"""Kernel 6's coarse-tree walk and its sort key, in plain PyTorch.

``bin_tree_ref`` (the plain version of ``csrc/bin.cu``'s walk) against
``bin_rays_ref`` (the TPU kernel's linear sweep over the cells, the
contract) bit for bit, on the coarse tree of the textured terrain at n = 32
as ``with_packet_mesh`` packs it and on a deeper coarse tree of the same
mesh; the nesting of child boxes in their parents' that the walk's pruning
rests on, and the widening of an inner box that would not hold its
subtree; ``bin_sort_key`` against the key that ``intersect_mesh_packet``
made in torch. No JAX: these are the port's own functions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import mesh_kernel as tmk  # noqa: E402

TMIN = 3e-2
N_RAYS = 4096


@pytest.fixture(scope="module")
def terrain():
    scene, _ = tsc.terrain_textured(n=32, device="cpu")
    return scene


@pytest.fixture(scope="module", params=["default", "deep"])
def coarse(request, terrain):
    """The two-pass coarse tree as the scene packs it (cells of up to 1024
    triangles) and one with cells of up to 16 (several levels)."""
    if request.param == "default":
        tree = tsc.with_packet_mesh(terrain).mesh_packed_coarse
    else:
        tree = tmk.pack_mesh(terrain.mesh, collapse_leaf=16, nodes_only=True)
    return request.param, tree


def _cells(tree):
    return tree.cell_boxes.reshape(-1, 6)


def _random_rays(tree, n, seed):
    """Rays from around the tree's box in random directions, an eighth dead,
    with t_init from inside the nearest cells to past the box."""
    g = np.random.default_rng(seed)
    lo, hi = tree.nodes[0, 0:3].numpy(), tree.nodes[0, 3:6].numpy()
    ext = hi - lo
    o = lo - 0.25 * ext + g.random((n, 3)) * 1.5 * ext
    d = g.normal(size=(n, 3))
    d[: n // 16] = [0.0, -1.0, 0.0]  # axis-parallel: safe_inv's clamp
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = g.random(n) * 2.0 * float(np.linalg.norm(ext))
    t0[n // 16: n // 8] = 0.0
    t0[n // 8: n // 4] = np.inf
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32),
            torch.tensor(t0, dtype=torch.float32))


def _inside_rays(tree, n, seed):
    """Rays from inside cells (several cells hold the origin where their
    boxes overlap or touch: a tie at distance 0), short t_init that prunes
    the far cells."""
    g = np.random.default_rng(seed)
    cells = _cells(tree).numpy()
    pick = cells[g.integers(0, len(cells), n)]
    o = pick[:, 0:3] + g.random((n, 3)) * (pick[:, 3:6] - pick[:, 0:3])
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ext = float(np.linalg.norm(tree.nodes[0, 3:6] - tree.nodes[0, 0:3]))
    t0 = g.random(n) * 0.2 * ext
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32),
            torch.tensor(t0, dtype=torch.float32))


def _shared_faces(tree):
    """Pairs of cells (in DFS order) whose boxes meet on a face: (a, b,
    axis) with a's max on that axis equal to b's min, their extents on the
    other two axes overlapping."""
    cells = _cells(tree).numpy()
    pairs = []
    for a in range(len(cells)):
        for b in range(len(cells)):
            for ax in range(3):
                if a == b or cells[a, 3 + ax] != cells[b, ax]:
                    continue
                o1, o2 = [k for k in range(3) if k != ax]
                if all(max(cells[a, k], cells[b, k])
                       < min(cells[a, 3 + k], cells[b, 3 + k])
                       for k in (o1, o2)):
                    pairs.append((a, b, ax))
    return pairs


def _face_rays(tree, n, seed):
    """Rays aimed at a face that two cells share: from outside both boxes,
    in the face's plane (no component across it), at a point of the
    overlap of the two boxes' extents, so that both cells are entered at
    the same distance where their entry slabs coincide."""
    g = np.random.default_rng(seed)
    cells = _cells(tree).numpy()
    pairs = _shared_faces(tree)
    assert pairs, "no two cells share a face"
    o, d = np.zeros((n, 3)), np.zeros((n, 3))
    for i in range(n):
        a, b, ax = pairs[g.integers(len(pairs))]
        lo = np.maximum(cells[a, 0:3], cells[b, 0:3])
        hi = np.minimum(cells[a, 3:6], cells[b, 3:6])
        q = lo + g.random(3) * (hi - lo)
        q[ax] = cells[a, 3 + ax]
        w = g.normal(size=3)
        w[ax] = 0.0
        w /= np.linalg.norm(w)
        o[i] = q - w * (1.0 + 2.0 * float(np.linalg.norm(hi - lo)))
        o[i, ax] = q[ax]
        d[i] = w
    t0 = np.full(n, np.inf)
    return (torch.tensor(o, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float32),
            torch.tensor(t0, dtype=torch.float32))


RAYS = {"random": _random_rays, "inside": _inside_rays}


@pytest.mark.parametrize("kind", sorted(RAYS))
def test_walk_equals_sweep(coarse, kind):
    """bin_tree_ref's (cell, tn) equal bin_rays_ref's bit for bit, and the
    walk tests fewer boxes per live ray than the sweep's C cells (on the
    deeper tree)."""
    name, tree = coarse
    o, d, t0 = RAYS[kind](tree, N_RAYS, 7)
    counts = {}
    walk = tmk.bin_tree_ref(tree, o, d, t0, TMIN, counts=counts)
    sweep = tmk.bin_rays_ref(tree, o, d, t0, TMIN)
    assert torch.equal(walk[0], sweep[0]) and torch.equal(walk[1], sweep[1])
    live = t0 > 0
    assert bool((walk[0][~live] == -1).all())
    assert bool((walk[1][~live] == tmk.BIG).all())
    share = float((walk[0] >= 0).float().mean())
    if kind == "random":
        assert 0.05 < share < 0.95, share  # both outcomes exercised
    C = _cells(tree).shape[0]
    tests = (counts["nodes"] + counts["cells"]) / int(live.sum())
    if name == "deep":
        assert C >= 64 and tests < C / 4, (C, tests)


def test_walk_keeps_the_first_of_tied_cells():
    """Rays aimed at a face that two cells of the deeper tree share, in its
    plane: where both cells pass at the same distance the first cell in DFS
    order wins, in the walk as in the sweep. The tree is the median split's
    (``use_native=False``): its cells cut the terrain's grid at grid lines,
    so neighbours share whole faces and are entered at the same distance;
    the SAH tree's neighbours differ in height and give no such ties."""
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.terrain(n=32, extent=120.0, height=14.0, seed=3)
    mesh = build_bvh(v, f, uv, 0, use_native=False, device="cpu")
    tree = tmk.pack_mesh(mesh, collapse_leaf=16, nodes_only=True)
    o, d, t0 = _face_rays(tree, 1024, 11)
    walk = tmk.bin_tree_ref(tree, o, d, t0, TMIN)
    sweep = tmk.bin_rays_ref(tree, o, d, t0, TMIN)
    assert torch.equal(walk[0], sweep[0]) and torch.equal(walk[1], sweep[1])
    # count the rays on which two or more cells pass at the winner's
    # distance: the tie rule decides them
    cells = _cells(tree)
    ix, iy, iz = (tmk._safe_inv(d[:, k]) for k in range(3))
    at_best = torch.zeros(o.shape[0], dtype=torch.int32)
    for c in range(cells.shape[0]):
        tn, tf = tmk._slab(cells[c], o[:, 0], o[:, 1], o[:, 2], ix, iy, iz)
        ok = (tn <= tf) & (tf > TMIN) & (tn < t0)
        at_best += (ok & (torch.clamp_min(tn, 0.0) == sweep[1])).int()
    assert int((at_best >= 2).sum()) >= 32, int((at_best >= 2).sum())


def _children(skip, i):
    c, out = i + 1, []
    while c < skip[i]:
        out.append(c)
        c = skip[c]
    return out


def test_child_boxes_nest_in_their_parents(coarse):
    """Every node's box holds its children's in f32 (the premise of the
    walk's pruning), so the walk table keeps the packed boxes as they
    are; its skip links and leaf flags are the tree's."""
    _, tree = coarse
    nodes = tree.nodes.numpy()
    skip = nodes[:, 6].astype(np.int64)
    lo, hi = nodes[:, 0:3], nodes[:, 3:6]
    inner = 0
    for i in range(len(nodes)):
        for c in _children(skip, i):
            inner += 1
            assert (lo[c] >= lo[i]).all() and (hi[c] <= hi[i]).all(), (i, c)
    assert inner == len(nodes) - 1  # every node but the root is a child
    table = tree.walk_nodes.numpy()
    bits = table.view(np.int32)
    np.testing.assert_array_equal(table[:, 0:3], lo)
    np.testing.assert_array_equal(table[:, 4:7], hi)
    np.testing.assert_array_equal(bits[:, 3], skip)
    np.testing.assert_array_equal(bits[:, 7], (nodes[:, 8] > 0).astype(
        np.int32))


def test_walk_table_widens_a_box_that_does_not_nest(terrain):
    """An inner box shrunk so that it no longer holds its subtree is widened
    in the walk table to the union of its subtree's boxes, and the walk
    still equals the sweep."""
    tree = tmk.pack_mesh(terrain.mesh, collapse_leaf=16, nodes_only=True)
    nodes = tree.nodes.numpy().copy()
    skip = nodes[:, 6].astype(np.int64)
    i = _children(skip, 0)[0]  # an inner node below the root
    assert skip[i] > i + 1
    nodes[i, 0:3] += 0.3 * (nodes[i, 3:6] - nodes[i, 0:3])
    table = tmk._walk_table(nodes[:, 0:3], nodes[:, 3:6], skip,
                            nodes[:, 8])
    np.testing.assert_array_equal(
        table[i, 0:3], tree.nodes[i, 0:3].numpy())  # the subtree's union
    shrunk = dataclasses.replace(tree, walk_nodes=torch.tensor(table))
    o, d, t0 = _random_rays(tree, N_RAYS, 5)
    walk = tmk.bin_tree_ref(shrunk, o, d, t0, TMIN)
    sweep = tmk.bin_rays_ref(tree, o, d, t0, TMIN)
    assert torch.equal(walk[0], sweep[0]) and torch.equal(walk[1], sweep[1])


def _torch_key(coarse, cell, btn, d, t_init):
    """intersect_mesh_packet's sort key as torch made it from kernel 6's
    (cell, tn) before the launch wrote it."""
    root = coarse.nodes[0]
    diag = torch.sqrt(torch.sum((root[3:6] - root[0:3]) ** 2))
    tq = torch.clamp(btn * (64.0 / torch.clamp_min(diag, 1e-6)),
                     0.0, 63.0).to(torch.int32)
    has = (cell >= 0) & (t_init > 0.0)
    return torch.where(has, ((cell * 8 + tmk._octant(d)) << 6) | tq,
                       1 << 26)


@pytest.mark.parametrize("kind", sorted(RAYS))
def test_sort_key_equals_the_torch_key(coarse, kind):
    """bin_sort_key with the tree's key_scale, and the key that bin_rays
    returns on the CPU, equal the torch key of intersect_mesh_packet bit for
    bit; a ray without a cell sorts last."""
    _, tree = coarse
    o, d, t0 = RAYS[kind](tree, N_RAYS, 3)
    cell, tn, key = tmk.bin_rays(tree, o, d, t0, TMIN)
    want = _torch_key(tree, cell, tn, d, t0)
    assert key.dtype == torch.int32
    assert torch.equal(key, want)
    assert torch.equal(tmk.bin_sort_key(cell, tn, d, tree.key_scale), want)
    assert bool((key[cell < 0] == 1 << 26).all())
    assert bool((key[cell >= 0] < 1 << 26).all())
    assert tree.key_scale.shape == () and tree.key_scale.dtype == \
        torch.float32


def test_walk_table_shared_memory(coarse):
    """Kernel 6 stages the whole walk table in shared memory, 32 B per
    node; the launcher refuses a table past a block's limit before any
    launch."""
    _, tree = coarse
    assert tmk.bin_smem_bytes(tree.num_nodes) == tree.walk_nodes.numel() * 4
    limit = tmk.SMEM_PER_BLOCK // 32
    assert tmk.bin_smem_bytes(limit) == 32 * limit
    with pytest.raises(ValueError, match="shared memory"):
        tmk.bin_smem_bytes(limit + 1)
