"""The persistent kernels' per-thread BVH walk, without Pallas.

``bvh_walk_ref`` (the plain version of ``csrc/pt_common.cuh::bvh_walk``)
over ``pack_bvh``'s tree, against the JAX package's XLA traversal
(``tpu_pathtracer/ops/triangle.py::intersect_mesh``, closest and any hit)
and brute force (``mesh_brute_force_t``) on the same JAX-built meshes
(carried across with ``mesh_from_numpy``), and against ``mesh_walk_ref``
over the 64-triangle-leaf tree that the plain versions walk (the same
PyTorch arithmetic); then the packing's invariants and limits, and the
tree's quality on terrain camera rays.

XLA on the CPU contracts multiply-adds into FMAs and PyTorch does not, so
against JAX a ray whose two best triangles lie within rounding of each other
(a ray through a shared edge, or a box standing on the floor) may pick the
other one: such near ties are told apart, counted and bounded, and every
other ray must pick JAX's triangle.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.models import mesh as jmesh, meshes as jmeshes  # noqa: E402
from tpu_pathtracer.models import scene as jsc  # noqa: E402
from tpu_pathtracer.ops import triangle as jtri  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, mesh as tmesh  # noqa: E402
from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import mesh_kernel as tmk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels._walk import (  # noqa: E402
    _moller_trumbore, bvh_walk_ref, mesh_walk_ref,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera  # noqa: E402

N_RAYS = 2048  # half through the mesh's box, half from points on it
WALK_AGREE = 0.999  # rays that must pick JAX's triangle (near ties aside)
TIE_RTOL = 1e-5  # two triangles this close in t on a ray are a near tie
TIE_SHARE = 0.02  # near ties allowed, of the rays
T_RTOL = 1e-5
EDGE_SHARE = 0.001  # rays the robust box test may catch that the tile misses
QUALITY = 5  # terrain32 camera rays: 64-leaf tests >= QUALITY x these
BIG = 1e30


def _checker_mesh():
    """The quad of the JAX suite's checker scene (tests/test_persistent.py
    :494-528): two triangles sharing a diagonal."""
    v, f, uv = jmeshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                            [10, 0, -10])
    return jmesh.build_bvh(v, f, uv, 0)


JAX_MESHES = {
    "cornell-boxes": lambda: jsc.cornell_boxes()[0].mesh,
    "cornell-quad": lambda: jsc.cornell_quad()[0].mesh,
    "terrain16": lambda: jsc.terrain_textured(n=16)[0].mesh,
    "checker": _checker_mesh,
}


def _rays(tm, seed):
    """N_RAYS seeded rays: half from a sphere around the mesh's box aimed
    at points inside it (on the checker quad, half of those at points of
    its shared diagonal), half from random points of random triangles in
    random directions (bounce and shadow rays start on a surface)."""
    rng = np.random.default_rng(seed)
    lo, hi = tm.node_min[0].numpy(), tm.node_max[0].numpy()
    n = N_RAYS // 2
    u = rng.normal(size=(n, 3))
    o1 = (0.5 * (lo + hi) + 0.75 * np.linalg.norm(hi - lo)
          * u / np.linalg.norm(u, axis=1, keepdims=True))
    tgt = rng.uniform(lo, hi, (n, 3))
    diag = np.zeros(N_RAYS, bool)
    if tm.num_tris == 2:
        s = rng.uniform(0, 1, n // 2)[:, None]
        tgt[: n // 2] = (np.array([-10.0, 0.0, -10.0])
                         + s * np.array([20.0, 0.0, 20.0]))
        diag[: n // 2] = True
    d1 = tgt - o1
    tri = rng.integers(0, tm.num_tris, n)
    b = rng.uniform(0, 1, (n, 2))
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    v0, e1, e2 = (getattr(tm, f).numpy()[tri] for f in ("v0", "e1", "e2"))
    o2 = v0 + b[:, :1] * e1 + b[:, 1:] * e2
    d2 = rng.normal(size=(n, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, diag


@pytest.fixture(scope="module", params=list(JAX_MESHES))
def case(request):
    """A JAX-built mesh, the same mesh in the port, its two packings,
    seeded rays, and the JAX closest hits (XLA walk and brute force)."""
    jm = JAX_MESHES[request.param]()
    tm = tmesh.mesh_from_numpy(
        {f: np.asarray(getattr(jm, f)) for f in tmesh.ARRAY_FIELDS},
        leaf_size=jm.leaf_size, device="cpu")
    o, d, diag = _rays(tm, seed=len(request.param))
    walk = jtri.intersect_mesh(jm, jnp.asarray(o), jnp.asarray(d),
                               tmin=tsc.EPSILON)
    brute = jtri.mesh_brute_force_t(jm, jnp.asarray(o), jnp.asarray(d),
                                    tmin=tsc.EPSILON)
    return dict(name=request.param, jm=jm, tm=tm, bvh=tmk.pack_bvh(tm),
                packed=tmk.pack_mesh(tm, collapse_leaf=64), o=o, d=d,
                diag=diag,
                jax={k: (np.asarray(h.t), np.asarray(h.tri))
                     for k, h in (("walk", walk), ("brute", brute))})


def _walk(case, t0, **kw):
    o, d = (torch.tensor(x) for x in (case["o"], case["d"]))
    return bvh_walk_ref(case["bvh"], *o.T, *d.T, torch.tensor(t0), **kw)


def _hit(case, tri):
    """t of each ray against its triangle tri in the port's arithmetic (BIG
    where it misses or tri is -1), and the hit's edge margin min(u, v,
    1 - u - v), negative outside the triangle."""
    tm = case["tm"]
    o, d = (torch.tensor(x) for x in (case["o"], case["d"]))
    idx = torch.tensor(tri, dtype=torch.int64).clamp_min(0)
    ok, u, v, t = _moller_trumbore(
        *o.T, *d.T,
        *(c for f in ("v0", "e1", "e2") for c in getattr(tm, f)[idx].T))
    margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v).numpy()
    hit = ok.numpy() & (margin >= 0) & (t.numpy() > tsc.EPSILON) & (tri >= 0)
    return np.where(hit, t.numpy(), BIG), np.where(ok.numpy(), margin, -1.0)


def _closest(case):
    """The port's closest hits from BIG: t and the winning triangle."""
    t, *_, tri = _walk(case, np.full(N_RAYS, BIG, np.float32),
                       with_tri=True)
    return t.numpy(), tri.numpy()


def _near_ties(case, tri, jtri_, jt):
    """Rays where the port and JAX may rightly differ: both hit at t within
    TIE_RTOL of each other (two triangles as close), or the hit of either
    side lies within TIE_RTOL of its triangle's edge (a ray through a
    shared edge, which one arithmetic may let through the crack)."""
    t_mine, m_mine = _hit(case, tri)
    _, m_jax = _hit(case, jtri_)
    both = (tri >= 0) & (jtri_ >= 0)
    close = both & (np.abs(t_mine - jt) <= TIE_RTOL * jt)
    edge = (((tri >= 0) & (np.abs(m_mine) <= TIE_RTOL))
            | ((jtri_ >= 0) & (np.abs(m_jax) <= TIE_RTOL)))
    return close | edge


@pytest.mark.parametrize("oracle", ["walk", "brute"])
def test_closest_hit_matches_jax(case, oracle):
    """The winning triangle of every ray is JAX's (XLA walk or brute force),
    but on near ties (``_near_ties``), counted and bounded (the checker's
    rays aimed at its shared diagonal are ties by construction and left
    out of the bound); t within T_RTOL; misses agree."""
    t, tri = _closest(case)
    jt, jtri_ = case["jax"][oracle]
    jhit = jt < 0.5 * BIG
    jtri_ = np.where(jhit, jtri_, -1)
    same = tri == jtri_
    tie = ~same & _near_ties(case, tri, jtri_, jt)
    agree = (same | tie).mean()
    print(f"{case['name']} vs {oracle}: {same.mean():.4f} same triangle, "
          f"{int(tie.sum())} near ties ({int(tie[case['diag']].sum())} on "
          f"the diagonal), {int(jhit.sum())} hits of {N_RAYS}")
    assert agree >= WALK_AGREE, (agree, np.nonzero(~(same | tie))[0][:10])
    assert tie[~case["diag"]].mean() <= TIE_SHARE, tie.sum()
    both = jhit & (tri >= 0) & (same | tie)
    np.testing.assert_allclose(t[both], jt[both], rtol=T_RTOL)
    if case["name"] in ("cornell-boxes", "cornell-quad"):
        assert jhit.mean() > 0.8


def test_occlusion_matches_jax_any_hit(case):
    """Occlusion mode blocks the segments (tmin, tmax) that JAX's any-hit
    traversal finds blocked, on >= WALK_AGREE of rays (a ray whose closest
    hit lies within T_RTOL of tmax may go either way); dead lanes stay
    0."""
    rng = np.random.default_rng(7)
    jt = case["jax"]["walk"][0]
    t_near = np.minimum(jt, 200.0)  # a miss gets segments up to 200 too
    tmax = np.where(rng.uniform(size=N_RAYS) < 0.5, t_near * 1.5,
                    rng.uniform(0.5, 2.0, N_RAYS) * t_near)
    tmax[:64] = 0.0
    tmax = tmax.astype(np.float32)
    occ = _walk(case, tmax, occlusion=True).numpy() == 0.0
    jh = jtri.intersect_mesh(case["jm"], jnp.asarray(case["o"]),
                             jnp.asarray(case["d"]), tmin=tsc.EPSILON,
                             tmax=jnp.asarray(tmax), any_hit=True)
    j_occ = np.asarray(jh.t) < tmax
    t, tri = _closest(case)
    jtri_ = np.where(jt < 0.5 * BIG, case["jax"]["walk"][1], -1)
    edge = ((np.abs(jt - tmax) <= T_RTOL * tmax)
            | _near_ties(case, tri, jtri_, jt))
    assert (occ[64:] == j_occ[64:])[~edge[64:]].mean() >= WALK_AGREE
    assert occ[:64].all()  # t_init 0: returned as 0, nothing walked


def test_matches_64_leaf_walk(case):
    """Against mesh_walk_ref on the 64-triangle-leaf tree (the tile walk of
    the plain versions, one 128-lane tile per row): t, normal, material and
    uv equal on every ray, from BIG and from a shorter t_init, but on the
    rays whose box the robust test catches where the tile's slab test
    misses it (counted, at most EDGE_SHARE, and only ever closer)."""
    n = N_RAYS
    rng = np.random.default_rng(3)
    jt = case["jax"]["walk"][0]
    for t0 in (np.full(n, BIG, np.float32),
               np.where(rng.uniform(size=n) < 0.5, 0.0,
                        rng.uniform(0.3, 1.5, n) * np.minimum(jt, 300.0)
                        ).astype(np.float32)):
        got = _walk(case, t0, track_uv=True)
        planes = [torch.tensor(np.ascontiguousarray(x)).reshape(-1, 128)
                  for x in (*case["o"].T, *case["d"].T, t0)]
        want = mesh_walk_ref(case["packed"], *planes, tile_rows=1,
                             track_uv=True)
        want = [w.reshape(-1) for w in want]
        differ = torch.zeros(n, dtype=torch.bool)
        for g, w in zip(got, want):
            differ |= g != w
        assert differ.float().mean() <= EDGE_SHARE, int(differ.sum())
        assert (got[0][differ] < want[0][differ]).all()


def test_packing_invariants(case):
    """Every triangle lies in exactly one leaf; a node's box encloses its
    subtree's boxes (exactly) and its leaf's triangles (to rounding of
    v0 + e); skip links point past the subtree; a mesh of at most
    BVH_MAX_LEAF triangles is one leaf, a larger one keeps the MeshData
    tree; slots are the MeshData triangles in order."""
    bvh, tm = case["bvh"], case["tm"]
    nodes = bvh.nodes.numpy()
    skip, first, count = bvh.links.numpy().T
    N, T = bvh.num_nodes, tm.num_tris
    assert (skip > np.arange(N)).all() and (skip <= N).all()
    seen = np.zeros(T, np.int64)
    verts = np.stack([tm.v0.numpy(), (tm.v0 + tm.e1).numpy(),
                      (tm.v0 + tm.e2).numpy()], 1)
    for i in range(N):
        lo, hi = nodes[i, 0:3], nodes[i, 4:7]
        sub = slice(i + 1, skip[i])
        assert (lo <= nodes[sub, 0:3]).all() and (nodes[sub, 4:7] <= hi).all()
        if count[i]:
            assert skip[i] == i + 1
            seen[first[i]:first[i] + count[i]] += 1
            v = verts[first[i]:first[i] + count[i]].reshape(-1, 3)
            tol = 1e-5 * np.maximum(np.abs(v), 1.0)
            assert (lo - tol <= v).all() and (v <= hi + tol).all()
    assert (seen == 1).all()
    if T <= tmk.BVH_MAX_LEAF:
        assert N == 1 and count[0] == T
    else:
        assert N == tm.num_nodes
        np.testing.assert_array_equal(count, tm.node_count.numpy())
    assert bvh.max_leaf == count.max()
    slots = bvh.tris.numpy()
    np.testing.assert_array_equal(slots[:, 0:3], tm.v0.numpy())
    np.testing.assert_array_equal(slots[:, 9], tm.material_id.numpy())


def test_limits_raise(monkeypatch):
    """pack_bvh raises ValueError at MAX_NODES nodes, for a leaf whose
    first triangle or count its int32 cannot hold, and for an empty mesh;
    with_packet_mesh passes the error on."""
    scene, _ = tsc.terrain_textured(n=10, device="cpu")  # 162 triangles
    mesh = scene.mesh
    n = tmk.pack_bvh(mesh).num_nodes
    monkeypatch.setattr(tmk, "MAX_NODES", n)
    with pytest.raises(ValueError, match="nodes"):
        tmk.pack_bvh(mesh)
    with pytest.raises(ValueError, match="nodes"):
        tsc.with_packet_mesh(scene)
    monkeypatch.setattr(tmk, "MAX_NODES", n + 1)
    tmk.pack_bvh(mesh)
    monkeypatch.setattr(tmk, "LEAF_BITS", 4)  # first triangles from 16
    with pytest.raises(ValueError, match="first triangle"):
        tmk.pack_bvh(mesh)
    monkeypatch.undo()
    big = dataclasses.replace(  # one leaf of 128 triangles
        mesh, node_count=torch.tensor([128], dtype=torch.int32),
        node_start=torch.tensor([0], dtype=torch.int32),
        node_skip=torch.tensor([1], dtype=torch.int32),
        node_min=mesh.node_min[:1], node_max=mesh.node_max[:1], num_nodes=1)
    with pytest.raises(ValueError, match="count"):
        tmk.pack_bvh(big)
    empty = dataclasses.replace(mesh, num_tris=0)
    with pytest.raises(ValueError, match="no triangles"):
        tmk.pack_bvh(empty)


def test_one_leaf_tree():
    """A mesh of one leaf (the checker quad, 2 triangles) packs as one
    node, and walks to the hits of a brute force over its triangles."""
    v, f, uv = jmeshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                            [10, 0, -10])
    from tpu_pathtracer_torch.models.mesh import build_bvh

    tm = build_bvh(v, f, uv, 0, device="cpu")
    bvh = tmk.pack_bvh(tm)
    assert bvh.num_nodes == 1 and bvh.links[0].tolist() == [1, 0, 2]
    o = torch.tensor([[0.0, 5.0, 0.0], [3.0, 5.0, -2.0], [30.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(3, 3)
    t0 = torch.full((3,), BIG)
    t, *_ = bvh_walk_ref(bvh, *o.T, *d.T, t0)
    assert t.tolist() == [5.0, 5.0, t0[2].item()]


def test_tree_quality_terrain32():
    """On terrain_textured(32) camera rays at 640x480 (the port's own
    median-split tree), the walk tests at most 1/QUALITY of the triangles
    that a per-ray walk of the 64-leaf tree tests (one live lane per tile
    of mesh_walk_ref), and returns the same hits."""
    scene, cs = tsc.terrain_textured(n=32, device="cpu")
    scene = tsc.with_packet_mesh(scene, two_pass=False)
    cam = pack_camera(tcm.make_camera(cs["eye"], cs["look_at"], cs["up"],
                                      640, 480, cs["fov"], device="cpu"))
    rng = np.random.default_rng(11)
    n = 384
    px, py = (torch.tensor(rng.uniform(0, s, n), dtype=torch.float32)
              for s in (640, 480))
    d = torch.stack([cam[k] - cam[6 + k] * py + cam[3 + k] * px
                     for k in range(3)], 1)
    d = d / d.norm(dim=1, keepdim=True)
    o = torch.tensor(cs["eye"], dtype=torch.float32).expand(n, 3)
    new, old = {}, {}
    t, *_ = bvh_walk_ref(scene.mesh_bvh, *o.T, *d.T, torch.full((n,), BIG),
                         counts=new)

    def tile(x):  # one live lane per 128-lane tile
        return torch.cat([x[:, None], torch.zeros(n, 127)], 1)

    t_old, *_ = mesh_walk_ref(
        scene.mesh_packed, *(tile(x) for x in (*o.T, *d.T)),
        tile(torch.full((n,), BIG)), tile_rows=1, counts=old)
    assert torch.equal(t, t_old[:, 0])
    assert new["segments"] == old["segments"] == n
    print(f"terrain32 camera rays per segment: boxes {new['boxes'] / n:.1f}"
          f" tris {new['tris'] / n:.1f} (64-leaf: boxes "
          f"{old['boxes'] / n:.1f} tris {old['tris'] / n:.1f})")
    assert new["tris"] * QUALITY <= old["tris"]


def _stacked_quads():
    """Three parallel 2-triangle quads at y = 0, 1, 2 (6 triangles, one
    leaf): a ray straight down through all three hits one triangle of
    each."""
    from tpu_pathtracer_torch.models import meshes as tmeshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    vs, fs, uvs = [], [], []
    for k, y in enumerate((0.0, 1.0, 2.0)):
        v, f, uv = tmeshes.quad([-5, y, -5], [-5, y, 5], [5, y, 5],
                                [5, y, -5])
        vs.append(np.asarray(v))
        fs.append(np.asarray(f) + 4 * k)
        uvs.append(np.asarray(uv))
    return build_bvh(np.concatenate(vs), np.concatenate(fs),
                     np.concatenate(uvs), 0, device="cpu")


def test_occlusion_counts_stop_at_first_occluder():
    """An occlusion walk counts a leaf's triangle tests up to and including
    its first occluder, as the kernel returns there (per-thread walk and
    the tile walk with one live lane per tile alike); a segment that no
    triangle blocks tests them all; a closest walk tests them all."""
    tm = _stacked_quads()
    bvh = tmk.pack_bvh(tm)
    assert bvh.num_nodes == 1 and bvh.max_leaf == 6
    rng = np.random.default_rng(5)
    n = 64
    # half straight down through the quads, half level between two of them
    # (through the leaf's box, parallel to every triangle)
    down = np.arange(n) < n // 2
    o = np.stack([np.where(down, rng.uniform(-4, 4, n), -8.0),
                  np.where(down, 5.0, 0.5),
                  rng.uniform(-4, 4, n)], 1).astype(np.float32)
    d = np.where(down[:, None], np.float32([0.0, -1.0, 0.0]),
                 np.float32([1.0, 0.0, 0.0])).astype(np.float32)
    tmax = np.full(n, 100.0, np.float32)
    ot, dt = torch.tensor(o), torch.tensor(d)
    # the first slot whose triangle blocks each segment, by brute force
    slots = bvh.tris
    ok, u, v, t = _moller_trumbore(
        *(x[:, None] for x in ot.T), *(x[:, None] for x in dt.T),
        *(slots[None, :, k] for k in range(9)))
    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tsc.EPSILON)
           & (t < torch.tensor(tmax)[:, None]))
    assert hit.any(1)[: n // 2].all() and not hit[n // 2:].any()
    want = torch.where(hit.any(1), hit.int().argmax(1) + 1, 6).sum()
    got = {}
    occ = bvh_walk_ref(bvh, *ot.T, *dt.T, torch.tensor(tmax),
                       occlusion=True, counts=got)
    assert (occ[: n // 2] == 0).all() and (occ[n // 2:] > 0).all()
    assert got == dict(segments=n, boxes=n, tris=int(want))
    assert int(want) < 6 * n  # the blocked segments stop early

    def tile(x):  # one live lane per 128-lane tile
        return torch.cat([x[:, None], torch.zeros(n, 127)], 1)

    old = {}
    mesh_walk_ref(tmk.pack_mesh(tm, collapse_leaf=64),
                  *(tile(x) for x in (*ot.T, *dt.T, torch.tensor(tmax))),
                  tile_rows=1, occlusion=True, counts=old)
    assert old == got
    closest = {}
    bvh_walk_ref(bvh, *ot.T, *dt.T, torch.tensor(tmax), counts=closest)
    assert closest["tris"] == 6 * n


def test_one_leaf_option():
    """pack_bvh's ``one_leaf``: with 0 a small mesh keeps its leaf-<=4
    MeshData tree (the tree the bounds count), and the walk over it finds
    the one leaf's hits; with a mesh's triangle count a larger mesh packs
    as one leaf."""
    scene, _ = tsc.cornell_boxes(device="cpu")
    tm = scene.mesh
    tree = tmk.pack_bvh(tm, one_leaf=0)
    assert tree.num_nodes == tm.num_nodes > 1
    np.testing.assert_array_equal(tree.links[:, 2].numpy(),
                                  tm.node_count.numpy())
    assert tree.max_leaf <= 4
    one = tmk.pack_bvh(tm)
    assert one.num_nodes == 1
    o, d, _ = _rays(tm, seed=9)
    o, d = torch.tensor(o), torch.tensor(d)
    t0 = torch.full((N_RAYS,), BIG)
    got = bvh_walk_ref(tree, *o.T, *d.T, t0, with_tri=True)
    want = bvh_walk_ref(one, *o.T, *d.T, t0, with_tri=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    terrain, _ = tsc.terrain_textured(n=8, device="cpu")  # 98 triangles
    assert tmk.pack_bvh(terrain.mesh).num_nodes > 1
    assert tmk.pack_bvh(terrain.mesh, one_leaf=98).num_nodes == 1


def test_plain_versions_record_their_walks():
    """``walks`` of the persistent plain version is called as
    mesh_walk_ref's ``record`` on every mesh walk (closest hits and NEE
    shadows), with the walk's own lane planes, and changes no output."""
    scene, cs = tsc.cornell_boxes(device="cpu")
    scene = tsc.with_packet_mesh(scene, two_pass=False)
    from tpu_pathtracer_torch.ops.kernels import persistent as tpk

    cam = pack_camera(tcm.make_camera(cs["eye"], cs["look_at"], cs["up"],
                                      32, 32, cs["fov"], device="cpu"))
    seen = []

    def record(occlusion, planes):
        assert len(planes) == 7 and planes[0].shape == (32, 128)
        seen.append((occlusion, int((planes[6] > 0).sum())))

    kw = dict(budget=3, width=32, height=32, tile_rows=32, use_nee=True)
    st0 = tpk.init_state(32, 32, 32, device="cpu")
    a, ra = tpk.persistent_step_ref(scene, cam, (1, 0), st0, walks=record,
                                    **kw)
    b, rb = tpk.persistent_step_ref(scene, cam, (1, 0), st0, **kw)
    assert int(ra) == int(rb)
    for f in tpk.STATE_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    closest = [n for occ, n in seen if not occ]
    assert len(closest) == 3 and closest[0] == 32 * 32
    assert any(occ and n > 0 for occ, n in seen)
