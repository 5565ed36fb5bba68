"""The port's packet and bin plain versions and packing against the JAX package.

Kernels 5 and 6 (``csrc/packet.cu``, ``csrc/bin.cu``) are held to their plain
versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``); here
the plain versions, ``packet_ref`` and ``bin_rays_ref``, are held to the JAX
package's Pallas kernels in interpret mode on the same rays, and the coarse
tree's packing to JAX's arrays. Three JAX interpret-mode calls in all, in
module-scoped fixtures: ``bin_rays``, a two-pass closest-hit query with
``t_init`` on a small textured terrain, and an any-hit query on
cornell_boxes. The fine trees are collapsed to 16- and 8-triangle leaves
there, because interpret mode unrolls a leaf's triangles (a 64-triangle leaf
costs minutes).

Kernel 5 walks ``pack_bvh``'s tree on the card; its plain version there,
``packet_bvh_ref``, is held here to the same JAX results, reusing the
fixtures (no JAX call of its own), and to ``packet_ref`` on the 64-leaf tree.

Bars: hit/miss and slot (triangle) equal on >= 99.9% of lanes, t at rtol
1e-5 (XLA contracts the Moller-Trumbore products into FMAs, PyTorch rounds
each one), n and uv within 1e-5, materials equal.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.models import scene as jsc  # noqa: E402
from tpu_pathtracer.ops import triangle as jtri  # noqa: E402
from tpu_pathtracer.ops.pallas import mesh_kernel as jmk  # noqa: E402
from tpu_pathtracer_torch.ops import triangle as ttri  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import mesh_kernel as tmk  # noqa: E402

from test_torch_scene_camera import scene_to_torch  # noqa: E402

TMIN = 3e-2
AGREE = 0.999  # share of lanes with equal hit/miss and slot
T_RTOL = 1e-5
ATTR_ATOL = 1e-5


def _rays(seed, n, lo, hi, lift, down):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(lo, hi, (n, 3)) + np.asarray(lift)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] -= down
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _terrain():
    js, _ = jsc.terrain_textured(n=16)
    return js, scene_to_torch(js)


@pytest.fixture(scope="module")
def terrain_case():
    """A small textured terrain (450 triangles), 600 rays with a random
    t_init (50 dead lanes, 100 unbounded), and JAX's interpret-mode
    bin_rays and two-pass closest-hit query on them."""
    js, ts = _terrain()
    o, d = _rays(0, 600, -50, 50, [0, 40, 0], 1.0)
    t_init = np.random.default_rng(1).uniform(10, 120, 600).astype(np.float32)
    t_init[:50] = 0.0
    t_init[50:150] = 1e30
    jf = jmk.pack_mesh(js.mesh, collapse_leaf=16)
    jc = jmk.pack_mesh(js.mesh, collapse_leaf=64, nodes_only=True,
                       fine_leaf=16)
    ja = [jnp.asarray(x) for x in (o, d, t_init)]
    cell, tn = jmk.bin_rays(jc, *ja, tmin=TMIN, interpret=True)
    jh = jmk.intersect_mesh_packet(jf, ja[0], ja[1], tmin=TMIN,
                                   t_init=ja[2], coarse=jc, interpret=True)
    tf = tmk.pack_mesh(ts.mesh, collapse_leaf=16)
    tc = tmk.pack_mesh(ts.mesh, collapse_leaf=64, nodes_only=True,
                       fine_leaf=16)
    return dict(js=js, ts=ts, o=o, d=d, t_init=t_init, jf=jf, jc=jc, tf=tf,
                tc=tc, cell=np.asarray(cell), tn=np.asarray(tn), jh=jh)


@pytest.fixture(scope="module")
def boxes_any_hit():
    """cornell_boxes, 600 shadow-like segments, JAX's interpret-mode any-hit
    query (sorted, single pass)."""
    js, _ = jsc.cornell_boxes()
    ts = scene_to_torch(js)
    o, d = _rays(2, 600, -40, 40, [0, 40, 0], 0.3)
    seg = np.random.default_rng(3).uniform(5, 90, 600).astype(np.float32)
    seg[:40] = 0.0
    jf = jmk.pack_mesh(js.mesh, collapse_leaf=8)
    jh = jmk.intersect_mesh_packet(
        jf, jnp.asarray(o), jnp.asarray(d), tmin=TMIN,
        t_init=jnp.asarray(seg), any_hit=True,
        tile_rows=jmk.ANY_HIT_TILE_ROWS, interpret=True)
    return dict(ts=ts, o=o, d=d, seg=seg,
                tf=tmk.pack_mesh(ts.mesh, collapse_leaf=8), jt=np.asarray(jh.t))


def _t(x):
    return torch.tensor(np.asarray(x))


def _hit_agreement(t_a, tri_a, t_b, tri_b, limit):
    hit_a, hit_b = t_a < limit, t_b < limit
    same = (hit_a == hit_b) & (~hit_a | (tri_a == tri_b))
    return same.mean(), same & hit_a


# -- packing -----------------------------------------------------------------

@pytest.mark.parametrize("coarse_leaf,fine_leaf", [(1024, 64), (64, 16),
                                                   (32, 8)])
@pytest.mark.parametrize("name", ["terrain", "cornell-boxes"])
def test_coarse_pack_matches_jax(name, coarse_leaf, fine_leaf):
    """pack_mesh(nodes_only=True, fine_leaf=...) gives JAX's node table,
    leaf-cell tables and fine map exactly on the same MeshData."""
    if name == "terrain":
        js, ts = _terrain()
    else:
        js, _ = jsc.cornell_boxes()
        ts = scene_to_torch(js)
    jp = jmk.pack_mesh(js.mesh, collapse_leaf=coarse_leaf, nodes_only=True,
                       fine_leaf=fine_leaf)
    tp = tmk.pack_mesh(ts.mesh, collapse_leaf=coarse_leaf, nodes_only=True,
                       fine_leaf=fine_leaf)
    for f in ("nodes", "cell_boxes", "cell_ids", "fine_map", "tri_rows",
              "remap"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert (tp.num_nodes, tp.leaf_size) == (jp.num_nodes, jp.leaf_size)


def test_with_packet_mesh_defaults_match_jax():
    """The JAX defaults: two-pass, coarse cells of up to 1024 triangles
    mapped onto the 64-triangle fine tree."""
    from tpu_pathtracer_torch.models import scene as tsc

    js, ts = _terrain()
    jp = jsc.with_packet_mesh(js)
    tsp = tsc.with_packet_mesh(ts)
    for f in ("nodes", "tri_rows"):
        np.testing.assert_array_equal(
            getattr(tsp.mesh_packed, f).numpy(),
            np.asarray(getattr(jp.mesh_packed, f)), err_msg=f)
    for f in ("nodes", "cell_ids", "fine_map"):
        np.testing.assert_array_equal(
            getattr(tsp.mesh_packed_coarse, f).numpy(),
            np.asarray(getattr(jp.mesh_packed_coarse, f)), err_msg=f)
    assert tsc.with_packet_mesh(ts, two_pass=False).mesh_packed_coarse is None


# -- the plain versions against JAX's interpret-mode kernels -----------------

def test_bin_rays_ref_matches_jax(terrain_case):
    """bin_rays_ref gives JAX's cells and entry distances exactly (the same
    f32 slab arithmetic with no products to contract)."""
    c = terrain_case
    counts = {}
    cell, tn = tmk.bin_rays_ref(c["tc"], _t(c["o"]), _t(c["d"]),
                                _t(c["t_init"]), TMIN, counts=counts)
    np.testing.assert_array_equal(cell.numpy(), c["cell"])
    np.testing.assert_array_equal(tn.numpy(), c["tn"])
    assert 0.1 < (c["cell"] >= 0).mean() < 0.9  # both outcomes exercised
    assert np.all(c["cell"][:50] == -1)  # dead lanes
    live = int((c["t_init"] > 0).sum())
    assert counts["cells"] == live * c["tc"].cell_ids.shape[0]


def test_two_pass_packet_matches_jax(terrain_case):
    """The two-pass query (bin, cell sort, the fine walk through
    packet_ref, un-permute) gives the hits of JAX's hint-first walk: slot,
    t, normal, uv and material."""
    c = terrain_case
    th = tmk.intersect_mesh_packet(c["tf"], _t(c["o"]), _t(c["d"]), TMIN,
                                   t_init=_t(c["t_init"]), coarse=c["tc"])
    jh = c["jh"]
    jt, tt = np.asarray(jh.t), th.t.numpy()
    lim = np.where(c["t_init"] > 0, c["t_init"], 0)
    agree, both = _hit_agreement(jt, np.asarray(jh.tri), tt, th.tri.numpy(),
                                 lim)
    assert agree >= AGREE
    assert 100 < both.sum() < 500  # hits and misses exercised
    np.testing.assert_allclose(tt, jt, rtol=T_RTOL)
    np.testing.assert_allclose(th.n.numpy()[both], np.asarray(jh.n)[both],
                               atol=ATTR_ATOL)
    np.testing.assert_allclose(th.uv.numpy()[both], np.asarray(jh.uv)[both],
                               atol=ATTR_ATOL)
    np.testing.assert_array_equal(th.mat.numpy(), np.asarray(jh.mat))
    assert np.all(tt[:50] > 1e29)  # dead lanes report BIG


def test_any_hit_matches_jax(boxes_any_hit):
    """Occlusion of finite segments equals JAX's, and t is 0 (occluded) or
    the segment length."""
    c = boxes_any_hit
    th = tmk.intersect_mesh_packet(c["tf"], _t(c["o"]), _t(c["d"]), TMIN,
                                   t_init=_t(c["seg"]), any_hit=True)
    occ_j = c["jt"] < c["seg"]
    occ_t = th.t.numpy() < c["seg"]
    assert (occ_j == occ_t).mean() >= AGREE
    assert 100 < occ_j.sum() < 500
    np.testing.assert_array_equal(th.t.numpy(), c["jt"])
    for a in (th.tri, th.n, th.uv, th.mat):
        assert not a.numpy().any()


# -- kernel 5's tree: pack_bvh's, walked by packet_bvh_ref -------------------

def _bvh_hit(bvh, c, t_init, any_hit):
    """packet_bvh_ref on a fixture's rays, with intersect_mesh_packet's t
    (t_init where nothing is closer, BIG on dead lanes); numpy arrays."""
    t, tri, n, uv, mat = tmk.packet_bvh_ref(bvh, _t(c["o"]), _t(c["d"]),
                                            _t(t_init), TMIN, any_hit)
    pos = np.where(t_init > 0, t_init, 0)
    t = t.numpy()
    t = np.where(t < pos, t, np.where(t_init > 0, t_init, 1e30))
    return t, tri.numpy(), n.numpy(), uv.numpy(), mat.numpy()


@pytest.mark.parametrize("one_leaf", [tmk.BVH_MAX_LEAF, 0])
def test_packet_bvh_ref_matches_jax(terrain_case, boxes_any_hit, one_leaf):
    """Kernel 5's plain version, on pack_bvh's tree (one leaf for a mesh of
    at most one_leaf triangles: cornell_boxes by default), gives the hits of
    JAX's interpret-mode queries: the two-pass closest-hit query on the
    terrain (triangle id, t, normal, uv, material) and the any-hit query on
    cornell_boxes."""
    c = terrain_case
    bvh = tmk.pack_bvh(c["ts"].mesh, one_leaf=one_leaf)
    t, tri, n, uv, mat = _bvh_hit(bvh, c, c["t_init"], False)
    jh = c["jh"]
    jt = np.asarray(jh.t)
    lim = np.where(c["t_init"] > 0, c["t_init"], 0)
    agree, both = _hit_agreement(jt, np.asarray(jh.tri), t, tri, lim)
    assert agree >= AGREE
    assert 100 < both.sum() < 500
    np.testing.assert_allclose(t, jt, rtol=T_RTOL)
    np.testing.assert_allclose(n[both], np.asarray(jh.n)[both],
                               atol=ATTR_ATOL)
    np.testing.assert_allclose(uv[both], np.asarray(jh.uv)[both],
                               atol=ATTR_ATOL)
    np.testing.assert_array_equal(mat, np.asarray(jh.mat))
    b = boxes_any_hit
    bvh = tmk.pack_bvh(b["ts"].mesh, one_leaf=one_leaf)
    t, tri, n, uv, mat = _bvh_hit(bvh, b, b["seg"], True)
    occ_j, occ_t = b["jt"] < b["seg"], t < b["seg"]
    assert (occ_j == occ_t).mean() >= AGREE
    assert 100 < occ_j.sum() < 500
    np.testing.assert_array_equal(t, b["jt"])
    for a in (tri, n, uv, mat):
        assert not a.any()


@pytest.mark.parametrize("case,any_hit,tmin", [
    ("terrain_case", False, TMIN), ("terrain_case", False, 2.0),
    ("terrain_case", True, TMIN), ("boxes_any_hit", False, TMIN),
    ("boxes_any_hit", True, TMIN)])
def test_packet_bvh_ref_matches_packet_ref(request, case, any_hit, tmin):
    """Kernel 5's plain version on pack_bvh's tree against packet_ref on the
    64-leaf tree (the TPU kernel's contract) on the same rays, compared by
    MeshData triangle id: the same hits on >= AGREE of lanes, and there the
    same t, normal, uv and material bit for bit (the same triangle
    arithmetic on the same slot rows)."""
    c = request.getfixturevalue(case)
    t_init = c["t_init"] if case == "terrain_case" else c["seg"]
    mesh = c["ts"].mesh
    pm = tmk.pack_mesh(mesh, collapse_leaf=64)
    args = (_t(c["o"]), _t(c["d"]), _t(t_init), tmin, any_hit)
    r = list(tmk.packet_ref(pm, *args))
    k = list(tmk.packet_bvh_ref(tmk.pack_bvh(mesh, one_leaf=0), *args))
    lim = torch.where(args[2] > 0, args[2], 0.0)
    found = r[0] < lim
    r[1] = torch.where(found & (not any_hit), pm.remap[r[1].long()], 0)
    hk = k[0] < lim
    same = (hk == found) & (~found | (k[1] == r[1]))
    assert float(same.double().mean()) >= AGREE
    assert 100 < int(found.sum()) < 500
    for a, b in zip(k, r):
        assert torch.equal(a[same], b[same].to(a.dtype))


@pytest.mark.parametrize("collapse_leaf", [64, 16, 8])
@pytest.mark.parametrize("name", ["terrain", "cornell-boxes"])
def test_packed_slots_follow_triangle_order(name, collapse_leaf):
    """pack_mesh's slots hold the MeshData triangles in increasing id order
    (build_bvh's DFS lays leaves out left to right), the same rows as
    pack_bvh's slots: so both walks, which keep the first of equal t in
    slot order, break an exact tie toward the lower triangle id alike."""
    if name == "terrain":
        _, ts = _terrain()
    else:
        js, _ = jsc.cornell_boxes()
        ts = scene_to_torch(js)
    pm = tmk.pack_mesh(ts.mesh, collapse_leaf=collapse_leaf)
    ids = pm.remap[pm.remap >= 0].long()
    assert torch.equal(ids, torch.arange(ts.mesh.num_tris))
    rows = pm.tri_rows.reshape(-1, tmk.TRI_STRIDE)[pm.remap >= 0]
    assert torch.equal(rows, tmk.pack_bvh(ts.mesh).tris)


# -- port-internal checks ----------------------------------------------------

def test_packet_ref_matches_triangle_walk():
    """packet_ref over the packed tree finds the per-lane threaded walk's
    (ops/triangle.py) closest hits, triangle ids and attributes; the sorted
    and unsorted queries agree; want_tri=False gives padded slots."""
    js, ts = _terrain()
    mesh = ts.mesh
    pm = tmk.pack_mesh(mesh, collapse_leaf=64)
    o, d = (_t(x) for x in _rays(4, 500, -50, 50, [0, 40, 0], 1.0))
    ref = ttri.intersect_mesh(mesh, o, d, tmin=TMIN)
    counts = {}
    t, slot, n, uv, mat = tmk.packet_ref(pm, o, d, torch.full((500,), 1e30),
                                         TMIN, counts=counts)
    hit = ref.t < 1e29
    assert 100 < int(hit.sum()) < 500
    assert counts["nodes"] >= 500 and counts["tris"] > 0
    un = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False)
    srt = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=True)
    for h in (un, srt):
        torch.testing.assert_close(h.t, ref.t, rtol=T_RTOL, atol=0)
        assert torch.equal(h.tri[hit], ref.tri[hit].to(h.tri.dtype))
        torch.testing.assert_close(h.n[hit], mesh.n_geom[ref.tri[hit]],
                                   rtol=0, atol=ATTR_ATOL)
        uv_ref = (mesh.uv0[ref.tri] + ref.u[:, None] * mesh.uv_e1[ref.tri]
                  + ref.v[:, None] * mesh.uv_e2[ref.tri])
        torch.testing.assert_close(h.uv[hit], uv_ref[hit], rtol=0,
                                   atol=ATTR_ATOL)
    for f in ("t", "tri", "n", "uv", "mat"):
        assert torch.equal(getattr(un, f), getattr(srt, f)), f
    slots = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False,
                                      want_tri=False).tri
    assert torch.equal(pm.remap[slots[hit].long()], un.tri[hit])


def test_hints_and_two_pass_do_not_change_hits():
    """A hint table (the JAX kernel's ordering aid, which the port's walk
    accepts and ignores) and the two-pass traversal return the single-pass
    hits exactly; the per-lane walk does not depend on the lane order."""
    js, ts = _terrain()
    pm = tmk.pack_mesh(ts.mesh, collapse_leaf=16)
    coarse = tmk.pack_mesh(ts.mesh, collapse_leaf=64, nodes_only=True,
                           fine_leaf=16)
    o, d = (_t(x) for x in _rays(5, 700, -50, 50, [0, 40, 0], 1.0))
    t0 = torch.tensor(np.random.default_rng(6).uniform(5, 150, 700),
                      dtype=torch.float32)
    base = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False, t_init=t0)
    n_tiles = -(-700 // (16 * tmk.LANES))  # the JAX default tile_rows 16
    rng = np.random.default_rng(7)
    for _ in range(3):  # any ranges, some reaching past the tree
        a = rng.integers(-2, pm.num_nodes, n_tiles)
        b = rng.integers(0, pm.num_nodes + 5, n_tiles)
        hints = torch.tensor(np.stack([np.minimum(a, b), np.maximum(a, b)],
                                      1), dtype=torch.int32)
        h = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False, t_init=t0,
                                      hints=hints)
        for f in ("t", "tri", "n", "uv", "mat"):
            assert torch.equal(getattr(h, f), getattr(base, f)), f
    for any_hit in (False, True):
        one = tmk.intersect_mesh_packet(pm, o, d, TMIN, t_init=t0,
                                        any_hit=any_hit)
        two = tmk.intersect_mesh_packet(pm, o, d, TMIN, t_init=t0,
                                        any_hit=any_hit, coarse=coarse)
        for f in ("t", "tri", "n", "uv", "mat"):
            assert torch.equal(getattr(one, f), getattr(two, f)), f


def test_t_init_semantics():
    """t equals t_init where nothing is closer, BIG on dead lanes; a hit
    found with t_init = BIG is found again with a larger t_init and lost
    with a smaller one."""
    js, ts = _terrain()
    pm = tmk.pack_mesh(ts.mesh, collapse_leaf=64)
    o, d = (_t(x) for x in _rays(8, 400, -50, 50, [0, 40, 0], 1.0))
    full = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False)
    hit = full.t < 1e29
    far = torch.where(hit, full.t * 1.5, 77.0)
    h = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False, t_init=far)
    assert torch.equal(h.t, torch.where(hit, full.t, far))
    near = torch.where(hit, full.t * 0.5, 77.0)
    h = tmk.intersect_mesh_packet(pm, o, d, TMIN, sort=False, t_init=near)
    assert torch.all(h.t[hit] == near[hit])
    dead = torch.zeros(400)
    h = tmk.intersect_mesh_packet(pm, o, d, TMIN, t_init=dead)
    assert torch.all(h.t > 1e29) and not h.tri.any()


def test_intersect_mesh_matches_jax():
    """ops/triangle.py::intersect_mesh (closest and any-hit) and the brute
    force oracle against JAX's XLA traversal on the same JAX-built mesh."""
    js, ts = _terrain()
    o, d = _rays(9, 300, -50, 50, [0, 40, 0], 1.0)
    seg = np.full(300, 40.0, np.float32)
    jh = jtri.intersect_mesh(js.mesh, jnp.asarray(o), jnp.asarray(d),
                             tmin=TMIN)
    ja = jtri.intersect_mesh(js.mesh, jnp.asarray(o), jnp.asarray(d),
                             tmin=TMIN, tmax=jnp.asarray(seg), any_hit=True)
    th = ttri.intersect_mesh(ts.mesh, _t(o), _t(d), tmin=TMIN)
    ta = ttri.intersect_mesh(ts.mesh, _t(o), _t(d), tmin=TMIN,
                             tmax=_t(seg), any_hit=True)
    bf = ttri.mesh_brute_force_t(ts.mesh, _t(o), _t(d), tmin=TMIN)
    hit = np.asarray(jh.t) < 1e29
    assert 100 < hit.sum() < 300
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=T_RTOL)
    np.testing.assert_array_equal(th.tri.numpy()[hit], np.asarray(jh.tri)[hit])
    for a, b in ((th.u, jh.u), (th.v, jh.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   atol=ATTR_ATOL)
    np.testing.assert_array_equal(ta.t.numpy() < seg, np.asarray(ja.t) < seg)
    np.testing.assert_allclose(bf.t.numpy(), np.asarray(jh.t), rtol=T_RTOL)


def test_plain_walks_refuse_other_devices():
    """The unpacked walk refuses a tensor off the CPU, and the routed
    queries raise on devices that are neither (no silent fallback)."""
    js, ts = _terrain()
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        ttri.intersect_mesh(ts.mesh, o, o, tmin=TMIN)
    pm = tmk.pack_mesh(ts.mesh)
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.packet_query(pm, o, o, torch.zeros(4, device="meta"), TMIN)
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.bin_rays(tmk.pack_mesh(ts.mesh, 1024, nodes_only=True), o, o,
                     torch.zeros(4, device="meta"), TMIN)
