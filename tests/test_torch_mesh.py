"""The port's mesh slice against the JAX package, without Pallas.

Geometry builders, the NumPy BVH builder, the packed layout, the TRI_LIGHT
tables and light table, and ``mesh_walk_ref`` (the plain version of the
kernels' in-kernel walk) against the XLA traversal
(``tpu_pathtracer/ops/triangle.py::intersect_mesh`` and, for the merge
with the sphere pass, ``ops/intersect.py::intersect``). Meshes built by the
JAX package are carried across with ``mesh_from_numpy``; the SAH builder,
both packages' default, is held to JAX's in ``test_torch_native_bvh.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_scene_camera import scene_to_torch  # noqa: E402
from tpu_pathtracer.models import mesh as jmesh, meshes as jmeshes  # noqa: E402
from tpu_pathtracer.models import scene as jsc  # noqa: E402
from tpu_pathtracer.ops import intersect as jint, triangle as jtri  # noqa: E402
from tpu_pathtracer.ops.pallas import mesh_kernel as jmk  # noqa: E402
from tpu_pathtracer.ops.pallas import trace_kernel as jtk  # noqa: E402
from tpu_pathtracer_torch.models import mesh as tmesh, meshes as tmeshes  # noqa: E402
from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import mesh_kernel as tmk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import trace_kernel as ttk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels._walk import mesh_walk_ref  # noqa: E402

MESH_SCENES = ["cornell-boxes", "cornell-glass", "cornell-quad"]
N_ROWS, TR = 32, 8  # 4096 rays in 4 tiles of 8 x 128 lanes
WALK_AGREE = 0.999  # fraction of rays that must agree
T_RTOL = 1e-4


def _geometry(mod):
    """The merged geometry of cornell_quad (walls, light quad, two boxes)
    from either package's builders."""
    walls = [
        (*mod.quad([-50, 0, 80], [50, 0, 80], [50, 0, -80], [-50, 0, -80]), 0),
        (*mod.quad([-50, 0, -80], [-50, 80, -80], [-50, 80, 80],
                   [-50, 0, 80]), 1),
        (*mod.quad([-15, 79.5, -35], [15, 79.5, -35], [15, 79.5, -5],
                   [-15, 79.5, -5]), 3),
        (*mod.box([-18, 30, -35], [30, 60, 30], rotation_y=0.3), 0),
        (*mod.box([20, 14, -5], [28, 28, 28], rotation_y=-0.25), 2),
        (*mod.box([0, 5, 0], [4, 6, 8]),),
    ]
    return mod.merge(*walls)


def test_geometry_builders_match_jax():
    for a, b in zip(_geometry(tmeshes), _geometry(jmeshes)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf_size", [1, 4, 16])
def test_numpy_bvh_matches_jax(leaf_size):
    """The NumPy median-split builder gives JAX's use_native=False tree and
    triangle order exactly."""
    v, f, uv, m = _geometry(jmeshes)
    jm = jmesh.build_bvh(v, f, uv, m, leaf_size=leaf_size, use_native=False)
    tm = tmesh.build_bvh(v, f, uv, m, leaf_size=leaf_size, use_native=False,
                         device="cpu")
    for name in tmesh.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert (tm.num_tris, tm.num_nodes, tm.leaf_size) == (
        jm.num_tris, jm.num_nodes, jm.leaf_size)


def _jax_scene(name):
    js, _ = jsc.BUILTIN_SCENES[name]()
    return js, scene_to_torch(js)


@pytest.mark.parametrize("collapse", [64, 8, 0])
@pytest.mark.parametrize("name", MESH_SCENES)
def test_pack_mesh_matches_jax(name, collapse):
    """pack_mesh of the carried-across JAX mesh equals JAX's layout."""
    js, ts = _jax_scene(name)
    jp = jmk.pack_mesh(js.mesh, collapse_leaf=collapse)
    tp = tmk.pack_mesh(ts.mesh, collapse_leaf=collapse)
    for f in ("nodes", "tri_rows", "remap"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert (tp.leaf_size, tp.num_nodes) == (jp.leaf_size, jp.num_nodes)
    np.testing.assert_array_equal(tp.boxes.numpy(),
                                  np.asarray(jp.nodes[:, 0:6]).reshape(-1))
    np.testing.assert_array_equal(
        tp.meta.numpy(), np.asarray(jp.nodes[:, 6:9]).astype(np.int32)
        .reshape(-1))


def test_coarse_tree_is_not_ported():
    """The coarse nodes-only tree is ported now (tests/test_torch_packet.py
    holds it against JAX): it has no triangles and lists its leaf cells."""
    js, ts = _jax_scene("cornell-glass")
    tp = tmk.pack_mesh(ts.mesh, collapse_leaf=1024, nodes_only=True)
    jp = jmk.pack_mesh(js.mesh, collapse_leaf=1024, nodes_only=True)
    np.testing.assert_array_equal(tp.nodes.numpy(), np.asarray(jp.nodes))
    np.testing.assert_array_equal(tp.cell_ids.numpy(),
                                  np.asarray(jp.cell_ids))
    assert tp.fine_map is None and not tp.tri_rows.any()


@pytest.mark.parametrize("name", MESH_SCENES)
def test_scene_tables_match_jax(name):
    """make_scene on the carried-across mesh gives JAX's tables, TRI_LIGHT
    tables and static structure exactly; the port's own builder gives the
    same tables but the mesh-order ones."""
    js, _ = _jax_scene(name)
    jm = tmesh.mesh_from_numpy(
        {f: np.asarray(getattr(js.mesh, f)) for f in tmesh.ARRAY_FIELDS},
        device="cpu")
    own, _ = tsc.BUILTIN_SCENES[name](device="cpu")
    # rebuild with the JAX mesh through the port's make_scene
    ts = tsc.make_scene(*_scene_args(name), mesh=jm, device="cpu")
    for f in tsc.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in tsc.STATIC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
        assert getattr(own, f) == getattr(js, f), f
    for f in tsc.TRI_FIELDS:
        if getattr(js, f) is None:
            assert getattr(ts, f) is None and getattr(own, f) is None
        else:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f)
    np.testing.assert_allclose(ttk.pack_lights(ts).numpy(),
                               np.asarray(jtk.pack_lights(js)), rtol=1e-6)


def _scene_args(name):
    """(spheres, materials, lights) of the built-in mesh scenes."""
    if name == "cornell-quad":
        mats = [tsc.diffuse([0.75, 0.75, 0.75]), tsc.diffuse([0.75, 0.25, 0.25]),
                tsc.diffuse([0.25, 0.25, 0.75]), tsc.diffuse([0.0, 0.0, 0.0])]
        return [], mats, [tsc.tri_light(3, [34.0, 34.0, 34.0])]
    if name == "cornell-boxes":
        mats = [tsc.diffuse([0.75, 0.75, 0.75]), tsc.diffuse([0.75, 0.25, 0.25]),
                tsc.diffuse([0.25, 0.25, 0.75]), tsc.diffuse([1.0, 1.0, 1.0])]
        return ([tsc.sphere([0, 86, -20], 10.0, 3, 0)], mats,
                [tsc.area_light(0, [60.0, 60.0, 60.0])])
    return ([tsc.sphere([-25, 16.5, -50], 16.5, 4),
             tsc.sphere([25, 16.5, -25], 16.5, 5),
             tsc.sphere([0, 86, -20], 10.0, 1, 0)],
            tsc.reference_materials(), [tsc.area_light(2, [60.0] * 3)])


def _mixed_lights(mod, mesh):
    """A TRI_LIGHT beside a sphere area light and a point light."""
    return mod.make_scene(
        [mod.sphere([0, 40, 0], 5.0, 0, 0), mod.sphere([20, 10, 0], 3.0, 1)],
        [mod.diffuse([0.7, 0.7, 0.7]), mod.diffuse([0.2, 0.5, 0.8]),
         mod.diffuse([0.0, 0.0, 0.0])],
        [mod.area_light(0, [8.0, 6.0, 4.0]),
         mod.tri_light(2, [30.0, 20.0, 10.0]),
         mod.point_light([0, 70, 10], [500.0, 500.0, 500.0])],
        mesh=mesh, **({"device": "cpu"} if mod is tsc else {}))


def test_pack_lights_weights_triangle_lights_by_area():
    """Selection probabilities of a triangle light are luminance times its
    total emissive area, as in the JAX packer; on a scene that mixes it with
    a sphere area light and a point light the tables agree to 1e-6."""
    v, f, uv, m = _geometry(jmeshes)
    m = np.where(m == 3, 2, 0)
    js = _mixed_lights(jsc, jmesh.build_bvh(v, f, uv, m, use_native=False))
    ts = _mixed_lights(tsc, tmesh.build_bvh(v, f, uv, m, use_native=False,
                                            device="cpu"))
    got, want = ttk.pack_lights(ts).numpy(), np.asarray(jtk.pack_lights(js))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[1, 7] > 0.5  # the big quad takes most of the power


def _rays(seed, n_dead=64):
    """N_ROWS x 128 random rays from inside the Cornell box, the first
    n_dead of them dead (t_init 0)."""
    rng = np.random.default_rng(seed)
    n = N_ROWS * 128
    o = rng.uniform([-49, 1, -79], [49, 79, 79], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    live = np.arange(n) >= n_dead
    return o, d, live


def _planes(x):
    return [torch.tensor(np.ascontiguousarray(x[:, k])).reshape(N_ROWS, 128)
            for k in range(3)]


@pytest.mark.parametrize("collapse", [64, 8])
@pytest.mark.parametrize("name", ["cornell-boxes", "cornell-glass"])
def test_mesh_walk_matches_xla_traversal(name, collapse):
    """Closest mode: t, unit normal and material of >= 99.9% of rays agree
    with the XLA per-ray traversal (t to 1e-4 relative); merged with the
    sphere pass (walk started from the sphere t), the hit agrees with
    ops/intersect.py::intersect; dead lanes do nothing."""
    js, ts = _jax_scene(name)
    pm = tmk.pack_mesh(ts.mesh, collapse_leaf=collapse)
    o, d, live = _rays(3)
    t_big = np.where(live, 1e30, 0.0).astype(np.float32)
    tm, nx, ny, nz, mat = mesh_walk_ref(
        pm, *_planes(o), *_planes(d), torch.tensor(t_big).reshape(N_ROWS, 128),
        tile_rows=TR)
    tm, mat = tm.reshape(-1).numpy(), mat.reshape(-1).numpy()
    n = torch.stack([nx, ny, nz], -1).reshape(-1, 3)
    n = (n / n.norm(dim=-1, keepdim=True).clamp_min(1e-20)).numpy()
    th = jtri.intersect_mesh(js.mesh, jnp.asarray(o), jnp.asarray(d),
                             tmin=tsc.EPSILON)
    jt = np.asarray(th.t)
    jn = np.asarray(js.mesh.n_geom)[np.asarray(th.tri)]
    jm = np.asarray(js.mesh.material_id)[np.asarray(th.tri)]
    ok = (np.abs(tm - jt) <= T_RTOL * np.abs(jt)) & (mat == jm) \
        & (np.abs(n - jn).max(-1) < 1e-5)
    assert ok[live].mean() >= WALK_AGREE, ok[live].mean()
    assert (tm[~live] == 0).all() and (mat[~live] == -1).all()

    # merged with the sphere pass: the walk starts from the sphere t
    t_sph = np.asarray(jnp.min(jint.ray_sphere_t(
        js, jnp.asarray(o), jnp.asarray(d)), axis=-1))
    t0 = np.where(live, t_sph, 0.0).astype(np.float32)
    tm2, *_, mat2 = mesh_walk_ref(
        pm, *_planes(o), *_planes(d), torch.tensor(t0).reshape(N_ROWS, 128),
        tile_rows=TR)
    tm2, mat2 = tm2.reshape(-1).numpy(), mat2.reshape(-1).numpy()
    closer = tm2 < t_sph
    t_hit = np.where(closer, tm2, t_sph)
    jh = jint.intersect(js, jsc.prim_attrs(js), jnp.asarray(o),
                        jnp.asarray(d))
    want_mat = np.asarray(jh.mat)
    got_mat = np.where(closer, mat2,
                       np.asarray(js.material_id)[np.asarray(jh.prim) % 8])
    ok = (np.abs(t_hit - np.asarray(jh.t)) <= T_RTOL * np.asarray(jh.t)) \
        & (got_mat == want_mat)
    assert ok[live].mean() >= WALK_AGREE, ok[live].mean()
    assert closer[live].any() and (~closer[live]).any()


@pytest.mark.parametrize("name", ["cornell-boxes", "cornell-glass"])
def test_mesh_walk_any_hit_matches_xla(name):
    """Occlusion mode: the segments (tmin, tmax) that a triangle blocks are
    the ones the XLA any-hit traversal finds, on >= 99.9% of rays."""
    js, ts = _jax_scene(name)
    pm = tmk.pack_mesh(ts.mesh, collapse_leaf=64)
    o, d, live = _rays(4)
    tmax = np.random.default_rng(5).uniform(1.0, 150.0, o.shape[0])
    tmax = np.where(live, tmax, 0.0).astype(np.float32)
    t = mesh_walk_ref(pm, *_planes(o), *_planes(d),
                      torch.tensor(tmax).reshape(N_ROWS, 128), tile_rows=TR,
                      occlusion=True).reshape(-1).numpy()
    th = jtri.intersect_mesh(js.mesh, jnp.asarray(o), jnp.asarray(d),
                             tmin=tsc.EPSILON, tmax=jnp.asarray(tmax),
                             any_hit=True)
    want = np.asarray(th.t) < tmax
    got = t == 0.0
    assert (got == want)[live].mean() >= WALK_AGREE
    assert want[live].any() and (~want[live]).any()
    assert (t[~live] == 0.0).all()
