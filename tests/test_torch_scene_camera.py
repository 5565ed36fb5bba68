"""The port's scene builders, packers and camera against the JAX package.

Scenes and cameras are built by the JAX builders and carried across with
``scene_from_numpy`` / ``camera_from_numpy``, so both sides compute on the
same tables; the port's own builders are checked against them too.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.ops.pallas import trace_kernel as jtk  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models import mesh as tmesh  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import trace_kernel as ttk  # noqa: E402

RTOL = 1e-6  # packers: the same f32 arithmetic on the same tables
CAM_ATOL = 1e-5  # camera: f32 transcendentals and normalizations


def scene_to_torch(js, device="cpu"):
    """Carry a JAX Scene across to the port, with its mesh (the JAX build,
    triangle order included), TRI_LIGHT tables and texture atlas; a packed
    JAX mesh is packed again by the port's own pack_mesh, with the coarse
    tree where the JAX scene has one."""
    mesh = None
    if js.mesh is not None:
        mesh = tmesh.mesh_from_numpy(
            {f: np.asarray(getattr(js.mesh, f)) for f in tmesh.ARRAY_FIELDS},
            leaf_size=js.mesh.leaf_size, device=device)
    arrays = {f: np.asarray(getattr(js, f))
              for f in tsc.ARRAY_FIELDS + tsc.TRI_FIELDS + ("textures",)
              if getattr(js, f) is not None}
    ts = tsc.scene_from_numpy(
        arrays, {f: getattr(js, f) for f in tsc.STATIC_FIELDS}, mesh=mesh,
        device=device)
    if js.mesh_packed is None:
        return ts
    return tsc.with_packet_mesh(
        ts, two_pass=js.mesh_packed_coarse is not None)


def camera_to_torch(jc, device="cpu"):
    """Carry a JAX Camera across to the port."""
    return tcm.camera_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in tcm.ARRAY_FIELDS},
        {f: getattr(jc, f) for f in tcm.STATIC_FIELDS}, device=device)


def point_light_scene(mod, **device):
    """The point-light scene of tests/test_persistent.py, from either
    package's builders (``device`` goes to the port's)."""
    return mod.make_scene(
        [mod.sphere([0, -1e4 - 1, 0], 1e4, 0)],
        [mod.diffuse([0.7, 0.7, 0.7])],
        [mod.point_light([0, 3, 0], [40.0, 40.0, 40.0])],
        **device,
    )


SCENES = ["cornell", "small", "single-sphere", "point"]


def _build(mod, name):
    device = {"device": "cpu"} if mod is tsc else {}
    if name == "point":
        return point_light_scene(mod, **device)
    return mod.BUILTIN_SCENES[name](**device)[0]


@pytest.mark.parametrize("name", SCENES)
def test_packers_match_jax(name):
    js = _build(jsc, name)
    ts = scene_to_torch(js)
    np.testing.assert_allclose(ttk.pack_prims(ts).numpy(),
                               np.asarray(jtk.pack_prims(js)), rtol=RTOL)
    np.testing.assert_allclose(ttk.pack_lights(ts).numpy(),
                               np.asarray(jtk.pack_lights(js)), rtol=RTOL)
    ja, ta = jsc.prim_attrs(js), tsc.prim_attrs(ts)
    for f in ("albedo", "coef", "mtype", "emission"):
        np.testing.assert_allclose(getattr(ta, f).numpy(),
                                   np.asarray(getattr(ja, f)), rtol=RTOL)


@pytest.mark.parametrize("name", SCENES)
def test_builders_match_jax(name):
    """The port's own builders give the JAX tables and static structure."""
    js, ts = _build(jsc, name), _build(tsc, name)
    for f in tsc.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in tsc.STATIC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f


@pytest.mark.parametrize("name", ["cornell", "small", "single-sphere"])
def test_camera_matches_jax(name):
    _, cs = jsc.BUILTIN_SCENES[name]()
    args = (cs["eye"], cs["look_at"], cs["up"], 40, 30, cs["fov"])
    jc, tc = jcm.make_camera(*args), tcm.make_camera(*args, device="cpu")
    for f in tcm.ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)),
                                   atol=CAM_ATOL, err_msg=f)
    np.testing.assert_allclose(ttk.pack_camera(tc).numpy(),
                               np.asarray(jtk.pack_camera(jc)),
                               atol=CAM_ATOL)
    np.testing.assert_allclose(ttk.pack_camera(camera_to_torch(jc)).numpy(),
                               np.asarray(jtk.pack_camera(jc)), rtol=RTOL)

    moved_j = jcm.rotate(jcm.translate(jc, [1.5, -2.0, 3.0]), [0.3, -0.2])
    moved_t = tcm.rotate(tcm.translate(tc, [1.5, -2.0, 3.0]), [0.3, -0.2])
    for f in ("pos", "view", "px_x", "px_y", "first_ray_dir"):
        np.testing.assert_allclose(getattr(moved_t, f).numpy(),
                                   np.asarray(getattr(moved_j, f)),
                                   atol=CAM_ATOL, err_msg=f)

    rng = np.random.default_rng(0)
    px = rng.integers(0, 40, 64).astype(np.int32)
    py = rng.integers(0, 30, 64).astype(np.int32)
    ju, jv = rng.uniform(-0.5, 0.5, (2, 64)).astype(np.float32)
    jo, jd = jcm.generate_rays(jc, jnp.asarray(px), jnp.asarray(py),
                               jnp.asarray(ju), jnp.asarray(jv))
    to, td = tcm.generate_rays(tc, torch.as_tensor(px), torch.as_tensor(py),
                               torch.as_tensor(ju), torch.as_tensor(jv))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=CAM_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=CAM_ATOL)


BAD_SCENES = {
    "material id": ([{"center": [0, 0, 0], "radius": 1.0, "material": 3,
                      "light": -1}], 1, []),
    "area prim": ([{"center": [0, 0, 0], "radius": 1.0, "material": 0,
                    "light": -1}], 1, [{"type": 1, "prim": 5,
                                        "intensity": [1, 1, 1]}]),
    "sphere light id": ([{"center": [0, 0, 0], "radius": 1.0, "material": 0,
                          "light": 2}], 1, []),
    "tri light without a mesh": ([], 1, [{"type": 2, "material": 0,
                                          "intensity": [1, 1, 1]}]),
}


@pytest.mark.parametrize("case", sorted(BAD_SCENES))
def test_make_scene_validation_matches_jax(case):
    spheres, n_mats, lights = BAD_SCENES[case]
    mats = [{"type": 0, "color": [0.5, 0.5, 0.5], "coef": 0.0}] * n_mats
    with pytest.raises(ValueError):
        jsc.make_scene(spheres, mats, lights)
    with pytest.raises(ValueError):
        tsc.make_scene(spheres, mats, lights, device="cpu")


def test_unported_features_raise():
    """The thin lens, textures and the coarse two-pass tree are ported (a
    lens camera keeps its lens; tests/test_torch_dof.py,
    tests/test_torch_persistent_texture.py, tests/test_torch_packet.py); a
    route that still cannot sample textures refuses a textured scene
    through refuse_textures, with its reason and its error type."""
    mats = [tsc.diffuse([0.5, 0.5, 0.5])]
    lens = tcm.make_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 8, 8,
                           lens_radius=1.0, focal_distance=5.0, device="cpu")
    assert lens.use_dof and lens.lens_radius == 1.0
    assert float(lens.focal_distance) == 5.0
    assert not tcm.make_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 8, 8,
                               device="cpu").use_dof
    tex = tsc.make_scene([], mats, textures=np.zeros((4, 4, 3)),
                         mat_texture=[0], device="cpu")
    assert tex.textured and tex.textures.shape == (1, 4, 4, 3)
    untextured = tsc.make_scene([], mats, mat_texture=[0], device="cpu")
    assert not untextured.textured
    scene, _ = tsc.cornell_glass(device="cpu")
    assert tsc.with_packet_mesh(scene).mesh_packed_coarse is not None
    with pytest.raises(NotImplementedError, match="item 12"):
        tsc.refuse_textures(tex, "the gradient kernel", "item 12")
    with pytest.raises(ValueError, match="the tangent walk does not take"):
        tsc.refuse_textures(tex, "the tangent walk", "Slice E", ValueError)
    tsc.refuse_textures(untextured, "the gradient kernel", "item 12")
