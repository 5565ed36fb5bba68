"""JSON scene files and the scene builders they use, against the JAX
package.

``io/scene_io.py`` builds a Scene from the same document as JAX's, every
array equal (the mesh through the SAH builder, so with no carry-across);
``uv_sphere``, ``load_obj`` and ``sphere_field`` give JAX's arrays bit for
bit; the errors are JAX's; and the JSON mesh scene's image through the
port's wavefront on JAX's uniforms matches JAX ``render_image`` at the
goldens' tolerance (rtol 1e-4 / atol 1e-5 on >= 98% of pixels, the mean
within 1e-4: the bar of ``test_torch_wavefront.py``). No Pallas call.
"""
from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpu_pathtracer.io import scene_io as jio  # noqa: E402
from tpu_pathtracer.models import camera as jcm, meshes as jmeshes  # noqa: E402
from tpu_pathtracer.models import integrator as jint, scene as jsc  # noqa: E402
from tpu_pathtracer_torch.cli import main as cli_main  # noqa: E402
from tpu_pathtracer_torch.io import scene_io as tio  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, meshes as tmeshes  # noqa: E402
from tpu_pathtracer_torch.models import mesh as tmesh, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import (  # noqa: E402
    RenderConfig, render_image,
)

from test_torch_wavefront import (  # noqa: E402
    AGREE, MEAN_RTOL, _agreement, jax_draws,
)

OBJ = "v -2 6 -2\nv 2 6 -2\nv 0 6 2\nf 1 2 3\n"
# the mesh document of tests/test_io.py, and a uv_sphere beside it
MESH_DOC = {
    "camera": {"eye": [0, 4, 12], "look_at": [0, 2, 0], "fov": 60.0},
    "materials": [
        {"type": "diffuse", "color": [0.7, 0.7, 0.7]},
        {"type": "diffuse", "color": [0.8, 0.2, 0.2]},
        {"type": "diffuse", "color": [1.0, 1.0, 1.0]},
        {"type": "specular", "color": [0.9, 0.9, 0.9]},
    ],
    "meshes": [
        {"type": "quad", "corners": [[-8, 0, 8], [8, 0, 8], [8, 0, -8],
                                     [-8, 0, -8]], "material": 0},
        {"type": "box", "center": [0, 1.5, 0], "size": [2, 3, 2],
         "rotation_y": 0.4, "material": 1},
        {"type": "obj", "path": "tri.obj", "material": 2},
        {"type": "uv_sphere", "center": [3, 1.5, -1], "radius": 1.2,
         "material": 3, "n_lat": 8, "n_lon": 12},
    ],
    "lights": [{"type": "tri", "material": 2, "intensity": [25, 25, 25]}],
}
# the sphere document of tests/test_io.py's CLI test, with a point light,
# a glass ball and a terrain
SPHERE_DOC = {
    "camera": {"eye": [0, 0, 4], "look_at": [0, 0, 0], "up": [0, 1, 0],
               "fov": 50.0, "lens_radius": 0.1, "focal_distance": 4.0},
    "materials": [{"type": "diffuse", "color": [0.8, 0.2, 0.2]},
                  {"type": "transmissive", "color": [1, 1, 1], "ior": 1.4}],
    "spheres": [
        {"center": [0, 0, 0], "radius": 1.0, "material": 0},
        {"center": [0, 2.5, 0], "radius": 0.5, "material": 0, "light": 0},
        {"center": [1.5, 0, 1], "radius": 0.4, "material": 1},
    ],
    "lights": [{"type": "area", "prim": 1, "intensity": [15, 15, 15]},
               {"type": "point", "pos": [0, 5, 0],
                "intensity": [100, 100, 100]}],
}
TERRAIN_DOC = {
    "materials": [{"type": "diffuse", "color": [0.5, 0.6, 0.4]}],
    "spheres": [{"center": [0, 60, 0], "radius": 10.0, "material": 0,
                 "light": 0}],
    "meshes": [{"type": "terrain", "n": 12, "extent": 40, "height": 5,
                "seed": 2, "material": 0}],
    "lights": [{"type": "area", "prim": 0, "intensity": [9, 9, 9]}],
}


def assert_same_scene(ts, js):
    """Every array and static field, the TRI_LIGHT tables and the mesh."""
    for f in tsc.ARRAY_FIELDS + tsc.TRI_FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    for f in tsc.STATIC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    assert (ts.mesh is None) == (js.mesh is None)
    if ts.mesh is not None:
        for f in tmesh.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(ts.mesh, f).numpy(),
                                          np.asarray(getattr(js.mesh, f)),
                                          err_msg=f"mesh.{f}")
        assert ts.mesh.num_nodes == js.mesh.num_nodes


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    (d / "tri.obj").write_text(OBJ)
    for name, doc in (("mesh", MESH_DOC), ("spheres", SPHERE_DOC),
                      ("terrain", TERRAIN_DOC)):
        (d / f"{name}.json").write_text(json.dumps(doc))
    return d


@pytest.mark.parametrize("args", [([0, 3, 0], 2.0, 16, 24),
                                  ([1, -2, 0.5], 0.7, 5, 7)])
def test_uv_sphere_matches_jax(args):
    for a, b in zip(tmeshes.uv_sphere(*args), jmeshes.uv_sphere(*args)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", [
    OBJ,
    # uvs, a quad and a pentagon (fan-triangulated), a shared vertex whose
    # last vt wins, normals' slots and blank lines
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 2 0.25\n\nvt 0 0\nvt 1 0\n"
    "vt 1 1\nvt 0 1\nvt 0.5 0.5\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
    "f 1/5 2 3/1 5//1 4\n",
])
def test_load_obj_matches_jax(tmp_path, text):
    p = tmp_path / "m.obj"
    p.write_text(text)
    for a, b in zip(tmeshes.load_obj(str(p)), jmeshes.load_obj(str(p))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sphere_field_matches_jax():
    """128 spheres drawn in JAX's order: every array, the static structure
    and the camera equal; the builtin is registered."""
    ts, tcs = tsc.sphere_field(device="cpu")
    js, jcs = jsc.sphere_field()
    assert_same_scene(ts, js)
    assert tcs == jcs and ts.num_prims == 128
    assert tsc.BUILTIN_SCENES["sphere-field"] is tsc.sphere_field


@pytest.mark.parametrize("name", ["mesh", "spheres", "terrain"])
def test_load_scene_matches_jax(scene_dir, name):
    path = str(scene_dir / f"{name}.json")
    ts, tcs = tio.load_scene(path, device="cpu")
    js, jcs = jio.load_scene(path)
    assert_same_scene(ts, js)
    assert tcs == jcs


@pytest.mark.parametrize("name", ["cornell", "small", "single-sphere",
                                  "sphere-field"])
def test_scene_to_dict_matches_jax(tmp_path, name):
    """The port's document of a builtin sphere scene is JAX's, and it loads
    back into the same scene."""
    ts, cs = tsc.BUILTIN_SCENES[name](device="cpu")
    js, _ = jsc.BUILTIN_SCENES[name]()
    doc = tio.scene_to_dict(ts, cs)
    assert doc == jio.scene_to_dict(js, cs)
    p = str(tmp_path / "s.json")
    tio.save_scene(p, ts, cs)
    back, cs2 = tio.load_scene(p, device="cpu")
    assert cs2["eye"] == cs["eye"] and cs2["fov"] == cs["fov"]
    for f in ("centers", "radii", "mat_color", "mat_type", "mat_coef",
              "light_intensity", "light_prim", "light_pos"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(ts, f).numpy(), err_msg=f)


BAD_DOCS = {
    "material type": {"materials": [{"type": "velvet", "color": [1, 1, 1]}]},
    "sphere material": {
        "materials": [{"type": "diffuse", "color": [1, 1, 1]}],
        "spheres": [{"center": [0, 0, 0], "radius": 1, "material": 5}]},
    "mesh material": {
        "materials": [{"type": "diffuse", "color": [1, 1, 1]}],
        "meshes": [{"type": "box", "center": [0, 0, 0], "size": [1, 1, 1],
                    "material": 5}]},
    "mesh type": {
        "materials": [{"type": "diffuse", "color": [1, 1, 1]}],
        "meshes": [{"type": "torus", "material": 0}]},
    "light type": {
        "materials": [{"type": "diffuse", "color": [1, 1, 1]}],
        "lights": [{"type": "spot", "pos": [0, 0, 0]}]},
}


@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_validation_errors_match_jax(case):
    """tests/test_io.py's validation cases and the unknown mesh and light
    types raise ValueError with JAX's messages."""
    doc = BAD_DOCS[case]
    with pytest.raises(ValueError) as want:
        jio.scene_from_dict(copy.deepcopy(doc))
    with pytest.raises(ValueError) as got:
        tio.scene_from_dict(copy.deepcopy(doc), device="cpu")
    assert str(got.value) == str(want.value)


def test_mesh_scenes_refuse_to_serialize(scene_dir):
    ts, cs = tio.load_scene(str(scene_dir / "mesh.json"), device="cpu")
    with pytest.raises(ValueError, match="mesh scenes do not serialize"):
        tio.scene_to_dict(ts, cs)


def test_relative_obj_paths_resolve_against_the_file(scene_dir, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)  # no tri.obj here
    ts, _ = tio.load_scene(str(scene_dir / "mesh.json"), device="cpu")
    assert ts.has_tri_lights and ts.tri_light_counts[0] == 1
    with pytest.raises(FileNotFoundError):
        tio.scene_from_dict(MESH_DOC, base_dir=str(tmp_path), device="cpu")


def test_json_mesh_scene_image_matches_jax(scene_dir):
    """The slice end to end on the CPU: the JSON mesh scene (TRI_LIGHT, NEE)
    loaded by each package and rendered by each integrator on JAX's
    uniforms."""
    w, h, spp, mb = 24, 18, 2, 3
    path = str(scene_dir / "mesh.json")
    js, cs = jio.load_scene(path)
    ts, _ = tio.load_scene(path, device="cpu")
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    tc = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device="cpu")
    key = jax.random.key(2)
    want = np.asarray(jint.render_image(
        js, jc, key, jint.RenderConfig(spp=spp, max_bounces=mb,
                                       use_nee=True)))
    img = render_image(ts, tc, 0, RenderConfig(spp=spp, max_bounces=mb,
                                               use_nee=True),
                       draws=jax_draws(key, 0, w * h * spp, mb, True))
    img = img.numpy()
    assert img.shape == want.shape and np.isfinite(img).all()
    assert img.max() > 0
    agree, mean_gap = _agreement(img, want)
    assert agree >= AGREE, agree
    assert mean_gap <= MEAN_RTOL, mean_gap


def test_cli_renders_a_json_scene(scene_dir, tmp_path, capsys):
    """cli render --scene file.json on the CPU writes the PNG and the linear
    .npy, and -q keeps the progress line off stderr."""
    png, npy = str(tmp_path / "o.png"), str(tmp_path / "o.npy")
    rc = cli_main(["render", "--scene", str(scene_dir / "mesh.json"),
                   "--size", "16x12", "--spp", "1", "--iterations", "2",
                   "--bounces", "2", "--nee", "--device", "cpu",
                   "--gamma", "1.0", "-o", png, "--hdr-output", npy, "-q"])
    assert rc == 0 and os.path.exists(png)
    hdr = np.load(npy)
    assert hdr.shape == (12, 16, 3) and hdr.dtype == np.float32
    assert np.isfinite(hdr).all() and hdr.max() > 0
    assert capsys.readouterr().err == ""
