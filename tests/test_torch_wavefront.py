"""The port's wavefront integrator against the JAX package, and its renderers.

The port renders with the JAX package's own uniforms (``utils/rng.py``
draws, made by JAX and replayed through ``TableDraws``), so its images are
compared pixel for pixel:

* the four goldens of ``tests/golden/`` (exact threefry renders of the JAX
  integrator): at the goldens' own rtol 1e-4 / atol 1e-5 on >= 98% of pixels,
  the reference's bar for f32 chaos at the 1e5-radius walls, and the image
  mean within 1e-4 relative;
* a small textured terrain against JAX ``trace`` (XLA, one jit), by the same
  bars.

Then the port's own invariants: packed two-pass, packed single-pass and
unpacked renders agree; the bounce-level sort is invisible; the progressive
renderer's image is the mean of its frames; backends route as JAX's do;
textured scenes and lens cameras reach the persistent routes, and the routes
that cannot take them refuse them.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import integrator as jint  # noqa: E402
from tpu_pathtracer.utils import rng as jrng  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models import progressive as tprog  # noqa: E402
from tpu_pathtracer_torch.models.integrator import (  # noqa: E402
    RenderConfig, render_image, trace, trace_pixels,
)
from tpu_pathtracer_torch.ops.kernels import mesh_kernel as tmk  # noqa: E402
from tpu_pathtracer_torch.utils import rng as trng  # noqa: E402

from test_torch_scene_camera import camera_to_torch, scene_to_torch  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
RTOL, ATOL = 1e-4, 1e-5  # the goldens' own tolerance
AGREE = 0.98  # share of pixels within it (f32 chaos at the walls)
MEAN_RTOL = 1e-4


def jax_draws(key, iteration, n_lanes, max_bounces, use_nee):
    """The JAX integrator's uniforms for every lane, as TableDraws."""
    it_key = jrng.iteration_key(key, iteration)
    lanes = jnp.arange(n_lanes, dtype=jnp.int32)
    tabs = {(trng.CAMERA_STREAM, 0): jrng.camera_uniforms(it_key, lanes)}
    for b in range(max_bounces + 1):
        tabs[(trng.BOUNCE_STREAM, b)] = jrng.bounce_uniforms(it_key, b, lanes)
        if use_nee:
            tabs[(trng.LIGHT_STREAM, b)] = jrng.light_uniforms(it_key, b,
                                                               lanes)
    return trng.TableDraws({k: torch.tensor(np.asarray(v))
                            for k, v in tabs.items()})


def _agreement(img, want):
    ok = np.abs(img - want) <= ATOL + RTOL * np.abs(want)
    return ok.all(axis=-1).mean(), abs(img.mean() / want.mean() - 1.0)


def _jax_scene(name, w, h):
    js, cs = jsc.BUILTIN_SCENES[name]()
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    return js, jc


GOLDENS = {
    # name: (scene, w, h, spp, max_bounces, nee, key, file)
    "config1": ("single-sphere", 128, 128, 16, 2, False, 42,
                "config1_128_16spp.npy"),
    "cornell_nee": ("cornell", 64, 48, 4, 6, True, 123,
                    "cornell_nee_64_4spp.npy"),
    "cornell_boxes": ("cornell-boxes", 48, 36, 2, 4, True, 5,
                      "cornell_boxes_48_2spp.npy"),
    "cornell_glass": ("cornell-glass", 48, 36, 2, 6, True, 9,
                      "cornell_glass_48_2spp.npy"),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_goldens_reproduced(case):
    name, w, h, spp, mb, nee, key, fname = GOLDENS[case]
    js, jc = _jax_scene(name, w, h)
    draws = jax_draws(jax.random.key(key), 0, w * h * spp, mb, nee)
    img = render_image(scene_to_torch(js), camera_to_torch(jc), 0,
                       RenderConfig(spp=spp, max_bounces=mb, use_nee=nee),
                       draws=draws).numpy()
    want = np.load(os.path.join(GOLDEN_DIR, fname))
    assert img.shape == want.shape and np.isfinite(img).all()
    agree, mean_gap = _agreement(img, want)
    assert agree >= AGREE, agree
    assert mean_gap <= MEAN_RTOL, mean_gap


TERRAIN = dict(w=32, h=24, spp=2, mb=3)


@pytest.fixture(scope="module")
def terrain():
    """A small textured terrain (n = 16, 450 triangles) at 32x24, 2 spp, 3
    bounces, NEE: the JAX integrator's image (one jit, XLA traversal of the
    unpacked mesh) and the draws it used."""
    js, cs = jsc.terrain_textured(n=16)
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], TERRAIN["w"],
                         TERRAIN["h"], cs["fov"])
    jcfg = jint.RenderConfig(spp=TERRAIN["spp"], max_bounces=TERRAIN["mb"],
                             use_nee=True)
    want = np.asarray(jint.render_image(js, jc, jax.random.key(7), jcfg))
    n = TERRAIN["w"] * TERRAIN["h"] * TERRAIN["spp"]
    draws = jax_draws(jax.random.key(7), 0, n, TERRAIN["mb"], True)
    return dict(ts=scene_to_torch(js), tc=camera_to_torch(jc), want=want,
                draws=draws,
                cfg=RenderConfig(spp=TERRAIN["spp"], max_bounces=TERRAIN["mb"],
                                 use_nee=True))


def test_textured_terrain_matches_jax_trace(terrain):
    t = terrain
    img = render_image(t["ts"], t["tc"], 0, t["cfg"], draws=t["draws"])
    img = img.numpy()
    agree, mean_gap = _agreement(img, t["want"])
    assert agree >= AGREE and mean_gap <= MEAN_RTOL, (agree, mean_gap)
    # the checker shows: the ground holds both albedos' shades
    assert img.std() > 0.05 and t["ts"].textured


def test_packed_renders_equal_unpacked(terrain):
    """Packed two-pass, packed single-pass (bounce sort) and unpacked
    renders of the same draws agree pixel for pixel."""
    t = terrain
    base = render_image(t["ts"], t["tc"], 0, t["cfg"], draws=t["draws"])
    for two_pass in (True, False):
        sp = tsc.with_packet_mesh(t["ts"], two_pass=two_pass)
        img = render_image(sp, t["tc"], 0, t["cfg"], draws=t["draws"])
        agree, mean_gap = _agreement(img.numpy(), base.numpy())
        assert agree >= 0.999 and mean_gap <= MEAN_RTOL, (two_pass, agree)


def test_bounce_sort_is_invisible(terrain, monkeypatch):
    """The single-pass packed render with its bounce-level and in-call sorts
    equals the same render with every sort key constant (lanes in raster
    order): the draws follow the lane ids, and the walk is per lane."""
    t = terrain
    sp = tsc.with_packet_mesh(t["ts"], two_pass=False)
    cfg = dataclasses.replace(t["cfg"], count_rays=True)
    sorted_img, rays = render_image(sp, t["tc"], 0, cfg, draws=t["draws"])
    monkeypatch.setattr(tmk, "packet_sort_key",
                        lambda o, d, alive=None: torch.zeros(
                            o.shape[0], dtype=torch.int32))
    plain_img, rays2 = render_image(sp, t["tc"], 0, cfg, draws=t["draws"])
    assert torch.equal(sorted_img, plain_img) and int(rays) == int(rays2)
    assert int(rays) >= TERRAIN["w"] * TERRAIN["h"] * TERRAIN["spp"]


def test_trace_is_keyed_on_lane_ids():
    """Tracing a shuffled batch with its lane ids gives each lane the
    radiance it gets in order: the Philox draws follow the global lane id."""
    scene, cs = tsc.cornell_boxes(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 12, 9,
                          cs["fov"], device="cpu")
    cfg = RenderConfig(spp=2, max_bounces=3, use_nee=True)
    draws = trng.philox_draws(3, 1)
    lanes = torch.arange(12 * 9 * 2, dtype=torch.int32)
    a = trace_pixels(scene, cam, lanes, draws, cfg)
    perm = torch.randperm(lanes.numel(), generator=torch.Generator()
                          .manual_seed(0))
    b = trace_pixels(scene, cam, lanes[perm], draws, cfg)
    assert torch.equal(a[perm], b)
    c = draws(trng.BOUNCE_STREAM, 2, lanes[:5], 3)
    assert torch.equal(c, trng.philox_draws(3, 1)(trng.BOUNCE_STREAM, 2,
                                                   lanes[:5], 3))
    assert not torch.equal(c, trng.philox_draws(3, 2)(trng.BOUNCE_STREAM, 2,
                                                       lanes[:5], 3))
    assert float(c.min()) >= 0.0 and float(c.max()) < 1.0


def test_progressive_renderer_accumulates_and_resets():
    scene, cs = tsc.single_sphere(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 16,
                          cs["fov"], device="cpu")
    cfg = RenderConfig(spp=2, max_bounces=2, use_nee=True)
    r = tprog.ProgressiveRenderer(scene, cam, cfg, seed=5, device="cpu")
    frames = []
    for it in range(3):
        frames.append(render_image(scene, cam, 5, cfg, iteration=it))
        r.step()
    assert r.iteration == 3
    torch.testing.assert_close(r.image(), torch.stack(frames).mean(0),
                               rtol=1e-5, atol=1e-6)
    r.reset()
    assert r.iteration == 0 and not r.state.radiance_sum.any()
    r.step()
    r.update_camera(tcm.translate(cam, [0.0, 0.0, 1.0]))
    assert r.iteration == 0 and not r.state.radiance_sum.any()


def test_auto_backend_routes_as_jax():
    scene, _ = tsc.cornell_boxes(device="cpu")
    big, _ = tsc.terrain_textured(n=80, device="cpu")  # 12,482 triangles
    assert tprog.BIG_MESH_TRIS == 10_000
    assert tprog.auto_backend(scene, "cpu") == "xla"
    assert tprog.auto_backend(big, "cpu") == "xla"
    assert tprog.auto_backend(scene, "cuda") == "pallas"
    assert tprog.auto_backend(big, "cuda") == "xla"
    sph, _ = tsc.cornell_spheres(device="cpu")
    assert tprog.auto_backend(sph, "cuda") == "pallas"


def test_cli_render_wavefront(tmp_path):
    from tpu_pathtracer_torch import cli
    from tpu_pathtracer_torch.io.image import read_png

    out = tmp_path / "boxes.png"
    rc = cli.main(["render", "--scene", "cornell-boxes", "--size", "16x12",
                   "--spp", "1", "--iterations", "2", "--bounces", "2",
                   "--nee", "--backend", "xla", "--device", "cpu", "-o",
                   str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img.max() > 0


def test_textured_scenes_and_lenses_are_refused(terrain):
    """The tangent walk refuses a textured scene (ValueError, as in the JAX
    package); the forward persistent step and PersistentRenderer render it,
    and the gradient walk gives its atlas gradient. A lens camera made by dataclasses.replace
    packs with its lens and renders through the persistent step, the
    renderer and the wavefront; the tangent walk refuses it (ValueError,
    also for a packed camera with a lens slot)."""
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    ts, cam = terrain["ts"], terrain["tc"]
    sp = tsc.with_packet_mesh(ts)
    cp = pack_camera(cam)
    w, h = cam.width, cam.height
    st = pk.init_state(w, h, 8, device="cpu")
    kw = dict(budget=2, width=w, height=h, tile_rows=8)
    st_k, rays = pk.persistent_step(sp, cp, (0, 0), st, **kw)
    st_r, rays_r = pk.persistent_step_ref(sp, cp, (0, 0), st, **kw)
    assert int(rays) == int(rays_r) > 0
    assert torch.equal(st_k.lr, st_r.lr)
    assert torch.isfinite(pk.state_image(st_k, w, h)).all()
    lanes = torch.zeros((st.lr.shape[0], 128, 3))
    # the gradient walk takes the textured terrain: an atlas gradient
    grad = rp.persistent_replay_call(sp, cp, (0, 0), 0, lanes, spp=1, **kw)
    assert grad[6].shape == sp.textures.shape
    assert bool(torch.isfinite(grad[6]).all()) and torch.isfinite(grad[2])
    with pytest.raises(ValueError, match="uv-motion"):
        cj.camera_jvp_call(sp, cp, torch.zeros(24), (0, 0), 0, spp=1, **kw)
    r = tprog.PersistentRenderer(ts, cam, RenderConfig(max_bounces=1),
                                 device="cpu", budget=2, tile_rows=8)
    r.step()
    assert torch.isfinite(r.image()).all() and float(r.image().mean()) > 0

    scene, cs = tsc.cornell_spheres(device="cpu")
    pin = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 8, 6,
                          cs["fov"], device="cpu")
    lens = dataclasses.replace(pin, lens_radius=0.5,
                               focal_distance=torch.tensor(40.0))
    weights = torch.ones((6, 8, 3))
    # the packer keeps the lens, so every persistent route traces it
    cp_lens = pack_camera(lens)
    assert float(cp_lens[12]) == 0.5 and float(cp_lens[13]) == 40.0
    r = tprog.PersistentRenderer(scene, lens, RenderConfig(max_bounces=1),
                                 device="cpu", budget=2, tile_rows=8)
    r.step()
    assert torch.isfinite(r.image()).all()
    with pytest.raises(ValueError, match="lens"):
        cj.camera_jvp_call(scene, cp_lens, torch.zeros(24), (0, 0), 0,
                           spp=1, budget=2, width=8, height=6)
    with pytest.raises(ValueError, match="lens"):
        cj.camera_weighted_grad(scene, lens, (0, 0), weights, spp=1,
                                budget=2)
    with pytest.raises(ValueError, match="lens"):
        cj.ior_mse_grad(scene, lens, (0, 0), weights, spp=1, budget=2)
    with pytest.raises(ValueError, match="lens"):
        cj.ior_weighted_grad(scene, lens, (0, 0), weights, spp=1, budget=2)
    img_lens = render_image(scene, lens, 0, RenderConfig(spp=1, max_bounces=1))
    assert torch.isfinite(img_lens).all()
    # the pinhole camera still runs every route, and differs
    img = render_image(scene, pin, 0, RenderConfig(spp=1, max_bounces=1))
    assert torch.isfinite(img).all() and not torch.equal(img, img_lens)


def test_trace_direct_rays_match_jax():
    """trace() on given rays with JAX's bounce draws equals JAX trace() on
    the same rays: cornell_quad with its TRI_LIGHT, NEE, Russian roulette
    from bounce 0."""
    js, jc = _jax_scene("cornell-quad", 8, 8)
    rng = np.random.default_rng(11)
    n = 256
    o = np.tile(np.float32([[0, 45, 79.0]]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lanes = np.arange(n, dtype=np.int32)
    key = jrng.iteration_key(jax.random.key(13), 0)
    jcfg = jint.RenderConfig(max_bounces=5, rr_start=0, use_nee=True)
    want = np.asarray(jax.jit(jint.trace, static_argnames="config")(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lanes), key,
        config=jcfg))
    draws = jax_draws(jax.random.key(13), 0, n, 5, True)
    got = trace(scene_to_torch(js), torch.tensor(o), torch.tensor(d),
                torch.tensor(lanes), draws,
                RenderConfig(max_bounces=5, rr_start=0, use_nee=True))
    ok = np.abs(got.numpy() - want) <= ATOL + RTOL * np.abs(want)
    assert ok.all(axis=-1).mean() >= AGREE
    assert want.mean() > 0.05
    assert abs(got.numpy().mean() / want.mean() - 1.0) <= MEAN_RTOL
