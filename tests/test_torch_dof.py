"""Thin-lens depth of field in the port against the JAX package.

Two JAX interpret-mode compiles, each once per module: the forward step
(``persistent_step(use_dof=True)``) and the fused value-and-grad walk
(``persistent_replay_call(use_dof=True)``), on cornell_spheres with NEE and
a lens of radius 4 focused at 60 (``tests/test_persistent.py:224-227``).
With the lens and NEE a lane draws 10 uniforms per iteration, in the JAX
order ``u_cam, v_cam, u_lens, v_lens, u1, u2, u3, ul1, ul2, usel``; the
blocks are rebuilt here with the same ``jax.random`` calls and handed to
the port's plain versions. The bars are those of
``tests/test_torch_persistent.py`` and ``tests/test_torch_replay_persistent.py``.
The persistent kernels map the lens uniforms to the disk by the polar map;
the wavefront's camera (``generate_rays``) by the concentric map, as in the
JAX package, and it is held to JAX ``render_image`` on JAX's own draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_persistent import jax_uniforms, torch_state  # noqa: E402
from test_torch_replay_persistent import (  # noqa: E402
    jax_uniforms as jax_grad_uniforms,
)
from test_torch_scene_camera import (  # noqa: E402
    camera_to_torch, scene_to_torch,
)
from test_torch_wavefront import jax_draws  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import integrator as jint  # noqa: E402
from tpu_pathtracer.ops.pallas import persistent as jpk  # noqa: E402
from tpu_pathtracer.ops.pallas import replay_persistent as jrp  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer.utils import rng as jrng  # noqa: E402
from tpu_pathtracer_torch import (  # noqa: E402
    PersistentRenderer, ProgressiveRenderer, RenderConfig,
)
from tpu_pathtracer_torch.diff import inverse  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import render_image  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import replay_persistent as trp  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    pack_camera,
)
from tpu_pathtracer_torch.utils import rng as trng  # noqa: E402
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, grad_lane_agreement, lane_agreement,
)

LENS = dict(lens_radius=4.0, focal_distance=60.0)
TR = 8
MB, RRS, BUDGET, FRAMES = 3, 0, 4, 2
FOLD_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4, 2e-3


def _jax_cornell(w, h, **lens):
    js, cs = jsc.cornell_spheres()
    return js, jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                               cs["fov"], **lens)


@pytest.fixture(scope="module")
def forward():
    """The JAX forward kernel with the lens, NEE (10 draws), 16x8, over 2
    frames in interpret mode, and the port's plain version on its
    uniforms."""
    w, h, seed = 16, 8, (6, 5)
    js, jc = _jax_cornell(w, h, **LENS)
    kw = dict(budget=BUDGET, width=w, height=h, max_bounces=MB, rr_start=RRS,
              tile_rows=TR, use_nee=True, use_dof=True)
    jst = jpk.init_state(w, h, tile_rows=TR)
    jrays = []
    for _ in range(FRAMES):
        jst, nr = jpk.persistent_step(js, jpack_camera(jc),
                                      jnp.asarray(seed, jnp.int32), jst,
                                      interpret=True, **kw)
        jrays.append(int(nr))
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    tst = tpk.init_state(w, h, tile_rows=TR, device="cpu")
    trays = []
    for f in range(FRAMES):
        u = torch.tensor(jax_uniforms(seed, f, tst.lr.shape[0] // TR, BUDGET,
                                      True, use_dof=True))
        tst, nr = tpk.persistent_step(ts, pack_camera(tc), seed, tst,
                                      uniforms=u, **kw)
        trays.append(int(nr))
    return dict(w=w, h=h, jst=jst, tst=tst, jrays=jrays, trays=trays, tc=tc,
                jc=jc)


def test_forward_dof_matches_jax_kernel(forward):
    """>= 98% of lanes agree on n_samp and radiance after 2 frames; the
    live-ray counts within 1%."""
    w, h = forward["w"], forward["h"]
    n_agree, l_agree, _ = lane_agreement(torch_state(forward["jst"]),
                                         forward["tst"], w, h)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    assert torch.isfinite(tpk.state_image(forward["tst"], w, h)).all()
    for rj, rt in zip(forward["jrays"], forward["trays"]):
        assert abs(rj - rt) <= 0.01 * rj, (forward["jrays"], forward["trays"])


def test_lens_camera_packs_like_jax(forward):
    """make_camera and pack_camera keep the lens: the packed camera equals
    JAX's, lens slots 12-13 and the view rows 14-22 included."""
    np.testing.assert_allclose(pack_camera(forward["tc"]).numpy(),
                               np.asarray(jpack_camera(forward["jc"])),
                               rtol=1e-6, atol=1e-6)
    cs = jsc.cornell_spheres()[1]
    own = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 8,
                          cs["fov"], device="cpu", **LENS)
    assert own.use_dof and own.lens_radius == 4.0
    np.testing.assert_allclose(pack_camera(own).numpy(),
                               np.asarray(jpack_camera(forward["jc"])),
                               rtol=1e-5, atol=1e-5)


def test_lens_spreads_the_image():
    """The lens blurs out-of-focus geometry: the plain version's lens image
    differs from the pinhole one on the same Philox draws, stays finite and
    keeps its brightness (the lens moves light, it adds none)."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    w, h = 32, 24
    kw = dict(budget=12, width=w, height=h, max_bounces=2, tile_rows=TR)
    imgs = {}
    for dof in (False, True):
        cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                              cs["fov"], device="cpu",
                              **(LENS if dof else {}))
        st = tpk.init_state(w, h, tile_rows=TR, device="cpu")
        for _ in range(4):
            st, _ = tpk.persistent_step(scene, pack_camera(cam), (3, 7), st,
                                        use_dof=dof, **kw)
        imgs[dof] = tpk.state_image(st, w, h)
    assert torch.isfinite(imgs[True]).all()
    assert float((imgs[True] - imgs[False]).abs().max()) > 0.05
    assert abs(float(imgs[True].mean()) / float(imgs[False].mean()) - 1) < 0.1


def test_production_draws_keep_the_pinhole_layout():
    """With the lens the Philox draws take a third group (10 draws); the
    first two groups, and so a pinhole launch's draws, are unchanged."""
    lane = torch.arange(256, dtype=torch.int64)
    pin = tpk.philox_uniforms(lane, 5, 1, 2, 3, tpk.n_draws(True))
    lens = tpk.philox_uniforms(lane, 5, 1, 2, 3, tpk.n_draws(True, True))
    assert len(pin) == 8 and len(lens) == 10
    assert all(torch.equal(a, b) for a, b in zip(pin, lens))
    cam, lp, bsdf, nee = tpk.split_draws(lens, True, True)
    assert lp == tuple(lens[2:4]) and bsdf == tuple(lens[4:7])
    assert nee == tuple(lens[7:10])
    assert tpk.split_draws(pin, True, False)[1] is None


# ---------------------------------------------------------------------------
# Kernel 3: the fused value-and-grad walk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gradient():
    """One JAX interpret-mode adjoint launch with the lens and NEE, and the
    port's plain version (phases "adjoint" and "both") on its uniforms."""
    w, h, spp, seed = 16, 12, 2, (9, 4)
    js, jc = _jax_cornell(w, h, **LENS)
    rows, _ = jrp.pixel_lanes_layout(w, h, TR)
    target = np.random.default_rng(7).random((h, w, 3), np.float32)
    kw = dict(spp=spp, budget=BUDGET, width=w, height=h, max_bounces=MB,
              rr_start=RRS, tile_rows=TR, use_nee=True, use_dof=True)
    jout = jrp.persistent_replay_call(
        js, jpack_camera(jc), jnp.asarray(seed, jnp.int32), jnp.int32(0),
        jrp.target_to_lanes(jnp.asarray(target), rows), interpret=True,
        phase="adjoint", **kw)
    jL, jns, jga, jgi, jrays, _ = (None if x is None else np.asarray(x)
                                   for x in jout)
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    tgt = trp.target_to_lanes(torch.tensor(target), rows)
    u = torch.tensor(jax_grad_uniforms(seed, 0, rows // TR, BUDGET, True,
                                       use_dof=True))
    args = (ts, pack_camera(tc), seed, 0, tgt)
    adj = trp.persistent_replay_call(*args, phase="adjoint", uniforms=u, **kw)
    both = trp.persistent_replay_call(*args, phase="both", uniforms=u, **kw)
    return dict(w=w, h=h, jax=tuple(torch.tensor(x)
                                    for x in (jL, jns, jga, jgi)),
                jrays=int(jrays), adj=adj, both=both, tgt=tgt, ts=ts, tc=tc,
                u=u, kw=kw, seed=seed)


def test_gradient_dof_lanes_match_jax_kernel(gradient):
    """>= 98% of lanes agree on n_samp, L and every GA/GI plane; equal
    live-ray counts up to one segment per thousand."""
    w, h = gradient["w"], gradient["h"]
    L, ns, ga, gi, rays, _ = gradient["adj"]
    agree = grad_lane_agreement(gradient["jax"], (L, ns, ga, gi), w, h)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    for name, frac in agree["planes"].items():
        assert frac >= AGREE, (name, agree)
    jr = gradient["jrays"]
    assert abs(int(rays) - jr) <= max(1, jr // 1000), (int(rays), jr)


def test_gradient_dof_fold_matches_jax(gradient):
    """Phase "both" equals the fold over phase "adjoint"'s lanes, and that
    fold over the agreeing lanes equals the JAX kernel's."""
    w, h, tgt = gradient["w"], gradient["h"], gradient["tgt"]
    L, ns, ga, gi, _, _ = gradient["adj"]
    _, _, loss, gA, gI, _, _ = gradient["both"]
    f_loss, f_gA, f_gI = trp.mse_fold(L, ns, ga, gi, tgt, w, h)
    np.testing.assert_allclose(float(loss), float(f_loss), rtol=FOLD_RTOL)
    np.testing.assert_allclose(gA.numpy(), f_gA.numpy(), rtol=FOLD_RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(gI.numpy(), f_gI.numpy(), rtol=FOLD_RTOL,
                               atol=1e-9)
    mask = grad_lane_agreement(gradient["jax"], (L, ns, ga, gi), w,
                               h)["mask"]
    t_fold = trp.mse_fold(L, ns, ga, gi, tgt, w, h, mask)
    j_fold = trp.mse_fold(*gradient["jax"], tgt, w, h, mask)
    np.testing.assert_allclose(float(t_fold[0]), float(j_fold[0]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_fold[1].numpy(), j_fold[1].numpy(),
                               rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(t_fold[2].numpy(), j_fold[2].numpy(),
                               rtol=GRAD_RTOL, atol=1e-7)
    assert np.abs(gA.numpy()).max() > 0


def test_trainer_takes_the_lens(gradient):
    """The trainer's loss and gradients with a lens camera are the fused
    walk's with use_dof (the camera decides, as JAX's camera.use_dof
    does), and differ from the same camera's pinhole walk."""
    g = gradient
    w, h = g["w"], g["h"]
    kw = {k: v for k, v in g["kw"].items()
          if k not in ("width", "height", "use_dof")}
    target = g["tgt"].reshape(-1, 3)[: w * h].reshape(h, w, 3)
    params = inverse.params_of(g["ts"])
    loss, grads = inverse.kernel_loss_and_grads(
        params, g["ts"], g["tc"], target, g["seed"], 0, uniforms=g["u"],
        **kw)
    np.testing.assert_allclose(float(loss), float(g["both"][2]), rtol=1e-6)
    pin = dataclasses.replace(g["tc"], lens_radius=0.0)
    n_pin = trp.pixel_lanes_layout(w, h, TR)[0] // TR * BUDGET \
        * tpk.n_draws(True) * TR
    loss_pin, _ = inverse.kernel_loss_and_grads(
        params, g["ts"], pin, target, g["seed"], 0,
        uniforms=g["u"].reshape(-1)[: n_pin * 128].reshape(-1, 128), **kw)
    assert float(loss_pin) != float(loss)
    assert all(torch.isfinite(v).all() for v in grads.values())


# ---------------------------------------------------------------------------
# The wavefront and the renderers
# ---------------------------------------------------------------------------

def test_generate_rays_lens_matches_jax():
    """The wavefront's thin lens (concentric disk map) gives JAX's primary
    rays to f32 rounding: origins within 1e-6 relative (plus 1e-5),
    directions within 1e-6."""
    js, jc = _jax_cornell(64, 48, **LENS)
    tc = camera_to_torch(jc)
    rng = np.random.default_rng(0)
    n = 4096
    px, py = rng.integers(0, 64, n), rng.integers(0, 48, n)
    u = [rng.random(n).astype(np.float32) for _ in range(4)]
    u[0], u[1] = u[0] - 0.5, u[1] - 0.5
    jo, jd = jcm.generate_rays(jc, jnp.asarray(px), jnp.asarray(py),
                               *(jnp.asarray(x) for x in u))
    o, d = tcm.generate_rays(tc, torch.tensor(px), torch.tensor(py),
                             *(torch.tensor(x) for x in u))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    # the origins spread over the lens disk of radius 4
    off = np.linalg.norm(o.numpy() - np.asarray(jc.pos), axis=-1)
    assert off.max() <= 4.0 + 1e-4 and off.max() > 3.5


def test_wavefront_lens_matches_jax_render():
    """render_image with a lens camera on JAX's own draws (the lens pair
    from LENS_STREAM) equals JAX render_image pixel for pixel, at the
    goldens' rtol 1e-4 / atol 1e-5 on >= 98% of pixels. The image means
    agree within 1%: a lens ray starts off the eye, so more paths meet the
    1e5-radius walls at angles where one ulp changes the hit than a pinhole
    camera's do (at 32x24, 2 spp: 0.991 of pixels agree, the few others
    move the mean by 0.27%; the primary rays themselves agree to rounding,
    test_generate_rays_lens_matches_jax)."""
    w, h, spp, mb = 32, 24, 2, 3
    js, jc = _jax_cornell(w, h, **LENS)
    key = jax.random.key(21)
    want = np.asarray(jint.render_image(
        js, jc, key, jint.RenderConfig(spp=spp, max_bounces=mb,
                                       use_nee=True)))
    n = w * h * spp
    draws = jax_draws(key, 0, n, mb, True)
    draws.tables[(trng.LENS_STREAM, 0)] = torch.tensor(np.asarray(
        jrng.lens_uniforms(jrng.iteration_key(key, 0),
                           jnp.arange(n, dtype=jnp.int32))))
    img = render_image(scene_to_torch(js), camera_to_torch(jc), 0,
                       RenderConfig(spp=spp, max_bounces=mb, use_nee=True),
                       draws=draws).numpy()
    ok = np.abs(img - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert ok.all(axis=-1).mean() >= AGREE
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-2
    pin = render_image(scene_to_torch(js),
                       dataclasses.replace(camera_to_torch(jc),
                                           lens_radius=0.0), 0,
                       RenderConfig(spp=spp, max_bounces=mb, use_nee=True),
                       draws=draws).numpy()
    assert np.abs(pin - img).max() > 0.05


def test_renderers_take_a_lens_camera():
    """PersistentRenderer launches with use_dof from the camera, and
    ProgressiveRenderer renders the lens through the wavefront; both give
    finite images that differ from the pinhole camera's."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    cfg = RenderConfig(spp=1, max_bounces=2, use_nee=True)
    out = {}
    for dof in (False, True):
        cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 12,
                              cs["fov"], device="cpu",
                              **(LENS if dof else {}))
        r = PersistentRenderer(scene, cam, cfg, seed=3, device="cpu",
                               budget=6, tile_rows=TR)
        r.step()
        p = ProgressiveRenderer(scene, cam, cfg, seed=3, device="cpu")
        p.step()
        out[dof] = (r.image(), p.image())
    for a, b in zip(out[False], out[True]):
        assert torch.isfinite(b).all()
        assert float((a - b).abs().max()) > 0.05
