"""The port's per-sample value-and-grad walk (kernel 7, ``replay_call``) and
the ``engine="sample"`` trainer against the JAX package.

The JAX side runs ``replay_call(..., interpret=True)``, whose interpret mode
draws an external threefry block (``jax.random.key(1)`` folded with seed[0]
+ 131 seed[1], the iteration and the global tile, ``replay_kernel.py:
684-697``); the same block is rebuilt here and handed to the port's plain
version through numpy. Four JAX interpret-mode calls:

* mode "vjp", brute force, on a random cotangent: lanes, gA_raw, gI_raw and
  rays; ``render_target_kernel(engine="sample")`` is this walk's lanes (its
  g does not enter L) averaged per pixel (JAX ``diff/inverse.py:531-547``);
* mode "mse", NEE, a thin lens: lanes, rays and the loss. A lens start
  off the eye flips one or two of the 768 lanes' f32 walks here, which the
  lane bar admits and a whole-image bar does not, so the loss is held over
  the pixels whose lanes agree (each side's loss is first held to the MSE
  of its own lanes);
* mode "vjp", the same walk, on the MSE cotangent of the JAX lanes zeroed
  on the pixels whose lanes do not agree: the gradients over the agreeing
  pixels;
* one ``make_kernel_train_step(engine="sample")`` step (mode "mse", brute
  force): parameters and loss to 1e-5, Adam's first moment (the gradient)
  to the gradient bar.

Bars: at least 98% of lanes within ``1e-4 * max(1, |L|)``, the loss within
rtol 1e-4, gA_raw and gI_raw within rtol 2e-3 (the JAX suite's), rays
within 1%. The rest checks the port alone: global tiles, mode "vjp"
against mode "mse", the routes that raise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_inverse import _adam_np, _np_params  # noqa: E402
from test_torch_scene_camera import camera_to_torch, scene_to_torch  # noqa: E402
from tpu_pathtracer.diff import inverse as jinv  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models.integrator import (  # noqa: E402
    RenderConfig as JRenderConfig,
)
from tpu_pathtracer.ops.pallas import replay_kernel as jrk  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.diff import inverse as tinv  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import replay_kernel as trk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import trace_kernel as ttk  # noqa: E402
from tpu_pathtracer_torch.utils.metrics import AGREE, L_TOL  # noqa: E402

W, H, SPP, MB, TR = 16, 12, 4, 3, 8
RRS = 1  # roulette from the third vertex on, inside the 4 bounces
LOSS_RTOL, GRAD_RTOL = 1e-4, 2e-3  # tests/test_replay_kernel.py's bars
RAY_TOL = 0.01  # chip_smoke.py's bar
LENS = dict(lens_radius=4.0, focal_distance=60.0)
LR, STEP_TOL = 5e-2, 1e-5  # tests/test_torch_inverse.py's step bar


def jax_block(seed, iteration, n_tiles, use_nee, use_dof=False,
              tile_offset=0):
    """The external block interpret mode feeds the JAX kernel, flattened
    to the port's (n_tiles * n_draw * TR, 128)."""
    n_draw = ttk.sample_n_draws(MB, use_nee, use_dof)
    rkey = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(1), seed[0] + 131 * seed[1]),
        iteration)
    return np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(rkey, t),
                                      (n_draw * TR, 128), jnp.float32))
        for t in range(tile_offset, tile_offset + n_tiles)])


def _agree(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.abs(a - b) <= L_TOL * np.maximum(1.0, np.abs(b))
    return float(ok.reshape(-1, 3).all(-1).mean())


def _cameras(cs, lens):
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                         **(LENS if lens else {}))
    return jc, camera_to_torch(jc)


@pytest.fixture(scope="module")
def scenes():
    js, cs = jsc.cornell_spheres()
    return js, cs, scene_to_torch(js)


def _both(js, ts, jc, tc, seed, aux, u, **kw):
    """The JAX kernel in interpret mode and the port's plain version on the
    same inputs, as numpy."""
    jout = jrk.replay_call(js, jpack_camera(jc), jnp.asarray(seed, jnp.int32),
                           jnp.int32(0), jnp.asarray(aux), interpret=True,
                           **kw)
    tout = trk.replay_call(ts, ttk.pack_camera(tc), seed, 0,
                           torch.tensor(aux), uniforms=u, **kw)
    return [np.asarray(x) for x in jout], [x.numpy() for x in tout]


def _pixel_mask(jL, tL, n_lanes):
    """Per lane: 1 where every lane of its pixel agrees, else 0."""
    ok = (np.abs(tL - jL) <= L_TOL * np.maximum(1.0, np.abs(jL))).all(-1)
    ok = ok.reshape(-1)
    ok[n_lanes:] = True
    return ok.reshape(-1, SPP).all(-1).repeat(SPP).reshape(jL.shape[:2])


@pytest.fixture(scope="module")
def calls(scenes):
    """The three replay calls of the module docstring, each on both
    sides."""
    js, cs, ts = scenes
    rows, n_lanes = jrk.lanes_layout(W, H, SPP, TR)
    rng = np.random.default_rng(11)
    kw = dict(spp=SPP, width=W, height=H, max_bounces=MB, rr_start=RRS,
              tile_rows=TR)
    out = {}
    jc, tc = _cameras(cs, False)
    g = (rng.standard_normal((rows, 128, 3)) * 1e-3).astype(np.float32)
    u = torch.tensor(jax_block((4, 3), 0, rows // TR, False))
    out["vjp-brute"] = dict(zip(("jax", "port"), _both(
        js, ts, jc, tc, (4, 3), g, u, mode="vjp", **kw)), u=u, tc=tc,
        seed=(4, 3))
    jc, tc = _cameras(cs, True)
    tgt = np.asarray(jrk.broadcast_pixels_to_lanes(
        jnp.asarray(rng.random((H, W, 3), np.float32)), SPP, rows))
    u = torch.tensor(jax_block((6, 1), 0, rows // TR, True, True))
    kw_lens = dict(kw, use_nee=True, use_dof=True)
    j, t = _both(js, ts, jc, tc, (6, 1), tgt, u, mode="mse", **kw_lens)
    mask = _pixel_mask(j[0], t[0], n_lanes)
    out["mse-nee-lens"] = dict(jax=j, port=t, tgt=tgt, mask=mask)
    g = trk.lane_cotangent(torch.tensor(j[0]), torch.tensor(tgt), SPP, W,
                           H).numpy() * mask[..., None]
    out["vjp-nee-lens"] = dict(zip(("jax", "port"), _both(
        js, ts, jc, tc, (6, 1), g, u, mode="vjp", **kw_lens)), mask=mask)
    for v in out.values():
        v["n_lanes"] = n_lanes
    return out


@pytest.mark.parametrize("name", ["vjp-brute", "mse-nee-lens",
                                  "vjp-nee-lens"])
def test_lanes_and_rays_match_jax_kernel(calls, name):
    case = calls[name]
    jL, port_L = case["jax"][0], case["port"][0]
    n = case["n_lanes"]
    assert _agree(port_L.reshape(-1, 3)[:n], jL.reshape(-1, 3)[:n]) >= AGREE
    assert (port_L.reshape(-1, 3)[n:] == 0).all()
    jr, tr = int(case["jax"][4]), int(case["port"][4])
    assert abs(tr - jr) <= RAY_TOL * jr


@pytest.mark.parametrize("name", ["vjp-brute", "vjp-nee-lens"])
def test_grads_match_jax_kernel(calls, name):
    """Mode "vjp": the same cotangent on both sides (zeroed where the lens
    walk's lanes disagree), gA_raw and gI_raw within 2e-3."""
    case = calls[name]
    _, jloss, jgA, jgI, _ = case["jax"]
    _, tloss, tgA, tgI, _ = case["port"]
    assert float(tloss) == 0.0 == float(jloss)
    np.testing.assert_allclose(tgA, jgA, rtol=GRAD_RTOL,
                               atol=1e-6 * np.abs(jgA).max())
    np.testing.assert_allclose(tgI, jgI, rtol=GRAD_RTOL,
                               atol=1e-6 * np.abs(jgI).max())
    assert np.abs(tgA).max() > 0 and np.abs(tgI).max() > 0
    if "mask" in case:  # the lens walk: at most two pixels masked out
        assert case["mask"].reshape(-1)[:case["n_lanes"]].mean() >= AGREE


def test_mse_loss_matches_jax_kernel(calls):
    """Mode "mse" with NEE and the lens: each side's loss is the MSE of its
    own lanes' pixel means (rtol 1e-5, the sum's order), and the two agree
    over the pixels whose lanes agree (rtol 1e-4)."""
    case = calls["mse-nee-lens"]
    tgt = case["tgt"].reshape(-1, 3)[:case["n_lanes"]:SPP]
    pix = case["mask"].reshape(-1)[:case["n_lanes"]:SPP]

    def mse(L, keep):
        img = L.reshape(-1, 3)[:case["n_lanes"]].reshape(-1, SPP, 3).mean(1)
        d = (img.astype(np.float64) - tgt) ** 2
        return float((d * keep[:, None]).sum() / (W * H * 3))

    everywhere = np.ones_like(pix)
    for side in ("jax", "port"):
        np.testing.assert_allclose(float(case[side][1]),
                                   mse(case[side][0], everywhere), rtol=1e-5)
    np.testing.assert_allclose(mse(case["port"][0], pix),
                               mse(case["jax"][0], pix), rtol=LOSS_RTOL)


def test_render_target_matches_jax(scenes, calls):
    """render_target_kernel(engine="sample") is the vjp walk's lanes
    averaged per pixel (its g does not enter L); the JAX function averages
    the same lanes."""
    case = calls["vjp-brute"]
    jL = case["jax"][0].reshape(-1, 3)[:case["n_lanes"]]
    want = jL.reshape(H * W, SPP, 3).mean(1)
    cfg = RenderConfig(spp=SPP, max_bounces=MB, rr_start=RRS)
    got = tinv.render_target_kernel(scenes[2], case["tc"], case["seed"],
                                    cfg, tile_rows=TR, engine="sample",
                                    uniforms=case["u"])
    assert tuple(got.shape) == (H * W, 3)
    assert _agree(got.numpy(), want) >= AGREE


@pytest.fixture(scope="module")
def jax_step(scenes):
    """One JAX train step on the sample engine from perturbed parameters."""
    js, cs, _ = scenes
    jc, _ = _cameras(cs, False)
    config = JRenderConfig(spp=SPP, max_bounces=MB, rr_start=RRS)
    target = np.random.default_rng(12).random((H, W, 3), np.float32)
    perturbed = js.replace(
        mat_color=jnp.clip(js.mat_color * 0.6 + 0.1, 0.0, 1.0),
        light_intensity=js.light_intensity * 0.7)
    optimizer = optax.adam(LR)
    state0 = jinv.init_state(perturbed, optimizer)
    step = jinv.make_kernel_train_step(
        perturbed, jc, config, optimizer, fixed_iteration=0, tile_rows=TR,
        engine="sample", interpret=True)
    seed = (13, 1)
    state1, loss = step(state0, jnp.asarray(target),
                        jnp.asarray(seed, jnp.int32))
    return dict(state0=state0, state1=state1, loss=float(loss),
                target=target, seed=seed)


def test_sample_train_step_matches_jax(scenes, jax_step):
    """The port's step on the sample engine from the carried-across state
    equals JAX's: parameters and loss to 1e-5, Adam's first moment (0.1 x
    the gradient) to the gradient bar."""
    _, cs, ts = scenes
    _, tc = _cameras(cs, False)
    s0 = jax_step["state0"]
    state = tinv.train_state_from_numpy(_np_params(s0.params),
                                        _adam_np(s0.opt_state), 0, lr=LR,
                                        device="cpu")
    rows, _ = trk.lanes_layout(W, H, SPP, TR)
    u = torch.tensor(jax_block(jax_step["seed"], 0, rows // TR, False))
    step = tinv.make_kernel_train_step(
        ts, tc, RenderConfig(spp=SPP, max_bounces=MB, rr_start=RRS),
        fixed_iteration=0, tile_rows=TR, engine="sample", uniforms=u)
    state, loss = step(state, torch.tensor(jax_step["target"]),
                       jax_step["seed"])
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=STEP_TOL)
    params, adam, n = tinv.train_state_to_numpy(state)
    want = _adam_np(jax_step["state1"].opt_state)
    assert n == 1 and adam["count"] == want["count"] == 1
    for k in tinv.PARAMS:
        np.testing.assert_allclose(
            params[k], np.asarray(jax_step["state1"].params[k]),
            atol=STEP_TOL, err_msg=k)
        np.testing.assert_allclose(adam["mu"][k], want["mu"][k],
                                   rtol=GRAD_RTOL, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], device="cpu")
    return scene, cam


def test_tile_offset_addresses_global_tiles(cornell):
    """A launch over tile 1 alone (tile_offset 1) replays that tile of the
    whole launch: its lanes bit for bit, on Philox draws and on the slice
    of the injected block; the per-tile partials sum to the whole's."""
    scene, cam = cornell
    cp = ttk.pack_camera(cam)
    tr = 2  # 3 tiles of 256 lanes
    rows, _ = trk.lanes_layout(W, H, SPP, tr)
    g = torch.randn((rows, 128, 3), generator=torch.Generator().manual_seed(
        4)) * 1e-3
    kw = dict(spp=SPP, width=W, height=H, max_bounces=MB, rr_start=RRS,
              tile_rows=tr, use_nee=True, mode="vjp")
    n_draw = ttk.sample_n_draws(MB, True)
    block = torch.rand((rows * n_draw, 128),
                       generator=torch.Generator().manual_seed(5))
    for u in (None, block):
        whole = trk.replay_call(scene, cp, (3, 1), 2, g, uniforms=u, **kw)
        parts = [trk.replay_call(
            scene, cp, (3, 1), 2, g[t * tr:(t + 1) * tr].contiguous(),
            tile_offset=t,
            uniforms=None if u is None
            else u[t * tr * n_draw:(t + 1) * tr * n_draw], **kw)
            for t in range(rows // tr)]
        for t, part in enumerate(parts):
            assert torch.equal(part[0], whole[0][t * tr:(t + 1) * tr])
        for i in (2, 3):
            np.testing.assert_allclose(sum(p[i] for p in parts).numpy(),
                                       whole[i].numpy(), rtol=1e-5,
                                       atol=1e-9)
        assert sum(int(p[4]) for p in parts) == int(whole[4])


@pytest.mark.parametrize("spp,use_nee", [(1, True), (4, False), (16, True)])
def test_vjp_mode_matches_mse_mode(cornell, spp, use_nee):
    """Mode "vjp" fed the lane-local MSE cotangent of mode "mse"'s own
    pixel means gives mode "mse"'s gradients (JAX
    test_vjp_mode_matches_mse_g); padding lanes stay black."""
    scene, cam = cornell
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(6))
    rows, n_lanes = trk.lanes_layout(W, H, spp, TR)
    aux = trk.broadcast_pixels_to_lanes(target, spp, rows)
    kw = dict(spp=spp, width=W, height=H, max_bounces=MB, rr_start=RRS,
              tile_rows=TR, use_nee=use_nee)
    cp = ttk.pack_camera(cam)
    L, loss, gA, gI, _ = trk.replay_call(scene, cp, (8, 2), 1, aux, **kw)
    g = trk.lane_cotangent(L, aux, spp, W, H)
    L2, loss2, gA2, gI2, _ = trk.replay_call(scene, cp, (8, 2), 1, g,
                                             mode="vjp", **kw)
    assert torch.equal(L, L2) and float(loss2) == 0.0
    assert (L.reshape(-1, 3)[n_lanes:] == 0).all()
    img = L.reshape(-1, 3)[:n_lanes].reshape(H, W, spp, 3).mean(2)
    np.testing.assert_allclose(float(loss),
                               float(torch.mean((img - target) ** 2)),
                               rtol=1e-5)
    np.testing.assert_allclose(gA2.numpy(), gA.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(gI2.numpy(), gI.numpy(), rtol=1e-5, atol=1e-9)


def test_sample_trainer_lowers_the_loss(cornell):
    """Same-seed descent on the sample engine, production Philox."""
    scene, cam = cornell
    config = RenderConfig(spp=SPP, max_bounces=MB, use_nee=True)
    target = tinv.render_target_kernel(scene, cam, (21, 0), config,
                                       tile_rows=TR, engine="sample")
    p0 = tinv.params_of(scene)
    p0["mat_color"][3] = 0.3
    p0["light_intensity"] *= 0.5
    state = tinv.init_state(scene, tinv.make_optimizer(LR), p0)
    step = tinv.make_kernel_train_step(scene, cam, config, fixed_iteration=0,
                                       tile_rows=TR, engine="sample")
    losses = [float(step(state, target, (21, 0))[1]) for _ in range(4)]
    assert losses[-1] < losses[0] and state.step == 4


def test_sample_routes(cornell):
    """spp must divide 128 (JAX's ValueError); unknown modes, mesh scenes
    and other devices raise; textures as a parameter raise the atlas
    ValueError naming the engine; mat_coef composes through the tangent
    walk; the kernel's Philox stream is its own; the launch counter counts
    kernel launches only."""
    scene, cam = cornell
    cp = ttk.pack_camera(cam)
    rows, _ = trk.lanes_layout(W, H, 3, TR)
    aux = torch.zeros((rows, 128, 3))
    with pytest.raises(ValueError, match="must divide 128"):
        trk.replay_call(scene, cp, (0, 0), 0, aux, spp=3, width=W, height=H)
    rows, _ = trk.lanes_layout(W, H, 2, TR)
    aux = torch.zeros((rows, 128, 3))
    with pytest.raises(ValueError, match="unknown mode"):
        trk.replay_call(scene, cp, (0, 0), 0, aux, spp=2, width=W, height=H,
                        tile_rows=TR, mode="both")
    boxes, _ = tsc.cornell_boxes(device="cpu")
    with pytest.raises(ValueError, match="has a mesh"):
        trk.replay_call(boxes, cp, (0, 0), 0, aux, spp=2, width=W, height=H,
                        tile_rows=TR)
    with pytest.raises(ValueError, match="unsupported device"):
        trk.replay_call(scene, cp, (0, 0), 0, aux.to("meta"), spp=2,
                        width=W, height=H, tile_rows=TR)
    target = torch.zeros((H, W, 3))
    params = tinv.params_of(scene)
    with pytest.raises(ValueError, match="engine='sample'"):
        tinv.kernel_loss_and_grads(
            dict(params, textures=torch.full((1, 2, 2, 3), 0.5)), scene, cam,
            target, (0, 0), 0, spp=2, engine="sample")
    loss, grads = tinv.kernel_loss_and_grads(
        tinv.params_of(scene, ior=True), scene, cam, target, (0, 0), 0,
        spp=2, max_bounces=2, tile_rows=TR, budget=4, engine="sample")
    assert set(grads) == {"mat_color", "light_intensity", "mat_coef"}
    assert torch.isfinite(loss) and torch.isfinite(grads["mat_coef"]).all()
    lane = torch.arange(64).reshape(1, 64)
    a = ttk.sample_draws(lane, 8, 1, 2, 1, 0, trk.STREAM)
    b = ttk.sample_draws(lane, 8, 1, 2, 1, 0, ttk.STREAM)
    assert all(not torch.equal(a(j), b(j)) for j in range(8))
    before = trk.launches
    trk.replay_call(scene, cp, (0, 0), 0, aux, spp=2, width=W, height=H,
                    tile_rows=TR, max_bounces=1)
    assert trk.launches == before
