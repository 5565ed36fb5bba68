"""The port's inverse-rendering trainer against the JAX package's.

One JAX ``make_kernel_train_step(..., interpret=True)`` step (brute force,
the fused kernel in interpret mode on its external uniforms) against the
port's step from the same parameters and Adam state, carried across with
``train_state_from_numpy``, on the same uniforms. Adam alone is checked
against ``optax.adam`` on the same numpy gradients. The rest checks the
port's own contracts: ``KernelMSE``'s backward, the routes that are not
ported, the refusal to fall back from the card, and import without JAX.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_replay_persistent import jax_uniforms  # noqa: E402
from test_torch_scene_camera import camera_to_torch, scene_to_torch  # noqa: E402
from tpu_pathtracer.diff import inverse as jinv  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models.integrator import (  # noqa: E402
    RenderConfig as JRenderConfig,
)
from tpu_pathtracer.ops.pallas.replay_persistent import (  # noqa: E402
    pixel_lanes_layout,
)
from tpu_pathtracer_torch.diff import inverse as tinv  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import RenderConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
W, H, TR = 16, 12, 8
SPP, MB, BUDGET = 2, 3, 6
RRS = 0  # Russian roulette from the second vertex on, inside the 3 bounces
# On this seed every lane takes the same path in both implementations, so
# the step is held to 1e-5. (Seed (13, 0) has a lane that makes
# a grazing hit on the glass ball, det = 1.37 against terms of ~1e3, and
# refracts onto the near-tie between the emitter and the ceiling; that f32
# chaos is what the lane tests' 98% bars are for.)
SEED = (13, 1)
LR = 5e-2
STEP_TOL = 1e-5  # parameters and loss after one train step
# Adam's first moment after that step is 0.1 * the gradient: the same lanes
# summed in another order.
GRAD_TOL = 1e-4
# Adam: the same update in f32 in another order of operations; relative
# above 1, where 1e-6 is below one ulp (ulp(12) = 9.5e-7).
ADAM_TOL = 1e-6


def _np_params(params):
    return {k: np.asarray(params[k]) for k in tinv.PARAMS}


def _adam_np(opt_state):
    """optax.adam's state -> the {"count", "mu", "nu"} of
    train_state_from_numpy."""
    st = opt_state[0]
    return {"count": int(st.count), "mu": _np_params(st.mu),
            "nu": _np_params(st.nu)}


@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step from perturbed parameters, and its inputs."""
    js, cs = jsc.cornell_spheres()
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"])
    config = JRenderConfig(spp=SPP, max_bounces=MB, rr_start=RRS)
    target = np.random.default_rng(11).random((H, W, 3), np.float32)
    perturbed = js.replace(
        mat_color=jnp.clip(js.mat_color * 0.6 + 0.1, 0.0, 1.0),
        light_intensity=js.light_intensity * 0.7)
    optimizer = optax.adam(LR)
    state0 = jinv.init_state(perturbed, optimizer)
    step = jinv.make_kernel_train_step(
        perturbed, jc, config, optimizer, fixed_iteration=0, tile_rows=TR,
        budget=BUDGET, interpret=True)
    state1, loss = step(state0, jnp.asarray(target),
                        jnp.asarray(SEED, jnp.int32))
    return dict(js=js, jc=jc, target=target, state0=state0, state1=state1,
                loss=float(loss))


def test_train_step_matches_jax(jax_step):
    """The port's step from the carried-across state equals JAX's: the
    parameters and the loss after the step to 1e-5, Adam's moment to
    GRAD_TOL."""
    js, jc = jax_step["js"], jax_step["jc"]
    s0 = jax_step["state0"]
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    state = tinv.train_state_from_numpy(_np_params(s0.params),
                                        _adam_np(s0.opt_state), 0, lr=LR,
                                        device="cpu")
    rows, _ = pixel_lanes_layout(W, H, TR)
    u = torch.tensor(jax_uniforms(SEED, 0, rows // TR, BUDGET, False))
    step = tinv.make_kernel_train_step(
        ts, tc, RenderConfig(spp=SPP, max_bounces=MB, rr_start=RRS),
        fixed_iteration=0, tile_rows=TR, budget=BUDGET, uniforms=u)
    state, loss = step(state, torch.tensor(jax_step["target"]), SEED)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), jax_step["loss"], rtol=STEP_TOL)
    params, adam, n = tinv.train_state_to_numpy(state)
    want = _adam_np(jax_step["state1"].opt_state)
    assert n == 1 and adam["count"] == want["count"] == 1
    for k in tinv.PARAMS:
        np.testing.assert_allclose(
            params[k], np.asarray(jax_step["state1"].params[k]),
            atol=STEP_TOL, err_msg=k)
        np.testing.assert_allclose(adam["mu"][k], want["mu"][k],
                                   rtol=GRAD_TOL, atol=1e-7, err_msg=k)


def test_adam_matches_optax():
    """torch Adam fed optax's numpy gradients agrees for 3 steps; halfway
    through, the optax state is carried across and both continue."""
    rng = np.random.default_rng(4)
    p0 = {"mat_color": rng.random((8, 3), np.float32),
          "light_intensity": rng.random((8, 3), np.float32) * 12}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 0.1
              for k, v in p0.items()} for _ in range(3)]
    opt = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    state = tinv.train_state_from_numpy(p0, None, 0, lr=LR, device="cpu")
    for i, g in enumerate(grads):
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for k in tinv.PARAMS:
            state.params[k].grad = torch.tensor(g[k])
        state.optimizer.step()
        for k in tinv.PARAMS:
            np.testing.assert_allclose(state.params[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=ADAM_TOL,
                                       rtol=ADAM_TOL)
        if i == 1:  # carry optax's state across and go on from it
            state = tinv.train_state_from_numpy(
                _np_params(jp), _adam_np(js), 2, lr=LR, device="cpu")


def test_train_state_round_trip():
    rng = np.random.default_rng(6)
    params = {k: rng.random((8, 3), np.float32) for k in tinv.PARAMS}
    adam = {"count": 7,
            "mu": {k: rng.random((8, 3), np.float32) for k in tinv.PARAMS},
            "nu": {k: rng.random((8, 3), np.float32) for k in tinv.PARAMS}}
    back = tinv.train_state_to_numpy(
        tinv.train_state_from_numpy(params, adam, 5, lr=LR, device="cpu"))
    assert back[2] == 5 and back[1]["count"] == 7
    for k in tinv.PARAMS:
        np.testing.assert_array_equal(back[0][k], params[k])
        np.testing.assert_array_equal(back[1]["mu"][k], adam["mu"][k])
        np.testing.assert_array_equal(back[1]["nu"][k], adam["nu"][k])
    fresh = tinv.train_state_to_numpy(
        tinv.train_state_from_numpy(params, None, 0, lr=LR, device="cpu"))
    assert fresh[1] is None


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], device="cpu")
    return scene, cam


def test_persistent_mse_backward_scales_saved_grads(cornell):
    """KernelMSE's backward (engine "persistent") is the cotangent times
    the gradients of kernel_loss_and_grads, and its forward is the same
    loss."""
    scene, cam = cornell
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(2))
    params = tinv.params_of(scene)
    kw = dict(spp=SPP, max_bounces=MB, tile_rows=TR, budget=BUDGET)
    loss, grads = tinv.kernel_loss_and_grads(params, scene, cam, target,
                                             (3, 1), 0, **kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    fwd = dict(kw, engine="persistent", rr_start=3, use_nee=False,
               strat_k=2, uniforms=None)
    out = tinv.KernelMSE.apply(leaves["mat_color"],
                                   leaves["light_intensity"], scene, cam,
                                   target, (3, 1), 0, fwd)
    assert torch.equal(out, loss)
    g_a, g_i = torch.autograd.grad(2.5 * out, [leaves["mat_color"],
                                               leaves["light_intensity"]])
    assert torch.equal(g_a, 2.5 * grads["mat_color"])
    assert torch.equal(g_i, 2.5 * grads["light_intensity"])
    assert grads["light_intensity"].shape == scene.light_intensity.shape
    assert float(grads["mat_color"].abs().max()) > 0


def test_trainer_lowers_the_loss(cornell):
    """Same-seed descent from perturbed parameters, production Philox."""
    scene, cam = cornell
    config = RenderConfig(spp=SPP, max_bounces=MB)
    target = tinv.render_target_kernel(scene, cam, (21, 0), config,
                                       tile_rows=TR, budget=BUDGET)
    p0 = tinv.params_of(scene)
    p0["mat_color"][3] = 0.3
    p0["light_intensity"] *= 0.5
    state = tinv.init_state(scene, tinv.make_optimizer(LR), p0)
    step = tinv.make_kernel_train_step(scene, cam, config, fixed_iteration=0,
                                       tile_rows=TR, budget=BUDGET)
    losses = [float(step(state, target, (21, 0))[1]) for _ in range(4)]
    assert losses[-1] < losses[0] and state.step == 4
    assert float(state.params["mat_color"].detach().min()) >= 0.0


def test_unported_routes_raise(cornell):
    scene, cam = cornell
    target = torch.zeros((H, W, 3))
    params = tinv.params_of(scene)
    cfg = RenderConfig(spp=1, max_bounces=1)
    # the per-sample engine traces spheres only, as in JAX
    boxes, _ = tsc.cornell_boxes(device="cpu")
    with pytest.raises(ValueError, match="engine='sample' does not trace"):
        tinv.kernel_loss_and_grads(tinv.params_of(boxes), boxes, cam, target,
                                   (0, 0), 0, spp=1, engine="sample")
    with pytest.raises(NotImplementedError, match="item 15"):
        tinv.make_kernel_train_step(scene, cam, cfg, mesh=object())
    # textures are ported: on a scene with no mesh no atlas gradient can be
    # made, and mat_coef does not go with an atlas (the JAX ValueErrors)
    tex = torch.full((1, 2, 2, 3), 0.5)
    assert torch.equal(
        tinv.apply_params(scene, dict(params, textures=tex)).textures, tex)
    with pytest.raises(ValueError, match="cannot produce atlas gradients"):
        tinv.kernel_loss_and_grads(dict(params, textures=tex), scene, cam,
                                   target, (0, 0), 0, spp=1)
    with pytest.raises(ValueError, match="mat_coef gradients"):
        tinv.kernel_loss_and_grads(
            dict(tinv.params_of(scene, ior=True), textures=tex), scene, cam,
            target, (0, 0), 0, spp=1)
    from tpu_pathtracer_torch import cli

    # the wavefront trainer is ported: cli invert's replay route runs
    assert cli.main(["invert", "--estimator", "replay", "--device", "cpu",
                     "--size", "8x6", "--spp", "1", "--steps", "2"]) == 0
    with pytest.raises(NotImplementedError, match="item 15"):
        tinv.make_train_step(scene, cam, cfg, mesh=object())


def test_cli_invert_cpu(capsys):
    from tpu_pathtracer_torch import cli

    rc = cli.main(["invert", "--size", "8x6", "--spp", "1", "--steps", "2",
                   "--device", "cpu", "--estimator", "kernel"])
    out = capsys.readouterr().out
    assert rc == 0 and "recovered albedo" in out and "step    1" in out


def test_cuda_without_a_card_raises(capsys):
    """The constructors default to the card; without one they raise rather
    than building on the CPU, and ``cli invert`` fails clearly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tsc.cornell_spheres()
    with pytest.raises((RuntimeError, AssertionError)):
        tcm.make_camera([0, 0, 5], [0, 0, 0], [0, 1, 0], 8, 8)
    from tpu_pathtracer_torch import cli

    assert cli.main(["invert", "--size", "8x8"]) != 0
    assert "--device cpu" in capsys.readouterr().err


def test_inverse_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import tpu_pathtracer_torch.diff.inverse, "
            "tpu_pathtracer_torch.diff.replay, "
            "tpu_pathtracer_torch.diff.score, "
            "tpu_pathtracer_torch.diff.geometry, "
            "tpu_pathtracer_torch.ops.kernels.replay_persistent; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpu_pathtracer') and sys.modules[m] is not None]")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
