"""Path replay (``diff/replay.py``) against the port's autograd and JAX's.

* Replay against autograd of ``render`` on the same Philox draws: both
  differentiate the same detached-sampling estimator, so they agree to
  float rounding, within JAX's own bar (``tests/test_replay.py:53-56``,
  rtol 2e-3, atol 2e-4 on the colours and 2e-5 on the intensities; with
  Russian roulette at depth 8, rtol 5e-3 as there). Brute force, NEE,
  and mesh scenes on the packet route (the TRI_LIGHT material -> light
  credit on ``cornell_quad``).
* Replay against JAX ``render_replay`` on JAX's uniforms (``TableDraws``),
  within rtol 1e-2: a lane that takes another path on one side (f32 chaos
  at the walls) moves a gradient by its whole contribution.
* The replay primal against ``render`` within JAX's rtol 5e-4
  (``tests/test_replay.py:177``); here it is bit for bit, since both walk
  the same operations in the same order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_scene_camera import camera_to_torch, scene_to_torch  # noqa: E402
from test_torch_wavefront import jax_draws  # noqa: E402
from tpu_pathtracer.diff import replay as jrep  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import integrator as jint  # noqa: E402
from tpu_pathtracer_torch.diff import replay  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import (  # noqa: E402
    RenderConfig, render,
)

W, H, SPP = 12, 10, 2
RTOL, ATOL_A, ATOL_I = 2e-3, 2e-4, 2e-5  # JAX's replay-vs-autodiff bar
RR_RTOL = 5e-3
JAX_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these files run many small ops, and under a
    parallel test run eight threads per worker oversubscribe the cores
    (a 6 s test took 280 s beside three other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name):
    scene, cs = tsc.BUILTIN_SCENES[name](device="cpu")
    if scene.mesh is not None:
        scene = tsc.with_packet_mesh(scene)
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], device="cpu")
    return scene, cam


def _grads(fn, scene, cam, config, weights, seed=4, draws=None):
    A = scene.mat_color.detach().clone().requires_grad_(True)
    I = scene.light_intensity.detach().clone().requires_grad_(True)
    img = fn(dataclasses.replace(scene, mat_color=A, light_intensity=I),
             cam, seed, config, draws=draws)
    torch.sum(img * weights).backward()
    return img.detach(), A.grad, I.grad


CASES = [("cornell", 1, False), ("cornell", 3, False), ("cornell", 6, False),
         ("cornell", 1, True), ("cornell", 3, True),
         ("cornell-boxes", 3, False), ("cornell-boxes", 3, True),
         ("cornell-quad", 3, False), ("cornell-quad", 3, True)]


@pytest.mark.parametrize("name,bounces,nee", CASES)
def test_replay_matches_autograd(name, bounces, nee):
    scene, cam = _scene(name)
    config = RenderConfig(spp=SPP, max_bounces=bounces, use_nee=nee)
    w = torch.tensor(np.random.default_rng(0).random((H, W, 3), np.float32))
    img_a, gA_a, gI_a = _grads(render, scene, cam, config, w)
    img_r, gA_r, gI_r = _grads(replay.render_replay, scene, cam, config, w)
    assert torch.equal(img_r, img_a)
    np.testing.assert_allclose(gA_r.numpy(), gA_a.numpy(), rtol=RTOL,
                               atol=ATOL_A)
    np.testing.assert_allclose(gI_r.numpy(), gI_a.numpy(), rtol=RTOL,
                               atol=ATOL_I)
    assert gA_r.abs().max() > 0 and gI_r.abs().max() > 0


def test_replay_with_rr_matches_autograd():
    """Depth 8, Russian roulette from bounce 4 (``tests/test_replay.py:
    180-190``): finite, and equal to autograd at rtol 5e-3."""
    scene, cam = _scene("cornell")
    config = RenderConfig(spp=SPP, max_bounces=8)
    w = torch.ones((H, W, 3))
    _, gA_a, gI_a = _grads(render, scene, cam, config, w, seed=2)
    _, gA_r, gI_r = _grads(replay.render_replay, scene, cam, config, w,
                           seed=2)
    assert torch.isfinite(gA_r).all() and torch.isfinite(gI_r).all()
    np.testing.assert_allclose(gA_r.numpy(), gA_a.numpy(), rtol=RR_RTOL,
                               atol=5e-4)
    np.testing.assert_allclose(gI_r.numpy(), gI_a.numpy(), rtol=RR_RTOL,
                               atol=5e-5)


@pytest.mark.parametrize("nee", [False, True])
def test_replay_primal_matches_render(nee):
    scene, cam = _scene("cornell")
    config = RenderConfig(spp=SPP, max_bounces=5, use_nee=nee)
    a = render(scene, cam, 7, config)
    b = replay.render_replay(scene, cam, 7, config)
    np.testing.assert_allclose(b.detach().numpy(), a.numpy(), rtol=5e-4,
                               atol=1e-6)


@pytest.mark.parametrize("nee", [False, True])
def test_replay_matches_jax(nee):
    """Port replay against JAX ``render_replay`` on JAX's uniforms."""
    js, cs = jsc.cornell_spheres()
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"])
    jcfg = jint.RenderConfig(spp=SPP, max_bounces=3, use_nee=nee)
    w = np.random.default_rng(1).random((H, W, 3), np.float32)

    def f(params):
        s = js.replace(mat_color=params[0], light_intensity=params[1])
        return jnp.sum(jrep.render_replay(s, jc, jax.random.key(4), jcfg)
                       * w)

    jA, jI = jax.jit(jax.grad(f))((js.mat_color, js.light_intensity))
    draws = jax_draws(jax.random.key(4), 0, W * H * SPP, 3, nee)
    _, gA, gI = _grads(replay.render_replay, scene_to_torch(js),
                       camera_to_torch(jc),
                       RenderConfig(spp=SPP, max_bounces=3, use_nee=nee),
                       torch.tensor(w), draws=draws)
    np.testing.assert_allclose(gA.numpy(), np.asarray(jA), rtol=JAX_RTOL,
                               atol=2e-3)
    np.testing.assert_allclose(gI.numpy(), np.asarray(jI), rtol=JAX_RTOL,
                               atol=2e-4)


def test_replay_saves_only_inputs_and_radiance():
    """The backward keeps the primal inputs and the per-lane L, nothing
    per bounce: the graph holds one node, TraceReplay's."""
    scene, cam = _scene("cornell")
    config = RenderConfig(spp=SPP, max_bounces=3)
    A = scene.mat_color.detach().clone().requires_grad_(True)
    img = replay.render_replay(dataclasses.replace(scene, mat_color=A), cam,
                               1, config)
    node = img.grad_fn
    while node is not None and "TraceReplay" not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None
    n_lanes = W * H * SPP
    sizes = sorted(t.numel() for t in node.saved_tensors)
    assert sizes[-1] == 3 * n_lanes and len(sizes) == 6


def test_replay_takes_the_lens():
    """A departure (ROADMAP Queue 3): JAX ``render_replay`` traces pinhole
    rays whatever the camera; the port's takes ``trace_pixels``' rays, so a
    lens camera's replay renders what ``render`` renders."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], lens_radius=4.0, focal_distance=60.0,
                          device="cpu")
    config = RenderConfig(spp=SPP, max_bounces=3, use_nee=True)
    a = render(scene, cam, 3, config)
    b = replay.render_replay(scene, cam, 3, config)
    assert torch.equal(b.detach(), a)
    pin = dataclasses.replace(cam, lens_radius=0.0)
    assert not torch.equal(render(scene, pin, 3, config), a)
