"""IOR gradients (``diff/score.py``) against JAX's and finite differences.

Fixture: the JAX score tests' glass ball between two emitters
(``tests/test_score.py:29-39``), where refraction never crosses a
silhouette, so the attached part is edge-free and the reflect-or-refract
choice carries most of the gradient.

* Against JAX ``ior_value_and_grad`` on JAX's uniforms (``TableDraws``),
  brute force and NEE: value and gradient within rtol 1e-2 (a lane that
  takes another path on one side moves the gradient by its share).
* The port's own estimator against central differences of ``render`` in
  expectation over iterations, at JAX's bars: the gradient above 0.3 and
  within rtol 0.4 of the FD mean (one lane flipping its Fresnel choice
  flips its whole path, so FD is meaningful in expectation only).
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
from tpu_pathtracer.diff import score as jscore  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import integrator as jint  # noqa: E402
from tpu_pathtracer_torch.diff import score  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import (  # noqa: E402
    RenderConfig, render,
)

IOR, GLASS = 1.5, 0
SPP, MB = 64, 6
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


def _glass(mod, **device):
    spheres = [mod.sphere([0, 0, 0], 5.0, 0),
               mod.sphere([0, 0, -80], 40.0, 1, 0),
               mod.sphere([0, 0, 140], 70.0, 1, 1)]
    mats = [mod.transmissive([1, 1, 1], ior=IOR), mod.diffuse([0, 0, 0])]
    lights = [mod.area_light(1, [4, 4, 4]), mod.area_light(2, [9, 9, 9])]
    return mod.make_scene(spheres, mats, lights, **device)


@pytest.mark.parametrize("nee", [False, True])
def test_ior_grad_matches_jax(nee):
    js = _glass(jsc)
    jc = jcm.make_camera([0, 0, 30], [0, 0, 0], [0, 1, 0], 4, 4, 0.5)
    w = np.full((4, 4, 3), 1.0 / 48, np.float32)
    jv, jg = jscore.ior_value_and_grad(
        js, jc, jax.random.key(3),
        jint.RenderConfig(spp=SPP, max_bounces=MB, use_nee=nee),
        jnp.asarray(w), iteration=2)
    draws = jax_draws(jax.random.key(3), 2, 16 * SPP, MB, nee)
    v, g = score.ior_value_and_grad(
        scene_to_torch(js), camera_to_torch(jc), 0,
        RenderConfig(spp=SPP, max_bounces=MB, use_nee=nee),
        torch.tensor(w), draws=draws)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(float(v), float(jv), rtol=JAX_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=JAX_RTOL,
                               atol=1e-4)
    assert float(g[GLASS]) != 0.0


@pytest.mark.parametrize("nee", [False, True])
def test_ior_grad_matches_fd(nee):
    scene = _glass(tsc, device="cpu")
    cam = tcm.make_camera([0, 0, 30], [0, 0, 0], [0, 1, 0], 4, 4, 0.5,
                          device="cpu")
    config = RenderConfig(spp=SPP, max_bounces=MB, use_nee=nee)
    w = torch.full((4, 4, 3), 1.0 / 48)
    h = 0.02

    def val(c, it):
        coef = scene.mat_coef.clone()
        coef[GLASS] = c
        img = render(dataclasses.replace(scene, mat_coef=coef), cam, 3,
                     config, iteration=it)
        return float(torch.sum(w * img))

    gs, fds = [], []
    for it in range(14):
        _, g = score.ior_value_and_grad(scene, cam, 3, config, w,
                                        iteration=it)
        gs.append(float(g[GLASS]))
        fds.append((val(IOR + h, it) - val(IOR - h, it)) / (2 * h))
    assert np.isfinite(gs).all()
    grad = float(np.mean(gs))
    assert grad > 0.3, grad
    np.testing.assert_allclose(grad, float(np.mean(fds)), rtol=0.4)


def test_ior_grad_finite_on_cornell():
    """The glass and mirror Cornell at depth 6: finite through RR-deep
    paths and mirror lanes."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 24, 18,
                          cs["fov"], device="cpu")
    _, g = score.ior_value_and_grad(scene, cam, 1,
                                    RenderConfig(spp=8, max_bounces=6),
                                    torch.full((18, 24, 3), 1 / 1296))
    assert torch.isfinite(g).all()
