"""The port's wavefront under autograd against ``jax.grad`` of JAX ``render``.

Both sides render the same paths: the port replays the JAX package's
uniforms through ``TableDraws`` (``test_torch_wavefront.jax_draws``) on the
scene carried across by ``scene_to_torch``; the JAX side is plain XLA on the
CPU (its scenes here are unpacked, so no Pallas). Bars:

* the primal image agrees on >= 98% of pixels at the goldens' rtol 1e-4 /
  atol 1e-5 (f32 chaos at the 1e5-radius walls, ``test_torch_wavefront``);
* the gradients agree within rtol 1e-2, atol 2e-3, the finite-difference
  bar of ``tests/test_gradients.py``: a lane that takes another path on one
  side moves a table's gradient by its whole contribution;
* ``attached_geom`` leaves the primal bit for bit;
* one ``make_train_step`` step from the same parameters and Adam state
  against JAX's on a one-device mesh: loss and parameters within the same
  bar.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_scene_camera import camera_to_torch, scene_to_torch  # noqa: E402
from test_torch_wavefront import jax_draws  # noqa: E402
from tpu_pathtracer.diff import inverse as jinv  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import integrator as jint  # noqa: E402
from tpu_pathtracer.parallel.mesh import make_mesh  # noqa: E402
from tpu_pathtracer_torch.diff import inverse as tinv  # noqa: E402
from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import (  # noqa: E402
    RenderConfig, render,
)

W, H, SPP, MB = 12, 10, 2, 3
RTOL, ATOL = 1e-4, 1e-5  # primal, per pixel (the goldens' bar)
AGREE = 0.98
G_RTOL, G_ATOL = 1e-2, 2e-3  # gradients
LR = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these files run many small ops, and under a
    parallel test run eight threads per worker oversubscribe the cores
    (a 6 s test took 280 s beside three other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, nee, key, w=W, h=H, spp=SPP, mb=MB):
    js, cs = jsc.BUILTIN_SCENES[name]()
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    return js, jc, dict(spp=spp, max_bounces=mb, use_nee=nee), key


def _textured():
    """The JAX replay tests' tinted checker floor and emissive sphere
    (``tests/test_replay.py:104-130``)."""
    from tpu_pathtracer.models import meshes
    from tpu_pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    tex = meshes.checker_texture(8, tiles=2, c0=(0.9, 0.3, 0.2),
                                 c1=(0.15, 0.8, 0.9))
    js = jsc.make_scene(
        [jsc.sphere([0.0, 9.0, 0.0], 2.0, 1, 0)],
        [jsc.diffuse([0.6, 1.0, 0.8]), jsc.diffuse([1.0, 1.0, 1.0])],
        [jsc.area_light(0, [14.0, 14.0, 14.0])],
        mesh=build_bvh(v, f, uv, 0), textures=tex, mat_texture=[0, -1])
    jc = jcm.make_camera([0, 12, 9], [0, 0, 0], [0, 1, 0], W, H, 60.0)
    return js, jc, dict(spp=4, max_bounces=2, use_nee=True), 3


CASES = {
    "cornell_brute": lambda: _setup("cornell", False, 4),
    "cornell_nee": lambda: _setup("cornell", True, 4),
    "cornell_quad_nee": lambda: _setup("cornell-quad", True, 9),
    "textured": _textured,
}
PARAMS = {"textured": ("mat_color", "light_intensity", "textures")}


def _jax_case(js, jc, cfg, key, names, weights):
    """JAX's image and d sum(weights * image) / d names, one jit."""
    config = jint.RenderConfig(**cfg)

    def f(params):
        img = jint.render(js.replace(**params), jc, jax.random.key(key),
                          config)
        return jnp.sum(img * weights), img

    (_, img), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: getattr(js, k) for k in names})
    return np.asarray(img), {k: np.asarray(v) for k, v in g.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    js, jc, cfg, key = CASES[request.param]()
    names = PARAMS.get(request.param, ("mat_color", "light_intensity"))
    weights = np.random.default_rng(0).random((jc.height, jc.width, 3),
                                              np.float32)
    img, grads = _jax_case(js, jc, cfg, key, names, jnp.asarray(weights))
    ts = scene_to_torch(js)
    if ts.mesh is not None and ts.textures is None:
        ts = tsc.with_packet_mesh(ts)  # the packet route, two-pass
    draws = jax_draws(jax.random.key(key), 0,
                      jc.width * jc.height * cfg["spp"], cfg["max_bounces"],
                      cfg["use_nee"])
    return dict(name=request.param, ts=ts, tc=camera_to_torch(jc),
                cfg=RenderConfig(**cfg), draws=draws, names=names,
                weights=torch.tensor(weights), img=img, grads=grads)


def _port_grads(c, config=None):
    params = {k: getattr(c["ts"], k).detach().clone().requires_grad_(True)
              for k in c["names"]}
    img = render(dataclasses.replace(c["ts"], **params), c["tc"], 0,
                 config or c["cfg"], draws=c["draws"])
    torch.sum(img * c["weights"]).backward()
    return img.detach(), {k: v.grad for k, v in params.items()}


def test_gradients_match_jax(case):
    """Primal on >= 98% of pixels; every table's gradient at the FD bar."""
    img, grads = _port_grads(case)
    ok = np.abs(img.numpy() - case["img"]) <= ATOL + RTOL * np.abs(
        case["img"])
    assert ok.all(axis=-1).mean() >= AGREE
    for k in case["names"]:
        g = grads[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, case["grads"][k], rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=k)
        assert np.abs(g).max() > 0, k


@pytest.mark.parametrize("remat", [False, True])
def test_remat_and_attached_geom_keep_the_estimate(case, remat):
    """``remat`` recomputes the bounces in the backward and
    ``attached_geom`` attaches the cosine: the image bit for bit, the
    gradients of the colour and light tables to rounding."""
    img0, g0 = _port_grads(case)
    img1, g1 = _port_grads(case, dataclasses.replace(
        case["cfg"], remat=remat, attached_geom=True))
    assert torch.equal(img0, img1)
    for k in case["names"]:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6)


def test_forward_renderers_build_no_graph(case):
    """``render_image`` runs under no_grad even with parameters that
    require grad."""
    from tpu_pathtracer_torch.models.integrator import render_image

    mc = case["ts"].mat_color.clone().requires_grad_(True)
    img = render_image(dataclasses.replace(case["ts"], mat_color=mc),
                       case["tc"], 0, case["cfg"], draws=case["draws"])
    assert not img.requires_grad


def _adam_np(opt_state, names):
    st = opt_state[0]
    return {"count": int(st.count),
            "mu": {k: np.asarray(st.mu[k]) for k in names},
            "nu": {k: np.asarray(st.nu[k]) for k in names}}


def test_train_step_matches_jax():
    """One wavefront train step (``make_train_step`` on a one-device mesh,
    fixed iteration 0, NEE) from perturbed parameters: the port's loss,
    parameters and Adam moment against JAX's."""
    js, jc, cfg, key = _setup("cornell", True, 6)
    config = jint.RenderConfig(**cfg)
    target = jinv.render_target(js, jc, jax.random.key(key), config,
                                n_iterations=1, base_iteration=0)
    p0 = dict(jinv.params_of(js))
    p0["mat_color"] = js.mat_color.at[3].set(jnp.asarray([0.3, 0.3, 0.3]))
    p0["light_intensity"] = js.light_intensity * 0.5
    optimizer = optax.adam(LR)
    s0 = jinv.init_state(js, optimizer, p0)
    step = jinv.make_train_step(js, jc, config,
                                make_mesh(jax.devices()[:1]), optimizer,
                                fixed_iteration=0)
    s1, loss = step(s0, target, jax.random.key(key))

    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    draws = jax_draws(jax.random.key(key), 0, W * H * SPP, MB, True)
    names = tinv.PARAMS
    state = tinv.train_state_from_numpy(
        {k: np.asarray(p0[k]) for k in names}, None, 0, lr=LR,
        device="cpu")
    t_target = tinv.render_target(ts, tc, 0, RenderConfig(**cfg),
                                  n_iterations=1, base_iteration=0,
                                  draws=draws)
    ok = np.abs(t_target.numpy() - np.asarray(target)) <= ATOL + RTOL * \
        np.abs(np.asarray(target))
    assert ok.all(axis=-1).mean() >= AGREE
    t_step = tinv.make_train_step(ts, tc, RenderConfig(**cfg),
                                  fixed_iteration=0, draws=draws)
    state, t_loss = t_step(state, torch.tensor(np.asarray(target)), 0)
    assert state.step == 1
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=G_RTOL)
    params, adam, _ = tinv.train_state_to_numpy(state)
    want = _adam_np(s1.opt_state, names)
    for k in names:
        np.testing.assert_allclose(params[k], np.asarray(s1.params[k]),
                                   rtol=G_RTOL, atol=G_ATOL, err_msg=k)
        np.testing.assert_allclose(adam["mu"][k], want["mu"][k],
                                   rtol=G_RTOL, atol=G_ATOL, err_msg=k)


def test_train_step_lowers_the_loss_and_trains_an_atlas():
    """Same-seed descent through the wavefront on the port's own Philox
    draws; on a textured scene the atlas trains too (no packed mesh
    needed), and a mesh raises as ``_check_route`` does."""
    js, jc, cfg, _ = _textured()
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    config = RenderConfig(**cfg)
    target = tinv.render_target(ts, tc, 5, config, n_iterations=1,
                                base_iteration=0)
    p0 = tinv.params_of(ts)
    assert "textures" in p0
    p0["mat_color"][1] = 0.5
    p0["textures"] = p0["textures"] * 0.7
    state = tinv.init_state(ts, tinv.make_optimizer(LR), p0)
    step = tinv.make_train_step(ts, tc, config, fixed_iteration=0)
    losses = [float(step(state, target, 5)[1]) for _ in range(4)]
    assert losses[-1] < losses[0] and state.step == 4
    assert float(state.params["textures"].detach().max()) <= 1.0
    with pytest.raises(NotImplementedError, match="item 15"):
        tinv.make_train_step(ts, tc, config, mesh=object())
    with pytest.raises(NotImplementedError, match="item 15"):
        tinv.sharded_loss(p0, ts, tc, target, 0, config, mesh=object())
