"""The port's camera/IOR tangent walk against the JAX kernel in interpret
mode, and against finite differences of its own primal.

Three JAX calls, one per module fixture, on the uniform blocks interpret
mode draws (``camera_jvp.py:1226-1239``, ``jax.random.key(3)``; the fused
gradient walk's under ``key(2)``), handed to the port through numpy:

1. ``camera_jvp_call`` on ``cornell_spheres`` with NEE, framed on its two
   balls: one random packed-camera tangent and the glass ball's IOR
   (sphere-area cone tangents, mirror and refraction JVPs, the IOR source
   and the score);
2. the same on ``cornell_quad`` (the mesh walk and TRI_LIGHT tangents);
3. ``kernel_loss_and_grads(params_of(scene, ior=True))`` brute force on the
   glass-ball fixture of ``tests/test_ior_kernel.py``, both walks' blocks
   injected, then one port train step against the JAX update.

Russian roulette runs from bounce 0 (``RRS``), so its boost of the tangents
feeds every comparison. Bars: >= 98% of lanes agree on n_samp, on L within
``1e-4 * max(1, |L|)`` and on every dL plane within ``DL_TOL``; each dL
plane's image sum within ``SUM_RTOL`` / ``SUM_ATOL``; ray counts within one
per thousand.

Without JAX, ``camera_jvp_ref`` is held to per-seed central differences of
its own primal on the JAX tests' edge-free fixtures (``tests/
test_camera_jvp.py:32-51, 87-106``: a point light over a floor sphere and
over a two-triangle quad), at that file's bars.
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
from tpu_pathtracer.diff import inverse as jinv  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.ops.pallas import camera_jvp as jcj  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.diff import inverse as tinv  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models import meshes as tmeshes  # noqa: E402
from tpu_pathtracer_torch.models.integrator import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.models.mesh import build_bvh  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import camera_jvp as tcj  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.replay_persistent import (  # noqa: E402
    pixel_lanes_layout,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    LANES, pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, tangent_lane_agreement,
)

W, H, TR = 16, 12, 8
SPP, MB, RRS, BUDGET = 2, 3, 0, 4
# dL against the JAX kernel, relative above 1 as L's bar. A tangent adds
# ~30 f32 operations per segment to the primal's, several through rsqrt
# (XLA's approximation, off by an ulp on a third of inputs) and in sums that
# XLA contracts into FMAs, and it divides by n.d near grazing hits. Measured:
# worst lane 1.2e-4 relative on cornell_spheres (99.5% of lanes within 1e-4),
# 1.0e-6 on cornell_quad, 5e-7 on the glass fixture; 1e-3 holds the worst
# lane with 8x room.
DL_TOL = 1e-3
# Each dL plane's image sum, within SUM_RTOL of the sum of its magnitudes
# (every lane agrees to DL_TOL, so the sums do too) plus SUM_ATOL for the
# lanes where an IOR plane is rounding noise: C sS - cS cancels to ~1e-7 on
# a glass lane that gathers nothing after the ball, on a few dozen lanes.
SUM_RTOL, SUM_ATOL = 1e-3, 1e-5
LOSS_RTOL, GRAD_RTOL = 1e-4, 2e-3  # the fused walk's bars (test_torch_inverse)
# The IOR gradient sums per-pixel tangents that agree to DL_TOL, with
# cancellation between the Snell and score halves: held to 1e-3.
IOR_RTOL = 1e-3
LR = 5e-2
STEP_TOL = 1e-5  # parameters after one Adam step (test_torch_inverse)


def jax_uniforms(key, seed, iteration, n_tiles, budget, use_nee,
                 tile_rows=TR):
    """The external uniform block that interpret mode draws for one walk:
    ``jax.random.key(key)`` (2 for the fused gradient walk, 3 for the tangent
    walk), folded with seed[0] + 131*seed[1], the iteration and the global
    tile."""
    n_draw = tpk.n_draws(use_nee)
    rkey = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(key), seed[0] + 131 * seed[1]),
        iteration)
    blk = budget * n_draw * tile_rows
    return torch.tensor(np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(rkey, t),
                                      (blk, LANES), jnp.float32))
        for t in range(n_tiles)]))


def _walk_case(name, seed, look_at=None, fov=None):
    """One JAX interpret-mode tangent walk with NEE and the port's plain
    version on the same uniforms: one random camera tangent, then one IOR
    tangent per transmissive material. ``look_at`` and ``fov`` reframe the
    scene's camera."""
    js, cs = jsc.BUILTIN_SCENES[name]()
    if js.mesh is not None:
        js = jsc.with_packet_mesh(js, two_pass=False)
    jc = jcm.make_camera(cs["eye"], look_at or cs["look_at"], cs["up"], W, H,
                         fov or cs["fov"])
    dcam = np.random.default_rng(3).normal(size=(1, 24)).astype(np.float32)
    dcam[:, 12:] = 0.0  # the lens and view rows feed no pinhole ray
    coef = jcj.transmissive_mats(js)
    kw = dict(spp=SPP, budget=BUDGET, width=W, height=H, max_bounces=MB,
              rr_start=RRS, tile_rows=TR, use_nee=True, coef_mats=coef)
    jout = jcj.camera_jvp_call(
        js, jpack_camera(jc), jnp.asarray(dcam), jnp.asarray(seed, jnp.int32),
        jnp.int32(0), interpret=True, **kw)
    jL, jdL, jns, jrays = (np.asarray(x) for x in jout)
    rows, _ = pixel_lanes_layout(W, H, TR)
    u = jax_uniforms(3, seed, 0, rows // TR, BUDGET, True)
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    args = (ts, pack_camera(tc), torch.tensor(dcam), seed, 0)
    port = tcj.camera_jvp_ref(*args, uniforms=u, **kw)
    return dict(jax=(torch.tensor(jL), torch.tensor(jdL), torch.tensor(jns)),
                jrays=int(jrays), port=port, coef=coef, args=args, kw=kw,
                u=u)


@pytest.fixture(scope="module")
def spheres():
    # framed on the two balls: at the scene's own framing no lane of this
    # size gathers light after the glass, so its IOR plane would be zero
    return _walk_case("cornell", (5, 2), look_at=[10, 16.5, -35], fov=40.0)


@pytest.fixture(scope="module")
def quad():
    return _walk_case("cornell-quad", (9, 4))


def plane_sum_excess(jdL, dL):
    """Per dL plane, |sum(port) - sum(JAX)| over the image in units of its
    bar, SUM_RTOL * sum(|JAX|) + SUM_ATOL."""
    s_port, s_jax = dL.double().sum((1, 2)), jdL.double().sum((1, 2))
    bar = SUM_RTOL * jdL.double().abs().sum((1, 2)) + SUM_ATOL
    return (s_port - s_jax).abs() / bar


def _check_lanes(case, ior_planes):
    L, dL, ns, rays = case["port"]
    agree = tangent_lane_agreement(case["jax"], (L, dL, ns), W, H,
                                   dl_tol=DL_TOL)
    assert agree["n_samp"] >= AGREE, agree
    assert agree["L"] >= AGREE, agree
    for name, frac in agree["planes"].items():
        assert frac >= AGREE, (name, agree)
    # A fault confined to a few lanes (the glass ball's pixels, the paths
    # that survive roulette) passes the per-lane share but moves its
    # plane's sum.
    excess = plane_sum_excess(case["jax"][1], dL)
    assert (excess <= 1.0).all(), excess
    assert abs(int(rays) - case["jrays"]) <= max(1, case["jrays"] // 1000)
    assert dL.shape[0] == 1 + ior_planes
    assert float(dL[0].abs().max()) > 0.1  # the camera tangent moves L
    assert torch.isfinite(dL).all() and int(ns.max()) <= SPP


def test_sphere_walk_matches_jax_kernel(spheres):
    """cornell_spheres NEE: >= 98% of lanes agree on n_samp, L, the camera
    tangent's and the glass IOR tangent's planes; equal ray counts."""
    assert spheres["coef"] == (5,)
    _check_lanes(spheres, 1)
    assert float(spheres["port"][1][1].abs().max()) > 1e-3  # the IOR moves L


def test_mesh_walk_matches_jax_kernel(quad):
    """cornell_quad NEE (no spheres, a TRI_LIGHT quad): the mesh walk's flat
    triangles (dn = 0) and the triangle light's sample tangents."""
    assert quad["coef"] == ()
    _check_lanes(quad, 0)


def test_tangents_are_independent(spheres):
    """Four tangents in one walk equal two walks of two (the chunking of
    the kernel's wrapper is exact): tangents never feed the primal."""
    scene, cp, _, seed, it = spheres["args"]
    rows = torch.tensor(np.random.default_rng(8).normal(size=(4, 24)),
                        dtype=torch.float32)
    kw = dict(spheres["kw"], coef_mats=(), uniforms=spheres["u"])
    four = tcj.camera_jvp_ref(scene, cp, rows, seed, it, **kw)
    two = [tcj.camera_jvp_ref(scene, cp, rows[i:i + 2], seed, it, **kw)
           for i in (0, 2)]
    for t in two:
        assert torch.equal(t[0], four[0]) and torch.equal(t[2], four[2])
        assert int(t[3]) == int(four[3])
    assert torch.equal(torch.cat([two[0][1], two[1][1]]), four[1])


# ---------------------------------------------------------------------------
# The IOR gradient in the trainer
# ---------------------------------------------------------------------------

GLASS_W = GLASS_H = 4
GLASS_SPP, GLASS_MB, GLASS_BUDGET = 2, 4, 6
GLASS_SEED = (3, 1)


def _glass_fixture(mod, **device):
    """tests/test_ior_kernel.py's edge-free glass ball: refraction never
    bends a ray across a silhouette; two emitters behind and ahead."""
    spheres = [mod.sphere([0, 0, 0], 5.0, 0),
               mod.sphere([0, 0, -80], 40.0, 1, 0),
               mod.sphere([0, 0, 140], 70.0, 1, 1)]
    mats = [mod.transmissive([1, 1, 1], ior=1.5), mod.diffuse([0, 0, 0])]
    lights = [mod.area_light(1, [4, 4, 4]), mod.area_light(2, [9, 9, 9])]
    return mod.make_scene(spheres, mats, lights, **device)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def glass():
    """JAX kernel_loss_and_grads with mat_coef at parameters and an Adam
    state that one optax step from random gradients left, and the optax
    update its gradients give."""
    js = _glass_fixture(jsc)
    jc = jcm.make_camera([0, 0, 30], [0, 0, 0], [0, 1, 0], GLASS_W, GLASS_H,
                         0.5)
    rng = np.random.default_rng(12)
    target = rng.random((GLASS_H, GLASS_W, 3), np.float32)
    params0 = jinv.params_of(js, ior=True)
    opt = optax.adam(LR)
    st0 = opt.init(params0)
    noise = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
             for k, v in params0.items()}
    upd, st1 = opt.update(noise, st0, params0)
    params1 = jinv._clamp_params(optax.apply_updates(params0, upd))
    loss, grads = jinv.kernel_loss_and_grads(
        params1, js, jc, jnp.asarray(target),
        jnp.asarray(GLASS_SEED, jnp.int32), 0, spp=GLASS_SPP,
        max_bounces=GLASS_MB, tile_rows=TR, budget=GLASS_BUDGET,
        use_nee=False, rr_start=RRS, interpret=True)
    upd, st2 = opt.update(grads, st1, params1)
    params2 = jinv._clamp_params(optax.apply_updates(params1, upd))
    adam = {"count": int(st1[0].count), "mu": _np(st1[0].mu),
            "nu": _np(st1[0].nu)}
    return dict(js=js, jc=jc, target=target, params1=_np(params1), adam=adam,
                loss=float(loss), grads=_np(grads), params2=_np(params2))


def _glass_uniforms():
    rows, _ = pixel_lanes_layout(GLASS_W, GLASS_H, TR)
    return (jax_uniforms(2, GLASS_SEED, 0, rows // TR, GLASS_BUDGET, False),
            jax_uniforms(3, GLASS_SEED, 0, rows // TR, GLASS_BUDGET, False))


def test_ior_trainer_grads_match_jax(glass):
    """kernel_loss_and_grads with mat_coef: the loss and all three
    gradients equal the JAX package's on the same uniforms; mat_coef's lands
    on the glass material only."""
    ts, tc = scene_to_torch(glass["js"]), camera_to_torch(glass["jc"])
    u, u_ior = _glass_uniforms()
    params = {k: torch.tensor(v) for k, v in glass["params1"].items()}
    loss, grads = tinv.kernel_loss_and_grads(
        params, ts, tc, torch.tensor(glass["target"]), GLASS_SEED, 0,
        spp=GLASS_SPP, max_bounces=GLASS_MB, tile_rows=TR,
        budget=GLASS_BUDGET, rr_start=RRS, uniforms=u, ior_uniforms=u_ior)
    np.testing.assert_allclose(float(loss), glass["loss"], rtol=LOSS_RTOL)
    want = glass["grads"]
    assert set(grads) == {"mat_color", "light_intensity", "mat_coef"}
    for k, rtol in (("mat_color", GRAD_RTOL), ("light_intensity", GRAD_RTOL),
                    ("mat_coef", IOR_RTOL)):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(grads[k].numpy(), want[k], rtol=rtol,
                                   atol=1e-6 * scale, err_msg=k)
    g = grads["mat_coef"].numpy()
    assert abs(g[0]) > 1e-3 and (g[1:] == 0).all()


def test_ior_train_step_matches_jax(glass):
    """One port train step from the carried-across parameters and Adam
    state (mat_coef's moments included) equals the optax update of the JAX
    gradients."""
    ts, tc = scene_to_torch(glass["js"]), camera_to_torch(glass["jc"])
    u, u_ior = _glass_uniforms()
    state = tinv.train_state_from_numpy(glass["params1"], glass["adam"], 1,
                                        lr=LR, device="cpu")
    step = tinv.make_kernel_train_step(
        ts, tc, RenderConfig(spp=GLASS_SPP, max_bounces=GLASS_MB,
                             rr_start=RRS),
        fixed_iteration=0, tile_rows=TR, budget=GLASS_BUDGET, uniforms=u,
        ior_uniforms=u_ior)
    state, loss = step(state, torch.tensor(glass["target"]), GLASS_SEED)
    np.testing.assert_allclose(float(loss), glass["loss"], rtol=LOSS_RTOL)
    params, adam, n = tinv.train_state_to_numpy(state)
    assert n == 2 and adam["count"] == 2 and set(params) == set(
        glass["params2"])
    for k, v in glass["params2"].items():
        np.testing.assert_allclose(params[k], v, atol=STEP_TOL, err_msg=k)
    assert params["mat_coef"][0] != glass["params1"]["mat_coef"][0]


# ---------------------------------------------------------------------------
# The port alone: finite differences, routing, clamps
# ---------------------------------------------------------------------------

FD_SPP, FD_MB, FD_BUDGET = 2, 1, 5


def _floor_fixture():
    scene = tsc.make_scene([tsc.sphere([0, -1e4, 0], 1e4, 0)],
                           [tsc.diffuse([0.8, 0.8, 0.8])],
                           [tsc.point_light([2, 4, 1], [30, 30, 30])],
                           device="cpu")
    return scene, np.random.default_rng(1), (5, 2)


def _quad_fixture():
    v, f, uv = tmeshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                            [10, 0, -10])
    scene = tsc.make_scene([], [tsc.diffuse([0.8, 0.8, 0.8])],
                           [tsc.point_light([2, 4, 1], [30, 30, 30])],
                           mesh=build_bvh(v, f, uv, 0, device="cpu"),
                           device="cpu")
    return tsc.with_packet_mesh(scene), np.random.default_rng(3), (9, 4)


@pytest.mark.parametrize("fixture", [_floor_fixture, _quad_fixture],
                         ids=["floor", "quad"])
def test_camera_pos_grad_matches_fd(fixture):
    """d/d camera.pos of sum(w * image) against central differences of the
    walk's own primal on the same seed (NEE, the point light the only
    light): x/y at rtol 2e-2, z, whose quotient is f32-noise-bound, at rtol
    0.2 / atol 0.5 (``tests/test_camera_jvp.py``'s bars)."""
    scene, rng, seed = fixture()
    cam = tcm.make_camera([0, 3, 6], [0, 0, 0], [0, 1, 0], W, H, 45.0,
                          device="cpu")
    w = torch.tensor(rng.random((H, W, 3), np.float32))
    kw = dict(spp=FD_SPP, max_bounces=FD_MB, budget=FD_BUDGET, tile_rows=TR,
              use_nee=True)
    _, g = tcj.camera_weighted_grad(scene, cam, seed, w, **kw)
    g = g["pos"].numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 1.0

    def f(pos):
        c = dataclasses.replace(cam, pos=torch.tensor(pos, dtype=torch.float32))
        L, _, ns, _ = tcj.camera_jvp_call(
            scene, pack_camera(c), torch.zeros(24), seed, 0, width=W,
            height=H, spp=FD_SPP, max_bounces=FD_MB, budget=FD_BUDGET,
            tile_rows=TR, use_nee=True)
        mean, _ = tcj._pixel_means(L, L[None], ns, W, H)
        return float(torch.sum(w * mean))

    p0 = cam.pos.numpy().astype(np.float64)
    for i, eps, rtol, atol in ((0, 8e-3, 2e-2, 1e-2), (1, 8e-3, 2e-2, 1e-2),
                               (2, 3e-2, 0.2, 0.5)):
        dp = np.zeros(3)
        dp[i] = eps
        fd = (f(p0 + dp) - f(p0 - dp)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=rtol, atol=atol,
                                   err_msg=f"axis {i}")


def test_transmissive_mats_routing():
    assert tcj.transmissive_mats(_glass_fixture(tsc, device="cpu")) == (0,)
    assert len(tcj.transmissive_mats(tsc.cornell_spheres(device="cpu")[0])) \
        == 1
    assert tcj.transmissive_mats(tsc.cornell_boxes(device="cpu")[0]) == ()


def test_ior_no_transmissive_raises():
    scene, cs = tsc.cornell_boxes(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 4, 4,
                          cs["fov"], device="cpu")
    with pytest.raises(ValueError, match="no transmissive"):
        tcj.ior_weighted_grad(tsc.with_packet_mesh(scene), cam, (1, 0),
                              torch.ones((4, 4, 3)), spp=2, budget=4)


def test_mat_coef_clamp_and_params():
    scene, _ = tsc.cornell_spheres(device="cpu")
    params = tinv.params_of(scene, ior=True)
    assert set(params) == {"mat_color", "light_intensity", "mat_coef"}
    assert params["mat_coef"] is not scene.mat_coef
    params["mat_coef"] = torch.tensor([0.5, 1.0, 1.7])
    out = tinv.clamp_params(params)
    assert out["mat_coef"].tolist() == pytest.approx([1.0, 1.0, 1.7])
    assert "mat_coef" not in tinv.clamp_params(tinv.params_of(scene))
    st = tinv.apply_params(scene, params)
    assert torch.equal(st.mat_coef, params["mat_coef"])


def test_unsupported_device_and_unpacked_mesh_raise():
    scene, cs = tsc.cornell_quad(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 4, 4,
                          cs["fov"], device="cpu")
    kw = dict(spp=1, budget=1, width=4, height=4, tile_rows=TR)
    with pytest.raises(ValueError, match="with_packet_mesh"):
        tcj.camera_jvp_call(scene, pack_camera(cam), torch.zeros(24), (0, 0),
                            0, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        tcj.camera_jvp_call(tsc.with_packet_mesh(scene),
                            pack_camera(cam).to("meta"), torch.zeros(24),
                            (0, 0), 0, **kw)
    before = tcj.launches
    tcj.camera_jvp_call(tsc.with_packet_mesh(scene), pack_camera(cam),
                        torch.zeros(24), (0, 0), 0, **kw)
    assert tcj.launches == before  # the plain version is not a launch
