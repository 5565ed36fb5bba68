"""Texture-atlas gradients of the port's fused walk against the JAX package.

The scene is the JAX suite's ``tex_scene`` (``tests/test_replay_persistent.py
:951-976``): a textured quad floor (an 8x8 two-colour checker on material
0), a diffuse sphere, an emissive sphere area light and a point light, at
16x12, tile_rows 8, spp 2, budget 6, 3 bounces, roulette after bounce 3.

Two JAX interpret-mode calls on one set of uniforms, NEE: launch 1
(``phase="adjoint"``, which records each completed path's C_tot) and the
scatter walk (``phase="scatter"``). The bars:

* the port's plain L, n_samp, every GA/GI plane and every C_tot plane agree
  with JAX's on >= 98% of lanes (``utils/metrics.py``);
* both scatter walks take the same cotangent planes, zeroed where the lanes
  disagree (the masked ``g``), and the atlases agree at the JAX test's
  tolerances (rtol 2e-3, atol 1e-7); loss, ``mat_color`` and
  ``light_intensity`` from the fold over the agreeing lanes at rtol 1e-4 /
  2e-3 (every lane agrees here, so these are the whole gradients);
* one train step of the port from the JAX trainer's state, carried across,
  equals the JAX trainer's update (optax Adam and its clamps) of the JAX
  kernel's gradients, parameters to 1e-5.

Without JAX: brute force, where roulette never fires (MB = RRS = 3), so the
loss is smooth in the texels, the atlas gradient against central
differences of the plain loss; the chunked driver at spp 33 against the
pooled fold of its own chunk launches; the routes that raise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_replay_persistent import jax_uniforms  # noqa: E402
from test_torch_scene_camera import (  # noqa: E402
    camera_to_torch, scene_to_torch,
)
from tpu_pathtracer.diff import inverse as jinv  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import meshes as jmeshes  # noqa: E402
from tpu_pathtracer.models.mesh import build_bvh as jbuild_bvh  # noqa: E402
from tpu_pathtracer.ops.pallas import replay_persistent as jrp  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.diff import inverse as tinv  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models import meshes as tmeshes  # noqa: E402
from tpu_pathtracer_torch.models.integrator import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.models.mesh import build_bvh as tbuild_bvh  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import replay_persistent as trp  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, grad_lane_agreement, _close,
)

W, H, TR = 16, 12, 8
SPP, MB, RRS, BUDGET = 2, 3, 3, 6
SEED = (5, 3)
LOSS_RTOL, GRAD_RTOL = 1e-4, 2e-3  # tests/test_replay_persistent.py:1003
TEX_ATOL = 1e-7
STEP_TOL, LR = 1e-5, 5e-2
FD_H, FD_RTOL = 1e-2, 2e-2


def tex_scene(mod, build_bvh, meshes, **device):
    """The JAX suite's tex_scene from either package's builders (``device``
    goes to the port's), packed."""
    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    mesh = build_bvh(v, f, uv, 0, **device)
    tex = meshes.checker_texture(8, tiles=2, c0=(0.9, 0.2, 0.15),
                                 c1=(0.1, 0.8, 0.85))
    scene = mod.make_scene(
        [mod.sphere([0, 2, 0], 1.0, 1),
         mod.sphere([2, 2.5, 0], 1.5, 2, light=1)],
        [mod.diffuse([0.7, 1.0, 0.9]), mod.diffuse([0.8, 0.4, 0.3]),
         mod.diffuse([0.05, 0.05, 0.05])],
        [mod.point_light([0.0, 8.0, 3.0], [60.0, 60.0, 60.0]),
         mod.area_light(1, [40.0, 40.0, 40.0])],
        mesh=mesh, textures=tex, mat_texture=[0, -1, -1], **device)
    return mod.with_packet_mesh(scene)


def _kw(use_nee, spp=SPP, budget=BUDGET):
    return dict(spp=spp, budget=budget, width=W, height=H, max_bounces=MB,
                rr_start=RRS, tile_rows=TR, use_nee=use_nee)


@pytest.fixture(scope="module")
def case():
    """JAX launch 1 and its scatter walk (NEE, interpret mode) and the
    port's plain walks on the same uniforms; both scatters take the port's
    launch-1 cotangent, zeroed on the lanes that disagree."""
    js = tex_scene(jsc, jbuild_bvh, jmeshes)
    jc = jcm.make_camera([0, 10, 9], [0, 0, 0], [0, 1, 0], W, H, 60.0)
    rows, _ = jrp.pixel_lanes_layout(W, H, TR)
    target = np.random.default_rng(3).random((H, W, 3), np.float32)
    jargs = (js, jpack_camera(jc), jnp.asarray(SEED, jnp.int32),
             jnp.int32(0), jrp.target_to_lanes(jnp.asarray(target), rows))
    jL, jns, jga, jgi, jrays, jct = jrp.persistent_replay_call(
        *jargs, interpret=True, phase="adjoint", **_kw(True))
    jout = tuple(torch.tensor(np.asarray(x)) for x in (jL, jns, jga, jgi))
    jct = torch.stack([torch.tensor(np.asarray(x)) for x in jct])

    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    assert ts.textured and trp.tex_route(ts)
    tgt = trp.target_to_lanes(torch.tensor(target), rows)
    u = torch.tensor(jax_uniforms(SEED, 0, rows // TR, BUDGET, True))
    args = (ts, pack_camera(tc), SEED, 0, tgt)
    adj = trp.persistent_replay_call(*args, phase="adjoint", uniforms=u,
                                     **_kw(True))
    both = trp.persistent_replay_call(*args, uniforms=u, **_kw(True))
    agree = grad_lane_agreement(jout, adj[:4], W, H)
    ct_ok = _close(jct.double(), adj[5].double()).all(0)
    mask = agree["mask"] & ct_ok
    g = trp.lane_cotangent(adj[0], adj[1], tgt, W, H) * mask
    jgT = jrp.persistent_replay_call(
        *jargs, interpret=True, phase="scatter",
        ext_g=tuple(jnp.asarray(x.numpy()) for x in g),
        ext_ct=tuple(jnp.asarray(x.numpy()) for x in jct), ext_ns=jns,
        **_kw(True))
    tgT = trp.persistent_replay_call(*args, phase="scatter", uniforms=u,
                                     ext_g=g, ext_ct=adj[5], ext_ns=adj[1],
                                     **_kw(True))
    return dict(js=js, jc=jc, ts=ts, tc=tc, target=target, tgt=tgt, u=u,
                jout=jout, jct=jct, jrays=int(jrays), adj=adj, both=both,
                agree=agree, ct_ok=ct_ok, mask=mask,
                jgT=torch.tensor(np.asarray(jgT)), tgT=tgT)


def test_plain_lanes_match_jax_kernel_textured(case):
    """>= 98% of lanes agree on n_samp, L, every GA/GI plane and every
    C_tot plane; the textured material's planes and the records are not
    all zero; equal ray counts up to one segment per thousand."""
    agree = case["agree"]
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    for name, frac in agree["planes"].items():
        assert frac >= AGREE, (name, agree)
    ct_frac = case["ct_ok"].reshape(-1)[:W * H].double().mean().item()
    assert ct_frac >= AGREE, ct_frac
    L, ns, ga, gi, rays, ct = case["adj"]
    assert ct.shape == (3 * SPP,) + tuple(ns.shape)
    assert bool(ga[0].abs().max() > 0) and bool(ct.abs().max() > 0)
    assert abs(int(rays) - case["jrays"]) <= max(1, case["jrays"] // 1000)


def test_loss_and_grads_match_jax_textured(case):
    """Phase "both" equals the fold of phase "adjoint" and carries the
    scatter's atlas; the fold over the agreeing lanes equals the same fold
    over JAX's; the masked-g atlases agree at the JAX test's bars and some
    taps are nonzero."""
    L, ns, ga, gi, _, ct = case["adj"]
    _, ns_b, loss, gA, gI, _, gT = case["both"]
    tgt, mask = case["tgt"], case["mask"]
    assert torch.equal(ns, ns_b) and gT.shape == case["ts"].textures.shape
    f_loss, f_gA, f_gI = trp.mse_fold(L, ns, ga, gi, tgt, W, H)
    np.testing.assert_allclose(float(loss), float(f_loss), rtol=1e-5)
    np.testing.assert_allclose(gA.numpy(), f_gA.numpy(), rtol=1e-5,
                               atol=1e-9)
    t_fold = trp.mse_fold(L, ns, ga, gi, tgt, W, H, mask)
    j_fold = trp.mse_fold(*case["jout"], tgt, W, H, mask)
    np.testing.assert_allclose(float(t_fold[0]), float(j_fold[0]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_fold[1].numpy(), j_fold[1].numpy(),
                               rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(t_fold[2].numpy(), j_fold[2].numpy(),
                               rtol=GRAD_RTOL, atol=1e-7)
    np.testing.assert_allclose(case["tgT"].numpy(), case["jgT"].numpy(),
                               rtol=GRAD_RTOL, atol=TEX_ATOL)
    assert float(case["jgT"].abs().max()) > 0
    if bool(mask.reshape(-1)[:W * H].all()):
        # every lane agrees: the masked g is the whole cotangent
        np.testing.assert_allclose(gT.numpy(), case["jgT"].numpy(),
                                   rtol=GRAD_RTOL, atol=TEX_ATOL)


def test_textured_train_step_matches_jax(case):
    """One make_kernel_train_step step from params_of (with the atlas),
    carried across from the JAX trainer's state, equals the JAX trainer's
    update of the JAX kernel's gradients (optax Adam, then its clamps)."""
    assert bool(case["mask"].reshape(-1)[:W * H].all())
    js, ts = case["js"], case["ts"]
    optimizer = optax.adam(LR)
    jstate = jinv.init_state(js, optimizer)
    assert set(jstate.params) == {"mat_color", "light_intensity", "textures"}
    assert set(tinv.params_of(ts)) == set(jstate.params)
    # the JAX kernel's gradients: its lanes folded, its scatter's atlas
    loss, gA, gI = trp.mse_fold(*case["jout"], case["tgt"], W, H)
    jgrads = {
        "mat_color": jnp.asarray(gA.numpy())
        / jnp.maximum(js.mat_color, 1e-8),
        "light_intensity": jnp.zeros_like(js.light_intensity).at[
            :gI.shape[0]].set(jnp.asarray(gI.numpy()))
        / jnp.maximum(js.light_intensity, 1e-8),
        "textures": jnp.asarray(case["jgT"].numpy()),
    }
    updates, opt1 = optimizer.update(jgrads, jstate.opt_state, jstate.params)
    want = jinv._clamp_params(optax.apply_updates(jstate.params, updates))

    def np_tree(t):
        return {k: np.asarray(t[k]) for k in jstate.params}

    st = jstate.opt_state[0]
    state = tinv.train_state_from_numpy(
        np_tree(jstate.params),
        {"count": int(st.count), "mu": np_tree(st.mu), "nu": np_tree(st.nu)},
        0, lr=LR, device="cpu")
    step = tinv.make_kernel_train_step(
        ts, case["tc"], RenderConfig(spp=SPP, max_bounces=MB, rr_start=RRS,
                                     use_nee=True),
        fixed_iteration=0, tile_rows=TR, budget=BUDGET, uniforms=case["u"])
    state, tloss = step(state, torch.tensor(case["target"]), SEED)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=STEP_TOL)
    params, adam, n = tinv.train_state_to_numpy(state)
    assert n == 1 and adam["count"] == 1
    for k in want:
        np.testing.assert_allclose(params[k], np.asarray(want[k]),
                                   atol=STEP_TOL, err_msg=k)
    moved = np.abs(params["textures"] - np.asarray(js.textures)).max()
    assert moved > 0.5 * LR


@pytest.fixture(scope="module")
def plain_scene():
    scene = tex_scene(tsc, tbuild_bvh, tmeshes, device="cpu")
    cam = tcm.make_camera([0, 10, 9], [0, 0, 0], [0, 1, 0], W, H, 60.0,
                          device="cpu")
    target = torch.tensor(
        np.random.default_rng(5).random((H, W, 3), np.float32))
    return scene, cam, target


def test_atlas_gradient_matches_finite_differences(plain_scene):
    """Brute force, where roulette never fires: the plain atlas gradient on
    the 5 entries of largest |g| equals central differences of the plain
    loss (h 1e-2, the same draws) at rtol 2e-2."""
    scene, cam, target = plain_scene
    kw = dict(spp=SPP, budget=BUDGET, max_bounces=MB, rr_start=RRS,
              tile_rows=TR, use_nee=False)
    _, grads, _ = trp.persistent_mse_value_and_grad(scene, cam, (7, 1), 0,
                                                    target, **kw)
    gT = grads["textures"]
    top = torch.topk(gT.abs().reshape(-1), 5).indices
    assert float(gT.abs().max()) > 0
    for i in top.tolist():
        fd = []
        for s in (1.0, -1.0):
            tex = scene.textures.clone()
            tex.view(-1)[i] += s * FD_H
            loss, _, _ = trp.persistent_mse_value_and_grad(
                tinv.apply_params(scene, dict(tinv.params_of(scene),
                                              textures=tex)),
                cam, (7, 1), 0, target, **kw)
            fd.append(float(loss))
        np.testing.assert_allclose(float(gT.view(-1)[i]),
                                   (fd[0] - fd[1]) / (2 * FD_H),
                                   rtol=FD_RTOL, err_msg=str(i))


def test_chunked_driver_composes_as_jax(plain_scene):
    """spp 33 at iteration 1 goes to the chunked driver: chunks (32, 9) and
    (1, 1) by JAX's budget formula at iterations 2 and 3; its loss and
    gradients equal the pooled fold of those chunk launches, and its atlas
    the sum of their scatters with the pooled cotangent."""
    scene, cam, target = plain_scene
    spp, budget, it = 33, 9, 1
    assert trp.chunk_plan(spp, budget, MB) == [(32, 9), (1, 1)]
    assert trp.chunk_plan(80, None, MB) == [
        (32, trp.default_budget(32, MB)), (32, trp.default_budget(32, MB)),
        (16, trp.default_budget(16, MB))]
    loss, grads, nrays = trp.persistent_mse_value_and_grad(
        scene, cam, (4, 2), it, target, spp=spp, budget=budget,
        max_bounces=MB, rr_start=RRS, tile_rows=TR, use_nee=True)
    rows, _ = trp.pixel_lanes_layout(W, H, TR)
    tgt = trp.target_to_lanes(target, rows)
    outs = [trp.persistent_replay_call(
        scene, pack_camera(cam), (4, 2), 2 * it + r, tgt, phase="adjoint",
        **_kw(True, c_spp, c_budget))
        for r, (c_spp, c_budget) in enumerate([(32, 9), (1, 1)])]
    L, ns, ga, gi = (sum(o[j] for o in outs) for j in range(4))
    want = trp.mse_fold(L, ns, ga, gi, tgt, W, H)
    np.testing.assert_allclose(float(loss), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(
        (grads["mat_color"] * torch.clamp_min(scene.mat_color, 1e-8)).numpy(),
        want[1].numpy(), rtol=1e-5, atol=1e-9)
    n_l = want[2].shape[0]
    np.testing.assert_allclose(
        (grads["light_intensity"]
         * torch.clamp_min(scene.light_intensity, 1e-8))[:n_l].numpy(),
        want[2].numpy(), rtol=1e-5, atol=1e-9)
    assert int(nrays) == sum(int(o[4]) for o in outs)
    # the pooled mean's lane-local cotangent (JAX :1656-1676)
    lane = torch.arange(ns.numel()).reshape(ns.shape)
    havef = ((ns > 0) & (lane < W * H)).to(torch.float32)
    inv_n = havef / torch.clamp_min(ns.to(torch.float32), 1.0)
    g = torch.stack([(L[..., c] * inv_n - tgt[..., c]) * havef
                     for c in range(3)]) * (2.0 / (W * H * 3)) * inv_n
    gT = sum(trp.persistent_replay_call(
        scene, pack_camera(cam), (4, 2), 2 * it + r, tgt, phase="scatter",
        ext_g=g, ext_ct=o[5], ext_ns=o[1], **_kw(True, c_spp, c_budget))
        for r, ((c_spp, c_budget), o) in enumerate(zip([(32, 9), (1, 1)],
                                                       outs)))
    np.testing.assert_allclose(grads["textures"].numpy(), gT.numpy(),
                               rtol=1e-5, atol=1e-9)
    assert float(gT.abs().max()) > 0


def test_texture_routes_raise(plain_scene):
    """JAX's ValueErrors: a textured gradient of spp > 32 in one launch,
    textures with mat_coef, "textures" on a scene with no mesh; a scatter
    on a scene whose kernels take no atlas; no atlas for the kernels
    without a mesh."""
    scene, cam, target = plain_scene
    rows, _ = trp.pixel_lanes_layout(W, H, TR)
    tgt = trp.target_to_lanes(target, rows)
    cp = pack_camera(cam)
    with pytest.raises(ValueError, match="spp=33 > 32"):
        trp.persistent_replay_call(scene, cp, (0, 0), 0, tgt,
                                   **_kw(False, 33, 1))
    # without the atlas gradient (a forward target) spp is not capped
    out = trp.persistent_replay_call(scene, cp, (0, 0), 0, tgt,
                                     compute_tex_grad=False,
                                     **_kw(False, 33, 1))
    assert out[6] is None
    params = tinv.params_of(scene, ior=True)
    with pytest.raises(ValueError, match="mat_coef gradients"):
        tinv.kernel_loss_and_grads(params, scene, cam, target, (0, 0), 0,
                                   spp=1, tile_rows=TR, budget=1)
    bare = tsc.make_scene([tsc.sphere([0, 0, 0], 1.0, 0)],
                          [tsc.diffuse([0.5, 0.5, 0.5])],
                          [tsc.point_light([0, 3, 0], [9.0, 9.0, 9.0])],
                          textures=np.ones((2, 2, 3), np.float32),
                          mat_texture=[0], device="cpu")
    assert "textures" in tinv.params_of(bare)
    # with no mesh the kernels take no atlas, as in JAX (the forward
    # launch refused a textured material without a mesh before)
    assert bare.textured and not trp.tex_route(bare)
    assert tpk.texture_arguments(bare, torch.device("cpu"))[0][0] is None
    with pytest.raises(ValueError, match="cannot produce atlas gradients"):
        tinv.kernel_loss_and_grads(tinv.params_of(bare), bare, cam, target,
                                   (0, 0), 0, spp=1, tile_rows=TR, budget=1)
    with pytest.raises(ValueError, match='phase="scatter"'):
        trp.persistent_replay_call(bare, cp, (0, 0), 0, tgt, phase="scatter",
                                   ext_g=tgt, ext_ct=tgt, ext_ns=tgt,
                                   **_kw(False))
