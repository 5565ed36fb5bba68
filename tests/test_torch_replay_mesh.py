"""The port's plain fused value-and-grad walk on a mesh scene against the JAX
kernel in interpret mode.

One JAX compile (~80 s on a CPU): ``cornell_quad`` with NEE, whose only
light is a TRI_LIGHT quad, so the intensity gradient comes from triangle
emission and triangle NEE and every material gradient from mesh vertices.
At 16x8, tile_rows 8, spp 2, budget 6, 3 bounces and roulette from bounce
0; the bars are those of ``tests/test_torch_replay_persistent.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_replay_persistent import (  # noqa: E402
    FOLD_RTOL, GRAD_RTOL, LOSS_RTOL, jax_uniforms,
)
from test_torch_scene_camera import (  # noqa: E402
    camera_to_torch, scene_to_torch,
)
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.ops.pallas import replay_persistent as jrp  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.ops.kernels import replay_persistent as trp  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, grad_lane_agreement,
)

W, H, TR = 16, 8, 8
SPP, MB, RRS, BUDGET = 2, 3, 0, 6
SEED = (6, 1)


@pytest.fixture(scope="module")
def case():
    js, cs = jsc.cornell_quad()
    js = jsc.with_packet_mesh(js, two_pass=False)
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"])
    rows, _ = jrp.pixel_lanes_layout(W, H, TR)
    target = np.random.default_rng(11).random((H, W, 3), np.float32)
    kw = dict(spp=SPP, budget=BUDGET, width=W, height=H, max_bounces=MB,
              rr_start=RRS, tile_rows=TR, use_nee=True)
    jout = jrp.persistent_replay_call(
        js, jpack_camera(jc), jnp.asarray(SEED, jnp.int32), jnp.int32(0),
        jrp.target_to_lanes(jnp.asarray(target), rows), interpret=True,
        phase="adjoint", **kw)
    jL, jns, jga, jgi, jrays, _ = (None if x is None else np.asarray(x)
                                   for x in jout)
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    tgt = trp.target_to_lanes(torch.tensor(target), rows)
    u = torch.tensor(jax_uniforms(SEED, 0, rows // TR, BUDGET, True))
    args = (ts, pack_camera(tc), SEED, 0, tgt)
    adj = trp.persistent_replay_call(*args, phase="adjoint", uniforms=u, **kw)
    both = trp.persistent_replay_call(*args, phase="both", uniforms=u, **kw)
    return dict(jax=tuple(torch.tensor(x) for x in (jL, jns, jga, jgi)),
                jrays=int(jrays), adj=adj, both=both, tgt=tgt, scene=ts)


def test_plain_lanes_match_jax_kernel_on_mesh(case):
    """>= 98% of lanes agree on n_samp, L and every GA/GI plane; the
    mesh-material and TRI_LIGHT planes are not all zero; equal ray
    counts up to one segment per thousand."""
    L, ns, ga, gi, rays, _ = case["adj"]
    agree = grad_lane_agreement(case["jax"], (L, ns, ga, gi), W, H)
    assert agree["n_samp"] >= AGREE, agree
    assert agree["L"] >= AGREE, agree
    for name, frac in agree["planes"].items():
        assert frac >= AGREE, (name, agree)
    slots = trp.material_slots(case["scene"])[0]
    assert slots == (0, 1, 2, 3)  # every mesh material gets a slot
    assert all(bool(ga[m].abs().max() > 0) for m in (0, 1, 2))
    assert bool(gi[0].abs().max() > 0)
    assert abs(int(rays) - case["jrays"]) <= max(1, case["jrays"] // 1000)


def test_loss_and_grads_match_jax_fold_on_mesh(case):
    """Phase "both" equals the fold over phase "adjoint"'s lanes, and the
    fold over the agreeing lanes equals the JAX kernel's."""
    L, ns, ga, gi, _, _ = case["adj"]
    _, ns_b, loss, gA, gI, _, _ = case["both"]
    tgt = case["tgt"]
    assert torch.equal(ns, ns_b)
    f_loss, f_gA, f_gI = trp.mse_fold(L, ns, ga, gi, tgt, W, H)
    np.testing.assert_allclose(float(loss), float(f_loss), rtol=FOLD_RTOL)
    np.testing.assert_allclose(gA.numpy(), f_gA.numpy(), rtol=FOLD_RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(gI.numpy(), f_gI.numpy(), rtol=FOLD_RTOL,
                               atol=1e-9)
    jL, jns, jga, jgi = case["jax"]
    mask = grad_lane_agreement(case["jax"], (L, ns, ga, gi), W, H)["mask"]
    t_fold = trp.mse_fold(L, ns, ga, gi, tgt, W, H, mask)
    j_fold = trp.mse_fold(jL, jns, jga, jgi, tgt, W, H, mask)
    np.testing.assert_allclose(float(t_fold[0]), float(j_fold[0]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_fold[1].numpy(), j_fold[1].numpy(),
                               rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(t_fold[2].numpy(), j_fold[2].numpy(),
                               rtol=GRAD_RTOL, atol=1e-7)
