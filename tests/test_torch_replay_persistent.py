"""The port's fused value-and-grad walk against the JAX kernel in interpret
mode.

The JAX side runs ``persistent_replay_call(..., phase="adjoint",
interpret=True)`` once per transport mode, as its own tests run it; the
uniform block it draws (``jax.random.key(2)``, ``replay_persistent.py:1307-
1322``) is rebuilt here with the same ``jax.random`` calls and handed to the
port's plain version through numpy. The bars:

* per lane, the JAX package's own kernel-vs-replica bar (``lane_agreement``):
  at least 98% of lanes agree on the sample count, on radiance and on every
  per-lane GA/GI plane within ``1e-4 * max(1, |x|)``;
* loss and raw gradients: the port's phase "both" equals the JAX package's
  cotangent fold (``:1656-1676``) over its own per-lane outputs (only the
  summation order differs, rtol 1e-5); and that fold over the lanes that
  agree equals the same fold over the JAX kernel's lanes at rtol 1e-4
  (loss) and 2e-3 (gradients), the JAX tests' bars. Where every lane
  agrees, this is the whole image;
* the live-ray counts are equal, up to one segment per thousand (see
  ``test_ray_counts_match_jax_kernel``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_scene_camera import camera_to_torch, scene_to_torch  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.ops.pallas import replay_persistent as jrp  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import replay_persistent as trp  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    LANES, pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, grad_lane_agreement,
)

W, H, TR = 16, 12, 8
# Russian roulette runs once bounce > RRS; with RRS 0 it decides whether a
# path goes on after its second and third vertices and boosts the throughput
# of the next, so the roulette branch feeds L, cA and GA in every comparison
# below.
SPP, MB, RRS, BUDGET = 2, 3, 0, 6
FOLD_RTOL = 1e-5  # the same lanes summed in another order
LOSS_RTOL, GRAD_RTOL = 1e-4, 2e-3  # tests/test_replay_persistent.py's bars


def jax_uniforms(seed, iteration, n_tiles, budget, use_nee, tile_rows=TR,
                 use_dof=False):
    """The external uniform block interpret mode feeds the JAX gradient
    kernel: key(2), folded with seed[0] + 131*seed[1], the iteration and the
    global tile."""
    n_draw = tpk.n_draws(use_nee, use_dof)
    rkey = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(2), seed[0] + 131 * seed[1]),
        iteration)
    blk = budget * n_draw * tile_rows
    return np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(rkey, t),
                                      (blk, LANES), jnp.float32))
        for t in range(n_tiles)])


CASES = {"brute": ((4, 11), False), "nee": ((9, 4), True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One JAX interpret-mode adjoint launch and the port's plain version on
    the same uniforms, target and scene tables."""
    seed, use_nee = CASES[request.param]
    js, cs = jsc.cornell_spheres()
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"])
    rows, _ = jrp.pixel_lanes_layout(W, H, TR)
    target = np.random.default_rng(7).random((H, W, 3), np.float32)
    kw = dict(spp=SPP, budget=BUDGET, width=W, height=H, max_bounces=MB,
              rr_start=RRS, tile_rows=TR, use_nee=use_nee)
    jout = jrp.persistent_replay_call(
        js, jpack_camera(jc), jnp.asarray(seed, jnp.int32), jnp.int32(0),
        jrp.target_to_lanes(jnp.asarray(target), rows), interpret=True,
        phase="adjoint", **kw)
    jL, jns, jga, jgi, jrays, _ = (None if x is None else np.asarray(x)
                                   for x in jout)

    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    tgt = trp.target_to_lanes(torch.tensor(target), rows)
    u = torch.tensor(jax_uniforms(seed, 0, rows // TR, BUDGET, use_nee))
    args = (ts, pack_camera(tc), seed, 0, tgt)
    adj = trp.persistent_replay_call(*args, phase="adjoint", uniforms=u, **kw)
    both = trp.persistent_replay_call(*args, phase="both", uniforms=u, **kw)
    jax_lanes = tuple(torch.tensor(x) for x in (jL, jns, jga, jgi))
    return dict(jax=jax_lanes, jrays=int(jrays), adj=adj, both=both,
                tgt=tgt, slots=trp.material_slots(ts)[0])


def test_plain_lanes_match_jax_kernel(case):
    """>= 98% of lanes agree on n_samp, L and every GA/GI plane."""
    L, ns, ga, gi, _, _ = case["adj"]
    jL, jns, jga, jgi = case["jax"]
    agree = grad_lane_agreement((jL, jns, jga, jgi), (L, ns, ga, gi), W, H)
    assert agree["n_samp"] >= AGREE, agree
    assert agree["L"] >= AGREE, agree
    for name, frac in agree["planes"].items():
        assert frac >= AGREE, (name, agree)
    # planes of materials without prims stay exactly zero on both sides
    empty = [m for m in range(ga.shape[0]) if m not in case["slots"]]
    assert (ga[empty] == 0).all() and (jga[empty] == 0).all()
    assert int(ns.max()) <= SPP and torch.isfinite(L).all()


def test_ray_counts_match_jax_kernel(case):
    """Equal live-ray counts, up to one segment per thousand: a path whose
    length flips on an f32 tie traces one segment more or less. Measured:
    equal in both modes here (846 brute force, 883 NEE); with roulette from
    bounce 3, NEE gave 1058 vs 1059 while every lane's completed-path
    outputs agreed, so the flipped segment belonged to a path that added
    nothing, or was still in flight at the end of the launch."""
    for rays in (int(case["adj"][4]), int(case["both"][5])):
        assert abs(rays - case["jrays"]) <= max(1, case["jrays"] // 1000)
    assert int(case["adj"][4]) == int(case["both"][5])


def test_loss_and_grads_match_jax_fold(case):
    """Phase "both" equals the cotangent fold over phase "adjoint"'s lanes,
    and the fold over the agreeing lanes equals the JAX kernel's."""
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
    mask = grad_lane_agreement((jL, jns, jga, jgi), (L, ns, ga, gi), W,
                               H)["mask"]
    t_loss, t_gA, t_gI = trp.mse_fold(L, ns, ga, gi, tgt, W, H, mask)
    j_loss, j_gA, j_gI = trp.mse_fold(jL, jns, jga, jgi, tgt, W, H, mask)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_gA.numpy(), j_gA.numpy(), rtol=GRAD_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(t_gI.numpy(), j_gI.numpy(), rtol=GRAD_RTOL,
                               atol=1e-7)
    assert np.abs(gA.numpy()).max() > 0 and np.abs(gI.numpy()).max() > 0


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], device="cpu")
    rows, _ = trp.pixel_lanes_layout(W, H, TR)
    tgt = trp.target_to_lanes(torch.rand((H, W, 3),
                                         generator=torch.Generator()
                                         .manual_seed(3)), rows)
    return scene, pack_camera(cam), tgt


@pytest.mark.parametrize("use_nee", [False, True])
def test_sample_count_guarantee(cornell, use_nee):
    """budget >= spp*(max_bounces+1) completes exactly spp paths per pixel;
    no budget completes more; padding lanes stay inert; the loss equals the
    MSE of the completed-path means (production Philox draws)."""
    scene, cp, tgt = cornell
    kw = dict(spp=SPP, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee)
    L, ns, loss, _, _, _, _ = trp.persistent_replay_call(
        scene, cp, (8, 3), 0, tgt, budget=SPP * (MB + 1), **kw)
    flat = ns.reshape(-1)
    assert (flat[: W * H] == SPP).all()
    assert (flat[W * H:] == 0).all() and (L.reshape(-1, 3)[W * H:] == 0).all()
    img = L.reshape(-1, 3)[: W * H] / SPP
    want = torch.mean((img - tgt.reshape(-1, 3)[: W * H]) ** 2)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    _, ns2, ga, gi, _, _ = trp.persistent_replay_call(
        scene, cp, (8, 3), 0, tgt, budget=2, phase="adjoint", **kw)
    assert int(ns2.max()) <= SPP
    assert (ga.reshape(ga.shape[0], 3, -1)[..., W * H:] == 0).all()
    assert (gi.reshape(gi.shape[0], 3, -1)[..., W * H:] == 0).all()


def test_production_stream_is_its_own():
    """The gradient walk's Philox draws differ from the forward kernel's
    for the same seed, frame and lane."""
    lane = torch.arange(64, dtype=torch.int64)
    fwd = tpk.philox_uniforms(lane, 5, 1, 0, 0, 8)
    grad = tpk.philox_uniforms(lane, 5, 1, 0, 0, 8, stream=trp.STREAM)
    assert all(not torch.equal(a, b) for a, b in zip(fwd, grad))


def test_unsupported_routes_raise(cornell):
    """The scatter phase needs a textured mesh scene (JAX returns no atlas
    gradient without one); the lens runs; the chunked driver runs on a
    sphere scene and gives no atlas gradient; other devices raise."""
    scene, cp, tgt = cornell
    kw = dict(spp=SPP, budget=2, width=W, height=H, tile_rows=TR)
    with pytest.raises(ValueError, match='phase="scatter"'):
        trp.persistent_replay_call(scene, cp, (1, 0), 0, tgt,
                                   phase="scatter", ext_g=tgt, ext_ct=tgt,
                                   ext_ns=tgt, **kw)
    # thin-lens DOF is ported: with a lens in the packed camera, use_dof
    # runs and starts paths off the eye (tests/test_torch_dof.py holds it
    # to the JAX kernel)
    cp_lens = cp.clone()
    cp_lens[12], cp_lens[13] = 4.0, 60.0
    pin = trp.persistent_replay_call(scene, cp_lens, (1, 0), 0, tgt, **kw)
    dof = trp.persistent_replay_call(scene, cp_lens, (1, 0), 0, tgt,
                                     use_dof=True, **kw)
    assert torch.isfinite(dof[0]).all() and torch.isfinite(dof[2])
    assert not torch.equal(pin[0], dof[0])
    _, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], device="cpu")
    loss, grads, _ = trp.chunked_mse_value_and_grad(
        scene, cam, (1, 0), 0, torch.zeros((H, W, 3)), spp=33, budget=2,
        tile_rows=TR)
    assert "textures" not in grads and torch.isfinite(loss)
    with pytest.raises(ValueError, match="unsupported device"):
        trp.persistent_replay_call(scene, cp, (1, 0), 0,
                                   tgt.to("meta"), **kw)


def test_launch_counter_counts_kernel_launches_only(cornell):
    scene, cp, tgt = cornell
    before = trp.launches
    trp.persistent_replay_call(scene, cp, (1, 0), 0, tgt, spp=1, budget=1,
                               width=W, height=H, tile_rows=TR)
    assert trp.launches == before


def test_warp_occupancy_counts(cornell):
    """The plain walk's warp occupancy of the schedule (chip_smoke.py's
    ``[replay live share]``): every warp-iteration has a live lane or none,
    packing the live lanes of each row never takes more warps than hold
    them, and the packed warps hold every live segment."""
    scene, cp, tgt = cornell
    counts = {}
    out = trp.persistent_replay_ref(
        scene, cp, (8, 3), 0, tgt, spp=SPP, budget=BUDGET, width=W,
        height=H, max_bounces=MB, tile_rows=TR, counts=counts)
    rows = tgt.shape[0]
    assert counts["warp_iters"] == BUDGET * rows * LANES // 32
    live, packed = int(counts["warp_live"]), int(counts["warp_packed"])
    assert 0 < packed <= live <= counts["warp_iters"]
    assert int(out[5]) <= 32 * packed


def test_limit_scene_fills_the_adjoint():
    """limit_spheres sits at the kernel's limits, 16 slots and 16 lights,
    and every light's intensity adjoint is reached (plain walk, NEE)."""
    scene, cs = tsc.limit_spheres(device="cpu")
    assert len(trp.material_slots(scene)[0]) == trp.MAX_SLOTS
    assert len(scene.light_structure) == trp.MAX_GRAD_LIGHTS
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                          cs["fov"], device="cpu")
    rows, _ = trp.pixel_lanes_layout(W, H, TR)
    tgt = torch.zeros((rows, LANES, 3))
    L, ns, ga, gi, _, _ = trp.persistent_replay_call(
        scene, pack_camera(cam), (1, 2), 0, tgt, spp=2, budget=12, width=W,
        height=H, tile_rows=TR, use_nee=True, phase="adjoint")
    assert torch.isfinite(L).all() and int(ns.sum()) > 0
    assert bool((gi.abs().sum((1, 2, 3)) > 0).all())


@pytest.mark.parametrize("n_slots, n_lights, scatter, want", [
    (5, 1, False, 4 * (LANES * (7 * 5 + 3 * 1 + 3) + 4 * 19)),
    (16, 16, False, 4 * (LANES * (7 * 16 + 3 * 16 + 3) + 4 * 97)),
    (16, 16, True, 4 * LANES * 3),
])
def test_shared_memory_per_block(n_slots, n_lights, scatter, want):
    """The kernel's block takes the adjoint sized to the scene: 7 words per
    slot and 3 per light per lane, the radiance sums and the epilogue's warp
    sums (cornell_spheres: 5 slots, 1 light, 21 KB; the limits: 16 and 16,
    83 KB; the scatter walk keeps no adjoint)."""
    assert trp.replay_smem_bytes(n_slots, n_lights, scatter=scatter) == want
    assert want <= trp.SMEM_PER_BLOCK


def test_shared_memory_past_the_block_is_refused():
    """A block may take 227 KB on the H100: 50 slots and 50 lights would
    need more, and the sizing helper refuses them."""
    with pytest.raises(ValueError, match="shared memory"):
        trp.replay_smem_bytes(50, 50)
    assert trp.replay_smem_bytes(50, 50, scatter=True) == 4 * LANES * 3
