"""The schedules that kernels 4 and 8 walk, counted by their plain versions.

``camera_jvp_ref``'s warp occupancy (what ``chip_smoke.py`` prints as
``[16 tangent live share]``) against a count made by hand from its lanes'
segment counts: a lane acts from iteration 0 until its pixel has its spp
paths, so a warp is live for as many iterations as its longest lane walks;
a budget too short to drain keeps every warp with a pixel live, and a
longer one adds no live warp-iteration once every pixel is done.
``trace_lanes_ref``'s walk lengths (``[35 trace live share]``): their sum
is the ray count and the warps' longest walks bound it. The tangent
kernel's shared-memory sizing and its refusal, and kernel 8's refusal of
lane ids that would wrap. No JAX: these are the port's
own functions.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.models import camera as cm, scene as sc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.replay_persistent import (  # noqa: E402
    SMEM_PER_BLOCK,
)
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    LANES, pack_camera,
)

W, H, TR, MB = 16, 12, 8, 3


@pytest.fixture(scope="module")
def cornell():
    scene, cs = sc.cornell_spheres(device="cpu")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cpu")
    return scene, pack_camera(cam)


def _tangent_counts(cornell, spp, budget, use_nee=False):
    scene, cp = cornell
    rows = torch.zeros((1, 24))
    rows[0, 9] = 1.0  # the camera's x position
    counts = {}
    out = cj.camera_jvp_ref(scene, cp, rows, (4, 1), 0, spp=spp,
                            budget=budget, width=W, height=H,
                            max_bounces=MB, tile_rows=TR, use_nee=use_nee,
                            counts=counts)
    return counts, out


def _by_hand(lane_segments, budget):
    """Warp-iterations with a live lane: per 32-lane warp, the iterations
    until its longest lane is done, within the budget."""
    longest = lane_segments.reshape(-1, 32).amax(-1).clamp_max(budget)
    return int(longest.sum())


@pytest.mark.parametrize("use_nee", [False, True])
def test_tangent_occupancy_matches_a_count_by_hand(cornell, use_nee):
    budget = 12
    counts, out = _tangent_counts(cornell, 2, budget, use_nee)
    seg = counts["lane_segments"]
    rows = seg.shape[0]
    assert counts["warp_iters"] == budget * rows * LANES // 32
    assert counts["segments"] == int(seg.sum())
    assert counts["warp_live"] == _by_hand(seg, budget)
    assert 0 < counts["warp_packed"] <= counts["warp_live"] \
        <= counts["warp_iters"]
    assert counts["segments"] <= 32 * counts["warp_live"]
    # the ray count: the segments plus the NEE shadow segments needed
    assert int(out[3]) == counts["segments"] + counts["shadow"]
    assert int(seg.reshape(-1)[W * H:].sum()) == 0  # padding never acts


def test_short_budget_keeps_every_pixel_warp_live(cornell):
    """spp 4 needs at least 4 iterations per pixel, so in 3 every warp with
    a pixel is live in every iteration and no lane drains."""
    counts, out = _tangent_counts(cornell, 4, 3)
    warps = -(-(W * H) // 32)
    assert counts["warp_live"] == 3 * warps
    assert int(out[2].reshape(-1)[:W * H].max()) < 4


def test_drained_warps_add_no_live_iterations(cornell):
    """Once every pixel has its spp paths (each at most MB + 1 segments),
    a longer budget adds warp-iterations but no live one, and every pixel
    ends with spp paths."""
    c1, o1 = _tangent_counts(cornell, 2, 2 * (MB + 1))
    c2, o2 = _tangent_counts(cornell, 2, 2 * (MB + 1) + 5)
    assert c1["warp_live"] == c2["warp_live"]
    assert c2["warp_iters"] - c1["warp_iters"] == 5 * o1[2].numel() // 32
    assert torch.equal(o1[2], o2[2]) and torch.equal(o1[0], o2[0])
    assert bool((o1[2].reshape(-1)[:W * H] == 2).all())
    assert torch.equal(c1["lane_segments"], c2["lane_segments"])


@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("spp", [1, 4])
def test_trace_walk_lengths(cornell, use_nee, spp):
    """The per-sample walks' lengths: one primary ray per lane of the
    image and at most MB + 1 segments; their sum is the ray count, and 32
    times each warp's longest walk, summed, bounds it."""
    scene, cp = cornell
    counts = {}
    _, rays = tk.trace_lanes_ref(scene, cp, (5, 1, 2), spp=spp, width=W,
                                 height=H, max_bounces=MB, tile_rows=TR,
                                 use_nee=use_nee, counts=counts)
    seg = counts["lane_segments"].reshape(-1)
    n = W * H * spp
    assert counts["vertices"] == int(rays) == int(seg.sum())
    assert bool((seg[:n] >= 1).all()) and int(seg[:n].max()) <= MB + 1
    assert int(seg[n:].sum()) == 0
    by_hand = sum(32 * max(seg[i:i + 32].tolist())
                  for i in range(0, seg.numel(), 32))
    assert counts["warp_longest"] == by_hand >= counts["vertices"]


def test_tangent_smem_sizing_and_refusal():
    """3 words per lane for L and 7 per tangent (dL, sS, cS), 128 lanes of
    4 bytes; past a block's shared memory, or without a tangent, the
    launcher refuses before any launch."""
    for n_tan in range(1, cj.MAX_TAN + 1):
        assert cj.tangent_smem_bytes(n_tan) == 4 * LANES * (3 + 7 * n_tan)
    fits = (SMEM_PER_BLOCK // (4 * LANES) - 3) // 7
    assert cj.tangent_smem_bytes(fits) <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        cj.tangent_smem_bytes(fits + 1)
    with pytest.raises(ValueError):
        cj.tangent_smem_bytes(0)


def test_trace_lane_id_guard():
    """Kernel 8's lane ids are int32: the launcher refuses, before any
    launch, a layout of 2**31 lanes or more, and takes one lane less."""
    tk.check_lane_ids(2 ** 31 // LANES - 1)
    with pytest.raises(ValueError, match="int32 lane ids"):
        tk.check_lane_ids(2 ** 31 // LANES)
