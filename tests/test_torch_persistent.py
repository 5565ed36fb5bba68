"""The port's persistent step against the JAX kernel in interpret mode.

The JAX side runs ``persistent_step(..., interpret=True)`` as its own tests
do; the uniform block it draws is rebuilt here with the same ``jax.random``
calls (``persistent.py:1188-1199``) and handed to the port's plain version
through numpy. Each JAX run happens once per module. The bar is the JAX
package's own kernel-vs-replica bar: at least 98% of lanes agree on the
sample count and on radiance, since the 1e5-radius wall spheres make f32
closest hits chaotic (``lane_agreement``). Radiance agrees where
``|dL| < 1e-4 * max(1, |L|)``: the reference's 1e-4, taken relative on lanes
brighter than 1. XLA's rsqrt
on the CPU is an approximation that differs from PyTorch's in the last bit
on about a third of inputs, and a one-ulp change of a ray direction moves a
hit on a 1e4-radius sphere by ~1e-3, which moves a bright NEE sample by a
few 1e-4 relative (the point-light scene: 96.9% of lanes within an absolute
1e-4, 99.5% within the relative bar).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_scene_camera import (  # noqa: E402
    camera_to_torch, point_light_scene, scene_to_torch,
)
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.ops.pallas import persistent as jpk  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    LANES, pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, lane_agreement,
)

W, H, TR = 32, 24, 8
# Russian roulette runs once bounce > RRS: with RRS 0 it decides whether a
# path goes on after its second and third vertices and boosts the
# throughput of the next.
MB, RRS, BUDGET, FRAMES = 3, 0, 6, 2

def jax_uniforms(seed, frame, n_tiles, budget, use_nee, tile_offset=0,
                 use_dof=False):
    """The external uniform block interpret mode feeds the JAX kernel."""
    n_draw = tpk.n_draws(use_nee, use_dof)
    rkey = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(0), seed[0] + 131 * seed[1]), frame)
    blk = budget * n_draw * TR
    return np.concatenate([
        np.asarray(jax.random.uniform(jax.random.fold_in(rkey, tile_offset + t),
                                      (blk, LANES), jnp.float32))
        for t in range(n_tiles)])


CASES = {
    # name: (scene builder, camera size, seed, use_nee)
    "cornell-brute": ("cornell", (W, H), (3, 7), False),
    "cornell-nee": ("cornell", (W, H), (9, 4), True),
    "point-nee": ("point", (16, 12), (11, 2), True),
}


def _scene_and_camera(name, w, h):
    if name == "point":
        js = point_light_scene(jsc)
        jc = jcm.make_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], w, h, 60.0)
    else:
        js, cs = jsc.BUILTIN_SCENES[name]()
        jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                             cs["fov"])
    return js, jc


def torch_state(js_state):
    """Carry a JAX PathState across to the port (CPU tensors)."""
    return tpk.PathState(
        **{f: torch.tensor(np.asarray(getattr(js_state, f)))
           for f in tpk.STATE_FIELDS},
        frame=int(js_state.frame))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One JAX interpret-mode run (FRAMES steps of BUDGET iterations) and the
    port's plain version on the same uniforms."""
    scene_name, (w, h), seed, use_nee = CASES[request.param]
    js, jc = _scene_and_camera(scene_name, w, h)
    kw = dict(budget=BUDGET, width=w, height=h, max_bounces=MB, rr_start=RRS,
              tile_rows=TR, use_nee=use_nee)
    jst = jpk.init_state(w, h, tile_rows=TR)
    jrays = []
    for _ in range(FRAMES):
        jst, nr = jpk.persistent_step(js, jpack_camera(jc),
                                      jnp.asarray(seed, jnp.int32), jst,
                                      interpret=True, **kw)
        jrays.append(int(nr))

    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    tst = tpk.init_state(w, h, tile_rows=TR, device="cpu")
    n_tiles = tst.lr.shape[0] // TR
    trays = []
    for f in range(FRAMES):
        u = torch.tensor(jax_uniforms(seed, f, n_tiles, BUDGET, use_nee))
        tst, nr = tpk.persistent_step(ts, pack_camera(tc), seed, tst,
                                      uniforms=u, **kw)
        trays.append(int(nr))
    return dict(w=w, h=h, jst=jst, tst=tst, jrays=jrays, trays=trays)


def test_plain_matches_jax_kernel(case):
    """>= 98% of lanes agree on n_samp and radiance after 2 frames."""
    w, h = case["w"], case["h"]
    n_agree, l_agree, _ = lane_agreement(torch_state(case["jst"]),
                                         case["tst"], w, h)
    assert n_agree >= AGREE, f"sample counts agree on only {n_agree:.4f}"
    assert l_agree >= AGREE, f"radiance agrees on only {l_agree:.4f}"
    assert int(tpk.state_min_samples(case["tst"], w, h)) >= 1
    assert torch.isfinite(tpk.state_image(case["tst"], w, h)).all()
    # live-ray counts: path segments, plus shadow segments under NEE
    for rj, rt in zip(case["jrays"], case["trays"]):
        assert abs(rj - rt) <= 0.01 * rj, (case["jrays"], case["trays"])


def test_state_readers_match_jax(case):
    """state_image / state_min_samples on the same state equal JAX's."""
    w, h = case["w"], case["h"]
    jst = case["jst"]
    tst = torch_state(jst)
    np.testing.assert_array_equal(
        tpk.state_image(tst, w, h).numpy(),
        np.asarray(jpk.state_image(jst, w, h)))
    assert int(tpk.state_min_samples(tst, w, h)) == int(
        jpk.state_min_samples(jst, w, h))


@pytest.fixture(scope="module")
def cornell_torch():
    scene, cs = tsc.cornell_spheres(device="cpu")
    from tpu_pathtracer_torch.models import camera as tcm

    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                          device="cpu")
    return scene, pack_camera(cam)


@pytest.mark.parametrize("use_nee", [False, True])
def test_sample_count_guarantee(cornell_torch, use_nee):
    """budget >= spp*(max_bounces+1) completes >= spp samples per pixel, and
    in brute force every lane is live every iteration."""
    scene, cp = cornell_torch
    st = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    st, nrays = tpk.persistent_step(
        scene, cp, (1, 2), st, budget=2 * (MB + 1), width=W, height=H,
        max_bounces=MB, tile_rows=TR, use_nee=use_nee)
    assert int(tpk.state_min_samples(st, W, H)) >= 2
    if use_nee:
        assert int(nrays) > W * H * 2 * (MB + 1)  # plus shadow segments
    else:
        assert int(nrays) == W * H * 2 * (MB + 1)


def test_padding_lanes_inert():
    """Lanes past width*height never activate (16x12 leaves most of the
    8-row tile as padding)."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    from tpu_pathtracer_torch.models import camera as tcm

    w, h = 16, 12
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                          device="cpu")
    st = tpk.init_state(w, h, tile_rows=TR, device="cpu")
    st, _ = tpk.persistent_step(scene, pack_camera(cam), (1, 2), st,
                                budget=4, width=w, height=h, max_bounces=MB,
                                tile_rows=TR)
    for f in tpk.STATE_FIELDS:
        assert (getattr(st, f).reshape(-1)[w * h:] == 0).all(), f


def test_production_mode_emitter_only(cornell_torch):
    """Philox production mode with max_bounces=0 (primary emitter hits
    only): a finite image whose mean is within 5% of the same plain version
    fed uniforms from numpy (emitter-edge pixels are Bernoulli in the
    jitter, so the means carry a few percent of sampling noise)."""
    scene, cp = cornell_torch
    kw = dict(budget=8, width=W, height=H, max_bounces=0, tile_rows=TR)
    st_p = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    st_u = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    rng = np.random.default_rng(5)
    n_tiles = st_u.lr.shape[0] // TR
    for _ in range(8):
        st_p, _ = tpk.persistent_step(scene, cp, (3, 7), st_p, **kw)
        u = rng.random((n_tiles * 8 * 5 * TR, LANES), dtype=np.float32)
        st_u, _ = tpk.persistent_step(scene, cp, (3, 7), st_u,
                                      uniforms=torch.tensor(u), **kw)
    img_p = tpk.state_image(st_p, W, H).numpy()
    img_u = tpk.state_image(st_u, W, H).numpy()
    assert np.isfinite(img_p).all() and img_p.max() > 0
    assert abs(img_p.mean() - img_u.mean()) / img_u.mean() < 0.05


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    kat = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in kat:
        got = tpk.philox4x32(torch.tensor([ctr[0]]), *ctr[1:], *key)
        assert tuple(int(g) for g in got) == want


def test_unsupported_device_is_refused():
    """A state on a non-CPU, non-CUDA device is refused, not moved."""
    scene, cs = tsc.single_sphere(device="cpu")
    st = tpk.init_state(8, 8, tile_rows=TR, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpk.persistent_step(scene, torch.zeros(24), (0, 0), st, budget=1,
                            width=8, height=8, tile_rows=TR)


def test_scattered_tiles_step_as_in_the_whole_image(cornell_torch):
    """The plain step on tiles picked from over the image (``tile_offset``
    a list of their indices) gives those tiles of the whole image's step
    bit for bit, Philox draws and rays included: lanes do not interact. A
    list of the wrong length is refused."""
    scene, cp = cornell_torch
    kw = dict(budget=6, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=True)
    whole = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    whole, _ = tpk.persistent_step(scene, cp, (4, 1), whole, **kw)
    n_tiles = whole.lr.shape[0] // TR
    picked = [n_tiles - 1, 0]

    def tiles(st):
        return dataclasses.replace(st, **{
            f: torch.cat([getattr(st, f)[t * TR:(t + 1) * TR]
                          for t in picked]) for f in tpk.STATE_FIELDS})

    got, rays = tpk.persistent_step_ref(scene, cp, (4, 1), tiles(whole),
                                        tile_offset=picked, **kw)
    want, _ = tpk.persistent_step(scene, cp, (4, 1), whole, **kw)
    rays_want = sum(
        int(tpk.persistent_step_ref(
            scene, cp, (4, 1),
            dataclasses.replace(whole, **{
                f: getattr(whole, f)[t * TR:(t + 1) * TR]
                for f in tpk.STATE_FIELDS}),
            tile_offset=t, **kw)[1]) for t in picked)
    for f in tpk.STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(tiles(want), f)), f
    assert int(rays) == rays_want
    with pytest.raises(ValueError, match="tile_offset"):
        tpk.persistent_step_ref(scene, cp, (4, 1), tiles(whole),
                                tile_offset=[0], **kw)
