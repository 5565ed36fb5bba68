"""Textures in the port's persistent step against the JAX package.

One JAX interpret-mode compile: the checker quad of
``tests/test_persistent.py:494-528`` (a 16x16 two-colour checker on a
20x20 quad whose material colour is not white, lit by a point light), at
16x12, budget 4, one bounce, NEE, over 2 frames. The texel MULTIPLIES the
material's colour, so a replace or a wrong tap fails per lane. The bars are
those of ``tests/test_torch_persistent.py`` (``lane_agreement``). Then,
without Pallas: the texel's four gathers against ``ops/texture.py``, the
walk's uv (``mesh_walk_ref(track_uv=True)``) against the XLA mesh traversal
of the JAX package, and the renderer on a textured terrain.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_persistent import jax_uniforms, torch_state  # noqa: E402
from test_torch_scene_camera import (  # noqa: E402
    camera_to_torch, scene_to_torch,
)
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import meshes as jmeshes  # noqa: E402
from tpu_pathtracer.models.mesh import build_bvh as jbuild_bvh  # noqa: E402
from tpu_pathtracer.ops import triangle as jtri  # noqa: E402
from tpu_pathtracer.ops.pallas import persistent as jpk  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch import PersistentRenderer, RenderConfig  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels._walk import mesh_walk_ref  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    LANES, pack_camera,
)
from tpu_pathtracer_torch.ops.texture import sample_bilinear  # noqa: E402
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, lane_agreement,
)

W, H, TR = 16, 12, 8
BUDGET, FRAMES, SEED = 4, 2, (11, 3)


def checker_quad(mod, build_bvh, meshes, **device):
    """The checker-quad scene of tests/test_persistent.py:494-528, from
    either package's builders (``device`` goes to the port's)."""
    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    mesh = build_bvh(v, f, uv, 0, **device)
    tex = meshes.checker_texture(16, tiles=4, c0=(0.9, 0.15, 0.1),
                                 c1=(0.05, 0.85, 0.9))
    return mod.make_scene(
        [], [mod.diffuse([0.7, 1.0, 0.9])],
        [mod.point_light([0.0, 8.0, 0.0], [60.0, 60.0, 60.0])],
        mesh=mesh, textures=tex, mat_texture=[0], **device)


@pytest.fixture(scope="module")
def checker():
    """The JAX kernel on the checker quad in interpret mode (FRAMES steps,
    NEE, one bounce) and the port's plain version on its uniforms."""
    js = jsc.with_packet_mesh(checker_quad(jsc, jbuild_bvh, jmeshes))
    jc = jcm.make_camera([0, 14, 9], [0, 0, 0], [0, 1, 0], W, H, 60.0)
    kw = dict(budget=BUDGET, width=W, height=H, max_bounces=1, tile_rows=TR,
              use_nee=True)
    jst = jpk.init_state(W, H, tile_rows=TR)
    jrays = []
    for f in range(FRAMES):
        jst, nr = jpk.persistent_step(js, jpack_camera(jc),
                                      jnp.asarray(SEED, jnp.int32), jst,
                                      interpret=True, **kw)
        jrays.append(int(nr))
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    assert ts.textured
    tst = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    trays = []
    for f in range(FRAMES):
        u = torch.tensor(jax_uniforms(SEED, f, tst.lr.shape[0] // TR, BUDGET,
                                      True))
        tst, nr = tpk.persistent_step(ts, pack_camera(tc), SEED, tst,
                                      uniforms=u, **kw)
        trays.append(int(nr))
    return dict(jst=jst, tst=tst, jrays=jrays, trays=trays, ts=ts, tc=tc,
                kw=kw)


def test_textured_plain_matches_jax_kernel(checker):
    """>= 98% of lanes agree on n_samp and radiance after 2 frames; the
    live-ray counts within 1%."""
    n_agree, l_agree, _ = lane_agreement(torch_state(checker["jst"]),
                                         checker["tst"], W, H)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    for rj, rt in zip(checker["jrays"], checker["trays"]):
        assert abs(rj - rt) <= 0.01 * rj, (checker["jrays"], checker["trays"])


def test_both_checker_colours_reach_the_image(checker):
    """Red-dominant and cyan-dominant pixels both show, and stripping the
    texture (the same scene untextured) changes the image: the texel
    multiplies the material colour on the quad."""
    img = tpk.state_image(checker["tst"], W, H)
    lit = img.sum(-1) > 1e-3
    red = lit & (img[..., 0] > 2 * img[..., 1])
    cyan = lit & (img[..., 1] > 2 * img[..., 0])
    assert int(red.sum()) > 0 and int(cyan.sum()) > 0, (red.sum(), cyan.sum())
    bare = dataclasses.replace(checker["ts"], textures=None)
    assert not bare.textured
    st = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    u = torch.tensor(jax_uniforms(SEED, 0, st.lr.shape[0] // TR, BUDGET,
                                  True))
    st, _ = tpk.persistent_step(bare, pack_camera(checker["tc"]), SEED, st,
                                uniforms=u, **checker["kw"])
    plain = tpk.state_image(st, W, H)
    assert not bool(((plain[..., 0] > 2 * plain[..., 1]) & lit).any())


def test_texel_matches_sample_bilinear():
    """The kernel's four gathers (y before x, the TPU kernel's index
    arithmetic) equal ops/texture.py's bilinear lookup up to rounding, on
    uv that wrap on both sides; untextured lanes are marked, and an id past
    the atlas gives a zero texel, as in the TPU kernel (whose rows past the
    atlas match none of its rows), where ops/texture.py reads the last
    texture."""
    gen = torch.Generator().manual_seed(4)
    tex = torch.rand((2, 8, 16, 3), generator=gen)
    n = 4096
    uv = torch.rand((n, 2), generator=gen) * 6.0 - 3.0
    mmat = torch.randint(0, 4, (n,), generator=gen, dtype=torch.int32)
    mc = torch.rand(n, generator=gen) < 0.8
    mat_tex = (1, -1, 0, 5)  # id 5 is past the atlas
    has, rgb = tpk.texel(tex, mat_tex, mc, mmat, uv[:, 0], uv[:, 1])
    tid = torch.tensor(mat_tex)[mmat.long()]
    want = sample_bilinear(tex, torch.where(mc, tid, -1), uv)
    assert torch.equal(has, mc & (tid >= 0))
    got = torch.stack(rgb, -1)
    inside = has & (tid < tex.shape[0])
    past = has & (tid >= tex.shape[0])
    assert bool(inside.any()) and bool(past.any())
    np.testing.assert_allclose(got[inside].numpy(), want[inside].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got[past], torch.zeros_like(got[past]))


def test_track_uv_matches_xla_walk():
    """mesh_walk_ref's uv (closest mode, track_uv) equals uv0 + u uv_e1 +
    v uv_e2 of the XLA traversal's hit on the same rays (terrain n = 16),
    wherever both find the same t; occlusion mode tracks none."""
    js, _ = jsc.terrain_textured(n=16)
    ts = tsc.with_packet_mesh(scene_to_torch(js), two_pass=False)
    rng = np.random.default_rng(2)
    n = 2 * 8 * LANES
    o = np.stack([rng.uniform(-60, 60, n), np.full(n, 40.0),
                  rng.uniform(-60, 60, n)], -1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.3, n), -np.ones(n),
                  rng.normal(0, 0.3, n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = jax.jit(lambda o, d: jtri.intersect_mesh(js.mesh, o, d, 3e-2))(
        jnp.asarray(o), jnp.asarray(d))
    jt = np.asarray(hit.t)
    found = jt < 1e29
    tri = np.asarray(hit.tri)
    juv = (np.asarray(js.mesh.uv0)[tri]
           + np.asarray(hit.u)[:, None] * np.asarray(js.mesh.uv_e1)[tri]
           + np.asarray(hit.v)[:, None] * np.asarray(js.mesh.uv_e2)[tri])
    planes = [torch.tensor(x).reshape(-1, LANES)
              for x in (*o.T, *d.T)]
    t0 = torch.full_like(planes[0], 1e30)
    t, *_, hu, hv = mesh_walk_ref(ts.mesh_packed, *planes, t0, tile_rows=8,
                                  track_uv=True)
    t = t.reshape(-1).numpy()
    same = found & (np.abs(t - jt) <= 1e-4 * np.maximum(1.0, jt))
    assert same.sum() >= 0.99 * found.sum() and found.mean() > 0.5
    got = np.stack([hu.reshape(-1).numpy(), hv.reshape(-1).numpy()], -1)
    np.testing.assert_allclose(got[same], juv[same], rtol=1e-4, atol=1e-5)
    occ = mesh_walk_ref(ts.mesh_packed, *planes, t0, tile_rows=8,
                        occlusion=True, track_uv=True)
    assert isinstance(occ, torch.Tensor)


def test_renderer_samples_textures():
    """PersistentRenderer renders a textured terrain (no refusal): finite,
    lit, and unlike the same scene with its texture stripped."""
    scene, cs = tsc.terrain_textured(n=16, device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 12,
                          cs["fov"], device="cpu")
    cfg = RenderConfig(spp=1, max_bounces=2, use_nee=True)
    imgs = []
    for s in (scene, dataclasses.replace(scene, textures=None)):
        r = PersistentRenderer(s, cam, cfg, seed=2, device="cpu", budget=4,
                               tile_rows=TR)
        r.step()
        imgs.append(r.image())
    assert torch.isfinite(imgs[0]).all() and float(imgs[0].mean()) > 0
    assert float((imgs[0] - imgs[1]).abs().max()) > 0.05
