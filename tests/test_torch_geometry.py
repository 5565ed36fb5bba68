"""Geometry gradients (``diff/geometry.py``) against JAX's and finite
differences.

* ``geometry_grads`` on the JAX geometry tests' coverage fixture (one
  emissive sphere on black, ``tests/test_geometry.py:36-57``) against JAX's
  with the same silhouette angles (JAX's per-sphere offset, passed as
  ``theta_offsets``) and the same uniforms for the image's lanes and for
  the edge lanes at (p + 1) * 0x100000, the port's stride at this size
  as at JAX's (``SegmentDraws``, a lane-offset
  form of ``TableDraws``). Both sides compute the same sums from the same
  rays, so the bar is rtol 1e-3, tighter than the FD bars below.
* ``mesh_translation_grads`` on the edge-free floor fixture
  (``tests/test_geometry.py:122-151``), the whole mesh (packed: the packet
  route) and the floor alone (``objects=(0,)``, unpacked), against JAX's
  at rtol 1e-3.
* The port's own estimators against central differences averaged over
  iterations, at JAX's bars: rtol 2e-2 on the radius and on the mesh
  translation (through ``_translate_mesh`` at delta != 0, which packs the
  translated mesh again), 5e-2 on the centre's z.
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
from tpu_pathtracer.diff import geometry as jgeo  # noqa: E402
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.models import integrator as jint  # noqa: E402
from tpu_pathtracer.utils import rng as jrng  # noqa: E402
from tpu_pathtracer_torch.diff import geometry  # noqa: E402
from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models.integrator import (  # noqa: E402
    RenderConfig, render,
)
from tpu_pathtracer_torch.utils import rng as trng  # noqa: E402

W, H = 48, 36
N_EDGE = 2048
JAX_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these files run many small ops, and under a
    parallel test run eight threads per worker oversubscribe the cores
    (a 6 s test took 280 s beside three other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SegmentDraws:
    """Given uniforms for lanes in segments: ``segments`` is a list of
    (first lane id, TableDraws whose row i is lane first + i)."""

    def __init__(self, segments):
        self.segments = segments

    def __call__(self, stream, bounce, lane_ids, n):
        lid = lane_ids.to(torch.int64)
        out = torch.full((lid.shape[0], n), float("nan"))
        for base, tab in self.segments:
            rows = tab.tables.get((int(stream), int(bounce)))
            if rows is None:
                continue
            m = (lid >= base) & (lid < base + rows.shape[0])
            out[m] = rows[lid[m] - base, :n]
        assert not torch.isnan(out).any(), "a lane outside every segment"
        return out


def _edge_draws(key, iteration, base, n, max_bounces):
    """JAX's bounce uniforms of lanes base .. base + n - 1."""
    it_key = jrng.iteration_key(key, iteration)
    lanes = jnp.arange(n, dtype=jnp.int32) + base
    return trng.TableDraws({
        (trng.BOUNCE_STREAM, b): torch.tensor(np.asarray(
            jrng.bounce_uniforms(it_key, b, lanes)))
        for b in range(max_bounces + 1)})


def _coverage(mod, **device):
    return mod.make_scene([mod.sphere([0.0, 0.0, 0.0], 8.0, 0, 0)],
                          [mod.diffuse([0.0, 0.0, 0.0])],
                          [mod.area_light(0, [5.0] * 3)], **device)


@pytest.fixture(scope="module")
def coverage():
    js = _coverage(jsc)
    jc = jcm.make_camera([0.0, 5.0, 60.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                         W, H, 45.0)
    return js, jc, scene_to_torch(js), camera_to_torch(jc), torch.tensor(
        np.random.default_rng(11).random((H, W, 3), np.float32))


def test_geometry_grads_match_jax(coverage):
    js, jc, ts, tc, wimg = coverage
    key, it, spp = jax.random.key(3), 0, 48
    jcfg = jint.RenderConfig(spp=spp, max_bounces=0)
    want = jgeo.geometry_grads(js, jc, key, jcfg, jnp.asarray(wimg.numpy()),
                               n_edge_samples=N_EDGE)
    ekey = jax.random.fold_in(jrng.iteration_key(key, it), 0x51100E77)
    offsets = torch.tensor([float(jax.random.uniform(
        jax.random.fold_in(ekey, p), ())) for p in range(ts.num_prims)])
    stride = geometry.edge_lane_stride(W * H * spp, N_EDGE)
    assert stride == 0x100000  # JAX's lane_base stride
    draws = SegmentDraws(
        [(0, jax_draws(key, it, W * H * spp, 0, False))]
        + [((p + 1) * stride, _edge_draws(key, it, (p + 1) * stride,
                                          N_EDGE, 0))
           for p in range(ts.num_prims)])
    g = geometry.geometry_grads(ts, tc, 0, RenderConfig(spp=spp,
                                                        max_bounces=0),
                                wimg, n_edge_samples=N_EDGE, draws=draws,
                                theta_offsets=offsets)
    for k in ("centers", "radii"):
        assert torch.isfinite(g[k]).all()
        np.testing.assert_allclose(g[k].numpy(), np.asarray(want[k]),
                                   rtol=JAX_RTOL, atol=1e-3, err_msg=k)
    assert float(g["radii"][0]) > 0


def _J(ts, tc, wimg, config, centers, radii, it):
    img = render(dataclasses.replace(ts, centers=centers, radii=radii), tc,
                 3, config, iteration=it)
    return float(torch.sum(img * wimg))


def test_geometry_grads_match_fd(coverage):
    """Radius (rtol 2e-2, FD over 8 iterations) and centre z (5e-2, 10)."""
    _, _, ts, tc, wimg = coverage
    config = RenderConfig(spp=48, max_bounces=0)
    g = geometry.geometry_grads(ts, tc, 3, config, wimg,
                                n_edge_samples=8192)
    h = 0.25
    fds = []
    for it in range(8):
        rp, rm = ts.radii.clone(), ts.radii.clone()
        rp[0] += h
        rm[0] -= h
        fds.append((_J(ts, tc, wimg, config, ts.centers, rp, it)
                    - _J(ts, tc, wimg, config, ts.centers, rm, it)) / (2 * h))
    fd = float(np.mean(fds))
    assert fd > 0
    np.testing.assert_allclose(float(g["radii"][0]), fd, rtol=2e-2)
    h = 0.4
    fds = []
    for it in range(10):
        cp, cm_ = ts.centers.clone(), ts.centers.clone()
        cp[0, 2] += h
        cm_[0, 2] -= h
        fds.append((_J(ts, tc, wimg, config, cp, ts.radii, it)
                    - _J(ts, tc, wimg, config, cm_, ts.radii, it)) / (2 * h))
    np.testing.assert_allclose(float(g["centers"][0, 2]),
                               float(np.mean(fds)), rtol=5e-2)


def test_wall_spheres_contribute_no_boundary():
    """The camera inside the Cornell wall spheres: no silhouette, and
    every gradient finite."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    from tpu_pathtracer_torch.models import camera as tcm

    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 32, 24,
                          cs["fov"], device="cpu")
    g = geometry.geometry_grads(scene, cam, 0,
                                RenderConfig(spp=4, max_bounces=2),
                                torch.ones((24, 32, 3)), n_edge_samples=256)
    assert torch.isfinite(g["centers"]).all()
    assert torch.isfinite(g["radii"]).all()


def _floor(with_ceiling=False):
    """The JAX tests' edge-free floor quad (and a far ceiling quad of
    material 1), lit by a point light."""
    from tpu_pathtracer.models import meshes
    from tpu_pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.quad([-40, 0, -40], [-40, 0, 40], [40, 0, 40],
                           [40, 0, -40])
    mats = [jsc.diffuse([0.8, 0.7, 0.6])]
    fm = 0
    if with_ceiling:
        v2, f2, uv2 = meshes.quad([-40, 30, -40], [40, 30, -40],
                                  [40, 30, 40], [-40, 30, 40])
        v, f = np.concatenate([v, v2]), np.concatenate([f, f2 + 4])
        uv = np.concatenate([uv, uv2])
        fm = np.array([0, 0, 1, 1], np.int32)
        mats.append(jsc.diffuse([0.3, 0.3, 0.3]))
    return jsc.make_scene([], mats,
                          [jsc.point_light([2, 6, 1], [60, 60, 60])],
                          mesh=build_bvh(v, f, uv, fm))


MESH_CASES = {"whole": (False, None, 5, 2), "floor_only": (True, (0,), 7, 4)}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_translation_matches_jax_and_fd(case):
    ceiling, objects, key, wseed = MESH_CASES[case]
    js = _floor(with_ceiling=ceiling)
    jc = jcm.make_camera([0, 5, 0.1], [0, 0, 0], [0, 0, -1], W, H, 45.0)
    spp, mb = 4, 1
    wimg = np.random.default_rng(wseed).random((H, W, 3), np.float32)
    want = np.asarray(jgeo.mesh_translation_grads(
        js, jc, jax.random.key(key),
        jint.RenderConfig(spp=spp, max_bounces=mb, use_nee=True),
        jnp.asarray(wimg), objects=objects))
    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    if objects is None:
        ts = tsc.with_packet_mesh(ts)  # the packet route
    config = RenderConfig(spp=spp, max_bounces=mb, use_nee=True)
    w = torch.tensor(wimg)
    g = geometry.mesh_translation_grads(
        ts, tc, 0, config, w, objects=objects,
        draws=jax_draws(jax.random.key(key), 0, W * H * spp, mb, True))
    assert torch.isfinite(g).all() and abs(float(g[1])) > 0.1
    np.testing.assert_allclose(g.numpy(), want, rtol=JAX_RTOL, atol=1e-3)

    # the port's own estimator on its own draws against FD
    g = geometry.mesh_translation_grads(ts, tc, key, config, w,
                                        objects=objects)
    h = 2e-2
    d = torch.tensor([0.0, h, 0.0])

    def J(delta, it):
        s = geometry._translate_mesh(ts, delta, objects)
        return float(torch.sum(render(s, tc, key, config, iteration=it)
                               * w))

    fds = [(J(d, it) - J(-d, it)) / (2 * h) for it in range(6)]
    np.testing.assert_allclose(float(g[1]), float(np.mean(fds)), rtol=2e-2)


def test_translate_mesh_keeps_the_scene_at_zero():
    """delta = 0: the same image, and the scene's own packs."""
    ts = tsc.with_packet_mesh(scene_to_torch(_floor()))
    moved = geometry._translate_mesh(ts, torch.zeros(3))
    assert moved.mesh_bvh is ts.mesh_bvh
    tc = camera_to_torch(jcm.make_camera([0, 5, 0.1], [0, 0, 0], [0, 0, -1],
                                         16, 12, 45.0))
    cfg = RenderConfig(spp=2, max_bounces=1, use_nee=True)
    assert torch.equal(render(moved, tc, 1, cfg), render(ts, tc, 1, cfg))


@pytest.mark.parametrize("lanes,n_edge,want", [
    (16 * 12 * 48, 512, 0x100000),
    (0x100000, 512, 0x100000),
    (640 * 480 * 4, 512, 0x200000),
    (64, 0x100001, 0x200000),
])
def test_edge_lanes_stay_apart(lanes, n_edge, want):
    """Sphere p's edge lanes, (p + 1) * S + i for i < n_edge, miss every
    pixel lane and every other sphere's edge lanes."""
    S = geometry.edge_lane_stride(lanes, n_edge)
    assert S == want
    assert S >= lanes and S >= n_edge
