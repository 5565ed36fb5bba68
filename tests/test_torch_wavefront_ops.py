"""The wavefront's math ops against the JAX package, op for op.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is rtol 1e-5 with an absolute floor of 1e-6 (2e-5 after the
divisions of the light pdfs): XLA on the CPU contracts multiply-adds into
FMAs and approximates rsqrt, and PyTorch rounds each step, so the two differ
in the last bits of a float32; a wrong formula is off by far more. Where a
formula cancels, the test says so and widens the bar to what float32 can
resolve there. Booleans, indices and selections are compared exactly, away
from their ties.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_pathtracer.models import scene as jsc  # noqa: E402
from tpu_pathtracer.ops import bsdf as jbsdf, intersect as jint  # noqa: E402
from tpu_pathtracer.ops import lights as jlights, optics as jopt  # noqa: E402
from tpu_pathtracer.ops import sampling as jsamp, texture as jtex  # noqa: E402
from tpu_pathtracer.ops import vecmath as jvm  # noqa: E402
from tpu_pathtracer_torch.models import scene as tsc  # noqa: E402
from tpu_pathtracer_torch.ops import bsdf as tbsdf, intersect as tint  # noqa: E402
from tpu_pathtracer_torch.ops import lights as tlights, optics as topt  # noqa: E402
from tpu_pathtracer_torch.ops import sampling as tsamp, texture as ttex  # noqa: E402
from tpu_pathtracer_torch.ops import vecmath as tvm  # noqa: E402

from test_torch_scene_camera import point_light_scene, scene_to_torch  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _both(a):
    return torch.tensor(a), jnp.asarray(a)


def test_vecmath_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, N, 3)).astype(np.float32)
    a[:5] = 0.0  # normalize of zero
    ta, ja = _both(a)
    tb, jb = _both(b)
    for fn in ("dot", "cross", "length", "normalize", "luminance",
               "max_component", "is_black"):
        args_t = (ta, tb) if fn in ("dot", "cross") else (ta,)
        args_j = (ja, jb) if fn in ("dot", "cross") else (ja,)
        _close(getattr(tvm, fn)(*args_t), getattr(jvm, fn)(*args_j))
    n = _unit(rng)
    tu, tv = tvm.orthonormal_basis(torch.tensor(n))
    ju, jv = jvm.orthonormal_basis(jnp.asarray(n))
    _close(tu, ju)
    _close(tv, jv)
    loc = _unit(rng)
    _close(tvm.to_world(torch.tensor(loc), torch.tensor(n)),
           jvm.to_world(jnp.asarray(loc), jnp.asarray(n)))


def test_optics_matches_jax():
    rng = np.random.default_rng(1)
    wo, n = _unit(rng), _unit(rng)
    flip = np.sum(wo * n, -1) > 0
    n[flip] = -n[flip]  # wo points toward the surface
    eta = rng.uniform(0.5, 1.8, N).astype(np.float32)
    n1 = rng.uniform(1.0, 1.6, N).astype(np.float32)
    n2 = rng.uniform(1.0, 1.6, N).astype(np.float32)
    (two, jwo), (tn, jn) = _both(wo), _both(n)
    _close(topt.reflect(two, tn), jopt.reflect(jwo, jn))
    _close(topt.refract(two, tn, torch.tensor(eta)),
           jopt.refract(jwo, jn, jnp.asarray(eta)), atol=2e-6)
    _close(topt.fresnel_reflectance(two, tn, torch.tensor(n1),
                                    torch.tensor(n2)),
           jopt.fresnel_reflectance(jwo, jn, jnp.asarray(n1),
                                    jnp.asarray(n2)))


def test_sampling_matches_jax():
    rng = np.random.default_rng(2)
    u1, u2 = rng.uniform(size=(2, N)).astype(np.float32)
    u1[0], u2[0] = 0.5, 0.5  # the disk map's degenerate centre
    (t1, j1), (t2, j2) = _both(u1), _both(u2)
    for a, b in zip(tsamp.concentric_sample_disk(t1, t2),
                    jsamp.concentric_sample_disk(j1, j2)):
        _close(a, b)
    n = _unit(rng)
    _close(tsamp.cosine_sample_hemisphere(t1, t2, torch.tensor(n)),
           jsamp.cosine_sample_hemisphere(j1, j2, jnp.asarray(n)),
           atol=2e-6)
    _close(tsamp.uniform_sample_sphere(t1, t2),
           jsamp.uniform_sample_sphere(j1, j2))
    ct = rng.uniform(0.0, 0.999, N).astype(np.float32)
    z = _unit(rng)
    tx, ty = tvm.orthonormal_basis(torch.tensor(z))
    jx, jy = jvm.orthonormal_basis(jnp.asarray(z))
    _close(tsamp.uniform_sample_cone(t1, t2, torch.tensor(ct), tx, ty,
                                     torch.tensor(z)),
           jsamp.uniform_sample_cone(j1, j2, jnp.asarray(ct), jx, jy,
                                     jnp.asarray(z)), atol=2e-6)
    _close(tsamp.uniform_cone_pdf(torch.tensor(ct)),
           jsamp.uniform_cone_pdf(jnp.asarray(ct)))
    for w in (rng.uniform(0, 3, 7).astype(np.float32), np.zeros(5, np.float32)):
        tc, tp = tsamp.make_distribution_1d(torch.tensor(w))
        jc, jp = jsamp.make_distribution_1d(jnp.asarray(w))
        _close(tc, jc)
        _close(tp, jp)
        ti, tpi = tsamp.sample_distribution_1d(tc, tp, t1)
        ji, jpi = jsamp.sample_distribution_1d(jc, jp, j1)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(tpi, jpi)
    fp, gp = rng.uniform(0, 5, (2, N)).astype(np.float32)
    fp[:3] = gp[:3] = 0.0
    _close(tsamp.power_heuristic(1.0, torch.tensor(fp), 1.0, torch.tensor(gp)),
           jsamp.power_heuristic(1.0, jnp.asarray(fp), 1.0, jnp.asarray(gp)))
    s = np.arange(N) % 9
    for spp in (9, 4, 3):
        for a, b in zip(
                tsamp.stratified_jitter_for_sample(t1, t2, torch.tensor(s % spp),
                                                   spp),
                jsamp.stratified_jitter_for_sample(j1, j2, jnp.asarray(s % spp),
                                                   spp)):
            _close(a, b)


def test_bsdf_matches_jax():
    rng = np.random.default_rng(3)
    wo, n = _unit(rng), _unit(rng)
    n[: N // 2] *= np.where(np.sum(wo * n, -1) > 0, -1, 1)[: N // 2, None]
    wi = _unit(rng)  # the first half enters from outside, the rest mixed
    mtype = (np.arange(N) % 3).astype(np.int32)
    albedo = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    coef = rng.uniform(1.0, 1.8, N).astype(np.float32)
    coef[::7] = 0.0  # padding materials
    u1, u2 = rng.uniform(size=(2, N)).astype(np.float32)
    T = {k: torch.tensor(v) for k, v in dict(
        wo=wo, n=n, wi=wi, mtype=mtype, albedo=albedo, coef=coef, u1=u1,
        u2=u2).items()}
    J = {k: jnp.asarray(v.numpy()) for k, v in T.items()}
    _close(tbsdf.f(T["mtype"], T["albedo"], T["wo"], T["wi"], T["n"]),
           jbsdf.f(J["mtype"], J["albedo"], J["wo"], J["wi"], J["n"]))
    _close(tbsdf.pdf(T["mtype"], T["wo"], T["wi"], T["n"]),
           jbsdf.pdf(J["mtype"], J["wo"], J["wi"], J["n"]))
    args = ("mtype", "albedo", "coef", "wo", "n", "u1", "u2")
    for a, b in zip(tbsdf.sample(*(T[k] for k in args)),
                    jbsdf.sample(*(J[k] for k in args))):
        _close(a, b, atol=2e-6)
    np.testing.assert_array_equal(
        tbsdf.is_specular_type(T["mtype"]).numpy(),
        np.asarray(jbsdf.is_specular_type(J["mtype"])))


def test_texture_matches_jax():
    rng = np.random.default_rng(4)
    tex = rng.uniform(0, 1, (3, 8, 16, 3)).astype(np.float32)
    tex_id = rng.integers(-1, 3, N).astype(np.int32)
    uv = rng.uniform(-2, 3, (N, 2)).astype(np.float32)  # wraps both ways
    out = ttex.sample_bilinear(torch.tensor(tex), torch.tensor(tex_id),
                               torch.tensor(uv))
    _close(out, jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(tex_id),
                                     jnp.asarray(uv)))
    assert not out.numpy()[tex_id < 0].any()


def _scene(name):
    if name == "point":
        js = point_light_scene(jsc)
    else:
        js, _ = jsc.BUILTIN_SCENES[name]()
    return js, scene_to_torch(js)


@pytest.mark.parametrize("name", ["cornell", "point", "cornell-quad",
                                  "single-sphere"])
def test_lights_match_jax(name):
    """Light selection, the light sample (sphere cone and inside-sphere,
    point, TRI_LIGHT by area) and the MIS counterweights."""
    js, ts = _scene(name)
    rng = np.random.default_rng(5)
    p = rng.uniform(-40, 40, (N, 3)).astype(np.float32) + np.float32(
        [0, 40, -20])
    if name == "cornell":
        p[:20] = np.float32([0, 579.6, -40]) + _unit(rng, 20) * 100  # inside
    u = rng.uniform(size=(N, 3)).astype(np.float32)
    for a, b in zip(tlights.light_selection_dist(ts),
                    jlights.light_selection_dist(js)):
        _close(a, b)
    tl = tlights.sample_lights(ts, torch.tensor(p), torch.tensor(u))
    jl = jlights.sample_lights(js, jnp.asarray(p), jnp.asarray(u))
    for f in ("is_delta", "valid", "index"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    assert tl.valid.any()
    _close(tl.radiance, jl.radiance, atol=2e-5)
    _close(tl.wi, jl.wi, atol=2e-5)
    # the cone sample's chord b - sqrt(b^2 - d^2 + r^2) cancels for a small
    # far light (single-sphere: r 0.5 at ~70): last-bit differences in b^2
    # move the distance by ~1e-4 of itself
    _close(tl.dist, jl.dist, rtol=1e-4, atol=2e-5)
    _close(tl.pdf, jl.pdf, rtol=2e-5, atol=2e-5)
    hit_prim = rng.integers(0, js.centers.shape[0] + 3, N).astype(np.int32)
    c = rng.uniform(-50, 50, (N, 3)).astype(np.float32)
    r = rng.uniform(0.5, 30, N).astype(np.float32)
    is_light = rng.uniform(size=N) < 0.7
    wi = _unit(rng)
    # 1 / (2 pi (1 - cos_max)) cancels for cones with cos_max near 1
    _close(tlights.light_dir_pdf(ts, *(torch.tensor(x) for x in
                                       (p, wi, c, r, is_light, hit_prim))),
           jlights.light_dir_pdf(js, *(jnp.asarray(x) for x in
                                       (p, wi, c, r, is_light, hit_prim))),
           rtol=2e-4)
    if js.has_tri_lights:
        _close(tlights.tri_sel_over_area_by_mat(ts),
               jlights.tri_sel_over_area_by_mat(js, jnp.float32))


@pytest.mark.parametrize("name", ["cornell", "cornell-boxes", "terrain"])
def test_intersect_matches_jax(name):
    """Closest hit (spheres merged with an unpacked mesh, textured albedo on
    the terrain) and the any-hit test with per-ray segments and a mask."""
    if name == "terrain":
        js, _ = jsc.terrain_textured(n=16)
        ts = scene_to_torch(js)
        o = np.random.default_rng(6).uniform(-50, 50, (N, 3)).astype(
            np.float32) + np.float32([0, 40, 0])
    else:
        js, ts = _scene(name)
        o = np.random.default_rng(6).uniform(-40, 40, (N, 3)).astype(
            np.float32) + np.float32([0, 40, -20])
    d = _unit(np.random.default_rng(7))
    th = tint.intersect(ts, tsc.prim_attrs(ts), torch.tensor(o),
                        torch.tensor(d))
    jh = jint.intersect(js, jsc.prim_attrs(js), jnp.asarray(o),
                        jnp.asarray(d))
    same = th.hit.numpy() == np.asarray(jh.hit)
    assert same.all() and th.hit.any()
    # a ray through a shared triangle edge ties: the two packages round the
    # two triangles' t differently and may keep either
    prim = th.prim.numpy() == np.asarray(jh.prim)
    assert prim.mean() >= 0.99
    assert np.all(th.prim.numpy()[~prim] >= js.centers.shape[0])
    _close(th.t.numpy()[~prim], np.asarray(jh.t)[~prim])
    for f in ("mat", "mtype"):
        np.testing.assert_array_equal(getattr(th, f).numpy()[prim],
                                      np.asarray(getattr(jh, f))[prim])
    # t = b - sqrt(det) with b ~ 1e5 on the 1e5-radius walls: f32 resolves
    # it to ulp(1e5) ~ 8e-3, whatever the rounding of each step
    for f in ("t", "p", "center"):
        _close(getattr(th, f).numpy()[prim],
               np.asarray(getattr(jh, f))[prim], atol=1e-2)
    for f in ("n", "radius", "albedo", "coef", "emission"):
        _close(getattr(th, f).numpy()[prim],
               np.asarray(getattr(jh, f))[prim], atol=2e-5)
    seg = np.random.default_rng(8).uniform(1, 200, N).astype(np.float32)
    mask = np.random.default_rng(9).uniform(size=N) < 0.8
    tp = tint.intersect_p(ts, torch.tensor(o), torch.tensor(d),
                          tmax=torch.tensor(seg), mask=torch.tensor(mask))
    jp = jint.intersect_p(js, jnp.asarray(o), jnp.asarray(d),
                          tmax=jnp.asarray(seg), mask=jnp.asarray(mask))
    # the unpacked JAX any-hit ignores the mask; the port's too
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < tp.numpy().mean() < 1


def test_intersect_packed_matches_unpacked():
    """On a packed mesh, one and two passes through packet_ref give the
    unpacked walk's hits and occlusions."""
    js, _ = jsc.terrain_textured(n=16)
    ts = scene_to_torch(js)
    rng = np.random.default_rng(10)
    o = torch.tensor(rng.uniform(-50, 50, (N, 3)).astype(np.float32)
                     + np.float32([0, 40, 0]))
    d = torch.tensor(_unit(rng))
    seg = torch.tensor(rng.uniform(1, 200, N).astype(np.float32))
    base = tint.intersect(ts, tsc.prim_attrs(ts), o, d)
    occ = tint.intersect_p(ts, o, d, tmax=seg)
    for two_pass in (False, True):
        sp = tsc.with_packet_mesh(ts, two_pass=two_pass)
        h = tint.intersect(sp, tsc.prim_attrs(sp), o, d)
        assert torch.equal(h.hit, base.hit) and torch.equal(h.mat, base.mat)
        for f in ("t", "n", "albedo"):
            torch.testing.assert_close(getattr(h, f), getattr(base, f),
                                       rtol=RTOL, atol=2e-5)
        assert torch.equal(tint.intersect_p(sp, o, d, tmax=seg), occ)
