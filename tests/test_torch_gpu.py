"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; skips without them. Imports no JAX, so it runs
on a machine without it: ``python -m pytest --noconftest
tests/test_torch_gpu.py -q`` (chip_smoke.py runs the same check at the main
path's shapes).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.models import camera as cm, scene as sc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as pk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    LANES, pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, lane_agreement,
)

W, H, TR, BUDGET, MB = 32, 24, 8, 6, 2


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("injected", [True, False])
def test_kernel_matches_plain_on_gpu(use_nee, injected):
    """Same uniforms (injected, or the shared Philox draws): >= 98% lane
    agreement, equal ray counts within 1%, and one launch per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")
    cp = pack_camera(cam)
    kw = dict(budget=BUDGET, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee)
    gen = torch.Generator(device="cuda").manual_seed(0)
    st_k = pk.init_state(W, H, tile_rows=TR, device="cuda")
    st_r = st_k.clone()
    rows = st_k.lr.shape[0] * BUDGET * pk.n_draws(use_nee)
    launches = pk.launches
    rays_k = rays_r = 0
    for _ in range(2):
        u = (torch.rand((rows, LANES), generator=gen, device="cuda")
             if injected else None)
        st_r, nr = pk.persistent_step_ref(scene, cp, (1, 2), st_r,
                                          uniforms=u, **kw)
        st_k, nk = pk.persistent_step(scene, cp, (1, 2), st_k, uniforms=u,
                                      **kw)
        rays_r, rays_k = rays_r + int(nr), rays_k + int(nk)
    assert pk.launches == launches + 2
    n_agree, l_agree, _ = lane_agreement(st_r, st_k, W, H)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    assert abs(rays_k - rays_r) <= 0.01 * rays_r


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("injected", [True, False])
def test_gradient_kernel_matches_plain_on_gpu(use_nee, injected):
    """The fused value-and-grad kernel against its plain version on the same
    uniforms: >= 98% of lanes agree on n_samp, L and every GA/GI plane; the
    kernel's phase "both" equals the cotangent fold over its own phase
    "adjoint" lanes; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import grad_lane_agreement

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tgt = rp.target_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), rows)
    u = (torch.rand((rows * BUDGET * pk.n_draws(use_nee), LANES),
                    generator=gen, device="cuda") if injected else None)
    kw = dict(spp=2, budget=BUDGET, width=W, height=H, max_bounces=MB,
              tile_rows=TR, use_nee=use_nee, uniforms=u)
    args = (scene, pack_camera(cam), (2, 5), 0, tgt)
    launches = rp.launches
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    k_both = rp.persistent_replay_call(*args, **kw)
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", **kw)
    torch.cuda.synchronize()
    assert rp.launches == launches + 2
    agree = grad_lane_agreement(r_adj[:4], k_adj[:4], W, H)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    loss, g_a, g_i = rp.mse_fold(*k_adj[:4], tgt, W, H)
    torch.testing.assert_close(k_both[2], loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(k_both[3], g_a, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(k_both[4], g_i, rtol=1e-5, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 4])
def test_gradient_kernel_at_the_adjoint_limits_on_gpu(spp):
    """A sphere scene with 16 slots and 16 lights, the gradient kernel's
    largest shared-memory block, at spp 1 (blocks drain early) and 4 (late),
    NEE, 3 bounces, the default budget, Philox draws: on n_samp, L and
    every GA/GI plane the kernel agrees with the plain version on >= 98% of
    lanes, or on as many as the plain version on the CPU agrees with itself
    on the card (chip_smoke.py's phase 7 takes the same floor at 10
    bounces), the ray counts within 1%, and phase "both" equals the
    cotangent fold over the kernel's own phase "adjoint" lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import grad_lane_agreement

    scene, cs = sc.limit_spheres(device="cuda")
    assert len(rp.material_slots(scene)[0]) == rp.MAX_SLOTS
    assert len(scene.light_structure) == rp.MAX_GRAD_LIGHTS
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    gen = torch.Generator(device="cuda").manual_seed(3)
    tgt = rp.target_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), rows)
    kw = dict(spp=spp, budget=rp.default_budget(spp, 3), width=W, height=H,
              max_bounces=3, tile_rows=TR, use_nee=True)
    args = (scene, pack_camera(cam), (4, 9), 0, tgt)
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    k_both = rp.persistent_replay_call(*args, **kw)
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", **kw)
    cpu = rp.persistent_replay_ref(scene.to("cpu"), args[1].cpu(), (4, 9), 0,
                                   tgt.cpu(), phase="adjoint", **kw)
    torch.cuda.synchronize()

    def worst(a, b):
        ag = grad_lane_agreement(a[:4], b[:4], W, H)
        return min(ag["n_samp"], ag["L"], min(ag["planes"].values()))

    bar = min(AGREE, worst(r_adj, cpu))
    assert worst(r_adj, k_adj) >= bar, (worst(r_adj, k_adj), bar)
    assert abs(int(k_adj[4]) - int(r_adj[4])) <= 0.01 * int(r_adj[4])
    loss, g_a, g_i = rp.mse_fold(*k_adj[:4], tgt, W, H)
    torch.testing.assert_close(k_both[2], loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(k_both[3], g_a, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(k_both[4], g_i, rtol=1e-5, atol=1e-9)


def _cornell_quad(w, h):
    scene, cs = sc.cornell_quad(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                         cs["fov"], device="cuda")
    return sc.with_packet_mesh(scene), pack_camera(cam)


@pytest.mark.gpu
def test_mesh_kernel_matches_plain_on_gpu():
    """cornell_quad with NEE (a pure mesh scene lit by a TRI_LIGHT quad) at
    64x48: the forward kernel's per-thread BVH walk against the plain
    version's tile walk, >= 98% lane agreement and ray counts within 1%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w, h = 64, 48
    scene, cp = _cornell_quad(w, h)
    kw = dict(budget=BUDGET, width=w, height=h, max_bounces=MB, tile_rows=TR,
              use_nee=True)
    st_k = pk.init_state(w, h, tile_rows=TR, device="cuda")
    st_r = st_k.clone()
    launches = pk.launches
    rays_k = rays_r = 0
    for _ in range(2):
        st_r, nr = pk.persistent_step_ref(scene, cp, (4, 1), st_r, **kw)
        st_k, nk = pk.persistent_step(scene, cp, (4, 1), st_k, **kw)
        rays_r, rays_k = rays_r + int(nr), rays_k + int(nk)
    assert pk.launches == launches + 2
    n_agree, l_agree, _ = lane_agreement(st_r, st_k, w, h)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    assert abs(rays_k - rays_r) <= 0.01 * rays_r
    assert float(pk.state_image(st_k, w, h).mean()) > 0.0


@pytest.mark.gpu
def test_mesh_gradient_kernel_matches_plain_on_gpu():
    """cornell_quad with NEE at 64x48: the gradient kernel's mesh-material
    and TRI_LIGHT adjoints against the plain version lane for lane, and
    phase "both" against the fold of its own phase "adjoint" lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import grad_lane_agreement

    w, h = 64, 48
    scene, cp = _cornell_quad(w, h)
    rows, _ = rp.pixel_lanes_layout(w, h, TR)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tgt = rp.target_to_lanes(
        torch.rand((h, w, 3), generator=gen, device="cuda"), rows)
    kw = dict(spp=2, budget=BUDGET, width=w, height=h, max_bounces=MB,
              tile_rows=TR, use_nee=True)
    args = (scene, cp, (3, 8), 0, tgt)
    launches = rp.launches
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    k_both = rp.persistent_replay_call(*args, **kw)
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", **kw)
    torch.cuda.synchronize()
    assert rp.launches == launches + 2
    agree = grad_lane_agreement(r_adj[:4], k_adj[:4], w, h)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    assert float(k_adj[3].abs().max()) > 0.0  # the TRI_LIGHT's adjoint
    loss, g_a, g_i = rp.mse_fold(*k_adj[:4], tgt, w, h)
    torch.testing.assert_close(k_both[2], loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(k_both[3], g_a, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(k_both[4], g_i, rtol=1e-5, atol=1e-9)


LENS = dict(lens_radius=4.0, focal_distance=60.0)


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("injected", [True, False])
def test_dof_kernel_matches_plain_on_gpu(use_nee, injected):
    """The forward kernel with a thin lens (7 or 10 draws) against its plain
    version on the same uniforms: >= 98% lane agreement, ray counts within
    1%, and a lens image unlike the pinhole one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda", **LENS)
    cp = pack_camera(cam)
    kw = dict(budget=BUDGET, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee, use_dof=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    st_k = pk.init_state(W, H, tile_rows=TR, device="cuda")
    st_r = st_k.clone()
    rows = st_k.lr.shape[0] * BUDGET * pk.n_draws(use_nee, True)
    rays_k = rays_r = 0
    for _ in range(2):
        u = (torch.rand((rows, LANES), generator=gen, device="cuda")
             if injected else None)
        st_r, nr = pk.persistent_step_ref(scene, cp, (1, 2), st_r,
                                          uniforms=u, **kw)
        st_k, nk = pk.persistent_step(scene, cp, (1, 2), st_k, uniforms=u,
                                      **kw)
        rays_r, rays_k = rays_r + int(nr), rays_k + int(nk)
    n_agree, l_agree, _ = lane_agreement(st_r, st_k, W, H)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    assert abs(rays_k - rays_r) <= 0.01 * rays_r
    st_p = pk.init_state(W, H, tile_rows=TR, device="cuda")
    st_p, _ = pk.persistent_step(scene, cp, (1, 2), st_p,
                                 **dict(kw, use_dof=False))
    assert float((pk.state_image(st_p, W, H)
                  - pk.state_image(st_k, W, H)).abs().max()) > 0.05


@pytest.mark.gpu
def test_textured_kernel_matches_plain_on_gpu():
    """The checker quad of the JAX suite at 64x48 with NEE: the textured
    build (uv tracked in the walk, four taps per textured hit) against the
    plain version's gathers, >= 98% lane agreement, both tiles shown."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    scene = sc.with_packet_mesh(sc.make_scene(
        [], [sc.diffuse([0.7, 1.0, 0.9])],
        [sc.point_light([0.0, 8.0, 0.0], [60.0, 60.0, 60.0])],
        mesh=build_bvh(v, f, uv, 0, device="cuda"),
        textures=meshes.checker_texture(16, tiles=4, c0=(0.9, 0.15, 0.1),
                                        c1=(0.05, 0.85, 0.9)),
        mat_texture=[0], device="cuda"))
    w, h = 64, 48
    cam = cm.make_camera([0, 14, 9], [0, 0, 0], [0, 1, 0], w, h, 60.0,
                         device="cuda")
    cp = pack_camera(cam)
    kw = dict(budget=BUDGET, width=w, height=h, max_bounces=1, tile_rows=TR,
              use_nee=True)
    st_k = pk.init_state(w, h, tile_rows=TR, device="cuda")
    st_r = st_k.clone()
    for _ in range(2):
        st_r, _ = pk.persistent_step_ref(scene, cp, (6, 1), st_r, **kw)
        st_k, _ = pk.persistent_step(scene, cp, (6, 1), st_k, **kw)
    n_agree, l_agree, _ = lane_agreement(st_r, st_k, w, h)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    img = pk.state_image(st_k, w, h)
    lit = img.sum(-1) > 1e-3
    assert bool((lit & (img[..., 0] > 2 * img[..., 1])).any())
    assert bool((lit & (img[..., 1] > 2 * img[..., 0])).any())


@pytest.mark.gpu
def test_quad_diagonal_tie_on_gpu():
    """Rays straight down onto the shared diagonal of a quad whose two
    triangles carry a red and a green material hit both triangles at the
    same t (exact arithmetic here, in both versions): the forward kernel's
    walk and its plain version give the hit to the lower triangle index
    (the tie rule), so after one iteration every lane's throughput is that
    triangle's colour in both, with the same normal (the same bounce)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    mesh = build_bvh(v, f, uv, np.array([0, 1]), device="cuda")
    colours = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]]
    scene = sc.with_packet_mesh(sc.make_scene(
        [], [sc.diffuse(c) for c in colours],
        [sc.point_light([0.0, 8.0, 0.0], [60.0, 60.0, 60.0])], mesh=mesh,
        device="cuda"))
    w, h = 128, 8
    cam = cm.make_camera([0, 14, 9], [0, 0, 0], [0, 1, 0], w, h, 60.0,
                         device="cuda")
    st = pk.init_state(w, h, tile_rows=TR, device="cuda")
    # lane i: from (s, 10, s) straight down, s = (i - 512) / 64, exact
    s_ = (torch.arange(st.lr.numel(), device="cuda", dtype=torch.float32)
          .reshape(st.lr.shape) - 512.0) / 64.0
    for name, val in (("ox", s_), ("oy", 10.0), ("oz", s_), ("dy", -1.0),
                      ("tr", 1.0), ("tg", 1.0), ("tb", 1.0),
                      ("prev_pdf", 1.0)):
        getattr(st, name)[:] = val
    st.alive[:] = 1
    st.prev_delta[:] = 1
    kw = dict(budget=1, width=w, height=h, max_bounces=4, tile_rows=TR)
    u = torch.rand((st.lr.shape[0] * pk.n_draws(False), LANES),
                   generator=torch.Generator(device="cuda").manual_seed(3),
                   device="cuda")
    st_r, _ = pk.persistent_step_ref(scene, pack_camera(cam), (1, 1),
                                     st.clone(), uniforms=u, **kw)
    st_k, _ = pk.persistent_step(scene, pack_camera(cam), (1, 1),
                                 st.clone(), uniforms=u, **kw)
    want = torch.tensor(colours[int(mesh.material_id[0])], device="cuda")
    for got in (st_r, st_k):
        thr = torch.stack([got.tr, got.tg, got.tb], -1).reshape(-1, 3)
        torch.testing.assert_close(thr, want.expand_as(thr), rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(got.oy, torch.zeros_like(got.oy))
    for name in ("ox", "oz", "dx", "dy", "dz"):
        torch.testing.assert_close(getattr(st_k, name), getattr(st_r, name),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_texture_id_past_the_atlas_is_black_on_gpu():
    """A material whose texture id is past the atlas takes a zero texel in
    the kernel and in its plain version, as in the TPU kernel: the quad lit
    by a point light renders black, and the two agree lane for lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    scene = sc.with_packet_mesh(sc.make_scene(
        [], [sc.diffuse([0.7, 1.0, 0.9])],
        [sc.point_light([0.0, 8.0, 0.0], [60.0, 60.0, 60.0])],
        mesh=build_bvh(v, f, uv, 0, device="cuda"),
        textures=meshes.checker_texture(16, tiles=4), mat_texture=[1],
        device="cuda"))
    w, h = 64, 48
    cam = cm.make_camera([0, 14, 9], [0, 0, 0], [0, 1, 0], w, h, 60.0,
                         device="cuda")
    cp = pack_camera(cam)
    kw = dict(budget=BUDGET, width=w, height=h, max_bounces=1, tile_rows=TR,
              use_nee=True)
    st_k = pk.init_state(w, h, tile_rows=TR, device="cuda")
    st_r = st_k.clone()
    st_r, _ = pk.persistent_step_ref(scene, cp, (6, 1), st_r, **kw)
    st_k, _ = pk.persistent_step(scene, cp, (6, 1), st_k, **kw)
    n_agree, l_agree, _ = lane_agreement(st_r, st_k, w, h)
    assert n_agree >= AGREE and l_agree >= AGREE, (n_agree, l_agree)
    assert int(st_k.n_samp.sum()) > 0
    assert float(pk.state_image(st_k, w, h).abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
def test_dof_gradient_kernel_matches_plain_on_gpu(use_nee):
    """The gradient kernel with the thin lens against its plain version on
    the same uniforms, lane for lane, and phase "both" against the fold of
    its own phase "adjoint" lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import grad_lane_agreement

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda", **LENS)
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    gen = torch.Generator(device="cuda").manual_seed(4)
    tgt = rp.target_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), rows)
    u = torch.rand((rows * BUDGET * pk.n_draws(use_nee, True), LANES),
                   generator=gen, device="cuda")
    kw = dict(spp=2, budget=BUDGET, width=W, height=H, max_bounces=MB,
              tile_rows=TR, use_nee=use_nee, use_dof=True, uniforms=u)
    args = (scene, pack_camera(cam), (3, 8), 0, tgt)
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    k_both = rp.persistent_replay_call(*args, **kw)
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", **kw)
    torch.cuda.synchronize()
    agree = grad_lane_agreement(r_adj[:4], k_adj[:4], W, H)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    loss, g_a, g_i = rp.mse_fold(*k_adj[:4], tgt, W, H)
    torch.testing.assert_close(k_both[2], loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(k_both[3], g_a, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(k_both[4], g_i, rtol=1e-5, atol=1e-9)


def _tex_scene(device):
    """The JAX suite's tex_scene (tests/test_replay_persistent.py:951-976):
    a checker-textured quad floor, a diffuse sphere, a sphere area light
    and a point light, packed, and its camera's eye, target and fov."""
    from tpu_pathtracer_torch.models import meshes
    from tpu_pathtracer_torch.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    scene = sc.make_scene(
        [sc.sphere([0, 2, 0], 1.0, 1), sc.sphere([2, 2.5, 0], 1.5, 2,
                                                 light=1)],
        [sc.diffuse([0.7, 1.0, 0.9]), sc.diffuse([0.8, 0.4, 0.3]),
         sc.diffuse([0.05, 0.05, 0.05])],
        [sc.point_light([0.0, 8.0, 3.0], [60.0, 60.0, 60.0]),
         sc.area_light(1, [40.0, 40.0, 40.0])],
        mesh=build_bvh(v, f, uv, 0, device=device),
        textures=meshes.checker_texture(8, tiles=2, c0=(0.9, 0.2, 0.15),
                                        c1=(0.1, 0.8, 0.85)),
        mat_texture=[0, -1, -1], device=device)
    return sc.with_packet_mesh(scene), ([0, 10, 9], [0, 0, 0], 60.0)


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
def test_textured_gradient_kernel_matches_plain_on_gpu(use_nee):
    """Kernel 3 on a textured scene: launch 1 (TEX, C_tot records) against
    the plain version on >= 98% of lanes, the C_tot planes included; the
    scatter walk replays launch 1's radiance and counts bit for bit; with the
    same cotangent, zeroed where the lanes disagree, the kernel's atlas
    gradient is within ATLAS_RTOL of the plain one; phase "both" is two
    launches, one of them a scatter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import (
        ATLAS_RTOL, atlas_gap, grad_lane_agreement,
    )

    scene, (eye, at, fov) = _tex_scene("cuda")
    cam = cm.make_camera(eye, at, [0, 1, 0], W, H, fov, device="cuda")
    rows, _ = rp.pixel_lanes_layout(W, H, TR)
    gen = torch.Generator(device="cuda").manual_seed(6)
    tgt = rp.target_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), rows)
    u = torch.rand((rows * BUDGET * pk.n_draws(use_nee), LANES),
                   generator=gen, device="cuda")
    kw = dict(spp=2, budget=BUDGET, width=W, height=H, max_bounces=MB,
              tile_rows=TR, use_nee=use_nee, uniforms=u)
    args = (scene, pack_camera(cam), (3, 9), 0, tgt)
    k_adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    r_adj = rp.persistent_replay_ref(*args, phase="adjoint", **kw)
    launches, scatters = rp.launches, rp.scatter_launches
    k_both = rp.persistent_replay_call(*args, **kw)
    torch.cuda.synchronize()
    assert (rp.launches - launches, rp.scatter_launches - scatters) == (2, 1)
    agree = grad_lane_agreement((*r_adj[:4], r_adj[5]),
                                (*k_adj[:4], k_adj[5]), W, H)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    g = rp.lane_cotangent(k_adj[0], k_adj[1], tgt, W, H)
    L2, n2, _, gT = rp.scatter_walk(*args, g, k_adj[5], k_adj[1], **kw)
    assert torch.equal(L2, k_adj[0]) and torch.equal(n2, k_adj[1])
    assert k_both[6].shape == scene.textures.shape
    g = g * agree["mask"].to("cuda")
    gk = rp.scatter_walk(*args, g, k_adj[5], k_adj[1], **kw)[3]
    gr = rp.scatter_walk(*args, g, r_adj[5], r_adj[1], **kw)[3]
    assert float(gr.abs().max()) > 0
    assert atlas_gap(gk, gr) <= ATLAS_RTOL


@pytest.mark.gpu
def test_scatter_atomics_within_bound_on_gpu():
    """Two scatter launches on the same inputs add in different orders:
    every cell agrees within ATOMIC_RTOL of the cell's sum of |terms| (the
    scatter of |g|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import ATOMIC_RTOL

    scene, (eye, at, fov) = _tex_scene("cuda")
    w, h = 160, 120
    cam = cm.make_camera(eye, at, [0, 1, 0], w, h, fov, device="cuda")
    rows, _ = rp.pixel_lanes_layout(w, h, TR)
    tgt = rp.target_to_lanes(torch.rand((h, w, 3), device="cuda"), rows)
    kw = dict(spp=4, budget=20, width=w, height=h, tile_rows=TR,
              use_nee=True)
    args = (scene, pack_camera(cam), (8, 1), 0, tgt)
    adj = rp.persistent_replay_call(*args, phase="adjoint", **kw)
    g = rp.lane_cotangent(adj[0], adj[1], tgt, w, h)
    a, b, s = (rp.scatter_walk(*args, x, adj[5], adj[1], **kw)[3]
               for x in (g, g, g.abs()))
    assert float(s.abs().max()) > 0
    assert bool(((a - b).abs() <= ATOMIC_RTOL * s).all())


@pytest.mark.gpu
def test_chunked_driver_matches_plain_on_gpu():
    """spp 33 on a textured scene goes to the chunked driver (32 + 1): the
    kernel's loss and gradients against the plain version's on the same
    Philox draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp

    scene, (eye, at, fov) = _tex_scene("cuda")
    cam = cm.make_camera(eye, at, [0, 1, 0], W, H, fov, device="cuda")
    target = torch.rand((H, W, 3), device="cuda")
    kw = dict(spp=33, budget=12, max_bounces=MB, tile_rows=TR, use_nee=True)
    launches = rp.launches
    k = rp.persistent_mse_value_and_grad(scene, cam, (2, 5), 1, target, **kw)
    assert rp.launches - launches == 4  # two chunks, two launches each
    call = rp.persistent_replay_call
    rp.persistent_replay_call = rp.persistent_replay_ref
    try:
        r = rp.persistent_mse_value_and_grad(scene, cam, (2, 5), 1, target,
                                             **kw)
    finally:
        rp.persistent_replay_call = call
    torch.testing.assert_close(k[0], r[0], rtol=1e-4, atol=0)
    for name in ("mat_color", "light_intensity", "textures"):
        scale = float(r[1][name].abs().max())
        torch.testing.assert_close(k[1][name], r[1][name], rtol=2e-3,
                                   atol=2e-3 * scale, msg=name)


def _position_rows(device):
    """d pack_camera / d pos: the three camera-position tangents."""
    rows = torch.zeros((3, 24), device=device)
    rows[0, 9] = rows[1, 10] = rows[2, 11] = 1.0
    return rows


def _jvp_case(name, w, h, use_nee, injected, seed):
    """Kernel and plain version of one tangent walk on the same uniforms:
    the camera position's three tangents and every transmissive material's
    IOR."""
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj

    scene, cs = sc.BUILTIN_SCENES[name](device="cuda")
    scene = sc.with_packet_mesh(scene)
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device="cuda")
    rows = -(-(w * h) // (TR * LANES)) * TR
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = (torch.rand((rows * BUDGET * pk.n_draws(use_nee), LANES),
                    generator=gen, device="cuda") if injected else None)
    kw = dict(spp=2, budget=BUDGET, width=w, height=h, max_bounces=MB,
              tile_rows=TR, use_nee=use_nee,
              coef_mats=cj.transmissive_mats(scene), uniforms=u)
    args = (scene, pack_camera(cam), _position_rows("cuda"), (seed, 3), 1)
    launches = cj.launches
    k = cj.camera_jvp_call(*args, **kw)
    r = cj.camera_jvp_ref(*args, **kw)
    torch.cuda.synchronize()
    return k, r, cj.launches - launches


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("injected", [True, False])
def test_camera_jvp_kernel_matches_plain_on_gpu(use_nee, injected):
    """cornell_spheres at 32x24, three position tangents and the glass
    ball's IOR in one launch: >= 98% of lanes agree on n_samp, L and every
    dL plane, ray counts within 1%, everything finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.utils.metrics import tangent_lane_agreement

    k, r, n = _jvp_case("cornell", W, H, use_nee, injected, 6)
    assert n == 1
    agree = tangent_lane_agreement((r[0], r[1], r[2]), (k[0], k[1], k[2]),
                                   W, H)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    assert abs(int(k[3]) - int(r[3])) <= 0.01 * int(r[3])
    assert all(bool(torch.isfinite(x).all()) for x in k[:2])
    if use_nee:  # brute force seldom reaches the light through the glass
        assert float(k[1][3].abs().max()) > 1e-3  # the IOR tangent


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell-glass", "cornell-quad"])
def test_camera_jvp_mesh_kernel_matches_plain_on_gpu(name):
    """Mesh scenes with NEE at 64x48: the glass ball inside mesh walls
    (position and IOR tangents), and the TRI_LIGHT quad scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.utils.metrics import tangent_lane_agreement

    k, r, n = _jvp_case(name, 64, 48, True, False, 8)
    agree = tangent_lane_agreement((r[0], r[1], r[2]), (k[0], k[1], k[2]),
                                   64, 48)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    assert abs(int(k[3]) - int(r[3])) <= 0.01 * int(r[3])


@pytest.mark.gpu
def test_camera_jvp_chunks_on_gpu():
    """Tangents beyond four go to further launches on the same seed: four
    in one launch equal two launches of two, and the fifth of five equals
    its own launch, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = torch.randn((4, 24), generator=gen, device="cuda")
    kw = dict(spp=2, budget=BUDGET, width=W, height=H, max_bounces=MB,
              tile_rows=TR, use_nee=True)
    args = (scene, pack_camera(cam))
    launches = cj.launches
    four = cj.camera_jvp_call(*args, rows, (2, 2), 0, **kw)
    halves = [cj.camera_jvp_call(*args, rows[i:i + 2], (2, 2), 0, **kw)
              for i in (0, 2)]
    five = cj.camera_jvp_call(*args, rows, (2, 2), 0,
                              coef_mats=cj.transmissive_mats(scene), **kw)
    alone = cj.camera_jvp_call(*args, rows[:0], (2, 2), 0,
                               coef_mats=cj.transmissive_mats(scene), **kw)
    torch.cuda.synchronize()
    assert cj.launches == launches + 1 + 2 + 2 + 1
    for h in halves + [five, alone]:
        assert torch.equal(h[0], four[0]) and torch.equal(h[2], four[2])
        assert int(h[3]) == int(four[3])
    assert torch.equal(torch.cat([halves[0][1], halves[1][1]]), four[1])
    assert torch.equal(five[1][:4], four[1])
    assert torch.equal(five[1][4], alone[1][0])


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [3, 60])
@pytest.mark.parametrize("n_tan", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["cornell", "cornell-glass"])
def test_camera_jvp_drain_on_gpu(name, n_tan, budget):
    """Kernel 4's drained warps and its sums in shared memory at T = 1..4,
    on spheres and on a mesh: n_tan - 1 camera-position tangents beside the
    glass's IOR (the score state's path), a budget too short to drain
    (spp 2 needs at least 2 iterations per pixel) and one far too long, held
    to camera_jvp_ref at the tangent bar: >= 98% of lanes on n_samp, L and
    every dL plane, rays within 1%; with the long budget every pixel has
    its spp paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import camera_jvp as cj
    from tpu_pathtracer_torch.utils.metrics import tangent_lane_agreement

    scene, cs = sc.BUILTIN_SCENES[name](device="cuda")
    scene = sc.with_packet_mesh(scene)
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                         device="cuda")
    glass = cj.transmissive_mats(scene)[:1]
    assert glass
    kw = dict(spp=2, budget=budget, width=W, height=H, max_bounces=MB,
              tile_rows=TR, use_nee=True, coef_mats=glass)
    args = (scene, pack_camera(cam), _position_rows("cuda")[:n_tan - 1],
            (11, n_tan), 2)
    launches = cj.launches
    k = cj.camera_jvp_call(*args, **kw)
    r = cj.camera_jvp_ref(*args, **kw)
    torch.cuda.synchronize()
    assert cj.launches == launches + 1 and k[1].shape[0] == n_tan
    agree = tangent_lane_agreement(r[:3], k[:3], W, H)
    assert agree["n_samp"] >= AGREE and agree["L"] >= AGREE, agree
    assert min(agree["planes"].values()) >= AGREE, agree
    assert abs(int(k[3]) - int(r[3])) <= 0.01 * int(r[3])
    assert all(bool(torch.isfinite(x).all()) for x in k[:2])
    if budget > 2 * (MB + 1):
        assert bool((k[2].reshape(-1)[:W * H] == 2).all())


@pytest.mark.gpu
@pytest.mark.parametrize("spp,use_nee,injected", [(1, False, False),
                                                  (4, True, True),
                                                  (4, True, False),
                                                  (64, True, False)])
def test_trace_kernel_takes_items_on_gpu(spp, use_nee, injected,
                                         monkeypatch):
    """Kernel 8's threads take (pixel, sample) items one after another: at
    29x17 (n_lanes not a multiple of 128) against trace_lanes_ref at its
    bar (>= 98% of lanes, rays within 1%), the padding lanes zero; on a
    grid cut to 1 or 2 blocks, so that each thread walks many items, the
    same radiance and ray count as on the resident grid, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk
    from tpu_pathtracer_torch.utils.metrics import sample_lane_agreement

    w, h = 29, 17
    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                         cs["fov"], device="cuda")
    rows, n = tk.lanes_layout(w, h, spp, TR)
    assert n % LANES
    gen = torch.Generator(device="cuda").manual_seed(spp)
    u = (torch.rand((rows * tk.sample_n_draws(MB, use_nee), LANES),
                    generator=gen, device="cuda") if injected else None)
    kw = dict(spp=spp, width=w, height=h, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee, uniforms=u)
    cp = pack_camera(cam)
    Lk, nk = tk.trace_lanes(scene, cp, (3, 1, 2), **kw)
    Lr, nr = tk.trace_lanes_ref(scene, cp, (3, 1, 2), **kw)
    assert sample_lane_agreement(Lk, Lr, n)[0] >= AGREE
    assert abs(int(nk) - int(nr)) <= 0.01 * int(nr)
    assert nk.dtype == torch.int64
    assert not bool(Lk.reshape(-1, 3)[n:].any())
    for blocks in (1, 2):
        monkeypatch.setattr(tk, "_trace_grid", lambda index, b=blocks: b)
        Lb, nb = tk.trace_lanes(scene, cp, (3, 1, 2), **kw)
        assert int(nb) == int(nk) and torch.equal(Lb, Lk), blocks


def _terrain_rays(n, seed):
    """A small terrain packed two-pass, and n rays at it from above with
    random t_init (an eighth dead)."""
    scene, _ = sc.terrain_textured(n=40, device="cuda")
    scene = sc.with_packet_mesh(scene, coarse_leaf=128)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    o = (torch.rand((n, 3), generator=gen, device="cuda") - 0.5) * 100
    o[:, 1] += 40
    d = torch.randn((n, 3), generator=gen, device="cuda")
    d[:, 1] -= 1.0
    d = d / d.norm(dim=-1, keepdim=True)
    t0 = torch.rand(n, generator=gen, device="cuda") * 150 + 5
    t0[: n // 8] = 0.0
    return scene, o, d, t0


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_packet_kernel_matches_plain_on_gpu(any_hit):
    """Kernel 5 against its plain version packet_bvh_ref on the same rays:
    t, triangle, normal, uv and material bit for bit (both walk pack_bvh's
    tree and are built to round alike), one launch per call; and against
    packet_ref on the 64-leaf tree, by triangle id, at packet_agreement's
    bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk
    from tpu_pathtracer_torch.utils.metrics import packet_agreement

    scene, o, d, t0 = _terrain_rays(20_000, 3)
    pm, bvh = scene.mesh_packed, scene.mesh_bvh
    launches = mk.packet_launches
    got = mk.packet_query(pm, o, d, t0, 3e-2, any_hit, bvh=bvh)
    torch.cuda.synchronize()
    assert mk.packet_launches == launches + 1
    want = mk.packet_bvh_ref(bvh, o, d, t0, 3e-2, any_hit)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    hit = got[0] < t0
    assert 0.05 < float(hit.float().mean()) < 0.95
    r = list(mk.packet_ref(pm, o, d, t0, 3e-2, any_hit))
    r[1] = torch.where(r[0] < torch.where(t0 > 0, t0, 0.0),
                       pm.remap[r[1].long()], 0)
    out = packet_agreement(got, r, t0, any_hit)
    assert out["ok"], out


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_packet_kernel_permuted_launch_on_gpu(any_hit):
    """A launch that reads and writes through a permutation equals, at the
    permuted positions, a launch on the rays permuted beforehand, bit for
    bit; the sorted query equals the unsorted one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    scene, o, d, t0 = _terrain_rays(20_000, 6)
    pm, bvh = scene.mesh_packed, scene.mesh_bvh
    gen = torch.Generator(device="cuda").manual_seed(7)
    perm = torch.randperm(o.shape[0], generator=gen, device="cuda")
    through = mk.packet_query(pm, o, d, t0, 3e-2, any_hit, bvh=bvh,
                              perm=perm.to(torch.int32))
    before = mk.packet_query(pm, o[perm].contiguous(), d[perm].contiguous(),
                             t0[perm], 3e-2, any_hit, bvh=bvh)
    for a, b in zip(through, before):
        assert torch.equal(a[perm], b)
    srt = mk.intersect_mesh_packet(pm, o, d, 3e-2, t_init=t0, any_hit=any_hit,
                                   bvh=bvh)
    uns = mk.intersect_mesh_packet(pm, o, d, 3e-2, t_init=t0, any_hit=any_hit,
                                   sort=False, bvh=bvh)
    for f in ("t", "tri", "n", "uv", "mat"):
        assert torch.equal(getattr(srt, f), getattr(uns, f)), f


@pytest.mark.gpu
def test_packet_kernel_needs_the_tree_on_gpu():
    """On the card the query raises without pack_bvh's tree: no fallback to
    the 64-leaf walk or to the plain version, and no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    scene, o, d, t0 = _terrain_rays(256, 8)
    p0, b0 = mk.packet_launches, mk.bin_launches
    with pytest.raises(ValueError, match="mesh_bvh"):
        mk.packet_query(scene.mesh_packed, o, d, t0, 3e-2)
    with pytest.raises(ValueError, match="mesh_bvh"):
        mk.intersect_mesh_packet(scene.mesh_packed, o, d, 3e-2, t_init=t0,
                                 coarse=scene.mesh_packed_coarse)
    assert (mk.packet_launches, mk.bin_launches) == (p0, b0)


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["small", "large"])
def test_bin_kernel_matches_plain_on_gpu(table):
    """Kernel 6 against both plain versions, bin_rays_ref (the sweep) and
    bin_tree_ref (the walk), with bin_sort_key: cells, entry distances and
    the sort key bit for bit, one launch per call, on a coarse tree of 63
    nodes and on one of 4,095 (its walk table past 48 KB of shared
    memory); the two-pass query equals the single-pass one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    scene, o, d, t0 = _terrain_rays(20_000, 4)
    coarse = scene.mesh_packed_coarse
    if table == "large":
        big, _ = sc.terrain_textured(n=64, device="cuda")
        coarse = mk.pack_mesh(big.mesh, collapse_leaf=4, nodes_only=True)
        assert mk.bin_smem_bytes(coarse.num_nodes) > 48 * 1024
        o = o * (coarse.nodes[0, 3] - coarse.nodes[0, 0]) / 100
    launches = mk.bin_launches
    got = mk.bin_rays(coarse, o, d, t0, 3e-2)
    torch.cuda.synchronize()
    assert mk.bin_launches == launches + 1
    cell = got[0]
    for ref in (mk.bin_rays_ref, mk.bin_tree_ref):
        c, tn = ref(coarse, o, d, t0, 3e-2)
        want = (c, tn, mk.bin_sort_key(c, tn, d, coarse.key_scale))
        for g, w in zip(got, want):
            assert torch.equal(g, w), ref.__name__
    assert 0.05 < float((cell >= 0).float().mean()) < 0.95
    if table == "large":
        return
    one = mk.intersect_mesh_packet(scene.mesh_packed, o, d, 3e-2, t_init=t0,
                                   bvh=scene.mesh_bvh)
    two = mk.intersect_mesh_packet(scene.mesh_packed, o, d, 3e-2, t_init=t0,
                                   coarse=coarse, bvh=scene.mesh_bvh)
    for f in ("t", "tri", "n", "uv", "mat"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f


@pytest.mark.gpu
def test_unpacked_mesh_walk_refuses_cuda():
    """On the card every mesh query goes through kernel 5: the per-lane
    walk of an unpacked mesh raises for CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.triangle import intersect_mesh

    scene, o, d, _ = _terrain_rays(64, 5)
    with pytest.raises(ValueError, match="CPU tensors only"):
        intersect_mesh(scene.mesh, o, d, tmin=3e-2)


@pytest.mark.gpu
def test_wavefront_renders_through_the_kernels_on_gpu():
    """ProgressiveRenderer on the textured terrain (n = 40) at 64x48, 2 spp,
    3 bounces, NEE: it packs the mesh two-pass itself, each frame launches
    kernels 5 and 6 once per wave (4 closest-hit and 4 shadow waves), and
    the image is finite and textured."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.models.progressive import ProgressiveRenderer
    from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk

    scene, cs = sc.terrain_textured(n=40, device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 64, 48,
                         cs["fov"], device="cuda")
    r = ProgressiveRenderer(scene, cam, RenderConfig(spp=2, max_bounces=3,
                                                     use_nee=True),
                            device="cuda")
    assert r.scene.mesh_packed_coarse is not None
    p0, b0 = mk.packet_launches, mk.bin_launches
    r.step()
    r.step()
    torch.cuda.synchronize()
    assert mk.packet_launches - p0 == 16 and mk.bin_launches - b0 == 16
    img = r.image()
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("injected", [True, False])
def test_trace_kernel_matches_plain_on_gpu(use_nee, injected):
    """The per-sample forward kernel (kernel 8) against trace_lanes_ref on
    the same uniforms: >= 98% of lanes, rays within 1%, one launch per
    render, a render that replays bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import trace_kernel as tk
    from tpu_pathtracer_torch.utils.metrics import sample_lane_agreement

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")
    rows, n = tk.lanes_layout(W, H, 4, TR)
    gen = torch.Generator(device="cuda").manual_seed(8)
    u = (torch.rand((rows * tk.sample_n_draws(MB, use_nee), LANES),
                    generator=gen, device="cuda") if injected else None)
    kw = dict(spp=4, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee, uniforms=u)
    launches = tk.launches
    Lk, nk = tk.trace_lanes(scene, pack_camera(cam), (3, 1, 2), **kw)
    Lk2, _ = tk.trace_lanes(scene, pack_camera(cam), (3, 1, 2), **kw)
    Lr, nr = tk.trace_lanes_ref(scene, pack_camera(cam), (3, 1, 2), **kw)
    assert tk.launches == launches + 2 and torch.equal(Lk, Lk2)
    assert sample_lane_agreement(Lk, Lr, n)[0] >= AGREE
    assert abs(int(nk) - int(nr)) <= 0.01 * int(nr)


@pytest.mark.gpu
@pytest.mark.parametrize("spp,use_nee,lens", [(4, False, False),
                                              (4, True, True),
                                              (16, True, False),
                                              (64, False, False)])
def test_replay_kernel_matches_plain_on_gpu(spp, use_nee, lens):
    """The per-sample value-and-grad kernel (kernel 7) against
    replay_call_ref on Philox draws, through the warp-shuffle (spp <= 32)
    and shared-memory pixel means: >= 98% of lanes, rays within 1%; mode
    "mse" equals mode "vjp" on its own lanes' cotangent; a launch replays
    bit for bit; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.utils.metrics import sample_lane_agreement

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda",
                         **(dict(lens_radius=4.0, focal_distance=60.0)
                            if lens else {}))
    cp = pack_camera(cam)
    rows, n = rk.lanes_layout(W, H, spp, TR)
    gen = torch.Generator(device="cuda").manual_seed(9)
    tgt = rk.broadcast_pixels_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), spp, rows)
    kw = dict(spp=spp, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee, use_dof=lens)
    launches = rk.launches
    k = rk.replay_call(scene, cp, (2, 5), 1, tgt, **kw)
    k2 = rk.replay_call(scene, cp, (2, 5), 1, tgt, **kw)
    r = rk.replay_call_ref(scene, cp, (2, 5), 1, tgt, **kw)
    g = rk.lane_cotangent(k[0], tgt, spp, W, H)
    kv = rk.replay_call(scene, cp, (2, 5), 1, g, mode="vjp", **kw)
    assert rk.launches == launches + 3
    assert all(torch.equal(a, b) for a, b in zip(k, k2))
    assert sample_lane_agreement(k[0], r[0], n)[0] >= AGREE
    assert abs(int(k[4]) - int(r[4])) <= 0.01 * int(r[4])
    for i in (2, 3):
        torch.testing.assert_close(kv[i], k[i], rtol=1e-4,
                                   atol=1e-6 * float(k[i].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("name,spp,use_nee", [("limit_spheres", 4, True),
                                              ("cornell_spheres", 128,
                                               False)])
def test_replay_kernel_at_its_limits_on_gpu(name, spp, use_nee):
    """Kernel 7 at its largest shared-memory block (limit_spheres: 16 slots
    and 16 lights) and at spp 128 (a pixel per row, the pixel mean through
    shared memory) against replay_call_ref on Philox draws: >= 98% of
    lanes, rays within 1%, and the loss and raw gradients of mode "vjp"
    with the cotangent kept on the lanes whose radiance agrees within
    1e-4 of the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch.ops.kernels import replay_kernel as rk
    from tpu_pathtracer_torch.ops.kernels import replay_persistent as rp
    from tpu_pathtracer_torch.utils.metrics import sample_lane_agreement

    scene, cs = getattr(sc, name)(device="cuda")
    if name == "limit_spheres":
        assert len(rp.material_slots(scene)[0]) == rk.MAX_SLOTS
        assert len(scene.light_structure) == rk.MAX_GRAD_LIGHTS
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")
    cp = pack_camera(cam)
    rows, n = rk.lanes_layout(W, H, spp, TR)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tgt = rk.broadcast_pixels_to_lanes(
        torch.rand((H, W, 3), generator=gen, device="cuda"), spp, rows)
    kw = dict(spp=spp, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee)
    k = rk.replay_call(scene, cp, (3, 1), 2, tgt, **kw)
    r = rk.replay_call_ref(scene, cp, (3, 1), 2, tgt, **kw)
    agree, _, ok = sample_lane_agreement(k[0], r[0], n)
    assert agree >= AGREE, agree
    assert abs(int(k[4]) - int(r[4])) <= 0.01 * int(r[4])
    g = rk.lane_cotangent(r[0], tgt, spp, W, H) * ok.to(
        device="cuda", dtype=torch.float32)[..., None]
    kv = rk.replay_call(scene, cp, (3, 1), 2, g, mode="vjp", **kw)
    rv = rk.replay_call_ref(scene, cp, (3, 1), 2, g, mode="vjp", **kw)
    for i in (2, 3):
        assert bool((rv[i] != 0).any())
        torch.testing.assert_close(kv[i], rv[i], rtol=1e-4,
                                   atol=1e-5 * float(rv[i].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
@pytest.mark.parametrize("injected", [True, False])
def test_sphere_field_kernel_matches_plain_on_gpu(use_nee, injected):
    """sphere_field's 128 spheres (half of the kernel's MAX_PRIMS) through
    the forward kernel against its plain version, as the Cornell test: 98%
    of lanes, or, where the f32 chaos of the 1e5-radius floor and the glass
    balls is larger, no fewer than the plain version on the CPU agrees with
    itself on the card (chip_smoke.py's floor for main-path launches)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene, cs = sc.sphere_field(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")
    cp = pack_camera(cam)
    kw = dict(budget=BUDGET, width=W, height=H, max_bounces=MB, tile_rows=TR,
              use_nee=use_nee)
    gen = torch.Generator(device="cuda").manual_seed(3)
    st_k = pk.init_state(W, H, tile_rows=TR, device="cuda")
    st_r, st_c = st_k.clone(), pk.init_state(W, H, tile_rows=TR, device="cpu")
    scene_c, cp_c = scene.to("cpu"), cp.cpu()
    rows = st_k.lr.shape[0] * BUDGET * pk.n_draws(use_nee)
    rays_k = rays_r = 0
    for _ in range(2):
        u = (torch.rand((rows, LANES), generator=gen, device="cuda")
             if injected else None)
        st_r, nr = pk.persistent_step_ref(scene, cp, (4, 0), st_r,
                                          uniforms=u, **kw)
        st_c, _ = pk.persistent_step_ref(
            scene_c, cp_c, (4, 0), st_c,
            uniforms=None if u is None else u.cpu(), **kw)
        st_k, nk = pk.persistent_step(scene, cp, (4, 0), st_k, uniforms=u,
                                      **kw)
        rays_r, rays_k = rays_r + int(nr), rays_k + int(nk)
    n_agree, l_agree, _ = lane_agreement(st_r, st_k, W, H)
    n_floor, l_floor, _ = lane_agreement(st_r, st_c, W, H)
    assert n_agree >= min(AGREE, n_floor) and l_agree >= min(AGREE, l_floor), \
        (n_agree, l_agree, n_floor, l_floor)
    assert abs(rays_k - rays_r) <= 0.01 * rays_r


@pytest.mark.gpu
def test_persistent_resume_on_gpu(tmp_path):
    """Kernel 1 resumed from a checkpoint continues bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tpu_pathtracer_torch import PersistentRenderer, RenderConfig
    from tpu_pathtracer_torch.utils import checkpoint as ckpt

    scene, cs = sc.cornell_spheres(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                         cs["fov"], device="cuda")

    def renderer():
        return PersistentRenderer(scene, cam, RenderConfig(use_nee=True),
                                  seed=2, device="cuda", budget=BUDGET,
                                  tile_rows=TR)

    full, part = renderer(), renderer()
    for _ in range(4):
        full.step()
    for _ in range(2):
        part.step()
    ckpt.save_state(str(tmp_path), part.state.frame, part.state)
    resumed = renderer()
    resumed.state = ckpt.restore_state(str(tmp_path), resumed.state)
    assert resumed.state.lr.is_cuda
    for _ in range(2):
        resumed.step()
    for f in pk.STATE_FIELDS:
        assert torch.equal(getattr(resumed.state, f), getattr(full.state, f))
