"""The CUDA kernel against its plain PyTorch version on the card.

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
