"""The port's plain persistent step on mesh scenes against the JAX kernel in
interpret mode.

Each JAX mesh compile in interpret mode takes 40-65 s on a CPU (the budget
is unrolled into the trace), so this file runs two: ``cornell_quad`` with
NEE (a pure mesh scene lit by a TRI_LIGHT quad: TRI_LIGHT emission, MIS
pdf, NEE and the mesh shadow walk) and ``cornell_glass`` with NEE (mesh
walls merged with mirror, glass and emitter spheres), at 16x8, tile_rows 8,
budget 6, 3 bounces and roulette from bounce 0, over 2 frames. The scenes
are built by the JAX builders and carried across with their mesh, so both
sides walk the same tree; the bars are those of
``tests/test_torch_persistent.py`` (``lane_agreement``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_persistent import jax_uniforms, torch_state  # noqa: E402
from test_torch_scene_camera import (  # noqa: E402
    camera_to_torch, scene_to_torch,
)
from tpu_pathtracer.models import camera as jcm, scene as jsc  # noqa: E402
from tpu_pathtracer.ops.pallas import persistent as jpk  # noqa: E402
from tpu_pathtracer.ops.pallas.trace_kernel import (  # noqa: E402
    pack_camera as jpack_camera,
)
from tpu_pathtracer_torch.ops.kernels import persistent as tpk  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.trace_kernel import (  # noqa: E402
    pack_camera,
)
from tpu_pathtracer_torch.utils.metrics import (  # noqa: E402
    AGREE, lane_agreement,
)

W, H, TR = 16, 8, 8
MB, RRS, BUDGET, FRAMES = 3, 0, 6, 2
CASES = {"cornell-quad": (5, 3), "cornell-glass": (2, 9)}  # name: seed


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One JAX interpret-mode run (FRAMES steps, NEE) and the port's plain
    version on the same uniforms."""
    seed = CASES[request.param]
    js, cs = jsc.BUILTIN_SCENES[request.param]()
    js = jsc.with_packet_mesh(js, two_pass=False)
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"])
    kw = dict(budget=BUDGET, width=W, height=H, max_bounces=MB, rr_start=RRS,
              tile_rows=TR, use_nee=True)
    jst = jpk.init_state(W, H, tile_rows=TR)
    jrays = []
    for _ in range(FRAMES):
        jst, nr = jpk.persistent_step(js, jpack_camera(jc),
                                      jnp.asarray(seed, jnp.int32), jst,
                                      interpret=True, **kw)
        jrays.append(int(nr))

    ts, tc = scene_to_torch(js), camera_to_torch(jc)
    tst = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    n_tiles = tst.lr.shape[0] // TR
    trays = []
    for f in range(FRAMES):
        u = torch.tensor(jax_uniforms(seed, f, n_tiles, BUDGET, True))
        tst, nr = tpk.persistent_step(ts, pack_camera(tc), seed, tst,
                                      uniforms=u, **kw)
        trays.append(int(nr))
    return dict(jst=jst, tst=tst, jrays=jrays, trays=trays, scene=ts)


def test_plain_matches_jax_kernel_on_mesh(case):
    """>= 98% of lanes agree on n_samp and radiance after 2 frames; the
    live-ray counts (path and shadow segments) within 1%."""
    n_agree, l_agree, _ = lane_agreement(torch_state(case["jst"]),
                                         case["tst"], W, H)
    assert n_agree >= AGREE, f"sample counts agree on only {n_agree:.4f}"
    assert l_agree >= AGREE, f"radiance agrees on only {l_agree:.4f}"
    for rj, rt in zip(case["jrays"], case["trays"]):
        assert abs(rj - rt) <= 0.01 * rj, (case["jrays"], case["trays"])


def test_mesh_scene_renders_light(case):
    """The image is finite and lit, every pixel completed a sample, and the
    JAX image agrees in its mean."""
    img = tpk.state_image(case["tst"], W, H)
    jimg = np.asarray(jpk.state_image(case["jst"], W, H))
    assert torch.isfinite(img).all() and float(img.mean()) > 0.0
    assert int(tpk.state_min_samples(case["tst"], W, H)) >= 1
    np.testing.assert_allclose(float(img.mean()), float(jimg.mean()),
                               rtol=0.02)


def test_unpacked_mesh_is_refused(case):
    """The step walks the packed mesh only: an unpacked mesh scene raises
    instead of rendering without its triangles."""
    import dataclasses

    bare = dataclasses.replace(case["scene"], mesh_packed=None)
    st = tpk.init_state(W, H, tile_rows=TR, device="cpu")
    with pytest.raises(ValueError, match="with_packet_mesh"):
        tpk.persistent_step(bare, torch.zeros(24), (0, 0), st, budget=1,
                            width=W, height=H, tile_rows=TR)
