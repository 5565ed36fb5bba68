"""The terminal viewer and the package's surface, against the JAX package.

``drag_camera`` gives JAX's camera for each button, the half-block frame
and the downsample give JAX's, ``run_viewer`` runs headless on both
backends on the CPU, a camera move restarts accumulation (the first frame
after it equals a fresh renderer's), and the package exports what JAX's
does. No Pallas call.
"""
from __future__ import annotations

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pathtracer as jpt  # noqa: E402
from tpu_pathtracer import viewer as jview  # noqa: E402
from tpu_pathtracer.models import camera as jcm  # noqa: E402
import tpu_pathtracer_torch as tpt  # noqa: E402
from tpu_pathtracer_torch import viewer as tview  # noqa: E402
from tpu_pathtracer_torch.cli import main as cli_main  # noqa: E402
from tpu_pathtracer_torch.models import camera as tcm, scene as tsc  # noqa: E402
from tpu_pathtracer_torch.models import progressive as tprog  # noqa: E402
from tpu_pathtracer_torch.models.integrator import RenderConfig  # noqa: E402

from test_torch_scene_camera import CAM_ATOL, camera_to_torch  # noqa: E402

CFG = RenderConfig(spp=1, max_bounces=3, use_nee=True)


@pytest.fixture(scope="module")
def cameras():
    cs = tsc.cornell_spheres(device="cpu")[1]
    jc = jcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 20, 14,
                         cs["fov"])
    return jc, camera_to_torch(jc)


@pytest.mark.parametrize("button,dx,dy", [(0, 3, -2), (1, -1, 4),
                                          (2, 5, 1), (0, 0, 1)])
def test_drag_camera_matches_jax(cameras, button, dx, dy):
    jc, tc = cameras
    want = jview.drag_camera(jc, button, dx, dy, 1.5)
    got = tview.drag_camera(tc, button, dx, dy, 1.5)
    for f in ("pos", "view", "px_x", "px_y", "first_ray_dir"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   atol=CAM_ATOL, err_msg=f)


def test_drag_without_motion_or_button(cameras):
    _, tc = cameras
    assert tview.drag_camera(tc, 0, 0, 0, 1.0) is None
    assert tview.drag_camera(tc, 3, 2, 2, 1.0) is None


def test_frame_helpers_match_jax():
    rng = np.random.default_rng(4)
    img = rng.random((37, 50, 3)).astype(np.float32)
    small = tview._downsample(img, 16, 12)
    np.testing.assert_array_equal(small, jview._downsample(img, 16, 12))
    rgb8 = (rng.random((9, 7, 3)) * 255).astype(np.uint8)
    assert tview._halfblock_frame(rgb8) == jview._halfblock_frame(rgb8)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_run_viewer_headless(backend):
    """max_frames with interactive=False renders that many frames; drawn
    into a stream (no terminal: no raw input) it writes half-block frames
    and the status line."""
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 12,
                          cs["fov"], device="cpu")
    assert tview.run_viewer(scene, cam, CFG, max_frames=2, interactive=False,
                            backend=backend, device="cpu") == 2
    out = io.StringIO()
    assert tview.run_viewer(scene, cam, CFG, max_frames=1, interactive=True,
                            out=out, backend=backend, device="cpu") == 1
    text = out.getvalue()
    assert "\x1b[H" in text and "▀" in text and "iter" in text


def test_backends_route():
    scene, cs = tsc.cornell_spheres(device="cpu")
    cam = tcm.make_camera(cs["eye"], cs["look_at"], cs["up"], 8, 6,
                          cs["fov"], device="cpu")
    make = tview.make_renderer
    assert isinstance(make(scene, cam, CFG, device="cpu"),
                      tprog.ProgressiveRenderer)  # auto on the CPU
    r = make(scene, cam, CFG, backend="pallas", device="cpu")
    assert isinstance(r, tprog.PersistentRenderer) and r.budget == 4
    with pytest.raises(ValueError, match="backend"):
        make(scene, cam, CFG, backend="vulkan", device="cpu")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_drag_restarts_accumulation(cameras, backend):
    """After a drag, the renderer's next frame equals a fresh renderer's
    first frame at the moved camera (the persistent one reset once, as a
    restart draws with the next salt)."""
    _, tc = cameras
    scene, _ = tsc.cornell_spheres(device="cpu")
    r = tview.make_renderer(scene, tc, CFG, seed=2, backend=backend,
                            device="cpu")
    r.step()
    moved = tview.drag_camera(r.camera, 0, 2, 1, 1.0)
    r.update_camera(moved)
    r.step()
    fresh = tview.make_renderer(scene, moved, CFG, seed=2, backend=backend,
                                device="cpu")
    if backend == "pallas":
        fresh.reset()
    fresh.step()
    assert torch.equal(r.image(), fresh.image())


def test_cli_view(capsys):
    assert cli_main(["view", "--scene", "single-sphere", "--size", "12x8",
                     "--frames", "2", "--device", "cpu"]) == 0
    assert "rendered 2 frames" in capsys.readouterr().out


def test_package_exports_match_jax():
    assert set(tpt.__all__) == set(jpt.__all__) | {"PersistentRenderer"}
    for name in tpt.__all__:
        assert getattr(tpt, name) is not None
    assert tpt.BUILTIN_SCENES.keys() == jpt.BUILTIN_SCENES.keys()
