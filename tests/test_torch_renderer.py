"""The port's renderer, CLI, import hygiene and kernel build command."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch import PersistentRenderer, RenderConfig  # noqa: E402
from tpu_pathtracer_torch.io.image import read_png  # noqa: E402
from tpu_pathtracer_torch.models import camera as cm, scene as sc  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import _build  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import persistent as pk  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
W, H, TR = 32, 24, 8


@pytest.fixture()
def renderer():
    scene, cs = sc.cornell_spheres(device="cpu")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                         device="cpu")
    return PersistentRenderer(scene, cam, RenderConfig(spp=2, max_bounces=2),
                              seed=3, device="cpu", budget=6, tile_rows=TR)


def test_render_to_and_iteration(renderer):
    rays = renderer.render_to(4)
    assert rays > 0
    assert renderer.min_samples >= 4
    assert renderer.iteration == renderer.min_samples // 2
    img = renderer.image().numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert 0.05 < img.mean() < 5.0


def test_update_camera_resets(renderer):
    renderer.render_to(2)
    before = renderer.image().clone()
    salt = renderer._salt
    renderer.update_camera(cm.translate(renderer.camera, [0.0, 0.0, 10.0]))
    assert renderer.iteration == 0 and renderer.min_samples == 0
    assert renderer._salt == salt + 1 and renderer.state.frame == 0
    renderer.step()
    assert not torch.equal(before, renderer.image())


def test_renderer_refuses_unported_options():
    scene, cs = sc.single_sphere(device="cpu")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 8, 8, cs["fov"],
                         device="cpu")
    with pytest.raises(NotImplementedError):
        PersistentRenderer(scene, cam, RenderConfig(), device="cpu",
                           mesh=object())


def test_cli_render_cpu(tmp_path, capsys):
    from tpu_pathtracer_torch import cli

    out = tmp_path / "out.png"
    rc = cli.main(["render", "--scene", "cornell", "--size", f"{W}x{H}",
                   "--spp", "1", "--iterations", "1", "--bounces", "2",
                   "--device", "cpu", "-o", str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (H, W, 3) and img.max() > 0


def test_cli_cuda_without_a_card_fails_clearly(capsys):
    """--device cuda (the default) never moves quietly to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from tpu_pathtracer_torch import cli

    rc = cli.main(["render", "--size", "8x8"])
    assert rc != 0
    assert "--device cpu" in capsys.readouterr().err


def test_imports_without_jax():
    """The port runs where jax is absent: import every module with jax
    blocked."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "tpu_pathtracer_torch").rglob("*.py"))
    code = ("import sys; sys.modules['jax'] = None; "
            "import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None]")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_command_targets_hopper(tmp_path):
    """The build assembles one sm_90a nvcc compile per source, the link
    into one library and the build/ path, without running nvcc."""
    srcs = _build.sources()
    assert [s.name for s in srcs] == ["bin.cu", "camera_jvp.cu",
                                      "packet.cu", "persistent.cu",
                                      "replay.cu", "replay_persistent.cu",
                                      "trace.cu"]
    obj = tmp_path / "a.o"
    cmd = _build.nvcc_command("nvcc", srcs[1], obj)
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-c", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == str(obj) and cmd[-1] == str(srcs[1])
    # the tangent, packet and bin kernels are built without FMA
    # contraction, the persistent and per-sample kernels with it
    assert [s.name for s in srcs
            if "-fmad=false" in _build.nvcc_command("nvcc", s, obj)] == [
                "bin.cu", "camera_jvp.cu", "packet.cu"]
    out = tmp_path / "lib.so"
    link = _build.link_command("nvcc", [obj, tmp_path / "b.o"], out)
    assert "-shared" in link and link[link.index("-o") + 1] == str(out)
    assert link[-2:] == [str(obj), str(tmp_path / "b.o")]
    lib = _build.library_path()
    assert lib.parent == REPO / "build" / "tpu_pathtracer_torch"
    assert lib.name.startswith("libtpt_kernels_") and lib.suffix == ".so"


def test_library_hash_covers_headers(tmp_path):
    """An edited shared header changes the library's hash, so the library
    is rebuilt instead of a stale one loaded (on a copy of csrc/)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert [h.name for h in _build.headers(csrc)] == ["pt_common.cuh"]
    before = _build.source_hash(csrc)
    assert before == _build.source_hash(_build.CSRC)
    header = csrc / "pt_common.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.source_hash(csrc) != before


def test_launch_counter_counts_kernel_launches_only(renderer):
    """The plain version on the CPU never counts as a kernel launch."""
    before = pk.launches
    renderer.step()
    assert pk.launches == before
