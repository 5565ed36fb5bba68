"""Checkpoint and resume, and the profiling and debug hooks, on the CPU.

Resume is bit for bit: the persistent renderer (its plain version), the
wavefront renderer and the wavefront trainer's TrainState, 2 steps, save,
restore into fresh objects, 2 more, equal 4 uninterrupted steps. No JAX.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer_torch.cli import main as cli_main  # noqa: E402
from tpu_pathtracer_torch.diff import inverse  # noqa: E402
from tpu_pathtracer_torch.models import camera as cm, scene as sc  # noqa: E402
from tpu_pathtracer_torch.models import progressive as prog  # noqa: E402
from tpu_pathtracer_torch.models.integrator import RenderConfig  # noqa: E402
from tpu_pathtracer_torch.ops.kernels.persistent import STATE_FIELDS  # noqa: E402
from tpu_pathtracer_torch.utils import checkpoint as ckpt  # noqa: E402
from tpu_pathtracer_torch.utils import debug, metrics, profiling  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread per module: the suite runs in several worker
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cornell(w, h):
    scene, cs = sc.cornell_spheres(device="cpu")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device="cpu")
    return scene, cam


def _persistent(scene, cam):
    return prog.PersistentRenderer(
        scene, cam, RenderConfig(spp=1, max_bounces=4, use_nee=True), seed=3,
        device="cpu", budget=4, tile_rows=8)


def test_persistent_resume_bit_exact(tmp_path):
    scene, cam = _cornell(16, 12)
    full = _persistent(scene, cam)
    for _ in range(4):
        full.step()
    part = _persistent(scene, cam)
    for _ in range(2):
        part.step()
    ckpt.save_state(str(tmp_path), part.state.frame, part.state)
    assert ckpt.latest_step(str(tmp_path)) == 2
    resumed = _persistent(scene, cam)
    resumed.state = ckpt.restore_state(str(tmp_path), resumed.state)
    assert resumed.state.frame == 2
    for _ in range(2):
        resumed.step()
    assert resumed.state.frame == full.state.frame == 4
    for f in STATE_FIELDS:
        assert torch.equal(getattr(resumed.state, f), getattr(full.state, f)), f
    assert full.min_samples > 0


def test_progressive_resume_bit_exact(tmp_path):
    scene, cam = _cornell(12, 10)
    cfg = RenderConfig(spp=2, max_bounces=3, use_nee=True)
    full = prog.ProgressiveRenderer(scene, cam, cfg, seed=9, device="cpu")
    for _ in range(4):
        full.step()
    part = prog.ProgressiveRenderer(scene, cam, cfg, seed=9, device="cpu")
    for _ in range(2):
        part.step()
    ckpt.save_state(str(tmp_path), part.iteration, part.state)
    resumed = prog.ProgressiveRenderer(scene, cam, cfg, seed=9, device="cpu")
    resumed.state = ckpt.restore_state(str(tmp_path), resumed.state)
    assert resumed.iteration == 2
    for _ in range(2):
        resumed.step()
    assert torch.equal(resumed.image(), full.image())


def test_train_state_resume_bit_exact(tmp_path):
    """The wavefront trainer's state (parameters, Adam's moments and step
    counts, the step that keys the draws) resumes bit for bit, restored
    into the fresh state's own tensors."""
    scene, cam = _cornell(8, 6)
    cfg = RenderConfig(spp=1, max_bounces=2)
    target = inverse.render_target(scene, cam, 5, cfg, n_iterations=1)
    step = inverse.make_train_step(scene, cam, cfg)

    def fresh():
        p = inverse.params_of(scene)
        p["mat_color"][3] = 0.3
        return inverse.init_state(scene, inverse.make_optimizer(5e-2), p)

    full = fresh()
    for _ in range(4):
        full, _ = step(full, target, 5)
    part = fresh()
    for _ in range(2):
        part, _ = step(part, target, 5)
    ckpt.save_state(str(tmp_path), part.step, part)
    resumed = fresh()
    tensors = dict(resumed.params)
    back = ckpt.restore_state(str(tmp_path), resumed)
    assert back is resumed and resumed.step == 2
    assert all(resumed.params[k] is t for k, t in tensors.items())
    assert all(p is tensors[k] for k, p in zip(
        inverse._names(tensors),
        resumed.optimizer.param_groups[0]["params"]))
    for _ in range(2):
        resumed, _ = step(resumed, target, 5)
    assert resumed.step == full.step == 4
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    a, b = (s.optimizer.state_dict()["state"] for s in (resumed, full))
    for i in b:
        for k in b[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)


def test_directory_rules(tmp_path):
    """A missing directory has no step; an empty one raises; the newest
    max_to_keep steps are kept; a killed write is never the latest; a
    checkpoint of another kind or shape is refused."""
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    os.makedirs(d)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(d, prog.init_state(2, 2, device="cpu"))
    for i in (1, 5, 3, 7):
        s = prog.init_state(2, 2, device="cpu")
        s.radiance_sum += i
        ckpt.save_state(d, i, prog.AccumulatorState(s.radiance_sum, i),
                        max_to_keep=3)
    assert sorted(os.listdir(d)) == ["3.pt", "5.pt", "7.pt"]
    open(os.path.join(d, "9.pt.123.tmp"), "wb").write(b"partial")
    assert ckpt.latest_step(d) == 7
    back = ckpt.restore_state(d, prog.init_state(2, 2, device="cpu"), step=5)
    assert back.iteration == 5 and bool((back.radiance_sum == 5).all())
    with pytest.raises(ValueError, match="AccumulatorState"):
        ckpt.restore_state(d, _persistent(*_cornell(4, 4)).state)
    with pytest.raises(ValueError, match="radiance_sum"):
        ckpt.restore_state(d, prog.init_state(3, 2, device="cpu"))


@pytest.mark.parametrize("backend,spp", [("xla", 1), ("pallas", 4)])
def test_cli_checkpoint_resumes(tmp_path, backend, spp):
    """cli render --checkpoint-dir: a render stopped early and run again to
    the full count gives the uninterrupted render's image bit for bit (a
    pallas step of budget 32 completes 8 samples per pixel here, so its 4
    spp take one step for 2 iterations and two for 4)."""
    def render(iterations, tag, ckdir=None):
        out = str(tmp_path / f"{tag}.npy")
        args = ["render", "--scene", "small", "--size", "12x8",
                "--spp", str(spp),
                "--bounces", "3", "--iterations", str(iterations),
                "--backend", backend, "--device", "cpu", "--hdr-output",
                out, "-q"]
        if ckdir:
            args += ["--checkpoint-dir", ckdir, "--checkpoint-every", "1"]
        assert cli_main(args) == 0
        return np.load(out)

    ckdir = str(tmp_path / "ck")
    want = render(4, "full")
    render(2, "first", ckdir)
    first = ckpt.latest_step(ckdir)
    got = render(4, "resumed", ckdir)
    assert ckpt.latest_step(ckdir) > first
    np.testing.assert_array_equal(got, want)


def test_timer_profiling_and_debug(tmp_path):
    with metrics.Timer() as t:
        torch.ones(8).sum()
    assert t.seconds >= 0.0
    rep = profiling.cost_report(lambda a: (a @ a).sum(), torch.ones(64, 64))
    assert rep["flops"] == 2 * 64 ** 3 and "peak_bytes" not in rep
    with profiling.trace(str(tmp_path / "tr")) as d:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert any(n.endswith(".json") for n in os.listdir(d))
    with pytest.raises(FloatingPointError, match="aten.log"):
        with debug.debug_mode():
            torch.log(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError, match="Inf"):
        with debug.debug_mode(nans=False):
            torch.tensor([1.0]) / 0.0
    with debug.debug_mode(infs=False):
        torch.tensor([1.0]) / 0.0
    err, out = debug.checkify_render(torch.sqrt)(torch.tensor([-1.0, 4.0]))
    assert "aten.sqrt" in err.get() and out[1] == 2.0
    with pytest.raises(FloatingPointError):
        err.throw()
    err, _ = debug.checkify_render(torch.sqrt)(torch.tensor([4.0]))
    assert err.get() is None
    err.throw()
