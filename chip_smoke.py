"""Smoke run of tpu_pathtracer_torch on one NVIDIA GPU.

Drives the port's main path on the card and checks it, in phases that each
print one line; any failure exits non-zero:

1. environment: versions, the card, its power limit, nvcc, triton;
2. build: compiles csrc/*.cu for sm_90a into build/tpu_pathtracer_torch/;
3. kernel vs plain PyTorch version on the card, with the same injected
   uniforms (cornell 160x120 brute force and NEE, the point-light scene with
   NEE) and with the production Philox draws; >= 98% of lanes must agree on
   the sample count and radiance, and the ray counts within 1%;
4. main path: PersistentRenderer(device="cuda") on cornell_spheres at
   640x480, spp 4, 10 bounces, brute force then NEE, render_to(16); the
   image is finite and the kernel's launch count equals the steps taken;
   each of those launches, replayed from its own input state, agrees with
   the plain version on the card on >= 98% of lanes (or, where the f32
   chaos of the budget-32 launch is larger, on no fewer lanes than the
   plain version on the CPU agrees with itself on the card), with ray
   counts within 1%; over the whole run the ray counts agree within 1% and
   the image means within 3%; update_camera resets the accumulation;
5. CLI: ``python -m tpu_pathtracer_torch.cli render`` writes a 640x480 PNG;
6. times at bench.py's workload (640x480, budget 16, tile_rows 32): step
   time and rays/s by the slope between 1 and K steps (CUDA events, median
   of REPS), the plain version's time per step, and from one torch.profiler
   trace of 10 steps the kernel's device time per launch, the device's busy
   time (union of kernel, memcpy and memset intervals), the device's idle
   share of that same window, and the device kernels that take the most
   time per step. The profiler slows the host, so that window is longer
   than the unprofiled step. The trace is kept under
   build/tpu_pathtracer_torch/.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Run it with no arguments from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEAN_TOL = 0.03
RAY_TOL = 0.01
REPS = 5
W, H, TR = 640, 480, 32


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_environment():
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    smi = smi.splitlines()[0] if smi else "nvidia-smi printed nothing"
    from tpu_pathtracer_torch.ops.kernels import _build

    try:
        nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        nvcc = f"nvcc unavailable: {e}"
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    print(f"[1 environment] torch {torch.__version__} cuda "
          f"{torch.version.cuda} device '{torch.cuda.get_device_name(0)}' "
          f"count {torch.cuda.device_count()} | nvidia-smi: {smi} | "
          f"nvcc: {nvcc} | triton: {has_triton}", flush=True)
    return smi


def phase_build():
    from tpu_pathtracer_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path, compile_s = _build.build()
    log = path.with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln] if log.is_file() else []
    print(f"[2 build] {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {compile_s:.2f} s); "
          f"ptxas: {' | '.join(regs) or 'no register report'}", flush=True)


def _cornell(w, h, device):
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    scene, cs = sc.cornell_spheres(device=device)
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
                         device=device)
    return scene, cam, pack_camera(cam)


def _point(w, h, device):
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.ops.kernels.trace_kernel import pack_camera

    scene = sc.make_scene(
        [sc.sphere([0, -1e4 - 1, 0], 1e4, 0)],
        [sc.diffuse([0.7, 0.7, 0.7])],
        [sc.point_light([0, 3, 0], [40.0, 40.0, 40.0])], device=device)
    cam = cm.make_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], w, h, 60.0,
                         device=device)
    return scene, cam, pack_camera(cam)


def phase_compare():
    """Kernel vs plain version on the card; returns the worst numbers."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import AGREE, lane_agreement

    dev = "cuda"
    cases = [
        # (name, scene builder, w, h, tile_rows, budget, use_nee, injected)
        ("cornell-brute", _cornell, 160, 120, 32, 8, False, True),
        ("cornell-nee", _cornell, 160, 120, 32, 8, True, True),
        ("point-nee", _point, 16, 12, 8, 8, True, True),
        ("cornell-nee-philox", _cornell, 160, 120, 32, 8, True, False),
    ]
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = dict(n_agree=1.0, l_agree=1.0, max_abs_err=0.0)
    parts = []
    for name, build, w, h, tr, budget, use_nee, injected in cases:
        scene, _, cp = build(w, h, dev)
        kw = dict(budget=budget, width=w, height=h, max_bounces=10,
                  rr_start=3, tile_rows=tr, use_nee=use_nee)
        st_k = pk.init_state(w, h, tr, device=dev)
        st_r = st_k.clone()
        rays_k, rays_r = 0, 0
        for _ in range(2):
            u = None
            if injected:
                rows = st_k.lr.shape[0] * budget * pk.n_draws(use_nee)
                u = torch.rand((rows, pk.LANES), generator=gen, device=dev)
            st_r, nr = pk.persistent_step_ref(scene, cp, (5, 1), st_r,
                                              uniforms=u, **kw)
            rays_r += int(nr)
            st_k, nk = pk.persistent_step(scene, cp, (5, 1), st_k,
                                          uniforms=u, **kw)
            rays_k += int(nk)
        torch.cuda.synchronize()
        if not (torch.isfinite(pk.state_image(st_k, w, h)).all()
                and torch.isfinite(pk.state_image(st_r, w, h)).all()):
            fail(f"{name}: non-finite radiance")
        n_ok, l_ok, dmax = lane_agreement(st_r, st_k, w, h)
        ray_err = abs(rays_k - rays_r) / max(rays_r, 1)
        parts.append(f"{name}: n {n_ok:.4f} L {l_ok:.4f} max|dL| {dmax:.3g} "
                     f"rays {rays_k}/{rays_r}")
        if n_ok < AGREE or l_ok < AGREE or ray_err > RAY_TOL:
            fail(f"kernel vs plain {name}: n_agree {n_ok}, l_agree {l_ok}, "
                 f"rays {rays_k} vs {rays_r}")
        worst["n_agree"] = min(worst["n_agree"], n_ok)
        worst["l_agree"] = min(worst["l_agree"], l_ok)
        worst["max_abs_err"] = max(worst["max_abs_err"], dmax)
    print("[3 kernel vs plain] " + " | ".join(parts), flush=True)
    return worst


def _render_plain(scene, cp, seed, steps, use_nee, budget):
    """The plain version driven as the renderer drives the kernel: the same
    seed, salt 0, frames 0..steps-1, so the same Philox draws. Returns the
    state and the live rays it traced."""
    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    st = pk.init_state(W, H, TR, device=scene.device)
    rays = 0
    for _ in range(steps):
        st, nr = pk.persistent_step_ref(
            scene, cp, (seed, 0), st, budget=budget, width=W, height=H,
            max_bounces=10, rr_start=3, tile_rows=TR, use_nee=use_nee)
        rays += int(nr)
    return st, rays


def _replay_per_step(scene, cam, cp, use_nee, main):
    """Replay the main path's launches one at a time and check each: a second
    renderer with the same seed takes the same steps, and before each step
    the plain version runs from a copy of the kernel's input state, on the
    same Philox draws, on the card and on the CPU. Returns, per launch, the
    kernel's agreement with the plain version on the card and the plain
    version's agreement with itself across the two backends. Fails unless
    the replay ends in the main path's exact state.

    Each launch is checked from a shared input because a lane whose f32
    closest hit flips once takes other paths for every later sample, so over
    a whole run the share of diverged lanes grows with the iterations run.
    The plain version on the CPU against itself on the card is the floor of
    that chaos for one launch: the same code, rounded by two math
    libraries."""
    import dataclasses

    import torch

    from tpu_pathtracer_torch import PersistentRenderer
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import lane_agreement

    r = PersistentRenderer(scene, cam, main.config, seed=main.seed,
                           device="cuda")
    scene_cpu, cp_cpu = scene.to("cpu"), cp.cpu()
    kw = dict(budget=r.budget, width=W, height=H, max_bounces=10,
              rr_start=3, tile_rows=TR, use_nee=use_nee)
    out = []
    for _ in range(main.state.frame):
        before = r.state.clone()
        before_cpu = dataclasses.replace(
            before, **{f: getattr(before, f).cpu() for f in pk.STATE_FIELDS})
        rays_k = r.step()
        ref, rays_r = pk.persistent_step_ref(scene, cp, (r.seed, 0), before,
                                             **kw)
        ref_cpu, _ = pk.persistent_step_ref(scene_cpu, cp_cpu, (r.seed, 0),
                                            before_cpu, **kw)
        n_ok, l_ok, dmax = lane_agreement(ref, r.state, W, H)
        n_fl, l_fl, _ = lane_agreement(ref, ref_cpu, W, H)
        out.append(dict(n_agree=n_ok, l_agree=l_ok, max_abs_err=dmax,
                        n_floor=n_fl, l_floor=l_fl,
                        ray_err=abs(rays_k - int(rays_r))
                        / max(int(rays_r), 1)))
    for f in pk.STATE_FIELDS:
        if not torch.equal(getattr(r.state, f), getattr(main.state, f)):
            fail(f"the replay of the main path differs in {f}")
    return out


def phase_main_path():
    import torch

    from tpu_pathtracer_torch import PersistentRenderer, RenderConfig
    from tpu_pathtracer_torch.models import camera as cm
    from tpu_pathtracer_torch.ops.kernels import persistent as pk
    from tpu_pathtracer_torch.utils.metrics import AGREE, lane_agreement

    scene, cam, cp = _cornell(W, H, "cuda")
    renderers, rays = {}, {}
    pk.launches = 0
    for use_nee in (False, True):
        r = PersistentRenderer(scene, cam,
                               RenderConfig(spp=4, max_bounces=10,
                                            rr_start=3, use_nee=use_nee),
                               seed=7, device="cuda")
        rays[use_nee] = r.render_to(16)
        renderers[use_nee] = r
    launches = pk.launches
    steps = sum(r.state.frame for r in renderers.values())
    if launches != steps or steps == 0:
        fail(f"main path: {launches} kernel launches for {steps} steps")
    parts = []
    worst = dict(n_agree=1.0, l_agree=1.0, n_floor=1.0, l_floor=1.0,
                 max_abs_err=0.0)
    for use_nee, r in renderers.items():
        mode = "nee" if use_nee else "brute"
        img = r.image()
        if tuple(img.shape) != (H, W, 3) or not torch.isfinite(img).all():
            fail(f"main path ({mode}): bad image {tuple(img.shape)}")
        if r.min_samples < 16:
            fail(f"main path ({mode}): min samples {r.min_samples}")
        launches_checked = _replay_per_step(scene, cam, cp, use_nee, r)
        for i, c in enumerate(launches_checked):
            # the reference's 98% bar, lowered only as far as the plain
            # version's own CPU-vs-card floor on this launch
            if c["n_agree"] < min(AGREE, c["n_floor"]) \
                    or c["l_agree"] < min(AGREE, c["l_floor"]) \
                    or c["ray_err"] > RAY_TOL:
                fail(f"main path ({mode}), launch {i} vs plain: {c}")
        step = {k: min(c[k] for c in launches_checked)
                for k in ("n_agree", "l_agree", "n_floor", "l_floor")}
        step["max_abs_err"] = max(c["max_abs_err"] for c in launches_checked)
        step["ray_err"] = max(c["ray_err"] for c in launches_checked)
        for key in ("n_agree", "l_agree", "n_floor", "l_floor"):
            worst[key] = min(worst[key], step[key])
        worst["max_abs_err"] = max(worst["max_abs_err"], step["max_abs_err"])
        # the whole run against the plain version's whole run
        ref_st, ref_rays = _render_plain(scene, cp, 7, r.state.frame,
                                         use_nee, r.budget)
        n_run, l_run, _ = lane_agreement(ref_st, r.state, W, H)
        ray_err = abs(rays[use_nee] - ref_rays) / max(ref_rays, 1)
        m = img.mean().item()
        m_ref = pk.state_image(ref_st, W, H).mean().item()
        if ray_err > RAY_TOL or abs(m - m_ref) > MEAN_TOL * abs(m_ref):
            fail(f"main path ({mode}) vs plain over the run: rays "
                 f"{rays[use_nee]} vs {ref_rays}, mean {m} vs {m_ref}")
        parts.append(
            f"{mode}: {r.state.frame} steps, min spp {r.min_samples}; worst "
            f"launch vs plain: n {step['n_agree']:.4f} L "
            f"{step['l_agree']:.4f} max|dL| {step['max_abs_err']:.3g} rays "
            f"err {step['ray_err']:.2e} (plain cpu vs card: n "
            f"{step['n_floor']:.4f} L {step['l_floor']:.4f}); whole run vs "
            f"plain: n {n_run:.4f} "
            f"L {l_run:.4f} rays {rays[use_nee]}/{ref_rays} mean "
            f"{m:.6f}/{m_ref:.6f}")
    r = renderers[True]
    before = r.image().clone()
    r.update_camera(cm.translate(r.camera, [0.0, 0.0, 10.0]))
    if r.iteration != 0 or r.min_samples != 0 or r.state.frame != 0:
        fail("update_camera did not reset the accumulation")
    r.step()
    if torch.equal(before, r.image()):
        fail("the image did not change after update_camera")
    print(f"[4 main path] cornell {W}x{H} spp 4, 10 bounces, budget "
          f"{r.budget}: " + " | ".join(parts) + f" | kernel launches "
          f"{launches} = steps {steps} | update_camera resets", flush=True)
    return launches, worst


def phase_cli():
    from tpu_pathtracer_torch.io.image import read_png
    from tpu_pathtracer_torch.ops.kernels import _build

    out = _build.build_dir() / "chip_smoke_cli.png"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.cli", "render",
         "--scene", "cornell", "--size", f"{W}x{H}", "--spp", "4",
         "--iterations", "4", "-o", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or not out.is_file():
        fail(f"cli render failed ({proc.returncode}): {proc.stderr[-2000:]}")
    img = read_png(str(out))
    if img.shape != (H, W, 3) or img.max() == 0:
        fail(f"cli wrote a bad PNG {img.shape}")
    print(f"[5 cli] wrote {out.relative_to(ROOT)} {img.shape} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _time_steps(scene, cp, use_nee, k, salt, step_fn, budget=16):
    """CUDA-event time of k steps from a fresh state (host wrapper
    included), and the rays they traced."""
    import torch

    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    st = pk.init_state(W, H, TR, device="cuda")
    rays = []
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(k):
        st, nr = step_fn(scene, cp, (salt, 0), st, budget=budget, width=W,
                         height=H, max_bounces=10, rr_start=3, tile_rows=TR,
                         use_nee=use_nee)
        rays.append(nr)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), int(torch.stack(rays).sum())


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > reach:
            busy += t1 - max(t0, reach)
            reach = t1
    return busy


def _profile_steps(scene, cp, use_nee, k=10):
    """One torch.profiler trace (device activity only) of k steps. Returns
    the persistent kernel's device ms per launch, the device's busy ms per
    step (union of kernel, memcpy and memset intervals), the window's ms per
    step (CUDA events around the same k steps), and the device ms per step
    of each kernel or copy name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_pathtracer_torch.ops.kernels import _build
    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    st = pk.init_state(W, H, TR, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(k):
            st, _ = pk.persistent_step(scene, cp, (400, i), st, budget=16,
                                       width=W, height=H, max_bounces=10,
                                       rr_start=3, tile_rows=TR,
                                       use_nee=use_nee)
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end)
    trace = (_build.build_dir()
             / f"chip_smoke_trace_{'nee' if use_nee else 'brute'}.json")
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kern = [e for e in events if "persistent_kernel" in e["name"]]
    if len(kern) != k:
        fail(f"the trace holds {len(kern)} persistent_kernel launches for "
             f"{k} steps")
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / k / 1e3
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in events)
    return (sum(e["dur"] for e in kern) / k / 1e3, busy / k / 1e3,
            window / k, by_name)


def phase_times(smi):
    """End-to-end step time and rays/s (CUDA events, slope between 1 and K
    steps, median of REPS), the plain version's step time, then one profiled
    window for the kernel's device time and the device's idle share (last,
    so its tracing touches no other number)."""
    from tpu_pathtracer_torch.ops.kernels import persistent as pk

    scene, _, cp = _cornell(W, H, "cuda")
    K = 24
    out = {}
    for use_nee in (False, True):
        mode = "nee" if use_nee else "brute"
        _time_steps(scene, cp, use_nee, 2, 99, pk.persistent_step)  # warm
        steps_ms, rates = [], []
        for rep in range(REPS):
            t1, r1 = _time_steps(scene, cp, use_nee, 1, 100 + rep,
                                 pk.persistent_step)
            tk, rk = _time_steps(scene, cp, use_nee, K, 200 + rep,
                                 pk.persistent_step)
            steps_ms.append((tk - t1) / (K - 1))
            rates.append((rk - r1) / (tk - t1) * 1e3)
        _time_steps(scene, cp, use_nee, 1, 98, pk.persistent_step_ref)
        t2, _ = _time_steps(scene, cp, use_nee, 2, 300,
                            pk.persistent_step_ref)
        out[mode] = dict(step_ms=statistics.median(steps_ms),
                         rays_per_s=statistics.median(rates), reps=rates,
                         plain_ms=t2 / 2)
    for mode, o in out.items():
        o["kernel_ms"], busy, window, by_name = _profile_steps(
            scene, cp, mode == "nee")
        o["busy_ms"], o["window_ms"] = busy, window
        o["idle_share"] = 1.0 - busy / window
        if o["idle_share"] < 0.0:
            fail(f"{mode}: device busy {busy} ms per step exceeds the "
                 f"window's {window} ms")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        o["top"] = "; ".join(f"{n[:48]} {ms:.4f}" for n, ms in top)
    parts = [
        f"{mode}: step {o['step_ms']:.4f} ms, {o['rays_per_s']:.6g} rays/s "
        f"(median of {REPS}: {', '.join(f'{r:.6g}' for r in o['reps'])}), "
        f"plain {o['plain_ms']:.3f} ms/step; profiled window "
        f"{o['window_ms']:.4f} ms/step, device busy {o['busy_ms']:.4f} ms, "
        f"idle share {o['idle_share']:.3f}, kernel {o['kernel_ms']:.4f} "
        f"ms/launch; top device ms/step: {o['top']}"
        for mode, o in out.items()]
    print(f"[6 times] {W}x{H} budget 16 tile_rows {TR} on {smi}: "
          + " | ".join(parts), flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    try:
        import tpu_pathtracer_torch  # noqa: F401
    except ImportError as e:
        fail(f"tpu_pathtracer_torch is not importable here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_pathtracer_torch.utils.metrics import AGREE, L_TOL

    smi = phase_environment()
    phase_build()
    worst = phase_compare()
    launches, worst_main = phase_main_path()
    phase_cli()
    times = phase_times(smi)

    kernel = {
        "name": "persistent_step",
        "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/persistent.cu",
        "replaces": "tpu_pathtracer/ops/pallas/persistent.py:154",
        "launches": launches,
        "max_abs_err": max(worst["max_abs_err"], worst_main["max_abs_err"]),
        "tolerance": f">= {AGREE} of lanes: equal n_samp and "
                     f"|dL| < {L_TOL} * max(1, |L|)",
        "n_agree": min(worst["n_agree"], worst_main["n_agree"]),
        "l_agree": min(worst["l_agree"], worst_main["l_agree"]),
        "n_floor_main": worst_main["n_floor"],
        "l_floor_main": worst_main["l_floor"],
        "ms": times["brute"]["kernel_ms"],
        "plain_ms": times["brute"]["plain_ms"],
        "ms_nee": times["nee"]["kernel_ms"],
        "plain_ms_nee": times["nee"]["plain_ms"],
        "step_ms_brute": times["brute"]["step_ms"],
        "step_ms_nee": times["nee"]["step_ms"],
        "idle_share_brute": times["brute"]["idle_share"],
        "idle_share_nee": times["nee"]["idle_share"],
        "rays_per_s_brute": times["brute"]["rays_per_s"],
        "rays_per_s_nee": times["nee"]["rays_per_s"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
