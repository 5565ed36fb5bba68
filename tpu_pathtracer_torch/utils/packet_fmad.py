"""Kernel 5 built with and without FMA contraction, on BASELINE config 4.

Builds ``csrc/packet.cu`` twice, with ``-fmad=false`` and with ``-fmad=true``
(nvcc's default), each into a library of its own, and drives the wavefront
through each in turn. Per traversal (two-pass and single-pass) it records
one frame's wave queries on the textured terrain at 1024x1024, 2 spp, 3
bounces, NEE, and for every wave:

* holds each build's answer against ``packet_ref`` on the same inputs by
  ``utils.metrics.packet_agreement`` (the bars of chip_smoke.py phase 17);
* times each build's launch with CUDA events, in the order A B B A, median
  of ``REPS`` such rounds.

Then it renders one 256x256 frame through each build and through the plain
queries on the same draws, and counts the pixels that agree at 1e-4 *
max(1, |L|) (phase 19's bar: >= 98%). It prints one line per traversal and
one JSON object, and exits non-zero if a build fails a bar. Needs one
NVIDIA GPU and nvcc; run it from the repository root::

    python3 -m tpu_pathtracer_torch.utils.packet_fmad
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from tpu_pathtracer_torch.ops.kernels import _build
from tpu_pathtracer_torch.ops.kernels import mesh_kernel as mk
from tpu_pathtracer_torch.utils.metrics import packet_agreement

BUILDS = {"no_fma": "-fmad=false", "fma": "-fmad=true"}
REPS = 5
W = H = 1024
SPP, BOUNCES = 2, 3
PIXEL_AGREE = 0.98


def build_variants() -> dict:
    """``tpt_packet`` of each build, bound as mesh_kernel binds it."""
    nvcc = _build.find_nvcc()
    out = _build.build_dir() / "packet_fmad"
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "packet.cu"
    procs = {}
    for name, flag in BUILDS.items():
        lib = out / f"libpacket_{name}.so"
        cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", flag,
               "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    reference = mk._kernels()[0]
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        fn = ctypes.CDLL(str(lib)).tpt_packet
        fn.argtypes, fn.restype = reference.argtypes, reference.restype
        fns[name] = fn
    return fns


class use_build:
    """Route kernel 5's wrapper to one build's entry point."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        self.saved = mk._kernels
        _, binf, error_string = self.saved()
        mk._kernels = lambda: (self.fn, binf, error_string)

    def __exit__(self, *exc):
        mk._kernels = self.saved


def record_waves(renderer) -> list:
    """The packet_query calls of one frame, their tensor inputs cloned."""
    calls, fn = [], mk.packet_query

    def rec(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return fn(*args)

    mk.packet_query = rec
    try:
        renderer.step()
    finally:
        mk.packet_query = fn
    torch.cuda.synchronize()
    return calls


def _ms(fn) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def compare_waves(renderer, fns) -> dict:
    """Per build: the worst agreement over the frame's waves, whether every
    wave holds the bars, and kernel 5's ms per frame (sum over waves of the
    median per wave)."""
    waves = record_waves(renderer)
    res = {n: dict(agree=1.0, max_abs_err=0.0, sign=0.0, t_ratio=0.0,
                   attr_diff=0.0, mat_off=0, t_ok=True, attrs_ok=True,
                   ok=True, ms_per_wave=[]) for n in fns}
    for args in waves:
        ref = mk.packet_ref(*args)
        any_hit = bool(args[5])
        for name, fn in fns.items():
            with use_build(fn):
                out = mk.packet_query(*args)
            c = packet_agreement(out, ref, args[3], any_hit)
            r = res[name]
            r["agree"] = min(r["agree"], c["agree"])
            r["max_abs_err"] = max(r["max_abs_err"], c["max_abs_err"])
            r["sign"] = max(r["sign"], c["sign"])
            r["t_ratio"] = max(r["t_ratio"], c["t_ratio"])
            r["attr_diff"] = max(r["attr_diff"], c["attr_diff"][0])
            r["mat_off"] += c["attr_diff"][1]
            for key in ("t_ok", "attrs_ok", "ok"):
                r[key] &= c[key]
        times = {n: [] for n in fns}
        names = list(fns)
        for _ in range(REPS):
            for name in names + names[::-1]:  # A B B A
                with use_build(fns[name]):
                    times[name].append(_ms(lambda: mk.packet_query(*args)))
        for name in fns:
            res[name]["ms_per_wave"].append(statistics.median(times[name]))
    for r in res.values():
        r["ms_per_frame"] = sum(r["ms_per_wave"])
        r["ms_per_launch"] = r["ms_per_frame"] / len(waves)
    return res


def main() -> int:
    from tpu_pathtracer_torch import ProgressiveRenderer, RenderConfig
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.models.integrator import render

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    fns = build_variants()
    cfg = RenderConfig(spp=SPP, max_bounces=BOUNCES, use_nee=True)
    scene, cs = sc.terrain_textured(device="cuda")
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"],
                         device="cuda")
    two = ProgressiveRenderer(scene, cam, cfg, seed=3, device="cuda")
    one = ProgressiveRenderer(sc.with_packet_mesh(scene, two_pass=False), cam,
                              cfg, seed=3, device="cuda")
    result = {"card": smi}
    ok = True
    for mode, r in (("two_pass", two), ("single_pass", one)):
        res = compare_waves(r, fns)
        result[mode] = res
        ok &= all(x["ok"] for x in res.values())
        parts = [f"{n}: kernel 5 {x['ms_per_launch']:.4f} ms/launch, "
                 f"{x['ms_per_frame']:.3f} ms/frame; every wave vs plain: "
                 f"agree >= {x['agree']:.5f}, max|dt| "
                 f"{x['max_abs_err']:.3g}, |dt| {x['t_ratio']:.3g} of its "
                 f"bar, n/uv differ by <= {x['attr_diff']:.3g} and "
                 f"{x['mat_off']} materials where the slots agree, sign "
                 f"{x['sign']:.3f}; bars "
                 + ("held" if x["ok"] else "FAILED (t "
                    + ("held" if x["t_ok"] else "failed") + ", n/uv/mat "
                    + ("held" if x["attrs_ok"] else "failed") + ")")
                 for n, x in res.items()]
        print(f"[{mode}] terrain {W}x{H} spp {SPP}, {BOUNCES} bounces, NEE "
              f"on {smi}: " + " | ".join(parts), flush=True)
    cam_s = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 256, 256,
                           cs["fov"], device="cuda")
    saved = mk.packet_query, mk.bin_rays
    mk.packet_query, mk.bin_rays = mk.packet_ref, mk.bin_rays_ref
    try:
        plain = render(two.scene, cam_s, 3, cfg, iteration=1)
    finally:
        mk.packet_query, mk.bin_rays = saved
    pixels = {}
    for name, fn in fns.items():
        with use_build(fn):
            img = render(two.scene, cam_s, 3, cfg, iteration=1)
        near = (img - plain).abs() <= 1e-4 * plain.abs().clamp_min(1.0)
        pixels[name] = float(near.all(-1).double().mean())
        ok &= pixels[name] >= PIXEL_AGREE
    result["frame_256_vs_plain_px"] = pixels
    print(f"[frame] 256x256 vs plain queries: " + ", ".join(
        f"{n} {v:.5f}" for n, v in pixels.items()) + f" (bar {PIXEL_AGREE})",
        flush=True)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
