"""Command-line interface of the PyTorch port: render a scene to a PNG.

Example:
  python -m tpu_pathtracer_torch.cli render --scene cornell --size 640x480 \\
      --spp 4 --iterations 16 -o out.png

``--device`` defaults to ``cuda``, which runs the CUDA kernel. ``--device
cpu`` runs the plain PyTorch version and is only taken when asked for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def cmd_render(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from tpu_pathtracer_torch.io.image import save_png
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.models.progressive import PersistentRenderer
    from tpu_pathtracer_torch.utils.metrics import RenderMeter

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda needs an NVIDIA GPU and a CUDA build of "
              "PyTorch, and none is available here (--device cpu runs the "
              "plain PyTorch version)", file=sys.stderr)
        return 2
    w, h = _parse_size(args.size)
    scene, cs = sc.BUILTIN_SCENES[args.scene](device=device)
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                            cs["fov"], device=device)
    config = RenderConfig(spp=args.spp, max_bounces=args.bounces,
                          use_nee=args.nee)
    r = PersistentRenderer(scene, camera, config, seed=args.seed,
                           device=device)
    meter = RenderMeter(w * h * args.spp)
    target_spp = args.spp * args.iterations
    while r.min_samples < target_spp:
        t0 = time.perf_counter()
        nrays = r.step()
        meter.update(time.perf_counter() - t0, nrays)
        print(f"\r{meter.status(r.min_samples)}", end="", file=sys.stderr)
    print(file=sys.stderr)
    hdr = r.image().cpu().numpy()
    if args.output:
        save_png(args.output, hdr)
        print(f"wrote {args.output}")
    else:
        print(json.dumps({"mean": float(hdr.mean()),
                          "max": float(np.max(hdr))}))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpu_pathtracer_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to an image")
    pr.add_argument("--scene", default="cornell",
                    choices=["cornell", "small", "single-sphere"])
    pr.add_argument("--size", default="640x480")
    pr.add_argument("--spp", type=int, default=4)
    pr.add_argument("--iterations", type=int, default=8)
    pr.add_argument("--bounces", type=int, default=10)
    pr.add_argument("--nee", action="store_true",
                    help="next-event estimation + MIS")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (plain PyTorch)")
    pr.add_argument("-o", "--output", help="PNG output path")
    pr.set_defaults(fn=cmd_render)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
