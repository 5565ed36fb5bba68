"""Command-line interface of the PyTorch port.

Examples:
  python -m tpu_pathtracer_torch.cli render --scene cornell --size 640x480 \\
      --spp 4 --iterations 16 -o out.png
  python -m tpu_pathtracer_torch.cli render --scene terrain --size 1024x1024 \\
      --spp 2 --bounces 3 --nee --iterations 4 -o terrain.png
  python -m tpu_pathtracer_torch.cli render --scene scene.json --nee \\
      --checkpoint-dir ckpt -o out.png --hdr-output out.npy
  python -m tpu_pathtracer_torch.cli view --scene cornell
  python -m tpu_pathtracer_torch.cli invert --size 32x32 --steps 30

``render`` draws a builtin scene or a JSON scene file (``io/scene_io.py``)
to a PNG and, with ``--hdr-output``, to linear radiance in a ``.npy``, and
with ``--checkpoint-dir`` resumes from and saves checkpoints
(``utils/checkpoint.py``). It renders through one of two backends, named as in
the JAX package so that commands carry over: ``xla`` is the PyTorch wavefront
integrator, whose mesh queries run the CUDA packet and bin kernels, and
``pallas`` is the persistent CUDA kernel; ``auto`` takes the wavefront on the
CPU and for meshes of more than 10,000 triangles (the textured ``terrain``),
else the persistent kernel. ``invert`` is the inverse-rendering demo
(BASELINE config 5): ``--estimator kernel`` trains through the fused
gradient kernel, ``replay`` by autograd through the wavefront, and ``auto``
(the default, as in JAX) takes the kernel on the card and the wavefront on
the CPU. ``view`` is the terminal viewer (``viewer.py``) on the same
backends. The JAX CLI's ``bench`` is not here: it times the JAX package,
and the port's benchmark is work of its own. ``--device`` defaults to
``cuda``, which runs the CUDA kernels. ``--device cpu`` runs the plain
PyTorch versions and is only taken when asked for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def _load_scene(name: str, device):
    """A builtin scene by name, or a JSON scene file (``io/scene_io.py``)."""
    from tpu_pathtracer_torch.io.scene_io import load_scene
    from tpu_pathtracer_torch.models import scene as sc

    if name in sc.BUILTIN_SCENES:
        return sc.BUILTIN_SCENES[name](device=device)
    return load_scene(name, device=device)


def cmd_render(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from tpu_pathtracer_torch.io.image import save_hdr, save_png
    from tpu_pathtracer_torch.models import camera as cm
    from tpu_pathtracer_torch.models import progressive as prog
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.utils import checkpoint as ckpt
    from tpu_pathtracer_torch.utils.metrics import RenderMeter

    device = torch.device(args.device)
    if _no_card(device):
        return 2
    w, h = _parse_size(args.size)
    scene, cs = _load_scene(args.scene, device)
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                            cs["fov"], lens_radius=cs.get("lens_radius", 0.0),
                            focal_distance=cs.get("focal_distance", 0.0),
                            device=device)
    config = RenderConfig(spp=args.spp, max_bounces=args.bounces,
                          use_nee=args.nee)
    backend = args.backend
    if backend == "auto":
        backend = prog.auto_backend(scene, device)
    meter = RenderMeter(w * h * args.spp)
    ckdir = args.checkpoint_dir

    def progress(done: int) -> None:
        if not args.quiet:
            print(f"\r{meter.status(done)}", end="", file=sys.stderr)

    if backend == "pallas":
        # --iterations x --spp is the per-pixel completed-sample target; a
        # checkpoint is the PathState, its frame the step number
        r = prog.PersistentRenderer(scene, camera, config, seed=args.seed,
                                    device=device)
        if ckdir and ckpt.latest_step(ckdir) is not None:
            r.state = ckpt.restore_state(ckdir, r.state)
            print(f"resumed at min {r.min_samples} samples/pixel",
                  file=sys.stderr)
        target_spp = args.spp * args.iterations
        steps = 0
        while r.min_samples < target_spp:
            t0 = time.perf_counter()
            nrays = r.step()
            meter.update(time.perf_counter() - t0, nrays)
            steps += 1
            progress(r.min_samples)
            if ckdir and steps % args.checkpoint_every == 0:
                ckpt.save_state(ckdir, r.state.frame, r.state)
        if ckdir:
            ckpt.save_state(ckdir, r.state.frame, r.state)
    else:
        r = prog.ProgressiveRenderer(scene, camera, config, seed=args.seed,
                                     device=device)
        if ckdir and ckpt.latest_step(ckdir) is not None:
            r.state = ckpt.restore_state(ckdir, r.state)
            print(f"resumed from iteration {r.iteration}", file=sys.stderr)
        while r.iteration < args.iterations:
            t0 = time.perf_counter()
            r.step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            meter.update(time.perf_counter() - t0, None)
            progress(r.iteration)
            if ckdir and r.iteration % args.checkpoint_every == 0:
                ckpt.save_state(ckdir, r.iteration, r.state)
        if ckdir:
            ckpt.save_state(ckdir, r.iteration, r.state)
    if not args.quiet:
        print(file=sys.stderr)
    hdr = r.image().cpu().numpy()
    if args.output:
        save_png(args.output, hdr, gamma=args.gamma)
        print(f"wrote {args.output}")
    if args.hdr_output:
        save_hdr(args.hdr_output, hdr)
        print(f"wrote {args.hdr_output}")
    if not args.output and not args.hdr_output:
        print(json.dumps({"mean": float(hdr.mean()),
                          "max": float(np.max(hdr))}))
    return 0


def cmd_view(args: argparse.Namespace) -> int:
    """The terminal viewer (``viewer.py``)."""
    import torch

    from tpu_pathtracer_torch.models import camera as cm
    from tpu_pathtracer_torch.models.integrator import RenderConfig
    from tpu_pathtracer_torch.viewer import run_viewer

    device = torch.device(args.device)
    if _no_card(device):
        return 2
    w, h = _parse_size(args.size)
    scene, cs = _load_scene(args.scene, device)
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                            cs["fov"], device=device)
    config = RenderConfig(spp=args.spp, max_bounces=args.bounces,
                          use_nee=args.nee)
    frames = run_viewer(
        scene, camera, config, seed=args.seed, max_frames=args.frames,
        interactive=sys.stdout.isatty() or args.frames is None,
        snapshot_path=args.snapshot, backend=args.backend, device=device)
    print(f"\nrendered {frames} frames")
    return 0


def _no_card(device) -> bool:
    """True, after saying so, when the card was asked for and is absent."""
    import torch

    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda needs an NVIDIA GPU and a CUDA build of "
              "PyTorch, and none is available here (--device cpu runs the "
              "plain PyTorch version)", file=sys.stderr)
        return True
    return False


def cmd_invert(args: argparse.Namespace) -> int:
    """Inverse-rendering demo (BASELINE config 5): perturb the Cornell
    grey-wall albedo and the light intensity, and recover them by same-seed
    gradient descent: through the fused gradient kernel (``--estimator
    kernel``, one launch per step) or by autograd through the wavefront
    (``replay``, the JAX package's route off the TPU); ``auto`` takes the
    kernel on the card and the wavefront on the CPU, as JAX's does."""
    import numpy as np
    import torch

    from tpu_pathtracer_torch.diff import inverse
    from tpu_pathtracer_torch.io.image import save_png
    from tpu_pathtracer_torch.models import camera as cm, scene as sc
    from tpu_pathtracer_torch.models.integrator import (
        RenderConfig, render_image,
    )

    device = torch.device(args.device)
    if _no_card(device):
        return 2
    estimator = args.estimator
    if estimator == "auto":
        estimator = "kernel" if device.type == "cuda" else "replay"
    w, h = _parse_size(args.size)
    scene, cs = sc.cornell_spheres(device=device)
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                            cs["fov"], device=device)
    config = RenderConfig(spp=args.spp, max_bounces=3)

    params0 = inverse.params_of(scene)
    params0["mat_color"][3] = 0.3
    params0["light_intensity"] *= 0.5
    state = inverse.init_state(scene, inverse.make_optimizer(lr=args.lr),
                               params0)
    if estimator == "kernel":
        seed = (args.seed, 0)
        target = inverse.render_target_kernel(scene, camera, seed, config,
                                              iteration=0)
        step_fn = inverse.make_kernel_train_step(scene, camera, config,
                                                 fixed_iteration=0)
    else:
        seed = args.seed
        target = inverse.render_target(scene, camera, seed, config,
                                       n_iterations=1, base_iteration=0)
        step_fn = inverse.make_train_step(scene, camera, config,
                                          fixed_iteration=0)
    for i in range(args.steps):
        state, loss = step_fn(state, target, seed)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
    got = state.params["mat_color"][3].detach().cpu().numpy()
    want = scene.mat_color[3].cpu().numpy()
    print(f"recovered albedo {np.round(got, 3)}  (true {np.round(want, 3)})")
    gi = state.params["light_intensity"][0].detach().cpu().numpy()
    wi = scene.light_intensity[0].cpu().numpy()
    print(f"recovered intensity {np.round(gi, 2)}  (true {np.round(wi, 2)})")
    if args.output:
        final = inverse.apply_params(
            scene, {k: v.detach() for k, v in state.params.items()})
        if estimator == "kernel":
            img = inverse.render_target_kernel(final, camera, seed, config,
                                               iteration=0)
        else:
            img = render_image(final, camera, seed, config)
        save_png(args.output, img.reshape(h, w, 3).cpu().numpy())
        print(f"wrote {args.output}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpu_pathtracer_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene to an image")
    pr.add_argument("--scene", default="cornell",
                    help="a builtin name (cornell, cornell-glass, "
                         "cornell-boxes, cornell-quad, small, single-sphere, "
                         "terrain, sphere-field) or a .json scene file")
    pr.add_argument("--size", default="640x480")
    pr.add_argument("--spp", type=int, default=4)
    pr.add_argument("--iterations", type=int, default=8)
    pr.add_argument("--bounces", type=int, default=10)
    pr.add_argument("--nee", action="store_true",
                    help="next-event estimation + MIS")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--backend", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="xla: the PyTorch wavefront with the CUDA packet "
                         "and bin kernels; pallas: the persistent CUDA "
                         "kernel; auto: the wavefront on the CPU and for "
                         "meshes above 10,000 triangles, else the "
                         "persistent kernel")
    pr.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    pr.add_argument("--gamma", type=float, default=2.2)
    pr.add_argument("--checkpoint-dir",
                    help="checkpoint directory: resume an interrupted "
                         "progressive render bit for bit (both backends)")
    pr.add_argument("--checkpoint-every", type=int, default=8,
                    help="checkpoint every N steps (pallas) or iterations "
                         "(xla)")
    pr.add_argument("-o", "--output", help="PNG output path")
    pr.add_argument("--hdr-output", help="linear .npy output path")
    pr.add_argument("-q", "--quiet", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("view", help="interactive terminal viewer")
    pv.add_argument("--scene", default="cornell",
                    help="a builtin name or a .json scene file")
    pv.add_argument("--size", default="192x144")
    pv.add_argument("--spp", type=int, default=2)
    pv.add_argument("--bounces", type=int, default=6)
    pv.add_argument("--nee", action="store_true")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (headless smoke mode)")
    pv.add_argument("--snapshot", default="snapshot.png")
    pv.add_argument("--backend", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="as for render")
    pv.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (plain PyTorch)")
    pv.set_defaults(fn=cmd_view)

    pi = sub.add_parser("invert", help="inverse-rendering demo (config 5)")
    pi.add_argument("--size", default="32x32")
    pi.add_argument("--spp", type=int, default=4)
    pi.add_argument("--steps", type=int, default=30)
    pi.add_argument("--lr", type=float, default=5e-2)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("--estimator", choices=["auto", "replay", "kernel"],
                    default="auto",
                    help="kernel = the fused value-and-grad kernel (one walk "
                         "per step); replay = autograd through the "
                         "wavefront; auto = kernel on the card, replay on "
                         "the CPU")
    pi.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernel) or cpu (plain PyTorch)")
    pi.add_argument("-o", "--output", help="render recovered scene to PNG")
    pi.set_defaults(fn=cmd_invert)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
