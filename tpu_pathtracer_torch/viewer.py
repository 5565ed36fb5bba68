"""Interactive progressive viewer in the terminal.

Counterpart of ``tpu_pathtracer/viewer.py``, the analogue of the reference's
app layer: GLUT window + per-frame progressive display (reference
main.cpp:205-232) and its input handling (main.cpp:238-364). The GL
pixel-buffer blit becomes ANSI truecolor half-block rendering; the input
map is:

  arrows        rotate          (reference PressKey arrows)
  w/a/s/d/q/e   translate forward/left/back/right/down/up
                (reference Ctrl+arrows; Shift = 10x there, '+'-speed here)
  [ ]           translate speed down/up
  r             reset accumulation     (reference Keyboard 'r')
  p             save PNG snapshot
  ESC / Ctrl-C  quit                   (reference Keyboard 27)
  mouse drags   left = rotate, right = translate in the view XY plane,
                middle = translate in the view XZ plane — the reference's
                Mouse/Motion map (main.cpp:312-364), carried over xterm
                SGR mouse reporting (ESC[?1002h button-drag tracking).

Camera motion resets accumulation exactly like the reference
(main.cpp:209 -> Pathtracer::Reset), through the renderers'
``update_camera``. The frames come from the persistent CUDA kernel
(``PersistentRenderer``, backend "pallas") or from the wavefront
(``ProgressiveRenderer``, "xla", whose mesh queries run the packet and bin
kernels).
"""
from __future__ import annotations

import os
import select
import sys
import time

import numpy as np

# Reference globals.h:53-54
CAM_TRANSLATE_DELTA = 1.0
CAM_ROTATE_DELTA = 0.05


def _halfblock_frame(rgb8: np.ndarray) -> str:
    """Render (H, W, 3) uint8 as ANSI truecolor half-blocks (2 rows/char)."""
    h, w, _ = rgb8.shape
    if h % 2:
        rgb8 = rgb8[:-1]
        h -= 1
    top = rgb8[0::2]
    bot = rgb8[1::2]
    lines = []
    for y in range(h // 2):
        parts = []
        prev = None
        for x in range(w):
            tr, tg, tb = top[y, x]
            br, bg, bb = bot[y, x]
            key = (tr, tg, tb, br, bg, bb)
            if key != prev:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m")
                prev = key
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def _downsample(img: np.ndarray, tw: int, th: int) -> np.ndarray:
    """Box-average an (H, W, 3) image to at most (th, tw)."""
    h, w, _ = img.shape
    fy = max(1, h // th)
    fx = max(1, w // tw)
    hh = (h // fy) * fy
    ww = (w // fx) * fx
    return (
        img[:hh, :ww]
        .reshape(hh // fy, fy, ww // fx, fx, 3)
        .mean(axis=(1, 3))
    )


class MouseEvent:
    """One SGR mouse report: button id, cell position, press/drag state."""

    __slots__ = ("button", "x", "y", "down")

    def __init__(self, button: int, x: int, y: int, down: bool):
        self.button = button  # 0 left, 1 middle, 2 right
        self.x = x
        self.y = y
        self.down = down  # False == release


class _RawInput:
    """Non-blocking raw keyboard + mouse reads (the GLUT callback
    substitute). Mouse uses xterm button-drag tracking (ESC[?1002h) with
    SGR encoding (ESC[?1006h): reports arrive as ESC[<b;x;yM / m."""

    def __init__(self, mouse: bool = True):
        self.mouse = mouse

    def __enter__(self):
        self.enabled = sys.stdin.isatty()
        if self.enabled:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.old = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
            if self.mouse:
                sys.stdout.write("\x1b[?1002h\x1b[?1006h")
                sys.stdout.flush()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import termios

            if self.mouse:
                sys.stdout.write("\x1b[?1006l\x1b[?1002l")
                sys.stdout.flush()
            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)
        return False

    def _read_sgr_mouse(self) -> MouseEvent | None:
        """Parse the tail of ESC [ < b ; x ; y (M|m)."""
        buf = ""
        while select.select([sys.stdin], [], [], 0.01)[0]:
            c = sys.stdin.read(1)
            if c in "Mm":
                try:
                    b, x, y = (int(v) for v in buf.split(";"))
                except ValueError:
                    return None
                return MouseEvent(b & 0b11, x, y, c == "M")
            buf += c
            if len(buf) > 16:
                return None
        return None

    def poll(self) -> str | MouseEvent | None:
        if not self.enabled:
            return None
        if select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # escape sequence (arrow / mouse) or bare ESC
                if select.select([sys.stdin], [], [], 0.01)[0]:
                    c1 = sys.stdin.read(1)
                    if c1 != "[":
                        return None
                    c2 = sys.stdin.read(1)
                    if c2 == "<":
                        return self._read_sgr_mouse()
                    return {"A": "UP", "B": "DOWN", "C": "RIGHT",
                            "D": "LEFT"}.get(c2, None)
                return "ESC"
            return ch
        return None


def drag_camera(camera, button: int, dx: int, dy: int, speed: float):
    """Map a mouse-drag delta to a camera update, or None.

    Reference Motion() semantics (main.cpp:312-364): left drag rotates,
    right drag translates in the view XY plane, middle drag translates in
    the view XZ plane. Deltas are in terminal cells (the analogue of the
    reference's pixel deltas), scaled by the rotate/translate step sizes.
    """
    from tpu_pathtracer_torch.models import camera as cm

    if dx == 0 and dy == 0:
        return None
    if button == 0:  # left: rotate (main.cpp:330-338)
        return cm.rotate(
            camera,
            [dx * CAM_ROTATE_DELTA * 0.5, -dy * CAM_ROTATE_DELTA * 0.5],
        )
    if button == 2:  # right: translate view-plane XY (main.cpp:340-350)
        return cm.translate(camera, [dx * speed, dy * speed, 0.0])
    if button == 1:  # middle: translate view XZ (main.cpp:352-362)
        return cm.translate(camera, [dx * speed, 0.0, dy * speed])
    return None


def make_renderer(scene, camera, config, seed: int = 0,
                  backend: str = "auto", device="cuda"):
    """The viewer's renderer: backend "auto" routes by
    ``progressive.auto_backend`` (as ``cli render``), "pallas" is
    ``PersistentRenderer`` (the persistent kernel), "xla" is
    ``ProgressiveRenderer`` (the wavefront). On the CPU the persistent
    renderer runs its plain version with a small budget (4 iterations per
    step, 8-row tiles), as the JAX viewer runs its interpreter."""
    import torch

    from tpu_pathtracer_torch.models.progressive import (
        PersistentRenderer, ProgressiveRenderer, auto_backend,
    )

    device = torch.device(device)
    if backend == "auto":
        backend = auto_backend(scene, device)
    if backend == "pallas":
        small = {"budget": 4, "tile_rows": 8} if device.type == "cpu" else {}
        return PersistentRenderer(scene, camera, config, seed=seed,
                                  device=device, **small)
    if backend == "xla":
        return ProgressiveRenderer(scene, camera, config, seed=seed,
                                   device=device)
    raise ValueError(f"unknown backend {backend!r} (auto, xla or pallas)")


def run_viewer(
    scene,
    camera,
    config,
    seed: int = 0,
    max_frames: int | None = None,
    interactive: bool = True,
    out=sys.stdout,
    snapshot_path: str = "snapshot.png",
    backend: str = "auto",
    device="cuda",
) -> int:
    """Main loop. Returns the number of frames rendered.

    max_frames + interactive=False gives a scriptable smoke mode (used by
    tests and headless checks). backend: see ``make_renderer``.
    """
    import torch

    from tpu_pathtracer_torch.io.image import save_png, tonemap
    from tpu_pathtracer_torch.models import camera as cm
    from tpu_pathtracer_torch.utils.metrics import RenderMeter

    r = make_renderer(scene, camera, config, seed, backend, device)
    on_card = torch.device(device).type == "cuda"
    meter = RenderMeter(camera.width * camera.height * config.spp)
    speed = CAM_TRANSLATE_DELTA
    frames = 0

    try:
        cols, rows = os.get_terminal_size()
    except OSError:
        cols, rows = 80, 24
    tw = max(16, min(cols - 1, 160))
    th = max(16, (rows - 2) * 2)

    def image() -> np.ndarray:
        return r.image().cpu().numpy()

    def redraw():
        small = _downsample(image(), tw, th)
        frame = _halfblock_frame(tonemap(small))
        out.write("\x1b[H" + frame + "\x1b[0m\n")
        out.write(
            f"\x1b[K[{meter.status(r.iteration)}]  "
            "arrows/drag:rotate wasdqe/r-drag:move r:reset p:png ESC:quit\r"
        )
        out.flush()

    drag = {"pos": None}  # last (button, x, y) while a button is held

    def mouse_camera(ev: MouseEvent):
        """Track the drag anchor and produce the camera update."""
        if not ev.down:
            drag["pos"] = None
            return None
        last = drag["pos"]
        drag["pos"] = (ev.button, ev.x, ev.y)
        if last is None or last[0] != ev.button:
            return None  # press or button change: establish the anchor
        return drag_camera(
            r.camera, ev.button, ev.x - last[1], ev.y - last[2], speed
        )

    with _RawInput() as kb:
        if interactive:
            out.write("\x1b[2J")  # clear
        while True:
            t0 = time.perf_counter()
            r.step()
            if on_card:
                torch.cuda.synchronize(device)
            meter.update(time.perf_counter() - t0, None)
            frames += 1
            if interactive:
                redraw()
            if max_frames is not None and frames >= max_frames:
                break

            key = kb.poll() if interactive else None
            if key is None:
                continue
            cam2 = None
            if isinstance(key, MouseEvent):
                cam2 = mouse_camera(key)
                if cam2 is not None:
                    r.update_camera(cam2)
                continue
            if key == "ESC":
                break
            elif key == "r":
                r.reset()  # both renderer classes implement it
            elif key == "p":
                save_png(snapshot_path, image())
            elif key in ("UP", "DOWN", "LEFT", "RIGHT"):
                d = CAM_ROTATE_DELTA
                theta = {
                    "UP": [0.0, d], "DOWN": [0.0, -d],
                    "LEFT": [-d, 0.0], "RIGHT": [d, 0.0],
                }[key]
                cam2 = cm.rotate(r.camera, theta)
            elif key in "wasdqe":
                v = {
                    "w": [0, 0, speed], "s": [0, 0, -speed],
                    "a": [-speed, 0, 0], "d": [speed, 0, 0],
                    "q": [0, -speed, 0], "e": [0, speed, 0],
                }[key]
                cam2 = cm.translate(r.camera, v)
            elif key == "[":
                speed = max(speed / 2, 1e-3)
            elif key == "]":
                speed = speed * 2
            if cam2 is not None:
                r.update_camera(cam2)  # resets accumulation (main.cpp:209)
    return frames
