"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``tpu_pathtracer_torch/csrc/*.cu`` for ``sm_90a``
(Hopper), one process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use. The
library lands in ``build/tpu_pathtracer_torch/`` beside the package, named
by a hash of the sources and their shared headers (``csrc/*.cuh``), so an
edited source or header rebuilds and an unchanged tree loads at once. It is
loaded with ``ctypes``; no PyTorch header is compiled, so a build takes
seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# The tangent kernel is built without FMA contraction, so that it rounds as
# its plain PyTorch version does (which fuses only where it calls an
# explicit FMA, as the kernel's fmaf does): with contraction its position
# tangents on a 1e4-radius floor sphere differ from the plain version's by
# more than 1e-4 on ~3% of lanes, more than the plain version on the CPU
# differs from itself on the card. The packet and bin kernels are built the
# same way, so that they equal their plain versions bit for bit (with
# contraction the packet kernel of the 64-leaf tree was 4-6% faster but
# failed its t and attribute bars, PERF.md).
SOURCE_FLAGS = {"camera_jvp.cu": ["-fmad=false"],
                "packet.cu": ["-fmad=false"],
                "bin.cu": ["-fmad=false"]}


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def headers(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cuh"))


def build_dir() -> Path:
    return _PKG.parent / "build" / "tpu_pathtracer_torch"


def source_hash(csrc: Path = CSRC) -> str:
    """Hash of every source and header, by name and content, and of the
    per-source flags."""
    h = hashlib.sha256(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sorted(sources(csrc) + headers(csrc)):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libtpt_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the default CUDA prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_command(nvcc: str, src: Path, output: Path) -> list[str]:
    """Compile one source into a position-independent object (route (b) of
    a kernel build: a shared library with a C interface)."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3",
            *SOURCE_FLAGS.get(src.name, []), "-c", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(output), str(src)]


def link_command(nvcc: str, objects: list[Path], output: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(output),
            *(str(o) for o in objects)]


def build() -> tuple[Path, float]:
    """Compile the library if this source hash has not been built yet.
    Returns (library path, seconds spent compiling and linking). The
    compiler's output (including ptxas register counts) is kept next to the
    library as ``<name>.log``."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    srcs = sources()
    objs = [out.parent / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.so.tmp")
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in (nvcc_command(nvcc, s, o) for s, o in zip(srcs, objs))]
    log, failed = [], False
    for cmd, proc in procs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        failed |= proc.returncode != 0
    if not failed:
        cmd = link_command(nvcc, objs, tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        failed = proc.returncode != 0
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    text = "\n".join(log)
    out.with_suffix(".log").write_text(text)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, out)
    return out, seconds


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes per kernel build, by name and
    template arguments (e.g. ``persistent_kernel<1,1,0>``), from a build
    log's ptxas lines."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"(?:I((?:L[bi]\d+E)+)E)?", ln)
        if m:
            args = re.findall(r"L[bi](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                             spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["regs"] = int(m.group(1))
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build()
    return ctypes.CDLL(str(path))
