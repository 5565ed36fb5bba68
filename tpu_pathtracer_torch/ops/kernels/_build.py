"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``tpu_pathtracer_torch/csrc/*.cu`` into one shared
library with a plain C interface, for ``sm_90a`` (Hopper), at first use. The
library lands in ``build/tpu_pathtracer_torch/`` beside the package, named by
a hash of the sources, so an edited source rebuilds and an unchanged one
loads at once. It is loaded with ``ctypes``; no PyTorch header is compiled,
so a build takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    return _PKG.parent / "build" / "tpu_pathtracer_torch"


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libtpt_kernels_{h.hexdigest()[:16]}.so"


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


def nvcc_command(nvcc: str, srcs: list[Path], output: Path) -> list[str]:
    """Route (b) of a kernel build: a shared library with a C interface."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(output),
            *(str(s) for s in srcs)]


def build() -> tuple[Path, float]:
    """Compile the library if this source hash has not been built yet.
    Returns (library path, seconds spent compiling). The compiler's output
    (including ptxas register counts) is kept next to the library as
    ``<name>.log``."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.so.tmp")
    cmd = nvcc_command(find_nvcc(), sources(), tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build()
    return ctypes.CDLL(str(path))
