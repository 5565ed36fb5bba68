"""The host BVH builder: binned SAH in C++, through ctypes.

Counterpart of ``tpu_pathtracer/native/bvh.py``. ``bvh_builder.cpp`` is the
port's own copy of the repository's ``native/bvh_builder.cpp``, byte for
byte, so the port builds the same trees where the JAX project is absent.
At first use ``g++`` compiles it into ``build/tpu_pathtracer_torch/`` (the
kernels' build directory), into a library named by a hash of the source and
the flags; nothing is written beside the source. There is no fallback: where
``g++`` is missing or the build fails, ``load_library`` raises and says why
(``models/mesh.py::build_bvh(use_native=False)`` is the NumPy median split,
taken only when asked for).

The flags are part of the BVH's contract. The SAH's float costs decide
the splits, so the trees rest on how the compiler rounds them: built with
FMA contraction (GCC contracts by default once the target has FMA, as the
JAX package's ``-march=native`` build on an x86-64 host with FMA does), the
trees equal the JAX package's bit for bit on ``terrain(224)``,
``terrain(32)`` and a 16 x 24 ``uv_sphere``; built with
``-ffp-contract=off`` they differ at leaf size 4. So x86-64 builds take
``-mfma`` (aarch64 has FMA in its base ISA), and never ``-march=native``,
which would make the tree depend on the host.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

from tpu_pathtracer_torch.ops.kernels._build import build_dir

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "bvh_builder.cpp")


def host_flags() -> list[str]:
    flags = ["-O3", "-fPIC", "-std=c++17", "-shared"]
    if platform.machine() in ("x86_64", "AMD64"):
        flags.append("-mfma")
    return flags


def library_path() -> str:
    h = hashlib.sha256(" ".join(host_flags()).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return str(build_dir() / f"libbvh_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the builder if this source and these flags have not been
    built yet; returns the library's path. Raises RuntimeError without
    ``g++`` or when the compile fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the host BVH builder (binned SAH) cannot be "
            "built; build_bvh(..., use_native=False) takes the NumPy median "
            "split, whose trees differ from the JAX package's")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *host_flags(), "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the builder, once per process."""
    lib = ctypes.CDLL(build())
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bvh_build.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        i32p, f32p, f32p, i32p, i32p, i32p, ctypes.c_int,
    ]
    lib.bvh_build.restype = ctypes.c_int
    return lib


def build_arrays(tri_min: np.ndarray, tri_max: np.ndarray,
                 centroid: np.ndarray, leaf_size: int):
    """Run the builder over T triangles' (T, 3) bounds and centroids.
    Returns (order, node_min, node_max, node_skip, node_start, node_count):
    the triangle permutation into leaf order and the threaded DFS nodes.
    Raises RuntimeError where the JAX wrapper returns None (no library, or
    more nodes than 2 T + 16)."""
    lib = load_library()
    T = int(tri_min.shape[0])
    max_nodes = 2 * T + 16
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    order = np.empty((T,), np.int32)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_skip = np.empty((max_nodes,), np.int32)
    node_start = np.empty((max_nodes,), np.int32)
    node_count = np.empty((max_nodes,), np.int32)
    m = lib.bvh_build(tri_min, tri_max, centroid, T, int(leaf_size), order,
                      node_min, node_max, node_skip, node_start, node_count,
                      max_nodes)
    if m < 0:
        raise RuntimeError(f"bvh_build: more than {max_nodes} nodes for {T} "
                           "triangles")
    return (order, node_min[:m].copy(), node_max[:m].copy(),
            node_skip[:m].copy(), node_start[:m].copy(),
            node_count[:m].copy())
