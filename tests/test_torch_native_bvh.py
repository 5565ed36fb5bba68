"""The port's host SAH builder against the JAX package's.

``tpu_pathtracer_torch/native/bvh.py`` builds its own copy of
``bvh_builder.cpp`` with g++ into ``build/tpu_pathtracer_torch/`` and must
give the JAX package's trees (``tpu_pathtracer/native/bvh.py``, the
committed ``native/libbvh.so``) bit for bit: the SAH's float costs decide
the splits, so this holds the build flags too. No Pallas call.
"""
from __future__ import annotations

import os
import platform
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pathtracer.models import mesh as jmesh, meshes as jmeshes  # noqa: E402
from tpu_pathtracer.native import bvh as jbvh  # noqa: E402
from tpu_pathtracer_torch.models import mesh as tmesh, meshes as tmeshes  # noqa: E402
from tpu_pathtracer_torch.native import bvh as tbvh  # noqa: E402
from tpu_pathtracer_torch.ops.kernels import _build  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {
    "terrain224": lambda m: m.terrain(224),
    "terrain32": lambda m: m.terrain(32),
    "uv_sphere": lambda m: m.uv_sphere([0, 3, 0], 2.0, 16, 24),
}


@pytest.fixture(scope="module")
def geometry():
    """Each mesh from both packages' builders (which must agree), and its
    triangles' bounds and centroids as the builders receive them."""
    out = {}
    for name, make in MESHES.items():
        v, f, uv = make(tmeshes)
        for a, b in zip((v, f, uv), make(jmeshes)):
            np.testing.assert_array_equal(a, b)
        tri = v[f]
        lo, hi = tri.min(axis=1), tri.max(axis=1)
        out[name] = dict(v=v, f=f, uv=uv, lo=lo.astype(np.float32),
                         hi=hi.astype(np.float32),
                         c=((lo + hi) * 0.5).astype(np.float32))
    return out


@pytest.mark.parametrize("leaf", [4, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_arrays_match_jax(geometry, name, leaf):
    g = geometry[name]
    want = jbvh.build_arrays(g["lo"], g["hi"], g["c"], leaf)
    assert want is not None, "the JAX package's native builder did not load"
    got = tbvh.build_arrays(g["lo"], g["hi"], g["c"], leaf)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf", [4, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_matches_jax(geometry, name, leaf):
    """build_bvh's default, the SAH builder, gives every MeshData array of
    JAX's build_bvh."""
    g = geometry[name]
    jm = jmesh.build_bvh(g["v"], g["f"], g["uv"], 0, leaf_size=leaf)
    tm = tmesh.build_bvh(g["v"], g["f"], g["uv"], 0, leaf_size=leaf,
                         device="cpu")
    for f in tmesh.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert (tm.num_tris, tm.num_nodes, tm.leaf_size) == (
        jm.num_tris, jm.num_nodes, jm.leaf_size)


def test_sah_is_not_the_median_split(geometry):
    """The default and use_native=False are different trees (the median
    split fills a complete tree)."""
    g = geometry["terrain32"]
    sah = tmesh.build_bvh(g["v"], g["f"], g["uv"], 0, device="cpu")
    med = tmesh.build_bvh(g["v"], g["f"], g["uv"], 0, use_native=False,
                          device="cpu")
    assert sah.num_nodes != med.num_nodes


def test_source_copy_and_build_place():
    """The port builds its own byte-identical copy of the source, into the
    kernels' build directory, named by the source and flags, with FMA
    contraction and without -march=native."""
    assert Path(tbvh.SOURCE).read_bytes() == (
        REPO / "native" / "bvh_builder.cpp").read_bytes()
    lib = Path(tbvh.library_path())
    assert lib.parent == _build.build_dir()
    assert lib.name.startswith("libbvh_") and lib.suffix == ".so"
    flags = tbvh.host_flags()
    assert not any(f.startswith("-march") for f in flags)
    assert ("-mfma" in flags) == (platform.machine() in ("x86_64", "AMD64"))
    assert tbvh.build() == str(lib) and lib.is_file()


def test_no_quiet_fallback(monkeypatch, tmp_path, geometry):
    """Without g++, or when the compile fails, the builder raises and names
    the cause; build_bvh raises too rather than take the median split."""
    monkeypatch.setattr(tbvh, "library_path",
                        lambda: str(tmp_path / "libbvh_x.so"))
    monkeypatch.setattr(tbvh.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbvh.build()
    monkeypatch.undo()

    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbvh, "SOURCE", str(bad))
    monkeypatch.setattr(tbvh, "library_path",
                        lambda: str(tmp_path / "libbvh_y.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbvh.build()
    assert os.listdir(tmp_path) == ["bvh_builder.cpp"]  # no library left

    def refuse():
        raise RuntimeError("no builder")

    monkeypatch.setattr(tbvh, "load_library", refuse)
    g = geometry["uv_sphere"]
    with pytest.raises(RuntimeError, match="no builder"):
        tmesh.build_bvh(g["v"], g["f"], g["uv"], 0, device="cpu")
