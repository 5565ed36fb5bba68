"""Packed mesh layouts and the wavefront's mesh queries (host side).

Counterpart of ``tpu_pathtracer/ops/pallas/mesh_kernel.py``:

* ``PackedMesh`` / ``pack_mesh``: the fine layout (16-float triangle slots
  ``v0 e1 e2 | material | uv0 uv_e1 uv_e2``, 8 slots per 128-float row,
  every leaf starting on a row, one leaf block of tail padding), which the
  TPU kernels walk and so the plain versions of kernel 5 (``packet_ref``)
  and of the persistent kernels (``ops/kernels/_walk.py::mesh_walk_ref``);
  and with ``nodes_only=True``
  the coarse tree of the two-pass traversal: its leaf cells as flat tables
  and, with ``fine_leaf``, each coarse node's subtree as a fine-tree node
  range;
* ``PackedBvh`` / ``pack_bvh``: the MeshData tree itself (leaves of a few
  triangles; one leaf for a mesh of at most 40), as 32-byte skip-link
  nodes and unpadded triangle slots, which the kernels walk per thread
  (the persistent kernels' ``csrc/pt_common.cuh::bvh_walk``, plain version
  ``ops/kernels/_walk.py::bvh_walk_ref``; kernel 5);
* ``intersect_mesh_packet``: the closest-hit or any-hit query of a ray wave,
  with ``t_init`` pruning, the in-call coherence sort, and the two-pass
  binned traversal (``bin_rays`` maps every ray to the coarse cell it enters
  nearest; rays sort by (cell, octant, depth), and rays that enter no cell
  before ``t_init`` are culled);
* kernel 5, the per-ray walk of ``pack_bvh``'s tree through the wave's
  permutation (``csrc/packet.cu``, which replaces ``_packet_kernel``; plain
  version ``packet_bvh_ref``), and kernel 6, the coarse tree's walk to the
  nearest cell, with the two-pass sort key (``csrc/bin.cu``, which
  replaces ``_bin_kernel``; plain versions ``bin_rays_ref``, the TPU
  kernel's sweep and the contract, and ``bin_tree_ref``, the walk). A
  CUDA tensor goes to the kernel, anything else but a CPU tensor raises.
  A CPU tensor goes to ``bin_rays_ref`` (and ``bin_sort_key``) and, for the
  packet query, to ``packet_ref`` on the 64-leaf tree, the TPU kernel's own
  contract, which kernel 5 is also held to on the card (by triangle id; the
  two trees can part only on near ties). ``packet_launches`` and
  ``bin_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch import Tensor

from tpu_pathtracer_torch.models.mesh import MeshData

LANES = 128
BIG = 1e30
TRIS_PER_ROW = 8
TRI_STRIDE = 16  # floats per triangle slot
MAX_NODES = 1 << 24  # node ids travel as exact f32 integers in pack_mesh
# pack_bvh: a mesh of at most BVH_MAX_LEAF triangles packs as one leaf (on
# the card one leaf was the faster at 36 triangles, the tree from 50:
# ``chip_smoke.py --leaf-cutoff``); a leaf's first triangle and count share
# an int32 (LEAF_BITS and the rest)
BVH_MAX_LEAF = 40
LEAF_BITS = 24
# Lanes per chunk of the plain walk's batched leaf tests (bounds its
# (lanes, leaf_size, 16) gather).
_LEAF_CHUNK = 1 << 15
# Shared memory a block may take on the H100 (227 KB, with the opt-in)
SMEM_PER_BLOCK = 232_448

# Kernel launches (plain-version calls are not counted).
packet_launches = 0
bin_launches = 0


@dataclasses.dataclass(frozen=True)
class PackedMesh:
    """Packed layout plus a remap back to MeshData triangle ids. ``boxes``
    and ``meta`` are the node table split as the kernels read it. A coarse
    tree (``pack_mesh(nodes_only=True)``) has no triangles; its leaf cells
    are ``cell_boxes``/``cell_ids`` and, with ``fine_leaf``, ``fine_map``
    holds each coarse node's subtree as a fine-tree node range."""

    nodes: Tensor  # (M, 16) f32: min3 max3 skip start count
    tri_rows: Tensor  # (R, 128) f32
    remap: Tensor  # (Tp,) int32 padded slot -> MeshData triangle (-1 pad)
    boxes: Tensor  # (M*6,) f32 node AABBs [min3 max3], flat
    meta: Tensor  # (M*3,) int32 [skip start count], flat
    leaf_size: int = 32
    num_nodes: int = 0
    fine_map: Tensor | None = None  # (M, 2) int32 [fine_start, fine_skip)
    cell_boxes: Tensor | None = None  # (C*6,) f32 leaf-cell AABBs, DFS order
    cell_ids: Tensor | None = None  # (C,) int32 leaf-cell node ids
    # a coarse tree's walk table (``_walk_table``) and its sort-key scale,
    # 64 / clamp_min(root diagonal, 1e-6), a 0-dim f32 tensor
    walk_nodes: Tensor | None = None  # (M, 8) f32: min3 skip | max3 leaf
    key_scale: Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def to(self, device) -> "PackedMesh":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("nodes", "tri_rows", "remap", "boxes",
                               "meta", "fine_map", "cell_boxes", "cell_ids",
                               "walk_nodes", "key_scale")
                     if getattr(self, f) is not None})


def _collapse_subtrees(node_start, node_count, node_skip, node_min,
                       node_max, collapse_leaf: int):
    """Collapse every BVH subtree holding <= collapse_leaf triangles into a
    single leaf node.

    Works on the threaded-DFS arrays: node i's subtree is the contiguous DFS
    range [i, skip_i), and the builder assigns leaf triangle ranges left to
    right, so a subtree's triangles are the contiguous range
    [first-leaf start, last-leaf start + count).
    """
    M = len(node_start)
    pre = np.zeros(M + 1, np.int64)  # prefix sum of leaf counts over DFS
    np.cumsum(node_count, out=pre[1:])
    # first leaf triangle-start at or after each DFS position
    first_start = np.full(M + 1, -1, np.int64)
    nxt = -1
    for i in range(M - 1, -1, -1):
        if node_count[i] > 0:
            nxt = node_start[i]
        first_start[i] = nxt

    sub_count = pre[node_skip] - pre[np.arange(M)]
    out = []  # (min, max, old_skip, start, count)
    kept_orig = []  # original DFS index of each emitted node
    old2new = np.full(M + 1, -1, np.int64)
    i = 0
    while i < M:
        old2new[i] = len(out)
        kept_orig.append(i)
        sc = sub_count[i]
        if 0 < sc <= collapse_leaf:
            out.append((node_min[i], node_max[i], node_skip[i],
                        first_start[i], sc))
            i = int(node_skip[i])  # the whole subtree becomes this leaf
        else:
            out.append((node_min[i], node_max[i], node_skip[i],
                        node_start[i], node_count[i]))
            i += 1
    old2new[M] = len(out)
    new_min = np.stack([o[0] for o in out])
    new_max = np.stack([o[1] for o in out])
    old_skips = np.asarray([o[2] for o in out], np.int64)
    new_skip = old2new[old_skips]
    assert (new_skip >= 0).all(), "collapsed skip target not emitted"
    new_start = np.asarray([o[3] for o in out], np.int64)
    new_count = np.asarray([o[4] for o in out], np.int64)
    return (new_start, new_count, new_skip, new_min, new_max,
            old2new, np.asarray(kept_orig, np.int64), old_skips)


def _tri_slots(mesh: MeshData, tri_ids: np.ndarray) -> np.ndarray:
    """(len(tri_ids), 16) f32 slots ``v0 e1 e2 | material | uv0 uv_e1
    uv_e2`` of the mesh's triangles ``tri_ids`` (-1: a zero pad slot)."""
    v0, e1, e2 = (getattr(mesh, f).cpu().numpy() for f in ("v0", "e1", "e2"))
    mat = mesh.material_id.cpu().numpy()
    uv0, uve1, uve2 = (getattr(mesh, f).cpu().numpy()
                       for f in ("uv0", "uv_e1", "uv_e2"))
    slots = np.zeros((len(tri_ids), TRI_STRIDE), np.float32)
    valid = tri_ids >= 0
    src = np.clip(tri_ids, 0, max(len(v0) - 1, 0))
    slots[:, 0:3] = np.where(valid[:, None], v0[src], 0.0)
    slots[:, 3:6] = np.where(valid[:, None], e1[src], 0.0)
    slots[:, 6:9] = np.where(valid[:, None], e2[src], 0.0)
    slots[:, 9] = np.where(valid, mat[src].astype(np.float32), 0.0)
    slots[:, 10:12] = np.where(valid[:, None], uv0[src], 0.0)
    slots[:, 12:14] = np.where(valid[:, None], uve1[src], 0.0)
    slots[:, 14:16] = np.where(valid[:, None], uve2[src], 0.0)
    return slots


def pack_mesh(mesh: MeshData, collapse_leaf: int = 64,
              nodes_only: bool = False,
              fine_leaf: int | None = None) -> PackedMesh:
    """Re-pack a built MeshData for the kernels (leaf-aligned triangles), on
    the mesh's device. Subtrees of up to ``collapse_leaf`` triangles fold
    into one leaf. ``nodes_only`` packs the coarse tree of the two-pass
    traversal instead (no triangles; use a large ``collapse_leaf``, ~1024),
    and ``fine_leaf`` adds its ``fine_map`` onto the tree that
    ``collapse_leaf=fine_leaf`` packs (the JAX kernel's hint table, packed
    as JAX packs it; the port's kernels do not read it)."""
    arrays = [getattr(mesh, f).cpu().numpy() for f in (
        "node_start", "node_count", "node_skip", "node_min", "node_max")]
    node_start, node_count, node_skip, node_min, node_max = arrays
    dev = mesh.v0.device
    kept_orig = old_skips = None
    if collapse_leaf and mesh.num_nodes:
        (node_start, node_count, node_skip, node_min,
         node_max, _o2n, kept_orig, old_skips) = _collapse_subtrees(
            node_start, node_count, node_skip, node_min, node_max,
            collapse_leaf)
    if nodes_only:
        return _pack_coarse(arrays, node_start, node_count, node_skip,
                            node_min, node_max, kept_orig, old_skips,
                            fine_leaf, dev)
    M = len(node_start)  # post-collapse node count
    leaf_size = int(node_count.max()) if M else 0

    new_start = np.zeros(M, np.int64)
    tri_blocks = []
    cursor = 0
    for n in range(M):
        c = node_count[n]
        if c == 0:
            continue
        pad = (-cursor) % TRIS_PER_ROW  # align the leaf to a row
        if pad:
            tri_blocks.append(np.full((pad,), -1, np.int64))
            cursor += pad
        new_start[n] = cursor
        tri_blocks.append(np.arange(node_start[n], node_start[n] + c))
        cursor += c
    tri_ids = (np.concatenate(tri_blocks) if tri_blocks
               else np.zeros((0,), np.int64))
    # tail padding: row-align, plus one full leaf block, so a fixed
    # leaf-rows read never runs past the buffer
    leaf_rows_pad = max(1, -(-leaf_size // TRIS_PER_ROW)) * TRIS_PER_ROW
    pad_tail = (-len(tri_ids)) % TRIS_PER_ROW + leaf_rows_pad
    tri_ids = np.concatenate([tri_ids, np.full(pad_tail, -1, np.int64)])
    Tp = len(tri_ids)

    valid = tri_ids >= 0
    slots = _tri_slots(mesh, tri_ids)
    tri_rows = slots.reshape(Tp // TRIS_PER_ROW, TRIS_PER_ROW * TRI_STRIDE)

    nodes = np.zeros((M, 16), np.float32)
    nodes[:, 0:3] = node_min
    nodes[:, 3:6] = node_max
    nodes[:, 6] = node_skip
    nodes[:, 7] = new_start
    nodes[:, 8] = node_count

    return PackedMesh(
        nodes=torch.tensor(nodes, device=dev),
        tri_rows=torch.tensor(tri_rows, device=dev),
        remap=torch.tensor(np.where(valid, tri_ids, -1).astype(np.int32),
                           device=dev),
        boxes=torch.tensor(nodes[:, 0:6].reshape(-1), device=dev),
        meta=torch.tensor(nodes[:, 6:9].astype(np.int32).reshape(-1),
                          device=dev),
        leaf_size=leaf_size,
        num_nodes=M,
    )


def _pack_coarse(arrays, node_start, node_count, node_skip, node_min,
                 node_max, kept_orig, old_skips, fine_leaf, dev
                 ) -> PackedMesh:
    """The nodes-only tree of the two-pass traversal (JAX ``pack_mesh``
    with ``nodes_only=True``): node table, leaf-cell tables, and with
    ``fine_leaf`` the map of each node onto the fine tree's node ranges."""
    M = len(node_start)
    nodes = np.zeros((M, 16), np.float32)
    nodes[:, 0:3] = node_min
    nodes[:, 3:6] = node_max
    nodes[:, 6] = node_skip
    nodes[:, 7] = node_start  # the raw triangle index; the sweep ignores it
    nodes[:, 8] = node_count
    fine_map = None
    if fine_leaf is not None and kept_orig is not None:
        # A node the coarse collapse keeps is kept by the finer collapse
        # too, unless it is finer than fine_leaf: such a node gets no hint.
        o2n_f = _collapse_subtrees(*arrays, fine_leaf)[5]
        fs, fe = o2n_f[kept_orig], o2n_f[old_skips]
        ok = (fs >= 0) & (fe >= 0)
        fine_map = torch.tensor(
            np.stack([np.where(ok, fs, 0), np.where(ok, fe, 0)],
                     axis=1).astype(np.int32), device=dev)
    leaf_sel = np.nonzero(node_count > 0)[0]
    nodes_t = torch.tensor(nodes, device=dev)
    root = nodes_t[0] if M else torch.zeros(16, device=dev)
    diag = torch.sqrt(torch.sum((root[3:6] - root[0:3]) ** 2))
    return PackedMesh(
        nodes=nodes_t,
        tri_rows=torch.zeros((1, LANES), dtype=torch.float32, device=dev),
        remap=torch.full((1,), -1, dtype=torch.int32, device=dev),
        boxes=torch.tensor(nodes[:, 0:6].reshape(-1), device=dev),
        meta=torch.tensor(nodes[:, 6:9].astype(np.int32).reshape(-1),
                          device=dev),
        leaf_size=int(node_count.max()) if M else 0,
        num_nodes=M,
        fine_map=fine_map,
        cell_boxes=torch.tensor(
            np.concatenate([node_min[leaf_sel], node_max[leaf_sel]], axis=1)
            .reshape(-1).astype(np.float32), device=dev),
        cell_ids=torch.tensor(leaf_sel.astype(np.int32), device=dev),
        walk_nodes=torch.tensor(
            _walk_table(node_min, node_max, node_skip, node_count),
            device=dev),
        key_scale=64.0 / torch.clamp_min(diag, 1e-6),
    )


def _walk_table(node_min, node_max, node_skip, node_count) -> np.ndarray:
    """(M, 8) f32 table of a coarse tree for the walk of kernel 6 and
    ``bin_tree_ref``: ``min3 skip | max3 leaf``, skip (the node after the
    subtree) and leaf (1 for a cell, a node with triangles) as int32 bits.
    An inner node's box is widened to hold every box of its subtree, so a
    subtree that the walk prunes at its root holds no cell that the sweep
    would take; where the boxes nest already, as ``build_bvh``'s do (each a
    min/max over a subset of its parent's triangles, rounded to f32
    monotonically), this changes nothing."""
    M = len(node_skip)
    lo = np.asarray(node_min, np.float32).copy()
    hi = np.asarray(node_max, np.float32).copy()
    skip = np.asarray(node_skip, np.int64)
    for i in np.nonzero(skip > np.arange(M) + 1)[0]:
        lo[i] = np.minimum(lo[i], lo[i + 1:skip[i]].min(0))
        hi[i] = np.maximum(hi[i], hi[i + 1:skip[i]].max(0))
    table = np.zeros((M, 8), np.float32)
    bits = table.view(np.int32)
    table[:, 0:3], table[:, 4:7] = lo, hi
    bits[:, 3] = skip
    bits[:, 7] = np.asarray(node_count) > 0
    return table


@dataclasses.dataclass(frozen=True)
class PackedBvh:
    """The tree that the persistent kernels walk per thread
    (``csrc/pt_common.cuh::bvh_walk``), packed by ``pack_bvh``: the mesh's
    own tree in DFS order, a node 32 B, two float4: ``min3 skip`` then
    ``max3 leaf``, with ``skip`` (the node after its subtree) and ``leaf``
    int32 bits; ``leaf`` is ``first | count << LEAF_BITS`` for a leaf of
    ``count`` triangles from slot ``first``, 0 for an inner node (its first
    child is the next node). Triangles are 16-float slots in MeshData
    order, unpadded, so a slot's index is its MeshData triangle id."""

    nodes: Tensor  # (N, 8) f32
    tris: Tensor  # (T, 16) f32
    num_nodes: int = 0
    max_leaf: int = 0  # triangles in the largest leaf

    @property
    def links(self) -> Tensor:
        """(N, 3) int64: skip, first triangle, triangle count (0: inner)."""
        bits = self.nodes.view(torch.int32)
        leaf = bits[:, 7].to(torch.int64)
        return torch.stack([bits[:, 3].to(torch.int64),
                            leaf & ((1 << LEAF_BITS) - 1),
                            leaf >> LEAF_BITS], 1)

    def to(self, device) -> "PackedBvh":
        return dataclasses.replace(self, nodes=self.nodes.to(device),
                                   tris=self.tris.to(device))


def pack_bvh(mesh: MeshData, one_leaf: int = BVH_MAX_LEAF) -> PackedBvh:
    """Pack a built MeshData's tree (threaded DFS, leaves of contiguous
    triangles, a few each) for the kernels' per-thread walk, on the mesh's
    device. A mesh of at most ``one_leaf`` triangles packs as one leaf:
    every ray of a warp then tests the same triangles in step, which beats
    walking its small-leaf tree (the Cornell meshes, 36-38 triangles). A
    larger mesh, and every mesh with ``one_leaf=0``, keeps its own leaves.
    Raises ValueError for an empty mesh,
    ``MAX_NODES`` or more nodes, or a leaf that its int32 cannot hold
    (first triangle from ``1 << LEAF_BITS``, or 128 triangles or more)."""
    arrays = [getattr(mesh, f).cpu().numpy() for f in (
        "node_start", "node_count", "node_skip", "node_min", "node_max")]
    T = mesh.num_tris
    if len(arrays[0]) == 0 or T == 0:
        raise ValueError("pack_bvh: the mesh has no triangles")
    if T <= one_leaf:
        arrays = _collapse_subtrees(*arrays, T)[:5]
    start, count, skip = (np.asarray(a, np.int64) for a in arrays[:3])
    N = len(start)
    if N >= MAX_NODES:
        raise ValueError(f"pack_bvh: the kernels' walk takes fewer than "
                         f"{MAX_NODES} nodes, got {N}")
    leaf = count > 0
    if ((start + count > T) & leaf).any():
        raise ValueError("pack_bvh: a leaf runs past the triangles")
    if (leaf & ((start >= 1 << LEAF_BITS)
                | (count >= 1 << (31 - LEAF_BITS)))).any():
        raise ValueError(f"pack_bvh: a leaf's first triangle must be below "
                         f"{1 << LEAF_BITS} and its count below "
                         f"{1 << (31 - LEAF_BITS)}")
    nodes = np.zeros((N, 8), np.float32)
    bits = nodes.view(np.int32)
    nodes[:, 0:3] = arrays[3]
    nodes[:, 4:7] = arrays[4]
    bits[:, 3] = skip
    bits[:, 7] = np.where(leaf, start | count << LEAF_BITS, 0)
    dev = mesh.v0.device
    return PackedBvh(
        nodes=torch.tensor(nodes, device=dev),
        tris=torch.tensor(_tri_slots(mesh, np.arange(T)), device=dev),
        num_nodes=N, max_leaf=int(count.max()))


# ---------------------------------------------------------------------------
# Plain PyTorch versions of kernels 5 and 6
# ---------------------------------------------------------------------------

def _safe_inv(a: Tensor) -> Tensor:
    """1/a with |a| clamped to 1e-12, keeping its sign (slab tests of
    axis-parallel rays)."""
    s = torch.where(torch.abs(a) > 1e-12, a,
                    torch.where(a >= 0, 1e-12, -1e-12))
    return 1.0 / s


def _slab(b: Tensor, ox, oy, oz, ix, iy, iz) -> tuple[Tensor, Tensor]:
    """(tn, tf) of rays against boxes b (..., 6) [min3 max3], in the
    kernels' operation order."""
    tx0 = (b[..., 0] - ox) * ix
    tx1 = (b[..., 3] - ox) * ix
    ty0 = (b[..., 1] - oy) * iy
    ty1 = (b[..., 4] - oy) * iy
    tz0 = (b[..., 2] - oz) * iz
    tz1 = (b[..., 5] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                     torch.minimum(ty0, ty1)),
                       torch.minimum(tz0, tz1))
    tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                     torch.maximum(ty0, ty1)),
                       torch.maximum(tz0, tz1))
    return tn, tf


def bin_rays_ref(coarse: PackedMesh, o: Tensor, d: Tensor, t_init: Tensor,
                 tmin: float, counts: dict | None = None
                 ) -> tuple[Tensor, Tensor]:
    """Plain version of kernel 6, the TPU kernel's sweep over the cells:
    per ray, the coarse leaf cell whose box it enters nearest (clamped
    entry distance; ties to the first cell in DFS order) among cells
    entered before ``t_init``, and that distance. Lanes with ``t_init <=
    0`` or no such cell get (-1, BIG). ``counts['cells']`` adds the cell
    tests of live lanes."""
    live = t_init > 0.0
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    ix, iy, iz = (_safe_inv(d[:, k]) for k in range(3))
    boxes = coarse.cell_boxes.reshape(-1, 6)
    best = torch.full_like(t_init, BIG)
    cell = torch.full(t_init.shape, -1, dtype=torch.int32, device=o.device)
    for c in range(boxes.shape[0]):
        tn, tf = _slab(boxes[c], ox, oy, oz, ix, iy, iz)
        tn_eff = torch.clamp_min(tn, 0.0)
        better = (live & (tn <= tf) & (tf > tmin)
                  & (tn < torch.minimum(t_init, best)) & (tn_eff < best))
        best = torch.where(better, tn_eff, best)
        cell = torch.where(better, coarse.cell_ids[c], cell)
    if counts is not None:
        counts["cells"] = (counts.get("cells", 0)
                           + int(live.sum()) * boxes.shape[0])
    return cell, best


def bin_tree_ref(coarse: PackedMesh, o: Tensor, d: Tensor, t_init: Tensor,
                 tmin: float, counts: dict | None = None
                 ) -> tuple[Tensor, Tensor]:
    """Plain version of kernel 6's walk: ``bin_rays_ref``'s answer, found by
    a stackless DFS walk of the coarse tree (``coarse.walk_nodes``) per
    lane. A node whose box fails the sweep's predicate prunes its subtree
    (the walk jumps to its skip link); a cell that passes it becomes the
    lane's best. A child's slab interval lies inside its parent's (the
    boxes nest, and (b - o) * inv is monotone in b under rounding), so a
    pruned subtree holds no cell that would pass, and the cells are met in
    the sweep's (DFS) order: the answer is the sweep's bit for bit.
    ``counts['nodes']`` and ``counts['cells']`` add the inner-node and cell
    tests of live lanes."""
    table = coarse.walk_nodes
    M = table.shape[0]
    bits = table.view(torch.int32)
    boxes = torch.cat([table[:, 0:3], table[:, 4:7]], 1)
    skip, leaf = bits[:, 3].to(torch.int64), bits[:, 7] != 0
    live = t_init > 0.0
    ix, iy, iz = (_safe_inv(d[:, k]) for k in range(3))
    best = torch.full_like(t_init, BIG)
    cell = torch.full(t_init.shape, -1, dtype=torch.int32, device=o.device)
    node = torch.where(live, 0, M).to(torch.int64)
    n_nodes = n_cells = 0
    while True:
        lane = torch.nonzero(node < M).squeeze(1)
        if lane.numel() == 0:
            break
        k = node[lane]
        tn, tf = _slab(boxes[k], o[lane, 0], o[lane, 1], o[lane, 2],
                       ix[lane], iy[lane], iz[lane])
        tn_eff = torch.clamp_min(tn, 0.0)
        b = best[lane]
        ok = ((tn <= tf) & (tf > tmin)
              & (tn < torch.minimum(t_init[lane], b)) & (tn_eff < b))
        is_leaf = leaf[k]
        take = ok & is_leaf
        best[lane] = torch.where(take, tn_eff, b)
        cell[lane] = torch.where(take, k.to(torch.int32), cell[lane])
        node[lane] = torch.where(ok & ~is_leaf, k + 1, skip[k])
        if counts is not None:
            c = int(is_leaf.sum())
            n_cells += c
            n_nodes += lane.numel() - c
    if counts is not None:
        counts["nodes"] = counts.get("nodes", 0) + n_nodes
        counts["cells"] = counts.get("cells", 0) + n_cells
    return cell, best


def bin_sort_key(cell: Tensor, tn: Tensor, d: Tensor, scale: Tensor
                 ) -> Tensor:
    """The two-pass traversal's sort key per ray from its bin (cell, tn):
    ``((cell * 8 + octant) << 6) | tq``, tq = tn * scale clamped to [0, 63]
    as int32 (``scale``: the coarse tree's ``key_scale``), or ``1 << 26``
    for a ray without a cell (dead lanes included). Kernel 6 writes the
    same key in its launch."""
    tq = torch.clamp(tn * scale, 0.0, 63.0).to(torch.int32)
    return torch.where(cell >= 0, ((cell * 8 + _octant(d)) << 6) | tq,
                       1 << 26)


def _mt_terms(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z, e2x,
              e2y, e2z):
    """Moller-Trumbore's determinant and the numerators of u, v and t, in
    the kernel's operation order (u = nu / det, v = nv / det, t = nt /
    det)."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    return (det, tvx * px + tvy * py + tvz * pz, dx * qx + dy * qy + dz * qz,
            e2x * qx + e2y * qy + e2z * qz)


def _leaf_tests(slots: Tensor, leaf_size: int, start: Tensor, count: Tensor,
                o: Tensor, d: Tensor, t: Tensor, tmin: float
                ) -> tuple[Tensor, Tensor, Tensor]:
    """Moller-Trumbore of rays (A,) against their leaves' triangles, in the
    kernel's operation order: (any valid, closest t, its slot). The kernel
    tests a leaf in slot order with strict < updates, which keeps the first
    slot of the smallest t; so does argmin over the valid t."""
    j = torch.arange(leaf_size, device=o.device)
    rows = slots[start[:, None] + j]  # (A, J, 16)
    det, nu, nv, nt = _mt_terms(*(o[:, k, None] for k in range(3)),
                                *(d[:, k, None] for k in range(3)),
                                *(rows[..., k] for k in range(9)))
    inv_det = 1.0 / det  # det = 0 gives inf/NaN, which every compare rejects
    uu, vv, tt = nu * inv_det, nv * inv_det, nt * inv_det
    valid = ((j[None, :] < count[:, None]) & (uu >= 0.0) & (vv >= 0.0)
             & (uu + vv <= 1.0) & (tt > tmin) & (tt < t[:, None]))
    tt = torch.where(valid, tt, torch.inf)
    jmin = torch.argmin(tt, dim=1)
    return (valid.any(dim=1), tt.gather(1, jmin[:, None])[:, 0],
            start + jmin)


def _walk_ref(packed: PackedMesh, lanes: Tensor, o: Tensor, d: Tensor,
              inv: Tensor, t: Tensor, slot: Tensor, tmin: float,
              any_hit: bool, counts: dict | None) -> None:
    """Advance every lane in ``lanes`` one node per step through the
    skip-link tree from the root to its end, updating t and slot in
    place."""
    M = packed.num_nodes
    boxes = packed.boxes.reshape(M, 6)
    meta = packed.meta.reshape(M, 3).to(torch.int64)
    slots = packed.tri_rows.reshape(-1, TRI_STRIDE)
    node = torch.zeros_like(lanes)
    while lanes.numel():
        keep = node < M
        lanes, node = lanes[keep], node[keep]
        if not lanes.numel():
            break
        lo, ld, li, lt = o[lanes], d[lanes], inv[lanes], t[lanes]
        tn, tf = _slab(boxes[node], lo[:, 0], lo[:, 1], lo[:, 2],
                       li[:, 0], li[:, 1], li[:, 2])
        box_hit = (tn <= tf) & (tf > tmin) & (tn < lt)
        if any_hit:
            box_hit &= lt > 0.0
        m = meta[node]
        skip, start, count = m[:, 0], m[:, 1], m[:, 2]
        leaf = torch.nonzero(box_hit & (count > 0))[:, 0]
        if counts is not None:
            counts["nodes"] = counts.get("nodes", 0) + lanes.numel()
            counts["tris"] = counts.get("tris", 0) + int(count[leaf].sum())
        done = torch.zeros_like(box_hit)
        for c0 in range(0, leaf.numel(), _LEAF_CHUNK):
            sub = leaf[c0:c0 + _LEAF_CHUNK]
            g = lanes[sub]
            hit, tt, ss = _leaf_tests(slots, packed.leaf_size, start[sub],
                                      count[sub], lo[sub], ld[sub], lt[sub],
                                      tmin)
            if any_hit:
                t[g] = torch.where(hit, 0.0, t[g])
                done[sub] = hit
            else:
                t[g] = torch.where(hit, tt, t[g])
                slot[g] = torch.where(hit, ss, slot[g])
        node = torch.where(box_hit & (count == 0), node + 1, skip)
        # an occluded lane's boxes all fail from here on: retire it
        node = torch.where(done, M, node)


def _attributes(slots: Tensor, o: Tensor, d: Tensor, slot: Tensor,
                found: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Normal, uv and material of the winning slot of the (S, 16) slot
    table, resolved after the walk (the JAX package's ``defer_attrs``
    route), 0 where nothing was found: the geometric normal cross(e1, e2)
    normalized, the uv from the barycentrics, in the kernel's operation
    order."""
    row = slots[slot]
    e1x, e1y, e1z = row[:, 3], row[:, 4], row[:, 5]
    e2x, e2y, e2z = row[:, 6], row[:, 7], row[:, 8]
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    nlen = torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-20))
    det, nu, nv, _ = _mt_terms(*(o[:, k] for k in range(3)),
                               *(d[:, k] for k in range(3)),
                               *(row[:, k] for k in range(9)))
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    uu, vv = nu * inv_det, nv * inv_det
    f = found[:, None]
    n = torch.where(f, torch.stack([nx / nlen, ny / nlen, nz / nlen], -1), 0.0)
    uv = torch.where(f, torch.stack([row[:, 10] + uu * row[:, 12]
                                     + vv * row[:, 14],
                                     row[:, 11] + uu * row[:, 13]
                                     + vv * row[:, 15]], -1), 0.0)
    mat = torch.where(found, row[:, 9].to(torch.int32), 0)
    return n, uv, mat


def packet_ref(packed: PackedMesh, o: Tensor, d: Tensor, t_init: Tensor,
               tmin: float, any_hit: bool = False,
               counts: dict | None = None):
    """Plain version of kernel 5: every live lane (``t_init > 0``) walks the
    fine tree from t = t_init, descending a node whose box it enters before
    its current t, testing a leaf's triangles with Moller-Trumbore and
    keeping a strictly closer hit; ``any_hit`` stops at the first one with
    t = 0. Returns (t, slot, n, uv, mat): t is 0 on dead lanes and t_init
    where nothing is closer; the attributes are 0 where no closer hit was
    found and in ``any_hit``. ``counts`` adds nodes entered, triangles
    tested and hits found (whose attributes are resolved)."""
    N = o.shape[0]
    live = t_init > 0.0
    t = torch.where(live, t_init, 0.0)
    slot = torch.zeros(N, dtype=torch.int64, device=o.device)
    _walk_ref(packed, torch.nonzero(live)[:, 0], o, d, _safe_inv(d), t, slot,
              tmin, any_hit, counts)
    found = live & (t < t_init)
    if any_hit:
        found = torch.zeros_like(found)
    if counts is not None:
        counts["found"] = counts.get("found", 0) + int(found.sum())
    n, uv, mat = _attributes(packed.tri_rows.reshape(-1, TRI_STRIDE), o, d,
                             slot, found)
    return t, torch.where(found, slot, 0).to(torch.int32), n, uv, mat


def packet_bvh_ref(bvh: PackedBvh, o: Tensor, d: Tensor, t_init: Tensor,
                   tmin: float, any_hit: bool = False,
                   counts: dict | None = None):
    """Plain version of kernel 5 as it runs on the card: every live lane
    (``t_init > 0``) walks ``pack_bvh``'s tree from t = t_init through
    ``ops/kernels/_walk.py::bvh_walk_ref`` (the robust box test, a leaf's
    triangles in order, strictly closer wins; ``any_hit`` stops at the
    first one with t = 0), and the winner's attributes are resolved as
    ``packet_ref`` resolves them. Returns (t, tri, n, uv, mat) as
    ``packet_ref`` does, with tri the MeshData triangle id (``pack_bvh``'s
    slots are in MeshData order). ``counts`` adds ``bvh_walk_ref``'s
    segments, boxes and tris, and hits found."""
    from tpu_pathtracer_torch.ops.kernels._walk import bvh_walk_ref

    live = t_init > 0.0
    t0 = torch.where(live, t_init, 0.0)
    planes = (*o.unbind(1), *d.unbind(1))
    if any_hit:
        t = bvh_walk_ref(bvh, *planes, t0, occlusion=True, tmin=tmin,
                         counts=counts)
        found = torch.zeros_like(live)
        tri = torch.zeros_like(t, dtype=torch.int64)
    else:
        t, *_, tri = bvh_walk_ref(bvh, *planes, t0, with_tri=True, tmin=tmin,
                                  counts=counts)
        found = live & (t < t_init)
    if counts is not None:
        counts["found"] = counts.get("found", 0) + int(found.sum())
    n, uv, mat = _attributes(bvh.tris, o, d, tri.clamp_min(0), found)
    return t, torch.where(found, tri, 0).to(torch.int32), n, uv, mat


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _kernels():
    """The bound C entry points of csrc/packet.cu and csrc/bin.cu."""
    from tpu_pathtracer_torch.ops.kernels import _build

    lib = _build.load_library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    packet = lib.tpt_packet
    packet.argtypes = [p, p, p, p,  # o (N,3), d (N,3), t_init (N,), perm
                       p, p, i,  # pack_bvh nodes, triangle slots, n_nodes
                       i, f, i,  # n, tmin, any_hit
                       p, p, p, p, p,  # t, slot, n (N,3), uv (N,2), mat
                       p]  # cudaStream_t
    packet.restype = i
    binf = lib.tpt_bin
    binf.argtypes = [p, p, p,  # o, d, t_init
                     p, i,  # walk table (M, 8), M
                     i, f, p,  # n, tmin, key_scale (device scalar)
                     p, p, p,  # cell (N,) int32, tn (N,), key (N,) int32
                     i, p]  # the grid's most blocks, cudaStream_t
    binf.restype = i
    lib.tpt_error_string.argtypes = [i]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return packet, binf, lib.tpt_error_string


def _checked(t: Tensor, name: str, dtype, shape: tuple, dev) -> Tensor:
    """t as a contiguous tensor of dtype on dev, shape checked."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want a {dtype} tensor of shape {shape} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def _raise_on(err: int, what: str, error_string) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{error_string(err).decode()} ({err})")


def _packet_cuda(bvh, o, d, t_init, tmin, any_hit, perm):
    global packet_launches
    dev = o.device
    N = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    M = bvh.num_nodes
    o = _checked(o, "o", f32, (N, 3), dev)
    d = _checked(d, "d", f32, (N, 3), dev)
    t_init = _checked(t_init, "t_init", f32, (N,), dev)
    if perm is not None:
        perm = _checked(perm, "perm", i32, (N,), dev)
    nodes = _checked(bvh.nodes, "bvh nodes", f32, (M, 8), dev)
    tris = _checked(bvh.tris, "bvh tris", f32, (bvh.tris.shape[0], TRI_STRIDE),
                    dev)
    t = torch.empty(N, dtype=f32, device=dev)
    if any_hit:  # the kernel writes t alone: the attributes are zeros
        zf = torch.zeros((), dtype=f32, device=dev)
        zi = torch.zeros((), dtype=i32, device=dev)
        slot, n, uv, mat = (zi.expand(N), zf.expand(N, 3), zf.expand(N, 2),
                            zi.expand(N))
    else:
        slot = torch.empty(N, dtype=i32, device=dev)
        n = torch.empty((N, 3), dtype=f32, device=dev)
        uv = torch.empty((N, 2), dtype=f32, device=dev)
        mat = torch.empty(N, dtype=i32, device=dev)
    if N == 0:
        return t, slot, n, uv, mat
    packet, _, error_string = _kernels()
    outs = [None] * 4 if any_hit else [x.data_ptr() for x in (slot, n, uv,
                                                              mat)]
    with torch.cuda.device(dev):
        err = packet(o.data_ptr(), d.data_ptr(), t_init.data_ptr(),
                     None if perm is None else perm.data_ptr(),
                     nodes.data_ptr(), tris.data_ptr(), M,
                     N, float(tmin), int(any_hit), t.data_ptr(), *outs,
                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "packet kernel", error_string)
    packet_launches += 1
    return t, slot, n, uv, mat


def bin_smem_bytes(n_nodes: int) -> int:
    """Bytes of shared memory that one block of kernel 6 takes: the walk
    table, 32 per node. Raises ValueError past SMEM_PER_BLOCK."""
    nbytes = 32 * n_nodes
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(
            f"kernel 6's walk table of {n_nodes} nodes needs {nbytes} B of "
            f"shared memory; a block may take {SMEM_PER_BLOCK} B")
    return nbytes


@functools.cache
def _bin_grid(device_index: int, n_nodes: int) -> int:
    """Kernel 6's most blocks on one card for a walk table of ``n_nodes``
    nodes: as many as are resident at once, the SMs times the blocks per
    SM that the table's shared memory allows (the card's occupancy
    calculator, asked once per card and table size)."""
    from tpu_pathtracer_torch.ops.kernels import _build

    occupancy = _build.load_library().tpt_bin_occupancy
    occupancy.argtypes = [ctypes.c_int]
    occupancy.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        per_sm = occupancy(n_nodes)
    if per_sm <= 0:
        raise RuntimeError("kernel 6's occupancy query failed")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * per_sm


def _bin_cuda(coarse, o, d, t_init, tmin):
    global bin_launches
    dev = o.device
    N = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    M = coarse.num_nodes
    o = _checked(o, "o", f32, (N, 3), dev)
    d = _checked(d, "d", f32, (N, 3), dev)
    t_init = _checked(t_init, "t_init", f32, (N,), dev)
    table = _checked(coarse.walk_nodes, "walk_nodes", f32, (M, 8), dev)
    scale = _checked(coarse.key_scale, "key_scale", f32, (), dev)
    bin_smem_bytes(M)
    cell = torch.empty(N, dtype=i32, device=dev)
    tn = torch.empty(N, dtype=f32, device=dev)
    key = torch.empty(N, dtype=i32, device=dev)
    if N == 0:
        return cell, tn, key
    _, binf, error_string = _kernels()
    with torch.cuda.device(dev):
        err = binf(o.data_ptr(), d.data_ptr(), t_init.data_ptr(),
                   table.data_ptr(), M, N, float(tmin), scale.data_ptr(),
                   cell.data_ptr(), tn.data_ptr(), key.data_ptr(),
                   _bin_grid(dev.index, M),
                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "bin kernel", error_string)
    bin_launches += 1
    return cell, tn, key


def packet_query(packed: PackedMesh, o: Tensor, d: Tensor, t_init: Tensor,
                 tmin: float, any_hit: bool = False, *,
                 bvh: PackedBvh | None = None, perm: Tensor | None = None):
    """(t, slot, n, uv, mat) as ``packet_ref`` returns them, with slot the
    winner's slot in the tree walked. On CUDA tensors kernel 5 walks
    ``bvh`` (ValueError without it), so slot is the MeshData triangle id;
    ``perm`` (int32, a permutation of the lanes) is the order its threads
    take the rays in, which changes no answer. On CPU tensors
    ``packet_ref`` walks ``packed``, the 64-leaf tree, and slot is a padded
    slot of it; the walk is per lane, so ``perm`` is not needed there."""
    dev = o.device
    if dev.type == "cuda":
        if bvh is None:
            raise ValueError("packet_query: kernel 5 walks pack_bvh's tree; "
                             "pass the scene's mesh_bvh as bvh")
        return _packet_cuda(bvh, o, d, t_init, tmin, any_hit, perm)
    if dev.type == "cpu":
        return packet_ref(packed, o, d, t_init, tmin, any_hit)
    raise ValueError(f"packet_query: unsupported device {dev}")


def bin_rays(coarse: PackedMesh, o: Tensor, d: Tensor, t_init: Tensor,
             tmin: float) -> tuple[Tensor, Tensor, Tensor]:
    """(cell, tn, key): kernel 6 on CUDA tensors, ``bin_rays_ref`` and
    ``bin_sort_key`` on CPU tensors. cell is the nearest coarse cell's node
    id (-1: provably no mesh hit before t_init, or a dead lane), tn its
    clamped entry distance (BIG when none), key the two-pass sort key
    (``bin_sort_key`` with the tree's ``key_scale``), which kernel 6 writes
    in the same launch."""
    dev = o.device
    if dev.type == "cuda":
        return _bin_cuda(coarse, o, d, t_init, tmin)
    if dev.type == "cpu":
        cell, tn = bin_rays_ref(coarse, o, d, t_init, tmin)
        return cell, tn, bin_sort_key(cell, tn, d, coarse.key_scale)
    raise ValueError(f"bin_rays: unsupported device {dev}")


# ---------------------------------------------------------------------------
# The wave query
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PacketHit:
    """Closest-hit record with the kernel-resolved shading attributes."""

    t: Tensor  # (N,) BIG on a miss
    tri: Tensor  # (N,) MeshData triangle id (want_tri=False: the walked slot)
    n: Tensor  # (N, 3) geometric normal
    uv: Tensor  # (N, 2) interpolated texture uv
    mat: Tensor  # (N,) material id


def _octant(d: Tensor) -> Tensor:
    return ((d[:, 0] < 0).to(torch.int32) * 4
            + (d[:, 1] < 0).to(torch.int32) * 2
            + (d[:, 2] < 0).to(torch.int32))


def packet_sort_key(o: Tensor, d: Tensor, alive: Tensor | None = None
                    ) -> Tensor:
    """Ray-coherence sort key: direction octant (major) and a 16^3 origin
    cell (minor); dead lanes sort last."""
    oct_ = _octant(d)
    lo = torch.amin(o, dim=0)
    hi = torch.amax(o, dim=0)
    q = torch.clamp(((o - lo) / torch.clamp_min(hi - lo, 1e-6) * 15.0)
                    .to(torch.int32), 0, 15)
    cell = (q[:, 0] * 16 + q[:, 2]) * 16 + q[:, 1]
    key = oct_ * 4096 + cell
    if alive is not None:
        key = torch.where(alive, key, 1 << 20)
    return key


def intersect_mesh_packet(
    packed: PackedMesh, o: Tensor, d: Tensor, tmin: float, sort: bool = True,
    t_init: Tensor | None = None, any_hit: bool = False,
    coarse: PackedMesh | None = None, hints: Tensor | None = None,
    want_tri: bool = True, bvh: PackedBvh | None = None,
) -> PacketHit:
    """Closest-hit (or, ``any_hit``, occlusion) query of N rays against the
    mesh; the contract of the JAX function of the same name.

    ``t_init`` (N,): the walk only finds hits strictly closer; lanes with
    ``t_init <= 0`` are dead. t equals t_init (or BIG) where no closer hit
    exists. ``any_hit``: the first occluder sets t = 0, and tri, n, uv and
    mat are zeros. ``sort`` orders the walk by ``packet_sort_key``; with
    ``coarse`` it is the two-pass binned traversal: ``bin_rays`` maps rays to
    their nearest coarse cell, rays are ordered by (cell, octant, quantized
    entry depth: ``bin_sort_key``, which kernel 6 writes in its launch),
    and rays that enter no cell before t_init skip the walk.
    The order is a permutation that kernel 5 reads and writes through, so
    the rays and the answers stay in the caller's order (every output is
    elementwise from there on); on the CPU, where the walk is per lane, no
    order is made and only the two-pass cull runs. On the card kernel 5 walks ``bvh``, the
    scene's ``mesh_bvh`` (``pack_bvh``; ValueError without it), and returns
    MeshData triangle ids; on the CPU ``packet_ref`` walks ``packed``, the
    64-leaf tree, and its padded slots map to MeshData ids through
    ``packed.remap``. ``want_tri=False`` returns the walked tree's slot
    instead: the padded slot on the CPU, the MeshData id on the card.
    ``hints`` (the JAX kernel's per-tile fine-tree ranges to walk first)
    order the TPU's shared tile walk and do not change the result; the CUDA
    kernel walks every ray from the root, one launch per wave, so they are
    accepted and ignored (the TPU's ``tile_rows`` has no counterpart here)."""
    if bvh is None and o.device.type == "cuda":
        raise ValueError("intersect_mesh_packet: kernel 5 walks pack_bvh's "
                         "tree; pass the scene's mesh_bvh as bvh")
    n = o.shape[0]
    if t_init is None:
        t_init = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    perm, culled, t_eff = None, None, t_init
    live = t_init > 0.0 if sort else None
    # the order is the card's alone: the CPU walk is per lane
    order = sort and o.device.type == "cuda"
    if sort and coarse is not None:
        # on the card kernel 6 writes the sort key in its launch
        cell, _, key = bin_rays(coarse, o, d, t_init, tmin)
        has = (cell >= 0) & live
        t_eff = torch.where(has, t_init, 0.0)
        culled = live & ~has
    elif order:
        key = packet_sort_key(o, d, alive=live)
    if order:
        perm = torch.argsort(key, stable=True).to(torch.int32)
    t, slot, nrm, uv, mat = packet_query(packed, o, d, t_eff, tmin, any_hit,
                                         bvh=bvh, perm=perm)
    found = t < torch.where(t_eff > 0.0, t_eff, 0.0)
    t_out = torch.where(found, t, torch.where(t_eff > 0.0, t_eff, BIG))
    if culled is not None:
        # culled live lanes have no mesh hit before t_init
        t_out = torch.where(culled, t_init, t_out)
    if any_hit:  # only t is meaningful: slot and the attributes are zeros
        tri = slot
    elif want_tri and o.device.type == "cpu":
        tri = torch.where(found, packed.remap[slot.to(torch.int64)], 0)
    else:
        tri = slot
    return PacketHit(t=t_out, tri=tri, n=nrm, uv=uv, mat=mat)
