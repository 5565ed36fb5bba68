"""Packed mesh layout for the in-kernel BVH walk (host side).

Counterpart of ``PackedMesh``, ``_collapse_subtrees`` and ``pack_mesh`` in
``tpu_pathtracer/ops/pallas/mesh_kernel.py``, with the same fine layout:
16-float triangle slots ``v0 e1 e2 | material | uv0 uv_e1 uv_e2``, 8 slots
per 128-float row, every leaf starting on a row, and one leaf block of tail
padding. Both persistent kernels walk this layout
(``csrc/pt_common.cuh``, ``ops/kernels/_walk.py``).

The standalone packet and bin kernels of that file (``_packet_kernel``,
``_bin_kernel``) and the coarse nodes-only tree they use are not ported yet
(ROADMAP Queue 2 items 5 and 6).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from tpu_pathtracer_torch.models.mesh import MeshData

LANES = 128
TRIS_PER_ROW = 8
TRI_STRIDE = 16  # floats per triangle slot


@dataclasses.dataclass(frozen=True)
class PackedMesh:
    """Packed layout plus a remap back to MeshData triangle ids. ``boxes``
    and ``meta`` are the node table split as the kernels read it."""

    nodes: Tensor  # (M, 16) f32: min3 max3 skip start count
    tri_rows: Tensor  # (R, 128) f32
    remap: Tensor  # (Tp,) int32 padded slot -> MeshData triangle (-1 pad)
    boxes: Tensor  # (M*6,) f32 node AABBs [min3 max3], flat
    meta: Tensor  # (M*3,) int32 [skip start count], flat
    leaf_size: int = 32
    num_nodes: int = 0

    @property
    def device(self) -> torch.device:
        return self.tri_rows.device

    def to(self, device) -> "PackedMesh":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("nodes", "tri_rows", "remap", "boxes",
                               "meta")})


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


def pack_mesh(mesh: MeshData, collapse_leaf: int = 64,
              nodes_only: bool = False,
              fine_leaf: int | None = None) -> PackedMesh:
    """Re-pack a built MeshData for the in-kernel walk (leaf-aligned
    triangles), on the mesh's device. Subtrees of up to ``collapse_leaf``
    triangles fold into one leaf."""
    if nodes_only or fine_leaf is not None:
        raise NotImplementedError(
            "the coarse nodes-only tree feeds the bin kernel, which is not "
            "ported to tpu_pathtracer_torch yet (ROADMAP Queue 2 item 6)")
    node_start = mesh.node_start.cpu().numpy()
    node_count = mesh.node_count.cpu().numpy()
    node_skip = mesh.node_skip.cpu().numpy()
    node_min = mesh.node_min.cpu().numpy()
    node_max = mesh.node_max.cpu().numpy()
    if collapse_leaf and mesh.num_nodes:
        (node_start, node_count, node_skip, node_min,
         node_max, *_) = _collapse_subtrees(
            node_start, node_count, node_skip, node_min, node_max,
            collapse_leaf)
    v0, e1, e2 = (getattr(mesh, f).cpu().numpy() for f in ("v0", "e1", "e2"))
    mat = mesh.material_id.cpu().numpy()
    uv0, uve1, uve2 = (getattr(mesh, f).cpu().numpy()
                       for f in ("uv0", "uv_e1", "uv_e2"))
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

    slots = np.zeros((Tp, TRI_STRIDE), np.float32)
    valid = tri_ids >= 0
    src = np.clip(tri_ids, 0, max(len(v0) - 1, 0))
    slots[:, 0:3] = np.where(valid[:, None], v0[src], 0.0)
    slots[:, 3:6] = np.where(valid[:, None], e1[src], 0.0)
    slots[:, 6:9] = np.where(valid[:, None], e2[src], 0.0)
    slots[:, 9] = np.where(valid, mat[src].astype(np.float32), 0.0)
    slots[:, 10:12] = np.where(valid[:, None], uv0[src], 0.0)
    slots[:, 12:14] = np.where(valid[:, None], uve1[src], 0.0)
    slots[:, 14:16] = np.where(valid[:, None], uve2[src], 0.0)
    tri_rows = slots.reshape(Tp // TRIS_PER_ROW, TRIS_PER_ROW * TRI_STRIDE)

    nodes = np.zeros((M, 16), np.float32)
    nodes[:, 0:3] = node_min
    nodes[:, 3:6] = node_max
    nodes[:, 6] = node_skip
    nodes[:, 7] = new_start
    nodes[:, 8] = node_count

    dev = mesh.v0.device
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
