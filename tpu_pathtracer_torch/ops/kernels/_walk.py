"""Plain PyTorch versions of the in-kernel BVH walks.

``mesh_walk_ref`` is the counterpart of
``tpu_pathtracer/ops/pallas/_walk.py::make_mesh_walk``, the walk that the
TPU persistent kernels trace, with its semantics kept exactly: the whole
tile of ``tile_rows x 128`` lanes walks ONE shared node sequence over the
64-triangle-leaf packed mesh (``ops/kernels/mesh_kernel.py::pack_mesh``);
a subtree is entered, and a leaf tested, when ANY live lane of the tile
hits its box; each lane is pruned by its own running t, and ``t_init <= 0``
marks a dead lane. Inside a leaf the triangles are tested in order and a
hit wins only if strictly closer (``tt < t_best``), so on a tie the lowest
triangle index wins (leaves lie in triangle order). The persistent
kernels' plain versions call this walk.

``bvh_walk_ref`` is the plain version of the walk the CUDA kernels run
(``csrc/pt_common.cuh::bvh_walk``) over ``pack_bvh``'s tree, the mesh's
own small-leaf tree with skip links: per lane, from the root, a node whose
box the lane's ray enters before its t is descended into (a leaf's
triangles tested in order, strictly closer wins), else the walk follows the
skip link. The far slab distance is scaled up by ``ROBUST`` and a box is
pruned only beyond t times ``PRUNE``, so that rounding never drops a box
that holds the hit. Both walks visit leaves in triangle order and keep a
strictly closer hit, so on an equal t the lower triangle index wins in
both; their triangle arithmetic is the same (``_moller_trumbore``), and
they differ only on rays whose own slab test misses, in the tile walk, a
box holding their hit.

With ``track_uv`` the closest mode of either walk also returns the
winner's interpolated texture uv, as the TPU walk does for textured
scenes. ``counts`` adds ``segments`` (live lanes), ``boxes`` (slab tests)
and ``tris`` (triangle tests): per live tile for the tile walk, so a
layout of one live lane per tile counts a per-thread walk of that tree.
An occlusion walk stops at its first occluder, so a leaf's tests count up
to and including it (in the tile walk, until every live lane of the tile
has found its own).
"""
from __future__ import annotations

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import EPSILON
from tpu_pathtracer_torch.ops.kernels.mesh_kernel import (
    TRI_STRIDE, TRIS_PER_ROW, PackedBvh, PackedMesh,
)

# 1 + 2 gamma(3) of Ize ("Robust BVH ray traversal", JCGT 2013), rounded up
# to 1 + 4 ulp, exact in f32: the far slab distance is scaled by it.
ROBUST = 1.0 + 4.0 * 2.0 ** -23
# A box or a pending subtree is pruned only beyond t * PRUNE: a triangle on
# a box's face is hit at a t that rounds a few ulp below the box's entry.
PRUNE = 1.0 + 2.0 ** -16


def _safe_inv(a: Tensor) -> Tensor:
    s = torch.where(a.abs() > 1e-12, a,
                    torch.where(a >= 0, 1e-12, -1e-12).to(a.dtype))
    return 1.0 / s


def _moller_trumbore(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z,
                     e2x, e2y, e2z):
    """(ok, u, v, t) of rays against triangles, broadcast, in the kernels'
    operation order; ok is |det| > 1e-12."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return ok, uu, vv, tt


def _count(counts: dict | None, key: str, n) -> None:
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(n)


def mesh_walk_ref(packed: PackedMesh, ox: Tensor, oy: Tensor, oz: Tensor,
                  dx: Tensor, dy: Tensor, dz: Tensor, t_init: Tensor, *,
                  tile_rows: int, occlusion: bool = False,
                  track_uv: bool = False, tmin: float = EPSILON,
                  counts: dict | None = None, record=None):
    """Walk the packed mesh for (rows_total, 128) lane planes.

    Closest mode returns (t, nx, ny, nz, mat): t stays ``t_init`` where no
    triangle is closer, the normal is the winner's unnormalized
    cross(e1, e2) (0 where none) and mat its material id (-1 where none);
    with ``track_uv`` also (u, v), the winner's uv0 + b1 uv_e1 + b2 uv_e2
    from slots 10-15 at its barycentrics (0 where none; JAX ``_walk.py:
    142-157``). Occlusion mode returns t alone, set to 0 at the first
    triangle found in (tmin, t_init); it never tracks uv. ``record``, if
    given, is called as ``record(occlusion, (ox, oy, oz, dx, dy, dz,
    t_init))`` before the walk, so that a caller can sample the segments
    that the plain versions walk (to count a bound's tests on them)."""
    if record is not None:
        record(occlusion, (ox, oy, oz, dx, dy, dz, t_init))
    shape = ox.shape
    n_tiles = shape[0] // tile_rows

    def tiles(x):
        return x.reshape(n_tiles, -1)

    ox, oy, oz, dx, dy, dz = (tiles(x) for x in (ox, oy, oz, dx, dy, dz))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t = tiles(t_init).clone()
    nx, ny, nz, hu, hv = (torch.zeros_like(t) for _ in range(5))
    track_uv = track_uv and not occlusion
    mat = torch.full(t.shape, -1, dtype=torch.int32, device=t.device)

    M = packed.num_nodes
    boxes = packed.boxes.reshape(-1, 6)
    meta = packed.meta.reshape(-1, 3).to(torch.int64)
    slots = packed.tri_rows.reshape(-1, TRI_STRIDE)
    leaf_slots = max(1, -(-packed.leaf_size // TRIS_PER_ROW)) * TRIS_PER_ROW
    nn = torch.zeros(n_tiles, dtype=torch.int64, device=t.device)
    if counts is not None:
        _count(counts, "segments", (t > 0.0).sum())
    while M > 0:
        active = nn < M
        if not bool(active.any()):
            break
        nc = torch.clamp_max(nn, M - 1)
        b = boxes[nc]
        tx0 = (b[:, 0:1] - ox) * ix
        tx1 = (b[:, 3:4] - ox) * ix
        ty0 = (b[:, 1:2] - oy) * iy
        ty1 = (b[:, 4:5] - oy) * iy
        tz0 = (b[:, 2:3] - oz) * iz
        tz1 = (b[:, 5:6] - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1))
        box_hit = (t > 0.0) & (tn <= tf) & (tf > tmin) & (tn < t)
        anyb = box_hit.any(1) & active
        skip, start, count = meta[nc, 0], meta[nc, 1], meta[nc, 2]
        is_leaf = count > 0
        leaf = anyb & is_leaf
        if counts is not None:
            _count(counts, "boxes", (active & (t > 0.0).any(1)).sum())
            if not occlusion:
                _count(counts, "tris", count[leaf].sum())
        if bool(leaf.any()):
            # the tiles at a leaf test all its slots at once, (tiles, slot,
            # lane); the first slot of the smallest t wins, as the
            # sequential strictly-closer test in slot order picks it
            ti = leaf.nonzero().squeeze(1)
            js = torch.arange(leaf_slots, device=t.device)
            tr = slots[torch.clamp_max(start[ti, None] + js,
                                       slots.shape[0] - 1)]
            (v0x, v0y, v0z, e1x, e1y, e1z,
             e2x, e2y, e2z) = (tr[:, :, k:k + 1] for k in range(9))
            lox, loy, loz, ldx, ldy, ldz = (x[ti, None, :] for x in
                                            (ox, oy, oz, dx, dy, dz))
            t_l = t[ti]
            ok, uu, vv, tt = _moller_trumbore(
                lox, loy, loz, ldx, ldy, ldz, v0x, v0y, v0z, e1x, e1y, e1z,
                e2x, e2y, e2z)
            valid = ((js[None, :, None] < count[ti, None, None]) & ok
                     & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                     & (tt > tmin) & (tt < t_l[:, None, :]))
            found = valid.any(1)
            if occlusion:
                if counts is not None:
                    # a live lane tests up to its first occluder, or all
                    tests = torch.where(found, valid.int().argmax(1) + 1,
                                        count[ti, None])
                    _count(counts, "tris", torch.where(
                        t_l > 0.0, tests, 0).amax(1).sum())
                t[ti] = torch.where(found, 0.0, t_l)
            else:
                best, jb = torch.where(valid, tt, float("inf")).min(1)
                jb = jb[:, None, :]

                def pick(x):
                    return x.expand(-1, -1, jb.shape[-1]).gather(
                        1, jb).squeeze(1)

                w1x, w1y, w1z, w2x, w2y, w2z = (
                    pick(x) for x in (e1x, e1y, e1z, e2x, e2y, e2z))
                t[ti] = torch.where(found, best, t_l)
                for plane, g in ((nx, w1y * w2z - w1z * w2y),
                                 (ny, w1z * w2x - w1x * w2z),
                                 (nz, w1x * w2y - w1y * w2x)):
                    plane[ti] = torch.where(found, g, plane[ti])
                mat[ti] = torch.where(found, pick(tr[:, :, 9:10]).to(
                    torch.int32), mat[ti])
                if track_uv:
                    bu, bv = pick(uu), pick(vv)
                    a = [pick(tr[:, :, k:k + 1]) for k in range(10, 16)]
                    hu[ti] = torch.where(found, a[0] + bu * a[2] + bv * a[4],
                                         hu[ti])
                    hv[ti] = torch.where(found, a[1] + bu * a[3] + bv * a[5],
                                         hv[ti])
        nn = torch.where(active, torch.where(anyb & ~is_leaf, nn + 1, skip),
                         nn)
    if occlusion:
        return t.reshape(shape)
    out = (t, nx, ny, nz, mat) + ((hu, hv) if track_uv else ())
    return tuple(x.reshape(shape) for x in out)


def bvh_walk_ref(bvh: PackedBvh, ox: Tensor, oy: Tensor, oz: Tensor,
                 dx: Tensor, dy: Tensor, dz: Tensor, t_init: Tensor, *,
                 occlusion: bool = False, track_uv: bool = False,
                 with_tri: bool = False, tmin: float = EPSILON,
                 counts: dict | None = None):
    """Walk ``pack_bvh``'s tree per lane, as ``csrc/pt_common.cuh::
    bvh_walk`` does, for lane tensors of any one shape; ``t_init <= 0``
    marks a dead lane. Returns what ``mesh_walk_ref`` returns: closest mode
    (t, nx, ny, nz, mat), with ``track_uv`` also (u, v), and with
    ``with_tri`` last the winner's triangle id (int64, -1 where none);
    occlusion mode t alone, 0 at the first triangle found in
    (tmin, t_init)."""
    shape = ox.shape
    o = [x.reshape(-1) for x in (ox, oy, oz)]
    d = [x.reshape(-1) for x in (dx, dy, dz)]
    inv = [_safe_inv(x) for x in d]
    t = t_init.reshape(-1).clone()
    dev = t.device
    L = t.numel()
    track_uv = track_uv and not occlusion
    nx, ny, nz, hu, hv = (torch.zeros_like(t) for _ in range(5))
    mat = torch.full((L,), -1, dtype=torch.int32, device=dev)
    best = torch.full((L,), -1, dtype=torch.int64, device=dev)
    links = bvh.links
    slots = bvh.tris
    n_tris = slots.shape[0]
    js = torch.arange(bvh.max_leaf, device=dev)
    node = torch.zeros(L, dtype=torch.int64, device=dev)
    lanes = torch.nonzero(t > 0.0)[:, 0]
    _count(counts, "segments", lanes.numel())
    while lanes.numel():
        lanes = lanes[node[lanes] < bvh.num_nodes]
        if not lanes.numel():
            break
        nd, lk = bvh.nodes[node[lanes]], links[node[lanes]]
        lo = [x[lanes] for x in o]
        li = [x[lanes] for x in inv]
        tx0 = (nd[:, 0] - lo[0]) * li[0]
        tx1 = (nd[:, 4] - lo[0]) * li[0]
        ty0 = (nd[:, 1] - lo[1]) * li[1]
        ty1 = (nd[:, 5] - lo[1]) * li[1]
        tz0 = (nd[:, 2] - lo[2]) * li[2]
        tz1 = (nd[:, 6] - lo[2]) * li[2]
        tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                         torch.minimum(ty0, ty1)),
                           torch.minimum(tz0, tz1))
        tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                         torch.maximum(ty0, ty1)),
                           torch.maximum(tz0, tz1)) * ROBUST
        hit = (tn <= tf) & (tf > tmin) & (tn <= t[lanes] * PRUNE)
        skip, first, count = lk[:, 0], lk[:, 1], lk[:, 2]
        _count(counts, "boxes", lanes.numel())
        done = torch.zeros_like(hit)
        sel = torch.nonzero(hit & (count > 0))[:, 0]
        if sel.numel():
            g = lanes[sel]
            first, cnt = first[sel], count[sel]
            tri = first[:, None] + js
            tr = slots[torch.clamp_max(tri, n_tris - 1)]
            ok, uu, vv, tt = _moller_trumbore(
                *(x[g, None] for x in o), *(x[g, None] for x in d),
                *(tr[..., k] for k in range(9)))
            valid = ((js < cnt[:, None]) & ok & (uu >= 0.0) & (vv >= 0.0)
                     & (uu + vv <= 1.0) & (tt > tmin) & (tt < t[g, None]))
            found = valid.any(1)
            if occlusion:
                # the kernel returns at the first occluder
                _count(counts, "tris", torch.where(
                    found, valid.int().argmax(1) + 1, cnt).sum())
                t[g] = torch.where(found, 0.0, t[g])
                done[sel] = found
            else:
                _count(counts, "tris", cnt.sum())
                # the smallest t, and its first slot on a tie, as the
                # kernel's in-order strictly-closer test keeps it
                bt, jb = torch.where(valid, tt, torch.inf).min(1)
                w = tr[torch.arange(len(sel), device=dev), jb]
                t[g] = torch.where(found, bt, t[g])
                best[g] = torch.where(found, first + jb, best[g])
                for plane, gn in (
                        (nx, w[:, 4] * w[:, 8] - w[:, 5] * w[:, 7]),
                        (ny, w[:, 5] * w[:, 6] - w[:, 3] * w[:, 8]),
                        (nz, w[:, 3] * w[:, 7] - w[:, 4] * w[:, 6])):
                    plane[g] = torch.where(found, gn, plane[g])
                mat[g] = torch.where(found, w[:, 9].to(torch.int32), mat[g])
                if track_uv:
                    bu = uu.gather(1, jb[:, None])[:, 0]
                    bv = vv.gather(1, jb[:, None])[:, 0]
                    hu[g] = torch.where(found, w[:, 10] + bu * w[:, 12]
                                        + bv * w[:, 14], hu[g])
                    hv[g] = torch.where(found, w[:, 11] + bu * w[:, 13]
                                        + bv * w[:, 15], hv[g])
        node[lanes] = torch.where(hit & (count == 0), node[lanes] + 1, skip)
        # an occluded lane is done
        lanes = lanes[~done]
    if occlusion:
        return t.reshape(shape)
    out = ((t, nx, ny, nz, mat) + ((hu, hv) if track_uv else ())
           + ((best,) if with_tri else ()))
    return tuple(x.reshape(shape) for x in out)
