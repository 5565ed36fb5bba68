"""Render metrics: rays/sec and spp/sec counters, and lane agreement.

Structured replacement for the reference's window-title FPS readout
(reference main.cpp:366-380): per-iteration wall time, rays traced, and a
one-line status string. The counters are host-side, around a step that
waits for the device when it reads its ray count, matching how the
reference's 1-second FPS window measured wall clock across its
cudaThreadSynchronize calls (pathtracer.cu:233,241).

``lane_agreement`` compares two runs of the persistent step lane for lane;
the tests and ``chip_smoke.py`` hold the kernel, its plain version and the
JAX kernel to ``AGREE`` with it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

# The JAX package's own kernel-vs-replica bar (tests/test_persistent.py):
# >= 98% of lanes agree on the sample count and within L_TOL * max(1, |L|)
# on radiance.
AGREE = 0.98
L_TOL = 1e-4


@dataclass
class RenderMeter:
    lanes_per_iteration: int
    total_time: float = 0.0
    total_rays: int = 0
    iterations: int = 0
    window: list = field(default_factory=list)

    def update(self, seconds: float, rays: int | None) -> None:
        self.total_time += seconds
        self.iterations += 1
        if rays is not None:
            self.total_rays += rays
        self.window.append((seconds, rays))
        if len(self.window) > 10:
            self.window.pop(0)

    @property
    def ips(self) -> float:
        """Iterations (progressive frames) per second, recent window."""
        t = sum(w[0] for w in self.window)
        return len(self.window) / t if t > 0 else 0.0

    @property
    def rays_per_sec(self) -> float:
        t = sum(w[0] for w in self.window)
        r = sum(w[1] or 0 for w in self.window)
        return r / t if t > 0 else 0.0

    def status(self, iteration: int) -> str:
        """One-line progress string (the reference's title-bar format was
        'Pathtracer (%.4f sps : %u)', main.cpp:377)."""
        parts = [f"iter {iteration}", f"{self.ips:.2f} it/s"]
        if self.total_rays:
            parts.append(f"{self.rays_per_sec / 1e6:.0f} Mrays/s")
        parts.append(f"{self.lanes_per_iteration * self.ips / 1e6:.1f} Mspp-px/s")
        return "  ".join(parts)


def sync_card() -> None:
    """Wait for the card's queued work, where this process has used it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Context-manager wall timer (``with Timer() as t: ...; t.seconds``).

    Where this process has used the card, it synchronizes the device before
    it reads the clock, on entry and on exit, so the seconds cover the work
    queued inside the scope and not only its launches; on the CPU it reads
    the clock alone."""

    def __enter__(self):
        sync_card()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync_card()
        self.seconds = time.perf_counter() - self.t0
        return False


def lane_agreement(a, b, width: int, height: int
                   ) -> tuple[float, float, float]:
    """How closely two PathStates of the same lanes agree: (fraction of real
    lanes with equal sample counts, fraction whose radiance sums differ by
    less than ``L_TOL * max(1, |L|)``, largest radiance difference).

    Two implementations of the step cannot agree bit for bit: the 1e5-radius
    walls make f32 closest hits chaotic, and rsqrt/sqrt and FMA contraction
    round differently on each backend, so a few lanes take different but
    equally valid paths. The tolerance is relative on lanes brighter than 1,
    where a one-ulp change of a hit point already moves a bright NEE sample
    by more than 1e-4.
    """
    n = width * height

    def lanes(st):
        L = torch.stack([st.lr, st.lg, st.lb], -1).reshape(-1, 3)[:n]
        return L.double().cpu(), st.n_samp.reshape(-1)[:n].cpu()

    La, na = lanes(a)
    Lb, nb = lanes(b)
    d = (La - Lb).abs().amax(-1)
    ok = d < L_TOL * torch.clamp_min(La.abs().amax(-1), 1.0)
    return ((na == nb).double().mean().item(), ok.double().mean().item(),
            d.max().item())


def sample_lane_agreement(a, b, n_lanes: int) -> tuple:
    """How closely two per-sample walks' (rows, 128, 3) radiance agree,
    ``b`` the reference (kernels 7 and 8): the fraction of the first
    ``n_lanes`` lanes whose every channel is within ``L_TOL * max(1,
    |L|)`` (``lane_agreement``'s bar), the largest difference, and the
    (rows, 128) mask of agreeing lanes (padding lanes agree), on the CPU."""
    a = a.double().cpu().reshape(-1, 3)
    b = b.double().cpu().reshape(-1, 3)
    d = (a - b).abs()
    ok = (d <= L_TOL * b.abs().clamp_min(1.0)).all(-1)
    ok[n_lanes:] = True
    return (ok[:n_lanes].double().mean().item(), d[:n_lanes].max().item(),
            ok.reshape(-1, 128))


def _close(x, y, tol=L_TOL):
    """Elementwise |x - y| < tol * max(1, |x|) (x is the reference)."""
    return (x - y).abs() < tol * torch.clamp_min(x.abs(), 1.0)


def _plane_agreement(La, na, Lb, nb, planes, n, tol=L_TOL) -> dict:
    """Lane agreement of two walks' (rows, 128, 3) radiance ``L*`` and
    (rows, 128) sample counts ``n*``, and of the named (rows, 128) planes in
    ``planes``, (name, reference, other) triples, within ``tol``."""
    l_ok = _close(La, Lb).all(-1)
    mask = (na == nb) & l_ok
    fracs = {}
    diff = float((La - Lb).abs().max())
    for name, x, y in planes:
        ok = _close(x, y, tol)
        fracs[name] = ok.reshape(-1)[:n].double().mean().item()
        mask &= ok
        diff = max(diff, float((x - y).abs().max()))

    def frac(m):
        return m.reshape(-1)[:n].double().mean().item()

    return {"n_samp": frac(na == nb), "L": frac(l_ok), "planes": fracs,
            "all": frac(mask), "max_abs_err": diff, "mask": mask}


def grad_lane_agreement(a, b, width: int, height: int) -> dict:
    """How closely two phase-"adjoint" outputs of the gradient walk agree
    lane for lane. ``a`` and ``b`` are (L_lanes (rows, 128, 3), n_samp
    (rows, 128), ga_lanes (M, 3, rows, 128), gi_lanes (NL, 3, rows, 128)),
    and optionally, fifth, the C_tot records (3*spp, rows, 128) of a
    textured walk (None: none); ``a`` is the reference. Returns the
    fractions of real lanes that agree on the sample count (``"n_samp"``),
    on radiance (``"L"``) and on each GA/GI plane and C_tot plane
    (``"planes"``, by name), the largest radiance and plane differences
    (``"max_abs_err"``), and ``"mask"``, the (rows, 128) lanes on which all
    of them agree, on the CPU (the bar is ``lane_agreement``'s)."""
    La, na, gaa, gia = (x.double().cpu() for x in a[:4])
    Lb, nb, gab, gib = (x.double().cpu() for x in b[:4])
    planes = [(f"{name}[{k}][{'rgb'[c]}]", xa[k, c], xb[k, c])
              for name, xa, xb in (("GA", gaa, gab), ("GI", gia, gib))
              for k in range(xa.shape[0]) for c in range(3)]
    if len(a) > 4 and a[4] is not None:
        cta, ctb = a[4].double().cpu(), b[4].double().cpu()
        planes += [(f"C_tot[{k // 3}][{'rgb'[k % 3]}]", cta[k], ctb[k])
                   for k in range(cta.shape[0])]
    return _plane_agreement(La, na, Lb, nb, planes, width * height)


# The atlas gradient of the scatter walk (phase "scatter"). Kernel against
# plain: both take the same cotangent planes, zeroed on the lanes where the
# two walks disagree, and the atlases agree within ATLAS_RTOL * max|gT|.
# Two kernel launches on the same inputs: the float atomics add in another
# order, and two f32 sums of n terms differ by at most 2 (n - 1) 2^-24 sum|x|;
# every cell is held within ATOMIC_RTOL * (the same scatter of |g|), which
# is sum|x| of that cell (every term's sign is g's: C_tot - C, the NEE term,
# the texel and the weights are >= 0). 1e-4 covers 838 terms in the worst
# case, and the error of a sum in random order grows as sqrt(n).
ATLAS_RTOL = 2e-3
ATOMIC_RTOL = 1e-4


def atlas_gap(k: "torch.Tensor", r: "torch.Tensor") -> float:
    """max |k - r| / max |r| of two atlas gradients (r the reference)."""
    return float((k.double() - r.double()).abs().max()
                 / r.double().abs().max().clamp_min(1e-300))


def tangent_lane_agreement(a, b, width: int, height: int,
                           dl_tol: float = L_TOL) -> dict:
    """How closely two tangent walks (``camera_jvp_call``) agree lane for
    lane. ``a`` and ``b`` are (L (rows, 128, 3), dL (T, rows, 128, 3),
    n_samp (rows, 128)); ``a`` is the reference. Returns what
    ``grad_lane_agreement`` does, with the dL planes (by name ``dL[j][c]``)
    held within ``dl_tol * max(1, |dL|)``."""
    La, dLa, na = (x.double().cpu() for x in a)
    Lb, dLb, nb = (x.double().cpu() for x in b)
    planes = [(f"dL[{j}][{'rgb'[c]}]", dLa[j, ..., c], dLb[j, ..., c])
              for j in range(dLa.shape[0]) for c in range(3)]
    return _plane_agreement(La, na, Lb, nb, planes, width * height, dl_tol)


# Kernels 5 and 6 against their plain versions (chip_smoke.py phases 17,
# 18 and 21): hit/miss and triangle (any-hit: occlusion) equal on
# PACKET_AGREE of lanes, t within PACKET_T_TOL * max(1, t) and the normal,
# uv and material equal there, and of the n lanes that differ, one sign of
# dt in excess by at most SIGN_Z * sqrt(n); coarse cells equal on
# PACKET_AGREE of lanes and their entry distance within BIN_TN_RTOL.
PACKET_AGREE = 0.999
PACKET_T_TOL = 1e-5
BIN_TN_RTOL = 1e-6
SIGN_Z = 6.0


def packet_agreement(k, r, t_init, any_hit: bool) -> dict:
    """Two answers to one packet query, each (t, id, n, uv, mat) with id the
    triangle or the slot, against the bars above: the share of lanes that
    agree, the share of hits, the largest |dt| on agreeing hits, whether t
    and the attributes hold on the agreeing lanes (``t_ratio``: the largest
    |dt| over its allowance there, 1.0 is the bar; ``attr_diff``: the
    largest difference of n or uv and the count of unequal materials), the
    lanes that differ and the sign balance over them (1.0 is the bar), and
    ``ok``."""
    lim = torch.where(t_init > 0, t_init, 0.0)
    hk, hr = k[0] < lim, r[0] < lim
    same = hk == hr
    if not any_hit:
        same &= ~hr | (k[1] == r[1])
    dt = (k[0] - r[0]).abs()
    ratio = dt[same] / (PACKET_T_TOL * r[0][same].abs().clamp_min(1.0))
    t_ratio = float(ratio.max()) if ratio.numel() else 0.0
    attrs_ok = any_hit or all(torch.equal(a[same], b[same].to(a.dtype))
                              for a, b in zip(k[2:], r[2:]))
    gaps = [float((a[same] - b[same].to(a.dtype)).abs().max())
            if bool(same.any()) else 0.0 for a, b in zip(k[2:4], r[2:4])]
    mat_off = int((k[4][same] != r[4][same].to(k[4].dtype)).sum())
    off = ~same
    n_off = int(off.sum())
    excess = abs(int(((k[0] > r[0]) & off).sum())
                 - int(((k[0] < r[0]) & off).sum()))
    agreeing_hits = same & hr
    out = dict(agree=float(same.double().mean()),
               hits=float(hr.double().mean()),
               max_abs_err=float(dt[agreeing_hits].max())
               if bool(agreeing_hits.any()) else 0.0,
               t_ok=t_ratio <= 1.0, t_ratio=t_ratio, attrs_ok=attrs_ok,
               attr_diff=(max(gaps), mat_off), n_off=n_off,
               sign=excess / (SIGN_Z * n_off ** 0.5) if n_off else 0.0)
    out["ok"] = (out["agree"] >= PACKET_AGREE and out["t_ok"] and attrs_ok
                 and out["sign"] <= 1.0)
    return out


def bin_agreement(k, r) -> dict:
    """Two (cell, tn) answers of the coarse-cell sweep against the bars
    above: the share of equal cells, tn's largest relative and absolute
    (on binned lanes) differences where the cells agree, and ``ok``."""
    same = k[0] == r[0]
    gap = (k[1] - r[1]).abs()
    binned = same & (r[0] >= 0)
    out = dict(agree=float(same.double().mean()),
               tn_rel=float((gap / r[1].abs().clamp_min(1e-30))[same].max())
               if bool(same.any()) else 0.0,
               tn_abs=float(gap[binned].max()) if bool(binned.any()) else 0.0)
    out["ok"] = out["agree"] >= PACKET_AGREE and out["tn_rel"] <= BIN_TN_RTOL
    return out
