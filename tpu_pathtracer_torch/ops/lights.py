"""Light sampling for next-event estimation and its MIS counterweights.

Counterpart of ``tpu_pathtracer/ops/lights.py``: one light per lane, chosen
in proportion to its power (``light_selection_dist``, shared by the sampler
and every MIS pdf); point lights, sphere-area lights by cone sampling (the
receiver inside the sphere samples its surface), and triangle (TRI_LIGHT)
lights by area. The JAX package's one-hot matrix products become gathers.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import Tensor

from tpu_pathtracer_torch.models.scene import (
    AREA_LIGHT, EPSILON, POINT_LIGHT, TRI_LIGHT, Scene,
)
from tpu_pathtracer_torch.ops import sampling, vecmath as vm


def light_selection_dist(scene: Scene) -> tuple[Tensor, Tensor]:
    """Power-proportional selection (cdf, pdfs): luminance times the surface
    area for sphere and triangle lights, luminance for point lights.
    Detached from autograd: a sampling decision, like the BSDF draws."""
    l_radius = scene.radii[scene.light_prim]
    lum = vm.luminance(scene.light_intensity)
    w = torch.where(scene.light_type == AREA_LIGHT,
                    4.0 * math.pi * l_radius * l_radius, 1.0)
    if scene.has_tri_lights:
        w = torch.where(scene.light_type == TRI_LIGHT, scene.tl_area, w)
    power = lum * w * scene.light_valid
    return sampling.make_distribution_1d(power.detach())


@dataclasses.dataclass(frozen=True)
class LightSample:
    """One light sample per lane."""

    radiance: Tensor  # (N, 3) emitted radiance toward the receiver
    wi: Tensor  # (N, 3) direction receiver -> sample
    pdf: Tensor  # (N,) solid-angle pdf, selection included
    dist: Tensor  # (N,) distance to the sampled point
    is_delta: Tensor  # (N,) bool: point lights
    valid: Tensor  # (N,) bool: a real light was sampled
    index: Tensor  # (N,) int64: the light chosen


def sample_lights(scene: Scene, p: Tensor, u: Tensor, tmin: float = EPSILON
                  ) -> LightSample:
    """Sample one light per shading point p (N, 3) with uniforms u (N, 3):
    (area u, area v, select)."""
    cdf, sel_pdfs = light_selection_dist(scene)
    li, sel_pdf = sampling.sample_distribution_1d(cdf, sel_pdfs, u[:, 2])
    l_type = scene.light_type[li]
    l_pos = vm.take(scene.light_pos, li)
    l_int = vm.take(scene.light_intensity, li)
    l_valid = scene.light_valid[li]
    l_prim = scene.light_prim[li]
    c = vm.take(scene.centers, l_prim)
    r = vm.take(scene.radii, l_prim)

    # point light
    to_l = l_pos - p
    d2_point = vm.length_sq(to_l)
    dist_point = vm.safe_sqrt(d2_point)
    wi_point = to_l / torch.clamp_min(dist_point, 1e-12)[:, None]
    rad_point = l_int / torch.clamp_min(d2_point, 1e-12)[:, None]

    # sphere light: cone sampling toward the sphere
    wc_raw = c - p
    d2 = vm.length_sq(wc_raw)
    dist_c = vm.safe_sqrt(d2)
    wc = wc_raw / torch.clamp_min(dist_c, 1e-12)[:, None]
    wc_x, wc_y = vm.orthonormal_basis(wc)
    inside = d2 - r * r < 1e-4
    sin2_tmax = torch.clamp(r * r / torch.clamp_min(d2, 1e-12), 0.0, 1.0)
    cos_tmax = vm.safe_sqrt(1.0 - sin2_tmax)
    wi_cone = sampling.uniform_sample_cone(u[:, 0], u[:, 1], cos_tmax, wc_x,
                                           wc_y, wc)
    b = vm.dot(wc_raw, wi_cone)
    det = b * b - d2 + r * r
    thit = b - vm.safe_sqrt(torch.clamp_min(det, 0.0))
    thit = torch.where(det >= 0.0, thit, b)
    ps_cone = p + wi_cone * thit[:, None]
    sph = sampling.uniform_sample_sphere(u[:, 0], u[:, 1])
    ps_inside = c + sph * r[:, None]
    ps = torch.where(inside[:, None], ps_inside, ps_cone)
    ns = (ps - c) / torch.clamp_min(r, 1e-12)[:, None]
    to_s = ps - p
    dist_area = vm.length(to_s)
    wi_area = to_s / torch.clamp_min(dist_area, 1e-12)[:, None]
    pdf_cone = sampling.uniform_cone_pdf(cos_tmax)
    area = 4.0 * math.pi * r * r
    cos_at_light = torch.abs(vm.dot(ns, -wi_area))
    pdf_inside = (dist_area * dist_area) / torch.clamp_min(
        cos_at_light * area, 1e-12)
    pdf_area = torch.where(inside, pdf_inside, pdf_cone)
    front = vm.dot(ns, -wi_area) > 0.0
    rad_area = l_int * front[:, None]

    is_point = l_type == POINT_LIGHT
    is_area = l_type == AREA_LIGHT
    radiance = torch.where(is_point[:, None], rad_point, rad_area)
    wi = torch.where(is_point[:, None], wi_point, wi_area)
    pdf = torch.where(is_point, 1.0, pdf_area)
    dist = torch.where(is_point, dist_point, dist_area)
    branch_ok = is_point | is_area
    if scene.has_tri_lights:
        is_tri = l_type == TRI_LIGHT
        wi_tri, rad_tri, pdf_tri, dist_tri, valid_tri = _sample_tri_light(
            scene, p, u, li, l_int, tmin)
        radiance = torch.where(is_tri[:, None], rad_tri, radiance)
        wi = torch.where(is_tri[:, None], wi_tri, wi)
        pdf = torch.where(is_tri, pdf_tri, pdf)
        dist = torch.where(is_tri, dist_tri, dist)
        branch_ok = branch_ok | (is_tri & valid_tri)
    pdf = pdf * sel_pdf
    valid = l_valid & branch_ok & (pdf > 0.0)
    # invalid lanes get a fixed finite sample
    vf = valid[:, None]
    park = torch.zeros_like(wi)
    park[:, 2] = 1.0
    return LightSample(
        radiance=torch.where(vf, radiance, 0.0),
        wi=torch.where(vf, wi, park),
        pdf=torch.where(valid, pdf, 1.0),
        dist=torch.where(valid, dist, 1.0),
        is_delta=is_point, valid=valid, index=li)


def _sample_tri_light(scene: Scene, p: Tensor, u: Tensor, li: Tensor,
                      l_int: Tensor, tmin: float):
    """A point on the chosen TRI_LIGHT: a triangle by area (u0 re-used
    within its cdf segment), then a uniform point by the sqrt warp. Returns
    (wi, radiance, solid-angle pdf d^2 / (cos_l A_total), dist, valid)."""
    cdf = scene.tl_cdf[li]  # (N, K)
    K = cdf.shape[1]
    area = scene.tl_area[li]
    u0 = u[:, 0]
    k = torch.clamp(torch.sum((u0[:, None] > cdf).to(torch.int64), dim=-1),
                    0, K - 1)
    cdf_prev = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=1)
    c_lo = cdf_prev.gather(1, k[:, None])[:, 0]
    c_hi = cdf.gather(1, k[:, None])[:, 0]
    u0r = torch.clamp((u0 - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-12),
                      0.0, 1.0)
    tv0, te1, te2, tn = (vm.take(getattr(scene, f).reshape(-1, 3),
                                 li * K + k)
                         for f in ("tl_v0", "tl_e1", "tl_e2", "tl_n"))
    su = torch.sqrt(u0r)
    b1 = 1.0 - su
    b2 = u[:, 1] * su
    ps = tv0 + b1[:, None] * te1 + b2[:, None] * te2
    to_s = ps - p
    d2 = vm.length_sq(to_s)
    dist = vm.safe_sqrt(d2)
    wi = to_s / torch.clamp_min(dist, 1e-12)[:, None]
    cos_l = vm.dot(tn, -wi)
    front = cos_l > 0.0
    pdf = d2 / torch.clamp_min(
        torch.abs(cos_l) * torch.clamp_min(area, 1e-20), 1e-12)
    radiance = l_int * front[:, None]
    valid = front & (dist > tmin) & (area > 0.0)
    return wi, radiance, pdf, dist, valid


def light_dir_pdf(scene: Scene, p: Tensor, wi: Tensor, hit_center: Tensor,
                  hit_radius: Tensor, hit_is_light: Tensor,
                  hit_prim: Tensor | None = None) -> Tensor:
    """Solid-angle pdf, selection included, with which ``sample_lights``
    picks direction wi from p toward the light sphere hit: the MIS
    counterweight of an emitter hit (scene.h:110-130)."""
    d2 = vm.distance_sq(p, hit_center)
    sin2_tmax = torch.clamp(
        hit_radius * hit_radius / torch.clamp_min(d2, 1e-12), 0.0, 1.0)
    inside = d2 - hit_radius * hit_radius < 1e-4
    cos_tmax = vm.safe_sqrt(1.0 - sin2_tmax)
    pdf = sampling.uniform_cone_pdf(cos_tmax)
    pdf = torch.where(inside, 1.0 / (4.0 * math.pi), pdf)
    pdf = pdf * selection_pdf_for_prim(scene, hit_prim)
    return torch.where(hit_is_light, pdf, 0.0)


def selection_pdf_for_prim(scene: Scene, hit_prim: Tensor | None):
    """P(sample_lights picks the light owning sphere ``hit_prim``); a mesh
    prim (>= the sphere count) or a prim without a light reads light 0, as
    the JAX package's one-hot contraction does."""
    _, sel_pdfs = light_selection_dist(scene)
    if hit_prim is None:
        return 1.0
    P0 = scene.centers.shape[0]
    L = scene.light_type.shape[0]
    in_range = (hit_prim >= 0) & (hit_prim < P0)
    lid = torch.where(in_range,
                      scene.light_id[torch.clamp(hit_prim, 0, P0 - 1)], 0)
    return sel_pdfs[torch.clamp(lid, 0, L - 1).to(torch.int64)]


def tri_sel_over_area_by_mat(scene: Scene) -> Tensor:
    """(M,) material id -> P(select its triangle light) / its total area:
    the TRI_LIGHT emitter-hit MIS counterweight is t^2 / cos_l times this."""
    _, sel_pdfs = light_selection_dist(scene)
    is_tri = (scene.light_type == TRI_LIGHT) & scene.light_valid
    vals = torch.where(is_tri,
                       sel_pdfs / torch.clamp_min(scene.tl_area, 1e-20), 0.0)
    M = scene.mat_color.shape[0]
    lm = torch.clamp(scene.light_mat, 0, M - 1).to(torch.int64)
    return torch.zeros(M, dtype=vals.dtype, device=vals.device).index_add_(
        0, lm, vals)
