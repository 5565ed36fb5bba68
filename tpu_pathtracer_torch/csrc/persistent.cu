// Persistent path-regeneration kernel for Hopper (sm_90a).
//
// Replaces: tpu_pathtracer/ops/pallas/persistent.py::_persistent_kernel
// (launched by persistent_step), whole: sphere and triangle-mesh scenes,
// brute force and NEE+MIS with point, sphere-area and triangle (TRI_LIGHT)
// lights, pinhole and thin-lens cameras (DOF), and textured mesh materials.
// The in-kernel BVH walk of ops/pallas/_walk.py is pt_common.cuh's
// bvh_walk over pack_bvh's tree, which also returns the hit's uv on a
// textured scene.
//
// What bounds it on this card: it is a long, divergent, register-heavy ALU
// state machine. Each lane does per-prim quadratics, transcendentals and
// three BSDF lobes per iteration; memory traffic is only the 20 state planes,
// read once and written once per launch (20 x 4 B x 2 per lane, about 49 MB
// at 640x480), plus the uniform block in test mode.
//
// What the design does about it:
//  * one thread per lane (pixel), one 128-thread block per 128-lane row of
//    the state planes, so every block sits inside one tile; the thread loads
//    its state into registers once, runs `budget` iterations in a device
//    loop, and stores it once, in place;
//  * the scene tables live in __constant__ memory: the per-prim loops read
//    the same address on every thread of a warp, which the constant cache
//    broadcasts. The loops run at runtime over the table (the TPU kernel
//    unrolled them over static tuples);
//  * lanes branch per lobe and per light instead of evaluating every lobe
//    under masks: a lane pays only for the lobe it took;
//  * a mesh is walked per thread after the sphere pass, from the sphere t,
//    so boxes behind the sphere hit are never entered. The tree is not the
//    TPU's (64-triangle leaves, for a walk shared by a whole tile) but the
//    mesh's own small-leaf tree (pack_bvh; one leaf for a mesh of at most
//    64 triangles), walked stacklessly through skip links
//    (pt_common.cuh::bvh_walk): a terrain segment tests ~10 triangles
//    instead of ~90. Its 32-byte nodes and the triangles are read from
//    global memory through the read-only cache;
//  * a textured mesh hit reads its four bilinear taps from the atlas in
//    device memory through the read-only cache (the TPU kernel's soft
//    two-hot MXU contraction stands in for a per-lane gather, which Hopper
//    has); untextured lanes and sphere hits read none;
//  * the kernel is built in six variants, templated on the mesh code
//    (MESH), the texture code (TEX, with a mesh only: the walk then tracks
//    uv) and the thin lens (DOF), so that a sphere or untextured scene and a
//    pinhole camera carry none of their registers;
//  * the live-ray count is reduced per warp and added to the per-tile
//    counter with one atomicAdd per warp.
//
// Randomness: with `uniforms` non-NULL the kernel reads the JAX kernel's
// external block (n_tiles, budget, n_draw, tile_rows, 128); otherwise it draws
// Philox4x32-10 keyed on (seed, salt) and countered on (global lane, frame,
// iteration, draw group), which the plain PyTorch version reproduces exactly.
//
// Agreement: CUDA's rsqrtf/sqrtf/sinf/cosf and nvcc's FMA contraction round
// differently from XLA on the CPU and from PyTorch's elementwise ops, and the
// 1e5-radius walls turn an ulp into a different closest hit on a few lanes.
// So the kernel is held to >= 98% of lanes against its plain version (the
// JAX package's own bar), not to bitwise equality. The build keeps nvcc's
// default FMA contraction (no -fmad=false in _build.py): it holds that bar;
// explicit fmaf calls fix the rounding where the walls need it, the thin
// lens rounds each step as the plain version does (pt_common.cuh), and the
// texel blend is contracted as nvcc likes.
//
// C interface (loaded with ctypes): tpt_persistent_step, tpt_error_string.

#include "pt_common.cuh"

namespace {

// prims: cx cy cz r ax ay az coef mtype ex ey ez (pack_prims layout)
__constant__ float c_prims[MAX_PRIMS * 12];
// bit 0: emissive; bits 1-2: BSDF type
__constant__ int c_pflags[MAX_PRIMS];
// lights: px py pz ir ig ib cdf_lo sel (pack_lights layout)
__constant__ float c_lights[MAX_LIGHTS * 8];
// light structure, LS ints per light (pt_common.cuh)
__constant__ int c_lstruct[MAX_LIGHTS * LS];
__constant__ float c_cam[24];  // pack_camera layout

struct State {  // STATE_FIELDS order
  float *lr, *lg, *lb;
  int* n_samp;
  float *ox, *oy, *oz, *dx, *dy, *dz;
  float *tr, *tg, *tb, *cr, *cg, *cb;
  int *bounce, *alive;
  float* prev_pdf;
  int* prev_delta;
};

struct Params {
  int n_prims, n_lights, tile_rows, budget, width, n_lanes;
  int max_bounces, rr_start, use_nee, strat_k, tile_offset;
  uint32_t seed, salt, frame;
  const float* uniforms;  // NULL: production Philox
  int* nrays;             // (n_tiles,) live-ray counter
  MeshView mesh;          // n_nodes 0: no mesh
  const float* atlas;     // (tex_k, tex_th, tex_tw, 3) texture atlas (TEX)
  int tex_k, tex_th, tex_tw;
};

// Six blocks of 128 threads per SM, so at most 80 registers: left to
// itself ptxas gives the textured mesh build 88 (five blocks per SM) and
// the untextured one 16 B of spills, and both ran 4-9% slower on terrain32
// and config 4 than with this bound (PERF.md, Findings). The sphere builds
// take 80 either way.
template <bool MESH, bool TEX, bool DOF>
__global__ void __launch_bounds__(LANES, 6)
persistent_kernel(State s, Params p) {
  static_assert(MESH || !TEX, "textures live on mesh materials");
  const int row = blockIdx.x;  // one block per 128-lane row
  const int col = threadIdx.x;
  const int idx = row * LANES + col;
  const int tile = row / p.tile_rows;
  const int trow = row - tile * p.tile_rows;
  const int tile_lanes = p.tile_rows * LANES;
  const int lane = idx + p.tile_offset * tile_lanes;  // global lane = pixel
  const bool in_domain = lane < p.n_lanes;
  const float px = (float)(lane % p.width);
  const float py = (float)(lane / p.width);
  // draws per iteration, in the TPU kernel's order (pt_common.cuh)
  constexpr int U1 = DOF ? 4 : 2;  // index of u1, after the camera's draws
  const int n_draw = U1 + 3 + (p.use_nee ? 3 : 0);

  float Lr = s.lr[idx], Lg = s.lg[idx], Lb = s.lb[idx];
  int n_samp = s.n_samp[idx];
  float ox = s.ox[idx], oy = s.oy[idx], oz = s.oz[idx];
  float dx = s.dx[idx], dy = s.dy[idx], dz = s.dz[idx];
  float Tr = s.tr[idx], Tg = s.tg[idx], Tb = s.tb[idx];
  float Cr = s.cr[idx], Cg = s.cg[idx], Cb = s.cb[idx];
  int bounce = s.bounce[idx];
  bool alive = s.alive[idx] != 0;
  float prev_pdf = s.prev_pdf[idx];
  bool prev_delta = s.prev_delta[idx] != 0;
  int n_live = 0;

  for (int it = 0; it < p.budget; ++it) {
    // ---- this iteration's uniforms: u_cam v_cam [u_lens v_lens] u1 u2 u3
    // [ul1 ul2 usel]
    float u[DOF ? 12 : 8];
    draw_uniforms(u, p.uniforms, tile, p.budget, it, n_draw, tile_lanes, trow,
                  col, lane, p.frame, p.seed, p.salt, STREAM_FORWARD);
    const float u1 = u[U1], u2 = u[U1 + 1], u3 = u[U1 + 2];
    const float ul1 = u[U1 + 3], ul2 = u[U1 + 4], usel = u[U1 + 5];

    // ---- regenerate: a dead lane starts its pixel's next sample. Stratified
    // jitter over strat_k^2 cells picked by n_samp % strat_k^2; prev_delta
    // is set on regeneration (camera rays count as delta for MIS).
    if (!alive && in_domain) {
      camera_dir(c_cam, px, py, n_samp, p.strat_k, u[0], u[1], dx, dy, dz);
      ox = c_cam[9];
      oy = c_cam[10];
      oz = c_cam[11];
      if (DOF) thin_lens(c_cam, u[2], u[3], ox, oy, oz, dx, dy, dz);
      Tr = Tg = Tb = 1.f;
      Cr = Cg = Cb = 0.f;
      bounce = 0;
      prev_pdf = 0.f;
      prev_delta = true;
      alive = true;
    }
    if (!alive) continue;  // padding lanes never act
    ++n_live;

    // ---- closest hit. Root selection of primitive.h:44: t0 = b - sq if
    // t0 > tmin, else b + sq. `<=` keeps the LAST prim on an exact tie, as
    // the TPU kernel's attribute pass does.
    float best_t = BIG;
    int best_p = -1;
    for (int q = 0; q < p.n_prims; ++q) {
      const float* P = c_prims + q * 12;
      const float opx = P[0] - ox, opy = P[1] - oy, opz = P[2] - oz;
      const float r = P[3];
      const float b = dot3_fma(opx, opy, opz, dx, dy, dz);
      const float det =
          fmaf(r, r, fmaf(b, b, -dot3_fma(opx, opy, opz, opx, opy, opz)));
      const float sq = sqrtf(fmaxf(det, 0.f));
      const float t0 = b - sq;
      const float t = t0 > TMIN ? t0 : b + sq;
      const float tv = (det >= 0.f && t > TMIN) ? t : BIG;
      if (tv <= best_t) {
        best_t = tv;
        best_p = q;
      }
    }
    // ---- the mesh, pruned from the sphere t; a triangle wins only if
    // strictly closer (persistent.py:358-397)
    float tm = BIG, gnx = 0.f, gny = 0.f, gnz = 0.f, hu = 0.f, hv = 0.f;
    int mmat = -1;
    if (MESH)
      tm = bvh_walk<false, TEX>(p.mesh, ox, oy, oz, dx, dy, dz, best_t,
                                gnx, gny, gnz, mmat, hu, hv);
    const bool mesh_hit = tm < best_t && tm < 0.5f * BIG;
    if (!mesh_hit && !(best_t < 0.5f * BIG)) {
      // miss: the path ends here and flushes into the pixel sum
      Lr += Cr;
      Lg += Cg;
      Lb += Cb;
      ++n_samp;
      alive = false;
      continue;
    }
    // Only acting lanes get here: lanes that do not act never compute a hit
    // point (the TPU kernel parks them on the origin instead, so that
    // o + d*1e30 cannot overflow into NaN in the NEE distance math).
    const float t_hit = mesh_hit ? tm : best_t;
    const float hx = fmaf(dx, t_hit, ox), hy = fmaf(dy, t_hit, oy),
                hz = fmaf(dz, t_hit, oz);
    float nx, ny, nz, ar, ag, ab, coef, er = 0.f, eg = 0.f, eb = 0.f;
    int mtype;
    bool emissive = false;
    if (mesh_hit) {
      const float inv_len = rsqrtf(fmaxf(gnx * gnx + gny * gny + gnz * gnz,
                                         1e-20f));
      nx = gnx * inv_len;
      ny = gny * inv_len;
      nz = gnz * inv_len;
      const float* MT = p.mesh.mats + mmat * MAT_STRIDE;
      ar = __ldg(MT);
      ag = __ldg(MT + 1);
      ab = __ldg(MT + 2);
      mtype = (int)__ldg(MT + 4);
      coef = __ldg(MT + 3);
      if (TEX) {
        // a textured material's colour is multiplied by the texel
        // (persistent.py:491-497); a texture id past the atlas gives a zero
        // texel, as the TPU kernel's rows past the atlas match no row
        const int texk = (int)__ldg(MT + 5);
        if (texk >= 0) {
          const float3 tx =
              texk < p.tex_k
                  ? texel(p.atlas, texk, p.tex_th, p.tex_tw, hu, hv)
                  : make_float3(0.f, 0.f, 0.f);
          ar = tx.x * ar;
          ag = tx.y * ag;
          ab = tx.z * ab;
        }
      }
      // triangles of a TRI_LIGHT's material emit its intensity (the last
      // such light wins, as in the TPU kernel's select chain)
      for (int li = 0; li < p.n_lights; ++li) {
        const int* S = c_lstruct + li * LS;
        if (S[0] != TRI_LIGHT || S[2] != mmat) continue;
        const float* LT = c_lights + li * 8;
        emissive = true;
        er = LT[3];
        eg = LT[4];
        eb = LT[5];
      }
    } else {
      const float* HP = c_prims + best_p * 12;
      const int pflag = c_pflags[best_p];
      mtype = (pflag >> 1) & 3;
      const float inv_r = 1.0f / HP[3];
      nx = (hx - HP[0]) * inv_r;
      ny = (hy - HP[1]) * inv_r;
      nz = (hz - HP[2]) * inv_r;
      ar = HP[4];
      ag = HP[5];
      ab = HP[6];
      coef = HP[7];
      if (pflag & 1) {
        emissive = true;
        er = HP[9];
        eg = HP[10];
        eb = HP[11];
      }
    }
    const bool is_s = mtype == SPECULAR, is_t = mtype == TRANSMISSIVE;
    const bool is_d = !(is_s || is_t);
    if (is_d) coef = 0.f;
    const float wox = dx, woy = dy, woz = dz;

    // ---- emitter hit (pathtracer.cu:134-137), MIS-weighted under NEE with
    // the squared power heuristic against the light's pdf
    if (emissive) {
      float take = dot3(nx, ny, nz, -wox, -woy, -woz) > 0.f ? 1.f : 0.f;
      if (p.use_nee) {
        // the light-sampling pdf of this emitter hit
        float ldp = 0.f;
        for (int li = 0; li < p.n_lights; ++li) {
          const int* S = c_lstruct + li * LS;
          if (mesh_hit && S[0] == TRI_LIGHT && S[2] == mmat)
            ldp = tri_light_pdf(tm, dot3(nx, ny, nz, dx, dy, dz),
                                c_lights[li * 8 + 7],
                                __ldg(p.mesh.tl + S[3] * TL_STRIDE + 13));
          else if (!mesh_hit && S[0] == AREA_LIGHT && S[1] == best_p)
            ldp = cone_pdf(c_prims + best_p * 12, ox, oy, oz) *
                  c_lights[li * 8 + 7];
        }
        const float pp2 = prev_pdf * prev_pdf;
        take *= prev_delta ? 1.f : pp2 / fmaxf(pp2 + ldp * ldp, 1e-20f);
      }
      Cr += Tr * er * take;
      Cg += Tg * eg * take;
      Cb += Tb * eb * take;
    }

    // ---- next-event estimation: one light chosen by usel against cdf_lo,
    // the last light taking the remainder; diffuse lanes only
    if (p.use_nee && is_d) {
      for (int li = 0; li < p.n_lights; ++li) {
        const float* LT = c_lights + li * 8;
        const float lo = LT[6], sel = LT[7];
        const bool m_l = li == p.n_lights - 1 ? usel >= lo
                                              : (usel >= lo && usel < lo + sel);
        if (!m_l) continue;
        const int* S = c_lstruct + li * LS;
        const bool area = S[0] == AREA_LIGHT && S[1] >= 0;
        const bool tri = MESH && S[0] == TRI_LIGHT;
        const LightSample ls =
            tri ? sample_tri_light(p.mesh.tl + S[3] * TL_STRIDE, S[4], LT, hx,
                                   hy, hz, ul1, ul2)
                : sample_light(LT, area ? c_prims + S[1] * 12 : nullptr, hx,
                               hy, hz, ul1, ul2);
        const float wlx = ls.wlx, wly = ls.wly, wlz = ls.wlz;
        const float pdf_l = ls.pdf;
        const float cos_l = dot3(wlx, wly, wlz, nx, ny, nz);
        const bool support = cos_l > 0.f && dot3(wox, woy, woz, wlx, wly, wlz) < 0.f;
        if (!(ls.valid && support)) continue;
        ++n_live;  // every needed shadow segment is a traced ray
        // shadow any-hit, segment-ball distance form: the segment
        // [tmin, smax] hits a sphere iff its nearest point to the centre is
        // within r. The sampled light sphere is skipped: its own hit lies
        // beyond smax by construction. Then the mesh, in occlusion mode.
        const float smax = fmaf(ls.dist, 0.999f, -TMIN);
        const int skip = area ? S[1] : -1;
        bool occ = false;
        for (int q = 0; q < p.n_prims && !occ; ++q) {
          if (q == skip) continue;
          const float* P = c_prims + q * 12;
          const float sx2 = P[0] - hx, sy2 = P[1] - hy, sz2 = P[2] - hz;
          const float rb = dot3_fma(sx2, sy2, sz2, wlx, wly, wlz);
          const float ts = fminf(fmaxf(rb, TMIN), smax);
          const float d2s = fmaf(-ts, __fsub_rn(2.f * rb, ts),
                                 dot3_fma(sx2, sy2, sz2, sx2, sy2, sz2));
          occ = d2s < __fmul_rn(P[3], P[3]);
        }
        if (MESH && !occ && smax > 0.f)
          occ = bvh_occluded(p.mesh, hx, hy, hz, wlx, wly, wlz, smax);
        if (occ) continue;
        // squared power heuristic against BSDF sampling; a point light is a
        // delta light with weight 1
        const float pdf_b = cos_l * INV_PI;
        const float w_mis =
            (area || tri)
                ? (pdf_l * pdf_l) / fmaxf(pdf_l * pdf_l + pdf_b * pdf_b, 1e-20f)
                : 1.f;
        const float scale = cos_l * w_mis / fmaxf(pdf_l, 1e-20f);
        Cr += Tr * (ar * INV_PI) * ls.rad_r * scale;
        Cg += Tg * (ag * INV_PI) * ls.rad_g * scale;
        Cb += Tb * (ab * INV_PI) * ls.rad_b * scale;
      }
    }

    // ---- BSDF sampling: one lobe per lane
    const Lobe lb = sample_lobe(is_s, is_t, nx, ny, nz, wox, woy, woz, ar, ag,
                                ab, coef, u1, u2);
    const float fr = lb.fr, fg = lb.fg, fb = lb.fb, pdf = lb.pdf, wgt = lb.wgt;
    const bool f_black = fr <= 0.f && fg <= 0.f && fb <= 0.f;
    const bool step_ok = !f_black && pdf > 0.f;
    if (step_ok) {
      Tr = Tr * fr * wgt;
      Tg = Tg * fg * wgt;
      Tb = Tb * fb * wgt;
    }

    // ---- Russian roulette once bounce > rr_start, p = min(0.5, max T)
    const bool do_rr = bounce > p.rr_start;
    const float p_cont = fminf(0.5f, fmaxf(Tr, fmaxf(Tg, Tb)));
    const bool survive = u3 <= p_cont;
    if (step_ok && do_rr && survive && p_cont > 0.f) {
      const float inv_p = 1.f / fmaxf(p_cont, 1e-20f);
      Tr *= inv_p;
      Tg *= inv_p;
      Tb *= inv_p;
    }
    const bool alive_next =
        step_ok && (survive || !do_rr) && bounce < p.max_bounces;
    if (!alive_next) {
      // path completion: flush per-path radiance into the pixel sum
      Lr += Cr;
      Lg += Cg;
      Lb += Cb;
      ++n_samp;
    }
    // ---- pending ray for the next iteration (MIS previous vertex = hit)
    ox = hx; oy = hy; oz = hz;
    dx = lb.wix; dy = lb.wiy; dz = lb.wiz;
    prev_pdf = pdf;
    prev_delta = !is_d;
    ++bounce;
    alive = alive_next;
  }

  s.lr[idx] = Lr; s.lg[idx] = Lg; s.lb[idx] = Lb;
  s.n_samp[idx] = n_samp;
  s.ox[idx] = ox; s.oy[idx] = oy; s.oz[idx] = oz;
  s.dx[idx] = dx; s.dy[idx] = dy; s.dz[idx] = dz;
  s.tr[idx] = Tr; s.tg[idx] = Tg; s.tb[idx] = Tb;
  s.cr[idx] = Cr; s.cg[idx] = Cg; s.cb[idx] = Cb;
  s.bounce[idx] = bounce;
  s.alive[idx] = alive ? 1 : 0;
  s.prev_pdf[idx] = prev_pdf;
  s.prev_delta[idx] = prev_delta ? 1 : 0;

  // per-tile live-ray count: warp sum, then one atomic per warp
  const int warp_sum = __reduce_add_sync(0xffffffffu, n_live);
  if ((col & 31) == 0) atomicAdd(p.nrays + tile, warp_sum);
}

template <bool MESH, bool TEX, bool DOF>
void launch(int rows, cudaStream_t st, const State& s, const Params& p) {
  persistent_kernel<MESH, TEX, DOF><<<rows, LANES, 0, st>>>(s, p);
}

}  // namespace

extern "C" {

// Launch one persistent step on `stream`. `state` is a host array of the 20
// device plane pointers in STATE_FIELDS order, each rows_total x 128 and
// updated in place. prims/lights/cam/uniforms/nrays and the mesh tables are
// device pointers; pflags/lstruct (LS ints per light) are host arrays. The
// prim, light and camera tables are copied into __constant__ memory on the
// same stream, so launches must stay on one stream. n_nodes == 0 means no
// mesh (its pointers are then not read); a non-NULL atlas (tex_k, tex_th,
// tex_tw, 3) with a mesh runs the textured build; use_dof the thin-lens
// build. Returns the first CUDA error (0 on success).
int tpt_persistent_step(void* const* state, const float* prims,
                        const int* pflags, int n_prims, const float* lights,
                        const int* lstruct, int n_lights, const float* cam,
                        const float* uniforms, int* nrays,
                        const float* mesh_nodes, const float* mesh_tris,
                        const float* mesh_mats,
                        const float* tri_lights, int n_nodes,
                        const float* atlas, int tex_k, int tex_th, int tex_tw,
                        int rows_total, int tile_rows, int budget, int width,
                        int n_lanes, int max_bounces, int rr_start,
                        int use_nee, int use_dof, int strat_k,
                        int tile_offset, uint32_t seed, uint32_t salt,
                        uint32_t frame, void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_lights < 0 ||
      n_lights > MAX_LIGHTS || rows_total <= 0 || tile_rows <= 0 ||
      rows_total % tile_rows != 0 || width <= 0 || strat_k < 1 ||
      n_nodes < 0 ||
      (n_nodes > 0 && !(mesh_nodes && mesh_tris && mesh_mats &&
                        tri_lights)) ||
      (atlas && (n_nodes == 0 || tex_k <= 0 || tex_th <= 0 || tex_tw <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n_prims > 0) {
    err = cudaMemcpyToSymbolAsync(c_prims, prims, sizeof(float) * 12 * n_prims,
                                  0, cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_pflags, pflags, sizeof(int) * n_prims,
                                    0, cudaMemcpyHostToDevice, st);
  }
  if (err == cudaSuccess && n_lights > 0) {
    err = cudaMemcpyToSymbolAsync(c_lights, lights,
                                  sizeof(float) * 8 * n_lights, 0,
                                  cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyToSymbolAsync(c_lstruct, lstruct,
                                    sizeof(int) * LS * n_lights, 0,
                                    cudaMemcpyHostToDevice, st);
  }
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_cam, cam, sizeof(float) * 24, 0,
                                  cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;

  State s;
  s.lr = (float*)state[0];
  s.lg = (float*)state[1];
  s.lb = (float*)state[2];
  s.n_samp = (int*)state[3];
  s.ox = (float*)state[4];
  s.oy = (float*)state[5];
  s.oz = (float*)state[6];
  s.dx = (float*)state[7];
  s.dy = (float*)state[8];
  s.dz = (float*)state[9];
  s.tr = (float*)state[10];
  s.tg = (float*)state[11];
  s.tb = (float*)state[12];
  s.cr = (float*)state[13];
  s.cg = (float*)state[14];
  s.cb = (float*)state[15];
  s.bounce = (int*)state[16];
  s.alive = (int*)state[17];
  s.prev_pdf = (float*)state[18];
  s.prev_delta = (int*)state[19];

  Params p;
  p.n_prims = n_prims;
  p.n_lights = n_lights;
  p.tile_rows = tile_rows;
  p.budget = budget;
  p.width = width;
  p.n_lanes = n_lanes;
  p.max_bounces = max_bounces;
  p.rr_start = rr_start;
  p.use_nee = use_nee;
  p.strat_k = strat_k;
  p.tile_offset = tile_offset;
  p.seed = seed;
  p.salt = salt;
  p.frame = frame;
  p.uniforms = uniforms;
  p.nrays = nrays;
  p.mesh.nodes = reinterpret_cast<const float4*>(mesh_nodes);
  p.mesh.tris = mesh_tris;
  p.mesh.mats = mesh_mats;
  p.mesh.tl = tri_lights;
  p.mesh.n_nodes = n_nodes;
  p.atlas = atlas;
  p.tex_k = tex_k;
  p.tex_th = tex_th;
  p.tex_tw = tex_tw;

  const int r = rows_total;
  if (n_nodes == 0)
    use_dof ? launch<false, false, true>(r, st, s, p)
            : launch<false, false, false>(r, st, s, p);
  else if (!atlas)
    use_dof ? launch<true, false, true>(r, st, s, p)
            : launch<true, false, false>(r, st, s, p);
  else
    use_dof ? launch<true, true, true>(r, st, s, p)
            : launch<true, true, false>(r, st, s, p);
  return (int)cudaGetLastError();
}

const char* tpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
