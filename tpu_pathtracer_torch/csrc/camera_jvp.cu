// Camera/IOR tangent kernel for Hopper (sm_90a).
//
// Replaces: tpu_pathtracer/ops/pallas/camera_jvp.py::_cjvp_kernel (launched
// by camera_jvp_call) for sphere and triangle-mesh scenes, brute force and
// NEE+MIS with point, sphere-area and triangle (TRI_LIGHT) lights. The JAX
// kernel refuses textured scenes, and so does the wrapper of this one; the
// JAX kernel reads a thin-lens camera as a pinhole one, which the wrapper
// refuses instead (ops/kernels/camera_jvp.py).
//
// What it computes: forward-mode tangents through one walk of the persistent
// regeneration schedule (one lane per pixel; a dead lane starts its pixel's
// next stratified sample while it has completed fewer than spp). Beside the
// primal path state every lane carries T tangents (T = 1..4, a template
// argument): the tangents of the ray origin and direction, of the throughput
// and of the path radiance C, and the per-pixel tangent sums dL. A camera
// tangent enters through its row of d pack_camera / d theta at
// regeneration; an IOR tangent (d / d mat_coef[m]) enters at m's
// transmissive vertices as the d(eta) source of the refraction JVP, and the
// Fresnel coin's motion through a streaming score (sS, cS), flushed at path
// completion as C_tot * sS - cS. Sampling is attached (the diffuse frame and
// the light samples move with the hit), the discrete decisions are detached
// (closest prim, occlusion, light choice, support, Russian roulette and its
// boost, the coin), and hit points follow the implicit function theorem,
// dt = -(n.do + t n.dd) / (n.d). Outputs per lane: L, dL_j, n_samp; per
// 128-lane row: the live rays (lanes alive after regeneration per iteration
// plus the NEE shadow segments needed).
//
// What bounds it on this card: a long, divergent ALU state machine, like the
// forward kernel, with each tangent adding its own chains (IFT, ONB and
// reflect/refract JVPs, light-sample and MIS tangents, throughput). Its
// device-memory traffic is the 3 + 3T output planes and the sample counts
// written once (and the uniform block read, in test mode).
//
// What the design does about it:
//  * one thread per lane, one 128-thread block per 128-lane row of the
//    layout, the path and its tangents in registers, as in persistent.cu;
//  * a lane that will neither act nor regenerate draws no uniforms (its
//    draws would go unused), and a warp none of whose lanes will has
//    drained and leaves the loop: on Cornell a path averages ~3.8 segments,
//    so a pixel's spp paths end well before the budget;
//  * what changes only where a path ends, the radiance sums L and the
//    per-tangent sums dL, and the IOR score state (sS, cS), which changes
//    only at an IOR tangent's transmissive vertices, live in dynamic shared
//    memory, [word][lane] (3 + 7T words per lane, smem_bytes; the launcher
//    passes ops/kernels/camera_jvp.py::tangent_smem_bytes), so they
//    hold no registers across the walk; each thread touches only its own
//    column, so no barrier is needed; the prim,
//    light, camera and tangent-row tables sit in __constant__ memory (copied
//    device to device), the per-prim flags, the light structure and the
//    tangent materials travel in the kernel's parameters, so a launch makes
//    no copy from host memory;
//  * the tangent count is a template argument, so every per-tangent array
//    is unrolled into registers; the wrapper splits more tangents into
//    launches of at most 4 on the same seed (exact: tangents never feed back
//    into the primal's decisions). Each (MESH, T) build has its own
//    __launch_bounds__;
//  * MESH is a template argument too, so a sphere scene does not carry the
//    BVH walk's registers;
//  * the primal reuses pt_common.cuh (uniforms, the BVH walk bvh_walk over
//    pack_bvh's tree, light samples, emitter pdfs), built here without FMA
//    contraction like the rest of the file; the tangent helpers recompute
//    the intermediates they need from the same inputs, which the compiler
//    folds into the primal's;
//  * the per-row ray count is a fixed block reduction with no atomics, so a
//    launch replays bit for bit; every output equals the previous
//    register-resident kernel's bit for bit (chip_smoke.py --ab);
//  * nvcc builds this file without FMA contraction (-fmad=false, see
//    _build.py): it fuses only where it calls fmaf, where the plain version
//    calls its explicit FMA, so both round alike and a fault cannot hide in
//    the lanes that f32 rounding would otherwise set apart.
//
// Differences from the forward kernel that are the TPU tangent kernel's
// own: regeneration stops at spp completed paths; the Fresnel lobe's cos_t
// is sqrt(max(1 - sin2t, 1e-12)); a point light's radiance is I * (1/d^2)
// applied after the BSDF factor, in the JAX kernel's order of products.
//
// Randomness: test mode reads the TPU kernel's external uniform block;
// production mode draws Philox4x32-10 under stream tag 0x20000, apart from
// every draw of the forward (0) and gradient (0x10000) kernels.
//
// C interface (loaded with ctypes): tpt_camera_jvp, tpt_camera_jvp_occupancy.

#include "pt_common.cuh"

namespace {

constexpr int MAX_TAN = 4;

__constant__ float c_prims[MAX_PRIMS * 12];  // pack_prims layout
__constant__ float c_lights[MAX_LIGHTS * 8];  // pack_lights layout
__constant__ float c_cam[24];                // pack_camera layout
__constant__ float c_dcam[MAX_TAN * 24];     // tangent rows of pack_camera

struct Params {
  int n_prims, n_lights, tile_rows, budget, spp, width, n_lanes;
  int max_bounces, rr_start, use_nee, strat_k, tile_offset;
  uint32_t seed, salt, iteration;
  const float* uniforms;  // NULL: production Philox
  float* out;             // (3 + 3T) planes of rows*128: L rgb, dL_j rgb
  int* n_samp;            // (rows, 128) completed paths
  int* nrays;             // (rows,) live rays per 128-lane row
  MeshView mesh;          // n_nodes 0: no mesh
  int tan_mat[MAX_TAN];   // material of an IOR tangent, -1: camera tangent
  int pinfo[MAX_PRIMS];   // bit 0 emissive, bits 1-2 type, bits 3+ material
  int lstruct[MAX_LIGHTS * LS];  // light structure (pt_common.cuh)
};

// Tangent of cone_pdf(LP, o) along the previous vertex's tangent `to`
// (camera_jvp.py:423-455).
__device__ __forceinline__ float cone_pdf_tangent(const float* LP, float ox,
                                                  float oy, float oz,
                                                  float tox, float toy,
                                                  float toz) {
  const float elx = LP[0] - ox, ely = LP[1] - oy, elz = LP[2] - oz;
  const float e2l = dot3(elx, ely, elz, elx, ely, elz);
  const float rl = LP[3];
  const float sin2 = fminf(rl * rl / fmaxf(e2l, 1e-12f), 1.f);
  const float ctm = sqrtf(fmaxf(1.f - sin2, 0.f));
  const float omc = fmaxf(1.f - ctm, 1e-12f);
  const float pc = 1.f / (TWO_PI * omc);
  const float de2l = -2.f * dot3(elx, ely, elz, tox, toy, toz);
  const float dsin2 =
      sin2 < 1.f ? -(rl * rl) / fmaxf(e2l * e2l, 1e-12f) * de2l : 0.f;
  const float dctm = ctm > 1e-6f ? -0.5f * dsin2 / fmaxf(ctm, 1e-6f) : 0.f;
  return e2l > rl * rl ? pc / omc * dctm : 0.f;
}

// Tangents of sample_light's cone sample of sphere light LP from the moving
// hit point: the sampling frame rotates with wc = normalize(c - h)
// (camera_jvp.py:516-614). Writes d wl and d pdf per tangent.
template <int T>
__device__ __forceinline__ void area_light_tangent(
    const float* LP, float sel, float hx, float hy, float hz, float ul1,
    float ul2, const float (&dpx)[T], const float (&dpy)[T],
    const float (&dpz)[T], float (&dwlx)[T], float (&dwly)[T],
    float (&dwlz)[T], float (&dpdf)[T]) {
  const float wrx = LP[0] - hx, wry = LP[1] - hy, wrz = LP[2] - hz;
  const float rl = LP[3];
  const float d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz);
  const float inv_dc = rsqrtf(fmaxf(d2l, 1e-20f));
  const float wcx = wrx * inv_dc, wcy = wry * inv_dc, wcz = wrz * inv_dc;
  const float sin2 = fminf(rl * rl / fmaxf(d2l, 1e-12f), 1.f);
  const float ctm = sqrtf(fmaxf(1.f - sin2, 0.f));
  const float omc = fmaxf(1.f - ctm, 1e-12f);
  const float cth = 1.f - ul1 * (1.f - ctm);
  const float sth = sqrtf(fmaxf(1.f - cth * cth, 0.f));
  const float phi = TWO_PI * ul2;
  const bool usex = fabsf(wcx) > fabsf(wcz);
  const float gax = usex ? -wcy : 0.f, gay = usex ? wcx : -wcz,
              gaz = usex ? 0.f : wcy;
  const float inv_a = rsqrtf(fmaxf(gax * gax + gay * gay + gaz * gaz, 1e-20f));
  const float ax = gax * inv_a, ay = gay * inv_a, az = gaz * inv_a;
  const float bx = wcy * az - wcz * ay;
  const float by = wcz * ax - wcx * az;
  const float bz = wcx * ay - wcy * ax;
  const float cphi = cosf(phi), sphi = sinf(phi);
  const float cp = cphi * sth, sp = sphi * sth;
  const float pdf_l = sel / (TWO_PI * omc);
#pragma unroll
  for (int j = 0; j < T; ++j) {
    // d(wr) = -dp: the light's centre is fixed
    const float dd2l = -2.f * dot3(wrx, wry, wrz, dpx[j], dpy[j], dpz[j]);
    const float dinv_dc = -0.5f * inv_dc * inv_dc * inv_dc * dd2l;
    const float dwcx = -dpx[j] * inv_dc + wrx * dinv_dc;
    const float dwcy = -dpy[j] * inv_dc + wry * dinv_dc;
    const float dwcz = -dpz[j] * inv_dc + wrz * dinv_dc;
    const float dsin2 =
        sin2 < 1.f ? -(rl * rl) / fmaxf(d2l * d2l, 1e-12f) * dd2l : 0.f;
    const float dctm = ctm > 1e-6f ? -0.5f * dsin2 / fmaxf(ctm, 1e-6f) : 0.f;
    const float dcth = ul1 * dctm;
    const float dsth = sth > 1e-6f ? -cth * dcth / fmaxf(sth, 1e-6f) : 0.f;
    const float dgax = usex ? -dwcy : 0.f, dgay = usex ? dwcx : -dwcz,
                dgaz = usex ? 0.f : dwcy;
    const float a_dg = ax * dgax + ay * dgay + az * dgaz;
    const float dax = (dgax - ax * a_dg) * inv_a;
    const float day = (dgay - ay * a_dg) * inv_a;
    const float daz = (dgaz - az * a_dg) * inv_a;
    const float dbx = dwcy * az + wcy * daz - dwcz * ay - wcz * day;
    const float dby = dwcz * ax + wcz * dax - dwcx * az - wcx * daz;
    const float dbz = dwcx * ay + wcx * day - dwcy * ax - wcy * dax;
    const float dcp = cphi * dsth, dsp = sphi * dsth;
    dwlx[j] = dax * cp + ax * dcp + dbx * sp + bx * dsp + dwcx * cth +
              wcx * dcth;
    dwly[j] = day * cp + ay * dcp + dby * sp + by * dsp + dwcy * cth +
              wcy * dcth;
    dwlz[j] = daz * cp + az * dcp + dbz * sp + bz * dsp + dwcz * cth +
              wcz * dcth;
    dpdf[j] = pdf_l / omc * dctm;
  }
}

// Tangents of sample_tri_light's sample from the moving hit point: the
// sampled point is fixed, so only the distance, direction and the pdf's
// d^2 / |cos| move (camera_jvp.py:615-680).
template <int T>
__device__ __forceinline__ void tri_light_tangent(
    const float* TL, int K, float sel, float hx, float hy, float hz,
    float ul1, float ul2, const float (&dpx)[T], const float (&dpy)[T],
    const float (&dpz)[T], float (&dwlx)[T], float (&dwly)[T],
    float (&dwlz)[T], float (&dpdf)[T]) {
  int k = 0;
  for (int q = 1; q < K; ++q)
    if (ul1 > __ldg(TL + (q - 1) * TL_STRIDE + 12)) k = q;
  const float* R = TL + k * TL_STRIDE;
  const float c_lo = k ? __ldg(R - TL_STRIDE + 12) : 0.f;
  const float c_hi = __ldg(R + 12);
  const float u0r =
      fminf(fmaxf((ul1 - c_lo) / fmaxf(c_hi - c_lo, 1e-12f), 0.f), 1.f);
  const float su = sqrtf(u0r);
  const float b1 = 1.f - su, b2 = ul2 * su;
  const float wrx = __ldg(R) + b1 * __ldg(R + 3) + b2 * __ldg(R + 6) - hx;
  const float wry = __ldg(R + 1) + b1 * __ldg(R + 4) + b2 * __ldg(R + 7) - hy;
  const float wrz = __ldg(R + 2) + b1 * __ldg(R + 5) + b2 * __ldg(R + 8) - hz;
  const float nlx = __ldg(R + 9), nly = __ldg(R + 10), nlz = __ldg(R + 11);
  const float d2l = dot3(wrx, wry, wrz, wrx, wry, wrz);
  const float inv_dl = rsqrtf(fmaxf(d2l, 1e-20f));
  const float wlx = wrx * inv_dl, wly = wry * inv_dl, wlz = wrz * inv_dl;
  const float cos_at = -dot3(nlx, nly, nlz, wlx, wly, wlz);
  const float abs_ca = fmaxf(fabsf(cos_at), 1e-9f);
  const float sgn_ca = (float)((cos_at > 0.f) - (cos_at < 0.f));
  const float pdf_l =
      sel * d2l / fmaxf(fabsf(cos_at) * fmaxf(__ldg(R + 13), 1e-20f), 1e-12f);
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float dd2l = -2.f * dot3(wrx, wry, wrz, dpx[j], dpy[j], dpz[j]);
    const float dinv_dl = -0.5f * inv_dl * inv_dl * inv_dl * dd2l;
    dwlx[j] = -dpx[j] * inv_dl + wrx * dinv_dl;
    dwly[j] = -dpy[j] * inv_dl + wry * dinv_dl;
    dwlz[j] = -dpz[j] * inv_dl + wrz * dinv_dl;
    const float dcos_at = -dot3(nlx, nly, nlz, dwlx[j], dwly[j], dwlz[j]);
    dpdf[j] = pdf_l * (dd2l / fmaxf(d2l, 1e-12f) - sgn_ca * dcos_at / abs_ca);
  }
}

// Point light LT from the moving hit point (camera_jvp.py:683-705): returns
// the falloff 1/d^2 and writes the tangents of wl and of the falloff.
template <int T>
__device__ __forceinline__ float point_light_tangent(
    const float* LT, float hx, float hy, float hz, const float (&dpx)[T],
    const float (&dpy)[T], const float (&dpz)[T], float (&dwlx)[T],
    float (&dwly)[T], float (&dwlz)[T], float (&dfac)[T]) {
  const float wrx = LT[0] - hx, wry = LT[1] - hy, wrz = LT[2] - hz;
  const float d2l = dot3(wrx, wry, wrz, wrx, wry, wrz);
  const float inv_dl = rsqrtf(fmaxf(d2l, 1e-20f));
  const float wlx = wrx * inv_dl, wly = wry * inv_dl, wlz = wrz * inv_dl;
  const float fac = inv_dl * inv_dl;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float dd2l = -2.f * dot3(wrx, wry, wrz, dpx[j], dpy[j], dpz[j]);
    dfac[j] = -fac * fac * dd2l;
    const float wl_dwr = -dot3(wlx, wly, wlz, dpx[j], dpy[j], dpz[j]);
    dwlx[j] = (-dpx[j] - wlx * wl_dwr) * inv_dl;
    dwly[j] = (-dpy[j] - wly * wl_dwr) * inv_dl;
    dwlz[j] = (-dpz[j] - wlz * wl_dwr) * inv_dl;
  }
  return fac;
}

// Path completion into a lane's column `acc` of the sums (word w at
// acc[w * LANES]): the radiance, the tangents and the score suffix sum_b
// s_b (C_tot - C_b) = C_tot sS - cS, added in the previous kernel's order;
// the score state is cleared for the lane's next path (it is zero when a
// path starts).
template <int T>
__device__ __forceinline__ void flush_path(
    float* acc, const bool (&ior)[T], float Cr, float Cg, float Cb,
    const float (&tCr)[T], const float (&tCg)[T], const float (&tCb)[T]) {
  acc[0] += Cr;
  acc[LANES] += Cg;
  acc[2 * LANES] += Cb;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float* const dl = acc + (3 + 3 * j) * LANES;
    float vr = dl[0] + tCr[j], vg = dl[LANES] + tCg[j],
          vb = dl[2 * LANES] + tCb[j];
    if (ior[j]) {
      float* const sc = acc + (3 + 3 * T + 4 * j) * LANES;
      const float sS = sc[0];
      vr += Cr * sS - sc[LANES];
      vg += Cg * sS - sc[2 * LANES];
      vb += Cb * sS - sc[3 * LANES];
      sc[0] = sc[LANES] = sc[2 * LANES] = sc[3 * LANES] = 0.f;
    }
    dl[0] = vr;
    dl[LANES] = vg;
    dl[2 * LANES] = vb;
  }
}

// Blocks per SM, chosen per build by chip_smoke.py --ab (PERF.md): 5 at
// T = 1 (96 registers), 4 from T = 2 (128 registers; T = 3 and 4 spill
// some of their tangent chains, and still ran 4-11% faster than at 3
// blocks with 151-168 registers).
constexpr int min_blocks(int T) { return T <= 1 ? 5 : 4; }

// Words of shared memory per lane for T tangents: L rgb, then dL rgb per
// tangent, then sS, cS rgb per tangent.
__host__ __device__ constexpr int acc_words(int T) { return 3 + 7 * T; }
__host__ __device__ constexpr int smem_bytes(int T) {
  return acc_words(T) * LANES * 4;
}
static_assert(smem_bytes(MAX_TAN) <= 48 * 1024,
              "the widest build needs no shared-memory opt-in");

template <bool MESH, int T>
__global__ void __launch_bounds__(LANES, min_blocks(T))
    camera_jvp_kernel(const __grid_constant__ Params p) {
  __shared__ int iscratch[4];
  extern __shared__ float acc_smem[];
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
  const int n_draw = p.use_nee ? 8 : 5;
  bool ior[T];
#pragma unroll
  for (int j = 0; j < T; ++j) ior[j] = p.tan_mat[j] >= 0;

  // this lane's column of the sums: word w at acc[w * LANES]
  float* const acc = acc_smem + col;
#pragma unroll
  for (int w = 0; w < acc_words(T); ++w) acc[w * LANES] = 0.f;
  int n_samp = 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float Tr = 0.f, Tg = 0.f, Tb = 0.f, Cr = 0.f, Cg = 0.f, Cb = 0.f;
  int bounce = 0;
  bool alive = false;
  float prev_pdf = 0.f;
  bool prev_delta = false;
  // per tangent: origin, direction, throughput and path radiance tangents
  float tox[T], toy[T], toz[T], tdx[T], tdy[T], tdz[T];
  float tTr[T], tTg[T], tTb[T], tCr[T], tCg[T], tCb[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    tox[j] = toy[j] = toz[j] = tdx[j] = tdy[j] = tdz[j] = 0.f;
    tTr[j] = tTg[j] = tTb[j] = tCr[j] = tCg[j] = tCb[j] = 0.f;
  }
  int n_live = 0;

  for (int it = 0; it < p.budget; ++it) {
    // a lane acts while its path is alive or its pixel has samples left; a
    // warp none of whose lanes acts has drained and stops (break, not
    // return: block_sum_int below needs every thread), and a lane that does
    // not act draws nothing (its draws would go unused)
    const bool acts = alive || (in_domain && n_samp < p.spp);
    if (!__any_sync(0xffffffffu, acts)) break;
    if (!acts) continue;
    float u[8];
    draw_uniforms(u, p.uniforms, tile, p.budget, it, n_draw, tile_lanes, trow,
                  col, lane, p.iteration, p.seed, p.salt,
                  STREAM_TANGENT);
    const float u1 = u[2], u2 = u[3], u3 = u[4];
    const float ul1 = u[5], ul2 = u[6], usel = u[7];

    // ---- regenerate while the pixel has samples left, with the primary
    // ray's tangents: d normalize(g) = (dg - n (n.dg)) / |g|
    if (!alive) {
      float jx, jy;
      if (p.strat_k > 1) {
        const float inv_k = 1.0f / (float)p.strat_k;
        const int cell = n_samp % (p.strat_k * p.strat_k);
        jx = ((float)(cell % p.strat_k) + u[0]) * inv_k - 0.5f;
        jy = ((float)(cell / p.strat_k) + u[1]) * inv_k - 0.5f;
      } else {
        jx = u[0] - 0.5f;
        jy = u[1] - 0.5f;
      }
      const float sx = px + jx, sy = py + jy;
      const float gdx = c_cam[0] - c_cam[6] * sy + c_cam[3] * sx;
      const float gdy = c_cam[1] - c_cam[7] * sy + c_cam[4] * sx;
      const float gdz = c_cam[2] - c_cam[8] * sy + c_cam[5] * sx;
      const float inv_g = rsqrtf(fmaxf(gdx * gdx + gdy * gdy + gdz * gdz, 1e-20f));
      dx = gdx * inv_g;
      dy = gdy * inv_g;
      dz = gdz * inv_g;
      ox = c_cam[9];
      oy = c_cam[10];
      oz = c_cam[11];
      Tr = Tg = Tb = 1.f;
      Cr = Cg = Cb = 0.f;
      bounce = 0;
      prev_pdf = 0.f;
      prev_delta = true;
      alive = true;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float* D = c_dcam + j * 24;
        const float tgx = D[0] - D[6] * sy + D[3] * sx;
        const float tgy = D[1] - D[7] * sy + D[4] * sx;
        const float tgz = D[2] - D[8] * sy + D[5] * sx;
        const float gdot = dx * tgx + dy * tgy + dz * tgz;
        tox[j] = D[9];
        toy[j] = D[10];
        toz[j] = D[11];
        tdx[j] = (tgx - dx * gdot) * inv_g;
        tdy[j] = (tgy - dy * gdot) * inv_g;
        tdz[j] = (tgz - dz * gdot) * inv_g;
        tTr[j] = tTg[j] = tTb[j] = tCr[j] = tCg[j] = tCb[j] = 0.f;
      }
    }
    ++n_live;

    // ---- closest hit; `<=` keeps the LAST prim on an exact tie, as the
    // TPU kernel's attribute pass does; then the mesh, pruned from the
    // sphere t (a triangle wins only if strictly closer)
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
    float tm = BIG, gnx = 0.f, gny = 0.f, gnz = 0.f, hu, hv;
    int mmat = -1;
    if (MESH)
      tm = bvh_walk<false, false>(p.mesh, ox, oy, oz, dx, dy, dz, best_t,
                                  gnx, gny, gnz, mmat, hu, hv);
    const bool mesh_hit = tm < best_t && tm < 0.5f * BIG;
    if (!mesh_hit && !(best_t < 0.5f * BIG)) {
      // miss: the path ends and flushes, its score suffix included
      flush_path<T>(acc, ior, Cr, Cg, Cb, tCr, tCg, tCb);
      ++n_samp;
      alive = false;
      continue;
    }
    const float t_hit = mesh_hit ? tm : best_t;
    const float hx = fmaf(dx, t_hit, ox), hy = fmaf(dy, t_hit, oy),
                hz = fmaf(dz, t_hit, oz);
    float nx, ny, nz, ar, ag, ab, coef, inv_r = 0.f;
    float er = 0.f, eg = 0.f, eb = 0.f;
    int mtype, mat;
    bool emissive = false;
    if (mesh_hit) {
      const float inv_len =
          rsqrtf(fmaxf(gnx * gnx + gny * gny + gnz * gnz, 1e-20f));
      nx = gnx * inv_len;
      ny = gny * inv_len;
      nz = gnz * inv_len;
      const float* MT = p.mesh.mats + mmat * MAT_STRIDE;
      ar = __ldg(MT);
      ag = __ldg(MT + 1);
      ab = __ldg(MT + 2);
      coef = __ldg(MT + 3);
      mtype = (int)__ldg(MT + 4);
      mat = mmat;
      for (int li = 0; li < p.n_lights; ++li) {  // the last such light wins
        const int* S = p.lstruct + li * LS;
        if (S[0] != TRI_LIGHT || S[2] != mmat) continue;
        const float* LT = c_lights + li * 8;
        emissive = true;
        er = LT[3];
        eg = LT[4];
        eb = LT[5];
      }
    } else {
      const float* HP = c_prims + best_p * 12;
      const int info = p.pinfo[best_p];
      mtype = (info >> 1) & 3;
      mat = info >> 3;
      inv_r = 1.0f / HP[3];  // flat triangles keep inv_r = 0: dn = 0
      nx = (hx - HP[0]) * inv_r;
      ny = (hy - HP[1]) * inv_r;
      nz = (hz - HP[2]) * inv_r;
      ar = HP[4];
      ag = HP[5];
      ab = HP[6];
      coef = HP[7];
      if (info & 1) {
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

    // ---- geometry tangents (IFT on the hit surface); an IOR tangent's
    // vertex mask: its material's transmissive hits, where ior = max(coef,
    // 1) has a derivative
    const float nd = dot3(nx, ny, nz, dx, dy, dz);
    const float nd_safe = fabsf(nd) > 1e-6f ? nd : (nd >= 0.f ? 1e-6f : -1e-6f);
    float dpx[T], dpy[T], dpz[T], dnx[T], dny[T], dnz[T];
    bool tmask[T];
    bool any_tm = false;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float n_do = dot3(nx, ny, nz, tox[j], toy[j], toz[j]);
      const float n_dd = dot3(nx, ny, nz, tdx[j], tdy[j], tdz[j]);
      const float dt = -(n_do + t_hit * n_dd) / nd_safe;
      dpx[j] = tox[j] + dx * dt + tdx[j] * t_hit;
      dpy[j] = toy[j] + dy * dt + tdy[j] * t_hit;
      dpz[j] = toz[j] + dz * dt + tdz[j] * t_hit;
      dnx[j] = dpx[j] * inv_r;
      dny[j] = dpy[j] * inv_r;
      dnz[j] = dpz[j] * inv_r;
      tmask[j] = ior[j] && is_t && mat == p.tan_mat[j] && coef > 1.f;
      any_tm |= tmask[j];
    }

    // ---- emitter hit, MIS-weighted under NEE: a sphere light's cone pdf
    // moves with the previous vertex; the carried BSDF pdf and a triangle
    // emitter's pdf are detached
    if (emissive && dot3(nx, ny, nz, -wox, -woy, -woz) > 0.f) {
      float w_emit = 1.f, dw_emit[T];
#pragma unroll
      for (int j = 0; j < T; ++j) dw_emit[j] = 0.f;
      if (p.use_nee && !prev_delta) {
        float ldp = 0.f, dldp[T];
#pragma unroll
        for (int j = 0; j < T; ++j) dldp[j] = 0.f;
        for (int li = 0; li < p.n_lights; ++li) {
          const int* S = p.lstruct + li * LS;
          if (mesh_hit && S[0] == TRI_LIGHT && S[2] == mmat) {
            ldp = tri_light_pdf(tm, dot3(nx, ny, nz, dx, dy, dz),
                                c_lights[li * 8 + 7],
                                __ldg(p.mesh.tl + S[3] * TL_STRIDE + 13));
#pragma unroll
            for (int j = 0; j < T; ++j) dldp[j] = 0.f;
          } else if (!mesh_hit && S[0] == AREA_LIGHT && S[1] == best_p) {
            const float* LP = c_prims + best_p * 12;
            const float sel = c_lights[li * 8 + 7];
            ldp = cone_pdf(LP, ox, oy, oz) * sel;
#pragma unroll
            for (int j = 0; j < T; ++j)
              dldp[j] = cone_pdf_tangent(LP, ox, oy, oz, tox[j], toy[j],
                                         toz[j]) * sel;
          }
        }
        const float pp2 = prev_pdf * prev_pdf;
        const float denom = fmaxf(pp2 + ldp * ldp, 1e-20f);
        w_emit = pp2 / denom;
        // d[a/(a+b)] = -w db/(a+b): a squared denominator overflows f32
#pragma unroll
        for (int j = 0; j < T; ++j)
          dw_emit[j] = -w_emit * (2.f * ldp * dldp[j]) / denom;
      }
      Cr += Tr * er * w_emit;
      Cg += Tg * eg * w_emit;
      Cb += Tb * eb * w_emit;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        tCr[j] += er * (tTr[j] * w_emit + Tr * dw_emit[j]);
        tCg[j] += eg * (tTg[j] * w_emit + Tg * dw_emit[j]);
        tCb[j] += eb * (tTb[j] * w_emit + Tb * dw_emit[j]);
      }
    }

    // ---- next-event estimation on diffuse lanes: one light chosen by
    // usel, its sample moving with the hit; occlusion, choice and support
    // are detached
    if (p.use_nee && is_d) {
      for (int li = 0; li < p.n_lights; ++li) {
        const float* LT = c_lights + li * 8;
        const float lo = LT[6], sel = LT[7];
        const bool m_l = li == p.n_lights - 1 ? usel >= lo
                                              : (usel >= lo && usel < lo + sel);
        if (!m_l) continue;
        const int* S = p.lstruct + li * LS;
        const bool area = S[0] == AREA_LIGHT && S[1] >= 0;
        const bool tri = S[0] == TRI_LIGHT;
        if (tri && !MESH) continue;  // triangle lights need the mesh tables
        const LightSample ls =
            tri ? sample_tri_light(p.mesh.tl + S[3] * TL_STRIDE, S[4], LT, hx,
                                   hy, hz, ul1, ul2)
                : sample_light(LT, area ? c_prims + S[1] * 12 : nullptr, hx,
                               hy, hz, ul1, ul2);
        const float wlx = ls.wlx, wly = ls.wly, wlz = ls.wlz;
        const float cos_l = dot3(wlx, wly, wlz, nx, ny, nz);
        const bool support =
            cos_l > 0.f && dot3(wox, woy, woz, wlx, wly, wlz) < 0.f;
        if (!(ls.valid && support)) continue;
        ++n_live;  // every needed shadow segment is a traced ray
        // shadow any-hit: segment-ball distance form over every prim but the
        // sampled light sphere, then the mesh in occlusion mode
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
        float fac = 1.f, dwlx[T], dwly[T], dwlz[T], dpdf[T], dfac[T];
#pragma unroll
        for (int j = 0; j < T; ++j) dpdf[j] = dfac[j] = 0.f;
        if (tri)
          tri_light_tangent<T>(p.mesh.tl + S[3] * TL_STRIDE, S[4], sel, hx,
                               hy, hz, ul1, ul2, dpx, dpy, dpz, dwlx, dwly,
                               dwlz, dpdf);
        else if (area)
          area_light_tangent<T>(c_prims + S[1] * 12, sel, hx, hy, hz, ul1,
                                ul2, dpx, dpy, dpz, dwlx, dwly, dwlz, dpdf);
        else
          fac = point_light_tangent<T>(LT, hx, hy, hz, dpx, dpy, dpz, dwlx,
                                       dwly, dwlz, dfac);
        const bool delta = !(area || tri);
        const float pdf_l = ls.pdf;
        const float ipl = 1.f / fmaxf(pdf_l, 1e-20f);
        const float pdf_b = cos_l * INV_PI;
        const float mden = fmaxf(pdf_l * pdf_l + pdf_b * pdf_b, 1e-20f);
        const float w_mis = delta ? 1.f : (pdf_l * pdf_l) / mden;
        const float scale = cos_l * w_mis * ipl;
        const float fir = ar * INV_PI * LT[3], fig = ag * INV_PI * LT[4],
                    fib = ab * INV_PI * LT[5];
        Cr += Tr * (ar * INV_PI) * LT[3] * fac * scale;
        Cg += Tg * (ag * INV_PI) * LT[4] * fac * scale;
        Cb += Tb * (ab * INV_PI) * LT[5] * fac * scale;
#pragma unroll
        for (int j = 0; j < T; ++j) {
          const float dcos_l = dot3(dwlx[j], dwly[j], dwlz[j], nx, ny, nz) +
                               dot3(wlx, wly, wlz, dnx[j], dny[j], dnz[j]);
          // w = a/(a+b): dw = ((1-w) da - w db)/(a+b), no squared
          // denominator (it overflows at grazing cone pdfs)
          const float dw_mis =
              delta ? 0.f
                    : ((1.f - w_mis) * 2.f * pdf_l * dpdf[j] -
                       w_mis * 2.f * pdf_b * (dcos_l * INV_PI)) / mden;
          const float dscale = dcos_l * w_mis * ipl + cos_l * dw_mis * ipl -
                               cos_l * w_mis * dpdf[j] * ipl * ipl;
          tCr[j] += fir * (tTr[j] * fac * scale + Tr * dfac[j] * scale +
                           Tr * fac * dscale);
          tCg[j] += fig * (tTg[j] * fac * scale + Tg * dfac[j] * scale +
                           Tg * fac * dscale);
          tCb[j] += fib * (tTb[j] * fac * scale + Tb * dfac[j] * scale +
                           Tb * fac * dscale);
        }
      }
    }

    // ---- BSDF sampling with its tangents: the attached diffuse frame
    // (wi = ONB(n) @ l, l detached), the mirror and the dielectric JVPs
    const float won = dot3(wox, woy, woz, nx, ny, nz);
    float wix, wiy, wiz, fr, fg, fb, pdf, wgt;
    float twix[T], twiy[T], twiz[T], dwgt[T];
    if (is_d) {
      const float r_d = sqrtf(u1);
      const float th = TWO_PI * u2;
      const float ldx = r_d * cosf(th), ldy = r_d * sinf(th);
      const float ldz = sqrtf(fmaxf(1.f - u1, 0.f));
      const bool use_x = fabsf(nx) > fabsf(nz);
      const float gux = use_x ? -ny : 0.f, guy = use_x ? nx : -nz,
                  guz = use_x ? 0.f : ny;
      const float inv_u =
          rsqrtf(fmaxf(gux * gux + guy * guy + guz * guz, 1e-20f));
      const float ux = gux * inv_u, uy = guy * inv_u, uz = guz * inv_u;
      const float vx = ny * uz - nz * uy;
      const float vy = nz * ux - nx * uz;
      const float vz = nx * uy - ny * ux;
      wix = ux * ldx + vx * ldy + nx * ldz;
      wiy = uy * ldx + vy * ldy + ny * ldz;
      wiz = uz * ldx + vz * ldy + nz * ldz;
      pdf = dot3(wox, woy, woz, wix, wiy, wiz) < 0.f ? ldz * INV_PI : 0.f;
      fr = ar * INV_PI;
      fg = ag * INV_PI;
      fb = ab * INV_PI;
      wgt = PI_F;  // cos/pdf is exactly pi, and tangent-free
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float dgux = use_x ? -dny[j] : 0.f;
        const float dguy = use_x ? dnx[j] : -dnz[j];
        const float dguz = use_x ? 0.f : dny[j];
        const float u_dg = ux * dgux + uy * dguy + uz * dguz;
        const float dux = (dgux - ux * u_dg) * inv_u;
        const float duy = (dguy - uy * u_dg) * inv_u;
        const float duz = (dguz - uz * u_dg) * inv_u;
        const float dvx = dny[j] * uz + ny * duz - dnz[j] * uy - nz * duy;
        const float dvy = dnz[j] * ux + nz * dux - dnx[j] * uz - nx * duz;
        const float dvz = dnx[j] * uy + nx * duy - dny[j] * ux - ny * dux;
        twix[j] = dux * ldx + dvx * ldy + dnx[j] * ldz;
        twiy[j] = duy * ldx + dvy * ldy + dny[j] * ldz;
        twiz[j] = duz * ldx + dvz * ldy + dnz[j] * ldz;
        dwgt[j] = 0.f;
      }
    } else {
      // mirror reflection, shared by the specular lobe and the dielectric
      const float wsx = wox - 2.f * won * nx;
      const float wsy = woy - 2.f * won * ny;
      const float wsz = woz - 2.f * won * nz;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float dwon = dot3(tdx[j], tdy[j], tdz[j], nx, ny, nz) +
                           dot3(wox, woy, woz, dnx[j], dny[j], dnz[j]);
        twix[j] = tdx[j] - 2.f * (dwon * nx + won * dnx[j]);
        twiy[j] = tdy[j] - 2.f * (dwon * ny + won * dny[j]);
        twiz[j] = tdz[j] - 2.f * (dwon * nz + won * dnz[j]);
      }
      wix = wsx;
      wiy = wsy;
      wiz = wsz;
      if (is_s) {
        fr = coef * ar;
        fg = coef * ag;
        fb = coef * ab;
      } else {
        const bool entering = won < 0.f;
        const float ior_v = fmaxf(coef, 1.f);
        const float n1 = entering ? 1.f : ior_v, n2 = entering ? ior_v : 1.f;
        const float sgn = entering ? 1.f : -1.f;
        const float nnx = nx * sgn, nny = ny * sgn, nnz = nz * sgn;
        const float cos_i = -(wox * nnx + woy * nny + woz * nnz);
        const float eta = n1 / n2;
        const float sin2t = eta * eta * (1.f - cos_i * cos_i);
        const float cos_t = sqrtf(fmaxf(1.f - sin2t, 1e-12f));
        const float r_orth =
            (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t);
        const float r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t);
        const float refl =
            sin2t > 1.f ? 1.f : 0.5f * (r_orth * r_orth + r_par * r_par);
        const bool do_reflect = u1 < refl;  // detached coin
        if (!do_reflect) {
          const float fac_t = eta * (-cos_i) + cos_t;
          wix = wox * eta - fac_t * nnx;
          wiy = woy * eta - fac_t * nny;
          wiz = woz * eta - fac_t * nnz;
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const float dnnx = dnx[j] * sgn, dnny = dny[j] * sgn,
                        dnnz = dnz[j] * sgn;
            const float dcos_i =
                -(tdx[j] * nnx + wox * dnnx + tdy[j] * nny + woy * dnny +
                  tdz[j] * nnz + woz * dnnz);
            float dsin2t = eta * eta * (-2.f * cos_i * dcos_i);
            float deta = 0.f;
            if (tmask[j]) {
              // the IOR source: d(ior) = 1 moves eta = n1/n2 (Snell)
              const float dn1 = entering ? 0.f : 1.f;
              const float dn2 = entering ? 1.f : 0.f;
              deta = (dn1 * n2 - n1 * dn2) / (n2 * n2);
              dsin2t = dsin2t + 2.f * eta * deta * (1.f - cos_i * cos_i);
            }
            const float dcos_t = -0.5f * dsin2t / cos_t;
            const float dfac = eta * (-dcos_i) + dcos_t;
            float dtx = tdx[j] * eta - dfac * nnx - fac_t * dnnx;
            float dty = tdy[j] * eta - dfac * nny - fac_t * dnny;
            float dtz = tdz[j] * eta - dfac * nnz - fac_t * dnnz;
            if (tmask[j]) {
              const float dfac_e = deta * (-cos_i);
              dtx = dtx + wox * deta - dfac_e * nnx;
              dty = dty + woy * deta - dfac_e * nny;
              dtz = dtz + woz * deta - dfac_e * nnz;
            }
            twix[j] = dtx;
            twiy[j] = dty;
            twiz[j] = dtz;
          }
        }
        if (any_tm) {
          // streaming score of the detached Fresnel coin: dR/d(ior) with the
          // geometry fixed; TIR lanes sit on R == 1 (dR = 0). C holds this
          // vertex's emission and NEE, which do not depend on the coin.
          const float dn1s = entering ? 0.f : 1.f, dn2s = entering ? 1.f : 0.f;
          const float detas = (dn1s * n2 - n1 * dn2s) / (n2 * n2);
          const float dsin2ts = 2.f * eta * detas * (1.f - cos_i * cos_i);
          const float dcos_ts = -0.5f * dsin2ts / cos_t;
          const float ao = n1 * cos_i - n2 * cos_t;
          const float bo = n1 * cos_i + n2 * cos_t;
          const float dao = dn1s * cos_i - dn2s * cos_t - n2 * dcos_ts;
          const float dbo = dn1s * cos_i + dn2s * cos_t + n2 * dcos_ts;
          const float bsafe = fmaxf(bo, 1e-9f);
          const float dro = (dao * bo - ao * dbo) / (bsafe * bsafe);
          const float cp_ = n2 * cos_i - n1 * cos_t;
          const float dp_ = n2 * cos_i + n1 * cos_t;
          const float dcp = dn2s * cos_i - dn1s * cos_t - n1 * dcos_ts;
          const float ddp = dn2s * cos_i + dn1s * cos_t + n1 * dcos_ts;
          const float dsafe = fmaxf(dp_, 1e-9f);
          const float drp = (dcp * dp_ - cp_ * ddp) / (dsafe * dsafe);
          const float dRv = sin2t > 1.f ? 0.f : r_orth * dro + r_par * drp;
          const float scf = do_reflect ? dRv / fmaxf(refl, 1e-6f)
                                       : -dRv / fmaxf(1.f - refl, 1e-6f);
#pragma unroll
          for (int j = 0; j < T; ++j) {
            if (!tmask[j]) continue;
            float* const sc = acc + (3 + 3 * T + 4 * j) * LANES;
            sc[0] += scf;
            sc[LANES] += scf * Cr;
            sc[2 * LANES] += scf * Cg;
            sc[3 * LANES] += scf * Cb;
          }
        }
        fr = ar;
        fg = ag;
        fb = ab;
      }
      pdf = 1.f;
      const float cos_dot = dot3(wix, wiy, wiz, nx, ny, nz);
      wgt = fabsf(cos_dot);
      const float sign_c = (float)((cos_dot > 0.f) - (cos_dot < 0.f));
#pragma unroll
      for (int j = 0; j < T; ++j)
        dwgt[j] = sign_c * (dot3(twix[j], twiy[j], twiz[j], nx, ny, nz) +
                            dot3(wix, wiy, wiz, dnx[j], dny[j], dnz[j]));
    }
    const bool f_black = fr <= 0.f && fg <= 0.f && fb <= 0.f;
    const bool step_ok = !f_black && pdf > 0.f;
    if (step_ok) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        tTr[j] = tTr[j] * fr * wgt + Tr * fr * dwgt[j];
        tTg[j] = tTg[j] * fg * wgt + Tg * fg * dwgt[j];
        tTb[j] = tTb[j] * fb * wgt + Tb * fb * dwgt[j];
      }
      Tr = Tr * fr * wgt;
      Tg = Tg * fg * wgt;
      Tb = Tb * fb * wgt;
    }

    // ---- Russian roulette once bounce > rr_start, p = min(0.5, max T); the
    // boost scales the tangents too (a detached factor)
    const bool do_rr = bounce > p.rr_start;
    const float p_cont = fminf(0.5f, fmaxf(Tr, fmaxf(Tg, Tb)));
    const bool survive = u3 <= p_cont;
    if (step_ok && do_rr && survive && p_cont > 0.f) {
      const float inv_p = 1.f / fmaxf(p_cont, 1e-20f);
      Tr *= inv_p;
      Tg *= inv_p;
      Tb *= inv_p;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        tTr[j] *= inv_p;
        tTg[j] *= inv_p;
        tTb[j] *= inv_p;
      }
    }
    const bool alive_next =
        step_ok && (survive || !do_rr) && bounce < p.max_bounces;
    if (!alive_next) {
      flush_path<T>(acc, ior, Cr, Cg, Cb, tCr, tCg, tCb);
      ++n_samp;
    }
    // ---- pending ray and its tangents for the next iteration
    ox = hx;
    oy = hy;
    oz = hz;
    dx = wix;
    dy = wiy;
    dz = wiz;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      tox[j] = dpx[j];
      toy[j] = dpy[j];
      toz[j] = dpz[j];
      tdx[j] = twix[j];
      tdy[j] = twiy[j];
      tdz[j] = twiz[j];
    }
    prev_pdf = pdf;
    prev_delta = !is_d;
    ++bounce;
    alive = alive_next;
  }

  const float dom = in_domain ? 1.f : 0.f;
  const size_t plane = (size_t)gridDim.x * LANES;
#pragma unroll
  for (int w = 0; w < 3 + 3 * T; ++w)
    p.out[w * plane + idx] = acc[w * LANES] * dom;
  p.n_samp[idx] = n_samp;
  const int rays = block_sum_int(n_live, iscratch);
  if (col == 0) p.nrays[row] = rays;
}

// The (MESH, T) build of the kernel.
const void* kernel_of(bool mesh, int n_tan) {
  switch (n_tan) {
    case 1: return mesh ? (const void*)camera_jvp_kernel<true, 1>
                        : (const void*)camera_jvp_kernel<false, 1>;
    case 2: return mesh ? (const void*)camera_jvp_kernel<true, 2>
                        : (const void*)camera_jvp_kernel<false, 2>;
    case 3: return mesh ? (const void*)camera_jvp_kernel<true, 3>
                        : (const void*)camera_jvp_kernel<false, 3>;
    default: return mesh ? (const void*)camera_jvp_kernel<true, 4>
                         : (const void*)camera_jvp_kernel<false, 4>;
  }
}

}  // namespace

extern "C" {

// Launch one tangent walk of n_tan (1..4) tangents on `stream`. prims,
// lights, cam, dcam (n_tan x 24), uniforms, the mesh tables and every output
// are device pointers; pinfo (per prim: bit 0 emissive, bits 1-2 type, bits
// 3+ material), lstruct (LS ints per light) and tan_mats (per tangent: the
// material of an IOR tangent, -1 for a camera tangent) are host arrays that
// travel in the kernel's parameters. The float tables are copied into
// __constant__ memory on the same stream, so launches must stay on one
// stream. `out` holds 3 + 3 n_tan planes of rows_total x 128 floats: L rgb,
// then dL rgb per tangent. n_nodes == 0 means no mesh. smem is the block's
// dynamic shared memory, tangent_smem_bytes(n_tan), refused unless it is
// the kernel's smem_bytes(n_tan). Returns the first CUDA error (0 on
// success).
int tpt_camera_jvp(const float* prims, const int* pinfo, int n_prims,
                   const float* lights, const int* lstruct, int n_lights,
                   const float* cam, const float* dcam, const int* tan_mats,
                   int n_tan, const float* uniforms, float* out, int* n_samp,
                   int* nrays, const float* mesh_nodes,
                   const float* mesh_tris, const float* mesh_mats,
                   const float* tri_lights, int n_nodes, int rows_total,
                   int tile_rows, int budget, int spp, int width, int n_lanes,
                   int max_bounces, int rr_start, int use_nee, int strat_k,
                   int tile_offset, uint32_t seed, uint32_t salt,
                   uint32_t iteration, int smem, void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_lights < 0 ||
      n_lights > MAX_LIGHTS || n_tan < 1 || n_tan > MAX_TAN ||
      rows_total <= 0 || tile_rows <= 0 || rows_total % tile_rows != 0 ||
      width <= 0 || strat_k < 1 || n_nodes < 0 ||
      smem != smem_bytes(n_tan) ||
      (n_nodes > 0 && !(mesh_nodes && mesh_tris && mesh_mats &&
                        tri_lights)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  if (n_prims > 0)
    err = cudaMemcpyToSymbolAsync(c_prims, prims, sizeof(float) * 12 * n_prims,
                                  0, cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess && n_lights > 0)
    err = cudaMemcpyToSymbolAsync(c_lights, lights,
                                  sizeof(float) * 8 * n_lights, 0,
                                  cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_cam, cam, sizeof(float) * 24, 0,
                                  cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(c_dcam, dcam, sizeof(float) * 24 * n_tan, 0,
                                  cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.n_prims = n_prims;
  p.n_lights = n_lights;
  p.tile_rows = tile_rows;
  p.budget = budget;
  p.spp = spp;
  p.width = width;
  p.n_lanes = n_lanes;
  p.max_bounces = max_bounces;
  p.rr_start = rr_start;
  p.use_nee = use_nee;
  p.strat_k = strat_k;
  p.tile_offset = tile_offset;
  p.seed = seed;
  p.salt = salt;
  p.iteration = iteration;
  p.uniforms = uniforms;
  p.out = out;
  p.n_samp = n_samp;
  p.nrays = nrays;
  p.mesh.nodes = reinterpret_cast<const float4*>(mesh_nodes);
  p.mesh.tris = mesh_tris;
  p.mesh.mats = mesh_mats;
  p.mesh.tl = tri_lights;
  p.mesh.n_nodes = n_nodes;
  for (int j = 0; j < MAX_TAN; ++j) p.tan_mat[j] = j < n_tan ? tan_mats[j] : -1;
  for (int q = 0; q < MAX_PRIMS; ++q) p.pinfo[q] = q < n_prims ? pinfo[q] : 0;
  for (int k = 0; k < MAX_LIGHTS * LS; ++k)
    p.lstruct[k] = k < n_lights * LS ? lstruct[k] : 0;

  void* args[] = {&p};
  err = cudaLaunchKernel(kernel_of(n_nodes > 0, n_tan), dim3(rows_total),
                         dim3(LANES), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks per SM of the (mesh, n_tan) build with smem bytes of shared memory
// per block, as the card's occupancy calculator gives them (-1 on an error).
int tpt_camera_jvp_occupancy(int mesh, int n_tan, int smem) {
  if (n_tan < 1 || n_tan > MAX_TAN || smem != smem_bytes(n_tan)) return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel_of(mesh != 0, n_tan), LANES, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
