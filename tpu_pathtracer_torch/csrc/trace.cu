// Per-sample path-trace kernel for Hopper (sm_90a).
//
// Replaces: tpu_pathtracer/ops/pallas/trace_kernel.py::_trace_kernel
// (launched by pallas_render), whole: sphere scenes, brute force and
// NEE+MIS with point and sphere-area lights, a pinhole camera. The TPU
// kernel reads only the pinhole slots of the packed camera and the sphere
// table; the wrapper (ops/kernels/trace_kernel.py) refuses a lens camera or
// a scene with a mesh rather than render them as something else.
//
// What it computes: one path per lane, lane = pixel * spp + s, each walked
// from its primary hit through up to max_bounces + 1 vertices: the emitter
// hit with its MIS weight against light sampling, NEE with a full quadratic
// shadow sweep over every sphere, one BSDF lobe (the diffuse one through
// the concentric disk map, re-normalized, weighted by cos / pdf), Russian
// roulette once bounce > rr_start. It writes each lane's radiance; the
// wrapper averages a pixel's spp lanes. The ray count is the TPU kernel's:
// every primary lane, then every lane alive after each bounce.
//
// What bounds it on this card: a divergent ALU walk, as the persistent
// forward kernel: per-prim quadratics, transcendentals and the lobes per
// vertex, the shadow sweep per NEE sample. Device memory is touched only to
// write three radiance planes (12 B per lane) and, in test mode, to read the
// uniform block.
//
// What the design does about it:
//  * one thread per lane, one 128-thread block per 128-lane row, so every
//    block sits inside one TPU tile; the walk runs in registers and a lane
//    that dies leaves the loop (the TPU kernel computes every bounce of
//    every lane under masks);
//  * the scene tables live in __constant__ memory, read at the same address
//    by every thread of a warp; the per-prim loops run over the table at
//    runtime (the TPU kernel unrolled them over static tuples);
//  * the uniforms come one Philox group of four at a time, in draw order
//    (pt_common.cuh::SampleDraws), so no draw is kept beyond its use;
//  * the per-row ray count is reduced in the block without atomics, and
//    the wrapper sums the rows.
//
// Rounding: the sphere quadratics and hit points use explicit FMAs in XLA's
// pattern, as persistent.cu does, and the build keeps nvcc's FMA
// contraction elsewhere (no -fmad=false in _build.py). The kernel is held to
// >= 98% of lanes against its plain version, as the persistent kernels are;
// the 1e5-radius walls make some lanes' closest hit f32-chaotic either way,
// and contraction is what the other walk kernels ship with. What is this
// kernel's own, and kept so: normals divide by the radius (:200-202), the
// sphere-light cone sample and the point light take sqrt and divide
// (:300-301, :340-345), the shadow sweep does not skip the sampled light,
// and the closest hit keeps the FIRST prim on an exact tie.
//
// Randomness: test mode reads the external block (n_tiles, n_draw,
// tile_rows, 128), n_draw = 2 + (max_bounces + 1) * (3 | 6); production mode
// draws Philox4x32-10 under stream tag 0x40000 (STREAM_TRACE).
//
// C interface (loaded with ctypes): tpt_trace.

#include "pt_common.cuh"

namespace {

__constant__ float c_prims[MAX_PRIMS * 12];  // pack_prims layout
__constant__ int c_pflags[MAX_PRIMS];        // bit 0 emissive, bits 1-2 type
__constant__ float c_lights[MAX_LIGHTS * 8];  // pack_lights layout
__constant__ int c_lstruct[MAX_LIGHTS * LS];  // light structure (pt_common)
__constant__ float c_cam[24];                // pack_camera layout

struct Params {
  int n_prims, n_lights, tile_rows, spp, strat_k, width, n_lanes;
  int max_bounces, rr_start, use_nee;
  uint32_t seed, salt, iteration;
  const float* uniforms;  // NULL: production Philox
  float *lr, *lg, *lb;    // (rows_total, 128) per-lane radiance
  int* nrays;             // (rows_total,) rays per row
};

// NEE sample of light LT from the hit point, kernel 8's arithmetic
// (trace_kernel.py:294-348): a sphere light (LP its pack_prims row) is
// cone-sampled around the direction to its centre, found by sqrt and
// divide, and lights only its outer face; any other light is a point light
// at LT's position with 1/d^2 falloff, also by sqrt and divide.
__device__ __forceinline__ LightSample sample_light_div(
    const float* LT, const float* LP, float hx, float hy, float hz, float ul1,
    float ul2) {
  LightSample s;
  if (LP) {
    const float wrx = LP[0] - hx, wry = LP[1] - hy, wrz = LP[2] - hz;
    const float rl = LP[3];
    const float d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz);
    const float distc = sqrtf(fmaxf(d2l, 1e-20f));
    const float wcx = wrx / distc, wcy = wry / distc, wcz = wrz / distc;
    const float sin2 = fminf(rl * rl / fmaxf(d2l, 1e-12f), 1.f);
    const float ctm = sqrtf(fmaxf(1.f - sin2, 0.f));
    const float cth = 1.f - ul1 * (1.f - ctm);
    const float sth = sqrtf(fmaxf(1.f - cth * cth, 0.f));
    const float phi = TWO_PI * ul2;
    const bool usex = fabsf(wcx) > fabsf(wcz);
    float ax = usex ? -wcy : 0.f, ay = usex ? wcx : -wcz,
          az = usex ? 0.f : wcy;
    normalize3(ax, ay, az);
    const float bx = wcy * az - wcz * ay;
    const float by = wcz * ax - wcx * az;
    const float bz = wcx * ay - wcy * ax;
    const float cp = cosf(phi) * sth, sp = sinf(phi) * sth;
    s.wlx = ax * cp + bx * sp + wcx * cth;
    s.wly = ay * cp + by * sp + wcy * cth;
    s.wlz = az * cp + bz * sp + wcz * cth;
    const float bq = dot3_fma(wrx, wry, wrz, s.wlx, s.wly, s.wlz);
    const float detq = fmaf(rl, rl, fmaf(bq, bq, -d2l));
    const float thit = bq - sqrtf(fmaxf(detq, 0.f));
    s.valid = detq >= 0.f && thit > TMIN && d2l > rl * rl;
    const float nsx = (hx + s.wlx * thit - LP[0]) / rl;
    const float nsy = (hy + s.wly * thit - LP[1]) / rl;
    const float nsz = (hz + s.wlz * thit - LP[2]) / rl;
    s.valid = s.valid && dot3(nsx, nsy, nsz, -s.wlx, -s.wly, -s.wlz) > 0.f;
    s.pdf = LT[7] / (TWO_PI * fmaxf(1.f - ctm, 1e-12f));
    s.dist = thit;
    s.rad_r = LT[3];
    s.rad_g = LT[4];
    s.rad_b = LT[5];
  } else {
    const float wrx = LT[0] - hx, wry = LT[1] - hy, wrz = LT[2] - hz;
    const float d2l = dot3(wrx, wry, wrz, wrx, wry, wrz);
    s.dist = sqrtf(fmaxf(d2l, 1e-20f));
    s.wlx = wrx / s.dist;
    s.wly = wry / s.dist;
    s.wlz = wrz / s.dist;
    const float inv_d2 = 1.f / fmaxf(d2l, 1e-12f);
    s.rad_r = LT[3] * inv_d2;
    s.rad_g = LT[4] * inv_d2;
    s.rad_b = LT[5] * inv_d2;
    s.pdf = LT[7];
    s.valid = s.dist > TMIN;
  }
  return s;
}

__global__ void __launch_bounds__(LANES)
    trace_kernel(const __grid_constant__ Params p) {
  __shared__ int iscratch[4];
  const int row = blockIdx.x;  // one block per 128-lane row
  const int col = threadIdx.x;
  const int lane = row * LANES + col;
  const int tile = row / p.tile_rows;
  const int trow = row - tile * p.tile_rows;
  const int tile_lanes = p.tile_rows * LANES;
  const bool in_domain = lane < p.n_lanes;
  const int nb = p.use_nee ? 6 : 3;  // draws per bounce
  const int n_draw = 2 + (p.max_bounces + 1) * nb;
  SampleDraws draw{
      p.uniforms ? p.uniforms + (size_t)tile * n_draw * tile_lanes +
                       trow * LANES + col
                 : nullptr,
      tile_lanes, (uint32_t)lane, p.iteration, p.seed, p.salt, STREAM_TRACE,
      -1, make_uint4(0u, 0u, 0u, 0u)};

  float Lr = 0.f, Lg = 0.f, Lb = 0.f;
  int n_live = 0;
  if (in_domain) {
    n_live = 1;  // the primary ray
    // ---- camera ray: stratified over strat_k^2 cells when spp is a
    // perfect square > 1 (the wrapper passes strat_k 1 otherwise)
    const int s = lane % p.spp, pix = lane / p.spp;
    float jx, jy, dx, dy, dz;
    jitter_div(s % (p.strat_k * p.strat_k), p.strat_k, draw(0), draw(1), jx,
               jy);
    pinhole_dir(c_cam, (float)(pix % p.width) + jx,
                (float)(pix / p.width) + jy, dx, dy, dz);
    float pox = c_cam[9], poy = c_cam[10], poz = c_cam[11];
    SphereHit h = closest_sphere<false>(c_prims, c_pflags, p.n_prims, pox,
                                        poy, poz, dx, dy, dz);
    bool alive = h.hit;
    float Tr = 1.f, Tg = 1.f, Tb = 1.f;
    float wox = dx, woy = dy, woz = dz;
    float prev_pdf = 0.f;
    bool prev_delta = true;  // primaries take full emitter credit

    for (int bounce = 0; bounce <= p.max_bounces && alive; ++bounce) {
      const int base = 2 + bounce * nb;
      const float u1 = draw(base), u2 = draw(base + 1), u3 = draw(base + 2);
      const bool is_s = h.mtype == SPECULAR, is_t = h.mtype == TRANSMISSIVE;
      const bool is_d = !(is_s || is_t);

      // ---- emitter hit (pathtracer.cu:134-137), MIS-weighted under NEE
      // against the light's cone pdf from the previous vertex
      if (h.emissive) {
        float take =
            dot3(h.nx, h.ny, h.nz, -wox, -woy, -woz) > 0.f ? 1.f : 0.f;
        if (p.use_nee) {
          float ldp = 0.f;  // the last matching light wins
          for (int li = 0; li < p.n_lights; ++li) {
            const int* S = c_lstruct + li * LS;
            if (S[0] == AREA_LIGHT && S[1] == h.prim)
              ldp = cone_pdf(c_prims + h.prim * 12, pox, poy, poz) *
                    c_lights[li * 8 + 7];
          }
          const float pp2 = prev_pdf * prev_pdf;
          take *= prev_delta ? 1.f : pp2 / fmaxf(pp2 + ldp * ldp, 1e-20f);
        }
        Lr += Tr * h.er * take;
        Lg += Tg * h.eg * take;
        Lb += Tb * h.eb * take;
      }

      // ---- next-event estimation on diffuse lanes: one light chosen by
      // usel against cdf_lo, the last light taking the remainder
      if (p.use_nee) {
        const float ul1 = draw(base + 3), ul2 = draw(base + 4),
                    usel = draw(base + 5);
        for (int li = 0; li < p.n_lights && is_d; ++li) {
          const float* LT = c_lights + li * 8;
          const float lo = LT[6], sel = LT[7];
          const bool m_l = li == p.n_lights - 1
                               ? usel >= lo
                               : (usel >= lo && usel < lo + sel);
          if (!m_l) continue;
          const int* S = c_lstruct + li * LS;
          const bool area = S[0] == AREA_LIGHT && S[1] >= 0;
          const LightSample ls =
              sample_light_div(LT, area ? c_prims + S[1] * 12 : nullptr, h.hx,
                               h.hy, h.hz, ul1, ul2);
          const float cos_l = dot3(ls.wlx, ls.wly, ls.wlz, h.nx, h.ny, h.nz);
          const bool support =
              cos_l > 0.f && dot3(wox, woy, woz, ls.wlx, ls.wly, ls.wlz) < 0.f;
          if (!(ls.valid && support)) continue;
          // shadow any-hit over every sphere, the sampled light included
          if (sphere_occluded(c_prims, p.n_prims, -1, h.hx, h.hy, h.hz,
                              ls.wlx, ls.wly, ls.wlz,
                              fmaf(ls.dist, 0.999f, -TMIN)))
            continue;
          // squared power heuristic against BSDF sampling; a point light
          // is a delta light with weight 1
          const float pdf_b = cos_l * INV_PI;
          const float w_mis =
              area ? (ls.pdf * ls.pdf) /
                         fmaxf(ls.pdf * ls.pdf + pdf_b * pdf_b, 1e-20f)
                   : 1.f;
          const float scale = cos_l * w_mis / fmaxf(ls.pdf, 1e-20f);
          Lr += Tr * (h.ar * INV_PI) * ls.rad_r * scale;
          Lg += Tg * (h.ag * INV_PI) * ls.rad_g * scale;
          Lb += Tb * (h.ab * INV_PI) * ls.rad_b * scale;
        }
      }

      // ---- BSDF sampling: one lobe per lane; the diffuse lobe through the
      // concentric map, the mirror and the dielectric as in pt_common
      const Lobe lb =
          is_d ? sample_diffuse_concentric(h.nx, h.ny, h.nz, wox, woy, woz,
                                           h.ar, h.ag, h.ab, u1, u2)
               : sample_lobe(is_s, is_t, h.nx, h.ny, h.nz, wox, woy, woz,
                             h.ar, h.ag, h.ab, h.coef, u1, u2);
      const bool f_black = lb.fr <= 0.f && lb.fg <= 0.f && lb.fb <= 0.f;
      const bool step_ok = !f_black && lb.pdf > 0.f;
      if (step_ok) {
        Tr = Tr * lb.fr * lb.wgt;
        Tg = Tg * lb.fg * lb.wgt;
        Tb = Tb * lb.fb * lb.wgt;
      }

      // ---- Russian roulette once bounce > rr_start, p = min(0.5, max T)
      alive = step_ok;
      if (bounce > p.rr_start) {
        const float p_cont = fminf(0.5f, fmaxf(Tr, fmaxf(Tg, Tb)));
        const bool survive = u3 <= p_cont;
        if (step_ok && survive && p_cont > 0.f) {
          const float inv_p = 1.f / fmaxf(p_cont, 1e-20f);
          Tr *= inv_p;
          Tg *= inv_p;
          Tb *= inv_p;
        }
        alive = step_ok && survive;
      }
      if (bounce == p.max_bounces) alive = false;
      if (!alive) break;
      ++n_live;  // the next segment is a traced ray

      // ---- next segment (MIS previous vertex = this hit)
      pox = h.hx;
      poy = h.hy;
      poz = h.hz;
      prev_pdf = lb.pdf;
      prev_delta = !is_d;
      wox = lb.wix;
      woy = lb.wiy;
      woz = lb.wiz;
      h = closest_sphere<false>(c_prims, c_pflags, p.n_prims, pox, poy, poz,
                                wox, woy, woz);
      alive = h.hit;
    }
  }
  p.lr[lane] = Lr;
  p.lg[lane] = Lg;
  p.lb[lane] = Lb;
  const int rays = block_sum_int(n_live, iscratch);
  if (col == 0) p.nrays[row] = rays;
}

}  // namespace

extern "C" {

// Launch one per-sample render on `stream`. prims/lights/cam/uniforms and
// the outputs are device pointers; pflags/lstruct (LS ints per light) are
// host arrays, copied with the tables into __constant__ memory on the same
// stream, so launches must stay on one stream. lr/lg/lb are rows_total x 128
// planes, nrays rows_total ints. Returns the first CUDA error (0 on
// success).
int tpt_trace(const float* prims, const int* pflags, int n_prims,
              const float* lights, const int* lstruct, int n_lights,
              const float* cam, const float* uniforms, float* lr, float* lg,
              float* lb, int* nrays, int rows_total, int tile_rows, int spp,
              int strat_k, int width, int n_lanes, int max_bounces,
              int rr_start, int use_nee, uint32_t seed, uint32_t salt,
              uint32_t iteration, void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_lights < 0 ||
      n_lights > MAX_LIGHTS || rows_total <= 0 || tile_rows <= 0 ||
      rows_total % tile_rows != 0 || width <= 0 || spp <= 0 || strat_k < 1 ||
      max_bounces < 0 || n_lanes > rows_total * LANES)
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

  Params p;
  p.n_prims = n_prims;
  p.n_lights = n_lights;
  p.tile_rows = tile_rows;
  p.spp = spp;
  p.strat_k = strat_k;
  p.width = width;
  p.n_lanes = n_lanes;
  p.max_bounces = max_bounces;
  p.rr_start = rr_start;
  p.use_nee = use_nee;
  p.seed = seed;
  p.salt = salt;
  p.iteration = iteration;
  p.uniforms = uniforms;
  p.lr = lr;
  p.lg = lg;
  p.lb = lb;
  p.nrays = nrays;
  trace_kernel<<<rows_total, LANES, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
