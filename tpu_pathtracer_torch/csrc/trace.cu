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
//  * a grid of resident blocks (the SMs times the blocks per SM, asked once
//    per card by the wrapper), each thread walking one path vertex per loop
//    iteration, the path in registers; when a thread's path ends it writes
//    that item's radiance and takes the next unstarted (pixel, sample)
//    item, whose camera ray goes through the same closest-hit call as a
//    bounce. So a warp no longer idles all its lanes but one until its
//    longest path ends (RR after bounce 3, up to 11 vertices against ~3.8
//    on average; one item per lane kept 0.53 of a warp's lane-iterations
//    live on Cornell): its lanes stay busy until the items run out. Items
//    come by a warp-aggregated fetch: a ballot of the lanes that need one,
//    one atomicAdd per warp on a counter, ranks by popc (a static stride
//    over the grid was built and measured 20-41% slower, PERF.md). The
//    TPU kernel computes every bounce of every lane under masks;
//  * __launch_bounds__(128, 7): 72 registers and 7 blocks per SM (at 80
//    registers and 6 it ran up to 5% slower);
//  * each item's draws stay keyed on the item (its lane id for Philox, its
//    tile, row and column of the block in test mode) and its arithmetic is
//    the per-lane kernel's, so the radiance does not depend on which thread
//    walks it;
//  * the scene tables live in __constant__ memory, read at the same address
//    by every thread of a warp; the per-prim loops run over the table at
//    runtime (the TPU kernel unrolled them over static tuples);
//  * the uniforms come one Philox group of four at a time, in draw order
//    (pt_common.cuh::SampleDraws), so no draw is kept beyond its use;
//  * the fetch counter and the ray count are 64-bit integers: the count is
//    summed per warp and added by one atomicAdd per warp, exact in any
//    order, and neither wraps however many lanes a launch holds (each
//    thread's last fetch overshoots the items); the padding lanes past the
//    image get zero radiance in the same launch.
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
// C interface (loaded with ctypes): tpt_trace, tpt_trace_occupancy.

#include "pt_common.cuh"

namespace {

__constant__ float c_prims[MAX_PRIMS * 12];  // pack_prims layout
__constant__ int c_pflags[MAX_PRIMS];        // bit 0 emissive, bits 1-2 type
__constant__ float c_lights[MAX_LIGHTS * 8];  // pack_lights layout
__constant__ int c_lstruct[MAX_LIGHTS * LS];  // light structure (pt_common)
__constant__ float c_cam[24];                // pack_camera layout

struct Params {
  int n_prims, n_lights, tile_rows, spp, strat_k, width, n_lanes, n_total;
  int max_bounces, rr_start, use_nee;
  uint32_t seed, salt, iteration;
  const float* uniforms;  // NULL: production Philox
  float *lr, *lg, *lb;    // (rows_total, 128) per-lane radiance
  unsigned long long* counters;  // [0] next unstarted item, [1] rays;
                                 // zeroed by the caller
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

// Starts the walk of item `item` (a (pixel, sample) lane): points the
// draws at its uniforms (test mode: the item's tile, row and column of the
// block; production: Philox countered on the item) and returns its primary
// ray, stratified over strat_k^2 cells when spp is a perfect square > 1
// (the wrapper passes strat_k 1 otherwise).
__device__ __forceinline__ void start_item(const Params& p, int item,
                                           int n_draw, SampleDraws& draw,
                                           float& dx, float& dy, float& dz) {
  const int tile_lanes = p.tile_rows * LANES;
  const int row = item / LANES, col = item - row * LANES;
  const int tile = row / p.tile_rows, trow = row - tile * p.tile_rows;
  draw.ub = p.uniforms ? p.uniforms + (size_t)tile * n_draw * tile_lanes +
                             trow * LANES + col
                       : nullptr;
  draw.lane = (uint32_t)item;
  draw.group = -1;
  const int s = item % p.spp, pix = item / p.spp;
  float jx, jy;
  jitter_div(s % (p.strat_k * p.strat_k), p.strat_k, draw(0), draw(1), jx,
             jy);
  pinhole_dir(c_cam, (float)(pix % p.width) + jx, (float)(pix / p.width) + jy,
              dx, dy, dz);
}

// Items come by a warp-aggregated fetch from p.counters[0]: one atomicAdd
// per warp for its lanes that need an item.
__global__ void __launch_bounds__(LANES, 7)
    trace_kernel(const __grid_constant__ Params p) {
  const int col = threadIdx.x;
  const int wl = col & 31;  // lane in the warp
  const int stride = (int)gridDim.x * LANES;
  const int nb = p.use_nee ? 6 : 3;  // draws per bounce
  const int n_draw = 2 + (p.max_bounces + 1) * nb;
  // the padding lanes past the image's items hold zero radiance
  for (int i = p.n_lanes + (int)blockIdx.x * LANES + col; i < p.n_total;
       i += stride)
    p.lr[i] = p.lg[i] = p.lb[i] = 0.f;

  SampleDraws draw{nullptr, p.tile_rows * LANES, 0u, p.iteration, p.seed,
                   p.salt, STREAM_TRACE, -1, make_uint4(0u, 0u, 0u, 0u)};
  int item = -1;
  bool busy = false;  // the thread walks an item's path
  bool done = false;  // the items ran out for this thread
  int n_live = 0;
  float Lr = 0.f, Lg = 0.f, Lb = 0.f, Tr = 1.f, Tg = 1.f, Tb = 1.f;
  float pox = 0.f, poy = 0.f, poz = 0.f, wox = 0.f, woy = 0.f, woz = 1.f;
  float prev_pdf = 0.f;
  bool prev_delta = true;
  int bounce = 0;

  // one vertex per iteration: the pending segment's closest hit and its
  // shading; a thread whose path ends takes the next unstarted item, whose
  // camera ray goes through the same closest-hit call
  while (true) {
    const bool need = !busy && !done;
    const unsigned want = __ballot_sync(0xffffffffu, need);
    if (want) {
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (wl == leader)
        base = atomicAdd(p.counters, (unsigned long long)__popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need) {
        const unsigned long long next =
            base + __popc(want & ((1u << wl) - 1u));
        done = next >= (unsigned long long)p.n_lanes;
        item = (int)next;  // read only while not done
      }
    }
    // a warp whose threads have all run out of items stops
    if (!__any_sync(0xffffffffu, !done)) break;
    if (done) continue;
    if (!busy) {
      start_item(p, item, n_draw, draw, wox, woy, woz);
      pox = c_cam[9];
      poy = c_cam[10];
      poz = c_cam[11];
      Lr = Lg = Lb = 0.f;
      Tr = Tg = Tb = 1.f;
      prev_pdf = 0.f;
      prev_delta = true;  // primaries take full emitter credit
      bounce = 0;
      busy = true;
      ++n_live;  // the primary ray
    }
    const SphereHit h = closest_sphere<false>(c_prims, c_pflags, p.n_prims,
                                              pox, poy, poz, wox, woy, woz);
    bool alive = h.hit;
    if (alive) {
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
      if (alive) {
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
        ++bounce;
      }
    }
    if (!alive) {  // the path ends: its radiance, then the next item
      p.lr[item] = Lr;
      p.lg[item] = Lg;
      p.lb[item] = Lb;
      busy = false;
    }
  }
  // the ray count, exact in any order: the warp's sum in 64 bits, one
  // atomicAdd per warp (the whole warp left the loop together)
  unsigned long long rays = (unsigned long long)n_live;
  for (int off = 16; off > 0; off >>= 1)
    rays += __shfl_down_sync(0xffffffffu, rays, off);
  if (wl == 0) atomicAdd(p.counters + 1, rays);
}

}  // namespace

extern "C" {

// Launch one per-sample render on `stream`, over `blocks` blocks of 128
// threads (the wrapper passes those resident at once: the SMs times
// tpt_trace_occupancy). prims/lights/cam/uniforms and the outputs are
// device pointers;
// pflags/lstruct (LS ints per light) are host arrays, copied with the
// tables into __constant__ memory on the same stream, so launches must stay
// on one stream. lr/lg/lb are rows_total x 128 planes; counters holds two
// 64-bit integers that the caller has zeroed: the fetch's next item, and
// the rays traced, which the launch adds there. Returns the first CUDA error (0 on
// success).
int tpt_trace(const float* prims, const int* pflags, int n_prims,
              const float* lights, const int* lstruct, int n_lights,
              const float* cam, const float* uniforms, float* lr, float* lg,
              float* lb, unsigned long long* counters, int rows_total, int tile_rows,
              int spp, int strat_k, int width, int n_lanes, int max_bounces,
              int rr_start, int use_nee, uint32_t seed, uint32_t salt,
              uint32_t iteration, int blocks, void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_lights < 0 ||
      n_lights > MAX_LIGHTS || rows_total <= 0 || tile_rows <= 0 ||
      rows_total % tile_rows != 0 || width <= 0 || spp <= 0 || strat_k < 1 ||
      max_bounces < 0 || n_lanes < 0 || n_lanes > rows_total * LANES ||
      blocks <= 0 || !counters)
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
  p.n_total = rows_total * LANES;
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
  p.counters = counters;
  trace_kernel<<<blocks, LANES, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Blocks per SM of the kernel, as the card's occupancy calculator gives
// them (-1 on an error).
int tpt_trace_occupancy() {
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, trace_kernel, LANES,
                                                    0) != cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
