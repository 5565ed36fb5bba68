// Device math shared by the persistent forward kernel (persistent.cu) and the
// persistent fused value-and-grad kernel (replay_persistent.cu).
//
// Only code that is the same math in both TPU kernels lives here: the
// uniforms of one wavefront iteration, the camera ray of a regenerated path,
// the three BSDF lobes, the NEE light sample (point light, or cone sampling
// of a sphere light) and the cone pdf of a sphere emitter for MIS. The
// closest-hit loops and the shadow tests differ between the two TPU kernels
// (tie rule, segment-ball vs quadratic occlusion) and stay in each kernel.
//
// Everything is in an anonymous namespace: each translation unit gets its
// own copy and no symbol of this header reaches the library's interface.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int MAX_PRIMS = 256;
constexpr int MAX_LIGHTS = 64;
constexpr float BIG = 1e30f;
constexpr float TMIN = 3e-2f;  // EPSILON, reference globals.h:49
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_PI = 0.318309886183790671538f;
constexpr int SPECULAR = 1;
constexpr int TRANSMISSIVE = 2;
constexpr int AREA_LIGHT = 1;

// The 1e5-radius wall spheres make the quadratic b^2 - |op|^2 + r^2 cancel
// badly in f32, so one ulp there changes which surface a lane hits. XLA on
// the CPU contracts multiply-adds into FMAs, nvcc does too but in its own
// pattern, and the plain PyTorch versions round every step. So the
// quadratics and the hit points use explicit FMAs in XLA's pattern, which
// the plain versions reproduce; elsewhere nvcc contracts as it likes.
__device__ __forceinline__ float dot3_fma(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return fmaf(az, bz, fmaf(ax, bx, __fmul_rn(ay, by)));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-20f));
  x *= inv;
  y *= inv;
  z *= inv;
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// top 24 bits -> [0, 1), exact in f32
__device__ __forceinline__ float bits_to_uniform(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// The uniforms of one wavefront iteration, in the order u_cam v_cam u1 u2 u3
// [ul1 ul2 usel]. Test mode (`uniforms` non-NULL) reads the TPU kernels'
// external block (n_tiles, budget, n_draw, tile_rows, 128); production mode
// draws Philox keyed on (seed, salt), countered on (global lane, frame,
// iteration, stream | draw group). `stream` keeps the kernels' draws apart.
__device__ __forceinline__ void draw_uniforms(
    float u[8], const float* uniforms, int tile, int budget, int it,
    int n_draw, int tile_lanes, int trow, int col, uint32_t lane,
    uint32_t frame, uint32_t seed, uint32_t salt, uint32_t stream) {
  if (uniforms) {
    const float* ub = uniforms +
                      (size_t)(tile * budget + it) * n_draw * tile_lanes +
                      trow * LANES + col;
    for (int j = 0; j < 8; ++j) u[j] = j < n_draw ? ub[j * tile_lanes] : 0.f;
  } else {
    const uint4 a = philox4x32_10(make_uint4(lane, frame, it, stream), seed, salt);
    const uint4 b = philox4x32_10(make_uint4(lane, frame, it, stream | 1u), seed, salt);
    u[0] = bits_to_uniform(a.x); u[1] = bits_to_uniform(a.y);
    u[2] = bits_to_uniform(a.z); u[3] = bits_to_uniform(a.w);
    u[4] = bits_to_uniform(b.x); u[5] = bits_to_uniform(b.y);
    u[6] = bits_to_uniform(b.z); u[7] = bits_to_uniform(b.w);
  }
}

// Primary ray direction of a regenerated path: stratified jitter over
// strat_k^2 cells picked by n_samp % strat_k^2 (cam: pack_camera layout).
__device__ __forceinline__ void camera_dir(const float* cam, float px,
                                           float py, int n_samp, int strat_k,
                                           float u_cam, float v_cam,
                                           float& dx, float& dy, float& dz) {
  float jx, jy;
  if (strat_k > 1) {
    const float inv_k = 1.0f / (float)strat_k;
    const int cell = n_samp % (strat_k * strat_k);
    jx = ((float)(cell % strat_k) + u_cam) * inv_k - 0.5f;
    jy = ((float)(cell / strat_k) + v_cam) * inv_k - 0.5f;
  } else {
    jx = u_cam - 0.5f;
    jy = v_cam - 0.5f;
  }
  const float sx = px + jx, sy = py + jy;
  dx = cam[0] - cam[6] * sy + cam[3] * sx;
  dy = cam[1] - cam[7] * sy + cam[4] * sx;
  dz = cam[2] - cam[8] * sy + cam[5] * sx;
  normalize3(dx, dy, dz);
}

// Solid-angle pdf of cone-sampling the sphere light LP (a pack_prims row)
// from o, 0 from inside it; the MIS weight of an emitter hit uses it.
__device__ __forceinline__ float cone_pdf(const float* LP, float ox, float oy,
                                          float oz) {
  const float dlx = LP[0] - ox, dly = LP[1] - oy, dlz = LP[2] - oz;
  const float d2l = dot3(dlx, dly, dlz, dlx, dly, dlz);
  const float rl = LP[3];
  const float sin2 = fminf(rl * rl / fmaxf(d2l, 1e-12f), 1.f);
  const float ctm = sqrtf(fmaxf(1.f - sin2, 0.f));
  const float pc = 1.f / (TWO_PI * fmaxf(1.f - ctm, 1e-12f));
  return d2l > rl * rl ? pc : 0.f;
}

struct LightSample {
  float wlx, wly, wlz, dist, pdf, rad_r, rad_g, rad_b;
  bool valid;
};

// NEE sample of light LT (a pack_lights row) from the hit point h. A sphere
// light (LP its pack_prims row, non-NULL) is cone-sampled around its centre
// and lights only its outer face; a point light is a delta light with 1/d^2
// falloff.
__device__ __forceinline__ LightSample sample_light(const float* LT,
                                                   const float* LP, float hx,
                                                   float hy, float hz,
                                                   float ul1, float ul2) {
  LightSample s;
  if (LP) {
    const float wrx = LP[0] - hx, wry = LP[1] - hy, wrz = LP[2] - hz;
    const float rl = LP[3];
    const float d2l = dot3_fma(wrx, wry, wrz, wrx, wry, wrz);
    const float inv_dc = rsqrtf(fmaxf(d2l, 1e-20f));
    const float wcx = wrx * inv_dc, wcy = wry * inv_dc, wcz = wrz * inv_dc;
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
    const float inv_rl = 1.0f / rl;
    const float nsx = (hx + s.wlx * thit - LP[0]) * inv_rl;
    const float nsy = (hy + s.wly * thit - LP[1]) * inv_rl;
    const float nsz = (hz + s.wlz * thit - LP[2]) * inv_rl;
    s.valid = s.valid && dot3(nsx, nsy, nsz, -s.wlx, -s.wly, -s.wlz) > 0.f;
    s.pdf = LT[7] / (TWO_PI * fmaxf(1.f - ctm, 1e-12f));
    s.dist = thit;
    s.rad_r = LT[3];
    s.rad_g = LT[4];
    s.rad_b = LT[5];
  } else {
    const float wrx = LT[0] - hx, wry = LT[1] - hy, wrz = LT[2] - hz;
    const float d2l = dot3(wrx, wry, wrz, wrx, wry, wrz);
    const float inv_dl = rsqrtf(fmaxf(d2l, 1e-20f));
    s.dist = d2l * inv_dl;
    s.wlx = wrx * inv_dl;
    s.wly = wry * inv_dl;
    s.wlz = wrz * inv_dl;
    const float inv_d2 = inv_dl * inv_dl;
    s.rad_r = LT[3] * inv_d2;
    s.rad_g = LT[4] * inv_d2;
    s.rad_b = LT[5] * inv_d2;
    s.pdf = LT[7];
    s.valid = s.dist > TMIN;
  }
  return s;
}

struct Lobe {
  float wix, wiy, wiz, fr, fg, fb, pdf, wgt;  // wgt = |cos| / pdf
};

// One BSDF lobe per lane: cosine hemisphere through the polar disk map
// (diffuse), mirror reflection (specular), or the Fresnel dielectric, whose
// reflection choice reuses u1.
__device__ __forceinline__ Lobe sample_lobe(bool is_s, bool is_t, float nx,
                                            float ny, float nz, float wox,
                                            float woy, float woz, float ar,
                                            float ag, float ab, float coef,
                                            float u1, float u2) {
  Lobe l;
  const float won = dot3(wox, woy, woz, nx, ny, nz);
  if (!(is_s || is_t)) {
    const float r_d = sqrtf(u1);
    const float th = TWO_PI * u2;
    const float ldx = r_d * cosf(th), ldy = r_d * sinf(th);
    const float ldz = sqrtf(fmaxf(1.f - u1, 0.f));
    const bool use_x = fabsf(nx) > fabsf(nz);
    float ux = use_x ? -ny : 0.f, uy = use_x ? nx : -nz, uz = use_x ? 0.f : ny;
    normalize3(ux, uy, uz);
    const float vx = ny * uz - nz * uy;
    const float vy = nz * ux - nx * uz;
    const float vz = nx * uy - ny * ux;
    l.wix = ux * ldx + vx * ldy + nx * ldz;
    l.wiy = uy * ldx + vy * ldy + ny * ldz;
    l.wiz = uz * ldx + vz * ldy + nz * ldz;
    l.pdf = dot3(wox, woy, woz, l.wix, l.wiy, l.wiz) < 0.f ? ldz * INV_PI : 0.f;
    l.fr = ar * INV_PI;
    l.fg = ag * INV_PI;
    l.fb = ab * INV_PI;
    l.wgt = PI_F;  // cos/pdf is exactly pi
    return l;
  }
  // mirror reflection, shared by the specular lobe and the dielectric
  const float wsx = wox - 2.f * won * nx;
  const float wsy = woy - 2.f * won * ny;
  const float wsz = woz - 2.f * won * nz;
  if (is_s) {
    l.wix = wsx; l.wiy = wsy; l.wiz = wsz;
    l.fr = coef * ar;
    l.fg = coef * ag;
    l.fb = coef * ab;
  } else {
    const bool entering = won < 0.f;
    const float ior = fmaxf(coef, 1.f);
    const float n1 = entering ? 1.f : ior, n2 = entering ? ior : 1.f;
    const float sgn = entering ? 1.f : -1.f;
    const float nnx = nx * sgn, nny = ny * sgn, nnz = nz * sgn;
    const float cos_i = -(wox * nnx + woy * nny + woz * nnz);
    const float eta = n1 / n2;
    const float sin2t = eta * eta * (1.f - cos_i * cos_i);
    const float cos_t = sqrtf(fmaxf(1.f - sin2t, 0.f));
    const float r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t);
    const float r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t);
    const float refl =
        sin2t > 1.f ? 1.f : 0.5f * (r_orth * r_orth + r_par * r_par);
    if (u1 < refl) {
      l.wix = wsx; l.wiy = wsy; l.wiz = wsz;
    } else {
      const float k = eta * (-cos_i) + cos_t;
      l.wix = wox * eta - k * nnx;
      l.wiy = woy * eta - k * nny;
      l.wiz = woz * eta - k * nnz;
    }
    l.fr = ar;
    l.fg = ag;
    l.fb = ab;
  }
  l.pdf = 1.f;
  l.wgt = fabsf(dot3(l.wix, l.wiy, l.wiz, nx, ny, nz));
  return l;
}

// Per-block sum of one value over the block's 128 threads, in a fixed
// order (warp shuffle tree, then the four warp sums in order), so the result
// does not depend on scheduling. `scratch` holds 4 floats of shared memory;
// every thread of the block must call it. The sum is valid on thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by the previous call
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  return threadIdx.x == 0 ? ((scratch[0] + scratch[1]) + scratch[2]) + scratch[3]
                          : 0.f;
}

}  // namespace
