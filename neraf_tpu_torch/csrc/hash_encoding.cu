// Multiresolution hash-grid encoding, forward and backward, for Hopper
// (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/hash_gather_attempt.py::pallas_vector_gather,
// the row gather table[idx] at the core of the hash-grid kernel that the TPU
// could not compile, together with the encoding the JAX package builds
// around that gather with XLA instead (neraf_tpu/ops/hashgrid.py::
// hash_encoding, and the scatter VJP of gather_rows). For rows x (N, 3) and
// a table (L * T, F), level l's rows at l * T:
//   xc   = clip(x, 0, 1); pos = xc * res_l (rounded f32 product, no FMA);
//   c0   = floor(pos); frac = pos - c0;
//   the 8 corners c = (i, j, k) at min(c0 + (i, j, k), res_l), indexed
//   densely (x + y (res+1) + z (res+1)^2) on a level whose (res+1)^3 corners
//   fit the table, else by the instant-NGP hash (x ^ 2654435761 y ^
//   805459861 z in uint32) & (T - 1);
//   w_c  = (wx * wy) * wz with w = frac or 1 - frac per axis;
//   out[row, l*F : l*F+F] = sum over c in order of w_c * table[row_c], each
//   term one fmaf into the sum (as XLA's CPU reduction forms it, bitwise).
//
// Forward: one thread per (row, level), the threads of a row adjacent, so a
// warp writes contiguous outputs; each corner's F features are one vector
// load (float4 at F = 4, float2 at F = 2) through the read-only path, and
// the weighted rows are summed in f32 in the reference's corner order.
// pos and the weights are rounded products (__fmul_rn): an FMA-contracted
// x * res - floor would move frac by an ulp, or below 0.
//
// Backward, for the output cotangent g (N, L*F): the table gradient is a
// zeroed (L*T, F) buffer filled with atomicAdd of w_c * g into each corner
// row (a sum in atomic order, so not bitwise repeatable); dx is
// d/dxc of the trilinear weights times (feature . g) times res, summed over
// corners and then over the levels of a row by shuffles among the row's
// threads, times clip's gradient (1 inside, 0 outside, 1/2 at exactly 0 or
// 1, as jnp.clip's). Either output may be skipped (a null pointer).
//
// What bounds it on the H100: device memory. A row reads 12 bytes of x and
// writes 4 L F bytes, and gathers 8 L table rows of 4 F bytes, each a 32-byte
// sector: the coarse levels stay in the 50 MB L2, the hashed fine levels
// of the 64 MiB table mostly miss it. The backward adds 8 L F scalar
// atomics a row, serialised in L2 where corners collide (most on the dense
// coarse levels). Shared-memory tables for the dense levels, vector atomics
// and fusing the encoding into the MLP are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct HashShape {
  int n;        // rows of x
  int levels;   // L
  int lp_log2;  // log2 of the threads per row: L rounded up to a power of 2
  int log2_t;   // log2 of the table rows per level
  int res[kMaxLevels];
  int dense[kMaxLevels];  // 1: the level is indexed densely
};

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ rows,
                                         uint32_t r, float (&v)[F]) {
  if constexpr (F == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(rows) + r);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = __ldg(reinterpret_cast<const float2*>(rows) + r);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* p, const float (&v)[F]) {
  if constexpr (F == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The clipped point's cell on one level: its lower corner and the fraction.
__device__ __forceinline__ void cell(const float (&xc)[3], uint32_t res,
                                     uint32_t (&c0)[3], float (&frac)[3]) {
  const float r = float(res);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fmul_rn(xc[d], r);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    c0[d] = uint32_t(fl);
  }
}

__device__ __forceinline__ uint32_t corner_row(const uint32_t (&c0)[3], int c,
                                               uint32_t res, bool dense,
                                               uint32_t mask) {
  const uint32_t cx = min(c0[0] + uint32_t(c >> 2), res);
  const uint32_t cy = min(c0[1] + uint32_t((c >> 1) & 1), res);
  const uint32_t cz = min(c0[2] + uint32_t(c & 1), res);
  if (dense) {
    const uint32_t st = res + 1u;
    return cx + cy * st + cz * st * st;
  }
  return (cx ^ (cy * 2654435761u) ^ (cz * 805459861u)) & mask;
}

// The per-axis weights of corner c: frac on the upper side, 1 - frac below.
__device__ __forceinline__ void axis_weights(const float (&frac)[3], int c,
                                             float (&w)[3]) {
  const int bit[3] = {c >> 2, (c >> 1) & 1, c & 1};
#pragma unroll
  for (int d = 0; d < 3; ++d) w[d] = bit[d] ? frac[d] : __fsub_rn(1.0f, frac[d]);
}

__device__ __forceinline__ void load_clipped(const float* __restrict__ x,
                                             int row, float (&xc)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d)
    xc[d] = fminf(fmaxf(__ldg(x + size_t(row) * 3 + d), 0.0f), 1.0f);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_encoding_fwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             float* __restrict__ out, HashShape s) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int row = int(t >> s.lp_log2);
  const int lvl = int(t & ((1 << s.lp_log2) - 1));
  if (row >= s.n || lvl >= s.levels) return;
  float xc[3];
  load_clipped(x, row, xc);
  const uint32_t res = uint32_t(s.res[lvl]);
  const bool dense = s.dense[lvl] != 0;
  const uint32_t mask = (1u << s.log2_t) - 1u;
  uint32_t c0[3];
  float frac[3];
  cell(xc, res, c0, frac);
  const float* rows = table + (size_t(lvl) << s.log2_t) * F;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float w[3];
    axis_weights(frac, c, w);
    const float wc = __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
    float v[F];
    load_row<F>(rows, corner_row(c0, c, res, dense, mask), v);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = fmaf(v[f], wc, acc[f]);
  }
  store_row<F>(out + size_t(row) * (s.levels * F) + lvl * F, acc);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    hash_encoding_bwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             const float* __restrict__ g,
                             float* __restrict__ dtable,
                             float* __restrict__ dx, HashShape s) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int row = int(t >> s.lp_log2);
  const int lvl = int(t & ((1 << s.lp_log2) - 1));
  float dpos[3] = {0.0f, 0.0f, 0.0f};
  float xc[3] = {0.0f, 0.0f, 0.0f};
  if (row < s.n && lvl < s.levels) {
    load_clipped(x, row, xc);
    const uint32_t res = uint32_t(s.res[lvl]);
    const bool dense = s.dense[lvl] != 0;
    const uint32_t mask = (1u << s.log2_t) - 1u;
    uint32_t c0[3];
    float frac[3];
    cell(xc, res, c0, frac);
    const size_t base = (size_t(lvl) << s.log2_t) * F;
    float gv[F];
    load_row<F>(g + size_t(row) * (s.levels * F) + lvl * F, 0, gv);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float w[3];
      axis_weights(frac, c, w);
      const uint32_t r = corner_row(c0, c, res, dense, mask);
      if (dtable != nullptr) {
        const float wc = __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
        float* dst = dtable + base + size_t(r) * F;
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(dst + f, __fmul_rn(wc, gv[f]));
      }
      if (dx != nullptr) {
        float v[F];
        load_row<F>(table + base, r, v);
        float dot = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot = fmaf(v[f], gv[f], dot);
        // d w_c / d frac_d: the other two axes' weights, signed by the side
        const float dw[3] = {w[1] * w[2], w[0] * w[2], w[0] * w[1]};
        const int bit[3] = {c >> 2, (c >> 1) & 1, c & 1};
#pragma unroll
        for (int d = 0; d < 3; ++d)
          dpos[d] += (bit[d] ? dw[d] : -dw[d]) * dot;
      }
    }
    const float r = float(res);
#pragma unroll
    for (int d = 0; d < 3; ++d) dpos[d] *= r;
  }
  if (dx == nullptr) return;  // the same for every thread of the launch
  // a row's levels are 2^lp_log2 adjacent lanes of one warp
  for (int off = (1 << s.lp_log2) >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      dpos[d] += __shfl_xor_sync(0xffffffffu, dpos[d], off);
  if (row < s.n && lvl == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = __ldg(x + size_t(row) * 3 + d);
      const float clip_grad = (v < 0.0f || v > 1.0f) ? 0.0f
                              : (v == 0.0f || v == 1.0f) ? 0.5f : 1.0f;
      dx[size_t(row) * 3 + d] = dpos[d] * clip_grad;
    }
  }
}

int make_shape(int n, int levels, int features, int log2_t, const int* res,
               const int* dense, HashShape* s) {
  if (n <= 0 || levels < 1 || levels > kMaxLevels ||
      (features != 2 && features != 4) || log2_t < 1 || log2_t > 26)
    return int(cudaErrorInvalidValue);
  s->n = n;
  s->levels = levels;
  s->lp_log2 = 0;
  while ((1 << s->lp_log2) < levels) ++s->lp_log2;
  s->log2_t = log2_t;
  for (int l = 0; l < kMaxLevels; ++l) {
    s->res[l] = l < levels ? res[l] : 0;
    s->dense[l] = l < levels ? dense[l] : 0;
  }
  return 0;
}

unsigned grid_for(const HashShape& s) {
  const long long threads = static_cast<long long>(s.n) << s.lp_log2;
  return unsigned((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`: x (n, 3) f32, table (levels << log2_t,
// features) f32, out (n, levels * features) f32; res and dense are host
// arrays of `levels` ints. Returns the cudaError_t of the launch.
int neraf_hash_encoding_launch(const float* x, const float* table, float* out,
                               int n, int levels, int features, int log2_t,
                               const int* res, const int* dense, void* stream) {
  HashShape s;
  const int bad = make_shape(n, levels, features, log2_t, res, dense, &s);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (features == 4)
    hash_encoding_fwd_kernel<4><<<grid_for(s), kThreads, 0, st>>>(x, table, out, s);
  else
    hash_encoding_fwd_kernel<2><<<grid_for(s), kThreads, 0, st>>>(x, table, out, s);
  return int(cudaGetLastError());
}

// Launches the backward on `stream` for the cotangent g (n, levels *
// features) f32: dtable (levels << log2_t, features) f32, zeroed by the
// caller, receives the table gradient and dx (n, 3) f32 the position
// gradient; either may be null (not computed).
int neraf_hash_encoding_bwd_launch(const float* x, const float* table,
                                   const float* g, float* dtable, float* dx,
                                   int n, int levels, int features, int log2_t,
                                   const int* res, const int* dense,
                                   void* stream) {
  HashShape s;
  const int bad = make_shape(n, levels, features, log2_t, res, dense, &s);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (features == 4)
    hash_encoding_bwd_kernel<4><<<grid_for(s), kThreads, 0, st>>>(
        x, table, g, dtable, dx, s);
  else
    hash_encoding_bwd_kernel<2><<<grid_for(s), kThreads, 0, st>>>(
        x, table, g, dtable, dx, s);
  return int(cudaGetLastError());
}

}  // extern "C"
