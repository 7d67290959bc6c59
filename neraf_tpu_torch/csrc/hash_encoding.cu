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
// The backward, for the output cotangent g (N, L*F), adds w_c * g into
// corner row_c of a zeroed (L*T, F) table gradient, and forms dx = d/dxc of
// the trilinear weights times (feature . g) times res, summed over corners
// and levels, times clip's gradient (1 inside, 0 outside, 1/2 at exactly 0
// or 1, as jnp.clip's). Either output may be skipped (a null pointer).
//
// Both kernels map one thread to a row, the 32 lanes of a warp to 32
// consecutive rows, and loop over the levels. The main path's rows are
// coherent (a ray's samples in order, the bake's cells along grid lines), so
// on the dense coarse levels the lanes of a warp share corners.
//
// Forward. What bounds it on the H100: the L2's sectors, not device memory.
// A row reads 12 bytes and writes 4 L F, but gathers 8 L table rows of 4 F
// bytes, each a 32-byte sector of the L2 (the 64 MiB table of the hashed
// fine levels mostly misses the 50 MB L2). With a warp on one level,
// lanes whose corners coincide read one sector in one instruction. A level's
// 8 corner loads (16 bytes each at F = 4, 8 at F = 2, through the read-only
// path) go out together, and the next level's go out before this
// level's sums, so that a thread keeps 16 gathers in flight. The outputs are
// staged in shared memory, 8 levels at a time, and stored as vectors with
// consecutive lanes on consecutive (row, level) pairs: a warp writes its
// rows' contiguous runs rather than 32 rows at a 4 L F-byte stride.
//
// Backward. What bounds it: the atomic adds into the table gradient, which
// the L2 serialises where rows collide, as they do on the coarse levels at
// the path's points (8 L F scalar atomics a row would be 256 at L 8, F 4).
// On each level the warp's lanes are grouped by their point's cell
// (__match_any_sync on the cell): lanes in one cell add into the same 8
// rows. Each lane stages its frac and g in a shared-memory slot; the
// group's k-th lane takes corners k, k + size, ..., sums w_c * g over the
// group's lanes in lane order and adds the sum with one vector atomic
// (float4 at F = 4, float2 at F = 2; its result unused, so a RED). A warp
// with no two lanes in one cell skips the slots and adds once a lane and
// corner. Grouping by cell costs one match a level where grouping by each
// corner's row would cost eight, and spreads a large group's sums over its
// lanes; it misses only rows that two cells share for one corner (a hash
// collision, or the clamp at res). The hashed levels are grouped too: on an
// H100 80GB HBM3 at 700 W, a train step's main-field points took
// 0.162-0.166 ms with every level grouped against 0.205-0.214 with the
// dense levels only, and random points took the same either way.
// The cotangent is staged in shared memory like the forward's outputs; dx
// is summed in registers over the levels and written once a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kWarp = 32;
constexpr int kThreads = 128;  // one row a thread
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunk = 8;  // levels staged in shared memory at a time

// A staged row: kChunk levels of F floats and F floats of padding, so that
// a warp's vector accesses to one level (32 rows) fall in distinct banks.
template <int F>
constexpr int kStride = (kChunk + 1) * F;
constexpr int kSlot = 8;  // floats a lane stages for its group's adds

struct HashShape {
  int n;       // rows of x
  int levels;  // L
  int log2_t;  // log2 of the table rows per level
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

template <int F>
__device__ __forceinline__ void read_row(const float* p, float (&v)[F]) {
  if constexpr (F == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// One vector atomic add of F floats (a RED: the result is not read).
template <int F>
__device__ __forceinline__ void red_row(float* p, const float (&v)[F]) {
  if constexpr (F == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
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

// Level l's cell of the point and its 8 corner rows, loaded together.
template <int F>
__device__ __forceinline__ void load_level(const float* __restrict__ table,
                                           const HashShape& s, int l,
                                           const float (&xc)[3],
                                           float (&frac)[3], float (&v)[8][F]) {
  const uint32_t res = uint32_t(s.res[l]);
  const bool dense = s.dense[l] != 0;
  const uint32_t mask = (1u << s.log2_t) - 1u;
  uint32_t c0[3];
  cell(xc, res, c0, frac);
  const float* rows = table + (size_t(l) << s.log2_t) * F;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    load_row<F>(rows, corner_row(c0, c, res, dense, mask), v[c]);
}

// The warp's staged levels l0 .. l0 + nl - 1 of its rows row0 .. row0 + 31
// to or from a (n, lf) array in device memory, a vector of F at a time,
// consecutive lanes on consecutive (row, level) pairs; rows past n are
// skipped.
template <int F>
__device__ __forceinline__ void tile_to_global(float* __restrict__ dst,
                                               const float* tile, int row0,
                                               int n, int lf, int l0, int nl,
                                               int lane) {
  for (int j = lane; j < kWarp * nl; j += kWarp) {
    const int r = j / nl, l = j - r * nl;
    if (row0 + r >= n) break;
    float v[F];
    read_row<F>(tile + r * kStride<F> + l * F, v);
    store_row<F>(dst + size_t(row0 + r) * lf + (l0 + l) * F, v);
  }
}

template <int F>
__device__ __forceinline__ void global_to_tile(const float* __restrict__ src,
                                               float* tile, int row0, int n,
                                               int lf, int l0, int nl,
                                               int lane) {
  for (int j = lane; j < kWarp * nl; j += kWarp) {
    const int r = j / nl, l = j - r * nl;
    if (row0 + r >= n) break;
    float v[F];
    load_row<F>(src + size_t(row0 + r) * lf + (l0 + l) * F, 0, v);
    store_row<F>(tile + r * kStride<F> + l * F, v);
  }
}

// The warp's lanes grouped by their point's cell on one level (the lanes
// past n apart): lanes in one cell add into the same 8 rows. A dense
// level's cell is its lower corner's row; a hashed level's its coordinates
// (c0 <= res < 2^21), since rows there collide.
__device__ __forceinline__ unsigned cell_group(const uint32_t (&c0)[3],
                                               uint32_t res, bool dense,
                                               bool valid) {
  if (dense) {  // no valid row is 0xffffffff (rows < 2^26)
    const uint32_t st = res + 1u;
    return __match_any_sync(0xffffffffu,
                            valid ? c0[0] + c0[1] * st + c0[2] * st * st
                                  : 0xffffffffu);
  }
  const unsigned long long key = (static_cast<unsigned long long>(c0[0]) << 42) |
                                 (static_cast<unsigned long long>(c0[1]) << 21) |
                                 c0[2];
  return __match_any_sync(0xffffffffu, valid ? key : ~0ull);
}

// A group's adds on one level. Its lanes share the cell c0, so corner c's
// row is one row for all of them: the group's k-th lane (in lane order)
// takes corners k, k + size, ..., and for each sums w_c * g over the
// group's lanes in lane order, from the frac and g each staged in its slot
// (kSlot floats: frac at 0-2, g at 4), then adds the sum with one vector
// atomic.
template <int F>
__device__ __forceinline__ void add_group(float* rows, const uint32_t (&c0)[3],
                                          uint32_t res, bool dense,
                                          uint32_t mask, unsigned group,
                                          const float* slot, int lane) {
  const int size = __popc(group), rank = __popc(group & ((1u << lane) - 1u));
  for (int c = rank; c < 8; c += size) {
    float sum[F];
#pragma unroll
    for (int f = 0; f < F; ++f) sum[f] = 0.0f;
    for (unsigned m = group; m != 0; m &= m - 1u) {
      const float* q = slot + (__ffs(m) - 1) * kSlot;
      const float frac[3] = {q[0], q[1], q[2]};
      float w[3];
      axis_weights(frac, c, w);
      const float wc = __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
#pragma unroll
      for (int f = 0; f < F; ++f) sum[f] += __fmul_rn(wc, q[4 + f]);
    }
    red_row<F>(rows + size_t(corner_row(c0, c, res, dense, mask)) * F, sum);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 4)
    hash_encoding_fwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             float* __restrict__ out,
                             const __grid_constant__ HashShape s) {
  __shared__ __align__(16) float staged[kWarps][kWarp * kStride<F>];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int row0 = (blockIdx.x * kWarps + warp) * kWarp;
  if (row0 >= s.n) return;  // the whole warp
  float xc[3];
  // the lanes of a ragged last warp past n redo row n - 1 and store nothing
  load_clipped(x, min(row0 + lane, s.n - 1), xc);
  float* tile = staged[warp];
  float frac[3], v[8][F];
  load_level<F>(table, s, 0, xc, frac, v);
  for (int l = 0; l < s.levels; ++l) {
    float next_frac[3], next[8][F];
    if (l + 1 < s.levels) load_level<F>(table, s, l + 1, xc, next_frac, next);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float w[3];
      axis_weights(frac, c, w);
      const float wc = __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = fmaf(v[c][f], wc, acc[f]);
    }
    const int k = l % kChunk;
    store_row<F>(tile + lane * kStride<F> + k * F, acc);
    if (k == kChunk - 1 || l + 1 == s.levels) {
      __syncwarp();
      tile_to_global<F>(out, tile, row0, s.n, s.levels * F, l - k, k + 1,
                        lane);
      __syncwarp();
    }
    if (l + 1 < s.levels) {
#pragma unroll
      for (int d = 0; d < 3; ++d) frac[d] = next_frac[d];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int f = 0; f < F; ++f) v[c][f] = next[c][f];
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, 4)
    hash_encoding_bwd_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             const float* __restrict__ g,
                             float* __restrict__ dtable,
                             float* __restrict__ dx,
                             const __grid_constant__ HashShape s) {
  __shared__ __align__(16) float staged[kWarps][kWarp * kStride<F>];
  __shared__ __align__(16) float slots[kWarps][kWarp * kSlot];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int row0 = (blockIdx.x * kWarps + warp) * kWarp;
  if (row0 >= s.n) return;  // the whole warp
  // the lanes of a ragged last warp past n take part in the warp's
  // collectives and add and store nothing
  const bool valid = row0 + lane < s.n;
  const int row = valid ? row0 + lane : s.n - 1;
  float xc[3];
  load_clipped(x, row, xc);
  float* tile = staged[warp];
  float* slot = slots[warp];
  const uint32_t mask = (1u << s.log2_t) - 1u;
  float dxs[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < s.levels; ++l) {
    const int k = l % kChunk;
    if (k == 0) {
      __syncwarp();
      global_to_tile<F>(g, tile, row0, s.n, s.levels * F, l,
                        min(kChunk, s.levels - l), lane);
      __syncwarp();
    }
    float gv[F];
    read_row<F>(tile + lane * kStride<F> + k * F, gv);
    const uint32_t res = uint32_t(s.res[l]);
    const bool dense = s.dense[l] != 0;
    uint32_t c0[3];
    float frac[3];
    cell(xc, res, c0, frac);
    const size_t base = (size_t(l) << s.log2_t) * F;
    // the table gradient: by groups of lanes in one cell where any two
    // lanes share one, else one add a lane and corner
    bool grouped = false;
    if (dtable != nullptr) {
      const unsigned group = cell_group(c0, res, dense, valid);
      grouped = __any_sync(0xffffffffu, valid && group != (1u << lane));
      if (grouped) {
        float* q = slot + lane * kSlot;
#pragma unroll
        for (int d = 0; d < 3; ++d) q[d] = frac[d];
#pragma unroll
        for (int f = 0; f < F; ++f) q[4 + f] = gv[f];
        __syncwarp();
        if (valid)
          add_group<F>(dtable + base, c0, res, dense, mask, group, slot, lane);
        __syncwarp();
      }
    }
    float dpos[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float w[3];
      axis_weights(frac, c, w);
      const uint32_t r = corner_row(c0, c, res, dense, mask);
      if (dtable != nullptr && !grouped && valid) {
        const float wc = __fmul_rn(__fmul_rn(w[0], w[1]), w[2]);
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = __fmul_rn(wc, gv[f]);
        red_row<F>(dtable + base + size_t(r) * F, v);
      }
      if (dx != nullptr) {
        float t[F];
        load_row<F>(table + base, r, t);
        float dot = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot = fmaf(t[f], gv[f], dot);
        // d w_c / d frac_d: the other two axes' weights, signed by the side
        const float dw[3] = {w[1] * w[2], w[0] * w[2], w[0] * w[1]};
        const int bit[3] = {c >> 2, (c >> 1) & 1, c & 1};
#pragma unroll
        for (int d = 0; d < 3; ++d)
          dpos[d] += (bit[d] ? dw[d] : -dw[d]) * dot;
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) dxs[d] += dpos[d] * float(res);
  }
  if (dx == nullptr || !valid) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float v = __ldg(x + size_t(row) * 3 + d);
    const float clip_grad = (v < 0.0f || v > 1.0f) ? 0.0f
                            : (v == 0.0f || v == 1.0f) ? 0.5f : 1.0f;
    dx[size_t(row) * 3 + d] = dxs[d] * clip_grad;
  }
}

int make_shape(int n, int levels, int features, int log2_t, const int* res,
               const int* dense, HashShape* s) {
  if (n <= 0 || levels < 1 || levels > kMaxLevels ||
      (features != 2 && features != 4) || log2_t < 1 || log2_t > 26)
    return int(cudaErrorInvalidValue);
  s->n = n;
  s->levels = levels;
  s->log2_t = log2_t;
  for (int l = 0; l < levels; ++l)
    if (res[l] < 1 || res[l] >= (1 << 21)) return int(cudaErrorInvalidValue);
  for (int l = 0; l < kMaxLevels; ++l) {
    s->res[l] = l < levels ? res[l] : 0;
    s->dense[l] = l < levels ? dense[l] : 0;
  }
  return 0;
}

unsigned grid_for(const HashShape& s) {
  return unsigned((static_cast<long long>(s.n) + kThreads - 1) / kThreads);
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
// features) f32, 16-byte aligned: dtable (levels << log2_t, features) f32,
// zeroed by the caller, receives the table gradient and dx (n, 3) f32 the
// position gradient; either may be null (not computed).
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
