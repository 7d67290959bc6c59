// Shared pieces of the fused PE+MLP kernels (pe_mlp.cu: forward,
// pe_mlp_bwd.cu: backward): the packed-layout constants, the range-reduced
// encoding, the mma.sync / ldmatrix / cp.async wrappers, the per-layer weight
// staging and the register-resident ReLU layer; stem_wgrad.cu uses the
// mma.sync and ldmatrix wrappers. Everything here has internal linkage, so
// each source gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;  // bf16 kernel: 16 rows per warp
constexpr int kSkew = 8;                // bf16 padding per shared-memory row
constexpr int kMaxK0 = 64;              // 6F + 3 <= 63, F <= 10
constexpr int kMaxOut = 32;
constexpr int kMaxHidden = 256;

constexpr int kF32Rows = 64;
constexpr int kF32K = 32;
constexpr int kF32Ld = kMaxHidden + 1;  // odd stride: conflict-free columns

struct PeMlpShape {
  int n;         // rows
  int F;         // frequencies
  int k0p;       // layer-0 input width, padded
  int hp;        // hidden width, padded
  int n_hidden;  // ReLU layers, >= 1
  int out_dim;   // O
  int op;        // O padded to a multiple of 8
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of the bf16 kernel: the largest staged layer, then biases.
__host__ __device__ inline size_t bf16_weight_bytes(int hp, int k0p, int op) {
  const int w = imax(hp * (imax(k0p, hp) + kSkew), op * (hp + kSkew));
  return size_t(w) * 2;
}
__host__ __device__ inline size_t bf16_smem_bytes(int hp, int k0p, int op) {
  return bf16_weight_bytes(hp, k0p, op) + size_t(imax(hp, op)) * 4;
}
inline size_t f32_smem_bytes() {
  return size_t(2 * kF32Rows + kF32K) * kF32Ld * 4;
}

// Encoding pair p of a row (interleaved layer-0 layout): (sin, cos) of
// 2 pi f x_d for p = d F + k < 3F, then (x0, x1), (x2, 0), zeros.
__device__ __forceinline__ float2 encode_pair(int p, float x0, float x1,
                                              float x2,
                                              const float* __restrict__ freqs,
                                              int F) {
  if (p < 3 * F) {
    const int d = p / F;
    const float xd = d == 0 ? x0 : (d == 1 ? x1 : x2);
    const float f = __ldg(freqs + (p - d * F));
    const float t_hi = __fmul_rn(f, xd);  // never contracted into an FMA
    const float t_lo = fmaf(f, xd, -t_hi);
    const float r = (t_hi - rintf(t_hi)) + t_lo;
    float s, c;
    sincospif(2.0f * r, &s, &c);
    return make_float2(s, c);
  }
  if (p == 3 * F) return make_float2(x0, x1);
  if (p == 3 * F + 1) return make_float2(x2, 0.0f);
  return make_float2(0.0f, 0.0f);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying a rows x k bf16 layer (row-major, k a multiple of 16) into
// shared memory at row stride k + kSkew and its biases; the caller waits
// with cp_async_wait_all and syncs the block.
__device__ __forceinline__ void stage_layer(__nv_bfloat16* ws, float* bs,
                                            const __nv_bfloat16* w,
                                            const float* __restrict__ b,
                                            int rows, int k) {
  const int per_row = k / 8;  // 16-byte chunks
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i - r * per_row;
    cp_async16(ws + r * (k + kSkew) + c * 8, w + size_t(r) * k + c * 8);
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) bs[i] = __ldg(b + i);
}

// One ReLU layer for a warp's 16 rows. `a` holds the input as A fragments
// of KT k16 tiles (only the first kt_used are read), `o` receives the
// output as A fragments of OUT_KT tiles (N = 16 OUT_KT columns). ws is the
// N x K weight at row stride ldw, bs its biases.
template <int KT, int OUT_KT>
__device__ __forceinline__ void relu_layer(const uint32_t (&a)[KT][4],
                                           uint32_t (&o)[OUT_KT][4],
                                           const __nv_bfloat16* ws, int ldw,
                                           const float* bs, int kt_used,
                                           int lane) {
  constexpr int kChunk = OUT_KT < 4 ? OUT_KT : 4;  // 64 columns per pass
  const int q = lane & 3;
  // ldmatrix.x4 rows: matrices (n tile 0, k 0-7), (0, 8-15), (1, 0-7), (1, 8-15)
  const int mrow = ((lane >> 4) << 3) + (lane & 7);
  const int mcol = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int c0 = 0; c0 < OUT_KT; c0 += kChunk) {
    float acc[2 * kChunk][4];
#pragma unroll
    for (int j = 0; j < 2 * kChunk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < kt_used) {
#pragma unroll
        for (int jp = 0; jp < kChunk; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, ws + ((c0 + jp) * 16 + mrow) * ldw + kt * 16 + mcol);
          mma_bf16(acc[2 * jp], a[kt], b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a[kt], b[2], b[3]);
        }
      }
    }
    // accumulator of n tile j (rows g, g+8; columns 2q, 2q+1) -> the A
    // fragment of k tile c0 + j/2: registers 0/1 for j even, 2/3 for odd
#pragma unroll
    for (int j = 0; j < 2 * kChunk; ++j) {
      const int col = c0 * 16 + j * 8 + 2 * q;
      const float b0 = bs[col], b1 = bs[col + 1];
      o[c0 + j / 2][(j & 1) * 2] = pack_bf16x2(fmaxf(acc[j][0] + b0, 0.0f),
                                               fmaxf(acc[j][1] + b1, 0.0f));
      o[c0 + j / 2][(j & 1) * 2 + 1] = pack_bf16x2(
          fmaxf(acc[j][2] + b0, 0.0f), fmaxf(acc[j][3] + b1, 0.0f));
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

}  // namespace
