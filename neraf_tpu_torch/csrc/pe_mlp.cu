// Fused fourier positional encoding + ReLU MLP forward for Hopper (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp, forward
// (_fwd_call, kernel _make_fwd_kernel). For rows x in [0,1]^3 it computes
//   enc = [sin(2 pi f_k x_d), cos(2 pi f_k x_d) for every (d, k)] + [x]
//   h   = relu(W_i h + b_i) for the hidden layers, out = W_o h + b_o (f32),
// the base MLP of the Nerfacto proposal fields (39 -> 128 -> 128 -> 1) and
// main field (63 -> 256 x 4 -> 16) of the vision render path.
//
// Layout (pack_layers in ops/pe_mlp.py): all weights are PyTorch's
// (out, in), zero-padded: hidden width to HP in {16, 32, 64, 128, 256}, layer
// 0's input to K0P (a multiple of 16), the output to OP (a multiple of 8).
// Layer 0's columns are interleaved [sin_0, cos_0, sin_1, cos_1, ..., x0,
// x1, x2, 0...], so each pair of adjacent encoding columns is one sincos.
//
// bf16 kernel, one warp per 16 rows, 8 warps (128 rows) per block:
//  - each thread forms its own entries of the layer-0 mma A fragments (two
//    rows, pairs of adjacent columns) straight in registers: the encoding
//    never touches memory;
//  - every layer runs as mma.sync m16n8k16 bf16 products with f32
//    accumulation; the bias add and ReLU are f32, then the f32 accumulator
//    fragment of two n8 tiles is exactly the bf16 A fragment of one k16
//    tile of the next layer, so activations stay in registers from layer
//    to layer (no hidden activation reaches shared or device memory);
//  - the weights are staged in shared memory one layer at a time with
//    cp.async (the main field's 424 KiB of weights do not fit a block's
//    227 KB; its largest layer, 256 x 256, is 132 KiB with the row skew);
//  - the output layer writes (N, O) f32, masked to the ragged row count.
// Angles are range-reduced as in the Pallas kernel: t = f x in turns is
// split exactly into t_hi + t_lo (the f32 product and its FMA residual) and
// reduced to r = (t_hi - rint(t_hi)) + t_lo in [-1/2, 1/2] before
// sincospi(2r). At 2^8 turns an unreduced fast sine is wrong, and even the
// f32 rounding of t alone costs ~1e-4 rad.
//
// What bounds it on the H100: the tensor cores fed by mma.sync, and shared
// memory reads of the B fragments. A warp reads a layer's whole weight
// matrix once per 16 rows (16 FLOP per byte of shared memory, about half the
// card's bf16 rate at 128 B/clk/SM), and the per-layer weight staging is not
// overlapped with the products (about a fifth of a layer's time at HP 256).
// Device memory sees only x (12 B/row) and the output (4 O B/row). Weights
// resident across persistent blocks, wgmma and TMA are left for later.
//
// The f32 kernel (CUDA-core FMA, no TF32) is the same function for checks
// in f32: 64 rows per block, activations in shared memory, weights staged
// in 32-deep K slices.

#include "pe_mlp_common.cuh"

namespace {

// The linear output layer: op (<= kMaxOut) columns from KT k tiles,
// written as f32 to out (n x out_dim) for the warp's rows row0 .. row0+15.
template <int KT>
__device__ __forceinline__ void out_layer(const uint32_t (&a)[KT][4],
                                          const __nv_bfloat16* ws, int ldw,
                                          const float* bs,
                                          float* __restrict__ out, int row0,
                                          const PeMlpShape& s, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int mrow = lane & 7, mcol = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int nt = 0; nt < kMaxOut / 8; ++nt) {
    if (nt * 8 < s.op) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t b[2];
        ldmatrix_x2(b, ws + (nt * 8 + mrow) * ldw + kt * 16 + mcol);
        mma_bf16(acc, a[kt], b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * q + e;
        if (col < s.out_dim) {
          const int r0 = row0 + g, r1 = row0 + g + 8;
          if (r0 < s.n) out[size_t(r0) * s.out_dim + col] = acc[e] + bs[col];
          if (r1 < s.n) out[size_t(r1) * s.out_dim + col] = acc[2 + e] + bs[col];
        }
      }
    }
  }
}

template <int HP>
__global__ void __launch_bounds__(kThreads, (HP > 128 ? 1 : 2))
    pe_mlp_bf16_kernel(const float* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ freqs,
                       float* __restrict__ out, PeMlpShape s) {
  constexpr int KT = HP / 16;
  constexpr int KT0 = kMaxK0 / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bs = reinterpret_cast<float*>(smem + bf16_weight_bytes(HP, s.k0p, s.op));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * kTileRows + warp * 16;

  // layer 0's weights are in flight while the encoding is formed
  stage_layer(ws, bs, w, bias, HP, s.k0p);
  float xr[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
#pragma unroll
    for (int d = 0; d < 3; ++d) xr[h][d] = r < s.n ? __ldg(x + size_t(r) * 3 + d) : 0.0f;
  }
  uint32_t a0[KT0][4];
#pragma unroll
  for (int kt = 0; kt < KT0; ++kt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 e = encode_pair(kt * 8 + half * 4 + q, xr[h][0], xr[h][1],
                                     xr[h][2], freqs, s.F);
        a0[kt][half * 2 + h] = pack_bf16x2(e.x, e.y);
      }
  cp_async_wait_all();
  __syncthreads();

  uint32_t act[KT][4];
  relu_layer<KT0, KT>(a0, act, ws, s.k0p + kSkew, bs, s.k0p / 16, lane);
  const __nv_bfloat16* wl = w + size_t(HP) * s.k0p;
  const float* bl = bias + HP;
  for (int l = 1; l < s.n_hidden; ++l) {
    __syncthreads();
    stage_layer(ws, bs, wl, bl, HP, HP);
    cp_async_wait_all();
    __syncthreads();
    uint32_t nxt[KT][4];
    relu_layer<KT, KT>(act, nxt, ws, HP + kSkew, bs, KT, lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) act[kt][e] = nxt[kt][e];
    wl += size_t(HP) * HP;
    bl += HP;
  }
  __syncthreads();
  stage_layer(ws, bs, wl, bl, s.op, HP);
  cp_async_wait_all();
  __syncthreads();
  out_layer<KT>(act, ws, HP + kSkew, bs, out, row0, s, lane);
}

// f32 on the CUDA cores: thread (ty, tx) owns rows ty*8 .. ty*8+7 and
// columns tx + 32 j of each layer's output.
__global__ void __launch_bounds__(kThreads)
    pe_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ freqs,
                      float* __restrict__ out, PeMlpShape s) {
  extern __shared__ float fsm[];
  float* act_in = fsm;
  float* act_out = fsm + kF32Rows * kF32Ld;
  float* wt = fsm + 2 * kF32Rows * kF32Ld;  // wt[kk][c] = W[c][k0 + kk]
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * kF32Rows;

  const int pairs = s.k0p / 2;
  for (int i = tid; i < kF32Rows * pairs; i += blockDim.x) {
    const int r = i / pairs, p = i - r * pairs;
    const int gr = row0 + r;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
    if (gr < s.n) {
      x0 = __ldg(x + size_t(gr) * 3);
      x1 = __ldg(x + size_t(gr) * 3 + 1);
      x2 = __ldg(x + size_t(gr) * 3 + 2);
    }
    const float2 e = encode_pair(p, x0, x1, x2, freqs, s.F);
    act_in[r * kF32Ld + 2 * p] = e.x;
    act_in[r * kF32Ld + 2 * p + 1] = e.y;
  }
  __syncthreads();

  const float* wl = w;
  const float* bl = bias;
  int k = s.k0p;
  for (int l = 0; l <= s.n_hidden; ++l) {
    const bool last = l == s.n_hidden;
    const int nout = last ? s.op : s.hp;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kF32K) {
      const int kn = k - k0 < kF32K ? k - k0 : kF32K;
      for (int i = tid; i < nout * kF32K; i += blockDim.x) {
        const int c = i / kF32K, kk = i - c * kF32K;
        if (kk < kn) wt[kk * kF32Ld + c] = __ldg(wl + size_t(c) * k + k0 + kk);
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = act_in[(ty * 8 + i) * kF32Ld + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 32 * j;
          bv[j] = c < nout ? wt[kk * kF32Ld + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 32 * j;
        if (c < nout) {
          const float v = acc[i][j] + __ldg(bl + c);
          if (!last) {
            act_out[r * kF32Ld + c] = fmaxf(v, 0.0f);
          } else if (c < s.out_dim && row0 + r < s.n) {
            out[size_t(row0 + r) * s.out_dim + c] = v;
          }
        }
      }
    }
    __syncthreads();
    float* t = act_in;
    act_in = act_out;
    act_out = t;
    wl += size_t(nout) * k;
    bl += nout;
    k = s.hp;
  }
}

}  // namespace

extern "C" {

// Launches the fused PE+MLP forward on `stream` (bf16 != 0: the bf16
// tensor-core kernel, weights bf16; else the f32 kernel, weights f32);
// returns the cudaError_t of the launch. Shapes are those of pack_layers.
int neraf_pe_mlp_launch(const float* x, const void* w, const float* bias,
                        const float* freqs, float* out, int n, int F, int k0p,
                        int hp, int n_hidden, int out_dim, int op, int bf16,
                        void* stream) {
  const PeMlpShape s{n, F, k0p, hp, n_hidden, out_dim, op};
  if (n <= 0 || F < 1 || k0p % 16 != 0 || k0p > kMaxK0 || 6 * F + 3 > k0p ||
      hp % 16 != 0 || hp > kMaxHidden || n_hidden < 1 || out_dim < 1 ||
      out_dim > op || op % 8 != 0 || op > kMaxOut)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16) {
    const size_t smem = f32_smem_bytes();
    err = cudaFuncSetAttribute(pe_mlp_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    pe_mlp_f32_kernel<<<(n + kF32Rows - 1) / kF32Rows, kThreads, smem, st>>>(
        x, static_cast<const float*>(w), bias, freqs, out, s);
    return int(cudaGetLastError());
  }
  void (*kernel)(const float*, const __nv_bfloat16*, const float*,
                 const float*, float*, PeMlpShape);
  switch (hp) {
    case 16: kernel = pe_mlp_bf16_kernel<16>; break;
    case 32: kernel = pe_mlp_bf16_kernel<32>; break;
    case 64: kernel = pe_mlp_bf16_kernel<64>; break;
    case 128: kernel = pe_mlp_bf16_kernel<128>; break;
    case 256: kernel = pe_mlp_bf16_kernel<256>; break;
    default: return int(cudaErrorInvalidValue);
  }
  const size_t smem = bf16_smem_bytes(hp, k0p, op);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<(n + kTileRows - 1) / kTileRows, kThreads, smem, st>>>(
      x, static_cast<const __nv_bfloat16*>(w), bias, freqs, out, s);
  return int(cudaGetLastError());
}

}  // extern "C"
