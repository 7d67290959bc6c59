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
// The bf16 kernel reads them in tile_layers' wgmma layout.
//
// bf16 kernel (pe_mlp_common.cuh's row-tile engine): persistent blocks of
// two consumer warpgroups (64 rows each, 128 a tile) and a producer warp,
// one block an SM, walking the row tiles:
//  - each thread forms its own entries of the layer-0 A fragments (two
//    rows, pairs of adjacent columns) straight in registers: the encoding
//    never touches memory;
//  - every layer is wgmma m64nNk16 with A (the activations) in registers
//    and B (the weights) in shared memory, f32 accumulation; the bias add
//    and ReLU are f32, then the accumulator is the next layer's A fragment
//    (no hidden activation reaches shared or device memory);
//  - the weights arrive by cp.async.bulk in the wgmma layout: the
//    proposals' 47 KiB once per block, for every tile it walks; the main
//    field's 424 KiB (its 256 x 256 layers as two 64 KiB chunks) through a
//    three-stage ring, the next chunk in flight while the current one is in
//    the products;
//  - the output layer writes (N, O) f32, masked to the ragged row count.
// Angles are range-reduced as in the Pallas kernel: t = f x in turns is
// split exactly into t_hi + t_lo (the f32 product and its FMA residual) and
// reduced to r = (t_hi - rint(t_hi)) + t_lo in [-1/2, 1/2] before
// sincospi(2r). At 2^8 turns an unreduced fast sine is wrong, and even the
// f32 rounding of t alone costs ~1e-4 rad.
//
// What bounds it on the H100: the bf16 products (a warpgroup reads each
// weight once per 64 rows from shared memory, at wgmma's own rate), with
// the encoding's sincospi and the epilogues on the CUDA cores beside them;
// at HP 256 also the L2 -> shared traffic of the streamed weights (424 KiB
// a 128-row tile: 5.3 GB at a render chunk's 1,572,864 rows), overlapped
// with the products by the ring. Device memory sees only x (12 B/row) and
// the output (4 O B/row).
//
// The f32 kernel (CUDA-core FMA, no TF32) is the same function for checks
// in f32: 64 rows per block, activations in shared memory, weights staged
// in 32-deep K slices.

#include "pe_mlp_common.cuh"

namespace {

// The linear output layer for a warp's rows: N = opk columns of the single
// output chunk, written as f32 to out (n x out_dim).
template <int HP, int N>
__device__ __forceinline__ void out_layer(const uint32_t (&act)[HP / 16][4],
                                          const unsigned char* w,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int row0,
                                          const PeMlpShape& s, int lane) {
  const int g = lane >> 2, q = lane & 3;
  float acc[N / 2];
  chunk_fwd<N, HP / 16>(acc, act, w, HP / 16);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * q + (e & 1), r = row0 + g + 8 * (e >> 1);
      if (col < s.out_dim && r < s.n)
        out[size_t(r) * s.out_dim + col] = acc[4 * j + e] + __ldg(bias + col);
    }
}

template <int HP>
__global__ void __launch_bounds__(kWgThreads, 1)
    pe_mlp_bf16_kernel(const float* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ freqs,
                       float* __restrict__ out, PeMlpShape s) {
  constexpr int NC = HP < 128 ? HP : 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int opk = ceil_to(s.op, 16), L = s.n_hidden;
  const Chunks ch{HP, s.k0p, opk, L, NC};
  const uint32_t stage_bytes = ring_stage_bytes(HP, s.k0p, opk);
  const int stages = ring_stages(HP, s.k0p, opk, L);
  const bool resident = ring_resident(HP, s.k0p, opk, L);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + size_t(stages) * stage_bytes);
  uint64_t* empty = full + kMaxStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (s.n + kBlockRows - 1) / kBlockRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    regs_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      Feeder f{smem, full, empty, stage_bytes, stages, 0, w};
      if (resident) {
        f.put_all(ch);
      } else {
        for (int t = blockIdx.x; t < tiles; t += gridDim.x)
          for (int l = 0; l <= L; ++l) f.put_layer(ch, l);
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  Ring ring{smem, full, empty, stage_bytes, stages, resident, 0};
  const float* bias_out = bias + size_t(L) * HP;
  const int sub = (warp >> 2) * kWgRows + (warp & 3) * 16;
  // each tile's encoding is formed while the previous tile's last hidden
  // layer is in the products
  const EncPairs enc = enc_pairs(freqs, s, lane);
  uint32_t a0[kMaxK0 / 16][4];
  if (blockIdx.x < tiles)
    encode_frags(a0, x, enc, s, blockIdx.x * kBlockRows + sub, lane);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * kBlockRows + sub;
    const int tn = t + gridDim.x;
    uint32_t a0n[kMaxK0 / 16][4];
    uint32_t act[HP / 16][4];
    forward_hidden<HP>(act, a0, ring, ch, bias, L, lane,
                       [](int, const uint32_t (&)[HP / 16][4]) {}, [&] {
                         if (tn < tiles)
                           encode_frags(a0n, x, enc, s, tn * kBlockRows + sub,
                                        lane);
                       });
#pragma unroll
    for (int kt = 0; kt < kMaxK0 / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a0[kt][e] = a0n[kt][e];
    const unsigned char* wo = ring.acquire(ch, L, 0);
    if (opk == 16)
      out_layer<HP, 16>(act, wo, bias_out, out, row0, s, lane);
    else
      out_layer<HP, 32>(act, wo, bias_out, out, row0, s, lane);
    ring.release(1, lane);
  }
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

// Launches the fused PE+MLP forward on `stream` (bf16 != 0: the bf16 wgmma
// kernel on `blocks` persistent blocks, the weights in tile_layers' layout;
// else the f32 kernel on pack_layers' f32 weights); returns the
// cudaError_t of the launch. Shapes are those of pack_layers.
int neraf_pe_mlp_launch(const float* x, const void* w, const float* bias,
                        const float* freqs, float* out, int n, int F, int k0p,
                        int hp, int n_hidden, int out_dim, int op, int blocks,
                        int bf16, void* stream) {
  const PeMlpShape s{n, F, k0p, hp, n_hidden, out_dim, op};
  if (n <= 0 || F < 1 || k0p % 16 != 0 || k0p > kMaxK0 || 6 * F + 3 > k0p ||
      hp % 16 != 0 || hp > kMaxHidden || n_hidden < 1 || out_dim < 1 ||
      out_dim > op || op % 8 != 0 || op > kMaxOut || blocks < 1)
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
  const size_t smem = ring_smem_bytes(hp, k0p, ceil_to(op, 16), n_hidden);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, kWgThreads, smem, st>>>(
      x, static_cast<const __nv_bfloat16*>(w), bias, freqs, out, s);
  return int(cudaGetLastError());
}

}  // extern "C"
