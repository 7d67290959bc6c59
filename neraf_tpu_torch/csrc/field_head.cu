// The main field's colour branch as one kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package (neraf_tpu/fields/nerfacto.py,
// NerfactoField.rgb_from_features) leaves this chain to XLA, which fuses
// it; eager PyTorch runs it as ~70 launches a render chunk
// (ops/field_head.py::field_head_plain: ~35 for the SH encoding, the
// stack, the cat, the casts, four GEMMs with their bias adds and ReLUs,
// the sigmoid). For rows r = 0 .. n-1 it computes
//   d   = dirs[r / S]        (S rows a direction: 48 in a render chunk)
//   sh  = SH4(((d + 1) / 2) * 2 - 1), f32, every product and sum rounded
//         on its own as the plain chain's elementwise ops round them, so
//         x0 is the plain chain's bit for bit
//   x0  = bf16([sh (16) | geo[r] (G) | emb (E) | 0 ...]), emb the row of
//         the direction's camera in the (C, E) table, or its only row
//   h   = relu(W_i h + b_i) over the hidden layers,
//   rgb = sigmoid(W_o h + b_o), written as bf16 (n, out_dim).
// A layer rounds where the plain chain's dense does: its f32 product to
// bf16, its bias to bf16, their f32 sum to bf16; the ReLU and the sigmoid
// follow in f32. So the kernel differs from the plain chain only by the
// order of the products' f32 sums, which flips a bf16 rounding in a few
// rows. (Rounding once, after an f32 bias, lies nearer the f32 chain but
// up to two bf16 steps off the plain chain at the tiny head: PERF.md.)
//
// Design: pe_mlp_common.cuh's row-tile engine, as the PE+MLP forward
// (pe_mlp.cu) runs it: persistent blocks, one an SM, of two consumer
// warpgroups of 64 rows and a producer warp. The head's weights (24.5 KiB
// in bf16 at width 64, in tile_layers' wgmma layout) arrive once per block
// by bulk copies and stay; the biases are read as f32. Each thread forms
// its own entries of the layer-0 A fragments in registers: the SH terms
// from its row's direction, the geo features read in place from the base
// output's (n, 1 + G) bf16 rows (geo_stride apart), the appearance row
// through the read-only cache. Every layer is wgmma m64nNk16 with A in
// registers and f32 accumulation; its accumulator, after the bias and the
// ReLU, is the next layer's A fragment (head_hidden: the engine's
// forward_hidden with the plain chain's rounding in the epilogue). The
// next tile's fragments are formed while the last hidden layer is in the
// products. No activation reaches shared or device memory; the output
// layer (3 columns padded to 16) masks its stores to the ragged row count.
//
// What bounds it on the H100: the products, 2 (64 64 + 64 64 + 64 64 +
// 16 64) = 26.6 kFLOP a row at width 64 (the padded head), 41.9 GFLOP a
// render chunk of 1,572,864 rows: 0.042 ms at 989 TFLOP/s. Device memory
// sees 34 B of base output and 6 B of rgb a row and 12 B a direction
// (63 MB a chunk, 0.019 ms at 3.35 TB/s). Beside the products run the
// SH terms, the fragment loads and the four epilogues on the CUDA cores.

#include "pe_mlp_common.cuh"

namespace {

constexpr int kHeadOut = 16;  // output columns of the one wgmma (<= 16 used)

struct HeadShape {
  int n;           // rows
  int S;           // rows a direction
  int G;           // geo features
  int geo_stride;  // elements between two rows of geo
  int E;           // appearance width
  int k0p;         // layer-0 input width, padded
  int n_hidden;    // ReLU layers, >= 1
  int out_dim;     // outputs, <= kHeadOut
};

// The 16 degree-4 SH terms of a direction, as ops/encodings.py::sh_encoding
// computes them on (d + 1) / 2 in float32 (PyTorch divides by a scalar 2
// as a product with 0.5; every op rounded alone, no FMA).
__device__ __forceinline__ void sh4(float (&o)[16], float dx, float dy,
                                    float dz) {
  auto remap = [](float d) {
    return __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(d, 1.0f), 0.5f), 2.0f), 1.0f);
  };
  const float x = remap(dx), y = remap(dy), z = remap(dz);
  const float x2 = __fmul_rn(x, x), y2 = __fmul_rn(y, y), z2 = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), yz = __fmul_rn(y, z), xz = __fmul_rn(x, z);
  const float one_5z2 = __fsub_rn(1.0f, __fmul_rn(5.0f, z2));
  o[0] = 0.28209479177387814f;
  o[1] = __fmul_rn(-0.48860251190291987f, y);
  o[2] = __fmul_rn(0.48860251190291987f, z);
  o[3] = __fmul_rn(-0.48860251190291987f, x);
  o[4] = __fmul_rn(1.0925484305920792f, xy);
  o[5] = __fmul_rn(-1.0925484305920792f, yz);
  o[6] = __fsub_rn(__fmul_rn(0.94617469575755997f, z2), 0.31539156525251999f);
  o[7] = __fmul_rn(-1.0925484305920792f, xz);
  o[8] = __fsub_rn(__fmul_rn(0.54627421529603959f, x2),
                   __fmul_rn(0.54627421529603959f, y2));
  o[9] = __fmul_rn(__fmul_rn(0.59004358992664352f, y),
                   __fadd_rn(__fmul_rn(-3.0f, x2), y2));
  o[10] = __fmul_rn(__fmul_rn(2.8906114426405538f, xy), z);
  o[11] = __fmul_rn(__fmul_rn(0.45704579946446572f, y), one_5z2);
  o[12] = __fmul_rn(__fmul_rn(0.3731763325901154f, z),
                    __fsub_rn(__fmul_rn(5.0f, z2), 3.0f));
  o[13] = __fmul_rn(__fmul_rn(0.45704579946446572f, x), one_5z2);
  o[14] = __fmul_rn(__fmul_rn(1.4453057213202769f, z), __fsub_rn(x2, y2));
  o[15] = __fmul_rn(__fmul_rn(0.59004358992664352f, x),
                    __fadd_rn(-x2, __fmul_rn(3.0f, y2)));
}

// Layer 0's A fragments of a warp's 16 rows (row0 + g, + 8): the k16 tiles
// of x0, this thread's columns 8 i + 2 q and + 1 of each. Rows past n read
// nothing (their outputs are not stored).
__device__ __forceinline__ void head_frags(uint32_t (&a0)[kMaxK0 / 16][4],
                                           const float* __restrict__ dirs,
                                           const unsigned short* __restrict__ geo,
                                           const float* __restrict__ emb,
                                           const long long* __restrict__ cam,
                                           const HeadShape& s, int row0,
                                           int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    const bool live = r < s.n;
    const int dr = live ? r / s.S : 0;
    float sh[16];
    sh4(sh, live ? __ldg(dirs + size_t(dr) * 3) : 0.0f,
        live ? __ldg(dirs + size_t(dr) * 3 + 1) : 0.0f,
        live ? __ldg(dirs + size_t(dr) * 3 + 2) : 0.0f);
    const unsigned short* gr = geo + size_t(live ? r : 0) * s.geo_stride;
    const float* er = emb + (cam != nullptr && live ? size_t(__ldg(cam + dr)) * s.E : 0);
#pragma unroll
    for (int i = 0; i < kMaxK0 / 8; ++i) {
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * i + 2 * q + j;
        float x = 0.0f;
        if (i < 2) {  // SH term c (k0p > 16 always)
          x = q == 0 ? sh[8 * i + j]
              : q == 1 ? sh[8 * i + 2 + j]
              : q == 2 ? sh[8 * i + 4 + j]
                       : sh[8 * i + 6 + j];
        } else if (live && c < 16 + s.G) {
          x = __bfloat162float(__ushort_as_bfloat16(__ldg(gr + (c - 16))));
        } else if (live && c < 16 + s.G + s.E) {
          x = __ldg(er + (c - 16 - s.G));
        }
        v[j] = x;
      }
      a0[i >> 1][(i & 1) * 2 + h] = pack_bf16x2(v[0], v[1]);
    }
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ops/pe_mlp.py::dense's rounding of one output: bf16(bf16(acc) + bf16(b)).
__device__ __forceinline__ float dense_out(float acc, float b) {
  return bf16_round(bf16_round(acc) + bf16_round(b));
}

// A hidden layer's epilogue: acc (NC columns starting at column c0 of the
// layer) through dense_out and the ReLU, packed into the A fragments of
// k16 tiles c0 / 16 .. of `o` (pe_mlp_common.cuh's relu_pack, rounded as
// the plain chain rounds).
template <int NC, int KT>
__device__ __forceinline__ void dense_relu_pack(const float (&acc)[NC / 2],
                                                uint32_t (&o)[KT][4], int c0,
                                                const float* __restrict__ bias,
                                                int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = c0 + j * 8 + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
    const int t = c0 / 16 + j / 2, e = (j & 1) * 2;
    o[t][e] = pack_bf16x2(fmaxf(dense_out(acc[4 * j], b0), 0.0f),
                          fmaxf(dense_out(acc[4 * j + 1], b1), 0.0f));
    o[t][e + 1] = pack_bf16x2(fmaxf(dense_out(acc[4 * j + 2], b0), 0.0f),
                              fmaxf(dense_out(acc[4 * j + 3], b1), 0.0f));
  }
}

// The hidden layers for a warp's rows, as forward_hidden runs them, with
// dense_relu_pack's epilogue; `during` runs while the last hidden chunk is
// in the products (the next row tile's fragments).
template <int HP, class During>
__device__ __forceinline__ void head_hidden(uint32_t (&act)[HP / 16][4],
                                            const uint32_t (&a0)[kMaxK0 / 16][4],
                                            Ring& ring, const Chunks& ch,
                                            const float* __restrict__ bias,
                                            int L, int lane, During during) {
  constexpr int NC = HP < 128 ? HP : 128;
  constexpr int CPL = HP / NC;
  auto last = [&](bool yes) {
    return [&during, yes] {
      if (yes) during();
    };
  };
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const unsigned char* w = ring.acquire(ch, 0, c);
    float acc[NC / 2];
    chunk_fwd<NC, kMaxK0 / 16>(acc, a0, w, ch.k0p / 16,
                               last(L == 1 && c == CPL - 1));
    ring.release(1, lane);
    dense_relu_pack<NC, HP / 16>(acc, act, c * NC, bias, lane);
  }
  for (int l = 1; l < L; ++l) {
    uint32_t nxt[HP / 16][4];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const unsigned char* w = ring.acquire(ch, l, c);
      float acc[NC / 2];
      chunk_fwd<NC, HP / 16>(acc, act, w, HP / 16,
                             last(l == L - 1 && c == CPL - 1));
      ring.release(1, lane);
      dense_relu_pack<NC, HP / 16>(acc, nxt, c * NC, bias + l * HP, lane);
    }
#pragma unroll
    for (int kt = 0; kt < HP / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) act[kt][e] = nxt[kt][e];
  }
}

// The output layer for a warp's rows: kHeadOut columns of the one output
// chunk through dense_out, then the sigmoid in f32, stored as bf16
// (n x out_dim).
template <int HP>
__device__ __forceinline__ void rgb_layer(const uint32_t (&act)[HP / 16][4],
                                          const unsigned char* w,
                                          const float* __restrict__ bias,
                                          __nv_bfloat16* __restrict__ out,
                                          int row0, const HeadShape& s,
                                          int lane) {
  const int g = lane >> 2, q = lane & 3;
  float acc[kHeadOut / 2];
  chunk_fwd<kHeadOut, HP / 16>(acc, act, w, HP / 16);
#pragma unroll
  for (int j = 0; j < kHeadOut / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * q + (e & 1), r = row0 + g + 8 * (e >> 1);
      if (col < s.out_dim && r < s.n) {
        const float pre = dense_out(acc[4 * j + e], __ldg(bias + col));
        out[size_t(r) * s.out_dim + col] =
            __float2bfloat16_rn(1.0f / (1.0f + expf(-pre)));
      }
    }
}

template <int HP>
__global__ void __launch_bounds__(kWgThreads, 1)
    field_head_kernel(const float* __restrict__ dirs,
                      const unsigned short* __restrict__ geo,
                      const float* __restrict__ emb,
                      const long long* __restrict__ cam,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, HeadShape s) {
  constexpr int NC = HP < 128 ? HP : 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = s.n_hidden;
  const Chunks ch{HP, s.k0p, kHeadOut, L, NC};
  const uint32_t stage_bytes = ring_stage_bytes(HP, s.k0p, kHeadOut);
  const int stages = ring_stages(HP, s.k0p, kHeadOut, L);
  const bool resident = ring_resident(HP, s.k0p, kHeadOut, L);
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
  uint32_t a0[kMaxK0 / 16][4];
  if (blockIdx.x < tiles)
    head_frags(a0, dirs, geo, emb, cam, s, blockIdx.x * kBlockRows + sub, lane);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * kBlockRows + sub;
    const int tn = t + gridDim.x;
    uint32_t a0n[kMaxK0 / 16][4];
    uint32_t act[HP / 16][4];
    head_hidden<HP>(act, a0, ring, ch, bias, L, lane, [&] {
      if (tn < tiles)
        head_frags(a0n, dirs, geo, emb, cam, s, tn * kBlockRows + sub, lane);
    });
#pragma unroll
    for (int kt = 0; kt < kMaxK0 / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a0[kt][e] = a0n[kt][e];
    const unsigned char* wo = ring.acquire(ch, L, 0);
    rgb_layer<HP>(act, wo, bias_out, out, row0, s, lane);
    ring.release(1, lane);
  }
}

}  // namespace

extern "C" {

// Launches the colour branch on `stream` on `blocks` persistent blocks:
// dirs (n / S rounded up, 3) f32, geo bf16 rows geo_stride apart, emb
// (C, E) f32 with cam (n / S rounded up) int64 camera rows, or cam null and
// emb one row; w in tile_layers' layout of pack_head's weights (bf16), bias
// pack_head's f32 biases; out (n, out_dim) bf16. Returns the cudaError_t
// of the launch.
int neraf_field_head_launch(const float* dirs, const void* geo,
                            const float* emb, const long long* cam,
                            const void* w, const float* bias, void* out, int n,
                            int S, int G, int geo_stride, int E, int k0p,
                            int hp, int n_hidden, int out_dim, int blocks,
                            void* stream) {
  const HeadShape s{n, S, G, geo_stride, E, k0p, n_hidden, out_dim};
  if (n <= 0 || S < 1 || G < 1 || E < 0 || geo_stride < G ||
      16 + G + E > k0p || k0p % 16 != 0 || k0p > kMaxK0 || n_hidden < 1 ||
      out_dim < 1 || out_dim > kHeadOut || blocks < 1)
    return int(cudaErrorInvalidValue);
  void (*kernel)(const float*, const unsigned short*, const float*,
                 const long long*, const __nv_bfloat16*, const float*,
                 __nv_bfloat16*, HeadShape);
  switch (hp) {
    case 16: kernel = field_head_kernel<16>; break;
    case 32: kernel = field_head_kernel<32>; break;
    case 64: kernel = field_head_kernel<64>; break;
    case 128: kernel = field_head_kernel<128>; break;
    case 256: kernel = field_head_kernel<256>; break;
    default: return int(cudaErrorInvalidValue);
  }
  const size_t smem = ring_smem_bytes(hp, k0p, kHeadOut, n_hidden);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<blocks, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dirs, static_cast<const unsigned short*>(geo), emb, cam,
      static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), s);
  return int(cudaGetLastError());
}

}  // extern "C"
