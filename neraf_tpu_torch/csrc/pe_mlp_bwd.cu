// Fused fourier positional encoding + ReLU MLP backward for Hopper (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp, backward (_bwd_call,
// kernel _make_bwd_kernel). For rows x in [0,1]^3 and the output cotangent g
// (N, O) f32 it returns dx (N, 3) f32 and every layer's dW, db in f32, in
// the packed layout of pack_layers (ops/pe_mlp.py), with the Pallas kernel's
// rounding: every product in bf16 with f32 accumulation, dW from the bf16
// cotangents (g, then each masked dpre), db from the f32 ones, the ReLU masks
// and the angle gradient in f32.
//
// Why not as on the TPU: the Pallas kernel runs its row tiles in order on
// one core and adds every tile's dW into accumulators that stay in VMEM. On
// the H100 blocks run in parallel and in no order, and the main field's dW
// (216,832 f32, 847 KiB; one 256 x 256 layer alone is 256 KiB) does not fit
// a block's 227 KB of shared memory. So the backward is three launches:
//  1. pe_mlp_bwd_{bf16,f32}_kernel, one block per row tile (as the forward
//     kernel: 16 rows per warp, activations in mma fragments, one layer's
//     weights at a time in shared memory): recomputes the forward, writes
//     each hidden layer's h to scratch (bf16), walks back through the layers
//     (dh = W^T dpre reads the staged layer transposed with ldmatrix.trans;
//     the f32 accumulators of two n8 tiles are again the bf16 A fragment of
//     the next k16 tile), writes each layer's masked dpre (f32) to scratch,
//     and forms dx from layer 0's input gradient and the recomputed sin/cos
//     (dang = dsin cos - dcos sin, dx = 2 pi f dang + dx_direct; the rint()
//     of the range reduction is piecewise constant);
//  2. pe_mlp_dw_kernel, once per layer: dW = dpre^T h_below as a split-K
//     product over the rows, a 64 x 64 tile of dW per block and one slice of
//     the rows per blockIdx.z, bf16 mma.sync with f32 accumulation; layer 0's
//     input (the encoding) is recomputed from x, not stored; db is summed
//     from the f32 dpre as it is loaded. Each block writes its partial tile
//     to its own slice of a scratch buffer;
//  3. pe_mlp_reduce_kernel sums the slices in a fixed order: dW and db are
//     deterministic (no atomics).
// The mask is h > 0 on the stored bf16 h: bf16 keeps f32's exponent range,
// so this is the Pallas kernel's pre > 0 unless 0 < pre < 2^-133.
//
// Scratch (allocated by the wrapper): h, n_hidden x N x HP bf16, and dpre,
// n_hidden x N x HP f32. At the proposal-0 training shape (1,048,576 rows,
// HP 128, 2 hidden layers) that is 537 MB of h and 1.07 GB of dpre; at the
// main field's (196,608 rows, HP 256, 4 layers) 403 MB and 805 MB; plus the
// dW slices, 257 x (all packed weights) f32 at most (223 MB for the main
// field).
//
// What bounds it on the H100: the tensor cores fed by mma.sync and
// shared-memory reads of the weights in launch 1 (as the forward), and
// device memory in launch 2: every dW tile re-reads its rows' dpre and h, HP
// / 64 times over, and the f32 dpre round trip through device memory is the
// largest traffic of the backward. Keeping dpre in bf16 with per-block db
// partials, larger dW tiles, wgmma and TMA are left for later.
//
// The f32 instantiation (CUDA-core FMA, no TF32) is the same function for
// checks in f32: 64 rows per block with activations in shared memory, h
// stored in f32, and an FMA dW tile.

#include "pe_mlp_common.cuh"

namespace {

constexpr int kDwTile = 64;      // dW tile: 64 output units x 64 input units
constexpr int kDwRows = 32;      // rows per step of the split-K loop
constexpr int kDwThreads = 128;  // 4 warps, each a 32 x 32 quarter of the tile
constexpr int kDwLd = kDwTile + 8;   // bf16 shared row stride (conflict-free)
constexpr int kDwLdF = kDwTile + 4;  // f32 shared row stride
constexpr float kTwoPi = 6.283185307179586f;

__host__ __device__ inline int ceil_to(int n, int m) { return (n + m - 1) / m * m; }

// A warp's activations (A fragments of KT k16 tiles) -> rows row0 .. row0+15
// of h (n x hp, bf16).
template <int KT>
__device__ __forceinline__ void store_act(const uint32_t (&a)[KT][4],
                                          __nv_bfloat16* h, int hp, int row0,
                                          int n, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = kt * 16 + half * 8 + 2 * q;
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(h + size_t(r0) * hp + col) = a[kt][half * 2];
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(h + size_t(r1) * hp + col) = a[kt][half * 2 + 1];
    }
}

__device__ __forceinline__ bool positive(const __nv_bfloat16* h, size_t i,
                                         int j) {
  return __bfloat162float(h[i + j]) > 0.0f;
}

// One backward layer for a warp's 16 rows: dh = a . W, where `a` holds the
// layer above's cotangent as A fragments of KT k16 tiles over W's rows (only
// the first kt_used are read) and W is staged row-major [K][N] at stride ldw.
// dpre = dh masked by h > 0 (h: this layer's activations, rows at stride
// hp) is written to dp (f32, rows at stride hp) and returned as bf16 A
// fragments in o (OUT_KT k16 tiles, N = 16 OUT_KT).
template <int KT, int OUT_KT>
__device__ __forceinline__ void back_layer(const uint32_t (&a)[KT][4],
                                           uint32_t (&o)[OUT_KT][4],
                                           const __nv_bfloat16* ws, int ldw,
                                           int kt_used,
                                           const __nv_bfloat16* h,
                                           float* __restrict__ dp, int hp,
                                           int row0, int n, int lane) {
  constexpr int kChunk = OUT_KT < 4 ? OUT_KT : 4;  // 64 columns per pass
  const int g = lane >> 2, q = lane & 3;
  // ldmatrix.x4.trans rows: matrices (n tile 0, k 0-7), (0, 8-15), (1, 0-7),
  // (1, 8-15), each from 8 rows k of W at 8 consecutive columns n
  const int krow = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int ncol = (lane >> 4) << 3;
  const int r0 = row0 + g, r1 = r0 + 8;
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
          ldmatrix_x4_trans(b, ws + (kt * 16 + krow) * ldw + (c0 + jp) * 16 + ncol);
          mma_bf16(acc[2 * jp], a[kt], b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a[kt], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kChunk; ++j) {
      const int col = c0 * 16 + j * 8 + 2 * q;
      float v[4];
      const size_t i0 = size_t(r0) * hp + col, i1 = size_t(r1) * hp + col;
      v[0] = r0 < n && positive(h, i0, 0) ? acc[j][0] : 0.0f;
      v[1] = r0 < n && positive(h, i0, 1) ? acc[j][1] : 0.0f;
      v[2] = r1 < n && positive(h, i1, 0) ? acc[j][2] : 0.0f;
      v[3] = r1 < n && positive(h, i1, 1) ? acc[j][3] : 0.0f;
      if (r0 < n) *reinterpret_cast<float2*>(dp + i0) = make_float2(v[0], v[1]);
      if (r1 < n) *reinterpret_cast<float2*>(dp + i1) = make_float2(v[2], v[3]);
      o[c0 + j / 2][(j & 1) * 2] = pack_bf16x2(v[0], v[1]);
      o[c0 + j / 2][(j & 1) * 2 + 1] = pack_bf16x2(v[2], v[3]);
    }
  }
}

// The input gradient of a row's encoding pair p (interleaved layout:
// (sin, cos) of 2 pi f x_d for p = d F + k < 3F, then (x0, x1), (x2, 0))
// from the pair's cotangents (ds, dc), added into d[3].
__device__ __forceinline__ void pair_input_grad(int p, float ds, float dc,
                                                float x0, float x1, float x2,
                                                const float* __restrict__ freqs,
                                                int F, float (&d)[3]) {
  if (p < 3 * F) {
    const int dd = p / F;
    const float xd = dd == 0 ? x0 : (dd == 1 ? x1 : x2);
    const float f = __ldg(freqs + (p - dd * F));
    const float t_hi = __fmul_rn(f, xd);
    const float t_lo = fmaf(f, xd, -t_hi);
    const float r = (t_hi - rintf(t_hi)) + t_lo;
    float s, c;
    sincospif(2.0f * r, &s, &c);
    const float g = (kTwoPi * f) * (ds * c - dc * s);
    if (dd == 0) d[0] += g;
    else if (dd == 1) d[1] += g;
    else d[2] += g;
  } else if (p == 3 * F) {
    d[0] += ds;
    d[1] += dc;
  } else if (p == 3 * F + 1) {
    d[2] += ds;
  }
}

// Layer 0 of the backward for a warp's 16 rows: the encoding's cotangent
// d_enc = a . W0 (W0 staged [HP][k0p] at stride ldw), then dx.
template <int KT>
__device__ __forceinline__ void input_grad(const uint32_t (&a)[KT][4],
                                           const __nv_bfloat16* ws, int ldw,
                                           const float* __restrict__ x,
                                           const float* __restrict__ freqs,
                                           float* __restrict__ dx,
                                           const PeMlpShape& s, int row0,
                                           int lane) {
  constexpr int NT = kMaxK0 / 8;
  const int g = lane >> 2, q = lane & 3;
  const int krow = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int ncol = (lane >> 4) << 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (jp * 16 < s.k0p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (kt * 16 + krow) * ldw + jp * 16 + ncol);
        mma_bf16(acc[2 * jp], a[kt], b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a[kt], b[2], b[3]);
      }
    }
  // n tile nt holds columns nt*8 + 2q, +1: the (sin, cos) pair p = 4 nt + q
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    float xr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) xr[c] = r < s.n ? __ldg(x + size_t(r) * 3 + c) : 0.0f;
    float d[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      if (nt * 8 < s.k0p)
        pair_input_grad(4 * nt + q, acc[nt][2 * h], acc[nt][2 * h + 1], xr[0],
                        xr[1], xr[2], freqs, s.F, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d[c] += __shfl_xor_sync(0xffffffffu, d[c], 1);
      d[c] += __shfl_xor_sync(0xffffffffu, d[c], 2);
    }
    if (q == 0 && r < s.n)
#pragma unroll
      for (int c = 0; c < 3; ++c) dx[size_t(r) * 3 + c] = d[c];
  }
}

template <int HP>
__global__ void __launch_bounds__(kThreads, (HP > 128 ? 1 : 2))
    pe_mlp_bwd_bf16_kernel(const float* __restrict__ x,
                           const float* __restrict__ gout,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ freqs,
                           __nv_bfloat16* __restrict__ hbuf,
                           float* __restrict__ dpbuf, float* __restrict__ dx,
                           PeMlpShape s) {
  constexpr int KT = HP / 16;
  constexpr int KT0 = kMaxK0 / 16;
  constexpr int KTO = kMaxOut / 16;
  const int opk = ceil_to(s.op, 16);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bs = reinterpret_cast<float*>(smem + bf16_weight_bytes(HP, s.k0p, opk));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * kTileRows + warp * 16;
  const size_t plane = size_t(s.n) * HP;

  // ---- the forward again (as pe_mlp_bf16_kernel), keeping every h
  stage_layer(ws, bs, w, bias, HP, s.k0p);
  uint32_t a0[KT0][4];
  {
    float xr[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
#pragma unroll
      for (int d = 0; d < 3; ++d) xr[h][d] = r < s.n ? __ldg(x + size_t(r) * 3 + d) : 0.0f;
    }
#pragma unroll
    for (int kt = 0; kt < KT0; ++kt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 e = encode_pair(kt * 8 + half * 4 + q, xr[h][0],
                                       xr[h][1], xr[h][2], freqs, s.F);
          a0[kt][half * 2 + h] = pack_bf16x2(e.x, e.y);
        }
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t act[KT][4];
  relu_layer<KT0, KT>(a0, act, ws, s.k0p + kSkew, bs, s.k0p / 16, lane);
  store_act<KT>(act, hbuf, HP, row0, s.n, lane);
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
    store_act<KT>(act, hbuf + l * plane, HP, row0, s.n, lane);
    wl += size_t(HP) * HP;
    bl += HP;
  }

  // ---- the output layer: dh = g W_out, its K (op rows) padded to 16
  __syncthreads();
  stage_layer(ws, bs, wl, bl, s.op, HP);
  for (int i = threadIdx.x; i < (opk - s.op) * (HP + kSkew); i += blockDim.x)
    ws[s.op * (HP + kSkew) + i] = __float2bfloat16(0.0f);
  uint32_t ga[KTO][4];
#pragma unroll
  for (int kt = 0; kt < KTO; ++kt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + g + 8 * h;
        const int c = kt * 16 + half * 8 + 2 * q;
        const float* gr = gout + size_t(r) * s.out_dim;
        const float v0 = r < s.n && c < s.out_dim ? __ldg(gr + c) : 0.0f;
        const float v1 = r < s.n && c + 1 < s.out_dim ? __ldg(gr + c + 1) : 0.0f;
        ga[kt][half * 2 + h] = pack_bf16x2(v0, v1);
      }
  cp_async_wait_all();
  __syncthreads();
  uint32_t da[KT][4];
  back_layer<KTO, KT>(ga, da, ws, HP + kSkew, opk / 16,
                      hbuf + (s.n_hidden - 1) * plane,
                      dpbuf + (s.n_hidden - 1) * plane, HP, row0, s.n, lane);

  // ---- hidden layers, top down: dh_{l-1} = dpre_l W_l
  for (int l = s.n_hidden - 1; l >= 1; --l) {
    wl -= size_t(HP) * HP;
    bl -= HP;
    __syncthreads();
    stage_layer(ws, bs, wl, bl, HP, HP);
    cp_async_wait_all();
    __syncthreads();
    uint32_t nxt[KT][4];
    back_layer<KT, KT>(da, nxt, ws, HP + kSkew, KT, hbuf + (l - 1) * plane,
                       dpbuf + (l - 1) * plane, HP, row0, s.n, lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) da[kt][e] = nxt[kt][e];
  }

  // ---- layer 0 against the encoding: dx
  if (dx != nullptr) {
    __syncthreads();
    stage_layer(ws, bs, w, bias, HP, s.k0p);
    cp_async_wait_all();
    __syncthreads();
    input_grad<KT>(da, ws, s.k0p + kSkew, x, freqs, dx, s, row0, lane);
  }
}

// acc[i][j] += sum_k act[ty*8 + i][k] * W(k, tx + 32 j) over k < K and
// columns < nout, for the f32 kernel's 64-row tile (activations in shared
// memory at stride kF32Ld). trans = false: W is (nout x K) row-major, the
// forward's W(k, c) = W[c][k]; trans = true: W is (K x nout) row-major, the
// backward's W(k, c) = W[k][c]. W is staged through wt in 32-deep K slices.
__device__ void f32_tile_gemm(float (&acc)[8][8], const float* act,
                              const float* __restrict__ w, int K, int nout,
                              bool trans, float* wt) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kF32K) {
    const int kn = K - k0 < kF32K ? K - k0 : kF32K;
    for (int i = tid; i < nout * kF32K; i += blockDim.x) {
      if (trans) {
        const int kk = i / nout, c = i - kk * nout;
        if (kk < kn) wt[kk * kF32Ld + c] = __ldg(w + size_t(k0 + kk) * nout + c);
      } else {
        const int c = i / kF32K, kk = i - c * kF32K;
        if (kk < kn) wt[kk * kF32Ld + c] = __ldg(w + size_t(c) * K + k0 + kk);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = act[(ty * 8 + i) * kF32Ld + k0 + kk];
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
}

__global__ void __launch_bounds__(kThreads)
    pe_mlp_bwd_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ gout,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ freqs,
                          float* __restrict__ hbuf, float* __restrict__ dpbuf,
                          float* __restrict__ dx, PeMlpShape s) {
  extern __shared__ float fsm[];
  float* act_in = fsm;
  float* act_out = fsm + kF32Rows * kF32Ld;
  float* wt = fsm + 2 * kF32Rows * kF32Ld;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * kF32Rows;
  const size_t plane = size_t(s.n) * s.hp;
  const int L = s.n_hidden;
  auto layer_w = [&](int l) {  // W_l; l == L is the output layer
    return l == 0 ? w : w + size_t(s.hp) * s.k0p + size_t(l - 1) * s.hp * s.hp;
  };

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

  float acc[8][8];
  // ---- the forward again, keeping every h
  for (int l = 0; l < L; ++l) {
    f32_tile_gemm(acc, act_in, layer_w(l), l == 0 ? s.k0p : s.hp, s.hp,
                  false, wt);
    float* h = hbuf + l * plane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 32 * j;
        if (c < s.hp) {
          const float v = fmaxf(acc[i][j] + __ldg(bias + l * s.hp + c), 0.0f);
          act_out[r * kF32Ld + c] = v;
          if (row0 + r < s.n) h[size_t(row0 + r) * s.hp + c] = v;
        }
      }
    }
    __syncthreads();
    float* t = act_in;
    act_in = act_out;
    act_out = t;
  }

  // ---- backward: the cotangent g, then dh_l = dpre_{l+1} W_{l+1}, masked
  for (int i = tid; i < kF32Rows * s.op; i += blockDim.x) {
    const int r = i / s.op, c = i - r * s.op;
    const int gr = row0 + r;
    act_in[r * kF32Ld + c] =
        gr < s.n && c < s.out_dim ? __ldg(gout + size_t(gr) * s.out_dim + c) : 0.0f;
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    f32_tile_gemm(acc, act_in, layer_w(l + 1), l == L - 1 ? s.op : s.hp,
                  s.hp, true, wt);
    const float* h = hbuf + l * plane;
    float* dp = dpbuf + l * plane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i, gr = row0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 32 * j;
        if (c < s.hp) {
          const bool live = gr < s.n && h[size_t(gr) * s.hp + c] > 0.0f;
          const float v = live ? acc[i][j] : 0.0f;
          act_out[r * kF32Ld + c] = v;
          if (gr < s.n) dp[size_t(gr) * s.hp + c] = v;
        }
      }
    }
    __syncthreads();
    float* t = act_in;
    act_in = act_out;
    act_out = t;
  }

  // ---- layer 0 against the encoding: dx (4 threads per row)
  if (dx == nullptr) return;
  f32_tile_gemm(acc, act_in, w, s.hp, s.k0p, true, wt);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 32 * j;
      if (c < s.k0p) act_out[(ty * 8 + i) * kF32Ld + c] = acc[i][j];
    }
  __syncthreads();
  const int r = tid >> 2, sub = tid & 3, gr = row0 + r;
  float xr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) xr[c] = gr < s.n ? __ldg(x + size_t(gr) * 3 + c) : 0.0f;
  float d[3] = {0.0f, 0.0f, 0.0f};
  for (int p = sub; p < pairs; p += 4)
    pair_input_grad(p, act_out[r * kF32Ld + 2 * p],
                    act_out[r * kF32Ld + 2 * p + 1], xr[0], xr[1], xr[2],
                    freqs, s.F, d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] += __shfl_xor_sync(0xffffffffu, d[c], 1);
    d[c] += __shfl_xor_sync(0xffffffffu, d[c], 2);
  }
  if (sub == 0 && gr < s.n)
#pragma unroll
    for (int c = 0; c < 3; ++c) dx[size_t(gr) * 3 + c] = d[c];
}

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(*p);
  else return *p;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16(v);
  else return v;
}

// One layer's dW = dpre^T . h_below over the rows [rbeg, rend) of this
// block's slice (blockIdx.z), a 64 x 64 tile of the packed (m_out x k_in)
// dW per block: out units m0 = 64 blockIdx.y, in units n0 = 64 blockIdx.x.
// a: dpre (or g), n x lda f32 with a_cols valid columns; hb: h_below, n x
// ldb in T, or null for layer 0, whose input (the encoding) is recomputed
// from x. The partial tile goes to part_w[chunk * stride + m * k_in + n],
// the partial db (from the f32 dpre, by the blocks with n0 == 0) to
// part_b[chunk * stride + m].
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    pe_mlp_dw_kernel(const float* __restrict__ a, int lda, int a_cols,
                     const T* __restrict__ hb, int ldb,
                     const float* __restrict__ x,
                     const float* __restrict__ freqs, int F, int m_out,
                     int k_in, int n, int rows_per_chunk,
                     float* __restrict__ part_w, float* __restrict__ part_b,
                     size_t stride) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kLd = kBf16 ? kDwLd : kDwLdF;
  __shared__ __align__(16) unsigned char raw[2 * kDwRows * kLd * sizeof(T)];
  T* as = reinterpret_cast<T*>(raw);         // as[k][m] = dpre[row k][m]
  T* bs = as + kDwRows * kLd;                // bs[k][n] = h[row k][n]
  __shared__ float red[kDwThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kDwTile, m0 = blockIdx.y * kDwTile;
  const int chunk = blockIdx.z;
  const int rbeg = chunk * rows_per_chunk;
  const int rend = rbeg + rows_per_chunk < n ? rbeg + rows_per_chunk : n;

  float acc[2][4][4];  // bf16: warp quarter 32 x 32 as 2 m16 x 4 n8 tiles
  float facc[8][4];    // f32: rows 8 (tid >> 4) + i, columns 4 (tid & 15) + j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      facc[i][j] = 0.0f;
      acc[i >> 2][i & 3][j] = 0.0f;
    }
  float db = 0.0f;
  const int lc = tid & (kDwTile - 1), lr = tid >> 6;  // loader: column, row
  for (int rs = rbeg; rs < rend; rs += kDwRows) {
#pragma unroll
    for (int j = 0; j < kDwRows / 2; ++j) {
      const int k = lr + 2 * j, r = rs + k, m = m0 + lc;
      const float v = r < rend && m < a_cols ? __ldg(a + size_t(r) * lda + m) : 0.0f;
      db += v;
      as[k * kLd + lc] = from_f32<T>(v);
    }
    if (hb == nullptr) {
      const int p = tid & 31;  // one encoding pair: columns 2p, 2p + 1
#pragma unroll
      for (int j = 0; j < kDwRows / 4; ++j) {
        const int k = (tid >> 5) + 4 * j, r = rs + k;
        float2 e = make_float2(0.0f, 0.0f);
        if (r < rend)
          e = encode_pair(p, __ldg(x + size_t(r) * 3), __ldg(x + size_t(r) * 3 + 1),
                          __ldg(x + size_t(r) * 3 + 2), freqs, F);
        bs[k * kLd + 2 * p] = from_f32<T>(e.x);
        bs[k * kLd + 2 * p + 1] = from_f32<T>(e.y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kDwRows / 2; ++j) {
        const int k = lr + 2 * j, r = rs + k, c = n0 + lc;
        bs[k * kLd + lc] = r < rend && c < k_in ? hb[size_t(r) * ldb + c] : from_f32<T>(0.0f);
      }
    }
    __syncthreads();
    if constexpr (kBf16) {
      const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
      const int r8 = lane & 7, mat = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kDwRows; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4_trans(af[mi], as + (kk + (mat >> 1) * 8 + r8) * kLd + wm +
                                        mi * 16 + (mat & 1) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bs + (kk + (mat & 1) * 8 + r8) * kLd + wn +
                                   np * 16 + (mat >> 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * np], af[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * np + 1], af[mi], b[2], b[3]);
          }
        }
      }
    } else {
      const int tm = (tid >> 4) * 8, tn = (tid & 15) * 4;
      for (int k = 0; k < kDwRows; ++k) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = load_f32(as + k * kLd + tm + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = load_f32(bs + k * kLd + tn + j);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
      }
    }
    __syncthreads();
  }

  float* pw = part_w + size_t(chunk) * stride;
  if constexpr (kBf16) {
    const int g = lane >> 2, q = lane & 3;
    const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
          const int c = n0 + wn + nt * 8 + 2 * q + (e & 1);
          if (m < m_out && c < k_in) pw[size_t(m) * k_in + c] = acc[mi][nt][e];
        }
  } else {
    const int tm = (tid >> 4) * 8, tn = (tid & 15) * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tm + i, c = n0 + tn + j;
        if (m < m_out && c < k_in) pw[size_t(m) * k_in + c] = facc[i][j];
      }
  }
  red[tid] = db;
  __syncthreads();
  if (blockIdx.x == 0 && tid < kDwTile && m0 + tid < m_out)
    part_b[size_t(chunk) * stride + m0 + tid] = red[tid] + red[tid + kDwTile];
}

// out[i] = sum over the slices c of part[c * count + i], c in order.
__global__ void pe_mlp_reduce_kernel(const float* __restrict__ part,
                                     int slices, int count,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int c = 0; c < slices; ++c) acc += part[size_t(c) * count + i];
  out[i] = acc;
}

template <typename T>
cudaError_t launch_dw(const float* g, const T* hbuf, const float* dpbuf,
                      const float* x, const float* freqs, float* part,
                      const PeMlpShape& s, int rows_per_chunk, int slices,
                      int total, cudaStream_t st) {
  const size_t plane = size_t(s.n) * s.hp;
  const int L = s.n_hidden;
  const int w_total = s.hp * s.k0p + (L - 1) * s.hp * s.hp + s.op * s.hp;
  for (int l = 0; l <= L; ++l) {
    const bool out_layer = l == L;
    const float* a = out_layer ? g : dpbuf + l * plane;
    const int lda = out_layer ? s.out_dim : s.hp;
    const T* hb = l == 0 ? nullptr : hbuf + (l - 1) * plane;
    const int m_out = out_layer ? s.op : s.hp;
    const int k_in = l == 0 ? s.k0p : s.hp;
    const size_t w_off = l == 0 ? 0 : size_t(s.hp) * s.k0p + size_t(l - 1) * s.hp * s.hp;
    const dim3 grid((k_in + kDwTile - 1) / kDwTile, (m_out + kDwTile - 1) / kDwTile,
                    slices);
    pe_mlp_dw_kernel<T><<<grid, kDwThreads, 0, st>>>(
        a, lda, lda, hb, s.hp, x, freqs, s.F, m_out, k_in, s.n, rows_per_chunk,
        part + w_off, part + w_total + l * s.hp, size_t(total));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  pe_mlp_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(part, slices, total,
                                                            part + size_t(slices) * total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fused PE+MLP backward on `stream`: dx (n x 3, skipped when
// dx is null) and, unless part is null, every layer's dW and db summed into
// part + slices * total (total = packed weights + packed biases, in
// pack_layers' order). hbuf (n_hidden x n x hp, bf16 or f32 by `bf16`) and
// dpbuf (n_hidden x n x hp f32) are scratch; part holds `slices` partial
// sums of `total` floats before the result. Returns the first cudaError_t.
int neraf_pe_mlp_bwd_launch(const float* x, const float* g, const void* w,
                            const float* bias, const float* freqs, float* dx,
                            void* hbuf, float* dpbuf, float* part, int n,
                            int F, int k0p, int hp, int n_hidden, int out_dim,
                            int op, int rows_per_chunk, int bf16,
                            void* stream) {
  const PeMlpShape s{n, F, k0p, hp, n_hidden, out_dim, op};
  if (n <= 0 || F < 1 || k0p % 16 != 0 || k0p > kMaxK0 || 6 * F + 3 > k0p ||
      hp % 16 != 0 || hp > kMaxHidden || n_hidden < 1 || out_dim < 1 ||
      out_dim > op || op % 8 != 0 || op > kMaxOut || rows_per_chunk < 1 ||
      rows_per_chunk % kDwRows != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slices = (n + rows_per_chunk - 1) / rows_per_chunk;
  const int total = hp * k0p + (n_hidden - 1) * hp * hp + op * hp +
                    n_hidden * hp + op;
  cudaError_t err;
  if (!bf16) {
    const size_t smem = f32_smem_bytes();
    err = cudaFuncSetAttribute(pe_mlp_bwd_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    pe_mlp_bwd_f32_kernel<<<(n + kF32Rows - 1) / kF32Rows, kThreads, smem, st>>>(
        x, g, static_cast<const float*>(w), bias, freqs,
        static_cast<float*>(hbuf), dpbuf, dx, s);
    err = cudaGetLastError();
    if (err != cudaSuccess || part == nullptr) return int(err);
    return int(launch_dw<float>(g, static_cast<const float*>(hbuf), dpbuf, x,
                                freqs, part, s, rows_per_chunk, slices, total,
                                st));
  }
  void (*kernel)(const float*, const float*, const __nv_bfloat16*,
                 const float*, const float*, __nv_bfloat16*, float*, float*,
                 PeMlpShape);
  switch (hp) {
    case 16: kernel = pe_mlp_bwd_bf16_kernel<16>; break;
    case 32: kernel = pe_mlp_bwd_bf16_kernel<32>; break;
    case 64: kernel = pe_mlp_bwd_bf16_kernel<64>; break;
    case 128: kernel = pe_mlp_bwd_bf16_kernel<128>; break;
    case 256: kernel = pe_mlp_bwd_bf16_kernel<256>; break;
    default: return int(cudaErrorInvalidValue);
  }
  const size_t smem = bf16_smem_bytes(hp, k0p, ceil_to(op, 16));
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<(n + kTileRows - 1) / kTileRows, kThreads, smem, st>>>(
      x, g, static_cast<const __nv_bfloat16*>(w), bias, freqs,
      static_cast<__nv_bfloat16*>(hbuf), dpbuf, dx, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return int(err);
  return int(launch_dw<__nv_bfloat16>(g, static_cast<const __nv_bfloat16*>(hbuf),
                                      dpbuf, x, freqs, part, s, rows_per_chunk,
                                      slices, total, st));
}

}  // extern "C"
