// Fused fourier positional encoding + ReLU MLP backward for Hopper (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp, backward (_bwd_call,
// kernel _make_bwd_kernel). For rows x in [0,1]^3 and the output cotangent g
// (N, O) f32 it returns dx (N, 3) f32 and every layer's dW, db in f32, in
// the packed layout of pack_layers (ops/pe_mlp.py), with the Pallas kernel's
// rounding: every product in bf16 with f32 accumulation, dW from the bf16
// cotangents (g, then each masked dpre), db from the f32 ones, the ReLU masks
// and the angle gradient in f32; dW and db are sums in a fixed order (no
// float atomics), so they are deterministic.
//
// Why not as on the TPU: the Pallas kernel runs its row tiles in order on
// one core and adds every tile's dW into accumulators that stay in VMEM. On
// the H100 blocks run in parallel and in no order, and the main field's dW
// (216,832 f32, 847 KiB) does not fit a block's 227 KB of shared memory. So
// the bf16 backward is three launches:
//  1. pe_mlp_bwd_bf16_kernel, pe_mlp_common.cuh's row-tile engine (two
//     warpgroups of 64 rows and a producer warp a block, persistent, the
//     weights resident or streamed through the ring, activations in
//     registers as wgmma's A operand): recomputes the forward, stores each
//     hidden layer's h (bf16) to scratch, walks back through the layers
//     (dh = dpre W on wgmma with the same staged W read MN-major, the
//     transpose bit set; at HP 256 in two 128-wide halves of N), masks dh
//     by h > 0 into dpre, stores dpre (bf16) to scratch, sums the f32 dpre
//     and g over its rows into per-block db partials (warp shuffles, then
//     the four warps of a warpgroup in order, then the two warpgroups), and
//     forms dx from layer 0's input gradient and the recomputed sin/cos
//     (dang = dsin cos - dcos sin, dx = 2 pi f dang + dx_direct; the rint()
//     of the range reduction is piecewise constant);
//  2. pe_mlp_dw_kernel<NB>, once per layer: dW = dpre^T h_below as a
//     split-K product over the rows on wgmma, both operands from shared
//     memory (MN-major, the transpose bits set): a block owns an M tile of
//     128 output units (64 a warpgroup) across the layer's whole input
//     width NB (<= 256, wgmma's largest N), and a slice of the rows, which
//     its producer warp streams in 64-row steps through a four-stage ring
//     of bulk copies (the M tile of dpre, all of h). Layer 0's input, the
//     encoding, is recomputed from x into the stage, never stored. The
//     output layer is taken transposed, dW_out^T = h^T g, so that M is the
//     hidden width there too. The slices are sized so that M tiles x
//     slices fill one wave of the SMs (132 at HP <= 128, 66 at HP 256),
//     and each block writes its partial tile to its own slice;
//  3. pe_mlp_reduce_kernel sums the dW slices and the db partials in a
//     fixed order.
// The mask is h > 0 on the stored bf16 h: bf16 keeps f32's exponent range,
// so this is the Pallas kernel's pre > 0 unless 0 < pre < 2^-133.
//
// Scratch (allocated by the wrapper, private to launches 1 and 2): h,
// n_hidden planes, and dpre, n_hidden planes and one of g, all bf16, rows
// padded to the row tiles. A plane is stored in 64-row tiles; in a tile of
// width W, the 8 x 8 core matrix of rows 8 rb .., units 8 ub .. lies at
// element (8 ub + rb) 64, row-major inside: a warp's accumulator of one n8
// tile is one contiguous 128-byte store, and an M tile of units in a step
// of rows is one contiguous bulk copy that wgmma reads as it lands. At the
// proposal-0 training shape (1,048,576 rows, HP 128, 2 hidden layers) that
// is 537 MB of h and 537 MB of dpre; at the main field's (196,608 rows, HP
// 256, 4 layers) 403 MB and 403 MB; plus the partials, slices x (all
// packed weights) f32 (57 MB for the main field) and one db partial a
// row-tile block.
//
// What bounds it on the H100: device memory. Launch 1 writes h and dpre
// (bf16) and reads h back for the masks; launch 2 reads every dpre plane
// once and every h plane once per M tile (twice at HP 256). The products
// run on wgmma, and the row-tile kernel's weight traffic stays in the L2.
// dW fused into the row-tile kernel (no h or dpre in device memory) is not
// taken at any HP: the dW accumulators of the proposals' 23.6 k weights do
// not fit the registers beside the row tile's, and accumulating them in
// shared memory adds a read-modify-write of 94 KiB a tile.
//
// The f32 instantiation (CUDA-core FMA, no TF32) is the same function for
// checks in f32: 64 rows per block with activations in shared memory, h and
// dpre stored row-major in f32, an FMA dW tile of 64 x 64 per block and the
// same slices.

#include "pe_mlp_common.cuh"

namespace {

// the bf16 dW kernel: 64 rows a step, an M tile of kBlockRows units
constexpr int kDwStep = kWgRows;
constexpr int kDwStages = 4;
constexpr int kDwABytes = kBlockRows * kDwStep * 2;  // 16 KiB
constexpr int kDwThreadsBf16 = 128 * kConsumers + 32;  // + a producer warp
// the f32 dW kernel
constexpr int kDwTile = 64;      // dW tile: 64 output units x 64 input units
constexpr int kDwRows = 32;      // rows per step of the split-K loop
constexpr int kDwThreads = 128;  // 2 x 64 threads: rows 8 (tid >> 4) ..
constexpr int kDwLdF = kDwTile + 4;  // f32 shared row stride

// Element offset in a plane of width W: 64-row tile rt, row block rb (8
// rows), unit block ub (8 units), row g of the block, units 2q, 2q + 1.
__device__ __forceinline__ size_t plane_off(int rt, int W, int rb, int ub,
                                            int g, int q) {
  return size_t(rt) * kWgRows * W + (ub * 8 + rb) * 64 + g * 8 + 2 * q;
}

__device__ __forceinline__ uint32_t& word(__nv_bfloat16* p) {
  return *reinterpret_cast<uint32_t*>(p);
}

// A warp's activations (A fragments of KT k16 tiles) -> its 16 rows of a
// plane of width W.
template <int KT>
__device__ __forceinline__ void store_plane(const uint32_t (&a)[KT][4],
                                            __nv_bfloat16* pl, int rt, int W,
                                            int wq, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      word(pl + plane_off(rt, W, 2 * wq + (e & 1), 2 * kt + (e >> 1), g, q)) =
          a[kt][e];
}

// Column sums over a warp's 16 rows of one n8 tile's values (rows g and
// g + 8 at columns col, col + 1) -> sc[col], sc[col + 1] (the g == 0 lanes).
__device__ __forceinline__ void col_sum(float v0, float v1, float v2,
                                        float v3, float* sc, int col,
                                        int lane) {
  float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
  for (int m = 4; m <= 16; m <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, m);
    s1 += __shfl_xor_sync(0xffffffffu, s1, m);
  }
  if (lane < 4) {
    sc[col] = s0;
    sc[col + 1] = s1;
  }
}

// A warpgroup's db sums: each warp writes a layer's column sums to its row
// of the scratch (two buffers, alternating by layer), then flush() adds
// the four rows in warp order to the warpgroup's running sums; a column's
// sum is only ever touched by one thread.
struct DbSums {
  float* scratch;  // [2][4][sw]
  float* acc;      // [n_hidden * HP + opk]
  int sw, wg, tid, parity;
  __device__ float* row(int wq) { return scratch + (parity * 4 + wq) * sw; }
  __device__ void flush(int off, int width) {
    named_sync(1 + wg, 128);
    const float* sc = scratch + parity * 4 * sw;
    for (int c = tid; c < width; c += 128)
      acc[off + c] += ((sc[c] + sc[sw + c]) + sc[2 * sw + c]) + sc[3 * sw + c];
    parity ^= 1;
  }
};

// acc = cot . W over W's rows (K; the cotangent's k16 tiles, kt_used of
// them) for the N columns col0 .. of W: W is staged MN-major in chunks of R
// rows, k tiles 0 .. PER-1 in chunk w0, the rest in w1. `during` runs
// while the products are in flight.
template <int N, int KT, int PER, class During = Nothing>
__device__ __forceinline__ void back_product(float (&acc)[N / 2],
                                             const uint32_t (&cot)[KT][4],
                                             const unsigned char* w0,
                                             const unsigned char* w1, int R,
                                             int kt_used, int col0,
                                             During during = During()) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    if (kt < kt_used) {
      const unsigned char* w = kt < PER ? w0 : w1;
      wgmma_rs<N, 1>(acc, cot[kt],
                     wgmma_desc(w + col0 * R * 2 + (kt % PER) * 256, 128,
                                R * 16));
    }
  wgmma_commit();
  during();
  wgmma_wait_all();
  fence_regs(acc);
}

// The h of a warp's rows at the NC columns c0 .. (the accumulator's
// places; the warp stored them in the forward), loaded while the products
// that the mask needs them for are in flight.
template <int NC>
__device__ __forceinline__ void load_h(uint32_t (&hv)[NC / 8][2],
                                       const __nv_bfloat16* __restrict__ hpl,
                                       int c0, int rt, int W, int wq,
                                       int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      hv[j][h] = *reinterpret_cast<const uint32_t*>(
          hpl + plane_off(rt, W, 2 * wq + h, c0 / 8 + j, g, q));
}

// dpre = dh (acc, the NC columns c0 ..) masked by h > 0 (hv) on rows < n:
// stored (bf16) to the dpre plane, its column sums to sc, and packed into
// the A fragments of `o`.
template <int NC, int KT>
__device__ __forceinline__ void back_epilogue(
    const float (&acc)[NC / 2], const uint32_t (&hv)[NC / 8][2],
    uint32_t (&o)[KT][4], int c0, __nv_bfloat16* __restrict__ dpl, int rt,
    int W, int wq, int lane, bool ok0, bool ok1, float* sc) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float2 h0 = unpack_bf16x2(hv[j][0]), h1 = unpack_bf16x2(hv[j][1]);
    const float v0 = ok0 && h0.x > 0.0f ? acc[4 * j] : 0.0f;
    const float v1 = ok0 && h0.y > 0.0f ? acc[4 * j + 1] : 0.0f;
    const float v2 = ok1 && h1.x > 0.0f ? acc[4 * j + 2] : 0.0f;
    const float v3 = ok1 && h1.y > 0.0f ? acc[4 * j + 3] : 0.0f;
    const uint32_t p0 = pack_bf16x2(v0, v1), p1 = pack_bf16x2(v2, v3);
    word(dpl + plane_off(rt, W, 2 * wq, c0 / 8 + j, g, q)) = p0;
    word(dpl + plane_off(rt, W, 2 * wq + 1, c0 / 8 + j, g, q)) = p1;
    o[c0 / 16 + j / 2][(j & 1) * 2] = p0;
    o[c0 / 16 + j / 2][(j & 1) * 2 + 1] = p1;
    col_sum(v0, v1, v2, v3, sc, c0 + 8 * j + 2 * q, lane);
  }
}

// The output cotangent g of a warp's rows as A fragments of opk / 16 k16
// tiles (bf16, zero past out_dim and n), stored to the g plane (width opk),
// its f32 column sums to sc.
__device__ __forceinline__ void load_g(uint32_t (&ga)[kMaxOut / 16][4],
                                       const float* __restrict__ gout,
                                       __nv_bfloat16* __restrict__ gpl, int rt,
                                       int opk, const PeMlpShape& s, int row0,
                                       int wq, int lane, float* sc) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kt = 0; kt < kMaxOut / 16; ++kt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (kt * 16 >= opk) {
        ga[kt][half * 2] = ga[kt][half * 2 + 1] = 0u;
        continue;
      }
      const int col = kt * 16 + half * 8 + 2 * q;
      float v[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + g + 8 * h;
        const float* gr = gout + size_t(r) * s.out_dim;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[h][e] = r < s.n && col + e < s.out_dim ? __ldg(gr + col + e) : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t p = pack_bf16x2(v[h][0], v[h][1]);
        ga[kt][half * 2 + h] = p;
        word(gpl + plane_off(rt, opk, 2 * wq + h, 2 * kt + half, g, q)) = p;
      }
      col_sum(v[0][0], v[0][1], v[1][0], v[1][1], sc, col, lane);
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

// Layer 0 of the backward for a warp's rows: the encoding's cotangent
// d_enc = dpre_0 W0 (N = k0p columns, K = HP over W0's chunks), then dx:
// for the pair p = 4 nt + q of n8 tile nt (columns 8 nt + 2q, + 1), dang =
// dsin cos - dcos sin and dx_d += 2 pi f dang (the rint() of the range
// reduction is piecewise constant), or the direct x columns.
template <int N, int KT, int PER>
__device__ __forceinline__ void input_grad(const uint32_t (&dp)[KT][4],
                                           const unsigned char* w0,
                                           const unsigned char* w1, int R,
                                           const float* __restrict__ x,
                                           const EncPairs& e,
                                           float* __restrict__ dx,
                                           const PeMlpShape& s, int row0,
                                           int lane) {
  const int g = lane >> 2, q = lane & 3;
  float xr[2][3];
  float acc[N / 2];
  back_product<N, KT, PER>(acc, dp, w0, w1, R, KT, 0, [&] {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        xr[h][c] = r < s.n ? __ldg(x + size_t(r) * 3 + c) : 0.0f;
    }
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const float ds = acc[4 * nt + 2 * h], dc = acc[4 * nt + 2 * h + 1];
      const int d = e.d[nt];
      if (d < 3) {
        const float2 sc = fast_sincos(
            e.f[nt], d == 0 ? xr[h][0] : (d == 1 ? xr[h][1] : xr[h][2]));
        const float v = (kTwoPi * e.f[nt]) * (ds * sc.y - dc * sc.x);
        d0 += d == 0 ? v : 0.0f;
        d1 += d == 1 ? v : 0.0f;
        d2 += d == 2 ? v : 0.0f;
      } else if (d == 3) {
        d0 += ds;
        d1 += dc;
      } else if (d == 4) {
        d2 += ds;
      }
    }
    float dv[3] = {d0, d1, d2};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dv[c] += __shfl_xor_sync(0xffffffffu, dv[c], 1);
      dv[c] += __shfl_xor_sync(0xffffffffu, dv[c], 2);
    }
    const int r = row0 + g + 8 * h;
    if (q == 0 && r < s.n)
#pragma unroll
      for (int c = 0; c < 3; ++c) dx[size_t(r) * 3 + c] = dv[c];
  }
}

// Shared memory of the bf16 row-tile kernel: the ring, then each
// warpgroup's db scratch and sums.
inline size_t bwd_smem_bytes(int hp, int k0p, int opk, int L) {
  const int sw = imax(hp, kMaxOut), nbk = L * hp + opk;
  return ring_smem_bytes(hp, k0p, opk, L) + size_t(kConsumers) * (8 * sw + nbk) * 4;
}

template <int HP>
__global__ void __launch_bounds__(kWgThreads, 1)
    pe_mlp_bwd_bf16_kernel(const float* __restrict__ x,
                           const float* __restrict__ gout,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ freqs,
                           __nv_bfloat16* __restrict__ hbuf,
                           __nv_bfloat16* __restrict__ dpbuf,
                           float* __restrict__ dx, float* __restrict__ part_b,
                           PeMlpShape s) {
  constexpr int NC = HP < 128 ? HP : 128;
  constexpr int CPL = HP / NC;
  constexpr int KT = HP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int opk = ceil_to(s.op, 16), L = s.n_hidden;
  const Chunks ch{HP, s.k0p, opk, L, NC};
  const uint32_t stage_bytes = ring_stage_bytes(HP, s.k0p, opk);
  const int stages = ring_stages(HP, s.k0p, opk, L);
  const bool resident = ring_resident(HP, s.k0p, opk, L);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + size_t(stages) * stage_bytes);
  uint64_t* empty = full + kMaxStages;
  float* dbs = reinterpret_cast<float*>(empty + kMaxStages);
  const int sw = imax(HP, kMaxOut), nbk = L * HP + opk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (s.n + kBlockRows - 1) / kBlockRows;
  const size_t plane = size_t(tiles) * kBlockRows * HP;
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
        // the order the consumers take them: the forward, the output
        // layer, the hidden layers back down, layer 0 for dx
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          for (int l = 0; l <= L; ++l) f.put_layer(ch, l);
          for (int l = L - 1; l >= 1; --l) f.put_layer(ch, l);
          if (dx != nullptr) f.put_layer(ch, 0);
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int wg = warp >> 2, wq = warp & 3, tid = threadIdx.x & 127;
  float* mine = dbs + size_t(wg) * (8 * sw + nbk);
  DbSums db{mine, mine + 8 * sw, sw, wg, tid, 0};
  for (int c = tid; c < nbk; c += 128) db.acc[c] = 0.0f;
  Ring ring{smem, full, empty, stage_bytes, stages, resident, 0};
  const EncPairs enc = enc_pairs(freqs, s, lane);
  __nv_bfloat16* gpl = dpbuf + size_t(L) * plane;
  const int g = lane >> 2;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t * kConsumers + wg;  // the 64-row tile of the planes
    const int row0 = rt * kWgRows + wq * 16;
    const bool ok0 = row0 + g < s.n, ok1 = row0 + g + 8 < s.n;

    // ---- the forward again, storing every h
    uint32_t a0[kMaxK0 / 16][4];
    encode_frags(a0, x, enc, s, row0, lane);
    uint32_t act[KT][4];
    forward_hidden<HP>(act, a0, ring, ch, bias, L, lane,
                       [&](int l, const uint32_t (&a)[KT][4]) {
                         store_plane<KT>(a, hbuf + l * plane, rt, HP, wq, lane);
                       },
                       Nothing());

    // ---- the output layer: dpre_{L-1} = mask(g W_out)
    uint32_t dp[KT][4];
    {
      uint32_t ga[kMaxOut / 16][4];
      load_g(ga, gout, gpl, rt, opk, s, row0, wq, lane, db.row(wq));
      db.flush(L * HP, opk);
      const unsigned char* wo = ring.acquire(ch, L, 0);
      float* sc = db.row(wq);
#pragma unroll
      for (int nh = 0; nh < CPL; ++nh) {
        uint32_t hv[NC / 8][2];
        float acc[NC / 2];
        back_product<NC, kMaxOut / 16, kMaxOut / 16>(
            acc, ga, wo, wo, opk, opk / 16, nh * NC, [&] {
              load_h<NC>(hv, hbuf + (L - 1) * plane, nh * NC, rt, HP, wq, lane);
            });
        back_epilogue<NC, KT>(acc, hv, dp, nh * NC, dpbuf + (L - 1) * plane,
                              rt, HP, wq, lane, ok0, ok1, sc);
      }
      ring.release(1, lane);
      db.flush((L - 1) * HP, HP);
    }

    // ---- hidden layers, top down: dh_{l-1} = dpre_l W_l
    for (int l = L - 1; l >= 1; --l) {
      const unsigned char* w0 = ring.acquire(ch, l, 0);
      const unsigned char* w1 = CPL > 1 ? ring.acquire(ch, l, 1) : w0;
      float* sc = db.row(wq);
      uint32_t nxt[KT][4];
#pragma unroll
      for (int nh = 0; nh < CPL; ++nh) {
        uint32_t hv[NC / 8][2];
        float acc[NC / 2];
        back_product<NC, KT, NC / 16>(acc, dp, w0, w1, NC, KT, nh * NC, [&] {
          load_h<NC>(hv, hbuf + (l - 1) * plane, nh * NC, rt, HP, wq, lane);
        });
        back_epilogue<NC, KT>(acc, hv, nxt, nh * NC, dpbuf + (l - 1) * plane,
                              rt, HP, wq, lane, ok0, ok1, sc);
      }
      ring.release(CPL, lane);
      db.flush((l - 1) * HP, HP);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[kt][e] = nxt[kt][e];
    }

    // ---- layer 0 against the encoding: dx
    if (dx != nullptr) {
      const unsigned char* w0 = ring.acquire(ch, 0, 0);
      const unsigned char* w1 = CPL > 1 ? ring.acquire(ch, 0, 1) : w0;
      switch (s.k0p) {
        case 16: input_grad<16, KT, NC / 16>(dp, w0, w1, NC, x, enc, dx, s, row0, lane); break;
        case 32: input_grad<32, KT, NC / 16>(dp, w0, w1, NC, x, enc, dx, s, row0, lane); break;
        case 48: input_grad<48, KT, NC / 16>(dp, w0, w1, NC, x, enc, dx, s, row0, lane); break;
        default: input_grad<64, KT, NC / 16>(dp, w0, w1, NC, x, enc, dx, s, row0, lane); break;
      }
      ring.release(CPL, lane);
    }
  }

  // ---- the block's db partial: the two warpgroups' sums, in order
  if (part_b != nullptr) {
    named_sync(1 + kConsumers, 128 * kConsumers);
    const float* s0 = dbs + 8 * sw;
    const float* s1 = s0 + 8 * sw + nbk;
    const int nb = L * HP + s.op;
    for (int c = threadIdx.x; c < nb; c += 128 * kConsumers)
      part_b[size_t(blockIdx.x) * nb + c] = s0[c] + s1[c];
  }
}

// Layer 0's input in a dW step: thread t forms the encoding pair p = t %
// 32 (frequency f, axis d as EncPairs has them) of the step's rows t / 32 +
// 8 k, as encode_frags does. load_x fetches the x values it needs for the
// step from row r0 (while the previous step is in the products), and
// encode_tile writes the pairs to the stage in the plane layout (width k0p).
struct EncTile {
  float f;
  int d;
  float xv[kDwStep / 8][2];

  __device__ void load_x(const float* __restrict__ x, const PeMlpShape& s,
                         int r0) {
#pragma unroll
    for (int k = 0; k < kDwStep / 8; ++k) {
      const int gr = r0 + (threadIdx.x >> 5) + 8 * k;
      const float* xg = x + size_t(gr) * 3;
      const bool ok = gr < s.n && d < 5;
      xv[k][0] = ok ? __ldg(xg + (d < 3 ? d : (d == 3 ? 0 : 2))) : 0.0f;
      xv[k][1] = ok && d == 3 ? __ldg(xg + 1) : 0.0f;
    }
  }
  __device__ void encode_tile(unsigned char* stage, const PeMlpShape& s) const {
    const int c = 2 * (threadIdx.x & 31);
    if (c >= s.k0p) return;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(stage);
#pragma unroll
    for (int k = 0; k < kDwStep / 8; ++k) {
      const int r = (threadIdx.x >> 5) + 8 * k;
      const float2 v = d < 3 ? fast_sincos(f, xv[k][0])
                             : make_float2(xv[k][0], xv[k][1]);
      word(e + ((c >> 3) * 8 + (r >> 3)) * 64 + (r & 7) * 8 + (c & 7)) =
          pack_bf16x2(v.x, v.y);
    }
  }
};

// One layer's dW over the 64-row steps [k_beg, k_end) of this block's slice
// (blockIdx.y), for the M tile of 128 units m0 = 128 blockIdx.x: D = A^T B
// with A the cotangent plane (width wa) and B the input plane (width NB),
// or, with b null, the encoding. D (M x NB) goes to the slice's partial at
// part + slice n_w + w_off, row-major (m, NB), or transposed (NB rows of
// wa: the output layer, whose A is h and B is g; rows < op written).
template <int NB>
__global__ void __launch_bounds__(kDwThreadsBf16, 1)
    pe_mlp_dw_kernel(const __nv_bfloat16* __restrict__ a, int wa,
                     const __nv_bfloat16* __restrict__ b,
                     const float* __restrict__ x,
                     const float* __restrict__ freqs, PeMlpShape s, int steps,
                     int steps_per_slice, float* __restrict__ part,
                     size_t n_w, size_t w_off, int transposed) {
  constexpr uint32_t kBBytes = NB * kDwStep * 2;
  constexpr uint32_t kStage = kDwABytes + kBBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDwStages * kStage);
  uint64_t* empty = full + kDwStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBlockRows;
  const int ma = wa - m0 < kBlockRows ? wa - m0 : kBlockRows;
  const int k_beg = blockIdx.y * steps_per_slice;
  const int k_end = k_beg + steps_per_slice < steps ? k_beg + steps_per_slice : steps;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDwStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      const uint32_t abytes = uint32_t(ma) * kDwStep * 2;
      for (int k = k_beg, it = 0; k < k_end; ++k, ++it) {
        const int st = it % kDwStages;
        if (it >= kDwStages) mbar_wait(empty + st, ((it / kDwStages) - 1) & 1);
        unsigned char* dst = smem + st * kStage;
        mbar_expect_tx(full + st, abytes + (b != nullptr ? kBBytes : 0));
        bulk_copy(dst, a + (size_t(k) * wa + m0) * kDwStep, abytes, full + st);
        if (b != nullptr)
          bulk_copy(dst + kDwABytes, b + size_t(k) * kDwStep * NB, kBBytes,
                    full + st);
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  const bool active = m0 + wg * kWgRows < wa;
  // layer 0: this thread's encoding pair, fixed for the kernel
  EncTile et;
  {
    const int p = threadIdx.x & 31;
    et.f = 0.0f;
    if (p < 3 * s.F) {
      et.d = p / s.F;
      et.f = __ldg(freqs + (p - et.d * s.F));
    } else {
      et.d = p == 3 * s.F ? 3 : (p == 3 * s.F + 1 ? 4 : 5);
    }
    if (b == nullptr && k_beg < k_end) et.load_x(x, s, k_beg * kDwStep);
  }
  float acc[NB / 2];
  zero(acc);
  fence_regs(acc);
  // one step's products stay in flight while the next step's are issued;
  // a stage is released once the products that read it completed
  int prev = -1;
  for (int k = k_beg, it = 0; k < k_end; ++k, ++it) {
    const int st = it % kDwStages;
    mbar_wait(full + st, (it / kDwStages) & 1);
    unsigned char* sa = smem + st * kStage;
    unsigned char* sb = sa + kDwABytes;
    if (b == nullptr) {
      et.encode_tile(sb, s);
      fence_proxy_async();
      named_sync(1, 128 * kConsumers);
    }
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kDwStep / 16; ++kt)
        wgmma_ss<NB, 1, 1>(acc, wgmma_desc(sa + wg * 8192 + kt * 256, 128, 1024),
                           wgmma_desc(sb + kt * 256, 128, 1024));
      wgmma_commit();
    }
    if (b == nullptr && k + 1 < k_end) et.load_x(x, s, (k + 1) * kDwStep);
    if (active) wgmma_wait_one();
    __syncwarp();
    const int done = active ? prev : st;
    if (lane == 0 && done >= 0) mbar_arrive(empty + done);
    prev = st;
  }
  if (!active) return;
  wgmma_wait_all();
  fence_regs(acc);

  const int g = lane >> 2, q = lane & 3;
  float* pw = part + size_t(blockIdx.y) * n_w + w_off;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wg * kWgRows + wq * 16 + g + 8 * (e >> 1);
      const int c = j * 8 + 2 * q + (e & 1);
      if (m >= wa) continue;
      if (!transposed)
        pw[size_t(m) * NB + c] = acc[4 * j + e];
      else if (c < s.op)
        pw[size_t(c) * wa + m] = acc[4 * j + e];
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

// The f32 dW = dpre^T . h_below over the rows [rbeg, rend) of this block's
// slice (blockIdx.z), a 64 x 64 tile of the packed (m_out x k_in) dW per
// block: out units m0 = 64 blockIdx.y, in units n0 = 64 blockIdx.x. a: dpre
// (or g), n x lda with a_cols valid columns; hb: h_below, n x ldb, or null
// for layer 0, whose input (the encoding) is recomputed from x. The
// partial tile goes to part_w[slice * n_w + m * k_in + n], the partial db
// (by the blocks with n0 == 0) to part_b[slice * n_b + m].
__global__ void __launch_bounds__(kDwThreads)
    pe_mlp_dw_f32_kernel(const float* __restrict__ a, int lda, int a_cols,
                         const float* __restrict__ hb, int ldb,
                         const float* __restrict__ x,
                         const float* __restrict__ freqs, int F, int m_out,
                         int k_in, int n, int rows_per_chunk,
                         float* __restrict__ part_w, size_t n_w,
                         float* __restrict__ part_b, size_t n_b) {
  __shared__ float as[kDwRows * kDwLdF];  // as[k][m] = dpre[row k][m]
  __shared__ float bs[kDwRows * kDwLdF];  // bs[k][n] = h[row k][n]
  __shared__ float red[kDwThreads];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kDwTile, m0 = blockIdx.y * kDwTile;
  const int chunk = blockIdx.z;
  const int rbeg = chunk * rows_per_chunk;
  const int rend = rbeg + rows_per_chunk < n ? rbeg + rows_per_chunk : n;

  float facc[8][4];  // rows 8 (tid >> 4) + i, columns 4 (tid & 15) + j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;
  float db = 0.0f;
  const int lc = tid & (kDwTile - 1), lr = tid >> 6;  // loader: column, row
  for (int rs = rbeg; rs < rend; rs += kDwRows) {
#pragma unroll
    for (int j = 0; j < kDwRows / 2; ++j) {
      const int k = lr + 2 * j, r = rs + k, m = m0 + lc;
      const float v = r < rend && m < a_cols ? __ldg(a + size_t(r) * lda + m) : 0.0f;
      db += v;
      as[k * kDwLdF + lc] = v;
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
        bs[k * kDwLdF + 2 * p] = e.x;
        bs[k * kDwLdF + 2 * p + 1] = e.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kDwRows / 2; ++j) {
        const int k = lr + 2 * j, r = rs + k, c = n0 + lc;
        bs[k * kDwLdF + lc] = r < rend && c < k_in ? hb[size_t(r) * ldb + c] : 0.0f;
      }
    }
    __syncthreads();
    const int tm = (tid >> 4) * 8, tn = (tid & 15) * 4;
    for (int k = 0; k < kDwRows; ++k) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[k * kDwLdF + tm + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k * kDwLdF + tn + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
    }
    __syncthreads();
  }

  float* pw = part_w + size_t(chunk) * n_w;
  const int tm = (tid >> 4) * 8, tn = (tid & 15) * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tm + i, c = n0 + tn + j;
      if (m < m_out && c < k_in) pw[size_t(m) * k_in + c] = facc[i][j];
    }
  red[tid] = db;
  __syncthreads();
  if (blockIdx.x == 0 && tid < kDwTile && m0 + tid < m_out)
    part_b[size_t(chunk) * n_b + m0 + tid] = red[tid] + red[tid + kDwTile];
}

// out[i] = the sum over the slices c < sw of part_w[c * nw + i], then
// out[nw + j] = the sum over c < sb of part_b[c * nb + j], c in order.
__global__ void pe_mlp_reduce_kernel(const float* __restrict__ part_w, int sw,
                                     int nw, const float* __restrict__ part_b,
                                     int sb, int nb, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* p = i < nw ? part_w + i : part_b + (i - nw);
  const int slices = i < nw ? sw : sb;
  const size_t stride = i < nw ? size_t(nw) : size_t(nb);
  if (i >= nw + nb) return;
  float acc = 0.0f;
  for (int c = 0; c < slices; ++c) acc += p[c * stride];
  out[i] = acc;
}

cudaError_t launch_reduce(const float* part_w, int sw, int nw,
                          const float* part_b, int sb, int nb, float* out,
                          cudaStream_t st) {
  pe_mlp_reduce_kernel<<<(nw + nb + 255) / 256, 256, 0, st>>>(
      part_w, sw, nw, part_b, sb, nb, out);
  return cudaGetLastError();
}

cudaError_t launch_dw_f32(const float* g, const float* hbuf, const float* dpbuf,
                          const float* x, const float* freqs, float* part_w,
                          float* part_b, const PeMlpShape& s, int slices,
                          size_t n_w, size_t n_b, cudaStream_t st) {
  const size_t plane = size_t(s.n) * s.hp;
  const int L = s.n_hidden;
  const int per = (s.n + slices - 1) / slices;
  const int rows_per_chunk = (per + kDwRows - 1) / kDwRows * kDwRows;
  for (int l = 0; l <= L; ++l) {
    const bool out_layer = l == L;
    const float* a = out_layer ? g : dpbuf + l * plane;
    const int lda = out_layer ? s.out_dim : s.hp;
    const float* hb = l == 0 ? nullptr : hbuf + (l - 1) * plane;
    const int m_out = out_layer ? s.op : s.hp;
    const int k_in = l == 0 ? s.k0p : s.hp;
    const size_t w_off = l == 0 ? 0 : size_t(s.hp) * s.k0p + size_t(l - 1) * s.hp * s.hp;
    const dim3 grid((k_in + kDwTile - 1) / kDwTile, (m_out + kDwTile - 1) / kDwTile,
                    slices);
    pe_mlp_dw_f32_kernel<<<grid, kDwThreads, 0, st>>>(
        a, lda, lda, hb, s.hp, x, freqs, s.F, m_out, k_in, s.n, rows_per_chunk,
        part_w + w_off, n_w, part_b + l * s.hp, n_b);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int NB>
cudaError_t launch_dw_bf16(const __nv_bfloat16* a, int wa,
                           const __nv_bfloat16* b, const float* x,
                           const float* freqs, const PeMlpShape& s, int steps,
                           int slices, float* part, size_t n_w, size_t w_off,
                           int transposed, cudaStream_t st) {
  const size_t smem = size_t(kDwStages) * (kDwABytes + NB * kDwStep * 2) +
                      2 * kDwStages * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      pe_mlp_dw_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int per = (steps + slices - 1) / slices;
  const dim3 grid((wa + kBlockRows - 1) / kBlockRows, slices);
  pe_mlp_dw_kernel<NB><<<grid, kDwThreadsBf16, smem, st>>>(
      a, wa, b, x, freqs, s, steps, per, part, n_w, w_off, transposed);
  return cudaGetLastError();
}

cudaError_t launch_dw_bf16_n(int nb, const __nv_bfloat16* a, int wa,
                             const __nv_bfloat16* b, const float* x,
                             const float* freqs, const PeMlpShape& s, int steps,
                             int slices, float* part, size_t n_w, size_t w_off,
                             int transposed, cudaStream_t st) {
#define NERAF_DW(N)                                                        \
  case N:                                                                  \
    return launch_dw_bf16<N>(a, wa, b, x, freqs, s, steps, slices, part,   \
                             n_w, w_off, transposed, st);
  switch (nb) {
    NERAF_DW(16)
    NERAF_DW(32)
    NERAF_DW(48)
    NERAF_DW(64)
    NERAF_DW(128)
    NERAF_DW(256)
    default: return cudaErrorInvalidValue;
  }
#undef NERAF_DW
}

}  // namespace

extern "C" {

// Launches the fused PE+MLP backward on `stream`: dx (n x 3, skipped when
// dx is null) and, unless part is null, every layer's dW and db summed into
// out (n_w packed weights, then n_b packed biases, pack_layers' order).
// bf16: w in tile_layers' layout; the row-tile kernel on `blocks`
// persistent blocks; hbuf (n_hidden planes) and dpbuf (n_hidden planes and
// the g plane), bf16, in the plane layout of ceil(n / 128) * 128 rows;
// part holds `slices` dW partials of n_w floats, then `blocks` db partials
// of n_b. f32: w in pack_layers' layout; hbuf and dpbuf n_hidden x n x hp
// f32; part holds `slices` dW partials, then `slices` db partials. Returns
// the first cudaError_t.
int neraf_pe_mlp_bwd_launch(const float* x, const float* g, const void* w,
                            const float* bias, const float* freqs, float* dx,
                            void* hbuf, void* dpbuf, float* part, float* out,
                            int n, int F, int k0p, int hp, int n_hidden,
                            int out_dim, int op, int slices, int blocks,
                            int bf16, void* stream) {
  const PeMlpShape s{n, F, k0p, hp, n_hidden, out_dim, op};
  if (n <= 0 || F < 1 || k0p % 16 != 0 || k0p > kMaxK0 || 6 * F + 3 > k0p ||
      hp % 16 != 0 || hp > kMaxHidden || n_hidden < 1 || out_dim < 1 ||
      out_dim > op || op % 8 != 0 || op > kMaxOut || slices < 1 || blocks < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = n_hidden;
  const size_t n_w = size_t(hp) * k0p + size_t(L - 1) * hp * hp + size_t(op) * hp;
  const size_t n_b = size_t(L) * hp + op;
  float* part_w = part;
  float* part_b = part == nullptr ? nullptr : part + size_t(slices) * n_w;
  cudaError_t err;
  if (!bf16) {
    const size_t smem = f32_smem_bytes();
    err = cudaFuncSetAttribute(pe_mlp_bwd_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    pe_mlp_bwd_f32_kernel<<<(n + kF32Rows - 1) / kF32Rows, kThreads, smem, st>>>(
        x, g, static_cast<const float*>(w), bias, freqs,
        static_cast<float*>(hbuf), static_cast<float*>(dpbuf), dx, s);
    err = cudaGetLastError();
    if (err != cudaSuccess || part == nullptr) return int(err);
    err = launch_dw_f32(g, static_cast<const float*>(hbuf),
                        static_cast<const float*>(dpbuf), x, freqs, part_w,
                        part_b, s, slices, n_w, n_b, st);
    if (err != cudaSuccess) return int(err);
    return int(launch_reduce(part_w, slices, int(n_w), part_b, slices,
                             int(n_b), out, st));
  }
  void (*kernel)(const float*, const float*, const __nv_bfloat16*,
                 const float*, const float*, __nv_bfloat16*, __nv_bfloat16*,
                 float*, float*, PeMlpShape);
  switch (hp) {
    case 16: kernel = pe_mlp_bwd_bf16_kernel<16>; break;
    case 32: kernel = pe_mlp_bwd_bf16_kernel<32>; break;
    case 64: kernel = pe_mlp_bwd_bf16_kernel<64>; break;
    case 128: kernel = pe_mlp_bwd_bf16_kernel<128>; break;
    case 256: kernel = pe_mlp_bwd_bf16_kernel<256>; break;
    default: return int(cudaErrorInvalidValue);
  }
  const int opk = ceil_to(op, 16);
  const size_t smem = bwd_smem_bytes(hp, k0p, opk, L);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(hbuf);
  __nv_bfloat16* dp = static_cast<__nv_bfloat16*>(dpbuf);
  kernel<<<blocks, kWgThreads, smem, st>>>(
      x, g, static_cast<const __nv_bfloat16*>(w), bias, freqs, hb, dp, dx,
      part_b, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return int(err);
  const int tiles = (n + kBlockRows - 1) / kBlockRows;
  const int steps = tiles * kBlockRows / kDwStep;
  const size_t plane = size_t(tiles) * kBlockRows * hp;
  for (int l = 0; l <= L; ++l) {
    if (l == L)  // dW_out^T = h_{L-1}^T g
      err = launch_dw_bf16_n(opk, hb + (L - 1) * plane, hp, dp + L * plane, x,
                             freqs, s, steps, slices, part_w, n_w,
                             size_t(hp) * k0p + size_t(L - 1) * hp * hp, 1, st);
    else if (l == 0)
      err = launch_dw_bf16_n(k0p, dp, hp, nullptr, x, freqs, s, steps, slices,
                             part_w, n_w, 0, 0, st);
    else
      err = launch_dw_bf16_n(hp, dp + l * plane, hp, hb + (l - 1) * plane, x,
                             freqs, s, steps, slices, part_w, n_w,
                             size_t(hp) * k0p + size_t(l - 1) * hp * hp, 0, st);
    if (err != cudaSuccess) return int(err);
  }
  return int(launch_reduce(part_w, slices, int(n_w), part_b, blocks, int(n_b),
                           out, st));
}

}  // extern "C"
