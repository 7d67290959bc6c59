// Weight gradient of the ResNet3D stem convolution for Hopper (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/stem_wgrad_kernel.py::stem_wgrad_pallas
// (kernel body :34-58), which the JAX package runs inside the joint train
// step's backward when NERAF_STEM_WGRAD_PALLAS=1. Like it, this kernel reads
// the space-to-depth FOLDED volume the stem's conv takes: xf (Df, Hf, Wf,
// 8 cin), cin <= 8 (the grid's 7), channel ((d % 2) 4 + (h % 2) 2 + w % 2)
// cin + c of folded voxel (d / 2, h / 2, w / 2) being x[d, h, w, c] of the
// grid volume x (D, H, W) = 2 (Df, Hf, Wf); and the cotangent g (Df, Hf,
// Wf, 64) of the folded conv's output (kernel 3, stride 1, padding 1),
// channels innermost. The TPU kernel returns the folded conv's weight
// gradient (3, 3, 3, 8 cin, 64); this one returns the same function
// unfolded to the direct conv's (kernel 5, stride 2, padding 2) Conv3d
// layout,
//   dW[co, ci, kd, kh, kw] = sum_{d,h,w} g[d, h, w, co]
//                            * x[2d+kd-2, 2h+kh-2, 2w+kw-2, ci]
// (x zero outside the volume) in float32, (64, 8, 5, 5, 5) over x padded to
// 8 channels (the wrapper keeps cin): folded tap k and block position r are
// direct tap 2 k + r, and the 91 folded taps a channel that meet the
// weight fold's zero 6th tap are not computed. The TPU kernel's halo DMA
// per depth block and 128-lane channel padding are Mosaic constraints and
// are not carried over.
//
// What bounds it on the H100: the tensor cores. The step's shape (xf 56 x
// 64^3) is 29.4 GFLOP of bf16 products for the 7 real channels (0.030 ms at
// 989 TFLOP/s; 33.6 GFLOP, 0.034 ms, for the 8 multiplied) against 63 MB of
// xf, g and dW (0.019 ms at 3.35 TB/s).
//
// As a product it is M = 64 output channels by N = 1000 (125 taps x 8
// channels) over K = Do Ho Wo output voxels (262,144 at the step), split-K
// over slices of the output voxels. Three launches:
//  1. stem_split_kernel unfolds xf into a scratch volume (D, H, 2, W/2,
//     8): each voxel of x its own 16-byte row, the channels padded to 8,
//     and the even and odd w positions of each (d, h) line apart, each
//     parity's line contiguous. Each thread takes one of a folded voxel's
//     8 channel blocks (cin channels), so that a warp reads 4 whole folded
//     voxels (448 contiguous bytes in bf16) and writes rows of 8 lines;
//     the block's position in the 2^3 block names its line (d, h) and its
//     parity. A stride-2 conv reads every other w position for a tap,
//     and wgmma's B wants 16-byte rows one after the other; the split,
//     made once, lets one TMA box row carry a parity's whole line (288
//     bytes) where boxes of 16-byte voxels, gathered at a stride of two,
//     bound the kernel (PERF.md);
//  2. stem_wgrad_wgmma_kernel (bf16) or stem_wgrad_f32_kernel: blockIdx.x
//     takes one slice of the output bricks (2 x 4 x 16 output voxels in
//     bf16, 1 x 4 x 16 in f32), walked in order; each brick stages its g tile
//     (voxels x 64) and the input brick it reads from the split volume,
//     (2b+3) voxels an axis, so that the 16 voxels of a brick row read 16
//     consecutive 16-byte rows for any tap. Each block writes its partial
//     dW to its own slice;
//  3. stem_reduce_kernel sums the slices in a fixed order: dW is
//     deterministic (no atomics), two launches bitwise equal.
//
// bf16, on wgmma (the design):
//  - Operands turned around: A = g^T (M = the 64 output channels, K = the 16
//    output voxels of a brick row), held in registers as each warp's
//    m16n8k16 fragment (ldmatrix.x4.trans of the g tile); one A fragment a
//    brick row serves every tap group of the warpgroup.
//  - B = the staged input brick read in place: for tap (kd, kh, kw) and the
//    16 voxels of a brick row, the 16 input rows are consecutive, so a core
//    matrix (8 voxels x 8 channels) is 128 contiguous bytes, and the 5 kh
//    taps of one (kd, kw) pair lie one staged line (576 bytes) apart. One
//    wgmma m64n40k16 takes the 5 kh taps x 8 channels of a (kd, kw) group
//    through an MN-major no-swizzle descriptor (leading offset 128 between
//    k neighbours, stride offset 576 between n neighbours); the 25 groups
//    cover the 125 taps exactly, none padded.
//  - Warp specialisation: blockIdx.y takes 13 or 12 of the 25 groups; its
//    two consumer warpgroups split them (7 + 6 or 6 + 6; 20 f32
//    accumulators a group a thread, 140 at most, setmaxnreg 232) and one
//    thread of the producer warpgroup (setmaxnreg 40) stages the bricks into
//    a ring of three stages with two TMA tensor copies a brick: the input
//    brick from the split volume (box: 7 d x 11 h x 2 parities x 18 w x 8
//    channels, rows of 288 bytes) and the g tile (128-byte swizzle, so the
//    ldmatrix rows fall in distinct banks). TMA's zero fill outside a map
//    gives the conv's padding and the ragged edges. The tensor maps are
//    encoded on the host at each launch (cuTensorMapEncodeTiled, looked up
//    at run time, so the library links no libcuda). Staging with 16-byte
//    cp.async instead was bound by the copies in flight (PERF.md).
//  - Each blockIdx.x stages its bricks in both blockIdx.y blocks (a cluster
//    multicast of the brick is left for later).
//  - The partials are stored in the accumulators' own layout (a warp's
//    stores are 128 contiguous bytes), which the reduction maps to dW.
// f32 (for checks in f32): every thread stages from the split volume
// (cp.async, two stages) and each holds 8 output x 8 input channels of 2
// taps, FMAs on the CUDA cores; blockIdx.y takes taps [64 y, 64 y + 64).

#include <cuda.h>  // CUtensorMap and its enums; no libcuda link

#include "pe_mlp_common.cuh"

namespace {

constexpr int kCin = 8;     // the kernel's input channels
constexpr int kCout = 64;   // the stem's output channels
constexpr int kTaps = 125;  // 5 x 5 x 5
constexpr int kBW = 16;     // output voxels along w in a brick row
constexpr int kIW = 2 * kBW + 3;       // input voxels along w a brick reads
constexpr int kHalfW = (kIW + 1) / 2;  // even (18) and odd (17) w positions
constexpr int kTotal = kCout * kCin * kTaps;

// f32 kernel
constexpr int kF32Threads = 256;
constexpr int kTapsPerBlock = 64;  // blockIdx.y: taps [64 y, 64 y + 64)

// bf16 wgmma kernel
constexpr int kGroups = 25;        // (kd, kw) pairs, 5 kh taps each
constexpr int kCtaGroups = 13;     // blockIdx.y 0: groups 0-12, 1: 13-24
constexpr int kMaxWgGroups = 7;    // a consumer warpgroup's groups
constexpr int kStages = 3;

struct StemGeo {
  int D, H, W;       // input volume
  int Do, Ho, Wo;    // output volume (64 channels)
  int nbh, nbw, nbricks;
  int slices;
};

// Brick geometry by element type: bf16 bricks are 2 x 4 x 16 output voxels
// (8 k16 steps), f32 bricks 1 x 4 x 16 (two stages of f32 must fit 227 KB).
template <typename T>
struct Brick {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BD = kBf16 ? 2 : 1, BH = 4;
  static constexpr int kVox = BD * BH * kBW;
  static constexpr int ID = 2 * BD + 3, IH = 2 * BH + 3;
};

using Bb = Brick<__nv_bfloat16>;
using Bf = Brick<float>;

// A bf16 stage (bytes): the input brick (ID x IH lines, each its even then
// its odd 18 positions, rows of 16 bytes), then 1024-aligned the g tile
// (128 voxel rows of 128 bytes, 128-byte swizzle).
struct Stage {
  static constexpr uint32_t kLine = 2 * kHalfW * kCin * 2;  // (d, h): kh + 1
  static constexpr uint32_t kXBytes = Bb::ID * Bb::IH * kLine;
  static constexpr uint32_t kG = (kXBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kGBytes = Bb::kVox * kCout * 2;
  static constexpr uint32_t kBytes = kG + kGBytes;
  static constexpr uint32_t kTx = kXBytes + kGBytes;  // a brick's copies
};

// Row (16 bytes, 8 channels) of input position (id, ih, iw) of a staged
// brick, both types: line (id, ih), its parity iw & 1, position iw >> 1.
template <typename T>
__device__ __forceinline__ int xrow(int id, int ih, int iw) {
  return ((id * Brick<T>::IH + ih) * 2 + (iw & 1)) * kHalfW + (iw >> 1);
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 4-d box of `map` at (c0, c1, c2, c3) into shared memory, counted on
// `bar` (bytes, zeros where the box leaves the tensor).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Slice blockIdx.x's bricks [b0, b1).
__device__ __forceinline__ void brick_range(const StemGeo& s, int& b0,
                                            int& b1) {
  b0 = int((long long)blockIdx.x * s.nbricks / s.slices);
  b1 = int((long long)(blockIdx.x + 1) * s.nbricks / s.slices);
}

// Output origin (d0, h0, w0) of brick b, w fastest.
template <typename T>
__device__ __forceinline__ void brick_origin(const StemGeo& s, int b, int& d0,
                                             int& h0, int& w0) {
  const int rest = b / s.nbw;
  w0 = (b % s.nbw) * kBW;
  h0 = (rest % s.nbh) * Brick<T>::BH;
  d0 = (rest / s.nbh) * Brick<T>::BD;
}

// ---- bf16: wgmma

// A consumer warpgroup's (kd, kw) groups: [first, first + count).
__device__ __forceinline__ int wg_first_group(int y, int c) {
  const int cta_count = y ? kGroups - kCtaGroups : kCtaGroups;
  return y * kCtaGroups + (c ? (cta_count + 1) / 2 : 0);
}
__device__ __forceinline__ int wg_group_count(int y, int c) {
  const int cta_count = y ? kGroups - kCtaGroups : kCtaGroups;
  return c ? cta_count / 2 : (cta_count + 1) / 2;
}

// Bytes from a brick row's (kd, kh, kw) = (0, 0, 0) row to group G's
// (kd, 0, kw) row.
__device__ __forceinline__ uint32_t group_bytes(int G) {
  const int kd = G / 5, kw = G % 5;
  return 16u * uint32_t(xrow<__nv_bfloat16>(kd, 0, kw));
}

// The consumer warpgroup's walk with NG groups: brick row r of a stage is
// the k16 step (its 16 voxels), the A fragment of warp wq (output channels
// 16 wq ..) loaded once and used by the NG wgmmas; two fragments alternate
// so that row r's loads wait only for row r - 2's wgmmas. A stage is
// released once its last row's wgmmas completed (in the next brick's first
// row, or after the walk).
template <int NG>
__device__ __forceinline__ void consume(float (&acc)[kMaxWgGroups][20],
                                        unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int b0, int b1,
                                        int first, int wq, int lane) {
  uint32_t goff[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) goff[j] = group_bytes(first + j);
  const uint64_t desc0 = wgmma_desc(smem, 128, Stage::kLine);
  const int r8 = lane & 7, mat = lane >> 3;
  // g tile: voxel v's 16-byte chunk c sits at chunk c ^ (v % 8) of its row
  const uint32_t a_lane = Stage::kG + 128u * uint32_t((mat >> 1) * 8 + r8) +
                          16u * uint32_t((wq * 2 + (mat & 1)) ^ r8);
  uint32_t af[2][4];
  int held = -1;  // the stage whose release waits for its last wgmmas
  for (int b = b0; b < b1; ++b) {
    const int i = b - b0, st = i % kStages;
    mbar_wait(full + st, (i / kStages) & 1);
    const uint32_t xoff = uint32_t(st) * Stage::kBytes;
#pragma unroll
    for (int r = 0; r < Bb::BD * Bb::BH; ++r) {
      const int bd = r / Bb::BH, bh = r % Bb::BH;
      ldmatrix_x4_trans(af[r & 1], smem + xoff + a_lane + 128u * (r * kBW));
      wgmma_fence();
      const uint32_t row =
          xoff + 16u * uint32_t(xrow<__nv_bfloat16>(2 * bd, 2 * bh, 0));
#pragma unroll
      for (int j = 0; j < NG; ++j)
        wgmma_rs_n40<1>(acc[j], af[r & 1], desc0 + ((row + goff[j]) >> 4));
      wgmma_commit();
      wgmma_wait_one();
      if (r == 0 && held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + held);
      }
    }
    held = st;
  }
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NG; ++j) fence_regs(acc[j]);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    stem_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap g_map,
                            float* __restrict__ part, StemGeo s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * Stage::kBytes);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b0, b1;
  brick_range(s, b0, b1);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    regs_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      for (int b = b0; b < b1; ++b) {
        const int i = b - b0, st = i % kStages;
        if (i >= kStages) mbar_wait(empty + st, (i / kStages - 1) & 1);
        int d0, h0, w0;
        brick_origin<__nv_bfloat16>(s, b, d0, h0, w0);
        unsigned char* dst = smem + st * Stage::kBytes;
        mbar_expect_tx(full + st, Stage::kTx);
        // the split volume's (8 (w >> 1) + channel, parity, h, d) of input
        // position (2 d0 - 2 + id, 2 h0 - 2 + ih, 2 w0 - 2 + iw)
        tma_load_4d(dst, &x_map, full + st, 8 * (w0 - 1), 0, 2 * h0 - 2,
                    2 * d0 - 2);
        tma_load_4d(dst + Stage::kG, &g_map, full + st, 0, w0, h0, d0);
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();

  const int c = warp >> 2, wq = warp & 3;
  const int first = wg_first_group(blockIdx.y, c);
  const int count = wg_group_count(blockIdx.y, c);
  float acc[kMaxWgGroups][20];
#pragma unroll
  for (int j = 0; j < kMaxWgGroups; ++j) zero(acc[j]);
  if (count == kMaxWgGroups)
    consume<kMaxWgGroups>(acc, smem, full, empty, b0, b1, first, wq, lane);
  else
    consume<kMaxWgGroups - 1>(acc, smem, full, empty, b0, b1, first, wq, lane);

  // the slice's partial in the accumulators' own layout, (group, register,
  // thread of the warpgroup): a warp's stores are 128 contiguous bytes;
  // stem_reduce_kernel maps it to dW (frag_to_dw)
  float* pw = part + size_t(blockIdx.x) * kTotal + wq * 32 + lane;
#pragma unroll
  for (int j = 0; j < kMaxWgGroups; ++j) {
    if (j >= count) continue;
#pragma unroll
    for (int e = 0; e < 20; ++e) pw[((first + j) * 20 + e) * 128] = acc[j][e];
  }
}

// The dW index of entry i of a wgmma partial, i = (G 20 + e) 128 + t:
// register e of thread t (warp wq = t / 32, lane = t % 32) of the
// warpgroup holding group G = (kd, kw) is output channel co = 16 wq +
// lane / 4 + 8 ((e >> 1) & 1) and n = 8 (e >> 2) + 2 (lane % 4) + (e & 1),
// i.e. tap kh = e >> 2 and input channel ci = 2 (lane % 4) + (e & 1).
__device__ __forceinline__ int frag_to_dw(int i) {
  const int t = i & 127, e = (i >> 7) % 20, G = (i >> 7) / 20;
  const int lane = t & 31, kd = G / 5, kw = G % 5, kh = e >> 2;
  const int co = (t >> 5) * 16 + (lane >> 2) + 8 * ((e >> 1) & 1);
  const int ci = 2 * (lane & 3) + (e & 1);
  return (co * kCin + ci) * kTaps + kd * 25 + kh * 5 + kw;
}

// ---- f32: CUDA cores

constexpr int kF32GLd = kCout + 4;  // g tile row stride
constexpr int kF32XElems = Bf::ID * Bf::IH * 2 * kHalfW * kCin;
constexpr size_t kF32StageBytes =
    size_t(kF32XElems + Bf::kVox * kF32GLd) * sizeof(float);

// Starts the cp.async copies of brick `b`: its input brick from the split
// volume x (zeros outside the volume) into xs and its g tile (zeros past
// the output's edge) into gs.
__device__ __forceinline__ void stage_brick_f32(float* xs, float* gs,
                                                const float* __restrict__ x,
                                                const float* __restrict__ g,
                                                const StemGeo& s, int b) {
  int d0, h0, w0;
  brick_origin<float>(s, b, d0, h0, w0);
  constexpr int kPos = Bf::ID * Bf::IH * kIW;
  for (int i = threadIdx.x; i < kPos * 2; i += blockDim.x) {
    const int c = i & 1, pos = i >> 1;  // two 16-byte chunks a voxel
    const int iw = pos % kIW, r = pos / kIW;
    const int ih = r % Bf::IH, id = r / Bf::IH;
    const int gd = 2 * d0 - 2 + id, gh = 2 * h0 - 2 + ih, gw = 2 * w0 - 2 + iw;
    const bool ok = gd >= 0 && gd < s.D && gh >= 0 && gh < s.H && gw >= 0 &&
                    gw < s.W;
    const size_t line = (size_t(gd) * s.H + gh) * 2 + (gw & 1);
    const float* src =
        ok ? x + (line * ((s.W + 1) / 2) + (gw >> 1)) * kCin + c * 4 : x;
    cp_async16_zfill(xs + xrow<float>(id, ih, iw) * kCin + c * 4, src, ok);
  }
  constexpr int per_vox = kCout / 4;
  for (int i = threadIdx.x; i < Bf::kVox * per_vox; i += blockDim.x) {
    const int c = i % per_vox, v = i / per_vox;
    const int oh = h0 + v / kBW, ow = w0 + v % kBW;  // BD == 1
    const bool ok = d0 < s.Do && oh < s.Ho && ow < s.Wo;
    const float* src =
        ok ? g + ((size_t(d0) * s.Ho + oh) * s.Wo + ow) * kCout + c * 4 : g;
    cp_async16_zfill(gs + v * kF32GLd + c * 4, src, ok);
  }
}

// The shared-memory row offset (in elements) of tap t relative to the
// voxel (0, 0, w) of a brick row: input position (kd, kh, kw + 2w).
__device__ __forceinline__ int tap_offset_f32(int t) {
  const int kd = t / 25, kh = (t / 5) % 5, kw = t % 5;
  return xrow<float>(kd, kh, kw) * kCin;
}

// thread (cg = tid % 8, tp = tid / 8) holds output channels 8 cg .. +7 of
// taps 64 y + 2 tp, +1, all 8 input channels. Bricks walked in order with
// two stages: brick i + 1's copies are in flight while brick i is consumed.
__global__ void __launch_bounds__(kF32Threads, 1)
    stem_wgrad_f32_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,
                          float* __restrict__ part, StemGeo s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stage[2] = {reinterpret_cast<float*>(smem_raw),
                     reinterpret_cast<float*>(smem_raw + kF32StageBytes)};
  const int cg = threadIdx.x & 7, tp = threadIdx.x >> 3;
  const int tap0 = blockIdx.y * kTapsPerBlock + 2 * tp;
  int toff[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    toff[j] = tap0 + j < kTaps ? tap_offset_f32(tap0 + j) : 0;
  float acc[2][8][8];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][i][c] = 0.0f;

  int b0, b1;
  brick_range(s, b0, b1);
  if (b0 < b1) stage_brick_f32(stage[0], stage[0] + kF32XElems, x, g, s, b0);
  cp_async_commit();
  for (int b = b0; b < b1; ++b) {
    const float* xs = stage[(b - b0) & 1];
    const float* gs = xs + kF32XElems;
    if (b + 1 < b1) {
      float* nxt = stage[(b + 1 - b0) & 1];
      stage_brick_f32(nxt, nxt + kF32XElems, x, g, s, b + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int v = 0; v < Bf::kVox; ++v) {
      const int bh = v / kBW, bw = v % kBW;
      const float4* gv4 =
          reinterpret_cast<const float4*>(gs + v * kF32GLd + 8 * cg);
      const float4 ga = gv4[0], gb = gv4[1];
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float* xr = xs + xrow<float>(0, 2 * bh, 2 * bw) * kCin;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4* xv4 = reinterpret_cast<const float4*>(xr + toff[j]);
        const float4 xa = xv4[0], xb = xv4[1];
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[j][i][c] = fmaf(gv[i], xv[c], acc[j][i][c]);
      }
    }
    __syncthreads();
  }

  float* pw = part + size_t(blockIdx.x) * kTotal;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = tap0 + j;
    if (t >= kTaps) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        pw[((8 * cg + i) * kCin + c) * kTaps + t] = acc[j][i][c];
  }
}

// xf (Df, Hf, Wf, 8 cin) folded -> xs (2 Df, 2 Hf, 2, Wf, 8): thread i =
// 8 v + b takes block b = (fd, fh, fw) of folded voxel v = (dd Hf + hh) Wf
// + k, the cin channels of x[2 dd + fd, 2 hh + fh, 2 k + fw] (consecutive
// threads read consecutive blocks), and writes them as that voxel's row
// of line (2 dd + fd, 2 hh + fh), parity fw, position k, the channels past
// cin zero.
template <typename T>
__global__ void stem_split_kernel(const T* __restrict__ xf, T* __restrict__ xs,
                                  int Df, int Hf, int Wf, int cin) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)Df * Hf * Wf * 8) return;
  const int b = int(i & 7);
  const long long v = i >> 3;
  const int k = int(v % Wf);
  const long long dh = v / Wf;  // dd Hf + hh
  const int hh = int(dh % Hf), dd = int(dh / Hf);
  const long long line = (2LL * dd + (b >> 2)) * (2 * Hf) + 2 * hh + ((b >> 1) & 1);
  const T* src = xf + i * cin;
  __align__(16) T row[kCin];
#pragma unroll
  for (int c = 0; c < kCin; ++c) row[c] = c < cin ? src[c] : T(0.0f);
  const uint4* from = reinterpret_cast<const uint4*>(row);
  uint4* dst = reinterpret_cast<uint4*>(xs + ((line * 2 + (b & 1)) * Wf + k) * kCin);
#pragma unroll
  for (int q = 0; q < int(kCin * sizeof(T) / 16); ++q) dst[q] = from[q];
}

// The sum over the slices c of part[c * kTotal + i], c in order, to out[i]
// (f32 partials, in dW's layout) or to out[frag_to_dw(i)] (wgmma partials).
__global__ void stem_reduce_kernel(const float* __restrict__ part, int slices,
                                   int frag, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kTotal) return;
  float acc = 0.0f;
  for (int c = 0; c < slices; ++c) acc += part[size_t(c) * kTotal + i];
  out[frag ? frag_to_dw(i) : i] = acc;
}

// ---- host: tensor maps and launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d bf16 map: dims innermost first, the strides of dims 1-3 in bytes,
// zeros outside.
bool map_4d(CUtensorMap* m, const void* base, const cuuint64_t (&dims)[4],
            const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t reduce(const float* part, float* out, int slices, bool frag,
                   cudaStream_t st) {
  stem_reduce_kernel<<<(kTotal + 255) / 256, 256, 0, st>>>(part, slices,
                                                           int(frag), out);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const __nv_bfloat16* xs, const __nv_bfloat16* g,
                        float* part, float* out, const StemGeo& s,
                        cudaStream_t st) {
  // the split volume as (8 (w >> 1) + channel, parity, h, d), a box a brick
  const cuuint64_t wh8 = cuuint64_t(s.W + 1) / 2 * kCin;
  const cuuint64_t x_dims[4] = {wh8, 2, cuuint64_t(s.H), cuuint64_t(s.D)};
  const cuuint64_t x_str[3] = {wh8 * 2, wh8 * 4, wh8 * 4 * s.H};
  const cuuint32_t x_box[4] = {kHalfW * kCin, 2, Bb::IH, Bb::ID};
  const cuuint64_t g_dims[4] = {kCout, cuuint64_t(s.Wo), cuuint64_t(s.Ho),
                                cuuint64_t(s.Do)};
  const cuuint64_t g_str[3] = {kCout * 2ull, cuuint64_t(s.Wo) * kCout * 2,
                               cuuint64_t(s.Ho) * s.Wo * kCout * 2};
  const cuuint32_t g_box[4] = {kCout, kBW, Bb::BH, Bb::BD};
  CUtensorMap xm, gm;
  if (!map_4d(&xm, xs, x_dims, x_str, x_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !map_4d(&gm, g, g_dims, g_str, g_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const size_t smem = kStages * Stage::kBytes + 1024 + 2 * kStages * 8;
  cudaError_t err = cudaFuncSetAttribute(
      stem_wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  stem_wgrad_wgmma_kernel<<<dim3(s.slices, 2), kWgThreads, smem, st>>>(
      xm, gm, part, s);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : reduce(part, out, s.slices, true, st);
}

cudaError_t launch_f32(const float* xs, const float* g, float* part,
                       float* out, const StemGeo& s, cudaStream_t st) {
  const size_t smem = 2 * kF32StageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      stem_wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  stem_wgrad_f32_kernel<<<dim3(s.slices, 2), kF32Threads, smem, st>>>(
      xs, g, part, s);
  err = cudaGetLastError();
  return err != cudaSuccess ? err : reduce(part, out, s.slices, false, st);
}

template <typename T>
cudaError_t launch(const void* xf, void* xs, const void* g, float* part,
                   float* out, int cin, const StemGeo& s, cudaStream_t st) {
  const long long n = (long long)s.Do * s.Ho * s.Wo * 8;
  stem_split_kernel<T><<<unsigned((n + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(xf), static_cast<T*>(xs), s.Do, s.Ho, s.Wo, cin);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2)
    return launch_bf16(static_cast<const T*>(xs), static_cast<const T*>(g),
                       part, out, s, st);
  else
    return launch_f32(static_cast<const T*>(xs), static_cast<const T*>(g),
                      part, out, s, st);
}

}  // namespace

extern "C" {

// Launches the stem weight gradient on `stream`: the folded volume xf (Df,
// Hf, Wf, 8 cin), cin <= 8, and g (Do, Ho, Wo, 64) = (Df, Hf, Wf, 64), both
// contiguous, bf16 (bf16 != 0) or f32, -> out (64, 8, 5, 5, 5) f32 (the
// channels past cin zero). xs (8 Df Hf 2 Wf 8 elements of xf's type) and
// part (slices x 64 x 8 x 125 f32) are scratch; slices must not exceed the
// bricks (the wrapper's launch plan). Returns the first cudaError_t.
int neraf_stem_wgrad_launch(const void* xf, const void* g, void* xs,
                            float* part, float* out, int Df, int Hf, int Wf,
                            int cin, int Do, int Ho, int Wo, int slices,
                            int bf16, void* stream) {
  if (Df < 1 || Hf < 1 || Wf < 1 || cin < 1 || cin > kCin || Do != Df ||
      Ho != Hf || Wo != Wf || slices < 1)
    return int(cudaErrorInvalidValue);
  StemGeo s{2 * Df, 2 * Hf, 2 * Wf, Do, Ho, Wo, 0, 0, 0, slices};
  s.nbw = (Wo + kBW - 1) / kBW;
  const int bd = bf16 ? Bb::BD : Bf::BD, bh = bf16 ? Bb::BH : Bf::BH;
  s.nbh = (Ho + bh - 1) / bh;
  s.nbricks = ((Do + bd - 1) / bd) * s.nbh * s.nbw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch<__nv_bfloat16>(xf, xs, g, part, out, cin, s, st)
                  : launch<float>(xf, xs, g, part, out, cin, s, st));
}

}  // extern "C"
