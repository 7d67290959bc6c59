// Weight gradient of the ResNet3D stem convolution for Hopper (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/stem_wgrad_kernel.py::stem_wgrad_pallas
// (kernel body :34-58), which the JAX package runs inside the joint train
// step's backward when NERAF_STEM_WGRAD_PALLAS=1. The port's stem is the
// direct conv3d, kernel 5, stride 2, padding 2, of a batch-1 NDHWC volume
// x (D, H, W, cin <= 8) into 64 channels (Do, Ho, Wo) = ((D-1)/2 + 1, ...).
// For the output cotangent g (Do, Ho, Wo, 64), channels innermost, it
// returns
//   dW[co, ci, kd, kh, kw] = sum_{d,h,w} g[d, h, w, co]
//                            * x[2d+kd-2, 2h+kh-2, 2w+kw-2, ci]
// (x zero outside the volume) in float32, in the (64, cin, 5, 5, 5) layout
// of the torch Conv3d weight. The TPU kernel computes the same function on
// the space-to-depth folded volume (k3/s1 over 56 channels, the 6th tap of
// each axis a zero pad); its halo DMA per depth block and 128-lane channel
// padding are Mosaic constraints and are not carried over.
//
// As a product it is tall and skinny: M = cout = 64 by N = cin x 125 taps
// (875) over K = Do Ho Wo output voxels (262,144 at the step's 7 x 128^3
// grid). Three launches:
//  1. stem_pack_kernel copies x into a scratch volume with cin padded to 8
//     zeros (16 bytes a voxel in bf16), so that every voxel is one aligned
//     16-byte cp.async;
//  2. stem_wgrad_{bf16,f32}_kernel: blockIdx.y takes 64 of the 125 taps,
//     blockIdx.x one slice of the output bricks (2 x 4 x 16 output voxels
//     in bf16, 1 x 4 x 16 in f32), walked in order and double-buffered with
//     cp.async: each brick stages its g tile (voxels x 64) and the input
//     brick it reads, (2b+3) voxels an axis, with the even and odd w
//     positions apart, so that the 8 voxels of an ldmatrix row group read 8
//     consecutive 16-byte rows whatever the tap. bf16: each warp holds 8
//     taps x 64 channels in mma.sync m16n8k16 accumulators (f32); a k16
//     step is 16 output voxels along w, its A fragments (g, 16 voxels x 16 channels)
//     are loaded once with ldmatrix.trans and used for the 8 taps, each tap's
//     B fragment (16 voxels x 8 padded input channels) is one
//     ldmatrix.x2.trans whose 16 row addresses are the strided input voxels.
//     f32: each thread holds 8 output x 8 input channels of 2 taps, FMAs on
//     the CUDA cores. Each block writes its partial dW to its own slice;
//  3. stem_reduce_kernel sums the slices in a fixed order: dW is
//     deterministic (no atomics).
//
// What bounds it on the H100: the tensor cores. The step's shape is 29.4
// GFLOP of bf16 products (0.030 ms at 989 TFLOP/s) against 63.1 MB of x, g
// and dW (0.019 ms at 3.35 TB/s); padding cin to 8 adds 1/7 to the products.
// mma.sync with one ldmatrix per tap and four mma reaches a fraction of the
// peak; wgmma, TMA and input bricks shared between neighbouring slices are
// left for later. The partial slices are slices x 64 x 875 f32 (14.8 MB at
// 66 slices), read once by the reduction from the L2.

#include "pe_mlp_common.cuh"

namespace {

constexpr int kStemThreads = 256;  // 8 warps
constexpr int kTaps = 125;         // 5 x 5 x 5
constexpr int kTapsPerBlock = 64;  // blockIdx.y: taps [64 y, 64 y + 64)
constexpr int kCinPad = 8;         // input channels padded to 8
constexpr int kCout = 64;          // the stem's output channels
constexpr int kBW = 16;            // output voxels along w in a brick row
constexpr int kIW = 2 * kBW + 3;   // input voxels along w a brick reads
constexpr int kHalfW = (kIW + 1) / 2;  // even (18) and odd (17) w positions

struct StemGeo {
  int D, H, W, cin;  // input volume, NDHWC
  int Do, Ho, Wo;    // output volume (64 channels)
  int nbh, nbw, nbricks;
  int total;         // 64 * cin * 125
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
  static constexpr int kGLd = kCout + (kBf16 ? 8 : 4);  // g tile row stride
  static constexpr int kXElems = ID * IH * 2 * kHalfW * kCinPad;
  static constexpr int kGElems = kVox * kGLd;
  static constexpr int kVec = 16 / int(sizeof(T));  // elements per 16 bytes
  static constexpr size_t kStageBytes = size_t(kXElems + kGElems) * sizeof(T);
};

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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Row of input position (id, ih, iw) of a staged brick: the even and odd w
// positions of each (id, ih) line are kept apart.
template <typename T>
__device__ __forceinline__ int xrow(int id, int ih, int iw) {
  return ((id * Brick<T>::IH + ih) * 2 + (iw & 1)) * kHalfW + (iw >> 1);
}

// The shared-memory row offset (in elements) of tap t relative to the
// voxel (0, 0, w) of a brick row: input position (kd, kh, kw + 2w).
template <typename T>
__device__ __forceinline__ int tap_offset(int t) {
  const int kd = t / 25, kh = (t / 5) % 5, kw = t % 5;
  return xrow<T>(kd, kh, kw) * kCinPad;
}

// Starts the cp.async copies of brick `b`: its input brick (zeros outside
// the volume) into xs and its g tile (zeros past the output's edge) into gs.
template <typename T>
__device__ __forceinline__ void stage_brick(T* xs, T* gs,
                                            const T* __restrict__ xp,
                                            const T* __restrict__ g,
                                            const StemGeo& s, int b) {
  using B = Brick<T>;
  const int bw = b % s.nbw, rest = b / s.nbw;
  const int d0 = (rest / s.nbh) * B::BD, h0 = (rest % s.nbh) * B::BH;
  const int w0 = bw * kBW;
  constexpr int kChunks = kCinPad / B::kVec;  // 16-byte chunks per voxel
  constexpr int kPos = B::ID * B::IH * kIW;
  for (int i = threadIdx.x; i < kPos * kChunks; i += blockDim.x) {
    const int c = i % kChunks, pos = i / kChunks;
    const int iw = pos % kIW, r = pos / kIW;
    const int ih = r % B::IH, id = r / B::IH;
    const int gd = 2 * d0 - 2 + id, gh = 2 * h0 - 2 + ih, gw = 2 * w0 - 2 + iw;
    const bool ok = gd >= 0 && gd < s.D && gh >= 0 && gh < s.H && gw >= 0 &&
                    gw < s.W;
    const T* src = ok ? xp + ((size_t(gd) * s.H + gh) * s.W + gw) * kCinPad +
                            c * B::kVec
                      : xp;
    cp_async16_zfill(xs + xrow<T>(id, ih, iw) * kCinPad + c * B::kVec, src, ok);
  }
  constexpr int per_vox = kCout / B::kVec;
  for (int i = threadIdx.x; i < B::kVox * per_vox; i += blockDim.x) {
    const int c = i % per_vox, v = i / per_vox;
    const int od = d0 + v / (B::BH * kBW), oh = h0 + (v / kBW) % B::BH;
    const int ow = w0 + v % kBW;
    const bool ok = od < s.Do && oh < s.Ho && ow < s.Wo;
    const T* src = ok ? g + ((size_t(od) * s.Ho + oh) * s.Wo + ow) * kCout +
                            c * B::kVec
                      : g;
    cp_async16_zfill(gs + v * B::kGLd + c * B::kVec, src, ok);
  }
}

// Walks this block's bricks in order with two stages: brick i + 1's copies
// are in flight while brick i is consumed by `body(xs, gs)`.
template <typename T, typename Body>
__device__ __forceinline__ void walk_bricks(const T* __restrict__ xp,
                                            const T* __restrict__ g,
                                            const StemGeo& s, Body body) {
  using B = Brick<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage[2] = {reinterpret_cast<T*>(smem),
                 reinterpret_cast<T*>(smem + B::kStageBytes)};
  const int b0 = int((long long)blockIdx.x * s.nbricks / s.slices);
  const int b1 = int((long long)(blockIdx.x + 1) * s.nbricks / s.slices);
  if (b0 < b1) stage_brick<T>(stage[0], stage[0] + B::kXElems, xp, g, s, b0);
  cp_async_commit();
  for (int b = b0; b < b1; ++b) {
    T* cur = stage[(b - b0) & 1];
    if (b + 1 < b1) {
      T* nxt = stage[(b + 1 - b0) & 1];
      stage_brick<T>(nxt, nxt + B::kXElems, xp, g, s, b + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(cur, cur + B::kXElems);
    __syncthreads();
  }
}

// bf16: warp w of blockIdx.y holds taps 64 y + 8 w + j (j < 8) x the 4 m16
// tiles of output channels.
__global__ void __launch_bounds__(kStemThreads, 1)
    stem_wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ xp,
                           const __nv_bfloat16* __restrict__ g,
                           float* __restrict__ part, StemGeo s) {
  using T = __nv_bfloat16;
  using B = Brick<T>;
  constexpr int MT = kCout / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tap0 = blockIdx.y * kTapsPerBlock + warp * 8;
  int toff[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    toff[j] = tap0 + j < kTaps ? tap_offset<T>(tap0 + j) : 0;
  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.0f;
  const int r8 = lane & 7, mat = lane >> 3;
  const int bw = lane & 15;  // lanes 0-15 address the B rows: voxel w

  walk_bricks<T>(xp, g, s, [&](const T* xs, const T* gs) {
#pragma unroll 1
    for (int step = 0; step < B::BD * B::BH; ++step) {  // one output row
      const int bd = step / B::BH, bh = step % B::BH;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(af[mt], gs + (step * kBW + (mat >> 1) * 8 + r8) *
                                           B::kGLd + mt * 16 + (mat & 1) * 8);
      const T* xr = xs + xrow<T>(2 * bd, 2 * bh, 2 * bw) * kCinPad;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, xr + toff[j]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[j][mt], af[mt], b[0], b[1]);
      }
    }
  });

  // accumulator e of tile (j, mt): channel co = 16 mt + g + 8 (e >> 1),
  // input channel ci = 2 q + (e & 1)
  float* pw = part + size_t(blockIdx.x) * s.total;
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = tap0 + j;
    if (t >= kTaps) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = mt * 16 + gq + (e >> 1) * 8, ci = 2 * q + (e & 1);
        if (ci < s.cin) pw[(co * s.cin + ci) * kTaps + t] = acc[j][mt][e];
      }
  }
}

// f32: thread (cg = tid % 8, tp = tid / 8) holds output channels 8 cg .. +7
// of taps 64 y + 2 tp, +1, all 8 padded input channels.
__global__ void __launch_bounds__(kStemThreads, 1)
    stem_wgrad_f32_kernel(const float* __restrict__ xp,
                          const float* __restrict__ g,
                          float* __restrict__ part, StemGeo s) {
  using B = Brick<float>;
  const int cg = threadIdx.x & 7, tp = threadIdx.x >> 3;
  const int tap0 = blockIdx.y * kTapsPerBlock + 2 * tp;
  int toff[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    toff[j] = tap0 + j < kTaps ? tap_offset<float>(tap0 + j) : 0;
  float acc[2][8][8];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][i][c] = 0.0f;

  walk_bricks<float>(xp, g, s, [&](const float* xs, const float* gs) {
#pragma unroll 1
    for (int v = 0; v < B::kVox; ++v) {
      const int bh = v / kBW, bw = v % kBW;  // BD == 1
      const float4* gv4 = reinterpret_cast<const float4*>(gs + v * B::kGLd + 8 * cg);
      const float4 ga = gv4[0], gb = gv4[1];
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float* xr = xs + xrow<float>(0, 2 * bh, 2 * bw) * kCinPad;
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
  });

  float* pw = part + size_t(blockIdx.x) * s.total;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = tap0 + j;
    if (t >= kTaps) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < s.cin) pw[((8 * cg + i) * s.cin + c) * kTaps + t] = acc[j][i][c];
  }
}

// x (n_pos, cin) -> xp (n_pos, 8), the channels past cin zero.
template <typename T>
__global__ void stem_pack_kernel(const T* __restrict__ x, T* __restrict__ xp,
                                 int n_pos, int cin) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pos) return;
  __align__(16) T row[kCinPad];
#pragma unroll
  for (int c = 0; c < kCinPad; ++c)
    row[c] = c < cin ? x[size_t(i) * cin + c] : T(0.0f);
  const uint4* src = reinterpret_cast<const uint4*>(row);
  uint4* dst = reinterpret_cast<uint4*>(xp + size_t(i) * kCinPad);
#pragma unroll
  for (int k = 0; k < int(kCinPad * sizeof(T) / 16); ++k) dst[k] = src[k];
}

// out[i] = sum over the slices c of part[c * count + i], c in order.
__global__ void stem_reduce_kernel(const float* __restrict__ part, int slices,
                                   int count, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int c = 0; c < slices; ++c) acc += part[size_t(c) * count + i];
  out[i] = acc;
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const void* x, const void* g, void* xpad,
                   float* part, float* out, const StemGeo& s,
                   cudaStream_t st) {
  const int n_pos = s.D * s.H * s.W;
  stem_pack_kernel<T><<<(n_pos + 255) / 256, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(xpad), n_pos, s.cin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * Brick<T>::kStageBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s.slices, (kTaps + kTapsPerBlock - 1) / kTapsPerBlock),
           kStemThreads, smem, st>>>(static_cast<const T*>(xpad),
                                     static_cast<const T*>(g), part, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stem_reduce_kernel<<<(s.total + 255) / 256, 256, 0, st>>>(part, s.slices,
                                                            s.total, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the stem weight gradient on `stream`: x (D, H, W, cin) and g
// (Do, Ho, Wo, 64), both contiguous, bf16 (bf16 != 0) or f32, -> out
// (64, cin, 5, 5, 5) f32. xpad (D H W x 8 elements of x's type) and part
// (slices x 64 cin 125 f32) are scratch. Returns the first cudaError_t.
int neraf_stem_wgrad_launch(const void* x, const void* g, void* xpad,
                            float* part, float* out, int D, int H, int W,
                            int cin, int Do, int Ho, int Wo, int slices,
                            int bf16, void* stream) {
  if (D < 1 || H < 1 || W < 1 || cin < 1 || cin > kCinPad ||
      Do != (D - 1) / 2 + 1 || Ho != (H - 1) / 2 + 1 || Wo != (W - 1) / 2 + 1 ||
      slices < 1)
    return int(cudaErrorInvalidValue);
  StemGeo s{D, H, W, cin, Do, Ho, Wo, 0, 0, 0, kCout * cin * kTaps, slices};
  s.nbw = (Wo + kBW - 1) / kBW;
  const int bd = bf16 ? Brick<__nv_bfloat16>::BD : Brick<float>::BD;
  const int bh = bf16 ? Brick<__nv_bfloat16>::BH : Brick<float>::BH;
  s.nbh = (Ho + bh - 1) / bh;
  s.nbricks = ((Do + bd - 1) / bd) * s.nbh * s.nbw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return int(launch<float>(stem_wgrad_f32_kernel, x, g, xpad, part, out, s, st));
  return int(launch<__nv_bfloat16>(stem_wgrad_bf16_kernel, x, g, xpad, part,
                                   out, s, st));
}

}  // extern "C"
