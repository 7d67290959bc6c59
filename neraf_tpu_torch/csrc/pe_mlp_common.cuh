// Shared pieces of the fused PE+MLP kernels (pe_mlp.cu: forward,
// pe_mlp_bwd.cu: backward): the packed-layout constants, the range-reduced
// encoding, the Hopper primitives (mbarriers, bulk copies, wgmma), the
// weight ring and the register-resident wgmma row-tile engine; stem_wgrad.cu
// uses the primitives, ldmatrix and wgmma_rs_n40. Everything here has internal
// linkage, so each source gets its own copy.
//
// The bf16 row-tile engine (forward kernel, backward row-tile kernel): a
// block is two consumer warpgroups and one producer warpgroup (one thread
// of it issues the copies, and it hands its registers to the consumers:
// 232 a consumer thread, where 384 threads alone would get 168; the
// backward at HP 256 holds two 64-row layers of fragments and an
// accumulator at once). A warpgroup owns
// 64 rows; each warp 16 of them, held as the A operand of wgmma in
// registers (the fragment of mma.sync m16n8k16, warp w of the warpgroup on
// rows 16w .. 16w + 15). A layer is wgmma m64nNk16 with the weights as the
// B operand in shared memory; its f32 accumulator, after the bias add, the
// ReLU and a bf16 pack, is the A fragment of the next layer's k16 tiles, so
// no activation leaves the registers between layers.
//
// Weights (tile_layers in ops/pe_mlp.py): every layer of the packed layout
// (PyTorch's (out, in), zero-padded; the output layer's rows to opk, a
// multiple of 16) is cut into chunks of NC = min(HP, 128) rows (the output
// layer: one chunk of opk rows), and a chunk of NC x C is stored as 8 x 8
// core matrices (8 rows of 16 contiguous bytes, 128 bytes each), core
// matrix (i, j) (rows 8i.., columns 8j..) at byte (j NC / 8 + i) 128. That
// is the no-swizzle layout wgmma reads both ways: as K-major B with K = the
// columns (the forward, out = h W^T: leading byte offset NC 16 between k
// neighbours, stride byte offset 128 between n neighbours), and as
// MN-major B with K = the rows (the backward, dh = dpre W: leading offset
// 128, stride offset NC 16, the transpose bit set). One 1-D bulk copy lands
// a chunk ready; no transposed copy and no tensor map.
//
// The chunks reach shared memory through a ring of stages filled by one
// thread of the producer warpgroup with cp.async.bulk, completion counted on an mbarrier per
// stage, stages released by the eight consumer warps on a second mbarrier.
// When every chunk fits the ring (HP <= 128 at the fields' depths) the
// weights are loaded once per block and stay (resident); otherwise (HP 256:
// 64 KiB chunks, three stages) they stream in the order the layers use
// them, the next chunk arriving while the current one is in the products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;   // the f32 kernels
constexpr int kMaxK0 = 64;              // 6F + 3 <= 63, F <= 10
constexpr int kMaxOut = 32;
constexpr int kMaxHidden = 256;

constexpr int kF32Rows = 64;
constexpr int kF32K = 32;
constexpr int kF32Ld = kMaxHidden + 1;  // odd stride: conflict-free columns

// the bf16 wgmma kernels
constexpr int kWgRows = 64;                       // rows of a warpgroup
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kBlockRows = kWgRows * kConsumers;  // rows of a block's tile
// + a producer warpgroup, of which one thread issues the copies; it gives
// its registers to the consumers (setmaxnreg)
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kRingBytes = 192 * 1024;
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;                  // a block's limit, bytes

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
__host__ __device__ inline int ceil_to(int n, int m) { return (n + m - 1) / m * m; }

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

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---- Hopper: mbarriers, bulk copies, named barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- Hopper: wgmma

// Shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets (the PTX ISA's canonical layouts; see the note at
// the top for what they are in the weight layout).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the newest committed group completed
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pins an accumulator's registers at this point of the program: no read
// of them moves above the wait, no write below the first wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

// wgmma m64nNk16, f32 += bf16 x bf16, scale-d 1: rs takes A from
// registers (the m16n8k16 fragment of each warp's 16 rows) and B from the
// descriptor b (TB: 1 = B is MN-major); ss takes both from descriptors.
// One function per N, the accumulator's operands written out.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, %13;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
      "%17, %18, %19}, %20, 1, 1, 1, %21;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

// stem_wgrad.cu: 5 kh taps x 8 input channels
template <int TB>
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4],
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19}, {%20, %21, %22, %23}, %24, 1, 1, 1, %25;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4],
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, 1, "
      "1, 1, %29;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, %37;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
      "%67}, %68, 1, 1, 1, %69;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a,
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, %10, %11;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
      "%17, 1, 1, 1, %18, %19;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t a,
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23}, %24, %25, 1, 1, 1, %26, "
      "%27;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, 1, 1, 1, %34, %35;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(a), "l"(b), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, "
      "%66, %67;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a,
    uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, "
      "%68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
      "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "
      "%94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, 1, 1, 1, %130, %131;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "n"(TA), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16<TB>(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, b);
  else if constexpr (N == 48) wgmma_rs_n48<TB>(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, b);
  else {
    static_assert(N == 128, "wgmma_rs: N");
    wgmma_rs_n128<TB>(d, a, b);
  }
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (N == 16) wgmma_ss_n16<TA, TB>(d, a, b);
  else if constexpr (N == 32) wgmma_ss_n32<TA, TB>(d, a, b);
  else if constexpr (N == 48) wgmma_ss_n48<TA, TB>(d, a, b);
  else if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, a, b);
  else if constexpr (N == 128) wgmma_ss_n128<TA, TB>(d, a, b);
  else {
    static_assert(N == 256, "wgmma_ss: N");
    wgmma_ss_n256<TA, TB>(d, a, b);
  }
}

// ---- the weight ring

// Chunk geometry of the wgmma weight layout (tile_layers): layer l < L is
// HP x (l ? HP : k0p) in chunks of NC rows, layer L (the output) opk x HP
// in one chunk.
struct Chunks {
  int hp, k0p, opk, L, nc;
  __device__ int per_layer() const { return hp / nc; }
  __device__ int cols(int l) const { return l == 0 ? k0p : hp; }
  __device__ int rows(int l) const { return l == L ? opk : nc; }
  __device__ uint32_t bytes(int l) const { return uint32_t(rows(l)) * cols(l) * 2; }
  __device__ size_t offset(int l, int c) const {  // elements
    if (l == 0) return size_t(c) * nc * k0p;
    return size_t(hp) * k0p + size_t(l - 1) * hp * hp + size_t(c) * nc * hp;
  }
  // the ring slot of (l, c) when every chunk is resident
  __device__ int slot(int l, int c) const { return l * per_layer() + c; }
};

// The consumer side of the ring. Resident: every chunk in its own slot,
// loaded once. Streaming: chunks in the order they are acquired, `it`
// counting acquisitions; release() after the wgmmas on a stage completed.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  uint32_t stage_bytes;
  int stages;
  bool resident;
  uint32_t it;

  __device__ const unsigned char* acquire(const Chunks& ch, int l, int c) {
    if (resident) {
      const int s = l == ch.L ? ch.slot(l, 0) : ch.slot(l, c);
      mbar_wait(full + s, 0);
      return base + size_t(s) * stage_bytes;
    }
    const int s = it % stages;
    mbar_wait(full + s, (it / stages) & 1);
    ++it;
    return base + size_t(s) * stage_bytes;
  }
  // releases the oldest `count` stages not yet released (streaming)
  __device__ void release(int count, int lane) {
    if (resident) return;
    __syncwarp();
    if (lane == 0)
      for (int k = count; k >= 1; --k) mbar_arrive(empty + (it - k) % stages);
  }
};

// The producer: one thread copies chunk (l, c) into the next stage once
// the consumers released it.
struct Feeder {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  uint32_t stage_bytes;
  int stages;
  uint32_t it;
  const __nv_bfloat16* w;

  __device__ void put(const Chunks& ch, int l, int c) {
    const int s = it % stages;
    if (it >= uint32_t(stages)) mbar_wait(empty + s, ((it / stages) - 1) & 1);
    const uint32_t bytes = ch.bytes(l);
    mbar_expect_tx(full + s, bytes);
    bulk_copy(base + size_t(s) * stage_bytes, w + ch.offset(l, c), bytes, full + s);
    ++it;
  }
  __device__ void put_layer(const Chunks& ch, int l) {
    const int n = l == ch.L ? 1 : ch.per_layer();
    for (int c = 0; c < n; ++c) put(ch, l, c);
  }
  // every chunk into its own slot, once
  __device__ void put_all(const Chunks& ch) {
    for (int l = 0; l <= ch.L; ++l) {
      const int n = l == ch.L ? 1 : ch.per_layer();
      for (int c = 0; c < n; ++c) {
        const int s = ch.slot(l, c);
        const uint32_t bytes = ch.bytes(l);
        mbar_expect_tx(full + s, bytes);
        bulk_copy(base + size_t(s) * stage_bytes, w + ch.offset(l, c), bytes,
                  full + s);
      }
    }
  }
};

// Ring geometry for HP: the largest chunk is a stage; resident when all
// chunks fit.
__host__ __device__ inline uint32_t ring_stage_bytes(int hp, int k0p, int opk) {
  const int nc = hp < 128 ? hp : 128;
  return uint32_t(imax(nc * imax(hp, k0p), opk * hp)) * 2;
}
__host__ __device__ inline int ring_chunks(int hp, int L) {
  return L * (hp <= 128 ? 1 : hp / 128) + 1;
}
__host__ __device__ inline int ring_stages(int hp, int k0p, int opk, int L) {
  const int fit = kRingBytes / int(ring_stage_bytes(hp, k0p, opk));
  const int s = fit < kMaxStages ? fit : kMaxStages;
  const int chunks = ring_chunks(hp, L);
  return chunks <= s ? chunks : s;
}
__host__ __device__ inline bool ring_resident(int hp, int k0p, int opk, int L) {
  return ring_chunks(hp, L) <= ring_stages(hp, k0p, opk, L);
}
// the ring and its two barriers a stage
inline size_t ring_smem_bytes(int hp, int k0p, int opk, int L) {
  return size_t(ring_stages(hp, k0p, opk, L)) * ring_stage_bytes(hp, k0p, opk) +
         2 * kMaxStages * sizeof(uint64_t);
}

// ---- the row-tile engine

constexpr float kTwoPi = 6.283185307179586f;

// A thread's share of layer 0's A fragments, fixed for the kernel: the
// encoding pairs p = 4 i + q (i = 2 kt + half), each a frequency and an
// axis (0-2: sin, cos of 2 pi f x_d; 3: (x0, x1); 4: (x2, 0); 5: zeros).
struct EncPairs {
  float f[kMaxK0 / 8];
  int d[kMaxK0 / 8];
};

__device__ __forceinline__ EncPairs enc_pairs(const float* __restrict__ freqs,
                                              const PeMlpShape& s, int lane) {
  EncPairs e;
#pragma unroll
  for (int i = 0; i < kMaxK0 / 8; ++i) {
    const int p = 4 * i + (lane & 3);
    e.f[i] = 0.0f;
    if (p < 3 * s.F) {
      e.d[i] = p / s.F;
      e.f[i] = __ldg(freqs + (p - e.d[i] * s.F));
    } else {
      e.d[i] = p == 3 * s.F ? 3 : (p == 3 * s.F + 1 ? 4 : 5);
    }
  }
  return e;
}

// (sin, cos) of 2 pi f x for the bf16 kernels: the angle t = f x in turns
// reduced exactly as encode_pair does it, then the fast intrinsics on
// 2 pi r, |r| <= 1/2 (2^-21 absolute error in [-pi, pi], far below bf16's
// rounding).
__device__ __forceinline__ float2 fast_sincos(float f, float x) {
  const float t_hi = __fmul_rn(f, x);
  const float t_lo = fmaf(f, x, -t_hi);
  const float a = kTwoPi * ((t_hi - rintf(t_hi)) + t_lo);
  return make_float2(__sinf(a), __cosf(a));
}

// Layer 0's A fragments of a warp's 16 rows (row0 + g, + 8), straight from
// x: the k0p / 16 k16 tiles of the interleaved encoding (zeros after them).
__device__ __forceinline__ void encode_frags(uint32_t (&a0)[kMaxK0 / 16][4],
                                             const float* __restrict__ x,
                                             const EncPairs& e,
                                             const PeMlpShape& s, int row0,
                                             int lane) {
  const int g = lane >> 2;
  float xr[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      xr[h][d] = r < s.n ? __ldg(x + size_t(r) * 3 + d) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kMaxK0 / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(0.0f, 0.0f);
      if ((i >> 1) * 16 < s.k0p) {
        const int d = e.d[i];
        if (d < 3) {
          v = fast_sincos(e.f[i], d == 0 ? xr[h][0] : (d == 1 ? xr[h][1] : xr[h][2]));
        } else if (d == 3) {
          v = make_float2(xr[h][0], xr[h][1]);
        } else if (d == 4) {
          v = make_float2(xr[h][2], 0.0f);
        }
      }
      a0[i >> 1][(i & 1) * 2 + h] = pack_bf16x2(v.x, v.y);
    }
}

struct Nothing {
  __device__ void operator()() const {}
};

// acc = A . W_chunk^T for a chunk of NC weight rows (K-major B, K = the
// chunk's columns, kt_used k16 tiles of `a`); `during` runs while the
// products are in flight.
template <int NC, int KT, class During = Nothing>
__device__ __forceinline__ void chunk_fwd(float (&acc)[NC / 2],
                                          const uint32_t (&a)[KT][4],
                                          const unsigned char* w, int kt_used,
                                          During during = During()) {
  zero(acc);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    if (kt < kt_used)
      wgmma_rs<NC, 0>(acc, a[kt],
                      wgmma_desc(w + kt * NC * 32, NC * 16, 128));
  wgmma_commit();
  during();
  wgmma_wait_all();
  fence_regs(acc);
}

// The ReLU epilogue: acc (N = NC columns starting at column c0 of the
// layer) + bias, max 0, packed into the A fragments of k16 tiles
// c0 / 16 .. of `o`.
template <int NC, int KT>
__device__ __forceinline__ void relu_pack(const float (&acc)[NC / 2],
                                          uint32_t (&o)[KT][4], int c0,
                                          const float* __restrict__ bias,
                                          int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = c0 + j * 8 + 2 * q;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
    const int t = c0 / 16 + j / 2, e = (j & 1) * 2;
    o[t][e] = pack_bf16x2(fmaxf(acc[4 * j] + b0, 0.0f),
                          fmaxf(acc[4 * j + 1] + b1, 0.0f));
    o[t][e + 1] = pack_bf16x2(fmaxf(acc[4 * j + 2] + b0, 0.0f),
                              fmaxf(acc[4 * j + 3] + b1, 0.0f));
  }
}

// The hidden layers of the forward for a warp's rows: layer 0 from the
// encoding fragments, then layers 1 .. L-1, each chunk of NC output units
// acquired from the ring; after each layer on_layer(l, act) (the backward
// stores h there). `during` runs while the last hidden chunk is in the
// products (the next row tile's encoding).
template <int HP, class OnLayer, class During>
__device__ __forceinline__ void forward_hidden(
    uint32_t (&act)[HP / 16][4], const uint32_t (&a0)[kMaxK0 / 16][4],
    Ring& ring, const Chunks& ch, const float* __restrict__ bias, int L,
    int lane, OnLayer on_layer, During during) {
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
    relu_pack<NC, HP / 16>(acc, act, c * NC, bias, lane);
  }
  on_layer(0, act);
  for (int l = 1; l < L; ++l) {
    uint32_t nxt[HP / 16][4];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const unsigned char* w = ring.acquire(ch, l, c);
      float acc[NC / 2];
      chunk_fwd<NC, HP / 16>(acc, act, w, HP / 16,
                             last(l == L - 1 && c == CPL - 1));
      ring.release(1, lane);
      relu_pack<NC, HP / 16>(acc, nxt, c * NC, bias + l * HP, lane);
    }
#pragma unroll
    for (int kt = 0; kt < HP / 16; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) act[kt][e] = nxt[kt][e];
    on_layer(l, act);
  }
}

}  // namespace
