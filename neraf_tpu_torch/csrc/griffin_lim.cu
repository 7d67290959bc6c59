// Momentum Griffin-Lim for Hopper (sm_90a), the whole loop inside one block.
//
// Replaces neraf_tpu/ops/pallas/griffin_lim_kernel.py::griffin_lim_pallas.
// It computes what that kernel computes -- n_iter rounds of
//   rebuilt = stft(istft(mag * angles)); new = rebuilt - mom * tprev;
//   angles = new / max(|new|, 1e-16); tprev = rebuilt
// and a final istft(mag * angles) -- with torch.stft / torch.istft
// conventions (center=True, reflect padding, onesided, window-sum-of-squares
// normalisation; irfft drops the imaginary parts of the DC and Nyquist bins).
//
// Layout: one block per channel. The channel's signal lives in shared memory
// for all iterations: `core` holds the normalised, trimmed signal the
// analysis reads, `ola` accumulates the overlap-add of the synthesis. Frames
// interact only through the signal, so each warp takes one frame at a time
// through analysis -> momentum/normalise -> synthesis -> overlap-add, and
// the angles are never stored. Frames t and t + n_fft/hop do not overlap,
// so the warps run one residue class of frames at a time with no atomics and
// a fixed summation order (results do not change from run to run, nor with
// the launch plan). The plan (ops/cuda/griffin_lim.py::gl_launch_plan) gives
// a block as many warps as a class has frames, or an even share of them, so
// that a class runs in whole rounds with every warp busy.
//
// Each frame's real DFT of n_fft points is a complex FFT of P = n_fft/2
// points (even samples real, odd imaginary) plus the split step, in fp32 on
// the CUDA cores (a TF32 tensor-core DFT keeps ~3 digits, which drifts over
// 32 iterations). One warp holds a frame in registers, R = P/32 points a
// lane: lane l holds points l + 32 s. The FFT is a self-sorting mixed-radix
// (Stockham) FFT whose every stage is one radix-R DFT per lane in registers
// (the last stage R/rho radix-rho DFTs), with the stage twiddles held in
// registers from the float64-built table; between stages the warp exchanges
// the points once through its buffer of P float2 (XOR-swizzled, no bank
// conflicts). P = 256 and 512 take 2 exchanges, P = 128 three. The output
// is in natural order in the input's layout, so the split step pairs bin k
// (lane l) with bin P - k (lane 32 - l) by warp shuffles, and the momentum,
// the projection (f32 rsqrt) and the inverse split step run on the same
// registers. The inverse FFT is the forward FFT of the conjugate. So a
// frame's analysis makes 3 dependent shared-memory passes (the frame load, 2
// exchanges) and its synthesis 3 (2 exchanges, the overlap-add), with the
// split steps between them in shuffles.
//
// The per-bin state (tprev, and mag transposed to frame-major order) is
// 240 KB per SoundSpaces channel, more than shared memory holds; it stays in
// global memory (L2-resident at one block an SM: ~32 MB for 132 channels),
// read and written once per frame, coalesced. Each warp copies the state of
// its next frame into its staging buffer with cp.async as soon as the
// current frame's split step has read its own, so the copy's latency hides
// behind the rest of the frame, the barrier and the next forward FFT, and
// holds no registers.
//
// What bounds the kernel on the card: latency, not a rate. A block holds a
// residue class's frames (20 warps at SoundSpaces, 96 registers a thread
// under the launch bound; 8 at RAF, where shared memory holds no more), each
// frame a dependent chain of FFT stages, exchanges and shuffles, and the
// block waits at a barrier after every class; the per-bin state's traffic
// through the L2 (20 bytes per bin and iteration, ~13.6 GB over 32
// iterations at 1024 SoundSpaces channels) is the next limit. Two blocks an
// SM would hold twice the state, more than the L2.
//
// Preconditions (checked by the Python wrapper): n_fft 256, 512 or 1024,
// F == n_fft/2 + 1, length == hop * (T - 1) > n_fft/2, hop | n_fft/2.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// most warps a block, by n_fft: the launch bound caps the registers so that
// a block of this many warps fits an SM's register file. At n_fft 1024 the
// staging leaves shared memory for 8 warps at RAF's T 60, so 8 lets a thread
// have 255 registers (16 capped it at 128, and the frame spilled)
__host__ __device__ constexpr int max_warps(int N) { return N == 1024 ? 8 : 20; }

struct GLShape {
  int T, hop, length, n_iter;
  float mom;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
// i * a and -i * a
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(-a.y, a.x); }
__device__ __forceinline__ float2 mul_ni(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 shfl(float2 a, int src) {
  return make_float2(__shfl_sync(kFull, a.x, src), __shfl_sync(kFull, a.y, src));
}

// a * exp(-2 pi i m / 16); m is a constant once the callers' loops unroll,
// and the quarter turns are exact
__device__ __forceinline__ float2 rot16(float2 a, int m) {
  constexpr float h = 0.70710678118654752f, c1 = 0.92387953251128676f,
                  s1 = 0.38268343236508977f;
  float c, s;
  switch (m & 15) {
    case 0: return a;
    case 4: return mul_ni(a);
    case 8: return make_float2(-a.x, -a.y);
    case 12: return mul_i(a);
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 7: c = -c1; s = s1; break;
    case 9: c = -c1; s = -s1; break;
    case 10: c = -h; s = -h; break;
    case 11: c = -s1; s = -c1; break;
    case 13: c = s1; s = -c1; break;
    case 14: c = h; s = -h; break;
    default: c = c1; s = -s1; break;  // 15
  }
  return make_float2(a.x * c + a.y * s, a.y * c - a.x * s);
}

// in-register DFT of RHO (<= 16) points, radix 2 by decimation in time:
// a[t] <- sum_s a[s] exp(-2 pi i s t / RHO)
template <int RHO>
__device__ __forceinline__ void dft(float2 (&a)[RHO]) {
  if constexpr (RHO > 1) {
    constexpr int H = RHO / 2;
    float2 e[H], o[H];
#pragma unroll
    for (int s = 0; s < H; ++s) {
      e[s] = a[2 * s];
      o[s] = a[2 * s + 1];
    }
    dft<H>(e);
    dft<H>(o);
#pragma unroll
    for (int t = 0; t < H; ++t) {
      const float2 w = rot16(o[t], t * (16 / RHO));
      a[t] = add(e[t], w);
      a[t + H] = sub(e[t], w);
    }
  }
}

// The FFT's stages: p = 1, then p *= rho, with rho = min(R, P / p).
__host__ __device__ constexpr int stage_radix(int P, int p) {
  return P / p < P / kWarp ? P / p : P / kWarp;
}
// twiddles a lane holds for the stages before p_end: (R / rho) * (rho - 1)
// for each stage after the first
__host__ __device__ constexpr int tw_count(int P, int p_end) {
  int n = 0;
  for (int p = 1; p < p_end; p *= stage_radix(P, p))
    if (p > 1) n += (P / kWarp / stage_radix(P, p)) * (stage_radix(P, p) - 1);
  return n;
}

// the exchange buffer's XOR swizzle: row a = j / 16 (16 float2, 128 bytes)
// permutes its slots by (a ^ 2a ^ 4a) mod 16, so that every stage's stores
// and the loads of points l + 32 s fall on distinct banks in each half-warp
__device__ __forceinline__ int swz(int j) {
  const int a = j >> 4;
  return j ^ ((a ^ (a << 1) ^ (a << 2)) & 15);
}

// the lane's stage twiddles exp(-2 pi i s k / (rho p)), k = (lane + 32 b)
// mod p, from tw_g[j] = exp(-2 pi i j / (2 P))
template <int P, int p = 1>
__device__ __forceinline__ void load_twiddles(float2 (&twr)[tw_count(P, P)],
                                              const float2* __restrict__ tw_g,
                                              int lane) {
  constexpr int R = P / kWarp, rho = stage_radix(P, p), nb = R / rho;
  if constexpr (p > 1) {
    constexpr int off = tw_count(P, p);
#pragma unroll
    for (int b = 0; b < nb; ++b) {
      const int k = (lane + kWarp * b) & (p - 1);
#pragma unroll
      for (int s = 1; s < rho; ++s)
        twr[off + b * (rho - 1) + s - 1] = __ldg(tw_g + s * k * (2 * P / (rho * p)));
    }
  }
  if constexpr (p * rho < P) load_twiddles<P, p * rho>(twr, tw_g, lane);
}

// Forward FFT of P points by one warp: v[s] holds point lane + 32 s on entry
// and bin lane + 32 s on exit. Stage (p, rho), butterfly i = lane + 32 b:
// inputs i + s P / rho (v[b + s R / rho]) times exp(-2 pi i s k / (rho p)),
// k = i mod p; a radix-rho DFT; outputs to (i - k) rho + k + t p, which the
// last stage (p rho = P, so k = i) leaves in place.
template <int P, int p = 1>
__device__ __forceinline__ void warp_fft(float2 (&v)[P / kWarp], float2* buf,
                                         const float2 (&twr)[tw_count(P, P)],
                                         int lane) {
  constexpr int R = P / kWarp, rho = stage_radix(P, p), nb = R / rho;
  constexpr int off = tw_count(P, p);
  constexpr bool last = p * rho == P;
#pragma unroll
  for (int b = 0; b < nb; ++b) {
    float2 a[rho];
#pragma unroll
    for (int s = 0; s < rho; ++s) a[s] = v[b + s * nb];
    if constexpr (p > 1) {
#pragma unroll
      for (int s = 1; s < rho; ++s) a[s] = cmul(a[s], twr[off + b * (rho - 1) + s - 1]);
    }
    dft<rho>(a);
    if constexpr (last) {
#pragma unroll
      for (int t = 0; t < rho; ++t) v[b + t * nb] = a[t];
    } else {
      const int i = lane + kWarp * b, k = i & (p - 1);
#pragma unroll
      for (int t = 0; t < rho; ++t) buf[swz((i - k) * rho + k + t * p)] = a[t];
    }
  }
  if constexpr (!last) {
    __syncwarp();
#pragma unroll
    for (int s = 0; s < R; ++s) v[s] = buf[swz(lane + kWarp * s)];
    __syncwarp();
    warp_fft<P, p * rho>(v, buf, twr, lane);
  }
}

// asynchronous copy of 4 or 8 bytes from global to shared memory
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ int reflect(int j, int L) {
  return j < 0 ? -j : (j >= L ? 2 * (L - 1) - j : j);
}

// a bin's synthesis coefficient mag * new / max(|new|, 1e-16) / P, with
// new = x - mom * prev (the DC and Nyquist bins are real); rsqrtf is within
// 2 ulp, where an IEEE sqrt and divide cost ~20 instructions a bin
__device__ __forceinline__ float2 project(float2 x, float2 prev, float g,
                                          float mom, bool real) {
  const float nr = x.x - mom * prev.x;
  const float ni = real ? 0.f : x.y - mom * prev.y;
  const float h = g * rsqrtf(fmaxf(nr * nr + ni * ni, 1e-32f));
  return make_float2(nr * h, ni * h);
}

// Dynamic shared memory, in this order (float2 arrays first, every float
// array of even length, so core and ola stay 8-byte aligned):
//   tw    [P] float2                 : exp(-2 pi i k / N), the split's twiddles
//   buf   [warps][P] float2          : each warp's exchange buffer
//   stage [warps] {[P+1] float2, [P+2] float} : each warp's next frame's
//                                      tprev and mag, copied ahead
//   win [N], core [length], ola [N + hop (T-1)]
// ops/cuda/griffin_lim.py::gl_smem_bytes mirrors these two functions.
__host__ __device__ inline size_t gl_base_bytes(int n_fft, int hop, int T,
                                                int length) {
  return size_t(n_fft / 2) * sizeof(float2) +
         size_t(n_fft + length + n_fft + hop * (T - 1)) * sizeof(float);
}
__host__ __device__ inline size_t gl_warp_bytes(int n_fft) {
  return size_t(n_fft / 2) * sizeof(float2) +
         size_t(n_fft / 2 + 1) * sizeof(float2) + size_t(n_fft / 2 + 2) * sizeof(float);
}

template <int N>
__global__ void __launch_bounds__(max_warps(N) * kWarp)
griffin_lim_kernel(const float* __restrict__ mag,      // (M, F, T)
                   const float2* __restrict__ ang0,    // (M, F, T) unit phasors
                   const float2* __restrict__ tw_g,    // (N,)
                   const float* __restrict__ win_g,    // (N,)
                   const float* __restrict__ inv_wsq,  // (length,)
                   float2* __restrict__ tprev,         // (M, T, F) scratch
                   float* __restrict__ mag_t,          // (M, T, F) scratch
                   float* __restrict__ out,            // (M, length)
                   GLShape s) {
  extern __shared__ float2 smem2[];
  constexpr int P = N / 2, R = P / kWarp, F = P + 1;
  const int T = s.T, hop = s.hop;
  const int L = s.length, pad = N / 2, olen = N + hop * (T - 1);
  const int q = N / hop, warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int mirror = (kWarp - lane) & (kWarp - 1);  // holds bins P - k
  float2* tw = smem2;
  float2* buf = tw + P + size_t(warp) * P;
  constexpr int SW = (3 * P + 4) / 2;  // a warp's staging, in float2
  float2* stage = tw + P + size_t(warps) * P + size_t(warp) * SW;
  float* mg_s = reinterpret_cast<float*>(stage + P + 1);
  float* win = reinterpret_cast<float*>(tw + P + size_t(warps) * (P + SW));
  float* core = win + N;
  float* ola = core + L;
  const float2* win2 = reinterpret_cast<const float2*>(win);

  const int m = blockIdx.x;
  const float* mag_m = mag + size_t(m) * F * T;
  const float2* ang_m = ang0 + size_t(m) * F * T;
  float2* tp_m = tprev + size_t(m) * T * F;
  float* mt_m = mag_t + size_t(m) * T * F;
  const float invP = 1.0f / float(P);

  float2 twr[tw_count(P, P)];
  load_twiddles<P>(twr, tw_g, lane);
  for (int i = threadIdx.x; i < P; i += blockDim.x) tw[i] = tw_g[i];
  for (int i = threadIdx.x; i < N; i += blockDim.x) win[i] = win_g[i];
  for (int i = threadIdx.x; i < olen; i += blockDim.x) ola[i] = 0.0f;
  __syncthreads();

  // it == -1 is the initial synthesis from the given angles; every later
  // pass analyses the current signal first.
  for (int it = -1; it < s.n_iter; ++it) {
    for (int r = 0; r < q; ++r) {
      for (int t = r + q * warp; t < T; t += q * warps) {
        float2* tp = tp_m + size_t(t) * F;
        float* mt = mt_m + size_t(t) * F;
        // the frame's synthesis coefficients C / P at bins k = lane + 32 j,
        // and (lane 0) at the Nyquist bin P
        float2 c[R], cP = make_float2(0.f, 0.f);
        float2 v[R];
        if (it >= 0) {
          // this frame's per-bin state, copied into the staging by this
          // lane when its previous frame was done with it
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          // windowed frame t of the reflect-padded signal, packed as
          // z[n] = x[2n] + i x[2n+1], n = lane + 32 j
          if (t * hop >= pad && t * hop + pad <= L) {  // no reflection
            const float2* src = reinterpret_cast<const float2*>(core + t * hop - pad);
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const int n = lane + kWarp * j;
              const float2 x = src[n], w = win2[n];
              v[j] = make_float2(x.x * w.x, x.y * w.y);
            }
          } else {
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const int n = lane + kWarp * j, p0 = t * hop + 2 * n - pad;
              const float2 w = win2[n];
              v[j] = make_float2(core[reflect(p0, L)] * w.x,
                                 core[reflect(p0 + 1, L)] * w.y);
            }
          }
          warp_fft<P>(v, buf, twr, lane);
          // split step: X[k] = E[k] + exp(-2 pi i k / N) O[k], with Z[P - k]
          // from the mirror lane (lane 0 holds its own: Z[P - 32 j] = v[R - j])
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const int k = lane + kWarp * j;
            const float2 other = shfl(v[R - 1 - j], mirror);
            const float2 zk = v[j];
            const float2 zc = conjf2(lane == 0 ? v[(R - j) % R] : other);
            const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
            const float2 o = make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x));
            const float2 xk = add(e, cmul(tw[k], o));
            tp[k] = xk;
            c[j] = project(xk, stage[k], mg_s[k] * invP, s.mom, k == 0);
            if (k == 0) {  // the Nyquist bin: X[P] = E[0] - O[0]
              const float2 xP = sub(e, o);
              tp[P] = xP;
              cP = project(xP, stage[P], mg_s[P] * invP, s.mom, true);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j <= R; ++j) {
            const int k = lane + kWarp * j;
            if (k <= P) {
              const float g = mag_m[size_t(k) * T + t];
              const float2 a = ang_m[size_t(k) * T + t];
              mt[k] = g;
              tp[k] = make_float2(0.f, 0.f);
              const float2 ck = (k == 0 || k == P)
                                    ? make_float2(g * a.x * invP, 0.f)
                                    : make_float2(g * a.x * invP, g * a.y * invP);
              if (j < R) c[j] = ck; else cP = ck;
            }
          }
        }
        {  // copy the state of this warp's next analysed frame (the next
           // of its class, else of the next class or iteration) into the
           // staging; each lane copies and later reads its own bins
          int tn = t + q * warps, rn = r, itn = it;
          while (tn >= T) {
            if (++rn == q) {
              rn = 0;
              if (++itn == s.n_iter) break;
            }
            tn = rn + q * warp;
          }
          // orders the tprev stores above before the copy, which reads them
          // back when a warp has one frame an iteration
          __syncwarp();
          if (itn >= 0 && itn < s.n_iter) {
            const float2* tpn = tp_m + size_t(tn) * F;
            const float* mtn = mt_m + size_t(tn) * F;
#pragma unroll
            for (int j = 0; j <= R; ++j) {
              const int k = lane + kWarp * j;
              if (k <= P) {
                cp_async(stage + k, tpn + k, 8);
                cp_async(mg_s + k, mtn + k, 4);
              }
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
          }
        }
        // inverse split step: Z'[k] = E[k] + i O[k], with
        // E = (C[k] + conj C[P-k]) / 2, O = (C[k] - conj C[P-k]) / 2 * exp(+2 pi i k / N);
        // the inverse FFT is conj(FFT(conj Z'))
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int k = lane + kWarp * j;
          const float2 other = shfl(c[R - 1 - j], mirror);
          const float2 cc = conjf2(lane != 0 ? other : (j == 0 ? cP : c[(R - j) % R]));
          const float2 ck = c[j];
          const float2 e = make_float2(0.5f * (ck.x + cc.x), 0.5f * (ck.y + cc.y));
          const float2 o = cmul(make_float2(0.5f * (ck.x - cc.x), 0.5f * (ck.y - cc.y)),
                                conjf2(tw[k]));
          v[j] = conjf2(add(e, mul_i(o)));
        }
        warp_fft<P>(v, buf, twr, lane);
        // overlap-add of the windowed frame: x[2n] + i x[2n+1] = conj v[j]
        float2* dst = reinterpret_cast<float2*>(ola + t * hop);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int n = lane + kWarp * j;
          const float2 w = win2[n];
          float2 acc = dst[n];
          acc.x = fmaf(v[j].x, w.x, acc.x);
          acc.y = fmaf(-v[j].y, w.y, acc.y);
          dst[n] = acc;
        }
      }
      __syncthreads();  // the next residue class overlaps this one's frames
    }
    if (it < s.n_iter - 1) {
      // normalise into core for the next analysis; reset the accumulator.
      // 1/wsq comes from the L2: eight loads in flight a thread, not one
      constexpr int U = 8;
      for (int i0 = threadIdx.x; i0 < olen; i0 += U * blockDim.x) {
        float w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = i0 + u * blockDim.x - pad;
          w[u] = (j >= 0 && j < L) ? inv_wsq[j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * blockDim.x;
          if (i < olen) {
            const float v = ola[i];
            ola[i] = 0.0f;
            const int j = i - pad;
            if (j >= 0 && j < L) core[j] = v * w[u];
          }
        }
      }
      __syncthreads();
    }
  }

  float* out_m = out + size_t(m) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    out_m[j] = ola[pad + j] * inv_wsq[j];
}

using GLKernel = void (*)(const float*, const float2*, const float2*,
                         const float*, const float*, float2*, float*, float*,
                         GLShape);

// the kernel for n_fft, its dynamic shared memory raised to `smem` bytes;
// null if n_fft is not served or `smem` is over the card's opt-in limit
GLKernel gl_kernel(int n_fft, int smem, cudaError_t* err) {
  GLKernel kernel = nullptr;
  switch (n_fft) {
    case 256: kernel = griffin_lim_kernel<256>; break;
    case 512: kernel = griffin_lim_kernel<512>; break;
    case 1024: kernel = griffin_lim_kernel<1024>; break;
    default: *err = cudaErrorInvalidValue; return nullptr;
  }
  int dev = 0, optin = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err == cudaSuccess && smem > optin) *err = cudaErrorInvalidValue;
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err == cudaSuccess)
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  return *err == cudaSuccess ? kernel : nullptr;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with the caller's plan (ops/cuda/
// griffin_lim.py::gl_launch_plan): `warps` a block, `smem` bytes of dynamic
// shared memory. Refuses a plan that the layout or the card cannot hold;
// returns the cudaError_t.
int neraf_gl_launch(const float* mag, const void* ang0, const void* tw,
                    const float* win, const float* inv_wsq, void* tprev,
                    float* mag_t, float* out, int M, int T, int n_fft,
                    int hop, int length, int n_iter, float mom, int warps,
                    int smem, void* stream) {
  if (warps < 1 || warps > max_warps(n_fft) ||
      size_t(smem) < gl_base_bytes(n_fft, hop, T, length) +
                         size_t(warps) * gl_warp_bytes(n_fft))
    return int(cudaErrorInvalidValue);
  cudaError_t err;
  const GLKernel kernel = gl_kernel(n_fft, smem, &err);
  if (!kernel) return int(err);
  GLShape s{T, hop, length, n_iter, mom};
  kernel<<<M, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, static_cast<const float2*>(ang0), static_cast<const float2*>(tw),
      win, inv_wsq, static_cast<float2*>(tprev), mag_t, out, s);
  return int(cudaGetLastError());
}

// Blocks of a plan that the card keeps resident on one SM, in *blocks (a
// report for chip_smoke.py; the launcher does not ask). Returns the
// cudaError_t.
int neraf_gl_blocks_per_sm(int n_fft, int warps, int smem, int* blocks) {
  cudaError_t err;
  const GLKernel kernel = gl_kernel(n_fft, smem, &err);
  if (!kernel) return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, warps * kWarp, size_t(smem)));
}

const char* neraf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
