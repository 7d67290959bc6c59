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
// a fixed summation order (results do not change from run to run).
//
// Each frame's real DFT of n_fft points is a complex FFT of P = n_fft/2
// points (even samples real, odd imaginary) plus the usual split step, run by
// one warp as a radix-4/2 Stockham FFT in shared memory, in fp32 on the CUDA
// cores (a TF32 tensor-core DFT keeps ~3 digits, which drifts over 32
// iterations). The per-bin state (tprev, and mag transposed to frame-major
// order) is 240 KB per SoundSpaces channel, more than shared memory holds;
// it stays in global memory, read and written once per frame, coalesced.
//
// What bounds the kernel on the card: instruction issue and shared-memory
// latency of the per-warp FFTs (~30 kFLOP per frame and iteration, small
// against the card's rate), with global traffic for the per-bin state
// (20 bytes per bin and iteration, ~13 GB over 32 iterations at 1024
// SoundSpaces channels) as the next limit; each frame loads its state before
// its forward FFT, so the load latency overlaps the FFT. One block per SM
// with up to 16 warps (SoundSpaces 16, RAF 11) keeps the in-flight state
// (~240 KB per channel) near L2's size.
//
// Preconditions (checked by the Python wrapper): n_fft 256, 512 or 1024,
// F == n_fft/2 + 1, length == hop * (T - 1) > n_fft/2, hop | n_fft/2.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 16;
constexpr size_t kSmemPerBlock = 227 * 1024;  // H100: opt-in maximum

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

// Stockham autosort FFT of P points (a power of two) by one warp, radix 4
// with one radix-2 stage when log2(P) is odd. tw[j] = exp(-2 pi i j / N)
// with P | N; `inverse` uses exp(+...) and does not scale. Ping-pongs
// between x and y and returns the buffer that holds the result.
template <int P, int N>
__device__ float2* warp_fft(float2* x, float2* y, const float2* tw,
                            bool inverse, int lane) {
#pragma unroll
  for (int p = 1; p < P;) {
    const int R = ((P / p) % 4 == 0) ? 4 : 2;
    const int stride = P / R, tstep = N / (R * p);
    for (int i = lane; i < stride; i += kWarp) {
      const int k = i & (p - 1);
      if (R == 4) {
        float2 a0 = x[i], a1 = x[i + stride], a2 = x[i + 2 * stride],
               a3 = x[i + 3 * stride];
        if (p > 1) {
          float2 w1 = tw[k * tstep], w2 = tw[2 * k * tstep],
                 w3 = tw[3 * k * tstep];
          if (inverse) { w1 = conjf2(w1); w2 = conjf2(w2); w3 = conjf2(w3); }
          a1 = cmul(a1, w1);
          a2 = cmul(a2, w2);
          a3 = cmul(a3, w3);
        }
        const float2 t0 = add(a0, a2), t1 = sub(a0, a2), t2 = add(a1, a3),
                     t3 = inverse ? mul_i(sub(a1, a3)) : mul_ni(sub(a1, a3));
        const int j = ((i - k) << 2) + k;
        y[j] = add(t0, t2);
        y[j + p] = add(t1, t3);
        y[j + 2 * p] = sub(t0, t2);
        y[j + 3 * p] = sub(t1, t3);
      } else {
        float2 a0 = x[i], a1 = x[i + stride];
        if (p > 1) {
          const float2 w = tw[k * tstep];
          a1 = cmul(a1, inverse ? conjf2(w) : w);
        }
        const int j = ((i - k) << 1) + k;
        y[j] = add(a0, a1);
        y[j + p] = sub(a0, a1);
      }
    }
    __syncwarp();
    float2* tmp = x;
    x = y;
    y = tmp;
    p *= R;
  }
  return x;
}

__device__ __forceinline__ int reflect(int j, int L) {
  return j < 0 ? -j : (j >= L ? 2 * (L - 1) - j : j);
}

// Dynamic shared memory, in this order (float2 arrays first, every float
// array of even length, so ola stays 8-byte aligned):
//   tw  [N] float2                : exp(-2 pi i j / N)
//   buf [warps][2][P+1] float2    : each warp's two FFT buffers
//   win [N], core [length], ola [N + hop (T-1)]
__host__ __device__ inline size_t gl_base_bytes(int n_fft, int hop, int T,
                                                int length) {
  return size_t(n_fft) * sizeof(float2) +
         size_t(n_fft + length + n_fft + hop * (T - 1)) * sizeof(float);
}
__host__ __device__ inline size_t gl_warp_bytes(int n_fft) {
  return 2 * size_t(n_fft / 2 + 1) * sizeof(float2);
}

template <int N>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
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
  constexpr int P = N / 2;
  constexpr int KB = P / kWarp + 1;  // bins per lane: k = lane + 32 j <= P
  constexpr int F = P + 1;
  const int T = s.T, hop = s.hop;
  const int L = s.length, pad = N / 2, olen = N + hop * (T - 1);
  const int q = N / hop, warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float2* tw = smem2;
  float2* bufs = tw + N;
  float* win = reinterpret_cast<float*>(bufs + size_t(warps) * 2 * (P + 1));
  float* core = win + N;
  float* ola = core + L;
  float2* bx = bufs + size_t(warp) * 2 * (P + 1);
  float2* by = bx + (P + 1);

  const int m = blockIdx.x;
  const float* mag_m = mag + size_t(m) * F * T;
  const float2* ang_m = ang0 + size_t(m) * F * T;
  float2* tp_m = tprev + size_t(m) * T * F;
  float* mt_m = mag_t + size_t(m) * T * F;
  const float invP = 1.0f / float(P);

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    tw[i] = tw_g[i];
    win[i] = win_g[i];
  }
  for (int i = threadIdx.x; i < olen; i += blockDim.x) ola[i] = 0.0f;
  __syncthreads();

  // it == -1 is the initial synthesis from the given angles; every later
  // pass analyses the current signal first.
  for (int it = -1; it < s.n_iter; ++it) {
    for (int r = 0; r < q; ++r) {
      for (int t = r + q * warp; t < T; t += q * warps) {
        float2* tp = tp_m + size_t(t) * F;
        float* mt = mt_m + size_t(t) * F;
        float2* spec;  // the frame's synthesis coefficients C[0..P], / P
        float2* work;  // the other buffer
        if (it >= 0) {
          // the frame's per-bin state, loaded first so that its latency
          // (L2 or device memory) hides behind the forward FFT
          float2 prev[KB];
          float mg[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int k = lane + kWarp * j;
            if (k <= P) {
              prev[j] = tp[k];
              mg[j] = mt[k];
            }
          }
          // windowed frame t of the reflect-padded signal, packed as
          // z[n] = x[2n] + i x[2n+1]
          for (int n = lane; n < P; n += kWarp) {
            const int p0 = t * hop + 2 * n - pad;
            bx[n] = make_float2(core[reflect(p0, L)] * win[2 * n],
                                core[reflect(p0 + 1, L)] * win[2 * n + 1]);
          }
          __syncwarp();
          const float2* Z = warp_fft<P, N>(bx, by, tw, false, lane);
          spec = (Z == bx) ? by : bx;
          work = (Z == bx) ? bx : by;
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int k = lane + kWarp * j;
            if (k > P) break;
            // split step: X[k] = E[k] + exp(-2 pi i k / N) O[k]
            const float2 zk = Z[k == P ? 0 : k];
            const float2 zc = conjf2(Z[k == 0 ? 0 : P - k]);
            const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
            const float2 o = make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x));
            const float2 xk = add(e, cmul(tw[k], o));
            tp[k] = xk;
            const float g = mg[j] * invP;
            if (k == 0 || k == P) {  // real bins
              const float nr = xk.x - s.mom * prev[j].x;
              spec[k] = make_float2(g * nr / fmaxf(fabsf(nr), 1e-16f), 0.f);
            } else {
              const float nr = xk.x - s.mom * prev[j].x;
              const float ni = xk.y - s.mom * prev[j].y;
              const float h = g / fmaxf(sqrtf(nr * nr + ni * ni), 1e-16f);
              spec[k] = make_float2(nr * h, ni * h);
            }
          }
        } else {
          spec = bx;
          work = by;
          for (int k = lane; k <= P; k += kWarp) {
            const float mg = mag_m[size_t(k) * T + t];
            const float2 a = ang_m[size_t(k) * T + t];
            mt[k] = mg;
            tp[k] = make_float2(0.f, 0.f);
            spec[k] = (k == 0 || k == P) ? make_float2(mg * a.x * invP, 0.f)
                                         : make_float2(mg * a.x * invP, mg * a.y * invP);
          }
        }
        __syncwarp();
        // inverse split step: Z'[k] = E[k] + i O[k], with
        // E = (C[k] + conj C[P-k]) / 2, O = (C[k] - conj C[P-k]) / 2 * exp(+2 pi i k / N)
        for (int k = lane; k < P; k += kWarp) {
          const float2 ck = spec[k], cc = conjf2(spec[P - k]);
          const float2 e = make_float2(0.5f * (ck.x + cc.x), 0.5f * (ck.y + cc.y));
          const float2 o = cmul(make_float2(0.5f * (ck.x - cc.x), 0.5f * (ck.y - cc.y)),
                                conjf2(tw[k]));
          work[k] = add(e, mul_i(o));
        }
        __syncwarp();
        const float2* z = warp_fft<P, N>(work, spec, tw, true, lane);
        float2* dst = reinterpret_cast<float2*>(ola + t * hop);
        const float2* w2 = reinterpret_cast<const float2*>(win);
        for (int n = lane; n < P; n += kWarp) {
          const float2 v = z[n], w = w2[n];
          float2 acc = dst[n];
          acc.x = fmaf(v.x, w.x, acc.x);
          acc.y = fmaf(v.y, w.y, acc.y);
          dst[n] = acc;
        }
        __syncwarp();
      }
      __syncthreads();  // the next residue class overlaps this one's frames
    }
    if (it < s.n_iter - 1) {
      // normalise into core for the next analysis; reset the accumulator
      for (int i = threadIdx.x; i < olen; i += blockDim.x) {
        const float v = ola[i];
        ola[i] = 0.0f;
        const int j = i - pad;
        if (j >= 0 && j < L) core[j] = v * inv_wsq[j];
      }
      __syncthreads();
    }
  }

  float* out_m = out + size_t(m) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    out_m[j] = ola[pad + j] * inv_wsq[j];
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
// Warps per block: one per frame of a residue class, as far as shared
// memory (one block per SM) and kMaxWarps allow.
int neraf_gl_launch(const float* mag, const void* ang0, const void* tw,
                    const float* win, const float* inv_wsq, void* tprev,
                    float* mag_t, float* out, int M, int T, int n_fft,
                    int hop, int length, int n_iter, float mom, void* stream) {
  const size_t base = gl_base_bytes(n_fft, hop, T, length);
  const size_t per_warp = gl_warp_bytes(n_fft);
  if (base + per_warp > kSmemPerBlock) return int(cudaErrorInvalidValue);
  const int q = n_fft / hop;
  size_t warps = (kSmemPerBlock - base) / per_warp;
  warps = warps < size_t(kMaxWarps) ? warps : size_t(kMaxWarps);
  warps = warps < size_t((T + q - 1) / q) ? warps : size_t((T + q - 1) / q);
  const size_t smem = base + warps * per_warp;
  void (*kernel)(const float*, const float2*, const float2*, const float*,
                 const float*, float2*, float*, float*, GLShape);
  switch (n_fft) {
    case 256: kernel = griffin_lim_kernel<256>; break;
    case 512: kernel = griffin_lim_kernel<512>; break;
    case 1024: kernel = griffin_lim_kernel<1024>; break;
    default: return int(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  GLShape s{T, hop, length, n_iter, mom};
  kernel<<<M, int(warps) * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, static_cast<const float2*>(ang0), static_cast<const float2*>(tw),
      win, inv_wsq, static_cast<float2*>(tprev), mag_t, out, s);
  return int(cudaGetLastError());
}

const char* neraf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
