// Shifted-slice concat for Hopper (sm_90a).
//
// Replaces neraf_tpu/ops/pallas/gl_crash_repro.py::shifted_value_concat
// (kernel body :43-45): for x (M, ROWS, HOP) f32 and t <= ROWS - 1,
//   out[m, r, :HOP] = x[m, r, :],  out[m, r, HOP:] = x[m, r + 1, :]
// (M, t, 2 HOP) f32, the two-strip framing of the JAX Griffin-Lim, which
// the TPU compiler could not build from a concat of row-shifted values. On
// the card it is a copy: one thread per 16 bytes of the output (float4) when
// HOP is a multiple of 4 and both pointers are 16-byte aligned, else one per
// float. Bound by device memory: x read once (the shifted strip re-reads
// each row but the second, from the L2) and the output written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// V is float4 (hop in units of 4 floats) or float.
template <typename V>
__global__ void shifted_concat_kernel(const V* __restrict__ x,
                                      V* __restrict__ out, int m, int rows,
                                      int t, int hop) {
  const size_t width = 2 * size_t(hop);
  const size_t total = size_t(m) * t * width;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t c = i % width, mr = i / width;
    const size_t r = mr % t, mm = mr / t;
    const bool second = c >= size_t(hop);
    const size_t src = (mm * rows + r + (second ? 1 : 0)) * hop +
                       (second ? c - hop : c);
    out[i] = __ldg(x + src);
  }
}

}  // namespace

extern "C" {

// Launches the shifted-slice concat on `stream`: x (m, rows, hop) f32
// contiguous -> out (m, t, 2 hop) f32. Returns the first cudaError_t.
int neraf_shifted_concat_launch(const float* x, float* out, int m, int rows,
                                int t, int hop, void* stream) {
  if (m < 0 || hop < 1 || t < 0 || t > rows - 1) return int(cudaErrorInvalidValue);
  const size_t total = size_t(m) * t * 2 * hop;
  if (total == 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = hop % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const size_t items = vec ? total / 4 : total;
  const int threads = 256;
  const size_t want = (items + threads - 1) / threads;
  const int blocks = int(want < 65536 ? want : 65536);
  if (vec)
    shifted_concat_kernel<float4><<<blocks, threads, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), m,
        rows, t, hop / 4);
  else
    shifted_concat_kernel<float><<<blocks, threads, 0, st>>>(x, out, m, rows, t,
                                                             hop);
  return int(cudaGetLastError());
}

}  // extern "C"
