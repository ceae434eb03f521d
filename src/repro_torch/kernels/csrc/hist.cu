// Histogram of int64 quantization codes shifted by `lo` and clipped to
// [0, n_bins): the one histogram SHE builds its shared codebook from.
//
// Replaces the TPU kernel `hist` (src/repro/kernels/hist.py), a one-hot
// matmul per chunk.  On Hopper it is a scatter: each block keeps
// privatized 32-bit bins in shared memory when the span fits
// (n_bins <= kMaxSharedBins, 48 KB), grid-strides over the codes with
// shared atomics, then flushes its nonzero bins into the 64-bit global
// counts.  Wider spans count with 64-bit global atomics directly.
//
// Bound: bytes (8 B read per code).  Shared-memory atomics contend when
// the codes cluster on a few bins, which quantization codes do (most are
// near zero).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBins = 12288;

__device__ __forceinline__ long long bin_of(long long c, long long lo,
                                            int n_bins) {
  long long v = c - lo;
  return v < 0 ? 0 : (v >= n_bins ? n_bins - 1 : v);
}

__global__ void hist_shared_kernel(const long long* __restrict__ codes,
                                   long long n, long long lo, int n_bins,
                                   unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned int bins[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    atomicAdd(&bins[bin_of(codes[i], lo, n_bins)], 1u);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
    if (bins[b]) atomicAdd(&counts[b], (unsigned long long)bins[b]);
}

__global__ void hist_global_kernel(const long long* __restrict__ codes,
                                   long long n, long long lo, int n_bins,
                                   unsigned long long* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    atomicAdd(&counts[bin_of(codes[i], lo, n_bins)], 1ull);
}

}  // namespace

// `counts` (n_bins int64) must be zeroed by the caller.
extern "C" int hist_codes(const long long* codes, long long n, long long lo,
                          int n_bins, long long* counts, int n_sms,
                          cudaStream_t stream) {
  if (n == 0 || n_bins <= 0) return 0;
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  long long cap = 8LL * n_sms;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  auto* out = reinterpret_cast<unsigned long long*>(counts);
  if (n_bins <= kMaxSharedBins) {
    hist_shared_kernel<<<grid, threads, n_bins * sizeof(unsigned int),
                         stream>>>(codes, n, lo, n_bins, out);
  } else {
    hist_global_kernel<<<grid, threads, 0, stream>>>(codes, n, lo, n_bins,
                                                     out);
  }
  return (int)cudaGetLastError();
}
