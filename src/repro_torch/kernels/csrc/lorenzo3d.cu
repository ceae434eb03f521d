// Fused prequant + zero-halo 3D Lorenzo codes, and their inverse, over a
// (N, X, Y, Z) stack of bricks.
//
// Replaces the TPU kernels lorenzo3d_codes_batched and
// lorenzo3d_recon_batched (src/repro/kernels/lorenzo3d.py).  The
// arithmetic is the reference's float64 host path, not the Pallas bodies'
// float32: q = rint(float64(x) / (2 eb)) (IEEE division, round half to
// even), int64 codes, and dequant float32(float64(q) * 2 eb).  Build
// without --use_fast_math so the division stays correctly rounded.
//
// Bound: bytes.  Codes read 4 B and write 8 B per element; recon reads
// 8 B and writes 4 B per element.  Codes use one thread per element and
// evaluate the 8-corner stencil from the float input (the neighbours sit
// in L1/L2), so the int64 prequant grid is never stored.  Recon runs
// three sequential scans, one thread per line: X and Y scans are
// coalesced across the Z index, the last scan (Z, fused with the
// dequant) walks contiguous lines one per thread and is not coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long prequant(float v, double two_eb) {
  return (long long)rint((double)v / two_eb);
}

__global__ void codes_kernel(const float* __restrict__ x,
                             long long* __restrict__ codes, long long total,
                             int X, int Y, int Z, double two_eb) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int k = (int)(idx % Z);
  const long long t = idx / Z;
  const int j = (int)(t % Y);
  const int i = (int)((t / Y) % X);
  const long long sy = Z, sx = (long long)Y * Z;
  long long c = 0;
  for (int di = 0; di < 2; ++di) {
    if (di && i == 0) continue;
    for (int dj = 0; dj < 2; ++dj) {
      if (dj && j == 0) continue;
      for (int dk = 0; dk < 2; ++dk) {
        if (dk && k == 0) continue;
        const long long q = prequant(x[idx - di * sx - dj * sy - dk], two_eb);
        c += ((di + dj + dk) & 1) ? -q : q;
      }
    }
  }
  codes[idx] = c;
}

// Inclusive scan along one axis: `len` steps of `inner` elements each;
// lines are (outer, inner) pairs.  May run in place (in == out): each
// element is read before it is written, by the one thread owning its line.
__global__ void scan_kernel(const long long* in, long long* out,
                            long long n_lines,
                            int len, long long inner) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= n_lines) return;
  const long long base = (line / inner) * len * inner + line % inner;
  long long acc = 0;
  for (int m = 0; m < len; ++m) {
    acc += in[base + m * inner];
    out[base + m * inner] = acc;
  }
}

// Last scan along Z, fused with the dequant.
__global__ void scan_z_dequant_kernel(const long long* __restrict__ in,
                                      float* __restrict__ out,
                                      long long n_lines, int Z,
                                      double two_eb) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= n_lines) return;
  const long long base = line * Z;
  long long acc = 0;
  for (int m = 0; m < Z; ++m) {
    acc += in[base + m];
    out[base + m] = (float)((double)acc * two_eb);
  }
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int lorenzo3d_codes_batched(const float* x, long long* codes,
                                       long long n, int X, int Y, int Z,
                                       double two_eb, cudaStream_t stream) {
  const long long total = n * X * Y * Z;
  if (total == 0) return 0;
  codes_kernel<<<blocks_for(total, 256), 256, 0, stream>>>(x, codes, total, X,
                                                           Y, Z, two_eb);
  return (int)cudaGetLastError();
}

// `scratch` holds the int64 partial sums (same shape as `codes`).
extern "C" int lorenzo3d_recon_batched(const long long* codes,
                                       long long* scratch, float* out,
                                       long long n, int X, int Y, int Z,
                                       double two_eb, cudaStream_t stream) {
  const long long total = n * X * Y * Z;
  if (total == 0) return 0;
  const long long yz = (long long)Y * Z;
  long long lines = n * yz;  // scan along X
  scan_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(codes, scratch,
                                                          lines, X, yz);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  lines = n * X * (long long)Z;  // scan along Y, in place
  scan_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(scratch, scratch,
                                                          lines, Y, Z);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  lines = n * X * (long long)Y;  // scan along Z + dequant
  scan_z_dequant_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(
      scratch, out, lines, Z, two_eb);
  return (int)cudaGetLastError();
}
