// Fused prequant + zero-halo 3D Lorenzo codes, and their inverse, over
// tiles: each (tx, ty, tz) tile of a brick is predicted on its own, with
// a zero halo on its low faces.
//
// Replaces the TPU kernels of src/repro/kernels/lorenzo3d.py:
//   lorenzo3d_codes_batched / lorenzo3d_recon_batched  (N, X, Y, Z) stack,
//                                                      tile = brick (K1, K2)
//   lorenzo3d_codes / lorenzo3d_recon                  one (X, Y, Z) array,
//                                                      any tile (K5, K6)
// Both pairs run the same kernels; the batched pair passes tile = brick.
// The arithmetic is the reference's float64 host path, not the Pallas
// bodies' float32: q = rint(float64(x) / (2 eb)) (IEEE division, round
// half to even), int64 codes, and dequant float32(float64(q) * 2 eb).
// Build without --use_fast_math so the division stays correctly rounded.
// All index arithmetic is 64-bit: a 512^3 grid has 1.3e8 elements.
//
// Bound: bytes.  Codes read 4 B and write 8 B per element; recon reads
// 8 B and writes 4 B per element.  Codes use one thread per element and
// evaluate the 8-corner stencil from the float input (the neighbours sit
// in L1/L2), so the int64 prequant grid is never stored.  Recon runs
// three sequential scans, one thread per line, restarting at tile edges:
// X and Y scans are coalesced across the Z index, the last scan (Z, fused
// with the dequant) walks contiguous lines one per thread and is not
// coalesced.  The scans move about 44 B per element against the bound's
// 12.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kSkipZero: a zero skips the float64 division (+-0 / 2eb rounds to the
// code 0 all the same), whose slow path a zero numerator takes.  The
// choice follows what each entry is given.  The single-array entry (K5)
// codes whole grids, which hold zeros wherever a level is not fully
// occupied: the test cut K5 by 18 % on a 92 %-dense GSP-padded 128^3
// level (3.5 % zeros) and by 2.2x on a 67 %-zero 512^3 grid.  The
// brick-stack entry (K1) codes occupied blocks only, where any zero test
// measured (this branch, a branch-free select, a per-warp vote) cost
// 10 % (chip_smoke.py on an H100; PERF.md).
template <bool kSkipZero>
__device__ __forceinline__ long long prequant(float v, double two_eb) {
  if (kSkipZero && v == 0.0f) return 0;
  return (long long)rint((double)v / two_eb);
}

// Element (i, j, k) of brick idx / (X*Y*Z); a corner across a low tile
// face (i % tx == 0, ...) is the zero halo.  Untiled launches (tile =
// brick) test i == 0 and skip the three modulos.
template <bool kTiled, bool kSkipZero>
__global__ void codes_kernel(const float* __restrict__ x,
                             long long* __restrict__ codes, long long total,
                             int X, int Y, int Z, int tx, int ty, int tz,
                             double two_eb) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int k = (int)(idx % Z);
  const long long t = idx / Z;
  const int j = (int)(t % Y);
  const int i = (int)((t / Y) % X);
  const long long sy = Z, sx = (long long)Y * Z;
  const bool hi = kTiled ? i % tx == 0 : i == 0;
  const bool hj = kTiled ? j % ty == 0 : j == 0;
  const bool hk = kTiled ? k % tz == 0 : k == 0;
  long long c = 0;
  for (int di = 0; di < 2; ++di) {
    if (di && hi) continue;
    for (int dj = 0; dj < 2; ++dj) {
      if (dj && hj) continue;
      for (int dk = 0; dk < 2; ++dk) {
        if (dk && hk) continue;
        const long long q =
            prequant<kSkipZero>(x[idx - di * sx - dj * sy - dk], two_eb);
        c += ((di + dj + dk) & 1) ? -q : q;
      }
    }
  }
  codes[idx] = c;
}

// Inclusive scan along one axis: `len` steps of `inner` elements each,
// restarting every `tile` steps; lines are (outer, inner) pairs.  May run
// in place (in == out): each element is read before it is written, by
// the one thread owning its line.
__global__ void scan_kernel(const long long* in, long long* out,
                            long long n_lines, int len, int tile,
                            long long inner) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= n_lines) return;
  const long long base = (line / inner) * len * inner + line % inner;
  long long acc = 0;
  for (int m = 0; m < len; ++m) {
    if (m % tile == 0) acc = 0;
    acc += in[base + m * inner];
    out[base + m * inner] = acc;
  }
}

// Last scan along Z, fused with the dequant.
__global__ void scan_z_dequant_kernel(const long long* __restrict__ in,
                                      float* __restrict__ out,
                                      long long n_lines, int Z, int tz,
                                      double two_eb) {
  long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= n_lines) return;
  const long long base = line * Z;
  long long acc = 0;
  for (int m = 0; m < Z; ++m) {
    if (m % tz == 0) acc = 0;
    acc += in[base + m];
    out[base + m] = (float)((double)acc * two_eb);
  }
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <bool kSkipZero>
int codes_launch(const float* x, long long* codes, long long n, int X, int Y,
                 int Z, int tx, int ty, int tz, double two_eb,
                 cudaStream_t stream) {
  const long long total = n * X * Y * Z;
  if (total == 0) return 0;
  const unsigned grid = blocks_for(total, 256);
  if (tx == X && ty == Y && tz == Z) {
    codes_kernel<false, kSkipZero><<<grid, 256, 0, stream>>>(
        x, codes, total, X, Y, Z, tx, ty, tz, two_eb);
  } else {
    codes_kernel<true, kSkipZero><<<grid, 256, 0, stream>>>(
        x, codes, total, X, Y, Z, tx, ty, tz, two_eb);
  }
  return (int)cudaGetLastError();
}

// `scratch` holds the int64 partial sums (same shape as `codes`).
int recon_launch(const long long* codes, long long* scratch, float* out,
                 long long n, int X, int Y, int Z, int tx, int ty, int tz,
                 double two_eb, cudaStream_t stream) {
  const long long total = n * X * Y * Z;
  if (total == 0) return 0;
  const long long yz = (long long)Y * Z;
  long long lines = n * yz;  // scan along X
  scan_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(codes, scratch,
                                                          lines, X, tx, yz);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  lines = n * X * (long long)Z;  // scan along Y, in place
  scan_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(scratch, scratch,
                                                          lines, Y, ty, Z);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  lines = n * X * (long long)Y;  // scan along Z + dequant
  scan_z_dequant_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(
      scratch, out, lines, Z, tz, two_eb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lorenzo3d_codes_batched(const float* x, long long* codes,
                                       long long n, int X, int Y, int Z,
                                       double two_eb, cudaStream_t stream) {
  return codes_launch<false>(x, codes, n, X, Y, Z, X, Y, Z, two_eb, stream);
}

extern "C" int lorenzo3d_recon_batched(const long long* codes,
                                       long long* scratch, float* out,
                                       long long n, int X, int Y, int Z,
                                       double two_eb, cudaStream_t stream) {
  return recon_launch(codes, scratch, out, n, X, Y, Z, X, Y, Z, two_eb,
                      stream);
}

extern "C" int lorenzo3d_codes(const float* x, long long* codes, int X, int Y,
                               int Z, int tx, int ty, int tz, double two_eb,
                               cudaStream_t stream) {
  return codes_launch<true>(x, codes, 1, X, Y, Z, tx, ty, tz, two_eb, stream);
}

extern "C" int lorenzo3d_recon(const long long* codes, long long* scratch,
                               float* out, int X, int Y, int Z, int tx,
                               int ty, int tz, double two_eb,
                               cudaStream_t stream) {
  return recon_launch(codes, scratch, out, 1, X, Y, Z, tx, ty, tz, two_eb,
                      stream);
}
