// Fused prequant + zero-halo 3D Lorenzo codes, and their inverse, over
// tiles: each (tx, ty, tz) tile of a brick is predicted on its own, with
// a zero halo on its low faces.
//
// Replaces the TPU kernels of src/repro/kernels/lorenzo3d.py:
//   lorenzo3d_codes_batched / lorenzo3d_recon_batched  (N, X, Y, Z) stack,
//                                                      tile = brick (K1, K2)
//   lorenzo3d_codes / lorenzo3d_recon                  one (X, Y, Z) array,
//                                                      any tile (K5, K6)
// The arithmetic is the reference's float64 host path, not the Pallas
// bodies' float32: q = rint(float64(x) / (2 eb)) (IEEE division, round
// half to even), int64 codes, and dequant float32(float64(q) * 2 eb).
// Build without --use_fast_math so the division stays correctly rounded.
//
// Bound: bytes.  Codes read 4 B and write 8 B per element; recon reads
// 8 B and writes 4 B per element: 12 B either way.
//
// Codes (K1 on a brick stack; K5 on one array at tile = shape, the only
// tile its callers use, as a one-brick stack): the plane walk
// (codes_bricks_kernel).  A block walks the X planes of its bricks, or of
// one Y band and X slab of a brick, prequantizing each element once into
// int64 plane buffers in shared memory: 12 B per element plus the halo
// planes and rows.  K5 walks with one unit of 4 values a thread (more
// units a thread, for bands of more rows and less halo, lost: PERF.md),
// and 4 units where a row loads one value a unit.  The elementwise
// kernel (codes_kernel: one thread per element, 64-bit indices, the
// 8-corner stencil evaluated from the float input with each corner
// prequantized again, 8 float64 divisions per element) takes K1's small
// stacks and long rows, and K5's other tiles and rows past 512 values.
//
// Recon of a brick stack (K2, lorenzo3d_recon_bricks): one block holds one
// brick, or several small ones, in shared memory as int64 with each Z line
// padded by one element, so that the X, Y and Z scans (one thread per
// line) are free of bank conflicts.  The block loads its bricks with
// coalesced 16-byte loads, runs the three inclusive scans in shared
// memory and stores the dequantized float32 values coalesced: 12 B of
// device traffic per element, the bound's.  A brick past one block's
// 227 KB (kSmemBudget), 32^3 and up, takes two launches: blocks of X
// planes run the Y and Z scans in shared memory and store int64 partial
// sums, then one thread per line runs the X scan through them, coalesced,
// fused with the dequant (28 B per element, but a few large bricks still
// spread over every SM).  ops.recon_route decides from the shape alone:
// "shared" (whole bricks), "planes", or "three_pass" when one padded
// (Y, Z) plane exceeds the budget (no main-path brick does).
//
// Recon of one array at tile = shape (K6, lorenzo3d_recon_planes): two
// launches.  Pass A (recon_yz_kernel) gives each X plane a block that
// walks it in bands of 64 KB: a warp scans a row along Z from coalesced
// 16-byte loads (a serial scan in each lane, a shuffle scan across
// lanes, the carry passed from chunk to chunk), one thread per column
// pair scans the band along Y with the carry of the rows above, and the
// int64 partial sums go out coalesced.  Pass B (recon_x_kernel) runs the
// X scan fused with the dequant, one thread per column pair with 16
// planes' loads in flight.  28 B per element (8 + 8 in pass A, 8 + 4 in pass B).
//
// The three-pass route (recon_launch: K2's largest planes, and K6's other
// tiles and rows past 4,096 values): three sequential scans through
// device memory, one thread per line, restarting at tile edges, the last
// (Z, fused with the dequant) walking contiguous lines one per thread,
// uncoalesced: about 44 B per element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kSkipZero: a zero skips the float64 division (+-0 / 2eb rounds to the
// code 0 all the same), whose slow path a zero numerator takes.  The
// choice follows what each kernel is given.  The single-array codes (K5)
// cover whole grids, which hold zeros wherever a level is not fully
// occupied: the test cut the elementwise design by 18 % on a 92 %-dense
// GSP-padded 128^3 level (3.5 % zeros) and by 2.2x on a 67 %-zero 512^3
// grid, and K5's walk keeps it where it wins in the same call on both
// grids (ops.K5_SKIP_ZERO; PERF.md).  The brick stacks (K1) hold occupied
// blocks only, where any zero test measured (this branch, a branch-free
// select, a per-warp vote) cost 10 % (chip_smoke.py on an H100; PERF.md).
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

// Bytes of shared memory one block may use (H100: 227 KB).
constexpr int kSmemBudget = 232448;
constexpr int kBrickThreads = 256;
// Shared memory a plane block aims at: three to an SM.
constexpr int kPlaneTarget = 64 * 1024;
// Dynamic shared memory a kernel gets without cudaFuncSetAttribute.
constexpr int kSmemDefault = 48 * 1024;
// Loads in flight per thread while a tile is read into shared memory.
constexpr int kUnroll = 4;

// Shared slot of element e of a tile of Z-long lines, each padded by one
// int64: the Z scan's threads, Z + 1 words apart, fall on distinct banks.
__device__ __forceinline__ int padded(int e, int Z) {
  const int line = e / Z;
  return line * (Z + 1) + (e - line * Z);
}

// `total` int64 codes from device memory into padded shared lines, with
// kUnroll coalesced loads in flight per thread (two codes a load when
// kVec: Z even and 16-byte aligned).
template <bool kVec>
__device__ void load_tile(const long long* __restrict__ src, int total, int Z,
                          long long* __restrict__ s) {
  if (kVec) {
    const longlong2* v2 = reinterpret_cast<const longlong2*>(src);
    const int nv = total / 2;
    for (int h0 = threadIdx.x; h0 < nv; h0 += kUnroll * blockDim.x) {
      longlong2 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int h = h0 + u * blockDim.x;
        if (h < nv) v[u] = v2[h];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int h = h0 + u * blockDim.x;
        if (h < nv) {
          const int at = padded(2 * h, Z);
          s[at] = v[u].x;
          s[at + 1] = v[u].y;
        }
      }
    }
  } else {
    for (int e0 = threadIdx.x; e0 < total; e0 += kUnroll * blockDim.x) {
      long long v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) v[u] = src[e];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) s[padded(e, Z)] = v[u];
      }
    }
  }
}

// The dequantized tile, float32(float64(q) * 2eb), stored coalesced.
__device__ void store_tile(float* __restrict__ dst, int total, int Z,
                           const long long* __restrict__ s, double two_eb) {
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    dst[e] = (float)((double)s[padded(e, Z)] * two_eb);
}

// Inclusive scans of `n_lines` lines of `len` steps `stride` apart; line t
// starts at first(t).
template <class F>
__device__ __forceinline__ void scan_lines(long long* s, int n_lines, int len,
                                           int stride, F first) {
  for (int t = threadIdx.x; t < n_lines; t += blockDim.x) {
    long long* q = s + first(t);
    long long acc = 0;
    for (int m = 0; m < len; ++m) {
      acc += q[m * stride];
      q[m * stride] = acc;
    }
  }
}

// K2: `per_block` whole bricks of one (X, Y, Z) stack per block.
template <bool kVec>
__global__ void __launch_bounds__(kBrickThreads)
recon_bricks_kernel(const long long* __restrict__ codes,
                    float* __restrict__ out, long long n, int X, int Y, int Z,
                    int per_block, double two_eb) {
  extern __shared__ long long s_brick[];
  const int zp = Z + 1, yz = Y * Z, xz = X * Z, vol_p = X * Y * zp;
  const long long b0 = (long long)blockIdx.x * per_block;
  const int nb = (int)(n - b0 < per_block ? n - b0 : per_block);
  const long long base = b0 * X * yz;
  const int total = nb * X * yz;
  load_tile<kVec>(codes + base, total, Z, s_brick);
  __syncthreads();
  // X: lines (brick, j, k), stride Y * zp
  scan_lines(s_brick, nb * yz, X, Y * zp, [&](int t) {
    const int bk = t / yz, r = t - bk * yz, j = r / Z;
    return bk * vol_p + j * zp + (r - j * Z);
  });
  __syncthreads();
  // Y: lines (brick, i, k), stride zp
  scan_lines(s_brick, nb * xz, Y, zp, [&](int t) {
    const int bk = t / xz, r = t - bk * xz, i = r / Z;
    return bk * vol_p + i * Y * zp + (r - i * Z);
  });
  __syncthreads();
  // Z: lines (brick, i, j), contiguous
  scan_lines(s_brick, nb * X * Y, Z, 1, [&](int t) { return t * zp; });
  __syncthreads();
  store_tile(out + base, total, Z, s_brick, two_eb);
}

// K2 for bricks past one block's shared memory (32^3 and up), in two
// launches.  Blocks of `px` X planes run the Y and Z scans in shared
// memory and store the int64 partial sums; then one thread per (brick, j,
// k) line runs the X scan through them, coalesced across k, fused with the
// dequant (the scans commute: int64 sums are exact).  28 B of device
// traffic per element instead of 12, but a stack of a few large bricks
// still spreads over every SM.
template <bool kVec>
__global__ void __launch_bounds__(kBrickThreads)
planes_yz_kernel(const long long* __restrict__ codes,
                 long long* __restrict__ partial, int X, int Y, int Z,
                 int px, int groups) {
  extern __shared__ long long s_pl[];
  const int zp = Z + 1, yz = Y * Z, plane_p = Y * zp;
  const long long brick = blockIdx.x / groups;
  const int x0 = (int)(blockIdx.x - brick * groups) * px;
  const int nx = X - x0 < px ? X - x0 : px;
  const long long sb = (brick * X + x0) * yz;
  load_tile<kVec>(codes + sb, nx * yz, Z, s_pl);
  __syncthreads();
  // Y: lines (plane, k), stride zp
  scan_lines(s_pl, nx * Z, Y, zp, [&](int t) {
    const int pl = t / Z;
    return pl * plane_p + (t - pl * Z);
  });
  __syncthreads();
  // Z: lines (plane, j), contiguous
  scan_lines(s_pl, nx * Y, Z, 1, [&](int t) { return t * zp; });
  __syncthreads();
  for (int e = threadIdx.x; e < nx * yz; e += blockDim.x)
    partial[sb + e] = s_pl[padded(e, Z)];
}

__global__ void scan_x_dequant_kernel(const long long* __restrict__ partial,
                                      float* __restrict__ out,
                                      long long n_lines, int X, long long yz,
                                      double two_eb) {
  const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= n_lines) return;
  const long long base = (line / yz) * X * yz + line % yz;
  long long acc = 0;
  for (int i = 0; i < X; ++i) {
    acc += partial[base + i * yz];
    out[base + i * yz] = (float)((double)acc * two_eb);
  }
}

// K6 at tile = shape (lorenzo3d_recon_planes), pass A: the Y and Z scans
// of one X plane per block (kScanThreads threads: 512 when the planes
// are too few to give each SM two blocks, else 256), which walks the
// plane in bands of `rows` rows (about kBandBytes of int64).  Per band:
//   - Z scan, one warp per row: each lane loads VEC consecutive codes
//     (16 bytes when VEC == 2), a chunk of 32·VEC values a warp, scans
//     them, then a shuffle scan of the lane totals; the row's carry passes
//     from chunk to chunk.  A warp issues kRowLoads chunks' loads (its
//     rows' chunks in order) before it scans them.  The band goes to
//     shared memory.
//   - Y scan, one thread per unit of VEC columns, walking the band's rows
//     from shared memory with the carry of the rows above (one int64 row
//     in shared memory); it stores the int64 partial sums, coalesced.
// Row indices inside a plane are 32-bit; the plane's base is 64-bit.
constexpr int kBandBytes = 64 * 1024;
constexpr int kRowLoads = 8;

template <int VEC>
__device__ __forceinline__ void load_units(const long long* p, bool ok,
                                           long long (&v)[VEC]) {
  if (!ok) {
#pragma unroll
    for (int m = 0; m < VEC; ++m) v[m] = 0;
  } else if (VEC == 2) {
    const longlong2 a = *reinterpret_cast<const longlong2*>(p);
    v[0] = a.x;
    v[VEC > 1 ? 1 : 0] = a.y;
  } else {
    v[0] = p[0];
  }
}

template <int VEC, int kScanThreads>
__global__ void __launch_bounds__(kScanThreads)
recon_yz_kernel(const long long* __restrict__ codes,
                long long* __restrict__ partial, int Y, int Z, int rows) {
  extern __shared__ long long s_band[];  // rows x Z, then the carry row
  long long* carry = s_band + rows * Z;
  const long long plane = (long long)blockIdx.x * Y * Z;
  const long long* src = codes + plane;
  long long* dst = partial + plane;
  constexpr int kWarps = kScanThreads / 32, kChunk = 32 * VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (Z + kChunk - 1) / kChunk;
  for (int k = threadIdx.x; k < Z; k += kScanThreads) carry[k] = 0;
  for (int y0 = 0; y0 < Y; y0 += rows) {
    const int nr = Y - y0 < rows ? Y - y0 : rows;
    // Z scan: warp w takes rows w, w + kWarps, ...; item t of the warp is
    // chunk t % chunks of its row t / chunks
    const int my_rows = nr > warp ? (nr - warp + kWarps - 1) / kWarps : 0;
    const int items = my_rows * chunks;
    long long rc = 0;  // the row's carry, the same in every lane
    for (int t0 = 0; t0 < items; t0 += kRowLoads) {
      long long v[kRowLoads][VEC];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int t = t0 + u;
        const int r = warp + (t / chunks) * kWarps;
        const int kk = (t % chunks) * kChunk + lane * VEC;
        load_units<VEC>(src + (long long)(y0 + r) * Z + kk,
                        t < items && kk < Z, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int t = t0 + u;
        if (t >= items) break;  // warp-uniform
        const int c = t % chunks, r = warp + (t / chunks) * kWarps;
        const int kk = c * kChunk + lane * VEC;
        if (c == 0) rc = 0;
#pragma unroll
        for (int m = 1; m < VEC; ++m) v[u][m] += v[u][m - 1];
        const long long tot = v[u][VEC - 1];
        long long incl = tot;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long o = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += o;
        }
        const long long add = incl - tot + rc;
        rc += __shfl_sync(0xffffffffu, incl, 31);
        if (kk < Z) {
          long long* at = s_band + r * Z + kk;
          if (VEC == 2) {
            *reinterpret_cast<longlong2*>(at) =
                make_longlong2(v[u][0] + add, v[u][VEC - 1] + add);
          } else {
            at[0] = v[u][0] + add;
          }
        }
      }
    }
    __syncthreads();
    // Y scan: one thread per unit of VEC columns
    for (int kk = threadIdx.x * VEC; kk < Z; kk += kScanThreads * VEC) {
      long long acc[VEC];
      load_units<VEC>(carry + kk, true, acc);
      for (int r = 0; r < nr; ++r) {
        long long v[VEC];
        load_units<VEC>(s_band + r * Z + kk, true, v);
#pragma unroll
        for (int m = 0; m < VEC; ++m) acc[m] += v[m];
        long long* out = dst + (long long)(y0 + r) * Z + kk;
        if (VEC == 2) {
          *reinterpret_cast<longlong2*>(out) =
              make_longlong2(acc[0], acc[VEC - 1]);
        } else {
          out[0] = acc[0];
        }
      }
#pragma unroll
      for (int m = 0; m < VEC; ++m) carry[kk + m] = acc[m];
    }
    __syncthreads();
  }
}

// K6 at tile = shape, pass B: the X scan fused with the dequant, one
// thread per unit of VEC (j, k) columns, coalesced across k, with the
// loads of kXLoads planes in flight before their sums.
constexpr int kXLoads = 16;
constexpr int kXThreads = 64;

template <int VEC>
__global__ void __launch_bounds__(kXThreads)
recon_x_kernel(const long long* __restrict__ partial, float* __restrict__ out,
               int X, int units, long long yz, double two_eb) {
  const int unit = blockIdx.x * kXThreads + threadIdx.x;
  if (unit >= units) return;
  const long long* p = partial + (long long)unit * VEC;
  float* o = out + (long long)unit * VEC;
  long long acc[VEC];
#pragma unroll
  for (int m = 0; m < VEC; ++m) acc[m] = 0;
  for (int i0 = 0; i0 < X; i0 += kXLoads) {
    long long v[kXLoads][VEC];
#pragma unroll
    for (int u = 0; u < kXLoads; ++u)
      load_units<VEC>(p + (i0 + u) * yz, i0 + u < X, v[u]);
#pragma unroll
    for (int u = 0; u < kXLoads; ++u) {
      if (i0 + u >= X) break;
      float f[VEC];
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        acc[m] += v[u][m];
        f[m] = (float)((double)acc[m] * two_eb);
      }
      float* dst = o + (i0 + u) * yz;
      if (VEC == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(f[0], f[VEC - 1]);
      } else {
        dst[0] = f[0];
      }
    }
  }
}

// The plane walk (codes_bricks_kernel): K1 on a brick stack, and K5 on
// one array at tile = shape (a one-brick stack).  A block takes nb whole
// bricks (as many as fill its 256 threads' units: 4 of 16^3, 16 of 8^3),
// or one Y band of one brick's planes (as many rows as fill the units,
// plus the row above as a halo), over the X planes [x0, x1) of one slab:
// stacks of few bricks are cut along X into slabs so that the card holds
// about `blocks_per_sm` blocks per SM, each slab prequantizing one halo
// plane more.  The block walks its planes in order.  Each thread owns RU
// units of VEC contiguous Z values (a 16-byte load when Z % 4 == 0),
// units tid, tid + 256, ..., the same on every plane, and
//   - prequantizes its units of plane p once (one float64 division and
//     rint per element) into one of two int64 plane buffers in shared
//     memory, then issues the loads of plane p + 2 (two planes are in
//     flight while it works);
//   - after the barrier, takes the 2D Lorenzo difference d2 = q[j][k] −
//     q[j−1][k] − q[j][k−1] + q[j−1][k−1] from the buffer (zero across a
//     brick's low Y and Z faces) and stores the code d2 − d2 of plane
//     p − 1, which it keeps in registers (zero at a brick's first
//     plane), coalesced.
// The buffers are read along Z by consecutive threads (no bank
// conflicts to pad against); one barrier per plane separates the writes
// of a buffer from the reads of the plane two before.  12 B of device
// traffic per element plus the halo planes and rows; index arithmetic
// is 32-bit inside a brick, 64-bit only for a unit's base offset.
// K1 runs RU = 1 without the zero test (kSkipZero above).  K5 runs
// ops.K5_UNITS with the zero test; RU = 4 gives a 512-value row (128
// units) a band of 7 rows and a halo row where RU = 1 gives one row and
// a halo row, but its registers cost more blocks per SM than the halo
// saves (PERF.md), so it serves rows that load one value a unit.
constexpr int kCodesThreads = 256;

template <int VEC, int RU, bool kSkipZero>
__global__ void __launch_bounds__(kCodesThreads)
codes_bricks_kernel(const float* __restrict__ x, long long* __restrict__ codes,
                    long long n, int X, int Y, int Z, int nb, int slabs,
                    int px, int bands, int py, double two_eb) {
  extern __shared__ long long s_q[];  // two plane buffers
  const int yz = Y * Z;
  const int band = (int)(blockIdx.x % bands);
  const long long rest = blockIdx.x / bands;
  const int slab = (int)(rest % slabs);
  const long long b0 = rest / slabs * nb;
  const int nbh = n - b0 < nb ? (int)(n - b0) : nb;
  const int x0 = slab * px, x1 = X < x0 + px ? X : x0 + px;
  const int p0 = x0 > 0 ? x0 - 1 : 0;
  const int y0 = band * py, y1 = Y < y0 + py ? Y : y0 + py;
  const int y0h = y0 > 0 ? y0 - 1 : 0;  // with the halo row
  const int band_el = (y1 - y0h) * Z, set = nb * band_el;
  // this thread's units: element e of the block's plane buffer, (j, k) in
  // its brick, and the unit's offset in the stack at plane 0
  const int n_units = nbh * band_el / VEC;
  bool live[RU];
  int e[RU], j[RU], k[RU];
  long long off[RU];
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int unit = threadIdx.x + r * kCodesThreads;
    live[r] = unit < n_units;
    e[r] = unit * VEC;
    const int bb = e[r] / band_el, jr = (e[r] - bb * band_el) / Z;
    j[r] = y0h + jr;
    k[r] = e[r] - bb * band_el - jr * Z;
    off[r] = (b0 + bb) * X * (long long)yz + (long long)j[r] * Z + k[r];
  }
  auto load = [&](int r, int p, float (&v)[VEC]) {
    if (!live[r] || p >= x1) return;
    const float* src = x + off[r] + (long long)p * yz;
    if (VEC == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = f.x;
      v[VEC > 1 ? 1 : 0] = f.y;
      v[VEC > 2 ? 2 : 0] = f.z;
      v[VEC > 3 ? 3 : 0] = f.w;
    } else {
      v[0] = __ldg(src);
    }
  };
  long long prev[RU][VEC];
#pragma unroll
  for (int r = 0; r < RU; ++r)
#pragma unroll
    for (int m = 0; m < VEC; ++m) prev[r][m] = 0;
  // plane p: prequantize from v, refill v with plane p + 2, then codes
  auto step = [&](int p, float (&v)[RU][VEC]) {
    long long* buf = s_q + ((p - p0) & 1) * set;
    long long q[RU][VEC];
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      if (!live[r]) continue;
#pragma unroll
      for (int m = 0; m < VEC; ++m)
        q[r][m] = prequant<kSkipZero>(v[r][m], two_eb);
      if (VEC == 4) {
        longlong2* b2 = reinterpret_cast<longlong2*>(buf + e[r]);
        b2[0] = make_longlong2(q[r][0], q[r][VEC > 1 ? 1 : 0]);
        b2[1] = make_longlong2(q[r][VEC > 2 ? 2 : 0], q[r][VEC > 3 ? 3 : 0]);
      } else {
        buf[e[r]] = q[r][0];
      }
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) load(r, p + 2, v[r]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RU; ++r) {
      if (!live[r] || j[r] < y0) continue;  // idle, or the halo row
      const long long* at = buf + e[r];
      long long up[VEC];
      if (VEC == 4 && j[r] > 0) {
        const longlong2* u2 = reinterpret_cast<const longlong2*>(at - Z);
        const longlong2 a = u2[0], b = u2[1];
        up[0] = a.x;
        up[VEC > 1 ? 1 : 0] = a.y;
        up[VEC > 2 ? 2 : 0] = b.x;
        up[VEC > 3 ? 3 : 0] = b.y;
      } else {
#pragma unroll
        for (int m = 0; m < VEC; ++m) up[m] = j[r] > 0 ? at[m - Z] : 0;
      }
      long long left = k[r] > 0 ? at[-1] : 0;
      long long up_left = j[r] > 0 && k[r] > 0 ? at[-Z - 1] : 0;
      long long c[VEC];
#pragma unroll
      for (int m = 0; m < VEC; ++m) {
        const long long d2 = q[r][m] - left - up[m] + up_left;
        c[m] = d2 - prev[r][m];
        prev[r][m] = d2;
        left = q[r][m];
        up_left = up[m];
      }
      if (p < x0) continue;  // the slab's halo plane
      long long* dst = codes + off[r] + (long long)p * yz;
      if (VEC == 4) {
        longlong2* d2p = reinterpret_cast<longlong2*>(dst);
        d2p[0] = make_longlong2(c[0], c[VEC > 1 ? 1 : 0]);
        d2p[1] = make_longlong2(c[VEC > 2 ? 2 : 0], c[VEC > 3 ? 3 : 0]);
      } else {
        dst[0] = c[0];
      }
    }
  };
  float va[RU][VEC], vb[RU][VEC];
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    load(r, p0, va[r]);
    load(r, p0 + 1, vb[r]);
  }
  for (int p = p0; p < x1; p += 2) {
    step(p, va);
    if (p + 1 < x1) step(p + 1, vb);
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

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that is
// past the default.
template <class K>
int allow_smem(K kernel, int smem) {
  if (smem <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cache[dev];
}

template <int VEC, int RU, bool kSkipZero>
int codes_bricks_launch(const float* x, long long* codes, long long n, int X,
                        int Y, int Z, int nb, int py, double two_eb,
                        int blocks_per_sm, cudaStream_t stream) {
  const long long groups = (n + nb - 1) / nb;
  const int bands = (Y + py - 1) / py;
  // about blocks_per_sm blocks per SM: cut a stack of few bricks along X,
  // keeping at least two planes a slab
  const long long target = (long long)blocks_per_sm * sm_count();
  const long long base = groups * bands;
  long long slabs = base >= target ? 1 : (target + base - 1) / base;
  if (slabs > X / 2) slabs = X / 2;
  if (slabs < 1) slabs = 1;
  const int px = (int)((X + slabs - 1) / slabs);
  slabs = (X + px - 1) / px;
  if (base * slabs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rows = bands > 1 ? py + 1 : Y;
  const int smem = 2 * nb * rows * Z * (int)sizeof(long long);
  auto kernel = codes_bricks_kernel<VEC, RU, kSkipZero>;
  int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  kernel<<<(unsigned)(base * slabs), kCodesThreads, smem, stream>>>(
      x, codes, n, X, Y, Z, nb, (int)slabs, px, bands, py, two_eb);
  return (int)cudaGetLastError();
}

// The plane walk with RU units a thread: whole bricks when a plane fills
// at most the block's units, else Y bands of one brick.  ops.codes_route
// and ops.codes3d_route send stacks of few values, and Z rows of more
// than half the block's units, to the elementwise kernel instead
// (cudaErrorInvalidValue for such a row here).
template <int RU, bool kSkipZero>
int codes_walk(const float* x, long long* codes, long long n, int X, int Y,
               int Z, double two_eb, int blocks_per_sm, cudaStream_t stream) {
  if (n == 0 || (long long)X * Y * Z == 0) return 0;
  if (blocks_per_sm < 1) return (int)cudaErrorInvalidValue;
  const bool vec = Z % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)codes & 15) == 0;
  const long long cap = (long long)kCodesThreads * RU;
  const long long row = Z / (vec ? 4 : 1), per_plane = (long long)Y * row;
  if (row > cap / 2) return (int)cudaErrorInvalidValue;
  long long nb = 1;
  int py = Y;
  if (per_plane <= cap) {
    nb = cap / per_plane;
    if (nb > n) nb = n;
  } else {
    py = (int)(cap / row) - 1;  // with the halo row, <= cap units
  }
  return vec ? codes_bricks_launch<4, RU, kSkipZero>(
                   x, codes, n, X, Y, Z, (int)nb, py, two_eb, blocks_per_sm,
                   stream)
             : codes_bricks_launch<1, RU, kSkipZero>(
                   x, codes, n, X, Y, Z, (int)nb, py, two_eb, blocks_per_sm,
                   stream);
}

// K1's plane walk: one unit a thread, about 8 blocks per SM, no zero test.
int codes_bricks(const float* x, long long* codes, long long n, int X, int Y,
                 int Z, double two_eb, cudaStream_t stream) {
  return codes_walk<1, false>(x, codes, n, X, Y, Z, two_eb, 8, stream);
}

// K6's planes route: pass A (Y and Z scans) into `scratch`, then pass B
// (X scan + dequant) into `out`.  16-byte units when Z is even and the
// pointers allow; cudaErrorInvalidValue for a plane past 32-bit indices
// or a row whose band buffer exceeds shared memory (ops.recon3d_route
// sends those to the three-pass route).
int recon_planes(const long long* codes, long long* scratch, float* out,
                 int X, int Y, int Z, double two_eb, cudaStream_t stream) {
  if ((long long)X * Y * Z == 0) return 0;
  const long long yz = (long long)Y * Z;
  if (yz > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = Z % 2 == 0 && ((uintptr_t)codes & 15) == 0 &&
                   ((uintptr_t)scratch & 15) == 0 && ((uintptr_t)out & 7) == 0;
  long long rows = kBandBytes / (8LL * Z);
  if (rows < 1) rows = 1;
  if (rows > Y) rows = Y;
  const long long smem = (rows + 1) * Z * 8;
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  // few planes (blocks): 512 threads a block, else 256
  const bool wide = X < 2 * sm_count();
  auto pass_a = recon_yz_kernel<1, 256>;
  if (vec)
    pass_a = wide ? recon_yz_kernel<2, 512> : recon_yz_kernel<2, 256>;
  else if (wide)
    pass_a = recon_yz_kernel<1, 512>;
  int rc = allow_smem(pass_a, (int)smem);
  if (rc) return rc;
  pass_a<<<(unsigned)X, wide ? 512 : 256, (int)smem, stream>>>(
      codes, scratch, Y, Z, (int)rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int units = (int)(yz / (vec ? 2 : 1));
  const unsigned grid = blocks_for(units, kXThreads);
  if (vec)
    recon_x_kernel<2><<<grid, kXThreads, 0, stream>>>(scratch, out, X, units,
                                                      yz, two_eb);
  else
    recon_x_kernel<1><<<grid, kXThreads, 0, stream>>>(scratch, out, X, units,
                                                      yz, two_eb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lorenzo3d_codes_batched(const float* x, long long* codes,
                                       long long n, int X, int Y, int Z,
                                       double two_eb, cudaStream_t stream) {
  return codes_bricks(x, codes, n, X, Y, Z, two_eb, stream);
}

// K1 as one thread per element (the kernel 1 of earlier builds): the
// route of small stacks and long rows (ops.codes_route).
extern "C" int lorenzo3d_codes_batched_elementwise(
    const float* x, long long* codes, long long n, int X, int Y, int Z,
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

// K2 on shared memory: whole bricks, per_block of them (up to 4,096
// elements) a block, when one brick fits; else X planes in shared memory
// and an X scan through `scratch` (int64, the shape of `codes`), when one
// plane fits.  cudaErrorInvalidValue for larger planes (ops.recon_route
// sends those to the three-pass entry).
extern "C" int lorenzo3d_recon_bricks(const long long* codes,
                                      long long* scratch, float* out,
                                      long long n, int X, int Y, int Z,
                                      double two_eb, cudaStream_t stream) {
  const long long vol = (long long)X * Y * Z;
  if (n == 0 || vol == 0) return 0;
  const long long plane_smem = (long long)Y * (Z + 1) * 8;
  if (plane_smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  const bool vec = Z % 2 == 0 && ((uintptr_t)codes & 15) == 0;
  int rc;
  if (X * plane_smem <= kSmemBudget) {
    long long per_block = 4096 / vol;
    if (per_block < 1) per_block = 1;
    if (per_block > n) per_block = n;
    while (per_block > 1 && per_block * X * plane_smem > kSmemBudget)
      --per_block;
    const int smem = (int)(per_block * X * plane_smem);
    const unsigned grid = (unsigned)((n + per_block - 1) / per_block);
    rc = vec ? allow_smem(recon_bricks_kernel<true>, smem)
             : allow_smem(recon_bricks_kernel<false>, smem);
    if (rc) return rc;
    if (vec)
      recon_bricks_kernel<true><<<grid, kBrickThreads, smem, stream>>>(
          codes, out, n, X, Y, Z, (int)per_block, two_eb);
    else
      recon_bricks_kernel<false><<<grid, kBrickThreads, smem, stream>>>(
          codes, out, n, X, Y, Z, (int)per_block, two_eb);
    return (int)cudaGetLastError();
  }
  long long px = kPlaneTarget / plane_smem;
  if (px < 1) px = 1;
  const int groups = (int)((X + px - 1) / px);
  const int smem = (int)(px * plane_smem);
  rc = vec ? allow_smem(planes_yz_kernel<true>, smem)
           : allow_smem(planes_yz_kernel<false>, smem);
  if (rc) return rc;
  const unsigned grid = (unsigned)(n * groups);
  if (vec)
    planes_yz_kernel<true><<<grid, kBrickThreads, smem, stream>>>(
        codes, scratch, X, Y, Z, (int)px, groups);
  else
    planes_yz_kernel<false><<<grid, kBrickThreads, smem, stream>>>(
        codes, scratch, X, Y, Z, (int)px, groups);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long yz = (long long)Y * Z, lines = n * yz;
  scan_x_dequant_kernel<<<blocks_for(lines, 256), 256, 0, stream>>>(
      scratch, out, lines, X, yz, two_eb);
  return (int)cudaGetLastError();
}

// K5 for any tile: one thread per element (the elementwise design),
// ops.codes3d_route's "elementwise"; kernel 5 of earlier builds at
// tile = shape.
extern "C" int lorenzo3d_codes(const float* x, long long* codes, int X, int Y,
                               int Z, int tx, int ty, int tz, double two_eb,
                               cudaStream_t stream) {
  return codes_launch<true>(x, codes, 1, X, Y, Z, tx, ty, tz, two_eb, stream);
}

// K5 at tile = shape: the plane walk on a one-brick stack with `units`
// units a thread (1, 2 or 4), about `blocks_per_sm` blocks per SM, the
// zero test when skip_zero != 0 (ops.codes3d_route's "walk").
extern "C" int lorenzo3d_codes_walk(const float* x, long long* codes, int X,
                                    int Y, int Z, double two_eb, int units,
                                    int skip_zero, int blocks_per_sm,
                                    cudaStream_t stream) {
  // a misaligned input or Z % 4 != 0 loads one value a unit: such rows
  // of up to 512 values need 4 units a thread
  const bool vec = Z % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)codes & 15) == 0;
  if (2 * (vec ? Z / 4 : Z) > kCodesThreads * units) units = 4;
  const float* a = x;
  long long* c = codes;
  const int b = blocks_per_sm;
  switch (units * 2 + (skip_zero != 0)) {
    case 2: return codes_walk<1, false>(a, c, 1, X, Y, Z, two_eb, b, stream);
    case 3: return codes_walk<1, true>(a, c, 1, X, Y, Z, two_eb, b, stream);
    case 4: return codes_walk<2, false>(a, c, 1, X, Y, Z, two_eb, b, stream);
    case 5: return codes_walk<2, true>(a, c, 1, X, Y, Z, two_eb, b, stream);
    case 8: return codes_walk<4, false>(a, c, 1, X, Y, Z, two_eb, b, stream);
    case 9: return codes_walk<4, true>(a, c, 1, X, Y, Z, two_eb, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 for any tile: three scans through device memory (the three-pass
// route, ops.recon3d_route's "three_pass"); kernel 6 of earlier builds at
// tile = shape.
extern "C" int lorenzo3d_recon(const long long* codes, long long* scratch,
                               float* out, int X, int Y, int Z, int tx,
                               int ty, int tz, double two_eb,
                               cudaStream_t stream) {
  return recon_launch(codes, scratch, out, 1, X, Y, Z, tx, ty, tz, two_eb,
                      stream);
}

// K6 at tile = shape: planes of Y and Z scans, then the X scan fused with
// the dequant, through `scratch` (int64, the shape of `codes`)
// (ops.recon3d_route's "planes").
extern "C" int lorenzo3d_recon_planes(const long long* codes,
                                      long long* scratch, float* out, int X,
                                      int Y, int Z, double two_eb,
                                      cudaStream_t stream) {
  return recon_planes(codes, scratch, out, X, Y, Z, two_eb, stream);
}
