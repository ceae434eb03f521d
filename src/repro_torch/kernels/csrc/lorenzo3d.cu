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
// 8 B and writes 4 B per element.
//
// Codes of a brick stack (K1, lorenzo3d_codes_batched): a block walks
// the X planes of its bricks (or of one X slab of a brick), prequantizing
// each element once into int64 plane buffers in shared memory; see
// codes_bricks_kernel.  Codes of one array at any tile (K5), and K1's
// small stacks and long rows: one thread per element, 64-bit indices (a
// 512^3 grid has 1.3e8 elements), the 8-corner stencil evaluated from
// the float input, each corner prequantized again (the neighbours sit in
// L1/L2); the kernel 1 of earlier builds.
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
// The three-pass route (recon_launch; also K6, whole-array tiles): three
// sequential scans through device memory, one thread per line, restarting
// at tile edges, the last (Z, fused with the dequant) walking contiguous
// lines one per thread, uncoalesced: about 44 B per element.
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

// K1 on a brick stack (codes_bricks_kernel).  A block takes nb whole
// bricks (as many as fill its 256 threads: 4 of 16^3, 16 of 8^3), or one
// Y band of one brick's planes (as many rows as fill the threads, plus
// the row above as a halo), over the X planes [x0, x1) of one slab:
// stacks of few bricks are cut along X into slabs so that the card holds
// about 8 blocks per SM, each slab prequantizing one halo plane more.
// The block walks its planes in order.  Each thread owns one unit of VEC
// contiguous Z values (a 16-byte load when Z % 4 == 0), the same on
// every plane, and
//   - prequantizes its unit of plane p once (one float64 division and
//     rint per element) into one of two int64 plane buffers in shared
//     memory, then issues the load of plane p + 2 (two planes are in
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
// is 32-bit inside a brick, 64-bit only for a unit's base offset.  No
// zero test: every one tried cost K1 10 % (kSkipZero above).
constexpr int kCodesThreads = 256;

template <int VEC>
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
  // this thread's unit: element e of the block's plane buffer, (j, k) in
  // its brick, and the unit's offset in the stack at plane 0
  const bool live = (int)threadIdx.x < nbh * band_el / VEC;
  const int e = threadIdx.x * VEC;
  const int bb = e / band_el, jr = (e - bb * band_el) / Z;
  const int j = y0h + jr, k = e - bb * band_el - jr * Z;
  const long long off = (b0 + bb) * X * (long long)yz + (long long)j * Z + k;
  auto load = [&](int p, float (&v)[VEC]) {
    if (!live || p >= x1) return;
    const float* src = x + off + (long long)p * yz;
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
  long long prev[VEC];
#pragma unroll
  for (int m = 0; m < VEC; ++m) prev[m] = 0;
  // plane p: prequantize from v, refill v with plane p + 2, then codes
  auto step = [&](int p, float (&v)[VEC]) {
    long long* buf = s_q + ((p - p0) & 1) * set;
    long long q[VEC];
    if (live) {
#pragma unroll
      for (int m = 0; m < VEC; ++m)
        q[m] = (long long)rint((double)v[m] / two_eb);
      if (VEC == 4) {
        longlong2* b2 = reinterpret_cast<longlong2*>(buf + e);
        b2[0] = make_longlong2(q[0], q[VEC > 1 ? 1 : 0]);
        b2[1] = make_longlong2(q[VEC > 2 ? 2 : 0], q[VEC > 3 ? 3 : 0]);
      } else {
        buf[e] = q[0];
      }
    }
    load(p + 2, v);
    __syncthreads();
    if (!live || j < y0) return;  // idle, or the halo row
    const long long* at = buf + e;
    long long up[VEC];
    if (VEC == 4 && j > 0) {
      const longlong2* u2 = reinterpret_cast<const longlong2*>(at - Z);
      const longlong2 a = u2[0], b = u2[1];
      up[0] = a.x;
      up[VEC > 1 ? 1 : 0] = a.y;
      up[VEC > 2 ? 2 : 0] = b.x;
      up[VEC > 3 ? 3 : 0] = b.y;
    } else {
#pragma unroll
      for (int m = 0; m < VEC; ++m) up[m] = j > 0 ? at[m - Z] : 0;
    }
    long long left = k > 0 ? at[-1] : 0;
    long long up_left = j > 0 && k > 0 ? at[-Z - 1] : 0;
    long long c[VEC];
#pragma unroll
    for (int m = 0; m < VEC; ++m) {
      const long long d2 = q[m] - left - up[m] + up_left;
      c[m] = d2 - prev[m];
      prev[m] = d2;
      left = q[m];
      up_left = up[m];
    }
    if (p < x0) return;  // the slab's halo plane
    long long* dst = codes + off + (long long)p * yz;
    if (VEC == 4) {
      longlong2* d2p = reinterpret_cast<longlong2*>(dst);
      d2p[0] = make_longlong2(c[0], c[VEC > 1 ? 1 : 0]);
      d2p[1] = make_longlong2(c[VEC > 2 ? 2 : 0], c[VEC > 3 ? 3 : 0]);
    } else {
      dst[0] = c[0];
    }
  };
  float va[VEC], vb[VEC];
  load(p0, va);
  load(p0 + 1, vb);
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

template <int VEC>
int codes_bricks_launch(const float* x, long long* codes, long long n, int X,
                        int Y, int Z, int nb, int py, double two_eb,
                        cudaStream_t stream) {
  const long long groups = (n + nb - 1) / nb;
  const int bands = (Y + py - 1) / py;
  // about 8 blocks per SM: cut a stack of few bricks along X, keeping at
  // least two planes a slab
  const long long target = 8LL * sm_count(), base = groups * bands;
  long long slabs = base >= target ? 1 : (target + base - 1) / base;
  if (slabs > X / 2) slabs = X / 2;
  if (slabs < 1) slabs = 1;
  const int px = (int)((X + slabs - 1) / slabs);
  slabs = (X + px - 1) / px;
  if (base * slabs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int rows = bands > 1 ? py + 1 : Y;
  const int smem = 2 * nb * rows * Z * (int)sizeof(long long);
  int rc = allow_smem(codes_bricks_kernel<VEC>, smem);
  if (rc) return rc;
  codes_bricks_kernel<VEC>
      <<<(unsigned)(base * slabs), kCodesThreads, smem, stream>>>(
          x, codes, n, X, Y, Z, nb, (int)slabs, px, bands, py, two_eb);
  return (int)cudaGetLastError();
}

// K1's plane walk: whole bricks when a plane fills at most a block's
// threads, else Y bands of one brick.  ops.codes_route sends stacks of
// few values, and Z rows of more than 128 loads, to the elementwise
// kernel instead (cudaErrorInvalidValue for such a row here).
int codes_bricks(const float* x, long long* codes, long long n, int X, int Y,
                 int Z, double two_eb, cudaStream_t stream) {
  if (n == 0 || (long long)X * Y * Z == 0) return 0;
  const bool vec = Z % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)codes & 15) == 0;
  const long long row = Z / (vec ? 4 : 1), per_plane = (long long)Y * row;
  if (row > kCodesThreads / 2) return (int)cudaErrorInvalidValue;
  long long nb = 1;
  int py = Y;
  if (per_plane <= kCodesThreads) {
    nb = kCodesThreads / per_plane;
    if (nb > n) nb = n;
  } else {
    py = (int)(kCodesThreads / row) - 1;  // with the halo row, <= 256 units
  }
  return vec ? codes_bricks_launch<4>(x, codes, n, X, Y, Z, (int)nb, py,
                                      two_eb, stream)
             : codes_bricks_launch<1>(x, codes, n, X, Y, Z, (int)nb, py,
                                      two_eb, stream);
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
