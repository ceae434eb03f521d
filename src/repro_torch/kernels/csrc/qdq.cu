// Per-group symmetric int8 quantization (kernel 7) and its inverse
// (kernel 8), on (n, d) row-major arrays with groups of `group` values
// along d.  For each group:
//   scale = max|x| > 0 ? max|x| / 127 : 1
//   q     = clamp(rint(x / scale), -127, 127)      (int8)
//   x'    = float(q) * scale                        (dequant, float32)
//
// Replaces the TPU kernels `group_quant` and `group_dequant`
// (src/repro/kernels/qdq.py), which quantize a (row_tile, d) block per
// grid step.  Their users are the int8 KV cache (one group = one
// (token, head) vector, group = head_dim) and the pod-axis gradient
// compression (group 256).
//
// Bound: bytes.  Quantizing reads 2 or 4 B and writes 1 B per value plus
// 4 B per group; dequantizing reads 1 B and writes 4 B per value.  The
// arithmetic is a few operations per value.
//
// Quant design (tile route).  A group takes L = group / R lanes, each
// holding R contiguous values in registers (R·sizeof(T) / 16 loads of
// 16 bytes, all issued before the reduction), so a warp holds the 32 / L
// consecutive groups of its tile.  The group's max is a shuffle
// reduction over its L lanes only; each lane stores its codes as one 8-
// or 16-byte pack, and the tile's scales leave in one coalesced store;
// there is no second read of the group.  Large launches (the prefill
// stacks) take R = 16: 32 B (bf16) or 64 B (float32) a lane in flight,
// 16-byte code stores, 4 groups of 128 bf16 a warp.  Small ones (a
// decode step, a few hundred groups) take R = 8: their time is each
// thread's own chain of loads, divisions and shuffles, so the work is
// spread over as many lanes as the group allows.  One warp per tile and
// no grid-stride loop: on the card, a grid-stride loop over a few blocks
// an SM lost on the prefill stack, and several tiles a warp before the
// reductions gained nothing there and cost a decode-step launch time.
// Groups of other sizes, and pointers off the packs' alignment, take the
// warp route: one warp per group, packs as wide as the group and the
// alignment allow, and a second read of the group from L1 (the design of
// the earlier build, kept reachable as group_quant_warp_* for a
// same-call comparison).
//
// The fused decode-step write (quantize_kv_*): one launch quantizes a
// step's K and V, (B, Sq, H, hd) each, and writes codes and scales into
// one layer's cache at positions start..start+Sq-1, in place: the tile
// route with each group index mapped to its source vector and its cache
// row (KvMap, which takes the cache's batch strides).
//
// Numerics follow the reference exactly: x / scale is a true IEEE
// division (not a product with the reciprocal: the two differ at ties),
// rintf rounds halves to even, and the build has no --use_fast_math.
// Held this way the codes and scales equal the plain version bit for
// bit.  Inputs are finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VEC>
struct __align__(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Value k of a little-endian 32-bit word of float32 or bf16 values.
template <typename T>
__device__ __forceinline__ float word_value(unsigned w, int k);
template <>
__device__ __forceinline__ float word_value<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_value<__nv_bfloat16>(unsigned w,
                                                           int k) {
  return __uint_as_float(k ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ unsigned word_of(const uint4& a, int w) {
  return w == 0 ? a.x : w == 1 ? a.y : w == 2 ? a.z : a.w;
}

__device__ __forceinline__ float group_scale(float amax) {
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

__device__ __forceinline__ int quant_code(float v, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}

// Group g of an (n_groups, group) array.
template <typename T>
struct DenseMap {
  const T* x;
  int8_t* q;
  float* scale;
  int group;
  __device__ const T* src(long long g) const { return x + g * group; }
  __device__ int8_t* codes(long long g) const { return q + g * group; }
  __device__ float* scale_at(long long g) const { return scale + g; }
};

// A decode step's K then V, (B, Sq, H, hd) each, as 2·half groups.  Group
// g < half is K's vector r = g − b·sq_h = s·H + h of batch b = g / sq_h;
// its codes go to cache element b·cb + (lead + r)·group and its scale to
// b·sb + lead + r, with lead = start·H and cb, sb the cache's batch
// strides (in codes and in scales).  half < 2^31 (checked by the
// launcher), so the division is 32-bit.
template <typename T>
struct KvMap {
  const T* k;
  const T* v;
  int8_t* ck;
  int8_t* cv;
  float* sk;
  float* sv;
  long long half, cb, sb, lead;
  unsigned sq_h;
  int group;
  __device__ const T* src(long long g) const {
    return g < half ? k + g * group : v + (g - half) * group;
  }
  __device__ int8_t* codes(long long g) const {
    const bool is_k = g < half;
    if (!is_k) g -= half;
    const unsigned b = (unsigned)g / sq_h;
    return (is_k ? ck : cv) + b * cb +
           (lead + g - (long long)b * sq_h) * group;
  }
  __device__ float* scale_at(long long g) const {
    const bool is_k = g < half;
    if (!is_k) g -= half;
    const unsigned b = (unsigned)g / sq_h;
    return (is_k ? sk : sv) + b * sb + lead + g - (long long)b * sq_h;
  }
};

// Tile route: L lanes a group, R contiguous values a lane; a warp takes
// the 32 / L consecutive groups of one tile.
template <typename T, int L, int R, class Map>
__global__ void __launch_bounds__(kThreads)
quant_tiles_kernel(Map m, long long n_groups) {
  constexpr int TILE = 32 / L;
  constexpr int NP = R * (int)sizeof(T) / 16;  // 16-byte loads a lane
  constexpr int VPW = 4 / (int)sizeof(T);      // values a 32-bit word
  const int lane = threadIdx.x & 31;
  const long long g0 =
      (((long long)blockIdx.x * kThreads + threadIdx.x) >> 5) * TILE;
  if (g0 >= n_groups) return;  // g0 is uniform across the warp
  const long long g = g0 + lane / L;
  const bool live = g < n_groups;
  uint4 raw[NP];
  if (live) {
    const uint4* p =
        reinterpret_cast<const uint4*>(m.src(g)) + (lane % L) * NP;
#pragma unroll
    for (int j = 0; j < NP; ++j) raw[j] = __ldg(p + j);
  } else {
#pragma unroll
    for (int j = 0; j < NP; ++j) raw[j] = make_uint4(0, 0, 0, 0);
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int k = 0; k < VPW; ++k)
        amax = fmaxf(amax, fabsf(word_value<T>(word_of(raw[j], w), k)));
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  const float s = group_scale(amax);
  if (live) {
    unsigned out[R / 4];
#pragma unroll
    for (int e = 0; e < R / 4; ++e) out[e] = 0;
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int k = 0; k < VPW; ++k) {
          const int e = (j * 4 + w) * VPW + k;
          const int c = quant_code(word_value<T>(word_of(raw[j], w), k), s);
          out[e >> 2] |= (unsigned)(c & 0xff) << (8 * (e & 3));
        }
    int8_t* dst = m.codes(g) + (lane % L) * R;
    if (R == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
    } else {
#pragma unroll
      for (int e = 0; e < R / 16; ++e)
        reinterpret_cast<uint4*>(dst)[e] = make_uint4(
            out[4 * e], out[4 * e + 1], out[4 * e + 2], out[4 * e + 3]);
    }
  }
  // lane i < TILE stores the scale of group g0 + i, held by lane i·L
  const float mine = __shfl_sync(kFull, s, (lane % TILE) * L);
  if (lane < TILE && g0 + lane < n_groups) *m.scale_at(g0 + lane) = mine;
}

// Warp route: one warp per group, VEC values a load.
template <typename T, int VEC, class Map>
__global__ void quant_warp_kernel(Map m, long long n_groups, int group) {
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= n_groups) return;  // g is uniform across the warp
  const Pack<T, VEC>* src = reinterpret_cast<const Pack<T, VEC>*>(m.src(g));
  const int n_packs = group / VEC;

  float amax = 0.0f;
  for (int p = lane; p < n_packs; p += 32) {
    const Pack<T, VEC> w = src[p];
#pragma unroll
    for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(to_float(w.v[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  const float s = group_scale(amax);

  Pack<int8_t, VEC>* dst = reinterpret_cast<Pack<int8_t, VEC>*>(m.codes(g));
  for (int p = lane; p < n_packs; p += 32) {
    const Pack<T, VEC> w = src[p];
    Pack<int8_t, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = (int8_t)quant_code(to_float(w.v[j]), s);
    dst[p] = o;
  }
  if (lane == 0) *m.scale_at(g) = s;
}

template <int VEC>
__global__ void group_dequant_kernel(const int8_t* __restrict__ q,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out,
                                     long long n_packs, int group) {
  const Pack<int8_t, VEC>* src = reinterpret_cast<const Pack<int8_t, VEC>*>(q);
  Pack<float, VEC>* dst = reinterpret_cast<Pack<float, VEC>*>(out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_packs; p += stride) {
    // VEC divides the group, so a pack never straddles two groups
    const float s = scale[p * VEC / group];
    const Pack<int8_t, VEC> w = src[p];
    Pack<float, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = __fmul_rn((float)w.v[j], s);
    dst[p] = o;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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

template <typename T, int L, int R, class Map>
int launch_tiles(const Map& m, long long n_groups, cudaStream_t stream) {
  constexpr int TILE = 32 / L;
  const long long n_tiles = (n_groups + TILE - 1) / TILE;
  const long long blocks = (n_tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quant_tiles_kernel<T, L, R, Map>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(m, n_groups);
  return (int)cudaGetLastError();
}

// The tile route for `group` values of T at these pointers, if it takes
// them: launches and sets *rc; false for the warp route.  16 values a
// lane for groups of 128 and up in launches of more groups than the
// card's warps hold at once in the narrow shape (64 an SM), and for
// groups of 512; else 8.
template <typename T, class Map>
bool try_tiles(const Map& m, long long n_groups, int group,
               const void* const* srcs, int n_src, void* const* dsts,
               int n_dst, cudaStream_t stream, int* rc) {
  const int narrow = group / 8 < 32 ? group / 8 : 32;
  const bool large =
      n_groups >= 64LL * sm_count() * (32 / (narrow > 0 ? narrow : 1));
  const int r = group == 512 || (group >= 128 && large) ? 16 : 8;
  const int lanes = group / r;
  if (group % r || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
    return false;
  for (int i = 0; i < n_src; ++i)
    if (!aligned(srcs[i], 16)) return false;
  for (int i = 0; i < n_dst; ++i)
    if (!aligned(dsts[i], r)) return false;
  if (r == 16) {
    switch (lanes) {
      case 32: *rc = launch_tiles<T, 32, 16>(m, n_groups, stream); break;
      case 16: *rc = launch_tiles<T, 16, 16>(m, n_groups, stream); break;
      default: *rc = launch_tiles<T, 8, 16>(m, n_groups, stream);
    }
    return true;
  }
  switch (lanes) {
    case 32: *rc = launch_tiles<T, 32, 8>(m, n_groups, stream); break;
    case 16: *rc = launch_tiles<T, 16, 8>(m, n_groups, stream); break;
    case 8: *rc = launch_tiles<T, 8, 8>(m, n_groups, stream); break;
    case 4: *rc = launch_tiles<T, 4, 8>(m, n_groups, stream); break;
    case 2: *rc = launch_tiles<T, 2, 8>(m, n_groups, stream); break;
    default: *rc = launch_tiles<T, 1, 8>(m, n_groups, stream);
  }
  return true;
}

// The warp route: the widest pack of at most 16 B that divides the
// group's warp stride and every pointer's alignment.
template <typename T, class Map>
int launch_warp(const Map& m, long long n_groups, int group,
                const void* const* srcs, int n_src, void* const* dsts,
                int n_dst, cudaStream_t stream) {
  const long long blocks = (n_groups * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int vec = 16 / (int)sizeof(T);
  for (; vec > 1; vec >>= 1) {
    bool ok = group % (32 * vec) == 0;
    for (int i = 0; i < n_src; ++i)
      ok = ok && aligned(srcs[i], (int)sizeof(T) * vec);
    for (int i = 0; i < n_dst; ++i) ok = ok && aligned(dsts[i], vec);
    if (ok) break;
  }
  const unsigned grid = (unsigned)blocks;
  switch (vec) {
    case 8:
      quant_warp_kernel<T, 8, Map>
          <<<grid, kThreads, 0, stream>>>(m, n_groups, group);
      break;
    case 4:
      quant_warp_kernel<T, 4, Map>
          <<<grid, kThreads, 0, stream>>>(m, n_groups, group);
      break;
    case 2:
      quant_warp_kernel<T, 2, Map>
          <<<grid, kThreads, 0, stream>>>(m, n_groups, group);
      break;
    default:
      quant_warp_kernel<T, 1, Map>
          <<<grid, kThreads, 0, stream>>>(m, n_groups, group);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int quant_dense(const T* x, int8_t* q, float* scale, long long n_groups,
                int group, bool warp_only, cudaStream_t stream) {
  if (n_groups == 0) return 0;
  if (group < 1) return (int)cudaErrorInvalidValue;
  const DenseMap<T> m{x, q, scale, group};
  const void* srcs[] = {x};
  void* dsts[] = {q};
  int rc = 0;
  if (!warp_only &&
      try_tiles<T>(m, n_groups, group, srcs, 1, dsts, 1, stream, &rc))
    return rc;
  return launch_warp<T>(m, n_groups, group, srcs, 1, dsts, 1, stream);
}

template <typename T>
int quant_kv(const T* k, const T* v, int8_t* ck, int8_t* cv, float* sk,
             float* sv, int B, int Sq, int H, int hd, int S, int start,
             long long cb, long long sb, cudaStream_t stream) {
  if (B < 0 || Sq < 0 || H < 0 || hd < 1 || start < 0 || start + Sq > S)
    return (int)cudaErrorInvalidValue;
  const long long half = (long long)B * Sq * H;
  if (half == 0) return 0;
  if (half >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const KvMap<T> m{k, v, ck, cv, sk, sv, half, cb, sb, (long long)start * H,
                   (unsigned)(Sq * H), hd};
  const void* srcs[] = {k, v};
  // the batch stride, as an address, must keep the packs' alignment too
  void* dsts[] = {ck, cv, reinterpret_cast<void*>(cb)};
  int rc = 0;
  if (try_tiles<T>(m, 2 * half, hd, srcs, 2, dsts, 3, stream, &rc)) return rc;
  return launch_warp<T>(m, 2 * half, hd, srcs, 2, dsts, 3, stream);
}

}  // namespace

// x: n_groups * group contiguous values (float32 or bfloat16); writes
// n_groups * group int8 codes to q and n_groups float32 scales.
extern "C" int group_quant_f32(const float* x, int8_t* q, float* scale,
                               long long n_groups, int group,
                               cudaStream_t stream) {
  return quant_dense<float>(x, q, scale, n_groups, group, false, stream);
}

extern "C" int group_quant_bf16(const __nv_bfloat16* x, int8_t* q,
                                float* scale, long long n_groups, int group,
                                cudaStream_t stream) {
  return quant_dense<__nv_bfloat16>(x, q, scale, n_groups, group, false,
                                    stream);
}

// The same on the warp route only (one warp per group): the kernel 7 of
// earlier builds, for a same-call comparison.
extern "C" int group_quant_warp_f32(const float* x, int8_t* q, float* scale,
                                    long long n_groups, int group,
                                    cudaStream_t stream) {
  return quant_dense<float>(x, q, scale, n_groups, group, true, stream);
}

extern "C" int group_quant_warp_bf16(const __nv_bfloat16* x, int8_t* q,
                                     float* scale, long long n_groups,
                                     int group, cudaStream_t stream) {
  return quant_dense<__nv_bfloat16>(x, q, scale, n_groups, group, true,
                                    stream);
}

// A decode step's write into an int8 KV cache: k, v (B, Sq, H, hd)
// contiguous; ck, cv (B, S, H, hd) int8 and sk, sv (B, S, H) float32, one
// layer's cache (each contiguous past its batch axis, whose strides are
// cb for the codes and sb for the scales), written at positions
// start..start+Sq-1 in place.
extern "C" int quantize_kv_f32(const float* k, const float* v, int8_t* ck,
                               int8_t* cv, float* sk, float* sv, int B,
                               int Sq, int H, int hd, int S, int start,
                               long long cb, long long sb,
                               cudaStream_t stream) {
  return quant_kv<float>(k, v, ck, cv, sk, sv, B, Sq, H, hd, S, start, cb,
                         sb, stream);
}

extern "C" int quantize_kv_bf16(const __nv_bfloat16* k,
                                const __nv_bfloat16* v, int8_t* ck,
                                int8_t* cv, float* sk, float* sv, int B,
                                int Sq, int H, int hd, int S, int start,
                                long long cb, long long sb,
                                cudaStream_t stream) {
  return quant_kv<__nv_bfloat16>(k, v, ck, cv, sk, sv, B, Sq, H, hd, S,
                                 start, cb, sb, stream);
}

// q: n_groups * group int8 codes, scale: n_groups float32; writes
// n_groups * group float32 values to out.
extern "C" int group_dequant_f32(const int8_t* q, const float* scale,
                                 float* out, long long n_groups, int group,
                                 int n_sms, cudaStream_t stream) {
  const long long n = n_groups * group;
  if (n == 0) return 0;
  int vec = 4;
  if (group % 4 || reinterpret_cast<uintptr_t>(q) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    vec = 1;
  const long long n_packs = n / vec;
  const int threads = 256;
  long long want = (n_packs + threads - 1) / threads;
  const long long cap = 32LL * n_sms;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  if (vec == 4)
    group_dequant_kernel<4><<<blocks, threads, 0, stream>>>(q, scale, out,
                                                            n_packs, group);
  else
    group_dequant_kernel<1><<<blocks, threads, 0, stream>>>(q, scale, out,
                                                            n_packs, group);
  return (int)cudaGetLastError();
}
