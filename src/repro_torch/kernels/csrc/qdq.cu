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
// Design.  Quant: one warp per group, so the group's max is a
// warp-shuffle reduction with no shared memory and no second pass over
// device memory.  Each lane loads VEC contiguous values (8 or 16 B) where
// the group size and the pointer's alignment allow, so a warp reads
// whole 128 B lines; the quantize pass reads the group again, from L1.
// Rows may be any number (the TPU kernel's n % row_tile rule came from
// its blocking).  Dequant: one thread per VEC values, grid-strided.
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

template <typename T, int VEC>
struct __align__(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int VEC>
__global__ void group_quant_kernel(const T* __restrict__ x,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ scale,
                                   long long n_groups, int group) {
  const long long g =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= n_groups) return;  // g is uniform across the warp
  const long long base = g * group;
  const Pack<T, VEC>* src = reinterpret_cast<const Pack<T, VEC>*>(x + base);
  const int n_packs = group / VEC;

  float amax = 0.0f;
  for (int p = lane; p < n_packs; p += 32) {
    const Pack<T, VEC> w = src[p];
#pragma unroll
    for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(to_float(w.v[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;

  Pack<int8_t, VEC>* dst = reinterpret_cast<Pack<int8_t, VEC>*>(q + base);
  for (int p = lane; p < n_packs; p += 32) {
    const Pack<T, VEC> w = src[p];
    Pack<int8_t, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float r = rintf(__fdiv_rn(to_float(w.v[j]), s));
      o.v[j] = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
    }
    dst[p] = o;
  }
  if (lane == 0) scale[g] = s;
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

// The widest pack of at most 16 B that divides the group's warp stride
// and the pointer's alignment.
template <typename T>
int pick_vec(const void* p, int group, int max_vec) {
  for (int v = max_vec; v > 1; v >>= 1)
    if (group % (32 * v) == 0 &&
        reinterpret_cast<uintptr_t>(p) % (sizeof(T) * v) == 0)
      return v;
  return 1;
}

template <typename T>
int launch_quant(const T* x, int8_t* q, float* scale, long long n_groups,
                 int group, cudaStream_t stream) {
  if (n_groups == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_groups * 32 + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = pick_vec<T>(x, group, 16 / (int)sizeof(T));
  switch (vec) {
    case 8:
      group_quant_kernel<T, 8><<<(unsigned)blocks, threads, 0, stream>>>(
          x, q, scale, n_groups, group);
      break;
    case 4:
      group_quant_kernel<T, 4><<<(unsigned)blocks, threads, 0, stream>>>(
          x, q, scale, n_groups, group);
      break;
    case 2:
      group_quant_kernel<T, 2><<<(unsigned)blocks, threads, 0, stream>>>(
          x, q, scale, n_groups, group);
      break;
    default:
      group_quant_kernel<T, 1><<<(unsigned)blocks, threads, 0, stream>>>(
          x, q, scale, n_groups, group);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: n_groups * group contiguous values (float32 or bfloat16); writes
// n_groups * group int8 codes to q and n_groups float32 scales.
extern "C" int group_quant_f32(const float* x, int8_t* q, float* scale,
                               long long n_groups, int group,
                               cudaStream_t stream) {
  return launch_quant<float>(x, q, scale, n_groups, group, stream);
}

extern "C" int group_quant_bf16(const __nv_bfloat16* x, int8_t* q,
                                float* scale, long long n_groups, int group,
                                cudaStream_t stream) {
  return launch_quant<__nv_bfloat16>(x, q, scale, n_groups, group, stream);
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
