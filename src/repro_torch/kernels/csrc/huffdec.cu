// Batched canonical-Huffman decode of many payloads under one codebook,
// read straight from one buffer of packed bytes.
//
// Replaces the TPU kernel huffdec_windows and its device walk decode_walk
// (src/repro/kernels/huffdec.py).  The TPU formulation first materializes
// an (A, max_nbits) window matrix that pads every payload to the longest;
// here each payload is walked in place, so the work and the memory are
// the payloads' own bits and symbols.
//
// One thread per payload runs the serial oracle's canonical walk
// (repro's entropy.decode_stream): one bit at a time, code = code << 1 |
// bit, accepting a length-l codeword when first_code[l] <= code <
// first_code[l] + count[l].  The checks run in the oracle's order, so the
// error kinds are the oracle's by construction: 1 = truncated (the payload
// ends mid-codeword), 2 = corrupt (maxlen bits match nothing), 3 = empty
// codebook with symbols to decode.  The per-length tables live in shared
// memory; bits come from a one-byte register refilled from global memory.
//
// Bound: bytes (packed bits in, 8 B per decoded symbol out), but with one
// thread per payload the longest payload sets the time: a level holds
// only ~10^3-10^4 payloads, too few threads to fill the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 57;

__global__ void huffdec_kernel(
    const uint8_t* __restrict__ data, const long long* __restrict__ byte_off,
    const long long* __restrict__ nbits, const long long* __restrict__ n_decode,
    const long long* __restrict__ out_off, int n_payloads,
    const long long* __restrict__ symbols, long long n_symbols,
    const long long* __restrict__ first_code,
    const long long* __restrict__ first_index,
    const long long* __restrict__ count, int maxlen,
    long long* __restrict__ out, int* __restrict__ err) {
  __shared__ long long s_fc[kMaxLen + 1];
  __shared__ long long s_fi[kMaxLen + 1];
  __shared__ long long s_cnt[kMaxLen + 1];
  for (int l = threadIdx.x; l <= maxlen; l += blockDim.x) {
    s_fc[l] = first_code[l];
    s_fi[l] = first_index[l];
    s_cnt[l] = count[l];
  }
  __syncthreads();
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= n_payloads) return;
  const long long nd = n_decode[a];
  int kind = 0;
  if (nd > 0) {
    const long long nb = nbits[a];
    long long* o = out + out_off[a];
    if (n_symbols == 0) {
      kind = 3;
    } else if (n_symbols == 1) {
      // single-symbol alphabet: 1 bit per symbol on the wire
      if (nb < nd) {
        kind = 1;
      } else {
        const long long s0 = symbols[0];
        for (long long k = 0; k < nd; ++k) o[k] = s0;
      }
    } else {
      const uint8_t* p = data + byte_off[a];
      long long pos = 0;
      unsigned int byte = 0;
      int avail = 0;
      for (long long k = 0; k < nd && kind == 0; ++k) {
        long long code = 0;
        for (int l = 1;; ++l) {
          if (pos >= nb) { kind = 1; break; }
          if (avail == 0) { byte = p[pos >> 3]; avail = 8; }
          --avail;
          code = (code << 1) | ((byte >> avail) & 1u);
          ++pos;
          if (l > maxlen) { kind = 2; break; }
          const long long c0 = s_fc[l], cnt = s_cnt[l];
          if (cnt && code - c0 < cnt && code >= c0) {
            o[k] = symbols[s_fi[l] + (code - c0)];
            break;
          }
        }
      }
    }
  }
  err[a] = kind;
}

}  // namespace

// Tables hold at least maxlen + 1 entries; maxlen <= 57.  `nbits` is the
// effective bit count, min(nbits, 8 * payload bytes).
extern "C" int huffdec_payloads(
    const uint8_t* data, const long long* byte_off, const long long* nbits,
    const long long* n_decode, const long long* out_off, int n_payloads,
    const long long* symbols, long long n_symbols,
    const long long* first_code, const long long* first_index,
    const long long* count, int maxlen, long long* out, int* err,
    cudaStream_t stream) {
  if (n_payloads == 0) return 0;
  if (maxlen < 0 || maxlen > kMaxLen) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned grid = (unsigned)((n_payloads + threads - 1) / threads);
  huffdec_kernel<<<grid, threads, 0, stream>>>(
      data, byte_off, nbits, n_decode, out_off, n_payloads, symbols,
      n_symbols, first_code, first_index, count, maxlen, out, err);
  return (int)cudaGetLastError();
}
