// Batched canonical-Huffman decode of many payloads under one codebook,
// read straight from one buffer of packed bytes.
//
// Replaces the TPU kernel huffdec_windows and its device walk decode_walk
// (src/repro/kernels/huffdec.py:48, :73).  The TPU formulation first
// materializes an (A, max_nbits) window matrix that pads every payload to
// the longest; here the payloads are read in place.
//
// Bound: bytes, the packed bits in and 8 B per decoded symbol out.  A
// serial walk cannot reach it: a level holds only ~10^3-10^4 payloads and
// a GSP or global level is one payload of the whole grid, so one thread
// per payload leaves the card idle behind the longest payload.  The
// decode is instead cut into chunks of `chunk_bits` bits and resolved by
// self-synchronisation (Klein & Wiseman 2003; Weissenberger & Schmidt,
// ICPP 2018), which needs no index in the stream, so the container's
// bytes stay the reference's:
//
//   sync_first   one thread per chunk decodes from the chunk's first bit
//                (exact for a payload's first chunk, a guess elsewhere) to
//                the first codeword boundary at or past the chunk's end,
//                and records that exit bit and its codeword count.
//   sync_pass    (up to kSyncPasses launches) a chunk whose entry differs
//                from its predecessor's exit decodes again from that exit.
//                A canonical code falls back onto the true codeword
//                boundaries within a few codewords, so one pass settles
//                Huffman data; a launch whose predecessor changed nothing
//                exits at once.  No host synchronisation.
//   (glue)       an exclusive scan of the counts gives each chunk's first
//                symbol (torch.cumsum in the wrapper).
//   flag         a payload is left to the serial walk if a chunk that may
//                hold one of its n_decode symbols is unsynced, meets a gap
//                or the payload's end mid-codeword, or if the synced chunks
//                hold fewer than n_decode symbols.
//   write        each synced chunk decodes again and writes its symbols,
//                staged in shared memory so that each warp's stores are
//                coalesced (a thread's own run of 8-byte symbols would
//                touch one line per lane and store).
//   serial       the oracle's bit-at-a-time walk (repro's
//                entropy.decode_stream), one thread per payload, for the
//                flagged payloads, the 0- and 1-symbol codebooks, payloads
//                without chunks and, on request, every payload.  Its out
//                and err are the oracle's by construction: 1 = truncated
//                (the payload ends mid-codeword), 2 = corrupt (maxlen bits
//                match nothing), 3 = empty codebook with symbols to decode.
//
// Measured on an H100 (chip_smoke.py; PERF.md): on a level of 4,882
// payloads and 30.9 M symbols the write takes about 60 % of the kernels'
// time and the two sync launches most of the rest; 64-bit chunks were the
// fastest of 64-1,024 there and on a one-payload 128^3 GSP level.
//
// Codewords of at most kLutBits bits are read with one lookup in a table
// of 2^kLutBits (row << 6 | length) entries in shared memory; longer ones
// take the canonical compare over a 64-bit window (maxlen <= 57).  Bits are
// read as big-endian 32-bit words into a 64-bit register.  Bits past a
// payload's end may enter a lookup; a codeword is accepted only if its
// length fits in the bits left, so they decide nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 57;
constexpr int kLutBits = 11;
constexpr int kLutSize = 1 << kLutBits;
constexpr int kThreads = 256;
constexpr int kSyncPasses = 4;
constexpr int kStage = 16;  // symbols a thread stages per write round
// stats (int32): [0] chunks, [1] sync passes run,
// [2] payloads walked serially, [3 + p] chunks decoded from a guessed
// (p = 0) or corrected (p >= 1) entry in pass p
constexpr int kStatPasses = 1, kStatSerial = 2, kStatChanged = 3;

struct Bits {
  const uint32_t* w;  // 4-byte aligned words covering the data
  long long n;        // words
  long long lead;     // bits in w[0] before data[0]

  __device__ __forceinline__ uint32_t word(long long i) const {
    if (i >= n) return 0u;
    return __byte_perm(__ldg(w + i), 0u, 0x0123);  // big-endian bit order
  }
  // the 64 bits from bit g of the data on, first bit highest
  __device__ unsigned long long peek64(long long g) const {
    g += lead;
    const long long i = g >> 5;
    const int s = (int)(g & 31);
    unsigned long long x = ((unsigned long long)word(i) << 32) | word(i + 1);
    if (s) x = (x << s) | (word(i + 2) >> (32 - s));
    return x;
  }
};

// A 64-bit window that holds at least 33 valid bits at its top.
struct Reader {
  unsigned long long buf;
  int valid;
  long long next;

  __device__ void seek(const Bits& b, long long g) {
    g += b.lead;
    const long long i = g >> 5;
    const int s = (int)(g & 31);
    buf = (((unsigned long long)b.word(i) << 32) | b.word(i + 1)) << s;
    valid = 64 - s;
    next = i + 2;
  }
  __device__ __forceinline__ void skip(const Bits& b, int n) {
    buf <<= n;
    valid -= n;
    if (valid <= 32) {
      buf |= (unsigned long long)b.word(next++) << (32 - valid);
      valid += 32;
    }
  }
};

struct Book {
  const unsigned* lut;  // shared; 0 = no codeword of <= kLutBits bits
  const long long* fc;  // shared per-length tables
  const long long* fi;
  const long long* cnt;
  int maxlen;
};

// Loads the per-length tables and the lookup table into shared memory;
// every thread of the block calls it.
__device__ void load_book(Book& bk, unsigned* s_lut, long long* s_fc,
                          long long* s_fi, long long* s_cnt,
                          const unsigned* lut_g, const long long* fc,
                          const long long* fi, const long long* cnt,
                          int maxlen) {
  for (int l = threadIdx.x; l <= maxlen; l += blockDim.x) {
    s_fc[l] = fc[l];
    s_fi[l] = fi[l];
    s_cnt[l] = cnt[l];
  }
  for (int i = threadIdx.x; i < kLutSize; i += blockDim.x) s_lut[i] = lut_g[i];
  bk.lut = s_lut;
  bk.fc = s_fc;
  bk.fi = s_fi;
  bk.cnt = s_cnt;
  bk.maxlen = maxlen;
}

// Length of the codeword at the reader's position (payload bit `g` of
// the data, `avail` bits left in the payload) and its codebook row; 0 if
// the payload ends inside it or no codeword matches.
__device__ __forceinline__ int next_code(const Book& bk, const Reader& r,
                                         const Bits& b, long long g,
                                         long long avail, long long& row) {
  const unsigned e = bk.lut[r.buf >> (64 - kLutBits)];
  if (e & 63u) {
    row = e >> 6;
    return (long long)(e & 63u) <= avail ? (int)(e & 63u) : 0;
  }
  const unsigned long long w = r.valid >= bk.maxlen ? r.buf : b.peek64(g);
  for (int l = 1; l <= bk.maxlen; ++l) {
    if (l > avail) return 0;
    const long long code = (long long)(w >> (64 - l));
    const long long c0 = bk.fc[l], n = bk.cnt[l];
    if (n && code >= c0 && code - c0 < n) {
      row = bk.fi[l] + (code - c0);
      return l;
    }
  }
  return 0;
}

// A chunk's decode in progress: the payload's bit 0 is data bit `base`, it
// has `nb` bits; codewords starting in [pos, end) belong to the chunk.
struct Walk {
  Reader r;
  long long base, pos, end, nb;

  __device__ void start(const Bits& b, long long base_, long long pos_,
                        long long end_, long long nb_) {
    base = base_;
    pos = pos_;
    end = end_;
    nb = nb_;
    if (pos < end) r.seek(b, base + pos);
  }
  // Decodes the next codeword: false if the payload ends inside it or no
  // codeword matches.
  __device__ __forceinline__ bool step(const Book& bk, const Bits& b,
                                       long long& row) {
    const int len = next_code(bk, r, b, base + pos, nb - pos, row);
    if (!len) return false;
    pos += len;
    if (len <= kLutBits)
      r.skip(b, len);
    else
      r.seek(b, base + pos);
    return true;
  }
};

// Decodes the codewords that start in [pos, end) of one payload (see
// Walk).  Returns the bit at which the first codeword at or past `end`
// starts, or -1 if the payload ends inside a codeword or a gap is met
// first; `n` counts the codewords decoded.
__device__ long long decode_run(const Book& bk, const Bits& b, long long base,
                                long long pos, long long end, long long nb,
                                int& n) {
  Walk w;
  w.start(b, base, pos, end, nb);
  n = 0;
  long long row;
  while (w.pos < w.end) {
    if (!w.step(bk, b, row)) return -1;
    ++n;
  }
  return w.pos;
}

// lut[i] = (row << 6) | length of the codeword of at most kLutBits bits
// that the kLutBits-bit window i starts with, or 0 (a miss, which the
// canonical compare of next_code settles).
__global__ void lut_kernel(const long long* __restrict__ fc,
                           const long long* __restrict__ fi,
                           const long long* __restrict__ cnt, int maxlen,
                           unsigned* __restrict__ lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kLutSize) return;
  unsigned e = 0;
  const int top = maxlen < kLutBits ? maxlen : kLutBits;
  for (int l = 1; l <= top; ++l) {
    const long long code = i >> (kLutBits - l);
    if (cnt[l] && code >= fc[l] && code - fc[l] < cnt[l]) {
      const long long row = fi[l] + (code - fc[l]);
      if (row < (1LL << 26)) e = (unsigned)(row << 6) | (unsigned)l;
      break;
    }
  }
  lut[i] = e;
}

struct Plan {
  const long long* byte_off;
  const long long* nbits;
  const long long* n_decode;
  const long long* pay_first;  // (A + 1,) first chunk of each payload
  const long long* chunk_pay;  // (cap,) payload of each chunk, A if none
  const long long* chunk_bit;  // (cap,) first bit of each chunk
  long long cap;
  int n_payloads;
  int chunk_bits;
};

// The payload of chunk c, or -1 if it has none or nothing to decode.
__device__ __forceinline__ int live_payload(const Plan& p, long long c) {
  if (c >= p.cap) return -1;
  const int a = (int)p.chunk_pay[c];
  if (a >= p.n_payloads || p.n_decode[a] <= 0) return -1;
  return a;
}

__device__ __forceinline__ long long chunk_end(const Plan& p, long long c,
                                               int a) {
  const long long e = p.chunk_bit[c] + p.chunk_bits, nb = p.nbits[a];
  return e < nb ? e : nb;
}

__global__ void __launch_bounds__(kThreads)
sync_first_kernel(Bits b, Plan p, const unsigned* __restrict__ lut_g,
                  const long long* __restrict__ fc,
                  const long long* __restrict__ fi,
                  const long long* __restrict__ cnt_tab, int maxlen,
                  long long* __restrict__ entry,
                  long long* __restrict__ exits, int* __restrict__ count,
                  int* __restrict__ stats) {
  __shared__ unsigned s_lut[kLutSize];
  __shared__ long long s_fc[kMaxLen + 1], s_fi[kMaxLen + 1],
      s_cnt[kMaxLen + 1];
  __shared__ int s_guessed;
  Book bk;
  load_book(bk, s_lut, s_fc, s_fi, s_cnt, lut_g, fc, fi, cnt_tab, maxlen);
  if (threadIdx.x == 0) s_guessed = 0;
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int a = live_payload(p, c);
  if (a >= 0) {
    const long long s = p.chunk_bit[c];
    int n;
    entry[c] = s;
    exits[c] = decode_run(bk, b, 8 * p.byte_off[a], s, chunk_end(p, c, a),
                          p.nbits[a], n);
    count[c] = n;
    if (c != p.pay_first[a]) atomicAdd(&s_guessed, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_guessed) atomicAdd(&stats[kStatChanged], s_guessed);
    if (blockIdx.x == 0) stats[kStatPasses] = 1;
  }
}

// Pass `pass` >= 1: reads the exits of pass - 1 from exits[(pass-1) & 1]
// and writes its own to exits[pass & 1].
__global__ void __launch_bounds__(kThreads)
sync_pass_kernel(Bits b, Plan p, const unsigned* __restrict__ lut_g,
                 const long long* __restrict__ fc,
                 const long long* __restrict__ fi,
                 const long long* __restrict__ cnt_tab, int maxlen,
                 long long* __restrict__ entry, long long* __restrict__ exits,
                 int* __restrict__ count, int* __restrict__ stats, int pass) {
  if (stats[kStatChanged + pass - 1] == 0) return;  // settled
  __shared__ unsigned s_lut[kLutSize];
  __shared__ long long s_fc[kMaxLen + 1], s_fi[kMaxLen + 1],
      s_cnt[kMaxLen + 1];
  __shared__ int s_redo;
  if (threadIdx.x == 0) {
    s_redo = 0;
    if (blockIdx.x == 0) stats[kStatPasses] = pass + 1;
  }
  __syncthreads();
  const long long* ein = exits + ((pass - 1) & 1) * p.cap;
  long long* eout = exits + (pass & 1) * p.cap;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int a = live_payload(p, c);
  long long e = 0;
  bool redo = false;
  if (a >= 0) {
    if (c != p.pay_first[a]) {
      e = ein[c - 1];
      redo = e >= 0 && e != entry[c];
    }
    if (!redo) eout[c] = ein[c];
  }
  if (redo) atomicAdd(&s_redo, 1);
  __syncthreads();
  const int n_redo = s_redo;
  if (n_redo == 0) return;
  Book bk;
  load_book(bk, s_lut, s_fc, s_fi, s_cnt, lut_g, fc, fi, cnt_tab, maxlen);
  __syncthreads();
  if (redo) {
    int n;
    entry[c] = e;
    eout[c] = decode_run(bk, b, 8 * p.byte_off[a], e, chunk_end(p, c, a),
                         p.nbits[a], n);
    count[c] = n;
  }
  if (threadIdx.x == 0) atomicAdd(&stats[kStatChanged + pass], n_redo);
}

// First symbol of chunk c within its payload.
__device__ __forceinline__ long long chunk_sym(const Plan& p,
                                               const long long* excl,
                                               long long c, int a) {
  return excl[c] - excl[p.pay_first[a]];
}

__global__ void flag_kernel(Plan p, const long long* __restrict__ entry,
                            const long long* __restrict__ exits,
                            const int* __restrict__ count,
                            const long long* __restrict__ excl,
                            const int* __restrict__ stats,
                            int* __restrict__ flag) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int a = live_payload(p, c);
  if (a < 0) return;
  const long long* ex = exits + ((stats[kStatPasses] - 1) & 1) * p.cap;
  const long long nd = p.n_decode[a];
  const long long off = chunk_sym(p, excl, c, a);
  const long long x = ex[c];
  const bool synced =
      c == p.pay_first[a] || (ex[c - 1] >= 0 && ex[c - 1] == entry[c]);
  const bool last = c + 1 == p.pay_first[a + 1];
  const bool short_of_nd = off + count[c] < nd;
  if ((!synced && off < nd) || (x < 0 && short_of_nd) ||
      (x >= 0 && last && short_of_nd))
    flag[a] = 1;
}

__device__ __forceinline__ bool parallel_ok(const Plan& p, const int* flag,
                                            int a) {
  return !flag[a] && p.pay_first[a + 1] <= p.cap;
}

// Each synced chunk decodes again and writes its symbols.  A thread's run
// of symbols is contiguous in `out` but 32 runs at once would touch 32
// lines a store, so the block decodes in rounds of kStage symbols a thread
// into shared memory, and each warp then writes its 32 runs with coalesced
// stores, two 128-byte runs a store.
__global__ void __launch_bounds__(kThreads)
write_kernel(Bits b, Plan p, const unsigned* __restrict__ lut_g,
             const long long* __restrict__ fc,
             const long long* __restrict__ fi,
             const long long* __restrict__ cnt_tab, int maxlen,
             const long long* __restrict__ symbols,
             const long long* __restrict__ out_off,
             const long long* __restrict__ entry,
             const long long* __restrict__ excl,
             const int* __restrict__ flag, long long* __restrict__ out) {
  static_assert(kStage == 16, "a warp writes two runs of 16 per store");
  __shared__ unsigned s_lut[kLutSize];
  __shared__ long long s_fc[kMaxLen + 1], s_fi[kMaxLen + 1],
      s_cnt[kMaxLen + 1];
  __shared__ long long s_sym[kThreads][kStage + 1];  // +1: no bank conflicts
  __shared__ long long s_dst[kThreads];
  __shared__ int s_n[kThreads];
  Book bk;
  load_book(bk, s_lut, s_fc, s_fi, s_cnt, lut_g, fc, fi, cnt_tab, maxlen);
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int a = live_payload(p, c);
  long long left = 0, dst = 0;
  Walk w;
  if (a >= 0 && parallel_ok(p, flag, a)) {
    const long long off = chunk_sym(p, excl, c, a);
    left = p.n_decode[a] - off;
    dst = out_off[a] + off;
    w.start(b, 8 * p.byte_off[a], entry[c], chunk_end(p, c, a), p.nbits[a]);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp0 = tid & ~31;
  for (;;) {
    int n = 0;
    long long row;
    while (left > 0 && n < kStage && w.pos < w.end) {
      if (!w.step(bk, b, row)) {
        left = 0;
        break;
      }
      s_sym[tid][n++] = __ldg(symbols + row);
      --left;
    }
    if (left > 0 && w.pos >= w.end) left = 0;
    s_n[tid] = n;
    s_dst[tid] = dst;
    dst += n;
    const int more = __syncthreads_or(left > 0);
    for (int i = 0; i < 16; ++i) {
      const int t = warp0 + 2 * i + (lane >> 4), k = lane & 15;
      if (k < s_n[t]) out[s_dst[t] + k] = s_sym[t][k];
    }
    if (!more) break;
    __syncthreads();
  }
}

// The oracle's walk, one thread per payload, for the payloads the
// parallel decode leaves (all of them when walk_all).
__global__ void serial_kernel(
    const uint8_t* __restrict__ data, Plan p,
    const long long* __restrict__ out_off,
    const long long* __restrict__ symbols, long long n_symbols,
    const long long* __restrict__ first_code,
    const long long* __restrict__ first_index,
    const long long* __restrict__ count, int maxlen,
    const int* __restrict__ flag, int walk_all, long long* __restrict__ out,
    int* __restrict__ err, int* __restrict__ stats) {
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
  if (a == 0) stats[0] = (int)p.pay_first[p.n_payloads];
  if (a >= p.n_payloads) return;
  const long long nd = p.n_decode[a];
  if (nd <= 0) return;
  if (!walk_all && p.pay_first[a + 1] > p.pay_first[a] &&
      parallel_ok(p, flag, a))
    return;
  atomicAdd(&stats[kStatSerial], 1);
  int kind = 0;
  const long long nb = p.nbits[a];
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
    const uint8_t* q = data + p.byte_off[a];
    long long pos = 0;
    unsigned int byte = 0;
    int avail = 0;
    for (long long k = 0; k < nd && kind == 0; ++k) {
      long long code = 0;
      for (int l = 1;; ++l) {
        if (pos >= nb) { kind = 1; break; }
        if (avail == 0) { byte = q[pos >> 3]; avail = 8; }
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
  err[a] = kind;
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

Bits make_bits(const uint8_t* data, long long n_data) {
  const uintptr_t addr = (uintptr_t)data;
  const long long lead = (long long)(addr & 3u);
  return Bits{(const uint32_t*)(addr - lead), (lead + n_data + 3) / 4,
              8 * lead};
}

Plan make_plan(const long long* byte_off, const long long* nbits,
               const long long* n_decode, const long long* pay_first,
               const long long* chunk_pay, const long long* chunk_bit,
               long long cap, int n_payloads, int chunk_bits) {
  return Plan{byte_off, nbits, n_decode, pay_first, chunk_pay, chunk_bit,
              cap, n_payloads, chunk_bits};
}

}  // namespace

extern "C" int huffdec_sync_passes() { return kSyncPasses; }

// Chunk sync: the lookup table, the first decode of every chunk and up to
// kSyncPasses correcting passes.  Tables hold at least maxlen + 1 entries,
// maxlen <= 57, n_symbols >= 2.  Workspace: lut (2^11 uint32), entry (cap),
// exits (2 cap), count (cap int32), stats (3 + kSyncPasses + 1 int32,
// zeroed).  `nbits` is the effective bit count, min(nbits, 8 * payload
// bytes).
extern "C" int huffdec_sync(
    const uint8_t* data, long long n_data, const long long* byte_off,
    const long long* nbits, const long long* n_decode, int n_payloads,
    long long n_symbols, const long long* first_code,
    const long long* first_index, const long long* count, int maxlen,
    const long long* pay_first, const long long* chunk_pay,
    const long long* chunk_bit, long long cap, int chunk_bits, unsigned* lut,
    long long* entry, long long* exits, int* chunk_count, int* stats,
    cudaStream_t stream) {
  if (maxlen < 1 || maxlen > kMaxLen || n_symbols < 2 || chunk_bits < 1)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  const Bits b = make_bits(data, n_data);
  const Plan p = make_plan(byte_off, nbits, n_decode, pay_first, chunk_pay,
                           chunk_bit, cap, n_payloads, chunk_bits);
  lut_kernel<<<blocks_for(kLutSize, kThreads), kThreads, 0, stream>>>(
      first_code, first_index, count, maxlen, lut);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const unsigned grid = blocks_for(cap, kThreads);
  sync_first_kernel<<<grid, kThreads, 0, stream>>>(
      b, p, lut, first_code, first_index, count, maxlen, entry, exits,
      chunk_count, stats);
  rc = (int)cudaGetLastError();
  for (int pass = 1; pass <= kSyncPasses && !rc; ++pass) {
    sync_pass_kernel<<<grid, kThreads, 0, stream>>>(
        b, p, lut, first_code, first_index, count, maxlen, entry, exits,
        chunk_count, stats, pass);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

// Flags, writes the synced chunks' symbols, and walks the rest serially
// (every payload when walk_all, which needs no sync workspace).  `excl`
// holds each chunk's exclusive running count of codewords (any origin);
// `flag` (A int32) and `err` start zeroed.
extern "C" int huffdec_finish(
    const uint8_t* data, long long n_data, const long long* byte_off,
    const long long* nbits, const long long* n_decode,
    const long long* out_off, int n_payloads, const long long* symbols,
    long long n_symbols, const long long* first_code,
    const long long* first_index, const long long* count, int maxlen,
    const long long* pay_first, const long long* chunk_pay,
    const long long* chunk_bit, long long cap, int chunk_bits,
    const unsigned* lut, const long long* entry, const long long* exits,
    const int* chunk_count, const long long* excl, int* flag, int walk_all,
    long long* out, int* err, int* stats, cudaStream_t stream) {
  if (n_payloads == 0) return 0;
  if (maxlen < 0 || maxlen > kMaxLen || chunk_bits < 1)
    return (int)cudaErrorInvalidValue;
  const Bits b = make_bits(data, n_data);
  const Plan p = make_plan(byte_off, nbits, n_decode, pay_first, chunk_pay,
                           chunk_bit, cap, n_payloads, chunk_bits);
  int rc = 0;
  if (!walk_all && cap > 0) {
    const unsigned grid = blocks_for(cap, kThreads);
    flag_kernel<<<grid, kThreads, 0, stream>>>(p, entry, exits, chunk_count,
                                                excl, stats, flag);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    write_kernel<<<grid, kThreads, 0, stream>>>(
        b, p, lut, first_code, first_index, count, maxlen, symbols, out_off,
        entry, excl, flag, out);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  serial_kernel<<<blocks_for(n_payloads, 128), 128, 0, stream>>>(
      data, p, out_off, symbols, n_symbols, first_code, first_index, count,
      maxlen, flag, walk_all, out, err, stats);
  return (int)cudaGetLastError();
}
