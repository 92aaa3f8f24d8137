// Canonical-Huffman chunk decode (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel huffdecode_chunks_multi in
// src/repro/kernels/huffdecode.py:92 (bodies _decode_block and
// _huffdecode_multi_kernel).  Each HUFF chunk of a ZNN1 stream is an
// independent MSB-first canonical-code bitstream; every step takes a
// lut_bits-wide window at the bit cursor, gathers one fused (sym << 4) | len
// entry from the chunk's plane row of the stacked LUTs, writes sym and
// advances the cursor by len.  (The TPU kernel fuses (sym << 8) | len into
// int32; len <= 15 fits four bits, so here an entry is an int16 and a
// resident row is half the size.)
//
// Three kernels.
//
// huffdecode_selfsync_kernel, the decode with no index: the one-shot decode
// (restores, file frames, deltas, the KV tier's cold blocks) and the index
// pass a resident payload feed runs once at build.  A chunk's position of
// symbol i+1 depends on symbol i's code length, so one thread per chunk is
// one chain of `count` steps, and a bf16 weight's exponent plane has only 18
// chunks at the default chunking: latency, not bytes, bounds it.  Here all
// the threads of a block decode one chunk (Weissenberger and Schmidt,
// "Massively Parallel Huffman Decoding on GPUs", ICPP 2018): the chunk's
// bits are cut into segments of seg_bits, each started at a guessed bit
// (only segment 0 is known to start on a codeword).
//  * Phase 1, synchronise: a segment decodes from its start until its
//    cursor reaches its end, recording where (its first codeword boundary
//    at or past the end), how many symbols it passed and whether it met a
//    length-0 entry (an incomplete code's LUT has them; a mis-started
//    segment of a valid stream can land on one too) and stalled there.
//    Then, block-wide, wherever segment k+1's start differs from segment
//    k's end, segment k+1 restarts there and decodes again, until nothing
//    changes: by induction from segment 0 the fixpoint is the serial
//    decode's partition.  Canonical codes resynchronise within tens of bits,
//    so a round or two usually does, and a restarted segment stops where
//    it meets a position its previous walk visited (each segment keeps a
//    mask of those in its first 64 bits); a code whose lengths share a
//    factor may need a round per segment, and the loop is bounded by the
//    count.  A thread owns a run of consecutive segments and carries its
//    own end into its next segment at once, so only a thread's first
//    segment waits for a round.
//  * Phase 2, place and emit: a block-wide scan of the symbol counts gives
//    each thread its first symbol number; each thread decodes its run again
//    from its true start, writing symbols (when asked: 16-byte stores as in
//    the sync decode) and the index entries that fall in it, and the thread
//    holding symbol count-1 writes the final cursor.  Without symbols a run
//    is walked only as far as its last index entry.
//  * Closed forms: once the cursor passes the chunk's words every window
//    reads zeros, so every further step gathers the same entry at a constant
//    length (possibly 0); after a stall the cursor stays put.  Symbols, index
//    entries and the final cursor past that point are written as such, in
//    parallel, not by a chain.  So on every input, valid or not, the outputs
//    equal the chain's.
// The block stages its LUT row and, when they fit, the chunk's words in
// shared memory with cp.async (as the sync decode does) and keeps each
// segment's state there; a chunk with more segments than the state holds
// gets longer segments.  Symbols and the index are separate optional
// outputs (null: not written): the feed's build asks for the index and the
// cursors, the one-shot decode for the symbols and the cursors.  With a
// non-null `rounds` it also writes the rounds of phase 1 each chunk took
// after its first pass.
//
// huffdecode_sync_kernel, the decode the serving ring runs every step: the
// index cuts a chunk into ceil(count / sync_every) independent sub-streams.
// One block per chunk, one thread per sub-stream (a loop when there are more
// than the block's threads).  What bounds it is still the chain inside a
// sub-stream, now sync_every steps long instead of count, so the design
// makes each step short:
//  * the block stages its LUT row (<= 64 KiB) and, when they fit, the
//    chunk's words in dynamic shared memory with cp.async (16-byte copies
//    for the aligned body), so every gather and word read hits shared
//    memory.  A chunk's HUFF payload is smaller than its raw size, so at the
//    default 131,072-symbol plane chunks words plus row stay under the
//    227 KB a block may take; a block whose words do not fit (larger chunks)
//    reads them from global memory instead;
//  * each thread keeps a 64-bit MSB-aligned bit buffer and refills it one
//    word at a time, not two word loads per symbol;
//  * a thread's symbols are contiguous in the output, so it packs them into
//    16-byte stores, with the misaligned head and ragged tail byte by byte.
//
// huffdecode_chain_kernel, one thread per chunk walking all its symbols
// (this port's first design).  No path runs it: it stays as the baseline the
// measurements time beside the self-synchronising decode.
//
// Invariants all three keep:
//  * words are packed compactly: chunk c owns words
//    [word_off[c], word_off[c+1]), so the resident feed holds compressed
//    bytes only, not chunk-capacity-padded buffers;
//  * a read past a chunk's own words yields 0 (the zero padding a
//    capacity-padded layout would hold) and never leaves the chunk, so a
//    corrupt or truncated payload decodes garbage that the host-side
//    cursor check rejects, never an out-of-bounds read;
//  * symbols go straight to out[out_off[c] ...], the chunk's place in its
//    output plane, so the caller needs no per-chunk slice or concatenate;
//  * cursors (and index entries) only saturate at INT32_MAX.  They must not
//    be clamped to the chunk's own (compact) word capacity: that capacity
//    ends inside the payload's last word, so a runaway cursor clamped there
//    could land in the payload's final byte and pass the host check.  On
//    valid streams cursors equal the reference's exactly, and the sync
//    decode's final cursor (the last sub-stream's end) equals the serial
//    one's.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SYNC_THREADS = 256;
constexpr int SS_THREADS = 1024;       // threads of a self-synchronising block
constexpr int SS_MAX_SEGS = 2048;      // segments a block keeps state for

__device__ __forceinline__ int32_t saturate(int64_t x) {
  return static_cast<int32_t>(x < INT32_MAX ? x : INT32_MAX);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ int lut_region_bytes(int lut_bits) {
  // the row plus up to 12 bytes of lead (see stage), rounded to 16
  return ((2 << lut_bits) + 12 + 15) & ~15;
}

__global__ void huffdecode_chain_kernel(const uint32_t* __restrict__ words,
                                        const int64_t* __restrict__ word_off,
                                        const int32_t* __restrict__ plane_ids,
                                        const int32_t* __restrict__ counts,
                                        const int64_t* __restrict__ out_off,
                                        const int16_t* __restrict__ luts,
                                        int lut_bits, int n_chunks,
                                        uint8_t* __restrict__ out,
                                        int32_t* __restrict__ cursors,
                                        const int64_t* __restrict__ sync_off,
                                        int32_t* __restrict__ sync, int sync_every) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const uint32_t* w = words + word_off[c];
  const int64_t nw = word_off[c + 1] - word_off[c];
  const int16_t* lut = luts + (static_cast<int64_t>(plane_ids[c]) << lut_bits);
  uint8_t* dst = out + out_off[c];
  const int count = counts[c];
  const uint32_t shift = 32u - static_cast<uint32_t>(lut_bits);
  int32_t* idx = sync ? sync + sync_off[c] : nullptr;
  int next_sync = 0;

  int64_t bitpos = 0;
  for (int i = 0; i < count; ++i) {
    if (idx && i == next_sync) {
      *idx++ = saturate(bitpos);
      next_sync += sync_every;
    }
    const int64_t w0 = bitpos >> 5;
    const uint32_t o = static_cast<uint32_t>(bitpos & 31);
    const uint32_t a = w0 < nw ? __ldg(w + w0) : 0u;
    const uint32_t b = w0 + 1 < nw ? __ldg(w + w0 + 1) : 0u;
    // (a << o) puts the window's first bit at the MSB; b adds its top o
    // bits.  The double shift stays defined at o == 0.
    const uint32_t win = (a << o) | ((b >> 1) >> (31u - o));
    const int v = __ldg(lut + (win >> shift));
    dst[i] = static_cast<uint8_t>(v >> 4);
    bitpos += v & 0xF;
  }
  cursors[c] = saturate(bitpos);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Queues the copy of nbytes (a multiple of 4) from 4-byte-aligned global src
// into shared memory at dst + (src & 12), dst 16-byte aligned, so that both
// sides agree modulo 16 and the body moves in 16-byte copies; the head up to
// src's first 16-byte boundary and the tail move 4 bytes at a time.  Returns
// where the staged bytes start.  The block waits with cp_async_wait_all.
__device__ __forceinline__ uint8_t* stage(uint8_t* dst, const uint8_t* src, int64_t nbytes) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 12);
  uint8_t* s = dst + lead;
  const int64_t head = min64((16 - lead) & 15, nbytes);
  const int64_t body_end = head + (nbytes - head) / 16 * 16;
  for (int64_t i = 4 * threadIdx.x; i < head; i += 4 * blockDim.x) cp_async4(s + i, src + i);
  for (int64_t i = head + 16 * threadIdx.x; i < body_end; i += 16 * blockDim.x)
    cp_async16(s + i, src + i);
  for (int64_t i = body_end + 4 * threadIdx.x; i < nbytes; i += 4 * blockDim.x)
    cp_async4(s + i, src + i);
  return s;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool STAGED>
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int64_t i, int64_t nw) {
  // unsigned compare: a negative index (a bad sync entry) reads 0 too
  if (static_cast<uint64_t>(i) >= static_cast<uint64_t>(nw)) return 0u;
  return STAGED ? w[i] : __ldg(w + i);
}

// Decodes n symbols of one sub-stream starting at bit `pos` of the chunk's
// words w[0 .. nw) into dst; returns the bit cursor after the last one.
template <bool STAGED>
__device__ __forceinline__ int64_t decode_run(const uint32_t* w, int64_t nw,
                                              const int16_t* lut, int lut_bits,
                                              int64_t pos, int n, uint8_t* dst) {
  int64_t wi = pos >> 5;
  const uint32_t o = static_cast<uint32_t>(pos & 31);
  uint64_t buf = ((static_cast<uint64_t>(word_at<STAGED>(w, wi, nw)) << 32) |
                  word_at<STAGED>(w, wi + 1, nw)) << o;
  int nbits = 64 - static_cast<int>(o);      // valid bits at the top of buf
  wi += 2;
  const uint32_t shift = 64u - static_cast<uint32_t>(lut_bits);
  auto next = [&]() -> uint32_t {
    if (nbits < 32) {                        // >= 17 left: room for one word
      buf |= static_cast<uint64_t>(word_at<STAGED>(w, wi++, nw)) << (32 - nbits);
      nbits += 32;
    }
    const int v = lut[buf >> shift];
    const int len = v & 0xF;
    buf <<= len;
    nbits -= len;
    pos += len;
    return static_cast<uint32_t>(v >> 4) & 0xFFu;
  };
  int i = 0;
  const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15), n);
  for (; i < head; ++i) dst[i] = static_cast<uint8_t>(next());
  for (; i + 16 <= n; i += 16) {
    uint32_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t x = next();
      x |= next() << 8;
      x |= next() << 16;
      x |= next() << 24;
      q[j] = x;
    }
    *reinterpret_cast<uint4*>(dst + i) = make_uint4(q[0], q[1], q[2], q[3]);
  }
  for (; i < n; ++i) dst[i] = static_cast<uint8_t>(next());
  return pos;
}

// Every sub-stream of chunk c, one thread each (a loop past blockDim.x), from
// the chunk's words w (staged in shared memory or not) and its staged LUT row.
template <bool STAGED>
__device__ __forceinline__ void decode_chunk(const uint32_t* w, int64_t nw, const int16_t* lut,
                                             int lut_bits, int count, const int32_t* idx,
                                             int sync_every, uint8_t* dst, int32_t* cursor) {
  const int nsub = static_cast<int>((static_cast<int64_t>(count) + sync_every - 1) / sync_every);
  for (int k = threadIdx.x; k < nsub; k += blockDim.x) {
    const int64_t first = static_cast<int64_t>(k) * sync_every;
    const int n = static_cast<int>(min64(sync_every, count - first));
    const int64_t end = decode_run<STAGED>(w, nw, lut, lut_bits, idx[k], n, dst + first);
    if (k == nsub - 1) *cursor = saturate(end);
  }
  if (nsub == 0 && threadIdx.x == 0) *cursor = 0;
}

__global__ void __launch_bounds__(SYNC_THREADS)
huffdecode_sync_kernel(const uint32_t* __restrict__ words,
                       const int64_t* __restrict__ word_off,
                       const int32_t* __restrict__ plane_ids,
                       const int32_t* __restrict__ counts,
                       const int64_t* __restrict__ out_off,
                       const int16_t* __restrict__ luts, int lut_bits,
                       const int64_t* __restrict__ sync_off,
                       const int32_t* __restrict__ sync, int sync_every,
                       int64_t word_cap, uint8_t* __restrict__ out,
                       int32_t* __restrict__ cursors) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = blockIdx.x;
  const uint32_t* gw = words + word_off[c];
  const int64_t nw = word_off[c + 1] - word_off[c];
  const auto* row = reinterpret_cast<const uint8_t*>(
      luts + (static_cast<int64_t>(plane_ids[c]) << lut_bits));
  const auto* lut = reinterpret_cast<const int16_t*>(stage(smem, row, 2LL << lut_bits));
  const int32_t* idx = sync + sync_off[c];
  uint8_t* dst = out + out_off[c];
  // nw is the same for every thread: the block takes one branch
  if (nw <= word_cap) {
    const auto* sw = reinterpret_cast<const uint32_t*>(stage(
        smem + lut_region_bytes(lut_bits), reinterpret_cast<const uint8_t*>(gw), 4 * nw));
    cp_async_wait_all();
    __syncthreads();
    decode_chunk<true>(sw, nw, lut, lut_bits, counts[c], idx, sync_every, dst, cursors + c);
  } else {
    cp_async_wait_all();
    __syncthreads();
    decode_chunk<false>(gw, nw, lut, lut_bits, counts[c], idx, sync_every, dst, cursors + c);
  }
}

// A 64-bit MSB-aligned bit buffer over a chunk's words, refilled one word
// at a time (the sync decode's decode_run keeps the same one).
template <bool STAGED>
struct BitCursor {
  const uint32_t* w;
  int64_t nw, wi;
  uint64_t buf;
  int nbits;                                 // valid bits at the top of buf

  __device__ __forceinline__ BitCursor(const uint32_t* w_, int64_t nw_, int64_t pos)
      : w(w_), nw(nw_) {
    wi = pos >> 5;
    const uint32_t o = static_cast<uint32_t>(pos & 31);
    buf = ((static_cast<uint64_t>(word_at<STAGED>(w, wi, nw)) << 32) |
           word_at<STAGED>(w, wi + 1, nw)) << o;
    nbits = 64 - static_cast<int>(o);
    wi += 2;
  }
  // The fused entry at the cursor (the top lut_bits bits: shift = 64 - lut_bits).
  __device__ __forceinline__ int entry(const int16_t* lut, uint32_t shift) {
    if (nbits < 32) {                        // >= 17 left: room for one word
      buf |= static_cast<uint64_t>(word_at<STAGED>(w, wi++, nw)) << (32 - nbits);
      nbits += 32;
    }
    return lut[buf >> shift];
  }
  __device__ __forceinline__ void skip(int len) {
    buf <<= len;
    nbits -= len;
  }
};

// The cursor after n symbols from `pos`, nothing written.
template <bool STAGED>
__device__ __forceinline__ int64_t advance(const uint32_t* w, int64_t nw, const int16_t* lut,
                                           uint32_t shift, int64_t pos, int64_t n) {
  if (n <= 0) return pos;
  BitCursor<STAGED> b(w, nw, pos);
  for (int64_t i = 0; i < n; ++i) {
    const int len = b.entry(lut, shift) & 0xF;
    b.skip(len);
    pos += len;
  }
  return pos;
}

// Symbols first .. first+n-1 of a chunk from `pos`, its cursor before
// symbol `first`: each into dst[i] (dst non-null) and each multiple of
// sync_every into idx[i / sync_every] (idx non-null).  Returns the cursor
// after the last.
template <bool STAGED>
__device__ __forceinline__ int64_t emit(const uint32_t* w, int64_t nw, const int16_t* lut,
                                        int lut_bits, int64_t pos, int64_t first, int64_t n,
                                        uint8_t* dst, int32_t* idx, int sync_every) {
  const uint32_t shift = 64u - static_cast<uint32_t>(lut_bits);
  const int64_t end = first + n;
  for (int64_t i = first; i < end;) {
    int64_t next = end;
    if (idx) {
      const int64_t q = i / sync_every;
      if (q * sync_every == i) idx[q] = saturate(pos);
      next = min64(end, (q + 1) * sync_every);
    }
    pos = dst ? decode_run<STAGED>(w, nw, lut, lut_bits, pos, static_cast<int>(next - i), dst + i)
              : advance<STAGED>(w, nw, lut, shift, pos, next - i);
    i = next;
  }
  return pos;
}

// Per-chunk state of a self-synchronising block (static shared memory).
struct SelfSyncState {
  uint64_t path[SS_MAX_SEGS];      // bit i: the segment's walk visits its bound + i
  int32_t count[SS_MAX_SEGS];      // symbols a segment passed (before a stall)
  uint8_t start[SS_MAX_SEGS];      // segment k starts at k * seg + start[k]
  uint8_t end[SS_MAX_SEGS];        // and ends at its bound + end[k] (not stalled)
  uint8_t stalled[SS_MAX_SEGS];
  int64_t warp_sum[SS_THREADS / 32];
  int64_t tail_first;              // the first symbol of the closed-form tail
  int64_t tail_pos;                // and its cursor
  int first_stall;                 // the first thread whose run stalls
};

// Exclusive sum of x over the block's threads (blockDim.x a multiple of 32,
// every thread calling); *total gets the sum of all.
__device__ __forceinline__ int64_t block_exclusive_sum(int64_t x, int64_t* warp_sum,
                                                       int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int64_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t s = lane < warps ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < warps) warp_sum[lane] = s;
  }
  __syncthreads();
  *total = warp_sum[warps - 1];
  return (warp ? warp_sum[warp - 1] : 0) + incl - x;
}

// One chunk, every thread of the block.
template <bool STAGED>
__device__ __forceinline__ void selfsync_chunk(const uint32_t* w, int64_t nw, const int16_t* lut,
                                               int lut_bits, int count, int64_t seg_bits,
                                               uint8_t* dst, int32_t* idx, int sync_every,
                                               int32_t* cursor, int32_t* rounds,
                                               SelfSyncState& sh) {
  const uint32_t shift = 64u - static_cast<uint32_t>(lut_bits);
  const int64_t bits = 32 * nw;
  int64_t seg = seg_bits;
  if ((bits + seg - 1) / seg > SS_MAX_SEGS) seg = (bits + SS_MAX_SEGS - 1) / SS_MAX_SEGS;
  const int nseg = static_cast<int>((bits + seg - 1) / seg);
  const int per = (nseg + blockDim.x - 1) / blockDim.x;
  const int k0 = min(nseg, static_cast<int>(threadIdx.x) * per);
  const int k1 = min(nseg, k0 + per);
  auto lo = [&](int k) { return static_cast<int64_t>(k) * seg; };
  auto hi = [&](int k) { return min64(static_cast<int64_t>(k + 1) * seg, bits); };
  // Segment k from its recorded start until the cursor reaches the
  // segment's end or meets a length-0 entry: its count, end and stall flag,
  // and the positions it visits in its first 64 bits.  With `again` (a new
  // start), the walk stops where it meets a position of the segment's
  // previous walk: from there the two walks are one, so the end and the
  // stall stay, and the count is the new steps plus the old walk's from
  // there (all of whose earlier positions lie in the first 64 bits).
  auto walk = [&](int k, bool again) {
    const int64_t base = lo(k), end = hi(k);
    const uint64_t old = again ? sh.path[k] : 0;
    uint64_t seen = 0;
    int64_t pos = base + sh.start[k];
    int32_t n = 0;
    bool stall = false, met = false;
    if (pos < end) {
      BitCursor<STAGED> b(w, nw, pos);
      do {
        const int64_t off = pos - base;
        if (off < 64) {
          const uint64_t bit = 1ull << off;
          if (old & bit) {
            met = true;
            break;
          }
          seen |= bit;
        }
        const int len = b.entry(lut, shift) & 0xF;
        if (len == 0) {
          stall = true;
          break;
        }
        b.skip(len);
        pos += len;
        ++n;
      } while (pos < end);
    }
    if (met) {
      const uint64_t below = (1ull << (pos - base)) - 1;
      sh.count[k] += n - __popcll(old & below);
      sh.path[k] = seen | (old & ~below);
    } else {
      sh.count[k] = n;
      sh.stalled[k] = stall;
      sh.end[k] = stall ? 0 : static_cast<uint8_t>(pos - end);
      sh.path[k] = seen;
    }
  };

  // Phase 1: the first pass, each run's later segments from their
  // predecessor's end; then rounds over the runs' first segments.
  for (int k = k0; k < k1; ++k) {
    sh.start[k] = (k > k0 && !sh.stalled[k - 1]) ? sh.end[k - 1] : 0;
    walk(k, false);
  }
  int r = 0;
  for (int round = 0; round <= nseg; ++round) {   // the fixpoint takes < nseg rounds
    __syncthreads();
    int moved = -1;
    if (k0 > 0 && k0 < k1 && !sh.stalled[k0 - 1] && sh.start[k0] != sh.end[k0 - 1])
      moved = sh.end[k0 - 1];
    if (!__syncthreads_or(moved >= 0)) break;
    ++r;
    if (moved >= 0) {
      sh.start[k0] = static_cast<uint8_t>(moved);
      walk(k0, true);
      for (int k = k0 + 1; k < k1 && !sh.stalled[k - 1] && sh.start[k] != sh.end[k - 1]; ++k) {
        sh.start[k] = sh.end[k - 1];
        walk(k, true);
      }
    }
  }
  __syncthreads();

  // Phase 2: each run's symbols up to its first stall, placed by a scan.
  int64_t run = 0;
  bool stall = false;
  for (int k = k0; k < k1 && !stall; ++k) {
    run += sh.count[k];
    stall = sh.stalled[k];
  }
  if (stall) atomicMin(&sh.first_stall, static_cast<int>(threadIdx.x));
  int64_t total;
  const int64_t first = block_exclusive_sum(run, sh.warp_sum, &total);
  const int first_stall = sh.first_stall;
  if (static_cast<int>(threadIdx.x) <= first_stall) {         // reached by the decode
    int64_t pos = k0 < k1 ? lo(k0) + sh.start[k0] : 0;
    const int64_t n = max64(0, min64(run, count - first));
    const bool ends = first + n == count ||                   // the final cursor, or
                      (static_cast<int>(threadIdx.x) == first_stall && n == run);  // the stall
    // without symbols a run is walked only as far as its last index entry
    int64_t m = n;
    if (!dst && !ends) {
      const int64_t last = (first + n - 1) / sync_every * sync_every;
      m = idx && last >= first ? last - first + 1 : 0;
    }
    if (m > 0) pos = emit<STAGED>(w, nw, lut, lut_bits, pos, first, m, dst, idx, sync_every);
    if (n > 0 && first + n == count) *cursor = saturate(pos);
    if (static_cast<int>(threadIdx.x) == first_stall) {
      sh.tail_first = first + run;
      if (n == run) sh.tail_pos = pos;       // the stall; needed only when reached
    }
  }
  if (first_stall == INT_MAX && threadIdx.x == 0) {
    sh.tail_first = total;
    sh.tail_pos = nseg ? hi(nseg - 1) + sh.end[nseg - 1] : 0;
  }
  __syncthreads();

  // The closed-form tail: symbols tail_first .. count-1 all take the entry
  // at tail_pos, a constant step (0 after a stall).
  const int64_t t0 = sh.tail_first;
  if (count > t0) {
    const int64_t p = sh.tail_pos;
    BitCursor<STAGED> b(w, nw, p);
    const int v = b.entry(lut, shift);
    const int64_t len = v & 0xF;
    if (dst) {
      const uint8_t sym = static_cast<uint8_t>(v >> 4);
      for (int64_t i = t0 + threadIdx.x; i < count; i += blockDim.x) dst[i] = sym;
    }
    if (idx) {
      for (int64_t q = (t0 + sync_every - 1) / sync_every + threadIdx.x;
           q * sync_every < count; q += blockDim.x)
        idx[q] = saturate(p + (q * sync_every - t0) * len);
    }
    if (threadIdx.x == 0) *cursor = saturate(p + (count - t0) * len);
  }
  if (count == 0 && threadIdx.x == 0) *cursor = 0;
  if (rounds && threadIdx.x == 0) *rounds = r;
}

__global__ void __launch_bounds__(SS_THREADS, 1)
huffdecode_selfsync_kernel(const uint32_t* __restrict__ words,
                           const int64_t* __restrict__ word_off,
                           const int32_t* __restrict__ plane_ids,
                           const int32_t* __restrict__ counts,
                           const int64_t* __restrict__ out_off,
                           const int16_t* __restrict__ luts, int lut_bits,
                           const int64_t* __restrict__ sync_off, int sync_every,
                           int64_t seg_bits, int64_t word_cap,
                           uint8_t* __restrict__ out, int32_t* __restrict__ cursors,
                           int32_t* __restrict__ sync, int32_t* __restrict__ rounds) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ SelfSyncState sh;
  const int c = blockIdx.x;
  const uint32_t* gw = words + word_off[c];
  const int64_t nw = word_off[c + 1] - word_off[c];
  const auto* row = reinterpret_cast<const uint8_t*>(
      luts + (static_cast<int64_t>(plane_ids[c]) << lut_bits));
  const auto* lut = reinterpret_cast<const int16_t*>(stage(smem, row, 2LL << lut_bits));
  uint8_t* dst = out ? out + out_off[c] : nullptr;
  int32_t* idx = sync ? sync + sync_off[c] : nullptr;
  int32_t* rnd = rounds ? rounds + c : nullptr;
  if (threadIdx.x == 0) sh.first_stall = INT_MAX;
  // nw is the same for every thread: the block takes one branch
  if (nw <= word_cap) {
    const auto* sw = reinterpret_cast<const uint32_t*>(stage(
        smem + lut_region_bytes(lut_bits), reinterpret_cast<const uint8_t*>(gw), 4 * nw));
    cp_async_wait_all();
    __syncthreads();
    selfsync_chunk<true>(sw, nw, lut, lut_bits, counts[c], seg_bits, dst, idx, sync_every,
                         cursors + c, rnd, sh);
  } else {
    cp_async_wait_all();
    __syncthreads();
    selfsync_chunk<false>(gw, nw, lut, lut_bits, counts[c], seg_bits, dst, idx, sync_every,
                          cursors + c, rnd, sh);
  }
}

}  // namespace

extern "C" {

// The chain baseline: one thread per chunk.
// words u32[W], word_off i64[n_chunks + 1], plane_ids i32[n_chunks],
// counts i32[n_chunks], out_off i64[n_chunks], luts i16[P, 1 << lut_bits]
// -> out u8[...] (count symbols at each out_off), cursors i32[n_chunks].
// With sync non-null, also the index: sync i32[sync_off[n_chunks]], chunk c's
// entries at sync_off[c] ..., ceil(counts[c] / sync_every) of them.
int huffdecode_chain_launch(const void* words, const void* word_off,
                            const void* plane_ids, const void* counts,
                            const void* out_off, const void* luts,
                            int lut_bits, int n_chunks, void* out,
                            void* cursors, const void* sync_off, void* sync,
                            int sync_every, void* stream) {
  if (n_chunks > 0) {
    const int threads = 32;
    const int blocks = (n_chunks + threads - 1) / threads;
    huffdecode_chain_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int64_t*>(word_off),
        static_cast<const int32_t*>(plane_ids),
        static_cast<const int32_t*>(counts),
        static_cast<const int64_t*>(out_off),
        static_cast<const int16_t*>(luts), lut_bits, n_chunks,
        static_cast<uint8_t*>(out), static_cast<int32_t*>(cursors),
        static_cast<const int64_t*>(sync_off), static_cast<int32_t*>(sync), sync_every);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory a block of `kernel` may take on the current device
// beside its static shared memory.
static int dynamic_smem(const void* kernel, int* bytes) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  *bytes = err == cudaSuccess ? optin - static_cast<int>(attr.sharedSizeBytes) : 0;
  return static_cast<int>(err);
}

// Words of one chunk a block stages in shared memory beside the LUT row
// region, in `smem` bytes of dynamic shared memory (3 words of lead).
static long long staged_words(int smem, int lut_bits) {
  const long long words = (smem - lut_region_bytes(lut_bits)) / 4 - 3;
  return words > 0 ? words : 0;
}

// Words a block of the sync kernel stages in shared memory on the current
// device: chunks with more words read them from global memory.
int huffdecode_sync_word_cap(int lut_bits, long long* cap) {
  int smem = 0;
  const int rc = dynamic_smem(reinterpret_cast<const void*>(huffdecode_sync_kernel), &smem);
  *cap = staged_words(smem, lut_bits);
  return rc;
}

// The same inputs and outputs, decoded from the index sync (entries as the
// index pass writes them): one block per chunk on the stream.
int huffdecode_sync_launch(const void* words, const void* word_off,
                           const void* plane_ids, const void* counts,
                           const void* out_off, const void* luts, int lut_bits,
                           int n_chunks, const void* sync_off, const void* sync,
                           int sync_every, void* out, void* cursors, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  long long word_cap = 0;
  const int rc = huffdecode_sync_word_cap(lut_bits, &word_cap);
  if (rc) return rc;
  // the row region, then word_cap words and up to 3 words of lead
  const int smem = lut_region_bytes(lut_bits) + static_cast<int>(4 * (word_cap + 3));
  const cudaError_t err = cudaFuncSetAttribute(
      huffdecode_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  huffdecode_sync_kernel<<<n_chunks, SYNC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(word_off),
      static_cast<const int32_t*>(plane_ids),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(out_off),
      static_cast<const int16_t*>(luts), lut_bits,
      static_cast<const int64_t*>(sync_off), static_cast<const int32_t*>(sync), sync_every,
      word_cap, static_cast<uint8_t*>(out), static_cast<int32_t*>(cursors));
  return static_cast<int>(cudaGetLastError());
}

// The self-synchronising decode: the same inputs, segments of seg_bits
// (>= 16) bits; out (symbols), sync (the index at sync_off, every
// sync_every symbols) and rounds (i32[n_chunks]) each optional (null: not
// written), cursors always.  One block per chunk on the stream.
int huffdecode_selfsync_launch(const void* words, const void* word_off,
                               const void* plane_ids, const void* counts,
                               const void* out_off, const void* luts, int lut_bits,
                               int n_chunks, const void* sync_off, int sync_every,
                               long long seg_bits, void* out, void* cursors, void* sync,
                               void* rounds, void* stream) {
  if (n_chunks <= 0) return static_cast<int>(cudaGetLastError());
  int smem = 0;
  const int rc = dynamic_smem(reinterpret_cast<const void*>(huffdecode_selfsync_kernel), &smem);
  if (rc) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      huffdecode_selfsync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  huffdecode_selfsync_kernel<<<n_chunks, SS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(word_off),
      static_cast<const int32_t*>(plane_ids),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(out_off),
      static_cast<const int16_t*>(luts), lut_bits,
      static_cast<const int64_t*>(sync_off), sync_every, static_cast<int64_t>(seg_bits),
      staged_words(smem, lut_bits), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(cursors), static_cast<int32_t*>(sync),
      static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

const char* huffdecode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
