// Huffman bit-pack (kernel K7) for Hopper, sm_90a: canonical codes of many
// chunks, each under its own table, packed MSB first into 32-bit words.
//
// Replaces the TPU kernel bitpack_encode_chunks_multi in
// src/repro/kernels/bitpack.py.  That kernel binary-searches the producing
// symbol for every output bit and reduces 32 bits to a word with weighted
// sums: O(8n log n) gathers, a shape chosen for the TPU's vector unit.
// Here a symbol writes its own code instead.
//
// What bounds it on the H100: operations, and how many SMs get them.  Per
// symbol a byte load, a table lookup, a shift and an OR; the bytes moved
// (one symbol in, at most two bytes out) are small.  A chunk is one serial
// bitstream of 131,072 symbols on the main path, and a 3072x768 leaf has
// only 18 of them: one block per chunk leaves 114 of 132 SMs idle.  So each
// chunk is cut into segments of SEG symbols, one block each, and a
// segment's first bit comes from a single-pass decoupled look-back:
//
//   A block takes the next segment in the order blocks start (a ticket
//   from a global counter), so it only ever waits on segments whose blocks
//   are already running.  It stages its chunk's (code, length) table row
//   in shared memory, checks it (lengths 0..15, a plane id that names a
//   row; a bad chunk gets nbits = -1), and sums its segment's code lengths
//   with a block-wide exclusive scan (warp shuffles, then the warp totals),
//   which also places each thread's run of SPT symbols.  It publishes that
//   sum in its status word, then one warp reads the status words of the
//   segments before it, 32 at a time, adding their sums back to the nearest
//   one that holds its chunk's running total, and publishes its own running
//   total.  The first segment of a chunk publishes at once, so no walk
//   passes it, and a walk takes one or two rounds of reads on the main path
//   (16 segments a chunk).
//   Each thread then joins its codes (at most 15 bits each) in a 64-bit
//   register and writes whole words into a shared-memory window of the
//   segment: a plain store for a word only it touches, a shared atomicOr
//   for the first and last word of its run, which it may share with its
//   neighbours.  The window goes to device memory once, in order: plain
//   stores for the inner words, a global atomicOr for the first and last
//   word, which the segment may share with the segments beside it (the
//   caller zeroed the words).  The last segment writes the chunk's bit
//   count.
//
// Bit j of a chunk lands in bit 31 - (j & 31) of word j >> 5, so the
// big-endian bytes of the words are the np.packbits stream of the host
// encoder.  Words past the chunk's raw-size capacity (chunk_syms / 4) are
// never stored (such a chunk is stored raw by the host), but the bit count
// still counts every code, pad symbols of a partial final chunk included,
// as the reference counts them.  Words the codes do not reach keep the
// zeros the caller allocated.  Nothing is read back to the host: the table
// check lives here.  A look-back that finds no predecessor after
// SPIN_LIMIT polls (which cannot happen while every block publishes its sum
// before it waits) gives nbits = -2 instead of hanging.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPT = 32;                            // symbols a thread
constexpr int SEG = THREADS * SPT;                 // a block's segment (SEGMENT_SYMS)
constexpr int MAXL = 15;
constexpr int WIN = (SEG * MAXL + 31) / 32 + 2;    // words a segment can touch
// the largest chunk whose bit count fits an int32 at MAXL bits a symbol
constexpr long long MAX_CHUNK_SYMS = 0x7FFFFFFFLL / MAXL / 4 * 4;
static_assert(THREADS == 256, "a block stages one table entry a thread");

// The thread's SPT symbols of a segment, as 8 words (4 symbols each); the
// words past `valid` symbols (a multiple of 4) read as zero.
__device__ __forceinline__ void load_syms(const uint8_t* p, int valid, uint32_t w[SPT / 4]) {
  if (valid == SPT && !(reinterpret_cast<uintptr_t>(p) & 15)) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < SPT / 4; ++k) {
      w[k] = 4 * k < valid ? reinterpret_cast<const uint32_t*>(p)[k] : 0u;
    }
  }
}

// A segment's published state in its status word: the bit count of the
// segment alone (AGGREGATE) or of its chunk up to and including it
// (INCLUSIVE), shifted past the flag.
constexpr unsigned long long AGGREGATE = 1, INCLUSIVE = 2;
// Polls of a predecessor's status before a block gives up (a safety net:
// every predecessor publishes its aggregate without waiting on anything).
constexpr int SPIN_LIMIT = 1 << 24;

__global__ void __launch_bounds__(THREADS)
bitpack_kernel(const uint8_t* __restrict__ syms,
               const int* __restrict__ plane_ids,
               const int* __restrict__ len_tables,
               const int* __restrict__ code_tables, int n_tables,
               unsigned long long* __restrict__ status,
               uint32_t* __restrict__ words, int* __restrict__ nbits,
               int chunk_syms, int n_seg, int n_blocks) {
  __shared__ uint32_t s_code[256];            // (code << 4) | length
  __shared__ uint32_t win[WIN];
  __shared__ int s_warp[WARPS];
  __shared__ int s_seg;
  __shared__ int s_start;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Segments in the order blocks start: a block waits only on segments
  // that started before it, so the look-back below cannot deadlock.
  if (tid == 0) s_seg = static_cast<int>(atomicAdd(&status[n_blocks], 1ull));
  __syncthreads();
  const int g = s_seg;
  const int c = g / n_seg, s = g % n_seg;
  const int pid = plane_ids[c];
  int ok = pid >= 0 && pid < n_tables;
  if (ok) {                                   // THREADS == 256: one entry each
    const int len = len_tables[pid * 256 + tid];
    ok = len >= 0 && len <= MAXL;
    const uint32_t code =
        static_cast<uint32_t>(code_tables[pid * 256 + tid]) & ((1u << (len & 31)) - 1u);
    s_code[tid] = (code << 4) | static_cast<uint32_t>(len & 15);
  }
  const int seg_len = min(SEG, chunk_syms - s * SEG);
  const int valid = max(0, min(SPT, seg_len - tid * SPT));
  uint32_t w[SPT / 4];
  load_syms(syms + static_cast<int64_t>(c) * chunk_syms + s * SEG + tid * SPT, valid, w);
  if (!__syncthreads_and(ok)) {               // no such row, or a bad length
    if (s == 0 && tid == 0) nbits[c] = -1;
    return;
  }

  int bits = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    if (k < valid) bits += s_code[(w[k >> 2] >> (8 * (k & 3))) & 0xFFu] & 15u;
  }
  // Block-wide exclusive scan of the threads' bit counts.
  int incl = bits;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int own = 0, before = incl - bits;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    own += s_warp[k];
    if (k < warp) before += s_warp[k];
  }

  // The segment's first bit (warp 0): publish this segment's count, then
  // read the status words of up to 32 earlier segments of the chunk at a
  // time, nearest first, until one holds the chunk's running total; the
  // counts from here back to it add up to the bits before this segment.
  if (warp == 0) {
    int prefix = 0;
    bool stalled = false;
    if (s > 0) {
      if (lane == 0) {
        atomicExch(&status[g], (static_cast<unsigned long long>(own) << 2) | AGGREGATE);
      }
      const int first = g - s;                // the chunk's first segment
      for (int hi = g - 1;; hi -= 32) {
        const int j = hi - lane;
        unsigned long long v = 0;
        if (j >= first) {
          for (int spin = 0; !v && spin < SPIN_LIMIT; ++spin) v = atomicAdd(&status[j], 0ull);
        }
        if (__any_sync(0xffffffffu, j >= first && !v)) {
          stalled = true;                     // gave up: flagged below
          break;
        }
        const unsigned inclusive = __ballot_sync(0xffffffffu, (v & INCLUSIVE) != 0);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        prefix += __reduce_add_sync(0xffffffffu, lane <= stop ? static_cast<int>(v >> 2) : 0);
        if (inclusive) break;
      }
    }
    if (lane == 0) {
      if (!stalled) {
        atomicExch(&status[g], (static_cast<unsigned long long>(prefix + own) << 2) | INCLUSIVE);
      }
      s_start = stalled ? -1 : prefix;
    }
  }
  __syncthreads();
  if (s_start < 0) {
    if (tid == 0) nbits[c] = -2;
    return;
  }

  const int start = s_start;
  const int cap_words = chunk_syms / 4;
  const int lead = start & 31;                // bits of window word 0 before the segment
  const int n_win = (lead + own + 31) >> 5;
  if (tid == 0 && s == n_seg - 1) nbits[c] = start + own;
  if ((start >> 5) >= cap_words) return;      // an expanded chunk: nothing lands here
  for (int k = tid; k < n_win; k += THREADS) win[k] = 0u;
  __syncthreads();

  if (bits) {
    const int first = lead + before;          // in window bits
    int wi = first >> 5;
    const bool shared_first = (first & 31) != 0;
    uint64_t acc = 0;                         // pending bits, low-aligned
    int n_acc = first & 31;                   // zeros for the word's earlier bits
    bool at_first = true;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (k < valid) {
        const uint32_t e = s_code[(w[k >> 2] >> (8 * (k & 3))) & 0xFFu];
        const int len = static_cast<int>(e & 15u);
        acc = (acc << len) | (e >> 4);
        n_acc += len;
        if (n_acc >= 32) {
          n_acc -= 32;
          const uint32_t word = static_cast<uint32_t>(acc >> n_acc);
          if (at_first && shared_first) atomicOr(&win[wi], word);
          else win[wi] = word;
          at_first = false;
          ++wi;
        }
      }
    }
    if (n_acc) atomicOr(&win[wi], static_cast<uint32_t>(acc << (32 - n_acc)));
  }
  __syncthreads();

  // The window to device memory: the first and last word may be shared with
  // the segments beside this one.
  uint32_t* dst = words + static_cast<int64_t>(c) * cap_words + (start >> 5);
  const int room = cap_words - (start >> 5);
  const int end = lead + own;
  for (int k = tid; k < n_win && k < room; k += THREADS) {
    if ((k == 0 && lead) || (k == n_win - 1 && (end & 31))) atomicOr(&dst[k], win[k]);
    else dst[k] = win[k];
  }
}

}  // namespace

extern "C" {

// syms: u8[n_chunks * chunk_syms]; plane_ids: int32[n_chunks]; len_tables,
// code_tables: int32[n_tables][256]; status: u64[n_chunks * ceil(chunk_syms
// / SEG) + 1], zeroed; words: u32[n_chunks][chunk_syms / 4], zeroed; nbits:
// int32[n_chunks].  chunk_syms must be a positive multiple of 4 and syms
// 4-byte aligned.  A chunk whose plane id names no
// row, or whose row has a length outside 0..15, gets nbits = -1.
int bitpack_launch(const void* syms, const void* plane_ids,
                   const void* len_tables, const void* code_tables,
                   int n_tables, void* status, void* words, void* nbits,
                   int n_chunks, int chunk_syms, void* stream) {
  if (n_chunks > 0) {
    if (chunk_syms <= 0 || chunk_syms % 4 || chunk_syms > MAX_CHUNK_SYMS)
      return static_cast<int>(cudaErrorInvalidValue);
    const int n_seg = (chunk_syms + SEG - 1) / SEG;
    const long long blocks = static_cast<long long>(n_chunks) * n_seg;
    if (blocks >= 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bitpack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        static_cast<const uint8_t*>(syms), static_cast<const int*>(plane_ids),
        static_cast<const int*>(len_tables), static_cast<const int*>(code_tables), n_tables,
        static_cast<unsigned long long*>(status), static_cast<uint32_t*>(words),
        static_cast<int*>(nbits), chunk_syms, n_seg, static_cast<int>(blocks));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bitpack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
