// Plane consumer (kernel K2) for Hopper, sm_90a: un-byte-group, inverse
// rotate-left-1 and the optional XOR with a base, in one pass.  Without a
// base it is also the byte ungrouping (kernel K11).
//
// Replaces the TPU kernel plane_consumer in
// src/repro/kernels/fused_unplane.py (bodies _bf16_unplane_kernel,
// _bf16_unplane_delta_kernel, _fp32_unplane_kernel,
// _fp32_unplane_delta_kernel), and ungroup_bf16_2d, ungroup_fp32_2d in
// src/repro/kernels/bytegroup.py.  Plane 0 is the most significant byte
// (the exponent after the encoder's rotate-left-1); the joined value is
// rotated right by one bit and, for a delta stream, XORed with base.
//
// What bounds it on the H100: bytes.  Each element reads itemsize plane
// bytes (plus itemsize base bytes) and writes itemsize bytes, with a
// handful of integer operations, far below the ~295 operations per byte
// where the ALUs would be the limit.
//
// The first design (a grid-stride loop, 16 elements a thread from 16-byte
// loads of each plane) read 49% of the bytes bound at fp32 and 63% at
// bf16 on large leaves (an H100, kernels/encode_compare.py).  Three things
// held it, and this design answers each:
//  1. Strided stores.  A thread stored its 16 elements as two (bf16) or
//     four (fp32) 16-byte words, so one warp store touched 32 or 16 bytes
//     of every 128-byte line.  Here the output tile is built in shared
//     memory and leaves with one bulk copy (cp.async.bulk ... bulk_group)
//     of whole lines; the planes and the base arrive the same way.
//  2. Few bytes in flight.  A thread loaded a group, waited, computed and
//     stored, so the bytes in flight were whatever the occupancy gave.
//     Here a persistent block keeps STAGES tiles of planes (and base) in
//     flight in a ring of shared-memory stages, fed by one thread's bulk
//     copies (cp.async.bulk ... mbarrier::complete_tx::bytes), which spend
//     no registers; the consumers wait on each stage's mbarrier by phase.
//  3. A join of four shift-and-mask pairs an element at fp32.  Here six
//     __byte_perm make four fp32 elements, and two make four bf16 ones.
// Inside a stage each thread reads consecutive 8-byte (bf16) or 4-byte
// (fp32) words of each plane and writes consecutive 16-byte words of the
// output tile, so a warp's shared-memory accesses meet no bank conflict.
// A stage's output is read by its bulk store while the next tile is
// computed; before a stage's output buffer is written again, the issuing
// thread waits for that store's reads (cp.async.bulk.wait_group.read).
//
// Whole tiles of `tile` elements take that pipeline.  The host chooses the
// tile (fused_unplane._unplane_plan): at most TILE_IN_BYTES of planes and
// base, in whole waves of tiles over the SMs, down to 1,024 elements for a
// small leaf.  The ragged remainder takes 16 elements a thread from
// 16-byte loads and then one element a thread, in the same launch, while
// the first tiles' copies are in flight.  A bf16 call too small to fill
// the pipeline (under 24 tiles of 1,024 elements an SM) takes no tiles:
// it is all groups of 16 (the vector path, whose loads take the read-only
// path as the first design's did).  A call in which any plane,
// the base or the output is not 16-byte aligned (bulk copies need it)
// goes element by element.  Offsets are 64-bit: a leaf may pass 2^32
// bytes.  Four variants: 2 or 4 planes, with or without base.  The
// kernel's dynamic shared-memory limit is raised once for each variant
// and device, to the stages of the largest tile, and never lowered: host
// threads launch at once with tiles of different sizes.
//
// THREADS, STAGES and BLOCKS_PER_SM come from kernels/unplane_launch_sweep.py
// on an H100: two stages of at most 32 KiB in and 32 KiB out read 88-92% of
// the bytes bound from 0.68 to 16 GB of traffic, within 0.5% of three or
// four stages; small leaves, which no pipeline fills, are fastest with
// many small blocks (up to eight an SM at 1,024-element tiles).
//
// Registers and shared memory (cuobjdump --dump-resource-usage, sm_90a),
// fp32, fp32 + base, bf16, bf16 + base: the first design 32, 36, 32, 34
// registers and no shared memory; this design 32, 42, 25, 31 registers,
// 1 KB of static shared memory, and STAGES x (itemsize x tile x (2, or 3
// with a base) + 8) bytes of dynamic shared memory a block (131,088 at
// the largest tile without a base, 98,320 with one).

#include <cstdint>
#include <map>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 2;                       // tiles in flight a block
constexpr int BLOCKS_PER_SM = 8;                // persistent blocks an SM, at most
constexpr int TILE_IN_BYTES = 32 << 10;         // a tile's planes and base, at most
constexpr int MAX_DEVICES = 64;
constexpr int64_t MAX_BLOCKS = 132 * 32;        // grid-stride beyond ~32 blocks/SM
constexpr int GROUP = 16;                       // elements per vector group
static_assert(STAGES >= 2, "a stage's output is stored while the next is computed");

struct Args {
  const uint8_t* p[4];        // planes, plane 0 most significant; unused ones null
  const void* base;           // u16/u32[n] or null
  void* out;                  // u16/u32[n]
  int64_t n;
  int64_t tiles;              // whole tiles through the bulk pipeline
  uint32_t tile;              // elements a tile, a multiple of 16
  int vec;                    // every pointer 16-byte aligned
};

// The largest tile: TILE_IN_BYTES of planes and base (fused_unplane.py
// plans no larger one).
constexpr uint32_t max_tile(int itemsize, bool has_base) {
  return TILE_IN_BYTES / (itemsize * (has_base ? 2 : 1)) / 16 * 16;
}

// Rotate both u16 halves of a word right by one bit.
__device__ __forceinline__ uint32_t rotr16x2(uint32_t w) {
  return ((w >> 1) & 0x7FFF7FFFu) | ((w << 15) & 0x80008000u);
}

__device__ __forceinline__ uint32_t rotr32(uint32_t w) { return __funnelshift_r(w, w, 1); }

// Elements k = 0..3 of a word of the exponent plane (e) and of the low
// plane (f), byte k of each: elements 0, 1 in lo and 2, 3 in hi.
__device__ __forceinline__ void join2(uint32_t e, uint32_t f, uint32_t& lo, uint32_t& hi) {
  lo = rotr16x2(__byte_perm(f, e, 0x5140));
  hi = rotr16x2(__byte_perm(f, e, 0x7362));
}

// Elements k = 0..3 of a word of each of four planes (plane 0 in a).
__device__ __forceinline__ uint4 join4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t x01 = __byte_perm(b, a, 0x5140), x23 = __byte_perm(d, c, 0x5140);
  const uint32_t y01 = __byte_perm(b, a, 0x7362), y23 = __byte_perm(d, c, 0x7362);
  return make_uint4(rotr32(__byte_perm(x23, x01, 0x5410)), rotr32(__byte_perm(x23, x01, 0x7632)),
                    rotr32(__byte_perm(y23, y01, 0x5410)), rotr32(__byte_perm(y23, y01, 0x7632)));
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// --- shared-memory barriers and bulk copies (PTX) -------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared, completing `bytes` transactions on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared -> global, in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// --- the work -------------------------------------------------------------

// Tile of `tile` elements in a stage: planes (itemsize x tile bytes), then
// the base (tile x itemsize bytes), in `in`; the output tile in `ob`.
template <int ITEMSIZE, bool HAS_BASE>
__device__ __forceinline__ void consume_tile(const uint8_t* in, uint8_t* ob, uint32_t tile) {
  const uint4* b4 = reinterpret_cast<const uint4*>(in + ITEMSIZE * tile);
  uint4* o4 = reinterpret_cast<uint4*>(ob);
  if constexpr (ITEMSIZE == 2) {
    const uint2* e2 = reinterpret_cast<const uint2*>(in);
    const uint2* f2 = reinterpret_cast<const uint2*>(in + tile);
#pragma unroll 4
    for (uint32_t u = threadIdx.x; u < tile / 8; u += THREADS) {   // 8 elements a step
      const uint2 e = e2[u], f = f2[u];
      uint4 v;
      join2(e.x, f.x, v.x, v.y);
      join2(e.y, f.y, v.z, v.w);
      if constexpr (HAS_BASE) v = xor4(v, b4[u]);
      o4[u] = v;
    }
  } else {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(in);
    const uint32_t w = tile / 4;                                     // words a plane
#pragma unroll 4
    for (uint32_t u = threadIdx.x; u < w; u += THREADS) {            // 4 elements a step
      uint4 v = join4(q[u], q[w + u], q[2 * w + u], q[3 * w + u]);
      if constexpr (HAS_BASE) v = xor4(v, b4[u]);
      o4[u] = v;
    }
  }
}

// Group g of 16 elements from 16-byte loads of global memory, through the
// read-only path (__ldg: no input aliases the output).
template <int ITEMSIZE, bool HAS_BASE>
__device__ __forceinline__ void consume_group(const Args& a, int64_t g) {
  const uint4* b4 = static_cast<const uint4*>(a.base);
  uint4* o4 = static_cast<uint4*>(a.out);
  if constexpr (ITEMSIZE == 2) {
    const uint4 e = __ldg(reinterpret_cast<const uint4*>(a.p[0]) + g);
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(a.p[1]) + g);
    uint4 lo, hi;
    join2(e.x, f.x, lo.x, lo.y);
    join2(e.y, f.y, lo.z, lo.w);
    join2(e.z, f.z, hi.x, hi.y);
    join2(e.w, f.w, hi.z, hi.w);
    if constexpr (HAS_BASE) {
      lo = xor4(lo, __ldg(b4 + 2 * g));
      hi = xor4(hi, __ldg(b4 + 2 * g + 1));
    }
    o4[2 * g] = lo;
    o4[2 * g + 1] = hi;
  } else {
    uint4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(reinterpret_cast<const uint4*>(a.p[k]) + g);
    uint4 v[4] = {join4(q[0].x, q[1].x, q[2].x, q[3].x), join4(q[0].y, q[1].y, q[2].y, q[3].y),
                  join4(q[0].z, q[1].z, q[2].z, q[3].z), join4(q[0].w, q[1].w, q[2].w, q[3].w)};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if constexpr (HAS_BASE) v[m] = xor4(v[m], __ldg(b4 + 4 * g + m));
      o4[4 * g + m] = v[m];
    }
  }
}

template <int ITEMSIZE, bool HAS_BASE>
__device__ __forceinline__ void consume_element(const Args& a, int64_t i) {
  if constexpr (ITEMSIZE == 2) {
    const uint32_t rot = (static_cast<uint32_t>(__ldg(a.p[0] + i)) << 8) | __ldg(a.p[1] + i);
    uint16_t x = static_cast<uint16_t>((rot >> 1) | ((rot & 1u) << 15));
    if constexpr (HAS_BASE) x ^= __ldg(static_cast<const uint16_t*>(a.base) + i);
    static_cast<uint16_t*>(a.out)[i] = x;
  } else {
    const uint32_t rot = (static_cast<uint32_t>(__ldg(a.p[0] + i)) << 24) |
                         (static_cast<uint32_t>(__ldg(a.p[1] + i)) << 16) |
                         (static_cast<uint32_t>(__ldg(a.p[2] + i)) << 8) | __ldg(a.p[3] + i);
    uint32_t x = rotr32(rot);
    if constexpr (HAS_BASE) x ^= __ldg(static_cast<const uint32_t*>(a.base) + i);
    static_cast<uint32_t*>(a.out)[i] = x;
  }
}

template <int ITEMSIZE, bool HAS_BASE>
__global__ void __launch_bounds__(THREADS) unplane_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t tile = a.tile;
  const uint32_t out_bytes = ITEMSIZE * tile;
  const uint32_t in_bytes = out_bytes * (HAS_BASE ? 2u : 1u);
  const uint32_t stage_bytes = in_bytes + out_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * stage_bytes);
  const int64_t grid = gridDim.x;
  const int64_t mine = a.tiles > blockIdx.x ? (a.tiles - 1 - blockIdx.x) / grid + 1 : 0;
  const bool lead = threadIdx.x == 0;

  // Tile k of this block (tile blockIdx.x + k * grid) into stage k % STAGES.
  auto load = [&](int64_t k) {
    const int s = static_cast<int>(k % STAGES);
    uint8_t* st = smem + s * stage_bytes;
    const int64_t t = blockIdx.x + k * grid;
    mbar_expect_tx(full + s, in_bytes);
#pragma unroll
    for (int q = 0; q < ITEMSIZE; ++q) bulk_load(st + q * tile, a.p[q] + t * tile, tile, full + s);
    if constexpr (HAS_BASE)
      bulk_load(st + out_bytes, static_cast<const uint8_t*>(a.base) + t * out_bytes, out_bytes,
                full + s);
  };
  if (mine > 0) {
    if (lead) {
      for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int64_t k = 0; k < STAGES && k < mine; ++k) load(k);
    }
    __syncthreads();                  // no thread waits on a barrier before its init
  }

  // The ragged remainder (or, misaligned, every element) while they fly.
  const int64_t stride = grid * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  int64_t done = a.tiles * tile;
  if (a.vec) {
    const int64_t ng = a.n / GROUP;
    for (int64_t g = done / GROUP + tid; g < ng; g += stride)
      consume_group<ITEMSIZE, HAS_BASE>(a, g);
    done = ng * GROUP;
  }
  for (int64_t i = done + tid; i < a.n; i += stride) consume_element<ITEMSIZE, HAS_BASE>(a, i);

  for (int64_t k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % STAGES);
    uint8_t* st = smem + s * stage_bytes;
    mbar_wait(full + s, static_cast<uint32_t>((k / STAGES) & 1));
    consume_tile<ITEMSIZE, HAS_BASE>(st, st + in_bytes, tile);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // writes -> bulk store
    // The next tile's output buffer was last stored STAGES tiles before it:
    // at most STAGES - 2 younger stores may still read theirs.
    if (lead) bulk_wait_read<STAGES - 2>();
    __syncthreads();
    if (lead) {
      const int64_t t = blockIdx.x + k * grid;
      bulk_store(static_cast<uint8_t*>(a.out) + t * out_bytes, st + in_bytes, out_bytes);
      if (k + STAGES < mine) load(k + STAGES);   // every thread is done with its input
    }
  }
  // Shared memory must outlive the stores' reads; their writes complete
  // before the kernel does.
  if (lead && mine > 0) bulk_wait_read<0>();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Dynamic shared memory of a launch with tiles: STAGES stages of input
// (planes, and base) and output tile, and a barrier each.
size_t smem_bytes(int itemsize, bool has_base, uint32_t tile) {
  return static_cast<size_t>(STAGES) *
         (static_cast<size_t>(itemsize) * tile * (has_base ? 3 : 2) + sizeof(uint64_t));
}

// What a launch with tiles needs of the card, found once for each variant
// and device.  The kernel's dynamic shared memory limit is shared by every
// host thread (the file engine decodes frames on several at once), so it
// is raised once to the largest stage and never lowered; the occupancy is
// cached for each shared-memory size a plan asks for.
struct Setup {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  int sms = 0;
  std::mutex mu;
  std::map<size_t, int> per_sm;
};

template <int ITEMSIZE, bool HAS_BASE>
cudaError_t blocks_for(int64_t tiles, size_t smem, int64_t& blocks) {
  auto kernel = unplane_kernel<ITEMSIZE, HAS_BASE>;
  static Setup setups[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Setup& s = setups[dev];
  std::call_once(s.once, [&] {
    s.err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(ITEMSIZE, HAS_BASE, max_tile(ITEMSIZE, HAS_BASE))));
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  });
  if (s.err != cudaSuccess) return s.err;
  int per_sm;
  {
    std::lock_guard<std::mutex> hold(s.mu);
    auto it = s.per_sm.find(smem);
    if (it == s.per_sm.end()) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
      if (err != cudaSuccess) return err;
      it = s.per_sm.emplace(smem, per_sm).first;
    }
    per_sm = it->second;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > BLOCKS_PER_SM) per_sm = BLOCKS_PER_SM;
  blocks = static_cast<int64_t>(per_sm) * s.sms;
  if (blocks > tiles) blocks = tiles;
  return cudaSuccess;
}

template <int ITEMSIZE, bool HAS_BASE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  int64_t blocks;
  size_t smem = 0;
  if (a.tiles > 0) {
    // A tile past the largest would ask for more shared memory than the
    // kernel is set for: refused here, and raised.
    if (a.tile > max_tile(ITEMSIZE, HAS_BASE)) return cudaErrorInvalidValue;
    smem = smem_bytes(ITEMSIZE, HAS_BASE, a.tile);
    cudaError_t err = blocks_for<ITEMSIZE, HAS_BASE>(a.tiles, smem, blocks);
    if (err != cudaSuccess) return err;
  } else {
    const int64_t work = a.vec ? a.n / GROUP + GROUP : a.n;
    blocks = (work + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  }
  unplane_kernel<ITEMSIZE, HAS_BASE><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// itemsize 2: p0, p1 -> u16[n]; itemsize 4: p0..p3 -> u32[n].  base is a
// u16/u32[n] or null; unused plane pointers may be null.  The first
// tiles * tile elements take the bulk pipeline (tile a multiple of 16, at
// most the largest tile; every pointer 16-byte aligned).  The rest goes
// by 16-element groups when every pointer is 16-byte aligned, and then
// element by element.
int unplane_launch(const void* p0, const void* p1, const void* p2, const void* p3,
                   const void* base, void* out, long long n, int itemsize, long long tiles,
                   int tile, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = aligned16(p0) && aligned16(p1) && aligned16(out) &&
                       (itemsize == 2 || (aligned16(p2) && aligned16(p3))) &&
                       (!base || aligned16(base));
  Args a{{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
          static_cast<const uint8_t*>(p2), static_cast<const uint8_t*>(p3)},
         base, out, n, tiles, static_cast<uint32_t>(tile), aligned};
  if ((itemsize != 2 && itemsize != 4) || tiles < 0 ||
      (tiles > 0 && (!aligned || tile <= 0 || tile % GROUP || tiles > n / tile)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (itemsize == 2)
    err = base ? launch<2, true>(a, s) : launch<2, false>(a, s);
  else
    err = base ? launch<4, true>(a, s) : launch<4, false>(a, s);
  if (err != cudaSuccess) cudaGetLastError();     // clear it: the caller raises this one
  return static_cast<int>(err);
}

// The dynamic shared memory a block of a launch with tiles of `tile`
// elements asks for, in bytes.
long long unplane_smem_bytes(int itemsize, int has_base, int tile) {
  return static_cast<long long>(smem_bytes(itemsize, has_base, static_cast<uint32_t>(tile)));
}

const char* unplane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
