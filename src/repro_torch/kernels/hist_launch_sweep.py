"""Time designs of the byte histograms K9 and K6 (``csrc/histogram.cu``) on
one CUDA card, to find what bounds them.

    PYTHONPATH=src python3 -m repro_torch.kernels.hist_launch_sweep \
        [--baseline other_histogram.cu] [--only "warp atomics|this tree"] [--rounds 2]

from the checkout's root.  Planes, each 2,359,296 bytes (a 3072x768 leaf):
the leaf's exponent plane as the ops path makes it, uniform random bytes,
and one byte value everywhere; each as K9 (one chunk) and as K6 (131,072-
byte chunks).  Every design but the baselines is one instance of the
template kernel in ``SWEEP_CU`` (kept only here), on a grid of one wave
whose blocks each count a contiguous part of one chunk with 16-byte loads:

* counting: ``load only`` (the load floor: loads, no counts), ``warp
  atomics`` (a shared atomic a byte into a histogram per warp), ``block
  atomics`` (one histogram a block), and counters in registers for a
  window of bins with shared atomics only outside it: ``window 8x4`` (8
  bins in 4-bit fields of one 32-bit register, a window check for 8 bytes
  at once, spilled every 15 / vectors batches), ``window 16x8`` and
  ``window 16x16`` (16 bins in 8- or 16-bit fields of 64-bit registers, a
  shift and an add a byte, flushed by a warp reduction just before a field
  could pass 255 or 65,535);
* merge into the int32 output: ``zeroed`` (global atomics into counts
  zeroed by a launch before each call, the zeroing in the events),
  ``ticket`` (global atomics into a state kept at zero; the last block of
  a chunk moves its row out and resets it), ``grid sync`` (a cooperative
  launch: the grid zeroes the counts, then one grid-wide barrier before
  its global atomics);
* shape ``T<threads>V<vectors in flight>S<vectors a thread a part, at
  least>``.

Beside them: ``this tree's chunk_histogram`` (the package's wrapper as the
ops call it) and each ``--baseline``, another ``histogram.cu`` with the C
interface (x, counts, n, chunk_elems, stream), its counts zeroed by a
launch before each call, as a kernel that only adds needs.
Every design but the load floor is checked against ``chunk_histogram_plain``,
then timed in rounds, designs interleaved, by ``chip_smoke.py``'s
``profiled_ms`` (the kernel's device time alone, L2 evicted before each
launch) and ``device_ms`` (CUDA events around the call, zeroing included).
Prints one line per (plane, chunking, design), fastest first, with every
round's reading in microseconds.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

# <checkout>/src/repro_torch/kernels/hist_launch_sweep.py: chip_smoke.py is at the root
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 3))

# Every design, as one kernel template: counting x merge x launch shape.
SWEEP_CU = r"""
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
enum { NONE = 0, WARP_ATOMICS = 1, BLOCK_ATOMICS = 2, WINDOW = 3,        // counting
       WINDOW16X8 = 4, WINDOW16X16 = 5 };
enum { ZEROED = 0, TICKET = 1, GRID_SYNC = 3 };                           // merge

struct Args {
  const uint8_t* x;
  int* out;        // ZEROED, GRID_SYNC: the counts (ZEROED: zero before the launch)
  int* acc;        // TICKET: rows then a ticket a chunk, zero at rest
  int64_t n, chunk, part_len, parts, units;
};

// Register window counters: eight 4-bit counters of bins [base, base + 8)
// in one register, spilled every 8 bytes into two registers of 8-bit
// counters; bytes outside the window take a shared atomic.
__device__ __forceinline__ uint32_t nibble(uint32_t b, uint32_t nb4) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(1u), "r"(b * 4u + nb4));
  return r;
}
__device__ __forceinline__ uint32_t word_nibbles(uint32_t w, uint32_t nb4) {
  return nibble(w & 0xFFu, nb4) + nibble((w >> 8) & 0xFFu, nb4) +
         nibble((w >> 16) & 0xFFu, nb4) + nibble(w >> 24, nb4);
}
__device__ __forceinline__ void count8(uint32_t a, uint32_t b, uint32_t base, uint32_t nb4,
                                       uint32_t& w0, uint32_t& w1, int* sh) {
  const uint32_t t = word_nibbles(a, nb4) + word_nibbles(b, nb4);
  w0 += t & 0x0F0F0F0Fu;
  w1 += (t >> 4) & 0x0F0F0F0Fu;
  if ((t * 0x11111111u) >> 28 != 8u) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t y = ((k < 4 ? a : b) >> (8 * (k & 3))) & 0xFFu;
      if (y - base >= 8u) atomicAdd(&sh[y], 1);
    }
  }
}
__device__ __forceinline__ void flush(uint32_t& w0, uint32_t& w1, uint32_t base, int lane,
                                      int* sh) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t mine = ((k & 1 ? w1 : w0) >> (8 * (k >> 1))) & 0xFFu;
    const uint32_t total = __reduce_add_sync(FULL, mine);
    if (lane == k && total) atomicAdd(&sh[base + k], static_cast<int>(total));
  }
  w0 = w1 = 0u;
}

// Register windows of 16 bins: counters of the bins [base, base + 16)
// in FIELD-bit fields (8 or 16) of 64-bit registers, one a bin, added to by
// a shift and an add; bytes outside the window take a shared atomic.  A
// warp's lanes share the base (the warp's largest byte of its first
// vectors, less 15) and add their fields into the shared histogram by a
// warp reduction before a field can overflow, and at the end.
template <int FIELD>
struct Window16 {
  static constexpr int PER = 64 / FIELD;         // fields a register
  static constexpr int REGS = 16 / PER;
  uint64_t r[REGS];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < REGS; ++k) r[k] = 0ull;
  }
  __device__ __forceinline__ void byte(uint32_t y, uint32_t base, int* sh) {
    const uint32_t d = y - base;
    if (d < 16u) {
      const uint64_t inc = 1ull << ((d % PER) * FIELD);
#pragma unroll
      for (int k = 0; k < REGS; ++k) r[k] += d / PER == static_cast<uint32_t>(k) ? inc : 0ull;
    } else {
      atomicAdd(&sh[y], 1);
    }
  }
  __device__ __forceinline__ void word(uint32_t w, uint32_t base, int* sh) {
    byte(w & 0xFFu, base, sh);
    byte((w >> 8) & 0xFFu, base, sh);
    byte((w >> 16) & 0xFFu, base, sh);
    byte(w >> 24, base, sh);
  }
  __device__ __forceinline__ void flush(uint32_t base, int lane, int* sh) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t mine = static_cast<uint32_t>(r[k / PER] >> ((k % PER) * FIELD)) &
                            ((1u << FIELD) - 1u);
      const uint32_t total = __reduce_add_sync(FULL, mine);
      if (lane == k && total && base + k < 256u) atomicAdd(&sh[base + k], static_cast<int>(total));
    }
    clear();
  }
};

__device__ __forceinline__ void count_word(int* h, uint32_t w) {
  atomicAdd(&h[w & 0xFFu], 1);
  atomicAdd(&h[(w >> 8) & 0xFFu], 1);
  atomicAdd(&h[(w >> 16) & 0xFFu], 1);
  atomicAdd(&h[w >> 24], 1);
}

template <int THREADS, int VECTORS, int COUNT>
__device__ __forceinline__ uint32_t count_range(const uint8_t* __restrict__ x, int64_t begin,
                                                int64_t end, int* mine) {
  const int t = threadIdx.x, lane = t & 31;
  uint32_t sink = 0;
  int64_t head = static_cast<int64_t>((16u - (reinterpret_cast<uintptr_t>(x + begin) & 15u)) & 15u);
  if (head > end - begin) head = end - begin;
  const int64_t body = begin + head;
  const int64_t nv = (end - body) / 16;
  for (int64_t i = begin + t; i < body; i += THREADS) {
    if (COUNT == NONE) sink ^= x[i]; else atomicAdd(&mine[x[i]], 1);
  }
  for (int64_t i = body + nv * 16 + t; i < end; i += THREADS) {
    if (COUNT == NONE) sink ^= x[i]; else atomicAdd(&mine[x[i]], 1);
  }
  const uint4* v = reinterpret_cast<const uint4*>(x + body);
  const int64_t steps = (nv + THREADS - 1) / THREADS;
  const int64_t batches = (steps + VECTORS - 1) / VECTORS;
  constexpr int FLUSH = 15 / VECTORS;
  // batches a thread between flushes of the 16-bin windows: a field takes
  // at most one a byte, 16 * VECTORS bytes a batch
  constexpr int FLUSH16 = ((1 << (COUNT == WINDOW16X16 ? 16 : 8)) - 1) / (16 * VECTORS);
  uint32_t base = 0u, nb4 = 0u, w0 = 0u, w1 = 0u;
  Window16<COUNT == WINDOW16X16 ? 16 : 8> win;
  win.clear();
  for (int64_t bt = 0; bt < batches; ++bt) {
    uint4 q[VECTORS];
#pragma unroll
    for (int j = 0; j < VECTORS; ++j) {
      const int64_t k = (bt * VECTORS + j) * THREADS + t;
      q[j] = k < nv ? v[k] : make_uint4(0u, 0u, 0u, 0u);
    }
    if (COUNT == WINDOW && bt == 0) {
      const uint32_t m4 = __vmaxu4(__vmaxu4(q[0].x, q[0].y), __vmaxu4(q[0].z, q[0].w));
      const uint32_t m2 = __vmaxu4(m4, m4 >> 16);
      const uint32_t top = __shfl_sync(FULL, max(m2 & 0xFFu, (m2 >> 8) & 0xFFu), 0);
      base = top > 7u ? top - 7u : 0u;
      nb4 = 0u - 4u * base;
    }
    if ((COUNT == WINDOW16X8 || COUNT == WINDOW16X16) && bt == 0) {
      uint32_t m = 0u;
#pragma unroll
      for (int j = 0; j < VECTORS; ++j) {
        m = __vmaxu4(m, __vmaxu4(__vmaxu4(q[j].x, q[j].y), __vmaxu4(q[j].z, q[j].w)));
      }
      m = __vmaxu4(m, m >> 16);
      const uint32_t top = __reduce_max_sync(FULL, max(m & 0xFFu, (m >> 8) & 0xFFu));
      base = top > 15u ? top - 15u : 0u;
    }
#pragma unroll
    for (int j = 0; j < VECTORS; ++j) {
      if ((bt * VECTORS + j) * THREADS + t >= nv) continue;
      if (COUNT == NONE) {
        sink ^= q[j].x ^ q[j].y ^ q[j].z ^ q[j].w;
      } else if (COUNT == WINDOW) {
        count8(q[j].x, q[j].y, base, nb4, w0, w1, mine);
        count8(q[j].z, q[j].w, base, nb4, w0, w1, mine);
      } else if (COUNT == WINDOW16X8 || COUNT == WINDOW16X16) {
        win.word(q[j].x, base, mine);
        win.word(q[j].y, base, mine);
        win.word(q[j].z, base, mine);
        win.word(q[j].w, base, mine);
      } else {
        count_word(mine, q[j].x);
        count_word(mine, q[j].y);
        count_word(mine, q[j].z);
        count_word(mine, q[j].w);
      }
    }
    if (COUNT == WINDOW && ((bt + 1) % FLUSH == 0 || bt + 1 == batches)) {
      flush(w0, w1, base, lane, mine);
    }
    if ((COUNT == WINDOW16X8 || COUNT == WINDOW16X16) &&
        ((bt + 1) % FLUSH16 == 0 || bt + 1 == batches)) {
      win.flush(base, lane, mine);
    }
  }
  return sink;
}

template <int THREADS, int VECTORS, int COUNT, int MERGE>
__global__ void __launch_bounds__(THREADS) sweep_kernel(Args a) {
  constexpr int COPIES = COUNT == WARP_ATOMICS ? THREADS / 32 : 1;
  __shared__ int h[COPIES][256];
  __shared__ int role;
  const int t = threadIdx.x;
  for (int k = t; k < COPIES * 256; k += THREADS) (&h[0][0])[k] = 0;
  const int64_t n_chunks = (a.n + a.chunk - 1) / a.chunk;
  if (MERGE == GRID_SYNC) {                      // the grid zeroes the counts
    for (int64_t k = static_cast<int64_t>(blockIdx.x) * THREADS + t; k < n_chunks * 64;
         k += static_cast<int64_t>(gridDim.x) * THREADS) {
      reinterpret_cast<int4*>(a.out)[k] = make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  int* mine = h[COUNT == WARP_ATOMICS ? t >> 5 : 0];
  uint32_t sink = 0;
  for (int64_t u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int64_t c = u / a.parts;
    const int64_t chunk_end = (c + 1) * a.chunk < a.n ? (c + 1) * a.chunk : a.n;
    int64_t begin = c * a.chunk + (u % a.parts) * a.part_len;
    if (begin > chunk_end) begin = chunk_end;
    const int64_t end = begin + a.part_len < chunk_end ? begin + a.part_len : chunk_end;
    sink ^= count_range<THREADS, VECTORS, COUNT>(a.x, begin, end, mine);
    if constexpr (MERGE == GRID_SYNC) {
      if (u == blockIdx.x) cooperative_groups::this_grid().sync();
    }
    if (COUNT == NONE) continue;
    __syncthreads();
    int* row = (MERGE == TICKET ? a.acc : a.out) + c * 256;
    for (int bin = t; bin < 256; bin += THREADS) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < COPIES; ++w) {
        s += h[w][bin];
        h[w][bin] = 0;
      }
      if (s) atomicAdd(row + bin, s);
    }
    __syncthreads();
    if (MERGE == TICKET) {
      unsigned* tickets = reinterpret_cast<unsigned*>(a.acc + n_chunks * 256);
      if (t == 0) {
        __threadfence();
        role = atomicAdd(tickets + c, 1u) == static_cast<unsigned>(a.parts - 1);
      }
      __syncthreads();
      if (role) {
        __threadfence();
        for (int k = t; k < 256; k += THREADS) a.out[c * 256 + k] = atomicExch(row + k, 0);
        if (t == 0) atomicExch(tickets + c, 0u);
      }
      __syncthreads();
    }
  }
  if (COUNT == NONE && sink == 0x9E3779B9u) a.out[0] = static_cast<int>(sink);   // keeps the loads
}

template <int T, int V, int C, int M>
int go(Args a, int min_steps, long long* grid_out, cudaStream_t stream) {
  auto kernel = sweep_kernel<T, V, C, M>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t n_chunks = (a.n + a.chunk - 1) / a.chunk;
  const int64_t span = a.chunk < a.n ? a.chunk : a.n;
  const int64_t min_part = static_cast<int64_t>(16) * T * min_steps;
  int64_t parts = wave / n_chunks;
  const int64_t most = (span + min_part - 1) / min_part;
  if (parts > most) parts = most;
  if (parts < 1) parts = 1;
  a.part_len = ((span + parts - 1) / parts + 15) / 16 * 16;
  a.parts = (span + a.part_len - 1) / a.part_len;
  a.units = n_chunks * a.parts;
  const int64_t grid = a.units < wave ? a.units : wave;
  *grid_out = grid;
  cudaLaunchAttribute coop{};
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(T);
  cfg.stream = stream;
  cfg.attrs = &coop;
  cfg.numAttrs = M == GRID_SYNC ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DESIGNS(X)                                                            \
  X(128, 2, 0, 0) X(256, 1, 0, 0) X(256, 2, 0, 0) X(256, 4, 0, 0) X(512, 2, 0, 0) \
  X(1024, 1, 0, 0) X(1024, 4, 0, 0)                                            \
  X(128, 2, 1, 0) X(256, 1, 1, 0) X(256, 2, 1, 0) X(256, 4, 1, 0) X(512, 2, 1, 0) \
  X(1024, 1, 1, 0) X(1024, 4, 1, 0)                                            \
  X(256, 4, 2, 0) X(512, 2, 2, 0) X(1024, 1, 2, 0)                             \
  X(128, 2, 3, 0) X(256, 2, 3, 0) X(256, 2, 3, 1)                              \
  X(256, 2, 4, 0) X(256, 4, 4, 0) X(256, 2, 5, 0) X(256, 4, 5, 0)             \
  X(256, 4, 1, 1) X(512, 2, 1, 1) X(256, 4, 1, 3) X(512, 2, 1, 3)             \
  X(256, 4, 2, 1) X(256, 4, 2, 3) X(256, 4, 0, 3)

extern "C" int sweep_launch(int threads, int vectors, int count, int merge, const void* x,
                            void* out, void* state, long long n, long long chunk_elems,
                            int min_steps, long long* grid, void* stream) {
  if (n <= 0 || chunk_elems <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(x), static_cast<int*>(out), static_cast<int*>(state),
         n, chunk_elems, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GO(T, V, C, M)                                                   \
  if (threads == T && vectors == V && count == C && merge == M) {         \
    return go<T, V, C, M>(a, min_steps, grid, s);                         \
  }
  DESIGNS(GO)
#undef GO
  return static_cast<int>(cudaErrorInvalidValue);
}
"""

COUNTS = {0: "load only", 1: "warp atomics", 2: "block atomics", 3: "window 8x4",
          4: "window 16x8", 5: "window 16x16"}
MERGES = {0: "zeroed", 1: "ticket", 3: "grid sync"}
# (threads, vectors in flight, vectors a thread a part at least, counting, merge)
DESIGNS = (
    [(t, v, s, 0, 0) for t, v, s in ((128, 2, 1), (256, 1, 1), (256, 2, 4), (256, 4, 2),
                                     (512, 2, 1), (1024, 1, 1), (1024, 4, 1))]
    + [(t, v, s, 1, 0) for t, v, s in ((128, 2, 1), (256, 1, 1), (256, 2, 4), (256, 4, 2),
                                       (512, 2, 1), (1024, 1, 1), (1024, 4, 1))]
    + [(256, 4, 2, 2, 0), (512, 2, 1, 2, 0), (1024, 1, 1, 2, 0)]
    + [(128, 2, 2, 3, 0), (256, 2, 2, 3, 0), (256, 2, 2, 3, 1)]
    + [(256, 2, 2, 4, 0), (256, 4, 2, 4, 0), (256, 2, 2, 5, 0), (256, 4, 2, 5, 0)]
    + [(256, 4, 2, 1, 1), (512, 2, 1, 1, 1), (256, 4, 2, 1, 3), (512, 2, 1, 1, 3)]
    + [(256, 4, 2, 2, 1), (256, 4, 2, 2, 3), (256, 4, 2, 0, 3)]
)


def name(threads, vectors, steps, count, merge):
    return f"{COUNTS[count]}, {MERGES[merge]} T{threads}V{vectors}S{steps}"


def main() -> int:
    import torch

    from . import _build
    from .histogram import chunk_histogram, chunk_histogram_plain

    sys.path.insert(0, ROOT)
    import chip_smoke                   # its timing helpers and inputs, so both time alike

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another histogram.cu with the earlier C interface (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", help="substrings of the design names to keep, '|'-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hist_launch_sweep: no CUDA device available", file=sys.stderr)
        return 1
    keep = args.only.split("|") if args.only else None

    def wanted(key):
        return keep is None or any(k in key for k in keep)

    sources = {"sweep": SWEEP_CU}
    for path in args.baseline:
        sources[os.path.basename(path)] = open(path).read()
    tmp = tempfile.mkdtemp(prefix="hist_sweep_")
    nvcc = _build.nvcc_path()
    procs = {}
    for key, text in sources.items():
        cu = os.path.join(tmp, f"{key}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[key] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{key}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(os.path.join(tmp, f"lib{key}.so"))
    sweep = libs.pop("sweep").sweep_launch
    sweep.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    sweep.restype = ctypes.c_int
    for lib in libs.values():           # the earlier interface: the caller zeroes the counts
        lib.histogram_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                                         + [ctypes.c_void_p])
        lib.histogram_launch.restype = ctypes.c_int

    print(chip_smoke.phase_card())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = chip_smoke.LEAF[0] * chip_smoke.LEAF[1]
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    planes = {
        "exponent plane": chip_smoke.ops_inputs(dev)["exp"],
        "uniform": torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=g),
        "one value": torch.full((n,), 121, dtype=torch.uint8, device=dev),
    }
    res: dict = {}
    for pname, x in planes.items():
        for chunking, chunk in (("K9", n), ("K6", chip_smoke.BF16_CHUNK)):
            rows = -(-n // chunk)
            want = chunk_histogram_plain(x, chunk)
            hist = torch.empty((rows, 256), dtype=torch.int32, device=dev)
            ticket_state = torch.zeros(rows * 257, dtype=torch.int32, device=dev)
            runs = {}
            for design in DESIGNS:
                key = name(*design)
                if not wanted(key):
                    continue
                threads, vectors, steps, count, merge = design

                def run(threads=threads, vectors=vectors, steps=steps, count=count, merge=merge):
                    if merge == 0:
                        hist.zero_()
                    grid = ctypes.c_longlong(0)
                    return sweep(threads, vectors, count, merge, x.data_ptr(), hist.data_ptr(),
                                 ticket_state.data_ptr(), n, chunk, steps, ctypes.byref(grid),
                                 stream)
                runs[key] = (run, r"sweep_kernel", count != 0)
            for key, lib in libs.items():
                if not wanted(key):
                    continue

                def run(fn=lib.histogram_launch):
                    hist.zero_()
                    return fn(x.data_ptr(), hist.data_ptr(), n, chunk, stream)
                runs[key] = (run, r"hist_kernel", True)
            if wanted("this tree"):             # the package's wrapper, as the ops call it
                if not torch.equal(chunk_histogram(x, chunk), want):
                    raise AssertionError(f"this tree's chunk_histogram disagrees on {pname}")
                runs["this tree's chunk_histogram"] = (
                    lambda: (chunk_histogram(x, chunk), 0)[1], r"hist_kernel", False)
            for key, (run, kname, check) in runs.items():
                hist.fill_(-7)                  # what a merge leaves unwritten shows
                rc = run()
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"{key}: launch failed with CUDA error {rc}")
                if check and not torch.equal(hist, want):
                    raise AssertionError(f"{key} disagrees with the plain version on "
                                         f"{pname} ({chunking})")
            for _ in range(args.rounds):
                for key, (run, kname, _) in runs.items():
                    dev_ms = chip_smoke.profiled_ms(run, kname, 20)
                    ev_ms = chip_smoke.device_ms(run, 50)
                    if dev_ms is not None:
                        res.setdefault((pname, chunking, key), []).append(
                            (dev_ms * 1e3, ev_ms * 1e3))
    for pname in planes:
        for chunking in ("K9", "K6"):
            rows = sorted((sum(d for d, _ in v) / len(v), k, v)
                          for (p, c, k), v in res.items() if p == pname and c == chunking)
            for mean, key, v in rows:
                ev = sum(e for _, e in v) / len(v)
                print(f"{pname} {chunking} {key}: device mean {mean:.3f} us "
                      f"({' '.join(f'{d:.3f}' for d, _ in v)}); events mean {ev:.3f} us "
                      f"({' '.join(f'{e:.3f}' for _, e in v)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
