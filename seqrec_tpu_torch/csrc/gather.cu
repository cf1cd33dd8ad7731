// Embedding row gather for Hopper (sm_90a): out[r, :] = table[ids[r], :],
// written in the caller's compute dtype.
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/gather.py (_gather_kernel,
// launched by _gather_pallas), which issues one HBM->VMEM row DMA per
// scalar-prefetched id, eight rows per grid step, and the `astype` to the
// compute dtype that follows every lookup in seqrec_tpu/models/model.py
// (XLA fuses it into the gather; here it is the kernel's store).
//
// What bounds it here: bytes. Each output row is one read of a table row and
// one write in the output dtype; there is no arithmetic. At the training
// shape (25,600 ids into a [3418, 128] f32 table) the table (1.75 MB) sits
// in the 50 MB L2 after its first touch, so the floor is the output write
// plus the distinct rows read; a bf16 output halves the write.
//
// Design (the gather's, not the TPU's DMA blocks):
// - A lane group of up to 32 lanes a row (a warp a 512-byte f32 row at
//   D=128; 16 lanes, two rows a warp, at D=64), a 16-byte vector a lane,
//   so a warp's loads and stores are whole coalesced segments. A row that
//   is not a multiple of 16 bytes (or a table whose base is not 16-byte
//   aligned) moves in the widest unit of 8, 4 or 2 bytes that divides its
//   bytes and the base: SASRec's d = 50 is 200-byte f32 rows, 8-byte
//   units, 25 a row. The unit is a template parameter (U); rows of 16-byte
//   multiples run the uint4 instantiation they always ran.
// - Each lane group takes kRows = 4 rows, a block's rows apart, and issues
//   the loads of all four before it stores any: four rows in flight a
//   lane, to hide the latency of rows whose ids it has just read (one
//   load a lane before).
// - A lane group reads its own rows' ids: all its lanes read one address,
//   one transaction the hardware broadcasts.
// - A block for every 4 x (256 / lanes) rows; no grid-stride loop.
// - The store converts: f32 rows to bf16 go out as 8-byte packs of four
//   round-to-nearest-even values (cvt.rn.bf16x2.f32), bf16 to f32 as two
//   16-byte stores, the same dtype as it came; a narrower unit converts
//   the same way into an output piece of its own width (an 8-byte f32
//   piece into a 4-byte bf16 pair, a 4-byte one into one bf16 by
//   cvt.rn.bf16.f32).
// - Table reads take the non-coherent path (__ldg): no kernel writes the
//   table while this one runs.
// Measured against the alternatives on an H100 (kernel_probes.py gather,
// PERF.md): one row a lane group is up to 0.0014 ms slower at 25,600
// rows; a warp's rows in groups with their ids loaded once and shuffled,
// 1 to 8 vectors in flight a lane and a one-wave grid-stride loop, is
// 0.001-0.0015 ms slower at every shape (64 registers, half the warps a
// SM, and per-lane index math in the chain of a launch this short).
//
// Out-of-range contract (jnp.take, as ops/reference.py): ids in [-V, V) wrap,
// any other id writes a NaN row (the output dtype's quiet NaN, 0x7FC0 in
// bf16, as the plain version and JAX's astype write it), and no address
// outside the table is ever read.
//
// Backward (seqrec_scatter_add_rows): the gather's transpose. Replaces the
// dense scatter-add of seqrec_tpu/ops/pallas/gather.py::_gather_core_bwd
// (`zeros_like(table).at[ids].add(g)`, an XLA scatter on the TPU): each of
// n f32 cotangent rows added into a [V, D] f32 table at its id. Ids in
// [-V, V) wrap; any other id's row is dropped, as XLA's scatter drops
// out-of-bounds updates. The cotangent comes in the compute dtype (f32 or
// bf16, the gather's output dtype) and is widened to f32 as it is loaded
// (exactly), a template parameter on its element type: no separate
// widening pass. Bound by bytes: the cotangent read once (13.1 MB for the
// inputs' 25,600 rows of 128 floats, half in bf16) and the table's 1.75 MB
// written.
//
// Deterministic: the same inputs give the same bits on every run, because
// every row's sum is taken in an order that the ids' positions fix, with
// plain f32 adds (__fadd_rn, nothing contracted), in three levels:
//   1. positions fall in chunks of C consecutive positions (C = 256 or
//      512, chosen by n); inside a chunk, a row's positions in order form
//      its run, cut into sub-runs of kSubRun = 32; a sub-run is summed
//      from 0 in position order;
//   2. a run's sub-runs are summed from 0 in order: the chunk's partial
//      row for that id;
//   3. the table row is the sum from 0 of its chunks' partials in chunk
//      order (0 where no chunk holds the id).
// gather.py::plain_ordered adds in the same order, in plain tensor code.
// A run of one position is its row of g itself: the sums all start at +0,
// and x and 0 + x (which differ only at x = -0) add the same into them.
// Two launches, no memset (the second writes every table row):
// - scatter_partials_kernel, a block of C threads a chunk: sorts the
//   chunk's (id, position) keys (64-bit, unique, so any sort gives one
//   order) by a bitonic sort (shuffles below 32 apart, shared memory
//   above); finds each key's run and its rank in it by binary search; a
//   block scan numbers the runs and sub-runs. Warp w sums the sub-runs of
//   two or more positions whose first key sits in sorted slots [32 w,
//   32 w + 32): at most 63 rows, so a heavy row (the padding id, a Zipf
//   head) spreads over the block's warps in sub-runs of 32 instead of one
//   warp; 16 row loads are in flight before their adds. A
//   run of more than 32 keys leaves its sub-run sums in a scratch buffer
//   (at most 2 C / 32 rows a chunk), and after a barrier one warp a run
//   adds them. Out: the chunk's runs' ids, sorted, and where each run's
//   sum is (a partial row, or for a run of one position its row of g: at
//   ML-1M's Zipf ids most runs, so most of g is read once, by launch 2),
//   and a directory of its runs over 1,024 id ranges, written by each
//   run's first thread.
// - scatter_combine_kernel, a warp a table row, launched as a programmatic
//   dependent of the first (its blocks take the SMs the first leaves idle
//   and wait for it there, instead of a launch gap): each lane looks up chunks
//   lane, lane + 32, ... (4 at once): the directory bounds the row's run
//   to a few entries, a short search finds it; the warp adds the sums it
//   found in chunk order, 8 loads ahead of the adds, then writes the row.
//   Its loads are coherent ones, never by the non-coherent path: its
//   blocks are resident while the first kernel still writes what they
//   read. Its cost grows with table rows x chunks, whether or not an id
//   reaches a row.
// The scratch (partial rows, sub-run sums, runs, directories) is one buffer
// from the caller, of seqrec_scatter_add_scratch_bytes(n, D, chunk)
// bytes; its layout is known here only. The C interface returns
// cudaGetLastError() after the launch; the launch is asynchronous on the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a lane group loads before it stores any

// A dtype's quiet NaN (0x7FC00000 in f32, 0x7FC0 in bf16), repeated to
// fill 32 bits.
template <typename T>
struct NanWord;
template <>
struct NanWord<float> {
  static constexpr unsigned int kValue = 0x7FC00000u;
};
template <>
struct NanWord<__nv_bfloat16> {
  static constexpr unsigned int kValue = 0x7FC07FC0u;
};

// kBytes output bytes (2 to 32), all of them words w (a dtype's NaN word
// repeated, or 0): the store of one input unit's output.
template <int kBytes>
__device__ __forceinline__ void store_words(unsigned char* dst, unsigned int w) {
  if constexpr (kBytes == 2) {
    *reinterpret_cast<unsigned short*>(dst) = static_cast<unsigned short>(w);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<unsigned int*>(dst) = w;
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w, w);
  } else {
    for (int i = 0; i < kBytes / 16; ++i) reinterpret_cast<uint4*>(dst)[i] = make_uint4(w, w, w, w);
  }
}

// One input unit U's values stored in the output dtype at dst. The unit a
// lane moves is the widest of 16, 8, 4 or 2 bytes that divides the row's
// bytes and the table's base (gather_rows chooses it): rows of 16-byte
// multiples take uint4, as they always did; the narrower units are the same
// kernel's loads and stores at another width.
template <typename In, typename Out, typename U = uint4>
struct Convert;
template <typename T, typename U>
struct Convert<T, T, U> {
  static constexpr int kOutBytes = sizeof(U);
  __device__ static void store(unsigned char* dst, U v) { *reinterpret_cast<U*>(dst) = v; }
};
template <>
struct Convert<float, __nv_bfloat16, uint4> {
  static constexpr int kOutBytes = 8;
  __device__ static void store(unsigned char* dst, uint4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(__uint_as_float(v.x), __uint_as_float(v.y));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(__uint_as_float(v.z), __uint_as_float(v.w));
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(*reinterpret_cast<const unsigned int*>(&lo),
                   *reinterpret_cast<const unsigned int*>(&hi));
  }
};
// An 8-byte f32 piece: one 4-byte bf16 pair; a 4-byte one: one bf16.
template <>
struct Convert<float, __nv_bfloat16, uint2> {
  static constexpr int kOutBytes = 4;
  __device__ static void store(unsigned char* dst, uint2 v) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(__uint_as_float(v.x), __uint_as_float(v.y));
    *reinterpret_cast<unsigned int*>(dst) = *reinterpret_cast<const unsigned int*>(&p);
  }
};
template <>
struct Convert<float, __nv_bfloat16, unsigned> {
  static constexpr int kOutBytes = 2;
  __device__ static void store(unsigned char* dst, unsigned v) {
    *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(__uint_as_float(v));
  }
};
// bf16 to f32: a bf16 is the top half of the f32 with the same value: exact.
// Each 32-bit word of bf16 pairs becomes two floats.
template <typename U>
struct Convert<__nv_bfloat16, float, U> {
  static constexpr int kOutBytes = 2 * sizeof(U);
  __device__ static void store(unsigned char* dst, U v) {
    if constexpr (sizeof(U) == 16) {
      uint4* d = reinterpret_cast<uint4*>(dst);
      d[0] = make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
      d[1] = make_uint4(v.z << 16, v.z & 0xffff0000u, v.w << 16, v.w & 0xffff0000u);
    } else if constexpr (sizeof(U) == 8) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v.x << 16, v.x & 0xffff0000u, v.y << 16, v.y & 0xffff0000u);
    } else if constexpr (sizeof(U) == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(v << 16, v & 0xffff0000u);
    } else {  // one bf16
      *reinterpret_cast<unsigned int*>(dst) = static_cast<unsigned int>(v) << 16;
    }
  }
};


// Where an id reads (the table row it names, when it names one): jnp.take's
// contract, ids in [-V, V) wrapping; or with kWindow, a row shard's: the
// caller has taken row0 off the id, and only [0, V) reads.
template <bool kWindow>
__device__ __forceinline__ bool in_table(long long id, long long num_rows) {
  return kWindow ? id >= 0 && id < num_rows : id >= -num_rows && id < num_rows;
}
template <bool kWindow>
__device__ __forceinline__ long long table_row(long long id, long long num_rows) {
  return kWindow || id >= 0 ? id : id + num_rows;
}

// lanes: the lanes of a row (a power of two up to 32, the smallest that
// covers the row's units U, then passes over the rest); a block
// has kThreads / lanes lane groups, and lane group j of block b takes rows
// (b * kR + k) * rows_per_block + j, k < kR: kR rows, all their loads
// before any store. kWindow: the shard window [row0, row0 + num_rows) of a
// row-sharded table (table holds its num_rows rows): id - row0 reads its
// row, an id outside the window writes a zero row (its rows live on
// another shard), JAX's jnp.where(owned, shard[clip(id - row0)], 0).
template <typename Id, typename In, typename Out, int kR = kRows, bool kWindow = false,
          typename U = uint4>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const U* __restrict__ table, long long num_rows, int vecs, int lanes,
                   const Id* __restrict__ ids, long long n, unsigned char* __restrict__ out,
                   long long row0) {
  constexpr int kOut = Convert<In, Out, U>::kOutBytes;
  const int rows_per_block = kThreads / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block * kR + slot;
  long long id[kR];
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const long long r = r0 + k * rows_per_block;
    id[k] = r < n ? static_cast<long long>(ids[r]) - (kWindow ? row0 : 0) : 0;
  }
  for (int c = lane; c < vecs; c += lanes) {
    U v[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (r0 + k * rows_per_block < n && in_table<kWindow>(id[k], num_rows)) {
        v[k] = __ldg(table + table_row<kWindow>(id[k], num_rows) * vecs + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const long long r = r0 + k * rows_per_block;
      if (r >= n) break;
      unsigned char* dst = out + (r * vecs + c) * kOut;
      if (in_table<kWindow>(id[k], num_rows)) {
        Convert<In, Out, U>::store(dst, v[k]);
      } else {  // a zero row off the window, else the output dtype's NaN
        store_words<kOut>(dst, kWindow ? 0u : NanWord<Out>::kValue);
      }
    }
  }
}

// kR: rows a lane group keeps in flight (kRows; the other counts are for
// kernel_probes.py gather). vecs: units U a row.
template <typename Id, typename In, typename Out, int kR = kRows, bool kWindow = false,
          typename U = uint4>
int launch_gather(const void* table, long long num_rows, int vecs, const void* ids, long long n,
                  void* out, cudaStream_t s, long long row0 = 0) {
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes <<= 1;
  const long long per_block = static_cast<long long>(kThreads / lanes) * kR;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<Id, In, Out, kR, kWindow, U><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const U*>(table), num_rows, vecs, lanes, static_cast<const Id*>(ids), n,
      static_cast<unsigned char*>(out), row0);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The scatter-add, deterministic
// ---------------------------------------------------------------------------

constexpr int kSubRun = 32;     // positions a sub-run at most
constexpr int kCombineWarps = 8;
constexpr int kSearches = 4;    // chunks a lane searches at once
constexpr int kBuckets = 1024;  // id ranges of a chunk's directory
constexpr int kAhead = 8;       // partial rows a warp loads before adding them

// A row's f32 values as V-wide units (float4, or float when D % 4 != 0),
// added with plain round-to-nearest adds (no contraction).
template <typename V>
__device__ __forceinline__ V zero_unit();
template <>
__device__ __forceinline__ float4 zero_unit<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float zero_unit<float>() { return 0.0f; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// A load of g in the partials kernel (the non-coherent path: no kernel
// writes g while it runs), issued where it is written: volatile keeps a
// batch of them together, ahead of their uses.
__device__ __forceinline__ float4 load_ahead(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float load_ahead(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// The combine's loads of what the partials grid writes. Its blocks are
// resident while that grid runs (programmatic dependent launch) and load
// only after griddepcontrol.wait, which makes that grid's writes visible to
// this one: to coherent loads, never to the non-coherent path. A run's sum,
// read once, goes through L2 only (ld.global.cg; volatile keeps a batch of
// them together, after the wait). The runs and the directories, which every
// warp searches, are plain loads (LDG.E, cached in L1): the kernel's
// pointers carry no __restrict__, so the compiler cannot prove them
// read-only and move them to the non-coherent path. (Through __ldca or
// ld.global.cg instead, the combine at a 37,484-row table ran 1.3x and 2x
// slower on an H100: `kernel_probes.py scatter`.)
__device__ __forceinline__ float4 load_l2(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float load_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// A unit of g at unit index i, widened to f32: g holds f32 or bf16 values
// (the cotangent in the compute dtype). The widening is exact (a bf16 is
// the top half of the f32 of the same value), so a bf16 g sums the same
// values in the same order as its f32 widening. nc: the partials kernel's
// loads (load_ahead); run: the combine's (through L2, as load_l2).
template <typename V, typename G>
struct GLoad;
// run: the combine's load of a run's sum, unit i of a row of g (from_g)
// or of partial. In f32 one load, its address selected: a branch between
// two volatile loads there made the combine 12% slower on an H100.
template <typename V>
struct GLoad<V, float> {
  __device__ static V nc(const void* g, long long i) {
    return load_ahead(static_cast<const V*>(g) + i);
  }
  __device__ static V run(const void* g, const V* partial, long long i, bool from_g) {
    return load_l2((from_g ? static_cast<const V*>(g) : partial) + i);
  }
};
__device__ __forceinline__ float4 widen4(unsigned a, unsigned b) {
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}
template <>
struct GLoad<float4, __nv_bfloat16> {
  __device__ static float4 nc(const void* g, long long i) {
    unsigned a, b;
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
                 : "=r"(a), "=r"(b) : "l"(static_cast<const uint2*>(g) + i));
    return widen4(a, b);
  }
  __device__ static float4 run(const void* g, const float4* partial, long long i, bool from_g) {
    // Plain L2 loads (not volatile asm), so that the compiler predicates
    // the two instead of branching: ordered after griddepcontrol.wait by
    // its memory clobber.
    const uint2 u = from_g ? __ldcg(static_cast<const uint2*>(g) + i) : make_uint2(0u, 0u);
    const float4 v = from_g ? make_float4(0.f, 0.f, 0.f, 0.f) : __ldcg(partial + i);
    return from_g ? widen4(u.x, u.y) : v;
  }
};
template <>
struct GLoad<float, __nv_bfloat16> {
  __device__ static float nc(const void* g, long long i) {
    unsigned short h;
    asm volatile("ld.global.nc.u16 %0, [%1];"
                 : "=h"(h) : "l"(static_cast<const unsigned short*>(g) + i));
    return __uint_as_float(static_cast<unsigned>(h) << 16);
  }
  __device__ static float run(const void* g, const float* partial, long long i, bool from_g) {
    const unsigned short h = from_g ? __ldcg(static_cast<const unsigned short*>(g) + i) : 0;
    const float v = from_g ? 0.f : __ldcg(partial + i);
    return from_g ? __uint_as_float(static_cast<unsigned>(h) << 16) : v;
  }
};

// Exclusive prefix sum of v over the block (blockDim.x threads, a multiple
// of 32); *total gets the block's sum. Four 16-bit counters share v.
__device__ unsigned long long block_exclusive_scan(unsigned long long v,
                                                   unsigned long long* warp_tot,
                                                   unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < nw ? warp_tot[lane] : 0ull;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nw) warp_tot[lane] = w;  // inclusive
  }
  __syncthreads();
  *total = warp_tot[nw - 1];
  return (warp > 0 ? warp_tot[warp - 1] : 0ull) + x - v;
}

// The first of keys[0, n) not below `want` (keys sorted ascending).
__device__ __forceinline__ int first_not_below(const unsigned long long* keys, int n,
                                           unsigned long long want) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (keys[lo + half] < want) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Launch 1: chunk blockIdx.x of C positions. kWindow: ids are a row shard's,
// as the gather's (id - row0 in [0, num_rows) adds, any other id adds
// nothing: its row lives on another shard). runs holds C (id, ref) pairs
// a chunk: the chunk's runs sorted by id, and where each run's sum is: a
// run of one position is that row of g itself (ref = its position), any
// other run a row of partial (ref = -1 - its slot). dir holds
// kBuckets + 1 ints a chunk: dir[b] is the first run whose id is at least
// b * ceil(V / kBuckets), dir[kBuckets] the chunk's number of runs; sub
// 2 C / kSubRun rows a chunk.
template <typename Id, typename V, typename G, int C, bool kWindow>
__global__ void __launch_bounds__(C)
scatter_partials_kernel(const void* __restrict__ g, const Id* __restrict__ ids, long long n,
                        long long num_rows, int D, float* sub, float* partial,
                        int2* __restrict__ runs, int* __restrict__ dir, long long row0) {
  constexpr int kW = sizeof(V) / 4;           // floats a unit
  constexpr int kAhead1 = 16;  // row loads before their adds
  constexpr int nw = C / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long warp_tot[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [C] sorted
  int* run_end = reinterpret_cast<int*>(keys + C);  // [C] one past the slot's run
  int* run_idx = run_end + C;                       // [C] runs before the slot
  int* msub_idx = run_idx + C;                      // [C] multi sub-runs before it; -1: solo
  int* multis = msub_idx + C;                       // [C] first slots of multi runs
  const long long base = static_cast<long long>(blockIdx.x) * C;
  const int units = D / kW;
  constexpr int sub_rows = 2 * C / kSubRun;
  V* subv = reinterpret_cast<V*>(sub) + static_cast<long long>(blockIdx.x) * sub_rows * units;
  V* partv = reinterpret_cast<V*>(partial) + base * units;

  // Let the combine launch's blocks take the SMs this grid leaves idle;
  // they wait (griddepcontrol.wait) until this grid is done and flushed.
  asm volatile("griddepcontrol.launch_dependents;");
  // Keys: (wrapped id, position in the chunk); dropped and absent ones last.
  unsigned long long key = ~0ull;
  if (base + t < n) {
    const long long id = static_cast<long long>(ids[base + t]) - (kWindow ? row0 : 0);
    if (in_table<kWindow>(id, num_rows)) {
      key = (static_cast<unsigned long long>(table_row<kWindow>(id, num_rows)) << 32) |
            static_cast<unsigned>(t);
    }
  }
  // Bitonic sort, ascending: pairs 32 or more apart through shared memory.
#pragma unroll
  for (int k = 2; k <= C; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        keys[t] = key;
        __syncthreads();
        other = keys[t ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool keep_min = ((t & k) == 0) == ((t & j) == 0);
      key = keep_min ? (other < key ? other : key) : (other > key ? other : key);
    }
  }
  keys[t] = key;
  __syncthreads();

  // Thread t now speaks for sorted slot t: its run, its rank in the run.
  const bool valid = key != ~0ull;
  const unsigned long long id = key >> 32;
  int start = t, end = t + 1;
  if (valid) {
    start = first_not_below(keys, C, id << 32);
    end = first_not_below(keys, C, (id + 1) << 32);
  }
  const bool run_head = valid && start == t;
  const bool solo = end - start == 1;  // a run of one position: nothing to sum
  const bool sub_head = valid && !solo && (t - start) % kSubRun == 0;
  const bool multi = end - start > kSubRun;
  const unsigned long long flags = (run_head ? 1ull : 0ull) |
                                   (run_head && multi ? 1ull << 16 : 0ull) |
                                   (sub_head && multi ? 1ull << 32 : 0ull);
  unsigned long long total;
  const unsigned long long ex = block_exclusive_scan(flags, warp_tot, &total);
  const int my_run = static_cast<int>(ex & 0xffff), my_msub = static_cast<int>((ex >> 32) & 0xffff);
  run_end[t] = end;
  run_idx[t] = my_run;
  msub_idx[t] = solo ? -1 : my_msub;
  if (run_head && multi) multis[(ex >> 16) & 0xffff] = t;
  const int n_runs = static_cast<int>(total & 0xffff);
  const int n_multi = static_cast<int>((total >> 16) & 0xffff);
  __syncthreads();

  // Level 1: warp w sums the sub-runs that start in its own slots [32 w,
  // 32 w + 32): from the first such start to the last one's end (at most
  // 63 slots), skipping the runs of one position between them. A
  // sub-run's sum goes to its run's partial row when the run has one
  // sub-run, else to the scratch row of its multi sub-run index.
  const unsigned heads = __ballot_sync(0xffffffffu, sub_head);
  const int dst_own = multi ? -1 - my_msub : my_run;
  if (heads) {
    const int w0 = 32 * warp;
    const int first = w0 + __ffs(heads) - 1, last_lane = 31 - __clz(heads);
    const int e_end = min(__shfl_sync(0xffffffffu, end, last_lane), w0 + last_lane + kSubRun);
    for (int c0 = 0; c0 < units; c0 += 32) {
      const int c = c0 + lane;
      V acc = zero_unit<V>();
      int head = first;
      for (int b0 = first; b0 < e_end; b0 += kAhead1) {
        // All kAhead1 loads first (a slot past the walk or of a run of
        // one position reloads the first slot's row; lanes past the row
        // its last unit), then their adds in slot order.
        V rows[kAhead1];
        const int cc = min(c, units - 1);
#pragma unroll
        for (int q = 0; q < kAhead1; ++q) {
          const int f = b0 + q < e_end && msub_idx[b0 + q] >= 0 ? b0 + q : first;
          rows[q] = GLoad<V, G>::nc(
              g, (base + static_cast<int>(keys[f] & 0xffffffffu)) * units + cc);
        }
#pragma unroll
        for (int q = 0; q < kAhead1; ++q) {
          const int f = b0 + q;
          if (f >= e_end) break;
          if (msub_idx[f] < 0) continue;  // a run of one position
          if (f != head && f - w0 < 32 && ((heads >> (f - w0)) & 1u)) {
            // f starts the next sub-run: store the one that ended.
            const int dst = __shfl_sync(0xffffffffu, dst_own, head - w0);
            if (c < units) {
              (dst >= 0 ? partv : subv)[static_cast<long long>(dst >= 0 ? dst : -1 - dst) *
                                        units + c] = acc;
            }
            acc = zero_unit<V>();
            head = f;
          }
          acc = add(acc, rows[q]);
        }
      }
      const int dst = __shfl_sync(0xffffffffu, dst_own, head - w0);
      if (c < units) {
        (dst >= 0 ? partv : subv)[static_cast<long long>(dst >= 0 ? dst : -1 - dst) * units + c] =
            acc;
      }
    }
  }
  // The runs' ids and refs, by their first slots; the chunk's directory,
  // by each run's first slot for the id ranges from its predecessor's to
  // its own (and the last one's to the end).
  const long long width = (num_rows + kBuckets - 1) / kBuckets;
  if (run_head) {
    runs[base + my_run] = make_int2(static_cast<int>(id),
                                    solo ? static_cast<int>(base + (key & 0xffffffffu))
                                         : static_cast<int>(-1 - (base + my_run)));
    const int b_prev = t == 0 ? -1 : static_cast<int>((keys[t - 1] >> 32) / width);
    for (int b = b_prev + 1; b <= static_cast<int>(id / width); ++b) {
      dir[static_cast<long long>(blockIdx.x) * (kBuckets + 1) + b] = my_run;
    }
  }
  if (valid && (t == C - 1 || keys[t + 1] == ~0ull)) {  // the last key: the last run
    for (int b = static_cast<int>(id / width) + 1; b <= kBuckets; ++b) {
      dir[static_cast<long long>(blockIdx.x) * (kBuckets + 1) + b] = n_runs;
    }
  }
  if (t == 0 && !valid) {  // no run at all
    for (int b = 0; b <= kBuckets; ++b) dir[static_cast<long long>(blockIdx.x) * (kBuckets + 1) + b] = 0;
  }
  __syncthreads();  // the sub-run sums are written (and visible to the block)

  // Level 2: a warp a run of more than kSubRun keys adds its sub-run sums.
  for (int m = warp; m < n_multi; m += nw) {
    const int t0 = multis[m];
    const int nsub = (run_end[t0] - t0 + kSubRun - 1) / kSubRun;
    const V* src = subv + static_cast<long long>(msub_idx[t0]) * units;
    for (int c = lane; c < units; c += 32) {
      V acc = zero_unit<V>();
      for (int q = 0; q < nsub; ++q) acc = add(acc, src[static_cast<long long>(q) * units + c]);
      partv[static_cast<long long>(run_idx[t0]) * units + c] = acc;
    }
  }
}

// Launch 2: a warp a table row; runs and dir as launch 1 left them (C
// pairs and kBuckets + 1 directory entries a chunk); a run's sum is a row
// of g or of partial, as its ref says.
template <typename V, typename G>
__global__ void __launch_bounds__(kCombineWarps * 32)
scatter_combine_kernel(const void* g, const float* partial, const int2* runs,
                       const int* dir, int chunks, int C, long long num_rows, int D,
                       float* out) {
  constexpr int kW = sizeof(V) / 4;
  const int lane = threadIdx.x & 31;
  const long long v = static_cast<long long>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (v >= num_rows) return;  // warp-uniform
  const int units = D / kW;
  const int bucket = static_cast<int>(v / ((num_rows + kBuckets - 1) / kBuckets));
  const V* pv = reinterpret_cast<const V*>(partial);
  V* ov = reinterpret_cast<V*>(out) + v * units;
  // Launched early (programmatic dependent launch): wait for the partials
  // grid to finish and its writes to be visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int c0 = 0; c0 < units; c0 += 32) {
    const int c = c0 + lane;
    V acc = zero_unit<V>();
    for (int r0 = 0; r0 < chunks; r0 += 32 * kSearches) {
      // Lane l looks up chunks r0 + l + 32 i, i < kSearches, side by side:
      // the directory bounds v's run to [lo, lo + len); halve that to 4
      // runs, then compare the 4 at once. ref: where the found run's sum is.
      int lo[kSearches], len[kSearches], ref[kSearches];
      bool found[kSearches];
#pragma unroll
      for (int i = 0; i < kSearches; ++i) {
        const long long ch = r0 + lane + 32 * i;
        lo[i] = len[i] = 0;
        if (ch < chunks) {
          const int* d = dir + ch * (kBuckets + 1) + bucket;
          lo[i] = *d;
          len[i] = d[1] - lo[i];
        }
      }
      for (bool busy = true; busy;) {
        busy = false;
#pragma unroll
        for (int i = 0; i < kSearches; ++i) {
          if (len[i] > 4) {
            const int half = len[i] >> 1;
            const long long ch = r0 + lane + 32 * i;
            if (runs[ch * C + lo[i] + half].x <= v) {
              lo[i] += half;
              len[i] -= half;
            } else {
              len[i] = half;
            }
            busy |= len[i] > 4;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kSearches; ++i) {
        const long long ch = r0 + lane + 32 * i;
        found[i] = false;
        ref[i] = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < len[i]) {
            const int2 run = runs[ch * C + lo[i] + q];
            if (run.x == v) {
              found[i] = true;
              ref[i] = run.y;
            }
          }
        }
      }
      // The found sums in chunk order (i, then lane), kAhead loads before
      // their adds.
#pragma unroll
      for (int i = 0; i < kSearches; ++i) {
        unsigned mask = __ballot_sync(0xffffffffu, found[i]);
        const int cc = min(c, units - 1);
        while (mask) {
          // kAhead loads first (past the last found sum, the first again),
          // then their adds in chunk order.
          V rows[kAhead];
          int got = 0;
          const int b_first = __ffs(mask) - 1;
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            const int b = mask ? __ffs(mask) - 1 : b_first;
            const int r = __shfl_sync(0xffffffffu, ref[i], b);
            got += mask != 0u;
            mask &= mask - 1;
            const long long at = static_cast<long long>(r >= 0 ? r : -1 - r) * units + cc;
            rows[q] = GLoad<V, G>::run(g, pv, at, r >= 0);
          }
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            if (q < got) acc = add(acc, rows[q]);
          }
        }
      }
    }
    if (c < units) ov[c] = acc;
  }
}

template <typename Id, typename V, typename G, int C, bool kWindow>
int launch_partials(const void* g, const void* ids, long long n, long long num_rows, int D,
                    void* partial, void* sub, int2* runs, void* dir, long long row0,
                    cudaStream_t s) {
  const long long chunks = (n + C - 1) / C;
  const size_t smem = static_cast<size_t>(C) * (8 + 4 * 4);
  scatter_partials_kernel<Id, V, G, C, kWindow><<<static_cast<unsigned>(chunks), C, smem, s>>>(
      g, static_cast<const Id*>(ids), n, num_rows, D,
      static_cast<float*>(sub), static_cast<float*>(partial), runs, static_cast<int*>(dir),
      row0);
  return static_cast<int>(cudaGetLastError());
}

// The scratch's four regions, at byte offsets, each 256-byte aligned:
// partial [chunks * C, D] float, sub [chunks * 2 C / kSubRun, D] float,
// runs [chunks * C] int2 (a pair a position), dir [chunks * (kBuckets + 1)]
// int.
struct ScratchLayout {
  long long partial, sub, runs, dir, bytes;
};

long long round_up_256(long long b) { return (b + 255) / 256 * 256; }

ScratchLayout scratch_layout(long long n, int D, int chunk) {
  const long long chunks = (n + chunk - 1) / chunk;
  ScratchLayout l;
  l.partial = 0;
  l.sub = round_up_256(chunks * chunk * D * 4LL);
  l.runs = l.sub + round_up_256(chunks * (2 * chunk / kSubRun) * D * 4LL);
  l.dir = l.runs + round_up_256(chunks * chunk * 8LL);
  l.bytes = l.dir + round_up_256(chunks * (kBuckets + 1) * 4LL);
  return l;
}

template <typename Id, typename V, typename G, bool kWindow>
int launch_scatter(const void* g, const void* ids, long long n, long long num_rows, int D,
                   int chunk, unsigned char* scratch, void* out, long long row0, cudaStream_t s) {
  const long long chunks = (n + chunk - 1) / chunk;
  const ScratchLayout l = scratch_layout(n, D, chunk);
  void* partial = scratch + l.partial;
  void* sub = scratch + l.sub;
  int2* runs = reinterpret_cast<int2*>(scratch + l.runs);
  void* dir = scratch + l.dir;
  if (chunks > 0) {
    const int e = chunk == 256
                      ? launch_partials<Id, V, G, 256, kWindow>(g, ids, n, num_rows, D, partial,
                                                                sub, runs, dir, row0, s)
                      : launch_partials<Id, V, G, 512, kWindow>(g, ids, n, num_rows, D, partial,
                                                                sub, runs, dir, row0, s);
    if (e != 0) return e;
  }
  // The combine may start while the partials grid runs (programmatic
  // dependent launch); it waits for it before reading what it wrote.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((num_rows + kCombineWarps - 1) / kCombineWarps));
  cfg.blockDim = dim3(kCombineWarps * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, scatter_combine_kernel<V, G>, g,
      static_cast<const float*>(partial), static_cast<const int2*>(runs),
      static_cast<const int*>(dir), static_cast<int>(chunks), chunk, num_rows, D,
      static_cast<float*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// One table dtype's launches at unit U: by ids' width and output dtype.
template <typename In, typename U, bool kWindow>
int launch_gather_unit(int kind, const void* table, long long num_rows, int vecs,
                       const void* ids, long long n, void* out, cudaStream_t s, long long row0) {
  using bf16 = __nv_bfloat16;
  constexpr int R = kRows;
  switch (kind) {  // (ids are int64) * 2 + (out is bf16)
    case 0: return launch_gather<int, In, float, R, kWindow, U>(table, num_rows, vecs, ids, n, out, s, row0);
    case 1: return launch_gather<int, In, bf16, R, kWindow, U>(table, num_rows, vecs, ids, n, out, s, row0);
    case 2: return launch_gather<long long, In, float, R, kWindow, U>(table, num_rows, vecs, ids, n, out, s, row0);
    default: return launch_gather<long long, In, bf16, R, kWindow, U>(table, num_rows, vecs, ids, n, out, s, row0);
  }
}

template <bool kWindow>
int gather_rows(const void* table, long long num_rows, long long D, int table_is_bf16,
                const void* ids, int ids_are_int64, long long n, void* out, int out_is_bf16,
                long long row0, void* stream) {
  const long long row_bytes = D * (table_is_bf16 ? 2 : 4);
  const int unit = mma::copy_unit(static_cast<unsigned long long>(row_bytes) |
                                  reinterpret_cast<uintptr_t>(table));
  // The output's unit: the input unit's values in the output dtype (up to 32
  // bytes, stored as 16-byte halves).
  const int out_unit = unit * (out_is_bf16 ? 2 : 4) / (table_is_bf16 ? 2 : 4);
  if (num_rows <= 0 || D <= 0 || unit == 0 || row_bytes / unit > 0x7fffffffLL || n < 0 ||
      row0 < 0 || row0 > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(out) % (out_unit < 16 ? out_unit : 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int vecs = static_cast<int>(row_bytes / unit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int kind = (ids_are_int64 ? 2 : 0) | (out_is_bf16 ? 1 : 0);
#define SEQREC_GATHER_ARGS kind, table, num_rows, vecs, ids, n, out, s, row0
  if (!table_is_bf16) {  // f32 rows are multiples of 4 bytes
    switch (unit) {
      case 16: return launch_gather_unit<float, uint4, kWindow>(SEQREC_GATHER_ARGS);
      case 8: return launch_gather_unit<float, uint2, kWindow>(SEQREC_GATHER_ARGS);
      case 4: return launch_gather_unit<float, unsigned, kWindow>(SEQREC_GATHER_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (unit) {
    case 16: return launch_gather_unit<bf16, uint4, kWindow>(SEQREC_GATHER_ARGS);
    case 8: return launch_gather_unit<bf16, uint2, kWindow>(SEQREC_GATHER_ARGS);
    case 4: return launch_gather_unit<bf16, unsigned, kWindow>(SEQREC_GATHER_ARGS);
    default: return launch_gather_unit<bf16, unsigned short, kWindow>(SEQREC_GATHER_ARGS);
  }
#undef SEQREC_GATHER_ARGS
}

template <bool kWindow>
int scatter_add_rows(const void* g, int g_is_bf16, const void* ids, int ids_are_int64,
                     long long n, long long num_rows, int D, int chunk, void* scratch,
                     long long scratch_bytes, void* out, long long row0, void* stream) {
  if (num_rows <= 0 || num_rows > 0x7fffffffLL || D <= 0 || n < 0 || n > 0x7fffffffLL ||
      (chunk != 256 && chunk != 512) || row0 < 0 || row0 > 0x7fffffffLL ||
      scratch_bytes < scratch_layout(n, D, chunk).bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  // float4 units: 4 values of g (16 bytes in f32, 8 in bf16) and of out.
  const uintptr_t g_align = g_is_bf16 ? 8 : 16;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(g) % g_align == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  using bf16 = __nv_bfloat16;
  constexpr bool W = kWindow;
  const int kind = (ids_are_int64 ? 4 : 0) | (g_is_bf16 ? 2 : 0) | (vec4 ? 1 : 0);
  switch (kind) {
    case 0: return launch_scatter<int, float, float, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    case 1: return launch_scatter<int, float4, float, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    case 2: return launch_scatter<int, float, bf16, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    case 3: return launch_scatter<int, float4, bf16, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    case 4: return launch_scatter<long long, float, float, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    case 5: return launch_scatter<long long, float4, float, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    case 6: return launch_scatter<long long, float, bf16, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
    default: return launch_scatter<long long, float4, bf16, W>(g, ids, n, num_rows, D, chunk, sc, out, row0, s);
  }
}

}  // namespace

extern "C" {

// table: [num_rows, D] float (table_is_bf16 = 0) or bf16 on the device, any
// D >= 1 (the unit: the widest of 16, 8, 4 or 2 bytes dividing the row's
// bytes and the table's base); ids: n ints (int64 when ids_are_int64, else
// int32); out: [n, D] float (out_is_bf16 = 0) or bf16, aligned to the
// output unit (16-byte aligned always does).
int seqrec_gather_rows(const void* table, long long num_rows, long long D, int table_is_bf16,
                       const void* ids, int ids_are_int64, long long n, void* out,
                       int out_is_bf16, void* stream) {
  return gather_rows<false>(table, num_rows, D, table_is_bf16, ids, ids_are_int64, n, out,
                            out_is_bf16, 0, stream);
}

// The shard-window variant: table holds rows [row0, row0 + num_rows) of a
// row-sharded table (0 <= row0 < 2^31); an id in the window reads its row,
// any other id writes a zero row.
int seqrec_gather_rows_window(const void* table, long long num_rows, long long D,
                              int table_is_bf16, const void* ids, int ids_are_int64, long long n,
                              void* out, int out_is_bf16, long long row0, void* stream) {
  return gather_rows<true>(table, num_rows, D, table_is_bf16, ids, ids_are_int64, n, out,
                           out_is_bf16, row0, stream);
}

// The scratch bytes seqrec_scatter_add_rows needs for n ids of D floats in
// chunks of `chunk` (256 or 512) positions; -1 for what it cannot take.
long long seqrec_scatter_add_scratch_bytes(long long n, int D, int chunk) {
  if (D <= 0 || n < 0 || n > 0x7fffffffLL || (chunk != 256 && chunk != 512)) return -1;
  return scratch_layout(n, D, chunk).bytes;
}

// g: [n, D] float (g_is_bf16 = 0) or bf16, widened to f32 as it is read;
// ids: n ints (int64 when ids_are_int64, else int32);
// out: [num_rows, D] float, every row written. chunk: positions a chunk,
// 256 or 512. scratch: scratch_bytes on the device, 16-byte aligned, at
// least seqrec_scatter_add_scratch_bytes(n, D, chunk). n < 2^31 (positions
// are kept as int32). num_rows < 2^31 (ids are kept as int32). n == 0
// launches only the second kernel, which writes zeros.
int seqrec_scatter_add_rows(const void* g, int g_is_bf16, const void* ids, int ids_are_int64,
                            long long n, long long num_rows, int D, int chunk,
                            void* scratch, long long scratch_bytes, void* out, void* stream) {
  return scatter_add_rows<false>(g, g_is_bf16, ids, ids_are_int64, n, num_rows, D, chunk,
                                 scratch, scratch_bytes, out, 0, stream);
}

// The shard-window variant: out holds rows [row0, row0 + num_rows) of a
// row-sharded table (0 <= row0 < 2^31); an id in the window adds at row
// id - row0, any other id adds nothing. The same scratch as above.
int seqrec_scatter_add_rows_window(const void* g, int g_is_bf16, const void* ids,
                                   int ids_are_int64, long long n, long long num_rows, int D,
                                   int chunk, void* scratch, long long scratch_bytes, void* out,
                                   long long row0, void* stream) {
  return scatter_add_rows<true>(g, g_is_bf16, ids, ids_are_int64, n, num_rows, D, chunk,
                                scratch, scratch_bytes, out, row0, stream);
}

const char* seqrec_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
