// Embedding row gather for Hopper (sm_90a): out[r, :] = table[ids[r], :].
//
// Replaces the TPU kernel seqrec_tpu/ops/pallas/gather.py (_gather_kernel,
// launched by _gather_pallas), which issues one HBM->VMEM row DMA per
// scalar-prefetched id, eight rows per grid step.
//
// What bounds it here: bytes. Each output row is one read of a table row and
// one write; there is no arithmetic. At the serving shape (12,800 ids into a
// [3418, 128] f32 table) the table (1.75 MB) sits in the 50 MB L2 after its
// first touch, so the floor is the output write plus the distinct rows read.
//
// Design: many rows per block and a group of lanes per row (one warp for a
// 512-byte f32 row of D=128, fewer lanes for shorter rows), each lane moving
// 16 bytes at a time, so a warp's loads and stores are whole 512-byte
// coalesced transactions. Each lane group reads its own id; ids need no
// prefetch pass. The grid strides over rows, so any number of ids launches.
//
// Out-of-range contract (jnp.take, as ops/reference.py): ids in [-V, V) wrap,
// any other id writes a NaN row (the caller passes the dtype's NaN bit
// pattern), and no address outside the table is ever read.
//
// Backward (seqrec_scatter_add_rows): the gather's transpose. Replaces the
// dense scatter-add of seqrec_tpu/ops/pallas/gather.py::_gather_core_bwd
// (`zeros_like(table).at[ids].add(g)`, an XLA scatter on the TPU): each of
// n f32 cotangent rows added into a [V, D] f32 table at its id. Ids in
// [-V, V) wrap; any other id's row is dropped, as XLA's scatter drops
// out-of-bounds updates. Bound by bytes: the cotangent read once (13.1 MB
// for the inputs' 25,600 rows of 128 floats) and the table's 1.75 MB
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

template <typename Id>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table, long long num_rows,
                   int vecs_per_row, int lanes_per_row,
                   const Id* __restrict__ ids, long long n,
                   uint4* __restrict__ out, unsigned int nan_word) {
  const int rows_per_block = kThreads / lanes_per_row;
  const int slot = threadIdx.x / lanes_per_row;
  const int lane = threadIdx.x % lanes_per_row;
  const uint4 nan4 = make_uint4(nan_word, nan_word, nan_word, nan_word);
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  for (long long r = static_cast<long long>(blockIdx.x) * rows_per_block + slot;
       r < n; r += stride) {
    const long long id = static_cast<long long>(ids[r]);
    uint4* dst = out + r * vecs_per_row;
    if (id >= -num_rows && id < num_rows) {
      const uint4* src = table + (id < 0 ? id + num_rows : id) * vecs_per_row;
      for (int c = lane; c < vecs_per_row; c += lanes_per_row) {
        dst[c] = __ldg(src + c);
      }
    } else {
      for (int c = lane; c < vecs_per_row; c += lanes_per_row) {
        dst[c] = nan4;
      }
    }
  }
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

// Launch 1: chunk blockIdx.x of C positions. runs holds C (id, ref) pairs
// a chunk: the chunk's runs sorted by id, and where each run's sum is: a
// run of one position is that row of g itself (ref = its position), any
// other run a row of partial (ref = -1 - its slot). dir holds
// kBuckets + 1 ints a chunk: dir[b] is the first run whose id is at least
// b * ceil(V / kBuckets), dir[kBuckets] the chunk's number of runs; sub
// 2 C / kSubRun rows a chunk.
template <typename Id, typename V, int C>
__global__ void __launch_bounds__(C)
scatter_partials_kernel(const float* __restrict__ g, const Id* __restrict__ ids, long long n,
                        long long num_rows, int D, float* sub, float* partial,
                        int2* __restrict__ runs, int* __restrict__ dir) {
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
  const V* gv = reinterpret_cast<const V*>(g);
  constexpr int sub_rows = 2 * C / kSubRun;
  V* subv = reinterpret_cast<V*>(sub) + static_cast<long long>(blockIdx.x) * sub_rows * units;
  V* partv = reinterpret_cast<V*>(partial) + base * units;

  // Let the combine launch's blocks take the SMs this grid leaves idle;
  // they wait (griddepcontrol.wait) until this grid is done and flushed.
  asm volatile("griddepcontrol.launch_dependents;");
  // Keys: (wrapped id, position in the chunk); dropped and absent ones last.
  unsigned long long key = ~0ull;
  if (base + t < n) {
    long long id = static_cast<long long>(ids[base + t]);
    if (id >= -num_rows && id < num_rows) {
      key = (static_cast<unsigned long long>(id < 0 ? id + num_rows : id) << 32) |
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
          rows[q] = load_ahead(gv + (base + static_cast<int>(keys[f] & 0xffffffffu)) * units + cc);
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
template <typename V>
__global__ void __launch_bounds__(kCombineWarps * 32)
scatter_combine_kernel(const float* g, const float* partial, const int2* runs,
                       const int* dir, int chunks, int C, long long num_rows, int D,
                       float* out) {
  constexpr int kW = sizeof(V) / 4;
  const int lane = threadIdx.x & 31;
  const long long v = static_cast<long long>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (v >= num_rows) return;  // warp-uniform
  const int units = D / kW;
  const int bucket = static_cast<int>(v / ((num_rows + kBuckets - 1) / kBuckets));
  const V* gv = reinterpret_cast<const V*>(g);
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
            rows[q] = load_l2(r >= 0 ? gv + static_cast<long long>(r) * units + cc
                                     : pv + static_cast<long long>(-1 - r) * units + cc);
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

template <typename Id, typename V, int C>
int launch_partials(const void* g, const void* ids, long long n, long long num_rows, int D,
                    void* partial, void* sub, int2* runs, void* dir, cudaStream_t s) {
  const long long chunks = (n + C - 1) / C;
  const size_t smem = static_cast<size_t>(C) * (8 + 4 * 4);
  scatter_partials_kernel<Id, V, C><<<static_cast<unsigned>(chunks), C, smem, s>>>(
      static_cast<const float*>(g), static_cast<const Id*>(ids), n, num_rows, D,
      static_cast<float*>(sub), static_cast<float*>(partial), runs, static_cast<int*>(dir));
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

template <typename Id, typename V>
int launch_scatter(const void* g, const void* ids, long long n, long long num_rows, int D,
                   int chunk, unsigned char* scratch, void* out, cudaStream_t s) {
  const long long chunks = (n + chunk - 1) / chunk;
  const ScratchLayout l = scratch_layout(n, D, chunk);
  void* partial = scratch + l.partial;
  void* sub = scratch + l.sub;
  int2* runs = reinterpret_cast<int2*>(scratch + l.runs);
  void* dir = scratch + l.dir;
  if (chunks > 0) {
    const int e = chunk == 256 ? launch_partials<Id, V, 256>(g, ids, n, num_rows, D, partial,
                                                             sub, runs, dir, s)
                               : launch_partials<Id, V, 512>(g, ids, n, num_rows, D, partial,
                                                             sub, runs, dir, s);
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
      &cfg, scatter_combine_kernel<V>, static_cast<const float*>(g),
      static_cast<const float*>(partial), static_cast<const int2*>(runs),
      static_cast<const int*>(dir), static_cast<int>(chunks), chunk, num_rows, D,
      static_cast<float*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// table: [num_rows, row_bytes] on the device, 16-byte aligned;
// ids: n ints (int64 when ids_are_int64, else int32); out: [n, row_bytes].
int seqrec_gather_rows(const void* table, long long num_rows,
                       long long row_bytes, const void* ids, int ids_are_int64,
                       long long n, void* out, unsigned int nan_word,
                       void* stream) {
  if (num_rows <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int vecs = static_cast<int>(row_bytes / 16);
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes <<= 1;
  const int rows_per_block = kThreads / lanes;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  uint4* o = static_cast<uint4*>(out);
  if (ids_are_int64) {
    gather_rows_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, num_rows, vecs, lanes, static_cast<const long long*>(ids), n, o,
        nan_word);
  } else {
    gather_rows_kernel<int><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, num_rows, vecs, lanes, static_cast<const int*>(ids), n, o, nan_word);
  }
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes seqrec_scatter_add_rows needs for n ids of D floats in
// chunks of `chunk` (256 or 512) positions; -1 for what it cannot take.
long long seqrec_scatter_add_scratch_bytes(long long n, int D, int chunk) {
  if (D <= 0 || n < 0 || n > 0x7fffffffLL || (chunk != 256 && chunk != 512)) return -1;
  return scratch_layout(n, D, chunk).bytes;
}

// g: [n, D] float; ids: n ints (int64 when ids_are_int64, else int32);
// out: [num_rows, D] float, every row written. chunk: positions a chunk,
// 256 or 512. scratch: scratch_bytes on the device, 16-byte aligned, at
// least seqrec_scatter_add_scratch_bytes(n, D, chunk). n < 2^31 (positions
// are kept as int32). num_rows < 2^31 (ids are kept as int32). n == 0
// launches only the second kernel, which writes zeros.
int seqrec_scatter_add_rows(const void* g, const void* ids, int ids_are_int64,
                            long long n, long long num_rows, int D, int chunk,
                            void* scratch, long long scratch_bytes, void* out, void* stream) {
  if (num_rows <= 0 || num_rows > 0x7fffffffLL || D <= 0 || n < 0 || n > 0x7fffffffLL ||
      (chunk != 256 && chunk != 512) ||
      scratch_bytes < scratch_layout(n, D, chunk).bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const bool vec4 = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(g) |
                                     reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  if (ids_are_int64) {
    return vec4 ? launch_scatter<long long, float4>(g, ids, n, num_rows, D, chunk, sc, out, s)
                : launch_scatter<long long, float>(g, ids, n, num_rows, D, chunk, sc, out, s);
  }
  return vec4 ? launch_scatter<int, float4>(g, ids, n, num_rows, D, chunk, sc, out, s)
              : launch_scatter<int, float>(g, ids, n, num_rows, D, chunk, sc, out, s);
}

const char* seqrec_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
