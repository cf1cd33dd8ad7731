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
// (`zeros_like(table).at[ids].add(g)`, an XLA scatter on the TPU). For each
// of n ids, the f32 cotangent row is added into a zeroed [V, D] f32 table
// (the caller allocates and zeroes it) with atomicAdd: one lane group per
// row, as the gather, one float per lane per step. Ids in [-V, V) wrap; any
// other id's row is dropped, as XLA's scatter drops out-of-bounds updates.
// Bound by bytes: the cotangent read once (13.1 MB for the inputs' 25,600
// rows of 128 floats) and the table's 1.75 MB zeroed and written. Atomics
// make the order of each row's sum vary from run to run.
//
// The C interface returns cudaGetLastError() after the launch; the launch is
// asynchronous on the caller's stream and allocates nothing.

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

template <typename Id>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float* __restrict__ g, const Id* __restrict__ ids,
                        long long n, long long num_rows, int D,
                        int lanes_per_row, float* __restrict__ out) {
  const int rows_per_block = kThreads / lanes_per_row;
  const int slot = threadIdx.x / lanes_per_row;
  const int lane = threadIdx.x % lanes_per_row;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  for (long long r = static_cast<long long>(blockIdx.x) * rows_per_block + slot;
       r < n; r += stride) {
    const long long id = static_cast<long long>(ids[r]);
    if (id < -num_rows || id >= num_rows) continue;  // dropped
    float* dst = out + (id < 0 ? id + num_rows : id) * D;
    const float* src = g + r * D;
    for (int c = lane; c < D; c += lanes_per_row) atomicAdd(dst + c, src[c]);
  }
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

// g: [n, D] float; ids: n ints (int64 when ids_are_int64, else int32);
// out: [num_rows, D] float, zeroed by the caller.
int seqrec_scatter_add_rows(const void* g, const void* ids, int ids_are_int64,
                            long long n, long long num_rows, int D, void* out,
                            void* stream) {
  if (num_rows <= 0 || D <= 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int lanes = 1;
  while (lanes < D && lanes < 32) lanes <<= 1;
  const int rows_per_block = kThreads / lanes;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  if (ids_are_int64) {
    scatter_add_rows_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        gp, static_cast<const long long*>(ids), n, num_rows, D, lanes, o);
  } else {
    scatter_add_rows_kernel<int><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        gp, static_cast<const int*>(ids), n, num_rows, D, lanes, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* seqrec_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
