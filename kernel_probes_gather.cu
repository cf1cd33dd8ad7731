// The CUDA side of `kernel_probes.py gather` (built by it with nvcc, never
// by the package): the gather of csrc/gather.cu with 1, 2, 4 (shipped) or 8
// rows in flight a lane group; the row-group design that was tried first
// (a warp's rows with their ids shuffled, 1 to 8 vectors in flight a lane,
// with and without a one-wave grid); the design the redesign replaced (one
// row a lane group, f32 only; the model cast after it); and an empty
// kernel, the floor of a launch timed by CUDA events.
#include "seqrec_tpu_torch/csrc/gather.cu"

namespace {

// The replaced design (gather.cu before the row groups): lanes_per_row
// lanes a row, one load each, a grid-stride loop; f32 in, f32 out.
__global__ void __launch_bounds__(kThreads)
previous_gather_kernel(const uint4* __restrict__ table, long long num_rows, int vecs_per_row,
                       int lanes_per_row, const int* __restrict__ ids, long long n,
                       uint4* __restrict__ out) {
  const int rows_per_block = kThreads / lanes_per_row;
  const int slot = threadIdx.x / lanes_per_row;
  const int lane = threadIdx.x % lanes_per_row;
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  for (long long r = static_cast<long long>(blockIdx.x) * rows_per_block + slot; r < n;
       r += stride) {
    const long long id = static_cast<long long>(ids[r]);
    uint4* dst = out + r * vecs_per_row;
    if (id >= -num_rows && id < num_rows) {
      const uint4* src = table + (id < 0 ? id + num_rows : id) * vecs_per_row;
      for (int c = lane; c < vecs_per_row; c += lanes_per_row) dst[c] = __ldg(src + c);
    }
  }
}

__global__ void empty_kernel() {}

// The row groups (the first design tried for the redesign): a warp
// takes a group of rows at a time, their ids loaded once by lane i and
// shuffled to the lanes that read row i, kU 16-byte vectors in flight a
// lane, a grid of at most one wave striding over the groups.
template <typename Id, typename In, typename Out, int kU>
__global__ void __launch_bounds__(kThreads)
row_groups_kernel(const uint4* __restrict__ table, long long num_rows, int vecs, int group,
                  const Id* __restrict__ ids, long long n, unsigned char* __restrict__ out) {
  constexpr int kOut = Convert<In, Out>::kOutBytes;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long groups = (n + group - 1) / group;
  const int passes = (vecs + 32 * kU - 1) / (32 * kU);
  int row_of[kU], col_of[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int f = u * 32 + lane;
    row_of[u] = passes == 1 ? f / vecs : 0;
    col_of[u] = passes == 1 ? f - row_of[u] * vecs : f;
  }
  for (long long gi = warp; gi < groups; gi += warps) {
    const long long r0 = gi * group;
    const long long my_id = lane < group && r0 + lane < n ? static_cast<long long>(ids[r0 + lane])
                                                          : 0;
    for (int p = 0; p < passes; ++p) {
      uint4 v[kU];
      bool ok[kU], in_range[kU];
      long long dst[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int ro = row_of[u] < group ? row_of[u] : 0;
        const long long id = __shfl_sync(0xffffffffu, my_id, ro);
        const int c = col_of[u] + p * 32 * kU;
        ok[u] = row_of[u] < group && c < vecs && r0 + ro < n;
        dst[u] = (r0 + ro) * vecs + c;
        in_range[u] = id >= -num_rows && id < num_rows;
        if (ok[u] && in_range[u]) v[u] = __ldg(table + (id < 0 ? id + num_rows : id) * vecs + c);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (!ok[u]) continue;
        if (in_range[u]) {
          Convert<In, Out>::store(out + dst[u] * kOut, v[u]);
        } else {
          store_words<kOut>(out + dst[u] * kOut, NanWord<Out>::kValue);
        }
      }
    }
  }
}

template <typename Out, int kU, bool kOneWave>
int launch_row_groups(const void* table, long long V, int vecs, const void* ids, long long n,
                      void* out, cudaStream_t s) {
  auto kernel = row_groups_kernel<int, float, Out, kU>;
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int group = vecs >= 32 * kU ? 1 : (32 * kU / vecs < 32 ? 32 * kU / vecs : 32);
  const long long want = ((n + group - 1) / group + kThreads / 32 - 1) / (kThreads / 32);
  const unsigned blocks = static_cast<unsigned>(kOneWave && want > wave ? wave : want);
  kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint4*>(table), V, vecs, group,
                                     static_cast<const int*>(ids), n,
                                     static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROW_GROUPS(name, U, WAVE)                                                            \
  int name(const void* table, long long V, long long D, const void* ids, long long n,        \
           void* out, int out_is_bf16, void* s) {                                            \
    const int vecs = static_cast<int>(D * 4 / 16);                                           \
    cudaStream_t st = static_cast<cudaStream_t>(s);                                           \
    return out_is_bf16                                                                        \
               ? launch_row_groups<__nv_bfloat16, U, WAVE>(table, V, vecs, ids, n, out, st)   \
               : launch_row_groups<float, U, WAVE>(table, V, vecs, ids, n, out, st);          \
  }

// The shipped kernel (csrc/gather.cu) with kR rows in flight a lane group.
#define ROWS(name, R)                                                                        \
  int name(const void* table, long long V, long long D, const void* ids, long long n,        \
           void* out, int out_is_bf16, void* s) {                                            \
    const int vecs = static_cast<int>(D * 4 / 16);                                           \
    cudaStream_t st = static_cast<cudaStream_t>(s);                                           \
    return out_is_bf16                                                                        \
               ? launch_gather<int, float, __nv_bfloat16, R>(table, V, vecs, ids, n, out, st) \
               : launch_gather<int, float, float, R>(table, V, vecs, ids, n, out, st);        \
  }

extern "C" {
ROW_GROUPS(row_groups_u1, 1, true)
ROW_GROUPS(row_groups_u2, 2, true)
ROW_GROUPS(row_groups_u4, 4, true)
ROW_GROUPS(row_groups_u8, 8, true)
ROW_GROUPS(row_groups_u4_full_grid, 4, false)
ROWS(rows_1, 1)
ROWS(rows_2, 2)
ROWS(rows_4, 4)
ROWS(rows_8, 8)

int gather_previous(const void* table, long long V, long long D, const void* ids, long long n,
                    void* out, int, void* s) {
  const int vecs = static_cast<int>(D * 4 / 16);
  int lanes = 1;
  while (lanes < vecs && lanes < 32) lanes <<= 1;
  const long long blocks = (n + kThreads / lanes - 1) / (kThreads / lanes);
  previous_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(s)>>>(
      static_cast<const uint4*>(table), V, vecs, lanes, static_cast<const int*>(ids), n,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

int empty_launch(void* s) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(s)>>>();
  return static_cast<int>(cudaGetLastError());
}
}
