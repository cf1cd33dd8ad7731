// The CUDA side of `kernel_probes.py attention` (built by it with nvcc, never
// by the package): the bf16 Dh-cluster attention (csrc/attention.cu
// attention_cluster_mma_kernel) with every wgmma descriptor's two byte
// offsets exchanged, a control that must fail its check against the plain
// version; its epilogue's quotient (markstein_quotient) beside __fdiv_rn on
// the same operands; the package's own kernels are reached through its library.
#define SEQREC_ATTN_PHASE_CLOCKS
#include "seqrec_tpu_torch/csrc/attention.cu"

namespace {

// The epilogue's steps on a[i] and l[i]: den = max(l, 1e-30), inv =
// RN(1 / den), got = markstein_quotient; want = __fdiv_rn(a, den).
__global__ void epilogue_quotient_probe(const float* a, const float* l, float* got, float* want,
                                        int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float den = fmaxf(l[i], 1e-30f);
    got[i] = markstein_quotient(a[i], den, __frcp_rn(den));
    want[i] = __fdiv_rn(a[i], den);
  }
}

}  // namespace

extern "C" {

// epilogue_quotient_probe over n pairs on the stream; a CUDA error code.
int attn_epilogue_quotients(const void* a, const void* l, void* got, void* want, int n,
                            void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  epilogue_quotient_probe<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(l), static_cast<float*>(got),
      static_cast<float*>(want), n);
  return static_cast<int>(cudaGetLastError());
}

// As seqrec_attention_forward on the Dh-cluster layout's TMA route (bf16,
// 16-byte units), with the descriptors' offsets exchanged.
int attn_cluster_control(const void* q, const void* k, const void* v, void* o, int B, int N,
                         int Tn, int Dh, long long sq_b, long long sq_t, long long sk_b,
                         long long sk_t, long long sv_b, long long sv_t, float scale, int band,
                         int clusters, void* stream) {
  if (B <= 0 || N <= 0 || Tn <= 0 || layout_of(Dh) != 2 || band < 1 || band > B * N ||
      clusters < 1 || clusters > (Tn + kTile - 1) / kTile * B * N ||
      stage_unit(Dh, 2, q, k, v, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t) != 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_cluster_bf16<true, 16, true>(q, k, v, o, B, N, Tn, Dh, sq_b, sq_t, sk_b, sk_t,
                                             sv_b, sv_t, scale, band, clusters,
                                             static_cast<cudaStream_t>(stream));
}

// The phase clocks (cycles, CTA 0's thread 0) since the last call, reset.
int attn_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_attn_phase, sizeof(g_attn_phase));
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long zero[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_attn_phase, zero, sizeof(zero)));
}

}  // extern "C"
