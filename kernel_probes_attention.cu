// The CUDA side of `kernel_probes.py attention` (built by it with nvcc, never
// by the package): the bf16 Dh-cluster attention (csrc/attention.cu
// attention_cluster_mma_kernel) with every wgmma descriptor's two byte
// offsets exchanged, a control that must fail its check against the plain
// version; the package's own kernels are reached through its library.
#define SEQREC_ATTN_PHASE_CLOCKS
#include "seqrec_tpu_torch/csrc/attention.cu"

extern "C" {

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
