// The CUDA side of `kernel_probes.py grid_f32` (built by it with nvcc, never
// by the package): csrc/gru.cu, or csrc/lstm.cu where PROBE_LSTM is defined,
// with the f32 grid forwards' phase clocks compiled in (rnn.cuh
// GRID_PHASE). The library exports the package's entry points, so that the
// wrappers launch it in the package library's place.
#define SEQREC_GRID_PHASE_CLOCKS
#ifdef PROBE_LSTM
#include "seqrec_tpu_torch/csrc/lstm.cu"
#else
#include "seqrec_tpu_torch/csrc/gru.cu"
#endif

extern "C" {

// The phase cycles (CTA 0's thread 0, summed over steps) since the last
// call, reset; then the mode (bit 0: no h copies, bit 1: no products).
int grid_phase_clocks(unsigned long long* out, int mode) {
  cudaError_t e = cudaMemcpyFromSymbol(out, rnn::g_grid_phase, sizeof(rnn::g_grid_phase));
  unsigned long long zero[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(rnn::g_grid_phase, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(rnn::g_grid_mode, &mode, sizeof(int));
  return static_cast<int>(e);
}

}  // extern "C"
