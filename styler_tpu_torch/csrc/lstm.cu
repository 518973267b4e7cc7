// LSTM recurrence over precomputed input gates, f32 throughout.
//
// Replaces the forward Pallas kernel of styler_tpu/ops/pallas_lstm.py
// (lstm_recurrence_pallas -> _run_forward/_fwd_kernel). One CTA runs one
// whole sequence: the loop over time inside the CTA takes the place of
// the TPU's sequential grid, w_hh stays resident in shared memory and
// h/c never leave the chip. One launch covers every (branch, direction,
// batch row) of a BiLSTM layer, each branch zero-padded to the widest
// hidden size Hp; padded units stay exactly 0 (their gates are 0, so
// c = 0.5*c + 0.5*tanh(0) = 0 and h = 0.5*tanh(0) = 0).
//
// Bound on the H100: the work is tiny (2*4H*H FLOPs and 16H bytes per
// step), so the bound in bytes or FLOPs is microseconds; what limits the
// kernel is the T-step dependency chain (one dot product of length Hp
// per thread, two __syncthreads per step). The design keeps every
// operand of a step in shared memory or registers so a step costs only
// on-chip latency.
//
// Exact f32: no tensor cores, no TF32, expf/tanhf (build without
// --use_fast_math). The dot product is summed first and then added to
// the input gate, as jnp.dot(h, w_hh.T) + gx is in the reference.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// gates: [S, B, T, 4*Hp]  (torch gate order i, f, g, o; gate k of unit u
//                          at k*Hp + u)
// w_t:   [S, Hp, 4*Hp]    (w_t[s][j][r] = w_hh[r][j] of sequence group s)
// h_out: [S, B, T, Hp]
// grid = S*B CTAs, block = 4*Hp threads (thread r owns gate row r)
__global__ void lstm_recurrence_kernel(const float* __restrict__ gates,
                                       const float* __restrict__ w_t,
                                       float* __restrict__ h_out,
                                       int B, int T, int Hp) {
  extern __shared__ float smem[];
  const int G = 4 * Hp;
  float* w = smem;          // [Hp][G]
  float* h = w + Hp * G;    // [Hp]
  float* g = h + Hp;        // [G]

  const int seq = blockIdx.x;  // s * B + b
  const int s = seq / B;
  const int row = threadIdx.x;

  const float* wsrc = w_t + (size_t)s * Hp * G;
  for (int i = row; i < Hp * G; i += blockDim.x) w[i] = wsrc[i];
  for (int i = row; i < Hp; i += blockDim.x) h[i] = 0.0f;
  float c = 0.0f;
  __syncthreads();

  const float* gx = gates + (size_t)seq * T * G;
  float* ho = h_out + (size_t)seq * T * Hp;
  for (int t = 0; t < T; ++t) {
    float dot = 0.0f;
    for (int j = 0; j < Hp; ++j) dot = fmaf(h[j], w[j * G + row], dot);
    g[row] = gx[(size_t)t * G + row] + dot;
    __syncthreads();
    if (row < Hp) {
      const float ig = sigmoid_f(g[row]);
      const float fg = sigmoid_f(g[Hp + row]);
      const float gg = tanhf(g[2 * Hp + row]);
      const float og = sigmoid_f(g[3 * Hp + row]);
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      h[row] = hn;
      ho[(size_t)t * Hp + row] = hn;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int styler_lstm_smem_bytes(int Hp) {
  return (Hp * 4 * Hp + Hp + 4 * Hp) * (int)sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int styler_lstm_recurrence(const float* gates, const float* w_t,
                                      float* h_out, int S, int B, int T,
                                      int Hp, void* stream) {
  const int threads = 4 * Hp;
  const int smem = styler_lstm_smem_bytes(Hp);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  lstm_recurrence_kernel<<<S * B, threads, smem, (cudaStream_t)stream>>>(
      gates, w_t, h_out, B, T, Hp);
  return (int)cudaGetLastError();
}
