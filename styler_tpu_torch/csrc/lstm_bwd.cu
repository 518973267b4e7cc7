// BPTT backward of the LSTM recurrence over precomputed input gates, f32.
//
// Replaces the backward Pallas kernel of styler_tpu/ops/pallas_lstm.py
// (_vjp_bwd -> _run_backward/_bwd_kernel). From the gradient of every
// h[t] and the residuals the forward kernel saved (activated gates, c, h)
// it computes d(gates_x)[t] for every step and dW_hh.
//
// The TPU kernel walks its sequential grid backwards in time with the
// whole batch in one block and one resident dW block that every grid step
// adds to. Neither carries over to CUDA, so the work is split in two
// kernels, both in this file, launched back to back on one stream:
//
// 1. lstm_bptt_kernel: one CTA per (branch, direction, batch row) walks
//    its own sequence from t = T-1 down to 0, as the forward kernel walks
//    it upwards. dh and dc carries stay on chip (shared memory and a
//    register), w_hh stays resident in shared memory. Per step:
//        dh = dh_out[t] + dh_carry
//        dc = dh * o * (1 - tanh(c[t])^2) + dc_carry
//        di = dc*g*i*(1-i)   df = dc*c[t-1]*f*(1-f)
//        dg = dc*i*(1-g*g)   do = dh*tanh(c[t])*o*(1-o)
//        dh_carry = dgates . W^T      dc_carry = dc * f
//    with c[t-1] = 0 at t = 0. The product dgates . W^T contracts over
//    the 4*Hp gate rows, the axis along which the forward reads w_t
//    contiguously; read by Hp threads each walking one row of w_t it
//    would hit one shared-memory bank 32 ways. The rows are therefore
//    stored with a pitch of 4*Hp + 1 words, which spreads neighbouring
//    rows over neighbouring banks, and the contraction is cut into four
//    quarters (one per gate) so all 4*Hp threads work: thread (q, j) sums
//    gate q's Hp terms of output j, and the four partial sums are added
//    in a fixed order at the start of the next step.
//    The loads of step t-1 (acts, c, dh_out) are issued before the
//    product of step t, so their latency hides behind it.
//
// 2. lstm_dw_kernel: dW[j][r] = sum over (b, t) of h[t-1][j] * dgates[t][r].
//    This contraction runs over time AND over batch rows, which live in
//    different CTAs of kernel 1, and dW feeds nothing in the chain; so it
//    is taken off the T-step critical path and formed afterwards from the
//    emitted dgates and the saved forward h (shifted by one step, zero at
//    t = 0) by a tiled product: one CTA per 16 x 64 tile of dW walks all
//    B*T terms in order. No atomics and no split of the sum across CTAs,
//    so the result is deterministic.
//
// Bound on the H100: like the forward, the work is tiny (B*T*16*Hp^2
// FLOPs and ~44*Hp bytes per step and sequence), so the byte or FLOP
// bound is tens of microseconds; kernel 1 is bound by its T dependent
// steps (two __syncthreads and one Hp-term dot product each).
//
// Exact f32: fmaf sums, tanhf, no tensor cores, no TF32 (build without
// --use_fast_math), as the TPU kernel runs its products at HIGHEST.
// Padded units (u >= H) get exactly 0 in dgates and dW: their g = tanh 0
// = 0, c = 0, dh_out = 0, and their rows and columns of w_t are 0.

#include <cuda_runtime.h>

namespace {

// dh_out: [S, B, T, Hp]   acts: [S, B, T, 4*Hp] (i, f, g, o activated)
// c:      [S, B, T, Hp]   w_t:  [S, Hp, 4*Hp]
// dgates: [S, B, T, 4*Hp]
// grid = S*B CTAs, block = 4*Hp threads
__global__ void lstm_bptt_kernel(const float* __restrict__ dh_out,
                                 const float* __restrict__ acts,
                                 const float* __restrict__ c,
                                 const float* __restrict__ w_t,
                                 float* __restrict__ dgates,
                                 int B, int T, int Hp) {
  extern __shared__ float smem[];
  const int G = 4 * Hp;
  const int P = G + 1;         // row pitch of w in shared memory
  float* w = smem;             // [Hp][P]
  float* dg = w + Hp * P;      // [G]  dgates of the current step
  float* part = dg + G;        // [4][Hp] partial sums of dgates . W^T

  const int seq = blockIdx.x;  // s * B + b
  const int s = seq / B;
  const int tid = threadIdx.x;
  const int q = tid / Hp;      // gate quarter of the contraction
  const int j = tid - q * Hp;  // output unit

  const float* wsrc = w_t + (size_t)s * Hp * G;
  for (int i = tid; i < Hp * G; i += blockDim.x) {
    const int row = i / G;
    w[row * P + (i - row * G)] = wsrc[i];
  }
  part[tid] = 0.0f;  // dh_carry = 0 at t = T-1
  __syncthreads();

  const float* a_seq = acts + (size_t)seq * T * G;
  const float* c_seq = c + (size_t)seq * T * Hp;
  const float* dho_seq = dh_out + (size_t)seq * T * Hp;
  float* dg_seq = dgates + (size_t)seq * T * G;
  const bool unit = tid < Hp;  // threads that own one hidden unit

  // registers of the step about to run, loaded one step ahead
  float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, cc = 0.f, cp = 0.f, dho = 0.f;
  if (unit && T > 0) {
    const int t = T - 1;
    ig = a_seq[(size_t)t * G + tid];
    fg = a_seq[(size_t)t * G + Hp + tid];
    gg = a_seq[(size_t)t * G + 2 * Hp + tid];
    og = a_seq[(size_t)t * G + 3 * Hp + tid];
    cc = c_seq[(size_t)t * Hp + tid];
    cp = t > 0 ? c_seq[(size_t)(t - 1) * Hp + tid] : 0.0f;
    dho = dho_seq[(size_t)t * Hp + tid];
  }
  float dc_carry = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    float n_ig = 0.f, n_fg = 0.f, n_gg = 0.f, n_og = 0.f, n_cp = 0.f, n_dho = 0.f;
    if (unit) {
      const float dh = dho + (((part[tid] + part[Hp + tid]) + part[2 * Hp + tid]) +
                              part[3 * Hp + tid]);
      const float tanh_c = tanhf(cc);
      const float dc = dh * og * (1.0f - tanh_c * tanh_c) + dc_carry;
      const float di = dc * gg * ig * (1.0f - ig);
      const float df = dc * cp * fg * (1.0f - fg);
      const float dgg = dc * ig * (1.0f - gg * gg);
      const float dog = dh * tanh_c * og * (1.0f - og);
      dc_carry = dc * fg;
      dg[tid] = di;
      dg[Hp + tid] = df;
      dg[2 * Hp + tid] = dgg;
      dg[3 * Hp + tid] = dog;
      float* out = dg_seq + (size_t)t * G;
      out[tid] = di;
      out[Hp + tid] = df;
      out[2 * Hp + tid] = dgg;
      out[3 * Hp + tid] = dog;
      if (t > 0) {  // the next step's operands, in flight during the product
        const int tn = t - 1;
        n_ig = a_seq[(size_t)tn * G + tid];
        n_fg = a_seq[(size_t)tn * G + Hp + tid];
        n_gg = a_seq[(size_t)tn * G + 2 * Hp + tid];
        n_og = a_seq[(size_t)tn * G + 3 * Hp + tid];
        n_cp = tn > 0 ? c_seq[(size_t)(tn - 1) * Hp + tid] : 0.0f;
        n_dho = dho_seq[(size_t)tn * Hp + tid];
      }
    }
    __syncthreads();  // dg complete; every read of part is done
    {
      const float* wr = w + j * P + q * Hp;
      const float* dq = dg + q * Hp;
      float acc = 0.0f;
      for (int r = 0; r < Hp; ++r) acc = fmaf(dq[r], wr[r], acc);
      part[tid] = acc;  // part[q * Hp + j]
    }
    __syncthreads();  // part complete; dg may be overwritten
    if (unit) {
      cc = cp;  // c[t-1] is the next step's c[t]
      ig = n_ig; fg = n_fg; gg = n_gg; og = n_og; cp = n_cp; dho = n_dho;
    }
  }
}

// dW[s][j][r] = sum_k hprev[s][k][j] * dgates[s][k][r], k = b*T + t,
// hprev[k] = h[k-1] if t > 0 else 0.
// h: [S, B*T, Hp], dgates: [S, B*T, 4*Hp], dw: [S, Hp, 4*Hp]
// grid = (ceil(G/64), ceil(Hp/16), S), block = 16 x 16; thread (ty, tx)
// owns dW[j0 + ty][r0 + 4*tx .. +3].
constexpr int TJ = 16, TR = 64, KC = 32;

__global__ void lstm_dw_kernel(const float* __restrict__ h,
                               const float* __restrict__ dgates,
                               float* __restrict__ dw,
                               int BT, int T, int Hp) {
  __shared__ float hs[KC][TJ];
  __shared__ __align__(16) float ds[KC][TR];
  const int G = 4 * Hp;
  const int s = blockIdx.z;
  const int j0 = blockIdx.y * TJ;
  const int r0 = blockIdx.x * TR;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const float* h_s = h + (size_t)s * BT * Hp;
  const float* d_s = dgates + (size_t)s * BT * G;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < BT; k0 += KC) {
    // hs: KC x TJ values, 2 per thread
    for (int i = tid; i < KC * TJ; i += 256) {
      const int kk = i / TJ, jj = i - kk * TJ;
      const int k = k0 + kk, jcol = j0 + jj;
      float v = 0.0f;
      if (k < BT && jcol < Hp && (k % T) != 0) v = h_s[(size_t)(k - 1) * Hp + jcol];
      hs[kk][jj] = v;
    }
    // ds: KC x TR values as float4, 2 per thread (G is a multiple of 4)
    for (int i = tid; i < KC * (TR / 4); i += 256) {
      const int kk = i / (TR / 4), rr = (i - kk * (TR / 4)) * 4;
      const int k = k0 + kk, r = r0 + rr;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < BT && r < G) v = *reinterpret_cast<const float4*>(d_s + (size_t)k * G + r);
      *reinterpret_cast<float4*>(&ds[kk][rr]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float a = hs[kk][ty];
      const float4 d = *reinterpret_cast<const float4*>(&ds[kk][4 * tx]);
      acc[0] = fmaf(a, d.x, acc[0]);
      acc[1] = fmaf(a, d.y, acc[1]);
      acc[2] = fmaf(a, d.z, acc[2]);
      acc[3] = fmaf(a, d.w, acc[3]);
    }
    __syncthreads();
  }
  const int jrow = j0 + ty, r = r0 + 4 * tx;
  if (jrow < Hp && r < G) {
    *reinterpret_cast<float4*>(dw + ((size_t)s * Hp + jrow) * G + r) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

}  // namespace

extern "C" int styler_lstm_bwd_smem_bytes(int Hp) {
  return (Hp * (4 * Hp + 1) + 4 * Hp + 4 * Hp) * (int)sizeof(float);
}

// Launches both kernels on the stream. Returns the first nonzero
// cudaError_t (0 on success).
extern "C" int styler_lstm_backward(const float* dh_out, const float* acts,
                                    const float* c, const float* h,
                                    const float* w_t, float* dgates,
                                    float* dw_t, int S, int B, int T, int Hp,
                                    void* stream) {
  const int smem = styler_lstm_bwd_smem_bytes(Hp);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bptt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lstm_bptt_kernel<<<S * B, 4 * Hp, smem, (cudaStream_t)stream>>>(
      dh_out, acts, c, w_t, dgates, B, T, Hp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int G = 4 * Hp;
  dim3 grid((G + TR - 1) / TR, (Hp + TJ - 1) / TJ, S);
  lstm_dw_kernel<<<grid, dim3(16, 16), 0, (cudaStream_t)stream>>>(
      h, dgates, dw_t, B * T, T, Hp);
  return (int)cudaGetLastError();
}
