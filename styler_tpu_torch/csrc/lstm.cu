// LSTM recurrence over precomputed input gates, f32 throughout.
//
// Replaces the forward Pallas kernel of styler_tpu/ops/pallas_lstm.py
// (lstm_recurrence_pallas -> _run_forward/_fwd_kernel). One CTA runs one
// whole sequence: the loop over time inside the CTA takes the place of
// the TPU's sequential grid, w_hh stays on chip and h/c never leave it.
// One launch covers every (branch, direction, batch row) of a BiLSTM
// layer, each branch zero-padded to the widest hidden size Hp; padded
// units stay exactly 0 (their gates are 0, so c = 0.5*c + 0.5*tanh(0) = 0
// and h = 0.5*tanh(0) = 0).
//
// Bound on the H100: the work is tiny (2*4H*H FLOPs and 16H bytes per
// step), so the bound in bytes or FLOPs is microseconds; what limits the
// kernel is the T-step dependency chain, and each step's cost is its
// on-chip latency: the Hp-term dot product of every gate row, the
// nonlinearities and one barrier.
//
// Design (plan instance "registers", Hp rounded up to W = 8..96): the
// 4*W threads of a CTA are laid out so that the four lanes of unit u are
// neighbours (lane = 4*(u mod 8) + k, warp = u / 8), and they hold the W
// weights of u's four gate rows in registers, loaded once; the width is a
// template parameter, so the product is fully unrolled. What bounds the
// product is not the FMAs but shared memory's 128 bytes a clock to the
// registers: if each lane read all of h for one gate row, a step would
// move 4*W*W words. So lane k reads only slice k of h (W/4 words, as
// float4) and forms partial sums of all four gate rows over it: W^2 words
// a step, 4x less. A reduce-scatter of three __shfl_xor_sync adds, in one
// fixed order, leaves gate k of u in lane k, which applies its gate's
// nonlinearity; the lanes of a unit exchange the four gates by
// __shfl_sync and each computes c and h (the same instructions on the same
// values, so the four copies agree bit for bit), and h goes into the
// other half of a double buffer of h: one __syncthreads per step. The
// step's input gate is loaded two steps ahead into one of two registers
// that alternate by step.
//
// Widths above 96 do not fit the register file (4*W threads x W weights).
// They run a runtime-width kernel with the same lane layout and the same
// one-barrier step, reading the weights through a pointer: instance
// "shared" copies them into shared memory when they fit (rows of pitch
// 4P + 1 floats, P the quarter pitch below, so the 32 lanes of a warp hit
// 32 different banks), instance "global" reads them from w_t itself
// (L1/L2-resident) when they do not (W > 120). The instance is chosen by
// the wrapper (ops/lstm.py:lstm_plan) from Hp alone; a launch of an
// instance that does not fit fails and the wrapper raises.
//
// Exact f32: no tensor cores, no TF32, expf/tanhf (build without
// --use_fast_math). The dot product is summed first and then added to
// the input gate, as jnp.dot(h, w_hh.T) + gx is in the reference.
//
// Two forms of each kernel. The serving form stores h only. The training
// form (kSave) also stores c[t] and the activated gates (i, f, g, o) of
// every step, which the BPTT kernel (lstm_bwd.cu) reads, as the Pallas
// forward kernel returns them as residuals of its custom VJP. The flag
// is a template parameter, so the serving launch pays nothing for it; h
// is computed by the same instructions in both forms.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRegWidth = 96;
constexpr int kMaxHp = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use
enum Instance { kRegisters = 0, kShared = 1, kGlobal = 2 };

__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }
// pitch of one gate quarter of a row of the wide kernel's weight copy: an
// odd multiple of 8 floats, so with rows of 4P + 1 floats the 32 lanes of
// a warp read 32 different banks
__host__ __device__ constexpr int quarter_pitch(int w) { return (w / 8) % 2 ? w : w + 8; }

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One step's gate: gx + dot, the lane's nonlinearity, the gather of the
// unit's four gates and the cell update. Returns the lane's activated gate
// and updates c; h = o * tanh(c) is returned through hn.
__device__ __forceinline__ float lstm_cell(float pre, int k, int base, float& c,
                                           float& hn) {
  const float sg = sigmoid_f(pre);
  const float th = tanhf(pre);
  const float a = k == 2 ? th : sg;
  const float ig = __shfl_sync(kFull, a, base);
  const float fg = __shfl_sync(kFull, a, base + 1);
  const float gg = __shfl_sync(kFull, a, base + 2);
  const float og = __shfl_sync(kFull, a, base + 3);
  c = fmaf(fg, c, __fmul_rn(ig, gg));
  hn = __fmul_rn(og, tanhf(c));
  return a;
}

// Register instance geometry at width W: the Hp terms of a gate row are
// cut into 4 slices of L (a multiple of 4, 4L >= W); slice s of h sits at
// s*SP in shared memory, SP an odd multiple of 4 so the four slices'
// float4 reads of one warp fall into four different groups of banks.
__host__ __device__ constexpr int slice_len(int w) { return (w / 4 + 3) / 4 * 4; }
__host__ __device__ constexpr int slice_pitch(int l) { return l % 8 == 4 ? l : l + 4; }

// gates: [S, B, T, 4*Hp]  (torch gate order i, f, g, o; gate k of unit u
//                          at k*Hp + u)
// w_t:   [S, Hp, 4*Hp]    (w_t[s][j][r] = w_hh[r][j] of sequence group s)
// h_out: [S, B, T, Hp]
// c_out: [S, B, T, Hp], acts_out: [S, B, T, 4*Hp]  (training form only)
// grid = S*B CTAs, block = 4*W threads, W = Hp rounded up to 8.
// Lane (u, s) holds the weights of unit u's four gate rows over slice s
// of h, w_t[s*L + i][k*Hp + u]; after the product, a reduce-scatter over
// the four lanes of u leaves gate s of u in lane s.
template <int W, bool kSave>
__global__ void __launch_bounds__(4 * W, 1)
    lstm_recurrence_kernel(const float* __restrict__ gates,
                           const float* __restrict__ w_t,
                           float* __restrict__ h_out, float* __restrict__ c_out,
                           float* __restrict__ acts_out, int B, int T, int Hp) {
  constexpr int L = slice_len(W);
  constexpr int SP = slice_pitch(L);
  __shared__ __align__(16) float hbuf[2][4 * SP];
  const int G = 4 * Hp;
  const int seq = blockIdx.x;  // s * B + b
  const int s = seq / B;
  const int lane = threadIdx.x & 31;
  const int u = (threadIdx.x >> 5) * 8 + (lane >> 2);
  const int k = lane & 3;  // h slice of the product; gate after the reduce-scatter
  const int base = lane & ~3;
  const bool live = u < Hp;
  const int row = k * Hp + u;

  float w[4][L];
  const float* wsrc = w_t + (size_t)s * Hp * G + u;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int j = k * L + i;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      w[g][i] = (live && j < Hp) ? wsrc[(size_t)j * G + g * Hp] : 0.0f;
  }
  for (int i = threadIdx.x; i < 8 * SP; i += blockDim.x) (&hbuf[0][0])[i] = 0.0f;

  const float* gx = gates + (size_t)seq * T * G + row;
  float* ho = h_out + (size_t)seq * T * Hp + u;
  float* hslot = &hbuf[0][(u / L) * SP + u % L];  // where unit u's h goes
  float c = 0.0f;
  // One step. gxt holds the step's input gate; once it is consumed, it
  // is reloaded with step t + 2's, in the same register.
  auto step = [&](int t, float& gxt) {
    const int buf = t & 1;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < L; i += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&hbuf[buf][k * SP + i]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[g] = fmaf(hv.x, w[g][i], acc[g]);
        acc[g] = fmaf(hv.y, w[g][i + 1], acc[g]);
        acc[g] = fmaf(hv.z, w[g][i + 2], acc[g]);
        acc[g] = fmaf(hv.w, w[g][i + 3], acc[g]);
      }
    }
    // reduce-scatter over the lanes of u: lanes k and k^2 swap the halves
    // of the gates they do not keep, then k and k^1 the gate they do not
    const bool hi = k & 2, odd = k & 1;
    const float p0 = (hi ? acc[2] : acc[0]) + __shfl_xor_sync(kFull, hi ? acc[0] : acc[2], 2);
    const float p1 = (hi ? acc[3] : acc[1]) + __shfl_xor_sync(kFull, hi ? acc[1] : acc[3], 2);
    const float dot = (odd ? p1 : p0) + __shfl_xor_sync(kFull, odd ? p0 : p1, 1);
    float hn;
    const float a = lstm_cell(gxt + dot, k, base, c, hn);
    gxt = (live && t + 2 < T) ? gx[(size_t)(t + 2) * G] : 0.0f;
    if (live) {
      if (k == 0) {
        hslot[(buf ^ 1) * 4 * SP] = hn;
        ho[(size_t)t * Hp] = hn;
      }
      if (kSave) {
        acts_out[((size_t)seq * T + t) * G + row] = a;
        if (k == 1) c_out[((size_t)seq * T + t) * Hp + u] = c;
      }
    }
    __syncthreads();
  };
  // two steps per iteration, each with its own register of input gates,
  // so no register is copied while its load is in flight
  float gx_even = (live && T > 0) ? gx[0] : 0.0f;
  float gx_odd = (live && T > 1) ? gx[G] : 0.0f;
  __syncthreads();
  for (int t = 0; t < T; t += 2) {
    step(t, gx_even);
    if (t + 1 < T) step(t + 1, gx_odd);
  }
}

// Widths whose weights do not fit the register file: the same step with
// the weights behind a pointer, either a copy in shared memory (kSharedW:
// row of gate row (u, k) at u*(4P+1) + k*P) or w_t itself (row at k*Hp +
// u, stride 4*Hp between terms). Where the weights live is a template
// parameter, so the shared instance issues shared-memory loads, not
// generic ones. Dynamic shared memory: h[2][W], then the weight copy if
// any. grid = S*B, block = 4*W threads (W <= 256).
template <bool kSave, bool kSharedW>
__global__ void __launch_bounds__(1024)
    lstm_recurrence_wide_kernel(const float* __restrict__ gates,
                                const float* __restrict__ w_t,
                                float* __restrict__ h_out, float* __restrict__ c_out,
                                float* __restrict__ acts_out, int B, int T, int Hp) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * Hp;
  const int W = round8(Hp);
  const int P = quarter_pitch(W);
  const int R = 4 * P + 1;
  float* hbuf = smem;  // [2][W]
  const int seq = blockIdx.x;
  const int s = seq / B;
  const int lane = threadIdx.x & 31;
  const int u = (threadIdx.x >> 5) * 8 + (lane >> 2);
  const int k = lane & 3;
  const int base = lane & ~3;
  const bool live = u < Hp;
  const int row = k * Hp + u;

  const float* wsrc = w_t + (size_t)s * Hp * G;
  const float* wp;
  if constexpr (kSharedW) {
    float* ws = smem + 2 * W;
    for (int i = threadIdx.x; i < Hp * G; i += blockDim.x) {
      const int j = i / G, r = i - j * G;
      const int kk = r / Hp, uu = r - kk * Hp;
      ws[uu * R + kk * P + j] = wsrc[i];
    }
    wp = ws + u * R + k * P;
  } else {
    wp = wsrc + row;
  }
  const int stride = kSharedW ? 1 : G;
  for (int i = threadIdx.x; i < 2 * W; i += blockDim.x) hbuf[i] = 0.0f;

  const float* gx = gates + (size_t)seq * T * G + row;
  float* ho = h_out + (size_t)seq * T * Hp + u;
  float gx0 = (live && T > 0) ? gx[0] : 0.0f;
  float gx1 = (live && T > 1) ? gx[G] : 0.0f;
  float c = 0.0f;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* hb = hbuf + (t & 1) * W;
    const float gx2 = (live && t + 2 < T) ? gx[(size_t)(t + 2) * G] : 0.0f;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (live) {
      int j = 0;
      for (; j + 4 <= Hp; j += 4) {
        a0 = fmaf(hb[j], wp[j * stride], a0);
        a1 = fmaf(hb[j + 1], wp[(j + 1) * stride], a1);
        a2 = fmaf(hb[j + 2], wp[(j + 2) * stride], a2);
        a3 = fmaf(hb[j + 3], wp[(j + 3) * stride], a3);
      }
      for (; j < Hp; ++j) a0 = fmaf(hb[j], wp[j * stride], a0);
    }
    float hn;
    const float a = lstm_cell(gx0 + ((a0 + a1) + (a2 + a3)), k, base, c, hn);
    if (live) {
      if (k == 0) {
        hbuf[((t & 1) ^ 1) * W + u] = hn;
        ho[(size_t)t * Hp] = hn;
      }
      if (kSave) {
        acts_out[((size_t)seq * T + t) * G + row] = a;
        if (k == 1) c_out[((size_t)seq * T + t) * Hp + u] = c;
      }
    }
    __syncthreads();
    gx0 = gx1;
    gx1 = gx2;
  }
}

// The per-step latency floor of a one-CTA recurrence: T steps of one
// float4 broadcast read from a double buffer, one store into the other
// half and one barrier, with no arithmetic. grid = ctas, block = threads.
__global__ void lstm_step_probe_kernel(float* __restrict__ out, int T) {
  __shared__ __align__(16) float buf[2][4];
  if (threadIdx.x < 8) (&buf[0][0])[threadIdx.x] = 0.0f;
  __syncthreads();
  float v = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float4 x = *reinterpret_cast<const float4*>(buf[t & 1]);
    v = x.x;
    if (threadIdx.x == 0) buf[(t & 1) ^ 1][0] = x.y;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

using Kernel = void (*)(const float*, const float*, float*, float*, float*, int, int, int);

template <bool kSave>
Kernel register_kernel(int W) {
  switch (W) {
#define STYLER_LSTM_CASE(w) \
  case w:                   \
    return lstm_recurrence_kernel<w, kSave>;
    STYLER_LSTM_CASE(8) STYLER_LSTM_CASE(16) STYLER_LSTM_CASE(24)
    STYLER_LSTM_CASE(32) STYLER_LSTM_CASE(40) STYLER_LSTM_CASE(48)
    STYLER_LSTM_CASE(56) STYLER_LSTM_CASE(64) STYLER_LSTM_CASE(72)
    STYLER_LSTM_CASE(80) STYLER_LSTM_CASE(88) STYLER_LSTM_CASE(96)
#undef STYLER_LSTM_CASE
    default:
      return nullptr;
  }
}

struct Plan {
  Kernel fn;
  int threads;
  int smem;  // dynamic shared memory bytes
};

cudaError_t plan_for(int instance, int Hp, bool save, Plan* p) {
  if (Hp < 1 || Hp > kMaxHp) return cudaErrorInvalidValue;
  const int W = round8(Hp);
  p->threads = 4 * W;
  p->smem = 0;
  if (instance == kRegisters) {
    if (W > kMaxRegWidth) return cudaErrorInvalidValue;
    p->fn = save ? register_kernel<true>(W) : register_kernel<false>(W);
    return cudaSuccess;
  }
  if (instance == kShared) {
    p->fn = save ? (Kernel)lstm_recurrence_wide_kernel<true, true>
                 : (Kernel)lstm_recurrence_wide_kernel<false, true>;
  } else if (instance == kGlobal) {
    p->fn = save ? (Kernel)lstm_recurrence_wide_kernel<true, false>
                 : (Kernel)lstm_recurrence_wide_kernel<false, false>;
  } else {
    return cudaErrorInvalidValue;
  }
  const int P = quarter_pitch(W);
  p->smem = (2 * W + (instance == kShared ? W * (4 * P + 1) : 0)) * (int)sizeof(float);
  return p->smem <= kSmemLimit ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(int instance, bool save, const float* gates, const float* w_t,
                   float* h_out, float* c_out, float* acts_out, int S, int B, int T,
                   int Hp, void* stream) {
  Plan p;
  cudaError_t err = plan_for(instance, Hp, save, &p);
  if (err != cudaSuccess) return err;
  if (p.smem > 0) {
    err = cudaFuncSetAttribute((const void*)p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return err;
  }
  p.fn<<<S * B, p.threads, p.smem, (cudaStream_t)stream>>>(gates, w_t, h_out, c_out, acts_out,
                                                           B, T, Hp);
  return cudaGetLastError();
}

}  // namespace

// What a launch of `instance` (0 registers, 1 shared, 2 global) at width
// Hp runs: out = {threads per CTA, shared memory bytes (static + dynamic),
// registers per thread}. Returns a CUDA error (cudaErrorInvalidValue for
// an instance that does not take this width).
extern "C" int styler_lstm_plan(int instance, int Hp, int save, int* out) {
  Plan p;
  cudaError_t err = plan_for(instance, Hp, save != 0, &p);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, (const void*)p.fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.threads;
  out[1] = (int)a.sharedSizeBytes + p.smem;
  out[2] = a.numRegs;
  return 0;
}

// Serving form. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int styler_lstm_recurrence(const float* gates, const float* w_t,
                                      float* h_out, int S, int B, int T, int Hp,
                                      int instance, void* stream) {
  return (int)launch(instance, false, gates, w_t, h_out, nullptr, nullptr, S, B, T, Hp,
                     stream);
}

// Training form: also stores c and the activated gates of every step.
extern "C" int styler_lstm_recurrence_train(const float* gates, const float* w_t,
                                            float* h_out, float* c_out,
                                            float* acts_out, int S, int B, int T,
                                            int Hp, int instance, void* stream) {
  return (int)launch(instance, true, gates, w_t, h_out, c_out, acts_out, S, B, T, Hp,
                     stream);
}

// The empty-step probe (measurement only): `ctas` CTAs of `threads`
// threads run T empty steps; out[ctas] receives one float per CTA.
extern "C" int styler_lstm_step_probe(float* out, int ctas, int T, int threads,
                                      void* stream) {
  lstm_step_probe_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>(out, T);
  return (int)cudaGetLastError();
}
