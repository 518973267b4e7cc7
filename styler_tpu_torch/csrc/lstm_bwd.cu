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
// parts, both in this file, launched back to back on one stream:
//
// 1. lstm_bptt_kernel, the walk: one CTA per (branch, direction, batch
//    row) walks its own sequence from t = T-1 down to 0, as the forward
//    kernel walks it upwards, with dh and dc carried on chip. Per step:
//        dh = dh_out[t] + dh_carry
//        dc = dh * o * (1 - tanh(c[t])^2) + dc_carry
//        di = dc*g*i*(1-i)   df = dc*c[t-1]*f*(1-f)
//        dg = dc*i*(1-g*g)   do = dh*tanh(c[t])*o*(1-o)
//        dh_carry = dgates . W^T      dc_carry = dc * f
//    with c[t-1] = 0 at t = 0. Its cost is the latency of T dependent
//    steps. Design (plan instance "registers", Hp rounded up to W =
//    8..96): the four gate quarters q of unit j sit in four neighbouring
//    lanes (lane = 4*(j mod 8) + q, warp = j / 8). Each lane computes dc
//    (the four lanes of a unit run the same instructions on the same
//    values, so they agree bit for bit) and its own d(gate) q, and writes
//    it into one half of a double buffer of dg in shared memory; then the
//    step's one __syncthreads. The product dh_carry = dg . W^T holds W in
//    registers (loaded once; the width is a template parameter, so it is
//    fully unrolled). What bounds it is not the FMAs but shared memory's
//    128 bytes a clock to the registers: a lane that reads all 4*W terms
//    of dg for one output would move 4*W*W*16 bytes a step. So each
//    half-warp takes 4 units and each of its 16 lanes one 16th of dg
//    (float4 reads), forming 4 partial sums from its 4 x W/4 weights: W^2
//    words a step, 4x less. A reduce-scatter of __shfl_xor_sync adds over
//    the 16 lanes, in one fixed order, leaves each unit's sum in its 4
//    elementwise lanes. The operands of a step are loaded two steps ahead,
//    into one of two sets of registers that alternate by step.
//    Widths above 96 run a runtime-width kernel with the same layout and
//    step, the weights in shared memory where they fit (instance
//    "shared", rows of pitch 4P + 1 so a warp's 32 lanes hit 32 banks) or
//    read from w_t itself (instance "global", W > 112).
//
// 2. dW[j][r] = sum over (b, t) of h[t-1][j] * dgates[t][r]. This
//    contraction runs over time AND over batch rows, which live in
//    different CTAs of the walk, and dW feeds nothing in the chain; so it
//    is taken off the T-step critical path and formed afterwards from the
//    emitted dgates and the saved forward h (shifted by one step, a zero
//    row at t = 0) by a tiled f32 product, lstm_dw_kernel: a CTA owns a
//    TJ x 64 tile of dW (TJ = Hp rounded up to 16, or half of it above
//    128, so dgates is read once), 4 x 4 outputs per thread, and walks its
//    batch rows in chunks of 32 steps through a 4-chunk cp.async ring. The
//    sum over batch rows is split into groups of rows (split K) so the
//    grid fills the card; each group writes its own partial tile, and
//    lstm_dw_sum_kernel adds the partials in a fixed order. No atomics, so
//    dW is deterministic.
//
// Bound on the H100: like the forward, the work is tiny (B*T*16*Hp^2
// FLOPs and ~44*Hp bytes per step and sequence), so the byte or FLOP
// bound is tens of microseconds; the walk is bound by its T dependent
// steps, the dW product by f32 FMA throughput (no tensor cores).
//
// Exact f32: fmaf sums, tanhf, no tensor cores, no TF32 (build without
// --use_fast_math), as the TPU kernel runs its products at HIGHEST.
// Padded units (u >= H) get exactly 0 in dgates and dW: their g = tanh 0
// = 0, c = 0, dh_out = 0, and their rows and columns of w_t are 0.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRegWidth = 96;
constexpr int kMaxHp = 256;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use
enum Instance { kRegisters = 0, kShared = 1, kGlobal = 2 };

__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }
// pitch of one gate quarter of dg in the wide kernel's shared memory: an
// odd multiple of 8 floats (rows of the weight copy then hit 32 banks)
__host__ __device__ constexpr int quarter_pitch(int w) { return (w / 8) % 2 ? w : w + 8; }

// cp.async copies into shared memory; an invalid copy writes zeros and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The operands of one step of one unit.
struct StepIn {
  float i, f, g, o, c, cp, dho;
};

__device__ __forceinline__ StepIn load_step(const float* a_seq, const float* c_seq,
                                            const float* dho_seq, int t, int j, int Hp,
                                            bool live) {
  StepIn x = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live && t >= 0) {
    const float* a = a_seq + (size_t)t * 4 * Hp + j;
    x.i = a[0];
    x.f = a[Hp];
    x.g = a[2 * Hp];
    x.o = a[3 * Hp];
    x.c = c_seq[(size_t)t * Hp + j];
    x.cp = t > 0 ? c_seq[(size_t)(t - 1) * Hp + j] : 0.0f;
    x.dho = dho_seq[(size_t)t * Hp + j];
  }
  return x;
}

// The elementwise backward of one step: returns d(gate q) and updates
// dc_carry. dh = dh_out[t] + dh_carry.
__device__ __forceinline__ float cell_backward(const StepIn& x, float dh, int q,
                                               float& dc_carry) {
  const float tc = tanhf(x.c);
  const float dc = dh * x.o * (1.0f - tc * tc) + dc_carry;
  const float di = dc * x.g * x.i * (1.0f - x.i);
  const float df = dc * x.cp * x.f * (1.0f - x.f);
  const float dgg = dc * x.i * (1.0f - x.g * x.g);
  const float dog = dh * tc * x.o * (1.0f - x.o);
  dc_carry = dc * x.f;
  return q == 0 ? di : q == 1 ? df : q == 2 ? dgg : dog;
}

// The sum of the four lanes' partials, in one fixed order, in all four.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v;
}

// Register instance geometry at width W: the 4*W terms of dh_carry[j]
// (d(gates) in the order q*W + j, padded per quarter to W) are cut into 16
// slices of L (a multiple of 4, 16L >= 4W); slice r of dg sits at r*SP in
// shared memory, SP an odd multiple of 4 so the float4 reads of any 8
// slices fall into 8 different groups of banks.
__host__ __device__ constexpr int slice_len(int w) { return (w / 4 + 3) / 4 * 4; }
__host__ __device__ constexpr int slice_pitch(int l) { return l % 8 == 4 ? l : l + 4; }

// dh_out: [S, B, T, Hp]   acts: [S, B, T, 4*Hp] (i, f, g, o activated)
// c:      [S, B, T, Hp]   w_t:  [S, Hp, 4*Hp]
// dgates: [S, B, T, 4*Hp]
// grid = S*B CTAs, block = 4*W threads.
// The elementwise part runs on lane (j, q): lane = 4*(j mod 8) + q. The
// product runs on the same lanes regrouped: each half-warp owns 4 units
// j0..j0+3 (j0 = 4 * (threadIdx.x / 16)), and its lane r holds their
// weights over slice r of dg, w_t[j0 + o][slice r]; a reduce-scatter over
// the 16 lanes leaves unit j0 + o's sum in lanes 4o..4o+3, the lanes of
// that unit's elementwise part.
template <int W>
__global__ void __launch_bounds__(4 * W, 1)
    lstm_bptt_kernel(const float* __restrict__ dh_out, const float* __restrict__ acts,
                     const float* __restrict__ c, const float* __restrict__ w_t,
                     float* __restrict__ dgates, int B, int T, int Hp) {
  constexpr int L = slice_len(W);
  constexpr int SP = slice_pitch(L);
  __shared__ __align__(16) float dgs[2][16 * SP];
  const int G = 4 * Hp;
  const int seq = blockIdx.x;  // s * B + b
  const int s = seq / B;
  const int lane = threadIdx.x & 31;
  const int j = (threadIdx.x >> 5) * 8 + (lane >> 2);
  const int q = lane & 3;
  const bool live = j < Hp;
  const int r16 = lane & 15;               // dg slice of the product
  const int j0 = (threadIdx.x >> 4) * 4;   // first unit of the half-warp

  float w[4][L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int r = r16 * L + i;  // q' * W + jj
    const int qq = r / W, jj = r - qq * W;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int jo = j0 + o;
      w[o][i] = (qq < 4 && jj < Hp && jo < Hp)
                    ? w_t[((size_t)s * Hp + jo) * G + qq * Hp + jj] : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < 32 * SP; i += blockDim.x) (&dgs[0][0])[i] = 0.0f;
  __syncthreads();

  const float* a_seq = acts + (size_t)seq * T * G;
  const float* c_seq = c + (size_t)seq * T * Hp;
  const float* dho_seq = dh_out + (size_t)seq * T * Hp;
  float* dg_seq = dgates + (size_t)seq * T * G + q * Hp + j;
  const int r_own = q * W + j;  // where this lane's d(gate) goes
  float* dg_slot = &dgs[0][(r_own / L) * SP + r_own % L];

  float dh_carry = 0.0f, dc_carry = 0.0f;
  // One step. x holds the step's operands; once they are consumed, it is
  // reloaded with step t - 2's, in the same registers.
  auto step = [&](int t, StepIn& x) {
    const int buf = t & 1;
    const float dq = cell_backward(x, x.dho + dh_carry, q, dc_carry);
    dg_slot[buf * 16 * SP] = dq;  // 0 for the padding lanes j >= Hp
    if (live) dg_seq[(size_t)t * G] = dq;
    x = load_step(a_seq, c_seq, dho_seq, t - 2, j, Hp, live);
    __syncthreads();  // dg[t & 1] complete; dg[(t & 1) ^ 1] free again
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < L; i += 4) {
      const float4 d = *reinterpret_cast<const float4*>(&dgs[buf][r16 * SP + i]);
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        acc[o] = fmaf(d.x, w[o][i], acc[o]);
        acc[o] = fmaf(d.y, w[o][i + 1], acc[o]);
        acc[o] = fmaf(d.z, w[o][i + 2], acc[o]);
        acc[o] = fmaf(d.w, w[o][i + 3], acc[o]);
      }
    }
    // reduce-scatter over the 16 slices: lanes r and r^8 swap the halves
    // of the units they do not keep, r and r^4 the unit they do not; then
    // the four lanes of the unit add up, in one fixed order
    const bool b3 = r16 & 8, b2 = r16 & 4;
    const float p0 = (b3 ? acc[2] : acc[0]) + __shfl_xor_sync(kFull, b3 ? acc[0] : acc[2], 8);
    const float p1 = (b3 ? acc[3] : acc[1]) + __shfl_xor_sync(kFull, b3 ? acc[1] : acc[3], 8);
    const float v = (b2 ? p1 : p0) + __shfl_xor_sync(kFull, b2 ? p0 : p1, 4);
    dh_carry = quad_sum(v);
  };
  // two steps per iteration, each with its own registers of operands, so
  // no register is copied while its load is in flight
  StepIn x_a = load_step(a_seq, c_seq, dho_seq, T - 1, j, Hp, live);
  StepIn x_b = load_step(a_seq, c_seq, dho_seq, T - 2, j, Hp, live);
  for (int t = T - 1; t >= 0; t -= 2) {
    step(t, x_a);
    if (t > 0) step(t - 1, x_b);
  }
}

// Widths whose weights do not fit the register file: the same walk with
// the weights behind a pointer, either a copy in shared memory (kSharedW:
// lane (j, q)'s row at j*(4P+1) + q*P) or w_t itself. Where the weights
// live is a template parameter, so the shared instance issues
// shared-memory loads, not generic ones. Dynamic shared memory: dg[2][4P],
// then the weight copy if any. grid = S*B, block = 4*W threads.
template <bool kSharedW>
__global__ void __launch_bounds__(1024)
    lstm_bptt_wide_kernel(const float* __restrict__ dh_out, const float* __restrict__ acts,
                          const float* __restrict__ c, const float* __restrict__ w_t,
                          float* __restrict__ dgates, int B, int T, int Hp) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * Hp;
  const int W = round8(Hp);
  const int P = quarter_pitch(W);
  const int R = 4 * P + 1;
  const int seq = blockIdx.x;
  const int s = seq / B;
  const int lane = threadIdx.x & 31;
  const int j = (threadIdx.x >> 5) * 8 + (lane >> 2);
  const int q = lane & 3;
  const bool live = j < Hp;

  const float* wsrc = w_t + (size_t)s * Hp * G;
  const float* wp;
  if constexpr (kSharedW) {
    float* ws = smem + 8 * P;
    for (int i = threadIdx.x; i < Hp * G; i += blockDim.x) {
      const int jj = i / G, r = i - jj * G;
      const int qq = r / Hp;
      ws[jj * R + qq * P + (r - qq * Hp)] = wsrc[i];
    }
    wp = ws + j * R + q * P;
  } else {
    wp = wsrc + (size_t)j * G + q * Hp;
  }
  __syncthreads();

  const float* a_seq = acts + (size_t)seq * T * G;
  const float* c_seq = c + (size_t)seq * T * Hp;
  const float* dho_seq = dh_out + (size_t)seq * T * Hp;
  float* dg_seq = dgates + (size_t)seq * T * G + q * Hp + j;

  StepIn cur = load_step(a_seq, c_seq, dho_seq, T - 1, j, Hp, live);
  StepIn nxt = load_step(a_seq, c_seq, dho_seq, T - 2, j, Hp, live);
  float dh_carry = 0.0f, dc_carry = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const float* dgb = smem + (t & 1) * 4 * P + q * P;
    const StepIn ahead = load_step(a_seq, c_seq, dho_seq, t - 2, j, Hp, live);
    const float dq = cell_backward(cur, cur.dho + dh_carry, q, dc_carry);
    smem[(t & 1) * 4 * P + q * P + j] = dq;
    if (live) dg_seq[(size_t)t * G] = dq;
    __syncthreads();
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (live) {
      int r = 0;
      for (; r + 4 <= Hp; r += 4) {
        a0 = fmaf(dgb[r], wp[r], a0);
        a1 = fmaf(dgb[r + 1], wp[r + 1], a1);
        a2 = fmaf(dgb[r + 2], wp[r + 2], a2);
        a3 = fmaf(dgb[r + 3], wp[r + 3], a3);
      }
      for (; r < Hp; ++r) a0 = fmaf(dgb[r], wp[r], a0);
    }
    dh_carry = quad_sum((a0 + a1) + (a2 + a3));
    cur = nxt;
    nxt = ahead;
  }
}

// ---------------------------------------------------------------- dW --

constexpr int DW_TR = 64;  // dW columns (gate rows r) per CTA
constexpr int DW_KC = 32;     // steps per chunk
constexpr int DW_STAGES = 4;  // chunks in the cp.async ring

// dW[s][j][r] = sum over the batch rows b of split `sp` and all t of
// h[s][b][t-1][j] * dgates[s][b][t][r] (h[-1] = 0).
// h: [S, B, T, Hp], dgates: [S, B, T, 4*Hp]
// out: dw [S, Hp, 4*Hp] (one split) or partials [S, splits, Hp, 4*Hp]
// grid = (ceil(4*Hp / 64), ceil(Hp / TJ), S * splits), block = 4*TJ;
// thread (tj, tr) owns dW[j0 + 4*tj .. +3][r0 + 4*tr .. +3]. Dynamic
// shared memory: a ring of DW_STAGES chunks, h [DW_STAGES][DW_KC][TJ]
// and dgates [DW_STAGES][DW_KC][64]; DW_STAGES - 1 chunks are in flight
// while one is multiplied.
__global__ void __launch_bounds__(512)
    lstm_dw_kernel(const float* __restrict__ h, const float* __restrict__ dgates,
                   float* __restrict__ out, int B, int T, int Hp, int TJ, int splits) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                             // [DW_STAGES][DW_KC][TJ]
  float* ds = smem + DW_STAGES * DW_KC * TJ;    // [DW_STAGES][DW_KC][DW_TR]
  const int G = 4 * Hp;
  const int s = blockIdx.z / splits;
  const int sp = blockIdx.z - s * splits;
  const int rows = (B + splits - 1) / splits;
  const int b0 = sp * rows;
  const int b1 = min(B, b0 + rows);
  const int j0 = blockIdx.y * TJ;
  const int r0 = blockIdx.x * DW_TR;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;  // 4 * TJ
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (lane & 7) + 8 * (warp & 1);
  const int tj = (lane >> 3) + 4 * (warp >> 1);
  // this thread's share of a chunk's h loads: column jj, rows kk0, +4, ...
  const int jj = tid % TJ, kk0 = tid / TJ;

  const int tchunks = (T + DW_KC - 1) / DW_KC;
  const int nchunks = (b1 - b0) * tchunks;

  auto load = [&](int n, int buf) {
    const int b = b0 + n / tchunks;
    const int t0 = (n % tchunks) * DW_KC;
    const size_t seq_row = ((size_t)s * B + b) * T;
    float* hb = hs + buf * DW_KC * TJ;
    float* db = ds + buf * DW_KC * DW_TR;
    const bool jv = j0 + jj < Hp;
    for (int kk = kk0; kk < DW_KC; kk += 4) {
      const int t = t0 + kk;  // row t pairs with h[t - 1]; the zero row at t = 0
      const bool v = jv && t > 0 && t < T;
      cp_async4(hb + kk * TJ + jj, v ? h + (seq_row + t - 1) * Hp + j0 + jj : h, v);
    }
    for (int i = tid; i < DW_KC * (DW_TR / 4); i += nthreads) {
      const int kk = i >> 4, rr = (i & 15) * 4;
      const int t = t0 + kk;
      const bool v = t < T && r0 + rr < G;
      cp_async16(db + kk * DW_TR + rr, v ? dgates + (seq_row + t) * G + r0 + rr : dgates, v);
    }
  };

  // one commit group per chunk (empty past the last), so the wait below
  // always leaves DW_STAGES - 2 groups pending
  float acc[4][4] = {};
#pragma unroll
  for (int n = 0; n < DW_STAGES - 1; ++n) {
    if (n < nchunks) load(n, n);
    cp_async_commit();
  }
  for (int n = 0; n < nchunks; ++n) {
    const int buf = n % DW_STAGES;
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // chunk n is in for every thread; chunk n - 1 is done
    const int next = n + DW_STAGES - 1;
    if (next < nchunks) load(next, next % DW_STAGES);  // into chunk n - 1's buffer
    cp_async_commit();
    const float* hb = hs + buf * DW_KC * TJ + 4 * tj;
    const float* db = ds + buf * DW_KC * DW_TR + 4 * tr;
#pragma unroll 8
    for (int kk = 0; kk < DW_KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(hb + kk * TJ);
      const float4 d = *reinterpret_cast<const float4*>(db + kk * DW_TR);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], dv[y], acc[x][y]);
      }
    }
  }

  float* dst = out + ((size_t)s * splits + sp) * Hp * G;
  const int r = r0 + 4 * tr;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int jrow = j0 + 4 * tj + x;
    if (jrow < Hp && r < G) {
      *reinterpret_cast<float4*>(dst + (size_t)jrow * G + r) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    }
  }
}

// dw[s] = sum of the partials [s][0..splits) in index order.
// n4 = Hp * 4*Hp / 4 float4s per recurrence; grid covers S * n4.
__global__ void lstm_dw_sum_kernel(const float4* __restrict__ part, float4* __restrict__ dw,
                                   int S, int n4, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * n4) return;
  const int s = i / n4, e = i - s * n4;
  const float4* p = part + (size_t)s * splits * n4 + e;
  float4 v = p[0];
  for (int k = 1; k < splits; ++k) {
    const float4 x = p[(size_t)k * n4];
    v.x += x.x;
    v.y += x.y;
    v.z += x.z;
    v.w += x.w;
  }
  dw[i] = v;
}

using Walk = void (*)(const float*, const float*, const float*, const float*, float*, int,
                      int, int);

Walk register_walk(int W) {
  switch (W) {
#define STYLER_LSTM_CASE(w) \
  case w:                   \
    return lstm_bptt_kernel<w>;
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
  Walk fn;      // the walk kernel
  int threads;
  int smem;     // the walk's dynamic shared memory bytes
  int dw_smem;  // the dW kernel's dynamic shared memory bytes
};

cudaError_t plan_for(int instance, int Hp, int TJ, Plan* p) {
  if (Hp < 1 || Hp > kMaxHp) return cudaErrorInvalidValue;
  if (TJ < 16 || TJ > 128 || TJ % 16 != 0) return cudaErrorInvalidValue;
  const int W = round8(Hp);
  const int P = quarter_pitch(W);
  p->threads = 4 * W;
  p->smem = 0;
  p->dw_smem = DW_STAGES * DW_KC * (TJ + DW_TR) * (int)sizeof(float);
  if (instance == kRegisters) {
    if (W > kMaxRegWidth) return cudaErrorInvalidValue;
    p->fn = register_walk(W);
    return cudaSuccess;
  }
  if (instance == kShared) {
    p->fn = lstm_bptt_wide_kernel<true>;
  } else if (instance == kGlobal) {
    p->fn = lstm_bptt_wide_kernel<false>;
  } else {
    return cudaErrorInvalidValue;
  }
  p->smem = (8 * P + (instance == kShared ? W * (4 * P + 1) : 0)) * (int)sizeof(float);
  return p->smem <= kSmemLimit ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// What a launch at width Hp with walk `instance` (0 registers, 1 shared,
// 2 global) and dW row tile TJ runs: out = {walk threads, walk shared
// memory bytes (static + dynamic), walk registers, dW threads, dW shared
// memory bytes, dW registers}. Returns a CUDA error
// (cudaErrorInvalidValue for an instance or tile that does not take Hp).
extern "C" int styler_lstm_bwd_plan(int instance, int Hp, int TJ, int* out) {
  Plan p;
  cudaError_t err = plan_for(instance, Hp, TJ, &p);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a, d;
  err = cudaFuncGetAttributes(&a, (const void*)p.fn);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&d, (const void*)lstm_dw_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.threads;
  out[1] = (int)a.sharedSizeBytes + p.smem;
  out[2] = a.numRegs;
  out[3] = 4 * TJ;
  out[4] = (int)d.sharedSizeBytes + p.dw_smem;
  out[5] = d.numRegs;
  return 0;
}

// Launches the walk (parts & 1), then the dW product and, when splits > 1,
// the sum of its partials (parts & 2) on the stream; the main path asks
// for both, a timing of one part for one. `partials` holds S * splits *
// Hp * 4*Hp floats when splits > 1 (unused otherwise); splits must be
// ceil(B / rows) for rows = ceil(B / splits), so every split owns at least
// one batch row. Returns the first nonzero cudaError_t (0 on success).
extern "C" int styler_lstm_backward(const float* dh_out, const float* acts, const float* c,
                                    const float* h, const float* w_t, float* dgates,
                                    float* dw_t, float* partials, int S, int B, int T,
                                    int Hp, int instance, int TJ, int splits, int parts,
                                    void* stream) {
  Plan p;
  cudaError_t err = plan_for(instance, Hp, TJ, &p);
  if (err != cudaSuccess) return (int)err;
  if (splits < 1 || splits > B) return (int)cudaErrorInvalidValue;
  const int rows = (B + splits - 1) / splits;
  if ((B + rows - 1) / rows != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (parts & 1) {
    if (p.smem > 0) {
      err = cudaFuncSetAttribute((const void*)p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 p.smem);
      if (err != cudaSuccess) return (int)err;
    }
    p.fn<<<S * B, p.threads, p.smem, st>>>(dh_out, acts, c, w_t, dgates, B, T, Hp);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !(parts & 2)) return (int)err;
  err = cudaFuncSetAttribute(lstm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.dw_smem);
  if (err != cudaSuccess) return (int)err;
  const int G = 4 * Hp;
  dim3 grid((G + DW_TR - 1) / DW_TR, (Hp + TJ - 1) / TJ, S * splits);
  lstm_dw_kernel<<<grid, 4 * TJ, p.dw_smem, st>>>(h, dgates, splits > 1 ? partials : dw_t,
                                                  B, T, Hp, TJ, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n4 = Hp * G / 4;
  const int threads = 256;
  lstm_dw_sum_kernel<<<(S * n4 + threads - 1) / threads, threads, 0, st>>>(
      reinterpret_cast<const float4*>(partials), reinterpret_cast<float4*>(dw_t), S, n4,
      splits);
  return (int)cudaGetLastError();
}
