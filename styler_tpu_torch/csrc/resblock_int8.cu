// One dilated convolution of a HiFi-GAN resblock stage in int8: the
// activation is quantised per 128-row scale window, multiplied on the int8
// tensor cores into int32, and rescaled in f32, with the stage's
// leaky-ReLU, SAME zero padding, bias, f32 residual carry and branch mean
// fused around it.
//
// Replaces the quantize mode of the Pallas kernel
// styler_tpu/ops/pallas_resblock.py (fused_resblock_stage(quantize=True) ->
// _stage_kernel, quantize branch; weight quantisation at :266-281). The
// wrapper (ops/resblock.py:resblock_stage_int8) launches this kernel twice
// per dilation of each branch (18 times per stage at 3 x 3), after one
// prep pass over the stage input.
//
// Arithmetic of one launch, for the scale window of output rows
// t0 .. t0 + I_WIN - 1 of batch row b (I_WIN == ops/resblock.py:INT8_TILE):
//   a[t, c]  = leaky_relu(in[t, c]) for t in [0, T), 0 outside
//   s_x      = max(max |a[t, c]| over t in [t0 - halo, t0 + I_WIN + halo)
//              and all c, 1e-6) * (1/127),   halo = (k-1)/2 * dil
//   q[t, c]  = clip(rint(a[t, c] * (1 / s_x)), -127, 127)   (half to even)
//   acc[t,n] = sum_j sum_c q[t + (j - (k-1)/2) * dil, c] * wq[j, n, c]  (int32)
//   v        = f32(acc) * (s_x * s_w[n]) + bias[n]
// then the epilogue flags (RES, ACC_READ, ACC_WRITE, FINAL as in
// csrc/resblock.cu). wq holds int8 weights with one scale s_w per output
// channel, quantised once per generator by the wrapper, in the layout
// [k, Cout, Cin] (input channels contiguous: the B operand's "col" layout
// of mma.sync). Every f32 operation is an explicit round-to-nearest
// intrinsic, so the compiler fuses nothing into an FMA: the plain version
// (resblock_stage_int8_plain) repeats the same roundings in the same
// order, and the two agree bit for bit. A pair's intermediate y stays f32:
// conv2 takes its scale over f32 values, so a bf16 y would change the
// integers.
//
// Design (the bf16 mode's geometry, csrc/resblock.cu):
//  - N tile BN = the smallest of 32, 64, 128 that holds C (128 with
//    grid.y = ceil(C / 128) above); warps of mma.sync m16n8k32 (s8 in,
//    s32 sums), each warp 16 x 32 up to 32 x 64 outputs. K step: 32 input
//    channels at C <= 32, else 64. Tiles (BM x BN, threads, warps M x N):
//      BN =  32: 256 x 32, 256, 8 x 1;  128 x 32, 256, 8 x 1
//      BN =  64: 256 x 64, 256, 8 x 1;  128 x 64, 256, 8 x 1
//      BN = 128: 128 x 128, 256, 4 x 2; 256 x 128, 512, 8 x 2
//    first choice first, except that above C = 128 the 512-thread tile
//    comes first (one wave of 256-row tiles); the host takes the first
//    tile whose shared memory lets 512 threads share an SM, else the
//    first that fits at all.
//  - A tile of 256 rows covers two scale windows and holds two int8 slabs,
//    one per window (I_WIN + 2 * halo rows each): the 2 * halo rows where
//    the windows overlap are quantised once under each scale. A warp's 16
//    or 32 rows lie in one window; it reads that window's slab and its
//    epilogue uses that window's s_x. Slab pitch round32(C) + 16 bytes, an
//    odd multiple of 16, so the 8 rows of an ldmatrix land in distinct
//    banks at any tap's row shift.
//  - Fragments by ldmatrix: an m16n8k32 s8 A fragment is a b16
//    ldmatrix.x4 of four 8-row x 16-byte blocks of the slab at the tap's
//    shift; B fragments of two n8 tiles are one ldmatrix.x4 over the
//    [Cout, Cin] weight rows.
//  - Weights: the conv's whole [k, BN, Cin] slice resident in shared memory
//    where it fits beside the slabs within the 2-CTA budget (C = 32 at
//    every conv, C = 64 at every conv, C = 128 at k = 3), else a 3-stage
//    cp.async ring of K-step x BN.
//  - One HBM read of each conv's input. Every launch that writes a tensor
//    another conv reads (y, and the carry between dilations) also writes
//    max |lrelu(v)| per row and per I_GROUP output channels ("row-max
//    partials", [B, T, ceil(C / 64)] f32, no atomics: each warp owns one
//    64-channel group of its rows); a prep kernel does the same for the
//    stage input, converting a bf16 x to the f32 carry on the way. The
//    consuming CTA reduces (I_WIN + 2 * halo) x ceil(C / 64) partials per
//    window for its scale, then reads its input window once, quantising
//    it into the slab(s). The alternative, staging the f32 window in
//    shared memory and taking the abs-max there, needs (BM + 2 * halo) x
//    C x 4 more bytes per CTA and does not fit at C = 256. Both give the
//    same scale: a max does not depend on order. A tile sweep of both on
//    an NVIDIA H100 80GB HBM3 at 700 W (whole HiFi-GAN stages of a
//    2 x 1024-frame batch, ms, row-max partials against the staged window
//    on the same tile) gave C = 128 2.529 / 3.559 (staging leaves 1 CTA
//    per SM), C = 64 1.876 / 2.101, C = 32 1.768 / 1.776; C = 256 0.981 /
//    does not fit. So the row-max partials, everywhere.
//  - Tiles kept, by the same sweep (ms per stage): C = 256 256 x 128 with
//    512 threads 0.981 (128 x 128: 1.009); C = 128 128 x 128 2.529
//    (256 x 128: 2.615); C = 64 256 x 64 1.876 (128 x 64: 2.037);
//    C = 32 256 x 32 1.768 (128 x 32: 2.000). The BN = 32 tiles are held
//    to 80 registers, so 3 CTAs share an SM.
//  - The epilogue works from registers (rows lane/4 and lane/4 + 8,
//    columns 2 * (lane % 4) + {0, 1} of each n8 tile) and reduces the row
//    maxima over the quad with two shuffles. The residual may alias the
//    output (the carry is updated in place), so loads from global memory
//    would wait for every earlier store: each warp first copies its
//    residual block with cp.async into the shared memory the slabs and
//    weights no longer need, all of it in flight at once, and reads it
//    from there (pitch WN + 8 floats).
//
// Bound on the H100: per stage 126 taps x 2*B*T*C^2 operations (1.22e12
// per HiFi-GAN request over its four stages) at the dense int8 rate of
// 1,979 TOPS, 0.62 ms per request. The 18 launches move about 186 bytes
// per element of a stage through HBM (each pair reads the f32 carry,
// writes and reads the f32 y, reads the residual and writes the carry;
// plus the branch sum and the bf16 output): 0.23 ms at C = 256 and 0.93
// ms at each of C = 128, 64, 32 at 3.35 TB/s, ~3.0 ms per HiFi-GAN
// request, which is this design's floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float SLOPE = 0.1f;

// ROWMAX has a bit of its own, apart from csrc/resblock.cu's ACT_OUT (16)
// and IN_ACT (32)
enum : int { RES = 1, ACC_READ = 2, ACC_WRITE = 4, FINAL = 8, ROWMAX = 64 };

constexpr int I_WIN = 128;       // output rows per scale window == INT8_TILE
constexpr int I_GROUP = 64;      // output channels per row-max partial
constexpr int KC = 64;           // input channels per weight step (at most)
constexpr int NST = 3;           // weight ring stages
constexpr int SM_THREADS = 512;  // per SM: 2 CTAs of 256 (or 1 of 512)
constexpr size_t STATIC_SMEM = 256;  // the kernel's own __shared__ arrays, at most
constexpr size_t SMEM_MAX = 227 * 1024 - STATIC_SMEM;  // one CTA's dynamic limit

// dynamic shared memory per CTA that lets SM_THREADS / threads CTAs share
// an SM's 228 KB (1 KB reserved per CTA)
constexpr size_t smem_budget(int threads) {
  return 228 * 1024 / (SM_THREADS / threads) - 1024 - STATIC_SMEM;
}

// CTAs per SM the registers must allow: 3 of 256 threads at BN = 32
// (32 accumulators a thread), else 512 threads per SM
constexpr int min_ctas(int bn, int threads) {
  return bn == 32 && threads == 256 ? 3 : SM_THREADS / threads;
}

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.0f ? x : __fmul_rn(x, SLOPE);
}

__device__ __forceinline__ float abs_act(float x) { return fabsf(lrelu(x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quant(float a, float inv) {
  const int q = __float2int_rn(__fmul_rn(a, inv));
  return q > 127 ? 127 : (q < -127 ? -127 : q);
}

// 4 activated values -> 4 int8 in one word, the first at the lowest byte
__device__ __forceinline__ uint32_t quant4(float4 v, float inv) {
  return (uint32_t)(quant(lrelu(v.x), inv) & 0xff) |
         ((uint32_t)(quant(lrelu(v.y), inv) & 0xff) << 8) |
         ((uint32_t)(quant(lrelu(v.z), inv) & 0xff) << 16) |
         ((uint32_t)(quant(lrelu(v.w), inv) & 0xff) << 24);
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(abs_act(v.x), abs_act(v.y)),
                        fmaxf(abs_act(v.z), abs_act(v.w))));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shapes of one launch that the host and the kernel both derive.
struct Geometry {
  int cp;     // input channels rounded up to the k32 step
  int lds;    // slab pitch (bytes): cp + 16, an odd multiple of 16
  int kc;     // input channels per weight step: min(cp, KC)
  int ldw;    // weight row pitch (bytes): kc + 16, an odd multiple of 16
  int n_kc;   // weight steps per tap
  int halo;   // rows each side
  int wrows;  // rows of one window's slab: I_WIN + 2 * halo
};

__host__ __device__ __forceinline__ Geometry geometry(int C, int k, int dil) {
  Geometry g;
  g.cp = (C + 31) / 32 * 32;
  g.lds = g.cp + 16;
  g.kc = g.cp < KC ? g.cp : KC;
  g.ldw = g.kc + 16;
  g.n_kc = (g.cp + g.kc - 1) / g.kc;
  g.halo = (k - 1) / 2 * dil;
  g.wrows = I_WIN + 2 * g.halo;
  return g;
}

// RESIDENT: the conv's whole weight slice is loaded once, no barrier in
// the product loop; else the NST-stage ring. The scale comes from the
// producer's row-max partials (rm_in).
template <int BN, int WM, int WN, int THREADS, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, min_ctas(BN, THREADS))
    resblock_conv_int8_kernel(const float* __restrict__ in,
                              const float* __restrict__ rm_in,
                              const int8_t* __restrict__ w,
                              const float* __restrict__ s_w,
                              const float* __restrict__ bias, const float* res,
                              float* acc_buf, float* out32, float* rm_out,
                              void* out_final, int T, int C, int k, int dil,
                              int flags, float scale, int bf16_out) {
  constexpr int WARPS_N = BN / WN;
  constexpr int WARPS = THREADS / 32;
  constexpr int WARPS_M = WARPS / WARPS_N;
  constexpr int BM = WARPS_M * WM;
  constexpr int N_WIN = BM / I_WIN;  // scale windows per tile
  constexpr int MT = WM / 16;        // m16 tiles per warp
  constexpr int NT = WN / 8;         // n8 tiles per warp
  constexpr int RLD = WN + 8;        // residual block pitch (floats)
  static_assert(BM % I_WIN == 0 && I_WIN % WM == 0, "a warp in one window");
  static_assert(WM % 16 == 0 && NT % 2 == 0 && BN % WN == 0, "tile");
  static_assert(WN == I_GROUP || BN == 32, "a warp owns one row-max group");
  static_assert(sizeof(float) * (WARPS + 2) * N_WIN <= STATIC_SMEM, "static");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[WARPS][N_WIN];
  __shared__ float win_scale[N_WIN], win_inv[N_WIN];

  const Geometry g = geometry(C, k, dil);
  const int half = (k - 1) / 2;
  const int rows = BM + 2 * g.halo;  // input rows of the tile
  const int n_steps = k * g.n_kc;
  const int slots = RESIDENT ? n_steps : NST;
  int8_t* slab = reinterpret_cast<int8_t*>(smem);  // [N_WIN][wrows][lds]
  int8_t* wsm = slab + (size_t)N_WIN * g.wrows * g.lds;  // [slots][BN][ldw]

  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* inb = in + (size_t)b * T * C;

  // one step's weights: tap j, input channels kq*kc .. +kc, BN outputs,
  // 16 bytes per cp.async
  const int cpr = g.kc / 16;  // 16-byte chunks per weight row and step
  auto load_weights = [&](int step) {
    const int j = step / g.n_kc, kq = step - j * g.n_kc;
    const int c_lo = kq * g.kc;
    int8_t* dst = wsm + (size_t)(RESIDENT ? step : step % NST) * BN * g.ldw;
#pragma unroll 1
    for (int p = tid; p < BN * cpr; p += THREADS) {
      const int n = p / cpr, c16 = (p - n * cpr) * 16;
      const int co = n0 + n, ci = c_lo + c16;
      const bool ok = co < C && ci < C;
      cp_async16(dst + n * g.ldw + c16,
                 ok ? w + ((size_t)j * C + co) * C + ci : w, ok);
    }
  };

  if (RESIDENT) {
    for (int s = 0; s < n_steps; ++s) load_weights(s);
    cp_async_commit();
  } else {
    for (int s = 0; s < NST - 1; ++s) {
      if (s < n_steps) load_weights(s);
      cp_async_commit();
    }
  }

  // 1. each window's scale, from the row-max partials of its rows
  float m[N_WIN];
  {
    const int n_part = (C + I_GROUP - 1) / I_GROUP;
#pragma unroll
    for (int wi = 0; wi < N_WIN; ++wi) {
      m[wi] = 0.0f;
      const int tw = t0 + wi * I_WIN;
      const int lo = max(tw - g.halo, 0), hi = min(tw + I_WIN + g.halo, T);
      const float* src = rm_in + ((size_t)b * T + lo) * n_part;
#pragma unroll 4
      for (int p = tid; p < (hi - lo) * n_part; p += THREADS)
        m[wi] = fmaxf(m[wi], src[p]);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int wi = 0; wi < N_WIN; ++wi) {
    float v = m[wi];
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[warp][wi] = v;
  }
  __syncthreads();
  if (tid < N_WIN) {
    float v = red[0][tid];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) v = fmaxf(v, red[i][tid]);
    const float s = __fmul_rn(fmaxf(v, 1e-6f), 1.0f / 127.0f);
    win_scale[tid] = s;
    win_inv[tid] = __fdiv_rn(1.0f, s);
  }
  __syncthreads();

  // 2. the input rows t0 - halo .. t0 + BM + halo quantised into each
  // window's slab, one read of each 16-channel group (rows past T and
  // channels past C are zeros)
  {
    float inv[N_WIN];
#pragma unroll
    for (int wi = 0; wi < N_WIN; ++wi) inv[wi] = win_inv[wi];
    const int gpr = g.cp / 16;
    const int n_groups = rows * gpr;
    constexpr int U = 2;  // 8 loads of 16 bytes in flight per thread
#pragma unroll 1
    for (int p0 = tid; p0 < n_groups; p0 += THREADS * U) {
      float4 xin[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * THREADS;
        const int r = p / gpr, c16 = (p - r * gpr) * 16;
        const int t = t0 - g.halo + r;
#pragma unroll
        for (int q = 0; q < 4; ++q) xin[u][q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < n_groups && t >= 0 && t < T && c16 < C) {
          const float4* src =
              reinterpret_cast<const float4*>(inb + (size_t)t * C + c16);
#pragma unroll
          for (int q = 0; q < 4; ++q) xin[u][q] = src[q];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * THREADS;
        if (p >= n_groups) break;
        const int r = p / gpr, c16 = (p - r * gpr) * 16;
#pragma unroll
        for (int wi = 0; wi < N_WIN; ++wi) {
          const int rw = r - wi * I_WIN;
          if (rw < 0 || rw >= g.wrows) continue;
          uint4 q;
          q.x = quant4(xin[u][0], inv[wi]);
          q.y = quant4(xin[u][1], inv[wi]);
          q.z = quant4(xin[u][2], inv[wi]);
          q.w = quant4(xin[u][3], inv[wi]);
          *reinterpret_cast<uint4*>(
              slab + ((size_t)wi * g.wrows + rw) * g.lds + c16) = q;
        }
      }
    }
  }

  // 3. int8 x int8 -> int32 over the k taps and the input channels
  const int wm0 = warp / WARPS_N * WM;
  const int wn0 = warp % WARPS_N * WN;
  const int wi = wm0 / I_WIN;  // this warp's scale window
  // a warp whose rows all lie past T or whose columns all lie past C skips
  // its products (it still takes part in every barrier)
  const bool live = t0 + wm0 < T && n0 + wn0 < C;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

  // per-lane ldmatrix addresses. A: rows lane % 16, bytes (lane / 16) * 16
  // of the warp's first row in its window's slab. B (two n8 tiles per x4):
  // weight row (lane / 16) * 8 + lane % 8, bytes ((lane / 8) % 2) * 16.
  const uint32_t a_lane =
      smem_u32(slab) +
      ((wi * g.wrows + g.halo + wm0 - wi * I_WIN + lane % 16) * g.lds +
       lane / 16 * 16);
  const uint32_t b_lane =
      smem_u32(wsm) +
      ((wn0 + lane / 16 * 8 + lane % 8) * g.ldw + (lane / 8) % 2 * 16);
  const uint32_t slot_bytes = BN * g.ldw;
  const uint32_t a_m16 = 16 * g.lds;  // bytes between a warp's m16 tiles

  if (RESIDENT) {
    cp_async_wait<0>();
    __syncthreads();
  }
  int step = 0;
  for (int j = 0; j < k; ++j) {
    const uint32_t a_tap = a_lane + (j - half) * dil * g.lds;
    for (int kq = 0; kq < g.n_kc; ++kq, ++step) {
      int slot = step;
      if (!RESIDENT) {
        cp_async_wait<NST - 2>();  // this step's weights (and the slab) landed
        __syncthreads();           // ... for every thread; the slot refilled
                                   // next was read one step ago
        if (step + NST - 1 < n_steps) load_weights(step + NST - 1);
        cp_async_commit();
        slot = step % NST;
      }
      if (!live) continue;
      const uint32_t a_k = a_tap + kq * g.kc;
      const uint32_t b_k = b_lane + slot * slot_bytes;
      const int nk = min(g.kc, g.cp - kq * g.kc) / 32;
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(a[i], a_k + i * a_m16 + kk * 32);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t bq[4];  // n8 tiles 2p, 2p + 1: k 0-15 and 16-31 each
          ldsm_x4(bq, b_k + p * 16 * g.ldw + kk * 32);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_s8(acc[i][2 * p], a[i], bq[0], bq[1]);
            mma_s8(acc[i][2 * p + 1], a[i], bq[2], bq[3]);
          }
        }
      }
    }
  }
  // the warp's residual block [WM][WN] into shared memory the slabs and
  // weights no longer need, all of it in flight at once (pitch RLD: the 8
  // rows of an epilogue read fall in distinct banks)
  __syncthreads();
  float* res_sm = reinterpret_cast<float*>(smem) + warp * WM * RLD;
  if ((flags & RES) && live) {
#pragma unroll 4
    for (int p = lane; p < WM * (WN / 4); p += 32) {
      const int r = p / (WN / 4), c4 = (p - r * (WN / 4)) * 4;
      const int t = t0 + wm0 + r, co = n0 + wn0 + c4;
      const bool ok = t < T && co < C;
      cp_async16(res_sm + r * RLD + c4,
                 ok ? res + ((size_t)b * T + t) * C + co : res, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
  }
  if (!live) return;

  // 4. epilogue from registers; C % 16 == 0, so an n8 tile is all in or
  // all out. Per n8 tile: the residual from shared memory and the branch
  // sum from HBM, then the arithmetic, then the stores (res may alias
  // out32: the carry is updated in place). ROWMAX: the row maxima of
  // |lrelu(v)| over this warp's channels, one 64-channel group, reduced
  // over the quad after the loop.
  const float sx = win_scale[wi];
  const int r_lane = t0 + wm0 + lane / 4;
  const int c_lane = n0 + wn0 + lane % 4 * 2;
  const float* res_lane = res_sm + lane / 4 * RLD + lane % 4 * 2;
  float mx[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) mx[i][0] = mx[i][1] = 0.0f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int co = c_lane + n * 8;
    if (co >= C) continue;
    const float2 sw = *reinterpret_cast<const float2*>(s_w + co);
    const float2 bb = *reinterpret_cast<const float2*>(bias + co);
    const float sc0 = __fmul_rn(sx, sw.x), sc1 = __fmul_rn(sx, sw.y);
    float2 a[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r_lane + i * 16 + h * 8;
        a[i][h] = make_float2(0.f, 0.f);
        if (t < T && (flags & ACC_READ))
          a[i][h] = *reinterpret_cast<const float2*>(acc_buf + ((size_t)b * T + t) * C + co);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r_lane + i * 16 + h * 8;
        if (t >= T) continue;
        const size_t idx = ((size_t)b * T + t) * C + co;
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][n][2 * h]), sc0), bb.x);
        float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][n][2 * h + 1]), sc1), bb.y);
        if (flags & RES) {
          const float2 r = *reinterpret_cast<const float2*>(
              res_lane + (i * 16 + h * 8) * RLD + n * 8);
          v0 = __fadd_rn(r.x, v0), v1 = __fadd_rn(r.y, v1);
        }
        if (flags & ACC_READ) v0 = __fadd_rn(a[i][h].x, v0), v1 = __fadd_rn(a[i][h].y, v1);
        if (flags & FINAL) {
          v0 = __fmul_rn(v0, scale);
          v1 = __fmul_rn(v1, scale);
          if (bf16_out)
            *reinterpret_cast<uint32_t*>(
                static_cast<__nv_bfloat16*>(out_final) + idx) = pack_bf16x2(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out_final) + idx) =
                make_float2(v0, v1);
        } else if (flags & ACC_WRITE) {
          *reinterpret_cast<float2*>(acc_buf + idx) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<float2*>(out32 + idx) = make_float2(v0, v1);
          mx[i][h] = fmaxf(mx[i][h], fmaxf(abs_act(v0), abs_act(v1)));
        }
      }
  }
  if (flags & ROWMAX) {
    const int n_part = (C + I_GROUP - 1) / I_GROUP;
    const int grp = (n0 + wn0) / I_GROUP;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = mx[i][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int t = r_lane + i * 16 + h * 8;
        if (lane % 4 == 0 && t < T)
          rm_out[((size_t)b * T + t) * n_part + grp] = v;
      }
  }
}

// The stage input x (bf16 or f32) -> its f32 copy (bf16 only) and its
// row-max partials: 16 threads per 64-channel group of a row, 4 channels
// each, the group's max over 4 shuffles.
__global__ void __launch_bounds__(256)
    resblock_int8_prep_kernel(const void* __restrict__ x, int x_bf16,
                              float* __restrict__ x32, float* __restrict__ rm,
                              int rows, int C) {
  const int n_part = (C + I_GROUP - 1) / I_GROUP;
  const int per_row = n_part * 16;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = i / per_row;
  const int g4 = (int)(i - row * per_row);
  const int c = g4 * 4;
  float m = 0.0f;
  if (row < rows && c < C) {
    const size_t idx = (size_t)row * C + c;
    float4 v;
    if (x_bf16) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          static_cast<const __nv_bfloat16*>(x) + idx);
      v = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
      *reinterpret_cast<float4*>(x32 + idx) = v;
    } else {
      v = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + idx);
    }
    m = absmax4(m, v);
  }
  for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (row < rows && g4 % 16 == 0) rm[row * n_part + g4 / 16] = m;
}

using Int8Kernel = void (*)(const float*, const float*, const int8_t*,
                            const float*, const float*, const float*, float*,
                            float*, float*, void*, int, int, int, int, int,
                            float, int);

struct Tile {
  int bn, wm, wn, threads, bm;
  Int8Kernel fn[2];  // [resident]
};

template <int BN, int WM, int WN, int THREADS = 256>
Tile tile() {
  return {BN, WM, WN, THREADS, (THREADS / 32) / (BN / WN) * WM,
          {resblock_conv_int8_kernel<BN, WM, WN, THREADS, false>,
           resblock_conv_int8_kernel<BN, WM, WN, THREADS, true>}};
}

// per BN, first choice first (see the header)
const Tile TILES[] = {
    tile<32, 32, 32>(),  tile<32, 16, 32>(),  tile<64, 32, 64>(),
    tile<64, 16, 64>(),  tile<128, 32, 64>(), tile<128, 32, 64, 512>(),
};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);
int forced_tile[3] = {-1, -1, -1};  // per BN (32, 64, 128), for tile sweeps

int bn_for(int C) { return C <= 32 ? 32 : C <= 64 ? 64 : 128; }
int bn_index(int bn) { return bn == 32 ? 0 : bn == 64 ? 1 : 2; }

// Dynamic shared memory of one launch: the slabs and the weights (resident
// or the ring), or the residual blocks the epilogue stages in the same
// bytes afterwards, whichever is larger.
size_t tile_smem(const Tile& t, int C, int k, int dil, int* resident) {
  const Geometry g = geometry(C, k, dil);
  const size_t slabs = (size_t)(t.bm / I_WIN) * g.wrows * g.lds;
  const size_t slot = (size_t)t.bn * g.ldw;
  const int n_steps = k * g.n_kc;
  const size_t res = (size_t)(t.threads / 32) * t.wm * (t.wn + 8) * 4;
  const size_t with_all = slabs + n_steps * slot;
  *resident = with_all <= smem_budget(t.threads) && res <= smem_budget(t.threads);
  const size_t used = *resident ? with_all : slabs + NST * slot;
  return used > res ? used : res;
}

struct Plan {
  const Tile* tile;
  int resident;
  size_t smem;
  dim3 grid;
  Int8Kernel fn;
};

// The tile of one launch; cudaErrorInvalidValue if none fits.
cudaError_t plan_int8(int B, int T, int C, int k, int dil, Plan* plan) {
  if (C % 16 || C <= 0 || T <= 0 || B <= 0 || k <= 0 || k % 2 == 0 || dil <= 0)
    return cudaErrorInvalidValue;
  const int bn = bn_for(C);
  const Tile* best = nullptr;
  int best_res = 0;
  size_t best_smem = 0;
  const int bi = bn_index(bn);
  // candidates in TILES order, except that above C = 128 (two or more
  // column blocks) the 512-thread tile comes first: one wave of 256-row
  // tiles, which the sweep measured ahead of 128 x 128 there
  int order[N_TILES], n_order = 0;
  for (int i = 0; i < N_TILES; ++i)
    if (C > 128 && TILES[i].threads == 512) order[n_order++] = i;
  for (int i = 0; i < N_TILES; ++i)
    if (!(C > 128 && TILES[i].threads == 512)) order[n_order++] = i;
  for (int pass = 0; pass < 3 && !best; ++pass) {
    // 0: the forced tile; 1: the first within its budget; 2: any
    for (int o = 0; o < N_TILES && !best; ++o) {
      const int i = order[o];
      if (TILES[i].bn != bn || (pass == 0 && i != forced_tile[bi])) continue;
      int res;
      const size_t smem = tile_smem(TILES[i], C, k, dil, &res);
      if (smem <= (pass == 1 ? smem_budget(TILES[i].threads) : SMEM_MAX)) {
        best = &TILES[i];
        best_res = res;
        best_smem = smem;
      }
    }
  }
  if (!best) return cudaErrorInvalidValue;
  plan->tile = best;
  plan->resident = best_res;
  plan->smem = best_smem;
  plan->grid = dim3((T + best->bm - 1) / best->bm, (C + bn - 1) / bn, B);
  plan->fn = best->fn[best_res];
  return cudaFuncSetAttribute(plan->fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)best_smem);
}

}  // namespace

// in, res, acc, out32: f32 [B, T, C]; rm_in, rm_out: f32 [B, T, ceil(C /
// 64)] row-max partials of in (read) and of out32 (written with ROWMAX);
// w: int8 [k, C (out), C (in)]; s_w, bias: f32 [C]; out_final: bf16
// (bf16_out != 0) or f32 [B, T, C]. Needs C % 16 == 0 and 16-byte aligned
// pointers. Returns the CUDA error of the launch (0 on success).
extern "C" int styler_resblock_conv_int8(
    const float* in, const float* rm_in, const void* w, const float* s_w,
    const float* bias, const float* res, float* acc, float* out32,
    float* rm_out, void* out_final, int B, int T, int C, int k, int dil,
    int flags, float scale, int bf16_out, void* stream) {
  Plan p;
  const cudaError_t err = plan_int8(B, T, C, k, dil, &p);
  if (err != cudaSuccess) return (int)err;
  p.fn<<<p.grid, p.tile->threads, p.smem, (cudaStream_t)stream>>>(
      in, rm_in, (const int8_t*)w, s_w, bias, res, acc, out32, rm_out,
      out_final, T, C, k, dil, flags, scale, bf16_out);
  return (int)cudaGetLastError();
}

// x: bf16 (x_bf16 != 0) or f32 [B, T, C]; x32: f32 [B, T, C], written only
// for a bf16 x; rm: f32 [B, T, ceil(C / 64)]. Needs C % 16 == 0.
extern "C" int styler_resblock_int8_prep(const void* x, int x_bf16, float* x32,
                                         float* rm, int B, int T, int C,
                                         void* stream) {
  if (C % 16 || C <= 0 || T <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const long long threads =
      (long long)B * T * ((C + I_GROUP - 1) / I_GROUP) * 16;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  resblock_int8_prep_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      x, x_bf16, x32, rm, B * T, C);
  return (int)cudaGetLastError();
}

// What a launch of this shape runs: out[0..9] = BM, BN, WN, threads,
// grid x, y, z, dynamic shared memory bytes, resident weights (0/1), CTAs
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA
// error.
extern "C" int styler_resblock_int8_plan(int B, int T, int C, int k, int dil,
                                         int* out) {
  Plan p;
  cudaError_t err = plan_int8(B, T, C, k, dil, &p);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, p.fn, p.tile->threads, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int v[10] = {p.tile->bm,      p.tile->bn,    p.tile->wn,
                     p.tile->threads, (int)p.grid.x, (int)p.grid.y,
                     (int)p.grid.z,   (int)p.smem,   p.resident,
                     ctas};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// Tile sweeps: force the launches of N tile `bn` onto the tile of BM rows
// and `threads` per CTA (it must fit in shared memory; else the usual
// choice is made); bm = 0 restores the usual choice. Returns
// cudaErrorInvalidValue for a tile the library does not have.
extern "C" int styler_resblock_int8_force_tile(int bn, int bm, int threads) {
  if (bn != 32 && bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  const int bi = bn_index(bn);
  if (bm == 0) {
    forced_tile[bi] = -1;
    return 0;
  }
  for (int i = 0; i < N_TILES; ++i) {
    if (TILES[i].bn == bn && TILES[i].bm == bm && TILES[i].threads == threads) {
      forced_tile[bi] = i;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}
