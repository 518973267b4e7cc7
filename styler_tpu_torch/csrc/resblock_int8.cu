// One dilated convolution of a HiFi-GAN resblock stage in int8: the
// activation is quantised per output tile, multiplied on the int8 tensor
// cores into int32, and rescaled in f32, with the stage's leaky-ReLU, SAME
// zero padding, bias, f32 residual carry and branch mean fused around it.
//
// Replaces the quantize mode of the Pallas kernel
// styler_tpu/ops/pallas_resblock.py (fused_resblock_stage(quantize=True) ->
// _stage_kernel, quantize branch; weight quantisation at :266-281). The
// wrapper (ops/resblock.py:resblock_stage_int8) launches this kernel 18
// times per stage, as the exact form (csrc/resblock.cu).
//
// Arithmetic of one launch, for the output tile of rows t0 .. t0 + I_BM - 1
// of batch row b (I_BM == ops/resblock.py:INT8_TILE):
//   a[t, c]  = leaky_relu(in[t, c]) for t in [0, T), 0 outside
//   s_x      = max(max |a[t, c]| over t in [t0 - halo, t0 + I_BM + halo)
//              and all c, 1e-6) * (1/127),   halo = (k-1)/2 * dil
//   q[t, c]  = clip(rint(a[t, c] * (1 / s_x)), -127, 127)   (half to even)
//   acc[t,n] = sum_j sum_c q[t + (j - (k-1)/2) * dil, c] * wq[j, n, c]  (int32)
//   v        = f32(acc) * (s_x * s_w[n]) + bias[n]
// then the exact form's epilogue flags (RES, ACC_READ, ACC_WRITE, FINAL).
// wq holds int8 weights with one scale s_w per output channel, quantised
// once per generator by the wrapper, in the layout [k, Cout, Cin] (input
// channels contiguous, which is the B operand's "col" layout of mma.sync).
// Every f32 operation is an explicit round-to-nearest intrinsic, so the
// compiler fuses nothing into an FMA: the plain version
// (resblock_stage_int8_plain) repeats the same roundings in the same order.
//
// Design: a CTA computes a 128-row x 128-channel output tile with 8 warps
// (4 along time x 2 along channels, 32 x 64 each) of
// mma.sync.m16n8k32.s8.s8.s32. It first reduces the abs-max of its input
// window (the scale needs all of it), then stages the window quantised to
// int8 in shared memory ONCE, so all k taps read their shifted A fragments
// from that slab; the weights stream through a double-buffered ring (64
// input channels x 128 output channels per step) with cp.async. Row pitches
// of 16 (mod 128) bytes keep the fragment loads free of bank conflicts.
// The epilogue runs from the accumulator registers.
//
// Bound on the H100: per stage 126 taps x 2*B*T*C^2 operations (1.22e12 per
// HiFi-GAN request over its four stages) at the dense int8 rate of 1,979
// TOPS, 0.62 ms per request. As in the exact form, the f32 carry makes 18
// HBM round trips per stage, the input is read twice (abs-max, then
// quantise), and mma.sync is not Hopper's wgmma, so this design stays far
// above that bound; at C = 64 and 32 half and three quarters of each
// 128-channel tile are padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float SLOPE = 0.1f;

enum : int { RES = 1, ACC_READ = 2, ACC_WRITE = 4, FINAL = 8 };

constexpr int I_BM = 128;       // time rows per CTA == INT8_TILE
constexpr int I_BN = 128;       // output channels per CTA
constexpr int I_BK = 64;        // input channels per weight step
constexpr int I_THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int I_LDW = I_BK + 16;  // weight ring row pitch (bytes)

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.0f ? x : __fmul_rn(x, SLOPE);
}

__device__ __forceinline__ void store_out(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_out(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_s8(int a, int b, int c, int d) {
  return (unsigned)(a & 0xff) | ((unsigned)(b & 0xff) << 8) |
         ((unsigned)(c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

__device__ __forceinline__ int quant(float a, float inv) {
  const int q = __float2int_rn(__fmul_rn(a, inv));
  return q > 127 ? 127 : (q < -127 ? -127 : q);
}

// Slab row pitch in bytes for C input channels: C rounded up to the weight
// step, plus 16, so rows start 4-byte aligned and 8 consecutive rows fall
// on 8 different groups of 4 banks.
__host__ __device__ __forceinline__ int slab_ld(int C) {
  return (C + I_BK - 1) / I_BK * I_BK + 16;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int C, int k, int dil) {
  const int halo = (k - 1) / 2 * dil;
  return (size_t)(I_BM + 2 * halo) * slab_ld(C) + 2 * (size_t)I_BN * I_LDW;
}

template <typename Tc>
__global__ void __launch_bounds__(I_THREADS)
    resblock_conv_int8_kernel(const float* __restrict__ in,
                              const int8_t* __restrict__ w,
                              const float* __restrict__ s_w,
                              const float* __restrict__ bias, const float* res,
                              float* acc_buf, float* out32, Tc* out_final,
                              int T, int C, int k, int dil, int flags,
                              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[I_THREADS / 32];
  const int half = (k - 1) / 2;
  const int halo = half * dil;
  const int lds = slab_ld(C);
  const int cp = lds - 16;  // input channels padded to the weight step
  const int rows = I_BM + 2 * halo;
  int8_t* slab = reinterpret_cast<int8_t*>(smem);
  int8_t* ring = slab + (size_t)rows * lds;  // [2][I_BN][I_LDW]

  const int t0 = blockIdx.x * I_BM;
  const int n0 = blockIdx.y * I_BN;
  const int b = blockIdx.z;
  const float* inb = in + (size_t)b * T * C;

  const int n_kc = cp / I_BK;
  const int n_steps = k * n_kc;
  auto load_weights = [&](int step, int buf) {
    const int j = step / n_kc, kc = step % n_kc;
    int8_t* dst = ring + (size_t)buf * I_BN * I_LDW;
    for (int p = threadIdx.x; p < I_BN * (I_BK / 16); p += I_THREADS) {
      const int n = p / (I_BK / 16), c16 = (p % (I_BK / 16)) * 16;
      const int co = n0 + n, ci = kc * I_BK + c16;
      const bool ok = co < C && ci < C;
      const int8_t* src = ok ? w + ((size_t)j * C + co) * C + ci : w;
      cp_async16(dst + n * I_LDW + c16, src, ok);
    }
  };

  load_weights(0, 0);
  cp_async_commit();

  // 1. the abs-max of the activated input window
  const int r_lo = max(t0 - halo, 0), r_hi = min(t0 + I_BM + halo, T);
  float m = 0.0f;
  for (int p = threadIdx.x; p < (r_hi - r_lo) * (C / 4); p += I_THREADS) {
    const int t = r_lo + p / (C / 4), c4 = (p % (C / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(inb + (size_t)t * C + c4);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(lrelu(v.x)), fabsf(lrelu(v.y))),
                       fmaxf(fabsf(lrelu(v.z)), fabsf(lrelu(v.w)))));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < I_THREADS / 32; ++i) m = fmaxf(m, red[i]);
  const float s_x = __fmul_rn(fmaxf(m, 1e-6f), 1.0f / 127.0f);
  const float inv = __fdiv_rn(1.0f, s_x);

  // 2. the window quantised with that scale: rows t0 - halo .. t0 + BM + halo
  for (int p = threadIdx.x; p < rows * (cp / 4); p += I_THREADS) {
    const int r = p / (cp / 4), c4 = (p % (cp / 4)) * 4;
    const int t = t0 - halo + r;
    unsigned word = 0;
    if (t >= 0 && t < T && c4 < C) {
      const float4 v = *reinterpret_cast<const float4*>(inb + (size_t)t * C + c4);
      word = pack_s8(quant(lrelu(v.x), inv), quant(lrelu(v.y), inv),
                     quant(lrelu(v.z), inv), quant(lrelu(v.w), inv));
    }
    *reinterpret_cast<unsigned*>(slab + (size_t)r * lds + c4) = word;
  }

  // 3. int8 x int8 -> int32 over the k taps and the input channels
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 64;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_weights(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();  // this step's weights have landed
    __syncthreads();      // ... for every thread; the slab too
    const int j = step / n_kc, kc = step % n_kc;
    const int8_t* wb = ring + (size_t)(step & 1) * I_BN * I_LDW;
    const int8_t* ab =
        slab + (size_t)(halo + (j - half) * dil + wm) * lds + kc * I_BK;
#pragma unroll
    for (int ks = 0; ks < I_BK; ks += 32) {
      unsigned af[2][4], bfr[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* a0 = ab + (size_t)(16 * i + g) * lds + ks + 4 * tq;
        af[i][0] = *reinterpret_cast<const unsigned*>(a0);
        af[i][1] = *reinterpret_cast<const unsigned*>(a0 + 8 * lds);
        af[i][2] = *reinterpret_cast<const unsigned*>(a0 + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(a0 + 8 * lds + 16);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int8_t* b0 = wb + (wn + 8 * n + g) * I_LDW + ks + 4 * tq;
        bfr[n][0] = *reinterpret_cast<const unsigned*>(b0);
        bfr[n][1] = *reinterpret_cast<const unsigned*>(b0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) mma_s8(acc[i][n], af[i], bfr[n]);
    }
    __syncthreads();  // the ring slot is refilled two steps on
  }

  // 4. epilogue from the registers: c0, c1 at row g, c2, c3 at row g + 8;
  // columns 2 * tq and 2 * tq + 1 of each 8-wide fragment
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + wm + 16 * i + g + (e >= 2 ? 8 : 0);
        const int co = n0 + wn + 8 * n + 2 * tq + (e & 1);
        if (t >= T || co >= C) continue;
        const size_t idx = ((size_t)b * T + t) * C + co;
        float v = __fmul_rn(__int2float_rn(acc[i][n][e]), __fmul_rn(s_x, s_w[co]));
        v = __fadd_rn(v, bias[co]);
        if (flags & RES) v = __fadd_rn(res[idx], v);
        if (flags & ACC_READ) v = __fadd_rn(acc_buf[idx], v);
        if (flags & FINAL) {
          store_out(__fmul_rn(v, scale), &out_final[idx]);
        } else if (flags & ACC_WRITE) {
          acc_buf[idx] = v;
        } else {
          out32[idx] = v;
        }
      }
}

template <typename Tc>
int launch(const float* in, const int8_t* w, const float* s_w,
           const float* bias, const float* res, float* acc, float* out32,
           Tc* out_final, int B, int T, int C, int k, int dil, int flags,
           float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(C, k, dil);
  cudaError_t err = cudaFuncSetAttribute(
      resblock_conv_int8_kernel<Tc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + I_BM - 1) / I_BM, (C + I_BN - 1) / I_BN, B);
  resblock_conv_int8_kernel<Tc><<<grid, I_THREADS, smem, s>>>(
      in, w, s_w, bias, res, acc, out32, out_final, T, C, k, dil, flags,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// in, res, acc, out32: f32 [B, T, C]; w: int8 [k, C (out), C (in)];
// s_w, bias: f32 [C]; out_final: bf16 (bf16_out != 0) or f32 [B, T, C].
// Needs C % 16 == 0 (16-byte weight rows, float4 input rows) and 16-byte
// aligned pointers. Returns the CUDA error of the launch (0 on success).
extern "C" int styler_resblock_conv_int8(const float* in, const void* w,
                                         const float* s_w, const float* bias,
                                         const float* res, float* acc,
                                         float* out32, void* out_final, int B,
                                         int T, int C, int k, int dil,
                                         int flags, float scale, int bf16_out,
                                         void* stream) {
  if (C % 16 != 0 || k % 2 == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wq = (const int8_t*)w;
  if (bf16_out)
    return launch(in, wq, s_w, bias, res, acc, out32,
                  (__nv_bfloat16*)out_final, B, T, C, k, dil, flags, scale, s);
  return launch(in, wq, s_w, bias, res, acc, out32, (float*)out_final, B, T,
                C, k, dil, flags, scale, s);
}
