// One dilated convolution of a HiFi-GAN / iSTFTNet resblock stage, with
// the stage's leaky-ReLU, SAME zero padding, bias, f32 residual carry and
// branch mean fused around it.
//
// Replaces the Pallas kernel styler_tpu/ops/pallas_resblock.py
// (fused_resblock_stage -> _stage_kernel, exact mode). The wrapper
// (ops/resblock.py) launches this kernel 18 times per stage (3 branches x
// 3 dilations x 2 convs); activations round-trip through device memory
// between launches, where the TPU kernel kept the whole tile in VMEM.
//
// Arithmetic (both modes): out[t, n] = sum_j sum_c A_j[t, c] * w[j, c, n]
// with A_j[t, c] = compute_dtype(leaky_relu(in[t + (j - (k-1)/2) * dil, c]))
// (0 outside [0, T)) and w in the flax [k, Cin, Cout] layout, summed in
// f32. The epilogue adds the f32 bias and then, by `flags`:
//   RES        v = res + v             (the residual carry, kept in f32)
//   ACC_READ   v = acc + v             (running sum over branches)
//   ACC_WRITE  acc = v
//   FINAL      out = compute_dtype(v * scale)   (scale = 1 / n_branches)
//   otherwise  out32 = v
// which is the TPU kernel's arithmetic: the carry between convs is f32 and
// only the stage output is cast to the compute dtype.
//
// bf16 mode (the main path): a CTA computes a 128-row x 128-channel output
// tile with 8 warps of wmma bf16 16x16x16 fragments (f32 accumulators).
// It stages its input rows plus the conv's halo ((k-1)/2 * dil rows each
// side), activated and cast to bf16, in shared memory ONCE, so all k taps
// read their shifted A fragments from that slab; the weights stream
// through a double-buffered shared-memory ring (32 input channels x 128
// output channels per step) with cp.async, overlapping the next step's
// load with this step's products.
// f32 mode (parity and tests): 64x64 tiles of plain f32 FMAs (no TF32),
// the input restaged per tap.
//
// Bound on the H100: per stage 126 taps x 2*B*T*C^2 FLOPs (2.7e11 at
// stage 0, 5.4e11 at stage 1 on the main path) against ~16 MB of weights
// and 2*B*T*C activations; bound by tensor-core operations in bf16. The
// 18 HBM round trips of the f32 carry (~3 GB per request) and wmma's
// mma.sync (not Hopper's wgmma) keep this design well above that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float SLOPE = 0.1f;

enum : int { RES = 1, ACC_READ = 2, ACC_WRITE = 4, FINAL = 8 };

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.0f ? x : x * SLOPE;
}

__device__ __forceinline__ void store_out(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_out(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

// Shared epilogue: Cs holds the f32 sums of a BM x BN tile (row stride ldc).
template <int BM, int BN, int THREADS, typename Tc>
__device__ __forceinline__ void epilogue(const float* Cs, int ldc,
                                         const float* __restrict__ bias,
                                         const float* res, float* acc_buf,
                                         float* out32, Tc* out_final, int b,
                                         int t0, int n0, int T, int C,
                                         int flags, float scale) {
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN;
    const int t = t0 + r, co = n0 + cc;
    if (t >= T || co >= C) continue;
    const size_t idx = ((size_t)b * T + t) * C + co;
    float v = Cs[r * ldc + cc] + bias[co];
    if (flags & RES) v = res[idx] + v;
    if (flags & ACC_READ) v = acc_buf[idx] + v;
    if (flags & FINAL) {
      store_out(v * scale, &out_final[idx]);
    } else if (flags & ACC_WRITE) {
      acc_buf[idx] = v;
    } else {
      out32[idx] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 mode
// ---------------------------------------------------------------------------

constexpr int H_BM = 128;      // time rows per CTA
constexpr int H_BN = 128;      // output channels per CTA
constexpr int H_BK = 32;       // input channels per weight step
constexpr int H_THREADS = 256; // 8 warps: 4 along M x 2 along N
constexpr int H_LDW = H_BN + 8;  // weight ring row stride (elements)
constexpr int H_LDC = H_BN + 4;  // epilogue row stride (floats)

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

// Slab row stride in elements for C input channels: C rounded up to the
// weight step, plus 16 so that every row starts on a 32-byte boundary
// (wmma's alignment) and consecutive rows fall on other banks.
__host__ __device__ __forceinline__ int slab_ld(int C) {
  return (C + H_BK - 1) / H_BK * H_BK + 16;
}

__host__ __device__ __forceinline__ size_t bf16_smem_bytes(int C, int k,
                                                           int dil) {
  const int halo = (k - 1) / 2 * dil;
  const size_t slab = (size_t)(H_BM + 2 * halo) * slab_ld(C) * 2;
  const size_t ring = 2 * (size_t)H_BK * H_LDW * 2;
  const size_t epi = (size_t)H_BM * H_LDC * 4;
  return slab + ring > epi ? slab + ring : epi;
}

__global__ void __launch_bounds__(H_THREADS)
    resblock_conv_bf16_kernel(const float* __restrict__ in,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* res, float* acc_buf, float* out32,
                              __nv_bfloat16* out_final, int T, int C, int k,
                              int dil, int flags, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int half = (k - 1) / 2;
  const int halo = half * dil;
  const int lds = slab_ld(C);
  const int cp = lds - 16;  // input channels padded to the weight step
  const int rows = H_BM + 2 * halo;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = slab + (size_t)rows * lds;  // [2][H_BK][H_LDW]

  const int t0 = blockIdx.x * H_BM;
  const int n0 = blockIdx.y * H_BN;
  const int b = blockIdx.z;
  const float* inb = in + (size_t)b * T * C;

  const int n_kc = cp / H_BK;
  const int n_steps = k * n_kc;
  auto load_weights = [&](int step, int buf) {
    const int j = step / n_kc, kc = step % n_kc;
    __nv_bfloat16* dst = ring + (size_t)buf * H_BK * H_LDW;
    for (int p = threadIdx.x; p < H_BK * (H_BN / 8); p += H_THREADS) {
      const int r = p / (H_BN / 8), c8 = (p % (H_BN / 8)) * 8;
      const int ci = kc * H_BK + r, co = n0 + c8;
      const bool ok = ci < C && co < C;
      const __nv_bfloat16* src = ok ? w + ((size_t)j * C + ci) * C + co : w;
      cp_async16(dst + r * H_LDW + c8, src, ok);
    }
  };

  load_weights(0, 0);
  cp_async_commit();

  // the activated bf16 input slab: rows t0 - halo .. t0 + BM + halo
  for (int p = threadIdx.x; p < rows * (cp / 4); p += H_THREADS) {
    const int r = p / (cp / 4), c4 = (p % (cp / 4)) * 4;
    const int t = t0 - halo + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T && c4 < C) {
      v = *reinterpret_cast<const float4*>(inb + (size_t)t * C + c4);
      v = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(slab + (size_t)r * lds + c4);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }

  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[i][n], 0.0f);

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) load_weights(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();  // this step's weights have landed
    __syncthreads();      // ... for every thread; the slab too
    const int j = step / n_kc, kc = step % n_kc;
    const __nv_bfloat16* wb = ring + (size_t)(step & 1) * H_BK * H_LDW;
    const __nv_bfloat16* ab =
        slab + (size_t)(halo + (j - half) * dil + wm) * lds + kc * H_BK;
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], ab + (size_t)16 * i * lds + kk, lds);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::load_matrix_sync(bfr[n], wb + kk * H_LDW + wn + 16 * n, H_LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::mma_sync(acc[i][n], af[i], bfr[n], acc[i][n]);
    }
    __syncthreads();  // the ring slot is refilled two steps on
  }

  float* Cs = reinterpret_cast<float*>(smem);  // reuses the slab
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * H_LDC + wn + 16 * n,
                              acc[i][n], H_LDC, wmma::mem_row_major);
  __syncthreads();
  epilogue<H_BM, H_BN, H_THREADS>(Cs, H_LDC, bias, res, acc_buf, out32,
                                  out_final, b, t0, n0, T, C, flags, scale);
}

// ---------------------------------------------------------------------------
// f32 mode
// ---------------------------------------------------------------------------

constexpr int F_BM = 64;
constexpr int F_BN = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 128;

__global__ void __launch_bounds__(F_THREADS)
    resblock_conv_f32_kernel(const float* __restrict__ in,
                             const float* __restrict__ w,
                             const float* __restrict__ bias, const float* res,
                             float* acc_buf, float* out32, float* out_final,
                             int T, int C, int k, int dil, int flags,
                             float scale) {
  __shared__ float As[F_BK][F_BM + 4];  // transposed: As[c][r]
  __shared__ float Bs[F_BK][F_BN + 4];
  __shared__ float Cs[F_BM * (F_BN + 4)];

  const int t0 = blockIdx.x * F_BM;
  const int n0 = blockIdx.y * F_BN;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 8;  // 8 x 8 = 64 columns
  const int ty = threadIdx.x / 8;  // 16 x 4 = 64 rows
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0f;

  const int half = (k - 1) / 2;
  const float* inb = in + (size_t)b * T * C;
  for (int j = 0; j < k; ++j) {
    const int shift = (j - half) * dil;
    const float* wj = w + (size_t)j * C * C;
    for (int c0 = 0; c0 < C; c0 += F_BK) {
      for (int e = threadIdx.x; e < F_BM * F_BK; e += F_THREADS) {
        const int r = e / F_BK, cc = e % F_BK;
        const int t = t0 + r + shift, ci = c0 + cc;
        float v = 0.0f;
        if (t >= 0 && t < T && ci < C) v = lrelu(inb[(size_t)t * C + ci]);
        As[cc][r] = v;
      }
      for (int e = threadIdx.x; e < F_BK * F_BN; e += F_THREADS) {
        const int r = e / F_BN, cc = e % F_BN;
        const int ci = c0 + r, co = n0 + cc;
        Bs[r][cc] = (ci < C && co < C) ? wj[(size_t)ci * C + co] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < F_BK; ++kk) {
        float a[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) bv[jj] = Bs[kk][tx * 8 + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      Cs[(ty * 4 + i) * (F_BN + 4) + tx * 8 + jj] = acc[i][jj];
  __syncthreads();
  epilogue<F_BM, F_BN, F_THREADS>(Cs, F_BN + 4, bias, res, acc_buf, out32,
                                  out_final, b, t0, n0, T, C, flags, scale);
}

}  // namespace

// in, res, acc, out32: f32 [B, T, C]; w: compute dtype [k, C, C];
// bias: f32 [C]; out_final: compute dtype [B, T, C]. bf16 != 0 selects
// the bf16 tensor-core path, which needs C % 8 == 0 and 16-byte aligned
// in / w. Returns the CUDA error of the launch (0 on success).
extern "C" int styler_resblock_conv(const float* in, const void* w,
                                    const float* bias, const float* res,
                                    float* acc, float* out32, void* out_final,
                                    int B, int T, int C, int k, int dil,
                                    int flags, float scale, int bf16,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const size_t smem = bf16_smem_bytes(C, k, dil);
    cudaError_t err = cudaFuncSetAttribute(
        resblock_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((T + H_BM - 1) / H_BM, (C + H_BN - 1) / H_BN, B);
    resblock_conv_bf16_kernel<<<grid, H_THREADS, smem, s>>>(
        in, (const __nv_bfloat16*)w, bias, res, acc, out32,
        (__nv_bfloat16*)out_final, T, C, k, dil, flags, scale);
  } else {
    const dim3 grid((T + F_BM - 1) / F_BM, (C + F_BN - 1) / F_BN, B);
    resblock_conv_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        in, (const float*)w, bias, res, acc, out32, (float*)out_final, T, C,
        k, dil, flags, scale);
  }
  return (int)cudaGetLastError();
}

