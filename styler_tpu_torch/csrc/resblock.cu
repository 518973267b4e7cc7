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
//   ACT_OUT    out = bf16(leaky_relu(v))        (bf16 mode only)
//   otherwise  out32 = v
// and IN_ACT (bf16 mode only) says the input is that ACT_OUT output, so
// A_j is read as it is. The wrapper gives a pair's first conv ACT_OUT and
// its second IN_ACT: the second conv computed exactly bf16(lrelu(y)) from
// an f32 y before, so the result is the same bit for bit and the pair
// moves 16 bytes per element through HBM instead of 20. Which is the TPU
// kernel's arithmetic: the carry between convs is f32 and only the stage
// output is cast to the compute dtype.
//
// bf16 mode (the main path), one kernel templated on the output tile:
//  - N tile BN = the smallest of 32, 64, 128 that holds C (128 with
//    grid.y = ceil(C / 128) above), so no warp multiplies zero-filled
//    weights; warps of mma.sync m16n8k16 (bf16 in, f32 sums) tile M (and
//    N at BN = 128), each warp 16 x 32 up to 32 x 64 outputs (16 to 64
//    f32 accumulators per thread). Tiles (BM x BN, threads, warps M x N),
//    first choice first, ordered by a sweep on an H100 (PERF.md,
//    tools/resblock_tiles.py):
//      BN =  32: 256 x 32, 256, 8 x 1;  128 x 32, 256, 8 x 1
//      BN =  64: 256 x 64, 256, 8 x 1;  128 x 64, 256, 8 x 1
//      BN = 128: 128 x 128, 256, 4 x 2; 256 x 128, 512, 8 x 2;
//                64 x 128, 256, 4 x 2
//    The host takes the first tile whose shared memory lets 512 threads
//    share an SM (2 CTAs of 256, 1 of 512), else the first that fits at
//    all; the others are what the sweep measures against. 32 x 64 warp
//    tiles read the fewest fragment bytes per product, which is why
//    BN = 128 splits its warps along N.
//  - The CTA stages its rows plus the conv's halo ((k-1)/2 * dil rows each
//    side) ONCE, activated and in bf16, in a slab of pitch round16(C) + 8
//    (an odd multiple of 16 bytes, so the 8 rows an ldmatrix reads fall in
//    distinct banks at any row shift); each tap reads its A fragments from
//    the slab at its shift (j - half) * dil with ldmatrix, B fragments from
//    the [k, Cin, Cout] weights with ldmatrix.trans.
//  - Weights: where the conv's whole [k, Cin, BN] slice fits beside the
//    slab within that budget (BN <= 64: C <= 32 always, C <= 64 for
//    k <= 7), it is loaded once with cp.async while the slab fills, and
//    the product loop has no barrier (the RESIDENT instance). Otherwise a
//    ring of 3 stages of 64 input channels x BN (cp.async.wait_group 1,
//    one __syncthreads per step).
//  - The epilogue works from registers: the m16n8 accumulator layout puts
//    rows lane/4 and lane/4 + 8, columns 2 * (lane % 4) + {0, 1} in each
//    thread, so bias, residual, branch sum and the bf16 output go straight
//    to global memory as float2 / bf16x2.
//  Shared memory at k = 11, dil = 5 (the largest halo) on the HiFi-GAN
//  stages: C = 32: 52,640 B (resident); C = 64: 71,712 B (ring); C = 128:
//  100,640 B (ring), 2 CTAs per SM; C = 256: 213,792 B (256 x 128, 512
//  threads, ring), 1 CTA of 16 warps, which at T = 8192 is one wave of 128
//  CTAs. ptxas: at most 120 registers, no spills (PERF.md).
//
// Bound on the H100: per stage 126 taps x 2*B*T*C^2 operations (2.7e11 at
// C = 256, 5.4e11 at 128, 2.7e11 at 64, 1.35e11 at 32 on the HiFi-GAN
// path), 1.231 ms per HiFi-GAN request at 989 TFLOP/s bf16 if the whole
// stage stayed on chip. This 18-launch form also moves per stage about
// 150 bytes per element through HBM (each pair: the f32 carry in, bf16 y
// out and in, the f32 residual in, the f32 carry out; plus the branch sum
// and the final cast): 0.75 ms at 3.35 TB/s for B*T*C = 16.8 M elements,
// about 2.5 ms per HiFi-GAN request, which is this design's floor.
// Hopper's wgmma is not used yet: its shared-memory descriptors must start
// on an 8-row core-matrix (and swizzle-atom) boundary, while a tap's A
// operand starts (j - half) * dil rows into the slab (1, 3, 5, 15, 25 ...
// rows). wgmma's RS form (A from registers via ldmatrix) belongs with a
// fused on-chip stage.
//
// f32 mode (parity and tests): 64x64 tiles of plain f32 FMAs (no TF32),
// the input restaged per tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float SLOPE = 0.1f;

enum : int {
  RES = 1, ACC_READ = 2, ACC_WRITE = 4, FINAL = 8, ACT_OUT = 16, IN_ACT = 32
};

__device__ __forceinline__ float lrelu(float x) {
  return x >= 0.0f ? x : x * SLOPE;
}

__device__ __forceinline__ void store_out(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_out(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

// f32 mode's epilogue: Cs holds the f32 sums of a BM x BN tile (row stride ldc).
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

constexpr int KC = 64;         // input channels per weight step (at most)
constexpr int NST = 3;         // weight ring stages
constexpr int SM_THREADS = 512;  // per SM: 2 CTAs of 256 (or 4 of 128)
constexpr size_t SMEM_MAX = 227 * 1024;  // one CTA's limit

// shared memory per CTA that lets SM_THREADS / threads CTAs share an SM's
// 228 KB (1 KB reserved per CTA)
constexpr size_t smem_budget(int threads) {
  return 228 * 1024 / (SM_THREADS / threads) - 1024;
}

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
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo at the lower address
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shapes of one launch that the host and the kernel both derive.
struct Geometry {
  int cp;       // input channels rounded up to the k16 step
  int lds;      // slab pitch (elements): cp + 8, an odd multiple of 16 bytes
  int kc;       // input channels per weight step: min(cp, KC)
  int n_kc;     // weight steps per tap
  int halo;     // rows each side
};

__host__ __device__ __forceinline__ Geometry geometry(int C, int k, int dil) {
  Geometry g;
  g.cp = (C + 15) / 16 * 16;
  g.lds = g.cp + 8;
  g.kc = g.cp < KC ? g.cp : KC;
  g.n_kc = (g.cp + g.kc - 1) / g.kc;
  g.halo = (k - 1) / 2 * dil;
  return g;
}

// RESIDENT: the conv's whole weight slice is loaded once, no barrier in
// the product loop; else the NST-stage ring.
template <int BN, int WM, int WN, int THREADS, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, SM_THREADS / THREADS)
    resblock_conv_bf16_kernel(const void* __restrict__ in,
                              const __nv_bfloat16* __restrict__ w,
                              const float* __restrict__ bias,
                              const float* res, float* acc_buf, float* out32,
                              __nv_bfloat16* out_final, int T, int C, int k,
                              int dil, int flags, float scale) {
  constexpr int WARPS_N = BN / WN;
  constexpr int WARPS_M = THREADS / 32 / WARPS_N;
  constexpr int BM = WARPS_M * WM;
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int NT = WN / 8;   // n8 tiles per warp
  constexpr int LDW = BN + 8;  // weight row pitch: an odd multiple of 16 bytes
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BN % WN == 0, "tile");

  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g = geometry(C, k, dil);
  const int half = (k - 1) / 2;
  const int rows = BM + 2 * g.halo;
  const int n_steps = k * g.n_kc;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wsm = slab + (size_t)rows * g.lds;  // [slots][kc][LDW]

  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // one step's weights: tap j, input channels kc*g.kc .. +g.kc, BN outputs.
  // A thread copies 16 bytes of every RSTEP-th row; what it needs across
  // steps is one offset, one shared address and one predicate.
  constexpr int GPR_W = BN / 8;            // 16-byte groups per weight row
  constexpr int RSTEP = THREADS / GPR_W;   // rows per pass of the CTA
  const int w_r0 = tid / GPR_W, w_c8 = tid % GPR_W * 8;
  const bool w_col_ok = n0 + w_c8 < C;
  const int w_thr = w_r0 * C + n0 + w_c8;  // offset within a [Cin, Cout] tap
  __nv_bfloat16* const w_dst = wsm + w_r0 * LDW + w_c8;
  auto load_weights = [&](int step) {
    const int j = step / g.n_kc, kc = step - j * g.n_kc;
    const int slot = RESIDENT ? step : step % NST;
    const int c_lo = kc * g.kc;
    const int n_rows = min(g.kc, g.cp - c_lo);
    const __nv_bfloat16* src = w + ((size_t)j * C + c_lo) * C + w_thr;
    __nv_bfloat16* dst = w_dst + slot * g.kc * LDW;
    for (int r = w_r0; r < n_rows; r += RSTEP) {
      const bool ok = w_col_ok && c_lo + r < C;
      cp_async16(dst, ok ? src : w, ok);
      src += RSTEP * C;
      dst += RSTEP * LDW;
    }
  };

  // the slab: rows t0 - halo .. t0 + BM + halo, 8 channels per 16 bytes
  const int gpr = g.cp / 8;
  const int n_groups = rows * gpr;
  if (flags & IN_ACT) {  // already activated bf16: copy as it is
    const __nv_bfloat16* inb =
        static_cast<const __nv_bfloat16*>(in) + (size_t)b * T * C;
#pragma unroll 1
    for (int p = tid; p < n_groups; p += THREADS) {
      const int r = p / gpr, c8 = (p - r * gpr) * 8;
      const int t = t0 - g.halo + r;
      const bool ok = t >= 0 && t < T && c8 < C;
      cp_async16(slab + (size_t)r * g.lds + c8,
                 ok ? inb + (size_t)t * C + c8 : inb, ok);
    }
    cp_async_commit();
  }
  if (RESIDENT) {
    for (int s = 0; s < n_steps; ++s) load_weights(s);
    cp_async_commit();
  } else {
    for (int s = 0; s < NST - 1; ++s) {
      if (s < n_steps) load_weights(s);
      cp_async_commit();
    }
  }
  if (!(flags & IN_ACT)) {  // f32: leaky-ReLU and round to bf16 on the way
    const float* inb = static_cast<const float*>(in) + (size_t)b * T * C;
    constexpr int U = 4;  // 8 loads of 16 bytes in flight per thread
#pragma unroll 1
    for (int p0 = tid; p0 < n_groups; p0 += THREADS * U) {
      float4 v[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * THREADS;
        const int r = p / gpr, c8 = (p - r * gpr) * 8;
        const int t = t0 - g.halo + r;
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < n_groups && t >= 0 && t < T && c8 < C) {
          const float4* src =
              reinterpret_cast<const float4*>(inb + (size_t)t * C + c8);
          v[u][0] = src[0];
          v[u][1] = src[1];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * THREADS;
        if (p >= n_groups) break;
        const int r = p / gpr, c8 = (p - r * gpr) * 8;
        uint4 q;
        q.x = pack_bf16x2(lrelu(v[u][0].x), lrelu(v[u][0].y));
        q.y = pack_bf16x2(lrelu(v[u][0].z), lrelu(v[u][0].w));
        q.z = pack_bf16x2(lrelu(v[u][1].x), lrelu(v[u][1].y));
        q.w = pack_bf16x2(lrelu(v[u][1].z), lrelu(v[u][1].w));
        *reinterpret_cast<uint4*>(slab + (size_t)r * g.lds + c8) = q;
      }
    }
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wm0 = warp / WARPS_N * WM;
  const int wn0 = warp % WARPS_N * WN;
  // a warp whose rows all lie past T or whose columns all lie past C skips
  // its products (it still takes part in every barrier)
  const bool live = t0 + wm0 < T && n0 + wn0 < C;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;

  // per-lane ldmatrix addresses: A rows lane % 16 at column (lane / 16) * 8
  // of the warp's first row; B (k rows) lane % 16 at column (lane / 16) * 8
  // of the warp's first output channel
  const uint32_t a_lane =
      smem_u32(slab) +
      ((g.halo + wm0 + lane % 16) * g.lds + lane / 16 * 8) * 2;
  const uint32_t b_lane =
      smem_u32(wsm) + ((lane % 16) * LDW + wn0 + lane / 16 * 8) * 2;
  const uint32_t slot_bytes = g.kc * LDW * 2;
  const uint32_t a_m16 = 16 * g.lds * 2;  // bytes between a warp's m16 tiles

  if (RESIDENT) {
    cp_async_wait<0>();
    __syncthreads();
  }
  int step = 0;
  for (int j = 0; j < k; ++j) {
    const uint32_t a_tap = a_lane + (j - half) * dil * g.lds * 2;
    for (int kc = 0; kc < g.n_kc; ++kc, ++step) {
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
      const uint32_t a_k = a_tap + kc * g.kc * 2;
      const uint32_t b_k = b_lane + slot * slot_bytes;
      // one k16 step of the warp tile: A fragments of every m16 tile, then
      // per pair of n8 tiles one ldmatrix.trans and 2 x MT products
      auto k16 = [&](int kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(a[i], a_k + i * a_m16 + kk * 32);
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t bq[4];  // n8 tiles 2p and 2p + 1, k 0-7 and 8-15
          ldsm_x4_trans(bq, b_k + (kk * 16 * LDW + p * 16) * 2);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[i][2 * p], a[i], bq[0], bq[1]);
            mma_bf16(acc[i][2 * p + 1], a[i], bq[2], bq[3]);
          }
        }
      };
      const int nk = min(g.kc, g.cp - kc * g.kc) / 16;
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) k16(kk);
    }
  }
  if (!live) return;

  // epilogue from registers; C % 8 == 0, so a column pair is all in or out.
  // Per n8 tile: its residual and branch-sum reads, then the adds, then the
  // stores (res may alias out32: the carry is updated in place, which also
  // keeps the next tile's reads behind these stores and the registers in
  // flight at 4 x MT float2).
  const int r_lane = t0 + wm0 + lane / 4;
  const int c_lane = n0 + wn0 + lane % 4 * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int co = c_lane + n * 8;
    float2 r[MT][2], a[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r_lane + i * 16 + h * 8;
        const size_t idx = ((size_t)b * T + t) * C + co;
        const bool in_tile = t < T && co < C;
        r[i][h] = a[i][h] = make_float2(0.f, 0.f);
        if (in_tile && (flags & RES))
          r[i][h] = *reinterpret_cast<const float2*>(res + idx);
        if (in_tile && (flags & ACC_READ))
          a[i][h] = *reinterpret_cast<const float2*>(acc_buf + idx);
      }
    if (co >= C) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r_lane + i * 16 + h * 8;
        if (t >= T) continue;
        const size_t idx = ((size_t)b * T + t) * C + co;
        float v0 = acc[i][n][2 * h] + bb.x, v1 = acc[i][n][2 * h + 1] + bb.y;
        if (flags & RES) v0 = r[i][h].x + v0, v1 = r[i][h].y + v1;
        if (flags & ACC_READ) v0 = a[i][h].x + v0, v1 = a[i][h].y + v1;
        if (flags & FINAL) {
          *reinterpret_cast<uint32_t*>(out_final + idx) =
              pack_bf16x2(v0 * scale, v1 * scale);
        } else if (flags & ACC_WRITE) {
          *reinterpret_cast<float2*>(acc_buf + idx) = make_float2(v0, v1);
        } else if (flags & ACT_OUT) {
          *reinterpret_cast<uint32_t*>(out_final + idx) =
              pack_bf16x2(lrelu(v0), lrelu(v1));
        } else {
          *reinterpret_cast<float2*>(out32 + idx) = make_float2(v0, v1);
        }
      }
  }
}

using Bf16Kernel = void (*)(const void*, const __nv_bfloat16*, const float*,
                            const float*, float*, float*, __nv_bfloat16*, int,
                            int, int, int, int, float);

struct Tile {
  int bn, wm, wn, threads, bm;
  Bf16Kernel ring, resident;  // resident: none at BN = 128, where it never fits
};

template <int BN, int WM, int WN, int THREADS = 256>
Tile tile() {
  Bf16Kernel resident = nullptr;
  if constexpr (BN <= 64)
    resident = resblock_conv_bf16_kernel<BN, WM, WN, THREADS, true>;
  return {BN, WM, WN, THREADS, (THREADS / 32) / (BN / WN) * WM,
          resblock_conv_bf16_kernel<BN, WM, WN, THREADS, false>, resident};
}

// per BN, first choice first (see the header)
const Tile TILES[] = {
    tile<32, 32, 32>(),  tile<32, 16, 32>(),        tile<64, 32, 64>(),
    tile<64, 16, 64>(),  tile<128, 32, 64>(),       tile<128, 32, 64, 512>(),
    tile<128, 16, 64>(),
};
constexpr int N_TILES = sizeof(TILES) / sizeof(TILES[0]);
int forced_tile[3] = {-1, -1, -1};  // per BN (32, 64, 128), for tile sweeps

int bn_for(int C) { return C <= 32 ? 32 : C <= 64 ? 64 : 128; }
int bn_index(int bn) { return bn == 32 ? 0 : bn == 64 ? 1 : 2; }

size_t tile_smem(const Tile& t, int C, int k, int dil, int* resident) {
  const Geometry g = geometry(C, k, dil);
  const size_t slab = (size_t)(t.bm + 2 * g.halo) * g.lds * 2;
  const size_t slot = (size_t)g.kc * (t.bn + 8) * 2;
  const int n_steps = k * g.n_kc;
  if (t.resident && slab + n_steps * slot <= smem_budget(t.threads)) {
    *resident = 1;
    return slab + n_steps * slot;
  }
  *resident = 0;
  return slab + (n_steps < NST ? n_steps : NST) * slot;
}

struct Plan {
  const Tile* tile;
  int resident;
  size_t smem;
  dim3 grid;
  Bf16Kernel fn;
};

// The tile of one bf16 launch; cudaErrorInvalidValue if none fits.
cudaError_t plan_bf16(int B, int T, int C, int k, int dil, Plan* plan) {
  if (C % 8 || C <= 0 || T <= 0 || B <= 0 || k <= 0 || k % 2 == 0 || dil <= 0)
    return cudaErrorInvalidValue;
  const int bn = bn_for(C);
  const Tile* best = nullptr;
  int best_res = 0;
  size_t best_smem = 0;
  const int forced = forced_tile[bn_index(bn)];
  for (int pass = 0; pass < 3 && !best; ++pass) {
    // 0: the forced tile; 1: the first within its budget; 2: any
    for (int i = 0; i < N_TILES && !best; ++i) {
      if (TILES[i].bn != bn || (pass == 0 && i != forced)) continue;
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
  plan->fn = best_res ? best->resident : best->ring;
  return cudaFuncSetAttribute(plan->fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)best_smem);
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

// in: f32 [B, T, C], or with IN_ACT bf16; res, acc, out32: f32 [B, T, C];
// w: compute dtype [k, C, C]; bias: f32 [C]; out_final: compute dtype
// [B, T, C] (FINAL's output, and ACT_OUT's). bf16 != 0 selects the bf16
// tensor-core path, which needs C % 8 == 0 and 16-byte aligned in / w;
// ACT_OUT and IN_ACT exist only there. Returns the CUDA error of the
// launch (0 on success).
extern "C" int styler_resblock_conv(const void* in, const void* w,
                                    const float* bias, const float* res,
                                    float* acc, float* out32, void* out_final,
                                    int B, int T, int C, int k, int dil,
                                    int flags, float scale, int bf16,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    Plan p;
    const cudaError_t err = plan_bf16(B, T, C, k, dil, &p);
    if (err != cudaSuccess) return (int)err;
    p.fn<<<p.grid, p.tile->threads, p.smem, s>>>(
        in, (const __nv_bfloat16*)w, bias, res, acc, out32,
        (__nv_bfloat16*)out_final, T, C, k, dil, flags, scale);
  } else {
    if (flags & (ACT_OUT | IN_ACT)) return (int)cudaErrorInvalidValue;
    const dim3 grid((T + F_BM - 1) / F_BM, (C + F_BN - 1) / F_BN, B);
    resblock_conv_f32_kernel<<<grid, F_THREADS, 0, s>>>(
        (const float*)in, (const float*)w, bias, res, acc, out32,
        (float*)out_final, T, C, k, dil, flags, scale);
  }
  return (int)cudaGetLastError();
}

// What a bf16 launch of this shape runs: out[0..9] = BM, BN, WN, threads,
// grid x, y, z, dynamic shared memory bytes, resident weights (0/1), CTAs
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA
// error.
extern "C" int styler_resblock_bf16_plan(int B, int T, int C, int k, int dil,
                                         int* out) {
  Plan p;
  cudaError_t err = plan_bf16(B, T, C, k, dil, &p);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, p.fn, p.tile->threads, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int v[10] = {p.tile->bm,     p.tile->bn,    p.tile->wn,
                     p.tile->threads, (int)p.grid.x, (int)p.grid.y,
                     (int)p.grid.z,   (int)p.smem,   p.resident,
                     ctas};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// Tile sweeps: force the bf16 launches of N tile `bn` onto the tile of BM
// rows, warp width `wn` and `threads` per CTA (it must fit in shared
// memory; else the usual choice is made); bm = 0 restores the usual
// choice. Returns cudaErrorInvalidValue for a tile the library does not
// have.
extern "C" int styler_resblock_bf16_force_tile(int bn, int bm, int wn,
                                               int threads) {
  if (bn != 32 && bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  if (bm == 0) {
    forced_tile[bn_index(bn)] = -1;
    return 0;
  }
  for (int i = 0; i < N_TILES; ++i) {
    if (TILES[i].bn == bn && TILES[i].bm == bm && TILES[i].wn == wn &&
        TILES[i].threads == threads) {
      forced_tile[bn_index(bn)] = i;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}
