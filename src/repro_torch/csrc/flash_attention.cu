// Online-softmax ("flash") attention for Hopper (sm_90a), causal and/or
// sliding-window, with GQA, with a plain C interface loaded through ctypes
// by repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:32
// (flash_attention_kernel, via flash_attention_pallas and
// ops.flash_attention):
//
//     o[i] = sum_j softmax_j(scale * q[i] . k[j] | mask) v[j]
//     mask: j < Sk, and j <= i if causal, and j > i - window if window > 0
//
// q (BH, Sq, Dq), k (BKV, Sk, Dq), v (BKV, Sk, Dv), o (BH, Sq, Dv), all
// float32 or all bfloat16; query head bh reads key/value head bh / group
// (GQA without expanded copies).  The running max, sum and accumulator are
// float32; with bfloat16 inputs the probabilities are rounded to bfloat16
// before the product with v, as the TPU kernel does.  Scale is 1/sqrt(Dq)
// unless given.  On the LM path: jamba's attention layer, BH = 4 x 32
// heads over 4 x 8 KV heads, S = 2048 (scoring) or 512 (prefill), D = 128,
// bfloat16.
//
// What bounds it on this card: the two products, 2 Sq Sk D multiply-adds
// (about half of that under a causal mask) against one read of q, k, v and
// one write of o, so it is bound by arithmetic at these shapes: the tensor
// cores in bfloat16, the CUDA cores in float32.
//
// What the design does about it: a TMA + wgmma kernel template at four
// head-dim pairs, a CUDA-core kernel and the earlier mma.sync kernel, each
// with its own entry point; the host's plan (kernels/flash_attention.py)
// picks by type, head dims and alignment alone:
//
//   * wgmma -- bfloat16, Dq == Dv == 128, 16-byte-aligned q, k, v, o (the
//     LM path): TMA + wgmma, warp-specialised (see
//     flash_attention_wgmma_kernel below).
//   * wgmma_dv -- the same kernel at Dq != Dv: bfloat16, (Dq, Dv) = (96,
//     64), MLA's heads (minicpm3-4b's prefill and scoring), 16-byte
//     aligned; its own entry point.
//   * wgmma_120, wgmma_96 -- the same kernel at (Dq, Dv) = (120, 120)
//     (h2o-danube3-4b: GQA 32 / 8 with a 4096-key window) and (96, 96)
//     (phi3-vision-4b), bfloat16, 16-byte aligned; an entry point each.
//   * cuda_core -- everything else (float32, other head dims, unaligned
//     bfloat16): one thread block per (head, 64-row query tile),
//     heavy (late) causal tiles launched first.  Each of the 256 threads
//     owns a 4 x 4 block of the score tile and a 4-row strip of the output
//     tile; q and k tiles sit transposed in shared memory so each d step is
//     two 16-byte loads for 16 FMAs (float32 arithmetic), and the
//     probability tile reuses the k tile's shared memory, so two blocks
//     fit on an SM at D = 128.  Row max and sum are reduced with warp
//     shuffles.  Ragged Sq and Sk are bounds-checked; there is no padding.
//   * mma_sync -- the tensor-core kernel that served the LM path before the
//     wgmma one (mma.sync m16n8k16, 64-row query tiles, synchronous k and v
//     copies); reachable only through its own entry point, kept as the
//     timed yardstick of the wgmma kernel.
//
// All of them: the softmax runs in base 2 with scale * log2(e) folded in,
// and a block walks only the key tiles from the first one inside the
// window up to the diagonal -- tiles wholly outside the mask are skipped,
// not computed and masked.  Skipping changes nothing: masked scores are
// NEG, not -inf, so a row's first visited keys that are masked add
// exp(NEG - NEG) = 1 terms, which the first valid key multiplies by
// exp(NEG - m) = 0, exactly as in the TPU kernel; l is flushed at 1e-30,
// as there.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

#define NEG_F (-1e18f)

namespace {

using namespace hopper;

constexpr int BQ = 64;        // query rows per block
constexpr int BKT = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int LDT = 68;       // padded row of the transposed q / k / p tiles
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
// the probability as the product with v sees it (bf16 inputs: rounded)
template <typename T> __device__ __forceinline__ float p_round(float p) {
  return to_f(from_f<T>(p));
}

template <int DMAX>
constexpr int smem_floats() {
  // Qt [DMAX][LDT], Kt [DMAX][LDT] (later Pt [BKT][LDT]), Vs [BKT][DMAX+4]
  return 2 * DMAX * LDT + BKT * (DMAX + 4);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int Sq, int Sk, int Dq, int Dv, int causal, int window,
                       float scale2) {
  constexpr int NJ = DMAX / 64;   // 64-column groups of the output strip
  constexpr int LDV = DMAX + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // Qt[d * LDT + r]
  float* Kt = smem + DMAX * LDT;          // Kt[d * LDT + c]
  float* Pt = Kt;                         // Pt[c * LDT + r], reuses Kt
  float* Vs = smem + 2 * DMAX * LDT;      // Vs[c * LDV + e]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int qtile = gridDim.x - 1 - blockIdx.x;    // late tiles first
  const int64_t bh = blockIdx.y;
  const int64_t kvh = bh / group;
  const int r0 = qtile * BQ;
  const int nj = (Dv + 63) / 64;

  const T* qb = q + (bh * Sq + r0) * Dq;
  const T* kb = k + kvh * Sk * Dq;
  const T* vb = v + kvh * Sk * Dv;

  for (int i = tid; i < BQ * Dq; i += THREADS) {
    const int r = i / Dq, d = i - r * Dq;
    Qt[d * LDT + r] = (r0 + r < Sq) ? to_f(qb[i]) : 0.f;
  }

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_F;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][jj][j] = 0.f;
  }

  const int kbeg = window > 0 ? max(0, r0 - window + 1) : 0;
  const int kend = causal ? min(Sk, r0 + BQ) : Sk;
  for (int c0 = kbeg - kbeg % BKT; c0 < kend; c0 += BKT) {
    __syncthreads();                  // last tile's readers of Pt, Vs done
    for (int i = tid; i < BKT * Dq; i += THREADS) {
      const int c = i / Dq, d = i - c * Dq;
      Kt[d * LDT + c] = (c0 + c < Sk) ? to_f(kb[(int64_t)c0 * Dq + i]) : 0.f;
    }
    for (int i = tid; i < BKT * nj * 64; i += THREADS) {
      const int c = i / (nj * 64), e = i - c * (nj * 64);
      Vs[c * LDV + e] = (c0 + c < Sk && e < Dv)
                            ? to_f(vb[(int64_t)(c0 + c) * Dv + e]) : 0.f;
    }
    __syncthreads();

    // scores of rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dq; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * LDT + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * LDT + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, online softmax (base 2), rescale the accumulator
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      float mx = NEG_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * tx + j;
        const bool ok = c < Sk && (!causal || c <= r) &&
                        (window <= 0 || c > r - window);
        s[i][j] = ok ? s[i][j] * scale2 : NEG_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][jj][j] *= alpha;
    }
    __syncthreads();                  // every reader of Kt is done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 pv;
      pv.x = p_round<T>(s[0][j]);
      pv.y = p_round<T>(s[1][j]);
      pv.z = p_round<T>(s[2][j]);
      pv.w = p_round<T>(s[3][j]);
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * LDT + 4 * ty) = pv;
    }
    __syncthreads();

    // acc += P V over this tile's keys
    for (int c = 0; c < BKT; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + c * LDT + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj < nj) {
          const float4 b = *reinterpret_cast<const float4*>(
              Vs + c * LDV + 64 * jj + 4 * tx);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][jj][j] = fmaf(av[i], bv[j], acc[i][jj][j]);
        }
      }
    }
  }

  T* ob = o + (bh * Sq + r0) * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r0 + r >= Sq) continue;
    const float lv = fmaxf(l[i], 1e-30f);   // as the TPU kernel's flush
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 64 * jj + 4 * tx + j;
        if (e < Dv) ob[(int64_t)r * Dv + e] = from_f<T>(acc[i][jj][j] / lv);
      }
  }
}

template <typename T, int DMAX>
int launch(const T* q, const T* k, const T* v, T* o, int bh, int group,
           int Sq, int Sk, int Dq, int Dv, int causal, int window,
           float scale, cudaStream_t stream) {
  const int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  // above 48 KB only after this opt-in (per device, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, bh);
  flash_attention_kernel<T, DMAX><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, group, Sq, Sk, Dq, Dv, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 with Dq == Dv == 128: tensor cores via mma.sync (the yardstick)
// ---------------------------------------------------------------------------
//
// Four warps per block, 16 query rows each.  A warp keeps its q rows as
// mma A fragments in registers for the whole key loop, computes each
// 16 x 64 score tile with m16n8k16 bf16 products (float32 sums), applies
// the mask and the online softmax on the accumulator fragments, and feeds
// the probabilities -- rounded to bf16 -- straight back as the A operand
// of the product with v (the score accumulator's layout is the A layout).
// k and v tiles are staged row-major in padded shared memory; v's B
// fragments come transposed through ldmatrix.trans.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int group, int Sq,
                           int Sk, int causal, int window, float scale2) {
  using bf = __nv_bfloat16;
  constexpr int LD = HD + 8;            // padded row (bf16) of the k, v tiles
  constexpr int KS = HD / 16;           // 16-deep k steps over the head dim
  constexpr int NT = BKT / 8;           // 8-key column tiles of a score tile
  constexpr int DT = HD / 8;            // 8-wide column tiles of the output
  __shared__ __align__(16) bf Ks[BKT * LD];
  __shared__ __align__(16) bf Vs[BKT * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;          // fragment row / column
  const int qtile = gridDim.x - 1 - blockIdx.x;   // late tiles first
  const int64_t bh = blockIdx.y;
  const int64_t kvh = bh / group;
  const int r0 = qtile * BQ;
  const int rw = r0 + 16 * warp;                  // this warp's first row

  const bf* qb = q + bh * Sq * HD;
  const bf* kb = k + kvh * Sk * HD;
  const bf* vb = v + kvh * Sk * HD;

  // q rows rw + g and rw + g + 8 as A fragments (zero past Sq)
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int col = 16 * ks + 2 * tg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + g + 8 * h;
      const bool ok = row < Sq;
      qa[ks][h] = ok ? *reinterpret_cast<const uint32_t*>(
                           qb + (int64_t)row * HD + col) : 0u;
      qa[ks][2 + h] = ok ? *reinterpret_cast<const uint32_t*>(
                               qb + (int64_t)row * HD + col + 8) : 0u;
    }
  }

  float m[2] = {NEG_F, NEG_F}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dt][j] = 0.f;

  const int kbeg = window > 0 ? max(0, r0 - window + 1) : 0;
  const int kend = causal ? min(Sk, r0 + BQ) : Sk;
  for (int c0 = kbeg - kbeg % BKT; c0 < kend; c0 += BKT) {
    __syncthreads();                    // last tile's readers are done
    for (int i = threadIdx.x; i < BKT * HD / 8; i += MMA_THREADS) {
      const int row = i / (HD / 8), c8 = 8 * (i % (HD / 8));
      const bool ok = c0 + row < Sk;
      const int64_t off = (int64_t)(c0 + row) * HD + c8;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(Ks + row * LD + c8) =
          ok ? *reinterpret_cast<const uint4*>(kb + off) : zero;
      *reinterpret_cast<uint4*>(Vs + row * LD + c8) =
          ok ? *reinterpret_cast<const uint4*>(vb + off) : zero;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf* kr = Ks + (8 * nt + g) * LD + 16 * ks + 2 * tg;
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // mask, online softmax (base 2) on rows rw + g (h = 0), rw + g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + g + 8 * h;
      float mx = NEG_F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + 8 * nt + 2 * tg + j;
          const bool ok = c < Sk && (!causal || c <= r) &&
                          (window <= 0 || c > r - window);
          float& x = s[nt][2 * h + j];
          x = ok ? x * scale2 : NEG_F;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = exp2f(m[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * h + j];
          x = exp2f(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[h] = l[h] * alpha + rs;
      m[h] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * h] *= alpha;
        acc[dt][2 * h + 1] *= alpha;
      }
    }

    // acc += P V: the score fragments of key columns 16kk.. are the A
    // fragment of k step kk
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        // lanes 0-15 address keys 16kk + lane at columns 8dt..; lanes
        // 16-31 the same keys at columns 8(dt + 1)..
        const bf* vr = Vs + (16 * kk + (lane % 16)) * LD + 8 * dt
                       + 8 * (lane / 16);
        const uint32_t addr =
            (uint32_t)__cvta_generic_to_shared(reinterpret_cast<const void*>(vr));
        uint32_t b[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(addr));
        mma_bf16(acc[dt], pa, b[0], b[1]);
        mma_bf16(acc[dt + 1], pa, b[2], b[3]);
      }
    }
  }

  bf* ob = o + bh * Sq * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    if (r >= Sq) continue;
    const float lv = fmaxf(l[h], 1e-30f);   // as the TPU kernel's flush
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r * HD + 8 * dt + 2 * tg) =
          pack_bf16(acc[dt][2 * h] / lv, acc[dt][2 * h + 1] / lv);
  }
}

template <int HD>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, int bh, int group,
               int Sq, int Sk, int causal, int window, float scale,
               cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, bh);
  flash_attention_mma_kernel<HD><<<grid, MMA_THREADS, 0, stream>>>(
      q, k, v, o, group, Sq, Sk, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, 16-byte aligned, (Dq, Dv) = (128, 128) (the LM path), (96, 64)
// (MLA), (120, 120) (h2o-danube3) or (96, 96) (phi3-vision): TMA + wgmma,
// warp-specialised
// ---------------------------------------------------------------------------
//
// A persistent grid of at most one 384-thread block per SM walks the work
// items -- (128-row query tile, query head) -- heaviest causal tiles first,
// heads fastest, so the items in flight share key/value heads in the L2,
// every other round of items dealt out to the blocks backwards.
// A producer warpgroup (registers lowered by setmaxnreg) has one thread
// issue TMA; two consumer warpgroups (registers raised) own 64 query rows
// each.  q, k, v and o are read and written through 3-D tensor maps (D, S,
// heads) in the 128-byte swizzle, as boxes of 64 columns (the widest a
// swizzled box may be): TMA zero-fills rows past S within a head and clips
// stores at Sq, where a 2-D (heads * S, D) map would read, and overwrite,
// the next head's rows.  Shared memory (Cfg below): two q tiles (128 rows,
// one per item in turn, so the next item's q loads under this one) and a
// ring of STAGES 128-key tiles of k and of v, every slot with a full and an
// empty mbarrier; the ring runs on across items.  Per key tile, a consumer
// warpgroup computes S = q k^T with wgmma m64n128k16 (both operands K-major
// in shared memory, Dq / 16 k steps; S in 64 float32 registers a thread),
// masks it only where the tile crosses the diagonal, the window's edge or
// Sk, runs the online softmax on the accumulator fragments (row max and sum
// reduced across the quad), rounds P to bf16 pairs in registers -- a
// 16-column slice of the accumulator is laid out as a wgmma A fragment --
// and adds P v with wgmma m64n{Dv}k16 from registers, v read N-major
// through the transpose bit.  The two warpgroups take turns issuing their
// products, so one's softmax runs under the other's products.  The epilogue
// divides by l, stages the warpgroup's 64 rows in its half of the item's q
// buffer (its q k^T are done) and writes them with TMA stores that drain
// under the next item.
//
// At MLA's heads (Dq 96, Dv 64) the work per score is 160 multiply-adds,
// not 256, while the softmax's exponentials stay one per score: they bound
// the kernel nearly as much as the products do (exp floor 0.0201 ms against
// the 0.0272 ms FLOP bound at 40 heads x S 2048), so the turn-taking that
// hides one warpgroup's softmax under the other's products matters more.
// q and k rows are 192 bytes: a tile is two 64-column boxes and TMA
// zero-fills columns 96-127 of the second (the barrier counts them); q k^T
// issues 6 k steps, never multiplying the zero columns.  v and o are one
// box a tile; P v is m64n64k16, the accumulator 32 registers a thread.  The
// 16 KB v tiles leave room for a ring of 3 stages (2 at 128 / 128).
//
// Widths that are not whole boxes ((120, 120), (96, 96)): every tile of q,
// k and v is ceil(D / 64) boxes, TMA zero-filling the columns past D (the
// maps are D wide; the barriers count the filled bytes).  q k^T issues
// ceil(Dq / 16) k steps -- at 120 the eighth multiplies columns 112-127,
// whose last 8 are zero in q and in k, so it adds exact zeros.  P v is
// issued at n = Dv, m64n120k16 and m64n96k16, ending inside the second
// 64-column atom of the swizzled v tile: on an H100 that gives what P v
// at the boxes' width (m64n128k16 over the zero-filled columns) gives, and
// is 2% (120) and 10% (96) faster (tools/flash_breakdown.py, pv_boxes).
// The epilogue stages o's Dv columns in the q buffer's boxes, and the o
// store, through a map Dv wide, clips the rest of the last box: nothing
// past Dv is written.  The ring is 2 stages deep at both, as at 128 / 128.
//
// Measured and rejected on an H100 (PERF.md): issuing the next tile's
// q k^T with this tile's P v and running the softmax under them (no
// faster, and S, P and o then need registers at once); one block per item
// (slower: every block filled and drained its pipeline alone).

namespace wgf {
constexpr int BQ = 128;                    // query rows per work item
constexpr int BK = 128;                    // keys per tile
constexpr int THREADS = 384;               // producer + 2 consumer warpgroups
constexpr int BOX_COLS = 64;               // 128-byte-swizzled box width
constexpr int BOX_BYTES = 128 * 128;       // 128 rows x 128 bytes
constexpr int SMEM_MAX = 232448;           // a block's shared memory, sm_90

// the shared-memory plan of the instance with head dims DQ (q, k) and DV
// (v, o): q and k tiles of ceil(DQ / 64) boxes, v tiles of ceil(DV / 64);
// two q tiles, then a ring of k and v tiles as deep as fits, then the
// barriers.  QK_STEPS: q k^T's 16-deep k steps
template <int DQ, int DV>
struct Cfg {
  static_assert(DQ % 8 == 0 && DV % 8 == 0 && DV <= DQ,
                "rows of whole 16-byte units (TMA); o is staged in the "
                "q buffer's boxes");
  static constexpr int QK_BOXES = (DQ + BOX_COLS - 1) / BOX_COLS;
  static constexpr int V_BOXES = (DV + BOX_COLS - 1) / BOX_COLS;
  static constexpr int QK_STEPS = (DQ + 15) / 16;
  static constexpr int QK_TILE = QK_BOXES * BOX_BYTES;
  static constexpr int V_TILE = V_BOXES * BOX_BYTES;
  static constexpr int STAGES =
      (SMEM_MAX - 1024 - 2 * QK_TILE - 8 * 4) / (QK_TILE + V_TILE + 8 * 4);
  static constexpr int K_OFF = 2 * QK_TILE;  // two q tiles first
  static constexpr int V_OFF = K_OFF + STAGES * QK_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_TILE;
  static constexpr int SMEM_BYTES = BAR_OFF + 8 * (4 + 4 * STAGES) + 1024;
  static_assert(STAGES >= 2 && SMEM_BYTES <= SMEM_MAX, "shared memory");
};
}  // namespace wgf

// exp2 on the special-function unit, one instruction (2^-22 relative
// error; subnormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// scale, mask (MASK: the tile crosses the diagonal, the window's edge or
// Sk) and the online softmax of one 64 x 128 score tile in place, on the
// accumulator fragment: s[4j + 2h + e] is row `row` + 8h, key `col` + 8j + e.
// Updates the running max m and sum l and returns in alpha the factor
// exp2(m_old - m_new) by which each row's accumulator is to be rescaled.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               int row, int col, int Sk,
                                               int causal, int window,
                                               float scale2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    float mx = NEG_F;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        if (MASK) {
          const int c = col + 8 * j + e;
          const bool ok = c < Sk && (!causal || c <= r) &&
                          (window <= 0 || c > r - window);
          x = ok ? x * scale2 : NEG_F;
        } else {
          x *= scale2;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = exp2_approx(m[h] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = exp2_approx(x - m_new);
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[h] = l[h] * alpha[h] + rs;
    m[h] = m_new;
  }
}

// the softmax of the tile of keys c0 .. c0 + 127 for the warpgroup's rows
// lo .. lo + 63, masked only if the tile crosses the diagonal, the window's
// edge or Sk for one of them
__device__ __forceinline__ void tile_softmax(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int row, int col, int c0, int lo,
                                             int Sk, int causal, int window,
                                             float scale2) {
  const bool inside = c0 + wgf::BK <= Sk &&
                      (!causal || c0 + wgf::BK - 1 <= lo) &&
                      (window <= 0 || c0 > lo + 63 - window);
  if (inside)
    online_softmax<false>(s, m, l, alpha, row, c0 + col, Sk, causal, window,
                          scale2);
  else
    online_softmax<true>(s, m, l, alpha, row, c0 + col, Sk, causal, window,
                         scale2);
}

// o's rows rescaled by alpha (the fragment layout of online_softmax)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
}

// P (the softmax tile, rounded to bf16 pairs) as the A fragments of the 8
// k steps over the tile's keys: a 16-column slice of the accumulator is
// laid out as a wgmma A fragment
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// S = q k^T (64 x 128 keys): STEPS = ceil(Dq / 16) k steps, both operands
// K-major; a step is 32 bytes along the swizzled rows of box kk / 4 (16 KB
// apart).  At Dq 96 the last box's columns 96-127 are TMA's zero fill and
// are not multiplied; at Dq 120 columns 120-127 are, by zeros.
template <int STEPS>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q,
                                         uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint32_t off = (kk / 4) * wgf::BOX_BYTES + (kk % 4) * 32;
    const uint64_t dq = sw128_desc(q + off, 16, 1024);
    const uint64_t dk = sw128_desc(k + off, 16, 1024);
    if (kk == 0)
      wgmma_ss_set<0>(s, dq, dk);
    else
      wgmma_ss<0>(s, dq, dk, 1);
  }
  wgmma_commit();
}

// o += P v: v's tile is (keys, Dv), N-major, read through the transpose
// bit; k step kk is 16 key rows, 2048 bytes down each 64-column box (Dv
// 128, 120, 96: two boxes BOX_BYTES apart, the leading offset, m64n{Dv}k16;
// Dv 64: one box, m64n64k16)
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&p)[8][4],
                                         uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < wgf::BK / 16; ++kk)
    wgmma_rs<1>(o, p[kk], sw128_desc(v + kk * 2048, wgf::BOX_BYTES, 1024),
                1);
  wgmma_commit();
}

// work item w of the persistent grid: query tile qtile of head bh, the
// heaviest (latest) causal tiles first, heads fastest, so the items in
// flight share key/value heads in the L2; and the key tiles its rows see
// (tiles wholly outside the mask are skipped, as in the kernels above:
// under a window, those wholly before row r0's first key r0 - window + 1).
// With a window the order is still heaviest first: every query tile past
// the window's reach walks about window / 128 + 1 key tiles, earlier ones
// fewer.
struct Item {
  int bh, kvh, r0, first, ntiles;   // tile i's first key: first + i * BK
  __device__ __forceinline__ Item(int w, int bh_count, int group, int Sq,
                                  int Sk, int causal, int window) {
    const int qtiles = (Sq + wgf::BQ - 1) / wgf::BQ;
    bh = w % bh_count;
    kvh = bh / group;
    r0 = (qtiles - 1 - w / bh_count) * wgf::BQ;
    const int kbeg = window > 0 ? max(0, r0 - window + 1) : 0;
    const int kend = causal ? min(Sk, r0 + wgf::BQ) : Sk;
    first = kbeg - kbeg % wgf::BK;
    ntiles = (kend - first + wgf::BK - 1) / wgf::BK;
  }
};

// the index of this block's n-th work item: the items are dealt out in
// rounds of gridDim.x, every other round backwards, so a block that took
// one of a round's heaviest items takes one of the next round's lightest
// and the blocks' key tiles even out (at MLA's shape, 640 items on 132 SMs,
// the busiest block walks 43 tiles, not 49 as when every round runs
// forwards); the item's tiles, and so its bits, do not depend on the block
__device__ __forceinline__ int item_of(int n) {
  return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int DQ, int DV>
__global__ void __launch_bounds__(wgf::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_o,
                             int bh_count, int group, int Sq, int Sk,
                             int causal, int window, float scale2) {
  using C = wgf::Cfg<DQ, DV>;
  constexpr int STAGES = C::STAGES, BOX_COLS = wgf::BOX_COLS;
  constexpr int BOX_BYTES = wgf::BOX_BYTES;
  extern __shared__ uint8_t smem_fa[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to that
  const uint32_t base = (smem_u32(smem_fa) + 1023u) & ~1023u;
  auto qs = [&](int b) { return base + b * C::QK_TILE; };
  auto ks = [&](int s) { return base + C::K_OFF + s * C::QK_TILE; };
  auto vs = [&](int s) { return base + C::V_OFF + s * C::V_TILE; };
  const uint32_t bars = base + C::BAR_OFF;
  auto q_full = [&](int b) { return bars + 8 * b; };
  auto q_empty = [&](int b) { return bars + 8 * (2 + b); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (4 + STAGES + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (4 + 3 * STAGES + s); };
  const int items = bh_count * ((Sq + wgf::BQ - 1) / wgf::BQ);
  const int wgid = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), 2);     // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgid == 0) {
    // producer: one thread loads each item's q into the q buffer of the
    // item before last, once its o stores have read it, and keeps the k
    // and v rings full across items.  Each barrier expects whole boxes:
    // TMA counts the zero-filled columns and rows too.
    setmaxnreg_dec<40>();
    if (t != 0) return;
    int g = 0, n = 0;               // ring tiles and items so far
    for (int w = item_of(0); w < items; w = item_of(++n)) {
      const Item it(w, bh_count, group, Sq, Sk, causal, window);
      const int b = n % 2;
      mbar_wait(q_empty(b), ((n / 2) & 1) ^ 1);
      mbar_expect_tx(q_full(b), C::QK_TILE);
      for (int j = 0; j < C::QK_BOXES; ++j)
        tma_load_3d(qs(b) + j * BOX_BYTES, &map_q, j * BOX_COLS, it.r0, it.bh,
                    q_full(b));
      for (int i = 0; i < it.ntiles; ++i, ++g) {
        const int s = g % STAGES, phase = (g / STAGES) & 1;
        const int c0 = it.first + i * wgf::BK;
        mbar_wait(k_empty(s), phase ^ 1);
        mbar_expect_tx(k_full(s), C::QK_TILE);
        for (int j = 0; j < C::QK_BOXES; ++j)
          tma_load_3d(ks(s) + j * BOX_BYTES, &map_k, j * BOX_COLS, c0, it.kvh,
                      k_full(s));
        mbar_wait(v_empty(s), phase ^ 1);
        mbar_expect_tx(v_full(s), C::V_TILE);
        for (int j = 0; j < C::V_BOXES; ++j)
          tma_load_3d(vs(s) + j * BOX_BYTES, &map_v, j * BOX_COLS, c0, it.kvh,
                      v_full(s));
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each item's tile;
  // thread t holds rows rw and rw + 8 of them, key columns 2 (t % 4) + 8j
  // (+ 1).  Per key tile: S = q k^T, the softmax, o += P v.  The two
  // warpgroups take turns on the tensor cores (named barriers PING + c): a
  // turn is one P v and the next q k^T, and passes when they are issued, so
  // one warpgroup's softmax runs under the other's products.  Within a
  // warpgroup the products wait for each other: S, P and o never need
  // registers at once, so the products are not serialised for lack of them.
  setmaxnreg_inc<232>();
  const int c = wgid - 1;
  const int warp = t / 32, lane = t % 32;
  const int rw = 16 * warp + lane / 4, col = 2 * (lane % 4);
  float o[DV / 2], s_acc[64];
  float m[2], l[2], alpha[2];
  uint32_t p[8][4];
  constexpr int PING = 3;            // named barriers 3 and 4 (1, 2: epilogue)
  auto my_turn = [&]() { named_bar_sync(PING + c, 256); };
  auto your_turn = [&]() { named_bar_arrive(PING + 1 - c, 256); };

  if (c == 1) your_turn();           // warpgroup 0 goes first
  int g = 0, n = 0;
  for (int w = item_of(0); w < items; w = item_of(++n)) {
    const Item it(w, bh_count, group, Sq, Sk, causal, window);
    const int lo = it.r0 + 64 * c, row = lo + rw;
    const uint32_t qa = qs(n % 2) + c * 64 * 128;  // its rows of q's boxes
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = NEG_F;
    l[0] = l[1] = 0.f;

    mbar_wait(q_full(n % 2), (n / 2) & 1);
    mbar_wait(k_full(g % STAGES), (g / STAGES) & 1);
    my_turn();
    issue_qk<C::QK_STEPS>(s_acc, qa, ks(g % STAGES));
    your_turn();
    wgmma_wait<0>();
    fence_regs(s_acc);
    if (lane == 0) mbar_arrive(k_empty(g % STAGES));
    // the item before's o stores have read its q buffer (they had this
    // whole tile's time): the producer may load the item after next there
    if (t == 0 && n > 0) {
      tma_store_wait_read<0>();
      mbar_arrive(q_empty((n - 1) % 2));
    }
    tile_softmax(s_acc, m, l, alpha, row, col, it.first, lo, Sk, causal,
                 window, scale2);
    pack_p(p, s_acc);
    for (int i = 1; i < it.ntiles; ++i) {
      const int s = (g + i) % STAGES, phase = ((g + i) / STAGES) & 1;
      const int sp = (g + i - 1) % STAGES;
      const int phase_p = ((g + i - 1) / STAGES) & 1;
      mbar_wait(v_full(sp), phase_p);
      mbar_wait(k_full(s), phase);
      my_turn();
      issue_pv(o, p, vs(sp));
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(sp));
      issue_qk<C::QK_STEPS>(s_acc, qa, ks(s));
      your_turn();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(k_empty(s));
      tile_softmax(s_acc, m, l, alpha, row, col, it.first + i * wgf::BK, lo,
                   Sk, causal, window, scale2);
      rescale(o, alpha);
      pack_p(p, s_acc);
    }
    g += it.ntiles;
    {
      const int sp = (g - 1) % STAGES;
      mbar_wait(v_full(sp), ((g - 1) / STAGES) & 1);
      my_turn();
      issue_pv(o, p, vs(sp));
      your_turn();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(sp));
    }

    // epilogue: o / l cast to bf16 into this warpgroup's rows of the item's
    // q buffer (its q k^T are done; 128-byte swizzle: 16-byte chunk j % 8
    // of row r sits at chunk (j % 8) ^ (r % 8)), then one TMA store a
    // 64-column box, clipped at Sq and at Dv, that drains under the next
    // item
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 8 * h;
      const float lv = fmaxf(l[h], 1e-30f);   // as the TPU kernel's flush
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const uint32_t at = qa + (j / 8) * BOX_BYTES + r * 128 +
                            (((j % 8) ^ (r % 8)) * 16) + 4 * (lane % 4);
        const uint32_t bits =
            pack_bf16(o[4 * j + 2 * h] / lv, o[4 * j + 2 * h + 1] / lv);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(bits)
                     : "memory");
      }
    }
    fence_proxy_async();
    warpgroup_sync(1 + c);
    if (t == 0) {
      for (int j = 0; j < C::V_BOXES; ++j)
        tma_store_3d(&map_o, qa + j * BOX_BYTES, j * BOX_COLS, lo, it.bh);
      tma_store_commit();
    }
  }
  // warpgroup 1's last turn goes to warpgroup 0, which takes it here; the
  // last stores have read their buffers before the block exits
  if (c == 0) my_turn();
  if (t == 0) tma_store_wait_read<0>();
}

// a contiguous (heads, rows, cols) bf16 tensor as a 3-D map (cols, rows,
// heads), boxes of 64 columns x box_rows rows x 1 head in the 128-byte
// swizzle; loads zero-fill past every bound (columns past cols too), stores
// clip
bool encode_heads(CUtensorMap* map, const void* ptr, int cols, int heads,
                  int rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row_bytes = (cuuint64_t)cols * 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)wgf::BOX_COLS, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int bh, int group, int Sq, int Sk, int causal, int window,
                 float scale, cudaStream_t stream) {
  using C = wgf::Cfg<DQ, DV>;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_heads(&mq, q, DQ, bh, Sq, wgf::BQ) ||
      !encode_heads(&mk, k, DQ, bh / group, Sk, wgf::BK) ||
      !encode_heads(&mv, v, DV, bh / group, Sk, wgf::BK) ||
      !encode_heads(&mo, o, DV, bh, Sq, 64))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<DQ, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  // persistent: one block per SM at most, each walking items w, w + grid..
  const int64_t items = (int64_t)bh * ((Sq + wgf::BQ - 1) / wgf::BQ);
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = items < sms ? (int)items : sms;
  flash_attention_wgmma_kernel<DQ, DV>
      <<<grid, wgf::THREADS, C::SMEM_BYTES, stream>>>(
          mq, mk, mv, mo, bh, group, Sq, Sk, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

bool aligned16(const void* q, const void* k, const void* v, const void* o) {
  return (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
         == 0;
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int bh, int group,
             int Sq, int Sk, int Dq, int Dv, int causal, int window,
             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int d = Dq > Dv ? Dq : Dv;
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, bh, group, Sq, Sk, Dq, Dv, causal,
                         window, scale, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, bh, group, Sq, Sk, Dq, Dv, causal,
                          window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every entry point: q (bh, Sq, Dq), k (bh / group, Sk, Dq), v (bh / group,
// Sk, Dv), o (bh, Sq, Dv): contiguous, on the device of `stream`; bh <=
// 65535; with causal or window > 0, Sq == Sk (the wrapper checks).
// Returns cudaGetLastError() after the launch, or the error that kept it
// from launching (cudaErrorInvalidValue for inputs the kernel does not
// take).

// cuda_core, float32: Dq, Dv <= 128.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int bh, int group, int Sq, int Sk, int Dq,
                        int Dv, int causal, int window, float scale,
                        void* stream) {
  return dispatch<float>(q, k, v, o, bh, group, Sq, Sk, Dq, Dv, causal,
                         window, scale, stream);
}

// cuda_core, bfloat16: Dq, Dv <= 128.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int bh, int group, int Sq, int Sk, int Dq,
                         int Dv, int causal, int window, float scale,
                         void* stream) {
  using bf = __nv_bfloat16;
  return dispatch<bf>((const bf*)q, (const bf*)k, (const bf*)v, (bf*)o, bh,
                      group, Sq, Sk, Dq, Dv, causal, window, scale, stream);
}

// wgmma, bfloat16: Dq == Dv == 128, q, k, v, o 16-byte aligned.
int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v,
                               void* o, int bh, int group, int Sq, int Sk,
                               int Dq, int Dv, int causal, int window,
                               float scale, void* stream) {
  if (!aligned16(q, k, v, o) || Dq != 128 || Dv != 128)
    return (int)cudaErrorInvalidValue;
  return launch_wgmma<128, 128>(q, k, v, o, bh, group, Sq, Sk, causal,
                                window, scale, (cudaStream_t)stream);
}

// The wgmma kernel's dynamic shared memory, bytes.
int flash_attention_wgmma_smem_bytes(void) {
  return wgf::Cfg<128, 128>::SMEM_BYTES;
}

// wgmma_dv, bfloat16: (Dq, Dv) = (96, 64), q, k, v, o 16-byte aligned.
int flash_attention_bf16_wgmma_dv(const void* q, const void* k, const void* v,
                                  void* o, int bh, int group, int Sq, int Sk,
                                  int Dq, int Dv, int causal, int window,
                                  float scale, void* stream) {
  if (!aligned16(q, k, v, o) || Dq != 96 || Dv != 64)
    return (int)cudaErrorInvalidValue;
  return launch_wgmma<96, 64>(q, k, v, o, bh, group, Sq, Sk, causal, window,
                              scale, (cudaStream_t)stream);
}

// The wgmma_dv kernel's dynamic shared memory, bytes, and its ring's depth.
int flash_attention_wgmma_dv_smem_bytes(void) {
  return wgf::Cfg<96, 64>::SMEM_BYTES;
}
int flash_attention_wgmma_dv_stages(void) { return wgf::Cfg<96, 64>::STAGES; }

// wgmma_120, bfloat16: (Dq, Dv) = (120, 120), q, k, v, o 16-byte aligned
// (h2o-danube3-4b's heads).
int flash_attention_bf16_wgmma_120(const void* q, const void* k,
                                   const void* v, void* o, int bh, int group,
                                   int Sq, int Sk, int Dq, int Dv, int causal,
                                   int window, float scale, void* stream) {
  if (!aligned16(q, k, v, o) || Dq != 120 || Dv != 120)
    return (int)cudaErrorInvalidValue;
  return launch_wgmma<120, 120>(q, k, v, o, bh, group, Sq, Sk, causal,
                                window, scale, (cudaStream_t)stream);
}

// wgmma_96, bfloat16: (Dq, Dv) = (96, 96), q, k, v, o 16-byte aligned
// (phi3-vision-4b's heads).
int flash_attention_bf16_wgmma_96(const void* q, const void* k, const void* v,
                                  void* o, int bh, int group, int Sq, int Sk,
                                  int Dq, int Dv, int causal, int window,
                                  float scale, void* stream) {
  if (!aligned16(q, k, v, o) || Dq != 96 || Dv != 96)
    return (int)cudaErrorInvalidValue;
  return launch_wgmma<96, 96>(q, k, v, o, bh, group, Sq, Sk, causal, window,
                              scale, (cudaStream_t)stream);
}

// The wgmma_120 and wgmma_96 kernels' dynamic shared memory, bytes, and
// their rings' depth.
int flash_attention_wgmma_120_smem_bytes(void) {
  return wgf::Cfg<120, 120>::SMEM_BYTES;
}
int flash_attention_wgmma_120_stages(void) {
  return wgf::Cfg<120, 120>::STAGES;
}
int flash_attention_wgmma_96_smem_bytes(void) {
  return wgf::Cfg<96, 96>::SMEM_BYTES;
}
int flash_attention_wgmma_96_stages(void) { return wgf::Cfg<96, 96>::STAGES; }

// mma_sync, bfloat16: Dq == Dv == 128, q, k, v, o 16-byte aligned.
int flash_attention_bf16_mma_sync(const void* q, const void* k,
                                  const void* v, void* o, int bh, int group,
                                  int Sq, int Sk, int Dq, int Dv, int causal,
                                  int window, float scale, void* stream) {
  using bf = __nv_bfloat16;
  if (!aligned16(q, k, v, o) || Dq != 128 || Dv != 128)
    return (int)cudaErrorInvalidValue;
  return launch_mma<128>((const bf*)q, (const bf*)k, (const bf*)v, (bf*)o, bh,
                         group, Sq, Sk, causal, window, scale,
                         (cudaStream_t)stream);
}

}  // extern "C"
