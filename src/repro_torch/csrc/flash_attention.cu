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
// heads over 8 KV heads, S = 2048, D = 128, bfloat16.
//
// What bounds it on this card: the two products, 2 Sq Sk D multiply-adds
// (about half of that under a causal mask) against one read of q, k, v and
// one write of o, so it is bound by arithmetic at these shapes.
//
// What the design does about it: two kernels, chosen from the inputs.
// bfloat16 with Dq == Dv == 128 (the LM path) runs on the tensor
// cores with mma.sync (see flash_attention_mma_kernel below); everything
// else (float32, other head dims, Dv != Dq) runs on the CUDA cores.  Both:
// one thread block per (head, 64-row query tile), heavy (late) causal
// tiles launched first.  The block walks only
// the 64-key tiles from the first one inside the window up to the diagonal
// -- tiles wholly outside the mask are skipped, not computed and masked.
// Skipping changes nothing: a row's first visited keys that are masked add
// exp(NEG - NEG) = 1 terms, which the first valid key multiplies by
// exp(NEG - m) = 0, exactly as in the TPU kernel.  Each of the 256 threads
// owns a 4 x 4 block of the score tile and a 4-row strip of the output
// tile; q and k tiles sit transposed in shared memory so each d step is
// two 16-byte loads for 16 FMAs (float32 arithmetic), and the probability
// tile reuses the k tile's shared memory, so two blocks fit on an SM at
// D = 128.  Row max and sum are reduced with warp shuffles and the softmax
// runs in base 2.  Ragged Sq and Sk are bounds-checked; there is no
// padding.  wgmma, TMA and software pipelining are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_F (-1e18f)

namespace {

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
// bf16 with Dq == Dv == 128 (the LM path): tensor cores via mma.sync
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

// q (bh, Sq, Dq), k (bh / group, Sk, Dq), v (bh / group, Sk, Dv),
// o (bh, Sq, Dv): contiguous, on the device of `stream`.  Dq, Dv <= 128,
// bh <= 65535; with causal or window > 0, Sq == Sk (the wrapper checks).
// Returns cudaGetLastError() after the launch.
int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, int bh, int group, int Sq, int Sk, int Dq,
                        int Dv, int causal, int window, float scale,
                        void* stream) {
  return dispatch<float>(q, k, v, o, bh, group, Sq, Sk, Dq, Dv, causal,
                         window, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int bh, int group, int Sq, int Sk, int Dq,
                         int Dv, int causal, int window, float scale,
                         void* stream) {
  using bf = __nv_bfloat16;
  const bf *qp = (const bf*)q, *kp = (const bf*)k, *vp = (const bf*)v;
  cudaStream_t s = (cudaStream_t)stream;
  // the tensor-core kernel reads k and v rows as 16-byte vectors
  const bool aligned =
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15) == 0;
  if (aligned && Dq == Dv && Dq == 128)
    return launch_mma<128>(qp, kp, vp, (bf*)o, bh, group, Sq, Sk, causal,
                           window, scale, s);
  return dispatch<bf>(qp, kp, vp, (bf*)o, bh, group, Sq, Sk, Dq, Dv, causal,
                      window, scale, stream);
}

}  // extern "C"
