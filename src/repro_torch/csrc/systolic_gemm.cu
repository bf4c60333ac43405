// Dense matrix product with an optional fused ReLU for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// repro_torch/kernels/systolic_gemm.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/systolic_gemm.py:29
// (systolic_gemm_kernel, via systolic_gemm_pallas and ops.gemm):
//
//     C = act(A @ B)      A (M, K), B (K, N), C (M, N), row-major
//     act = identity (activation 0) or ReLU (activation 1, the Gamma
//     gemm instruction's activation), applied after the last k step
//
// A and B are both float32 or both bfloat16; the sum is float32; C is
// float32 or bfloat16.  On the olmo-1b path: M = 8 (decode) or 8192
// (prefill), K = 2048, N in {2048, 4096, 24576, 50304}.
//
// What bounds it on this card: 2 M K N flops against one read of A and B
// and one write of C.  With bf16 inputs the prefill products are bound by
// the tensor cores (989 TFLOP/s), the decode products (M = 8) by reading B
// (3.35 TB/s).  float32 inputs run on the CUDA cores (67 TFLOP/s; TF32 is
// never used, the reference holds float32 to 1e-4).
//
// What the design does about it: every thread block owns one 128 x 128
// output tile and walks k itself -- the TPU grid's carried k axis with its
// VMEM accumulator does not carry over, GPU blocks run in no order.  Blocks
// are rastered M-tile first, so the blocks in flight share one K x 128
// panel of B and all of A stays in the 50 MB L2: B is read from device
// memory once.  The next k tile is fetched into registers while the
// current one is multiplied out of shared memory (one buffer, two
// barriers per tile).
//   * bf16: 8 warps as 2 x 4, each warp a 64 x 32 sub-tile of mma.sync
//     m16n8k16 products (float32 accumulators, 64 per thread); A fragments
//     are 32-bit shared-memory loads, B fragments come transposed through
//     ldmatrix.trans; k tiles of 32, rows padded by 16 bytes so neither
//     read conflicts on banks.
//   * float32: 16 x 16 threads, each an 8 x 8 register tile (two 4-row by
//     two 4-column strips, read as 16-byte shared-memory loads), FFMA in
//     k order; k tiles of 8, A stored transposed.
// Global loads are 16-byte vectors when K and N allow it and the pointers
// are aligned; otherwise element by element.  Ragged M, N and K are
// bounds-checked (zeros past K, no stores past M or N): no padded copies.
// ReLU and the cast happen in the epilogue.  wgmma, TMA, cp.async
// pipelining and split-K for small M are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_out2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_out2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// (row, col) and (row, col + 1) of C; the pair store needs N even (then
// col, which is even, keeps it aligned)
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* C, int M, int N, int row,
                                           int col, float x, float y,
                                           int relu) {
  if (row >= M) return;
  if (relu) {
    x = fmaxf(x, 0.f);
    y = fmaxf(y, 0.f);
  }
  OutT* p = C + (int64_t)row * N + col;
  if (col + 1 < N && (N & 1) == 0) {
    store_out2(p, x, y);
  } else {
    if (col < N) store_out(p, x);
    if (col + 1 < N) store_out(p + 1, y);
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores via mma.sync
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128;   // output tile of a block
constexpr int BKH = 32;             // k depth of one bf16 tile
constexpr int THREADS = 256;        // 8 warps
constexpr int WN_WARPS = 4;         // warps along n (2 along m)
constexpr int WM = 64, WN = 32;     // a warp's sub-tile
constexpr int MT = WM / 16, NT = WN / 8;
constexpr int LDA = BKH + 8;        // padded A row (bf16)
constexpr int LDB = BN + 8;         // padded B row (bf16)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k tile in flight in registers: 2 x 16 bytes of A and of B per
// thread (VEC), or 16 elements of each (element by element).
template <bool VEC> struct RegsH;
template <> struct RegsH<true> { uint4 a[2], b[2]; };
template <> struct RegsH<false> { bf16 a[16], b[16]; };

__device__ __forceinline__ void fetch_h(RegsH<true>& r, const bf16* A,
                                        const bf16* B, int M, int K, int N,
                                        int m0, int n0, int k0) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + THREADS * i;
    // A: 128 rows x 4 chunks of 8
    const int ar = c / (BKH / 8), ak = 8 * (c % (BKH / 8));
    const bool aok = m0 + ar < M && k0 + ak < K;
    r.a[i] = aok ? *reinterpret_cast<const uint4*>(
                       A + (int64_t)(m0 + ar) * K + k0 + ak) : zero;
    // B: 32 rows x 16 chunks of 8
    const int br = c / (BN / 8), bn = 8 * (c % (BN / 8));
    const bool bok = k0 + br < K && n0 + bn < N;
    r.b[i] = bok ? *reinterpret_cast<const uint4*>(
                       B + (int64_t)(k0 + br) * N + n0 + bn) : zero;
  }
}

__device__ __forceinline__ void store_h(const RegsH<true>& r, bf16* As,
                                        bf16* Bs) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + THREADS * i;
    const int ar = c / (BKH / 8), ak = 8 * (c % (BKH / 8));
    *reinterpret_cast<uint4*>(As + ar * LDA + ak) = r.a[i];
    const int br = c / (BN / 8), bn = 8 * (c % (BN / 8));
    *reinterpret_cast<uint4*>(Bs + br * LDB + bn) = r.b[i];
  }
}

__device__ __forceinline__ void fetch_h(RegsH<false>& r, const bf16* A,
                                        const bf16* B, int M, int K, int N,
                                        int m0, int n0, int k0) {
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int ar = e / BKH, ak = e % BKH;
    r.a[i] = (m0 + ar < M && k0 + ak < K)
                 ? A[(int64_t)(m0 + ar) * K + k0 + ak] : zero;
    const int br = e / BN, bn = e % BN;
    r.b[i] = (k0 + br < K && n0 + bn < N)
                 ? B[(int64_t)(k0 + br) * N + n0 + bn] : zero;
  }
}

__device__ __forceinline__ void store_h(const RegsH<false>& r, bf16* As,
                                        bf16* Bs) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int e = threadIdx.x + THREADS * i;
    As[(e / BKH) * LDA + e % BKH] = r.a[i];
    Bs[(e / BN) * LDB + e % BN] = r.b[i];
  }
}

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 OutT* __restrict__ C, int M, int K, int N, int relu) {
  __shared__ __align__(16) bf16 As[BM * LDA];
  __shared__ __align__(16) bf16 Bs[BKH * LDB];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;          // fragment row / column
  const int wm0 = WM * (warp / WN_WARPS), wn0 = WN * (warp % WN_WARPS);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  RegsH<VEC> regs;
  fetch_h(regs, A, B, M, K, N, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += BKH) {
    __syncthreads();                    // the last tile's readers are done
    store_h(regs, As, Bs);
    __syncthreads();
    if (k0 + BKH < K) fetch_h(regs, A, B, M, K, N, m0, n0, k0 + BKH);
#pragma unroll
    for (int ks = 0; ks < BKH / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* p = As + (wm0 + 16 * mt + g) * LDA + 16 * ks + 2 * tg;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDA + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        // lanes 0-15 address k rows 16ks + lane at columns 8nt..; lanes
        // 16-31 the same rows at columns 8(nt + 1)..
        const bf16* p = Bs + (16 * ks + (lane % 16)) * LDB + wn0 + 8 * nt
                        + 8 * (lane / 16);
        const uint32_t addr = (uint32_t)__cvta_generic_to_shared(
            reinterpret_cast<const void*>(p));
        uint32_t b[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
            : "r"(addr));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][nt + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = m0 + wm0 + 16 * mt + g;
      const int col = n0 + wn0 + 8 * nt + 2 * tg;
      store_pair(C, M, N, row, col, acc[mt][nt][0], acc[mt][nt][1], relu);
      store_pair(C, M, N, row + 8, col, acc[mt][nt][2], acc[mt][nt][3],
                 relu);
    }
}

// ---------------------------------------------------------------------------
// float32 inputs: CUDA-core FFMA
// ---------------------------------------------------------------------------

constexpr int BKF = 8;              // k depth of one float32 tile
constexpr int LDF = BM + 4;         // padded row of the k-major tiles

template <bool VEC> struct RegsF;
template <> struct RegsF<true> { float4 a, b; };
template <> struct RegsF<false> { float a[4], b[4]; };

__device__ __forceinline__ void fetch_f(RegsF<true>& r, const float* A,
                                        const float* B, int M, int K, int N,
                                        int m0, int n0, int k0) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int t = threadIdx.x;
  // A: 128 rows x 2 chunks of 4;  B: 8 rows x 32 chunks of 4
  const int ar = t / 2, ak = 4 * (t % 2);
  r.a = (m0 + ar < M && k0 + ak < K)
            ? *reinterpret_cast<const float4*>(
                  A + (int64_t)(m0 + ar) * K + k0 + ak) : zero;
  const int br = t / 32, bn = 4 * (t % 32);
  r.b = (k0 + br < K && n0 + bn < N)
            ? *reinterpret_cast<const float4*>(
                  B + (int64_t)(k0 + br) * N + n0 + bn) : zero;
}

__device__ __forceinline__ void store_f(const RegsF<true>& r, float* As,
                                        float* Bs) {
  const int t = threadIdx.x;
  const int ar = t / 2, ak = 4 * (t % 2);
  As[(ak + 0) * LDF + ar] = r.a.x;     // A transposed: As[k][m]
  As[(ak + 1) * LDF + ar] = r.a.y;
  As[(ak + 2) * LDF + ar] = r.a.z;
  As[(ak + 3) * LDF + ar] = r.a.w;
  const int br = t / 32, bn = 4 * (t % 32);
  *reinterpret_cast<float4*>(Bs + br * LDF + bn) = r.b;
}

__device__ __forceinline__ void fetch_f(RegsF<false>& r, const float* A,
                                        const float* B, int M, int K, int N,
                                        int m0, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int ar = e / BKF, ak = e % BKF;
    r.a[i] = (m0 + ar < M && k0 + ak < K)
                 ? A[(int64_t)(m0 + ar) * K + k0 + ak] : 0.f;
    const int br = e / BN, bn = e % BN;
    r.b[i] = (k0 + br < K && n0 + bn < N)
                 ? B[(int64_t)(k0 + br) * N + n0 + bn] : 0.f;
  }
}

__device__ __forceinline__ void store_f(const RegsF<false>& r, float* As,
                                        float* Bs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + THREADS * i;
    As[(e % BKF) * LDF + e / BKF] = r.a[i];
    Bs[(e / BN) * LDF + e % BN] = r.b[i];
  }
}

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                OutT* __restrict__ C, int M, int K, int N, int relu) {
  __shared__ __align__(16) float As[BKF * LDF];   // As[k][m]
  __shared__ __align__(16) float Bs[BKF * LDF];   // Bs[k][n]

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // this thread's rows: 4ty.. and 64 + 4ty..; columns 4tx.. and 64 + 4tx..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  RegsF<VEC> regs;
  fetch_f(regs, A, B, M, K, N, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += BKF) {
    __syncthreads();
    store_f(regs, As, Bs);
    __syncthreads();
    if (k0 + BKF < K) fetch_f(regs, A, B, M, K, N, m0, n0, k0 + BKF);
#pragma unroll
    for (int k = 0; k < BKF; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDF + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * LDF + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LDF + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * LDF + 64 + 4 * tx);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      store_pair(C, M, N, row, col, acc[i][j], acc[i][j + 1], relu);
    }
  }
}

template <typename InT>
bool aligned16(const InT* A, const InT* B, int K, int N) {
  const int per = 16 / (int)sizeof(InT);
  return ((((uintptr_t)A) | ((uintptr_t)B)) & 15) == 0 && K % per == 0 &&
         N % per == 0;
}

template <typename OutT>
int launch_bf16(const bf16* A, const bf16* B, OutT* C, int M, int K, int N,
                int relu, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (aligned16(A, B, K, N))
    gemm_bf16_kernel<true, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, K, N,
                                                          relu);
  else
    gemm_bf16_kernel<false, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, K, N,
                                                           relu);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_f32(const float* A, const float* B, OutT* C, int M, int K, int N,
               int relu, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (aligned16(A, B, K, N))
    gemm_f32_kernel<true, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, K, N,
                                                         relu);
  else
    gemm_f32_kernel<false, OutT><<<grid, THREADS, 0, s>>>(A, B, C, M, K, N,
                                                          relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A (M, K), B (K, N), C (M, N): contiguous, on the device of `stream`;
// K >= 1, ceil(N / 128) <= 65535 (the wrapper checks).  C is float32
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1).  Returns cudaGetLastError()
// after the launch.
int systolic_gemm_bf16(const void* A, const void* B, void* C, int M, int K,
                       int N, int activation, int out_bf16, void* stream) {
  const bf16 *a = (const bf16*)A, *b = (const bf16*)B;
  cudaStream_t s = (cudaStream_t)stream;
  const int relu = activation == 1;
  return out_bf16 ? launch_bf16(a, b, (bf16*)C, M, K, N, relu, s)
                  : launch_bf16(a, b, (float*)C, M, K, N, relu, s);
}

int systolic_gemm_f32(const float* A, const float* B, void* C, int M, int K,
                      int N, int activation, int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int relu = activation == 1;
  return out_bf16 ? launch_f32(A, B, (bf16*)C, M, K, N, relu, s)
                  : launch_f32(A, B, (float*)C, M, K, N, relu, s);
}

}  // extern "C"
