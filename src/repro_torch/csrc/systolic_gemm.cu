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
// What the design does about it -- four kernels, chosen on the host by
// shape and alignment alone (repro_torch/kernels/systolic_gemm.py, plan):
//
//   * wgmma (bf16, M > 64, K and N multiples of 8, 16-byte aligned
//     pointers): the prefill products, bound by the tensor cores.  A
//     persistent grid of one 384-thread block per SM walks 128 x 256 output
//     tiles in a grouped order (16 m-tiles at a time), so the blocks in
//     flight share panels of A and B in the L2.  Warp-specialised: one
//     producer warpgroup (its registers lowered by setmaxnreg) keeps TMA
//     loads in flight into a ring of 4 stages of 64-deep k tiles (16 KB of
//     A, 32 KB of B, both with the 128-byte swizzle; B arrives as four
//     64-column boxes, the widest a swizzled box may be), each stage with a
//     full and an empty mbarrier.  Two consumer warpgroups each run
//     wgmma.mma_async m64n256k16 on 64 rows of the tile, with float32
//     accumulators in registers (128 a thread).  B is row-major (K, N), so
//     its tile is N-major in shared memory and wgmma reads it through the
//     transpose bit -- no transposed copy.  One wgmma group stays in flight
//     while the previous stage is handed back to the producer, and the
//     producer runs ahead into the next tile while the consumers store
//     this one's epilogue: ReLU and the cast in registers, 128-byte-wide
//     chunks of rows staged in two 8 KB shared-memory buffers per
//     warpgroup and written by TMA stores, so the consumers return to the
//     tensor cores while the stores drain (on an H100 the prefill mlp
//     product went from 1.20 to 1.12 ms when its epilogue stopped storing
//     from registers).  TMA zero-fills loads past M, N and K, and clips
//     stores at M and N.
//   * splitk (bf16, M <= 64, same alignment): the decode products, bound
//     by reading B once.  ceil(N / 64) panels of 64 columns (128 bytes of
//     each row of B), and K split so that the grid has at least 2 blocks
//     per SM; each 128-thread block streams its share of B through a
//     6-stage cp.async ring whose slots are all filled up front (a share of
//     up to 6 k tiles costs one round trip to device memory), and runs
//     mma.sync m16n8k16 with the operands swapped: 16 columns of B per warp
//     as the m side, read transposed through ldmatrix.trans, the activation
//     rows as n = 8, 16, 32 or 64, so no tensor-core work is spent padding
//     M to 64 or 128 (the tensor cores are ~0.3% busy at M = 8: any route
//     to them will do, and mma.sync needs no shared-memory descriptors).
//     With more than one split, the partial sums go to a float32 workspace;
//     one thread per block counts the block in on an integer counter per
//     panel (acquire-release), and the last block to arrive adds the
//     partials in split order, applies ReLU and the cast, and resets the
//     counter: the result is deterministic, and no float atomics are used.
//   * mma_sync (bf16 otherwise: K or N not a multiple of 8, misaligned
//     views): every thread block owns one 128 x 128 output tile and walks k
//     itself, blocks rastered M-tile first; the next k tile is fetched into
//     registers while the current one is multiplied out of shared memory
//     (one buffer, two barriers per tile); 8 warps as 2 x 4, each warp a
//     64 x 32 sub-tile of mma.sync m16n8k16 products (float32 accumulators,
//     64 per thread); A fragments are 32-bit shared-memory loads, B
//     fragments come transposed through ldmatrix.trans; k tiles of 32, rows
//     padded by 16 bytes so neither read conflicts on banks.
//   * f32 (float32 inputs): the same 128 x 128 tiles on the CUDA cores, 16
//     x 16 threads, each an 8 x 8 register tile (two 4-row by two 4-column
//     strips, read as 16-byte shared-memory loads), FFMA in k order; k
//     tiles of 8, A stored transposed.
//
// In mma_sync and f32, global loads are 16-byte vectors when K and N allow
// it and the pointers are aligned, otherwise element by element; ragged M,
// N and K are bounds-checked (zeros past K, no stores past M or N): no
// padded copies anywhere.  ReLU and the cast happen in every epilogue.
// The TMA descriptors are encoded on the host through
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (no -lcuda),
// and passed as __grid_constant__ kernel parameters.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// ---------------------------------------------------------------------------
// the wgmma kernel's epilogue store (the Hopper primitives are in hopper.cuh)
// ---------------------------------------------------------------------------

// (x, y) cast to the output type, 8 or 4 bytes into shared memory
__device__ __forceinline__ void st_shared_out(uint32_t addr, float x, float y,
                                              float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y) : "memory");
}
__device__ __forceinline__ void st_shared_out(uint32_t addr, float x, float y,
                                              bf16*) {
  uint32_t bits;   // y in the high half, x in the low
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(bits) : "f"(y), "f"(x));
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(bits)
               : "memory");
}

// ---------------------------------------------------------------------------
// bf16, M > 64: TMA + wgmma, warp-specialised, persistent
// ---------------------------------------------------------------------------

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64;   // output tile, k tile
constexpr int STAGES = 4;
constexpr int THREADS = 384;                  // producer + 2 consumers
constexpr int BOX_N = 64;                     // widest 128-byte-swizzled box
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BOX_BYTES = BK * BOX_N * 2;   // 8 KB
constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;   // 48 KB
// epilogue: each consumer warpgroup stages its 64 rows of C through two
// 8 KB buffers, 128 bytes of each row at a time, for TMA stores
constexpr int EPI_BYTES = 64 * 128;
constexpr int SMEM_BYTES =
    STAGES * STAGE_BYTES + 4 * EPI_BYTES + 2 * STAGES * 8 + 1024;
constexpr int GROUP_M = 16;                   // m-tiles per raster group
}  // namespace wg

// tile index -> (m-tile, n-tile): groups of GROUP_M m-tiles, n-major
// inside a group, so the tiles in flight share A and B panels in the L2
__device__ __forceinline__ void tile_coords(int tile, int tiles_m,
                                            int tiles_n, int& tm, int& tn) {
  const int group = wg::GROUP_M * tiles_n;
  const int first_m = (tile / group) * wg::GROUP_M;
  const int gm = min(tiles_m - first_m, wg::GROUP_M);
  const int r = tile % group;
  tm = first_m + r % gm;
  tn = r / gm;
}

template <typename OutT>
__global__ void __launch_bounds__(wg::THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c, int M, int K,
                  int N, int relu) {
  constexpr int BM = wg::BM, BN = wg::BN, BK = wg::BK, STAGES = wg::STAGES;
  constexpr int BOX_N = wg::BOX_N, A_BYTES = wg::A_BYTES;
  constexpr int B_BOX_BYTES = wg::B_BOX_BYTES, STAGE_BYTES = wg::STAGE_BYTES;
  extern __shared__ uint8_t smem_wg[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to that
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t epi = ring + STAGES * STAGE_BYTES;   // 4 x EPI_BYTES
  const uint32_t bars = epi + 4 * wg::EPI_BYTES;      // full[s], empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n, ktiles = (K + BK - 1) / BK;
  const int group = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);       // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (group == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (t != 0) return;
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty(s), phase ^ 1);
        mbar_expect_tx(full(s), STAGE_BYTES);
        const uint32_t a_dst = ring + s * STAGE_BYTES;
        tma_load_2d(a_dst, &map_a, kt * BK, tm * BM, full(s));
#pragma unroll
        for (int j = 0; j < BN / BOX_N; ++j)
          tma_load_2d(a_dst + A_BYTES + j * B_BOX_BYTES, &map_b,
                      tn * BN + j * BOX_N, kt * BK, full(s));
        if (++s == STAGES) { s = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup c holds rows 64c .. 64c + 63 of the tile
  setmaxnreg_inc<232>();
  const int c = group - 1;
  const int warp = t / 32, lane = t % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int s = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, tn;
    tile_coords(tile, tiles_m, tiles_n, tm, tn);
    int prev = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full(s), phase);
      const uint32_t a_src = ring + s * STAGE_BYTES + c * (64 * BK * 2);
      const uint32_t b_src = ring + s * STAGE_BYTES + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, 8-row groups 1024 B apart, k16 steps 32 B along a
        // swizzled row; B: N-major, 8 k-rows per 1024 B, 64-column boxes
        // 8 KB apart, k16 steps two 8-row groups
        const uint64_t da = sw128_desc(a_src + kk * 32, 16, 1024);
        const uint64_t db = sw128_desc(b_src + kk * 2048, B_BOX_BYTES, 1024);
        wgmma_ss<1>(acc, da, db, (kt | kk) != 0);
      }
      wgmma_commit();
      // the group before this one is done: hand its stage back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == STAGES) { s = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(prev));

    // epilogue: thread t holds rows r and r + 8 of each 8-column group.
    // Chunks of 128 bytes a row (COLS columns) go through the warpgroup's
    // two staging buffers in the 128-byte swizzle, and one thread hands
    // each to a TMA store: the consumers return to the next tile's wgmma
    // while the stores drain, and the store clips at M and N.
    constexpr int COLS = 128 / (int)sizeof(OutT);
    const int r = 16 * warp + lane / 4;           // and r + 8
#pragma unroll
    for (int q = 0; q < BN / COLS; ++q) {
      const uint32_t buf = epi + (2 * c + q % 2) * wg::EPI_BYTES;
      // the store that last read this buffer, two chunks ago, is done
      if (t == 0) tma_store_wait_read<1>();
      warpgroup_sync(1 + c);
#pragma unroll
      for (int jj = 0; jj < COLS / 8; ++jj) {
        const int j = q * (COLS / 8) + jj;   // constant once unrolled
        const int byte = (8 * jj + 2 * (lane % 4)) * sizeof(OutT);
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                      acc[4 * j + 3]};
        if (relu)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          const uint32_t at = buf + row * 128 +
                              (((byte / 16) ^ (row % 8)) * 16) + byte % 16;
          st_shared_out(at, v[2 * h], v[2 * h + 1], (OutT*)nullptr);
        }
      }
      // the generic-proxy writes are visible to the TMA unit, then store
      fence_proxy_async();
      warpgroup_sync(1 + c);
      if (t == 0) {
        tma_store_2d(&map_c, buf, tn * BN + q * COLS, tm * BM + 64 * c);
        tma_store_commit();
      }
    }
  }
  // the last stores have read their buffers before the block exits
  if (t == 0) tma_store_wait_read<0>();
}

// ---------------------------------------------------------------------------
// bf16, M <= 64: split-K, mma.sync with swapped operands
// ---------------------------------------------------------------------------

namespace sk {
constexpr int BN = 64, BK = 64;      // a block's panel width, k tile
constexpr int STAGES = 6;
constexpr int THREADS = 128;         // 4 warps, 16 columns each
constexpr int LDB = BN + 8;          // padded rows: ldmatrix without
constexpr int LDA = BK + 8;          // bank conflicts
template <int NT>
constexpr int smem_bytes() {
  return STAGES * (BK * LDB + NT * 8 * LDA) * 2;
}
}  // namespace sk

// NT groups of 8 activation rows (M <= 8 NT).  Block (panel, split) owns
// columns 64 panel .. + 63 and k tiles [split T / splits, (split + 1) T /
// splits) of the T = ceil(K / 64).
template <int NT, typename OutT>
__global__ void __launch_bounds__(sk::THREADS)
gemm_splitk_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   OutT* __restrict__ C, float* __restrict__ ws,
                   int* __restrict__ counters, int M, int K, int N,
                   int splits, int relu) {
  constexpr int BN = sk::BN, BK = sk::BK, STAGES = sk::STAGES;
  constexpr int THREADS = sk::THREADS, LDB = sk::LDB, LDA = sk::LDA;
  extern __shared__ __align__(16) uint8_t smem_sk[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_sk);    // [STAGES][BK][LDB]
  bf16* As = Bs + STAGES * BK * LDB;               // [STAGES][8 NT][LDA]
  __shared__ int last;

  const int panel = blockIdx.x, split = blockIdx.y;
  const int n0 = panel * BN;
  const int T = (K + BK - 1) / BK;
  const int t0 = (int)((int64_t)split * T / splits);
  const int nt = (int)((int64_t)(split + 1) * T / splits) - t0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;

  auto load = [&](int slot, int kt) {
    const int k0 = kt * BK;
    bf16* bs = Bs + slot * BK * LDB;
    bf16* as = As + slot * NT * 8 * LDA;
    // B: 64 k rows x 8 chunks of 8 columns (N % 8 == 0: a chunk is all in
    // or all out)
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int ch = threadIdx.x + THREADS * i;
      const int r = ch / (BN / 8), cn = 8 * (ch % (BN / 8));
      const bool ok = k0 + r < K && n0 + cn < N;
      cp_async16(bs + r * LDB + cn,
                 ok ? B + (int64_t)(k0 + r) * N + n0 + cn : B, ok ? 16 : 0);
    }
    // A: 8 NT rows x 8 chunks of 8 k
    for (int ch = threadIdx.x; ch < NT * 8 * (BK / 8); ch += THREADS) {
      const int r = ch / (BK / 8), ck = 8 * (ch % (BK / 8));
      const bool ok = r < M && k0 + ck < K;
      cp_async16(as + r * LDA + ck, ok ? A + (int64_t)r * K + k0 + ck : A,
                 ok ? 16 : 0);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // every slot is filled up front, so a share of at most STAGES tiles
  // costs one round trip to device memory
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    if (st < nt) load(st, t0 + st);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 1>();
    __syncthreads();                    // tile i has landed
    const bf16* bs = Bs + (i % STAGES) * BK * LDB;
    const bf16* as = As + (i % STAGES) * NT * 8 * LDA;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // the m side: 16 columns of B, read transposed out of the [k][n]
      // tile; lanes 8q .. 8q + 7 address matrix q = (k half, n half)
      const int q = lane / 8;
      const bf16* p = bs + (16 * ks + 8 * (q / 2) + lane % 8) * LDB +
                      16 * warp + 8 * (q % 2);
      uint32_t a[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
          "{%0,%1,%2,%3}, [%4];\n"
          : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
          : "r"(smem_u32(p)));
      // the n side: activation rows 8j + g, k pairs 2tg and 2tg + 8
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* pa = as + (8 * j + g) * LDA + 16 * ks + 2 * tg;
        mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(pa),
                 *reinterpret_cast<const uint32_t*>(pa + 8));
      }
    }
    __syncthreads();                    // slot i % STAGES is free again
    if (i + STAGES < nt) load(i % STAGES, t0 + i + STAGES);
    cp_async_commit();
  }

  // acc[j][e]: column n0 + 16 warp + g + 8 (e / 2), activation row
  // 8 j + 2 tg + e % 2
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 16 * warp + g + 8 * (e / 2);
        const int row = 8 * j + 2 * tg + e % 2;
        if (row < M && col < N) {
          const float x = acc[j][e];
          store_out(C + (int64_t)row * N + col, relu ? fmaxf(x, 0.f) : x);
        }
      }
    return;
  }
  float* part = ws + (int64_t)split * M * N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + 16 * warp + g + 8 * (e / 2);
      const int row = 8 * j + 2 * tg + e % 2;
      if (row < M && col < N) part[(int64_t)row * N + col] = acc[j][e];
    }
  // one thread counts the block in: the barrier orders the block's
  // partials before its release, its acquire orders the other blocks'
  // partials before the last block's reads
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old) : "l"(counters + panel) : "memory");
    last = old == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block of the panel: thread t sums column n0 + t % 64 of rows
  // t / 64, t / 64 + 2, ... over the splits, in split order
  constexpr int PER = 8 * NT * BN / THREADS;
  const int col = n0 + threadIdx.x % BN, row0 = threadIdx.x / BN;
  if (col < N) {
    float x[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) x[i] = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int row = row0 + (THREADS / BN) * i;
        if (row < M) x[i] += __ldcg(ws + ((int64_t)sp * M + row) * N + col);
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int row = row0 + (THREADS / BN) * i;
      if (row < M)
        store_out(C + (int64_t)row * N + col, relu ? fmaxf(x[i], 0.f) : x[i]);
    }
  }
  if (threadIdx.x == 0) counters[panel] = 0;   // ready for the next call
}

// ---------------------------------------------------------------------------
// host side of the new kernels
// ---------------------------------------------------------------------------

template <typename T> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<bf16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <> constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// a row-major (rows, cols) matrix, boxes of box_rows rows x 128 bytes in
// the 128-byte swizzle; loads zero-fill out of bounds, stores clip
template <typename T>
bool encode_map(CUtensorMap* map, const T* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)),
                             (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, map_type<T>(), 2, const_cast<T*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch_wgmma(const bf16* A, const bf16* B, OutT* C, int M, int K, int N,
                 int relu, int grid, cudaStream_t s) {
  CUtensorMap map_a, map_b, map_c;
  if (!encode_map(&map_a, A, M, K, wg::BM) ||
      !encode_map(&map_b, B, K, N, wg::BK) ||
      !encode_map(&map_c, C, M, N, 64))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  gemm_wgmma_kernel<OutT><<<grid, wg::THREADS, wg::SMEM_BYTES, s>>>(
      map_a, map_b, map_c, M, K, N, relu);
  return (int)cudaGetLastError();
}

template <int NT, typename OutT>
int launch_splitk_nt(const bf16* A, const bf16* B, OutT* C, float* ws,
                     int* counters, int M, int K, int N, int relu, int splits,
                     cudaStream_t s) {
  constexpr int bytes = sk::smem_bytes<NT>();
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_splitk_kernel<NT, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + sk::BN - 1) / sk::BN, splits);
  gemm_splitk_kernel<NT, OutT><<<grid, sk::THREADS, bytes, s>>>(
      A, B, C, ws, counters, M, K, N, splits, relu);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_splitk(const bf16* A, const bf16* B, OutT* C, float* ws,
                  int* counters, int M, int K, int N, int relu, int splits,
                  cudaStream_t s) {
  if (M <= 8)
    return launch_splitk_nt<1>(A, B, C, ws, counters, M, K, N, relu, splits, s);
  if (M <= 16)
    return launch_splitk_nt<2>(A, B, C, ws, counters, M, K, N, relu, splits, s);
  if (M <= 32)
    return launch_splitk_nt<4>(A, B, C, ws, counters, M, K, N, relu, splits, s);
  return launch_splitk_nt<8>(A, B, C, ws, counters, M, K, N, relu, splits, s);
}

}  // namespace

extern "C" {

// Every entry point: A (M, K), B (K, N), C (M, N) contiguous, on the
// device of `stream`; K >= 1 (the wrapper checks).  C is float32
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1).  Returns cudaGetLastError()
// after the launch, or the error that kept it from launching.

// The tile sizes the host-side plan must agree with: the wgmma kernel's
// (BM, BN, BK), the split-K kernel's (BN, BK), the 128 x 128 kernels'.
void systolic_gemm_tiles(int* out) {
  out[0] = wg::BM;
  out[1] = wg::BN;
  out[2] = wg::BK;
  out[3] = sk::BN;
  out[4] = sk::BK;
  out[5] = BM;
  out[6] = BN;
}

// bf16, M > 64: TMA + wgmma on a persistent grid of `grid` blocks.  K and
// N multiples of 8, A and B 16-byte aligned (else cudaErrorInvalidValue).
int systolic_gemm_bf16_wgmma(const void* A, const void* B, void* C, int M,
                             int K, int N, int activation, int out_bf16,
                             int grid, void* stream) {
  const bf16 *a = (const bf16*)A, *b = (const bf16*)B;
  cudaStream_t s = (cudaStream_t)stream;
  const int relu = activation == 1;
  return out_bf16 ? launch_wgmma(a, b, (bf16*)C, M, K, N, relu, grid, s)
                  : launch_wgmma(a, b, (float*)C, M, K, N, relu, grid, s);
}

// bf16, M <= 64: split-K over `splits` (1 .. ceil(K / 64)) shares of K.
// With splits > 1: `ws` holds splits x M x N floats, `counters` one int
// per 64-column panel, zero on entry and left zero on exit.
int systolic_gemm_bf16_splitk(const void* A, const void* B, void* C,
                              void* ws, void* counters, int M, int K, int N,
                              int activation, int out_bf16, int splits,
                              void* stream) {
  const bf16 *a = (const bf16*)A, *b = (const bf16*)B;
  cudaStream_t s = (cudaStream_t)stream;
  const int relu = activation == 1;
  float* w = (float*)ws;
  int* cnt = (int*)counters;
  return out_bf16 ? launch_splitk(a, b, (bf16*)C, w, cnt, M, K, N, relu,
                                  splits, s)
                  : launch_splitk(a, b, (float*)C, w, cnt, M, K, N, relu,
                                  splits, s);
}

// bf16 otherwise: 128 x 128 tiles of mma.sync; ceil(N / 128) <= 65535.
int systolic_gemm_bf16(const void* A, const void* B, void* C, int M, int K,
                       int N, int activation, int out_bf16, void* stream) {
  const bf16 *a = (const bf16*)A, *b = (const bf16*)B;
  cudaStream_t s = (cudaStream_t)stream;
  const int relu = activation == 1;
  return out_bf16 ? launch_bf16(a, b, (bf16*)C, M, K, N, relu, s)
                  : launch_bf16(a, b, (float*)C, M, K, N, relu, s);
}

// float32: 128 x 128 tiles on the CUDA cores; ceil(N / 128) <= 65535.
int systolic_gemm_f32(const float* A, const float* B, void* C, int M, int K,
                      int N, int activation, int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int relu = activation == 1;
  return out_bf16 ? launch_f32(A, B, (bf16*)C, M, K, N, relu, s)
                  : launch_f32(A, B, (float*)C, M, K, N, relu, s);
}

}  // extern "C"
