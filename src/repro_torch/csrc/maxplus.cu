// Batched max-plus matrix product and matrix-vector product for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// repro_torch/kernels/maxplus.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/maxplus.py:29
// (maxplus_matmul_kernel, via maxplus_matmul_pallas and
// maxplus_matvec_pallas):
//
//     C[b, i, j] = max_k (A[b, i, k] + B[b, k, j])
//
// in float32, with -1e18 (NEG) standing for -inf, including in the ragged
// edges of a tile.  On the AIDG path the products are the (128, 128) x
// (128, 128) Kleene-closure squarings of the blocked engine and the
// (128, 128) x (128,) per-block propagations, batched over candidates x
// blocks.
//
// What bounds it on this card: every (i, j, k) triple costs two FP32
// instructions (one add, one max).  A (128, 128, 128) product is 2.1 M
// triples against 196 KB of traffic, so the matmul is bound by the FP32
// instruction rate, not by memory.  Tensor cores do not apply: max-plus
// is not a multiply-add semiring.  The matvec reads each A entry once for
// one triple, so it is bound by memory bandwidth.
//
// What the design does about it: the matmul gives each thread block one
// 64 x 64 output tile of one batch item and walks k through 16-deep
// shared-memory tiles of A (stored transposed) and B.  Each of the 256
// threads keeps a 4 x 4 register micro-tile of accumulators initialised to
// NEG and reads its 4 A values and 4 B values per k as two 16-byte
// shared-memory loads, so 32 FP32 instructions share 2 loads.  Ragged
// edges load NEG, which can never win a max against a real path.  The
// matvec gives one warp to one output row: the lanes stride along k with
// coalesced loads of A and reduce with warp shuffles.  Max is exact and
// order-free, so both kernels agree bit for bit with the plain PyTorch
// version whatever the reduction order.  wgmma, TMA and Hopper's DPX
// instructions are not used yet.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_F (-1e18f)

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 16;    // k depth of one shared-memory tile
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int AS_LD = BM + 4;   // padded row of the transposed A tile

__global__ void __launch_bounds__(THREADS)
maxplus_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int M, int K, int N,
                      int tiles_m, int tiles_n) {
  __shared__ __align__(16) float As[BK][AS_LD];   // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];      // Bs[k][n]

  int64_t idx = blockIdx.x;
  const int tn = (int)(idx % tiles_n);
  idx /= tiles_n;
  const int tm = (int)(idx % tiles_m);
  const int64_t bz = idx / tiles_m;

  const float* Ab = A + bz * (int64_t)M * K;
  const float* Bb = B + bz * (int64_t)K * N;
  float* Cb = C + bz * (int64_t)M * N;

  const int row0 = tm * BM;
  const int col0 = tn * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // 0..15: column group
  const int ty = tid / (BN / TN);   // 0..15: row group

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = NEG_F;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK, read along k (coalesced), stored transposed
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int m = e / BK;
      const int k = e % BK;
      const int gm = row0 + m;
      const int gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? Ab[(int64_t)gm * K + gk] : NEG_F;
    }
    // B tile: BK x BN, read along n (coalesced)
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int k = e / BN;
      const int n = e % BN;
      const int gk = k0 + k;
      const int gn = col0 + n;
      Bs[k][n] = (gk < K && gn < N) ? Bb[(int64_t)gk * N + gn] : NEG_F;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaxf(acc[i][j], av[i] + bv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) Cb[(int64_t)gm * N + gn] = acc[i][j];
    }
  }
}

constexpr int MV_WARPS = 8;   // output rows per block, one warp each

__global__ void __launch_bounds__(MV_WARPS * 32)
maxplus_matvec_kernel(const float* __restrict__ A, const float* __restrict__ v,
                      float* __restrict__ out, int M, int K, int tiles_m) {
  const int64_t bz = blockIdx.x / tiles_m;
  const int tm = (int)(blockIdx.x % tiles_m);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = tm * MV_WARPS + warp;
  if (row >= M) return;   // whole warp leaves together
  const float* a = A + (bz * M + row) * (int64_t)K;
  const float* vb = v + bz * (int64_t)K;
  float acc = NEG_F;
  for (int k = lane; k < K; k += 32) acc = fmaxf(acc, a[k] + vb[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = fmaxf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[bz * (int64_t)M + row] = acc;
}

}  // namespace

extern "C" {

// C[b] = A[b] (x) B[b] for contiguous float32 A (batch, M, K),
// B (batch, K, N), C (batch, M, N).  Returns cudaGetLastError() after the
// launch (0 = launched).
int maxplus_matmul_f32(const float* A, const float* B, float* C,
                       long long batch, int M, int K, int N, void* stream) {
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const long long blocks = batch * tiles_m * tiles_n;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  maxplus_matmul_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(A, B, C, M, K, N, tiles_m,
                                                  tiles_n);
  return (int)cudaGetLastError();
}

// out[b] = A[b] (x) v[b] for contiguous float32 A (batch, M, K),
// v (batch, K), out (batch, M).  Returns cudaGetLastError().
int maxplus_matvec_f32(const float* A, const float* v, float* out,
                       long long batch, int M, int K, void* stream) {
  const int tiles_m = (M + MV_WARPS - 1) / MV_WARPS;
  const long long blocks = batch * tiles_m;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  maxplus_matvec_kernel<<<(unsigned)blocks, MV_WARPS * 32, 0,
                          (cudaStream_t)stream>>>(A, v, out, M, K, tiles_m);
  return (int)cudaGetLastError();
}

}  // extern "C"
