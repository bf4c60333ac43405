// Batched max-plus products for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/maxplus.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/maxplus.py:29
// (maxplus_matmul_kernel, via maxplus_matmul_pallas and
// maxplus_matvec_pallas):
//
//     C[b, i, j] = max_k (A[b, i, k] + B[b, k, j])
//
// in float32, with -1e18 (NEG) standing for -inf, including in the ragged
// edges of a tile.  On the AIDG path the products are the (128, 128)
// Kleene-closure squarings of the blocked engine and its (128, 128) x
// (128,) per-block propagations, batched over blocks x candidates.
//
// Five kernels:
//
// * maxplus_matmul_kernel, maxplus_matvec_kernel -- the general product
//   and matrix-vector product, any shape.  Every (i, j, k) triple costs
//   two FP32 instructions (one add, one max): a (128, 128, 128) product is
//   2.1 M triples against 196 KB of traffic, so the matmul is bound by the
//   FP32 instruction rate; the matvec reads each A entry once and is bound
//   by memory bandwidth.  The matmul gives each thread block one 64 x 64
//   output tile and walks k through 16-deep shared-memory tiles of A
//   (stored transposed) and B; each of the 256 threads keeps a 4 x 4
//   register micro-tile.  The matvec gives one warp to one output row.
//
// * maxplus_closure_kernel -- the whole Kleene star P = (I (+) M)^(2^steps)
//   of every n x n block (n <= 128) of the batch in ONE launch: a
//   persistent grid whose thread blocks (one per SM) each walk items.  M =
//   D[blk] + w[item, i] is built in shared memory from the block's
//   structure and the item's work vector (or read whole, w NULL); P and its
//   transpose stay resident in shared memory through all the squarings
//   P <- max(P, P (x) P), and each item is written once.  In
//   lower mode (strictly lower-triangular structure, every finite value
//   below 2^35 in magnitude -- the caller's plan() checks both) only
//   entries i >= j are computed, over k in [j, i]: every other term is
//   NEG + x, which rounds back to NEG, so the result is bit for bit the
//   full product's while doing about a fifth of its triples.  Bound: the
//   diagonal of P stays 0, so only the triples j < k < i can change an
//   entry -- two FP32 instructions each -- plus one max with the old P per
//   entry i >= j.  Design: each thread owns one "piece"
//   -- an 8 x 8 output tile and a k range of at most 32 -- from a work
//   list the host builds (kernels/maxplus.py: closure_pieces): long tiles
//   near the corner are split over several threads so that no warp waits
//   on the few long tiles, and warps hold pieces of equal length; a tile's
//   other pieces leave their results in shared scratch slots, and its
//   first piece folds them all into P after one barrier.  The squarings
//   stop early, exactly, once one changes nothing.
//   An 8 x 8 micro-tile reads two 16-byte A values (from the transpose)
//   and two 16-byte B values per k for 128 FP32 instructions; an XOR
//   swizzle of the 16-byte chunks (at()) keeps the loads of neighbouring
//   tiles, and the fold's stores into the transpose, in distinct banks.
//   Tensor cores do not apply (max-plus is not a multiply-add semiring)
//   and DPX is integer-only, so each triple is one FADD and one FMNMX.
//
// * maxplus_matvec_lower_kernel -- t = C (x) h for closure blocks C whose
//   entries above the diagonal are exactly NEG (lower mode's output): row
//   i reads C[i, 0..i] only, and folds the skipped terms, whose max is
//   fl(NEG + max_{k>i} h_k) because rounding is monotone, from a suffix
//   max of h -- equal to the general matvec bit for bit for any h, with
//   half its bytes.  Bound: bytes.  One thread block per item; a lane
//   reads 16 bytes of a row at a time, and each warp reduces 32 rows at
//   once with a transposing butterfly (31 shuffles for 32 rows).
//
// * maxplus_matvec_folded_kernel -- h = max(h0, (D + w) (x) prev) with the
//   structure block D shared by the whole batch and the work w folded in
//   as it is read: the (batch, n, n) operand D + w is never written.  Each
//   sum rounds as (d_ij + w_i) + prev_j, as the plain version's two
//   separate adds do.  Bound: three FP32 instructions per (item, i, j).
//   Each block stages D through shared memory with coalesced reads; each
//   thread then keeps its row of D in registers and sweeps 16 items.
//
// Max is exact and order-free, so every kernel agrees bit for bit with its
// plain PyTorch version whatever the reduction order.  Build without fast
// math: no add may be contracted or reassociated.

#include <cuda_runtime.h>
#include <math.h>
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

// ---------------------------------------------------------------------------
// the closure: P resident in shared memory, one launch for the batch
// ---------------------------------------------------------------------------

constexpr int CL_N = 128;            // largest block the closure kernels take
constexpr int CL_LD = CL_N + 4;      // padded row of P and PT (33 chunks)
constexpr int CL_MAX_THREADS = 320;  // longest work list (closure_pieces)
constexpr int PIECE_FIELDS = 8;      // row0, col0, k0, k1, slot, 3 slots
constexpr int MAX_EXTRA = 3;         // other pieces of one tile, at most
constexpr int SLOT_LD = 64 + 4;      // one 8 x 8 result in scratch, padded
constexpr int CL_MAX_SLOTS = 256;    // scratch slots, at most (fits 227 KB)
constexpr int BUILD_BATCH = 8;       // loads in flight per thread in the build

// Where entry (r, c) of P (or of its transpose PT) lives: rows of CL_LD
// floats; within a row the 16-byte chunk q = c / 4 moves to q ^ (bit 3 of
// q) ^ (r / 8 mod 8).  The first term puts the 16-byte loads of eight
// neighbouring 8-wide tiles from one row in eight distinct bank groups;
// the second does the same for the stores of one tile column into eight
// rows r = col0 + j of tiles in different block columns (PT in the fold).
// A 16-byte-aligned group of four columns stays one.
__device__ __forceinline__ int at(int r, int c) {
  return r * CL_LD + (c ^ ((c >> 3) & 4) ^ ((r >> 1) & 28));
}

// one k of an 8 x 8 tile: a = P[row0 .. +8][k] (from PT), b = P[k][col0 ..
// +8]; a0/a1/b0/b1 are the four 16-byte groups' places in row k
__device__ __forceinline__ void closure_step(float (&acc)[8][8],
                                             const float* __restrict__ Pk,
                                             const float* __restrict__ PTk,
                                             int a0, int a1, int b0, int b1) {
  const float4 x0 = *reinterpret_cast<const float4*>(&PTk[a0]);
  const float4 x1 = *reinterpret_cast<const float4*>(&PTk[a1]);
  const float4 y0 = *reinterpret_cast<const float4*>(&Pk[b0]);
  const float4 y1 = *reinterpret_cast<const float4*>(&Pk[b1]);
  const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const float b[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaxf(acc[i][j], a[i] + b[j]);
}

// acc = max(acc, the 8 x 8 result another piece left in scratch slot sl)
__device__ __forceinline__ void fold_slot(float (&acc)[8][8],
                                          const float* sl) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 u0 = *reinterpret_cast<const float4*>(&sl[8 * i]);
    const float4 u1 = *reinterpret_cast<const float4*>(&sl[8 * i + 4]);
    const float u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaxf(acc[i][j], u[j]);
  }
}

// The tile at (row0, col0) <- max(P, acc), in P and in PT; returns
// whether any entry changed.
__device__ __forceinline__ int fold_tile(float (&acc)[8][8], float* P,
                                         float* PT, int row0, int col0) {
  const int p0 = at(row0, col0), p1 = at(row0, col0 + 4);
  const int t0 = at(col0, row0), t1 = at(col0, row0 + 4);
  int changed = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // rows row0 + i share row0's swizzle
    float4* q0 = reinterpret_cast<float4*>(&P[p0 + i * CL_LD]);
    float4* q1 = reinterpret_cast<float4*>(&P[p1 + i * CL_LD]);
    const float4 o0 = *q0, o1 = *q1;
    const float o[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = fmaxf(o[j], acc[i][j]);
      changed |= v != o[j];
      acc[i][j] = v;
    }
    *q0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *q1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {   // and columns col0 + j of PT
    *reinterpret_cast<float4*>(&PT[t0 + j * CL_LD]) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(&PT[t1 + j * CL_LD]) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
  return changed;
}

// A persistent grid: block b takes items b, b + gridDim.x, ...  D
// (items / per_blk, n, n), w (items, n) or NULL, out (items, n, n).
// P[i][j] lives at P[at(i, j)], its transpose PT the same way; rows and
// columns n..n8-1 are never read for a real entry (every k range ends at
// n).
__global__ void __launch_bounds__(CL_MAX_THREADS, 1)
maxplus_closure_kernel(const float* __restrict__ D, const float* __restrict__ w,
                       float* __restrict__ out, long long items,
                       long long per_blk, int n, int n8, int steps,
                       const int* __restrict__ pieces, int npieces) {
  extern __shared__ __align__(16) float smem[];
  float* P = smem;
  float* PT = smem + n8 * CL_LD;
  float* scratch = smem + 2 * n8 * CL_LD;   // SLOT_LD floats per slot
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const int nq = n / 4;                     // 16-byte groups per row
  const bool vec = n % 4 == 0 && ((uintptr_t)D & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;

  // this thread's piece: a contributor (slot >= 0) leaves its result in
  // scratch slot ``slot``; a tile's first piece (slot -1) folds in the
  // slots pc[5..7] (-1: none) and writes the tile
  const int* pc = pieces + PIECE_FIELDS * tid;
  int row0 = -1, col0 = 0, k0 = 0, k1 = 0, slot = -1;
  if (tid < npieces) {
    row0 = pc[0];
    col0 = pc[1];
    k0 = pc[2];
    k1 = pc[3];
    slot = pc[4];
  }
  const bool mine = row0 >= 0;
  // the tile's 16-byte groups in row k = 0 of P and PT (the loop XORs in
  // k / 8 mod 8)
  const int a0 = mine ? at(0, row0) : 0, a1 = mine ? at(0, row0 + 4) : 0;
  const int b0 = mine ? at(0, col0) : 0, b1 = mine ? at(0, col0 + 4) : 0;

  // rows and columns n..n8-1 of the padded square start as NEG (the
  // squarings write them, but no real entry ever reads them)
  if (n8 > n)
    for (int i = warp; i < n8; i += nwarps)
      for (int j = lane; j < n8; j += 32)
        if (i >= n || j >= n) P[at(i, j)] = PT[at(i, j)] = NEG_F;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const float* Dm = D + (item / per_blk) * (long long)n * n;
    const float* wm = w ? w + item * n : nullptr;
    float* om = out + item * (long long)n * n;

    // P = max(D + w, I): d_ij + w_i as the plain version rounds it.  Each
    // warp takes rows, its lanes 16-byte groups of a row, BUILD_BATCH rows
    // a pass, so the loads of a pass are in flight together.
    if (vec) {
      const float4* D4 = reinterpret_cast<const float4*>(Dm);
      for (int i0 = warp; i0 < n; i0 += BUILD_BATCH * nwarps) {
        float4 d[BUILD_BATCH];
        float wv[BUILD_BATCH];
#pragma unroll
        for (int r = 0; r < BUILD_BATCH; ++r) {
          const int i = i0 + r * nwarps;
          if (i < n && lane < nq) {
            d[r] = D4[i * nq + lane];
            wv[r] = wm ? wm[i] : 0.0f;
          }
        }
#pragma unroll
        for (int r = 0; r < BUILD_BATCH; ++r) {
          const int i = i0 + r * nwarps, j = 4 * lane;
          if (i < n && lane < nq) {
            float m[4] = {d[r].x, d[r].y, d[r].z, d[r].w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (wm) m[c] = m[c] + wv[r];
              m[c] = fmaxf(m[c], i == j + c ? 0.0f : NEG_F);
            }
            *reinterpret_cast<float4*>(&P[at(i, j)]) =
                make_float4(m[0], m[1], m[2], m[3]);
          }
        }
      }
    } else {
      for (int i = warp; i < n; i += nwarps) {
        const float wi = wm ? wm[i] : 0.0f;
        float d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = lane + 32 * c;
          d[c] = j < n ? Dm[i * n + j] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = lane + 32 * c;
          if (j < n) {
            const float m = wm ? d[c] + wi : d[c];
            P[at(i, j)] = fmaxf(m, i == j ? 0.0f : NEG_F);
          }
        }
      }
    }
    __syncthreads();
    for (int q = warp; q < n / 4; q += nwarps)   // PT from 4 P rows at a time
      for (int j = lane; j < n; j += 32) {
        float4 v;
        v.x = P[at(4 * q + 0, j)];
        v.y = P[at(4 * q + 1, j)];
        v.z = P[at(4 * q + 2, j)];
        v.w = P[at(4 * q + 3, j)];
        *reinterpret_cast<float4*>(&PT[at(j, 4 * q)]) = v;
      }
    for (int i = 4 * (n / 4); i < n; ++i)          // the rows past them
      for (int j = tid; j < n; j += blockDim.x) PT[at(j, i)] = P[at(i, j)];
    __syncthreads();

    for (int s = 0; s < steps; ++s) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = NEG_F;
      if (mine) {
        // pieces start at a multiple of 8, so k / 8 is fixed in each block
        int k = k0;
        for (; k + 8 <= k1; k += 8) {
          const int x = (k >> 1) & 28;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            closure_step(acc, P + (k + kk) * CL_LD, PT + (k + kk) * CL_LD,
                         a0 ^ x, a1 ^ x, b0 ^ x, b1 ^ x);
        }
        for (; k < k1; ++k) {
          const int x = (k >> 1) & 28;
          closure_step(acc, P + k * CL_LD, PT + k * CL_LD, a0 ^ x, a1 ^ x,
                       b0 ^ x, b1 ^ x);
        }
      }
      if (mine && slot >= 0) {   // leave this piece's result in its slot
        float* sl = scratch + slot * SLOT_LD;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          *reinterpret_cast<float4*>(&sl[8 * i]) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(&sl[8 * i + 4]) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
      __syncthreads();   // every read of this squaring's P is done
      // P <- max(P, Q): each tile's first piece folds in the other pieces'
      // results and the old P, then writes P and PT; a squaring that
      // changes nothing ends the closure (no later one would)
      int changed = 0;
      if (mine && slot < 0) {
#pragma unroll
        for (int e = 0; e < MAX_EXTRA; ++e) {
          const int x = pc[5 + e];   // read here: fewer registers live
          if (x >= 0) fold_slot(acc, scratch + x * SLOT_LD);
        }
        changed = fold_tile(acc, P, PT, row0, col0);
      }
      if (!__syncthreads_or(changed)) break;
    }

    if (vec) {
      float4* o4 = reinterpret_cast<float4*>(om);
      for (int i = warp; i < n; i += nwarps)
        if (lane < nq)
          o4[i * nq + lane] =
              *reinterpret_cast<const float4*>(&P[at(i, 4 * lane)]);
    } else {
      for (int i = warp; i < n; i += nwarps)
        for (int j = lane; j < n; j += 32) om[i * n + j] = P[at(i, j)];
    }
    __syncthreads();   // the store has read P before the next item's build
  }
}

// ---------------------------------------------------------------------------
// the propagation matvecs
// ---------------------------------------------------------------------------

constexpr int LV_WARPS = 4;   // 4 warps x 32 rows = CL_N rows per item

// One step of the transposing butterfly: v[0 .. 2S) holds 2S rows' partial
// maxes; each lane keeps the S rows on its side of bit S of the lane index,
// sends the other S to lane ^ S and takes its partner's for its own.
template <int S>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool up = (lane & S) != 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float send = up ? v[j] : v[j + S];
    const float keep = up ? v[j + S] : v[j];
    v[j] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, S));
  }
}

// t[b] = C[b] (x) h[b], C (batch, n, n) with C[b, i, k] == NEG for k > i.
// Warp w owns rows i = 4 r + w (r = 0..31), so every warp sees the whole
// triangle's spread of row lengths.
__global__ void __launch_bounds__(LV_WARPS * 32)
maxplus_matvec_lower_kernel(const float* __restrict__ C,
                            const float* __restrict__ h,
                            float* __restrict__ out, int n) {
  __shared__ __align__(16) float hs[CL_N];
  __shared__ float suf[CL_N + 1];   // suf[i] = max_{k >= i} h_k
  __shared__ float wmax[LV_WARPS];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned full = 0xffffffffu;

  float x = tid < n ? h[b * n + tid] : -INFINITY;
  hs[tid] = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_down_sync(full, x, d);
    if (lane + d < 32) x = fmaxf(x, y);
  }
  if (lane == 0) wmax[warp] = x;
  __syncthreads();
  for (int v = warp + 1; v < LV_WARPS; ++v) x = fmaxf(x, wmax[v]);
  suf[tid] = x;
  if (tid == 0) suf[CL_N] = -INFINITY;
  __syncthreads();

  const float* Cb = C + b * (long long)n * n;
  float v[32];
  if (n % 4 == 0 && ((uintptr_t)C & 15) == 0) {
    // lane l reads C[i, 4l .. 4l + 3] as one 16-byte load where 4l <= i;
    // the group's entries past i are true terms too (max is idempotent)
    const int nq = n / 4;
    const float4 h4 = lane < nq
        ? *reinterpret_cast<const float4*>(&hs[4 * lane])
        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = 4 * r + warp;
      v[r] = NEG_F;
      if (i < n && 4 * lane <= i) {
        const float4 c = reinterpret_cast<const float4*>(Cb + i * n)[lane];
        v[r] = fmaxf(v[r], fmaxf(fmaxf(c.x + h4.x, c.y + h4.y),
                                 fmaxf(c.z + h4.z, c.w + h4.w)));
      }
    }
  } else {
    float hk[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) hk[m] = hs[lane + 32 * m];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = 4 * r + warp;
      v[r] = NEG_F;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int k = lane + 32 * m;
        if (k <= i && i < n) v[r] = fmaxf(v[r], Cb[i * n + k] + hk[m]);
      }
    }
  }
  // transposing butterfly: after it lane l holds the max over all lanes
  // of row r = l
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  const int i = 4 * lane + warp;
  if (i < n) out[b * n + i] = fmaxf(v[0], NEG_F + suf[i + 1]);
}

constexpr int FV_ITEMS = 16;        // items per thread block
constexpr int FV_LD = CL_N + 1;     // odd row: row i of thread i, no conflicts

// h[b] = max(h0[b], (D + w[b]) (x) prev[b]): D (n, n) shared, w, prev, h0
// and h (batch, n).  The block stages D through shared memory (coalesced
// reads; FV_LD floats a row in the dynamic buffer), then thread i keeps
// row i in registers and sweeps the block's items.
__global__ void __launch_bounds__(CL_N)
maxplus_matvec_folded_kernel(const float* __restrict__ D,
                             const float* __restrict__ w,
                             const float* __restrict__ prev,
                             const float* __restrict__ h0,
                             float* __restrict__ out, long long batch, int n) {
  extern __shared__ float Dsh[];                       // [CL_N][FV_LD]
  __shared__ __align__(16) float ps[FV_ITEMS][CL_N];
  const long long b0 = (long long)blockIdx.x * FV_ITEMS;
  const int i = threadIdx.x;
#pragma unroll 16
  for (int e = i; e < CL_N * CL_N; e += CL_N) {
    const int r = e / CL_N, j = e % CL_N;
    Dsh[r * FV_LD + j] = (r < n && j < n) ? D[r * n + j] : NEG_F;
  }
  for (int e = i; e < FV_ITEMS * CL_N; e += CL_N) {
    const int c = e / CL_N, j = e % CL_N;
    ps[c][j] = (b0 + c < batch && j < n) ? prev[(b0 + c) * n + j] : -INFINITY;
  }
  __syncthreads();
  float d[CL_N];
#pragma unroll
  for (int j = 0; j < CL_N; ++j) d[j] = Dsh[i * FV_LD + j];
  if (i >= n) return;
  for (int c = 0; c < FV_ITEMS && b0 + c < batch; ++c) {
    const long long b = b0 + c;
    const float wi = w[b * n + i];
    float acc0 = NEG_F, acc1 = NEG_F, acc2 = NEG_F, acc3 = NEG_F;
#pragma unroll
    for (int j = 0; j < CL_N; j += 4) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[c][j]);
      acc0 = fmaxf(acc0, (d[j + 0] + wi) + p.x);
      acc1 = fmaxf(acc1, (d[j + 1] + wi) + p.y);
      acc2 = fmaxf(acc2, (d[j + 2] + wi) + p.z);
      acc3 = fmaxf(acc3, (d[j + 3] + wi) + p.w);
    }
    out[b * n + i] = fmaxf(h0[b * n + i],
                           fmaxf(fmaxf(acc0, acc1), fmaxf(acc2, acc3)));
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel and
// device; do it once per device (``done`` holds a flag for each).
constexpr int MAX_DEVICES = 64;
constexpr int CL_SMEM_MAX =
    (2 * CL_N * CL_LD + CL_MAX_SLOTS * SLOT_LD) * (int)sizeof(float);
int closure_smem_set[MAX_DEVICES];
int folded_smem_set[MAX_DEVICES];

int allow_smem(const void* kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES) done[dev] = 1;
  return 0;
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

// Kleene star of every item, one launch: out[item] = max(M, I)^(2^steps)
// with M = D[item / per_blk] + w[item][:, None] (w NULL: M = D[item],
// per_blk 1).  D (items / per_blk, n, n), w (items, n), out (items, n, n),
// all contiguous float32, n <= 128.  ``pieces`` (threads, 6) int32 on the
// device is the work list of closure_pieces (row0 -1: no work), ``nslots``
// its number of scratch slots.  Returns the first CUDA error (0 =
// launched).
int maxplus_closure_f32(const float* D, const float* w, float* out,
                        long long items, long long per_blk, int n, int steps,
                        const int* pieces, int threads, int nslots,
                        void* stream) {
  if (n <= 0 || n > CL_N || items <= 0 || items > 0x7fffffffLL ||
      per_blk <= 0 || steps < 0 || threads < 32 || threads % 32 != 0 ||
      threads > CL_MAX_THREADS || nslots < 0 || nslots > CL_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  const int n8 = (n + 7) / 8 * 8;
  const int smem = (2 * n8 * CL_LD + nslots * SLOT_LD) * (int)sizeof(float);
  const int err = allow_smem((const void*)maxplus_closure_kernel,
                             CL_SMEM_MAX, closure_smem_set);
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, maxplus_closure_kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = items < (long long)sms * per_sm
                             ? items : (long long)sms * per_sm;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  maxplus_closure_kernel<<<(unsigned)grid, threads, smem,
                           (cudaStream_t)stream>>>(
      D, w, out, items, per_blk, n, n8, steps, pieces, threads);
  return (int)cudaGetLastError();
}

// out[b] = C[b] (x) h[b] for closure blocks whose entries above the
// diagonal are NEG: C (batch, n, n), h and out (batch, n), n <= 128.
int maxplus_matvec_lower_f32(const float* C, const float* h, float* out,
                             long long batch, int n, void* stream) {
  if (n <= 0 || n > CL_N || batch <= 0 || batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  maxplus_matvec_lower_kernel<<<(unsigned)batch, LV_WARPS * 32, 0,
                                (cudaStream_t)stream>>>(C, h, out, n);
  return (int)cudaGetLastError();
}

// out[b] = max(h0[b], (D + w[b][:, None]) (x) prev[b]): D (n, n), w, prev,
// h0 and out (batch, n), n <= 128.
int maxplus_matvec_folded_f32(const float* D, const float* w,
                              const float* prev, const float* h0, float* out,
                              long long batch, int n, void* stream) {
  const long long blocks = (batch + FV_ITEMS - 1) / FV_ITEMS;
  if (n <= 0 || n > CL_N || blocks <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = CL_N * FV_LD * (int)sizeof(float);
  const int err = allow_smem((const void*)maxplus_matvec_folded_kernel, smem,
                             folded_smem_set);
  if (err != 0) return err;
  maxplus_matvec_folded_kernel<<<(unsigned)blocks, CL_N, smem,
                                 (cudaStream_t)stream>>>(D, w, prev, h0, out,
                                                         batch, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
