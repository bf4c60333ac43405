// Mamba-1 selective scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/selective_scan.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py:29
// (selective_scan_kernel, via selective_scan_pallas and ops.selective_scan):
//
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      h: (D, N) per batch
//     y_t = h_t . C_t + Dskip * x_t
//
// x, dt, y: (batch, S, D) float32; B, C: (batch, S, N); A: (D, N); Dskip:
// (D,).  On the LM path: jamba's mamba layers, (4, 2048, 8192) with N = 16
// when scoring, (1, 1024, 8192) in the float32 check.
//
// What bounds it on this card: every (step, channel, state) costs one
// exponential, which the special-function units (MUFU) compute at 16 per
// clock per SM (0.26 ms for the path shape), about the time it takes to
// read x and dt and write y once (805 MB, 0.24 ms at 3.35 TB/s).  At the
// MUFU's rate the scan has to stream 12 bytes per 16 exponentials, 94% of
// the memory's rate: both limits have to be held at once.  The recurrence
// is sequential in time and independent across channels.
//
// Two kernels, each with its own entry point; the host's plan
// (kernels/selective_scan.py) picks by shape and alignment alone:
//
//   * ring -- D % 4 == 0 and x, dt, y 16-byte aligned (what TMA takes):
//     the design below;
//   * pr12 -- everything else: the first port's kernel (one thread per
//     channel, B and C staged behind __syncthreads), kept as it was; it is
//     also the yardstick the ring kernel is timed against.
//
// The ring kernel's design, point by point against what held the pr12
// kernel at 40% of its bound (times: tools/scan_breakdown.py on an H100
// SXM at 700 W, device time at the path shape):
//
//   * lanes per channel: each channel's N states (padded to NP = 4, 8 or
//     16) are split over L adjacent lanes (L = 1, 2, 4 or 8), each lane
//     holding NP / L of them, their A * log2(e) and h in registers for the
//     whole sequence.  A block has 4 consumer warps (128 / L channels) and
//     1 producer warp.  More lanes give more warps per channel but add
//     shuffles and shared loads to every (step, state): at the path shape
//     L = 2 (16 consumer warps per SM) takes 9% longer than L = 1 (8) and
//     L = 4 54% longer, so the plan takes the fewest lanes that load the busiest SM as
//     lightly as any (L = 1 at the path shape, L = 2 at (1, 1024, 8192)).
//     With L > 1, y's partial dots meet by __shfl_xor_sync in a fixed
//     order: two calls are bit for bit equal;
//   * an asynchronous ring instead of __syncthreads staging: the producer
//     warp keeps STAGES tiles of T = 16 steps in flight -- x and dt by TMA
//     (3-D maps (D, S, batch), zero-filled past D and S), B and C by
//     cp.async into a [T][NP] layout zero-filled past N (any N, any
//     alignment) -- behind full/empty mbarriers; it never waits for its
//     own copies, only for free slots.  The ring alone (no arithmetic, no
//     y) streams x and dt at ~3.1 TB/s;
//   * y leaves by TMA too: each consumer warp keeps a tile's y in
//     registers (a shared store between two steps would keep the compiler
//     from hoisting the next step's shared loads above it), then writes
//     them into one of two shared buffers and one lane stores the (T,
//     32 / L) box (a direct store from the first lane of each channel's
//     group, tools/scan_breakdown.py's y_direct, is 10% slower);
//   * shorter chains: the exponentials do not depend on h, so the loop
//     is software-pipelined -- each state's exponential for the next step
//     is issued beside its update for this step, which spreads the MUFU's
//     work evenly instead of in bursts -- and the dot is 2 (4 at NP / L =
//     16) interleaved partial sums instead of one chain of N dependent
//     FFMAs;
//   * the exponential is ex2.approx.ftz.f32 by inline PTX: exp2f() without
//     fast math compiles to MUFU.EX2 wrapped in a range test and two
//     multiplies (to keep results below 2^-126), three issue slots per
//     (step, state) the loop cannot spare.  Flushing results below 2^-126
//     to zero changes y by far less than the 1e-4 tolerance.  Computing
//     one exponential in eight on the FMA pipe instead (a polynomial) was
//     measured and left out: 3% slower, since the loop issues ~6
//     instructions per exponential and the MUFU is not its only limit.
//
// Ragged channel counts are masked (TMA zero-fills loads and clips
// stores); state slots beyond N hold zeros and add nothing.
//
// ring_state -- the ring kernel with the state: each lane starts its
// states from h0 (batch, D, N) instead of zeros and writes them to hS
// after the last step, so that a prefill leaves the state a decode step
// continues from.  Steps past S in the last tile read dt = x = 0 and B =
// 0 (zero-filled), so they leave h as it is (2^0 = 1 exactly): hS is
// h_S.  The stateless instances compile as before (STATE is a template
// argument), so their results keep their bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// pr12: one thread per channel
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;   // channels per block
constexpr int CHUNK = 64;      // time steps of B and C staged per round
constexpr int UNROLL = 8;      // x / dt prefetch depth (registers)

template <int NMAX>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ Dskip,
                      float* __restrict__ y, int S, int D, int N) {
  __shared__ __align__(16) float sB[CHUNK * NMAX];
  __shared__ __align__(16) float sC[CHUNK * NMAX];

  const int64_t b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const bool live = ch < D;

  float a2[NMAX], h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = (live && n < N) ? A[(int64_t)ch * N + n] * LOG2E : 0.f;
    h[n] = 0.f;
  }
  const float dskip = live ? Dskip[ch] : 0.f;

  const int64_t row0 = b * S;                 // row of (b, t = 0)
  const float* xb = x + row0 * D + ch;
  const float* db = dt + row0 * D + ch;
  float* yb = y + row0 * D + ch;

  float xv[UNROLL], dv[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool ok = live && u < S;
    xv[u] = ok ? xb[(int64_t)u * D] : 0.f;
    dv[u] = ok ? db[(int64_t)u * D] : 0.f;
  }

  for (int tg = 0; tg < S; tg += UNROLL) {
    const int t_chunk = tg - tg % CHUNK;
    if (tg == t_chunk) {                      // stage B, C for 64 steps
      __syncthreads();                        // last round's readers are done
      const int steps = min(CHUNK, S - t_chunk);
      for (int i = threadIdx.x; i < CHUNK * NMAX; i += THREADS) {
        const int t = i / NMAX, n = i - t * NMAX;
        const bool ok = t < steps && n < N;
        const int64_t off = (row0 + t_chunk + t) * N + n;
        sB[i] = ok ? Bm[off] : 0.f;
        sC[i] = ok ? Cm[off] : 0.f;
      }
      __syncthreads();
    }
    float xn[UNROLL], dn[UNROLL];             // prefetch the next 8 steps
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = tg + UNROLL + u;
      const bool ok = live && t < S;
      xn[u] = ok ? xb[(int64_t)t * D] : 0.f;
      dn[u] = ok ? db[(int64_t)t * D] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = tg + u;
      if (live && t < S) {
        const float* bt = sB + (t - t_chunk) * NMAX;
        const float* ct = sC + (t - t_chunk) * NMAX;
        const float dtx = dv[u] * xv[u];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          const float dA = exp2f(dv[u] * a2[n]);
          h[n] = fmaf(dA, h[n], dtx * bt[n]);
          acc = fmaf(h[n], ct[n], acc);
        }
        yb[(int64_t)t * D] = fmaf(dskip, xv[u], acc);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      xv[u] = xn[u];
      dv[u] = dn[u];
    }
  }
}

template <int NMAX>
int launch(const float* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* Dskip, float* y, int batch, int S,
           int D, int N, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, batch);
  selective_scan_kernel<NMAX><<<grid, THREADS, 0, stream>>>(
      x, dt, Bm, Cm, A, Dskip, y, S, D, N);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ring: split states, a TMA ring, TMA stores
// ---------------------------------------------------------------------------

namespace ring {

constexpr int CONSUMERS = 128;             // 4 consumer warps
constexpr int THREADS = CONSUMERS + 32;    // + 1 producer warp
constexpr int T = 16;                      // steps per ring tile

// the layout of one block's shared memory for L lanes a channel and NP
// state slots; kernels/selective_scan.py::ring_smem_bytes mirrors it
template <int L, int NP>
struct Cfg {
  static constexpr int CB = CONSUMERS / L;       // channels per block
  static constexpr int CW = 32 / L;              // channels per warp
  static constexpr int SPL = NP / L;             // states per lane
  static constexpr int STAGES = L <= 2 ? 4 : 3;  // ring tiles
  // blocks the launch bounds ask to fit on an SM (registers)
  static constexpr int MIN_BLOCKS = L == 1 ? 2 : (L == 2 ? 4 : 8);
  static constexpr int XT = T * CB * 4;          // one x or dt tile (bytes)
  static constexpr int BT = T * NP * 4;          // one B or C tile
  static constexpr int YT = T * CW * 4;          // one warp's y tile
  static constexpr int X_OFF = 0;
  static constexpr int DT_OFF = STAGES * XT;
  static constexpr int B_OFF = 2 * STAGES * XT;
  static constexpr int C_OFF = B_OFF + STAGES * BT;
  static constexpr int Y_OFF = C_OFF + STAGES * BT;
  static constexpr int BAR_OFF = Y_OFF + 4 * 2 * YT;
  // + the barriers, + 128 to align the base
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 128;
  static_assert(SPL >= 1 && NP % L == 0, "L must divide NP");
  static_assert(XT % 128 == 0 && BT % 128 == 0 && YT % 128 == 0,
                "TMA tiles start on 128-byte boundaries");
};

// 2^x on the MUFU alone (see the header: no range test, results below
// 2^-126 flush to zero)
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 4 bytes from global into shared memory, or 4 zero bytes when `ok` is
// false (then nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// one arrival on `bar` once this thread's cp.async copies so far have
// landed (counted in the barrier's initial count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar) : "memory");
}

// SPL consecutive floats from shared memory, as wide loads
template <int SPL>
__device__ __forceinline__ void lds(float (&v)[SPL], const float* p) {
  if constexpr (SPL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPL; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (SPL == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// h . c over one lane's SPL states is taken as DOT_P interleaved partial
// sums (4 at SPL = 16, 2 from SPL = 2, else 1), p[j % DOT_P] accumulating
// h[j] c[j] in j order, then added as a tree by dot_sum; the CPU tests
// emulate this order (tests/test_torch_scan_plan.py)
template <int SPL>
constexpr int DOT_P = SPL >= 16 ? 4 : (SPL >= 2 ? 2 : 1);

template <int SPL>
__device__ __forceinline__ float dot_sum(const float (&p)[DOT_P<SPL>]) {
  if constexpr (DOT_P<SPL> == 4) return (p[0] + p[1]) + (p[2] + p[3]);
  else if constexpr (DOT_P<SPL> == 2) return p[0] + p[1];
  else return p[0];
}

template <int L, int NP, bool STATE>
__global__ void __launch_bounds__(THREADS, (Cfg<L, NP>::MIN_BLOCKS))
selective_scan_ring_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_dt,
                           const __grid_constant__ CUtensorMap map_y,
                           const float* __restrict__ Bm,
                           const float* __restrict__ Cm,
                           const float* __restrict__ A,
                           const float* __restrict__ Dskip,
                           float* __restrict__ y,
                           const float* __restrict__ h0,
                           float* __restrict__ hS, int S, int D, int N) {
  using C = Cfg<L, NP>;
  constexpr int SPL = C::SPL, CB = C::CB, CW = C::CW, STAGES = C::STAGES;
  constexpr int DP = DOT_P<SPL>;              // partial dots
  extern __shared__ uint8_t smem_ss[];
  const uint32_t raw = smem_u32(smem_ss);
  const uint32_t base = (raw + 127u) & ~127u;
  uint8_t* sbase = smem_ss + (base - raw);
  auto sx = [&](int s) { return (float*)(sbase + C::X_OFF + s * C::XT); };
  auto sdt = [&](int s) { return (float*)(sbase + C::DT_OFF + s * C::XT); };
  auto sB = [&](int s) { return (float*)(sbase + C::B_OFF + s * C::BT); };
  auto sC = [&](int s) { return (float*)(sbase + C::C_OFF + s * C::BT); };
  auto full = [&](int s) { return base + C::BAR_OFF + 8 * s; };
  auto empty = [&](int s) { return base + C::BAR_OFF + 8 * (STAGES + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, c0 = blockIdx.x * CB;
  const int tiles = (S + T - 1) / T;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's 32 lanes each arrive once their B and C copies
      // have landed, lane 0 once more with the TMA bytes
      mbar_init(full(s), 33);
      mbar_init(empty(s), 4);          // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: tile i of x and dt by TMA, of B and C by cp.async into
    // [T][NP] (zeros past N and past S), once its slot is free; it never
    // waits for its own copies, only for free slots
    const float* Bb = Bm + (int64_t)b * S * N;
    const float* Cb = Cm + (int64_t)b * S * N;
    constexpr int PER_LANE = T * NP / 32;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES, t0 = i * T;
      if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * C::XT);
        tma_load_3d(smem_u32(sx(s)), &map_x, c0, t0, b, full(s));
        tma_load_3d(smem_u32(sdt(s)), &map_dt, c0, t0, b, full(s));
      }
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int e = lane + 32 * j, t = e / NP, n = e % NP;
        const bool ok = n < N && t0 + t < S;
        const int64_t off = ok ? (int64_t)(t0 + t) * N + n : 0;
        cp_async4(sB(s) + e, Bb + off, ok);
        cp_async4(sC(s) + e, Cb + off, ok);
      }
      cp_async_arrive(full(s));
    }
    return;
  }

  // consumers: lane k of channel group g holds states k*SPL .. k*SPL+SPL-1
  const int tid = threadIdx.x, g = tid / L, k = tid % L;
  const int ch = c0 + g;
  const bool live = ch < D;
  float a2[SPL], h[SPL];
  const int64_t hrow = ((int64_t)b * D + ch) * N;   // (b, ch) in h0 and hS
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = k * SPL + j;
    a2[j] = (live && n < N) ? A[(int64_t)ch * N + n] * LOG2E : 0.f;
    if constexpr (STATE)
      h[j] = (live && n < N) ? h0[hrow + n] : 0.f;
    else
      h[j] = 0.f;
  }
  const float dskip = live ? Dskip[ch] : 0.f;
  float* ybuf = (float*)(sbase + C::Y_OFF) + warp * 2 * (T * CW);
  const bool warp_live = c0 + warp * CW < D;    // its y box holds a channel

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES, t0 = i * T;
    mbar_wait(full(s), (i / STAGES) & 1);
    const float* tx = sx(s);
    const float* tdt = sdt(s);
    const float* tb = sB(s) + k * SPL;
    const float* tc = sC(s) + k * SPL;
    // y stays in registers until the tile's steps are done: a shared
    // store between two steps would keep the compiler from hoisting the
    // next step's shared loads above it
    float yt[T], dA[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) dA[j] = ex2_ftz(tdt[g] * a2[j]);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float xv = tx[t * CB + g], dv = tdt[t * CB + g];
      const float dv_next = t + 1 < T ? tdt[(t + 1) * CB + g] : 0.f;
      float bv[SPL], cv[SPL], dA_next[SPL], p[DP];
      lds<SPL>(bv, tb + t * NP);
      lds<SPL>(cv, tc + t * NP);
      const float dtx = dv * xv;
      // software-pipelined: state j's exponential for the next step (it
      // does not depend on h) beside its update for this step, so that
      // the MUFU gets one exponential in every ~5 instructions instead of
      // bursts; the dot as DOT_P interleaved partial sums (see dot_sum)
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        if (t + 1 < T) dA_next[j] = ex2_ftz(dv_next * a2[j]);
        h[j] = fmaf(dA[j], h[j], dtx * bv[j]);
        p[j % DP] = j < DP ? h[j] * cv[j] : fmaf(h[j], cv[j], p[j % DP]);
      }
      float acc = dot_sum<SPL>(p);
#pragma unroll
      for (int m = 1; m < L; m <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      yt[t] = fmaf(dskip, xv, acc);
      if (t + 1 < T) {
#pragma unroll
        for (int j = 0; j < SPL; ++j) dA[j] = dA_next[j];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    float* ty = ybuf + (i & 1) * (T * CW);
    if (i >= 2) {
      // the store of tile i - 2 has read this buffer
      if (lane == 0) tma_store_wait_read<1>();
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (k == 0) ty[t * CW + lane / L] = yt[t];
    fence_proxy_async();                 // the y tile is visible to TMA
    __syncwarp();
    if (lane == 0 && warp_live) {
      tma_store_3d(&map_y, smem_u32(ty), c0 + warp * CW, t0, b);
      tma_store_commit();
    }
  }
  if constexpr (STATE) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int n = k * SPL + j;
      if (live && n < N) hS[hrow + n] = h[j];
    }
  }
  if (lane == 0) tma_store_wait_read<0>();
}

// a contiguous (batch, S, D) float32 tensor as a 3-D map (D, S, batch),
// boxes of `box_c` channels x T steps x 1 batch row; loads zero-fill past
// every bound, stores clip
bool encode_rows(CUtensorMap* map, const void* ptr, int batch, int S, int D,
                 int box_c) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)D * 4;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {row, row * (cuuint64_t)S};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)T, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int L, int NP, bool STATE>
int launch(const float* x, const float* dt, const float* Bm, const float* Cm,
           const float* A, const float* Dskip, float* y, const float* h0,
           float* hS, int batch, int S, int D, int N, cudaStream_t stream) {
  using C = Cfg<L, NP>;
  CUtensorMap mx, mdt, my;
  if (!encode_rows(&mx, x, batch, S, D, C::CB) ||
      !encode_rows(&mdt, dt, batch, S, D, C::CB) ||
      !encode_rows(&my, y, batch, S, D, C::CW))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_ring_kernel<L, NP, STATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  // the largest shared-memory carve-out, so that MIN_BLOCKS blocks fit
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(selective_scan_ring_kernel<L, NP, STATE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((D + C::CB - 1) / C::CB, batch);
  selective_scan_ring_kernel<L, NP, STATE>
      <<<grid, THREADS, C::SMEM, stream>>>(mx, mdt, my, Bm, Cm, A, Dskip, y,
                                           h0, hS, S, D, N);
  return (int)cudaGetLastError();
}

// the (L, NP) instances: NP in {4, 8, 16}, L in {1, 2, 4, 8} with L <= NP
#define RING_INSTANCES(X)                                                  \
  X(1, 4) X(2, 4) X(4, 4) X(1, 8) X(2, 8) X(4, 8) X(8, 8) X(1, 16)         \
      X(2, 16) X(4, 16) X(8, 16)

// the ring kernel (with the state where STATE) at `lanes` lanes: checks
// what the kernel takes, then launches the (lanes, padded N) instance
template <bool STATE>
int ring_entry(const float* x, const float* dt, const float* Bm,
               const float* Cm, const float* A, const float* Dskip, float* y,
               const float* h0, float* hS, int batch, int S, int D, int N,
               int lanes, cudaStream_t stream) {
  if (N < 1 || N > 16 || D % 4 != 0 ||
      ((uintptr_t)x | (uintptr_t)dt | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int np = N <= 4 ? 4 : (N <= 8 ? 8 : 16);
#define RING_LAUNCH(LL, NN)                                                \
  if (lanes == LL && np == NN)                                             \
    return launch<LL, NN, STATE>(x, dt, Bm, Cm, A, Dskip, y, h0, hS, batch, \
                                 S, D, N, stream);
  RING_INSTANCES(RING_LAUNCH)
#undef RING_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace ring

}  // namespace

extern "C" {

// Every entry point: x, dt, y (batch, S, D); B, C (batch, S, N); A (D, N);
// Dskip (D,): all float32, contiguous, on the device of `stream`.  1 <= N
// <= 16 and batch <= 65535 (the wrapper checks).  Return
// cudaGetLastError() after the launch, or the error that kept it from
// launching (cudaErrorInvalidValue for inputs the kernel does not take).

// the pr12 kernel: any D, any alignment
int selective_scan_f32(const float* x, const float* dt, const float* Bm,
                       const float* Cm, const float* A, const float* Dskip,
                       float* y, int batch, int S, int D, int N,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 4) return launch<4>(x, dt, Bm, Cm, A, Dskip, y, batch, S, D, N, s);
  if (N <= 8) return launch<8>(x, dt, Bm, Cm, A, Dskip, y, batch, S, D, N, s);
  if (N <= 16) return launch<16>(x, dt, Bm, Cm, A, Dskip, y, batch, S, D, N, s);
  return (int)cudaErrorInvalidValue;
}

// the ring kernel with `lanes` lanes a channel (1, 2, 4 or 8, at most N
// padded to 4, 8 or 16): D % 4 == 0 and x, dt, y 16-byte aligned
int selective_scan_f32_ring(const float* x, const float* dt, const float* Bm,
                            const float* Cm, const float* A,
                            const float* Dskip, float* y, int batch, int S,
                            int D, int N, int lanes, void* stream) {
  return ring::ring_entry<false>(x, dt, Bm, Cm, A, Dskip, y, nullptr, nullptr,
                                 batch, S, D, N, lanes,
                                 (cudaStream_t)stream);
}

// the ring kernel with the state (ring_state): as selective_scan_f32_ring,
// the states starting from h0 (batch, D, N) float32 and written to hS
// (the same shape, another buffer) after the last step
int selective_scan_f32_ring_state(const float* x, const float* dt,
                                  const float* Bm, const float* Cm,
                                  const float* A, const float* Dskip,
                                  float* y, const float* h0, float* hS,
                                  int batch, int S, int D, int N, int lanes,
                                  void* stream) {
  return ring::ring_entry<true>(x, dt, Bm, Cm, A, Dskip, y, h0, hS, batch, S,
                                D, N, lanes, (cudaStream_t)stream);
}

// the ring kernel's dynamic shared memory in bytes for `lanes` lanes and
// `np` state slots, or -1 for an instance it does not have
int selective_scan_ring_smem_bytes(int lanes, int np) {
#define RING_SMEM(LL, NN) \
  if (lanes == LL && np == NN) return ring::Cfg<LL, NN>::SMEM;
  RING_INSTANCES(RING_SMEM)
#undef RING_SMEM
  return -1;
}

// the ring kernel's steps per tile
int selective_scan_ring_steps(void) { return ring::T; }

}  // extern "C"
