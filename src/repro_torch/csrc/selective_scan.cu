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
// (D,).  On the LM path: jamba's mamba layers, (4, 2048, 8192) with N = 16.
//
// What bounds it on this card: every (step, channel, state) costs one
// exponential, which the special-function units compute at 16 per clock per
// SM (0.26 ms for the path shape), about the time it takes to read x and dt
// and write y once (805 MB, 0.24 ms).  The recurrence is sequential in time
// and independent across channels.
//
// What the design does about it: one thread block per (batch, 128-channel
// tile); each thread owns one channel and keeps its N state values, and
// A * log2(e), in registers for the whole sequence, so h never touches
// memory.  B_t and C_t are shared by all channels: the block stages them
// for 64 time steps at a time in shared memory and every thread reads them
// as broadcasts.  x and dt are read coalesced along the channel axis, and
// each thread prefetches the next 8 steps' values into registers while it
// computes the current 8, which hides the load latency at the low
// occupancy this grid gives.  Ragged channel counts are bounds-checked (no
// padding); state slots beyond N hold zeros and add nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int CHUNK = 64;      // time steps of B and C staged per round
constexpr int UNROLL = 8;      // x / dt prefetch depth (registers)
constexpr float LOG2E = 1.4426950408889634f;

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

}  // namespace

extern "C" {

// x, dt, y (batch, S, D); B, C (batch, S, N); A (D, N); Dskip (D,): all
// float32, contiguous, on the device of `stream`.  1 <= N <= 16 and
// batch <= 65535 (the wrapper checks).  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for N outside the range).
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

}  // extern "C"
