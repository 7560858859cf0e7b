// Mamba selective scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssm_scan.py::ssm_scan (Pallas body `_kernel`),
// the TPU kernel behind ops.ssm_scan in every Mamba layer (models/ssm.py
// mamba_forward), at prefill and at decode.
//
// What it computes, for each (batch b, channel d), walking t = 0 .. T-1:
//   h[n]   <- exp(dt_t[d] * A[d][n]) * h[n] + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d]  = sum_n h[n] * C_t[n] + D[d] * x_t[d]
// x (B, T, Din), B_t / C_t rows of Bm / Cm (B, T, N), all three in fp32 or
// bf16 (one template type: the model produces them in its dtype); dt
// (B, T, Din), A (Din, N), D (Din,) and h0 (B, Din, N) fp32, as the model
// produces them (nothing is cast on entry) -> y (B, T, Din) in x's dtype and
// the final h (B, Din, N) fp32. The state and sums are fp32, exp is the
// accurate expf (no fast math).
//
// Design. One thread owns one (b, d) channel and keeps its N <= 16 states
// and its row of A in registers; a block of 64 threads covers 64 channels
// of one sequence. Bm and Cm rows are shared by every channel of a
// sequence: each block stages TT = 32 steps of them in shared memory at a
// time (two barriers per 32 steps), read as broadcasts. x_t[d] and dt_t[d]
// are read coalesced across d, one step ahead of the arithmetic. Bm and Cm
// may be views with a row stride (the model slices them out of one
// projection), so their batch and time strides are arguments.
//
// What bounds it here. A step costs ~7 fp32 operations per state element
// (an exp counted as one): at Jamba's prefill (B = 1, T = 1024,
// Din = 16384, N = 16) that is 1.9 G operations, 28 us at the fp32 rate,
// and 136 MB moved (bf16 x and y, fp32 dt), 41 us at the HBM rate. The T
// steps are a dependent chain per channel and the grid holds 16384
// threads, ~4 warps an SM: latency, not the card's rates, sets the time
// (the numbers are in PERF.md).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int NT = 64;       // channels per block
constexpr int MAX_N = 16;    // state size (checked in Python)
constexpr int TT = 32;       // steps of Bm / Cm staged per round

template <typename T>
__global__ void __launch_bounds__(NT)
    ssm_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ h0, T* __restrict__ y,
               float* __restrict__ hT, int Tlen, int Din, int N,
               long long bc_sb, long long bc_st) {
  __shared__ float sB[TT][MAX_N], sC[TT][MAX_N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * NT + threadIdx.x;
  const bool on = d < Din;

  float h[MAX_N], a[MAX_N];
  float Dd = 0.f;
  const size_t hrow = (size_t(b) * Din + d) * N;
#pragma unroll
  for (int n = 0; n < MAX_N; ++n) {
    h[n] = (on && n < N) ? h0[hrow + n] : 0.f;
    a[n] = (on && n < N) ? A[size_t(d) * N + n] : 0.f;
  }
  if (on) Dd = D[d];

  const size_t xrow = size_t(b) * Tlen * Din + d;   // x[b, t, d]: + t * Din
  const T* Bb = Bm + b * bc_sb;
  const T* Cb = Cm + b * bc_sb;
  float nx = 0.f, ndt = 0.f;
  if (on) {
    nx = to_f32(x[xrow]);
    ndt = dt[xrow];
  }
  for (int t0 = 0; t0 < Tlen; t0 += TT) {
    const int tt = min(TT, Tlen - t0);
    __syncthreads();   // every thread is done with the previous round
    for (int i = threadIdx.x; i < tt * N; i += NT) {
      const int s = i / N, n = i % N;
      const long long o = (t0 + s) * bc_st + n;
      sB[s][n] = to_f32(Bb[o]);
      sC[s][n] = to_f32(Cb[o]);
    }
    __syncthreads();
    if (!on) continue;
    for (int s = 0; s < tt; ++s) {
      const int t = t0 + s;
      const float xt = nx, dtt = ndt;
      if (t + 1 < Tlen) {
        nx = to_f32(x[xrow + size_t(t + 1) * Din]);
        ndt = dt[xrow + size_t(t + 1) * Din];
      }
      const float bx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < MAX_N; ++n) {
        if (n < N) {
          h[n] = expf(dtt * a[n]) * h[n] + bx * sB[s][n];
          acc += h[n] * sC[s][n];
        }
      }
      y[xrow + size_t(t) * Din] = from_f32<T>(acc + Dd * xt);
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < MAX_N; ++n)
      if (n < N) hT[hrow + n] = h[n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* hT, int B, int Tlen,
                   int Din, int N, long long bc_sb, long long bc_st,
                   cudaStream_t stream) {
  dim3 grid((Din + NT - 1) / NT, B);
  ssm_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hT), Tlen, Din, N, bc_sb, bc_st);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* h0, void* y, void* hT, int B, int T,
                              int Din, int N, long long bc_sb,
                              long long bc_st, int dtype, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || Din < 1 || N < 1 || N > MAX_N)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(x, dt, A, Bm, Cm, D, h0, y, hT, B, T, Din, N, bc_sb,
                         bc_st, s);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, hT, B, T, Din,
                                 N, bc_sb, bc_st, s);
  return int(cudaErrorInvalidValue);
}
