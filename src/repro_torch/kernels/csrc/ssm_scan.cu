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
// What bounds it here. A step costs ~7 fp32 operations per state element
// (an exp counted as one): at Jamba's prefill (B = 1, T = 1024,
// Din = 16384, N = 16) that is 1.9 G operations, 28 us at the fp32 rate,
// and 136 MB moved (bf16 x and y, fp32 dt), 41 us at the HBM rate. Its
// B * T * Din * N = 268 M accurate exponentials each take one result of
// the special-function unit, 16 a clock per SM: ~65-70 us at Hopper's
// clocks, above both. The T steps are a dependent chain per (channel,
// state), so what the design has to buy is (channel, state) pairs in
// flight, not bandwidth.
//
// Design. The N states of a channel are spread over G lanes of a warp, R
// consecutive states per lane (R * G = N rounded up to a power of two,
// <= 16, R = min(4, that)). R = 4 beat one and two states per lane at
// prefill and decode (PERF.md): more channels per warp and fewer shuffles
// outweigh the longer per-lane chain. A step's only
// dependent chain is h = a * h + b per state: a = expf(dt * A[d][n]) and b
// = dt * x * B_t[n] do not depend on h, and the step loop is unrolled so
// that later steps' exponentials and loads overlap. The output is each
// lane's sum over its R states, then a log2(G)-level xor-shuffle sum; the
// group's first lane adds D[d] * x_t[d] and writes it into a shared-memory
// tile that the block stores coalesced along Din. Lanes past N hold zeros
// (A = B = C = 0) and add nothing; channels past Din compute on zeros and
// store nothing.
// Staging: a block of NT threads owns CH = NT / G channels of one sequence
// and walks T in tiles of TT steps (32 in bf16). x and dt for its channels
// (16-byte pieces) and the Bm / Cm rows (4-byte words; shared by every
// channel of the sequence) of the next tile are copied with cp.async into
// the other half of a double-buffered ring while this tile runs, so global
// loads leave the per-step path; Bm / Cm are widened to fp32 once per tile.
// Bm and Cm may be views with a row stride (the model slices them out of
// one projection), so their batch and time strides are arguments. Each
// lane reads its states of h0 into registers before it writes any of hT,
// so hT may be h0 (decode's in-place state).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f32;
using repro::to_f32;

constexpr int NT = 256;        // threads per block
constexpr int MAX_N = 16;      // state size (checked in Python)
constexpr int TILE = 2048;     // steps x channels staged per tile, at most

template <typename T, int R, int G>
struct Cfg {
  static constexpr int NP = R * G;         // states per channel, padded
  static constexpr int CH = NT / G;        // channels per block
  static constexpr int TT0 = sizeof(T) == 2 ? 32 : 16;   // smem <= 48 KB
  static constexpr int TT = TILE / CH < TT0 ? TILE / CH : TT0;
  static constexpr int E = 4 / sizeof(T);  // elements per 4-byte copy
  static constexpr int XP = 16 / sizeof(T);   // elements per 16-byte copy
};

// Copy tile steps [t0, t0 + tt) of x, dt (channels d0 .. d0 + CH, 16-byte
// pieces) and the Bm / Cm rows (4-byte words) into ring slot q; pieces past
// Din or N are zero-filled.
template <typename T, int R, int G>
__device__ __forceinline__ void stage(
    T (*sx)[Cfg<T, R, G>::CH], float (*sdt)[Cfg<T, R, G>::CH],
    T (*sB)[Cfg<T, R, G>::NP], T (*sC)[Cfg<T, R, G>::NP],
    const T* __restrict__ x, const float* __restrict__ dt, const T* Bb,
    const T* Cb, size_t row0, int t0, int tt, int d0, int Din, int N,
    long long bc_st) {
  using C = Cfg<T, R, G>;
  constexpr int XW = C::CH / C::XP;   // 16-byte pieces of x per step
  for (int i = threadIdx.x; i < tt * XW; i += NT) {
    const int s = i / XW, c = (i % XW) * C::XP;
    const bool ok = d0 + c < Din;
    cp_async16(&sx[s][c], x + (ok ? row0 + size_t(t0 + s) * Din + d0 + c : 0),
               ok);
  }
  constexpr int DW = C::CH / 4;       // 16-byte pieces of dt per step
  for (int i = threadIdx.x; i < tt * DW; i += NT) {
    const int s = i / DW, c = (i % DW) * 4;
    const bool ok = d0 + c < Din;
    cp_async16(&sdt[s][c],
               dt + (ok ? row0 + size_t(t0 + s) * Din + d0 + c : 0), ok);
  }
  constexpr int BW = C::NP / C::E;    // 4-byte words of a Bm / Cm row
  for (int i = threadIdx.x; i < tt * BW; i += NT) {
    const int s = i / BW, n = (i % BW) * C::E;
    const bool ok = n < N;
    const long long o = ok ? (t0 + s) * bc_st + n : 0;
    cp_async4(&sB[s][n], Bb + o, ok);
    cp_async4(&sC[s][n], Cb + o, ok);
  }
  cp_async_commit();
}

template <typename T, int R, int G>
__global__ void __launch_bounds__(NT)
    ssm_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const float* h0, T* __restrict__ y, float* hT, int Tlen,
               int Din, int N, long long bc_sb, long long bc_st) {
  using C = Cfg<T, R, G>;
  __shared__ __align__(16) T sx[2][C::TT][C::CH];
  __shared__ __align__(16) float sdt[2][C::TT][C::CH];
  __shared__ __align__(16) T sB[2][C::TT][C::NP];
  __shared__ __align__(16) T sC[2][C::TT][C::NP];
  __shared__ __align__(16) float fB[C::TT][C::NP], fC[C::TT][C::NP];
  __shared__ float sy[C::TT][C::CH];   // the tile's outputs
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C::CH;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int d = d0 + c;
  const bool on = d < Din;

  const size_t row0 = size_t(b) * Tlen * Din;   // x[b, t, d] = row0 + t*Din + d
  const T* Bb = Bm + b * bc_sb;
  const T* Cb = Cm + b * bc_sb;
  const int ntiles = (Tlen + C::TT - 1) / C::TT;
  stage<T, R, G>(sx[0], sdt[0], sB[0], sC[0], x, dt, Bb, Cb, row0, 0,
                 min(C::TT, Tlen), d0, Din, N, bc_st);

  float h[R], a[R];
  const size_t hrow = (size_t(b) * Din + d) * N;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int n = g * R + q;
    h[q] = (on && n < N) ? h0[hrow + n] : 0.f;
    a[q] = (on && n < N) ? A[size_t(d) * N + n] : 0.f;
  }
  const float Dd = on ? D[d] : 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q = it & 1, t0 = it * C::TT;
    const int tt = min(C::TT, Tlen - t0);
    cp_async_wait<0>();
    __syncthreads();   // tile it is in slot q; the previous tile is done
    if (it + 1 < ntiles) {
      const int t1 = t0 + C::TT;
      stage<T, R, G>(sx[q ^ 1], sdt[q ^ 1], sB[q ^ 1], sC[q ^ 1], x, dt, Bb,
                     Cb, row0, t1, min(C::TT, Tlen - t1), d0, Din, N, bc_st);
    }
    for (int i = threadIdx.x; i < tt * C::NP; i += NT) {   // B, C to fp32
      const int s = i / C::NP, n = i % C::NP;
      fB[s][n] = to_f32(sB[q][s][n]);
      fC[s][n] = to_f32(sC[q][s][n]);
    }
    __syncthreads();
    // The tile's steps are unrolled with the per-step sums in registers:
    // no shared-memory store sits between one step's loads and the next,
    // so the compiler can issue later steps' loads and exponentials early.
#pragma unroll 4
    for (int s = 0; s < tt; ++s) {
      const float xt = to_f32(sx[q][s][c]);
      const float dtt = sdt[q][s][c];
      const float bx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = g * R + r;
        h[r] = expf(dtt * a[r]) * h[r] + bx * fB[s][n];
        acc += h[r] * fC[s][n];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) sy[s][c] = acc + Dd * xt;
    }
    __syncthreads();   // sy is complete
    for (int i = threadIdx.x; i < tt * C::CH; i += NT) {
      const int s = i / C::CH, cc = i % C::CH;
      if (d0 + cc < Din)
        y[row0 + size_t(t0 + s) * Din + d0 + cc] = from_f32<T>(sy[s][cc]);
    }
  }
  if (on) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int n = g * R + q;
      if (n < N) hT[hrow + n] = h[q];
    }
  }
}

template <typename T, int R, int G>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* hT, int B, int Tlen,
                   int Din, int N, long long bc_sb, long long bc_st,
                   cudaStream_t stream) {
  constexpr int CH = Cfg<T, R, G>::CH;
  dim3 grid((Din + CH - 1) / CH, B);
  ssm_kernel<T, R, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hT), Tlen, Din, N, bc_sb, bc_st);
  return cudaGetLastError();
}

// R = min(4, NP) states per lane, G = NP / R lanes per channel, NP = N
// rounded up to a power of two.
template <typename T>
cudaError_t launch_rg(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* D,
                      const void* h0, void* y, void* hT, int B, int Tlen,
                      int Din, int N, long long bc_sb, long long bc_st,
                      cudaStream_t s) {
  int np = 1;
  while (np < N) np *= 2;
#define REPRO_SSM_CASE(np_, r, g)                                            \
  if (np == np_)                                                            \
    return launch<T, r, g>(x, dt, A, Bm, Cm, D, h0, y, hT, B, Tlen, Din, N, \
                           bc_sb, bc_st, s);
  REPRO_SSM_CASE(1, 1, 1) REPRO_SSM_CASE(2, 2, 1) REPRO_SSM_CASE(4, 4, 1)
  REPRO_SSM_CASE(8, 4, 2) REPRO_SSM_CASE(16, 4, 4)
#undef REPRO_SSM_CASE
  return cudaErrorInvalidValue;
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
    return launch_rg<float>(x, dt, A, Bm, Cm, D, h0, y, hT, B, T, Din, N,
                            bc_sb, bc_st, s);
  if (dtype == repro::kBFloat16)
    return launch_rg<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, hT, B, T, Din,
                                    N, bc_sb, bc_st, s);
  return int(cudaErrorInvalidValue);
}
