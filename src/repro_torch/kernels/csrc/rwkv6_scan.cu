// RWKV-6 ("Finch") WKV recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (Pallas body
// `_kernel`), the TPU kernel behind ops.rwkv6_scan in every RWKV time-mix
// layer (models/ssm.py rwkv_time_mix), at prefill and at decode.
//
// What it computes, for each (batch b, head h), walking t = 0 .. T-1:
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r, k, v (B, T, H, K) in fp32 or bf16, w (B, T, H, K) fp32 decays in
// (0, 1), u (H, K) fp32, S (B, H, K, K) fp32 -> out (B, T, H, K) in v's
// dtype and the final S in fp32. Sums and the state are fp32, and each
// output is the products of ref.rwkv6_sequential summed in order of i.
//
// What bounds it here. The work is ~5 fp32 operations per state element a
// step (2 for the output, 3 for the update) and 4 input values per (b, h)
// and channel: at rwkv6-1.6b's prefill (B = 1, T = 1024, H = 32, K = 64,
// bf16 r/k/v) that is 0.67 G operations, 10 us at the fp32 rate, and 26
// MB, 8 us at the HBM rate. But T is a chain of dependent steps: one block
// per (b, h) walking all T steps puts B * H = 32 blocks on 132 SMs and
// lets one step's latency times T set the time.
//
// Design: chunk-parallel state passing. The recurrence is linear in S, so
// T is cut into n chunks of c steps (rwkv6_scan.py plan_chunks: c = 16, 32
// or 64) and three kernels run:
//   1. chunk states, a block per (b, h, chunk): the walk below from S = 0
//      with no outputs leaves L_i, the state the chunk's own k vᵀ terms
//      give at its end; the same block multiplies the chunk's decays into
//      P_i (K values). Products of w only: no log / exp, so it is exact
//      for every w in (0, 1) (ref.rwkv6_chunked's ±60 clip is not here).
//   2. carry, a thread per state element: S_in[0] = s0, S_in[i+1] =
//      P_i ⊙ S_in[i] + L_i (P_i scales row i), n sequential steps; S_in[i]
//      overwrites L_i in the scratch tensor, the last S goes to sT.
//   3. outputs, a block per (b, h, chunk): the per-step walk from S_in[i]
//      over the chunk's steps, the same arithmetic as the single pass.
// The serial depth falls from T steps to c + n + c, on B * H * n blocks.
// Where T <= c the wrapper's single pass is kernel 3 over one chunk of T
// steps from s0, writing the final state: one launch (decode).
//
// The walk. One block of K threads owns one (b, h, chunk); thread j owns
// column j of S as K fp32 registers. The chunk's rows of r, k, v and w are
// copied TS steps at a time with 16-byte cp.async into a double-buffered
// ring in shared memory (the next tile's copies in flight while this tile
// runs), r, k and v are widened to fp32 once per tile, and the steps run
// with no barrier between them; r_t[i], k_t[i], w_t[i] are broadcast
// reads. Each thread reads its column of the
// state into registers before it writes any of it, and each carry thread
// reads its element of s0 before it writes that of sT (kernels 1 and 3 do
// not read s0), so sT may be s0 at every T (decode's in-place state).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f32;
using repro::to_f32;

constexpr int TS = 16;          // steps staged in shared memory at a time
constexpr int CARRY_NT = 256;   // threads of a carry block
constexpr int CARRY_BATCH = 8;  // chunks whose L, P a carry thread loads ahead

// OUT: outputs from s_in (kernel 3 and the single pass); else the chunk
// state from zero and the decay product (kernel 1). Block bh * n + ci walks
// steps [ci * c, min((ci + 1) * c, T)). s_in / s_out / P are indexed per
// (bh, chunk) with n chunks (n = 1: s0 and sT); s_out may be null.
template <typename T, int K, bool OUT>
__global__ void __launch_bounds__(K)
    walk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* s_in, T* out,
                float* s_out, float* __restrict__ P, int Tlen, int H, int c,
                int n) {
  constexpr int RW = K * sizeof(T) / 16;   // 16-byte pieces of an r/k/v row
  constexpr int WW = K * 4 / 16;           // 16-byte pieces of a w row
  constexpr int EP = 16 / sizeof(T);       // elements in a piece
  __shared__ __align__(16) T raw[2][3][TS][K];   // r, k, v as given
  __shared__ __align__(16) float sw[2][TS][K];
  __shared__ float sr[OUT ? TS : 1][K], sk[TS][K], sv[TS][K], su[K];
  const int bh = blockIdx.x / n, ci = blockIdx.x % n;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const int t0 = ci * c, len = min(c, Tlen - t0);
  const size_t sidx = size_t(blockIdx.x) * K * K;
  const size_t step = size_t(H) * K;   // elements between t and t + 1
  const size_t base = (size_t(b) * Tlen + t0) * step + size_t(h) * K;

  // copy steps [s0, s0 + tt) of the chunk into ring slot q
  auto stage = [&](int q, int s0, int tt) {
    const T* src[3] = {r, k, v};
    for (int a = OUT ? 0 : 1; a < 3; ++a)
      for (int e = j; e < tt * RW; e += K) {
        const int s = e / RW, p = (e % RW) * EP;
        cp_async16(&raw[q][a][s][p], src[a] + base + (s0 + s) * step + p);
      }
    for (int e = j; e < tt * WW; e += K) {
      const int s = e / WW, p = (e % WW) * 4;
      cp_async16(&sw[q][s][p], w + base + (s0 + s) * step + p);
    }
    cp_async_commit();
  };
  const int ntiles = (len + TS - 1) / TS;
  stage(0, 0, min(TS, len));

  float S[K];   // S[i] = state[i][j]
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = OUT ? s_in[sidx + i * K + j] : 0.f;
  if (OUT) su[j] = u[h * K + j];
  float p = 1.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q = it & 1, s0 = it * TS, tt = min(TS, len - s0);
    cp_async_wait<0>();
    __syncthreads();   // tile it is in slot q; the previous tile is done
    if (it + 1 < ntiles) stage(q ^ 1, s0 + TS, min(TS, len - s0 - TS));
    for (int s = 0; s < tt; ++s) {   // to fp32, column j
      if (OUT) sr[s][j] = to_f32(raw[q][0][s][j]);
      sk[s][j] = to_f32(raw[q][1][s][j]);
      sv[s][j] = to_f32(raw[q][2][s][j]);
    }
    __syncthreads();
    for (int s = 0; s < tt; ++s) {
      const float vj = sv[s][j];
      if (!OUT) p *= sw[q][s][j];
      float o = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = sk[s][i] * vj;
        if (OUT) o += sr[s][i] * (S[i] + su[i] * kv);
        S[i] = sw[q][s][i] * S[i] + kv;
      }
      if (OUT) out[base + (s0 + s) * step + j] = from_f32<T>(o);
    }
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int i = 0; i < K; ++i) s_out[sidx + i * K + j] = S[i];
  }
  if (!OUT) P[size_t(blockIdx.x) * K + j] = p;
}

// Kernel 2: thread e owns state element (bh, i, j) = e and walks the n
// chunks: S_in[ci] = S, S = P_ci[i] * S + L_ci, with L_ci read from and
// S_in[ci] written to the same scratch element.
template <int K>
__global__ void __launch_bounds__(CARRY_NT)
    carry_kernel(const float* s0, float* __restrict__ scratch,
                 const float* __restrict__ P, float* sT, int BH, int n) {
  const size_t e = size_t(blockIdx.x) * CARRY_NT + threadIdx.x;
  if (e >= size_t(BH) * K * K) return;
  const size_t bh = e / (K * K);
  const int ij = int(e % (K * K)), i = ij / K;
  float S = s0[e];
  float* Lp = scratch + bh * n * K * K + ij;
  const float* Pp = P + bh * n * K + i;
  for (int c0 = 0; c0 < n; c0 += CARRY_BATCH) {
    float L[CARRY_BATCH], pc[CARRY_BATCH];
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      if (c0 + q < n) {
        L[q] = Lp[size_t(c0 + q) * K * K];
        pc[q] = Pp[size_t(c0 + q) * K];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_BATCH; ++q) {
      if (c0 + q < n) {
        Lp[size_t(c0 + q) * K * K] = S;
        S = pc[q] * S + L[q];
      }
    }
  }
  sT[e] = S;
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* out,
                   void* sT, void* scratch, int B, int Tlen, int H, int c,
                   cudaStream_t stream) {
  const T* rp = static_cast<const T*>(r);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  T* op = static_cast<T*>(out);
  const int BH = B * H;
  if (c >= Tlen) {   // single pass: one chunk of T steps from s0
    walk_kernel<T, K, true><<<BH, K, 0, stream>>>(
        rp, kp, vp, wp, up, static_cast<const float*>(s0), op,
        static_cast<float*>(sT), nullptr, Tlen, H, Tlen, 1);
    return cudaGetLastError();
  }
  const int n = (Tlen + c - 1) / c;
  float* Ls = static_cast<float*>(scratch);              // (B, H, n, K, K)
  float* P = Ls + size_t(BH) * n * K * K;                // (B, H, n, K)
  walk_kernel<T, K, false><<<BH * n, K, 0, stream>>>(
      rp, kp, vp, wp, up, nullptr, nullptr, Ls, P, Tlen, H, c, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = size_t(BH) * K * K;
  carry_kernel<K><<<int((elems + CARRY_NT - 1) / CARRY_NT), CARRY_NT, 0,
                    stream>>>(static_cast<const float*>(s0), Ls, P,
                              static_cast<float*>(sT), BH, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  walk_kernel<T, K, true><<<BH * n, K, 0, stream>>>(
      rp, kp, vp, wp, up, Ls, op, nullptr, nullptr, Tlen, H, c, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* sT, void* scratch, int B, int Tlen, int H, int K,
                     int c, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, sT, scratch, B,
                                  Tlen, H, c, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, sT, scratch, B,
                                  Tlen, H, c, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, sT, scratch, B,
                                  Tlen, H, c, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// chunk >= T: the single pass (scratch unused, may be null); else three
// kernels with scratch of B * H * ceil(T / chunk) * K * (K + 1) floats.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* out, void* sT, void* scratch, int B,
                                int T, int H, int K, int chunk, int dtype,
                                void* stream) {
  if (B < 1 || T < 1 || H < 1 || chunk < 1) return int(cudaErrorInvalidValue);
  if (chunk < T && scratch == nullptr) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_k<float>(r, k, v, w, u, s0, out, sT, scratch, B, T, H, K,
                           chunk, s);
  if (dtype == repro::kBFloat16)
    return launch_k<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, scratch, B, T,
                                   H, K, chunk, s);
  return int(cudaErrorInvalidValue);
}
