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
// dtype and the final S in fp32. Sums and the state are fp32, and the
// products are those of ref.rwkv6_sequential, summed in order of i.
//
// Design: the official RWKV CUDA structure that the TPU kernel's docstring
// names. One block of K threads owns one (b, h); thread j owns column j of
// S as K fp32 registers. At each t the K values of r_t, k_t and w_t pass
// through shared memory (each thread loads one of each, coalesced), thread
// j reads v_t[j] itself, and the next step's four values are loaded into
// registers before this step's arithmetic, so their latency overlaps it.
//
// What bounds it here. The work is ~5 fp32 operations per state element a
// step (2 for the output, 3 for the update) and 4 input values per (b, h)
// and channel: at rwkv6-1.6b's prefill (B = 1, T = 1024, H = 32, K = 64,
// bf16 r/k/v) that is 0.67 G operations, 10 us at the fp32 rate, and 26
// MB, 8 us at the HBM rate. But T is a chain of dependent steps and the
// grid has B * H = 32 blocks of 64 threads on 132 SMs, so one step's
// latency times T, not the card, sets the time. The chunked tensor-core
// form (ref.rwkv6_chunked is its oracle) is the later fix; the numbers are
// in PERF.md.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

template <typename T, int K>
__global__ void __launch_bounds__(K)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ out, float* __restrict__ sT, int Tlen,
                 int H) {
  __shared__ float sr[K], sk[K], sw[K], su[K];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[K];   // S[i] = state[b, h, i, j]
  const float* s0p = s0 + size_t(bh) * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) S[i] = s0p[i * K + j];
  su[j] = u[h * K + j];

  const size_t step = size_t(H) * K;   // elements between t and t + 1
  size_t off = size_t(b) * Tlen * step + size_t(h) * K + j;
  float nr = 0.f, nk = 0.f, nw = 0.f, nv = 0.f;
  if (Tlen > 0) {
    nr = to_f32(r[off]);
    nk = to_f32(k[off]);
    nw = w[off];
    nv = to_f32(v[off]);
  }
  for (int t = 0; t < Tlen; ++t, off += step) {
    __syncthreads();   // every thread is done with the previous step's sr/sk/sw
    sr[j] = nr;
    sk[j] = nk;
    sw[j] = nw;
    const float vj = nv;
    __syncthreads();
    if (t + 1 < Tlen) {
      nr = to_f32(r[off + step]);
      nk = to_f32(k[off + step]);
      nw = w[off + step];
      nv = to_f32(v[off + step]);
    }
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float kv = sk[i] * vj;
      o += sr[i] * (S[i] + su[i] * kv);
      S[i] = sw[i] * S[i] + kv;
    }
    out[off] = from_f32<T>(o);
  }
  float* sTp = sT + size_t(bh) * K * K;
#pragma unroll
  for (int i = 0; i < K; ++i) sTp[i * K + j] = S[i];
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* out,
                   void* sT, int B, int Tlen, int H, cudaStream_t stream) {
  rwkv6_kernel<T, K><<<B * H, K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sT), Tlen, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* out,
                     void* sT, int B, int Tlen, int H, int K,
                     cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, sT, B, Tlen, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, sT, B, Tlen, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, sT, B, Tlen, H, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0,
                                void* out, void* sT, int B, int T, int H,
                                int K, int dtype, void* stream) {
  if (B < 1 || T < 1 || H < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_k<float>(r, k, v, w, u, s0, out, sT, B, T, H, K, s);
  if (dtype == repro::kBFloat16)
    return launch_k<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, B, T, H, K, s);
  return int(cudaErrorInvalidValue);
}
