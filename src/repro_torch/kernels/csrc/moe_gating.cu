// MoE top-k softmax gating for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/moe_gating.py::moe_gating_topk (Pallas body
// `_kernel`), the TPU kernel behind ops.moe_gating on every prefill and
// decode step of an MoE layer (models/moe.py moe_forward).
//
// What it computes: for each token row t of fp32 router logits (T, E), the
// softmax over the E experts, its k largest probabilities in descending
// order (ties to the lower expert index, as lax.top_k and the plain version
// ref.topk_gating), renormalised by max(sum, 1e-9): weights (T, k) fp32 and
// ids (T, k) int32.
//
// Design. One warp owns one row; a block of 4 warps owns 4 rows. Lane l
// holds experts l, l + 32, ... (NV = ceil(E / 32) <= 12 values) in
// registers. Max and sum are warp shuffles. Each of the k rounds is a warp
// argmax over (probability, index) that prefers the lower index on equal
// probabilities; the picked expert's register is then set to -inf. The TPU
// kernel subtracts the picked probability instead, which leaves 0.0 in its
// slot: once fewer than k probabilities survive fp32 underflow, a later
// round can pick that slot again and repeat an id. -inf ranks below every
// probability, underflowed zeros included, so ids are always distinct.
// exp and the division are the accurate ones (no fast math), so the
// probabilities are those of torch.softmax up to the order of the sum, and
// the ids match the plain version.
//
// What bounds it here. It reads T*E*4 bytes and writes T*k*8, a few fp32
// operations per logit: memory-bound, about 0.06 us of HBM traffic at
// T = 1024, E = 32, k = 8, so at serving shapes one launch costs more than
// the work. The numbers are in PERF.md.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;     // rows per block
constexpr int MAX_K = 8;     // checked in Python
constexpr int MAX_NV = 12;   // E <= 384, checked in Python

template <int NV>
__global__ void __launch_bounds__(WARPS * 32)
    moe_gating_kernel(const float* __restrict__ logits, float* __restrict__ w,
                      int32_t* __restrict__ ids, int T, int E, int k) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= T) return;   // whole warps leave together: t is per warp
  const float* row = logits + size_t(t) * E;

  float p[NV];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? row[e] : -INFINITY;
    mx = fmaxf(mx, p[j]);
  }
  mx = repro::warp_max(mx, 32);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? expf(p[j] - mx) : 0.f;
    sum += p[j];
  }
  sum = repro::warp_sum(sum, 32);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? p[j] / sum : -INFINITY;   // padding ranks below all
  }

  float my_w = 0.f;   // lane r keeps round r's pick
  int my_id = 0;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r >= k) break;
    // this lane's best: j ascending means index ascending, so a strict >
    // keeps the lower index on ties
    float bv = p[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < NV; ++j) {
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j == bi) p[j] = -INFINITY;
    if (lane == r) {
      my_w = bv;
      my_id = bi;
    }
  }
  const float total = repro::warp_sum(lane < k ? my_w : 0.f, 32);
  if (lane < k) {
    w[size_t(t) * k + lane] = my_w / fmaxf(total, 1e-9f);
    ids[size_t(t) * k + lane] = my_id;
  }
}

template <int NV>
cudaError_t launch(const float* logits, float* w, int32_t* ids, int T, int E,
                   int k, cudaStream_t stream) {
  const int blocks = (T + WARPS - 1) / WARPS;
  moe_gating_kernel<NV><<<blocks, WARPS * 32, 0, stream>>>(logits, w, ids, T,
                                                           E, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_moe_gating(const void* logits, void* w, void* ids, int T,
                                int E, int k, void* stream) {
  if (T < 1 || E < 1 || k < 1 || k > MAX_K || k > E || E > 32 * MAX_NV)
    return int(cudaErrorInvalidValue);
  const float* lg = static_cast<const float*>(logits);
  float* wo = static_cast<float*>(w);
  int32_t* io = static_cast<int32_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((E + 31) / 32) {
    case 1: return launch<1>(lg, wo, io, T, E, k, s);
    case 2: return launch<2>(lg, wo, io, T, E, k, s);
    case 3: return launch<3>(lg, wo, io, T, E, k, s);
    case 4: return launch<4>(lg, wo, io, T, E, k, s);
    case 5: return launch<5>(lg, wo, io, T, E, k, s);
    case 6: return launch<6>(lg, wo, io, T, E, k, s);
    case 7: return launch<7>(lg, wo, io, T, E, k, s);
    case 8: return launch<8>(lg, wo, io, T, E, k, s);
    case 9: return launch<9>(lg, wo, io, T, E, k, s);
    case 10: return launch<10>(lg, wo, io, T, E, k, s);
    case 11: return launch<11>(lg, wo, io, T, E, k, s);
    case 12: return launch<12>(lg, wo, io, T, E, k, s);
  }
  return int(cudaErrorInvalidValue);
}
