// Single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`), the TPU kernel behind ops.decode_attention on the
// committed decode path (models/layers.py attention_decode).
//
// What it computes: for each sequence b and query head h, one new token
// attends over its cache k/v[b, :lengths[b], h // G] (the token's own K/V is
// already written at lengths[b] - 1). The optional sliding window is anchored
// at lengths[b] - 1 (keys j > lengths[b] - 1 - window), the optional softcap
// is applied before the mask, sums are fp32, and lengths[b] == 0 gives zeros.
//
// Design. One block of 128 threads owns one (batch, kv head) and serves all
// G = H / KVH query heads that share it, so each K/V row is read from device
// memory once per step, not G times. The block walks 64-row kv tiles from
// the first tile the window reaches to lengths[b]; tiles at or past
// lengths[b] are never read. Per tile: K and V are staged in shared memory
// as fp32, a G x 64 score tile is computed, one warp per head updates that
// head's running (max, sum), and each thread rescales and accumulates its
// output columns for every head it owns.
//
// What bounds it here. Decode attention reads the live cache once and does
// ~2 flops per byte, so the card's bound is memory bandwidth (3.35 TB/s).
// This grid has only B * KVH blocks (16 at qwen2's B = 8, KVH = 2, on 132
// SMs), so one SM's load rate, not the card's, sets the time: the numbers
// are in PERF.md. Splitting each sequence's kv range across blocks
// (split-KV with a combine pass) is the later fix.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;

constexpr int BK = 64;       // kv rows per tile
constexpr int NT = 128;      // threads per block
constexpr int MAX_G = 16;    // query heads per kv head (checked in Python)

template <int DH>
constexpr size_t smem_bytes(int G) {
  // sK (BK x DH+1) + sV (BK x DH) + sQ (G x DH) + sS (G x BK) + m, l, alpha
  return sizeof(float) * (size_t(BK) * (DH + 1) + size_t(BK) * DH +
                          size_t(G) * DH + size_t(G) * BK + 3 * size_t(G));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const int32_t* __restrict__ lengths,
                  T* __restrict__ o, int S, int H, int KVH, int window,
                  float softcap, float scale) {
  constexpr int LD = DH + 1;
  constexpr int GSTEP = NT / DH;   // heads that share one output column
  constexpr int HPT = (MAX_G + GSTEP - 1) / GSTEP;   // heads per thread
  const int G = H / KVH;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * DH;
  float* sS = sQ + G * DH;
  float* sM = sS + G * BK;
  float* sL = sM + G;
  float* sA = sL + G;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int len = min(max(lengths[b], 0), S);
  const int lo = window > 0 ? max(0, len - window) : 0;   // first key kept

  const size_t row_stride = size_t(KVH) * DH;
  const T* kb = kc + size_t(b) * S * row_stride + size_t(kvh) * DH;
  const T* vb = vc + size_t(b) * S * row_stride + size_t(kvh) * DH;
  const T* qb = q + (size_t(b) * H + size_t(kvh) * G) * DH;

  repro::stage_rows<T, DH, NT>(qb, DH, 0, G, G, sQ, DH, scale, tid);
  for (int g = tid; g < G; g += NT) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  const int d = tid % DH;
  const int g0 = tid / DH;
  float acc[HPT];
#pragma unroll
  for (int j = 0; j < HPT; ++j) acc[j] = 0.f;
  __syncthreads();

  for (int k0 = (lo / BK) * BK; k0 < len; k0 += BK) {
    repro::stage_rows<T, DH, NT>(kb, row_stride, k0, BK, len, sK, LD, 1.f, tid);
    repro::stage_rows<T, DH, NT>(vb, row_stride, k0, BK, len, sV, DH, 1.f, tid);
    __syncthreads();

    for (int i = tid; i < G * BK; i += NT) {
      const int g = i / BK, kk = i % BK;
      const float* qrow = sQ + g * DH;
      const float* krow = sK + kk * LD;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < DH; ++c) s += qrow[c] * krow[c];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sS[i] = s;
    }
    __syncthreads();

    // one warp per head: mask, running max / sum, probabilities in place
    for (int g = warp; g < G; g += NT / 32) {
      float p[BK / 32];
      bool keep[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        const int kpos = k0 + lane + 32 * t;
        keep[t] = kpos < len && kpos >= lo;
        p[t] = keep[t] ? sS[g * BK + lane + 32 * t] : kNegInf;
        mx = fmaxf(mx, p[t]);
      }
      mx = repro::warp_max(mx, 32);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float alpha = m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BK / 32; ++t) {
        p[t] = keep[t] ? expf(p[t] - m_safe) : 0.f;
        sum += p[t];
        sS[g * BK + lane + 32 * t] = p[t];
      }
      sum = repro::warp_sum(sum, 32);
      if (lane == 0) {
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
        sA[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      const int g = g0 + j * GSTEP;
      if (g < G) {
        const float* prow = sS + g * BK;
        float a = acc[j] * sA[g];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a += prow[kk] * sV[kk * DH + d];
        acc[j] = a;
      }
    }
    __syncthreads();   // sK / sV / sS are rewritten by the next tile
  }

  T* ob = o + (size_t(b) * H + size_t(kvh) * G) * DH;
#pragma unroll
  for (int j = 0; j < HPT; ++j) {
    const int g = g0 + j * GSTEP;
    if (g < G) ob[g * DH + d] = from_f32<T>(acc[j] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, void* o, int B, int S, int H, int KVH,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  auto kern = decode_kernel<T, DH>;
  const int G = H / KVH;
  if (G < 1 || G > MAX_G) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes<DH>(MAX_G)));
  if (err != cudaSuccess) return err;
  dim3 grid(KVH, B);
  kern<<<grid, NT, smem_bytes<DH>(G), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int32_t*>(lengths),
      static_cast<T*>(o), S, H, KVH, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* lengths, void* o, int B,
                                      int S, int H, int KVH, int Dh,
                                      int dtype, int window, float softcap,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && Dh == 64)
    return launch<float, 64>(q, k_cache, v_cache, lengths, o, B, S, H, KVH,
                             window, softcap, scale, s);
  if (dtype == repro::kFloat32 && Dh == 128)
    return launch<float, 128>(q, k_cache, v_cache, lengths, o, B, S, H, KVH,
                              window, softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, lengths, o, B, S,
                                     H, KVH, window, softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, lengths, o, B, S,
                                      H, KVH, window, softcap, scale, s);
  return int(cudaErrorInvalidValue);
}
