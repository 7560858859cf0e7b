// Causal GQA prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas
// body `_kernel`), the TPU kernel behind ops.flash_attention on the prefill
// path (models/layers.py attention_forward).
//
// What it computes: out[b, i, h] = softmax_j(cap(q_i . k_j * Dh^-0.5)) v_j over
// the keys j that the causal mask (j <= i) and the optional sliding window
// (j > i - window) allow, with k/v read from kv head h // (H / KVH). The
// softcap is applied before the mask, scores and sums are fp32, and a fully
// masked row gives zeros (the reference's m_safe guard and l >= 1e-30).
//
// Design. One block of 256 threads owns one (batch, query head, 64-row query
// tile); four threads share a query row. The block loops over 64-row kv
// tiles staged in shared memory as fp32, with an fp32 online softmax kept in
// registers (running max and sum per row, 32 or 16 output columns per
// thread). Tiles wholly above the diagonal or wholly before the window are
// never loaded. Unlike the TPU kernel it takes any Sq and Skv: rows and
// columns past the edge are masked, so the engine's power-of-two padding
// (>= 8) and ragged tails both work.
//
// What bounds it here. The prefill's causal attention is compute-bound on
// paper (~2*Dh flops per byte of k/v at Sq = Skv = 1024), so the card's bound
// is the tensor-core rate. This first kernel does its products with fp32
// FMAs out of shared memory (no mma/wgmma), so it is bound by shared-memory
// bandwidth and the fp32 pipe, far from that bound: the numbers are in
// PERF.md. The padded row stride (Dh + 1) keeps the score loop free of bank
// conflicts; wgmma with TMA-fed tiles is the later step.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::kNegInf;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int TPR = 4;          // threads per query row
constexpr int NT = BQ * TPR;    // threads per block
constexpr int SPT = BK / TPR;   // scores per thread per tile

template <int DH>
constexpr size_t smem_bytes() {
  // sQ (BQ x DH+1) + sK (BK x DH+1) + sV (BK x DH) + sP (BQ x BK+1), fp32
  return sizeof(float) *
         (size_t(BQ) * (DH + 1) + size_t(BK) * (DH + 1) + size_t(BK) * DH +
          size_t(BQ) * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int H, int KVH, int causal, int window,
                     float softcap, float scale) {
  constexpr int LD = DH + 1;
  constexpr int CPT = DH / TPR;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * DH;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int qpos = q0 + row;

  const size_t q_stride = size_t(H) * DH;     // between sequence positions
  const size_t kv_stride = size_t(KVH) * DH;
  const T* qb = q + size_t(b) * Sq * q_stride + size_t(h) * DH;
  const T* kb = k + size_t(b) * Skv * kv_stride + size_t(kvh) * DH;
  const T* vb = v + size_t(b) * Skv * kv_stride + size_t(kvh) * DH;

  repro::stage_rows<T, DH, NT>(qb, q_stride, q0, BQ, Sq, sQ, LD, scale, tid);

  // kv range this tile can see: [kv_lo, kv_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m_run = kNegInf, l_run = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  __syncthreads();
  for (int k0 = (kv_lo / BK) * BK; k0 < kv_hi; k0 += BK) {
    repro::stage_rows<T, DH, NT>(kb, kv_stride, k0, BK, Skv, sK, LD, 1.f, tid);
    repro::stage_rows<T, DH, NT>(vb, kv_stride, k0, BK, Skv, sV, DH, 1.f, tid);
    __syncthreads();

    // scores of (row, k0 + part + TPR * j)
    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.f;
    const float* qrow = sQ + row * LD;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[j] += qd * sK[(part + TPR * j) * LD + d];
    }

    unsigned ok = 0;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kpos = k0 + part + TPR * j;
      float x = s[j];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const bool keep = kpos < Skv && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
      s[j] = keep ? x : kNegInf;
      ok |= unsigned(keep) << j;
      mx = fmaxf(mx, s[j]);
    }
    mx = repro::warp_max(mx, TPR);
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
    const float alpha = m_run <= kNegInf / 2 ? 0.f : expf(m_run - m_safe);
    float lsum = 0.f;
    float* prow = sP + row * (BK + 1);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = (ok >> j) & 1u ? expf(s[j] - m_safe) : 0.f;
      lsum += p;
      prow[part + TPR * j] = p;
    }
    lsum = repro::warp_sum(lsum, TPR);
    l_run = l_run * alpha + lsum;
    m_run = m_new;
    __syncwarp();   // the four threads of a row are lanes of one warp

#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = sV + kk * DH + part;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] += p * vrow[TPR * c];
    }
    __syncthreads();   // sK / sV / sP are rewritten by the next tile
  }

  if (qpos < Sq) {
    const float l_safe = fmaxf(l_run, 1e-30f);
    T* orow = o + (size_t(b) * Sq + qpos) * q_stride + size_t(h) * DH + part;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[TPR * c] = from_f32<T>(acc[c] / l_safe);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KVH, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DH>;
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KVH, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int H, int KVH, int Dh,
                                     int dtype, int causal, int window,
                                     float softcap, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && Dh == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                             softcap, scale, s);
  if (dtype == repro::kFloat32 && Dh == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                              softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Skv, H, KVH, causal,
                                     window, softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Skv, H, KVH, causal,
                                      window, softcap, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
