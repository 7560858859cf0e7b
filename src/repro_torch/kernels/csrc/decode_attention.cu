// Single-token GQA decode attention for Hopper (sm_90a), split-KV.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// body `_kernel`), the TPU kernel behind ops.decode_attention
// (models/layers.py attention_decode).
//
// What it computes: for each sequence b and query head h, one new token
// attends over its cache k/v[b, :, h // G]. Committed mode: the token's own
// K/V is already written at lengths[b] - 1, the keys are j < lengths[b], the
// optional sliding window is anchored at lengths[b] - 1 (keys j > lengths[b]
// - 1 - window), and lengths[b] == 0 gives zeros. Append mode (the serving
// engine's; k_new and v_new given, (B, KVH, Dh)): the cache is read-only with
// lengths[b] old tokens, the window is anchored at the new token's position
// lengths[b] (keys j > lengths[b] - window), and the new token is one more
// key, always kept, merged in the combine pass; lengths[b] == 0 gives v_new.
// The optional softcap is applied to every score before the mask, sums are
// fp32, and lengths are int32 or int64, read as the engine hands them over.
//
// What bounds it here. Decode attention reads the live cache once and does
// ~2 flops per byte, so the card's bound is memory bandwidth (3.35 TB/s).
// The TPU kernel walks one sequence's kv range in order on one core; on 132
// SMs that is B * KVH blocks (16 at qwen2's B = 8, KVH = 2), and one SM's
// load rate sets the time.
//
// Design (flash-decoding). Pass 1, decode_split_kernel, has the grid
// (n_splits, KVH, B): each block takes one contiguous chunk of the kv range
// of one (b, kv head), a multiple of TILE = 128 rows, and serves all G query
// heads from one read of each K/V row. The wrapper picks n_splits from S, B,
// KVH and the SM count (about four blocks per SM), never from lengths, so the
// host never waits on the device. A chunk at or past lengths[b], or wholly
// before the window, writes an empty partial (m = -1e30, l = 0, o = 0) and
// exits. Inside a block each of the 4 warps owns 32-row sub-tiles, which it
// copies with cp.async (16 bytes a lane, K and V as two groups, rows past
// the chunk zero-filled) into its own shared-memory buffers in their own
// dtype: all of a sub-tile's loads are in flight at once, and the next
// sub-tile's K is copied while this one's softmax and P V run. The G scores
// of a row are warp-shuffle reductions over Dh (Dh / 8 or Dh / 4 lanes a
// row, 16-byte reads) against q held as fp32, one lane per row then runs
// the online softmax of each head with warp reductions, and each lane
// accumulates Dh / 32 output columns of every head. No __syncthreads inside
// the loop: the warps meet once, to merge their (m, l, o) into the block's
// partial. Pass 2,
// decode_combine_kernel, on the same stream, merges the splits of each
// (b, h): each is rescaled by exp(m_s - m), empty ones are skipped through
// the m_safe guard, and the sum is divided by max(l, 1e-30). In append mode
// the combine block first takes the new token as one more partial: m_self =
// softcap(scale * q . k_new) (q scaled first, as in the split pass; a block
// reduction over Dh), l_self = 1, o_self = v_new. So append mode is still two
// launches, with no extra pass and no host sync. The partials are fp32
// scratch that the wrapper allocates. Both dtypes share the design:
// memory-bound decode has no use for tensor cores.
//
// Head dim 112 (kimi-k2). The lane maps above need a power-of-two Dh: a K
// row shared by Dh / 8 (bf16) or Dh / 4 (fp32) lanes under a shuffle
// reduction, Dh / 32 V columns a lane, Dh / 32 warps in the combine pass. So
// Dh 112 is staged at DP = kPaddedDH<112> = 128 columns in shared memory:
// the sub-tiles' columns 112-127 are zero-filled by cp.async (nothing is
// read from global memory for them) and q's padded columns are zero, so the
// scores are those of the 112 real columns and the padded output columns
// are never written. The cache is read at 112 columns a row: the byte bound
// stays that of Dh 112. The combine pass runs DP threads, of which those
// past Dh add nothing and store nothing.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::from_f32;
using repro::kNegInf;
using repro::to_f32;

constexpr int NWARP = 4;
constexpr int NT = 32 * NWARP;     // threads per block
constexpr int SUB = 32;            // kv rows per warp sub-tile
constexpr int TILE = NWARP * SUB;  // kv rows per block step; chunk multiple
constexpr int MAX_G = 16;          // heads per kv head (checked in Python)

// lengths dtype codes (kernels/decode_attention.py LENGTH_CODES)
constexpr int kInt32 = 0;
constexpr int kInt64 = 1;

size_t smem_bytes(int G, int DH, size_t elem) {
  // per warp: K and V sub-tiles (SUB x DH of T; its o (G x DH fp32) after
  // the loop); sQ (G x DH), per warp scores (G x SUB), m, l (G each), fp32
  return size_t(NWARP) * 2 * SUB * DH * elem +
         sizeof(float) * (size_t(G) * DH + size_t(NWARP) * G * (SUB + 2));
}

// One warp copies rows [r0, r0 + SUB) of a (rows, DH) slice into dst (SUB x
// DP, DP = kPaddedDH<DH>); rows at or past r0 + rows, and columns DH to DP,
// are zero-filled, never read.
template <typename T, int DH>
__device__ __forceinline__ void copy_sub(const T* __restrict__ base,
                                         size_t row_stride, int r0, int rows,
                                         T* dst, int lane) {
  constexpr int DP = repro::kPaddedDH<DH>;
  constexpr int N = 16 / sizeof(T);
  constexpr int CPR = DP / N;   // 16-byte chunks per staged row
  static_assert(SUB * CPR % 32 == 0, "copy_sub lane map");
#pragma unroll
  for (int it = 0; it < SUB * CPR / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / CPR, c = (i % CPR) * N;
    // at an unpadded head dim (DP == DH) this is the plain row copy;
    // padded chunks read nothing from a valid address (column 0)
    const bool pad = DP != DH && c >= DH;
    const bool ok = r < rows && !pad;
    cp_async16(dst + r * DP + c,
               base + size_t(ok ? r0 + r : r0) * row_stride + (pad ? 0 : c),
               ok);
  }
}

// C consecutive elements of T widened to fp32 (C * sizeof(T) <= 16 bytes)
template <typename T, int C>
__device__ __forceinline__ void load_cols(const T* src, float* dst) {
  if constexpr (C * sizeof(T) == 16) {
    repro::Chunk<T>::load(src, dst);
  } else if constexpr (sizeof(T) == 4 && C == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else if constexpr (sizeof(T) == 2 && C == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    dst[0] = a.x;
    dst[1] = a.y;
    dst[2] = b.x;
    dst[3] = b.y;
  } else {
    static_assert(sizeof(T) == 2 && C == 2, "unsupported column load");
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    dst[0] = a.x;
    dst[1] = a.y;
  }
}

template <typename T, int DH, typename L>
__global__ void __launch_bounds__(NT)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const L* __restrict__ lengths,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ o_part, int S, int H, int KVH,
                        int chunk, int window, int append, float softcap,
                        float scale) {
  constexpr int DP = repro::kPaddedDH<DH>;   // staged columns
  constexpr int N = repro::Chunk<T>::N;   // elements of one 16-byte load
  constexpr int LPR = DP / N;             // lanes that share a K row
  constexpr int RPW = 32 / LPR;           // K rows a warp reads per step
  constexpr int STEPS = SUB / RPW;
  constexpr int U = 4;                    // steps whose loads are in flight
  constexpr int CPL = DP / 32;            // V columns per lane
  static_assert(STEPS % U == 0, "sub-tile steps");
  const int G = H / KVH;
  const int n_splits = gridDim.x;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sKV = reinterpret_cast<T*>(smem);   // NWARP x (K, V) x SUB x DP
  float* sQ = reinterpret_cast<float*>(sKV + NWARP * 2 * SUB * DP);
  float* sS = sQ + G * DP;               // NWARP x G x SUB
  float* sM = sS + NWARP * G * SUB;      // NWARP x G
  float* sL = sM + NWARP * G;            // NWARP x G

  const long long raw_len = static_cast<long long>(lengths[b]);
  const int len = int(min(max(raw_len, 0LL), static_cast<long long>(S)));
  // first key kept: the window ends at the new token, which sits at len - 1
  // in committed mode and at len (outside the cache) in append mode
  const int lo = window > 0 ? max(0, len - window + append) : 0;
  const int ra = max(split * chunk, lo);
  const int re = min(split * chunk + chunk, len);
  // partial of head g of this block: (b, kvh * G + g, split)
  const size_t part = (size_t(b) * H + size_t(kvh) * G) * n_splits + split;

  if (ra >= re) {   // nothing to attend in this chunk: an empty partial
    for (int i = tid; i < G * DH; i += NT)
      o_part[(part + size_t(i / DH) * n_splits) * DH + i % DH] = 0.f;
    for (int g = tid; g < G; g += NT) {
      m_part[part + size_t(g) * n_splits] = kNegInf;
      l_part[part + size_t(g) * n_splits] = 0.f;
    }
    return;
  }

  const T* qb = q + (size_t(b) * H + size_t(kvh) * G) * DH;
  if constexpr (DP == DH) {
    for (int i = tid; i < G * DH; i += NT) sQ[i] = to_f32(qb[i]) * scale;
  } else {
    for (int i = tid; i < G * DP; i += NT) {   // padded columns zero
      const int g = i / DP, d = i % DP;
      sQ[i] = d < DH ? to_f32(qb[g * DH + d]) * scale : 0.f;
    }
  }
  __syncthreads();

  const size_t row_stride = size_t(KVH) * DH;
  const T* kb = kc + size_t(b) * S * row_stride + size_t(kvh) * DH;
  const T* vb = vc + size_t(b) * S * row_stride + size_t(kvh) * DH;
  float* sSw = sS + warp * G * SUB;
  T* sK = sKV + warp * 2 * SUB * DP;
  T* sV = sK + SUB * DP;
  const int my_row = lane / LPR;          // row of a step this lane reads
  const int my_col = (lane % LPR) * N;    // its first K column

  float m[MAX_G], l[MAX_G], acc[MAX_G][CPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
  }

  int r0 = ra + warp * SUB;
  if (r0 < re) {
    copy_sub<T, DH>(kb, row_stride, r0, min(SUB, re - r0), sK, lane);
    cp_async_commit();
    copy_sub<T, DH>(vb, row_stride, r0, min(SUB, re - r0), sV, lane);
    cp_async_commit();
  }
  for (; r0 < re; r0 += TILE) {
    const int rows = min(SUB, re - r0);
    const int next = r0 + TILE;
    cp_async_wait<1>();   // this sub-tile's K has landed
    __syncwarp();

    // 1. scores of the sub-tile's rows, masked rows -1e30
#pragma unroll 1
    for (int st0 = 0; st0 < STEPS; st0 += U) {
      float x[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        repro::Chunk<T>::load(sK + ((st0 + u) * RPW + my_row) * DP + my_col,
                              x[u]);
      for (int g = 0; g < G; ++g) {
        const float4* qg =
            reinterpret_cast<const float4*>(sQ + g * DP + my_col);
        float qv[N];
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const float4 t = qg[i];
          qv[4 * i] = t.x;
          qv[4 * i + 1] = t.y;
          qv[4 * i + 2] = t.z;
          qv[4 * i + 3] = t.w;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) d += qv[i] * x[u][i];
          d = repro::warp_sum(d, LPR);
          if (softcap > 0.f) d = softcap * tanhf(d / softcap);
          const int rr = (st0 + u) * RPW + my_row;
          if (lane % LPR == 0) sSw[g * SUB + rr] = rr < rows ? d : kNegInf;
        }
      }
    }
    __syncwarp();   // sK is free: copy the next sub-tile's K
    if (next < re) copy_sub<T, DH>(kb, row_stride, next, min(SUB, re - next),
                                   sK, lane);
    cp_async_commit();

    // 2. online softmax per head, one lane per row
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float sv = sSw[g * SUB + lane];
        const float m_new = fmaxf(m[g], repro::warp_max(sv, 32));
        const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
        const float alpha = m[g] <= kNegInf / 2 ? 0.f : expf(m[g] - m_safe);
        const float p = sv <= kNegInf / 2 ? 0.f : expf(sv - m_safe);
        l[g] = l[g] * alpha + repro::warp_sum(p, 32);
        m[g] = m_new;
        sSw[g * SUB + lane] = p;
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] *= alpha;
      }
    }
    cp_async_wait<1>();   // this sub-tile's V has landed
    __syncwarp();

    // 3. o += p v over the sub-tile's rows (zero-filled rows past `rows`
    // have p = 0)
    for (int rr0 = 0; rr0 < rows; rr0 += U) {
      float vv[U][CPL];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_cols<T, CPL>(sV + (rr0 + u) * DP + lane * CPL, vv[u]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float p = sSw[g * SUB + rr0 + u];
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[g][c] += p * vv[u][c];
          }
        }
      }
    }
    __syncwarp();   // sV and sSw are free: copy the next sub-tile's V
    if (next < re) copy_sub<T, DH>(vb, row_stride, next, min(SUB, re - next),
                                   sV, lane);
    cp_async_commit();
  }

  // merge the warps' states into the block's partial; a warp's o goes where
  // its K and V sub-tiles were (G x DP fp32 fits in 2 x SUB x DP of T)
  float* sO = reinterpret_cast<float*>(sK);
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      if (lane == 0) {
        sM[warp * G + g] = m[g];
        sL[warp * G + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        sO[g * DP + lane * CPL + c] = acc[g][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, d = i % DH;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mb = fmaxf(mb, sM[w * G + g]);
    const float m_safe = mb <= kNegInf / 2 ? 0.f : mb;
    float lb = 0.f, ob = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float mw = sM[w * G + g];
      if (mw > kNegInf / 2) {
        const float wt = expf(mw - m_safe);
        lb += wt * sL[w * G + g];
        ob += wt * reinterpret_cast<const float*>(
                       sKV + w * 2 * SUB * DP)[g * DP + d];
      }
    }
    const size_t pg = part + size_t(g) * n_splits;
    o_part[pg * DH + d] = ob;
    if (d == 0) {
      m_part[pg] = mb;
      l_part[pg] = lb;
    }
  }
}

// One block of DP = kPaddedDH<DH> threads per (b, h): merges the n_splits
// partials and, in append mode (k_new non-null), the new token as one more
// partial. Threads d >= DH (Dh 112) add zeros to the dot and store nothing.
template <typename T, int DH>
__global__ void __launch_bounds__(repro::kPaddedDH<DH>)
    decode_combine_kernel(const float* __restrict__ m_part,
                          const float* __restrict__ l_part,
                          const float* __restrict__ o_part,
                          const T* __restrict__ q, const T* __restrict__ k_new,
                          const T* __restrict__ v_new, T* __restrict__ o,
                          int n_splits, int H, int KVH, float softcap,
                          float scale) {
  constexpr int DP = repro::kPaddedDH<DH>;
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const bool col = DP == DH || d < DH;   // a real output column
  const float* mp = m_part + bh * n_splits;
  const float* lp = l_part + bh * n_splits;
  const float* op = o_part + bh * n_splits * DH;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, mp[s]);
  float m_self = kNegInf, v_self = 0.f;
  if (k_new != nullptr) {   // uniform over the block
    __shared__ float red[DP / 32];
    const size_t b = bh / H;
    const int h = int(bh % H);
    const size_t kv = (b * KVH + h / (H / KVH)) * DH;
    float x = col ? to_f32(q[bh * DH + d]) * scale * to_f32(k_new[kv + d])
                  : 0.f;
    x = repro::warp_sum(x, 32);
    if (d % 32 == 0) red[d / 32] = x;
    __syncthreads();
    float dot = 0.f;
#pragma unroll
    for (int w = 0; w < DP / 32; ++w) dot += red[w];
    if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
    m_self = dot;
    v_self = col ? to_f32(v_new[kv + d]) : 0.f;
    mx = fmaxf(mx, m_self);
  }
  const float m_safe = mx <= kNegInf / 2 ? 0.f : mx;
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    if (mp[s] > kNegInf / 2) {   // empty splits add nothing
      const float wt = expf(mp[s] - m_safe);
      l += wt * lp[s];
      if (col) acc += wt * op[size_t(s) * DH + d];
    }
  }
  if (k_new != nullptr) {
    const float wt = expf(m_self - m_safe);
    l += wt;
    acc += wt * v_self;
  }
  if (col) o[bh * DH + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int DH, typename L>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, const void* k_new, const void* v_new,
                   void* o, float* partials, int B, int S, int H, int KVH,
                   int n_splits, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const int G = H / KVH;
  if (G < 1 || G > MAX_G || n_splits < 1) return cudaErrorInvalidValue;
  auto split_kern = decode_split_kernel<T, DH, L>;
  cudaError_t err = cudaFuncSetAttribute(
      split_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes(MAX_G, repro::kPaddedDH<DH>, sizeof(T))));
  if (err != cudaSuccess) return err;
  // chunk: ceil(S / n_splits) rounded up to TILE (ref.split_chunk)
  const int chunk = ((S + n_splits - 1) / n_splits + TILE - 1) / TILE * TILE;
  const size_t n_part = size_t(B) * H * n_splits;
  float* m_part = partials;
  float* l_part = m_part + n_part;
  float* o_part = l_part + n_part;
  dim3 grid(n_splits, KVH, B);
  split_kern<<<grid, NT, smem_bytes(G, repro::kPaddedDH<DH>, sizeof(T)),
               stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const L*>(lengths), m_part,
      l_part, o_part, S, H, KVH, chunk, window, k_new != nullptr ? 1 : 0,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, DH><<<B * H, repro::kPaddedDH<DH>, 0, stream>>>(
      m_part, l_part, o_part, static_cast<const T*>(q),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(o), n_splits, H, KVH, softcap, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_len(int len_dtype, const void* q, const void* kc,
                       const void* vc, const void* lengths, const void* k_new,
                       const void* v_new, void* o, float* partials, int B,
                       int S, int H, int KVH, int n_splits, int window,
                       float softcap, float scale, cudaStream_t stream) {
  if (len_dtype == kInt32)
    return launch<T, DH, int32_t>(q, kc, vc, lengths, k_new, v_new, o,
                                  partials, B, S, H, KVH, n_splits, window,
                                  softcap, scale, stream);
  if (len_dtype == kInt64)
    return launch<T, DH, int64_t>(q, kc, vc, lengths, k_new, v_new, o,
                                  partials, B, S, H, KVH, n_splits, window,
                                  softcap, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// k_new / v_new: null in committed mode, (B, KVH, Dh) in append mode
extern "C" int repro_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* o,
                                      void* partials, int B, int S, int H,
                                      int KVH, int Dh, int dtype,
                                      int len_dtype, int n_splits, int window,
                                      float softcap, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if ((k_new == nullptr) != (v_new == nullptr))
    return int(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32 && Dh == 64)
    return launch_len<float, 64>(len_dtype, q, k_cache, v_cache, lengths,
                                 k_new, v_new, o, part, B, S, H, KVH,
                                 n_splits, window, softcap, scale, s);
  if (dtype == repro::kFloat32 && Dh == 112)
    return launch_len<float, 112>(len_dtype, q, k_cache, v_cache, lengths,
                                  k_new, v_new, o, part, B, S, H, KVH,
                                  n_splits, window, softcap, scale, s);
  if (dtype == repro::kFloat32 && Dh == 128)
    return launch_len<float, 128>(len_dtype, q, k_cache, v_cache, lengths,
                                  k_new, v_new, o, part, B, S, H, KVH,
                                  n_splits, window, softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 64)
    return launch_len<__nv_bfloat16, 64>(len_dtype, q, k_cache, v_cache,
                                         lengths, k_new, v_new, o, part, B, S,
                                         H, KVH, n_splits, window, softcap,
                                         scale, s);
  if (dtype == repro::kBFloat16 && Dh == 112)
    return launch_len<__nv_bfloat16, 112>(len_dtype, q, k_cache, v_cache,
                                          lengths, k_new, v_new, o, part, B,
                                          S, H, KVH, n_splits, window,
                                          softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 128)
    return launch_len<__nv_bfloat16, 128>(len_dtype, q, k_cache, v_cache,
                                          lengths, k_new, v_new, o, part, B,
                                          S, H, KVH, n_splits, window,
                                          softcap, scale, s);
  return int(cudaErrorInvalidValue);
}
