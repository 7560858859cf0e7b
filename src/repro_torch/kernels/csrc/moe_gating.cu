// MoE routing for Hopper (sm_90a): top-k softmax gating, the GShard
// dispatch maps and the aux losses of one MoE layer call, in one launch.
//
// Replaces: src/repro/kernels/moe_gating.py::moe_gating_topk (Pallas body
// `_kernel`), the TPU kernel behind the MoE layer's gating on every
// prefill and decode step (models/moe.py moe_forward), together with what
// the layer computes from its output before the dispatch gather: the aux
// losses (kernels/ref.py gating_aux) and the index maps (ref.py
// dispatch_indices, the reference's models/moe.py build_dispatch_indices).
//
// What it computes, for fp32 router logits (T, E) cut into `groups` blocks
// of Tg = T / groups tokens:
//   * per token, the softmax over E experts, its k largest probabilities in
//     descending order (ties to the lower expert index, as lax.top_k and
//     ref.topk_gating), renormalised by max(sum, 1e-9): w (T, k) fp32 and
//     ids (T, k) int32;
//   * with maps, per block: an entry's position is its rank among the
//     block's entries t*k+j routed to the same expert, in flat order;
//     slot_of = e*cap + pos, or E*cap when pos >= cap (dropped);
//     token_of_slot / tk_of_slot (E*cap + 1) give each kept slot's token
//     and flat index, and Tg / Tg*k for empty slots and the sentinel E*cap;
//   * lb_loss = E * sum_e (count_e / T) * mean_t p[t, e] and
//     z_loss = mean_t lse_t^2 over all T.
//
// Design. A block of tokens is one thread-block cluster of R <= 8 CTAs of
// 32 warps (the portable cluster size; R from the shapes in moe_gating.py
// plan_route). Each CTA takes a contiguous range of whole tokens, so its
// flat entries are contiguous too.
//   1. Gating: one warp per token row, lane l holding experts l, l + 32, ...
//      in registers, the warp's next row loaded while this one computes;
//      max and sum are warp shuffles, exp and the division the accurate
//      ones. Each of the k rounds takes the warp's largest
//      (probability, lowest index) with two redux instructions: the max of
//      the probabilities' bit patterns (non-negative floats order as their
//      bits; a picked or padding expert is -inf, key 0, below an
//      underflowed 0.0, so ids are always distinct), then the min index
//      among the lanes holding it. The row's probabilities and lse^2 add
//      into per-lane sums for the aux.
//   2. Positions: each warp walks its part of the CTA's entries in 32-entry
//      steps; __match_any_sync groups the lanes of one expert, a popcount
//      of the lower lanes ranks each in the step, and per-warp counts in
//      shared memory carry the rank across steps. An exclusive scan of the
//      warps' counts orders the warps.
//   3. cluster.sync(); each CTA reads the lower-ranked CTAs' counts through
//      distributed shared memory for its offsets, and all of them for the
//      block's totals. Kept entries write their slot; the CTAs split
//      [0, E*cap] into contiguous ranges and each writes the empty slots of
//      its range, so every element is written exactly once and the outputs
//      need no fill.
//   4. Aux: after a second cluster barrier (which also keeps every CTA's
//      shared memory alive while others read it), CTA rank 0 holds the
//      block's sums, added over DSMEM in rank order, and writes the losses.
//      With several blocks each writes its sums, and the last block to
//      finish (a ticket in device memory that it resets, so no memset is
//      launched) adds them in block order 0..groups-1. Every sum has a
//      fixed order: the results do not change from run to run.
// Without maps (the dense path and moe_gating_topk) the same kernel skips
// the positions and the maps and counts ids with shared-memory atomics
// (integers: order-free).
//
// What bounds it here. It reads T*E*4 bytes, writes T*k*16 and two maps of
// 8 bytes a slot: well under a microsecond of HBM traffic at serving
// shapes, so latency bounds it: a warp's rows one after another (k rounds
// of dependent reductions each), the cluster barriers and one launch. Its
// worth is the ~60 small PyTorch kernels of the layer it replaces. The
// numbers are in PERF.md.
#include <climits>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 32;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K = 8;              // checked in Python
constexpr int MAX_NV = 12;            // E <= 384, checked in Python
constexpr int MAX_CTAS = 8;           // portable cluster size
constexpr int MAX_CTA_ENTRIES = 8192; // a CTA's entries: ranks fit 16 bits
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* logits;
  float* w;
  int32_t* ids;
  int64_t* slot_of;   // (groups, Tg*k); null without maps
  int64_t* tos;       // (groups, E*cap + 1)
  int64_t* tks;
  float* aux;         // lb_loss, z_loss
  float* partial;     // groups x E psum, groups x E counts (int), groups
                      // lse2; null for one group
  unsigned* ticket;   // 0 between launches; null for one group
  int T, E, k, groups, ctas, cap;
};

// shared memory words before the entries
__host__ __device__ constexpr int head_words(int E) {
  return WARPS * E + 4 * E + WARPS + 2;
}

template <int NV>
__device__ __forceinline__ void load_row(const float* row, int E, int lane,
                                         float* dst) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    dst[j] = e < E ? row[e] : -INFINITY;
  }
}

template <int NV, bool MAPS>
__global__ void __launch_bounds__(THREADS) moe_route_kernel(Args a) {
  extern __shared__ int smem[];
  const int E = a.E, K = a.k;
  int* work = smem;                                    // WARPS x E
  float* fwork = reinterpret_cast<float*>(work);
  int* s_cnt = work + WARPS * E;                       // this CTA's counts
  float* s_psum = reinterpret_cast<float*>(s_cnt + E); // sum_t p[t, e]
  int* s_off = reinterpret_cast<int*>(s_psum + E);     // lower CTAs' counts
  int* s_tot = s_off + E;                              // the block's counts
  float* s_lse2 = reinterpret_cast<float*>(s_tot + E); // WARPS + 1
  int* s_flag = reinterpret_cast<int*>(s_lse2 + WARPS + 1);
  int* s_ent = s_flag + 1;                             // expert, then rank

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int g = blockIdx.x / R;
  const int Tg = (a.T + a.groups - 1) / a.groups;
  const int g0 = g * Tg, gn = min(Tg, a.T - g0);
  const int per = (Tg + R - 1) / R;
  const int t0 = min(rank * per, gn), t1 = min(t0 + per, gn);

  if constexpr (!MAPS) {
    for (int e = tid; e < E; e += THREADS) s_cnt[e] = 0;
    __syncthreads();
  }

  // -- 1. gating: a warp per token row ---------------------------------
  float acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = 0.f;
  float lse2 = 0.f;
  float next[NV];   // the warp's next row, loaded while this one computes
  if (t0 + warp < t1) load_row<NV>(a.logits + size_t(g0 + t0 + warp) * E, E,
                                   lane, next);
  for (int t = t0 + warp; t < t1; t += WARPS) {
    float p[NV];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      p[j] = next[j];
      mx = fmaxf(mx, p[j]);
    }
    if (t + WARPS < t1)
      load_row<NV>(a.logits + size_t(g0 + t + WARPS) * E, E, lane, next);
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
      if (e < E) acc[j] += p[j];
    }
    const float lse = mx + logf(sum);
    lse2 += lse * lse;

    float my_w = 0.f;   // lane r keeps round r's pick
    int my_id = 0;
#pragma unroll
    for (int r = 0; r < MAX_K; ++r) {
      if (r >= K) break;
      // this lane's best: j ascending means index ascending, so a strict >
      // keeps the lower index on ties
      unsigned bkey = 0u;
      int bi = lane;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const unsigned key = p[j] >= 0.f ? __float_as_uint(p[j]) + 1u : 0u;
        if (key > bkey) {
          bkey = key;
          bi = lane + 32 * j;
        }
      }
      const unsigned top = __reduce_max_sync(FULL, bkey);
      const int pick = __reduce_min_sync(FULL, bkey == top ? bi : INT_MAX);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (lane + 32 * j == pick) p[j] = -INFINITY;
      if (lane == r) {
        my_w = __uint_as_float(top - 1u);
        my_id = pick;
      }
    }
    const float total = repro::warp_sum(lane < K ? my_w : 0.f, 32);
    if (lane < K) {
      const size_t o = size_t(g0 + t) * K + lane;
      a.w[o] = my_w / fmaxf(total, 1e-9f);
      a.ids[o] = my_id;
      if constexpr (MAPS)
        s_ent[(t - t0) * K + lane] = my_id;
      else
        atomicAdd(&s_cnt[my_id], 1);
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < E) fwork[warp * E + lane + 32 * j] = acc[j];
  if (lane == 0) s_lse2[warp] = lse2;
  __syncthreads();
  for (int e = tid; e < E; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += fwork[w * E + e];
    s_psum[e] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += s_lse2[w];
    s_lse2[WARPS] = s;
  }
  __syncthreads();

  // -- 2. positions inside the CTA: each warp ranks a contiguous part ----
  const int n = (t1 - t0) * K;
  const int part = (n + WARPS - 1) / WARPS;
  const int lo = min(warp * part, n), hi = min(lo + part, n);
  if constexpr (MAPS) {
    for (int i = tid; i < WARPS * E; i += THREADS) work[i] = 0;
    __syncthreads();
    int* hist = work + warp * E;
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const bool act = i < hi;
      const unsigned am = __ballot_sync(FULL, act);
      if (act) {
        const int e = s_ent[i];
        const unsigned same = __match_any_sync(am, e);
        const int before = hist[e];
        __syncwarp(am);
        if (lane == 31 - __clz(same)) hist[e] = before + __popc(same);
        s_ent[i] = (e << 16) | (before + __popc(same & ((1u << lane) - 1u)));
      }
      __syncwarp();
    }
    __syncthreads();
    for (int e = tid; e < E; e += THREADS) {   // exclusive scan over warps
      int run = 0;
      for (int w = 0; w < WARPS; ++w) {
        const int c = work[w * E + e];
        work[w * E + e] = run;
        run += c;
      }
      s_cnt[e] = run;
    }
  }

  // -- 3. across the cluster ---------------------------------------------
  cluster.sync();
  for (int e = tid; e < E; e += THREADS) {
    if (!MAPS && rank != 0) break;
    int off = 0, tot = 0;
    for (int r = 0; r < R; ++r) {
      const int c = cluster.map_shared_rank(s_cnt, r)[e];
      if (r < rank) off += c;
      tot += c;
    }
    s_off[e] = off;
    s_tot[e] = tot;
  }
  if (rank == 0) {
    for (int e = tid; e < E; e += THREADS) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += cluster.map_shared_rank(s_psum, r)[e];
      s_psum[e] = s;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < R; ++r)
        s += cluster.map_shared_rank(s_lse2, r)[WARPS];
      s_lse2[WARPS] = s;
    }
  }
  __syncthreads();
  if constexpr (MAPS) {
    const int cap = a.cap, S = E * cap + 1;
    int64_t* slot_of = a.slot_of + size_t(g) * Tg * K;
    int64_t* tos = a.tos + size_t(g) * S;
    int64_t* tks = a.tks + size_t(g) * S;
    for (int i = lo + lane; i < hi; i += 32) {
      const int v = s_ent[i];
      const int e = v >> 16;
      const int pos = s_off[e] + work[warp * E + e] + (v & 0xffff);
      const int flat = t0 * K + i;
      if (pos < cap) {
        const int slot = e * cap + pos;
        slot_of[flat] = slot;
        tos[slot] = flat / K;
        tks[slot] = flat;
      } else {
        slot_of[flat] = E * cap;
      }
    }
    const int sper = (S + R - 1) / R;
    const int s_end = min(S, (rank + 1) * sper);
    for (int s = rank * sper + tid; s < s_end; s += THREADS) {
      const int e = s / cap;
      if (e == E || s - e * cap >= s_tot[e]) {   // the sentinel, or empty
        tos[s] = Tg;
        tks[s] = int64_t(Tg) * K;
      }
    }
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
  if (rank != 0) return;

  // -- 4. aux: rank 0 holds its block's sums; with several blocks, the last
  // to finish adds them up in block order ----------------------------------
  const int G = a.groups;
  if (G > 1) {
    int* cnt_all = reinterpret_cast<int*>(a.partial + size_t(G) * E);
    float* lse_all = a.partial + size_t(2 * G) * E;
    for (int e = tid; e < E; e += THREADS) {
      a.partial[size_t(g) * E + e] = s_psum[e];
      cnt_all[size_t(g) * E + e] = s_tot[e];
    }
    if (tid == 0) lse_all[g] = s_lse2[WARPS];
    __threadfence();
    __syncthreads();
    if (tid == 0) s_flag[0] = atomicAdd(a.ticket, 1u) == unsigned(G - 1);
    __syncthreads();
    if (!s_flag[0]) return;
    __threadfence();
    for (int e = tid; e < E; e += THREADS) {
      float ps = 0.f;
      int c = 0;
#pragma unroll 4
      for (int b = 0; b < G; ++b) {
        ps += __ldcg(a.partial + size_t(b) * E + e);
        c += __ldcg(cnt_all + size_t(b) * E + e);
      }
      s_psum[e] = ps;
      s_tot[e] = c;
    }
    if (tid == 0) {
      float z = 0.f;
#pragma unroll 4
      for (int b = 0; b < G; ++b) z += __ldcg(lse_all + b);
      s_lse2[WARPS] = z;
      *a.ticket = 0u;
    }
    __syncthreads();
  }
  if (warp == 0) {   // a fixed order: lane-strided sums, then a butterfly
    const float T = float(a.T);
    float lb = 0.f;
    for (int e = lane; e < E; e += 32)
      lb += (float(s_tot[e]) / T) * (s_psum[e] / T);
    lb = repro::warp_sum(lb, 32);
    if (lane == 0) {
      a.aux[0] = float(E) * lb;
      a.aux[1] = s_lse2[WARPS] / T;
    }
  }
}

template <int NV, bool MAPS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int R = a.ctas;
  const int Tg = (a.T + a.groups - 1) / a.groups;
  const int per = (Tg + R - 1) / R;
  const size_t smem =
      sizeof(int) * (size_t(head_words(a.E)) + (MAPS ? size_t(per) * a.k : 0));
  auto kernel = moe_route_kernel<NV, MAPS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.groups * R);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool MAPS>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  switch ((a.E + 31) / 32) {
    case 1: return launch<1, MAPS>(a, s);
    case 2: return launch<2, MAPS>(a, s);
    case 3: return launch<3, MAPS>(a, s);
    case 4: return launch<4, MAPS>(a, s);
    case 5: return launch<5, MAPS>(a, s);
    case 6: return launch<6, MAPS>(a, s);
    case 7: return launch<7, MAPS>(a, s);
    case 8: return launch<8, MAPS>(a, s);
    case 9: return launch<9, MAPS>(a, s);
    case 10: return launch<10, MAPS>(a, s);
    case 11: return launch<11, MAPS>(a, s);
    case 12: return launch<12, MAPS>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// `groups` blocks of ceil(T / groups) tokens, each a cluster of `ctas` CTAs.
// slot_of, tos and tks null: gating and aux only (cap unused); otherwise the
// blocks are the dispatch blocks (T a multiple of groups).
extern "C" int repro_moe_route(const void* logits, void* w, void* ids,
                               void* slot_of, void* tos, void* tks, void* aux,
                               void* partial, void* ticket, int T, int E,
                               int k, int groups, int ctas, int cap,
                               void* stream) {
  const bool maps = slot_of != nullptr;
  if (T < 1 || E < 1 || E > 32 * MAX_NV || k < 1 || k > MAX_K || k > E ||
      groups < 1 || groups > T || ctas < 1 || ctas > MAX_CTAS)
    return int(cudaErrorInvalidValue);
  if (groups > 1 && (partial == nullptr || ticket == nullptr))
    return int(cudaErrorInvalidValue);
  if (maps && (tos == nullptr || tks == nullptr || T % groups != 0 ||
               cap < 1 ||
               int64_t(E) * cap >= INT_MAX / 2 ||
               int64_t((T / groups + ctas - 1) / ctas) * k > MAX_CTA_ENTRIES))
    return int(cudaErrorInvalidValue);
  Args a;
  a.logits = static_cast<const float*>(logits);
  a.w = static_cast<float*>(w);
  a.ids = static_cast<int32_t*>(ids);
  a.slot_of = static_cast<int64_t*>(slot_of);
  a.tos = static_cast<int64_t*>(tos);
  a.tks = static_cast<int64_t*>(tks);
  a.aux = static_cast<float*>(aux);
  a.partial = static_cast<float*>(partial);
  a.ticket = static_cast<unsigned*>(ticket);
  a.T = T;
  a.E = E;
  a.k = k;
  a.groups = groups;
  a.ctas = ctas;
  a.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(maps ? dispatch<true>(a, s) : dispatch<false>(a, s));
}
