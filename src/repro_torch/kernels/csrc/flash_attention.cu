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
// Unlike the TPU kernel it takes any Sq and Skv: rows and columns past the
// edge are masked, so the engine's power-of-two padding (>= 8) and ragged
// tails both work.
//
// What bounds it here. The prefill's causal attention is compute-bound on
// paper (~2*Dh flops per byte of k/v at Sq = Skv = 1024), so the card's bound
// is the bf16 tensor-core rate.
//
// bf16 design (flash_tc_kernel, the served path), on Hopper's warpgroup
// tensor-core instruction. One block is one warpgroup (4 warps, 128
// threads) and owns one (batch, query head, 64-row query tile). Q and the
// 64-row K and V tiles sit in shared memory in bf16, in the 128-byte
// swizzled layout that wgmma's descriptors name; K and V stream through a
// 2-stage cp.async ring, so tile j+1 is in flight while tile j is computed.
// S = Q K^T is wgmma m64n64k16 with both operands in shared memory; O += P V
// is wgmma m64nDHk16 with P as the register A operand, re-packed to bf16
// from the S accumulators (whose layout is the A fragment's), and V read
// transposed (MN-major). Accumulators are fp32. The online softmax runs in
// registers on log2e-prescaled scores (the softcap first) with ex2.approx;
// only diagonal, window-edge and ragged tiles are masked. Tiles wholly above
// the diagonal or before the window are never loaded, and the q-tile index
// is reversed so the heaviest causal tiles launch first. P is rounded to
// bf16 before P V, where the plain version keeps it in fp32: the error
// against it grows from ~0.004 to ~0.016 (the bf16 tolerance is 2e-2).
// Next steps (PERF.md): overlap the softmax with the products (two
// warpgroups or intra-warpgroup pipelining) and TMA-fed tiles.
//
// fp32 design (flash_fwd_kernel). Tensor cores would round fp32 inputs to
// TF32 (~3 decimal digits), which cannot meet the 2e-5 fp32 tolerance of
// the reference's tests, so fp32 keeps the first kernel: one block of 256
// threads per (batch, query head, 64-row tile), four threads per query row,
// 64-row kv tiles staged in shared memory as fp32 and fp32 FMAs, with the
// padded row stride (Dh + 1) keeping the score loop free of bank conflicts.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async_commit;
using repro::cp_async_wait;
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

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;           // query rows per block: one warpgroup
constexpr int BK = 64;           // kv rows per tile
constexpr int NT = 128;          // threads per block: 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
constexpr size_t smem_bytes() {
  // sQ (BQ rows) + sK, sV (2 stages of BK rows each), bf16, and room to
  // align the base to 1024 bytes
  return sizeof(bf16) * size_t(DH) * (BQ + 4 * BK) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// d (64 x 64 fp32, 32 a thread) += A * B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32, 32 a thread) += A * B, A in registers (each warp's
// 16 rows as the mma.m16n8k16 A fragment), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 fp32, 64 a thread) += A * B, A in registers (each warp's
// 16 rows as the mma.m16n8k16 A fragment), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// make the threads' cp.async writes visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of r across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4), layout type 1 (bits 62-63)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// 2^x on the SFU (ex2.approx: ~2 ulp, far below the bf16 rounding of P)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Issue the async copy of ROWS rows (row0 on) of a slice whose rows hold DH
// bf16 `row_stride` apart into dst (1024-byte aligned) in the 128-byte
// swizzled layout that wgmma reads: 64-column atoms of ROWS x 128 bytes one
// after another, row r of an atom at r * 128 bytes, its 16-byte chunk c at
// (c ^ r % 8) * 16. Rows at or past `limit` are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ base,
                                          size_t row_stride, int row0,
                                          int limit, bf16* dst, int tid) {
  constexpr int CPR = DH / 8;   // 16-byte chunks per row
  const uint32_t d0 = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int i = tid + it * NT;
    const int c = i % CPR, r = i / CPR;
    const bool ok = row0 + r < limit;
    const bf16* src = base + size_t(ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(d0 + (c / 8) * (ROWS * 128) + r * 128 + ((c % 8) ^ (r % 8)) * 16,
               src, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(NT, 2)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                    int Skv, int H, int KVH, int causal, int window,
                    float softcap, float scale) {
  constexpr int KSTEPS = DH / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;        // 8-column blocks of S
  constexpr int NO = DH / 8;        // 8-column blocks of O
  // Descriptor strides. K-major Q and K: 8-row groups 1024 bytes apart (the
  // leading offset is unused). MN-major V: 64-column atoms BK * 128 bytes
  // apart, 8-row groups 1024 bytes apart.
  constexpr uint32_t KM_LBO = 16, KM_SBO = 1024;
  constexpr uint32_t MN_LBO = BK * 128, MN_SBO = 1024;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle is a function of address bits
  bf16* sQ = reinterpret_cast<bf16*>(
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024);
  bf16* sK = sQ + BQ * DH;          // 2 stages
  bf16* sV = sK + 2 * BK * DH;      // 2 stages

  // heaviest causal q tiles first: blockIdx.y 0 is the last tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, t4 = lane % 4;   // fragment row, column pair

  const size_t q_stride = size_t(H) * DH;
  const size_t kv_stride = size_t(KVH) * DH;
  const bf16* qb = q + size_t(b) * Sq * q_stride + size_t(h) * DH;
  const bf16* kb = k + size_t(b) * Skv * kv_stride + size_t(kvh) * DH;
  const bf16* vb = v + size_t(b) * Skv * kv_stride + size_t(kvh) * DH;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_lo / BK;
  const int t_end = (kv_hi + BK - 1) / BK;

  load_tile<DH, BQ>(qb, q_stride, q0, Sq, sQ, tid);
  if (t_begin < t_end) {
    load_tile<DH, BK>(kb, kv_stride, t_begin * BK, Skv, sK, tid);
    load_tile<DH, BK>(vb, kv_stride, t_begin * BK, Skv, sV, tid);
  }
  cp_async_commit();

  // Accumulators in wgmma's layout: warp w holds rows 16 w + gid (entries
  // 4 j, 4 j + 1) and 16 w + gid + 8 (4 j + 2, 4 j + 3) of 8-column block
  // j, columns 8 j + 2 t4 and + 1. Per row: running max (log2 domain) and
  // this thread's part of the running sum.
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(sQ);
  const float qk_scale = softcap > 0.f ? scale : scale * kLog2e;
  const int row_base = q0 + warp * 16 + gid;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile<DH, BK>(kb, kv_stride, (t + 1) * BK, Skv,
                        sK + (st ^ 1) * BK * DH, tid);
      load_tile<DH, BK>(vb, kv_stride, (t + 1) * BK, Skv,
                        sV + (st ^ 1) * BK * DH, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T, 64 x 64; a k-step is 32 bytes into a 64-column atom
    const uint32_t k_addr = smem_u32(sK + st * BK * DH);
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_n64(s,
                   make_desc(q_addr + (kk / 4) * (BQ * 128) + (kk % 4) * 32,
                             KM_LBO, KM_SBO),
                   make_desc(k_addr + (kk / 4) * (BK * 128) + (kk % 4) * 32,
                             KM_LBO, KM_SBO));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, softcap, log2e prescale; mask only where the tile needs it
    const int k0 = t * BK;
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) {
      float x = s[i] * qk_scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap) * kLog2e;
      s[i] = x;
    }
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) {
        const int kpos = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
        const int qpos = row_base + ((i >> 1) & 1) * 8;
        const bool keep = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        if (!keep) s[i] = kNegInf;
      }
    }

    // online softmax; the four threads of a row are lanes 4*gid .. 4*gid+3
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = repro::warp_max(mx[r], 4);
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_safe[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[r] =
          m_run[r] <= kNegInf / 2 ? 0.f : fast_exp2(m_run[r] - m_safe[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    // masked scores are -1e30: their exp2 is exactly 0. P goes straight to
    // bf16 A fragments: k-step kk of P V is S column blocks 2 kk, 2 kk + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(s[4 * j + e] - m_safe[e >> 1]);
        l_run[e >> 1] += p[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }

    // O += P V: a k-step is two 8-row groups of V
    const uint32_t v_addr = smem_u32(sV + st * BK * DH);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = make_desc(v_addr + kk * 2048, MN_LBO, MN_SBO);
      if constexpr (DH == 128)
        wgmma_rs_n128(acc, pa[kk], dv);
      else
        wgmma_rs_n64(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();   // stage st is refilled by the next iteration's copy
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = repro::warp_sum(l_run[r], 4);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int qpos = row_base + r * 8;
    if (qpos < Sq) {
      bf16* orow = o + (size_t(b) * Sq + qpos) * q_stride + size_t(h) * DH;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * inv,
                                  acc[4 * n + 2 * r + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KVH, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  auto kern = flash_tc_kernel<DH>;
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, KVH,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

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
    return tc::launch<64>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                          softcap, scale, s);
  if (dtype == repro::kBFloat16 && Dh == 128)
    return tc::launch<128>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,
                           softcap, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
