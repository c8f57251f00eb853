// Paged decode attention for Hopper (sm_90a): one query token per request
// over the K/V pages its page table names, GQA, online softmax, split over
// pages (flash-decoding).
//
// Replaces the TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py:75, body `_kernel`).  For
// request b, KV head h and its G = H / KV query heads g:
//   a token t of page p (pool slot page_map[b, p]) is valid iff
//   t < lengths[b] and the page is mapped (page_map[b, p] >= 0);
//   out[b, h*G + g] = sum_t softmax_t(q[b, h*G + g] . k[t]) v[t]
// over the valid tokens, with q prescaled by `scale` in q's own dtype by
// the wrapper (as the TPU kernel does).  A row with no valid token gives
// zeros (the TPU kernel's l = 0 over max(l, 1e-20)).
//
// `unmapped_reads_zero = 1` switches to the contract of the vmem decode
// path (repro.core.vmem.kvcache.paged_decode_attention): a token below the
// length on an unmapped page counts with k = v = 0, and a request with
// length <= 0 gets the softmax of an all-masked row there, the uniform
// mean over all n_pages * page gathered rows (zeros on unmapped pages).
// Pool slots are clamped into [0, n_slots - 1], so no page table entry can
// read outside the pool.
//
// What bounds it: memory.  Decode reads every K and V row below the length
// once and does 4 * hd flops per (query head, token) for G query heads per
// row: about 4 flops per byte of bf16 K/V (G = 8), far below the ~295 at
// which the tensor cores would be the limit.  The bound is the K/V bytes
// this run's lengths need over the 3.35 TB/s of device memory.  So the
// design keeps many bytes in flight on every SM and does little per byte.
//
// Design.  One call is two CUDA launches:
//
// 1. A split kernel, grid (request x KV head x head chunk, split).  A split is
//    a contiguous run of pps = ceil(n_pages / n_splits) pages of the request;
//    a split at or past the request's ceil(length / page) pages is empty.  The
//    wrapper picks n_splits from B * KV and the longest length a page table
//    row can name (n_pages * page, so it need not read the lengths back to the
//    host): enough splits for about 4 waves of 2 CTAs on each SM, at least 64
//    tokens a split (one split when B * KV alone fills the card), and at most
//    4096 tokens a split.  The CTA (4 warps) reads its split's page-table
//    entries once, up front, and expands them into a table of pool rows, one a
//    token, in shared memory, so the copies of each stage do no division by
//    the page size (with one per 16-byte copy, address arithmetic takes most
//    of the issue slots and the kernel is not bound by bytes).  K and V rows
//    are copied into shared memory in their own dtype by 16-byte `cp.async`
//    (zero-filled past the length and on unmapped pages), `tok` tokens a
//    stage, three stages, two in flight while one computes: one barrier per
//    stage.  Each warp keeps its own online softmax (m, l, acc) in registers
//    over its tokens of each stage; at the end of the split the 4 warps'
//    states are merged through shared memory and written as the split's
//    partial (m, l, acc[hd]) to an fp32 scratch the wrapper allocates.  A
//    split with no valid token writes m = -1e30, l = 0, acc = 0.  Two routes,
//    by the pool's dtype and head dim:
//    * bf16 pools with hd % 8 == 0, hd <= 128 and 16-byte aligned pools
//      (the vmem path: hd 128): `paged_attention_split_tc_kernel`, on the
//      tensor cores.  Each warp takes 16 tokens of a 64-token stage (the
//      rows swizzled so that `ldmatrix` has no bank conflicts) and the
//      CTA's 16 query-head rows (G <= 16 heads per head chunk, zero rows
//      past G), so each K and V row serves all the heads in one
//      `mma.sync.m16n8k16`: S = q K^T, then O += P V with V through
//      `ldmatrix.trans`.  q (fp32, prescaled) and P are each split into
//      two bf16 terms, hi + lo, in registers, so the products keep ~16 bits
//      of mantissa (the fp32 result to ~1e-5, not bf16's 4e-3) at twice
//      the (cheap) MMAs; the softmax runs on the accumulator fragments.
//      On the CUDA cores the same work is ~170 instructions a token per
//      warp (bf16 unpacking repeated for each head): issue-bound, not
//      bound by bytes.
//    * every other pool (fp32, hd = 6, hd > 128):
//      `paged_attention_split_kernel`, on the CUDA cores.  lane = (head,
//      part): each of the 32 / gw lanes of one of the CTA's gw query heads
//      owns dl consecutive head-dim elements of q (fp32, prescaled) and of
//      the fp32 accumulator (gw = 8, dl = 32 at G = 8, hd = 128), so every
//      K and V row read from shared memory serves all the CTA's heads and a
//      score needs log2(32 / gw) shuffles; a warp scores 4 tokens per
//      rescale.  Where hd * itemsize is not a multiple of 16 or a pool is
//      not 16-byte aligned (hd = 6 in the tests), the stage is loaded
//      element by element.
//    G above what one CTA holds (16 heads on the tensor cores; gw * hd >
//    2048 on the CUDA cores) is split over head chunks, each re-reading
//    the K/V pages (not the model path).
// 2. `paged_attention_combine_kernel`, one CTA per (request, query head):
//    out = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-20),
//    M = max_i m_i.  Empty splits drop out (weight e^(-1e30 - M) = 0); a
//    row whose every split is empty gives 0 / 1e-20 = 0.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kGroup = 4;            // tokens a warp scores per rescale
constexpr int kStageBytes = 16384;   // K + V bytes of one stage
constexpr float kNegInf = -1e30f;

struct Config {
  int gw;      // query heads per CTA, a power of two <= 32
  int parts;   // lanes per head: 32 / gw
  int dl;      // head-dim elements per lane (4 .. 64)
  int hdp;     // shared-memory row length, parts * dl >= hd
  int tok;     // tokens per stage, a multiple of kWarps * kGroup
  int n_hc;    // head chunks, ceil(G / gw)
};

__host__ __device__ inline Config make_config(int hd, int G, int esize) {
  Config c;
  int gw = 1;
  while (gw < G && gw < 32) gw <<= 1;
  while (gw > 1 && (32 / gw) * 64 < hd) gw >>= 1;
  c.gw = gw;
  c.parts = 32 / gw;
  int dl = 4;
  while (c.parts * dl < hd) dl <<= 1;
  c.dl = dl;
  c.hdp = c.parts * dl;
  int tok = kStageBytes / (2 * c.hdp * esize) / (kWarps * kGroup) *
            (kWarps * kGroup);
  c.tok = tok < kWarps * kGroup ? kWarps * kGroup : (tok > 64 ? 64 : tok);
  c.n_hc = (G + gw - 1) / gw;
  return c;
}

// Shared memory: kStages x (K, V) x [tok][hdp] in the pool's dtype, the
// split's token rows (pool row slot * page + t % page, -1 on an unmapped
// page), then the warps' (acc [gw][hdp], m, l).
__host__ __device__ inline size_t stage_bytes(const Config& c, int esize) {
  return static_cast<size_t>(kStages) * 2 * c.tok * c.hdp * esize;
}
__host__ __device__ inline size_t rows_bytes(int split_tokens) {
  return (static_cast<size_t>(split_tokens) * 4 + 15) / 16 * 16;
}
__host__ __device__ inline size_t smem_bytes(const Config& c,
                                             int split_tokens, int esize) {
  return stage_bytes(c, esize) + rows_bytes(split_tokens) +
         static_cast<size_t>(kWarps) * c.gw * (c.hdp + 2) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// DL consecutive elements of a shared-memory row as fp32
template <int DL>
__device__ __forceinline__ void load_row(const float* p, float (&x)[DL]) {
#pragma unroll
  for (int i = 0; i < DL / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <int DL>
__device__ __forceinline__ void load_row(const bf16* p, float (&x)[DL]) {
  if constexpr (DL >= 8) {
#pragma unroll
    for (int i = 0; i < DL / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      unpack2(v.x, x[8 * i], x[8 * i + 1]);
      unpack2(v.y, x[8 * i + 2], x[8 * i + 3]);
      unpack2(v.z, x[8 * i + 4], x[8 * i + 5]);
      unpack2(v.w, x[8 * i + 6], x[8 * i + 7]);
    }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack2(v.x, x[0], x[1]);
    unpack2(v.y, x[2], x[3]);
  }
}

// ---- the tensor-core route's fragments (mma.sync.m16n8k16, bf16 -> fp32)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as two bf16 pairs, hi + lo, with x - hi - lo ~ 2^-16 |x|
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- what both routes share

// the pages [p0, p1) and tokens [t_begin, t_end) of one split
struct Range {
  bool uniform;   // unmapped_reads_zero and length <= 0: every row, score 0
  int p0, p1, t_begin, t_end;
};

__device__ __forceinline__ Range split_range(int length,
                                             int unmapped_reads_zero,
                                             int n_pages, int page, int split,
                                             int pps) {
  Range r;
  r.uniform = unmapped_reads_zero && length <= 0;
  const int total = n_pages * page;
  const int tok_end =
      r.uniform ? total : (length <= 0 ? 0 : min(length, total));
  const int steps = (tok_end + page - 1) / page;
  r.p0 = split * pps;
  r.p1 = min(r.p0 + pps, steps);
  r.t_begin = r.p0 * page;
  r.t_end = min(r.p1 * page, tok_end);
  return r;
}

// an empty split's partial for heads [h0, min(h0 + gw, G)): m = -1e30,
// l = 0, acc = 0
__device__ void write_empty(float* part_acc, float* part_ml, int64_t head0,
                            int h0, int gw, int G, int n_splits, int split,
                            int hd) {
  for (int i = threadIdx.x; i < gw * hd; i += kThreads) {
    const int hh = i / hd;
    if (h0 + hh >= G) continue;
    const int64_t pi = (head0 + h0 + hh) * n_splits + split;
    const int d = i - hh * hd;
    part_acc[pi * hd + d] = 0.f;
    if (d == 0) {
      part_ml[2 * pi] = kNegInf;
      part_ml[2 * pi + 1] = 0.f;
    }
  }
}

// the warps' states, acc c_acc [kWarps][gw][hdp] and (m, l) c_ml
// [kWarps][gw][2], merged into the split's partial for heads [h0, h0 + gw)
__device__ void merge_warps(const float* c_acc, const float* c_ml, int gw,
                            int hdp, float* part_acc, float* part_ml,
                            int64_t head0, int h0, int G, int n_splits,
                            int split, int hd) {
  for (int i = threadIdx.x; i < gw * hd; i += kThreads) {
    const int hh = i / hd;
    if (h0 + hh >= G) continue;
    const int d = i - hh * hd;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, c_ml[2 * (w * gw + hh)]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(c_ml[2 * (w * gw + hh)] - M);
      a = fmaf(e, c_acc[(w * gw + hh) * hdp + d], a);
      L = fmaf(e, c_ml[2 * (w * gw + hh) + 1], L);
    }
    const int64_t pi = (head0 + h0 + hh) * n_splits + split;
    part_acc[pi * hd + d] = a;
    if (d == 0) {
      part_ml[2 * pi] = M;
      part_ml[2 * pi + 1] = L;
    }
  }
}

// the split's token rows: rows_s[i] = the pool row (slot * page + t %
// page, the slot clamped into the pool) of token t = t_begin + i, or -1
// where its page is unmapped; one page-table read and one division a token
__device__ __forceinline__ void fill_rows(int32_t* rows_s,
                                          const int32_t* __restrict__ pm_row,
                                          const Range& rg, int page,
                                          int n_slots) {
  for (int i = threadIdx.x; i < rg.t_end - rg.t_begin; i += kThreads) {
    const int t = rg.t_begin + i;
    const int p = t / page;
    const int entry = pm_row[p];
    rows_s[i] =
        entry < 0 ? -1 : min(entry, n_slots - 1) * page + (t - p * page);
  }
}

// tokens [t0, t0 + tok) of a split into one stage, K then V, each
// [tok][hdp]; rows past t_end or on an unmapped page read as zero.  VEC:
// 16-byte cp.async; else element by element (padding columns untouched).
template <typename T>
__device__ __forceinline__ void load_stage(
    T* ks, T* vs, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int32_t* rows_s, const Range& rg, int t0, int tok, int hdp, int hd,
    int64_t tok_stride, int64_t head_off, bool vec) {
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    const int cr = hd / per;
    for (int i = threadIdx.x; i < tok * cr; i += kThreads) {
      const int r = i / cr;
      const int c = i - r * cr;
      const int t = t0 + r;
      const int row = t < rg.t_end ? rows_s[t - rg.t_begin] : -1;
      const bool ok = row >= 0;
      const int64_t off = row * tok_stride + head_off + c * per;
      cp_async16(ks + r * hdp + c * per, ok ? k_pool + off : k_pool, ok);
      cp_async16(vs + r * hdp + c * per, ok ? v_pool + off : v_pool, ok);
    }
  } else {
    for (int i = threadIdx.x; i < tok * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      const int t = t0 + r;
      const int row = t < rg.t_end ? rows_s[t - rg.t_begin] : -1;
      const int64_t off = row * tok_stride + head_off + d;
      ks[r * hdp + d] = row >= 0 ? k_pool[off] : zero<T>();
      vs[r * hdp + d] = row >= 0 ? v_pool[off] : zero<T>();
    }
  }
}

// is token t of the split counted (before the uniform rule)?
__device__ __forceinline__ bool token_valid(const int32_t* rows_s, int t,
                                            const Range& rg,
                                            int unmapped_reads_zero) {
  return t < rg.t_end &&
         (unmapped_reads_zero || rows_s[t - rg.t_begin] >= 0);
}

// ---- the CUDA-core route

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(
    const float* __restrict__ q,            // [B, H, hd], prescaled
    const T* __restrict__ k_pool,           // [n_slots, page, KV, hd]
    const T* __restrict__ v_pool,
    const int32_t* __restrict__ page_map,   // [B, n_pages]
    const int32_t* __restrict__ lengths,    // [B]
    float* __restrict__ part_acc,           // [B, H, n_splits, hd]
    float* __restrict__ part_ml,            // [B, H, n_splits, 2]
    int n_slots, int page, int KV, int hd, int G, int n_pages, int pps,
    int unmapped_reads_zero, int vec) {
  const Config cf = make_config(hd, G, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);
  int32_t* rows_s =
      reinterpret_cast<int32_t*>(smem_raw + stage_bytes(cf, sizeof(T)));
  float* c_acc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(
                                              rows_s) + rows_bytes(pps * page));
  float* c_ml = c_acc + kWarps * cf.gw * cf.hdp;
  const int stage_elems = 2 * cf.tok * cf.hdp;

  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int hc = blockIdx.x % cf.n_hc;
  const int kvh = (blockIdx.x / cf.n_hc) % KV;
  const int b = blockIdx.x / cf.n_hc / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = lane / cf.parts;   // this lane's head in the chunk
  const int dp = lane % cf.parts;   // and its part of the head dim
  const int h0 = hc * cf.gw;
  const int g = h0 + hw;
  const int64_t head0 = static_cast<int64_t>(b) * KV * G + kvh * G;

  const Range rg = split_range(lengths[b], unmapped_reads_zero, n_pages,
                               page, split, pps);
  if (rg.p0 >= rg.p1) {
    write_empty(part_acc, part_ml, head0, h0, cf.gw, G, n_splits, split, hd);
    return;
  }
  fill_rows(rows_s, page_map + static_cast<int64_t>(b) * n_pages, rg, page,
            n_slots);
  if (cf.hdp > hd) {   // padding columns are never copied: zero them once
    const int padw = cf.hdp - hd;
    for (int i = tid; i < kStages * 2 * cf.tok * padw; i += kThreads) {
      const int r = i / padw;
      kv_s[r * cf.hdp + hd + (i - r * padw)] = zero<T>();
    }
  }
  __syncthreads();

  const int64_t tok_stride = static_cast<int64_t>(KV) * hd;
  const int64_t head_off = static_cast<int64_t>(kvh) * hd;
  auto load = [&](int st, int t0) {
    T* ks = kv_s + st * stage_elems;
    load_stage<T>(ks, ks + cf.tok * cf.hdp, k_pool, v_pool, rows_s, rg, t0,
                  cf.tok, cf.hdp, hd, tok_stride, head_off, vec);
  };

  float qr[DL], acc[DL];
  const float* qg = q + (head0 + g) * hd;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = dp * DL + i;
    qr[i] = (g < G && d < hd) ? qg[d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int n_chunks = (rg.t_end - rg.t_begin + cf.tok - 1) / cf.tok;
  load(0, rg.t_begin);
  cp_async_commit();
  if (n_chunks > 1) load(1, rg.t_begin + cf.tok);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 2 < n_chunks) load((c + 2) % kStages,
                               rg.t_begin + (c + 2) * cf.tok);
    cp_async_commit();
    cp_async_wait2();   // chunk c has landed
    __syncthreads();
    const T* ks = kv_s + (c % kStages) * stage_elems;
    const T* vs = ks + cf.tok * cf.hdp;
    const int tc0 = rg.t_begin + c * cf.tok;
    for (int r0 = warp * kGroup; r0 < cf.tok; r0 += kWarps * kGroup) {
      float s[kGroup];
      bool valid[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float kr[DL];
        load_row<DL>(ks + (r0 + u) * cf.hdp + dp * DL, kr);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < DL; ++i)
          part[i & 3] = fmaf(qr[i], kr[i], part[i & 3]);
        s[u] = (part[0] + part[1]) + (part[2] + part[3]);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        for (int o = 1; o < cf.parts; o <<= 1)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        valid[u] = token_valid(rows_s, tc0 + r0 + u, rg,
                               unmapped_reads_zero);
        s[u] = !valid[u] ? kNegInf : (rg.uniform ? 0.f : s[u]);
      }
      float mx = m;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) mx = fmaxf(mx, s[u]);
      const float alpha = expf(m - mx);
      m = mx;
      float p[kGroup];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        p[u] = valid[u] ? expf(s[u] - mx) : 0.f;
        sum += p[u];
      }
      l = l * alpha + sum;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float vr[DL];
        load_row<DL>(vs + (r0 + u) * cf.hdp + dp * DL, vr);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[i] = fmaf(p[u], vr[i], acc[i]);
      }
    }
    __syncthreads();   // stage c % kStages is free for chunk c + 3
  }

#pragma unroll
  for (int i = 0; i < DL; ++i)
    c_acc[(warp * cf.gw + hw) * cf.hdp + dp * DL + i] = acc[i];
  if (dp == 0) {
    c_ml[2 * (warp * cf.gw + hw)] = m;
    c_ml[2 * (warp * cf.gw + hw) + 1] = l;
  }
  __syncthreads();
  merge_warps(c_acc, c_ml, cf.gw, cf.hdp, part_acc, part_ml, head0, h0, G,
              n_splits, split, hd);
}

// ---- the tensor-core route (bf16 pools, hd % 8 == 0, hd <= 128)

constexpr int kTcTok = 64;     // tokens a stage, 16 a warp
constexpr int kTcHeads = 16;   // query-head rows of the MMA, zero past G

template <int HDP>
struct TcShape {
  // kStages x (K, V) x [kTcTok][HDP] bf16; the split's token rows follow,
  // and after the loop the warps' merge state reuses the stages
  static constexpr size_t kStagesBytes =
      static_cast<size_t>(kStages) * 2 * kTcTok * HDP * sizeof(bf16);
  static_assert(static_cast<size_t>(kWarps) * kTcHeads * (HDP + 2) *
                        sizeof(float) <= kStagesBytes,
                "the merge state must fit in the stages");
};

inline size_t tc_smem_bytes(int hdp, int split_tokens) {
  return (hdp == 64 ? TcShape<64>::kStagesBytes
                    : TcShape<128>::kStagesBytes) + rows_bytes(split_tokens);
}

template <int HDP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HDP + ((c ^ (r & 7)) << 3);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
paged_attention_split_tc_kernel(
    const float* __restrict__ q,            // [B, H, hd], prescaled
    const bf16* __restrict__ k_pool,        // [n_slots, page, KV, hd]
    const bf16* __restrict__ v_pool,
    const int32_t* __restrict__ page_map,   // [B, n_pages]
    const int32_t* __restrict__ lengths,    // [B]
    float* __restrict__ part_acc,           // [B, H, n_splits, hd]
    float* __restrict__ part_ml,            // [B, H, n_splits, 2]
    int n_slots, int page, int KV, int hd, int G, int n_pages, int pps,
    int unmapped_reads_zero) {
  constexpr int KS = HDP / 16;   // k-steps over the head dim
  constexpr int DT = HDP / 8;    // output tiles of 8 columns
  constexpr int stage_elems = 2 * kTcTok * HDP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_raw);
  int32_t* rows_s =
      reinterpret_cast<int32_t*>(smem_raw + TcShape<HDP>::kStagesBytes);
  float* c_acc = reinterpret_cast<float*>(smem_raw);   // after the loop
  float* c_ml = c_acc + kWarps * kTcHeads * HDP;

  const int n_hc = (G + kTcHeads - 1) / kTcHeads;
  const int split = blockIdx.y;
  const int n_splits = gridDim.y;
  const int hc = blockIdx.x % n_hc;
  const int kvh = (blockIdx.x / n_hc) % KV;
  const int b = blockIdx.x / n_hc / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;   // fragment row (head gq and gq + 8)
  const int t4 = lane & 3;    // fragment column pair
  const int r0 = warp * 16;   // this warp's tokens in a stage
  const int h0 = hc * kTcHeads;
  const int64_t head0 = static_cast<int64_t>(b) * KV * G + kvh * G;

  const Range rg = split_range(lengths[b], unmapped_reads_zero, n_pages,
                               page, split, pps);
  if (rg.p0 >= rg.p1) {
    write_empty(part_acc, part_ml, head0, h0, kTcHeads, G, n_splits, split,
                hd);
    return;
  }
  fill_rows(rows_s, page_map + static_cast<int64_t>(b) * n_pages, rg, page,
            n_slots);
  __syncthreads();

  // q as A fragments (rows: heads h0 + gq, + 8; k: the head dim), hi + lo
  uint32_t qhi[KS][4], qlo[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int g = h0 + gq + 8 * (f & 1);
      const int d = 16 * ks + 8 * (f >> 1) + 2 * t4;
      const float* qg = q + (head0 + (g < G ? g : 0)) * hd;
      const float x0 = (g < G && d < hd) ? qg[d] : 0.f;
      const float x1 = (g < G && d + 1 < hd) ? qg[d + 1] : 0.f;
      split_bf16(x0, x1, qhi[ks][f], qlo[ks][f]);
    }
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int64_t tok_stride = static_cast<int64_t>(KV) * hd;
  const int64_t head_off = static_cast<int64_t>(kvh) * hd;
  // a stage: each thread copies one 16-byte column chunk c of every
  // (kThreads / CR)-th row, the chunk at c ^ (row & 7) (padding chunks
  // past hd zero-filled)
  constexpr int CR = HDP / 8;
  const int cc = tid % CR;
  auto load = [&](int st, int t0) {
    bf16* ks = kv_s + st * stage_elems;
    bf16* vs = ks + kTcTok * HDP;
#pragma unroll
    for (int r = tid / CR; r < kTcTok; r += kThreads / CR) {
      const int t = t0 + r;
      const int row = t < rg.t_end ? rows_s[t - rg.t_begin] : -1;
      const bool ok = row >= 0 && cc * 8 < hd;
      const int64_t off = row * tok_stride + head_off + cc * 8;
      cp_async16(ks + swz<HDP>(r, cc), ok ? k_pool + off : k_pool, ok);
      cp_async16(vs + swz<HDP>(r, cc), ok ? v_pool + off : v_pool, ok);
    }
  };
  const int n_chunks = (rg.t_end - rg.t_begin + kTcTok - 1) / kTcTok;
  load(0, rg.t_begin);
  cp_async_commit();
  if (n_chunks > 1) load(1, rg.t_begin + kTcTok);
  cp_async_commit();

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 2 < n_chunks) load((c + 2) % kStages,
                               rg.t_begin + (c + 2) * kTcTok);
    cp_async_commit();
    cp_async_wait2();   // chunk c has landed
    __syncthreads();
    const bf16* kt = kv_s + (c % kStages) * stage_elems;
    const bf16* vt = kt + kTcTok * HDP;
    const int tw = rg.t_begin + c * kTcTok + r0;   // the warp's first token

    // ---- S = q K^T: 16 head rows x 16 tokens (two tiles of 8)
    // (hi and lo into separate accumulators: shorter MMA chains)
    float sc[2][4], sl[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kb[4];
      ldsm_x4(kb, kt + swz<HDP>(r0 + (lane & 7) + ((lane >> 4) << 3),
                                2 * ks + ((lane >> 3) & 1)));
      mma(sc[0], qhi[ks], kb[0], kb[1]);
      mma(sl[0], qlo[ks], kb[0], kb[1]);
      mma(sc[1], qhi[ks], kb[2], kb[3]);
      mma(sl[1], qlo[ks], kb[2], kb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] += sl[j][e];

    // ---- mask and online softmax; rows gq (e < 2) and gq + 8 (e >= 2)
    bool vis[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        vis[j][u] = token_valid(rows_s, tw + 8 * j + 2 * t4 + u, rg,
                                unmapped_reads_zero);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = !vis[j][e & 1] ? kNegInf
                        : (rg.uniform ? 0.f : sc[j][e]);
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = vis[j][e & 1] ? expf(sc[j][e] - m[e >> 1]) : 0.f;
        sc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // ---- O += P V, P (hi + lo) straight from the score fragments
    uint32_t phi[4], plo[4];
    split_bf16(sc[0][0], sc[0][1], phi[0], plo[0]);
    split_bf16(sc[0][2], sc[0][3], phi[1], plo[1]);
    split_bf16(sc[1][0], sc[1][1], phi[2], plo[2]);
    split_bf16(sc[1][2], sc[1][3], phi[3], plo[3]);
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vt + swz<HDP>(r0 + (lane & 7) +
                                          (((lane >> 3) & 1) << 3),
                                      dt + (lane >> 4)));
      mma(o[dt], phi, bv[0], bv[1]);
      mma(o[dt], plo, bv[0], bv[1]);
      mma(o[dt + 1], phi, bv[2], bv[3]);
      mma(o[dt + 1], plo, bv[2], bv[3]);
    }
    __syncthreads();   // stage c % kStages is free for chunk c + 3
  }

  // ---- merge the 4 warps' states (over the stages, all copies landed)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * kTcHeads + gq + 8 * r;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      c_acc[row * HDP + dt * 8 + 2 * t4] = o[dt][2 * r];
      c_acc[row * HDP + dt * 8 + 2 * t4 + 1] = o[dt][2 * r + 1];
    }
    if (t4 == 0) {
      c_ml[2 * row] = m[r];
      c_ml[2 * row + 1] = l[r];
    }
  }
  __syncthreads();
  merge_warps(c_acc, c_ml, kTcHeads, HDP, part_acc, part_ml, head0, h0, G,
              n_splits, split, hd);
}

// out[row] = sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i, 1e-20),
// one CTA per row (request, query head): warp 0 reduces M and the
// denominator over the splits, then each thread sums one output column
// over the splits, 8 independent loads in flight
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               float* __restrict__ out, int n_splits,
                               int hd) {
  __shared__ float red[2];
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float* ml = part_ml + row * n_splits * 2;
  const float* pa = part_acc + row * n_splits * hd;
  if (threadIdx.x < 32) {
    float M = kNegInf;
    for (int s = lane; s < n_splits; s += 32) M = fmaxf(M, ml[2 * s]);
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int s = lane; s < n_splits; s += 32)
      L = fmaf(expf(ml[2 * s] - M), ml[2 * s + 1], L);
    for (int o = 16; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) {
      red[0] = M;
      red[1] = fmaxf(L, 1e-20f);
    }
  }
  __syncthreads();
  const float M = red[0];
  const float denom = red[1];
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s)
      a = fmaf(expf(ml[2 * s] - M), pa[static_cast<int64_t>(s) * hd + d], a);
    out[row * hd + d] = a / denom;
  }
}

template <typename T, int DL>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_map, const void* lengths, void* part_acc,
           void* part_ml, int B, int n_slots, int page, int KV, int hd,
           int G, int n_pages, int n_splits, int unmapped_reads_zero,
           int vec, cudaStream_t stream) {
  const Config cf = make_config(hd, G, sizeof(T));
  const int pps = (n_pages + n_splits - 1) / n_splits;
  const size_t smem = smem_bytes(cf, pps * page, sizeof(T));
  auto kern = paged_attention_split_kernel<T, DL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * KV * cf.n_hc, n_splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_map),
      static_cast<const int32_t*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), n_slots, page, KV, hd, G, n_pages, pps,
      unmapped_reads_zero, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              const void* page_map, const void* lengths, void* part_acc,
              void* part_ml, int B, int n_slots, int page, int KV, int hd,
              int G, int n_pages, int n_splits, int unmapped_reads_zero,
              cudaStream_t stream) {
  const int pps = (n_pages + n_splits - 1) / n_splits;
  const size_t smem = tc_smem_bytes(HDP, pps * page);
  auto kern = paged_attention_split_tc_kernel<HDP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * KV * ((G + kTcHeads - 1) / kTcHeads), n_splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool),
      static_cast<const int32_t*>(page_map),
      static_cast<const int32_t*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), n_slots, page, KV, hd, G, n_pages, pps,
      unmapped_reads_zero);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core route takes bf16 pools with 16-byte rows and hd <= 128
bool tc_route(int hd, int esize, bool aligned) {
  return esize == 2 && hd % 8 == 0 && hd <= 128 && aligned;
}

template <typename T>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const void* page_map, const void* lengths, void* part_acc,
                 void* part_ml, int B, int n_slots, int page, int KV, int hd,
                 int G, int n_pages, int n_splits, int unmapped_reads_zero,
                 cudaStream_t s) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(k_pool) |
                          reinterpret_cast<uintptr_t>(v_pool);
  const bool aligned = bases % 16 == 0;
  if (tc_route(hd, sizeof(T), aligned)) {
    if (hd <= 64)
      return launch_tc<64>(q, k_pool, v_pool, page_map, lengths, part_acc,
                           part_ml, B, n_slots, page, KV, hd, G, n_pages,
                           n_splits, unmapped_reads_zero, s);
    return launch_tc<128>(q, k_pool, v_pool, page_map, lengths, part_acc,
                          part_ml, B, n_slots, page, KV, hd, G, n_pages,
                          n_splits, unmapped_reads_zero, s);
  }
  const int vec = (hd * sizeof(T)) % 16 == 0 && aligned;
#define PA_ARGS                                                          \
  q, k_pool, v_pool, page_map, lengths, part_acc, part_ml, B, n_slots,   \
      page, KV, hd, G, n_pages, n_splits, unmapped_reads_zero, vec, s
  switch (make_config(hd, G, sizeof(T)).dl) {
    case 4: return launch<T, 4>(PA_ARGS);
    case 8: return launch<T, 8>(PA_ARGS);
    case 16: return launch<T, 16>(PA_ARGS);
    case 32: return launch<T, 32>(PA_ARGS);
    case 64: return launch<T, 64>(PA_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PA_ARGS
}

}  // namespace

// Bytes of dynamic shared memory one CTA of the split kernel needs, with
// n_splits splits of a page table of n_pages (the wrapper checks it
// against the card's limit before launching).
extern "C" long long paged_attention_smem_bytes(int page, int hd, int G,
                                                int n_pages, int n_splits,
                                                int pool_bf16) {
  const int esize = pool_bf16 ? 2 : 4;
  const int pps = (n_pages + n_splits - 1) / n_splits;
  // the CUDA-core route's need, and the tensor-core route's where it may
  // be taken (it is, unless a pool is not 16-byte aligned)
  size_t smem = smem_bytes(make_config(hd, G, esize), pps * page, esize);
  if (tc_route(hd, esize, true)) {
    const size_t tc = tc_smem_bytes(hd <= 64 ? 64 : 128, pps * page);
    smem = tc > smem ? tc : smem;
  }
  return static_cast<long long>(smem);
}

// Plain C entry point (loaded with ctypes).  q and out are fp32 [B, H, hd];
// the pools are fp32 (pool_bf16 = 0) or bf16 (pool_bf16 = 1); part_acc
// [B, H, n_splits, hd] and part_ml [B, H, n_splits, 2] are fp32 scratch.
// Two launches on `stream` (the split kernel, then the combine); does not
// synchronise, allocates nothing; returns the first CUDA error of the
// launches (0 on success), cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_map,
                                      const void* lengths, void* out,
                                      void* part_acc, void* part_ml, int B,
                                      int n_slots, int page, int KV, int hd,
                                      int G, int n_pages, int n_splits,
                                      int unmapped_reads_zero, int pool_bf16,
                                      void* stream) {
  if (B <= 0) return 0;
  if (n_splits < 1 || n_splits > n_pages || n_slots < 1 || page < 1 ||
      hd < 1 || G < 1 || KV < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      pool_bf16
          ? launch_split<bf16>(q, k_pool, v_pool, page_map, lengths,
                               part_acc, part_ml, B, n_slots, page, KV, hd,
                               G, n_pages, n_splits, unmapped_reads_zero, s)
          : launch_split<float>(q, k_pool, v_pool, page_map, lengths,
                                part_acc, part_ml, B, n_slots, page, KV, hd,
                                G, n_pages, n_splits, unmapped_reads_zero,
                                s);
  if (rc != 0) return rc;
  paged_attention_combine_kernel<<<B * KV * G, kThreads, 0, s>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<float*>(out), n_splits, hd);
  return static_cast<int>(cudaGetLastError());
}
