// Paged decode attention for Hopper (sm_90a): one query token per request
// over the K/V pages its page table names, GQA, online softmax.
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
//
// What bounds it: memory.  Decode reads every K and V row below the length
// once and does 4 * hd flops per (query head, token) for G = 8 query heads
// per row: about 4 flops per byte of bf16 K/V, far below the ~295 at which
// the tensor cores would be the limit.  The bound is the K/V bytes this
// run's lengths need over the 3.35 TB/s of device memory.
//
// Design (simple and right first): one CTA per (request, KV head), so each
// K/V page read is shared by the G query heads of its group.  The CTA
// loops over only the pages below ceil(length / page); for each it loads
// the K and V page (page x hd, fp32 or bf16, converted to fp32) into
// shared memory, computes the G x page scores (one thread per score, fp32
// dot over hd in four partial sums), runs the online softmax (one warp
// per query head, state m and l in shared memory) and accumulates
// acc[G][hd] (eight outputs per thread at a time in registers, kept in
// shared memory between pages).  Every FMA reads two shared-memory
// operands, so on the card this version is bound by shared-memory
// bandwidth, far above the byte bound; tensor cores, TMA and a split over
// pages are for a later version.  A single-request call (B = 1) launches
// only KV CTAs.  Pool slots are clamped into [0, n_slots - 1], so no page
// table entry can read outside the pool.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 8;   // P.V outputs a thread accumulates at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats: K page (rows padded to hd + 1 so the score
// threads of one warp, which read 16 or 32 different rows, hit different
// banks), V page, q, acc, scores, and m, l, alpha per query head.
__host__ __device__ inline size_t smem_floats(int page, int hd, int G) {
  return static_cast<size_t>(page) * (hd + 1) +
         static_cast<size_t>(page) * hd + 2 * static_cast<size_t>(G) * hd +
         static_cast<size_t>(G) * page + 3 * static_cast<size_t>(G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,       // [B, H, hd]
                       const T* __restrict__ k_pool,      // [S, page, KV, hd]
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ page_map,  // [B, n_pages]
                       const int32_t* __restrict__ lengths,   // [B]
                       float* __restrict__ out,               // [B, H, hd]
                       int n_slots, int page, int KV, int hd, int G,
                       int n_pages, int unmapped_reads_zero) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* k_s = smem;
  float* v_s = k_s + page * ldk;
  float* q_s = v_s + page * hd;
  float* acc = q_s + G * hd;
  float* s_s = acc + G * hd;
  float* m_s = s_s + G * page;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[b];
  const bool uniform = unmapped_reads_zero && length <= 0;

  const int64_t head0 = static_cast<int64_t>(b) * KV * G + kvh * G;
  const float* qb = q + head0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = qb[i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int64_t total = static_cast<int64_t>(n_pages) * page;
  int steps;
  if (uniform || length >= total) {
    steps = n_pages;
  } else {
    steps = length <= 0 ? 0 : (length + page - 1) / page;
  }
  const int64_t tok_stride = static_cast<int64_t>(KV) * hd;
  const int64_t slot_stride = tok_stride * page;
  __syncthreads();

  for (int p = 0; p < steps; ++p) {
    const int entry = page_map[static_cast<int64_t>(b) * n_pages + p];
    const bool mapped = entry >= 0;
    // the whole CTA takes this branch together
    if (!mapped && !unmapped_reads_zero) continue;
    const int slot = entry < 0 ? 0 : (entry >= n_slots ? n_slots - 1 : entry);
    const int64_t base = slot * slot_stride + static_cast<int64_t>(kvh) * hd;

    // ---- K and V page -> shared (fp32); an unmapped page reads zeros
    for (int i = tid; i < page * hd; i += kThreads) {
      const int t = i / hd;
      const int d = i - t * hd;
      float kk = 0.f, vv = 0.f;
      if (mapped) {
        const int64_t off = base + t * tok_stride + d;
        kk = to_float(k_pool[off]);
        vv = to_float(v_pool[off]);
      }
      k_s[t * ldk + d] = kk;
      v_s[t * hd + d] = vv;
    }
    __syncthreads();

    // ---- scores: one thread per (query head, token)
    for (int i = tid; i < G * page; i += kThreads) {
      const int g = i / page;
      const int t = i - g * page;
      float s = kNegInf;
      if (uniform) {
        s = 0.f;
      } else if (p * page + t < length) {
        const float* qg = q_s + g * hd;
        const float* kt = k_s + t * ldk;
        // four independent partial sums, so the shared-memory loads and
        // FMAs of one thread overlap instead of forming one long chain
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        int d = 0;
        for (; d + 4 <= hd; d += 4) {
          d0 = fmaf(qg[d], kt[d], d0);
          d1 = fmaf(qg[d + 1], kt[d + 1], d1);
          d2 = fmaf(qg[d + 2], kt[d + 2], d2);
          d3 = fmaf(qg[d + 3], kt[d + 3], d3);
        }
        for (; d < hd; ++d) d0 = fmaf(qg[d], kt[d], d0);
        s = (d0 + d1) + (d2 + d3);
      }
      s_s[i] = s;
    }
    __syncthreads();

    // ---- online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const bool valid = uniform || p * page + t < length;
        const float e = valid ? expf(sg[t] - m_new) : 0.f;
        sg[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // ---- acc[g][d] = acc * alpha + sum_t p[g][t] v[t][d]; a thread keeps
    // kOut outputs in registers, kOut independent chains over the tokens
    for (int i0 = 0; i0 < G * hd; i0 += kThreads * kOut) {
      float a[kOut];
      const float* pg[kOut];
      const float* vd[kOut];
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int i = min(i0 + k * kThreads + tid, G * hd - 1);
        const int g = i / hd;
        a[k] = acc[i] * a_s[g];
        pg[k] = s_s + g * page;
        vd[k] = v_s + (i - g * hd);
      }
      for (int t = 0; t < page; ++t) {
#pragma unroll
        for (int k = 0; k < kOut; ++k)
          a[k] = fmaf(pg[k][t], vd[k][t * hd], a[k]);
      }
#pragma unroll
      for (int k = 0; k < kOut; ++k) {
        const int i = i0 + k * kThreads + tid;
        if (i < G * hd) acc[i] = a[k];
      }
    }
    __syncthreads();
  }

  float* ob = out + head0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    ob[i] = acc[i] / fmaxf(l_s[i / hd], 1e-20f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_map, const void* lengths, void* out, int B,
           int n_slots, int page, int KV, int hd, int G, int n_pages,
           int unmapped_reads_zero, cudaStream_t stream) {
  const size_t smem = smem_floats(page, hd, G) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_map),
      static_cast<const int32_t*>(lengths), static_cast<float*>(out),
      n_slots, page, KV, hd, G, n_pages, unmapped_reads_zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long paged_attention_smem_bytes(int page, int hd, int G) {
  return static_cast<long long>(smem_floats(page, hd, G) * sizeof(float));
}

// Plain C entry point (loaded with ctypes).  q and out are fp32 [B, H, hd];
// the pools are fp32 (pool_bf16 = 0) or bf16 (pool_bf16 = 1).  Launches on
// `stream`, does not synchronise, allocates nothing; returns the CUDA error
// of the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_map,
                                      const void* lengths, void* out, int B,
                                      int n_slots, int page, int KV, int hd,
                                      int G, int n_pages,
                                      int unmapped_reads_zero, int pool_bf16,
                                      void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pool_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_map, lengths, out,
                                 B, n_slots, page, KV, hd, G, n_pages,
                                 unmapped_reads_zero, s);
  return launch<float>(q, k_pool, v_pool, page_map, lengths, out, B,
                       n_slots, page, KV, hd, G, n_pages, unmapped_reads_zero,
                       s);
}
