// Causal flash attention (forward) for Hopper (sm_90a): GQA, optional
// sliding window, online softmax in fp32.
//
// Replaces the TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:75, body `_kernel`).  For
// batch b, query head h (KV head h / G, G = H / KV) and query position s:
//   out[b, s, h] = sum_t softmax_t(scale * q[b, s, h] . k[b, t, h / G]) v[b, t, h / G]
// over the keys t <= s (and t > s - window when window > 0).  Scores are
// fp32 for fp32 and bf16 inputs alike; a masked score is the reference's
// finite -1e30 and its weight is set to 0 (with -inf a row with no visible
// key in a tile would give exp(-inf - -inf) = NaN); the output is
// acc / max(l, 1e-20) in q's dtype.
//
// What bounds it: operations.  At the model's prefill shape (S = 8192,
// H = 32, hd = 120, window 4096) the card must do 4 * hd * H flops per
// visible (query, key) pair, ~0.39 ms at the tensor cores' bf16 rate,
// against ~0.05 ms to move q, k, v and out once.
//
// Design (simple and right first; no tensor cores, TMA or wgmma yet): one CTA
// of 256 threads per (query tile of kBQ = 64 rows, query head, batch row),
// longest tiles launched first.  q, k and v are read in their own [B, S,
// heads, hd] layout.  The CTA walks only the key tiles (kBK = 64 keys) its
// rows can see, from max(0, q0 - window + 1) to q0 + kBQ - 1. Per key tile: K
// and V are staged in shared memory as fp32 (rows zero-padded, so any S and
// any hd <= 256 work, hd = 120 included); each thread computes a register tile
// of RM query rows x RN keys (float4 shared-memory reads, rows padded so a
// quarter-warp's reads hit distinct banks); the row max and sum are reduced
// over the 16 threads of a row group with shuffles; the weights P go through
// shared memory (over the consumed K tile) and each thread adds P V into its
// RM x (HDP / 16) fp32 accumulators.  On the card this runs on the CUDA cores'
// fp32 FMA rate (67 TFLOP/s at most), so it cannot come nearer than ~15x to
// the tensor-core bound: mma.sync / wgmma with hd padded to 128 is the next
// step.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;   // threads along the keys / output columns
constexpr int kTY = 16;   // threads along the query rows
constexpr int kBQ = 64;   // query rows per CTA
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Row stride (floats) of the Q and K tiles: a multiple of 4 (float4
// reads) with ld / 4 odd, so the 8 rows a quarter-warp reads at once fall
// into distinct banks.
__host__ __device__ inline int ld_qk(int hd) { return (hd + 7) / 8 * 8 + 4; }

__host__ __device__ inline size_t max_sz(size_t a, size_t b) {
  return a > b ? a : b;
}

// Shared memory, in floats: Q [kBQ][ld], K (later P [kBQ][kBK + 4]) and
// V [kBK][HDP].
__host__ __device__ inline size_t smem_floats(int hdp, int hd) {
  const size_t ld = ld_qk(hd);
  return kBQ * ld + max_sz(static_cast<size_t>(kBK) * ld,
                           static_cast<size_t>(kBQ) * (kBK + 4)) +
         static_cast<size_t>(kBK) * hdp;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, HDP <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q,   // [B, S, H, hd]
                       const T* __restrict__ k,   // [B, S, KV, hd]
                       const T* __restrict__ v,   // [B, S, KV, hd]
                       T* __restrict__ out,       // [B, S, H, hd]
                       int S, int H, int KV, int hd, float scale,
                       int window) {
  constexpr int RM = kBQ / kTY;    // query rows per thread
  constexpr int RN = kBK / kTX;    // keys per thread in the score tile
  constexpr int CN = HDP / 64;     // float4 output columns per thread
  constexpr int LDP = kBK + 4;
  extern __shared__ __align__(16) float smem[];
  const int ld = ld_qk(hd);
  const int hd4 = (hd + 3) & ~3;   // dot length; columns past hd are zero
  float* q_s = smem;
  float* kp_s = q_s + kBQ * ld;
  float* v_s = kp_s + max_sz(static_cast<size_t>(kBK) * ld,
                             static_cast<size_t>(kBQ) * LDP);

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const T* qb = q + static_cast<int64_t>(b) * S * q_row +
                static_cast<int64_t>(h) * hd;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_row +
                static_cast<int64_t>(kvh) * hd;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_row +
                static_cast<int64_t>(kvh) * hd;
  T* ob = out + static_cast<int64_t>(b) * S * q_row +
          static_cast<int64_t>(h) * hd;

  // ---- Q tile -> shared (fp32); rows past S and padding columns are 0
  for (int i = tid; i < kBQ * ld; i += kThreads) {
    const int r = i / ld;
    const int d = i - r * ld;
    const int s = q0 + r;
    q_s[i] = (s < S && d < hd) ? to_float(qb[s * q_row + d]) : 0.f;
  }

  float acc[RM][CN][4];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // only the key tiles some row of this query tile can see
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = min(q0 + kBQ - 1, S - 1);
  const int row0 = ty * RM;

  for (int t = k_lo / kBK; t <= k_hi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's P and V are consumed
    for (int i = tid; i < kBK * ld; i += kThreads) {
      const int r = i / ld;
      const int d = i - r * ld;
      const int s = k0 + r;
      kp_s[i] = (s < S && d < hd) ? to_float(kb[s * kv_row + d]) : 0.f;
    }
    for (int i = tid; i < kBK * HDP; i += kThreads) {
      const int r = i / HDP;
      const int d = i - r * HDP;
      const int s = k0 + r;
      v_s[i] = (s < S && d < hd) ? to_float(vb[s * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // ---- scores: rows row0 + i, keys k0 + tx + kTX * j
    float sc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (row0 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kp_s + (tx + kTX * j) * ld +
                                                 d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // ---- mask, online softmax over the 16 threads of each row group
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + row0 + i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kp = k0 + tx + kTX * j;
        const bool vis = kp <= qp && kp < S &&
                         (window <= 0 || kp > qp - window);
        ok |= static_cast<unsigned>(vis) << j;
        sc[i][j] = vis ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = (ok >> j) & 1u ? expf(sc[i][j] - m_new) : 0.f;
        sc[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < CN; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();   // every thread is done with the K tile
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        kp_s[(row0 + i) * LDP + tx + kTX * j] = sc[i][j];
    __syncthreads();

    // ---- acc += P V; this thread's columns are c * 64 + tx * 4 + [0, 4)
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(kp_s + (row0 + i) * LDP +
                                                 kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = v_s + (kk + u) * HDP + tx * 4;
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + c * 64);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  // ---- out = acc / max(l, 1e-20) in q's dtype
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + row0 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = ob + s * q_row;
#pragma unroll
    for (int c = 0; c < CN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < hd) store(orow + d, acc[i][c][e] / denom);
      }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, float scale, int window,
           cudaStream_t stream) {
  const size_t smem = smem_floats(HDP, hd) * sizeof(float);
  auto kern = flash_attention_kernel<T, HDP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, hd, scale,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int hd, float scale, int window,
              cudaStream_t s) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
  return launch<T, 256>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
}

int hd_pad(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

}  // namespace

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long flash_attention_smem_bytes(int hd) {
  return static_cast<long long>(smem_floats(hd_pad(hd), hd) * sizeof(float));
}

// Plain C entry point (loaded with ctypes).  q, out [B, S, H, hd] and k, v
// [B, S, KV, hd], contiguous, all fp32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); H % KV == 0, 1 <= hd <= 256.  Launches on `stream`, does
// not synchronise, allocates nothing; returns the CUDA error of the launch
// (0 on success), cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, float scale,
                                      int window, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd < 1 || hd > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, scale,
                                    window, s);
  return launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
}
