// Causal flash attention (forward) for Hopper (sm_90a): GQA, optional
// sliding window, online softmax in fp32.
//
// Replaces the TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py:75, body `_kernel`).  For
// batch b, query head h (KV head h / G, G = H / KV) and query position s:
//   out[b, s, h] = sum_t softmax_t(scale * q[b, s, h] . k[b, t, h / G]) v[b, t, h / G]
// over the keys t <= s (and t > s - window when window > 0).  Scores are
// fp32; a masked score is the reference's finite -1e30 and its weight is
// set to 0 (with -inf a row with no visible key in a tile would give
// exp(-inf - -inf) = NaN); the output is acc / max(l, 1e-20) in q's dtype.
//
// What bounds it: operations.  The card must do 4 * hd flops per visible
// (query, key) pair and query head: at the model's prefill shape (S = 8192,
// H = 32, hd = 120, window 4096) ~0.39 ms at the tensor cores' bf16 rate,
// against ~0.05 ms to move q, k, v and out once.
//
// Two kernels, chosen by dtype in `flash_attention_launch` (not a
// fallback: each dtype has exactly one kernel, and a call either kernel
// refuses raises):
//
// * bf16 q, k, v (every prefill of the model path): the tensor-core
//   kernel `flash_attention_tc_kernel`, FlashAttention-2's shape.  One CTA
//   of 4 warps per (query tile, query head, batch row), longest tiles
//   launched first; the CTA walks only the key tiles its rows can see.  hd
//   is padded with zeros to HDP in {64, 128, 256} (hd = 120 -> 128: +6.7 %
//   work).  At HDP <= 128 each warp owns two 16-row MMA tiles (query
//   tiles of 128 rows), so every K and V fragment read from shared memory
//   feeds two MMAs, and key tiles are 64 keys (32 with element loads); at
//   HDP 256 a warp owns one row tile and key tiles are 32 keys.  Q, K and
//   V stay bf16 in shared memory in an XOR-swizzled layout (16-byte chunk
//   c of row r at chunk c ^ (r & 7)), so `ldmatrix` reads 8 rows without
//   bank conflicts.  K/V tiles go through two stages filled by 16-byte
//   `cp.async` with zero fill (rows past S, columns past hd), so tile
//   t + 1 loads while tile t computes.  S = Q K^T is
//   `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), the Q A-fragments
//   re-read from shared memory each key tile (registers hold the
//   accumulators: at HDP 128 the kernel uses 255 with no spills).  The
//   causal / window mask is applied only on tiles that cross the diagonal
//   or the window edge.  The online softmax runs on the accumulator
//   fragments, its row max in raw score units, so a weight costs one FMA
//   and one `ex2.approx` (2^(s * scale * log2 e - m * scale * log2 e)); the
//   row max is reduced over a quad by shuffles, the row sum kept per thread
//   and reduced once at the end, and the accumulator's rescale is skipped
//   where no row max of the warp moved.  P is rounded to bf16 in registers
//   (as JAX's attention_core rounds its weights) and used directly as the
//   A operand of the P V `mma`; V comes in through `ldmatrix.trans`; P
//   never goes through shared memory.  Rows past S are never stored.
//   Where hd * 2 bytes is not a multiple of 16 or a base pointer is not
//   16-byte aligned, the same kernel (template flag VEC = false) loads
//   element by element.  The kernel is issue-bound (softmax and rescale
//   instructions between the MMAs), not bound by the tensor cores: no
//   wgmma or TMA yet.
//
// * fp32 q, k, v: the SIMT kernel `flash_attention_kernel` (the tensor
//   cores in TF32 cannot meet the fp32 tolerance of 2e-5).  One CTA of 256
//   threads per (64-row query tile, query head, batch row); per 64-key
//   tile, K and V are staged in shared memory as fp32 (rows zero-padded,
//   so any S and any hd <= 256 work); each thread computes a register tile
//   of RM query rows x RN keys with float4 shared-memory reads; the row
//   max and sum are reduced over the 16 threads of a row group with
//   shuffles; P goes through shared memory and each thread adds P V into
//   its RM x (HDP / 16) fp32 accumulators, on the CUDA cores' fp32 FMAs.
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;   // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// HDP <= 128: 2 row tiles of 16 a warp (each K and V fragment feeds two
// MMAs), 64-key tiles; 32-key tiles with element loads, whose loops would
// push the 64-key tile past 255 registers.  HDP 256: 1 row tile (the
// accumulator alone takes 128 registers), 32-key tiles.
template <int HDP, bool VEC>
struct Shape {
  static constexpr int MT = HDP <= 128 ? 2 : 1;           // row tiles a warp
  static constexpr int BQ = 4 * 16 * MT;                  // query rows a CTA
  static constexpr int BK = HDP <= 128 && VEC ? 64 : 32;  // keys a tile
  // Q [BQ][HDP], then K and V, each [2 stages][BK][HDP], all bf16
  static constexpr size_t kSmemBytes =
      (static_cast<size_t>(BQ) + 4 * BK) * HDP * sizeof(bf16);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of 16-byte chunk c of row r in a [rows][HDP] bf16 tile
template <int HDP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * HDP + ((c ^ (r & 7)) << 3);
}

// 16-byte copy; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// 2^x on the SFU (one instruction; relative error ~2^-22, flushes to 0
// below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of a row-major bf16 matrix with `stride` elements
// per row (columns [0, hd)) into a swizzled [ROWS][HDP] tile; rows past S
// and columns past hd read as zero.  VEC: 16-byte cp.async (needs hd % 8
// == 0 and 16-byte aligned bases); else element by element.
template <int ROWS, int HDP, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int64_t stride, int hd,
                                          int tid) {
  if constexpr (VEC) {
    constexpr int C = HDP / 8;
    for (int i = tid; i < ROWS * C; i += kThreads) {
      const int r = i / C;
      const int c = i - r * C;
      const int s = r0 + r;
      const bool ok = s < S && c * 8 < hd;
      cp_async16(dst + swz<HDP>(r, c), ok ? src + s * stride + c * 8 : src,
                 ok);
    }
  } else {
    for (int i = tid; i < ROWS * HDP; i += kThreads) {
      const int r = i / HDP;
      const int d = i - r * HDP;
      const int s = r0 + r;
      dst[swz<HDP>(r, d >> 3) + (d & 7)] =
          (s < S && d < hd) ? src[s * stride + d] : __float2bfloat16(0.f);
    }
  }
}

template <int HDP, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_tc_kernel(const bf16* __restrict__ q,   // [B, S, H, hd]
                          const bf16* __restrict__ k,   // [B, S, KV, hd]
                          const bf16* __restrict__ v,   // [B, S, KV, hd]
                          bf16* __restrict__ out,       // [B, S, H, hd]
                          int S, int H, int KV, int hd, float scale_log2,
                          int window) {
  using Sh = Shape<HDP, VEC>;
  constexpr int MT = Sh::MT;
  constexpr int BQ = Sh::BQ;
  constexpr int BK = Sh::BK;
  constexpr int NT = BK / 8;     // score tiles of 8 keys
  constexpr int KS = HDP / 16;   // k-steps over the head dim
  constexpr int DT = HDP / 8;    // output tiles of 8 columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * HDP;
  bf16* v_s = k_s + 2 * BK * HDP;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16 * MT;   // this warp's first row
  const int g = lane >> 2;               // fragment row (and row + 8)
  const int t4 = lane & 3;               // fragment column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const int64_t q_row = static_cast<int64_t>(H) * hd;
  const int64_t kv_row = static_cast<int64_t>(KV) * hd;
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_row +
                   static_cast<int64_t>(h) * hd;
  const bf16* kb = k + static_cast<int64_t>(b) * S * kv_row +
                   static_cast<int64_t>(kvh) * hd;
  const bf16* vb = v + static_cast<int64_t>(b) * S * kv_row +
                   static_cast<int64_t>(kvh) * hd;
  bf16* ob = out + static_cast<int64_t>(b) * S * q_row +
             static_cast<int64_t>(h) * hd;

  // only the key tiles some row of this query tile can see
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = min(q0 + BQ - 1, S - 1);
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi / BK;

  load_tile<BQ, HDP, VEC>(q_s, qb, q0, S, q_row, hd, tid);
  load_tile<BK, HDP, VEC>(k_s, kb, t_lo * BK, S, kv_row, hd, tid);
  load_tile<BK, HDP, VEC>(v_s, vb, t_lo * BK, S, kv_row, hd, tid);
  cp_async_commit();

  float o[MT][DT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][dt][e] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t < t_hi) {   // tile t + 1 into the other stage, in flight
      const int n0 = (t + 1) * BK;
      load_tile<BK, HDP, VEC>(k_s + (st ^ 1) * BK * HDP, kb, n0, S, kv_row,
                              hd, tid);
      load_tile<BK, HDP, VEC>(v_s + (st ^ 1) * BK * HDP, vb, n0, S, kv_row,
                              hd, tid);
    }
    cp_async_commit();
    cp_async_wait1();   // everything but tile t + 1 has landed
    __syncthreads();
    const bf16* kt = k_s + st * BK * HDP;
    const bf16* vt = v_s + st * BK * HDP;

    // ---- S = Q K^T, 16 * MT rows x BK keys per warp; each K fragment
    // serves the warp's MT row tiles, the Q fragments are re-read from
    // shared memory (registers hold the accumulators)
    float sc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], q_s + swz<HDP>(wr + 16 * i + (lane & 15),
                                     2 * ks + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bq[4];
        ldsm_x4(bq, kt + swz<HDP>(j * 8 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma(sc[i][j], a[i], bq[0], bq[1]);
          mma(sc[i][j + 1], a[i], bq[2], bq[3]);
        }
      }
    }

    // ---- mask (only where the tile crosses the diagonal or the window
    // edge) and online softmax; this thread holds rows g and g + 8 of each
    // row tile.  m is kept in raw score units (scale > 0), so a weight is
    // 2^(s * scale_log2 - m * scale_log2): one FMA and one SFU op a score
    const int k0 = t * BK;
    const bool full = k0 + BK - 1 <= q0 &&
                      (window <= 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (!full) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = q0 + wr + 16 * i + g + ((e >> 1) << 3);
            const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
            const bool vis = kp <= qp && (window <= 0 || kp > qp - window);
            sc[i][j][e] = vis ? sc[i][j][e] : kNegInf;
          }
      }
      float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][j][e]);
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[i][r] - mx[r]) * scale_log2);
        m[i][r] = mx[r];
        mc[r] = mx[r] * scale_log2;
        l[i][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = sc[i][j][e];
          float p = ex2(fmaf(s, scale_log2, -mc[e >> 1]));
          // a masked score's weight is 0 (also where the whole row is
          // masked so far and s - m = 0)
          if (!full) p = s <= kNegInf ? 0.f : p;
          sc[i][j][e] = p;
          l[i][e >> 1] += p;
        }
      // the rescale costs DT * 4 multiplies a thread; skip it where no
      // row max of the warp moved (most tiles once the maxima settle)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          o[i][dt][0] *= alpha[0];
          o[i][dt][1] *= alpha[0];
          o[i][dt][2] *= alpha[1];
          o[i][dt][3] *= alpha[1];
        }
      }
    }

    // ---- O += P V, P (bf16) straight from the score fragments; each V
    // fragment serves the warp's MT row tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a[i][0] = pack_bf16(sc[i][2 * kk][0], sc[i][2 * kk][1]);
        a[i][1] = pack_bf16(sc[i][2 * kk][2], sc[i][2 * kk][3]);
        a[i][2] = pack_bf16(sc[i][2 * kk + 1][0], sc[i][2 * kk + 1][1]);
        a[i][3] = pack_bf16(sc[i][2 * kk + 1][2], sc[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + swz<HDP>(kk * 16 + (lane & 7) +
                                            (((lane >> 3) & 1) << 3),
                                        dt + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma(o[i][dt], a[i], bv[0], bv[1]);
          mma(o[i][dt + 1], a[i], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // stage st is free for tile t + 2
  }

  // ---- out = acc / max(l, 1e-20) in bf16; rows past S are not stored
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 1);
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 2);
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = q0 + wr + 16 * i + g + 8 * r;
      if (s >= S) continue;
      const float denom = fmaxf(l[i][r], 1e-20f);
      bf16* orow = ob + s * q_row;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int d = dt * 8 + 2 * t4;
        if (d < hd) orow[d] = __float2bfloat16(o[i][dt][2 * r] / denom);
        if (d + 1 < hd)
          orow[d + 1] = __float2bfloat16(o[i][dt][2 * r + 1] / denom);
      }
    }
}

template <int HDP, bool VEC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int hd, float scale, int window,
           cudaStream_t stream) {
  using Sh = Shape<HDP, VEC>;
  const size_t smem = Sh::kSmemBytes;
  auto kern = flash_attention_tc_kernel<HDP, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + Sh::BQ - 1) / Sh::BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, hd,
      scale * kLog2e, window);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int hd, float scale, int window,
              cudaStream_t s) {
  if (hd <= 64)
    return launch<64, VEC>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
  if (hd <= 128)
    return launch<128, VEC>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
  return launch<256, VEC>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
}

}  // namespace tc

}  // namespace

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long flash_attention_smem_bytes(int hd, int is_bf16) {
  const int hdp = hd_pad(hd);
  if (is_bf16)
    return static_cast<long long>(
        hdp == 64    ? tc::Shape<64, true>::kSmemBytes
        : hdp == 128 ? tc::Shape<128, true>::kSmemBytes
                     : tc::Shape<256, true>::kSmemBytes);
  return static_cast<long long>(smem_floats(hdp, hd) * sizeof(float));
}

// Plain C entry point (loaded with ctypes).  q, out [B, S, H, hd] and k, v
// [B, S, KV, hd], contiguous, all fp32 (is_bf16 = 0: the SIMT kernel) or
// all bf16 (is_bf16 = 1: the tensor-core kernel, 16-byte loads where hd %
// 8 == 0 and every base is 16-byte aligned, else element loads); H % KV ==
// 0, 1 <= hd <= 256.  Launches on `stream`, does not synchronise,
// allocates nothing; returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, float scale,
                                      int window, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd < 1 || hd > 256 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                            reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) |
                            reinterpret_cast<uintptr_t>(out);
    if (hd % 8 == 0 && bases % 16 == 0)
      return tc::launch_hd<true>(q, k, v, out, B, S, H, KV, hd, scale,
                                 window, s);
    return tc::launch_hd<false>(q, k, v, out, B, S, H, KV, hd, scale, window,
                                s);
  }
  return launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale, window, s);
}
