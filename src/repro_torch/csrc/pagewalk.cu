// Batched two-stage dense-table walk for Hopper (sm_90a).
//
// Replaces the TPU kernel `two_stage_translate_kernel`
// (src/repro/kernels/pagewalk/kernel.py:53, body `_kernel`).  For B
// queries (tenant t, request r, page p, want_write w):
//   stage 1: tp = vs_table[t, r, p], perm = vs_perm[t, r, p];
//            fault if tp < 0 or perm lacks the wanted R/W bit;
//   stage 2: slot = g_table[t, max(tp, 0)]; fault if slot < 0;
//   out: slot (-1 on fault), fault, stage (0 ok, 1 = VS stage, 2 = G stage).
//
// What bounds it: memory.  Each query reads 13 bytes of its own
// coordinates and writes 9 bytes of results, and gathers three int32
// table entries; there is no arithmetic to speak of.  At the realistic
// 8 tenants x 64 requests x 512 pages the stage-1 tables are 1 MiB each,
// so they are not staged in shared memory as the TPU kernel staged them
// in VMEM: the gathers are served from the 50 MB L2, and the bound is the
// bytes each query streams (inputs once, outputs once, each touched table
// entry once) over the 3.35 TB/s of device memory.
//
// Design: one thread per query, a plain grid-stride-free launch of
// ceil(B / 256) blocks.  Every coordinate is read as a JAX gather reads
// it: a negative one wraps once (i + n), then it is clamped into
// [0, n - 1].  So no input can read out of bounds, and the kernel agrees
// with the reference on out-of-range coordinates too (tp >= G reads
// g_table[t, G-1], tenant -1 reads the last tenant).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPermR = 1;
constexpr int kPermW = 2;
constexpr int kThreads = 256;

// JAX's gather rule for index v into a dimension of size n: wrap a
// negative index once, then clamp into [0, n - 1].
__device__ __forceinline__ int gather_index(int v, int n) {
  const int w = v < 0 ? v + n : v;
  return w < 0 ? 0 : (w >= n ? n - 1 : w);
}

__global__ void __launch_bounds__(kThreads)
pagewalk_kernel(const int32_t* __restrict__ vs_table,
                const int32_t* __restrict__ vs_perm,
                const int32_t* __restrict__ g_table,
                const int32_t* __restrict__ tenant,
                const int32_t* __restrict__ req,
                const int32_t* __restrict__ page,
                const uint8_t* __restrict__ want_write,
                int32_t* __restrict__ slot_out,
                uint8_t* __restrict__ fault_out,
                int32_t* __restrict__ stage_out,
                int B, int T, int R, int P, int G) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int t = gather_index(tenant[i], T);
  const int r = gather_index(req[i], R);
  const int p = gather_index(page[i], P);
  const int64_t flat1 = (static_cast<int64_t>(t) * R + r) * P + p;
  const int tp = __ldg(vs_table + flat1);
  const int perm = __ldg(vs_perm + flat1);
  const int want = want_write[i] ? kPermW : kPermR;
  const bool s1 = (tp < 0) || ((perm & want) == 0);
  const int slot = __ldg(g_table + static_cast<int64_t>(t) * G +
                         gather_index(tp < 0 ? 0 : tp, G));
  const bool s2 = !s1 && (slot < 0);
  const bool fault = s1 || s2;
  slot_out[i] = fault ? -1 : slot;
  fault_out[i] = fault ? 1 : 0;
  stage_out[i] = s1 ? 1 : (s2 ? 2 : 0);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int pagewalk_launch(const void* vs_table, const void* vs_perm,
                               const void* g_table, const void* tenant,
                               const void* req, const void* page,
                               const void* want_write, void* slot_out,
                               void* fault_out, void* stage_out, int B, int T,
                               int R, int P, int G, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  pagewalk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vs_table),
      static_cast<const int32_t*>(vs_perm),
      static_cast<const int32_t*>(g_table),
      static_cast<const int32_t*>(tenant), static_cast<const int32_t*>(req),
      static_cast<const int32_t*>(page),
      static_cast<const uint8_t*>(want_write),
      static_cast<int32_t*>(slot_out), static_cast<uint8_t*>(fault_out),
      static_cast<int32_t*>(stage_out), B, T, R, P, G);
  return static_cast<int>(cudaGetLastError());
}
