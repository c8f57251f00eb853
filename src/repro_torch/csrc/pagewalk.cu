// Batched two-stage dense-table walk for Hopper (sm_90a).
//
// Replaces the TPU kernel `two_stage_translate_kernel`
// (src/repro/kernels/pagewalk/kernel.py:53, body `_kernel`).  For each
// query (tenant t, request r, page p, want_write w):
//   stage 1: tp = vs_table[t, r, p], perm = vs_perm[t, r, p];
//            fault if tp < 0 or perm lacks the wanted R/W bit;
//   stage 2: slot = g_table[t, max(tp, 0)]; fault if slot < 0;
//   out: slot (-1 on fault), fault, stage (0 ok, 1 = VS stage, 2 = G stage).
// With the fused cache (`fused`, `fused_ok`, optional) it is the whole of
// JAX's `page_table.translate` (src/repro/core/vmem/page_table.py:66-90):
// where fused_ok[t, r, p] holds, the answer is (fused[t, r, p], no fault,
// stage 0).  Every coordinate, and tp, is read as a JAX gather reads it:
// a negative one wraps once (i + n), then it is clamped into [0, n - 1].
//
// What bounds it.  At the table sweep (8 tenants x 64 requests x 512
// pages, B = 262,144 shuffled queries) 13 B of coordinates come in and
// 9 B of results go out a query, and each query makes up to three
// dependent 4-byte gathers into 2.1 MiB of tables (vs_table and vs_perm,
// then g_table), each a scattered 32-byte sector.  Taken apart on the
// card (chip_smoke.py, pagewalk phase): of the first design's 13.86 us,
// 5.50 us is the fixed cost of a launch between two events; a copy of
// the same bytes takes 7.97 us and the same walk in table order 10.14
// us, so the rest is the scattered gathers.  In trials neither more loads
// in flight a thread (4 or 8 queries a thread, 16-byte coordinate loads),
// nor fewer or more CTAs, nor an L2 prefetch of the tables made them
// faster.  At its consumers' small shapes (one request's 256 pages; one
// coordinate of the control plane) it is one launch and three dependent
// memory round trips.  So the design:
//
//  * Fewer gathers: a walk whose grid strides (throughput-bound) skips
//    the stage-2 gather of a stage-1 fault; every walk skips it for an
//    unmapped tp or a fused hit.  A smaller walk issues stage 2 as soon
//    as tp is in, without waiting for the permission check.
//  * Gathers and the coordinate stream overlapped: a grid of at most four
//    256-thread CTAs an SM (`kernel.grid_size`) strides over the queries,
//    and each thread loads its next query's coordinates behind the
//    current query's gathers.
//  * Translate in one launch (the consumers' shapes): a coordinate is a
//    value passed by argument (no host-to-device copy), or elements at
//    base + o * s_outer + i * s_inner over an [outer, inner] grid of
//    queries (0 for a broadcast dimension), or, with no base, value +
//    o * s_outer + i * s_inner (translate_block's page range).  So the
//    fused select and the broadcast of JAX's translate cost no kernel of
//    their own, and a coordinate given by value costs no load.  The TPU
//    kernel's own case, four flat vectors, is the grid (1, B).
#include <cstdint>
#include <cuda_runtime.h>

// One coordinate (or want_write) of the [outer, inner] query grid; the
// layout of `kernel._CoordArg` on the Python side.
struct Coord {
  const void* ptr;     // elements to read; nullptr: computed from `value`
  long long s_outer;   // element strides
  long long s_inner;
  int value;
  int bytes;           // element size of `ptr`: 4 or 8 (int), 1 (bool)
};

namespace {

constexpr int kPermR = 1;
constexpr int kPermW = 2;
constexpr int kThreads = 256;

struct Tables {
  const int32_t* vs_table;
  const int32_t* vs_perm;
  const int32_t* g_table;
  const int32_t* fused;      // nullptr: no fused cache
  const uint8_t* fused_ok;
  int32_t* slot_out;
  uint8_t* fault_out;
  int32_t* stage_out;
  int n, T, R, P, G;
  int strides;               // the grid strides: gate stage 2 on perm too
};

struct GridCoords {
  Coord c[4];                // tenant, req, page, want_write
  int inner;
  int need_oi;               // some coordinate needs (o, i) = divmod(q, inner)
};

struct Query {
  int t, r, p, w;
};

// JAX's gather rule for index v into a dimension of size n: wrap a
// negative index once, then clamp into [0, n - 1].
__device__ __forceinline__ int gather_index(int v, int n) {
  const int w = v < 0 ? v + n : v;
  return w < 0 ? 0 : (w >= n ? n - 1 : w);
}

__device__ __forceinline__ int read_coord(const Coord& c, int o, int i) {
  const long long off = o * c.s_outer + i * c.s_inner;
  if (c.ptr == nullptr) return static_cast<int>(c.value + off);
  if (c.bytes == 8)
    return static_cast<int>(
        __ldg(static_cast<const long long*>(c.ptr) + off));
  if (c.bytes == 1)
    return __ldg(static_cast<const unsigned char*>(c.ptr) + off) != 0;
  return __ldg(static_cast<const int*>(c.ptr) + off);
}

__device__ __forceinline__ Query read_grid(const GridCoords& c, int q) {
  // without a divmod, (0, q) serves constant and flat coordinates
  const int o = c.need_oi ? q / c.inner : 0;
  const int i = c.need_oi ? q - o * c.inner : q;
  return {read_coord(c.c[0], o, i), read_coord(c.c[1], o, i),
          read_coord(c.c[2], o, i), read_coord(c.c[3], o, i)};
}

// The grid-stride walk: this thread's queries q, q + stride, ..., the
// next one's coordinates loaded behind the current one's gathers.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
pagewalk_kernel(const Tables tb, const GridCoords c) {
  const int stride = gridDim.x * blockDim.x;
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= tb.n) return;
  Query cur = read_grid(c, q);
  for (; q < tb.n; q += stride) {
    const int t = gather_index(cur.t, tb.T);
    const long long f1 = (static_cast<long long>(t) * tb.R +
                          gather_index(cur.r, tb.R)) * tb.P +
                         gather_index(cur.p, tb.P);
    const int tp = __ldg(tb.vs_table + f1);
    const int perm = __ldg(tb.vs_perm + f1);
    const bool hit = kFused && __ldg(tb.fused_ok + f1);
    const int fused = kFused ? __ldg(tb.fused + f1) : 0;
    const int want = cur.w ? kPermW : kPermR;
    if (q + stride < tb.n) cur = read_grid(c, q + stride);
    const bool s1 = (tp < 0) || ((perm & want) == 0);
    // a throughput-bound walk skips the gathers a permission fault
    // discards; a latency-bound one issues stage 2 as soon as tp is in
    const bool skip = hit || (tb.strides ? s1 : tp < 0);
    int slot = skip ? -1
                    : __ldg(tb.g_table + static_cast<long long>(t) * tb.G +
                            gather_index(tp, tb.G));
    int stage = s1 ? 1 : (slot < 0 && !hit ? 2 : 0);
    if (stage != 0) slot = -1;
    if (hit) {
      slot = fused;
      stage = 0;
    }
    tb.slot_out[q] = slot;
    tb.stage_out[q] = stage;
    tb.fault_out[q] = stage != 0;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches `grid` CTAs of 256
// threads on `stream`; does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch.
extern "C" int pagewalk_launch(const void* vs_table, const void* vs_perm,
                               const void* g_table, const void* fused,
                               const void* fused_ok, void* slot_out,
                               void* fault_out, void* stage_out,
                               Coord tenant, Coord req, Coord page,
                               Coord want, int outer, int inner, int T,
                               int R, int P, int G, int grid,
                               void* stream) {
  const Tables tb{static_cast<const int32_t*>(vs_table),
                  static_cast<const int32_t*>(vs_perm),
                  static_cast<const int32_t*>(g_table),
                  static_cast<const int32_t*>(fused),
                  static_cast<const uint8_t*>(fused_ok),
                  static_cast<int32_t*>(slot_out),
                  static_cast<uint8_t*>(fault_out),
                  static_cast<int32_t*>(stage_out),
                  outer * inner, T, R, P, G,
                  outer * inner > grid * kThreads};
  if (tb.n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GridCoords c{{tenant, req, page, want}, inner, 0};
  // (o, i) = (0, q) serves every coordinate unless the grid has several
  // rows and some coordinate is neither constant nor flat
  if (outer > 1)
    for (const Coord& x : c.c)
      c.need_oi |= !(x.s_inner == 1 && x.s_outer == inner) &&
                   (x.s_outer != 0 || x.s_inner != 0);
  if (fused != nullptr)
    pagewalk_kernel<true><<<grid, kThreads, 0, s>>>(tb, c);
  else
    pagewalk_kernel<false><<<grid, kThreads, 0, s>>>(tb, c);
  return static_cast<int>(cudaGetLastError());
}
