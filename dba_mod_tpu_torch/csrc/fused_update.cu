// Fused per-step client-state update for the stacked [C, ...] client axis.
//
// Replaces dba_mod_tpu/ops/fused_update.py::_build_kernel (the Pallas TPU
// kernel launched by _run_chunks and dispatched from the custom_vmap batch
// rule of make_fused_step_update). Per leaf kind, with a per-client lr[c] and
// valid[c]:
//
//   sgd      g' = g + wd*w ; m' = mu*m + g' ; w' = w - lr[c]*m'  (w, m updated)
//   sgd_acc  the sgd update, and fg' = fg + g                  (w, m, fg)
//   sel      bn_old' = bn_new                                  (bn_old updated)
//
// each applied only where valid[c] != 0. sgd_acc is the FoolsGold case: the
// Pallas kernel has separate sgd and acc leaves that read g twice; here one
// leaf reads g once and writes w, m and the accumulator fg. The JAX version
// is functional and returns where(valid, new, old); this kernel updates w, m,
// fg and bn_old IN PLACE, which saves writing a second copy of the whole
// client state every step. An invalid client's rows are neither read nor
// written.
//
// What bounds it: device-memory bytes. An sgd value reads w, g, m and writes
// w, m: 20 B (28 B for sgd_acc: fg is read and written too). On the CIFAR
// ResNet-18 state (2,797,610 parameters, 4,800 BN running-stat values) at
// C = 10 that is about 560 MB per step (784 MB with FoolsGold), so the least
// time at the H100's 3.35 TB/s is about 0.17 ms (0.23 ms); the arithmetic
// (6-7 flops per value) is three orders of magnitude below the fp32 peak.
//
// Design: ONE launch covers every leaf of every rank and every client, so the
// step does not pay ~100 elementwise launches. The host passes a table by
// value: a pool of pointers (each leaf's 2-4 pointers, in the order listed
// above), and per leaf its kind, elements per client, first pool entry and
// first tile. The table stays under the 4 KB kernel-parameter limit with
// kMaxLeaves leaves and kMaxPtrs pointers; the wrapper chunks longer lists,
// as multi_tensor_apply does (the CIFAR ResNet-18 state needs one table with
// FoolsGold on or off). The work is cut into tiles of kTile elements of one
// client's row of one leaf; block b finds its leaf by binary search over the
// tiles' prefix sums, so large and small leaves share the grid evenly. Rows
// whose pointers are 16-byte aligned use float4 loads and stores.
//
// Sizes: the full Tiny-ImageNet ResNet-18 (11,279,112 parameters, 9,600 BN
// values per client) has the same 62 + 40 leaves as the CIFAR net; its
// largest leaf holds 2,359,296 values per client, and at C = 10 a step is
// about 28.5 k tiles of one launch (2.26 GB moved, 3.16 GB with FoolsGold).
// Every int index below stays under n + kTile or the tile count, which the
// wrapper checks against INT_MAX (ops/fused_update.py::_layout); the
// client's row offset is taken in size_t. LoanNet's 6 leaves are rows of
// 9 to 4,186 values: rows whose length or address is not a multiple of 4
// take the scalar loop.
//
// Rounding: every product and sum is an explicit round-to-nearest intrinsic
// (and the library is built with -fmad=false), in the JAX order of operations,
// so the result is bitwise equal to the plain PyTorch version
// (dba_mod_tpu_torch/ops/fused_update.py::fused_step_update_reference).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 120;
constexpr int kMaxPtrs = 336;     // with kMaxLeaves, keeps the parameters
                                  // (table + 28 B of scalars) under 4 KB
constexpr int kThreads = 256;
constexpr int kTile = 4096;       // elements of one client row per block

enum Kind : unsigned char { kSgd = 0, kSgdAcc = 1, kSel = 2 };

struct LeafTable {
  float* ptr[kMaxPtrs];           // sgd: w, g, m   sgd_acc: w, g, m, fg
                                  // sel: bn_old, bn_new
  int n[kMaxLeaves];              // elements per client
  int tile_start[kMaxLeaves + 1]; // prefix sum of C * ceil(n / kTile)
  unsigned short first[kMaxLeaves];  // leaf's first entry in ptr
  unsigned char kind[kMaxLeaves];
  int num_leaves;
};
// the launch's parameters: the table, lr, valid, num_clients, mu, wd
static_assert(sizeof(LeafTable) + 2 * sizeof(float*) + 3 * 4 <= 4096,
              "kernel parameters over the 4 KB limit");

__device__ __forceinline__ void sgd1(float& w, float g, float& m, float lr,
                                     float mu, float wd) {
  const float g2 = __fadd_rn(g, __fmul_rn(wd, w));
  const float m2 = __fadd_rn(__fmul_rn(mu, m), g2);
  w = __fsub_rn(w, __fmul_rn(lr, m2));
  m = m2;
}

__device__ __forceinline__ void sgd4(float4& w, const float4& g, float4& m,
                                     float lr, float mu, float wd) {
  sgd1(w.x, g.x, m.x, lr, mu, wd);
  sgd1(w.y, g.y, m.y, lr, mu, wd);
  sgd1(w.z, g.z, m.z, lr, mu, wd);
  sgd1(w.w, g.w, m.w, lr, mu, wd);
}

__device__ __forceinline__ void acc4(float4& f, const float4& g) {
  f.x = __fadd_rn(f.x, g.x);
  f.y = __fadd_rn(f.y, g.y);
  f.z = __fadd_rn(f.z, g.z);
  f.w = __fadd_rn(f.w, g.w);
}

__global__ void __launch_bounds__(kThreads)
fused_step_update_kernel(const LeafTable table, const float* __restrict__ lr,
                         const float* __restrict__ valid, int num_clients,
                         float mu, float wd) {
  const int tile = blockIdx.x;
  // leaf l with tile_start[l] <= tile < tile_start[l + 1]
  int lo = 0, hi = table.num_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int l = lo;
  const int n = table.n[l];
  const int tiles_per_row = (n + kTile - 1) / kTile;
  const int local = tile - table.tile_start[l];
  const int client = local / tiles_per_row;
  if (client >= num_clients || valid[client] == 0.0f) return;
  const int begin = (local - client * tiles_per_row) * kTile;
  const int end = min(n, begin + kTile);
  const size_t off = static_cast<size_t>(client) * n + begin;
  const unsigned char kind = table.kind[l];
  float* const* p = table.ptr + table.first[l];
  float* a = p[0] + off;                    // w or bn_old
  const float* b = p[1] + off;              // g or bn_new
  float* c = kind == kSel ? nullptr : p[2] + off;      // m
  float* d = kind == kSgdAcc ? p[3] + off : nullptr;   // fg
  const float lr_c = lr[client];
  const int len = end - begin;

  uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                   reinterpret_cast<uintptr_t>(b);
  if (c) addr |= reinterpret_cast<uintptr_t>(c);
  if (d) addr |= reinterpret_cast<uintptr_t>(d);
  const bool vec = ((addr & 15) == 0) && ((len & 3) == 0);

  if (vec) {
    float4* a4 = reinterpret_cast<float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* c4 = reinterpret_cast<float4*>(c);
    float4* d4 = reinterpret_cast<float4*>(d);
    const int n4 = len >> 2;
    if (kind == kSel) {
      for (int i = threadIdx.x; i < n4; i += kThreads) a4[i] = b4[i];
    } else if (kind == kSgd) {
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 g = b4[i];
        float4 w = a4[i], m = c4[i];
        sgd4(w, g, m, lr_c, mu, wd);
        a4[i] = w;
        c4[i] = m;
      }
    } else {
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const float4 g = b4[i];
        float4 w = a4[i], m = c4[i], f = d4[i];
        sgd4(w, g, m, lr_c, mu, wd);
        acc4(f, g);
        a4[i] = w;
        c4[i] = m;
        d4[i] = f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      if (kind == kSel) {
        a[i] = b[i];
        continue;
      }
      const float g = b[i];
      float w = a[i], m = c[i];
      sgd1(w, g, m, lr_c, mu, wd);
      a[i] = w;
      c[i] = m;
      if (kind == kSgdAcc) d[i] = __fadd_rn(d[i], g);
    }
  }
}

}  // namespace

extern "C" {

int fused_update_max_leaves() { return kMaxLeaves; }
int fused_update_max_ptrs() { return kMaxPtrs; }
int fused_update_tile() { return kTile; }
int fused_update_table_bytes() { return static_cast<int>(sizeof(LeafTable)); }

// `table` is a host LeafTable filled by the Python wrapper; it is copied into
// the kernel's parameters. Returns cudaGetLastError() after the launch.
int fused_step_update_launch(const void* table, const float* lr,
                             const float* valid, int num_clients, float mu,
                             float wd, void* stream) {
  const LeafTable& t = *static_cast<const LeafTable*>(table);
  const int tiles = t.tile_start[t.num_leaves];
  if (tiles > 0) {
    fused_step_update_kernel<<<tiles, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        t, lr, valid, num_clients, mu, wd);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
