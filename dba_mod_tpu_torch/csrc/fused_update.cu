// Fused per-step client-state update for the stacked [C, ...] client axis.
//
// Replaces dba_mod_tpu/ops/fused_update.py::_build_kernel (the Pallas TPU
// kernel launched by _run_chunks and dispatched from the custom_vmap batch
// rule of make_fused_step_update). Per leaf kind, with a per-client lr[c] and
// valid[c]:
//
//   sgd  g' = g + wd*w ; m' = mu*m + g' ; w' = w - lr[c]*m'   (w, m updated)
//   acc  fg' = fg + g                                         (fg updated)
//   sel  bn_old' = bn_new                                     (bn_old updated)
//
// each applied only where valid[c] != 0. The JAX version is functional and
// returns where(valid, new, old); this kernel updates w, m, fg and bn_old IN
// PLACE, which saves writing a second copy of the whole client state every
// step. An invalid client's rows are neither read nor written.
//
// What bounds it: device-memory bytes. An sgd value reads w, g, m and writes
// w, m: 20 B. On the CIFAR ResNet-18 state (2,797,610 parameters, 4,800 BN
// running-stat values) at C = 10 that is about 560 MB per step, so the least
// time at the H100's 3.35 TB/s is about 0.17 ms; the arithmetic (6 flops per
// value) is three orders of magnitude below the fp32 peak.
//
// Design: ONE launch covers every leaf of every rank and every client, so the
// step does not pay ~100 elementwise launches. The host passes a table of
// (kind, pointers, elements per client) by value, up to kMaxLeaves leaves per
// launch (the wrapper chunks longer leaf lists, as multi_tensor_apply does).
// The work is cut into tiles of kTile elements of one client's row of one
// leaf; block b finds its leaf by binary search over the tiles' prefix sums,
// so large and small leaves share the grid evenly. Rows whose pointers are
// 16-byte aligned use float4 loads and stores.
//
// Rounding: every product and sum is an explicit round-to-nearest intrinsic
// (and the library is built with -fmad=false), in the JAX order of operations,
// so the result is bitwise equal to the plain PyTorch version
// (dba_mod_tpu_torch/ops/fused_update.py::fused_step_update_reference).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 120;   // keeps the by-value table under 4 KB
constexpr int kThreads = 256;
constexpr int kTile = 4096;       // elements of one client row per block

enum Kind : unsigned char { kSgd = 0, kAcc = 1, kSel = 2 };

struct LeafTable {
  float* a[kMaxLeaves];           // sgd: w     acc: fg     sel: bn_old
  const float* b[kMaxLeaves];     // sgd: g     acc: g      sel: bn_new
  float* c[kMaxLeaves];           // sgd: m     (unused otherwise)
  int n[kMaxLeaves];              // elements per client
  int tile_start[kMaxLeaves + 1]; // prefix sum of C * ceil(n / kTile)
  unsigned char kind[kMaxLeaves];
  int num_leaves;
};

__device__ __forceinline__ void sgd1(float& w, float g, float& m, float lr,
                                     float mu, float wd) {
  const float g2 = __fadd_rn(g, __fmul_rn(wd, w));
  const float m2 = __fadd_rn(__fmul_rn(mu, m), g2);
  w = __fsub_rn(w, __fmul_rn(lr, m2));
  m = m2;
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
  const size_t row = static_cast<size_t>(client) * n;
  float* a = table.a[l] + row;
  const float* b = table.b[l] + row;
  float* c = table.c[l] + row;
  const unsigned char kind = table.kind[l];
  const float lr_c = lr[client];

  uintptr_t addr = reinterpret_cast<uintptr_t>(a + begin) |
                   reinterpret_cast<uintptr_t>(b + begin);
  if (kind == kSgd) addr |= reinterpret_cast<uintptr_t>(c + begin);
  const bool vec = ((addr & 15) == 0) && (((end - begin) & 3) == 0);

  if (vec) {
    float4* a4 = reinterpret_cast<float4*>(a + begin);
    const float4* b4 = reinterpret_cast<const float4*>(b + begin);
    float4* c4 = reinterpret_cast<float4*>(c + begin);
    const int n4 = (end - begin) >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 y = b4[i];
      if (kind == kSel) {
        a4[i] = y;
        continue;
      }
      float4 x = a4[i];
      if (kind == kSgd) {
        float4 z = c4[i];
        sgd1(x.x, y.x, z.x, lr_c, mu, wd);
        sgd1(x.y, y.y, z.y, lr_c, mu, wd);
        sgd1(x.z, y.z, z.z, lr_c, mu, wd);
        sgd1(x.w, y.w, z.w, lr_c, mu, wd);
        c4[i] = z;
      } else if (kind == kAcc) {
        x.x = __fadd_rn(x.x, y.x);
        x.y = __fadd_rn(x.y, y.y);
        x.z = __fadd_rn(x.z, y.z);
        x.w = __fadd_rn(x.w, y.w);
      }
      a4[i] = x;
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += kThreads) {
      if (kind == kSgd) {
        float w = a[i], m = c[i];
        sgd1(w, b[i], m, lr_c, mu, wd);
        a[i] = w;
        c[i] = m;
      } else if (kind == kAcc) {
        a[i] = __fadd_rn(a[i], b[i]);
      } else {
        a[i] = b[i];
      }
    }
  }
}

}  // namespace

extern "C" {

int fused_update_max_leaves() { return kMaxLeaves; }
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
