// Keras Adam over many fp32 leaves in one launch (A1).
//
// Replaces no TPU kernel: the JAX package updates in optax's XLA ops. It
// replaces the port's eager composite (training/state.py::KerasAdam.step on
// the CPU, ops/keras_adam.py::keras_adam_reference), about 13 launches a
// leaf, 1,500 a step for Isensee2017's 114 leaves:
//
//   m = m * b1 + g * (1 - b1)
//   v = v * b2 + (g * (1 - b2)) * g
//   p = p + ((m * alpha) / (sqrt(v) + eps)) * (-lr)
//
// Each operation is rounded to fp32 on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn, which nvcc does not contract), and the host rounds
// every scalar to fp32 as PyTorch rounds the composite's Python numbers, so
// the result is the composite's bit for bit.
//
// What bounds it on the H100: bytes, 28 a parameter (p, g, m, v read; p, m,
// v written), against 3.35 TB/s; and, for the composite, the host's
// launches. What the design does about it:
//   One launch covers up to kMaxLeaves leaves: the table of their pointers,
//   element counts, first tiles and step sizes travels by value in the
//   kernel's 4 KB of parameters (__grid_constant__, read in place, no copy),
//   so nothing is copied to the device first. More leaves take more launches
//   of the same kernel, in order on one stream (multi-tensor apply's split).
//   Blocks stride over the launch's tiles of kTile elements; a block finds
//   its tile's leaf by a binary search over the first tiles (uniform across
//   the block). A leaf whose four pointers are 16-byte aligned is read and
//   written in 16-byte vectors, kUnroll in flight a thread from each of p,
//   g, m and v, its ragged end element by element; any other leaf element
//   by element.
#include <cuda_runtime.h>
#include <stdint.h>

namespace fetal {
namespace {

constexpr int kAdamThreads = 256;
constexpr int kAdamUnroll = 2;  // 16-byte vectors of each operand in flight a thread
constexpr int kTile = kAdamThreads * 4 * kAdamUnroll;  // elements a block takes at once
constexpr int kAdamBlocksPerSm = 4;
constexpr int kMaxLeaves = 80;  // ops/keras_adam.py::MAX_LEAVES
constexpr int kRow = 5;         // a leaf's row of the host table: p, g, m, v, numel

struct AdamTable {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int tile_start[kMaxLeaves + 1];  // the launch's first tile of each leaf; [leaves]: all tiles
  float alpha[kMaxLeaves];
  int leaves;
  float b1, omb1, b2, omb2, eps, neg_lr;
};
static_assert(sizeof(AdamTable) <= 4096, "the table must fit in the kernel's parameters");

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, float alpha,
                                     const AdamTable& t) {
  m = __fadd_rn(__fmul_rn(m, t.b1), __fmul_rn(g, t.omb1));
  v = __fadd_rn(__fmul_rn(v, t.b2), __fmul_rn(__fmul_rn(g, t.omb2), g));
  const float den = __fadd_rn(__fsqrt_rn(v), t.eps);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fmul_rn(m, alpha), den), t.neg_lr));
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      float alpha, const AdamTable& t) {
  adam(p.x, g.x, m.x, v.x, alpha, t);
  adam(p.y, g.y, m.y, v.y, alpha, t);
  adam(p.z, g.z, m.z, v.z, alpha, t);
  adam(p.w, g.w, m.w, v.w, alpha, t);
}

__global__ void __launch_bounds__(kAdamThreads, kAdamBlocksPerSm)
    keras_adam_kernel(const __grid_constant__ AdamTable t) {
  const int tiles = t.tile_start[t.leaves];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int lo = 0, hi = t.leaves;  // tile_start[lo] <= tile < tile_start[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (t.tile_start[mid] <= tile)
        lo = mid;
      else
        hi = mid;
    }
    float* p = t.p[lo];
    const float* g = t.g[lo];
    float* m = t.m[lo];
    float* v = t.v[lo];
    const float alpha = t.alpha[lo];
    const long long begin = static_cast<long long>(tile - t.tile_start[lo]) * kTile;
    const long long end = min(begin + kTile, t.n[lo]);
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
    if ((bits & 15) == 0) {
      float4 pv[kAdamUnroll], gv[kAdamUnroll], mv[kAdamUnroll], vv[kAdamUnroll];
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const long long i = begin + 4LL * (u * kAdamThreads + threadIdx.x);
        if (i + 4 <= end) {
          pv[u] = *reinterpret_cast<const float4*>(p + i);
          gv[u] = __ldg(reinterpret_cast<const float4*>(g + i));
          mv[u] = *reinterpret_cast<const float4*>(m + i);
          vv[u] = *reinterpret_cast<const float4*>(v + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kAdamUnroll; ++u) {
        const long long i = begin + 4LL * (u * kAdamThreads + threadIdx.x);
        if (i + 4 <= end) {
          adam4(pv[u], gv[u], mv[u], vv[u], alpha, t);
          *reinterpret_cast<float4*>(p + i) = pv[u];
          *reinterpret_cast<float4*>(m + i) = mv[u];
          *reinterpret_cast<float4*>(v + i) = vv[u];
        } else {
          for (long long j = i; j < end; ++j) adam(p[j], g[j], m[j], v[j], alpha, t);
        }
      }
    } else {
      for (long long i = begin + threadIdx.x; i < end; i += kAdamThreads)
        adam(p[i], g[i], m[i], v[i], alpha, t);
    }
  }
}

}  // namespace
}  // namespace fetal

// One launch over `leaves` (1..kMaxLeaves) leaves: `table` holds a row of
// kRow 64-bit integers a leaf (the addresses of p, g, m and v, contiguous
// fp32, then the element count), `alpha` each leaf's fp32 step size,
// `scalars` the fp32 b1, 1 - b1, b2, 1 - b2, eps and -lr. The table is
// read on the host here: the caller may refill it once this returns.
extern "C" int fetal_keras_adam(int leaves, const long long* table, const float* alpha,
                                const float* scalars, void* stream) {
  using namespace fetal;
  if (leaves < 1 || leaves > kMaxLeaves) return cudaErrorInvalidValue;
  AdamTable t{};
  int tiles = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long* row = table + kRow * i;
    t.p[i] = reinterpret_cast<float*>(row[0]);
    t.g[i] = reinterpret_cast<const float*>(row[1]);
    t.m[i] = reinterpret_cast<float*>(row[2]);
    t.v[i] = reinterpret_cast<float*>(row[3]);
    t.n[i] = row[4];
    t.tile_start[i] = tiles;
    tiles += static_cast<int>((row[4] + kTile - 1) / kTile);
    t.alpha[i] = alpha[i];
  }
  t.tile_start[leaves] = tiles;
  t.leaves = leaves;
  t.b1 = scalars[0];
  t.omb1 = scalars[1];
  t.b2 = scalars[2];
  t.omb2 = scalars[3];
  t.eps = scalars[4];
  t.neg_lr = scalars[5];
  if (tiles == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int blocks = tiles < sms * kAdamBlocksPerSm ? tiles : sms * kAdamBlocksPerSm;
  keras_adam_kernel<<<blocks, kAdamThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return cudaGetLastError();
}
