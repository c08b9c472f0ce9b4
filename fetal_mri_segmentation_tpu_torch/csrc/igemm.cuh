// Tile machinery shared by the implicit-GEMM convolution kernels
// (conv3x3.cu, dec0.cu).
//
// One block computes a 128-voxel x 64-channel output tile (GEMM M x N) with
// 8 warps, each owning a 32 x 32 sub-tile of bf16 tensor-core products
// (nvcuda::wmma 16x16x16, fp32 accumulators). K runs over (tap, 32-channel
// chunk) pairs. Each K step gathers the A tile (128 voxels x 32 channels,
// one conv tap) from NDHWC activations and the B tile (32 K rows x 64
// output channels) from a row-major weight matrix into shared memory with
// 16-byte cp.async copies, double-buffered so the next step's copies run
// under this step's products. Out-of-range taps, channels and output
// columns are zero-filled by the copy itself (src-size 0), so SAME padding
// never materializes. The epilogue adds the fp32 bias, applies the
// activation and stores bf16 in 16-byte vectors.
//
// Requirements the Python wrappers check before a launch: bf16 NDHWC
// activations and bf16 weights with every channel count a multiple of 8
// (16-byte vectors), contiguous, 16-byte-aligned base pointers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fetal {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;       // output voxels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // input channels per K step
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kALd = kBK + 8;  // padded shared-memory row strides (elements)
constexpr int kBLd = kBN + 8;
constexpr int kCLd = kBN + 4;
constexpr int kATile = kBM * kALd;
constexpr int kBTile = kBK * kBLd;
constexpr int kPipeBytes = 2 * (kATile + kBTile) * 2;
constexpr int kCBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kCBytes ? kPipeBytes : kCBytes;

enum Activation { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// B tile of one K step: `rows_valid` rows starting at `w_rows` of a
// (K, co_total) row-major weight matrix, columns n0..n0+63. One 16-byte
// copy per thread; rows and columns past the end are zero-filled.
__device__ __forceinline__ void load_b_tile(bf16* bs, const bf16* w_rows, int rows_valid,
                                            int n0, int co_total, const bf16* w_base) {
  const int kr = threadIdx.x >> 3;
  const int cq = threadIdx.x & 7;
  const int col = n0 + cq * 8;
  const bool ok = kr < rows_valid && col < co_total;
  const bf16* src = ok ? w_rows + static_cast<long long>(kr) * co_total + col : w_base;
  cp_async16(bs + kr * kBLd + cq * 8, src, ok);
}

__device__ __forceinline__ void mma_step(const bf16* as, const bf16* bs, FragC (&acc)[2][2],
                                         int wm, int wn) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    FragA a[2];
    FragB b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * kALd + kk, kALd);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], bs + kk * kBLd + wn * 32 + j * 16, kBLd);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// Double-buffered K loop. `load_stage(it, as, bs)` starts the cp.async
// copies of K step `it` into one A and one B buffer.
template <class LoadStage>
__device__ __forceinline__ void main_loop(unsigned char* smem, int n_iters, LoadStage load_stage,
                                          FragC (&acc)[2][2], int wm, int wn) {
  bf16* as[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + kATile};
  bf16* bs[2] = {reinterpret_cast<bf16*>(smem) + 2 * kATile,
                 reinterpret_cast<bf16*>(smem) + 2 * kATile + kBTile};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  load_stage(0, as[0], bs[0]);
  cp_async_commit();
  for (int it = 0; it < n_iters; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_iters) {
      load_stage(it + 1, as[cur ^ 1], bs[cur ^ 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_step(as[cur], bs[cur], acc, wm, wn);
    __syncthreads();
  }
}

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == kRelu) return v > 0.f ? v : 0.f;
  if (act == kLeakyRelu) return v > 0.f ? v : v * slope;
  return v;
}

// Bias + activation + bf16 store. `row_offset(r)` is the element offset of
// tile row r's channel 0 in y, or -1 for a row past the end of M.
template <class RowOffset>
__device__ __forceinline__ void epilogue(unsigned char* smem, FragC (&acc)[2][2], int wm, int wn,
                                         const float* __restrict__ bias, bf16* __restrict__ y,
                                         int n0, int co_total, int act, float slope,
                                         RowOffset row_offset) {
  float* cs = reinterpret_cast<float*>(smem);  // reuses the pipeline buffers
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16, acc[i][j], kCLd,
                              wmma::mem_row_major);
  __syncthreads();
  for (int v = threadIdx.x; v < kBM * (kBN / 8); v += kThreads) {
    const int r = v >> 3;
    const int cq = v & 7;
    const int co = n0 + cq * 8;
    const long long off = row_offset(r);
    if (off < 0 || co >= co_total) continue;
    const float* src = cs + r * kCLd + cq * 8;
    __align__(16) __nv_bfloat162 out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = activate(src[2 * e] + bias[co + 2 * e], act, slope);
      const float hi = activate(src[2 * e + 1] + bias[co + 2 * e + 1], act, slope);
      out[e] = __floats2bfloat162_rn(lo, hi);
    }
    *reinterpret_cast<uint4*>(y + off + co) = *reinterpret_cast<const uint4*>(out);
  }
}

}  // namespace fetal
