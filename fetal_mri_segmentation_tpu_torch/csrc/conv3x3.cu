// Fused 3x3x3 convolution + bias + activation, stride 1, SAME padding, as an
// implicit GEMM on Hopper's tensor cores.
//
// Replaces both TPU kernels of the conv contract:
//   fetal_mri_segmentation_tpu/ops/pallas_conv.py::_kernel (halo-slab
//     kernel, C_in % 128 == 0 on the TPU), and
//   fetal_mri_segmentation_tpu/ops/pallas_conv_flat.py::_flat_kernel (the
//     zero-ring flat-plane layout for any C_in >= 8).
// The flat layout existed so that a conv tap is a lane rotation on the TPU;
// here every tap is a gathered A tile read straight from NDHWC, so one kernel
// covers both contracts and consecutive convs chain without a relayout.
//
//   y[b,d,h,w,co] = act(sum_{kd,kh,kw,ci} x[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                       * W[kd,kh,kw,ci,co] + bias[co])
//
// GEMM view: M = B*D*H*W output voxels, N = C_out, K = 27*C_in. The DHWIO
// weight is already the (27*C_in, C_out) row-major B matrix.
//
// What bounds it on the H100: arithmetic. K >= 27*32 = 864 and every
// activation tile is reused by 64 output channels, so the U-Net's convs sit
// far above the 295 FLOP/byte ridge of bf16 on this card; the limit is how
// close the tensor cores get to their peak. This first version uses
// mma.sync-class products (wmma 16x16x16) with a double-buffered cp.async
// pipeline, which keeps the tensor cores fed at a fraction of the wgmma
// rate; TMA + wgmma + a persistent schedule are the next step.
#include "igemm.cuh"

namespace fetal {

__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ y, int B, int D, int H,
                   int W, int Ci, int Co, int act, float slope) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const long long M = static_cast<long long>(B) * D * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;

  // This thread gathers channel group q (8 channels) of tile rows
  // tid/4 and tid/4 + 64; decode their voxel coordinates once.
  const int q = tid & 3;
  int rd[2], rh[2], rw[2];
  long long rvox[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    rok[i] = m < M;
    const long long mm = rok[i] ? m : 0;
    rvox[i] = mm;
    rw[i] = static_cast<int>(mm % W);
    const long long t = mm / W;
    rh[i] = static_cast<int>(t % H);
    rd[i] = static_cast<int>((t / H) % D);
  }

  const int chunks = (Ci + kBK - 1) / kBK;
  const int n_iters = 27 * chunks;
  const long long plane = static_cast<long long>(H) * W;

  auto load_stage = [&](int it, bf16* as, bf16* bs) {
    const int tap = it / chunks;
    const int c0 = (it - tap * chunks) * kBK;
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int c = c0 + q * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = rd[i] + kd - 1, h = rh[i] + kh - 1, ww = rw[i] + kw - 1;
      const bool ok = rok[i] && c < Ci && d >= 0 && d < D && h >= 0 && h < H && ww >= 0 && ww < W;
      const bf16* src =
          ok ? x + (rvox[i] + (kd - 1) * plane + (kh - 1) * W + (kw - 1)) * Ci + c : x;
      cp_async16(as + ((tid >> 2) + i * 64) * kALd + q * 8, src, ok);
    }
    load_b_tile(bs, w + static_cast<long long>(tap * Ci + c0) * Co, min(kBK, Ci - c0), n0, Co, w);
  };

  FragC acc[2][2];
  main_loop(smem, n_iters, load_stage, acc, wm, wn);
  epilogue(smem, acc, wm, wn, bias, y, n0, Co, act, slope, [&](int r) -> long long {
    const long long m = m0 + r;
    return m < M ? m * Co : -1;
  });
}

}  // namespace fetal

// x: (B, D, H, W, Ci) bf16, w: (3, 3, 3, Ci, Co) bf16, bias: (Co,) fp32,
// y: (B, D, H, W, Co) bf16, all contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fetal_conv3x3_bf16(const void* x, const void* w, const void* bias, void* y, int B,
                                  int D, int H, int W, int Ci, int Co, int act, float slope,
                                  void* stream) {
  using namespace fetal;
  const long long M = static_cast<long long>(B) * D * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (Co + kBN - 1) / kBN);
  conv3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(y), B, D, H, W, Ci, Co, act, slope);
  return static_cast<int>(cudaGetLastError());
}
