// Fused 3x3x3 convolution + bias + activation, stride 1, SAME padding, as an
// implicit GEMM on Hopper's tensor cores (wgmma fed by TMA, igemm.cuh).
//
// Replaces both TPU kernels of the conv contract:
//   fetal_mri_segmentation_tpu/ops/pallas_conv.py::_kernel (halo-slab
//     kernel, C_in % 128 == 0 on the TPU), and
//   fetal_mri_segmentation_tpu/ops/pallas_conv_flat.py::_flat_kernel (the
//     zero-ring flat-plane layout for any C_in >= 8).
// The flat layout existed so that a conv tap is a lane rotation on the TPU;
// here every tap is a TMA box read straight from NDHWC, so one kernel covers
// both contracts and consecutive convs chain without a relayout.
//
//   y[b,d,h,w,co] = act(sum_{kd,kh,kw,ci} x[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                       * W[kd,kh,kw,ci,co] + bias[co])
//
// GEMM view: M = B*D*H*W output voxels, N = C_out, K = 27*C_in. The B
// operand is the weight prepared once as (C_out, 27, C_in), K-major.
//
// What bounds it on the H100: arithmetic. K >= 27*32 = 864 and every
// activation tile is reused by up to 128 output channels, so the U-Net's
// convs sit far above the 295 FLOP/byte ridge of bf16 on this card; the
// limit is how close the tensor cores get to their peak, and in front of
// them how fast shared memory takes the TMA tiles and feeds the products.
// The previous version (wmma 16x16x16, two cp.async stages, 32-channel K
// steps) held them near 125 TFLOP/s.
//
// What this design does about it: wgmma m64n128k16 from shared memory, a
// TMA ring of 4 or 8 stages, a producer warp and two consumer warpgroups,
// persistent blocks (igemm.cuh). A tile's voxels are a spatial box
// (TD, TH, TW) -- 128 voxels, e.g. (1, 4, 32) at 32^3 and (2, 8, 8) at 8^3,
// or 256 for C_out <= 64, e.g. (1, 4, 64) at 64^3 -- so the activation tile
// of one (tap, KB-channel chunk) is a single 5-D TMA box of x at
// (c0, w0+kw-1, h0+kh-1, d0+kd-1, b): its smem image [td][th][tw][c] is the
// K-major tile wgmma reads, and the hardware's zero fill outside the tensor
// is the SAME padding (negative coordinates included) and the ragged K
// (channels past C_in) at once. KB is 64 (128-byte rows and swizzle), or 32
// (64-byte rows and swizzle) where C_in <= 32, so that enc0_conv2
// (C_in = 32) spends no products on zeros; a ragged C_in still does (40
// runs as 64). Boxes, KB and the N tile (64 where C_out <= 64, else 128)
// come from ops/conv3x3.py::tile_plan.
#include "igemm.cuh"

namespace fetal {

struct ConvMaps {
  CUtensorMap x;  // (C_in, W, H, D, B), box (KB, TW, TH, TD, 1)
  CUtensorMap w;  // (C_in, 27, C_out), box (KB, 1, BN)
};

// Field order = ops/conv3x3.py::ConvPlan.geom.
struct ConvGeom {
  int B, D, H, W, Co, chunks;
  TileGrid grid;
};

template <int BN, int KB>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ ConvMaps maps, const ConvGeom g,
                   const float* __restrict__ bias, bf16* __restrict__ y, int act, float slope) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int chunks = g.chunks;
  // K step it = (tap, chunk), tap = kd*9 + kh*3 + kw
  auto issue = [=, &maps](const Tile& t, int it, uint32_t a_dst, uint32_t b_dst, uint32_t bar) {
    const int tap = it / chunks;
    const int c0 = (it - tap * chunks) * KB;
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    tma_load_5d(a_dst, &maps.x, bar, c0, t.w0 + kw - 1, t.h0 + kh - 1, t.d0 + kd - 1, t.b);
    tma_load_3d(b_dst, &maps.w, bar, c0, tap, t.n0);
  };
  auto row_offset = [=](const Tile& t, int r) -> long long {
    const TileGrid& q = g.grid;
    const int d = t.d0 + r / (q.TH * q.TW), h = t.h0 + (r / q.TW) % q.TH, w = t.w0 + r % q.TW;
    if (d >= g.D || h >= g.H || w >= g.W) return -1;
    return (((static_cast<long long>(t.b) * g.D + d) * g.H + h) * g.W + w) * g.Co;
  };
  igemm<BN, KB>(smem, g.grid, g.grid.m_tiles * g.grid.n_tiles, 27 * chunks, issue, bias, y,
                g.Co, act, slope, row_offset);
}

}  // namespace fetal

// specs: two tensor-map specs (x, then the (C_out, 27, C_in) weight) of
// kMapSpecLen integers; geom: the 14 ConvGeom integers; bias (C_out,) fp32;
// y (B, D, H, W, C_out) bf16 contiguous. Launches `blocks` persistent
// blocks of N tile `bn` and K step `kb` on `stream`; returns 0, a
// cudaError_t, or an encode error.
extern "C" int fetal_conv3x3_bf16(const long long* specs, const int* geom, const void* bias,
                                  void* y, int bn, int kb, int blocks, int act, float slope,
                                  void* stream) {
  using namespace fetal;
  CUtensorMap m[2];
  if (const int err = encode_maps(m, specs, 2)) return err;
  const ConvMaps maps{m[0], m[1]};
  const ConvGeom g{geom[0],
                   geom[1],
                   geom[2],
                   geom[3],
                   geom[4],
                   geom[5],
                   {geom[6], geom[7], geom[8], geom[9], geom[10], geom[11], geom[12], geom[13]}};
  const float* b = static_cast<const float*>(bias);
  bf16* out = static_cast<bf16*>(y);
  const dim3 grid(blocks);
  if (bn == 128 && kb == 64)
    return launch(conv3x3_kernel<128, 64>, grid, Smem<128, 64>::kBytes, stream, maps, g, b, out,
                  act, slope);
  if (bn == 64 && kb == 64)
    return launch(conv3x3_kernel<64, 64>, grid, Smem<64, 64>::kBytes, stream, maps, g, b, out,
                  act, slope);
  if (bn == 128 && kb == 32)
    return launch(conv3x3_kernel<128, 32>, grid, Smem<128, 32>::kBytes, stream, maps, g, b, out,
                  act, slope);
  if (bn == 64 && kb == 32)
    return launch(conv3x3_kernel<64, 32>, grid, Smem<64, 32>::kBytes, stream, maps, g, b, out,
                  act, slope);
  return static_cast<int>(cudaErrorInvalidValue);
}
