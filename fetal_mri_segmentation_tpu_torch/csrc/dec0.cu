// Fused decoder level: nearest x2 upsample + concat + 3x3x3 conv + bias +
// activation, as 8 output-parity implicit GEMMs at coarse resolution, on
// Hopper's tensor cores (wgmma fed by TMA, igemm.cuh).
//
// Replaces fetal_mri_segmentation_tpu/ops/pallas_dec0.py::_dec0_kernel.
//
//   y = act(conv3^3(concat[up_nearest2(x_deep), skip], W) + bias)
//
// Nearest upsampling makes the 3-tap conv over the upsampled half touch only
// two distinct coarse voxels per axis for a given output parity r, so the up
// half collapses to a 2x2x2 conv with pre-summed weights Weff_r
// (models/layers.py::up_concat_conv3x3). For the output voxels of parity
// r = (r1, r2, r3) at coarse index (a, b, c) -- fine (2a+r1, 2b+r2, 2c+r3) --
// one GEMM row reads
//   8 up taps:    x_deep[a+r1+j1-1, b+r2+j2-1, c+r3+j3-1, :],  j in {0,1}^3
//   27 skip taps: skip[2a+r1+k1-1, 2b+r2+k2-1, 2c+r3+k3-1, :], k in {0,1,2}^3
// so K = 8*C_up + 27*C_skip. Each output tile has one parity, which selects
// the (C_out, 8, C_up) block of the pre-summed up weights; the (C_out, 27,
// C_skip) skip weights are shared by all 8. No upsampled tensor, no concat
// and no parity relayout is ever written, and the epilogue writes the fine
// NDHWC positions of its parity directly (the TPU kernel's parity-block
// layout and its interleave pass are not needed).
//
// What bounds it on the H100: arithmetic, as for conv3x3.cu (K >= 8*64 +
// 27*32). The previous version ran on the wmma pipeline near 125 TFLOP/s.
//
// What this design does about it: the same wgmma/TMA mainloop as
// conv3x3.cu, with a spatial M box (TD, TH, TW) over the coarse grid and
// K steps of 64 channels in both halves.
//   Up taps are plain 5-D boxes of x_deep at (c0, c+r3+j3-1, b+r2+j2-1,
//   a+r1+j1-1, batch).
//   Skip taps: with t = r+k-1 in {-1..2}, the fine index 2a+t equals
//   2(a+s)+p for s = floor(t/2), p = t mod 2. The wrapper encodes 8 tensor
//   maps over the skip, one per sub-parity p = (p1, p2, p3): coarse extents,
//   doubled strides, base offset by p. Each skip tap is then one coarse box
//   at (c0, c+s3, b+s2, a+s1, batch) of map p, and out of range is again
//   TMA's zero fill. Chosen over TMA elementStrides of 2 (the odd
//   sub-parities would still need maps of their own, offset by p) and over
//   cp.async gathers (which bring back per-thread addresses and
//   predicates): all of A and B reach shared memory through TMA.
#include "igemm.cuh"

namespace fetal {

struct Dec0Maps {
  CUtensorMap xd;       // (C_up, wc, hc, dc, B), box (64, TW, TH, TD, 1)
  CUtensorMap wup;      // (C_up, 8, C_out, 8 parities), box (64, 1, BN, 1)
  CUtensorMap wskip;    // (C_skip, 27, C_out), box (64, 1, BN)
  CUtensorMap skip[8];  // sub-parity p1*4+p2*2+p3: (C_skip, wc, hc, dc, B)
};

constexpr int kKB = 64;  // channels per K step, both halves

// Field order = ops/dec0.py::Dec0Plan.geom.
struct Dec0Geom {
  int B, dc, hc, wc, Co, cu_chunks, cs_chunks;
  TileGrid grid;
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    dec0_kernel(const __grid_constant__ Dec0Maps maps, const Dec0Geom g,
                const float* __restrict__ bias, bf16* __restrict__ y, int act, float slope) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int cu_chunks = g.cu_chunks, cs_chunks = g.cs_chunks;
  const int n_up = 8 * cu_chunks;

  // K steps: first (j, chunk) of the up half, j = j1*4 + j2*2 + j3, then
  // (k, chunk) of the skip half, k = k1*9 + k2*3 + k3; t.parity = r1*4 + r2*2 + r3
  auto issue = [=, &maps](const Tile& t, int it, uint32_t a_dst, uint32_t b_dst, uint32_t bar) {
    const int r1 = (t.parity >> 2) & 1, r2 = (t.parity >> 1) & 1, r3 = t.parity & 1;
    if (it < n_up) {
      const int j = it / cu_chunks;
      const int c0 = (it - j * cu_chunks) * kKB;
      const int j1 = (j >> 2) & 1, j2 = (j >> 1) & 1, j3 = j & 1;
      tma_load_5d(a_dst, &maps.xd, bar, c0, t.w0 + r3 + j3 - 1, t.h0 + r2 + j2 - 1,
                  t.d0 + r1 + j1 - 1, t.b);
      tma_load_4d(b_dst, &maps.wup, bar, c0, j, t.n0, t.parity);
    } else {
      const int k = (it - n_up) / cs_chunks;
      const int c0 = (it - n_up - k * cs_chunks) * kKB;
      const int t1 = r1 + k / 9 - 1, t2 = r2 + (k / 3) % 3 - 1, t3 = r3 + k % 3 - 1;
      const int s1 = (t1 + 2) / 2 - 1, s2 = (t2 + 2) / 2 - 1, s3 = (t3 + 2) / 2 - 1;
      const int p = (t1 - 2 * s1) * 4 + (t2 - 2 * s2) * 2 + (t3 - 2 * s3);
      tma_load_5d(a_dst, &maps.skip[p], bar, c0, t.w0 + s3, t.h0 + s2, t.d0 + s1, t.b);
      tma_load_3d(b_dst, &maps.wskip, bar, c0, k, t.n0);
    }
  };
  auto row_offset = [=](const Tile& t, int r) -> long long {
    const TileGrid& q = g.grid;
    const int a = t.d0 + r / (q.TH * q.TW), bb = t.h0 + (r / q.TW) % q.TH, c = t.w0 + r % q.TW;
    if (a >= g.dc || bb >= g.hc || c >= g.wc) return -1;
    const int r1 = (t.parity >> 2) & 1, r2 = (t.parity >> 1) & 1, r3 = t.parity & 1;
    const long long fine =
        ((static_cast<long long>(t.b) * 2 * g.dc + 2 * a + r1) * 2 * g.hc + 2 * bb + r2) * 2 *
            g.wc +
        2 * c + r3;
    return fine * g.Co;
  };
  igemm<BN, kKB>(smem, g.grid, 8 * g.grid.m_tiles * g.grid.n_tiles, n_up + 27 * cs_chunks, issue,
            bias, y, g.Co, act, slope, row_offset);
}

}  // namespace fetal

// specs: 11 tensor-map specs (x_deep, up weights (8, C_out, 8, C_up), skip
// weights (C_out, 27, C_skip), then the 8 skip sub-parity views) of
// kMapSpecLen integers; geom: the 15 Dec0Geom integers; bias (C_out,) fp32;
// y (B, 2dc, 2hc, 2wc, C_out) bf16 contiguous. Launches `blocks`
// persistent blocks of N tile `bn` on `stream`; returns 0, a cudaError_t,
// or an encode error.
extern "C" int fetal_dec0_bf16(const long long* specs, const int* geom, const void* bias,
                               void* y, int bn, int blocks, int act, float slope,
                               void* stream) {
  using namespace fetal;
  CUtensorMap m[11];
  if (const int err = encode_maps(m, specs, 11)) return err;
  Dec0Maps maps;
  maps.xd = m[0];
  maps.wup = m[1];
  maps.wskip = m[2];
  for (int p = 0; p < 8; ++p) maps.skip[p] = m[3 + p];
  const Dec0Geom g{geom[0],
                   geom[1],
                   geom[2],
                   geom[3],
                   geom[4],
                   geom[5],
                   geom[6],
                   {geom[7], geom[8], geom[9], geom[10], geom[11], geom[12], geom[13], geom[14]}};
  const float* b = static_cast<const float*>(bias);
  bf16* out = static_cast<bf16*>(y);
  if (bn == 128)
    return launch(dec0_kernel<128>, dim3(blocks), Smem<128, kKB>::kBytes, stream, maps, g, b,
                  out, act, slope);
  if (bn == 64)
    return launch(dec0_kernel<64>, dim3(blocks), Smem<64, kKB>::kBytes, stream, maps, g, b, out,
                  act, slope);
  return static_cast<int>(cudaErrorInvalidValue);
}
