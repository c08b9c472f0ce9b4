// Fused decoder level: nearest x2 upsample + concat + 3x3x3 conv + bias +
// activation, as 8 output-parity implicit GEMMs at coarse resolution.
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
// so K = 8*C_up + 27*C_skip. blockIdx.z selects the parity and with it the
// (8*C_up, C_out) block of the pre-summed up weights; the (27*C_skip, C_out)
// skip weights are shared by all 8. Both operands are gathered straight from
// NDHWC: no upsampled tensor, no concat and no parity relayout is ever
// written, and the output lands in the fine NDHWC tensor directly (the TPU
// kernel's parity-block layout and its interleave pass are not needed).
//
// What bounds it on the H100: arithmetic, as for conv3x3.cu (K >= 8*64 +
// 27*32). The design removes the memory traffic the unfused level pays (an
// upsampled copy 8x the size of x_deep, a concat, and a 27-tap conv over the
// upsampled half where 8 taps suffice); the products run on the same
// double-buffered wmma pipeline (igemm.cuh).
#include "igemm.cuh"

namespace fetal {

__global__ void __launch_bounds__(kThreads)
    dec0_kernel(const bf16* __restrict__ xd, const bf16* __restrict__ skip,
                const bf16* __restrict__ wup, const bf16* __restrict__ wskip,
                const float* __restrict__ bias, bf16* __restrict__ y, int B, int dc, int hc,
                int wc, int Cu, int Cs, int Co, int act, float slope) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const int parity = blockIdx.z;
  const int r1 = (parity >> 2) & 1, r2 = (parity >> 1) & 1, r3 = parity & 1;
  const int Df = 2 * dc, Hf = 2 * hc, Wf = 2 * wc;
  const long long Mc = static_cast<long long>(B) * dc * hc * wc;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;

  const int q = tid & 3;
  int rb[2], ra[2], rbb[2], rc[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    rok[i] = m < Mc;
    const long long mm = rok[i] ? m : 0;
    rc[i] = static_cast<int>(mm % wc);
    long long t = mm / wc;
    rbb[i] = static_cast<int>(t % hc);
    t /= hc;
    ra[i] = static_cast<int>(t % dc);
    rb[i] = static_cast<int>(t / dc);
  }

  const int cu_chunks = (Cu + kBK - 1) / kBK;
  const int cs_chunks = (Cs + kBK - 1) / kBK;
  const int n_up = 8 * cu_chunks;
  const int n_iters = n_up + 27 * cs_chunks;
  const bf16* wup_r = wup + static_cast<long long>(parity) * 8 * Cu * Co;

  auto load_stage = [&](int it, bf16* as, bf16* bs) {
    if (it < n_up) {
      const int j = it / cu_chunks;
      const int c0 = (it - j * cu_chunks) * kBK;
      const int j1 = (j >> 2) & 1, j2 = (j >> 1) & 1, j3 = j & 1;
      const int ch = c0 + q * 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int sa = ra[i] + r1 + j1 - 1, sb = rbb[i] + r2 + j2 - 1, sc = rc[i] + r3 + j3 - 1;
        const bool ok = rok[i] && ch < Cu && sa >= 0 && sa < dc && sb >= 0 && sb < hc &&
                        sc >= 0 && sc < wc;
        const bf16* src =
            ok ? xd + (((static_cast<long long>(rb[i]) * dc + sa) * hc + sb) * wc + sc) * Cu + ch
               : xd;
        cp_async16(as + ((tid >> 2) + i * 64) * kALd + q * 8, src, ok);
      }
      load_b_tile(bs, wup_r + static_cast<long long>(j * Cu + c0) * Co, min(kBK, Cu - c0), n0,
                  Co, wup);
    } else {
      const int s = it - n_up;
      const int k = s / cs_chunks;
      const int c0 = (s - k * cs_chunks) * kBK;
      const int k1 = k / 9, k2 = (k / 3) % 3, k3 = k % 3;
      const int ch = c0 + q * 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int fd = 2 * ra[i] + r1 + k1 - 1, fh = 2 * rbb[i] + r2 + k2 - 1,
                  fw = 2 * rc[i] + r3 + k3 - 1;
        const bool ok = rok[i] && ch < Cs && fd >= 0 && fd < Df && fh >= 0 && fh < Hf &&
                        fw >= 0 && fw < Wf;
        const bf16* src =
            ok ? skip + (((static_cast<long long>(rb[i]) * Df + fd) * Hf + fh) * Wf + fw) * Cs + ch
               : skip;
        cp_async16(as + ((tid >> 2) + i * 64) * kALd + q * 8, src, ok);
      }
      load_b_tile(bs, wskip + static_cast<long long>(k * Cs + c0) * Co, min(kBK, Cs - c0), n0,
                  Co, wskip);
    }
  };

  FragC acc[2][2];
  main_loop(smem, n_iters, load_stage, acc, wm, wn);
  epilogue(smem, acc, wm, wn, bias, y, n0, Co, act, slope, [&](int r) -> long long {
    const long long m = m0 + r;
    if (m >= Mc) return -1;
    const int c = static_cast<int>(m % wc);
    long long t = m / wc;
    const int bb = static_cast<int>(t % hc);
    t /= hc;
    const int a = static_cast<int>(t % dc);
    const long long b = t / dc;
    const long long fine = ((b * Df + 2 * a + r1) * Hf + 2 * bb + r2) * Wf + 2 * c + r3;
    return fine * Co;
  });
}

}  // namespace fetal

// xd: (B, dc, hc, wc, Cu) bf16; skip: (B, 2dc, 2hc, 2wc, Cs) bf16;
// wup: (8, 8*Cu, Co) bf16, the pre-summed up weights per output parity;
// wskip: (27*Cs, Co) bf16; bias: (Co,) fp32; y: (B, 2dc, 2hc, 2wc, Co) bf16.
// All contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int fetal_dec0_bf16(const void* xd, const void* skip, const void* wup,
                               const void* wskip, const void* bias, void* y, int B, int dc,
                               int hc, int wc, int Cu, int Cs, int Co, int act, float slope,
                               void* stream) {
  using namespace fetal;
  const long long Mc = static_cast<long long>(B) * dc * hc * wc;
  const dim3 grid(static_cast<unsigned>((Mc + kBM - 1) / kBM), (Co + kBN - 1) / kBN, 8);
  dec0_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xd), static_cast<const bf16*>(skip), static_cast<const bf16*>(wup),
      static_cast<const bf16*>(wskip), static_cast<const float*>(bias), static_cast<bf16*>(y), B,
      dc, hc, wc, Cu, Cs, Co, act, slope);
  return static_cast<int>(cudaGetLastError());
}
