// A copy of the JAX package's native/fastloader.cpp, kept in the PyTorch
// port so that the port builds its host library from its own sources
// (fetal_mri_segmentation_tpu_torch/utils/native.py compiles it at first
// use into build/torch_native/). Everything after this header is that file
// unchanged; tests/test_torch_copies.py holds it equal.
//
// fastloader — native host-side data-path kernels for the TPU framework.
//
// The reference's host data path is pure Python/numpy (unet3d/generator.py +
// unet3d/utils/patches.py); on this framework the device does the heavy work,
// but the host still has to slice 3D patches out of cached cases and (in the
// host-fallback reconstruction path) do Gaussian overlap-add. These are
// memcpy/FMA-bound loops where numpy's generic striding machinery leaves
// 2-4x on the table on the single host core — so they are implemented
// natively and exposed via ctypes (fetal_mri_segmentation_tpu/utils/native.py)
// with a transparent numpy fallback.
//
// Layout convention: all volumes are C-contiguous float32 with spatial axes
// last, i.e. (C, D, H, W); a patch corner may be negative / out of bounds and
// the out-of-bounds region is zero-filled (reference:
// unet3d/utils/patches.py::fix_out_of_bound_patch_attempt semantics).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Extract one zero-padded patch: src (C, D, H, W) -> dst (C, pd, ph, pw).
void extract_patch_f32(const float* src, float* dst,
                       int64_t C, int64_t D, int64_t H, int64_t W,
                       int64_t cd, int64_t ch, int64_t cw,   // corner (may be <0)
                       int64_t pd, int64_t ph, int64_t pw) {
  const int64_t patch_elems = pd * ph * pw;
  // valid source ranges per axis
  const int64_t d0 = std::max<int64_t>(cd, 0), d1 = std::min<int64_t>(cd + pd, D);
  const int64_t h0 = std::max<int64_t>(ch, 0), h1 = std::min<int64_t>(ch + ph, H);
  const int64_t w0 = std::max<int64_t>(cw, 0), w1 = std::min<int64_t>(cw + pw, W);
  const bool any_pad = (d0 != cd) || (d1 != cd + pd) || (h0 != ch) ||
                       (h1 != ch + ph) || (w0 != cw) || (w1 != cw + pw);
  for (int64_t c = 0; c < C; ++c) {
    float* out = dst + c * patch_elems;
    if (any_pad) std::memset(out, 0, sizeof(float) * patch_elems);
    if (d1 <= d0 || h1 <= h0 || w1 <= w0) continue;
    const float* in = src + c * D * H * W;
    const int64_t row_bytes = (w1 - w0) * sizeof(float);
    for (int64_t d = d0; d < d1; ++d) {
      for (int64_t h = h0; h < h1; ++h) {
        const float* s = in + (d * H + h) * W + w0;
        float* o = out + ((d - cd) * ph + (h - ch)) * pw + (w0 - cw);
        std::memcpy(o, s, row_bytes);
      }
    }
  }
}

// Batch variant: corners (N, 3) int64 -> dst (N, C, pd, ph, pw).
void extract_patches_batch_f32(const float* src, float* dst,
                               int64_t C, int64_t D, int64_t H, int64_t W,
                               const int64_t* corners, int64_t n,
                               int64_t pd, int64_t ph, int64_t pw) {
  const int64_t patch_elems = C * pd * ph * pw;
  for (int64_t i = 0; i < n; ++i) {
    extract_patch_f32(src, dst + i * patch_elems, C, D, H, W,
                      corners[3 * i], corners[3 * i + 1], corners[3 * i + 2],
                      pd, ph, pw);
  }
}

// Weighted overlap-add of one patch into accumulators.
// acc (C, D, H, W), wsum (D, H, W), patch (C, pd, ph, pw), weight (pd, ph, pw).
void overlap_add_f32(float* acc, float* wsum,
                     const float* patch, const float* weight,
                     int64_t C, int64_t D, int64_t H, int64_t W,
                     int64_t cd, int64_t ch, int64_t cw,
                     int64_t pd, int64_t ph, int64_t pw) {
  const int64_t d0 = std::max<int64_t>(cd, 0), d1 = std::min<int64_t>(cd + pd, D);
  const int64_t h0 = std::max<int64_t>(ch, 0), h1 = std::min<int64_t>(ch + ph, H);
  const int64_t w0 = std::max<int64_t>(cw, 0), w1 = std::min<int64_t>(cw + pw, W);
  if (d1 <= d0 || h1 <= h0 || w1 <= w0) return;
  for (int64_t c = 0; c < C; ++c) {
    float* a = acc + c * D * H * W;
    const float* p = patch + c * pd * ph * pw;
    for (int64_t d = d0; d < d1; ++d) {
      for (int64_t h = h0; h < h1; ++h) {
        const float* ps = p + ((d - cd) * ph + (h - ch)) * pw + (w0 - cw);
        const float* ws = weight + ((d - cd) * ph + (h - ch)) * pw + (w0 - cw);
        float* as = a + (d * H + h) * W + w0;
        for (int64_t w = 0; w < w1 - w0; ++w) as[w] += ps[w] * ws[w];
      }
    }
  }
  for (int64_t d = d0; d < d1; ++d) {
    for (int64_t h = h0; h < h1; ++h) {
      const float* ws = weight + ((d - cd) * ph + (h - ch)) * pw + (w0 - cw);
      float* o = wsum + (d * H + h) * W + w0;
      for (int64_t w = 0; w < w1 - w0; ++w) o[w] += ws[w];
    }
  }
}

// One-hot expansion: truth (D*H*W,) float -> out (n_labels, D*H*W) float,
// out[l, v] = truth[v] == labels[l].
void one_hot_f32(const float* truth, float* out, const double* labels,
                 int64_t n_labels, int64_t n_voxels) {
  for (int64_t l = 0; l < n_labels; ++l) {
    const float lab = static_cast<float>(labels[l]);
    float* o = out + l * n_voxels;
    for (int64_t v = 0; v < n_voxels; ++v) o[v] = (truth[v] == lab) ? 1.f : 0.f;
  }
}

// Any-nonzero check (skip_blank fast path); returns 1 if any voxel != 0.
int32_t any_nonzero_f32(const float* data, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    if (data[i] != 0.f) return 1;
  return 0;
}

}  // extern "C"
