// Fused InstanceNorm + activation over NDHWC activations, in two launches.
//
// Replaces no TPU kernel: the JAX package normalizes in plain XLA ops after
// the Pallas convs. It replaces the port's eager composite
// (models/layers.py::InstanceNorm followed by apply_activation), eleven
// fp32 ops a call, about 56 bytes of traffic an element.
//
//   y[b, n, c] = act(T((x[b, n, c] - mean[b, c]) * rstd[b, c] * scale[c]
//                      + bias[c]))
//   rstd = rsqrt(var + eps), biased variance, per sample b and channel c
//
// x is read as (B, N, C): an NDHWC tensor with N voxels a sample, or a
// space-to-depth folded one (B, d, h, w, F*C), whose sub-voxels are the
// outer part of its last axis, as (B, N*F, C). T is x's type (bf16 or fp32);
// the value is rounded to T before the activation and again after it,
// which is what the composite does (norm, cast, then the activation in T).
//
// What bounds it on the H100: bytes. Three passes over T (read for the
// moments, read again and write for the output): 6 bytes an element in
// bf16, against 3.35 TB/s.
//
// What the design does about it:
//   Launch 1 (grid chunks x B): each block reads a range of rows of one
//     sample with 16-byte loads across C (thread (r, j) takes the vector j
//     of rows r, r + R, ...; four rows in flight), keeps per-thread Welford
//     moments in fp32, merges the block's rows (Chan's pairwise update, a
//     tree in shared memory) and writes (mean, M2) per channel to a scratch
//     of B x chunks x C x 2 floats. The chunks are sized on the host so
//     that every SM has blocks even where B x C is 128 (Isensee level 0).
//     No E[x^2] - E[x]^2: the moments do not cancel after a conv whose
//     mean is far from zero.
//   Launch 2 (grid blocks x B): each block merges its sample's chunk
//     moments in shared memory into (mean, rstd * scale) per channel, then
//     reads x once more in 16-byte vectors, four in flight a thread, and
//     writes y in T. scale and bias are read as fp32 through their pointers.
//
// Training (fetal_instance_norm_act with a moments pointer, then
// fetal_instance_norm_act_backward; ops/instance_norm.py's autograd
// Function) replaces the composite's forward and autograd's fp32 backward
// of it:
//   forward: the same two launches, the apply launch instantiated apart
//     (instance_norm_apply_save) so that the first block of each sample
//     also writes the sample's fp32 (mean, rstd) per channel, the moments
//     the backward reads. Serving keeps its own apply kernel, which writes
//     no moments.
//   backward, with x^ = (x - mean) * rstd, z the forward's value in T
//     recomputed from x, dz = dy * act'(z) and g = dz * scale:
//       dx = rstd * (g - mean_N(g) - x^ * mean_N(g * x^))
//          = rstd * scale * (dz - S1 / N - x^ * S2 / N),
//       S1 = sum_N dz, S2 = sum_N dz * x^ per (sample, channel);
//       dscale = sum_B S2, dbias = sum_B S1.
//     Launch 1 (grid chunks x B, the forward's stats plan): each block
//       reads x and dy over a range of rows, recomputes z (so y is not
//       read), and writes fp32 partial (S1, S2) per channel to a scratch of
//       B x chunks x C x 2 floats, summed in a fixed tree.
//     Launch 2 (grid blocks x B, the forward's apply plan): each block sums
//       its sample's partials in a fixed order, then reads x and dy once
//       more and writes dx in T.
//     Launch 3 (only where scale or bias wants a gradient): dscale and
//       dbias, fp32, each channel's partials over the samples and chunks in
//       a fixed order; no atomics, so a step's gradients repeat bit for bit.
//   10 bytes an element in bf16: x and dy read twice, dx written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fetal {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kNormThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors in flight per thread

template <typename T>
struct Pack;  // 16 bytes of T

template <>
struct Pack<bf16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// (n, mean, m2) += (nb, mb, m2b): Chan's pairwise update
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb,
                                      float m2b) {
  const float total = n + nb;
  if (nb == 0.f) return;
  const float delta = mb - mean;
  const float w = nb / total;
  mean += delta * w;
  m2 += m2b + delta * delta * n * w;
  n = total;
}

// Rows [row0, row1) of one sample: this thread's Welford moments of the VN
// channels of vector j over rows row0 + r, row0 + r + R, ...
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    instance_norm_stats(const T* __restrict__ x, long long rows, int C, long long chunk_rows,
                        float* __restrict__ part) {
  constexpr int VN = Pack<T>::kN;
  __shared__ float s_mean[kNormThreads * VN];
  __shared__ float s_m2[kNormThreads * VN];
  __shared__ float s_n[kNormThreads];
  const int V = C / VN, R = kNormThreads / V;
  const int j = threadIdx.x % V, r = threadIdx.x / V;
  const int b = blockIdx.y, k = blockIdx.x;
  const long long row0 = k * chunk_rows;
  const long long row1 = min(rows, row0 + chunk_rows);
  float n = 0.f, mean[VN], m2[VN];
#pragma unroll
  for (int i = 0; i < VN; ++i) mean[i] = m2[i] = 0.f;
  if (r < R) {
    const T* base = x + static_cast<long long>(b) * rows * C + j * VN;
    long long row = row0 + r;
    for (; row + (kUnroll - 1) * R < row1; row += kUnroll * R) {
      float v[kUnroll][VN];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) Pack<T>::load(base + (row + u * R) * C, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        n += 1.f;
        const float inv = 1.f / n;
#pragma unroll
        for (int i = 0; i < VN; ++i) {
          const float d = v[u][i] - mean[i];
          mean[i] += d * inv;
          m2[i] += d * (v[u][i] - mean[i]);
        }
      }
    }
    for (; row < row1; row += R) {
      float v[VN];
      Pack<T>::load(base + row * C, v);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        const float d = v[i] - mean[i];
        mean[i] += d * inv;
        m2[i] += d * (v[i] - mean[i]);
      }
    }
    // row r's partials at [r * C + c]; every thread of row r has the same n
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      s_mean[r * C + j * VN + i] = mean[i];
      s_m2[r * C + j * VN + i] = m2[i];
    }
    s_n[r] = n;
  }
  // tree over the rows: row r takes row r + s; a thread reads only rows
  // that no thread writes in the same step
  int span = 1;
  while (span < R) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    __syncthreads();
    if (r < s && r + s < R) {
      const float nb = s_n[r + s];
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        const int c = j * VN + i;
        float nn = n;
        merge(nn, mean[i], m2[i], nb, s_mean[(r + s) * C + c], s_m2[(r + s) * C + c]);
        s_mean[r * C + c] = mean[i];
        s_m2[r * C + c] = m2[i];
      }
      n += nb;
      s_n[r] = n;
    }
  }
  if (r == 0) {
    float* out = part + ((static_cast<long long>(b) * gridDim.x + k) * C + j * VN) * 2;
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      out[2 * i] = mean[i];
      out[2 * i + 1] = m2[i];
    }
  }
}

// The apply launch: merge the sample's chunk moments, then normalize.
// kSave (training): the first block of each sample also writes the
// sample's (mean, rstd) per channel to moments, (2, B, C) fp32.
template <typename T, bool kSave>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x, T* __restrict__ y,
                                           const float* __restrict__ part,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, long long rows, int C,
                                           int chunks, long long chunk_rows, float eps, int act,
                                           float slope, float* __restrict__ moments) {
  constexpr int VN = Pack<T>::kN;
  extern __shared__ float smem[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int G = C < kNormThreads ? kNormThreads / C : 1;  // threads a channel
  float* s_n = smem;
  float* s_mean = s_n + G * C;
  float* s_m2 = s_mean + G * C;
  float* s_mu = s_m2 + G * C;  // per channel: mean, rstd * scale, bias
  float* s_a = s_mu + C;
  float* s_b = s_a + C;
  const float* p = part + static_cast<long long>(b) * chunks * C * 2;
  for (int idx = tid; idx < G * C; idx += kNormThreads) {
    const int c = idx % C, g = idx / C;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = g; k < chunks; k += G) {
      const float nb = static_cast<float>(min(chunk_rows, rows - k * chunk_rows));
      merge(n, mean, m2, nb, p[(k * C + c) * 2], p[(k * C + c) * 2 + 1]);
    }
    s_n[idx] = n;
    s_mean[idx] = mean;
    s_m2[idx] = m2;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kNormThreads) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int g = 0; g < G; ++g) merge(n, mean, m2, s_n[g * C + c], s_mean[g * C + c], s_m2[g * C + c]);
    const float rstd = rsqrtf(m2 / n + eps);
    s_mu[c] = mean;
    s_a[c] = rstd * scale[c];
    s_b[c] = bias[c];
    if constexpr (kSave) {
      if (blockIdx.x == 0) {
        moments[static_cast<long long>(b) * C + c] = mean;
        moments[static_cast<long long>(gridDim.y + b) * C + c] = rstd;
      }
    }
  }
  __syncthreads();

  const long long nvec = rows * C / VN;
  const long long offset = static_cast<long long>(b) * rows * C;
  const T* xb = x + offset;
  T* yb = y + offset;
  const long long stride = static_cast<long long>(gridDim.x) * kNormThreads;
  const int step_c = static_cast<int>((stride * VN) % C);  // channel shift a stride
  long long v = static_cast<long long>(blockIdx.x) * kNormThreads + tid;
  int c0 = static_cast<int>((v * VN) % C);
  auto apply = [&](float (&val)[VN], int c) {
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      float t = Pack<T>::round((val[i] - s_mu[c + i]) * s_a[c + i] + s_b[c + i]);
      if (act == 1) t = t > 0.f ? t : 0.f;
      else if (act == 2) t = t > 0.f ? t : t * slope;
      val[i] = t;
    }
  };
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    float val[kUnroll][VN];
    int cs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Pack<T>::load(xb + (v + u * stride) * VN, val[u]);
      cs[u] = c0;
      c0 += step_c;
      if (c0 >= C) c0 -= C;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      apply(val[u], cs[u]);
      Pack<T>::store(yb + (v + u * stride) * VN, val[u]);
    }
  }
  for (; v < nvec; v += stride) {
    float val[VN];
    Pack<T>::load(xb + v * VN, val);
    apply(val, c0);
    Pack<T>::store(yb + v * VN, val);
    c0 += step_c;
    if (c0 >= C) c0 -= C;
  }
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    instance_norm_apply(const T* __restrict__ x, T* __restrict__ y,
                        const float* __restrict__ part, const float* __restrict__ scale,
                        const float* __restrict__ bias, long long rows, int C, int chunks,
                        long long chunk_rows, float eps, int act, float slope) {
  apply_rows<T, false>(x, y, part, scale, bias, rows, C, chunks, chunk_rows, eps, act, slope,
                       nullptr);
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    instance_norm_apply_save(const T* __restrict__ x, T* __restrict__ y,
                             const float* __restrict__ part, const float* __restrict__ scale,
                             const float* __restrict__ bias, long long rows, int C, int chunks,
                             long long chunk_rows, float eps, int act, float slope,
                             float* __restrict__ moments) {
  apply_rows<T, true>(x, y, part, scale, bias, rows, C, chunks, chunk_rows, eps, act, slope,
                      moments);
}

// dy * act'(z), z the forward's value in T recomputed from x exactly as the
// apply launch computes it (a = rstd * scale): the sign of z decides
template <typename T>
__device__ __forceinline__ float grad_z(float xv, float dyv, float mu, float a, float bb, int act,
                                        float slope) {
  if (act == 0) return dyv;
  const float z = Pack<T>::round((xv - mu) * a + bb);
  return z > 0.f ? dyv : (act == 1 ? 0.f : dyv * slope);
}

// Backward launch 1: rows [row0, row1) of one sample, thread (r, j) as in
// instance_norm_stats; partial (S1, S2) of its VN channels per chunk.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    instance_norm_bwd_sums(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ moments, const float* __restrict__ scale,
                           const float* __restrict__ bias, long long rows, int C,
                           long long chunk_rows, int act, float slope, float* __restrict__ part) {
  constexpr int VN = Pack<T>::kN;
  __shared__ float s_1[kNormThreads * VN];
  __shared__ float s_2[kNormThreads * VN];
  const int V = C / VN, R = kNormThreads / V;
  const int j = threadIdx.x % V, r = threadIdx.x / V;
  const int b = blockIdx.y, k = blockIdx.x;
  const long long row0 = k * chunk_rows;
  const long long row1 = min(rows, row0 + chunk_rows);
  float s1[VN], s2[VN];
#pragma unroll
  for (int i = 0; i < VN; ++i) s1[i] = s2[i] = 0.f;
  if (r < R) {
    float mu[VN], rs[VN], a[VN], bb[VN];
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      const int c = j * VN + i;
      mu[i] = moments[static_cast<long long>(b) * C + c];
      rs[i] = moments[static_cast<long long>(gridDim.y + b) * C + c];
      a[i] = rs[i] * scale[c];
      bb[i] = bias[c];
    }
    const long long offset = static_cast<long long>(b) * rows * C + j * VN;
    const T* xb = x + offset;
    const T* db = dy + offset;
    auto add = [&](const float (&xv)[VN], const float (&dv)[VN]) {
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        const float dz = grad_z<T>(xv[i], dv[i], mu[i], a[i], bb[i], act, slope);
        s1[i] += dz;
        s2[i] += dz * ((xv[i] - mu[i]) * rs[i]);
      }
    };
    long long row = row0 + r;
    for (; row + (kUnroll - 1) * R < row1; row += kUnroll * R) {
      float xv[kUnroll][VN], dv[kUnroll][VN];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Pack<T>::load(xb + (row + u * R) * C, xv[u]);
        Pack<T>::load(db + (row + u * R) * C, dv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(xv[u], dv[u]);
    }
    for (; row < row1; row += R) {
      float xv[VN], dv[VN];
      Pack<T>::load(xb + row * C, xv);
      Pack<T>::load(db + row * C, dv);
      add(xv, dv);
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      s_1[r * C + j * VN + i] = s1[i];
      s_2[r * C + j * VN + i] = s2[i];
    }
  }
  // the same tree over the rows as instance_norm_stats, summing
  int span = 1;
  while (span < R) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    __syncthreads();
    if (r < s && r + s < R) {
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        const int c = j * VN + i;
        s1[i] += s_1[(r + s) * C + c];
        s2[i] += s_2[(r + s) * C + c];
        s_1[r * C + c] = s1[i];
        s_2[r * C + c] = s2[i];
      }
    }
  }
  if (r == 0) {
    float* out = part + ((static_cast<long long>(b) * gridDim.x + k) * C + j * VN) * 2;
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      out[2 * i] = s1[i];
      out[2 * i + 1] = s2[i];
    }
  }
}

// Backward launch 2: the sample's (S1, S2) from its partials (G threads a
// channel over every G-th chunk, then the G sums in order), then dx.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    instance_norm_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                         const float* __restrict__ moments, const float* __restrict__ part,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         long long rows, int C, int chunks, int act, float slope) {
  constexpr int VN = Pack<T>::kN;
  extern __shared__ float smem[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int G = C < kNormThreads ? kNormThreads / C : 1;
  float* s_1 = smem;
  float* s_2 = s_1 + G * C;
  // per channel: mean, rstd, a = rstd * scale, bias, -a S1 / N, -a S2 / N
  float* s_mu = s_2 + G * C;
  float* s_rs = s_mu + C;
  float* s_a = s_rs + C;
  float* s_b = s_a + C;
  float* s_k1 = s_b + C;
  float* s_k2 = s_k1 + C;
  const float* p = part + static_cast<long long>(b) * chunks * C * 2;
  for (int idx = tid; idx < G * C; idx += kNormThreads) {
    const int c = idx % C, g = idx / C;
    float t1 = 0.f, t2 = 0.f;
    for (int k = g; k < chunks; k += G) {
      t1 += p[(k * C + c) * 2];
      t2 += p[(k * C + c) * 2 + 1];
    }
    s_1[idx] = t1;
    s_2[idx] = t2;
  }
  __syncthreads();
  const float inv_n = 1.f / static_cast<float>(rows);
  for (int c = tid; c < C; c += kNormThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int g = 0; g < G; ++g) {
      t1 += s_1[g * C + c];
      t2 += s_2[g * C + c];
    }
    const float rs = moments[static_cast<long long>(gridDim.y + b) * C + c];
    const float a = rs * scale[c];
    s_mu[c] = moments[static_cast<long long>(b) * C + c];
    s_rs[c] = rs;
    s_a[c] = a;
    s_b[c] = bias[c];
    s_k1[c] = -a * t1 * inv_n;
    s_k2[c] = -a * t2 * inv_n;
  }
  __syncthreads();

  const long long nvec = rows * C / VN;
  const long long offset = static_cast<long long>(b) * rows * C;
  const T* xb = x + offset;
  const T* db = dy + offset;
  T* ob = dx + offset;
  const long long stride = static_cast<long long>(gridDim.x) * kNormThreads;
  const int step_c = static_cast<int>((stride * VN) % C);
  long long v = static_cast<long long>(blockIdx.x) * kNormThreads + tid;
  int c0 = static_cast<int>((v * VN) % C);
  auto grad = [&](float (&xv)[VN], const float (&dv)[VN], int c) {
#pragma unroll
    for (int i = 0; i < VN; ++i) {
      const float mu = s_mu[c + i], a = s_a[c + i];
      const float dz = grad_z<T>(xv[i], dv[i], mu, a, s_b[c + i], act, slope);
      xv[i] = a * dz + s_k1[c + i] + s_k2[c + i] * ((xv[i] - mu) * s_rs[c + i]);
    }
  };
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    float xv[kUnroll][VN], dv[kUnroll][VN];
    int cs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Pack<T>::load(xb + (v + u * stride) * VN, xv[u]);
      Pack<T>::load(db + (v + u * stride) * VN, dv[u]);
      cs[u] = c0;
      c0 += step_c;
      if (c0 >= C) c0 -= C;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      grad(xv[u], dv[u], cs[u]);
      Pack<T>::store(ob + (v + u * stride) * VN, xv[u]);
    }
  }
  for (; v < nvec; v += stride) {
    float xv[VN], dv[VN];
    Pack<T>::load(xb + v * VN, xv);
    Pack<T>::load(db + v * VN, dv);
    grad(xv, dv, c0);
    Pack<T>::store(ob + v * VN, xv);
    c0 += step_c;
    if (c0 >= C) c0 -= C;
  }
}

// Backward launch 3 (grid ceil(C / kNormThreads)): dscale = sum S2, dbias =
// sum S1 over the B x chunks partials of each channel. Where C is under
// kNormThreads, G threads share a channel, each over every G-th partial,
// and one of them adds the G sums in order.
__global__ void __launch_bounds__(kNormThreads)
    instance_norm_bwd_params(const float* __restrict__ part, int C, int n_parts,
                             float* __restrict__ dparams) {
  __shared__ float s_1[kNormThreads];
  __shared__ float s_2[kNormThreads];
  const int G = C < kNormThreads ? kNormThreads / C : 1;
  const int tid = threadIdx.x;
  const int c = G > 1 ? tid % C : blockIdx.x * kNormThreads + tid;
  const int g = G > 1 ? tid / C : 0;
  float t1 = 0.f, t2 = 0.f;
  if (g < G && c < C) {
    for (int e = g; e < n_parts; e += G) {
      t1 += part[(static_cast<long long>(e) * C + c) * 2];
      t2 += part[(static_cast<long long>(e) * C + c) * 2 + 1];
    }
  }
  s_1[tid] = t1;
  s_2[tid] = t2;
  __syncthreads();
  if (g == 0 && c < C) {
    for (int h = 1; h < G; ++h) {
      t1 += s_1[h * C + c];
      t2 += s_2[h * C + c];
    }
    dparams[c] = t2;
    dparams[C + c] = t1;
  }
}

template <typename T>
int launch_pair(const void* x, void* y, void* part, const void* scale, const void* bias, int B,
                long long rows, int C, int chunks, long long chunk_rows, int blocks, float eps,
                int act, float slope, cudaStream_t stream, void* moments) {
  instance_norm_stats<T><<<dim3(chunks, B), kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), rows, C, chunk_rows, static_cast<float*>(part));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = C < kNormThreads ? kNormThreads / C : 1;
  const size_t smem = sizeof(float) * (3 * G * C + 3 * C);
  if (moments)
    instance_norm_apply_save<T><<<dim3(blocks, B), kNormThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(part),
        static_cast<const float*>(scale), static_cast<const float*>(bias), rows, C, chunks,
        chunk_rows, eps, act, slope, static_cast<float*>(moments));
  else
    instance_norm_apply<T><<<dim3(blocks, B), kNormThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(part),
        static_cast<const float*>(scale), static_cast<const float*>(bias), rows, C, chunks,
        chunk_rows, eps, act, slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* x, const void* dy, void* dx, const void* moments, void* part,
                    const void* scale, const void* bias, void* dparams, int B, long long rows,
                    int C, int chunks, long long chunk_rows, int blocks, int act, float slope,
                    cudaStream_t stream) {
  instance_norm_bwd_sums<T><<<dim3(chunks, B), kNormThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(moments),
      static_cast<const float*>(scale), static_cast<const float*>(bias), rows, C, chunk_rows,
      act, slope, static_cast<float*>(part));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = C < kNormThreads ? kNormThreads / C : 1;
  const size_t smem = sizeof(float) * (2 * G * C + 6 * C);
  instance_norm_bwd_dx<T><<<dim3(blocks, B), kNormThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<const float*>(moments), static_cast<const float*>(part),
      static_cast<const float*>(scale), static_cast<const float*>(bias), rows, C, chunks, act,
      slope);
  e = cudaGetLastError();
  if (e != cudaSuccess || !dparams) return static_cast<int>(e);
  instance_norm_bwd_params<<<(C + kNormThreads - 1) / kNormThreads, kNormThreads, 0, stream>>>(
      static_cast<const float*>(part), C, B * chunks, static_cast<float*>(dparams));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace fetal

// x, y: (B, rows, C) contiguous, bf16 or fp32; part: B x chunks x C x 2
// floats of scratch; scale, bias: (C,) fp32. C % 8 == 0, C <= 1024.
// moments: null when serving; in training (2, B, C) fp32, which the apply
// launch writes: mean, then rstd.
// geom = (B, rows, C, chunks, chunk_rows, blocks, is_bf16, act), field for
// field ops/instance_norm.py::_geometry: chunk k of a sample covers rows
// [k * chunk_rows, (k + 1) * chunk_rows); act 0 none, 1 relu, 2 leaky_relu
// (ops/cuda_lib.py::ACTIVATIONS).
extern "C" int fetal_instance_norm_act(const void* x, void* y, void* part, const void* scale,
                                       const void* bias, void* moments, const long long* geom,
                                       float eps, float slope, void* stream) {
  using namespace fetal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(geom[0]), C = static_cast<int>(geom[2]);
  const int chunks = static_cast<int>(geom[3]), blocks = static_cast<int>(geom[5]);
  const int act = static_cast<int>(geom[7]);
  if (geom[6])
    return launch_pair<bf16>(x, y, part, scale, bias, B, geom[1], C, chunks, geom[4], blocks,
                             eps, act, slope, s, moments);
  return launch_pair<float>(x, y, part, scale, bias, B, geom[1], C, chunks, geom[4], blocks,
                            eps, act, slope, s, moments);
}

// The backward of the training forward with the same geom: x, dy, dx
// (B, rows, C) in T; moments as the forward wrote them; part B x chunks
// x C x 2 floats of scratch; dparams (2, C) fp32, dscale then dbias, or
// null for no parameter gradient (two launches, not three).
extern "C" int fetal_instance_norm_act_backward(const void* x, const void* dy, void* dx,
                                                const void* moments, void* part,
                                                const void* scale, const void* bias,
                                                void* dparams, const long long* geom,
                                                float slope, void* stream) {
  using namespace fetal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(geom[0]), C = static_cast<int>(geom[2]);
  const int chunks = static_cast<int>(geom[3]), blocks = static_cast<int>(geom[5]);
  const int act = static_cast<int>(geom[7]);
  if (geom[6])
    return launch_backward<bf16>(x, dy, dx, moments, part, scale, bias, dparams, B, geom[1], C,
                                 chunks, geom[4], blocks, act, slope, s);
  return launch_backward<float>(x, dy, dx, moments, part, scale, bias, dparams, B, geom[1], C,
                                chunks, geom[4], blocks, act, slope, s);
}
