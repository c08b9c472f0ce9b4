// Tile machinery shared by the implicit-GEMM convolution kernels
// (conv3x3.cu, dec0.cu), written for Hopper (sm_90a).
//
// An output tile is kBM voxels x BN channels (GEMM M x N): 128 x 128, or
// 256 x 64 where C_out <= 64 (see kSwapped). A launch has one persistent
// block per SM, and block i takes tiles i, i + gridDim.x, ... K runs over
// (tap, KB-channel chunk) steps, KB = 64 (one 128-byte row, the span of the
// 128-byte swizzle) or, where C_in <= 32, KB = 32 (a 64-byte row in the
// 64-byte swizzle).
//
// Warp specialisation, 384 threads:
//   warps 0-7  two consumer warpgroups, half of the tile's voxels each;
//              every K step they issue KB/16 wgmma.mma_async m64n128k16
//              (bf16 in, fp32 accumulators in registers) with both operands
//              read from shared memory, keep one step's products in flight
//              and then release the previous step's stage;
//   warps 8-11 the producer warpgroup: one thread keeps a ring of kStages
//              stages full with TMA tile loads (cp.async.bulk.tensor) that
//              complete on the stage's full barrier (mbarrier expect-tx);
//              it refills a stage once all eight consumer warps have
//              arrived on its empty barrier, and runs on into the block's
//              next tile while the consumers store the last one.
// setmaxnreg moves registers from the producer (40) to the consumers (232).
//
// Both operands are K-major tiles of KB-channel rows in the swizzle of that
// width, as TMA writes them and wgmma reads them: the activations are kBM
// rows (voxels), one TMA box per (tap, chunk); the weights are BN rows
// (output channels), from a weight matrix prepared once as
// (C_out, taps, C_in). TMA fills every element outside the tensor with
// zeros: the SAME-padding halo, channels past C_in (a ragged K) and output
// channels past C_out cost no predicate. The epilogue adds the fp32 bias,
// applies the activation, stages the bf16 tile in shared memory as
// [voxel][channel] and writes 16-byte vectors to the voxels that lie
// inside the output.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// at run time with cudaGetDriverEntryPoint (no -lcuda), from plain integer
// specs that the Python wrappers compute (ops/tiling.py).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fetal {

using bf16 = __nv_bfloat16;

constexpr int kConsumerThreads = 256;
constexpr int kThreads = 384;        // two consumer warpgroups + the producer warpgroup

// Every tile runs on wgmma m64n128k16: 64 x 128 products per warpgroup and
// 16 channels. A 128-wide N tile takes 128 voxels, each warpgroup 64 voxel
// rows (A) x 128 output channels (B). A 64-wide N tile (C_out <= 64) takes
// 256 voxels with the operands swapped: each warpgroup computes 64 output
// channels (A, the weights) x 128 voxels (B), so it reads as little shared
// memory per product as the 128-wide tile, where m64n64 products would
// read a third more.
template <int BN>
constexpr bool kSwapped = BN == 64;

// Dynamic shared memory of one block for K steps of KB channels: the
// activation (voxel) ring, the weight ring, the staged output tile and the
// barriers. Tiles start at multiples of 1024 bytes (the period of the
// 128-byte swizzle, twice that of the 64-byte one); kBytes adds the slack
// for aligning the base. A stage is released one K step after its products
// are issued, so kStages - 2 steps of loads are in flight ahead of the
// tensor cores: 8 stages where a stage is small, else 4 (on the H100, a
// fifth stage slowed the 128-wide tiles: dec1_conv2 0.39 -> 0.44 ms).
template <int BN, int KB>
struct Smem {
  static constexpr int kBM = kSwapped<BN> ? 256 : 128;  // voxels per tile
  static constexpr int kATileBytes = kBM * KB * 2;      // voxels x KB
  static constexpr int kBTileBytes = BN * KB * 2;       // weights: BN x KB
  static constexpr int kStages = kATileBytes + kBTileBytes <= 24 * 1024 ? 8 : 4;
  static constexpr int kOutLd = BN + 8;  // staged row stride (bf16): no bank conflicts
  static constexpr int kA = 0;
  static constexpr int kB = kStages * kATileBytes;
  static constexpr int kOut = kB + kStages * kBTileBytes;
  static constexpr int kBar = kOut + kBM * kOutLd * 2;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;
  static constexpr uint32_t kStageTx = kATileBytes + kBTileBytes;
};

enum Activation { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == kRelu) return v > 0.f ? v : 0.f;
  if (act == kLeakyRelu) return v > 0.f ? v : v * slope;
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ---- TMA tile loads (coordinates innermost first, signed: out of range is zero) ----
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor of a K-major tile of KB-channel rows in
// the swizzle of the row's width: 128-byte rows (KB = 64) in the 128-byte
// swizzle, 8-row groups 1024 bytes apart (SBO), layout type 1; 64-byte rows
// (KB = 32) in the 64-byte swizzle, groups 512 bytes apart, layout type 2.
template <int KB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  static_assert(KB == 64 || KB == 32, "K steps of 64 or 32 channels");
  constexpr uint64_t kSbo = KB * 2 * 8 / 16;
  constexpr uint64_t kLayout = KB == 64 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (kSbo << 32) |
         (kLayout << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching accumulators across an asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] * B[N x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The output tiles of a launch: boxes (TD, TH, TW) of kBM voxels of the output
// grid (b, then D, H, W, tile_w fastest) x N tiles x output parities (8 for
// the fused decoder, else 1). Tile t is (m, n, parity) with m fastest, so
// the blocks in flight at one time share their weight tiles in L2.
struct TileGrid {
  int TD, TH, TW, tiles_d, tiles_h, tiles_w, m_tiles, n_tiles;
};

struct Tile {
  int b, d0, h0, w0, n0, parity;
};

template <int BN>
__device__ __forceinline__ Tile decode_tile(const TileGrid& g, int t) {
  Tile c;
  int m = t % g.m_tiles;
  t /= g.m_tiles;
  c.n0 = (t % g.n_tiles) * BN;
  c.parity = t / g.n_tiles;
  c.w0 = (m % g.tiles_w) * g.TW;
  m /= g.tiles_w;
  c.h0 = (m % g.tiles_h) * g.TH;
  m /= g.tiles_h;
  c.d0 = (m % g.tiles_d) * g.TD;
  c.b = m / g.tiles_d;
  return c;
}

// Persistent warp-specialised implicit GEMM: block i computes tiles i,
// i + gridDim.x, ... of the `n_tiles` kBM x BN output tiles, each over
// `n_iters` K steps. The producer thread calls
// `issue(tile, it, a_dst, b_dst, full_bar)` to start the TMA loads of K step
// `it` of `tile` (Smem<BN, KB>::kStageTx bytes in all) into one stage; it runs
// on into the next tile while the consumers finish the last one, so one
// tile's epilogue hides the next one's first loads. `row_offset(tile, r)` is
// the element offset of tile row r's channel 0 in y, or -1 for a row
// outside the output. The caller's code before this call is all the block
// shares: the two roles never reconverge, so setmaxnreg takes effect.
template <int BN, int KB, class Issue, class RowOffset>
__device__ __forceinline__ void igemm(unsigned char* smem_raw, const TileGrid& grid, int n_tiles,
                                      int n_iters, Issue issue, const float* __restrict__ bias,
                                      bf16* __restrict__ y, int co_total, int act, float slope,
                                      RowOffset row_offset) {
  using L = Smem<BN, KB>;
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::kBar;
  const uint32_t empty = full + 8 * L::kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumerThreads) {
      uint32_t step = 0;  // K steps issued by this block, over all its tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile = decode_tile<BN>(grid, t);
        for (int it = 0; it < n_iters; ++it, ++step) {
          const uint32_t s = step % L::kStages;
          mbar_wait(empty + 8 * s, ((step / L::kStages) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(full + 8 * s, L::kStageTx);
          issue(tile, it, base + L::kA + s * L::kATileBytes, base + L::kB + s * L::kBTileBytes,
                full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: kBM / 2 voxels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    constexpr bool kSwap = kSwapped<BN>;
    constexpr int kRows = L::kBM / 2;
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const uint32_t a_rows = base + L::kA + wg * kRows * (KB * 2);
    bf16* out = reinterpret_cast<bf16*>(smem + L::kOut);
    constexpr int kVecs = BN / 8;
    uint32_t step = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tile = decode_tile<BN>(grid, t);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_acc(acc);
      for (int it = 0; it < n_iters; ++it, ++step) {
        const uint32_t s = step % L::kStages;
        mbar_wait(full + 8 * s, (step / L::kStages) & 1);
        const uint32_t a = a_rows + s * L::kATileBytes;
        const uint32_t b = base + L::kB + s * L::kBTileBytes;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KB / 16; ++k) {  // 16 channels = 32 bytes along the swizzled row
          if constexpr (kSwap)
            wgmma_n128(acc, smem_desc<KB>(b + 32 * k), smem_desc<KB>(a + 32 * k), 1);
          else
            wgmma_n128(acc, smem_desc<KB>(a + 32 * k), smem_desc<KB>(b + 32 * k), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its stage
        if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((step - 1) % L::kStages));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((step - 1) % L::kStages));

      // Epilogue: bias + activation into a staged bf16 tile, [voxel][channel],
      // then 16-byte stores. Accumulator layout: warp w holds product rows
      // 16w..16w+15, acc[4j + 2i + e] is row lane/4 + 8i, column
      // 8j + 2(lane%4) + e; rows are voxels and columns channels, or the
      // other way round when swapped. The first barrier keeps this tile's
      // writes behind the last tile's reads.
      const int n0 = tile.n0;
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = warp * 16 + (lane >> 2) + 8 * i;
          const int col = 8 * j + 2 * (lane & 3);
          if constexpr (kSwap) {  // row: channel; col, col + 1: voxels
            const bool ok = n0 + row < co_total;
            const float bv = ok ? bias[n0 + row] : 0.f;
            const int v = wg * kRows + col;
            out[v * L::kOutLd + row] =
                __float2bfloat16_rn(activate(acc[4 * j + 2 * i] + bv, act, slope));
            out[(v + 1) * L::kOutLd + row] =
                __float2bfloat16_rn(activate(acc[4 * j + 2 * i + 1] + bv, act, slope));
          } else {  // row: voxel; col, col + 1: channels (C_out % 8 == 0: both or neither)
            const bool ok = n0 + col < co_total;
            const float b0 = ok ? bias[n0 + col] : 0.f;
            const float b1 = ok ? bias[n0 + col + 1] : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(out + (wg * kRows + row) * L::kOutLd + col) =
                __floats2bfloat162_rn(activate(acc[4 * j + 2 * i] + b0, act, slope),
                                      activate(acc[4 * j + 2 * i + 1] + b1, act, slope));
          }
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      for (int v = tid & 127; v < kRows * kVecs; v += 128) {
        const int r = wg * kRows + v / kVecs;
        const int c = (v % kVecs) * 8;
        const long long off = row_offset(tile, r);
        if (off < 0 || n0 + c >= co_total) continue;
        *reinterpret_cast<uint4*>(y + off + n0 + c) =
            *reinterpret_cast<const uint4*>(out + r * L::kOutLd + c);
      }
    }
  }
}

// ---- host side: tensor maps from the wrappers' integer specs ----

// One spec: base address, rank, dims[5] (elements, innermost first),
// strides[5] (bytes; [0] is the element size and unused), box[5], swizzle
// bytes (128 or 64: the inner box's width).
constexpr int kMapSpecLen = 18;
// Return codes beside cudaError_t: cuTensorMapEncodeTiled was not found, or
// encoding map m failed with CUresult r (kEncodeError + 1000 m + r).
constexpr int kNoEncoder = 99999;
constexpr int kEncodeError = 100000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();  // not a launch error: leave nothing for check_launch to find
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// bf16 tiled maps, 128- or 64-byte swizzle, zero fill out of bounds.
inline int encode_maps(CUtensorMap* maps, const long long* specs, int n) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (!encode) return kNoEncoder;
  for (int m = 0; m < n; ++m) {
    const long long* s = specs + m * kMapSpecLen;
    const int rank = static_cast<int>(s[1]);
    cuuint64_t dims[5], strides[4];
    cuuint32_t box[5], elem[5];
    for (int i = 0; i < rank; ++i) {
      dims[i] = static_cast<cuuint64_t>(s[2 + i]);
      box[i] = static_cast<cuuint32_t>(s[12 + i]);
      elem[i] = 1;
    }
    for (int i = 1; i < rank; ++i) strides[i - 1] = static_cast<cuuint64_t>(s[7 + i]);
    const CUresult r = encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                              reinterpret_cast<void*>(s[0]), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE,
                              s[17] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeError + 1000 * m + static_cast<int>(r);
  }
  return 0;
}

// Grants the kernel its dynamic shared memory, launches it on `stream` and
// returns cudaGetLastError().
template <class Kernel, class... Args>
inline int launch(Kernel kernel, dim3 grid, int smem_bytes, void* stream, Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fetal
