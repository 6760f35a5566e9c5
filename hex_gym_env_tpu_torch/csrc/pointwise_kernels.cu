// The KataGo tower's 1x1 convs as a float32 FFMA product on NCHW boards
// (C entry hex_pointwise_conv: one kernel, pointwise_kernel, on the caller's
// stream), for Hopper (sm_90a) behind a plain C interface (ops/cuda_lib.py
// builds this file with the others into one library; ops/pointwise.py is its
// wrapper and holds its plain PyTorch twin).
//
// Replaces no TPU kernel: the JAX package has no such tower, and its convs
// are XLA's.  Added because cuDNN, asked for the tower's 384 -> 192 and
// 192 -> 384 1x1 convs at 400 11x11 boards in full float32, runs an implicit
// GEMM at ~25 TFLOP/s, 37% of the float32 peak.  A 1x1 conv of C input and
// K output channels (each a multiple of 64) is, for each board b, the
// product y_b (K, n^2) = W (K, C) x_b (C, n^2), and in NCHW each board's
// (C, n^2) panel is contiguous.  Here the B n^2 positions of all boards are
// one flat axis p, cut into tiles of pt consecutive positions (pt = kBM =
// 128 on boards of 5x5 and up) that cross board boundaries freely: 48,400
// positions at 400 11x11 boards make 379 tiles, the last one ragged, and no
// board is padded.  Each output's sum runs over c = 0 .. C - 1 in order,
// fmaf, the direct sum in float32 (no TF32), as a direct conv's.  The
// weight comes as its transpose W^T (C, K), built once a bind
// (ops/pointwise.py), so its tile rows load as W^T's rows.
//
// Bound, at B = 400, 11x11, 384 -> 192 (or 192 -> 384): by operations,
// 2 x 48,400 x 384 x 192 = 7.14 GFLOP, 0.1066 ms at 67 TFLOP/s; by bytes, x
// 74.3 MB (37.2) read and y 37.2 MB (74.3) written once, W 0.3 MB, 0.033 ms
// at 3.35 TB/s: bound by operations (~64 FLOP/byte, the ridge ~20).  Design,
// the Winograd product's (csrc/winograd_kernels.cu) where it carries over:
//   - CTA tiles of kBM = 64 WM positions x kBN = 32 WN output channels, 32
//     WM WN threads, each with 8 x 8 accumulators (a warp 64 x 32, a thread
//     positions {4l, 4l + 32} + 0..3 and channels {4l', 4l' + 16} + 0..3 of
//     it, so each shared-memory read is a broadcast float4); a depth step of
//     kBK = 16 channels; W^T's kBK x kBN tile by 16-byte cp.async, as the
//     Winograd product loads its U;
//   - x's rows start on any float (n^2 is odd at 11x11), so a position
//     tile's row is not a 16-byte run; 4-byte copies of it ran the product
//     ~15% slower than 16-byte ones (H100 SXM, 700 W).  So each position tile
//     is cut into its board segments, and for each of the kBK rows each
//     segment's run is copied as the 16-byte chunks that cover it (aligned
//     down: x is 16-byte aligned and every C n^2 board panel and kBK n^2
//     step starts on 16 bytes, C being a multiple of 4), into a staging row
//     of the ring; one stage ahead of the product each thread moves its
//     position's kBK values from the staging rows (each at its own shift)
//     into a packed kBK x kBM tile, double-buffered, which the product reads
//     with float4 broadcasts.  The ring holds kStages = 4 stages: two in
//     flight while one is repacked and one is computed, one __syncthreads a
//     step.  A chunk past x's end is cut by cp.async's source size;
//   - the 8 x 8 accumulators go out through shared memory (float4 writes
//     along the positions, over the ring), then each thread stores one
//     position of each channel row, a warp 32 consecutive positions of y's
//     NCHW rows: no transpose pass, no uncoalesced store;
//   - the tile's width: kBN is 192 where it divides K, so the 192 -> 384
//     and 384 -> 192 convs both run 192-channel tiles (379 x 2 and 379
//     CTAs, ~96% of six and three full waves of one 384-thread CTA an SM),
//     and 64 for every other multiple of 64 (128 threads); CTAs run
//     position-tile major, so the K / kBN tiles of one position tile read
//     its x panel from L2 together.  On small boards a tile takes pt =
//     6 n^2 + 1 positions (at most 8 segments) when that is under kBM.
// Read at the tower's shapes (H100 SXM, 700 W): 0.196 ms a conv (36.4
// TFLOP/s) at 384 -> 192 and 0.218 ms (32.7) at 192 -> 384, against cuDNN's
// 0.250 and 0.295.  What keeps it from the bound: the repack (~7%), the
// output's write, which one CTA an SM cannot overlap with its products (~6%
// at 37 MB of y, ~11% at 74 MB), and the last partial wave (~4%).  Threads
// of 8 x 12 accumulators, persistent CTAs that write one tile while loading
// the next or spread its write over the next one's steps, and 64-position
// tiles at two CTAs an SM each read slower.
// Refuses (cudaErrorInvalidValue) C or K not a multiple of 64, no board, more
// than 2^31 positions, or x or W^T not 16-byte aligned.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBK = 16, kStages = 4;
constexpr int kChannels = 64;  // C and K a multiple of the narrowest tile
constexpr int kMaxSegs = 8;  // board segments a position tile, at most
constexpr int kPad = 4;  // the output tile's row pad, floats

template <int WM, int WN>
struct Tile {
  static_assert(WN % 2 == 0, "a thread keeps one position column: kThreads a multiple of kBM");
  static constexpr int kBM = 64 * WM, kBN = 32 * WN, kThreads = 32 * WM * WN;
  static constexpr int kLdy = kBM + kPad;
  static constexpr int kRowStep = kThreads / kBM;  // a thread's rows of a tile, kRowStep apart
  // 16-byte chunk slots a staging row, at most (kBM / 4 + 2 a segment), and a thread's
  static constexpr int kMaxChunks = kBM / 4 + 2 * kMaxSegs;
  static constexpr int kSlots = (kBK * kMaxChunks + kThreads - 1) / kThreads;
  static constexpr int kMinBlocks = kThreads < 512 ? 512 / kThreads : 1;
  // shared floats for staging rows of ncf floats: the ring, or the output tile after it
  static int smem_floats(int ncf) {
    return std::max(kStages * kBK * (ncf + kBN) + 2 * kBK * kBM, kBN * kLdy);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

struct PointwiseArgs {
  const float* x;  // (B, C, n, n)
  const float* wt;  // (C, K): W^T
  float* y;  // (B, K, n, n)
  int C, K, nn;
  int pt;  // positions a tile
  int ncf;  // floats a staging row: 4 x its chunk slots
  long long P;  // B n^2 positions
  long long xlen;  // B C n^2 floats of x
};

// The board segments of the tile of positions [p0, pe): segment j is board
// b + j, positions qa_j .. qa_j + len_j of it, at tile columns col_j.. and
// staging chunk slots chunk_j.. (ceil(len_j / 4) + 1 of them).
struct Segments {
  int n = 0;
  long long b0 = 0;
  int qa[kMaxSegs], len[kMaxSegs], col[kMaxSegs], chunk[kMaxSegs + 1];

  __device__ Segments(long long p0, long long pe, int nn) {
    b0 = p0 / nn;
    chunk[0] = 0;
    for (long long p = p0; p < pe && n < kMaxSegs; ++n) {
      const long long b = p / nn;
      qa[n] = static_cast<int>(p - b * nn);
      len[n] = static_cast<int>(pe - p < nn - qa[n] ? pe - p : nn - qa[n]);
      col[n] = static_cast<int>(p - p0);
      chunk[n + 1] = chunk[n] + (len[n] + 3) / 4 + 1;
      p += len[n];
    }
  }
};

template <int WM, int WN>
__global__ void __launch_bounds__(Tile<WM, WN>::kThreads, Tile<WM, WN>::kMinBlocks)
pointwise_kernel(PointwiseArgs a) {
  using T = Tile<WM, WN>;
  constexpr int kBM = T::kBM, kBN = T::kBN, kThreads = T::kThreads, kRowStep = T::kRowStep;
  constexpr int kSlots = T::kSlots;
  extern __shared__ __align__(16) float smem_pw[];
  const int C = a.C, K = a.K, nn = a.nn, ncf = a.ncf;
  float* Raw = smem_pw;  // kStages x kBK staging rows of ncf floats
  float* Packed = Raw + kStages * kBK * ncf;  // 2 x kBK x kBM: x's rows c, positions p
  float* Bs = Packed + 2 * kBK * kBM;  // kStages x kBK x kBN: W^T's rows c
  const int tiles_n = K / kBN;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x - tm * tiles_n;
  const int tid = threadIdx.x, col = tid % kBM, row0 = tid / kBM;
  const long long p0 = static_cast<long long>(tm) * a.pt;
  const Segments seg(p0, p0 + a.pt < a.P ? p0 + a.pt : a.P, nn);
  const int chunks = seg.chunk[seg.n];  // chunk slots a staging row of this tile
  // this thread's chunks of a stage: x's offset at the first step and the
  // staging offset, or -1
  long long src[kSlots];
  int dst[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int id = tid + i * kThreads, r = id / chunks, c = id - r * chunks;
    dst[i] = -1;
    if (r < kBK) {
      int j = 0;
      while (c >= seg.chunk[j + 1]) ++j;
      // the segment's run of row r starts s floats past a 16-byte boundary
      const long long start = ((seg.b0 + j) * C + r) * nn + seg.qa[j];
      src[i] = start - (start & 3) + 4 * (c - seg.chunk[j]);
      dst[i] = r * ncf + 4 * c;
    }
  }
  // this thread's position: its segment, the staging float of row 0
  int mine = -1, shift_base = 0;
  if (col < a.pt && p0 + col < a.P) {
    int j = 0;
    while (col >= seg.col[j] + seg.len[j]) ++j;
    mine = 4 * seg.chunk[j] + col - seg.col[j];
    shift_base = seg.qa[j];
  }
  const float* wp = a.wt + static_cast<long long>(tn) * kBN;
  auto load = [&](int stage, int k0) {
    float* raw = Raw + stage * kBK * ncf;
    const long long step = static_cast<long long>(k0) * nn;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (dst[i] < 0) continue;
      const long long s = src[i] + step;
      const long long rem = a.xlen - s;
      cp_async16(raw + dst[i], a.x + s, rem >= 4 ? 16 : rem > 0 ? static_cast<int>(4 * rem) : 0);
    }
    float* bs = Bs + stage * kBK * kBN;
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads, r = id / (kBN / 4), c4 = id % (kBN / 4) * 4;
      cp_async16(bs + r * kBN + c4, wp + static_cast<long long>(k0 + r) * K + c4, 16);
    }
  };
  // the staging rows of a stage into a packed tile: row r of this thread's
  // segment starts (r n^2 + qa) mod 4 floats into its first chunk
  auto repack = [&](int stage, float* packed) {
    if (mine < 0) return;
    const float* raw = Raw + stage * kBK * ncf;
#pragma unroll
    for (int i = 0; i < (kBK + kRowStep - 1) / kRowStep; ++i) {
      const int r = row0 + i * kRowStep;
      if (r < kBK) packed[r * kBM + col] = raw[r * ncf + ((r * nn + shift_base) & 3) + mine];
    }
  };
  const int warp = tid >> 5, lane = tid & 31;
  const int rm = (warp / WN) * 64 + (lane >> 2) * 4;  // positions rm + 0..3 and rm + 32 + 0..3
  const int rn = (warp % WN) * 32 + (lane & 3) * 4;  // channels rn + 0..3 and rn + 16 + 0..3
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int steps = C / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s * kBK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
  __syncthreads();  // step 0 landed for all
  repack(0, Packed);
  for (int kt = 0; kt < steps; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3) : "memory");
    // step kt + 1 landed and step kt repacked, for all; step kt - 1's
    // product is done, so its W^T stage and packed tile are free, and the
    // staging stage repacked a step before it
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < steps) load(next % kStages, next * kBK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (kt + 1 < steps) repack((kt + 1) % kStages, Packed + ((kt + 1) & 1) * kBK * kBM);
    const float* as = Packed + (kt & 1) * kBK * kBM;
    const float* bs = Bs + (kt % kStages) * kBK * kBN;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kBM + rm);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kBM + rm + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * kBN + rn);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * kBN + rn + 16);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free: the output tile takes its place
  constexpr int kLdy = T::kLdy;
  // kBN channel rows x kLdy positions: row h kBN / 2 + 16 w + c holds
  // channel 32 w + 16 h + c of the tile (w a warp column)
  float* Ys = smem_pw;
  const int r0 = (warp % WN) * 16 + (lane & 3) * 4;  // this thread's rows: its channels rn + 16 h
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * half;
        *reinterpret_cast<float4*>(Ys + (h * kBN / 2 + r0 + j) * kLdy + rm + 32 * half) =
            make_float4(acc[i][4 * h + j], acc[i + 1][4 * h + j], acc[i + 2][4 * h + j],
                        acc[i + 3][4 * h + j]);
      }
  __syncthreads();
  if (mine < 0) return;
  const long long p = p0 + col;
  float* yp = a.y + p + p / nn * (K - 1LL) * nn + static_cast<long long>(tn) * kBN * nn;
#pragma unroll 4
  for (int r = row0; r < kBN; r += kRowStep) {
    const int h = r / (kBN / 2), c = r - h * (kBN / 2);
    const int k = (c / 16) * 32 + 16 * h + c % 16;
    yp[static_cast<long long>(k) * nn] = Ys[r * kLdy + col];
  }
}

template <int WM, int WN>
cudaError_t launch_tile(PointwiseArgs a, cudaStream_t st) {
  using T = Tile<WM, WN>;
  a.pt = std::min(T::kBM, 6 * a.nn + 1);  // at most kMaxSegs segments a tile
  const int segs = std::min(a.pt, (a.pt - 1) / a.nn + 2);
  a.ncf = 4 * ((a.pt + 3) / 4 + 2 * segs);
  const int smem = 4 * T::smem_floats(a.ncf);
  cudaError_t e = cudaFuncSetAttribute(pointwise_kernel<WM, WN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (a.P + a.pt - 1) / a.pt * (a.K / T::kBN);
  pointwise_kernel<WM, WN><<<static_cast<unsigned>(tiles), T::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One 1x1 conv (no bias) of x (B, C, n, n) by the weight whose transpose is
// wt (C, K) into y (B, K, n, n), all float32, nn = n^2.  One launch on
// stream; returns its cudaGetLastError().
int hex_pointwise_conv(const void* x, const void* wt, void* y, int B, int C, int K, int nn,
                       void* stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16 != 0 || B < 1 ||
      nn < 1 || C < kChannels || C % kChannels != 0 || K < kChannels || K % kChannels != 0 ||
      static_cast<long long>(B) * nn >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = static_cast<long long>(B) * nn;
  const PointwiseArgs a{static_cast<const float*>(x), static_cast<const float*>(wt),
                        static_cast<float*>(y), C, K, nn, 0, 0, P, P * C};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 192 == 0) return static_cast<int>(launch_tile<2, 6>(a, st));
  return static_cast<int>(launch_tile<2, 2>(a, st));
}

}  // extern "C"
