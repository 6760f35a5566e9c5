// The 3x3 convs of the residual towers as a float32 Winograd F(4x4, 3x3)
// conv (C entry hex_winograd_conv: three kernels, wino_input_kernel,
// wino_gemm_kernel and wino_output_kernel, on the caller's stream), for
// Hopper (sm_90a) behind a plain C interface (ops/cuda_lib.py builds this
// file with the others into one library; ops/winograd.py is its wrapper and
// holds its plain PyTorch twin).
//
// Replaces no TPU kernel: the JAX package has no residual tower, and its
// convs are XLA's.  Added because cuDNN, asked for the AZ-ResNet tower's
// 256 -> 256 3x3 convs at 400 11x11 boards in full float32, runs an FFT
// algorithm: it pads the board to 16x16 (144 complex frequencies, 576 real
// multiplies a board, input and output channel), and it flips and
// transforms the same bound filters again on every call.  Here the filters
// are transformed once a bind (U = G g G^T, in float64 by the wrapper,
// rounded once to float32), and a conv of C input and K output channels
// (each a multiple of 64; the KataGo tower's are 192 -> 192 and 128 -> 192)
// is:
//   1. wino_input_kernel: the board x (B, C, n, n) NCHW, cut into
//      ceil(n/4)^2 tiles of 4x4 outputs, each tile's 6x6 input patch (pad
//      1, zero outside the board) to V = B^T d B, written as
//      V[c][xi][p], xi = 6 a + b the 36 points, p = b T + t the tile
//      (T tiles a board), rows padded to Ppad (a multiple of 128);
//   2. wino_gemm_kernel: M[xi] = V[xi]^T U[xi], 36 independent
//      (Ppad x C) (C x K) float32 products, FFMA only, M[p][xi][k];
//   3. wino_output_kernel: y = A^T M A for each tile and output channel,
//      the ragged row and column past the board dropped, y (B, K, n, n)
//      NCHW.
// The points are {0, 1, -1, 1/2, -2, inf}: B^T and A^T below, G (fractions
// kept in G) in ops/winograd.py.  Exact in real arithmetic; in float32 the
// transforms' weights raise the rounding over the direct sum (~1.6e-6 of
// the output's RMS at C = 256, against ~1.7e-7 direct).
//
// Bound, at B = 400, C = K = 256, 11x11 (P = 3,600 tiles): by operations,
// the 36 products' 17.0 GFLOP, 0.254 ms at 67 TFLOP/s (the direct conv's
// count is 57.1 GFLOP, 0.852 ms); by bytes, x read and y written once and
// U read once, 108.7 MB, 0.032 ms at 3.35 TB/s.  V and M (132.7 MB each)
// are this design's own traffic: the transforms are bound by it, the
// product by its FFMAs.  Design:
//   - input: a CTA takes nb boards x cg channels, nb T a multiple of 32
//     (32 boards at 11x11) and about 256 tiles in all, stages their
//     planes (each board's cg n^2 floats are contiguous) in shared memory,
//     one thread a tile, and writes each (xi, c) row as runs of 32
//     consecutive p that start on 128 bytes, so a warp stores one line;
//   - product: 128 x kBN CTA tiles of 2 kBN threads with 8 x 8
//     accumulators each (a warp 64 x 32, a thread rows {4l, 4l + 32} +
//     0..3 and columns {4l', 4l' + 16} + 0..3 of it, so each shared-memory
//     read is a broadcast float4), a depth step of kBK = 16 from a ring of
//     kStages = 3 stages filled by 16-byte cp.async; V^T's rows and U's
//     rows are both contiguous along the tile, so neither is transposed on
//     the way; CTAs run point by point (xi-major), so a point's V (3.7 MB)
//     and U (256 KB) are read from L2 by all its tiles.  Two template
//     instances of the product: kBN = 128 (256 threads) where K is a
//     multiple of 128, the AZ-ResNet's 256 -> 256 tiling, unchanged; kBN =
//     64 (128 threads, the same warp and thread tiles, half the warps
//     across) for every other K, a multiple of 64 (192: three column tiles
//     of 64, not a 128 and a 64 in two launches).  Each output's sum runs
//     over the depth in the same order in both, so the arithmetic is the
//     same.  The 128 instance runs at ~65% of the float32 peak at 1,980
//     MHz; 8 x 16 accumulators, a depth step of 8 or 32 and 2 or 4 stages
//     read within 2% of it;
//   - output: a CTA takes one board x kKC output channels, reads M[p][xi]
//     as runs of kKC channels, builds the kKC planes in shared memory and
//     writes them out as kKC n^2 contiguous floats (float4 stores).
// Refuses (cudaErrorInvalidValue) a board above kMaxBoard, C or K not a
// multiple of 64, or a pointer not 16-byte aligned.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <numeric>

namespace {

constexpr int kPoints = 36;  // 6 x 6 transformed points a tile
constexpr int kMaxBoard = 19;  // the output CTA's kKC planes in 48 KB of shared memory
constexpr int kKC = 32;  // output transform: output channels a CTA
constexpr int kBM = 128, kBK = 16, kStages = 3;
constexpr int kChannels = 64;  // C and K a multiple of the narrow product tile
// the product's threads and shared bytes for a tile of kBN columns (48 KB
// at 128: no opt-in needed)
template <int kBN> __host__ __device__ constexpr int gemm_threads() { return 2 * kBN; }
template <int kBN> __host__ __device__ constexpr int gemm_smem() {
  return kStages * kBK * (kBM + kBN) * 4;
}

// v = B^T d along one axis
__device__ __forceinline__ void input_1d(const float (&d)[6], float (&v)[6]) {
  v[0] = d[0] - 1.5f * d[1] - 2.0f * d[2] + 1.5f * d[3] + d[4];
  v[1] = -d[1] + 0.5f * d[2] + 2.5f * d[3] + d[4];
  v[2] = d[1] - 2.5f * d[2] + 0.5f * d[3] + d[4];
  v[3] = -2.0f * d[1] - d[2] + 2.0f * d[3] + d[4];
  v[4] = 0.5f * d[1] - d[2] - 0.5f * d[3] + d[4];
  v[5] = d[1] - 1.5f * d[2] - 2.0f * d[3] + 1.5f * d[4] + d[5];
}

// y = A^T m along one axis
__device__ __forceinline__ void output_1d(const float (&m)[6], float (&y)[4]) {
  const float s = m[1] + m[2], t = m[1] - m[2];
  y[0] = m[0] + s + m[3] + m[4];
  y[1] = t + 0.5f * m[3] - 2.0f * m[4];
  y[2] = s + 0.25f * m[3] + 4.0f * m[4];
  y[3] = t + 0.125f * m[3] - 8.0f * m[4] + m[5];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

struct WinoArgs {
  const float* x;  // (B, C, n, n)
  const float* u;  // (36, C, K)
  float* v;  // (C, 36, Ppad)
  float* m;  // (Ppad, 36, K)
  float* y;  // (B, K, n, n)
  int B, C, K, n, tn, Ppad;
  int nb, cg;  // input transform: boards and channels a CTA
};

__global__ void __launch_bounds__(1024) wino_input_kernel(WinoArgs a) {
  extern __shared__ __align__(16) float smem_in[];  // nb boards x cg planes of n^2
  const int n = a.n, nn = n * n, tn = a.tn, T = tn * tn, cg = a.cg;
  const int b0 = blockIdx.x * a.nb, c0 = blockIdx.y * cg;
  const int nb = min(a.nb, a.B - b0);
  const int chunk = cg * nn;  // a board's cg planes, contiguous
  for (int i = threadIdx.x; i < nb * chunk; i += blockDim.x) {  // all in flight at once
    const int j = i / chunk;
    cp_async4(smem_in + i, a.x + (static_cast<long long>(b0 + j) * a.C + c0) * nn + (i - j * chunk));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int np = nb * T;  // tiles of the CTA: a run of p
  const long long point = a.Ppad, plane = kPoints * point;  // V[c][xi][p]
  for (int it = threadIdx.x; it < cg * np; it += blockDim.x) {
    const int cc = it / np, pl = it - cc * np;
    const int j = pl / T, t = pl - j * T, ty = t / tn, tx = t - ty * tn;
    const float* src = smem_in + (j * cg + cc) * nn;
    float d[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int row = 4 * ty - 1 + r;
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        const int col = 4 * tx - 1 + s;
        d[r][s] = (row >= 0 && row < n && col >= 0 && col < n) ? src[row * n + col] : 0.0f;
      }
    }
    float w[6][6];  // B^T d
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const float col[6] = {d[0][s], d[1][s], d[2][s], d[3][s], d[4][s], d[5][s]};
      float o[6];
      input_1d(col, o);
#pragma unroll
      for (int r = 0; r < 6; ++r) w[r][s] = o[r];
    }
    float* dst = a.v + static_cast<long long>(c0 + cc) * plane + static_cast<long long>(b0) * T + pl;
#pragma unroll
    for (int r = 0; r < 6; ++r) {  // (B^T d) B
      float o[6];
      input_1d(w[r], o);
#pragma unroll
      for (int s = 0; s < 6; ++s) dst[(6 * r + s) * point] = o[s];
    }
  }
}

template <int kBN>
__global__ void __launch_bounds__(2 * kBN, 256 / kBN) wino_gemm_kernel(WinoArgs a) {
  constexpr int kThreads = gemm_threads<kBN>(), kWarpsN = kBN / 32;
  extern __shared__ __align__(16) float smem_gemm[];
  float* As = smem_gemm;  // kStages x kBK x kBM: V^T's rows k, tile columns p
  float* Bs = smem_gemm + kStages * kBK * kBM;  // kStages x kBK x kBN: U's rows k
  const int C = a.C, K = a.K, Ppad = a.Ppad;
  const int tiles_n = K / kBN, per_point = (Ppad / kBM) * tiles_n;
  const int xi = blockIdx.x / per_point, rest = blockIdx.x - xi * per_point;
  const int tm = rest / tiles_n, tn = rest - tm * tiles_n;
  const long long v_row = static_cast<long long>(kPoints) * Ppad;  // V[c][xi][p]
  const float* A = a.v + static_cast<long long>(xi) * Ppad + tm * kBM;
  const float* Bg = a.u + static_cast<long long>(xi) * C * K + tn * kBN;
  const int tid = threadIdx.x;
  auto load = [&](int stage, int k0) {
    if constexpr (kBN == kBM) {  // the 128 instance: A's and B's copies in turn
#pragma unroll
      for (int i = 0; i < kBK * kBM / 4 / kThreads; ++i) {
        const int id = tid + i * kThreads, row = id / (kBM / 4), c4 = id % (kBM / 4) * 4;
        cp_async16(As + (stage * kBK + row) * kBM + c4, A + (k0 + row) * v_row + c4);
        cp_async16(Bs + (stage * kBK + row) * kBN + c4,
                   Bg + static_cast<long long>(k0 + row) * K + c4);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK * kBM / 4 / kThreads; ++i) {
        const int id = tid + i * kThreads, row = id / (kBM / 4), c4 = id % (kBM / 4) * 4;
        cp_async16(As + (stage * kBK + row) * kBM + c4, A + (k0 + row) * v_row + c4);
      }
#pragma unroll
      for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
        const int id = tid + i * kThreads, row = id / (kBN / 4), c4 = id % (kBN / 4) * 4;
        cp_async16(Bs + (stage * kBK + row) * kBN + c4,
                   Bg + static_cast<long long>(k0 + row) * K + c4);
      }
    }
  };
  const int warp = tid >> 5, lane = tid & 31;
  const int rm = (warp / kWarpsN) * 64 + (lane >> 2) * 4;  // rows rm + 0..3 and rm + 32 + 0..3
  const int rn = (warp % kWarpsN) * 32 + (lane & 3) * 4;  // columns rn + 0..3 and rn + 16 + 0..3
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
  for (int kt = 0; kt < steps; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // step kt landed for all; step kt - 1's stage is free
    const int next = kt + kStages - 1;
    if (next < steps) load(next % kStages, next * kBK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* as = As + (kt % kStages) * kBK * kBM;
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
  const long long m_row = static_cast<long long>(kPoints) * K;  // M[p][xi][k]
  float* out = a.m + (tm * kBM) * m_row + static_cast<long long>(xi) * K + tn * kBN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = out + (rm + (i < 4 ? i : 28 + i)) * m_row;
    *reinterpret_cast<float4*>(row + rn) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + rn + 16) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

__global__ void wino_output_kernel(WinoArgs a) {
  extern __shared__ __align__(16) float smem_out[];  // kKC planes of n^2
  const int n = a.n, nn = n * n, tn = a.tn, T = tn * tn, K = a.K;
  const int b = blockIdx.x, k0 = blockIdx.y * kKC;
  const int point = K;  // M[p][xi][k]
  for (int it = threadIdx.x; it < T * kKC; it += blockDim.x) {
    const int t = it / kKC, kk = it - t * kKC, ty = t / tn, tx = t - ty * tn;
    const float* src = a.m + (static_cast<long long>(b) * T + t) * kPoints * K + k0 + kk;
    float w[4][6];  // A^T M
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      const float col[6] = {src[(0 + s) * point], src[(6 + s) * point], src[(12 + s) * point],
                            src[(18 + s) * point], src[(24 + s) * point], src[(30 + s) * point]};
      float o[4];
      output_1d(col, o);
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i][s] = o[i];
    }
    float* dst = smem_out + kk * nn;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (A^T M) A
      float o[4];
      output_1d(w[i], o);
      const int row = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * tx + j;
        if (row < n && col < n) dst[row * n + col] = o[j];
      }
    }
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(a.y + (static_cast<long long>(b) * K + k0) * nn);
  for (int i = threadIdx.x; i < kKC * nn / 4; i += blockDim.x)
    out[i] = reinterpret_cast<const float4*>(smem_out)[i];
}

int round_up(int v, int to) { return (v + to - 1) / to * to; }

}  // namespace

extern "C" {

// One conv of x (B, C, n, n) by the filter image u (36, C, K) into y (B, K,
// n, n), all float32 NCHW, through the scratch v (C, 36, Ppad) and m (Ppad,
// 36, K), Ppad = B ceil(n/4)^2 rounded up to 128 (ops/winograd.py
// allocates both).  Three launches on stream; returns the first launch's
// error, else cudaGetLastError() of the last.
int hex_winograd_conv(const void* x, const void* u, void* v, void* m, void* y, int B, int C,
                      int K, int n, void* stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(u) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(m) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0 ||
      B < 1 || C < kChannels || C % kChannels != 0 || K < kChannels || K % kChannels != 0 ||
      n < 1 || n > kMaxBoard)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tn = (n + 3) / 4, T = tn * tn;
  if (static_cast<long long>(B) * T > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  // input transform: nb boards (nb T a multiple of 32, so each (xi, c) run
  // of p starts on 128 bytes) x cg channels, about 256 tiles a CTA (cg is 1,
  // 2, 4 or 8, a divisor of C)
  const int nb = 32 / std::gcd(T, 32), cg = std::max(1, std::min(8, 256 / (nb * T)));
  WinoArgs a{static_cast<const float*>(x), static_cast<const float*>(u), static_cast<float*>(v),
             static_cast<float*>(m), static_cast<float*>(y), B, C, K, n, tn,
             round_up(B * T, kBM), nb, cg};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nn = n * n;
  const dim3 in_grid((B + nb - 1) / nb, C / cg);
  const int in_threads = std::min(1024, round_up(cg * nb * T, 32));
  wino_input_kernel<<<in_grid, in_threads, nb * cg * nn * 4, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (K % 128 == 0)
    wino_gemm_kernel<128><<<kPoints * (a.Ppad / kBM) * (K / 128), gemm_threads<128>(),
                            gemm_smem<128>(), st>>>(a);
  else
    wino_gemm_kernel<64><<<kPoints * (a.Ppad / kBM) * (K / 64), gemm_threads<64>(),
                           gemm_smem<64>(), st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int out_threads = std::min(1024, round_up(T * kKC, 32));
  wino_output_kernel<<<dim3(B, K / kKC), out_threads, kKC * nn * 4, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
