// The learner's kernels for Hopper (sm_90a): GAE (K5) and the fused PPO
// epoch sweep (K6), behind a plain C interface loaded with ctypes
// (ops/cuda_lib.py builds this file and hex_kernels.cu into one library).
// Never with --use_fast_math: expf/logf/sqrtf and the divisions must stay
// IEEE, or the kernels drift from their PyTorch twins.
//
// Each entry launches on the caller's stream, allocates nothing (the
// wrapper passes outputs and scratch), and returns cudaGetLastError() of
// its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hex_common.cuh"

namespace cg = cooperative_groups;
using hex::ld4;
using hex::Mlp;
using hex::round4;
using hex::row_stride;
using hex::Scratch;

namespace {

// ===========================================================================
// K5 — GAE.  Replaces ops/pallas_gae.py:_gae_kernel (entry `compute_gae`).
// Each env column walks t from T-1 down to 0:
//   delta = r + gamma*next_v*nt - v,  adv = delta + gl*nt*adv,  ret = adv + v
// (nt = 1 - done, next_v = v[t+1], or the last value at t = T-1).  Every
// operation is rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn, which
// nvcc never contracts into an FMA), in the order of the twin
// train/gae.compute_gae, so the two agree exactly; a parallel scan over t
// would round otherwise, so the walk through adv stays serial.
//
// Bound: bytes — T*B*(4+4+1) + 4B in and 2*T*B*4 out (~0.6 MB at T = 128,
// B = 256; 0.17 us at 3.35 TB/s).  The serial floor is the chain through
// adv, a multiply and an add per step (~8 cycles; ~0.6 us at T = 128).
//
// The first design gave one thread to each column in CTAs of 128 threads
// (B = 256 ran on 2 SMs) and loaded r, v and done inside the loop, so every
// step waited out a memory round trip: 29.5 us at the preset (T = 128,
// B = 256; ~230 ns per step, one H100).  A warp per 32 columns holding
// chunks of 16 or 32 steps in registers, the next chunk's loads issued
// before the current one's walk, took 7.8 and 12.5 us (once a compare right
// after each done byte's load, which made every step wait for its load, was
// moved to the walk): a single warp cannot keep enough loads in flight.
// Now only the chain is serial:
//   - a CTA of kGaeWarps warps owns 32 columns (B = 256 runs 8 CTAs) and
//     takes the steps in chunks of kGaeSteps from the top; every thread of
//     the CTA loads its share of the chunk (a column, every kGaeWarps-th
//     step: all its loads in flight before any use) and computes each
//     step's delta and gl*nt, which need no adv, into shared memory with v;
//   - after a barrier, warp 0 walks the chunk through adv = delta + c*adv,
//     two roundings per step, and writes adv and ret coalesced; a barrier
//     later the CTA takes the next chunk (T has no cap: the strict presets
//     run T = 2048);
//   - inputs may be strided views (the rollout record's reward and value
//     lanes), so the caller copies nothing; the outputs are one (2, T, B)
//     buffer.
// At the preset this took 5.5 us (one H100; 4 warps 7.1 us, 16 warps 5.5 us,
// chunks of 64 steps 7.2 us), 74 us at T = 2048, B = 256.
// ===========================================================================

constexpr int kGaeWarps = 8;
constexpr int kGaeSteps = 128;  // steps per chunk: 3 x 128 x 32 floats of shared memory

struct GaeArgs {
  const float* rewards;  // (T, B) at element strides (r_t, r_b)
  const float* values;
  const uint8_t* dones;
  const float* last_values;  // (B,) at stride l_b
  long long r_t, r_b, v_t, v_b, d_t, d_b, l_b;
  float* o_adv;  // (T, B) contiguous
  float* o_ret;
  int T, B;
  float gamma, gl;
};

__global__ void __launch_bounds__(32 * kGaeWarps) gae_kernel(const GaeArgs a) {
  __shared__ float s_delta[kGaeSteps][32], s_c[kGaeSteps][32], s_v[kGaeSteps][32];
  constexpr int kPer = kGaeSteps / kGaeWarps;  // steps a thread loads per chunk
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const bool live = b < a.B;  // every thread reaches every barrier
  float adv = 0.0f;           // warp 0's carry
  for (int t_hi = a.T - 1; t_hi >= 0; t_hi -= kGaeSteps) {
    const int n = min(kGaeSteps, t_hi + 1);
    // ---- the chunk's loads, then its delta and gl*nt (step k = t_hi - t)
    float r[kPer], v[kPer], nv[kPer];
    uint32_t d[kPer];  // raw bytes: compared only after every load is issued
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = wid + kGaeWarps * i;
      const long long t = t_hi - k;
      if (live && k < n) {
        r[i] = a.rewards[t * a.r_t + b * a.r_b];
        v[i] = a.values[t * a.v_t + b * a.v_b];
        d[i] = a.dones[t * a.d_t + b * a.d_b];
        nv[i] = t + 1 < a.T ? a.values[(t + 1) * a.v_t + b * a.v_b] : a.last_values[b * a.l_b];
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = wid + kGaeWarps * i;
      if (live && k < n) {
        const float nt = __fsub_rn(1.0f, d[i] ? 1.0f : 0.0f);
        s_delta[k][lane] = __fsub_rn(__fadd_rn(r[i], __fmul_rn(__fmul_rn(a.gamma, nv[i]), nt)), v[i]);
        s_c[k][lane] = __fmul_rn(a.gl, nt);
        s_v[k][lane] = v[i];
      }
    }
    __syncthreads();
    // ---- warp 0 walks the chain
    if (wid == 0 && live) {
      const long long o = static_cast<long long>(t_hi) * a.B + b;
      float* oa = a.o_adv + o;
      float* orr = a.o_ret + o;
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        adv = __fadd_rn(s_delta[k][lane], __fmul_rn(s_c[k][lane], adv));
        oa[-k * a.B] = adv;
        orr[-k * a.B] = __fadd_rn(adv, s_v[k][lane]);
      }
    }
    __syncthreads();  // the chunk's shared memory is free again
  }
}

// ===========================================================================
// K6 — the whole epochs x minibatches PPO sweep.  Replaces
// ops/pallas_ppo.py:_make_kernel (entries `make_pallas_update_fn` and
// `make_pallas_fast_update_fn`).  It computes what that kernel computes —
// per grad step the MLP forward of both towers, the masked-PPO loss with the
// minibatch's ddof=1 advantage normalisation, the hand-derived backward,
// optax's global-norm clip and Adam — on this port's own packing: separate
// pi (out = A) and vf (out = 1) towers, params / m / v as flat runs laid out
// as ops/policy_kernel.pack_agent.  Minibatch rows are read through the
// index array (idx (G, mb), or rowperm (n,) + a block order (G,)) from the
// ungathered obs (n, F) int8 and flt (n, 4) [action, logp_old, adv, ret];
// the legal mask is obs == 0 (the PPOBatch invariant).
//
// Bound: operations.  Per row and grad step the forward is
// 2(F*H + (L-1)*H*H + H*A) + 2(F*H + (L-1)*H*H + H) FLOP and the backward
// about twice that less the input gradient: ~31 GFLOP per sweep at the 7x7
// preset (n = 32768, mb = 4096, 10 epochs, H = 64), 0.457 ms at 67 TFLOP/s
// fp32 (about 5.7 us per grad step).
//
// Where the time went (phase clock, one chip run on an H100 80GB HBM3 at
// 700 W, 141 us per grad step): forward 48 us and backward 68 us (81%) —
// every chunk restaged each layer from L2 twice (11 round trips of two
// barriers) and ran ~17 one-output-per-thread fmaf loops, each ending in a
// barrier; the advantage statistics, gathered again in every CTA, 12.5 us;
// loss 6.7 us; the three grid syncs 3.9 us and the slot reduction 3.5 us
// together only 5%.  So this design cuts the per-chunk serial path and
// leaves the reduction's shape alone (no clusters):
//   - prologue, once per sweep: the CTAs split the G steps and compute each
//     step's advantage (mean, ddof=1 denom) into a (G, 2) scratch with the
//     old kernel's fixed order (the same values bit for bit), and write a
//     padded image of the parameters (each layer (n_in + 1) x S, the bias as
//     row n_in, S = the output width rounded up to 4 floats with S/4 odd, zero
//     pads); one grid sync;
//   - weights resident: each grad step copies the whole padded image into
//     shared memory with 16-byte cp.async.cg (L2, never a stale L1 line)
//     while the rows are gathered (MLP-default: 77 KB; MLP-deep: 148 KB at
//     16 rows).  Where it does not fit (MLP-wide-deep), one tower-layer at a
//     time is staged into two buffers in the order the phases use them, the
//     next one in flight while the current one is used;
//   - register-tiled phases: a thread owns a 4 x 4 tile (4 rows x 4 outputs;
//     for the weight gradient 4 inputs x 4 outputs), reads its weights as
//     float4 and keeps 16 accumulators; both towers' layers share one phase
//     and one barrier (resident), and a layer's weight gradient and its input
//     gradient run in the same phase (the input gradient goes to a separate
//     ping-pong buffer).  Per chunk: L + 1 forward phases, the loss (eight
//     lanes per row), L + 1 backward phases;
//   - the reduction: each CTA sums one slice of the parameters over all CTA
//     slots in a fixed order (groups of 32 slots, each in slot order, then
//     the groups in order), so runs are bitwise repeatable without float
//     atomics; CTA 0 sums the stat partials; then the global norm (one fixed
//     lane-strided order in every CTA), optax's clip and Adam on the slice,
//     which also writes the padded image.  Three grid syncs per step, as the
//     data flow needs: partials -> slices, slices -> norm, Adam -> the next
//     step's weights.
// After (the same clock, 512 threads per CTA, 56 us per grad step): the
// backward 25.5 us, the forward 13.0 us, the prologue (statistics read,
// rows gathered, weights copied) 6.2 us, the loss 4.2 us, the reduction
// 4.3 us and the three syncs 6.0 us.  Still fp32 FMA: TF32 tensor-core
// products would break the tolerances against the twin.  Data other CTAs wrote in this launch is read with
// __ldcg or cp.async.cg (L2).
// ===========================================================================

constexpr int kThreads = 512;
// phase clock: thread 0 of each CTA stamps clock64() at the start of each
// grad step and at the end of each of its phases (utils/profiling.py
// phase_split reads the buffer): prologue, forward, loss, backward,
// sync 1, reduce, sync 2, adam, sync 3.  Step 0's prologue includes the
// sweep's own prologue; with several chunks per CTA the marks inside the
// chunk loop are the last chunk's.
constexpr int kPpoMarks = 10;
constexpr int kMaxBlocks = 18;
constexpr int kAdvThreads = 256;  // 2 towers x (8 layers + head)

struct PpoArgs {
  const int8_t* obs;   // (n, F)
  const float* flt;    // (n, 4) [action, logp_old, adv, ret]
  const int* idx;      // (G, mb) rows, or (n,) rowperm when order is set
  const int* order;    // (G,) block order, or null
  const float* bias;   // (G, 2) [1 - b1^t, 1 - b2^t]
  float* p;            // (P,) params, updated in place
  float* m;            // (P,) Adam first moment
  float* v;            // (P,) Adam second moment
  float* stats;        // (G, 8)
  float* partial;      // (grid, P) per-CTA gradient partials
  float* stat_slots;   // (grid, 8)
  float* ss_slots;     // (grid,) per-slice sums of squares
  float* grad;         // (P,) reduced gradient
  float* adv;          // (G, 2) per-step advantage [mean, denom]
  float* p_pad;        // (Ppad,) the padded image of p
  long long* timers;   // (grid, G, kPpoMarks) clock64 stamps, or null
  Mlp mlp;
  int mb, G, R, P, resident, smem_floats;
  float lr, clip_lo, clip_hi, clip, ent_scale, vf_scale, max_norm, eps;
};

__device__ __forceinline__ void mark(long long* timers, int k) {
  if (timers != nullptr && threadIdx.x == 0) timers[k] = clock64();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(hex::kFullMask, v, o);
  return v;
}


// The packed layers: block k = t * (L + 1) + l of tower t (0 pi, 1 vf) is
// layer l (l == L the head) as (n_in + 1) x n_out, the bias as row n_in;
// in the padded image it is (n_in + 1) x row_stride(n_out).
struct Blocks {
  int n, P, Ppad, max_padded;
  int in[kMaxBlocks], out[kMaxBlocks], packed[kMaxBlocks + 1], padded[kMaxBlocks + 1];
};

__host__ __device__ inline void blocks_of(const Mlp& m, Blocks& b) {
  const int L = m.n_layers;
  b.n = 2 * (L + 1);
  int po = 0, qo = 0, mx = 0;
  for (int t = 0; t < 2; ++t) {
    for (int l = 0; l <= L; ++l) {
      const int k = t * (L + 1) + l;
      const int n_in = l == 0 ? m.F : m.H;
      const int n_out = l < L ? m.H : (t == 0 ? m.A : 1);
      const int sz = (n_in + 1) * row_stride(n_out);
      b.in[k] = n_in;
      b.out[k] = n_out;
      b.packed[k] = po;
      b.padded[k] = qo;
      po += (n_in + 1) * n_out;
      qo += sz;
      mx = sz > mx ? sz : mx;
    }
  }
  b.packed[b.n] = po;
  b.padded[b.n] = qo;
  b.P = po;
  b.Ppad = qo;
  b.max_padded = mx;
}

// packed index j -> its place in the padded image
__device__ __forceinline__ int padded_index(const Blocks& b, int j) {
  int k = 0;
  while (j >= b.packed[k + 1]) ++k;
  const int o = j - b.packed[k], n_out = b.out[k];
  const int i = o / n_out;
  return b.padded[k] + i * row_stride(n_out) + (o - i * n_out);
}

// shared-memory carve (floats; every segment a multiple of 4 floats)
struct Smem {
  float* w;      // resident: the padded image; staged: two stage buffers
  float* xs;     // (R, sF) input boards
  float* h;      // (2 towers, L, R, sH) hidden outputs
  float* D;      // (2 towers, 2, R, sH) ping-pong pre-activation gradients
  float* head;   // (R, sA) logits, then dlogits
  float* vhead;  // (R, 4) value, then dvalue
  float* rows;   // (R, 4) [action, logp_old, adv, ret]
  float* rstat;  // (R, 8) per-row stat terms (5 used)
  int* ridx;     // (R,) the chunk's batch rows
};

__host__ __device__ inline int ppo_smem_floats(const Mlp& m, const Blocks& b, int R, int resident) {
  const int sF = row_stride(m.F), sH = row_stride(m.H), sA = row_stride(m.A);
  const int w = resident ? b.Ppad : 2 * b.max_padded;
  return w + R * sF + 2 * m.n_layers * R * sH + 4 * R * sH + R * sA + R * 4 + R * 4 + R * 8 + R;
}

__device__ Smem carve(float* base, const Mlp& m, const Blocks& b, int R, int resident) {
  const int sF = row_stride(m.F), sH = row_stride(m.H), sA = row_stride(m.A);
  Smem s;
  s.w = base;
  s.xs = s.w + (resident ? b.Ppad : 2 * b.max_padded);
  s.h = s.xs + R * sF;
  s.D = s.h + 2 * m.n_layers * R * sH;
  s.head = s.D + 4 * R * sH;
  s.vhead = s.head + R * sA;
  s.rows = s.vhead + R * 4;
  s.rstat = s.rows + R * 4;
  s.ridx = reinterpret_cast<int*>(s.rstat + R * 8);
  return s;
}

// 16-byte asynchronous copies global -> shared through L2 (.cg)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread issues its share of a copy of n floats (n % 4 == 0, both ends
// 16-byte aligned), then commits one group
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n) {
  for (int q = threadIdx.x * 4; q < n; q += blockDim.x * 4) cp_async16(dst + q, src + q);
  cp_async_commit();
}

// ---- the register-tiled phases ----------------------------------------------

// out[r][j] = act(b[j] + sum_k in[r][k] W[k][j]): a 4-row x 4-column tile
struct Dense {
  const float* in;  // (rows, sin)
  const float* w;   // padded block, row stride S, bias row n_in
  float* out;       // (rows, sout)
  int sin, n_in, S, n_out, sout, act;  // act: 0 tanh, 1 relu, -1 none
};

__device__ __forceinline__ void dense_tile(const Dense& d, int r0, int c0) {
  float acc[4][4] = {};
  const float* x = d.in + r0 * d.sin;
  const float* w = d.w + c0;
#pragma unroll 4
  for (int k = 0; k < d.n_in; ++k) {
    const float4 wk = ld4(w + k * d.S);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xv = x[i * d.sin + k];
      acc[i][0] = fmaf(xv, wk.x, acc[i][0]);
      acc[i][1] = fmaf(xv, wk.y, acc[i][1]);
      acc[i][2] = fmaf(xv, wk.z, acc[i][2]);
      acc[i][3] = fmaf(xv, wk.w, acc[i][3]);
    }
  }
  const float4 b = ld4(w + d.n_in * d.S);
  const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = acc[i][e] + bb[e];
      o[e] = d.act < 0 ? z : hex::activate(z, d.act);
    }
    *reinterpret_cast<float4*>(d.out + (r0 + i) * d.sout + c0) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// slot[W (n_in, n_out), b] (+)= [in^T d, sum_r d] over nr rows, rows summed
// in order: a 4-input x 4-output tile (input n_in is the bias, input 1)
struct Grad {
  const float* in;  // (rows, sin)
  const float* d;   // (rows, sd), sd % 4 == 0, pads zero
  float* slot;      // the block's packed place in the CTA's slot
  int sin, n_in, sd, n_out;
};

__device__ __forceinline__ void grad_tile(const Grad& g, int i0, int j0, int nr, bool first) {
  float acc[4][4] = {};
#pragma unroll 2
  for (int r = 0; r < nr; ++r) {
    const float4 dv = ld4(g.d + r * g.sd + j0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q;
      const float xv = i < g.n_in ? g.in[r * g.sin + i] : 1.0f;
      acc[q][0] = fmaf(xv, dv.x, acc[q][0]);
      acc[q][1] = fmaf(xv, dv.y, acc[q][1]);
      acc[q][2] = fmaf(xv, dv.z, acc[q][2]);
      acc[q][3] = fmaf(xv, dv.w, acc[q][3]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + q;
    if (i > g.n_in) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + e;
      if (j < g.n_out) {
        float* o = g.slot + i * g.n_out + j;
        *o = first ? acc[q][e] : *o + acc[q][e];
      }
    }
  }
}

// out[r][i] = act'(h[r][i]) * sum_j d[r][j] W[i][j]: 4 rows x 4 inputs
// i0, i0 + C, i0 + 2C, i0 + 3C (C = ceil(n_in / 4)), so that neighbouring
// threads read neighbouring weight rows
struct Back {
  const float* d;  // (rows, sd), pads zero
  const float* w;  // padded block, row stride S (pads zero)
  const float* h;  // (rows, sh) the layer's input activations
  float* out;      // (rows, so)
  int sd, n4, S, n_in, sh, so, relu;
};

__device__ __forceinline__ void back_tile(const Back& b, int r0, int i0) {
  const int C = (b.n_in + 3) >> 2;
  const float* wq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) wq[q] = b.w + min(i0 + q * C, b.n_in - 1) * b.S;
  float acc[4][4] = {};
  for (int j = 0; j < b.n4; j += 4) {
    float4 dv[4], wv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) dv[p] = ld4(b.d + (r0 + p) * b.sd + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) wv[q] = ld4(wq[q] + j);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a = acc[p][q];
        a = fmaf(dv[p].x, wv[q].x, a);
        a = fmaf(dv[p].y, wv[q].y, a);
        a = fmaf(dv[p].z, wv[q].z, a);
        acc[p][q] = fmaf(dv[p].w, wv[q].w, a);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + q * C;
    if (i >= b.n_in) break;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float hv = b.h[(r0 + p) * b.sh + i];
      b.out[(r0 + p) * b.so + i] =
          b.relu ? (hv > 0.0f ? acc[p][q] : 0.0f) : acc[p][q] * (1.0f - hv * hv);
    }
  }
}

template <typename Job, typename Tile>
__device__ __forceinline__ void job_tiles(const Job& job, int n, int& t, Tile tile) {
  for (; t < n; t += blockDim.x) tile(job, t);
  t -= n;
}

// one forward phase: one or two dense jobs over the chunk's rows (the
// threads walk the jobs' tiles as one index space); ends with a sync
__device__ __forceinline__ void fwd_phase(const Dense& j0, const Dense& j1, int nj, int nr) {
  const int rgs = (nr + 3) >> 2;
  auto tile = [](const Dense& d, int u) {
    const int cg = (d.n_out + 3) >> 2;
    const int rg = u / cg;
    dense_tile(d, rg * 4, (u - rg * cg) * 4);
  };
  int t = threadIdx.x;
  job_tiles(j0, rgs * ((j0.n_out + 3) >> 2), t, tile);
  if (nj > 1) job_tiles(j1, rgs * ((j1.n_out + 3) >> 2), t, tile);
  __syncthreads();
}

// one backward phase: ng weight-gradient jobs and nb input-gradient jobs
// (the threads walk all their tiles as one index space); ends with a sync
__device__ __forceinline__ void bwd_phase(const Grad& g0, const Grad& g1, int ng, const Back& b0,
                                          const Back& b1, int nb, int nr, bool first) {
  auto gtile = [nr, first](const Grad& g, int u) {
    const int jg = (g.n_out + 3) >> 2;
    const int ig = u / jg;
    grad_tile(g, ig * 4, (u - ig * jg) * 4, nr, first);
  };
  auto btile = [](const Back& b, int u) {
    const int C = (b.n_in + 3) >> 2;
    const int rg = u / C;
    back_tile(b, rg * 4, u - rg * C);
  };
  const int rgs = (nr + 3) >> 2;
  int t = threadIdx.x;
  job_tiles(g0, ((g0.n_in + 4) >> 2) * ((g0.n_out + 3) >> 2), t, gtile);
  if (ng > 1) job_tiles(g1, ((g1.n_in + 4) >> 2) * ((g1.n_out + 3) >> 2), t, gtile);
  if (nb > 0) job_tiles(b0, rgs * ((b0.n_in + 3) >> 2), t, btile);
  if (nb > 1) job_tiles(b1, rgs * ((b1.n_in + 3) >> 2), t, btile);
  __syncthreads();
}

// The masked-PPO loss and its head gradients for the chunk's rows, eight
// lanes per row (shuffles within the lane group): head (logits) becomes
// dlogits, vhead (value) becomes dvalue, and rstat gets [min(unclipped,
// clipped), err^2, entropy, kl term, clipped].
constexpr int kLossLanes = 8;

__device__ __forceinline__ float group_sum(float v) {
  for (int o = kLossLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(hex::kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
  for (int o = kLossLanes / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(hex::kFullMask, v, o));
  return v;
}

__device__ void loss_rows(const PpoArgs& a, const Smem& s, int nr, float mean, float denom) {
  const int A = a.mlp.A, lane = threadIdx.x & (kLossLanes - 1);
  const int sF = row_stride(a.mlp.F), sA = row_stride(A);
  const int n_groups = blockDim.x / kLossLanes;
  // every lane of a warp runs the same trip count, so the shuffles stay full
  const int n_rounds = (nr + n_groups - 1) / n_groups;
  for (int k = 0; k < n_rounds; ++k) {
    const int r0 = k * n_groups + threadIdx.x / kLossLanes;
    const bool live = r0 < nr;
    const int r = live ? r0 : nr - 1;
    float* lg = s.head + r * sA;
    const float* x = s.xs + r * sF;
    const float* row = s.rows + r * 4;
    const int act = static_cast<int>(row[0]);
    float mx = -FLT_MAX;
    for (int j = lane; j < A; j += kLossLanes) mx = fmaxf(mx, x[j] == 0.0f ? lg[j] : hex::kMaskedLogit);
    mx = group_max(mx);
    float se = 0.0f;
    for (int j = lane; j < A; j += kLossLanes) se += expf((x[j] == 0.0f ? lg[j] : hex::kMaskedLogit) - mx);
    se = group_sum(se);
    const float lse = logf(se);
    const float lp_a = ((x[act] == 0.0f ? lg[act] : hex::kMaskedLogit) - mx) - lse;
    float plogp = 0.0f;
    for (int j = lane; j < A; j += kLossLanes) {
      if (x[j] != 0.0f) continue;
      const float z = lg[j] - mx;
      plogp += (expf(z) / se) * (z - lse);
    }
    const float ent = -group_sum(plogp);

    const float adv = (row[2] - mean) / denom;
    const float log_ratio = lp_a - row[1];
    const float ratio = expf(log_ratio);
    const float unclipped = adv * ratio;
    const float clipped = adv * fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
    const bool in_bounds = ratio > a.clip_lo && ratio < a.clip_hi;
    const bool active = unclipped <= clipped || in_bounds;
    const float dlp = active ? -(adv * ratio) / static_cast<float>(a.mb) : 0.0f;
    __syncwarp();  // every lane has read lg before any lane overwrites it
    if (live) {
      for (int j = lane; j < sA; j += kLossLanes) {
        float dj = 0.0f;
        if (j < A && x[j] == 0.0f) {
          const float z = lg[j] - mx;
          const float p = expf(z) / se;
          dj = dlp * ((j == act ? 1.0f : 0.0f) - p);
          if (a.ent_scale != 0.0f) dj += a.ent_scale * p * ((z - lse) + ent);
        }
        lg[j] = dj;  // pads too: the backward reads them as float4
      }
      if (lane == 0) {
        const float err = s.vhead[r * 4] - row[3];
        s.vhead[r * 4] = a.vf_scale * err;
        float* st = s.rstat + r * 5;
        st[0] = fminf(unclipped, clipped);
        st[1] = err * err;
        st[2] = ent;
        st[3] = (ratio - 1.0f) - log_ratio;
        st[4] = fabsf(ratio - 1.0f) > a.clip ? 1.0f : 0.0f;
      }
    }
    __syncwarp();
  }
  __syncthreads();
}

// staged mode: the tower-layers in the order the phases use them — forward
// (t, l) for l = 0..L, t = 0, 1; then backward (t, l) for l = L..1
__device__ __forceinline__ int stage_block(int item, int L) {
  const int nf = 2 * (L + 1);
  if (item < nf) return (item & 1) * (L + 1) + (item >> 1);
  const int u = item - nf;
  return (u & 1) * (L + 1) + (L - (u >> 1));
}

__device__ __forceinline__ void stage_issue(const PpoArgs& a, const Blocks& bl, float* buf, int item) {
  const int k = stage_block(item, a.mlp.n_layers);
  copy_async(buf + (item & 1) * bl.max_padded, a.p_pad + bl.padded[k],
             (bl.in[k] + 1) * row_stride(bl.out[k]));
}

// staged mode: start the copy of the item after this one (or an empty
// group), wait for this one's, and return its buffer
__device__ __forceinline__ const float* stage_next(const PpoArgs& a, const Blocks& bl, float* buf,
                                                   int& item) {
  const int n_items = 4 * a.mlp.n_layers + 2;
  if (item + 1 < n_items) stage_issue(a, bl, buf, item + 1);
  else cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  return buf + ((item++) & 1) * bl.max_padded;
}

__global__ void __launch_bounds__(kThreads, 1) ppo_kernel(PpoArgs a) {
  extern __shared__ __align__(16) float smem_ppo[];
  __shared__ Scratch red;
  __shared__ float cta_stats[5];
  __shared__ float total_sq;
  __shared__ Blocks bl;
  cg::grid_group grid = cg::this_grid();
  const Mlp& m = a.mlp;
  const int tid = threadIdx.x, c = blockIdx.x, n_cta = gridDim.x;
  const int mb = a.mb, R = a.R, P = a.P, L = m.n_layers;
  const bool resident = a.resident != 0;
  const int sF = row_stride(m.F), sH = row_stride(m.H), sA = row_stride(m.A);
  if (tid == 0) blocks_of(m, bl);
  __syncthreads();
  const Smem s = carve(smem_ppo, m, bl, R, a.resident);
  // this CTA's slice of the parameters for the reduction and Adam
  const int lo = static_cast<int>(static_cast<long long>(c) * P / n_cta);
  const int hi = static_cast<int>(static_cast<long long>(c + 1) * P / n_cta);
  float* my_slot = a.partial + static_cast<long long>(c) * P;
  long long* tim0 = a.timers != nullptr ? a.timers + static_cast<long long>(c) * a.G * kPpoMarks : nullptr;
  mark(tim0, 0);

  // ---- sweep prologue: per-step advantage statistics, the padded image ----
  for (int g = c; g < a.G; g += n_cta) {
    const int* rows = a.order != nullptr ? a.idx + static_cast<long long>(a.order[g]) * mb
                                         : a.idx + static_cast<long long>(g) * mb;
    // (unrolled loops keep their sums in order; the unroll only lets the
    // independent gathers be in flight together)
    // the first kAdvThreads threads stride the rows, the rest add 0.0f: the
    // order of the 256-thread kernel this one replaced, so the same bits
    float acc = 0.0f;
#pragma unroll 8
    for (int k = tid; k < mb && tid < kAdvThreads; k += kAdvThreads) acc += a.flt[rows[k] * 4 + 2];
    const float mean = hex::block_sum(acc, red) / static_cast<float>(mb);
    acc = 0.0f;
#pragma unroll 8
    for (int k = tid; k < mb && tid < kAdvThreads; k += kAdvThreads) {
      const float dv = a.flt[rows[k] * 4 + 2] - mean;
      acc += dv * dv;
    }
    const float var = hex::block_sum(acc, red) / static_cast<float>(mb - 1);
    if (tid == 0) {
      a.adv[2 * g] = mean;
      a.adv[2 * g + 1] = sqrtf(var) + 1e-8f;
    }
  }
  for (int q = c * blockDim.x + tid; q < bl.Ppad; q += n_cta * blockDim.x) {
    int k = 0;
    while (q >= bl.padded[k + 1]) ++k;
    const int S = row_stride(bl.out[k]), o = q - bl.padded[k];
    const int i = o / S, j = o - i * S;
    a.p_pad[q] = j < bl.out[k] ? a.p[bl.packed[k] + i * bl.out[k] + j] : 0.0f;
  }
  grid.sync();

  for (int step = 0; step < a.G; ++step) {
    long long* tm = tim0 != nullptr ? tim0 + static_cast<long long>(step) * kPpoMarks : nullptr;
    if (step > 0) mark(tm, 0);
    const int* rows = a.order != nullptr ? a.idx + static_cast<long long>(a.order[step]) * mb
                                         : a.idx + static_cast<long long>(step) * mb;
    if (resident) copy_async(s.w, a.p_pad, bl.Ppad);
    const float mean = __ldcg(a.adv + 2 * step), denom = __ldcg(a.adv + 2 * step + 1);
    if (tid < 5) cta_stats[tid] = 0.0f;

    bool first = true;
    for (int q0 = c * R; q0 < mb; q0 += n_cta * R) {
      const int nr = min(R, mb - q0);
      int item = 0;
      if (!resident) stage_issue(a, bl, s.w, 0);
      for (int r = tid; r < nr; r += blockDim.x) s.ridx[r] = rows[q0 + r];
      __syncthreads();
#pragma unroll 4
      for (int o = tid; o < nr * m.F; o += blockDim.x) {
        const int r = o / m.F, i = o - r * m.F;
        s.xs[r * sF + i] = static_cast<float>(a.obs[static_cast<long long>(s.ridx[r]) * m.F + i]);
      }
      for (int o = tid; o < nr * 4; o += blockDim.x) s.rows[o] = a.flt[s.ridx[o / 4] * 4 + (o & 3)];
      if (resident) cp_async_wait<0>();
      __syncthreads();
      mark(tm, 1);

      // ---- forward: L + 1 phases (one per tower in staged mode) ----------
      for (int l = 0; l <= L; ++l) {
        for (int t0 = 0; t0 < 2; t0 += resident ? 2 : 1) {
          Dense jobs[2];
          const int nt = resident ? 2 : 1;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u >= nt) break;
            const int t = t0 + u, k = t * (L + 1) + l;
            const float* w = resident ? s.w + bl.padded[k] : stage_next(a, bl, s.w, item);
            Dense& d = jobs[u];
            d.in = l == 0 ? s.xs : s.h + ((t * L) + l - 1) * R * sH;
            d.sin = l == 0 ? sF : sH;
            d.n_in = bl.in[k];
            d.w = w;
            d.S = row_stride(bl.out[k]);
            d.n_out = bl.out[k];
            d.out = l < L ? s.h + (t * L + l) * R * sH : (t == 0 ? s.head : s.vhead);
            d.sout = l < L ? sH : (t == 0 ? sA : 4);
            d.act = l < L ? m.relu : -1;
          }
          fwd_phase(jobs[0], jobs[1], nt, nr);
        }
      }
      mark(tm, 2);
      loss_rows(a, s, nr, mean, denom);
      if (tid < 5)
        for (int r = 0; r < nr; ++r) cta_stats[tid] += s.rstat[r * 5 + tid];
      mark(tm, 3);

      // ---- backward: head, layers L-1..1 (weight and input gradients
      // together), then layer 0's weight gradients ---------------------------
      for (int l = L; l >= 0; --l) {
        const int step_t = (resident || l == 0) ? 2 : 1;
        for (int t0 = 0; t0 < 2; t0 += step_t) {
          Grad gs[2];
          Back bs[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u >= step_t) break;
            const int t = t0 + u, k = t * (L + 1) + l;
            const float* dz = l == L ? (t == 0 ? s.head : s.vhead) : s.D + (t * 2 + (l & 1)) * R * sH;
            const int sd = l == L ? (t == 0 ? sA : 4) : sH;
            const float* hin = l == 0 ? s.xs : s.h + (t * L + l - 1) * R * sH;
            Grad& g = gs[u];
            g.in = hin;
            g.sin = l == 0 ? sF : sH;
            g.n_in = bl.in[k];
            g.d = dz;
            g.sd = sd;
            g.n_out = bl.out[k];
            g.slot = my_slot + bl.packed[k];
            if (l > 0) {
              Back& b = bs[u];
              b.d = dz;
              b.sd = sd;
              b.n4 = round4(bl.out[k]);
              b.w = resident ? s.w + bl.padded[k] : stage_next(a, bl, s.w, item);
              b.S = row_stride(bl.out[k]);
              b.n_in = m.H;
              b.h = hin;
              b.sh = sH;
              b.out = s.D + (t * 2 + ((l - 1) & 1)) * R * sH;
              b.so = sH;
              b.relu = m.relu;
            }
          }
          bwd_phase(gs[0], gs[1], step_t, bs[0], bs[1], l > 0 ? step_t : 0, nr, first);
        }
      }
      mark(tm, 4);
      first = false;
    }
    if (tid < 5) a.stat_slots[c * 8 + tid] = cta_stats[tid];
    grid.sync();
    mark(tm, 5);

    // ---- reduce this CTA's slice over all slots, in a fixed order ---------
    // CTA 0: warp k < 8 writes stat k (the first five summed over the slots,
    // lane-strided, then a fixed shuffle tree)
    const int warp = tid >> 5, lane = tid & 31;
    if (c == 0 && warp < 8) {
      float sum = 0.0f;
      if (warp < 5)
        for (int k = lane; k < n_cta; k += 32) sum += __ldcg(a.stat_slots + k * 8 + warp);
      sum = warp_sum(sum);
      if (lane == 0) a.stats[step * 8 + warp] = (warp == 0 ? -sum : sum) / static_cast<float>(mb);
    }
    // groups of 32 slots summed in slot order, in parallel; then the groups
    // in order (the shared memory is free until the next step's copy)
    const int width = hi - lo;
    int ngrp = (n_cta + 31) >> 5;
    if (width * ngrp > a.smem_floats) ngrp = 1;
    float* part = smem_ppo;
    if (ngrp > 1) {
      for (int it = tid; it < width * ngrp; it += blockDim.x) {
        const int grp = it / width, j = lo + (it - grp * width);
        float vals[32];
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const int k = grp * 32 + u;
          vals[u] = k < n_cta ? __ldcg(a.partial + static_cast<long long>(k) * P + j) : 0.0f;
        }
        float g = 0.0f;
#pragma unroll
        for (int u = 0; u < 32; ++u) g += vals[u];  // + 0.0f past the last slot changes nothing
        part[it] = g;
      }
      __syncthreads();
    }
    float sq = 0.0f;
    for (int j = lo + tid; j < hi; j += blockDim.x) {
      float g = 0.0f;
      if (ngrp > 1) {
        for (int grp = 0; grp < ngrp; ++grp) g += part[grp * width + (j - lo)];
      } else {
#pragma unroll 16
        for (int k = 0; k < n_cta; ++k) g += __ldcg(a.partial + static_cast<long long>(k) * P + j);
      }
      a.grad[j] = g;
      sq += g * g;
    }
    sq = hex::block_sum(sq, red);
    if (tid == 0) a.ss_slots[c] = sq;
    mark(tm, 6);
    grid.sync();
    mark(tm, 7);

    // ---- global norm, clip scale, Adam on this slice -------------------------
    if (warp == 0) {  // the same lane-strided sum and shuffle tree in every CTA
      float tot = 0.0f;
      for (int k = lane; k < n_cta; k += 32) tot += __ldcg(a.ss_slots + k);
      tot = warp_sum(tot);
      if (lane == 0) total_sq = tot;
    }
    __syncthreads();
    const float gnorm = sqrtf(total_sq);
    const float scale = gnorm < a.max_norm ? 1.0f : a.max_norm / gnorm;
    const float bc1 = a.bias[step * 2], bc2 = a.bias[step * 2 + 1];
    for (int j = lo + tid; j < hi; j += blockDim.x) {
      const float g = a.grad[j] * scale;
      const float mj = 0.9f * a.m[j] + 0.1f * g;
      const float vj = 0.999f * a.v[j] + 0.001f * (g * g);
      a.m[j] = mj;
      a.v[j] = vj;
      const float pj = a.p[j] - a.lr * (mj / bc1) / (sqrtf(vj / bc2) + a.eps);
      a.p[j] = pj;
      a.p_pad[padded_index(bl, j)] = pj;
    }
    mark(tm, 8);
    grid.sync();
    mark(tm, 9);
  }
}

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// ===========================================================================
// C interface
// ===========================================================================

extern "C" {

int hex_gae(const void* rewards, long long r_t, long long r_b, const void* values, long long v_t,
            long long v_b, const void* dones, long long d_t, long long d_b, const void* last_values,
            long long l_b, void* o_out, int T, int B, float gamma, float gl, void* stream) {
  float* out = static_cast<float*>(o_out);  // (2, T, B): advantages, then returns
  const GaeArgs a{static_cast<const float*>(rewards),
                  static_cast<const float*>(values),
                  static_cast<const uint8_t*>(dones),
                  static_cast<const float*>(last_values),
                  r_t, r_b, v_t, v_b, d_t, d_b, l_b,
                  out, out + static_cast<long long>(T) * B,
                  T, B, gamma, gl};
  gae_kernel<<<(B + 31) / 32, 32 * kGaeWarps, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

// The sweep's launch shape for one model and minibatch: plan = [grid, R
// (rows per chunk), dynamic shared-memory bytes, resident (1: the whole
// padded parameter image in shared memory; 0: staged per tower-layer),
// Ppad (floats of the padded image)].  The resident layout is taken at the
// largest R (32, 16, 8, 4) that fits, else the staged one.  grid never
// exceeds the CTAs that fit on the card at once (a cooperative launch needs
// them all resident) nor the number of R-row chunks of a minibatch, so
// every CTA owns at least one chunk.
int hex_ppo_plan(int F, int H, int A, int n_layers, int mb, int* plan) {
  const Mlp m{F, H, A, n_layers, 0};
  if (n_layers < 1 || n_layers > 8) return static_cast<int>(cudaErrorInvalidValue);
  Blocks b;
  blocks_of(m, b);
  const long long limit = 220 * 1024;
  int R = 0, resident = 1;
  for (int mode = 1; mode >= 0 && R == 0; --mode) {
    for (int r = 32; r >= 4; r /= 2) {
      if (static_cast<long long>(ppo_smem_floats(m, b, r, mode)) * 4 <= limit) {
        R = r;
        resident = mode;
        break;
      }
    }
  }
  if (R == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = ppo_smem_floats(m, b, R, resident) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(ppo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, n_sm = 0, per_sm = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ppo_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int chunks = (mb + R - 1) / R;
  plan[0] = per_sm * n_sm < chunks ? per_sm * n_sm : chunks;
  plan[1] = R;
  plan[2] = smem;
  plan[3] = resident;
  plan[4] = b.Ppad;
  return 0;
}

// One cooperative launch of the sweep (grid, R, smem and resident from
// hex_ppo_plan).
int hex_ppo(const void* obs, const void* flt, const void* idx, const void* order, const void* bias,
            void* p, void* m, void* v, void* stats, void* partial, void* stat_slots, void* ss_slots,
            void* grad, void* adv, void* p_pad, int F, int H, int A, int n_layers, int relu, int mb,
            int G, float lr, float clip, float clip_lo, float clip_hi, float ent_scale,
            float vf_scale, float max_norm, float eps, int grid, int R, int smem, int resident,
            void* timers, void* stream) {
  PpoArgs a{};
  a.obs = static_cast<const int8_t*>(obs);
  a.flt = static_cast<const float*>(flt);
  a.idx = static_cast<const int*>(idx);
  a.order = static_cast<const int*>(order);
  a.bias = static_cast<const float*>(bias);
  a.p = static_cast<float*>(p);
  a.m = static_cast<float*>(m);
  a.v = static_cast<float*>(v);
  a.stats = static_cast<float*>(stats);
  a.partial = static_cast<float*>(partial);
  a.stat_slots = static_cast<float*>(stat_slots);
  a.ss_slots = static_cast<float*>(ss_slots);
  a.grad = static_cast<float*>(grad);
  a.adv = static_cast<float*>(adv);
  a.p_pad = static_cast<float*>(p_pad);
  a.timers = static_cast<long long*>(timers);
  a.mlp = Mlp{F, H, A, n_layers, relu};
  a.mb = mb;
  a.G = G;
  a.R = R;
  a.P = hex::tower_size(a.mlp, A) + hex::tower_size(a.mlp, 1);
  a.resident = resident;
  a.smem_floats = smem / static_cast<int>(sizeof(float));
  a.lr = lr;
  a.clip = clip;
  a.clip_lo = clip_lo;
  a.clip_hi = clip_hi;
  a.ent_scale = ent_scale;
  a.vf_scale = vf_scale;
  a.max_norm = max_norm;
  a.eps = eps;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ppo_kernel), dim3(grid),
                                              dim3(kThreads), args, static_cast<size_t>(smem),
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return finish_launch();
}

}  // extern "C"
