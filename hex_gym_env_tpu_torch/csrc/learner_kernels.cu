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
using hex::Mlp;
using hex::Scratch;

namespace {

// ===========================================================================
// K5 — GAE.  Replaces ops/pallas_gae.py:_gae_kernel (entry `compute_gae`).
// One thread per env column walks t from T-1 down to 0; neighbouring threads
// read neighbouring words of each (T, B) row, so every load is coalesced.
// Bound: bytes — T*B*(4+4+1) + 4B in and 2*T*B*4 out (~0.6 MB at T = 128,
// B = 256; 0.19 us at 3.35 TB/s).  The recurrence is serial in t, so with
// B = 256 only 256 threads run; the kernel is latency-bound (T dependent
// steps).  Every operation is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn, which nvcc never contracts into an FMA), in the order of the
// twin train/gae.compute_gae, so the two agree exactly.
// ===========================================================================

__global__ void gae_kernel(const float* __restrict__ rewards, const float* __restrict__ values,
                           const uint8_t* __restrict__ dones, const float* __restrict__ last_values,
                           float* __restrict__ o_adv, float* __restrict__ o_ret, int T, int B,
                           float gamma, float gl) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float adv = 0.0f;
  float next_v = last_values[b];
  for (int t = T - 1; t >= 0; --t) {
    const long long i = static_cast<long long>(t) * B + b;
    const float v = values[i];
    const float nt = __fsub_rn(1.0f, dones[i] ? 1.0f : 0.0f);
    const float delta = __fsub_rn(__fadd_rn(rewards[i], __fmul_rn(__fmul_rn(gamma, next_v), nt)), v);
    adv = __fadd_rn(delta, __fmul_rn(__fmul_rn(gl, nt), adv));
    o_adv[i] = adv;
    o_ret[i] = __fadd_rn(adv, v);
    next_v = v;
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
// One cooperative persistent launch per sweep: grid = at most the CTAs that
// fit on the card at once, 256 threads each.  Each grad step runs in phases:
//   1. every CTA computes the minibatch's advantage mean and ddof=1 std
//      itself, in one fixed order, so all CTAs hold bitwise the same values;
//   2. each CTA runs forward and backward for its chunks of R rows and
//      writes its partial gradient (P floats) and 5 stat partials to its own
//      slot in global memory;
//   3. grid sync;
//   4. each CTA sums one slice of the parameters over all CTA slots in slot
//      order (no float atomics: runs are bitwise repeatable), with the
//      slice's sum of squares; CTA 0 sums the stat partials;
//   5. grid sync;
//   6. every CTA sums the slices' squares in one fixed order (lane-strided,
//      then a fixed shuffle tree) -> global norm -> clip scale;
//   7. Adam on its own slice (bias corrections from the
//      host's (G, 2) table: 1 - b^t, t = count0 + step + 1);
//   8. grid sync, so the next step reads the new parameters.
// Data other CTAs wrote in this launch is read with __ldcg (L2, never a
// stale L1 line).
//
// Bound: operations.  Per row and grad step the forward is
// 2(F*H + (L-1)*H*H + H*A) + 2(F*H + (L-1)*H*H + H) FLOP and the backward
// about twice that less the input gradient: ~31 GFLOP per sweep at the 7x7
// preset (n = 32768, mb = 4096, 10 epochs, H = 64), 0.46 ms at 67 TFLOP/s
// fp32.  This simple design uses no tensor cores: each layer is a loop of
// fmaf over weights staged in shared memory (rows padded by one word against
// bank conflicts), one output per thread, and the grid syncs and the
// per-step reduction over all CTA slots add a fixed cost per grad step.
// wgmma/TMA tiles are later work.
// ===========================================================================

constexpr int kThreads = 256;

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
  Mlp mlp;
  int mb, G, R, P;
  float lr, clip_lo, clip_hi, clip, ent_scale, vf_scale, max_norm, eps;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(hex::kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(hex::kFullMask, v, o));
  return v;
}

// Copies one layer (W (n_in, n_out) then b (n_out), as packed) from global
// memory into shared memory with a row stride of n_out + 1 (b lands in row
// n_in).  Each thread keeps kInFlight loads in flight: the copy is bound by
// L2 latency, not bandwidth.
constexpr int kInFlight = 8;

__device__ void stage_layer(const float* g, int n_in, int n_out, float* s) {
  __syncthreads();  // every reader of the previous layer is done
  const int stride = n_out + 1, total = n_in * n_out + n_out;
  for (int base = threadIdx.x; base < total; base += kInFlight * blockDim.x) {
    float vals[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int o = base + u * blockDim.x;
      vals[u] = o < total ? __ldcg(g + o) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int o = base + u * blockDim.x;
      if (o < total) {
        const int i = o / n_out;
        s[i * stride + (o - i * n_out)] = vals[u];
      }
    }
  }
  __syncthreads();
}

// out[r][j] = act(b[j] + sum_i in[r][i] W[i][j]) for nr rows; act: 0 tanh,
// 1 relu, -1 none.  Ends with a sync.
__device__ void dense_rows(const float* in, int n_in, const float* s, int n_out, int nr, float* out,
                           int act) {
  const int stride = n_out + 1;
  const float* b = s + n_in * stride;
  for (int o = threadIdx.x; o < nr * n_out; o += blockDim.x) {
    const int r = o / n_out, j = o - r * n_out;
    const float* x = in + r * n_in;
    float acc = 0.0f;
    for (int i = 0; i < n_in; ++i) acc = fmaf(x[i], s[i * stride + j], acc);
    acc += b[j];
    out[o] = act < 0 ? acc : hex::activate(acc, act);
  }
  __syncthreads();
}

// h[r][i] <- act'(h[r][i]) * sum_j d[r][j] W[i][j]: the upstream gradient
// of a layer's pre-activation, written over that layer's output.  Ends with
// a sync.
__device__ void back_rows(const float* d, int n_out, const float* s, int n_in, int nr, float* h,
                          int relu) {
  const int stride = n_out + 1;
  for (int o = threadIdx.x; o < nr * n_in; o += blockDim.x) {
    const int r = o / n_in, i = o - r * n_in;
    const float* dr = d + r * n_out;
    const float* w = s + i * stride;
    float acc = 0.0f;
    for (int j = 0; j < n_out; ++j) acc = fmaf(dr[j], w[j], acc);
    const float hv = h[o];
    h[o] = relu ? (hv > 0.0f ? acc : 0.0f) : acc * (1.0f - hv * hv);
  }
  __syncthreads();
}

// slot[W (n_in, n_out), b (n_out)] (+)= [in^T d, sum_r d] over nr rows, rows
// summed in order.  Each element has one owner thread across chunks.
__device__ void grad_rows(const float* in, int n_in, const float* d, int n_out, int nr, float* slot,
                          bool first) {
  const int nw = n_in * n_out;
  for (int o = threadIdx.x; o < nw + n_out; o += blockDim.x) {
    float acc = 0.0f;
    if (o < nw) {
      const int i = o / n_out, j = o - i * n_out;
      for (int r = 0; r < nr; ++r) acc = fmaf(in[r * n_in + i], d[r * n_out + j], acc);
    } else {
      const int j = o - nw;
      for (int r = 0; r < nr; ++r) acc += d[r * n_out + j];
    }
    slot[o] = first ? acc : slot[o] + acc;
  }
}

struct Layout {
  float* xs;     // (R, F) input boards
  float* acts;   // (2 towers, L, R, H) layer outputs, then their gradients
  float* head;   // (R, A) logits, then dlogits
  float* vhead;  // (R,) value, then dvalue
  float* rows;   // (R, 4) [action, logp_old, adv, ret]
  float* rstat;  // (R, 5) per-row stat terms
  float* stage;  // one staged layer
  int* ridx;     // (R,) the chunk's batch rows
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int stage_floats(const Mlp& m) {
  int s = m.F * (m.H + 1) + m.H;
  s = imax(s, m.H * (m.H + 1) + m.H);
  s = imax(s, m.H * (m.A + 1) + m.A);
  return s;
}

__host__ __device__ inline int ppo_smem_floats(const Mlp& m, int R) {
  // floats, then R ints of row indices
  return R * m.F + 2 * m.n_layers * R * m.H + R * m.A + R + R * 4 + R * 5 + stage_floats(m) + R;
}

__device__ Layout carve(float* base, const Mlp& m, int R) {
  Layout l;
  l.xs = base;
  l.acts = l.xs + R * m.F;
  l.head = l.acts + 2 * m.n_layers * R * m.H;
  l.vhead = l.head + R * m.A;
  l.rows = l.vhead + R;
  l.rstat = l.rows + R * 4;
  l.stage = l.rstat + R * 5;
  l.ridx = reinterpret_cast<int*>(l.stage + stage_floats(m));
  return l;
}


// the (R, H) output buffer of tower t's layer l
__device__ __forceinline__ float* layer_out(const Layout& s, const Mlp& m, int R, int t, int l) {
  return s.acts + (t * m.n_layers + l) * R * m.H;
}

// Forward of tower t (packed weights w, head width out) over the chunk's nr
// rows: layer outputs into acts, head outputs into y.
__device__ void tower_forward(const Mlp& m, int R, const Layout& s, int t, const float* w, int out,
                              float* y, int nr) {
  const float* in = s.xs;
  int n_in = m.F;
  for (int l = 0; l < m.n_layers; ++l) {
    stage_layer(w, n_in, m.H, s.stage);
    float* h = layer_out(s, m, R, t, l);
    dense_rows(in, n_in, s.stage, m.H, nr, h, m.relu);
    w += n_in * m.H + m.H;
    in = h;
    n_in = m.H;
  }
  stage_layer(w, m.H, out, s.stage);
  dense_rows(in, m.H, s.stage, out, nr, y, -1);
}

// Backward of tower t from the head gradient d (nr, out): gradients into
// slot (the tower's packed layout), activation gradients over acts.
__device__ void tower_backward(const Mlp& m, int R, const Layout& s, int t, const float* w, int out,
                               const float* d, int nr, float* slot, bool first) {
  // offsets of each layer in the packed tower
  int off[9];
  int n_in = m.F, o = 0;
  for (int l = 0; l < m.n_layers; ++l) {
    off[l] = o;
    o += n_in * m.H + m.H;
    n_in = m.H;
  }
  off[m.n_layers] = o;
  const int L = m.n_layers;
  float* top = layer_out(s, m, R, t, L - 1);
  grad_rows(top, m.H, d, out, nr, slot + off[L], first);
  stage_layer(w + off[L], m.H, out, s.stage);
  back_rows(d, out, s.stage, m.H, nr, top, m.relu);
  for (int l = L - 1; l >= 0; --l) {
    const float* dz = layer_out(s, m, R, t, l);
    const float* in = l == 0 ? s.xs : layer_out(s, m, R, t, l - 1);
    grad_rows(in, l == 0 ? m.F : m.H, dz, m.H, nr, slot + off[l], first);
    if (l > 0) {
      stage_layer(w + off[l], m.H, m.H, s.stage);
      back_rows(dz, m.H, s.stage, m.H, nr, layer_out(s, m, R, t, l - 1), m.relu);
    }
  }
}

// The masked-PPO loss and its head gradients for the chunk's rows, one warp
// per row: head (logits) becomes dlogits, vhead (value) becomes dvalue, and
// rstat gets [min(unclipped, clipped), err^2, entropy, kl term, clipped].
__device__ void loss_rows(const PpoArgs& a, const Layout& s, int nr, float mean, float denom) {
  const int A = a.mlp.A, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < nr; r += n_warps) {
    float* lg = s.head + r * A;
    const float* x = s.xs + r * a.mlp.F;
    const float* row = s.rows + r * 4;
    const int act = static_cast<int>(row[0]);
    float mx = -FLT_MAX;
    for (int j = lane; j < A; j += 32) mx = fmaxf(mx, x[j] == 0.0f ? lg[j] : hex::kMaskedLogit);
    mx = warp_max(mx);
    float se = 0.0f;
    for (int j = lane; j < A; j += 32) se += expf((x[j] == 0.0f ? lg[j] : hex::kMaskedLogit) - mx);
    se = warp_sum(se);
    const float lse = logf(se);
    const float lp_a = ((x[act] == 0.0f ? lg[act] : hex::kMaskedLogit) - mx) - lse;
    float plogp = 0.0f;
    for (int j = lane; j < A; j += 32) {
      if (x[j] != 0.0f) continue;
      const float z = lg[j] - mx;
      plogp += (expf(z) / se) * (z - lse);
    }
    const float ent = -warp_sum(plogp);

    const float adv = (row[2] - mean) / denom;
    const float log_ratio = lp_a - row[1];
    const float ratio = expf(log_ratio);
    const float unclipped = adv * ratio;
    const float clipped = adv * fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
    const bool in_bounds = ratio > a.clip_lo && ratio < a.clip_hi;
    const bool active = unclipped <= clipped || in_bounds;
    const float dlp = active ? -(adv * ratio) / static_cast<float>(a.mb) : 0.0f;
    __syncwarp();  // every lane has read lg before any lane overwrites it
    for (int j = lane; j < A; j += 32) {
      float dj = 0.0f;
      if (x[j] == 0.0f) {
        const float z = lg[j] - mx;
        const float p = expf(z) / se;
        dj = dlp * ((j == act ? 1.0f : 0.0f) - p);
        if (a.ent_scale != 0.0f) dj += a.ent_scale * p * ((z - lse) + ent);
      }
      lg[j] = dj;
    }
    if (lane == 0) {
      const float err = s.vhead[r] - row[3];
      s.vhead[r] = a.vf_scale * err;
      float* st = s.rstat + r * 5;
      st[0] = fminf(unclipped, clipped);
      st[1] = err * err;
      st[2] = ent;
      st[3] = (ratio - 1.0f) - log_ratio;
      st[4] = fabsf(ratio - 1.0f) > a.clip ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) ppo_kernel(PpoArgs a) {
  extern __shared__ float smem_ppo[];
  __shared__ Scratch red;
  __shared__ float cta_stats[5];
  __shared__ float total_sq;
  cg::grid_group grid = cg::this_grid();
  const Mlp& m = a.mlp;
  const int tid = threadIdx.x, c = blockIdx.x, n_cta = gridDim.x;
  const int mb = a.mb, R = a.R, P = a.P;
  const Layout s = carve(smem_ppo, m, R);
  const int pi_size = hex::tower_size(m, m.A);
  // this CTA's slice of the parameters for the reduction and Adam
  const int lo = static_cast<int>(static_cast<long long>(c) * P / n_cta);
  const int hi = static_cast<int>(static_cast<long long>(c + 1) * P / n_cta);
  float* my_slot = a.partial + static_cast<long long>(c) * P;

  for (int step = 0; step < a.G; ++step) {
    const int* rows = a.order != nullptr ? a.idx + static_cast<long long>(a.order[step]) * mb
                                         : a.idx + static_cast<long long>(step) * mb;
    // ---- 1. the minibatch's advantage mean and ddof=1 std ----------------
    // (unrolled loops below keep their sums in order; the unroll only lets
    // the independent gathers be in flight together)
    float acc = 0.0f;
#pragma unroll 8
    for (int k = tid; k < mb; k += blockDim.x) acc += a.flt[rows[k] * 4 + 2];
    const float mean = hex::block_sum(acc, red) / static_cast<float>(mb);
    acc = 0.0f;
#pragma unroll 8
    for (int k = tid; k < mb; k += blockDim.x) {
      const float dv = a.flt[rows[k] * 4 + 2] - mean;
      acc += dv * dv;
    }
    const float var = hex::block_sum(acc, red) / static_cast<float>(mb - 1);
    const float denom = sqrtf(var) + 1e-8f;
    if (tid < 5) cta_stats[tid] = 0.0f;

    // ---- 2. forward + backward of this CTA's chunks ----------------------
    bool first = true;
    for (int q0 = c * R; q0 < mb; q0 += n_cta * R) {
      const int nr = min(R, mb - q0);
      for (int r = tid; r < nr; r += blockDim.x) s.ridx[r] = rows[q0 + r];
      __syncthreads();
#pragma unroll 4
      for (int o = tid; o < nr * m.F; o += blockDim.x) {
        const int r = o / m.F, i = o - r * m.F;
        s.xs[o] = static_cast<float>(a.obs[static_cast<long long>(s.ridx[r]) * m.F + i]);
      }
      for (int o = tid; o < nr * 4; o += blockDim.x) s.rows[o] = a.flt[s.ridx[o / 4] * 4 + (o & 3)];
      __syncthreads();
      tower_forward(m, R, s, 0, a.p, m.A, s.head, nr);
      tower_forward(m, R, s, 1, a.p + pi_size, 1, s.vhead, nr);
      loss_rows(a, s, nr, mean, denom);
      if (tid < 5)
        for (int r = 0; r < nr; ++r) cta_stats[tid] += s.rstat[r * 5 + tid];
      tower_backward(m, R, s, 0, a.p, m.A, s.head, nr, my_slot, first);
      tower_backward(m, R, s, 1, a.p + pi_size, 1, s.vhead, nr, my_slot + pi_size, first);
      __syncthreads();
      first = false;
    }
    if (tid < 5) a.stat_slots[c * 8 + tid] = cta_stats[tid];
    grid.sync();

    // ---- 4. reduce this CTA's slice over all slots, in slot order --------
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
    float sq = 0.0f;
    for (int j = lo + tid; j < hi; j += blockDim.x) {
      float g = 0.0f;
#pragma unroll 16
      for (int k = 0; k < n_cta; ++k) g += __ldcg(a.partial + static_cast<long long>(k) * P + j);
      a.grad[j] = g;
      sq += g * g;
    }
    sq = hex::block_sum(sq, red);
    if (tid == 0) a.ss_slots[c] = sq;
    grid.sync();

    // ---- 6-7. global norm, clip scale, Adam on this slice -----------------
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
      a.p[j] = a.p[j] - a.lr * (mj / bc1) / (sqrtf(vj / bc2) + a.eps);
    }
    grid.sync();
  }
}

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// ===========================================================================
// C interface
// ===========================================================================

extern "C" {

int hex_gae(const void* rewards, const void* values, const void* dones, const void* last_values,
            void* o_adv, void* o_ret, int T, int B, float gamma, float gl, void* stream) {
  const int threads = 128;
  gae_kernel<<<(B + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const uint8_t*>(dones), static_cast<const float*>(last_values),
      static_cast<float*>(o_adv), static_cast<float*>(o_ret), T, B, gamma, gl);
  return finish_launch();
}

// The sweep's launch shape for one model and minibatch: plan = [grid, R
// (rows per chunk), dynamic shared-memory bytes].  grid never exceeds the
// CTAs that fit on the card at once (a cooperative launch needs them all
// resident) nor the number of R-row chunks of a minibatch, so every CTA
// owns at least one chunk.
int hex_ppo_plan(int F, int H, int A, int n_layers, int mb, int* plan) {
  const Mlp m{F, H, A, n_layers, 0};
  if (n_layers < 1 || n_layers > 8) return static_cast<int>(cudaErrorInvalidValue);
  int R = 32;
  const int limit = 220 * 1024;
  while (R > 1 && ppo_smem_floats(m, R) * static_cast<int>(sizeof(float)) > limit) R /= 2;
  const int smem = ppo_smem_floats(m, R) * static_cast<int>(sizeof(float));
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
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
  return 0;
}

// One cooperative launch of the sweep (grid and R from hex_ppo_plan).
int hex_ppo(const void* obs, const void* flt, const void* idx, const void* order, const void* bias,
            void* p, void* m, void* v, void* stats, void* partial, void* stat_slots, void* ss_slots,
            void* grad, int F, int H, int A, int n_layers, int relu, int mb, int G, float lr,
            float clip, float clip_lo, float clip_hi, float ent_scale, float vf_scale,
            float max_norm, float eps, int grid, int R, int smem, void* stream) {
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
  a.mlp = Mlp{F, H, A, n_layers, relu};
  a.mb = mb;
  a.G = G;
  a.R = R;
  a.P = hex::tower_size(a.mlp, A) + hex::tower_size(a.mlp, 1);
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
