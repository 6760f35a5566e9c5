// Device functions shared by the kernels of hex_kernels.cu and
// learner_kernels.cu (every one inline: both files include this header): move
// decoding, the flat-label union with its win test, the MLP towers, and the
// masked Gumbel-max sample with its log-softmax.
//
// One CTA holds one game.  Functions that take shared-memory arrays are
// called by every thread of the CTA with the same per-game scalars, so the
// scalars they return are the same on every thread and the control flow
// around their __syncthreads() stays uniform.
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>

#include <curand_kernel.h>

namespace hex {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaskedLogit = -FLT_MAX;  // float32 min, as ops/masked.py

// floor division, as jnp's // on int32 (C++ / truncates toward zero)
__device__ __forceinline__ int floordiv(int a, int n) {
  int q = a / n;
  if ((a % n != 0) && ((a < 0) != (n < 0))) --q;
  return q;
}

// mover-frame action -> world-frame flat cell (seat 1 sees the transpose)
__device__ __forceinline__ int to_world(int action, int to_move, int n) {
  const int ym = floordiv(action, n);
  const int xm = action - ym * n;
  return to_move == 0 ? ym * n + xm : xm * n + ym;
}

// ---------------------------------------------------------------------------
// Random bits -> samples, exactly the map of the JAX kernels
// (ops/pallas_policy.py _gumbel/_sample_row, ops/pallas_rollout.py reset draws)
// ---------------------------------------------------------------------------

// top 24 bits as a float in [0, 1)
__device__ __forceinline__ float unit_uniform(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = unit_uniform(bits) + 2.98023223876953125e-08f;  // + 2^-25
  return -logf(-logf(u));
}

// A source of 32-bit words for one thread: an injected row of bits (the
// JAX interpret-mode layout) or the thread's own Philox stream.
struct Bits {
  const uint32_t* row;  // null: draw from the Philox state
  curandStatePhilox4_32_10_t* state;
  __device__ __forceinline__ uint32_t at(int j) const {
    return row != nullptr ? row[j] : curand(state);
  }
};

// ---------------------------------------------------------------------------
// Block reductions (blockDim.x a multiple of 32, at most 1024)
// ---------------------------------------------------------------------------

struct Scratch {
  float v[32];
  int i[32];
};

// strict order of (value, index): larger value first, then LOWER index —
// jnp.argmax / torch.argmax break ties to the first maximum
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ int block_argmax(float v, int i, Scratch& s) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, o);
    const int oi = __shfl_xor_sync(kFullMask, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s.v[warp] = v;
    s.i[warp] = i;
  }
  __syncthreads();
  float bv = s.v[0];
  int bi = s.i[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    if (better(s.v[w], s.i[w], bv, bi)) {
      bv = s.v[w];
      bi = s.i[w];
    }
  }
  __syncthreads();
  return bi;
}

__device__ __forceinline__ float block_max(float v, Scratch& s) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  if ((threadIdx.x & 31) == 0) s.v[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s.v[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, s.v[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, Scratch& s) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  if ((threadIdx.x & 31) == 0) s.v[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = s.v[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r += s.v[w];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// MLP towers.  A tower's weights are one flat float32 run, kernels (in, out)
// row-major so that neighbouring threads (neighbouring outputs) read
// neighbouring words:
//   [W0 (F,H), b0 (H), {Wl (H,H), bl (H)} x (n_layers-1), Wout (H,out), bout (out)]
// The agent is its pi tower (out = A) followed by its vf tower (out = 1); a
// bank member is one pi tower.  See ops/policy_kernel.py for the packing.
// ---------------------------------------------------------------------------

struct Mlp {
  int F, H, A, n_layers, relu;
};

__host__ __device__ __forceinline__ int tower_size(const Mlp& m, int out) {
  return m.F * m.H + m.H + (m.n_layers - 1) * (m.H * m.H + m.H) + m.H * out + out;
}

__device__ __forceinline__ float activate(float v, int relu) {
  return relu ? fmaxf(v, 0.0f) : tanhf(v);
}

// dot(x[0:in], W[:, j]) + b[j] in the order k = 0, 1, ...
__device__ __forceinline__ float dense_unit(const float* W, const float* b, const float* x,
                                            int in, int out, int j) {
  float acc = 0.0f;
  for (int k = 0; k < in; ++k) acc = fmaf(x[k], W[k * out + j], acc);
  return acc + b[j];
}

// Runs tower t0 (out0 outputs) and, when t1 is not null, tower t1 (out1
// outputs) side by side on input x (F floats).  h0/h1 are 2H-float scratch
// buffers; y receives out0 (+ out1) outputs.  Weights may lie in shared or
// global memory (generic pointers).  Ends with __syncthreads().
__device__ inline void mlp_towers(const Mlp& m, const float* t0, int out0, const float* t1,
                                  int out1, const float* x, float* h0, float* h1, float* y) {
  const int ntow = t1 != nullptr ? 2 : 1;
  const int H = m.H;
  const float* hin = x;
  float* hout = h0;
  int in = m.F;
  int woff = 0;
  for (int l = 0; l < m.n_layers; ++l) {
    const int boff = woff + in * H;
    for (int j = threadIdx.x; j < ntow * H; j += blockDim.x) {
      const int tw = j / H, jj = j - tw * H;
      const float* w = tw == 0 ? t0 : t1;
      const float* xin = l == 0 ? x : hin + tw * H;
      hout[j] = activate(dense_unit(w + woff, w + boff, xin, in, H, jj), m.relu);
    }
    __syncthreads();
    hin = hout;
    hout = hout == h0 ? h1 : h0;
    woff = boff + H;
    in = H;
  }
  for (int j = threadIdx.x; j < out0 + (ntow == 2 ? out1 : 0); j += blockDim.x) {
    const bool second = j >= out0;
    const int out = second ? out1 : out0;
    const int jj = second ? j - out0 : j;
    const float* w = second ? t1 : t0;
    y[j] = dense_unit(w + woff, w + woff + H * out, hin + (second ? H : 0), H, out, jj);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Masked sample.  logits (A floats, shared) is overwritten with the masked
// logits; legal may be shared or global.  With noise, the action is the
// argmax of masked + gumbel(bits); without (eval), of masked.  Returns the
// action on every thread and its log-softmax in *logp.  Ends with a sync.
// ---------------------------------------------------------------------------

__device__ inline int masked_sample(float* logits, const uint8_t* legal, int A, bool noise,
                                    const Bits& bits, float* masked_out, float* logp,
                                    Scratch& s) {
  // (-FLT_MAX, INT_MAX) loses to every real entry, masked ones included
  float bv = -FLT_MAX, mx = -FLT_MAX;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    const float m = legal[j] ? logits[j] : kMaskedLogit;
    logits[j] = m;
    if (masked_out != nullptr) masked_out[j] = m;
    const float score = noise ? m + gumbel(bits.at(j)) : m;
    if (better(score, j, bv, bi)) {
      bv = score;
      bi = j;
    }
    mx = fmaxf(mx, m);
  }
  const int action = block_argmax(bv, bi, s);
  if (logp != nullptr) {
    const float zmax = block_max(mx, s);
    float se = 0.0f;
    for (int j = threadIdx.x; j < A; j += blockDim.x) se += expf(logits[j] - zmax);
    const float lse = logf(block_sum(se, s));
    *logp = (logits[action] - zmax) - lse;
  }
  return action;
}

// ---------------------------------------------------------------------------
// Flat-label union (ops/labels.py place_stone).  st0/st1 (L bytes) and lab
// (L ints) are the game's stones and labels in shared memory; thread t owns
// lane t (blockDim.x >= L).  Places seat s's stone at world cell c when act
// (c must then lie in [0, L)), relabels every node of the merged group to c,
// and returns the win: the mover's two edge virtuals share a group after the
// move.  With pre_connected false only a join made by this stone's group
// counts (K7's test), not edges that were connected before the move.  act
// is uniform over the CTA, so the early return is too.
// ---------------------------------------------------------------------------

struct Board {
  int n, F, L;
};

__device__ inline bool place_stone(const Board& g, uint8_t* st0, uint8_t* st1, int* lab, int s,
                                   int c, bool act, bool pre_connected = true) {
  if (!act) return false;
  const int n = g.n;
  const uint8_t* mine = s == 0 ? st0 : st1;
  const int y = c / n, x = c - (c / n) * n;
  const bool top = y > 0, bot = y < n - 1, lft = x > 0, rgt = x < n - 1;
  const int offs[6] = {-n, -n + 1, -1, 1, n - 1, n};
  const bool nb_ok[6] = {top, top && rgt, lft, rgt, bot && lft, bot};
  const int e0 = g.F + 2 * s;
  const int lab_e0 = lab[e0], lab_e1 = lab[e0 + 1];

  int slot[8];
  bool elig[8];
  for (int k = 0; k < 6; ++k) {
    const int id = min(max(c + offs[k], 0), g.L - 1);  // invalid slots stay in bounds
    slot[k] = lab[id];
    elig[k] = nb_ok[k] && mine[id];
  }
  slot[6] = lab_e0;
  slot[7] = lab_e1;
  elig[6] = s == 0 ? y == 0 : x == 0;
  elig[7] = s == 0 ? y == n - 1 : x == n - 1;

  bool joined0 = false, joined1 = false;
  for (int k = 0; k < 8; ++k) {
    joined0 |= elig[k] && slot[k] == lab_e0;
    joined1 |= elig[k] && slot[k] == lab_e1;
  }
  const int t = threadIdx.x;
  const int own = t < g.L ? lab[t] : 0;
  __syncthreads();  // every slot label is read before any label is written
  if (t < g.L) {
    bool match = false;
    for (int k = 0; k < 8; ++k) match |= elig[k] && own == slot[k];
    if (match) lab[t] = c;
  }
  if (t == c) (s == 0 ? st0 : st1)[c] = 1;
  __syncthreads();
  return (joined0 && joined1) || (pre_connected && lab_e0 == lab_e1);
}

}  // namespace hex
