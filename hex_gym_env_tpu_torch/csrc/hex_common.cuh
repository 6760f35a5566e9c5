// Device functions shared by the kernels of hex_kernels.cu and
// learner_kernels.cu (every one inline: both files include this header): move
// decoding, the flat-label union with its win test, the MLP towers, and the
// masked Gumbel-max sample with its log-softmax.
//
// Two families.  The block reduction (block_sum, K6): called by every thread
// of the CTA with its own value, it returns the same sum on every thread and
// ends in __syncthreads(), so the control flow around it stays uniform.  The
// warp-level functions (warp_*: K1-K4, K7): one warp plays one game, lane l
// owns entries l, l + 32, ... of any length; they synchronise with
// __syncwarp() and shuffles only, so the other games of a CTA never wait for
// this one; every lane gets the same scalars back.  The game's team of warps
// shares its forward passes (team_mlp_towers) behind the game's own named
// barrier.
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
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
// Block reduction (blockDim.x a multiple of 32, at most 1024)
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
// MLP towers.  A packed tower is one flat float32 run, kernels (in, out)
// row-major:
//   [W0 (F,H), b0 (H), {Wl (H,H), bl (H)} x (n_layers-1), Wout (H,out), bout (out)]
// The agent is its pi tower (out = A) followed by its vf tower (out = 1); a
// bank member is one pi tower.  See ops/policy_kernel.py for the packing.
// The forward passes read a tower as its image (transposed and padded, the
// layout of team_mlp_towers below), built by tower_image_kernel.
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

// v rounded to the nearest bfloat16 (ties to even), back in float32: the
// bf16 bank's weights and its dots' left-hand sides (rollout_bank_bf16)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// The game board of the flat-label union (ops/labels.py): n x n cells, then
// the four edge virtuals, lanes F .. F + 3, then padding up to L lanes.
// ---------------------------------------------------------------------------

struct Board {
  int n, F, L;
};

// ---------------------------------------------------------------------------
// Warp-level versions: one warp per game (see the top of this file)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the warp's best (value, index) under `better`; every lane gets it (a
// strict total order, so the butterfly's pairing cannot change the result)
__device__ __forceinline__ int warp_argmax(float v, int i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, o);
    const int oi = __shfl_xor_sync(kFullMask, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  return i;
}

__device__ __forceinline__ float warp_max_all(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// (a + b == b + a, so every lane of the butterfly ends with the same bits)
__device__ __forceinline__ float warp_sum_all(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The warp-level towers read their weights transposed and padded (the
// image: tower_image_kernel in hex_kernels.cu builds it, once per launch for
// K4 and once per rollout for K2 and K3): each layer is its
// n_out rows of n_in weights, row stride row_stride(n_in) (pads zero), then
// its n_out biases rounded up to 4 floats.  A tower is its layers in order, the head last.
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// the row stride of n floats read as float4 by lanes or threads that walk
// neighbouring rows: n rounded up to 4 floats, with stride/4 odd so that
// their 16-byte reads hit distinct banks
__host__ __device__ __forceinline__ int row_stride(int n) {
  int s = round4(n);
  if (((s >> 2) & 1) == 0) s += 4;
  return s;
}

__host__ __device__ __forceinline__ int tlayer_size(int n_in, int n_out) {
  return n_out * row_stride(n_in) + round4(n_out);
}

__host__ __device__ inline int ttower_size(const Mlp& m, int out) {
  int s = tlayer_size(m.F, m.H) + tlayer_size(m.H, out);
  for (int l = 1; l < m.n_layers; ++l) s += tlayer_size(m.H, m.H);
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// A team: the n_threads threads (whole warps) that share one game's
// forward passes, synchronised by their own named barrier (id 1-15), so the
// CTA's other games never wait for this one; one warp is __syncwarp().
struct Team {
  int rank, n_threads, bar;
  __device__ __forceinline__ void sync() const {
    if (n_threads == 32) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(n_threads) : "memory");
    }
  }
};

// Hopper's transaction barriers (mbarrier, 8 bytes of shared memory): a
// bulk copy (cp.async.bulk, the TMA's plain-bytes form, started by one
// thread) completes its bytes on one, and a thread that has waited for the
// barrier's phase 0 sees the copied bytes.  Sizes and addresses are
// multiples of 16 bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// dot(x[0:in4], w[0:in4]) in the order k = 0, 1, ... (one fmaf chain), x and w 16-byte aligned with zero pads up to in4 (a multiple
// of 4): up to 64 inputs at a time are loaded into registers first, all
// their loads in flight together, then summed.
__device__ __forceinline__ float dot_row(const float* x, const float* w, int in4) {
  float acc = 0.0f;
  for (int k0 = 0; k0 < in4; k0 += 64) {
    float4 xv[16], wv[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (k0 + 4 * c < in4) {
        xv[c] = ld4(x + k0 + 4 * c);
        wv[c] = ld4(w + k0 + 4 * c);
      }
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      if (k0 + 4 * c < in4) {
        acc = fmaf(xv[c].x, wv[c].x, acc);
        acc = fmaf(xv[c].y, wv[c].y, acc);
        acc = fmaf(xv[c].z, wv[c].z, acc);
        acc = fmaf(xv[c].w, wv[c].w, acc);
      }
    }
  }
  return acc;
}

// One or two towers side by side for a team, on their images: team thread r
// computes outputs r, r + n, ... of each layer (n = the team's threads), each
// a dot_row of its weight row and the layer's input, plus its bias.  x holds round4(F) floats, pads zero; h0/h1 hold 2 towers of
// round4(H) floats (one, when t1 is null), pads zero; y receives out0 (+
// out1) outputs.  Every layer ends with team.sync(), the last one too.
// kBf16Hidden rounds each hidden unit to bf16 where it is written, so the
// next layer's dot takes a bf16 left-hand side (the bf16 bank of K4): with
// bf16 weights every product is exact in float32 and the fmaf chain sums
// them as a float32 dot does, in another order than XLA's.  With ready
// set, layer l (both towers', the heads last) is read only after barrier
// ready[l]'s phase 0 (the layer's bulk copies into shared memory, K2).
template <bool kBf16Hidden = false>
__device__ inline void team_mlp_towers(const Team& team, const Mlp& m, const float* t0, int out0,
                                       const float* t1, int out1, const float* x, float* h0,
                                       float* h1, float* y, const uint64_t* ready = nullptr) {
  const int ntow = t1 != nullptr ? 2 : 1;
  const int H = m.H, H4 = round4(m.H);
  const float* hin = x;
  float* hout = h0;
  int in = m.F;
  int woff = 0;
  for (int l = 0; l <= m.n_layers; ++l) {
    const bool head = l == m.n_layers;
    const int S = row_stride(in), in4 = round4(in);
    // outputs: both towers' H units, or the heads' out0 + out1
    const int split = head ? out0 : H;
    const int total = head ? out0 + (ntow == 2 ? out1 : 0) : ntow * H;
    if (ready != nullptr) mbar_wait(ready + l, 0);
    for (int j = team.rank; j < total; j += team.n_threads) {
      const bool second = j >= split;
      const int jj = second ? j - split : j;
      const int out = head ? (second ? out1 : out0) : H;
      const float* w = (second ? t1 : t0) + woff;
      const float* xin = l == 0 ? x : hin + (second ? H4 : 0);
      const float z = dot_row(xin, w + jj * S, in4) + w[out * S + jj];
      if (head) {
        y[j] = z;
      } else {
        const float h = activate(z, m.relu);
        hout[(second ? H4 : 0) + jj] = kBf16Hidden ? round_bf16(h) : h;
      }
    }
    team.sync();
    if (head) break;
    woff += tlayer_size(in, H);
    hin = hout;
    hout = hout == h0 ? h1 : h0;
    in = H;
  }
}

// The masked sample for one warp: logits (A floats, shared) is overwritten
// with the masked logits; with noise, the action is the argmax of masked +
// gumbel(bits), without (eval), of masked.  Lane l scores entries l, l + 32,
// ... (drawing its bits in that order); argmax with ties to the lowest index; the
// log-softmax of the action when logp is set.  Ends with __syncwarp().
__device__ inline int warp_masked_sample(float* logits, const uint8_t* legal, int A, bool noise,
                                         const Bits& bits, float* logp) {
  const int lane = lane_id();
  float bv = -FLT_MAX, mx = -FLT_MAX;
  int bi = INT_MAX;
  for (int j = lane; j < A; j += 32) {
    const float m = legal[j] ? logits[j] : kMaskedLogit;
    logits[j] = m;
    const float score = noise ? m + gumbel(bits.at(j)) : m;
    if (better(score, j, bv, bi)) {
      bv = score;
      bi = j;
    }
    mx = fmaxf(mx, m);
  }
  const int action = warp_argmax(bv, bi);
  __syncwarp();  // every lane's masked logits are written
  if (logp != nullptr) {
    const float zmax = warp_max_all(mx);
    float se = 0.0f;
    for (int j = lane; j < A; j += 32) se += expf(logits[j] - zmax);
    const float lse = logf(warp_sum_all(se));
    *logp = (logits[action] - zmax) - lse;
  }
  return action;
}

// The flat-label union (ops/labels.py place_stone) for one warp: st0/st1
// (L bytes) and lab (L ints) are the game's stones and labels in shared
// memory, and lane l owns board lanes l, l + 32, ... (any L).  Places seat
// s's stone at world cell c when act (c must then lie in [0, L)), relabels
// every node of the merged group among lanes [0, lanes) to c, and returns
// the win: the mover's two edge virtuals share a group after the move.  With
// pre_connected false only a join made by this stone's group counts (K7's
// test), not edges that were connected before the move.
//
// Lane l reads slot label l mod 8 (lanes 8-31 repeat lanes 0-7 at no cost
// to the warp); the warp votes on them and shares the eight by shuffles,
// and only after that does any lane write: the read-all-then-write rule of
// the union.  A lane's own labels need no such care, since no other lane
// writes them, so the relabel loops over any number of lanes per thread
// with nothing held in registers.  An ineligible slot holds -1, which no
// label equals, so with no eligible slot (a stone with no friendly
// neighbour, off the mover's edges) the relabel would change nothing and is
// skipped.  act must be the same on every lane.
// Ends with __syncwarp().
//
// lanes: the lanes a relabel may touch.  Every slot label lies in
// [0, F + 4) whenever every move lands on a cell (K4, K7), so F + 4 covers
// the real lanes and a padding lane, which holds its own index, is never
// relabelled; K1 passes L, since a mover-frame action in [F, L) lands on a
// padding or virtual lane and is played there, as in the JAX package.
__device__ inline bool warp_place_stone(const Board& g, uint8_t* st0, uint8_t* st1, int* lab,
                                        int s, int c, bool act, bool pre_connected, int lanes) {
  if (!act) return false;
  const int n = g.n, lane = lane_id();
  const uint8_t* mine = s == 0 ? st0 : st1;
  // c / n, exact: c + 0.5 lies at least 0.5 / n from a multiple of n, far
  // beyond __fdividef's error for any c below 2^20
  const int y = __float2int_rd(__fdividef(static_cast<float>(c) + 0.5f, static_cast<float>(n)));
  const int x = c - y * n;
  const int e0 = g.F + 2 * s;
  const int lab_e0 = lab[e0], lab_e1 = lab[e0 + 1];

  // Lane k (mod 8) reads slot k once for the warp: the neighbours (dy, dx)
  // = (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), each only where
  // its row and column step stay on the board (a cell of row n - 1 has no
  // lower neighbour, ...), at index c + n dy + dx clamped into [0, L), then
  // the mover's two edge virtuals where c touches them.
  const int k = lane & 7;
  int my_slot;
  if (k < 6) {
    const int dy = (k >> 1) - 1;
    const int dx = ((0x489 >> (2 * k)) & 3) - 1;
    const bool ok = (dy >= 0 || y > 0) && (dy <= 0 || y < n - 1) && (dx >= 0 || x > 0) &&
                    (dx <= 0 || x < n - 1);
    const int id = min(max(c + dy * n + dx, 0), g.L - 1);
    my_slot = ok && mine[id] ? lab[id] : -1;
  } else if (k == 6) {
    my_slot = (s == 0 ? y == 0 : x == 0) ? lab_e0 : -1;
  } else {
    my_slot = (s == 0 ? y == n - 1 : x == n - 1) ? lab_e1 : -1;
  }
  const bool joined0 = __any_sync(kFullMask, my_slot == lab_e0);
  const bool joined1 = __any_sync(kFullMask, my_slot == lab_e1);
  if (__any_sync(kFullMask, my_slot >= 0)) {  // else no label matches: nothing to relabel
    int slot[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) slot[j] = __shfl_sync(kFullMask, my_slot, j);
    __syncwarp();  // every slot label is read before any label is written
    for (int t = lane; t < lanes; t += 32) {
      const int own = lab[t];
      bool match = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) match |= own == slot[j];
      if (match) lab[t] = c;
    }
  }
  if (lane == 0) (s == 0 ? st0 : st1)[c] = 1;  // after the votes: every slot is read
  __syncwarp();
  return (joined0 && joined1) || (pre_connected && lab_e0 == lab_e1);
}

// The warp's argmax of non-negative integer scores, ties to the lowest
// index: each lane passes its best (score, index), the lowest index among
// its own best scores; every lane gets the winner's index.  Two redux.sync
// (sm_80+) in place of warp_argmax's five shuffle rounds.
__device__ __forceinline__ int warp_argmax_u32(unsigned v, int i) {
  const unsigned top = __reduce_max_sync(kFullMask, v);
  return __reduce_min_sync(kFullMask, v == top ? i : INT_MAX);
}

}  // namespace hex
