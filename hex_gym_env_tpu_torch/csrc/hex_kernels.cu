// The selfplay rollout's kernels for Hopper (sm_90a), behind a plain C
// interface loaded with ctypes (ops/cuda_lib.py).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhexkernels.so hex_kernels.cu
// Never with --use_fast_math: tanhf/logf/expf must stay the library ones,
// or the kernels drift from their PyTorch twins.
//
// Every kernel runs one game per CTA: games are independent, so the grid is
// the batch.  Each entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() of its launch.
//
// Randomness: each kernel takes an optional bits array in the JAX package's
// interpret-mode layout and maps bits to samples exactly as the JAX kernels
// do.  Without it, every thread draws from its own Philox stream
// (curand_init(seed, row * blockDim + thread, 0)); the wrapper draws a
// fresh seed per launch from the caller's generator, so no two
// launches share a stream and a restored generator replays the streams.
// That is this port's stream deviation, as the TPU hardware PRNG is the JAX
// package's.

#include <cuda_runtime.h>

#include "hex_common.cuh"

using hex::Bits;
using hex::Board;
using hex::Mlp;
using hex::Scratch;

namespace {

__device__ __forceinline__ void philox_init(curandStatePhilox4_32_10_t* st,
                                            unsigned long long seed) {
  const unsigned long long sub =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  curand_init(seed, sub, 0, st);
}

// ===========================================================================
// K1 — env step.  Replaces ops/pallas_step.py:_step_kernel (entry `step`).
// One game per CTA, one thread per lane (blockDim = L).  Bound: bytes — per
// game it reads 2L stone bytes + 4L label bytes + 6 scalars and writes the
// same plus 2 rewards, ~1.6 KB at L = 128; at B = 256 that is 0.12 us of
// HBM time, so the launch itself dominates.  The design keeps the game in
// shared memory for the read-all-then-write label union and writes out of
// place, so the kernel never waits on more than one game's data.
// ===========================================================================

struct StepArgs {
  const uint8_t* stones;  // (B, 2, L) bool
  const int* labels;      // (B, L)
  const int* to_move;
  const uint8_t* done;
  const int* winner;
  const int* empty;
  const int* moves;
  const int* actions;     // (B,) mover frame
  const uint8_t* active;  // (B,) or null (all active)
  uint8_t* o_stones;
  int* o_labels;
  int* o_to_move;
  uint8_t* o_done;
  int* o_winner;
  int* o_empty;
  int* o_moves;
  float* o_rewards;  // (B, 2)
  Board g;
};

__global__ void step_kernel(StepArgs a) {
  extern __shared__ int smem_step[];
  const int L = a.g.L, b = blockIdx.x, t = threadIdx.x;
  int* lab = smem_step;
  uint8_t* st0 = reinterpret_cast<uint8_t*>(lab + L);
  uint8_t* st1 = st0 + L;
  if (t < L) {
    lab[t] = a.labels[b * L + t];
    st0[t] = a.stones[(2 * b) * L + t];
    st1[t] = a.stones[(2 * b + 1) * L + t];
  }
  __syncthreads();

  const int s = a.to_move[b];
  const bool was_done = a.done[b] != 0;
  const bool active = a.active == nullptr || a.active[b] != 0;
  const int c = hex::to_world(a.actions[b], s, a.g.n);
  const bool valid = c >= 0 && c < L && !(st0[c] | st1[c]);
  const bool invalid_now = !valid && !was_done && active;
  const bool act = valid && !was_done && active;
  const bool win = act && hex::place_stone(a.g, st0, st1, lab, s, c, act);

  if (t < L) {
    a.o_labels[b * L + t] = lab[t];
    a.o_stones[(2 * b) * L + t] = st0[t];
    a.o_stones[(2 * b + 1) * L + t] = st1[t];
  }
  if (t == 0) {
    const int empty = a.empty[b] - (act ? 1 : 0);
    const bool draw = act && !win && empty <= 0;
    a.o_empty[b] = empty;
    a.o_done[b] = was_done || win || draw || invalid_now;
    a.o_winner[b] = win ? s : draw ? 2 : invalid_now ? 3 : a.winner[b];
    a.o_to_move[b] = (was_done || !active) ? s : 1 - s;
    a.o_moves[b] = a.moves[b] + (act ? 1 : 0);
    const float r = win ? 1.0f : 0.0f;
    a.o_rewards[2 * b] = s == 0 ? r : -r;
    a.o_rewards[2 * b + 1] = s == 1 ? r : -r;
  }
}

// ===========================================================================
// K2 — agent pass.  Replaces ops/pallas_policy.py:_agent_kernel (entry
// `agent_forward_sample`).  One game per CTA of 128 threads: both towers'
// layers run side by side (thread j computes output j), then the masked
// Gumbel-max sample, its log-softmax and the value.  Bound: operations are
// 2(F*2H + (n_layers-1)*2H*H + H*(A+1)) FLOP per game (~35 KFLOP at 7x7,
// H = 64; 9 MFLOP at B = 256, 0.13 us at the fp32 peak); bytes are the
// params (~72 KB, read once) plus per-game obs/legal/bits/outputs.  Both are
// far below the launch cost; weights are read straight from global memory
// (L2-resident after the first CTAs), coalesced by the (in, out) layout.
// ===========================================================================

struct AgentArgs {
  const float* params;  // pi tower then vf tower, see hex_common.cuh
  Mlp m;
  const int8_t* obs;     // (B, F)
  const uint8_t* legal;  // (B, A)
  const uint32_t* bits;  // (B, A) or null
  unsigned long long seed;
  int* o_action;
  float* o_logp;
  float* o_value;
  float* o_masked;  // (B, A)
};

__global__ void agent_kernel(AgentArgs a) {
  extern __shared__ float smem_agent[];
  __shared__ Scratch red;
  const Mlp& m = a.m;
  const int b = blockIdx.x;
  float* x = smem_agent;
  float* h0 = x + m.F;
  float* h1 = h0 + 2 * m.H;
  float* y = h1 + 2 * m.H;
  for (int i = threadIdx.x; i < m.F; i += blockDim.x) x[i] = static_cast<float>(a.obs[b * m.F + i]);
  __syncthreads();

  const float* pi = a.params;
  const float* vf = pi + hex::tower_size(m, m.A);
  hex::mlp_towers(m, pi, m.A, vf, 1, x, h0, h1, y);

  curandStatePhilox4_32_10_t st;
  if (a.bits == nullptr) philox_init(&st, a.seed);
  const Bits bits{a.bits != nullptr ? a.bits + b * m.A : nullptr, &st};
  float logp;
  const int action = hex::masked_sample(y, a.legal + b * m.A, m.A, true, bits,
                                        a.o_masked + b * m.A, &logp, red);
  if (threadIdx.x == 0) {
    a.o_action[b] = action;
    a.o_logp[b] = logp;
    a.o_value[b] = y[m.A];
  }
}

// ===========================================================================
// K3 — opponent-bank pass.  Replaces ops/pallas_policy.py:_bank_kernel
// (entry `bank_forward_sample`).  One game per CTA: the CTA reads its row's
// member (pool slot, or the best at index P) straight from global memory —
// no window-masked stack — runs that member's pi tower and action head, and
// samples.  Bound: bytes, the members actually used (each ~42 KB at 7x7,
// H = 64; all 31 at B = 256, 0.4 us of HBM time) plus per-game rows; the
// operations, 2(F*H + (n_layers-1)*H*H + H*A) FLOP per game (~21 KFLOP),
// take less.  Members stay L2-resident across CTAs.  Launch-bound at B = 256.
// ===========================================================================

struct BankArgs {
  const float* bank;  // (P1, tower_size) members, best last
  Mlp m;
  const int8_t* obs;
  const uint8_t* legal;
  const int* member;  // (B,) member index
  const uint32_t* bits;
  unsigned long long seed;
  int* o_action;
  float* o_masked;
};

__global__ void bank_kernel(BankArgs a) {
  extern __shared__ float smem_bank[];
  __shared__ Scratch red;
  const Mlp& m = a.m;
  const int b = blockIdx.x;
  float* x = smem_bank;
  float* h0 = x + m.F;
  float* h1 = h0 + 2 * m.H;
  float* y = h1 + 2 * m.H;
  for (int i = threadIdx.x; i < m.F; i += blockDim.x) x[i] = static_cast<float>(a.obs[b * m.F + i]);
  __syncthreads();

  const float* w = a.bank + static_cast<long long>(a.member[b]) * hex::tower_size(m, m.A);
  hex::mlp_towers(m, w, m.A, nullptr, 0, x, h0, h1, y);

  curandStatePhilox4_32_10_t st;
  if (a.bits == nullptr) philox_init(&st, a.seed);
  const Bits bits{a.bits != nullptr ? a.bits + b * m.A : nullptr, &st};
  const int action = hex::masked_sample(y, a.legal + b * m.A, m.A, true, bits,
                                        a.o_masked + b * m.A, nullptr, red);
  if (threadIdx.x == 0) a.o_action[b] = action;
}

// ===========================================================================
// K4 — the whole T-step selfplay rollout.  Replaces
// ops/pallas_rollout.py:_rollout_kernel (entry `fused_rollout`).  One game
// per CTA, one thread per lane (blockDim = L = 128); the time loop runs
// inside the CTA (the TPU made time its sequential grid axis).  The game's
// stones and labels stay in shared memory for all T steps, and so do the
// agent's weights when they fit (~72 KB at 7x7, H = 64; else they are read
// from global memory).  The bank member of each move and the first-move
// table are read from global memory (L2).
//
// Per step: mover-frame obs and legal mask (a transposed index, no matmul),
// agent towers + sample (argmax in eval mode), the agent's move, the
// opponent's reply from its bank member, and, in training mode, the reset
// of finished games with the seat / best / pool-slot redraws and the
// opening move from the (P1, A) table.  Eval mode freezes finished games.
//
// Bound: operations.  Per step and game 2(F*2H + (n_layers-1)*2H*H +
// H*(A+1)) + 2(F*H + (n_layers-1)*H*H + H*A) FLOP (~56 KFLOP at 7x7,
// H = 64): 1.8 GFLOP for B = 256, T = 128, 27 us at the fp32 peak.  Bytes:
// obs (T*B*F) + ints and flts (2*T*B*32) + carry + weights, ~5 MB, 1.5 us.
// This simple design is latency-bound: one game per CTA leaves most lanes
// of each warp idle in the MLP layers and synchronises ~30 times per step.
// ===========================================================================

struct RolloutArgs {
  const float* agent;  // pi tower then vf tower
  const float* bank;   // (P1, tower_size)
  const float* first;  // (P1, A) empty-board logits
  Mlp m;
  int P1;
  // carry in
  const uint8_t* stones;
  const int* labels;
  const int* to_move;
  const uint8_t* done;
  const int* empty;
  const int* moves;
  const int* seat;
  const uint8_t* use_best;
  const int* opp_idx;
  // injected bits (all or none): agent/opp/first (T, B, A), reset (T, B, 128)
  const uint32_t* agent_bits;
  const uint32_t* opp_bits;
  const uint32_t* first_bits;
  const uint32_t* reset_bits;
  unsigned long long seed;
  // record
  int8_t* o_obs;  // (T, B, F)
  int* o_ints;    // (T, B, 8)
  float* o_flts;  // (T, B, 8)
  // carry out
  uint8_t* o_stones;
  int* o_labels;
  int* o_to_move;
  uint8_t* o_done;
  int* o_empty;
  int* o_moves;
  int* o_seat;
  uint8_t* o_use_best;
  int* o_opp_idx;
  Board g;
  int B, T;
  float best_prob;
  int per_episode_seat, eval_mode, agent_in_smem;
};

constexpr int kResetLanes = 128;

// mover-frame observation into x (float) and record, legal mask into legal
__device__ __forceinline__ void observe(const Board& g, const uint8_t* st0, const uint8_t* st1,
                                        int tm, float* x, uint8_t* legal, int8_t* record) {
  for (int i = threadIdx.x; i < g.F; i += blockDim.x) {
    const int w = tm == 0 ? i : (i % g.n) * g.n + i / g.n;
    const int d = static_cast<int>(st1[w]) - static_cast<int>(st0[w]);
    const int ob = tm == 0 ? d : -d;
    x[i] = static_cast<float>(ob);
    legal[i] = !(st0[w] | st1[w]);
    if (record != nullptr) record[i] = static_cast<int8_t>(ob);
  }
  __syncthreads();
}

__global__ void rollout_kernel(RolloutArgs a) {
  extern __shared__ float smem_roll[];
  __shared__ Scratch red;
  __shared__ uint32_t reset_words[3];
  const Mlp& m = a.m;
  const Board& g = a.g;
  const int b = blockIdx.x, t = threadIdx.x, L = g.L, F = g.F, A = m.A, B = a.B;
  const int agent_size = hex::tower_size(m, A) + hex::tower_size(m, 1);
  const int member_size = hex::tower_size(m, A);

  float* aw = smem_roll;
  float* x = a.agent_in_smem ? aw + agent_size : smem_roll;
  float* h0 = x + F;
  float* h1 = h0 + 2 * m.H;
  float* y = h1 + 2 * m.H;
  int* lab = reinterpret_cast<int*>(y + A + 1);
  uint8_t* st0 = reinterpret_cast<uint8_t*>(lab + L);
  uint8_t* st1 = st0 + L;
  uint8_t* legal = st1 + L;

  if (a.agent_in_smem) {
    for (int i = t; i < agent_size; i += blockDim.x) aw[i] = a.agent[i];
  } else {
    aw = const_cast<float*>(a.agent);
  }
  if (t < L) {
    lab[t] = a.labels[b * L + t];
    st0[t] = a.stones[(2 * b) * L + t];
    st1[t] = a.stones[(2 * b + 1) * L + t];
  }
  // per-game scalars: one copy per thread, updated identically by all
  int tm = a.to_move[b], empty = a.empty[b], mc = a.moves[b];
  bool done = a.done[b] != 0;
  int seat = a.seat[b], use_best = a.use_best[b] != 0, opp_idx = a.opp_idx[b];

  const bool injected = a.agent_bits != nullptr;
  curandStatePhilox4_32_10_t st;
  if (!injected) philox_init(&st, a.seed);
  const float* agent_pi = aw;
  const float* agent_vf = aw + member_size;
  __syncthreads();

  for (int step = 0; step < a.T; ++step) {
    const long long row = static_cast<long long>(step) * B + b;

    // ---- 1. agent forward + sample ------------------------------------
    observe(g, st0, st1, tm, x, legal, a.o_obs + row * F);
    hex::mlp_towers(m, agent_pi, A, agent_vf, 1, x, h0, h1, y);
    const float value = y[A];
    float logp;
    const Bits abits{injected ? a.agent_bits + row * A : nullptr, &st};
    const int act_a = hex::masked_sample(y, legal, A, !a.eval_mode, abits, nullptr, &logp, red);

    // ---- 2. agent move ---------------------------------------------------
    const bool act1 = !done;
    const bool win1 = hex::place_stone(g, st0, st1, lab, tm, hex::to_world(act_a, tm, g.n), act1);
    if (act1) {
      empty -= 1;
      done = win1 || empty <= 0;
      tm = 1 - tm;
      mc += 1;
    }

    // ---- 3. opponent reply -----------------------------------------------
    observe(g, st0, st1, tm, x, legal, nullptr);
    const int member = use_best ? a.P1 - 1 : opp_idx;
    hex::mlp_towers(m, a.bank + static_cast<long long>(member) * member_size, A, nullptr, 0, x,
                    h0, h1, y);
    const Bits obits{injected ? a.opp_bits + row * A : nullptr, &st};
    const int act_o = hex::masked_sample(y, legal, A, true, obits, nullptr, nullptr, red);
    const bool act2 = !done;
    const bool win2 = hex::place_stone(g, st0, st1, lab, tm, hex::to_world(act_o, tm, g.n), act2);
    if (act2) {
      empty -= 1;
      done = win2 || empty <= 0;
      tm = 1 - tm;
      mc += 1;
    }
    const float reward = (win1 ? 1.0f : 0.0f) - (win2 ? 1.0f : 0.0f);
    const bool done_out = done;

    // ---- 4. auto-reset + redraws + opening move (training only) ----------
    int act_f = 0;
    if (!a.eval_mode) {
      if (t < 3) reset_words[t] = injected ? a.reset_bits[row * kResetLanes + t] : curand(&st);
      __syncthreads();
      const float u_seat = hex::unit_uniform(reset_words[0]);
      const float u_best = hex::unit_uniform(reset_words[1]);
      const float u_idx = hex::unit_uniform(reset_words[2]);
      const bool m_reset = done;
      if (m_reset) {
        if (t < L) {
          lab[t] = t;
          st0[t] = 0;
          st1[t] = 0;
        }
        empty = F;
        tm = 0;
        mc = 0;
        done = false;
        if (a.per_episode_seat) seat = u_seat < 0.5f;
        use_best = u_best < a.best_prob;
        opp_idx = min(static_cast<int>(u_idx * static_cast<float>(a.P1 - 1)), a.P1 - 2);
      }
      __syncthreads();
      // the opener's logits: the member's empty-board row; every cell legal
      const float* first = a.first + static_cast<long long>(use_best ? a.P1 - 1 : opp_idx) * A;
      float bv = -FLT_MAX;
      int bi = INT_MAX;
      for (int j = t; j < A; j += blockDim.x) {
        const uint32_t w = injected ? a.first_bits[row * A + j] : curand(&st);
        const float score = first[j] + hex::gumbel(w);
        if (hex::better(score, j, bv, bi)) {
          bv = score;
          bi = j;
        }
      }
      act_f = hex::block_argmax(bv, bi, red);
      const bool act3 = m_reset && seat == 1;
      hex::place_stone(g, st0, st1, lab, tm, act_f, act3);  // seat 0 opens: world frame
      if (act3) {
        empty -= 1;
        tm = 1 - tm;
        mc += 1;
      }
    }

    // ---- emit ---------------------------------------------------------------
    if (t < 8) {
      const int iv[8] = {act_a, act_o, act_f, done_out, seat, use_best, opp_idx, 0};
      const float fv[8] = {logp, value, reward, 0.f, 0.f, 0.f, 0.f, 0.f};
      a.o_ints[row * 8 + t] = iv[t];
      a.o_flts[row * 8 + t] = fv[t];
    }
  }

  if (t < L) {
    a.o_labels[b * L + t] = lab[t];
    a.o_stones[(2 * b) * L + t] = st0[t];
    a.o_stones[(2 * b + 1) * L + t] = st1[t];
  }
  if (t == 0) {
    a.o_to_move[b] = tm;
    a.o_done[b] = done;
    a.o_empty[b] = empty;
    a.o_moves[b] = mc;
    a.o_seat[b] = seat;
    a.o_use_best[b] = use_best;
    a.o_opp_idx[b] = opp_idx;
  }
}

// shared-memory bytes of the x/h0/h1/y float buffers
int mlp_smem_bytes(const Mlp& m) { return (m.F + 4 * m.H + m.A + 1) * static_cast<int>(sizeof(float)); }

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// ===========================================================================
// C interface
// ===========================================================================

extern "C" {

const char* hex_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int hex_step(const void* stones, const void* labels, const void* to_move, const void* done,
             const void* winner, const void* empty, const void* moves, const void* actions,
             const void* active, void* o_stones, void* o_labels, void* o_to_move, void* o_done,
             void* o_winner, void* o_empty, void* o_moves, void* o_rewards, int B, int n, int L,
             void* stream) {
  StepArgs a{static_cast<const uint8_t*>(stones), static_cast<const int*>(labels),
             static_cast<const int*>(to_move),    static_cast<const uint8_t*>(done),
             static_cast<const int*>(winner),     static_cast<const int*>(empty),
             static_cast<const int*>(moves),      static_cast<const int*>(actions),
             static_cast<const uint8_t*>(active), static_cast<uint8_t*>(o_stones),
             static_cast<int*>(o_labels),         static_cast<int*>(o_to_move),
             static_cast<uint8_t*>(o_done),       static_cast<int*>(o_winner),
             static_cast<int*>(o_empty),          static_cast<int*>(o_moves),
             static_cast<float*>(o_rewards),      Board{n, n * n, L}};
  const int smem = L * (static_cast<int>(sizeof(int)) + 2);
  step_kernel<<<B, L, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

int hex_agent(const void* params, int F, int H, int A, int n_layers, int relu, const void* obs,
              const void* legal, const void* bits, unsigned long long seed,
              void* o_action, void* o_logp, void* o_value, void* o_masked, int B,
              void* stream) {
  AgentArgs a{static_cast<const float*>(params), Mlp{F, H, A, n_layers, relu},
              static_cast<const int8_t*>(obs), static_cast<const uint8_t*>(legal),
              static_cast<const uint32_t*>(bits), seed,
              static_cast<int*>(o_action), static_cast<float*>(o_logp),
              static_cast<float*>(o_value), static_cast<float*>(o_masked)};
  const int smem = mlp_smem_bytes(a.m);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(agent_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  agent_kernel<<<B, 128, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

int hex_bank(const void* bank, int F, int H, int A, int n_layers, int relu, const void* obs,
             const void* legal, const void* member, const void* bits, unsigned long long seed,
             void* o_action, void* o_masked, int B, void* stream) {
  BankArgs a{static_cast<const float*>(bank), Mlp{F, H, A, n_layers, relu},
             static_cast<const int8_t*>(obs), static_cast<const uint8_t*>(legal),
             static_cast<const int*>(member), static_cast<const uint32_t*>(bits), seed,
             static_cast<int*>(o_action), static_cast<float*>(o_masked)};
  const int smem = mlp_smem_bytes(a.m);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(bank_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bank_kernel<<<B, 128, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

int hex_rollout(const void* agent, const void* bank, const void* first, int F, int H, int A,
                int n_layers, int relu, int P1, const void* stones, const void* labels,
                const void* to_move, const void* done, const void* empty, const void* moves,
                const void* seat, const void* use_best, const void* opp_idx,
                const void* agent_bits, const void* opp_bits, const void* first_bits,
                const void* reset_bits, unsigned long long seed,
                void* o_obs, void* o_ints, void* o_flts, void* o_stones, void* o_labels,
                void* o_to_move, void* o_done, void* o_empty, void* o_moves, void* o_seat,
                void* o_use_best, void* o_opp_idx, int B, int n, int L, int T, float best_prob,
                int per_episode_seat, int eval_mode, void* stream) {
  RolloutArgs a{};
  a.agent = static_cast<const float*>(agent);
  a.bank = static_cast<const float*>(bank);
  a.first = static_cast<const float*>(first);
  a.m = Mlp{F, H, A, n_layers, relu};
  a.P1 = P1;
  a.stones = static_cast<const uint8_t*>(stones);
  a.labels = static_cast<const int*>(labels);
  a.to_move = static_cast<const int*>(to_move);
  a.done = static_cast<const uint8_t*>(done);
  a.empty = static_cast<const int*>(empty);
  a.moves = static_cast<const int*>(moves);
  a.seat = static_cast<const int*>(seat);
  a.use_best = static_cast<const uint8_t*>(use_best);
  a.opp_idx = static_cast<const int*>(opp_idx);
  a.agent_bits = static_cast<const uint32_t*>(agent_bits);
  a.opp_bits = static_cast<const uint32_t*>(opp_bits);
  a.first_bits = static_cast<const uint32_t*>(first_bits);
  a.reset_bits = static_cast<const uint32_t*>(reset_bits);
  a.seed = seed;
  a.o_obs = static_cast<int8_t*>(o_obs);
  a.o_ints = static_cast<int*>(o_ints);
  a.o_flts = static_cast<float*>(o_flts);
  a.o_stones = static_cast<uint8_t*>(o_stones);
  a.o_labels = static_cast<int*>(o_labels);
  a.o_to_move = static_cast<int*>(o_to_move);
  a.o_done = static_cast<uint8_t*>(o_done);
  a.o_empty = static_cast<int*>(o_empty);
  a.o_moves = static_cast<int*>(o_moves);
  a.o_seat = static_cast<int*>(o_seat);
  a.o_use_best = static_cast<uint8_t*>(o_use_best);
  a.o_opp_idx = static_cast<int*>(o_opp_idx);
  a.g = Board{n, n * n, L};
  a.B = B;
  a.T = T;
  a.best_prob = best_prob;
  a.per_episode_seat = per_episode_seat;
  a.eval_mode = eval_mode;

  const int agent_bytes =
      (hex::tower_size(a.m, A) + hex::tower_size(a.m, 1)) * static_cast<int>(sizeof(float));
  const int base = mlp_smem_bytes(a.m) + L * (static_cast<int>(sizeof(int)) + 3);
  a.agent_in_smem = base + agent_bytes <= 200 * 1024;
  const int smem = base + (a.agent_in_smem ? agent_bytes : 0);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(rollout_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  rollout_kernel<<<B, L, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

}  // extern "C"
