// The env and selfplay rollout's kernels (K1-K4, and K7, the random-legal
// rollout of the env-throughput benchmark) for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes (ops/cuda_lib.py).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhexkernels.so hex_kernels.cu
// Never with --use_fast_math: tanhf/logf/expf must stay the library ones,
// or the kernels drift from their PyTorch twins.
//
// Games are independent: K2 and K3 run one game per CTA, so the grid is
// the batch; K1 and K7 run a warp per game and K4 a team of warps per game,
// several games per CTA.  Each
// entry launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of its launch.
//
// Randomness: each kernel takes an optional bits array in the JAX package's
// interpret-mode layout and maps bits to samples exactly as the JAX kernels
// do.  Without it, every thread draws from its own Philox stream
// (curand_init(seed, row * blockDim + thread, 0); K4 and K7: curand_init(
// seed, game * 32 + lane, 0)); the wrapper draws a fresh seed per launch from the
// caller's generator, so no two launches share a stream and a restored
// generator replays the streams.
// That is this port's stream deviation, as the TPU hardware PRNG is the JAX
// package's.

#include <cuda_runtime.h>

#include <algorithm>

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
// K1 and K7 share a launch shape: one warp per game, games_per_cta games
// (warps) per CTA, each game's labels (L ints) and stones (2L bytes) in its
// own slice of shared memory, and no block barrier.  env_games_per_cta picks
// the games per CTA: at most kEnvMaxGames, and no more than keep one CTA per
// SM where B allows, so a small batch is not a grid of a few CTAs (B = 30
// runs 30 CTAs of one warp, B = 256 256 CTAs, B = 8192 1024 CTAs of eight).
// Both write their outputs into two buffers (ops/step_kernel.py carves the
// state's tensors from them as views):
//   ints  = labels (B, L), to_move, winner, empty, move_count (B each), then
//           K1's rewards (B, 2) as float32 or K7's games (B);
//   bytes = stones (B, 2, L), done (B).
// ===========================================================================

constexpr int kEnvMaxGames = 8;  // games (warps) per CTA of K1 and K7

__host__ __device__ inline int env_game_bytes(int L) { return L * (static_cast<int>(sizeof(int)) + 2); }

// One game's slice: labels (L ints), then the two seats' stones (L bytes
// each).  L is a multiple of 128 (the topology's lanes), so a slice is
// 16-byte aligned and the warp moves a game as int4 labels and 4-byte
// words of stones, lane l the lanes 4l .. 4l + 3 of every 128 (one
// round trip at L = 128); the wrapper hands in 16-byte aligned arrays.
struct EnvSlice {
  int* lab;
  uint8_t* st0;
  uint8_t* st1;
  __device__ EnvSlice(void* smem, int slot, int L) {
    lab = reinterpret_cast<int*>(static_cast<char*>(smem) + static_cast<long long>(slot) * env_game_bytes(L));
    st0 = reinterpret_cast<uint8_t*>(lab + L);
    st1 = st0 + L;
  }
  // game b's labels and stones from the (B, L) and (B, 2, L) arrays
  __device__ void load(const int* labels, const uint8_t* stones, long long b, int L) {
    const int4* lsrc = reinterpret_cast<const int4*>(labels + b * L);
    const uint32_t* ssrc = reinterpret_cast<const uint32_t*>(stones + 2 * b * L);
#pragma unroll 2
    for (int i = hex::lane_id(); i < L / 4; i += 32) {
      reinterpret_cast<int4*>(lab)[i] = lsrc[i];
      reinterpret_cast<uint32_t*>(st0)[i] = ssrc[i];
      reinterpret_cast<uint32_t*>(st1)[i] = ssrc[L / 4 + i];
    }
    __syncwarp();
  }
  __device__ void store(int* labels, uint8_t* stones, long long b, int L) const {
    int4* ldst = reinterpret_cast<int4*>(labels + b * L);
    uint32_t* sdst = reinterpret_cast<uint32_t*>(stones + 2 * b * L);
#pragma unroll 2
    for (int i = hex::lane_id(); i < L / 4; i += 32) {
      ldst[i] = reinterpret_cast<const int4*>(lab)[i];
      sdst[i] = reinterpret_cast<const uint32_t*>(st0)[i];
      sdst[L / 4 + i] = reinterpret_cast<const uint32_t*>(st1)[i];
    }
  }
};

// ===========================================================================
// K1 — env step.  Replaces ops/pallas_step.py:_step_kernel (entry `step`).
// One warp per game (the shared launch shape above): the warp stages its
// game in shared memory, decodes the move, applies hex::warp_place_stone
// (pre-connected term on, relabelling all L lanes) and writes the game out
// of place.  Bound: bytes — per game 6L + 22 bytes in (stones, labels, five
// ints, done, action, active) and 6L + 25 out (the state and two rewards),
// ~1.6 KB at L = 128; at B = 256 that is 0.12 us of HBM time, so the launch
// itself dominates.  The earlier design ran one game per CTA of L threads,
// two __syncthreads() in the union, and at 7x7 75 of each CTA's 128 threads
// had no real lane; a warp per game keeps every thread on lanes of its game
// and lets a CTA hold up to eight games.
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
  int* o_ints;            // see the launch shape above
  uint8_t* o_bytes;
  Board g;
  int B, games_per_cta;
};

__global__ void __launch_bounds__(32 * kEnvMaxGames) step_kernel(StepArgs a) {
  extern __shared__ __align__(16) int smem_env[];
  const int L = a.g.L, lane = hex::lane_id(), slot = threadIdx.x >> 5;
  const int b = blockIdx.x * a.games_per_cta + slot;
  if (b >= a.B) return;  // a whole warp: no barrier waits for it
  const int s = a.to_move[b];  // the scalars' loads in flight with the game's
  const bool was_done = a.done[b] != 0;
  const bool active = a.active == nullptr || a.active[b] != 0;
  const int c = hex::to_world(a.actions[b], s, a.g.n);
  EnvSlice game(smem_env, slot, L);
  game.load(a.labels, a.stones, b, L);
  const bool valid = c >= 0 && c < L && !(game.st0[c] | game.st1[c]);
  const bool invalid_now = !valid && !was_done && active;
  const bool act = valid && !was_done && active;
  const bool win = hex::warp_place_stone(a.g, game.st0, game.st1, game.lab, s, c, act, true, L);

  const long long BL = static_cast<long long>(a.B) * L;
  game.store(a.o_ints, a.o_bytes, b, L);
  if (lane == 0) {
    int* o = a.o_ints + BL;  // to_move, winner, empty, move_count, rewards
    const int empty = a.empty[b] - (act ? 1 : 0);
    const bool draw = act && !win && empty <= 0;
    o[b] = (was_done || !active) ? s : 1 - s;
    o[a.B + b] = win ? s : draw ? 2 : invalid_now ? 3 : a.winner[b];
    o[2 * a.B + b] = empty;
    o[3 * a.B + b] = a.moves[b] + (act ? 1 : 0);
    float* rewards = reinterpret_cast<float*>(o + 4 * a.B);
    const float r = win ? 1.0f : 0.0f;
    rewards[2 * b] = s == 0 ? r : -r;
    rewards[2 * b + 1] = s == 1 ? r : -r;
    a.o_bytes[2 * BL + b] = was_done || win || draw || invalid_now;
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
// ops/pallas_rollout.py:_rollout_kernel (entry `fused_rollout`).  The time
// loop runs inside the kernel (the TPU made time its sequential grid axis).
// Per step: mover-frame obs and legal mask (a transposed index, no matmul),
// agent towers + sample (argmax in eval mode), the agent's move, the
// opponent's reply from its bank member, and, in training mode, the reset
// of finished games with the seat / best / pool-slot redraws and the opening
// move from the (P1, A) table.  Eval mode freezes finished games.
//
// Bound: operations.  Per step and game 2(F*2H + (n_layers-1)*2H*H +
// H*(A+1)) + 2(F*H + (n_layers-1)*H*H + H*A) FLOP (~56 KFLOP at 7x7,
// H = 64): 1.8 GFLOP for B = 256, T = 128, 0.0274 ms at the fp32 peak.
// Bytes: obs (T*B*F) + ints and flts (2*T*B*32) + carry + weights, ~5 MB.
//
// Where the time went (phase clock, chip runs on an H100 80GB HBM3 at
// 700 W; one game per 128-thread CTA, 22.2 us per step): the opponent's
// forward 13.8 us (62%) — its bank member's weights read from L2 in
// dependent fmaf loops —, the agent's forward 3.9 us (weights in shared
// memory), the samples 2.2 us and the moves and reset 2.2 us, every one
// ending in block barriers (~30 per step) with most lanes idle.  So:
//   - one team of warps per game, several games per CTA, and no block
//     barrier inside the time loop.  The leader warp plays the game with the
//     warp-level functions of hex_common.cuh (the sample's reductions are
//     butterflies with ties to the lowest index; the union reads every label
//     before a __syncwarp, then writes); the team shares the two forward
//     passes (team_mlp_towers), synchronised by the game's own named
//     barrier.  One warp alone left the card's other schedulers idle and its
//     dependent fmaf chains unhidden: 1.445 ms per preset rollout against
//     1.178 ms with two warps and 1.265 ms with four;
//   - a first small kernel of the same entry writes the agent and every bank
//     member transposed and padded, so a thread's weight row is contiguous:
//     it loads up to 64 weights and inputs as float4 into registers, all in
//     flight together, before its fmaf chain (dot_row; loads interleaved
//     with the chain ran 2.6x slower);
//   - the agent's image is staged once per launch into shared memory,
//     shared by the CTA's games;
//   - each game's bank member is copied into its own slice of shared memory
//     with 16-byte cp.async when it changes (at the start and after a reset
//     that redraws it), so the copy overlaps the next step's agent pass and
//     the opponent's forward reads shared memory; the member changes once
//     per episode, not per step;
//   - hex_rollout_plan picks (agent and members in shared memory) where they
//     fit, else (agent only), else (neither), and the games per CTA that
//     need the fewest waves of CTAs on the card (the fewest among equals).
// After (the same clock, two warps per game, several games per CTA): the
// two forward passes 3.7 and 3.8 us, the samples 2.8 us, the moves 1.5 us,
// the reset 1.5 us per step, the kernel 1.19 ms per preset rollout against
// 2.41 ms before.
// Randomness: the injected-bits path maps bits to samples exactly as the
// JAX kernel does.  Without bits each lane of a game draws from its own
// Philox stream, curand_init(seed, game * 32 + lane, 0): keyed by game, not
// by CTA or thread, so the streams do not depend on how many games share a
// CTA, and a restored generator (which gives the seed) replays them.  The
// production stream differs from the one-game-per-CTA kernel's; its
// distribution does not.
// ===========================================================================

struct RolloutArgs {
  const float* agent;  // transposed image: pi tower then vf tower
  const float* bank;   // transposed images, P1 x ttower_size(m, A)
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
  int per_episode_seat, eval_mode;
  // launch shape (hex_rollout): games per CTA, what sits in shared memory,
  // and the bytes of one game's slice
  int games_per_cta, agent_in_smem, member_in_smem, game_bytes;
  long long* timers;  // (B, T, kRollMarks) clock64 stamps, or null
};

constexpr int kResetLanes = 128;
// warps per game: a leader warp that plays the game and a helper that
// shares its forward passes (at the preset 1, 2 and 4 warps per game took
// 1.445, 1.178 and 1.265 ms per rollout on one H100)
constexpr int kTeamWarps = 2;
// phase clock: lane 0 of each game stamps clock64() at the start of each
// step and at the end of each of its phases (utils/profiling.py
// phase_split reads the buffer): agent forward, agent sample, agent move,
// opponent forward, opponent sample, opponent move, reset, emit
constexpr int kRollMarks = 9;

__device__ __forceinline__ void roll_mark(long long* timers, int k, bool writer) {
  if (timers != nullptr && writer) timers[k] = clock64();
}

__host__ __device__ inline int round_up(int n, int k) { return (n + k - 1) / k * k; }

// one game's slice of shared memory: [member image (if staged)] x, h0, h1,
// y (floats), the member index for the team and 3 spare ints, labels
// (ints), then stones and the legal mask (bytes)
__host__ __device__ inline int rollout_game_bytes(const Mlp& m, const Board& g, bool member) {
  const int floats = (member ? hex::ttower_size(m, m.A) : 0) + hex::round4(m.F) +
                     4 * hex::round4(m.H) + hex::round4(m.A + 1);
  return round_up(floats * 4 + 16 + g.L * 4 + 2 * g.L + m.A, 16);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The transposed, padded towers of team_mlp_towers, one per blockIdx.y: 0
// the agent's pi tower, 1 its vf tower, 2 + i bank member i; out holds
// them in that order.
__global__ void tower_image_kernel(const float* agent, const float* bank, Mlp m, float* out) {
  const int inst = blockIdx.y, L = m.n_layers, H = m.H;
  const int head = inst == 1 ? 1 : m.A;
  const int pi_t = hex::ttower_size(m, m.A);
  const float* src = inst == 0   ? agent
                     : inst == 1 ? agent + hex::tower_size(m, m.A)
                                 : bank + static_cast<long long>(inst - 2) * hex::tower_size(m, m.A);
  float* dst = out + (inst == 0   ? 0
                      : inst == 1 ? pi_t
                                  : pi_t + hex::ttower_size(m, 1) + static_cast<long long>(inst - 2) * pi_t);
  const int total = hex::ttower_size(m, head);
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < total; q += gridDim.x * blockDim.x) {
    int woff = 0, poff = 0, in = m.F;
    for (int l = 0; l <= L; ++l) {
      const int n_out = l == L ? head : H, S = hex::row_stride(in);
      const int sz = hex::tlayer_size(in, n_out);
      if (q < woff + sz) {
        const int e = q - woff;
        float v = 0.0f;
        if (e < n_out * S) {
          const int j = e / S, k = e - (e / S) * S;
          if (k < in) v = src[poff + k * n_out + j];
        } else if (e - n_out * S < n_out) {
          v = src[poff + in * n_out + (e - n_out * S)];
        }
        dst[q] = v;
        break;
      }
      woff += sz;
      poff += (in + 1) * n_out;
      in = H;
    }
  }
}

// mover-frame observation into x (float) and record, legal mask into legal
__device__ __forceinline__ void warp_observe(const Board& g, const uint8_t* st0, const uint8_t* st1,
                                             int tm, float* x, uint8_t* legal, int8_t* record) {
  for (int i = hex::lane_id(); i < g.F; i += 32) {
    const int w = tm == 0 ? i : (i % g.n) * g.n + i / g.n;
    const int d = static_cast<int>(st1[w]) - static_cast<int>(st0[w]);
    const int ob = tm == 0 ? d : -d;
    x[i] = static_cast<float>(ob);
    legal[i] = !(st0[w] | st1[w]);
    if (record != nullptr) record[i] = static_cast<int8_t>(ob);
  }
  __syncwarp();
}

__global__ void rollout_kernel(RolloutArgs a) {
  extern __shared__ __align__(16) float smem_roll[];
  const Mlp& m = a.m;
  const Board& g = a.g;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int tix = wid / kTeamWarps;  // the game's slot in the CTA
  const bool leader = wid % kTeamWarps == 0;
  const int b = blockIdx.x * a.games_per_cta + tix;
  const hex::Team team{static_cast<int>(threadIdx.x) % (32 * kTeamWarps), 32 * kTeamWarps, 1 + tix};
  const int L = g.L, F = g.F, A = m.A, B = a.B;
  const int member_size = hex::ttower_size(m, A);
  const int agent_size = member_size + hex::ttower_size(m, 1);

  // the agent's image, once per launch, shared by the CTA's games: the
  // kernel's only block barrier
  const float* aw = a.agent;
  if (a.agent_in_smem) {
    for (int i = threadIdx.x * 4; i < agent_size; i += blockDim.x * 4)
      *reinterpret_cast<float4*>(smem_roll + i) = __ldcg(reinterpret_cast<const float4*>(a.agent + i));
    aw = smem_roll;
  }
  __syncthreads();
  if (b >= B) return;

  char* slice = reinterpret_cast<char*>(smem_roll + (a.agent_in_smem ? agent_size : 0)) +
                static_cast<long long>(tix) * a.game_bytes;
  float* mw = reinterpret_cast<float*>(slice);
  float* x = mw + (a.member_in_smem ? member_size : 0);
  float* h0 = x + hex::round4(F);
  float* h1 = h0 + 2 * hex::round4(m.H);
  float* y = h1 + 2 * hex::round4(m.H);
  int* member_of = reinterpret_cast<int*>(y + hex::round4(A + 1));  // for the team
  int* lab = member_of + 4;
  uint8_t* st0 = reinterpret_cast<uint8_t*>(lab + L);
  uint8_t* st1 = st0 + L;
  uint8_t* legal = st1 + L;

  const float* agent_pi = aw;
  const float* agent_vf = aw + member_size;
  if (!leader) {
    // a helper warp: its share of the two forward passes of every step, in
    // step with the leader through the team's barrier
    for (int step = 0; step < a.T; ++step) {
      team.sync();  // the agent's observation is in x
      hex::team_mlp_towers(team, m, agent_pi, A, agent_vf, 1, x, h0, h1, y);
      team.sync();  // the opponent's observation and member are ready
      const float* mweights =
          a.member_in_smem ? mw : a.bank + static_cast<long long>(*member_of) * member_size;
      hex::team_mlp_towers(team, m, mweights, A, nullptr, 0, x, h0, h1, y);
    }
    return;
  }

  // the leader warp: the game itself
  for (int t = lane; t < L; t += 32) {
    lab[t] = a.labels[b * L + t];
    st0[t] = a.stones[(2 * b) * L + t];
    st1[t] = a.stones[(2 * b + 1) * L + t];
  }
  // the float4 reads of x and h0/h1 cover their pads: zero them once
  for (int i = lane; i < reinterpret_cast<float*>(member_of) - x; i += 32) x[i] = 0.0f;
  // per-game scalars: one copy per lane, updated identically by all
  int tm = a.to_move[b], empty = a.empty[b], mc = a.moves[b];
  bool done = a.done[b] != 0;
  int seat = a.seat[b], use_best = a.use_best[b] != 0, opp_idx = a.opp_idx[b];

  const bool injected = a.agent_bits != nullptr;
  curandStatePhilox4_32_10_t st;
  if (!injected) curand_init(a.seed, static_cast<unsigned long long>(b) * 32 + lane, 0, &st);

  // the game's bank member into its slice, asynchronously, when it changes
  int staged = -1;
  auto stage_member = [&](int member) {
    if (!a.member_in_smem || member == staged) return;
    staged = member;
    const float* src = a.bank + static_cast<long long>(member) * member_size;
    for (int i = lane * 4; i < member_size; i += 128) cp_async16(mw + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_member(use_best ? a.P1 - 1 : opp_idx);
  __syncwarp();

  for (int step = 0; step < a.T; ++step) {
    const long long row = static_cast<long long>(step) * B + b;
    long long* tk = a.timers != nullptr ? a.timers + (static_cast<long long>(b) * a.T + step) * kRollMarks
                                        : nullptr;
    roll_mark(tk, 0, lane == 0);

    // ---- 1. agent forward + sample ------------------------------------
    warp_observe(g, st0, st1, tm, x, legal, a.o_obs + row * F);
    team.sync();
    hex::team_mlp_towers(team, m, agent_pi, A, agent_vf, 1, x, h0, h1, y);
    roll_mark(tk, 1, lane == 0);
    const float value = y[A];
    float logp;
    const Bits abits{injected ? a.agent_bits + row * A : nullptr, &st};
    const int act_a = hex::warp_masked_sample(y, legal, A, !a.eval_mode, abits, &logp);
    roll_mark(tk, 2, lane == 0);

    // ---- 2. agent move ---------------------------------------------------
    const bool act1 = !done;
    const bool win1 = hex::warp_place_stone(g, st0, st1, lab, tm, hex::to_world(act_a, tm, g.n), act1,
                                            true, L);
    if (act1) {
      empty -= 1;
      done = win1 || empty <= 0;
      tm = 1 - tm;
      mc += 1;
    }
    roll_mark(tk, 3, lane == 0);

    // ---- 3. opponent reply -----------------------------------------------
    warp_observe(g, st0, st1, tm, x, legal, nullptr);
    const int member = use_best ? a.P1 - 1 : opp_idx;
    const float* mweights = mw;
    if (a.member_in_smem) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // the team's barrier publishes it
    } else {
      mweights = a.bank + static_cast<long long>(member) * member_size;
      if (lane == 0) *member_of = member;
    }
    team.sync();
    hex::team_mlp_towers(team, m, mweights, A, nullptr, 0, x, h0, h1, y);
    roll_mark(tk, 4, lane == 0);
    const Bits obits{injected ? a.opp_bits + row * A : nullptr, &st};
    const int act_o = hex::warp_masked_sample(y, legal, A, true, obits, nullptr);
    roll_mark(tk, 5, lane == 0);
    const bool act2 = !done;
    const bool win2 = hex::warp_place_stone(g, st0, st1, lab, tm, hex::to_world(act_o, tm, g.n), act2,
                                            true, L);
    if (act2) {
      empty -= 1;
      done = win2 || empty <= 0;
      tm = 1 - tm;
      mc += 1;
    }
    const float reward = (win1 ? 1.0f : 0.0f) - (win2 ? 1.0f : 0.0f);
    const bool done_out = done;
    roll_mark(tk, 6, lane == 0);

    // ---- 4. auto-reset + redraws + opening move (training only) ----------
    int act_f = 0;
    if (!a.eval_mode) {
      uint32_t word = 0;
      if (lane < 3) word = injected ? a.reset_bits[row * kResetLanes + lane] : curand(&st);
      const float u_seat = hex::unit_uniform(__shfl_sync(hex::kFullMask, word, 0));
      const float u_best = hex::unit_uniform(__shfl_sync(hex::kFullMask, word, 1));
      const float u_idx = hex::unit_uniform(__shfl_sync(hex::kFullMask, word, 2));
      const bool m_reset = done;
      if (m_reset) {
        for (int t = lane; t < L; t += 32) {
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
        stage_member(use_best ? a.P1 - 1 : opp_idx);
      }
      __syncwarp();
      // the opener's logits: the member's empty-board row; every cell legal
      const float* first = a.first + static_cast<long long>(use_best ? a.P1 - 1 : opp_idx) * A;
      float bv = -FLT_MAX;
      int bi = INT_MAX;
      for (int j = lane; j < A; j += 32) {
        const uint32_t w = injected ? a.first_bits[row * A + j] : curand(&st);
        const float score = first[j] + hex::gumbel(w);
        if (hex::better(score, j, bv, bi)) {
          bv = score;
          bi = j;
        }
      }
      act_f = hex::warp_argmax(bv, bi);
      const bool act3 = m_reset && seat == 1;
      hex::warp_place_stone(g, st0, st1, lab, tm, act_f, act3, true, L);  // seat 0 opens: world frame
      if (act3) {
        empty -= 1;
        tm = 1 - tm;
        mc += 1;
      }
    }
    roll_mark(tk, 7, lane == 0);

    // ---- emit ---------------------------------------------------------------
    if (lane < 8) {
      const int iv[8] = {act_a, act_o, act_f, done_out, seat, use_best, opp_idx, 0};
      const float fv[8] = {logp, value, reward, 0.f, 0.f, 0.f, 0.f, 0.f};
      a.o_ints[row * 8 + lane] = iv[lane];
      a.o_flts[row * 8 + lane] = fv[lane];
    }
    roll_mark(tk, 8, lane == 0);
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int t = lane; t < L; t += 32) {
    a.o_labels[b * L + t] = lab[t];
    a.o_stones[(2 * b) * L + t] = st0[t];
    a.o_stones[(2 * b + 1) * L + t] = st1[t];
  }
  if (lane == 0) {
    a.o_to_move[b] = tm;
    a.o_done[b] = done;
    a.o_empty[b] = empty;
    a.o_moves[b] = mc;
    a.o_seat[b] = seat;
    a.o_use_best[b] = use_best;
    a.o_opp_idx[b] = opp_idx;
  }
}
// ===========================================================================
// K7 — the fused random-legal rollout.  Replaces
// ops/pallas_step.py:_random_rollout_kernel (entry `random_rollout`).  T
// uniform-random legal moves per game with auto-reset, for the env-throughput
// benchmark.  One warp per game (the launch shape of K1); the time loop runs
// inside the warp and the game's stones and labels stay in its slice of
// shared memory for all T steps.
//
// Per step: the move is the argmax over cells of (bits >> 8) + 1 on empty
// cells and 0 elsewhere (lowest cell on ties; cell 0 when no cell is empty,
// as on a full board handed in), placed in the world frame.  Lane l scores
// its cells l + 32q, q < nq = ceil(F / 32), in ascending order, keeping the
// first best, from (0, l); then hex::warp_argmax_u32 takes the warp's best
// with ties to the lowest index, so the result is the block argmax's over
// all L lanes.  The score is an integer below 2^24 + 1, as exact as the JAX
// kernel's float32.  A lane keeps its cells' occupancy as bits of a register
// (so F <= 1024, which the entry checks), set by the lane that owns the
// placed cell.  The union is hex::warp_place_stone over the F + 4 real lanes
// with the win test joined_e0 & joined_e1 only (no pre-connected term,
// unlike K1); on a win or a full board the game resets to zero stones and
// identity labels over all L lanes, seat 0 to move and num_cells empty, and
// `games` counts the resets.  Only to_move and empty are read of the
// per-game scalars (a game that came in done is played on); done 0, winner
// -1 and move_count 0 are written, as the JAX kernel's meta.  Each lane
// holds a copy of the game's scalars, updated identically, so no lane waits
// on another for them.
//
// Randomness: injected bits keep the (T, B, L) layout, lane l reading the
// words of its cells.  Without them each lane draws from its own Philox
// stream, curand_init(seed, game * 32 + lane, 0) as K4's, nq words a step
// in q order, whether or not the cell exists, so every lane of the warp
// refills curand's four-word buffer at the same step and the refill never
// diverges.  The production stream differs from the one-game-per-CTA
// kernel's (which drew one word per thread and lane, padding included);
// its distribution, uniform over the empty cells, does not.
//
// Bound: operations.  Per game and step: the score and the max over the F
// cells (2F) and, over the F + 4 real lanes, the relabel's 8 compares and
// 8 ors and the select (17 (F + 4)): 999 32-bit integer operations at 7x7,
// 4.2e9 at B = 8192, T = 512, 0.063 ms at the fp32 rate (no integer op runs
// faster).  An earlier count took 19 operations on every one of the L = 128
// lanes, padding included, and gave 0.152 ms for the same work.  Bytes: the
// state in and out, ~13 MB at that shape, 4 us (plus 4 T B L with injected
// bits).
//
// The earlier design ran one game per CTA of L threads: at 7x7 75 of the
// 128 threads had no real lane, every step waited on five block barriers
// (two in the argmax, two in the union, one in the next argmax), and at
// most 16 games fit on an SM; it took 6.3-6.4 ms at that shape.  Now a step
// has no block barrier, only warp votes, shuffles and two redux.sync, and
// every thread holds real cells.  ptxas gives 47 registers a thread, so 5
// CTAs of 8 games (40 games) are resident per SM; capping it at 40
// registers for 48 games per SM did not run faster, since the warps issue
// most of the time.  About 1.3-1.5 ms at that shape (H100 SXM 80 GB, 700 W).
// ===========================================================================

struct RandomRolloutArgs {
  const uint8_t* stones;  // (B, 2, L) bool
  const int* labels;      // (B, L)
  const int* to_move;
  const int* empty;
  const uint32_t* bits;  // (T, B, L) or null: Philox
  unsigned long long seed;
  int* o_ints;  // see the launch shape above; games after move_count
  uint8_t* o_bytes;
  Board g;
  int B, T, games_per_cta;
};

__global__ void __launch_bounds__(32 * kEnvMaxGames) random_rollout_kernel(RandomRolloutArgs a) {
  extern __shared__ __align__(16) int smem_env[];
  const Board& g = a.g;
  const int L = g.L, F = g.F, lane = hex::lane_id(), slot = threadIdx.x >> 5;
  const int b = blockIdx.x * a.games_per_cta + slot;
  if (b >= a.B) return;  // a whole warp: no barrier waits for it
  EnvSlice game(smem_env, slot, L);
  game.load(a.labels, a.stones, b, L);
  int s = a.to_move[b], empty = a.empty[b], games = 0;
  // the lane's cells lane + 32q, q < nq, and their occupancy as the bits of
  // a register (F <= 1024)
  const int nq = (F + 31) / 32;
  unsigned occ = 0u;
  for (int q = 0; q < nq; ++q) {
    const int t = lane + 32 * q;
    if (t < F && (game.st0[t] | game.st1[t])) occ |= 1u << q;
  }

  const bool injected = a.bits != nullptr;
  curandStatePhilox4_32_10_t st;
  if (!injected) curand_init(a.seed, static_cast<unsigned long long>(b) * 32 + lane, 0, &st);

  for (int step = 0; step < a.T; ++step) {
    const uint32_t* w = injected ? a.bits + (static_cast<long long>(step) * a.B + b) * L : nullptr;
    unsigned best = 0u;  // (0, lane): loses to every empty cell and to lane 0's own (0, 0)
    int bi = lane;
    for (int q = 0; q < nq; ++q) {  // every lane draws nq words a step: refills in step
      const int t = lane + 32 * q;
      const uint32_t word = injected ? (t < F ? w[t] : 0u) : curand(&st);
      const unsigned score = (t < F && !((occ >> q) & 1u)) ? (word >> 8) + 1u : 0u;
      if (score > best) {
        best = score;
        bi = t;
      }
    }
    const int c = hex::warp_argmax_u32(best, bi);
    const bool joined = hex::warp_place_stone(g, game.st0, game.st1, game.lab, s, c, true, false, F + 4);
    if ((c & 31) == lane) occ |= 1u << (c >> 5);
    empty -= 1;
    if (joined || empty <= 0) {  // the same on every lane
      for (int t = lane; t < L; t += 32) {
        game.lab[t] = t;
        game.st0[t] = 0;
        game.st1[t] = 0;
      }
      __syncwarp();
      occ = 0u;
      s = 0;
      empty = F;
      ++games;
    } else {
      s = 1 - s;
    }
  }

  const long long BL = static_cast<long long>(a.B) * L;
  game.store(a.o_ints, a.o_bytes, b, L);
  if (lane == 0) {
    int* o = a.o_ints + BL;  // to_move, winner, empty, move_count, games
    o[b] = s;
    o[a.B + b] = -1;
    o[2 * a.B + b] = empty;
    o[3 * a.B + b] = 0;
    o[4 * a.B + b] = games;
    a.o_bytes[2 * BL + b] = 0;
  }
}

// shared-memory bytes of the x/h0/h1/y float buffers
int mlp_smem_bytes(const Mlp& m) { return (m.F + 4 * m.H + m.A + 1) * static_cast<int>(sizeof(float)); }

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// K1's and K7's games per CTA for B games (see the launch shape above)
cudaError_t env_games_per_cta(int B, int* gpc) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  *gpc = std::max(1, std::min(kEnvMaxGames, B / std::max(n_sm, 1)));
  return e;
}

// launch one of the warp-per-game kernels on B games of L lanes
template <typename Args>
int launch_env(void (*kernel)(Args), Args a, int L, void* stream) {
  cudaError_t e = env_games_per_cta(a.B, &a.games_per_cta);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = a.games_per_cta * env_game_bytes(L);
  if ((e = allow_smem(reinterpret_cast<const void*>(kernel), smem)) != cudaSuccess) return static_cast<int>(e);
  kernel<<<(a.B + a.games_per_cta - 1) / a.games_per_cta, 32 * a.games_per_cta, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

}  // namespace

// ===========================================================================
// C interface
// ===========================================================================

extern "C" {

const char* hex_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int hex_step(const void* stones, const void* labels, const void* to_move, const void* done,
             const void* winner, const void* empty, const void* moves, const void* actions,
             const void* active, void* o_ints, void* o_bytes, int B, int n, int L, void* stream) {
  const StepArgs a{static_cast<const uint8_t*>(stones), static_cast<const int*>(labels),
                   static_cast<const int*>(to_move),    static_cast<const uint8_t*>(done),
                   static_cast<const int*>(winner),     static_cast<const int*>(empty),
                   static_cast<const int*>(moves),      static_cast<const int*>(actions),
                   static_cast<const uint8_t*>(active), static_cast<int*>(o_ints),
                   static_cast<uint8_t*>(o_bytes),      Board{n, n * n, L},
                   B,                                   0};
  return launch_env(step_kernel, a, L, stream);
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

// The rollout's launch shape for one model, board and batch: plan =
// [games per CTA, agent in shared memory, members in shared memory, shared
// bytes].  The first of (agent and members in shared memory), (agent only),
// (neither) that fits one game, then the games per CTA (at most 8) that
// need the fewest waves of CTAs on the card, the fewest games among equals.
int hex_rollout_plan(int F, int H, int A, int n_layers, int n, int L, int B, int* plan) {
  const Mlp m{F, H, A, n_layers, 0};
  const Board g{n, n * n, L};
  // K4 is held against its twin on boards up to 11x11 only (L = 128), the
  // sizes of the preset grid; ops/rollout_kernel.py gates it the same way
  if (L > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int limit = 220 * 1024;
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(rollout_kernel),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, n_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  const int agent_bytes = (hex::ttower_size(m, A) + hex::ttower_size(m, 1)) * 4;
  const int modes[3][2] = {{1, 1}, {1, 0}, {0, 0}};
  int best_waves = 0;
  plan[0] = 0;
  for (const auto& mode : modes) {
    const int gb = rollout_game_bytes(m, g, mode[1] != 0);
    for (int gpc = 1; gpc <= 8; ++gpc) {
      const int bytes = (mode[0] ? agent_bytes : 0) + gpc * gb;
      if (bytes > limit) break;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, reinterpret_cast<const void*>(rollout_kernel), 32 * kTeamWarps * gpc, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (per_sm < 1) break;
      const int ctas = (B + gpc - 1) / gpc;
      const int waves = (ctas + per_sm * n_sm - 1) / (per_sm * n_sm);
      if (plan[0] == 0 || waves < best_waves) {
        best_waves = waves;
        plan[0] = gpc;
        plan[1] = mode[0];
        plan[2] = mode[1];
        plan[3] = bytes;
      }
    }
    if (plan[0] != 0) break;
  }
  return plan[0] != 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int hex_rollout(const void* agent, const void* bank, const void* first, void* image, int F,
                int H, int A, int n_layers, int relu, int P1, const void* stones, const void* labels,
                const void* to_move, const void* done, const void* empty, const void* moves,
                const void* seat, const void* use_best, const void* opp_idx,
                const void* agent_bits, const void* opp_bits, const void* first_bits,
                const void* reset_bits, unsigned long long seed,
                void* o_obs, void* o_ints, void* o_flts, void* o_stones, void* o_labels,
                void* o_to_move, void* o_done, void* o_empty, void* o_moves, void* o_seat,
                void* o_use_best, void* o_opp_idx, int B, int n, int L, int T, float best_prob,
                int per_episode_seat, int eval_mode, int games_per_cta, int agent_in_smem,
                int member_in_smem, void* timers, void* stream) {
  RolloutArgs a{};
  a.m = Mlp{F, H, A, n_layers, relu};
  float* img = static_cast<float*>(image);
  a.agent = img;
  a.bank = img + hex::ttower_size(a.m, A) + hex::ttower_size(a.m, 1);
  a.first = static_cast<const float*>(first);
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
  a.timers = static_cast<long long*>(timers);
  a.games_per_cta = games_per_cta;
  a.agent_in_smem = agent_in_smem;
  a.member_in_smem = member_in_smem;
  a.game_bytes = rollout_game_bytes(a.m, a.g, member_in_smem != 0);
  const int smem = (agent_in_smem ? (hex::ttower_size(a.m, A) + hex::ttower_size(a.m, 1)) * 4 : 0) +
                   games_per_cta * a.game_bytes;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(rollout_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int image_blocks = (hex::ttower_size(a.m, A) + 255) / 256;
  tower_image_kernel<<<dim3(image_blocks, 2 + P1), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(agent), static_cast<const float*>(bank), a.m, img);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  rollout_kernel<<<(B + games_per_cta - 1) / games_per_cta, 32 * kTeamWarps * games_per_cta, smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

// floats of hex_rollout's image scratch: the agent's two towers and P1 bank
// members, transposed and padded
int hex_rollout_image_floats(int F, int H, int A, int n_layers, int P1) {
  const Mlp m{F, H, A, n_layers, 0};
  return hex::ttower_size(m, A) * (1 + P1) + hex::ttower_size(m, 1);
}

int hex_random_rollout(const void* stones, const void* labels, const void* to_move,
                       const void* empty, const void* bits, unsigned long long seed, void* o_ints,
                       void* o_bytes, int B, int n, int L, int T, void* stream) {
  const RandomRolloutArgs a{static_cast<const uint8_t*>(stones), static_cast<const int*>(labels),
                            static_cast<const int*>(to_move),    static_cast<const int*>(empty),
                            static_cast<const uint32_t*>(bits),  seed,
                            static_cast<int*>(o_ints),           static_cast<uint8_t*>(o_bytes),
                            Board{n, n * n, L},                  B,
                            T,                                   0};
  if (n * n > 1024) return static_cast<int>(cudaErrorInvalidValue);  // occupancy bits
  return launch_env(random_rollout_kernel, a, L, stream);
}

// K1's and K7's launch shape for B games of L lanes, for reports: plan =
// [games per CTA, CTAs resident per SM, registers per thread] of K1
// (kernel 0) or K7 (kernel 1).  Launches nothing.
int hex_env_plan(int kernel, int B, int L, int* plan) {
  const void* fn = kernel == 0 ? reinterpret_cast<const void*>(step_kernel)
                               : reinterpret_cast<const void*>(random_rollout_kernel);
  cudaError_t e = env_games_per_cta(B, &plan[0]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = plan[0] * env_game_bytes(L);
  if ((e = allow_smem(fn, smem)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&plan[1], fn, 32 * plan[0], smem)) != cudaSuccess)
    return static_cast<int>(e);
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return static_cast<int>(e);
  plan[2] = attr.numRegs;
  return 0;
}

}  // extern "C"
