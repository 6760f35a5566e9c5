// The env and selfplay rollout's kernels (K1-K4, K7, the random-legal
// rollout of the env-throughput benchmark, and the match's policy forward)
// for Hopper (sm_90a), behind a
// plain C interface loaded with ctypes (ops/cuda_lib.py).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhexkernels.so hex_kernels.cu
// Never with --use_fast_math: tanhf/logf/expf must stay the library ones,
// or the kernels drift from their PyTorch twins.
//
// Games are independent: K1 and K7 run a warp per game and K2-K4 a team of
// warps per game, several games per CTA.  Each entry launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() of its
// launch.
//
// Randomness: each kernel takes an optional bits array in the JAX package's
// interpret-mode layout and maps bits to samples exactly as the JAX kernels
// do.  Without it, each lane of a game draws from its own Philox stream,
// curand_init(seed, game * 32 + lane, 0); the wrapper draws a fresh seed per
// launch from the caller's generator, so no two launches share a stream and
// a restored generator replays the streams.  That is this port's stream
// deviation, as the TPU hardware PRNG is the JAX package's.

#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

#include "hex_common.cuh"

using hex::Bits;
using hex::Board;
using hex::Mlp;

namespace {

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
// `agent_forward_sample`).  Per game: both towers of the agent on its
// observation, side by side, then the masked Gumbel-max sample, its
// log-softmax and the value.  Bound: operations, 2(F*2H + (n_layers-1)*2H*H
// + H*(A+1)) FLOP per game (~35 KFLOP at 7x7, H = 64; 9 MFLOP at B = 256,
// 0.13 us at the fp32 peak); the bytes (the packed float32 weights, ~72 KB,
// read once, plus each game's rows) take less.  But every game reads all of
// the agent: its ~76 KB image, 19.5 MB at B = 256 were each game to fetch it.
//
// The first design ran one game per CTA of 128 threads: thread j computed
// output j in an fmaf loop that read the (in, out) weights from L2 one by
// one, block barriers between the layers and in the sample's three
// reductions (8.1 us per call at 7x7, B = 256 on one H100).  Now:
//   - the agent is transposed and padded once per rollout (hex_tower_image,
//     the layout of team_mlp_towers), so a thread's weight row is
//     contiguous and dot_row has a row's loads in flight before its chain;
//   - one thread of each CTA copies the image into shared memory with bulk
//     copies (cp.async.bulk, the TMA's plain-bytes form), layer l of both
//     towers onto transaction barrier l, so the games start on layer 0 while
//     the later layers are in flight, and the CTA's games share the copy; an
//     image that does not fit (MLP-wide-deep at 9x9, ~540 KB) is read from
//     global memory (L2) instead;
//   - a team of kAgentTeamWarps warps per game runs both towers side by side
//     (team_mlp_towers: one hidden unit a thread at H = 64) behind the game's
//     own named barrier, then the leader warp samples (warp_masked_sample,
//     butterflies); the one block barrier publishes the transaction
//     barriers' set-up;
//   - up to kAgentMaxGames games per CTA, as many as still leave no SM idle
//     (ceil(B / SMs)): B = 256 runs 128 CTAs of two games, B = 30 30 CTAs.
// Measured on one H100 (7x7, B = 256, device time): 5.4 us as kept; 5.6 us
// with teams of two warps; 5.7 us with one game per CTA (floor(B / SMs), the
// rule of K1 and K3), 6.0 us with both; 6.2 us with two-warp teams at four
// games per CTA (64 CTAs); the image staged by every thread with 16-byte
// cp.async behind a block barrier 6.7 us (four warps, one game per CTA) and
// 7.9 us (two); the image read from L2 by each game, as K3 reads its bank,
// 10.2 us (four warps) and 11.8 us (two).
// Randomness: with bits the JAX map; without, each lane of a game draws from
// curand_init(seed, game * 32 + lane, 0), as K3 and K4: the stream differs
// from the first design's (one per CTA thread); its distribution does not.
// ===========================================================================

constexpr int kAgentTeamWarps = 4;  // warps per game
// games per CTA at most: 256 threads, whose launch bound leaves a thread the
// 255 registers it can use (dot_row holds 32 float4; K3 at 512 spilled it)
constexpr int kAgentMaxGames = 2;

struct AgentArgs {
  const float* image;  // the agent's image: pi tower (ttower_size(m, A)), then vf tower
  Mlp m;
  const int8_t* obs;     // (B, F)
  const uint8_t* legal;  // (B, A)
  const uint32_t* bits;  // (B, A) or null
  unsigned long long seed;
  float* o_masked;  // (B, A)
  float* o_logp;
  float* o_value;
  int* o_action;
  int B, games_per_cta;
  int staged;  // the image in shared memory (else read from global memory)
};

__host__ __device__ inline int agent_image_floats(const Mlp& m) {
  return hex::ttower_size(m, m.A) + hex::ttower_size(m, 1);
}

// the staged image's floats with its n_layers + 1 barriers (8 bytes each)
__host__ __device__ inline int agent_staged_floats(const Mlp& m) {
  return agent_image_floats(m) + hex::round4(2 * (m.n_layers + 1));
}

// one game's slice of shared memory (floats): x (round4(F)), h0 and h1 (two
// towers of round4(H) each), y (round4(A + 1): the logits, then the value)
__host__ __device__ inline int agent_game_floats(const Mlp& m) {
  return hex::round4(m.F) + 4 * hex::round4(m.H) + hex::round4(m.A + 1);
}

__global__ void __launch_bounds__(32 * kAgentTeamWarps * kAgentMaxGames) agent_kernel(AgentArgs a) {
  extern __shared__ __align__(16) float smem_agent[];
  const Mlp& m = a.m;
  const float* image = a.image;
  const uint64_t* ready = nullptr;
  if (a.staged) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_agent + agent_image_floats(m));
    if (threadIdx.x == 0) {
      for (int l = 0; l <= m.n_layers; ++l) hex::mbar_init(bars + l, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are set up: the kernel's only block barrier
    if (threadIdx.x == 0) {
      // layer l of both towers in flight onto barrier l: the games start on
      // layer 0 while the later layers are still on their way
      const int vf = hex::ttower_size(m, m.A);
      int off = 0, in = m.F;
      for (int l = 0; l <= m.n_layers; ++l) {
        const bool head = l == m.n_layers;
        const int pi_n = hex::tlayer_size(in, head ? m.A : m.H);
        const int vf_n = hex::tlayer_size(in, head ? 1 : m.H);
        hex::mbar_expect_tx(bars + l, 4u * (pi_n + vf_n));
        hex::bulk_copy(smem_agent + off, a.image + off, 4u * pi_n, bars + l);
        hex::bulk_copy(smem_agent + vf + off, a.image + vf + off, 4u * vf_n, bars + l);
        off += pi_n;
        in = m.H;
      }
    }
    image = smem_agent;
    ready = bars;
  }
  const int wid = threadIdx.x >> 5, slot = wid / kAgentTeamWarps;
  const int b = blockIdx.x * a.games_per_cta + slot;
  if (b >= a.B) return;  // the whole team: no barrier waits for it
  const hex::Team team{static_cast<int>(threadIdx.x) % (32 * kAgentTeamWarps), 32 * kAgentTeamWarps,
                       1 + slot};
  const int F4 = hex::round4(m.F), H4 = hex::round4(m.H);
  float* x = smem_agent + (a.staged ? agent_staged_floats(m) : 0) + slot * agent_game_floats(m);
  float* h0 = x + F4;
  float* h1 = h0 + 2 * H4;
  float* y = h1 + 2 * H4;
  // the observation, and the pads the float4 reads cover, zeroed
  for (int i = team.rank; i < F4; i += team.n_threads)
    x[i] = i < m.F ? static_cast<float>(a.obs[static_cast<long long>(b) * m.F + i]) : 0.0f;
  for (int i = m.H + team.rank; i < H4; i += team.n_threads)
    h0[i] = h0[H4 + i] = h1[i] = h1[H4 + i] = 0.0f;
  team.sync();
  hex::team_mlp_towers(team, m, image, m.A, image + hex::ttower_size(m, m.A), 1, x, h0, h1, y,
                       ready);
  if (wid % kAgentTeamWarps != 0) return;  // a helper: its share is done

  const int lane = hex::lane_id();
  const long long row = static_cast<long long>(b) * m.A;
  curandStatePhilox4_32_10_t st;
  if (a.bits == nullptr) curand_init(a.seed, static_cast<unsigned long long>(b) * 32 + lane, 0, &st);
  const Bits bits{a.bits != nullptr ? a.bits + row : nullptr, &st};
  float logp;
  const int action = hex::warp_masked_sample(y, a.legal + row, m.A, true, bits, &logp);
  for (int j = lane; j < m.A; j += 32) a.o_masked[row + j] = y[j];  // the lane's own entries
  if (lane == 0) {
    a.o_action[b] = action;
    a.o_logp[b] = logp;
    a.o_value[b] = y[m.A];
  }
}

// ===========================================================================
// K3 — opponent-bank pass.  Replaces ops/pallas_policy.py:_bank_kernel
// (entry `bank_forward_sample`).  Each row's member (pool slot, or the best
// at index P1 - 1) runs its pi tower and action head on the row's
// observation, then the masked Gumbel-max sample.  Bound: bytes, the members
// actually used (each ~42 KB at 7x7, H = 64; all 31 at B = 256, 0.4 us of
// HBM time) plus per-game rows; the operations, 2(F*H + (n_layers-1)*H*H +
// H*A) FLOP per game (~21 KFLOP), take less.  At B = 256 the launch and the
// game's serial path (three dependent layers, then the sample) set the time.
//
// The first design ran one game per CTA of 128 threads: thread j computed
// output j in an fmaf loop that read the member's (in, out) weights from L2
// one by one, block barriers between the layers and in the sample's
// reductions, most lanes idle (10.1 us per call at B = 256 on one H100; the
// same pattern was 62% of K4's step before its redesign).  Now K4's pieces:
//   - the bank is transposed and padded once per rollout (hex_tower_image:
//     tower_image_kernel, the layout of team_mlp_towers), so a thread's
//     weight row is contiguous and dot_row has all of a row's loads in
//     flight before its fmaf chain;
//   - a team of kBankTeamWarps warps per game, up to kBankMaxGames games per
//     CTA (fewer where B is small, as K1, so B = 256 runs 256 CTAs of one
//     game):
//     the team shares the forward pass behind the game's own named barrier,
//     then the leader warp samples with warp_masked_sample (butterflies, ties
//     to the lowest index); no block barrier anywhere;
//   - lane l owns outputs l, l + 32, ... of any width, so any board the scan
//     path takes runs (13x13 and up).
// Measured on one H100 (7x7, B = 256, device time): 7.4 us on the image;
// 10.7 us reading the (in, out) layout with a row's 32 loads in flight
// before the chain; 9.4 us with one warp per game (but 21.8 against 40.5 us
// at B = 4096); 8.4 us with the rows prefetched into L1 up front; 21.8 us
// at 512 threads per CTA, whose launch bound cut the registers to 32 and
// spilled dot_row.  Every game reads its member's ~45 KB from L2 (11 MB at
// B = 256), which with the launch sets most of what is left.
// Randomness: with bits the JAX map; without, each lane of a game draws from
// curand_init(seed, game * 32 + lane, 0), as K4.
// ===========================================================================

constexpr int kBankTeamWarps = 2;  // warps per game
// games per CTA at most: team_mlp_towers' dot_row holds 32 float4 in
// registers, so a thread needs well over 128 registers, and 4 warps per CTA
// keep a CTA within the SM's 64K
constexpr int kBankMaxGames = 2;

struct BankArgs {
  const float* image;  // P1 transposed, padded pi towers (ttower_size(m, A) each)
  Mlp m;
  int P1;
  const int8_t* obs;        // (B, F)
  const uint8_t* legal;     // (B, A)
  const int* member;        // (B,) member index
  const uint8_t* use_best;  // (B,) or null: where set, the best (P1 - 1) instead
  const uint32_t* bits;     // (B, A) or null
  unsigned long long seed;
  int* o_action;
  float* o_masked;  // (B, A)
  int B, games_per_cta;
};

// one game's slice of shared memory (floats): x (round4(F)), h0 and h1
// (round4(H) each), y (round4(A))
__host__ __device__ inline int bank_game_floats(const Mlp& m) {
  return hex::round4(m.F) + 2 * hex::round4(m.H) + hex::round4(m.A);
}

__global__ void __launch_bounds__(32 * kBankTeamWarps * kBankMaxGames) bank_kernel(BankArgs a) {
  extern __shared__ __align__(16) float smem_bank[];
  const Mlp& m = a.m;
  const int wid = threadIdx.x >> 5, slot = wid / kBankTeamWarps;
  const int b = blockIdx.x * a.games_per_cta + slot;
  if (b >= a.B) return;  // the whole team: no barrier waits for it
  const hex::Team team{static_cast<int>(threadIdx.x) % (32 * kBankTeamWarps), 32 * kBankTeamWarps,
                       1 + slot};
  const int F4 = hex::round4(m.F), H4 = hex::round4(m.H);
  float* x = smem_bank + slot * bank_game_floats(m);
  float* h0 = x + F4;
  float* h1 = h0 + H4;
  float* y = h1 + H4;
  const int member = a.use_best != nullptr && a.use_best[b] ? a.P1 - 1 : a.member[b];
  // the observation, and the pads the float4 reads cover, zeroed
  for (int i = team.rank; i < F4; i += team.n_threads)
    x[i] = i < m.F ? static_cast<float>(a.obs[static_cast<long long>(b) * m.F + i]) : 0.0f;
  for (int i = m.H + team.rank; i < H4; i += team.n_threads) h0[i] = h1[i] = 0.0f;
  team.sync();
  const float* w = a.image + static_cast<long long>(member) * hex::ttower_size(m, m.A);
  hex::team_mlp_towers(team, m, w, m.A, nullptr, 0, x, h0, h1, y);
  if (wid % kBankTeamWarps != 0) return;  // a helper: its share is done

  const int lane = hex::lane_id();
  const long long row = static_cast<long long>(b) * m.A;
  curandStatePhilox4_32_10_t st;
  if (a.bits == nullptr) curand_init(a.seed, static_cast<unsigned long long>(b) * 32 + lane, 0, &st);
  const Bits bits{a.bits != nullptr ? a.bits + row : nullptr, &st};
  const int action = hex::warp_masked_sample(y, a.legal + row, m.A, true, bits, nullptr);
  for (int j = lane; j < m.A; j += 32) a.o_masked[row + j] = y[j];  // the lane's own entries
  if (lane == 0) a.o_action[b] = action;
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
//
// The bf16 bank (rollout_bank_bf16; JAX ops/pallas_rollout.py bank_bf16) is
// a second instance of the kernel, kBankBf16, not a branch in the time loop:
// tower_image_kernel rounds the members' weights and biases to bf16 (round
// to nearest even), and the opponent's forward rounds each hidden unit to
// bf16 where it writes it, so each of its dots takes a bf16 left-hand side
// (the observation in {-1, 0, 1} is exact) and bf16 weights, whose products
// are exact in float32, summed in float32 with the bias added after the dot:
// JAX's rule up to the order of the sum.  The agent's towers and the
// opening-move table stay float32.  Where the caller passes opp_logits, the
// kernel writes the opponent's logits of every step there: the check of
// this instance compares them, since the record holds only its actions.
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
  float* o_opp_logits;  // (T, B, A) the opponent's logits at each step, or null
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

// The transposed, padded towers of team_mlp_towers: instance 0 the agent's
// pi tower, 1 its vf tower, 2 + i bank member i; block row blockIdx.y builds
// instance first + blockIdx.y, and out holds the instances from `first` on,
// in that order (first = 2: the bank alone, K3's image).  round_members
// rounds the members' weights and biases to bf16 (K4's bf16 bank).
__global__ void tower_image_kernel(const float* agent, const float* bank, Mlp m, float* out,
                                   int first, int round_members) {
  const int inst = first + blockIdx.y, L = m.n_layers, H = m.H;
  const int head = inst == 1 ? 1 : m.A;
  const int pi_t = hex::ttower_size(m, m.A);
  auto offset = [&](int i) -> long long {
    return i == 0   ? 0
           : i == 1 ? pi_t
                    : pi_t + hex::ttower_size(m, 1) + static_cast<long long>(i - 2) * pi_t;
  };
  const float* src = inst == 0   ? agent
                     : inst == 1 ? agent + hex::tower_size(m, m.A)
                                 : bank + static_cast<long long>(inst - 2) * hex::tower_size(m, m.A);
  float* dst = out + (offset(inst) - offset(first));
  const bool round = round_members && inst >= 2;
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
        dst[q] = round ? hex::round_bf16(v) : v;
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

template <bool kBankBf16>
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
      hex::team_mlp_towers<kBankBf16>(team, m, mweights, A, nullptr, 0, x, h0, h1, y);
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
    hex::team_mlp_towers<kBankBf16>(team, m, mweights, A, nullptr, 0, x, h0, h1, y);
    roll_mark(tk, 4, lane == 0);
    if (a.o_opp_logits != nullptr)
      for (int j = lane; j < A; j += 32) a.o_opp_logits[row * A + j] = y[j];
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

// ===========================================================================
// The match's policy forward (mlp_forward_kernel, C entry hex_mlp_forward).
// Replaces no TPU kernel: the JAX package's match calls the model's
// forward, which XLA compiles whole.  Added because the port's eager
// forward (torch.func.functional_call, then ten or eleven ATen ops with two
// cuBLAS SGEMMs a tower) cost the match ~370 us of host time a side each
// ply.  One launch runs both towers of an MlpPolicy on float32 boards
// (B, F) and writes the raw action logits (B, A) and the value (B,): no
// mask, no draw (scripts/match.py picks from the logits).
// Bound: operations, 2 (2 F H + 2 (n_layers - 1) H^2 + H (A + 1)) FLOP a
// board: 145 MFLOP at 7x7, H = 64, B = 4096, 2.2 us at 67 TFLOP/s; the
// bytes (boards and logits 0.8 MB each, the 76 KB image) take 0.5 us at
// 3.35 TB/s.  Design:
//   - the weights are the side's image, built once a match from the
//     module's parameters by mlp_image_kernel in K2's agent-image layout
//     (each layer's n_out rows of n_in weights at row_stride(n_in), then its
//     biases; the pi tower, then the vf tower).  Where it fits beside the
//     activations (every board of MLP-default), the whole image goes into
//     shared memory by bulk copies, layer l of both towers onto transaction
//     barrier l, as K2 stages its image, so layer 0 runs while the rest is
//     on its way; else each tower stages one layer at a time with every
//     thread's 16-byte cp.async;
//   - a CTA takes R = 8 RT boards (RT 2, 4 or 8: fwd_plan takes the fewest
//     waves by the occupancy API, then the smallest RT; at 7x7, B = 4,096:
//     256 CTAs of 16 boards, two an SM), reads its boards coalesced, 16
//     bytes a thread, and keeps each layer's activations in shared memory,
//     never in device memory;
//   - the two towers run side by side, 128 threads each behind a named
//     barrier of their own, so a layer is one step of both: 3 steps at
//     MLP-default, the value head beside the action head;
//   - a layer is a register-tiled product: thread (tc, tr) of its tower's
//     128 holds RT x 4 sums, rows tr + 8 i and outputs tc + 16 j (64
//     outputs a pass).  A warp covers 8 rows and 4 neighbouring outputs, so
//     each step over 4 inputs reads RT float4 of activations (8 rows, 128
//     bytes) and 4 float4 of weight rows (4 rows), conflict-free (row_stride
//     keeps 8 neighbouring rows on distinct banks), for 16 RT fmaf;
//   - each output is one fmaf chain over k = 0, 1, ..., plus the bias, then
//     tanhf or max(v, 0): float32 throughout, no TF32, no fast math.
// Measured on one H100 (device time, 7x7 MLP-default, B = 4,096): 12.8 us
// as kept; 13.5 us with CTAs of 32 boards, one an SM; 16.0 us with the
// towers one after the other on all 256 threads (RT x 4 tiles of rows 16
// apart) and 17.0 us with that and the image copied by plain loads and
// stores.  A CTA's own path sets the floor: 19 CTAs of 16 boards take
// 9.1 us, the three dependent layers with their loads behind the boards'
// read and the image's first layer.
// ===========================================================================

constexpr int kFwdThreads = 256;  // two towers of 128: 16 output lanes x 8 row lanes each
constexpr int kFwdTowerThreads = 128;
constexpr int kFwdCols = 4;       // outputs a thread, 16 apart: 64 a pass
constexpr int kFwdMaxLayers = 8;  // hidden layers a tower, at most

struct FwdArgs {
  const float* image;  // pi tower's image (ttower_size(m, A)), then the vf tower's
  Mlp m;
  const float* x;   // (B, F) boards
  float* o_logits;  // (B, A)
  float* o_value;   // (B,)
  int B;
  int resident;  // the whole image in shared memory, else one tower-layer a tower at a time
};

// a CTA's activations (floats): the boards (R rows at row_stride(F)), then
// two buffers of each tower's hidden units (R rows at row_stride(H))
__host__ __device__ inline int fwd_act_floats(const Mlp& m, int R) {
  return R * (hex::row_stride(m.F) + 4 * hex::row_stride(m.H));
}

// the largest tower-layer of the image: each tower's staging buffer (floats)
__host__ __device__ inline int fwd_stage_floats(const Mlp& m) {
  int s = hex::tlayer_size(m.F, m.H);
  if (m.n_layers > 1) s = s > hex::tlayer_size(m.H, m.H) ? s : hex::tlayer_size(m.H, m.H);
  return s > hex::tlayer_size(m.H, m.A) ? s : hex::tlayer_size(m.H, m.A);
}

// the tower's 128 threads wait for each other (named barrier 1 + tower)
__device__ __forceinline__ void fwd_tower_sync(int tower) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tower), "r"(kFwdTowerThreads) : "memory");
}

// n floats (a multiple of 4, both ends 16-byte aligned) into shared memory
// by one tower's threads (rank 0 .. 127), every 16-byte copy in flight
// before any is waited for; the caller's barrier then publishes them
__device__ __forceinline__ void fwd_stage(float* dst, const float* src, int n, int rank) {
  for (int q = 4 * rank; q < n; q += 4 * kFwdTowerThreads) cp_async16(dst + q, src + q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One layer of one tower for the CTA's 8 RT rows, by the tower's 128
// threads (rank 0 .. 127): out[r * out_stride + c] = v, v the bias c plus
// the fmaf chain of in[r][k] w[c][k] over k = 0 .. n_in - 1, then activated
// (relu >= 0: relu or tanh; -1: a head, left as it is); in has row stride
// row_stride(n_in) with zero pads, w is one layer of the image.  Rows from
// `rows` on are not written.
template <int RT>
__device__ inline void fwd_dense(int rank, const float* in, int n_in, const float* w, int n_out,
                                 int relu, float* out, int out_stride, int rows) {
  const int lane = rank & 31, wid = rank >> 5;
  const int tc = 4 * wid + (lane & 3), tr = lane >> 2;
  const int S = hex::row_stride(n_in), in4 = hex::round4(n_in);
  const float* bias = w + n_out * S;
  for (int c0 = 0; c0 + tc < n_out; c0 += 16 * kFwdCols) {
    const float* wr[kFwdCols];
#pragma unroll
    for (int j = 0; j < kFwdCols; ++j) wr[j] = w + min(c0 + tc + 16 * j, n_out - 1) * S;
    float acc[RT][kFwdCols];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < kFwdCols; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < in4; k += 4) {
      float4 a[RT], b[kFwdCols];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = hex::ld4(in + (tr + 8 * i) * S + k);
#pragma unroll
      for (int j = 0; j < kFwdCols; ++j) b[j] = hex::ld4(wr[j] + k);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < kFwdCols; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = tr + 8 * i;
#pragma unroll
      for (int j = 0; j < kFwdCols; ++j) {
        const int c = c0 + tc + 16 * j;
        if (r < rows && c < n_out) {
          const float v = acc[i][j] + bias[c];
          out[static_cast<long long>(r) * out_stride + c] = relu >= 0 ? hex::activate(v, relu) : v;
        }
      }
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(kFwdThreads, 1) mlp_forward_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem_fwd[];
  constexpr int R = 8 * RT;
  const Mlp& m = a.m;
  const int SF = hex::row_stride(m.F), SH = hex::row_stride(m.H), F4 = hex::round4(m.F);
  float* x = smem_fwd;
  float* pi0 = x + R * SF;
  float* pi1 = pi0 + R * SH;
  float* vf0 = pi1 + R * SH;
  float* vf1 = vf0 + R * SH;
  float* wbuf = vf1 + R * SH;  // the image, or a tower-layer of each tower
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), a.B - b0));
  const int vf_off = hex::ttower_size(m, m.A);
  // resident: one thread puts layer l of both towers in flight onto
  // transaction barrier l with bulk copies (as K2), so the first layer runs
  // while the later ones are still on their way
  uint64_t* bars = reinterpret_cast<uint64_t*>(wbuf + agent_image_floats(m));
  if (a.resident && threadIdx.x == 0) {
    for (int l = 0; l <= m.n_layers; ++l) hex::mbar_init(bars + l, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int off = 0, in = m.F;
    for (int l = 0; l <= m.n_layers; ++l) {
      const bool head = l == m.n_layers;
      const int pi_n = hex::tlayer_size(in, head ? m.A : m.H);
      const int vf_n = hex::tlayer_size(in, head ? 1 : m.H);
      hex::mbar_expect_tx(bars + l, 4u * (pi_n + vf_n));
      hex::bulk_copy(wbuf + off, a.image + off, 4u * pi_n, bars + l);
      hex::bulk_copy(wbuf + vf_off + off, a.image + vf_off + off, 4u * vf_n, bars + l);
      off += pi_n;
      in = m.H;
    }
  }

  // the CTA's boards are rows * F consecutive floats: 16 bytes a thread
  // where they start aligned, the tail one by one; every pad the float4
  // reads of a layer cover is zero, and so are the rows past B
  const float* src = a.x + b0 * m.F;
  const int n = rows * m.F;
  const int n4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? n / 4 : 0;
  for (int q = threadIdx.x; q < n4; q += kFwdThreads) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    const int i = 4 * q;
    x[(i / m.F) * SF + i % m.F] = v.x;
    x[((i + 1) / m.F) * SF + (i + 1) % m.F] = v.y;
    x[((i + 2) / m.F) * SF + (i + 2) % m.F] = v.z;
    x[((i + 3) / m.F) * SF + (i + 3) % m.F] = v.w;
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kFwdThreads) x[(i / m.F) * SF + i % m.F] = src[i];
  for (int q = threadIdx.x; q < R * F4; q += kFwdThreads) {
    const int r = q / F4, k = q % F4;
    if (r >= rows || k >= m.F) x[r * SF + k] = 0.0f;
  }
  const int H4 = hex::round4(m.H);
  for (int q = threadIdx.x; q < R * (H4 - m.H); q += kFwdThreads) {
    const int o = (q / (H4 - m.H)) * SH + m.H + q % (H4 - m.H);
    pi0[o] = pi1[o] = vf0[o] = vf1[o] = 0.0f;
  }
  __syncthreads();  // the boards, the pads and the barriers' set-up: the only block barrier

  // from here the two towers run side by side, the pi tower on threads
  // 0 .. 127 and the vf tower on 128 .. 255, each behind its own barrier
  const int tower = threadIdx.x / kFwdTowerThreads, rank = threadIdx.x % kFwdTowerThreads;
  const float* tw = (a.resident ? wbuf : a.image) + (tower == 0 ? 0 : vf_off);
  float* stage = wbuf + tower * fwd_stage_floats(m);
  float* h0 = tower == 0 ? pi0 : vf0;
  float* h1 = tower == 0 ? pi1 : vf1;
  const float* hin = x;
  int woff = 0, in = m.F;
  for (int l = 0; l <= m.n_layers; ++l) {
    const bool head = l == m.n_layers;
    const int n_out = head ? (tower == 0 ? m.A : 1) : m.H;
    float* hout = l & 1 ? h1 : h0;
    const float* w = tw + woff;
    if (a.resident) {
      hex::mbar_wait(bars + l, 0);
    } else {
      // (the barrier after the previous layer ended its reads of the copy)
      fwd_stage(stage, w, hex::tlayer_size(in, n_out), rank);
      fwd_tower_sync(tower);
      w = stage;
    }
    if (head) {
      float* o = tower == 0 ? a.o_logits + b0 * m.A : a.o_value + b0;
      fwd_dense<RT>(rank, hin, in, w, n_out, -1, o, tower == 0 ? m.A : 1, rows);
    } else {
      fwd_dense<RT>(rank, hin, in, w, n_out, m.relu, hout, SH, R);
      fwd_tower_sync(tower);  // the layer is written before the next reads it
    }
    woff += hex::tlayer_size(in, m.H);
    hin = hout;
    in = m.H;
  }
}

// The image's source: tower t's (0 pi, 1 vf) layer l (the head at
// n_layers), nn.Linear's weight (n_out, n_in), element (j, k) at
// w[j * ws[0] + k * ws[1]], and bias (n_out), element j at b[j * bs]
struct ImageSrc {
  const float* w[2][kFwdMaxLayers + 1];
  const float* b[2][kFwdMaxLayers + 1];
  long long ws[2][kFwdMaxLayers + 1][2];
  long long bs[2][kFwdMaxLayers + 1];
};

// mlp_forward_kernel's image from the module's parameters, once a match:
// block row blockIdx.y builds tower blockIdx.y.  nn.Linear already keeps a
// layer as rows of outputs, so each row is copied and padded to
// row_stride(n_in), the biases to round4(n_out): the values of K2's agent
// image (tower_image_kernel, from the packing).
__global__ void mlp_image_kernel(ImageSrc s, Mlp m, float* out) {
  const int t = blockIdx.y, head = t == 0 ? m.A : 1;
  float* dst = out + (t == 0 ? 0 : hex::ttower_size(m, m.A));
  const int total = hex::ttower_size(m, head);
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < total; q += gridDim.x * blockDim.x) {
    int woff = 0, in = m.F;
    for (int l = 0; l <= m.n_layers; ++l) {
      const int n_out = l == m.n_layers ? head : m.H, S = hex::row_stride(in);
      const int sz = hex::tlayer_size(in, n_out);
      if (q < woff + sz) {
        const int e = q - woff;
        float v = 0.0f;
        if (e < n_out * S) {
          const int j = e / S, k = e - j * S;
          if (k < in) v = s.w[t][l][j * s.ws[t][l][0] + k * s.ws[t][l][1]];
        } else if (e - n_out * S < n_out) {
          v = s.b[t][l][(e - n_out * S) * s.bs[t][l]];
        }
        dst[q] = v;
        break;
      }
      woff += sz;
      in = m.H;
    }
  }
}

int finish_launch() { return static_cast<int>(cudaGetLastError()); }

// dynamic shared memory a CTA may take on the card (227 KB)
constexpr int kMaxSmem = 227 * 1024;

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// games per CTA for B games, at most max_games: no more than keep one CTA
// per SM where B allows (see K1's and K7's launch shape above); with
// round_up, as many as share a CTA's staged weights and still leave no SM
// idle (K2)
cudaError_t env_games_per_cta(int B, int* gpc, int max_games = kEnvMaxGames, bool round_up = false) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  n_sm = std::max(n_sm, 1);
  *gpc = std::max(1, std::min(max_games, (B + (round_up ? n_sm - 1 : 0)) / n_sm));
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

// K4's instance: the float32 bank, or the bf16 bank
const void* rollout_fn(int bank_bf16) {
  return bank_bf16 ? reinterpret_cast<const void*>(rollout_kernel<true>)
                   : reinterpret_cast<const void*>(rollout_kernel<false>);
}

const void* fwd_fn(int rt) {
  return rt == 2   ? reinterpret_cast<const void*>(mlp_forward_kernel<2>)
         : rt == 4 ? reinterpret_cast<const void*>(mlp_forward_kernel<4>)
                   : reinterpret_cast<const void*>(mlp_forward_kernel<8>);
}

// mlp_forward_kernel's launch shape for B boards on the current device:
// plan = [RT, resident, shared bytes, CTAs].  For each RT of 2, 4, 8 (CTAs
// of 8 RT boards): the image whole in shared memory where it fits beside
// the activations, else one tower-layer of each tower at a time; then the
// RT whose CTAs need the fewest waves on the card (CTAs resident per SM by
// the occupancy API), the smallest RT among equals, since more CTAs of
// fewer boards hide more of each CTA's serial path.  The dynamic
// shared-memory limit of each instance is raised to its bytes here, and the
// last plan is kept, so a launch with the same shapes on the same device
// asks the runtime nothing more.
cudaError_t fwd_plan(const Mlp& m, int B, int* plan) {
  if (B < 1 || m.n_layers < 1 || m.n_layers > kFwdMaxLayers) return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static int last[10] = {-1};  // dev, F, H, A, n_layers, B, then the plan
  std::lock_guard<std::mutex> lock(mu);
  const int key[6] = {dev, m.F, m.H, m.A, m.n_layers, B};
  if (std::equal(key, key + 6, last)) {
    std::copy(last + 6, last + 10, plan);
    return cudaSuccess;
  }
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  int best_waves = 0;
  plan[0] = 0;
  for (int rt = 2; rt <= 8; rt *= 2) {
    const int act = fwd_act_floats(m, 8 * rt);
    const int whole = (agent_staged_floats(m) + act) * 4;  // the image and its barriers
    const int staged = (2 * fwd_stage_floats(m) + act) * 4;
    if (staged > kMaxSmem) break;
    const int bytes = whole <= kMaxSmem ? whole : staged;
    const void* fn = fwd_fn(rt);
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
        cudaSuccess)
      return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kFwdThreads, bytes)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) break;
    const int ctas = (B + 8 * rt - 1) / (8 * rt);
    const int waves = (ctas + per_sm * n_sm - 1) / (per_sm * n_sm);
    if (plan[0] == 0 || waves < best_waves) {
      best_waves = waves;
      plan[0] = rt;
      plan[1] = whole <= kMaxSmem;
      plan[2] = bytes;
      plan[3] = ctas;
    }
  }
  if (plan[0] == 0) return cudaErrorInvalidValue;
  // every instance's limit now stands at its own bytes, the chosen one's too
  std::copy(key, key + 6, last);
  std::copy(plan, plan + 4, last + 6);
  return cudaSuccess;
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

int hex_agent(const void* image, int F, int H, int A, int n_layers, int relu, const void* obs,
              const void* legal, const void* bits, unsigned long long seed, void* o_masked,
              void* o_logp, void* o_value, void* o_action, int B, void* stream) {
  AgentArgs a{static_cast<const float*>(image), Mlp{F, H, A, n_layers, relu},
              static_cast<const int8_t*>(obs),  static_cast<const uint8_t*>(legal),
              static_cast<const uint32_t*>(bits), seed,
              static_cast<float*>(o_masked),    static_cast<float*>(o_logp),
              static_cast<float*>(o_value),     static_cast<int*>(o_action),
              B,                                0,
              0};
  cudaError_t e = env_games_per_cta(B, &a.games_per_cta, kAgentMaxGames, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the image staged in shared memory where it fits beside the games' slices
  const int slices = a.games_per_cta * agent_game_floats(a.m);
  a.staged = (agent_staged_floats(a.m) + slices) * static_cast<int>(sizeof(float)) <= kMaxSmem;
  const int smem = ((a.staged ? agent_staged_floats(a.m) : 0) + slices) * static_cast<int>(sizeof(float));
  if ((e = allow_smem(reinterpret_cast<const void*>(agent_kernel), smem)) != cudaSuccess)
    return static_cast<int>(e);
  agent_kernel<<<(B + a.games_per_cta - 1) / a.games_per_cta, 32 * kAgentTeamWarps * a.games_per_cta,
                 smem, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

int hex_bank(const void* image, int F, int H, int A, int n_layers, int relu, int P1,
             const void* obs, const void* legal, const void* member, const void* use_best,
             const void* bits, unsigned long long seed, void* o_action, void* o_masked, int B,
             void* stream) {
  BankArgs a{static_cast<const float*>(image),    Mlp{F, H, A, n_layers, relu},
             P1,                                   static_cast<const int8_t*>(obs),
             static_cast<const uint8_t*>(legal),   static_cast<const int*>(member),
             static_cast<const uint8_t*>(use_best), static_cast<const uint32_t*>(bits),
             seed,                                 static_cast<int*>(o_action),
             static_cast<float*>(o_masked),        B,
             0};
  cudaError_t e = env_games_per_cta(B, &a.games_per_cta, kBankMaxGames);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = a.games_per_cta * bank_game_floats(a.m) * static_cast<int>(sizeof(float));
  if ((e = allow_smem(reinterpret_cast<const void*>(bank_kernel), smem)) != cudaSuccess)
    return static_cast<int>(e);
  bank_kernel<<<(B + a.games_per_cta - 1) / a.games_per_cta, 32 * kBankTeamWarps * a.games_per_cta,
                smem, static_cast<cudaStream_t>(stream)>>>(a);
  return finish_launch();
}

// Towers transposed and padded by tower_image_kernel into out, once per
// rollout: instances first .. first + count - 1 of (0 the agent's pi tower,
// 1 its vf tower, 2 + i bank member i) — K2's agent image (first 0, count 2,
// from agent) or K3's bank image (first 2, count P1, from bank)
int hex_tower_image(const void* agent, const void* bank, int F, int H, int A, int n_layers,
                    int first, int count, void* out, void* stream) {
  const Mlp m{F, H, A, n_layers, 0};
  const int blocks = (hex::ttower_size(m, A) + 255) / 256;
  tower_image_kernel<<<dim3(blocks, count), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(agent), static_cast<const float*>(bank), m, static_cast<float*>(out),
      first, 0);
  return finish_launch();
}

// The rollout's launch shape for one model, board and batch: plan =
// [games per CTA, agent in shared memory, members in shared memory, shared
// bytes].  The first of (agent and members in shared memory), (agent only),
// (neither) that fits one game, then the games per CTA (at most 8) that
// need the fewest waves of CTAs on the card, the fewest games among equals.
// bank_bf16 picks the bf16-bank instance.
int hex_rollout_plan(int F, int H, int A, int n_layers, int n, int L, int B, int bank_bf16,
                     int* plan) {
  const Mlp m{F, H, A, n_layers, 0};
  const Board g{n, n * n, L};
  // K4 is held against its twin on boards up to 11x11 only (L = 128), the
  // sizes of the preset grid; ops/rollout_kernel.py gates it the same way
  if (L > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int limit = 220 * 1024;
  const void* kernel = rollout_fn(bank_bf16);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
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
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kTeamWarps * gpc, bytes);
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
                int per_episode_seat, int eval_mode, int bank_bf16, int games_per_cta,
                int agent_in_smem, int member_in_smem, void* timers, void* opp_logits,
                void* stream) {
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
  a.o_opp_logits = static_cast<float*>(opp_logits);
  a.games_per_cta = games_per_cta;
  a.agent_in_smem = agent_in_smem;
  a.member_in_smem = member_in_smem;
  a.game_bytes = rollout_game_bytes(a.m, a.g, member_in_smem != 0);
  const int smem = (agent_in_smem ? (hex::ttower_size(a.m, A) + hex::ttower_size(a.m, 1)) * 4 : 0) +
                   games_per_cta * a.game_bytes;
  cudaError_t e = allow_smem(rollout_fn(bank_bf16), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int image_blocks = (hex::ttower_size(a.m, A) + 255) / 256;
  tower_image_kernel<<<dim3(image_blocks, 2 + P1), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(agent), static_cast<const float*>(bank), a.m, img, 0, bank_bf16);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + games_per_cta - 1) / games_per_cta), block(32 * kTeamWarps * games_per_cta);
  if (bank_bf16) {
    rollout_kernel<true><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    rollout_kernel<false><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  }
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

// The image of mlp_forward_kernel, from the module's parameters: params is
// a host array of 4 (n_layers + 1) device pointers, for the pi tower then
// the vf tower each layer's weight and bias, the head last; strides a host
// array of each layer's three element strides, the weight's two, then the
// bias's (a parameter need not be contiguous).
int hex_mlp_image(const void* const* params, const long long* strides, int F, int H, int A,
                  int n_layers, void* out, void* stream) {
  if (n_layers < 1 || n_layers > kFwdMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  ImageSrc s{};
  for (int t = 0; t < 2; ++t) {
    for (int l = 0; l <= n_layers; ++l) {
      const int i = t * (n_layers + 1) + l;
      s.w[t][l] = static_cast<const float*>(params[2 * i]);
      s.b[t][l] = static_cast<const float*>(params[2 * i + 1]);
      s.ws[t][l][0] = strides[3 * i];
      s.ws[t][l][1] = strides[3 * i + 1];
      s.bs[t][l] = strides[3 * i + 2];
    }
  }
  const Mlp m{F, H, A, n_layers, 0};
  const int blocks = (hex::ttower_size(m, A) + 255) / 256;
  mlp_image_kernel<<<dim3(blocks, 2), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, m, static_cast<float*>(out));
  return finish_launch();
}

int hex_mlp_forward(const void* image, int F, int H, int A, int n_layers, int relu, const void* x,
                    void* o_logits, void* o_value, int B, void* stream) {
  FwdArgs a{static_cast<const float*>(image), Mlp{F, H, A, n_layers, relu},
            static_cast<const float*>(x),     static_cast<float*>(o_logits),
            static_cast<float*>(o_value),     B,
            0};
  int plan[4];
  const cudaError_t e = fwd_plan(a.m, B, plan);  // raised each instance's shared-memory limit
  if (e != cudaSuccess) return static_cast<int>(e);
  a.resident = plan[1];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan[0] == 2) {
    mlp_forward_kernel<2><<<plan[3], kFwdThreads, plan[2], st>>>(a);
  } else if (plan[0] == 4) {
    mlp_forward_kernel<4><<<plan[3], kFwdThreads, plan[2], st>>>(a);
  } else {
    mlp_forward_kernel<8><<<plan[3], kFwdThreads, plan[2], st>>>(a);
  }
  return finish_launch();
}

// hex_mlp_forward's launch shape for B boards, for reports and tests: plan
// = [RT (8 RT boards a CTA), image whole in shared memory, shared bytes,
// CTAs].  Launches nothing.
int hex_mlp_forward_plan(int F, int H, int A, int n_layers, int B, int* plan) {
  return static_cast<int>(fwd_plan(Mlp{F, H, A, n_layers, 0}, B, plan));
}

}  // extern "C"
