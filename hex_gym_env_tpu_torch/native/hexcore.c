/* hexcore — native scalar Hex engine (variant-B semantics).
 *
 * The reference has no native code at all (SURVEY.md §2.9); this is the
 * framework's host-side runtime component: a C implementation of the exact
 * environment contract (world-frame board, mover-frame actions/observations,
 * flat-label connectivity with edge virtuals, mover-only win check, the
 * invalid-move and full-board-draw quirks of minihex/HexSingleGame.py).
 * Used for: fast interactive/GUI play without a device round trip, scalar
 * oracles in tests, and host-side batch playouts.  Exposed through ctypes
 * (see native/__init__.py) — no pybind11 dependency.
 *
 * Winner codes match hex_gym_env_tpu_torch.core.state.Winner:
 *   -1 ongoing, 0 seat0, 1 seat1, 2 draw, 3 invalid-move termination.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_N 32

typedef struct {
    int n;            /* board side */
    int cells;        /* n*n */
    int8_t board[MAX_N * MAX_N];        /* world frame: -1 seat0, +1 seat1 */
    int32_t labels[MAX_N * MAX_N + 4];  /* flat labels + 4 edge virtuals */
    int to_move;
    int done;
    int winner;       /* -1/0/1/2/3 */
    int empty;
} HexGame;

static const int DY[6] = {-1, -1, 0, 0, 1, 1};
static const int DX[6] = {0, 1, -1, 1, -1, 0};

/* ---------------------------------------------------------------------- */

HexGame *hex_new(int n) {
    if (n < 2 || n > MAX_N) return NULL;
    HexGame *g = (HexGame *)malloc(sizeof(HexGame));
    g->n = n;
    g->cells = n * n;
    return g;
}

void hex_free(HexGame *g) { free(g); }

void hex_reset(HexGame *g) {
    memset(g->board, 0, sizeof(int8_t) * g->cells);
    for (int i = 0; i < g->cells + 4; i++) g->labels[i] = i;
    g->to_move = 0;
    g->done = 0;
    g->winner = -1;
    g->empty = g->cells;
}

/* relabel every node carrying `from` to `to` */
static void merge_label(HexGame *g, int32_t from, int32_t to) {
    if (from == to) return;
    int total = g->cells + 4;
    for (int i = 0; i < total; i++)
        if (g->labels[i] == from) g->labels[i] = to;
}

/* union the stone at world cell c (seat s) with same-seat neighbors and the
 * seat's edge virtuals; returns 1 when the seat's edges end up connected */
static int place_and_union(HexGame *g, int s, int c) {
    int n = g->n;
    int y = c / n, x = c % n;
    int8_t stone = (s == 0) ? -1 : 1;
    int e0 = g->cells + 2 * s, e1 = e0 + 1;
    int32_t label_e0 = g->labels[e0], label_e1 = g->labels[e1];
    int pre_connected = (label_e0 == label_e1);

    for (int k = 0; k < 6; k++) {
        int ny = y + DY[k], nx = x + DX[k];
        if (ny < 0 || ny >= n || nx < 0 || nx >= n) continue;
        int nc = ny * n + nx;
        if (g->board[nc] == stone) merge_label(g, g->labels[nc], (int32_t)c);
    }
    /* seat 0 connects rows, seat 1 connects columns (world frame) */
    int on_e0 = (s == 0) ? (y == 0) : (x == 0);
    int on_e1 = (s == 0) ? (y == n - 1) : (x == n - 1);
    if (on_e0) merge_label(g, g->labels[e0], (int32_t)c);
    if (on_e1) merge_label(g, g->labels[e1], (int32_t)c);
    /* the new stone keeps label c (it was an empty singleton) */
    if (pre_connected) return 1;
    return g->labels[e0] == g->labels[e1];
}

/* Apply a MOVER-FRAME action.  Writes the 2-vector reward (indexed by seat)
 * into reward[2]; returns the done flag. */
int hex_step(HexGame *g, int action, float *reward) {
    reward[0] = 0.0f;
    reward[1] = 0.0f;
    if (g->done || action < 0 || action >= g->cells) return g->done;
    int n = g->n, s = g->to_move;
    int ym = action / n, xm = action % n;
    int yw = (s == 0) ? ym : xm;
    int xw = (s == 0) ? xm : ym;
    int c = yw * n + xw;

    if (g->board[c] != 0) {          /* invalid move terminates, reward 0 */
        g->done = 1;
        g->winner = 3;
        g->to_move = 1 - s;          /* the env still flips (HexSingleGame.py:259) */
        return 1;
    }
    g->board[c] = (s == 0) ? -1 : 1;
    g->empty -= 1;
    int win = place_and_union(g, s, c);
    if (win) {
        g->done = 1;
        g->winner = s;
        reward[s] = 1.0f;
        reward[1 - s] = -1.0f;
    } else if (g->empty <= 0) {
        g->done = 1;
        g->winner = 2;               /* draw: board full, no connection */
    }
    g->to_move = 1 - s;
    return g->done;
}

/* mover-frame observation: mover stones -1, opponent +1 */
void hex_observe(HexGame *g, int8_t *out) {
    int n = g->n;
    if (g->to_move == 0) {
        memcpy(out, g->board, sizeof(int8_t) * g->cells);
    } else {
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++)
                out[y * n + x] = (int8_t)(-g->board[x * n + y]);
    }
}

/* mover-frame legal mask */
void hex_legal(HexGame *g, uint8_t *out) {
    int n = g->n;
    if (g->to_move == 0) {
        for (int i = 0; i < g->cells; i++) out[i] = g->board[i] == 0;
    } else {
        for (int y = 0; y < n; y++)
            for (int x = 0; x < n; x++)
                out[y * n + x] = g->board[x * n + y] == 0;
    }
}

void hex_world_board(HexGame *g, int8_t *out) {
    memcpy(out, g->board, sizeof(int8_t) * g->cells);
}

/* Load a world-frame board (replay construction, sampled starts). */
void hex_set_board(HexGame *g, const int8_t *board) {
    hex_reset(g);
    memcpy(g->board, board, sizeof(int8_t) * g->cells);
    g->empty = 0;
    for (int c = 0; c < g->cells; c++) {
        if (g->board[c] == 0) { g->empty += 1; continue; }
        int s = (g->board[c] == 1);
        place_and_union(g, s, c);    /* win ignored during replay, like the
                                        reference's construction loop */
    }
}

int hex_to_move(HexGame *g) { return g->to_move; }
int hex_done(HexGame *g) { return g->done; }
int hex_winner(HexGame *g) { return g->winner; }
int hex_empty(HexGame *g) { return g->empty; }

/* xorshift PRNG for the batch helper */
static uint64_t xs_next(uint64_t *st) {
    uint64_t x = *st;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    *st = x;
    return x;
}

/* Play `games` random-legal games to completion; returns winners (codes as
 * above) and total moves.  Host-side throughput baseline + soak test. */
long hex_random_playouts(int n, int games, uint64_t seed, int *winners) {
    HexGame *g = hex_new(n);
    long moves = 0;
    uint64_t st = seed ? seed : 0x9E3779B97F4A7C15ull;
    uint8_t legal[MAX_N * MAX_N];
    int choices[MAX_N * MAX_N];
    float reward[2];
    for (int i = 0; i < games; i++) {
        hex_reset(g);
        while (!g->done) {
            hex_legal(g, legal);
            int m = 0;
            for (int a = 0; a < g->cells; a++)
                if (legal[a]) choices[m++] = a;
            int a = choices[xs_next(&st) % (uint64_t)m];
            hex_step(g, a, reward);
            moves++;
        }
        winners[i] = g->winner;
    }
    hex_free(g);
    return moves;
}
