// Skip-state (implicit-pause) lattice sweeps on Hopper: the pause-aware
// Viterbi and the forward-sum alpha and beta/posterior sweeps over
// T_s = 2*t_x + 1 states (even s: an optional shared pause; odd s: token
// (s-1)/2). Moves are stay, advance (from s-1) and skip (from s-2, only
// into odd s >= 3); paths start in {0, 1} and end in {ts-2, ts-1};
// enter_cost is added once per transition into a pause (an advance into
// an even state, and a start in state 0).
//
// H4, mas_skip_kernel, replaces the TPU kernels _viterbi_fwd_kernel and
// _viterbi_bwd_kernel via mas_skip_pallas and the start-state choice
// between them (aligner_tpu/ops/skip_dp_pallas.py), in one launch:
//
//   v[s,0]  = value[s,0] (+ enter_cost at s == 0) for s in {0, 1}
//   cand1   = fl(v[s-1,y-1] + enter_cost) on even s, v[s-1,y-1] on odd s
//   v[s,y]  = fl(max(v[s,y-1], cand1, v[s-2,y-1]) + value[s,y])
//   move    = 0, 1 or 2: a candidate replaces only if strictly greater,
//             advance against stay first, then skip against the better
//   walk:     s = ts-2, or ts-1 if v[ts-1,t_y-1] > v[ts-2,t_y-1];
//             for y = t_y-1..0: path[s,y] = 1; s -= move[s,y]
// Bit-identical to mas_skip_single (ops/skip_dp_reference.py): each add is
// one rounded float32 add in the reference's order, and x + 0.0f serves
// the cost-free form. A state never reads a higher state, so each item
// sweeps only its own ts states and t_y frames. Items outside
// 1 <= t_x <= t_y, or whose ts or t_y exceed the lattice, keep the
// zero-filled path.
//
// H5, forward_sum_skip_alpha_kernel, replaces _alpha_skip_kernel via
// forward_sum_skip_alpha_pallas (its per-frame body):
//
//   alpha[0,s] = lp[0,s] + (s == 0 ? enter_cost : s == 1 ? 0 : NEG)
//   alpha[y,s] = lp[y,s] + logaddexp(logaddexp(alpha[y-1,s], p1), p2)
//   p1 = alpha[y-1,s-1] (+ enter_cost on even s), NEG at s == 0
//   p2 = alpha[y-1,s-2] on odd s >= 3, else NEG
//   frames y >= t_y freeze the carry.
// It is the forward sweep of csrc/forward_sweep.cuh with these arms, two
// pad cells of NEG left of the column (both arms are selects) and the
// plan of the posterior sweeps.
//
// H6, forward_sum_skip_gamma_kernel, replaces _gamma_skip_kernel via
// forward_sum_skip_gamma_pallas: a reverse sweep over the message
// M[y] = lp[y] + beta[y] that emits the posterior
//
//   beta[y,s]  = y == t_y-1 ? (s in {ts-1, ts-2} ? 0 : NEG)
//              : logaddexp(logaddexp(M[y+1,s], m1), m2)
//   m1 = M[y+1,s+1] (+ enter_cost on odd s) where s+1 < ts, else NEG
//   m2 = M[y+1,s+2] on odd s with s+2 < ts, else NEG
//   gamma[y,s] = exp(alpha[y,s] + beta[y,s] - total) on live cells
//                (y < t_y, lp > NEG/2), exactly 0 elsewhere
// with M clamped to NEG at or below NEG/2 and frames y >= t_y passing the
// message through. The caller zeroes `total` for invalid items, so the
// exp cannot overflow. An item with t_x > t_y, t_y < 1, or neither end
// state inside the lattice has gamma 0 everywhere and runs no chain; one
// with t_x = 0 keeps its chain, since its pause-only path is a path of
// the lattice and the plain version gives it mass.
//
// logaddexp is jnp.logaddexp's form in precise expf/log1pf; the file is
// built without --use_fast_math and has no multiply to contract.
//
// What bounds them on this card: like the plain-lattice sweeps, a chain
// of t_y dependent column steps per item (a shared-memory exchange with
// the s-1, s-2 or s+1, s+2 neighbours and one __syncthreads each; H4 adds
// a single-thread walk over the moves), i.e. latency, plus one pass over
// the lattices. One block per item runs the items in parallel; the column
// is double-buffered in shared memory, so a step takes one barrier.
// Lattices are read and written through strides, so the model's
// frame-major lattice is read in place.
//
// H4 keeps on the chain only what the next frame needs:
// * Moves as two bit planes. Each warp turns its cells' decisions into
//   two 32-bit masks with __ballot_sync (advance taken; skip taken), and
//   one lane stores both words for the frame. The planes live in shared
//   memory where they fit beside the columns and the ring (8 bytes a
//   frame per 32 states: 73.7 KB at 257 states x 1024 frames), else in a
//   device-memory scratch [B, T_y, 2 * words], 16x fewer bytes than one
//   move byte a cell; the wrapper's plan (ops/skip_dp_kernel.py:
//   _skip_viterbi_plan, from the shape and strides, before the launch)
//   says which. The walk then reads, four frames a round, the two words
//   the state can be in, and takes each step with a shift and a subtract.
// * Values fetched ahead by cp.async into a ring in shared memory, so no
//   device-memory latency sits on the chain. Where the frames are strided
//   (the pause model's frame-major view), each thread copies its own
//   cells of frame y + RING - 1, one coalesced row a warp. Where they are
//   contiguous (serving's state-major lattice), a row would cost each
//   warp 32 lines of one float, and the load/store unit those lines take
//   is the one the chain's shared-memory traffic needs; there each warp
//   copies tiles of 8 frames x 4 states (32-byte runs) two tiles ahead,
//   and every thread waits for them before a barrier 8 frames early.
// * A frame step of one basic block: frame 0 peeled, two pad cells of
//   -inf left of each column (no `if` for s < 2), the skip's and the
//   cost's per-state rules as selects, copies predicated, columns and
//   ring rows padded to threads x CELLS cells (cells at or past ts compute
//   on what shared memory holds; no state reads a higher one).
// * Only the item's frames: the chain stops at t_y, and invalid items
//   return before it.
// H5 is the sweep of csrc/forward_sweep.cuh (two nested logaddexp where H2
// has one) and H6 that of csrc/posterior_sweep.cuh (likewise against H3);
// each header says how its design keeps the loads (lp rows fetched ahead),
// the posterior and the frames past t_y off the chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "forward_sweep.cuh"
#include "posterior_sweep.cuh"

namespace {

// Shared memory of H4 whose threads hold `pitch` cells: the move planes
// of `plane_frames` frames (0 when they live in device memory), RING value
// rows of pitch + 4 floats and two columns behind two pad cells each.
inline size_t skip_viterbi_smem(int pitch, int ring, int plane_frames) {
  return static_cast<size_t>(plane_frames) * (pitch / 32) * sizeof(uint2) +
         (static_cast<size_t>(ring) * (pitch + 4) + 2 * (pitch + 2)) *
             sizeof(float);
}

constexpr int TILE = 8;  // frames of a tile: 8 frames x 4 states a warp

template <int CELLS, int RING, bool SHARED_PLANES, bool TILES>
__global__ void __launch_bounds__(1024) mas_skip_kernel(
    const float* __restrict__ value, long long sv_b, long long sv_s,
    long long sv_y, const int* __restrict__ t_x, const int* __restrict__ t_y,
    uint2* __restrict__ scratch, float* __restrict__ path, long long sp_b,
    long long sp_s, long long sp_y, int T_s, int T_y, float max_neg_val,
    float enter_cost) {
  static_assert((RING & (RING - 1)) == 0 && RING >= 2, "a power of 2");
  static_assert(!TILES || RING >= 3 * TILE, "tiles fetched 2 tiles ahead");
  extern __shared__ uint2 smem_planes[];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  if (tx < 1 || tx > ty || ty > T_y || tx > (T_s - 1) / 2) return;
  const int ts = 2 * tx + 1;

  const int P = blockDim.x * CELLS;  // the pitch of a column
  const int Q = P + 4;               // the pitch of a ring row
  const int W = P / 32;              // plane words a frame
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  // Frame y's moves at cell c: bit c % 32 of planes[y * W + c / 32], .x
  // for an advance and .y for a skip.
  uint2* const planes = SHARED_PLANES
                            ? smem_planes
                            : scratch + static_cast<long long>(b) * T_y * W;
  float* const ring = reinterpret_cast<float*>(
      smem_planes + (SHARED_PLANES ? static_cast<size_t>(T_y) * W : 0));
  float* prev = ring + RING * Q + 2;  // v[., y - 1], -inf at -2 and -1
  float* cur = prev + P + 2;

  int cell[CELLS];
  float cost[CELLS];   // the advance's cost: enter_cost into a pause
  bool skips[CELLS];   // a skip lands on odd s >= 3 only
  int tile_s[CELLS];   // tiles: this lane's state in sub-tile 0
  const float* v_at[CELLS];  // this lane's next value to copy
  const int tile_f = lane % TILE;  // tiles: this lane's frame in a tile
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    cell[k] = threadIdx.x + k * blockDim.x;
    cost[k] = (cell[k] & 1) ? 0.f : enter_cost;
    skips[k] = (cell[k] & 1) && cell[k] >= 3;
    tile_s[k] = 32 * (threadIdx.x / 32 + k * warps) + lane / TILE;
    v_at[k] = value + b * sv_b +
              (TILES ? tile_s[k] * sv_s + tile_f * sv_y : cell[k] * sv_s);
  }
  // The copies started at frame y's step, one commit group, none past
  // frame t_y - 1 or state ts - 1. Rows: each thread its own cells of
  // frame y + RING - 1. Tiles: each warp sub-tile y % TILE of the tile of
  // frames two tiles ahead, lane l at state 4 * (y % TILE) + l / TILE of
  // its 32 and frame l % TILE of the tile, so a warp reads 4 runs of TILE
  // contiguous frames where a row would read 32 lines. The source moves
  // by 4 states a sub-tile and to the next tile's frames after the last.
  const long long next_sub = 4 * sv_s;
  const long long next_tile = TILE * sv_y - (32 - 4) * sv_s;
  auto fetch = [&](int y) {
    if (TILES) {
      const int j = y & (TILE - 1);
      const int f = ((y >> 3) + 2) * TILE + tile_f;
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int s = tile_s[k] + 4 * j;
        float* const dst = ring + (f & (RING - 1)) * Q + s;
        if (f < ty && s < ts) cp_async4(dst, v_at[k]);
        v_at[k] += j == TILE - 1 ? next_tile : next_sub;
      }
    } else {
      const int f = y + RING - 1;
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        if (f < ty && cell[k] < ts)
          cp_async4(ring + (f & (RING - 1)) * Q + cell[k], v_at[k]);
        v_at[k] += sv_y;
      }
    }
    cp_async_commit();
  };
  for (int y = TILES ? -2 * TILE : 1 - RING; y < 0; ++y) fetch(y);
  if (cell[0] < 2) {
    prev[cell[0] - 2] = -INFINITY;
    cur[cell[0] - 2] = -INFINITY;
  }
  // Tiles: every thread's copies of frames 0..2*TILE-1 have landed, and
  // the barrier shows them to all. Rows: this thread's frame 0.
  cp_async_wait<TILES ? 0 : RING - 2>();
  if (TILES) __syncthreads();
  const float* row = ring;  // frame y's ring row
  auto next_frame = [&](int y) {
    fetch(y);
    row = ring + ((y + 1) & (RING - 1)) * Q;
    float* const t = prev;
    prev = cur;
    cur = t;
    // Frame y + 1 has landed: rows, this thread's copy; tiles, every
    // copy started at step y - TILE or before, shown by the barrier.
    cp_async_wait<TILES ? TILE : RING - 2>();
    __syncthreads();
  };

  // Frame 0: only the start states {0, 1} are live, and no move is made.
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int c = cell[k];
    cur[c] = c == 0 ? row[c] + enter_cost : (c == 1 ? row[c] : max_neg_val);
  }
  next_frame(0);
  for (int y = 1; y < ty; ++y) {
    uint2* const moves = planes + static_cast<long long>(y) * W;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int c = cell[k];
      const float stay = prev[c];
      const float adv = prev[c - 1] + cost[k];
      const float skip = skips[k] ? prev[c - 2] : -INFINITY;
      const bool take1 = adv > stay;
      const float best1 = take1 ? adv : stay;
      const bool take2 = skip > best1;
      cur[c] = (take2 ? skip : best1) + row[c];
      const unsigned adv_bits = __ballot_sync(~0u, take1 && !take2);
      const unsigned skip_bits = __ballot_sync(~0u, take2);
      if (lane == 0)
        moves[threadIdx.x / 32 + k * warps] = make_uint2(adv_bits, skip_bits);
    }
    next_frame(y);
  }

  if (threadIdx.x != 0) return;
  // The last token unless the trailing pause is strictly better.
  int s = prev[ts - 1] > prev[ts - 2] ? ts - 1 : ts - 2;
  float* p = path + b * sp_b;
  auto move = [&](uint2 m) {
    return ((m.x >> (s & 31)) & 1u) + 2 * ((m.y >> (s & 31)) & 1u);
  };
  int y = ty - 1;
  // Four frames a round: s falls by at most 2 a frame, so their moves lie
  // in word s / 32 or the one below; both are read before the four steps.
  for (; y >= 4; y -= 4) {
    const int w = s >> 5;
    uint2 hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2* row = planes + static_cast<long long>(y - j) * W;
      hi[j] = row[w];
      lo[j] = row[w > 0 ? w - 1 : 0];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[s * sp_s + (y - j) * sp_y] = 1.f;
      s -= move((s >> 5) == w ? hi[j] : lo[j]);
    }
  }
  for (; y > 0; --y) {
    p[s * sp_s + y * sp_y] = 1.f;
    s -= move(planes[static_cast<long long>(y) * W + (s >> 5)]);
  }
  p[s * sp_s] = 1.f;
}

template <int CELLS, int RING>
__global__ void __launch_bounds__(1024) forward_sum_skip_alpha_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_s, const int* __restrict__ t_y, float* __restrict__ alphas,
    float* __restrict__ final_col, int B, int T_s, int T_y,
    float enter_cost) {
  const int b = blockIdx.x;
  const ForwardLattices item{lp + b * sl_b,
                             sl_y,
                             sl_s,
                             alphas + static_cast<long long>(b) * T_s,
                             static_cast<long long>(B) * T_s,
                             1,
                             final_col + static_cast<long long>(b) * T_s};
  // Two pad cells of NEG left of the column: the arms read s - 1 and s - 2
  // and select NEG where the rule has no arm.
  forward_sweep<CELLS, RING, 2>(
      item, T_s, T_y, t_y[b],
      [=](int s) { return s == 0 ? enter_cost : (s == 1 ? 0.f : NEG); },
      [=](const float* prev, int s) {
        const float adv = prev[s - 1];
        const float p1 = (s & 1) ? adv : (s == 0 ? NEG : adv + enter_cost);
        const float p2 = ((s & 1) && s >= 3) ? prev[s - 2] : NEG;
        return logaddexp(logaddexp(prev[s], p1), p2);
      });
}

template <int CELLS, int RING>
__global__ void __launch_bounds__(1024) forward_sum_skip_gamma_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_s, const float* __restrict__ alphas, long long sa_y,
    long long sa_b, long long sa_s, const float* __restrict__ total,
    const int* __restrict__ t_x, const int* __restrict__ t_y,
    float* __restrict__ gamma, long long sg_y, long long sg_b,
    long long sg_s, int T_s, int T_y, float enter_cost) {
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const long long ts = 2LL * tx + 1;
  const int ty = t_y[b];
  const ItemLattices item{lp + b * sl_b,     sl_y, sl_s,
                          alphas + b * sa_b, sa_y, sa_s,
                          gamma + b * sg_b,  sg_y, sg_s};
  const bool chain = ty >= 1 && tx >= 0 && tx <= ty && ts - 2 < T_s;
  posterior_sweep<CELLS, RING>(
      item, T_s, T_y, ty, chain, total[b],
      [=](const float* nxt, int s, bool end) {
        if (end) return (s == ts - 1 || s == ts - 2) ? 0.f : NEG;
        float m1 = NEG;
        float m2 = NEG;
        // s + 1 < ts keeps the arc inside the item; s + 1 < T_s keeps the
        // read inside the shared column when ts exceeds it.
        if (s + 1 < ts && s + 1 < T_s) {
          m1 = nxt[s + 1];
          if (s & 1) m1 += enter_cost;
        }
        if ((s & 1) && s + 2 < ts && s + 2 < T_s) m2 = nxt[s + 2];
        return logaddexp(logaddexp(nxt[s], m1), m2);
      });
}

template <int C, int R, bool S, bool T>
struct SkipPlan {
  static constexpr int cells = C;
  static constexpr int ring = R;
  static constexpr bool shared = S;
  static constexpr bool tiles = T;
};

// f(SkipPlan<cells, ring, shared, tiles>{}) for the plans of
// ops/skip_dp_kernel.py: SKIP_VITERBI_PLANS; any other is refused.
template <class F>
cudaError_t with_skip_plan(int cells, int ring, bool shared, bool tiles,
                           F f) {
  if (cells == 1 && ring == 32 && shared && tiles)
    return f(SkipPlan<1, 32, true, true>{});
  if (cells == 1 && ring == 32 && !shared && tiles)
    return f(SkipPlan<1, 32, false, true>{});
  if (cells == 1 && ring == 8 && shared && !tiles)
    return f(SkipPlan<1, 8, true, false>{});
  if (cells == 1 && ring == 4 && shared && !tiles)
    return f(SkipPlan<1, 4, true, false>{});
  if (cells == 1 && ring == 8 && !shared && !tiles)
    return f(SkipPlan<1, 8, false, false>{});
  if (cells == 2 && ring == 8 && shared && !tiles)
    return f(SkipPlan<2, 8, true, false>{});
  if (cells == 2 && ring == 4 && shared && !tiles)
    return f(SkipPlan<2, 4, true, false>{});
  if (cells == 2 && ring == 8 && !shared && !tiles)
    return f(SkipPlan<2, 8, false, false>{});
  if (cells == 4 && ring == 8 && shared && !tiles)
    return f(SkipPlan<4, 8, true, false>{});
  if (cells == 4 && ring == 4 && shared && !tiles)
    return f(SkipPlan<4, 4, true, false>{});
  if (cells == 4 && ring == 8 && !shared && !tiles)
    return f(SkipPlan<4, 8, false, false>{});
  if (cells == 8 && ring == 4 && shared && !tiles)
    return f(SkipPlan<8, 4, true, false>{});
  if (cells == 8 && ring == 4 && !shared && !tiles)
    return f(SkipPlan<8, 4, false, false>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// value: f32 lattice read as [B, T_s, T_y] through element strides sv_*;
// t_x, t_y: int32 [B]; scratch: int32 [B, T_y, threads * cells / 16], the
// move planes when they do not live in shared memory (else unused); path:
// f32, zero-filled, written through strides sp_*; threads, cells, ring,
// shared_planes, tiles: the wrapper's plan. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a plan that was not built.
extern "C" int mas_skip_launch(const float* value, long long sv_b,
                               long long sv_s, long long sv_y,
                               const int* t_x, const int* t_y, void* scratch,
                               float* path, long long sp_b, long long sp_s,
                               long long sp_y, int B, int T_s, int T_y,
                               int threads, int cells, int ring,
                               int shared_planes, int tiles,
                               float max_neg_val, float enter_cost,
                               void* stream) {
  return static_cast<int>(with_skip_plan(
      cells, ring, shared_planes != 0, tiles != 0, [&](auto plan) {
        using P = decltype(plan);
        return launch_sweep(
            mas_skip_kernel<P::cells, P::ring, P::shared, P::tiles>, B,
            threads, cells, T_s,
            skip_viterbi_smem(threads * cells, P::ring, P::shared ? T_y : 0),
            stream, value, sv_b, sv_s, sv_y, t_x, t_y,
            static_cast<uint2*>(scratch), path, sp_b, sp_s, sp_y, T_s, T_y,
            max_neg_val, enter_cost);
      }));
}

// lp: f32 lattice read as [T_y, B, T_s] through element strides sl_*
// (already masked with NEG at s >= 2*t_x+1); t_y: int32 [B]; alphas: f32
// [T_y, B, T_s] contiguous, written whole; final_col: f32 [B, T_s]
// contiguous; threads, cells, ring: the wrapper's plan. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// that was not built.
extern "C" int forward_sum_skip_alpha_launch(
    const float* lp, long long sl_y, long long sl_b, long long sl_s,
    const int* t_y, float* alphas, float* final_col, int B, int T_s, int T_y,
    int threads, int cells, int ring, float enter_cost, void* stream) {
  return static_cast<int>(with_plan(cells, ring, [&](auto plan) {
    using P = decltype(plan);
    return launch_sweep(forward_sum_skip_alpha_kernel<P::cells, P::ring>, B,
                        threads, cells, T_s,
                        forward_smem(threads * cells, P::ring, 2), stream, lp,
                        sl_y, sl_b, sl_s, t_y, alphas, final_col, B, T_s, T_y,
                        enter_cost);
  }));
}

// lp, alphas: f32 lattices read as [T_y, B, T_s] through element strides
// (lp already masked with NEG at s >= 2*t_x+1); total: f32 [B], 0 for
// invalid items; t_x, t_y: int32 [B]; gamma: f32 written as [T_y, B, T_s]
// through element strides sg_*; threads, cells, ring: the wrapper's plan.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a plan that was not built.
extern "C" int forward_sum_skip_gamma_launch(
    const float* lp, long long sl_y, long long sl_b, long long sl_s,
    const float* alphas, long long sa_y, long long sa_b, long long sa_s,
    const float* total, const int* t_x, const int* t_y, float* gamma,
    long long sg_y, long long sg_b, long long sg_s, int B, int T_s, int T_y,
    int threads, int cells, int ring, float enter_cost, void* stream) {
  return static_cast<int>(with_plan(cells, ring, [&](auto plan) {
    using P = decltype(plan);
    return launch_sweep(forward_sum_skip_gamma_kernel<P::cells, P::ring>, B,
                        threads, cells, T_s,
                        sweep_smem(threads * cells, P::ring), stream, lp,
                        sl_y, sl_b, sl_s, alphas, sa_y, sa_b, sa_s, total,
                        t_x, t_y, gamma, sg_y, sg_b, sg_s, T_s, T_y,
                        enter_cost);
  }));
}
