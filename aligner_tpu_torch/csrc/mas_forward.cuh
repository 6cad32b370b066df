// The MAS forward sweep that H1 (csrc/mas.cu) and H13
// (csrc/mas_two_pass.cu) share: a group of whole warps sweeps one item's
// frames y = 0..t_y - 1 over
//
//   cum[x,y] = max(v_cur, v_prev) + value[x,y]
//   v_cur    = cum[x,y-1], or max_neg_val when x == y
//   v_prev   = cum[x-1,y-1]; at x == 0: 0 when y == 0, else max_neg_val
//   bit[x,y] = (x > 0) & ((x == y) | (cum[x,y-1] < cum[x-1,y-1]))
//
// and keeps the decision bits as a ballot plane: each warp turns its cells'
// bits into one 32-bit word a frame with __ballot_sync and one lane stores
// it, bit x % 32 of word x / 32 of the frame's W = pitch / 32 words. H1
// runs one group a block (its barrier __syncthreads); H13 runs K groups a
// block, one item each, each behind its own named barrier, so that a
// group runs to its own t_y and waits for no other.
//
// The step is one basic block: frame 0 peeled, a pad cell of max_neg_val
// left of each column (the x == 0 arm), the x == y arm a select, columns
// padded to threads x CELLS cells. Values are fetched ahead by cp.async
// into a ring in shared memory: rows (each thread its own cells of frame
// y + RING - 1) where the tokens are contiguous, tiles of 8 frames x 4
// tokens a warp instruction where the frames are (a row would touch 32
// lines a warp). Bit-identity with the reference rests on `fmaxf` then one
// rounded f32 add (the exactness lemma of aligner_tpu/ops/mas_pallas.py):
// the files are built without --use_fast_math and have no multiply to
// contract.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int TILE = 8;  // frames of a tile: 8 frames x 4 tokens a warp
enum Fetch { FETCH_ROWS = 0, FETCH_TILES = 1, FETCH_WIDE = 2 };

// Shared memory of one group whose threads hold `pitch` cells: the plane
// of `plane_frames` frames (0 when it lives in device memory), RING value
// rows of pitch + 4 floats and two columns behind a pad cell each.
__host__ __device__ inline size_t forward_smem(int pitch, int ring,
                                               int plane_frames) {
  return static_cast<size_t>(plane_frames) * (pitch / 32) * sizeof(unsigned) +
         (static_cast<size_t>(ring) * (pitch + 4) + 2 * (pitch + 1)) *
             sizeof(float);
}

// 32-bit words of an item's device-memory scratch: the plane, then H1's
// walk's tokens as int16.
__host__ __device__ inline long long item_words(int T_y, int W) {
  return static_cast<long long>(T_y) * W + (T_y + 1) / 2;
}

template <bool SHARED, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (SHARED)
    return *p;
  else
    return __ldcg(p);  // device memory: from L2, where this launch wrote it
}

// The threads that sweep one item, their index in the group, its size and
// its barrier: the whole block (H1), or `threads` threads (whole warps)
// from thread `first` behind named barrier `id` (H13's chains).
struct BlockGroup {
  __device__ unsigned tid() const { return threadIdx.x; }
  __device__ unsigned size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};
struct ChainGroup {
  int id;
  unsigned first, threads;
  __device__ unsigned tid() const { return threadIdx.x - first; }
  __device__ unsigned size() const { return threads; }
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
  }
};

// The forward sweep of one valid item (1 <= tx <= ty, both within the
// lattice) by the group `g`: frame y's bits into planes[y * W + ...]. v:
// the item's values, read through element strides; ring: RING rows of
// pitch + 4 floats; cols: two columns of pitch + 1 floats. Every thread of
// the group calls it.
template <int CELLS, int RING, bool TILES, class Group>
__device__ __forceinline__ void mas_forward(const float* v, long long sv_x,
                                            long long sv_y, int tx, int ty,
                                            unsigned* planes, float* ring,
                                            float* cols, float max_neg_val,
                                            Group g) {
  static_assert((RING & (RING - 1)) == 0 && RING >= 2, "a power of 2");
  static_assert(!TILES || RING >= 3 * TILE, "tiles fetched 2 tiles ahead");
  const int P = g.size() * CELLS;  // the pitch of a column
  const int Q = P + 4;            // the pitch of a ring row
  const int W = P / 32;           // plane words a frame
  const int warps = g.size() / 32;
  const int lane = g.tid() % 32;
  float* prev = cols + 1;  // cum[., y - 1], a pad cell at -1
  float* cur = prev + P + 1;

  int cell[CELLS];
  bool pos[CELLS];     // x > 0: the only cells that can step
  int tile_x[CELLS];   // tiles: this lane's token in sub-tile 0
  const float* v_at[CELLS];  // this lane's next value to copy
  const int tile_f = lane % TILE;  // tiles: this lane's frame in a tile
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    cell[k] = g.tid() + k * g.size();
    pos[k] = cell[k] > 0;
    tile_x[k] = 32 * (g.tid() / 32 + k * warps) + lane / TILE;
    v_at[k] = v + (TILES ? tile_x[k] * sv_x + tile_f * sv_y : cell[k] * sv_x);
  }
  // The copies started at frame y's step, one commit group, none past
  // frame t_y - 1 or token t_x - 1; as H4's (csrc/skip_dp.cu). Rows: each
  // thread its own cells of frame y + RING - 1. Tiles: each warp sub-tile
  // y % TILE of the tile of frames two tiles ahead, lane l at token
  // 4 * (y % TILE) + l / TILE of its 32 and frame l % TILE.
  const long long next_sub = 4 * sv_x;
  const long long next_tile = TILE * sv_y - (32 - 4) * sv_x;
  auto fetch = [&](int y) {
    if (TILES) {
      const int j = y & (TILE - 1);
      const int f = ((y >> 3) + 2) * TILE + tile_f;
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        const int x = tile_x[k] + 4 * j;
        float* const dst = ring + (f & (RING - 1)) * Q + x;
        if (f < ty && x < tx) cp_async4(dst, v_at[k]);
        v_at[k] += j == TILE - 1 ? next_tile : next_sub;
      }
    } else {
      const int f = y + RING - 1;
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        if (f < ty && cell[k] < tx)
          cp_async4(ring + (f & (RING - 1)) * Q + cell[k], v_at[k]);
        v_at[k] += sv_y;
      }
    }
    cp_async_commit();
  };
  for (int y = TILES ? -2 * TILE : 1 - RING; y < 0; ++y) fetch(y);
  if (g.tid() == 0) {  // the x == 0 arm after frame 0
    prev[-1] = max_neg_val;
    cur[-1] = max_neg_val;
  }
  // Tiles: every thread's copies of frames 0..2*TILE-1 have landed, and
  // the barrier shows them to all. Rows: this thread's frame 0.
  cp_async_wait<TILES ? 0 : RING - 2>();
  if (TILES) g.sync();
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
    g.sync();
  };

  // Frame 0: the column before it is 0 and no cell steps.
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    const int c = cell[k];
    cur[c] = fmaxf(c == 0 ? max_neg_val : 0.f, 0.f) + row[c];
    if (lane == 0) planes[g.tid() / 32 + k * warps] = 0u;
  }
  next_frame(0);
  for (int y = 1; y < ty; ++y) {
    unsigned* const words = planes + static_cast<long long>(y) * W;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const int c = cell[k];
      const float p = prev[c];
      const float ps = prev[c - 1];
      const bool diag = c == y;
      cur[c] = fmaxf(diag ? max_neg_val : p, ps) + row[c];
      const unsigned word = __ballot_sync(~0u, pos[k] && (diag || p < ps));
      if (lane == 0) words[g.tid() / 32 + k * warps] = word;
    }
    next_frame(y);
  }
}

// Bits 0..3 of b to bytes 0..3 (the products b << 7j do not overlap).
__device__ __forceinline__ unsigned bytes4(unsigned b) {
  return (b * 0x00204081u) & 0x01010101u;
}

// Every byte of the item's bits [T_y, T_x] by the group `grp`: the plane's
// bit on the band of a valid item, else 0; sixteen bytes a store where T_x
// allows it (the band a mask of the word's 16 bits), else four or one.
// top: the frames that emit (t_y, or 0 for an invalid item).
template <bool SHARED, class Group>
__device__ void write_bits(const unsigned* planes, int W, int tx, int top,
                           int ty, uint8_t* bits, int T_x, int T_y,
                           Group grp) {
  auto bit = [&](int y, int x, unsigned word) -> unsigned {
    const bool band = x < tx && x <= y && x >= tx - (ty - y);
    return band ? (word >> (x & 31)) & 1u : 0u;
  };
  if (T_x % 16 == 0) {
    const int groups = T_x / 16;
    for (int g = grp.tid(); g < T_y * groups; g += grp.size()) {
      const int y = g / groups;
      const int x = 16 * (g - y * groups);
      // The band's cells x + lo .. x + hi of these 16.
      const int lo = max(tx - (ty - y) - x, 0);
      const int hi = min(min(tx - 1, y) - x, 15);
      unsigned m = 0;
      if (y < top && lo <= hi) {
        const unsigned word = load<SHARED>(
            planes + static_cast<long long>(y) * W + (x >> 5));
        m = (word >> (x & 31)) & ((2u << hi) - (1u << lo));
      }
      reinterpret_cast<uint4*>(bits)[g] =
          make_uint4(bytes4(m & 15u), bytes4((m >> 4) & 15u),
                     bytes4((m >> 8) & 15u), bytes4(m >> 12));
    }
  } else if (T_x % 4 == 0) {
    const int groups = T_x / 4;
    for (int g = grp.tid(); g < T_y * groups; g += grp.size()) {
      const int y = g / groups;
      const int x = 4 * (g - y * groups);
      unsigned out = 0;
      if (y < top) {
        const unsigned word = load<SHARED>(
            planes + static_cast<long long>(y) * W + (x >> 5));
#pragma unroll
        for (int j = 0; j < 4; ++j) out |= bit(y, x + j, word) << (8 * j);
      }
      reinterpret_cast<unsigned*>(bits)[g] = out;
    }
  } else {
    for (int g = grp.tid(); g < T_y * T_x; g += grp.size()) {
      const int y = g / T_x;
      const int x = g - y * T_x;
      bits[g] = y < top ? bit(y, x, load<SHARED>(
                                        planes + static_cast<long long>(y) *
                                                     W + (x >> 5)))
                        : 0;
    }
  }
}

template <int C, int R, bool S, bool T>
struct MasPlan {
  static constexpr int cells = C;
  static constexpr int ring = R;
  static constexpr bool shared = S;
  static constexpr bool tiles = T;
};

// f(MasPlan<cells, ring, shared, tiles>{}) for the plans of
// ops/mas_kernel.py: MAS_PLANS, which H1 and H13 both take; any other is
// refused.
template <class F>
cudaError_t with_mas_plan(int cells, int ring, bool shared, bool tiles,
                          F f) {
  if (cells == 1 && ring == 32 && shared && tiles)
    return f(MasPlan<1, 32, true, true>{});
  if (cells == 1 && ring == 32 && !shared && tiles)
    return f(MasPlan<1, 32, false, true>{});
  if (cells == 1 && ring == 8 && shared && !tiles)
    return f(MasPlan<1, 8, true, false>{});
  if (cells == 1 && ring == 4 && shared && !tiles)
    return f(MasPlan<1, 4, true, false>{});
  if (cells == 1 && ring == 8 && !shared && !tiles)
    return f(MasPlan<1, 8, false, false>{});
  if (cells == 2 && ring == 8 && shared && !tiles)
    return f(MasPlan<2, 8, true, false>{});
  if (cells == 2 && ring == 4 && shared && !tiles)
    return f(MasPlan<2, 4, true, false>{});
  if (cells == 2 && ring == 8 && !shared && !tiles)
    return f(MasPlan<2, 8, false, false>{});
  if (cells == 4 && ring == 8 && shared && !tiles)
    return f(MasPlan<4, 8, true, false>{});
  if (cells == 4 && ring == 4 && shared && !tiles)
    return f(MasPlan<4, 4, true, false>{});
  if (cells == 4 && ring == 8 && !shared && !tiles)
    return f(MasPlan<4, 8, false, false>{});
  if (cells == 8 && ring == 4 && shared && !tiles)
    return f(MasPlan<8, 4, true, false>{});
  if (cells == 8 && ring == 4 && !shared && !tiles)
    return f(MasPlan<8, 4, false, false>{});
  return cudaErrorInvalidValue;
}

}  // namespace
