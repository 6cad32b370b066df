// The walk that H10 (mas_walk_stage_kernel), H14 (mas_walk_chains_kernel)
// and H11 (mas_walk_idx_kernel) share, in csrc/mas_two_pass.cu: a group of
// whole warps walks one item from its uint8 decision bits [T_y, T_x] and
// writes every frame of its output. H10 and H11 run one group a block
// (BlockGroup), H14 K groups a block, one item each (ChainGroup), as H1
// and H13 share csrc/mas_forward.cuh. What the storers write is the
// walk's store policy: the path's [T_x, F] tile of each chunk (TileStore:
// H10, H14) or the item's int32 index row (IdxStore: H11).
//
// Frames are taken in chunks of F, from the chunk that holds frame t_y - 1
// down to frame 0; within an item chunk k's bytes are the contiguous range
// [y0 * T_x, (y0 + F) * T_x). Three roles, each a warp or more, hand the
// chunks over through mbarriers in shared memory, S stages deep:
//  - the producer warp fetches chunk k into byte stage k % S as soon as
//    the walker has released chunk k - S: one cp.async.bulk issued by one
//    thread where the item's base, the chunk's offset and its size are
//    16-byte multiples ("bulk"), else 4-byte cp.async by every lane where
//    T_x % 4 == 0 ("async"), else byte loads ("bytes");
//  - lane 0 of the walker warp follows the bits from shared memory. The
//    index falls by at most one a frame, so frames y..y-3 can only read
//    bytes index-3..index of their rows: two aligned 4-byte words a frame,
//    all eight read before the four steps (H1's walk reads plane words the
//    same way, csrc/mas.cu). A round never crosses a chunk, so it never
//    reads a stage it has not waited for. Each frame's token (int16) goes
//    into token stage k % S;
//  - the storer warps, one chunk behind the walker, write the chunk's
//    frames through the store policy: the path's tile whole, zeros
//    included, four floats a store along the axis of stride 1; or the
//    index row, four frames a store where the address allows. They first
//    write the chunks at or past t_y, which need neither bytes nor a walk.
// An invalid item (outside 1 <= t_x <= t_y, or lengths beyond the lattice)
// loads no bytes and gets zeros; frames >= t_y are 0. A step goes down a
// token where the bit is set: any non-zero byte counts as set and token 0
// never steps, so bits that did not come from the forward kernels cannot
// take the walk out of the lattice.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "mas_forward.cuh"

namespace {

enum WalkFetch { WALK_BULK = 0, WALK_ASYNC = 1, WALK_BYTES = 2 };

// (frames a chunk F, stages S) of ops/mas_kernel.py: WALK_PLANS, in its
// order; the launch refuses any other.
struct WalkPlan {
  int frames, stages;
};
constexpr WalkPlan kWalkPlans[] = {{128, 4}, {64, 4}, {32, 4}, {16, 4},
                                   {8, 4},   {4, 4},  {2, 4},  {1, 4},
                                   {1, 2},   {1, 1}};

inline bool walk_plan_built(int frames, int stages) {
  for (const WalkPlan& p : kWalkPlans)
    if (p.frames == frames && p.stages == stages) return true;
  return false;
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}
// Bytes of one byte stage, and of one group's shared memory: 4 S
// mbarriers, S byte stages, S token stages of F int16.
__host__ __device__ inline size_t walk_stage_bytes(int T_x, int frames) {
  return round16(static_cast<size_t>(frames) * T_x);
}
__host__ __device__ inline size_t walk_smem(int T_x, int frames,
                                            int stages) {
  return 32 * static_cast<size_t>(stages) +
         stages * walk_stage_bytes(T_x, frames) +
         round16(2 * static_cast<size_t>(stages) * frames);
}

__device__ __forceinline__ unsigned walk_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void walk_bar_init(uint64_t* bar, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   walk_smem_addr(bar)),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void walk_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   walk_smem_addr(bar))
               : "memory");
}
// Wait until the phase of `bar` with parity `phase` has completed.
__device__ __forceinline__ void walk_bar_wait(uint64_t* bar,
                                              unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WALK_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WALK_WAIT;\n"
      "}\n" ::"r"(walk_smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// body(c, o0, step) for every column group c < groups of `outer` rows,
// thread t of n: each thread keeps one group and strides the rows where
// there are at least as many threads as groups, else strides the groups.
template <class Body>
__device__ __forceinline__ void walk_spread(int groups, int t, int n,
                                            Body body) {
  if (groups <= n) {
    const int per = n / groups;
    if (t < per * groups) body(t % groups, t / groups, per);
  } else {
    for (int c = t; c < groups; c += n) body(c, 0, 1);
  }
}

// Every cell of frames [y0, y0 + nf) of the item's path p: 1 where x is
// the frame's token, which tok(r) gives for frame y0 + r (-1: none).
// Thread t of n; four floats a store along the axis of stride 1 where the
// strides and the pointer allow it, each thread reading its tokens once,
// streamed past the caches (the path is not read back here).
template <class Tok>
__device__ __forceinline__ void walk_store_tile(float* p, long long sp_x,
                                                long long sp_y, int T_x,
                                                int y0, int nf, Tok tok,
                                                int t, int n) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  if (sp_y == 1 && aligned && sp_x % 4 == 0 && y0 % 4 == 0 && nf % 4 == 0) {
    // Frames along a store: a thread keeps four frames' tokens and goes
    // down the token rows.
    walk_spread(nf / 4, t, n, [&](int c, int x0, int dx) {
      const int r = 4 * c;
      const int k0 = tok(r), k1 = tok(r + 1), k2 = tok(r + 2),
                k3 = tok(r + 3);
      float* q = p + x0 * sp_x + y0 + r;
      for (int x = x0; x < T_x; x += dx, q += dx * sp_x)
        __stcs(reinterpret_cast<float4*>(q),
               make_float4(k0 == x ? 1.f : 0.f, k1 == x ? 1.f : 0.f,
                           k2 == x ? 1.f : 0.f, k3 == x ? 1.f : 0.f));
    });
  } else if (sp_x == 1 && aligned && sp_y % 4 == 0 && T_x % 4 == 0) {
    // Tokens along a store: a thread keeps four tokens and goes down the
    // frames.
    walk_spread(T_x / 4, t, n, [&](int c, int r0, int dr) {
      const int i = 4 * c;
      for (int r = r0; r < nf; r += dr) {
        const int k = tok(r);
        __stcs(reinterpret_cast<float4*>(p + (y0 + r) * sp_y + i),
               make_float4(i == k ? 1.f : 0.f, i + 1 == k ? 1.f : 0.f,
                           i + 2 == k ? 1.f : 0.f, i + 3 == k ? 1.f : 0.f));
      }
    });
  } else if (sp_y == 1) {
    for (int g = t; g < T_x * nf; g += n) {
      const int x = g / nf;
      const int r = g - x * nf;
      p[x * sp_x + y0 + r] = tok(r) == x ? 1.f : 0.f;
    }
  } else {
    for (int g = t; g < nf * T_x; g += n) {
      const int r = g / T_x;
      const int x = g - r * T_x;
      p[x * sp_x + (y0 + r) * sp_y] = tok(r) == x ? 1.f : 0.f;
    }
  }
}

// Frames [y0, y0 + nf) of the item's index row: token + 1 as int32, 0
// where tok(r) gives -1 (no token). Thread t of n; one frame a store up to
// the first 16-byte aligned frame, then four frames a store (streamed
// past the caches), then one a store for the frames left over.
template <class Tok>
__device__ __forceinline__ void walk_store_idx(int* row, int y0, int nf,
                                               Tok tok, int t, int n) {
  int* const q = row + y0;
  const int head =
      min(nf, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(q) & 15)) &
                               15) / 4);
  const int quads = (nf - head) / 4;
  for (int c = t; c < quads; c += n) {
    const int r = head + 4 * c;
    __stcs(reinterpret_cast<int4*>(q + r),
           make_int4(tok(r) + 1, tok(r + 1) + 1, tok(r + 2) + 1,
                     tok(r + 3) + 1));
  }
  for (int r = t; r < head; r += n) q[r] = tok(r) + 1;
  for (int r = head + 4 * quads + t; r < nf; r += n) q[r] = tok(r) + 1;
}

// The store policies of ring_walk: store(y0, nf, tok, t, n) writes frames
// [y0, y0 + nf) as thread t of n storers, tok(r) giving frame y0 + r's
// token or -1.
struct TileStore {  // the path, read through strides sp_x, sp_y
  float* p;
  long long sp_x, sp_y;
  int T_x;
  template <class Tok>
  __device__ __forceinline__ void operator()(int y0, int nf, Tok tok, int t,
                                             int n) const {
    walk_store_tile(p, sp_x, sp_y, T_x, y0, nf, tok, t, n);
  }
};
struct IdxStore {  // the item's int32 [T_y] index row
  int* row;
  template <class Tok>
  __device__ __forceinline__ void operator()(int y0, int nf, Tok tok, int t,
                                             int n) const {
    walk_store_idx(row, y0, nf, tok, t, n);
  }
};

// One step of the walk from the stage's word holding byte offset o.
__device__ __forceinline__ int walk_step(unsigned word, int o, int index) {
  const unsigned byte = __byte_perm(word, 0u, 0x4440u | (o & 3));  // 0-extended
  return index - ((byte != 0u && index > 0) ? 1 : 0);
}

// The walk of item `bits` (its [T_y, T_x] bytes) with lengths tx, ty
// (valid: 1 <= tx <= ty, both within the lattice) by the group g, its
// frames written through the store policy `store`. smem: the group's
// walk_smem(T_x, F, S) bytes, 16-byte aligned. rot: the group's index in
// the block, which rotates its roles over the SM's four schedulers. Every
// thread of the group calls it; the group has at least three warps.
template <class Group, class Store>
__device__ void ring_walk(const uint8_t* bits, int tx, int ty, bool valid,
                          int T_x, int T_y, int F, int S, int fetch,
                          unsigned char* smem, int rot, Group g,
                          Store store) {
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + S;
  uint64_t* const tfull = empty + S;
  uint64_t* const tempty = tfull + S;
  unsigned char* const stages = smem + 32 * S;
  const size_t stage_bytes = walk_stage_bytes(T_x, F);
  short* const tokens =
      reinterpret_cast<short*>(stages + S * stage_bytes);
  const int warps = g.size() / 32;
  const int lane = g.tid() % 32;
  const int role = (static_cast<int>(g.tid() / 32) + warps - rot % warps) %
                   warps;  // 0 walker, 1 producer, 2.. storers
  const int storers = g.size() - 64;
  const int n = valid ? (ty + F - 1) / F : 0;  // the chunks walked
  if (g.tid() == 0) {
    for (int s = 0; s < S; ++s) {
      walk_bar_init(&full[s], fetch == WALK_BULK ? 1 : 32);
      walk_bar_init(&empty[s], 1);
      walk_bar_init(&tfull[s], 1);
      walk_bar_init(&tempty[s], storers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  g.sync();

  if (role == 1) {
    if (fetch == WALK_BULK && lane != 0) return;
    for (int k = 0; k < n; ++k) {
      const int s = k % S;
      const unsigned phase = (k / S) & 1;
      const int y0 = (n - 1 - k) * F;
      unsigned char* const dst = stages + s * stage_bytes;
      const uint8_t* const src = bits + static_cast<long long>(y0) * T_x;
      if (fetch == WALK_BULK) {
        if (k >= S) walk_bar_wait(&empty[s], phase ^ 1u);
        // To the lattice's end, so that the size stays a 16-byte multiple.
        const unsigned bytes =
            static_cast<unsigned>(min(F, T_y - y0)) * T_x;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                walk_smem_addr(&full[s])),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(walk_smem_addr(dst)),
            "l"(src), "r"(bytes), "r"(walk_smem_addr(&full[s]))
            : "memory");
        continue;
      }
      if (k >= S) walk_bar_wait(&empty[s], phase ^ 1u);
      const int bytes = min(F, ty - y0) * T_x;  // frames below t_y only
      if (fetch == WALK_ASYNC) {
        for (int q = 4 * lane; q < bytes; q += 4 * 32) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           walk_smem_addr(dst + q)),
                       "l"(src + q)
                       : "memory");
        }
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                walk_smem_addr(&full[s]))
            : "memory");
      } else {
#pragma unroll 8
        for (int q = lane; q < bytes; q += 32) dst[q] = src[q];
        walk_bar_arrive(&full[s]);
      }
    }
  } else if (role == 0) {
    if (lane != 0) return;
    int index = tx - 1;
    for (int k = 0; k < n; ++k) {
      const int s = k % S;
      const unsigned phase = (k / S) & 1;
      const int y0 = (n - 1 - k) * F;
      const unsigned* const st = reinterpret_cast<const unsigned*>(
          stages + s * stage_bytes);
      short* const tk = tokens + s * F;
      if (k >= S) walk_bar_wait(&tempty[s], phase ^ 1u);
      walk_bar_wait(&full[s], phase);
      int r = min(F, ty - y0) - 1;  // the chunk's top frame, from y0
      // Four frames a round, their eight words read before the steps.
      // Frame r - j's byte lies at offset d = c[j] + index, 1 <= d <= 7, of
      // the eight bytes (lo, hi), which one byte permute with d in every
      // selector nibble picks; the next frame's selector is ready for
      // either outcome, so a step is a permute, a compare and a select.
      for (; r >= 3; r -= 4) {
        unsigned hi[4], lo[4], c4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = (r - j) * T_x;
          const int w = (row + index) >> 2;
          hi[j] = st[w];
          lo[j] = st[w > 0 ? w - 1 : 0];
          c4[j] = static_cast<unsigned>(row - 4 * (w - 1)) * 0x1111u;
        }
        unsigned x4 = static_cast<unsigned>(index) * 0x1111u;
        unsigned sel = c4[0] + x4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tk[r - j] = static_cast<short>(index);
          const bool down = __byte_perm(lo[j], hi[j], sel) != 0u && index > 0;
          index -= down ? 1 : 0;
          if (j < 3) {
            const unsigned stay = c4[j + 1] + x4;
            sel = down ? stay - 0x1111u : stay;
            x4 -= down ? 0x1111u : 0u;
          }
        }
      }
      for (; r >= 0; --r) {
        const int o = r * T_x + index;
        tk[r] = static_cast<short>(index);
        index = walk_step(st[o >> 2], o, index);
      }
      walk_bar_arrive(&empty[s]);
      walk_bar_arrive(&tfull[s]);
    }
  } else {
    const int st_id = 32 * (role - 2) + lane;  // this thread among storers
    // The chunks at or past t_y (every chunk of an invalid item): zeros.
    const int chunks = (T_y + F - 1) / F;
    for (int c = n; c < chunks; ++c)
      store(c * F, min(F, T_y - c * F), [](int) { return -1; }, st_id,
            storers);
    for (int k = 0; k < n; ++k) {
      const int s = k % S;
      const unsigned phase = (k / S) & 1;
      const int y0 = (n - 1 - k) * F;
      const short* const tk = tokens + s * F;
      const int live = min(F, ty - y0);
      walk_bar_wait(&tfull[s], phase);
      store(y0, min(F, T_y - y0),
            [&](int r) { return r < live ? int(tk[r]) : -1; }, st_id,
            storers);
      walk_bar_arrive(&tempty[s]);
    }
  }
}

}  // namespace
