// MoBo boundary-search token sweeps on Hopper: the forward boundary
// recursion (soft and hard) and the backward recursion under the
// max-duration window D. All three read the token-major grid e [T_x, B, T_y1]
// through element strides (T_y1 = T_y + 1, position 0 = the virtual frame
// -1; position 0 and frames >= t_y already hold NEG, as
// ops/mobo.py:_prep_energies leaves them) and sweep over tokens, not frames.
//
// H7, mobo_alpha_kernel, replaces the TPU kernel _alpha_kernel via
// mobo_alpha_pallas (aligner_tpu/ops/mobo_pallas.py):
//
//   z_i(q)    = LSE_{d=1..D} e_i(q+d)
//   a_i(q)    = z_i(q) > NEG/2 ? logB_{i-1}(q) - z_i(q) : NEG
//   logB_i(p) = e_i(p) + LSE_{d=1..D} a_i(p-d), NEG where <= NEG/2
//   logB_{-1} = 0 at p == 0, NEG elsewhere; tokens i >= t_x repeat the
//   carry, so the last row is each item's row of token t_x - 1.
//
// H8, mobo_bp_kernel, replaces _bp_kernel via mobo_bp_pallas: the same
// recursion with max in place of the inner LSE, emitting the d that won
// (a later d replaces only if strictly greater; 0 on tokens >= t_x), and
// then, in the same launch, the walk over its own backpointers that the
// JAX package runs as a scan outside its kernel:
//
//   pos = t_y; for i = T_x-1..0: dur[i] = i < t_x ? bp_i(pos) : 0;
//   pos -= dur[i]   (pos clamped into the grid, which only an item with
//   no boundary sequence needs).
//
// H9, mobo_beta_kernel, replaces _beta_kernel via mobo_beta_pallas:
//
//   c(p)      = (e_{i+1}(p) > NEG/2 ? e_{i+1}(p) : NEG) + beta_{i+1}(p)
//   beta_i(p) = z_{i+1}(p) > NEG/2 ? LSE_{d=1..D} c(p+d) - z_{i+1}(p) : NEG
//   beta_{t_x-1} = 0 at p == t_y, NEG elsewhere; tokens i >= t_x hold NEG.
//
// LSE is the reference's accumulation (ops/mobo.py:_window_lse): the max
// over d ascending, then the sum of expf(x_d - max) over d ascending, then
// max + logf(sum), in precise expf/logf; window cells outside the grid
// count as NEG and are not skipped, so a dead window sums D terms like the
// reference. The file is built without --use_fast_math and has no multiply
// to contract. Every live cell's window is computed whole by one thread, so
// the kernels agree with the plain versions to the last bit.
//
// What bounds them on this card: not bytes (8 per cell) but the special
// function unit and the chain. Per cell H7 and H9 take 2*D expf and two
// logf, at 16 per clock per SM; and each item is a chain of t_x dependent
// token steps whose windows couple neighbouring positions. One thread
// computes a window in about 400 dependent instructions, so a token step
// is a latency, and the design of H7 and H9 takes everything else off it:
//
// * z off the chain. z depends on e alone, so before the token loop every
//   block computes it for its own positions and every live token: rows of
//   e staged in shared memory, four windows per thread at once. z stays in
//   shared memory when T_x rows of the block's slice fit there, else in
//   the output rows, which the chain reads before it overwrites them. A
//   token step is then one window per cell.
// * A cluster of C blocks per item (C <= 8, from the wrapper's plan). Block
//   r owns positions [r*w, r*w + w) and keeps them in its threads for the
//   whole sweep; w >= D, so the D-cell halo of the exchanged row comes
//   from one neighbour. H7 pushes its last D cells of a_i to the right and
//   H9 its first D cells of c to the left: asynchronous stores into the
//   neighbour's shared memory (st.async) that complete on the
//   neighbour's mbarrier, armed with the bytes it expects.
//   A token step has one block barrier; only the cells that read the halo
//   wait for it, and a pushed row is written again two tokens later, after
//   the neighbour has said it read it (a second mbarrier). No barrier over
//   the cluster and no memory fence sits on the chain: on the H100 a
//   cluster barrier, or a release at cluster scope, costs about as much as
//   a token's window (python -m aligner_tpu_torch.probe_barriers). At
//   B = 16 and C = 8 the sweeps run on 128 SMs instead of 16.
// * Rows fetched ahead: each thread starts the cp.async of its own cells
//   of the next token's e row (and z row, where z is in the output) before
//   the current token's barrier, so no device-memory load sits on the
//   chain.
// * No tail: a block has ceil(w/k/32)*32 chain threads, k = ceil(w/1024),
//   each with k cells at most; up to three more groups of as many threads
//   join the z prologue and only pass the block barriers afterwards.
//
// H8 keeps its first design: one block per item, threads striding over the
// T_y1 positions, shifted rows in shared memory with D cells of NEG on
// either side, z inside the token loop and two barriers per token.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e15f;
constexpr float DEAD = 0.5f * NEG;
constexpr int MAX_CLUSTER = 8;        // the portable cluster size
constexpr int PROLOGUE_GROUPS = 4;    // thread groups that compute z
constexpr size_t MAX_SMEM = 232448;   // a block's opt-in shared memory

// LSE over row[q+1 .. q+D].
__device__ __forceinline__ float window_lse_fwd(const float* row, int q,
                                                int D) {
  float m = row[q + 1];
  for (int d = 2; d <= D; ++d) m = fmaxf(m, row[q + d]);
  float s = 0.f;
  for (int d = 1; d <= D; ++d) s += expf(row[q + d] - m);
  return m + logf(s);
}

// LSE over first[0], first[step], .., first[(D-1)*step], d ascending, with
// the loops unrolled so that a thread's loads are in flight together: the
// window of one cell of H7 (step -1) or H9 (step +1) on the chain.
__device__ __forceinline__ float window_lse_chain(const float* first,
                                                  int step, int D) {
  float m = first[0];
#pragma unroll 8
  for (int d = 1; d < D; ++d) m = fmaxf(m, first[d * step]);
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s += expf(first[d * step] - m);
  return m + logf(s);
}

// window_lse_fwd over four rows at once, rows[k][q+1 .. q+D] for k < 4:
// four independent chains whose latencies overlap, each in the reference's
// order.
__device__ __forceinline__ void window_lse_fwd4(const float* row, int pitch,
                                                int q, int D, float* z) {
  float m[4], s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = row[k * pitch + q + 1];
    s[k] = 0.f;
  }
#pragma unroll 4
  for (int d = 2; d <= D; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], row[k * pitch + q + d]);
#pragma unroll 4
  for (int d = 1; d <= D; ++d)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += expf(row[k * pitch + q + d] - m[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) z[k] = m[k] + logf(s[k]);
}

// `count` floats of shared memory set to NEG.
__device__ __forceinline__ void fill_rows(float* rows, int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) rows[k] = NEG;
}

// The hard forward recursion of H8: max/argmax and the backpointers.
__device__ __forceinline__ void bp_sweep(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, int tx, int* __restrict__ bp, int B, int T_x, int n,
    int D, float* smem) {
  const int b = blockIdx.x;
  const int width = n + 2 * D;
  float* e_row = smem + D;              // e_i, read at q+1..q+D
  float* a_row = smem + width + D;      // a_i, read at p-1..p-D
  float* prev = smem + 2 * width;       // logB_{i-1}, each thread its own p
  fill_rows(smem, 2 * width);
  for (int p = threadIdx.x; p < n; p += blockDim.x) prev[p] = p ? NEG : 0.f;
  __syncthreads();

  const int live = tx < T_x ? (tx > 0 ? tx : 0) : T_x;
  const float* eb = e + b * se_b;
  for (int i = 0; i < live; ++i) {
    const long long out = (static_cast<long long>(i) * B + b) * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
      e_row[p] = eb[i * se_x + p * se_p];
    __syncthreads();
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const float z = window_lse_fwd(e_row, q, D);
      a_row[q] = z > DEAD ? prev[q] - z : NEG;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float inner = a_row[p - 1];
      int arg = 1;
      for (int d = 2; d <= D; ++d) {
        const float c = a_row[p - d];
        if (c > inner) {
          inner = c;
          arg = d;
        }
      }
      bp[out + p] = arg;
      float v = e_row[p] + inner;
      if (!(v > DEAD)) v = NEG;
      prev[p] = v;
    }
    // The next token's e_row is written only after every thread has left
    // the pass that reads it shifted, and its a_row after the barrier that
    // follows the e_row load.
  }
  // Tokens >= t_x point nowhere.
  for (int i = live; i < T_x; ++i) {
    const long long out = (static_cast<long long>(i) * B + b) * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x) bp[out + p] = 0;
  }
}

__global__ void __launch_bounds__(1024) mobo_bp_kernel(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, const int* __restrict__ t_x, const int* __restrict__ t_y,
    int* __restrict__ bp, int* __restrict__ durs, int B, int T_x, int n,
    int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  bp_sweep(e, se_x, se_b, se_p, tx, bp, B, T_x, n, D, smem);
  __syncthreads();                       // this block's bp rows are written
  if (threadIdx.x != 0) return;
  int pos = t_y[b];
  for (int i = T_x - 1; i >= 0; --i) {
    pos = pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
    const int d =
        i < tx ? bp[(static_cast<long long>(i) * B + b) * n + pos] : 0;
    durs[static_cast<long long>(b) * T_x + i] = d;
    pos -= d;
  }
}

// ---- H7 and H9: a cluster of blocks per item ----

// Cells per chain thread, and chain threads, of a block that owns w
// positions: at most 1024 threads, each with the same count of cells but
// for the last warp's lanes.
__host__ __device__ inline int cells_per_thread(int w) {
  return (w + 1023) / 1024;
}
__host__ __device__ inline int chain_threads(int w) {
  const int k = cells_per_thread(w);
  return ((w + k - 1) / k + 31) / 32 * 32;
}
inline int sweep_threads(int w) {
  const int tc = chain_threads(w);
  const int groups = 1024 / tc < PROLOGUE_GROUPS ? 1024 / tc
                                                 : PROLOGUE_GROUPS;
  return tc * (groups > 1 ? groups : 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(count)
               : "memory");
}
// This block's shared address `local` in the cluster's block `rank`.
__device__ __forceinline__ unsigned cluster_address(const void* local,
                                                    int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_address(local)), "r"(rank));
  return remote;
}
// Arrive on the barrier at `bar` in the cluster's block `rank`.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar,
                                            int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_address(bar, rank))
               : "memory");
}
// Arrive on this block's `bar`, which then also waits for `bytes` of
// asynchronous stores.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_address(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of this block's `bar` with parity `phase` has
// completed, and see what its arrivals and stores brought.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(phase)
      : "memory");
}

// The halo exchange between neighbouring blocks, one token t at a time,
// with no barrier over the cluster and no fence: block `to` receives this
// block's D cells of the exchanged row of parity t & 1 (its halo) as
// asynchronous stores that complete on its full[t & 1]; block `from`
// writes this block's halo. full[p] completes when the halo's bytes have
// landed and this block has armed it (one arrival per phase); empty[p]
// when `to` has read what this block wrote there (one arrival), so that
// the parity can be written again two tokens later.
struct Halo {
  unsigned long long* full;
  unsigned long long* empty;
  int to, from;    // cluster ranks, -1 for none
  unsigned bytes;  // of the halo that `from` writes per token

  // Store v into cell `local` of block `to`'s row of token t.
  __device__ void push(const float* local, int t, float v) const {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];\n" ::"r"(cluster_address(local, to)),
        "r"(__float_as_uint(v)), "r"(cluster_address(&full[t & 1], to))
        : "memory");
  }
  // Before a cell is pushed at token t: `to` has read token t - 2's.
  __device__ void wait_empty(int t) const {
    if (t >= 2) mbar_wait(&empty[t & 1], ((t >> 1) & 1) ^ 1);
  }
  // After the block's barrier of token t every thread has read token
  // t - 1's halo: arm its parity for token t + 1 and tell `from`.
  __device__ void release(int t) const {
    if (from >= 0 && t >= 1 && threadIdx.x == 0) {
      mbar_expect(&full[(t & 1) ^ 1], bytes);
      mbar_arrive(&empty[(t & 1) ^ 1], from);
    }
  }
  // Before a cell reads the halo of token t.
  __device__ void wait_full(int t) const {
    mbar_wait(&full[t & 1], (t >> 1) & 1);
  }
};

// Barriers of the halo exchange, initialised and armed for tokens 0 and 1
// by thread 0; every block of the cluster has to pass a cluster barrier
// before they are used.
__device__ __forceinline__ Halo make_halo(unsigned long long* bars, int to,
                                          int from, int cells) {
  const unsigned bytes = static_cast<unsigned>(cells) * sizeof(float);
  if (threadIdx.x == 0) {
    for (int p = 0; p < 4; ++p) mbar_init(&bars[p], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (from >= 0)
      for (int p = 0; p < 2; ++p) mbar_expect(&bars[p], bytes);
  }
  return Halo{bars, bars + 2, to, from, bytes};
}

// One block's view of its item: its slice of positions, its shared rows
// and its cells. Shared memory, in floats: two exchanged rows of w + D
// (cells and halo), the carried row (w), two e rows fetched ahead (2*w),
// the z prologue's stage (4 rows of w + D per group of chain threads), and
// z: T_x rows of w, or two rows fetched ahead from the output.
struct Slice {
  int b, rank, start, wb, tc, c0, w, xw;
  float* smem;
  float* carry;    // logB_{i-1} (H7) or beta_{i+1} (H9), own cells
  float* stage;    // rows of e staged for the z prologue
  float* z;        // z rows
  bool z_shared;

  __device__ Slice(float* sm, int C, int w_, int n, int D, bool zs)
      : w(w_), xw(w_ + D), smem(sm), z_shared(zs) {
    b = blockIdx.x / C;
    rank = static_cast<int>(cg::this_cluster().block_rank());
    start = rank * w;
    wb = n - start < w ? n - start : w;
    tc = chain_threads(w);
    c0 = static_cast<int>(threadIdx.x) < tc ? static_cast<int>(threadIdx.x)
                                            : wb;
    carry = smem + 2 * xw;
    stage = carry + 3 * w;
    z = stage + 4 * (blockDim.x / tc) * xw;
  }
  // The exchanged row of parity par (cells and halo).
  __device__ float* x(int par) const { return smem + par * xw; }
  // Own cells of the token's e row, by parity.
  __device__ float* e(int par) const { return carry + (1 + par) * w; }
};

// z of slot i (the window over grid row i + shift; a row past the grid is
// NEG) for every own position and slot < rows; into shared memory, or into
// output row i, which the chain reads before it overwrites it. In passes of
// 4 * groups slots: the block stages their rows of e over its slice and D
// more positions (NEG past the grid) in `stage`, then each group of chain
// threads takes four slots.
__device__ __forceinline__ void z_prologue(const Slice& s, const float* eb,
                                           long long se_x, long long se_p,
                                           int rows, int shift, int T_x,
                                           int n, int D, int w, float* out,
                                           long long row_stride) {
  const int pitch = w + D;
  const int groups = blockDim.x / s.tc;
  const int group = threadIdx.x / s.tc;
  const int lane = threadIdx.x - group * s.tc;
  for (int i0 = 0; i0 < rows; i0 += 4 * groups) {
    for (int k = threadIdx.x; k < 4 * groups * pitch; k += blockDim.x) {
      const int r = k / pitch;
      const int q = k - r * pitch;
      const int row = i0 + r + shift;
      s.stage[k] = row < T_x && s.start + q < n
                     ? eb[row * se_x + (s.start + q) * se_p]
                     : NEG;
    }
    __syncthreads();
    const int i = i0 + 4 * group;
    for (int c = lane; c < s.wb; c += s.tc) {
      float z[4];
      window_lse_fwd4(s.stage + 4 * group * pitch, pitch, c, D, z);
      for (int k = 0; k < 4 && i + k < rows; ++k) {
        if (s.z_shared)
          s.z[(i + k) * w + c] = z[k];
        else
          out[(i + k) * row_stride + c] = z[k];
      }
    }
    __syncthreads();                     // before the stage is refilled
  }
}

// Start copying own cells of grid row `row` of e (NEG past the grid) and,
// with z in the output, of z slot `slot` into buffer `par`; one commit
// group per call, empty or not.
__device__ __forceinline__ void fetch_ahead(const Slice& s, const float* eb,
                                            long long se_x, long long se_p,
                                            int row, int T_x, const float* out,
                                            long long row_stride, int slot,
                                            int par, int w) {
  for (int c = s.c0; c < s.wb; c += s.tc) {
    if (row < T_x)
      cp_async4(s.e(par) + c, eb + row * se_x + (s.start + c) * se_p);
    else
      s.e(par)[c] = NEG;
    if (!s.z_shared)
      cp_async4(s.z + par * w + c, out + slot * row_stride + c);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(1024) mobo_alpha_kernel(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, const int* __restrict__ t_x, float* __restrict__ logB,
    int B, int T_x, int n, int D, int C, int w, int z_shared) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Slice s(smem, C, w, n, D, z_shared != 0);
  const int tx = t_x[s.b];
  const int live = tx < T_x ? (tx > 0 ? tx : 0) : T_x;
  const long long row_stride = static_cast<long long>(B) * n;
  float* out = logB + static_cast<long long>(s.b) * n + s.start;
  const float* eb = e + s.b * se_b;

  __shared__ unsigned long long bars[4];
  // Pushed to the right: the last D cells of a_i; read from the left.
  const Halo halo = make_halo(bars, s.rank + 1 < C ? s.rank + 1 : -1,
                              s.rank - 1, D);
  fill_rows(smem, 2 * (w + D));          // block 0's halo stays NEG
  for (int c = s.c0; c < s.wb; c += s.tc)
    s.carry[c] = s.start + c ? NEG : 0.f;
  z_prologue(s, eb, se_x, se_p, live, 0, T_x, n, D, w, out, row_stride);
  cluster.sync();                        // z written, every block running

  const bool reads_halo = halo.from >= 0 && s.c0 < D;
  if (live > 0)
    fetch_ahead(s, eb, se_x, se_p, 0, T_x, out, row_stride, 0, 0, w);
  for (int i = 0; i < live; ++i) {
    const int par = i & 1;
    cp_async_wait_all();                 // token i's cells have landed
    const float* z = s.z_shared ? s.z + i * w : s.z + par * w;
    float* a = s.x(par) + D;
    for (int c = s.c0; c < s.wb; c += s.tc) {
      const float zc = z[c];
      const float ac = zc > DEAD ? s.carry[c] - zc : NEG;
      a[c] = ac;
      if (halo.to >= 0 && c >= w - D) {
        if (c - s.tc < w - D) halo.wait_empty(i);   // first pushed cell
        halo.push(s.x(par) + c - (w - D), i, ac);
      }
    }
    if (i + 1 < live)
      fetch_ahead(s, eb, se_x, se_p, i + 1, T_x, out, row_stride, i + 1,
                  par ^ 1, w);
    // Every cell of a_i is in shared memory, and every thread has left
    // token i - 1, whose rows of the other parity are written next.
    __syncthreads();
    halo.release(i);
    if (reads_halo) halo.wait_full(i);
    for (int c = s.c0; c < s.wb; c += s.tc) {
      const float inner = window_lse_chain(a + c - 1, -1, D);
      float v = s.e(par)[c] + inner;
      if (!(v > DEAD)) v = NEG;
      s.carry[c] = v;
      out[i * row_stride + c] = v;
    }
  }
  // Tokens >= t_x repeat the carry.
  for (int i = live; i < T_x; ++i)
    for (int c = s.c0; c < s.wb; c += s.tc) out[i * row_stride + c] = s.carry[c];
  cluster.sync();  // no block leaves while a neighbour may reach its memory
}

__global__ void __launch_bounds__(1024) mobo_beta_kernel(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, const int* __restrict__ t_x, const int* __restrict__ t_y,
    float* __restrict__ beta, int B, int T_x, int n, int D, int C, int w,
    int z_shared) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Slice s(smem, C, w, n, D, z_shared != 0);
  const int tx = t_x[s.b];
  const int ty = t_y[s.b];
  const long long row_stride = static_cast<long long>(B) * n;
  float* out = beta + static_cast<long long>(s.b) * n + s.start;
  const float* eb = e + s.b * se_b;
  // Chain tokens 0..steps-1, run from the last: the tokens below the pinned
  // row t_x - 1, or every token when t_x > T_x (the last of them reads a
  // NEG row past the grid).
  const int steps = tx > T_x ? T_x : (tx > 1 ? tx - 1 : 0);
  const bool pinned = tx >= 1 && tx <= T_x;

  __shared__ unsigned long long bars[4];
  // Pushed to the left: the first D cells of c (fewer where the block has
  // fewer); read from the right, which pushes min(D, its cells).
  const int right_cells = n - (s.start + w) < w ? n - (s.start + w) : w;
  const Halo halo = make_halo(bars, s.rank - 1,
                              s.rank + 1 < C ? s.rank + 1 : -1,
                              right_cells < D ? right_cells : D);
  fill_rows(smem, 2 * (w + D));          // the last block's halo stays NEG
  for (int c = s.c0; c < s.wb; c += s.tc) {
    const float v = pinned && s.start + c == ty ? 0.f : NEG;
    s.carry[c] = v;
    if (pinned) out[(tx - 1) * row_stride + c] = v;
    for (int i = tx > 0 ? tx : 0; i < T_x; ++i) out[i * row_stride + c] = NEG;
  }
  z_prologue(s, eb, se_x, se_p, steps, 1, T_x, n, D, w, out, row_stride);
  cluster.sync();                        // z written, every block running

  // The thread's last cell reads the halo if any of its cells does.
  const int last = s.c0 < s.wb ? s.c0 + (s.wb - 1 - s.c0) / s.tc * s.tc : -1;
  const bool reads_halo = halo.from >= 0 && last + D >= w;
  if (steps > 0)
    fetch_ahead(s, eb, se_x, se_p, steps, T_x, out, row_stride, steps - 1, 0,
                w);
  // Step t runs token i = steps - 1 - t; rows and barriers go by t's parity.
  for (int t = 0, i = steps - 1; i >= 0; ++t, --i) {
    const int par = t & 1;
    cp_async_wait_all();                 // token i's cells have landed
    const float* z = s.z_shared ? s.z + i * w : s.z + par * w;
    float* x = s.x(par);
    for (int c = s.c0; c < s.wb; c += s.tc) {
      const float ev = s.e(par)[c];
      const float cv = (ev > DEAD ? ev : NEG) + s.carry[c];
      x[c] = cv;
      if (halo.to >= 0 && c < D) {
        if (c == s.c0) halo.wait_empty(t);           // first pushed cell
        halo.push(s.x(par) + w + c, t, cv);
      }
    }
    if (i > 0)
      fetch_ahead(s, eb, se_x, se_p, i, T_x, out, row_stride, i - 1, par ^ 1,
                  w);
    // Every cell of c is in shared memory, and every thread has left the
    // previous step, whose rows of the other parity are written next.
    __syncthreads();
    halo.release(t);
    if (reads_halo) halo.wait_full(t);
    for (int c = s.c0; c < s.wb; c += s.tc) {
      const float zc = z[c];
      const float inner = window_lse_chain(x + c + 1, 1, D);
      const float v = zc > DEAD ? inner - zc : NEG;
      s.carry[c] = v;
      out[i * row_stride + c] = v;
    }
  }
  cluster.sync();  // no block leaves while a neighbour may reach its memory
}

int block_threads(int n) { return n >= 1024 ? 1024 : ((n + 31) / 32) * 32; }

// Opt in to `smem` bytes of dynamic shared memory where that is above the
// 48 KB a kernel gets without asking.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The launch of H7 or H9 on B clusters of C blocks, each owning w
// positions, into `config` (which points at `attr`) and `z_shared`.
// Refuses a plan that breaks the kernels' assumptions: C in 1..8, C*w >= n
// with every block owning a cell, and w >= D when there is a neighbour.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int B, int T_x, int n, int D,
                           int C, int w, void* stream,
                           cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr, int* z_shared) {
  if (C < 1 || C > MAX_CLUSTER || w < 1 ||
      static_cast<long long>(C) * w < n ||
      static_cast<long long>(C - 1) * w >= n || (C > 1 && w < D))
    return cudaErrorInvalidValue;
  const size_t threads = sweep_threads(w);
  const size_t rows = (2 + 4 * threads / chain_threads(w)) *
                          (static_cast<size_t>(w) + D) + 3 * w;
  const size_t z_rows = static_cast<size_t>(T_x) * w;
  *z_shared = (rows + z_rows) * sizeof(float) <= MAX_SMEM;
  const size_t smem = (rows + (*z_shared ? z_rows : 2 * w)) * sizeof(float);
  const cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  *config = {};
  config->gridDim = dim3(B * C);
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = smem;
  config->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// e: f32 grid read as [T_x, B, T_y1] through element strides se_*; t_x:
// int32 [B]; logB: f32 [T_x, B, T_y1] contiguous; D >= 1; C blocks per
// item, each owning w positions (ops/mobo_kernel.py:_cluster_plan).
// Returns the launch's error, else cudaGetLastError() after it.
extern "C" int mobo_alpha_launch(const float* e, long long se_x,
                                 long long se_b, long long se_p,
                                 const int* t_x, float* logB, int B, int T_x,
                                 int T_y1, int D, int C, int w,
                                 void* stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  int z_shared;
  cudaError_t err = cluster_config(mobo_alpha_kernel, B, T_x, T_y1, D, C, w,
                                   stream, &config, &attr, &z_shared);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&config, mobo_alpha_kernel, e, se_x, se_b, se_p,
                             t_x, logB, B, T_x, T_y1, D, C, w, z_shared);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// e, t_x as above; t_y: int32 [B]; bp: int32 [T_x, B, T_y1] contiguous;
// durs: int32 [B, T_x] contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int mobo_bp_launch(const float* e, long long se_x, long long se_b,
                              long long se_p, const int* t_x, const int* t_y,
                              int* bp, int* durs, int B, int T_x, int T_y1,
                              int D, void* stream) {
  // Two rows of n + 2*D floats and one of n.
  const size_t smem =
      (3 * static_cast<size_t>(T_y1) + 4 * static_cast<size_t>(D)) *
      sizeof(float);
  cudaError_t err = opt_in_smem(mobo_bp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mobo_bp_kernel<<<B, block_threads(T_y1), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      e, se_x, se_b, se_p, t_x, t_y, bp, durs, B, T_x, T_y1, D);
  return static_cast<int>(cudaGetLastError());
}

// e, t_x, t_y as above; beta: f32 [T_x, B, T_y1] contiguous; C and w as
// for mobo_alpha_launch. Returns the launch's error, else
// cudaGetLastError() after it.
extern "C" int mobo_beta_launch(const float* e, long long se_x,
                                long long se_b, long long se_p,
                                const int* t_x, const int* t_y, float* beta,
                                int B, int T_x, int T_y1, int D, int C, int w,
                                void* stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  int z_shared;
  cudaError_t err = cluster_config(mobo_beta_kernel, B, T_x, T_y1, D, C, w,
                                   stream, &config, &attr, &z_shared);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&config, mobo_beta_kernel, e, se_x, se_b, se_p,
                             t_x, t_y, beta, B, T_x, T_y1, D, C, w,
                             z_shared);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
