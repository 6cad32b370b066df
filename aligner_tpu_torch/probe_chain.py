"""Floor of a posterior sweep's frame step on the card: blocks that do
nothing but the chain of H3 or H6 (`csrc/posterior_sweep.cuh`), one cell
per thread, in nanoseconds per dependent step.

    python -m aligner_tpu_torch.probe_chain

A step reads the x and x+1 neighbours (and x+2 for two arms) of the
message column from shared memory, takes one precise logaddexp (two
nested for two arms, as H6), adds lp, clamps at NEG/2, stores the new
column and passes one block barrier (the columns double-buffered). lp is
a constant, or is loaded from device memory after the barrier, as H2 and
H5 load it: from a lattice that stays in the 50 MB L2 (1024 frames) or
one that streams from device memory (8192 frames).

Builds its own small CUDA source with nvcc into `_build/`, launches 16
blocks (the phase-7 batch) of 128 threads (H3's column) and of 288
(H6's), and prints one JSON line per shape with the best of five launches
by CUDA events, beside the card's name and power limit. Exits 1 without
a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import math
import sys

SOURCE = r"""
#include <cuda_runtime.h>
constexpr float NEG = -1e15f;
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}
// `steps` dependent column steps of blockDim.x cells; lp row y % rows of
// a [rows, gridDim.x, blockDim.x] lattice when LOAD, else lv.
template <int ARMS, bool LOAD>
__global__ void chain(const float* __restrict__ lp, int rows, float lv,
                      float* __restrict__ out, int steps) {
  extern __shared__ float cols[];
  const int T = blockDim.x;
  const int c = threadIdx.x;
  cols[c] = 0.f;
  __syncthreads();
  for (int y = 0; y < steps; ++y) {
    const float* in = cols + (y & 1) * T;
    float* cur = cols + ((y + 1) & 1) * T;
    float beta = logaddexp(in[c], c + 1 < T ? in[c + 1] : NEG);
    if (ARMS == 2) beta = logaddexp(beta, c + 2 < T ? in[c + 2] : NEG);
    const float l =
        LOAD ? lp[((long long)(y % rows) * gridDim.x + blockIdx.x) * T + c]
             : lv;
    const float m = l + beta;
    cur[c] = m > 0.5f * NEG ? m : NEG;
    __syncthreads();
  }
  out[blockIdx.x * T + c] = cols[(steps & 1) * T + c];
}
// Best of five launches in ms, or -1 if a launch failed.
extern "C" float time_chain(int arms, const float* lp, int rows, float lv,
                            float* out, int blocks, int threads,
                            int steps) {
  auto kernel = arms == 1 ? (lp ? &chain<1, true> : &chain<1, false>)
                          : (lp ? &chain<2, true> : &chain<2, false>);
  const size_t smem = 2 * threads * sizeof(float);
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  float best = 1e30f;
  for (int rep = 0; rep < 6; ++rep) {  // the first one warms up
    cudaEventRecord(start);
    kernel<<<blocks, threads, smem>>>(lp, rows, lv, out, steps);
    if (cudaGetLastError() != cudaSuccess) return -1.f;
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms;
    cudaEventElapsedTime(&ms, start, end);
    if (rep > 0) best = ms < best ? ms : best;
  }
  return cudaGetLastError() == cudaSuccess ? best : -1.f;
}
"""

BLOCKS = 16
STEPS = 10240
WIDTHS = (128, 288)                  # H3's and H6's columns at phase 7
# lp: None (a constant), or the frames of a lattice that stays in L2 or
# streams from device memory.
LOADS = (("none", 0), ("l2", 1024), ("device memory", 8192))


def main() -> int:
    import torch
    from aligner_tpu_torch import _build
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    lib = _build.build_probe("probe_chain", SOURCE)
    lib.time_chain.restype = ctypes.c_float
    lib.time_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
    torch.cuda.init()
    card = _build.card_label(0)
    for threads in WIDTHS:
        out = torch.empty(BLOCKS * threads, device="cuda")
        for arms in (1, 2):
            # lp = -log(arms + 1) keeps an interior message constant.
            lv = -math.log(arms + 1)
            for load, rows in LOADS:
                lp = (torch.full((rows, BLOCKS, threads), lv, device="cuda")
                      if rows else None)
                ms = lib.time_chain(arms, lp.data_ptr() if rows else None,
                                    max(rows, 1), lv, out.data_ptr(),
                                    BLOCKS, threads, STEPS)
                if ms < 0:
                    print(json.dumps({"error": "chain launch failed"}))
                    return 1
                print(json.dumps({"probe": "chain", "logaddexp": arms,
                                  "lp_load": load, "blocks": BLOCKS,
                                  "threads": threads,
                                  "ns_per_step": ms / STEPS * 1e6,
                                  "device": card}), flush=True)
                del lp
    return 0


if __name__ == "__main__":
    sys.exit(main())
