// The residual FCFS walk shared by escrow_admit.cu and txn_megastep.cu (the
// Pallas megastep's phase 2 is the escrow_admit walk verbatim, so both CUDA
// kernels call this one function).
//
// Walk the residual transactions res_idx[0:n_res] in batch (= FCFS) order;
// a transaction commits iff every valid line fits the cell's remaining
// availability, counting the demand its own earlier lines put on the same
// cell; a commit reserves its lines, an abort leaves no trace.
//
// Called by ONE warp, lane l holding line l (L <= 32; TPC-C has 15). Per
// transaction each valid lane loads have = avail[slot] with an L2-coherent
// load, sums the quantities of earlier valid lanes on the same slot through
// shuffles (the Pallas walk's subtract-then-check, which makes duplicate
// cells in one order accumulate), and the warp votes
// ok = all(prior + q <= have). On ok every valid lane atomicSub's its
// quantity, so duplicate slots accumulate exactly. The dynamic trip count
// n_res is read from device memory: the host never synchronises, and
// n_res == 0 (an all-fast batch) is an empty walk.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void residual_walk(
    const int32_t* __restrict__ n_res, const int32_t* __restrict__ res_idx,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ qty,
    const uint8_t* __restrict__ line_valid, int32_t* avail,
    uint8_t* committed, int L) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int n = *n_res;
  for (int i = 0; i < n; ++i) {
    const int t = res_idx[i];
    bool v = false;
    int s = 0, q = 0;
    if (lane < L) {
      v = line_valid[t * L + lane] != 0;
      s = slot[t * L + lane];
      q = qty[t * L + lane];
    }
    // __ldcg reads at L2, where the atomics of earlier transactions landed
    const int have = v ? __ldcg(avail + s) : 0;
    int prior = 0;
    for (int j = 0; j < L; ++j) {
      const int sj = __shfl_sync(kFull, s, j);
      const int qj = __shfl_sync(kFull, q, j);
      const int vj = __shfl_sync(kFull, (int)v, j);
      if (j < lane && vj && sj == s) prior += qj;
    }
    const bool ok = __all_sync(kFull, !v || prior + q <= have);
    if (ok && v) atomicSub(avail + s, q);
    if (lane == 0) committed[t] = ok ? 1 : 0;
    __syncwarp();
  }
}
