// Residual FCFS escrow admission (Level 2 of the two-level pipeline) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/escrow_admit.py
// (_escrow_admit_body / escrow_admit_kernel): walk the residual
// transactions res_idx[0:n_res] in batch (= FCFS) order, committed starting
// as the gate's fast mask. The walk itself is residual_walk.cuh, shared with
// the megastep.
//
// What bounds it on this card: not bytes and not arithmetic but latency.
// The walk is sequential by definition (transaction t+1 sees t's
// reservations), so its cost is n_res dependent round trips to L2: one load
// of each line's cell, one atomic per committed line. The bytes the
// function must move are only the residual transactions' lines and the
// avail cells they name; the avail vector itself (the slice's ~26 MB escrow
// admission vector, more than the 227 KB of shared memory a block can hold,
// but inside the 50 MB L2) is neither read nor written whole.
//
// Design: ONE warp, lane l holding line l (see residual_walk.cuh).
//
// The kernel updates avail and committed IN PLACE. The Pallas kernel copied
// avail0 into its output; here the caller passes the fresh vector it has
// just built (sparse_admission_problem concatenates a new one every batch)
// and a copy of the fast mask, so no 26 MB copy runs per batch. The fast
// path's settle scatter and the contention gate stay torch ops outside, as
// they sat outside the Pallas kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "residual_walk.cuh"

namespace {

__global__ void escrow_admit_walk(const int32_t* __restrict__ n_res,
                                  const int32_t* __restrict__ res_idx,
                                  const int32_t* __restrict__ slot,
                                  const int32_t* __restrict__ qty,
                                  const uint8_t* __restrict__ line_valid,
                                  int32_t* avail, uint8_t* committed, int L) {
  residual_walk(n_res, res_idx, slot, qty, line_valid, avail, committed, L);
}

}  // namespace

extern "C" int escrow_admit_launch(const void* n_res, const void* res_idx,
                                   const void* slot, const void* qty,
                                   const void* line_valid, void* avail,
                                   void* committed, int L, void* stream) {
  escrow_admit_walk<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n_res), static_cast<const int32_t*>(res_idx),
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(qty),
      static_cast<const uint8_t*>(line_valid), static_cast<int32_t*>(avail),
      static_cast<uint8_t*>(committed), L);
  return static_cast<int>(cudaGetLastError());
}
