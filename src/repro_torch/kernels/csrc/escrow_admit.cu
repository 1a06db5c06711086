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
// reservations), so its cost is n_res dependent steps. The bytes the
// function must move are only the residual transactions' lines and the
// avail cells they name; the avail vector itself (the slice's ~26 MB escrow
// admission vector, more than the 227 KB of shared memory a block can hold,
// but inside the 50 MB L2) is neither read nor written whole.
//
// Design: ONE block of kThreads threads (residual_walk.cuh). The block
// stages a tile of the residual window and gathers the avail cells it
// names into a hash table in shared memory, every load in flight at once;
// warp 0 then walks the tile in shared memory, a step a shared read, a
// vote and a shared store, and the block writes the cells back. So the
// serial part no longer waits on L2 (about 1.0 us a residual transaction
// when each step made dependent round trips there). What is left is the
// launch, a few dependent global rounds a tile, and the staging's work in
// shared memory: each line's scan of its transaction for earlier lines on
// its slot and its insert into the table, which at the main path's B = 256
// take about as long as the walk itself.
//
// The kernel updates avail IN PLACE. The Pallas kernel copied avail0 into
// its output; here the caller passes the fresh vector it has just built
// (sparse_admission_problem concatenates a new one every batch), so no
// 26 MB copy runs per batch. committed starts as the fast mask, copied in
// the kernel. The fast
// path's settle scatter and the contention gate stay torch ops outside, as
// they sat outside the Pallas kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "residual_walk.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) escrow_admit_walk(
    const int32_t* __restrict__ n_res, const int32_t* __restrict__ res_idx,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ qty,
    const uint8_t* __restrict__ line_valid, const uint8_t* __restrict__ fast,
    int32_t* avail, uint8_t* committed, int B, int L, int T, int H) {
  extern __shared__ int4 smem[];
  walk::residual_walk(n_res, res_idx, slot, qty, line_valid, fast, avail,
                      committed, B, L, T, H, smem);
}

}  // namespace

// T transactions a tile, H table entries and smem bytes of dynamic shared
// memory, as the wrapper computed them (kernels/escrow_admit.py).
extern "C" int escrow_admit_launch(const void* n_res, const void* res_idx,
                                   const void* slot, const void* qty,
                                   const void* line_valid, const void* fast,
                                   void* avail, void* committed, int B, int L,
                                   int T, int H, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      escrow_admit_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  escrow_admit_walk<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n_res), static_cast<const int32_t*>(res_idx),
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(qty),
      static_cast<const uint8_t*>(line_valid),
      static_cast<const uint8_t*>(fast), static_cast<int32_t*>(avail),
      static_cast<uint8_t*>(committed), B, L, T, H);
  return static_cast<int>(cudaGetLastError());
}
