// The transaction megastep (phases 2-4 of strict-stock New-Order) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/txn_megastep.py
// (_txn_megastep_body / txn_megastep_kernel):
//   phase 2 — the residual FCFS walk, exactly the escrow_admit walk;
//   phase 3 — committed effects: the fast path's reservations settle into
//             avail, each transaction's rank (committed earlier
//             transactions of its district key, stored for aborted ones
//             too), the per-district commit counts d_count, and the three
//             stock slabs (decrement, order count, remote count) over the
//             admitted local lines;
//   phase 4 — RAMP stamps ol_ts and line amounts price x qty.
//
// What bounds it on this card: bytes. The function must write the three
// dense [n_cells] slabs (at the slice's 64 spec-scale warehouses,
// 3 x 26 MB per batch); the [B, L] window and the avail cells it names are
// tens of KB. The walk adds n_res dependent L2 round trips, as in
// escrow_admit.
//
// Design: ONE block. Warp 0 runs phase 2 (residual_walk.cuh, the
// escrow_admit walk) while the other warps wait at a block barrier; phases
// 3-4 then run with every thread of the block striding over the [B, L]
// window. All accumulations are integer atomics (atomicSub on avail,
// atomicAdd on d_count and the slabs), which are exact in any order; rank
// is an O(B) count per transaction, so it follows batch order by
// construction.
//
// The kernel updates avail IN PLACE: the caller passes the fresh vector it
// has just built (sparse_admission_problem concatenates a new one every
// batch), where the Pallas kernel copied avail0 into its output. The
// zeroing of d_count and the slabs is the wrapper's; writing the dense
// slabs is what the caller's dense adds consume, it is the kernel's cost at
// this size and is left for later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "residual_walk.cuh"

namespace {

constexpr int kThreads = 1024;

struct MegaArgs {
  const int32_t* n_res;
  const int32_t* res_idx;
  const int32_t* slot;
  const int32_t* qty;
  const uint8_t* line_valid;
  const uint8_t* fast;
  const int32_t* key_local;
  const int32_t* cell_local;
  const uint8_t* local_line;
  const uint8_t* remote_line;
  const int32_t* ramp_ts;
  const float* price_row;
  uint8_t* committed;   // in: fast mask copy; out: verdicts
  int32_t* avail;       // in: avail0 (the caller's); out: fully settled
  int32_t* rank;
  int32_t* d_count;     // zeroed by the wrapper
  int32_t* stock_dec;   // zeroed by the wrapper
  int32_t* stock_cnt;   // zeroed by the wrapper
  int32_t* stock_rcnt;  // zeroed by the wrapper
  int32_t* ol_ts;
  float* amount;
  int B;
  int L;
};

__global__ void __launch_bounds__(kThreads) txn_megastep_kernel(MegaArgs a) {
  // ---- phase 2: residual FCFS walk (warp 0) ------------------------------
  if (threadIdx.x < 32)
    residual_walk(a.n_res, a.res_idx, a.slot, a.qty, a.line_valid, a.avail,
                  a.committed, a.L);
  __syncthreads();

  const int B = a.B, L = a.L, N = B * L;
  // ---- phase 3a: per-transaction rank and district counts ----------------
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    const int key = a.key_local[t];
    int r = 0;
    for (int u = 0; u < t; ++u)
      r += (a.key_local[u] == key && __ldcg(a.committed + u)) ? 1 : 0;
    a.rank[t] = r;
    if (__ldcg(a.committed + t)) atomicAdd(a.d_count + key, 1);
  }
  // ---- phase 3b + 4: settle, slabs and stamps over the [B, L] window -----
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const int t = e / L;
    const bool v = a.line_valid[e] != 0;
    const int q = a.qty[e];
    if (v && a.fast[t]) atomicSub(a.avail + a.slot[e], q);
    if (__ldcg(a.committed + t) && a.local_line[e]) {
      const int cell = a.cell_local[e];
      atomicAdd(a.stock_dec + cell, q);
      atomicAdd(a.stock_cnt + cell, 1);
      if (a.remote_line[e]) atomicAdd(a.stock_rcnt + cell, 1);
    }
    a.ol_ts[e] = v ? a.ramp_ts[t] : -1;
    a.amount[e] = v ? a.price_row[e] * static_cast<float>(q) : 0.0f;
  }
}

}  // namespace

extern "C" int txn_megastep_launch(
    const void* n_res, const void* res_idx, const void* slot, const void* qty,
    const void* line_valid, const void* fast, const void* key_local,
    const void* cell_local, const void* local_line, const void* remote_line,
    const void* ramp_ts, const void* price_row, void* committed, void* avail,
    void* rank, void* d_count, void* stock_dec, void* stock_cnt,
    void* stock_rcnt, void* ol_ts, void* amount, int B, int L, void* stream) {
  MegaArgs a{static_cast<const int32_t*>(n_res),
             static_cast<const int32_t*>(res_idx),
             static_cast<const int32_t*>(slot),
             static_cast<const int32_t*>(qty),
             static_cast<const uint8_t*>(line_valid),
             static_cast<const uint8_t*>(fast),
             static_cast<const int32_t*>(key_local),
             static_cast<const int32_t*>(cell_local),
             static_cast<const uint8_t*>(local_line),
             static_cast<const uint8_t*>(remote_line),
             static_cast<const int32_t*>(ramp_ts),
             static_cast<const float*>(price_row),
             static_cast<uint8_t*>(committed),
             static_cast<int32_t*>(avail),
             static_cast<int32_t*>(rank),
             static_cast<int32_t*>(d_count),
             static_cast<int32_t*>(stock_dec),
             static_cast<int32_t*>(stock_cnt),
             static_cast<int32_t*>(stock_rcnt),
             static_cast<int32_t*>(ol_ts),
             static_cast<float*>(amount),
             B,
             L};
  txn_megastep_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
