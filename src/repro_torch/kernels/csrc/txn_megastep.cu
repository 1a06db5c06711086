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
// dense [n_cells] slabs (at the slice's 64 spec-scale warehouses, 3 x 26 MB
// per batch); the [B, L] window and the avail cells it names are tens of
// KB. The wrapper zeroes the slabs with one torch.zeros, at the HBM rate:
// folding that into this one-block kernel would need a grid-wide barrier
// and move no fewer bytes. The kernel itself is latency on one SM: the
// walk's staging and its n_res serial steps, the rank's dependence on
// every earlier transaction, and phase 3b's global atomics.
//
// Design: ONE block of kThreads threads.
//   phase 2  — residual_walk.cuh, the escrow_admit walk: the tile's lines
//              and cells staged in shared memory by the whole block, then
//              walked there by warp 0, so no step waits on L2;
//   phase 3a — rank and d_count over the batch in chunks of kThreads
//              transactions: each chunk's keys and verdicts are staged in
//              shared memory, thread t counts the committed same-key
//              transactions before it in the chunk there (broadcast reads,
//              no global load in the loop) and adds its key's count from
//              earlier chunks, which is d_count itself, advanced by the
//              chunk's commits after every thread has read it. So rank
//              follows batch order for any B, and is stored for aborted
//              transactions too;
//   phase 3b/4 — every thread strides over the [B, L] window, loading
//              kBatch elements before it uses any: the fast path's settle
//              (atomicSub on avail), the slabs (atomicAdd), the stamps.
//              Integer atomics are exact in any order.
//
// The kernel updates avail IN PLACE: the caller passes the fresh vector it
// has just built (sparse_admission_problem concatenates a new one every
// batch), where the Pallas kernel copied avail0 into its output.

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
  uint8_t* committed;   // out: verdicts
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
  int T;                // transactions a walk tile
  int H;                // table entries of a full tile
};

__global__ void __launch_bounds__(kThreads) txn_megastep_kernel(MegaArgs a) {
  extern __shared__ int4 smem[];
  __shared__ int chunk_key[kThreads];
  __shared__ uint8_t chunk_committed[kThreads];

  // ---- phase 2: residual FCFS walk (the whole block; ends at a barrier) --
  walk::residual_walk(a.n_res, a.res_idx, a.slot, a.qty, a.line_valid,
                      a.fast, a.avail, a.committed, a.B, a.L, a.T, a.H,
                      smem);

  const int B = a.B, L = a.L, N = B * L, tid = threadIdx.x;
  // ---- phase 3a: rank and district counts, a chunk of kThreads at a time -
  for (int c0 = 0; c0 < B; c0 += kThreads) {
    const int t = c0 + tid;
    const bool in = t < B;
    const int key = in ? a.key_local[t] : -1;
    const bool com = in && __ldcg(a.committed + t);
    chunk_key[tid] = key;
    chunk_committed[tid] = com;
    __syncthreads();
    if (in) {
      int r = __ldcg(a.d_count + key);   // commits of earlier chunks
      for (int u = 0; u < tid; ++u)
        r += (chunk_key[u] == key && chunk_committed[u]) ? 1 : 0;
      a.rank[t] = r;
    }
    __syncthreads();   // every read of d_count precedes this chunk's adds
    if (com) atomicAdd(a.d_count + key, 1);
    __syncthreads();
  }
  // ---- phase 3b + 4: settle, slabs and stamps over the [B, L] window -----
  // kBatch elements a thread a round: every load first, then the atomics
  // and stores, so a round waits on one memory latency
  constexpr int kB = walk::kBatch;
  for (int e0 = tid; e0 < N; e0 += kB * blockDim.x) {
    bool v[kB], settle[kB], land[kB], remote[kB];
    int q[kB], s[kB], cell[kB], ts[kB];
    float price[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int e = e0 + k * blockDim.x;
      const bool in = e < N;
      const int t = in ? e / L : 0;
      v[k] = in && a.line_valid[e];
      settle[k] = v[k] && a.fast[t];
      land[k] = in && a.local_line[e] && __ldcg(a.committed + t);
      remote[k] = in && a.remote_line[e];
      q[k] = in ? a.qty[e] : 0;
      s[k] = in ? a.slot[e] : 0;
      cell[k] = in ? a.cell_local[e] : 0;
      ts[k] = in ? a.ramp_ts[t] : 0;
      price[k] = in ? a.price_row[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int e = e0 + k * blockDim.x;
      if (e >= N) continue;
      if (settle[k]) atomicSub(a.avail + s[k], q[k]);
      if (land[k]) {
        atomicAdd(a.stock_dec + cell[k], q[k]);
        atomicAdd(a.stock_cnt + cell[k], 1);
        if (remote[k]) atomicAdd(a.stock_rcnt + cell[k], 1);
      }
      a.ol_ts[e] = v[k] ? ts[k] : -1;
      a.amount[e] = v[k] ? price[k] * static_cast<float>(q[k]) : 0.0f;
    }
  }
}

}  // namespace

extern "C" int txn_megastep_launch(
    const void* n_res, const void* res_idx, const void* slot, const void* qty,
    const void* line_valid, const void* fast, const void* key_local,
    const void* cell_local, const void* local_line, const void* remote_line,
    const void* ramp_ts, const void* price_row, void* committed, void* avail,
    void* rank, void* d_count, void* stock_dec, void* stock_cnt,
    void* stock_rcnt, void* ol_ts, void* amount, int B, int L, int T, int H,
    int smem, void* stream) {
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
             L,
             T,
             H};
  cudaError_t err = cudaFuncSetAttribute(
      txn_megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  txn_megastep_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
