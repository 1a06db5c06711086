// The residual FCFS walk shared by escrow_admit.cu and txn_megastep.cu (the
// Pallas megastep's phase 2 is the escrow_admit walk verbatim, so both CUDA
// kernels call this one routine).
//
// Walk the residual transactions res_idx[0:n_res] in batch (= FCFS) order
// against avail; a transaction commits iff every valid line fits the cell's
// remaining availability, counting the demand its own earlier lines put on
// the same cell; a commit reserves its lines, an abort leaves no trace.
// The dynamic trip count n_res is read from device memory: the host never
// synchronises, and n_res == 0 (an all-fast batch) is an empty walk.
//
// The walk is sequential by definition (transaction i+1 sees i's
// reservations), so its cost is the latency of one step times n_res. The
// Pallas kernel walked an avail resident in VMEM; here the cells a tile of
// the walk names are gathered into shared memory first, so a step is a
// shared-memory read, a warp vote and a shared-memory store, and no step
// waits on L2 or HBM. Called by EVERY thread of the block (it holds block
// barriers). committed starts as the fast mask; then, for each tile of at
// most T transactions:
//
//   1. stage: the tile's lines in walk order (slot, or -1 for an invalid
//      line, and qty), read from global memory by all threads at once,
//      kBatch lines a thread a round;
//   2. table: each valid line computes need = prior + qty, prior being the
//      quantities of its transaction's earlier valid lines on the same
//      slot (it depends only on the transaction's own lines, so it leaves
//      the serial loop), and finds its cell in an open-addressing hash of
//      the tile's distinct slots (Fibonacci hashing, linear probing,
//      atomicCAS; H >= 2 x the tile's lines, a power of two). The line
//      that claims an entry loads avail[slot] into it, so all the tile's
//      cell loads are in flight together. Each line keeps its entry, and a
//      flag when it is its transaction's last valid line on that slot;
//   3. walk: warp 0, lane l holding line l (L <= 32), per transaction:
//      have = table[entry], ok = all(!valid || need <= have); on ok the
//      last line on each slot stores have - need, its need being the
//      transaction's whole demand on the cell, so duplicate slots reserve
//      exactly once and no atomic is needed. The next transaction's line
//      is loaded while the vote runs. No global memory is touched;
//   4. write back every table entry to avail[slot] and the verdicts to
//      committed[res_idx[i]], then a block barrier, so the next tile's
//      gather sees this tile's reservations and the tiles equal one walk.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace walk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = -1;          // a free table entry (slots are >= 0)
constexpr int kLast = 1 << 30;      // flag: the last line on its slot
constexpr int kEntry = kLast - 1;   // mask of the entry index

// Entries of the table for a tile of `lines` lines: a power of two of at
// least twice the lines (a load factor of at most 1/2), at least 32. The
// wrapper sizes the shared memory with the same rule
// (kernels/escrow_admit.py walk_table_size).
__device__ __forceinline__ int table_size(int lines) {
  int h = 32;
  while (h < 2 * lines) h <<= 1;
  return h;
}

// The first table entry probed for slot s in a table of 2**(32 - shift)
// entries: Fibonacci hashing, the top bits of s times 2**32 / phi. The
// slots of a batch come in runs of neighbours (one warehouse's hot items
// sit side by side in the hot set), which the identity s mod H would pile
// into long linear-probing clusters; the multiplier scatters them.
// (kernels/escrow_admit.py walk_hash is the same function.)
__device__ __forceinline__ int hash(int s, int shift) {
  return static_cast<int>((static_cast<unsigned>(s) * 0x9E3779B9u) >> shift);
}

// The layout of the dynamic shared memory for tiles of T transactions of L
// lines: four int arrays of T x L lines, the table's keys and values (H
// entries each, H = table_size(T x L)), then T verdict bytes.
struct Smem {
  int* slot;    // [T L] staged slot, kEmpty for an invalid line
  int* qty;     // [T L] staged quantity
  int* entry;   // [T L] table entry | kLast, or kEmpty for an invalid line
  int* need;    // [T L] prior + qty
  int* key;     // [H] slot held by the entry, or kEmpty
  int* val;     // [H] the cell's remaining availability
  uint8_t* verdict;  // [T]

  __device__ Smem(void* base, int T, int L, int H) {
    const int n = T * L;
    slot = static_cast<int*>(base);
    qty = slot + n;
    entry = qty + n;
    need = entry + n;
    key = need + n;
    val = key + H;
    verdict = reinterpret_cast<uint8_t*>(val + H);
  }
};

// Lines (or window elements) a thread handles in one round: their global
// loads are all issued before any result is used, so a round costs one
// memory latency, not kBatch of them.
constexpr int kBatch = 4;

// Line g of the batch's [B, L] window holding its tile's line e, or -1.
__device__ __forceinline__ int window_line(const int32_t* res_idx, int tile0,
                                           int e, int lines, int L) {
  if (e >= lines) return -1;
  const int i = e / L;
  return res_idx[tile0 + i] * L + (e - i * L);
}

__device__ __forceinline__ void residual_walk(
    const int32_t* __restrict__ n_res, const int32_t* __restrict__ res_idx,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ qty,
    const uint8_t* __restrict__ line_valid, const uint8_t* __restrict__ fast,
    int32_t* avail, uint8_t* committed, int B, int L, int T, int H,
    void* smem) {
  const Smem sm(smem, T, L, H);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n = *n_res;
  for (int t = tid; t < B; t += nthreads) committed[t] = fast[t];
  __syncthreads();   // the walk's verdicts land after the fast mask
  for (int tile0 = 0; tile0 < n; tile0 += T) {
    const int nt = min(T, n - tile0), lines = nt * L;
    const int ht = table_size(lines), mask = ht - 1;
    const int shift = 33 - __ffs(ht);   // 32 - log2(ht)

    // ---- 1. stage the tile's lines in walk order; clear the table ------
    for (int e0 = tid; e0 < lines; e0 += kBatch * nthreads) {
      int g[kBatch], s[kBatch], q[kBatch];
      bool v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        g[k] = window_line(res_idx, tile0, e0 + k * nthreads, lines, L);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        v[k] = g[k] >= 0 && line_valid[g[k]];
        s[k] = g[k] >= 0 ? slot[g[k]] : 0;
        q[k] = g[k] >= 0 ? qty[g[k]] : 0;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (g[k] < 0) continue;
        sm.slot[e0 + k * nthreads] = v[k] ? s[k] : kEmpty;
        sm.qty[e0 + k * nthreads] = q[k];
      }
    }
    for (int h = tid; h < ht; h += nthreads) sm.key[h] = kEmpty;
    __syncthreads();

    // ---- 2. need, and each line's cell in the table ----------------------
    for (int e0 = tid; e0 < lines; e0 += kBatch * nthreads) {
      int claimed[kBatch], cell[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * nthreads;
        claimed[k] = -1;
        cell[k] = 0;
        if (e >= lines) continue;
        const int s = sm.slot[e];
        int packed = kEmpty, need = 0;
        if (s != kEmpty) {
          const int l = e % L, base = e - l;
          int prior = 0;
          bool last = true;
#pragma unroll 4
          for (int j = 0; j < L; ++j) {   // branch-free: the loads pipeline
            const int sj = sm.slot[base + j], qj = sm.qty[base + j];
            prior += (sj == s && j < l) ? qj : 0;
            last = last && !(sj == s && j > l);
          }
          need = prior + sm.qty[e];
          int h = hash(s, shift);
          for (;;) {
            const int prev = atomicCAS(sm.key + h, kEmpty, s);
            if (prev == kEmpty) {
              claimed[k] = h;
              cell[k] = s;
              break;
            }
            if (prev == s) break;
            h = (h + 1) & mask;
          }
          packed = h | (last ? kLast : 0);
        }
        sm.entry[e] = packed;
        sm.need[e] = need;
      }
      // the claimed cells' loads, all in flight together; __ldcg reads at
      // L2, where the previous tile's write-back is
      int have[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        have[k] = claimed[k] >= 0 ? __ldcg(avail + cell[k]) : 0;
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (claimed[k] >= 0) sm.val[claimed[k]] = have[k];
    }
    __syncthreads();

    // ---- 3. the serial walk, in shared memory (warp 0) --------------------
    if (tid < 32) {
      volatile int* val = sm.val;
      const bool on = tid < L;
      int packed = on ? sm.entry[tid] : kEmpty;
      int need = on ? sm.need[tid] : 0;
      for (int i = 0; i < nt; ++i) {
        int packed_next = kEmpty, need_next = 0;
        if (on && i + 1 < nt) {
          packed_next = sm.entry[(i + 1) * L + tid];
          need_next = sm.need[(i + 1) * L + tid];
        }
        const bool v = packed != kEmpty;
        const int h = packed & kEntry;
        const int have = v ? val[h] : 0;
        const bool ok = __all_sync(kFull, !v || need <= have);
        if (ok && v && (packed & kLast)) val[h] = have - need;
        if (tid == 0) sm.verdict[i] = ok ? 1 : 0;
        __syncwarp();
        packed = packed_next;
        need = need_next;
      }
    }
    __syncthreads();

    // ---- 4. write back the cells and the verdicts -------------------------
    for (int h = tid; h < ht; h += nthreads) {
      const int s = sm.key[h];
      if (s != kEmpty) avail[s] = sm.val[h];
    }
    for (int i = tid; i < nt; i += nthreads)
      committed[res_idx[tile0 + i]] = sm.verdict[i];
    __syncthreads();
  }
}

}  // namespace walk
