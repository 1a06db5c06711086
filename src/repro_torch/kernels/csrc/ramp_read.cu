// The fused RAMP read for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ramp_read.py
// (_ramp_read_kernel / ramp_read_kernel): for each query row, the
// commit-record metadata (req_ts, nlines) and five [R, L] line streams
// give
//   need      = line < nlines
//   match     = ol_ts == req_ts
//   round1    = vis & match & need           (the committed layer)
//   repaired  = need & ~round1 & prep & match (the lookback round)
//   present   = round1 | repaired
// and the outputs present, amount_sel (0 where absent), i_id_sel (-1 where
// absent), and per row amount_sum, lines_read and repaired.
//
// What bounds it on this card: bytes. Nothing is reused, and a handful of
// integer compares per line is all the arithmetic. At most each input is
// read once and each output written once, 365 bytes per row at L = 15
// (8 of metadata, 14 per line in, 9 per line out, 12 of row results).
// Fewer are needed: a line's streams matter only while its fate depends
// on them. The stamp is read where the line is needed (line < nlines),
// visibility where the stamp matches, the prepared bit where a matching
// line is invisible, and the amount and item id where the line is
// present; the outputs are written whole. The kernel reads exactly that,
// so an order table that is mostly empty slots costs little more than the
// outputs.
//
// Design: a block takes kRows rows. Its threads stride over the block's
// rows * L line elements of the flattened row-major [R, L] streams, so
// neighbouring threads load and store neighbouring elements (coalesced);
// each line's selected amount and its two flags go to shared memory. After
// a barrier, one thread per row sums its row IN LINE ORDER, from 0.0f,
// line 0 first: the order of the plain version and of XLA, so amount_sum
// is bit-equal to both. Rows past R are masked, not asserted away. The
// inputs are assumed contiguous with L <= kMaxLines; the wrapper checks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kMaxLines = 32;

__global__ void __launch_bounds__(kThreads)
ramp_read_kernel(const int32_t* __restrict__ req_ts,
                 const int32_t* __restrict__ nlines,
                 const int32_t* __restrict__ ol_ts,
                 const uint8_t* __restrict__ ol_vis,
                 const uint8_t* __restrict__ ol_prep,
                 const float* __restrict__ amount,
                 const int32_t* __restrict__ i_id,
                 uint8_t* __restrict__ present,
                 float* __restrict__ amount_sel,
                 int32_t* __restrict__ i_id_sel,
                 float* __restrict__ amount_sum,
                 int32_t* __restrict__ lines_read,
                 int32_t* __restrict__ repaired, int64_t R, int L) {
  __shared__ int32_t s_req[kRows];
  __shared__ int32_t s_need[kRows];
  __shared__ float s_amt[kRows * kMaxLines];
  __shared__ uint8_t s_present[kRows * kMaxLines];
  __shared__ uint8_t s_repaired[kRows * kMaxLines];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows),
                                        R - row0));
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s_req[r] = req_ts[row0 + r];
    s_need[r] = nlines[row0 + r];
  }
  __syncthreads();

  const int64_t base = row0 * L;
  for (int e = threadIdx.x; e < rows * L; e += blockDim.x) {
    const int r = e / L;
    const int l = e - r * L;
    const int64_t g = base + e;
    // for a needed line with a matching stamp, round 1 is its visibility
    // and the lookback its prepared bit; any other line is absent
    bool pres = false;
    bool rep = false;
    float a = 0.0f;
    int32_t item = -1;
    if (l < s_need[r] && ol_ts[g] == s_req[r]) {
      const bool vis = ol_vis[g];
      rep = !vis && ol_prep[g];
      pres = vis || rep;
      if (pres) {
        a = amount[g];
        item = i_id[g];
      }
    }
    present[g] = pres;
    amount_sel[g] = a;
    i_id_sel[g] = item;
    s_amt[e] = a;
    s_present[e] = pres;
    s_repaired[e] = rep;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float sum = 0.0f;
    int n_read = 0;
    int n_rep = 0;
    for (int l = 0; l < L; ++l) {
      sum += s_amt[r * L + l];
      n_read += s_present[r * L + l];
      n_rep += s_repaired[r * L + l];
    }
    amount_sum[row0 + r] = sum;
    lines_read[row0 + r] = n_read;
    repaired[row0 + r] = n_rep;
  }
}

}  // namespace

extern "C" int ramp_read_launch(const void* req_ts, const void* nlines,
                                const void* ol_ts, const void* ol_vis,
                                const void* ol_prep, const void* amount,
                                const void* i_id, void* present,
                                void* amount_sel, void* i_id_sel,
                                void* amount_sum, void* lines_read,
                                void* repaired, int64_t R, int L,
                                void* stream) {
  if (L < 1 || L > kMaxLines) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (R + kRows - 1) / kRows;
  ramp_read_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(req_ts), static_cast<const int32_t*>(nlines),
      static_cast<const int32_t*>(ol_ts), static_cast<const uint8_t*>(ol_vis),
      static_cast<const uint8_t*>(ol_prep), static_cast<const float*>(amount),
      static_cast<const int32_t*>(i_id), static_cast<uint8_t*>(present),
      static_cast<float*>(amount_sel), static_cast<int32_t*>(i_id_sel),
      static_cast<float*>(amount_sum), static_cast<int32_t*>(lines_read),
      static_cast<int32_t*>(repaired), R, L);
  return static_cast<int>(cudaGetLastError());
}
