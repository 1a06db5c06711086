// The VersionedSlots join fused with the threshold audit, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lattice_merge.py
// (_merge_kernel / lattice_merge_kernel): for each row r of two versioned
// tables a and b,
//   b_newer    = b_ver > a_ver              (strictly: a wins a tie)
//   valid      = a_valid | b_valid
//   version    = max(a_ver, b_ver)
//   payload    = b_newer ? b_pay[r, :] : a_pay[r, :]
//   viol       = valid & any(payload < lo | payload > hi)
//
// What bounds it on this card: bytes. Nothing is reused and the
// arithmetic is a compare per element. The data needs both valid masks
// and both stamps, then only the winning row's payload: the losing row's
// W elements decide nothing, so they are not read. Each output is written
// once. At W = 4 float32 columns and int64 stamps that is 34 bytes in and
// 26 out a row, where reading both payloads would be 50 in.
//
// Design: one thread a row. It loads the two stamps and the two valid
// bytes (neighbouring threads, neighbouring rows: coalesced), picks the
// winning side, and copies that side's row. Where a row is a whole number
// of 16-byte chunks and the three payload pointers are 16-byte aligned
// (the wrapper checks), the copy goes in 16-byte vector loads and stores,
// so a warp moves 32 contiguous rows of W = 4 float32 in one instruction
// each way; otherwise element by element. The thresholds arrive already
// rounded to the payload's dtype (float32; bfloat16 widened to float32;
// float32 for an int32 payload), so comparing the payload widened to
// float32 with them is the reference's comparison in its own dtype.
// NaN compares false both ways and is never flagged. Rows past R are
// masked; any R >= 1 and W >= 0 is taken.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int32_t x) { return __int2float_rn(x); }

template <typename T>
__device__ __forceinline__ bool outside(T x, float lo, float hi) {
  const float f = widen(x);
  return (f < lo) || (f > hi);
}

template <typename V, typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
lattice_merge_kernel(const uint8_t* __restrict__ a_valid,
                     const V* __restrict__ a_ver,
                     const T* __restrict__ a_pay,
                     const uint8_t* __restrict__ b_valid,
                     const V* __restrict__ b_ver,
                     const T* __restrict__ b_pay,
                     uint8_t* __restrict__ valid, V* __restrict__ version,
                     T* __restrict__ payload, uint8_t* __restrict__ viol,
                     int64_t R, int W, float lo, float hi) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= R) return;
  const V av = a_ver[r];
  const V bv = b_ver[r];
  const bool b_newer = bv > av;
  const bool v = (a_valid[r] | b_valid[r]) != 0;
  const T* src = (b_newer ? b_pay : a_pay) + r * W;
  T* dst = payload + r * W;
  bool bad = false;
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int c = 0; c < W / kPer; ++c) {
      const uint4 chunk = s4[c];
      d4[c] = chunk;
      T vals[kPer];
      memcpy(vals, &chunk, sizeof(chunk));
#pragma unroll
      for (int k = 0; k < kPer; ++k) bad |= outside(vals[k], lo, hi);
    }
  } else {
    for (int w = 0; w < W; ++w) {
      const T x = src[w];
      dst[w] = x;
      bad |= outside(x, lo, hi);
    }
  }
  valid[r] = v;
  version[r] = b_newer ? bv : av;
  viol[r] = v && bad;
}

template <typename V, typename T>
int launch_typed(const void* a_valid, const void* a_ver, const void* a_pay,
                 const void* b_valid, const void* b_ver, const void* b_pay,
                 void* valid, void* version, void* payload, void* viol,
                 int64_t R, int W, float lo, float hi, int vec,
                 cudaStream_t stream) {
  const int64_t blocks = (R + kThreads - 1) / kThreads;
  const auto kernel = vec ? lattice_merge_kernel<V, T, true>
                          : lattice_merge_kernel<V, T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a_valid), static_cast<const V*>(a_ver),
      static_cast<const T*>(a_pay), static_cast<const uint8_t*>(b_valid),
      static_cast<const V*>(b_ver), static_cast<const T*>(b_pay),
      static_cast<uint8_t*>(valid), static_cast<V*>(version),
      static_cast<T*>(payload), static_cast<uint8_t*>(viol), R, W, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_payload(int pay_kind, const void* a_valid, const void* a_ver,
                   const void* a_pay, const void* b_valid, const void* b_ver,
                   const void* b_pay, void* valid, void* version,
                   void* payload, void* viol, int64_t R, int W, float lo,
                   float hi, int vec, cudaStream_t stream) {
  switch (pay_kind) {
    case 0:
      return launch_typed<V, float>(a_valid, a_ver, a_pay, b_valid, b_ver,
                                    b_pay, valid, version, payload, viol, R,
                                    W, lo, hi, vec, stream);
    case 1:
      return launch_typed<V, __nv_bfloat16>(a_valid, a_ver, a_pay, b_valid,
                                            b_ver, b_pay, valid, version,
                                            payload, viol, R, W, lo, hi, vec,
                                            stream);
    case 2:
      return launch_typed<V, int32_t>(a_valid, a_ver, a_pay, b_valid, b_ver,
                                      b_pay, valid, version, payload, viol,
                                      R, W, lo, hi, vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ver_bytes: 4 (int32 stamps) or 8 (int64); pay_kind: 0 float32,
// 1 bfloat16, 2 int32; vec: 1 when each row is whole 16-byte chunks and
// the payload pointers are 16-byte aligned.
extern "C" int lattice_merge_launch(const void* a_valid, const void* a_ver,
                                    const void* a_pay, const void* b_valid,
                                    const void* b_ver, const void* b_pay,
                                    void* valid, void* version, void* payload,
                                    void* viol, int64_t R, int W, float lo,
                                    float hi, int ver_bytes, int pay_kind,
                                    int vec, void* stream) {
  if (R < 1 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ver_bytes == 8) {
    return launch_payload<int64_t>(pay_kind, a_valid, a_ver, a_pay, b_valid,
                                   b_ver, b_pay, valid, version, payload,
                                   viol, R, W, lo, hi, vec, s);
  }
  if (ver_bytes == 4) {
    return launch_payload<int32_t>(pay_kind, a_valid, a_ver, a_pay, b_valid,
                                   b_ver, b_pay, valid, version, payload,
                                   viol, R, W, lo, hi, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
