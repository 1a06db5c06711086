// Causal or full grouped-query attention with an online softmax, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_attn_kernel / flash_attention_kernel). For q [B, S, H, hd] and k, v
// [B, S, KV, hd] in the reference's layout, with g = H / KV and query head
// h reading key/value head h / g (the heads need not divide evenly into
// warps: smollm has 15 query heads on 5 key/value heads):
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / g] / sqrt(hd))
//                  * v[b, j, h / g]
// over j <= i when causal, over every j otherwise. The softmax runs online
// in float32: a running max m, denominator l and accumulator acc a row, a
// tile of keys at a time, and the row is acc / max(l, 1e-30) rounded to
// the output's type (q's), as the TPU kernel finishes it.
//
// What bounds it on this card: at the serving path's shapes (S about 500,
// hd 64, bf16) the bytes (q, k, v read once, out written once) and the
// tensor-core operations take about the same least time, some 5 us. This
// kernel is the simple, right first version: it runs the products on the
// float32 cores, not the tensor cores, so operations bound it, far above
// that least time. Tensor cores (wgmma), TMA and a k/v tile ring are the
// later work that closes the gap.
//
// Design: one block per (b * H + h, tile of 32 query rows). Four threads
// share a query row: each holds a quarter of the row's head dims (float4
// chunks c = lane + 4 i, so the four read neighbouring 16-byte words of a
// shared-memory key row, free of bank conflicts) and the matching quarter
// of the accumulator, and two shuffles sum a score over the four. Key and
// value tiles of 32 rows of the block's one key/value head are staged in
// shared memory as float32; the key/value heads are never replicated. Under
// causal masking the block stops at its last row's diagonal, so tiles
// wholly above the diagonal are never read. A ragged last tile (S need not
// be a multiple of 32: the serving path meets S = 509, a prime) is masked,
// key rows past S are never read and query rows past S are never written.
// A masked score counts for nothing; every causal row has its diagonal, so
// no row is wholly masked.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 32;                   // query rows a block
constexpr int kLanesPerRow = 4;                     // threads sharing a row
constexpr int kThreads = kRowsPerBlock * kLanesPerRow;
constexpr int kTileK = 32;                          // key rows a tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x.x, x.y);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, int causal, float scale) {
  constexpr int kChunks = HD / 4;                   // float4 chunks a row
  constexpr int kMine = kChunks / kLanesPerRow;     // chunks a thread holds
  __shared__ float4 ks[kTileK][kChunks];
  __shared__ float4 vs[kTileK][kChunks];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x % kLanesPerRow;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row = row0 + threadIdx.x / kLanesPerRow;
  const bool live = row < S;

  const T* qrow = q + ((static_cast<int64_t>(b) * S + (live ? row : 0)) * H
                       + h) * HD;
  float4 qc[kMine], acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const float4 x = load4(qrow + 4 * (lane + kLanesPerRow * i));
    qc[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -FLT_MAX;
  float l = 0.f;

  const int last = min(row0 + kRowsPerBlock, S) - 1;
  const int k_end = causal ? last + 1 : S;          // keys the block sees
  const int64_t step = static_cast<int64_t>(KV) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  for (int k0 = 0; k0 < k_end; k0 += kTileK) {
    __syncthreads();                                // the last tile is used
    for (int idx = threadIdx.x; idx < kTileK * kChunks; idx += kThreads) {
      const int j = idx / kChunks;
      const int c = idx % kChunks;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vf = kf;
      if (k0 + j < S) {
        kf = load4(kb + (k0 + j) * step + 4 * c);
        vf = load4(vb + (k0 + j) * step + 4 * c);
      }
      ks[j][c] = kf;
      vs[j][c] = vf;
    }
    __syncthreads();

    float s[kTileK];
    unsigned ok = 0u;
    float tile_max = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kMine; ++i)
        d += dot4(qc[i], ks[j][lane + kLanesPerRow * i]);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int col = k0 + j;
      if (col < S && (!causal || col <= row)) {
        ok |= 1u << j;
        tile_max = fmaxf(tile_max, d);
      }
      s[j] = d;
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float p = (ok >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 x = vs[j][lane + kLanesPerRow * i];
        acc[i].x += p * x.x;
        acc[i].y += p * x.y;
        acc[i].z += p * x.z;
        acc[i].w += p * x.w;
      }
    }
    m = m_new;
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* orow = out + ((static_cast<int64_t>(b) * S + row) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    store4(orow + 4 * (lane + kLanesPerRow * i),
           make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                       acc[i].w / den));
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int KV, int hd, int causal,
                 float scale, cudaStream_t stream) {
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, B * H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 16:
      flash_attention_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, causal, scale);
      break;
    case 32:
      flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, causal, scale);
      break;
    case 64:
      flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, causal, scale);
      break;
    case 128:
      flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, ot, S, H, KV, causal, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 float32, 1 bfloat16 (q, k, v and out share it); hd: 16, 32, 64
// or 128; H a multiple of KV; every pointer 16-byte aligned (the wrapper
// checks); scale is hd ** -0.5 rounded to float32 (the reference's
// weakly typed Python float), applied to q in float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      float scale, int kind, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_typed<float>(q, k, v, out, B, S, H, KV, hd, causal, scale,
                               s);
  if (kind == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal,
                                       scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
