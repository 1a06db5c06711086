// The RWKV-6 WKV scan with data-dependent decay, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (_rwkv_kernel
// / rwkv6_scan_kernel). Per batch row b and head h, with the state S an
// [hd (k), hd (v)] float32 matrix starting at s0[b, h], for t = 0 .. T-1:
//   cur      = sum_k r_t[k] * (k_t[k] * u[h, k])
//   out_t[v] = sum_k r_t[k] * S[k, v] + cur * v_t[v]
//   S[k, v]  = S[k, v] * max(w_t[k], 1e-9) + k_t[k] * v_t[v]
// and s_T = S after the last token. The TPU kernel evaluates the same
// function chunkwise (a [C, C] masked product inside a chunk, the state
// carried between chunks, log w clamped at 1e-9); this kernel walks the
// recurrence token by token with the same clamp, so it takes any T (the
// TPU wrapper shrinks its chunk to a divisor of T: T = 509 gives chunk 1).
// r, k, v and out are float32 or bfloat16; w, u, s0 and s_T are float32;
// all arithmetic is float32.
//
// What bounds it on this card: bytes and float32 operations about equally
// at the serving path's shapes (rwkv6-3b: B 8, T 509, H 40, hd 64): some
// 136 MB (r, k, v bf16, w f32, out, s0 and s_T once) and 4 hd^2 operations
// a token and head, each about 40 us. The walk is sequential in t, so
// the parallelism is B * H * hd columns.
//
// Design: one block per (b, h) of 4 * hd threads. Thread (col, part) holds
// state rows k = part + 4 i of column col in registers (hd / 4 floats) and
// the matching bonus values; four neighbouring lanes share a column and two
// shuffles sum a column's product over them. Tokens are staged in shared
// memory a chunk at a time (2048 / hd tokens: 32 KB of r, k, v, w as
// float32, loaded with neighbouring threads on neighbouring addresses), so
// the walk over a chunk waits on no device-memory load. The state never
// leaves the registers until s_T is written.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 4;            // threads sharing a state column
constexpr int kStage = 2048;         // token x head-dim values staged a chunk

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD * kSplit)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ out, float* __restrict__ sT, int Tn, int H) {
  constexpr int kThreads = HD * kSplit;
  constexpr int kRows = HD / kSplit;            // state rows a thread holds
  constexpr int kChunk = kStage / HD;           // tokens staged at a time
  __shared__ float rs[kChunk][HD];
  __shared__ float ks[kChunk][HD];
  __shared__ float vs[kChunk][HD];
  __shared__ float ws[kChunk][HD];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int part = threadIdx.x % kSplit;
  const int col = threadIdx.x / kSplit;

  const float* s_in = s0 + static_cast<int64_t>(bh) * HD * HD;
  float st[kRows], ur[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    st[i] = s_in[(part + kSplit * i) * HD + col];
    ur[i] = u[h * HD + part + kSplit * i];
  }

  const int64_t step = static_cast<int64_t>(H) * HD;    // between tokens
  const int64_t base = (static_cast<int64_t>(b) * Tn * H + h) * HD;
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    const int n = min(kChunk, Tn - t0);
    __syncthreads();                                    // the last chunk is used
    for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
      const int tt = idx / HD;
      const int d = idx % HD;
      const int64_t g = base + (t0 + tt) * step + d;
      rs[tt][d] = widen(r[g]);
      ks[tt][d] = widen(k[g]);
      vs[tt][d] = widen(v[g]);
      ws[tt][d] = fmaxf(w[g], 1e-9f);
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      float o = 0.f;
      float cur = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float rk = rs[tt][part + kSplit * i];
        o += rk * st[i];
        cur += rk * (ks[tt][part + kSplit * i] * ur[i]);
      }
      o += __shfl_xor_sync(0xffffffffu, o, 1);
      o += __shfl_xor_sync(0xffffffffu, o, 2);
      cur += __shfl_xor_sync(0xffffffffu, cur, 1);
      cur += __shfl_xor_sync(0xffffffffu, cur, 2);
      const float vc = vs[tt][col];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kk = part + kSplit * i;
        st[i] = st[i] * ws[tt][kk] + ks[tt][kk] * vc;
      }
      if (part == 0) put(out + base + (t0 + tt) * step + col, o + cur * vc);
    }
  }

  float* s_out = sT + static_cast<int64_t>(bh) * HD * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) s_out[(part + kSplit * i) * HD + col] = st[i];
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* s0, void* out, float* sT,
                 int B, int Tn, int H, int hd, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const unsigned blocks = static_cast<unsigned>(B) * H;
  switch (hd) {
    case 8:
      rwkv6_scan_kernel<T, 8><<<blocks, 8 * kSplit, 0, stream>>>(
          rt, kt, vt, w, u, s0, ot, sT, Tn, H);
      break;
    case 16:
      rwkv6_scan_kernel<T, 16><<<blocks, 16 * kSplit, 0, stream>>>(
          rt, kt, vt, w, u, s0, ot, sT, Tn, H);
      break;
    case 32:
      rwkv6_scan_kernel<T, 32><<<blocks, 32 * kSplit, 0, stream>>>(
          rt, kt, vt, w, u, s0, ot, sT, Tn, H);
      break;
    case 64:
      rwkv6_scan_kernel<T, 64><<<blocks, 64 * kSplit, 0, stream>>>(
          rt, kt, vt, w, u, s0, ot, sT, Tn, H);
      break;
    case 128:
      rwkv6_scan_kernel<T, 128><<<blocks, 128 * kSplit, 0, stream>>>(
          rt, kt, vt, w, u, s0, ot, sT, Tn, H);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 float32, 1 bfloat16 (r, k, v and out share it); hd: 8, 16, 32,
// 64 or 128. r, k, v, w, out [B, T, H, hd]; u [H, hd]; s0, sT [B, H, hd,
// hd] (k rows, v columns), all contiguous.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* out, void* sT, int B, int Tn, int H,
                                 int hd, int kind, void* stream) {
  if (B < 1 || H < 1 || Tn < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* tf = static_cast<float*>(sT);
  if (kind == 0)
    return launch_typed<float>(r, k, v, wf, uf, sf, out, tf, B, Tn, H, hd, s);
  if (kind == 1)
    return launch_typed<__nv_bfloat16>(r, k, v, wf, uf, sf, out, tf, B, Tn,
                                       H, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
