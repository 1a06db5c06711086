// The RWKV-6 WKV scan with data-dependent decay, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (_rwkv_kernel
// / rwkv6_scan_kernel). Per batch row b and head h, with the state S an
// [hd (k), hd (v)] float32 matrix starting at s0[b, h], for t = 0 .. T-1:
//   cur      = sum_k r_t[k] * (k_t[k] * u[h, k])
//   out_t[v] = sum_k r_t[k] * S[k, v] + cur * v_t[v]
//   S[k, v]  = S[k, v] * max(w_t[k], 1e-9) + k_t[k] * v_t[v]
// and s_T = S after the last token. r, k, v and out are float32 or
// bfloat16; w, u, s0 and s_T are float32; all arithmetic is float32 on the
// float32 cores (no TF32: the reference's float32 tolerances are 1e-3 on
// the output and 2e-4 on the state).
//
// What bounds it on this card: float32 operations, a little above the
// bytes, at the serving path's shapes (rwkv6-3b: B 8, T 467, H 40, hd 64):
// the chunked form needs some 4 hd^2 operations a token and head (40 us at
// 67 TFLOP/s; the 125 MB of r, k, v bf16, w f32, out, s0 and s_T take
// 37 us). A token-by-token walk has T dependent steps a block; this kernel
// takes the chunked form of the TPU kernel, ceil(T / C) steps of C = 16
// tokens, all of whose work is small dense products. Per chunk, with
// cum = cumsum(log max(w, 1e-9)) over the chunk (inclusive) and
// cumx = cum - log w (exclusive):
//   out_i  = (r_i exp(cumx_i)) S + sum_{j<i} A_ij v_j + (r_i . (u k_i)) v_i
//   A_ij   = sum_k r_ik k_jk exp(cumx_ik - cum_jk)            (j < i)
//   S      = exp(cum_last) S + sum_j (k_j exp(cum_last - cum_j))^T v_j
// No exponent there is positive (w <= 1), and the mask sits inside: A_ij is
// formed only for j < i. The factored form r_i e^cumx_i . k_j e^-cum_j
// would overflow float32 where w sits at its clamp (16 tokens of 1e-9 give
// cum = -331), so it is used only for a chunk whose cumulative products
// all lie in [1e-30, 1e30] (every factor then in range; then the decays are
// cumulative products and one reciprocal, no log or exp). Any other chunk
// (w near the clamp) takes the masked form above, an exp a term.
//
// Design: the columns of S are independent (out[:, v] and S[:, v] read
// only column v), so a block owns one (b, h) and a slice of 32 columns
// (hd / 32 slices; all hd for hd <= 32): 640 blocks of 4 warps for the
// serving shape, five a streaming multiprocessor, one wave. Each slice
// recomputes the chunk's decays and its [C, C] scores, about 15% of its
// operations at hd 64. A chunk's r, k, w and v are loaded into registers
// while the last chunk computes (a thread holds one column k of 8
// consecutive tokens at hd 64, so the cumulative products of w start in
// registers and only the groups' totals cross threads), then staged in
// shared memory as float32, rows padded so the float4 reads of a warp hit
// distinct banks. The block's state slice lives in registers (a 4 x 4
// tile a thread at hd 64) and is mirrored in shared memory for the output
// product. Every product is register-blocked: the output's sums over S's
// rows and the chunk's tokens are split over the 4 warps (a lane 4 tokens
// x 4 columns; the partials meet in shared memory), the state update is a
// 4 x 4 tile a thread. A ragged last chunk is padded with r = k = v = 0
// and w = 1, which changes nothing, and rows past T are never written.
// Five block barriers a chunk (six in the masked form) and the slices'
// repeated work keep it above its bound (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;           // tokens a chunk (C)
constexpr int kThreads = 8 * kChunk; // 8 threads a token of the chunk
constexpr int kSliceMax = 32;        // state columns a block
constexpr float kLo = 1e-30f;        // the factored form's range of the
constexpr float kHi = 1e30f;         //   chunk's cumulative products

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive floats from shared memory (N = 1, 2, 4 or 8; p aligned to
// min(N, 4) floats)
template <int N>
__device__ __forceinline__ void ldv(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      x[i] = t.x;
      x[i + 1] = t.y;
      x[i + 2] = t.z;
      x[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

// N consecutive floats to shared memory, aligned as for ldv
template <int N>
__device__ __forceinline__ void stv(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// N consecutive outputs (N = 1, 2 or 4; p aligned to N elements)
template <int N>
__device__ __forceinline__ void put(float* p, const float (&x)[N]) {
  stv<N>(p, x);
}
template <int N>
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&x)[N]) {
  if constexpr (N == 1) {
    *p = __float2bfloat16(x[0]);
  } else {
    uint32_t two[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 y = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      two[i] = *reinterpret_cast<const uint32_t*>(&y);
    }
    if constexpr (N == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(two[0], two[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = two[0];
  }
}

template <int HD>
struct Shape {
  static constexpr int kP = HD + 4;                     // padded row
  static constexpr int kTp = kChunk + 4;                // padded token row
  static constexpr int kVs = HD < kSliceMax ? HD : kSliceMax;
  static constexpr int kSlices = HD / kVs;
  static constexpr int kCpt = kVs / 8;                  // columns a thread
  static constexpr int kRpt = HD * 8 > kThreads ? HD * 8 / kThreads : 1;
                                                        // state rows a thread
  // resident blocks asked of ptxas: at hd 64, five a streaming
  // multiprocessor hold the serving shape's 640 blocks in one wave (at
  // the cost of a few spilled registers); hd 128 would spill hundreds
  static constexpr int kMinBlocks = HD <= 64 ? 5 : 1;
  // r, k, w [C][kP], later the out partials [4][C][kVs]
  static constexpr int kRkw = 3 * kChunk * kP > 4 * kChunk * kVs
                                  ? 3 * kChunk * kP : 4 * kChunk * kVs;
  // shared floats: r, k, w; rd, kf, kd [C][kP]; v [C][kVs]; S [HD][kVs];
  // rd transposed [HD][kTp]; A transposed [C][kTp]; u, dec [HD]; the
  // groups' products [kThreads]
  static constexpr int kFloats = kRkw + 3 * kChunk * kP + kChunk * kVs
                                 + HD * kVs + (HD + kChunk) * kTp + 2 * HD
                                 + kThreads;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Shape<HD>::kMinBlocks)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ out, float* __restrict__ sT, int Tn, int H) {
  using Sh = Shape<HD>;
  constexpr int P = Sh::kP, Vs = Sh::kVs, CPT = Sh::kCpt, RPT = Sh::kRpt;
  constexpr int Tp = Sh::kTp;
  constexpr int C = kChunk;
  extern __shared__ __align__(16) float sm[];
  float* R = sm;                                  // r
  float* K = R + C * P;                           // k
  float* W = K + C * P;                           // max(w, 1e-9), then the
                                                  //   log cumsum (masked form)
  float* PART = sm;                               // [4][C][Vs], over r, k, w
  float* RD = sm + Sh::kRkw;                      // r_i exp(cumx_i)
  float* KF = RD + C * P;                         // k_j exp(-cum_j) (factored)
  float* KD = KF + C * P;                         // k_j exp(cum_last - cum_j)
  float* V = KD + C * P;                          // [C][Vs]: the slice of v
  float* S = V + C * Vs;                          // [HD][Vs]: the state slice
  float* RDT = S + HD * Vs;                       // [HD][Tp]: RD transposed
  float* AT = RDT + HD * Tp;                      // [C][Tp]: the scores A^T
  float* U = AT + C * Tp;                         // [HD]: u[h]
  float* DEC = U + HD;                            // [HD]: exp(cum_last)
  float* TOT = DEC + HD;                          // [kThreads]: group products

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / Sh::kSlices;
  const int v0 = (blockIdx.x % Sh::kSlices) * Vs;   // the slice's columns
  const int b = bh / H;
  const int h = bh % H;
  const int ti = tid / 8;                           // a token of the chunk
  const int cg = tid % 8;
  const int c0 = cg * CPT;                          // columns within slice
  const int kr0 = ti * RPT;                         // state rows
  const bool owner = kr0 < HD;                      // small hd: a part

  for (int d = tid; d < HD; d += kThreads) U[d] = u[h * HD + d];
  for (int e = tid; e < C * Tp; e += kThreads) AT[e] = 0.f;   // j > i stay 0
  // the thread's score A_ij, j < i: the C (C - 1) / 2 of them row by row,
  // one a thread
  static_assert(kChunk * (kChunk - 1) / 2 <= kThreads, "a score a thread");
  int ai = 1;
  while (ai * (ai + 1) / 2 <= tid) ++ai;
  const int aj = tid - ai * (ai - 1) / 2;
  const bool scorer = ai < C;
  const float* s_in = s0 + static_cast<int64_t>(bh) * HD * HD;
  float st[RPT][CPT];
  if (owner) {
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        st[a][c] = s_in[(kr0 + a) * HD + v0 + c0 + c];
        S[(kr0 + a) * Vs + c0 + c] = st[a][c];
      }
  }

  const int64_t step = static_cast<int64_t>(H) * HD;     // between tokens
  const int64_t base = (static_cast<int64_t>(b) * Tn * H + h) * HD;
  // a thread holds column kc of L consecutive tokens of the chunk (group
  // grp of G): its r, k, w, and the running product of its w
  constexpr int G = kThreads / HD;
  constexpr int L = C / G;
  const int kc = tid % HD;
  const int grp = tid / HD;
  // chunk t0's inputs into registers, as loaded (nothing waits on the
  // loads until the next chunk is staged); past T, r = k = v = 0, w = 1
  T lr[L], lk[L], lv[CPT];
  float lw[L];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int n = 0; n < L; ++n) {
      const int i = t0 + grp * L + n;
      const bool ok = i < Tn;
      const int64_t g = base + i * step + kc;
      lr[n] = ok ? r[g] : T(0.f);
      lk[n] = ok ? k[g] : T(0.f);
      lw[n] = ok ? w[g] : 1.f;
    }
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
      const int idx = tid + kThreads * n;           // C * Vs = CPT * kThreads
      const bool ok = t0 + idx / Vs < Tn;
      lv[n] = ok ? v[base + (t0 + idx / Vs) * step + v0 + idx % Vs] : T(0.f);
    }
  };

  if (Tn > 0) fetch(0);
  for (int t0 = 0; t0 < Tn; t0 += C) {
    float pr[L], pk[L], pw[L], run[L];              // run: the group's products
#pragma unroll
    for (int n = 0; n < L; ++n) {
      pr[n] = widen(lr[n]);
      pk[n] = widen(lk[n]);
      pw[n] = fmaxf(lw[n], 1e-9f);
      run[n] = (n ? run[n - 1] : 1.f) * pw[n];
    }
    __syncthreads();                                // the last chunk is used
#pragma unroll
    for (int n = 0; n < L; ++n) {
      const int at = (grp * L + n) * P + kc;
      R[at] = pr[n];
      K[at] = pk[n];
      W[at] = pw[n];
    }
#pragma unroll
    for (int n = 0; n < CPT; ++n) V[tid + kThreads * n] = widen(lv[n]);
    TOT[tid] = run[L - 1];
    __syncthreads();

    // 1. the decays: cumulative products, the earlier groups' first
    float before = 1.f, last = 1.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const float t = TOT[gg * HD + kc];
      if (gg < grp) before *= t;
      last *= t;
    }
    float lo = last, hi = last, prev = before, rd[L];
#pragma unroll
    for (int n = 0; n < L; ++n) {
      const int at = (grp * L + n) * P + kc;
      const float cp = before * run[n];             // the product to i
      const float inv = __fdividef(1.f, cp);
      rd[n] = pr[n] * prev;
      RD[at] = rd[n];
      KF[at] = pk[n] * inv;
      KD[at] = pk[n] * (last * inv);
      prev = cp;
      lo = fminf(lo, cp);
      hi = fmaxf(hi, cp);
    }
    stv<L>(RDT + kc * Tp + grp * L, rd);
    if (grp == 0) DEC[kc] = last;
    if (t0 + C < Tn) fetch(t0 + C);                 // lands while this computes
    const bool masked = __syncthreads_or(!(lo >= kLo && hi <= kHi));
    if (masked) {                                   // the exponent form
      if (tid < HD) {
        float cum = 0.f;
        for (int i = 0; i < C; ++i) {
          RD[i * P + tid] = R[i * P + tid] * expf(cum);
          RDT[tid * Tp + i] = RD[i * P + tid];
          cum += logf(W[i * P + tid]);
          W[i * P + tid] = cum;
        }
        for (int j = 0; j < C; ++j)
          KD[j * P + tid] = K[j * P + tid] * expf(cum - W[j * P + tid]);
        DEC[tid] = expf(cum);
      }
      __syncthreads();
    }

    // 2. the scores A_ij (j < i) and the bonus term on the diagonal
    if (scorer) {
      float a = 0.f;
      if (!masked) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};       // four chains, not one
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          float x[4], y[4];
          ldv<4>(x, RD + ai * P + d);
          ldv<4>(y, KF + aj * P + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) part[c] += x[c] * y[c];
        }
        a = (part[0] + part[1]) + (part[2] + part[3]);
      } else {
        for (int d = 0; d < HD; ++d)
          a += R[ai * P + d] * K[aj * P + d] *
               expf(W[(ai - 1) * P + d] - W[aj * P + d]);
      }
      AT[aj * Tp + ai] = a;
    }
    float cur = 0.f;
    for (int d = cg; d < HD; d += 8)
      cur += R[ti * P + d] * (U[d] * K[ti * P + d]);
    cur += __shfl_xor_sync(0xffffffffu, cur, 1);
    cur += __shfl_xor_sync(0xffffffffu, cur, 2);
    cur += __shfl_xor_sync(0xffffffffu, cur, 4);
    if (cg == 0) AT[ti * Tp + ti] = cur;
    __syncthreads();

    // 3. out_i = rd_i S + sum_{j<=i} A_ij v_j, the sums split over the
    // warps: warp w takes a quarter of S's rows and of the chunk's tokens,
    // a lane 4 tokens x CPT columns; the partials meet in shared memory
    {
      constexpr int KW = HD / 4, JW = C / 4;
      const int warp = tid / 32;
      const int i0 = 4 * ((tid % 32) / 8);
      float acc[4][CPT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[a][c] = 0.f;
      auto step = [&](const float* xs, const float* ys) {
        float x[4], y[CPT];
        ldv<4>(x, xs + i0);
        ldv<CPT>(y, ys + c0);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[a][c] += x[a] * y[c];
      };
#pragma unroll 4
      for (int q = warp * KW; q < (warp + 1) * KW; ++q)
        step(RDT + q * Tp, S + q * Vs);             // rd S
#pragma unroll
      for (int j = warp * JW; j < (warp + 1) * JW; ++j)
        step(AT + j * Tp, V + j * Vs);              // A v
#pragma unroll
      for (int a = 0; a < 4; ++a)
        stv<CPT>(PART + (warp * C + i0 + a) * Vs + c0, acc[a]);
    }
    __syncthreads();
    if (t0 + ti < Tn) {                             // beside the state update
      float o[CPT], x[CPT];
      ldv<CPT>(o, PART + ti * Vs + c0);
#pragma unroll
      for (int wp = 1; wp < 4; ++wp) {
        ldv<CPT>(x, PART + (wp * C + ti) * Vs + c0);
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[c] += x[c];
      }
      put<CPT>(out + base + (t0 + ti) * step + v0 + c0, o);
    }

    // 4. S = dec S + kd^T v on the thread's RPT x CPT tile
    if (owner) {
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float dec = DEC[kr0 + a];
#pragma unroll
        for (int c = 0; c < CPT; ++c) st[a][c] *= dec;
      }
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        float x[RPT], y[CPT];
        ldv<RPT>(x, KD + j * P + kr0);
        ldv<CPT>(y, V + j * Vs + c0);
#pragma unroll
        for (int a = 0; a < RPT; ++a)
#pragma unroll
          for (int c = 0; c < CPT; ++c) st[a][c] += x[a] * y[c];
      }
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < CPT; ++c) S[(kr0 + a) * Vs + c0 + c] = st[a][c];
    }
  }

  if (owner) {
    float* s_out = sT + static_cast<int64_t>(bh) * HD * HD;
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        s_out[(kr0 + a) * HD + v0 + c0 + c] = st[a][c];
  }
}

template <typename T, int HD>
int launch_hd(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, void* out, float* sT, int B,
              int Tn, int H, cudaStream_t stream) {
  using Sh = Shape<HD>;
  constexpr int bytes = Sh::kFloats * 4;
  static bool sized = false;                        // once an instance
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const unsigned blocks = static_cast<unsigned>(B) * H * Sh::kSlices;
  rwkv6_scan_kernel<T, HD><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(out), sT, Tn, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* s0, void* out, float* sT,
                 int B, int Tn, int H, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8:
      return launch_hd<T, 8>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    case 16:
      return launch_hd<T, 16>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    case 32:
      return launch_hd<T, 32>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    case 64:
      return launch_hd<T, 64>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    case 128:
      return launch_hd<T, 128>(r, k, v, w, u, s0, out, sT, B, Tn, H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
