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
// in float32: a running max m (from finfo(float32).min), denominator l and
// accumulator acc a row, a tile of keys at a time, and the row is
// acc / max(l, 1e-30) rounded to the output's type (q's), as the TPU
// kernel finishes it.
//
// Two routes behind one entry, chosen by the inputs' dtype (`kind`):
//
// bfloat16 (the serving path): the tensor-core kernel. What bounds it on
// this card: at the serving path's shapes (S about 500, hd 64) the bytes
// (q, k, v read once, out written once) and the bf16 tensor-core
// operations take about the same least time, some 5 us, so the design
// keeps every product on the tensor cores and every intermediate on the
// chip. It is FlashAttention-2's structure:
//   * one block of 4 warps per (b * H + h, tile of 64 query rows), 16 rows
//     a warp; the blocks run longest first over the whole grid (causal
//     rows far down the sequence see the most keys), so the short ones
//     fill the tail. The query tile is loaded once and each warp holds its
//     rows as mma A fragments in registers (ldmatrix);
//   * key and value tiles of 64 rows x hd bf16 in shared memory, rows
//     padded by 16 bytes so ldmatrix reads 8 rows on 8 distinct bank
//     quads; two stages, filled with cp.async, so tile j + 1 loads while
//     tile j is multiplied. Rows past S are zero-filled, never read;
//   * S = Q K^T with mma.sync m16n8k16 bf16 -> float32; the softmax scale
//     (times log2 e, for exp2f) is applied to the float32 scores, inside
//     each exponent (one fma: s c - m c, with m the row's running max);
//   * the online softmax stays in registers: a thread holds two rows'
//     scores, and the row max takes two shuffles across its quad (the
//     denominator's partial sums are reduced once, at the end);
//   * P is rounded to bf16 straight from the score accumulators into the
//     A fragments of the P V product; V is read with ldmatrix.trans;
//   * O stays in float32 registers until the row is divided and written;
//   * under causal masking a block stops at its last row's diagonal, so
//     tiles wholly above it are never loaded, and a warp skips the 16-key
//     steps past its own last row. Only a diagonal tile and the ragged
//     last tile (S need not be a multiple of 64: the serving path meets
//     S = 467 and 509) are masked; a whole tile runs the same loops
//     without a branch. A warp whose rows all lie past S computes nothing,
//     and query rows past S are never written;
//   * the key/value head is read by index: nothing is replicated. Each
//     block serves one query head; the g heads that share a key/value
//     tile meet it in the L2 cache (a block serving all g heads of a tile
//     was measured slower, PERF.md).
//
// float32: the float32-core kernel. TF32 keeps about three decimal digits
// and cannot hold the reference's float32 tolerance (2e-5), so float32
// inputs (the reduced float32 models served against the CPU) keep exact
// float32 products: one block per (b * H + h, tile of 32 query rows), four
// threads sharing a query row, each holding a quarter of its head dims
// (float4 chunks c = lane + 4 i, free of bank conflicts) and two shuffles
// summing a score; key and value tiles of 32 rows staged in shared memory.
// It is operations-bound on the float32 cores.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

// ---- float32 route -------------------------------------------------------

constexpr int kRowsPerBlock = 32;                   // query rows a block
constexpr int kLanesPerRow = 4;                     // threads sharing a row
constexpr int kThreads = kRowsPerBlock * kLanesPerRow;
constexpr int kTileKf = 32;                         // key rows a tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int H, int KV,
                           int causal, float scale) {
  constexpr int kChunks = HD / 4;                   // float4 chunks a row
  constexpr int kMine = kChunks / kLanesPerRow;     // chunks a thread holds
  __shared__ float4 ks[kTileKf][kChunks];
  __shared__ float4 vs[kTileKf][kChunks];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x % kLanesPerRow;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row = row0 + threadIdx.x / kLanesPerRow;
  const bool live = row < S;

  const float* qrow = q + ((static_cast<int64_t>(b) * S + (live ? row : 0))
                           * H + h) * HD;
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
  const float* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  for (int k0 = 0; k0 < k_end; k0 += kTileKf) {
    __syncthreads();                                // the last tile is used
    for (int idx = threadIdx.x; idx < kTileKf * kChunks; idx += kThreads) {
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

    float s[kTileKf];
    unsigned ok = 0u;
    float tile_max = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kTileKf; ++j) {
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
    for (int j = 0; j < kTileKf; ++j) {
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
  float* orow = out + ((static_cast<int64_t>(b) * S + row) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    *reinterpret_cast<float4*>(orow + 4 * (lane + kLanesPerRow * i)) =
        make_float4(acc[i].x / den, acc[i].y / den, acc[i].z / den,
                    acc[i].w / den);
  }
}

// ---- bfloat16 route: the tensor cores --------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTileK = 64;                          // key rows a tile
constexpr int kPad = 8;                             // bf16 a shared row pads

constexpr int kTileQ = 64;                          // query rows a block
constexpr int kTcThreads = 2 * kTileQ;              // 4 warps, 16 rows each
constexpr int kStages = 2;                          // key/value tiles held

// shared bytes: the query tile and the stages of key and value tiles
constexpr int tc_smem_bytes(int hd) {
  return (kTileQ + 2 * kStages * kTileK) * (hd + kPad) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          int S, int H, int KV, int causal,
                          float scale_log2) {
  constexpr int kStride = HD + kPad;                // bf16 a shared row
  constexpr int kChunks = HD / 8;                   // 16-byte chunks a row
  constexpr int kSteps = HD / 16;                   // mma k-steps over hd
  constexpr int kNs = kTileK / 8;                   // score n-tiles
  constexpr int kNo = HD / 8;                       // output n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);         // [kTileQ][kStride]
  bf16* ks = qs + kTileQ * kStride;           // [kStages][kTileK][kStride]
  bf16* vs = ks + kStages * kTileK * kStride; // [kStages][kTileK][kStride]

  // blocks run longest first: the last query tiles of every head (the
  // most keys under causal masking), then the next
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const int n_bh = gridDim.x / n_qt;
  const int bh = blockIdx.x % n_bh;
  const int row0 = (n_qt - 1 - blockIdx.x / n_bh) * kTileQ;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;                           // fragment row
  const int t4 = lane % 4;                          // fragment column pair
  const int mi = lane / 8;                          // ldmatrix: its matrix
  const int wrow = row0 + 16 * warp;                // the warp's first row
  const bool idle = wrow >= S;                      // wholly past S

  const int64_t qstep = static_cast<int64_t>(H) * HD;
  const int64_t kvstep = static_cast<int64_t>(KV) * HD;
  const bf16* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  // rows r0 .. r0 + 63 of a [S, hd] view into shared memory, past S zero
  auto stage = [&](bf16* dst, const bf16* src, int64_t step, int r0) {
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kTcThreads) {
      const int rr = idx / kChunks;
      const int c = idx % kChunks;
      const bool ok = r0 + rr < S;
      cp_async16(dst + rr * kStride + 8 * c,
                 src + (ok ? r0 + rr : 0) * step + 8 * c, ok);
    }
  };

  const int last = min(row0 + kTileQ, S) - 1;
  const int k_end = causal ? last + 1 : S;          // keys the block sees
  const int n_tiles = (k_end + kTileK - 1) / kTileK;

  // a commit group a tile (the query tile rides with the first), empty
  // past the last
  auto stage_tile = [&](int j) {
    if (j < n_tiles) {
      const int at = (j % kStages) * kTileK * kStride;
      stage(ks + at, kb, kvstep, j * kTileK);
      stage(vs + at, vb, kvstep, j * kTileK);
    }
    cp_async_commit();
  };
  stage(qs, q + (static_cast<int64_t>(b) * S * H + h) * HD, qstep, row0);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) stage_tile(j);

  uint32_t qf[kSteps][4];
  float o[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX};                // rows g and g + 8,
                                                    //   unscaled
  float l[2] = {0.f, 0.f};                          // this thread's share

  for (int j = 0; j < n_tiles; ++j) {
    stage_tile(j + kStages - 1);                    // a later tile loads
    cp_async_wait<kStages - 1>();                   // tile j has landed
    __syncthreads();
    if (j == 0 && !idle) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + (16 * warp + 8 * (mi & 1) + lane % 8)
                                     * kStride + 16 * kk + 8 * (mi >> 1));
    }
    const bf16* kt = ks + (j % kStages) * kTileK * kStride;
    const bf16* vt = vs + (j % kStages) * kTileK * kStride;
    const int k0 = j * kTileK;
    // the tile's keys the warp needs: none past S, none past its last row
    int k_lim = min(kTileK, S - k0);
    if (causal) k_lim = min(k_lim, wrow + 16 - k0);

    // one tile's work; kFull: every key needed and none masked, so the
    // loops run without a branch
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      // scores of the warp's 16 rows against the keys it needs
      float s[kNs][4];
#pragma unroll
      for (int n = 0; n < kNs; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
        for (int np = 0; np < kNs / 2; ++np) {
          if (!kFull && 16 * np >= k_lim) break;
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (16 * np + 8 * (mi >> 1) + lane % 8) * kStride
                              + 16 * kk + 8 * (mi & 1));
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // mask a diagonal or ragged tile (a key skipped above lies past S or
      // past every row of the warp); the row max is taken on the unscaled
      // float32 scores, the scale enters each exponent in float32
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kNs; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e];
          if (!kFull) {
            const int col = k0 + 8 * n + 2 * t4 + (e & 1);
            const int row = wrow + g + 8 * (e >> 1);
            if (col >= S || (causal && col > row)) x = -INFINITY;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      const float mc[2] = {m[0] * scale_log2, m[1] * scale_log2};
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < kNs; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[n][e], scale_log2, -mc[e >> 1]));
          l[e >> 1] += p;
          s[n][e] = p;
        }
      }

      // O += P V: P's accumulators become the A fragments, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        if (!kFull && 16 * kk >= k_lim) break;
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < kNo / 2; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (16 * kk + 8 * (mi & 1) + lane % 8)
                                    * kStride + 16 * dp + 8 * (mi >> 1));
          mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    };
    if (!idle && k_lim > 0) {
      if (k_lim < kTileK || (causal && k0 + kTileK - 1 > wrow))
        tile(std::false_type{});
      else
        tile(std::true_type{});
    }
    __syncthreads();                                // the stage is free
  }

  if (idle) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow + g + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((static_cast<int64_t>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t4) =
          pack_bf16(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int causal, float scale, int kind,
              cudaStream_t stream) {
  if (kind == 0) {
    const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, B * H);
    flash_attention_f32_kernel<HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
        causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
  static bool sized = false;                        // once a head dim
  constexpr int bytes = tc_smem_bytes(HD);
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int n_qt = (S + kTileQ - 1) / kTileQ;
  const float log2e = 1.4426950408889634f;
  flash_attention_tc_kernel<HD><<<n_qt * B * H, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, causal,
      scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 float32 (the float32-core kernel), 1 bfloat16 (the tensor-core
// kernel); q, k, v and out share it. hd: 16, 32, 64 or 128; H a multiple
// of KV; every pointer 16-byte aligned (the wrapper checks); scale is
// hd ** -0.5 rounded to float32 (the reference's weakly typed Python
// float), applied to the float32 scores (to q in float32 on the float32
// route).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      float scale, int kind, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || B * H > 65535 ||
      (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(q, k, v, out, B, S, H, KV, causal, scale, kind, s);
    case 32:
      return launch_hd<32>(q, k, v, out, B, S, H, KV, causal, scale, kind, s);
    case 64:
      return launch_hd<64>(q, k, v, out, B, S, H, KV, causal, scale, kind, s);
    case 128:
      return launch_hd<128>(q, k, v, out, B, S, H, KV, causal, scale, kind,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
