// Sequence-packed multi-head self-attention on fused qkv, for Hopper
// (sm_90a): a token attends exactly the tokens that carry its segment id.
//
// Replaces the TPU kernel
//   pathway_tpu/ops/fused_attention.py::_packed_call (body _seg_kernel) -- B4
//
// Several chunks share one row of up to 512 tokens, back to back; segment
// ids are unique across rows and -1 marks padding. The TPU kernel packs
// 256-token blocks and adds BLOCK_OFF where ids differ, to keep its 128-wide
// matrix unit fed. Here one block owns (query tile of 32 rows, head, row):
//
//   * the mask is seg_q == seg_k, the TPU kernel's own rule, so the result
//     is exact for any ids, contiguous or not;
//   * a 16-key tile whose [min, max] id range misses the query tile's range
//     of live ids holds no key any of those queries may attend: it is never
//     loaded, scored or multiplied (an exact skip). With contiguous
//     segments of 64-256 tokens a query tile touches one to three segments,
//     so most of the row's 32 key tiles drop out;
//   * query rows with segment -1 are never read downstream; the kernel
//     writes zeros there (the TPU kernel leaves finite garbage), and a tile
//     of only such rows does no work at all.
//
// Softmax runs in f32 over the matching keys, the probabilities are rounded
// to bf16 and multiplied with V accumulating in f32, ctx is written in bf16:
// the rounding points of masked_attention.cu and of the TPU kernel.
//
// Bound on this card: at the main path's shapes (rows of 512, head dim 32,
// segments of 64-256 tokens) the work that must be done is 4*h*hd*sum(len^2)
// operations against qkv read once and ctx written once, which is bytes-
// bound. The block re-reads its live key tiles from L2 and keeps scores and
// probabilities in shared memory (never in device memory), with the tensor
// cores (WMMA bf16) for both products; one block per SM at a 512-token row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QT = 32;  // query rows per block (4 warps)
constexpr int KT = 16;  // keys per tile (one WMMA column block)
constexpr int NO_SEG_LO = 0x7fffffff;
constexpr int NO_SEG_HI = -0x7fffffff - 1;

__host__ __device__ __forceinline__ size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

struct Layout {
  size_t q, k, v, sc, p, o, seg, live, total;
};

template <int HD>
__host__ __device__ __forceinline__ Layout layout_for(int Sp) {
  constexpr int LDH = HD + 8;
  Layout L;
  size_t off = 0;
  L.q = off;    off = align128(off + (size_t)QT * LDH * sizeof(bf16));
  L.k = off;    off = align128(off + (size_t)Sp * LDH * sizeof(bf16));
  L.v = off;    off = align128(off + (size_t)Sp * LDH * sizeof(bf16));
  L.sc = off;   off = align128(off + (size_t)QT * (Sp + 4) * sizeof(float));
  L.p = off;    off = align128(off + (size_t)QT * (Sp + 8) * sizeof(bf16));
  L.o = off;    off = align128(off + (size_t)QT * (HD + 4) * sizeof(float));
  L.seg = off;  off = align128(off + (size_t)Sp * sizeof(int));
  L.live = off; off = align128(off + (size_t)(Sp / KT) * sizeof(int));
  L.total = off;
  return L;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(128)
segment_attention_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg_ids,
                         bf16* __restrict__ out, int S, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = HD + 8;
  constexpr int LDO = HD + 4;
  const int Sp = (S + KT - 1) & ~(KT - 1);
  const int LDSC = Sp + 4;
  const int LDP = Sp + 8;
  const int n_tiles = Sp / KT;
  const Layout L = layout_for<HD>(Sp);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Sc = reinterpret_cast<float*>(smem + L.sc);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  int* seg = reinterpret_cast<int*>(smem + L.seg);
  int* tile_live = reinterpret_cast<int*>(smem + L.live);
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = 3LL * D;
  const bf16* base = qkv + b * S * row_stride;

  for (int j = tid; j < Sp; j += 128) seg[j] = j < S ? seg_ids[b * S + j] : -1;
  __syncthreads();

  // the query tile's range of live ids (-1 rows excluded)
  if (warp == 0) {
    const int q = q0 + lane;
    const int s = q < S ? seg[q] : -1;
    const int lo = warp_min_i(s >= 0 ? s : NO_SEG_LO);
    const int hi = warp_max_i(s >= 0 ? s : NO_SEG_HI);
    if (lane == 0) {
      q_lo = lo;
      q_hi = hi;
    }
  }
  __syncthreads();
  const int lo = q_lo, hi = q_hi;
  if (lo > hi) {  // no live query row: zeros, no work
    for (int e = tid; e < QT * HD; e += 128) {
      const int q = q0 + e / HD;
      if (q < S) out[(b * S + q) * D + h * HD + e % HD] = __float2bfloat16(0.0f);
    }
    return;
  }

  // a key tile is live when its id range meets [lo, hi]
  for (int t = tid; t < n_tiles; t += 128) {
    int kmin = NO_SEG_LO, kmax = NO_SEG_HI;
    for (int j = t * KT; j < (t + 1) * KT; ++j) {
      kmin = min(kmin, seg[j]);
      kmax = max(kmax, seg[j]);
    }
    tile_live[t] = (kmax >= lo && kmin <= hi) ? 1 : 0;
  }

  // stage the Q tile and the live tiles' K, V rows for head h (16 bytes a load)
  constexpr int CH = HD / 8;
  for (int c = tid; c < QT * CH; c += 128) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) v = *reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride + h * HD + cc);
    *reinterpret_cast<uint4*>(Qs + r * LDH + cc) = v;
  }
  __syncthreads();
  for (int c = tid; c < Sp * CH; c += 128) {
    const int r = c / CH, cc = (c % CH) * 8;
    if (!tile_live[r / KT]) continue;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(base + r * row_stride + D + h * HD + cc);
      vv = *reinterpret_cast<const uint4*>(base + r * row_stride + 2 * D + h * HD + cc);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDH + cc) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDH + cc) = vv;
  }
  __syncthreads();

  // scores = Q K^T on the live key tiles ([QT, Sp] f32)
  for (int f = warp; f < 2 * n_tiles; f += 4) {
    const int i = f % 2, j = f / 2;
    if (!tile_live[j]) continue;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
      wmma::load_matrix_sync(a, Qs + 16 * i * LDH + kk, LDH);
      wmma::load_matrix_sync(bm, Ks + KT * j * LDH + kk, LDH);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(Sc + 16 * i * LDSC + KT * j, acc, LDSC, wmma::mem_row_major);
  }
  __syncthreads();

  // f32 softmax over the keys of the row's own segment; probabilities in bf16
  for (int r = warp; r < QT; r += 4) {
    const int q = q0 + r;
    const int sq = q < S ? seg[q] : -1;
    float* srow = Sc + r * LDSC;
    bf16* prow = Ps + r * LDP;
    if (sq < 0) {
      for (int j = lane; j < Sp; j += 32)
        if (tile_live[j / KT]) prow[j] = __float2bfloat16(0.0f);
      continue;
    }
    float m = -3.0e38f;
    for (int j = lane; j < Sp; j += 32)
      if (tile_live[j / KT] && seg[j] == sq) m = fmaxf(m, srow[j] * scale);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < Sp; j += 32) {
      if (!tile_live[j / KT]) continue;
      const float e = seg[j] == sq ? expf(srow[j] * scale - m) : 0.0f;
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.0f / sum;
    for (int j = lane; j < Sp; j += 32)
      if (tile_live[j / KT]) prow[j] = __float2bfloat16(srow[j] * inv);
  }
  __syncthreads();

  // ctx = P V over the live key tiles ([QT, HD] f32)
  for (int f = warp; f < 2 * (HD / 16); f += 4) {
    const int i = f % 2, j = f / 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int t = 0; t < n_tiles; ++t) {
      if (!tile_live[t]) continue;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::load_matrix_sync(a, Ps + 16 * i * LDP + KT * t, LDP);
      wmma::load_matrix_sync(bm, Vs + KT * t * LDH + 16 * j, LDH);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(Os + 16 * i * LDO + 16 * j, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < QT * HD; e += 128) {
    const int r = e / HD, c = e % HD;
    const int q = q0 + r;
    if (q < S) {
      const float o = seg[q] >= 0 ? Os[r * LDO + c] : 0.0f;
      out[(b * S + q) * D + h * HD + c] = __float2bfloat16(o);
    }
  }
}

template <int HD>
cudaError_t launch(const bf16* qkv, const int* seg, bf16* out, int B, int S, int D, float scale,
                   cudaStream_t stream) {
  const int Sp = (S + KT - 1) & ~(KT - 1);
  const size_t bytes = layout_for<HD>(Sp).total;
  cudaError_t err = cudaFuncSetAttribute(segment_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + QT - 1) / QT, D / HD, B);
  segment_attention_kernel<HD><<<grid, 128, bytes, stream>>>(qkv, seg, out, S, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, S, 3D] bf16, segment_ids [B, S] int32 (-1 = padding), out [B, S, D]
// bf16; head_dim 32 (MiniLM), S <= 512. Returns the launch's cudaError_t.
int pt_segment_attention(const void* qkv, const void* segment_ids, void* out, int B, int S, int D,
                         int head_dim, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* q = reinterpret_cast<const bf16*>(qkv);
  const int* g = reinterpret_cast<const int*>(segment_ids);
  bf16* o = reinterpret_cast<bf16*>(out);
  switch (head_dim) {
    case 32: return (int)launch<32>(q, g, o, B, S, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
