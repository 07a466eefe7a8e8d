// Multi-head self-attention on fused qkv with a key-padding mask, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels:
//   pathway_tpu/ops/fused_attention.py::_fused_call (body _kernel)      -- B3
//   pathway_tpu/ops/fused_layer.py::fused_layer_tokens, the attention
//   step of _layer_kernel                                               -- B1
//
// One block per (query tile of 32 rows, head, sequence). Scores are taken
// against that sequence's own keys only: the TPU packs p sequences into one
// block and masks the cross-sequence tiles with BLOCK_OFF purely to feed its
// 128-wide matrix unit; here no cross-sequence work exists. Keys whose mask
// is false get the additive KEY_OFF = -1e9 (finite: a row whose keys are all
// masked averages V uniformly and never gives NaN). Softmax runs in f32, the
// probabilities are rounded to bf16 and multiplied with V accumulating in f32,
// and ctx is written in bf16 -- the TPU kernel's rounding points.
// With zero_empty set (the B1 path), a sequence with no live key writes zeros
// and does no work, as the TPU layer kernel's dead blocks do.
//
// Bound on this card: at the main path's shapes (S = 160, head dim 32) the
// work is small against the reads of qkv, but each block re-reads its
// sequence's K and V (from L2) and the scores pass through shared memory,
// so it is bound by on-chip traffic and latency rather than either roofline.
// The design keeps scores and probabilities in shared memory (never in
// device memory) and uses the tensor cores (WMMA bf16) for both products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int QT = 32;           // query rows per block (4 warps)
constexpr float KEY_OFF = -1.0e9f;

__host__ __device__ __forceinline__ size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

struct Layout {
  size_t q, k, v, sc, p, o, kb, total;
};

template <int HD>
__host__ __device__ __forceinline__ Layout layout_for(int Sp) {
  constexpr int LDH = HD + 8;
  Layout L;
  size_t off = 0;
  L.q = off;  off = align128(off + (size_t)QT * LDH * sizeof(bf16));
  L.k = off;  off = align128(off + (size_t)Sp * LDH * sizeof(bf16));
  L.v = off;  off = align128(off + (size_t)Sp * LDH * sizeof(bf16));
  L.sc = off; off = align128(off + (size_t)QT * (Sp + 4) * sizeof(float));
  L.p = off;  off = align128(off + (size_t)QT * (Sp + 8) * sizeof(bf16));
  L.o = off;  off = align128(off + (size_t)QT * (HD + 4) * sizeof(float));
  L.kb = off; off = align128(off + (size_t)Sp * sizeof(float));
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

template <int HD>
__global__ void __launch_bounds__(128)
masked_attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ key_mask,
                        bf16* __restrict__ out, int S, int D, float scale, int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = HD + 8;
  constexpr int LDO = HD + 4;
  const int Sp = (S + 15) & ~15;
  const int LDSC = Sp + 4;
  const int LDP = Sp + 8;
  const Layout L = layout_for<HD>(Sp);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  float* Sc = reinterpret_cast<float*>(smem + L.sc);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* kb = reinterpret_cast<float*>(smem + L.kb);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = 3LL * D;
  const bf16* base = qkv + b * S * row_stride;

  int live = 0;
  for (int j = tid; j < Sp; j += 128) {
    const bool on = j < S && key_mask[b * S + j];
    kb[j] = on ? 0.0f : KEY_OFF;
    live |= on;
  }
  live = __syncthreads_or(live);
  if (zero_empty && !live) {
    for (int e = tid; e < QT * HD; e += 128) {
      const int q = q0 + e / HD;
      if (q < S) out[(b * S + q) * D + h * HD + e % HD] = __float2bfloat16(0.0f);
    }
    return;
  }

  // stage Q tile and all of this sequence's K, V for head h (16 bytes per load)
  constexpr int CH = HD / 8;
  for (int c = tid; c < QT * CH; c += 128) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S) v = *reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride + h * HD + cc);
    *reinterpret_cast<uint4*>(Qs + r * LDH + cc) = v;
  }
  for (int c = tid; c < Sp * CH; c += 128) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (r < S) {
      kv = *reinterpret_cast<const uint4*>(base + r * row_stride + D + h * HD + cc);
      vv = *reinterpret_cast<const uint4*>(base + r * row_stride + 2 * D + h * HD + cc);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDH + cc) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LDH + cc) = vv;
  }
  __syncthreads();

  // scores = Q K^T  ([QT, Sp] f32)
  const int nf = 2 * (Sp / 16);
  for (int f = warp; f < nf; f += 4) {
    const int i = f % 2, j = f / 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
      wmma::load_matrix_sync(a, Qs + 16 * i * LDH + kk, LDH);
      wmma::load_matrix_sync(bm, Ks + 16 * j * LDH + kk, LDH);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(Sc + 16 * i * LDSC + 16 * j, acc, LDSC, wmma::mem_row_major);
  }
  __syncthreads();

  // stable f32 softmax per query row; probabilities rounded to bf16
  for (int r = warp; r < QT; r += 4) {
    float* srow = Sc + r * LDSC;
    float m = -3.0e38f;
    for (int j = lane; j < S; j += 32) {
      const float s = srow[j] * scale + kb[j];
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    bf16* prow = Ps + r * LDP;
    for (int j = lane; j < Sp; j += 32)
      prow[j] = __float2bfloat16(j < S ? srow[j] / sum : 0.0f);
  }
  __syncthreads();

  // ctx = P V  ([QT, HD] f32)
  for (int f = warp; f < 2 * (HD / 16); f += 4) {
    const int i = f % 2, j = f / 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < Sp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::load_matrix_sync(a, Ps + 16 * i * LDP + kk, LDP);
      wmma::load_matrix_sync(bm, Vs + kk * LDH + 16 * j, LDH);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(Os + 16 * i * LDO + 16 * j, acc, LDO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < QT * HD; e += 128) {
    const int r = e / HD, c = e % HD;
    if (q0 + r < S) out[(b * S + q0 + r) * D + h * HD + c] = __float2bfloat16(Os[r * LDO + c]);
  }
}

template <int HD>
cudaError_t launch(const bf16* qkv, const uint8_t* mask, bf16* out, int B, int S, int D,
                   float scale, int zero_empty, cudaStream_t stream) {
  const int Sp = (S + 15) & ~15;
  const size_t bytes = layout_for<HD>(Sp).total;
  cudaError_t err = cudaFuncSetAttribute(masked_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + QT - 1) / QT, D / HD, B);
  masked_attention_kernel<HD><<<grid, 128, bytes, stream>>>(qkv, mask, out, S, D, scale,
                                                            zero_empty);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, S, 3D] bf16, key_mask [B, S] uint8, out [B, S, D] bf16; head_dim 32
// (MiniLM), S <= 512. Returns the launch's cudaError_t.
int pt_masked_attention(const void* qkv, const void* key_mask, void* out, int B, int S, int D,
                        int head_dim, float scale, int zero_empty, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* q = reinterpret_cast<const bf16*>(qkv);
  const uint8_t* m = reinterpret_cast<const uint8_t*>(key_mask);
  bf16* o = reinterpret_cast<bf16*>(out);
  switch (head_dim) {
    case 32: return (int)launch<32>(q, m, o, B, S, D, scale, zero_empty, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
