// Multi-head self-attention on fused qkv with a key-padding mask, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels:
//   pathway_tpu/ops/fused_attention.py::_fused_call (body _kernel)      -- B3
//   pathway_tpu/ops/fused_layer.py::fused_layer_tokens, the attention
//   step of _layer_kernel                                               -- B1
//
// The TPU packs several sequences into one block and masks the cross-
// sequence tiles with BLOCK_OFF purely to feed its 128-wide matrix unit;
// here a block of 4 warps owns (64-query tile, head, sequence) and runs the
// FlashAttention-2 loop of flash_tile.cuh (mma.sync m16n8k16, K and V
// double-buffered with cp.async, an f32 online softmax in registers, P fed
// straight into P.V), so no cross-sequence work exists. The key mask is the
// loop's special case where a whole 64-key tile is live or dead by key
// index:
//
//   * the block loads the sequence's mask once and marks each key tile as
//     holding a live key, and as holding only live keys;
//   * tiles with no live key are skipped: their keys would get exp(-1e9 -
//     m) = 0 against any live score. For B1 (lengths) that is every tile
//     past the sequence's length;
//   * inside a live tile a masked key gets the finite additive KEY_OFF =
//     -1e9, as the TPU kernel adds it; a tile of only live keys adds
//     nothing; keys past S (the zero-filled tail of the last tile) are not
//     keys at all and get -inf;
//   * a sequence with no live key: with zero_empty (the B1 path) it writes
//     zeros and does no work, as the TPU layer kernel's dead blocks do;
//     without it (B3) every tile is visited, every score is -1e9 and the
//     row averages V uniformly, never NaN;
//   * a warp whose 16 rows all lie past S does no math.
//
// Rounding: scores, the softmax statistics and P.V in f32; P is rounded to
// bf16 before normalisation (the plain version follows); ctx in bf16.
// Templated on the head dim (32, 64, 128, 256); the wrapper zero-pads any
// other head dim up to 256 to the next of these and passes the true scale.
//
// Bound on this card: at the main path's shapes (S = 160, head dim 32, the
// B1 layer) the work is small against the reads of qkv and the writes of
// ctx, so the kernel is bytes-bound; the loop keeps every intermediate on
// chip and re-reads a live key tile from L2 once per query tile. On an
// H100 80GB HBM3 at 700 W (chip_smoke.py): the B1 layer's attention
// (qkv [1024, 160, 1152]) 0.377-0.386 ms against a 0.149 ms bound and
// 0.999 ms for SDPA; B3 (qkv [256, 128, 1152]) 0.069 ms against 0.030 and
// 0.098 ms.

#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr float KEY_OFF = -1.0e9f;

template <int HD>
__global__ void __launch_bounds__(NT)
masked_attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ key_mask,
                        bf16* __restrict__ out, int S, int D, float scale, int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float kbias[MAX_S];  // 0 live, KEY_OFF masked, -inf past S
  __shared__ int tile_live[MAX_KT], tile_plain[MAX_KT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = 3LL * D;
  const bf16* base = qkv + b * S * row_stride;
  const int n_kt = (S + KT - 1) / KT;

  // the mask, once: each key's bias and each tile's live / all-live flags
  for (int t = warp; t < n_kt; t += WARPS) {
    bool all = true, any = false;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = t * KT + half * 32 + lane;
      const bool in = j < S;
      const bool on = in && key_mask[b * S + j];
      kbias[j] = on ? 0.0f : (in ? KEY_OFF : -CUDART_INF_F);
      all &= on;
      any |= on;
    }
    all = __all_sync(0xffffffffu, all);
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
      tile_live[t] = any;
      tile_plain[t] = all;
    }
  }
  __syncthreads();
  uint32_t todo = 0;
  for (int t = 0; t < n_kt; ++t) todo |= (uint32_t)tile_live[t] << t;
  if (!todo) {
    if (zero_empty) {  // a sequence with no live key: zeros, no work
      store_zeros<HD>(out, b * S, q0, S, D, h, tid);
      return;
    }
    todo = (1u << n_kt) - 1;  // every key at KEY_OFF: a uniform average of V
  }

  bf16* Qs = Tiles<HD>::q(smem);
  load_rows<HD>(Qs, base, row_stride, h * HD, q0, S, tid);
  auto load_kv = [&](int t, int buf) {
    load_rows<HD>(Tiles<HD>::k(smem, buf), base, row_stride, D + h * HD, t * KT, S, tid);
    load_rows<HD>(Tiles<HD>::v(smem, buf), base, row_stride, 2 * D + h * HD, t * KT, S, tid);
  };
  int cur = __ffs(todo) - 1;
  todo &= todo - 1;
  load_kv(cur, 0);
  cp_async_commit();

  const bool active = q0 + warp * 16 < S;  // warp-uniform
  const int g = lane / 4, cq = lane % 4;
  const float sl = scale * LOG2E;
  Rows<HD> rows;
  rows.init();
  int buf = 0;
  bool first = true;
  while (cur >= 0) {
    const int nxt = todo ? __ffs(todo) - 1 : -1;
    todo &= todo - 1;
    if (nxt >= 0) load_kv(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (active) {
      if (first) rows.load_q(Qs, warp, lane);
      float s[KT / 8][4];
      rows.scores(Tiles<HD>::k(smem, buf), lane, s);
      if (tile_plain[cur]) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sl;
      } else {
        const float* kb = kbias + cur * KT + 2 * cq;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = (s[j][e] * scale + kb[j * 8 + (e & 1)]) * LOG2E;
      }
      rows.update(s, Tiles<HD>::v(smem, buf), lane);
    }
    first = false;
    __syncthreads();  // every warp is done with buf before it is refilled
    cur = nxt;
    buf ^= 1;
  }
  if (active) rows.store(out, b * S, q0 + warp * 16 + g, S, D, h, lane, true, true);
}

template <int HD>
cudaError_t launch(const bf16* qkv, const uint8_t* mask, bf16* out, int B, int S, int D, float scale,
                   int zero_empty, cudaStream_t stream) {
  static const cudaError_t opt_in = allow_smem(masked_attention_kernel<HD>, Tiles<HD>::BYTES);
  if (opt_in != cudaSuccess) return opt_in;
  dim3 grid((S + QT - 1) / QT, D / HD, B);
  masked_attention_kernel<HD><<<grid, NT, Tiles<HD>::BYTES, stream>>>(qkv, mask, out, S, D, scale, zero_empty);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, S, 3D] bf16, key_mask [B, S] uint8, out [B, S, D] bf16; head_dim
// 32, 64, 128 or 256 (D = heads * head_dim), S <= 512. Returns the launch's
// cudaError_t.
int pt_masked_attention(const void* qkv, const void* key_mask, void* out, int B, int S, int D,
                        int head_dim, float scale, int zero_empty, void* stream) {
  if (S > MAX_S || D % head_dim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* q = reinterpret_cast<const bf16*>(qkv);
  const uint8_t* m = reinterpret_cast<const uint8_t*>(key_mask);
  bf16* o = reinterpret_cast<bf16*>(out);
  switch (head_dim) {
    case 32: return (int)launch<32>(q, m, o, B, S, D, scale, zero_empty, s);
    case 64: return (int)launch<64>(q, m, o, B, S, D, scale, zero_empty, s);
    case 128: return (int)launch<128>(q, m, o, B, S, D, scale, zero_empty, s);
    case 256: return (int)launch<256>(q, m, o, B, S, D, scale, zero_empty, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
