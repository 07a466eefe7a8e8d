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
//   * the block reads the sequence's mask once and marks each key tile as
//     holding a live key, and as holding only live keys. Up to S = 512 the
//     keys' biases and the flags sit in static shared memory; past it (any
//     S) the flags take two ints a tile of dynamic shared memory and a
//     visited tile's bias is staged with its K and V, its mask bytes
//     loaded under the tile before;
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

// LONG = false (S <= SHORT_S, every path of the port today): the sequence's
// key bias and tile flags sit in static shared memory and the live tiles in
// a bit mask. LONG = true (any S): two ints a tile of dynamic shared memory
// for the flags, and each visited tile's bias staged beside its K and V.
template <int HD, bool LONG>
__global__ void __launch_bounds__(NT)
masked_attention_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ key_mask,
                        bf16* __restrict__ out, int S, int D, float scale, int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  // short: each key's bias (0 live, KEY_OFF masked, -inf past S); long: the two staged tiles'
  __shared__ float kbias[LONG ? 2 * KT : SHORT_S];
  __shared__ int flags[LONG ? 1 : 2 * SHORT_KT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = 3LL * D;
  const bf16* base = qkv + b * S * row_stride;
  const uint8_t* mask = key_mask + b * S;
  const int n_kt = (S + KT - 1) / KT;
  int* tile_live = LONG ? reinterpret_cast<int*>(smem + Tiles<HD>::BYTES) : flags;  // [n_kt]
  int* tile_plain = tile_live + n_kt;                                                 // [n_kt]

  // the mask, once: each tile's live / all-live flags (short: and each key's bias)
  for (int t = warp; t < n_kt; t += WARPS) {
    bool all = true, any = false;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = t * KT + half * 32 + lane;
      const bool in = j < S;
      const bool on = in && mask[j];
      if constexpr (!LONG) kbias[j] = on ? 0.0f : (in ? KEY_OFF : -CUDART_INF_F);
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
  // the tiles to visit: the live ones, or every one when no key is live
  // (each key at KEY_OFF: a uniform average of V); short: as a bit mask
  uint32_t todo = 0;
  bool any_live = false;
  if constexpr (LONG) {
    for (int t = 0; t < n_kt && !any_live; ++t) any_live = tile_live[t];
  } else {
    for (int t = 0; t < n_kt; ++t) todo |= (uint32_t)tile_live[t] << t;
    any_live = todo != 0;
    if (!any_live) todo = (1u << n_kt) - 1;
  }
  if (!any_live && zero_empty) {  // a sequence with no live key: zeros, no work
    store_zeros<HD>(out, b * S, q0, S, D, h, tid);
    return;
  }
  auto next_tile = [&](int t) {  // the tile visited after t, -1 past the last
    if constexpr (LONG) {
      for (++t; t < n_kt; ++t)
        if (!any_live || tile_live[t]) return t;
      return -1;
    } else {
      const int nxt = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      return nxt;
    }
  };
  // long: tile t's mask bytes for this thread's key (2: past S), and their bias
  auto mask_byte = [&](int t) { return t * KT + tid < S ? (int)mask[t * KT + tid] : 2; };
  auto bias_of = [](int m) { return m == 2 ? -CUDART_INF_F : (m ? 0.0f : KEY_OFF); };

  bf16* Qs = Tiles<HD>::q(smem);
  load_rows<HD>(Qs, base, row_stride, h * HD, q0, S, tid);
  auto load_kv = [&](int t, int buf) {
    load_rows<HD>(Tiles<HD>::k(smem, buf), base, row_stride, D + h * HD, t * KT, S, tid);
    load_rows<HD>(Tiles<HD>::v(smem, buf), base, row_stride, 2 * D + h * HD, t * KT, S, tid);
  };
  int cur = next_tile(-1);
  load_kv(cur, 0);
  if (LONG && tid < KT) kbias[tid] = bias_of(mask_byte(cur));
  cp_async_commit();

  const bool active = q0 + warp * 16 < S;  // warp-uniform
  const int g = lane / 4, cq = lane % 4;
  const float sl = scale * LOG2E;
  Rows<HD> rows;
  rows.init();
  int buf = 0;
  bool first = true;
  while (cur >= 0) {
    const int nxt = next_tile(cur);
    if (nxt >= 0) load_kv(nxt, buf ^ 1);
    // long: the next tile's mask bytes, loaded now and staged after this
    // tile's math, so the load's latency hides under it
    const int next_mask = LONG && nxt >= 0 && tid < KT ? mask_byte(nxt) : 0;
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
        const float* kb = kbias + (LONG ? buf * KT : cur * KT) + 2 * cq;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = (s[j][e] * scale + kb[j * 8 + (e & 1)]) * LOG2E;
      }
      rows.update(s, Tiles<HD>::v(smem, buf), lane);
    }
    first = false;
    if (LONG && nxt >= 0 && tid < KT) kbias[(buf ^ 1) * KT + tid] = bias_of(next_mask);
    __syncthreads();  // every warp is done with buf before it is refilled
    cur = nxt;
    buf ^= 1;
  }
  if (active) rows.store(out, b * S, q0 + warp * 16 + g, S, D, h, lane, true, true);
}

template <int HD>
cudaError_t launch(const bf16* qkv, const uint8_t* mask, bf16* out, int B, int S, int D, float scale,
                   int zero_empty, cudaStream_t stream) {
  dim3 grid((S + QT - 1) / QT, D / HD, B);
  if (S <= SHORT_S) {
    static const cudaError_t opt_in = allow_smem(masked_attention_kernel<HD, false>, Tiles<HD>::BYTES);
    if (opt_in != cudaSuccess) return opt_in;
    masked_attention_kernel<HD, false><<<grid, NT, Tiles<HD>::BYTES, stream>>>(qkv, mask, out, S, D, scale,
                                                                              zero_empty);
    return cudaGetLastError();
  }
  static int limit = 0;  // dynamic shared memory the long kernel may take, found once
  if (!limit) {
    const cudaError_t err = smem_limit(masked_attention_kernel<HD, true>, &limit);
    if (err != cudaSuccess) return err;
  }
  const int bytes = Tiles<HD>::BYTES + 2 * ((S + KT - 1) / KT) * (int)sizeof(int);
  if (bytes > limit) return cudaErrorInvalidValue;
  masked_attention_kernel<HD, true><<<grid, NT, bytes, stream>>>(qkv, mask, out, S, D, scale, zero_empty);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, S, 3D] bf16, key_mask [B, S] uint8, out [B, S, D] bf16; head_dim
// 32, 64, 128 or 256 (D = heads * head_dim), any S. Returns the launch's
// cudaError_t.
int pt_masked_attention(const void* qkv, const void* key_mask, void* out, int B, int S, int D,
                        int head_dim, float scale, int zero_empty, void* stream) {
  if (D % head_dim) return (int)cudaErrorInvalidValue;
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
