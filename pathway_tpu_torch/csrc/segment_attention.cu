// Sequence-packed multi-head self-attention on fused qkv, for Hopper
// (sm_90a): a token attends exactly the tokens that carry its segment id.
//
// Replaces the TPU kernel
//   pathway_tpu/ops/fused_attention.py::_packed_call (body _seg_kernel) -- B4
//
// Several chunks share one row of tokens (512 on the packed ingest), back to back; segment
// ids are unique across rows and -1 marks padding. The TPU kernel packs
// 256-token blocks and adds BLOCK_OFF where ids differ, to keep its 128-wide
// matrix unit fed. Here the kernel is a FlashAttention-2 style loop:
//
//   * one block of 4 warps owns (64-query tile, head, row); a warp owns 16
//     query rows and runs mma.sync m16n8k16 bf16 with f32 accumulation;
//   * the block reads the query tile's range [lo, hi] of live ids and each
//     64-key tile's [min, max] id range. Up to S = 512 the row's ids (2 KB)
//     sit in static shared memory; past it (any S) the ranges take two ints
//     a tile of dynamic shared memory and a visited tile's ids are staged
//     with its K and V, loaded under the tile before. A 64-key tile whose
//     [min, max] id range misses [lo, hi] holds no key any of those queries may attend,
//     so only the live key tiles are visited (an exact skip). With
//     contiguous segments of 64-256 tokens that is two to four of a 512-
//     token row's eight tiles. A warp also skips the compute of a live tile
//     that misses its own 16 rows' id range;
//   * K and V of head h for the live tiles stream through a double buffer
//     with cp.async (4 x 16 bytes per key, coalesced across keys), so the
//     next tile's copy overlaps this tile's math;
//   * scores and probabilities stay in registers: f32 running max and sum
//     per query row (online softmax in the exp2 domain), P converted to
//     bf16 straight into the A fragment of the P.V product. No buffer is
//     sized to the row's keys: a block takes about 28 KB of shared memory
//     at head dim 32, so many blocks are resident per SM;
//   * the mask seg_q == seg_k is applied inside each loaded tile, so the
//     result is exact for any ids, contiguous or not. A query row whose
//     segment has no key in a tile keeps its max at -inf there; the rescale
//     is guarded so it never computes exp(-inf - (-inf));
//   * query rows with segment -1 write zeros (the TPU kernel leaves finite
//     garbage that no caller reads), and a tile of only such rows does no
//     work at all.
//
// The loop itself (mma.sync tiles, cp.async double buffer, online softmax,
// P into P.V) is flash_tile.cuh's, shared with masked_attention.cu.
// Templated on the head dim (32, 64, 128, 256); the wrapper zero-pads any
// other head dim up to 256 to the next of these and passes the true scale.
//
// Rounding: scores and softmax statistics in f32; P is rounded to bf16
// before normalisation (the plain version rounds at the same point); P.V
// accumulates in f32; ctx is written in bf16.
//
// Bound on this card: at the packed ingest's shapes (rows of 512, head dim
// 32, segments of 64-256 tokens) the work that must be done is
// 4*h*hd*sum(len^2) operations against qkv read once and ctx written once,
// which is bytes-bound. The loop keeps every intermediate on chip and
// re-reads a live key tile from L2 once per query tile that needs it. On an
// H100 80GB HBM3 at 700 W (chip_smoke.py, qkv [256, 512, 1152], 630
// segments): 0.521-0.523 ms against a 0.120 ms bound, 1.100 ms for SDPA
// with the equality mask.

#include "flash_tile.cuh"

namespace {

using namespace flash;

constexpr int NO_SEG_LO = 0x7fffffff;
constexpr int NO_SEG_HI = -0x7fffffff - 1;

// Bit t set when key tile t's id range [tmin[t], tmax[t]] meets [lo, hi].
__device__ __forceinline__ uint32_t live_tiles(const int* tmin, const int* tmax, int n_kt, int lo, int hi) {
  uint32_t mask = 0;
  for (int t = 0; t < n_kt; ++t)
    if (tmax[t] >= lo && tmin[t] <= hi) mask |= 1u << t;
  return mask;
}

// LONG = false (S <= SHORT_S, every path of the port today): the row's ids
// sit in static shared memory and the live tiles in bit masks. LONG = true
// (any S): two ints a tile of dynamic shared memory for the tiles' id
// ranges, and each visited tile's ids staged beside its K and V.
template <int HD, bool LONG>
__global__ void __launch_bounds__(NT)
segment_attention_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg_ids,
                         bf16* __restrict__ out, int S, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  // short: the row's ids (-1 past S); long: the two staged tiles'
  __shared__ __align__(16) int seg[LONG ? 2 * KT : SHORT_S];
  __shared__ int ranges[LONG ? 1 : 2 * SHORT_KT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = 3LL * D;
  const bf16* base = qkv + b * S * row_stride;
  const int* row_ids = seg_ids + b * S;
  const int n_kt = (S + KT - 1) / KT;
  int* tmin = LONG ? reinterpret_cast<int*>(smem + Tiles<HD>::BYTES) : ranges;  // [n_kt]
  int* tmax = tmin + n_kt;                                                      // [n_kt]
  // the id of position j (-1 past S): short from shared memory, long from the row
  auto id = [&](int j) {
    if constexpr (LONG) {
      return j < S ? row_ids[j] : -1;
    } else {
      return seg[j];
    }
  };

  if constexpr (!LONG) {
    for (int j = tid; j < SHORT_S; j += NT) seg[j] = j < S ? row_ids[j] : -1;
    __syncthreads();
  }

  // the query tile's range of live ids (-1 rows excluded); each warp computes it
  int lo = NO_SEG_LO, hi = NO_SEG_HI;
#pragma unroll
  for (int i = lane; i < QT; i += 32) {
    const int a = id(q0 + i);
    lo = min(lo, a >= 0 ? a : NO_SEG_LO);
    hi = max(hi, a >= 0 ? a : NO_SEG_HI);
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  if (lo > hi) {  // no live query row: zeros, no work
    store_zeros<HD>(out, b * S, q0, S, D, h, tid);
    return;
  }
  // each key tile's id range, once per block
  for (int t = warp; t < n_kt; t += WARPS) {
    const int a = id(t * KT + lane), c = id(t * KT + 32 + lane);
    const int mn = warp_min_i(min(a, c)), mx = warp_max_i(max(a, c));
    if (lane == 0) {
      tmin[t] = mn;
      tmax[t] = mx;
    }
  }
  __syncthreads();
  // short: the live tiles as a bit mask
  uint32_t todo = LONG ? 0u : live_tiles(tmin, tmax, n_kt, lo, hi);
  auto next_tile = [&](int t) {  // the live tile after t, -1 past the last
    if constexpr (LONG) {
      for (++t; t < n_kt; ++t)
        if (tmax[t] >= lo && tmin[t] <= hi) return t;
      return -1;
    } else {
      const int nxt = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      return nxt;
    }
  };

  // this warp's 16 rows: their ids, and the live tiles that meet their range
  const int g = lane / 4, cq = lane % 4;
  const int r0 = q0 + warp * 16 + g;
  const int sq0 = id(r0);
  const int sq1 = id(r0 + 8);
  const int s16 = id(q0 + warp * 16 + (lane % 16));
  const int wlo = warp_min_i(s16 >= 0 ? s16 : NO_SEG_LO);
  const int whi = warp_max_i(s16 >= 0 ? s16 : NO_SEG_HI);
  const uint32_t mine = LONG || wlo > whi ? 0u : (live_tiles(tmin, tmax, n_kt, wlo, whi) & todo);
  auto is_mine = [&](int t) {
    if constexpr (LONG) {
      return wlo <= whi && tmax[t] >= wlo && tmin[t] <= whi;
    } else {
      return (mine >> t) & 1u;
    }
  };

  // stage Q (once) and the first live tile's K, V (long: and ids); rows past S are zero-filled
  bf16* Qs = Tiles<HD>::q(smem);
  load_rows<HD>(Qs, base, row_stride, h * HD, q0, S, tid);
  auto load_kv = [&](int t, int buf) {
    load_rows<HD>(Tiles<HD>::k(smem, buf), base, row_stride, D + h * HD, t * KT, S, tid);
    load_rows<HD>(Tiles<HD>::v(smem, buf), base, row_stride, 2 * D + h * HD, t * KT, S, tid);
  };
  int cur = next_tile(-1);
  load_kv(cur, 0);
  if (LONG && tid < KT) seg[tid] = id(cur * KT + tid);
  cp_async_commit();

  const float sl = scale * LOG2E;
  Rows<HD> rows;
  rows.init();
  int buf = 0;
  bool first = true;
  while (cur >= 0) {
    const int nxt = next_tile(cur);
    if (nxt >= 0) load_kv(nxt, buf ^ 1);
    // long: the next tile's ids, loaded now and staged after this tile's
    // math, so the load's latency hides under it
    const int next_ids = LONG && nxt >= 0 && tid < KT ? id(nxt * KT + tid) : -1;
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (first) {
      rows.load_q(Qs, warp, lane);
      first = false;
    }
    if (is_mine(cur)) {
      // mask to the row's own segment, in the exp2 domain
      float s[KT / 8][4];
      rows.scores(Tiles<HD>::k(smem, buf), lane, s);
      const int* kseg = seg + (LONG ? buf * KT : cur * KT);
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sk = kseg[j * 8 + 2 * cq + (e & 1)];
          const int sq = (e < 2) ? sq0 : sq1;
          s[j][e] = (sq >= 0 && sk == sq) ? s[j][e] * sl : -CUDART_INF_F;
        }
      }
      rows.update(s, Tiles<HD>::v(smem, buf), lane);
    }
    if (LONG && nxt >= 0 && tid < KT) seg[(buf ^ 1) * KT + tid] = next_ids;
    __syncthreads();  // every warp is done with buf before it is refilled
    cur = nxt;
    buf ^= 1;
  }
  // normalise and write ctx; -1 rows get zeros
  rows.store(out, b * S, r0, S, D, h, lane, sq0 >= 0, sq1 >= 0);
}

template <int HD>
cudaError_t launch(const bf16* qkv, const int* seg, bf16* out, int B, int S, int D, float scale,
                   cudaStream_t stream) {
  dim3 grid((S + QT - 1) / QT, D / HD, B);
  if (S <= SHORT_S) {
    static const cudaError_t opt_in = allow_smem(segment_attention_kernel<HD, false>, Tiles<HD>::BYTES);
    if (opt_in != cudaSuccess) return opt_in;
    segment_attention_kernel<HD, false><<<grid, NT, Tiles<HD>::BYTES, stream>>>(qkv, seg, out, S, D, scale);
    return cudaGetLastError();
  }
  static int limit = 0;  // dynamic shared memory the long kernel may take, found once
  if (!limit) {
    const cudaError_t err = smem_limit(segment_attention_kernel<HD, true>, &limit);
    if (err != cudaSuccess) return err;
  }
  const int bytes = Tiles<HD>::BYTES + 2 * ((S + KT - 1) / KT) * (int)sizeof(int);
  if (bytes > limit) return cudaErrorInvalidValue;
  segment_attention_kernel<HD, true><<<grid, NT, bytes, stream>>>(qkv, seg, out, S, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, S, 3D] bf16, segment_ids [B, S] int32 (-1 = padding), out [B, S, D]
// bf16; head_dim 32, 64, 128 or 256 (D = heads * head_dim), any S. Returns the
// launch's cudaError_t.
int pt_segment_attention(const void* qkv, const void* segment_ids, void* out, int B, int S, int D,
                         int head_dim, float scale, void* stream) {
  if (D % head_dim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* q = reinterpret_cast<const bf16*>(qkv);
  const int* seg = reinterpret_cast<const int*>(segment_ids);
  bf16* o = reinterpret_cast<bf16*>(out);
  switch (head_dim) {
    case 32: return (int)launch<32>(q, seg, o, B, S, D, scale, s);
    case 64: return (int)launch<64>(q, seg, o, B, S, D, scale, s);
    case 128: return (int)launch<128>(q, seg, o, B, S, D, scale, s);
    case 256: return (int)launch<256>(q, seg, o, B, S, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
