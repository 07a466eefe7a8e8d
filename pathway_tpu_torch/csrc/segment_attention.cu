// Sequence-packed multi-head self-attention on fused qkv, for Hopper
// (sm_90a): a token attends exactly the tokens that carry its segment id.
//
// Replaces the TPU kernel
//   pathway_tpu/ops/fused_attention.py::_packed_call (body _seg_kernel) -- B4
//
// Several chunks share one row of up to 512 tokens, back to back; segment
// ids are unique across rows and -1 marks padding. The TPU kernel packs
// 256-token blocks and adds BLOCK_OFF where ids differ, to keep its 128-wide
// matrix unit fed. Here the kernel is a FlashAttention-2 style loop:
//
//   * one block of 4 warps owns (64-query tile, head, row); a warp owns 16
//     query rows and runs mma.sync m16n8k16 bf16 with f32 accumulation;
//   * the block loads the row's segment ids once (2 KB) and the query
//     tile's range [lo, hi] of live ids; a 64-key tile whose [min, max] id
//     range misses [lo, hi] holds no key any of those queries may attend,
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
//     sized to the row's keys: a block takes about 22 KB of shared memory,
//     so many blocks are resident per SM;
//   * the mask seg_q == seg_k is applied inside each loaded tile, so the
//     result is exact for any ids, contiguous or not. A query row whose
//     segment has no key in a tile keeps its max at -inf there; the rescale
//     is guarded so it never computes exp(-inf - (-inf));
//   * query rows with segment -1 write zeros (the TPU kernel leaves finite
//     garbage that no caller reads), and a tile of only such rows does no
//     work at all.
//
// Rounding: scores and softmax statistics in f32; P is rounded to bf16
// before normalisation (the plain version rounds after it), one bf16 step;
// P.V accumulates in f32; ctx is written in bf16.
//
// Bound on this card: at the packed ingest's shapes (rows of 512, head dim
// 32, segments of 64-256 tokens) the work that must be done is
// 4*h*hd*sum(len^2) operations against qkv read once and ctx written once,
// which is bytes-bound. The loop keeps every intermediate on chip and
// re-reads a live key tile from L2 once per query tile that needs it. On an
// H100 80GB HBM3 at 700 W (chip_smoke.py, qkv [256, 512, 1152], 630
// segments): 0.510 ms against a 0.120 ms bound, 1.098 ms for SDPA with the
// equality mask; the plain version takes 18.820 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 32;          // head dim (MiniLM)
constexpr int QT = 64;          // query rows per block, 16 per warp
constexpr int WARPS = QT / 16;
constexpr int NT = WARPS * 32;  // threads per block
constexpr int KT = 64;          // keys per tile
constexpr int LDH = HD + 8;     // bf16 row stride in shared memory: conflict-free ldmatrix
constexpr int MAX_S = 512;
constexpr int MAX_KT = MAX_S / KT;
constexpr int NO_SEG_LO = 0x7fffffff;
constexpr int NO_SEG_HI = -0x7fffffff - 1;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Bit t set when key tile t's id range [tmin[t], tmax[t]] meets [lo, hi].
__device__ __forceinline__ uint32_t live_tiles(const int* tmin, const int* tmax, int n_kt, int lo, int hi) {
  uint32_t mask = 0;
  for (int t = 0; t < n_kt; ++t)
    if (tmax[t] >= lo && tmin[t] <= hi) mask |= 1u << t;
  return mask;
}

__global__ void __launch_bounds__(NT)
segment_attention_kernel(const bf16* __restrict__ qkv, const int* __restrict__ seg_ids,
                         bf16* __restrict__ out, int S, int D, float scale) {
  __shared__ __align__(16) int seg[MAX_S];
  __shared__ int tmin[MAX_KT], tmax[MAX_KT];
  __shared__ __align__(128) bf16 Qs[QT * LDH];
  __shared__ __align__(128) bf16 Ks[2][KT * LDH];
  __shared__ __align__(128) bf16 Vs[2][KT * LDH];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = 3LL * D;
  const bf16* base = qkv + b * S * row_stride;
  const int n_kt = (S + KT - 1) / KT;

  for (int j = tid; j < MAX_S; j += NT) seg[j] = j < S ? seg_ids[b * S + j] : -1;
  __syncthreads();

  // the query tile's range of live ids (-1 rows excluded; seg is -1 past S);
  // each warp computes it
  int lo = NO_SEG_LO, hi = NO_SEG_HI;
#pragma unroll
  for (int i = lane; i < QT; i += 32) {
    const int a = seg[q0 + i];
    lo = min(lo, a >= 0 ? a : NO_SEG_LO);
    hi = max(hi, a >= 0 ? a : NO_SEG_HI);
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  if (lo > hi) {  // no live query row: zeros, no work
    for (int c = tid; c < QT * (HD / 8); c += NT) {
      const int q = q0 + c / (HD / 8);
      if (q < S)
        *reinterpret_cast<uint4*>(out + (b * S + q) * D + h * HD + (c % (HD / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  // each key tile's id range, once per block
  for (int t = warp; t < n_kt; t += WARPS) {
    const int a = seg[t * KT + lane], c = seg[t * KT + 32 + lane];
    const int mn = warp_min_i(min(a, c)), mx = warp_max_i(max(a, c));
    if (lane == 0) {
      tmin[t] = mn;
      tmax[t] = mx;
    }
  }
  __syncthreads();
  uint32_t todo = live_tiles(tmin, tmax, n_kt, lo, hi);

  // this warp's 16 rows: their ids, and the live tiles that meet their range
  const int g = lane / 4, cq = lane % 4;
  const int r0 = q0 + warp * 16 + g;
  const int sq0 = seg[r0];
  const int sq1 = seg[r0 + 8];
  uint32_t mine;
  {
    const int s16 = seg[q0 + warp * 16 + (lane % 16)];
    const int wlo = warp_min_i(s16 >= 0 ? s16 : NO_SEG_LO);
    const int whi = warp_max_i(s16 >= 0 ? s16 : NO_SEG_HI);
    mine = wlo > whi ? 0u : (live_tiles(tmin, tmax, n_kt, wlo, whi) & todo);
  }

  // stage Q (once) and the first live tile's K, V; rows past S are zero-filled
  for (int c = tid; c < QT * (HD / 8); c += NT) {
    const int r = c / (HD / 8), part = (c % (HD / 8)) * 8;
    const bool in = q0 + r < S;
    cp_async16(smem_u32(Qs + r * LDH + part), base + (in ? (q0 + r) * row_stride : 0) + h * HD + part,
               in ? 16 : 0);
  }
  auto load_kv = [&](int t, int buf) {
    for (int c = tid; c < KT * (HD / 8); c += NT) {
      const int r = c / (HD / 8), part = (c % (HD / 8)) * 8;
      const int key = t * KT + r;
      const bool in = key < S;
      const bf16* src = base + (in ? key * row_stride : 0) + h * HD + part;
      cp_async16(smem_u32(Ks[buf] + r * LDH + part), src + D, in ? 16 : 0);
      cp_async16(smem_u32(Vs[buf] + r * LDH + part), src + 2 * D, in ? 16 : 0);
    }
  };
  int cur = __ffs(todo) - 1;
  todo &= todo - 1;
  load_kv(cur, 0);
  cp_async_commit();

  const float sl = scale * LOG2E;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  uint32_t qa[HD / 16][4];

  int buf = 0;
  bool first = true;
  while (cur >= 0) {
    const int nxt = todo ? __ffs(todo) - 1 : -1;
    todo &= todo - 1;
    if (nxt >= 0) load_kv(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        ldsm_x4(qa[ks], smem_u32(Qs + (warp * 16 + (lane % 16)) * LDH + ks * 16 + (lane / 16) * 8));
      first = false;
    }
    if (mine & (1u << cur)) {
      // S = Q K^T for this warp's 16 rows x 64 keys
      float s[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        uint32_t kb[4];
        ldsm_x4(kb, smem_u32(Ks[buf] + (j * 8 + (lane % 8)) * LDH + (lane / 8) * 8));
        mma16816(s[j], qa[0], kb[0], kb[1]);
        mma16816(s[j], qa[1], kb[2], kb[3]);
      }
      // mask to the row's own segment; running max in the exp2 domain
      const int kbase = cur * KT;
      float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sk = seg[kbase + j * 8 + 2 * cq + (e & 1)];
          const int sq = (e < 2) ? sq0 : sq1;
          const float v = (sq >= 0 && sk == sq) ? s[j][e] * sl : -CUDART_INF_F;
          s[j][e] = v;
          mt[e >> 1] = fmaxf(mt[e >> 1], v);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m_run[r], mt[r]);
        // no matching key so far: nothing to rescale, and never exp(-inf - (-inf));
        // a masked score (-inf) then gives exp2(-inf) = 0 against any finite m_use
        alpha[r] = (m_new == -CUDART_INF_F) ? 1.0f : exp2f(m_run[r] - m_new);
        m_use[r] = (m_new == -CUDART_INF_F) ? 0.0f : m_new;
        m_run[r] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m_use[e >> 1]);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V: P (bf16) from the score registers, V through ldmatrix.trans
#pragma unroll
      for (int t = 0; t < KT / 16; ++t) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
        pa[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
        pa[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
        pa[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += 16) {
          uint32_t vb[4];
          ldsm_x4_t(vb, smem_u32(Vs[buf] + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDH + d0 +
                                 (lane / 16) * 8));
          mma16816(o[d0 / 8], pa, vb[0], vb[1]);
          mma16816(o[d0 / 8 + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
    cur = nxt;
    buf ^= 1;
  }

  // normalise and write ctx; -1 rows get zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = r0 + 8 * r;
    if (q >= S) continue;
    const int sq = r ? sq1 : sq0;
    const float inv = (sq >= 0 && l_run[r] > 0.0f) ? 1.0f / l_run[r] : 0.0f;
    bf16* dst = out + (b * S + q) * D + h * HD + 2 * cq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

}  // namespace

extern "C" {

// qkv [B, S, 3D] bf16, segment_ids [B, S] int32 (-1 = padding), out [B, S, D]
// bf16; head_dim 32 (MiniLM), S <= 512. Returns the launch's cudaError_t.
int pt_segment_attention(const void* qkv, const void* segment_ids, void* out, int B, int S, int D,
                         int head_dim, float scale, void* stream) {
  if (head_dim != HD || S > MAX_S) return (int)cudaErrorInvalidValue;
  dim3 grid((S + QT - 1) / QT, D / HD, B);
  segment_attention_kernel<<<grid, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const bf16*>(qkv), reinterpret_cast<const int*>(segment_ids),
      reinterpret_cast<bf16*>(out), S, D, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
