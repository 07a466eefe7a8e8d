// The FlashAttention-2 style inner loop shared by masked_attention.cu (B1's
// attention step and B3) and segment_attention.cu (B4), for Hopper (sm_90a).
//
// A block of 4 warps owns 64 query rows of one (sequence, head); a warp owns
// 16 of them and runs mma.sync m16n8k16 bf16 with f32 accumulation. K and V
// of 64-key tiles stream through a double buffer in shared memory with
// cp.async; scores and probabilities stay in registers (an f32 online
// softmax in the exp2 domain), and P is rounded to bf16 straight into the A
// fragment of the P.V product -- before normalisation, which happens once at
// the end. What a key counts for (excluded, masked, live) is the caller's:
// it hands `update` scores already scaled into the exp2 domain, with -inf
// for keys the row may not attend. Templated on the head dim (32, 64, 128,
// 256). At 256 a warp's output tile alone is 128 f32 registers a thread, so
// the Q fragments are read from shared memory at each key tile instead of
// being held in registers, which keeps the loop inside 255 registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int QT = 64;          // query rows per block, 16 per warp
constexpr int WARPS = QT / 16;
constexpr int NT = WARPS * 32;  // threads per block
constexpr int KT = 64;          // keys per tile
constexpr int MAX_S = 512;
constexpr int MAX_KT = MAX_S / KT;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(QT == KT, "load_rows stages Q and K/V tiles of the same height");

// Shared-memory layout of one block: Q [QT, LDH], then K and V double
// buffers [2][KT, LDH] each; LDH = HD + 8 keeps ldmatrix conflict-free.
template <int HD>
struct Tiles {
  static constexpr int LDH = HD + 8;
  static constexpr int Q_ELEMS = QT * LDH;
  static constexpr int KV_ELEMS = KT * LDH;
  static constexpr int BYTES = (Q_ELEMS + 4 * KV_ELEMS) * (int)sizeof(bf16);
  __device__ static bf16* q(unsigned char* smem) { return reinterpret_cast<bf16*>(smem); }
  __device__ static bf16* k(unsigned char* smem, int buf) { return q(smem) + Q_ELEMS + buf * KV_ELEMS; }
  __device__ static bf16* v(unsigned char* smem, int buf) { return q(smem) + Q_ELEMS + (2 + buf) * KV_ELEMS; }
};

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

// Copy rows [r0, r0 + rows) of head h's slice of q, k or v (column offset
// `col` into a qkv row of 3D) into a tile; rows at or past S are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, int64_t row_stride, int col, int r0,
                                          int S, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = tid; c < KT * CH; c += NT) {
    const int r = c / CH, part = (c % CH) * 8;
    const bool in = r0 + r < S;
    cp_async16(smem_u32(dst + r * Tiles<HD>::LDH + part), base + (in ? (r0 + r) * row_stride : 0) + col + part,
               in ? 16 : 0);
  }
}

// Zeros for query rows [q0, q0 + QT) of head h (the rows that exist).
template <int HD>
__device__ __forceinline__ void store_zeros(bf16* out, int64_t row0, int q0, int S, int D, int h, int tid) {
  for (int c = tid; c < QT * (HD / 8); c += NT) {
    const int q = q0 + c / (HD / 8);
    if (q < S)
      *reinterpret_cast<uint4*>(out + (row0 + q) * D + h * HD + (c % (HD / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's 16 query rows: Q fragments, running max and sum per row (rows
// g and g + 8 of the warp's 16, g = lane / 4), and the f32 output tile.
template <int HD>
struct Rows {
  static constexpr bool Q_REGS = HD <= 128;  // Q fragments held in registers
  float m_run[2], l_run[2];
  float o[HD / 8][4];
  uint32_t qa[Q_REGS ? HD / 16 : 1][4];
  uint32_t q_addr;  // this lane's ldmatrix address of Q in shared memory (HD > 128)

  __device__ __forceinline__ void init() {
    m_run[0] = m_run[1] = -CUDART_INF_F;
    l_run[0] = l_run[1] = 0.0f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  }

  __device__ __forceinline__ void load_q(const bf16* Qs, int warp, int lane) {
    q_addr = smem_u32(Qs + (warp * 16 + (lane % 16)) * Tiles<HD>::LDH + (lane / 16) * 8);
    if constexpr (Q_REGS) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) ldsm_x4(qa[ks], q_addr + ks * 16 * (int)sizeof(bf16));
    }
  }

  // s = Q K^T for the warp's 16 rows x KT keys; s[j][e] is key 8 j + 2 (lane % 4) + (e & 1)
  // of row g + 8 (e >> 1)
  __device__ __forceinline__ void scores(const bf16* Ks, int lane, float (&s)[KT / 8][4]) const {
    if constexpr (Q_REGS) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) {
          uint32_t kb[4];
          ldsm_x4(kb, smem_u32(Ks + (j * 8 + (lane % 8)) * Tiles<HD>::LDH + c * 32 + (lane / 8) * 8));
          mma16816(s[j], qa[2 * c], kb[0], kb[1]);
          mma16816(s[j], qa[2 * c + 1], kb[2], kb[3]);
        }
      }
    } else {  // Q's 32 columns at a time from shared memory; each s[j] sums c in the same order
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < HD / 32; ++c) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, q_addr + c * 32 * (int)sizeof(bf16));
        ldsm_x4(a1, q_addr + (c * 32 + 16) * (int)sizeof(bf16));
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          uint32_t kb[4];
          ldsm_x4(kb, smem_u32(Ks + (j * 8 + (lane % 8)) * Tiles<HD>::LDH + c * 32 + (lane / 8) * 8));
          mma16816(s[j], a0, kb[0], kb[1]);
          mma16816(s[j], a1, kb[2], kb[3]);
        }
      }
    }
  }

  // Online softmax over one tile of scores already in the exp2 domain (-inf:
  // a key the row may not attend), then O += P V with P rounded to bf16.
  __device__ __forceinline__ void update(float (&s)[KT / 8][4], const bf16* Vs, int lane) {
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);
      // no attendable key so far: nothing to rescale, and never exp(-inf - (-inf));
      // an excluded score (-inf) then gives exp2(-inf) = 0 against any finite m_use
      alpha[r] = (m_new == -CUDART_INF_F) ? 1.0f : exp2f(m_run[r] - m_new);
      m_use[r] = (m_new == -CUDART_INF_F) ? 0.0f : m_new;
      m_run[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
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
        ldsm_x4_t(vb, smem_u32(Vs + (t * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * Tiles<HD>::LDH + d0 +
                               (lane / 16) * 8));
        mma16816(o[d0 / 8], pa, vb[0], vb[1]);
        mma16816(o[d0 / 8 + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Normalise and write the warp's rows q = r0 and r0 + 8 (row r0 is the
  // warp's row g); rows at or past S are skipped, rows with keep false (or
  // nothing attended) get zeros.
  __device__ __forceinline__ void store(bf16* out, int64_t row0, int r0, int S, int D, int h, int lane,
                                        bool keep0, bool keep1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r0 + 8 * r;
      if (q >= S) continue;
      const bool keep = r ? keep1 : keep0;
      const float inv = (keep && l_run[r] > 0.0f) ? 1.0f / l_run[r] : 0.0f;
      bf16* dst = out + (row0 + q) * D + h * HD + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
};

// Dynamic shared memory above 48 KB needs an opt-in per kernel, once.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
