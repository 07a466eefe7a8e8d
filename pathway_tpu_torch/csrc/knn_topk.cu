// Fused KNN scores + top-k, for Hopper (sm_90a).
//
// Replaces: pathway_tpu/ops/pallas_knn.py::knn_topk (body _kernel, merge
// _merge_topk). It computes the top-k of factor * (Q D^T) + bias per query,
// where bias carries NEG for dead index slots and -|d|^2 for L2 (factor 2).
// Ties go to the lower doc index; a candidate scored at or below NEG / 2 never
// enters a list, so a list that finds fewer than k live docs ends in
// (NEG, -1). Rows at or past n_docs never surface.
//
// The TPU carries one running top-k per query across a sequential doc axis
// (dimension_semantics "arbitrary"); Hopper blocks run in no order, so the
// work is two passes:
//   1. knn_partial_kernel: grid (doc splits, query tiles of 64). Each block
//      scores its doc range tile by tile in f32 (the TPU kernel casts both
//      sides to f32; no TF32 here either) and keeps each query's running
//      top-k in registers: a warp owns 8 queries, each lane holds list
//      positions lane and lane + 32. It writes [q, splits, k] partials.
//   2. knn_merge_kernel: one warp per query folds the splits' sorted lists
//      into the final top-k with the same register insertion.
// The [q, N] score matrix never reaches device memory.
//
// Bound on this card: 2 q N D f32 operations against 4 N D bytes of docs;
// at q = 256 the f32 arithmetic bounds it (67 TFLOP/s without tensor cores).
// This first version is a plain shared-memory tiled f32 loop (4x4 outputs a
// thread, no cp.async pipeline); list updates are cheap after the first
// tiles, because a candidate must beat the current k-th score to be inserted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TQ = 64;   // queries per block
constexpr int TN = 64;   // docs per tile
constexpr int DC = 32;   // depth of one staged chunk
constexpr int QPW = 8;   // queries per warp (8 warps)

// Insert (cs, ci) into a warp's sorted list of k <= 64 entries (lane holds
// positions lane and lane + 32) if it beats the k-th entry. Entries already
// in the list that tie with cs stay ahead of it: they came from lower indices.
__device__ __forceinline__ void insert(float (&ls)[2], int (&li)[2], float cs, int ci, int k,
                                       int lane) {
  const float kth = __shfl_sync(FULL, (k - 1) < 32 ? ls[0] : ls[1], (k - 1) & 31);
  if (!(cs > kth)) return;  // warp-uniform
  const unsigned b0 = __ballot_sync(FULL, lane < k && ls[0] >= cs);
  const unsigned b1 = __ballot_sync(FULL, lane + 32 < k && ls[1] >= cs);
  const int pos = __popc(b0) + __popc(b1);
  float up0 = __shfl_up_sync(FULL, ls[0], 1);
  int upi0 = __shfl_up_sync(FULL, li[0], 1);
  float up1 = __shfl_up_sync(FULL, ls[1], 1);
  int upi1 = __shfl_up_sync(FULL, li[1], 1);
  const float w31 = __shfl_sync(FULL, ls[0], 31);
  const int wi31 = __shfl_sync(FULL, li[0], 31);
  if (lane == 0) {
    up1 = w31;
    upi1 = wi31;
  }
  const int p0 = lane, p1 = lane + 32;
  if (p0 == pos) {
    ls[0] = cs;
    li[0] = ci;
  } else if (p0 > pos) {
    ls[0] = up0;
    li[0] = upi0;
  }
  if (p1 == pos) {
    ls[1] = cs;
    li[1] = ci;
  } else if (p1 > pos) {
    ls[1] = up1;
    li[1] = upi1;
  }
}

__device__ __forceinline__ float kth_of(const float (&ls)[2], int k) {
  return __shfl_sync(FULL, (k - 1) < 32 ? ls[0] : ls[1], (k - 1) & 31);
}

__global__ void __launch_bounds__(256)
knn_partial_kernel(const float* __restrict__ Q, const float* __restrict__ Dm,
                   const float* __restrict__ bias, float factor, int nq, int nd, int dim, int k,
                   int tiles_per_split, float* __restrict__ part_s, int* __restrict__ part_i) {
  __shared__ __align__(16) float Qs[DC][TQ + 4];
  __shared__ __align__(16) float Ds[DC][TN + 4];
  __shared__ float Ss[TQ][TN + 1];
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tx = tid % 16;  // docs tx*4 .. tx*4+3
  const int ty = tid / 16;  // queries ty*4 .. ty*4+3

  float ls[QPW][2];
  int li[QPW][2];
#pragma unroll
  for (int a = 0; a < QPW; ++a) {
    ls[a][0] = ls[a][1] = NEG;
    li[a][0] = li[a][1] = -1;
  }

  const int n_tiles = (nd + TN - 1) / TN;
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  for (int t = t0; t < t1; ++t) {
    const int d0 = t * TN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int c0 = 0; c0 < dim; c0 += DC) {
      for (int e = tid; e < TQ * DC; e += 256) {
        const int r = e / DC, c = e % DC;
        const int gq = q0 + r, gc = c0 + c;
        Qs[c][r] = (gq < nq && gc < dim) ? Q[(int64_t)gq * dim + gc] : 0.0f;
      }
      for (int e = tid; e < TN * DC; e += 256) {
        const int r = e / DC, c = e % DC;
        const int gd = d0 + r, gc = c0 + c;
        Ds[c][r] = (gd < nd && gc < dim) ? Dm[(int64_t)gd * dim + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&Qs[c][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Ds[c][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[ty * 4 + i][tx * 4 + j] = acc[i][j];
    __syncthreads();

#pragma unroll
    for (int a = 0; a < QPW; ++a) {
      const int q = warp * QPW + a;
      if (q0 + q < nq) {  // warp-uniform
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = half * 32 + lane;
          const int doc = d0 + j;
          float s = NEG;
          if (doc < nd) {
            s = __fadd_rn(__fmul_rn(Ss[q][j], factor), bias[doc]);  // no FMA: as the plain version
            if (!(s > NEG * 0.5f)) s = NEG;
          }
          unsigned m = __ballot_sync(FULL, s > kth_of(ls[a], k));
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float cs = __shfl_sync(FULL, s, src);
            insert(ls[a], li[a], cs, d0 + half * 32 + src, k, lane);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < QPW; ++a) {
    const int q = q0 + warp * QPW + a;
    if (q < nq) {
      const int64_t o = ((int64_t)q * splits + split) * k;
      if (lane < k) {
        part_s[o + lane] = ls[a][0];
        part_i[o + lane] = li[a][0];
      }
      if (lane + 32 < k) {
        part_s[o + lane + 32] = ls[a][1];
        part_i[o + lane + 32] = li[a][1];
      }
    }
  }
}

__global__ void __launch_bounds__(128)
knn_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i, int nq,
                 int splits, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * 4 + warp;
  if (q >= nq) return;  // warp-uniform
  float ls[2] = {NEG, NEG};
  int li[2] = {-1, -1};
  const int total = splits * k;
  const float* ps = part_s + (int64_t)q * total;
  const int* pi = part_i + (int64_t)q * total;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    const float s = e < total ? ps[e] : NEG;
    const int id = e < total ? pi[e] : -1;
    unsigned m = __ballot_sync(FULL, s > kth_of(ls, k));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(ls, li, __shfl_sync(FULL, s, src), __shfl_sync(FULL, id, src), k, lane);
    }
  }
  const bool live0 = ls[0] > NEG * 0.5f, live1 = ls[1] > NEG * 0.5f;
  if (lane < k) {
    out_s[(int64_t)q * k + lane] = live0 ? ls[0] : NEG;
    out_i[(int64_t)q * k + lane] = live0 ? li[0] : -1;
  }
  if (lane + 32 < k) {
    out_s[(int64_t)q * k + lane + 32] = live1 ? ls[1] : NEG;
    out_i[(int64_t)q * k + lane + 32] = live1 ? li[1] : -1;
  }
}

}  // namespace

extern "C" {

// Pass 1. Q [nq, dim] f32, D [nd, dim] f32, bias [nd] f32; part_s/part_i are
// [nq, splits, k]; 1 <= k <= 64. Returns the launch's cudaError_t.
int pt_knn_topk_partial(const void* Q, const void* D, const void* bias, float factor, int nq,
                        int nd, int dim, int k, int splits, int tiles_per_split, void* part_s,
                        void* part_i, void* stream) {
  if (k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  dim3 grid(splits, (nq + TQ - 1) / TQ);
  knn_partial_kernel<<<grid, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)Q, (const float*)D, (const float*)bias, factor, nq, nd, dim, k,
      tiles_per_split, (float*)part_s, (int*)part_i);
  return (int)cudaGetLastError();
}

// Pass 2: [nq, splits, k] partials -> out_s/out_i [nq, k].
int pt_knn_topk_merge(const void* part_s, const void* part_i, int nq, int splits, int k,
                      void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  knn_merge_kernel<<<(nq + 3) / 4, 128, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)part_s, (const int*)part_i, nq, splits, k, (float*)out_s, (int*)out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
