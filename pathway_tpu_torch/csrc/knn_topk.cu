// Fused KNN scores + top-k, for Hopper (sm_90a).
//
// Replaces: pathway_tpu/ops/pallas_knn.py::knn_topk (body _kernel, merge
// _merge_topk). It computes the top-k of factor * (Q D^T) + bias per query,
// where bias carries NEG for dead index slots and -|d|^2 for L2 (factor 2).
// Ties go to the lower doc index; a candidate scored at or below NEG / 2 never
// enters a list, so a list that finds fewer than k live docs ends in
// (NEG, -1). Rows at or past n_docs never surface.
//
// Also replaces pathway_tpu/ops/pallas_knn.py::knn_topk_sharded, which runs
// the same kernel on each shard of a row-sharded slab inside a shard_map and
// takes one top-k over the [q, n_shards * k] candidates. Here each shard runs
// the two passes below on its own device, its merge writing global indices
// (base = shard * shard_len) into its k columns of a [q, n_shards, k] block
// on the first shard's device, and one more knn_merge_kernel launch folds the
// block: the (score, index) order makes the shards' ties go to the lower
// global row, as lax.top_k over the shard-major concatenation does. That
// merge reads q * n_shards * k entries, so the shards' doc bytes bound the
// whole call, as they bound one shard's.
//
// The TPU carries one running top-k per query across a sequential doc axis
// (dimension_semantics "arbitrary"); Hopper blocks run in no order, so the
// work is two passes: a partial pass in which each block scores one
// contiguous doc range (a split) and keeps each query's running top-k, and
// knn_merge_kernel, which folds the [q, splits, k] partials. The [q, N]
// score matrix never reaches device memory. Lists order entries by (score
// descending, index ascending), so insertion order never decides a tie and
// the merge may fold partials in any order.
//
// The partial pass has two regimes, picked by the wrapper from the number of
// queries (ops/knn_topk.py::launch_plan):
//
//   * knn_stream_kernel, few queries (the index's single-query search). The
//     work is 2 q N D operations on 4 N D bytes of docs, so at q <= 16 the
//     bytes bound it. The queries sit in shared memory; each block streams
//     its doc range through a ring of 32-row tiles filled by 16-byte
//     cp.async, a few tiles ahead. A warp scores 4 docs at once for every
//     query in f32 FMAs (lanes across the dimension, then one transposed
//     shuffle reduction for all 4 x q sums), and a score enters a candidate
//     buffer only if it reaches the query's current k-th score; the list's
//     owner warp inserts the few that do. One block per SM covers the slab.
//     At a width that is not a multiple of 4 it copies 4 bytes at a time and
//     also serves more queries, 16 a launch (TMA cannot take such rows).
//   * knn_tc_kernel, many queries (batch search). There the f32 operations
//     bound it (67 TFLOP/s without tensor cores). Scores come from the tensor
//     cores in error-compensated 3xTF32: each f32 operand is split into a TF32
//     high part and a TF32 low part, and hi*hi + hi*lo + lo*hi accumulate in
//     f32 (single-pass TF32 keeps three decimal digits and is not used). TMA
//     brings 64-query and 128-doc chunks of 32 f32 (one 128-byte swizzle row)
//     into a 3-stage ring; the block writes each chunk's low parts beside it
//     while the tensor cores work on the chunk before, and two warpgroups run
//     wgmma.m64n64k8 (tf32) from shared memory, 64 docs each. The 64 x 128
//     score tile goes to shared memory; each warp tests its 8 queries' rows
//     against the k-th entries it keeps beside its register lists and walks
//     only the 32-doc blocks where some score passes. The grid is (query
//     tiles, splits) with one block per SM, so each query has few, long
//     splits to merge.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper_tma.cuh"

namespace {

constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- lists

// (s1, i1) ranks ahead of (s2, i2): higher score, or equal score and lower index
__device__ __forceinline__ bool ahead(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void list_init(float (&ls)[2], int (&li)[2]) {
  ls[0] = ls[1] = NEG;
  li[0] = li[1] = -1;
}

// the k-th entry of a warp's list (lane holds positions lane and lane + 32)
__device__ __forceinline__ void kth_of(const float (&ls)[2], const int (&li)[2], int k, float& ks, int& ki) {
  const bool hi = (k - 1) >= 32;
  ks = __shfl_sync(FULL, hi ? ls[1] : ls[0], (k - 1) & 31);
  ki = __shfl_sync(FULL, hi ? li[1] : li[0], (k - 1) & 31);
}

// Insert the warp-uniform candidate (cs, ci) into a sorted list of k <= 64
// if it ranks ahead of the k-th entry.
__device__ __forceinline__ void insert(float (&ls)[2], int (&li)[2], float cs, int ci, int k, int lane) {
  float ks;
  int ki;
  kth_of(ls, li, k, ks, ki);
  if (!ahead(cs, ci, ks, ki)) return;  // warp-uniform
  const unsigned b0 = __ballot_sync(FULL, lane < k && ahead(ls[0], li[0], cs, ci));
  const unsigned b1 = __ballot_sync(FULL, lane + 32 < k && ahead(ls[1], li[1], cs, ci));
  const int pos = __popc(b0) + __popc(b1);
  const float up0 = __shfl_up_sync(FULL, ls[0], 1);
  const int upi0 = __shfl_up_sync(FULL, li[0], 1);
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

// Insert the candidates of mask m (lane j holds (s, id)), all ranked ahead
// of the list's k-th entry when the mask was taken, one at a time.
__device__ __forceinline__ void fold_mask(float (&ls)[2], int (&li)[2], float s, int id, unsigned m, int k, int lane) {
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    insert(ls, li, __shfl_sync(FULL, s, src), __shfl_sync(FULL, id, src), k, lane);
  }
}

// Fold one candidate per lane into the warp's list; only candidates that
// rank ahead of the current k-th entry are inserted.
__device__ __forceinline__ void fold32(float (&ls)[2], int (&li)[2], float s, int id, bool live, int k, int lane) {
  float ks;
  int ki;
  kth_of(ls, li, k, ks, ki);
  fold_mask(ls, li, s, id, __ballot_sync(FULL, live && ahead(s, id, ks, ki)), k, lane);
}

__device__ __forceinline__ void list_store(const float (&ls)[2], const int (&li)[2], int k, int lane, float* s,
                                           int* i) {
  if (lane < k) {
    s[lane] = ls[0];
    i[lane] = li[0];
  }
  if (lane + 32 < k) {
    s[lane + 32] = ls[1];
    i[lane + 32] = li[1];
  }
}

// ---------------------------------------------------------------- copies

// VEC floats from global to shared memory, asynchronously; zero-filled when !ok
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? VEC * 4 : 0;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n groups are pending (n is a runtime value below 4)
__device__ __forceinline__ void cp_wait(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::);
  else if (n == 2) asm volatile("cp.async.wait_group 2;\n" ::);
  else asm volatile("cp.async.wait_group 3;\n" ::);
}

template <int VEC>
__device__ __forceinline__ void ld_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// ---------------------------------------------------------------- small q

constexpr int ST_THREADS = 256;
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_DPW = 4;                  // docs a warp scores at once
constexpr int ST_TN = ST_WARPS * ST_DPW;  // docs per tile (32)

// Sum N values per lane over the warp, transposed: each step halves the
// values a lane keeps and sends the other half to its partner, so N sums
// cost about N shuffles instead of 5 N. Afterwards the lane holds the full
// sums of values base + i, i < max(N / 32, 1) (see xreduce_base).
template <int N, int O>
__device__ __forceinline__ void xreduce(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, O);
      }
      xreduce<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], O);
      xreduce<1, O / 2>(v, lane);
    }
  }
}

template <int N>
__device__ __forceinline__ int xreduce_base(int lane) {
  int base = 0, n = N;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (n > 1) {
      n >>= 1;
      if (lane & o) base += n;
    }
  }
  return base;
}

// NQ: queries held (a power of two >= nq); VEC: floats per copy (4 when the
// dimension is a multiple of 4, else 1).
template <int NQ, int VEC>
__global__ void __launch_bounds__(ST_THREADS, 1)
knn_stream_kernel(const float* __restrict__ Q, const float* __restrict__ Dm, const float* __restrict__ bias,
                  float factor, int nq, int nd, int dim, int k, int tiles_per_split, int stages,
                  float* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int NV = ST_DPW * NQ;           // sums a lane carries: value j * NQ + q
  constexpr int NF = NV >= 32 ? NV / 32 : 1;  // full sums a lane holds after the reduction
  constexpr int LQ = (NQ + ST_WARPS - 1) / ST_WARPS;  // lists per warp
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [NQ][dim]
  float* ring = qs + NQ * dim;               // [stages][ST_TN][dim]
  float* bring = ring + stages * ST_TN * dim;  // [stages][ST_TN]
  float* cand_s = bring + stages * ST_TN;    // [NQ][ST_TN]
  int* cand_i = reinterpret_cast<int*>(cand_s + NQ * ST_TN);
  int* cnt = cand_i + NQ * ST_TN;            // [NQ]
  float* thr = reinterpret_cast<float*>(cnt + NQ);  // [NQ] a list's k-th score, a lower bound

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, splits = gridDim.x;
  const int n_tiles = (nd + ST_TN - 1) / ST_TN;
  const int t0 = split * tiles_per_split;
  const int ntl = max(0, min(t0 + tiles_per_split, n_tiles) - t0);
  const int chunks = dim / VEC;

  auto issue = [&](int it) {
    const int slot = it % stages;
    const int d0 = (t0 + it) * ST_TN;
    float* dst = ring + slot * ST_TN * dim;
    for (int e = tid; e < ST_TN * chunks; e += ST_THREADS) {
      const int r = e / chunks, c = e - r * chunks;
      const bool ok = d0 + r < nd;
      cp_async<VEC>(dst + r * dim + c * VEC, Dm + (int64_t)(ok ? d0 + r : 0) * dim + c * VEC, ok);
    }
    if (tid < ST_TN) {
      const bool ok = d0 + tid < nd;
      cp_async<1>(bring + slot * ST_TN + tid, bias + (ok ? d0 + tid : 0), ok);
    }
  };

  for (int e = tid; e < NQ * dim; e += ST_THREADS) qs[e] = e < nq * dim ? Q[e] : 0.0f;
  if (tid < NQ) {
    cnt[tid] = 0;
    thr[tid] = NEG;
  }
  float ls[LQ][2];
  int li[LQ][2];
#pragma unroll
  for (int a = 0; a < LQ; ++a) list_init(ls[a], li[a]);

  for (int s = 0; s < stages - 1; ++s) {
    if (s < ntl) issue(s);
    cp_commit();
  }
  for (int it = 0; it < ntl; ++it) {
    cp_wait(stages - 2);
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + stages - 1 < ntl) issue(it + stages - 1);
    cp_commit();

    const int slot = it % stages;
    const float* tile = ring + slot * ST_TN * dim + warp * ST_DPW * dim;
    float acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
    for (int c = lane * VEC; c < dim; c += 32 * VEC) {
      float dv[ST_DPW][VEC];
#pragma unroll
      for (int j = 0; j < ST_DPW; ++j) ld_vec<VEC>(dv[j], tile + j * dim + c);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float qv[VEC];
        ld_vec<VEC>(qv, qs + q * dim + c);
#pragma unroll
        for (int j = 0; j < ST_DPW; ++j)
#pragma unroll
          for (int u = 0; u < VEC; ++u) acc[j * NQ + q] = fmaf(qv[u], dv[j][u], acc[j * NQ + q]);
      }
    }
    xreduce<NV, 16>(acc, lane);
    const int base = xreduce_base<NV>(lane);
    const bool owner = NV >= 32 || (lane & (32 / NV - 1)) == 0;
    const int d0 = (t0 + it) * ST_TN;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int v = base + f, j = v / NQ, q = v % NQ;
      const int r = warp * ST_DPW + j, doc = d0 + r;
      if (owner && q < nq && doc < nd) {
        // no FMA: the same rounding as the plain version's (scores * factor) + bias
        const float s = __fadd_rn(__fmul_rn(acc[f], factor), bring[slot * ST_TN + r]);
        if (s > NEG * 0.5f && s >= thr[q]) {
          const int p = atomicAdd(&cnt[q], 1);
          cand_s[q * ST_TN + p] = s;
          cand_i[q * ST_TN + p] = doc;
        }
      }
    }
    __syncthreads();  // candidates of tile it are in place
#pragma unroll
    for (int a = 0; a < LQ; ++a) {
      const int q = warp + a * ST_WARPS;
      if (q < NQ && q < nq) {  // warp-uniform
        const int n = cnt[q];
        for (int b = 0; b < n; b += 32) {
          const bool live = b + lane < n;
          fold32(ls[a], li[a], live ? cand_s[q * ST_TN + b + lane] : NEG, live ? cand_i[q * ST_TN + b + lane] : -1,
                 live, k, lane);
        }
        float ks;
        int ki;
        kth_of(ls[a], li[a], k, ks, ki);
        __syncwarp();
        if (lane == 0) {
          cnt[q] = 0;
          thr[q] = ks;
        }
      }
    }
  }
  cp_wait(0);

#pragma unroll
  for (int a = 0; a < LQ; ++a) {
    const int q = warp + a * ST_WARPS;
    if (q < NQ && q < nq) {
      const int64_t o = ((int64_t)q * splits + split) * k;
      list_store(ls[a], li[a], k, lane, part_s + o, part_i + o);
    }
  }
}

// ---------------------------------------------------------------- large q

constexpr int TC_THREADS = 256;  // two warpgroups; warpgroup w scores docs [64 w, 64 w + 64) of a tile
constexpr int TC_BQ = 64;        // queries per block
constexpr int TC_BN = 128;       // docs per tile
constexpr int TC_BK = 32;        // f32 per chunk row: one 128-byte swizzle row
constexpr int TC_STAGES = 3;
constexpr int TC_A_BYTES = TC_BQ * TC_BK * 4;
constexpr int TC_RAW_BYTES = TC_A_BYTES + TC_BN * TC_BK * 4;  // one chunk's queries and docs as loaded
constexpr int TC_STAGE_BYTES = 2 * TC_RAW_BYTES;              // then their TF32 low parts, same layout
constexpr int TC_SLD = TC_BN + 4;                             // score tile row
constexpr int TC_QPW = TC_BQ / (TC_THREADS / 32);              // lists per warp (8)
constexpr size_t TC_SMEM = (size_t)TC_STAGES * TC_STAGE_BYTES + sizeof(float) * TC_BQ * TC_SLD + 8 * TC_STAGES + 1024;
static_assert(TC_QPW * (TC_BN / 32) <= 32, "one bit per (row, 32-doc block) of a warp");

__device__ __forceinline__ float tf32_hi(float x) { return __uint_as_float(__float_as_uint(x) & 0xffffe000u); }

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// D[64, 64] += A[64, 8] B[64, 8]^T in TF32, both operands K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Q and D arrive by TMA ([64 | 128] rows x 32 f32, 128-byte swizzle, zero
// fill past nq, nd and dim); grid (query tiles, splits).
__global__ void __launch_bounds__(TC_THREADS, 1)
knn_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap td,
              const float* __restrict__ bias, float factor, int nq, int nd, int dim, int k, int tiles_per_split,
              float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte aligned tiles
  unsigned char* gbase = smem_raw + (base - raw0);
  float* ss = reinterpret_cast<float*>(gbase + TC_STAGES * TC_STAGE_BYTES);  // [TC_BQ][TC_SLD]
  const uint32_t bars = base + TC_STAGES * TC_STAGE_BYTES + sizeof(float) * TC_BQ * TC_SLD;
  auto full = [&](int s) { return bars + 8u * s; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = tid / 128;
  const int g = lane / 4, t = lane % 4;  // accumulator fragment coordinates
  const int q0 = blockIdx.x * TC_BQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (nd + TC_BN - 1) / TC_BN;
  const int t0 = split * tiles_per_split;
  const int ntl = max(0, min(t0 + tiles_per_split, n_tiles) - t0);
  const int kc_n = (dim + TC_BK - 1) / TC_BK;
  const int total = ntl * kc_n;  // chunks, tile-major

  auto issue = [&](int c) {  // one thread
    const int s = c % TC_STAGES;
    const uint32_t st = base + s * TC_STAGE_BYTES;
    mbar_expect_tx(full(s), TC_RAW_BYTES);  // zero-filled box parts count too
    tma_load_2d(st, &tq, (c % kc_n) * TC_BK, q0, full(s));
    tma_load_2d(st + TC_A_BYTES, &td, (c % kc_n) * TC_BK, (t0 + c / kc_n) * TC_BN, full(s));
  };
  // the TF32 low part of each f32 of chunk c, rounded. The tensor cores
  // read an f32 operand as TF32 by its top 19 bits, so the loaded tile
  // itself is the high part and hi + lo is exactly x.
  auto convert = [&](int c) {
    const int s = c % TC_STAGES;
    mbar_wait(full(s), (c / TC_STAGES) & 1);
    const float4* x4 = reinterpret_cast<const float4*>(gbase + s * TC_STAGE_BYTES);
    float4* lo = reinterpret_cast<float4*>(gbase + s * TC_STAGE_BYTES + TC_RAW_BYTES);
#pragma unroll
    for (int i = tid; i < TC_RAW_BYTES / 16; i += TC_THREADS) {
      const float4 x = x4[i];
      lo[i] = make_float4(tf32_round(x.x - tf32_hi(x.x)), tf32_round(x.y - tf32_hi(x.y)),
                          tf32_round(x.z - tf32_hi(x.z)), tf32_round(x.w - tf32_hi(x.w)));
    }
    fence_proxy_async();  // the tensor cores read these through the async proxy
  };

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&td)) : "memory");
    for (int c = 0; c < min(TC_STAGES, total); ++c) issue(c);
  }

  float ls[TC_QPW][2];
  int li[TC_QPW][2];
  float ks[TC_QPW];  // each list's k-th entry, kept beside it
  int ki[TC_QPW];
#pragma unroll
  for (int a = 0; a < TC_QPW; ++a) {
    list_init(ls[a], li[a]);
    ks[a] = NEG;
    ki[a] = -1;
  }
  float d[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) d[r] = 0.0f;
  float bias_r[TC_BN / 32];

  if (total > 0) convert(0);
  __syncthreads();
  for (int c = 0; c < total; ++c) {
    const int kc = c % kc_n;
    const int d0 = (t0 + c / kc_n) * TC_BN;
    if (kc == 0) {  // this tile's bias, read while its chunks compute
#pragma unroll
      for (int j = 0; j < TC_BN / 32; ++j) {
        const int doc = d0 + j * 32 + lane;
        bias_r[j] = doc < nd ? __ldg(bias + doc) : 0.0f;
      }
    }
    const uint32_t st = base + (c % TC_STAGES) * TC_STAGE_BYTES;
    const uint64_t ah = sw128_desc(st), al = sw128_desc(st + TC_RAW_BYTES);
    const uint64_t bh = sw128_desc(st + TC_A_BYTES + wg * 64 * 128);
    const uint64_t bl = sw128_desc(st + TC_RAW_BYTES + TC_A_BYTES + wg * 64 * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk) {  // small terms first
      wgmma_tf32(d, al + 2 * kk, bh + 2 * kk);
      wgmma_tf32(d, ah + 2 * kk, bl + 2 * kk);
      wgmma_tf32(d, ah + 2 * kk, bh + 2 * kk);
    }
    wgmma_commit();
    if (c + 1 < total) convert(c + 1);  // overlaps the products of chunk c
    wgmma_wait<0>();
    __syncthreads();  // chunk c's stage is free and chunk c + 1 is split
    if (tid == 0 && c + TC_STAGES < total) issue(c + TC_STAGES);

    if (kc == kc_n - 1) {  // the tile's scores are complete
      const int w4 = warp % 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* p = ss + (w4 * 16 + g) * TC_SLD + wg * 64 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(p + 8 * TC_SLD) = make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) d[r] = 0.0f;
      __syncthreads();
      // every lane scores its column of the warp's 8 rows against the lists'
      // k-th entries first; the warp then walks only the (row, 32-doc column
      // block) pairs in which some lane found a candidate
      float sc[TC_QPW][TC_BN / 32];
      unsigned mine = 0;
#pragma unroll
      for (int a = 0; a < TC_QPW; ++a) {
        const bool row_live = q0 + warp * TC_QPW + a < nq;
#pragma unroll
        for (int j = 0; j < TC_BN / 32; ++j) {
          const int doc = d0 + j * 32 + lane;
          const float s = __fadd_rn(__fmul_rn(ss[(warp * TC_QPW + a) * TC_SLD + j * 32 + lane], factor), bias_r[j]);
          sc[a][j] = row_live && doc < nd && s > NEG * 0.5f ? s : NEG;
          if (ahead(sc[a][j], doc, ks[a], ki[a])) mine |= 1u << (a * (TC_BN / 32) + j);
        }
      }
      const unsigned walk = __reduce_or_sync(FULL, mine);
      if (walk) {
#pragma unroll
        for (int a = 0; a < TC_QPW; ++a) {
#pragma unroll
          for (int j = 0; j < TC_BN / 32; ++j) {
            if (!((walk >> (a * (TC_BN / 32) + j)) & 1u)) continue;  // warp-uniform
            const int doc = d0 + j * 32 + lane;
            fold_mask(ls[a], li[a], sc[a][j], doc, __ballot_sync(FULL, ahead(sc[a][j], doc, ks[a], ki[a])), k, lane);
            kth_of(ls[a], li[a], k, ks[a], ki[a]);
          }
        }
      }
      // the next write of ss follows the next chunk's __syncthreads
    }
  }

#pragma unroll
  for (int a = 0; a < TC_QPW; ++a) {
    const int q = q0 + warp * TC_QPW + a;
    if (q < nq) {
      const int64_t o = ((int64_t)q * splits + split) * k;
      list_store(ls[a], li[a], k, lane, part_s + o, part_i + o);
    }
  }
}

// A row-major [rows, cols] f32 matrix seen as boxes of [box_rows, 32],
// 128-byte swizzle. The docs' map is reused call after call, so maps are
// kept in a small cache keyed by pointer and shape.
struct MapEntry {
  const void* ptr;
  int rows, cols, box_rows;
  CUtensorMap map;
};

bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  constexpr int CACHE = 16;
  static MapEntry cache[CACHE];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const MapEntry& e = cache[i];
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)TC_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  MapEntry& e = cache[next];
  e = MapEntry{ptr, rows, cols, box_rows, *map};
  next = (next + 1) % CACHE;
  if (used < CACHE) ++used;
  return true;
}

// ---------------------------------------------------------------- merge

constexpr int MG_THREADS = 256;
constexpr int MG_WARPS = MG_THREADS / 32;
constexpr int MG_UNROLL = 4;

// One block per query: each warp folds a strided share of the query's
// splits x k partials (MG_UNROLL loads in flight a lane), then warp 0 folds
// the warps' lists.
__global__ void __launch_bounds__(MG_THREADS)
knn_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i, int splits, int k, int base,
                 int ld_out, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float ws[MG_WARPS * 64];
  __shared__ int wi[MG_WARPS * 64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q = blockIdx.x;
  const int total = splits * k;
  const float* ps = part_s + q * total;
  const int* pi = part_i + q * total;
  float ls[2];
  int li[2];
  list_init(ls, li);
  for (int e0 = warp * 32; e0 < total; e0 += MG_THREADS * MG_UNROLL) {
    float s[MG_UNROLL];
    int id[MG_UNROLL];
#pragma unroll
    for (int u = 0; u < MG_UNROLL; ++u) {
      const int e = e0 + u * MG_THREADS + lane;
      s[u] = e < total ? ps[e] : NEG;
      id[u] = e < total ? pi[e] : -1;
    }
#pragma unroll
    for (int u = 0; u < MG_UNROLL; ++u) fold32(ls, li, s[u], id[u], s[u] > NEG * 0.5f, k, lane);
  }
  list_store(ls, li, k, lane, ws + warp * 64, wi + warp * 64);
  __syncthreads();
  if (warp != 0) return;
  list_init(ls, li);
  for (int e0 = 0; e0 < MG_WARPS * k; e0 += 32) {
    const int e = e0 + lane;
    const bool in = e < MG_WARPS * k;
    const float s = in ? ws[(e / k) * 64 + e % k] : NEG;
    const int id = in ? wi[(e / k) * 64 + e % k] : -1;
    fold32(ls, li, s, id, s > NEG * 0.5f, k, lane);
  }
  const bool live0 = ls[0] > NEG * 0.5f, live1 = ls[1] > NEG * 0.5f;
  if (lane < k) {
    out_s[q * ld_out + lane] = live0 ? ls[0] : NEG;
    out_i[q * ld_out + lane] = live0 ? li[0] + base : -1;
  }
  if (lane + 32 < k) {
    out_s[q * ld_out + lane + 32] = live1 ? ls[1] : NEG;
    out_i[q * ld_out + lane + 32] = live1 ? li[1] + base : -1;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NQ, int VEC>
int launch_stream(const float* Q, const float* D, const float* bias, float factor, int nq, int nd, int dim, int k,
                  int splits, int tiles_per_split, int stages, float* part_s, int* part_i, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ((size_t)NQ * dim + (size_t)stages * ST_TN * (dim + 1) +
                                        2 * (size_t)NQ * ST_TN + 2 * (size_t)NQ);
  const cudaError_t err = allow_smem(knn_stream_kernel<NQ, VEC>, bytes);
  if (err != cudaSuccess) return (int)err;
  knn_stream_kernel<NQ, VEC><<<splits, ST_THREADS, bytes, stream>>>(Q, D, bias, factor, nq, nd, dim, k,
                                                                     tiles_per_split, stages, part_s, part_i);
  return (int)cudaGetLastError();
}

template <int NQ>
int launch_stream_nq(const float* Q, const float* D, const float* bias, float factor, int nq, int nd, int dim, int k,
                     int splits, int tiles_per_split, int stages, float* part_s, int* part_i, cudaStream_t stream) {
  return dim % 4 == 0
             ? launch_stream<NQ, 4>(Q, D, bias, factor, nq, nd, dim, k, splits, tiles_per_split, stages, part_s,
                                    part_i, stream)
             : launch_stream<NQ, 1>(Q, D, bias, factor, nq, nd, dim, k, splits, tiles_per_split, stages, part_s,
                                    part_i, stream);
}

}  // namespace

extern "C" {

// Partial pass, few queries. Q [nq, dim] f32 with 1 <= nq <= 16, D [nd, dim]
// f32, bias [nd] f32; part_s/part_i are [nq, splits, k]; 1 <= k <= 64;
// 2 <= stages <= 4 ring tiles (the wrapper sizes them to shared memory).
// Returns the launch's cudaError_t.
int pt_knn_topk_stream(const void* Q, const void* D, const void* bias, float factor, int nq, int nd, int dim,
                       int k, int splits, int tiles_per_split, int stages, void* part_s, void* part_i,
                       void* stream) {
  if (k < 1 || k > 64 || nq < 1 || nq > 16 || stages < 2 || stages > 4) return (int)cudaErrorInvalidValue;
  const float *q = (const float*)Q, *d = (const float*)D, *b = (const float*)bias;
  float* ps = (float*)part_s;
  int* pi = (int*)part_i;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (nq == 1) return launch_stream_nq<1>(q, d, b, factor, nq, nd, dim, k, splits, tiles_per_split, stages, ps, pi, st);
  if (nq == 2) return launch_stream_nq<2>(q, d, b, factor, nq, nd, dim, k, splits, tiles_per_split, stages, ps, pi, st);
  if (nq <= 4) return launch_stream_nq<4>(q, d, b, factor, nq, nd, dim, k, splits, tiles_per_split, stages, ps, pi, st);
  if (nq <= 8) return launch_stream_nq<8>(q, d, b, factor, nq, nd, dim, k, splits, tiles_per_split, stages, ps, pi, st);
  return launch_stream_nq<16>(q, d, b, factor, nq, nd, dim, k, splits, tiles_per_split, stages, ps, pi, st);
}

// Partial pass, many queries: grid (ceil(nq / 64), splits) on the tensor
// cores. Same operands and partial layout as pt_knn_topk_stream; dim must be
// a multiple of 4 (TMA takes 16-byte row strides).
int pt_knn_topk_tc(const void* Q, const void* D, const void* bias, float factor, int nq, int nd, int dim, int k,
                   int splits, int tiles_per_split, void* part_s, void* part_i, void* stream) {
  if (k < 1 || k > 64 || nq < 1 || nd < 1 || dim < 1 || dim % 4) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, td;
  if (!tensor_map(&tq, Q, nq, dim, TC_BQ) || !tensor_map(&td, D, nd, dim, TC_BN)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(knn_tc_kernel, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  knn_tc_kernel<<<dim3((nq + TC_BQ - 1) / TC_BQ, splits), TC_THREADS, TC_SMEM, reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, td, (const float*)bias, factor, nq, nd, dim, k, tiles_per_split, (float*)part_s, (int*)part_i);
  return (int)cudaGetLastError();
}

// Merge pass: [nq, splits, k] partials -> out_s/out_i, row q at q * ld_out
// (ld_out >= k), live indices shifted by base (a shard's first global row;
// dead entries stay -1). knn_topk_sharded merges each shard with its base
// into a [nq, n_shards, k] candidate block (ld_out = n_shards * k), then the
// block once more with splits = n_shards and base 0.
int pt_knn_topk_merge(const void* part_s, const void* part_i, int nq, int splits, int k, int base, int ld_out,
                      void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > 64 || ld_out < k || base < 0) return (int)cudaErrorInvalidValue;
  knn_merge_kernel<<<nq, MG_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)part_s, (const int*)part_i, splits, k, base, ld_out, (float*)out_s, (int*)out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
