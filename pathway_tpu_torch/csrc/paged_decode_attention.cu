// Decode-step attention over a paged KV pool, for Hopper (sm_90a): one query
// token per sequence against that sequence's context, which lives in
// fixed-size pages scattered through one pool and is named, in order, by
// the sequence's page-table row.
//
// Replaces the TPU kernel
//   pathway_tpu/ops/paged_attention.py::paged_decode_attention
//   (body _paged_kernel)                                                 -- B5
//
// The TPU kernel walks a sequential (sequence, page) grid: scalar-prefetched
// page tables steer each step's K/V block, live pages are copied into a
// persistent VMEM gather buffer and dead ones zero-filled, and the last page
// step runs one softmax over the whole buffer. Hopper blocks run in no order
// and carry nothing between them, so the context is split (flash-decoding):
//
//   * paged_decode_split_kernel: grid (sequence, head, context split). A
//     split covers `chunk` <= 64 positions (whole pages when a page is at
//     most 64 positions). Each warp takes a quarter of the split's rows; it
//     loads their table entries beside the sequence's length, then issues
//     every 16-byte cp.async of its K and V rows before it waits, so all of
//     a block's loads are in flight at once. Scores, max, exp and sum, and
//     P.V then run from shared memory: one softmax over the split, kept
//     unnormalised as (max, sum, P.V). Head dims up to 256.
//   * paged_decode_split_tiled_kernel: the same for wider heads, whose rows
//     pass through two shared buffers 256 columns at a time: the K tiles,
//     then the V tiles, each tile's copy in flight while the one before it
//     is used; the scores accumulate over the K tiles, P.V runs per V tile.
//   * paged_decode_combine_kernel: grid (sequence, head), launched by the
//     same entry point. A log-sum-exp combine of the live splits' partials.
//     When the whole context fits one split it is not launched: the split
//     kernel normalises and writes.
//
//   * table entries are clamped to [0, n_pages - 1] (the TPU kernel's index
//     map clamps to n_pages - 1), and no position at or past the length is
//     ever read; splits that start past the length return at once;
//   * a length-0 sequence writes exact zeros;
//   * any head dim (16-byte copies when the rows allow them, 4-byte copies
//     otherwise); shared memory holds two tiles of at most 256 columns, the
//     query and the split's scores.
//
// Numerics: everything is f32. The TPU kernel is bitwise equal to its
// reference only because both run the same ops under one compiler; here the
// sums run in another order than PyTorch's, so the kernel is held to
// paged_attention_reference within 1e-4 (f32), not bitwise.
//
// Bound on this card: one decode step reads each live K and V row once
// (2 * 4 * d bytes per context position) and does 4 * d operations on it,
// so it is bytes-bound by far; at the decode path's size (a few MB) the
// bytes take well under a microsecond and latency decides: the design keeps
// one dependent load chain per block (table -> K/V) and enough blocks to
// spread it over the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float LOWEST = -3.0e38f;  // below any score: the start of a max
constexpr int HD_TILE = 256;         // head columns staged in shared memory at once

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
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

// one value per thread reduced over the block; every thread gets the result
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// shared-memory row of K or V: padded so that the score loop's float4 reads
// (8 rows at once) fall in distinct banks
__host__ __device__ constexpr int row_ld(int hd, int vec) { return vec == 4 ? hd + 8 : hd + 1; }

template <int VEC>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                          const float* __restrict__ v_pages, const int* __restrict__ tables,
                          const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ part_ml,
                          float* __restrict__ part_o, int d, int n_pages, int page_size, int pages_per_seq,
                          int hd, int chunk, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int ld = row_ld(hd, VEC);
  float* ks = sm;                // [chunk][ld]
  float* vs = ks + chunk * ld;   // [chunk][ld]
  float* qs = vs + chunk * ld;   // [hd]
  float* ps = qs + hd;           // [chunk] scores, then exp
  __shared__ float red[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t b = blockIdx.x;
  const int h = blockIdx.y, sp = blockIdx.z, splits = gridDim.z, heads = gridDim.y;
  const int ctx = pages_per_seq * page_size;
  const int j0 = sp * chunk;
  // the table entries of this warp's rows (w, w + 4, ...; lane i holds row
  // w + 4 i), loaded beside the length rather than after it
  const int jl = j0 + warp + WARPS * lane;
  const int pg = lane < (chunk + WARPS - 1) / WARPS && jl < ctx ? tables[b * pages_per_seq + jl / page_size] : 0;
  const int len = min(max(lens[b], 0), ctx);
  const int n = min(chunk, len - j0);  // live rows of this split
  if (n <= 0) {
    if (splits == 1)  // the whole context is this split: length 0 gives exact zeros
      for (int i = tid; i < hd; i += THREADS) out[b * d + h * hd + i] = 0.0f;
    return;  // the combine skips splits past the length
  }

  // every K/V row of the split, in flight at once: warp w copies rows w, w + 4, ...
  const int cpr = hd / VEC;  // copies per row
  for (int i = 0, r = warp; i < (chunk + WARPS - 1) / WARPS; ++i, r += WARPS) {
    const int entry = __shfl_sync(0xffffffffu, pg, i);
    if (r >= n) break;  // warp-uniform
    const int j = j0 + r;
    const int page = max(0, min(entry, n_pages - 1));
    const int64_t row = ((int64_t)page * page_size + j % page_size) * d + h * hd;
    for (int c = lane; c < cpr; c += 32) {
      cp_async<VEC>(ks + r * ld + c * VEC, k_pages + row + c * VEC);
      cp_async<VEC>(vs + r * ld + c * VEC, v_pages + row + c * VEC);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < hd; i += THREADS) qs[i] = q[b * d + h * hd + i];
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // scores: two threads per row, each over half of the head dim's copies
  float mloc = LOWEST;
  for (int r0 = 0; r0 < n; r0 += THREADS / 2) {
    const int r = r0 + tid / 2, half = tid & 1;
    float s = 0.0f;
    if (r < n) {
      const float* kr = ks + r * ld;
      if constexpr (VEC == 4) {
        for (int c = half * 4; c < hd; c += 8) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + c);
          const float4 qv = *reinterpret_cast<const float4*>(qs + c);
          s = fmaf(qv.x, kv.x, s);
          s = fmaf(qv.y, kv.y, s);
          s = fmaf(qv.z, kv.z, s);
          s = fmaf(qv.w, kv.w, s);
        }
      } else {
        for (int c = half; c < hd; c += 2) s = fmaf(qs[c], kr[c], s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (r < n) {
      s *= scale;
      if (!half) ps[r] = s;
      mloc = fmaxf(mloc, s);
    }
  }
  const float m = block_reduce<true>(mloc, red);
  float lsum = 0.0f;
  for (int r = tid; r < n; r += THREADS) {
    const float e = expf(ps[r] - m);
    ps[r] = e;
    lsum += e;
  }
  const float l = block_reduce<false>(lsum, red);  // its barriers also publish ps

  for (int c = tid; c < hd; c += THREADS) {
    float o = 0.0f;
    for (int r = 0; r < n; ++r) o = fmaf(ps[r], vs[r * ld + c], o);
    if (splits == 1) {
      out[b * d + h * hd + c] = o / l;
    } else {
      part_o[((b * heads + h) * splits + sp) * hd + c] = o;
    }
  }
  if (splits > 1 && tid == 0) {
    part_ml[((b * heads + h) * splits + sp) * 2] = m;
    part_ml[((b * heads + h) * splits + sp) * 2 + 1] = l;
  }
}

// Head dims above HD_TILE: the split's K and V rows pass through shared
// memory HD_TILE columns at a time (two buffers: the scores accumulate over
// the K tiles, then P.V runs per V tile), so the shared memory a block takes
// does not grow with the head dim beyond its query and scores.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                          const float* __restrict__ v_pages, const int* __restrict__ tables,
                          const int* __restrict__ lens, float* __restrict__ out, float* __restrict__ part_ml,
                          float* __restrict__ part_o, int d, int n_pages, int page_size, int pages_per_seq,
                          int hd, int chunk, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int tw = min(hd, HD_TILE);     // head columns of one staged tile
  const int tiles = (hd + tw - 1) / tw;
  const int ld = row_ld(tw, VEC);
  float* bufs[2] = {sm, sm + chunk * ld};  // [chunk][ld] each
  float* qs = sm + 2 * chunk * ld;         // [hd]
  float* ps = qs + hd;                     // [chunk] scores, then exp
  __shared__ float red[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t b = blockIdx.x;
  const int h = blockIdx.y, sp = blockIdx.z, splits = gridDim.z, heads = gridDim.y;
  const int ctx = pages_per_seq * page_size;
  const int j0 = sp * chunk;
  // the table entries of this warp's rows (w, w + 4, ...; lane i holds row
  // w + 4 i), loaded beside the length rather than after it
  const int jl = j0 + warp + WARPS * lane;
  const int pg = lane < (chunk + WARPS - 1) / WARPS && jl < ctx ? tables[b * pages_per_seq + jl / page_size] : 0;
  const int len = min(max(lens[b], 0), ctx);
  const int n = min(chunk, len - j0);  // live rows of this split
  if (n <= 0) {
    if (splits == 1)  // the whole context is this split: length 0 gives exact zeros
      for (int i = tid; i < hd; i += THREADS) out[b * d + h * hd + i] = 0.0f;
    return;  // the combine skips splits past the length
  }

  // Stage i of 2 * tiles copies column tile i % tiles of every K (i < tiles)
  // or V row of the split into buffer i % 2: warp w copies rows w, w + 4, ...
  auto stage = [&](int i) {
    const float* src = i < tiles ? k_pages : v_pages;
    const int c0 = (i % tiles) * tw, cpr = min(tw, hd - c0) / VEC;  // copies per row
    float* dst = bufs[i & 1];
    for (int it = 0, r = warp; it < (chunk + WARPS - 1) / WARPS; ++it, r += WARPS) {
      const int entry = __shfl_sync(0xffffffffu, pg, it);
      if (r >= n) break;  // warp-uniform
      const int j = j0 + r;
      const int page = max(0, min(entry, n_pages - 1));
      const int64_t row = ((int64_t)page * page_size + j % page_size) * d + h * hd + c0;
      for (int c = lane; c < cpr; c += 32) cp_async<VEC>(dst + r * ld + c * VEC, src + row + c * VEC);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);  // K of the first column tile
  stage(1);  // K of the second
  for (int i = tid; i < hd; i += THREADS) qs[i] = q[b * d + h * hd + i];

  // scores over column tile [c0, c0 + w) of the K rows in kbuf, added into
  // ps: two threads per row, each over half of the tile's copies. With
  // `last` the sums are whole: scaled, kept, and this thread's max returned.
  auto score_tile = [&](const float* kbuf, int c0, int w, bool first, bool last) {
    float mloc = LOWEST;
    for (int r0 = 0; r0 < n; r0 += THREADS / 2) {
      const int r = r0 + tid / 2, half = tid & 1;
      float s = 0.0f;
      if (r < n) {
        const float* kr = kbuf + r * ld;
        if constexpr (VEC == 4) {
          for (int c = half * 4; c < w; c += 8) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + c);
            const float4 qv = *reinterpret_cast<const float4*>(qs + c0 + c);
            s = fmaf(qv.x, kv.x, s);
            s = fmaf(qv.y, kv.y, s);
            s = fmaf(qv.z, kv.z, s);
            s = fmaf(qv.w, kv.w, s);
          }
        } else {
          for (int c = half; c < w; c += 2) s = fmaf(qs[c0 + c], kr[c], s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (r < n) {
        if (!first) s += ps[r];
        if (last) {
          s *= scale;
          mloc = fmaxf(mloc, s);
        }
        if (!half) ps[r] = s;
      }
    }
    return mloc;
  };
  // one softmax over the split, kept unnormalised: ps becomes exp(s - m);
  // returns the sum (and, past one split, keeps (m, sum) for the combine)
  auto softmax = [&](float mloc) {
    const float m = block_reduce<true>(mloc, red);
    float lsum = 0.0f;
    for (int r = tid; r < n; r += THREADS) {
      const float e = expf(ps[r] - m);
      ps[r] = e;
      lsum += e;
    }
    const float l = block_reduce<false>(lsum, red);  // its barriers also publish ps
    if (splits > 1 && tid == 0) {
      part_ml[((b * heads + h) * splits + sp) * 2] = m;
      part_ml[((b * heads + h) * splits + sp) * 2 + 1] = l;
    }
    return l;
  };
  // P.V over column tile [c0, c0 + w) of the V rows in vbuf
  auto pv_tile = [&](const float* vbuf, int c0, int w, float l) {
    for (int c = tid; c < w; c += THREADS) {
      float o = 0.0f;
      for (int r = 0; r < n; ++r) o = fmaf(ps[r], vbuf[r * ld + c], o);
      if (splits == 1) {
        out[b * d + h * hd + c0 + c] = o / l;
      } else {
        part_o[((b * heads + h) * splits + sp) * hd + c0 + c] = o;
      }
    }
  };

  // K tiles then V tiles through the two buffers, each copy in flight under
  // the tile before it
  const int total = 2 * tiles;
  float mloc = LOWEST, l = 0.0f;
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* cur = bufs[i & 1];
    const int c0 = (i % tiles) * tw, w = min(tw, hd - c0);
    if (i < tiles) {
      mloc = score_tile(cur, c0, w, i == 0, i == tiles - 1);
    } else {
      if (i == tiles) l = softmax(mloc);
      pv_tile(cur, c0, w, l);
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled
    if (i + 2 < total) stage(i + 2);
  }
}

// log-sum-exp combine of the live splits' (max, sum, P.V) partials: the
// split weights are computed once into shared memory, then every column
// sums its splits
__global__ void __launch_bounds__(THREADS)
paged_decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_o,
                            const int* __restrict__ lens, float* __restrict__ out, int d, int ctx, int hd,
                            int chunk, int splits) {
  extern __shared__ float wsm[];  // [splits] weights, then [splits] sums
  __shared__ float red[WARPS];
  const int64_t b = blockIdx.x;
  const int h = blockIdx.y, heads = gridDim.y, tid = threadIdx.x;
  const int len = min(max(lens[b], 0), ctx);
  const int live = (len + chunk - 1) / chunk;
  float* o = out + b * d + h * hd;
  if (live == 0) {
    for (int c = tid; c < hd; c += THREADS) o[c] = 0.0f;
    return;
  }
  const float* ml = part_ml + (b * heads + h) * splits * 2;
  const float* po = part_o + (b * heads + h) * splits * hd;
  float m = LOWEST;
  for (int s = tid; s < live; s += THREADS) {
    wsm[s] = ml[2 * s];
    wsm[splits + s] = ml[2 * s + 1];
    m = fmaxf(m, wsm[s]);
  }
  m = block_reduce<true>(m, red);
  float l = 0.0f;
  for (int s = tid; s < live; s += THREADS) {
    const float w = expf(wsm[s] - m);
    wsm[s] = w;
    l += w * wsm[splits + s];
  }
  l = block_reduce<false>(l, red);
  for (int c = tid; c < hd; c += THREADS) {
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < live; ++s) acc = fmaf(po[s * hd + c], wsm[s], acc);
    o[c] = acc / l;
  }
}

}  // namespace

extern "C" {

// q [B, d] f32; k_pages / v_pages [n_pages, page_size, d] f32 (one layer of
// the pool); page_tables [B, pages_per_seq] int32; lens [B] int32; out [B, d]
// f32. head_dim >= 1 (staged 256 columns at a time), 1 <= chunk <= 64. The context splits into
// ceil(pages_per_seq * page_size / chunk) splits of `chunk` positions; with
// more than one, `partials` (B * heads * splits * (head_dim + 2) f32) holds
// their (max, sum) pairs and P.V rows and the combine kernel follows on the
// same stream. Returns the first launch error (cudaError_t).
int pt_paged_decode_attention(const void* q, const void* k_pages, const void* v_pages, const void* page_tables,
                              const void* lens, void* out, void* partials, int B, int d, int n_pages,
                              int page_size, int pages_per_seq, int head_dim, int chunk, float scale,
                              void* stream) {
  if (head_dim < 1 || d % head_dim || chunk < 1 || chunk > 64) return (int)cudaErrorInvalidValue;
  const int vec = (head_dim % 4 == 0 && d % 4 == 0) ? 4 : 1;
  const int ld = row_ld(head_dim < HD_TILE ? head_dim : HD_TILE, vec);
  const size_t bytes = sizeof(float) * ((size_t)2 * chunk * ld + head_dim + chunk);
  const int heads = d / head_dim;
  const int ctx = pages_per_seq * page_size;
  const int splits = (ctx + chunk - 1) / chunk;
  const dim3 grid(B, heads, splits);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float *qq = (const float*)q, *kp = (const float*)k_pages, *vp = (const float*)v_pages;
  const int *tb = (const int*)page_tables, *ln = (const int*)lens;
  float* part_ml = (float*)partials;
  float* part_o = part_ml + (size_t)B * heads * splits * 2;
  // the split kernel for these copies and this head dim, launched
  auto split = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, bytes, st>>>(qq, kp, vp, tb, ln, (float*)out, part_ml, part_o, d, n_pages, page_size,
                                         pages_per_seq, head_dim, chunk, scale);
    return cudaGetLastError();
  };
  const bool tiled = head_dim > HD_TILE;
  const cudaError_t err = vec == 4 ? split(tiled ? paged_decode_split_tiled_kernel<4> : paged_decode_split_kernel<4>)
                                   : split(tiled ? paged_decode_split_tiled_kernel<1> : paged_decode_split_kernel<1>);
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_decode_combine_kernel<<<dim3(B, heads), THREADS, sizeof(float) * 2 * splits, st>>>(
      part_ml, part_o, ln, (float*)out, d, ctx, head_dim, chunk, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
