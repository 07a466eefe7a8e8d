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
// and carry nothing between them, so one block owns one (sequence, head)
// and reads its own page-table row and length:
//
//   * it loops over the live positions only (j < length), finding each K/V
//     row through the table, so there is no gather buffer and no zero-fill;
//   * table entries are clamped to [0, n_pages - 1] (the TPU kernel's index
//     map clamps to n_pages - 1), and no position at or past the length is
//     ever read;
//   * the f32 scores of the whole context sit in shared memory (at most
//     pages_per_seq * page_size floats), then one max / exp / sum pass and
//     the probabilities times V: a single-pass softmax, no online rescaling;
//   * a length-0 sequence writes exact zeros.
//
// Numerics: everything is f32. The TPU kernel is bitwise equal to its
// reference only because both run the same ops under one compiler; here the
// dot products sum in another order than PyTorch's, so the kernel is held to
// paged_attention_reference within 1e-4 (f32), not bitwise.
//
// Bound on this card: one decode step reads each live K and V row once
// (2 * 4 * d bytes per context position) and does 4 * d operations on it,
// so it is bytes-bound by far. Each warp reads whole 4-byte-per-lane rows
// of K and each thread one column of V, coalesced within a row; the
// scores never leave shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

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

// reduce one value per thread over the block; every thread gets the result
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__global__ void __launch_bounds__(THREADS)
paged_decode_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                              const float* __restrict__ v_pages, const int* __restrict__ tables,
                              const int* __restrict__ lens, float* __restrict__ out, int d,
                              int n_pages, int page_size, int pages_per_seq, int hd,
                              float scale) {
  extern __shared__ float sc[];  // [pages_per_seq * page_size] scores, then probabilities
  __shared__ float qs[128];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t b = blockIdx.x;
  const int h = blockIdx.y;
  const int ctx = pages_per_seq * page_size;
  const int len = min(max(lens[b], 0), ctx);
  float* o = out + b * d + h * hd;
  if (len == 0) {
    for (int i = tid; i < hd; i += THREADS) o[i] = 0.0f;
    return;
  }
  for (int i = tid; i < hd; i += THREADS) qs[i] = q[b * d + h * hd + i];
  __syncthreads();

  const int* table = tables + b * pages_per_seq;
  // scores: one warp per context position, lanes across the head dim
  for (int j = warp; j < len; j += THREADS / 32) {
    const int page = max(0, min(table[j / page_size], n_pages - 1));
    const float* krow = k_pages + ((int64_t)page * page_size + j % page_size) * d + h * hd;
    float s = 0.0f;
    for (int i = lane; i < hd; i += 32) s += qs[i] * krow[i];
    s = warp_sum(s);
    if (lane == 0) sc[j] = s * scale;
  }
  __syncthreads();

  float m = -3.0e38f;
  for (int j = tid; j < len; j += THREADS) m = fmaxf(m, sc[j]);
  m = block_reduce<true>(m, red);
  float sum = 0.0f;
  for (int j = tid; j < len; j += THREADS) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = tid; j < len; j += THREADS) sc[j] = sc[j] / sum;
  __syncthreads();

  // probabilities times V: thread (group g, column c) sums positions j = g mod groups
  const int groups = THREADS / hd;
  const int c = tid % hd, g = tid / hd;
  float acc = 0.0f;
  if (g < groups) {
    for (int j = g; j < len; j += groups) {
      const int page = max(0, min(table[j / page_size], n_pages - 1));
      acc += sc[j] * v_pages[((int64_t)page * page_size + j % page_size) * d + h * hd + c];
    }
  }
  __syncthreads();
  red[tid] = acc;
  __syncthreads();
  if (tid < hd) {
    float r = red[tid];
    for (int gg = 1; gg < groups; ++gg) r += red[gg * hd + tid];
    o[tid] = r;
  }
}

}  // namespace

extern "C" {

// q [B, d] f32; k_pages / v_pages [n_pages, page_size, d] f32 (one layer of
// the pool); page_tables [B, pages_per_seq] int32; lens [B] int32; out [B, d]
// f32. head_dim in {32, 64, 128}. Returns the launch's cudaError_t.
int pt_paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                              const void* page_tables, const void* lens, void* out, int B, int d,
                              int n_pages, int page_size, int pages_per_seq, int head_dim,
                              float scale, void* stream) {
  if (head_dim != 32 && head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  if (d % head_dim) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)pages_per_seq * page_size * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, d / head_dim);
  paged_decode_attention_kernel<<<grid, THREADS, bytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_pages),
      reinterpret_cast<const float*>(v_pages), reinterpret_cast<const int*>(page_tables),
      reinterpret_cast<const int*>(lens), reinterpret_cast<float*>(out), d, n_pages, page_size,
      pages_per_seq, head_dim, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
