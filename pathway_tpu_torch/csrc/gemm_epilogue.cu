// Projections of one encoder layer with fused epilogues, for Hopper (sm_90a).
//
// Replaces: pathway_tpu/ops/fused_layer.py::fused_layer_tokens (body
// _layer_kernel) -- its qkv projection, out projection + residual +
// LayerNorm, FFN in + tanh-GELU, and FFN out + residual + LayerNorm. The
// TPU kernel keeps a whole layer's weights (about 3.5 MB in bf16 at MiniLM
// width) resident in VMEM; a Hopper block has at most 227 KB of shared
// memory, so the layer is split into these two GEMM kernels plus
// masked_attention.cu, and the activations between them go through device
// memory.
//
// gemm_bias_act:                 Y = act(X W^T + b)        bf16 out
// gemm_bias_residual_layernorm:  Y = LN(R + X W^T + b)     bf16 (and f32) out
//
// X is [M, K] bf16 row-major, W is [N, K] bf16 row-major (torch Linear
// layout), accumulation is f32 on the tensor cores (WMMA 16x16x16 bf16).
//
// Bound on this card: at the main path's shapes (M = 1024 * 160 tokens,
// K/N in {384, 1152, 1536}) each product is above the bf16 ridge point, so
// operations bound them. This first version is a plain shared-memory tiled
// WMMA loop with no TMA, no wgmma and no multi-stage pipeline; it keeps the
// epilogues fused (bias, GELU, residual and LayerNorm never make a separate
// pass over device memory) and leaves the asynchronous pipeline to later work.
// The residual-LayerNorm kernel gives one block whole rows (all N columns),
// so the row statistics are computed in the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 32;        // depth of one K step
constexpr int LDS = BK + 8;   // bf16 row stride of a staged tile (keeps WMMA alignment)

__device__ __forceinline__ float gelu_tanh(float x) {
  // tanh-approximate GELU, as jax.nn.gelu(approximate=True)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [r0, r0 + rows) x cols [k0, k0 + BK) of a row-major [R, K] bf16
// matrix into shared memory, 16 bytes per load; out-of-range rows are zero.
// K % 8 == 0 is checked by the caller, so a 16-byte chunk is in range whole.
__device__ __forceinline__ void stage_tile(bf16* s, const bf16* __restrict__ g, int R, int K,
                                           int r0, int k0, int rows, int tid, int nthreads) {
  for (int c = tid; c < rows * (BK / 8); c += nthreads) {
    const int r = c / (BK / 8);
    const int kc = (c % (BK / 8)) * 8;
    const int gr = r0 + r;
    const int gk = k0 + kc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < R && gk < K) v = *reinterpret_cast<const uint4*>(g + (int64_t)gr * K + gk);
    *reinterpret_cast<uint4*>(s + r * LDS + kc) = v;
  }
}

// ---------------------------------------------------------------- bias + act
constexpr int GBM = 64, GBN = 64, GLDC = GBN + 4;

template <int ACT>
__global__ void __launch_bounds__(128)
gemm_bias_act_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
                     const float* __restrict__ bias, bf16* __restrict__ Y, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[GBM * LDS];
  __shared__ __align__(128) bf16 Bs[GBN * LDS];
  __shared__ __align__(128) float Cs[GBM * GLDC];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * GBM;
  const int n0 = blockIdx.x * GBN;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile(As, X, M, K, m0, k0, GBM, tid, 128);
    stage_tile(Bs, W, N, K, n0, k0, GBN, tid, 128);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + (wn + 16 * j) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * GLDC + wn + 16 * j, acc[i][j], GLDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < GBM * GBN; e += 128) {
    const int r = e / GBN, c = e % GBN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      float v = Cs[r * GLDC + c] + bias[gc];
      if (ACT) v = gelu_tanh(v);
      Y[(int64_t)gr * N + gc] = __float2bfloat16(v);
    }
  }
}

// ------------------------------------------------- residual + LayerNorm rows
constexpr int LBM = 32;  // rows per block; 8 warps

template <int N>
__global__ void __launch_bounds__(256)
gemm_res_ln_kernel(const bf16* __restrict__ X, const bf16* __restrict__ W,
                   const float* __restrict__ bias, const void* __restrict__ R, int r_is_f32,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   float* __restrict__ Yf, bf16* __restrict__ Yb, int M, int K, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [LBM, LDS]
  bf16* Bs = As + LBM * LDS;                 // [N, LDS]
  float* Cs = reinterpret_cast<float*>(smem);  // [LBM, N + 4], reused after the K loop
  constexpr int LDC = N + 4;
  constexpr int CPW = N / 16 / 8;  // 16-wide column fragments per warp
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * LBM;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][CPW];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CPW; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_tile(As, X, M, K, m0, k0, LBM, tid, 256);
    stage_tile(Bs, W, N, K, 0, k0, N, tid, 256);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + 16 * i * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < CPW; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Bs + (warp * CPW + j) * 16 * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < CPW; ++j)
      wmma::store_matrix_sync(Cs + 16 * i * LDC + (warp * CPW + j) * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue: one warp per row, N / 32 columns per lane
  constexpr int PER = N / 32;
  for (int rr = 0; rr < LBM / 8; ++rr) {
    const int r = warp * (LBM / 8) + rr;
    const int64_t gr = m0 + r;
    if (gr >= M) break;  // warp-uniform
    float v[PER];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      const float res = r_is_f32 ? reinterpret_cast<const float*>(R)[gr * N + c]
                                 : __bfloat162float(reinterpret_cast<const bf16*>(R)[gr * N + c]);
      v[j] = res + (Cs[r * LDC + c] + bias[c]);
      s += v[j];
    }
    const float mu = warp_sum(s) / N;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < PER; ++j) q += (v[j] - mu) * (v[j] - mu);
    const float inv = rsqrtf(warp_sum(q) / N + eps);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = lane + 32 * j;
      const float y = (v[j] - mu) * inv * gamma[c] + beta[c];
      if (Yf) Yf[gr * N + c] = y;
      // kept conditional although callers always pass Yb: the unconditional
      // store compiles to more registers and one block per SM instead of two
      if (Yb) Yb[gr * N + c] = __float2bfloat16(y);
    }
  }
}

template <int N>
cudaError_t launch_res_ln(const bf16* X, const bf16* W, const float* bias, const void* R,
                          int r_is_f32, const float* gamma, const float* beta, float* Yf,
                          bf16* Yb, int M, int K, float eps, cudaStream_t stream) {
  const size_t stage = (size_t)(LBM + N) * LDS * sizeof(bf16);
  const size_t epi = (size_t)LBM * (N + 4) * sizeof(float);
  const size_t bytes = stage > epi ? stage : epi;
  cudaError_t err = cudaFuncSetAttribute(gemm_res_ln_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((M + LBM - 1) / LBM);
  gemm_res_ln_kernel<N><<<grid, 256, bytes, stream>>>(X, W, bias, R, r_is_f32, gamma, beta, Yf,
                                                      Yb, M, K, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// act: 0 = none, 1 = tanh-GELU. Returns the launch's cudaError_t.
int pt_gemm_bias_act(const void* X, const void* W, const void* bias, void* Y, int M, int N,
                     int K, int act, void* stream) {
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (act)
    gemm_bias_act_kernel<1><<<grid, 128, 0, s>>>((const bf16*)X, (const bf16*)W,
                                                 (const float*)bias, (bf16*)Y, M, N, K);
  else
    gemm_bias_act_kernel<0><<<grid, 128, 0, s>>>((const bf16*)X, (const bf16*)W,
                                                 (const float*)bias, (bf16*)Y, M, N, K);
  return (int)cudaGetLastError();
}

// N = 384 (MiniLM width); Yf (and Yb) may be null. Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for another N.
int pt_gemm_bias_residual_layernorm(const void* X, const void* W, const void* bias,
                                    const void* R, int r_is_f32, const void* gamma,
                                    const void* beta, void* Yf, void* Yb, int M, int N, int K,
                                    float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define PT_RES_LN(NN)                                                                         \
  case NN:                                                                                    \
    return (int)launch_res_ln<NN>((const bf16*)X, (const bf16*)W, (const float*)bias, R,      \
                                  r_is_f32, (const float*)gamma, (const float*)beta,          \
                                  (float*)Yf, (bf16*)Yb, M, K, eps, s);
  switch (N) {
    PT_RES_LN(384)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_RES_LN
}

}  // extern "C"
