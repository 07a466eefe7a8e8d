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
// layout), accumulation is f32 on the tensor cores.
//
// Bound on this card: at the main path's shapes (M = 1024 * 160 tokens,
// K = 384, N in {1152, 1536}) gemm_bias_act sits near the bf16 ridge point:
// qkv is bound by its bytes (X read, Y written), FFN-in by its operations.
// K is only 384, six 64-deep steps per output tile, so the cost of a tile's
// prologue and epilogue weighs as much as its math. Its design:
//   * TMA copies X and W tiles (128-byte swizzle) into a 6-stage shared-
//     memory ring with full/empty mbarriers, issued by one producer thread,
//     so a whole tile's K is in flight ahead of the math and the copies
//     need no registers;
//   * two consumer warpgroups run wgmma.m64n128k16 straight from shared
//     memory;
//   * the grid is persistent (one 128 x 128 tile block per SM) and walks the
//     tiles n-fastest: the producer loads the next tile while the consumers
//     do this one's epilogue (bias, tanh-GELU, bf16, TMA store).
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): qkv 0.260 ms against a
// 0.151 ms bound and 0.256 ms for cuBLAS (F.linear); FFN-in with GELU
// 0.539 ms against 0.195 ms and 0.667 ms (F.linear + F.gelu); the plain
// versions 4.094 and 11.342 ms.
//
// gemm_bias_residual_layernorm is a shared-memory tiled WMMA loop with no
// TMA, no wgmma and no multi-stage pipeline. It gives one block whole rows
// (all N columns), so the row statistics are computed in the epilogue.
// Both kernels keep their epilogues fused (bias, GELU, residual and
// LayerNorm never make a separate pass over device memory).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <mutex>

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
// TMA + wgmma, warp-specialised, persistent. A block has two consumer
// warpgroups (64 output rows each) and one producer warpgroup whose first
// thread keeps TMA loads of X [128, 64] and W [128, 64] tiles (128-byte
// swizzle, K-major) in flight through a STAGES-deep ring guarded by
// full/empty mbarriers. A consumer keeps one wgmma group in flight while
// it waits for the next stage, and frees a stage once the group that read
// it is done. The block walks output tiles n-fastest (blocks in flight
// share one X row block, read once from device memory), so the producer
// runs ahead into the next tile while the consumers do this tile's
// epilogue: + bias, GELU, bf16 into a 128-byte-swizzled staging tile in
// shared memory, written out by an asynchronous TMA store that drains
// while the next tile's math runs. TMA zero-fills the M, N and K tails of
// the loads and clips the store, so the one configuration serves every M,
// from the single-query embed (M = 32: 9 tiles) to a document batch.
constexpr int TBK = 64;    // K depth of one stage: 64 bf16 = one 128-byte swizzle row
constexpr int STAGES = 6;  // six 64-deep steps: a whole K = 384 tile in flight
constexpr int NWG = 2;             // consumer warpgroups, 64 output rows each
constexpr int TBM = 64 * NWG;      // 128 x 128 output tiles
constexpr int TBN = 128;
constexpr int A_BYTES = TBM * TBK * 2;
constexpr int B_BYTES = TBN * TBK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_BYTES = 64 * TBN * 2;  // one consumer's staged [64, TBN] bf16 output
// ring + staged outputs + barriers + alignment slack
constexpr int TMA_SMEM = STAGES * STAGE_BYTES + NWG * OUT_BYTES + 2 * STAGES * 8 + 1024;
constexpr int TMA_THREADS = 128 * (NWG + 1);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row core groups 1024 bytes apart (SBO), tile base
// 1024-byte aligned. A step of 16 along K adds 32 bytes to the address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;             // LBO (unused for swizzled K-major)
  d |= (uint64_t)(1024 >> 4) << 32;   // SBO
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read0() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait0() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64, 128] (+)= A[64, 16] B[16, 128]^T, both from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int ACT>
__global__ void __launch_bounds__(TMA_THREADS, 1)
gemm_bias_act_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap ty, const float* __restrict__ bias, int M,
                         int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte aligned tiles
  const uint32_t outs = base + STAGES * STAGE_BYTES;
  const uint32_t bars = outs + NWG * OUT_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tiles_n = (N + TBN - 1) / TBN;
  const int tiles = ((M + TBM - 1) / TBM) * tiles_n;
  const int ksteps = (K + TBK - 1) / TBK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread issues every copy
    if (tid % 128 == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * TBM, n0 = (tile % tiles_n) * TBN;
        for (int k = 0; k < ksteps; ++k) {
          mbar_wait(empty(stage), phase ^ 1u);
          const uint32_t a = base + stage * STAGE_BYTES;
          mbar_expect_tx(full(stage), STAGE_BYTES);  // out-of-range box parts count too (zero-filled)
          tma_load_2d(a, &tx, k * TBK, m0, full(stage));
          tma_load_2d(a + A_BYTES, &tw, k * TBK, n0, full(stage));
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
    float d[TBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    const int lt = tid % 128, w = lt / 32, lane = tid % 32;
    const uint32_t out = outs + wg * OUT_BYTES;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * TBM, n0 = (tile % tiles_n) * TBN;
      int prev = -1;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(full(stage), phase);
        const uint32_t a = base + stage * STAGE_BYTES + wg * 64 * TBK * 2;
        const uint32_t bt = base + stage * STAGE_BYTES + A_BYTES;
        const uint64_t da = sw128_desc(a), db = sw128_desc(bt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk)  // +32 bytes along K = +2 in the descriptor
          wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk, (k > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: its stage is free
        if (prev >= 0 && lt == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < TBN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
      if (lt == 0) mbar_arrive(empty(prev));

      // epilogue: + bias, GELU, bf16 into the staging tile (64-column boxes,
      // 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8))
      if (lt == 0) bulk_wait_read0();  // the previous tile's store has left the staging tile
      named_barrier(1 + wg, 128);
      const int g = lane / 4;
#pragma unroll
      for (int j = 0; j < TBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        const float b0 = col < N ? bias[col] : 0.0f;
        const float b1 = col + 1 < N ? bias[col + 1] : 0.0f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = w * 16 + g + 8 * hh;
          float v0 = d[4 * j + 2 * hh] + b0, v1 = d[4 * j + 2 * hh + 1] + b1;
          if (ACT) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          }
          const uint32_t off = (j / 8) * 8192 + r * 128 + (((j % 8) ^ g) * 16) + (lane % 4) * 4;
          *reinterpret_cast<__nv_bfloat162*>(smem_raw + (out - raw) + off) = __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_proxy_async();  // the staged values are visible to the TMA unit
      named_barrier(1 + wg, 128);
      if (lt == 0) {
#pragma unroll
        for (int bb = 0; bb < TBN / 64; ++bb) tma_store_2d(&ty, out + bb * 8192, n0 + 64 * bb, m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (lt == 0) bulk_wait0();
  }
}

// cuTensorMapEncodeTiled is a driver-API function; it is fetched through the
// runtime so the library links nothing beyond cudart.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major [rows, cols] bf16 matrix seen as boxes of [box_rows, 64],
// 128-byte swizzle. A map is a pure function of these arguments, so maps
// are kept in a small cache: a call with a pointer and shape seen before
// (the layer's weights, a reused activation buffer) encodes nothing.
struct MapEntry {
  const void* ptr;
  int rows, cols, box_rows;
  CUtensorMap map;
};

bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  constexpr int CACHE = 32;
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
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)TBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, elem,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  MapEntry& e = cache[next];
  e = MapEntry{ptr, rows, cols, box_rows, *map};
  next = (next + 1) % CACHE;
  if (used < CACHE) ++used;
  return true;
}

template <int ACT>
cudaError_t launch_tma(const bf16* X, const bf16* W, const float* bias, bf16* Y, int M, int N, int K,
                       cudaStream_t stream) {
  static int max_grid = 0;  // resident blocks on the whole card, found once
  auto kernel = gemm_bias_act_tma_kernel<ACT>;
  if (!max_grid) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TMA_THREADS, TMA_SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_grid = sms * per_sm;
  }
  CUtensorMap tx, tw, ty;
  if (!tensor_map(&tx, X, M, K, TBM) || !tensor_map(&tw, W, N, K, TBN) || !tensor_map(&ty, Y, M, N, 64))
    return cudaErrorInvalidValue;
  const int tiles = ((M + TBM - 1) / TBM) * ((N + TBN - 1) / TBN);
  const int grid = tiles < max_grid ? tiles : max_grid;
  kernel<<<grid, TMA_THREADS, TMA_SMEM, stream>>>(tx, tw, ty, bias, M, N, K);
  return cudaGetLastError();
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
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bf16* x = (const bf16*)X;
  const bf16* w = (const bf16*)W;
  if (act) return (int)launch_tma<1>(x, w, (const float*)bias, (bf16*)Y, M, N, K, s);
  return (int)launch_tma<0>(x, w, (const float*)bias, (bf16*)Y, M, N, K, s);
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
