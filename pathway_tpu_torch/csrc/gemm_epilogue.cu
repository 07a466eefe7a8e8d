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
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): qkv 0.257 ms against a
// 0.151 ms bound and 0.255 ms for cuBLAS (F.linear); FFN-in with GELU
// 0.541-0.549 ms against 0.195 ms and 0.669 ms (F.linear + F.gelu).
//
// gemm_bias_residual_layernorm reuses that mainloop with an output tile that
// spans whole rows (N up to 768; N = 1024 in two column chunks), so the
// LayerNorm statistics come from the accumulators in the epilogue: bias,
// residual, LayerNorm and the f32 and bf16 stores never make a separate
// pass over device memory. At the main path's shapes (M = 163,840, N = 384,
// K = 384 or 1536) it reads X and the residual and writes the rows once,
// which bounds it by bytes; the weight tile is re-read from L2 by every
// 128-row tile. On an H100 80GB HBM3 at 700 W (chip_smoke.py): out
// projection + LN1 (K 384) 0.455-0.458 ms against a 0.188 ms bound and
// 0.749 ms for F.linear + F.layer_norm; FFN out + LN2 (K 1536) 0.681-0.682
// ms against 0.263 and 0.854 ms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper_tma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  // tanh-approximate GELU, as jax.nn.gelu(approximate=True)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
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

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read0() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait0() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// wgmma.m64nNk16 for the widths the kernels issue, accumulators in registers
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  // D[64, 128] (+)= A[64, 16] B[16, 128]^T, both from shared memory
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
};

template <>
struct Wgmma<192> {
  // D[64, 192] (+)= A[64, 16] B[16, 192]^T, both from shared memory
  __device__ __forceinline__ static void run(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
          "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
          "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
          "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

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
          Wgmma<TBN>::run(d, da + 2 * kk, db + 2 * kk, (k > 0 || kk > 0) ? 1 : 0);
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
// The same TMA ring and wgmma mainloop, with an output tile that spans whole
// rows, so the LayerNorm statistics are taken in the epilogue, from the
// accumulators, without a second pass over memory. Two consumer warpgroups
// (256 threads, no separate producer: thread 0 issues the TMA loads for the
// step STAGES ahead as soon as both warpgroups have freed a stage, so at
// most 255 registers a thread hold up to 192 f32 accumulators). A tile is
// BM = 64 RG rows x the chunk's CN columns; warpgroup (rg, cs) owns rows
// [64 rg, 64 rg + 64) and columns [CW cs, CW cs + CW) of it, issued as NP
// wgmma of width PN. With CS = 2 the two warpgroups split the columns and
// exchange each row's sum and sum of squared deviations through shared
// memory. Widths whose row does not fit the registers (N = 1024) run in
// NCH = 2 column chunks: each chunk's pre-LayerNorm rows go to the f32
// output, its statistics merge into the row's (Chan's pairwise update),
// and a last pass normalises the rows from there (L2-resident).
//   N     RG CS NCH  per warpgroup      stages
//   256   2  1  1    64 x 256 (2 x 128)  4
//   384   2  1  1    64 x 384 (2 x 192)  3
//   512   1  2  1    64 x 256 (2 x 128)  2
//   768   1  2  1    64 x 384 (2 x 192)  2
//   1024  1  2  2    64 x 256 (2 x 128)  3
// The grid is persistent (one block per SM: ring and staging take 150-226
// KB) and the loads of the next tile run under this tile's epilogue. The
// residual is read in bf16 or f32 (a template parameter: no branch in the
// loop); LayerNorm is mean((x - mu)^2) in f32, as the plain version
// computes it. The epilogue works on the accumulator registers in place
// (v, then v - mean): at N = 384 a thread holds 192 of them, and any copy
// would spill. The rows leave through a [16, 32] f32 tile per warp in
// shared memory, so that every store writes whole row segments.
//
// Other widths: the wrapper pads a row of width n (any n up to 1024) to the
// next width above with zero weight rows, bias, gamma, beta and residual
// columns, and passes n as n_live. Columns at or past n_live hold exactly 0
// before the LayerNorm; they are left out of the row's mean and variance
// (each chunk counts its live columns) and leave as 0, which the wrapper
// slices off.

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the residual's two columns of a thread, in f32, as its type reads them
__device__ __forceinline__ float2 load2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

template <int N, int RG, int CS, int NCH, int STAGES>
struct LnTile {
  static constexpr int BM = 64 * RG;   // rows per tile
  static constexpr int CN = N / NCH;   // columns per chunk
  static constexpr int CW = CN / CS;   // columns per warpgroup
  static constexpr int PN = CW > 256 ? CW / 2 : (CW == 256 ? 128 : CW);  // width of one wgmma
  static constexpr int NP = CW / PN;
  static constexpr int BOX = 128;      // W rows per TMA box
  static constexpr int A_BYTES = BM * TBK * 2;
  static constexpr int STAGE = A_BYTES + CN * TBK * 2;
  static constexpr int TILE = 16 * 32 * 4;              // a warp's [16, 32] f32 output tile
  static constexpr int STAGING = NCH == 1 ? 8 * TILE : 0;  // (N = 1024 writes its rows directly)
  static constexpr int SMEM = STAGES * STAGE + STAGING + 2 * STAGES * 8 + 2 * CS * BM * 4 + 1024;
  static_assert(RG * CS == 2, "two consumer warpgroups");
  static_assert(CN % BOX == 0 && CW % PN == 0 && NP * PN == CW, "column split");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

template <int N, int RG, int CS, int NCH, int STAGES, typename RT>
__global__ void __launch_bounds__(256, 1)
gemm_res_ln_tma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                       const float* __restrict__ bias, const RT* __restrict__ R, const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* __restrict__ Yf, bf16* __restrict__ Yb, int M, int K,
                       int n_live, float eps) {
  using T = LnTile<N, RG, CS, NCH, STAGES>;
  constexpr int PN = T::PN, NP = T::NP, CW = T::CW, CN = T::CN, BM = T::BM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128-byte swizzle wants 1024-byte aligned tiles
  const uint32_t staging = base + STAGES * T::STAGE;
  const uint32_t bars = staging + T::STAGING;
  float* red = reinterpret_cast<float*>(smem_raw + (bars - raw) + 2 * STAGES * 8);  // [2][CS][BM]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, lt = tid % 128, w = lt / 32, lane = tid % 32, g = lane / 4;
  const int rg = wg / CS, cs = wg % CS;
  const int tiles = (M + BM - 1) / BM;
  const int ksteps = (K + TBK - 1) / TBK;
  const int per_tile = NCH * ksteps;
  const int my_tiles = tiles > (int)blockIdx.x ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_tiles * per_tile;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step i of this block (tile, chunk, k) into stage i % STAGES; thread 0 only
  auto issue = [&](int i) {
    const int s = i % STAGES;
    mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1u);
    const int tile = blockIdx.x + (i / per_tile) * gridDim.x;
    const int ch = (i % per_tile) / ksteps, k = i % ksteps;
    const uint32_t a = base + s * T::STAGE;
    mbar_expect_tx(full(s), T::STAGE);  // out-of-range box parts count too (zero-filled)
    tma_load_2d(a, &tx, k * TBK, tile * BM, full(s));
#pragma unroll
    for (int bx = 0; bx < CN / T::BOX; ++bx)
      tma_load_2d(a + T::A_BYTES + bx * T::BOX * 128, &tw, k * TBK, ch * CN + bx * T::BOX, full(s));
  };
  // a warpgroup is done with step i: free its stage, and refill it STAGES ahead
  auto release = [&](int i) {
    if (lt == 0) mbar_arrive(empty(i % STAGES));
    if (tid == 0 && i + STAGES < total) issue(i + STAGES);
  };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
    for (int i = 0; i < STAGES && i < total; ++i) issue(i);
  }

  // a row statistic of this thread's two rows (g, g + 8 of its warp's 16),
  // summed over the warpgroup's columns and, with CS = 2, over both
  // warpgroups through shared memory buffer `buf`
  auto row_total = [&](float (&x)[2], int buf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      x[r] += __shfl_xor_sync(0xffffffffu, x[r], 1);
      x[r] += __shfl_xor_sync(0xffffffffu, x[r], 2);
    }
    if (CS > 1) {
      const int rl = rg * 64 + w * 16 + g;
      if (lane % 4 == 0) {
        red[(buf * CS + cs) * BM + rl] = x[0];
        red[(buf * CS + cs) * BM + rl + 8] = x[1];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < CS; ++c) x[r] += red[(buf * CS + c) * BM + rl + 8 * r];
      }
    }
  };

  float d[NP][PN / 2];
  int c = 0;  // steps consumed
  for (int t = 0; t < my_tiles; ++t) {
    const int64_t row0 = (int64_t)(blockIdx.x + t * gridDim.x) * BM + rg * 64 + w * 16 + g;
    float mean[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
    for (int ch = 0; ch < NCH; ++ch) {
      for (int k = 0; k < ksteps; ++k, ++c) {
        const int s = c % STAGES;
        mbar_wait(full(s), (c / STAGES) & 1);
        const uint32_t a = base + s * T::STAGE + rg * 64 * TBK * 2;
        const uint32_t bt = base + s * T::STAGE + T::A_BYTES + cs * CW * TBK * 2;
        const uint64_t da = sw128_desc(a);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk)  // +32 bytes along K = +2 in the descriptor
#pragma unroll
          for (int p = 0; p < NP; ++p)
            Wgmma<PN>::run(d[p], da + 2 * kk, sw128_desc(bt + p * PN * TBK * 2) + 2 * kk, (k > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: its stage is free
        if (k > 0) release(c - 1);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < PN / 2; ++i) asm volatile("" : "+f"(d[p][i])::"memory");
      release(c - 1);

      // epilogue of the chunk: v = residual + (acc + bias), its row statistics
      const int col0 = ch * CN + cs * CW + 2 * (lane % 4);
      const bool ok[2] = {row0 < M, row0 + 8 < M};
      const RT* res[2] = {R + row0 * N + col0, R + (row0 + 8) * N + col0};  // read only where ok
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < PN / 8; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col0 + p * PN + 8 * j));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 rv = ok[hh] ? load2(res[hh] + p * PN + 8 * j) : make_float2(0.0f, 0.0f);
            float& a0 = d[p][4 * j + 2 * hh];
            float& a1 = d[p][4 * j + 2 * hh + 1];
            a0 = rv.x + (a0 + bb.x);
            a1 = rv.y + (a1 + bb.y);
            sum[hh] += a0 + a1;
          }
        }
      row_total(sum, 0);
      // the chunk's live columns (all CN unless the row is padded), and the live ones before it
      const int done = min(ch * CN, n_live);
      const int cnt = min(CN, n_live - done);
      const float cmean[2] = {cnt > 0 ? sum[0] / cnt : 0.0f, cnt > 0 ? sum[1] / cnt : 0.0f};
      // centred in place: the registers hold v - mean from here on (a
      // separate copy of the 192 differences would not fit and spill)
      float sq[2] = {0.0f, 0.0f};
      if (cnt == CN) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < PN / 2; ++i) {
            d[p][i] -= cmean[(i >> 1) & 1];
            sq[(i >> 1) & 1] += d[p][i] * d[p][i];
          }
      } else {  // a padded row: its pad columns stay 0 and add nothing
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int i = 0; i < PN / 2; ++i) {
            const bool live = col0 + p * PN + 8 * (i >> 2) + (i & 1) < n_live;
            d[p][i] = live ? d[p][i] - cmean[(i >> 1) & 1] : 0.0f;
            sq[(i >> 1) & 1] += d[p][i] * d[p][i];
          }
      }
      row_total(sq, 1);
      if (NCH == 1) {
        mean[0] = cmean[0];
        mean[1] = cmean[1];
        m2[0] = sq[0];
        m2[1] = sq[1];
        const float inv[2] = {rsqrtf(m2[0] / n_live + eps), rsqrtf(m2[1] / n_live + eps)};
        // y = (v - mean) * inv * gamma + beta, stored as f32 (when asked) and
        // bf16 through the warp's [16, 32] staging tile, 32 columns at a
        // time: the accumulator layout puts 8 rows x 32 bytes in one warp
        // store, the tile lets every store write whole 128- and 64-byte row
        // segments. Column c of tile row r sits at c ^ 8 (r % 4): no bank
        // conflicts either way.
        float* tile = reinterpret_cast<float*>(smem_raw + (staging - raw)) + (wg * 4 + w) * (T::TILE / 4);
        const int64_t wrow = row0 - g;  // the warp's first row
        auto write = [&](auto with_f32) {
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int cc = 0; cc < PN / 32; ++cc) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int j = 4 * cc + jj;
                const int col = col0 + p * PN + 8 * j;
                const float2 ga = __ldg(reinterpret_cast<const float2*>(gamma + col));
                const float2 be = __ldg(reinterpret_cast<const float2*>(beta + col));
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const int r = g + 8 * hh;
                  *reinterpret_cast<float2*>(tile + r * 32 + ((8 * jj + 2 * (lane % 4)) ^ ((r & 3) << 3))) =
                      make_float2(d[p][4 * j + 2 * hh] * inv[hh] * ga.x + be.x,
                                  d[p][4 * j + 2 * hh + 1] * inv[hh] * ga.y + be.y);
                }
              }
              __syncwarp();
              const int cbase = ch * CN + cs * CW + p * PN + 32 * cc;
              if constexpr (decltype(with_f32)::value) {
#pragma unroll
                for (int it = 0; it < 4; ++it) {  // 16 rows x 8 float4
                  const int r = (32 * it + lane) >> 3, k = lane & 7;
                  if (wrow + r < M)
                    *reinterpret_cast<float4*>(Yf + (wrow + r) * N + cbase + 4 * k) =
                        *reinterpret_cast<const float4*>(tile + r * 32 + ((4 * k) ^ ((r & 3) << 3)));
                }
              }
#pragma unroll
              for (int it = 0; it < 2; ++it) {  // 16 rows x 4 x 8 bf16
                const int r = (32 * it + lane) >> 2, k = lane & 3;
                if (wrow + r < M) {
                  const float4 a = *reinterpret_cast<const float4*>(tile + r * 32 + ((8 * k) ^ ((r & 3) << 3)));
                  const float4 b = *reinterpret_cast<const float4*>(tile + r * 32 + ((8 * k + 4) ^ ((r & 3) << 3)));
                  uint4 o;
                  o.x = pack_bf16x2(a.x, a.y);
                  o.y = pack_bf16x2(a.z, a.w);
                  o.z = pack_bf16x2(b.x, b.y);
                  o.w = pack_bf16x2(b.z, b.w);
                  *reinterpret_cast<uint4*>(Yb + (wrow + r) * N + cbase + 8 * k) = o;
                }
              }
              __syncwarp();  // the tile is read before the next chunk overwrites it
            }
        };
        if (Yf)
          write(std::true_type{});
        else
          write(std::false_type{});
      } else {
        const float na = (float)done, nc = (float)cnt, nn = (float)(done + cnt);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (cnt <= 0) break;
          const float delta = cmean[r] - mean[r];
          mean[r] += delta * (nc / nn);
          m2[r] += sq[r] + delta * delta * (na * nc / nn);
        }
        // the pre-LayerNorm rows wait in the f32 output
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < PN / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (ok[hh])
                *reinterpret_cast<float2*>(Yf + (row0 + 8 * hh) * N + col0 + p * PN + 8 * j) =
                    make_float2(d[p][4 * j + 2 * hh] + cmean[hh], d[p][4 * j + 2 * hh + 1] + cmean[hh]);
      }
    }
    if (NCH > 1) {  // normalise the staged rows: each thread reads back what it wrote
      const float inv[2] = {rsqrtf(m2[0] / n_live + eps), rsqrtf(m2[1] / n_live + eps)};
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll 4
          for (int j = 0; j < PN / 8; ++j) {
            const int col = ch * CN + cs * CW + 2 * (lane % 4) + p * PN + 8 * j;
            const float2 ga = __ldg(reinterpret_cast<const float2*>(gamma + col));
            const float2 be = __ldg(reinterpret_cast<const float2*>(beta + col));
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int64_t row = row0 + 8 * hh;
              if (row >= M) continue;
              float2* yf = reinterpret_cast<float2*>(Yf + row * N + col);
              const float2 v = *yf;
              const float y0 = (v.x - mean[hh]) * inv[hh] * ga.x + be.x;
              const float y1 = (v.y - mean[hh]) * inv[hh] * ga.y + be.y;
              *yf = make_float2(y0, y1);
              *reinterpret_cast<__nv_bfloat162*>(Yb + row * N + col) = __floats2bfloat162_rn(y0, y1);
            }
          }
    }
  }
}

template <int N, int RG, int CS, int NCH, int STAGES, typename RT>
cudaError_t launch_res_ln(const bf16* X, const bf16* W, const float* bias, const RT* R, const float* gamma,
                          const float* beta, float* Yf, bf16* Yb, int M, int K, int n_live, float eps,
                          cudaStream_t stream) {
  using T = LnTile<N, RG, CS, NCH, STAGES>;
  static int max_grid = 0;  // resident blocks on the whole card, found once
  auto kernel = gemm_res_ln_tma_kernel<N, RG, CS, NCH, STAGES, RT>;
  if (NCH > 1 && !Yf) return cudaErrorInvalidValue;  // the rows are staged in Yf
  if (!max_grid) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, T::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_grid = sms * per_sm;
  }
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, X, M, K, T::BM) || !tensor_map(&tw, W, N, K, T::BOX)) return cudaErrorInvalidValue;
  const int tiles = (M + T::BM - 1) / T::BM;
  const int grid = tiles < max_grid ? tiles : max_grid;
  kernel<<<grid, 256, T::SMEM, stream>>>(tx, tw, bias, R, gamma, beta, Yf, Yb, M, K, n_live, eps);
  return cudaGetLastError();
}

// the launch for a bf16 or an f32 residual
template <int N, int RG, int CS, int NCH, int STAGES>
cudaError_t launch_res_ln_any(const bf16* X, const bf16* W, const float* bias, const void* R, int r_is_f32,
                              const float* gamma, const float* beta, float* Yf, bf16* Yb, int M, int K, int n_live,
                              float eps, cudaStream_t stream) {
  if (r_is_f32)
    return launch_res_ln<N, RG, CS, NCH, STAGES>(X, W, bias, (const float*)R, gamma, beta, Yf, Yb, M, K, n_live, eps,
                                                 stream);
  return launch_res_ln<N, RG, CS, NCH, STAGES>(X, W, bias, (const bf16*)R, gamma, beta, Yf, Yb, M, K, n_live, eps,
                                               stream);
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

// N in {256, 384, 512, 768, 1024}, K % 8 == 0; the first n_live (0 <
// n_live <= N) columns are the row, the rest zero padding; Yf may be null
// except at N = 1024, where the rows are staged there. Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for another N.
int pt_gemm_bias_residual_layernorm(const void* X, const void* W, const void* bias,
                                    const void* R, int r_is_f32, const void* gamma,
                                    const void* beta, void* Yf, void* Yb, int M, int N, int n_live,
                                    int K, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define PT_RES_LN(NN, RG, CS, NCH, ST)                                                         \
  case NN:                                                                                     \
    return (int)launch_res_ln_any<NN, RG, CS, NCH, ST>((const bf16*)X, (const bf16*)W, (const float*)bias, R, \
                                                   r_is_f32, (const float*)gamma, (const float*)beta, \
                                                   (float*)Yf, (bf16*)Yb, M, K, n_live, eps, s);
  if (K % 8 || n_live <= 0 || n_live > N) return (int)cudaErrorInvalidValue;
  switch (N) {
    PT_RES_LN(256, 2, 1, 1, 4)
    PT_RES_LN(384, 2, 1, 1, 3)
    PT_RES_LN(512, 1, 2, 1, 2)
    PT_RES_LN(768, 1, 2, 1, 2)
    PT_RES_LN(1024, 1, 2, 2, 3)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PT_RES_LN
}

}  // extern "C"
