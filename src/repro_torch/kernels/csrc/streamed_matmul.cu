// GEMM C = A @ B with an fp32 accumulator, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mm_kernel
// (src/repro/kernels/streamed_matmul/kernel.py:17, grid at :48), a
// K-blocked product on the MXU whose wrapper pads M to a multiple of 8 and
// K, N to multiples of 128.
//
// fp32 (um_gemm_f32, the main path): 3xTF32 on the tensor cores.
//
// Bound on the H100 (published SXM peaks at 700 W): operations.  An n x n
// product does 2n^3 operations on 12n^2 bytes; the fastest units that take
// fp32 operands are the TF32 tensor cores, 495 TFLOP/s: 2n^3 / 495 TFLOP/s
// = 156.6 ms at the paper's n = 33,842, the function's bound.  IEEE fp32
// FMAs on the CUDA cores top out at 67 TFLOP/s (1,157 ms there).  TF32
// keeps only 10 bits of mantissa, which the JAX tests' fp32 tolerance
// (1e-3 sqrt(k), rtol 1e-2) does not allow.  3xTF32 keeps fp32's accuracy
// on the tensor cores: each operand x becomes x_hi = tf32(x) and
// x_lo = tf32(x - x_hi) (x - x_hi is exact in fp32), and
//   A B ~ A_lo B_hi + A_hi B_lo + A_hi B_hi,
// dropping A_lo B_lo, about 2^-22 of each product.  Three TF32 products:
// 3 * 2n^3 / 495 TFLOP/s = 469.8 ms at n = 33,842, the ceiling of this
// algorithm (three times the function's bound).
//
// Rounding.  tf32(x) rounds to nearest, ties away from zero, by hand on the
// bits: (bits + 0x1000) & ~0x1fff, what cvt.rna.tf32.f32 gives.  The tensor
// cores read only the top 19 bits of a TF32 operand (sign, 8 of exponent,
// 10 of mantissa) and ignore the low 13.  Both parts are rounded here, so
// their low 13 bits are already zero and the split is the same whether the
// hardware truncated or rounded them.  The plain version of the split is
// split_tf32_ref in streamed_matmul/ref.py; chip_smoke.py holds the two bit
// for bit.
//
// Accumulation.  The sum over K is not left to one wgmma accumulator:
// tried on the H100, that form's error against fp64 was several times
// torch.matmul's in fp32 and grew with K, as an accumulator that truncates
// its sums would drift, and it would fail the fp64 check of chip_smoke.py.
// Each 32-deep K step is summed by wgmma into a fresh accumulator instead
// and then added, rounded to nearest, into a running total on the CUDA
// cores (64 adds a thread a step).
//
// Design.  K goes in panels of at most 8,192 (kPanelK), of equal depth but
// for the last.  For each panel a split pre-pass (split_kernel, also its
// own C entry um_split_tf32) writes A_hi, A_lo as (M_p, K_c) and B^T_hi,
// B^T_lo as (N_p, K_c) into scratch that the wrapper allocates, zero-padded
// to the tile multiples, and the main kernel adds the panel's product into
// C (the first panel's overwrites it).  The pre-pass exists because TF32
// wgmma reads both operands K-major only (the transpose bit is for
// f16/bf16), because TMA needs 16-byte global strides (33,842 x 4 bytes is
// not a multiple of 16), and because padding removes every mask from the
// main loop.  It moves 27.5 GB at n = 33,842 (~8 ms at 3.35 TB/s).  The
// panels keep the scratch at 2 (M_p + N_p) K_c fp32, 3.7 GB at n = 33,842
// (5 panels of 6,784), where the whole of K would take 18.4 GB, more than
// A and B; each panel after the first reads C back once more.  The main
// kernel: a block of 384 threads owns a
// 128 x 128 tile of C.  One producer warpgroup (setmaxnreg 24) has one lane
// issue the four TMA loads of each 32-deep K step (A_hi, A_lo, B_hi, B_lo,
// 16 KB each, 128-byte swizzle) into a ring of 3 stages (192 KB) with full
// and empty mbarriers.  Two consumer warpgroups (setmaxnreg 240), 64 rows
// each, issue wgmma.m64n128k8.f32.tf32.tf32 from shared memory, three per
// k8 slice, the two small terms first as CUTLASS's 3xTF32 does, then wait
// for the step's products and add them into the total; the other
// warpgroup's products keep the tensor cores busy meanwhile.  Blocks are
// rastered in groups of 12 M tiles that walk the N tiles together, so the
// 132 blocks in flight share their A and B tiles in L2; but only while
// they stay in step along K.  Over the 532 waves of n = 33,842 the blocks
// drift apart and those tiles come from device memory again and again, so
// the grid goes out in launches of at most 16 waves, each of which starts
// its blocks together (tried on an H100: one launch of the whole grid ran
// far slower at that size).  So one um_gemm_f32 call launches, for each
// panel, 2 splits and ceil(tiles / (16 SMs)) products: 5 x (2 + 34) = 180
// kernels at n = 33,842 on the H100's 132 SMs.  Only the output store is
// masked.  K = 0 gives zeros.
//
// bf16 (um_gemm_bf16, test shapes only): a CUDA-core kernel, 128 x 128 x 8
// tiles, 8 x 8 register blocking, inputs widened to fp32 as they are staged
// and the fp32 sum rounded to bf16 (to nearest even) as it is stored.
#include "hopper_common.cuh"
#include "smem_limit.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// bf16: the CUDA cores
// ---------------------------------------------------------------------------
namespace cuda_core {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kBK / kThreads;  // elements of A (and of B) a thread stages
constexpr int kPadA = 4;

// Each thread owns an 8 x 8 register tile, split in two 4-wide halves 64
// rows and 64 columns apart, so its shared-memory reads are 16-byte vectors
// that no two threads of a half-warp take from the same bank.  A is staged
// k-major (transposed) with 4 floats of padding.  The next K tile is loaded
// into registers while the current one is multiplied.  Ragged edges of M,
// N and K are masked.
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ c, int64_t M, int64_t N, int64_t K) {
  __shared__ __align__(16) float As[kBK][kBM + kPadA];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  float a_next[kLoads], b_next[kLoads];
  auto load_tile = [&](int64_t k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int idx = tid + j * kThreads;
      const int64_t am = m0 + idx / kBK, ak = k0 + idx % kBK;
      a_next[j] = (am < M && ak < K) ? __bfloat162float(a[am * K + ak]) : 0.0f;
      const int64_t bk = k0 + idx / kBN, bn = n0 + idx % kBN;
      b_next[j] = (bk < K && bn < N) ? __bfloat162float(b[bk * N + bn]) : 0.0f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_tile(0);
  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int idx = tid + j * kThreads;
      As[idx % kBK][idx / kBK] = a_next[j];
      Bs[idx / kBN][idx % kBN] = b_next[j];
    }
    __syncthreads();
    if (k0 + kBK < K) load_tile(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (n < N) c[m * N + n] = __float2bfloat16(acc[i][j]);
    }
  }
}

int launch(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c, int64_t M,
           int64_t N, int64_t K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// fp32: 3xTF32 with wgmma and TMA
// ---------------------------------------------------------------------------
namespace tf32x3 {

using namespace um_hopper;

constexpr int kBM = 128, kBN = 128;
constexpr int kBK = 32;  // fp32 a K step: one swizzle row
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// Registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kGroupM = 12;  // M tiles that walk the N tiles together
constexpr int kWaves = 16;   // waves of blocks a launch, at most
constexpr uint32_t kRowBytes = kBK * 4;
constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma's 128- or 64-byte swizzle
constexpr uint32_t kAtom = 8 * kRowBytes;               // an 8-row swizzle atom
constexpr uint32_t kTileBytes = kBM * kRowBytes;  // each of A_hi, A_lo, B_hi, B_lo
constexpr uint32_t kStageBytes = 4 * kTileBytes;
constexpr int kStages = 192 * 1024 / kStageBytes;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment of the swizzle atoms
constexpr int kSplitTile = 32;
constexpr int64_t kPanelK = 8192;  // K depth of one panel of split scratch, at most
static_assert(kBM == kBN, "A and B tiles share one size");

// The bits of x rounded to TF32: to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// hi and lo (Rp, Cp) from src, read as (R, C) row-major or, with kT, as
// (C, R) row-major and transposed, rows ld floats apart; zero outside
// (R, C).  A 32 x 32 tile goes through shared memory so that both the
// reads and the writes are coalesced.
template <bool kT>
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ src, int64_t ld, float* __restrict__ hi,
                 float* __restrict__ lo, int64_t R, int64_t C, int64_t Rp, int64_t Cp) {
  __shared__ float t[kSplitTile][kSplitTile + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kSplitTile;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kSplitTile;
  const int tx = threadIdx.x % kSplitTile, ty = threadIdx.x / kSplitTile;
#pragma unroll
  for (int i = ty; i < kSplitTile; i += 256 / kSplitTile) {
    if (kT) {  // t[c][r] = src[c][r]
      const int64_t c = c0 + i, r = r0 + tx;
      t[i][tx] = c < C && r < R ? src[c * ld + r] : 0.0f;
    } else {  // t[r][c] = src[r][c]
      const int64_t r = r0 + i, c = c0 + tx;
      t[i][tx] = r < R && c < C ? src[r * ld + c] : 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kSplitTile; i += 256 / kSplitTile) {
    const int64_t r = r0 + i, c = c0 + tx;
    if (r >= Rp || c >= Cp) continue;
    const float x = kT ? t[tx][i] : t[i][tx];
    const float h = tf32_rna(x);
    hi[r * Cp + c] = h;
    lo[r * Cp + c] = tf32_rna(__fsub_rn(x, h));
  }
}

int split(const float* src, int64_t ld, float* hi, float* lo, int64_t R, int64_t C,
          int64_t Rp, int64_t Cp, bool transpose, cudaStream_t stream) {
  if (R <= 0 || C <= 0 || Rp < R || Cp < C || ld < (transpose ? R : C))
    return cudaErrorInvalidValue;
  const int64_t gx = (Cp + kSplitTile - 1) / kSplitTile, gy = (Rp + kSplitTile - 1) / kSplitTile;
  if (gx > INT_MAX || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  if (transpose)
    split_kernel<true><<<grid, 256, 0, stream>>>(src, ld, hi, lo, R, C, Rp, Cp);
  else
    split_kernel<false><<<grid, 256, 0, stream>>>(src, ld, hi, lo, R, C, Rp, Cp);
  return cudaGetLastError();
}

// d (64 x 128, fp32) (+)= A (64 x 8) B (8 x 128), TF32, both in shared
// memory, K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The block's barriers: each stage loaded; each stage free again.
struct Bars {
  uint32_t base;
  __device__ uint32_t full(int s) const { return base + 8u * s; }
  __device__ uint32_t empty(int s) const { return base + 8u * (kStages + s); }
};

__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(__grid_constant__ const CUtensorMap ta_hi,
                __grid_constant__ const CUtensorMap ta_lo,
                __grid_constant__ const CUtensorMap tb_hi,
                __grid_constant__ const CUtensorMap tb_lo, float* __restrict__ c, int64_t M,
                int64_t N, int nk, int n_m, int n_n, int tile0, int accumulate) {
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[2 * kStages];
  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;  // stage s at + s * kStageBytes
  const Bars bars{smem_addr(bar_mem)};

  // Groups of kGroupM M tiles walk the N tiles together.
  const int id = tile0 + static_cast<int>(blockIdx.x);
  const int per_group = kGroupM * n_n;
  const int first_m = id / per_group * kGroupM;
  const int group_m = n_m - first_m < kGroupM ? n_m - first_m : kGroupM;
  const int m0 = (first_m + id % per_group % group_m) * kBM;
  const int n0 = id % per_group / group_m * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(bars.empty(s), (kt / kStages - 1) & 1);
        const uint32_t st = ring + s * kStageBytes;
        const int k0 = kt * kBK;
        mbar_expect_tx(bars.full(s), kStageBytes);
        tma_load(st, &ta_hi, bars.full(s), k0, m0);
        tma_load(st + kTileBytes, &ta_lo, bars.full(s), k0, m0);
        tma_load(st + 2 * kTileBytes, &tb_hi, bars.full(s), k0, n0);
        tma_load(st + 3 * kTileBytes, &tb_lo, bars.full(s), k0, n0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // Consumers.  Thread t of warpgroup wg holds rows r0 and r0 + 8 of the
  // tile and, of every 8 columns, columns c0 and c0 + 1: element 4j + e is
  // (row r0 + 8 (e / 2), column 8j + c0 + e % 2).
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float total[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.0f;

  // Per K step: the 12 products into acc, which the first overwrites;
  // then the stage goes back to the producer and acc is added to the
  // total, rounded to nearest.  An 8-row swizzle atom is kAtom bytes; a k8
  // slice is 32 bytes further along the row.  While one warpgroup adds,
  // the other's products keep the tensor cores busy.
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    const uint32_t st = ring + s * kStageBytes;
    const uint64_t a_hi = gmma_desc(st + wg * 64 * kRowBytes, 16, kAtom, kLayout);
    const uint64_t a_lo = a_hi + (kTileBytes >> 4);
    const uint64_t b_hi = gmma_desc(st + 2 * kTileBytes, 16, kAtom, kLayout);
    const uint64_t b_lo = b_hi + (kTileBytes >> 4);
    mbar_wait(bars.full(s), (kt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_tf32_n128(acc, a_lo + 2 * kk, b_hi + 2 * kk, kk > 0);
      wgmma_tf32_n128(acc, a_hi + 2 * kk, b_lo + 2 * kk, 1);
      wgmma_tf32_n128(acc, a_hi + 2 * kk, b_hi + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.empty(s));
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += acc[i];
  }

  // A later panel adds its total to what c holds; every value is loaded
  // before any is stored, so that the loads are in flight together.
  const bool pairs = N % 2 == 0;  // then a column pair is 8-byte aligned
  if (accumulate) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = m0 + r0 + 8 * r;
      if (row >= M) continue;
      const float* crow = c + row * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t col = n0 + 8 * j + c0;
        if (col >= N) continue;
        if (pairs) {
          const float2 old = *reinterpret_cast<const float2*>(crow + col);
          total[4 * j + 2 * r] += old.x;
          total[4 * j + 2 * r + 1] += old.y;
        } else {
          total[4 * j + 2 * r] += crow[col];
          if (col + 1 < N) total[4 * j + 2 * r + 1] += crow[col + 1];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = m0 + r0 + 8 * r;
    if (row >= M) continue;
    float* crow = c + row * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int64_t col = n0 + 8 * j + c0;
      if (col >= N) continue;
      const float x = total[4 * j + 2 * r], y = total[4 * j + 2 * r + 1];
      if (pairs) {
        *reinterpret_cast<float2*>(crow + col) = make_float2(x, y);
      } else {
        crow[col] = x;
        if (col + 1 < N) crow[col + 1] = y;
      }
    }
  }
}

// K goes in panels of at most kPanelK, of equal depth but for the last, so
// that the split scratch holds one panel: 2 (M_p + N_p) K_c floats.
struct Plan {
  int64_t Mp, Np, Kc;
  Plan(int64_t M, int64_t N, int64_t K) : Mp(round_up(M, kBM)), Np(round_up(N, kBN)) {
    const int64_t Kp = round_up(K, kBK), panels = (Kp + kPanelK - 1) / kPanelK;
    Kc = round_up((Kp + panels - 1) / panels, kBK);
  }
  static int64_t round_up(int64_t x, int64_t m) { return (x + m - 1) / m * m; }
  int64_t scratch_floats() const { return 2 * (Mp + Np) * Kc; }
};

// A (rows, kp) fp32 array as a 2-D map whose box is one swizzle row of K
// (32 floats) by kBM rows.
bool make_map(EncodeTiled encode, CUtensorMap* map, const float* ptr, int64_t rows,
              int64_t kp) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp * 4)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Adds to *launches each kernel it launches.
int launch(const float* a, const float* b, float* c, float* scratch, int64_t M, int64_t N,
           int64_t K, int64_t* launches, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  if (K == 0) return cudaMemsetAsync(c, 0, M * N * sizeof(float), stream);
  const Plan p(M, N, K);
  const int64_t n_m = p.Mp / kBM, n_n = p.Np / kBN;
  if (p.Kc / kBK > INT_MAX || p.Mp > INT_MAX || p.Np > INT_MAX || n_m * n_n > INT_MAX ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return cudaErrorInvalidValue;
  float* a_hi = scratch;
  float* a_lo = a_hi + p.Mp * p.Kc;
  float* b_hi = a_lo + p.Mp * p.Kc;
  float* b_lo = b_hi + p.Np * p.Kc;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t e = raise_smem_limit(gemm_kernel, kSmem, configured);
  if (e != cudaSuccess) return e;
  int err, device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  const int tiles = static_cast<int>(n_m * n_n), per_launch = kWaves * sms;

  // Each panel of K: split it into the scratch, then add its product into
  // c (the first panel overwrites c).  The stream orders a panel's split
  // after the product that read the scratch before it.
  for (int64_t k0 = 0; k0 < K; k0 += p.Kc) {
    const int64_t kc = K - k0 < p.Kc ? K - k0 : p.Kc, kp = Plan::round_up(kc, kBK);
    if ((err = split(a + k0, K, a_hi, a_lo, M, kc, p.Mp, kp, false, stream)) != cudaSuccess ||
        (err = split(b + k0 * N, N, b_hi, b_lo, N, kc, p.Np, kp, true, stream)) !=
            cudaSuccess)
      return err;
    *launches += 2;
    CUtensorMap ta_hi, ta_lo, tb_hi, tb_lo;
    if (!make_map(encode, &ta_hi, a_hi, p.Mp, kp) || !make_map(encode, &ta_lo, a_lo, p.Mp, kp) ||
        !make_map(encode, &tb_hi, b_hi, p.Np, kp) || !make_map(encode, &tb_lo, b_lo, p.Np, kp))
      return cudaErrorInvalidValue;
    // Blocks that share a panel find it in L2 only while they run in step.
    // Each launch starts its blocks together, so the tiles go out in
    // launches of at most kWaves waves, before the blocks drift apart.
    for (int tile0 = 0; tile0 < tiles; tile0 += per_launch) {
      const int count = tiles - tile0 < per_launch ? tiles - tile0 : per_launch;
      gemm_kernel<<<static_cast<unsigned>(count), kThreads, kSmem, stream>>>(
          ta_hi, ta_lo, tb_hi, tb_lo, c, M, N, static_cast<int>(kp / kBK),
          static_cast<int>(n_m), static_cast<int>(n_n), tile0, k0 > 0);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      ++*launches;
    }
  }
  return cudaSuccess;
}

}  // namespace tf32x3

}  // namespace

// Bytes of scratch that um_gemm_f32 needs for these sizes (0 when K = 0).
extern "C" int64_t um_gemm_f32_scratch_bytes(int64_t M, int64_t N, int64_t K) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  return tf32x3::Plan(M, N, K).scratch_floats() * static_cast<int64_t>(sizeof(float));
}

// c (M, N) = a (M, K) @ b (K, N), 3xTF32; scratch holds
// um_gemm_f32_scratch_bytes(M, N, K) bytes, 16-byte aligned.  Adds the
// number of kernels it launched to *launches.
extern "C" int um_gemm_f32(const float* a, const float* b, float* c, float* scratch,
                           int64_t M, int64_t N, int64_t K, int64_t* launches,
                           void* stream) {
  return tf32x3::launch(a, b, c, scratch, M, N, K, launches, stream);
}

// The split pre-pass alone: hi and lo (Rp, Cp) of src (R, C), or with
// transpose of src (C, R) read transposed, zero-padded.
extern "C" int um_split_tf32(const float* src, float* hi, float* lo, int64_t R, int64_t C,
                             int64_t Rp, int64_t Cp, int64_t transpose, void* stream) {
  return tf32x3::split(src, transpose != 0 ? R : C, hi, lo, R, C, Rp, Cp, transpose != 0,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int um_gemm_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                            __nv_bfloat16* c, int64_t M, int64_t N, int64_t K,
                            void* stream) {
  return cuda_core::launch(a, b, c, M, N, K, stream);
}
