// Flash attention forward (GQA, causal, optional sliding window) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _fa_kernel in
// src/repro/kernels/flash_attention/kernel.py.  On the TPU the grid is
// (B*Hq, q blocks, KV blocks) and the third axis runs in order, carrying the
// running max, sum and accumulator in VMEM scratch.  Here one block owns one
// (batch, query head, query tile) and loops over the KV tiles itself, with
// the running max, sum and accumulator of its rows in registers.  Query
// head h reads KV head h / (Hq / Hkv).  Queries are the last Sq positions of
// the KV stream (q_offset = Skv - Sq).  KV tiles wholly above the causal
// diagonal or wholly before the window of every row of the query tile are
// never loaded.  Ragged Sq and Skv are masked here (the Pallas kernel
// asserts that the blocks divide them).  A row with no key in its band
// gives 0 / max(l, 1e-20) = 0.
//
// Bound on the H100: operations.  Causal prefill at S = 32k does
// 4 Hq Dh S(S+1)/2 operations on a few hundred MB, so the products belong
// on the bf16 tensor cores (989 TFLOP/s).  There are two kernels:
//
// - bf16 (um_flash_attention_bf16, the main path): Q K^T and P V on the
//   tensor cores with wgmma, fp32 accumulators, P rounded to bf16 for the
//   P V product as the JAX reference does (p.astype(v.dtype)).
// - fp32 (um_flash_attention_f32): IEEE fp32 FMAs on the CUDA cores (no
//   TF32, no tensor cores), so that it keeps the JAX tests' fp32 tolerance
//   of 2e-3 (cuda_core below).  No full-width path runs it; the kernel
//   timing rows of repro_torch.bench.lm_bench time it at S = 256.
//
// bf16 design (tensor_core below).  A block of 384 threads owns 128 query
// rows: two consumer warpgroups of 64 rows each and one producer warpgroup,
// which gives its registers up (setmaxnreg: 24 a thread for it, 240 for the
// consumers).  Shared memory holds the Q tile and a ring of two stages of
// 128-key K and V tiles, all in the 128-byte swizzled layout that wgmma
// reads (64- and 32-byte swizzle for Dh = 32 and 16): 160 KB at Dh = 128,
// one block per SM.  One producer lane loads each tile with one TMA copy
// per swizzle row of Dh (4-D tensor maps over (Dh, H, S, B), so rows past
// Sq or Skv read zero) and an mbarrier says when it has landed; K and V of
// a stage are freed through mbarriers of their own, K as soon as S is
// done, so the producer runs a tile ahead of the products.  Each consumer
// warpgroup, per KV tile i:
//   S_i = Q K_i^T  wgmma m64n128k16, Q and K from shared memory (K-major),
//                  issued together with O += P_{i-1} V_{i-1};
//   softmax        on S_i's accumulator fragment while the P V product still
//                  runs: a row lives in the 4 lanes of a quad, so its max is
//                  2 shuffles; exp2 with the scale times log2(e) folded into
//                  one FMA; the masks are applied only on tiles that cross
//                  the diagonal, the window's edge or the end of Skv; the
//                  sum stays per thread until the end;
//   then           O is rescaled and P_i packed to bf16 pairs, which is
//                  wgmma's A fragment as it stands, so P never goes through
//                  shared memory;
//   O += P_i V_i   wgmma m64nDhk16, A = P_i from registers, B = the V tile
//                  read MN-major through the transpose bit.
// 128-key tiles, not 64: an n128 product reads 6 KB of shared memory per
// 64 x 128 x 16 step where two n64 products read 8 KB, and the mask and
// barrier work per key halves; S_i's 64 floats, P_{i-1}'s 32 registers and
// O's 64 floats (Dh = 128) fit in the consumers' 240 registers.
//
// The TMA descriptors are encoded on the host for every call, through the
// driver's cuTensorMapEncodeTiled reached with cudaGetDriverEntryPoint, so
// the library needs no link against libcuda.  The TMA, mbarrier, wgmma
// descriptor and fence helpers live in hopper_common.cuh, shared with the
// SGEMM kernel.
#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "smem_limit.cuh"

#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace um_attn;

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------
//
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns score rows
// 4ty..4ty+3 and columns tx + 16j of each 64 x 64 score tile, and the same
// rows and columns tx + 16c of the output.  Row max and sum are reduced over
// the 16 lanes of a row group with shuffles.  Q, the current K or V tile
// and P sit in shared memory as fp32, rows padded by 4 floats so that the
// 16-byte reads are free of bank conflicts.  The next tile is loaded into
// registers while the current one is multiplied.
namespace cuda_core {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 4) + kBK * (DH + 4) + kBQ * (kBK + 4);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int64_t Sq,
                     int64_t Skv, int Hq, int Hkv, int causal, int64_t window,
                     float scale) {
  constexpr int LD = DH + 4;              // row stride of Qs and KVs
  constexpr int LP = kBK + 4;             // row stride of Ps
  constexpr int CH = kBK * DH / 4 / kThreads;  // 4-element chunks a thread stages
  constexpr int CPT = DH / 16;            // output columns per thread
  static_assert(kBQ == kBK && CH >= 1, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + kBQ * LD;
  float* Ps = KVs + kBK * LD;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t nq = (Sq + kBQ - 1) / kBQ;
  const int64_t q0 = (nq - 1 - blockIdx.x) * kBQ;  // the longest rows first
  const int bh = blockIdx.y;
  const int64_t b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int64_t q_offset = Skv - Sq;

  // KV tiles that hold a position some row of this tile attends to.
  const int64_t q_last = (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;
  int64_t kv_end = Skv, kv_begin = 0;
  if (causal && q_offset + q_last + 1 < kv_end) kv_end = q_offset + q_last + 1;
  if (window > 0 && q_offset + q0 - window + 1 > 0) kv_begin = q_offset + q0 - window + 1;
  const int64_t t_begin = kv_begin / kBK;
  const int64_t t_end = kv_end > kv_begin ? (kv_end + kBK - 1) / kBK : t_begin;

  const int64_t q_row = static_cast<int64_t>(Hq) * DH;  // elements per position
  const int64_t kv_row = static_cast<int64_t>(Hkv) * DH;
  const T* qb = q + b * Sq * q_row + static_cast<int64_t>(h) * DH;
  const T* kb = k + b * Skv * kv_row + static_cast<int64_t>(hk) * DH;
  const T* vb = v + b * Skv * kv_row + static_cast<int64_t>(hk) * DH;

  // Stage a 64 x DH tile (rows past n read zero) into registers / smem.
  Raw<T, 4> stage[CH];
  auto load_tile = [&](const T* base, int64_t row_stride, int64_t r0, int64_t n) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      const int64_t r = r0 + idx / (DH / 4);
      stage[c] = r < n ? load_raw<T, 4>(base + r * row_stride + (idx % (DH / 4)) * 4)
                       : zero_raw<T, 4>();
    }
  };
  auto store_tile = [&](float* dst) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int idx = tid + c * kThreads;
      float f[4];
      widen<4>(stage[c], f);
      *reinterpret_cast<float4*>(dst + (idx / (DH / 4)) * LD + (idx % (DH / 4)) * 4) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
  };

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  if (t_begin < t_end) {
    load_tile(qb, q_row, q0, Sq);
    store_tile(Qs);
    load_tile(kb, kv_row, t_begin * kBK, Skv);
    store_tile(KVs);
    __syncthreads();
  }

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t k0 = t * kBK;
    load_tile(vb, kv_row, k0, Skv);  // V of this tile, in flight during QK^T

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // Mask, then the online softmax of each row (JAX's order of operations).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q_offset + q0 + ty * 4 + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        valid[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                   (window <= 0 || kpos > qpos - window);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off >= 1; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // every read of K is done, P is written
    store_tile(KVs);  // V replaces K
    __syncthreads();
    if (t + 1 < t_end) load_tile(kb, kv_row, k0 + kBK, Skv);  // next K, in flight during PV

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = KVs + (kk + u) * LD + tx;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float vv = vrow[16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
            acc[i][c] = fmaf(p, vv, acc[i][c]);
          }
        }
      }
    }
    __syncthreads();  // every read of V and P is done
    if (t + 1 < t_end) {
      store_tile(KVs);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-20f);
    T* orow = o + b * Sq * q_row + r * q_row + static_cast<int64_t>(h) * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = narrow<T>(acc[i][c] * inv);
  }
}

template <typename T, int DH>
int launch(const T* q, const T* k, const T* v, T* o, int64_t B, int64_t Sq,
           int64_t Skv, int64_t Hq, int64_t Hkv, int causal, int64_t window,
           float scale, void* stream) {
  constexpr int bytes = smem_floats<DH>() * 4;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err = raise_smem_limit(flash_fwd_kernel<T, DH>, bytes, configured);
  if (err != cudaSuccess) return err;
  const int64_t nq = (Sq + kBQ - 1) / kBQ;
  const dim3 grid(static_cast<unsigned>(nq), static_cast<unsigned>(B * Hq));
  flash_fwd_kernel<T, DH><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, Sq, Skv, static_cast<int>(Hq), static_cast<int>(Hkv), causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int64_t B, int64_t Sq,
             int64_t Skv, int64_t Hq, int64_t Hkv, int64_t Dh, int64_t causal,
             int64_t window, double scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B * Hq > 65535 || (Sq + kBQ - 1) / kBQ > 2147483647)
    return cudaErrorInvalidValue;
  const float s = static_cast<float>(scale);
  const int c = causal != 0;
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    default: return cudaErrorInvalidValue;
  }
}


}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, TMA loads
// ---------------------------------------------------------------------------
namespace tensor_core {

using namespace um_hopper;

constexpr int kBQ = 128, kBK = 128, kStages = 2;
constexpr int kConsumers = 256;                // two warpgroups
constexpr int kThreads = kConsumers + 128;     // and the producer warpgroup
// Registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kConsumerWarps = kConsumers / 32;
static_assert(kBQ == kBK, "Q and K chunks share their k-step offsets");

// Shared-memory geometry of a tile of rows x Dh bf16: Dh is cut into
// chunks of one swizzle row (kRowBytes); a chunk holds all rows, kRowBytes
// apart, so 8 rows make one swizzle atom of 8 * kRowBytes bytes.
template <int DH>
struct Tile {
  static constexpr int kRowBytes = DH * 2 < 128 ? DH * 2 : 128;
  static constexpr int kRowElems = kRowBytes / 2;
  static constexpr int kChunks = DH / kRowElems;
  // wgmma's layout type: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kBQ * DH * 2;
  static constexpr int kKVBytes = kBK * DH * 2;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;  // + alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest even as bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128): A and B in shared
// memory, both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 16, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 16):
// B in shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 32):
// B in shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 64):
// B in shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x 128):
// B in shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (DH == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (DH == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// Online softmax of one 64 x kBK S fragment, in base 2: m_run is the
// running max of s * scale * log2(e) of the thread's two rows, l_run the
// thread's part of their running sums.  Masks the tile first if it crosses
// the causal diagonal, the window's edge or the end of Skv (qpos: the
// position of the thread's first row; qlo, qhi: of the block's first and
// last real rows).  Replaces S by P = exp2(s * scale * log2(e) - m) in
// fp32 and writes the factor by which the accumulator's rows are to be
// scaled.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2],
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], int k0, int qpos, int c0,
                                             int Skv, int qlo, int qhi, int causal,
                                             int window, float scale_log2) {
  const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > qlo) ||
                    (window > 0 && k0 <= qhi - window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + c0 + (e & 1);
        const int q = qpos + 8 * (e >> 1);
        const bool ok =
            kpos < Skv && (!causal || kpos <= q) && (window <= 0 || kpos > q - window);
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row lives in the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
    sub[r] = m_new == -INFINITY ? 0.0f : m_new;  // a row with no key yet
    corr[r] = ex2(m_run[r] - sub[r]);
    m_run[r] = m_new;
  }
  float rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sc[4 * j + 2 * r] = ex2(fmaf(sc[4 * j + 2 * r], scale_log2, -sub[r]));
      sc[4 * j + 2 * r + 1] = ex2(fmaf(sc[4 * j + 2 * r + 1], scale_log2, -sub[r]));
      rsum[r] += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rsum[r];
}

// P as bf16 pairs in wgmma's A-fragment order: the S fragment's pairs as
// they stand (A of k-step kk is p[4kk .. 4kk + 3]).
__device__ __forceinline__ void pack_p(const float (&sc)[kBK / 2], uint32_t (&p)[kBK / 4]) {
#pragma unroll
  for (int i = 0; i < kBK / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// The block's barriers: Q loaded; K and V of each stage loaded; K and V of
// each stage free again.
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8u * (1 + s); }
  __device__ uint32_t v_full(int s) const { return base + 8u * (1 + kStages + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8u * (1 + 2 * kStages + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8u * (1 + 3 * kStages + s); }
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(__grid_constant__ const CUtensorMap tq,
                    __grid_constant__ const CUtensorMap tk,
                    __grid_constant__ const CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                    int Sq, int Skv, int Hq, int Hkv, int BH, int nq, int causal, int window,
                    float scale_log2) {
  using G = Tile<DH>;
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[1 + 4 * kStages];
  const uint32_t q_s = (smem_addr(smem) + 1023u) & ~1023u;  // swizzle atoms need 1 KB
  const uint32_t k_s = q_s + G::kQBytes;                    // stage s at + s * kKVBytes
  const uint32_t v_s = k_s + kStages * G::kKVBytes;
  const Bars bars{smem_addr(bar_mem)};

  const int id = static_cast<int>(blockIdx.x);
  const int bh = id % BH;
  const int q0 = (nq - 1 - id / BH) * kBQ;  // the longest rows first, every head
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q_offset = Skv - Sq;

  // KV tiles that hold a position some row of this tile attends to.
  const int qlo = q_offset + q0;
  const int qhi = q_offset + (q0 + kBQ < Sq ? q0 + kBQ : Sq) - 1;
  int kv_begin = 0, kv_end = Skv;
  if (causal && qhi + 1 < kv_end) kv_end = qhi + 1;
  if (window > 0 && qlo - window + 1 > 0) kv_begin = qlo - window + 1;
  const int t_begin = kv_begin / kBK;
  const int n_tiles = kv_end > kv_begin ? (kv_end + kBK - 1) / kBK - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_empty(s), kConsumerWarps);
      mbar_init(bars.v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(bars.q_full(), G::kQBytes);
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(q_s + c * kBQ * G::kRowBytes, &tq, bars.q_full(), c * G::kRowElems, h, q0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t freed = (i / kStages - 1) & 1;  // parity of the stage's last release
        const int k0 = (t_begin + i) * kBK;
        if (i >= kStages) mbar_wait(bars.k_empty(s), freed);
        mbar_expect_tx(bars.k_full(s), G::kKVBytes);
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(k_s + s * G::kKVBytes + c * kBK * G::kRowBytes, &tk, bars.k_full(s),
                   c * G::kRowElems, hk, k0, b);
        if (i >= kStages) mbar_wait(bars.v_empty(s), freed);
        mbar_expect_tx(bars.v_full(s), G::kKVBytes);
        for (int c = 0; c < G::kChunks; ++c)
          tma_load(v_s + s * G::kKVBytes + c * kBK * G::kRowBytes, &tv, bars.v_full(s),
                   c * G::kRowElems, hk, k0, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // Consumers.  Thread t of warpgroup wg holds rows r0 and r0 + 8 of the
  // block's 128 and, of every 8 columns of S or O, columns c0 and c0 + 1:
  // element 4j + e of a fragment is (row r0 + 8 (e / 2), column 8j + c0 + e % 2).
  constexpr int kO = DH / 2, kS = kBK / 2, kP = kBK / 4;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  if (n_tiles > 0) {
    constexpr uint32_t kAtom = 8 * G::kRowBytes;  // stride of 8-row groups
    const uint64_t q_desc = gmma_desc(q_s + wg * 64 * G::kRowBytes, 16, kAtom, G::kLayout);
    // S = Q K^T over Dh, 16 at a time (chunk kk * 16 / kRowElems of the rows,
    // element kk * 16 % kRowElems of the chunk)
    auto k_desc = [&](int s) {
      return gmma_desc(k_s + s * G::kKVBytes, 16, kAtom, G::kLayout);
    };
    auto v_desc = [&](int s) {
      return gmma_desc(v_s + s * G::kKVBytes, kBK * G::kRowBytes, kAtom, G::kLayout);
    };
    auto issue_qk = [&](float (&sc)[kS], uint64_t kd) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk * 16 / G::kRowElems) * kBK * G::kRowBytes +
                             (kk * 16 % G::kRowElems) * 2;
        wgmma_ss_n128(sc, q_desc + (off >> 4), kd + (off >> 4), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V over the tile's keys, 16 at a time
    auto issue_pv = [&](const uint32_t (&p)[kP], uint64_t vd) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_pv<DH>(acc, a, vd + ((kk * 16 * G::kRowBytes) >> 4));
      }
      wgmma_commit();
    };
    // One warp's arrival on a barrier that counts the consumer warps.
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Tile i's S product runs beside tile i-1's P V product, so that the
    // softmax of tile i overlaps the tensor cores' work on P V.
    uint32_t p[kP];
    float corr[2];
    mbar_wait(bars.q_full(), 0);
    {
      float sc[kS];
      const uint64_t kd = k_desc(0);
      mbar_wait(bars.k_full(0), 0);
      wgmma_fence();
      issue_qk(sc, kd);
      wgmma_wait<0>();
      fence_regs(sc);
      release(bars.k_empty(0));
      softmax_tile(sc, m_run, l_run, corr, t_begin * kBK, qlo + r0, c0, Skv, qlo, qhi,
                   causal, window, scale_log2);  // corr: acc is still 0
      pack_p(sc, p);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      float sc[kS];
      const uint64_t kd = k_desc(s), vd = v_desc(sp);
      mbar_wait(bars.k_full(s), (i / kStages) & 1);
      wgmma_fence();
      issue_qk(sc, kd);
      mbar_wait(bars.v_full(sp), ((i - 1) / kStages) & 1);
      issue_pv(p, vd);
      wgmma_wait<1>();  // S is done, P V may still run
      fence_regs(sc);
      release(bars.k_empty(s));
      softmax_tile(sc, m_run, l_run, corr, (t_begin + i) * kBK, qlo + r0, c0, Skv, qlo, qhi,
                   causal, window, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);  // P stays in its registers until its product is done
      fence_regs(sc);
      release(bars.v_empty(sp));
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
      pack_p(sc, p);  // only now: P's registers are the next product's input
    }
    const int last = n_tiles - 1;
    const uint64_t vd = v_desc(last % kStages);
    mbar_wait(bars.v_full(last % kStages), (last / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(p, vd);
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + r0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l, 1e-20f);
    __nv_bfloat16* orow = o + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
  }
}

// A (B, S, H, DH) bf16 tensor as a 4-D map whose box is one swizzle row of
// Dh, one head and `rows` positions; positions past S read zero.
template <int DH>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
              int64_t H, int rows) {
  using G = Tile<DH>;
  const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(DH * 2),
                                 static_cast<cuuint64_t>(H * DH * 2),
                                 static_cast<cuuint64_t>(S * H * DH * 2)};
  const cuuint32_t box[4] = {G::kRowElems, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* o, int64_t B, int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
           int causal, int64_t window, float scale, void* stream) {
  using G = Tile<DH>;
  // TMA reads from 16-byte aligned addresses only
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int64_t nq = (Sq + kBQ - 1) / kBQ;
  if (Sq > INT_MAX - kBQ || Skv > INT_MAX - kBK || nq * B * Hq > INT_MAX)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map<DH>(encode, &tq, q, B, Sq, Hq, kBQ) ||
      !make_map<DH>(encode, &tk, k, B, Skv, Hkv, kBK) ||
      !make_map<DH>(encode, &tv, v, B, Skv, Hkv, kBK))
    return cudaErrorInvalidValue;
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t err = raise_smem_limit(flash_tc_kernel<DH>, G::kSmem, configured);
  if (err != cudaSuccess) return err;
  // a window that reaches back past position 0 for every row is no window
  const int w = window <= 0 || window >= Skv ? 0 : static_cast<int>(window);
  flash_tc_kernel<DH><<<static_cast<unsigned>(nq * B * Hq), kThreads, G::kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, o, static_cast<int>(Sq), static_cast<int>(Skv), static_cast<int>(Hq),
      static_cast<int>(Hkv), static_cast<int>(B * Hq), static_cast<int>(nq), causal, w,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             __nv_bfloat16* o, int64_t B, int64_t Sq, int64_t Skv, int64_t Hq, int64_t Hkv,
             int64_t Dh, int64_t causal, int64_t window, double scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return cudaErrorInvalidValue;
  const float s = static_cast<float>(scale);
  const int c = causal != 0;
  switch (Dh) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    case 32: return launch<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    case 64: return launch<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    case 128: return launch<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, c, window, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tensor_core

}  // namespace

// window <= 0 means no window.
extern "C" int um_flash_attention_f32(const float* q, const float* k, const float* v,
                                      float* o, int64_t B, int64_t Sq, int64_t Skv,
                                      int64_t Hq, int64_t Hkv, int64_t Dh,
                                      int64_t causal, int64_t window, double scale,
                                      void* stream) {
  return cuda_core::dispatch(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dh, causal, window, scale,
                             stream);
}

extern "C" int um_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* o,
                                       int64_t B, int64_t Sq, int64_t Skv, int64_t Hq,
                                       int64_t Hkv, int64_t Dh, int64_t causal,
                                       int64_t window, double scale, void* stream) {
  return tensor_core::dispatch(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dh, causal, window, scale,
                               stream);
}
