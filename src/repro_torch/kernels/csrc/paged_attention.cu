// Paged decode attention (one query token, GQA) over a block-table KV pool,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pa_kernel in
// src/repro/kernels/paged_attention/kernel.py.  There the block table rides
// the scalar-prefetch path, the grid is (B, pages per sequence) and each
// step DMAs one page while the running max, sum and accumulator of all Hq
// heads sit in VMEM.  Hopper has no scalar prefetch and its blocks run in
// no order, so here a block reads its own block-table row and walks the
// live positions of its sequence itself.  Positions at or past seq_len are
// masked, and the block-table entries of pages wholly past it are never
// read; a negative page id wraps once and an id past the pool is clamped,
// as the reference's gather indexes; a zero-length sequence gives zeros,
// since the output is acc / max(l, 1e-20) as on the TPU.
//
// Bound on the H100: bytes.  A decode step does 4 Hq Dh flops per live
// position on 4 Hkv Dh bytes (bf16) of K and V, 2 Hq/Hkv flops per byte:
// far below the ridge.  Both kernels read every K/V byte of a live page
// once per call: a block serves all G = Hq/Hkv query heads of its KV head.
// There are two kernels:
//
// - bf16 (um_paged_attention_bf16, the main path): the products on the
//   tensor cores, pages brought by TMA into a shared-memory ring, each
//   sequence split over work items that a second kernel merges
//   (tensor_core below).
// - fp32 (um_paged_attention_f32): IEEE fp32 FMAs on the CUDA cores
//   (cuda_core below).  No full-width path runs it.
//
// bf16 design (tensor_core).  Dot products on the CUDA cores cost about
// 1,000 instructions per 8 positions (the fp32 kernel's form), which bounds
// such a kernel by instruction issue well before the bytes.  Here the
// products leave the issue slots and the loads leave the registers:
//
// - Split-KV ("flash-decoding").  A work item is (sequence, KV head, chunk
//   of chunk_pages(psz) pages, about 2,048 positions), one block each: at
//   qwen2-72b decode_32k that is 12,288 live items of ~1 MB in place of
//   1,024 blocks of 8 or 16 MB, so the grid is even.  Each item writes its
//   fp32 partial (m, l, acc) for its G heads to scratch that the wrapper
//   allocates (um_paged_attention_bf16_scratch_bytes); paged_merge_kernel
//   then merges the live chunks of each (sequence, KV head) in chunk order,
//   as combine_decode_partials merges shards, so the result does not
//   depend on which block ran first.  Two launches a call.
// - A page ring.  160 threads: four consumer warps and one producer warp.
//   The producer reads the block-table entry of each live page and copies
//   its K and V rows for the block's KV head into a ring of kStages stages
//   of 64 positions (32 KB at Dh = 128), with full and empty mbarriers.
//   The copy is TMA through 4-D tensor maps over the pools (Dh, Hkv, psz,
//   npages), box (one swizzle row of Dh, 1, gcd(psz, 64), 1): the page id
//   from the block table is the box's coordinate, the counterpart of the
//   Pallas index map that dereferences bt_ref.  A box must start on an
//   8-row swizzle atom, so a page size that is not a multiple of 8 takes
//   cp.async instead: the producer warp copies whole rows an instruction,
//   16 bytes a lane, into the same swizzled layout.  cp.async alone would
//   serve every page size, but at qwen2-72b decode_32k it took 6-9 % longer
//   than TMA in the same run (PERF.md, Findings).  Two blocks an SM, so up to
//   192 KB are in flight on an SM at Dh = 128.
// - Tensor-core products, mma.sync m16n8k16 bf16 with fp32 accumulators.
//   Consumer warp w takes positions 16w .. 16w + 15 of every stage and
//   keeps its own online softmax.  Scores S^T = K Q^T: the 16 keys are M,
//   the G query heads of the KV head N (one n8 tile for G <= 8, two for
//   G <= 16), K from shared memory by ldmatrix, Q^T in registers for the
//   whole item.  q and k are bf16, so the products are exact in fp32, as
//   the JAX kernel's astype(f32).  The softmax is fp32 in JAX's order: the
//   scale applied to the scores, masked positions set to -1e30, m, corr, p
//   and l as at kernel.py:58-73.  O^T += V^T P^T: Dh is M, the heads N, V
//   read by ldmatrix.trans.  P stays fp32-accurate: it is split into bf16
//   hi = bf16(P) and lo = bf16(P - hi) and the two products are summed in
//   the fp32 accumulator (one bf16 P fails the full-width limit on short
//   rows; tests/test_torch_paged_precision.py).  S^T's accumulator holds a
//   (key, head pair) per lane where P^T's operand wants a (key pair,
//   head), so each 8 x 8 block of packed P goes through movmatrix.trans,
//   in registers.  V rows past seq_len are zeroed in the operand, since
//   0 x NaN would be NaN and those rows may hold anything.
// - At the end of an item the four warps' partials are merged in warp
//   order through the ring's shared memory, and the block writes one.
#include "attention_common.cuh"
#include "hopper_common.cuh"
#include "smem_limit.cuh"

#include <cuda_bf16.h>

#include <climits>
#include <cstring>
#include <numeric>

namespace {

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------
//
// 8 warps; warp w takes groups of R = 64/GP consecutive positions (GP = G
// rounded up to a power of two >= 4), groups w, w+8, w+16, ...  Each lane
// holds Dh/32 dims of the G query vectors in registers and loads the same
// dims of the group's K and V rows (one coalesced 16-, 8- or 4-byte access
// a lane and row), so a warp reads each row's Dh contiguous elements once.
// The R x GP partial dot products of a lane are summed across the warp by a
// transpose-reduce (62 shuffles for 64 sums, each lane ending with two),
// then the group's scores go through shared memory to update the warp's
// running max, sum and accumulator (fp32, JAX's order of operations).  The
// next group's rows are loaded while a group is computed.  At the end the 8
// warps' partials are merged exactly, as combine_decode_partials merges
// shards.  One block per (sequence, KV head).
namespace cuda_core {

using namespace um_attn;

constexpr int kWarps = 8, kThreads = 32 * kWarps;

// Transpose-reduce of a lane's 64 partial sums over the warp: at each level
// a lane keeps one half of its sums and adds its partner's copy of that
// half, so lane i ends with the warp's sums 2i and 2i+1 in part[0..1].
// Recursion on HALF keeps every index a constant, so part stays in
// registers.
template <int HALF>
__device__ __forceinline__ void transpose_reduce(float (&part)[64], int lane) {
  if constexpr (HALF >= 2) {
    constexpr int OFF = HALF / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? part[i] : part[i + HALF];
      const float keep = upper ? part[i + HALF] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    transpose_reduce<HALF / 2>(part, lane);
  }
}

template <typename T, int DH, int GP>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool, const int* __restrict__ block_table,
                        const int* __restrict__ seq_lens, T* __restrict__ out,
                        int64_t npages, int64_t psz, int Hq, int Hkv, int64_t P,
                        float scale) {
  constexpr int DPL = DH >= 32 ? DH / 32 : 1;  // dims a lane holds
  constexpr int R = 64 / GP;                   // positions in a warp's group
  constexpr int NV = R * GP;                   // partial sums a lane makes (64)
  static_assert(NV == 64 && GP >= 4, "group shape");

  __shared__ float ps[kWarps][NV];
  __shared__ float wm[kWarps][GP], wl[kWarps][GP];
  __shared__ __align__(16) float osum[GP][DH];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int hk = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int G = Hq / Hkv;
  const int d0 = lane * DPL;
  const bool active = d0 < DH;

  // Live length: seq_len, clipped to the block table's span.
  int64_t len = seq_lens[b];
  len = len < 0 ? 0 : (len > P * psz ? P * psz : len);
  const int* bt = block_table + b * P;
  const int64_t row_stride = static_cast<int64_t>(Hkv) * DH;  // elements per pool row
  const int64_t head_off = static_cast<int64_t>(hk) * DH + d0;

  float qr[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G && active) {
      widen<DPL>(load_raw<T, DPL>(q + (b * Hq + static_cast<int64_t>(hk) * G + g) * DH + d0),
                 qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < DPL; ++e) qr[g][e] = 0.0f;
    }
  }

  float m[GP], l[GP], acc[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.0f;
  }

  // The K and V rows of the group at t0 (rows past len read zero).
  auto load_group = [&](int64_t t0, Raw<T, DPL>(&kraw)[R], Raw<T, DPL>(&vraw)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t t = t0 + r;
      if (t < len && active) {
        int64_t page = bt[t / psz];
        if (page < 0) page += npages;  // index as the gather of the reference does
        page = page < 0 ? 0 : (page >= npages ? npages - 1 : page);
        const int64_t off = (page * psz + t % psz) * row_stride + head_off;
        kraw[r] = load_raw<T, DPL>(kpool + off);
        vraw[r] = load_raw<T, DPL>(vpool + off);
      } else {
        kraw[r] = zero_raw<T, DPL>();
        vraw[r] = zero_raw<T, DPL>();
      }
    }
  };

  constexpr int64_t kStep = kWarps * R;
  Raw<T, DPL> kraw[R], vraw[R], knext[R], vnext[R];
  load_group(static_cast<int64_t>(warp) * R, kraw, vraw);
  for (int64_t t0 = static_cast<int64_t>(warp) * R; t0 < len; t0 += kStep) {
    // The next group's rows are in flight while this group is computed.
    if (t0 + kStep < len) load_group(t0 + kStep, knext, vnext);

    // Partial q . k of this lane's dims, index r * GP + g.
    float part[NV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float kf[DPL];
      widen<DPL>(kraw[r], kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) s = fmaf(qr[g][e], kf[e], s);
        part[r * GP + g] = s;
      }
    }
    transpose_reduce<NV / 2>(part, lane);

    // Scores of this lane's two (position, head) pairs.
    float s2[2];
    bool valid[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = 2 * lane + j;
      valid[j] = t0 + idx / GP < len && idx % GP < G;
      s2[j] = valid[j] ? part[j] * scale : kNegInf;
      ps[warp][idx] = s2[j];
    }
    __syncwarp();
    float corr[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < R; ++r) mx = fmaxf(mx, ps[warp][r * GP + g]);
      const float m_new = fmaxf(m[g], mx);
      corr[g] = expf(m[g] - m_new);
      m[g] = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = 2 * lane + j;
      float mg = 0.0f;  // m[idx % GP], selected so that m stays in registers
#pragma unroll
      for (int g = 0; g < GP; ++g)
        if (g == idx % GP) mg = m[g];
      ps[warp][idx] = valid[j] ? expf(s2[j] - mg) : 0.0f;
    }
    __syncwarp();

#pragma unroll
    for (int g = 0; g < GP; ++g) {
      l[g] *= corr[g];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= corr[g];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float vf[DPL];
      widen<DPL>(vraw[r], vf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float p = ps[warp][r * GP + g];
        l[g] += p;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncwarp();  // ps is read by every lane before the next group writes it
#pragma unroll
    for (int r = 0; r < R; ++r) {
      kraw[r] = knext[r];
      vraw[r] = vnext[r];
    }
  }

  // Merge the warps' partials: rescale each to the block's max, then sum.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
  }
  for (int i = threadIdx.x; i < GP * DH; i += kThreads) (&osum[0][0])[i] = 0.0f;
  __syncthreads();
  float mall[GP], lall[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    mall[g] = kNegInf;
    for (int w = 0; w < kWarps; ++w) mall[g] = fmaxf(mall[g], wm[w][g]);
    lall[g] = 0.0f;
    for (int w = 0; w < kWarps; ++w) lall[g] += wl[w][g] * expf(wm[w][g] - mall[g]);
  }
  for (int w = 0; w < kWarps; ++w) {  // in warp order, so the sum is deterministic
    if (warp == w && active) {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float c = expf(m[g] - mall[g]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) osum[g][d0 + e] += acc[g][e] * c;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float lg = 0.0f;
#pragma unroll
    for (int gg = 0; gg < GP; ++gg)
      if (gg == g) lg = lall[gg];
    out[(b * Hq + static_cast<int64_t>(hk) * G + g) * DH + d] =
        narrow<T>(osum[g][d] / fmaxf(lg, 1e-20f));
  }
}

template <typename T, int DH, int GP>
int launch(const T* q, const T* kpool, const T* vpool, const int* bt, const int* sl,
           T* out, int64_t B, int64_t Hq, int64_t Hkv, int64_t npages, int64_t psz,
           int64_t P, float scale, void* stream) {
  const dim3 grid(static_cast<unsigned>(Hkv), static_cast<unsigned>(B));
  paged_decode_kernel<T, DH, GP><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, kpool, vpool, bt, sl, out, npages, psz, static_cast<int>(Hq),
      static_cast<int>(Hkv), P, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
int by_group(const T* q, const T* kpool, const T* vpool, const int* bt, const int* sl,
             T* out, int64_t B, int64_t Hq, int64_t Hkv, int64_t npages, int64_t psz,
             int64_t P, float scale, void* stream) {
  const int64_t G = Hq / Hkv;
  if (G <= 4) return launch<T, DH, 4>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, scale, stream);
  if (G <= 8) return launch<T, DH, 8>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, scale, stream);
  if (G <= 16) return launch<T, DH, 16>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const T* q, const T* kpool, const T* vpool, const int* bt, const int* sl,
             T* out, int64_t B, int64_t Hq, int64_t Hkv, int64_t Dh, int64_t npages,
             int64_t psz, int64_t P, double scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || npages <= 0 || psz <= 0 ||
      P < 0)
    return cudaErrorInvalidValue;
  const float s = static_cast<float>(scale);
  switch (Dh) {
    case 16: return by_group<T, 16>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, s, stream);
    case 32: return by_group<T, 32>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, s, stream);
    case 64: return by_group<T, 64>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, s, stream);
    case 128: return by_group<T, 128>(q, kpool, vpool, bt, sl, out, B, Hq, Hkv, npages, psz, P, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, a TMA page ring, split-KV
// ---------------------------------------------------------------------------
namespace tensor_core {

using namespace um_attn;
using namespace um_hopper;

constexpr int kTK = 64;             // positions in a stage
constexpr int kConsumerWarps = 4;   // 16 positions of each stage each
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kStages = 3;
constexpr int kMergeThreads = 128;
static_assert(kTK == 16 * kConsumerWarps, "a warp takes one m16 tile of a stage");

// Shared-memory geometry of a stage's K (or V) tile of kTK rows x Dh bf16:
// Dh is cut into chunks of one swizzle row (kRowBytes); a chunk holds all
// rows, kRowBytes apart, in the layout TMA writes with the swizzle of that
// width: 16-byte unit u of row r of a chunk lies at unit u ^ f(r).
template <int DH>
struct Geo {
  static constexpr int kRowBytes = DH * 2 < 128 ? DH * 2 : 128;
  static constexpr int kRowElems = kRowBytes / 2;
  static constexpr int kChunks = DH / kRowElems;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 0x70 : kRowBytes == 64 ? 0x30 : 0x10;
  static constexpr int kTileBytes = kTK * DH * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K then V
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  // Byte offset of element e (a multiple of 8) of row r in a tile that
  // starts on a 1 KB boundary.
  static __device__ __forceinline__ uint32_t offset(int r, int e) {
    const uint32_t off = (e / kRowElems) * (kTK * kRowBytes) + r * kRowBytes +
                         (e % kRowElems) * 2;
    return off ^ ((off >> 3) & kSwizzle);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The transpose of an 8 x 8 bf16 matrix held as mma fragments: lane l has
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1, before and after.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d (16 x 8, fp32) += A (16 x 16, bf16, row-major) B (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// One arrival on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Two floats rounded to nearest even as bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo_half(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi_half(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

// The block-table entry as a page of the pool: a negative id wraps once, an
// id past the pool is clamped.
__device__ __forceinline__ int64_t pool_page(int id, int64_t npages) {
  int64_t page = id;
  if (page < 0) page += npages;
  return page < 0 ? 0 : (page >= npages ? npages - 1 : page);
}

// The bf16 halves of x whose key (k for the low half, k + 1 for the high
// half) is below n; the others zero.
__device__ __forceinline__ uint32_t keep_keys(uint32_t x, int k, int n) {
  return x & ((k < n ? 0x0000FFFFu : 0u) | (k + 1 < n ? 0xFFFF0000u : 0u));
}

// Block (chunk c, KV head hk, sequence b): the partial of positions
// [c * chunk_len, min((c + 1) * chunk_len, len)) for the G query heads of
// hk, written at part + item * G * (DH + 2) as m[G], l[G], acc[G][DH].
// NT = n8 tiles of query heads (G <= 8 NT).
template <int DH, int NT>
__global__ void __launch_bounds__(kThreads, 2)
    paged_tc_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kpool,
                    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ block_table,
                    const int* __restrict__ seq_lens, float* __restrict__ part, int64_t npages,
                    int64_t psz, int Hq, int Hkv, int64_t P, int64_t chunk_len, int box,
                    float scale) {
  using Gm = Geo<DH>;
  constexpr int KS = DH / 16;  // k16 steps of Q K^T, m16 tiles of V^T P^T
  constexpr int kUnits = DH / 8;        // 16-byte units of a row
  constexpr int kRowsAtOnce = 32 / kUnits;  // rows one producer instruction copies
  static_assert(32 % kUnits == 0, "a warp copies whole rows");
  extern __shared__ uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_mem[2 * kStages];

  const int c = blockIdx.x, hk = blockIdx.y;
  const int64_t b = blockIdx.z;
  int64_t len = seq_lens[b];
  len = len < 0 ? 0 : (len > P * psz ? P * psz : len);
  const int64_t start = static_cast<int64_t>(c) * chunk_len;
  if (start >= len) return;  // a chunk wholly past seq_len: the merge skips it
  const int64_t end = start + chunk_len < len ? start + chunk_len : len;
  const int ntiles = static_cast<int>((end - start + kTK - 1) / kTK);
  const int G = Hq / Hkv;
  const int* bt = block_table + b * P;

  const uint32_t ring = (smem_addr(smem) + 1023u) & ~1023u;  // swizzle atoms need 1 KB
  uint8_t* ring_ptr = smem + (ring - smem_addr(smem));
  const uint32_t bars = smem_addr(bar_mem);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), box ? 1 : 32);  // TMA: one expect_tx; cp.async: each lane
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (box) {  // TMA from one lane: boxes of `box` rows, each inside one page
      if (lane != 0) return;
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
        const int64_t t0 = start + static_cast<int64_t>(i) * kTK;
        const int rows = end - t0 < kTK ? static_cast<int>(end - t0) : kTK;
        const uint32_t kdst = ring + s * Gm::kStageBytes, vdst = kdst + Gm::kTileBytes;
        const int nbox = (rows + box - 1) / box;
        mbar_expect_tx(full(s), static_cast<uint32_t>(nbox * box * DH * 2 * 2));
        for (int j = 0; j < nbox; ++j) {
          const int64_t p = t0 + static_cast<int64_t>(j) * box;
          const int page = static_cast<int>(pool_page(bt[p / psz], npages));
          const int r = static_cast<int>(p % psz);
#pragma unroll
          for (int ch = 0; ch < Gm::kChunks; ++ch) {
            const uint32_t off = ch * kTK * Gm::kRowBytes + j * box * Gm::kRowBytes;
            tma_load(kdst + off, &tk, full(s), ch * Gm::kRowElems, hk, r, page);
            tma_load(vdst + off, &tv, full(s), ch * Gm::kRowElems, hk, r, page);
          }
        }
      }
      return;
    }
    // cp.async: lane l copies 16-byte unit l % kUnits of rows l / kUnits,
    // l / kUnits + kRowsAtOnce, ... of the stage, so each instruction reads
    // whole rows; it walks the pages from the stage's first row on and
    // reads the block-table entry of each page it enters.
    const int e = (lane % kUnits) * 8;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty(s), ((i / kStages) - 1) & 1);
      const int64_t t0 = start + static_cast<int64_t>(i) * kTK;
      const int rows = end - t0 < kTK ? static_cast<int>(end - t0) : kTK;
      const uint32_t kdst = ring + s * Gm::kStageBytes, vdst = kdst + Gm::kTileBytes;
      int64_t pi = t0 / psz, off = t0 % psz + lane / kUnits, page = -1;
      for (int r = lane / kUnits; r < rows; r += kRowsAtOnce, off += kRowsAtOnce) {
        if (page < 0 || off >= psz) {
          pi += off / psz;
          off %= psz;
          page = pool_page(bt[pi], npages);
        }
        const int64_t src = ((page * psz + off) * Hkv + hk) * DH + e;
        cp_async16(kdst + Gm::offset(r, e), kpool + src);
        cp_async16(vdst + Gm::offset(r, e), vpool + src);
      }
      cp_async_arrive(full(s));
    }
    return;
  }

  // Consumers.  In an mma fragment lane l holds row l / 4 (+ 8) and columns
  // 2 (l % 4), 2 (l % 4) + 1: of S^T, keys and heads; of O^T, dims and heads.
  const int gq = lane >> 2, tq = lane & 3;
  const unsigned short* qs = reinterpret_cast<const unsigned short*>(q) +
                             (b * Hq + static_cast<int64_t>(hk) * G) * DH;
  uint32_t qf[NT][KS][2];  // Q^T as the B operand: dims 16 kk + 2 tq (+ 8), head gq
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int h = nt * 8 + gq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = kk * 16 + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned short* x = qs + static_cast<int64_t>(h) * DH + d + 8 * half;
        qf[nt][kk][half] = h < G ? x[0] | (static_cast<uint32_t>(x[1]) << 16) : 0u;
      }
    }
  }
  float o[NT][KS][4], m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[nt][j] = kNegInf;
      l[nt][j] = 0.0f;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][mt][e] = 0.0f;
  }
  // ldmatrix rows: lanes 8i .. 8i + 7 address matrix i.  K as the A
  // operand: matrices (keys 0-7, 8-15) x (dims 0-7, 8-15), keys first;
  // V^T: the same four blocks read transposed, dims first.
  const int k_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_col = ((lane >> 4) & 1) * 8;
  const int v_row = 16 * warp + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int v_col = ((lane >> 3) & 1) * 8;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const int64_t k0 = start + static_cast<int64_t>(i) * kTK + 16 * warp;
    mbar_wait(full(s), (i / kStages) & 1);
    if (k0 < end) {
      const int nvalid = end - k0 < 16 ? static_cast<int>(end - k0) : 16;
      const uint32_t kt = ring + s * Gm::kStageBytes, vt = kt + Gm::kTileBytes;

      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + Gm::offset(k_row, kk * 16 + k_col));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(sc[nt], a, qf[nt][kk][0], qf[nt][kk][1]);
      }

      // Online softmax of each head (a column over the warp's 16 keys).
      const bool valid0 = gq < nvalid, valid1 = gq + 8 < nvalid;
      uint32_t bhi[NT][2], blo[NT][2];
      float corr[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float p[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s0 = valid0 ? sc[nt][j] * scale : kNegInf;
          const float s1 = valid1 ? sc[nt][j + 2] * scale : kNegInf;
          float mx = fmaxf(s0, s1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m[nt][j], mx);
          corr[nt][j] = expf(m[nt][j] - m_new);
          p[j] = valid0 ? expf(s0 - m_new) : 0.0f;
          p[j + 2] = valid1 ? expf(s1 - m_new) : 0.0f;
          l[nt][j] = l[nt][j] * corr[nt][j] + (p[j] + p[j + 2]);
          m[nt][j] = m_new;
        }
        // P = hi + lo, each as bf16 pairs (key gq or gq + 8; heads 2tq, 2tq + 1),
        // then transposed to P^T's B operand (keys 2tq, 2tq + 1 (+ 8); head gq).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t hi = pack_bf16(p[2 * r], p[2 * r + 1]);
          const uint32_t lo =
              pack_bf16(p[2 * r] - bf16_lo_half(hi), p[2 * r + 1] - bf16_hi_half(hi));
          bhi[nt][r] = movmatrix_trans(hi);
          blo[nt][r] = movmatrix_trans(lo);
        }
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          o[nt][mt][0] *= corr[nt][0];
          o[nt][mt][1] *= corr[nt][1];
          o[nt][mt][2] *= corr[nt][0];
          o[nt][mt][3] *= corr[nt][1];
        }
      }

      // O^T += V^T (P_hi^T + P_lo^T), Dh in m16 tiles.
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vt + Gm::offset(v_row, mt * 16 + v_col));
        if (nvalid < 16) {  // keys 2tq, 2tq + 1 in a[0..1], 8 more in a[2..3]
          a[0] = keep_keys(a[0], 2 * tq, nvalid);
          a[1] = keep_keys(a[1], 2 * tq, nvalid);
          a[2] = keep_keys(a[2], 2 * tq + 8, nvalid);
          a[3] = keep_keys(a[3], 2 * tq + 8, nvalid);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(o[nt][mt], a, bhi[nt][0], bhi[nt][1]);
          mma_bf16(o[nt][mt], a, blo[nt][0], blo[nt][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // Merge the four warps' partials in warp order, through the ring: every
  // consumer has read its last stage and every copy has landed.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 4);
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 8);
      l[nt][j] += __shfl_xor_sync(0xffffffffu, l[nt][j], 16);
    }
  float* wm = reinterpret_cast<float*>(ring_ptr);  // [warp][16]
  float* wl = wm + kConsumerWarps * 16;             // [warp][16]
  float* wo = wl + kConsumerWarps * 16;             // [warp][16][DH]
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = nt * 8 + 2 * tq + j;
      if (gq == 0) {
        wm[warp * 16 + h] = m[nt][j];
        wl[warp * 16 + h] = l[nt][j];
      }
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        wo[(warp * 16 + h) * DH + mt * 16 + gq] = o[nt][mt][j];
        wo[(warp * 16 + h) * DH + mt * 16 + gq + 8] = o[nt][mt][j + 2];
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
  float* out = part + ((b * Hkv + hk) * gridDim.x + c) * static_cast<int64_t>(G) * (DH + 2);
  for (int idx = threadIdx.x; idx < G * DH; idx += 32 * kConsumerWarps) {
    const int h = idx / DH, d = idx % DH;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) mb = fmaxf(mb, wm[w * 16 + h]);
    float acc = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float f = expf(wm[w * 16 + h] - mb);
      acc += wo[(w * 16 + h) * DH + d] * f;
      lsum += wl[w * 16 + h] * f;
    }
    out[2 * G + idx] = acc;
    if (d == 0) {
      out[h] = mb;
      out[G + h] = lsum;
    }
  }
}

// Sequence b, KV head hk: the live chunks' partials merged in chunk order,
// as combine_decode_partials merges shards: each rescaled to the largest
// m, summed, and acc / max(l, 1e-20) rounded to bf16.
__global__ void __launch_bounds__(kMergeThreads)
    paged_merge_kernel(const float* __restrict__ part, const int* __restrict__ seq_lens,
                       __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Dh, int64_t psz,
                       int64_t P, int64_t chunk_len, int nchunks) {
  const int hk = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int G = Hq / Hkv;
  int64_t len = seq_lens[b];
  len = len < 0 ? 0 : (len > P * psz ? P * psz : len);
  const int nlive = static_cast<int>((len + chunk_len - 1) / chunk_len);
  const int64_t stride = static_cast<int64_t>(G) * (Dh + 2);
  const float* base = part + (b * Hkv + hk) * nchunks * stride;
  for (int idx = threadIdx.x; idx < G * Dh; idx += kMergeThreads) {
    const int h = idx / Dh;
    float m_all = kNegInf;
    for (int c = 0; c < nlive; ++c) m_all = fmaxf(m_all, base[c * stride + h]);
    float acc = 0.0f, lsum = 0.0f;
    for (int c = 0; c < nlive; ++c) {
      const float* pc = base + c * stride;
      const float f = expf(pc[h] - m_all);
      lsum += pc[G + h] * f;
      acc += pc[2 * G + idx] * f;
    }
    out[(b * Hq + static_cast<int64_t>(hk) * G) * Dh + idx] =
        __float2bfloat16(acc / fmaxf(lsum, 1e-20f));
  }
}

// A pool (npages, psz, Hkv, DH) bf16 as a 4-D map whose box is one swizzle
// row of Dh, one head and `box` rows of one page.
template <int DH>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int64_t npages,
              int64_t psz, int64_t Hkv, int box) {
  using Gm = Geo<DH>;
  const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(Hkv), static_cast<cuuint64_t>(psz),
                              static_cast<cuuint64_t>(npages)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(DH * 2),
                                 static_cast<cuuint64_t>(Hkv * DH * 2),
                                 static_cast<cuuint64_t>(psz * Hkv * DH * 2)};
  const cuuint32_t boxdim[4] = {Gm::kRowElems, 1, static_cast<cuuint32_t>(box), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = Gm::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Gm::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, boxdim, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Positions of one split-KV work item, as near 2,048 as whole pages allow.
constexpr int64_t kChunkPositions = 2048;

int64_t chunk_pages(int64_t psz) {
  const int64_t n = (kChunkPositions + psz / 2) / psz;
  return n > 1 ? n : 1;
}

int64_t chunks(int64_t P, int64_t psz) {
  const int64_t per = chunk_pages(psz);
  return P > 0 ? (P + per - 1) / per : 1;
}

// fp32 scratch of a call: the partial (m, l, acc) of the G query heads of
// every (sequence, KV head, chunk), G (Dh + 2) floats each.
int64_t scratch_floats(int64_t B, int64_t Hq, int64_t Hkv, int64_t Dh, int64_t psz,
                       int64_t P) {
  return B * Hkv * chunks(P, psz) * (Hq / Hkv) * (Dh + 2);
}

// Adds to *launches each kernel it launches (two).
template <int DH, int NT>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kpool, const __nv_bfloat16* vpool,
           const int* bt, const int* sl, __nv_bfloat16* out, float* scratch, int64_t B,
           int64_t Hq, int64_t Hkv, int64_t npages, int64_t psz, int64_t P, float scale,
           int64_t* launches, cudaStream_t stream) {
  using Gm = Geo<DH>;
  // TMA and cp.async read 16-byte aligned rows
  if ((reinterpret_cast<uintptr_t>(kpool) | reinterpret_cast<uintptr_t>(vpool)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 4 != 0)
    return cudaErrorMisalignedAddress;
  const int64_t nchunks = chunks(P, psz);
  if (npages > INT_MAX || psz > INT_MAX || Hkv > 65535 || nchunks > INT_MAX)
    return cudaErrorInvalidValue;
  // TMA where a box of gcd(psz, 64) rows starts on an 8-row swizzle atom;
  // box 0 selects cp.async
  const int box = psz % 8 == 0 ? static_cast<int>(std::gcd(psz, int64_t{kTK})) : 0;
  CUtensorMap tk, tv;
  std::memset(&tk, 0, sizeof(tk));
  std::memset(&tv, 0, sizeof(tv));
  if (box) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    if (!make_map<DH>(encode, &tk, kpool, npages, psz, Hkv, box) ||
        !make_map<DH>(encode, &tv, vpool, npages, psz, Hkv, box))
      return cudaErrorInvalidValue;
  }
  static unsigned long long configured = 0;  // a bit per device
  const cudaError_t smem_err = raise_smem_limit(paged_tc_kernel<DH, NT>, Gm::kSmem, configured);
  if (smem_err != cudaSuccess) return smem_err;
  const int64_t chunk_len = chunk_pages(psz) * psz;
  const dim3 grid(static_cast<unsigned>(nchunks), static_cast<unsigned>(Hkv),
                  static_cast<unsigned>(B));
  paged_tc_kernel<DH, NT><<<grid, kThreads, Gm::kSmem, stream>>>(
      tk, tv, q, kpool, vpool, bt, sl, scratch, npages, psz, static_cast<int>(Hq),
      static_cast<int>(Hkv), P, chunk_len, box, scale);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launches;
  paged_merge_kernel<<<dim3(static_cast<unsigned>(Hkv), static_cast<unsigned>(B)),
                       kMergeThreads, 0, stream>>>(scratch, sl, out, static_cast<int>(Hq),
                                                   static_cast<int>(Hkv), DH, psz, P,
                                                   chunk_len, static_cast<int>(nchunks));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launches;
  return cudaSuccess;
}

template <int DH>
int by_group(const __nv_bfloat16* q, const __nv_bfloat16* kpool, const __nv_bfloat16* vpool,
             const int* bt, const int* sl, __nv_bfloat16* out, float* scratch, int64_t B,
             int64_t Hq, int64_t Hkv, int64_t npages, int64_t psz, int64_t P, float scale,
             int64_t* launches, cudaStream_t stream) {
  const int64_t G = Hq / Hkv;
  if (G <= 8)
    return launch<DH, 1>(q, kpool, vpool, bt, sl, out, scratch, B, Hq, Hkv, npages, psz, P,
                         scale, launches, stream);
  if (G <= 16)
    return launch<DH, 2>(q, kpool, vpool, bt, sl, out, scratch, B, Hq, Hkv, npages, psz, P,
                         scale, launches, stream);
  return cudaErrorInvalidValue;
}

int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* kpool, const __nv_bfloat16* vpool,
             const int* bt, const int* sl, __nv_bfloat16* out, float* scratch, int64_t B,
             int64_t Hq, int64_t Hkv, int64_t Dh, int64_t npages, int64_t psz, int64_t P,
             double scale, int64_t* launches, void* stream_ptr) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || npages <= 0 ||
      psz <= 0 || P < 0)
    return cudaErrorInvalidValue;
  const float s = static_cast<float>(scale);
  const auto st = static_cast<cudaStream_t>(stream_ptr);
  switch (Dh) {
    case 16: return by_group<16>(q, kpool, vpool, bt, sl, out, scratch, B, Hq, Hkv, npages, psz, P, s, launches, st);
    case 32: return by_group<32>(q, kpool, vpool, bt, sl, out, scratch, B, Hq, Hkv, npages, psz, P, s, launches, st);
    case 64: return by_group<64>(q, kpool, vpool, bt, sl, out, scratch, B, Hq, Hkv, npages, psz, P, s, launches, st);
    case 128: return by_group<128>(q, kpool, vpool, bt, sl, out, scratch, B, Hq, Hkv, npages, psz, P, s, launches, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tensor_core

}  // namespace

// Both entry points add to *launches each kernel they launch: one for fp32,
// two for bf16 (the items, then the merge).
extern "C" int um_paged_attention_f32(const float* q, const float* kpool,
                                      const float* vpool, const int* block_table,
                                      const int* seq_lens, float* out, int64_t B, int64_t Hq,
                                      int64_t Hkv, int64_t Dh, int64_t npages, int64_t psz,
                                      int64_t P, double scale, int64_t* launches,
                                      void* stream) {
  const int err = cuda_core::dispatch(q, kpool, vpool, block_table, seq_lens, out, B, Hq,
                                      Hkv, Dh, npages, psz, P, scale, stream);
  if (err == cudaSuccess) ++*launches;
  return err;
}

// Bytes of the fp32 scratch that um_paged_attention_bf16 takes for its
// work items' partials (0 for a shape it refuses).
extern "C" int64_t um_paged_attention_bf16_scratch_bytes(int64_t B, int64_t Hq, int64_t Hkv,
                                                         int64_t Dh, int64_t psz,
                                                         int64_t P) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || Dh <= 0 || psz <= 0 || P < 0)
    return 0;
  return tensor_core::scratch_floats(B, Hq, Hkv, Dh, psz, P) *
         static_cast<int64_t>(sizeof(float));
}

extern "C" int um_paged_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kpool,
                                       const __nv_bfloat16* vpool, const int* block_table,
                                       const int* seq_lens, __nv_bfloat16* out,
                                       float* scratch, int64_t B, int64_t Hq, int64_t Hkv,
                                       int64_t Dh, int64_t npages, int64_t psz, int64_t P,
                                       double scale, int64_t* launches, void* stream) {
  return tensor_core::dispatch(q, kpool, vpool, block_table, seq_lens, out, scratch, B, Hq,
                               Hkv, Dh, npages, psz, P, scale, launches, stream);
}
