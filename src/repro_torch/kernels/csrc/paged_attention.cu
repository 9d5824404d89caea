// Paged decode attention (one query token, GQA) over a block-table KV pool,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _pa_kernel in
// src/repro/kernels/paged_attention/kernel.py.  There the block table rides
// the scalar-prefetch path, the grid is (B, pages per sequence) and each
// step DMAs one page while the running max, sum and accumulator of all Hq
// heads sit in VMEM.  Hopper has no scalar prefetch and its blocks run in
// no order, so here one block owns one (sequence, KV head), reads its own
// block-table row, and walks the sequence's live positions itself.
// Positions at or past seq_len (so every page wholly past it) are never
// loaded; a zero-length sequence gives zeros, since the output is
// acc / max(l, 1e-20) as on the TPU.
//
// Bound on the H100: bytes.  A decode step does 4 Hq Dh flops per live
// position on 4 Hkv Dh bytes (bf16) of K and V, 2 Hq/Hkv flops per byte:
// far below the ridge.  The design reads every K/V byte of a live page once
// per call: the block serves all G = Hq/Hkv query heads of its KV head, so
// a page is not read again for each query head.
//
// Design: 8 warps; warp w takes groups of R = 64/GP consecutive positions
// (GP = G rounded up to a power of two >= 4), groups w, w+8, w+16, ...  Each
// lane holds Dh/32 dims of the G query vectors in registers and loads the
// same dims of the group's K and V rows (one coalesced 16-, 8- or 4-byte
// access a lane and row), so a warp reads each row's Dh contiguous elements
// once.  The R x GP partial dot products of a lane are summed across the
// warp by a transpose-reduce (62 shuffles for 64 sums, each lane ending
// with two), then the group's scores go through shared memory to update
// the warp's running max, sum and accumulator (fp32, JAX's order of
// operations).  The next group's rows are loaded while a group is
// computed.  At the end the 8 warps' partials are merged exactly, as
// combine_decode_partials merges shards.  bf16 is widened on load; the
// output is rounded to nearest even.
#include "attention_common.cuh"

namespace {

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

}  // namespace

extern "C" int um_paged_attention_f32(const float* q, const float* kpool,
                                      const float* vpool, const int* block_table,
                                      const int* seq_lens, float* out, int64_t B,
                                      int64_t Hq, int64_t Hkv, int64_t Dh,
                                      int64_t npages, int64_t psz, int64_t P,
                                      double scale, void* stream) {
  return dispatch(q, kpool, vpool, block_table, seq_lens, out, B, Hq, Hkv, Dh, npages,
                  psz, P, scale, stream);
}

extern "C" int um_paged_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kpool,
                                       const __nv_bfloat16* vpool, const int* block_table,
                                       const int* seq_lens, __nv_bfloat16* out, int64_t B,
                                       int64_t Hq, int64_t Hkv, int64_t Dh,
                                       int64_t npages, int64_t psz, int64_t P,
                                       double scale, void* stream) {
  return dispatch(q, kpool, vpool, block_table, seq_lens, out, B, Hq, Hkv, Dh, npages,
                  psz, P, scale, stream);
}
