// Flash attention forward (GQA, causal, optional sliding window) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel _fa_kernel in
// src/repro/kernels/flash_attention/kernel.py.  On the TPU the grid is
// (B*Hq, q blocks, KV blocks) and the third axis runs in order, carrying the
// running max, sum and accumulator in VMEM scratch.  Here one block owns one
// (batch, query head, 64-row query tile) and loops over 64-row KV tiles
// itself, with the running max, sum and accumulator of its rows in
// registers.  Query head h reads KV head h / (Hq / Hkv).  Queries are the
// last Sq positions of the KV stream (q_offset = Skv - Sq).  KV tiles wholly
// above the causal diagonal or wholly before the window of every row of the
// query tile are never loaded.  Ragged Sq and Skv are masked here (the
// Pallas kernel asserts that the blocks divide them).
//
// Bound on the H100: operations.  Causal prefill at S = 32k does
// 4 Hq Dh S(S+1)/2 operations on a few hundred MB.  This first kernel runs
// the products as IEEE fp32 FMAs on the CUDA cores (no TF32, no tensor
// cores), so fp32 keeps the JAX tests' 2e-3 tolerance; bf16 is widened to
// fp32 as it is staged and the output is rounded to nearest even.  Its
// ceiling is the 67 TFLOP/s fp32 rate, not the 989 TFLOP/s bf16 tensor-core
// peak that bounds the work: mma/wgmma tiles are later work.
//
// Design: 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns score
// rows 4ty..4ty+3 and columns tx + 16j of each 64 x 64 score tile, and the
// same rows and columns tx + 16c of the output.  Row max and sum are reduced
// over the 16 lanes of a row group with shuffles.  Q, the current K or V
// tile and P sit in shared memory as fp32, rows padded by 4 floats so that
// the 16-byte reads are free of bank conflicts.  The next tile is loaded
// into registers while the current one is multiplied.
#include "attention_common.cuh"

namespace {

using namespace um_attn;

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
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
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

}  // namespace

// window <= 0 means no window.
extern "C" int um_flash_attention_f32(const float* q, const float* k, const float* v,
                                      float* o, int64_t B, int64_t Sq, int64_t Skv,
                                      int64_t Hq, int64_t Hkv, int64_t Dh,
                                      int64_t causal, int64_t window, double scale,
                                      void* stream) {
  return dispatch(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dh, causal, window, scale, stream);
}

extern "C" int um_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* o,
                                       int64_t B, int64_t Sq, int64_t Skv, int64_t Hq,
                                       int64_t Hkv, int64_t Dh, int64_t causal,
                                       int64_t window, double scale, void* stream) {
  return dispatch(q, k, v, o, B, Sq, Skv, Hq, Hkv, Dh, causal, window, scale, stream);
}
