// One flash-attention update of online-softmax state with an arriving K/V
// block, on an NVIDIA Hopper card (sm_90a), bound to Python with ctypes
// through a plain C interface (scanner_tpu_torch/kernels/attention.py
// builds and calls it).
//
// Replaces the TPU kernel scanner_tpu/kernels/pallas_attention.py::
// _flash_kernel (entry flash_block_update), which ring attention calls once
// per ring step.  Same function and the same formulas, not the same blocks:
//
//   q (BH, Tq, D) f32, already scaled;  k, v (BH, Tk, D) f32;
//   m, l (BH, Tq) running max and normaliser;  acc (BH, Tq, D);
//   q_off, k_off: global positions of q[., 0] and k[., 0] for the causal
//   mask (q_pos >= k_pos is kept).  NEG_INF = -1e30 is the sentinel of an
//   empty row: a row that sees no key keeps m = NEG_INF, l = 0, acc = 0.
//
// Per K tile, for each query row (the Pallas body, pallas_attention.py:63-94):
//   m_new  = max(m, max_j s_j)
//   m_safe = m_new <= NEG_INF/2 ? 0 : m_new
//   p_j    = s_j <= NEG_INF/2 ? 0 : exp(s_j - m_safe)
//   corr   = m <= NEG_INF/2 ? 0 : exp(m - m_safe)
//   l      = l * corr + sum_j p_j ;  acc = acc * corr + p . V ;  m = m_new
//
// Design (a simple, correct first kernel; tensor cores come later).  The
// TPU kernel walks the K/V tiles in its sequential grid and carries
// (m, l, acc) in the revisited output block; here one CUDA block owns 64
// query rows of one (batch, head) and walks every K/V tile in a loop, with
// the carry in registers.  256 threads form a 16 x 16 grid: thread
// (ty, tx) holds query rows ty + 16 i (i < 4), logit columns tx + 16 j
// (j < 4) of each 64-key tile, and output columns tx + 16 j (j < D/16).
// Both products are f32 FMAs on the CUDA cores from shared memory:
// Q and K rows are read as float4 along D with a row stride of D + 4
// floats (conflict-free for a quarter-warp), the probabilities go through
// a 64 x 80 shared tile.  Row max and row sum are butterfly shuffles over
// the 16 lanes of a half-warp, so all 16 lanes hold identical (m, l).
// Ragged edges: Q rows past Tq and K rows past Tk are zero in shared
// memory, and logits of keys past Tk are set to NEG_INF, which the
// formulas above turn into p = 0 exactly as a masked key.  With a causal
// mask, a K tile that lies wholly after the block's last query is skipped
// and given its exact effect (corr = 1 where m is set, l = acc = 0 where
// it is not).
//
// What bounds it: 4 * BH * Tq * Tk * D flops against q/k/v/acc bytes; at
// the long-clip shapes (Tq = Tk = 2048) that is thousands of flops per
// byte, so it is bound by arithmetic: f32 on the CUDA cores (67 TFLOP/s
// on an H100 SXM), and in this first design by shared-memory bandwidth
// (about one 16-byte shared load per four FMAs).  wgmma on bf16/TF32
// tiles fed by TMA is the way to the tensor-core rate.
//
// Shared memory: (64 + 64) x (D + 4) + 64 x D + 64 x 80 floats, 121 KB at
// D = 128, so the kernel is launched with dynamic shared memory after
// cudaFuncSetAttribute raises its limit above 48 KB.  D <= 128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = kNegInf * 0.5f;
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kCols = kBK / 16;     // logit columns per thread
constexpr int kPStride = kBK + 16;  // probability tile row stride (floats)
constexpr int kMaxD = 128;

template <int DPT>  // output columns per thread: D <= 16 * DPT
struct Layout {
  static constexpr int kDMax = 16 * DPT;
  static constexpr int kQK = kDMax + 4;  // Q and K row stride (floats)
  static constexpr int kV = kDMax;       // V row stride (floats)
  static constexpr size_t kBytes =
      sizeof(float) * (size_t(kBQ) * kQK + size_t(kBK) * kQK +
                       size_t(kBK) * kV + size_t(kBQ) * kPStride);
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

template <int DPT>
__global__ void __launch_bounds__(kThreads)
flash_update_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ acc_in,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int q_tiles, int Tq,
                    int Tk, int D, long long q_off, long long k_off,
                    int causal) {
  using L = Layout<DPT>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * L::kQK;
  float* sV = sK + kBK * L::kQK;
  float* sP = sV + kBK * L::kV;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const long long bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const float* qb = q + bh * Tq * D;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const int D4 = (D + 3) & ~3;

  for (int i = tid; i < kBQ * L::kQK; i += kThreads) {
    const int r = i / L::kQK, c = i % L::kQK;
    sQ[i] = (q0 + r < Tq && c < D) ? qb[(long long)(q0 + r) * D + c] : 0.f;
  }

  float m_r[kRows], l_r[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool ok = r < Tq;
    const long long row = bh * Tq + r;
    m_r[i] = ok ? m_in[row] : kNegInf;
    l_r[i] = ok ? l_in[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      acc[i][j] = (ok && d < D) ? acc_in[row * D + d] : 0.f;
    }
  }

  const long long q_last = q_off + min(q0 + kBQ, Tq) - 1;
  const int k_tiles = (Tk + kBK - 1) / kBK;
  for (int t = 0; t < k_tiles; ++t) {
    const int k0 = t * kBK;
    if (causal && k_off + k0 > q_last) {
      // every logit of the tile is masked: p = 0, m_new = max(m, NEG_INF),
      // corr = 1 where m is set and 0 where it is not
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (m_r[i] <= kMaskedBelow) {
          l_r[i] = 0.f;
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
        }
        m_r[i] = fmaxf(m_r[i], kNegInf);
      }
      continue;
    }

    __syncthreads();  // the previous tile's sK / sV / sP reads are done
    for (int i = tid; i < kBK * L::kQK; i += kThreads) {
      const int r = i / L::kQK, c = i % L::kQK;
      sK[i] = (k0 + r < Tk && c < D) ? kb[(long long)(k0 + r) * D + c] : 0.f;
    }
    for (int i = tid; i < kBK * L::kV; i += kThreads) {
      const int r = i / L::kV, c = i % L::kV;
      sV[i] = (k0 + r < Tk && c < D) ? vb[(long long)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    // logits s = q . k for 4 rows x 4 keys, float4 along D
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D4; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &sQ[(ty + 16 * i) * L::kQK + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &sK[(tx + 16 * j) * L::kQK + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of this thread's rows
    float corr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long q_pos = q_off + q0 + ty + 16 * i;
      float mb = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kc = k0 + tx + 16 * j;
        if (kc >= Tk || (causal && q_pos < k_off + kc)) s[i][j] = kNegInf;
        mb = fmaxf(mb, s[i][j]);
      }
      mb = half_warp_max(mb);
      const float m_new = fmaxf(m_r[i], mb);
      const float m_safe = m_new <= kMaskedBelow ? 0.f : m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p =
            s[i][j] <= kMaskedBelow ? 0.f : expf(s[i][j] - m_safe);
        s[i][j] = p;
        ps += p;
      }
      ps = half_warp_sum(ps);
      corr[i] = m_r[i] <= kMaskedBelow ? 0.f : expf(m_r[i] - m_safe);
      l_r[i] = l_r[i] * corr[i] + ps;
      m_r[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // pv = p . V for 4 rows x DPT output columns
    float pv[kRows][DPT];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) pv[i][j] = 0.f;
    for (int c = 0; c < kBK; c += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &sP[(ty + 16 * i) * kPStride + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DPT];
#pragma unroll
        for (int j = 0; j < DPT; ++j) vv[j] = sV[(c + cc) * L::kV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = comp(p4[i], cc);
#pragma unroll
          for (int j = 0; j < DPT; ++j) pv[i][j] = fmaf(p, vv[j], pv[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const long long row = bh * Tq + r;
    if (tx == 0) {
      m_out[row] = m_r[i];
      l_out[row] = l_r[i];
    }
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) acc_out[row * D + d] = acc[i][j];
    }
  }
}

template <int DPT>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m_in, const float* l_in, const float* acc_in,
                   float* m_out, float* l_out, float* acc_out, long long BH,
                   int Tq, int Tk, int D, long long q_off, long long k_off,
                   int causal, cudaStream_t stream) {
  // the limit is per device, so it is raised on every launch (a cheap
  // call) rather than once per process
  const size_t bytes = Layout<DPT>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_update_kernel<DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const int q_tiles = (Tq + kBQ - 1) / kBQ;
  const long long blocks = BH * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_update_kernel<DPT><<<static_cast<unsigned>(blocks), kThreads, bytes,
                             stream>>>(q, k, v, m_in, l_in, acc_in, m_out,
                                       l_out, acc_out, q_tiles, Tq, Tk, D,
                                       q_off, k_off, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors contiguous f32 on the current device.  Returns the CUDA
// error of the launch (0 on success); the wrapper raises on anything else.
int flash_block_update_f32(const float* q, const float* k, const float* v,
                           const float* m_in, const float* l_in,
                           const float* acc_in, float* m_out, float* l_out,
                           float* acc_out, long long BH, long long Tq,
                           long long Tk, int D, long long q_off,
                           long long k_off, int causal, void* stream) {
  if (D < 1 || D > kMaxD || Tq > 0x7fffffffLL || Tk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tq = static_cast<int>(Tq), tk = static_cast<int>(Tk);
  cudaError_t e;
  if (D <= 16)
    e = launch<1>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH,
                  tq, tk, D, q_off, k_off, causal, s);
  else if (D <= 32)
    e = launch<2>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH,
                  tq, tk, D, q_off, k_off, causal, s);
  else if (D <= 64)
    e = launch<4>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH,
                  tq, tk, D, q_off, k_off, causal, s);
  else
    e = launch<8>(q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out, BH,
                  tq, tk, D, q_off, k_off, causal, s);
  return static_cast<int>(e);
}

}  // extern "C"
