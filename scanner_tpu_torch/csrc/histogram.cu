// Per-row histograms of small-integer bin ids on an NVIDIA Hopper card
// (sm_90a), bound to Python with ctypes through a plain C interface
// (scanner_tpu_torch/kernels/cuda_ops.py builds and calls it).
//
// Replaces the TPU kernel scanner_tpu/kernels/pallas_ops.py::_hist_kernel
// (reached through pallas_histogram and histogram_frames).  It computes
// the same function, not the same blocks:
//   hist_u8_frames: (B, H, W, C) uint8 frames -> (B, C, bins) int32, with
//                   the binning bin = (v * bins) >> 8 fused into the read
//                   (histogram_frames; the engine's main path).  Reading
//                   the uint8 frames instead of int32 bin ids moves a
//                   quarter of the bytes.
//   hist_i32_ids:   (R, P) int32 bin ids -> (R, bins) int32, where only
//                   0 <= id < bins counts (pallas_histogram's contract:
//                   padding ids == bins count nowhere).
//
// What bounds it: the kernel must read every input byte once and does a
// handful of integer operations per byte, so it is bound by device-memory
// bytes.  At the main path's 16 x 480 x 640 x 3 uint8 that is 14.7 MB,
// about 4.4 us at the H100's 3.35 TB/s.  In practice shared-memory atomic
// contention can dominate instead: a flat-colored frame sends nearly every
// pixel of a channel to one bin, so every lane of a warp increments the
// same shared word.  Each warp therefore keeps its own C x bins
// sub-histogram in shared memory (contention is confined to one warp,
// never the whole block), the block sums the sub-histograms, and only then
// does one global atomicAdd per non-zero (row, channel, bin) into an
// output the wrapper zeroed.  Integer atomics are exact, so the result is
// bit-identical to the plain version whatever the order.
//
// Loads are 16 bytes per thread.  A row's start need not be 16-byte
// aligned (frames of ragged geometry), so each row splits into a scalar
// head up to the first aligned address, an aligned vector body, and a
// scalar tail; the channel of element e of a row is e % C, carried
// through each 16-byte vector from its starting element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kVecsPerThread = 8;      // 16-byte vectors per thread per block
constexpr int kMaxChannels = 4;

__device__ __forceinline__ void count_one(int* wh, uint8_t v, int c,
                                          int bins) {
  atomicAdd(&wh[c * bins + ((static_cast<int>(v) * bins) >> 8)], 1);
}

__device__ __forceinline__ void count_one(int* wh, int32_t v, int c,
                                          int bins) {
  if (v >= 0 && v < bins) atomicAdd(&wh[c * bins + v], 1);
}

template <typename T>
__device__ __forceinline__ void count_vec(int* wh, const uint4& q, int c,
                                          int C, int bins) {
  const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int k = 0; k < static_cast<int>(16 / sizeof(T)); ++k) {
    count_one(wh, e[k], c, bins);
    if (++c == C) c = 0;
  }
}

// One block covers one chunk of one row: blockIdx.x = row * chunks + chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ in, int* __restrict__ out,
            long long row_elems, int C, int bins, long long chunks) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ int sh[];
  const int nb = C * bins;
  const int warps = blockDim.x / 32;
  for (int i = threadIdx.x; i < warps * nb; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  int* wh = sh + (threadIdx.x / 32) * nb;

  const long long row = blockIdx.x / chunks;
  const long long chunk = blockIdx.x % chunks;
  const T* base = in + row * row_elems;

  // scalar head up to the first 16-byte boundary, then whole vectors
  long long head =
      ((16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15) / sizeof(T);
  if (head > row_elems) head = row_elems;
  const long long nvec = (row_elems - head) / V;
  const long long body_end = head + nvec * V;

  const long long per_block = static_cast<long long>(kThreads) *
                              kVecsPerThread;
  const long long vlo = chunk * per_block;
  long long vhi = vlo + per_block;
  if (vhi > nvec) vhi = nvec;
  const uint4* vbase = reinterpret_cast<const uint4*>(base + head);
  for (long long v = vlo + threadIdx.x; v < vhi; v += blockDim.x) {
    const uint4 q = __ldg(vbase + v);
    count_vec<T>(wh, q, static_cast<int>((head + v * V) % C), C, bins);
  }
  if (chunk == 0) {
    // the head and the tail: fewer than V elements each
    for (long long e = threadIdx.x; e < head; e += blockDim.x)
      count_one(wh, base[e], static_cast<int>(e % C), bins);
    for (long long e = body_end + threadIdx.x; e < row_elems;
         e += blockDim.x)
      count_one(wh, base[e], static_cast<int>(e % C), bins);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    int s = 0;
    for (int w = 0; w < warps; ++w) s += sh[w * nb + i];
    if (s) atomicAdd(&out[row * nb + i], s);
  }
}

template <typename T>
int launch(const void* in, void* out, long long rows, long long row_elems,
           int C, int bins, void* stream) {
  if (rows <= 0 || row_elems <= 0) return cudaSuccess;
  constexpr int V = 16 / sizeof(T);
  const long long per_block = static_cast<long long>(kThreads) *
                              kVecsPerThread;
  long long nvec = row_elems / V;
  long long chunks = (nvec + per_block - 1) / per_block;
  if (chunks < 1) chunks = 1;
  const size_t smem = sizeof(int) * (kThreads / 32) * C * bins;
  hist_kernel<T><<<static_cast<unsigned>(rows * chunks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<int*>(out), row_elems, C, bins,
      chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// frames: (B, H*W*C) uint8, out: (B, C, bins) int32 zeroed by the caller
int hist_u8_frames(const void* frames, void* out, long long B,
                   long long frame_elems, int C, int bins, void* stream) {
  if (C < 1 || C > kMaxChannels || bins < 1 || bins > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<uint8_t>(frames, out, B, frame_elems, C, bins, stream);
}

// ids: (R, P) int32, out: (R, bins) int32 zeroed by the caller
int hist_i32_ids(const void* ids, void* out, long long R, long long P,
                 int bins, void* stream) {
  if (bins < 1 || bins > 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int32_t>(ids, out, R, P, 1, bins, stream);
}

}  // extern "C"
