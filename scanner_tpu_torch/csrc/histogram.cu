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
// What bounds it: every input byte is read once and costs a shift, a mask
// and an increment, so at the main path's 16 x 480 x 640 x 3 uint8
// (14.7 MB) the bytes bind: 4.4 us at the H100's 3.35 TB/s, against about
// 2.6 us for three INT32 operations a byte on the INT32 lanes.  On the
// card two things bind first.  The counting: one shared-memory atomic a
// byte, so the time follows the SMs that count (96 of 132 at B = 16, by
// what the card's GPCs hold in clusters).  And what every block pays
// once: the first loads' latency, the block's totals, the cluster
// barrier and the wait for the cluster's slowest block.
//
// * The channel is fixed at compile time (hist_u8_private<C>, for C = 1,
//   3 and 4 at the main path's 16 bins).  A warp loads 32 consecutive
//   16-byte vectors per instruction, fully coalesced.  Byte b of a vector
//   lies in channel (r + b) % C, where r, the channel of the vector's
//   first byte, stays the same for a lane from one step to the next (a
//   step moves 16 times a multiple of C bytes), so each lane rotates C
//   counter base addresses once and the unrolled loop indexes them with
//   constants.  A byte's bin is one byte of (word >> 4) & 0x0f0f0f0f (a
//   byte permute): the loop has no division, no modulo and no run-time
//   channel, 4.85 SASS instructions a byte.
// * Counting cannot contend: every thread has private 32-bit counters in
//   shared memory laid out [channel * bins + bin][thread], so the 32
//   lanes of a warp always address 32 different banks, whatever the
//   pixels (a flat frame costs what a random one does).  An increment is
//   one `red.shared.add`.  A thread touches no column but its own until
//   the block's totals, so it clears its column and counts on with no
//   barrier; the totals read each counter's row with 16-byte loads, four
//   threads a row, at lane-rotated offsets free of bank conflicts.  Other
//   bins, C = 2, and the int32-id entry take hist_general: run-time bins
//   and channel, one sub-histogram per warp, contention confined to a
//   warp (its time depends on the data).
// * Bytes in flight: a lane keeps its next step's loads (kStepVecs: 6
//   vectors for C = 3, 96 bytes) in flight while it counts the current
//   one, and the first loads go out before the counters are cleared, so
//   the clear runs under their latency.  Steps of 9 or 12 vectors ran
//   slower (more instructions a byte).
// * Balance: each block asks for more than half an SM's shared memory,
//   so an SM holds one block, and the k blocks of a row split its body
//   into equal runs of vectors.  The wrapper picks the largest k for
//   which the card holds all B clusters of k at once
//   (hist_cluster_caps): an H100's GPCs hold 15 clusters of 8, not 16,
//   so B = 16 takes k = 6 (96 SMs), B = 8 k = 9, B = 32 k = 3.
// * The output is written once: the k blocks of a row form one thread-
//   block cluster; each block sums its counters into C * bins totals and
//   stores them into block 0's shared memory through distributed shared
//   memory; after one cluster barrier block 0 adds them and stores the
//   row.  No fill, no global atomics, one launch a call.  Integer sums
//   are exact, so the result is bit-identical to the plain version.
//
// A row's start need not be 16-byte aligned (frames of ragged geometry,
// views), so each row splits into a head of fewer than 16 bytes up to the
// first aligned address, a body of whole vectors, and a tail of less than
// one; block 0 of the row counts the head and the tail.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;  // scales the vectors a lane loads per step
constexpr int kMaxChannels = 4;
constexpr int kMaxBins = 128;
constexpr int kMaxCluster = 16;
// the private-counter kernel's bins, 2^kLB: the main path's 16
constexpr int kLB = 4;
constexpr int kBins = 1 << kLB;
// more than half of an SM's 228 KB of shared memory: one block per SM
constexpr size_t kSpreadSmem = 116 * 1024;

// A row of n elements starting at `base`: `head` elements up to the first
// 16-byte aligned address, then `groups` whole groups of `group`
// elements; block `rank` of the row's k takes groups [g0, g1).
struct Split {
  long long head, groups, g0, g1;
};

template <typename T>
__device__ __forceinline__ Split split_row(const T* base, long long n,
                                           long long group, int rank,
                                           int k) {
  Split s;
  s.head = static_cast<long long>(
      ((16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15) / sizeof(T));
  if (s.head > n) s.head = n;
  s.groups = (n - s.head) / group;
  s.g0 = s.groups * rank / k;
  s.g1 = s.groups * (rank + 1) / k;
  return s;
}

// A block may write another's shared memory only once that block has
// started: every block arrives on the cluster barrier as it starts
// (started()) and waits on it before its first remote store
// (gather_slot), by when the others have long arrived.
__device__ __forceinline__ void started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// Rank 0's slot of this block's totals: every block of a row's cluster
// stores its C * bins totals into rank 0's gather[k][nb] through
// distributed shared memory.  Every thread of the block calls it.
__device__ __forceinline__ int* gather_slot(cg::cluster_group& cluster,
                                            int* gather, int nb) {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  return cluster.map_shared_rank(gather, 0) +
         static_cast<int>(cluster.block_rank()) * nb;
}

// After every block of the cluster stored its totals (gather_slot), rank 0
// sums them and stores the row: the output is written once.  Every thread
// of every block of the cluster calls it.
__device__ __forceinline__ void store_row(cg::cluster_group& cluster,
                                          const int* gather, int nb,
                                          int* out_row) {
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int k = static_cast<int>(cluster.num_blocks());
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      int s = 0;
      for (int r = 0; r < k; ++r) s += gather[r * nb + i];
      out_row[i] = s;
    }
  }
}

// -- the private-counter kernel: C and 16 bins fixed at compile time -------

// One count into a thread's private counter.
__device__ __forceinline__ void bump(uint32_t addr) {
  asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(addr) : "memory");
}

// 16-byte vectors a lane loads per step: a multiple of 3 for C = 3, so
// that a step moves every lane's channel phase by a whole turn.
template <int C>
constexpr int kStepVecs = (C == 3 ? 3 : 1) * kUnroll;

template <int C>
__device__ __forceinline__ void count_vec(const uint4& v,
                                          const uint32_t (&cb)[C]) {
  constexpr uint32_t kMask = 0x01010101u * (kBins - 1u);
  constexpr uint32_t kBinBytes = 4u * kThreads;  // one bin's counters
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = (w[j] >> (8 - kLB)) & kMask;  // four bins
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bump(cb[(4 * j + b) % C] + __byte_perm(t, 0, 0x4440 + b) * kBinBytes);
  }
}

template <int C>
__device__ __forceinline__ void load_step(uint4 (&buf)[kStepVecs<C>],
                                          const uint4* body, long long v,
                                          long long v1) {
#pragma unroll
  for (int i = 0; i < kStepVecs<C>; ++i)
    buf[i] = v + 32 * i < v1 ? __ldg(body + v + 32 * i)
                             : make_uint4(0, 0, 0, 0);
}

// Shared memory: the counters [C * bins][kThreads] and gather[k][C * bins],
// and at least kSpreadSmem, so that an SM holds one block and a cluster's
// blocks spread over SMs instead of sharing one.
template <int C>
constexpr size_t private_smem() {
  constexpr size_t kNeed =
      sizeof(int) * (static_cast<size_t>(C * kBins) * (kThreads + kMaxCluster));
  return kNeed > kSpreadSmem ? kNeed : kSpreadSmem;
}

// One cluster of k blocks per row: blockIdx.x = row * k + rank.  A warp
// loads 32 consecutive vectors per instruction; byte b of the vector a
// lane loads as its i-th of a step lies in channel (r_i + b) % C, where
// r_i, the channel of the vector's first byte, is fixed for the lane
// across steps, so cb[i][b % C] is its counter base.
template <int C>
__global__ void __launch_bounds__(kThreads)
hist_u8_private(const uint8_t* __restrict__ in, int* __restrict__ out,
                long long n) {
  constexpr int kNB = C * kBins;
  constexpr int kV = kStepVecs<C>;
  constexpr long long kStep = 32LL * kV * kWarps;  // vectors a step takes
  extern __shared__ int4 smem4[];
  int* cnt = reinterpret_cast<int*>(smem4);  // [kNB][kThreads]
  int* gather = cnt + kNB * kThreads;        // [k][kNB], used in rank 0

  started();
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / k;
  const uint8_t* base = in + row * n;
  const Split s = split_row(base, n, 16, rank, k);
  const uint4* body = reinterpret_cast<const uint4*>(base + s.head);

  const int lane = threadIdx.x & 31;
  long long v = s.g0 + (threadIdx.x >> 5) * (32LL * kV) + lane;
  uint4 cur[kV];
  load_step<C>(cur, body, v, s.g1);

  // a thread counts into its own column of counters and no other, so it
  // clears that column and counts on without a barrier
#pragma unroll
  for (int i = 0; i < kNB; ++i) cnt[i * kThreads + threadIdx.x] = 0;
  const uint32_t mine =
      static_cast<uint32_t>(__cvta_generic_to_shared(cnt + threadIdx.x));
  uint32_t cb[kV][C];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int r = static_cast<int>((s.head + 16 * (v + 32 * i)) % C);
#pragma unroll
    for (int j = 0; j < C; ++j)
      cb[i][j] = mine + ((r + j) % C) * (4u * kBins * kThreads);
  }

  for (; v < s.g1; v += kStep) {
    uint4 nxt[kV];
    load_step<C>(nxt, body, v + kStep, s.g1);
#pragma unroll
    for (int i = 0; i < kV; ++i)
      if (v + 32 * i < s.g1) count_vec(cur[i], cb[i]);
#pragma unroll
    for (int i = 0; i < kV; ++i) cur[i] = nxt[i];
  }
  if (rank == 0) {  // the head and the tail, channel e % C
    for (long long e = threadIdx.x; e < s.head; e += kThreads)
      bump(mine + ((static_cast<int>(e % C) << kLB) + (base[e] >> (8 - kLB))) *
                      4u * kThreads);
    for (long long e = s.head + 16 * s.groups + threadIdx.x; e < n;
         e += kThreads)
      bump(mine + ((static_cast<int>(e % C) << kLB) + (base[e] >> (8 - kLB))) *
                      4u * kThreads);
  }
  __syncthreads();

  // this block's totals: counter i's kThreads values are contiguous, and
  // kParts threads sum a run of them each with 16-byte loads, starting at
  // lane-rotated offsets so that the 8 lanes of a quarter warp read 8
  // different bank groups
  constexpr int kParts = 4;
  constexpr int kRun = kThreads / 4 / kParts;  // 16-byte loads a thread
  const int part = threadIdx.x % kParts;
  int* slot = gather_slot(cluster, gather, kNB);
  for (int i0 = 0; i0 < kNB; i0 += kThreads / kParts) {
    const int i = i0 + threadIdx.x / kParts;
    int sum = 0;
    if (i < kNB) {
      const int4* run = smem4 + i * (kThreads / 4) + part * kRun;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int4 x = run[(j + lane) % kRun];
        sum += x.x + x.y + x.z + x.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (i < kNB && part == 0) slot[i] = sum;
  }
  store_row(cluster, gather, kNB, out + row * kNB);
}

// -- the general kernel: run-time channels and bins, uint8 or int32 ---------

__device__ __forceinline__ void count_one(int* wh, uint8_t v, int c,
                                          int bins) {
  atomicAdd(&wh[c * bins + ((static_cast<int>(v) * bins) >> 8)], 1);
}

__device__ __forceinline__ void count_one(int* wh, int32_t v, int c,
                                          int bins) {
  if (v >= 0 && v < bins) atomicAdd(&wh[c * bins + v], 1);
}

size_t general_smem(int nb) {
  return sizeof(int) * (kWarps + kMaxCluster) * nb;
}

// One cluster of k blocks per row; groups are single 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_general(const T* __restrict__ in, int* __restrict__ out, long long n,
             int C, int bins) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ int4 smem4[];
  int* sh = reinterpret_cast<int*>(smem4);  // [kWarps][nb]
  const int nb = C * bins;
  int* gather = sh + kWarps * nb;           // [k][nb], used in rank 0
  started();
  for (int i = threadIdx.x; i < kWarps * nb; i += kThreads) sh[i] = 0;
  __syncthreads();
  int* wh = sh + (threadIdx.x / 32) * nb;

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / k;
  const T* base = in + row * n;
  const Split s = split_row(base, n, V, rank, k);
  const uint4* body = reinterpret_cast<const uint4*>(base + s.head);

  // the channel of vector g's first element is (head + g * V) % C; one
  // step of the loop moves it by (kThreads * V) % C
  long long g = s.g0 + threadIdx.x;
  int c0 = static_cast<int>((s.head + g * V) % C);
  const int step = (kThreads * V) % C;
  for (; g < s.g1; g += kThreads) {
    const uint4 q = __ldg(body + g);
    const T* e = reinterpret_cast<const T*>(&q);
    int c = c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      count_one(wh, e[j], c, bins);
      if (++c == C) c = 0;
    }
    c0 += step;
    if (c0 >= C) c0 -= C;
  }
  if (rank == 0) {  // the head and the tail
    for (long long e = threadIdx.x; e < s.head; e += kThreads)
      count_one(wh, base[e], static_cast<int>(e % C), bins);
    for (long long e = s.head + s.groups * V + threadIdx.x; e < n;
         e += kThreads)
      count_one(wh, base[e], static_cast<int>(e % C), bins);
  }
  __syncthreads();
  int* slot = gather_slot(cluster, gather, nb);
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += sh[w * nb + i];
    slot[i] = sum;
  }
  store_row(cluster, gather, nb, out + row * nb);
}

// -- launching --------------------------------------------------------------

// Sets a kernel's shared-memory limit to `smem` and lets it take 16-block
// clusters, once per card; `ready` holds a bit per card for this kernel.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, unsigned* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (__atomic_load_n(ready, __ATOMIC_ACQUIRE) & bit)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  __atomic_fetch_or(ready, bit, __ATOMIC_RELEASE);
  return 0;
}

template <int C>
unsigned private_ready = 0;
template <typename T>
unsigned general_ready = 0;

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, long long rows,
                                  int k, size_t smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(k);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, long long rows, int k, void* stream,
           Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, rows, k, smem, stream);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_private(const void* in, void* out, long long rows, long long n,
                   int k, void* stream) {
  const int err =
      prepare(hist_u8_private<C>, private_smem<C>(), &private_ready<C>);
  if (err) return err;
  return launch(hist_u8_private<C>, private_smem<C>(), rows, k, stream,
                static_cast<const uint8_t*>(in), static_cast<int*>(out), n);
}

bool bad_grid(long long rows, int k) {
  return rows < 0 || k < 1 || k > kMaxCluster || rows * k > INT_MAX;
}

}  // namespace

extern "C" {

// 2: the output is written once by the kernel (no zeroing by the caller),
// and the caller passes k, the blocks (one cluster) per row.
int hist_abi_version() { return 2; }

// caps[k - 1], k = 1..n (n <= 16): how many clusters of k blocks of the
// main path's kernel the current card holds at once (0 where it cannot
// run them).  Returns 0, or a CUDA error.
int hist_cluster_caps(int* caps, int n) {
  auto kernel = hist_u8_private<3>;
  const size_t smem = private_smem<3>();
  const int err = prepare(kernel, smem, &private_ready<3>);
  if (err) return err;
  for (int k = 1; k <= n && k <= kMaxCluster; ++k) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(&attr, 1, k, smem, nullptr);
    caps[k - 1] = 0;
    if (cudaOccupancyMaxActiveClusters(&caps[k - 1], kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();
      caps[k - 1] = 0;
    }
  }
  return 0;
}

// frames: (B, n = H*W*C) uint8, out: (B, C, bins) int32, written whole
int hist_u8_frames(const void* frames, void* out, long long B, long long n,
                   int C, int bins, int k, void* stream) {
  if (C < 1 || C > kMaxChannels || bins < 1 || bins > kMaxBins || n < 0 ||
      bad_grid(B, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (bins == kBins) {
    switch (C) {
      case 1: return launch_private<1>(frames, out, B, n, k, stream);
      case 3: return launch_private<3>(frames, out, B, n, k, stream);
      case 4: return launch_private<4>(frames, out, B, n, k, stream);
    }
  }
  const int err = prepare(hist_general<uint8_t>,
                          general_smem(kMaxChannels * kMaxBins),
                          &general_ready<uint8_t>);
  if (err) return err;
  return launch(hist_general<uint8_t>, general_smem(C * bins), B, k, stream,
                static_cast<const uint8_t*>(frames), static_cast<int*>(out),
                n, C, bins);
}

// ids: (R, P) int32, out: (R, bins) int32, written whole
int hist_i32_ids(const void* ids, void* out, long long R, long long P,
                 int bins, int k, void* stream) {
  if (bins < 1 || bins > kMaxBins || P < 0 || bad_grid(R, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const int err = prepare(hist_general<int32_t>, general_smem(kMaxBins),
                          &general_ready<int32_t>);
  if (err) return err;
  return launch(hist_general<int32_t>, general_smem(bins), R, k, stream,
                static_cast<const int32_t*>(ids), static_cast<int*>(out), P,
                1, bins);
}

}  // extern "C"
