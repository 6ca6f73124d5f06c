// One flash-attention update of online-softmax state with an arriving K/V
// block, on an NVIDIA Hopper card (sm_90a): both products on the tensor
// cores in TF32 (wgmma), fed by TMA loads behind mbarriers.  Bound to
// Python with ctypes through a plain C interface
// (scanner_tpu_torch/kernels/attention.py builds and calls it).
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
// What bounds it on an H100 SXM: 4 * BH * Tq * Tk * D flops at the TF32
// tensor-core rate (495 TFLOP/s dense), BH * Tq * Tk exponentials at the
// special-function rate (about 3.9 T/s, FlashAttention-3, Shah et al.
// 2024), and q/k/v/carry bytes at 3.35 TB/s.  At (BH, T, D) =
// 16 x 2048 x 128 the flops bind: 34.4 GFLOP, 0.069 ms (exps 0.017 ms).
// At the pose train step's call, 8 x 2048 x 32, flops and exps tie at
// about 0.0087 ms, so the softmax's own arithmetic weighs as much as the
// products there.
//
// Design.  Two kernels per call, launched by the same C entry:
//  1. transpose_v_kernel writes V^T (BH, Dp, Tk8) to a scratch buffer.
//     TF32 wgmma reads both operands K-major from shared memory (there is
//     no transpose bit for 32-bit types), and for O += P . V the
//     contraction runs over keys, so B must be V^T.  The pass rounds V to
//     TF32 and permutes the keys inside each group of 8 (below); it costs
//     one read and one write of V (about 10 us at 16 x 2048 x 128).
//  2. flash_tf32_kernel: one block owns 128 query rows of one (batch,
//     head) and walks every tile of K and V^T in a loop (BK = 64 keys at
//     D = 128, 128 at D <= 64), with the carry (m, l, acc) in registers.
//     Three warpgroups, specialised:
//       * a producer warpgroup, of which one thread issues the TMA loads:
//         Q once, then K and V^T tiles into a ring of shared-memory stages
//         (2 at D >= 64, 4 at D = 32).  K and V^T of a stage each have a
//         "full" mbarrier (TMA byte count) and an "empty" one (the eight
//         consumer warps): K is released once S = Q . K^T is done, V^T
//         once O += P . V is, so the next tiles' copies run under the
//         current tiles' products.  It hands its registers to the
//         consumers with setmaxnreg (40 a thread; they get 232);
//       * two consumer warpgroups of 64 query rows each run
//         S = Q . K^T (wgmma m64nBKk8, A and B from shared memory), the
//         mask and the online softmax on S in registers, and
//         O += P . V (wgmma m64nDk8, A = P from registers, B = V^T from
//         shared memory).  Tile j's P . V is issued right behind tile
//         j + 1's Q . K^T, and tile j + 1's softmax runs while P . V is
//         still on the tensor cores.  Two named barriers make the
//         warpgroups take turns issuing their products, so one's softmax
//         runs while the other's products are on the tensor cores
//         (FlashAttention-3's "ping-pong").
//     With a causal mask, the blocks with the most tiles start first.
//     Tensor maps are 3-D (D, T, BH) with a 128-byte swizzle (32 f32 per
//     row of the swizzle atom; D = 128 is four atoms), so a tile that runs
//     past Tq or Tk is zero-filled by the hardware and never reads the
//     next head's rows.  Keys past Tk get the NEG_INF logit.  With a
//     causal mask, tiles wholly after the block's last query are never
//     loaded and get their exact effect (corr = 1 where m is set; l = acc
//     = 0 where it is not); only tiles that straddle the diagonal or the
//     end of K are masked.
//  P stays in registers: the accumulator of S holds columns (2t, 2t+1)
//  of each 8-column group where the tf32 A fragment wants (t, t+4), so
//  V^T's keys are stored in the order 0 2 4 6 1 3 5 7 within each group
//  of 8; the sum over keys does not care about their order.
//  The template parameter DT (32, 64, 128) is the head dim of the tiles;
//  the wrapper pads q, k, v with zero columns to Dp, a multiple of 4 (a
//  tensor map's row stride must be a multiple of 16 bytes), and TMA
//  zero-fills the columns from Dp to DT.  ptxas (-v, CUDA 12.9) gives every
//  instance 168 registers at entry and no spills; without the register
//  handoff the D = 128 instance spills and 128-key tiles do not fit.
//
// Precision: one, TF32 products with f32 accumulation.  The tensor core
// reads the top 19 bits of each f32 operand in shared memory.  q is
// rounded to nearest, ties away from zero (cvt.rna), in shared memory
// once per block; v is rounded the same way by the transpose pass; p is
// rounded so in registers; k is truncated (its low 13 bits are dropped by
// the tensor core as it reads them; rounding it would cost a pass over
// every tile).  tf32_operand() in kernels/attention.py mirrors each
// choice.  The softmax (max, exp, l) runs in f32 on the unrounded logits;
// exp is ex2.approx.  Unit roundoff 2^-11 (rounded), 2^-10 (truncated).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = kNegInf * 0.5f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;                    // query rows per block
constexpr int kConsumerWarps = 8;           // two warpgroups of 64 rows
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + a producer WG
// registers per thread after setmaxnreg: the producer warpgroup gives
// (168 - 40) x 128 to the consumers, (232 - 168) x 256
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kAtom = 32;                   // f32 per 128-byte swizzle row
constexpr int kAtomBytes = 128;
constexpr int kMaxD = 128;

template <int DT>  // head dim of the tiles: 32, 64 or 128
struct Tile {
  static constexpr int kAtoms = DT / kAtom;
  // keys per tile: 128 where the registers allow (S and P take BK / 2
  // each per thread, O takes DT / 2), which doubles the independent work
  // between two waits of a warpgroup
  static constexpr int kBK = DT == 128 ? 64 : 128;
  static constexpr int kStages = DT == 32 ? 4 : 2;
  static constexpr uint32_t kQBytes = kBQ * DT * 4;
  static constexpr uint32_t kKBytes = kBK * DT * 4;
  static constexpr uint32_t kVBytes = DT * kBK * 4;
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  // barriers in the first 1024 bytes, then Q and the stages, each swizzle
  // region 1024-byte aligned; 1024 more to align the dynamic base
  static constexpr size_t kSmem =
      1024 + kQBytes + size_t(kStages) * kStageBytes + 1024;
};

// -- PTX helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// waits for the phase of `parity` to complete.  A wait of seconds means a
// broken pipeline: it traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (int polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0) start = clock64();
    else if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Named barriers 3 and 4 take turns between the two consumer warpgroups:
// warpgroup wg issues its products after bar.sync(3 + wg) and lets the
// other one issue with bar.arrive(4 - wg), so one warpgroup's softmax runs
// while the other's products are on the tensor cores.
constexpr int kTurnBar = 3;

__device__ __forceinline__ void my_turn(int wg) {
  named_bar_sync(kTurnBar + wg, 256);
}

__device__ __forceinline__ void your_turn(int wg) {
  named_bar_arrive(kTurnBar + 1 - wg, 256);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// wgmma matrix descriptor of a K-major tile with the 128-byte swizzle:
// start address, leading offset 1 (unused for swizzled K-major), 1024
// bytes between groups of 8 rows, layout type 1 (128B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma (reads after wgmma_wait depend on this)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 64) = A (64 x 8) . B (64 x 8)^T (+ D if scale_d), A and B from
// shared memory (K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128) = A (64 x 8) . B (128 x 8)^T (+ D if scale_d), A and B from
// shared memory (K-major, 128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32) += A (64 x 8, registers) . B (32 x 8)^T, B from shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64) += A (64 x 8, registers) . B (64 x 8)^T, B from shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 8, registers) . B (128 x 8)^T, B from shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int DT>
__device__ __forceinline__ void wgmma_pv(float (&o)[DT / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DT == 32)
    wgmma_rs_n32(o, a, db);
  else if constexpr (DT == 64)
    wgmma_rs_n64(o, a, db);
  else
    wgmma_rs_n128(o, a, db);
}

// key stored at position c of each group of 8 in V^T (see the note above)
__host__ __device__ constexpr int key_at(int c) {
  return c < 4 ? 2 * c : 2 * c - 7;
}

// V (BH, Tk, Dp) -> V^T (BH, Dp, Tk8), TF32-rounded, keys permuted within
// each group of 8, zero for keys >= Tk.  32 x 32 tiles through shared
// memory; 32 x 8 threads.
__global__ void __launch_bounds__(256)
transpose_v_kernel(const float* __restrict__ v, float* __restrict__ vt,
                   long long BH, int Tk, int Tk8, int Dp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int key = (tx & ~7) | key_at(tx & 7);
  for (long long bh = blockIdx.z; bh < BH; bh += gridDim.z) {
    const float* vb = v + bh * Tk * Dp;
    float* vtb = vt + bh * Dp * Tk8;
    for (int r = ty; r < 32; r += 8) {
      const int kk = k0 + r, d = d0 + tx;
      tile[r][tx] = (kk < Tk && d < Dp) ? vb[(long long)kk * Dp + d] : 0.f;
    }
    __syncthreads();
    for (int r = ty; r < 32; r += 8) {
      const int d = d0 + r, pos = k0 + tx;
      if (d < Dp && pos < Tk8)
        vtb[(long long)d * Tk8 + pos] = __uint_as_float(tf32_rna(tile[key][r]));
    }
    __syncthreads();
  }
}

// mask and online softmax of one S tile in registers (sc, accumulator
// layout), for the thread's two rows: turns sc into p, updates m and this
// thread's share of l, and returns each row's corr in corr[]
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             int r_wg, int t, int kvalid,
                                             bool causal, long long delta) {
  // keys past Tk, and (causal) keys after the row's query: row r and key
  // column c are kept iff r + delta >= c
  if (kvalid < BK || (causal && delta < BK - 1)) {
    const int dl = static_cast<int>(max(min(delta, 128LL), -128LL));
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = 8 * n + 2 * t + (v & 1);
        const int r = r_wg + 8 * (v >> 1);
        if (c >= kvalid || (causal && r + dl < c)) sc[4 * n + v] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    const float m_safe = m_new <= kMaskedBelow ? 0.f : m_new;
    corr[i] = m[i] <= kMaskedBelow
                  ? 0.f
                  : (m[i] == m_safe ? 1.f
                                    : fast_exp2((m[i] - m_safe) * kLog2e));
    ms[i] = m_safe * kLog2e;
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int v = 0; v < BK / 2; ++v) {
    const int i = (v >> 1) & 1;
    const float x = sc[v];
    const float p =
        x <= kMaskedBelow ? 0.f : fast_exp2(fmaf(x, kLog2e, -ms[i]));
    sc[v] = p;
    l[i] += p;
  }
}

// issues S = Q . K^T (64 x BK) over DT / 8 steps of 8 as one commit
// group; q: the warpgroup's 64 rows of Q, k: a K stage (both swizzled)
template <int DT, int BK = Tile<DT>::kBK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q,
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < DT / 8; ++kk) {
    const uint64_t da =
        sw128_desc(q + (kk / 4) * kBQ * kAtomBytes + (kk % 4) * 32);
    const uint64_t db =
        sw128_desc(k + (kk / 4) * BK * kAtomBytes + (kk % 4) * 32);
    if constexpr (BK == 64)
      wgmma_ss_n64(sc, da, db, kk > 0);
    else
      wgmma_ss_n128(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// issues O += P . V over BK / 8 steps of 8 keys as one commit group; pa:
// P in TF32 registers, vt: a V^T stage (DT rows of BK keys, swizzled)
template <int DT, int BK = Tile<DT>::kBK>
__device__ __forceinline__ void issue_pv(float (&o)[DT / 2],
                                         const uint32_t (&pa)[BK / 2],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    wgmma_pv<DT>(o, a,
                 sw128_desc(vt + (kk / 4) * DT * kAtomBytes + (kk % 4) * 32));
  }
  wgmma_commit();
}

// p of sc in TF32 in the key order of V^T (key_at): the accumulator holds
// columns (2t, 2t + 1) of each group of 8 where the A fragment wants
// (t, t + 4); then O rescaled by corr
template <int DT, int BK = Tile<DT>::kBK>
__device__ __forceinline__ void take_p(uint32_t (&pa)[BK / 2],
                                       float (&o)[DT / 2],
                                       const float (&sc)[BK / 2],
                                       const float (&corr)[2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    pa[4 * kk] = tf32_rna(sc[4 * kk]);
    pa[4 * kk + 1] = tf32_rna(sc[4 * kk + 2]);
    pa[4 * kk + 2] = tf32_rna(sc[4 * kk + 1]);
    pa[4 * kk + 3] = tf32_rna(sc[4 * kk + 3]);
  }
#pragma unroll
  for (int v = 0; v < DT / 2; ++v) o[v] *= corr[(v >> 1) & 1];
}

// one arrival per consumer warp on an "empty" barrier
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ acc_in,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  float* __restrict__ acc_out, int q_tiles, int Tq, int Tk,
                  int D, long long q_off, long long k_off, int causal) {
  using T = Tile<DT>;
  constexpr int S = T::kStages;
  constexpr int BK = T::kBK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  // mbarriers: Q, then per stage "full" and "empty" for its K tile and for
  // its V^T tile (released separately: K after S = Q . K^T, V^T after
  // O += P . V)
  const uint32_t q_bar = base;
  const uint32_t full_k = base + 8, empty_k = full_k + 8 * S;
  const uint32_t full_v = empty_k + 8 * S, empty_v = full_v + 8 * S;
  const uint32_t sQ = base + 1024;
  const uint32_t sStages = sQ + T::kQBytes;

  const int bh = blockIdx.x / q_tiles;
  // the last query tiles see the most keys under a causal mask: they go
  // first
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * kBQ;
  const int k_tiles = (Tk + BK - 1) / BK;
  // with a causal mask, tiles wholly after the block's last query are
  // never loaded
  int n_tiles = k_tiles;
  if (causal) {
    const long long q_last = q_off + min(q0 + kBQ, Tq) - 1;
    n_tiles = q_last < k_off
                  ? 0
                  : static_cast<int>(min(static_cast<long long>(k_tiles),
                                         (q_last - k_off) / BK + 1));
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    // -- producer warpgroup: one thread issues every TMA load ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 32 * kConsumerWarps) {
      mbar_expect_tx(q_bar, T::kQBytes);
#pragma unroll
      for (int b = 0; b < T::kAtoms; ++b)
        tma_load_3d(sQ + b * kBQ * kAtomBytes, &qmap, q_bar, b * kAtom, q0,
                    bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        const uint32_t parity = ((j / S) & 1) ^ 1;
        const uint32_t st = sStages + s * T::kStageBytes;
        mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, T::kKBytes);
#pragma unroll
        for (int b = 0; b < T::kAtoms; ++b)
          tma_load_3d(st + b * BK * kAtomBytes, &kmap, full_k + 8 * s,
                      b * kAtom, j * BK, bh);
        mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, T::kVBytes);
#pragma unroll
        for (int h = 0; h < BK / kAtom; ++h)
          tma_load_3d(st + T::kKBytes + h * DT * kAtomBytes, &vmap,
                      full_v + 8 * s, j * BK + h * kAtom, 0, bh);
      }
    }
    return;
  }

  // -- consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64) -------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // accumulator layout (S and O alike): register 4n + 2i + jj holds row
  // 16 warp + g + 8 i of the warpgroup's 64, column 8n + 2t + jj
  const int r_wg = 16 * warp + g;

  // Q arrives once; each warpgroup rounds its own 64 rows to TF32 in
  // place, then makes the generic writes visible to wgmma
  mbar_wait(q_bar, 0);
#pragma unroll
  for (int b = 0; b < T::kAtoms; ++b) {
    float4* p = reinterpret_cast<float4*>(
        gbase + 1024 + b * kBQ * kAtomBytes + wg * 64 * kAtomBytes);
    for (int e = threadIdx.x & 127; e < 64 * kAtomBytes / 16; e += 128) {
      float4 x = p[e];
      x.x = __uint_as_float(tf32_rna(x.x));
      x.y = __uint_as_float(tf32_rna(x.y));
      x.z = __uint_as_float(tf32_rna(x.z));
      x.w = __uint_as_float(tf32_rna(x.w));
      p[e] = x;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_bar_sync(1 + wg, 128);

  // the carry; l[] is this thread's share of the row sum (the quad's
  // shares add up to l), so it needs no shuffles until the end
  float m[2], l[2], o[DT / 2];
  bool ok[2];
  long long grow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 64 * wg + r_wg + 8 * i;
    ok[i] = r < Tq;
    grow[i] = static_cast<long long>(bh) * Tq + r;
    m[i] = ok[i] ? m_in[grow[i]] : kNegInf;
    l[i] = ok[i] && t == 0 ? l_in[grow[i]] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < DT / 8; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = v >> 1, col = 8 * n + 2 * t + (v & 1);
      o[4 * n + v] = (ok[i] && col < D) ? acc_in[grow[i] * D + col] : 0.f;
    }

  const long long qpos0 = q_off + q0 + 64 * wg;  // position of row 0
  const uint32_t sQw = sQ + wg * 64 * kAtomBytes;  // this warpgroup's Q
  float sc[BK / 2] = {};  // S of the tile ahead, then its p
  uint32_t pa[BK / 2];    // p of the current tile in TF32: the A operand
  float corr[2];

  if (wg == 1) your_turn(wg);  // warpgroup 0 issues first
  if (n_tiles > 0) {
    mbar_wait(full_k, 0);
    my_turn(wg);
    wgmma_fence();
    issue_s<DT>(sc, sQw, sStages);
    your_turn(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    release(empty_k, lane);
    softmax_tile<BK>(sc, m, l, corr, r_wg, t, Tk, causal, qpos0 - k_off);
    take_p<DT>(pa, o, sc, corr);
  }
  // tile j's O += P . V runs under tile j + 1's S product and softmax
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int s = j % S, s1 = (j + 1) % S;
    mbar_wait(full_k + 8 * s1, ((j + 1) / S) & 1);
    mbar_wait(full_v + 8 * s, (j / S) & 1);
    my_turn(wg);
    wgmma_fence();
    issue_s<DT>(sc, sQw, sStages + s1 * T::kStageBytes);
    issue_pv<DT>(o, pa, sStages + s * T::kStageBytes + T::kKBytes);
    your_turn(wg);
    wgmma_wait<1>();
    fence_regs(sc);
    release(empty_k + 8 * s1, lane);
    const int k0 = (j + 1) * BK;
    softmax_tile<BK>(sc, m, l, corr, r_wg, t, Tk - k0, causal,
                     qpos0 - (k_off + k0));
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(empty_v + 8 * s, lane);
    take_p<DT>(pa, o, sc, corr);
  }
  if (n_tiles > 0) {
    const int j = n_tiles - 1, s = j % S;
    mbar_wait(full_v + 8 * s, (j / S) & 1);
    my_turn(wg);
    wgmma_fence();
    issue_pv<DT>(o, pa, sStages + s * T::kStageBytes + T::kKBytes);
    your_turn(wg);
    wgmma_wait<0>();
    fence_regs(o);
    release(empty_v + 8 * s, lane);
  }
  // both warpgroups took n_tiles + 1 turns; the first arrive for
  // warpgroup 0 is still open
  if (wg == 0) my_turn(wg);

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  if (n_tiles < k_tiles) {
    // the skipped tiles: every logit masked, so p = 0, m_new = max(m,
    // NEG_INF), corr = 1 where m is set and 0 where it is not
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (m[i] <= kMaskedBelow) {
        l[i] = 0.f;
#pragma unroll
        for (int n = 0; n < DT / 8; ++n) {
          o[4 * n + 2 * i] = 0.f;
          o[4 * n + 2 * i + 1] = 0.f;
        }
      }
      m[i] = fmaxf(m[i], kNegInf);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
    if (t == 0) {
      m_out[grow[i]] = m[i];
      l_out[grow[i]] = l[i];
    }
#pragma unroll
    for (int n = 0; n < DT / 8; ++n)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * n + 2 * t + jj;
        if (col < D) acc_out[grow[i] * D + col] = o[4 * n + 2 * i + jj];
      }
  }
}

// -- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the libcuda that PyTorch has
// loaded (so the library needs no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// a contiguous f32 tensor (n2, n1, n0), n0 innermost, read in boxes of
// (32, rows, 1) with the 128-byte swizzle; elements out of range read as 0
CUresult encode_3d(CUtensorMap* map, const float* ptr, long long n0,
                   long long n1, long long n2, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n0) * 4,
                                 static_cast<cuuint64_t>(n0 * n1) * 4};
  const cuuint32_t box[3] = {kAtom, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 0, a CUDA runtime error (> 0), or minus the encoder's CUresult (< 0)
template <int DT>
int launch(const float* q, const float* k, const float* vt, const float* m_in,
           const float* l_in, const float* acc_in, float* m_out, float* l_out,
           float* acc_out, long long BH, int Tq, int Tk, int Tk8, int D,
           int Dp, long long q_off, long long k_off, int causal,
           cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  CUresult r = encode_3d(&qmap, q, Dp, Tq, BH, kBQ);
  if (r == CUDA_SUCCESS) r = encode_3d(&kmap, k, Dp, Tk, BH, Tile<DT>::kBK);
  if (r == CUDA_SUCCESS) r = encode_3d(&vmap, vt, Tk8, Dp, BH, DT);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  // the limit is per device, so it is raised on every launch (a cheap
  // call) rather than once per process
  const size_t bytes = Tile<DT>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const int q_tiles = (Tq + kBQ - 1) / kBQ;
  const long long blocks = BH * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_tf32_kernel<DT><<<static_cast<unsigned>(blocks), kThreads, bytes,
                          stream>>>(qmap, kmap, vmap, m_in, l_in, acc_in,
                                    m_out, l_out, acc_out, q_tiles, Tq, Tk, D,
                                    q_off, k_off, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: contiguous f32 (BH, T, Dp), 16-byte aligned, Dp a multiple of 4
// with zero columns from D; vt: scratch f32 (BH, Dp, Tk8), Tk8 = Tk
// rounded up to a multiple of 8; m, l (BH, Tq) and acc (BH, Tq, D)
// contiguous f32.  All on the current device, launched on `stream`.
// Returns 0, a CUDA error of a launch (> 0), or minus the CUresult of
// a tensor-map encoding (< 0); the wrapper raises on anything but 0.
int flash_block_update_f32(const float* q, const float* k, const float* v,
                           float* vt, const float* m_in, const float* l_in,
                           const float* acc_in, float* m_out, float* l_out,
                           float* acc_out, long long BH, long long Tq,
                           long long Tk, int D, int Dp, long long q_off,
                           long long k_off, int causal, void* stream) {
  if (D < 1 || D > kMaxD || Dp < D || Dp > kMaxD || Dp % 4 || Tk < 1 ||
      Tq > 0x7fffff00LL || Tk > 0x7fffff00LL || BH > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(vt)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (BH == 0 || Tq == 0) return 0;
  if (!encode_tiled()) return static_cast<int>(cudaErrorSymbolNotFound);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tq = static_cast<int>(Tq), tk = static_cast<int>(Tk);
  const int tk8 = (tk + 7) / 8 * 8;
  const dim3 tgrid((tk8 + 31) / 32, (Dp + 31) / 32,
                   static_cast<unsigned>(BH < 65535 ? BH : 65535));
  transpose_v_kernel<<<tgrid, dim3(32, 8), 0, s>>>(v, vt, BH, tk, tk8, Dp);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (Dp <= 32)
    return launch<32>(q, k, vt, m_in, l_in, acc_in, m_out, l_out, acc_out,
                      BH, tq, tk, tk8, D, Dp, q_off, k_off, causal, s);
  if (Dp <= 64)
    return launch<64>(q, k, vt, m_in, l_in, acc_in, m_out, l_out, acc_out,
                      BH, tq, tk, tk8, D, Dp, q_off, k_off, causal, s);
  return launch<128>(q, k, vt, m_in, l_in, acc_in, m_out, l_out, acc_out, BH,
                     tq, tk, tk8, D, Dp, q_off, k_off, causal, s);
}

}  // extern "C"
