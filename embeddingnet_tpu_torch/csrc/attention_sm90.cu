// The attention core of a ViT block, forward and backward, for Hopper
// (sm_90a): y = softmax(q k^T / sqrt(d)) v per (batch, head), with q, k, v
// and y in the projections' layout [B, N, h*d] (Flax's at the public
// function), each head addressed in place by a 3-D tensor map.
//
// Replaces no TPU kernel: the JAX package runs Flax's
// MultiHeadDotProductAttention, which XLA fuses; there is no pallas_call.
// It was added because the port's eager core (the heads split and made
// contiguous, q scaled, two batched products on align-1 GEMMs at 197
// tokens, a softmax pass, the merge) took 1.70 ms a call at B=256, N=197,
// h=12, d=64 against a bound of 92.5 us, and its backward as much again.
//
// What bounds it on an H100: bytes. At that shape a call moves q, k, v and
// y once, 310 MB (92.5 us at 3.35 TB/s), for 4*B*h*N^2*d = 30.5 GFLOP
// (31 us at the dense bf16 peak); the backward reads q, k, v, y, dy and
// the logsumexp and writes dq, dk, dv, 620 MB, for 2.5 times the
// forward's operations. The design keeps every N x N tensor on the chip:
//   - a tile is 64 rows (one wgmma M) by the head dimension, loaded by TMA
//     as one or two boxes of 64 columns (128-byte rows, 128-byte swizzle)
//     from a 3-D map (columns, tokens, batch): a box starts at column
//     head*d, so no head is ever copied out, and rows past N are zeros
//     from the map's bounds. Columns past d (the next head's, or zeros)
//     land in the box but no product reads them into a kept result: the
//     score products stop at d, and the value products' extra columns are
//     never stored;
//   - forward: a block of two consumer warpgroups owns 128 query rows of
//     one (batch, head); each warpgroup 64. Keys and values stream in
//     chunks of 64 through a ring of four stages (at N <= 256 all of them
//     at once). Per chunk: S = q k^T by wgmma from shared memory (f32 in
//     registers), the online softmax in f32 (row max and sum by quad
//     shuffles, exp2 with the scale folded in), P rounded to bf16 in the
//     registers that wgmma reads as its A operand, O += P v. The row
//     logsumexp (f32, [B, h, N]) is stored for the backward;
//   - backward, FlashAttention-2's algebra without atomics: block (role,
//     tile, batch*head). Role 0 owns a 64-key tile and walks the query
//     chunks: S^T = k q^T and dP^T = v dO^T, P^T rebuilt from the
//     logsumexp, dS^T = P^T (dP^T - D) with D = rowsum(dO o O) taken from
//     the chunk in shared memory, dV += P^T dO and dK += dS^T q. Role 1
//     owns a 64-query tile and walks the key chunks: S, dP, dS as above,
//     dQ += dS k. Every gradient element is summed by one block in one
//     order, so a rerun (a remat recompute, a second launch) gives the same
//     bits. One launch holds both roles.
// Scores are scaled in f32 (scale = 1/sqrt(d)), never rounded to bf16
// before the softmax. bf16 or fp16 inputs; d a multiple of 16 up to 128;
// any N >= 1, B and h.
//
// float32 and float64 inputs (the precisions the card-vs-CPU checks run a
// model in) take instances of the same arithmetic without tensor cores:
// a warp per row, every sum in the input's precision, the logsumexp kept
// in it too; d from 1 to 128.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;            // rows of a tile: one wgmma M, a chunk
constexpr int kBox = kRows * 128;    // one 64-row box of 64 columns (8 KB)
constexpr int kFwdGroups = 2;        // consumer warpgroups of a forward block
constexpr int kFwdStages = 4;        // key/value chunks a forward block holds
constexpr int kBwdStages = 2;        // streamed chunks a backward block holds
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A 64-row tile of `boxes` boxes; the dynamic shared memory of each kernel,
// with room to align it to 1024 bytes. The forward holds its warpgroups'
// query tiles and the ring of key and value chunks; the backward the larger
// role: k and v tiles and two stages of (q, dO, O) chunks (role 1 holds q,
// dO, O and two stages of (k, v): 7 tiles).
__host__ __device__ constexpr int tile_bytes(int boxes) {
  return boxes * kBox;
}
__host__ __device__ constexpr int fwd_smem(int boxes) {
  return (kFwdGroups + 2 * kFwdStages) * tile_bytes(boxes) + 1024;
}
__host__ __device__ constexpr int bwd_smem(int boxes) {
  return (2 + 3 * kBwdStages) * tile_bytes(boxes) + 1024;
}

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase differs from `parity`. A wait that lasts
// seconds (a fault) traps, so that the launch fails instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t polls = 1; !done; ++polls) {
    if ((polls & 0xFFFF) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) {
        start = now;
      } else if (now - start > 4000000000ull) {
        __trap();
      }
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes into a 1024-byte aligned
// buffer). K-major: `lbo` unused, `sbo` the 1024 bytes between groups of
// eight 128-byte rows. N-major: `lbo` the bytes between 64-wide N blocks,
// `sbo` the bytes between groups of eight K rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

__device__ __forceinline__ void ld_shared_v4(uint32_t addr, uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

// Pins an accumulator's registers at this point of the program, so that no
// arithmetic on them moves into a wgmma batch (ptxas would serialise the
// batch's products).
template <int kN>
__device__ __forceinline__ void fence_operand(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x; 2^-inf = +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[64x64] (+)= A[64x16] B[16x64], bf16; A and B from shared memory,
// both K-major; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_bf16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] B[16x64], bf16; A from registers (the accumulator
// layout of a 64x16 slice, rounded and paired), B from shared memory,
// N-major.
__device__ __forceinline__ void wgmma_rs_n64_bf16(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x128] += A[64x16] B[16x128], bf16; A from registers (the accumulator
// layout of a 64x16 slice, rounded and paired), B from shared memory,
// N-major.
__device__ __forceinline__ void wgmma_rs_n128_bf16(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x64] (+)= A[64x16] B[16x64], f16; A and B from shared memory,
// both K-major; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_f16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] B[16x64], f16; A from registers (the accumulator
// layout of a 64x16 slice, rounded and paired), B from shared memory,
// N-major.
__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x128] += A[64x16] B[16x128], f16; A from registers (the accumulator
// layout of a 64x16 slice, rounded and paired), B from shared memory,
// N-major.
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---------------------------------------------------------------------------
// Element types, products and tiles.
// ---------------------------------------------------------------------------

template <bool kHalf>
struct Elem;

template <>
struct Elem<false> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  }
};

template <>
struct Elem<true> {
  using T = __half;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<__half2*>(&w));
  }
};

template <bool kHalf>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (kHalf) {
    wgmma_ss_n64_f16(d, da, db, accumulate);
  } else {
    wgmma_ss_n64_bf16(d, da, db, accumulate);
  }
}

template <bool kHalf, int kDB>
__device__ __forceinline__ void mma_rs(float (&d)[32 * kDB],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kDB == 1) {
    if constexpr (kHalf) {
      wgmma_rs_n64_f16(d, a, db);
    } else {
      wgmma_rs_n64_bf16(d, a, db);
    }
  } else {
    if constexpr (kHalf) {
      wgmma_rs_n128_f16(d, a, db);
    } else {
      wgmma_rs_n128_bf16(d, a, db);
    }
  }
}

// K-major operand, k-step kk (16 columns) of a tile of 64-column boxes; a
// 16-wide step is 32 bytes into the 128-byte row.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kBox + 32 * (kk % 4), 16, 1024);
}
// N-major B operand, k-step kk (16 rows, 2 KB) of a tile; its 64-column
// boxes kBox apart.
__device__ __forceinline__ uint64_t n_major(uint32_t tile, int kk) {
  return smem_desc(tile + 2048 * kk, kBox, 1024);
}

// d[64 x 64] = A B^T over kSteps * 16 columns: A the rows of tile `a`, B the
// rows of tile `b`, both K-major.
template <bool kHalf, int kSteps>
__device__ __forceinline__ void scores_over(float (&d)[32], uint32_t a,
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    mma_ss<kHalf>(d, k_major(a, kk), k_major(b, kk), kk);
}

// The same over the head dimension, `ksteps` = d / 16 of the 4 * kDB steps
// the boxes hold: each count a straight run of products, with no branch
// between them (ptxas would serialise a batch that has one).
template <bool kHalf, int kDB>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a, uint32_t b,
                                       int ksteps) {
  switch (ksteps - 4 * (kDB - 1)) {
    case 1: scores_over<kHalf, 4 * kDB - 3>(d, a, b); break;
    case 2: scores_over<kHalf, 4 * kDB - 2>(d, a, b); break;
    case 3: scores_over<kHalf, 4 * kDB - 1>(d, a, b); break;
    default: scores_over<kHalf, 4 * kDB>(d, a, b); break;
  }
}

// d[64 x 64*kDB] += A B over 64 rows of B: A the packed fragments of a
// 64 x 64 accumulator, B tile `b` N-major.
template <bool kHalf, int kDB>
__device__ __forceinline__ void products(float (&d)[32 * kDB],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<kHalf, kDB>(d, a[kk], n_major(b, kk));
}

// The A fragments of four 16-wide k-steps from a 64 x 64 f32 accumulator:
// a thread's accumulator entry 4j + 2h + e is row 16*warp + lane/4 + 8h,
// column 8j + 2*(lane%4) + e, and k-step kk's fragment takes columns
// 16kk .. 16kk + 15 in wgmma's (mma.sync's) A order: (row, k), (row + 8,
// k), (row, k + 8), (row + 8, k + 8), each a rounded pair.
template <bool kHalf>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = Elem<kHalf>::pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// Issues the TMA loads of the 64-row tile at `row` of (batch, columns
// col0 ..) into `dst`.
template <int kDB>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int col0, int row,
                                          int batch) {
#pragma unroll
  for (int j = 0; j < kDB; ++j)
    tma_load_3d(dst + j * kBox, map, bar, col0 + 64 * j, row, batch);
}

// Stores the warpgroup's 64-row accumulator, rows h scaled by mul[h], into
// dst at rows row0 .. (those below n) and columns col0 .. col0 + head_dim
// of a contiguous [batch, n, cols] tensor whose batch starts at `base`.
template <bool kHalf, int kDB>
__device__ __forceinline__ void store_rows(typename Elem<kHalf>::T* dst,
                                           const float (&acc)[32 * kDB],
                                           const float (&mul)[2], size_t base,
                                           int row0, int n, int cols,
                                           int head_dim) {
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * h;
    if (r >= n) continue;
    typename Elem<kHalf>::T* p = dst + base + static_cast<size_t>(r) * cols;
#pragma unroll
    for (int j = 0; j < 8 * kDB; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      if (c < head_dim) {
        *reinterpret_cast<uint32_t*>(p + c) = Elem<kHalf>::pack(
            acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward. Block x: query tile x % q_tiles (128 rows) of (batch, head)
// x / q_tiles; 256 threads, warpgroup g the rows 64g .. of the tile.
// ---------------------------------------------------------------------------

template <bool kHalf, int kDB>
__global__ void __launch_bounds__(128 * kFwdGroups, kDB == 1 ? 2 : 1)
attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          typename Elem<kHalf>::T* __restrict__ out,
                          float* __restrict__ lse, int n, int heads,
                          int head_dim, int q_tiles, float scale_log2) {
  constexpr int kTile = tile_bytes(kDB);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kFwdStages + 1];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_smem = q_smem + kFwdGroups * kTile;
  const uint32_t q_bar = smem_u32(&bars[kFwdStages]);
  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / heads;
  const int col0 = (bh - b * heads) * head_dim;
  const int cols = heads * head_dim;
  const int q0 = tile * kRows * kFwdGroups;
  const int chunks = (n + kRows - 1) / kRows;

  // Chunk c of k and v into stage c % kFwdStages.
  auto load_kv = [&](int c) {
    const int s = c % kFwdStages;
    const uint32_t bar = smem_u32(&bars[s]);
    const uint32_t dst = kv_smem + s * 2 * kTile;
    mbar_expect_tx(bar, 2 * kTile);
    load_tile<kDB>(dst, &k_map, bar, col0, c * kRows, b);
    load_tile<kDB>(dst + kTile, &v_map, bar, col0, c * kRows, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kFwdStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, kFwdGroups * kTile);
    for (int g = 0; g < kFwdGroups; ++g)
      load_tile<kDB>(q_smem + g * kTile, &q_map, q_bar, col0, q0 + g * kRows,
                     b);
    for (int c = 0; c < chunks && c < kFwdStages; ++c) load_kv(c);
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t my_q = q_smem + wg * kTile;
  const int ksteps = head_dim / 16;
  float o[32 * kDB];
#pragma unroll
  for (int i = 0; i < 32 * kDB; ++i) o[i] = 0.0f;
  // Per row h (16*warp + lane/4 + 8h): the running max of the scores times
  // scale * log2(e), and this thread's share of the running sum.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  mbar_wait(q_bar, 0);
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kFwdStages;
    const uint32_t k_tile = kv_smem + s * 2 * kTile;
    mbar_wait(smem_u32(&bars[s]), (c / kFwdStages) & 1);
    float sc[32];
    wgmma_fence();
    scores<kHalf, kDB>(sc, my_q, k_tile, ksteps);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(o);
    // Both warpgroups are past chunk c - 1's products: its stage is free.
    __syncthreads();
    if (threadIdx.x == 0 && c > 0 && c - 1 + kFwdStages < chunks)
      load_kv(c - 1 + kFwdStages);
    const int key = c * kRows + 2 * (lane % 4);
    if (c * kRows + kRows > n) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key + 8 * j + e >= n) {
            sc[4 * j + e] = -INFINITY;
            sc[4 * j + 2 + e] = -INFINITY;
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every chunk holds a key below n, so the row's max is finite
      const float m_new = fmaxf(m[h], mx * scale_log2);
      const float alpha = fast_exp2(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              fast_exp2(fmaf(sc[4 * j + 2 * h + e], scale_log2, -m_new));
          sc[4 * j + 2 * h + e] = p;
          sum += p;
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 8 * kDB; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }
    uint32_t p[4][4];
    pack_a<kHalf>(p, sc);
    fence_operand(o);
    wgmma_fence();
    products<kHalf, kDB>(o, p, k_tile + kTile);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operand(o);
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / l[h];
  }
  const int row0 = q0 + wg * kRows;
  store_rows<kHalf, kDB>(out, o, inv,
                         static_cast<size_t>(b) * n * cols + col0, row0, n,
                         cols, head_dim);
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * warp + lane / 4 + 8 * h;
      if (r < n)
        lse[static_cast<size_t>(bh) * n + r] = (m[h] + log2f(l[h])) * kLn2;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. Block x: role x % 2, tile (x / 2) % tiles of (batch, head)
// x / (2 * tiles); 128 threads, one warpgroup.
// ---------------------------------------------------------------------------

template <bool kHalf, int kDB>
__global__ void __launch_bounds__(128, kDB == 1 ? 2 : 1)
attention_bwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          typename Elem<kHalf>::T* __restrict__ dq,
                          typename Elem<kHalf>::T* __restrict__ dk,
                          typename Elem<kHalf>::T* __restrict__ dv, int n,
                          int heads, int head_dim, int tiles, float scale,
                          float scale_log2) {
  constexpr int kTile = tile_bytes(kDB);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kBwdStages + 1];
  // per stage: the chunk's 64 rows' logsumexp (times log2(e)) and D
  __shared__ float row_lse[kBwdStages][kRows];
  __shared__ float row_d[kBwdStages][kRows];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int role = blockIdx.x % 2;
  const int tile = (blockIdx.x / 2) % tiles;
  const int bh = blockIdx.x / (2 * tiles);
  const int b = bh / heads;
  const int col0 = (bh - b * heads) * head_dim;
  const int cols = heads * head_dim;
  const int row0 = tile * kRows;
  const int chunks = tiles;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ksteps = head_dim / 16;
  const float* lse_bh = lse + static_cast<size_t>(bh) * n;
  const uint32_t fixed_bar = smem_u32(&bars[kBwdStages]);
  // Role 0 holds its k and v tiles and stages of (q, dO, O) chunks; role 1
  // its q, dO and O tiles and stages of (k, v) chunks.
  const int fixed_tiles = role == 0 ? 2 : 3;
  const int stage_tiles = role == 0 ? 3 : 2;
  const uint32_t stages = base + fixed_tiles * kTile;

  auto load_chunk = [&](int c) {
    const int s = c % kBwdStages;
    const uint32_t bar = smem_u32(&bars[s]);
    const uint32_t dst = stages + s * stage_tiles * kTile;
    mbar_expect_tx(bar, stage_tiles * kTile);
    if (role == 0) {
      load_tile<kDB>(dst, &q_map, bar, col0, c * kRows, b);
      load_tile<kDB>(dst + kTile, &do_map, bar, col0, c * kRows, b);
      load_tile<kDB>(dst + 2 * kTile, &o_map, bar, col0, c * kRows, b);
    } else {
      load_tile<kDB>(dst, &k_map, bar, col0, c * kRows, b);
      load_tile<kDB>(dst + kTile, &v_map, bar, col0, c * kRows, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kBwdStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(fixed_bar, fixed_tiles * kTile);
    if (role == 0) {
      load_tile<kDB>(base, &k_map, fixed_bar, col0, row0, b);
      load_tile<kDB>(base + kTile, &v_map, fixed_bar, col0, row0, b);
    } else {
      load_tile<kDB>(base, &q_map, fixed_bar, col0, row0, b);
      load_tile<kDB>(base + kTile, &do_map, fixed_bar, col0, row0, b);
      load_tile<kDB>(base + 2 * kTile, &o_map, fixed_bar, col0, row0, b);
    }
    for (int c = 0; c < chunks && c < kBwdStages; ++c) load_chunk(c);
  }

  // D = rowsum(dO o O) and the logsumexp (times log2(e); +inf past n, so
  // that P is 0 there) of the 64 rows of tiles do_t and o_t, the rows
  // first .. of the sequence, into d_out and lse_out: thread tid sums half
  // of row tid / 2 (the 16-byte chunk j of row r sits at j ^ (r % 8)) in a
  // fixed order, and a shuffle adds the halves.
  auto row_dots = [&](uint32_t do_t, uint32_t o_t, float* d_out,
                      float* lse_out, int first) {
    const int r = tid / 2;
    const int half = tid % 2;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kDB; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = 4 * half + u;
        if (64 * j + 8 * cc >= head_dim) continue;
        const uint32_t off = j * kBox + r * 128 + ((cc ^ (r & 7)) << 4);
        uint32_t x[4], y[4];
        ld_shared_v4(do_t + off, x);
        ld_shared_v4(o_t + off, y);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 g = Elem<kHalf>::unpack(x[i]);
          const float2 f = Elem<kHalf>::unpack(y[i]);
          sum = fmaf(g.x, f.x, sum);
          sum = fmaf(g.y, f.y, sum);
        }
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      d_out[r] = sum;
      lse_out[r] = first + r < n ? lse_bh[first + r] * kLog2e : INFINITY;
    }
  };

  mbar_wait(fixed_bar, 0);
  if (role == 0) {
    // dK and dV of keys row0 .. row0 + 63: rows of the accumulators.
    float dv_acc[32 * kDB], dk_acc[32 * kDB];
#pragma unroll
    for (int i = 0; i < 32 * kDB; ++i) dv_acc[i] = dk_acc[i] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % kBwdStages;
      const uint32_t q_c = stages + s * 3 * kTile;
      const uint32_t do_c = q_c + kTile;
      mbar_wait(smem_u32(&bars[s]), (c / kBwdStages) & 1);
      row_dots(do_c, do_c + kTile, row_d[s], row_lse[s], c * kRows);
      float st[32], dpt[32];
      wgmma_fence();
      scores<kHalf, kDB>(st, base, q_c, ksteps);           // S^T = k q^T
      scores<kHalf, kDB>(dpt, base + kTile, do_c, ksteps); // dP^T = v dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(st);
      fence_operand(dpt);
      fence_operand(dv_acc);
      fence_operand(dk_acc);
      // The chunk's D and logsumexp are in shared memory, and chunk c - 1's
      // products have completed: its stage takes chunk c + 1.
      __syncthreads();
      if (tid == 0 && c > 0 && c + 1 < chunks) load_chunk(c + 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * j + 2 * (lane % 4) + e;
          const float ls = row_lse[s][q];
          const float dd = row_d[s][q];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float p = fast_exp2(fmaf(st[i], scale_log2, -ls));
            st[i] = p;
            dpt[i] = p * (dpt[i] - dd);
          }
        }
      uint32_t pa[4][4], da[4][4];
      pack_a<kHalf>(pa, st);
      pack_a<kHalf>(da, dpt);
      fence_operand(dv_acc);
      fence_operand(dk_acc);
      wgmma_fence();
      products<kHalf, kDB>(dv_acc, pa, do_c);   // dV += P^T dO
      products<kHalf, kDB>(dk_acc, da, q_c);    // dK += dS^T q
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operand(dv_acc);
    fence_operand(dk_acc);
    const size_t at = static_cast<size_t>(b) * n * cols + col0;
    const float k_mul[2] = {scale, scale};
    const float v_mul[2] = {1.0f, 1.0f};
    store_rows<kHalf, kDB>(dk, dk_acc, k_mul, at, row0, n, cols, head_dim);
    store_rows<kHalf, kDB>(dv, dv_acc, v_mul, at, row0, n, cols, head_dim);
  } else {
    // dQ of queries row0 .. row0 + 63.
    row_dots(base + kTile, base + 2 * kTile, row_d[0], row_lse[0], row0);
    __syncthreads();
    const int r = 16 * warp + lane / 4;
    const float ls[2] = {row_lse[0][r], row_lse[0][r + 8]};
    const float dd[2] = {row_d[0][r], row_d[0][r + 8]};
    float dq_acc[32 * kDB];
#pragma unroll
    for (int i = 0; i < 32 * kDB; ++i) dq_acc[i] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % kBwdStages;
      const uint32_t k_c = stages + s * 2 * kTile;
      mbar_wait(smem_u32(&bars[s]), (c / kBwdStages) & 1);
      float sc[32], dp[32];
      wgmma_fence();
      scores<kHalf, kDB>(sc, base, k_c, ksteps);             // S = q k^T
      scores<kHalf, kDB>(dp, base + kTile, k_c + kTile, ksteps);  // dO v^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      fence_operand(dq_acc);
      // chunk c - 1's product has completed: its stage takes chunk c + 1
      __syncthreads();
      if (tid == 0 && c > 0 && c + 1 < chunks) load_chunk(c + 1);
      const int key = c * kRows + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = key + 8 * j + e < n;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float p =
                valid ? fast_exp2(fmaf(sc[i], scale_log2, -ls[h])) : 0.0f;
            dp[i] = p * (dp[i] - dd[h]);
          }
        }
      uint32_t da[4][4];
      pack_a<kHalf>(da, dp);
      fence_operand(dq_acc);
      wgmma_fence();
      products<kHalf, kDB>(dq_acc, da, k_c);   // dQ += dS k
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operand(dq_acc);
    const float q_mul[2] = {scale, scale};
    store_rows<kHalf, kDB>(dq, dq_acc, q_mul,
                           static_cast<size_t>(b) * n * cols + col0, row0, n,
                           cols, head_dim);
  }
}

// ---------------------------------------------------------------------------
// float32 and float64: the forward and the backward above without tensor
// cores. A warp owns one row: a query row forward and in the backward's
// dq role, a key row in its dk, dv role. A lane holds columns lane,
// lane + 32, ... of the row's head. Every sum over the head dimension is a
// butterfly over the warp, every sum over rows runs in row order in one
// warp, so a rerun gives the same bits. The grid is 1-D: block (role,
// batch*head, tile of kSimtWarps rows).
// ---------------------------------------------------------------------------

constexpr int kSimtWarps = 8;     // rows of a block
constexpr int kSimtCols = 4;      // columns a lane holds: d <= 128

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// Each of v's sums over the warp, in every lane.
template <typename T, int kSums>
__device__ __forceinline__ void warp_sums(T (&v)[kSums]) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], offset);
    }
  }
}

// The lane's columns of a head row (zeros past d), times `mul`.
template <typename T>
__device__ __forceinline__ void load_cols(T (&x)[kSimtCols], const T* row,
                                          int lane, int head_dim,
                                          T mul = T(1)) {
#pragma unroll
  for (int c = 0; c < kSimtCols; ++c) {
    const int col = lane + 32 * c;
    x[c] = col < head_dim ? row[col] * mul : T(0);
  }
}

template <typename T>
__device__ __forceinline__ T dot_cols(const T (&a)[kSimtCols],
                                      const T (&b)[kSimtCols]) {
  T sum = T(0);
#pragma unroll
  for (int c = 0; c < kSimtCols; ++c) sum += a[c] * b[c];
  return sum;
}

template <typename T>
__device__ __forceinline__ void store_cols(T* row, const T (&x)[kSimtCols],
                                           T mul, int lane, int head_dim) {
#pragma unroll
  for (int c = 0; c < kSimtCols; ++c) {
    const int col = lane + 32 * c;
    if (col < head_dim) row[col] = x[c] * mul;
  }
}

// Forward: the online softmax over every key in order; q is scaled before
// the score, as the logsumexp it stores (null: not kept) assumes.
template <typename T>
__global__ void __launch_bounds__(32 * kSimtWarps)
    attention_fwd_simt_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              T* __restrict__ lse, int n, int heads,
                              int head_dim, int tiles, long long q_row,
                              long long q_batch, long long k_row,
                              long long k_batch, long long v_row,
                              long long v_batch, T scale) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x / tiles;
  const int row = (blockIdx.x % tiles) * kSimtWarps + threadIdx.x / 32;
  if (row >= n) return;
  const int b = bh / heads;
  const long long col0 = static_cast<long long>(bh % heads) * head_dim;
  const T* k_b = k + b * k_batch + col0;
  const T* v_b = v + b * v_batch + col0;
  T qs[kSimtCols], acc[kSimtCols] = {};
  load_cols(qs, q + b * q_batch + row * q_row + col0, lane, head_dim, scale);
  T m = -INFINITY, l = T(0);
  for (int j = 0; j < n; ++j) {
    T kj[kSimtCols], vj[kSimtCols];
    load_cols(kj, k_b + j * k_row, lane, head_dim);
    load_cols(vj, v_b + j * v_row, lane, head_dim);
    T s[1] = {dot_cols(qs, kj)};
    warp_sums(s);
    const T m_new = m > s[0] ? m : s[0];
    const T alpha = exp_of(m - m_new);
    const T p = exp_of(s[0] - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int c = 0; c < kSimtCols; ++c) acc[c] = acc[c] * alpha + p * vj[c];
    m = m_new;
  }
  const long long cols = static_cast<long long>(heads) * head_dim;
  store_cols(out + (static_cast<long long>(b) * n + row) * cols + col0, acc,
             T(1) / l, lane, head_dim);
  if (lse != nullptr && lane == 0) {
    lse[static_cast<long long>(bh) * n + row] = m + log_of(l);
  }
}

// Backward: the first half of the grid the dq role (a query row walks the
// keys: dq = scale * sum_j dS_ij k_j), the second the dk, dv role (a key
// row walks the queries: dv = sum_i P_ij dO_i, dk = scale * sum_i dS_ij
// q_i), with P_ij = exp(s_ij - lse_i), dS_ij = P_ij (dO_i v_j - D_i) and
// D_i = dO_i o_i taken where it is needed.
template <typename T>
__global__ void __launch_bounds__(32 * kSimtWarps)
    attention_bwd_simt_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ o,
        const T* __restrict__ dout, const T* __restrict__ lse,
        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int n,
        int heads, int head_dim, int tiles, long long q_row,
        long long q_batch, long long k_row, long long k_batch,
        long long v_row, long long v_batch, long long o_row,
        long long o_batch, long long do_row, long long do_batch, T scale) {
  const int lane = threadIdx.x & 31;
  const int half = gridDim.x / 2;
  const bool key_role = static_cast<int>(blockIdx.x) >= half;
  const int block = key_role ? blockIdx.x - half : blockIdx.x;
  const int bh = block / tiles;
  const int row = (block % tiles) * kSimtWarps + threadIdx.x / 32;
  if (row >= n) return;
  const int b = bh / heads;
  const long long col0 = static_cast<long long>(bh % heads) * head_dim;
  const T* q_b = q + b * q_batch + col0;
  const T* k_b = k + b * k_batch + col0;
  const T* v_b = v + b * v_batch + col0;
  const T* o_b = o + b * o_batch + col0;
  const T* do_b = dout + b * do_batch + col0;
  const T* lse_bh = lse + static_cast<long long>(bh) * n;
  const long long at = (static_cast<long long>(b) * n + row) *
                           (static_cast<long long>(heads) * head_dim) +
                       col0;
  if (!key_role) {
    T qs[kSimtCols], g[kSimtCols], oi[kSimtCols], acc[kSimtCols] = {};
    load_cols(qs, q_b + row * q_row, lane, head_dim, scale);
    load_cols(g, do_b + row * do_row, lane, head_dim);
    load_cols(oi, o_b + row * o_row, lane, head_dim);
    T d[1] = {dot_cols(g, oi)};
    warp_sums(d);
    const T ls = lse_bh[row];
    for (int j = 0; j < n; ++j) {
      T kj[kSimtCols], vj[kSimtCols];
      load_cols(kj, k_b + j * k_row, lane, head_dim);
      load_cols(vj, v_b + j * v_row, lane, head_dim);
      T s[2] = {dot_cols(qs, kj), dot_cols(g, vj)};
      warp_sums(s);
      const T ds = exp_of(s[0] - ls) * (s[1] - d[0]);
#pragma unroll
      for (int c = 0; c < kSimtCols; ++c) acc[c] += ds * kj[c];
    }
    store_cols(dq + at, acc, scale, lane, head_dim);
    return;
  }
  T kj[kSimtCols], vj[kSimtCols], acc_k[kSimtCols] = {},
                                  acc_v[kSimtCols] = {};
  load_cols(kj, k_b + row * k_row, lane, head_dim);
  load_cols(vj, v_b + row * v_row, lane, head_dim);
  for (int i = 0; i < n; ++i) {
    T qi[kSimtCols], qs[kSimtCols], g[kSimtCols], oi[kSimtCols];
    load_cols(qi, q_b + i * q_row, lane, head_dim);
    load_cols(g, do_b + i * do_row, lane, head_dim);
    load_cols(oi, o_b + i * o_row, lane, head_dim);
#pragma unroll
    for (int c = 0; c < kSimtCols; ++c) qs[c] = qi[c] * scale;
    T s[3] = {dot_cols(qs, kj), dot_cols(g, vj), dot_cols(g, oi)};
    warp_sums(s);
    const T p = exp_of(s[0] - lse_bh[i]);
    const T ds = p * (s[1] - s[2]);
#pragma unroll
    for (int c = 0; c < kSimtCols; ++c) {
      acc_v[c] += p * g[c];
      acc_k[c] += ds * qi[c];
    }
  }
  store_cols(dk + at, acc_k, scale, lane, head_dim);
  store_cols(dv + at, acc_v, T(1), lane, head_dim);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// 3-D map over a [batch, n, cols] tensor of 16-bit elements with unit
// column stride and the given row and batch strides (elements): boxes of 64
// columns by 64 rows of one batch, 128-byte swizzle, zeros outside.
bool encode_rows(CUtensorMap* map, const void* base, bool half, int batch,
                 int n, int cols, long long row_stride,
                 long long batch_stride) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2,
                                 (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map,
            half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lifts the kernel's dynamic shared memory limit to at least `bytes`, once
// per device (`limit` holds what each device has), and launches it.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int (&limit)[kMaxDevices],
                   int bytes, int blocks, int threads, cudaStream_t stream,
                   Args&&... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || limit[dev] < bytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) limit[dev] = bytes;
  }
  kernel<<<blocks, threads, bytes, stream>>>(static_cast<Args&&>(args)...);
  return cudaGetLastError();
}

template <bool kHalf, int kDB>
cudaError_t launch_fwd(const CUtensorMap* maps, void* out, float* lse,
                       int blocks, int n, int heads, int head_dim,
                       int q_tiles, float scale_log2, cudaStream_t stream) {
  static int limit[kMaxDevices];
  using T = typename Elem<kHalf>::T;
  return launch(attention_fwd_sm90_kernel<kHalf, kDB>, limit, fwd_smem(kDB),
                blocks, 128 * kFwdGroups, stream, maps[0], maps[1], maps[2],
                static_cast<T*>(out), lse, n, heads, head_dim, q_tiles,
                scale_log2);
}

template <bool kHalf, int kDB>
cudaError_t launch_bwd(const CUtensorMap* maps, const float* lse, void* dq,
                       void* dk, void* dv, int blocks, int n, int heads,
                       int head_dim, int tiles, float scale, float scale_log2,
                       cudaStream_t stream) {
  static int limit[kMaxDevices];
  using T = typename Elem<kHalf>::T;
  return launch(attention_bwd_sm90_kernel<kHalf, kDB>, limit, bwd_smem(kDB),
                blocks, 128, stream, maps[0], maps[1], maps[2], maps[3],
                maps[4], lse, static_cast<T*>(dq), static_cast<T*>(dk),
                static_cast<T*>(dv), n, heads, head_dim, tiles, scale,
                scale_log2);
}

// Input types: bf16 and fp16 run the tensor-core kernels, f32 and f64
// their instances without tensor cores.
enum : int { kBF16 = 0, kF16 = 1, kF32 = 2, kF64 = 3 };

// Whether a kernel takes the shape, and the blocks of each of its roles'
// halves (a launch of `roles` halves stays under 2^31 blocks).
bool shape_ok(int type, int batch, int n, int heads, int head_dim, int roles,
              int* tiles, int* blocks) {
  if (type < kBF16 || type > kF64 || batch < 1 || n < 1 || heads < 1 ||
      head_dim < 1 || head_dim > 128) {
    return false;
  }
  const bool simt = type >= kF32;
  if (!simt && head_dim % 16 != 0) return false;
  const int rows =
      simt ? kSimtWarps : (roles == 1 ? kRows * kFwdGroups : kRows);
  *tiles = (n + rows - 1) / rows;
  const long long total =
      static_cast<long long>(roles) * *tiles * batch * heads;
  if (total >= (1LL << 31)) return false;
  *blocks = static_cast<int>(total);
  return true;
}

template <typename T>
int launch_simt_fwd(const void* q, const void* k, const void* v, void* out,
                    void* lse, int blocks, int n, int heads, int head_dim,
                    int tiles, long long q_row, long long q_batch,
                    long long k_row, long long k_batch, long long v_row,
                    long long v_batch, double scale, cudaStream_t stream) {
  attention_fwd_simt_kernel<T><<<blocks, 32 * kSimtWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<T*>(lse),
      n, heads, head_dim, tiles, q_row, q_batch, k_row, k_batch, v_row,
      v_batch, static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt_bwd(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* dq, void* dk, void* dv, int blocks, int n,
                    int heads, int head_dim, int tiles,
                    const long long (&strides)[10], double scale,
                    cudaStream_t stream) {
  attention_bwd_simt_kernel<T><<<blocks, 32 * kSimtWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const T*>(lse),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), n,
      heads, head_dim, tiles, strides[0], strides[1], strides[2],
      strides[3], strides[4], strides[5], strides[6], strides[7],
      strides[8], strides[9], static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launch (0 =
// launched; -1 = a shape or type no kernel takes: in bf16 or fp16 a head
// dimension that is not a multiple of 16 in 16 .. 128, in f32 or f64 one
// outside 1 .. 128, an empty dimension, or 2^31 blocks or more; -2 = a
// tensor map could not be encoded). q, k, v, o, dout are [batch, n,
// heads*head_dim] with unit column stride and the given row and batch
// strides (elements; in bf16 and fp16 the caller has checked 16-byte
// alignment of bases and strides); out, dq, dk, dv are contiguous. `type`
// is kBF16, kF16, kF32 or kF64; lse is [batch, heads, n] in f32 for bf16
// and fp16, else in the input's type. `scale` is 1/sqrt(head_dim).

// out = softmax(q k^T * scale) v per head; lse (null: not kept) the row
// logsumexp of the scaled scores.
extern "C" int embn_attention_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int batch, int n,
                                  int heads, int head_dim, int type,
                                  long long q_row, long long q_batch,
                                  long long k_row, long long k_batch,
                                  long long v_row, long long v_batch,
                                  double scale, void* stream) {
  int tiles = 0, blocks = 0;
  if (!shape_ok(type, batch, n, heads, head_dim, 1, &tiles, &blocks)) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (type >= kF32) {
    return (type == kF32 ? launch_simt_fwd<float> : launch_simt_fwd<double>)(
        q, k, v, out, lse, blocks, n, heads, head_dim, tiles, q_row, q_batch,
        k_row, k_batch, v_row, v_batch, scale, s);
  }
  const bool half = type == kF16;
  const int cols = heads * head_dim;
  CUtensorMap maps[3];
  if (!encode_rows(&maps[0], q, half, batch, n, cols, q_row, q_batch) ||
      !encode_rows(&maps[1], k, half, batch, n, cols, k_row, k_batch) ||
      !encode_rows(&maps[2], v, half, batch, n, cols, v_row, v_batch)) {
    return -2;
  }
  const float scale_log2 = static_cast<float>(scale) * kLog2e;
  using Launch = decltype(&launch_fwd<false, 1>);
  static const Launch by_type[2][2] = {
      {launch_fwd<false, 1>, launch_fwd<false, 2>},
      {launch_fwd<true, 1>, launch_fwd<true, 2>}};
  return static_cast<int>(by_type[half][head_dim > 64](
      maps, out, static_cast<float*>(lse), blocks, n, heads, head_dim, tiles,
      scale_log2, s));
}

// dq, dk, dv of the forward above for the output gradient dout, from its
// inputs, its output o and its logsumexp.
extern "C" int embn_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    int batch, int n, int heads, int head_dim, int type, long long q_row,
    long long q_batch, long long k_row, long long k_batch, long long v_row,
    long long v_batch, long long o_row, long long o_batch, long long do_row,
    long long do_batch, double scale, void* stream) {
  int tiles = 0, blocks = 0;
  if (!shape_ok(type, batch, n, heads, head_dim, 2, &tiles, &blocks)) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (type >= kF32) {
    const long long strides[10] = {q_row, q_batch, k_row, k_batch, v_row,
                                   v_batch, o_row, o_batch, do_row, do_batch};
    return (type == kF32 ? launch_simt_bwd<float> : launch_simt_bwd<double>)(
        q, k, v, o, dout, lse, dq, dk, dv, blocks, n, heads, head_dim, tiles,
        strides, scale, s);
  }
  const bool half = type == kF16;
  const int cols = heads * head_dim;
  CUtensorMap maps[5];
  if (!encode_rows(&maps[0], q, half, batch, n, cols, q_row, q_batch) ||
      !encode_rows(&maps[1], k, half, batch, n, cols, k_row, k_batch) ||
      !encode_rows(&maps[2], v, half, batch, n, cols, v_row, v_batch) ||
      !encode_rows(&maps[3], o, half, batch, n, cols, o_row, o_batch) ||
      !encode_rows(&maps[4], dout, half, batch, n, cols, do_row, do_batch)) {
    return -2;
  }
  const float scale_f = static_cast<float>(scale);
  using Launch = decltype(&launch_bwd<false, 1>);
  static const Launch by_type[2][2] = {
      {launch_bwd<false, 1>, launch_bwd<false, 2>},
      {launch_bwd<true, 1>, launch_bwd<true, 2>}};
  return static_cast<int>(by_type[half][head_dim > 64](
      maps, static_cast<const float*>(lse), dq, dk, dv, blocks, n, heads,
      head_dim, tiles, scale_f, scale_f * kLog2e, s));
}
