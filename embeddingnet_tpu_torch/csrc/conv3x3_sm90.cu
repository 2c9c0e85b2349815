// Stride-1 SAME 3x3 convolution on a small square NHWC map, its input
// gradient and its weight gradient, each optionally after a per-channel
// affine + ReLU of its input, and the forward with that affine + ReLU on
// its output instead, as TMA-fed wgmma implicit GEMMs for Hopper (sm_90a).
//
// Replaces five Pallas TPU kernels, four of embeddingnet_tpu/ops/fused_conv.py
// and one of tools/pallas_fused_conv.py:
//   conv3x3_sm90_kernel<false, *, false, false> -> _fwd_kernel (K1, via
//                                 _conv_fwd_impl): out = conv3x3(x, w)
//   conv3x3_sm90_kernel<true, *, false, false>  -> _fwd_kernel as the input
//                                 gradient (_conv_vjp_bwd):
//                                 dx = conv3x3(g, flip(w)), reading w as
//                                 it stands
//   conv3x3_sm90_kernel<false, *, true, false>  -> _fwd_bn_kernel (K3, via
//                                 _conv_bn_fwd_impl):
//                                 out = conv3x3(relu(x*scale + bias), w)
//   conv3x3_sm90_kernel<false, *, false, true>  -> fused_kernel of
//                                 tools/pallas_fused_conv.py (T1, via
//                                 fused_conv_bn_relu):
//                                 out = relu(conv3x3(x, w)*scale + bias)
//   conv3x3_wgrad_sm90_kernel<false>     -> _wgrad_kernel (K2, via
//                                 _wgrad_impl):
//                                 dW[t] = sum_m x_pad[shift t]^T g
//   conv3x3_wgrad_sm90_kernel<true>      -> _wgrad_bn_kernel (K4, via
//                                 _wgrad_bn_impl): the same with
//                                 z = relu(x*scale + bias) for x, recomputed
//                                 from the raw x and never stored
// x [B, S, S, Cin] bf16 NHWC, w [3, 3, Cin, Cout] bf16 (HWIO), g
// [B, S, S, Cout] bf16, scale and bias f32, one per input channel [Cin]
// (K3, K4) or per output channel [Cout] (T1); out and dx bf16, dW
// [3, 3, Cin, Cout] f32. S in {2, 4, 8}, Cin and Cout multiples of 128 (the
// wrapper's gate), any B >= 1. Accumulation is f32 in registers; each
// output is summed in one fixed order, with no atomics, so every result is
// the same bit for bit from launch to launch.
//
// The conv (forward and dgrad) is the GEMM [M = B*S*S, K = 9*Ck] x [K, N],
// M in NHWC order, K tap-major, in output tiles of kRows (128 or 256, the
// wrapper's choice) by 128. The grid is persistent: one block per SM walks
// the tiles `ctas` apart. In a block, two consumer warpgroups each run
// wgmma m64n128k16 on kRows/2 of a tile's rows, and one producer thread
// keeps a ring of 4 (or 6) stages of TMA loads in flight, each stage one
// 64-wide K chunk (kRows x 128 bytes of A, 16 KB of B), with a full and an
// empty mbarrier per stage. The consumers keep one wgmma group in flight
// and release a stage when the group that read it has completed; the
// producer runs on into the next tile while the consumers store this one,
// so a tile's pipeline fill and epilogue overlap its neighbours'.
//
// The A tile is one TMA box of a 4-D tensor map over the activation,
// innermost first (C, W, H, B): a box [64, S, S, kRows/(S*S)] is kRows
// output positions in NHWC order by 64 channels, the K-major A tile,
// 128-byte swizzled. For tap (dy, dx) the producer loads the box at (c0,
// dx-1, dy-1, b0): TMA writes zeros for every coordinate outside the
// tensor, negative ones included, which is SAME padding, and for the rows
// past a ragged batch. The B operand comes from a 2-D map over w seen as [9*Cin, Cout] in
// boxes of 64x64: for the forward, B[k = (t, ci), n = co] = w[t, ci, co] is
// N-major (wgmma's transpose bit for B); for the dgrad,
// B[k = (t, co), n = ci] = w[8-t, ci, co] is K-major, wgmma's native B
// layout, with the tap reversed in the producer's coordinates, so the
// flipped, transposed weight is never made. The epilogue rounds the
// accumulators to bf16 and stores them from registers, rows past the batch
// masked; T1's epilogue first maps each accumulator to relu(acc*scale +
// bias) of its output channel, the product and the sum rounded apart (no
// FMA) as the plain version rounds, with one rounding to bf16
// (cvt.rn.relu.bf16x2.f32). A thread's 32 columns of a tile take their
// scales and biases two at a time from a copy of all Cout in shared memory,
// so that none is held across the store loop: the 256-row tiles keep 128
// f32 accumulators a thread live under the launch bound's register cap.
//
// The weight gradient is dW [9*Cin, Cout] = A^T G reduced over the M
// positions. A block owns a 128x128 dW tile within one tap and reduces its
// part of M in chunks of 64 positions: the A tile is two boxes of the same
// 4-D map at the tap's shift ([64, S, S, 64/(S*S)], channels contiguous:
// the M-major A operand, wgmma's transpose bit for A), G two 64x64 boxes of
// a 2-D map over g [B*S*S, Cout] (N-major B). The positions are split into
// `parts` parts (grid.z); each part writes an f32 partial and
// conv3x3_sum_parts_kernel adds the parts in a fixed order. The wrapper
// picks the parts (ops/fused_conv.py, plan_sm90) so that the blocks fill
// whole waves of the card's SMs.
//
// The prologue (K3, K4) runs on each landed A stage in shared memory,
// between the consumer's wait on the stage's full barrier and its wgmma:
// each consumer warpgroup rewrites in place the rows that only it reads
// (K3: its kRows/2 rows of the tile; K4: its 64-channel box), 16 bytes (8
// channels of one position) per vector, z = relu(x*scale + bias) with the
// product and the sum rounded apart (no FMA) and one round to bf16, as the
// plain version rounds; then fence.proxy.async (the rewrite is a
// generic-proxy write, wgmma reads through the async proxy) and a barrier
// over the warpgroup's 128 threads. The 128-byte swizzle keeps logical
// 16-byte chunk j of a 128-byte row r at physical chunk j ^ (r % 8) (the
// stage is 1024-byte aligned), which names the 8 channels a vector holds;
// every vector of a thread has the same r % 8 and physical chunk, so a
// thread needs 8 scales and biases per K chunk (K3, from a copy of all Cin
// in shared memory) or per block (K4, in registers). The padding ring and
// the rows past the batch stay zero after the affine (relu(bias) != 0):
// a row (b, h, w) of a box at (c0, dx-1, dy-1, b0) is rewritten only when
// 0 <= h+dy-1 < S, 0 <= w+dx-1 < S and b0+b < B, from coordinates, never
// from the value. With one wgmma group in flight, the rewrite of stage k+1
// overlaps the products of stage k. K3's consumers raise their register
// cap to 232 (setmaxnreg; the producer lowers its own to 40), since 256-row
// tiles keep 128 f32 accumulators a thread live through the rewrite.
//
// TMA needs 16-byte aligned bases and strides: the wrapper checks the
// pointers, and channels that are multiples of 128 make every stride a
// multiple of 256 bytes. The inner box is 64 bf16 = 128 bytes, the span of
// the 128-byte swizzle; every box dimension is at most 256. The tensor maps
// are encoded on the host at every launch (activations move between calls)
// and passed as __grid_constant__ parameters. cuTensorMapEncodeTiled is
// resolved through cudaGetDriverEntryPoint, so nothing beyond the CUDA
// runtime is linked.
//
// What bounds it on an H100: 2*B*S*S*9*Cin*Cout FLOPs, 19.3 GFLOP at every
// training shape at B = 1024, against about 10 MB read and written: the
// tensor cores, 19.5 us at the dense bf16 peak. Measured (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md) the mainloop with 128-row tiles runs a 64-wide
// chunk in about 0.49 us against 0.28 at the peak, loading 32 KB per chunk
// per SM: the L2-to-SM traffic bounds it. 256-row tiles load a quarter less
// per product, so the wrapper takes them where they still give a block to
// 90% of the SMs (S = 4 and 8 at B = 1024); at S = 2 there are only 128
// tiles of 128 rows. Deeper rings (5, 6 stages) gained nothing measurable.
// T1 runs K1's forward GEMM (the same tiles) with its epilogue, which
// overlaps the producer's loads for the block's next tile.
// K3 and K4 run the same GEMMs at 51-56 and 55-80 us a launch at B = 1024
// against K1's 34-38 and K2's 43-58 (tools/conv3x3_kernels_ab_torch.py,
// same card; PERF.md): the rewrite, about 30 instructions per 16-byte
// vector on the two consumer warps of each scheduler, grows with the
// vectors a thread owns and does not hide under the products. A warpgroup
// that only rewrites stages would take it off the consumers' path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;           // output columns (and K2's rows) a block
constexpr int kChunk = 64;           // K per stage (bf16: one 128-byte row)
constexpr int kHalfBytes = 64 * 128;             // one 64x64 bf16 box
constexpr int kBBytes = 2 * kHalfBytes;          // a stage's B (16 KB)
constexpr int kThreads = 384;        // two consumer warpgroups, a producer
constexpr int kMaxDevices = 64;

// A stage: A (rows x 128 bytes) then B; the dynamic shared memory of a ring
// of such stages, with room to align it to 1024 bytes.
__host__ __device__ constexpr int stage_bytes(int rows) {
  return rows * 128 + kBBytes;
}
__host__ __device__ constexpr int smem_bytes(int rows, int depth) {
  return depth * stage_bytes(rows) + 1024;
}
// The ring's depth: 4 stages; 6 for the prologue's 128-row stages, where
// shared memory holds them: a stage stays in the ring through its own
// rewrite and the next stage's, since the consumers release it after
// issuing the next stage's products.
__host__ __device__ constexpr int ring_depth(int rows, bool prologue) {
  return prologue && rows == 128 ? 6 : 4;
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`. A wait that lasts
// seconds (a fault in the ring) traps, so that the launch fails instead of
// hanging the card.
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (the
// layout TMA's CU_TENSOR_MAP_SWIZZLE_128B writes into a 1024-byte aligned
// buffer). K-major: `lbo` unused (1), `sbo` the 1024 bytes between groups of
// eight 128-byte rows. M/N-major: `lbo` the bytes between 64-wide M/N
// blocks, `sbo` the bytes between groups of eight K rows.
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

// Generic-proxy shared-memory access for the prologue, and what orders it
// before wgmma's async-proxy reads.
__device__ __forceinline__ void ld_shared_v4(uint32_t addr, uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr,
                                             const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier `id` (1 + the warpgroup; 0 is __syncthreads) over the 128
// threads of one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Moves registers between the warpgroups: every warp of a warpgroup runs
// the same instruction.
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// d[64x128] += A[64x16] B[16x128], bf16 in, f32 accumulators. kTransA /
// kTransB: 0 K-major, 1 M/N-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// The ring's shared memory: kDepth stages of [A kRows x 128 bytes | B
// 16 KB], 1024-byte aligned for the 128-byte swizzle, and the full/empty
// barriers.
template <int kRows, int kDepth>
struct Ring {
  static constexpr int depth = kDepth;
  uint32_t tiles;
  uint32_t full;
  uint32_t empty;
  __device__ uint32_t a(int stage) const {
    return tiles + stage * stage_bytes(kRows);
  }
  __device__ uint32_t b(int stage) const { return a(stage) + kRows * 128; }
  __device__ uint32_t full_bar(int stage) const { return full + 8 * stage; }
  __device__ uint32_t empty_bar(int stage) const { return empty + 8 * stage; }
};

template <int kRows, int kDepth>
__device__ __forceinline__ Ring<kRows, kDepth> make_ring(uint8_t* smem_raw,
                                                         uint64_t* full,
                                                         uint64_t* empty) {
  Ring<kRows, kDepth> r;
  r.tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  r.full = smem_u32(full);
  r.empty = smem_u32(empty);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDepth; ++i) {
      mbar_init(r.full_bar(i), 1);       // the producer's expect_tx arrival
      mbar_init(r.empty_bar(i), 2);      // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The consumer side of the ring: the next `chunks` stages from (stage,
// phase), which it advances, each first handed to `prologue(stage, kc)`
// (kc counts the chunks from 0) and then multiplied by `mma(stage)`; one
// wgmma group stays in flight, and a stage is released once the group that
// read it has completed.
template <class RingT, class Prologue, class Mma>
__device__ __forceinline__ void consume(const RingT& ring, int chunks,
                                        int& stage, uint32_t& phase,
                                        Prologue prologue, Mma mma) {
  const bool signals = threadIdx.x % 128 == 0;
  int prev = stage;
  for (int kc = 0; kc < chunks; ++kc) {
    mbar_wait(ring.full_bar(stage), phase);
    prologue(stage, kc);
    wgmma_fence();
    mma(stage);
    wgmma_commit();
    wgmma_wait<1>();
    if (kc > 0 && signals) mbar_arrive(ring.empty_bar(prev));
    prev = stage;
    if (++stage == RingT::depth) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  if (chunks > 0 && signals) mbar_arrive(ring.empty_bar(prev));
}

// ---------------------------------------------------------------------------
// The prologue of K3 and K4 on a landed A stage. A consumer thread (tid =
// threadIdx.x % 128 in its warpgroup) owns the 16-byte vectors tid + 128*i
// of its warpgroup's rows: row tid/8 + 16*i, physical chunk tid % 8, so
// logical chunk (tid % 8) ^ (tid/8 % 8) for every i.
// ---------------------------------------------------------------------------

constexpr int kTapBits = 9;

// The 8-channel group of a box that this thread's vectors hold.
__device__ __forceinline__ int prologue_group() {
  const int tid = threadIdx.x % 128;
  return (tid % 8) ^ ((tid / 8) % 8);
}

// Row r of a box of whole s x s maps: bit t set where tap t's shift keeps
// the row's position on the map; the row's image in the box above the tap
// bits.
__device__ __forceinline__ uint32_t row_word(int r, int s) {
  const int ss = s * s;
  const int img = r / ss;
  const int h = (r - img * ss) / s;
  const int w = r - img * ss - h * s;
  uint32_t taps = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int y = h + t / 3 - 1;
    const int x = w + t % 3 - 1;
    if (y >= 0 && y < s && x >= 0 && x < s) taps |= 1u << t;
  }
  return taps | static_cast<uint32_t>(img) << kTapBits;
}

// The words of this thread's kVecs rows, the warpgroup's rows starting at
// row `first` of the box.
template <int kVecs>
__device__ __forceinline__ void row_words(uint32_t (&word)[kVecs], int first,
                                          int s) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    word[i] = row_word(first + tid / 8 + 16 * i, s);
  }
}

// relu(lo) and relu(hi) rounded to bf16 and packed, lo in the low half:
// one instruction for the plain version's clamp and cast.
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// z = relu(x*scale + bias) in place on this thread's vectors of the rows at
// shared address `rows` whose words call them real for tap t with `images`
// images of the box left in the batch (the others keep TMA's zeros); `sc`
// and `bi` are the thread's 8 channels. All the loads are issued before
// the first product and all the stores after the last, so their latencies
// overlap. Then the warpgroup's rewrite is made visible to its wgmma.
template <int kVecs>
__device__ __forceinline__ void affine_relu_rows(
    uint32_t rows, const uint32_t (&word)[kVecs], int t, int images,
    const float (&sc)[8], const float (&bi)[8]) {
  const uint32_t base = rows + (threadIdx.x % 128) * 16;
  uint32_t v[kVecs][4];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) ld_shared_v4(base + 128 * 16 * i, v[i]);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = __uint_as_float(v[i][j] << 16);
      const float hi = __uint_as_float(v[i][j] & 0xFFFF0000u);
      v[i][j] = relu_bf16x2(__fadd_rn(__fmul_rn(lo, sc[2 * j]), bi[2 * j]),
                            __fadd_rn(__fmul_rn(hi, sc[2 * j + 1]),
                                      bi[2 * j + 1]));
    }
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (((word[i] >> t) & 1u) &&
        static_cast<int>(word[i] >> kTapBits) < images) {
      st_shared_v4(base + 128 * 16 * i, v[i]);
    }
  }
  fence_proxy_async();
  warpgroup_sync(1 + threadIdx.x / 128);
}

// 8 consecutive floats from 32-byte aligned `p`.
__device__ __forceinline__ void load8(float (&dst)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// ---------------------------------------------------------------------------
// The conv: forward (kDgrad = false) and input gradient (kDgrad = true);
// kPrologue (forward only) applies relu(x*scale + bias) to the input first,
// kEpilogue (forward only) relu(out*scale + bias) to the output.
// act_map: 4-D over the input activation [B, S, S, Ck]; w_map: 2-D over
// w [9*Cin_w, Cout_w] in 64x64 boxes. Ck = Cin_w for the forward and
// Cout_w for the dgrad; the output has N = Cout_w (forward) or Cin_w
// (dgrad) channels. With kPrologue (kEpilogue), the Ck (N) scales and then
// the Ck (N) biases follow the ring in dynamic shared memory.
// ---------------------------------------------------------------------------

template <bool kDgrad, int kRows, bool kPrologue, bool kEpilogue>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap act_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int batch, int s,
                    int ck, int n_total, int cin_w, int m_tiles) {
  static_assert(!(kDgrad && kPrologue), "the prologue is the forward's");
  static_assert(!(kEpilogue && (kDgrad || kPrologue)),
                "the epilogue is the plain forward's");
  constexpr int kSub = kRows / 128;    // m64 products per warpgroup
  constexpr int kVecs = 4 * kSub;      // prologue vectors a thread, a chunk
  constexpr int kDepth = ring_depth(kRows, kPrologue);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDepth], empty[kDepth];
  float* affine = nullptr;
  const int n_affine = kPrologue ? ck : n_total;
  if (kPrologue || kEpilogue) {
    // after the ring, which starts at the first 1024-byte boundary
    affine = reinterpret_cast<float*>(
        smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u) +
        kDepth * stage_bytes(kRows));
    for (int i = threadIdx.x; i < n_affine; i += kThreads) {
      affine[i] = scale[i];
      affine[n_affine + i] = bias[i];
    }
  }
  const auto ring = make_ring<kRows, kDepth>(smem_raw, full, empty);

  const int m_total = batch * s * s;
  const int images = kRows / (s * s);          // the A box's batch extent
  const int tiles = m_tiles * (n_total / kTile);
  const int per_tap = ck / kChunk;
  const int chunks = 9 * per_tap;
  const int wg = threadIdx.x / 128;
  // The block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the M
  // tile is the fast index, so the blocks at work share weight slices.
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 2) {
    // Producer: one thread starts every load, running ahead into the next
    // tile while the consumers store this one.
    if (kPrologue) reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b0 = (tile % m_tiles) * images;
      const int n0 = (tile / m_tiles) * kTile;
      for (int kc = 0; kc < chunks; ++kc) {
        const int t = kc / per_tap;
        const int c0 = (kc - t * per_tap) * kChunk;
        const uint32_t bar = ring.full_bar(stage);
        mbar_wait(ring.empty_bar(stage), phase ^ 1);
        mbar_expect_tx(bar, stage_bytes(kRows));
        tma_load_4d(ring.a(stage), &act_map, bar, c0, t % 3 - 1, t / 3 - 1,
                    b0);
        for (int h = 0; h < 2; ++h) {
          const uint32_t dst = ring.b(stage) + h * kHalfBytes;
          if (kDgrad) {
            // B[(t, co), ci] = w[8 - t, ci, co]: rows of ci, co contiguous
            tma_load_2d(dst, &w_map, bar, c0, (8 - t) * cin_w + n0 + 64 * h);
          } else {
            // B[(t, ci), co] = w[t, ci, co]: rows of k, co contiguous
            tma_load_2d(dst, &w_map, bar, n0 + 64 * h, t * ck + c0);
          }
        }
        if (++stage == kDepth) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies the kSub 64-row blocks wg*kSub ..
  // of a tile, each against the whole 128-wide B.
  if (kPrologue) reg_alloc<232>();
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  uint32_t word[kVecs];
  if (kPrologue) row_words(word, wg * kSub * 64, s);
  const int group = prologue_group();
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[kSub][64];
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[u][i] = 0.0f;
    const int images_left = batch - (tile % m_tiles) * images;
    consume(
        ring, chunks, stage, phase,
        [&](int slot, int kc) {
          if (!kPrologue) return;
          const int t = kc / per_tap;
          const int c = (kc - t * per_tap) * kChunk + 8 * group;
          float sc[8], bi[8];
          load8(sc, affine + c);
          load8(bi, affine + ck + c);
          affine_relu_rows(ring.a(slot) + wg * kSub * kHalfBytes, word, t,
                           images_left, sc, bi);
        },
        [&](int slot) {
#pragma unroll
          for (int k = 0; k < kChunk / 16; ++k) {
            // B: for the dgrad K-major, 128 rows of n; for the forward
            // N-major, two 64-wide N blocks 8 KB apart, 16 K rows = 2 KB
            const uint64_t db =
                kDgrad ? smem_desc(ring.b(slot) + 32 * k, 16, 1024)
                       : smem_desc(ring.b(slot) + 2048 * k, kHalfBytes, 1024);
#pragma unroll
            for (int u = 0; u < kSub; ++u) {
              // A: K-major, 128-byte rows; a 16-wide K step is 32 bytes in.
              const uint64_t da = smem_desc(
                  ring.a(slot) + (wg * kSub + u) * kHalfBytes + 32 * k, 16,
                  1024);
              wgmma_m64n128k16<0, kDgrad ? 0 : 1>(acc[u], da, db);
            }
          }
        });

    // Epilogue: acc[u][4j + 2h + e] is row 16*warp + lane/4 + 8h, column
    // 8j + 2*(lane%4) + e of the warpgroup's u-th 64x128 block. T1 reads
    // the two columns' scales and biases once per j, for all u and h.
    const int m = (tile % m_tiles) * kRows + 64 * wg * kSub + 16 * warp +
                  lane / 4;          // the row of u = h = 0
    const int n = (tile / m_tiles) * kTile + 2 * (lane % 4);
    __nv_bfloat16* const row = out + static_cast<size_t>(m) * n_total + n;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float2 sc = {}, bi = {};
      if (kEpilogue) {
        sc = *reinterpret_cast<const float2*>(affine + n + 8 * j);
        bi = *reinterpret_cast<const float2*>(affine + n_total + n + 8 * j);
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * u + 8 * h;
          if (m + r >= m_total) continue;
          __nv_bfloat16* dst = row + static_cast<size_t>(r) * n_total + 8 * j;
          const float lo = acc[u][4 * j + 2 * h];
          const float hi = acc[u][4 * j + 2 * h + 1];
          if (kEpilogue) {
            *reinterpret_cast<uint32_t*>(dst) =
                relu_bf16x2(__fadd_rn(__fmul_rn(lo, sc.x), bi.x),
                            __fadd_rn(__fmul_rn(hi, sc.y), bi.y));
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(lo, hi);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The weight gradient; kPrologue takes relu(x*scale + bias) for x. x_map:
// 4-D over x [B, S, S, Cin] in boxes of 64 positions; g_map: 2-D over g
// [B*S*S, Cout] in 64x64 boxes. Block (blockIdx.x, blockIdx.y) owns dW rows
// 128*x .. (within one tap) and columns 128*y ..; part blockIdx.z reduces
// chunks [z*per_part, ...).
// ---------------------------------------------------------------------------

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgrad_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap g_map,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          float* __restrict__ dst, int batch, int s, int cin,
                          int cout, int per_part) {
  constexpr int kDepth = ring_depth(kTile, kPrologue);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDepth], empty[kDepth];
  const auto ring = make_ring<kTile, kDepth>(smem_raw, full, empty);

  const int ss = s * s;
  const int chunks_total = (batch * ss + kChunk - 1) / kChunk;
  const int first = blockIdx.z * per_part;
  const int chunks = max(0, min(chunks_total, first + per_part) - first);
  const int k0 = blockIdx.x * kTile;
  const int t = k0 / cin;
  const int c0 = k0 - t * cin;
  const int n0 = blockIdx.y * kTile;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    if (threadIdx.x != 256) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int kc = 0; kc < chunks; ++kc) {
      const int p0 = (first + kc) * kChunk;        // first position
      mbar_wait(ring.empty_bar(stage), phase ^ 1);
      mbar_expect_tx(ring.full_bar(stage), stage_bytes(kTile));
      for (int h = 0; h < 2; ++h) {
        tma_load_4d(ring.a(stage) + h * kHalfBytes, &x_map,
                    ring.full_bar(stage), c0 + 64 * h, t % 3 - 1, t / 3 - 1,
                    p0 / ss);
        tma_load_2d(ring.b(stage) + h * kHalfBytes, &g_map,
                    ring.full_bar(stage), n0 + 64 * h, p0);
      }
      if (++stage == kDepth) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // The prologue's constants: the warpgroup rewrites its own box (channels
  // c0 + 64*wg ..), whose 8 channels per thread are fixed for the block.
  uint32_t word[4];
  float sc[8], bi[8];
  if (kPrologue) {
    row_words(word, 0, s);
    const int c = c0 + 64 * wg + 8 * prologue_group();
    load8(sc, scale + c);
    load8(bi, bias + c);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  consume(
      ring, chunks, stage, phase,
      [&](int slot, int kc) {
        if (!kPrologue) return;
        affine_relu_rows(ring.a(slot) + wg * kHalfBytes, word, t,
                         batch - (first + kc) * kChunk / ss, sc, bi);
      },
      [&](int slot) {
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k) {
          // A^T: this warpgroup's 64 channels are one M-major block
          // (positions are rows of 128 bytes); 16 positions = 2 KB.
          const uint64_t da =
              smem_desc(ring.a(slot) + wg * kHalfBytes + 2048 * k,
                        kHalfBytes, 1024);
          // G: N-major, two 64-wide N blocks 8 KB apart
          const uint64_t db =
              smem_desc(ring.b(slot) + 2048 * k, kHalfBytes, 1024);
          wgmma_m64n128k16<1, 1>(acc, da, db);
        }
      });

  float* part = dst + static_cast<size_t>(blockIdx.z) * 9 * cin * cout;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
    float* row = part + static_cast<size_t>(r) * cout + n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// dW = sum of the parts' partials, added in part order.
__global__ void conv3x3_sum_parts_kernel(const float4* __restrict__ parts,
                                         float4* __restrict__ out,
                                         int n_parts, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = parts[i];
  for (int p = 1; p < n_parts; ++p) {
    const float4 v = parts[static_cast<size_t>(p) * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[i] = acc;
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

// bf16, 128-byte swizzle, zeros outside the tensor. dims/box innermost
// first; strides in bytes of dims 1.. .
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 4-D map over an NHWC activation [batch, s, s, c], boxes of 64 channels by
// `images` whole maps.
bool encode_act(CUtensorMap* map, const void* base, int batch, int s, int c,
                int images) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)s, (cuuint64_t)s,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)s * c * 2,
                                 (cuuint64_t)s * s * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)s, (cuuint32_t)s,
                             (cuuint32_t)images};
  return encode(map, base, 4, dims, strides, box);
}

// 2-D map over a row-major [rows, cols] matrix, 64x64 boxes.
bool encode_matrix(CUtensorMap* map, const void* base, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode(map, base, 2, dims, strides, box);
}

// Lifts the kernel's dynamic shared memory limit to at least `bytes`, once
// per device and size (`limit` holds what each device has), and launches it
// on `grid` with `args`.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int (&limit)[kMaxDevices],
                   int bytes, dim3 grid, cudaStream_t stream,
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
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<Args&&>(args)...);
  return cudaGetLastError();
}

template <bool kDgrad, int kRows, bool kPrologue, bool kEpilogue>
cudaError_t launch_conv(const CUtensorMap& act_map, const CUtensorMap& w_map,
                        const float* scale, const float* bias,
                        __nv_bfloat16* out, int batch, int s, int ck,
                        int n_total, int cin_w, int m_tiles, int ctas,
                        cudaStream_t stream) {
  static int limit[kMaxDevices];
  const int bytes = smem_bytes(kRows, ring_depth(kRows, kPrologue)) +
                    (kPrologue ? 8 * ck : kEpilogue ? 8 * n_total : 0);
  return launch(conv3x3_sm90_kernel<kDgrad, kRows, kPrologue, kEpilogue>,
                limit, bytes,
                dim3(ctas), stream, act_map, w_map, scale, bias, out, batch,
                s, ck, n_total, cin_w, m_tiles);
}

template <bool kPrologue>
cudaError_t launch_wgrad(const CUtensorMap& x_map, const CUtensorMap& g_map,
                         const float* scale, const float* bias, float* dst,
                         int batch, int s, int cin, int cout, int parts,
                         int per_part, cudaStream_t stream) {
  static int limit[kMaxDevices];
  return launch(conv3x3_wgrad_sm90_kernel<kPrologue>, limit,
                smem_bytes(kTile, ring_depth(kTile, kPrologue)),
                dim3(9 * cin / kTile, cout / kTile, parts),
                stream, x_map, g_map, scale, bias, dst, batch, s, cin, cout,
                per_part);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() of its launches (0 =
// launched; -1 = arguments no kernel takes: an unknown mode, a tile height
// other than 128 or 256, or scale and bias not given exactly where the
// mode applies them; -2 = a tensor map could not be encoded). The caller
// has checked shapes, dtypes, contiguity and 16-byte alignment. `scale` and
// `bias` (f32) are both null, or both given for an affine + ReLU.

// The conv with the weight w [3, 3, cin_w, cout_w], by `mode`:
//   0 (K1): out [batch, s, s, cout_w] = conv3x3(x [batch, s, s, cin_w], w);
//   1 (K1 as the dgrad): out [batch, s, s, cin_w] = conv3x3(x [batch, s, s,
//     cout_w], flip(w)), the input gradient for the output gradient x;
//   2 (K3): conv3x3(relu(x*scale + bias), w), scale and bias [cin_w];
//   3 (T1): relu(conv3x3(x, w)*scale + bias), scale and bias [cout_w].
// The output is cut into tiles of `rows` (128 or 256) by 128, which `ctas`
// persistent blocks share (at most one block per SM: more are idle).
extern "C" int embn_conv3x3_sm90(const void* x, const void* w,
                                 const void* scale, const void* bias,
                                 void* out, int batch, int s, int cin_w,
                                 int cout_w, int mode, int rows, int ctas,
                                 void* stream) {
  const bool affine = scale != nullptr;
  if (mode < 0 || mode > 3 || (rows != 128 && rows != 256) ||
      affine != (bias != nullptr) || affine != (mode >= 2)) {
    return -1;
  }
  const bool dgrad = mode == 1;
  const int ck = dgrad ? cout_w : cin_w;
  const int n_total = dgrad ? cin_w : cout_w;
  const int images = rows / (s * s);
  const int m_tiles = (batch + images - 1) / images;
  CUtensorMap act_map, w_map;
  if (!encode_act(&act_map, x, batch, s, ck, images) ||
      !encode_matrix(&w_map, w, 9 * cin_w, cout_w)) {
    return -2;
  }
  using Launch = decltype(&launch_conv<false, 128, false, false>);
  static const Launch by_mode[4][2] = {
      {launch_conv<false, 128, false, false>,
       launch_conv<false, 256, false, false>},
      {launch_conv<true, 128, false, false>,
       launch_conv<true, 256, false, false>},
      {launch_conv<false, 128, true, false>,
       launch_conv<false, 256, true, false>},
      {launch_conv<false, 128, false, true>,
       launch_conv<false, 256, false, true>}};
  const Launch conv = by_mode[mode][rows == 256];
  return static_cast<int>(
      conv(act_map, w_map, static_cast<const float*>(scale),
           static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
           batch, s, ck, n_total, cin_w, m_tiles, ctas,
           static_cast<cudaStream_t>(stream)));
}

// dW [3, 3, cin, cout] f32 of the conv of x [batch, s, s, cin], or with the
// prologue of relu(x*scale + bias), for the output gradient g [batch, s, s,
// cout]. The positions are reduced in `parts` parts of `per_part`
// 64-position chunks; with more than one part, `ws` holds the [parts,
// 9*cin, cout] f32 partials that are then added in part order into `out`.
extern "C" int embn_conv3x3_wgrad_sm90(const void* x, const void* g,
                                       const void* scale, const void* bias,
                                       void* ws, void* out, int batch, int s,
                                       int cin, int cout, int parts,
                                       int per_part, void* stream) {
  const bool prologue = scale != nullptr;
  if (prologue != (bias != nullptr)) return -1;
  CUtensorMap x_map, g_map;
  if (!encode_act(&x_map, x, batch, s, cin, kChunk / (s * s)) ||
      !encode_matrix(&g_map, g, batch * s * s, cout)) {
    return -2;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(parts > 1 ? ws : out);
  const auto wgrad = prologue ? launch_wgrad<true> : launch_wgrad<false>;
  const cudaError_t err = wgrad(
      x_map, g_map, static_cast<const float*>(scale),
      static_cast<const float*>(bias), dst, batch, s, cin, cout, parts,
      per_part, st);
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const int n4 = 9 * cin * cout / 4;
  conv3x3_sum_parts_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(out), parts, n4);
  return static_cast<int>(cudaGetLastError());
}
