// Stride-1 SAME 3x3 convolution on a small square NHWC map followed by a
// per-channel affine + ReLU, for Hopper (sm_90a).
//
// Replaces fused_kernel of tools/pallas_fused_conv.py (T1, via
// fused_conv_bn_relu): out = relu(conv3x3(x, w) * scale + bias).
// x [B, S, S, Cin] bf16 NHWC, w [3, 3, Cin, Cout] bf16 (HWIO), out
// [B, S, S, Cout] bf16; scale/bias f32 [Cout]; S in {2, 4, 8}, Cin and Cout
// multiples of 128 (the wrapper's gate). Accumulation is f32; the output is
// rounded to bf16 once, in the epilogue. The plain conv (K1, forward and
// input gradient) and the conv with the affine + ReLU before it (K3) are
// csrc/conv3x3_sm90.cu's; this entry point takes only T1's mode, 2.
//
// Design: an implicit GEMM. Rows are output positions, M = B*S*S, in NHWC
// order, so the output is the row-major [M, Cout] matrix and needs no
// reordering. Columns are output channels, N = Cout. The reduction runs over
// K = 9*Cin, tap-major, so the HWIO weight is already the row-major [K, N]
// B operand. Each block owns a 64x64 output tile and walks K in chunks of 64
// (a chunk never straddles a tap, since Cin % 64 == 0). Per chunk it gathers
// the A tile, the 64 rows shifted by the chunk's tap, into shared memory;
// taps that fall outside the map are written as zeros. The epilogue applies
// relu(acc*scale + bias) to the f32 accumulator tile as it leaves shared
// memory, with the block's 64 scales and biases read once into shared
// memory, the multiply and the add rounded separately (no contraction into
// an FMA) as the plain version rounds them. Four warps each multiply a
// 32x32 quarter with nvcuda::wmma bf16 16x16x16 into f32 fragments. The
// next chunk's global loads are issued into registers before the current
// chunk's products, so memory and tensor-core work overlap. No atomics:
// every output is summed in one fixed order, and results are deterministic.
//
// What bounds it on an H100: at B = 1024, S = 2, C = 512 (the A/B tool's
// shape) 19.3 GFLOP for 13.1 MB, so the tensor cores (19.5 us at the dense
// bf16 peak). Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md) it takes
// about 150 us, bound by the serial chain of K chunks inside each block:
// 72 chunks at C=512 with one chunk in flight take about 1.3 us each. The
// blocks of one weight slice are adjacent in launch order (M is the fast
// grid axis), so the slice is read from L2 after its first block.
// csrc/conv3x3_sm90.cu's TMA/wgmma ring, with the affine + ReLU applied to
// the accumulators before the bf16 store, is the design to move it to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;             // output rows per block
constexpr int BN = 64;             // output channels per block
constexpr int BK = 64;             // reduction chunk
constexpr int THREADS = 128;       // four warps, 2x2 over the tile
constexpr int VEC = 8;             // bf16 values in one 16-byte vector
constexpr int LDA = BK + 8;        // padded shared strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int A_VECS = BM * BK / VEC / THREADS;  // 4 vectors per thread
constexpr int B_VECS = BK * BN / VEC / THREADS;  // 4 vectors per thread
constexpr int ROWS_PER_PASS = THREADS / (BK / VEC);  // 16

// embn_conv3x3_small's `mode` of T1: the affine + ReLU after the conv.
constexpr int kEpilogue = 2;

__global__ void __launch_bounds__(THREADS)
conv3x3_affine_relu_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out,
                           int batch, int s, int cin, int cout) {
  __shared__ __align__(128) __nv_bfloat16 a_s[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 b_s[BK * LDB];
  __shared__ __align__(128) float c_s[BM * LDC];
  __shared__ float scale_s[BN], bias_s[BN];   // the block's channels

  const int m_total = batch * s * s;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  // This thread stages rows r0 + 16*i of the A tile (and k rows r0 + 16*i of
  // the B tile), always at the 8-element segment seg.
  const int r0 = tid / (BK / VEC);
  const int seg = tid % (BK / VEC);

  // Output position of each staged A row; -1 marks a row past the batch.
  int row_b[A_VECS], row_y[A_VECS], row_x[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int m = m0 + r0 + i * ROWS_PER_PASS;
    if (m < m_total) {
      const int p = m % (s * s);
      row_b[i] = m / (s * s);
      row_y[i] = p / s;
      row_x[i] = p % s;
    } else {
      row_b[i] = -1;
      row_y[i] = 0;
      row_x[i] = 0;
    }
  }

  uint4 a_reg[A_VECS];
  uint4 b_reg[B_VECS];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Global loads of chunk kt into registers.
  auto load_chunk = [&](int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / cin;
    const int c = k0 - tap * cin + seg * VEC;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int iy = row_y[i] + dy;
      const int ix = row_x[i] + dx;
      const bool in = row_b[i] >= 0 && iy >= 0 && iy < s && ix >= 0 && ix < s;
      a_reg[i] = in
          ? *reinterpret_cast<const uint4*>(
                x + ((size_t)(row_b[i] * s + iy) * s + ix) * cin + c)
          : zero;
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int k = k0 + r0 + i * ROWS_PER_PASS;
      b_reg[i] = *reinterpret_cast<const uint4*>(
          w + (size_t)k * cout + n0 + seg * VEC);
    }
  };

  // The loaded chunk's registers into shared memory.
  auto stage_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      *reinterpret_cast<uint4*>(
          &a_s[(r0 + i * ROWS_PER_PASS) * LDA + seg * VEC]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      *reinterpret_cast<uint4*>(
          &b_s[(r0 + i * ROWS_PER_PASS) * LDB + seg * VEC]) = b_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int k_chunks = 9 * cin / BK;
  load_chunk(0);
  for (int kt = 0; kt < k_chunks; ++kt) {
    stage_chunk();
    __syncthreads();
    if (kt + 1 < k_chunks) load_chunk(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &a_s[(wm + 16 * i) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &b_s[kk * LDB + wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: f32 tile through shared memory, relu(acc*scale + bias) in
  // f32, one bf16 rounding, 16-byte stores of whole rows; rows past the
  // batch are not written.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&c_s[(wm + 16 * i) * LDC + wn + 16 * j],
                              acc[i][j], LDC, wmma::mem_row_major);
  if (tid < BN) {
    scale_s[tid] = scale[n0 + tid];
    bias_s[tid] = bias[n0 + tid];
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN / VEC; idx += THREADS) {
    const int r = idx / (BN / VEC);
    const int cseg = idx % (BN / VEC);
    const int m = m0 + r;
    if (m >= m_total) continue;
    uint4 v;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = cseg * VEC + j;
      e[j] = __float2bfloat16(fmaxf(
          __fadd_rn(__fmul_rn(c_s[r * LDC + c], scale_s[c]), bias_s[c]),
          0.0f));
    }
    *reinterpret_cast<uint4*>(out + (size_t)m * cout + n0 + cseg * VEC) = v;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (0 = launched,
// -1 = a mode other than T1's 2: the plain conv's 0 and the prologue's 1
// are csrc/conv3x3_sm90.cu's). The caller has checked shapes, dtypes,
// contiguity and 16-byte alignment.
extern "C" int embn_conv3x3_small(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, int batch, int s, int cin,
                                  int cout, int mode, void* stream) {
  if (mode != kEpilogue) return -1;
  const dim3 grid((batch * s * s + BM - 1) / BM, cout / BN);
  conv3x3_affine_relu_kernel<<<grid, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
      batch, s, cin, cout);
  return static_cast<int>(cudaGetLastError());
}
