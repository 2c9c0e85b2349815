// Weight gradient of the stride-1 SAME 3x3 convolution of relu(x * scale +
// bias) on a small square NHWC map, for Hopper (sm_90a).
//
// Replaces _wgrad_bn_kernel (K4, via _wgrad_bn_impl) of
// embeddingnet_tpu/ops/fused_conv.py: dW[t] = sum_m z_pad[shift t]^T g with
// z = relu(x * scale + bias) recomputed from the raw x (never stored). The
// plain weight gradient (K2) is csrc/conv3x3_sm90.cu's; this entry point
// refuses prologue = 0.
// x [B, S, S, Cin] bf16 NHWC, g [B, S, S, Cout] bf16 (the output gradient),
// scale/bias [Cin] f32; dW [3, 3, Cin, Cout] f32 (HWIO), which the caller
// rounds once to the weight's dtype. S in {2, 4, 8}, Cin and Cout multiples
// of 128 (the wrapper's gate).
//
// Design: dW is the row-major [K = 9*Cin, N = Cout] matrix, HWIO as it
// stands; its rows are tap-major, so a 64-row block of dW lies within one
// tap's Cin slice. dW = A^T G, with A the [M = B*S*S, 9*Cin] matrix of taps
// (row m, the output position (b, y, x), holds x[b, y+dy, x+dx, :] for each
// tap, zero where the tap falls off the map) and G the [M, Cout] output
// gradient. Each block owns a 64x64 tile of dW and reduces over its share
// of the M rows in chunks of 64: per chunk it stages the 64 shifted input
// rows of its tap (the affine applied to the in-map taps only, so the
// padding ring stays zero after the affine, as _affine_relu_block masks it)
// and the 64 matching rows of G in shared memory, and four warps each
// accumulate a 32x32 quarter with nvcuda::wmma bf16 16x16x16 products in
// f32, A^T read as a column-major fragment. The next chunk's global loads
// are issued into registers before the current chunk's products.
//
// The TPU kernel carries dW across a sequential grid. Here the blocks run
// at once, and at B=1024, S=8, C=128 dW has only 18 x 2 = 36 tiles to
// reduce 65,536 rows, so the rows are split into `splits` parts (grid.z):
// each part writes its f32 partial tile, and a second kernel adds the parts
// in a fixed order. No atomics: dW is the same bit for bit from launch to
// launch.
//
// What bounds it on an H100: 2*B*S*S*9*Cin*Cout FLOPs (19.3 GFLOP at every
// training shape at B=1024) against x and g read once and dW written once
// (about 10 MB), so the tensor cores at 989 TFLOP/s, 19.5 us. This simple
// kernel (wmma, one chunk in flight per block) is far from that; wgmma with
// a TMA pipeline is the fix: csrc/conv3x3_sm90.cu's design, which K2
// already uses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;             // reduction rows (output positions) per chunk
constexpr int BK = 64;             // dW rows (tap, input channel) per block
constexpr int BN = 64;             // dW columns (output channels) per block
constexpr int THREADS = 128;       // four warps, 2x2 over the tile
constexpr int VEC = 8;             // bf16 values in one 16-byte vector
constexpr int LDA = BK + 8;        // padded shared strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int ROW_VECS = BM * BK / VEC / THREADS;  // 4 rows per thread
constexpr int ROWS_PER_PASS = THREADS / (BK / VEC);  // 16

__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_bn_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ g,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     float* __restrict__ dst,
                     int batch, int s, int cin, int cout,
                     int chunks_per_split) {
  __shared__ __align__(128) __nv_bfloat16 a_s[BM * LDA];  // [m][k]
  __shared__ __align__(128) __nv_bfloat16 g_s[BM * LDB];  // [m][n]
  __shared__ __align__(128) float c_s[BK * LDC];

  const int ss = s * s;
  const int m_total = batch * ss;
  const int k0 = blockIdx.x * BK;
  const int n0 = blockIdx.y * BN;
  const int tap = k0 / cin;
  const int c0 = k0 - tap * cin;
  const int dy = tap / 3 - 1;
  const int dx = tap % 3 - 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wk = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  // This thread stages rows r0 + 16*i of each chunk, at the 8-element
  // segment seg of the tile's 64 columns. A chunk starts at a multiple of
  // 64 rows, and S*S divides 64, so a row's place in the map, and whether
  // its tap is in the map, is the same in every chunk: only the batch
  // index moves.
  const int r0 = tid / (BK / VEC);
  const int seg = tid % (BK / VEC);
  int src_off[ROW_VECS];   // element offset of the tap's input row
  bool in_map[ROW_VECS];
#pragma unroll
  for (int i = 0; i < ROW_VECS; ++i) {
    const int r = r0 + i * ROWS_PER_PASS;
    const int b = r / ss;
    const int p = r % ss;
    const int iy = p / s + dy;
    const int ix = p % s + dx;
    in_map[i] = iy >= 0 && iy < s && ix >= 0 && ix < s;
    src_off[i] = ((b * s + iy) * s + ix) * cin + c0 + seg * VEC;
  }

  float sc[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sc[j] = scale[c0 + seg * VEC + j];
    bi[j] = bias[c0 + seg * VEC + j];
  }

  const int chunks = (m_total + BM - 1) / BM;
  const int chunk_begin = blockIdx.z * chunks_per_split;
  const int chunk_end = min(chunks, chunk_begin + chunks_per_split);

  uint4 a_reg[ROW_VECS];
  uint4 g_reg[ROW_VECS];
  bool a_in[ROW_VECS];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto load_chunk = [&](int mc) {
    const int m_base = mc * BM;
    const size_t x_base = (size_t)(m_base / ss) * ss * cin;
#pragma unroll
    for (int i = 0; i < ROW_VECS; ++i) {
      const int m = m_base + r0 + i * ROWS_PER_PASS;
      const bool valid = m < m_total;
      a_in[i] = valid && in_map[i];
      a_reg[i] = a_in[i]
          ? *reinterpret_cast<const uint4*>(x + x_base + src_off[i])
          : zero;
      g_reg[i] = valid
          ? *reinterpret_cast<const uint4*>(g + (size_t)m * cout + n0 +
                                            seg * VEC)
          : zero;
    }
  };

  auto stage_chunk = [&]() {
#pragma unroll
    for (int i = 0; i < ROW_VECS; ++i) {
      uint4 v = a_reg[i];
      if (a_in[i]) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          // rounded as the plain version rounds: product, then sum
          const float z = __fadd_rn(__fmul_rn(__bfloat162float(e[j]), sc[j]),
                                    bi[j]);
          e[j] = __float2bfloat16(fmaxf(z, 0.0f));
        }
      }
      const int r = r0 + i * ROWS_PER_PASS;
      *reinterpret_cast<uint4*>(&a_s[r * LDA + seg * VEC]) = v;
      *reinterpret_cast<uint4*>(&g_s[r * LDB + seg * VEC]) = g_reg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (chunk_begin < chunk_end) load_chunk(chunk_begin);
  for (int mc = chunk_begin; mc < chunk_end; ++mc) {
    stage_chunk();
    __syncthreads();
    if (mc + 1 < chunk_end) load_chunk(mc + 1);
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
      // A^T tile: element (k, m) sits at a_s[m * LDA + k], column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &a_s[kk * LDA + wk + 16 * i], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &g_s[kk * LDB + wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: the f32 tile through shared memory, 16-byte stores of whole
  // rows into this split's partial (or dW itself when there is one split).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&c_s[(wk + 16 * i) * LDC + wn + 16 * j],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* out = dst + (size_t)blockIdx.z * 9 * cin * cout;
  for (int idx = tid; idx < BK * BN / 4; idx += THREADS) {
    const int r = idx / (BN / 4);
    const int c = (idx % (BN / 4)) * 4;
    const float* src = &c_s[r * LDC + c];
    *reinterpret_cast<float4*>(out + (size_t)(k0 + r) * cout + n0 + c) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

// dW = sum of the splits' partials, added in split order.
__global__ void sum_splits_kernel(const float4* __restrict__ parts,
                                  float4* __restrict__ out, int splits,
                                  int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = parts[i];
  for (int p = 1; p < splits; ++p) {
    const float4 v = parts[(size_t)p * n4 + i];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[i] = acc;
}

}  // namespace

// Plain C entry point, loaded with ctypes. `ws` holds `splits` partial dW
// (unused when splits == 1: the kernel then writes `out` directly). Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launches (0 = launched, -1 = prologue 0, the plain weight gradient,
// which this source no longer has). The caller has checked shapes, dtypes,
// contiguity and 16-byte alignment.
extern "C" int embn_conv3x3_wgrad(const void* x, const void* g,
                                  const void* scale, const void* bias,
                                  void* ws, void* out, int batch, int s,
                                  int cin, int cout, int splits,
                                  int prologue, void* stream) {
  if (!prologue) return -1;
  const int chunks = (batch * s * s + BM - 1) / BM;
  const int per_split = (chunks + splits - 1) / splits;
  const dim3 grid(9 * cin / BK, cout / BN, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  conv3x3_wgrad_bn_kernel<<<grid, THREADS, 0, st>>>(
      xb, gb, static_cast<const float*>(scale),
      static_cast<const float*>(bias), dst, batch, s, cin, cout, per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int n4 = 9 * cin * cout / 4;
  sum_splits_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(
      static_cast<const float4*>(ws), static_cast<float4*>(out), splits, n4);
  return static_cast<int>(cudaGetLastError());
}
