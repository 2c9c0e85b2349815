// uint8 -> bf16 normalisation for Hopper (sm_90a): out[i] = bf16(f32(x[i])
// * (1/255)) over a contiguous uint8 tensor of any shape, n < 2^31
// elements. The product is rounded once to f32 (__fmul_rn: no contraction)
// and once to bf16 (round to nearest even); on every u8 value this equals
// the exact divide bf16(f32(x) / 255).
//
// Replaces the Pallas TPU kernel `kern` of tools/perf_probe3.py (via
// `norm_pallas`), T2, which the port first carried as a Triton kernel.
//
// What bounds it on an H100: 3 bytes an element (one read, two written),
// 37.7 MB at the training batch [1024, 64, 64, 3], so 11.3 us at 3.35 TB/s;
// it does no arithmetic to speak of. The design moves those bytes in the
// widest accesses and keeps enough of them in flight:
//   - a thread loads 16 input bytes as one uint4, with the streaming hint
//     (__ldcs: the input is read once), and stores 32 output bytes as two
//     uint4, plain, so that L2 may keep them for the stem conv that reads
//     them next. The 32 bytes a thread converts are not the 32 it stores:
//     a warp's lanes trade words by shuffle so that each store instruction
//     writes 512 contiguous bytes. Stored from the lane that loaded them,
//     each instruction would write half of every 32-byte sector it
//     touched, twice the L2 write requests (a first version did so and
//     took about twice the device time);
//   - 256-thread blocks, no shared memory; a block owns tiles of kThreads *
//     kUnroll vectors (16 KB in, 32 KB out) and issues a tile's kUnroll
//     loads a thread before its first store; the blocks walk the tiles
//     grid-stride, the grid being the SMs times the resident blocks, or the
//     tiles where they are fewer (ops/preprocess.py, plan_normalize_u8);
//     at the training batch that is 768 blocks of one tile, some 90 KB of
//     loads in flight on each SM against the ~20 KB that HBM's latency
//     asks for;
//   - the bytes are unpacked with shifts and converted two at a time
//     (__floats2bfloat162_rn).
// Edges: the `head` elements before the first 16-byte-aligned input
// address and the n % 16 of the tail go one element a thread, grid-stride.
// The vector body needs the input and the output 16-byte aligned after the
// head; with the output 16-byte aligned (torch.empty), that is an input
// address that is 8-byte aligned. Any other input takes the scalar path
// whole: the wrapper passes head = n, and every element goes one a thread
// (correct, not fast; whole batches are aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // ops/preprocess.py THREADS
constexpr int kUnroll = 4;     // ops/preprocess.py UNROLL
constexpr int kTile = kThreads * kUnroll;
constexpr float kScale = 1.0f / 255.0f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float unit(uint32_t byte) {
  return __fmul_rn(__uint2float_rn(byte), kScale);
}

// bytes `shift / 8` and `shift / 8 + 1` of `word` as a bf16 pair, the
// lower byte in the lower half
__device__ __forceinline__ uint32_t pair(uint32_t word, int shift) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(
      unit((word >> shift) & 0xffu), unit((word >> (shift + 8)) & 0xffu));
  return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
    normalize_u8_sm90_kernel(const uint8_t* __restrict__ x,
                             __nv_bfloat16* __restrict__ out, int n,
                             int head, int vectors) {
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  const int lane = threadIdx.x & 31;
  for (int t0 = blockIdx.x * kTile; t0 < vectors; t0 += gridDim.x * kTile) {
    uint4 in[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int v = t0 + k * kThreads + threadIdx.x;
      in[k] = v < vectors ? __ldcs(xv + v) : make_uint4(0, 0, 0, 0);
    }
    // A warp's 32 vectors are 1 KB of output. Store h of lane L writes its
    // 16-byte chunk h * 32 + L, the elements of half L & 1 of vector
    // h * 16 + L / 2, so each store instruction covers 512 contiguous
    // bytes (whole sectors); the lane that loaded that vector hands its
    // two words over by shuffle. Every lane shuffles (t0 is the same for
    // the whole block); only the stores are masked.
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int base = t0 + k * kThreads + (threadIdx.x & ~31);
      const uint4 w = in[k];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int src = h * 16 + (lane >> 1);
        const uint32_t x0 = __shfl_sync(kAll, w.x, src);
        const uint32_t y0 = __shfl_sync(kAll, w.y, src);
        const uint32_t z0 = __shfl_sync(kAll, w.z, src);
        const uint32_t w0 = __shfl_sync(kAll, w.w, src);
        const uint32_t a = (lane & 1) ? z0 : x0;
        const uint32_t b = (lane & 1) ? w0 : y0;
        if (base + src < vectors) {
          ov[2 * base + h * 32 + lane] = make_uint4(
              pair(a, 0), pair(a, 16), pair(b, 0), pair(b, 16));
        }
      }
    }
  }
  // the head [0, head) and the tail [head + 16 * vectors, n); 64-bit
  // indices, so that the stride cannot carry one past 2^31
  const long long body = 16LL * vectors;
  const long long edges = n - body;
  for (long long e = blockIdx.x * kThreads + threadIdx.x; e < edges;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long i = e < head ? e : e + body;
    out[i] = __float2bfloat16_rn(unit(x[i]));
  }
}

// x uint8 [n], out bf16 [n]; `head` elements go before the vector body
// (n for the scalar path), `grid` blocks of 256 threads, on `stream`.
// Returns cudaGetLastError() of the launch, or -1 for arguments the kernel
// does not take (a negative n or head, head > n, grid < 1, or a vector body
// that would not be 16-byte aligned), before any launch.
extern "C" int embn_normalize_u8(const void* x, void* out, int n, int head,
                                 int grid, void* stream) {
  if (n < 0 || head < 0 || head > n || grid < 1) return -1;
  const int vectors = (n - head) / 16;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (vectors > 0 && ((reinterpret_cast<uintptr_t>(xb + head) |
                       reinterpret_cast<uintptr_t>(ob + head)) & 15)) {
    return -1;
  }
  normalize_u8_sm90_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      xb, ob, n, head, vectors);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of 256 threads that one SM holds at once for this kernel (the
// occupancy calculator's answer for its registers), into *blocks.
extern "C" int embn_normalize_u8_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, normalize_u8_sm90_kernel, kThreads, 0));
}
