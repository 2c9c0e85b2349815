// LayerNorm over the last dimension for Hopper (sm_90a): y = (x - mean) *
// rstd * gamma + beta for each row of D values, and its backward with the
// parameters' gradients, for the ViT's pre-norm blocks (models/vit.py
// LayerNorm through ops/layernorm.py).
//
// Replaces no TPU kernel: on the TPU this is Flax's nn.LayerNorm, which XLA
// fuses into the ops around it; there is no pallas_call. It was added
// because the port's eager chain (x cast to f32, F.layer_norm, the result
// cast back; autograd's f32 backward with its casts and its separate
// gamma/beta reduction) moved about five times the bytes the function
// needs: 347 us a forward at [256, 197, 768] bf16 against 46 us.
//
// What bounds it on an H100: bytes. A forward reads x and writes y once (4
// bytes an element in bf16: 155 MB at that shape, 46 us at 3.35 TB/s); a
// backward reads x and dy and writes dx (232 MB, 69 us). The design reads
// each of them once, in 16-byte accesses:
//   - a row is owned by `lanes` lanes of a warp (a power of two: 32 for a
//     row of 32 chunks or more), each lane holding up to kChunks chunks of
//     kVec values in registers: in bf16 and fp16 a chunk is 16 bytes, 8
//     values, and a lane holds 3 (D up to 768) or 4 (up to 1,024), so that
//     no register is spent on a chunk the row does not have; where D, the
//     base or the
//     row stride is not a 16-byte multiple, and in float32 and float64
//     (which only the card-vs-CPU checks run), a chunk is one value and a
//     lane holds 32. Lane l holds chunks l, l + lanes, ..., so a warp's
//     loads cover whole lines. A block of 256 threads walks a contiguous
//     range of rows, 256 / lanes of them at a time; gamma and beta sit in
//     shared memory, chunk-interleaved so that neighbouring lanes read
//     neighbouring words;
//   - forward: the mean, then the variance from the registers (two
//     passes; each sum a lane's values in order, then xor shuffles, which
//     give every lane of the row the same bits), rstd = rsqrt(var + eps),
//     y = (x - mean) * rstd * gamma + beta in the sums' precision, rounded
//     once to x's dtype. mean and rstd ([rows]) are stored only when the
//     caller keeps them for the backward. The bf16 and fp16 instances are
//     held to 64 registers, four blocks an SM (80 and three blocks: 72
//     against 66.5 us at ViT-B's shape);
//   - backward: x and dy held the same way; g = dy * gamma, x^ = (x -
//     mean) * rstd, dx = rstd * (g - mean(g) - x^ * mean(g * x^)), rounded
//     once to x's dtype. The parameters' gradients: each row slot of a
//     block adds dy * x^ and dy for its lanes' columns (in registers where
//     they fit, else in its own slice of shared memory: no two threads
//     share a column), the block adds its slots in order into one row of
//     partial sums [blocks][2][D], and a second small launch adds the
//     blocks' rows in order into [dgamma; dbeta]. No atomics: two calls
//     give the same bits, and a remat recompute the same forward. The
//     bf16 and fp16 instances read x, dy and gamma a second time for dx
//     (from L1) rather than hold them across the row's sums: at 3 chunks a
//     lane that fits 128 registers, two blocks an SM (held, 216 registers
//     and one block: 109 against 99 us at ViT-B's shape).
// Sums are f32 for bf16, fp16 and f32 inputs and float64 for float64 (the
// precision the card-vs-CPU checks run a model in); gamma, beta, mean,
// rstd and the parameters' gradients are in that precision too
// (ops/layernorm.py converts parameters of another dtype).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

enum : int { kBF16 = 0, kF16 = 1, kF32 = 2, kF64 = 3 };

constexpr int kThreads = 256;       // ops/layernorm.py THREADS
constexpr int kWarp = 32;
constexpr int kChunkBytes = 16;
constexpr int kChunks3 = 3;         // ops/layernorm.py CHUNKS: 16-byte
constexpr int kChunks4 = 4;         // chunks a lane, bf16 and fp16
constexpr int kScalar = 32;         // SCALAR_CHUNKS: values a lane, kVec 1
constexpr int kSumThreadsX = 32;    // the sum launch: columns a block
constexpr int kSumThreadsY = 8;     // and rows of partials it walks at once
constexpr int kSmemMax = 232448;    // dynamic shared memory a block can use
constexpr int kMaxDevices = 16;

template <int kType> struct Elem;
template <> struct Elem<kBF16> { using T = __nv_bfloat16; using A = float; };
template <> struct Elem<kF16> { using T = __half; using A = float; };
template <> struct Elem<kF32> { using T = float; using A = float; };
template <> struct Elem<kF64> { using T = double; using A = double; };

__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T, typename A>
__device__ __forceinline__ T from_acc(A v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(v);
  } else {
    return v;
  }
}

__device__ __forceinline__ float rsqrt_of(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_of(double v) {
  return rsqrt(v);
}
__device__ __forceinline__ float fma_of(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_of(double a, double b, double c) {
  return fma(a, b, c);
}

// kVec values of one 16-byte access (or one value)
template <typename T, int kVec>
struct Pack {
  T v[kVec];
};

template <typename T, int kVec>
__device__ __forceinline__ void load_pack(const T* p, Pack<T, kVec>& out) {
  if constexpr (kVec == 1) {
    out.v[0] = *p;
  } else {
    static_assert(sizeof(T) * kVec == kChunkBytes, "a chunk is 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(&out, &u, kChunkBytes);
  }
}

template <typename T, int kVec>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, kVec>& in) {
  if constexpr (kVec == 1) {
    *p = in.v[0];
  } else {
    uint4 u;
    memcpy(&u, &in, kChunkBytes);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// a 16-byte access read again (from L1, where the row still is), opaque to
// the compiler: it would otherwise keep the first read's values, and what
// was computed from them, in registers across the row's sums
template <typename T>
__device__ __forceinline__ void reload_pack(const T* p, Pack<T, 8>& out) {
  uint4 u;
  asm volatile("ld.global.ca.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  memcpy(&out, &u, kChunkBytes);
}

// the sum over a row's `lanes` lanes (an aligned power-of-two group of the
// warp; every lane of the warp takes part), the same bits in each lane
template <typename A>
__device__ __forceinline__ A row_sum(A v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Where a block's rows are: [begin, end) of `rows`, walked `slots` at a
// time, slot s on rows begin + s, begin + s + slots, ...
struct Rows {
  long long begin;
  long long end;
};

__device__ __forceinline__ Rows block_rows(long long rows,
                                           long long rows_per_block) {
  const long long begin = blockIdx.x * rows_per_block;
  const long long end = begin + rows_per_block < rows
      ? begin + rows_per_block : rows;
  return {begin, end};
}

// n values of p, chunk-interleaved into s: value j of chunk c (column c *
// kVec + j) at s[j * nc + c], so that lane c of a row reads bank c
template <int kVec, typename A>
__device__ __forceinline__ void stage_interleaved(const A* __restrict__ p,
                                                  A* s, int d) {
  const int nc = d / kVec;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    s[(i % kVec) * nc + i / kVec] = p[i];
  }
}

}  // namespace

template <int kType, int kVec, int kChunks>
__global__ void __launch_bounds__(kThreads, kVec > 1 ? 4 : 1)
    layernorm_fwd_sm90_kernel(
        const typename Elem<kType>::T* __restrict__ x,
        const typename Elem<kType>::A* __restrict__ gamma,
        const typename Elem<kType>::A* __restrict__ beta,
        typename Elem<kType>::T* __restrict__ y,
        typename Elem<kType>::A* __restrict__ mean_out,
        typename Elem<kType>::A* __restrict__ rstd_out, long long rows,
        int d, long long stride, int lanes, long long rows_per_block,
        typename Elem<kType>::A eps) {
  using T = typename Elem<kType>::T;
  using A = typename Elem<kType>::A;
  extern __shared__ __align__(16) unsigned char smem[];
  A* sg = reinterpret_cast<A*>(smem);   // gamma, then beta, interleaved
  A* sb = sg + d;
  stage_interleaved<kVec>(gamma, sg, d);
  stage_interleaved<kVec>(beta, sb, d);
  __syncthreads();
  const int nc = d / kVec;
  const int lane = threadIdx.x & (lanes - 1);
  const int slots = kThreads / lanes;
  const Rows R = block_rows(rows, rows_per_block);
  for (long long base = R.begin; base < R.end; base += slots) {
    const long long row = base + threadIdx.x / lanes;
    const bool live = row < R.end;
    const T* xr = x + (live ? row : 0) * stride;
    Pack<T, kVec> v[kChunks];
    A sum = A(0);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (live && c < nc) {
        load_pack(xr + c * kVec, v[k]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) sum += to_acc(v[k].v[j]);
      }
    }
    const A mean = row_sum(sum, lanes) / A(d);
    A sq = A(0);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (live && c < nc) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const A t = to_acc(v[k].v[j]) - mean;
          sq = fma_of(t, t, sq);
        }
      }
    }
    const A rstd = rsqrt_of(row_sum(sq, lanes) / A(d) + eps);
    if (!live) continue;
    T* yr = y + row * d;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (c < nc) {
        Pack<T, kVec> o;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const A xh = (to_acc(v[k].v[j]) - mean) * rstd;
          o.v[j] = from_acc<T>(fma_of(xh, sg[j * nc + c], sb[j * nc + c]));
        }
        store_pack(yr + c * kVec, o);
      }
    }
    if (lane == 0 && mean_out) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// dx and the block's row of partial sums [2][d] (sum dy * x^, sum dy over
// its rows, in column order) into partial[blockIdx.x]
template <int kType, int kVec, int kChunks>
__global__ void __launch_bounds__(kThreads, kVec > 1 && kChunks == 3 ? 2 : 1)
    layernorm_bwd_sm90_kernel(
        const typename Elem<kType>::T* __restrict__ x,
        const typename Elem<kType>::T* __restrict__ dy,
        const typename Elem<kType>::A* __restrict__ mean,
        const typename Elem<kType>::A* __restrict__ rstd,
        const typename Elem<kType>::A* __restrict__ gamma,
        typename Elem<kType>::T* __restrict__ dx,
        typename Elem<kType>::A* __restrict__ partial, long long rows, int d,
        long long x_stride, long long dy_stride, int lanes,
        long long rows_per_block) {
  using T = typename Elem<kType>::T;
  using A = typename Elem<kType>::A;
  // the parameters' sums of a lane's columns held in registers where they
  // fit (up to 128 bytes of them: bf16 and fp16, and float32's 32 values),
  // else (float64) added row by row into the slot's slice of shared
  // memory
  constexpr bool kInRegisters = kChunks * kVec * sizeof(A) <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = d / kVec;
  const int slots = kThreads / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  A* sg = reinterpret_cast<A*>(smem);   // gamma, interleaved
  A* sums = sg + d;                     // [slots][2][d], interleaved
  A* mine = sums + slot * 2 * d;
  stage_interleaved<kVec>(gamma, sg, d);
  if constexpr (!kInRegisters) {
    for (int i = threadIdx.x; i < slots * 2 * d; i += kThreads) {
      sums[i] = A(0);
    }
  }
  __syncthreads();
  A acc_xh[kInRegisters ? kChunks : 1][kInRegisters ? kVec : 1];
  A acc_dy[kInRegisters ? kChunks : 1][kInRegisters ? kVec : 1];
  if constexpr (kInRegisters) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc_xh[k][j] = acc_dy[k][j] = A(0);
    }
  }
  const Rows R = block_rows(rows, rows_per_block);
  for (long long base = R.begin; base < R.end; base += slots) {
    const long long row = base + slot;
    const bool live = row < R.end;
    const T* xr = x + (live ? row : 0) * x_stride;
    const T* gr = dy + (live ? row : 0) * dy_stride;
    Pack<T, kVec> xv[kChunks], gv[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (live && c < nc) {
        load_pack(xr + c * kVec, xv[k]);
        load_pack(gr + c * kVec, gv[k]);
      }
    }
    const A m = live ? mean[row] : A(0);
    const A rs = live ? rstd[row] : A(0);
    A s_g = A(0), s_gx = A(0);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (live && c < nc) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const A xh = (to_acc(xv[k].v[j]) - m) * rs;
          const A g = to_acc(gv[k].v[j]);
          const A gg = g * sg[j * nc + c];
          s_g += gg;
          s_gx = fma_of(gg, xh, s_gx);
          if constexpr (kInRegisters) {
            acc_xh[k][j] = fma_of(g, xh, acc_xh[k][j]);
            acc_dy[k][j] += g;
          } else {
            mine[j * nc + c] = fma_of(g, xh, mine[j * nc + c]);
            mine[d + j * nc + c] += g;
          }
        }
      }
    }
    const A a = row_sum(s_g, lanes) / A(d);
    const A b = row_sum(s_gx, lanes) / A(d);
    if (!live) continue;
    T* dxr = dx + row * d;
    // the vector instances read x, dy and gamma again rather than hold
    // them (the note at the top)
    const volatile A* sg2 = sg;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (c < nc) {
        Pack<T, kVec> xa, ga, o;
        if constexpr (kVec > 1) {
          reload_pack(xr + c * kVec, xa);
          reload_pack(gr + c * kVec, ga);
        } else {
          xa = xv[k];
          ga = gv[k];
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const A xh = (to_acc(xa.v[j]) - m) * rs;
          const A gg = to_acc(ga.v[j]) * (kVec > 1 ? sg2[j * nc + c]
                                                   : sg[j * nc + c]);
          o.v[j] = from_acc<T>(rs * (gg - a - xh * b));
        }
        store_pack(dxr + c * kVec, o);
      }
    }
  }
  if constexpr (kInRegisters) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = lane + k * lanes;
      if (c < nc) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          mine[j * nc + c] = acc_xh[k][j];
          mine[d + j * nc + c] = acc_dy[k][j];
        }
      }
    }
  }
  __syncthreads();
  // the block's slots in order, into its row of partials in column order
  A* out = partial + static_cast<long long>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += kThreads) {
    A s = A(0);
    for (int t = 0; t < slots; ++t) s += sums[t * 2 * d + i];
    const int half = i / d;
    const int r = i - half * d;
    out[half * d + (r % nc) * kVec + r / nc] = s;
  }
}

// out[i] = the sum of partial[b][i] over the blocks b in order; i < n
template <typename A>
__global__ void __launch_bounds__(kSumThreadsX * kSumThreadsY)
    layernorm_bwd_sum_sm90_kernel(const A* __restrict__ partial,
                                  A* __restrict__ out, int blocks, int n) {
  __shared__ A red[kSumThreadsY][kSumThreadsX];
  const int tx = threadIdx.x % kSumThreadsX;
  const int ty = threadIdx.x / kSumThreadsX;
  const int i = blockIdx.x * kSumThreadsX + tx;
  A s = A(0);
  if (i < n) {
    for (int b = ty; b < blocks; b += kSumThreadsY) {
      s += partial[static_cast<long long>(b) * n + i];
    }
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && i < n) {
    for (int t = 1; t < kSumThreadsY; ++t) s += red[t][tx];
    out[i] = s;
  }
}

namespace {

template <int kValue>
using Int = std::integral_constant<int, kValue>;

int elem_bytes(int type) {
  return type == kF64 ? 8 : type == kF32 ? 4 : 2;
}

int acc_bytes(int type) { return type == kF64 ? 8 : 4; }

int fwd_smem(int type, int d) { return 2 * d * acc_bytes(type); }

int bwd_smem(int type, int d, int lanes) {
  return (1 + 2 * (kThreads / lanes)) * d * acc_bytes(type);
}

// calls fn(type, vec, chunks) with the instance's integral constants; false
// where no instance takes them
template <typename Fn>
bool dispatch(int type, int vec, int chunks, Fn&& fn) {
  auto with = [&](auto t) {
    constexpr int kType = decltype(t)::value;
    if constexpr (kType == kBF16 || kType == kF16) {
      if (vec == 8 && chunks == kChunks3) {
        fn(t, Int<8>{}, Int<kChunks3>{});
        return true;
      }
      if (vec == 8 && chunks == kChunks4) {
        fn(t, Int<8>{}, Int<kChunks4>{});
        return true;
      }
    }
    if (vec == 1 && chunks == kScalar) {
      fn(t, Int<1>{}, Int<kScalar>{});
      return true;
    }
    return false;
  };
  switch (type) {
    case kBF16: return with(Int<kBF16>{});
    case kF16: return with(Int<kF16>{});
    case kF32: return with(Int<kF32>{});
    case kF64: return with(Int<kF64>{});
    default: return false;
  }
}

// The arguments the kernels take (ops/layernorm.py plan_layernorm lays them
// out): a row of d >= 1 values in nc = d / vec chunks, lanes a power of two
// up to 32 with lanes * chunks >= nc, and blocks x rows_per_block covering
// rows with no empty block.
bool bad_plan(long long rows, int d, int type, int vec, int lanes,
              int chunks, int blocks, long long rows_per_block) {
  if (type < kBF16 || type > kF64 || rows < 1 || d < 1 || lanes < 1 ||
      lanes > kWarp || (lanes & (lanes - 1)) || blocks < 1 ||
      rows_per_block < 1 || vec < 1 || d % vec) {
    return true;
  }
  const long long nc = d / vec;
  return static_cast<long long>(lanes) * chunks < nc ||
         static_cast<long long>(blocks) * rows_per_block < rows ||
         static_cast<long long>(blocks - 1) * rows_per_block >= rows;
}

// a vector instance's 16-byte accesses need each streamed tensor's base
// and row stride 16-byte aligned
bool misaligned(int type, int vec, const void* p, long long stride) {
  if (vec == 1) return false;
  return (reinterpret_cast<uintptr_t>(p) & 15) ||
         (stride * elem_bytes(type)) % kChunkBytes;
}

// Lifts the kernel's dynamic shared memory limit to at least `bytes`, once
// per device (`limit` holds what each device has).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int (&limit)[kMaxDevices], int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && limit[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) limit[dev] = bytes;
  return err;
}

template <int kType, int kVec, int kChunks>
struct Kernels {
  static int fwd_limit[kMaxDevices];
  static int bwd_limit[kMaxDevices];
};
template <int kType, int kVec, int kChunks>
int Kernels<kType, kVec, kChunks>::fwd_limit[kMaxDevices];
template <int kType, int kVec, int kChunks>
int Kernels<kType, kVec, kChunks>::bwd_limit[kMaxDevices];

}  // namespace

// The launches return cudaGetLastError() after them, or -1 for arguments
// the kernels do not take (before any launch). type: kBF16 0, kF16 1, kF32
// 2, kF64 3, the dtype of x, dy, y and dx; gamma, beta, mean, rstd, the
// partials and [dgamma; dbeta] are f32 (float64 for kF64). x is [rows, d]
// with row stride x_stride (dy dy_stride), y and dx contiguous. vec (a
// chunk's values: 8 in bf16 and fp16, or 1), lanes a row, chunks (the
// instance: 4 with vec 8, 32 with vec 1), blocks of 256
// threads and rows_per_block are ops/layernorm.py plan_layernorm's.

// The blocks of an instance that fit on one SM at once, into *out.
extern "C" int embn_layernorm_blocks_per_sm(int type, int vec, int lanes,
                                            int chunks, int d, int backward,
                                            int* out) {
  if (!out || lanes < 1 || d < 1) return -1;
  const int bytes = backward ? bwd_smem(type, d, lanes) : fwd_smem(type, d);
  if (bytes > kSmemMax) return -1;
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch(type, vec, chunks, [&](auto t, auto v, auto c) {
    constexpr int kT = decltype(t)::value;
    constexpr int kV = decltype(v)::value;
    constexpr int kC = decltype(c)::value;
    using K = Kernels<kT, kV, kC>;
    if (backward) {
      auto kernel = layernorm_bwd_sm90_kernel<kT, kV, kC>;
      err = allow_smem(kernel, K::bwd_limit, bytes);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            kThreads, bytes);
      }
    } else {
      auto kernel = layernorm_fwd_sm90_kernel<kT, kV, kC>;
      err = allow_smem(kernel, K::fwd_limit, bytes);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            kThreads, bytes);
      }
    }
  });
  if (!ok) return -1;
  return static_cast<int>(err);
}

// y = (x - mean) * rstd * gamma + beta; mean and rstd ([rows]) written
// where both are given.
extern "C" int embn_layernorm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, long long rows,
                                  long long x_stride,
                                  long long rows_per_block, int d, int type,
                                  int vec, int lanes, int chunks, int blocks,
                                  double eps, void* stream) {
  const int bytes = fwd_smem(type, d);
  if (bad_plan(rows, d, type, vec, lanes, chunks, blocks, rows_per_block) ||
      !x || !gamma || !beta || !y || (!mean != !rstd) || x_stride < d ||
      misaligned(type, vec, x, x_stride) || misaligned(type, vec, y, d) ||
      bytes > kSmemMax) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch(type, vec, chunks, [&](auto t, auto v, auto c) {
    constexpr int kT = decltype(t)::value;
    constexpr int kV = decltype(v)::value;
    constexpr int kC = decltype(c)::value;
    using T = typename Elem<kT>::T;
    using A = typename Elem<kT>::A;
    auto kernel = layernorm_fwd_sm90_kernel<kT, kV, kC>;
    err = allow_smem(kernel, Kernels<kT, kV, kC>::fwd_limit, bytes);
    if (err != cudaSuccess) return;
    kernel<<<blocks, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const A*>(gamma),
        static_cast<const A*>(beta), static_cast<T*>(y),
        static_cast<A*>(mean), static_cast<A*>(rstd), rows, d, x_stride,
        lanes, rows_per_block, static_cast<A>(eps));
    err = cudaGetLastError();
  });
  if (!ok) return -1;
  return static_cast<int>(err);
}

// dx and [dgamma; dbeta] (2 * d values) from x, dy, the forward's mean and
// rstd, and gamma; partial holds blocks * 2 * d values.
extern "C" int embn_layernorm_bwd(const void* x, const void* dy,
                                  const void* mean, const void* rstd,
                                  const void* gamma, void* dx, void* partial,
                                  void* dparams, long long rows,
                                  long long x_stride, long long dy_stride,
                                  long long rows_per_block, int d, int type,
                                  int vec, int lanes, int chunks, int blocks,
                                  void* stream) {
  if (bad_plan(rows, d, type, vec, lanes, chunks, blocks, rows_per_block) ||
      !x || !dy || !mean || !rstd || !gamma || !dx || !partial ||
      !dparams || x_stride < d || dy_stride < d ||
      misaligned(type, vec, x, x_stride) ||
      misaligned(type, vec, dy, dy_stride) || misaligned(type, vec, dx, d)) {
    return -1;
  }
  const int bytes = bwd_smem(type, d, lanes);
  if (bytes > kSmemMax) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch(type, vec, chunks, [&](auto t, auto v, auto c) {
    constexpr int kT = decltype(t)::value;
    constexpr int kV = decltype(v)::value;
    constexpr int kC = decltype(c)::value;
    using T = typename Elem<kT>::T;
    using A = typename Elem<kT>::A;
    auto kernel = layernorm_bwd_sm90_kernel<kT, kV, kC>;
    err = allow_smem(kernel, Kernels<kT, kV, kC>::bwd_limit, bytes);
    if (err != cudaSuccess) return;
    kernel<<<blocks, kThreads, bytes, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy),
        static_cast<const A*>(mean), static_cast<const A*>(rstd),
        static_cast<const A*>(gamma), static_cast<T*>(dx),
        static_cast<A*>(partial), rows, d, x_stride, dy_stride, lanes,
        rows_per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return;
    const int n = 2 * d;
    layernorm_bwd_sum_sm90_kernel<A>
        <<<(n + kSumThreadsX - 1) / kSumThreadsX,
           kSumThreadsX * kSumThreadsY, 0, s>>>(
            static_cast<const A*>(partial), static_cast<A*>(dparams), blocks,
            n);
    err = cudaGetLastError();
  });
  if (!ok) return -1;
  return static_cast<int>(err);
}
