// Train-mode BatchNorm for Hopper (sm_90a): the batch statistics with the
// effective affine and the running averages, the affine itself, and their
// backward, over an activation of N*H*W rows and C channels.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into the convolutions around it. In the port it was some twenty
// eager f32 PyTorch ops a layer forward and as many backward (casts, means,
// per-channel ops, the affine), streaming full-size f32 copies; these
// kernels do the same arithmetic (Flax's: the biased variance E[x^2] -
// E[x]^2 clamped at 0, its momentum, its running variance) in four
// launches a layer, two forward and two backward.
//
// What bounds them on an H100: bytes. The statistics read x once, the affine
// reads x and writes y, the backward's sums read x and dy, and dx reads x
// and dy and writes dx: at 3.35 TB/s, 0.6 us per MB moved. The design moves
// those bytes in the widest accesses, with enough of them in flight:
//   - the data is channels_last, a row-major [rows, C] matrix, so the
//     per-channel sums are column sums. A thread owns 8 channels (one
//     16-byte load of bf16, two of f32) of a slab of at most 8 * 8 channels
//     (one 128-byte line of a bf16 row) and walks the block's rows with a
//     stride of 256 / tx, kUnroll rows in flight, sums of f32 in registers;
//     a warp's loads cover whole lines;
//   - the grid is (groups of rows) x (slabs of channels), about four blocks
//     an SM and at most 256 groups (ops/batchnorm.py, plan_batchnorm): the
//     same code serves a 1,048,576 x 64 stem and a 4,096 x 2,048 stage-4
//     layer. Narrow slabs keep the partial sums a slab's last block adds
//     small: at most 256 rows of 64 channels, 8 a thread;
//   - a block sums its threads' registers in shared memory by a fixed tree
//     and writes one row of partial sums; the last block of a slab to finish
//     (an atomic ticket after __threadfence) adds the groups' partials in a
//     fixed order, so the sums are bitwise repeatable, and finishes each
//     channel there: the mean, the variance, scale = gamma * rsqrt(var +
//     eps), bias = beta - mean * scale and the running averages (forward),
//     or dgamma, dbeta and the coefficients of dx = a * dy + b * (x - mean)
//     + c (backward). Every per-channel op of the eager path is in that one
//     launch. With a data-parallel world the kernel writes the two sums
//     instead; the ranks all-reduce them and bn_finalize_sm90_kernel, one
//     thread a channel, finishes the channels;
//   - the affine and dx are one streaming pass each, the per-channel
//     numbers held in registers.
// Edges: a C that is not a multiple of 8, a base address that is not
// 16-byte aligned, or a contiguous NCHW tensor (taken through its strides:
// NASNet's stem adjusts feed one) run the same kernels one channel a
// thread (kVec 1 instances), correct and slower; every backbone of the port
// feeds channels_last with C a multiple of 8 but NASNet's and the
// Inceptions' odd widths. Inputs bf16 or f32, summed in f32; or float64 (a
// module converted with .double(), the precision the card-vs-CPU checks
// run in), one channel a thread, every sum and per-channel number in
// float64. Any C >= 1 and 1 <= rows < 2^31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // ops/batchnorm.py THREADS
constexpr int kVec = 8;        // ops/batchnorm.py VECTOR: channels a thread
constexpr int kUnroll = 4;     // ops/batchnorm.py UNROLL: rows in flight

// What the per-channel finish does (ops/batchnorm.py keeps the same bits).
constexpr int kBackward = 1;   // the backward's numbers, else the forward's
constexpr int kTrain = 2;      // batch statistics, else the running ones
constexpr int kUpdate = 4;     // lerp the running averages, count the batch
constexpr int kDirect = 8;     // backward: a = scale (BatchNorm), else 0
constexpr int kSums = 16;      // write the two sums alone (for a world)

// dtype codes of the inputs, outputs and parameters (ops/batchnorm.py)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF64 = 2;

using bf16 = __nv_bfloat16;

// the type sums and per-channel numbers are kept in: float64 for float64
// data, else f32
template <typename X>
using Acc = std::conditional_t<std::is_same_v<X, double>, double, float>;

struct Layout {
  long long rows;     // N * H * W
  long long spatial;  // H * W
  int c;
  int nchw;           // 1: contiguous NCHW; 0: channels_last
};

struct Plan {
  long long rows_per_block;
  int tx;             // threads along the channels; 256 / tx rows of them
};

// The per-channel finish. Forward: out [4][c] = mean, the variance before
// the clamp, scale, bias (f32). Backward: out [4][c] = a, b, c, mean of
// dx = a * dy + b * (x - mean) + c, from stat, the forward's [4][c]; the
// two sums are (sum dy, sum dy * x) of BatchNorm or the incoming (dbias,
// dscale) of BNScaleBias, both local (dgamma, dbeta) and global (the
// coefficients). Parameters and running averages are f32, bf16 or f64;
// out, stat and the sums are A.
template <typename A>
struct Fin {
  A* out;
  const A* stat;
  const void* gamma;
  const void* beta;
  void* running_mean;
  void* running_var;
  long long* tracked;
  void* dgamma;
  void* dbeta;
  A eps;
  A momentum;         // torch's: the batch's weight in the running average
  A count;            // the rows the statistics cover (all ranks')
  int c;
  int param_type;     // kF32, kBF16 or kF64
  int flags;
};

template <typename A>
__device__ __forceinline__ A to_acc(float v) { return v; }
template <typename A>
__device__ __forceinline__ A to_acc(double v) { return v; }
template <typename A>
__device__ __forceinline__ A to_acc(bf16 v) { return __bfloat162float(v); }

template <typename T, typename A>
__device__ __forceinline__ T from_acc(A v) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __float2bfloat16_rn(static_cast<float>(v));
  } else {
    return static_cast<T>(v);
  }
}

// correctly rounded arithmetic in A, so that no fused multiply-add changes
// what eager PyTorch's separate ops round
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
// f32: rsqrtf (2 ulp); float64: 1 / sqrt, both correctly rounded, as the
// CPU's torch.rsqrt computes it
__device__ __forceinline__ float rsqrt_of(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_of(double v) {
  return __ddiv_rn(1.0, __dsqrt_rn(v));
}
__device__ __forceinline__ float fma_of(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_of(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float max_of(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_of(double a, double b) {
  return fmax(a, b);
}

template <typename A>
__device__ __forceinline__ A param(const void* p, int i, int type) {
  if (type == kBF16) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (type == kF64) return static_cast<A>(static_cast<const double*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <typename A>
__device__ __forceinline__ void set_param(void* p, int i, int type, A v) {
  if (type == kBF16) {
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(static_cast<float>(v));
  } else if (type == kF64) {
    static_cast<double*>(p)[i] = v;
  } else {
    static_cast<float*>(p)[i] = static_cast<float>(v);
  }
}

// the value as the parameters' dtype holds it (eager's .to(dtype))
template <typename A>
__device__ __forceinline__ A rounded(A v, int type) {
  if (type == kBF16) {
    return __bfloat162float(__float2bfloat16_rn(static_cast<float>(v)));
  }
  return type == kF32 ? static_cast<A>(static_cast<float>(v)) : v;
}

// torch.lerp's formula, its weight a scalar
template <typename A>
__device__ __forceinline__ A lerp(A self, A end, A w) {
  return (w < A(0.5) && w > A(-0.5)) ? self + w * (end - self)
                                     : end - (end - self) * (A(1) - w);
}

// rows < 2^31 (the entry points refuse more), so the NCHW path's division
// is a 32-bit one, inline
__device__ __forceinline__ long long offset(const Layout& L, long long r,
                                            int c) {
  if (!L.nchw) return r * L.c + c;
  const unsigned s = static_cast<unsigned>(L.spatial);
  const unsigned n = static_cast<unsigned>(r) / s;
  return (static_cast<long long>(n) * L.c + c) * s +
         (static_cast<unsigned>(r) - n * s);
}

// 8 channels from a 16-byte aligned address
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int V, typename T, typename A>
__device__ __forceinline__ void load_row(const T* p, const Layout& L,
                                         long long r, int c0, A (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_acc<A>(p[offset(L, r, c0)]);
  } else {
    load8(p + r * L.c + c0, v);
  }
}

template <int V, typename T, typename A>
__device__ __forceinline__ void store_row(T* p, const Layout& L, long long r,
                                          int c0, const A (&v)[V]) {
  if constexpr (V == 1) {
    p[offset(L, r, c0)] = from_acc<T>(v[0]);
  } else {
    store8(p + r * L.c + c0, v);
  }
}

template <typename A>
__device__ void finish_channel(const Fin<A>& f, int c, A s0, A s1, A g0,
                               A g1) {
  const int C = f.c;
  if (f.flags & kSums) {
    f.out[c] = s0;
    f.out[C + c] = s1;
    return;
  }
  const int pt = f.param_type;
  const A gamma = param<A>(f.gamma, c, pt);
  const bool train = f.flags & kTrain;
  if (!(f.flags & kBackward)) {
    A mean, var_raw, var;
    if (train) {
      mean = div_rn(g0, f.count);
      const A ex2 = div_rn(g1, f.count);
      var_raw = sub_rn(ex2, mul_rn(mean, mean));
      var = max_of(var_raw, A(0));
    } else {
      mean = param<A>(f.running_mean, c, pt);
      var_raw = var = param<A>(f.running_var, c, pt);
    }
    const A scale = mul_rn(rsqrt_of(add_rn(var, f.eps)), gamma);
    const A bias = sub_rn(param<A>(f.beta, c, pt), mul_rn(mean, scale));
    f.out[c] = mean;
    f.out[C + c] = var_raw;
    f.out[2 * C + c] = scale;
    f.out[3 * C + c] = bias;
    if (f.flags & kUpdate) {
      set_param(f.running_mean, c, pt,
                lerp(param<A>(f.running_mean, c, pt), rounded(mean, pt),
                     f.momentum));
      set_param(f.running_var, c, pt,
                lerp(param<A>(f.running_var, c, pt), rounded(var, pt),
                     f.momentum));
      if (c == 0) *f.tracked += 1;
    }
    return;
  }
  // backward: (s0, s1) = (dbias, dscale) of y = x * scale + bias, local;
  // (g0, g1) the same over the world
  const A mean = f.stat[c];
  const A var_raw = f.stat[C + c];
  const A var = train ? max_of(var_raw, A(0)) : var_raw;
  const A rstd = rsqrt_of(var + f.eps);
  const A scale = mul_rn(rstd, gamma);
  if (f.dgamma) set_param(f.dgamma, c, pt, rstd * (s1 - mean * s0));
  if (f.dbeta) set_param(f.dbeta, c, pt, s0);
  A b = 0, cc = 0;
  if (train) {
    // d var (through the clamp where it passed), d mean through bias;
    // var = E[x^2] - mean^2 gives d var / d x = 2 (x - mean) / count
    const A dvar = var_raw >= A(0)
        ? A(-0.5) * gamma * (g1 - mean * g0) * rstd * rstd * rstd : A(0);
    b = A(2) * dvar / f.count;
    cc = -scale * g0 / f.count;
  }
  f.out[c] = (f.flags & kDirect) ? scale : A(0);
  f.out[C + c] = b;
  f.out[2 * C + c] = cc;
  f.out[3 * C + c] = mean;
}

// The block's two sums for each of its V channels by a fixed tree over the
// rows' threads (row thread 0 ends with them), through shared memory; the
// threads past the last whole row (ty >= 256 / tx) hold zeros.
template <int V, typename A>
__device__ __forceinline__ void block_tree(A (&s0)[V], A (&s1)[V],
                                           A (*red)[kThreads], int tx_n,
                                           int ty) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[j][t] = s0[j];
    red[V + j][t] = s1[j];
  }
  __syncthreads();
  const int ty_n = kThreads / tx_n;
  int h = 1;
  while (2 * h < ty_n) h *= 2;
  for (; h > 0; h >>= 1) {
    if (ty < h && ty + h < ty_n) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s0[j] += red[j][t + h * tx_n];
        s1[j] += red[V + j][t + h * tx_n];
        red[j][t] = s0[j];
        red[V + j][t] = s1[j];
      }
    }
    __syncthreads();
  }
}

// sum x and x^2 (kGrad false) or dy and dy * x (kGrad true) over the rows,
// per channel, then finish the channels in the slab's last block
template <int V, bool kGrad, typename X, typename Y, typename A>
__device__ __forceinline__ void reduce_body(const X* __restrict__ x,
                                            const Y* __restrict__ dy,
                                            const Layout& L, const Plan& P,
                                            A* __restrict__ partial,
                                            int* __restrict__ tickets,
                                            const Fin<A>& f) {
  __shared__ A red[2 * V][kThreads];
  __shared__ int last;
  const int tx_n = P.tx;
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * V;
  const bool active = c0 < L.c && ty < ty_n;
  A s0[V], s1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s0[j] = s1[j] = A(0);
  const long long begin = blockIdx.x * P.rows_per_block;
  const long long end = begin + P.rows_per_block < L.rows
      ? begin + P.rows_per_block : L.rows;
  if (active) {
    long long r = begin + ty;
    for (; r + (kUnroll - 1) * ty_n < end; r += kUnroll * ty_n) {
      A a[kUnroll][V], g[kUnroll][V];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        load_row<V>(x, L, r + k * ty_n, c0, a[k]);
        if constexpr (kGrad) load_row<V>(dy, L, r + k * ty_n, c0, g[k]);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if constexpr (kGrad) {
            s0[j] += g[k][j];
            s1[j] = fma_of(g[k][j], a[k][j], s1[j]);
          } else {
            s0[j] += a[k][j];
            s1[j] = fma_of(a[k][j], a[k][j], s1[j]);
          }
        }
      }
    }
    for (; r < end; r += ty_n) {
      A a[V], g[V];
      load_row<V>(x, L, r, c0, a);
      if constexpr (kGrad) load_row<V>(dy, L, r, c0, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (kGrad) {
          s0[j] += g[j];
          s1[j] = fma_of(g[j], a[j], s1[j]);
        } else {
          s0[j] += a[j];
          s1[j] = fma_of(a[j], a[j], s1[j]);
        }
      }
    }
  }
  block_tree<V>(s0, s1, red, tx_n, ty);
  const long long C = L.c;
  if (ty == 0 && active) {
    A* p = partial + blockIdx.x * 2 * C + c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p[j] = s0[j];
      p[C + j] = s1[j];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + blockIdx.y, 1) ==
           static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the slab's last block: the groups' partials in a fixed order
#pragma unroll
  for (int j = 0; j < V; ++j) s0[j] = s1[j] = A(0);
  if (active) {
#pragma unroll 4
    for (int g = ty; g < static_cast<int>(gridDim.x); g += ty_n) {
      const A* p = partial + g * 2 * C + c0;
      if constexpr (V == kVec) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(p) + q);
          const float4 b = __ldcg(reinterpret_cast<const float4*>(p + C) + q);
          s0[4 * q] += a.x; s0[4 * q + 1] += a.y;
          s0[4 * q + 2] += a.z; s0[4 * q + 3] += a.w;
          s1[4 * q] += b.x; s1[4 * q + 1] += b.y;
          s1[4 * q + 2] += b.z; s1[4 * q + 3] += b.w;
        }
      } else {
        s0[0] += __ldcg(p);
        s1[0] += __ldcg(p + C);
      }
    }
  }
  block_tree<V>(s0, s1, red, tx_n, ty);
  if (ty == 0 && active) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c0 + j < L.c) finish_channel(f, c0 + j, s0[j], s1[j], s0[j], s1[j]);
    }
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

}  // namespace

template <int V, typename X>
__global__ void __launch_bounds__(kThreads)
    bn_stats_sm90_kernel(const X* __restrict__ x, Layout L, Plan P,
                         Acc<X>* __restrict__ partial,
                         int* __restrict__ tickets,
                         Fin<Acc<X>> f) {
  reduce_body<V, false, X, X>(x, nullptr, L, P, partial, tickets, f);
}

template <int V, typename X, typename Y>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_sm90_kernel(const X* __restrict__ x,
                              const Y* __restrict__ dy, Layout L, Plan P,
                              Acc<X>* __restrict__ partial,
                              int* __restrict__ tickets, Fin<Acc<X>> f) {
  reduce_body<V, true, X, Y>(x, dy, L, P, partial, tickets, f);
}

// y = cast(A(x) * scale + bias), the affine from the forward's stat or, in
// eval mode (stat null), from the running averages
template <int V, typename X, typename Y>
__global__ void __launch_bounds__(kThreads)
    bn_apply_sm90_kernel(const X* __restrict__ x, Y* __restrict__ y, Layout L,
                         Plan P, Fin<Acc<X>> f) {
  using A = Acc<X>;
  const int tx_n = P.tx;
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * V;
  if (c0 >= L.c || ty >= ty_n) return;
  const int C = L.c;
  A scale[V], bias[V];
  if (f.stat) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      scale[j] = f.stat[2 * C + c0 + j];
      bias[j] = f.stat[3 * C + c0 + j];
    }
  } else {
    const int pt = f.param_type;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j;
      scale[j] = mul_rn(
          rsqrt_of(add_rn(param<A>(f.running_var, c, pt), f.eps)),
          param<A>(f.gamma, c, pt));
      bias[j] = sub_rn(param<A>(f.beta, c, pt),
                       mul_rn(param<A>(f.running_mean, c, pt), scale[j]));
    }
  }
  const long long begin = blockIdx.x * P.rows_per_block;
  const long long end = begin + P.rows_per_block < L.rows
      ? begin + P.rows_per_block : L.rows;
  long long r = begin + ty;
  for (; r + (kUnroll - 1) * ty_n < end; r += kUnroll * ty_n) {
    A a[kUnroll][V];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      load_row<V>(x, L, r + k * ty_n, c0, a[k]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      A o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = add_rn(mul_rn(a[k][j], scale[j]), bias[j]);
      }
      store_row<V>(y, L, r + k * ty_n, c0, o);
    }
  }
  for (; r < end; r += ty_n) {
    A a[V];
    load_row<V>(x, L, r, c0, a);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = add_rn(mul_rn(a[j], scale[j]), bias[j]);
    }
    store_row<V>(y, L, r, c0, a);
  }
}

// dx = a * dy + b * (x - mean) + c, coef [4][C] = a, b, c, mean; dy null
// for BNScaleBias (a = 0)
template <int V, typename X, typename Y>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_dx_sm90_kernel(const X* __restrict__ x, const Y* __restrict__ dy,
                          X* __restrict__ dx, Layout L, Plan P,
                          const Acc<X>* __restrict__ coef) {
  using A = Acc<X>;
  const int tx_n = P.tx;
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n;
  const int ty = threadIdx.x / tx_n;
  const int c0 = (blockIdx.y * tx_n + tx) * V;
  if (c0 >= L.c || ty >= ty_n) return;
  const int C = L.c;
  A ca[V], cb[V], cc[V], cm[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ca[j] = coef[c0 + j];
    cb[j] = coef[C + c0 + j];
    cc[j] = coef[2 * C + c0 + j];
    cm[j] = coef[3 * C + c0 + j];
  }
  const bool with_dy = dy != nullptr;
  const long long begin = blockIdx.x * P.rows_per_block;
  const long long end = begin + P.rows_per_block < L.rows
      ? begin + P.rows_per_block : L.rows;
  long long r = begin + ty;
  for (; r + (kUnroll - 1) * ty_n < end; r += kUnroll * ty_n) {
    A a[kUnroll][V], g[kUnroll][V];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      load_row<V>(x, L, r + k * ty_n, c0, a[k]);
      if (with_dy) {
        load_row<V>(dy, L, r + k * ty_n, c0, g[k]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) g[k][j] = A(0);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[k][j] = fma_of(ca[j], g[k][j],
                         fma_of(cb[j], a[k][j] - cm[j], cc[j]));
      }
      store_row<V>(dx, L, r + k * ty_n, c0, a[k]);
    }
  }
  for (; r < end; r += ty_n) {
    A a[V], g[V];
    load_row<V>(x, L, r, c0, a);
    if (with_dy) {
      load_row<V>(dy, L, r, c0, g);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = A(0);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = fma_of(ca[j], g[j], fma_of(cb[j], a[j] - cm[j], cc[j]));
    }
    store_row<V>(dx, L, r, c0, a);
  }
}

// One thread a channel: the finish of a world's all-reduced sums (forward
// or backward), of BNScaleBias's incoming (dbias, dscale), or of the
// running averages (eval). (l0, l1) local, (g0, g1) global (null: the
// local ones); a null local is zeros.
template <typename A>
__global__ void __launch_bounds__(kThreads)
    bn_finalize_sm90_kernel(const A* __restrict__ l0,
                            const A* __restrict__ l1,
                            const A* __restrict__ g0,
                            const A* __restrict__ g1, Fin<A> f) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= f.c) return;
  const A a0 = l0 ? l0[c] : A(0);
  const A a1 = l1 ? l1[c] : A(0);
  finish_channel(f, c, a0, a1, g0 ? g0[c] : a0, g1 ? g1[c] : a1);
}

namespace {

template <typename T>
struct Tag { using type = T; };

// calls fn(vector width, X tag, Y tag) for the instance the dtype codes
// name: bf16 or f32 each, 8 or 1 channels a thread; or float64 both, one
// channel a thread. False for codes no instance takes.
template <typename Fn>
bool dispatch(int vec, int x_type, int y_type, Fn&& fn) {
  using One = std::integral_constant<int, 1>;
  if (x_type == kF64 || y_type == kF64) {
    if (x_type != kF64 || y_type != kF64 || vec != 1) return false;
    fn(One{}, Tag<double>{}, Tag<double>{});
    return true;
  }
  if ((x_type != kF32 && x_type != kBF16) ||
      (y_type != kF32 && y_type != kBF16)) {
    return false;
  }
  auto types = [&](auto v) {
    if (x_type == kBF16) {
      if (y_type == kBF16) fn(v, Tag<bf16>{}, Tag<bf16>{});
      else fn(v, Tag<bf16>{}, Tag<float>{});
    } else {
      if (y_type == kBF16) fn(v, Tag<float>{}, Tag<bf16>{});
      else fn(v, Tag<float>{}, Tag<float>{});
    }
  };
  if (vec == kVec) {
    types(std::integral_constant<int, kVec>{});
  } else if (vec == 1) {
    types(One{});
  } else {
    return false;
  }
  return true;
}

bool bad_plan(long long rows, long long spatial, int c, int nchw, int vec,
              int tx, int groups, int slabs, long long rows_per_block) {
  const bool tx_ok = tx >= 1 && tx <= kThreads;
  return rows < 1 || rows >= (1LL << 31) || spatial < 1 ||
         rows % spatial != 0 || c < 1 ||
         (nchw != 0 && nchw != 1) || (vec == kVec && (c % kVec || nchw)) ||
         !tx_ok || groups < 1 || slabs < 1 || slabs > 65535 ||
         rows_per_block < 1 || rows_per_block % (kThreads / tx) != 0 ||
         static_cast<long long>(groups) * rows_per_block < rows ||
         static_cast<long long>(groups - 1) * rows_per_block >= rows ||
         static_cast<long long>(slabs) * tx * vec < c ||
         static_cast<long long>(slabs - 1) * tx * vec >= c;
}

// a vector instance's 16-byte accesses need every streamed tensor aligned
bool misaligned(int vec, std::initializer_list<const void*> ptrs) {
  if (vec != kVec) return false;
  for (const void* p : ptrs) {
    if (p && (reinterpret_cast<uintptr_t>(p) & 15)) return true;
  }
  return false;
}

bool bad_param_type(int type) {
  return type != kF32 && type != kBF16 && type != kF64;
}

template <typename A>
Fin<A> make_fin(void* out, const void* stat, const void* gamma,
                const void* beta, void* running_mean, void* running_var,
                void* tracked, void* dgamma, void* dbeta, double eps,
                double momentum, double count, int c, int param_type,
                int flags) {
  Fin<A> f;
  f.out = static_cast<A*>(out);
  f.stat = static_cast<const A*>(stat);
  f.gamma = gamma;
  f.beta = beta;
  f.running_mean = running_mean;
  f.running_var = running_var;
  f.tracked = static_cast<long long*>(tracked);
  f.dgamma = dgamma;
  f.dbeta = dbeta;
  f.eps = static_cast<A>(eps);
  f.momentum = static_cast<A>(momentum);
  f.count = static_cast<A>(count);
  f.c = c;
  f.param_type = param_type;
  f.flags = flags;
  return f;
}

}  // namespace

// The launches below return cudaGetLastError() of the launch, or -1 for
// arguments the kernels do not take (before any launch). Geometry: rows =
// N*H*W, spatial = H*W, c, nchw (1: contiguous NCHW, else channels_last);
// plan (ops/batchnorm.py plan_batchnorm): vec (8 or 1 channels a thread),
// tx, groups x slabs blocks of 256 threads, rows_per_block; x_type, y_type
// and param_type the dtypes of the input, of the output or dy, and of the
// parameters and running averages (kF32 0, kBF16 1, kF64 2). `partial`
// holds groups * 2 * c sums, `tickets` slabs ints that are 0 (the last
// block of each slab sets its ticket back to 0). Every per-channel number
// (partial, out, stat, coef, the sums) is f32, or float64 where x is; eps,
// momentum and count are rounded to that type.

// Forward statistics of x: flags kTrain [| kUpdate] -> out [4][c] (mean,
// variance, scale, bias) and the running averages; or kSums -> out [2][c].
extern "C" int embn_bn_stats(const void* x, void* partial, void* tickets,
                             void* out, const void* gamma, const void* beta,
                             void* running_mean, void* running_var,
                             void* tracked, long long rows, long long spatial,
                             long long rows_per_block, int c, int nchw,
                             int vec, int tx, int groups, int slabs,
                             int x_type, int param_type, int flags,
                             double eps, double momentum, double count,
                             void* stream) {
  if (bad_plan(rows, spatial, c, nchw, vec, tx, groups, slabs,
               rows_per_block) || misaligned(vec, {x}) || !x || !partial ||
      !tickets || !out || (flags & kBackward) || bad_param_type(param_type) ||
      (!(flags & kSums) && (!(flags & kTrain) || !gamma || !beta)) ||
      ((flags & kUpdate) && (!running_mean || !running_var || !tracked))) {
    return -1;
  }
  const Layout L{rows, spatial, c, nchw};
  const Plan P{rows_per_block, tx};
  const dim3 grid(groups, slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(vec, x_type, x_type, [&](auto v, auto xt, auto) {
    using X = typename decltype(xt)::type;
    using A = Acc<X>;
    bn_stats_sm90_kernel<decltype(v)::value, X><<<grid, kThreads, 0, s>>>(
        static_cast<const X*>(x), L, P, static_cast<A*>(partial),
        static_cast<int*>(tickets),
        make_fin<A>(out, nullptr, gamma, beta, running_mean, running_var,
                    tracked, nullptr, nullptr, eps, momentum, count, c,
                    param_type, flags));
  });
  return ok ? static_cast<int>(cudaGetLastError()) : -1;
}

// y = x * scale + bias in y's dtype: the affine from stat ([4][c], the
// forward's), or with stat null from the running averages (eval).
extern "C" int embn_bn_apply(const void* x, void* y, const void* stat,
                             const void* gamma, const void* beta,
                             const void* running_mean,
                             const void* running_var, long long rows,
                             long long spatial, long long rows_per_block,
                             int c, int nchw, int vec, int tx, int groups,
                             int slabs, int x_type, int y_type,
                             int param_type, double eps, void* stream) {
  if (bad_plan(rows, spatial, c, nchw, vec, tx, groups, slabs,
               rows_per_block) || misaligned(vec, {x, y}) || !x || !y ||
      bad_param_type(param_type) ||
      (!stat && (!gamma || !beta || !running_mean || !running_var))) {
    return -1;
  }
  const Layout L{rows, spatial, c, nchw};
  const Plan P{rows_per_block, tx};
  const dim3 grid(groups, slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(vec, x_type, y_type, [&](auto v, auto xt, auto yt) {
    using X = typename decltype(xt)::type;
    using Y = typename decltype(yt)::type;
    bn_apply_sm90_kernel<decltype(v)::value, X, Y><<<grid, kThreads, 0, s>>>(
        static_cast<const X*>(x), static_cast<Y*>(y), L, P,
        make_fin<Acc<X>>(nullptr, stat, gamma, beta,
                         const_cast<void*>(running_mean),
                         const_cast<void*>(running_var), nullptr, nullptr,
                         nullptr, eps, 0.0, 0.0, c, param_type, 0));
  });
  return ok ? static_cast<int>(cudaGetLastError()) : -1;
}

// Backward sums of dy and dy * x: flags kBackward | kDirect [| kTrain] ->
// coef [4][c], dgamma and dbeta (either null where not wanted), from stat
// ([4][c], the forward's, or the running averages' from bn_finalize in
// eval mode); or kSums -> coef [2][c] (sum dy, sum dy * x).
extern "C" int embn_bn_bwd_reduce(const void* x, const void* dy,
                                  void* partial, void* tickets, void* coef,
                                  const void* stat, const void* gamma,
                                  void* dgamma, void* dbeta, long long rows,
                                  long long spatial, long long rows_per_block,
                                  int c, int nchw, int vec, int tx, int groups,
                                  int slabs, int x_type, int y_type,
                                  int param_type, int flags, double eps,
                                  double count, void* stream) {
  if (bad_plan(rows, spatial, c, nchw, vec, tx, groups, slabs,
               rows_per_block) || misaligned(vec, {x, dy}) || !x || !dy ||
      !partial || !tickets || !coef || bad_param_type(param_type) ||
      (!(flags & kSums) && (!(flags & kBackward) || !stat || !gamma))) {
    return -1;
  }
  const Layout L{rows, spatial, c, nchw};
  const Plan P{rows_per_block, tx};
  const dim3 grid(groups, slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(vec, x_type, y_type, [&](auto v, auto xt, auto yt) {
    using X = typename decltype(xt)::type;
    using Y = typename decltype(yt)::type;
    using A = Acc<X>;
    bn_bwd_reduce_sm90_kernel<decltype(v)::value, X, Y>
        <<<grid, kThreads, 0, s>>>(
            static_cast<const X*>(x), static_cast<const Y*>(dy), L, P,
            static_cast<A*>(partial), static_cast<int*>(tickets),
            make_fin<A>(coef, stat, gamma, nullptr, nullptr, nullptr,
                        nullptr, dgamma, dbeta, eps, 0.0, count, c,
                        param_type, flags));
  });
  return ok ? static_cast<int>(cudaGetLastError()) : -1;
}

// dx = a * dy + b * (x - mean) + c in x's dtype, coef [4][c]; dy (y's
// dtype) null where a = 0.
extern "C" int embn_bn_bwd_dx(const void* x, const void* dy, void* dx,
                              const void* coef, long long rows,
                              long long spatial, long long rows_per_block,
                              int c, int nchw, int vec, int tx, int groups,
                              int slabs, int x_type, int y_type,
                              void* stream) {
  if (bad_plan(rows, spatial, c, nchw, vec, tx, groups, slabs,
               rows_per_block) || misaligned(vec, {x, dy, dx}) || !x ||
      !dx || !coef) {
    return -1;
  }
  const Layout L{rows, spatial, c, nchw};
  const Plan P{rows_per_block, tx};
  const dim3 grid(groups, slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(vec, x_type, y_type, [&](auto v, auto xt, auto yt) {
    using X = typename decltype(xt)::type;
    using Y = typename decltype(yt)::type;
    bn_bwd_dx_sm90_kernel<decltype(v)::value, X, Y><<<grid, kThreads, 0, s>>>(
        static_cast<const X*>(x), static_cast<const Y*>(dy),
        static_cast<X*>(dx), L, P, static_cast<const Acc<X>*>(coef));
  });
  return ok ? static_cast<int>(cudaGetLastError()) : -1;
}

// One thread a channel, ceil(c / 256) blocks: the finish (flags as
// above, kSums excluded) from the sums (l0, l1) and (g0, g1) of [c] numbers,
// into out [4][c]; acc_type kF64 where those and out are float64, else f32.
extern "C" int embn_bn_finalize(const void* l0, const void* l1,
                                const void* g0, const void* g1, void* out,
                                const void* stat, const void* gamma,
                                const void* beta, void* running_mean,
                                void* running_var, void* tracked,
                                void* dgamma, void* dbeta, int c,
                                int acc_type, int param_type, int flags,
                                double eps, double momentum, double count,
                                void* stream) {
  const bool backward = flags & kBackward;
  if (c < 1 || !out || !gamma || (flags & kSums) ||
      (acc_type != kF32 && acc_type != kF64) || bad_param_type(param_type) ||
      (backward && !stat) || (!backward && !beta) ||
      (!backward && !(flags & kTrain) && (!running_mean || !running_var)) ||
      ((flags & kUpdate) && (!running_mean || !running_var || !tracked))) {
    return -1;
  }
  const int blocks = (c + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto tag) {
    using A = typename decltype(tag)::type;
    bn_finalize_sm90_kernel<A><<<blocks, kThreads, 0, s>>>(
        static_cast<const A*>(l0), static_cast<const A*>(l1),
        static_cast<const A*>(g0), static_cast<const A*>(g1),
        make_fin<A>(out, stat, gamma, beta, running_mean, running_var,
                    tracked, dgamma, dbeta, eps, momentum, count, c,
                    param_type, flags));
  };
  if (acc_type == kF64) {
    launch(Tag<double>{});
  } else {
    launch(Tag<float>{});
  }
  return static_cast<int>(cudaGetLastError());
}
