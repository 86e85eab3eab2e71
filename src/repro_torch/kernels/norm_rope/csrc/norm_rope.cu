// Row RMSNorm and rotary embedding for Hopper (sm_90a): one pass each.
//
// Replaces no Pallas kernel.  The JAX package leaves rms_norm and
// apply_rope (src/repro/models/layers.py) to XLA, which fuses each into
// one pass over its input; the port's eager PyTorch versions
// (repro_torch/models/layers.py) run them as chains of fp32 passes: nine
// launches a norm, eighteen a RoPE call, each pass over a fp32
// copy of the activations.
//
// Bound.  Both do a few operations an element, far below the H100's
// ridge point, so device-memory bytes bound them: each input element read
// once and each output element written once, in its own dtype.
//
// Design.  Everything between the load and the store stays in fp32
// registers, in the plain code's order of operations, each product and
// sum rounded once (the __f*_rn intrinsics keep nvcc from contracting
// them into FMAs the plain code does not do):
//  - rmsnorm_rows_kernel: a row's squares summed in fp32 (a warp shuffle,
//    then shared memory across the CTA's warps), r = rsqrt(sum * (1/n) +
//    eps), out = cast((x * r) * float(w)).  A row is read once, in 16-byte
//    vectors held in registers until the store (up to MAX_VPT a thread),
//    with scalar loads for the tail that no whole vector covers.  A row
//    gets as many warps as hold it at up to MAX_VPT vectors a thread
//    (more vectors a thread keep more bytes in flight: 8 ran at 1.4x the
//    speed of 2 on an H100); rows of one warp share a CTA.  A row that is
//    not 16-byte aligned, or too wide for the registers, is read twice
//    with scalar loads instead.
//  - rope_qk_kernel: one token's D/2 angles float(position) * inv_freq[i]
//    and their precise sincosf, computed once into shared memory and used
//    for all the token's query and key heads; the split-half rotation
//    x1*cos - x2*sin, x1*sin + x2*cos on 16-byte vectors of both halves.
// Inputs are read with their strides as they lie (unit stride along the
// last dimension); outputs are new contiguous tensors.  ops.py picks the
// launch shape; this file checks and launches it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_VPT = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// N consecutive elements of p (aligned to their size, up to 16 bytes) as
// floats, in one or more vector loads
template <typename W, int N>
__device__ __forceinline__ void load_f(const W* p, float (&out)[N]) {
  constexpr int BYTES = sizeof(W) * N;
  if constexpr (BYTES % 16 == 0) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int v = 0; v < BYTES / 16; ++v)
      raw[v] = reinterpret_cast<const uint4*>(p)[v];
    const W* e = reinterpret_cast<const W*>(raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  } else {
    static_assert(BYTES == 8, "a weight vector is 8 or 16k bytes");
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  }
}

// the sum of v over the row's threads (threadIdx.x), in every thread;
// blockDim.x is 32 or a multiple of it, and a CTA with more than one warp
// a row holds one row
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (blockDim.x <= 32) return v;
  __shared__ float part[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct NormArgs {
  const void* x;
  const void* w;
  void* y;
  long long rows;
  int n;               // row width
  long long n1, n2;    // the two inner leading sizes (rows = n0 * n1 * n2)
  long long s0, s1, s2;  // the three leading strides, in elements
  float eps;
  int vec;             // 1: 16-byte vectors, vpt of them a thread
  int vpt;
};

template <typename T, typename W>
__global__ void __launch_bounds__(512) rmsnorm_rows_kernel(NormArgs a) {
  constexpr int V = 16 / sizeof(T);
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  // uniform over a warp, and a CTA of several warps a row has one row
  if (r >= a.rows) return;
  const long long i2 = r % a.n2, t = r / a.n2;
  const T* x = static_cast<const T*>(a.x) + (t / a.n1) * a.s0 +
               (t % a.n1) * a.s1 + i2 * a.s2;
  T* y = static_cast<T*>(a.y) + r * a.n;
  const W* w = static_cast<const W*>(a.w);
  const int G = blockDim.x, lane = threadIdx.x;
  const float inv_n = 1.0f / static_cast<float>(a.n);
  float ss = 0.f;
  if (a.vec) {
    const int nv = a.n / V, tail_at = nv * V;
    uint4 raw[MAX_VPT];
#pragma unroll
    for (int k = 0; k < MAX_VPT; ++k) {
      const int i = lane + k * G;
      if (k < a.vpt && i < nv) {
        raw[k] = reinterpret_cast<const uint4*>(x)[i];
        const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f(e[j]);
          ss = __fadd_rn(ss, __fmul_rn(f, f));
        }
      }
    }
    const bool tail = tail_at + lane < a.n;
    float xt = 0.f;
    if (tail) {
      xt = to_f(x[tail_at + lane]);
      ss = __fadd_rn(ss, __fmul_rn(xt, xt));
    }
    const float inv = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss), inv_n), a.eps));
#pragma unroll
    for (int k = 0; k < MAX_VPT; ++k) {
      const int i = lane + k * G;
      if (k < a.vpt && i < nv) {
        const T* e = reinterpret_cast<const T*>(&raw[k]);
        float wf[V];
        load_f<W, V>(w + i * V, wf);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < V; ++j)
          oe[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(e[j]), inv), wf[j]));
        reinterpret_cast<uint4*>(y)[i] = o;
      }
    }
    if (tail)
      y[tail_at + lane] = from_f<T>(
          __fmul_rn(__fmul_rn(xt, inv), to_f(w[tail_at + lane])));
  } else {
    for (int i = lane; i < a.n; i += G) {
      const float f = to_f(x[i]);
      ss = __fadd_rn(ss, __fmul_rn(f, f));
    }
    const float inv = rsqrtf(__fadd_rn(__fmul_rn(row_sum(ss), inv_n), a.eps));
    for (int i = lane; i < a.n; i += G)
      y[i] = from_f<T>(__fmul_rn(__fmul_rn(to_f(x[i]), inv), to_f(w[i])));
  }
}

struct RopeArgs {
  const void* q;
  const void* k;         // null when only q is rotated (hk == 0)
  void* qo;
  void* ko;
  const void* pos;
  int pos_code;          // 0 int32, 1 int64
  const float* inv;      // [d / 2] inverse frequencies
  long long tokens;      // b * s
  int s, h, hk, d;
  long long q0, q1, q2;  // q's batch, sequence and head strides
  long long k0, k1, k2;
  long long p0, p1;      // positions' batch and sequence strides
  int vec;               // 1: 16-byte vectors of each half
};

template <typename T>
__global__ void __launch_bounds__(256) rope_qk_kernel(RopeArgs a) {
  extern __shared__ float2 table_all[];
  const int half = a.d / 2;
  float2* table = table_all + threadIdx.y * half;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = t < a.tokens;
  const long long b = live ? t / a.s : 0, s = live ? t % a.s : 0;
  const int G = blockDim.x, lane = threadIdx.x;
  if (live) {
    const long long at = b * a.p0 + s * a.p1;
    const float p =
        a.pos_code == 0
            ? static_cast<float>(static_cast<const int32_t*>(a.pos)[at])
            : static_cast<float>(static_cast<const long long*>(a.pos)[at]);
    for (int i = lane; i < half; i += G) {
      float sn, cs;
      sincosf(__fmul_rn(p, a.inv[i]), &sn, &cs);
      table[i] = make_float2(cs, sn);
    }
  }
  __syncthreads();
  if (!live) return;
  const int heads = a.h + a.hk;
  const int V = a.vec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int per_head = half / V;
  for (int task = lane; task < heads * per_head; task += G) {
    const int hh = task / per_head, c = (task % per_head) * V;
    const bool is_q = hh < a.h;
    const int head = is_q ? hh : hh - a.h;
    const T* src = is_q ? static_cast<const T*>(a.q) + b * a.q0 + s * a.q1 +
                              head * a.q2
                        : static_cast<const T*>(a.k) + b * a.k0 + s * a.k1 +
                              head * a.k2;
    T* dst = is_q ? static_cast<T*>(a.qo) + (t * a.h + head) * a.d
                  : static_cast<T*>(a.ko) + (t * a.hk + head) * a.d;
    if (a.vec) {
      constexpr int VV = 16 / sizeof(T);
      uint4 r1 = *reinterpret_cast<const uint4*>(src + c);
      uint4 r2 = *reinterpret_cast<const uint4*>(src + half + c);
      const T* e1 = reinterpret_cast<const T*>(&r1);
      const T* e2 = reinterpret_cast<const T*>(&r2);
      uint4 o1, o2;
      T* f1 = reinterpret_cast<T*>(&o1);
      T* f2 = reinterpret_cast<T*>(&o2);
#pragma unroll
      for (int j = 0; j < VV; ++j) {
        const float x1 = to_f(e1[j]), x2 = to_f(e2[j]);
        const float2 cs = table[c + j];
        f1[j] = from_f<T>(__fsub_rn(__fmul_rn(x1, cs.x), __fmul_rn(x2, cs.y)));
        f2[j] = from_f<T>(__fadd_rn(__fmul_rn(x1, cs.y), __fmul_rn(x2, cs.x)));
      }
      *reinterpret_cast<uint4*>(dst + c) = o1;
      *reinterpret_cast<uint4*>(dst + half + c) = o2;
    } else {
      const float x1 = to_f(src[c]), x2 = to_f(src[half + c]);
      const float2 cs = table[c];
      dst[c] = from_f<T>(__fsub_rn(__fmul_rn(x1, cs.x), __fmul_rn(x2, cs.y)));
      dst[half + c] =
          from_f<T>(__fadd_rn(__fmul_rn(x1, cs.y), __fmul_rn(x2, cs.x)));
    }
  }
}

template <typename T>
cudaError_t norm_launch(int w_code, const NormArgs& a, dim3 grid, dim3 block,
                        cudaStream_t st) {
  if (w_code == 0)
    rmsnorm_rows_kernel<T, float><<<grid, block, 0, st>>>(a);
  else if (w_code == 1)
    rmsnorm_rows_kernel<T, __nv_bfloat16><<<grid, block, 0, st>>>(a);
  else
    rmsnorm_rows_kernel<T, __half><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// y [rows, n] (contiguous) = rms_norm of x's rows; x's rows at offsets
// i0*s0 + i1*s1 + i2*s2 for the row (i0, i1, i2) of the leading sizes
// (rows / (n1*n2), n1, n2).  Dtype codes: 0 f32, 1 bf16, 2 f16, for x and
// y (x_code) and for w (w_code).  `threads` a row (32 or a multiple of it,
// at most 512) and `rows_per_cta` (1 unless threads == 32); with vec,
// x's rows, w and y are 16-byte aligned and `vpt` 16-byte vectors a
// thread (at most 8) cover the row.  Returns the launch's CUDA error.
extern "C" int rms_norm_launch(const void* x, const void* w, void* y,
                               int x_code, int w_code, long long rows, int n,
                               long long n1, long long n2, long long s0,
                               long long s1, long long s2, float eps, int vec,
                               int vpt, int threads, int rows_per_cta,
                               void* stream) {
  if (rows < 1 || n < 1 || n1 < 1 || n2 < 1 || threads < 32 ||
      threads > 512 || threads % 32 || rows_per_cta < 1 ||
      threads * rows_per_cta > 512 || (threads > 32 && rows_per_cta != 1) ||
      (vec && (vpt < 1 || vpt > MAX_VPT)) || x_code < 0 || x_code > 2 ||
      w_code < 0 || w_code > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  NormArgs a{x, w, y, rows, n, n1, n2, s0, s1, s2, eps, vec, vpt};
  const dim3 grid(static_cast<unsigned>(ctas)), block(threads, rows_per_cta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_code == 0)
    err = norm_launch<float>(w_code, a, grid, block, st);
  else if (x_code == 1)
    err = norm_launch<__nv_bfloat16>(w_code, a, grid, block, st);
  else
    err = norm_launch<__half>(w_code, a, grid, block, st);
  return static_cast<int>(err);
}

// qo [b, s, h, d] and ko [b, s, hk, d] (contiguous) = q and k rotated by
// int32 (pos_code 0) or int64 (1) positions [b, s] (strides p0, p1; may
// be 0); q, k read at the given
// batch, sequence and head strides.  k may be null with hk == 0.  inv
// holds d / 2 fp32 inverse frequencies.  `threads` a token (a multiple of
// 32), `tokens_per_cta` tokens a CTA (threads * tokens_per_cta <= 256);
// with vec, d / 2 is a multiple of a 16-byte vector and every head's row
// is 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int rope_qk_launch(const void* q, const void* k, void* qo,
                              void* ko, int code, const void* pos,
                              int pos_code, const float* inv, int b, int s,
                              int h, int hk, int d, long long q0,
                              long long q1, long long q2, long long k0,
                              long long k1, long long k2, long long p0,
                              long long p1, int vec, int threads,
                              int tokens_per_cta, void* stream) {
  if (b < 1 || s < 1 || h < 1 || hk < 0 || (hk > 0 && k == nullptr) ||
      d < 2 || d % 2 || d > 1024 || code < 0 || code > 2 || pos_code < 0 ||
      pos_code > 1 || threads < 32 || threads % 32 || tokens_per_cta < 1 ||
      threads * tokens_per_cta > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tokens = static_cast<long long>(b) * s;
  const long long ctas = (tokens + tokens_per_cta - 1) / tokens_per_cta;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  RopeArgs a{q, k, qo, ko, pos, pos_code, inv, tokens, s, h, hk, d,
             q0, q1, q2, k0, k1, k2, p0, p1, vec};
  const dim3 grid(static_cast<unsigned>(ctas)), block(threads, tokens_per_cta);
  const size_t smem = sizeof(float2) * (d / 2) * tokens_per_cta;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code == 0)
    rope_qk_kernel<float><<<grid, block, smem, st>>>(a);
  else if (code == 1)
    rope_qk_kernel<__nv_bfloat16><<<grid, block, smem, st>>>(a);
  else
    rope_qk_kernel<__half><<<grid, block, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
