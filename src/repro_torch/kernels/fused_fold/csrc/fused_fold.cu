// Fused grouped power-sum fold for Hopper (sm_90a): one read of a block.
//
// Replaces repro/kernels/fused_fold/kernel.py::_fused_fold_kernel (the
// Pallas TPU kernel).  For one block x [R, F] (any of f32/bf16/f16/f64/
// i64/i32/i16/i8/u8/bool, cast to fp32 in registers), int32 gids [R] and an
// fp32 row weight mask [R] it produces, per group g in [0, G):
//
//   count[g] = sum of m_r            over rows with gid g and m_r != 0
//   s_k[g,f] = sum of m_r * v^k      k in {1..4}, v = (m_r > 0 ? x[r,f] : 0)
//
// Rows are zeroed BEFORE the powers are raised, so NaN or Inf in a
// masked-off row never reaches a sum.  s3 = (v*v)*v and s4 = (v*v)*(v*v),
// the reference's products.
//
// Non-finite powers follow the reference's one-hot contraction, where a
// row meets every group with weight 0 except its own: 0 * Inf = NaN.  So
// s_k[g,f] is NaN whenever some row with m_r > 0 and gid != g (in range or
// not) has a non-finite v^k at f, on top of g's own IEEE sum.  The count,
// contracted against ones, is never poisoned.  Rows with a gid outside
// [0, G) add to no group's sums or count.
//
// Design.  The Pallas kernel carries its sums in VMEM across a sequential
// row sweep; CUDA blocks run in no fixed order, so the grid here is
// (feature tiles) x (S row splits).  Each thread owns one feature column
// and walks its split's rows in order, accumulating the requested powers of
// every group in shared memory laid out [acc][G][block width], so no two
// threads touch one word and no atomics are needed.  The split partials
// [S, n_acc, G, F] are then summed over S in a fixed order by a second small
// kernel (skipped when S == 1, where the first writes the output directly).
// The count is accumulated once, by thread 0 of the CTAs of feature tile 0.
// For the non-finite rule no thread does per-group work per row: one FMA
// a row tells whether its column met a non-finite power at all; only then
// does the thread walk its split again to keep, per power, the first
// offending gid and a "more than one gid" flag, and it writes NaN into
// every group these poison when it stores its split's partial; the split
// sum then carries the NaN.
// With no floating-point atomics a re-fold returns the same bits.
//
// Bound.  The fold does about 15 flops per payload byte read at most, far
// below the H100's ridge point, so it is bound by device-memory bytes: the
// payload is read once and the accumulators written once.  This first
// version issues plain loads; a cp.async/TMA-pipelined row sweep with the
// accumulators of small G held in registers is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f32<double>(double v) {
  return __double2float_rn(v);
}
template <> __device__ __forceinline__ float to_f32<int64_t>(int64_t v) {
  return __ll2float_rn(v);
}
template <> __device__ __forceinline__ float to_f32<int32_t>(int32_t v) {
  return __int2float_rn(v);
}
template <> __device__ __forceinline__ float to_f32<int16_t>(int16_t v) {
  return __int2float_rn(static_cast<int>(v));
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return __int2float_rn(static_cast<int>(v));
}
template <> __device__ __forceinline__ float to_f32<uint8_t>(uint8_t v) {
  return __int2float_rn(static_cast<int>(v));
}

// One (feature tile, row split) cell.  flags bit k-1 asks for s_k.
template <typename T>
__global__ void fold_split_kernel(const T* __restrict__ x,
                                  const int32_t* __restrict__ gids,
                                  const float* __restrict__ mask,
                                  long long R, long long F, int G, int flags,
                                  int want_count, long long rows_per_split,
                                  float* __restrict__ out_s,
                                  float* __restrict__ out_c) {
  extern __shared__ float smem[];
  const int bf = blockDim.x;
  const int tid = threadIdx.x;
  const int n_wide = __popc(flags);
  const size_t stride = static_cast<size_t>(G) * bf;  // one accumulator
  float* acc = smem;                                  // [n_wide][G][bf]
  float* cnt = smem + n_wide * stride;                // [G]
  const long long f = static_cast<long long>(blockIdx.x) * bf + tid;
  const int split = blockIdx.y;
  const long long r0 = static_cast<long long>(split) * rows_per_split;
  const long long r1 = min(R, r0 + rows_per_split);
  const bool do_count = want_count && blockIdx.x == 0;
  const bool live = f < F;

  for (size_t i = tid; i < n_wide * stride; i += bf) acc[i] = 0.f;
  if (do_count)
    for (int i = tid; i < G; i += bf) cnt[i] = 0.f;
  __syncthreads();

  // rows go in batches of UNROLL so that each thread has UNROLL
  // independent payload loads in flight; rows then add in row order
  constexpr int UNROLL = 8;
  float* mine = acc + tid;
  // top * 0 is 0 for a finite top and NaN otherwise, so one FMA a row
  // tells whether any row with m > 0 had a non-finite highest power
  // (masked rows load 0); |v|^k finite bounds the lower powers
  float seen = 0.f;
  for (long long rb = r0; rb < r1; rb += UNROLL) {
    float mv[UNROLL], xv[UNROLL];
    int gv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long r = rb + u;
      const bool in = r < r1;
      mv[u] = in ? mask[r] : 0.f;
      gv[u] = in ? gids[r] : -1;
      const bool load = live && mv[u] > 0.f;
      xv[u] = load ? to_f32<T>(x[r * F + f]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float m = mv[u];
      const int g = gv[u];
      if (m == 0.f) continue;                      // the same for every thread
      const float v = xv[u];  // 0 unless m > 0: masked rows never load
      const float v2 = v * v;
      const float top = (flags & 8) ? v2 * v2 : (flags & 4) ? v2 * v
                                               : (flags & 2) ? v2 : v;
      seen = fmaf(top, 0.f, seen);
      if (g < 0 || g >= G) continue;               // the same for every thread
      if (do_count && tid == 0) cnt[g] += m;
      if (!live) continue;
      float* a = mine + static_cast<size_t>(g) * bf;
      if (flags & 1) { *a += m * v; a += stride; }
      if (flags & 2) { *a += m * v2; a += stride; }
      if (flags & 4) { *a += m * (v2 * v); a += stride; }
      if (flags & 8) { *a += m * (v2 * v2); }
    }
  }
  // rare path: walk the split again for this column and note, per power
  // k, the gid of the first row with a non-finite v^k and whether such
  // rows carry more than one gid
  bool bad[4] = {false, false, false, false};
  bool bad_multi[4] = {false, false, false, false};
  int bad_gid[4] = {0, 0, 0, 0};
  if (live && seen != seen) {
    for (long long r = r0; r < r1; ++r) {
      if (!(mask[r] > 0.f)) continue;
      const int g = gids[r];
      const float v = to_f32<T>(x[r * F + f]);
      const float v2 = v * v;
      const float pw[4] = {v, v2, v2 * v, v2 * v2};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(flags & (1 << k)) || isfinite(pw[k])) continue;
        if (!bad[k]) {
          bad[k] = true;
          bad_gid[k] = g;
        } else if (bad_gid[k] != g) {
          bad_multi[k] = true;
        }
      }
    }
  }
  __syncthreads();

  if (live) {
    int j = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(flags & (1 << k))) continue;
      for (int g = 0; g < G; ++g) {
        float val = acc[j * stride + static_cast<size_t>(g) * bf + tid];
        if (bad[k] && (bad_multi[k] || bad_gid[k] != g)) val = CUDART_NAN_F;
        out_s[((static_cast<size_t>(split) * n_wide + j) * G + g) * F + f] =
            val;
      }
      ++j;
    }
  }
  if (do_count)
    for (int i = tid; i < G; i += bf)
      out_c[static_cast<size_t>(split) * G + i] = cnt[i];
}

// out[i] = sum over s of part[s, i], in the order s = 0, 1, ..., S-1.
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int S,
                                  long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[static_cast<size_t>(k) * n + i];
  out[i] = s;
}

template <typename T>
cudaError_t launch_split(const void* x, const int32_t* gids,
                         const float* mask, long long R, long long F, int G,
                         int flags, int want_count, int bf, int S,
                         long long rows_per_split, float* out_s,
                         float* out_c, cudaStream_t stream) {
  const int n_wide = __builtin_popcount(flags);
  const size_t smem =
      (static_cast<size_t>(n_wide) * G * bf + G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fold_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = F > 0 ? (F + bf - 1) / bf : 1;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(S));
  fold_split_kernel<T><<<grid, bf, smem, stream>>>(
      static_cast<const T*>(x), gids, mask, R, F, G, flags, want_count,
      rows_per_split, out_s, out_c);
  return cudaGetLastError();
}

cudaError_t launch_sum(const float* part, float* out, int S, long long n,
                       cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      part, out, S, n);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 f32, 1 bf16, 2 f16, 3 f64, 4 i32, 5 i64, 6 i16, 7 i8,
// 8 u8 (and bool, one byte each).  With S == 1 the split kernel writes
// out_s [n_wide, G, F] and out_c [G] directly and the scratch pointers are
// unused; otherwise it writes scratch_s [S, n_wide, G, F] and scratch_c
// [S, G], which are then summed into out_s / out_c.  Returns the CUDA error
// of the first failing step (0 on success).
extern "C" int fused_fold_launch(const void* x, int dtype, const void* gids,
                                 const void* mask, long long R, long long F,
                                 int G, int flags, int want_count, int bf,
                                 int S, long long rows_per_split, void* out_s,
                                 void* out_c, void* scratch_s,
                                 void* scratch_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* g = static_cast<const int32_t*>(gids);
  const float* m = static_cast<const float*>(mask);
  float* ps = static_cast<float*>(S == 1 ? out_s : scratch_s);
  float* pc = static_cast<float*>(S == 1 ? out_c : scratch_c);
  cudaError_t err;
  switch (dtype) {
#define FF_CASE(code, T)                                                    \
  case code:                                                                \
    err = launch_split<T>(x, g, m, R, F, G, flags, want_count, bf, S,       \
                          rows_per_split, ps, pc, st);                      \
    break;
    FF_CASE(0, float)
    FF_CASE(1, __nv_bfloat16)
    FF_CASE(2, __half)
    FF_CASE(3, double)
    FF_CASE(4, int32_t)
    FF_CASE(5, int64_t)
    FF_CASE(6, int16_t)
    FF_CASE(7, int8_t)
    FF_CASE(8, uint8_t)
#undef FF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S > 1) {
    const long long n_wide = __builtin_popcount(flags);
    err = launch_sum(static_cast<const float*>(scratch_s),
                     static_cast<float*>(out_s), S, n_wide * G * F, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (want_count) {
      err = launch_sum(static_cast<const float*>(scratch_c),
                       static_cast<float*>(out_c), S, G, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}
