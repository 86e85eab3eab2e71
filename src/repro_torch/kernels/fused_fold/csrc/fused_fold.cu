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
// Bound.  The fold does at most about 15 flops per payload byte, far below
// the H100's ridge point, so device-memory bytes bound it: the selected
// rows' payload read once, the sidecars, the sums written once.  On the
// population path a grouped query's block of 256 rows selects about a
// quarter of them, and the Mean run folds blocks of 16 rows, at F =
// 91*109*91 = 902,629 columns: few bytes in flight per thread, in the
// first design each behind a load of the row's mask.  Latency, not
// bandwidth, held that design back (24% of the byte bound on an H100).
//
// Design.
//  1. A row list.  Before any payload is read, a CTA compacts the rows
//     with m_r > 0 into a list of (row, gid, weight) in shared memory, in
//     ascending row order (a warp-ballot prefix sum over the rows).  A
//     block longer than one list chunk is walked chunk by chunk, so rows
//     still add in row order.  Masked rows are never touched again, and the
//     payload loads depend on shared memory only.
//  2. Bytes in flight.  Each thread owns C = 2 columns, one in each of two
//     units of `lanes` columns (coalesced warp loads), and for each batch
//     of U = 8 list entries issues all U*C loads before it uses any.
//     F is odd on the population path, so rows are 4-byte aligned only:
//     plain 4-byte loads, no vector loads, cp.async.cg or TMA.
//  3. Register accumulators for G <= 8 (compiled for GT in {1, 2, 4, 8}
//     groups and NP in {1, 2, 4} powers): every entry is FMA'd into every
//     group with the one-hot weight (m for its own gid, 0 for the others),
//     the reference's contraction, which gives its NaN poisoning for
//     free.  Larger G keeps [power][G][width] accumulators in shared
//     memory (the limit on G is unchanged) and the non-finite rule of the
//     first design: one FMA a row into `seen`, and only in a column where
//     it fired, a second walk over the chunk's list.
//  4. A persistent grid: as many CTAs as fit on the card at once, each
//     walking units u = blockIdx.x, += gridDim.x, two at a time, then the
//     odd one alone, so no partial last wave.  A block narrower than one
//     CTA splits its rows over the CTA's threads instead (splits =
//     threads / lanes) and sums the splits' partials in a fixed tree.
//  5. The count is summed by the last CTA from mask and gids, over every
//     row with m != 0, in a fixed order.
// No floating-point atomics: a re-fold returns the same bits.  Python
// (kernel.py::launch_plan) chooses the path, lanes, splits, list chunk,
// shared memory and grid; this file only checks and launches them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // the register path's CTA width
constexpr int U = 8;             // list entries per batch of loads
constexpr int SCRATCH_WORDS = 64;

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

struct Args {
  const void* x;
  const int32_t* gids;
  const float* mask;
  long long R, F;
  int G, flags, want_count, lanes, chunk_rows;
  float* out_s;   // [n_wide, G, F]
  float* out_c;   // [G]
};

// The shared-memory row list of one chunk (structure of arrays).
struct List {
  int* row;
  int* gid;
  float* w;
};

__device__ __forceinline__ List list_at(unsigned char* smem, int chunk_rows) {
  List l;
  l.row = reinterpret_cast<int*>(smem);
  l.gid = l.row + chunk_rows;
  l.w = reinterpret_cast<float*>(l.gid + chunk_rows);
  return l;
}

// Every thread of the CTA: compact rows [r0, r1) with m > 0 into `l`, in
// ascending order; returns their number.  `scratch` holds a word a warp.
__device__ int build_list(const Args& a, long long r0, long long r1,
                          const List& l, int* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  int n = 0;
  for (long long base = r0; base < r1; base += blockDim.x) {
    const long long r = base + tid;
    float m = 0.f;
    int g = 0;
    if (r < r1) {
      m = a.mask[r];
      g = a.gids[r];
    }
    const bool keep = m > 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    int before = n, total = n;
    for (int w = 0; w < n_warps; ++w) {
      const int c = scratch[w];
      if (w < warp) before += c;
      total += c;
    }
    if (keep) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      l.row[pos] = static_cast<int>(r);
      l.gid[pos] = g;
      l.w[pos] = m;
    }
    n = total;
    __syncthreads();   // the list is complete; scratch may be reused
  }
  return n;
}

// count[g] for g < G <= GT with all threads of the CTA: rows tid, tid +
// blockDim.x, ... in registers, then a fixed shuffle tree within each warp
// and the warps' partials in warp order.
template <int GT>
__device__ void count_parallel(const Args& a, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  float c[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) c[g] = 0.f;
  for (long long r = tid; r < a.R; r += blockDim.x) {
    const float m = a.mask[r];
    const int gid = a.gids[r];
#pragma unroll
    for (int g = 0; g < GT; ++g) c[g] += (m != 0.f && gid == g) ? m : 0.f;
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      c[g] += __shfl_down_sync(0xffffffffu, c[g], off);
  }
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GT; ++g) red[warp * GT + g] = c[g];
  __syncthreads();
  if (tid < a.G) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += red[w * GT + tid];
    a.out_c[tid] = s;
  }
}

// count[g] for any G: thread t sums groups t, t + blockDim.x, ... over the
// rows in order.
__device__ void count_serial(const Args& a) {
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    float c = 0.f;
    for (long long r = 0; r < a.R; ++r) {
      const float m = a.mask[r];
      if (m != 0.f && a.gids[r] == g) c += m;
    }
    a.out_c[g] = c;
  }
}

// ---- the register path: G <= GT <= 8 --------------------------------------

// Walk list entries [e0, e1) for the CC columns `col`, FMA-ing each entry
// into every group of acc with its one-hot weight.
template <typename T, int GT, int NP, int CC>
__device__ __forceinline__ void walk_registers(
    const T* __restrict__ x, long long F, const long long (&col)[CC],
    const List& l, int e0, int e1, float (&acc)[NP][GT][CC]) {
  bool live[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) live[c] = col[c] < F;
  for (int eb = e0; eb < e1; eb += U) {
    float xv[U][CC];
#pragma unroll
    for (int u = 0; u < U; ++u) {     // every load of the batch first
      const int e = eb + u;
      const bool in = e < e1;
      const T* xr = x + static_cast<long long>(in ? l.row[e] : 0) * F;
#pragma unroll
      for (int c = 0; c < CC; ++c)
        xv[u][c] = (in && live[c]) ? to_f32<T>(xr[col[c]]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // gid and weight are read again here (shared-memory broadcasts)
      // rather than held across the loads
      const int e = eb + u;
      const bool in = e < e1;
      const int gid = in ? l.gid[e] : -1;
      const float wt = in ? l.w[e] : 0.f;
      float w[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) w[g] = gid == g ? wt : 0.f;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        const float v = xv[u][c];
        const float v2 = v * v;
        const float p[4] = {v, v2, v2 * v, v2 * v2};
#pragma unroll
        for (int k = 0; k < NP; ++k)
#pragma unroll
          for (int g = 0; g < GT; ++g)
            acc[k][g][c] = fmaf(w[g], p[k], acc[k][g][c]);
      }
    }
  }
}

// Fold CC units (units[c] * lanes + lane is a thread's column c) over every
// row and store their sums.  All threads of the CTA take part.
template <typename T, int GT, int NP, int CC>
__device__ void fold_units_registers(const Args& a,
                                     const long long (&units)[CC],
                                     unsigned char* smem, int n_single,
                                     float* red) {
  const int tid = threadIdx.x;
  const int lane = tid % a.lanes, split = tid / a.lanes;
  const int S = blockDim.x / a.lanes;
  const List l = list_at(smem, a.chunk_rows);
  int* scratch = reinterpret_cast<int*>(smem + 12 * a.chunk_rows);
  const T* x = static_cast<const T*>(a.x);
  long long col[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) col[c] = units[c] * a.lanes + lane;
  float acc[NP][GT][CC];
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[k][g][c] = 0.f;

  // the list of a one-chunk block was built once, before the first unit
  const long long n_chunks =
      n_single >= 0 ? 1 : (a.R + a.chunk_rows - 1) / a.chunk_rows;
  for (long long ch = 0; ch < n_chunks; ++ch) {
    int n = n_single;
    if (n_single < 0) {
      __syncthreads();   // every thread is done with the last chunk's list
      const long long r0 = ch * a.chunk_rows;
      n = build_list(a, r0, min(a.R, r0 + a.chunk_rows), l, scratch);
    }
    const int per = (n + S - 1) / S;
    const int e0 = min(n, split * per), e1 = min(n, e0 + per);
    walk_registers<T, GT, NP, CC>(x, a.F, col, l, e0, e1, acc);
  }

  if (S > 1) {   // sum the splits' partials in a fixed tree
    constexpr int NA = NP * GT * CC;
    float* mine = red + static_cast<size_t>(split) * NA * a.lanes + lane;
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int c = 0; c < CC; ++c)
          mine[((k * GT + g) * CC + c) * a.lanes] = acc[k][g][c];
    __syncthreads();
    for (int half = S / 2; half > 0; half /= 2) {
      if (split < half) {
        const float* other = mine + static_cast<size_t>(half) * NA * a.lanes;
        for (int i = 0; i < NA; ++i) mine[i * a.lanes] += other[i * a.lanes];
      }
      __syncthreads();
    }
    if (split == 0)
#pragma unroll
      for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int c = 0; c < CC; ++c)
            acc[k][g][c] = mine[((k * GT + g) * CC + c) * a.lanes];
    __syncthreads();   // red is free for the next unit
  }
  if (split != 0) return;
  int j = 0;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (!(a.flags & (1 << k))) continue;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= a.G) continue;
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (col[c] < a.F)
          a.out_s[(static_cast<size_t>(j) * a.G + g) * a.F + col[c]] =
              acc[k][g][c];
    }
    ++j;
  }
}

// CTAs an SM must hold, as many as no instantiation spills at: four (up to
// 64 registers a thread) for at most two accumulators a column and
// payloads of at most 4 bytes, three (85) for up to eight in fewer than
// eight groups, one for the largest set with 8-byte payloads, else two
// (128).  More resident CTAs put more loads in flight, which the short
// row lists of the Mean run's blocks need.
constexpr int min_ctas(int gt, int np, int bytes) {
  return bytes <= 4 && gt * np <= 2            ? 4
         : bytes <= 4 && gt < 8 && gt * np <= 8 ? 3
         : bytes > 4 && gt * np >= 32           ? 1
                                                : 2;
}

template <typename T, int GT, int NP>
__global__ void __launch_bounds__(NT, min_ctas(GT, NP, sizeof(T)))
fold_registers_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = blockDim.x / a.lanes;
  const size_t list_bytes = 12 * static_cast<size_t>(a.chunk_rows);
  int* scratch = reinterpret_cast<int*>(smem + list_bytes);
  float* red = reinterpret_cast<float*>(smem + list_bytes +
                                        4 * SCRATCH_WORDS);
  const long long n_units = a.F > 0 ? (a.F + a.lanes - 1) / a.lanes : 1;
  int n_single = -1;   // the list's length when the block is one chunk
  if (a.R <= a.chunk_rows)
    n_single = build_list(a, 0, a.R, list_at(smem, a.chunk_rows), scratch);
  const long long g = gridDim.x;
  for (long long u = blockIdx.x; u < n_units;) {
    if (S == 1 && u + g < n_units) {
      const long long two[2] = {u, u + g};
      fold_units_registers<T, GT, NP, 2>(a, two, smem, n_single, red);
      u += 2 * g;
    } else {
      const long long one[1] = {u};
      fold_units_registers<T, GT, NP, 1>(a, one, smem, n_single, red);
      u += g;
    }
  }
  if (a.want_count && blockIdx.x == gridDim.x - 1)
    count_parallel<GT>(a, reinterpret_cast<float*>(scratch));
}

// ---- the shared-memory path: G > 8 -----------------------------------------

// One thread a column; accumulators [n_wide][G][blockDim.x] in shared
// memory, then the row list.
template <typename T>
__global__ void fold_shared_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bf = blockDim.x, tid = threadIdx.x;
  const int n_wide = __popc(a.flags);
  const size_t stride = static_cast<size_t>(a.G) * bf;   // one accumulator
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* list_base = smem + 4 * n_wide * stride;
  const List l = list_at(list_base, a.chunk_rows);
  int* scratch =
      reinterpret_cast<int*>(list_base + 12 * static_cast<size_t>(a.chunk_rows));
  const T* x = static_cast<const T*>(a.x);
  const long long n_units = a.F > 0 ? (a.F + bf - 1) / bf : 1;
  const long long n_chunks = (a.R + a.chunk_rows - 1) / a.chunk_rows;
  int n_single = -1;
  if (a.R <= a.chunk_rows) n_single = build_list(a, 0, a.R, l, scratch);

  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const long long f = u * bf + tid;
    const bool live = f < a.F;
    float* mine = acc + tid;
    for (size_t i = 0; i < n_wide * static_cast<size_t>(a.G); ++i)
      mine[i * bf] = 0.f;
    bool bad[4] = {false, false, false, false};
    bool bad_multi[4] = {false, false, false, false};
    int bad_gid[4] = {0, 0, 0, 0};
    for (long long ch = 0; ch < (n_single >= 0 ? 1 : n_chunks); ++ch) {
      int n = n_single;
      if (n_single < 0) {
        __syncthreads();
        const long long r0 = ch * a.chunk_rows;
        n = build_list(a, r0, min(a.R, r0 + a.chunk_rows), l, scratch);
      }
      // top * 0 is 0 for a finite top and NaN otherwise, so one FMA a row
      // tells whether any listed row had a non-finite highest power;
      // |v|^k finite bounds the lower powers
      float seen = 0.f;
      for (int eb = 0; eb < n; eb += U) {
        float xv[U];
#pragma unroll
        for (int u2 = 0; u2 < U; ++u2) {
          const int e = eb + u2;
          xv[u2] = (e < n && live)
                       ? to_f32<T>(x[static_cast<long long>(l.row[e]) * a.F + f])
                       : 0.f;
        }
#pragma unroll
        for (int u2 = 0; u2 < U; ++u2) {
          const int e = eb + u2;
          if (e >= n) break;                       // the same for every thread
          const float m = l.w[e];
          const int g = l.gid[e];
          const float v = xv[u2];
          const float v2 = v * v;
          const float top = (a.flags & 8) ? v2 * v2 : (a.flags & 4) ? v2 * v
                            : (a.flags & 2) ? v2 : v;
          seen = fmaf(top, 0.f, seen);
          if (g < 0 || g >= a.G || !live) continue;
          float* p = mine + static_cast<size_t>(g) * bf;
          if (a.flags & 1) { *p += m * v; p += stride; }
          if (a.flags & 2) { *p += m * v2; p += stride; }
          if (a.flags & 4) { *p += m * (v2 * v); p += stride; }
          if (a.flags & 8) { *p += m * (v2 * v2); }
        }
      }
      // rare path: walk this chunk's list again for this column and note,
      // per power k, the gid of the first row with a non-finite v^k and
      // whether such rows carry more than one gid
      if (live && seen != seen) {
        for (int e = 0; e < n; ++e) {
          const int g = l.gid[e];
          const float v = to_f32<T>(x[static_cast<long long>(l.row[e]) * a.F + f]);
          const float v2 = v * v;
          const float pw[4] = {v, v2, v2 * v, v2 * v2};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!(a.flags & (1 << k)) || isfinite(pw[k])) continue;
            if (!bad[k]) {
              bad[k] = true;
              bad_gid[k] = g;
            } else if (bad_gid[k] != g) {
              bad_multi[k] = true;
            }
          }
        }
      }
    }
    if (live) {
      int j = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(a.flags & (1 << k))) continue;
        for (int g = 0; g < a.G; ++g) {
          float val = mine[(j * static_cast<size_t>(a.G) + g) * bf];
          if (bad[k] && (bad_multi[k] || bad_gid[k] != g)) val = CUDART_NAN_F;
          a.out_s[(static_cast<size_t>(j) * a.G + g) * a.F + f] = val;
        }
        ++j;
      }
    }
  }
  if (a.want_count && blockIdx.x == gridDim.x - 1) count_serial(a);
}

// ---- count only -------------------------------------------------------

__global__ void count_kernel(Args a) {
  __shared__ float red[SCRATCH_WORDS];
  if (a.G <= 8) count_parallel<8>(a, red);
  else count_serial(a);
}

// ---- dispatch ---------------------------------------------------------

enum Path { REGISTERS = 0, SHARED = 1, COUNT = 2 };

template <typename T, int GT>
const void* registers_np(int np) {
  switch (np) {
    case 1: return reinterpret_cast<const void*>(fold_registers_kernel<T, GT, 1>);
    case 2: return reinterpret_cast<const void*>(fold_registers_kernel<T, GT, 2>);
    case 4: return reinterpret_cast<const void*>(fold_registers_kernel<T, GT, 4>);
  }
  return nullptr;
}

template <typename T>
const void* kernel_for(int path, int gt, int np) {
  if (path == SHARED) return reinterpret_cast<const void*>(fold_shared_kernel<T>);
  switch (gt) {
    case 1: return registers_np<T, 1>(np);
    case 2: return registers_np<T, 2>(np);
    case 4: return registers_np<T, 4>(np);
    case 8: return registers_np<T, 8>(np);
  }
  return nullptr;
}

// dtype codes: 0 f32, 1 bf16, 2 f16, 3 f64, 4 i32, 5 i64, 6 i16, 7 i8,
// 8 u8 (and bool, one byte each)
const void* pick(int dtype, int path, int gt, int np) {
  if (path == COUNT) return reinterpret_cast<const void*>(count_kernel);
  switch (dtype) {
    case 0: return kernel_for<float>(path, gt, np);
    case 1: return kernel_for<__nv_bfloat16>(path, gt, np);
    case 2: return kernel_for<__half>(path, gt, np);
    case 3: return kernel_for<double>(path, gt, np);
    case 4: return kernel_for<int32_t>(path, gt, np);
    case 5: return kernel_for<int64_t>(path, gt, np);
    case 6: return kernel_for<int16_t>(path, gt, np);
    case 7: return kernel_for<int8_t>(path, gt, np);
    case 8: return kernel_for<uint8_t>(path, gt, np);
  }
  return nullptr;
}

cudaError_t prepare(const void* fn, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// CTAs of `threads` threads with `smem` bytes of dynamic shared memory
// that one SM holds at once for the kernel of (dtype, path, gt, np), or
// minus a CUDA error code.
extern "C" int fused_fold_ctas_per_sm(int dtype, int path, int gt, int np,
                                      int threads, int smem) {
  const void* fn = pick(dtype, path, gt, np);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

// One fold as kernel.py::launch_plan laid it out: path 0 (registers: gt
// groups compiled, np powers accumulated, threads == 256, lanes a power of
// two dividing it; a CTA with row splits folds one unit, lanes >= F), 1
// (shared memory: threads columns a CTA) or 2 (count only, one CTA).  flags bit k-1 asks for s_k; out_s is [popc(flags), G,
// F] fp32 and out_c [G] fp32.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int fused_fold_launch(const void* x, int dtype, const void* gids,
                                 const void* mask, long long R, long long F,
                                 int G, int flags, int want_count, int path,
                                 int gt, int np, int threads, int lanes,
                                 int chunk_rows, int smem, int grid,
                                 void* out_s, void* out_c, void* stream) {
  const void* fn = pick(dtype, path, gt, np);
  if (fn == nullptr || R < 0 || R > 0x7fffffffLL || F < 0 || G < 1 ||
      threads % 32 != 0 || lanes < 1 || threads % lanes != 0 ||
      chunk_rows < 1 || grid < 1 ||
      (path == REGISTERS &&
       (threads != NT || G > gt || flags == 0 || (flags >> np) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{x, static_cast<const int32_t*>(gids), static_cast<const float*>(mask),
         R, F, G, flags, want_count, lanes, chunk_rows,
         static_cast<float*>(out_s), static_cast<float*>(out_c)};
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
