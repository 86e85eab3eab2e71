// Flash-attention forward for Hopper (sm_90a): causal or sliding-window
// softmax attention with an online softmax, fp32 inside.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_kernel (the
// Pallas TPU kernel).  For q [B, H, Sq, D] and k, v [B, Hkv, Skv, D] (f32,
// bf16 or f16, any batch/head/sequence strides, unit stride along D) it
// writes o [B, H, Sq, D] in q's dtype:
//
//   s[i, j] = (q_i . k_j) * scale, set to -1e30 where masked
//   o_i     = sum_j softmax_j(s[i, :]) v_j
//
// A position j is masked when j >= Skv and, if causal, when j > i or (with
// window > 0) j <= i - window.  Query head h reads KV head h / (H / Hkv) by
// index: K/V are never broadcast.  The mask value is -1e30, not -inf, as in
// the reference: a block that is fully masked before the first valid key of
// a row adds exp(0) terms that the later correction exp(m_prev - m_new)
// wipes out exactly, where -inf would give inf - inf = NaN.  The normaliser
// is clamped at 1e-30 before the division.
//
// Design.  One CTA of 256 threads per (batch*head, 64-row query block); the
// heaviest causal query blocks launch first.  The CTA walks 64-key blocks
// in order, skipping blocks that lie wholly above the diagonal or wholly
// before the window (both would only add terms that are multiplied by an
// exact 0 later).  Q, K and V tiles are converted to fp32 in shared memory.
// The 64x64 score tile is a register-tiled product (each thread 4x4
// scores), the online max / normaliser runs four threads per row with warp
// shuffles, and P.V accumulates into registers (each thread 4 rows x D/16
// columns).  All arithmetic is fp32 on the CUDA cores.
//
// Bound.  At the serving shape (B 8, H 32, S 2048, D 64, bf16, causal) the
// work is about 137 GFLOP against 268 MB of inputs and output, so on an
// H100 the tensor-core rate bounds it, not the bytes.  This first version
// runs its products on the CUDA cores in fp32 and is far from that bound;
// wgmma tiles fed by TMA are the later step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows per CTA
constexpr int BK = 64;     // keys per block
constexpr int NT = 256;    // threads per CTA: a 16 x 16 grid
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

template <int D>
constexpr size_t smem_floats() {
  return 3 * BQ * (D + 1) + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                 int Sq, int Skv, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, float scale, int causal, int window) {
  constexpr int DP = D + 1;     // padded rows: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int DJ = D / 16;    // output columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;               // [BQ][DP]
  float* Ks = Qs + BQ * DP;     // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* Ss = Vs + BK * DP;     // [BQ][SP] scores, then probabilities
  float* m_s = Ss + BQ * SP;    // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running normaliser
  float* c_s = l_s + BQ;        // [BQ] this block's correction

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qb * BQ;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + hk * ksh;
  const T* vp = v + b * vsb + hk * vsh;
  T* op = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    Qs[r * DP + c] = q0 + r < Sq ? to_f32<T>(qp[(q0 + r) * qss + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  int kb_begin = 0;
  int kb_end = (Skv + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    kb_end = min(kb_end, q_last / BK + 1);
    if (window > 0) kb_begin = max(0, q0 - window + 1) / BK;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // the last block is done with Ks, Vs and Ss
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Skv;
      Ks[r * DP + c] = in ? to_f32<T>(kp[(k0 + r) * kss + c]) : 0.f;
      Vs[r * DP + c] = in ? to_f32<T>(vp[(k0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < Skv;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        Ss[(ty * 4 + i) * SP + tx + 16 * j] = ok ? s[i][j] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row
    {
      const int r = tid / 4, part = tid % 4;
      float* row = Ss + r * SP;
      float mx = NEG;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V: rows ty*4 + i, columns tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      op[(q0 + r) * oss + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Skv,
                   const long long* st, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Skv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Hkv, int Sq, int Skv,
                     const long long* st, float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Skv, st, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Skv, st, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, st, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, st, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 f32, 1 bf16, 2 f16 (q, k, v and o share one).  strides
// holds 12 element strides: (batch, head, sequence) of q, k, v and o, in
// that order; the head-dim stride must be 1.  D is one of 16, 32, 64, 128.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int Hkv, int Sq, int Skv,
                                      int D, const long long* strides,
                                      float scale, int causal, int window,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st); break;
    case 1: err = launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st); break;
    case 2: err = launch_d<__half>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
