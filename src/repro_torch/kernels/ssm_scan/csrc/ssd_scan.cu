// Chunked SSD (mamba2) scan for Hopper (sm_90a), from a given or a zero
// state.
//
// Replaces repro/kernels/ssm_scan/kernel.py::_ssd_kernel (the Pallas TPU
// kernel).  For every (batch b, head h) stream, with x [B, L, H, P] (dt
// folded in, f32), the per-step decay a [B, L, H] (f32) and B, C [B, L, N]
// shared by all heads (f32, bf16 or f16, read at batch b: never copied out
// per head), it runs the recurrence
//
//   s_t = a_t s_{t-1} + x_t B_t^T      (s in R^{P x N}; s_{-1} the initial
//   y_t = s_t C_t                        state, or zero)
//
// chunk by chunk, as the reference does.  Per chunk of Q steps, with
// cum = inclusive cumsum of log(max(a, 1e-20)):
//
//   M[i, j]  = (C_i . B_j) exp(cum_i - cum_j) for i >= j, else 0
//   y_i      = sum_j M[i, j] x_j + exp(cum_i) (S C_i)
//   S       <- exp(cum_{Q-1}) S + sum_j exp(cum_{Q-1} - cum_j) x_j B_j^T
//
// The upper triangle is never exponentiated (the reference masks with
// -1e30 before exp, giving an exact 0).  Steps past L are read as a = 1,
// x = B = C = 0, the reference's identity padding, and are not written.
// It writes y [B, L, H, P] and the final state [B, H, P, N], both f32.
// The initial state [B, H, P, N] f32 is read once, or taken as zero.
//
// Design.  One CTA of 256 threads per stream walks its chunks in order and
// keeps the fp32 state S [P, N] in shared memory for the whole sequence, so
// device memory sees each input once and never the state.  Per chunk the
// CTA stages x, B, C, the decay matrix M (Q x Q) and the cumulative log
// decay in shared memory: with Q = 128 and P = N = 64 that is 183,552
// bytes, one CTA per SM.  The three products are register-tiled on a
// 16 x 16 thread grid (M: 8 x 8 entries a thread; y: 8 x 4; the state:
// 4 x 4), in fp32 on the CUDA cores.  The cumsum is one warp's scan.
//
// Bound.  At the serving shape (B 8, L 2048, H 64, P = N = 64, Q = 128)
// the scan does about 51 GFLOP and must move about 550 MB (x and y in f32
// dominate), so on an H100 the bytes bound it.  This first version runs its
// products on the CUDA cores in fp32, one CTA per SM with no overlap of
// loads and compute; pipelined tiles and tensor-core products are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QM = 128;   // largest chunk
constexpr int PM = 64;    // largest head dim P
constexpr int NM = 64;    // largest state dim N
constexpr int NT = 256;
constexpr int XP = PM + 1;
constexpr int BN = NM + 1;
constexpr int MQ = QM + 1;

constexpr size_t kSmemFloats =
    QM * XP + 2 * QM * BN + QM * MQ + PM * BN + 2 * QM;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename TB>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const TB* __restrict__ Bm, const TB* __restrict__ Cm,
                float* __restrict__ y, float* __restrict__ state_out,
                const float* __restrict__ init_state, int L,
                int H, int P, int N, int Q, long long xsb, long long xst,
                long long xsh, long long asb, long long ast, long long ash,
                long long bsb, long long bst, long long csb, long long cst,
                long long ysb, long long yst, long long ysh) {
  extern __shared__ float sm[];
  float* Xs = sm;                // [QM][XP]  x of the chunk
  float* Bs = Xs + QM * XP;      // [QM][BN]
  float* Cs = Bs + QM * BN;      // [QM][BN]
  float* Ms = Cs + QM * BN;      // [QM][MQ]  (C B^T) * decay, lower triangle
  float* St = Ms + QM * MQ;      // [PM][BN]  the carried state
  float* cum = St + PM * BN;     // [QM]      inclusive cumsum of log decay
  float* dout = cum + QM;        // [QM]      exp(cum[Q-1] - cum[j])

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float* xp = x + b * xsb + h * xsh;
  const float* ap = a + b * asb + h * ash;
  const TB* bp = Bm + b * bsb;
  const TB* cp = Cm + b * csb;
  float* yp = y + b * ysb + h * ysh;

  // the carried state: the stream's initial state, zero where none is
  // given and in the padding past P and N
  const float* si =
      init_state ? init_state + static_cast<size_t>(bh) * P * N : nullptr;
  for (int i = tid; i < PM * BN; i += NT) {
    const int p = i / BN, n = i % BN;
    St[i] = (si && p < P && n < N) ? si[p * N + n] : 0.f;
  }

  const int n_chunks = (L + Q - 1) / Q;
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * Q;
    __syncthreads();   // the last chunk is done with every tile
    for (int i = tid; i < Q * P; i += NT) {
      const int j = i / P, p = i % P;
      Xs[j * XP + p] = t0 + j < L ? xp[(t0 + j) * xst + p] : 0.f;
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int j = i / N, n = i % N;
      const bool in = t0 + j < L;
      Bs[j * BN + n] = in ? to_f32<TB>(bp[(t0 + j) * bst + n]) : 0.f;
      Cs[j * BN + n] = in ? to_f32<TB>(cp[(t0 + j) * cst + n]) : 0.f;
    }
    if (tid < Q) {
      const float av = t0 + tid < L ? ap[(t0 + tid) * ast] : 1.f;
      cum[tid] = logf(fmaxf(av, 1e-20f));
    }
    __syncthreads();
    if (tid < 32) {    // inclusive scan: 4 steps a lane, then across lanes
      const int per = (Q + 31) / 32;
      const int lo = tid * per, hi = min(Q, lo + per);
      float run = 0.f;
      for (int j = lo; j < hi; ++j) {
        run += cum[j];
        cum[j] = run;
      }
      float off = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, off, d);
        if (tid >= d) off += o;
      }
      off -= run;      // exclusive prefix of this lane's total
      for (int j = lo; j < hi; ++j) cum[j] += off;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    if (tid < Q) dout[tid] = expf(cum_last - cum[tid]);

    // M = (C B^T) * decay: rows ty + 16*ia, columns tx + 16*jb
    {
      float m[8][8];
#pragma unroll
      for (int ia = 0; ia < 8; ++ia)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) m[ia][jb] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia) cv[ia] = Cs[(ty + 16 * ia) * BN + n];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) bv[jb] = Bs[(tx + 16 * jb) * BN + n];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia)
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
            m[ia][jb] = fmaf(cv[ia], bv[jb], m[ia][jb]);
      }
#pragma unroll
      for (int ia = 0; ia < 8; ++ia) {
        const int i = ty + 16 * ia;
        if (i >= Q) continue;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int j = tx + 16 * jb;
          if (j >= Q) continue;
          Ms[i * MQ + j] = i >= j ? m[ia][jb] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(cum_i) (C S^T): rows ty + 16*ia, columns tx + 16*pb
    {
      float yi[8][4], ys[8][4];
#pragma unroll
      for (int ia = 0; ia < 8; ++ia)
#pragma unroll
        for (int pb = 0; pb < 4; ++pb) yi[ia][pb] = ys[ia][pb] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float mv[8], xv[4];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia) mv[ia] = Ms[(ty + 16 * ia) * MQ + j];
#pragma unroll
        for (int pb = 0; pb < 4; ++pb) xv[pb] = Xs[j * XP + tx + 16 * pb];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia)
#pragma unroll
          for (int pb = 0; pb < 4; ++pb)
            yi[ia][pb] = fmaf(mv[ia], xv[pb], yi[ia][pb]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[8], sv[4];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia) cv[ia] = Cs[(ty + 16 * ia) * BN + n];
#pragma unroll
        for (int pb = 0; pb < 4; ++pb) sv[pb] = St[(tx + 16 * pb) * BN + n];
#pragma unroll
        for (int ia = 0; ia < 8; ++ia)
#pragma unroll
          for (int pb = 0; pb < 4; ++pb)
            ys[ia][pb] = fmaf(cv[ia], sv[pb], ys[ia][pb]);
      }
#pragma unroll
      for (int ia = 0; ia < 8; ++ia) {
        const int i = ty + 16 * ia;
        if (i >= Q || t0 + i >= L) continue;
        const float din = expf(cum[i]);
#pragma unroll
        for (int pb = 0; pb < 4; ++pb) {
          const int p = tx + 16 * pb;
          if (p < P) yp[(t0 + i) * yst + p] = yi[ia][pb] + din * ys[ia][pb];
        }
      }
    }
    __syncthreads();   // every read of the old state is done

    // S = exp(cum_last) S + (x * dout)^T B: rows ty + 16*pa, cols tx + 16*nb
    {
      float s[4][4];
#pragma unroll
      for (int pa = 0; pa < 4; ++pa)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) s[pa][nb] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float dj = dout[j];
        float xv[4], bv[4];
#pragma unroll
        for (int pa = 0; pa < 4; ++pa) xv[pa] = Xs[j * XP + ty + 16 * pa] * dj;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) bv[nb] = Bs[j * BN + tx + 16 * nb];
#pragma unroll
        for (int pa = 0; pa < 4; ++pa)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) s[pa][nb] = fmaf(xv[pa], bv[nb], s[pa][nb]);
      }
      const float dec = expf(cum_last);
#pragma unroll
      for (int pa = 0; pa < 4; ++pa) {
        const int p = ty + 16 * pa;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int n = tx + 16 * nb;
          if (p < P && n < N) St[p * BN + n] = St[p * BN + n] * dec + s[pa][nb];
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<size_t>(bh) * P * N;
  for (int i = tid; i < P * N; i += NT) so[i] = St[(i / N) * BN + i % N];
}

template <typename TB>
cudaError_t launch(const float* x, const float* a, const void* Bm,
                   const void* Cm, float* y, float* state_out,
                   const float* init_state, int Bsz, int L,
                   int H, int P, int N, int Q, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<TB><<<Bsz * H, NT, smem, stream>>>(
      x, a, static_cast<const TB*>(Bm), static_cast<const TB*>(Cm), y,
      state_out, init_state, L, H, P, N, Q, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12]);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype codes: 0 f32, 1 bf16, 2 f16 (B and C share one).  strides holds
// 13 element strides: x (batch, step, head), a (batch, step, head),
// B (batch, step), C (batch, step), y (batch, step, head); the innermost
// strides of x, B, C and y must be 1.  The final state is written
// contiguous [B*H, P, N]; init_state, contiguous [B*H, P, N] f32, is the
// state before step 0 (null: zero).  Requires 1 <= Q <= 128, P <= 64, N <= 64.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* Bm,
                               const void* Cm, int bc_dtype, void* y,
                               void* state_out, const void* init_state,
                               int Bsz, int L, int H, int P,
                               int N, int Q, const long long* strides,
                               void* stream) {
  if (Q < 1 || Q > QM || P < 1 || P > PM || N < 1 || N > NM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state_out);
  const float* si = static_cast<const float*>(init_state);
  cudaError_t err;
  switch (bc_dtype) {
    case 0: err = launch<float>(xf, af, Bm, Cm, yf, sf, si, Bsz, L, H, P, N, Q, strides, st); break;
    case 1: err = launch<__nv_bfloat16>(xf, af, Bm, Cm, yf, sf, si, Bsz, L, H, P, N, Q, strides, st); break;
    case 2: err = launch<__half>(xf, af, Bm, Cm, yf, sf, si, Bsz, L, H, P, N, Q, strides, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
