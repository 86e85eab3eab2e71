// Flash-attention forward for Hopper (sm_90a) in bf16 and f16 at head dims
// 64 and 128: TMA-fed wgmma tiles with a warp-specialised producer.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_kernel (the
// Pallas TPU kernel) for 16-bit inputs; flash_attention.cu beside it keeps
// f32 and head dims 16/32.  Same function: for q [B, H, Sq, D] and k, v
// [B, Hkv, Skv, D] (any batch/head/sequence strides, unit stride along D)
// it writes o [B, H, Sq, D] in q's dtype:
//
//   s[i, j] = (q_i . k_j) * scale, set to -1e30 where masked
//   o_i     = sum_j softmax_j(s[i, :]) v_j
//
// A position j is masked when j >= Skv and, if causal, when j > i or (with
// window > 0) j <= i - window.  Query head h reads KV head h / (H / Hkv),
// which is a tensor-map coordinate: K and V are never broadcast.  The mask
// value is -1e30, not -inf, as in the reference: a row's first block, when
// wholly masked, adds exp(0) terms that the next correction
// exp(m_prev - m_new) wipes out exactly.  The normaliser is clamped at
// 1e-30 before the division.
//
// Bound.  At the serving call (B 8, H 32, S 2048, D 64, causal) the causal
// pairs need 137 GFLOP against 268 MB of inputs and output: the tensor
// cores' 989 TFLOP/s bound it, not the bytes, and only wgmma reaches that
// rate.  Done on the CUDA cores in fp32 the same work cannot take less
// than 2 ms.
//
// Design.  One CTA per (batch*head, 128-row query tile), heaviest causal
// tiles first; three warpgroups.  Warpgroup 0 is the producer: it gives up
// registers (setmaxnreg), and one of its threads TMA-loads the Q tile once,
// then K and V tiles of 128 keys into a ring of STAGES buffers guarded by
// full and empty mbarriers.  Warpgroups 1 and 2 each own 64 query rows:
//   S = Q K^T      wgmma m64n128k16, both operands in shared memory
//   online softmax on the accumulator fragments in registers: each row
//                  sits in a quad of lanes, reduced with two shuffles; the
//                  scale is applied to the fp32 scores, with log2(e)
//                  folded in so exp is one ex2
//   O += P V       wgmma m64nDk16, P from registers in the input type (the
//                  accumulator layout is the A-fragment layout), V from
//                  shared memory through the transpose bit
// Tiles use the 128-byte swizzle: a row of 64 elements is one 128-byte
// swizzle row, so a D=128 tile is two column halves, each its own TMA box.
// Keys past Skv arrive as zeros from TMA and are masked by position; query
// rows past Sq are computed on zeros and never stored.  Blocks wholly above
// the diagonal or wholly before the window are skipped.  The reference
// keeps P in fp32; here P is rounded to the input type for the second
// product, a relative change of about 2^-9 (bf16) or 2^-12 (f16).

#include <type_traits>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;        // query rows per CTA: two consumers of 64
constexpr int BK = 128;        // keys per K/V tile
constexpr int STAGES = 2;      // depth of the K/V ring
constexpr int NT = 384;        // producer + two consumer warpgroups
constexpr int ATOM = 64;       // elements in one 128-byte swizzle row
constexpr int ROW_BYTES = 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;   // room to align to 1024
};

template <typename T>
__device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t a, uint64_t b,
                                       bool first) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (first) wgmma_ss_n128_bf16_first(d, a, b);
    else wgmma_ss_n128_bf16(d, a, b);
  } else {
    if (first) wgmma_ss_n128_f16_first(d, a, b);
    else wgmma_ss_n128_f16(d, a, b);
  }
}

template <typename T, int D>
__device__ __forceinline__ void mma_pv(float (&d)[D / 2], const uint32_t* a,
                                       uint64_t b) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (D == 64) {
    if constexpr (bf) wgmma_rs_n64_bf16(d, a, b);
    else wgmma_rs_n64_f16(d, a, b);
  } else {
    if constexpr (bf) wgmma_rs_n128_bf16(d, a, b);
    else wgmma_rs_n128_f16(d, a, b);
  }
}

// ---- the kernel ----------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   T* __restrict__ o, long long osb, long long osh,
                   long long oss, int H, int group, int Sq, int Skv,
                   float scale_log2, int causal, int window) {
  using L = Smem<D>;
  constexpr int HALVES = D / ATOM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / group;
  int kb_begin = 0;
  int kb_end = (Skv + BK - 1) / BK;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    kb_end = min(kb_end, q_last / BK + 1);
    if (window > 0) kb_begin = max(0, q0 - window + 1) / BK;
  }
  const int n_blocks = kb_end - kb_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load(sQ + hf * BQ * ROW_BYTES, &tm_q, bar_q, hf * ATOM, q0, h, b);
      for (int it = 0; it < n_blocks; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (kb_begin + it) * BK;
        mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load(sK + s * L::KV_BYTES + hf * BK * ROW_BYTES, &tm_k,
                   k_full(s), hf * ATOM, k0, hk, b);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load(sV + s * L::KV_BYTES + hf * BK * ROW_BYTES, &tm_v,
                   v_full(s), hf * ATOM, k0, hk, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 rows [0, 64), warpgroup 2 rows [64, 128) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_lo = q0 + cw * 64;           // this warpgroup's rows
  const int r0 = row_lo + warp * 16 + lane / 4;   // this thread's: r0, r0+8
  const int cq = (lane % 4) * 2;             // first column in each 8-group

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // l: this thread's part

  const uint32_t qa = sQ + cw * 64 * ROW_BYTES;
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_blocks; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = (kb_begin + it) * BK;

    // S = Q K^T: D/16 k-steps, 32 bytes each along the swizzled rows
    float sc[BK / 2];
    const uint32_t ka = sK + s * L::KV_BYTES;
    mbar_wait(k_full(s), ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da =
          sw128_desc(qa + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024);
      const uint64_t db =
          sw128_desc(ka + (kk / 4) * BK * ROW_BYTES + off, 16, 1024);
      mma_qk<T>(sc, da, db, kk == 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale (log2 domain), mask, online softmax.  Register i holds row
    // r0 + 8 * ((i / 2) % 2), key k0 + (i / 4) * 8 + cq + i % 2.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
    const bool partial =
        k0 + BK > Skv ||
        (causal && (k0 + BK - 1 > row_lo ||
                    (window > 0 && k0 <= row_lo + 63 - window)));
    if (partial) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = r0 + 8 * ((i / 2) % 2);
        const int col = k0 + (i / 4) * 8 + cq + (i % 2);
        bool ok = col < Skv;
        if (causal) {
          ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
        }
        if (!ok) sc[i] = NEG;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2 == 0) mx0 = fmaxf(mx0, sc[i]);
      else mx1 = fmaxf(mx1, sc[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2 == 0) {
        sc[i] = ex2(sc[i] - m0);
        ps0 += sc[i];
      } else {
        sc[i] = ex2(sc[i] - m1);
        ps1 += sc[i];
      }
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= ((i / 2) % 2 == 0) ? c0 : c1;
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);

    // O += P V: BK/16 k-steps of 16 keys (2048 bytes of V each)
    const uint32_t va = sV + s * L::KV_BYTES;
    mbar_wait(v_full(s), ph);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      mma_pv<T, D>(acc, pa + 4 * j,
                   sw128_desc(va + j * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: o = acc / max(l, 1e-30), rows past Sq never written
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = g * 8 + cq;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
          pack2<T>(acc[4 * g] / l0, acc[4 * g + 1] / l0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * oss + col) =
          pack2<T>(acc[4 * g + 2] / l1, acc[4 * g + 3] / l1);
  }
}

// ---- host side -------------------------------------------------------------

// A [B, Hn, S, D] operand as a 4-D tensor map (D, S, Hn, B), boxes of 64
// columns x `rows` rows, 128-byte swizzle, zeros outside.  st holds its
// (batch, head, sequence) element strides.
template <typename T>
CUresult encode(CUtensorMap* map, const void* ptr, int D, int S, int Hn, int B,
                const long long* st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Hn),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(st[2]) * sizeof(T),
      static_cast<cuuint64_t>(st[1]) * sizeof(T),
      static_cast<cuuint64_t>(st[0]) * sizeof(T)};
  const cuuint32_t box[4] = {ATOM, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return cuTensorMapEncodeTiled(map, dt, 4, const_cast<void*>(ptr), dims,
                                strides, box, unit,
                                CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_ERROR = 1000;   // + CUresult of cuTensorMapEncodeTiled

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Skv, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  auto kernel = flash_wgmma_kernel<T, D>;
  // setmaxnreg moves registers between the warpgroups of the CTA's own
  // allocation: the kernel must start with enough of them, or the
  // consumers' setmaxnreg.inc would wait forever.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * NT < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
    return cudaErrorInvalidConfiguration;
  const int smem = Smem<D>::ALLOC;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  CUresult r = encode<T>(&mq, q, D, Sq, H, B, st, BQ);
  if (r == CUDA_SUCCESS) r = encode<T>(&mk, k, D, Skv, Hkv, B, st + 3, BK);
  if (r == CUDA_SUCCESS) r = encode<T>(&mv, v, D, Skv, Hkv, B, st + 6, BK);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), st[9], st[10], st[11], H, H / Hkv, Sq,
      Skv, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int Hkv, int Sq, int Skv, const long long* st,
             float scale, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, st, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, st, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 1 bf16, 2 f16 (q, k, v and o share one).  strides holds 12
// element strides: (batch, head, sequence) of q, k, v and o, in that order;
// the head-dim stride is 1.  q, k and v need 16-byte aligned bases and
// sequence/head/batch strides of a multiple of 16 bytes (TMA); o needs
// even strides.  D is 64 or 128, Sq and Skv at least 1, B * H at most
// 65535.  Returns 0, a CUDA error code, or 1000 + the CUresult
// of a failed tensor-map encoding.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int dtype,
                                            int B, int H, int Hkv, int Sq,
                                            int Skv, int D,
                                            const long long* strides,
                                            float scale, int causal,
                                            int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st);
    case 2: return launch_d<__half>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}
