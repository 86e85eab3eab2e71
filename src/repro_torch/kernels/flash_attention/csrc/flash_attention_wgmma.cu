// Flash-attention forward for Hopper (sm_90a) at head dims 64 and 128:
// wgmma tiles with a warp-specialised producer, in two instances.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_kernel (the
// Pallas TPU kernel) at head dims 64 and 128; flash_attention.cu beside it
// keeps head dims 16 and 32.  Same function: for q [B, H, Sq, D] and k, v
// [B, Hkv, Skv, D] (any batch/head/sequence strides, unit stride along D)
// it writes o [B, H, Sq, D] in q's dtype:
//
//   s[i, j] = (q_i . k_j) * scale, set to -1e30 where masked
//   o_i     = sum_j softmax_j(s[i, :]) v_j
//
// A position j is masked when j >= Skv and, if causal, when j > i or (with
// window > 0) j <= i - window.  Query head h reads KV head h / (H / Hkv):
// K and V are never broadcast.  The mask value is -1e30, not -inf, as in
// the reference: a row's first block, when wholly masked, adds exp(0) terms
// that the next correction exp(m_prev - m_new) wipes out exactly.  The
// normaliser is clamped at 1e-30 before the division.
//
// Bound.  At the serving call (B 8, H 32, S 2048, D 64, causal) the causal
// pairs need 137 GFLOP against 268 MB of inputs and output in bf16: the
// tensor cores' 989 TFLOP/s bound it, not the bytes, and only wgmma
// reaches that rate.  Done on the CUDA cores in fp32 the same work cannot
// take less than 2 ms.  In fp32 the split below triples the products: 411
// GFLOP of bf16 work, 0.42 ms, against 536 MB (0.16 ms).
//
// Design.  One CTA per (batch*head, 128-row query tile), heaviest causal
// tiles first; three warpgroups.  Warpgroup 0 is the producer and fills a
// ring of STAGES K/V buffers guarded by full and empty mbarriers.
// Warpgroups 1 and 2 each own 64 query rows:
//   S = Q K^T      wgmma m64nNk16, both operands in shared memory
//   online softmax on the accumulator fragments in registers: each row
//                  sits in a quad of lanes, reduced with two shuffles; the
//                  scale is applied to the fp32 scores, with log2(e)
//                  folded in so exp is one ex2
//   O += P V       wgmma m64nDk16, P from registers (the accumulator layout
//                  is the A-fragment layout), V from shared memory through
//                  the transpose bit
// Tiles use the 128-byte swizzle: a row of 64 elements is one 128-byte
// swizzle row, so a D=128 tile is two column halves.  Keys past Skv arrive
// as zeros and are masked by position; query rows past Sq are computed on
// zeros and never stored.  Blocks wholly above the diagonal or wholly
// before the window are skipped.
//
// bf16 and f16 (flash_wgmma_kernel).  The producer gives up registers
// (setmaxnreg) and one of its threads TMA-loads the Q tile once, then K and
// V tiles of 128 keys.  The reference keeps P in fp32; here P is rounded to
// the input type for the second product, a relative change of about 2^-9
// (bf16) or 2^-12 (f16).
//
// f32 (flash_wgmma_split_kernel), under the split-precision contract: an
// fp32 operand enters the tensor cores only as hi = bf16(v), lo = bf16(v -
// hi); a product of two is hi.hi + hi.lo + lo.hi; every sum is fp32;
// nothing is rounded once to bf16 and nothing runs in TF32.  So
//   S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T
//   O += P_hi V_hi + P_hi V_lo + P_lo V_hi
// with P kept fp32 through the softmax and split into hi/lo register
// fragments.  What is left out (lo.lo, and v below lo) is about 2^-17
// relative per operand.  TMA copies and does not convert, so the split is
// made once per tile, by the producer: one of its threads keeps TMA loads
// of fp32 tiles (64 rows x D, unswizzled) in flight into NSTG staging
// buffers, and all 128 split each staged tile (16-byte shared loads) into
// hi and lo tiles in the 128-byte swizzle, fence the writes to the async
// proxy and arrive on the tile's mbarrier (128 arrivals).  Hi/lo tiles
// double the bf16 layout, so this instance takes K/V tiles of 64 keys: Q
// hi/lo + 2 stages x (K + V) hi/lo = 96 KB at D = 64, with 4 staging
// tiles of 16 KB (two key blocks ahead); 192 KB at D = 128, with the one
// staging tile of 32 KB that still fits.  Registers: the producer keeps
// 56, the consumers 224 (at D = 128: O 64, S 32, then P hi/lo 32).
//
// Every mbarrier wait traps after about 2^34 cycles (a lost arrival), and
// the launcher refuses a build with too few registers for setmaxnreg.

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

// The key blocks of NK keys a CTA of query rows [q0, q0 + BQ) visits: all
// of them, or under a causal mask none wholly above the diagonal and none
// wholly before the window.
template <int NK>
__device__ __forceinline__ void key_blocks(int q0, int Sq, int Skv,
                                           int causal, int window,
                                           int& begin, int& count) {
  begin = 0;
  int end = (Skv + NK - 1) / NK;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    end = min(end, q_last / NK + 1);
    if (window > 0) begin = max(0, q0 - window + 1) / NK;
  }
  count = end - begin;
}

// One thread's two rows of the online softmax, r0 and r0 + 8: the running
// maxima (log2 domain) and this thread's part of the normalisers.
struct Rows {
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  // the normalisers summed over the row's quad, clamped at 1e-30
  __device__ __forceinline__ void finish() {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
  }
};

// Scale (log2 domain), mask and exponentiate a block of NK scores, update
// the running maxima and normalisers and rescale acc by the correction.
// Score register i holds row r0 + 8 * ((i / 2) % 2), key
// k0 + (i / 4) * 8 + cq + i % 2; row_lo is the warpgroup's first row.
// Each row sits in a quad of lanes, reduced with two shuffles.
template <int NK, int NA>
__device__ __forceinline__ void online_softmax(float (&sc)[NK / 2],
                                               float (&acc)[NA], Rows& rs,
                                               int k0, int row_lo, int r0,
                                               int cq, int Skv, int causal,
                                               int window, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) sc[i] *= scale_log2;
  const bool partial =
      k0 + NK > Skv ||
      (causal && (k0 + NK - 1 > row_lo ||
                  (window > 0 && k0 <= row_lo + 63 - window)));
  if (partial) {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
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
  float mx0 = rs.m0, mx1 = rs.m1;
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    if ((i / 2) % 2 == 0) mx0 = fmaxf(mx0, sc[i]);
    else mx1 = fmaxf(mx1, sc[i]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float c0 = ex2(rs.m0 - mx0), c1 = ex2(rs.m1 - mx1);
  rs.m0 = mx0;
  rs.m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    if ((i / 2) % 2 == 0) {
      sc[i] = ex2(sc[i] - mx0);
      ps0 += sc[i];
    } else {
      sc[i] = ex2(sc[i] - mx1);
      ps1 += sc[i];
    }
  }
  rs.l0 = rs.l0 * c0 + ps0;
  rs.l1 = rs.l1 * c1 + ps1;
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] *= ((i / 2) % 2 == 0) ? c0 : c1;
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
  int kb_begin, n_blocks;
  key_blocks<BK>(q0, Sq, Skv, causal, window, kb_begin, n_blocks);

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
  Rows rs;

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

    online_softmax<BK>(sc, acc, rs, k0, row_lo, r0, cq, Skv, causal, window,
                       scale_log2);
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
  rs.finish();
  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = g * 8 + cq;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * oss + col) =
          pack2<T>(acc[4 * g] / rs.l0, acc[4 * g + 1] / rs.l0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * oss + col) =
          pack2<T>(acc[4 * g + 2] / rs.l1, acc[4 * g + 3] / rs.l1);
  }
}

// ---- the fp32 instance: split precision ---------------------------------

constexpr int BKS = 64;        // keys per K/V tile of the fp32 instance
constexpr int SPLIT_PRODUCER_REGS = 56, SPLIT_CONSUMER_REGS = 224;

// Q's hi and lo tiles, then per stage the hi and lo tiles of K and of V,
// each in the 128-byte swizzle (a D = 128 tile is two column halves);
// then NSTG fp32 staging tiles of 64 rows, which TMA fills.
template <int D>
struct SplitSmem {
  static constexpr int Q_BYTES = BQ * D * 2;     // one bf16 part of Q
  static constexpr int T_BYTES = BKS * D * 2;    // one bf16 part of K or V
  static constexpr int QL_OFF = Q_BYTES;
  static constexpr int KV_OFF = 2 * Q_BYTES;     // K hi, K lo, V hi, V lo
  static constexpr int STAGE_BYTES = 4 * T_BYTES;
  static constexpr int STG_OFF = KV_OFF + STAGES * STAGE_BYTES;
  static constexpr int STG_BYTES = BKS * D * 4;  // one fp32 tile of 64 rows
  static constexpr int NSTG = D == 64 ? 4 : 1;   // what is left of 227 KB
  static constexpr int BAR_OFF = STG_OFF + NSTG * STG_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES],
  // staged[NSTG]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * STAGES + NSTG) * 8;
  static constexpr int ALLOC = BYTES + 1024;    // room to align to 1024
};
static_assert(SplitSmem<64>::ALLOC <= 232448, "over the 227 KB a CTA may use");
static_assert(SplitSmem<128>::ALLOC <= 232448, "over the 227 KB a CTA may use");

// One staged fp32 tile of 64 rows x D (dense, row-major) split into hi and
// lo bf16 tiles in the 128-byte swizzle, as rows [row0, row0 + 64) of
// destination tiles of R rows, by the 128 producer threads: each takes
// chunks of 8 values (two 16-byte shared loads, one 16-byte store per
// part).
template <int D, int R>
__device__ __forceinline__ void split_staged(const float* stg,
                                             unsigned char* hi,
                                             unsigned char* lo, int row0,
                                             int pt) {
  constexpr int CPR = D / 8;             // chunks per row
  constexpr int PER = BKS * CPR / 128;   // chunks per thread
#pragma unroll 2
  for (int i = 0; i < PER; ++i) {
    const int c = pt + 128 * i;
    const int r = c / CPR, cc = c % CPR;
    const float4* src = reinterpret_cast<const float4*>(stg + r * D + cc * 8);
    const float4 a = src[0], b = src[1];
    uint4 h, l;
    split2(a.x, a.y, h.x, l.x);
    split2(a.z, a.w, h.y, l.y);
    split2(b.x, b.y, h.z, l.z);
    split2(b.z, b.w, h.w, l.w);
    const int row = row0 + r;
    const uint32_t off = (cc / 8) * R * ROW_BYTES + row * ROW_BYTES +
                         ((((cc % 8) ^ row) & 7) << 4);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// fp32 q, k, v and o at head dim D under the split-precision contract:
// every fp32 operand enters the tensor cores only as hi = bf16(v),
// lo = bf16(v - hi); a product of two is hi.hi + hi.lo + lo.hi; every sum
// is fp32 (the wgmma accumulators).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         float* __restrict__ o, long long osb, long long osh,
                         long long oss, int H, int group, int Sq, int Skv,
                         float scale_log2, int causal, int window) {
  using L = SplitSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR_OFF;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto staged = [&](int s) { return bar_q + 8u * (1 + 3 * STAGES + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / group;
  int kb_begin, n_blocks;
  key_blocks<BKS>(q0, Sq, Skv, causal, window, kb_begin, n_blocks);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 128);             // every producer thread
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 128);
      mbar_init(v_full(s), 128);
      mbar_init(empty(s), 8);          // lane 0 of each consumer warp
    }
    for (int s = 0; s < L::NSTG; ++s) mbar_init(staged(s), 1);   // TMA
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 keeps TMA loads of fp32 tiles in flight,
    // all 128 threads split each staged tile into the bf16 ring.  Tiles
    // in order: Q rows [0, 64) and [64, 128), then K and V of each key
    // block. ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(SPLIT_PRODUCER_REGS));
    const int pt = threadIdx.x;
    const int total = 2 + 2 * n_blocks;
    const CUtensorMap* mq = &tm_q;
    const CUtensorMap* mk = &tm_k;
    const CUtensorMap* mv = &tm_v;
    auto load_tile = [&](int t) {
      const int slot = t % L::NSTG;
      const uint32_t dst = base + L::STG_OFF + slot * L::STG_BYTES;
      mbar_expect_tx(staged(slot), L::STG_BYTES);
      if (t < 2)
        tma_load(dst, mq, staged(slot), 0, q0 + t * BKS, h, b);
      else
        tma_load(dst, t % 2 ? mv : mk, staged(slot), 0,
                 (kb_begin + (t - 2) / 2) * BKS, hk, b);
    };
    if (pt == 0)
      for (int t = 0; t < min(L::NSTG, total); ++t) load_tile(t);
    for (int t = 0; t < total; ++t) {
      const int slot = t % L::NSTG;
      const int it = (t - 2) / 2, s = it % STAGES;
      if (t >= 2 && t % 2 == 0)
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
      mbar_wait(staged(slot), (t / L::NSTG) & 1);
      const float* stg = reinterpret_cast<const float*>(
          gbase + L::STG_OFF + slot * L::STG_BYTES);
      if (t < 2) {
        split_staged<D, BQ>(stg, gbase, gbase + L::QL_OFF, t * BKS, pt);
      } else {
        unsigned char* st = gbase + L::KV_OFF + s * L::STAGE_BYTES +
                            (t % 2) * 2 * L::T_BYTES;
        split_staged<D, BKS>(stg, st, st + L::T_BYTES, 0, pt);
      }
      fence_proxy_async();
      if (t == 1) mbar_arrive(bar_q);
      else if (t >= 2) mbar_arrive(t % 2 ? v_full(s) : k_full(s));
      // every thread is done with the staged tile before TMA refills it
      named_bar_sync(1, 128);
      if (pt == 0 && t + L::NSTG < total) load_tile(t + L::NSTG);
    }
    return;
  }

  // ---- consumers: warpgroup 1 rows [0, 64), warpgroup 2 rows [64, 128) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(SPLIT_CONSUMER_REGS));
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row_lo = q0 + cw * 64;
  const int r0 = row_lo + warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  Rows rs;
  const uint32_t qh = base + cw * 64 * ROW_BYTES;
  const uint32_t ql = qh + L::QL_OFF;
  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_blocks; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = (kb_begin + it) * BKS;
    const uint32_t kh = base + L::KV_OFF + s * L::STAGE_BYTES;
    const uint32_t kl = kh + L::T_BYTES;
    const uint32_t vh = kh + 2 * L::T_BYTES, vl = kh + 3 * L::T_BYTES;

    // S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T
    float sc[BKS / 2];
#pragma unroll
    for (int i = 0; i < BKS / 2; ++i) sc[i] = 0.f;
    mbar_wait(k_full(s), ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * BQ * ROW_BYTES + off;
      const uint32_t ko = (kk / 4) * BKS * ROW_BYTES + off;
      const uint64_t ah = sw128_desc(qh + qo, 16, 1024);
      const uint64_t al = sw128_desc(ql + qo, 16, 1024);
      const uint64_t bh_ = sw128_desc(kh + ko, 16, 1024);
      const uint64_t bl_ = sw128_desc(kl + ko, 16, 1024);
      wgmma_ss_n64_bf16<0, 0>(sc, ah, bh_, 1);
      wgmma_ss_n64_bf16<0, 0>(sc, ah, bl_, 1);
      wgmma_ss_n64_bf16<0, 0>(sc, al, bh_, 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    online_softmax<BKS>(sc, acc, rs, k0, row_lo, r0, cq, Skv, causal,
                        window, scale_log2);
    // P stays fp32 until it is split into hi/lo A fragments
    uint32_t pah[BKS / 4], pal[BKS / 4];
#pragma unroll
    for (int i = 0; i < BKS / 4; ++i)
      split2(sc[2 * i], sc[2 * i + 1], pah[i], pal[i]);

    // O += P_hi V_hi + P_hi V_lo + P_lo V_hi
    mbar_wait(v_full(s), ph);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BKS / 16; ++j) {
      const uint64_t dh =
          sw128_desc(vh + j * 16 * ROW_BYTES, BKS * ROW_BYTES, 1024);
      const uint64_t dl =
          sw128_desc(vl + j * 16 * ROW_BYTES, BKS * ROW_BYTES, 1024);
      mma_pv<__nv_bfloat16, D>(acc, pah + 4 * j, dh);
      mma_pv<__nv_bfloat16, D>(acc, pah + 4 * j, dl);
      mma_pv<__nv_bfloat16, D>(acc, pal + 4 * j, dh);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s));
  }

  rs.finish();
  float* ob = o + b * osb + h * osh;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = g * 8 + cq;
    if (r0 < Sq)
      *reinterpret_cast<float2*>(ob + r0 * oss + col) =
          make_float2(acc[4 * g] / rs.l0, acc[4 * g + 1] / rs.l0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<float2*>(ob + (r0 + 8) * oss + col) =
          make_float2(acc[4 * g + 2] / rs.l1, acc[4 * g + 3] / rs.l1);
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

// setmaxnreg moves registers between the warpgroups of the CTA's own
// allocation: the kernel must start with enough of them, or the consumers'
// setmaxnreg.inc would wait forever.
template <typename K>
cudaError_t prepare(K kernel, int producer_regs, int consumer_regs,
                    int smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * NT < 128 * producer_regs + 256 * consumer_regs)
    return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Skv, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  auto kernel = flash_wgmma_kernel<T, D>;
  const int smem = Smem<D>::ALLOC;
  const cudaError_t err =
      prepare(kernel, PRODUCER_REGS, CONSUMER_REGS, smem);
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

// A [B, Hn, S, D] fp32 operand as a 4-D tensor map (D, S, Hn, B), boxes of
// D columns x 64 rows, unswizzled (the staging tiles), zeros outside.
CUresult encode_f32(CUtensorMap* map, const void* ptr, int D, int S, int Hn,
                    int B, const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Hn),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 4,
                                 static_cast<cuuint64_t>(st[1]) * 4,
                                 static_cast<cuuint64_t>(st[0]) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), BKS, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                const_cast<void*>(ptr), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_split(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Hkv, int Sq, int Skv, const long long* st,
                 float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_wgmma_split_kernel<D>;
  const int smem = SplitSmem<D>::ALLOC;
  const cudaError_t err =
      prepare(kernel, SPLIT_PRODUCER_REGS, SPLIT_CONSUMER_REGS, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  CUresult r = encode_f32(&mq, q, D, Sq, H, B, st);
  if (r == CUDA_SUCCESS) r = encode_f32(&mk, k, D, Skv, Hkv, B, st + 3);
  if (r == CUDA_SUCCESS) r = encode_f32(&mv, v, D, Skv, Hkv, B, st + 6);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<float*>(o), st[9], st[10], st[11], H, H / Hkv,
      Sq, Skv, scale * LOG2E, causal, window);
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

// dtype codes: 0 f32 (the split-precision instance), 1 bf16, 2 f16 (q, k,
// v and o share one).  strides holds 12 element strides: (batch, head,
// sequence) of q, k, v and o, in that order; the head-dim stride is 1.  q,
// k and v need 16-byte aligned bases and sequence/head/batch strides of a
// multiple of 16 bytes (TMA, and the f32 instance's 16-byte loads); o
// needs even strides.  D is 64 or 128, Sq and Skv at least 1, B * H at most
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
    case 0:
      switch (D) {
        case 64: return launch_split<64>(q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st);
        case 128: return launch_split<128>(q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st);
        default: return cudaErrorInvalidValue;
      }
    case 1: return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st);
    case 2: return launch_d<__half>(D, q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}
