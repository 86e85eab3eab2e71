// Flash-attention forward for Hopper (sm_90a) at head dims 16, 32, 64 and
// 128: wgmma tiles with a warp-specialised producer, in two instances.
//
// Replaces repro/kernels/flash_attention/kernel.py::_flash_kernel (the
// Pallas TPU kernel) at every head dim the port takes.  Same function: for
// q [B, H, Sq, D] and k, v [B, Hkv, Skv, D] (any batch/head/sequence
// strides, unit stride along D) it writes o [B, H, Sq, D] in q's dtype:
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
// GFLOP of bf16 work, 0.42 ms, against 536 MB (0.16 ms).  At the reduced
// configs' head dim 16 the products shrink fourfold and the softmax does
// not: one ex2 a causal pair (5.4e8 at B 8, H 32, S 2048) on the SFUs' 16
// a clock an SM sets the floor, about 0.15 ms, above the tensor term.
//
// Design.  One CTA per (batch*head, 128-row query tile), heaviest causal
// tiles first; three warpgroups.  Warpgroup 0 is the producer and fills a
// ring of STAGES K/V buffers guarded by full and empty mbarriers.
// Warpgroups 1 and 2 each own 64 query rows:
//   S = Q K^T      wgmma m64nNk16, both operands in shared memory, D/16
//                  k-steps
//   online softmax on the accumulator fragments in registers: each row
//                  sits in a quad of lanes, reduced with two shuffles; the
//                  scale is applied to the fp32 scores, with log2(e)
//                  folded in so exp is one ex2
//   O += P V       wgmma m64nDk16, P from registers (the accumulator layout
//                  is the A-fragment layout), V from shared memory through
//                  the transpose bit
// D is a template parameter.  A tile's rows are AT = min(D, 64) elements,
// RB = 2 AT bytes (32, 64 or 128), stored in the RB-byte swizzle that TMA
// writes and the descriptors name (hopper.cuh: sw_desc); a D = 128 tile is
// two column halves of 64.  Keys past Skv arrive as zeros and are masked by
// position; query rows past Sq are computed on zeros and never stored.
// Blocks wholly above the diagonal or wholly before the window are
// skipped.
//
// bf16 and f16 (flash_wgmma_kernel).  The producer gives up registers
// (setmaxnreg, at D >= 64) and one of its threads TMA-loads the Q tile
// once, then K and V tiles of 128 keys.  The reference keeps P in fp32;
// here P is rounded to the input type for the second product, a relative
// change of about 2^-9 (bf16) or 2^-12 (f16).
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
// hi and lo tiles in the swizzle, fence the writes to the async proxy and
// arrive on the tile's mbarrier (128 arrivals).  Hi/lo tiles double the
// bf16 layout, so this instance takes K/V tiles of 64 keys.
//
// Shared memory (bytes, + 1,024 to align, + the mbarriers):
//   bf16/f16: Q + STAGES x (K + V)
//     D 16   4,096 + 4 x 8,192 = 36,864
//     D 32   8,192 + 4 x 16,384 = 73,728
//     D 64   16,384 + 2 x 32,768 = 81,920
//     D 128  32,768 + 2 x 65,536 = 163,840
//   f32: Q hi/lo + STAGES x (K + V) hi/lo + NSTG fp32 staging tiles
//     D 16   8,192 + 4 x 8,192 + 8 x 4,096 = 73,728
//     D 32   16,384 + 4 x 16,384 + 8 x 8,192 = 147,456
//     D 64   32,768 + 2 x 32,768 + 4 x 16,384 = 163,840
//     D 128  65,536 + 2 x 65,536 + 1 x 32,768 = 229,376
// At D <= 32 the tiles are small, so the rings are deeper: four key blocks
// in flight, eight staging tiles (four key blocks ahead of the split).
// Registers: 168 a thread at launch at most.  At D >= 64 the
// producer gives its registers to the consumers (setmaxnreg: 40 / 232 in
// the bf16 instance, 56 / 224 in the split one; at D = 128 O takes 64, S
// 64 and P 32 a thread).  At D <= 32 a consumer needs fewer than 168 (S 64,
// P 32, O 8 or 16 at D 16/32), so neither side moves any and the launcher
// asks for no register count.
//
// Set-up.  Each kernel instance's dynamic shared memory is set (and, where
// it uses setmaxnreg, its registers checked) once per device, not per
// launch.  The tensor maps are encoded on every launch: they hold the
// tensors' addresses.
//
// Every mbarrier wait traps after about 2^34 cycles (a lost arrival), and
// the launcher refuses a build with too few registers for setmaxnreg.

#include <atomic>
#include <type_traits>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;        // query rows per CTA: two consumers of 64
constexpr int BK = 128;        // keys per K/V tile
constexpr int NT = 384;        // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tile geometry at head dim D: rows of AT = min(D, 64) elements, RB
// bytes in the RB-byte swizzle, D / AT column halves; the depth of the K/V
// ring; whether the warpgroups move registers (setmaxnreg).
template <int D>
struct Geo {
  static constexpr int AT = D < 64 ? D : 64;
  static constexpr int RB = AT * 2;
  static constexpr int HALVES = D / AT;
  static constexpr int STAGES = D <= 32 ? 4 : 2;
  static constexpr bool MOVE_REGS = D >= 64;
};

template <int D>
struct Smem : Geo<D> {
  using G = Geo<D>;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + G::STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + G::STAGES * KV_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * G::STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;   // room to align to 1024
};

// Descriptor of k-step kk (16 columns) of a K-major tile of `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  using G = Geo<D>;
  constexpr int KPA = G::AT / 16;          // k-steps per column half
  return sw_desc<G::RB>(tile + (kk / KPA) * rows * G::RB + (kk % KPA) * 32,
                        16, 8 * G::RB);
}

// Descriptor of k-step j (16 keys) of an MN-major V tile of `rows` keys:
// column halves rows * RB bytes apart, 8-key groups 8 * RB apart.
template <int D>
__device__ __forceinline__ uint64_t vdesc(uint32_t tile, int rows, int j) {
  using G = Geo<D>;
  return sw_desc<G::RB>(tile + j * 16 * G::RB, rows * G::RB, 8 * G::RB);
}

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
  if constexpr (D == 16) {
    if constexpr (bf) wgmma_rs_n16_bf16(d, a, b);
    else wgmma_rs_n16_f16(d, a, b);
  } else if constexpr (D == 32) {
    if constexpr (bf) wgmma_rs_n32_bf16(d, a, b);
    else wgmma_rs_n32_f16(d, a, b);
  } else if constexpr (D == 64) {
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
  constexpr int STAGES = L::STAGES, RB = L::RB;
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
    if constexpr (L::MOVE_REGS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < L::HALVES; ++hf)
        tma_load(sQ + hf * BQ * RB, &tm_q, bar_q, hf * L::AT, q0, h, b);
      for (int it = 0; it < n_blocks; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (kb_begin + it) * BK;
        mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_load(sK + s * L::KV_BYTES + hf * BK * RB, &tm_k, k_full(s),
                   hf * L::AT, k0, hk, b);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_load(sV + s * L::KV_BYTES + hf * BK * RB, &tm_v, v_full(s),
                   hf * L::AT, k0, hk, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 rows [0, 64), warpgroup 2 rows [64, 128) ----
  if constexpr (L::MOVE_REGS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
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

  const uint32_t qa = sQ + cw * 64 * RB;
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
    for (int kk = 0; kk < D / 16; ++kk)
      mma_qk<T>(sc, kdesc<D>(qa, BQ, kk), kdesc<D>(ka, BK, kk), kk == 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    online_softmax<BK>(sc, acc, rs, k0, row_lo, r0, cq, Skv, causal, window,
                       scale_log2);
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);

    // O += P V: BK/16 k-steps of 16 keys
    const uint32_t va = sV + s * L::KV_BYTES;
    mbar_wait(v_full(s), ph);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      mma_pv<T, D>(acc, pa + 4 * j, vdesc<D>(va, BK, j));
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
// each in the swizzle of Geo<D> (a D = 128 tile is two column halves);
// then NSTG fp32 staging tiles of 64 rows, which TMA fills.
template <int D>
struct SplitSmem : Geo<D> {
  using G = Geo<D>;
  static constexpr int Q_BYTES = BQ * D * 2;     // one bf16 part of Q
  static constexpr int T_BYTES = BKS * D * 2;    // one bf16 part of K or V
  static constexpr int QL_OFF = Q_BYTES;
  static constexpr int KV_OFF = 2 * Q_BYTES;     // K hi, K lo, V hi, V lo
  static constexpr int STAGE_BYTES = 4 * T_BYTES;
  static constexpr int STG_OFF = KV_OFF + G::STAGES * STAGE_BYTES;
  static constexpr int STG_BYTES = BKS * D * 4;  // one fp32 tile of 64 rows
  // what is left of 227 KB
  static constexpr int NSTG = D <= 32 ? 8 : D == 64 ? 4 : 1;
  static constexpr int BAR_OFF = STG_OFF + NSTG * STG_BYTES;
  // barriers: q_full, k_full[STAGES], v_full[STAGES], empty[STAGES],
  // staged[NSTG]
  static constexpr int BYTES = BAR_OFF + (1 + 3 * G::STAGES + NSTG) * 8;
  static constexpr int ALLOC = BYTES + 1024;    // room to align to 1024
  static_assert(ALLOC <= 232448, "over the 227 KB a CTA may use");
};

// One staged fp32 tile of 64 rows x D (dense, row-major) split into hi and
// lo bf16 tiles in the swizzle of Geo<D>, as rows [row0, row0 + 64) of
// destination tiles of R rows, by the 128 producer threads: each takes
// chunks of 8 values (two 16-byte shared loads, one 16-byte store per
// part).
template <int D, int R>
__device__ __forceinline__ void split_staged(const float* stg,
                                             unsigned char* hi,
                                             unsigned char* lo, int row0,
                                             int pt) {
  using G = Geo<D>;
  constexpr int CPR = D / 8;             // chunks per row
  constexpr int CPA = G::AT / 8;         // chunks per column half's row
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
    const uint32_t off =
        (cc / CPA) * R * G::RB + sw_chunk<G::RB>(row, cc % CPA);
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
  constexpr int STAGES = L::STAGES, RB = L::RB;
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
    if constexpr (L::MOVE_REGS)
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
  if constexpr (L::MOVE_REGS)
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
  const uint32_t qh = base + cw * 64 * RB;
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
      const uint64_t ah = kdesc<D>(qh, BQ, kk);
      const uint64_t al = kdesc<D>(ql, BQ, kk);
      const uint64_t bh_ = kdesc<D>(kh, BKS, kk);
      const uint64_t bl_ = kdesc<D>(kl, BKS, kk);
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
      const uint64_t dh = vdesc<D>(vh, BKS, j);
      const uint64_t dl = vdesc<D>(vl, BKS, j);
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

// A [B, Hn, S, D] operand as a 4-D tensor map (D, S, Hn, B), boxes of AT
// columns x `rows` rows in the RB-byte swizzle (Geo<D>), zeros outside.
// st holds its (batch, head, sequence) element strides.
template <typename T, int D>
CUresult encode(CUtensorMap* map, const void* ptr, int S, int Hn, int B,
                const long long* st, int rows) {
  using G = Geo<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(Hn),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(st[2]) * sizeof(T),
      static_cast<cuuint64_t>(st[1]) * sizeof(T),
      static_cast<cuuint64_t>(st[0]) * sizeof(T)};
  const cuuint32_t box[4] = {G::AT, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const CUtensorMapSwizzle sw = G::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::RB == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return cuTensorMapEncodeTiled(map, dt, 4, const_cast<void*>(ptr), dims,
                                strides, box, unit,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

constexpr int ENCODE_ERROR = 1000;   // + CUresult of cuTensorMapEncodeTiled
constexpr int MAX_DEVICES = 64;

// Set up one kernel instance on the current device, once per device (a
// bit per device in the instance's own `ready`): its dynamic shared memory
// and, where it moves registers, a check of them.  setmaxnreg moves
// registers between the warpgroups of the CTA's own allocation: the kernel
// must start with enough of them, or the consumers' setmaxnreg.inc would
// wait forever.  Returns 0 or a CUDA error code.
template <bool MOVE_REGS, typename K>
int prepare(std::atomic<unsigned long long>& ready, K kernel,
            int producer_regs, int consumer_regs, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < MAX_DEVICES ? 1ull << dev : 0;
  if (ready.load(std::memory_order_acquire) & bit) return 0;
  if constexpr (MOVE_REGS) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * NT < 128 * producer_regs + 256 * consumer_regs)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready.fetch_or(bit, std::memory_order_release);
  return 0;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Skv, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = flash_wgmma_kernel<T, D>;
  const int smem = Smem<D>::ALLOC;
  const int err = prepare<Geo<D>::MOVE_REGS>(ready, kernel, PRODUCER_REGS,
                                             CONSUMER_REGS, smem);
  if (err) return err;
  CUtensorMap mq, mk, mv;
  CUresult r = encode<T, D>(&mq, q, Sq, H, B, st, BQ);
  if (r == CUDA_SUCCESS) r = encode<T, D>(&mk, k, Skv, Hkv, B, st + 3, BK);
  if (r == CUDA_SUCCESS) r = encode<T, D>(&mv, v, Skv, Hkv, B, st + 6, BK);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<T*>(o), st[9], st[10], st[11], H, H / Hkv, Sq,
      Skv, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

template <int D>
int launch_split(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Hkv, int Sq, int Skv, const long long* st,
                 float scale, int causal, int window, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  auto kernel = flash_wgmma_split_kernel<D>;
  const int smem = SplitSmem<D>::ALLOC;
  const int err = prepare<Geo<D>::MOVE_REGS>(ready, kernel,
                                             SPLIT_PRODUCER_REGS,
                                             SPLIT_CONSUMER_REGS, smem);
  if (err) return err;
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

using Launcher = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, const long long*, float, int,
                         int, cudaStream_t);

// The launcher of an instance: dtype code (0 f32, 1 bf16, 2 f16) by head
// dim (16, 32, 64, 128).
constexpr Launcher LAUNCHERS[3][4] = {
    {launch_split<16>, launch_split<32>, launch_split<64>, launch_split<128>},
    {launch<__nv_bfloat16, 16>, launch<__nv_bfloat16, 32>,
     launch<__nv_bfloat16, 64>, launch<__nv_bfloat16, 128>},
    {launch<__half, 16>, launch<__half, 32>, launch<__half, 64>,
     launch<__half, 128>}};

}  // namespace

// dtype codes: 0 f32 (the split-precision instance), 1 bf16, 2 f16 (q, k,
// v and o share one).  strides holds 12 element strides: (batch, head,
// sequence) of q, k, v and o, in that order; the head-dim stride is 1.  q,
// k and v need 16-byte aligned bases and sequence/head/batch strides of a
// multiple of 16 bytes (TMA, and the f32 instance's 16-byte loads); o
// needs even strides.  D is 16, 32, 64 or 128, Sq and Skv at least 1,
// B * H at most 65535.  Returns 0, a CUDA error code, or 1000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int dtype,
                                            int B, int H, int Hkv, int Sq,
                                            int Skv, int D,
                                            const long long* strides,
                                            float scale, int causal,
                                            int window, void* stream) {
  const int d = D == 16 ? 0 : D == 32 ? 1 : D == 64 ? 2 : D == 128 ? 3 : -1;
  if (dtype < 0 || dtype > 2 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return LAUNCHERS[dtype][d](q, k, v, o, B, H, Hkv, Sq, Skv, strides, scale,
                             causal, window,
                             static_cast<cudaStream_t>(stream));
}
