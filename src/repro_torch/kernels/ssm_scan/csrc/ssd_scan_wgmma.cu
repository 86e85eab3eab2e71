// Chunked SSD (mamba2) scan for Hopper (sm_90a) on bf16 tensor cores, from
// a given or a zero state: TMA-fed wgmma tiles, one CTA per stream.
//
// Replaces repro/kernels/ssm_scan/kernel.py::_ssd_kernel (the Pallas TPU
// kernel) at every head dim P and state dim N up to 64 (multiples of 8; the
// wrapper pads others with zeros) and any configured chunk, for any L and
// any B/C dtype, in two instances: bf16 B and C (ssd_scan_wgmma_launch),
// and f32 or f16 B and C (ssd_scan_split_launch, the split instance); each
// at two chunk tiles, 128 steps (for L > 64) and 64 (the short kernel, for
// L <= 64; see below).
// Same function: for every (batch b, head h) stream, with x [B, L, H, P]
// f32 (dt folded in), the decay a [B, L, H] f32 and B, C [B, L, N] shared
// by all heads (read at batch b), per chunk of Q steps (the tile: 128, or
// 64 in the short kernel) with cum the inclusive cumsum of
// log(max(a, 1e-20)):
//
//   M[i, j]  = (C_i . B_j) exp(cum_i - cum_j) for i >= j, else exactly 0
//   y_i      = sum_j M[i, j] x_j + exp(cum_i) (C_i . S^T)
//   S       <- exp(cum_{Q-1}) S + sum_j exp(cum_{Q-1} - cum_j) x_j^T B_j
//
// Steps past L are read as a = 1 and x = B = C = 0 (TMA fills the rows
// with zeros) and are not written: a ragged tail, and a sequence shorter
// than one chunk, which is one chunk padded to the tile.  That is the
// reference's arithmetic at Q = min(chunk, L): the padded steps add 0 to
// cum and nothing to y or the state; only the rounding differs.  The
// chunk only sets the blocking of one linear recurrence, so the tile need
// not be the configured chunk: a configured chunk of 16 runs at the tile
// too, and computes the same function up to rounding.
//
// Tiles are 64 wide along P and N whatever the call's P and N.  The tensor
// maps carry the real P and N, so TMA's out-of-bounds fill writes zeros in
// the columns past them; zero columns of x, B and C, and the zero rows and
// columns of the state past P and N, add nothing to y or to the state.
// The initial state is read, and y and the final state written, only
// inside the real P and N.  At P = N = 64 each kernel runs as its own
// instance (FULL), in which those masks fold away.
// Outputs: y [B, L, H, P] f32 and the final state [B, H, P, N] f32.  The
// state before the first step is the initial state [B, H, P, N] f32 where
// one is given, else zero: warpgroup 0 loads it into its state
// accumulator, in the accumulator's fragment layout (the inverse of the
// final store), so the first chunk's C.S^T sees it through the same hi/lo
// split as every later chunk.
//
// Precision contract.  In the bf16 instance B and C enter the tensor cores
// exactly.  Every fp32 operand (x, the decay matrix M, the carried state S,
// x scaled by the decay to the chunk's end) enters only as an
// error-compensated split, hi = bf16(v), lo = bf16(v - hi):
//   C.B^T           one bf16 product (both exact)
//   C.S^T           C.S_hi^T + C.S_lo^T
//   M.x             M_hi.x_hi + M_hi.x_lo + M_lo.x_hi
//   (x*dout)^T.B    xd_hi^T.B + xd_lo^T.B
// and every sum accumulates in fp32 (the wgmma accumulators).  What is left
// out (lo.lo, and the part of v below lo) is about 2^-17 relative per
// operand; no fp32 operand is rounded once to bf16, and nothing runs in
// TF32.  In the split instance B and C are fp32 (or f16) operands too, so
// each product with one of them takes three: C_hi.B_hi^T + C_hi.B_lo^T +
// C_lo.B_hi^T, C_hi.S_hi^T + C_hi.S_lo^T + C_lo.S_hi^T, and xd_hi^T.B_hi +
// xd_hi^T.B_lo + xd_lo^T.B_hi: 12 products against the bf16 instance's 8.
// An f16 value splits exactly.
//
// Bound.  At the serving call (B 8, L 2048, H 64, P = N = 64, Q = 128) the
// scan must move about 553 MB (x and y in f32 dominate): 0.165 ms at 3.35
// TB/s.  Its 34.6 GFLOP would take 0.52 ms on the CUDA cores in fp32; split
// into bf16 products it is about 80 GFLOP of tensor-core work, under 0.1 ms
// (about 120 GFLOP, 0.12 ms, in the split instance).
//
// Design.  One CTA per stream walks its chunks in order and keeps the fp32
// state on chip, so device memory sees each input once and never the state
// (a chunk-parallel scheme would write and re-read per-chunk states).  Three
// warpgroups:
//   warpgroup 2 (producer) gives up registers (setmaxnreg) and one warp of
//     it works: for chunk c it waits for ring slot c % 2 to be free,
//     TMA-loads x (f32, unswizzled), B and C (bf16, 128-byte swizzle) into
//     it, then computes the chunk's cumsum (a warp scan of log a), exp(cum)
//     and exp(cum_last - cum) into the slot: the next chunk's loads and scan
//     run while the consumers work on this one.
//   warpgroup 0 (rows 0-63) and warpgroup 1 (rows 64-127), consumers:
//     1. issue C.B^T (wgmma, both K-major from shared memory; warpgroup 0
//        needs only keys 0-63, n64, warpgroup 1 all 128, n128), and while
//        the tensor cores run it, split x and x*dout into hi/lo bf16 tiles
//        (128-byte swizzle, shared by both); warpgroup 0, which holds the
//        state as a m64n64 wgmma accumulator (32 registers a thread),
//        writes S_hi/S_lo tiles;
//     2. issue y = C.S^T (C K-major, S K-major), and while it runs apply
//        the decay to the C.B^T fragments in registers, exponentiating
//        only i >= j, and split M into hi/lo register-A fragments (the
//        accumulator layout is the A layout); then y *= exp(cum_i);
//     3. y += M.x: register-A wgmma against the x tiles read MN-major;
//        warpgroup 0 skips the k-steps of keys 64-127, which it never sees;
//     4. warpgroup 0 only: S = exp(cum_last) S + xd^T.B (both operands
//        MN-major from shared memory), balancing warpgroup 1's extra
//        k-steps of step 3, in a group of its own;
//     5. y goes straight from registers to device memory (under step 4);
//        the ring slot is released.
//   Two named barriers a chunk order the consumers around the shared split
//   tiles.  The consumers raise their registers to 224 (setmaxnreg): at
//   the 168 a thread that 384 threads start with, warpgroup 0 (the state,
//   C.B^T, y and the M fragments live at once) spills.
//
// Shared memory (bytes) at Q = 128, one CTA per SM:
//   x f32, 2 stages                  65,536
//   B and C bf16, 2 stages           65,536
//   x hi/lo, xd hi/lo bf16           65,536   (single: rewritten each chunk)
//   S hi/lo bf16                     16,384
//   cum, exp(cum), dout, 2 stages     3,072
//   mbarriers                            64   -> 216,128 + 1,024 to align
// Only the inputs are double-buffered.  A second set of split tiles would
// let the next chunk's split overlap this chunk's products, but its 64 KB
// do not fit.
//
// The split instance.  TMA copies and does not convert, and hi/lo B and C
// tiles of one chunk take the 64 KB that two stages of bf16 B and C take.
// So a small pre-pass kernel (split_bc_kernel, ssd_scan_split_bc_launch,
// launched first on the same stream) splits B and C once per batch into
// four bf16 planes in scratch memory: B hi, B lo, C hi, C lo [Bsz, L, 64]
// each (all H streams of a
// batch read the same rows, so splitting per stream would repeat the work
// H times).  The scan then TMA-loads a chunk's four tiles into a single
// B/C stage guarded by bc_full / bc_empty, while x stays double-buffered:
// the shared-memory layout above is unchanged.  The producer refills the
// B/C stage once the consumers release the previous chunk's, after it has
// loaded the next x and computed its cumsum.
//
// The short kernel (ssd_short_kernel, Q = 64).  A sequence of 1 <= L <= 64
// steps is one chunk padded to 64 steps, not to 128: half the rows, and
// products of half the keys.  One warpgroup of 128 threads does all of it:
// warp 0 issues the chunk's TMA loads (one stage, no ring: there is no
// next chunk to prefetch) and computes its cumsum while they land, then
// the four warps run warpgroup 0's body above on rows 0-63.  No producer
// and no setmaxnreg: a thread may keep 255 registers.  Its shared memory
// is the layout above at Q = 64 with one stage (x 16 KB, B/C 32 KB, the
// split tiles 32 KB, S 16 KB, cum 768 bytes: 99,112 + 1,024 bytes), so two
// CTAs share an SM: the 512 streams of B 8 x H 64 run in two waves over
// 132 SMs instead of four, the serving launcher's 256 (B 4) in one.
//
// Set-up.  Each kernel instance's dynamic shared memory is set (and the
// 128-step kernel's registers checked) once per device, not per launch.
// The tensor maps are encoded on every launch: they hold the tensors'
// addresses, which change from call to call.
//
// Every mbarrier wait traps after about 2^34 cycles (a lost arrival), and
// the launcher refuses a build with too few registers for setmaxnreg.

#include <atomic>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int TP = 64;          // the tiles' width along the head dim P
constexpr int TN = 64;          // and along the state dim N
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr float LOG2E = 1.4426950408889634f;

// The shared-memory layout of one CTA at a chunk tile of Q_ steps: Q_ =
// 128 (two stages of inputs, two consumer warpgroups and a producer
// warpgroup) or Q_ = 64 (the short instance: one stage, one warpgroup).
template <int Q_>
struct Tile {
  static constexpr int Q = Q_;                       // chunk
  static constexpr int STAGES = Q == 128 ? 2 : 1;    // depth of the ring
  static constexpr int NC = 2 * Q;    // consumer threads: Q / 64 warpgroups
  // and the producer warpgroup at Q 128
  static constexpr int THREADS = Q == 128 ? NC + 128 : NC;
  static constexpr int X_BYTES = Q * TP * 4;     // f32 [Q][TP], unswizzled
  static constexpr int BC_BYTES = Q * TN * 2;    // bf16 [Q][TN], 128B swizzle
  static constexpr int T_BYTES = Q * 64 * 2;     // a bf16 split tile [Q][64]
  static constexpr int S_BYTES = TP * TN * 2;    // a bf16 state tile [TP][TN]
  static constexpr int CUM_BYTES = 3 * Q * 4;    // cum, exp(cum), dout
  static constexpr int X_OFF = 0;
  // B/C: four tiles, two stages of B and C (bf16 instance at Q 128; at Q
  // 64 one stage), or one stage of B hi, B lo, C hi, C lo (split)
  static constexpr int B_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int C_OFF = B_OFF + STAGES * BC_BYTES;
  static constexpr int XH_OFF = B_OFF + 4 * BC_BYTES;
  static constexpr int XL_OFF = XH_OFF + T_BYTES;
  static constexpr int DH_OFF = XL_OFF + T_BYTES;
  static constexpr int DL_OFF = DH_OFF + T_BYTES;
  static constexpr int SH_OFF = DL_OFF + T_BYTES;
  static constexpr int SL_OFF = SH_OFF + S_BYTES;
  static constexpr int CUM_OFF = SL_OFF + S_BYTES;
  static constexpr int BAR_OFF = CUM_OFF + STAGES * CUM_BYTES;
  // barriers: full[STAGES] (TMA), cum_full[STAGES] (cumsum warp),
  // empty[STAGES] (lane 0 of each consumer warp), and for the split
  // instance bc_full (TMA) and bc_empty (lane 0 of each consumer warp)
  static constexpr int SMEM_BYTES = BAR_OFF + (3 * STAGES + 2) * 8;
  static constexpr int ALLOC = SMEM_BYTES + 1024;   // room to align to 1024
  static_assert(ALLOC <= 232448, "over the 227 KB a CTA may use");
  static_assert(SH_OFF % 1024 == 0 && XH_OFF % 1024 == 0 &&
                B_OFF % 1024 == 0, "tile alignment");
};
using T128 = Tile<128>;
using T64 = Tile<64>;
constexpr int NT = T128::THREADS;
// two 64-step CTAs share an SM: 2 x 128 threads x 255 registers fit its
// 65,536, and 2 x ALLOC its 228 KB of shared memory
static_assert(2 * (T64::ALLOC + 1024) <= 233472, "two short CTAs an SM");

// K-major 128-byte-swizzled operand: rows of 64 bf16, 8-row groups 1024
// bytes apart.  MN-major: the same tile read along its rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return sw_desc<128>(addr, 16, 1024);
}
template <int Q>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return sw_desc<128>(addr, Q * 128, 1024);
}

struct Ctx {
  uint32_t base;            // shared address of the aligned buffer
  unsigned char* gbase;     // its generic address
  float* y;                 // y at (b, step 0, h)
  long long yst;
  float* state;             // the final state of this stream [P][N]
  const float* init;        // its initial state [P][N], or null (zero)
  int L, n_chunks;
  int P, N;                 // the real head and state dims (<= 64)
};

template <int Q>
__device__ __forceinline__ uint32_t bar_full(uint32_t base, int s) {
  return base + Tile<Q>::BAR_OFF + 8u * s;
}
template <int Q>
__device__ __forceinline__ uint32_t bar_cum(uint32_t base, int s) {
  return base + Tile<Q>::BAR_OFF + 8u * (Tile<Q>::STAGES + s);
}
template <int Q>
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int s) {
  return base + Tile<Q>::BAR_OFF + 8u * (2 * Tile<Q>::STAGES + s);
}
template <int Q>
__device__ __forceinline__ uint32_t bar_bc_full(uint32_t base) {
  return base + Tile<Q>::BAR_OFF + 8u * (3 * Tile<Q>::STAGES);
}
template <int Q>
__device__ __forceinline__ uint32_t bar_bc_empty(uint32_t base) {
  return base + Tile<Q>::BAR_OFF + 8u * (3 * Tile<Q>::STAGES + 1);
}

// Where chunk stage s's B and C tiles lie.  bf16 instance: B and C,
// STAGES stages each.  Split instance: one stage of B hi, B lo, C hi, C lo
// (the lo tiles are hi + BC_BYTES).
template <int Q, bool SPLIT>
__device__ __forceinline__ uint32_t b_tile(uint32_t base, int s) {
  using T = Tile<Q>;
  return SPLIT ? base + T::B_OFF : base + T::B_OFF + s * T::BC_BYTES;
}
template <int Q, bool SPLIT>
__device__ __forceinline__ uint32_t c_tile(uint32_t base, int s) {
  using T = Tile<Q>;
  return SPLIT ? base + T::B_OFF + 2 * T::BC_BYTES
               : base + T::C_OFF + s * T::BC_BYTES;
}

// Consumer warpgroup W: chunk rows [64 W, 64 W + 64).  FROM_STATE: the
// state before the first chunk is cx.init (else zero); a template
// argument, so that the scan from zero compiles as it did without it.
// SPLIT: B and C arrive as bf16 hi/lo tiles, and every product with one
// of them takes three products (hi.hi + hi.lo + lo.hi).  FULL: P = N =
// 64, the tiles' widths, known when compiling, so that the masks past the
// real P and N fold away: with them the full-width call ran 2% slower.
template <int Q, int W, bool FROM_STATE, bool SPLIT, bool FULL>
__device__ __forceinline__ void consume(const Ctx& cx) {
  using T = Tile<Q>;
  constexpr int NC = T::NC;
  constexpr int KS = (W + 1) * 4;       // k-steps of 16 keys in M.x
  constexpr int NCB = (W + 1) * 64;     // keys of C.B^T this group needs
  const int t = threadIdx.x;            // 0..NC-1
  const int warp = (t % 128) / 32, lane = t % 32;
  const int rl = warp * 16 + lane / 4;  // this thread's rows: rl, rl + 8
  const int i0 = W * 64 + rl;
  const int cq = (lane % 4) * 2;        // first column in each 8-group
  const uint32_t base = cx.base;
  const int P = FULL ? TP : cx.P, N = FULL ? TN : cx.N;

  // the state (warpgroup 0): register 4 g + 2 r + c holds row rl + 8 r,
  // column 8 g + cq + c, as the final store below writes it; zero past the
  // real P and N (which are multiples of 8)
  float S[32];
  if (W == 0 && FROM_STATE) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int n = g * 8 + cq;
      const float2 zero = make_float2(0.f, 0.f);
      const bool in = FULL || n < N;
      const float2 s0 =
          in && (FULL || rl < P)
              ? *reinterpret_cast<const float2*>(cx.init + rl * N + n)
              : zero;
      const float2 s1 =
          in && (FULL || rl + 8 < P)
              ? *reinterpret_cast<const float2*>(cx.init + (rl + 8) * N + n)
              : zero;
      S[4 * g] = s0.x;
      S[4 * g + 1] = s0.y;
      S[4 * g + 2] = s1.x;
      S[4 * g + 3] = s1.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = 0.f;
  }

  for (int ck = 0; ck < cx.n_chunks; ++ck) {
    const int s = ck % T::STAGES;
    const uint32_t ph = (ck / T::STAGES) & 1;
    const int t0 = ck * Q;
    const uint32_t bs = b_tile<Q, SPLIT>(base, s);
    const uint32_t cs = c_tile<Q, SPLIT>(base, s);
    const float* xf = reinterpret_cast<const float*>(
        cx.gbase + T::X_OFF + s * T::X_BYTES);
    const float* cum = reinterpret_cast<const float*>(
        cx.gbase + T::CUM_OFF + s * T::CUM_BYTES);
    const float* ecum = cum + Q;
    const float* dout = cum + 2 * Q;
    // B and C first: C.B^T needs neither x nor the cumsum
    if constexpr (SPLIT) mbar_wait(bar_bc_full<Q>(base), ck & 1);
    else mbar_wait(bar_full<Q>(base, s), ph);

    // 1a. cb = C.B^T, issued first: the tensor cores run it under the split
    float cb[NCB / 2];
#pragma unroll
    for (int i = 0; i < NCB / 2; ++i) cb[i] = 0.f;
    const uint32_t ca = cs + W * 64 * 128;    // this group's 64 rows of C
    wg_fence();
    // split: C_hi.B_hi^T + C_hi.B_lo^T + C_lo.B_hi^T
#pragma unroll
    for (int p = 0; p < (SPLIT ? 3 : 1); ++p) {
      const uint32_t cp = ca + (p == 2 ? T::BC_BYTES : 0);
      const uint32_t bp = bs + (p == 1 ? T::BC_BYTES : 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (W == 0)
          wgmma_ss_n64_bf16<0, 0>(cb, kmajor(cp + kk * 32),
                                  kmajor(bp + kk * 32), 1);
        else
          wgmma_ss_n128_bf16(cb, kmajor(cp + kk * 32), kmajor(bp + kk * 32));
      }
    }
    wg_commit();
    fence_regs(cb);
    if constexpr (SPLIT) mbar_wait(bar_full<Q>(base, s), ph);    // x
    mbar_wait(bar_cum<Q>(base, s), ph);

    // 1b. split x and xd = x * dout: four 16-byte chunks of 8 values a thread
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = t + NC * k;
      const int row = c >> 3, q = c & 7;
      const float4* src =
          reinterpret_cast<const float4*>(xf + row * TP + q * 8);
      const float4 v0 = src[0], v1 = src[1];
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      const float dj = dout[row];
      uint4 xh, xl, dh, dl;
      split2(v[0], v[1], xh.x, xl.x);
      split2(v[2], v[3], xh.y, xl.y);
      split2(v[4], v[5], xh.z, xl.z);
      split2(v[6], v[7], xh.w, xl.w);
      split2(v[0] * dj, v[1] * dj, dh.x, dl.x);
      split2(v[2] * dj, v[3] * dj, dh.y, dl.y);
      split2(v[4] * dj, v[5] * dj, dh.z, dl.z);
      split2(v[6] * dj, v[7] * dj, dh.w, dl.w);
      const uint32_t off = row * 128 + (((q ^ row) & 7) << 4);
      *reinterpret_cast<uint4*>(cx.gbase + T::XH_OFF + off) = xh;
      *reinterpret_cast<uint4*>(cx.gbase + T::XL_OFF + off) = xl;
      *reinterpret_cast<uint4*>(cx.gbase + T::DH_OFF + off) = dh;
      *reinterpret_cast<uint4*>(cx.gbase + T::DL_OFF + off) = dl;
    }
    // the state entering this chunk, as S_hi/S_lo
    if (W == 0 && (ck > 0 || FROM_STATE)) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int n = g * 8 + cq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split2(S[4 * g + 2 * r], S[4 * g + 2 * r + 1], hi, lo);
          const uint32_t off = sw128_offset(rl + 8 * r, n);
          *reinterpret_cast<uint32_t*>(cx.gbase + T::SH_OFF + off) = hi;
          *reinterpret_cast<uint32_t*>(cx.gbase + T::SL_OFF + off) = lo;
        }
      }
    }
    fence_proxy_async();
    named_bar_sync(1, NC);

    // 2a. y = C.S^T (from the second chunk on, or from the first with an
    // initial state), under the decay below;
    // y is first live here, which keeps the split above free of spills
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    if (ck > 0 || FROM_STATE) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64_bf16<0, 0>(y, kmajor(ca + kk * 32),
                                kmajor(base + T::SH_OFF + kk * 32), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64_bf16<0, 0>(y, kmajor(ca + kk * 32),
                                kmajor(base + T::SL_OFF + kk * 32), 1);
      if constexpr (SPLIT) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64_bf16<0, 0>(y, kmajor(ca + T::BC_BYTES + kk * 32),
                                  kmajor(base + T::SH_OFF + kk * 32), 1);
      }
      wg_commit();
      fence_regs(y);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    fence_regs(cb);

    // 2b. M = cb * exp(cum_i - cum_j) for i >= j, split into A fragments.
    // Register i holds row i0 + 8 * ((i / 2) % 2), key (i / 4) * 8 + cq + i % 2.
    const float c0 = cum[i0], c1 = cum[i0 + 8];
    uint32_t mh[NCB / 4], ml[NCB / 4];
#pragma unroll
    for (int i = 0; i < NCB / 2; i += 2) {
      const bool top = (i / 2) % 2 == 0;
      const int row = top ? i0 : i0 + 8;
      const float cr = top ? c0 : c1;
      const int col = (i / 4) * 8 + cq;
      const float m0 =
          col <= row ? cb[i] * ex2((cr - cum[col]) * LOG2E) : 0.f;
      const float m1 =
          col + 1 <= row ? cb[i + 1] * ex2((cr - cum[col + 1]) * LOG2E) : 0.f;
      split2(m0, m1, mh[i / 2], ml[i / 2]);
    }
    if constexpr (W == 0) {
      const float decay = ecum[Q - 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) S[i] *= decay;
    }
    wg_wait<0>();
    fence_regs(y);
    const float e0 = ecum[i0], e1 = ecum[i0 + 8];   // y *= exp(cum_i)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] *= ((i / 2) % 2 == 0) ? e0 : e1;

    // 3. y += M.x;  4. S += xd^T.B (warpgroup 0), a group of its own so
    // that y is stored while it runs
    fence_regs(y);
    if constexpr (W == 0) fence_regs(S);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t xh = mnmajor<Q>(base + T::XH_OFF + ks * 16 * 128);
      const uint64_t xl = mnmajor<Q>(base + T::XL_OFF + ks * 16 * 128);
      wgmma_rs_n64_bf16(y, mh + 4 * ks, xh);
      wgmma_rs_n64_bf16(y, mh + 4 * ks, xl);
      wgmma_rs_n64_bf16(y, ml + 4 * ks, xh);
    }
    wg_commit();
    fence_regs(y);
    if constexpr (W == 0) {
#pragma unroll
      for (int ks = 0; ks < Q / 16; ++ks) {
        const uint64_t bt = mnmajor<Q>(bs + ks * 16 * 128);
        const uint64_t dh = mnmajor<Q>(base + T::DH_OFF + ks * 16 * 128);
        wgmma_ss_n64_bf16<1, 1>(S, dh, bt, 1);
        wgmma_ss_n64_bf16<1, 1>(
            S, mnmajor<Q>(base + T::DL_OFF + ks * 16 * 128), bt, 1);
        if constexpr (SPLIT)
          wgmma_ss_n64_bf16<1, 1>(
              S, dh, mnmajor<Q>(bs + T::BC_BYTES + ks * 16 * 128), 1);
      }
      wg_commit();
      fence_regs(S);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    fence_regs(y);

    // 5. store y (rows past L and columns past P never), release the slot,
    // wait for the other group before the split tiles are rewritten
    float* yb = cx.y + static_cast<long long>(t0) * cx.yst;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int col = g * 8 + cq;
      if ((FULL || col < P) && t0 + i0 < cx.L)
        *reinterpret_cast<float2*>(yb + i0 * cx.yst + col) =
            make_float2(y[4 * g], y[4 * g + 1]);
      if ((FULL || col < P) && t0 + i0 + 8 < cx.L)
        *reinterpret_cast<float2*>(yb + (i0 + 8) * cx.yst + col) =
            make_float2(y[4 * g + 2], y[4 * g + 3]);
    }
    if constexpr (W == 0) {
      wg_wait<0>();
      fence_regs(S);
    }
    if (lane == 0) {
      mbar_arrive(bar_empty<Q>(base, s));
      if constexpr (SPLIT) mbar_arrive(bar_bc_empty<Q>(base));
    }
    named_bar_sync(1, NC);
  }

  if constexpr (W == 0) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int n = g * 8 + cq;
      if (FULL || (n < N && rl < P))
        *reinterpret_cast<float2*>(cx.state + rl * N + n) =
            make_float2(S[4 * g], S[4 * g + 1]);
      if (FULL || (n < N && rl + 8 < P))
        *reinterpret_cast<float2*>(cx.state + (rl + 8) * N + n) =
            make_float2(S[4 * g + 2], S[4 * g + 3]);
    }
  }
}

__device__ __forceinline__ uint32_t aligned_base(unsigned char* smem_raw,
                                                 unsigned char** gbase) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  *gbase = smem_raw + (base - raw);
  return base;
}

template <int Q>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  for (int s = 0; s < Tile<Q>::STAGES; ++s) {
    mbar_init(bar_full<Q>(base, s), 1);
    mbar_init(bar_cum<Q>(base, s), 32);     // every lane of the cumsum warp
    // lane 0 of each consumer warp
    mbar_init(bar_empty<Q>(base, s), Tile<Q>::NC / 32);
  }
  mbar_init(bar_bc_full<Q>(base), 1);
  mbar_init(bar_bc_empty<Q>(base), Tile<Q>::NC / 32);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: TMA-load chunk stage s's x (and, in the bf16 instance, its
// B and C) onto the stage's full barrier.
template <int Q, bool SPLIT>
__device__ __forceinline__ void load_x_bc(uint32_t base, int s, int t0, int b,
                                          int h, const CUtensorMap* tm_x,
                                          const CUtensorMap* tm_b,
                                          const CUtensorMap* tm_c) {
  using T = Tile<Q>;
  const uint32_t full = bar_full<Q>(base, s);
  mbar_expect_tx(full, SPLIT ? T::X_BYTES : T::X_BYTES + 2 * T::BC_BYTES);
  tma_load(base + T::X_OFF + s * T::X_BYTES, tm_x, full, 0, t0, h, b);
  if constexpr (!SPLIT) {
    tma_load_3d(base + T::B_OFF + s * T::BC_BYTES, tm_b, full, 0, t0, b);
    tma_load_3d(base + T::C_OFF + s * T::BC_BYTES, tm_c, full, 0, t0, b);
  }
}

// One thread, split instance: TMA-load the chunk's B hi, B lo, C hi, C lo
// tiles onto bc_full (tm_b maps the four planes as batches p * Bsz + b).
template <int Q>
__device__ __forceinline__ void load_planes(uint32_t base, int t0, int b,
                                            int Bsz, const CUtensorMap* tm_b) {
  using T = Tile<Q>;
  const uint32_t full = bar_bc_full<Q>(base);
  mbar_expect_tx(full, 4 * T::BC_BYTES);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    tma_load_3d(base + T::B_OFF + p * T::BC_BYTES, tm_b, full, 0, t0,
                p * Bsz + b);
}

// One warp: chunk stage s's inclusive cumsum of log(max(a, 1e-20)) (Q / 32
// steps a lane, then a scan across lanes; steps past L decay by 1), with
// exp(cum) and exp(cum_last - cum), into the stage's cum tile; then every
// lane arrives on the stage's cum barrier.
template <int Q>
__device__ __forceinline__ void chunk_cumsum(uint32_t base,
                                             unsigned char* gbase, int s,
                                             int t0, const float* ap,
                                             long long ast, int L, int lane) {
  using T = Tile<Q>;
  constexpr int PER = Q / 32;
  float v[PER], run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int tt = t0 + lane * PER + k;
    const float av = tt < L ? ap[static_cast<long long>(tt) * ast] : 1.f;
    run += logf(fmaxf(av, 1e-20f));
    v[k] = run;
  }
  float off = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, off, d);
    if (lane >= d) off += o;
  }
  const float last = __shfl_sync(0xffffffffu, off, 31);
  off -= run;      // exclusive prefix of this lane's total
  float* cs = reinterpret_cast<float*>(gbase + T::CUM_OFF + s * T::CUM_BYTES);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane * PER + k;
    const float c = off + v[k];
    cs[j] = c;
    cs[Q + j] = expf(c);
    cs[2 * Q + j] = expf(last - c);
  }
  mbar_arrive(bar_cum<Q>(base, s));
}

// The 128-step instance: any L, chunk after chunk, through the ring.
template <bool FROM_STATE, bool SPLIT, bool FULL>
__global__ void __launch_bounds__(NT, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ a, float* __restrict__ y,
                 float* __restrict__ state_out,
                 const float* __restrict__ init_state, int L, int H, int P,
                 int N, long long asb, long long ast, long long ash,
                 long long ysb, long long yst, long long ysh) {
  using T = T128;
  constexpr int Q = 128, NC = T::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gbase;
  const uint32_t base = aligned_base(smem_raw, &gbase);
  if (threadIdx.x == 0) init_barriers<Q>(base);
  __syncthreads();
  // Values live across setmaxnreg are spilled: each side computes its own
  // after it.
  if (threadIdx.x >= NC) {
    // ---- producer: one warp of the last warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x >= NC + 32) return;
    const int lane = threadIdx.x % 32;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int n_chunks = (L + Q - 1) / Q;
    const float* ap = a + b * asb + h * ash;
    for (int ck = 0; ck < n_chunks; ++ck) {
      const int s = ck % T::STAGES;
      const int t0 = ck * Q;
      mbar_wait(bar_empty<Q>(base, s), ((ck / T::STAGES) & 1) ^ 1);
      if (lane == 0)
        load_x_bc<Q, SPLIT>(base, s, t0, b, h, &tm_x, &tm_b, &tm_c);
      chunk_cumsum<Q>(base, gbase, s, t0, ap, ast, L, lane);
      // split: the single B/C stage is refilled once the consumers are
      // done with the previous chunk's
      if constexpr (SPLIT) {
        if (lane == 0) {
          mbar_wait(bar_bc_empty<Q>(base), (ck & 1) ^ 1);
          load_planes<Q>(base, t0, b, gridDim.x / H, &tm_b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_chunks = (L + Q - 1) / Q;
  Ctx cx{base, gbase, y + b * ysb + h * ysh, yst,
         state_out + static_cast<long long>(blockIdx.x) * P * N,
         init_state ? init_state + static_cast<long long>(blockIdx.x) * P * N
                    : nullptr,
         L, n_chunks, P, N};
  if (threadIdx.x < 128) consume<Q, 0, FROM_STATE, SPLIT, FULL>(cx);
  else consume<Q, 1, FROM_STATE, SPLIT, FULL>(cx);
}

// The 64-step instance, for 1 <= L <= 64: one chunk, one stage, one
// warpgroup of 128 threads (no producer, no setmaxnreg: a thread may hold
// 255 registers and two CTAs share an SM).  Warp 0 issues the chunk's
// loads and computes its cumsum while the TMA copies land; then all four
// warps run warpgroup 0's body of the 128-step instance on rows 0-63.
template <bool FROM_STATE, bool SPLIT, bool FULL>
__global__ void __launch_bounds__(T64::NC, 2)
ssd_short_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const float* __restrict__ a, float* __restrict__ y,
                 float* __restrict__ state_out,
                 const float* __restrict__ init_state, int L, int H, int P,
                 int N, long long asb, long long ast, long long ash,
                 long long ysb, long long yst, long long ysh) {
  constexpr int Q = 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gbase;
  const uint32_t base = aligned_base(smem_raw, &gbase);
  if (threadIdx.x == 0) init_barriers<Q>(base);
  __syncthreads();
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) {
      load_x_bc<Q, SPLIT>(base, 0, 0, b, h, &tm_x, &tm_b, &tm_c);
      if constexpr (SPLIT) load_planes<Q>(base, 0, b, gridDim.x / H, &tm_b);
    }
    chunk_cumsum<Q>(base, gbase, 0, 0, a + b * asb + h * ash, ast, L, lane);
  }
  Ctx cx{base, gbase, y + b * ysb + h * ysh, yst,
         state_out + static_cast<long long>(blockIdx.x) * P * N,
         init_state ? init_state + static_cast<long long>(blockIdx.x) * P * N
                    : nullptr,
         L, 1, P, N};
  consume<Q, 0, FROM_STATE, SPLIT, FULL>(cx);
}

// The split instance's pre-pass: B and C (f32 or f16, [Bsz, L, N] with
// the caller's strides, N a multiple of 8) into bf16 planes [4][Bsz][L][N]:
// B hi, B lo, C hi, C lo.  Once per batch, not per stream: all H heads read
// the same rows.
// An f16 value splits exactly (its 11 significant bits fit in two bf16
// parts).  One thread per 8 values.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T>
__global__ void split_bc_kernel(const T* __restrict__ Bm,
                                const T* __restrict__ Cm, long long bsb,
                                long long bst, long long csb, long long cst,
                                __nv_bfloat16* __restrict__ out, int Bsz,
                                int L, int N) {
  const long long rows = static_cast<long long>(Bsz) * L;
  const int cpr = N / 8;                  // chunks of 8 values a row
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * rows * cpr) return;
  const int q = static_cast<int>(i % cpr);
  const long long r = (i / cpr) % rows;
  const int which = static_cast<int>(i / (rows * cpr));   // 0 B, 1 C
  const long long b = r / L, t = r % L;
  const T* src = which ? Cm + b * csb + t * cst : Bm + b * bsb + t * bst;
  float v[8];
  load8(src + q * 8, v);
  uint4 hi, lo;
  split2(v[0], v[1], hi.x, lo.x);
  split2(v[2], v[3], hi.y, lo.y);
  split2(v[4], v[5], hi.z, lo.z);
  split2(v[6], v[7], hi.w, lo.w);
  *reinterpret_cast<uint4*>(out + ((2 * which) * rows + r) * N + q * 8) = hi;
  *reinterpret_cast<uint4*>(out + ((2 * which + 1) * rows + r) * N + q * 8) =
      lo;
}

// ---- host side -------------------------------------------------------------

// x [B, L, H, P] f32 as a 4-D map (P, L, H, B), boxes of 64 x Q steps
// (zeros past P and L), unswizzled; st: its (batch, step, head) element
// strides.
CUresult encode_x(CUtensorMap* map, const void* x, int L, int H, int B,
                  int P, int Q, const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 4,
                                 static_cast<cuuint64_t>(st[2]) * 4,
                                 static_cast<cuuint64_t>(st[0]) * 4};
  const cuuint32_t box[4] = {TP, static_cast<cuuint32_t>(Q), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                const_cast<void*>(x), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// B or C [B, L, N] bf16 as a 3-D map (N, L, B), boxes of 64 x Q steps
// (zeros past N and L), 128-byte swizzle; sb, st: its batch and step
// element strides.
CUresult encode_bc(CUtensorMap* map, const void* p, int L, int B, int N,
                   int Q, long long sb, long long st) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {TN, static_cast<cuuint32_t>(Q), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                const_cast<void*>(p), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_ERROR = 1000;   // + CUresult of cuTensorMapEncodeTiled
constexpr int MAX_DEVICES = 64;

// both kernels' type (they take the same parameters)
using ScanKernel = decltype(&ssd_wgmma_kernel<false, false, false>);

template <int Q, bool FROM_STATE, bool SPLIT, bool FULL>
ScanKernel kernel_of() {
  if constexpr (Q == 128) return ssd_wgmma_kernel<FROM_STATE, SPLIT, FULL>;
  else return ssd_short_kernel<FROM_STATE, SPLIT, FULL>;
}

// Set up one kernel instance on the current device, once per device: its
// dynamic shared memory, and a check of its registers.  setmaxnreg moves
// registers between the warpgroups of the 128-step CTA's own allocation:
// the kernel must start with enough of them, or the consumers'
// setmaxnreg.inc would wait forever.  The 64-step CTA does not use
// setmaxnreg.  Returns 0 or a CUDA error code.
template <int Q, bool FROM_STATE, bool SPLIT, bool FULL>
int prepare() {
  const ScanKernel kernel = kernel_of<Q, FROM_STATE, SPLIT, FULL>();
  static std::atomic<unsigned long long> ready{0};   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < MAX_DEVICES ? 1ull << dev : 0;
  if (ready.load(std::memory_order_acquire) & bit) return 0;
  if constexpr (Q == 128) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * NT < 128 * PRODUCER_REGS + T128::NC * CONSUMER_REGS)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<Q>::ALLOC);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready.fetch_or(bit, std::memory_order_release);
  return 0;
}

// Launch one instance of the scan (Q: its chunk tile).  The split instance
// reads all four B/C planes through mb (mc is not read).
template <int Q, bool FROM_STATE, bool SPLIT, bool FULL>
int launch_scan(const CUtensorMap& mx, const CUtensorMap& mb,
                const CUtensorMap& mc, const void* a, void* y,
                void* state_out, const void* init_state, int Bsz, int L,
                int H, int P, int N, const long long* st,
                cudaStream_t stream) {
  const int err = prepare<Q, FROM_STATE, SPLIT, FULL>();
  if (err) return err;
  kernel_of<Q, FROM_STATE, SPLIT, FULL>()
      <<<Bsz * H, Tile<Q>::THREADS, Tile<Q>::ALLOC, stream>>>(
          mx, mb, mc, static_cast<const float*>(a), static_cast<float*>(y),
          static_cast<float*>(state_out),
          static_cast<const float*>(init_state), L, H, P, N, st[3], st[4],
          st[5], st[10], st[11], st[12]);
  return static_cast<int>(cudaGetLastError());
}

// Encode the maps and launch the bf16 (SPLIT false) or split instance at
// chunk tile Q.
template <int Q, bool SPLIT>
int run_scan(const void* x, const void* a, const void* Bm, const void* Cm,
             void* y, void* state_out, const void* init_state, int Bsz,
             int L, int H, int P, int N, const long long* st, void* stream) {
  CUtensorMap mx, mb, mc;
  CUresult r = encode_x(&mx, x, L, H, Bsz, P, Q, st);
  // the split instance's planes [4][Bsz][L][N] are 4 Bsz batches
  if (r == CUDA_SUCCESS)
    r = encode_bc(&mb, Bm, L, SPLIT ? 4 * Bsz : Bsz, N, Q, st[6], st[7]);
  if (r == CUDA_SUCCESS && !SPLIT)
    r = encode_bc(&mc, Cm, L, Bsz, N, Q, st[8], st[9]);
  if (r != CUDA_SUCCESS) return ENCODE_ERROR + static_cast<int>(r);
  const CUtensorMap& mcs = SPLIT ? mb : mc;
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const bool full = P == TP && N == TN;
  if (init_state)
    return full ? launch_scan<Q, true, SPLIT, true>(mx, mb, mcs, a, y,
                                                    state_out, init_state,
                                                    Bsz, L, H, P, N, st, strm)
                : launch_scan<Q, true, SPLIT, false>(mx, mb, mcs, a, y,
                                                     state_out, init_state,
                                                     Bsz, L, H, P, N, st,
                                                     strm);
  return full ? launch_scan<Q, false, SPLIT, true>(mx, mb, mcs, a, y,
                                                   state_out, init_state, Bsz,
                                                   L, H, P, N, st, strm)
              : launch_scan<Q, false, SPLIT, false>(mx, mb, mcs, a, y,
                                                    state_out, init_state,
                                                    Bsz, L, H, P, N, st,
                                                    strm);
}

// A head or state dim the kernel takes: a multiple of 8 up to the tile.
bool dim_ok(int d, int tile) { return d >= 8 && d <= tile && d % 8 == 0; }

template <int Q, bool FROM_STATE, bool SPLIT>
int ctas_per_sm() {
  const int err = prepare<Q, FROM_STATE, SPLIT, true>();
  if (err) return -err;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of<Q, FROM_STATE, SPLIT, true>(), Tile<Q>::THREADS,
      Tile<Q>::ALLOC);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
using CtasFn = int (*)();

}  // namespace

// bc_dtype 1 (bf16), P and N multiples of 8 from 8 to 64, L >= 1, and Q_
// the chunk tile: 128 (any L, a sequence shorter than one chunk is one
// chunk padded with steps of a = 1 and x = B = C = 0) or 64 (the short
// instance, for L <= 64, padded to 64 steps the same way).  strides holds
// 13 element strides: x (batch, step, head), a (batch, step, head), B
// (batch, step), C (batch, step), y (batch, step, head); the innermost
// strides of x, B, C and y are 1.  x, B and C need 16-byte aligned bases
// and strides of a multiple of 16 bytes (TMA); y 8-byte alignment.  The
// final state is written contiguous [B*H, P, N]; init_state, contiguous
// [B*H, P, N] f32 with 8-byte alignment, is the state before step 0
// (null: zero).  Returns 0, a CUDA error code, or 1000 + the CUresult of a
// failed tensor-map encoding.
extern "C" int ssd_scan_wgmma_launch(const void* x, const void* a,
                                     const void* Bm, const void* Cm,
                                     int bc_dtype, void* y, void* state_out,
                                     const void* init_state,
                                     int Bsz, int L, int H, int P_, int N_,
                                     int Q_, const long long* st,
                                     void* stream) {
  if (bc_dtype != 1 || !dim_ok(P_, TP) || !dim_ok(N_, TN) || L < 1 ||
      !(Q_ == 128 || (Q_ == 64 && L <= 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  return Q_ == 128
             ? run_scan<128, false>(x, a, Bm, Cm, y, state_out, init_state,
                                    Bsz, L, H, P_, N_, st, stream)
             : run_scan<64, false>(x, a, Bm, Cm, y, state_out, init_state,
                                   Bsz, L, H, P_, N_, st, stream);
}

// How many CTAs of an instance (Q_ 128 or 64, split 0 or 1, from_state 0
// or 1) fit on one SM of the current device, after its set-up; or minus
// a CUDA error code.
extern "C" int ssd_scan_wgmma_ctas_per_sm(int Q_, int split,
                                          int from_state) {
  static const CtasFn table[2][2][2] = {
      {{ctas_per_sm<64, false, false>, ctas_per_sm<64, true, false>},
       {ctas_per_sm<64, false, true>, ctas_per_sm<64, true, true>}},
      {{ctas_per_sm<128, false, false>, ctas_per_sm<128, true, false>},
       {ctas_per_sm<128, false, true>, ctas_per_sm<128, true, true>}}};
  if (Q_ != 64 && Q_ != 128) return -static_cast<int>(cudaErrorInvalidValue);
  return table[Q_ == 128][split != 0][from_state != 0]();
}

// The split instance's pre-pass: B and C (bc_dtype 0 f32 or 2 f16, [Bsz,
// L, N], N a multiple of 8 from 8 to 64; st holds their batch and step
// element strides, B's then C's, with unit stride along N, 16-byte aligned
// bases and strides of a multiple of 16 bytes) into planes, 4 * Bsz * L *
// N bf16 values, 16-byte aligned: B hi, B lo, C hi, C lo, each [Bsz, L,
// N].  Returns 0 or a CUDA error code.
extern "C" int ssd_scan_split_bc_launch(const void* Bm, const void* Cm,
                                        int bc_dtype, int Bsz, int L, int N,
                                        const long long* st, void* planes,
                                        void* stream) {
  if ((bc_dtype != 0 && bc_dtype != 2) || L < 1 || !dim_ok(N, TN) ||
      planes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<__nv_bfloat16*>(planes);
  const long long threads = 2LL * Bsz * L * (N / 8);
  const int blocks = static_cast<int>((threads + 255) / 256);
  if (bc_dtype == 0)
    split_bc_kernel<float><<<blocks, 256, 0, strm>>>(
        static_cast<const float*>(Bm), static_cast<const float*>(Cm), st[0],
        st[1], st[2], st[3], out, Bsz, L, N);
  else
    split_bc_kernel<__half><<<blocks, 256, 0, strm>>>(
        static_cast<const __half*>(Bm), static_cast<const __half*>(Cm),
        st[0], st[1], st[2], st[3], out, Bsz, L, N);
  return static_cast<int>(cudaGetLastError());
}

// The split instance, after the pre-pass: the interface of
// ssd_scan_wgmma_launch with Bm = Cm = the pre-pass's planes (their batch
// and step strides in st[6], st[7]; st[8], st[9] are not read) and
// bc_dtype 0 or 2, the dtype the planes were split from.
extern "C" int ssd_scan_split_launch(const void* x, const void* a,
                                     const void* Bm, const void* Cm,
                                     int bc_dtype, void* y, void* state_out,
                                     const void* init_state,
                                     int Bsz, int L, int H, int P_, int N_,
                                     int Q_, const long long* st,
                                     void* stream) {
  if ((bc_dtype != 0 && bc_dtype != 2) || !dim_ok(P_, TP) ||
      !dim_ok(N_, TN) || L < 1 || !(Q_ == 128 || (Q_ == 64 && L <= 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  return Q_ == 128
             ? run_scan<128, true>(x, a, Bm, Cm, y, state_out, init_state,
                                   Bsz, L, H, P_, N_, st, stream)
             : run_scan<64, true>(x, a, Bm, Cm, y, state_out, init_state,
                                  Bsz, L, H, P_, N_, st, stream);
}
