// Causal flash-attention forward (FlashAttention online softmax) over
// q [B, S, H, D] and k, v [B, S, KV, D] in bf16 (or f16: the build with
// DS_F16, below), writing o [B, S, H, D] in the inputs' type and the row
// logsumexp lse [B, H, S] in f32 (kept for the backward, csrc/flash_bwd.cu).
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py _flash_fwd
// (_fwd_kernel), the prefill attention of the serving path and the
// forward of the training path, in its causal, sliding-window and ALiBi
// modes, for any whole GQA group and head dims 64, 80, 96, 128 and 256.
//
// Bound on the H100: the work is 4 * D operations per live (query, key)
// pair per head against 2 * S * (H + 2 KV) * D bytes of q, k, v and o,
// about S / 4 operations per byte at D 128 causal: operations bind above
// S of roughly 1200 (the training shapes, the long prefills), bytes below
// (short prefills). So the design spends the tensor cores well and keeps
// everything else off their path:
//
// - One CTA takes BM = 128 query rows of one (batch, q head): two consumer
//   warpgroups of 64 rows each, and a producer warpgroup one thread of
//   which issues every load. setmaxnreg gives the consumers 240 registers
//   and the producer 24. Where B * H * ceil(S / 128) would not fill the
//   card (a single short prefill), the launcher takes 64-row CTAs with
//   one consumer warpgroup, two CTAs to an SM.
// - TMA loads the CTA's Q once and streams K and V tiles of BN keys
//   through a two-stage ring in shared memory, each stage with full and
//   empty mbarriers for K and for V, so the next tile's loads overlap this
//   tile's products. The tensor maps are 4-D over [B, S, heads, D]: a q
//   head and its KV head (h / (H / KV), any whole group, Falcon-7B's 71
//   over one) are coordinates, and K/V are never repeated in memory.
//   Rows past S arrive as TMA's out-of-bounds zeros. Tiles use the
//   128-byte swizzle, 64 bf16 columns to an atom.
// - S = Q K^T runs on wgmma (bf16 or f16 in, f32 accumulate) with both operands
//   in shared memory; the score tile never leaves registers. The online
//   softmax runs on the accumulator fragments (rows 16w + lane/4 and +8,
//   columns 8j + 2 (lane % 4) and +1): row max and sum across the 4
//   threads that share a row, the rescale of O in registers. P is rounded
//   to the inputs' type into wgmma A fragments in registers, and O += P V runs on
//   wgmma with V as the shared-memory B operand (MN-major: D contiguous).
//   The O accumulator stays in registers to the end.
// - Only the tiles that the diagonal or the window's left edge cuts take
//   mask arithmetic. The q tiles run heaviest first (the tile index is
//   reversed), so the longest causal rows do not form the tail.
// - The epilogue normalises by l, stages O through shared memory and
//   writes it as 16-byte vectors; rows past S write nothing. No atomics:
//   two launches on the same inputs give the same bits.
//
// Scores are kept in log2 units: x = s * (scale * log2 e), p = 2^(x - m),
// lse = m ln 2 + ln l. The products are written with the _rn intrinsics,
// never contracted, so each score takes the same arithmetic in every
// tile and mode.
//
// Sliding window (window > 0, Mistral-class): query row r attends to key
// column c iff r - window < c <= r. The K-tile loop starts at the first
// tile the band of the CTA's first row needs, max(q0 - window + 1, 0) /
// BN (the TPU kernel's _win_jbase), so the work scales with the window,
// not with S. A row can find a whole tile outside its band; its running
// max stays -inf there, and the guard on m keeps p = 0. window <= 0 is
// plain causal attention, and any window >= S is the causal band, so the
// launcher runs it as window 0: the result is the causal one bit for bit.
//
// ALiBi (slopes != null, Bloom-class): the score of row r and column c
// gains slopes[h] * (c - r) in f32 after the 1/sqrt(D) scale and before
// the mask, as the TPU kernel adds it. h is the q head the CTA serves, so
// with GQA the slope is that of head kv * G + g, never of the KV head.
// ALiBi and the window are independent runtime arguments. Zero slopes add
// +0 to every score, so they give the result without ALiBi bit for bit.
//
// Head dims 80 (Phi-2) and 96 (GPT-NeoX-20B): a row of 160 or 192 bytes
// is two 64-column swizzle atoms whose columns past D TMA fills with
// zeros. Q K^T takes the five or six 16-wide depth steps that hold data;
// P V and the O accumulator run 128 wide (the zero columns of V add
// nothing) and the epilogue writes the first D.
//
// Head dim 256 (GPT-J-6B): four atoms a row, and every D 256 launch takes
// 64-row CTAs (one consumer warpgroup and the producer) over 64-key tiles
// in the two-stage ring: 32 KB of Q, 64 KB of K, 64 KB of V, one CTA an
// SM. The O staging has no room of its own: it goes over the
// warpgroup's Q, dead once the last tile's Q K^T has completed, in two
// passes of 128 columns (64 x 136 bf16, 17 KB of Q's 32). P V is two
// 128-wide products a depth step (V's atoms 0-1, then 2-3). Registers
// set the CTA: a warpgroup's O accumulator is 64 x 256 f32, 128
// registers a thread beside the 32 of the score tile and the 16 of P.
// ptxas allocates the consumers' code under the launch's cap, not under
// setmaxnreg's: 128-row CTAs (two consumer warpgroups and a producer, 168
// registers) spilled 248 bytes a thread, with 32-key tiles still 64. A
// lone 64-row CTA of 256 threads holds 255 registers a thread without
// setmaxnreg (ptxas: 189, no spills) and ran 14% faster at GPT-J-6B's
// 2048-token prefill and 1.9x at 512, where the 128-row CTAs left half
// the SMs idle (port_timing.py flash; PERF.md).
//
// f16 (fp16 mixed-precision training): the same source built with
// DS_F16 (hopper.cuh) takes q, k, v in f16, runs every wgmma as
// .f32.f16.f16, rounds P to f16 for P V (the TPU kernel's
// p.astype(v.dtype)) and writes o in f16. The tiling, the ring and the
// softmax are the bf16 kernel's: the two types have the same width and
// the same tensor-core rate, so only the rounding differs (f16 keeps 11
// significant bits over a range up to 65504, bf16 8 over f32's range).
// P lies in [0, 1], so it cannot overflow f16; below 2^-14 it loses bits
// as an f16 subnormal, as the reference's cast does.
//
// The TPU kernel's grid ran its k axis in order with the accumulators in
// VMEM scratch; here that axis is the loop inside the CTA.
//
// The mbarrier, TMA and wgmma helpers live in hopper.cuh, shared with the
// backward (flash_bwd.cu).

#include <chrono>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int QBOX = 64;                  // Q rows per TMA box (one warpgroup's rows)
constexpr int STAGES = 2;                 // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tiling of one instantiation: head dim D, NWG consumer warpgroups of 64
// query rows, key tiles of BN columns. Shared memory (byte offsets from a
// 1024-aligned base, as the 128-byte swizzle needs): Q [NWG][NA][64][64],
// K and V [STAGES][NA][BN][64] each (an atom's rows contiguous, 128 bytes
// apart), the O staging rows, the mbarriers.
template <int D_, int NWG_, int BN_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int NWG = NWG_;
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = BN_;
  static constexpr int NA = (D + ATOM - 1) / ATOM;  // swizzle atoms across a row
  static constexpr int DP = NA * ATOM;              // width of P V and of the O accumulator
  static constexpr int KSTEPS = D / 16;             // Q K^T depth steps
  static constexpr int THREADS = (NWG + 1) * WG;
  // the O staging: its own region, or (D 256) the warpgroup's Q, in
  // passes of OC columns
  static constexpr bool O_OVER_Q = D > 128;
  static constexpr int OC = O_OVER_Q ? 128 : DP;    // columns an epilogue pass stages
  static constexpr int LDO = OC + 8;                // elem_t stride of an O staging row
  static constexpr int Q_BOX_BYTES = QBOX * ATOM * 2;
  static constexpr int KV_BOX_BYTES = BN * ATOM * 2;
  static constexpr int KV_TILE = NA * KV_BOX_BYTES;  // one stage of K, or of V
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NWG * NA * Q_BOX_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int O_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = O_OFF + (O_OVER_Q ? 0 : NWG * 64 * LDO * 2);
  static constexpr int SMEM = BAR_OFF + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
  // CTAs an SM: two 64-row CTAs where their shared memory fits
  static constexpr int MIN_BLOCKS = NWG == 2 || 2 * (SMEM + 1024) > 233472 ? 1 : 2;
  // registers per thread after setmaxnreg: what the CTA holds at launch
  // (65536 / (THREADS * MIN_BLOCKS), at most 255), the producer's given
  // to the consumers; a lone 64-row CTA an SM (D 256) may hold 255 a
  // thread from the launch and takes no setmaxnreg
  static constexpr bool SETMAXNREG = NWG == 2 || MIN_BLOCKS == 2;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 232;
  static_assert(D % 16 == 0 && (D <= 128 || D == 256), "head dim");
  static_assert(BN % 64 == 0 && BN <= 128, "key tile");
  static_assert(DP % OC == 0 && (!O_OVER_Q || 64 * LDO * 2 <= NA * Q_BOX_BYTES), "O staging");
  static_assert(O_OFF % 1024 == 0 && K_OFF % 1024 == 0 && V_OFF % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory per SM");
  static_assert(!SETMAXNREG || (PRODUCER_REGS + NWG * CONSUMER_REGS) * WG * MIN_BLOCKS <= 65536,
                "registers");
};

// O += P V for one 16-key depth step kk: one wgmma 128 columns wide (D up
// to 128), or two (D 256: V's atoms 0-1 into columns 0-127 of O, atoms
// 2-3 into 128-255)
template <class C>
__device__ __forceinline__ void pv_step(float (&acc)[C::DP / 2], const uint32_t (&pa)[4],
                                        uint32_t v_tile, int kk) {
  if constexpr (C::DP <= 128) {
    wgmma_rs(acc, pa, gmma_desc(v_tile + kk * 16 * 128, C::KV_BOX_BYTES, 1024));
  } else {
    static_assert(C::DP == 256, "P V width");
    float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&acc[0]);
    float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&acc[64]);
    wgmma_rs(lo, pa, gmma_desc(v_tile + kk * 16 * 128, C::KV_BOX_BYTES, 1024));
#ifndef DS_FAULT_PV_HI_SKIPPED  // defined only in a planted fault's build (chip_smoke.py)
    wgmma_rs(hi, pa, gmma_desc(v_tile + 2 * C::KV_BOX_BYTES + kk * 16 * 128, C::KV_BOX_BYTES,
                               1024));
#endif
  }
}

// The consumer warpgroup `wg` of a CTA: 64 query rows from r0.
template <class C>
__device__ __forceinline__ void consume(unsigned char* smem, uint32_t base, int wg, int r0,
                                        int j0, int n_tiles, int b, int h, int S, int H,
                                        int window, float scale_log2, const float* slopes,
                                        elem_t* __restrict__ o, float* __restrict__ lse) {
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const int lr = 16 * warp + lane / 4;  // the thread's rows lr and lr + 8 of the 64
  const int ra = r0 + lr;               // as sequence positions
  const int cq = 2 * (lane % 4);        // its first column in each 8-column group
  const bool alibi = slopes != nullptr;
  const float slope_log2 = alibi ? slopes[h] * LOG2E : 0.f;  // of the q head
  const uint32_t bars = base + C::BAR_OFF;
  const uint32_t q_tile = base + C::Q_OFF + wg * C::NA * C::Q_BOX_BYTES;

  float acc[C::DP / 2];  // O, f32, wgmma fragment layout
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows ra, ra + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's part of their running sums

  mbar_wait(bars, 0);  // Q
  for (int j = j0, it = 0; j < n_tiles; ++j, ++it) {
    const int st = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = j * C::BN;
    const uint32_t k_tile = base + C::K_OFF + st * C::KV_TILE;
    const uint32_t v_tile = base + C::V_OFF + st * C::KV_TILE;

    // S = Q K^T
    float sc[C::BN / 2];
    mbar_wait(bars + 8 * (1 + st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // the k-step's 32 bytes inside its atom's rows
      wgmma_ss(sc, gmma_desc(q_tile + (kk / 4) * C::Q_BOX_BYTES + off, 16, 1024),
               gmma_desc(k_tile + (kk / 4) * C::KV_BOX_BYTES + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + STAGES + st));  // K stage free

    // scale, ALiBi bias, mask (only where the diagonal or the band's left
    // edge cuts this warpgroup's rows)
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) sc[i] = __fmul_rn(sc[i], scale_log2);
    if (alibi) {
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        const int c = k0 + 8 * (i / 4) + cq + (i & 1);
        const int r = ra + 8 * ((i >> 1) & 1);
        sc[i] = __fadd_rn(sc[i], __fmul_rn(slope_log2, static_cast<float>(c - r)));
      }
    }
    const bool diag = k0 + C::BN - 1 > r0;
    const bool edge = window > 0 && k0 <= r0 + 63 - window;
    if (diag || edge) {
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) {
        const int c = k0 + 8 * (i / 4) + cq + (i & 1);
        const int r = ra + 8 * ((i >> 1) & 1);
        if (c > r || (window > 0 && c <= r - window)) sc[i] = -INFINITY;
      }
    }

    // online softmax: row max across the quad, rescale, p = 2^(x - m)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < C::BN / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with nothing live so far keeps p = 0 (and O = 0, l = 0)
    const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
    const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
    const float corr0 = ex2(__fsub_rn(m0, mu0));
    const float corr1 = ex2(__fsub_rn(m1, mu1));
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < C::BN / 2; i += 4) {
      sc[i] = ex2(__fsub_rn(sc[i], mu0));
      sc[i + 1] = ex2(__fsub_rn(sc[i + 1], mu0));
      sc[i + 2] = ex2(__fsub_rn(sc[i + 2], mu1));
      sc[i + 3] = ex2(__fsub_rn(sc[i + 3], mu1));
      sum0 += sc[i] + sc[i + 1];
      sum1 += sc[i + 2] + sc[i + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int i = 0; i < C::DP / 2; i += 4) {
      acc[i] *= corr0;
      acc[i + 1] *= corr0;
      acc[i + 2] *= corr1;
      acc[i + 3] *= corr1;
    }
    // P in elem_t as wgmma A fragments: k-step kk holds columns 16kk..16kk+15
    uint32_t pa[C::BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_ab(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    }

    // O += P V
    mbar_wait(bars + 8 * (1 + 2 * STAGES + st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) pv_step<C>(acc, pa[kk], v_tile, kk);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + 3 * STAGES + st));  // V stage free
  }

  // epilogue: l across the quad, O / l staged in shared memory as elem_t,
  // written as 16-byte vectors; lse = m ln 2 + ln l
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (lane % 4 == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
    if (ra < S) lrow[ra] = m0 * LN2 + logf(l0 > 0.f ? l0 : 1.f);
    if (ra + 8 < S) lrow[ra + 8] = m1 * LN2 + logf(l1 > 0.f ? l1 : 1.f);
  }
  // the staging rows: the warpgroup's own region, or (D 256) its Q, whose
  // last reader (the last tile's Q K^T) has completed
  elem_t* so = C::O_OVER_Q ? reinterpret_cast<elem_t*>(smem + (q_tile - base))
                           : reinterpret_cast<elem_t*>(smem + C::O_OFF) + wg * 64 * C::LDO;
#pragma unroll
  for (int p = 0; p < C::DP / C::OC; ++p) {
    if (p > 0) asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
#pragma unroll
    for (int g = 0; g < C::OC / 8; ++g) {
      const int c = 8 * g + cq;
      const int a = 4 * (p * C::OC / 8 + g);
      *reinterpret_cast<elem2_t*>(so + lr * C::LDO + c) =
          to_elem2(acc[a] * inv0, acc[a + 1] * inv0);
      *reinterpret_cast<elem2_t*>(so + (lr + 8) * C::LDO + c) =
          to_elem2(acc[a + 2] * inv1, acc[a + 3] * inv1);
    }
    asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
    // 16-byte vectors per row of this pass: the first D columns
    constexpr int VPR = (C::D < C::OC ? C::D : C::OC) / 8;
    for (int x = wtid; x < 64 * VPR; x += WG) {
      const int row = x / VPR;
      const int cv = x % VPR;
      if (r0 + row < S)
        *reinterpret_cast<uint4*>(o + ((static_cast<size_t>(b) * S + r0 + row) * H + h) * C::D +
                                  p * C::OC + cv * 8) =
            *reinterpret_cast<const uint4*>(so + row * C::LDO + cv * 8);
    }
  }
}

// Grid: one CTA per (q tile, batch, q head), q tiles in reverse order
// (blockIdx.x / (B * H) = 0 is the last tile). Threads: NWG consumer
// warpgroups, then the producer warpgroup.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, elem_t* __restrict__ o,
                     float* __restrict__ lse, const float* __restrict__ slopes, int S, int H,
                     int KV, int window, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;  // Q, K full[ST], K empty[ST], V full[ST], V empty[ST]

  const int n_m = (S + C::BM - 1) / C::BM;
  const int BH = gridDim.x / n_m;
  const int bh = blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (n_m - 1 - blockIdx.x / BH) * C::BM;
  // causal: tiles up to the one holding the CTA's last row; window: from
  // the one holding its first row's first live column
  const int n_tiles = min((q0 + C::BM - 1) / C::BN + 1, (S + C::BN - 1) / C::BN);
  const int j0 = window > 0 ? max(q0 - window + 1, 0) / C::BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + STAGES + s), 4 * C::NWG);  // one arrival per consumer warp
      mbar_init(bars + 8 * (1 + 2 * STAGES + s), 1);
      mbar_init(bars + 8 * (1 + 3 * STAGES + s), 4 * C::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == C::NWG) {  // producer
    if constexpr (C::SETMAXNREG)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x % WG == 0) {
      // Q: one box per warpgroup and atom; a warpgroup whose rows all lie
      // past S gets none (its rows are never written)
      uint32_t q_bytes = 0;
      for (int w = 0; w < C::NWG; ++w)
        if (q0 + 64 * w < S) q_bytes += C::NA * C::Q_BOX_BYTES;
      mbar_expect_tx(bars, q_bytes);
      for (int w = 0; w < C::NWG; ++w)
        if (q0 + 64 * w < S)
          for (int a = 0; a < C::NA; ++a)
            tma_load(base + C::Q_OFF + (w * C::NA + a) * C::Q_BOX_BYTES, &tq, bars, a * ATOM, h,
                     q0 + 64 * w, b);
      for (int j = j0, it = 0; j < n_tiles; ++j, ++it) {
        const int st = it % STAGES;
        const uint32_t ph = ((it / STAGES) & 1) ^ 1;  // the first pass finds every stage free
        const uint32_t k_full = bars + 8 * (1 + st);
        const uint32_t v_full = bars + 8 * (1 + 2 * STAGES + st);
        mbar_wait(bars + 8 * (1 + STAGES + st), ph);
        mbar_expect_tx(k_full, C::KV_TILE);
        for (int a = 0; a < C::NA; ++a)
          tma_load(base + C::K_OFF + st * C::KV_TILE + a * C::KV_BOX_BYTES, &tk, k_full,
                   a * ATOM, kvh, j * C::BN, b);
        mbar_wait(bars + 8 * (1 + 3 * STAGES + st), ph);
        mbar_expect_tx(v_full, C::KV_TILE);
        for (int a = 0; a < C::NA; ++a)
          tma_load(base + C::V_OFF + st * C::KV_TILE + a * C::KV_BOX_BYTES, &tv, v_full,
                   a * ATOM, kvh, j * C::BN, b);
      }
    }
  } else {
    if constexpr (C::SETMAXNREG)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CONSUMER_REGS));
    consume<C>(smem, base, wg, q0 + 64 * wg, j0, n_tiles, b, h, S, H, window, scale_log2,
               slopes, o, lse);
  }
}

int encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, int B, int S,
                int H, int KV, int D, int bn) {
  int err = encode_map(&maps[0], q, B, S, H, D, QBOX);
  if (err == 0) err = encode_map(&maps[1], k, B, S, KV, D, bn);
  if (err == 0) err = encode_map(&maps[2], v, B, S, KV, D, bn);
  return err;
}

template <class C>
int launch(void* o, void* lse, const void* q, const void* k, const void* v, const void* slopes,
           int B, int S, int H, int KV, int window, float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  int err = encode_maps(maps, q, k, v, B, S, H, KV, C::D, C::BN);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(B) * H * ((S + C::BM - 1) / C::BM);
  flash_fwd_kernel<C><<<static_cast<unsigned>(ctas), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<elem_t*>(o), static_cast<float*>(lse),
      static_cast<const float*>(slopes), S, H, KV, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// 128-row CTAs (two consumer warpgroups, 128-key tiles) where they fill
// the card; else 64-row CTAs (one consumer warpgroup, 64-key tiles, two
// CTAs to an SM), which double the CTAs of a short prefill. D 256 always
// takes 64-row CTAs, one an SM (see the top of the file).
template <int D>
int dispatch(void* o, void* lse, const void* q, const void* k, const void* v, const void* slopes,
             int B, int S, int H, int KV, int window, float scale, cudaStream_t st) {
  if constexpr (D != 256) {
    const long long ctas128 = static_cast<long long>(B) * H * ((S + 127) / 128);
    if (ctas128 >= sm_count())
      return launch<Cfg<D, 2, 128>>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
  }
  return launch<Cfg<D, 1, 64>>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
}

}  // namespace

// slopes: [H] f32 ALiBi slopes, or null for none
extern "C" int flash_fwd(void* o, void* lse, const void* q, const void* k, const void* v,
                         const void* slopes, int B, int S, int H, int KV, int D, int window,
                         float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (window >= S) window = 0;  // the causal band: the same result, and no overflow in the tile bounds
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch<64>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 80:
      return dispatch<80>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 96:
      return dispatch<96>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 128:
      return dispatch<128>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 256:
      return dispatch<256>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Host cost of one call's tensor maps: nanoseconds to encode the three
// maps of q, k and v `iters` times (the maps of 128-row CTAs), or -1.
extern "C" int flash_fwd_encode_ns(const void* q, const void* k, const void* v, int B, int S,
                                   int H, int KV, int D, int iters) {
  CUtensorMap maps[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (encode_maps(maps, q, k, v, B, S, H, KV, D, 128) != 0) return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return static_cast<int>(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count());
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
