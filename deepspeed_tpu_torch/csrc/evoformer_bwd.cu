// Evoformer (DS4Sci) attention backward, recomputing the probabilities
// from the forward's logsumexp: P = exp(q k^T * scale + bias1 + bias2 -
// lse), dS = P (dO v^T - delta) with delta = rowsum(dO * O). Two kernels:
//
//   evo_bwd_dq   dq = dS k * scale
//   evo_bwd_dkv  dk = dS^T q * scale, dv = P^T dO, and dsum [G, N] f32 =
//                the sum of dS over queries for each key (bias1's gradient
//                is its sum over heads, taken outside the kernels)
//
// over q, k, v, dO [B, S, N, H, D] bf16 (read in place), bias1 [B, S, 1, 1,
// N] and bias2 [B, 1, H, N, N] bf16 or absent, lse and delta [G, N] f32
// (G = B * S * H in (b, s, h) order). bias2's gradient, the sum of dS over
// the sequences, is kernel #10 in evoformer_db2.cu.
//
// Replaces: deepspeed_tpu/ops/pallas/evoformer_attention.py
// _evo_bwd_dq_kernel (the pallas_call at :310) and _evo_bwd_dkv_kernel
// (:347). The same function: P and dS are rounded to bf16 before their
// products, as the TPU kernels round them; dS is unscaled and the scale
// multiplies the finished dq and dk; dsum adds the unrounded f32 dS.
//
// Bound on the H100: per slice each kernel reads q, k, v and dO (8 N D
// bytes) against three (dq) or four (dk, dv) products of depth D per
// (query, key) pair: about N / 2 operations per byte at D 32, so the
// roofline bound is the bytes. Two floors sit above it, as in the forward
// (evoformer_fwd.cu): one exp2 per (query, key) pair, G N^2 of them at 16 a
// clock an SM (~16 us at E1: B 1, S 128, N 256, H 8; ~145 us at E3: S 512,
// N 384), and the L2 -> SM bytes of bias2, which a CTA per (b, s, h) would
// read once per sequence (G N^2 2 bytes: 134 MB at E1, 1.21 GB at E3, for
// 1.05 and 2.36 MB of unique bias2). Both kernels take #7's design:
//
// - A CTA owns 128 rows (two warpgroups of 64) of one (b, h), query rows
//   for dq and key rows for dk/dv, and walks a run of consecutive
//   sequences of that (b, h). The run comes from the wrapper's plan
//   (ops/cuda/evoformer_attention.py bwd_run_plan: B H ceil(N / 128) CTAs a
//   run, the grid near whole waves of the card); every sequence's outputs
//   are computed alone, so any run count gives the same bits.
// - The CTA's part of bias2 is loaded into shared memory once per run and
//   serves every sequence in it (evoformer_band.cuh), cutting the L2 ->
//   SM bias2 bytes by the run length. Where it would not fit beside the
//   rings (N above 512 at D 32, above 384 at D 64) no band is made and
//   bias2 is read from device memory in the fragment layout.
// - The rows the CTA owns (dq: Q, dO, their lse and delta; dk/dv: K, V and
//   their bias1) are double-buffered across sequences: the next
//   sequence's land while this one runs. The other side (dq: K and V key
//   tiles with each tile's bias1; dk/dv: Q and dO query tiles with each
//   tile's lse and delta) streams through a TMA ring of STAGES stages
//   that runs across sequence boundaries (ring tile t is sequence t / n,
//   tile t % n). A producer warpgroup beside the two consumer warpgroups
//   issues every load in that order: its first warp's lane 0 the TMA
//   loads, its lanes the small rows (bias1, lse, delta) beside them by
//   cp.async, counted on the same full mbarrier
//   (cp.async.mbarrier.arrive), so no consumer waits on their latency. A
//   stage is refilled as soon as every consumer warp has released it, so
//   the consumer warpgroups are not held to each other's pace (with the
//   loads issued by a consumer warp, as in #7, the two ran in step, and
//   both kernels were slower: PERF.md). The CTA's 12 warps leave ptxas
//   168 registers a thread at launch; setmaxnreg hands the producer's to
//   the consumers (232 each), without which dq at D 32 spilled 132 bytes
//   and ran slower (PERF.md).
//   Tile rows are D bf16 wide: one 64-byte swizzle atom at D 32, one
//   128-byte atom at D 64; rows past N arrive as TMA's zeros.
// - Every product runs on wgmma; nothing N x N touches shared or device
//   memory. The exponent is taken on the accumulator fragments in log2
//   units, x = s (scale log2 e) + (bias2 log2 e + bias1 log2 e), P =
//   2^(x - lse log2 e), and dS = P (dP - delta) there too; P and dS are
//   packed to bf16 as register A fragments of the next products.
// - At the end of each sequence the sums are scaled, staged in bf16 in the
//   warpgroup's spent input rows (dq in Q's, dk in K's, dv in V's) and
//   written as 16-byte vectors; rows past N write nothing. dsum is written
//   from the fragments. The accumulators are then reset.
// - No atomics: two launches on the same inputs give the same bits.
//
// dq (evo_bwd_dq_kernel): per key tile, S = Q K^T and dP = dO V^T (both
// K-major), then dQ += dS K with dS as register A fragments and K read
// MN-major (the form of #7's P V). lse and delta are indexed by the
// fragment row; rows past N take lse = +inf (P = 0) and keys past N (the
// ragged last tile) x = -inf, by a select on the exponent, so neither adds
// anything (and no -inf * 0 or inf - inf ever forms). The band is #7's:
// the CTA's 128 query rows x N keys.
//
// dk, dv, dsum (evo_bwd_dkv_kernel): the transposed form of
// flash_bwd.cu's dkv. Per 64-query tile, S^T = K Q^T and dP^T = V dO^T
// (K-major x K-major; the query is the fragment column, so lse and delta
// are indexed by column), then dV += P^T dO and dK += dS^T Q with P^T and
// dS^T as register A fragments and the same swizzled dO / Q tile read
// MN-major. dsum adds each key row's unrounded f32 dS^T over the thread's
// columns tile by tile, then over the quad by two shuffles: a fixed order.
// Queries past N take lse = +inf; keys past N take bias1 = -inf, so P = 0
// there. The band is a column band of bias2, all N queries x the CTA's 128
// keys, which the fragments read transposed: element (key r, query c) is
// bias2[c][k0 + r]. Read from a row-major copy, a thread's pair (c, c + 1)
// of key r would be two 16-bit loads from rows N apart, and a warp's eight
// keys r of one column would share banks. So the band is transposed once
// per run as it is loaded: bandT[r][c] = bias2[c][k0 + r], row stride ld =
// 8 mod 64 elements (ld / 2 = 4 mod 32 words). A fragment read is then the
// 32-bit word (r ld + c) / 2 with r = 64 wg + lr (+ 8), c = q0 + 8j + 2
// (lane % 4): over a warp, lr = lane / 4 takes 8 rows, so the banks are
// (4 lr + lane % 4 + const) mod 32, 32 distinct ones. The transposing load
// gives each thread a pair of queries (c, c + 1) and 8 keys: two 16-byte
// loads of bias2 rows c and c + 1, eight 32-bit stores bandT[r + e][c, c +
// 1], consecutive threads on consecutive pairs of one key group, so the
// stores of a warp are 32 consecutive words (element loads where N % 8 !=
// 0 or the base is not 16-byte aligned).

#include "evoformer_band.cuh"

namespace {

using namespace hopper;
using namespace evo;

constexpr int NWG = 2;          // consumer warpgroups of 64 rows
constexpr int BM = 64 * NWG;    // a CTA's rows: query rows (dq) or key rows (dk, dv)
constexpr int THREADS = (NWG + 1) * WG;  // the consumers, then the producer warpgroup
// registers a thread after setmaxnreg: the producer's given to the consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert((PRODUCER_REGS + NWG * CONSUMER_REGS) * WG <= 65536, "registers");

// Byte offset of 16-byte chunk v of `row` in a staging tile of ROW-byte
// rows: the chunk index XOR the row bits that TMA's swizzle of that width
// uses (128 bytes: row % 8; 64 bytes: (row / 2) % 4), so the 8 rows x 16
// bytes of one fragment store land in 32 distinct banks.
template <int ROW>
__device__ __forceinline__ int stage_off(int row, int v) {
  return row * ROW + ((v ^ (ROW == 128 ? row & 7 : (row >> 1) & 3)) << 4);
}

// A warpgroup's 64 x D f32 accumulator times `mul`, as bf16 rows (rows lr
// and lr + 8 of the fragments) at `dst`.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const float (&acc)[D / 2],
                                           float mul, int lr, int cq) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(dst + stage_off<2 * D>(lr + 8 * half, j) + cq * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// The 64 staged rows of a warpgroup as 16-byte vectors: row r to
// out + r * row_stride, for the rows with row0 + r < N.
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* out, size_t row_stride,
                                           const unsigned char* src, int row0, int N, int wtid) {
  constexpr int VPR = D / 8;
  for (int x = wtid; x < 64 * VPR; x += WG) {
    const int r = x / VPR;
    const int v = x % VPR;
    if (row0 + r >= N) continue;
    *reinterpret_cast<uint4*>(out + r * row_stride + v * 8) =
        *reinterpret_cast<const uint4*>(src + stage_off<2 * D>(r, v));
  }
}

// The CTA's mbarriers: two pairs (full, empty) for its double-buffered rows,
// then the ring's full[STAGES] and empty[STAGES]. Every full barrier takes
// the producer's expect_tx and one cp.async arrival of each lane of its
// loading warp; every empty barrier one arrival of each consumer warp.
__device__ __forceinline__ void init_bars(uint32_t bars, int stages) {
  if (threadIdx.x == 0) {
    for (int x = 0; x < 2 + stages; ++x) {
      const uint32_t full = x < 2 ? bars + 8 * x : bars + 32 + 8 * (x - 2);
      mbar_init(full, 1 + 32);
      mbar_init(x < 2 ? full + 16 : full + 8 * stages, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The lse and delta rows r0 .. r0 + n - 1 of slice g into shared memory at
// `lse_dst` / `delta_dst` by cp.async (lane `lane` of the loading warp
// copies rows lane, lane + 32, ...), zeros past N.
__device__ __forceinline__ void stage_lse_delta(uint32_t lse_dst, uint32_t delta_dst,
                                               const float* lse, const float* delta, size_t g,
                                               int r0, int n, int N, int lane) {
  const size_t row = g * N;
  for (int r = lane; r < n; r += 32) {
    const bool in = r0 + r < N;
    const size_t at = row + (in ? r0 + r : 0);
    cp_async4(lse_dst + 4 * r, lse + at, in ? 4 : 0);
    cp_async4(delta_dst + 4 * r, delta + at, in ? 4 : 0);
  }
}

// A ring stage is free: one arrival per consumer warp on its empty barrier.
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
  __syncwarp();  // the warp whole again before its next wgmma (.sync.aligned)
}

// Whether this thread belongs to the producer warpgroup. The producer
// hands registers to the consumers (setmaxnreg), its first warp runs
// `produce` (every load of the CTA, in order) and waits for its cp.async
// copies; then the warpgroup leaves.
template <class Produce>
__device__ __forceinline__ bool producer(int wg, int warp, const Produce& produce) {
  if (wg != NWG) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    return false;
  }
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
  if (warp == 0) {
    produce();
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  return true;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// Tiling of one dq instantiation: head dim D (ROW = 2 D bytes a row), key
// tiles of BN (128 at D 32, 64 at D 64, as #7), a ring of STAGES K/V
// stages. Shared memory (byte offsets from a 1024-aligned base): Q and dO
// [2 buffers][NWG][64][D] each, the ring [STAGES] x (K [BN][D], V [BN][D]),
// bias1 per stage [STAGES][B1W] as bf16 pairs (hopper.cuh stage_bias1),
// lse and delta [2 buffers][BM] f32 each, the mbarriers (Q full[2], Q
// empty[2], full[STAGES], empty[STAGES]), then the band [BM][band_ld] bf16
// when it is made.
template <int D_, int BN_, int STAGES_>
struct DqCfg {
  static constexpr int D = D_;
  static constexpr int BN = BN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int ROW = 2 * D;
  static constexpr int KSTEPS = D / 16;
  static constexpr int Q_TILE = 64 * ROW;  // a warpgroup's Q (or dO) rows
  static constexpr int KV_TILE = BN * ROW;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + 2 * NWG * Q_TILE;
  static constexpr int RING_OFF = DO_OFF + 2 * NWG * Q_TILE;
  static constexpr int STAGE_BYTES = 2 * KV_TILE;  // K, then V
  static constexpr int B1W = BN / 2 + 4;  // words of a stage's bias1 (BN / 2 + 1 used)
  static constexpr int B1_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int LSE_OFF = B1_OFF + STAGES * B1W * 4;
  static constexpr int DELTA_OFF = LSE_OFF + 2 * BM * 4;
  static constexpr int BAR_OFF = DELTA_OFF + 2 * BM * 4;
  static constexpr int BAND_OFF = (BAR_OFF + (4 + 2 * STAGES) * 8 + 127) / 128 * 128;
  static constexpr int BAND_TILE = BN;  // band columns: N padded to whole key tiles
  static_assert(D == 32 || D == 64, "head dim: one 64- or 128-byte swizzle atom");
  static_assert(BN % 64 == 0 && BN <= 128, "key tile");
  static_assert(RING_OFF % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(BAND_OFF + 1024 <= SMEM_LIMIT, "shared memory");
};

// Grid: one CTA per (query tile, b x h, run of sequences), query tiles
// fastest. Threads: NWG consumer warpgroups, then the producer warpgroup,
// whose first warp issues every load (lane 0 the TMA loads, every lane its
// cp.async copies of bias1, lse and delta).
template <class C>
__global__ void __launch_bounds__(THREADS, 1)
    evo_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, __nv_bfloat16* __restrict__ dq,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const __nv_bfloat16* __restrict__ bias1,
                      const __nv_bfloat16* __restrict__ bias2, int S, int N, int H, int n_runs,
                      int band_ld, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;
  const uint32_t q_full = bars, q_empty = bars + 16, full = bars + 32;
  const uint32_t empty = full + 8 * C::STAGES;

  const int nq = (N + BM - 1) / BM;
  const int nk = (N + C::BN - 1) / C::BN;
  const int BH = gridDim.x / (nq * n_runs);
  const int q0 = (blockIdx.x % nq) * BM;
  const int bh = (blockIdx.x / nq) % BH;
  const int run = blockIdx.x / (nq * BH);
  const int b = bh / H;
  const int h = bh % H;
  const int run_len = (S + n_runs - 1) / n_runs;
  const int s0 = run * run_len;
  const int R = min(S, s0 + run_len) - s0;
  if (R <= 0) return;  // the wrapper's plan leaves no run empty
  const int n_live = q0 + 64 < N ? 2 : 1;  // warpgroups with rows below N

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const uint32_t* b1w = reinterpret_cast<const uint32_t*>(smem + C::B1_OFF);
  const float* lse_s = reinterpret_cast<const float*>(smem + C::LSE_OFF);
  const float* delta_s = reinterpret_cast<const float*>(smem + C::DELTA_OFF);
  __nv_bfloat16* band =
      band_ld > 0 ? reinterpret_cast<__nv_bfloat16*>(smem + C::BAND_OFF) : nullptr;
  const __nv_bfloat16* b2_rows =
      bias2 != nullptr ? bias2 + static_cast<size_t>(bh) * N * N + static_cast<size_t>(q0) * N
                       : nullptr;
  if (band != nullptr)
    load_band<BM, THREADS>(band, band_ld, bias2 + static_cast<size_t>(bh) * N * N, q0, N);

  // the loading warp fills ring stage t % STAGES: lane 0 loads the K and V tiles by
  // TMA, every lane copies its words of the tile's bias1
  auto load = [&](int t) {
    const int st = t % C::STAGES;
    const uint32_t bar = full + 8 * st;
    const uint32_t k_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const int k0 = (t % nk) * C::BN;
    const int bs = b * S + s0 + t / nk;
    if (lane == 0) {
      mbar_expect_tx(bar, C::STAGE_BYTES);
      tma_load(k_tile, &tk, bar, 0, h, k0, bs);
      tma_load(k_tile + C::KV_TILE, &tv, bar, 0, h, k0, bs);
    }
    if (bias1 != nullptr)
      stage_bias1(base + C::B1_OFF + st * C::B1W * 4, bias1, static_cast<size_t>(bs) * N, k0,
                  C::BN, N, lane);
    cp_async_arrive(bar);
  };
  // the loading warp: Q, dO, lse and delta of sequence si into buffer si % 2, once
  // every warp is done with the sequence that buffer held (the first fill
  // of each finds it free); a warpgroup whose rows all lie past N gets no Q
  // or dO
  auto load_q = [&](int si) {
    const int qb = si % 2;
    const uint32_t bar = q_full + 8 * qb;
    const int bs = b * S + s0 + si;
    mbar_wait(q_empty + 8 * qb, ((si / 2) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * n_live * C::Q_TILE);
      for (int w = 0; w < n_live; ++w) {
        const int at = (qb * NWG + w) * C::Q_TILE;
        tma_load(base + C::Q_OFF + at, &tq, bar, 0, h, q0 + 64 * w, bs);
        tma_load(base + C::DO_OFF + at, &tdo, bar, 0, h, q0 + 64 * w, bs);
      }
    }
    stage_lse_delta(base + C::LSE_OFF + qb * BM * 4, base + C::DELTA_OFF + qb * BM * 4, lse,
                   delta, static_cast<size_t>(bs) * H + h, q0, BM, N, lane);
    cp_async_arrive(bar);
  };

  init_bars(bars, C::STAGES);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // the band visible to every warp
  // the producer: each sequence's Q rows once their buffer is free, then
  // its key tiles as ring stages free up
  if (producer(wg, warp, [&] {
        for (int si = 0; si < R; ++si) {
          load_q(si);
          for (int t = si * nk; t < (si + 1) * nk; ++t) {
            mbar_wait(empty + 8 * (t % C::STAGES), ((t / C::STAGES) & 1) ^ 1);
            load(t);
          }
        }
      }))
    return;

  const int lr = 16 * warp + lane / 4;  // the thread's rows lr and lr + 8 of its warpgroup's 64
  const int br = 64 * wg + lr;          // ... as rows of the band
  const int ra = q0 + br;               // ... as residues
  const int cq = 2 * (lane % 4);        // its first key column in each 8-column group
  const bool live = wg < n_live;        // a warpgroup past N only keeps the barriers' counts

  for (int si = 0; si < R; ++si) {
    const int qb = si % 2;
    const size_t bs = static_cast<size_t>(b) * S + s0 + si;
    mbar_wait(q_full + 8 * qb, (si / 2) & 1);
    const uint32_t q_tile = base + C::Q_OFF + (qb * NWG + wg) * C::Q_TILE;
    const uint32_t do_tile = base + C::DO_OFF + (qb * NWG + wg) * C::Q_TILE;
    // lse in log2 units (+inf past N: P = 0) and delta of rows ra, ra + 8
    const float* ls = lse_s + qb * BM + br;
    const float* dl = delta_s + qb * BM + br;
    const float l0 = ra < N ? __fmul_rn(ls[0], LOG2E) : INFINITY;
    const float l1 = ra + 8 < N ? __fmul_rn(ls[8], LOG2E) : INFINITY;
    const float d0 = dl[0], d1 = dl[8];

    float acc[C::D / 2];  // dQ, f32, wgmma fragment layout
#pragma unroll
    for (int i = 0; i < C::D / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < nk; ++j) {
      const int t = si * nk + j;
      const int st = t % C::STAGES;
      const int k0 = j * C::BN;
      const uint32_t k_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
      const uint32_t v_tile = k_tile + C::KV_TILE;
      mbar_wait(full + 8 * st, (t / C::STAGES) & 1);
      if (live) {
        // S = Q K^T, dP = dO V^T
        float s[C::BN / 2], dp[C::BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
          wgmma_ss(s, gmma_desc(q_tile + kk * 32, 16, 8 * C::ROW, C::ROW),
                   gmma_desc(k_tile + kk * 32, 16, 8 * C::ROW, C::ROW), kk > 0);
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
          wgmma_ss(dp, gmma_desc(do_tile + kk * 32, 16, 8 * C::ROW, C::ROW),
                   gmma_desc(v_tile + kk * 32, 16, 8 * C::ROW, C::ROW), kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);
        fence_regs(dp);

        // P = 2^(s scale log2 e + bias2 log2 e + bias1 log2 e - lse log2 e),
        // dS = P (dP - delta), in place of dP; bias2 from the band, or from
        // device memory, or 0 (absent)
        const uint32_t* w1 = b1w + st * C::B1W;
        const int par = bias1 != nullptr ? bias1_parity(bias1, bs * N, k0) : 0;
        const bool ragged = k0 + C::BN > N;
        auto grads = [&](auto pair) {
#pragma unroll
          for (int g = 0; g < C::BN / 8; ++g) {
            const int c = 8 * g + cq;
            const uint32_t p1 = bias1 != nullptr ? bias1_pair(w1, par, c) : 0u;
            const float b1x = __fmul_rn(bf16_lo(p1), LOG2E), b1y = __fmul_rn(bf16_hi(p1), LOG2E);
            const uint32_t r0 = pair(br, k0 + c);
            const uint32_t r8 = pair(br + 8, k0 + c);
            float x0 = fmaf(s[4 * g], scale_log2, fmaf(bf16_lo(r0), LOG2E, b1x));
            float x1 = fmaf(s[4 * g + 1], scale_log2, fmaf(bf16_hi(r0), LOG2E, b1y));
            float x2 = fmaf(s[4 * g + 2], scale_log2, fmaf(bf16_lo(r8), LOG2E, b1x));
            float x3 = fmaf(s[4 * g + 3], scale_log2, fmaf(bf16_hi(r8), LOG2E, b1y));
            if (ragged) {  // keys past N: P = 0
              if (k0 + c >= N) x0 = x2 = -INFINITY;
              if (k0 + c + 1 >= N) x1 = x3 = -INFINITY;
            }
            dp[4 * g] = __fmul_rn(ex2(x0 - l0), __fsub_rn(dp[4 * g], d0));
            dp[4 * g + 1] = __fmul_rn(ex2(x1 - l0), __fsub_rn(dp[4 * g + 1], d0));
            dp[4 * g + 2] = __fmul_rn(ex2(x2 - l1), __fsub_rn(dp[4 * g + 2], d1));
            dp[4 * g + 3] = __fmul_rn(ex2(x3 - l1), __fsub_rn(dp[4 * g + 3], d1));
          }
        };
        if (band != nullptr)
          grads([&](int r, int c) {
            return *reinterpret_cast<const uint32_t*>(band + r * band_ld + c);
          });
        else if (b2_rows != nullptr)
          grads([&](int r, int c) { return b2_global(b2_rows, N, q0, r, c); });
        else
          grads([](int, int) { return 0u; });
        // dS in bf16 as wgmma A fragments: k-step kk holds keys 16kk..16kk+15
        uint32_t da[C::BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }

        // dQ += dS K (K read MN-major)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          wgmma_rs(acc, da[kk],
                   gmma_desc(k_tile + kk * 16 * C::ROW, C::KV_TILE, 8 * C::ROW, C::ROW));
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
      }
      release(empty + 8 * st, lane);
    }

    // dq = dQ scale, staged in the warpgroup's spent Q rows; then the
    // buffer is free for sequence si + 2
    if (live) {
      unsigned char* sq = smem + (q_tile - base);
      const int row0 = q0 + 64 * wg;
      stage_rows<C::D>(sq, acc, scale, lr, cq);
      asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
      write_rows<C::D>(dq + ((bs * N + row0) * H + h) * C::D, static_cast<size_t>(H) * C::D, sq,
                       row0, N, wtid);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * qb);
  }
}

// ---------------------------------------------------------------------------
// dk, dv, dsum
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // queries of a ring tile

// Tiling of one dk/dv instantiation: head dim D, a ring of STAGES Q/dO
// stages. Shared
// memory (byte offsets from a 1024-aligned base): K and V [2 buffers] x (K
// [BM][D], V [BM][D]), the ring [STAGES] x (Q [BQ][D], dO [BQ][D]), lse and
// delta per stage [STAGES][BQ] f32 each, bias1 of the CTA's keys per
// buffer [2][B1W] as bf16 pairs, the mbarriers (K/V full[2], K/V
// empty[2], full[STAGES], empty[STAGES]), then the transposed band
// [BM][band_ld] bf16 when it is made.
template <int D_, int STAGES_>
struct DkvCfg {
  static constexpr int D = D_;
  static constexpr int STAGES = STAGES_;
  static constexpr int ROW = 2 * D;
  static constexpr int KSTEPS = D / 16;
  static constexpr int KV_TILE = BM * ROW;  // the CTA's K (or V) rows
  static constexpr int Q_TILE = BQ * ROW;
  static constexpr int KV_OFF = 0;
  static constexpr int RING_OFF = KV_OFF + 4 * KV_TILE;
  static constexpr int STAGE_BYTES = 2 * Q_TILE;  // Q, then dO
  static constexpr int LSE_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int B1W = BM / 2 + 4;  // words of a buffer's bias1 (BM / 2 + 1 used)
  static constexpr int B1_OFF = DELTA_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = B1_OFF + 2 * B1W * 4;
  static constexpr int BAND_OFF = (BAR_OFF + (4 + 2 * STAGES) * 8 + 127) / 128 * 128;
  static constexpr int BAND_TILE = BQ;  // band columns: N padded to whole query tiles
  static_assert(D == 32 || D == 64, "head dim: one 64- or 128-byte swizzle atom");
  static_assert(RING_OFF % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(BAND_OFF + 1024 <= SMEM_LIMIT, "shared memory");
};

// The dk/dv CTA's band, transposed: bandT[r][c] = bias2[c][k0 + r] of its
// (b, h) (`src` at the (b, h) matrix) for its BM keys r and queries c <
// band_ld, zeros past N (see the header for the layout and its banks).
__device__ __forceinline__ void load_band_t(__nv_bfloat16* band, int band_ld,
                                            const __nv_bfloat16* src, int k0, int N) {
  if (N % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    // a thread takes queries c, c + 1 and keys k0 + r .. k0 + r + 7 (all
    // live or all past N, as N % 8 == 0)
    const int pairs = band_ld / 2;
    for (int x = threadIdx.x; x < (BM / 8) * pairs; x += THREADS) {
      const int c = 2 * (x % pairs);
      const int r = 8 * (x / pairs);
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (k0 + r < N) {
        const __nv_bfloat16* col = src + k0 + r;
        if (c < N) lo = __ldg(reinterpret_cast<const uint4*>(col + static_cast<size_t>(c) * N));
        if (c + 1 < N)
          hi = __ldg(reinterpret_cast<const uint4*>(col + static_cast<size_t>(c + 1) * N));
      }
      const uint32_t a[4] = {lo.x, lo.y, lo.z, lo.w};
      const uint32_t z[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t x0 = (a[e / 2] >> (16 * (e & 1))) & 0xffffu;
        const uint32_t x1 = (z[e / 2] >> (16 * (e & 1))) & 0xffffu;
        *reinterpret_cast<uint32_t*>(band + (r + e) * band_ld + c) = x0 | (x1 << 16);
      }
    }
  } else {
    // element loads, keys fastest (consecutive threads read consecutive keys)
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d = reinterpret_cast<unsigned short*>(band);
    for (int x = threadIdx.x; x < BM * band_ld; x += THREADS) {
      const int r = x % BM;
      const int c = x / BM;
      d[r * band_ld + c] = k0 + r < N && c < N ? s[static_cast<size_t>(c) * N + k0 + r] : 0;
    }
  }
}

// bias2 at (key r of the CTA's, queries c and c + 1) as a bf16 pair, read
// from device memory when no band is made (`b2` at the (b, h) matrix):
// zeros past N.
__device__ __forceinline__ uint32_t b2_global_t(const __nv_bfloat16* b2, int N, int key, int c) {
  if (key >= N) return 0u;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(b2) + key;
  const uint32_t lo = c < N ? __ldg(p + static_cast<size_t>(c) * N) : 0u;
  const uint32_t hi = c + 1 < N ? __ldg(p + static_cast<size_t>(c + 1) * N) : 0u;
  return lo | (hi << 16);
}

// Grid: one CTA per (key block, b x h, run of sequences), key blocks
// fastest. Threads: NWG consumer warpgroups, warpgroup wg taking keys
// k0 + 64 wg .. + 63, then the producer warpgroup (as dq's).
template <class C>
__global__ void __launch_bounds__(THREADS, 1)
    evo_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, float* __restrict__ dsum,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const __nv_bfloat16* __restrict__ bias1,
                       const __nv_bfloat16* __restrict__ bias2, int S, int N, int H, int n_runs,
                       int band_ld, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;
  const uint32_t kv_full = bars, kv_empty = bars + 16, full = bars + 32;
  const uint32_t empty = full + 8 * C::STAGES;

  const int nkb = (N + BM - 1) / BM;
  const int nqt = (N + BQ - 1) / BQ;
  const int BH = gridDim.x / (nkb * n_runs);
  const int k0 = (blockIdx.x % nkb) * BM;
  const int bh = (blockIdx.x / nkb) % BH;
  const int run = blockIdx.x / (nkb * BH);
  const int b = bh / H;
  const int h = bh % H;
  const int run_len = (S + n_runs - 1) / n_runs;
  const int s0 = run * run_len;
  const int R = min(S, s0 + run_len) - s0;
  if (R <= 0) return;  // the wrapper's plan leaves no run empty
  const int n_live = k0 + 64 < N ? 2 : 1;  // warpgroups with keys below N

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const float* lse_s = reinterpret_cast<const float*>(smem + C::LSE_OFF);
  const float* delta_s = reinterpret_cast<const float*>(smem + C::DELTA_OFF);
  __nv_bfloat16* band =
      band_ld > 0 ? reinterpret_cast<__nv_bfloat16*>(smem + C::BAND_OFF) : nullptr;
  const __nv_bfloat16* b2 = bias2 != nullptr ? bias2 + static_cast<size_t>(bh) * N * N : nullptr;
  if (band != nullptr) load_band_t(band, band_ld, b2, k0, N);

  // the loading warp: K, V and the keys' bias1 of sequence si into buffer si % 2, once
  // every warp is done with the sequence that buffer held
  auto load_kv = [&](int si) {
    const int kb = si % 2;
    const uint32_t bar = kv_full + 8 * kb;
    const int bs = b * S + s0 + si;
    mbar_wait(kv_empty + 8 * kb, ((si / 2) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * C::KV_TILE);
      tma_load(base + C::KV_OFF + kb * 2 * C::KV_TILE, &tk, bar, 0, h, k0, bs);
      tma_load(base + C::KV_OFF + (kb * 2 + 1) * C::KV_TILE, &tv, bar, 0, h, k0, bs);
    }
    if (bias1 != nullptr)
      stage_bias1(base + C::B1_OFF + kb * C::B1W * 4, bias1, static_cast<size_t>(bs) * N, k0, BM,
                  N, lane);
    cp_async_arrive(bar);
  };
  // the loading warp fills ring stage t % STAGES with query tile t % nqt of sequence
  // t / nqt: lane 0 loads Q and dO by TMA, every lane copies its rows of
  // lse and delta
  auto load = [&](int t) {
    const int st = t % C::STAGES;
    const uint32_t bar = full + 8 * st;
    const uint32_t q_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const int q0 = (t % nqt) * BQ;
    const int bs = b * S + s0 + t / nqt;
    if (lane == 0) {
      mbar_expect_tx(bar, C::STAGE_BYTES);
      tma_load(q_tile, &tq, bar, 0, h, q0, bs);
      tma_load(q_tile + C::Q_TILE, &tdo, bar, 0, h, q0, bs);
    }
    stage_lse_delta(base + C::LSE_OFF + st * BQ * 4, base + C::DELTA_OFF + st * BQ * 4, lse,
                   delta, static_cast<size_t>(bs) * H + h, q0, BQ, N, lane);
    cp_async_arrive(bar);
  };

  init_bars(bars, C::STAGES);
  __syncthreads();  // the band visible to every warp
  // the producer: each sequence's K and V rows once their buffer is free,
  // then its query tiles as ring stages free up
  if (producer(wg, warp, [&] {
        for (int si = 0; si < R; ++si) {
          load_kv(si);
          for (int t = si * nqt; t < (si + 1) * nqt; ++t) {
            mbar_wait(empty + 8 * (t % C::STAGES), ((t / C::STAGES) & 1) ^ 1);
            load(t);
          }
        }
      }))
    return;

  const int lr = 16 * warp + lane / 4;  // the thread's key rows lr and lr + 8 of the 64
  const int kr = 64 * wg + lr;          // ... as rows of the CTA's keys and the band
  const int ka = k0 + kr;               // ... as residues
  const int cq = 2 * (lane % 4);        // its first query column in each 8-column group
  const bool live = wg < n_live;

  for (int si = 0; si < R; ++si) {
    const int kb = si % 2;
    const size_t bs = static_cast<size_t>(b) * S + s0 + si;
    mbar_wait(kv_full + 8 * kb, (si / 2) & 1);
    const uint32_t k_rows = base + C::KV_OFF + kb * 2 * C::KV_TILE + wg * 64 * C::ROW;
    const uint32_t v_rows = k_rows + C::KV_TILE;
    // bias1 of keys ka, ka + 8 in log2 units; -inf past N (P = 0 there)
    float e0 = 0.f, e1 = 0.f;
    if (bias1 != nullptr) {
      const unsigned short* w =
          reinterpret_cast<const unsigned short*>(smem + C::B1_OFF + kb * C::B1W * 4) +
          bias1_parity(bias1, bs * N, k0) + kr;
      e0 = __fmul_rn(bf16_lo(w[0]), LOG2E);
      e1 = __fmul_rn(bf16_lo(w[8]), LOG2E);
    }
    if (ka >= N) e0 = -INFINITY;
    if (ka + 8 >= N) e1 = -INFINITY;

    float dka[C::D / 2], dva[C::D / 2];  // f32, wgmma fragment layout
#pragma unroll
    for (int i = 0; i < C::D / 2; ++i) dka[i] = dva[i] = 0.f;
    float sum0 = 0.f, sum1 = 0.f;  // this thread's part of the dS row sums of keys ka, ka + 8

    for (int i = 0; i < nqt; ++i) {
      const int t = si * nqt + i;
      const int st = t % C::STAGES;
      const int q0 = i * BQ;
      const uint32_t q_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
      const uint32_t do_tile = q_tile + C::Q_TILE;
      mbar_wait(full + 8 * st, (t / C::STAGES) & 1);
      if (live) {
        // S^T = K Q^T, dP^T = V dO^T
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
          wgmma_ss(s, gmma_desc(k_rows + kk * 32, 16, 8 * C::ROW, C::ROW),
                   gmma_desc(q_tile + kk * 32, 16, 8 * C::ROW, C::ROW), kk > 0);
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
          wgmma_ss(dp, gmma_desc(v_rows + kk * 32, 16, 8 * C::ROW, C::ROW),
                   gmma_desc(do_tile + kk * 32, 16, 8 * C::ROW, C::ROW), kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(s);
        fence_regs(dp);

        // P^T = 2^(x - lse log2 e) in place of S^T, dS^T = P^T (dP^T -
        // delta) in place of dP^T; the query is the column
        const float* ls = lse_s + st * BQ;
        const float* dl = delta_s + st * BQ;
        const bool ragged = q0 + BQ > N;
        auto grads = [&](auto pair) {
#pragma unroll
          for (int g = 0; g < BQ / 8; ++g) {
            const int c = 8 * g + cq;
            const float2 lv = *reinterpret_cast<const float2*>(ls + c);
            const float2 dv2 = *reinterpret_cast<const float2*>(dl + c);
            float lx = __fmul_rn(lv.x, LOG2E), ly = __fmul_rn(lv.y, LOG2E);
            if (ragged) {  // queries past N: P = 0
              if (q0 + c >= N) lx = INFINITY;
              if (q0 + c + 1 >= N) ly = INFINITY;
            }
            const uint32_t w0 = pair(kr, q0 + c);
            const uint32_t w8 = pair(kr + 8, q0 + c);
            const float p0 = ex2(fmaf(s[4 * g], scale_log2, fmaf(bf16_lo(w0), LOG2E, e0)) - lx);
            const float p1 =
                ex2(fmaf(s[4 * g + 1], scale_log2, fmaf(bf16_hi(w0), LOG2E, e0)) - ly);
            const float p2 =
                ex2(fmaf(s[4 * g + 2], scale_log2, fmaf(bf16_lo(w8), LOG2E, e1)) - lx);
            const float p3 =
                ex2(fmaf(s[4 * g + 3], scale_log2, fmaf(bf16_hi(w8), LOG2E, e1)) - ly);
            s[4 * g] = p0;
            s[4 * g + 1] = p1;
            s[4 * g + 2] = p2;
            s[4 * g + 3] = p3;
            dp[4 * g] = __fmul_rn(p0, __fsub_rn(dp[4 * g], dv2.x));
            dp[4 * g + 1] = __fmul_rn(p1, __fsub_rn(dp[4 * g + 1], dv2.y));
            dp[4 * g + 2] = __fmul_rn(p2, __fsub_rn(dp[4 * g + 2], dv2.x));
            dp[4 * g + 3] = __fmul_rn(p3, __fsub_rn(dp[4 * g + 3], dv2.y));
            sum0 = __fadd_rn(__fadd_rn(sum0, dp[4 * g]), dp[4 * g + 1]);
            sum1 = __fadd_rn(__fadd_rn(sum1, dp[4 * g + 2]), dp[4 * g + 3]);
          }
        };
        if (band != nullptr)
          grads([&](int r, int c) {
            return *reinterpret_cast<const uint32_t*>(band + r * band_ld + c);
          });
        else if (b2 != nullptr)
          grads([&](int r, int c) { return b2_global_t(b2, N, k0 + r, c); });
        else
          grads([](int, int) { return 0u; });
        // P^T and dS^T in bf16 as A fragments (k-step kk: queries 16kk..16kk+15)
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
            da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
          }
        }

        // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dva, pa[kk],
                   gmma_desc(do_tile + kk * 16 * C::ROW, C::Q_TILE, 8 * C::ROW, C::ROW));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dka, da[kk],
                   gmma_desc(q_tile + kk * 16 * C::ROW, C::Q_TILE, 8 * C::ROW, C::ROW));
        wgmma_commit();
        wgmma_wait();
        fence_regs(dva);
        fence_regs(dka);
      }
      release(empty + 8 * st, lane);
    }

    // this sequence's dsum (the quad's parts added), dk = dK scale and dv,
    // staged in the warpgroup's spent K and V rows; then the buffer is free
    // for sequence si + 2
    if (live) {
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, 1));
      sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xffffffffu, sum0, 2));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, 1));
      sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xffffffffu, sum1, 2));
      if (lane % 4 == 0) {
        float* drow = dsum + (bs * H + h) * N;
        if (ka < N) drow[ka] = sum0;
        if (ka + 8 < N) drow[ka + 8] = sum1;
      }
      unsigned char* sk = smem + (k_rows - base);
      unsigned char* sv = smem + (v_rows - base);
      stage_rows<C::D>(sk, dka, scale, lr, cq);
      stage_rows<C::D>(sv, dva, 1.f, lr, cq);
      asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
      const int row0 = k0 + 64 * wg;
      const size_t at = ((bs * N + row0) * H + h) * C::D;
      write_rows<C::D>(dk + at, static_cast<size_t>(H) * C::D, sk, row0, N, wtid);
      write_rows<C::D>(dv + at, static_cast<size_t>(H) * C::D, sv, row0, N, wtid);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty + 8 * kb);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Tensor maps of q and dO (boxes of `q_rows` positions) and of k and v
// (`kv_rows`), [B S, N, H, D] as (batch, rows, heads, D), D columns each.
int encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
                int BS, int N, int H, int D, int q_rows, int kv_rows) {
  int err = encode_map(&maps[0], q, BS, N, H, D, q_rows, D);
  if (err == 0) err = encode_map(&maps[1], k, BS, N, H, D, kv_rows, D);
  if (err == 0) err = encode_map(&maps[2], v, BS, N, H, D, kv_rows, D);
  if (err == 0) err = encode_map(&maps[3], dout, BS, N, H, D, q_rows, D);
  return err;
}

template <class C>
int launch_dq(void* dq, const void* q, const void* k, const void* v, const void* b1,
              const void* b2, const void* dout, const void* lse, const void* delta, int B, int S,
              int N, int H, int n_runs, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode_maps(maps, q, k, v, dout, B * S, N, H, C::D, 64, C::BN);
  if (err != 0) return err;
  const int band_ld = band_stride(N, b2 != nullptr, C::BAND_TILE, BM, C::BAND_OFF);
  const int smem = static_cast<int>(band_smem(C::BAND_OFF, BM, band_ld));
  cudaError_t e =
      cudaFuncSetAttribute(evo_bwd_dq_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(n_runs) * B * H * ((N + BM - 1) / BM);
  evo_bwd_dq_kernel<C><<<static_cast<unsigned>(ctas), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<__nv_bfloat16*>(dq),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2), S, N, H,
      n_runs, band_ld, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_dkv(void* dk, void* dv, void* dsum, const void* q, const void* k, const void* v,
               const void* b1, const void* b2, const void* dout, const void* lse,
               const void* delta, int B, int S, int N, int H, int n_runs, float scale,
               cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode_maps(maps, q, k, v, dout, B * S, N, H, C::D, BQ, BM);
  if (err != 0) return err;
  const int band_ld = band_stride(N, b2 != nullptr, C::BAND_TILE, BM, C::BAND_OFF);
  const int smem = static_cast<int>(band_smem(C::BAND_OFF, BM, band_ld));
  cudaError_t e = cudaFuncSetAttribute(evo_bwd_dkv_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(n_runs) * B * H * ((N + BM - 1) / BM);
  evo_bwd_dkv_kernel<C><<<static_cast<unsigned>(ctas), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dsum), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(b2), S, N, H, n_runs, band_ld, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// In both: b1 / b2 may be NULL (the bias is absent). n_runs: the sequences
// of each (b, h) are cut into n_runs runs of ceil(S / n_runs) (the last may
// be shorter; the wrapper's plan leaves none empty), one CTA per run and
// 128-row tile.
extern "C" int evoformer_bwd_dq(void* dq, const void* q, const void* k, const void* v,
                                const void* b1, const void* b2, const void* dout,
                                const void* lse, const void* delta, int B, int S, int N, int H,
                                int D, int n_runs, float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  if (n_runs < 1 || n_runs > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq<DqCfg<32, 128, 3>>(dq, q, k, v, b1, b2, dout, lse, delta, B, S, N, H,
                                          n_runs, scale, st);
    case 64:
      return launch_dq<DqCfg<64, 64, 3>>(dq, q, k, v, b1, b2, dout, lse, delta, B, S, N, H,
                                         n_runs, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int evoformer_bwd_dkv(void* dk, void* dv, void* dsum, const void* q, const void* k,
                                 const void* v, const void* b1, const void* b2,
                                 const void* dout, const void* lse, const void* delta, int B,
                                 int S, int N, int H, int D, int n_runs, float scale,
                                 void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  if (n_runs < 1 || n_runs > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkv<DkvCfg<32, 4>>(dk, dv, dsum, q, k, v, b1, b2, dout, lse, delta, B, S, N,
                                       H, n_runs, scale, st);
    case 64:
      return launch_dkv<DkvCfg<64, 3>>(dk, dv, dsum, q, k, v, b1, b2, dout, lse, delta, B, S, N,
                                       H, n_runs, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
