// Evoformer (DS4Sci) attention forward: softmax(q k^T / sqrt(D) + bias1 +
// bias2) v with an online softmax over key tiles, writing o and the row
// logsumexp lse for the backward.
//
//   q, k, v, o  [B, S, N, H, D] bf16 (batch, sequences, residues, heads)
//   bias1       [B, S, 1, 1, N] bf16 or absent: one bias per key (the MSA
//               mask), shared by every query and head of a sequence
//   bias2       [B, 1, H, N, N] bf16 or absent: the pair bias, shared by
//               every sequence
//   lse         [G, N] f32 with G = B * S * H in (b, s, h) order
//
// Replaces: deepspeed_tpu/ops/pallas/evoformer_attention.py _evo_kernel
// (the pallas_call of evoformer_flash_fwd at :139). The same function: P is
// rounded to bf16 before P V, and a row whose probabilities sum to 0 gets
// o = 0 and lse = m + log 1 (the TPU kernel's l == 0 guard).
//
// Bound on the H100: at D = 32 the call does 4 N^2 D operations per slice
// against about 8 N D bytes of q, k, v and o, about N / 2 operations per
// byte, so the roofline bound is the bytes (q, k, v, o, the biases and
// lse). Two further floors sit above it at D 32. The exponentials: G N^2
// of them at 16 ex2 a clock an SM (the MUFU rate of compute capability
// 9.0): 67.1 M at E1 (B 1, S 128, N 256, H 8) and 604 M at E3 (S 512, N
// 384), ~16 and ~145 us at 132 SMs and 1,980 MHz, against byte bounds of
// 21 and 123 us. And the bytes between L2 and the SMs: the pair bias is
// the same for every sequence, and a grid of one CTA per (b, s, h) and
// query tile reads its band of bias2 once per sequence, G N^2 2 bytes of
// L2 traffic: 134 MB at E1 and 1.21 GB at E3, for 1.05 and 2.36 MB of
// unique bias2. The design answers each:
//
// - A CTA owns BM = 128 query rows (two consumer warpgroups of 64) of one
//   (b, h) and a run of consecutive sequences s of that (b, h), and walks
//   them in order. Its 128 x N band of bias2 is loaded into shared memory
//   once (cp.async; 16-byte copies where N % 8 == 0, element loads
//   otherwise; evoformer_band.cuh, shared with the backward's dq, #8)
//   and serves every sequence of the run, so the L2 -> SM
//   bias2 bytes fall by the run length: B H n_runs N^2 2 bytes in all,
//   8.4 MB at E1 (8 runs of 16 sequences on 132 SMs) and 26 MB at E3 (11
//   runs of 47). The run length comes from the wrapper's plan
//   (ops/cuda/evoformer_attention.py fwd_run_plan), which keeps the grid
//   near whole waves of the card. The band is kept in bf16, its rows
//   padded to a stride of 8 mod 64 elements, so the fragment reads (rows
//   lr, lr + 8; columns 8j + 2 (lane % 4)) hit 32 distinct banks. A band
//   that would not fit next to the ring (N above 512) is not made: the
//   kernel then reads bias2 from device memory in the fragment layout
//   (G N^2 2 bytes of L2 traffic, for shapes beyond the models' crops).
//   bias1 rides in the ring beside its key tile.
// - A TMA ring of K/V tiles (STAGES deep, full and empty mbarriers): the
//   loads run AHEAD tiles in front of the products, across sequence
//   boundaries (ring tile t is sequence t / nk, key tile t % nk). Thread 0
//   issues the TMA loads as its warp leaves a tile, and warp 0 stages each
//   tile's bias1 beside it by cp.async (as aligned 32-bit words, whatever
//   N and the row's offset), the copies counted on the stage's full barrier
//   by cp.async.mbarrier.arrive, so no thread waits on their latency. Q is
//   double-buffered: the next sequence's Q lands while this one runs. The
//   4-D tensor maps of hopper::encode_map take [B S, N, H, D] as
//   (batch, rows, heads, D), so q, k and v are read in place; rows past N
//   arrive as TMA's zeros. A tile's rows are D bf16 wide: at D 64 one
//   128-byte swizzle atom, at D 32 one 64-byte atom (TMA's 64-byte swizzle
//   and the descriptors' 64-byte layout), so D 32 spends no shared memory,
//   tensor work or O registers on zero columns (P V is m64n32k16).
// - S = Q K^T and O += P V on wgmma; the scores, the online max, sum and
//   correction stay in the accumulator fragments, P is packed to bf16 in
//   registers as wgmma's A operand, O stays in registers. Nothing N x N
//   touches shared or device memory. The exponent is one exp2 per score:
//   x = s (scale log2 e) + (bias2 log2 e + bias1 log2 e), two FFMAs, so no
//   exponential is spent on a separate multiply; keys past N (the ragged
//   last tile only) get x = -inf, p = 0. lse is written in natural log,
//   m ln 2 + ln l.
// - No atomics: two launches on the same inputs give the same bits.
//
// The TPU kernel's key grid axis, run in order with the accumulators in
// VMEM, is the key-tile loop inside the CTA; its sequence axis, which
// reread the bias block from HBM per (b, s, h), is the run a CTA walks.

#include "evoformer_band.cuh"

namespace {

using namespace hopper;
using namespace evo;

constexpr int NWG = 2;              // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * NWG;        // query rows of a CTA
constexpr int THREADS = NWG * WG;
constexpr float LN2 = 0.6931471805599453f;

// Tiling of one instantiation: head dim D (32 or 64: one swizzle atom of
// ROW = 2 D bytes a row), key tiles of BN, a ring of STAGES K/V stages
// (AHEAD tiles loaded in front of the one in use; the refill takes the
// stage of the tile before last, so the two warpgroups seldom wait on each
// other). D 32 takes 128-key tiles, which ran faster than 64-key tiles
// at E3 on the H100 and as fast at E1 (where 64-key tiles need two CTAs
// an SM to keep up, and the band allows that at N 256 but not at 384).
// D 64 keeps 64-key tiles, so its band still fits next to the ring at N
// 384. Shared memory (byte offsets from a 1024-aligned base): Q [2
// buffers][NWG][64][D], the ring [STAGES] x (K [BN][D], V [BN][D]), bias1
// per stage [STAGES][B1W] as bf16 pairs (hopper.cuh stage_bias1), the
// mbarriers (Q full[2], Q empty[2], full[STAGES], empty[STAGES]), then the
// bias2 band [BM][band_ld] bf16 when it is made.
template <int D_, int BN_, int STAGES_>
struct Cfg {
  static constexpr int D = D_;
  static constexpr int BN = BN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int AHEAD = STAGES - NWG + 1;
  static constexpr int ROW = 2 * D;      // bytes of a tile row: the swizzle span
  static constexpr int KSTEPS = D / 16;  // Q K^T depth steps
  static constexpr int Q_TILE = 64 * ROW;  // a warpgroup's Q rows
  static constexpr int KV_TILE = BN * ROW;
  static constexpr int Q_OFF = 0;
  static constexpr int RING_OFF = Q_OFF + 2 * NWG * Q_TILE;
  static constexpr int STAGE_BYTES = 2 * KV_TILE;  // K, then V
  static constexpr int B1W = BN / 2 + 4;  // words of a stage's bias1 (BN / 2 + 1 used)
  static constexpr int B1_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = B1_OFF + STAGES * B1W * 4;
  static constexpr int N_BARS = 4 + 2 * STAGES;
  static constexpr int BAND_OFF = (BAR_OFF + N_BARS * 8 + 127) / 128 * 128;
  static_assert(D == 32 || D == 64, "head dim: one 64- or 128-byte swizzle atom");
  static_assert(BN % 64 == 0 && BN <= 128, "key tile");
  static_assert(AHEAD >= 1, "ring depth");
  static_assert(RING_OFF % 1024 == 0 && STAGE_BYTES % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
};

// Grid: one CTA per (query tile, b x h, run of sequences), query tiles
// fastest (the CTAs that read the same K/V tiles run together). Threads:
// NWG consumer warpgroups; thread 0 also issues the TMA loads and warp 0
// stages bias1.
template <class C>
__global__ void __launch_bounds__(THREADS, 1)
    evo_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, const __nv_bfloat16* __restrict__ bias1,
                   const __nv_bfloat16* __restrict__ bias2, int S, int N, int H, int n_runs,
                   int band_ld, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;  // Q full[2], Q empty[2], full[STAGES], empty[STAGES]
  const uint32_t q_full = bars, q_empty = bars + 16;
  const uint32_t full = bars + 32, empty = bars + 32 + 8 * C::STAGES;

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
  const int n_tiles = R * nk;

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const bool loader = threadIdx.x < 32;  // warp 0
  const uint32_t* b1w = reinterpret_cast<const uint32_t*>(smem + C::B1_OFF);
  __nv_bfloat16* band =
      band_ld > 0 ? reinterpret_cast<__nv_bfloat16*>(smem + C::BAND_OFF) : nullptr;
  const __nv_bfloat16* b2_rows =
      bias2 != nullptr ? bias2 + static_cast<size_t>(bh) * N * N + static_cast<size_t>(q0) * N
                       : nullptr;
  if (band != nullptr)
    load_band<BM, THREADS>(band, band_ld, bias2 + static_cast<size_t>(bh) * N * N, q0, N);

  // warp 0 fills ring stage t % STAGES: lane 0 loads the K and V tiles by
  // TMA, every lane copies its words of the tile's bias1; each lane's
  // arrival comes when its copies have landed
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
  // thread 0: Q of sequence si into buffer si % 2, once every warp is done
  // with the sequence that buffer held (the first fill of each finds it
  // free); a warpgroup whose rows all lie past N gets none
  auto load_q = [&](int si) {
    const int qb = si % 2;
    mbar_wait(q_empty + 8 * qb, ((si / 2) & 1) ^ 1);
    const int n_live = q0 + 64 < N ? 2 : 1;
    mbar_expect_tx(q_full + 8 * qb, n_live * C::Q_TILE);
    for (int w = 0; w < n_live; ++w)
      tma_load(base + C::Q_OFF + (qb * NWG + w) * C::Q_TILE, &tq, q_full + 8 * qb, 0, h,
               q0 + 64 * w, b * S + s0 + si);
  };

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + 8 * x, 1);
      mbar_init(q_empty + 8 * x, 4 * NWG);  // one arrival per consumer warp
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // lane 0's expect_tx, then each lane's copies
      mbar_init(empty + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    if (lane == 0)
      for (int si = 0; si < min(2, R); ++si) load_q(si);
    for (int t = 0; t < min(C::AHEAD, n_tiles); ++t) load(t);
  }
  __syncwarp();
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();  // the band visible to every warp

  const int lr = 16 * warp + lane / 4;  // the thread's rows lr and lr + 8 of its warpgroup's 64
  const int br = 64 * wg + lr;          // ... as rows of the band
  const int ra = q0 + br;               // ... as residues
  const int cq = 2 * (lane % 4);        // its first column in each 8-column group
  const bool live = q0 + 64 * wg < N;   // a warpgroup past N only keeps the barriers' counts

  for (int si = 0; si < R; ++si) {
    const int qb = si % 2;
    const size_t bs = static_cast<size_t>(b) * S + s0 + si;
    if (threadIdx.x == 0 && si >= 1 && si + 1 < R) load_q(si + 1);
    __syncwarp();
    mbar_wait(q_full + 8 * qb, (si / 2) & 1);
    const uint32_t q_tile = base + C::Q_OFF + (qb * NWG + wg) * C::Q_TILE;

    float acc[C::D / 2];  // O, f32, wgmma fragment layout
#pragma unroll
    for (int i = 0; i < C::D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows ra, ra + 8 (log2 units)
    float l0 = 0.f, l1 = 0.f;              // this thread's part of their running sums

    for (int j = 0; j < nk; ++j) {
      const int t = si * nk + j;
      const int st = t % C::STAGES;
      const int k0 = j * C::BN;
      const uint32_t k_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
      const uint32_t v_tile = k_tile + C::KV_TILE;
      mbar_wait(full + 8 * st, (t / C::STAGES) & 1);
      if (live) {
        // S = Q K^T
        float sc[C::BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KSTEPS; ++kk)
          wgmma_ss(sc, gmma_desc(q_tile + kk * 32, 16, 8 * C::ROW, C::ROW),
                   gmma_desc(k_tile + kk * 32, 16, 8 * C::ROW, C::ROW), kk > 0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        if (j == nk - 1) {  // this sequence's Q is spent
          __syncwarp();
          if (lane == 0) mbar_arrive(q_empty + 8 * qb);
        }

        // x = s (scale log2 e) + bias2 log2 e + bias1 log2 e; bias2 from the
        // band, or from device memory, or 0 (absent)
        const uint32_t* w1 = b1w + st * C::B1W;
        const int par = bias1 != nullptr ? bias1_parity(bias1, bs * N, k0) : 0;
        auto logits = [&](auto pair) {
#pragma unroll
          for (int g = 0; g < C::BN / 8; ++g) {
            const int c = 8 * g + cq;
            const uint32_t p1 = bias1 != nullptr ? bias1_pair(w1, par, c) : 0u;
            const float b1x = __fmul_rn(bf16_lo(p1), LOG2E), b1y = __fmul_rn(bf16_hi(p1), LOG2E);
            const uint32_t r0 = pair(br, k0 + c);
            const uint32_t r8 = pair(br + 8, k0 + c);
            sc[4 * g] = fmaf(sc[4 * g], scale_log2, fmaf(bf16_lo(r0), LOG2E, b1x));
            sc[4 * g + 1] = fmaf(sc[4 * g + 1], scale_log2, fmaf(bf16_hi(r0), LOG2E, b1y));
            sc[4 * g + 2] = fmaf(sc[4 * g + 2], scale_log2, fmaf(bf16_lo(r8), LOG2E, b1x));
            sc[4 * g + 3] = fmaf(sc[4 * g + 3], scale_log2, fmaf(bf16_hi(r8), LOG2E, b1y));
          }
        };
        if (band != nullptr)
          logits([&](int r, int c) {
            return *reinterpret_cast<const uint32_t*>(band + r * band_ld + c);
          });
        else if (b2_rows != nullptr)
          logits([&](int r, int c) { return b2_global(b2_rows, N, q0, r, c); });
        else
          logits([](int, int) { return 0u; });
        if (k0 + C::BN > N) {  // the ragged last tile: keys past N get p = 0
#pragma unroll
          for (int i = 0; i < C::BN / 2; ++i)
            if (k0 + 8 * (i / 4) + cq + (i & 1) >= N) sc[i] = -INFINITY;
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
        const float corr0 = ex2(m0 - mu0);
        const float corr1 = ex2(m1 - mu1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int i = 0; i < C::BN / 2; i += 4) {
          sc[i] = ex2(sc[i] - mu0);
          sc[i + 1] = ex2(sc[i + 1] - mu0);
          sc[i + 2] = ex2(sc[i + 2] - mu1);
          sc[i + 3] = ex2(sc[i + 3] - mu1);
          sum0 += sc[i] + sc[i + 1];
          sum1 += sc[i + 2] + sc[i + 3];
        }
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
#pragma unroll
        for (int i = 0; i < C::D / 2; i += 4) {
          acc[i] *= corr0;
          acc[i + 1] *= corr0;
          acc[i + 2] *= corr1;
          acc[i + 3] *= corr1;
        }
        // P in bf16 as wgmma A fragments: k-step kk holds columns 16kk..16kk+15
        uint32_t pa[C::BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        }

        // O += P V (V read MN-major)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk)
          wgmma_rs(acc, pa[kk], gmma_desc(v_tile + kk * 16 * C::ROW, C::KV_TILE, 8 * C::ROW, C::ROW));
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
      } else if (j == nk - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty + 8 * qb);
      }
      // the stage is free; thread 0 refills the one of tile t + AHEAD
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
      const int u = t + C::AHEAD;
      if (loader && u < n_tiles) {
        mbar_wait(empty + 8 * (u % C::STAGES), ((u / C::STAGES) & 1) ^ 1);
        load(u);
      }
      __syncwarp();  // warp 0 whole again before its next wgmma (.sync.aligned)
    }

    if (live) {
      // o = O / l, written from the fragments (rows past N write nothing);
      // lse = m ln 2 + ln l, with l == 0 read as 1 (o = 0 there)
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const size_t row_elems = static_cast<size_t>(H) * C::D;
      __nv_bfloat16* o0 = o + (bs * N + ra) * row_elems + static_cast<size_t>(h) * C::D + cq;
#pragma unroll
      for (int g = 0; g < C::D / 8; ++g) {
        if (ra < N)
          *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * g) =
              __floats2bfloat162_rn(acc[4 * g] * inv0, acc[4 * g + 1] * inv0);
        if (ra + 8 < N)
          *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * row_elems + 8 * g) =
              __floats2bfloat162_rn(acc[4 * g + 2] * inv1, acc[4 * g + 3] * inv1);
      }
      if (lane % 4 == 0) {
        float* lrow = lse + (bs * H + h) * N;
        if (ra < N) lrow[ra] = m0 * LN2 + logf(l0 > 0.f ? l0 : 1.f);
        if (ra + 8 < N) lrow[ra + 8] = m1 * LN2 + logf(l1 > 0.f ? l1 : 1.f);
      }
    }
  }
}

template <class C>
int launch(void* o, void* lse, const void* q, const void* k, const void* v, const void* b1,
           const void* b2, int B, int S, int N, int H, int n_runs, float scale,
           cudaStream_t stream) {
  CUtensorMap maps[3];
  // [B S, N, H, D] as (batch, rows, heads, D): 64-row boxes of Q, BN-row
  // K/V, D columns each
  int err = encode_map(&maps[0], q, B * S, N, H, C::D, 64, C::D);
  if (err == 0) err = encode_map(&maps[1], k, B * S, N, H, C::D, C::BN, C::D);
  if (err == 0) err = encode_map(&maps[2], v, B * S, N, H, C::D, C::BN, C::D);
  if (err != 0) return err;
  const int band_ld = band_stride(N, b2 != nullptr, C::BN, BM, C::BAND_OFF);
  const int smem = static_cast<int>(band_smem(C::BAND_OFF, BM, band_ld));
  cudaError_t e =
      cudaFuncSetAttribute(evo_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(n_runs) * B * H * ((N + BM - 1) / BM);
  evo_fwd_kernel<C><<<static_cast<unsigned>(ctas), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2), S, N, H,
      n_runs, band_ld, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b1 / b2 may be NULL (the bias is absent). n_runs: the sequences of each
// (b, h) are cut into n_runs runs of ceil(S / n_runs) (the last may be
// shorter; the wrapper's plan leaves none empty), one CTA per run and
// 128-row query tile.
extern "C" int evoformer_fwd(void* o, void* lse, const void* q, const void* k, const void* v,
                             const void* b1, const void* b2, int B, int S, int N, int H, int D,
                             int n_runs, float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  if (n_runs < 1 || n_runs > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<Cfg<32, 128, 3>>(o, lse, q, k, v, b1, b2, B, S, N, H, n_runs, scale, st);
    case 64:
      return launch<Cfg<64, 64, 3>>(o, lse, q, k, v, b1, b2, B, S, N, H, n_runs, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
