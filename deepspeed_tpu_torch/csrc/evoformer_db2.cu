// Evoformer (DS4Sci) attention backward: the pair bias's gradient
//
//   db2 [B, 1, H, N, N] = sum over the S sequences of dS, in bias2's dtype,
//   dS = P (dP - delta), P = exp(q k^T * scale + bias1 + bias2 - lse),
//   dP = dO v^T, delta = rowsum(dO * O)
//
// over q, k, v, dO [B, S, N, H, D] bf16, bias1 [B, S, 1, 1, N] bf16 or
// absent, bias2 [B, 1, H, N, N] bf16, and the forward's lse and delta [G,
// N] f32 (G = B * S * H in (b, s, h) order). dS is added unrounded in f32
// and rounded once, as the TPU kernel adds it.
//
// Replaces: deepspeed_tpu/ops/pallas/evoformer_attention.py
// _evo_bwd_db2_kernel (the pallas_call at :394, grid (B H, nq, nk, S) with
// the sequences innermost and the db2 block resident in VMEM).
//
// Bound on the H100: per (b, h) the call reads each sequence's q, k, v and
// dO once (4 N D bf16) and writes N^2, with two products of depth D per
// (query, key) pair: about N / 2 operations per byte at D 32, bound by the
// bytes (21 us at E1: B 1, S 128, N 256, H 8, D 32). The exponentials are
// a floor above that, as in the forward: G N^2 of them, 67.1 M at E1 and
// 604 M at E3 (S 512, N 384), ~16 and ~145 us at 16 ex2 a clock an SM,
// 132 SMs and 1,980 MHz. A grid of one block per db2 tile that walks all
// S sequences is small (B H (N / 64)^2 blocks, 128 at E1), and its steps
// wait on their loads one after another. The design here:
//
// - The sequence axis is split across CTAs (ops/cuda/evoformer_attention.py
//   db2_split_plan): where the grid of tiles would not keep 132 SMs busy
//   to the end, each tile's sequences are cut into n_chunks contiguous
//   runs, one CTA per (chunk, b x h, query tile, key tile). Each CTA sums
//   its run into an f32 tile, writes it to the wrapper's scratch
//   [n_chunks, B H, N, N] f32, and a second kernel adds the chunks in chunk
//   order and rounds once to bf16: no atomics, so two launches give the
//   same bits. With one chunk the CTA writes bf16 itself and there is no
//   scratch. The scratch stays under a quarter of one f32 [G, N, N] logits
//   tensor (the plan's runs hold at least 4 sequences).
// - A CTA owns a 128 x 64 tile of db2 (two warpgroups of 64 query rows
//   sharing the 64 keys). A TMA ring brings each sequence's Q and dO rows
//   and K and V tiles (STAGES deep, full and empty mbarriers), AHEAD
//   sequences in front of the products. Thread 0 issues the TMA loads as
//   its warp leaves a sequence, as in kernel #3 (flash_bwd.cu), and warp 0
//   copies each sequence's lse and delta for the CTA's rows (0 past N) and
//   bias1 for its keys beside the tiles by cp.async, the copies counted on
//   the stage's full barrier by cp.async.mbarrier.arrive: no thread waits
//   on their latency.
// - S = Q K^T and dP = dO V^T run on wgmma (both operands K-major in
//   shared memory; tile rows are D bf16 wide, one 64-byte swizzle atom at
//   D 32 and one 128-byte atom at D 64, as in the forward). P = 2^(s scale log2 e + bias2 log2 e
//   + bias1 log2 e - lse log2 e) and P (dP - delta) are taken on the
//   accumulator fragments and added into the db2 tile, which stays in
//   registers across the run.
// - The bias2 tile is the same for every sequence: each thread reads its
//   32 values once, into registers, as f32 times log2 e, with -inf past N
//   (so keys and queries past N give P = 0 and add nothing).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NWG = 2;               // warpgroups, 64 query rows each
constexpr int BM = 64 * NWG;         // query rows of a CTA's tile
constexpr int BK = 64;               // keys of a CTA's tile
constexpr int THREADS = NWG * WG;
constexpr int AHEAD = 2;             // ring tiles (sequences) loaded ahead of the one in use
constexpr int STAGES = AHEAD + NWG - 1;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of head dim D (byte offsets from a 1024-aligned base): the
// ring [STAGES] x (Q [NWG][64][D], dO [NWG][64][D], K [64][D], V [64][D]),
// each stage's lse and delta for the CTA's rows [STAGES][BM] f32 and
// bias1 for its keys [STAGES][B1W] as bf16 pairs (hopper.cuh
// stage_bias1), the mbarriers (full[STAGES], empty[STAGES]).
template <int D>
struct Layout {
  static constexpr int ROW = 2 * D;      // bytes of a tile row: the swizzle span
  static constexpr int TILE = 64 * ROW;  // 64 rows
  static constexpr int Q_OFF = 0;        // within a stage
  static constexpr int DO_OFF = NWG * TILE;
  static constexpr int K_OFF = 2 * NWG * TILE;
  static constexpr int V_OFF = K_OFF + TILE;
  static constexpr int STAGE_BYTES = V_OFF + TILE;
  static constexpr int LSE_OFF = STAGES * STAGE_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * BM * 4;
  static constexpr int B1W = BK / 2 + 4;  // words of a stage's bias1 (BK / 2 + 1 used)
  static constexpr int B1_OFF = DELTA_OFF + STAGES * BM * 4;
  static constexpr int BAR_OFF = B1_OFF + STAGES * B1W * 4;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(D == 32 || D == 64, "head dim: one 64- or 128-byte swizzle atom");
  static_assert(STAGE_BYTES % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(SMEM <= 232448, "shared memory per CTA");
};

// Grid: one CTA per (chunk, b x h, query tile, key tile), key tiles
// fastest; the CTAs of one (chunk, b x h) read the same Q, dO, K and V
// tiles and run together.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    evo_db2_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, __nv_bfloat16* __restrict__ db2,
                   float* __restrict__ part, const __nv_bfloat16* __restrict__ bias1,
                   const __nv_bfloat16* __restrict__ bias2, const float* __restrict__ lse,
                   const float* __restrict__ delta, int S, int N, int H, int n_chunks,
                   float scale_log2) {
  using L = Layout<D>;
  constexpr int KSTEPS = D / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * STAGES;

  const int nq = (N + BM - 1) / BM;
  const int nkt = (N + BK - 1) / BK;
  const int BH = gridDim.x / (n_chunks * nq * nkt);
  const int k0 = (blockIdx.x % nkt) * BK;
  const int q0 = (blockIdx.x / nkt % nq) * BM;
  const int bh = blockIdx.x / (nkt * nq) % BH;
  const int chunk = blockIdx.x / (nkt * nq * BH);
  const int b = bh / H;
  const int h = bh % H;
  const int run = (S + n_chunks - 1) / n_chunks;
  const int s0 = chunk * run;
  const int R = min(S, s0 + run) - s0;  // sequences of this chunk
  if (R <= 0) return;                    // the wrapper's plan leaves no chunk empty
  const int n_live = q0 + 64 < N ? 2 : 1;  // warpgroups with rows below N

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const bool loader = threadIdx.x < 32;  // warp 0
  const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE_OFF);
  const float* delta_s = reinterpret_cast<const float*>(smem + L::DELTA_OFF);
  const uint32_t* b1w = reinterpret_cast<const uint32_t*>(smem + L::B1_OFF);

  // warp 0 fills stage t % STAGES with sequence s0 + t: lane 0 loads the
  // tiles by TMA, every lane copies its rows of lse and delta and its words
  // of bias1; each lane's arrival comes when its copies have landed
  auto load = [&](int t) {
    const int st = t % STAGES;
    const uint32_t bar = full + 8 * st;
    const uint32_t stage = base + st * L::STAGE_BYTES;
    const int bs = b * S + s0 + t;
    if (lane == 0) {
      mbar_expect_tx(bar, (2 * n_live + 2) * L::TILE);
      for (int w = 0; w < n_live; ++w) {
        tma_load(stage + L::Q_OFF + w * L::TILE, &tq, bar, 0, h, q0 + 64 * w, bs);
        tma_load(stage + L::DO_OFF + w * L::TILE, &tdo, bar, 0, h, q0 + 64 * w, bs);
      }
      tma_load(stage + L::K_OFF, &tk, bar, 0, h, k0, bs);
      tma_load(stage + L::V_OFF, &tv, bar, 0, h, k0, bs);
    }
    const size_t row = (static_cast<size_t>(bs) * H + h) * N;
#pragma unroll
    for (int x = 0; x < BM / 32; ++x) {
      const int r = lane + 32 * x;
      const bool in = q0 + r < N;
      cp_async4(base + L::LSE_OFF + (st * BM + r) * 4, lse + row + (in ? q0 + r : 0),
                in ? 4 : 0);
      cp_async4(base + L::DELTA_OFF + (st * BM + r) * 4, delta + row + (in ? q0 + r : 0),
                in ? 4 : 0);
    }
    if (bias1 != nullptr)
      stage_bias1(base + L::B1_OFF + st * L::B1W * 4, bias1, static_cast<size_t>(bs) * N, k0, BK,
                  N, lane);
    cp_async_arrive(bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // lane 0's expect_tx, then each lane's copies
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (loader) {
    for (int t = 0; t < min(AHEAD, R); ++t) load(t);
  }
  __syncwarp();

  const int lr = 16 * warp + lane / 4;  // the thread's rows lr and lr + 8 of its warpgroup's 64
  const int wr = 64 * wg + lr;          // ... as rows of the CTA's tile
  const int cq = 2 * (lane % 4);        // its first key column in each 8-column group
  const bool live = wg < n_live;

  // the thread's 32 values of the bias2 tile, f32 times log2 e, -inf past N
  float b2l[32];
  const __nv_bfloat16* b2 = bias2 + static_cast<size_t>(bh) * N * N;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = q0 + wr + 8 * ((i >> 1) & 1);
    const int c = k0 + 8 * (i / 4) + cq + (i & 1);
    b2l[i] = r < N && c < N ? __fmul_rn(__bfloat162float(b2[static_cast<size_t>(r) * N + c]), LOG2E)
                            : -INFINITY;
  }
  float acc[32];  // the db2 tile, f32, wgmma fragment layout
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int t = 0; t < R; ++t) {
    const int st = t % STAGES;
    const uint32_t stage = base + st * L::STAGE_BYTES;
    mbar_wait(full + 8 * st, (t / STAGES) & 1);
    if (live) {
      // S = Q K^T, dP = dO V^T
      float s[32], dp[32];
      const uint32_t q_tile = stage + L::Q_OFF + wg * L::TILE;
      const uint32_t do_tile = stage + L::DO_OFF + wg * L::TILE;
      constexpr int SBO = 8 * L::ROW;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss(s, gmma_desc(q_tile + kk * 32, 16, SBO, L::ROW),
                 gmma_desc(stage + L::K_OFF + kk * 32, 16, SBO, L::ROW), kk > 0);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss(dp, gmma_desc(do_tile + kk * 32, 16, SBO, L::ROW),
                 gmma_desc(stage + L::V_OFF + kk * 32, 16, SBO, L::ROW), kk > 0);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // acc += P (dP - delta), P = 2^(s scale + bias2 + bias1 - lse) (log2 units)
      const float l0 = __fmul_rn(lse_s[st * BM + wr], LOG2E);  // log2 units
      const float l1 = __fmul_rn(lse_s[st * BM + wr + 8], LOG2E);
      const float d0 = delta_s[st * BM + wr], d1 = delta_s[st * BM + wr + 8];
      const uint32_t* w1 = b1w + st * L::B1W;
      const int par =
          bias1 != nullptr ? bias1_parity(bias1, static_cast<size_t>(b * S + s0 + t) * N, k0) : 0;
#pragma unroll
      for (int g = 0; g < BK / 8; ++g) {
        const uint32_t p1 = bias1 != nullptr ? bias1_pair(w1, par, 8 * g + cq) : 0u;
        const float b1x = __fmul_rn(bf16_lo(p1), LOG2E), b1y = __fmul_rn(bf16_hi(p1), LOG2E);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 4 * g + x;
          const bool second = x >= 2;
          const float e = fmaf(s[i], scale_log2, b2l[i]) + ((x & 1) ? b1y : b1x);
          const float p = ex2(e - (second ? l1 : l0));
          acc[i] = fmaf(p, dp[i] - (second ? d1 : d0), acc[i]);
        }
      }
    }
    // the stage is free; thread 0 refills the one of sequence t + AHEAD
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    const int u = t + AHEAD;
    if (loader && u < R) {
      mbar_wait(empty + 8 * (u % STAGES), ((u / STAGES) & 1) ^ 1);
      load(u);
    }
    __syncwarp();  // warp 0 whole again before its next wgmma (.sync.aligned)
  }
  if (!live) return;

  // one chunk: db2 in bf16; a chunk of a split: its f32 partial, added up
  // by the combining pass. Pairs of columns as one store where N is even.
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = q0 + wr + 8 * ((i >> 1) & 1);
    const int c = k0 + 8 * (i / 4) + cq;
    if (r >= N || c >= N) continue;
    const size_t idx = (static_cast<size_t>(bh) * N + r) * N + c;
    if (part == nullptr) {
      if (pairs)
        *reinterpret_cast<__nv_bfloat162*>(db2 + idx) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      else {
        db2[idx] = __float2bfloat16(acc[i]);
        if (c + 1 < N) db2[idx + 1] = __float2bfloat16(acc[i + 1]);
      }
    } else {
      float* p = part + static_cast<size_t>(chunk) * BH * N * N + idx;
      if (pairs)
        *reinterpret_cast<float2*>(p) = make_float2(acc[i], acc[i + 1]);
      else {
        p[0] = acc[i];
        if (c + 1 < N) p[1] = acc[i + 1];
      }
    }
  }
}

// The split's second pass: db2 (n elements) = the sum over chunks, in chunk
// order, of the f32 partials [n_chunks][n], rounded once to bf16.
__global__ void __launch_bounds__(256)
    evo_db2_combine(__nv_bfloat16* __restrict__ db2, const float* __restrict__ part, int n_chunks,
                    long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n) return;
  float s = part[e];
  for (int c = 1; c < n_chunks; ++c) s += part[c * n + e];
  db2[e] = __float2bfloat16(s);
}

template <int D>
int launch(void* db2, void* part, const void* q, const void* k, const void* v, const void* b1,
           const void* b2, const void* dout, const void* lse, const void* delta, int B, int S,
           int N, int H, int n_chunks, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  // [B S, N, H, D] as (batch, rows, heads, D), boxes of 64 rows x D columns
  int err = encode_map(&maps[0], q, B * S, N, H, D, 64, D);
  if (err == 0) err = encode_map(&maps[1], k, B * S, N, H, D, 64, D);
  if (err == 0) err = encode_map(&maps[2], v, B * S, N, H, D, 64, D);
  if (err == 0) err = encode_map(&maps[3], dout, B * S, N, H, D, 64, D);
  if (err != 0) return err;
  constexpr int smem = Layout<D>::SMEM;
  cudaError_t e =
      cudaFuncSetAttribute(evo_db2_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(n_chunks) * B * H * ((N + BM - 1) / BM) *
                         ((N + BK - 1) / BK);
  evo_db2_kernel<D><<<static_cast<unsigned>(ctas), THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<__nv_bfloat16*>(db2),
      n_chunks > 1 ? static_cast<float*>(part) : nullptr, static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(b2), static_cast<const float*>(lse),
      static_cast<const float*>(delta), S, N, H, n_chunks, scale * LOG2E);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * H * N * N;
  evo_db2_combine<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      static_cast<__nv_bfloat16*>(db2), static_cast<const float*>(part), n_chunks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// b1 may be NULL (absent); b2 is required. n_chunks: the sequence split (1:
// none); part: its f32 scratch [n_chunks, B H, N, N], unused (may be null)
// when n_chunks is 1. Chunk c takes sequences c * ceil(S / n_chunks)
// onwards.
extern "C" int evoformer_bwd_db2(void* db2, void* part, const void* q, const void* k,
                                 const void* v, const void* b1, const void* b2, const void* dout,
                                 const void* lse, const void* delta, int B, int S, int N, int H,
                                 int D, int n_chunks, float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  if (b2 == nullptr || n_chunks < 1 || n_chunks > S || (n_chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(db2, part, q, k, v, b1, b2, dout, lse, delta, B, S, N, H, n_chunks, scale,
                        st);
    case 64:
      return launch<64>(db2, part, q, k, v, b1, b2, dout, lse, delta, B, S, N, H, n_chunks, scale,
                        st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
