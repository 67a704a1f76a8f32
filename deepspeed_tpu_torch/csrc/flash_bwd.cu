// Causal flash-attention backward (recompute from the saved logsumexp) over
// q, do [B, S, H, D] and k, v [B, S, KV, D] in bf16 (or f16: the build
// with DS_F16, below) with lse and
// delta = rowsum(dO * O) as [B, H, S] f32, in its causal, sliding-window
// and ALiBi modes, at head dims 64, 80, 96, 128 and 256 and any whole
// query group (counted as the wide-group mode above 8 heads a group, and
// as the head_dim-80, -96 and -256 modes). Two kernels:
//
//   flash_bwd_dq   dq [B, S, H, D] in the inputs' type
//   flash_bwd_dkv  dk, dv [B, S, KV, D] in the inputs' type (GQA: summed over the group)
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py _flash_bwd, i.e.
// _bwd_dq_kernel (the pallas_call at :438) and _bwd_dkv_kernel (:467),
// which the training step runs once per layer.
//
// Bound on the H100: per live (query, key) pair and head, dq does three
// products of depth D (S, dP, dS K) and dkv four (S^T, dP^T, P^T dO,
// dS^T Q), against about 2 S D bytes per operand and head: at the
// training shapes (S = 2048) hundreds of operations per byte, so both are
// bound by the tensor cores. The design is kernel #1's (flash_fwd.cu),
// with the machinery in hopper.cuh:
//
// - Warpgroups of 64 rows each and a TMA ring: one elected thread issues
//   every load, and the tiles stream through a ring of shared memory with
//   full and empty mbarriers, two tiles ahead, so the next tiles' loads
//   overlap this tile's products (a ring of two stages, three with two
//   warpgroups). Tiles are TMA boxes of 64 columns with the
//   128-byte swizzle; rows past S arrive as zeros. A lost arrival in the
//   ring traps rather than hangs. Unlike #1 there is no producer
//   warpgroup and no setmaxnreg: ptxas sizes a thread's registers by the
//   launch bounds and the warps that share an SM sub-partition (16K
//   registers each), so any CTA of 9 to 12 warps gets at most 168, and
//   dkv's warpgroups, which hold dK, dV, S^T and dP^T at once (~230 a
//   thread at D 128), spilled there, setmaxnreg 240 or not. CTAs of at
//   most 8 warps get up to 255. The loads are issued by thread 0 (dkv:
//   with its warp staging lse and delta) as its warp leaves a tile; the
//   stage it refills is that of the tile before last (DkvCfg), so it
//   seldom waits for the other warpgroup.
// - Every product runs on wgmma in one of the two forms #1 runs: K-major
//   A and B from shared memory (S = Q K^T), or A from registers times an
//   MN-major B (O += P V). No S x S quantity leaves registers: the
//   exponent, the mask and dS are computed on the accumulator fragments,
//   P and dS are rounded to the inputs' type into A fragments there (as
//   the TPU kernels round them), and the dq, dk, dv sums stay in registers
//   to the end. The epilogue stages each sum in that type in the warpgroup's own
//   input rows (now spent) and writes 16-byte vectors; rows past S write
//   nothing.
// - Only the tiles that the diagonal or the window's edge cuts take mask
//   arithmetic; a warpgroup skips a tile that its band misses whole.
//
// dkv: a CTA owns BNK = 64 x NWG key rows of one (batch, KV head), K and V
// loaded once by TMA, warpgroup w its keys 64w..64w+63. The ring streams
// the 64-query tiles of Q and dO of each q head of its group, and beside
// them each tile's lse (in log2 units; +inf past S, so P = 0 there) and
// delta, which warp 0 stages as it refills the stage. Per tile:
// S^T = K Q^T and dP^T = V dO^T (K-major x K-major; the query is the
// fragment column, so lse and delta are indexed by column), then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A fragments
// and dO and Q read MN-major: the same Q tile is read K-major for S^T and
// MN-major for dK. Causal: query tiles from the CTA's first key to S;
// window: up to the last query that sees its last key,
// (k0 + BNK - 1 + window - 1) / 64 (the TPU kernel's
// q_start <= k_start + block_k - 1 + window - 1). Key tiles run in order,
// so the CTAs with the longest causal walks take the first block indices.
// Two warpgroups (128 keys) where B * KV * ceil(S / 128) fills the card,
// else one (64 keys, two CTAs an SM).
//
// f16 (fp16 mixed-precision training): the same source built with DS_F16
// (hopper.cuh) takes q, k, v and dO in f16, runs every wgmma as
// .f32.f16.f16, rounds P and dS to f16 for their products (the TPU
// kernels' astype(q.dtype)) and writes dq, dk and dv in f16; lse, delta,
// the slopes and the split's partials stay f32. The designs are the bf16
// ones. Under fp16 loss scaling dS is the quantity that overflows: a
// |dS| past 65504 rounds to inf, as the reference's cast does, and the
// gradients it reaches turn non-finite, which the engine's overflow
// check then sees.
//
// The group split (wide groups on a grid that would not fill the card:
// Falcon-7B's 71 q heads over one KV head at B = 4, S = 2048 is 64 CTAs of
// 128 keys for 132 SMs). The TPU ran the group as a sequential grid axis
// with its sum in VMEM; here the wrapper splits each group into n_chunks
// contiguous chunks of ceil(G / n_chunks) q heads (the last may be
// partial; its plan is flash_attention.dkv_split_plan), one CTA per
// (key block, chunk). Each chunk CTA writes its partial dk and dv in f32
// to the wrapper's scratch [n_chunks, 2, B, S, KV, D], and a second
// kernel adds the partials in chunk order and writes elem_t: no atomics, so
// two launches give the same bits. With n_chunks = 1 (the flagship, and
// any grid that fills the card) one pass writes elem_t and no scratch
// exists.
//
// dq: a CTA owns BM = 64 x NWG query rows of one q head (128 where
// B * H * ceil(S / 128) fills the card, else 64), Q and dO loaded once; K
// and V stream through the ring in 64-key tiles. Per tile S = Q K^T and
// dP = dO V^T, then dQ += dS K with K read MN-major. lse and delta are
// known (no online softmax) and indexed by fragment row. Query tiles run
// in reverse (the longest causal rows first). Causal: key tiles up to
// the CTA's last row; window: from the tile holding the first live column
// of its first row, max(q0 - window + 1, 0) / 64 (the TPU's _win_jbase).
//
// Sliding window (window > 0): (row, col) is live iff row - window < col
// <= row, as in the forward. window <= 0 is plain causal, and any
// window >= S is the causal band, so the launcher runs it as window 0: the
// result is the causal one bit for bit.
//
// ALiBi (slopes != null, Bloom-class): the recomputed score of query row
// r and key column c gains slopes[h] * (c - r) after the scale and before
// the mask and the - lse, as the TPU kernels add it, with h the q head:
// dq's CTA serves one q head; dkv visits q heads h = kv * G + g, each with
// its own slope, never that of the KV head. In log2 units the exponent is
// fmaf(s, scale log2 e, fmaf(slope log2 e, c - r, -lse log2 e)), slope 0
// when slopes == null: the bias joins the subtrahend, so a null pointer
// and all-zero slopes give the same bits, and the chain is written out
// (never contracted), alike in masked and unmasked tiles.
//
// Head dims 80 (Phi-2) and 96 (GPT-NeoX-20B): a row is two swizzle atoms
// whose columns past D TMA fills with zeros; the products of depth D take
// five or six 16-wide steps, the dq, dk and dv accumulators run 128 wide
// (their columns past D are zero) and the epilogue writes the first D.
//
// Head dim 256 (GPT-J-6B): four atoms a row, and the tiles no longer fit
// the CTAs above. A 64-row tile of Q or dO is 32 KB, so a CTA of one
// warpgroup already holds 192 KB (dq: Q, dO and two K/V stages; dkv: K,
// V and two Q/dO stages): one CTA an SM. dq keeps its design with one
// warpgroup (DqCfg<256, 1>): its 64 x 256 f32 dQ accumulator is 128
// registers a thread beside the 64 of S and dP, under the 255 that a lone
// 128-thread CTA gets, and dQ += dS K runs as two 128-wide products a
// depth step (the accumulator in two halves). dkv cannot: dK and dV for
// 64 keys x 256 columns are 256 f32 registers a thread in one warpgroup.
// So a D-256 dkv CTA (DkvWideCfg, flash_bwd_dkv_wide_kernel) owns 64 keys
// with two warpgroups that split the work by output: warpgroup 0
// computes S^T = K Q^T and P^T, and accumulates dV += P^T dO; warpgroup 1
// computes dP^T = V dO^T and accumulates dK += dS^T Q, taking P^T from
// warpgroup 0 through shared memory (the hand-off: two 16 KB f32 slots,
// each guarded by a full and an empty mbarrier, each thread's 32 values
// at the same fragment positions in both warpgroups). Every product runs
// once, as in the narrower tilings; the hand-off costs 32 KB of shared
// memory and one f32 round trip a tile. Each warpgroup stages its sum in
// its own spent operand (dV over K, dK over V). The ring's loader is
// warpgroup 1's first warp, which finishes each tile last. The group
// split counts 64-key blocks at this width (dkv_split_plan).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;    // rows of a warpgroup's products and of a ring tile
constexpr int AHEAD = 2;    // ring tiles loaded ahead of the one in use
constexpr int ROW_BYTES = TILE * 128;  // one TMA box: 64 rows of one swizzle atom
constexpr float LOG2E = 1.4426950408889634f;

// Tiling of one dkv instantiation: head dim D, NWG warpgroups of 64 keys.
// Shared memory (byte offsets from a 1024-aligned base): K and V
// [NA][BNK][64] each, the ring of Q and dO tiles [STAGES][2][NA][64][64],
// each stage's lse (log2 units) and delta [STAGES][64] f32, the mbarriers
// (K/V; full[STAGES]; empty[STAGES]). The ring holds AHEAD tiles in flight
// and, with two warpgroups, one more: the stage a refill takes is the one
// of the tile before last, which the other warpgroup has most likely freed
// already, so the warpgroups do not wait on each other tile by tile.
template <int D_, int NWG_>
struct DkvCfg {
  static constexpr int D = D_;
  static constexpr int NWG = NWG_;
  static constexpr int BNK = 64 * NWG;
  static constexpr int NA = (D + ATOM - 1) / ATOM;  // swizzle atoms across a row
  static constexpr int DP = NA * ATOM;              // width of the dK and dV accumulators
  static constexpr int KSTEPS = D / 16;             // depth steps of S^T and dP^T
  static constexpr int THREADS = NWG * WG;
  static constexpr int K_ATOM = BNK * 128;          // one atom of the CTA's K (or V) rows
  static constexpr int KV_BYTES = NA * K_ATOM;
  static constexpr int Q_TILE = NA * ROW_BYTES;     // one Q (or dO) tile
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int RING_OFF = V_OFF + KV_BYTES;
  static constexpr int STAGES = AHEAD + NWG - 1;   // ring depth
  static constexpr int STAGE_BYTES = 2 * Q_TILE;    // Q, then dO
  static constexpr int LSE_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * TILE * 4;
  static constexpr int BAR_OFF = DELTA_OFF + STAGES * TILE * 4;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  static_assert(V_OFF % 1024 == 0 && RING_OFF % 1024 == 0 && Q_TILE % 1024 == 0,
                "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory per SM");
};

// Tiling of dkv at head dim 256 (flash_bwd_dkv_wide_kernel): 64 keys a
// CTA, warpgroup 0 on dV and warpgroup 1 on dK. Shared memory: K and V
// [NA][64][64] each, the ring of Q and dO tiles [STAGES][2][NA][64][64],
// the P^T hand-off [2][64 x 64] f32, each stage's lse and delta [STAGES][64]
// f32, the mbarriers (K/V; full[STAGES]; empty[STAGES]; hand_full[2];
// hand_empty[2]). dV and dK are PARTS products of ACC_N = 128 columns.
template <int D_>
struct DkvWideCfg {
  static constexpr int D = D_;
  static constexpr int NWG = 2;
  static constexpr int BNK = TILE;
  static constexpr int NA = D / ATOM;
  static constexpr int ACC_N = 128;
  static constexpr int PARTS = D / ACC_N;
  static constexpr int KSTEPS = D / 16;
  static constexpr int THREADS = NWG * WG;
  static constexpr int K_ATOM = BNK * 128;
  static constexpr int KV_BYTES = NA * K_ATOM;
  static constexpr int Q_TILE = NA * ROW_BYTES;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int RING_OFF = V_OFF + KV_BYTES;
  static constexpr int STAGES = AHEAD;
  static constexpr int STAGE_BYTES = 2 * Q_TILE;
  static constexpr int HAND_BYTES = TILE * TILE * 4;  // one slot: a 64 x 64 f32 P^T tile
  static constexpr int HAND_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int LSE_OFF = HAND_OFF + 2 * HAND_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * TILE * 4;
  static constexpr int BAR_OFF = DELTA_OFF + STAGES * TILE * 4;
  static constexpr int HAND_BAR = 1 + 2 * STAGES;  // index of hand_full[0]
  static constexpr int SMEM = BAR_OFF + (HAND_BAR + 4) * 8 + 1024;
  static constexpr int MIN_BLOCKS = 1;
  static_assert(D % 128 == 0 && D <= 256, "head dim");
  static_assert(V_OFF % 1024 == 0 && RING_OFF % 1024 == 0 && HAND_OFF % 1024 == 0,
                "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(SMEM + 1024 <= 233472, "shared memory per SM");
};

// Tiling of one dq instantiation: NWG warpgroups of 64 query rows, 64-key
// tiles. Shared memory: Q and dO [NWG][NA][64][64] each, the ring of K and
// V tiles [STAGES][2][NA][64][64] (as dkv's ring), the mbarriers (Q/dO;
// full[STAGES]; empty[STAGES]). The dQ accumulator is PARTS products of
// ACC_N columns (one up to 128 wide, two halves of 128 at D 256).
template <int D_, int NWG_>
struct DqCfg {
  static constexpr int D = D_;
  static constexpr int NWG = NWG_;
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = TILE;
  static constexpr int NA = (D + ATOM - 1) / ATOM;
  static constexpr int DP = NA * ATOM;              // width of the dQ accumulator
  static constexpr int ACC_N = DP < 128 ? DP : 128;  // columns of one dS K product
  static constexpr int PARTS = DP / ACC_N;
  static constexpr int KSTEPS = D / 16;             // depth steps of S and dP
  static constexpr int THREADS = NWG * WG;
  static constexpr int WG_TILE = NA * ROW_BYTES;    // a warpgroup's Q (or dO) rows; a K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_OFF + NWG * WG_TILE;
  static constexpr int RING_OFF = DO_OFF + NWG * WG_TILE;
  static constexpr int STAGES = AHEAD + NWG - 1;   // ring depth
  static constexpr int STAGE_BYTES = 2 * WG_TILE;   // K, then V
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
  // CTAs an SM: two of one warpgroup where their shared memory fits (not
  // at D 256)
  static constexpr int MIN_BLOCKS = NWG == 2 || 2 * (SMEM + 1024) > 233472 ? 1 : 2;
  static_assert(D % 16 == 0 && D <= 256 && DP % ACC_N == 0, "head dim");
  static_assert(DO_OFF % 1024 == 0 && RING_OFF % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory per SM");
};

// Byte offset, inside a run of swizzle atoms `atom_bytes` apart, of the
// 16-byte chunk holding columns 8v..8v+7 of `row` in the epilogue's
// staging (the chunk index XOR the row's low three bits, as the 128-byte
// swizzle places it: the 8 rows a fragment store touches at once land in
// 8 different bank groups).
__device__ __forceinline__ int stage_off(int row, int v, int atom_bytes) {
  return (v / 8) * atom_bytes + row * 128 + (((v % 8) ^ (row & 7)) << 4);
}

// Stage a warpgroup's 64 x DP f32 accumulator as elem_t rows (rows lr and
// lr + 8 of the fragments) in shared memory at `dst`.
template <int DP, int N>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const float (&acc)[N], int lr,
                                           int cq, int atom_bytes) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = lr + 8 * half;
      *reinterpret_cast<elem2_t*>(dst + stage_off(row, j, atom_bytes) + cq * 2) =
          to_elem2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// The CTA's mbarriers: bars (the tiles loaded once), full[STAGES] (`fill`
// arrivals each), empty[STAGES]
template <class C>
__device__ __forceinline__ void init_bars(uint32_t bars, int fill) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), fill);
      mbar_init(bars + 8 * (1 + C::STAGES + s), 4 * C::NWG);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// A warp is done with ring tile t (stage t % STAGES): one arrival per
// warp frees it. The loader (thread 0, or warp 0) then loads tile
// u = t + AHEAD into stage u % STAGES once every warp has freed that
// stage's previous tile (its fill u / STAGES waits for the empty barrier's
// phase before; the first fill of a stage finds it free).
template <class C, class Load>
__device__ __forceinline__ void release(uint32_t bars, int t, int n_tiles, int lane, bool loader,
                                       const Load& load) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bars + 8 * (1 + C::STAGES + t % C::STAGES));
  const int u = t + AHEAD;
  if (loader && u < n_tiles) {
    mbar_wait(bars + 8 * (1 + C::STAGES + u % C::STAGES), ((u / C::STAGES) & 1) ^ 1);
    load(u);
  }
  __syncwarp();  // warp 0 whole again before its next wgmma (.sync.aligned)
}

// dkv: one CTA per (key block, batch x KV head, chunk), key blocks in
// order (the longest causal walks first); warpgroup wg takes keys
// kw..kw+63 of the block.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         elem_t* __restrict__ dk, elem_t* __restrict__ dv,
                         float* __restrict__ part, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ slopes,
                         int B, int S, int H, int KV, int window, int n_chunks, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;

  const int per_block = B * KV * n_chunks;
  const int k0 = (blockIdx.x / per_block) * C::BNK;
  const int chunk = blockIdx.x % n_chunks;
  const int bk = (blockIdx.x % per_block) / n_chunks;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int G = H / KV;
  const int csize = (G + n_chunks - 1) / n_chunks;
  const int g0 = min(G, chunk * csize);
  const int g1 = min(G, g0 + csize);
  // causal: query tiles from the one holding key k0 to the end; window: up
  // to the one holding the last query that sees key k0 + BNK - 1. The ring
  // walks them for each q head of the chunk: tile t is q head
  // kvh * G + g0 + t / n_i, query tile i0 + t % n_i.
  const int nq = (S + TILE - 1) / TILE;
  const int i0 = k0 / TILE;
  const int n_i = (window > 0 ? min(nq, (k0 + C::BNK - 1 + window - 1) / TILE + 1) : nq) - i0;
  const int n_tiles = (g1 - g0) * n_i;

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const bool loader = threadIdx.x < 32;  // warp 0
  float* lse_s = reinterpret_cast<float*>(smem + C::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + C::DELTA_OFF);

  // warp 0 fills stage t % C::STAGES: fetch(t) reads each lane's two rows of
  // lse and delta into registers a tile ahead (their latency off the ring's
  // path); load(t) has lane 0 load the Q and dO tiles by TMA and each lane
  // store its rows, then arrive
  float pre_l[2], pre_d[2];
  auto fetch = [&](int t) {
    const int q0 = (i0 + t % n_i) * TILE;
    const size_t row = (static_cast<size_t>(b) * H + kvh * G + g0 + t / n_i) * S;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int q = q0 + lane + 32 * x;
      pre_l[x] = q < S ? __fmul_rn(lse[row + q], LOG2E) : INFINITY;
      pre_d[x] = q < S ? delta[row + q] : 0.f;
    }
  };
  auto load = [&](int t) {
    const int st = t % C::STAGES;
    const uint32_t full = bars + 8 * (1 + st);
    const uint32_t q_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const int h = kvh * G + g0 + t / n_i;
    const int q0 = (i0 + t % n_i) * TILE;
    if (lane == 0) {
      mbar_expect_tx(full, C::STAGE_BYTES);
      for (int a = 0; a < C::NA; ++a) {
        tma_load(q_tile + a * ROW_BYTES, &tq, full, a * ATOM, h, q0, b);
        tma_load(q_tile + C::Q_TILE + a * ROW_BYTES, &tdo, full, a * ATOM, h, q0, b);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      lse_s[st * TILE + lane + 32 * x] = pre_l[x];
      delta_s[st * TILE + lane + 32 * x] = pre_d[x];
    }
    mbar_arrive(full);
  };

  init_bars<C>(bars, 1 + 32);  // full: lane 0's expect_tx, then each lane of warp 0
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * C::KV_BYTES);
      for (int a = 0; a < C::NA; ++a) {
        tma_load(base + C::K_OFF + a * C::K_ATOM, &tk, bars, a * ATOM, kvh, k0, b);
        tma_load(base + C::V_OFF + a * C::K_ATOM, &tv, bars, a * ATOM, kvh, k0, b);
      }
    }
    for (int t = 0; t < min(AHEAD, n_tiles); ++t) {
      fetch(t);
      load(t);
    }
  }
  __syncwarp();

  const int lr = 16 * warp + lane / 4;  // the thread's key rows lr and lr + 8 of the 64
  const int cq = 2 * (lane % 4);        // its first query column in each 8-column group
  const int kw = k0 + 64 * wg;          // the warpgroup's first key
  const int ka = kw + lr;
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_rows = base + C::K_OFF + wg * ROW_BYTES;  // this warpgroup's rows of atom 0
  const uint32_t v_rows = base + C::V_OFF + wg * ROW_BYTES;

  float dka[C::DP / 2], dva[C::DP / 2];  // f32, wgmma fragment layout
#pragma unroll
  for (int i = 0; i < C::DP / 2; ++i) dka[i] = dva[i] = 0.f;
  float slope_log2 = 0.f;

  mbar_wait(bars, 0);  // K, V
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % C::STAGES;
    const int q0 = (i0 + t % n_i) * TILE;
    const uint32_t q_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const uint32_t do_tile = q_tile + C::Q_TILE;
    if (t % n_i == 0 && slopes != nullptr)  // a new q head: its own slope
      slope_log2 = __fmul_rn(slopes[kvh * G + g0 + t / n_i], LOG2E);
    if (loader && t + AHEAD < n_tiles) fetch(t + AHEAD);
    mbar_wait(bars + 8 * (1 + st), (t / C::STAGES) & 1);
    // a tile the warpgroup's band misses whole (every query before its
    // first key, or at least `window` past its last) takes no products
    if (q0 + TILE - 1 >= kw && !(window > 0 && q0 - (kw + 63) >= window)) {
      // S^T = K Q^T, dP^T = V dO^T
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * C::K_ATOM + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss(s, gmma_desc(k_rows + off, 16, 1024), gmma_desc(q_tile + qoff, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * C::K_ATOM + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss(dp, gmma_desc(v_rows + off, 16, 1024), gmma_desc(do_tile + qoff, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // P^T = 2^(s scale + slope (key - query) - lse) on live (key,
      // query), dS^T = P^T (dP^T - delta) scale; the query is the column
      const bool cut = kw + 63 > q0 || (window > 0 && kw <= q0 + TILE - 1 - window);
      const float* ls = lse_s + st * TILE;
      const float* dl = delta_s + st * TILE;
      uint32_t pa[4][4], da[4][4];  // P^T, dS^T in elem_t as A fragments (k-step: 16 queries)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int i = 8 * kk + x;
          const int qc = 8 * (i / 4) + cq + (i & 1);  // the query's column in the tile
          const int c = q0 + qc;
          const int r = ka + 8 * ((i >> 1) & 1);
          float p = ex2(fmaf(s[i], scale_log2,
                             fmaf(slope_log2, static_cast<float>(r - c), -ls[qc])));
          if (cut && (r > c || (window > 0 && r <= c - window))) p = 0.f;
          s[i] = p;
          dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], dl[qc])), scale);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          pa[kk][x] = pack_ab(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
          da[kk][x] = pack_ab(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }
      }

      // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dva, pa[kk], gmma_desc(do_tile + kk * 16 * 128, ROW_BYTES, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dka, da[kk], gmma_desc(q_tile + kk * 16 * 128, ROW_BYTES, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dva);
      fence_regs(dka);
    }
    release<C>(bars, t, n_tiles, lane, loader, load);
  }

  const size_t row_stride = static_cast<size_t>(KV) * C::D;
  if (part != nullptr) {
    // a chunk of a split group: its f32 partial, added up by the combine pass
    const size_t n = static_cast<size_t>(B) * S * row_stride;
    float* pk = part + static_cast<size_t>(chunk) * 2 * n;
    float* pv = pk + n;
#pragma unroll
    for (int j = 0; j < C::D / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = ka + 8 * half;
        if (key < S) {
          const size_t idx = (static_cast<size_t>(b) * S + key) * row_stride +
                             static_cast<size_t>(kvh) * C::D + 8 * j + cq;
          *reinterpret_cast<float2*>(pk + idx) =
              make_float2(dka[4 * j + 2 * half], dka[4 * j + 2 * half + 1]);
          *reinterpret_cast<float2*>(pv + idx) =
              make_float2(dva[4 * j + 2 * half], dva[4 * j + 2 * half + 1]);
        }
      }
    }
    return;
  }
  // stage dK in the warpgroup's K rows and dV in its V rows (spent), then
  // write 16-byte vectors
  unsigned char* sk = smem + C::K_OFF + wg * ROW_BYTES;
  unsigned char* sv = smem + C::V_OFF + wg * ROW_BYTES;
  stage_rows<C::DP>(sk, dka, lr, cq, C::K_ATOM);
  stage_rows<C::DP>(sv, dva, lr, cq, C::K_ATOM);
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
  constexpr int VPR = C::D / 8;  // 16-byte vectors per row
  for (int x = wtid; x < 64 * VPR; x += WG) {
    const int row = x / VPR;
    const int v = x % VPR;
    if (kw + row >= S) continue;
    const size_t dst = (static_cast<size_t>(b) * S + kw + row) * row_stride +
                       static_cast<size_t>(kvh) * C::D + v * 8;
    const int off = stage_off(row, v, C::K_ATOM);
    *reinterpret_cast<uint4*>(dk + dst) = *reinterpret_cast<const uint4*>(sk + off);
    *reinterpret_cast<uint4*>(dv + dst) = *reinterpret_cast<const uint4*>(sv + off);
  }
}

// dkv at head dim 256: one CTA per (64-key block, batch x KV head, chunk),
// key blocks in order. Warpgroup 0 takes S^T, P^T and dV; warpgroup 1
// dP^T, dS^T and dK, with P^T from warpgroup 0 through the hand-off slot
// t % 2 of tile t. Every tile of the walk meets the CTA's keys (the walk
// starts at the tile holding k0 and, with a window, ends at the last tile
// that sees key k0 + 63), so both warpgroups take every tile.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              elem_t* __restrict__ dk, elem_t* __restrict__ dv,
                              float* __restrict__ part, const float* __restrict__ lse,
                              const float* __restrict__ delta, const float* __restrict__ slopes,
                              int B, int S, int H, int KV, int window, int n_chunks,
                              float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;

  const int per_block = B * KV * n_chunks;
  const int k0 = (blockIdx.x / per_block) * C::BNK;
  const int chunk = blockIdx.x % n_chunks;
  const int bk = (blockIdx.x % per_block) / n_chunks;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int G = H / KV;
  const int csize = (G + n_chunks - 1) / n_chunks;
  const int g0 = min(G, chunk * csize);
  const int g1 = min(G, g0 + csize);
  const int nq = (S + TILE - 1) / TILE;
  const int i0 = k0 / TILE;
  const int n_i = (window > 0 ? min(nq, (k0 + C::BNK - 1 + window - 1) / TILE + 1) : nq) - i0;
  const int n_tiles = (g1 - g0) * n_i;

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const bool loader = wg == 1 && warp == 0;  // warpgroup 1 leaves each tile last
  float* lse_s = reinterpret_cast<float*>(smem + C::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + C::DELTA_OFF);
  const uint32_t hand_full = bars + 8 * C::HAND_BAR;  // + 8 s: slot s
  const uint32_t hand_empty = hand_full + 16;

  // the loader warp fills stage t % STAGES as dkv's loader does
  float pre_l[2], pre_d[2];
  auto fetch = [&](int t) {
    const int q0 = (i0 + t % n_i) * TILE;
    const size_t row = (static_cast<size_t>(b) * H + kvh * G + g0 + t / n_i) * S;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int q = q0 + lane + 32 * x;
      pre_l[x] = q < S ? __fmul_rn(lse[row + q], LOG2E) : INFINITY;
      pre_d[x] = q < S ? delta[row + q] : 0.f;
    }
  };
  auto load = [&](int t) {
    const int st = t % C::STAGES;
    const uint32_t full = bars + 8 * (1 + st);
    const uint32_t q_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const int h = kvh * G + g0 + t / n_i;
    const int q0 = (i0 + t % n_i) * TILE;
    if (lane == 0) {
      mbar_expect_tx(full, C::STAGE_BYTES);
      for (int a = 0; a < C::NA; ++a) {
        tma_load(q_tile + a * ROW_BYTES, &tq, full, a * ATOM, h, q0, b);
        tma_load(q_tile + C::Q_TILE + a * ROW_BYTES, &tdo, full, a * ATOM, h, q0, b);
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      lse_s[st * TILE + lane + 32 * x] = pre_l[x];
      delta_s[st * TILE + lane + 32 * x] = pre_d[x];
    }
    mbar_arrive(full);
  };

  if (threadIdx.x == 0)
    for (int s = 0; s < 4; ++s) mbar_init(hand_full + 8 * s, WG);  // every thread of a warpgroup
  init_bars<C>(bars, 1 + 32);
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(bars, 2 * C::KV_BYTES);
      for (int a = 0; a < C::NA; ++a) {
        tma_load(base + C::K_OFF + a * C::K_ATOM, &tk, bars, a * ATOM, kvh, k0, b);
        tma_load(base + C::V_OFF + a * C::K_ATOM, &tv, bars, a * ATOM, kvh, k0, b);
      }
    }
    for (int t = 0; t < min(AHEAD, n_tiles); ++t) {
      fetch(t);
      load(t);
    }
  }
  __syncwarp();

  const int lr = 16 * warp + lane / 4;  // the thread's key rows lr and lr + 8 of the 64
  const int cq = 2 * (lane % 4);        // its first query column in each 8-column group
  const int ka = k0 + lr;
  const float scale_log2 = scale * LOG2E;
  // warpgroup 0 multiplies K by Q (S^T) and P^T by dO; warpgroup 1 V by
  // dO (dP^T) and dS^T by Q
  const uint32_t kv_rows = base + (wg == 0 ? C::K_OFF : C::V_OFF);

  float acc[C::PARTS][C::ACC_N / 2];  // dV (warpgroup 0) or dK (1), f32, by column part
#pragma unroll
  for (int p = 0; p < C::PARTS; ++p)
#pragma unroll
    for (int i = 0; i < C::ACC_N / 2; ++i) acc[p][i] = 0.f;
  float slope_log2 = 0.f;

  mbar_wait(bars, 0);  // K, V
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % C::STAGES;
    const int hs = t & 1;  // the hand-off slot
    const int q0 = (i0 + t % n_i) * TILE;
    const uint32_t q_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const uint32_t do_tile = q_tile + C::Q_TILE;
    float4* hand = reinterpret_cast<float4*>(smem + C::HAND_OFF + hs * C::HAND_BYTES);
    if (t % n_i == 0 && slopes != nullptr)  // a new q head: its own slope
      slope_log2 = __fmul_rn(slopes[kvh * G + g0 + t / n_i], LOG2E);
    if (loader && t + AHEAD < n_tiles) fetch(t + AHEAD);
    mbar_wait(bars + 8 * (1 + st), (t / C::STAGES) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float x[32];
    const uint32_t b_tile = wg == 0 ? q_tile : do_tile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      const uint32_t off = (kk / 4) * C::K_ATOM + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss(x, gmma_desc(kv_rows + off, 16, 1024), gmma_desc(b_tile + qoff, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(x);

    uint32_t a[4][4];  // P^T or dS^T in elem_t as A fragments (k-step: 16 queries)
    if (wg == 0) {
      // P^T = 2^(s scale + slope (key - query) - lse) on live (key, query)
      const bool cut = k0 + 63 > q0 || (window > 0 && k0 <= q0 + TILE - 1 - window);
      const float* ls = lse_s + st * TILE;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qc = 8 * (i / 4) + cq + (i & 1);
        const int c = q0 + qc;
        const int r = ka + 8 * ((i >> 1) & 1);
        float p = ex2(fmaf(x[i], scale_log2,
                           fmaf(slope_log2, static_cast<float>(r - c), -ls[qc])));
        if (cut && (r > c || (window > 0 && r <= c - window))) p = 0.f;
        x[i] = p;
      }
      // hand P^T to warpgroup 1 once it has read this slot's tile t - 2
      mbar_wait(hand_empty + 8 * hs, ((t >> 1) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        hand[j * WG + wtid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      mbar_arrive(hand_full + 8 * hs);
    } else {
      // dS^T = P^T (dP^T - delta) scale, P^T from warpgroup 0 (entries
      // 4j..4j+3 of the fragment: 8-column group j)
      const float* dl = delta_s + st * TILE;
      mbar_wait(hand_full + 8 * hs, (t >> 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float4 h4 = hand[j * WG + wtid];
#ifdef DS_FAULT_HANDOFF_HALF
        if (j >= 4) h4 = make_float4(0.f, 0.f, 0.f, 0.f);  // planted fault: queries 32-63 lost
#endif
        const float p[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + cq + (e & 1);
          x[4 * j + e] = __fmul_rn(__fmul_rn(p[e], __fsub_rn(x[4 * j + e], dl[qc])), scale);
        }
      }
      mbar_arrive(hand_empty + 8 * hs);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[kk][j] = pack_ab(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);

    // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1); dO and Q read
    // MN-major, part p from their atom 2p
    const uint32_t mn_tile = wg == 0 ? do_tile : q_tile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < C::PARTS; ++p)
        wgmma_rs(acc[p], a[kk],
                 gmma_desc(mn_tile + p * (C::ACC_N / ATOM) * ROW_BYTES + kk * 16 * 128,
                           ROW_BYTES, 1024));
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int p = 0; p < C::PARTS; ++p) fence_regs(acc[p]);
    release<C>(bars, t, n_tiles, lane, loader, load);
  }

  const size_t row_stride = static_cast<size_t>(KV) * C::D;
  if (part != nullptr) {
    // a chunk of a split group: its f32 partial (dk at 0, dv at n), added
    // up by the combine pass
    const size_t n = static_cast<size_t>(B) * S * row_stride;
    float* pw = part + static_cast<size_t>(chunk) * 2 * n + (wg == 0 ? n : 0);
#pragma unroll
    for (int p = 0; p < C::PARTS; ++p)
#pragma unroll
      for (int j = 0; j < C::ACC_N / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = ka + 8 * half;
          if (key < S) {
            const size_t idx = (static_cast<size_t>(b) * S + key) * row_stride +
                               static_cast<size_t>(kvh) * C::D + p * C::ACC_N + 8 * j + cq;
            *reinterpret_cast<float2*>(pw + idx) =
                make_float2(acc[p][4 * j + 2 * half], acc[p][4 * j + 2 * half + 1]);
          }
        }
    return;
  }
  // stage dV in K (warpgroup 0's own operand, spent) and dK in V (warpgroup
  // 1's), then write 16-byte vectors
  unsigned char* so = smem + (wg == 0 ? C::K_OFF : C::V_OFF);
#pragma unroll
  for (int p = 0; p < C::PARTS; ++p)
    stage_rows<C::ACC_N>(so + p * (C::ACC_N / ATOM) * C::K_ATOM, acc[p], lr, cq, C::K_ATOM);
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
  elem_t* out = wg == 0 ? dv : dk;
  constexpr int VPR = C::D / 8;  // 16-byte vectors per row
  for (int x = wtid; x < 64 * VPR; x += WG) {
    const int row = x / VPR;
    const int v = x % VPR;
    if (k0 + row >= S) continue;
    const size_t dst = (static_cast<size_t>(b) * S + k0 + row) * row_stride +
                       static_cast<size_t>(kvh) * C::D + v * 8;
    *reinterpret_cast<uint4*>(out + dst) =
        *reinterpret_cast<const uint4*>(so + stage_off(row, v, C::K_ATOM));
  }
}

// The group split's second pass: dk, dv (n elements each) = the sum over
// chunks, in chunk order, of the f32 partials [n_chunks][2][n]; one
// thread per 4 elements.
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_combine(elem_t* __restrict__ dk, elem_t* __restrict__ dv,
                          const float* __restrict__ part, int n_chunks, long long n4) {
  const long long x = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (x >= 2 * n4) return;
  const long long t = x / n4;  // 0: dk, 1: dv
  const long long e = x % n4;
  const float4* p = reinterpret_cast<const float4*>(part) + t * n4 + e;
  float4 s = p[0];
  for (int c = 1; c < n_chunks; ++c) {
    const float4 v = p[c * 2 * n4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  elem_t* out = t == 0 ? dk : dv;
  *reinterpret_cast<uint2*>(out + 4 * e) = make_uint2(pack_elem(s.x, s.y), pack_elem(s.z, s.w));
}

// dq: one CTA per (q tile, batch, q head), q tiles in reverse order (the
// longest causal rows first); warpgroup wg takes rows rw..rw+63.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, elem_t* __restrict__ dq,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ slopes, int S, int H, int KV, int window,
                        float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;

  const int n_m = (S + C::BM - 1) / C::BM;
  const int BH = gridDim.x / n_m;
  const int bh = blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (n_m - 1 - blockIdx.x / BH) * C::BM;
  // causal: key tiles up to the one holding the CTA's last row; window:
  // from the one holding its first row's first live column. Ring tile t is
  // key tile j0 + t.
  const int j0 = window > 0 ? max(q0 - window + 1, 0) / C::BN : 0;
  const int n_tiles = min((q0 + C::BM - 1) / C::BN + 1, (S + C::BN - 1) / C::BN) - j0;

  auto load = [&](int t) {
    const int st = t % C::STAGES;
    const uint32_t full = bars + 8 * (1 + st);
    const uint32_t k_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    mbar_expect_tx(full, C::STAGE_BYTES);
    for (int a = 0; a < C::NA; ++a) {
      tma_load(k_tile + a * ROW_BYTES, &tk, full, a * ATOM, kvh, (j0 + t) * C::BN, b);
      tma_load(k_tile + C::WG_TILE + a * ROW_BYTES, &tv, full, a * ATOM, kvh, (j0 + t) * C::BN,
               b);
    }
  };

  init_bars<C>(bars, 1);
  if (threadIdx.x == 0) {
    // Q and dO: one box per warpgroup and atom; a warpgroup whose rows all
    // lie past S gets none (its rows are never written)
    uint32_t bytes = 0;
    for (int w = 0; w < C::NWG; ++w)
      if (q0 + 64 * w < S) bytes += 2 * C::WG_TILE;
    mbar_expect_tx(bars, bytes);
    for (int w = 0; w < C::NWG; ++w)
      if (q0 + 64 * w < S)
        for (int a = 0; a < C::NA; ++a) {
          tma_load(base + C::Q_OFF + w * C::WG_TILE + a * ROW_BYTES, &tq, bars, a * ATOM, h,
                   q0 + 64 * w, b);
          tma_load(base + C::DO_OFF + w * C::WG_TILE + a * ROW_BYTES, &tdo, bars, a * ATOM, h,
                   q0 + 64 * w, b);
        }
    for (int t = 0; t < min(AHEAD, n_tiles); ++t) load(t);
  }
  __syncwarp();

  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const int lr = 16 * warp + lane / 4;  // the thread's rows lr and lr + 8 of the 64
  const int rw = q0 + 64 * wg;          // the warpgroup's first row
  const int ra = rw + lr;
  const int cq = 2 * (lane % 4);        // its first key column in each 8-column group
  const float scale_log2 = scale * LOG2E;
  const float slope_log2 = slopes != nullptr ? __fmul_rn(slopes[h], LOG2E) : 0.f;
  const uint32_t q_tile = base + C::Q_OFF + wg * C::WG_TILE;
  const uint32_t do_tile = base + C::DO_OFF + wg * C::WG_TILE;
  // lse (log2 units; +inf past S, so P = 0 there) and delta of rows ra, ra + 8
  const size_t row = (static_cast<size_t>(b) * H + h) * S;
  const float l0 = ra < S ? __fmul_rn(lse[row + ra], LOG2E) : INFINITY;
  const float l1 = ra + 8 < S ? __fmul_rn(lse[row + ra + 8], LOG2E) : INFINITY;
  const float d0 = ra < S ? delta[row + ra] : 0.f;
  const float d1 = ra + 8 < S ? delta[row + ra + 8] : 0.f;

  float acc[C::PARTS][C::ACC_N / 2];  // dQ, f32, wgmma fragment layout, by column part
#pragma unroll
  for (int p = 0; p < C::PARTS; ++p)
#pragma unroll
    for (int i = 0; i < C::ACC_N / 2; ++i) acc[p][i] = 0.f;

  mbar_wait(bars, 0);  // Q, dO
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % C::STAGES;
    const int c0 = (j0 + t) * C::BN;
    const uint32_t k_tile = base + C::RING_OFF + st * C::STAGE_BYTES;
    const uint32_t v_tile = k_tile + C::WG_TILE;
    mbar_wait(bars + 8 * (1 + st), (t / C::STAGES) & 1);
    // a tile the warpgroup's band misses whole takes no products
    if (c0 <= rw + 63 && !(window > 0 && rw - (c0 + C::BN - 1) >= window)) {
      // S = Q K^T, dP = dO V^T
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss(s, gmma_desc(q_tile + off, 16, 1024), gmma_desc(k_tile + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {
        const uint32_t off = (kk / 4) * ROW_BYTES + (kk % 4) * 32;
        wgmma_ss(dp, gmma_desc(do_tile + off, 16, 1024), gmma_desc(v_tile + off, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // P = 2^(s scale + slope (col - row) - lse), dS = P (dP - delta) scale
      const bool cut = c0 + C::BN - 1 > rw || (window > 0 && c0 <= rw + 63 - window);
      uint32_t da[4][4];  // dS in elem_t as A fragments (k-step: 16 keys)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int i = 8 * kk + x;
          const int c = c0 + 8 * (i / 4) + cq + (i & 1);
          const int r = ra + 8 * ((i >> 1) & 1);
          const bool second = (i >> 1) & 1;
          float p = ex2(fmaf(s[i], scale_log2,
                             fmaf(slope_log2, static_cast<float>(c - r), -(second ? l1 : l0))));
          if (cut && (c > r || (window > 0 && c <= r - window))) p = 0.f;
          dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], second ? d1 : d0)), scale);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
          da[kk][x] = pack_ab(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
      }

      // dQ += dS K (K read MN-major; part p takes K's atoms from
      // p * ACC_N / 64)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < C::PARTS; ++p)
          wgmma_rs(acc[p], da[kk],
                   gmma_desc(k_tile + p * (C::ACC_N / ATOM) * ROW_BYTES + kk * 16 * 128,
                             ROW_BYTES, 1024));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int p = 0; p < C::PARTS; ++p) fence_regs(acc[p]);
    }
    release<C>(bars, t, n_tiles, lane, threadIdx.x == 0, load);
  }

  // stage dQ in the warpgroup's Q rows (spent), then write 16-byte vectors
  unsigned char* sq = smem + C::Q_OFF + wg * C::WG_TILE;
#pragma unroll
  for (int p = 0; p < C::PARTS; ++p)
    stage_rows<C::ACC_N>(sq + p * (C::ACC_N / ATOM) * ROW_BYTES, acc[p], lr, cq, ROW_BYTES);
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
  constexpr int VPR = C::D / 8;
  for (int x = wtid; x < 64 * VPR; x += WG) {
    const int r = x / VPR;
    const int v = x % VPR;
    if (rw + r >= S) continue;
    *reinterpret_cast<uint4*>(dq + ((static_cast<size_t>(b) * S + rw + r) * H + h) * C::D +
                              v * 8) =
        *reinterpret_cast<const uint4*>(sq + stage_off(r, v, ROW_BYTES));
  }
}

// Tensor maps of q and dO (64-row boxes) and of k and v (kv_rows-row boxes).
int encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
                int B, int S, int H, int KV, int D, int kv_rows) {
  int err = encode_map(&maps[0], q, B, S, H, D, TILE);
  if (err == 0) err = encode_map(&maps[1], k, B, S, KV, D, kv_rows);
  if (err == 0) err = encode_map(&maps[2], v, B, S, KV, D, kv_rows);
  if (err == 0) err = encode_map(&maps[3], dout, B, S, H, D, TILE);
  return err;
}

template <class C>
int launch_dq(void* dq, const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* slopes, int B, int S, int H,
              int KV, int window, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode_maps(maps, q, k, v, dout, B, S, H, KV, C::D, C::BN);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(B) * H * ((S + C::BM - 1) / C::BM);
  flash_bwd_dq_kernel<C><<<static_cast<unsigned>(ctas), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<elem_t*>(dq),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(slopes), S, H, KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <class C, class Kernel>
int launch_dkv(Kernel kernel, void* dk, void* dv, void* part, const void* q, const void* k,
               const void* v, const void* dout, const void* lse, const void* delta,
               const void* slopes, int B, int S, int H, int KV, int window, int n_chunks,
               float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  int err = encode_maps(maps, q, k, v, dout, B, S, H, KV, C::D, C::BNK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas =
      static_cast<long long>((S + C::BNK - 1) / C::BNK) * B * KV * n_chunks;
  kernel<<<static_cast<unsigned>(ctas), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<elem_t*>(dk),
      static_cast<elem_t*>(dv), n_chunks > 1 ? static_cast<float*>(part) : nullptr,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(slopes), B, S, H, KV, window, n_chunks, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 1) return static_cast<int>(e);
  const long long n4 = static_cast<long long>(B) * S * KV * C::D / 4;
  flash_bwd_dkv_combine<<<static_cast<unsigned>((2 * n4 + 255) / 256), 256, 0, stream>>>(
      static_cast<elem_t*>(dk), static_cast<elem_t*>(dv),
      static_cast<const float*>(part), n_chunks, n4);
  return static_cast<int>(cudaGetLastError());
}

// 128-row CTAs (two warpgroups) where B * heads * ceil(S / 128) fills the
// card, else 64-row CTAs (one warpgroup, two CTAs an SM); dkv always takes
// 128 keys when its group is split. Head dim 256 has one tiling each:
// DqCfg<256, 1> and DkvWideCfg<256> (64 keys), split or not.
bool fills_card(int B, int S, int heads) {
  return static_cast<long long>(B) * heads * ((S + 127) / 128) >= sm_count();
}

template <int D>
int dispatch_dq(void* dq, const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, const void* slopes, int B, int S, int H,
                int KV, int window, float scale, cudaStream_t st) {
  if constexpr (D <= 128)
    if (fills_card(B, S, H))
      return launch_dq<DqCfg<D, 2>>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window,
                                    scale, st);
  return launch_dq<DqCfg<D, 1>>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window,
                                scale, st);
}

template <int D>
int dispatch_dkv(void* dk, void* dv, void* part, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, const void* slopes, int B,
                 int S, int H, int KV, int window, int n_chunks, float scale, cudaStream_t st) {
  if constexpr (D > 128) {
    using C = DkvWideCfg<D>;
    return launch_dkv<C>(flash_bwd_dkv_wide_kernel<C>, dk, dv, part, q, k, v, dout, lse, delta,
                         slopes, B, S, H, KV, window, n_chunks, scale, st);
  } else if (n_chunks > 1 || fills_card(B, S, KV)) {
    using C = DkvCfg<D, 2>;
    return launch_dkv<C>(flash_bwd_dkv_kernel<C>, dk, dv, part, q, k, v, dout, lse, delta,
                         slopes, B, S, H, KV, window, n_chunks, scale, st);
  } else {
    using C = DkvCfg<D, 1>;
    return launch_dkv<C>(flash_bwd_dkv_kernel<C>, dk, dv, part, q, k, v, dout, lse, delta,
                         slopes, B, S, H, KV, window, n_chunks, scale, st);
  }
}

}  // namespace

// slopes: [H] f32 ALiBi slopes in q head order, or null for none
extern "C" int flash_bwd_dq(void* dq, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            const void* slopes, int B, int S, int H, int KV, int D, int window,
                            float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (window >= S) window = 0;  // the causal band: the same result, no overflow in tile bounds
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_dq<64>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window, scale,
                             st);
    case 80:
      return dispatch_dq<80>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window, scale,
                             st);
    case 96:
      return dispatch_dq<96>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window, scale,
                             st);
    case 128:
      return dispatch_dq<128>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window, scale,
                              st);
    case 256:
      return dispatch_dq<256>(dq, q, k, v, dout, lse, delta, slopes, B, S, H, KV, window, scale,
                              st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// slopes: as flash_bwd_dq; the group's q head kv * G + g takes slopes[kv * G + g].
// n_chunks: the group split (1: none); part: its f32 scratch
// [n_chunks, 2, B, S, KV, D], unused (may be null) when n_chunks is 1.
extern "C" int flash_bwd_dkv(void* dk, void* dv, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* slopes, void* part, int B, int S, int H, int KV, int D,
                             int window, int n_chunks, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks < 1 || n_chunks > H / KV || (n_chunks > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch_dkv<64>(dk, dv, part, q, k, v, dout, lse, delta, slopes, B, S, H, KV,
                              window, n_chunks, scale, st);
    case 80:
      return dispatch_dkv<80>(dk, dv, part, q, k, v, dout, lse, delta, slopes, B, S, H, KV,
                              window, n_chunks, scale, st);
    case 96:
      return dispatch_dkv<96>(dk, dv, part, q, k, v, dout, lse, delta, slopes, B, S, H, KV,
                              window, n_chunks, scale, st);
    case 128:
      return dispatch_dkv<128>(dk, dv, part, q, k, v, dout, lse, delta, slopes, B, S, H, KV,
                               window, n_chunks, scale, st);
    case 256:
      return dispatch_dkv<256>(dk, dv, part, q, k, v, dout, lse, delta, slopes, B, S, H, KV,
                               window, n_chunks, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
