// Causal flash-attention forward (FlashAttention online softmax) over
// q [B, S, H, D] and k, v [B, S, KV, D] in bf16, writing o [B, S, H, D]
// in bf16 and the row logsumexp lse [B, H, S] in f32 (kept for the
// backward, csrc/flash_bwd.cu).
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py _flash_fwd
// (_fwd_kernel), the prefill attention of the serving path and the
// forward of the training path, in its causal, sliding-window and ALiBi
// modes, for any whole GQA group and head dims 64, 80 and 128.
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
// - S = Q K^T runs on wgmma (bf16 in, f32 accumulate) with both operands
//   in shared memory; the score tile never leaves registers. The online
//   softmax runs on the accumulator fragments (rows 16w + lane/4 and +8,
//   columns 8j + 2 (lane % 4) and +1): row max and sum across the 4
//   threads that share a row, the rescale of O in registers. P is rounded
//   to bf16 into wgmma A fragments in registers, and O += P V runs on
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
// Head dim 80 (Phi-2): a row of 160 bytes is two 64-column swizzle atoms
// whose columns 80-127 TMA fills with zeros. Q K^T takes the five 16-wide
// depth steps that hold data; P V and the O accumulator run 128 wide (the
// zero columns of V add nothing) and the epilogue writes the first 80.
//
// The TPU kernel's grid ran its k axis in order with the accumulators in
// VMEM scratch; here that axis is the loop inside the CTA.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <chrono>
#include <cstdint>
#include <math.h>

namespace {

constexpr int WG = 128;                   // threads per warpgroup
constexpr int QBOX = 64;                  // Q rows per TMA box (one warpgroup's rows)
constexpr int ATOM = 64;                  // bf16 columns per 128-byte swizzle atom
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
  static constexpr int LDO = DP + 8;                // bf16 stride of an O staging row
  static constexpr int Q_BOX_BYTES = QBOX * ATOM * 2;
  static constexpr int KV_BOX_BYTES = BN * ATOM * 2;
  static constexpr int KV_TILE = NA * KV_BOX_BYTES;  // one stage of K, or of V
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NWG * NA * Q_BOX_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int O_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = O_OFF + NWG * 64 * LDO * 2;
  static constexpr int SMEM = BAR_OFF + (1 + 4 * STAGES) * 8 + 1024;  // + alignment slack
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;
  // registers per thread after setmaxnreg: what the CTA holds at launch
  // (65536 / (THREADS * MIN_BLOCKS), at most 255), the producer's given
  // to the consumers
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 232;
  static_assert(D % 16 == 0 && D <= 128, "head dim");
  static_assert(BN % 64 == 0 && BN <= 128, "key tile");
  static_assert(O_OFF % 1024 == 0 && K_OFF % 1024 == 0 && V_OFF % 1024 == 0, "swizzle alignment");
  static_assert(BAR_OFF % 8 == 0, "mbarrier alignment");
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "shared memory per SM");
  static_assert((PRODUCER_REGS + NWG * CONSUMER_REGS) * WG * MIN_BLOCKS <= 65536, "registers");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait
// that never ends (a lost arrival or transaction count) traps, so a fault
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// One TMA box of a 4-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (wgmma writes it behind the compiler's back).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units). K-major tiles
// (Q, K): rows 128 bytes apart, 8-row groups 1024 apart (the stride
// offset), the leading offset unused. MN-major (V as B of P V): the 8-key
// groups 1024 apart, the 64-column atoms BN * 128 apart (the leading
// offset).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (+)= A B on one warpgroup, m64 x N x k16, f32 accumulators d[N / 2]
// in the wgmma fragment layout. _ss: A and B from shared memory (both
// K-major); scale_d 0 overwrites d. _rs: A from registers (the P
// fragments), B MN-major (transposed) from shared memory, accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// The consumer warpgroup `wg` of a CTA: 64 query rows from r0.
template <class C>
__device__ __forceinline__ void consume(unsigned char* smem, uint32_t base, int wg, int r0,
                                        int j0, int n_tiles, int b, int h, int S, int H,
                                        int window, float scale_log2, const float* slopes,
                                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
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
    // P in bf16 as wgmma A fragments: k-step kk holds columns 16kk..16kk+15
    uint32_t pa[C::BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
    }

    // O += P V
    mbar_wait(bars + 8 * (1 + 2 * STAGES + st), ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk)
      wgmma_rs(acc, pa[kk], gmma_desc(v_tile + kk * 16 * 128, C::KV_BOX_BYTES, 1024));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (1 + 3 * STAGES + st));  // V stage free
  }

  // epilogue: l across the quad, O / l staged in shared memory as bf16,
  // written as 16-byte vectors; lse = m ln 2 + ln l
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem + C::O_OFF) + wg * 64 * C::LDO;
#pragma unroll
  for (int g = 0; g < C::DP / 8; ++g) {
    const int c = 8 * g + cq;
    *reinterpret_cast<__nv_bfloat162*>(so + lr * C::LDO + c) =
        __floats2bfloat162_rn(acc[4 * g] * inv0, acc[4 * g + 1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(so + (lr + 8) * C::LDO + c) =
        __floats2bfloat162_rn(acc[4 * g + 2] * inv1, acc[4 * g + 3] * inv1);
  }
  if (lane % 4 == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
    if (ra < S) lrow[ra] = m0 * LN2 + logf(l0 > 0.f ? l0 : 1.f);
    if (ra + 8 < S) lrow[ra + 8] = m1 * LN2 + logf(l1 > 0.f ? l1 : 1.f);
  }
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(WG) : "memory");
  constexpr int VPR = C::D / 8;  // 16-byte vectors per row
  for (int x = wtid; x < 64 * VPR; x += WG) {
    const int row = x / VPR;
    const int cv = x % VPR;
    if (r0 + row < S)
      *reinterpret_cast<uint4*>(o + ((static_cast<size_t>(b) * S + r0 + row) * H + h) * C::D +
                                cv * 8) =
          *reinterpret_cast<const uint4*>(so + row * C::LDO + cv * 8);
  }
}

// Grid: one CTA per (q tile, batch, q head), q tiles in reverse order
// (blockIdx.x / (B * H) = 0 is the last tile). Threads: NWG consumer
// warpgroups, then the producer warpgroup.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CONSUMER_REGS));
    consume<C>(smem, base, wg, q0 + 64 * wg, j0, n_tiles, b, h, S, H, window, scale_log2,
               slopes, o, lse);
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda); null if the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 4-D tensor map over x [B, S, heads, D] bf16 (innermost first: D, heads,
// S, B): boxes of `rows` positions x 64 columns of one head, 128-byte
// swizzle, zeros outside the tensor (columns past D, rows past S).
int encode_map(CUtensorMap* map, const void* x, int B, int S, int heads, int D, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(ATOM), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
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
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const float*>(slopes), S, H, KV, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

// 128-row CTAs (two consumer warpgroups, 128-key tiles) where they fill
// the card; else 64-row CTAs (one consumer warpgroup, 64-key tiles, two
// CTAs to an SM), which double the CTAs of a short prefill.
template <int D>
int dispatch(void* o, void* lse, const void* q, const void* k, const void* v, const void* slopes,
             int B, int S, int H, int KV, int window, float scale, cudaStream_t st) {
  const long long ctas128 = static_cast<long long>(B) * H * ((S + 127) / 128);
  if (ctas128 >= sm_count())
    return launch<Cfg<D, 2, 128>>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
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
    case 128:
      return dispatch<128>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
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
