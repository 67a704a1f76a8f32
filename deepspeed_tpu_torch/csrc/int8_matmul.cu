// W8A16 GEMM: Y[M, N] = X[M, K] Q[N, K]^T with bf16 activations X, int8
// codes Q (one output channel a row, K contiguous) and one f32 scale per
// output channel, accumulated in f32:
//   bf16 output: Y = bf16(bf16(X Q^T) * bf16(s))   (inference/model.py _wmm)
//   f32 output:  Y = f32(bf16(X Q^T)) * s           (_lm_logits, the logits)
// Every product of a per-channel int8 serving engine reduces to this form
// (e,ehd->hd with N = heads x D; hd,hde->e with K = H x D; te,ef->tf;
// tf,fe->te; e,ev->v; the tied e,ve->v, whose [V, E] codes are this
// layout already).
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA
// (deepspeed_tpu/inference/model.py:198 _wmm, :216 _lm_logits), which on
// the TPU fuses the int8 -> bf16 convert into the dot's operand stream, so
// the product streams int8 bytes. On the card only a hand-written kernel
// does that: dequantize-then-cuBLAS reads the codes, writes a bf16 copy
// and reads it again, 2.5x the bf16 path's weight bytes.
//
// Bound on the H100: bytes at decode (M = 1-64: N K code bytes against 2 M
// N K operations, far below the 295 operations a byte where the tensor
// cores would bind; at M 1-8 the 7B products stream their codes at 2.0-2.4
// TB/s, close to what the TMA ring reaches with no arithmetic at all),
// operations at prefill (M in the hundreds or thousands). Tokens 1-64 take
// a tile 8-64 wide, prefill tiles of 128 (ops/cuda/int8_matmul.py
// matmul_split_plan). The design:
// - Operands swapped: a consumer warpgroup owns 64 output channels as
//   wgmma's M and the token rows as wgmma's N (TN), so decode's 1-64 rows
//   cost one n8-n64 product, not a 64-row tile of padding, the codes (the
//   large operand) are read once a CTA, and the scale is one per
//   accumulator row. Two consumer warpgroups make a tile of 128 channels
//   x TN tokens.
// - A producer warpgroup (one thread issues every load; setmaxnreg gives
//   its registers to the consumers) keeps a ring of mbarrier-guarded
//   stages in flight, as many as shared memory holds up to MAX_STAGES (6:
//   12 at TN 8 measured slower). A stage is one unit of 128 contraction
//   columns: the codes [128][128 B] as one TMA box, X [TN][128] as two
//   boxes of 64 bf16, all with the 128-byte swizzle, from 2-D tensor maps
//   (hopper.cuh encode_map_2d). TMA fills everything past N, M and K with
//   zeros, so the loop masks nothing (K must be a multiple of 16 for the
//   maps' row strides).
// - Codes to bf16 once, in registers (A from registers, wgmma_rs_kb): each
//   consumer thread reads its two rows' code pairs (k 2t, 2t + 1 and 2t +
//   8, 2t + 9 of each k16 step; 2-byte shared loads, free of bank
//   conflicts under the swizzle, two of them a 4-code word) and converts
//   them exactly: an int8 code's sign bit flipped is code + 128, which
//   placed under the exponent of 2^23 reads as 2^23 + code + 128 in f32;
//   less 2^23 + 128 that is the code, whose f32 upper half is its bf16 (at
//   most 8 significant bits). Shared memory is read once a code and
//   nothing is written back; codes and X keep their natural k order, so
//   nothing is permuted. The next 64-deep half's fragments are converted
//   while the products of the last DEPTH - 1 halves run (DEPTH register
//   sets).
// - The grid is at most one wave and balanced: `ctas` CTAs each take a
//   contiguous range of the units (tile, 128-deep slice), tile-major with
//   token tiles fastest, so every CTA streams the same bytes whatever the
//   tile count. A tile that one CTA covers is stored directly; a tile cut
//   between CTAs (at most the first and the last of each CTA's range)
//   leaves f32 partials in the CTAs' slots, and the CTA that ends the
//   tile adds them after its run, in CTA order, which is k order (no float
//   atomics: the same bits every launch). It waits only on CTAs of lower
//   index; the others count their arrival without waiting. Arrival
//   counters are left at 0 for the next launch (the wrapper keeps them,
//   with the partials, in the stream's decode workspace). The plan takes a
//   grid of one CTA a tile where the tiles fill the card (prefill).
// - The epilogue stores the tile transposed, Y[token, channel], from the
//   accumulators (eight lanes write a run of eight channels of one token
//   row): rounds the f32 sum to bf16, then applies the scale as _wmm does
//   (the product of two bf16 values is exact in f32, so one rounding), or
//   for the logits multiplies in f32. Rows past M and channels past N are
//   not written.
// - Host: the codes are static weights, so their tensor map (a function of
//   pointer, N, K and box) is encoded once and found in a table after; a
//   call encodes only X's (int8_matmul_encode_ns reports the cost). Maps
//   pass as __grid_constant__ parameters, so a CUDA graph captures them
//   by value: a replay relies on X being the graph's static buffer.
// The mma.sync kernel this replaces (its first design: 128-deep slices in
// a 3-stage cp.async ring, both operands in registers) measured slower,
// cold, at every product and width of the served lanes but M 1 on the
// 4096 x 4096 product and the flagship's, and the flagship's logits at M
// 8 (by 0.4-1.4 us; PERF.md); replayed decode ran faster at every lane
// and width.

#include <chrono>
#include <mutex>

#include "hopper.cuh"

namespace {

// four int8 codes (code i in byte i of w) -> bf16x2 words lo = (c0, c1),
// hi = (c2, c3), exactly (see the header)
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

using namespace hopper;

constexpr int UK = 128;           // contraction depth of a unit (a ring stage): a 128-byte code row
constexpr int NWG = 2;            // consumer warpgroups
constexpr int SMEM_CAP = 232448;  // dynamic shared memory a CTA may take (H100)
// stages in the ring at most: more in flight (12 at TN 8) measured slower
// at every decode product of Llama-2-7B (PERF.md)
constexpr int MAX_STAGES = 6;
constexpr int FIXED = 1024 + 2 * MAX_STAGES * 8;  // alignment slack, mbarriers

// One instantiation: TN token rows a tile (wgmma's N; 8-64 at decode, 128
// at prefill). Each consumer warpgroup owns one m64 tile of 64 output
// channels (WGM = 1: CH = 128 channels a tile) and keeps DEPTH register
// sets of A fragments (DEPTH - 1 groups of products in flight while the
// next half-stage converts: 4 at decode, 3 at prefill, where the
// accumulators take more registers). A ring stage holds one unit: the
// codes [CH rows][128 B] as one TMA box and X [TN rows][128 k] as two
// boxes of 64 bf16, all with the 128-byte swizzle; as many stages as
// shared memory holds, at most MAX_STAGES. ops/cuda/int8_matmul.py
// (wgmma_stages) keeps a copy of this rule.
template <int TN_>
struct Cfg {
  static constexpr int TN = TN_;
  static constexpr int DEPTH = TN <= 64 ? 4 : 3;
  static constexpr int CH = 64 * NWG;
  static constexpr int THREADS = (NWG + 1) * WG;
  static constexpr int Q_BYTES = CH * UK;
  static constexpr int X_BOX = TN * 128;
  static constexpr int STAGE = Q_BYTES + 2 * X_BOX;
  static constexpr int FIT = (SMEM_CAP - FIXED) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static constexpr int ACC = TN / 2;  // f32 accumulators a thread
  // registers a thread after setmaxnreg: the producer's given to the consumers
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
  // the consumer holds the stages of DEPTH / 2 units while it waits for the next
  static_assert(DEPTH >= 2 && DEPTH <= 4 && STAGES >= DEPTH / 2 + 1, "ring and register sets");
  static_assert(SMEM <= SMEM_CAP, "shared memory");
  static_assert(X_BOX % 1024 == 0 && Q_BYTES % 1024 == 0, "swizzle alignment");
  static_assert((PRODUCER_REGS + NWG * CONSUMER_REGS) * WG <= 65536, "registers");
};

struct Args {
  void* out;
  const float* scale;
  float* part;    // [2 x ctas, TN, CH] f32 partial tiles (a grid that splits tiles)
  int* counters;  // one arrival counter a tile, 0 between launches
  int M, N, K, f32_out;
  int tok_tiles;  // ceil(M / TN); tile t: channel tile t / tok_tiles, token tile t % tok_tiles
  int chunks;     // units a tile: ceil(K / UK)
  long long units;
};

// CTA g of G takes units [start(g), start(g + 1)) in tile-major order
__host__ __device__ __forceinline__ long long unit_start(long long g, long long units, int G) {
  return g * units / G;
}
// the CTA whose range holds unit u
__host__ __device__ __forceinline__ int cta_of(long long u, long long units, int G) {
  return static_cast<int>(((u + 1) * G + units - 1) / units - 1);
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NWG * WG) : "memory");
}

// The A fragments of one 64-deep half of a stage for the thread's rows
// (rows 16 warp + g and + 8 of warpgroup wg's 64; k-steps kk 0-3: k 16 (4
// half + kk) + 2t, +1 and +8, +9), each code converted once. The codes
// box keeps row r's 16-byte chunk j at chunk j ^ (r % 8), so the eight
// rows a warp reads at once fall on eight chunks: no bank conflicts.
template <class C>
__device__ __forceinline__ void convert(uint32_t (&af)[4][4], uint32_t codes, int half, int wg,
                                        int warp, int g, int t) {
  const uint32_t row = codes + (64 * wg + 16 * warp + g) * UK;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = (((4 * half + kk) ^ g) << 4) + 2 * t;
    const uint32_t r0 = __byte_perm(lds_u16(row + off), lds_u16(row + off + 8), 0x5410);
    const uint32_t r8 =
        __byte_perm(lds_u16(row + 8 * UK + off), lds_u16(row + 8 * UK + off + 8), 0x5410);
    codes_to_bf16(r0, af[kk][0], af[kk][2]);
    codes_to_bf16(r8, af[kk][1], af[kk][3]);
  }
}

// acc += A (this half's codes) X^T (the half's X box, K-major)
template <class C>
__device__ __forceinline__ void issue(float (&acc)[C::ACC], const uint32_t (&af)[4][4],
                                      uint32_t xbox) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_kb<C::TN>(acc, af[kk], gmma_desc(xbox + kk * 32, 16, 1024));
  wgmma_commit();
}

__device__ __forceinline__ void keep(uint32_t (&af)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(af[kk]);
}

// Where the thread's accumulator i sits in the tile: channel 64 wg + 16
// warp + g (+8 for i % 4 >= 2), token 8 (i / 4) + 2t (+1 for odd i).
struct Frag {
  int wg, warp, g, t;
  __device__ __forceinline__ int ch(int i) const {
    return 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int tok(int i) const { return 8 * (i / 4) + 2 * t + (i & 1); }
};

// Y[tok, ch] of the thread's accumulators: the tile stored transposed;
// rows past M and channels past N are not written.
template <class C>
__device__ __forceinline__ void store_tile(const Args& a, const float (&v)[C::ACC], int tile,
                                           const Frag& f) {
  const int ch_base = (tile / a.tok_tiles) * C::CH;
  const int tok_base = (tile % a.tok_tiles) * C::TN;
  const int ch0 = ch_base + f.ch(0);
  const float s0 = ch0 < a.N ? a.scale[ch0] : 0.f;
  const float s1 = ch0 + 8 < a.N ? a.scale[ch0 + 8] : 0.f;
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    const int tok = tok_base + f.tok(i);
    const int ch = ch_base + f.ch(i);
    if (tok >= a.M || ch >= a.N) continue;
    const float s = (i >> 1) & 1 ? s1 : s0;
    const size_t at = static_cast<size_t>(tok) * a.N + ch;
    if (a.f32_out)
      static_cast<float*>(a.out)[at] = bf16_round(v[i]) * s;
    else
      static_cast<__nv_bfloat16*>(a.out)[at] =
          __float2bfloat16_rn(bf16_round(v[i]) * bf16_round(s));
  }
}

// A tile cut between CTAs ga..gb: each leaves its f32 partial in a
// [TN][CH] slot of its own (2 g: its first segment, 2 g + 1: its last);
// the CTA that ends the tile (gb, for which it is the first segment) adds
// them at the end of its run, once the others have arrived, in CTA order,
// which is k order (no float atomics: the same bits every launch). gb
// waits only on CTAs of lower index, which run before it or beside it.
template <class C>
__device__ __forceinline__ void combine(const Args& a, int tile, const Frag& f) {
  const int G = gridDim.x;
  const long long tu0 = static_cast<long long>(tile) * a.chunks;
  const int ga = cta_of(tu0, a.units, G);
  if (threadIdx.x == 0) {
    int* c = a.counters + tile;
    for (uint32_t n = 0; ld_acquire(c) != static_cast<int>(blockIdx.x) - ga; ++n) {
      if (n == (1u << 26)) __trap();  // a lost arrival fails the launch, never hangs the card
      __nanosleep(64);
    }
    *c = 0;  // ready for the next launch
  }
  consumers_sync();
  const bool ga_mid = unit_start(ga, a.units, G) < tu0;  // CTA ga began in an earlier tile
  float v[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) v[i] = 0.f;
  for (int c = ga; c <= static_cast<int>(blockIdx.x); ++c) {
    const float* p = a.part + static_cast<size_t>(2 * c + (c == ga && ga_mid)) * C::TN * C::CH;
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) v[i] += __ldcg(p + f.tok(i) * C::CH + f.ch(i));
  }
  store_tile<C>(a, v, tile, f);
}

// After a segment [u0, u1) of a tile: a whole tile is stored; a part goes
// to the CTA's slot, and a CTA that does not end the tile counts its
// arrival (no wait). Returns the tile if this CTA ends it (combined after
// its run), else -1.
template <class C>
__device__ __forceinline__ int epilogue(const Args& a, const float (&acc)[C::ACC], int tile,
                                        long long u0, long long u1, long long ub, const Frag& f) {
  const long long tu0 = static_cast<long long>(tile) * a.chunks;
  if (u0 == tu0 && u1 == tu0 + a.chunks) {
    store_tile<C>(a, acc, tile, f);
    return -1;
  }
  float* mine = a.part + static_cast<size_t>(2 * blockIdx.x + (u0 > ub)) * C::TN * C::CH;
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) mine[f.tok(i) * C::CH + f.ch(i)] = acc[i];
  if (u1 == tu0 + a.chunks) return tile;  // this CTA ends the tile
  consumers_sync();                       // every thread's part is written
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(a.counters + tile, 1);
  }
  return -1;
}

// A consumer warpgroup: for each segment of the CTA's units (the part of
// one tile), the pipeline below, then the epilogue. The segment runs as
// half-stages (64 deep): the A fragments of half-step s + 1 are converted
// while the products of steps s - DEPTH + 2 .. s run, in DEPTH register
// sets taken in turn (so no set is rewritten while a product reads it);
// a stage is released once its second half's products are done.
template <class C>
__device__ __forceinline__ void consume(const Args& a, uint32_t base, int wg, long long ub,
                                        long long ue) {
  const int wtid = threadIdx.x % WG;
  const int lane = wtid % 32;
  const Frag f{wg, wtid / 32, lane / 4, lane % 4};
  const uint32_t full = base + C::BAR_OFF;
  const uint32_t empty = full + 8 * C::STAGES;
  float acc[C::ACC];
  uint32_t af[C::DEPTH][4][4];
#pragma unroll
  for (int d = 0; d < C::DEPTH; ++d)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) af[d][kk][e] = 0u;
  auto release = [&](int unit) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (unit % C::STAGES));
  };
  auto stage = [&](int unit) { return base + (unit % C::STAGES) * C::STAGE; };
  auto arrived = [&](int unit) {
    mbar_wait(full + 8 * (unit % C::STAGES), (unit / C::STAGES) & 1);
  };
  int deferred = -1;  // the tile this CTA ends, combined after its run
  int it = 0;         // the ring position of the segment's first unit
  for (long long u = ub; u < ue;) {
    const int tile = static_cast<int>(u / a.chunks);
    const long long seg_end = min(ue, static_cast<long long>(tile + 1) * a.chunks);
    const int steps = 2 * static_cast<int>(seg_end - u);
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
    arrived(it);
    convert<C>(af[0], stage(it), 0, wg, f.warp, f.g, f.t);
    for (int s0 = 0; s0 < steps; s0 += C::DEPTH) {
#pragma unroll
      for (int d = 0; d < C::DEPTH; ++d) {
        const int s = s0 + d;
        if (s < steps) {
          issue<C>(acc, af[d], stage(it + s / 2) + C::Q_BYTES + (s & 1) * C::X_BOX);
          wgmma_wait_n<C::DEPTH - 1>();  // step s - DEPTH + 1 is done: its set is free
          keep(af[(d + 1) % C::DEPTH]);
          const int done = s - (C::DEPTH - 1);
          if (done >= 0 && (done & 1)) release(it + done / 2);
          if (s + 1 < steps) {
            if (((s + 1) & 1) == 0) arrived(it + (s + 1) / 2);
            convert<C>(af[(d + 1) % C::DEPTH], stage(it + (s + 1) / 2), (s + 1) & 1, wg, f.warp,
                       f.g, f.t);
          }
        }
      }
    }
    wgmma_wait_n<0>();
#pragma unroll
    for (int d = 0; d < C::DEPTH; ++d) keep(af[d]);
    fence_regs(acc);
    for (int done = max(steps - C::DEPTH + 1, 0); done < steps; ++done)
      if (done & 1) release(it + done / 2);
    const int ends = epilogue<C>(a, acc, tile, u, seg_end, ub, f);
    if (ends >= 0) deferred = ends;
    it += static_cast<int>(seg_end - u);
    u = seg_end;
  }
  if (deferred >= 0) combine<C>(a, deferred, f);
}

// Grid: `ctas` CTAs, each a contiguous range of the units (tile-major,
// token tiles fastest within a channel tile). Threads: NWG consumer
// warpgroups, then the producer warpgroup, one thread of which issues
// every load.
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tx, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + C::BAR_OFF;
  const uint32_t empty = full + 8 * C::STAGES;
  const long long ub = unit_start(blockIdx.x, a.units, gridDim.x);
  const long long ue = unit_start(blockIdx.x + 1, a.units, gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x % WG == 0) {
      int it = 0;
      for (long long u = ub; u < ue; ++u, ++it) {
        const int st = it % C::STAGES;
        const int tile = static_cast<int>(u / a.chunks);
        const int k0 = static_cast<int>(u - static_cast<long long>(tile) * a.chunks) * UK;
        const int ch0 = (tile / a.tok_tiles) * C::CH;
        const int tok0 = (tile % a.tok_tiles) * C::TN;
        mbar_wait(empty + 8 * st, ((it / C::STAGES) & 1) ^ 1);  // the first pass finds it free
        const uint32_t bar = full + 8 * st;
        const uint32_t dst = base + st * C::STAGE;
        mbar_expect_tx(bar, C::STAGE);
        tma_load_2d(dst, &tq, bar, k0, ch0);
        tma_load_2d(dst + C::Q_BYTES, &tx, bar, k0, tok0);
        tma_load_2d(dst + C::Q_BYTES + C::X_BOX, &tx, bar, k0 + 64, tok0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(C::CONSUMER_REGS));
  consume<C>(a, base, wg, ub, ue);
}

// The codes' tensor map is a function of (pointer, N, K, box rows) alone,
// so it is encoded once and kept: a weight's later calls find it here
// (a direct-mapped table; a collision encodes again).
constexpr int MAP_SLOTS = 4096;
struct MapSlot {
  const void* p;
  int rows, cols, box;
  CUtensorMap map;
};
MapSlot map_slots[MAP_SLOTS];
std::mutex map_mutex;

int codes_map(CUtensorMap* out, const void* q, int N, int K, int box_rows) {
  const size_t h = (reinterpret_cast<uintptr_t>(q) >> 8) ^ (static_cast<size_t>(N) * 31 + K) ^
                   (static_cast<size_t>(box_rows) << 3);
  MapSlot& s = map_slots[h % MAP_SLOTS];
  std::lock_guard<std::mutex> lock(map_mutex);
  if (s.p != q || s.rows != N || s.cols != K || s.box != box_rows) {
    const int err = encode_map_2d(&s.map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, box_rows, UK);
    if (err != 0) {
      s.p = nullptr;
      return err;
    }
    s.p = q;
    s.rows = N;
    s.cols = K;
    s.box = box_rows;
  }
  *out = s.map;
  return 0;
}

template <class C>
int encode_maps(CUtensorMap* tq, CUtensorMap* tx, const void* x, const void* q, int M, int N,
                int K) {
  int err = codes_map(tq, q, N, K, C::CH);
  if (err == 0)
    err = encode_map_2d(tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, C::TN, 64);
  return err;
}

template <class C>
int launch(const void* x, const void* q, const Args& a, int ctas, cudaStream_t stream) {
  CUtensorMap tq, tx;
  const int err = encode_maps<C>(&tq, &tx, x, q, a.M, a.N, a.K);
  if (err != 0) return err;
  static int attr_device = -1;  // the device whose shared memory cap was last set
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a16_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_device = dev;
  }
  w8a16_wgmma_kernel<C><<<ctas, C::THREADS, C::SMEM, stream>>>(tq, tx, a);
  return static_cast<int>(cudaGetLastError());
}

// the token widths (ops/cuda/int8_matmul.py TOKEN_WIDTHS)
template <class F>
int with_cfg(int tn, F&& f) {
  switch (tn) {
    case 8:
      return f(Cfg<8>{});
    case 16:
      return f(Cfg<16>{});
    case 32:
      return f(Cfg<32>{});
    case 64:
      return f(Cfg<64>{});
    case 128:
      return f(Cfg<128>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// whether some CTA's range starts inside a tile (then tiles are split)
bool splits_tiles(long long units, int chunks, int ctas) {
  if (units % ctas == 0) return (units / ctas) % chunks != 0;
  for (int g = 1; g < ctas; ++g)
    if (unit_start(g, units, ctas) % chunks != 0) return true;
  return false;
}

}  // namespace

// out [M, N] bf16 (f32_out 0) or f32 (f32_out 1); x [M, K] bf16; codes
// [N, K] int8; scale [N] f32; K a multiple of 16; x and codes 16-byte
// aligned. tn: token rows a tile, 8, 16, 32, 64 or 128. ctas: the grid,
// at most the units (ceil(N / 128) ceil(M / tn) tiles x ceil(K / 128));
// where it cuts a tile between CTAs, `partials` holds 2 x ctas x tn x 128
// f32 and `counters` one int32 a tile (all 0, left 0).
extern "C" int int8_matmul(void* out, const void* x, const void* codes, const void* scale,
                           void* partials, void* counters, int M, int N, int K, int tn, int ctas,
                           int f32_out, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_cfg(tn, [&](auto cfg) {
    using C = decltype(cfg);
    const int tok_tiles = (M + C::TN - 1) / C::TN;
    const long long tiles = static_cast<long long>((N + C::CH - 1) / C::CH) * tok_tiles;
    const int chunks = (K + UK - 1) / UK;
    const long long units = tiles * chunks;
    if (tiles > (1LL << 30) || ctas < 1 || ctas > units)
      return static_cast<int>(cudaErrorInvalidValue);
    if (splits_tiles(units, chunks, ctas) && (partials == nullptr || counters == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const Args a{out, static_cast<const float*>(scale), static_cast<float*>(partials),
                 static_cast<int*>(counters), M, N, K, f32_out != 0, tok_tiles, chunks, units};
    return launch<C>(x, codes, a, ctas, static_cast<cudaStream_t>(stream));
  });
}

// Host cost of one call's tensor maps: nanoseconds to find the codes' map
// (encoded at its first call, found in the table after) and encode x's,
// `iters` times, or -1.
extern "C" int int8_matmul_encode_ns(const void* x, const void* codes, int M, int N, int K, int tn,
                                     int iters) {
  return with_cfg(tn, [&](auto cfg) {
    using C = decltype(cfg);
    CUtensorMap tq, tx;
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < iters; ++i)
      if (encode_maps<C>(&tq, &tx, x, codes, M, N, K) != 0) return -1;
    const auto t1 = std::chrono::steady_clock::now();
    return static_cast<int>(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count());
  });
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
