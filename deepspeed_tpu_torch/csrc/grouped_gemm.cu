// Grouped (ragged) GEMM of dropless MoE serving, in two operand forms:
//   out[a, :] = xs[a, :] @ w[e(a)]      a in [0, A)
// xs [A, K] bf16 holds the expert-sorted assignment rows in contiguous
// segments, counts [X] int32 (on the device) their lengths; the weights
// are one stack [X, K, N] (N contiguous) of
// - bf16 values (grouped_gemm), or
// - groupwise int8 codes with f32 scales [X, K, groups], one scale per k
//   row and N / groups output columns (grouped_gemm_int8): each weight is
//   bf16_rn(f32(code) * scale), the value ops/quantization.py
//   dequantize_groupwise writes, made on the way into the products.
// f32 sums, bf16 output; rows past sum(counts) are left as the wrapper
// made them (zeros).
//
// Replaces no Pallas kernel. The JAX package runs this product as
// jax.lax.ragged_dot (deepspeed_tpu/moe/dropless.py:134 grouped_mm) on
// stacks that inference/model.py _mlp dequantizes "transiently at use";
// XLA fuses that convert into the dot's operand stream, so the TPU streams
// int8 bytes. On the card only a hand-written kernel computes the product
// without a host read of the segment sizes, and only one that dequantizes
// in its loads reads the codes instead of a bf16 copy of them.
//
// Bound on the H100: bytes. At decode (A = 16 rows over the active
// experts' K x N weights) ~A / active_experts operations a weight byte;
// at prefill (A ~ 1024, ~146 rows an expert) about 146 in bf16, still
// below the 295 where the tensor cores bind. The least time is the active
// experts' weights (2 bytes a weight, or 1 + 4 / group) read once over
// 3.35 TB/s. The design:
// - Operands swapped, as the W8A16 GEMM (int8_matmul.cu): a CTA computes
//   128 output columns (two consumer warpgroups of 64, wgmma's M, the
//   weight tile read MN-major) by TN rows of ONE segment (wgmma's N: 16 at
//   decode, 128 at prefill; ops/cuda/grouped_gemm.py token_width), so a
//   decode segment of 1-4 rows costs an n16 product, not a 64-row tile.
// - A producer warp keeps a ring of STAGES mbarrier-guarded stages in
//   flight. A stage is BK = 64 contraction rows: the weight tile by TMA
//   from a 3-D map over the stack ([X][K][N]: k past K reads zeros, never
//   the next expert's rows), two [64][64] bf16 boxes, or one [64][128]
//   int8 box; the segment's TN rows of xs [TN][64] bf16 by TMA (rows past
//   A are zeros); in the int8 form the stage's 2 x 64 scales, copied by
//   the warp's lanes with cp.async, each arriving on the stage's barrier.
//   All boxes take the 128-byte swizzle. A consumer holds two stages (the
//   one its products read, the one it releases when they end), so the
//   rest of the ring is in flight: 5 of 18 KB (bf16) or 9 of 11 KB (int8)
//   at decode, two CTAs an SM.
// - bf16: wgmma reads the weight box (A, transposed) and the xs box (B)
//   from the stage. int8: each thread reads its A fragments' codes from
//   the swizzled box (one byte each; a warp's loads fall on distinct
//   chunks, no bank conflicts), makes each bf16_rn(f32(code) x the scale
//   of its k row) in registers, and wgmma takes A from registers: nothing
//   is written back to shared memory. Two register sets in turn: stage
//   it + 1 converts while stage it's products run. Measured slower
//   (PERF.md): a first int8 design that converted each stage into bf16
//   boxes in shared memory for the bf16 form's products (its per-stage
//   proxy fences and barriers held the ring to two stages in flight), and
//   2-byte loads of a thread's two codes over a permuted column order, or
//   one copy of the scales for both warpgroups.
// - Segment offsets come from the device: warp 0 of every CTA scans
//   counts (one load a lane, shuffle sums) and finds the segment and the
//   row tile of its blockIdx.x. The grid's row tiles are the bound
//   ceil(A / TN) + min(X, A) - 1 on what the segments take, so the launch
//   needs no host read and a CUDA graph captures it; a CTA whose tile lies past the
//   last segment, or in no segment, exits at once. A count that would run
//   past A is cut at A.
// - Split K (blockIdx.z): where too few tiles would be live to fill the
//   card (decode: 32 column tiles of w_out an active expert), each tile's
//   contraction is cut into `splits` contiguous ranges of BK-deep chunks,
//   sized on the host from A, K, N, X and the form (the active experts
//   live on the device; ops/cuda/grouped_gemm.py grouped_plan). Each split
//   leaves its f32 partial tile in a slot of its own; the last of a tile's
//   CTAs to arrive (an int32 counter a tile, reset to 0 for the next
//   launch) adds the slots in split order, which is k order: no float
//   atomics, the same bits every launch.
// - The epilogue rounds each f32 sum to bf16 once and stores it from the
//   accumulators, transposed (out[row, column]), rows of the segment and
//   columns below N only.
// K must be a multiple of 8 and N of 8 (bf16) or 64 (int8; the group
// N / groups a multiple of 64).
//
// Fault builds (chip_smoke.py FAULT_BUILDS), each of which the checks must
// catch: DS_FAULT_SEGMENT_SHIFT starts segment 1 one row late;
// DS_FAULT_STAGE_BEFORE_BARRIER reads ring stage it + 1 where stage it's
// barrier was waited on; DS_FAULT_SPLIT_LEFT_OUT leaves the last split out
// of the combine; DS_FAULT_SCALE_NEXT_ROW and DS_FAULT_SCALE_NEXT_GROUP
// take the scale of the next k row or the next column group.

#include <mutex>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CH = 128;                 // output columns a CTA (wgmma's M, two warpgroups)
constexpr int NWG = 2;                  // consumer warpgroups
constexpr int BK = 64;                  // contraction rows a ring stage
constexpr int THREADS = NWG * WG + 32;  // the consumers, then the producer warp
constexpr int W_BOX = BK * ATOM * 2;    // one warpgroup's [BK][64] bf16 weights: 8 KB
constexpr int Q_BOX = BK * CH;          // a stage's [BK][128] int8 codes: 8 KB
constexpr int SC_BYTES = NWG * BK * 4;  // a stage's scales [NWG][BK] f32

// One instantiation: the form (Q8: int8 codes), TN rows a tile (wgmma's
// N), the ring's STAGES and the CTAs an SM the registers and shared
// memory are sized for (2 at decode, where a CTA's ramp overlaps its
// neighbour's stream). ops/cuda/grouped_gemm.py (STAGES, smem_bytes)
// keeps a copy of this.
template <bool Q8_, int TN_, int STAGES_, int MINB_>
struct Cfg {
  static constexpr bool Q8 = Q8_;
  static constexpr int TN = TN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int MINB = MINB_;
  static constexpr int X_BOX = TN * 128;  // xs [TN][64] bf16
  static constexpr int W_BYTES = Q8 ? Q_BOX : NWG * W_BOX;
  static constexpr int STAGE = (W_BYTES + X_BOX + (Q8 ? SC_BYTES : 0) + 1023) / 1024 * 1024;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static constexpr int ACC = TN / 2;  // f32 accumulators a thread
  static_assert(SMEM <= 232448 && SMEM * MINB <= 228 * 1024 - 1024 * MINB,
                "shared memory of a CTA, and of MINB CTAs an SM");
  static_assert(STAGES >= 3, "the loops hold two stages while the next loads");
};

struct Args {
  __nv_bfloat16* out;
  const int* counts;
  const float* scale;  // int8: [X, K, groups] f32
  float* part;         // split K: [splits][tiles][TN * CH] f32 partial tiles
  int* counters;       // split K: one arrival counter a tile, 0 between launches
  int A, K, N, X;
  int groups;          // int8: scale columns a k row (group N / groups)
  int splits, chunks;  // ranges of the contraction; BK-deep chunks in K
};

template <int TN>
__device__ __forceinline__ void wgmma_tn(float (&d)[TN / 2], uint64_t a, uint64_t b);

// D += A B on one warpgroup, m64 x TN x k16: A (64 output columns x 16 k)
// read MN-major from shared memory (the weight box, columns contiguous:
// transposed), B (TN rows x 16 k) K-major from shared memory (the xs box)
template <>
__device__ __forceinline__ void wgmma_tn<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t a, uint64_t b) {
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
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// an int8 code (the low byte of b) -> f32, exactly: its sign bit flipped is
// code + 128, which under the exponent of 2^23 reads as 2^23 + code + 128;
// less 2^23 + 128 that is the code
__device__ __forceinline__ float code_f32(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((b ^ 0x80u) & 0xFFu)), 8388736.f);
}

// the bf16 pair (low half: the first) of two codes times their scales: one
// f32 product and one rounding each, as dequantize_groupwise
__device__ __forceinline__ uint32_t deq2(uint32_t b0, float s0, uint32_t b1, float s1) {
  return pack_bf16(__fmul_rn(code_f32(b0), s0), __fmul_rn(code_f32(b1), s1));
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumer threads
  asm volatile("bar.sync 3, %0;" ::"n"(NWG * WG) : "memory");
}

// Warp 0's walk of the segments: the expert, first row and end row of row
// tile t (TN rows of one segment), or expert -1 past the last. Lane l
// reads counts[e0 + l] of each 32 experts e0.. (one round of loads, not X
// in a row); a count cut at A is min(c, A - min(s, A)), s the sum of the
// counts before it, which is what a walk cutting each count at A - offset
// gives; shuffle scans give each expert's offset and first tile.
__device__ __forceinline__ void find_tile(const Args& a, int TN, int t, int lane, int& expert,
                                          int& row0, int& row_end) {
  int tiles_before = 0, off = 0;
  expert = -1;
  row0 = row_end = 0;
  for (int e0 = 0; e0 < a.X; e0 += 32) {
    const int e = e0 + lane;
    int c = e < a.X ? a.counts[e] : 0;
    c = c < 0 ? 0 : c;
    int s = c;  // inclusive sums of the raw counts, then of the tiles
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += v;
    }
    const int before = off + s - c;  // raw rows before e
    const int cut = min(c, max(a.A - min(before, a.A), 0));
    const int seg = min(before, a.A);
    const int tiles = (cut + TN - 1) / TN;
    int ts = tiles;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, ts, d);
      if (lane >= d) ts += v;
    }
    const int first = tiles_before + ts - tiles;  // the expert's first row tile
    const unsigned hit = __ballot_sync(0xffffffffu, t >= first && t < first + tiles);
    if (hit) {
      const int l = __ffs(hit) - 1;
      const int f = __shfl_sync(0xffffffffu, first, l);
      const int n = __shfl_sync(0xffffffffu, cut, l);
      int start = __shfl_sync(0xffffffffu, seg, l);
#ifdef DS_FAULT_SEGMENT_SHIFT
      if (e0 + l == 1) start += 1;  // planted fault: segment 1 starts one row late
#endif
      expert = e0 + l;
      row0 = start + (t - f) * TN;
      row_end = start + n < a.A ? start + n : a.A;
      return;
    }
    tiles_before = __shfl_sync(0xffffffffu, tiles_before + ts, 31);
    off = __shfl_sync(0xffffffffu, off + s, 31);
  }
}

// Where the thread's accumulator i sits in the tile: output column 64 wg
// + 16 warp + g (+8 for i % 4 >= 2), row 8 (i / 4) + 2t (+1 for odd i).
struct Frag {
  int wg, warp, g, t;
  __device__ __forceinline__ int col(int i) const {
    return 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int row(int i) const { return 8 * (i / 4) + 2 * t + (i & 1); }
};

template <class C>
__device__ __forceinline__ void store_tile(const Args& a, const float (&v)[C::ACC], int row0,
                                           int row_end, int col0, const Frag& f) {
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) {
    const int r = row0 + f.row(i), c = col0 + f.col(i);
    if (r < row_end && c < a.N)
      a.out[static_cast<size_t>(r) * a.N + c] = __float2bfloat16_rn(v[i]);
  }
}

// The consumers of one CTA: the products over the split's chunks, then the
// epilogue (split K: the partial, and the combine by the last to arrive).
template <class C>
__device__ __forceinline__ void consume(const Args& a, uint32_t base, int n, int row0,
                                        int row_end, int col0, int tile, int tiles) {
  const int wg = threadIdx.x / WG;
  const int wtid = threadIdx.x % WG;
  const int lane = wtid % 32;
  const Frag f{wg, wtid / 32, lane / 4, lane % 4};
  const uint32_t full = base + C::BAR_OFF;
  const uint32_t empty = full + 8 * C::STAGES;
  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

#ifdef DS_FAULT_STAGE_BEFORE_BARRIER
  constexpr int AHEAD = 1;  // planted fault: the stage after the one waited on
#else
  constexpr int AHEAD = 0;
#endif
  auto stage = [&](int it) { return base + ((it + AHEAD) % C::STAGES) * C::STAGE; };
  auto wait_full = [&](int it) {
    mbar_wait(full + 8 * (it % C::STAGES), (it / C::STAGES) & 1);
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % C::STAGES));
  };
  // bf16: A, the warpgroup's weight box, and B, the xs box, both from the
  // ring stage
  auto issue = [&](int it) {
    const uint32_t st = stage(it);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tn<C::TN>(acc, gmma_desc(st + wg * W_BOX + kk * 16 * 128, W_BOX, 1024),
                      gmma_desc(st + C::W_BYTES + kk * 32, 16, 1024));
    wgmma_commit();
  };
  // int8: A from registers, the codes of stage it converted (convert), B
  // the xs box of the ring stage
  auto issue_q8 = [&](const uint32_t (&af)[BK / 16][4], int it) {
    const uint32_t xb = stage(it) + C::W_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_kb<C::TN>(acc, af[kk], gmma_desc(xb + kk * 32, 16, 1024));
    wgmma_commit();
  };
  // int8: the A fragments of stage it for the thread's two output columns
  // (rows of A: 64 wg + 16 warp + g and + 8) and k-steps kk (k 16 kk + 2t,
  // + 1, + 8, + 9), each code read once from the swizzled box (column c of
  // k row r in chunk (c / 16) ^ (r % 8); a warp's loads of one k fall on
  // four chunks, no bank conflicts) and made bf16_rn(code x its k row's
  // scale)
  auto convert = [&](uint32_t (&af)[BK / 16][4], int it) {
    const uint32_t codes = stage(it);
    const uint32_t sc = codes + C::W_BYTES + C::X_BOX + 4 * wg * BK;
    const int chunk = 4 * wg + f.warp;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // k = 16 kk + 2t, + 1, + 8, + 9
        const int k = 16 * kk + 2 * f.t + (j & 1) + 8 * (j >> 1);
        const uint32_t row = codes + k * 128 + ((chunk ^ (k & 7)) << 4);
        b[j][0] = lds_u8(row + f.g);
        b[j][1] = lds_u8(row + f.g + 8);
      }
      const float2 s0 = lds_f32x2(sc + 4 * (16 * kk + 2 * f.t));
      const float2 s8 = lds_f32x2(sc + 4 * (16 * kk + 2 * f.t + 8));
      af[kk][0] = deq2(b[0][0], s0.x, b[1][0], s0.y);
      af[kk][1] = deq2(b[0][1], s0.x, b[1][1], s0.y);
      af[kk][2] = deq2(b[2][0], s8.x, b[3][0], s8.y);
      af[kk][3] = deq2(b[2][1], s8.x, b[3][1], s8.y);
    }
  };
  auto keep = [&](uint32_t (&af)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(af[kk]);
  };

  if constexpr (C::Q8) {
    // two register sets in turn: stage it + 1 converts while stage it's
    // products run; a set is rewritten only once the products that read
    // it are done
    uint32_t af[2][BK / 16][4] = {};
    auto step = [&](uint32_t (&mine)[BK / 16][4], uint32_t (&next)[BK / 16][4], int it) {
      issue_q8(mine, it);
      wgmma_wait_n<1>();  // step it - 1 is done: its set and its stage are free
      keep(next);
      if (it >= 1) release(it - 1);
      if (it + 1 < n) {
        wait_full(it + 1);
        convert(next, it + 1);
      }
    };
    wait_full(0);
    convert(af[0], 0);
    int it = 0;
    for (; it + 1 < n; it += 2) {  // no issue or wait under a branch (ptxas C7518)
      step(af[0], af[1], it);
      step(af[1], af[0], it + 1);
    }
    if (it < n) step(af[0], af[1], it);
    wgmma_wait_n<0>();
    keep(af[0]);
    keep(af[1]);
  } else {
    for (int it = 0; it < n; ++it) {
      wait_full(it);
      issue(it);
      wgmma_wait_n<1>();
      if (it >= 1) release(it - 1);
    }
    wgmma_wait_n<0>();
  }
  fence_regs(acc);
  release(n - 1);

  if (a.splits == 1) {
    store_tile<C>(a, acc, row0, row_end, col0, f);
    return;
  }
  // split K: this split's partial, then the last CTA of the tile to
  // arrive adds every split's in split (= k) order
  constexpr int SLOT = C::TN * CH;
  const int ctid = threadIdx.x;  // 0 .. 255, the consumers
  float4* mine = reinterpret_cast<float4*>(
      a.part + (static_cast<size_t>(blockIdx.z) * tiles + tile) * SLOT);
#pragma unroll
  for (int q = 0; q < C::ACC / 4; ++q)
    mine[q * NWG * WG + ctid] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                            acc[4 * q + 3]);
  __threadfence();
  consumers_sync();
  __shared__ int s_last;
  if (ctid == 0) s_last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  consumers_sync();
  if (!s_last) return;
  __threadfence();
  float v[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) v[i] = 0.f;
#ifdef DS_FAULT_SPLIT_LEFT_OUT
  const int summed = a.splits - 1;  // planted fault: the last split left out
#else
  const int summed = a.splits;
#endif
  for (int s = 0; s < summed; ++s) {
    const float4* p =
        reinterpret_cast<const float4*>(a.part + (static_cast<size_t>(s) * tiles + tile) * SLOT);
#pragma unroll
    for (int q = 0; q < C::ACC / 4; ++q) {
      const float4 x = __ldcg(p + q * NWG * WG + ctid);
      v[4 * q] += x.x;
      v[4 * q + 1] += x.y;
      v[4 * q + 2] += x.z;
      v[4 * q + 3] += x.w;
    }
  }
  store_tile<C>(a, v, row0, row_end, col0, f);
  if (ctid == 0) a.counters[tile] = 0;  // ready for the next launch
}

// Grid: (row tiles, column tiles, splits). Threads: NWG consumer
// warpgroups, then the producer warp.
template <class C>
__global__ void __launch_bounds__(THREADS, C::MINB)
    grouped_gemm_kernel(const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap tx, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int s_tile[3];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + C::BAR_OFF;
  const uint32_t empty = full + 8 * C::STAGES;
  if (threadIdx.x < 32) {
    int e, r0, r1;
    find_tile(a, C::TN, blockIdx.x, threadIdx.x, e, r0, r1);
    if (threadIdx.x == 0) {
      s_tile[0] = e;
      s_tile[1] = r0;
      s_tile[2] = r1;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, C::Q8 ? 1 + 32 : 1);  // the TMA's bytes (+ each lane's scales)
      mbar_init(empty + 8 * s, 4 * NWG);             // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int expert = s_tile[0], row0 = s_tile[1], row_end = s_tile[2];
  if (expert < 0 || row0 >= row_end) return;  // no rows: the whole CTA
  const int col0 = blockIdx.y * CH;
  const int kc0 = static_cast<int>(static_cast<long long>(blockIdx.z) * a.chunks / a.splits);
  const int kc1 = static_cast<int>(static_cast<long long>(blockIdx.z + 1) * a.chunks / a.splits);
  const int n = kc1 - kc0;

  if (threadIdx.x >= NWG * WG) {  // the producer warp
    const int lane = threadIdx.x % 32;
    const int group = a.N / (a.groups > 0 ? a.groups : 1);
    for (int it = 0; it < n; ++it) {
      const int st = it % C::STAGES;
      const int k0 = (kc0 + it) * BK;
      mbar_wait(empty + 8 * st, ((it / C::STAGES) & 1) ^ 1);  // the first pass finds it free
      const uint32_t bar = full + 8 * st;
      const uint32_t dst = base + st * C::STAGE;
      if (lane == 0) {
        mbar_expect_tx(bar, C::W_BYTES + C::X_BOX);
        tma_load(dst, &tw, bar, col0, k0, expert, 0);
        if (!C::Q8) tma_load(dst + W_BOX, &tw, bar, col0 + ATOM, k0, expert, 0);
        tma_load_2d(dst + C::W_BYTES, &tx, bar, k0, row0);
      }
      if (C::Q8) {
        // scales [NWG][BK]: entry q is k row q % BK of the columns of warpgroup q / BK
        for (int q = lane; q < NWG * BK; q += 32) {
          int k = k0 + q % BK;
          int g = (col0 + ATOM * (q / BK)) / group;
#ifdef DS_FAULT_SCALE_NEXT_ROW
          if (k + 1 < a.K) ++k;  // planted fault: the next k row's scale
#endif
#ifdef DS_FAULT_SCALE_NEXT_GROUP
          if (g + 1 < a.groups) ++g;  // planted fault: the next group's scale
#endif
          const bool ok = k < a.K && g < a.groups;
          cp_async4(dst + C::W_BYTES + C::X_BOX + 4 * q,
                    ok ? a.scale + (static_cast<size_t>(expert) * a.K + k) * a.groups + g
                       : a.scale,
                    ok ? 4u : 0u);
        }
        cp_async_arrive(bar);
      }
    }
    return;
  }
  consume<C>(a, base, n, row0, row_end, col0, blockIdx.x * gridDim.y + blockIdx.y,
             gridDim.x * gridDim.y);
}

// A weight stack's tensor map is a function of (pointer, X, K, N, form)
// alone, so it is encoded once and kept: a stack's later calls find it
// here (a direct-mapped table; a collision encodes again).
constexpr int MAP_SLOTS = 1024;
struct MapSlot {
  const void* p;
  int X, K, N, q8;
  CUtensorMap map;
};
MapSlot map_slots[MAP_SLOTS];
std::mutex map_mutex;

// 4-D map over the stack [X][K][N] (innermost first: N, K, X, 1): boxes
// of BK k rows by 128 bytes of columns (64 bf16 or 128 int8), the 128-byte
// swizzle, zeros outside the stack.
int encode_stack(CUtensorMap* map, const void* w, int X, int K, int N, bool q8) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t esz = q8 ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(X), 1};
  const cuuint64_t strides[3] = {N * esz, static_cast<cuuint64_t>(K) * N * esz,
                                 static_cast<cuuint64_t>(X) * K * N * esz};
  const cuuint32_t box[4] = {q8 ? 128u : 64u, static_cast<cuuint32_t>(BK), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r =
      enc(map, q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
          const_cast<void*>(w), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int stack_map(CUtensorMap* out, const void* w, int X, int K, int N, bool q8) {
  const size_t h = (reinterpret_cast<uintptr_t>(w) >> 8) ^ (static_cast<size_t>(N) * 31 + K) ^
                   (static_cast<size_t>(X) << 5) ^ (q8 ? 7 : 0);
  MapSlot& s = map_slots[h % MAP_SLOTS];
  std::lock_guard<std::mutex> lock(map_mutex);
  if (s.p != w || s.X != X || s.K != K || s.N != N || s.q8 != static_cast<int>(q8)) {
    const int err = encode_stack(&s.map, w, X, K, N, q8);
    if (err != 0) {
      s.p = nullptr;
      return err;
    }
    s.p = w;
    s.X = X;
    s.K = K;
    s.N = N;
    s.q8 = q8;
  }
  *out = s.map;
  return 0;
}

template <class C>
int launch(const void* xs, const void* w, const Args& a, int row_tiles, cudaStream_t stream) {
  CUtensorMap tw, tx;
  int err = stack_map(&tw, w, a.X, a.K, a.N, C::Q8);
  if (err == 0)
    err = encode_map_2d(&tx, xs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.A, a.K, C::TN, ATOM);
  if (err != 0) return err;
  static int attr_device = -1;  // the device whose shared memory cap was last set
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_gemm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_device = dev;
  }
  const dim3 grid(row_tiles, (a.N + CH - 1) / CH, a.splits);
  grouped_gemm_kernel<C><<<grid, THREADS, C::SMEM, stream>>>(tw, tx, a);
  return static_cast<int>(cudaGetLastError());
}

// the row widths and each form's ring (ops/cuda/grouped_gemm.py TOKEN_WIDTHS and STAGES)
template <bool Q8, class F>
int with_cfg(int tn, F&& f) {
  switch (tn) {
    case 16:
      return f(Cfg<Q8, 16, Q8 ? 9 : 5, 2>{});
    case 128:
      return f(Cfg<Q8, 128, Q8 ? 8 : 6, 1>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool Q8>
int run(void* out, const void* xs, const void* w, const void* scale, const void* counts,
        void* part, void* counters, int A, int K, int N, int X, int groups, int tn, int splits,
        void* stream) {
  if (A <= 0 || N <= 0 || X <= 0) return 0;
  if (K <= 0 || K % 8 != 0 || N % (Q8 ? ATOM : 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q8 && (groups <= 0 || N % groups != 0 || (N / groups) % ATOM != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (K + BK - 1) / BK;
  if (splits < 1 || splits > chunks || (splits > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (A + tn - 1) / tn + (X < A ? X : A) - 1;
  const Args a{static_cast<__nv_bfloat16*>(out), static_cast<const int*>(counts),
               static_cast<const float*>(scale), static_cast<float*>(part),
               static_cast<int*>(counters), A, K, N, X, groups, splits, chunks};
  return with_cfg<Q8>(tn, [&](auto cfg) {
    return launch<decltype(cfg)>(xs, w, a, row_tiles, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// out [A, N] bf16, xs [A, K] bf16, w [X, K, N] bf16, counts [X] int32;
// part / counters: split K's f32 partials ([splits][row tiles x column
// tiles][tn x 128]) and int32 arrival counters (one a tile, all 0, left
// 0), unused (may be null) at splits 1; tn 16 or 128 rows a tile. Returns
// the launch's cudaError_t.
extern "C" int grouped_gemm(void* out, const void* xs, const void* w, const void* counts,
                            void* part, void* counters, int A, int K, int N, int X, int tn,
                            int splits, void* stream) {
  return run<false>(out, xs, w, nullptr, counts, part, counters, A, K, N, X, 1, tn, splits,
                    stream);
}

// As grouped_gemm, the weights groupwise int8: codes [X, K, N] int8 and
// scale [X, K, groups] f32 (group N / groups, a multiple of 64).
extern "C" int grouped_gemm_int8(void* out, const void* xs, const void* codes, const void* scale,
                                 const void* counts, void* part, void* counters, int A, int K,
                                 int N, int X, int groups, int tn, int splits, void* stream) {
  return run<true>(out, xs, codes, scale, counts, part, counters, A, K, N, X, groups, tn, splits,
                   stream);
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
