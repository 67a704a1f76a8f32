// Paged decode attention: one new query token per row against its paged
// KV context, in four modes built from one template.
//
//   FUSED = true   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//                  paged_decode_fused (_decode_fused_kernel): the cache
//                  holds positions < ctx-1, the new token's K/V enter as
//                  the column at position ctx - 1 from k_new/v_new, and the
//                  row's new K/V row is written into its flat slot. The
//                  same template serves the bf16 fused mode of
//                  paged_decode_attention (_decode_kernel with k_new), which
//                  the JAX package takes where paged_decode_fused's
//                  D % 128 == 0 does not hold (head_dim 64, 80 or 96).
//   FUSED = false  replaces paged_decode_attention (_decode_kernel) in its
//                  plain bf16 mode: attend over cache positions < ctx.
//   QUANT = true   the int8 modes of paged_decode_attention
//                  (_decode_kernel with quant=True, plain and fused): the
//                  pools hold int8 codes with one f32 scale per (slot, KV
//                  head) in [NBLK, bs, KV] scale pools. A tile's codes and
//                  scales arrive by cp.async and are dequantized into the
//                  bf16 tile as bf16(code * scale), q's dtype as in the TPU
//                  kernel, so the products are the bf16 mode's. Fused, the
//                  quantizer of kv_quant.cuh (_quant_row_kernel of the TPU
//                  kernel; codes and scales bit-identical to
//                  quantize_kv_rows) runs where the new column is attended,
//                  and the column takes the dequantized value, as every
//                  later read will.
//
// Bound on the H100: bytes. A row with context c reads c * KV * D * 2 bytes
// of K and as many of V (c * KV * (D + 4) * 2 with int8 codes and their
// scales) and does 4 * c * H * D operations, ~G operations a byte, far
// below the ~295 where the tensor cores would bind. So the design moves
// every live K/V byte once a launch and keeps enough of them in flight:
//
// - One CTA per (row, KV head, split) holds the KV head's whole query
//   group: its G heads, padded to 16-row slices, are the rows of the
//   CTA's matrix products (Falcon-7B's 71 heads over one KV head: 5
//   slices), so each K/V tile is loaded once for all of them, as the TPU
//   kernel did for its padded group (Gp = max(G, 8)). A group of more than
//   128 heads takes one CTA per 128 (the only case that reads a tile
//   twice).
// - Split-K over the context. A split is a fixed run of split_len absolute
//   positions (a multiple of the 64-column tile) chosen by the wrapper's
//   decode_split_plan from the shapes alone (never from ctx_lens, the
//   window, the slopes or the bitmap). Each split's CTA leaves an f32
//   partial (unnormalised O, row max m, row sum l) for each head; the
//   partials are added in split order, never with float atomics, by the
//   last CTA of the (row, KV head) to arrive (an int32 arrival counter the
//   wrapper owns and the combining CTA resets to 0): no second launch,
//   whose host time a host-bound decode step would pay (a second kernel
//   measured slower at the flagship's decode shape; PERF.md).
//   Only the splits a row's live range (and its new column) overlaps take
//   part (live_splits, from ctx and the shapes); the others exit at once.
//   A row with one such split, and every row when nothing is split (S x
//   KV already fills the card), takes its output from that CTA directly:
//   no partial, no second pass.
// - Tiles of 64 positions aligned to absolute multiples of 64, loaded
//   through a 3-stage cp.async ring (16-byte copies; two tiles in flight
//   while one is computed). The split's block-table entries are staged
//   once into shared memory. A position that must not be read (past the
//   live limit, left of the window, in a disallowed block, of another
//   split) is zero-filled by cp.async with src-size 0 and never read from
//   device memory, and a tile with no live position is not loaded at all.
//   Rows are padded to a 16-byte-odd stride (D + 8 bf16) so that ldmatrix
//   reads them without bank conflicts at D 64, 80, 96, 128 and 256.
// - S = Q K^T and O += P V on mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), fragments by ldmatrix (.trans for V). wgmma is not used:
//   it takes 64-row tiles and the group is 1-71 rows, and the tensor cores
//   only take the dot products off the shuffle path here. A warp owns a
//   16-row slice and a part of each tile's columns: with one slice (G <=
//   16) four warps take 16 columns each, with two slices two take 32, with
//   more each warp takes all 64 of its slice; the warps' online-softmax
//   states are combined in shared memory at the end, in warp order. A
//   group of at most 8 (NARROW: Mistral's 4, the MHA models' 1) takes the
//   products transposed, S^T = K Q^T and O^T += V^T P^T, with the keys and
//   the head dim as the 16-row side and the group as the 8 columns: half
//   the products of a 16-row slice, whose rows past the group would be
//   padding; P^T comes from the accumulators by movmatrix.
// - Softmax in f32 on the accumulator fragments: the score is
//   s = dot * scale + slope * position (ALiBi, the ABSOLUTE key position,
//   added in f32 after the scale in the reference's form; slope 0
//   otherwise, which adds exactly nothing), a dead column is set to -inf
//   by a select (never by an addition: 0 x NaN is NaN), and exp2 takes
//   (s - m) * log2(e). P V keeps P in f32 to ~16 bits: P = bf16(P) +
//   bf16(P - bf16(P)), two products into the same f32 accumulators, so the
//   kernel's output differs from its plain version (P in f32) by the
//   summation order and the output's bf16 rounding, as before; the TPU
//   kernel rounds P to bf16 once (paged_attention.py:218).
//
// Sliding window (window > 0, every mode): a row attends to context
// positions ctx - window <= c < ctx (ctx counts the new token), so the live
// range starts at max(ctx - window, 0); no position left of it is loaded.
// window >= ctx starts at 0: the tiles and masks of window 0, bit for bit.
//
// ALiBi (slopes != null, every mode, Bloom-class): the score of q head
// h * group + g at context position c gains slopes[h * group + g] * c with
// c the ABSOLUTE key position (the TPU kernel's `ab_ref * cols`, and
// paged_decode_attention_xla's form); the fused new column is at ctx - 1.
// Null slopes run the same code with slope 0: zero slopes are null's
// result bit for bit.
//
// Block-sparse layout (allowed != null, every mode): allowed is [S,
// table_width] int32, one entry per table slot; column c of row s is
// attended only when allowed[s * table_width + c / block_size] != 0. The
// staged table marks a disallowed block with -1: no byte of it (K, V, int8
// codes or scales) is loaded, its columns are zero-filled and masked, and
// a tile with no allowed live column is skipped. The fused modes' new
// column (ctx - 1) is attended whatever the bitmap says, as in both TPU
// kernels. An all-ones bitmap walks the tiles and masks of none.
//
// Head dims 64, 80, 96, 128 and 256 (Phi-2 has 80, GPT-NeoX-20B 96, GPT-J-6B
// 256): D / 16 k-steps of 16 (5 at D 80: the last by ldmatrix.x2; 6 at D
// 96, no power of two: the row loops and the column-tile pairs take any
// count), D / 8 output column tiles. The int8 quantizer pads a lane's
// missing elements with zeros, which leave amax unchanged and are never
// stored. At D 256 a stage of bf16 K and V is 67,584 bytes, so the
// 3-stage ring takes 202,752 of the 227 KB a block may use (one CTA an
// SM); a 16-row slice's O is 128 f32 registers a thread, which leave no
// room for Q's 64 outside NARROW: there each k-step's Q fragments are
// read again from q (an L1 hit) when a tile needs them. A NARROW warp's
// O^T at D 256 is 64 registers and keeps Q resident.
//
// Pad rows (ctx <= 0) output zeros and write nothing. A fused row with slot
// < 0 attends its cache only. Every block id is clamped to the arena. A row
// with no live, allowed position outputs zeros (l = 0), as the TPU kernels'
// l_safe does; an empty split leaves m = -inf, l = 0, which the combine
// weighs by 0 without reading its O.
//
// Fused-mode ordering: the new column belongs to the one split that holds
// position ctx - 1 (the last split if ctx - 1 is past the table); that CTA
// stages the new K/V row into its tile from shared memory, and, after all
// its own loads, writes the row to its slot (the first 128-head chunk's CTA
// only: the row is written once). No CTA reads that slot: it is position
// ctx - 1 of this row, and every cache loop stops at ctx - 1; rows are
// distinct sequences. So no cross-CTA ordering is needed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <math.h>

#include "kv_quant.cuh"

namespace {

constexpr int TILE = 64;         // context positions a tile
constexpr int STAGES = 3;        // tiles in the cp.async ring
constexpr int SLICE = 16;        // query heads of one warp's mma rows
constexpr int MAX_SLICES = 8;    // slices a CTA: up to 128 query heads
constexpr int MAX_WARPS = 8;
constexpr int MAX_SPLITS = 64;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int LDS = D + 8;        // bf16 row stride of a tile: rows 16 bytes off a bank period
  static constexpr int CPR = D / 8;        // 16-byte chunks of a bf16 row
  static constexpr int CPR8 = D / 16;      // 16-byte chunks of an int8 row
  static constexpr int KSTEPS = D / 16;    // k-steps of Q K^T, column-tile pairs of P V
  static constexpr int TILE_ELEMS = TILE * LDS;
  static constexpr int BF16_STAGE = 2 * TILE_ELEMS * 2;          // K and V tiles, bytes
  static constexpr int RAW_STAGE = 2 * TILE * D + 2 * TILE * 4;  // int8 codes and f32 scales
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert((LDS * 2) % 16 == 0 && RAW_STAGE % 16 == 0, "16-byte rows");
};

template <int D, bool QUANT>
__host__ __device__ constexpr int ring_bytes() {
  return QUANT ? STAGES * Geo<D>::RAW_STAGE + Geo<D>::BF16_STAGE : STAGES * Geo<D>::BF16_STAGE;
}

struct Args {
  __nv_bfloat16* out;            // [S, H, D]
  const __nv_bfloat16* q;        // [S, H, D]
  void* k_pool;                  // [NBLK, bs, KV, D] bf16 or int8
  void* v_pool;
  float* k_scale;                // [NBLK, bs, KV] (QUANT)
  float* v_scale;
  const int32_t* tables;         // [S, table_width]
  const int32_t* ctx_lens;       // [S]
  const __nv_bfloat16* k_new;    // [S, KV, D] (FUSED)
  const __nv_bfloat16* v_new;
  const int32_t* slots;          // [S] (FUSED)
  const float* slopes;           // [H] ALiBi slopes, or null
  const int32_t* allowed;        // [S, table_width] layout bitmap, or null
  float* part;                   // n > 1: f32 partials, O [S, KV, n, G, D] then m, l [S, KV, n, 2, G]
  int* counters;                 // n > 1: [S * KV * g_chunks] int32 arrival counters
  int S, n_kv, group, n_blocks, block_size, table_width, window, fused;
  int n_splits, split_len, span, g_chunks, tbl_cap, tile_cap;
  float scale;
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 (valid false) zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the 8 x 8 bf16 matrix a warp holds in accumulator layout (lane l: row
// l / 4, columns 2 (l % 4) and + 1), transposed, in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16(x, y) and lo = bf16 of what hi leaves out: hi + lo
// carries ~16 bits of each value
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// 16 int8 codes -> 16 bf16(code * scale) at dst (16-byte aligned). A code
// becomes its f32 without a conversion instruction: with its sign bit
// flipped it is u = code + 128, the byte put under the exponent of 2^23
// reads as 2^23 + u, and less 2^23 + 128 that is code, exactly; then one
// f32 product and one bf16 rounding, as bf16(float(code) * scale).
__device__ __forceinline__ void dequant16(uint4 codes, float scale, __nv_bfloat16* dst) {
  const uint32_t in[4] = {codes.x ^ 0x80808080u, codes.y ^ 0x80808080u,
                          codes.z ^ 0x80808080u, codes.w ^ 0x80808080u};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = in[i / 2];
    const int b = 2 * (i % 2);
    const float lo = __int_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | b)) - 8388736.f;
    const float hi = __int_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | (b + 1))) - 8388736.f;
    w[i] = bf16x2_bits(__floats2bfloat162_rn(lo * scale, hi * scale));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// four values as bf16 at dst (8-byte aligned)
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float x, float y, float z, float w) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2_bits(__floats2bfloat162_rn(x, y)),
                                              bf16x2_bits(__floats2bfloat162_rn(z, w)));
}

// ---------------------------------------------------------------------------
// the combine: partials of one (row, KV head, 128-head chunk) added in
// split order
// ---------------------------------------------------------------------------

// The partials of (s, h): O [n][G][D] (16-byte aligned), and m, l [n][2][G].
__device__ __forceinline__ float* part_o(const Args& a, int s, int h, int D) {
  return a.part + ((size_t)s * a.n_kv + h) * a.n_splits * a.group * D;
}

__device__ __forceinline__ float* part_ml(const Args& a, int s, int h, int D) {
  return a.part + (size_t)a.S * a.n_kv * a.n_splits * a.group * D +
         ((size_t)s * a.n_kv + h) * a.n_splits * 2 * a.group;
}

// The splits [lo, hi] of row s that can hold a live position: those the
// row's cache range [max(ctx - window, 0), min(ctx - fused, span))
// overlaps, and the fused new column's (min((ctx - 1) / split_len, n - 1)).
// The others have nothing to add and exit at once; a row with one such
// split (or none: split 0, zeros) takes its output from that split's CTA
// directly, with no partial and no combine. From ctx and the shapes alone,
// so every CTA of the row agrees.
struct SplitRange {
  int lo, hi;
};

__device__ __forceinline__ SplitRange live_splits(const Args& a, int s) {
  const int ctx = a.ctx_lens[s];
  const int L = a.split_len;
  const int limit = min(a.fused ? ctx - 1 : ctx, a.span);
  const int wlo = a.window > 0 ? max(ctx - a.window, 0) : 0;
  SplitRange r{a.n_splits, -1};
  if (wlo < limit) r = {wlo / L, (limit - 1) / L};
  if (a.fused && ctx > 0 && a.slots[s] >= 0) {
    const int c = min((ctx - 1) / L, a.n_splits - 1);
    r = {min(r.lo, c), max(r.hi, c)};
  }
  return r.hi < 0 ? SplitRange{0, 0} : r;
}

// out = sum_c w_c O_c / sum_c w_c l_c over the non-empty splits c of [lo,
// hi] in split order, w_c = exp2((m_c - max m) log2 e); an empty split (m_c = -inf at
// every head) is left out, and its O, never written, is never read; zeros
// where the sum of l is 0. Four columns a thread. Shared memory: w_s n * Gc
// floats, L_s Gc floats, idx_s n + 1 ints. Reads through L2 (ld.cg): other
// CTAs wrote the partials.
template <int D>
__device__ void combine(const Args& a, int s, int h, int g0, int Gc, SplitRange r, float* w_s,
                        float* L_s, int* idx_s) {
  const int n = r.hi - r.lo + 1, G = a.group, NT = blockDim.x;
  const float* po = part_o(a, s, h, D);
  const float* pml = part_ml(a, s, h, D) + (size_t)r.lo * 2 * G;  // split lo's m
  if (threadIdx.x < 32) {  // the non-empty splits, in order (n <= 64)
    const int lane = threadIdx.x;
    const bool f0 = lane < n && __ldcg(pml + lane * 2 * G + g0) != -INFINITY;
    const bool f1 = lane + 32 < n && __ldcg(pml + (lane + 32) * 2 * G + g0) != -INFINITY;
    const unsigned b0 = __ballot_sync(0xffffffffu, f0), b1 = __ballot_sync(0xffffffffu, f1);
    const unsigned below = (1u << lane) - 1u;
    if (f0) idx_s[__popc(b0 & below)] = r.lo + lane;
    if (f1) idx_s[__popc(b0) + __popc(b1 & below)] = r.lo + lane + 32;
    if (lane == 0) idx_s[n] = __popc(b0) + __popc(b1);
  }
  for (int g = threadIdx.x; g < Gc; g += NT) {
    float M = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < n; ++c) M = fmaxf(M, __ldcg(pml + c * 2 * G + g0 + g));
    float L = 0.f;
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const float m = __ldcg(pml + c * 2 * G + g0 + g);
      const float w = m == -INFINITY ? 0.f : exp2f((m - M) * LOG2E);
      w_s[(r.lo + c) * Gc + g] = w;
      L += __ldcg(pml + c * 2 * G + G + g0 + g) * w;
    }
    L_s[g] = L;
  }
  __syncthreads();
  const int nk = idx_s[n];
  __nv_bfloat16* out = a.out + ((size_t)s * a.n_kv * G + (size_t)h * G + g0) * D;
  // CU groups of four columns a thread, their loads of two splits in flight
  // together: the combine is a latency-bound tail after the last split
  constexpr int CU = 8;
  for (int e0 = threadIdx.x * 4; e0 < Gc * D; e0 += NT * 4 * CU) {
    float4 acc[CU];
    int gs[CU];
    size_t off[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int e = min(e0 + u * NT * 4, Gc * D - 4);
      gs[u] = e / D;
      off[u] = (size_t)(g0 + gs[u]) * D + (e - gs[u] * D);
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 2
    for (int k = 0; k < nk; ++k) {
      const int c = idx_s[k];
      const float* pc = po + (size_t)c * G * D;
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const float w = w_s[c * Gc + gs[u]];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(pc + off[u]));
        acc[u].x += x.x * w;
        acc[u].y += x.y * w;
        acc[u].z += x.z * w;
        acc[u].w += x.w * w;
      }
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int e = e0 + u * NT * 4;
      if (e < Gc * D) {
        const float L = L_s[gs[u]];
        store4(out + e, L > 0.f ? acc[u].x / L : 0.f, L > 0.f ? acc[u].y / L : 0.f,
               L > 0.f ? acc[u].z / L : 0.f, L > 0.f ? acc[u].w / L : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the split kernel
// ---------------------------------------------------------------------------

// grid (S * n_splits, KV * g_chunks), split fastest; blockDim 32 x the warps
// of the first chunk (slices x warps a slice)
template <int D, bool FUSED, bool QUANT, bool NARROW>
__global__ void __launch_bounds__(NARROW ? 4 * 32 : MAX_WARPS * 32) decode_kernel(const Args a) {
  using Gm = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long roff_s[STAGES][TILE];  // each stage's rows: slot * KV + h, -1 if dead
  __shared__ unsigned live_s[STAGES + 1][2];   // live columns of tile t at t % (STAGES + 1)
  __shared__ float m_s[MAX_WARPS * SLICE], l_s[MAX_WARPS * SLICE], w_s[MAX_WARPS * SLICE];
  __shared__ float Mrow_s[MAX_SLICES * SLICE], Lrow_s[MAX_SLICES * SLICE];
  __shared__ __align__(16) __nv_bfloat16 new_s[2][D];  // the new K, V row (dequantized on int8)
  __shared__ int8_t code_s[2][D];                     // its codes (QUANT)
  __shared__ float nsc_s[2];                          // and scales
  __shared__ int n_tiles_s, last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, NT = blockDim.x;
  const int split = blockIdx.x % a.n_splits;
  const int s = blockIdx.x / a.n_splits;
  const int chunk = blockIdx.y % a.g_chunks;
  const int h = blockIdx.y / a.g_chunks;
  const int G = a.group, KV = a.n_kv, H = KV * G, bs = a.block_size;
  const int g0 = chunk * MAX_SLICES * SLICE;
  const int Gc = min(MAX_SLICES * SLICE, G - g0);  // query heads of this CTA
  const int slices = (Gc + SLICE - 1) / SLICE;
  const int tw = slices == 1 ? 4 : slices == 2 ? 2 : 1;  // warps a slice
  const int nw = slices * tw;
  const int head0 = h * G + g0;
  const int ctx = a.ctx_lens[s];

  // the split's live positions [lo, hi) of the cache, and the new column
  const int sp0 = split * a.split_len;
  const int sp1 = min(sp0 + a.split_len, a.span);
  const int limit = min(FUSED ? ctx - 1 : ctx, a.span);
  const int lo = max(sp0, a.window > 0 ? max(ctx - a.window, 0) : 0);
  const int hi = min(sp1, limit);
  const int slot = FUSED && ctx > 0 ? a.slots[s] : -1;
  const int newpos = ctx - 1;
  const bool owner = FUSED && ctx > 0 && slot >= 0 &&
                     min(newpos / a.split_len, a.n_splits - 1) == split;
  const SplitRange row_splits = live_splits(a, s);
  if (split < row_splits.lo || split > row_splits.hi) return;  // nothing live to add
  const bool direct = row_splits.lo == row_splits.hi;  // the row's only split

  unsigned char* ring = smem;
  int* tbl_s = reinterpret_cast<int*>(smem + ring_bytes<D, QUANT>());
  int* tiles_s = tbl_s + a.tbl_cap;

  // the block ids of [lo, hi) (-1: a disallowed block), clamped to the arena
  const int blo = lo / bs;
  const int nb = lo < hi ? (hi - 1) / bs - blo + 1 : 0;
  {
    const int32_t* table = a.tables + (size_t)s * a.table_width;
    const int32_t* allow = a.allowed ? a.allowed + (size_t)s * a.table_width : nullptr;
    for (int i = tid; i < nb; i += NT) {
      int id = min(max(table[blo + i], 0), a.n_blocks - 1);
      if (allow && allow[blo + i] == 0) id = -1;
      tbl_s[i] = id;
    }
  }
  const __nv_bfloat16* kn = FUSED ? a.k_new + ((size_t)s * KV + h) * D : nullptr;
  const __nv_bfloat16* vn = FUSED ? a.v_new + ((size_t)s * KV + h) * D : nullptr;
  if (owner) {
    if constexpr (QUANT) {
      // warp 0 quantizes the new K row, warp 1 V (_quant_row_kernel)
      constexpr int EPL = (D + 31) / 32;
      if (warp < 2) {
        const __nv_bfloat16* src = warp ? vn : kn;
        float x[EPL];
        int8_t code[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane * EPL + e;
          x[e] = d < D ? __bfloat162float(src[d]) : 0.f;  // zeros leave amax as it is
        }
        const float sc = kv_quant_slice<EPL>(x, code);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane * EPL + e;
          if (d < D) {
            code_s[warp][d] = code[e];
            new_s[warp][d] = __float2bfloat16_rn((float)code[e] * sc);
          }
        }
        if (lane == 0) nsc_s[warp] = sc;
      }
    } else {
      for (int i = tid; i < 2 * D; i += NT) new_s[i / D][i % D] = (i < D ? kn : vn)[i % D];
    }
  }
  __syncthreads();

  // the tiles with a live position, in order (warp 0)
  const int tn = owner ? newpos / TILE : -1;  // the new column's tile
  if (warp == 0) {
    int ta = lo < hi ? lo / TILE : 0, tb = lo < hi ? (hi + TILE - 1) / TILE : 0;
    if (owner) {
      ta = ta < tb ? min(ta, tn) : tn;
      tb = max(tb, tn + 1);
    }
    int count = 0;
    for (int base = ta; base < tb; base += 32) {
      const int t = base + lane;
      bool keep = t < tb && t == tn;
      if (t < tb && !keep) {
        const int pa = max(t * TILE, lo), pb = min(t * TILE + TILE, hi);
        for (int b = pa / bs; pa < pb && !keep && b <= (pb - 1) / bs; ++b)
          keep = tbl_s[b - blo] >= 0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) tiles_s[count + __popc(m & ((1u << lane) - 1u))] = t * TILE;
      count += __popc(m);
    }
    if (lane == 0) n_tiles_s = count;
  }
  __syncthreads();
  const int n_tiles = n_tiles_s;

  auto cache_live = [&](int p) { return p >= lo && p < hi && tbl_s[p / bs - blo] >= 0; };
  auto slot_of = [&](int p) { return (long long)tbl_s[p / bs - blo] * bs + p % bs; };

  // tile t's rows (threads < TILE, one row each): where each row's K/V
  // lies (slot * KV + h; -1: not read) and the tile's live columns (the
  // cache's and the new one)
  auto rows = [&](int t) {
    if (t < n_tiles && tid < TILE) {
      const int p = tiles_s[t] + tid;
      const bool live = cache_live(p);
      roff_s[t % STAGES][tid] = live ? (long long)slot_of(p) * KV + h : -1ll;
      const unsigned b = __ballot_sync(0xffffffffu, live || (owner && p == newpos));
      if (lane == 0) live_s[t % (STAGES + 1)][warp] = b;
    }
  };

  // issue tile t's copies into stage t % STAGES and commit them as one group
  // (an empty group past the last tile)
  auto issue = [&](int t) {
    const int st = t % STAGES;
    if (t < n_tiles) {
      if constexpr (QUANT) {
        int8_t* kc = reinterpret_cast<int8_t*>(ring + st * Gm::RAW_STAGE);
        int8_t* vc = kc + TILE * D;
        float* ksc = reinterpret_cast<float*>(vc + TILE * D);
        float* vsc = ksc + TILE;
        const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
        const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
        for (int i = tid; i < TILE * Gm::CPR8; i += NT) {
          const int r = i / Gm::CPR8, c = i % Gm::CPR8;
          const long long row = roff_s[st][r];
          const size_t at = row >= 0 ? (size_t)row * D + c * 16 : 0;
          cp_async16(kc + r * D + c * 16, kp + at, row >= 0);
          cp_async16(vc + r * D + c * 16, vp + at, row >= 0);
        }
        for (int r = tid; r < TILE; r += NT) {
          const long long row = roff_s[st][r];
          const size_t at = row >= 0 ? (size_t)row : 0;
          cp_async4(ksc + r, a.k_scale + at, row >= 0);
          cp_async4(vsc + r, a.v_scale + at, row >= 0);
        }
      } else {
        __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(ring + st * Gm::BF16_STAGE);
        __nv_bfloat16* vs = ks + Gm::TILE_ELEMS;
        const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k_pool);
        const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v_pool);
        for (int i = tid; i < TILE * Gm::CPR; i += NT) {
          const int r = i / Gm::CPR, c = i % Gm::CPR;
          const long long row = roff_s[st][r];
          const size_t at = row >= 0 ? (size_t)row * D + c * 8 : 0;
          cp_async16(ks + r * Gm::LDS + c * 8, kp + at, row >= 0);
          cp_async16(vs + r * Gm::LDS + c * 8, vp + at, row >= 0);
        }
      }
    }
    cp_async_commit();
  };

  // this warp: a 16-row slice of the group and its share of each tile's columns
  const int slice = warp % slices, phase = warp / slices;
  const int kw = TILE / tw;  // columns a tile
  const int ntw = kw / 8;    // their 8-column mma tiles: 8, 4 or 2
  const int kb = phase * kw;
  const bool computes = warp < nw;
  const int gid = lane >> 2, qid = lane & 3;
  // Q as A fragments (rows: heads gid, gid + 8 of the slice) or, NARROW, as
  // B fragments of S^T = K Q^T (columns: heads gid of the group); held in
  // registers but at D 256 outside NARROW (QREG false), where each tile
  // reads them from the rows qrows (null: a padding row)
  constexpr bool QREG = NARROW || D <= 128;
  uint32_t qf[QREG ? Gm::KSTEPS : 1][NARROW ? 2 : 4];
  const __nv_bfloat16* qrows[2] = {nullptr, nullptr};
  float slope[2];  // rows gid, gid + 8; NARROW: columns 2 qid, 2 qid + 1
  if constexpr (NARROW) {
    const bool valid = computes && gid < Gc && n_tiles > 0;
    const __nv_bfloat16* qrow = a.q + ((size_t)s * H + head0 + (valid ? gid : 0)) * D;
#pragma unroll
    for (int ks = 0; ks < Gm::KSTEPS; ++ks) {
      const int col = ks * 16 + qid * 2;
      qf[ks][0] = valid ? *reinterpret_cast<const uint32_t*>(qrow + col) : 0u;
      qf[ks][1] = valid ? *reinterpret_cast<const uint32_t*>(qrow + col + 8) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int g = 2 * qid + j;
      slope[j] = computes && g < Gc && a.slopes ? a.slopes[head0 + g] : 0.f;
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int g = slice * SLICE + gid + rr * 8;
      const bool valid = computes && g < Gc && n_tiles > 0;
      const __nv_bfloat16* qrow = a.q + ((size_t)s * H + head0 + (valid ? g : 0)) * D;
      slope[rr] = valid && a.slopes ? a.slopes[head0 + g] : 0.f;
      if constexpr (QREG) {
#pragma unroll
        for (int ks = 0; ks < Gm::KSTEPS; ++ks) {
          const int col = ks * 16 + qid * 2;
          qf[ks][rr] = valid ? *reinterpret_cast<const uint32_t*>(qrow + col) : 0u;
          qf[ks][2 + rr] = valid ? *reinterpret_cast<const uint32_t*>(qrow + col + 8) : 0u;
        }
      } else {
        qrows[rr] = valid ? qrow : nullptr;
      }
    }
  }
  // k-step ks's A fragments from qrows (QREG false)
  auto q_frag = [&](int ks, uint32_t(&f)[4]) {
#ifdef DS_FAULT_Q_FRAG_NEXT_KSTEP  // defined only in a planted fault's build (chip_smoke.py)
    const int col = (ks + 1) % Gm::KSTEPS * 16 + qid * 2;
#else
    const int col = ks * 16 + qid * 2;
#endif
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      f[rr] = qrows[rr] ? *reinterpret_cast<const uint32_t*>(qrows[rr] + col) : 0u;
      f[2 + rr] = qrows[rr] ? *reinterpret_cast<const uint32_t*>(qrows[rr] + col + 8) : 0u;
    }
  };
  // O (rows as the scores'), or NARROW O^T: D / 16 tiles of 16 columns x 8 heads
  constexpr int NO = NARROW ? Gm::KSTEPS : 2 * Gm::KSTEPS;
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // the online softmax's max and (this thread's part of the) sum: rows gid,
  // gid + 8; NARROW: heads 2 qid, 2 qid + 1
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  // NARROW (a group of at most 8): one tile's 16 columns of this warp as
  // S^T = K Q^T (rows the keys, columns the heads: half the products of
  // 16-row slices, whose rows past the group would be padding), the
  // softmax down its columns, and O^T += V^T P^T, P^T taken from the
  // accumulators by movmatrix
  auto compute_narrow = [&](const __nv_bfloat16* kt, const __nv_bfloat16* vt, int p0,
                            unsigned long long live) {
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // even, odd k-steps
    const __nv_bfloat16* krow =
        kt + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * Gm::LDS + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < Gm::KSTEPS; ++ks) {
      uint32_t k4[4];
      ldsm_x4(k4, krow + ks * 16);
      mma(sc[ks & 1], k4, qf[ks][0], qf[ks][1]);
    }
    float v[4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kb + gid + (e >> 1) * 8;
      float x = (sc[0][e] + sc[1][e]) * a.scale + slope[e & 1] * (float)(p0 + key);
      x = (live >> key) & 1ull ? x : -INFINITY;
      v[e] = x;
      mx[e & 1] = fmaxf(mx[e & 1], x);
    }
    float m_use[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o_ = 4; o_ < 32; o_ <<= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o_));
      const float m_new = fmaxf(m_r[j], mx[j]);
      m_use[j] = m_new == -INFINITY ? 0.f : m_new;
      corr[j] = exp2f((m_r[j] - m_use[j]) * LOG2E);
      m_r[j] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = exp2f((v[e] - m_use[e & 1]) * LOG2E);
      psum[e & 1] += v[e];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l_r[j] = l_r[j] * corr[j] + psum[j];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[1];
      o[i][2] *= corr[0];
      o[i][3] *= corr[1];
    }
    uint32_t h01, l01, h23, l23;
    split_bf16(v[0], v[1], h01, l01);
    split_bf16(v[2], v[3], h23, l23);
    const uint32_t bh0 = movmatrix_trans(h01), bh1 = movmatrix_trans(h23);
    const uint32_t bl0 = movmatrix_trans(l01), bl1 = movmatrix_trans(l23);
    const __nv_bfloat16* vrow =
        vt + (kb + (lane & 7) + (lane >> 4) * 8) * Gm::LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int mt = 0; mt < Gm::KSTEPS; ++mt) {
      uint32_t v4[4];
      ldsm_x4_trans(v4, vrow + mt * 16);
      mma(o[mt], v4, bh0, bh1);
      mma(o[mt], v4, bl0, bl1);
    }
  };

  // one tile: S = Q K^T, the online softmax, O += P V
  auto compute = [&](const __nv_bfloat16* kt, const __nv_bfloat16* vt, int p0,
                     unsigned long long live) {
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Gm::KSTEPS; ks += 2) {
      uint32_t qa[2][4];  // QREG false: k-steps ks and ks + 1 (D 256: an even count)
      if constexpr (!QREG) {
        q_frag(ks, qa[0]);
        q_frag(ks + 1, qa[1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < ntw) {
          const __nv_bfloat16* krow = kt + (kb + j * 8 + (lane & 7)) * Gm::LDS + ks * 16;
          if (ks + 1 < Gm::KSTEPS) {
            uint32_t b[4];
            ldsm_x4(b, krow + (lane >> 3) * 8);
            if constexpr (!NARROW && QREG) {
              mma(sc[j], qf[ks], b[0], b[1]);
              mma(sc[j], qf[ks + 1], b[2], b[3]);
            } else if constexpr (!NARROW) {
              mma(sc[j], qa[0], b[0], b[1]);
              mma(sc[j], qa[1], b[2], b[3]);
            }
          } else {
            uint32_t b[2];
            ldsm_x2(b, krow + ((lane >> 3) & 1) * 8);
            if constexpr (!NARROW && QREG) mma(sc[j], qf[ks], b[0], b[1]);
            else if constexpr (!NARROW) mma(sc[j], qa[0], b[0], b[1]);
          }
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntw) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + j * 8 + qid * 2 + (e & 1);
          float v = sc[j][e] * a.scale + slope[e >> 1] * (float)(p0 + key);
          v = (live >> key) & 1ull ? v : -INFINITY;
          sc[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      }
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      m_use[rr] = m_new == -INFINITY ? 0.f : m_new;  // no live column yet: -inf - -inf
      corr[rr] = exp2f((m_r[rr] - m_use[rr]) * LOG2E);
      m_r[rr] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntw) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((sc[j][e] - m_use[e >> 1]) * LOG2E);
          sc[j][e] = p;
          psum[e >> 1] += p;
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l_r[rr] = l_r[rr] * corr[rr] + psum[rr];
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk < ntw) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
        const __nv_bfloat16* vrow =
            vt + (kb + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * Gm::LDS + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < Gm::KSTEPS; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, vrow + dp * 16);
          if constexpr (!NARROW) {
            mma(o[2 * dp], ph, b[0], b[1]);
            mma(o[2 * dp], pl, b[0], b[1]);
            mma(o[2 * dp + 1], ph, b[2], b[3]);
            mma(o[2 * dp + 1], pl, b[2], b[3]);
          }
        }
      }
    }
  };

  // the ring: tiles t + 1 and t + 2 in flight while t is computed; the
  // rows of tile t + 3 are found while the copies of t + 1 and t + 2 fly
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * Gm::RAW_STAGE);
#pragma unroll 1
  for (int t = 0; t < STAGES; ++t) rows(t);
  __syncthreads();
#pragma unroll 1
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int st = t % STAGES;
    const int p0 = tiles_s[t];
    __nv_bfloat16 *kt, *vt;
    if constexpr (QUANT) {
      const int8_t* kc = reinterpret_cast<const int8_t*>(ring + st * Gm::RAW_STAGE);
      const float* ksc = reinterpret_cast<const float*>(kc + 2 * TILE * D);
      for (int i = tid; i < 2 * TILE * Gm::CPR8; i += NT) {
        const int which = i / (TILE * Gm::CPR8), j = i % (TILE * Gm::CPR8);
        const int r = j / Gm::CPR8, c = j % Gm::CPR8;
        const uint4 codes = *reinterpret_cast<const uint4*>(kc + which * TILE * D + r * D + c * 16);
        dequant16(codes, ksc[which * TILE + r], qbuf + which * Gm::TILE_ELEMS + r * Gm::LDS + c * 16);
      }
      kt = qbuf;
      __syncthreads();
    } else {
      kt = reinterpret_cast<__nv_bfloat16*>(ring + st * Gm::BF16_STAGE);
    }
    vt = kt + Gm::TILE_ELEMS;
    if (p0 == tn * TILE) {  // the new column's row, from shared memory
      const int r = newpos - p0;
      for (int i = tid; i < 2 * Gm::CPR; i += NT)
        reinterpret_cast<uint4*>((i < Gm::CPR ? kt : vt) + r * Gm::LDS)[i % Gm::CPR] =
            reinterpret_cast<const uint4*>(new_s[i / Gm::CPR])[i % Gm::CPR];
      __syncthreads();
    }
    const unsigned* lv = live_s[t % (STAGES + 1)];
    const unsigned long long live = (unsigned long long)lv[0] | ((unsigned long long)lv[1] << 32);
    if (computes) {
      if constexpr (NARROW) compute_narrow(kt, vt, p0, live);
      else compute(kt, vt, p0, live);
    }
    rows(t + STAGES);
    __syncthreads();
  }
  cp_async_wait<0>();

  // the new row to its slot, after this CTA's own loads; once (chunk 0)
  if (owner && chunk == 0) {
    int blk = slot / bs;
    blk = min(max(blk, 0), a.n_blocks - 1);
    const size_t dst = (((size_t)blk * bs + slot % bs) * KV + h) * D;
    if constexpr (QUANT) {
      for (int i = tid; i < 2 * D; i += NT)
        (i < D ? static_cast<int8_t*>(a.k_pool) : static_cast<int8_t*>(a.v_pool))[dst + i % D] =
            code_s[i / D][i % D];
      if (tid < 2) (tid ? a.v_scale : a.k_scale)[dst / D] = nsc_s[tid];
    } else {
      for (int i = tid; i < 2 * D; i += NT)
        (i < D ? static_cast<__nv_bfloat16*>(a.k_pool)
               : static_cast<__nv_bfloat16*>(a.v_pool))[dst + i % D] = new_s[i / D][i % D];
    }
  }

  // the CTA's result: its warps' states added in warp order
  const int SL = slices * SLICE;
  float* o_s = reinterpret_cast<float*>(ring);  // [tw][SL][D], the ring's bytes
  __syncthreads();
  if (n_tiles > 0) {
    if constexpr (NARROW) {  // O^T: heads 2 qid + j, columns 16 mt + gid (+ 8)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o_ = 4; o_ < 32; o_ <<= 1) l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], o_);
      if (computes) {
        const int row = phase * SL + 2 * qid;
#pragma unroll
        for (int mt = 0; mt < NO; ++mt) {
          const int col = mt * 16 + gid;
          o_s[(size_t)row * D + col] = o[mt][0];
          o_s[(size_t)(row + 1) * D + col] = o[mt][1];
          o_s[(size_t)row * D + col + 8] = o[mt][2];
          o_s[(size_t)(row + 1) * D + col + 8] = o[mt][3];
        }
        if (gid == 0) {
          m_s[row] = m_r[0];
          l_s[row] = l_r[0];
          m_s[row + 1] = m_r[1];
          l_s[row + 1] = l_r[1];
        }
      }
    } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 1);
      l_r[rr] += __shfl_xor_sync(0xffffffffu, l_r[rr], 2);
    }
    if (computes) {
      const int row = phase * SL + slice * SLICE + gid;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int col = i * 8 + qid * 2;
        *reinterpret_cast<float2*>(o_s + (size_t)row * D + col) = make_float2(o[i][0], o[i][1]);
        *reinterpret_cast<float2*>(o_s + (size_t)(row + 8) * D + col) =
            make_float2(o[i][2], o[i][3]);
      }
      if (qid == 0) {
        m_s[row] = m_r[0];
        l_s[row] = l_r[0];
        m_s[row + 8] = m_r[1];
        l_s[row + 8] = l_r[1];
      }
    }
    }
    __syncthreads();
    for (int g = tid; g < Gc; g += NT) {
      float M = -INFINITY;
      for (int p = 0; p < tw; ++p) M = fmaxf(M, m_s[p * SL + g]);
      float L = 0.f;
      for (int p = 0; p < tw; ++p) {
        const float m = m_s[p * SL + g];
        const float w = m == -INFINITY ? 0.f : exp2f((m - M) * LOG2E);
        w_s[p * SL + g] = w;
        L += l_s[p * SL + g] * w;
      }
      Mrow_s[g] = M;
      Lrow_s[g] = L;
    }
  } else {
    for (int g = tid; g < Gc; g += NT) {
      Mrow_s[g] = -INFINITY;
      Lrow_s[g] = 0.f;
    }
  }
  __syncthreads();

  // four columns a thread: the output itself, or the split's partial (an
  // empty split: m = -inf and l = 0 only)
  float* po = direct ? nullptr : part_o(a, s, h, D) + ((size_t)split * G + g0) * D;
  __nv_bfloat16* out = a.out + ((size_t)s * H + head0) * D;
  if (direct || n_tiles > 0) {
    for (int e = tid * 4; e < Gc * D; e += NT * 4) {
      const int g = e / D, d = e - g * D;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n_tiles > 0) {
        for (int p = 0; p < tw; ++p) {
          const float4 x = *reinterpret_cast<const float4*>(o_s + (size_t)(p * SL + g) * D + d);
          const float w = w_s[p * SL + g];
          acc.x += x.x * w;
          acc.y += x.y * w;
          acc.z += x.z * w;
          acc.w += x.w * w;
        }
      }
      if (direct) {
        const float L = Lrow_s[g];
        store4(out + e, L > 0.f ? acc.x / L : 0.f, L > 0.f ? acc.y / L : 0.f,
               L > 0.f ? acc.z / L : 0.f, L > 0.f ? acc.w / L : 0.f);
      } else {
        *reinterpret_cast<float4*>(po + e) = acc;
      }
    }
  }
  if (direct) return;
  float* pml = part_ml(a, s, h, D) + (size_t)split * 2 * G + g0;
  for (int g = tid; g < Gc; g += NT) {
    pml[g] = Mrow_s[g];
    pml[G + g] = Lrow_s[g];
  }
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (size_t)s * gridDim.y + blockIdx.y;
  if (tid == 0) last_s = atomicAdd(counter, 1) == row_splits.hi - row_splits.lo;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  float* cw = reinterpret_cast<float*>(ring);
  combine<D>(a, s, h, g0, Gc, row_splits, cw, cw + a.n_splits * Gc,
             reinterpret_cast<int*>(cw + a.n_splits * Gc + Gc));
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <int D, bool FUSED, bool QUANT, bool NARROW>
int launch(const Args& a, int S, cudaStream_t stream) {
  const int smem = ring_bytes<D, QUANT>() + (a.tbl_cap + a.tile_cap) * (int)sizeof(int);
  static int attr_device = -1, attr_bytes = 0;  // the dynamic shared memory cap last set
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev || attr_bytes < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<D, FUSED, QUANT, NARROW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_device = dev;
    attr_bytes = smem;
  }
  const int slices = (min(MAX_SLICES * SLICE, a.group) + SLICE - 1) / SLICE;
  const int warps = slices * (slices == 1 ? 4 : slices == 2 ? 2 : 1);
  decode_kernel<D, FUSED, QUANT, NARROW>
      <<<dim3(S * a.n_splits, a.n_kv * a.g_chunks), warps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool NARROW>
int launch_modes(bool fused, bool quant, const Args& a, int S, cudaStream_t stream) {
  if (fused && quant) return launch<D, true, true, NARROW>(a, S, stream);
  if (fused) return launch<D, true, false, NARROW>(a, S, stream);
  if (quant) return launch<D, false, true, NARROW>(a, S, stream);
  return launch<D, false, false, NARROW>(a, S, stream);
}

// a group of at most 8 heads takes the transposed products (NARROW)
template <int D>
int launch_modes(bool fused, bool quant, const Args& a, int S, cudaStream_t stream) {
  return a.group <= 8 ? launch_modes<D, true>(fused, quant, a, S, stream)
                      : launch_modes<D, false>(fused, quant, a, S, stream);
}

}  // namespace

// n_splits splits of split_len positions each (a multiple of 64; the last
// may be cut at the span table_width * block_size). With n_splits > 1,
// `partials` is the f32 scratch [S, KV, n_splits * G * (D + 2)] and
// `counters` the [S * KV * ceil(G / 128)] int32 arrival counters (all 0,
// left 0).
extern "C" int paged_decode(void* out, const void* q, void* k_cache, void* v_cache,
                            void* k_scale, void* v_scale, const void* tables,
                            const void* ctx_lens, const void* k_new, const void* v_new,
                            const void* slots, const void* slopes, const void* allowed,
                            void* partials, void* counters, int fused, int quant, int S, int H,
                            int KV, int D, int n_blocks, int block_size, int table_width,
                            int window, int n_splits, int split_len, float scale, void* stream) {
  if (S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || block_size <= 0 || table_width <= 0 || n_splits < 1 ||
      n_splits > MAX_SPLITS || split_len <= 0 || split_len % TILE != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int g_chunks = (G + MAX_SLICES * SLICE - 1) / (MAX_SLICES * SLICE);
  if ((long long)KV * g_chunks > 65535 || (long long)S * n_splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (fused && (k_new == nullptr || v_new == nullptr || slots == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_splits > 1 && (partials == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int span = table_width * block_size;
  Args a{(__nv_bfloat16*)out, (const __nv_bfloat16*)q, k_cache, v_cache, (float*)k_scale,
         (float*)v_scale, (const int32_t*)tables, (const int32_t*)ctx_lens,
         (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const int32_t*)slots,
         (const float*)slopes, (const int32_t*)allowed, (float*)partials, (int*)counters, S, KV, G,
         n_blocks, block_size, table_width, window, fused != 0, n_splits, split_len, span, g_chunks,
         split_len / block_size + 2, split_len / TILE + 2, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_modes<64>(fused != 0, quant != 0, a, S, st);
    case 80:
      return launch_modes<80>(fused != 0, quant != 0, a, S, st);
    case 96:
      return launch_modes<96>(fused != 0, quant != 0, a, S, st);
    case 128:
      return launch_modes<128>(fused != 0, quant != 0, a, S, st);
    case 256:
      return launch_modes<256>(fused != 0, quant != 0, a, S, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
