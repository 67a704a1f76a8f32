// Paged decode attention in f32: one new f32 query token per row against
// its paged KV context, from f32 pools or from int8 pools with f32 scales,
// plain or with the fused write of the new row; the f32 serving engine's
// decode.
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py _decode_kernel
// (paged_decode_attention, :443) and _decode_fused_kernel
// (paged_decode_fused, :795) where q is f32: the JAX kernels take q's
// dtype (:410, :802), so an f32 engine computes its products and its
// softmax in f32, and on int8 pools dequantizes each code as f32(code) *
// scale (:186-188), never rounded to bf16. The modes are paged_decode.cu's:
//   FUSED   the cache holds positions < ctx - 1; the row's new K/V enter
//           as the column at ctx - 1 from k_new/v_new and are written to
//           the row's flat slot (QUANT: quantized by kv_quant_f32.cuh, bit
//           for bit the plain quantize_kv_rows, and attended as their
//           dequantized f32 value, as every later read will see them);
//   QUANT   int8 code pools with [NBLK, bs, KV] f32 scale pools;
// with a sliding window, ALiBi slopes (the ABSOLUTE key position), the
// [S, table_width] layout bitmap (the fused new column attended whatever
// it says), any whole GQA group and head dims 64, 80, 96, 128 and 256. The
// semantics (live ranges, pad rows, clamped block ids, empty splits, the
// fused ordering) are paged_decode.cu's; see there.
//
// Bound on the H100: bytes. A row with context c reads c * KV * D * 4
// bytes of K and as many of V (c * KV * (D + 4) * 2 from int8 pools) and
// does 4 * c * H * D operations, ~G / 2 operations a byte, far below what
// the CUDA cores' 67 TF/s of f32 FMA would bind. So the design is plain
// FFMA and keeps the bf16 kernel's structure for the bytes:
//
// - The split plan and its in-order combine are paged_decode.cu's: one CTA
//   per (row, KV head, split, chunk of at most 64 query heads), a split's
//   f32 partials (O, m, l) added in split order by the last CTA of the
//   (row, KV head, chunk) to arrive; no float atomics, the same bits every
//   run. The wrapper's decode_split_plan chooses the splits from the
//   shapes alone. (64 heads a CTA, where the bf16 kernel holds 128, keep
//   the f32 O accumulator of a CTA in shared memory at any head dim.)
// - Tiles of 32 positions, aligned to absolute multiples of 32, through a
//   two-stage cp.async ring (16-byte copies), f32 rows padded to D + 4
//   floats so that the float4 reads of 8 neighbouring rows fall on 8
//   different bank quads. A position that must not be read is zero-filled
//   with src-size 0 and never read from device memory; a tile with no live
//   position is not loaded. int8 tiles arrive as codes and scales and are
//   dequantized into an f32 tile in shared memory.
// - S = q K^T: a thread a (query head, position) pair, the head's q row
//   read through L1 (a warp reads one row: a broadcast), K's row from
//   shared memory, float4 at a time, FFMA. The online softmax: a warp a
//   head, a lane a position, exp in f32 (expf), the score s * scale +
//   slope * position, a dead position set to -inf by a select. O += P V:
//   a thread four columns of one head, the head's O in shared memory.
// - The output, or the split's partial, from the head's O, m and l.
//
// Planted faults (defined only in chip_smoke.py's fault builds):
// DS_FAULT_TF32 rounds the operands of every product (q and K, P and V)
// to TF32 first, as single-pass TF32 tensor-core products would;
// DS_FAULT_SPLIT_DROPPED leaves the last non-empty split out of the
// combine.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

#include "kv_quant_f32.cuh"

namespace {

constexpr int TILE = 32;      // context positions a tile: one a lane in the softmax
constexpr int STAGES = 2;     // tiles in the cp.async ring
constexpr int GCH = 64;       // query heads a CTA
constexpr int NT = 256;       // threads a CTA
constexpr int NW = NT / 32;
constexpr int MAX_SPLITS = 64;

template <int D>
struct Geo {
  static constexpr int LDK = D + 4;                         // f32 tile rows (floats)
  static constexpr int CH = D / 4;                          // 16-byte chunks of an f32 row
  static constexpr int CH8 = D / 16;                        // of an int8 row
  static constexpr int D4 = D / 4;                          // float4 columns
  static constexpr int F32_TILE = TILE * LDK;               // floats of a K (or V) tile
  static constexpr int F32_STAGE = 2 * F32_TILE * 4;        // bytes: K and V
  static constexpr int RAW_STAGE = 2 * TILE * D + 2 * TILE * 4;  // int8 codes, f32 scales
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
};

template <int D, bool QUANT>
__host__ __device__ constexpr int ring_bytes() {
  return QUANT ? STAGES * Geo<D>::RAW_STAGE + Geo<D>::F32_STAGE : STAGES * Geo<D>::F32_STAGE;
}

struct Args {
  float* out;                    // [S, H, D]
  const float* q;                // [S, H, D]
  void* k_pool;                  // [NBLK, bs, KV, D] f32 or int8
  void* v_pool;
  float* k_scale;                // [NBLK, bs, KV] (QUANT)
  float* v_scale;
  const int32_t* tables;         // [S, table_width]
  const int32_t* ctx_lens;       // [S]
  const float* k_new;            // [S, KV, D] (FUSED)
  const float* v_new;
  const int32_t* slots;          // [S] (FUSED)
  const float* slopes;           // [H] ALiBi slopes, or null
  const int32_t* allowed;        // [S, table_width] layout bitmap, or null
  float* part;                   // n > 1: O [S, KV, n, G, D] then m, l [S, KV, n, 2, G]
  int* counters;                 // n > 1: [S * KV * g_chunks] int32 arrival counters
  int S, n_kv, group, n_blocks, block_size, table_width, window, fused;
  int n_splits, split_len, span, g_chunks, gmax, tbl_cap, tile_cap;
  float scale;
};

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

// a product's operand: itself, or in the planted fault's build its TF32
// rounding (10 mantissa bits, as single-pass TF32 tensor cores take it)
__device__ __forceinline__ float op(float x) {
#ifdef DS_FAULT_TF32
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
#else
  return x;
#endif
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the partials of (s, h): O [n][G][D], and m, l [n][2][G]
__device__ __forceinline__ float* part_o(const Args& a, int s, int h, int D) {
  return a.part + ((size_t)s * a.n_kv + h) * a.n_splits * a.group * D;
}

__device__ __forceinline__ float* part_ml(const Args& a, int s, int h, int D) {
  return a.part + (size_t)a.S * a.n_kv * a.n_splits * a.group * D +
         ((size_t)s * a.n_kv + h) * a.n_splits * 2 * a.group;
}

// The splits [lo, hi] of row s that can hold a live position (paged_decode.cu's
// live_splits): from ctx and the shapes alone, so every CTA of the row agrees.
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

// out = sum_c w_c O_c / sum_c w_c l_c over the non-empty splits c of [lo, hi]
// in split order, w_c = exp(m_c - max m); an empty split (m_c = -inf) is
// left out and its O never read; zeros where the sum of l is 0. Shared
// memory: w_s n * Gc floats, L_s Gc floats, idx_s n + 1 ints. Reads through
// L2 (ld.cg): other CTAs wrote the partials.
template <int D>
__device__ void combine(const Args& a, int s, int h, int g0, int Gc, SplitRange r, float* w_s,
                        float* L_s, int* idx_s) {
  const int n = r.hi - r.lo + 1, G = a.group;
  const float* po = part_o(a, s, h, D);
  const float* pml = part_ml(a, s, h, D) + (size_t)r.lo * 2 * G;
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
    for (int c = 0; c < n; ++c) M = fmaxf(M, __ldcg(pml + c * 2 * G + g0 + g));
    float L = 0.f;
    for (int c = 0; c < n; ++c) {
      const float m = __ldcg(pml + c * 2 * G + g0 + g);
      const float w = m == -INFINITY ? 0.f : expf(m - M);
      w_s[(r.lo + c) * Gc + g] = w;
      L += __ldcg(pml + c * 2 * G + G + g0 + g) * w;
    }
    L_s[g] = L;
  }
  __syncthreads();
#ifdef DS_FAULT_SPLIT_DROPPED  // defined only in a planted fault's build (chip_smoke.py)
  const int nk = max(idx_s[n] - 1, 1);
#else
  const int nk = idx_s[n];
#endif
  float* out = a.out + ((size_t)s * a.n_kv * G + (size_t)h * G + g0) * D;
  for (int e = threadIdx.x * 4; e < Gc * D; e += NT * 4) {
    const int g = e / D;
    const size_t off = (size_t)(g0 + g) * D + (e - g * D);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nk; ++k) {
      const int c = idx_s[k];
      const float w = w_s[c * Gc + g];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(po + (size_t)c * G * D + off));
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    const float L = L_s[g];
    *reinterpret_cast<float4*>(out + e) =
        L > 0.f ? make_float4(acc.x / L, acc.y / L, acc.z / L, acc.w / L)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// grid (S * n_splits, KV * g_chunks), split fastest; NT threads
template <int D, bool FUSED, bool QUANT>
__global__ void __launch_bounds__(NT, 1) decode_f32_kernel(const Args a) {
  using Gm = Geo<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float m_s[GCH], l_s[GCH], corr_s[GCH], slope_s[GCH];
  __shared__ __align__(16) float new_s[2][D];  // the new K, V row (dequantized on int8)
  __shared__ int8_t code_s[2][D];              // its codes (QUANT)
  __shared__ float nsc_s[2];                   // and scales
  __shared__ int n_tiles_s, last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % a.n_splits;
  const int s = blockIdx.x / a.n_splits;
  const int chunk = blockIdx.y % a.g_chunks;
  const int h = blockIdx.y / a.g_chunks;
  const int G = a.group, KV = a.n_kv, H = KV * G, bs = a.block_size;
  const int g0 = chunk * GCH;
  const int Gc = min(GCH, G - g0);  // query heads of this CTA
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
  float* o_s = reinterpret_cast<float*>(smem + ring_bytes<D, QUANT>());  // [gmax][D]
  float* p_s = o_s + (size_t)a.gmax * D;                                // [gmax][TILE]
  int* tbl_s = reinterpret_cast<int*>(p_s + (size_t)a.gmax * TILE);
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
  for (int g = tid; g < Gc; g += NT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
    slope_s[g] = a.slopes ? a.slopes[head0 + g] : 0.f;
  }
  for (int i = tid; i < Gc * D; i += NT) o_s[i] = 0.f;
  if (owner) {
    const float* kn = a.k_new + ((size_t)s * KV + h) * D;
    const float* vn = a.v_new + ((size_t)s * KV + h) * D;
    if constexpr (QUANT) {
      // warp 0 quantizes the new K row, warp 1 V (_quant_row_kernel)
      constexpr int EPL = (D + 31) / 32;
      if (warp < 2) {
        float x[EPL];
        int code[EPL];
        const float sc = kv_quant_warp_f32<D>(warp ? vn : kn, lane, x, code);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane + 32 * e;
          if (d < D) {
            code_s[warp][d] = (int8_t)code[e];
            new_s[warp][d] = __fmul_rn((float)code[e], sc);
          }
        }
        if (lane == 0) nsc_s[warp] = sc;
      }
    } else {
      for (int i = tid; i < 2 * D; i += NT) new_s[i / D][i % D] = (i < D ? kn : vn)[i % D];
    }
  }
  __syncthreads();

  auto cache_live = [&](int p) { return p >= lo && p < hi && tbl_s[p / bs - blo] >= 0; };
  auto slot_of = [&](int p) { return (long long)tbl_s[p / bs - blo] * bs + p % bs; };

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

  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int st = t % STAGES;
      const int p0 = tiles_s[t];
      if constexpr (QUANT) {
        int8_t* kc = reinterpret_cast<int8_t*>(ring + st * Gm::RAW_STAGE);
        int8_t* vc = kc + TILE * D;
        float* ksc = reinterpret_cast<float*>(vc + TILE * D);
        float* vsc = ksc + TILE;
        const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
        const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
        for (int i = tid; i < TILE * Gm::CH8; i += NT) {
          const int r = i / Gm::CH8, c = i % Gm::CH8;
          const bool live = cache_live(p0 + r);
          const size_t at = live ? ((size_t)slot_of(p0 + r) * KV + h) * D + c * 16 : 0;
          cp_async16(kc + r * D + c * 16, kp + at, live);
          cp_async16(vc + r * D + c * 16, vp + at, live);
        }
        for (int r = tid; r < TILE; r += NT) {
          const bool live = cache_live(p0 + r);
          const size_t at = live ? (size_t)slot_of(p0 + r) * KV + h : 0;
          cp_async4(ksc + r, a.k_scale + at, live);
          cp_async4(vsc + r, a.v_scale + at, live);
        }
      } else {
        float* ks = reinterpret_cast<float*>(ring + st * Gm::F32_STAGE);
        float* vs = ks + Gm::F32_TILE;
        const float* kp = static_cast<const float*>(a.k_pool);
        const float* vp = static_cast<const float*>(a.v_pool);
        for (int i = tid; i < TILE * Gm::CH; i += NT) {
          const int r = i / Gm::CH, c = i % Gm::CH;
          const bool live = cache_live(p0 + r);
          const size_t at = live ? ((size_t)slot_of(p0 + r) * KV + h) * D + c * 4 : 0;
          cp_async16(ks + r * Gm::LDK + c * 4, kp + at, live);
          cp_async16(vs + r * Gm::LDK + c * 4, vp + at, live);
        }
      }
    }
    cp_async_commit();
  };

  const float* qrow0 = a.q + ((size_t)s * H + head0) * D;
  issue(0);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int p0 = tiles_s[t];
    float* kt;
    if constexpr (QUANT) {
      const int st = t % STAGES;
      const int8_t* kc = reinterpret_cast<const int8_t*>(ring + st * Gm::RAW_STAGE);
      const float* ksc = reinterpret_cast<const float*>(kc + 2 * TILE * D);
      kt = reinterpret_cast<float*>(ring + STAGES * Gm::RAW_STAGE);
      for (int i = tid; i < 2 * TILE * D; i += NT) {
        const int which = i / (TILE * D), j = i % (TILE * D);
        const int r = j / D, d = j % D;
        kt[which * Gm::F32_TILE + r * Gm::LDK + d] =
            __fmul_rn((float)kc[which * TILE * D + j], ksc[which * TILE + r]);
      }
      __syncthreads();  // the new column's row below overwrites a dequantized one
    } else {
      kt = reinterpret_cast<float*>(ring + (t % STAGES) * Gm::F32_STAGE);
    }
    float* vt = kt + Gm::F32_TILE;
    if (p0 == tn * TILE) {  // the new column's row, from shared memory
      const int r = newpos - p0;
      for (int i = tid; i < 2 * D; i += NT) (i < D ? kt : vt)[r * Gm::LDK + i % D] = new_s[i / D][i % D];
    }
    __syncthreads();

    // scores: a thread a (head, position); a warp one head
    for (int i = tid; i < Gc * TILE; i += NT) {
      const int g = i / TILE, p = i % TILE;
      const float4* qv = reinterpret_cast<const float4*>(qrow0 + (size_t)g * D);
      const float4* kv = reinterpret_cast<const float4*>(kt + p * Gm::LDK);
      float acc = 0.f;
#pragma unroll 8
      for (int d4 = 0; d4 < Gm::D4; ++d4) {
        const float4 x = __ldg(qv + d4), y = kv[d4];
        acc = fmaf(op(x.x), op(y.x), acc);
        acc = fmaf(op(x.y), op(y.y), acc);
        acc = fmaf(op(x.z), op(y.z), acc);
        acc = fmaf(op(x.w), op(y.w), acc);
      }
      p_s[g * TILE + p] = acc;
    }
    __syncthreads();

    // online softmax: a warp a head, a lane a position
    {
      const int pos = p0 + lane;
      const bool live = cache_live(pos) || (owner && pos == newpos);
      for (int g = warp; g < Gc; g += NW) {
        float x = p_s[g * TILE + lane] * a.scale + slope_s[g] * (float)pos;
        x = live ? x : -INFINITY;
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live column yet
        const float p = expf(x - m_use);
        const float sum = warp_sum(p);
        p_s[g * TILE + lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_old - m_use);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();

    // O = O * corr + P V: a thread four columns of one head
    for (int e = tid; e < Gc * Gm::D4; e += NT) {
      const int g = e / Gm::D4, d4 = e % Gm::D4;
      float4 o = reinterpret_cast<float4*>(o_s)[e];
      const float c = corr_s[g];
      o.x *= c;
      o.y *= c;
      o.z *= c;
      o.w *= c;
      const float* pr = p_s + g * TILE;
#pragma unroll 8
      for (int p = 0; p < TILE; ++p) {
        const float pv = op(pr[p]);
        const float4 v = reinterpret_cast<const float4*>(vt + p * Gm::LDK)[d4];
        o.x = fmaf(pv, op(v.x), o.x);
        o.y = fmaf(pv, op(v.y), o.y);
        o.z = fmaf(pv, op(v.z), o.z);
        o.w = fmaf(pv, op(v.w), o.w);
      }
      reinterpret_cast<float4*>(o_s)[e] = o;
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (owner && chunk == 0) {
    const int blk = min(max(slot / bs, 0), a.n_blocks - 1);
    const size_t dst = (((size_t)blk * bs + slot % bs) * KV + h) * D;
    if constexpr (QUANT) {
      for (int i = tid; i < 2 * D; i += NT)
        (i < D ? static_cast<int8_t*>(a.k_pool) : static_cast<int8_t*>(a.v_pool))[dst + i % D] =
            code_s[i / D][i % D];
      if (tid < 2) (tid ? a.v_scale : a.k_scale)[dst / D] = nsc_s[tid];
    } else {
      for (int i = tid; i < 2 * D; i += NT)
        (i < D ? static_cast<float*>(a.k_pool) : static_cast<float*>(a.v_pool))[dst + i % D] =
            new_s[i / D][i % D];
    }
  }
  __syncthreads();

  // the output itself, or the split's partial (an empty split: m = -inf and l = 0 only)
  if (direct) {
    float* out = a.out + ((size_t)s * H + head0) * D;
    for (int e = tid * 4; e < Gc * D; e += NT * 4) {
      const float L = l_s[e / D];
      const float4 o = *reinterpret_cast<const float4*>(o_s + e);
      *reinterpret_cast<float4*>(out + e) =
          L > 0.f ? make_float4(o.x / L, o.y / L, o.z / L, o.w / L)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  if (n_tiles > 0) {
    float* po = part_o(a, s, h, D) + ((size_t)split * G + g0) * D;
    for (int e = tid * 4; e < Gc * D; e += NT * 4)
      *reinterpret_cast<float4*>(po + e) = *reinterpret_cast<const float4*>(o_s + e);
  }
  float* pml = part_ml(a, s, h, D) + (size_t)split * 2 * G + g0;
  for (int g = tid; g < Gc; g += NT) {
    pml[g] = m_s[g];
    pml[G + g] = l_s[g];
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

template <int D, bool FUSED, bool QUANT>
int launch(const Args& a, int S, cudaStream_t stream) {
  const int smem = ring_bytes<D, QUANT>() + a.gmax * (D + TILE) * (int)sizeof(float) +
                   (a.tbl_cap + a.tile_cap) * (int)sizeof(int);
  static int attr_device = -1, attr_bytes = 0;  // the dynamic shared memory cap last set
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev || attr_bytes < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_f32_kernel<D, FUSED, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_device = dev;
    attr_bytes = smem;
  }
  decode_f32_kernel<D, FUSED, QUANT>
      <<<dim3(S * a.n_splits, a.n_kv * a.g_chunks), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_modes(bool fused, bool quant, const Args& a, int S, cudaStream_t stream) {
  if (fused && quant) return launch<D, true, true>(a, S, stream);
  if (fused) return launch<D, true, false>(a, S, stream);
  if (quant) return launch<D, false, true>(a, S, stream);
  return launch<D, false, false>(a, S, stream);
}

}  // namespace

// As paged_decode (paged_decode.cu) with f32 q, out, k_new, v_new and f32
// (or int8) pools; the arrival counters are [S * KV * ceil(G / 64)].
extern "C" int paged_decode_f32(void* out, const void* q, void* k_cache, void* v_cache,
                                void* k_scale, void* v_scale, const void* tables,
                                const void* ctx_lens, const void* k_new, const void* v_new,
                                const void* slots, const void* slopes, const void* allowed,
                                void* partials, void* counters, int fused, int quant, int S,
                                int H, int KV, int D, int n_blocks, int block_size,
                                int table_width, int window, int n_splits, int split_len,
                                float scale, void* stream) {
  if (S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || block_size <= 0 || table_width <= 0 || n_splits < 1 ||
      n_splits > MAX_SPLITS || split_len <= 0 || split_len % TILE != 0)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int g_chunks = (G + GCH - 1) / GCH;
  if ((long long)KV * g_chunks > 65535 || (long long)S * n_splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (fused && (k_new == nullptr || v_new == nullptr || slots == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_splits > 1 && (partials == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int span = table_width * block_size;
  Args a{(float*)out, (const float*)q, k_cache, v_cache, (float*)k_scale, (float*)v_scale,
         (const int32_t*)tables, (const int32_t*)ctx_lens, (const float*)k_new,
         (const float*)v_new, (const int32_t*)slots, (const float*)slopes,
         (const int32_t*)allowed, (float*)partials, (int*)counters, S, KV, G, n_blocks,
         block_size, table_width, window, fused != 0, n_splits, split_len, span, g_chunks,
         G < GCH ? G : GCH, split_len / block_size + 2, split_len / TILE + 2, scale};
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
