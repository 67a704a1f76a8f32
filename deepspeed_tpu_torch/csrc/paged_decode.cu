// Paged decode attention: one new query token per row against its paged
// KV context, in four modes built from one template.
//
//   FUSED = true   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//                  paged_decode_fused (_decode_fused_kernel): the cache
//                  holds positions < ctx-1, the new token's K/V enter as
//                  one extra softmax column from k_new/v_new, and the block
//                  writes its own head's slice of the new row into the
//                  row's flat slot. The same template serves the bf16
//                  fused mode of paged_decode_attention (_decode_kernel
//                  with k_new), which the JAX package takes where
//                  paged_decode_fused's D % 128 == 0 does not hold
//                  (head_dim 64 or 80: supports_fused_v2).
//   FUSED = false  replaces paged_decode_attention (_decode_kernel) in its
//                  plain bf16 mode: attend over cache positions < ctx.
//   QUANT = true   the int8 modes of paged_decode_attention
//                  (_decode_kernel with quant=True, plain and fused): the
//                  pools hold int8 codes with one f32 scale per (slot, KV
//                  head) in [NBLK, bs, KV] scale pools. Each tile's codes
//                  are staged with 16-byte loads (16 codes each) and
//                  dequantized into the same bf16 shared tiles as
//                  bf16(code * scale), q's dtype as in the TPU kernel, so
//                  the score, softmax and P.V code is the bf16 code. The
//                  tile's scales for head h are staged once per tile.
//                  Fused, warp 0 of the block of KV head h quantizes that
//                  head's slice of k_new and warp 1 of v_new with
//                  kv_quant.cuh (_quant_row_kernel of the TPU kernel; codes
//                  and scales bit-identical to quantize_kv_rows), writes
//                  the codes and the scale to the slot, and the new column
//                  uses the dequantized value, as every later read will.
//
// Bound on the H100: bytes. A row with context c reads c * KV * D * 2
// bytes of K and as many of V (c * KV * (D + 4) * 2 with int8 codes and
// their scales) and does 4 * c * H * D operations, far below the ~295
// operations per byte where the tensor cores would bind. The design
// therefore reads every live K/V byte once per block: the grid is (S, KV,
// chunks) and one block serves up to 8 query heads of one KV head, so a
// K/V tile loaded into shared memory is used by each of them (a group of
// at most 8, every model before Falcon-7B, reads each byte exactly once;
// below, wider groups). Tiles of TILE
// columns are staged with 16-byte vector loads and only columns below the
// live length are ever loaded or accumulated (an unwritten or stale slot
// may hold NaN, and 0 * NaN would poison the sum). The online softmax
// runs in f32.
//
// Sliding window (window > 0, every mode): a row attends to context
// positions ctx - window <= c < ctx (ctx counts the new token). The column
// loop starts at max(ctx - window, 0) instead of 0, exact to the token (a
// tile may start mid-block: slot_of maps any column), so no position left
// of the window is loaded or masked, and the bytes read are those of
// min(ctx, window) positions (the TPU kernel's _win_jbase_decode grid and
// `cols >= ctx - window` mask). The fused mode's new column, ctx - 1, is
// always inside. window <= 0, or window >= ctx, starts at 0: the result is
// bit-identical to the causal one.
//
// ALiBi (slopes != null, every mode, Bloom-class): the score of q head
// h * group + g at context position c gains slopes[h * group + g] * c, in
// f32 after the 1/sqrt(D) scale, with c the ABSOLUTE key position. That is
// the form of the TPU kernel (`ab_ref * cols`) and of
// paged_decode_attention_xla: for one query at position ctx - 1 it equals
// slope * (c - (ctx - 1)) under softmax, but at ctx ~ 2,000 the bias is
// ~1,700, where an f32 ulp is 1.2e-4, so the two forms round differently
// and the kernel keeps the reference's. The fused mode's new column is at
// position ctx - 1. The block's group of slopes is staged in shared memory
// once; null slopes add nothing (the other modes are unchanged bit for
// bit). ALiBi and the window are independent runtime arguments.
//
// Block-sparse layout (allowed != null, every mode): allowed is [S,
// table_width] int32, row-major, one entry per table slot (cache block),
// the layout row of the row's query position at cache-block granularity
// (the TPU kernels' allowed_slots scalar prefetch). Context column c of
// row s is attended only when allowed[s * table_width + c / block_size]
// != 0. The column loop walks runs of allowed blocks: at the loop head c0
// jumps to the start of the next allowed block, and the tile's length n
// is capped at the end of the current run of allowed blocks as well as at
// TILE and the live limit. So no byte of a disallowed block is loaded
// (its K and V rows, and on int8 pools its scales), no value from one
// reaches a sum (a stale slot may hold NaN), full tiles run over
// contiguous allowed blocks (the local window), and a hole costs one
// bitmap read per block. With block_size < TILE (16 and 32 are legal
// cache blocks) a tile spans several blocks and is cut at the first
// disallowed one; at block_size 128 a tile never straddles two blocks.
// The fused modes' new column (position ctx - 1) is attended whatever the
// bitmap says, as in both TPU kernels (_decode_kernel's final-step
// column, _decode_fused_kernel's newcol); layouts always allow their
// diagonal, so in serving this changes nothing. A row with no allowed
// live column outputs zeros (l = 0), as the TPU kernels' l_safe does.
// The bitmap, the window and the slopes are independent runtime
// arguments. Null (dense) walks the same tiles as before, and so does an
// all-ones bitmap: both are the dense result bit for bit. Bound: bytes,
// those of the allowed live positions only.
//
// Query groups of any size (Falcon-7B: 71 query heads over one KV head):
// the grid is (S, KV, ceil(G / 8)) and block (s, h, c) serves query heads
// 8c .. min(8c + 8, G) - 1 of KV head h's group, so a wide group spreads
// over many blocks (Falcon-7B at 8 rows: 72 blocks, not 8) while each
// block keeps the <= 8 heads' q rows, probabilities and accumulators of
// the G <= 8 design; the last chunk may be partial (71 = 8 x 8 + 7).
// Every chunk of a KV head reads the same K/V tiles (the second and later
// reads mostly from L2). The TPU kernel padded G to 8 sublanes (Gp =
// max(G, 8)) and read K/V once for the whole padded group. Fused modes:
// every chunk attends the new column from k_new/v_new, and chunk 0 alone
// stores the new row; on int8 pools every chunk runs the same
// deterministic quantizer, so all use the value chunk 0 stores.
//
// Head dims 64, 80 and 128 (Phi-2 has 80): the block has D threads
// rounded up to whole warps (96 at D = 80), thread d < D owns output
// column d, and the idle lanes of the last warp join every barrier and
// full-mask shuffle but own no column. A warp's dot product over D gives
// lane l the EPL = ceil(D / 32) neighbouring elements l * EPL .. (3 at
// D = 80: lanes 27-31 hold none), and the quantizer pads a lane's missing
// elements with zeros, which leave amax unchanged and are never stored.
// A row is 160 bytes in bf16 and 80 in int8 at D = 80, so 16-byte loads
// still divide it. At D 64 and 128 with a group of at most 8 the loops,
// and so the results, are those of the kernel before these two modes.
//
// The TPU kernel's D % 128 == 0 requirement was a TPU tiling artifact and
// does not carry over. Pad rows (ctx <= 0) output zeros and write nothing.
// Every block id is clamped to the arena.
//
// Fused-mode ordering: chunk 0 writes the new row's slice for its own
// head only after its own loads, and no block reads that slice (it is
// position ctx-1 of this row, outside every cache loop; rows are distinct
// sequences), so no cross-block ordering is needed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <math.h>
#include <type_traits>

#include "kv_quant.cuh"

namespace {

constexpr int TILE = 64;  // cache columns staged per pass
constexpr int GC = 8;     // query heads per block: one chunk of a KV head's group

// threads per block: D rounded up to whole warps
__host__ __device__ constexpr int threads_for(int D) { return (D + 31) / 32 * 32; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float dequant(int8_t code, float scale) {
  return __bfloat162float(__float2bfloat16_rn((float)code * scale));
}

// 16 int8 codes -> 16 bf16(code * scale) at dst (16-byte aligned)
__device__ __forceinline__ void dequant16(uint4 codes, float scale, __nv_bfloat16* dst) {
  const uint32_t in[4] = {codes.x, codes.y, codes.z, codes.w};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = in[i / 2] >> (16 * (i % 2));
    const __nv_bfloat162 p = __floats2bfloat162_rn((float)(int8_t)(word & 0xffu) * scale,
                                                   (float)(int8_t)(word >> 8) * scale);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// blockDim.x == threads_for(D): thread d < D owns output column d of every
// query head of the block's chunk; grid (S, KV, ceil(group / GC)).
template <int D, bool FUSED, bool QUANT>
__global__ void __launch_bounds__((D + 31) / 32 * 32) paged_decode_kernel(
    __nv_bfloat16* __restrict__ out,            // [S, H, D]
    const __nv_bfloat16* __restrict__ q,        // [S, H, D]
    void* __restrict__ k_pool,                  // [NBLK, bs, KV, D] bf16 or int8
    void* __restrict__ v_pool,                  // [NBLK, bs, KV, D] bf16 or int8
    float* __restrict__ k_scale,                // [NBLK, bs, KV]   (QUANT)
    float* __restrict__ v_scale,                // [NBLK, bs, KV]   (QUANT)
    const int32_t* __restrict__ tables,         // [S, NB]
    const int32_t* __restrict__ ctx_lens,       // [S]
    const __nv_bfloat16* __restrict__ k_new,    // [S, KV, D]   (FUSED)
    const __nv_bfloat16* __restrict__ v_new,    // [S, KV, D]   (FUSED)
    const int32_t* __restrict__ slots,          // [S]          (FUSED)
    const float* __restrict__ slopes,           // [H] ALiBi slopes, or null
    const int32_t* __restrict__ allowed,        // [S, NB] layout bitmap, or null
    int n_kv, int group, int n_blocks, int block_size, int table_width, int window,
    float scale) {
  using CacheT = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;
  CacheT* k_cache = static_cast<CacheT*>(k_pool);
  CacheT* v_cache = static_cast<CacheT*>(v_pool);
  constexpr int NT = threads_for(D);
  constexpr int NW = NT / 32;                        // warps
  constexpr int VPR = D * sizeof(CacheT) / 16;       // 16-byte vectors per cache row
  constexpr int EPL = (D + 31) / 32;  // elements per lane in a warp dot product
  static_assert(D * sizeof(CacheT) % 16 == 0, "a cache row must be whole 16-byte vectors");
  // element e of lane l is column l * EPL + e; it exists when that is < D
  auto in_row = [](int d) { return D % 32 == 0 || d < D; };

  __shared__ __align__(16) __nv_bfloat16 ks[TILE][D];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE][D];
  __shared__ float qs[GC][D];
  __shared__ float ps[GC][TILE];
  __shared__ float m_s[GC], l_s[GC], corr_s[GC];
  __shared__ float slope_s[GC];  // ALiBi slope of each query head of the chunk
  __shared__ float ksc[QUANT ? TILE : 1], vsc[QUANT ? TILE : 1];  // the tile's scales
  __shared__ float kn_s[QUANT ? D : 1], vn_s[QUANT ? D : 1];      // dequantized new row

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int chunk = blockIdx.z;
  const int gc = min(GC, group - chunk * GC);  // query heads of this block
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool col = tid < D;  // this thread owns output column tid
  const int H = n_kv * group;
  const int head0 = h * group + chunk * GC;  // the block's first query head
  const int ctx = ctx_lens[s];
  __nv_bfloat16* o_row = out + ((size_t)s * H + head0) * D;

  if (ctx <= 0) {  // pad row
    if (col)
      for (int g = 0; g < gc; ++g) o_row[(size_t)g * D + tid] = __float2bfloat16(0.f);
    return;
  }
  int limit = FUSED ? ctx - 1 : ctx;
  limit = min(limit, table_width * block_size);
  const int32_t* table = tables + (size_t)s * table_width;
  const size_t row_stride = (size_t)n_kv * D;  // elements between two slots
  auto slot_of = [&](int c) {  // flat arena slot of context position c
    int blk = table[c / block_size];
    blk = min(max(blk, 0), n_blocks - 1);
    return (size_t)blk * block_size + c % block_size;
  };

  if (col)
    for (int g = 0; g < gc; ++g)
      qs[g][tid] = __bfloat162float(q[((size_t)s * H + head0 + g) * D + tid]);
  const bool alibi = slopes != nullptr;
  if (tid < gc) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    slope_s[tid] = alibi ? slopes[head0 + tid] : 0.f;
  }
  float acc[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) acc[g] = 0.f;
  __syncthreads();

  const int start = window > 0 ? max(ctx - window, 0) : 0;  // the window's first column
  const int32_t* allow = allowed ? allowed + (size_t)s * table_width : nullptr;
  // Every thread reads the same bitmap entries of one row, so c0 and n are
  // uniform over the thread block and the __syncthreads() below are
  // reached by all threads or by none.
  for (int c0 = start;;) {
    if (allow) {  // to the start of the next allowed block
      while (c0 < limit && allow[c0 / block_size] == 0) c0 = (c0 / block_size + 1) * block_size;
    }
    if (c0 >= limit) break;
    int end = min(c0 + TILE, limit);
    if (allow) {  // cut the tile at the end of the run of allowed blocks
      int b = c0 / block_size + 1;
      while (b * block_size < end && allow[b] != 0) ++b;
      end = min(end, b * block_size);
    }
    const int n = end - c0;
    if constexpr (QUANT) {
      for (int r = tid; r < n; r += NT) {
        const size_t at = slot_of(c0 + r) * n_kv + h;
        ksc[r] = k_scale[at];
        vsc[r] = v_scale[at];
      }
      __syncthreads();
    }
    // stage K and V rows [c0, c0 + n) of head h
    for (int i = tid; i < n * VPR; i += NT) {
      const int r = i / VPR;
      const int c = i % VPR;
      const size_t base = slot_of(c0 + r) * row_stride + (size_t)h * D;
      const uint4 kv = reinterpret_cast<const uint4*>(k_cache + base)[c];
      const uint4 vv = reinterpret_cast<const uint4*>(v_cache + base)[c];
      if constexpr (QUANT) {
        dequant16(kv, ksc[r], &ks[r][c * 16]);
        dequant16(vv, vsc[r], &vs[r][c * 16]);
      } else {
        reinterpret_cast<uint4*>(&ks[r][0])[c] = kv;
        reinterpret_cast<uint4*>(&vs[r][0])[c] = vv;
      }
    }
    __syncthreads();

    // scores: warp w takes columns w, w + NW, ...; lanes split D
    for (int r = warp; r < n; r += NW) {
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane * EPL + e;
        kf[e] = in_row(d) ? __bfloat162float(ks[r][d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < gc) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int d = lane * EPL + e;
            if (in_row(d)) part += qs[g][d] * kf[e];
          }
          part = warp_sum(part);
          if (lane == 0) {
            float sc = part * scale;
            if (alibi) sc += slope_s[g] * (float)(c0 + r);  // absolute key position
            ps[g][r] = sc;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + NW, ...
    for (int g = warp; g < gc; g += NW) {
      float mx = -INFINITY;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, ps[g][r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float p = expf(ps[g][r] - m_new);
        ps[g][r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P V: thread tid owns column tid; only the n live columns are read
    if (col) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g < gc) {
          float a = acc[g] * corr_s[g];
          for (int r = 0; r < n; ++r) a += ps[g][r] * __bfloat162float(vs[r][tid]);
          acc[g] = a;
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
    c0 = end;
  }

  if (FUSED) {
    const int slot = slots[s];
    if (slot >= 0) {
      const __nv_bfloat16* kn = k_new + ((size_t)s * n_kv + h) * D;
      const __nv_bfloat16* vn = v_new + ((size_t)s * n_kv + h) * D;
      int blk = slot / block_size;
      blk = min(max(blk, 0), n_blocks - 1);
      const size_t dst_slot = (size_t)blk * block_size + slot % block_size;
      const size_t dst = dst_slot * row_stride + (size_t)h * D;
      const bool writer = chunk == 0;  // one chunk stores the new row
      if constexpr (QUANT) {
        // the new row's slice of head h: warp 0 quantizes K, warp 1 V, in
        // every chunk (the same deterministic codes); chunk 0 writes codes
        // and scale to the slot (after this block's own loads), and every
        // chunk keeps the dequantized value for the column below
        if (warp < 2) {
          const __nv_bfloat16* src = warp ? vn : kn;
          float x[EPL];
          int8_t code[EPL];
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int d = lane * EPL + e;
            x[e] = in_row(d) ? __bfloat162float(src[d]) : 0.f;  // zeros leave amax as it is
          }
          const float sc = kv_quant_slice<EPL>(x, code);
          int8_t* codes = (warp ? v_cache : k_cache) + dst;
          float* deq = warp ? vn_s : kn_s;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int d = lane * EPL + e;
            if (in_row(d)) {
              if (writer) codes[d] = code[e];
              deq[d] = dequant(code[e], sc);
            }
          }
          if (writer && lane == 0) (warp ? v_scale : k_scale)[dst_slot * n_kv + h] = sc;
        }
        __syncthreads();
      }
      for (int g = warp; g < gc; g += NW) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane * EPL + e;
          if (in_row(d)) part += qs[g][d] * (QUANT ? kn_s[d] : __bfloat162float(kn[d]));
        }
        part = warp_sum(part);
        if (lane == 0) {
          float sc = part * scale;
          if (alibi) sc += slope_s[g] * (float)(ctx - 1);  // the new token's position
          const float m_old = m_s[g];
          const float m_new = fmaxf(m_old, sc);
          const float corr = expf(m_old - m_new);
          const float p = expf(sc - m_new);
          corr_s[g] = corr;
          ps[g][0] = p;
          l_s[g] = l_s[g] * corr + p;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      if (col) {
        const float vd = QUANT ? vn_s[tid] : __bfloat162float(vn[tid]);
#pragma unroll
        for (int g = 0; g < GC; ++g)
          if (g < gc) acc[g] = acc[g] * corr_s[g] + ps[g][0] * vd;
        if constexpr (!QUANT) {
          // the new row's slice of head h goes to its slot, after this
          // block's own loads
          if (writer) {
            k_cache[dst + tid] = kn[tid];
            v_cache[dst + tid] = vn[tid];
          }
        }
      }
    }
  }

  if (col) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < gc) {
        const float l = l_s[g];
        o_row[(size_t)g * D + tid] = __float2bfloat16(l > 0.f ? acc[g] / l : 0.f);
      }
    }
  }
}

struct DecodeArgs {
  void *out, *k_pool, *v_pool, *k_scale, *v_scale;
  const void *q, *tables, *ctx_lens, *k_new, *v_new, *slots, *slopes, *allowed;
  int S, n_kv, group, n_blocks, block_size, table_width, window;
  float scale;
};

template <int D, bool FUSED, bool QUANT>
void launch(const DecodeArgs& a, cudaStream_t stream) {
  dim3 grid(a.S, a.n_kv, (a.group + GC - 1) / GC);
  paged_decode_kernel<D, FUSED, QUANT><<<grid, threads_for(D), 0, stream>>>(
      (__nv_bfloat16*)a.out, (const __nv_bfloat16*)a.q, a.k_pool, a.v_pool,
      (float*)a.k_scale, (float*)a.v_scale, (const int32_t*)a.tables,
      (const int32_t*)a.ctx_lens, (const __nv_bfloat16*)a.k_new,
      (const __nv_bfloat16*)a.v_new, (const int32_t*)a.slots, (const float*)a.slopes,
      (const int32_t*)a.allowed, a.n_kv, a.group, a.n_blocks, a.block_size, a.table_width,
      a.window, a.scale);
}

template <int D>
int launch_modes(bool fused, bool quant, const DecodeArgs& a, cudaStream_t stream) {
  if (fused && quant) launch<D, true, true>(a, stream);
  else if (fused) launch<D, true, false>(a, stream);
  else if (quant) launch<D, false, true>(a, stream);
  else launch<D, false, false>(a, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode(void* out, const void* q, void* k_cache, void* v_cache,
                            void* k_scale, void* v_scale, const void* tables,
                            const void* ctx_lens, const void* k_new, const void* v_new,
                            const void* slots, const void* slopes, const void* allowed,
                            int fused, int quant, int S, int H, int KV, int D, int n_blocks,
                            int block_size, int table_width, int window, float scale,
                            void* stream) {
  if (S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > 65535 * GC) return (int)cudaErrorInvalidValue;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (fused && (k_new == nullptr || v_new == nullptr || slots == nullptr))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{out, k_cache, v_cache, k_scale, v_scale, q, tables, ctx_lens,
                     k_new, v_new, slots, slopes, allowed, S, KV, H / KV, n_blocks,
                     block_size, table_width, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_modes<64>(fused != 0, quant != 0, a, st);
    case 80:
      return launch_modes<80>(fused != 0, quant != 0, a, st);
    case 128:
      return launch_modes<128>(fused != 0, quant != 0, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
