// Paged decode attention: one new query token per row against its paged
// KV context, in two modes built from one template.
//
//   FUSED = true   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//                  paged_decode_fused (_decode_fused_kernel): the cache
//                  holds positions < ctx-1, the new token's K/V enter as
//                  one extra softmax column from k_new/v_new, and the block
//                  writes its own head's slice of the new row into the
//                  row's flat slot.
//   FUSED = false  replaces paged_decode_attention (_decode_kernel) in its
//                  plain bf16 mode: attend over cache positions < ctx.
//
// Bound on the H100: bytes. A row with context c reads c * KV * D * 2
// bytes of K and as many of V and does 4 * c * H * D operations, far below
// the ~295 operations per byte where the tensor cores would bind. The
// design therefore reads every live K/V byte exactly once: the grid is
// (S, KV) and one block serves the G query heads of one KV head, so a K/V
// tile loaded into shared memory is used by the whole group. Tiles of
// TILE columns are staged with 16-byte vector loads and only columns
// below the live length are ever loaded or accumulated (an unwritten or
// stale slot may hold NaN, and 0 * NaN would poison the sum). The online
// softmax runs in f32.
//
// The TPU kernel padded G to 8 sublanes and required D % 128 == 0; both
// were TPU tiling artifacts and do not carry over. Pad rows (ctx <= 0)
// output zeros and write nothing. Every block id is clamped to the arena.
//
// Fused-mode ordering: a block writes the new row's slice for its own
// head only after its own loads, and no other block reads that slice (it
// is position ctx-1 of this row, outside every cache loop; rows are
// distinct sequences), so no cross-block ordering is needed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int TILE = 64;   // cache columns staged per pass
constexpr int MAX_G = 8;   // query heads per KV head

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

// blockDim.x == D: thread d owns output column d of every query head.
template <int D, bool FUSED>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    __nv_bfloat16* __restrict__ out,            // [S, H, D]
    const __nv_bfloat16* __restrict__ q,        // [S, H, D]
    __nv_bfloat16* __restrict__ k_cache,        // [NBLK, bs, KV, D]
    __nv_bfloat16* __restrict__ v_cache,        // [NBLK, bs, KV, D]
    const int32_t* __restrict__ tables,         // [S, NB]
    const int32_t* __restrict__ ctx_lens,       // [S]
    const __nv_bfloat16* __restrict__ k_new,    // [S, KV, D]   (FUSED)
    const __nv_bfloat16* __restrict__ v_new,    // [S, KV, D]   (FUSED)
    const int32_t* __restrict__ slots,          // [S]          (FUSED)
    int n_kv, int group, int n_blocks, int block_size, int table_width,
    float scale) {
  constexpr int NW = D / 32;    // warps
  constexpr int VPR = D / 8;    // 16-byte vectors per row
  constexpr int EPL = D / 32;   // elements per lane in a warp dot product

  __shared__ __align__(16) __nv_bfloat16 ks[TILE][D];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE][D];
  __shared__ float qs[MAX_G][D];
  __shared__ float ps[MAX_G][TILE];
  __shared__ float m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = n_kv * group;
  const int ctx = ctx_lens[s];
  __nv_bfloat16* o_row = out + ((size_t)s * H + (size_t)h * group) * D;

  if (ctx <= 0) {  // pad row
    for (int g = 0; g < group; ++g) o_row[(size_t)g * D + tid] = __float2bfloat16(0.f);
    return;
  }
  int limit = FUSED ? ctx - 1 : ctx;
  limit = min(limit, table_width * block_size);
  const int32_t* table = tables + (size_t)s * table_width;
  const size_t row_stride = (size_t)n_kv * D;  // elements between two slots

  for (int g = 0; g < group; ++g)
    qs[g][tid] = __bfloat162float(q[((size_t)s * H + (size_t)h * group + g) * D + tid]);
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < limit; c0 += TILE) {
    const int n = min(TILE, limit - c0);
    // stage K and V rows [c0, c0 + n) of head h
    for (int i = tid; i < n * VPR; i += D) {
      const int r = i / VPR;
      const int c = i % VPR;
      const int col = c0 + r;
      int blk = table[col / block_size];
      blk = min(max(blk, 0), n_blocks - 1);
      const size_t base = ((size_t)blk * block_size + col % block_size) * row_stride + (size_t)h * D;
      reinterpret_cast<uint4*>(&ks[r][0])[c] = reinterpret_cast<const uint4*>(k_cache + base)[c];
      reinterpret_cast<uint4*>(&vs[r][0])[c] = reinterpret_cast<const uint4*>(v_cache + base)[c];
    }
    __syncthreads();

    // scores: warp w takes columns w, w + NW, ...; lanes split D
    for (int r = warp; r < n; r += NW) {
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = __bfloat162float(ks[r][lane * EPL + e]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < group) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part += qs[g][lane * EPL + e] * kf[e];
          part = warp_sum(part);
          if (lane == 0) ps[g][r] = part * scale;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes heads w, w + NW, ...
    for (int g = warp; g < group; g += NW) {
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
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < group) {
        float a = acc[g] * corr_s[g];
        for (int r = 0; r < n; ++r) a += ps[g][r] * __bfloat162float(vs[r][tid]);
        acc[g] = a;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

  if (FUSED) {
    const int slot = slots[s];
    if (slot >= 0) {
      const __nv_bfloat16* kn = k_new + ((size_t)s * n_kv + h) * D;
      const __nv_bfloat16* vn = v_new + ((size_t)s * n_kv + h) * D;
      for (int g = warp; g < group; g += NW) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          part += qs[g][lane * EPL + e] * __bfloat162float(kn[lane * EPL + e]);
        part = warp_sum(part);
        if (lane == 0) {
          const float sc = part * scale;
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
      const float vd = __bfloat162float(vn[tid]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < group) acc[g] = acc[g] * corr_s[g] + ps[g][0] * vd;
      // the new row's slice of head h goes to its slot, after this
      // block's own loads
      int blk = slot / block_size;
      blk = min(max(blk, 0), n_blocks - 1);
      const size_t dst = ((size_t)blk * block_size + slot % block_size) * row_stride + (size_t)h * D + tid;
      k_cache[dst] = kn[tid];
      v_cache[dst] = vn[tid];
    }
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < group) {
      const float l = l_s[g];
      o_row[(size_t)g * D + tid] = __float2bfloat16(l > 0.f ? acc[g] / l : 0.f);
    }
  }
}

template <int D>
int launch(bool fused, void* out, const void* q, void* k_cache, void* v_cache,
           const void* tables, const void* ctx_lens, const void* k_new,
           const void* v_new, const void* slots, int S, int n_kv, int group,
           int n_blocks, int block_size, int table_width, float scale,
           cudaStream_t stream) {
  dim3 grid(S, n_kv);
  if (fused) {
    paged_decode_kernel<D, true><<<grid, D, 0, stream>>>(
        (__nv_bfloat16*)out, (const __nv_bfloat16*)q, (__nv_bfloat16*)k_cache,
        (__nv_bfloat16*)v_cache, (const int32_t*)tables, (const int32_t*)ctx_lens,
        (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
        (const int32_t*)slots, n_kv, group, n_blocks, block_size, table_width, scale);
  } else {
    paged_decode_kernel<D, false><<<grid, D, 0, stream>>>(
        (__nv_bfloat16*)out, (const __nv_bfloat16*)q, (__nv_bfloat16*)k_cache,
        (__nv_bfloat16*)v_cache, (const int32_t*)tables, (const int32_t*)ctx_lens,
        nullptr, nullptr, nullptr, n_kv, group, n_blocks, block_size, table_width, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode(void* out, const void* q, void* k_cache, void* v_cache,
                            const void* tables, const void* ctx_lens,
                            const void* k_new, const void* v_new, const void* slots,
                            int fused, int S, int H, int KV, int D, int n_blocks,
                            int block_size, int table_width, float scale,
                            void* stream) {
  if (S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_G) return (int)cudaErrorInvalidValue;
  const int group = H / KV;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(fused != 0, out, q, k_cache, v_cache, tables, ctx_lens, k_new,
                        v_new, slots, S, KV, group, n_blocks, block_size, table_width,
                        scale, st);
    case 128:
      return launch<128>(fused != 0, out, q, k_cache, v_cache, tables, ctx_lens, k_new,
                         v_new, slots, S, KV, group, n_blocks, block_size, table_width,
                         scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
