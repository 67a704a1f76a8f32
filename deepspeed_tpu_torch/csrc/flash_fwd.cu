// Causal flash-attention forward (FlashAttention-2 online softmax) over
// q [B, S, H, D] and k, v [B, S, KV, D] in bf16, writing o [B, S, H, D]
// in bf16 and the row logsumexp lse [B, H, S] in f32 (kept for the
// backward, csrc/flash_bwd.cu).
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py _flash_fwd
// (_fwd_kernel), the prefill attention of the serving path and the
// forward of the training path, in its causal, sliding-window and ALiBi
// modes.
//
// Sliding window (window > 0, Mistral-class): query row r attends to key
// column c iff r - window < c <= r. The K-tile loop starts at the first
// tile the band of the q tile's first row needs, max(q0 - window + 1, 0)
// / BK (the TPU kernel's _win_jbase), so the work scales with the window,
// not with S; inside a tile the columns left of a row's band are masked.
// A row can find a whole tile outside its band (the tile the q tile's
// first row needs lies left of a later row's band); its running max stays
// -inf there, and the guard on m_new keeps p = 0 and corr = 1. window <= 0
// is plain causal attention, and any window >= S visits the same tiles and
// masks the same columns, so its result is bit-identical to window = 0.
//
// ALiBi (slopes != null, Bloom-class): the score of row r and column c
// gains slopes[h] * (c - r) in f32 after the 1/sqrt(D) scale and before
// the mask, as the TPU kernel adds it (it read the slope of q head h from
// SMEM; here one f32 load per block). h is the q head the block serves, so
// with GQA the slope is that of head kv * G + g, never of the KV head. The
// bias is one multiply-add per score; ALiBi and the window are independent
// runtime arguments, so one binary serves causal, window, ALiBi and both.
// slopes == null adds nothing: the causal and window results are unchanged
// bit for bit.
//
// Bound on the H100: at prefill lengths of a few hundred tokens and
// D = 128 the work is 4 * S^2 / 2 * D operations per head against
// 4 * S * D * 2 bytes, i.e. about S / 4 operations per byte: operations
// bind above S of roughly 1200, bytes below. The design keeps S x S
// scores out of device memory entirely: a 64 x D query tile stays in
// shared memory while 64-column K/V tiles stream past it up to the
// diagonal (tiles above it are never loaded), products run on the
// tensor cores through WMMA (bf16 in, f32 accumulate), and the running
// max, sum and output live in f32. This is the simple correct first
// version: WMMA instead of wgmma and synchronous tile loads instead of
// TMA pipelines are left for a later PR.
//
// Grid (B * H, ceil(S / 64)), 4 warps; warp w owns query rows 16w..16w+15
// of the tile. GQA: query head h reads KV head h / (H / KV), for any whole
// group (Falcon-7B: 71 query heads over one KV head); K/V are never
// repeated in memory.
//
// Head dims 64, 80 (Phi-2) and 128. The WMMA 16 x 16 x 16 tiles divide
// each (80: five steps of the Q K^T depth loop, five output column tiles);
// Layout<80> keeps 16-byte row strides (LDH 88 bf16, LDO 84 f32) and
// 32-byte-aligned regions and fragment pointers, a row is ten 16-byte
// vectors, and the per-lane loops over D stride by 32 with a bound, so
// none assumes D % 32 == 0. The TPU kernel's grid ran its k axis in order with
// the accumulators in VMEM scratch; here that axis is the loop inside the
// block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <math.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key columns per tile
constexpr int NT = 128;  // threads per block (4 warps)

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

// Shared-memory layout. Row strides are padded against bank conflicts and
// kept multiples of 16 bytes; every region starts 32-byte aligned, as
// WMMA loads and stores require.
template <int D>
struct Layout {
  static_assert(D % 16 == 0, "WMMA tiles are 16 wide");
  static constexpr int LDH = D + 8;   // bf16 stride of the Q, K and V tiles
  static constexpr int LDS = BK + 4;  // f32 stride of the score tile
  static constexpr int LDP = BK + 8;  // bf16 stride of the probability tile
  static constexpr int LDO = D + 4;   // f32 stride of the output accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)BQ * LDH * 2;
  static constexpr size_t V = K + (size_t)BK * LDH * 2;
  static constexpr size_t SC = V + (size_t)BK * LDH * 2;
  static constexpr size_t P = SC + (size_t)BQ * LDS * 4;
  static constexpr size_t O = P + (size_t)BQ * LDP * 2;
  static constexpr size_t M = O + (size_t)BQ * LDO * 4;
  static constexpr size_t L = M + (size_t)BQ * 4;
  static constexpr size_t BYTES = L + (size_t)BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ slopes, int S, int H,
    int KV, int window, float scale) {
  using Lay = Layout<D>;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::K);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::V);
  float* ss = reinterpret_cast<float*>(smem + Lay::SC);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  float* os = reinterpret_cast<float*>(smem + Lay::O);
  float* m_s = reinterpret_cast<float*>(smem + Lay::M);
  float* l_s = reinterpret_cast<float*>(smem + Lay::L);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const bool alibi = slopes != nullptr;
  const float slope = alibi ? slopes[h] : 0.f;  // of the q head, not the KV head
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t q_row = (size_t)H * D;    // elements between two positions of q / o
  const size_t kv_row = (size_t)KV * D;  // of k / v
  const __nv_bfloat16* qb = q + (size_t)b * S * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * VPR; i += NT) {
    const int r = i / VPR;
    const int c = i % VPR;
    uint4 val = zero;
    if (q0 + r < S) val = reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_row)[c];
    reinterpret_cast<uint4*>(qs + r * Lay::LDH)[c] = val;
  }
  for (int i = tid; i < BQ * D; i += NT) os[(i / D) * Lay::LDO + i % D] = 0.f;
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int r0 = warp * 16;
  // causal: tiles up to the one holding this q tile's last row; window:
  // from the one holding its first row's first live column
  const int n_tiles = min((q0 + BQ - 1) / BK + 1, (S + BK - 1) / BK);
  const int j0 = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  for (int j = j0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Q/O init visible; the previous tile's K/V reads done
    for (int i = tid; i < BK * VPR; i += NT) {
      const int r = i / VPR;
      const int c = i % VPR;
      uint4 kv4 = zero, vv4 = zero;  // columns past S load as zeros
      if (k0 + r < S) {
        kv4 = reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_row)[c];
        vv4 = reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_row)[c];
      }
      reinterpret_cast<uint4*>(ks + r * Lay::LDH)[c] = kv4;
      reinterpret_cast<uint4*>(vs + r * Lay::LDH)[c] = vv4;
    }
    __syncthreads();

    // S_w = Q_w K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + r0 * Lay::LDH + kk, Lay::LDH);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, ks + (n * 16) * Lay::LDH + kk, Lay::LDH);
          wmma::mma_sync(sacc[n], a, bt, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(ss + r0 * Lay::LDS + n * 16, sacc[n], Lay::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's rows; lane owns columns lane, lane+32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int row = q0 + r;
      const float* srow = ss + r * Lay::LDS;
      const int c_a = k0 + lane;
      const int c_b = k0 + lane + 32;
      float x_a = srow[lane] * scale;
      float x_b = srow[lane + 32] * scale;
      if (alibi) {  // slope * (col - row): added before the mask, as the TPU kernel does
        x_a += slope * (float)(c_a - row);
        x_b += slope * (float)(c_b - row);
      }
      const bool banded = window > 0;
      if (c_a > row || c_a >= S || (banded && c_a <= row - window)) x_a = -INFINITY;
      if (c_b > row || c_b >= S || (banded && c_b <= row - window)) x_b = -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x_a, x_b)));
      float p_a = 0.f, p_b = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {
        p_a = expf(x_a - m_new);
        p_b = expf(x_b - m_new);
        corr = expf(m_old - m_new);
      }
      const float sum = warp_sum(p_a + p_b);
      ps[r * Lay::LDP + lane] = __float2bfloat16(p_a);
      ps[r * Lay::LDP + lane + 32] = __float2bfloat16(p_b);
      for (int d = lane; d < D; d += 32) os[r * Lay::LDO + d] *= corr;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncwarp();

    // O_w += P_w V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, os + r0 * Lay::LDO + n * 16, Lay::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + r0 * Lay::LDP + kk, Lay::LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, vs + kk * Lay::LDH + n * 16, Lay::LDH);
        wmma::mma_sync(oacc, a, bv, oacc);
      }
      wmma::store_matrix_sync(os + r0 * Lay::LDO + n * 16, oacc, Lay::LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int row = q0 + r;
    if (row >= S) break;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = o + ((size_t)b * S + row) * q_row + (size_t)h * D;
    for (int d = lane; d < D; d += 32) orow[d] = __float2bfloat16(os[r * Lay::LDO + d] * inv);
    if (lane == 0) lse[((size_t)b * H + h) * S + row] = m_s[r] + logf(l > 0.f ? l : 1.f);
  }
}

template <int D>
int launch(void* o, void* lse, const void* q, const void* k, const void* v,
           const void* slopes, int B, int S, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      (__nv_bfloat16*)o, (float*)lse, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)slopes, S, H, KV, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// slopes: [H] f32 ALiBi slopes, or null for none
extern "C" int flash_fwd(void* o, void* lse, const void* q, const void* k, const void* v,
                         const void* slopes, int B, int S, int H, int KV, int D, int window,
                         float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (window > S) window = S;  // the same band, and no overflow in the tile bounds
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch<64>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 80:
      return launch<80>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 128:
      return launch<128>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
