// Causal flash-attention backward (recompute from the saved logsumexp) over
// q, do [B, S, H, D] and k, v [B, S, KV, D] in bf16 with lse and
// delta = rowsum(dO * O) as [B, H, S] f32. Two kernels:
//
//   flash_bwd_dq   dq [B, S, H, D] bf16
//   flash_bwd_dkv  dk, dv [B, S, KV, D] bf16 (GQA: summed over the group)
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py _flash_bwd, i.e.
// _bwd_dq_kernel (the pallas_call at :438) and _bwd_dkv_kernel (:467),
// which the training step runs once per layer.
//
// Bound on the H100: at the training shape (S = 2048, D = 128) dq does
// three S x S x D products per head under the causal mask and dkv four,
// against about 2 S D bytes per operand: hundreds of operations per byte,
// so both are bound by the tensor cores, not by memory. The design keeps
// every S x S quantity (scores, P, dP, dS) out of device memory: 64-row
// tiles are staged in shared memory, products run on the tensor cores
// through WMMA (bf16 in, f32 accumulate), and the dq / dk / dv sums live
// in WMMA accumulator fragments (registers) for the whole block. P and dS
// are rounded to bf16 before their products, as the TPU kernel does.
// Simple and correct first: WMMA instead of wgmma and synchronous tile
// loads instead of TMA pipelines are left for a later PR.
//
// Grids. dq: (B * H, ceil(S / 64)); the block owns 64 query rows and
// loops over the K/V tiles up to the diagonal. dkv: (B * KV, ceil(S / 64));
// the block owns 64 key rows and loops over the G = H / KV query heads of
// its group and over the query tiles from the diagonal to the end. The
// TPU ran those two loops as sequential grid axes with VMEM accumulators;
// here they are loops inside one block, so the GQA sum needs no atomics
// and the result is the same from run to run. 4 warps; warp w owns rows
// 16w..16w+15 of the block's tile, so the element-wise passes need only
// warp-level synchronisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <math.h>

namespace {

using namespace nvcuda;

constexpr int BT = 64;   // rows of every tile (query and key tiles alike)
constexpr int NT = 128;  // threads per block (4 warps)

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared-memory layout, the same for both kernels. Row strides are padded
// against bank conflicts and kept multiples of 16 bytes; every region
// starts 32-byte aligned, as WMMA loads and stores require.
template <int D>
struct Layout {
  static constexpr int LDH = D + 8;   // bf16 stride of the 64 x D tiles
  static constexpr int LDS = BT + 4;  // f32 stride of the 64 x 64 score tiles
  static constexpr int LDP = BT + 8;  // bf16 stride of the 64 x 64 P / dS tile
  static constexpr int LDO = D + 4;   // f32 stride of the output staging tile
  static constexpr size_t TILE = (size_t)BT * LDH * 2;
  static constexpr size_t T0 = 0;            // dq: Q   | dkv: K
  static constexpr size_t T1 = T0 + TILE;    // dq: dO  | dkv: V
  static constexpr size_t T2 = T1 + TILE;    // dq: K   | dkv: Q
  static constexpr size_t T3 = T2 + TILE;    // dq: V   | dkv: dO
  static constexpr size_t S1 = T3 + TILE;    // f32 scores (S, or S^T)
  static constexpr size_t S2 = S1 + (size_t)BT * LDS * 4;  // f32 dP (or dP^T, then dS^T)
  static constexpr size_t P = S2 + (size_t)BT * LDS * 4;   // bf16 dS (or P^T, then dS^T)
  static constexpr size_t LSE = P + (size_t)BT * LDP * 2;
  static constexpr size_t DELTA = LSE + (size_t)BT * 4;
  static constexpr size_t BYTES = DELTA + (size_t)BT * 4;
  // the output staging tile (64 x LDO f32) reuses two adjacent 64 x D tiles
  static_assert((size_t)BT * LDO * 4 <= 2 * TILE, "staging tile does not fit");
};

// Copy rows [r_begin, r_begin + 64) of a [S, row_stride] bf16 matrix (from
// `src`, which already points at the head's first column) into a 64 x D
// shared tile; rows at or past S load as zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int r_begin, int S, int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BT * VPR; i += NT) {
    const int r = i / VPR;
    const int c = i % VPR;
    uint4 val = zero;
    if (r_begin + r < S) val = reinterpret_cast<const uint4*>(src + (size_t)(r_begin + r) * row_stride)[c];
    reinterpret_cast<uint4*>(dst + r * Layout<D>::LDH)[c] = val;
  }
}

// out[16][64] (f32, stride ldo) = a[16][D] * b[64][D]^T, with a and b
// bf16 tiles of stride LDH. One warp.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float* out, int ldo, const __nv_bfloat16* a,
                                                  const __nv_bfloat16* b) {
  constexpr int LDH = Layout<D>::LDH;
  AccFrag acc[BT / 16];
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDH);
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + (n * 16) * LDH + kk, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BT / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], ldo, wmma::mem_row_major);
}

// acc[16][D] += p[16][64] * m[64][D]: p a bf16 tile of stride LDP, m a
// bf16 tile of stride LDH. One warp; acc stays in registers.
template <int D>
__device__ __forceinline__ void accumulate(AccFrag (&acc)[D / 16], const __nv_bfloat16* p,
                                           const __nv_bfloat16* m) {
  constexpr int LDH = Layout<D>::LDH;
  constexpr int LDP = Layout<D>::LDP;
#pragma unroll
  for (int kk = 0; kk < BT; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, p + kk, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, m + kk * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write this warp's 16 accumulator rows (tile rows r0..r0+15, i.e. matrix
// rows row_begin + r0 + ...) to dst [S, row_stride] in bf16 through the
// f32 staging tile; rows at or past S are not written.
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* dst, size_t row_stride, float* stage,
                                           AccFrag (&acc)[D / 16], int r0, int row_begin, int S,
                                           int lane) {
  constexpr int LDO = Layout<D>::LDO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + r0 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int row = row_begin + r0 + rr;
    if (row >= S) break;
    const float* srow = stage + (r0 + rr) * LDO;
    __nv_bfloat162* drow = reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * row_stride);
    for (int d2 = lane; d2 < D / 2; d2 += 32)
      drow[d2] = __floats2bfloat162_rn(srow[2 * d2], srow[2 * d2 + 1]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    __nv_bfloat16* __restrict__ dq, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int S, int H, int KV, float scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T0);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T1);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T2);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T3);
  float* ss = reinterpret_cast<float*>(smem + Lay::S1);
  float* dps = reinterpret_cast<float*>(smem + Lay::S2);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::DELTA);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16;
  const int lane = tid & 31;
  const size_t q_row = (size_t)H * D;    // elements between two positions of q / do / dq
  const size_t kv_row = (size_t)KV * D;  // of k / v
  const size_t q_off = (size_t)b * S * q_row + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * D;

  load_tile<D>(qs, q + q_off, q_row, q0, S, tid);
  load_tile<D>(dos, dout + q_off, q_row, q0, S, tid);
  if (tid < BT) {
    const int row = q0 + tid;
    const size_t i = ((size_t)b * H + h) * S + row;
    lse_s[tid] = row < S ? lse[i] : 0.f;
    delta_s[tid] = row < S ? delta[i] : 0.f;
  }
  AccFrag acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // causal: K/V tiles up to the one holding this q tile's last row
  const int n_tiles = min((q0 + BT - 1) / BT + 1, (S + BT - 1) / BT);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // Q/dO/lse/delta visible; the previous tile's K/V reads done
    load_tile<D>(ks, kb, kv_row, k0, S, tid);
    load_tile<D>(vs, vb, kv_row, k0, S, tid);
    __syncthreads();

    rows_times_rows_t<D>(ss + r0 * Lay::LDS, Lay::LDS, qs + r0 * Lay::LDH, ks);   // S = Q K^T
    rows_times_rows_t<D>(dps + r0 * Lay::LDS, Lay::LDS, dos + r0 * Lay::LDH, vs); // dP = dO V^T
    __syncwarp();

    // P = exp(S * scale - lse) on live (row, col), dS = P (dP - delta) scale
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int row = q0 + r;
      const float l = lse_s[r];
      const float dl = delta_s[r];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int col = k0 + c;
        float p = 0.f;
        if (row < S && col <= row) p = expf(ss[r * Lay::LDS + c] * scale - l);
        dss[r * Lay::LDP + c] = __float2bfloat16(p * (dps[r * Lay::LDS + c] - dl) * scale);
      }
    }
    __syncwarp();
    accumulate<D>(acc, dss + r0 * Lay::LDP, ks);  // dQ += dS K
  }
  __syncthreads();  // every warp is done with Q/dO before staging overwrites them
  write_rows<D>(dq + q_off, q_row, reinterpret_cast<float*>(smem + Lay::T0), acc, r0, q0, S,
                lane);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S, int H, int KV,
    float scale) {
  using Lay = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T0);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T1);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T2);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T3);
  float* sts = reinterpret_cast<float*>(smem + Lay::S1);
  float* dpts = reinterpret_cast<float*>(smem + Lay::S2);
  __nv_bfloat16* pts = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::DELTA);

  const int bk = blockIdx.x;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16;
  const int lane = tid & 31;
  const size_t q_row = (size_t)H * D;
  const size_t kv_row = (size_t)KV * D;
  const size_t kv_off = (size_t)b * S * kv_row + (size_t)kvh * D;

  load_tile<D>(ks, k + kv_off, kv_row, k0, S, tid);
  load_tile<D>(vs, v + kv_off, kv_row, k0, S, tid);
  AccFrag dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int nq = (S + BT - 1) / BT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;  // query heads of a group are contiguous
    const size_t q_off = (size_t)b * S * q_row + (size_t)h * D;
    const float* lse_h = lse + ((size_t)b * H + h) * S;
    const float* delta_h = delta + ((size_t)b * H + h) * S;
    // causal: query tiles from the one holding key row k0 to the end
    for (int i = k0 / BT; i < nq; ++i) {
      const int q0 = i * BT;
      __syncthreads();  // K/V visible; the previous tile's Q/dO/lse reads done
      load_tile<D>(qs, q + q_off, q_row, q0, S, tid);
      load_tile<D>(dos, dout + q_off, q_row, q0, S, tid);
      if (tid < BT) {
        const int col = q0 + tid;
        lse_s[tid] = col < S ? lse_h[col] : 0.f;
        delta_s[tid] = col < S ? delta_h[col] : 0.f;
      }
      __syncthreads();

      rows_times_rows_t<D>(sts + r0 * Lay::LDS, Lay::LDS, ks + r0 * Lay::LDH, qs);    // S^T = K Q^T
      rows_times_rows_t<D>(dpts + r0 * Lay::LDS, Lay::LDS, vs + r0 * Lay::LDH, dos);  // dP^T = V dO^T
      __syncwarp();

      // P^T (bf16, for dV) and dS^T (f32, in place of dP^T)
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr;
        const int krow = k0 + r;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int qcol = q0 + c;
          float p = 0.f;
          if (qcol < S && krow <= qcol) p = expf(sts[r * Lay::LDS + c] * scale - lse_s[c]);
          pts[r * Lay::LDP + c] = __float2bfloat16(p);
          float* dpt = dpts + r * Lay::LDS + c;
          *dpt = p * (*dpt - delta_s[c]) * scale;
        }
      }
      __syncwarp();
      accumulate<D>(dv_acc, pts + r0 * Lay::LDP, dos);  // dV += P^T dO
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int r = r0 + rr;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          pts[r * Lay::LDP + c] = __float2bfloat16(dpts[r * Lay::LDS + c]);
        }
      }
      __syncwarp();
      accumulate<D>(dk_acc, pts + r0 * Lay::LDP, qs);  // dK += dS^T Q
    }
  }
  __syncthreads();  // every warp is done with Q/dO before staging overwrites them
  float* stage = reinterpret_cast<float*>(smem + Lay::T2);
  write_rows<D>(dk + kv_off, kv_row, stage, dk_acc, r0, k0, S, lane);
  write_rows<D>(dv + kv_off, kv_row, stage, dv_acc, r0, k0, S, lane);
}

template <int D>
int launch_dq(void* dq, const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, int B, int S, int H, int KV, float scale,
              cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + BT - 1) / BT);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      (__nv_bfloat16*)dq, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, (const float*)lse,
      (const float*)delta, S, H, KV, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(void* dk, void* dv, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta, int B, int S, int H,
               int KV, float scale, cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * KV, (S + BT - 1) / BT);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout,
      (const float*)lse, (const float*)delta, S, H, KV, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq(void* dq, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, int B, int S,
                            int H, int KV, int D, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_dq<64>(dq, q, k, v, dout, lse, delta, B, S, H, KV, scale, st);
    case 128:
      return launch_dq<128>(dq, q, k, v, dout, lse, delta, B, S, H, KV, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_dkv(void* dk, void* dv, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, int B, int S,
                             int H, int KV, int D, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return launch_dkv<64>(dk, dv, q, k, v, dout, lse, delta, B, S, H, KV, scale, st);
    case 128:
      return launch_dkv<128>(dk, dv, q, k, v, dout, lse, delta, B, S, H, KV, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
