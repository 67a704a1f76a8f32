// Tile helpers of the evoformer backward kernels #8 and #9
// (evoformer_bwd.cu; #7 and #10 are built on hopper.cuh). Tensors use the
// DS4Sci layout: q, k, v, o, dO and their gradients [B, S, N, H, D] bf16,
// read in place (a head row is D contiguous elements, rows H * D apart);
// bias1 [B, S, 1, 1, N] and bias2 [B, 1, H, N, N] bf16; lse, delta and row
// sums [G, N] f32 with G = B * S * H in (b, s, h) order. Every block runs 4
// warps over 64-row tiles; warp w owns rows 16w..16w+15 of its tile.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <math.h>

namespace evo {

using namespace nvcuda;

constexpr int BT = 64;   // rows of every tile (query and key tiles alike)
constexpr int NT = 128;  // threads per block (4 warps)
constexpr int LDB = BT + 4;  // bf16 stride of a bias2 tile: 8-byte rows for cp.async,
                             // 34 words, so a column read is at most 2-way conflicted
constexpr int LDS = BT + 4;  // f32 stride of a 64 x 64 score tile
constexpr int LDP = BT + 8;  // bf16 stride of a 64 x 64 P / dS tile

template <int D>
__host__ __device__ constexpr int ldh() { return D + 8; }  // bf16 stride of a 64 x D tile
template <int D>
__host__ __device__ constexpr int ldo() { return D + 4; }  // f32 stride of a 64 x D staging tile

// shared-memory regions start 128-byte aligned (WMMA needs 32)
__host__ __device__ constexpr size_t al(size_t x) { return (x + 127) / 128 * 128; }
template <int D>
__host__ __device__ constexpr size_t tile_bytes() { return al((size_t)BT * ldh<D>() * 2); }
constexpr size_t SCORE_BYTES = al((size_t)BT * LDS * 4);
constexpr size_t P_BYTES = al((size_t)BT * LDP * 2);
constexpr size_t BIAS2_BYTES = al((size_t)BT * LDB * 2);
constexpr size_t ROW_BYTES = al((size_t)BT * 4);

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Offset of the first element of slice g = (b, s, h) in a [B, S, N, H, D]
// tensor; its rows are H * D elements apart.
template <int D>
__device__ __forceinline__ size_t slice_offset(int g, int N, int H) {
  return (size_t)(g / H) * N * H * D + (size_t)(g % H) * D;
}

// Asynchronous global -> shared copies (cp.async): a thread issues every
// load of a tile at once and waits for all of them together (wait_loads),
// instead of paying one memory latency after another. An invalid copy
// reads nothing and zero-fills its destination; `src` must still point
// into the tensor.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n));
}

// Wait for every cp.async this thread issued (then __syncthreads() makes
// the block's copies visible to all its threads).
__device__ __forceinline__ void wait_loads() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r_begin, r_begin + 64) of a slice (`src` at its first element,
// rows `row_stride` apart) into a 64 x D shared tile; rows at or past N
// load as zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int r_begin, int N, int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
#pragma unroll
  for (int j = 0; j < BT * VPR / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const bool live = r_begin + r < N;
    cp_async<16>(dst + r * ldh<D>() + c, src + (live ? (size_t)(r_begin + r) * row_stride : 0) + c,
                 live);
  }
}

// The 64 x 64 tile at rows [r_begin, +64), columns [c_begin, +64) of an
// [N, N] bf16 matrix into dst (stride LDB); entries past N load as 0.
// 8-byte copies where every row start is 8-byte aligned (N % 4 == 0 and
// an aligned base), synchronous element loads otherwise.
__device__ __forceinline__ void load_bias_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int r_begin, int c_begin, int N, int tid) {
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 8 == 0) {
#pragma unroll
    for (int j = 0; j < BT * (BT / 4) / NT; ++j) {
      const int i = tid + j * NT;
      const int r = i / (BT / 4);
      const int c = (i % (BT / 4)) * 4;
      const bool live = r_begin + r < N && c_begin + c < N;
      cp_async<8>(dst + r * LDB + c, src + (live ? (size_t)(r_begin + r) * N + c_begin + c : 0),
                  live);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < BT * BT; i += NT) {
      const int r = i / BT;
      const int c = i % BT;
      dst[r * LDB + c] = (r_begin + r < N && c_begin + c < N)
                             ? src[(size_t)(r_begin + r) * N + c_begin + c]
                             : zero;
    }
  }
}

// 64 entries of a [.., N] f32 row vector from position `begin` into dst;
// entries past N load as 0. Threads 0..63.
__device__ __forceinline__ void load_row(float* dst, const float* src, int begin, int N,
                                         int tid) {
  if (tid < BT) cp_async<4>(dst + tid, src + (begin + tid < N ? begin + tid : 0), begin + tid < N);
}

// The same for a bf16 row (bias1), widened to f32 (a synchronous load).
__device__ __forceinline__ void load_row(float* dst, const __nv_bfloat16* src, int begin,
                                         int N, int tid) {
  if (tid < BT) dst[tid] = begin + tid < N ? __bfloat162float(src[begin + tid]) : 0.f;
}

// The logit of one (query, key) pair as the TPU kernel forms it: the
// product times the scale, plus bias1, plus bias2, added in that order in
// f32 (no fused multiply-add, so each step rounds as there). An absent
// bias is not added.
__device__ __forceinline__ float logit(float qk, float scale, bool has_b1, float b1,
                                       bool has_b2, __nv_bfloat16 b2) {
  float x = __fmul_rn(qk, scale);
  if (has_b1) x = __fadd_rn(x, b1);
  if (has_b2) x = __fadd_rn(x, __bfloat162float(b2));
  return x;
}

// out[16][64] (f32, stride LDS) = a[16][D] * b[64][D]^T, with a and b bf16
// tiles of stride ldh<D>(). One warp.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float* out, const __nv_bfloat16* a,
                                                  const __nv_bfloat16* b) {
  constexpr int LDH = ldh<D>();
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
    wmma::store_matrix_sync(out + n * 16, acc[n], LDS, wmma::mem_row_major);
}

// acc[16][D] += p[16][64] * m[64][D]: p a bf16 tile of stride LDP, m a
// bf16 tile of stride ldh<D>(). One warp; acc stays in registers.
template <int D>
__device__ __forceinline__ void accumulate(AccFrag (&acc)[D / 16], const __nv_bfloat16* p,
                                           const __nv_bfloat16* m) {
  constexpr int LDH = ldh<D>();
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

// Write this warp's 16 accumulator rows (tile rows r0..r0+15, i.e. slice
// rows row_begin + r0 + ...) times `scale` to dst (rows `row_stride`
// apart) in bf16 through the f32 staging tile; rows at or past N are not
// written.
template <int D>
__device__ __forceinline__ void write_rows(__nv_bfloat16* dst, size_t row_stride, float* stage,
                                           AccFrag (&acc)[D / 16], float scale, int r0,
                                           int row_begin, int N, int lane) {
  constexpr int LDO = ldo<D>();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + r0 * LDO + n * 16, acc[n], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int row = row_begin + r0 + rr;
    if (row >= N) break;
    const float* srow = stage + (r0 + rr) * LDO;
    __nv_bfloat162* drow = reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * row_stride);
    for (int d2 = lane; d2 < D / 2; d2 += 32)
      drow[d2] = __floats2bfloat162_rn(srow[2 * d2] * scale, srow[2 * d2 + 1] * scale);
  }
  __syncwarp();
}

}  // namespace evo
