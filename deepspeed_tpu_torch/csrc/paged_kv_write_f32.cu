// Quantizing paged KV write of f32 rows: T new [KV, D] f32 rows become
// int8 codes in the code pools [NBLK, bs, KV, D] and one f32 scale per
// (row, KV head) in the scale pools [NBLK, bs, KV], at flat slots (block *
// bs + offset), in place, in one launch.
//
// Replaces, for an f32 serving engine on int8 KV pools: the JAX package's
// _write_kv_quant on f32 rows, i.e. quantize_kv_rows (an XLA pass,
// deepspeed_tpu/ops/pallas/paged_attention.py:69-86), paged_kv_write
// (_kv_write_kernel, :889) on the codes and paged_scale_write (:902) on
// the scales. (The f32 write into f32 pages is paged_kv_write.cu's
// kv_write_kernel, which moves a row's bytes whatever their type.)
//
// Bound on the H100: bytes, T_live * KV * D * 4 read and T_live * KV * (D +
// 4) written for K and V each, a few operations an element (a max, an IEEE
// division, a conversion). The design is the plain one: one warp a head
// slice (2 * T * KV of them in a flat order, a row's K heads, then its V
// heads), lane l on elements l + 32 e, so that each load and each code
// store of the warp is contiguous; the amax by a shuffle max on the bits
// of |x|; the codes by kv_quant_f32.cuh, bit for bit the plain
// quantize_kv_rows. Head dims 64, 80, 96, 128 and 256, any KV >= 1.
//
// Contract (the bf16 write's): slot < 0 drops the row; the block id is
// clamped to the arena, so a violated block-table contract writes inside
// the arena.
//
// Planted faults (defined only in chip_smoke.py's fault builds):
// DS_FAULT_ROW_TAIL leaves the last 16-byte chunk of each row's elements
// (4 f32) unwritten; DS_FAULT_SCALE_NEXT_HEAD stores each slice's scale at
// the next KV head's place of its slot.

#include <cuda_runtime.h>
#include <cstdint>

#include "kv_quant_f32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLICES = THREADS / 32;  // a CTA's head slices: one a warp

template <int D>
__global__ void __launch_bounds__(THREADS)
kv_write_int8_f32_kernel(int8_t* __restrict__ k_codes, int8_t* __restrict__ v_codes,
                         float* __restrict__ k_scale, float* __restrict__ v_scale,
                         const float* __restrict__ k_new, const float* __restrict__ v_new,
                         const int32_t* __restrict__ slots, long long n_slices, int n_blocks,
                         int block_size, int n_kv) {
  constexpr int EPL = (D + 31) / 32;
  const long long j = (long long)blockIdx.x * SLICES + threadIdx.x / 32;  // the warp's slice
  const int lane = threadIdx.x % 32;
  if (j >= n_slices) return;  // the whole warp
  const long long r = j / (2 * n_kv);
  int h = (int)(j - r * 2 * n_kv);
  const bool is_v = h >= n_kv;
  h -= is_v ? n_kv : 0;
  const int slot = slots[r];
  if (slot < 0) return;  // a dropped row: the whole warp
  const int blk = min(slot / block_size, n_blocks - 1);
  const long long dst = ((long long)blk * block_size + slot % block_size) * n_kv + h;
  float x[EPL];
  int code[EPL];
  const float scale =
      kv_quant_warp_f32<D>((is_v ? v_new : k_new) + (r * n_kv + h) * D, lane, x, code);
#ifdef DS_FAULT_ROW_TAIL
  constexpr int WRITTEN = D - 4;
#else
  constexpr int WRITTEN = D;
#endif
  int8_t* out = (is_v ? v_codes : k_codes) + dst * D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    if (d < WRITTEN) out[d] = (int8_t)code[e];
  }
  if (lane == 0) {
#ifdef DS_FAULT_SCALE_NEXT_HEAD
    const long long at = dst - h + (h + 1) % n_kv;
#else
    const long long at = dst;
#endif
    (is_v ? v_scale : k_scale)[at] = scale;
  }
}

template <int D>
int launch(void* k_codes, void* v_codes, void* k_scale, void* v_scale, const void* k_new,
           const void* v_new, const void* slots, long long n_slices, int n_blocks,
           int block_size, int n_kv, cudaStream_t st) {
  const long long grid = (n_slices + SLICES - 1) / SLICES;
  kv_write_int8_f32_kernel<D><<<(unsigned)grid, THREADS, 0, st>>>(
      (int8_t*)k_codes, (int8_t*)v_codes, (float*)k_scale, (float*)v_scale,
      (const float*)k_new, (const float*)v_new, (const int32_t*)slots, n_slices, n_blocks,
      block_size, n_kv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_kv_write_int8_f32(void* k_codes, void* v_codes, void* k_scale,
                                       void* v_scale, const void* k_new, const void* v_new,
                                       const void* slots, int n_rows, int n_blocks,
                                       int block_size, int n_kv, int head_dim, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_kv <= 0 || n_blocks <= 0 || block_size <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_rows * 2 * n_kv;
  if ((n + SLICES - 1) / SLICES > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch<64>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n, n_blocks,
                        block_size, n_kv, st);
    case 80:
      return launch<80>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n, n_blocks,
                        block_size, n_kv, st);
    case 96:
      return launch<96>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n, n_blocks,
                        block_size, n_kv, st);
    case 128:
      return launch<128>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n, n_blocks,
                         block_size, n_kv, st);
    case 256:
      return launch<256>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n, n_blocks,
                         block_size, n_kv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
