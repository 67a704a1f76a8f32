// Paged KV-cache write: scatter T new [KV, D] rows into the paged arena
// [NBLK, bs, KV, D] at flat slots (block * bs + offset), in place.
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py paged_kv_write
// (_kv_write_kernel). The TPU kernel sorted the rows by slot and
// read-modify-wrote whole cache blocks through VMEM, because Mosaic could
// not store a row at a dynamic sublane offset. A GPU stores one row
// directly, so there is no sort and no block round trip here.
//
// Bound on the H100: bytes. Each live row is read once and written once
// (KV * D * 2 bytes each for K and V); there is no arithmetic. The design
// gives each (row, K-or-V) pair one thread block whose threads move the
// row as 16-byte vectors, neighbouring threads on neighbouring addresses,
// so every store is a full, coalesced transaction.
//
// Contract (same as the TPU kernel): slot < 0 drops the row (pad rows);
// the block id is clamped to the arena, so a violated block-table
// contract writes inside the arena instead of at an illegal address that
// would kill the CUDA context.
//
// paged_kv_write_int8, the quantizing write into int8 pools, replaces
// three steps of the JAX package's _write_kv_quant: quantize_kv_rows (an
// XLA pass), paged_kv_write on the code pools and paged_kv_write reused as
// paged_scale_write (paged_attention.py:902) on the f32 scale pools
// [NBLK, bs, KV]. One launch reads each live bf16 row once and writes its
// codes and one scale per (row, head). Bound: bytes, T_live * KV * D * 2
// read and T_live * KV * (D + 4) written for K and V each. One block per
// row; warp w quantizes the [D] slices w, w + warps, ... of the row's 2*KV
// slices (K heads, then V heads) with kv_quant.cuh, lane l holding
// ceil(D/32) neighbouring elements (at D = 80, 3: lanes 27-31 hold only
// the zero padding, which is never stored). A scale is one 4-byte store,
// so any KV works (the bf16 write's 16-byte rows would refuse a [KV] f32
// scale row for KV < 4). The bf16 write moves whole rows of KV * D * 2
// bytes, so it takes any head dim and KV whose row is a multiple of 16
// bytes (Falcon-7B's one KV head of 64: 128 bytes; Phi-2's 32 x 80: 5,120).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "kv_quant.cuh"

namespace {

__global__ void kv_write_kernel(uint4* __restrict__ k_cache,
                                uint4* __restrict__ v_cache,
                                const uint4* __restrict__ k_new,
                                const uint4* __restrict__ v_new,
                                const int32_t* __restrict__ slots,
                                int n_blocks, int block_size, int row_vecs) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0) return;
  int blk = slot / block_size;
  blk = min(max(blk, 0), n_blocks - 1);
  const long long off = (long long)blk * block_size + slot % block_size;
  const bool is_v = blockIdx.y == 1;
  uint4* dst = (is_v ? v_cache : k_cache) + off * row_vecs;
  const uint4* src = (is_v ? v_new : k_new) + (long long)t * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

template <int D>
__global__ void kv_write_int8_kernel(int8_t* __restrict__ k_codes,        // [NBLK, bs, KV, D]
                                     int8_t* __restrict__ v_codes,
                                     float* __restrict__ k_scale,         // [NBLK, bs, KV]
                                     float* __restrict__ v_scale,
                                     const __nv_bfloat16* __restrict__ k_new,  // [T, KV, D]
                                     const __nv_bfloat16* __restrict__ v_new,
                                     const int32_t* __restrict__ slots,   // [T]
                                     int n_blocks, int block_size, int n_kv) {
  constexpr int EPL = (D + 31) / 32;
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0) return;
  int blk = slot / block_size;
  blk = min(max(blk, 0), n_blocks - 1);
  const long long off = (long long)blk * block_size + slot % block_size;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int j = threadIdx.x >> 5; j < 2 * n_kv; j += warps) {
    const bool is_v = j >= n_kv;
    const int h = is_v ? j - n_kv : j;
    const __nv_bfloat16* src = (is_v ? v_new : k_new) + ((long long)t * n_kv + h) * D + lane * EPL;
    float x[EPL];
    int8_t code[EPL];
    // element e of this lane is column lane * EPL + e of the slice
    const int n_own = min(EPL, max(D - lane * EPL, 0));
#pragma unroll
    for (int e = 0; e < EPL; ++e) x[e] = e < n_own ? __bfloat162float(src[e]) : 0.f;
    const float scale = kv_quant_slice<EPL>(x, code);
    int8_t* dst = (is_v ? v_codes : k_codes) + (off * n_kv + h) * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (e < n_own) dst[e] = code[e];
    if (lane == 0) (is_v ? v_scale : k_scale)[off * n_kv + h] = scale;
  }
}

}  // namespace

extern "C" int paged_kv_write(void* k_cache, void* v_cache, const void* k_new,
                              const void* v_new, const void* slots, int n_rows,
                              int n_blocks, int block_size, int row_bytes,
                              void* stream) {
  if (n_rows <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  int threads = ((row_vecs + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  dim3 grid(n_rows, 2);
  kv_write_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (uint4*)k_cache, (uint4*)v_cache, (const uint4*)k_new,
      (const uint4*)v_new, (const int32_t*)slots, n_blocks, block_size,
      row_vecs);
  return (int)cudaGetLastError();
}

extern "C" int paged_kv_write_int8(void* k_codes, void* v_codes, void* k_scale, void* v_scale,
                                   const void* k_new, const void* v_new, const void* slots,
                                   int n_rows, int n_blocks, int block_size, int n_kv,
                                   int head_dim, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_kv <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 32 * (2 * n_kv < 8 ? 2 * n_kv : 8);
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      kv_write_int8_kernel<64><<<n_rows, threads, 0, st>>>(
          (int8_t*)k_codes, (int8_t*)v_codes, (float*)k_scale, (float*)v_scale,
          (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const int32_t*)slots,
          n_blocks, block_size, n_kv);
      break;
    case 80:
      kv_write_int8_kernel<80><<<n_rows, threads, 0, st>>>(
          (int8_t*)k_codes, (int8_t*)v_codes, (float*)k_scale, (float*)v_scale,
          (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const int32_t*)slots,
          n_blocks, block_size, n_kv);
      break;
    case 128:
      kv_write_int8_kernel<128><<<n_rows, threads, 0, st>>>(
          (int8_t*)k_codes, (int8_t*)v_codes, (float*)k_scale, (float*)v_scale,
          (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const int32_t*)slots,
          n_blocks, block_size, n_kv);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
