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

#include <cuda_runtime.h>
#include <cstdint>

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

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
