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
// so every store is a full, coalesced transaction. It takes any head dim
// and KV whose row is a multiple of 16 bytes (Falcon-7B's one KV head of
// 64: 128 bytes; Phi-2's 32 x 80: 5,120).
//
// The same kernel writes f32 rows into f32 pages (an f32 serving engine's
// pools, the f32 mode of the TPU kernel): a row of KV * D * 4 bytes.
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
// codes and one scale per (row, head), with the quantizer of kv_quant.cuh
// (NaN and inf as the JAX package gives them: see there), and the drop and
// clamp contract above. Head dims 64, 80, 96, 128 and 256, any KV >= 1.
//
// Bound: bytes, T_live * KV * D * 2 read and T_live * KV * (D + 4) written
// for K and V each, a few operations a byte (a max, a divide and a
// conversion an element); on the H100 the instructions come close to the
// bytes' time, and a short write (a prefill wave, one KV head) is a chain
// of latencies, so the design keeps every access a vector and each
// thread's chain short:
// - the rows are 2 * T * KV head slices in a flat order (a row's K heads,
//   then its V heads); a CTA of 256 threads takes a tile of 16
//   consecutive slices, one slice a half-warp of 16 lanes, one lane a
//   chunk of 8 bf16 (16 bytes) at D 80, 96 and 128 (lanes 10-15 idle at
//   80, 12-15 at 96) and of 4 (8 bytes) at D 64, so a warp reads two
//   neighbouring slices, contiguous bytes; at D 256 (GPT-J-6B) a slice is
//   32 chunks and lane l takes two, chunks l and l + 16, so that each of
//   its two loads is still 16 lanes on 256 contiguous bytes; the index of
//   a slice's row and of a slot's block are multiplies by magic numbers,
//   not divisions;
// - a slice's amax is the max of the bits of |x| (16-bit halves, two
//   elements an instruction), then a shuffle max within the half-warp:
//   exact in any order, NaN kept;
// - the slice's reciprocal is taken once and each quotient is a multiply
//   and two fmas with no clamp after the conversion (kv_quant.cuh's short
//   route: the IEEE quotient and code bit for bit; kv_quant_check below
//   tries every pair), so a lane's quotients are independent chains
//   (__fdiv_rn's call to its slow path kept them apart);
// - a chunk's codes go out as one 8- or 4-byte store (a slot's [KV, D]
//   codes are contiguous, so a warp writes whole sectors), the slice's
//   scale as one 4-byte store of its lane 0;
// - a warp whose slices are both dropped rows stops after its lookups.
// Alternatives measured on the H100 (PERF.md, Findings): up to 8 slices a
// lane group with all their loads issued first, gathering a tile's scales
// in shared memory for 16-byte stores, persistent CTAs, 64- and 128-thread
// CTAs, loads issued before the slot is known; none was faster at the
// four shapes that bound the write.

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
#ifdef DS_FAULT_ROW_TAIL  // defined only in a planted fault's build (chip_smoke.py)
  const int written = row_vecs - 1;  // each row's last 16 bytes left unwritten
#else
  const int written = row_vecs;
#endif
  for (int i = threadIdx.x; i < written; i += blockDim.x) dst[i] = src[i];
}

// the int8 write's CTA: KV8_TILE head slices of the flat [T, 2 KV] order
// (a row's K heads, then its V heads), one a group of KV8_LANES lanes
constexpr int KV8_THREADS = 256;
constexpr int KV8_LANES = 16;
constexpr int KV8_TILE = KV8_THREADS / KV8_LANES;

template <int D>
struct Kv8 {
  static constexpr int EPL = D == 64 ? 4 : 8;  // bf16 a chunk: 8 bytes at D 64, else 16
  static constexpr int CHUNKS = D / EPL;       // chunks of a slice: 16, 10, 12, 16, 32
  static constexpr int NC = (CHUNKS + KV8_LANES - 1) / KV8_LANES;  // chunks a lane: 2 at D 256
  static_assert(D % EPL == 0 && NC <= 2, "head dim");
};

template <int EPL>
struct Kv8Chunk;
template <>
struct Kv8Chunk<4> {
  using T = uint2;
};
template <>
struct Kv8Chunk<8> {
  using T = uint4;
};

__device__ __forceinline__ void kv8_words(const uint2& v, uint32_t (&w)[2]) {
  w[0] = v.x;
  w[1] = v.y;
}

__device__ __forceinline__ void kv8_words(const uint4& v, uint32_t (&w)[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// four codes in [-127, 127] as the bytes of a word, code e in byte e
__device__ __forceinline__ uint32_t kv8_pack(const int* c) {
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
}

// n / d for 0 <= n < 2^31 by d's magic number and shift (the wrapper's
// _divisor_magic): (umulhi(n, magic) + n) >> shift
struct Kv8Div {
  uint32_t magic;
  int shift;
};

__device__ __forceinline__ int kv8_div(int n, Kv8Div d) {
  return (int)((__umulhi((uint32_t)n, d.magic) + (uint32_t)n) >> d.shift);
}

struct Kv8Slice {
  int src;        // its [D] row of k_new / v_new: row * KV + head
  long long dst;  // its (slot, head) in the pools: slot * KV + head; -1: dropped
  bool is_v;
};

// slice j of the flat order: row j / (2 KV), its K heads, then its V heads
__device__ __forceinline__ Kv8Slice kv8_slice(int j, int n_kv, Kv8Div per_row,
                                              const int32_t* __restrict__ slots, int n_blocks,
                                              int block_size, Kv8Div per_block) {
  const int r = kv8_div(j, per_row);
  int h = j - r * 2 * n_kv;
  const bool is_v = h >= n_kv;
  h -= is_v ? n_kv : 0;
  const int slot = __ldg(slots + r);
  long long dst = -1;
  if (slot >= 0) {
    const int blk = kv8_div(slot, per_block);
    dst = ((long long)min(blk, n_blocks - 1) * block_size + (slot - blk * block_size)) * n_kv + h;
  }
  return {r * n_kv + h, dst, is_v};
}

template <int D>
__global__ void __launch_bounds__(KV8_THREADS)
kv_write_int8_kernel(int8_t* __restrict__ k_codes,   // [NBLK, bs, KV, D]
                     int8_t* __restrict__ v_codes,
                     float* __restrict__ k_scale,    // [NBLK, bs, KV]
                     float* __restrict__ v_scale,
                     const void* __restrict__ k_new,  // [T, KV, D] bf16
                     const void* __restrict__ v_new,
                     const int32_t* __restrict__ slots,  // [T]
                     int n_slices, int n_blocks, int block_size, int n_kv, Kv8Div per_row,
                     Kv8Div per_block) {
  using C = Kv8<D>;
  using Chunk = typename Kv8Chunk<C::EPL>::T;
  constexpr int W = C::EPL / 2;  // 32-bit words a chunk: two bf16 each
  const int lane = threadIdx.x % KV8_LANES;  // the slice's chunks lane (and lane + 16)
  const int j = blockIdx.x * KV8_TILE + threadIdx.x / KV8_LANES;
  Chunk raw[C::NC] = {};
  Kv8Slice s{0, -1, false};
  if (j < n_slices) {
    s = kv8_slice(j, n_kv, per_row, slots, n_blocks, block_size, per_block);
    const Chunk* src = static_cast<const Chunk*>(s.is_v ? v_new : k_new) +
                       (long long)s.src * C::CHUNKS + lane;
#pragma unroll
    for (int i = 0; i < C::NC; ++i)
      if (s.dst >= 0 && lane + i * KV8_LANES < C::CHUNKS) raw[i] = __ldg(src + i * KV8_LANES);
  }
  // a warp whose two slices are both dropped rows (or past the end) is
  // done; else all its lanes go on, so every shuffle runs with the whole warp
  if (!__any_sync(0xffffffffu, s.dst >= 0)) return;
  uint32_t w[C::NC * W];
#pragma unroll
  for (int i = 0; i < C::NC; ++i) {
    uint32_t wi[W];
    kv8_words(raw[i], wi);
#pragma unroll
    for (int e = 0; e < W; ++e) w[i * W + e] = wi[e];
  }
  // the max of |x| on the bf16 pairs' bits (16-bit halves; the bits of a
  // bf16 and of its f32 share their order), then across the group
  uint32_t m2 = 0;
#pragma unroll
  for (int i = 0; i < C::NC * W; ++i) m2 = __vmaxu2(m2, w[i] & 0x7fff7fffu);
  uint32_t amax = max(m2 << 16, m2 & 0xffff0000u);
#pragma unroll
  for (int o = KV8_LANES / 2; o > 0; o >>= 1)
    amax = max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  float x[C::NC * C::EPL];
#pragma unroll
  for (int i = 0; i < C::NC * W; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);  // element 2i: the low half
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  const KvScale sc = kv_scale(amax);
  int c[C::NC * C::EPL];
  kv_codes(x, sc, c);
  if (s.dst < 0) return;
#pragma unroll
  for (int i = 0; i < C::NC; ++i) {
    const int chunk = lane + i * KV8_LANES;
    if (chunk < C::CHUNKS) {
      int8_t* out = (s.is_v ? v_codes : k_codes) + s.dst * D + chunk * C::EPL;
      const int* ci = c + i * C::EPL;
      if constexpr (C::EPL == 8)
        *reinterpret_cast<uint2*>(out) = make_uint2(kv8_pack(ci), kv8_pack(ci + 4));
      else
        *reinterpret_cast<uint32_t*>(out) = kv8_pack(ci);
    }
  }
  if (lane == 0) (s.is_v ? v_scale : k_scale)[s.dst] = sc.scale;
}

template <int D>
int launch_int8(void* k_codes, void* v_codes, void* k_scale, void* v_scale, const void* k_new,
                const void* v_new, const void* slots, int n_slices, int n_blocks,
                int block_size, int n_kv, Kv8Div per_row, Kv8Div per_block, cudaStream_t st) {
  kv_write_int8_kernel<D><<<(n_slices + KV8_TILE - 1) / KV8_TILE, KV8_THREADS, 0, st>>>(
      (int8_t*)k_codes, (int8_t*)v_codes, (float*)k_scale, (float*)v_scale, k_new, v_new,
      (const int32_t*)slots, n_slices, n_blocks, block_size, n_kv, per_row, per_block);
  return (int)cudaGetLastError();
}

// every (x, amax) pair the quantizer can meet, x any bf16 and amax any bf16
// magnitude >= |x| (or NaN, beside any x): one CTA an amax, its threads
// over x. out[0] += the pairs tried; out[1] += those whose code by
// kv_codes's route differs from the IEEE division's; out[2] = the least
// (amax bits << 16 | x bits) of such a pair (the caller sets it to ~0)
__global__ void kv_quant_check_kernel(unsigned long long* out) {
  const uint32_t a = blockIdx.x;  // the amax's bf16 bits, 0 .. 0x7fff
  const KvScale s = kv_scale(a << 16);
  unsigned long long n = 0, off = 0, first = ~0ull;
  for (uint32_t xb = threadIdx.x; xb < 65536u; xb += blockDim.x) {
    if ((xb & 0x7fffu) > a && a <= 0x7f80u) continue;  // |x| > amax (amax not NaN)
    const float x[1] = {__uint_as_float(xb << 16)};
    int code[1];
    kv_codes(x, s, code);
    ++n;
    if (code[0] != kv_code_ieee(x[0], s.scale)) {
      ++off;
      first = min(first, ((unsigned long long)a << 16) | xb);
    }
  }
  atomicAdd(out, n);
  atomicAdd(out + 1, off);
  atomicMin(out + 2, first);
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

// row_magic / row_shift, block_magic / block_shift: the magic numbers and
// shifts of 2 * n_kv and of block_size (the wrapper's _divisor_magic)
extern "C" int paged_kv_write_int8(void* k_codes, void* v_codes, void* k_scale, void* v_scale,
                                   const void* k_new, const void* v_new, const void* slots,
                                   int n_rows, int n_blocks, int block_size, int n_kv,
                                   int head_dim, unsigned row_magic, int row_shift,
                                   unsigned block_magic, int block_shift, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_kv <= 0 || (long long)n_rows * 2 * n_kv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n = n_rows * 2 * n_kv;
  const Kv8Div per_row{row_magic, row_shift}, per_block{block_magic, block_shift};
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch_int8<64>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n,
                             n_blocks, block_size, n_kv, per_row, per_block, st);
    case 80:
      return launch_int8<80>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n,
                             n_blocks, block_size, n_kv, per_row, per_block, st);
    case 96:
      return launch_int8<96>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n,
                             n_blocks, block_size, n_kv, per_row, per_block, st);
    case 128:
      return launch_int8<128>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n,
                              n_blocks, block_size, n_kv, per_row, per_block, st);
    case 256:
      return launch_int8<256>(k_codes, v_codes, k_scale, v_scale, k_new, v_new, slots, n,
                              n_blocks, block_size, n_kv, per_row, per_block, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the exhaustive check of the quantizer's two division routes
// (kv_quant.cuh) into out[3], device memory (zeros, zeros, ~0)
extern "C" int kv_quant_check(void* out, void* stream) {
  kv_quant_check_kernel<<<0x8000, 256, 0, (cudaStream_t)stream>>>((unsigned long long*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
