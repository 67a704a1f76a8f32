// W8A16 GEMM: Y[M, N] = X[M, K] Q[N, K]^T with bf16 activations X, int8
// codes Q (one output channel a row, K contiguous) and one f32 scale per
// output channel, accumulated in f32:
//   bf16 output: Y = bf16(bf16(X Q^T) * bf16(s))   (inference/model.py _wmm)
//   f32 output:  Y = f32(bf16(X Q^T)) * s           (_lm_logits, the logits)
// Every product of a per-channel int8 serving engine reduces to this form
// (e,ehd->hd with N = heads x D; hd,hde->e with K = H x D; te,ef->tf;
// tf,fe->te; e,ev->v; the tied e,ve->v, whose [V, E] codes are this
// layout already).
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA
// (deepspeed_tpu/inference/model.py:198 _wmm, :216 _lm_logits), which on
// the TPU fuses the int8 -> bf16 convert into the dot's operand stream, so
// the product streams int8 bytes. On the card only a hand-written kernel
// does that: dequantize-then-cuBLAS reads the codes, writes a bf16 copy
// and reads it again, 2.5x the bf16 path's weight bytes.
//
// Bound on the H100: bytes at decode (M = 1-64: N K code bytes against 2 M
// N K operations, far below the 295 operations a byte where the tensor
// cores would bind), operations at prefill (M in the hundreds or
// thousands). The design, simple first:
// - CTAs of 4 warps (8 at 128 rows) own a 128-column tile of Y and BM
//   rows (16, 32, 64 or 128, the wrapper's plan: the least that holds M,
//   or 16 for a decode step's small product) over a range of K; a
//   3-stage cp.async ring brings each 128-deep slice of X
//   (bf16 rows padded to 272 bytes) and of the codes (128-byte rows: a
//   column's slice is one whole cache line; odd rows keep the two halves
//   of their line swapped, so that the two rows a quarter-warp reads fall
//   on different banks) to shared memory; out-of-range rows, columns and
//   the K tail are zero-filled by the copy (K must be a multiple of 16).
//   64-deep slices, or 4 stages, or warps of 32 rows measured slower at
//   the decode rows (PERF.md).
// - Products on mma.sync.m16n8k16 (bf16 in, f32 accumulate); a warp holds
//   32 columns and up to 64 rows. The contraction order within each
//   64-deep half of a slice is permuted so that a lane's B fragments for
//   all four k16 steps of a column come from ONE 16-byte load of its codes
//   (lane (g, t) reads codes [16t, 16t + 16) of column g; step j uses
//   16t + 4j .. 16t + 4j + 3), and its A fragments from two 16-byte loads
//   per row of the same k range: the sum runs over the same k either way.
//   No ldmatrix; both loads are free of bank conflicts.
// - Each int8 code converts to bf16 in registers, exactly: its sign bit
//   flipped is code + 128, which placed under the exponent of 2^23 reads
//   as 2^23 + code + 128 in f32; less 2^23 + 128 that is the code, whose
//   f32 upper half is its bf16 (at most 8 significant bits).
// - Split-K where the tiles alone would leave the card idle (decode):
//   the plan (ops/cuda/int8_matmul.py matmul_split_plan) cuts K into
//   n_splits ranges of whole slices; each CTA writes its f32
//   partial tile, and the last CTA of a tile to arrive adds the partials
//   in split order (no float atomics: the same bits every launch) and
//   applies the epilogue. Arrival counters are left at 0 for the next
//   launch (the wrapper keeps them, with the partials, in the stream's
//   decode workspace).
// - The epilogue rounds the f32 sum to bf16, then applies the scale as
//   _wmm does (the product of two bf16 values is exact in f32, so one
//   rounding), or for the logits multiplies in f32.
// A wgmma/TMA design for prefill and a decode that reaches the int8 byte
// bound are later work (ROADMAP B8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ops/cuda/int8_matmul.py's split plan keeps copies of BN, BK and STAGES
constexpr int BN = 128;               // output columns a CTA
constexpr int BK = 128;               // contraction depth of a ring stage (a multiple of 64)
constexpr int STAGES = 3;             // stages in the cp.async ring
constexpr int WN = 32;                // columns a warp: four n8 tiles
constexpr int XS = BK + 8;            // bf16 row stride of an X slice in shared memory
// a code row's 16-byte chunk c lives at chunk c ^ swz(row): rows of 128
// bytes or more alternate halves of each 128-byte line, so that the two
// rows a quarter-warp reads fall on different banks
__device__ __forceinline__ int swz(int row) { return BK >= 128 ? (row & 1) << 2 : 0; }

template <int BM>
struct Cfg {
  static constexpr int WM = BM < 64 ? BM : 64;  // rows a warp
  static constexpr int MT = WM / 16;            // m16 tiles a warp
  static constexpr int WARPS_M = BM / WM;
  static constexpr int WARPS = WARPS_M * (BN / WN);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int X_BYTES = BM * XS * 2;
  static constexpr int Q_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = X_BYTES + Q_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

struct Args {
  void* out;
  const __nv_bfloat16* x;
  const int8_t* q;
  const float* scale;
  float* part;    // [n_splits, M, N] f32 partials (n_splits > 1)
  int* counters;  // one arrival counter a tile (n_splits > 1), 0 between launches
  int M, N, K, n_splits, split_len, f32_out;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four int8 codes (code i in byte i of w) -> bf16x2 words lo = (c0, c1),
// hi = (c2, c3), exactly (see the header)
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// slice [k0, k0 + BK) of X rows m0.. and of the codes of columns n0.. into
// a ring stage; rows past M or N and k at or past k_end are zero-filled
template <int BM>
__device__ __forceinline__ void load_stage(const Args& a, uint8_t* stage, int m0, int n0, int k0,
                                           int k_end, int tid) {
  using C = Cfg<BM>;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);
  int8_t* qs = reinterpret_cast<int8_t*>(stage + C::X_BYTES);
#pragma unroll
  for (int i = tid; i < BM * (BK / 8); i += C::THREADS) {
    const int r = i / (BK / 8), c = i % (BK / 8);
    const int m = m0 + r, k = k0 + c * 8;
    const bool ok = m < a.M && k < k_end;
    cp_async16(xs + r * XS + c * 8, ok ? a.x + (size_t)m * a.K + k : a.x, ok);
  }
#pragma unroll
  for (int i = tid; i < BN * (BK / 16); i += C::THREADS) {
    const int r = i / (BK / 16), c = i % (BK / 16);
    const int n = n0 + r, k = k0 + c * 16;
    const bool ok = n < a.N && k < k_end;
    cp_async16(qs + r * BK + ((c ^ swz(r)) * 16), ok ? a.q + (size_t)n * a.K + k : a.q, ok);
  }
}

// one ring stage's products into the warp's accumulators
template <int BM>
__device__ __forceinline__ void compute_stage(const uint8_t* stage,
                                              float (&acc)[Cfg<BM>::MT][4][4], int warp_m,
                                              int warp_n, int lane) {
  using C = Cfg<BM>;
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(stage);
  const int8_t* qs = reinterpret_cast<const int8_t*>(stage + C::X_BYTES);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < BK / 64; ++h) {  // each 64-deep part of the slice
    uint32_t b[4][4][2];  // [n8 tile][k16 step][b0, b1]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = warp_n * WN + nt * 8 + g;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(qs + row * BK + (((4 * h + t) ^ swz(row)) * 16));
      codes_to_bf16(raw.x, b[nt][0][0], b[nt][0][1]);
      codes_to_bf16(raw.y, b[nt][1][0], b[nt][1][1]);
      codes_to_bf16(raw.z, b[nt][2][0], b[nt][2][1]);
      codes_to_bf16(raw.w, b[nt][3][0], b[nt][3][1]);
    }
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const __nv_bfloat16* r0 = xs + (warp_m * C::WM + mt * 16 + g) * XS + 64 * h + 16 * t;
      const __nv_bfloat16* r1 = r0 + 8 * XS;
      const uint4 p0 = *reinterpret_cast<const uint4*>(r0);
      const uint4 p1 = *reinterpret_cast<const uint4*>(r0 + 8);
      const uint4 q0 = *reinterpret_cast<const uint4*>(r1);
      const uint4 q1 = *reinterpret_cast<const uint4*>(r1 + 8);
      const uint32_t w0[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const uint32_t w1[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t af[4] = {w0[2 * j], w1[2 * j], w0[2 * j + 1], w1[2 * j + 1]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], af, b[nt][j][0], b[nt][j][1]);
      }
    }
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Y[r, c] and Y[r, c + 1] from their f32 sums (c + 1 may be past N)
__device__ __forceinline__ void store_pair(const Args& a, int r, int c, float v0, float v1) {
  if (r >= a.M || c >= a.N) return;
  const bool both = c + 1 < a.N;
  const size_t at = (size_t)r * a.N + c;
  if (a.f32_out) {
    float* out = reinterpret_cast<float*>(a.out) + at;
    const float y0 = bf16_round(v0) * a.scale[c];
    if (both) {
      const float y1 = bf16_round(v1) * a.scale[c + 1];
      if ((a.N & 1) == 0) {
        *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
      } else {
        out[0] = y0;
        out[1] = y1;
      }
    } else {
      out[0] = y0;
    }
    return;
  }
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(a.out) + at;
  const __nv_bfloat16 y0 = __float2bfloat16_rn(bf16_round(v0) * bf16_round(a.scale[c]));
  if (both) {
    const __nv_bfloat16 y1 = __float2bfloat16_rn(bf16_round(v1) * bf16_round(a.scale[c + 1]));
    if ((a.N & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(out) = __halves2bfloat162(y0, y1);
    } else {
      out[0] = y0;
      out[1] = y1;
    }
  } else {
    out[0] = y0;
  }
}

template <int BM>
__global__ void __launch_bounds__(Cfg<BM>::THREADS) w8a16_kernel(const Args a) {
  using C = Cfg<BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / (BN / WN), warp_n = warp % (BN / WN);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int k_begin = split * a.split_len;
  const int k_end = min(a.K, k_begin + a.split_len);
  const int chunks = (k_end - k_begin + BK - 1) / BK;

  float acc[C::MT][4][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      load_stage<BM>(a, smem + s * C::STAGE_BYTES, m0, n0, k_begin + s * BK, k_end, tid);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // slice c has landed
    __syncthreads();              // and every warp is done with slice c - 1's stage
    const int next = c + STAGES - 1;
    if (next < chunks)
      load_stage<BM>(a, smem + (next % STAGES) * C::STAGE_BYTES, m0, n0, k_begin + next * BK,
                     k_end, tid);
    cp_async_commit();
    compute_stage<BM>(smem + (c % STAGES) * C::STAGE_BYTES, acc, warp_m, warp_n, lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  const int row0 = m0 + warp_m * C::WM + g, col0 = n0 + warp_n * WN + 2 * t;
  if (a.n_splits == 1) {
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = row0 + mt * 16, c = col0 + nt * 8;
        store_pair(a, r, c, acc[mt][nt][0], acc[mt][nt][1]);
        store_pair(a, r + 8, c, acc[mt][nt][2], acc[mt][nt][3]);
      }
    return;
  }

  // split-K: this split's partial tile, then the last CTA to arrive adds
  // all of them in split order
  float* part = a.part + (size_t)split * a.M * a.N;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + mt * 16 + (e >> 1) * 8, c = col0 + nt * 8 + (e & 1);
        if (r < a.M && c < a.N) part[(size_t)r * a.N + c] = acc[mt][nt][e];
      }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(a.counters + tile, 1) == a.n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < BM * (BN / 2); i += C::THREADS) {
    const int r = m0 + i / (BN / 2), c = n0 + 2 * (i % (BN / 2));
    if (r >= a.M || c >= a.N) continue;
    float v0 = 0.f, v1 = 0.f;
    for (int s = 0; s < a.n_splits; ++s) {
      const float* p = a.part + ((size_t)s * a.M + r) * a.N + c;
      v0 += __ldcg(p);
      if (c + 1 < a.N) v1 += __ldcg(p + 1);
    }
    store_pair(a, r, c, v0, v1);
  }
  if (tid == 0) a.counters[tile] = 0;  // ready for the next launch
}

template <int BM>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<BM>;
  static int attr_device = -1;  // the device whose shared memory cap was last set
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a16_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_device = dev;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.n_splits);
  w8a16_kernel<BM><<<grid, C::THREADS, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// out [M, N] bf16 (f32_out 0) or f32 (f32_out 1); x [M, K] bf16; codes
// [N, K] int8; scale [N] f32; K a multiple of 16. bm: 16, 32, 64 or 128
// rows a CTA. n_splits ranges of split_len (a multiple of 64) along K,
// none empty; with n_splits > 1, `partials` is the f32 scratch [n_splits,
// M, N] and `counters` ceil(M / bm) * ceil(N / 128) int32 counters (all 0,
// left 0).
extern "C" int int8_matmul(void* out, const void* x, const void* codes, const void* scale,
                           void* partials, void* counters, int M, int N, int K, int bm,
                           int n_splits, int split_len, int f32_out, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 16 != 0 || n_splits < 1 || n_splits > 65535 || split_len <= 0 ||
      split_len % BK != 0 || (long long)(n_splits - 1) * split_len >= K)
    return (int)cudaErrorInvalidValue;
  if (n_splits > 1 && (partials == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bm <= 0 || (M + bm - 1) / bm > 65535) return (int)cudaErrorInvalidValue;
  const Args a{out, (const __nv_bfloat16*)x, (const int8_t*)codes, (const float*)scale,
               (float*)partials, (int*)counters, M, N, K, n_splits, split_len, f32_out != 0};
  cudaStream_t st = (cudaStream_t)stream;
  switch (bm) {
    case 16:
      return launch<16>(a, st);
    case 32:
      return launch<32>(a, st);
    case 64:
      return launch<64>(a, st);
    case 128:
      return launch<128>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
