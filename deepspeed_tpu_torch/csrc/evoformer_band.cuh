// The pair bias (bias2) as the evoformer kernels read it, shared by the
// forward (#7, evoformer_fwd.cu) and the backward's dq (#8) and dk/dv
// (#9, evoformer_bwd.cu): bias2 [B, 1, H, N, N] bf16 is the same for every
// sequence, so a CTA that walks a run of sequences keeps the part it needs
// (its band) in shared memory for the whole run, or, when the band would
// not fit, reads bias2 from device memory in the wgmma fragment layout.
#pragma once

#include "hopper.cuh"

namespace evo {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA may opt into
constexpr float LOG2E = 1.4426950408889634f;

// bias2 at (row r of the CTA's rows, columns c and c + 1) as a bf16 pair,
// read from device memory when no band is made (`rows` at the CTA's first
// row, row0): zeros past N, element loads (a row of odd N starts on any
// byte).
__device__ __forceinline__ uint32_t b2_global(const __nv_bfloat16* rows, int N, int row0, int r,
                                              int c) {
  if (row0 + r >= N) return 0u;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(rows) +
                            static_cast<size_t>(r) * N + c;
  const uint32_t lo = c < N ? __ldg(p) : 0u;
  const uint32_t hi = c + 1 < N ? __ldg(p + 1) : 0u;
  return lo | (hi << 16);
}

// A CTA's dynamic shared memory: its band of `rows` x band_ld bf16 from
// byte band_off (band_ld 0: none), and the slack that aligns the base.
inline long long band_smem(int band_off, int rows, int band_ld) {
  return band_off + static_cast<long long>(rows) * band_ld * 2 + 1024;
}

// The band's row stride in elements: N padded to whole `tile`s (a multiple
// of 64) plus 8, i.e. 8 mod 64 elements (16 mod 128 bytes), so the
// fragment reads of a band row pair (rows lr and lr + 8 of a warp, lr =
// lane / 4; a 32-bit word at column 8j + 2 (lane % 4)) hit 32 distinct
// banks (word (r ld + c) / 2 with ld / 2 = 4 mod 32: 4 r + lane % 4 over r
// < 8), and every row starts 16-byte aligned. 0 when no band is made: no
// bias2, or `rows` rows of it would not fit above `band_off` bytes.
inline int band_stride(int N, bool has_b2, int tile, int rows, int band_off) {
  const int ld = (N + tile - 1) / tile * tile + 8;
  return has_b2 && band_smem(band_off, rows, ld) <= SMEM_LIMIT ? ld : 0;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// A CTA's band of ROWS rows: bias2 rows q0 .. q0 + ROWS - 1 of its (b, h)
// (`src` at the (b, h) matrix), columns 0 .. band_ld - 1, zeros past N.
// Asynchronous 16-byte copies where every row starts 16-byte aligned
// (N % 8 == 0 and an aligned base; the caller waits), element loads
// otherwise. THREADS threads share the copies.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_band(__nv_bfloat16* band, int band_ld,
                                          const __nv_bfloat16* src, int q0, int N) {
  if (N % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vpr = band_ld / 8;
    for (int x = threadIdx.x; x < ROWS * vpr; x += THREADS) {
      const int r = x / vpr;
      const int c = (x % vpr) * 8;
      const bool live = q0 + r < N && c < N;
      cp_async16(smem_u32(band + r * band_ld + c),
                 live ? src + static_cast<size_t>(q0 + r) * N + c : src, live);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int x = threadIdx.x; x < ROWS * band_ld; x += THREADS) {
      const int r = x / band_ld;
      const int c = x % band_ld;
      band[x] = q0 + r < N && c < N ? src[static_cast<size_t>(q0 + r) * N + c]
                                    : __float2bfloat16(0.f);
    }
  }
}

}  // namespace evo
