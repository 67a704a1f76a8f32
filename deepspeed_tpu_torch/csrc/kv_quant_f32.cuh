// int8 KV quantizer for f32 rows, shared by the quantizing cache write of
// f32 rows (paged_kv_write_f32.cu) and the fused int8 decode with f32 q
// (paged_decode_f32.cu), so that a token's codes do not depend on which
// path wrote it.
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py quantize_kv_rows
// (:69-86) and _quant_row_kernel (:89-100) on f32 rows: the rule of
// kv_quant.cuh, with its amax on the bits of |x| (NaN kept) and the scale
// as a multiply by float(1/127). The quotient x / scale is always
// __fdiv_rn, the IEEE division: kv_quant.cuh's short route (a reciprocal
// and two fmas) was proved on the card by an exhaustive run over every
// pair of bf16 values, which does not cover f32 inputs, and the division
// is far from what bounds either kernel. So codes and scales are those of
// the plain quantize_kv_rows on f32 rows bit for bit, NaN, inf, subnormal
// and all-zero slices included, as kv_quant.cuh sets them out.

#pragma once

#include "kv_quant.cuh"

// the scale of a slice whose max |x| has the bits amax_bits: amax / 127 as
// a multiply, 1 where that is not > 0 (zero, or a NaN amax)
__device__ __forceinline__ float kv_scale_f32(uint32_t amax_bits) {
  const float scale = __fmul_rn(__uint_as_float(amax_bits), KV_QUANT_INV);
  return scale > 0.f ? scale : 1.f;
}

// One warp quantizes one [D] f32 head slice at src: lane l takes elements
// l + 32 e (neighbouring lanes on neighbouring addresses), zeros past D,
// which leave amax as it is. Fills x with the elements and code with their
// codes, and returns the slice's scale (the same in every lane).
template <int D>
__device__ __forceinline__ float kv_quant_warp_f32(const float* __restrict__ src, int lane,
                                                   float (&x)[(D + 31) / 32],
                                                   int (&code)[(D + 31) / 32]) {
  constexpr int EPL = (D + 31) / 32;
  uint32_t amax = 0;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane + 32 * e;
    x[e] = d < D ? src[d] : 0.f;
    amax = max(amax, kv_abs_bits(x[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = kv_scale_f32(amax);
#pragma unroll
  for (int e = 0; e < EPL; ++e) code[e] = kv_code_ieee(x[e], scale);
  return scale;
}
