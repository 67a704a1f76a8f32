// int8 KV quantizer, shared by the quantizing cache write
// (paged_kv_write.cu) and the fused int8 decode (paged_decode.cu) so that
// the two cannot drift apart.
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py _quant_row_kernel
// (inside _decode_kernel) and, on the write path, the XLA pass
// quantize_kv_rows. A token's codes must be bit-identical whichever path
// wrote them (prefill write, continuation write, fused decode), and
// bit-identical to the port's plain quantize_kv_rows, so every step is
// spelled to round exactly as XLA does:
//
//   amax  = max |x| over the D elements          (exact in any order)
//   scale = amax * float(1.0 / 127.0)            (a multiply by the f32 of
//           the double 1/127, never a division: the JAX package spells it
//           so because a compiler may turn a division by a constant into
//           this multiply in one program and not in another)
//   scale = scale > 0 ? scale : 1
//   code  = clamp(rint(x / scale), -127, 127)    (x / scale the correctly
//           rounded IEEE quotient; the conversion rounds half to even like
//           jnp.round / torch.round, where roundf would round ties away
//           from zero)
//
// The quotient: where the amax is finite and the scale lies in [2^-100,
// 2^100], y = RN(1/scale) once a slice, then q = RN(x * y) and
// RN(q + RN(x - q * scale) * y) with fmas, which is the correctly rounded
// x / scale (Markstein's theorem: y within half an ulp of 1/scale, q
// within one ulp of the quotient, no overflow; an underflowing quotient is
// far below the .5 that could move a code). Elsewhere (a subnormal or
// infinite scale, a NaN amax) __fdiv_rn, the IEEE division whatever the
// flags. The quantizer's whole domain is under 2^31 (x, amax) pairs of
// bf16 values; paged_kv_write.cu's kv_quant_check runs every one of them
// on the card through both routes and counts the codes that differ.
//
// NaN and inf, as jnp.max, jnp.round, jnp.clip and the cast to int8 give
// them: a NaN anywhere in a slice makes its amax NaN (the max is taken on
// the bits of |x|, where a NaN's lie above +inf's; fmaxf would drop it),
// so its scale is 1 (NaN > 0 is false); an element whose quotient is NaN
// (a NaN, or +-inf over an infinite scale) gets code 0, and a quotient of
// +-inf code +-127. A slice holding inf and no NaN thus has scale inf and
// every code 0.
//
// Build without --use_fast_math and without -ftz=true: flushing denormals
// would turn the scale of a row whose amax is tiny into 0, and so into 1.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

constexpr float KV_QUANT_INV = (float)(1.0 / 127.0);

// |x| as bits: for non-negative floats the order of the bits is the order
// of the values, and a NaN's bits are above +inf's, so the integer max of
// these is the bits of max |x|, NaN when any element is NaN, in any order
__device__ __forceinline__ uint32_t kv_abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// a slice's divisor: its scale, and where the short route holds (`ieee`
// false) the reciprocal it takes
struct KvScale {
  float scale;
  float rcp;
  bool ieee;
};

// the divisor of a slice whose max |x| has the bits amax_bits
__device__ __forceinline__ KvScale kv_scale(uint32_t amax_bits) {
  float scale = __uint_as_float(amax_bits) * KV_QUANT_INV;
  scale = scale > 0.f ? scale : 1.f;
  const bool ieee = amax_bits >= 0x7f800000u || !(scale >= 0x1p-100f && scale <= 0x1p100f);
  return {scale, __frcp_rn(ieee ? 1.f : scale), ieee};
}

// clamp(rint(q), -127, 127): cvt.rni.s32.f32 rounds half to even, takes
// NaN to 0 and saturates +-inf, so the clamp follows in integers
__device__ __forceinline__ int kv_round(float q) {
  return min(max(__float2int_rn(q), -127), 127);
}

// the code of x by the short route (s.ieee false): there the amax is
// finite and the scale normal, so |x| / scale <= 127 (1 + 2^-22) < 127.5
// (|x| <= amax, scale = amax / 127 to within two roundings): the code
// needs no clamp, and no quotient is NaN or infinite
__device__ __forceinline__ int kv_code_short(float x, const KvScale& s) {
  const float q = __fmul_rn(x, s.rcp);
  return __float2int_rn(__fmaf_rn(__fmaf_rn(-q, s.scale, x), s.rcp, q));
}

// the code of x by the IEEE division
__device__ __forceinline__ int kv_code_ieee(float x, float scale) {
  return kv_round(__fdiv_rn(x, scale));
}

// the codes of n elements of one slice, the route taken once for all
template <int N>
__device__ __forceinline__ void kv_codes(const float (&x)[N], const KvScale& s, int (&code)[N]) {
  if (s.ieee) {
#pragma unroll
    for (int e = 0; e < N; ++e) code[e] = kv_code_ieee(x[e], s.scale);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) code[e] = kv_code_short(x[e], s);
  }
}

// One warp quantizes one [32 * EPL] head slice: lane l holds elements
// l * EPL .. l * EPL + EPL - 1 in x. Writes their codes and returns the
// slice's scale (the same in every lane). A head dim that is no multiple
// of 32 (80: EPL = 3, 96 slots) pads the slots past D with zeros, which
// leave amax, and so the scale and every real code, unchanged; the caller
// never stores their codes.
template <int EPL>
__device__ __forceinline__ float kv_quant_slice(const float (&x)[EPL], int8_t (&code)[EPL]) {
  uint32_t amax = 0;
#pragma unroll
  for (int e = 0; e < EPL; ++e) amax = max(amax, kv_abs_bits(x[e]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const KvScale s = kv_scale(amax);
  int c[EPL];
  kv_codes(x, s, c);
#pragma unroll
  for (int e = 0; e < EPL; ++e) code[e] = (int8_t)c[e];
  return s.scale;
}
