// int8 KV quantizer of one [D] head slice, shared by the quantizing cache
// write (paged_kv_write.cu) and the fused int8 decode (paged_decode.cu) so
// that the two cannot drift apart.
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
//   code  = clamp(rint(x / scale), -127, 127)    (__fdiv_rn: the IEEE
//           division whatever the flags; rintf rounds half to even like
//           jnp.round / torch.round, where roundf would round ties away
//           from zero)
//
// Build without --use_fast_math and without -ftz=true: flushing denormals
// would turn the scale of a row whose amax is tiny into 0, and so into 1.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

constexpr float KV_QUANT_MAX = 127.f;
constexpr float KV_QUANT_INV = (float)(1.0 / 127.0);

// One warp quantizes one [32 * EPL] head slice: lane l holds elements
// l * EPL .. l * EPL + EPL - 1 in x. Writes their codes and returns the
// slice's scale (the same in every lane). A head dim that is no multiple
// of 32 (80: EPL = 3, 96 slots) pads the slots past D with zeros, which
// leave amax, and so the scale and every real code, unchanged; the caller
// never stores their codes.
template <int EPL>
__device__ __forceinline__ float kv_quant_slice(const float (&x)[EPL], int8_t (&code)[EPL]) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  float scale = amax * KV_QUANT_INV;
  scale = scale > 0.f ? scale : 1.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    code[e] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x[e], scale)), -KV_QUANT_MAX), KV_QUANT_MAX);
  return scale;
}
