// Evoformer (DS4Sci) attention backward, recomputing the probabilities
// from the forward's logsumexp: P = exp(q k^T * scale + bias1 + bias2 -
// lse), dS = P (dO v^T - delta) with delta = rowsum(dO * O). Two
// kernels, over the layout of evoformer_common.cuh:
//
//   evo_bwd_dq   dq = dS k * scale
//   evo_bwd_dkv  dk = dS^T q * scale, dv = P^T dO, and dsum [G, N] f32 =
//                the sum of dS over queries for each key (bias1's gradient
//                is its sum over heads, taken outside the kernels)
//
// bias2's gradient, the sum of dS over the sequences, is kernel #10 in
// evoformer_db2.cu.
//
// Replaces: deepspeed_tpu/ops/pallas/evoformer_attention.py
// _evo_bwd_dq_kernel (the pallas_call at :310) and _evo_bwd_dkv_kernel
// (:347).
//
// Bound on the H100: as the forward, about N / 2 operations per byte at
// D = 32, so both are bound by the bytes they must move. Every N x N
// quantity (scores, P, dP, dS) stays out of device memory: 64 x 64 tiles
// of S, dP (f32) and P or dS (bf16) live in shared memory, products run on
// the tensor cores through WMMA (bf16 in, f32 accumulate), and P and dS
// are rounded to bf16 before their products as the TPU kernels round them
// (dS unscaled; the scale multiplies the finished dq and dk). The row sums
// of dS (for bias1) add the unrounded f32 dS. Inputs are read in
// place in [B, S, N, H, D]: no transposed copy is made. Simple first, as
// the forward: WMMA, and tiles by cp.async without a load pipeline.
//
// Grids. On the TPU each kernel ran one grid axis in order with VMEM
// accumulators; here that axis is a loop inside one block, so no sum
// crosses blocks, no atomics are used and two runs give the same bits.
//   dq:  (G, ceil(N / 64)); the block owns 64 query rows and walks the key
//        tiles, dq in WMMA accumulator fragments.
//   dkv: (G, ceil(N / 64)); the block owns 64 key rows and walks the query
//        tiles, dk and dv in fragments, the row sums in registers.
// Both read bias2 tile by tile once per sequence (G N^2 2 bytes of L2
// traffic each, 1.21 GB at S 512, N 384, H 8). 4 warps; warp w owns rows
// 16w..16w+15 of the block's tile, so the element-wise passes need only
// warp-level synchronisation. Ragged tiles are masked: P = 0 past N, rows
// past N are not stored.

#include "evoformer_common.cuh"

namespace {

using namespace evo;

// Shared-memory layout, the same for the two kernels.
template <int D>
struct Layout {
  static constexpr size_t T0 = 0;                       // dq: Q  | dkv: K
  static constexpr size_t T1 = T0 + tile_bytes<D>();    // dq: dO | dkv: V
  static constexpr size_t T2 = T1 + tile_bytes<D>();    // dq: K  | dkv: Q
  static constexpr size_t T3 = T2 + tile_bytes<D>();    // dq: V  | dkv: dO
  static constexpr size_t S1 = T3 + tile_bytes<D>();    // f32 S (dkv: S^T)
  static constexpr size_t S2 = S1 + SCORE_BYTES;        // f32 dP (dkv: dP^T, then dS^T)
  static constexpr size_t P = S2 + SCORE_BYTES;         // bf16 dS (dkv: P^T, then dS^T)
  static constexpr size_t B2 = P + P_BYTES;             // bf16 bias2 tile [query][key]
  static constexpr size_t B1 = B2 + BIAS2_BYTES;        // f32 bias1 for the tile's keys
  static constexpr size_t LSE = B1 + ROW_BYTES;
  static constexpr size_t DELTA = LSE + ROW_BYTES;
  static constexpr size_t BYTES = DELTA + ROW_BYTES;
  // the f32 staging tile of an output (64 x ldo<D>()) reuses two adjacent
  // 64 x D tiles
  static_assert((size_t)BT * ldo<D>() * 4 <= 2 * tile_bytes<D>(), "staging tile does not fit");
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* b1;  // NULL when absent
  const __nv_bfloat16* b2;  // NULL when absent
  const __nv_bfloat16* dout;
  const float* lse;
  const float* delta;
  int S, N, H;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(NT) evo_bwd_dq_kernel(__nv_bfloat16* __restrict__ dq,
                                                        const Args a) {
  using Lay = Layout<D>;
  constexpr int LDH = ldh<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T0);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T1);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T2);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T3);
  float* ss = reinterpret_cast<float*>(smem + Lay::S1);
  float* dps = reinterpret_cast<float*>(smem + Lay::S2);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  __nv_bfloat16* b2s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::B2);
  float* b1s = reinterpret_cast<float*>(smem + Lay::B1);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::DELTA);

  const int N = a.N;
  const int g = blockIdx.x;
  const int bs = g / a.H;
  const int h = g % a.H;
  const int q0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16;
  const int lane = tid & 31;
  const size_t row = (size_t)a.H * D;
  const size_t off = slice_offset<D>(g, N, a.H);
  const bool has_b1 = a.b1 != nullptr;
  const bool has_b2 = a.b2 != nullptr;
  const __nv_bfloat16* b1row = has_b1 ? a.b1 + (size_t)bs * N : nullptr;
  const __nv_bfloat16* b2mat =
      has_b2 ? a.b2 + ((size_t)(bs / a.S) * a.H + h) * N * N : nullptr;

  load_tile<D>(qs, a.q + off, row, q0, N, tid);
  load_tile<D>(dos, a.dout + off, row, q0, N, tid);
  load_row(lse_s, a.lse + (size_t)g * N, q0, N, tid);
  load_row(delta_s, a.delta + (size_t)g * N, q0, N, tid);
  AccFrag acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int n_tiles = (N + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // Q/dO/lse/delta visible; the previous tile's reads done
    load_tile<D>(ks, a.k + off, row, k0, N, tid);
    load_tile<D>(vs, a.v + off, row, k0, N, tid);
    if (has_b2) load_bias_tile(b2s, b2mat, q0, k0, N, tid);
    if (has_b1) load_row(b1s, b1row, k0, N, tid);
    wait_loads();
    __syncthreads();

    rows_times_rows_t<D>(ss + r0 * LDS, qs + r0 * LDH, ks);    // S = Q K^T
    rows_times_rows_t<D>(dps + r0 * LDS, dos + r0 * LDH, vs);  // dP = dO V^T
    __syncwarp();

    // P = exp(logit - lse) on live (row, col); dS = P (dP - delta), in bf16
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const bool live_row = q0 + r < N;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f;
        if (live_row && k0 + c < N)
          p = expf(logit(ss[r * LDS + c], a.scale, has_b1, b1s[c], has_b2, b2s[r * LDB + c]) -
                   lse_s[r]);
        dss[r * LDP + c] = __float2bfloat16(p * (dps[r * LDS + c] - delta_s[r]));
      }
    }
    __syncwarp();
    accumulate<D>(acc, dss + r0 * LDP, ks);  // dQ += dS K
  }
  __syncthreads();  // every warp is done with Q/dO before staging overwrites them
  write_rows<D>(dq + off, row, reinterpret_cast<float*>(smem + Lay::T0), acc, a.scale, r0, q0,
                N, lane);
}

template <int D>
__global__ void __launch_bounds__(NT) evo_bwd_dkv_kernel(__nv_bfloat16* __restrict__ dk,
                                                         __nv_bfloat16* __restrict__ dv,
                                                         float* __restrict__ dsum,
                                                         const Args a) {
  using Lay = Layout<D>;
  constexpr int LDH = ldh<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T0);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T1);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T2);
  __nv_bfloat16* dos = reinterpret_cast<__nv_bfloat16*>(smem + Lay::T3);
  float* sts = reinterpret_cast<float*>(smem + Lay::S1);
  float* dpts = reinterpret_cast<float*>(smem + Lay::S2);
  __nv_bfloat16* pts = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  __nv_bfloat16* b2s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::B2);
  float* b1s = reinterpret_cast<float*>(smem + Lay::B1);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + Lay::DELTA);

  const int N = a.N;
  const int g = blockIdx.x;
  const int bs = g / a.H;
  const int h = g % a.H;
  const int k0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16;
  const int lane = tid & 31;
  const size_t row = (size_t)a.H * D;
  const size_t off = slice_offset<D>(g, N, a.H);
  const bool has_b1 = a.b1 != nullptr;
  const bool has_b2 = a.b2 != nullptr;
  const __nv_bfloat16* b2mat =
      has_b2 ? a.b2 + ((size_t)(bs / a.S) * a.H + h) * N * N : nullptr;
  const float* lse_g = a.lse + (size_t)g * N;
  const float* delta_g = a.delta + (size_t)g * N;

  load_tile<D>(ks, a.k + off, row, k0, N, tid);
  load_tile<D>(vs, a.v + off, row, k0, N, tid);
  if (has_b1) load_row(b1s, a.b1 + (size_t)bs * N, k0, N, tid);  // the block's keys
  AccFrag dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  float row_sum = 0.f;  // lane l < 16: the dS row sum of key row r0 + l

  const int n_tiles = (N + BT - 1) / BT;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * BT;
    __syncthreads();  // K/V/bias1 visible; the previous tile's reads done
    load_tile<D>(qs, a.q + off, row, q0, N, tid);
    load_tile<D>(dos, a.dout + off, row, q0, N, tid);
    if (has_b2) load_bias_tile(b2s, b2mat, q0, k0, N, tid);
    load_row(lse_s, lse_g, q0, N, tid);
    load_row(delta_s, delta_g, q0, N, tid);
    wait_loads();
    __syncthreads();

    rows_times_rows_t<D>(sts + r0 * LDS, ks + r0 * LDH, qs);    // S^T = K Q^T
    rows_times_rows_t<D>(dpts + r0 * LDS, vs + r0 * LDH, dos);  // dP^T = V dO^T
    __syncwarp();

    // P^T (bf16, for dV) and dS^T (f32, in place of dP^T); row r is key
    // k0 + r, column c is query q0 + c (the bias2 tile is read transposed)
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const bool live_key = k0 + r < N;
      float part = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f;
        if (live_key && q0 + c < N)
          p = expf(logit(sts[r * LDS + c], a.scale, has_b1, b1s[r], has_b2, b2s[c * LDB + r]) -
                   lse_s[c]);
        pts[r * LDP + c] = __float2bfloat16(p);
        float* dpt = dpts + r * LDS + c;
        const float ds = p * (*dpt - delta_s[c]);
        *dpt = ds;
        part += ds;
      }
      const float total = warp_sum(part);
      if (lane == rr) row_sum += total;
    }
    __syncwarp();
    accumulate<D>(dv_acc, pts + r0 * LDP, dos);  // dV += P^T dO
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        pts[r * LDP + c] = __float2bfloat16(dpts[r * LDS + c]);
      }
    }
    __syncwarp();
    accumulate<D>(dk_acc, pts + r0 * LDP, qs);  // dK += dS^T Q
  }
  if (lane < 16 && k0 + r0 + lane < N) dsum[(size_t)g * N + k0 + r0 + lane] = row_sum;
  __syncthreads();  // every warp is done with Q/dO before staging overwrites them
  float* stage = reinterpret_cast<float*>(smem + Lay::T2);
  write_rows<D>(dk + off, row, stage, dk_acc, a.scale, r0, k0, N, lane);
  write_rows<D>(dv + off, row, stage, dv_acc, 1.f, r0, k0, N, lane);
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_dq(void* dq, const Args& a, int B, cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  int err = prepare(evo_bwd_dq_kernel<D>, smem);
  if (err) return err;
  dim3 grid(B * a.S * a.H, (a.N + BT - 1) / BT);
  evo_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>((__nv_bfloat16*)dq, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(void* dk, void* dv, void* dsum, const Args& a, int B, cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  int err = prepare(evo_bwd_dkv_kernel<D>, smem);
  if (err) return err;
  dim3 grid(B * a.S * a.H, (a.N + BT - 1) / BT);
  evo_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>((__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
                                                    (float*)dsum, a);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* b1, const void* b2,
               const void* dout, const void* lse, const void* delta, int S, int N, int H,
               float scale) {
  return Args{(const __nv_bfloat16*)q,    (const __nv_bfloat16*)k,
              (const __nv_bfloat16*)v,    (const __nv_bfloat16*)b1,
              (const __nv_bfloat16*)b2,   (const __nv_bfloat16*)dout,
              (const float*)lse,          (const float*)delta,
              S, N, H, scale};
}

}  // namespace

// In both: b1 / b2 may be NULL (the bias is absent).
extern "C" int evoformer_bwd_dq(void* dq, const void* q, const void* k, const void* v,
                                const void* b1, const void* b2, const void* dout,
                                const void* lse, const void* delta, int B, int S, int N, int H,
                                int D, float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  const Args a = make_args(q, k, v, b1, b2, dout, lse, delta, S, N, H, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch_dq<32>(dq, a, B, st);
    case 64:
      return launch_dq<64>(dq, a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int evoformer_bwd_dkv(void* dk, void* dv, void* dsum, const void* q, const void* k,
                                 const void* v, const void* b1, const void* b2,
                                 const void* dout, const void* lse, const void* delta, int B,
                                 int S, int N, int H, int D, float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  const Args a = make_args(q, k, v, b1, b2, dout, lse, delta, S, N, H, scale);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch_dkv<32>(dk, dv, dsum, a, B, st);
    case 64:
      return launch_dkv<64>(dk, dv, dsum, a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
