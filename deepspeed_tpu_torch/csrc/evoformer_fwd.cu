// Evoformer (DS4Sci) attention forward: softmax(q k^T / sqrt(D) + bias1 +
// bias2) v with an online softmax over key tiles, writing o and the row
// logsumexp lse for the backward.
//
//   q, k, v, o  [B, S, N, H, D] bf16 (batch, sequences, residues, heads)
//   bias1       [B, S, 1, 1, N] bf16 or absent: one bias per key (the MSA
//               mask), shared by every query and head of a sequence
//   bias2       [B, 1, H, N, N] bf16 or absent: the pair bias, shared by
//               every sequence
//   lse         [G, N] f32 with G = B * S * H in (b, s, h) order
//
// Replaces: deepspeed_tpu/ops/pallas/evoformer_attention.py _evo_kernel
// (the pallas_call of evoformer_flash_fwd at :139).
//
// Bound on the H100: at D = 32 the call does 4 N^2 D operations per slice
// against about 8 N D bytes of q, k, v and o, i.e. about N / 2 operations
// per byte: below the card's ~295 at every N the model uses, so the kernel
// is bound by the bytes it must move (q, k, v, o, the biases and lse), not
// by the tensor cores. The design keeps every N x N quantity (scores,
// probabilities) out of device memory, which is what the op exists for:
// each block owns 64 query rows of one (b, s, h) slice, keeps them in
// shared memory and streams 64-key tiles of K, V, bias1 and bias2 past
// them. Products run on the tensor cores through WMMA (bf16 in, f32
// accumulate); the running max, sum and output stay in f32; P is rounded
// to bf16 before P V as the TPU kernel rounds it. q, k and v are read in
// place in their [B, S, N, H, D] layout: no transposed copy is made. Each
// tile arrives by cp.async, all of a thread's copies in flight at once;
// the softmax pass gives each row 8 lanes, so a warp's 16 rows take 4
// passes. Simple first: WMMA instead of wgmma, and no load pipeline (TMA,
// double buffering), are left for a later PR.
//
// Grid (G, ceil(N / 64)), 4 warps. The TPU kernel's key grid axis, run in
// order with the accumulators in VMEM, is the loop inside the block here.
// A ragged last tile is masked: keys past N get probability 0, rows past
// N are not stored.

#include "evoformer_common.cuh"

namespace {

using namespace evo;

template <int D>
struct Layout {
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + tile_bytes<D>();
  static constexpr size_t V = K + tile_bytes<D>();
  static constexpr size_t SC = V + tile_bytes<D>();
  static constexpr size_t P = SC + SCORE_BYTES;
  static constexpr size_t O = P + P_BYTES;  // f32 output accumulator, stride ldo<D>()
  static constexpr size_t B2 = O + al((size_t)BT * ldo<D>() * 4);
  static constexpr size_t B1 = B2 + BIAS2_BYTES;
  static constexpr size_t M = B1 + ROW_BYTES;
  static constexpr size_t L = M + ROW_BYTES;
  static constexpr size_t BYTES = L + ROW_BYTES;
};

template <int D>
__global__ void __launch_bounds__(NT) evo_fwd_kernel(
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ bias1, const __nv_bfloat16* __restrict__ bias2, int S,
    int N, int H, float scale) {
  using Lay = Layout<D>;
  constexpr int LDH = ldh<D>();
  constexpr int LDO = ldo<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Q);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + Lay::K);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + Lay::V);
  float* ss = reinterpret_cast<float*>(smem + Lay::SC);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + Lay::P);
  float* os = reinterpret_cast<float*>(smem + Lay::O);
  __nv_bfloat16* b2s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::B2);
  float* b1s = reinterpret_cast<float*>(smem + Lay::B1);
  float* m_s = reinterpret_cast<float*>(smem + Lay::M);
  float* l_s = reinterpret_cast<float*>(smem + Lay::L);

  const int g = blockIdx.x;  // (b, s, h)
  const int bs = g / H;      // b * S + s
  const int h = g % H;
  const int q0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16;
  const int lane = tid & 31;
  const size_t row = (size_t)H * D;  // elements between two residues of a slice
  const size_t off = slice_offset<D>(g, N, H);
  const bool has_b1 = bias1 != nullptr;
  const bool has_b2 = bias2 != nullptr;
  const __nv_bfloat16* b1row = has_b1 ? bias1 + (size_t)bs * N : nullptr;
  const __nv_bfloat16* b2mat = has_b2 ? bias2 + ((size_t)(bs / S) * H + h) * N * N : nullptr;

  load_tile<D>(qs, q + off, row, q0, N, tid);
  for (int i = tid; i < BT * D; i += NT) os[(i / D) * LDO + i % D] = 0.f;
  if (tid < BT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int n_tiles = (N + BT - 1) / BT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // Q/O init visible; the previous tile's reads done
    load_tile<D>(ks, k + off, row, k0, N, tid);
    load_tile<D>(vs, v + off, row, k0, N, tid);
    if (has_b2) load_bias_tile(b2s, b2mat, q0, k0, N, tid);
    if (has_b1) load_row(b1s, b1row, k0, N, tid);
    wait_loads();
    __syncthreads();

    rows_times_rows_t<D>(ss + r0 * LDS, qs + r0 * LDH, ks);  // S_w = Q_w K^T
    __syncwarp();

    // online softmax over this warp's 16 rows, 4 rows a pass: lanes 8j..8j+7
    // share row rr + j, each owning 8 consecutive columns
    const int sub = lane >> 3;
    const int c0 = (lane & 7) * 8;
    for (int rr = 0; rr < 16; rr += 4) {
      const int r = r0 + rr + sub;
      float x[8];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + e;
        x[e] = k0 + c < N ? logit(ss[r * LDS + c], scale, has_b1, b1s[c], has_b2,
                                  b2s[r * LDB + c])
                          : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, group8_max(mx));
      float sum = 0.f, corr = 1.f;
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float p0 = 0.f, p1 = 0.f;
        if (m_new != -INFINITY) {
          p0 = expf(x[e] - m_new);
          p1 = expf(x[e + 1] - m_new);
        }
        sum += p0 + p1;
        __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
        packed[e / 2] = *reinterpret_cast<uint32_t*>(&pp);
      }
      if (m_new != -INFINITY) corr = expf(m_old - m_new);
      sum = group8_sum(sum);
      *reinterpret_cast<uint4*>(ps + r * LDP + c0) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      for (int d = lane & 7; d < D; d += 8) os[r * LDO + d] *= corr;
      if ((lane & 7) == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncwarp();

    // O_w += P_w V, the accumulator kept in shared memory between tiles
    // for the per-row rescaling above
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      AccFrag oacc;
      wmma::load_matrix_sync(oacc, os + r0 * LDO + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ps + r0 * LDP + kk, LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(bv, vs + kk * LDH + n * 16, LDH);
        wmma::mma_sync(oacc, a, bv, oacc);
      }
      wmma::store_matrix_sync(os + r0 * LDO + n * 16, oacc, LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // o = acc / l and lse = m + log(l), with the TPU kernel's guard for l == 0
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    const int qi = q0 + r;
    if (qi >= N) break;
    const float l = l_s[r] == 0.f ? 1.f : l_s[r];
    __nv_bfloat16* orow = o + off + (size_t)qi * row;
    for (int d = lane; d < D; d += 32) orow[d] = __float2bfloat16(os[r * LDO + d] / l);
    if (lane == 0) lse[(size_t)g * N + qi] = m_s[r] + logf(l);
  }
}

template <int D>
int launch(void* o, void* lse, const void* q, const void* k, const void* v, const void* b1,
           const void* b2, int B, int S, int N, int H, float scale, cudaStream_t stream) {
  const int smem = (int)Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(evo_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * S * H, (N + BT - 1) / BT);
  evo_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      (__nv_bfloat16*)o, (float*)lse, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)b1, (const __nv_bfloat16*)b2, S, N, H,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// b1 / b2 may be NULL (the bias is absent).
extern "C" int evoformer_fwd(void* o, void* lse, const void* q, const void* k, const void* v,
                             const void* b1, const void* b2, int B, int S, int N, int H, int D,
                             float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || H <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<32>(o, lse, q, k, v, b1, b2, B, S, N, H, scale, st);
    case 64:
      return launch<64>(o, lse, q, k, v, b1, b2, B, S, N, H, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
