// Grouped (ragged) GEMM of dropless MoE serving:
//   out[a, :] = xs[a, :] @ w[e(a)]      a in [0, A)
// xs [A, K] bf16 holds the expert-sorted assignment rows in contiguous
// segments, counts [X] int32 (on the device) their lengths, w [X, K, N]
// bf16 the expert weights (N contiguous); f32 accumulation, bf16 output.
// Rows past sum(counts) are left as the wrapper made them (zeros).
//
// Replaces no Pallas kernel. The JAX package runs this product as
// jax.lax.ragged_dot (deepspeed_tpu/moe/dropless.py:134 grouped_mm), which
// XLA lowers on the TPU; on the card only a hand-written kernel computes it
// without a host read of the segment sizes.
//
// Bound on the H100: bytes at decode (A = 16 rows against each active
// expert's K x N weights: ~2 operations a weight byte, far below the 295
// where the tensor cores bind), bytes or operations at prefill (A in the
// thousands: 2 A K N against one read of the active experts' weights).
// This first design is simple and right; wgmma fed by a TMA ring, and the
// groupwise int8 dequant fused into the loads, are later work (ROADMAP B8f):
// - One CTA of 4 warps computes a 64-row x 128-column tile of ONE segment
//   (rows of one expert) on the tensor cores, mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate), its fragments by ldmatrix (.trans for the weights,
//   which are [K][N], N contiguous); each warp owns 32 x 64 of the tile.
// - Segment offsets come from the device: thread 0 of every CTA scans
//   counts (X is small) and finds the segment and the row tile of its
//   blockIdx.x. The grid is sized by the bound ceil(A / 64) + X row tiles
//   (each segment's last tile may be partial) times ceil(N / 128) column
//   tiles, so the launch needs no host read and a CUDA graph captures it;
//   a CTA whose tile lies past the last segment exits. An empty segment
//   takes no tile. A count that would run past A is cut at A.
// - K advances 32 at a time through a 2-stage cp.async ring in shared
//   memory (16-byte copies; rows past the segment, k past K and columns
//   past N zero-filled, so the products mask nothing): the next stage
//   loads while the current one's products run. Rows are padded (40 and
//   136 bf16) so that the 8 rows an ldmatrix reads fall in 8 bank groups.
// - The epilogue rounds each f32 sum to bf16 and stores it from the
//   accumulator registers, two columns a store, rows of the segment and
//   columns below N only.
// K and N must be multiples of 8 (16-byte copies of whole chunks).
//
// Fault build (chip_smoke.py FAULT_BUILDS): DS_FAULT_SEGMENT_SHIFT starts
// segment 1 one row late, which the checks must catch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows a tile (one segment)
constexpr int BN = 128;       // columns a tile
constexpr int BK = 32;        // contraction a ring stage
constexpr int THREADS = 128;  // 4 warps, 2 x 2 over the tile, 32 x 64 each
constexpr int A_LD = BK + 8;  // row strides (bf16) of the two stages: 80 and
constexpr int B_LD = BN + 8;  // 272 bytes, so ldmatrix's 8 rows miss each other's banks
constexpr int A_STAGE = BM * A_LD;  // elements a stage
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM = 2 * (A_STAGE + B_STAGE) * 2;  // 27,648 B: no opt-in

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 (fill false) zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(__nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ xs,
                    const __nv_bfloat16* __restrict__ w, const int* __restrict__ counts,
                    int A, int K, int N, int X) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_expert, s_row0, s_row_end;
  const int tid = threadIdx.x;

  // -- which segment and which of its row tiles this CTA computes --------
  if (tid == 0) {
    const int t = blockIdx.x;
    int tiles_before = 0, off = 0, expert = -1, row0 = 0, row_end = 0;
    for (int e = 0; e < X; ++e) {
      int c = counts[e];
      c = c < 0 ? 0 : (c > A - off ? A - off : c);
      const int tiles = (c + BM - 1) / BM;
      if (t < tiles_before + tiles) {
        int seg = off;
#ifdef DS_FAULT_SEGMENT_SHIFT
        if (e == 1) seg += 1;  // planted fault: segment 1 starts one row late
#endif
        expert = e;
        row0 = seg + (t - tiles_before) * BM;
        row_end = seg + c < A ? seg + c : A;
        break;
      }
      tiles_before += tiles;
      off += c;
    }
    s_expert = expert;
    s_row0 = row0;
    s_row_end = row_end;
  }
  __syncthreads();
  const int expert = s_expert, row0 = s_row0, row_end = s_row_end;
  if (expert < 0 || row0 >= row_end) return;  // past the last segment: the whole CTA
  const int col0 = blockIdx.y * BN;
  const __nv_bfloat16* we = w + static_cast<size_t>(expert) * K * N;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + 2 * A_STAGE;

  auto load_stage = [&](int stage, int k0) {
    for (int c = tid; c < BM * BK / 8; c += THREADS) {  // xs: 64 rows x 4 chunks
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      const bool ok = gr < row_end && gk < K;
      cp_async16(sa + stage * A_STAGE + r * A_LD + kc,
                 ok ? xs + static_cast<size_t>(gr) * K + gk : xs, ok);
    }
    for (int c = tid; c < BK * BN / 8; c += THREADS) {  // w: 32 k x 16 chunks
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = col0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(sb + stage * B_STAGE + r * B_LD + nc,
                 ok ? we + static_cast<size_t>(gk) * N + gn : w, ok);
    }
  };

  const int lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;  // the warp's 32 x 64 of the tile
  // ldmatrix x4: lanes 0-15 address rows 0-15 of a 16 x 16 block at column 0,
  // lanes 16-31 the same rows at column 8 (A: a0-a3; B^T: b0, b1 of two n8 tiles)
  const int lrow = lane % 16, lcol = (lane / 16) * 8;
  float acc[2][8][4] = {};

  const int nk = (K + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();  // (an empty group on the last step)
    cp_async_wait<1>();  // stage kt has landed
    __syncthreads();
    const __nv_bfloat16* a = sa + (kt & 1) * A_STAGE;
    const __nv_bfloat16* b = sb + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t fa[2][4], fb[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(fa[i], a + (wm + i * 16 + lrow) * A_LD + kk + lcol);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x4_trans(fb[j], b + (kk + lrow) * B_LD + wn + j * 16 + lcol);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          mma(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
    }
    __syncthreads();  // the stage is free for the load two steps on
  }
  cp_async_wait<0>();

  // -- epilogue: lane holds rows g, g + 8 of each m16 tile, columns 2q, 2q + 1
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = col0 + wn + j * 8 + 2 * q;
      if (gn >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wm + i * 16 + g + 8 * h;
        if (gr < row_end)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(gr) * N + gn) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

}  // namespace

// out [A, N], xs [A, K], w [X, K, N] bf16; counts [X] int32; the stream.
// Returns the launch's cudaError_t.
extern "C" int grouped_gemm(void* out, const void* xs, const void* w, const void* counts, int A,
                            int K, int N, int X, void* stream) {
  if (A <= 0 || N <= 0 || X <= 0) return 0;
  const dim3 grid((A + BM - 1) / BM + X, (N + BN - 1) / BN);
  grouped_gemm_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(xs),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(counts), A, K, N, X);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
