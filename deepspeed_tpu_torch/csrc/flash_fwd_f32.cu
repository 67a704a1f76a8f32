// Causal flash-attention forward in f32 (FlashAttention online softmax)
// over q [B, S, H, D] and k, v [B, S, KV, D], writing o [B, S, H, D] in f32
// and the row logsumexp lse [B, H, S]: the prefill attention of an f32
// serving engine.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py _flash_fwd
// (_fwd_kernel, :233) where q is f32: the JAX kernel takes q's dtype
// (:244), so an f32 engine's prefill computes its products in f32. Modes:
// causal, sliding window, ALiBi, any whole GQA group, head dims 64, 80,
// 96, 128 and 256 (flash_fwd.cu's semantics, set out there). The backward
// has no f32 kernel yet: the wrapper refuses f32 inputs that need a
// gradient before any launch.
//
// Bound on the H100: 4 * D operations per live (query, key) pair per head
// against 4 * S * (2 H + 2 KV) * D bytes, about S / 8 operations a byte at
// D 128: operations bind from a few hundred tokens on. Single-pass TF32
// on the tensor cores keeps ~3 decimal digits, too few for an f32 mode
// held to the f32 plain version, and 3xTF32 would be a design of its own;
// this first f32 kernel is plain FFMA on the CUDA cores (67 TF/s of f32):
//
// - One CTA takes 64 query rows of one (batch, q head), 256 threads as a
//   16 x 16 grid: thread (ty, tx) holds the score tile's rows ty + 16 i
//   and columns tx + 16 j (i, j < 4), and the output's rows ty + 16 i and
//   columns tx + 16 n (n < D / 16), all in registers.
// - Q stays in shared memory; K and V tiles of 64 keys arrive by cp.async
//   (16-byte copies, rows past S zero-filled), K of the next tile loaded
//   while this tile's softmax and P V run, V of the next while the next
//   scores run. Q and K rows are padded to D + 4 floats, so the float4
//   reads of 8 neighbouring rows fall on 8 different bank quads.
// - S = Q K^T and O += P V by fmaf, P through shared memory. The online
//   softmax in f32 with expf, the row max and sum across the 16 threads of
//   a row by shuffles; a dead column set to -inf by a select; the score s
//   * scale + slope * (c - r) (ALiBi after the scale, before the mask).
// - lse = m + log(l); o = O / l; rows past S write nothing. No atomics:
//   two launches on the same inputs give the same bits.
//
// The window (window > 0: row r sees c iff r - window < c <= r) starts the
// key-tile loop at the band's first tile; any window >= S is run as 0, so
// the result is the causal one bit for bit. Null slopes run the same code
// with slope 0: zero slopes give the result without ALiBi bit for bit.
//
// Planted faults (defined only in chip_smoke.py's fault builds):
// DS_FAULT_TF32 rounds the operands of every product (Q and K, P and V) to
// TF32 first, as single-pass TF32 tensor-core products would;
// DS_FAULT_DIAG_UNMASKED takes the diagonal tile without its causal mask.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows a CTA
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads: 16 x 16
constexpr int RPT = 4;   // rows a thread: ty + 16 i
constexpr int CPT = 4;   // score columns a thread: tx + 16 j

template <int D>
struct Geo {
  static constexpr int LDQ = D + 4;     // Q and K rows (floats)
  static constexpr int LDV = D;         // V rows: a warp reads 16 consecutive floats of one
  static constexpr int LDP = BK + 4;    // P rows
  static constexpr int NCOL = D / 16;   // output columns a thread
  static constexpr int K_OFF = BQ * LDQ;
  static constexpr int V_OFF = K_OFF + BK * LDQ;
  static constexpr int P_OFF = V_OFF + BK * LDV;
  static constexpr int BYTES = (P_OFF + BQ * LDP) * 4;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
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

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a product's operand: itself, or in the planted fault's build its TF32
// rounding (10 mantissa bits, as single-pass TF32 tensor cores take it)
__device__ __forceinline__ float op(float x) {
#ifdef DS_FAULT_TF32
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
#else
  return x;
#endif
}

// 64 rows of D floats from src (row r at src + (row0 + r) * stride) into
// dst (row stride ld); rows at or past n_rows zero-filled
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long stride,
                                          int row0, int n_rows) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * ld + c * 4, src + (ok ? (row0 + r) * stride + c * 4 : 0), ok);
  }
}

// max and sum over the 16 threads of a row (tx: lane bits 0-3)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (ceil(S / 64), H, B)
template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(float* __restrict__ o, float* __restrict__ lse, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ slopes, int S, int H, int KV, int window,
                     float scale) {
  using G = Geo<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + G::K_OFF;
  float* Vs = smem + G::V_OFF;
  float* Ps = smem + G::P_OFF;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;
  const float* qb = q + ((long long)b * S * H + h) * D;
  const float* kb = k + ((long long)b * S * KV + h / (H / KV)) * D;
  const float* vb = v + ((long long)b * S * KV + h / (H / KV)) * D;
  const float slope = slopes ? slopes[h] : 0.f;
  const int t_lo = window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int t_hi = min(q0 + BQ - 1, S - 1) / BK;  // the diagonal tile

  load_rows<D>(Qs, G::LDQ, qb, qstride, q0, S);
  load_rows<D>(Ks, G::LDQ, kb, kstride, t_lo * BK, S);
  cp_async_commit();
  load_rows<D>(Vs, G::LDV, vb, kstride, t_lo * BK, S);
  cp_async_commit();

  float acc[RPT][G::NCOL];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < G::NCOL; ++n) acc[i][n] = 0.f;
  }

#pragma unroll 1
  for (int t = t_lo; t <= t_hi; ++t) {
    cp_async_wait1();  // Q and this tile's K (its V may be in flight)
    __syncthreads();
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[RPT], kk[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * G::LDQ + d);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * G::LDQ + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(op(qa[i].x), op(kk[j].x), s[i][j]);
          s[i][j] = fmaf(op(qa[i].y), op(kk[j].y), s[i][j]);
          s[i][j] = fmaf(op(qa[i].z), op(kk[j].z), s[i][j]);
          s[i][j] = fmaf(op(qa[i].w), op(kk[j].w), s[i][j]);
        }
    }
    __syncthreads();  // every thread is done with Ks
    if (t < t_hi) load_rows<D>(Ks, G::LDQ, kb, kstride, (t + 1) * BK, S);
    cp_async_commit();

    const int c0 = t * BK;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = c0 + tx + 16 * j;
        const float x = s[i][j] * scale + slope * (float)(c - r);
        bool vis = window <= 0 || c > r - window;
#ifdef DS_FAULT_DIAG_UNMASKED  // defined only in a planted fault's build (chip_smoke.py)
        vis = vis && (t == t_hi || c <= r);
#else
        vis = vis && c <= r;
#endif
        s[i][j] = vis ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live column yet
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        psum += s[i][j];
        Ps[(ty + 16 * i) * G::LDP + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < G::NCOL; ++n) acc[i][n] *= corr;
    }
    cp_async_wait1();  // this tile's V (the next K may be in flight)
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p4[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * G::LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[G::NCOL];
#pragma unroll
        for (int n = 0; n < G::NCOL; ++n) vv[n] = op(Vs[(c + cc) * G::LDV + tx + 16 * n]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float p = op(cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w);
#pragma unroll
          for (int n = 0; n < G::NCOL; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
        }
      }
    }
    __syncthreads();  // every thread is done with Vs and Ps
    if (t < t_hi) load_rows<D>(Vs, G::LDV, vb, kstride, (t + 1) * BK, S);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    float* orow = o + (((long long)b * S + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < G::NCOL; ++n) orow[tx + 16 * n] = acc[i][n] / l[i];
    if (tx == 0) lse[((long long)b * H + h) * S + r] = m[i] + logf(l[i]);
  }
}

template <int D>
int dispatch(void* o, void* lse, const void* q, const void* k, const void* v, const void* slopes,
             int B, int S, int H, int KV, int window, float scale, cudaStream_t st) {
  using G = Geo<D>;
  static int attr_device = -1;  // the device whose shared memory cap was last set
  int dev = 0;
  cudaGetDevice(&dev);
  if (attr_device != dev) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
    if (e != cudaSuccess) return (int)e;
    attr_device = dev;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, NT, G::BYTES, st>>>(
      (float*)o, (float*)lse, (const float*)q, (const float*)k, (const float*)v,
      (const float*)slopes, S, H, KV, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// As flash_fwd (flash_fwd.cu) on f32 q, k, v and o.
extern "C" int flash_fwd_f32(void* o, void* lse, const void* q, const void* k, const void* v,
                             const void* slopes, int B, int S, int H, int KV, int D, int window,
                             float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;  // the causal band: the same result
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return dispatch<64>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 80:
      return dispatch<80>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 96:
      return dispatch<96>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 128:
      return dispatch<128>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    case 256:
      return dispatch<256>(o, lse, q, k, v, slopes, B, S, H, KV, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ds_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
