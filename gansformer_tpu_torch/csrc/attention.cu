// Bipartite attention, both directions, over heads folded into the batch:
// out = softmax(q k^T / sqrt(D)) v with fp32 logits, max, exp and sums.
//
// grid_to_latent  (replaces gansformer_tpu/ops/pallas_attention.py
//   _grid_to_latent_kernel via _grid_to_latent_fwd): q [B, n, D] grid rows,
//   k/v [B, L, D|Dv] with L <= 64 latents.  The softmax axis is the tiny L,
//   so every grid row is independent: one block stages K and V of one batch
//   entry in shared memory (fp32, opted in above 48 KB) and each warp walks
//   query rows, keeping its logits in registers (one per lane) and its
//   probabilities in a per-warp smem row.  Probabilities are rounded to the
//   value dtype before the mix, as the reference casts them.
//   Bound: bytes (q read once, out written once; ~2*L*(D+Dv) flops a row).
//
// latent_to_grid  (replaces _latent_to_grid_kernel via _latent_to_grid_fwd):
//   q [B, L, D] latents, k/v [B, n, D|Dv], softmax over the long n axis.  The
//   TPU carries the online-softmax state (m, s, acc) across a sequential
//   grid; Hopper blocks run in no order, so n is split into chunks: each
//   block writes a partial (m, s, acc[L, Dv]) in fp32 for its chunk, and a
//   second small kernel combines the partials.  Bound: bytes (k and v read
//   once).
//
// Both forwards take an optional fp32 ``lse`` [B, Lq] output, the row
// statistic max + log(denominator) that the backward kernels
// (attention_bwd.cu) rebuild P from.  With a null pointer nothing is
// written: the serving path passes null, as the TPU's no-grad path declares
// no lse output.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxL = 64;       // latents a grid row attends to
constexpr int kWarps = 8;       // warps per block
constexpr int kG2LRows = 128;   // grid rows per grid_to_latent block
constexpr int kChunk = 256;     // key rows per latent_to_grid block

template <typename T>
__global__ void __launch_bounds__(256)
    g2l_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int n, int L, int D, int Dv,
               float scale) {
  extern __shared__ float sm[];
  float* Ks = sm;                       // [L, D]
  float* Vs = Ks + L * D;               // [L, Dv]
  float* Qs = Vs + L * Dv;              // [kWarps, D]
  float* Ps = Qs + kWarps * D;          // [kWarps, kMaxL]
  const int b = blockIdx.y;
  const T* kb = k + (long long)b * L * D;
  const T* vb = v + (long long)b * L * Dv;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) Ks[i] = to_f(kb[i]);
  for (int i = threadIdx.x; i < L * Dv; i += blockDim.x) Vs[i] = to_f(vb[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = Qs + warp * D;
  float* ps = Ps + warp * kMaxL;
  const int r0 = blockIdx.x * kG2LRows;
  const int r1 = min(n, r0 + kG2LRows);
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const T* qr = q + ((long long)b * n + r) * D;
    for (int d = lane; d < D; d += 32) qs[d] = to_f(qr[d]);
    __syncwarp();
    // lane l keeps logit l, lane l also keeps logit l + 32
    float lg0 = -INFINITY, lg1 = -INFINITY;
    for (int l = 0; l < L; ++l) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += qs[d] * Ks[l * D + d];
      part = warp_sum(part) * scale;
      if (lane == (l & 31)) {
        if (l < 32) lg0 = part; else lg1 = part;
      }
    }
    const float m = warp_max(fmaxf(lg0, lg1));
    const float e0 = lane < L ? expf(lg0 - m) : 0.f;
    const float e1 = lane + 32 < L ? expf(lg1 - m) : 0.f;
    const float den = warp_sum(e0 + e1);
    const float inv = 1.f / den;
    if (lse != nullptr && lane == 0) lse[(long long)b * n + r] = m + logf(den);
    if (lane < L) ps[lane] = round_to<T>(e0 * inv);
    if (lane + 32 < L) ps[lane + 32] = round_to<T>(e1 * inv);
    __syncwarp();
    T* orow = o + ((long long)b * n + r) * Dv;
    for (int dv = lane; dv < Dv; dv += 32) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += ps[l] * Vs[l * Dv + dv];
      orow[dv] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

// One block per (chunk, batch entry): logits S[L, chunk] in smem, per-row
// max/exp/sum, then acc[l, dv] = sum_j p[l, j] v[j, dv] with every thread
// owning Dv columns and all L rows in registers (LMAX is a compile-time
// bound, so the accumulator array stays in registers).
template <typename T, int LMAX>
__global__ void __launch_bounds__(256)
    l2g_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ m_part,
                       float* __restrict__ s_part,
                       float* __restrict__ acc_part, int n, int L, int D,
                       int Dv, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;                       // [L, D]
  float* S = Qs + L * D;                // [L, kChunk]
  float* Kr = S + L * kChunk;           // [kWarps, D]
  const int c = blockIdx.x, nchunks = gridDim.x, b = blockIdx.y;
  const int j0 = c * kChunk;
  const int cn = min(kChunk, n - j0);
  const T* qb = q + (long long)b * L * D;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) Qs[i] = to_f(qb[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kr = Kr + warp * D;
  for (int j = warp; j < cn; j += kWarps) {
    const T* krow = k + ((long long)b * n + j0 + j) * D;
    for (int d = lane; d < D; d += 32) kr[d] = to_f(krow[d]);
    __syncwarp();
    for (int l = 0; l < L; ++l) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += Qs[l * D + d] * kr[d];
      part = warp_sum(part);
      if (lane == 0) S[l * kChunk + j] = part * scale;
    }
    __syncwarp();
  }
  __syncthreads();

  for (int l = warp; l < L; l += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < cn; j += 32) m = fmaxf(m, S[l * kChunk + j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < cn; j += 32) {
      const float p = expf(S[l * kChunk + j] - m);
      S[l * kChunk + j] = p;
      s += p;
    }
    s = warp_sum(s);
    if (lane == 0) {
      m_part[((long long)b * nchunks + c) * L + l] = m;
      s_part[((long long)b * nchunks + c) * L + l] = s;
    }
  }
  __syncthreads();

  for (int dv = threadIdx.x; dv < Dv; dv += blockDim.x) {
    float acc[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
    for (int j = 0; j < cn; ++j) {
      const float vj = to_f(v[((long long)b * n + j0 + j) * Dv + dv]);
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < L) acc[l] += S[l * kChunk + j] * vj;
    }
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L)
        acc_part[(((long long)b * nchunks + c) * L + l) * Dv + dv] = acc[l];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    l2g_combine_kernel(const float* __restrict__ m_part,
                       const float* __restrict__ s_part,
                       const float* __restrict__ acc_part, T* __restrict__ o,
                       float* __restrict__ lse, int B, int nchunks, int L,
                       int Dv) {
  const long long total = (long long)B * L * Dv;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int dv = (int)(idx % Dv);
    const long long bl = idx / Dv;
    const int l = (int)(bl % L);
    const int b = (int)(bl / L);
    float M = -INFINITY;
    for (int c = 0; c < nchunks; ++c)
      M = fmaxf(M, m_part[((long long)b * nchunks + c) * L + l]);
    float den = 0.f, num = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      const long long pl = ((long long)b * nchunks + c) * L + l;
      const float wgt = expf(m_part[pl] - M);
      den += s_part[pl] * wgt;
      num += acc_part[pl * Dv + dv] * wgt;
    }
    o[idx] = from_f<T>(num / den);
    if (lse != nullptr && dv == 0) lse[bl] = M + logf(den);
  }
}

size_t g2l_smem(int L, int D, int Dv) {
  return sizeof(float) *
         ((size_t)L * D + (size_t)L * Dv + kWarps * D + kWarps * kMaxL);
}

size_t l2g_smem(int L, int D) {
  return sizeof(float) * ((size_t)L * D + (size_t)L * kChunk + kWarps * D);
}

template <typename T>
int g2l_launch(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int n, int L, int D, int Dv, float scale,
               cudaStream_t st) {
  const size_t smem = g2l_smem(L, D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      g2l_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kG2LRows - 1) / kG2LRows, B);
  g2l_kernel<T><<<grid, 32 * kWarps, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, n, L, D, Dv, scale);
  return (int)cudaGetLastError();
}

template <typename T, int LMAX>
int l2g_launch(const void* q, const void* k, const void* v, void* o,
               float* lse, float* m_part, float* s_part, float* acc_part,
               int B, int n, int L, int D, int Dv, float scale,
               cudaStream_t st) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  const size_t smem = l2g_smem(L, D);
  cudaError_t err = cudaFuncSetAttribute(
      l2g_partial_kernel<T, LMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2g_partial_kernel<T, LMAX><<<dim3(nchunks, B), 32 * kWarps, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, m_part, s_part, acc_part, n, L,
      D, Dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * L * Dv;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  l2g_combine_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      m_part, s_part, acc_part, (T*)o, lse, B, nchunks, L, Dv);
  return (int)cudaGetLastError();
}

template <typename T>
int l2g_dispatch(const void* q, const void* k, const void* v, void* o,
                 float* lse, float* m_part, float* s_part, float* acc_part,
                 int B, int n, int L, int D, int Dv, float scale,
                 cudaStream_t st) {
  if (L <= 16)
    return l2g_launch<T, 16>(q, k, v, o, lse, m_part, s_part, acc_part, B, n,
                             L, D, Dv, scale, st);
  if (L <= 32)
    return l2g_launch<T, 32>(q, k, v, o, lse, m_part, s_part, acc_part, B, n,
                             L, D, Dv, scale, st);
  return l2g_launch<T, 64>(q, k, v, o, lse, m_part, s_part, acc_part, B, n, L,
                           D, Dv, scale, st);
}

}  // namespace

extern "C" int gt_attn_chunk() { return kChunk; }

extern "C" long long gt_g2l_smem(int L, int D, int Dv) {
  return (long long)g2l_smem(L, D, Dv);
}

extern "C" long long gt_l2g_smem(int L, int D) {
  return (long long)l2g_smem(L, D);
}

extern "C" int gt_grid_to_latent(int dtype, const void* q, const void* k,
                                 const void* v, void* o, float* lse, int B,
                                 int n, int L, int D, int Dv, float scale,
                                 void* stream) {
  if (L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    return g2l_launch<float>(q, k, v, o, lse, B, n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return g2l_launch<__nv_bfloat16>(q, k, v, o, lse, B, n, L, D, Dv, scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gt_latent_to_grid(int dtype, const void* q, const void* k,
                                 const void* v, void* o, float* lse,
                                 float* m_part, float* s_part,
                                 float* acc_part, int B, int n, int L, int D,
                                 int Dv, float scale, void* stream) {
  if (L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    return l2g_dispatch<float>(q, k, v, o, lse, m_part, s_part, acc_part, B,
                               n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return l2g_dispatch<__nv_bfloat16>(q, k, v, o, lse, m_part, s_part,
                                       acc_part, B, n, L, D, Dv, scale, st);
  return (int)cudaErrorInvalidValue;
}
