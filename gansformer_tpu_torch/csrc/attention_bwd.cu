// Backward of the bipartite attention, both directions, over heads folded
// into the batch: (dq, dk, dv) of out = softmax(q k^T * scale) v at the
// cotangent do, with P = exp(s - lse) rebuilt from the forward's fp32 row
// statistic (attention.cu) and every product, sum and exp in fp32 whatever
// the storage type.
//
// grid_to_latent backward (replaces gansformer_tpu/ops/pallas_attention.py
//   _grid_to_latent_bwd -> pl.pallas_call, body _grid_to_latent_bwd_kernel):
//   q/do [B, n, D|Dv] grid rows, k/v [B, L, D|Dv] with L <= 64 latents.  One
//   block per (64-row chunk, batch entry) keeps K and V in shared memory;
//   each warp walks rows, rebuilds the row's L probabilities, forms
//   dP = do V^T, the row delta rowsum(dP * P) inside the row (as the TPU
//   body does) and dS = P (dP - delta), and writes dq = dS K * scale
//   directly.  dk and dv are sums over all n rows: the TPU carries them in
//   fp32 scratch across its sequential grid; Hopper blocks run in no order,
//   so each chunk writes fp32 partials [B, chunks, L, D|Dv] (threads own
//   columns and keep all L sums in registers) and a second kernel sums them
//   in chunk order (deterministic).  Rows past n are never visited, so a
//   ragged tail adds nothing.
//
// latent_to_grid backward (replaces _latent_to_grid_bwd -> pl.pallas_call,
//   body _latent_to_grid_bwd_kernel): q/do [B, L, D|Dv] latents, k/v
//   [B, n, D|Dv] grid keys, softmax over n.  delta = rowsum(do * o) comes
//   from the caller (computed outside, as the JAX package computes it
//   outside its pallas_call).  One block per (64-key chunk, batch entry)
//   keeps Q and dO in shared memory; each warp walks keys, forms the key's
//   column of P and dS, and writes dv = P^T dO and dk = dS^T Q * scale for
//   that key directly.  dq = dS K * scale is a sum over all n keys: the
//   chunk's dS [L, chunk] stays in shared memory, each chunk writes an fp32
//   partial [B, chunks, L, D], and the same fixed-order reduce sums them.
//   Keys past n are never visited (the TPU masks its padded columns).
//
// Bound: bytes.  q, k, v, do are read once and dq, dk, dv written once; the
// five products of the flash backward are 2 Lq Lk (3 D + 2 Dv) flops, a
// few dozen per byte at L = 16, far under Hopper's ridge.  This first
// version runs on the fp32 FMA units with warp reductions; q/do (kernel 8)
// and k (kernel 9) are read a second time for the chunk sums, mostly from
// L2.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxL = 64;       // latents on the short side
constexpr int kWarps = 8;       // warps per block
// Grid rows (keys) per block, both kernels: small enough that the path's
// small grids (n = 256, 1024 at batch 8) still launch a few dozen blocks.
constexpr int kRows = 64;

// Fixed-order sum over chunks of fp32 partials [B, chunks, M] -> out [B, M].
template <typename T>
__device__ __forceinline__ void sum_chunks(const float* __restrict__ part,
                                           T* __restrict__ out, int B,
                                           int chunks, long long M) {
  const long long total = (long long)B * M;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / M, m = idx % M;
    const float* p = part + b * chunks * M + m;
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += p[(long long)c * M];
    out[idx] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    g2l_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int B, int chunks, long long M) {
  sum_chunks<T>(part, out, B, chunks, M);
}

template <typename T>
__global__ void __launch_bounds__(256)
    l2g_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int B, int chunks, long long M) {
  sum_chunks<T>(part, out, B, chunks, M);
}

template <typename T, int LMAX>
__global__ void __launch_bounds__(256)
    g2l_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lse,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   float* __restrict__ dk_part, float* __restrict__ dv_part,
                   int n, int L, int D, int Dv, float scale) {
  extern __shared__ float sm[];
  float* Ks = sm;                       // [L, D]
  float* Vs = Ks + L * D;               // [L, Dv]
  float* Pc = Vs + L * Dv;              // [kRows, L] P of the chunk's rows
  float* dSc = Pc + kRows * L;          // [kRows, L] dS of the chunk's rows
  float* Rows = dSc + kRows * L;        // [kWarps, D + Dv] a q and a do row
  const int c = blockIdx.x, nchunks = gridDim.x, b = blockIdx.y;
  const int r0 = c * kRows;
  const int cn = min(kRows, n - r0);
  const T* kb = k + (long long)b * L * D;
  const T* vb = v + (long long)b * L * Dv;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) Ks[i] = to_f(kb[i]);
  for (int i = threadIdx.x; i < L * Dv; i += blockDim.x) Vs[i] = to_f(vb[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qs = Rows + warp * (D + Dv);
  float* dos = qs + D;
  for (int rr = warp; rr < cn; rr += kWarps) {
    const long long row = (long long)b * n + r0 + rr;
    for (int d = lane; d < D; d += 32) qs[d] = to_f(q[row * D + d]);
    for (int d = lane; d < Dv; d += 32) dos[d] = to_f(dout[row * Dv + d]);
    __syncwarp();
    const float lr = lse[row];
    // lane l keeps P and dP of latent l, and of latent l + 32
    float p0 = 0.f, p1 = 0.f, dp0 = 0.f, dp1 = 0.f;
    for (int l = 0; l < L; ++l) {
      float s = 0.f, t = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[d] * Ks[l * D + d];
      for (int d = lane; d < Dv; d += 32) t += dos[d] * Vs[l * Dv + d];
      s = warp_sum(s);
      t = warp_sum(t);
      if (lane == (l & 31)) {
        const float p = expf(s * scale - lr);
        if (l < 32) {
          p0 = p;
          dp0 = t;
        } else {
          p1 = p;
          dp1 = t;
        }
      }
    }
    const float delta = warp_sum(p0 * dp0 + p1 * dp1);
    if (lane < L) {
      Pc[rr * L + lane] = p0;
      dSc[rr * L + lane] = p0 * (dp0 - delta);
    }
    if (lane + 32 < L) {
      Pc[rr * L + lane + 32] = p1;
      dSc[rr * L + lane + 32] = p1 * (dp1 - delta);
    }
    __syncwarp();
    const float* dsr = dSc + rr * L;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += dsr[l] * Ks[l * D + d];
      dq[row * D + d] = from_f<T>(acc * scale);
    }
    __syncwarp();
  }
  __syncthreads();

  // The chunk's partials: dv[l, j] = sum_r P[r, l] do[r, j] and
  // dk[l, d] = scale * sum_r dS[r, l] q[r, d]; a thread owns one column.
  for (int col = threadIdx.x; col < Dv + D; col += blockDim.x) {
    const bool is_v = col < Dv;
    const float* coef = is_v ? Pc : dSc;
    const T* src = is_v ? dout : q;
    const int width = is_v ? Dv : D;
    const int cc = is_v ? col : col - Dv;
    float acc[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
    for (int rr = 0; rr < cn; ++rr) {
      const float x = to_f(src[((long long)b * n + r0 + rr) * width + cc]);
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < L) acc[l] += coef[rr * L + l] * x;
    }
    float* part = is_v ? dv_part : dk_part;
    const float mul = is_v ? 1.f : scale;
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L)
        part[(((long long)b * nchunks + c) * L + l) * width + cc] =
            acc[l] * mul;
  }
}

template <typename T, int LMAX>
__global__ void __launch_bounds__(256)
    l2g_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const T* __restrict__ dout, float* __restrict__ dq_part,
                   T* __restrict__ dk, T* __restrict__ dv, int n, int L,
                   int D, int Dv, float scale) {
  extern __shared__ float sm[];
  float* Qs = sm;                       // [L, D]
  float* dOs = Qs + L * D;              // [L, Dv]
  float* dSc = dOs + L * Dv;            // [L, kRows] dS of the chunk's keys
  float* Rows = dSc + L * kRows;        // [kWarps, D + Dv] a k and a v row
  float* Pw = Rows + kWarps * (D + Dv);  // [kWarps, 2 * kMaxL] P, dS of a key
  const int c = blockIdx.x, nchunks = gridDim.x, b = blockIdx.y;
  const int j0 = c * kRows;
  const int cn = min(kRows, n - j0);
  const T* qb = q + (long long)b * L * D;
  const T* db = dout + (long long)b * L * Dv;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) Qs[i] = to_f(qb[i]);
  for (int i = threadIdx.x; i < L * Dv; i += blockDim.x) dOs[i] = to_f(db[i]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* ks = Rows + warp * (D + Dv);
  float* vs = ks + D;
  float* pw = Pw + warp * 2 * kMaxL;
  float* dsw = pw + kMaxL;
  const float* lseb = lse + (long long)b * L;
  const float* deltab = delta + (long long)b * L;
  for (int jj = warp; jj < cn; jj += kWarps) {
    const long long row = (long long)b * n + j0 + jj;
    for (int d = lane; d < D; d += 32) ks[d] = to_f(k[row * D + d]);
    for (int d = lane; d < Dv; d += 32) vs[d] = to_f(v[row * Dv + d]);
    __syncwarp();
    for (int l = 0; l < L; ++l) {
      float s = 0.f, t = 0.f;
      for (int d = lane; d < D; d += 32) s += Qs[l * D + d] * ks[d];
      for (int d = lane; d < Dv; d += 32) t += dOs[l * Dv + d] * vs[d];
      s = warp_sum(s);
      t = warp_sum(t);
      if (lane == 0) {
        const float p = expf(s * scale - lseb[l]);
        const float ds = p * (t - deltab[l]);
        pw[l] = p;
        dsw[l] = ds;
        dSc[l * kRows + jj] = ds;
      }
    }
    __syncwarp();
    for (int d = lane; d < Dv; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += pw[l] * dOs[l * Dv + d];
      dv[row * Dv + d] = from_f<T>(acc);
    }
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) acc += dsw[l] * Qs[l * D + d];
      dk[row * D + d] = from_f<T>(acc * scale);
    }
    __syncwarp();
  }
  __syncthreads();

  // The chunk's dq partial: dq[l, d] = scale * sum_j dS[l, j] k[j, d].
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) acc[l] = 0.f;
    for (int jj = 0; jj < cn; ++jj) {
      const float kv = to_f(k[((long long)b * n + j0 + jj) * D + d]);
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < L) acc[l] += dSc[l * kRows + jj] * kv;
    }
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
      if (l < L)
        dq_part[(((long long)b * nchunks + c) * L + l) * D + d] =
            acc[l] * scale;
  }
}

size_t g2l_bwd_smem(int L, int D, int Dv) {
  return sizeof(float) * ((size_t)L * (D + Dv) + 2 * (size_t)kRows * L +
                          (size_t)kWarps * (D + Dv));
}

size_t l2g_bwd_smem(int L, int D, int Dv) {
  return sizeof(float) * ((size_t)L * (D + Dv) + (size_t)L * kRows +
                          (size_t)kWarps * (D + Dv) + kWarps * 2 * kMaxL);
}

template <typename T, bool G2L>
int launch_reduce(const float* part, T* out, int B, int chunks, long long M,
                  cudaStream_t st) {
  long long blocks = ((long long)B * M + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  if (G2L)
    g2l_bwd_reduce_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(part, out, B,
                                                               chunks, M);
  else
    l2g_bwd_reduce_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(part, out, B,
                                                               chunks, M);
  return (int)cudaGetLastError();
}

template <typename T, int LMAX>
int g2l_bwd_launch(const void* q, const void* k, const void* v,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* dk_part, float* dv_part, int B, int n,
                   int L, int D, int Dv, float scale, cudaStream_t st) {
  const int nchunks = (n + kRows - 1) / kRows;
  const size_t smem = g2l_bwd_smem(L, D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      g2l_bwd_kernel<T, LMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  g2l_bwd_kernel<T, LMAX><<<dim3(nchunks, B), 32 * kWarps, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, (T*)dq,
      dk_part, dv_part, n, L, D, Dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_reduce<T, true>(dk_part, (T*)dk, B, nchunks,
                                        (long long)L * D, st);
  if (rc != 0) return rc;
  return launch_reduce<T, true>(dv_part, (T*)dv, B, nchunks, (long long)L * Dv,
                                st);
}

template <typename T, int LMAX>
int l2g_bwd_launch(const void* q, const void* k, const void* v,
                   const float* lse, const float* delta, const void* dout,
                   void* dq, void* dk, void* dv, float* dq_part, int B, int n,
                   int L, int D, int Dv, float scale, cudaStream_t st) {
  const int nchunks = (n + kRows - 1) / kRows;
  const size_t smem = l2g_bwd_smem(L, D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      l2g_bwd_kernel<T, LMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2g_bwd_kernel<T, LMAX><<<dim3(nchunks, B), 32 * kWarps, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, delta, (const T*)dout,
      dq_part, (T*)dk, (T*)dv, n, L, D, Dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<T, false>(dq_part, (T*)dq, B, nchunks,
                                 (long long)L * D, st);
}

template <typename T>
int g2l_bwd_dispatch(const void* q, const void* k, const void* v,
                     const float* lse, const void* dout, void* dq, void* dk,
                     void* dv, float* dk_part, float* dv_part, int B, int n,
                     int L, int D, int Dv, float scale, cudaStream_t st) {
  if (L <= 16)
    return g2l_bwd_launch<T, 16>(q, k, v, lse, dout, dq, dk, dv, dk_part,
                                 dv_part, B, n, L, D, Dv, scale, st);
  if (L <= 32)
    return g2l_bwd_launch<T, 32>(q, k, v, lse, dout, dq, dk, dv, dk_part,
                                 dv_part, B, n, L, D, Dv, scale, st);
  return g2l_bwd_launch<T, 64>(q, k, v, lse, dout, dq, dk, dv, dk_part,
                               dv_part, B, n, L, D, Dv, scale, st);
}

template <typename T>
int l2g_bwd_dispatch(const void* q, const void* k, const void* v,
                     const float* lse, const float* delta, const void* dout,
                     void* dq, void* dk, void* dv, float* dq_part, int B,
                     int n, int L, int D, int Dv, float scale,
                     cudaStream_t st) {
  if (L <= 16)
    return l2g_bwd_launch<T, 16>(q, k, v, lse, delta, dout, dq, dk, dv,
                                 dq_part, B, n, L, D, Dv, scale, st);
  if (L <= 32)
    return l2g_bwd_launch<T, 32>(q, k, v, lse, delta, dout, dq, dk, dv,
                                 dq_part, B, n, L, D, Dv, scale, st);
  return l2g_bwd_launch<T, 64>(q, k, v, lse, delta, dout, dq, dk, dv,
                               dq_part, B, n, L, D, Dv, scale, st);
}

}  // namespace

extern "C" int gt_attn_bwd_rows() { return kRows; }

extern "C" long long gt_g2l_bwd_smem(int L, int D, int Dv) {
  return (long long)g2l_bwd_smem(L, D, Dv);
}

extern "C" long long gt_l2g_bwd_smem(int L, int D, int Dv) {
  return (long long)l2g_bwd_smem(L, D, Dv);
}

extern "C" int gt_grid_to_latent_bwd(int dtype, const void* q, const void* k,
                                     const void* v, const float* lse,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, float* dk_part, float* dv_part,
                                     int B, int n, int L, int D, int Dv,
                                     float scale, void* stream) {
  if (L < 1 || L > kMaxL || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    return g2l_bwd_dispatch<float>(q, k, v, lse, dout, dq, dk, dv, dk_part,
                                   dv_part, B, n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return g2l_bwd_dispatch<__nv_bfloat16>(q, k, v, lse, dout, dq, dk, dv,
                                           dk_part, dv_part, B, n, L, D, Dv,
                                           scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gt_latent_to_grid_bwd(int dtype, const void* q, const void* k,
                                     const void* v, const float* lse,
                                     const float* delta, const void* dout,
                                     void* dq, void* dk, void* dv,
                                     float* dq_part, int B, int n, int L,
                                     int D, int Dv, float scale,
                                     void* stream) {
  if (L < 1 || L > kMaxL || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    return l2g_bwd_dispatch<float>(q, k, v, lse, delta, dout, dq, dk, dv,
                                   dq_part, B, n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return l2g_bwd_dispatch<__nv_bfloat16>(q, k, v, lse, delta, dout, dq, dk,
                                           dv, dq_part, B, n, L, D, Dv, scale,
                                           st);
  return (int)cudaErrorInvalidValue;
}
