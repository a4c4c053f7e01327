// Backward of the modulated convolution (the core y = d * conv(x * s, w)),
// on NHWC, for the three kinds of csrc/modconv.cu.  Two kernels:
//
// dx/ds - replaces gansformer_tpu/ops/pallas_modconv.py _bwd_body (launched
//   by _bwd_call).  The transposed conv as an implicit GEMM per sample:
//     u[p, c]  = sum_t sum_k du[p + off_t, k] * round(wT[t, k, c] * d[k])
//     dx[p, c] = s[c] * u[p, c]            (x's dtype)
//     ds[c]    = sum_p x[p, c] * u[p, c]   (fp32)
//   with the adjoint taps of _prep_adjoint (same3: flipped 3x3; poly: the
//   phase-folded cotangent [N,H,W,4Co] at offsets (-dh, -dw)).  d is folded
//   into the weight-tile load (rounded to the compute dtype, as _bwd_body
//   does) and s into the epilogue: the forward's folds, transposed.
//   ds sums over every pixel of the image.  The TPU kernel revisits one
//   output block across its sequential row axis; Hopper blocks run in no
//   order, so each 64-pixel tile writes an fp32 partial [N, tiles, Ci] and
//   a second pass sums the tiles in a fixed order.  Not atomicAdd: the
//   result must not change from run to run, and the smoke's planted-fault
//   control (one tile's partial dropped) is defined on these partials.
//
// dw - replaces _dw_body (launched by _dw_call):
//     dw[t, c, k] = sum_n s[n, c] d[n, k] sum_p x[n, p + off_t, c] du[n, p, k]
//   A GEMM with a long contraction (N * H * W, up to 8 * 65536) and a small
//   output (T * Ci * CoK <= 9 * 512 * 512): one block per output tile
//   cannot fill 132 SMs, so the contraction is split (split-K) over
//   (sample, row-strip) chunks; each block walks a contiguous run of
//   chunks, applies the rank-1 scale s_n (x) d_n to its [64 x 64] tap
//   result whenever the sample changes (never to a modulated copy of x),
//   and writes an fp32 partial; a second pass sums the partials in a fixed
//   order (deterministic, no atomics).
//
// Both: bf16 with channel counts that are multiples of 8 use the tensor
// cores through WMMA (16x16x16, fp32 accumulators, 4 warps of 32x32);
// fp32 and the 3-channel tRGB run on the fp32 FMA units.  Bound:
// operations (the forward's multiply-adds), like the forward kernel; the
// loads are not pipelined yet (no cp.async/TMA, no wgmma).
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;  // rows (pixels for dx, Ci for dw) per block
constexpr int kBN = 64;  // columns (Ci for dx, CoK for dw) per block
constexpr int kBK = 16;  // contraction slice of the FMA path
constexpr int kMaxTaps = 9;

struct Taps {
  int n;
  int oy[kMaxTaps];
  int ox[kMaxTaps];
};

// ---- dx/ds, fp32 FMA path --------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    dx_fma_kernel(const T* __restrict__ du, const T* __restrict__ wt,
                  const float* __restrict__ pre, const float* __restrict__ post,
                  const T* __restrict__ x, T* __restrict__ dx,
                  float* __restrict__ ds_part, int H, int W, int K, int C,
                  Taps taps) {
  __shared__ float As[kBK][kBM + 4];  // [k][pixel]
  __shared__ float Bs[kBK][kBN + 4];  // [k][column]
  __shared__ float red[16][kBN];
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int HW = H * W;
  const T* dun = du + (long long)n * HW * K;
  const float* pn = pre + (long long)n * K;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < taps.n; ++t) {
    const int oy = taps.oy[t], ox = taps.ox[t];
    const T* wtt = wt + (long long)t * K * C;
    for (int c0 = 0; c0 < K; c0 += kBK) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = tid + 256 * r;
        const int c = e % kBK, p = e / kBK;
        const int pg = p0 + p, cg = c0 + c;
        float v = 0.f;
        if (pg < HW && cg < K) {
          const int hh = pg / W + oy, ww = pg % W + ox;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f(dun[((long long)hh * W + ww) * K + cg]);
        }
        As[c][p] = v;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = tid + 256 * r;
        const int j = e % kBN, c = e / kBN;
        const int jg = j0 + j, cg = c0 + c;
        Bs[c][j] = (jg < C && cg < K)
                       ? round_to<T>(to_f(wtt[(long long)cg * C + jg]) * pn[cg])
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

  const float* sn = post + (long long)n * C;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= HW) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jg = j0 + tx + 16 * j;
      if (jg >= C) continue;
      const long long off = ((long long)n * HW + p) * C + jg;
      dx[off] = from_f<T>(acc[i][j] * sn[jg]);
      part[j] += acc[i][j] * to_f(x[off]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx + 16 * j] = part[j];
  __syncthreads();
  if (tid < kBN && j0 + tid < C) {
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += red[r][tid];
    ds_part[((long long)n * gridDim.x + blockIdx.x) * C + j0 + tid] = sum;
  }
}

// ---- dx/ds, bf16 tensor-core path ------------------------------------------

constexpr int kWK = 32;        // contraction slice of the WMMA paths
constexpr int kLdA = kWK + 8;  // dx: bf16 pitch of the A tile [64][40]
constexpr int kLdB = kBN + 8;  // bf16 pitch of a [32][72] tile
constexpr int kLdC = kBN + 4;  // fp32 pitch of the C tile [64][68]
constexpr int kDxSmemAB = (kBM * kLdA + kWK * kLdB) * 2;
constexpr int kDxSmemC = kBM * kLdC * 4;
constexpr int kDxSmem = kDxSmemAB > kDxSmemC ? kDxSmemAB : kDxSmemC;

__global__ void __launch_bounds__(128)
    dx_wmma_kernel(const __nv_bfloat16* __restrict__ du,
                   const __nv_bfloat16* __restrict__ wt,
                   const float* __restrict__ pre,
                   const float* __restrict__ post,
                   const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ dx, float* __restrict__ ds_part,
                   int H, int W, int K, int C, Taps taps) {
  namespace wm = nvcuda::wmma;
  __shared__ __align__(128) unsigned char smem[kDxSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][kLdA]
  __nv_bfloat16* Bs = As + kBM * kLdA;                          // [32][kLdB]
  float* Cs = reinterpret_cast<float*>(smem);  // [64][kLdC], after the loop
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const int HW = H * W;
  const __nv_bfloat16* dun = du + (long long)n * HW * K;
  const float* pn = pre + (long long)n * K;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < taps.n; ++t) {
    const int oy = taps.oy[t], ox = taps.ox[t];
    const __nv_bfloat16* wtt = wt + (long long)t * K * C;
    for (int c0 = 0; c0 < K; c0 += kWK) {
      // A: 64 pixels x 32 cotangent channels, as 256 vectors of 8
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + 128 * r;
        const int p = v / 4, cv = (v % 4) * 8;
        const int pg = p0 + p, cg = c0 + cv;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (pg < HW && cg < K) {
          const int hh = pg / W + oy, ww = pg % W + ox;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            val = *reinterpret_cast<const uint4*>(
                dun + ((long long)hh * W + ww) * K + cg);
        }
        *reinterpret_cast<uint4*>(As + p * kLdA + cv) = val;
      }
      // B: 32 cotangent channels x 64 columns of wT * d, rounded to bf16
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + 128 * r;
        const int c = v / 8, jv = (v % 8) * 8;
        const int cg = c0 + c, jg = j0 + jv;
        uint4 out = make_uint4(0, 0, 0, 0);
        if (cg < K && jg < C) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(wtt + (long long)cg * C + jg);
          const __nv_bfloat162* in =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
          const float sc = pn[cg];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(in[e]);
            o[e] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
          }
        }
        *reinterpret_cast<uint4*>(Bs + c * kLdB + jv) = out;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWK; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major>
            a[2];
        wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wm::load_matrix_sync(a[i], As + (wr + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wm::load_matrix_sync(b[j], Bs + kk * kLdB + wc + 16 * j, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wm::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wm::store_matrix_sync(Cs + (wr + 16 * i) * kLdC + wc + 16 * j,
                            acc[i][j], kLdC, wm::mem_row_major);
  __syncthreads();

  const float* sn = post + (long long)n * C;
  for (int e = tid; e < kBM * kBN; e += 128) {
    const int p = p0 + e / kBN, jg = j0 + e % kBN;
    if (p >= HW || jg >= C) continue;
    dx[((long long)n * HW + p) * C + jg] =
        __float2bfloat16(Cs[(e / kBN) * kLdC + e % kBN] * sn[jg]);
  }
  if (tid < kBN && j0 + tid < C) {
    const int jg = j0 + tid;
    float sum = 0.f;
    for (int r = 0; r < kBM && p0 + r < HW; ++r)
      sum += Cs[r * kLdC + tid] *
             __bfloat162float(x[((long long)n * HW + p0 + r) * C + jg]);
    ds_part[((long long)n * gridDim.x + blockIdx.x) * C + jg] = sum;
  }
}

// ds[n, c] = sum over tiles of ds_part[n, tile, c], tiles in order.
__global__ void ds_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ ds, int N, int tiles,
                                 int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * C) return;
  const int n = idx / C, c = idx % C;
  const float* pn = part + (long long)n * tiles * C + c;
  float sum = 0.f;
  for (int i = 0; i < tiles; ++i) sum += pn[(long long)i * C];
  ds[idx] = sum;
}

// ---- dw: the split-K walk shared by both paths -----------------------------
//
// The contraction is N * S chunks of R pixels (chunk c: sample c / S, pixels
// [(c % S) * R, min(HW, (c % S + 1) * R))); split b of P walks chunks
// [b * N*S / P, (b + 1) * N*S / P).

struct Split {
  int S, R, P;
};

// ---- dw, fp32 FMA path -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
    dw_fma_kernel(const T* __restrict__ x, const T* __restrict__ du,
                  const float* __restrict__ s, const float* __restrict__ pre,
                  float* __restrict__ part, int N, int H, int W, int Ci, int K,
                  Taps taps, Split sp) {
  __shared__ float As[kBK][kBM + 4];  // [pixel][ci]
  __shared__ float Bs[kBK][kBN + 4];  // [pixel][k]
  const int ci0 = blockIdx.x * kBM, k0 = blockIdx.y * kBN;
  const int t = blockIdx.z / sp.P, split = blockIdx.z % sp.P;
  const int oy = taps.oy[t], ox = taps.ox[t];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int HW = H * W;
  const long long chunks = (long long)N * sp.S;
  const long long cb = chunks * split / sp.P;
  const long long ce = chunks * (split + 1) / sp.P;

  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.f;

  auto flush = [&](int n) {  // tot += (s_n (x) d_n) * acc; acc = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = ci0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        if (ci < Ci && k < K)
          tot[i][j] += acc[i][j] * s[(long long)n * Ci + ci] *
                       pre[(long long)n * K + k];
        acc[i][j] = 0.f;
      }
    }
  };

  int cur = -1;
  for (long long c = cb; c < ce; ++c) {
    const int n = (int)(c / sp.S);
    const int pb = (int)(c % sp.S) * sp.R;
    const int pe = min(HW, pb + sp.R);
    if (n != cur) {
      if (cur >= 0) flush(cur);
      cur = n;
    }
    const T* xn = x + (long long)n * HW * Ci;
    const T* dun = du + (long long)n * HW * K;
    for (int q0 = pb; q0 < pe; q0 += kBK) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = tid + 256 * r;
        const int ci = e % kBM, pp = e / kBM;
        const int q = q0 + pp, cg = ci0 + ci;
        float v = 0.f;
        if (q < pe && cg < Ci) {
          const int hh = q / W + oy, ww = q % W + ox;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f(xn[((long long)hh * W + ww) * Ci + cg]);
        }
        As[pp][ci] = v;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = tid + 256 * r;
        const int kk = e % kBN, pp = e / kBN;
        const int q = q0 + pp, kg = k0 + kk;
        Bs[pp][kk] =
            (q < pe && kg < K) ? to_f(dun[(long long)q * K + kg]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int pp = 0; pp < kBK; ++pp) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[pp][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[pp][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }
  if (cur >= 0) flush(cur);

  float* out = part + ((long long)split * taps.n + t) * Ci * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (ci < Ci && k < K) out[(long long)ci * K + k] = tot[i][j];
    }
  }
}

// ---- dw, bf16 tensor-core path ---------------------------------------------

__global__ void __launch_bounds__(128)
    dw_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ du,
                   const float* __restrict__ s, const float* __restrict__ pre,
                   float* __restrict__ part, int N, int H, int W, int Ci,
                   int K, Taps taps, Split sp) {
  namespace wm = nvcuda::wmma;
  __shared__ __align__(128) __nv_bfloat16 As[kWK * kLdB];  // [pixel][ci]
  __shared__ __align__(128) __nv_bfloat16 Bs[kWK * kLdB];  // [pixel][k]
  __shared__ __align__(128) float Cs[kBM * kLdC];          // [ci][k]
  // The block's scaled sum; each thread owns elements tid + 128 r (kept
  // in shared memory, not registers: 32 more floats a thread spill).
  __shared__ __align__(128) float Ts[kBM * kLdC];
  const int ci0 = blockIdx.x * kBM, k0 = blockIdx.y * kBN;
  const int t = blockIdx.z / sp.P, split = blockIdx.z % sp.P;
  const int oy = taps.oy[t], ox = taps.ox[t];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const int HW = H * W;
  const long long chunks = (long long)N * sp.S;
  const long long cb = chunks * split / sp.P;
  const long long ce = chunks * (split + 1) / sp.P;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);
  for (int e = tid; e < kBM * kBN; e += 128)
    Ts[(e / kBN) * kLdC + e % kBN] = 0.f;

  auto flush = [&](int n) {  // Ts += (s_n (x) d_n) * acc; acc = 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wm::store_matrix_sync(Cs + (wr + 16 * i) * kLdC + wc + 16 * j,
                              acc[i][j], kLdC, wm::mem_row_major);
        wm::fill_fragment(acc[i][j], 0.f);
      }
    __syncthreads();
    for (int e = tid; e < kBM * kBN; e += 128) {
      const int ci = ci0 + e / kBN, k = k0 + e % kBN;
      const int o = (e / kBN) * kLdC + e % kBN;
      if (ci < Ci && k < K)
        Ts[o] += Cs[o] * s[(long long)n * Ci + ci] * pre[(long long)n * K + k];
    }
    __syncthreads();
  };

  int cur = -1;
  for (long long c = cb; c < ce; ++c) {
    const int n = (int)(c / sp.S);
    const int pb = (int)(c % sp.S) * sp.R;
    const int pe = min(HW, pb + sp.R);
    if (n != cur) {
      if (cur >= 0) flush(cur);
      cur = n;
    }
    const __nv_bfloat16* xn = x + (long long)n * HW * Ci;
    const __nv_bfloat16* dun = du + (long long)n * HW * K;
    for (int q0 = pb; q0 < pe; q0 += kWK) {
      // A: 32 pixels x 64 input channels of x at this tap, 8 per vector
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + 128 * r;
        const int pp = v / 8, cv = (v % 8) * 8;
        const int q = q0 + pp, cg = ci0 + cv;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (q < pe && cg < Ci) {
          const int hh = q / W + oy, ww = q % W + ox;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            val = *reinterpret_cast<const uint4*>(
                xn + ((long long)hh * W + ww) * Ci + cg);
        }
        *reinterpret_cast<uint4*>(As + pp * kLdB + cv) = val;
      }
      // B: 32 pixels x 64 cotangent channels
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + 128 * r;
        const int pp = v / 8, kv = (v % 8) * 8;
        const int q = q0 + pp, kg = k0 + kv;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (q < pe && kg < K)
          val = *reinterpret_cast<const uint4*>(dun + (long long)q * K + kg);
        *reinterpret_cast<uint4*>(Bs + pp * kLdB + kv) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWK; kk += 16) {
        // A^T: element (ci, pixel) at As[pixel * kLdB + ci], column-major
        wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::col_major>
            a[2];
        wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>
            b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wm::load_matrix_sync(a[i], As + kk * kLdB + wr + 16 * i, kLdB);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wm::load_matrix_sync(b[j], Bs + kk * kLdB + wc + 16 * j, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wm::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  if (cur >= 0) flush(cur);

  float* out = part + ((long long)split * taps.n + t) * Ci * K;
  for (int e = tid; e < kBM * kBN; e += 128) {
    const int ci = ci0 + e / kBN, k = k0 + e % kBN;
    if (ci < Ci && k < K)
      out[(long long)ci * K + k] = Ts[(e / kBN) * kLdC + e % kBN];
  }
}

// out[i] = sum over splits of part[split][i], splits in order.
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long total,
                                 int P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int b = 0; b < P; ++b) sum += part[(long long)b * total + idx];
  out[idx] = sum;
}

bool make_taps(int ntaps, const int* oy, const int* ox, Taps* taps) {
  if (ntaps < 1 || ntaps > kMaxTaps) return false;
  taps->n = ntaps;
  for (int t = 0; t < ntaps; ++t) {
    taps->oy[t] = oy[t];
    taps->ox[t] = ox[t];
  }
  return true;
}

}  // namespace

// Pixels per ds partial (one dx tile).
extern "C" int gt_modconv_dx_tile() { return kBM; }

// dx [N,H,W,C] and ds [N,C] (fp32) from the cotangent du [N,H,W,K], the
// adjoint weights wT [T,K,C], pre = d [N,K] and post = s [N,C] (fp32), and
// x [N,H,W,C]; ds_part is fp32 scratch of [N, ceil(H*W/64), C].
extern "C" int gt_modconv_dx(int dtype, const void* du, const void* wt,
                             const float* pre, const float* post,
                             const void* x, void* dx, float* ds_part,
                             float* ds, int N, int H, int W, int K, int C,
                             int ntaps, const int* tap_oy, const int* tap_ox,
                             void* stream) {
  Taps taps;
  if (!make_taps(ntaps, tap_oy, tap_ox, &taps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (H * W + kBM - 1) / kBM;
  dim3 grid(tiles, (C + kBN - 1) / kBN, N);
  if (dtype == GT_DTYPE_F32)
    dx_fma_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)du, (const float*)wt, pre, post, (const float*)x,
        (float*)dx, ds_part, H, W, K, C, taps);
  else if (dtype == GT_DTYPE_BF16 && K % 8 == 0 && C % 8 == 0)
    dx_wmma_kernel<<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)du, (const __nv_bfloat16*)wt, pre, post,
        (const __nv_bfloat16*)x, (__nv_bfloat16*)dx, ds_part, H, W, K, C,
        taps);
  else if (dtype == GT_DTYPE_BF16)
    dx_fma_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)du, (const __nv_bfloat16*)wt, pre, post,
        (const __nv_bfloat16*)x, (__nv_bfloat16*)dx, ds_part, H, W, K, C,
        taps);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ds_reduce_kernel<<<(N * C + 255) / 256, 256, 0, st>>>(ds_part, ds, N,
                                                        tiles, C);
  return (int)cudaGetLastError();
}

// dw [T, Ci, K] (fp32) from x [N,H,W,Ci], the cotangent du [N,H,W,K],
// s [N,Ci] and pre = d [N,K] (fp32), split over P blocks of the N * S
// chunks of R pixels; part is fp32 scratch of [P, T, Ci, K].
extern "C" int gt_modconv_dw(int dtype, const void* x, const void* du,
                             const float* s, const float* pre, float* part,
                             float* out, int N, int H, int W, int Ci, int K,
                             int ntaps, const int* tap_oy, const int* tap_ox,
                             int S, int R, int P, void* stream) {
  Taps taps;
  if (!make_taps(ntaps, tap_oy, tap_ox, &taps) || S < 1 || R < 1 || P < 1 ||
      (long long)S * R < (long long)H * W || P > N * S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Split sp{S, R, P};
  dim3 grid((Ci + kBM - 1) / kBM, (K + kBN - 1) / kBN, ntaps * P);
  if (dtype == GT_DTYPE_F32)
    dw_fma_kernel<float><<<grid, 256, 0, st>>>(
        (const float*)x, (const float*)du, s, pre, part, N, H, W, Ci, K, taps,
        sp);
  else if (dtype == GT_DTYPE_BF16 && Ci % 8 == 0 && K % 8 == 0)
    dw_wmma_kernel<<<grid, 128, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)du, s, pre, part, N, H,
        W, Ci, K, taps, sp);
  else if (dtype == GT_DTYPE_BF16)
    dw_fma_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)du, s, pre, part, N, H,
        W, Ci, K, taps, sp);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)ntaps * Ci * K;
  dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, out, total, P);
  return (int)cudaGetLastError();
}
