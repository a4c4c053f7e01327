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
//   into the weights and rounded to the compute dtype, as _bwd_body does,
//   once per sample by a first pass; s goes into the epilogue.  ds sums
//   over every pixel of the image.  The TPU kernel revisits one output
//   block across its sequential row axis; Hopper blocks run in no order,
//   so each pixel tile writes an fp32 partial [N, tiles, Ci] and a second
//   pass sums the tiles in a fixed order.  Not atomicAdd: the result must
//   not change from run to run, and the smoke's planted-fault control (one
//   tile's partial dropped) is defined on these partials.
//
// dw - replaces _dw_body (launched by _dw_call):
//     dw[t, c, k] = sum_n s[n, c] d[n, k] sum_p x[n, p + off_t, c] du[n, p, k]
//   A GEMM with a long contraction (N * H * W, up to 8 * 65536) and an
//   output of T * Ci * CoK (up to 4 * 512 * 2048): where the output tiles
//   alone cannot fill 132 SMs the contraction is split (split-K) along
//   (sample, pixel) units, cut at sample boundaries (ops/cuda_modconv.py
//   dw_split): a split is part of one sample, or whole samples.  (Splits
//   inside single samples only would need 8 splits at res 4-32, whose
//   partials of 75-134 MB cost more than the dw they sum.)  The rank-1
//   scale s_n (x) d_n is applied in fp32 to each sample's product, in
//   registers, never to a modulated copy of x; each split writes an fp32
//   partial and a second pass sums them in a fixed order (deterministic,
//   no atomics; one split writes dw itself).  Each block takes one tap: a
//   loop over the 9 taps inside the block would reuse the du tile, but
//   would hold 9 accumulator tiles (288 registers a thread at 64 x 64), so
//   du is re-read per tap, from L2.
//
// Bound on the H100: the forward's multiply-adds over the bf16 tensor
// peak (dw; dx/ds at 512 channels), or the bytes of du, x and dx (dx/ds
// at 64-128 channels), PERF.md section 6 rows 5-6.  Design for it: bf16
// operands go through wgmma (sm_90a, fp32 accumulators in registers) on
// 128-byte swizzled tiles that a producer warp lands by TMA in a ring of
// 3-5 shared-memory slots, zero-filled outside the image, while the
// consumer warpgroups drain it (hopper.cuh TmaRing); 128 x 128 output
// tiles (two consumer warpgroups) where the channel counts reach 128 and
// 64-wide tiles below.  The 3-channel tRGB (CoK = 3) runs small-K kernels
// bound by the bytes of x and dx; fp32 runs the FMA kernels.  The poly
// kind multiplies the 7 of 16 (tap, phase) weight blocks that are zero
// by construction too: phases are interleaved within every 16-byte chunk
// of the cotangent, so no whole chunk of work is zero.
#include "common.cuh"
#include "hopper.cuh"

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

// ---- dx/ds, bf16 wgmma path ------------------------------------------------
//
// A first pass folds d into the adjoint weights once per sample,
// wtd[n, t, k, c] = round(wT[t, k, c] * d[n, k]) in bf16 (the rounding
// point of _bwd_body), rather than in every pixel tile of the sample
// (folding in the kernel's consumers, or in a producer warpgroup, put the
// scaling on the wgmma's critical path: 1.5-2x slower on the H100).
// Then per sample an implicit GEMM: M = 128 pixels (two consumer
// warpgroups of 64 rows), N = BN input channels, contraction = taps x CoK
// in 64-deep stages.  Stage j = (tap j / kchunks, cotangent channels k0
// .. k0 + 64): A is the cotangent window at the tap's offset (K-major), B
// the weight tile wtd[n, t, k0 .., c0 ..] (MN-major).  A producer warp
// lands them by TMA (zero-filled outside the image) into a ring of S
// slots as the consumers hand slots back; the consumer warpgroups wait
// only for landed slots and never for each other.

constexpr int kDxBM = 128;        // pixels per dx tile (and per ds partial)
constexpr int kDxBK = 64;         // cotangent channels per stage
constexpr int kDxConsumers = 256; // two consumer warpgroups
constexpr int kDxThreads = 288;   // and the producer warp
constexpr int kBlock = 64 * 128;  // 64 swizzled rows of 128 bytes
constexpr int kAlign = 1024;      // slack to align the ring to 1 KB

// Ring slots: the 64-wide tile (a short contraction of 9 stages at 64
// channels) takes three, so that three blocks share an SM and overlap
// one another's prologue and epilogue.
template <int BN>
__host__ __device__ constexpr int dx_stages() {
  return BN == 64 ? 3 : 5;
}

template <int BN>
__host__ __device__ constexpr int dx_stage_bytes() {
  return kDxBM * 128 + (BN / 64) * kBlock;
}

// wtd [N, T, K, C] = round(wT [T, K, C] * d [N, K]), 8 channels a thread.
__global__ void dx_prescale_kernel(const __nv_bfloat16* __restrict__ wt,
                                   const float* __restrict__ pre,
                                   __nv_bfloat16* __restrict__ wtd, int N,
                                   int T, int K, int C) {
  const long long chunks = (long long)N * T * K * C / 8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < chunks; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8;
    const long long row = e / C;                  // (n * T + t) * K + k
    const int k = (int)(row % K);
    const long long nt = row / K;
    const int n = (int)(nt / T), t = (int)(nt % T);
    const float sc = pre[(long long)n * K + k];
    uint4 v = *reinterpret_cast<const uint4*>(
        wt + ((long long)t * K + k) * C + e % C);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      h[q] = __floats2bfloat162_rn(f.x * sc, f.y * sc);
    }
    *reinterpret_cast<uint4*>(wtd + e) = v;
  }
}

template <int BN>
__global__ void __launch_bounds__(kDxThreads, 1)
    dx_wgmma_kernel(const __grid_constant__ CUtensorMap tm_du,
                    const __grid_constant__ CUtensorMap tm_wtd,
                    const float* __restrict__ post,
                    const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ dx,
                    float* __restrict__ ds_part, int H, int W, int K, int C,
                    Taps taps) {
  constexpr int S = dx_stages<BN>();
  constexpr int kABytes = kDxBM * 128;
  constexpr int kStage = dx_stage_bytes<BN>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_oy[kMaxTaps], s_ox[kMaxTaps];
  __shared__ __align__(8) TmaRing<S> ring;
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));

  const int n = blockIdx.z;
  const int p0 = blockIdx.y * kDxBM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int HW = H * W;
  const int kchunks = (K + kDxBK - 1) / kDxBK;
  const int iters = taps.n * kchunks;
  if (tid < taps.n) {
    s_oy[tid] = taps.oy[tid];
    s_ox[tid] = taps.ox[tid];
  }
  if (tid == 0) ring.init(kDxConsumers / 128);
  __syncthreads();

  // Producer: stage j into slot j % S once both consumer warpgroups have
  // handed back the slot's previous stage: the cotangent box of the
  // tile's pixels (kDxBM pixels as rows of the image, shifted by the tap)
  // and the BN / 64 weight boxes.
  const int h0 = p0 / W, w0 = p0 % W;
  auto issue = [&](int j) {
    uint64_t* bar = ring.acquire(j, kStage);
    unsigned char* sa = smem + (j % S) * kStage;
    const int t = j / kchunks, k0 = (j % kchunks) * kDxBK;
    tma_load_4d(sa, &tm_du, bar, k0, w0 + s_ox[t], h0 + s_oy[t], n);
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      tma_load_4d(sa + kABytes + b * kBlock, &tm_wtd, bar, c0 + 64 * b, k0,
                  t, n);
  };

  if (tid >= kDxConsumers) {
    if (tid == kDxConsumers)
      for (int j = 0; j < iters; ++j) issue(j);
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < iters; ++j) {
    ring.wait(j);
    const uint32_t a0 = smem_u32(smem + (j % S) * kStage) + wg * kBlock;
    const uint32_t b0 = smem_u32(smem + (j % S) * kStage + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDxBK / 16; ++ks)
      wgmma_tile<BN, 0, 1>(acc, gmma_desc(a0 + ks * 32, 16, 1024),
                           gmma_desc(b0 + ks * 16 * 128, kBlock, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    // stage j-1's wgmma of this warpgroup is done: its slot may refill
    if (j > 0 && tid % 128 == 0) ring.release(j - 1);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue: u goes through shared memory (fp32, padded rows) so that
  // dx = s * u (bf16) is stored and x read 16 bytes a thread, a row of
  // the tile per BN / 8 threads; each thread sums x * u over its rows for
  // its 8 channels, and the row groups' sums are added in a fixed order.
  constexpr int kULd = BN + 4;
  constexpr int kGroups = kDxConsumers / (BN / 8);   // row groups
  bar_sync<1, kDxConsumers>();  // both warpgroups are done with the ring
  float* us = reinterpret_cast<float*>(smem);       // [kDxBM][kULd]
  float* red = us + kDxBM * kULd;                   // [kGroups][BN]
  {
    const int lane = tid % 32;
    const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(us + (r0 + 8 * hf) * kULd + jb * 8 +
                                   2 * (lane % 4)) =
            make_float2(acc[jb * 4 + 2 * hf], acc[jb * 4 + 2 * hf + 1]);
  }
  bar_sync<1, kDxConsumers>();
  const int cc = tid % (BN / 8), rg = tid / (BN / 8);
  const int c = c0 + cc * 8;
  float part[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e] = 0.f;
  if (c < C) {
    const float* sn = post + (long long)n * C + c;
    const float4 s_lo = *reinterpret_cast<const float4*>(sn);
    const float4 s_hi = *reinterpret_cast<const float4*>(sn + 4);
    const float sc[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w,
                         s_hi.x, s_hi.y, s_hi.z, s_hi.w};
    for (int r = rg; r < kDxBM && p0 + r < HW; r += kGroups) {
      const long long off = ((long long)n * HW + p0 + r) * C + c;
      const float* ur = us + r * kULd + cc * 8;
      const float4 u_lo = *reinterpret_cast<const float4*>(ur);
      const float4 u_hi = *reinterpret_cast<const float4*>(ur + 4);
      const float u[8] = {u_lo.x, u_lo.y, u_lo.z, u_lo.w,
                          u_hi.x, u_hi.y, u_hi.z, u_hi.w};
      const uint4 xr = *reinterpret_cast<const uint4*>(x + off);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xr);
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xh[e]);
        part[2 * e] += xf.x * u[2 * e];
        part[2 * e + 1] += xf.y * u[2 * e + 1];
        oh[e] = __floats2bfloat162_rn(u[2 * e] * sc[2 * e],
                                      u[2 * e + 1] * sc[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(dx + off) = o;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[rg * BN + cc * 8 + e] = part[e];
  bar_sync<1, kDxConsumers>();
  for (int cl = tid; cl < BN; cl += kDxConsumers) {
    if (c0 + cl >= C) continue;
    float sum = 0.f;
    for (int g = 0; g < kGroups; ++g) sum += red[g * BN + cl];
    ds_part[((long long)n * gridDim.y + blockIdx.y) * C + c0 + cl] = sum;
  }
}

// ds[n, c] = sum over tiles of ds_part[n, tile, c], tiles in order.
// A block of 32 channels x 8 tile rows per (sample, 32 channels): thread
// row r sums tiles r, r + 8, ... in order, then row 0 adds the 8 sums in
// order (deterministic, and 8 loads in flight per channel).
__global__ void __launch_bounds__(256)
    ds_reduce_kernel(const float* __restrict__ part, float* __restrict__ ds,
                     int N, int tiles, int C) {
  __shared__ float red[8][32];
  const int n = blockIdx.y, c = blockIdx.x * 32 + threadIdx.x;
  const int r = threadIdx.y;
  float sum = 0.f;
  if (c < C) {
    const float* pn = part + (long long)n * tiles * C + c;
    for (int i = r; i < tiles; i += 8) sum += pn[(long long)i * C];
  }
  red[r][threadIdx.x] = sum;
  __syncthreads();
  if (r == 0 && c < C) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i][threadIdx.x];
    ds[(long long)n * C + c] = tot;
  }
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

// ---- dw, bf16 wgmma path ---------------------------------------------------
//
// One block per (k tile, ci tile, tap, split): D[ci, k] += A[ci, p] * B[p,
// k] over the split's pixels in stages of BP = 64 or 128 pixels, A = x at
// the tap's offset (MN-major, zero-filled outside the image) and B = du
// (MN-major), landed by TMA from a producer warp into a ring of S slots
// as the consumer warpgroups hand slots back.  WGS warpgroups take 64 ci
// rows each; BN = 64 or 128 k columns.  A stage never straddles two
// samples: when the sample changes, the warpgroup waits for its wgmma,
// adds the sample's product times s_n (x) d_n (fp32, in registers) to its
// running sum and restarts the accumulator, so the scale is applied once
// per sample and never to a modulated copy of x.

constexpr int kDwRows = 128;   // a stage's pixels tile the image's rows

// Pixels per stage (BP): 128 where the image has them (half as many ring
// round trips per pixel), 64 at res <= 8 and for the 64 x 64 tile, which
// shares its SM with two more blocks instead (dw_stage_pixels in
// ops/cuda_modconv.py).
template <int WGS, int BN, int BP>
__host__ __device__ constexpr int dw_stage_bytes() {
  return (WGS + BN / 64) * BP * 128;
}

// Ring slots, within 227 KB.
template <int WGS, int BN, int BP>
__host__ __device__ constexpr int dw_stages() {
  return BP == 64 ? (WGS == 1 && BN == 64 ? 4 : 5)
                  : (WGS == 2 && BN == 128 ? 3 : 4);
}

// The split's walk over (sample, pixel) stages: unit u = (sample u / S,
// pixels [(u % S) R, min(HW, (u % S + 1) R))), in stages of bp pixels (R
// is a multiple of bp, or HW).
struct DwCursor {
  long long u;
  int q, qe, n, bp;
  __device__ __forceinline__ void start(long long u0, const Split& sp,
                                        int HW, int pixels) {
    u = u0;
    bp = pixels;
    enter(sp, HW);
  }
  __device__ __forceinline__ void enter(const Split& sp, int HW) {
    n = (int)(u / sp.S);
    q = (int)(u % sp.S) * sp.R;
    qe = min(HW, q + sp.R);
  }
  __device__ __forceinline__ void next(const Split& sp, int HW) {
    q += bp;
    if (q >= qe) {
      ++u;
      enter(sp, HW);
    }
  }
};

template <int WGS, int BN, int BP>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
    dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_du,
                    const float* __restrict__ s,
                    const float* __restrict__ pre, float* __restrict__ part,
                    int N, int H, int W, int Ci, int K, Taps taps, Split sp) {
  constexpr int kConsumers = WGS * 128;
  constexpr int BM = WGS * 64;
  constexpr int kOperand = BP * 128;     // one 64-channel block of a stage
  constexpr int kABytes = WGS * kOperand;
  constexpr int kStage = dw_stage_bytes<WGS, BN, BP>();
  constexpr int S = dw_stages<WGS, BN, BP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) TmaRing<S> ring;
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));

  const int k0 = blockIdx.x * BN;
  const int ci_tiles = (Ci + BM - 1) / BM;
  const int ci0 = (blockIdx.y % ci_tiles) * BM;
  const int t = blockIdx.y / ci_tiles;
  const int split = blockIdx.z;
  const int oy = taps.oy[t], ox = taps.ox[t];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int HW = H * W;
  const long long units = (long long)N * sp.S;
  const long long u_end = units * (split + 1) / sp.P;

  if (tid == 0) ring.init(WGS);
  __syncthreads();

  // Producer: stage j into slot j % S once the consumers handed back the
  // slot's previous stage: BP pixels of one sample as rows of the
  // image; x's boxes at the tap's offset (TMA zero-fills outside the
  // image) and du's boxes.
  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      DwCursor pc;
      pc.start(units * split / sp.P, sp, HW, BP);
      for (int j = 0; pc.u < u_end; ++j) {
        uint64_t* bar = ring.acquire(j, kStage);
        unsigned char* sa = smem + (j % S) * kStage;
        const int h0 = pc.q / W, w0 = pc.q % W;
#pragma unroll
        for (int b = 0; b < WGS; ++b)
          tma_load_4d(sa + b * kOperand, &tm_x, bar, ci0 + 64 * b, w0 + ox,
                      h0 + oy, pc.n);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_4d(sa + kABytes + b * kOperand, &tm_du, bar, k0 + 64 * b,
                      w0, h0, pc.n);
        pc.next(sp, HW);
      }
    }
    return;
  }

  // This thread's accumulator rows (ci) and column pairs (k).
  const int lane = tid % 32;
  const int r0 = ci0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  const int kc0 = k0 + 2 * (lane % 4);
  float acc[BN / 2], tot[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = tot[i] = 0.f;
  auto flush = [&](int n) {  // tot += acc * (s_n (x) d_n); acc = 0
    const float* sn = s + (long long)n * Ci;
    const float* dn = pre + (long long)n * K;
    const float sr[2] = {r0 < Ci ? sn[r0] : 0.f,
                         r0 + 8 < Ci ? sn[r0 + 8] : 0.f};
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
      const int k = kc0 + jb * 8;
      const float d0 = k < K ? dn[k] : 0.f, d1 = k < K ? dn[k + 1] : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = jb * 4 + 2 * hf;
        tot[i] += acc[i] * (sr[hf] * d0);
        tot[i + 1] += acc[i + 1] * (sr[hf] * d1);
        acc[i] = acc[i + 1] = 0.f;
      }
    }
  };

  DwCursor cc;  // the stage to compute
  cc.start(units * split / sp.P, sp, HW, BP);
  int cur = cc.n;
  for (int j = 0; cc.u < u_end; ++j) {
    ring.wait(j);
    if (cc.n != cur) {
      wgmma_wait<0>();
      fence_acc(acc);
      flush(cur);
      cur = cc.n;
    }
    const uint32_t a0 =
        smem_u32(smem + (j % S) * kStage) + wg * kOperand;
    const uint32_t b0 = smem_u32(smem + (j % S) * kStage + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BP / 16; ++ks)
      wgmma_tile<BN, 1, 1>(acc, gmma_desc(a0 + ks * 2048, kOperand, 1024),
                           gmma_desc(b0 + ks * 2048, kOperand, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    // stage j-1's wgmma of this warpgroup is done: its slot may refill
    if (j > 0 && tid % 128 == 0) ring.release(j - 1);
    cc.next(sp, HW);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  flush(cur);

  float* out = part + ((long long)split * taps.n + t) * Ci * K;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int k = kc0 + jb * 8;
    if (k >= K) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ci = r0 + 8 * hf;
      if (ci < Ci)
        *reinterpret_cast<float2*>(out + (long long)ci * K + k) =
            make_float2(tot[jb * 4 + 2 * hf], tot[jb * 4 + 2 * hf + 1]);
    }
  }
}

// ---- dx/ds and dw at a cotangent of at most kSmallK channels (tRGB) --------
//
// The 1x1 tRGB conv has CoK = 3: too few channels for a tensor-core tile,
// and almost no arithmetic (6 flops per byte of x), so both kernels are
// bound by the bytes of x and dx.  A thread owns 8 channels (16 bytes) of
// a pixel and the block walks kSmallTile pixels of one sample.

constexpr int kSmallK = 4;       // cotangent channels of this path, at most
constexpr int kSmallTile = 256;  // pixels per dx block (and ds partial)

// dx = s * u, u[p, c] = sum_k du[p, k] round(wT[k, c] d[k]); ds partial of
// the tile.  Single tap at offset 0 (same1).
__global__ void __launch_bounds__(256)
    dx_smallk_kernel(const __nv_bfloat16* __restrict__ du,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ pre,
                     const float* __restrict__ post,
                     const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ ds_part, int HW, int K, int C) {
  __shared__ float red[256 * 8];
  const int n = blockIdx.y, tile = blockIdx.x;
  const int chunks = C / 8;            // threads per pixel
  const int rows = 256 / chunks;       // pixels per pass
  const int tid = threadIdx.x;
  const int cc = tid % chunks, rg = tid / chunks;
  const int c = cc * 8;
  float part[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) part[e] = 0.f;
  if (rg < rows) {
    float w[kSmallK][8];
#pragma unroll
    for (int k = 0; k < kSmallK; ++k) {
      const float dk = k < K ? pre[(long long)n * K + k] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w[k][e] = k < K ? __bfloat162float(__float2bfloat16(
                              __bfloat162float(wt[(long long)k * C + c + e]) *
                              dk))
                        : 0.f;
    }
    float sc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[e] = post[(long long)n * C + c + e];
    const int pend = min(HW, (tile + 1) * kSmallTile);
    for (int p = tile * kSmallTile + rg; p < pend; p += rows) {
      const long long pix = (long long)n * HW + p;
      float g[kSmallK];
#pragma unroll
      for (int k = 0; k < kSmallK; ++k)
        g[k] = k < K ? __bfloat162float(du[pix * K + k]) : 0.f;
      const uint4 xr = *reinterpret_cast<const uint4*>(x + pix * C + c);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xr);
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int k = 0; k < kSmallK; ++k) {
          u0 += g[k] * w[k][2 * e];
          u1 += g[k] * w[k][2 * e + 1];
        }
        const float2 xf = __bfloat1622float2(xh[e]);
        part[2 * e] += xf.x * u0;
        part[2 * e + 1] += xf.y * u1;
        oh[e] = __floats2bfloat162_rn(u0 * sc[2 * e], u1 * sc[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(dx + pix * C + c) = o;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[tid * 8 + e] = part[e];
  __syncthreads();
  for (int cl = tid; cl < C; cl += 256) {
    float sum = 0.f;
    for (int r = 0; r < rows; ++r)
      sum += red[(r * chunks + cl / 8) * 8 + cl % 8];
    ds_part[((long long)n * gridDim.x + tile) * C + cl] = sum;
  }
}

// One block per unit (sample b / S, pixels [(b % S) R, (b % S + 1) R)):
// its term of dw [Ci, K], times s_n (x) d_n, as the block's fp32 partial.
__global__ void __launch_bounds__(256)
    dw_smallk_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ du,
                     const float* __restrict__ s,
                     const float* __restrict__ pre, float* __restrict__ part,
                     int HW, int Ci, int K, int S, int R) {
  __shared__ float red[256 * 8 * kSmallK];
  const int b = blockIdx.x, n = b / S, piece = b % S;
  const int chunks = Ci / 8, rows = 256 / chunks;
  const int tid = threadIdx.x;
  const int cc = tid % chunks, rg = tid / chunks;
  const int c = cc * 8;
  float acc[kSmallK][8];
#pragma unroll
  for (int k = 0; k < kSmallK; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.f;
  if (rg < rows) {
    const int pend = min(HW, (piece + 1) * R);
    for (int p = piece * R + rg; p < pend; p += rows) {
      const long long pix = (long long)n * HW + p;
      const uint4 xr = *reinterpret_cast<const uint4*>(x + pix * Ci + c);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xr);
      float xf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(xh[e]);
        xf[2 * e] = f.x;
        xf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int k = 0; k < kSmallK; ++k) {
        const float g = k < K ? __bfloat162float(du[pix * K + k]) : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[k][e] += xf[e] * g;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSmallK; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(tid * kSmallK + k) * 8 + e] = acc[k][e];
  __syncthreads();
  for (int o = tid; o < Ci * K; o += 256) {
    const int ci = o / K, k = o % K;
    float sum = 0.f;
    for (int r = 0; r < rows; ++r)
      sum += red[((r * chunks + ci / 8) * kSmallK + k) * 8 + ci % 8];
    part[(long long)b * Ci * K + o] =
        sum * (s[(long long)n * Ci + ci] * pre[(long long)n * K + k]);
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


// The paths of a launch, chosen by the wrapper (ops/cuda_modconv.py
// bwd_path) and checked here: the FMA kernels (fp32, or any shape), the
// wgmma kernels (bf16, channel counts that are multiples of 8, and an
// image width whose rows tile the `rows` pixels of a TMA box: whole rows
// of the image, or a run of one row), and the small-K kernels (bf16, at
// most kSmallK cotangent channels, one tap at offset 0: the tRGB).
enum Path { kPathFma = 0, kPathWgmma = 1, kPathSmallK = 2 };

bool path_fits(int path, int dtype, int K, int C, int W, int rows,
               const Taps& taps) {
  if (path == kPathFma)
    return dtype == GT_DTYPE_F32 || dtype == GT_DTYPE_BF16;
  if (dtype != GT_DTYPE_BF16 || C % 8 != 0) return false;
  if (path == kPathWgmma)
    return K % 8 == 0 && W > 0 && (W >= rows ? W % rows == 0 : rows % W == 0);
  return path == kPathSmallK && K <= kSmallK && 256 % (C / 8) == 0 &&
         taps.n == 1 && taps.oy[0] == 0 && taps.ox[0] == 0;
}

template <int BN>
int launch_dx(const void* du, const void* wt, const float* pre,
              const float* post, const void* x, void* dx, void* wtd,
              float* ds_part, int N, int H, int W, int K, int C, Taps taps,
              cudaStream_t st) {
  constexpr int smem = dx_stages<BN>() * dx_stage_bytes<BN>() + kAlign;
  // the opt-in belongs to the current device: made at every launch
  const int attr = set_smem(dx_wgmma_kernel<BN>, smem);
  if (attr != 0) return attr;
  const long long chunks = (long long)N * taps.n * K * C / 8;
  const int blocks = (int)(chunks < 132 * 16 * 256 ? (chunks + 255) / 256
                                                   : 132 * 16);
  dx_prescale_kernel<<<blocks, 256, 0, st>>>(
      (const __nv_bfloat16*)wt, pre, (__nv_bfloat16*)wtd, N, taps.n, K, C);
  int rc = (int)cudaGetLastError();
  CUtensorMap tm_du, tm_wtd;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)K,
                              (cuuint64_t)taps.n, (cuuint64_t)N};
  const cuuint32_t box[4] = {64, kDxBK, 1, 1};
  if (rc == 0) rc = bf16_map(&tm_wtd, wtd, 4, dims, box);
  if (rc == 0) rc = nhwc_map(&tm_du, du, N, H, W, K, kDxBM);
  if (rc != 0) return rc;
  dim3 grid((C + BN - 1) / BN, (H * W + kDxBM - 1) / kDxBM, N);
  dx_wgmma_kernel<BN><<<grid, kDxThreads, smem, st>>>(
      tm_du, tm_wtd, post, (const __nv_bfloat16*)x, (__nv_bfloat16*)dx,
      ds_part, H, W, K, C, taps);
  return (int)cudaGetLastError();
}

template <int WGS, int BN, int BP>
int launch_dw(const void* x, const void* du, const float* s,
              const float* pre, float* dst, int N, int H, int W, int Ci,
              int K, Taps taps, Split sp, cudaStream_t st) {
  constexpr int smem =
      dw_stages<WGS, BN, BP>() * dw_stage_bytes<WGS, BN, BP>() + kAlign;
  // the opt-in belongs to the current device: made at every launch
  const int attr = set_smem(dw_wgmma_kernel<WGS, BN, BP>, smem);
  if (attr != 0) return attr;
  CUtensorMap tm_x, tm_du;
  int rc = nhwc_map(&tm_x, x, N, H, W, Ci, BP);
  if (rc == 0) rc = nhwc_map(&tm_du, du, N, H, W, K, BP);
  if (rc != 0) return rc;
  dim3 grid((K + BN - 1) / BN, ((Ci + WGS * 64 - 1) / (WGS * 64)) * taps.n,
            sp.P);
  dw_wgmma_kernel<WGS, BN, BP><<<grid, WGS * 128 + 32, smem, st>>>(
      tm_x, tm_du, s, pre, dst, N, H, W, Ci, K, taps, sp);
  return (int)cudaGetLastError();
}

using DwLaunch = int (*)(const void*, const void*, const float*,
                         const float*, float*, int, int, int, int, int, Taps,
                         Split, cudaStream_t);

// 128-pixel dw stages: for every tile but 64 x 64, where a sample has 128
// pixels (res >= 16).
bool dw_wide(int Ci, int K, int HW) {
  return (Ci >= 128 || K >= 128) && HW >= 128;
}

}  // namespace

// Pixels per ds partial (one dx tile) of a dx/ds launch on `path`.
extern "C" int gt_modconv_dx_tile(int path) {
  return path == kPathWgmma ? kDxBM : path == kPathSmallK ? kSmallTile : kBM;
}

// Dynamic shared memory of a launch on `path` (which = 0: dx/ds, 1: dw)
// with CoK = K and Ci = C on HW pixels a sample; 0 bytes off the wgmma
// path, whose kernels' tiles are static.
extern "C" int gt_modconv_bwd_smem(int which, int path, int K, int C,
                                   int HW) {
  if (path != kPathWgmma) return 0;
  if (which == 0)
    return kAlign + (C >= 128 ? dx_stages<128>() * dx_stage_bytes<128>()
                              : dx_stages<64>() * dx_stage_bytes<64>());
  const int wgs = C >= 128 ? 2 : 1, bn = K >= 128 ? 128 : 64;
  const int bp = dw_wide(C, K, HW) ? 128 : 64;
  const int stages = bp == 64 ? (wgs == 1 && bn == 64 ? 4 : 5)
                              : (wgs == 2 && bn == 128 ? 3 : 4);
  return kAlign + stages * (wgs + bn / 64) * bp * 128;
}

// dx [N,H,W,C] and ds [N,C] (fp32) from the cotangent du [N,H,W,K], the
// adjoint weights wT [T,K,C], pre = d [N,K] and post = s [N,C] (fp32), and
// x [N,H,W,C]; ds_part is fp32 scratch of [N, ceil(H*W / tile), C] with
// tile = gt_modconv_dx_tile(path), and wtd bf16 scratch of [N, T, K, C]
// for the weights with d folded in on the wgmma path (else unused).
extern "C" int gt_modconv_dx(int path, int dtype, const void* du,
                             const void* wt, const float* pre,
                             const float* post, const void* x, void* dx,
                             void* wtd, float* ds_part, float* ds, int N,
                             int H, int W, int K, int C, int ntaps,
                             const int* tap_oy, const int* tap_ox,
                             void* stream) {
  Taps taps;
  if (!make_taps(ntaps, tap_oy, tap_ox, &taps) ||
      !path_fits(path, dtype, K, C, W, kDxBM, taps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tile = gt_modconv_dx_tile(path);
  const int tiles = (H * W + tile - 1) / tile;
  int rc = 0;
  if (path == kPathWgmma) {
    if (wtd == nullptr) return (int)cudaErrorInvalidValue;
    rc = C >= 128 ? launch_dx<128>(du, wt, pre, post, x, dx, wtd, ds_part,
                                   N, H, W, K, C, taps, st)
                  : launch_dx<64>(du, wt, pre, post, x, dx, wtd, ds_part, N,
                                  H, W, K, C, taps, st);
  } else if (path == kPathSmallK) {
    dx_smallk_kernel<<<dim3(tiles, N), 256, 0, st>>>(
        (const __nv_bfloat16*)du, (const __nv_bfloat16*)wt, pre, post,
        (const __nv_bfloat16*)x, (__nv_bfloat16*)dx, ds_part, H * W, K, C);
    rc = (int)cudaGetLastError();
  } else {
    dim3 grid(tiles, (C + kBN - 1) / kBN, N);
    if (dtype == GT_DTYPE_F32)
      dx_fma_kernel<float><<<grid, 256, 0, st>>>(
          (const float*)du, (const float*)wt, pre, post, (const float*)x,
          (float*)dx, ds_part, H, W, K, C, taps);
    else
      dx_fma_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
          (const __nv_bfloat16*)du, (const __nv_bfloat16*)wt, pre, post,
          (const __nv_bfloat16*)x, (__nv_bfloat16*)dx, ds_part, H, W, K, C,
          taps);
    rc = (int)cudaGetLastError();
  }
  if (rc != 0) return rc;
  ds_reduce_kernel<<<dim3((C + 31) / 32, N), dim3(32, 8), 0, st>>>(
      ds_part, ds, N, tiles, C);
  return (int)cudaGetLastError();
}

// dw [T, Ci, K] (fp32) from x [N,H,W,Ci], the cotangent du [N,H,W,K],
// s [N,Ci] and pre = d [N,K] (fp32), split over P blocks of the N * S
// units of R pixels (ops/cuda_modconv.py dw_split); part is fp32 scratch
// of [P, T, Ci, K] (unused when P == 1: the split writes dw).
extern "C" int gt_modconv_dw(int path, int dtype, const void* x,
                             const void* du, const float* s,
                             const float* pre, float* part, float* out,
                             int N, int H, int W, int Ci, int K, int ntaps,
                             const int* tap_oy, const int* tap_ox, int S,
                             int R, int P, void* stream) {
  Taps taps;
  if (!make_taps(ntaps, tap_oy, tap_ox, &taps) ||
      !path_fits(path, dtype, K, Ci, W, kDwRows, taps) || S < 1 || R < 1 ||
      P < 1 || (long long)S * R < (long long)H * W || P > N * S ||
      (path == kPathSmallK && P != N * S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Split sp{S, R, P};
  float* dst = P == 1 ? out : part;
  int rc = 0;
  if (path == kPathWgmma) {
    const bool wide = dw_wide(Ci, K, H * W);
    const DwLaunch launch =
        Ci >= 128 ? (K >= 128 ? (wide ? launch_dw<2, 128, 128>
                                      : launch_dw<2, 128, 64>)
                              : (wide ? launch_dw<2, 64, 128>
                                      : launch_dw<2, 64, 64>))
                  : (K >= 128 ? (wide ? launch_dw<1, 128, 128>
                                      : launch_dw<1, 128, 64>)
                              : launch_dw<1, 64, 64>);
    rc = launch(x, du, s, pre, dst, N, H, W, Ci, K, taps, sp, st);
  } else if (path == kPathSmallK) {
    dw_smallk_kernel<<<P, 256, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)du, s, pre, dst,
        H * W, Ci, K, S, R);
    rc = (int)cudaGetLastError();
  } else {
    dim3 grid((Ci + kBM - 1) / kBM, (K + kBN - 1) / kBN, ntaps * P);
    if (dtype == GT_DTYPE_F32)
      dw_fma_kernel<float><<<grid, 256, 0, st>>>(
          (const float*)x, (const float*)du, s, pre, dst, N, H, W, Ci, K,
          taps, sp);
    else
      dw_fma_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)du, s, pre, dst, N,
          H, W, Ci, K, taps, sp);
    rc = (int)cudaGetLastError();
  }
  if (rc != 0 || P == 1) return rc;
  const long long total = (long long)ntaps * Ci * K;
  dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, out, total, P);
  return (int)cudaGetLastError();
}
