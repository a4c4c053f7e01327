// Modulated convolution on NHWC: y = post * conv(x * s, w) with an optional
// act(y + bias) * gain epilogue, for the three kinds of the synthesis
// network:
//   same3 - 3x3, pad 1 (9 taps at offsets -1..1);
//   same1 - 1x1 (tRGB);
//   poly  - the stride-2 transposed 3x3 conv as 4 output phases of 2x2 taps
//           at the low resolution (weights from _poly_w4: [4, Ci, Co*4],
//           co-outer / phase-inner), written straight to [N, 2H, 2W, Co]
//           so the [N, H, W, 4Co] phase tensor never exists.
//
// Replaces the Pallas kernel gansformer_tpu/ops/pallas_modconv.py (_fwd_body,
// launched by _fwd_call).  The TPU kernel folds the style s and the demod d
// into a per-sample weight tile; here s is folded into the activation load
// and d (post) into the epilogue, so one weight tile serves every sample of
// the batch: the starting point for a tensor-core (wgmma) version.
//
// Design: an implicit GEMM.  One block owns a tile of 64 output pixels x
// 64 output columns (CoK = Co * phases) of one sample and loops over taps
// and slices of Ci, staging (x*s) and w in shared memory.
//   bf16 with Ci and CoK multiples of 8 (every 3x3 conv and up-conv of the
//   synthesis network): tensor cores through WMMA (16x16x16 bf16, fp32
//   accumulators), 4 warps of 32x32 each, 32-channel slices loaded as
//   16-byte vectors; x*s is rounded to bf16 in shared memory.
//   Otherwise (fp32, or the 3-channel tRGB): fp32 FMA, 256 threads of 4x4
//   outputs, 16-channel slices.
// Bound: operations (2 * pixels * taps * Ci * CoK).  Neither path
// pipelines its loads yet (no cp.async/TMA, no wgmma), so both sit well
// above the tensor-core bound.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;  // output pixels per block
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 16;  // input channels per smem stage
constexpr int kMaxTaps = 9;

struct Taps {
  int n;
  int oy[kMaxTaps];
  int ox[kMaxTaps];
};

template <typename T>
__global__ void __launch_bounds__(256)
    modconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ s, const float* __restrict__ post,
                   const float* __restrict__ bias, T* __restrict__ y, int H,
                   int W, int Ci, int CoK, int phases, Taps taps, int act,
                   float alpha, float gain) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * kBM;
  const int j0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int HW = H * W;
  const T* xn = x + (long long)n * HW * Ci;
  const float* sn = s + (long long)n * Ci;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < taps.n; ++t) {
    const int oy = taps.oy[t], ox = taps.ox[t];
    const T* wt = w + (long long)t * Ci * CoK;
    for (int c0 = 0; c0 < Ci; c0 += kBK) {
      // A: 64 pixels x 16 channels of the modulated input (zero outside)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = tid + 256 * r;
        const int c = e % kBK, p = e / kBK;
        const int pg = p0 + p, cg = c0 + c;
        float v = 0.f;
        if (pg < HW && cg < Ci) {
          const int hh = pg / W + oy, ww = pg % W + ox;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f(xn[((long long)hh * W + ww) * Ci + cg]) * sn[cg];
        }
        As[c][p] = v;
      }
      // B: 16 channels x 64 columns of this tap's weights
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = tid + 256 * r;
        const int j = e % kBN, c = e / kBN;
        const int jg = j0 + j, cg = c0 + c;
        Bs[c][j] =
            (jg < CoK && cg < Ci) ? to_f(wt[(long long)cg * CoK + jg]) : 0.f;
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

  const int Co = CoK / phases;
  const float* pn = post + (long long)n * CoK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= HW) continue;
    const int hh = p / W, ww = p % W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jg = j0 + tx + 16 * j;
      if (jg >= CoK) continue;
      const int co = jg / phases;
      float v = acc[i][j] * pn[jg];
      if (act != GT_ACT_NONE) v = apply_act(v + bias[co], act, alpha, gain);
      long long off;
      if (phases == 1) {
        off = (((long long)n * H + hh) * W + ww) * Co + co;
      } else {  // depth-to-space: column co*4 + a*2 + b -> (2h+a, 2w+b, co)
        const int a = (jg % 4) / 2, b = jg % 2;
        off = (((long long)n * 2 * H + 2 * hh + a) * 2 * W + 2 * ww + b) *
                  Co + co;
      }
      y[off] = from_f<T>(v);
    }
  }
}

// ---- bf16 tensor-core path -------------------------------------------------

constexpr int kWK = 32;             // input channels per smem stage
constexpr int kLdA = kWK + 8;       // bf16 row pitch of the A tile [64][40]
constexpr int kLdB = kBN + 8;       // bf16 row pitch of the B tile [32][72]
constexpr int kLdC = kBN + 4;       // fp32 row pitch of the C tile [64][68]
constexpr int kSmemAB = (kBM * kLdA + kWK * kLdB) * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmemW = kSmemAB > kSmemC ? kSmemAB : kSmemC;

__global__ void __launch_bounds__(128)
    modconv_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ s,
                        const float* __restrict__ post,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, int H, int W, int Ci,
                        int CoK, int phases, Taps taps, int act, float alpha,
                        float gain) {
  namespace wm = nvcuda::wmma;
  __shared__ __align__(128) unsigned char smem[kSmemW];
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
  const __nv_bfloat16* xn = x + (long long)n * HW * Ci;
  const float* sn = s + (long long)n * Ci;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wm::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < taps.n; ++t) {
    const int oy = taps.oy[t], ox = taps.ox[t];
    const __nv_bfloat16* wt = w + (long long)t * Ci * CoK;
    for (int c0 = 0; c0 < Ci; c0 += kWK) {
      // A: 64 pixels x 32 channels, as 256 vectors of 8 channels
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + 128 * r;
        const int p = v / 4, cv = (v % 4) * 8;
        const int pg = p0 + p, cg = c0 + cv;
        uint4 out = make_uint4(0, 0, 0, 0);
        if (pg < HW && cg < Ci) {
          const int hh = pg / W + oy, ww = pg % W + ox;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                xn + ((long long)hh * W + ww) * Ci + cg);
            const __nv_bfloat162* in =
                reinterpret_cast<const __nv_bfloat162*>(&raw);
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(in[e]);
              o[e] = __floats2bfloat162_rn(f.x * sn[cg + 2 * e],
                                           f.y * sn[cg + 2 * e + 1]);
            }
          }
        }
        *reinterpret_cast<uint4*>(As + p * kLdA + cv) = out;
      }
      // B: 32 channels x 64 columns, as 256 vectors of 8 columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int v = tid + 128 * r;
        const int c = v / 8, jv = (v % 8) * 8;
        const int cg = c0 + c, jg = j0 + jv;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (cg < Ci && jg < CoK)
          val = *reinterpret_cast<const uint4*>(wt + (long long)cg * CoK + jg);
        *reinterpret_cast<uint4*>(Bs + c * kLdB + jv) = val;
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

  const int Co = CoK / phases;
  const float* pn = post + (long long)n * CoK;
  for (int e = tid; e < kBM * kBN; e += 128) {
    const int p = p0 + e / kBN, jg = j0 + e % kBN;
    if (p >= HW || jg >= CoK) continue;
    const int hh = p / W, ww = p % W;
    const int co = jg / phases;
    float v = Cs[(e / kBN) * kLdC + e % kBN] * pn[jg];
    if (act != GT_ACT_NONE) v = apply_act(v + bias[co], act, alpha, gain);
    long long off;
    if (phases == 1) {
      off = (((long long)n * H + hh) * W + ww) * Co + co;
    } else {
      const int a = (jg % 4) / 2, b = jg % 2;
      off = (((long long)n * 2 * H + 2 * hh + a) * 2 * W + 2 * ww + b) * Co +
            co;
    }
    y[off] = __float2bfloat16(v);
  }
}

template <typename T>
void launch(const void* x, const void* w, const float* s, const float* post,
            const float* bias, void* y, int N, int H, int W, int Ci, int CoK,
            int phases, const Taps& taps, int act, float alpha, float gain,
            cudaStream_t stream) {
  dim3 grid((H * W + kBM - 1) / kBM, (CoK + kBN - 1) / kBN, N);
  modconv_kernel<T><<<grid, 256, 0, stream>>>(
      (const T*)x, (const T*)w, s, post, bias, (T*)y, H, W, Ci, CoK, phases,
      taps, act, alpha, gain);
}

}  // namespace

extern "C" int gt_modconv(int dtype, const void* x, const void* w,
                          const float* s, const float* post, const float* bias,
                          void* y, int N, int H, int W, int Ci, int CoK,
                          int phases, int ntaps, const int* tap_oy,
                          const int* tap_ox, int act, float alpha, float gain,
                          void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || (phases != 1 && phases != 4) ||
      CoK % phases)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ntaps;
  for (int t = 0; t < ntaps; ++t) {
    taps.oy[t] = tap_oy[t];
    taps.ox[t] = tap_ox[t];
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    launch<float>(x, w, s, post, bias, y, N, H, W, Ci, CoK, phases, taps, act,
                  alpha, gain, st);
  else if (dtype == GT_DTYPE_BF16 && Ci % 8 == 0 && CoK % 8 == 0)
    modconv_wmma_kernel<<<dim3((H * W + kBM - 1) / kBM, (CoK + kBN - 1) / kBN,
                               N),
                          128, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, s, post, bias,
        (__nv_bfloat16*)y, H, W, Ci, CoK, phases, taps, act, alpha, gain);
  else if (dtype == GT_DTYPE_BF16)
    launch<__nv_bfloat16>(x, w, s, post, bias, y, N, H, W, Ci, CoK, phases,
                          taps, act, alpha, gain, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
