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
// into a per-sample weight tile; here s scales the activation operand and
// d (post) goes into the fp32 epilogue, so one weight tile serves every
// sample of the batch.  The rounding point is that of _ref_core (x * s
// rounded to x's dtype before the conv), which modconv_plain follows.
//
// Bound on the H100: the multiply-adds over the bf16 tensor peak (3x3
// convs and up-convs at 128-512 channels), the bytes of x and y (the
// 3-channel tRGB).  Three paths, chosen by the wrapper (ops/cuda_modconv.py
// fwd_path) and checked here:
//   wgmma (bf16 same3 / poly / same1 with channel counts that are multiples
//     of 8): an implicit GEMM with M = 128 consecutive pixels of the
//     flattened [N * H * W] (whole rows of one sample, a run of one row, or
//     whole samples where a sample has fewer than 128 pixels), N = 64 or 128
//     columns, contraction = Ci x taps in stages of 64 channels x one tap,
//     chunk-major.  One producer thread lands each stage by TMA into a ring
//     of 7-9 slots (hopper.cuh TmaRing): the x box shifted by the tap,
//     zero-filled outside the image sample by sample (no halo code; poly's
//     taps read one row and column past the edge as zeros), and the weight
//     boxes [64 ci x 64 columns] of wstack [T, Ci, CoK], shared by the whole
//     batch.  Two consumer warpgroups read their 64 rows of the x slot with
//     ldmatrix, scale each row's channels by its own sample's s in fp32
//     (the styles are read once per channel chunk), round to bf16 and issue
//     wgmma with A from registers (B from the swizzled slot), accumulating
//     in fp32 registers, one wgmma group in flight.  That scaling is the
//     price of one weight tile for the batch: on the H100 it takes about a
//     third of the time at res 32-256 (a copy without it ran 1.30 ms
//     against 1.71 over the 20 launches of a synthesize at batch 8).  Where
//     the output tiles give fewer than half as many blocks as the card has
//     SMs (res 4-16 at 512 channels), the stages are split over P blocks
//     (split-K over channel chunks x taps) that write fp32 partials, and
//     fwd_reduce_kernel sums them in a fixed order (deterministic) and
//     applies d and the epilogue.  The epilogue stages the tile in shared
//     memory and writes 16 bytes a thread: poly's co-major phase columns
//     co * 4 + a * 2 + b go to (2h + a, 2w + b, co), 8 channels at a time.
//   small-K (bf16, CoK <= 4, one tap at offset 0: the tRGB): bound by the
//     bytes of x, which each thread reads 16 bytes at a time; three fp32
//     dot products per pixel with s folded in, reduced across the pixel's
//     threads by shuffles.
//   FMA (fp32, or any other shape): 64 x 64 tiles on the fp32 FMA units.
#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16 wgmma path -------------------------------------------------------

constexpr int kFwdBM = 128;        // pixels per tile (two warpgroups of 64)
constexpr int kFwdBK = 64;         // input channels per stage
constexpr int kFwdConsumers = 256; // two consumer warpgroups
constexpr int kFwdThreads = 288;   // and the producer warp
constexpr int kBlock = 64 * 128;   // 64 swizzled rows of 128 bytes
constexpr int kAlign = 1024;       // slack to align the ring to 1 KB

template <int BN>
__host__ __device__ constexpr int fwd_stage_bytes() {
  return kFwdBM * 128 + (BN / 64) * kBlock;
}

// Ring slots, as many as one block an SM may hold in 227 KB (the
// epilogue's tile reuses the ring): 7 for the 128-wide tile, 9 for the
// 64-wide one.
template <int BN>
__host__ __device__ constexpr int fwd_stages() {
  return BN == 128 ? 7 : 9;
}

template <int BN>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return fwd_stages<BN>() * fwd_stage_bytes<BN>() + kAlign;
}

// The epilogue of 8 values of one pixel (sample n, pixel p of H x W): column
// j0 .. j0 + 7 (phases 1), or channels co .. co + 7 of phase ph = a * 2 + b
// (poly, columns co * 4 + ph): times post, + bias and act, 16 bytes of y.
__device__ __forceinline__ void emit8(float (&v)[8], int n, int p, int j0,
                                      int ph, const float* __restrict__ post,
                                      const float* __restrict__ bias,
                                      __nv_bfloat16* __restrict__ y, int H,
                                      int W, int CoK, int phases, int act,
                                      float alpha, float gain) {
  const float* pn = post + (long long)n * CoK;
  long long off;
  if (phases == 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] *= pn[j0 + e];
      if (act != GT_ACT_NONE) v[e] = apply_act(v[e] + bias[j0 + e], act,
                                               alpha, gain);
    }
    off = ((long long)n * H * W + p) * CoK + j0;
  } else {
    const int Co = CoK / 4;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] *= pn[(j0 + e) * 4 + ph];
      if (act != GT_ACT_NONE) v[e] = apply_act(v[e] + bias[j0 + e], act,
                                               alpha, gain);
    }
    const int h = p / W, w = p % W, a = ph / 2, b = ph % 2;
    off = (((long long)n * 2 * H + 2 * h + a) * 2 * W + 2 * w + b) * Co + j0;
  }
  uint4 o;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    oh[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(y + off) = o;
}

// One block per (128 pixels, BN columns, split): the split's stages j in
// [jb, je) of the contraction, stage j = (channels 64 * (j / T) .., tap j %
// T), chunk-major so that a chunk's styles serve its T stages.  P = 1
// writes y; P > 1 writes the fp32 partial part[split, pixel, column] for
// fwd_reduce_kernel.
template <int BN>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ s,
                     const float* __restrict__ post,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                     int N, int H, int W, int Ci, int CoK, int phases,
                     Taps taps, int P, int act, float alpha, float gain) {
  constexpr int S = fwd_stages<BN>();
  constexpr int kABytes = kFwdBM * 128;
  constexpr int kStage = fwd_stage_bytes<BN>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int s_oy[kMaxTaps], s_ox[kMaxTaps];
  __shared__ __align__(8) TmaRing<S> ring;
  unsigned char* smem =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));

  const long long base = (long long)blockIdx.x * kFwdBM;  // first pixel
  const int c0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int HW = H * W;
  const long long pixels = (long long)N * HW;
  const int kchunks = (Ci + kFwdBK - 1) / kFwdBK;
  const int stages = taps.n * kchunks;
  const int jb = stages * split / P;
  const int nst = stages * (split + 1) / P - jb;
  if (tid < taps.n) {
    s_oy[tid] = taps.oy[tid];
    s_ox[tid] = taps.ox[tid];
  }
  if (tid == 0) ring.init(kFwdConsumers / 128);
  __syncthreads();

  // Producer: stage i of the split into slot i % S once both consumer
  // warpgroups have handed the slot back: the x box of the tile's pixels
  // shifted by the tap (128 consecutive pixels: whole rows, a run of one
  // row, or whole samples) and the BN / 64 weight boxes.
  if (tid >= kFwdConsumers) {
    if (tid == kFwdConsumers) {
      const int n0 = (int)(base / HW), p0 = (int)(base % HW);
      const int h0 = p0 / W, w0 = p0 % W;
      for (int i = 0; i < nst; ++i) {
        const int j = jb + i;
        uint64_t* bar = ring.acquire(i, kStage);
        unsigned char* sa = smem + (i % S) * kStage;
        const int t = j % taps.n, k0 = (j / taps.n) * kFwdBK;
        tma_load_4d(sa, &tm_x, bar, k0, w0 + s_ox[t], h0 + s_oy[t], n0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_4d(sa + kABytes + b * kBlock, &tm_w, bar, c0 + 64 * b, k0,
                      t, 0);
      }
    }
    return;
  }

  // Consumers.  ldmatrix: lane l reads row 16 * warp + l % 16 of its
  // warpgroup's 64 rows at 8-channel chunk 2 * ks + l / 16 (128-byte
  // swizzle: chunk c of row r lies at chunk c ^ (r % 8)).  Its fragment
  // rows are r0 and r0 + 8, each scaled by its own sample's s.
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int lr = warp * 16 + lane % 16, lhalf = lane / 16;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const float* srow[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long f = base + r0 + 8 * hf;
    srow[hf] = s + (long long)min((int)(f / HW), N - 1) * Ci;
  }
  const int cq = 2 * (lane % 4);

  // The styles of stage i's channel chunk for this thread's fragment (read
  // where a chunk starts, before its slot is waited for, so that their
  // latency hides behind the wait); stage i's fragments from the slot,
  // scaled and rounded to bf16.
  auto styles = [&](int i, float2(&sv)[4][4]) {
    const int k0 = ((jb + i) / taps.n) * kFwdBK;
#pragma unroll
    for (int ks = 0; ks < kFwdBK / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = k0 + ks * 16 + 8 * (q / 2) + cq;
        sv[ks][q] = c < Ci ? *reinterpret_cast<const float2*>(srow[q % 2] + c)
                           : make_float2(0.f, 0.f);
      }
  };
  auto load = [&](int i, const float2(&sv)[4][4], uint32_t(&a)[4][4]) {
    const uint32_t slot = smem_u32(smem + (i % S) * kStage) + wg * kBlock;
#pragma unroll
    for (int ks = 0; ks < kFwdBK / 16; ++ks) {
      ldmatrix_x4(a[ks], slot + lr * 128 +
                             (((2 * ks + lhalf) ^ (lr % 8)) << 4));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&a[ks][q]);
        const float2 f = __bfloat1622float2(h);
        h = __floats2bfloat162_rn(f.x * sv[ks][q].x, f.y * sv[ks][q].y);
        a[ks][q] = *reinterpret_cast<uint32_t*>(&h);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // Stage i's wgmma group on fragments a.
  auto issue = [&](int i, const uint32_t(&a)[4][4]) {
    const uint32_t b0 = smem_u32(smem + (i % S) * kStage + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kFwdBK / 16; ++ks)
      wgmma_tile_rs<BN, 1>(acc, a[ks],
                           gmma_desc(b0 + ks * 16 * 128, kBlock, 1024));
    wgmma_commit();
  };
  float2 sv[4][4];
  // Stage i's fragments: its chunk's styles, its slot, ldmatrix and
  // scale.
  auto prepare = [&](int i, uint32_t(&a)[4][4]) {
    if (i == 0 || (jb + i) % taps.n == 0) styles(i, sv);
    ring.wait(i);
    load(i, sv, a);
  };
  // One wgmma group stays in flight: stage i's group is issued, then the
  // wait for all but one group completes stage i - 1, whose slot and
  // fragments go back (the fragments to stage i + 1).  Unrolled by two so
  // that the fragments in flight keep their registers.
  uint32_t fa[4][4], fb[4][4];
  prepare(0, fa);
  for (int i = 0; i < nst; i += 2) {
    issue(i, fa);
    wgmma_wait<1>();
    fence_acc(acc);
    if (i > 0 && tid % 128 == 0) ring.release(i - 1);
    if (i + 1 >= nst) break;
    prepare(i + 1, fb);
    issue(i + 1, fb);
    wgmma_wait<1>();
    fence_acc(acc);
    if (tid % 128 == 0) ring.release(i);
    if (i + 2 < nst) prepare(i + 2, fa);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue: the tile goes through shared memory (fp32, padded rows) so
  // that each thread writes 16 bytes: 8 columns of one pixel (phases 1),
  // 8 channels of one phase of one pixel (poly), or 8 fp32 partials.
  constexpr int kLd = BN + 4;
  bar_sync<1, kFwdConsumers>();  // both warpgroups are done with the ring
  float* cs = reinterpret_cast<float*>(smem);  // [kFwdBM][kLd]
  {
    const int rr = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int jb8 = 0; jb8 < BN / 8; ++jb8)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(cs + (rr + 8 * hf) * kLd + jb8 * 8 + cq) =
            make_float2(acc[jb8 * 4 + 2 * hf], acc[jb8 * 4 + 2 * hf + 1]);
  }
  bar_sync<1, kFwdConsumers>();
  constexpr int kUnits = BN / 8;  // 16-byte units of a row
  for (int e = tid; e < kFwdBM * kUnits; e += kFwdConsumers) {
    const int r = e / kUnits, u = e % kUnits;
    const long long f = base + r;
    if (f >= pixels) continue;
    const int n = (int)(f / HW), p = (int)(f % HW);
    float v[8];
    if (P > 1 || phases == 1) {
      const int j = c0 + u * 8;
      if (j >= CoK) continue;
      const float* cr = cs + r * kLd + u * 8;
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = cr[q];
      if (P > 1) {
        float* dst = part + ((long long)split * pixels + f) * CoK + j;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      } else {
        emit8(v, n, p, j, 0, post, bias, y, H, W, CoK, 1, act, alpha, gain);
      }
    } else {
      // unit u = (phase, 8-channel group g); the tile holds BN / 4 channels
      constexpr int kGroups = BN / 32;
      const int ph = u / kGroups, g = u % kGroups;
      const int co = c0 / 4 + g * 8;
      if (co >= CoK / 4) continue;
      const float* cr = cs + r * kLd + g * 32 + ph;
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = cr[4 * q];
      emit8(v, n, p, co, ph, post, bias, y, H, W, CoK, 4, act, alpha, gain);
    }
  }
}

// y from the P fp32 partials [P, N * H * W, CoK], summed in split order:
// one thread per pixel and 8 columns (phases 1) or 8 channels x 4 phases
// (poly), then d, the bias and act (emit8).
__global__ void __launch_bounds__(256)
    fwd_reduce_kernel(const float* __restrict__ part,
                      const float* __restrict__ post,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int N, int H, int W,
                      int CoK, int phases, int P, int act, float alpha,
                      float gain) {
  const int units = CoK / (8 * phases);
  const long long pixels = (long long)N * H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pixels * units) return;
  const long long f = idx / units;
  const int u = (int)(idx % units);
  const int n = (int)(f / (H * W)), p = (int)(f % (H * W));
  if (phases == 1) {
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int b = 0; b < P; ++b) {
      const float* src = part + ((long long)b * pixels + f) * CoK + u * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    emit8(v, n, p, u * 8, 0, post, bias, y, H, W, CoK, 1, act, alpha, gain);
    return;
  }
  float v[4][8];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
#pragma unroll
    for (int q = 0; q < 8; ++q) v[ph][q] = 0.f;
  for (int b = 0; b < P; ++b) {
    const float* src = part + ((long long)b * pixels + f) * CoK + u * 32;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 c = *reinterpret_cast<const float4*>(src + 4 * q);
      v[0][q] += c.x;
      v[1][q] += c.y;
      v[2][q] += c.z;
      v[3][q] += c.w;
    }
  }
#pragma unroll
  for (int ph = 0; ph < 4; ++ph)
    emit8(v[ph], n, p, u * 8, ph, post, bias, y, H, W, CoK, 4, act, alpha,
          gain);
}

// ---- bf16 tRGB: CoK <= kSmallK output columns, one tap at offset 0 ---------
//
// A pixel's Ci channels are read by tpp = min(Ci / 8, 32) threads, 16 bytes
// (8 channels) at a time; each forms CoK partial dot products of round(x *
// s) with w in fp32, the pixel's threads add them by shuffles, and the
// block's results go out through shared memory in coalesced 2-byte stores.

constexpr int kSmallK = 4;       // output columns of this path, at most
constexpr int kSmallTile = 256;  // pixels per block
constexpr int kSmallPer = 2;     // 16-byte chunks per thread, at most (Ci <= 512)

__global__ void __launch_bounds__(256)
    fwd_smallk_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ s,
                      const float* __restrict__ post,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int HW, int Ci, int CoK,
                      int act, float alpha, float gain) {
  __shared__ float res[kSmallTile * kSmallK];
  const int n = blockIdx.y;
  const int chunks = Ci / 8;
  const int tpp = chunks < 32 ? chunks : 32;   // threads per pixel
  const int per = chunks / tpp;                // chunks per thread
  const int ppw = 32 / tpp;                    // pixels per warp and pass
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int sub = lane % tpp;
  const int p0 = blockIdx.x * kSmallTile;
  const int np = min(HW - p0, kSmallTile);

  float wr[kSmallPer][8][kSmallK], sr[kSmallPer][8];
#pragma unroll
  for (int q = 0; q < kSmallPer; ++q) {
    const int c = (sub + q * tpp) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = q < per;
      sr[q][e] = in ? s[(long long)n * Ci + c + e] : 0.f;
#pragma unroll
      for (int k = 0; k < kSmallK; ++k)
        wr[q][e][k] = in && k < CoK
                          ? __bfloat162float(w[(long long)(c + e) * CoK + k])
                          : 0.f;
    }
  }
  float pk[kSmallK], bk[kSmallK];
#pragma unroll
  for (int k = 0; k < kSmallK; ++k) {
    pk[k] = k < CoK ? post[(long long)n * CoK + k] : 0.f;
    bk[k] = k < CoK && act != GT_ACT_NONE ? bias[k] : 0.f;
  }

  // every lane takes every pass (the shuffles need the whole warp)
  for (int base = warp * ppw; base < np; base += 8 * ppw) {
    const int pl = base + lane / tpp;
    const bool valid = pl < np;
    float acc[kSmallK] = {0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const __nv_bfloat16* xp = x + ((long long)n * HW + p0 + pl) * Ci;
#pragma unroll
      for (int q = 0; q < kSmallPer; ++q) {
        if (q >= per) break;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(xp + (sub + q * tpp) * 8);
        const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(xh[e]);
          const float x0 = round_to<__nv_bfloat16>(f.x * sr[q][2 * e]);
          const float x1 = round_to<__nv_bfloat16>(f.y * sr[q][2 * e + 1]);
#pragma unroll
          for (int k = 0; k < kSmallK; ++k)
            acc[k] += x0 * wr[q][2 * e][k] + x1 * wr[q][2 * e + 1][k];
        }
      }
    }
    for (int o = tpp / 2; o > 0; o /= 2)
#pragma unroll
      for (int k = 0; k < kSmallK; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
    if (valid && sub == 0)
#pragma unroll
      for (int k = 0; k < kSmallK; ++k) {
        float v = acc[k] * pk[k];
        if (act != GT_ACT_NONE) v = apply_act(v + bk[k], act, alpha, gain);
        res[pl * kSmallK + k] = v;
      }
  }
  __syncthreads();
  __nv_bfloat16* yn = y + ((long long)n * HW + p0) * CoK;
  for (int i = tid; i < np * CoK; i += 256)
    yn[i] = __float2bfloat16(res[(i / CoK) * kSmallK + i % CoK]);
}

// ---- paths and launches ----------------------------------------------------

enum Path { kPathFma = 0, kPathWgmma = 1, kPathSmallK = 2 };

// The pixels of a wgmma tile are 128 consecutive pixels of the flattened
// [N * H * W] that one TMA box covers: a run of one row (W a multiple of
// 128), or whole rows of one sample, or whole samples (W dividing 128, and
// H * W a multiple or a divisor of 128).
bool tile_fits(int H, int W) {
  if (W <= 0 || H <= 0) return false;
  if (W >= kFwdBM) return W % kFwdBM == 0;
  const int hw = H * W;
  return kFwdBM % W == 0 && (hw % kFwdBM == 0 || kFwdBM % hw == 0);
}

bool path_fits(int path, int dtype, int H, int W, int Ci, int CoK,
               int phases, const Taps& taps) {
  if (path == kPathFma)
    return dtype == GT_DTYPE_F32 || dtype == GT_DTYPE_BF16;
  if (dtype != GT_DTYPE_BF16 || Ci % 8 != 0) return false;
  if (path == kPathWgmma)
    return CoK % (8 * phases) == 0 && tile_fits(H, W);
  const int chunks = Ci / 8;
  return path == kPathSmallK && phases == 1 && CoK <= kSmallK &&
         Ci <= 8 * 32 * kSmallPer && (32 % chunks == 0 || chunks % 32 == 0) &&
         taps.n == 1 && taps.oy[0] == 0 && taps.ox[0] == 0;
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const float* s,
                 const float* post, const float* bias, void* y, float* part,
                 int N, int H, int W, int Ci, int CoK, int phases,
                 const Taps& taps, int P, int act, float alpha, float gain,
                 cudaStream_t st) {
  constexpr int smem = fwd_smem_bytes<BN>();
  // the opt-in belongs to the current device: made at every launch
  const int attr = set_smem(fwd_wgmma_kernel<BN>, smem);
  if (attr != 0) return attr;
  // x in boxes of 64 channels x 128 consecutive pixels: bw x bh pixels of
  // bn samples
  const int bw = W < kFwdBM ? W : kFwdBM;
  int bh = kFwdBM / bw, bn = 1;
  if (bh > H) {
    bn = bh / H;
    bh = H;
  }
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xdims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)N};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh,
                              (cuuint32_t)bn};
  int rc = bf16_map(&tm_x, x, 4, xdims, xbox);
  const cuuint64_t wdims[4] = {(cuuint64_t)CoK, (cuuint64_t)Ci,
                               (cuuint64_t)taps.n, 1};
  const cuuint32_t wbox[4] = {64, kFwdBK, 1, 1};
  if (rc == 0) rc = bf16_map(&tm_w, w, 4, wdims, wbox);
  if (rc != 0) return rc;
  const long long pixels = (long long)N * H * W;
  dim3 grid((unsigned)((pixels + kFwdBM - 1) / kFwdBM), (CoK + BN - 1) / BN,
            P);
  fwd_wgmma_kernel<BN><<<grid, kFwdThreads, smem, st>>>(
      tm_x, tm_w, s, post, bias, (__nv_bfloat16*)y, part, N, H, W, Ci, CoK,
      phases, taps, P, act, alpha, gain);
  rc = (int)cudaGetLastError();
  if (rc != 0 || P == 1) return rc;
  const long long threads = pixels * (CoK / (8 * phases));
  fwd_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      part, post, bias, (__nv_bfloat16*)y, N, H, W, CoK, phases, P, act,
      alpha, gain);
  return (int)cudaGetLastError();
}

}  // namespace

// Pixels of one output tile of a forward launch on `path`.
extern "C" int gt_modconv_fwd_tile(int path) {
  return path == kPathWgmma ? kFwdBM : path == kPathSmallK ? kSmallTile : kBM;
}

// Dynamic shared memory of a forward launch on `path` with CoK output
// columns: the ring and its 1 KB of alignment slack on the wgmma path (the
// epilogue's tile reuses the ring), 0 bytes on the others.
extern "C" int gt_modconv_fwd_smem(int path, int CoK) {
  if (path != kPathWgmma) return 0;
  return CoK >= 128 ? fwd_smem_bytes<128>() : fwd_smem_bytes<64>();
}

// y [N, up H, up W, CoK / phases] from x [N,H,W,Ci], the stacked weights
// w [T, Ci, CoK], s [N,Ci], post [N,CoK] and bias [CoK / phases] (fp32;
// bias read only with an epilogue), on `path` (ops/cuda_modconv.py
// fwd_path); P > 1 splits the wgmma path's stages over P blocks per tile,
// with part fp32 scratch of [P, N * H * W, CoK].
extern "C" int gt_modconv(int path, int dtype, const void* x, const void* w,
                          const float* s, const float* post, const float* bias,
                          void* y, float* part, int N, int H, int W, int Ci,
                          int CoK, int phases, int ntaps, const int* tap_oy,
                          const int* tap_ox, int P, int act, float alpha,
                          float gain, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || (phases != 1 && phases != 4) ||
      CoK % phases)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ntaps;
  for (int t = 0; t < ntaps; ++t) {
    taps.oy[t] = tap_oy[t];
    taps.ox[t] = tap_ox[t];
  }
  const int stages = ntaps * ((Ci + kFwdBK - 1) / kFwdBK);
  if (!path_fits(path, dtype, H, W, Ci, CoK, phases, taps) || P < 1 ||
      (P > 1 && (path != kPathWgmma || P > stages || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == kPathWgmma)
    return CoK >= 128
               ? launch_wgmma<128>(x, w, s, post, bias, y, part, N, H, W, Ci,
                                   CoK, phases, taps, P, act, alpha, gain, st)
               : launch_wgmma<64>(x, w, s, post, bias, y, part, N, H, W, Ci,
                                  CoK, phases, taps, P, act, alpha, gain, st);
  if (path == kPathSmallK) {
    dim3 grid((H * W + kSmallTile - 1) / kSmallTile, N);
    fwd_smallk_kernel<<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, s, post, bias,
        (__nv_bfloat16*)y, H * W, Ci, CoK, act, alpha, gain);
  } else if (dtype == GT_DTYPE_F32) {
    launch<float>(x, w, s, post, bias, y, N, H, W, Ci, CoK, phases, taps, act,
                  alpha, gain, st);
  } else {
    launch<__nv_bfloat16>(x, w, s, post, bias, y, N, H, W, Ci, CoK, phases,
                          taps, act, alpha, gain, st);
  }
  return (int)cudaGetLastError();
}
