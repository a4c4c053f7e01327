// upfirdn2d on NHWC: zero-insert upsample -> pad/crop -> true-convolution FIR
// -> decimate, with an optional act(y + bias) * gain epilogue.
//
// Replaces the Pallas kernel gansformer_tpu/ops/pallas_upfirdn.py
// (_upfirdn_body, launched by _ufd_call; re-entered as the adjoint by
// _ufd_bwd_rule and _ufd_ba_bwd_rule).  Bound on this card: bytes.  A 4x4
// FIR does 16 multiply-adds per output element, far below the ~295
// operations per byte where Hopper's compute would become the limit, so
// the least time is one read of the input and one write of the output.
// The TPU version pads the whole block in VMEM and walks the taps as
// strided slices.  Three routes here, picked by the wrapper
// (ops/cuda_upfirdn.py ufd_path, mirrored by ufd_plan below):
//
// * ufd_tile_kernel<T, UP, DOWN> (every preset launch with C a multiple
//   of the 16-byte vector: the generator's blur, the discriminator's
//   blur-pool and decimated skip, the adjoints of all three).  One block
//   per (sample, output tile, channel block of up to 128 bytes a pixel).
//   The block copies the tile's input window into shared memory with
//   16-byte cp.async, zero-filled where the window leaves the image, so
//   pads and negative crops cost no code.  Each thread then owns one
//   16-byte channel vector x P consecutive output columns of a row: per
//   filter row it reads the (P - 1) * DOWN + 4 window columns those
//   outputs need once, 16 bytes at a time, and adds each to every output
//   whose tap it is (compile-time indices, no per-tap test).  With UP = 2
//   each output phase uses only its own 2 x 2 taps of the 4x4 filter: the
//   wrapper hands a 2 x 2 x 3 x 3 table of the taps each phase applies to
//   each of its 3 x 3 window offsets (zeros where none), so the phase
//   arithmetic is done once on the host.  Window rows are padded so the
//   16-byte reads of a quarter warp fall in distinct banks.
// * ufd_smallc_kernel<T, UP, DOWN> (C <= 4 channels, not a multiple of the
//   vector: the tRGB skip upsample, C = 3 and up 2, and its adjoint, down
//   2).  One thread per output pixel, or per 2 x 2 output quad with
//   UP = 2, all channels in registers, the same tap tables.
// * upfirdn_kernel<T, UP, DOWN> (the general route: any filter of up to 64
//   taps, any factors).  One thread per output element, channel fastest;
//   for each tap it works out which input sample it reads.  No preset
//   launch takes it.
//
// Rounding: every route sums in fp32 and rounds once to the storage type
// after the epilogue, as _upfirdn_body does (acc.astype(o_ref.dtype)).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxTaps = 64;  // fh * fw
constexpr int kThreads = 256;
constexpr int kSmallC = 4;    // channels of the small-channel route, at most

enum { kPathGeneral = 0, kPathTile = 1, kPathSmallC = 2 };

struct Filter {
  float v[kMaxTaps];
};

__host__ __device__ __forceinline__ int floor_div2(int a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

// The tile plan of a launch: nv 16-byte vectors a pixel (the channel
// block), threads as nv x tr rows x gx column groups, each thread P
// output columns (UP = 2: P / 2 pairs) of ry rows; the tile th x tw; the
// input window wh x ww pixels, each window row `pitch` 16-byte units
// apart.
struct TilePlan {
  int nv, tr, gx, ry, p, th, tw, wh, ww, pitch, smem;
};

TilePlan tile_plan(int dtype, int C, int up, int down) {
  TilePlan t;
  const int vec = dtype == GT_DTYPE_BF16 ? 8 : 4;
  t.nv = 8;
  while (t.nv > 1 && (C / vec) % t.nv) t.nv >>= 1;
  t.gx = t.nv >= 4 ? 4 : 8;
  t.tr = kThreads / t.nv / t.gx;
  t.p = down == 2 ? 2 : 4;
  t.ry = up == 2 ? 2 : (down == 2 ? 1 : (t.nv == 8 ? 2 : 1));
  t.th = t.tr * t.ry;
  t.tw = t.gx * t.p;
  if (up == 2) {
    t.wh = t.th / 2 + 2;
    t.ww = t.tw / 2 + 2;
  } else {
    t.wh = (t.th - 1) * down + 4;
    t.ww = (t.tw - 1) * down + 4;
  }
  // the rows a quarter warp reads are `step` window rows apart; pick the
  // pitch so their 16-byte units land in distinct banks
  int skew = 0;
  if (t.nv == 4) skew = (up == 1 && down == 1) ? 4 : 2;
  if (t.nv == 2) skew = down == 2 ? 1 : 2;
  if (t.nv == 1) skew = 1;
  t.pitch = t.ww * t.nv + (((skew - t.ww * t.nv) % 8) + 8) % 8;
  t.smem = t.wh * t.pitch * 16;
  return t;
}

int ufd_path(int dtype, int C, int up, int down, int fh, int fw) {
  const bool factors = (up == 1 && down == 1) || (up == 2 && down == 1) ||
                       (up == 1 && down == 2);
  if (fh != 4 || fw != 4 || !factors) return kPathGeneral;
  const int vec = dtype == GT_DTYPE_BF16 ? 8 : 4;
  if (C % vec == 0 && tile_plan(dtype, C, up, down).smem <= kMaxSmem)
    return kPathTile;
  if (C <= kSmallC) return kPathSmallC;
  return kPathGeneral;
}

// 16 bytes of shared memory as fp32 values, and back to storage.
__device__ __forceinline__ void load16(const unsigned char* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load16(const unsigned char* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// Apply the epilogue to one output vector and store it (16 bytes).
template <typename T, int VEC>
__device__ __forceinline__ void put(T* dst, float (&acc)[VEC],
                                    const float (&b)[VEC], int act,
                                    float alpha, float gain) {
  if (act != GT_ACT_NONE) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      acc[i] = apply_act(acc[i] + b[i], act, alpha, gain);
  }
  store16(dst, acc);
}

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
    ufd_tile_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    T* __restrict__ y, int H, int W, int C, int OH, int OW,
                    int py0, int px0, TilePlan tp, int tiles_x, Filter g,
                    int act, float alpha, float gain) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int P = DOWN == 2 ? 2 : 4;
  extern __shared__ __align__(16) unsigned char win[];
  const int n = blockIdx.z, cb = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * tp.th;
  const int ox0 = (blockIdx.x % tiles_x) * tp.tw;
  const int iy0 = UP == 2 ? floor_div2(oy0 - py0) : oy0 * DOWN - py0;
  const int ix0 = UP == 2 ? floor_div2(ox0 - px0) : ox0 * DOWN - px0;
  const int nv = tp.nv;
  // 32-bit index math: the wrapper rejects tensors of 2^31 elements or more
  const T* xn = x + n * H * W * C + cb * nv * VEC;

  const int chunks = tp.wh * tp.ww * nv;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int v = i % nv, pix = i / nv;
    const int wx = pix % tp.ww, wy = pix / tp.ww;
    const int iy = iy0 + wy, ix = ix0 + wx;
    const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
    cp_async16(win + (wy * tp.pitch + wx * nv + v) * 16,
               in ? xn + (iy * W + ix) * C + v * VEC : xn, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int v = threadIdx.x % nv, slot = threadIdx.x / nv;
  const int r = slot % tp.tr, gi = slot / tp.tr;
  const int c0 = cb * nv * VEC + v * VEC;
  float b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    b[i] = (act != GT_ACT_NONE && bias != nullptr) ? bias[c0 + i] : 0.f;
  const unsigned char* wv = win + v * 16;
  const int px = nv * 16;              // bytes of one window pixel
  const int pitch = tp.pitch * 16;     // bytes of one window row

  for (int k = 0; k < tp.ry; ++k) {
    const int yl = r + k * tp.tr;
    const int oy = oy0 + yl;
    if (oy >= OH) break;
    float acc[P][VEC];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[p][i] = 0.f;
    if constexpr (UP == 1) {
      const int xl0 = gi * P;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const unsigned char* row =
            wv + (yl * DOWN + a) * pitch + xl0 * DOWN * px;
#pragma unroll
        for (int c = 0; c < (P - 1) * DOWN + 4; ++c) {
          float xv[VEC];
          load16(row + c * px, xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int j = c - p * DOWN;
            if (j >= 0 && j < 4) {
              const float w = g.v[a * 4 + j];
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                acc[p][i] = fmaf(w, xv[i], acc[p][i]);
            }
          }
        }
      }
    } else {
      // outputs 2 * (mx0 + m) + ax of output row yl, phase ay = yl % 2
      // (tiles start on even rows and columns, tr is even)
      const int ay = yl & 1, my = yl >> 1, mx0 = gi * (P / 2);
      float gs[2][3][3];
#pragma unroll
      for (int ax = 0; ax < 2; ++ax)
#pragma unroll
        for (int o1 = 0; o1 < 3; ++o1)
#pragma unroll
          for (int o2 = 0; o2 < 3; ++o2) {
            const int at = (ax * 3 + o1) * 3 + o2;
            gs[ax][o1][o2] = ay ? g.v[18 + at] : g.v[at];
          }
#pragma unroll
      for (int o1 = 0; o1 < 3; ++o1) {
        const unsigned char* row = wv + (my + o1) * pitch + mx0 * px;
#pragma unroll
        for (int c = 0; c < P / 2 + 2; ++c) {
          float xv[VEC];
          load16(row + c * px, xv);
#pragma unroll
          for (int m = 0; m < P / 2; ++m) {
            const int o2 = c - m;
            if (o2 >= 0 && o2 < 3) {
#pragma unroll
              for (int ax = 0; ax < 2; ++ax)
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                  acc[2 * m + ax][i] =
                      fmaf(gs[ax][o1][o2], xv[i], acc[2 * m + ax][i]);
            }
          }
        }
      }
    }
    T* yrow = y + (n * OH + oy) * OW * C + c0;
    const int xl0 = gi * P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int ox = ox0 + xl0 + p;
      if (ox < OW) put<T, VEC>(yrow + ox * C, acc[p], b, act, alpha, gain);
    }
  }
}

// One thread per output pixel (UP = 1) or 2 x 2 output quad (UP = 2),
// the C <= kSmallC channels of each input pixel read as scalars (the
// pixels are not 16-byte aligned); the tap tables of ufd_tile_kernel.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
    ufd_smallc_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                      T* __restrict__ y, int N, int H, int W, int C, int OH,
                      int OW, int py0, int px0, Filter g, int act,
                      float alpha, float gain) {
  constexpr int Q = UP == 2 ? 4 : 1;   // outputs a thread
  const int UH = UP == 2 ? (OH + 1) / 2 : OH;
  const int UW = UP == 2 ? (OW + 1) / 2 : OW;
  const int total = N * UH * UW;
  float b[kSmallC];
#pragma unroll
  for (int c = 0; c < kSmallC; ++c)
    b[c] = (act != GT_ACT_NONE && bias != nullptr && c < C) ? bias[c] : 0.f;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int ux = idx % UW;
    const int t = idx / UW;
    const int uy = t % UH, n = t / UH;
    const T* xn = x + n * H * W * C;
    float acc[Q][kSmallC];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int c = 0; c < kSmallC; ++c) acc[q][c] = 0.f;
    constexpr int K = UP == 2 ? 3 : 4;   // window offsets per dimension
    const int iy0 = UP == 2 ? floor_div2(2 * uy - py0) : uy * DOWN - py0;
    const int ix0 = UP == 2 ? floor_div2(2 * ux - px0) : ux * DOWN - px0;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      const int iy = iy0 + a;
      if (iy < 0 || iy >= H) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int ix = ix0 + j;
        if (ix < 0 || ix >= W) continue;
        const T* p = xn + (iy * W + ix) * C;
        float xv[kSmallC];
#pragma unroll
        for (int c = 0; c < kSmallC; ++c) xv[c] = c < C ? to_f(p[c]) : 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float w = g.v[(q * K + a) * K + j];
#pragma unroll
          for (int c = 0; c < kSmallC; ++c) acc[q][c] = fmaf(w, xv[c], acc[q][c]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int oy = UP == 2 ? 2 * uy + q / 2 : uy;
      const int ox = UP == 2 ? 2 * ux + q % 2 : ux;
      if (oy >= OH || ox >= OW) continue;
      T* dst = y + ((n * OH + oy) * OW + ox) * C;
#pragma unroll
      for (int c = 0; c < kSmallC; ++c) {
        if (c >= C) break;
        float u = acc[q][c];
        if (act != GT_ACT_NONE) u = apply_act(u + b[c], act, alpha, gain);
        dst[c] = from_f<T>(u);
      }
    }
  }
}

// UP/DOWN > 0 fix the factors at compile time (the path's 1/1, 2/1 and
// 1/2), so the per-tap "is this a zero-inserted sample" test folds away;
// 0 takes them from the arguments.
template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(256)
    upfirdn_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                   T* __restrict__ y, int N, int H, int W, int C, int OH,
                   int OW, int up_arg, int down_arg, int py0, int px0, int fh,
                   int fw, Filter f, int act, float alpha, float gain) {
  const int up = UP > 0 ? UP : up_arg;
  const int down = DOWN > 0 ? DOWN : down_arg;
  // 32-bit index math: the wrapper rejects tensors of 2^31 elements or more
  const int total = N * OH * OW * C;
  const int HU = H * up, WU = W * up;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int c = idx % C;
    int r = idx / C;
    const int ox = r % OW;
    r /= OW;
    const int oy = r % OH;
    const int n = r / OH;
    const T* xn = x + n * H * W * C + c;
    float acc = 0.f;
    for (int i = 0; i < fh; ++i) {
      // row of the zero-inserted grid that padded row oy*down + i holds
      const int uy = oy * down + i - py0;
      if (uy < 0 || uy >= HU || uy % up) continue;
      const int iy = uy / up;
      for (int j = 0; j < fw; ++j) {
        const int ux = ox * down + j - px0;
        if (ux < 0 || ux >= WU || ux % up) continue;
        const int ix = ux / up;
        // true convolution: the window meets the filter flipped
        acc += f.v[(fh - 1 - i) * fw + (fw - 1 - j)] *
               to_f(xn[(iy * W + ix) * C]);
      }
    }
    if (act != GT_ACT_NONE)
      acc = apply_act(acc + (bias ? bias[c] : 0.f), act, alpha, gain);
    y[idx] = from_f<T>(acc);
  }
}

unsigned grid_blocks(long long units) {
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename T, int UP, int DOWN>
int launch_tile(const void* x, const float* bias, void* y, int N, int H,
                int W, int C, int OH, int OW, int py0, int px0,
                const TilePlan& tp, const Filter& g, int act, float alpha,
                float gain, cudaStream_t s) {
  auto kernel = ufd_tile_kernel<T, UP, DOWN>;
  const int err = set_smem(kernel, tp.smem);
  if (err != 0) return err;
  const int tiles_x = (OW + tp.tw - 1) / tp.tw;
  const int tiles_y = (OH + tp.th - 1) / tp.th;
  const int cblocks = C / (tp.nv * (16 / (int)sizeof(T)));
  if (cblocks > 65535 || N > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(tiles_x * tiles_y, cblocks, N), kThreads, tp.smem, s>>>(
      (const T*)x, bias, (T*)y, H, W, C, OH, OW, py0, px0, tp, tiles_x, g,
      act, alpha, gain);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int path, const void* x, const float* bias, void* y, int N, int H,
           int W, int C, int OH, int OW, int up, int down, int py0, int px0,
           int fh, int fw, const Filter& f, int act, float alpha, float gain,
           int dtype, cudaStream_t s) {
  if (path == kPathTile) {
    const TilePlan tp = tile_plan(dtype, C, up, down);
    if (up == 2)
      return launch_tile<T, 2, 1>(x, bias, y, N, H, W, C, OH, OW, py0, px0,
                                  tp, f, act, alpha, gain, s);
    if (down == 2)
      return launch_tile<T, 1, 2>(x, bias, y, N, H, W, C, OH, OW, py0, px0,
                                  tp, f, act, alpha, gain, s);
    return launch_tile<T, 1, 1>(x, bias, y, N, H, W, C, OH, OW, py0, px0, tp,
                                f, act, alpha, gain, s);
  }
  if (path == kPathSmallC) {
    auto kernel = ufd_smallc_kernel<T, 1, 1>;
    long long units = (long long)N * OH * OW;
    if (up == 2) {
      kernel = ufd_smallc_kernel<T, 2, 1>;
      units = (long long)N * ((OH + 1) / 2) * ((OW + 1) / 2);
    } else if (down == 2) {
      kernel = ufd_smallc_kernel<T, 1, 2>;
    }
    kernel<<<grid_blocks(units), kThreads, 0, s>>>(
        (const T*)x, bias, (T*)y, N, H, W, C, OH, OW, py0, px0, f, act,
        alpha, gain);
    return (int)cudaGetLastError();
  }
  auto kernel = upfirdn_kernel<T, 0, 0>;
  if (up == 1 && down == 1) kernel = upfirdn_kernel<T, 1, 1>;
  else if (up == 2 && down == 1) kernel = upfirdn_kernel<T, 2, 1>;
  else if (up == 1 && down == 2) kernel = upfirdn_kernel<T, 1, 2>;
  kernel<<<grid_blocks((long long)N * OH * OW * C), 256, 0, s>>>(
      (const T*)x, bias, (T*)y, N, H, W, C, OH, OW, up, down, py0, px0, fh,
      fw, f, act, alpha, gain);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of a launch, for the wrapper's check: {path, nv, tr, gx, ry,
// p, th, tw, wh, ww, pitch, smem} (the tile fields 0 off the tile route).
extern "C" void gt_ufd_plan(int dtype, int C, int up, int down, int fh,
                            int fw, int* out) {
  const int path = ufd_path(dtype, C, up, down, fh, fw);
  TilePlan t{};
  if (path == kPathTile) t = tile_plan(dtype, C, up, down);
  const int vals[12] = {path, t.nv, t.tr, t.gx, t.ry, t.p,
                        t.th, t.tw, t.wh, t.ww, t.pitch, t.smem};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
}

// `taps`: the raw fh x fw filter on the general route; on the tile and
// small-channel routes the table the wrapper built from it (ufd_taps:
// the flipped 4x4 filter for UP = 1, the per-phase 2 x 2 x 3 x 3 table
// for UP = 2).  `path` must be the route ufd_path gives.
extern "C" int gt_upfirdn(int path, int dtype, const void* x,
                          const float* bias, void* y, int N, int H, int W,
                          int C, int OH, int OW, int up, int down, int py0,
                          int px0, int fh, int fw, const float* taps,
                          int ntaps, int act, float alpha, float gain,
                          void* stream) {
  if (ntaps > kMaxTaps || path != ufd_path(dtype, C, up, down, fh, fw))
    return (int)cudaErrorInvalidValue;
  Filter f;
  for (int i = 0; i < ntaps; ++i) f.v[i] = taps[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    return launch<float>(path, x, bias, y, N, H, W, C, OH, OW, up, down, py0,
                         px0, fh, fw, f, act, alpha, gain, dtype, s);
  if (dtype == GT_DTYPE_BF16)
    return launch<__nv_bfloat16>(path, x, bias, y, N, H, W, C, OH, OW, up,
                                 down, py0, px0, fh, fw, f, act, alpha, gain,
                                 dtype, s);
  return (int)cudaErrorInvalidValue;
}
