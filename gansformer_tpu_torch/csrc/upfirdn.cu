// upfirdn2d on NHWC: zero-insert upsample -> pad/crop -> true-convolution FIR
// -> decimate, with an optional act(y + bias) * gain epilogue.
//
// Replaces the Pallas kernel gansformer_tpu/ops/pallas_upfirdn.py
// (_upfirdn_body, launched by _ufd_call).  The TPU version pads the whole
// block in VMEM and walks the taps as strided slices; here one thread owns
// one output element (channel fastest, so a warp reads and writes
// neighbouring addresses) and computes for each tap which input sample it
// reads, so neither the zero-inserted nor the padded grid ever exists.
// Bound: bytes (a 4x4 FIR does 16 MACs per output element); the neighbour
// reads of adjacent outputs hit L1/L2, so device memory sees each input
// byte about once.
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 64;  // fh * fw

struct Filter {
  float v[kMaxTaps];
};

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

template <typename T>
void launch(const void* x, const float* bias, void* y, int N, int H, int W,
            int C, int OH, int OW, int up, int down, int py0, int px0, int fh,
            int fw, const Filter& f, int act, float alpha, float gain,
            cudaStream_t stream) {
  const long long total = (long long)N * OH * OW * C;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  if (blocks < 1) blocks = 1;
  auto kernel = upfirdn_kernel<T, 0, 0>;
  if (up == 1 && down == 1) kernel = upfirdn_kernel<T, 1, 1>;
  else if (up == 2 && down == 1) kernel = upfirdn_kernel<T, 2, 1>;
  else if (up == 1 && down == 2) kernel = upfirdn_kernel<T, 1, 2>;
  kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      (const T*)x, bias, (T*)y, N, H, W, C, OH, OW, up, down, py0, px0, fh,
      fw, f, act, alpha, gain);
}

}  // namespace

extern "C" int gt_upfirdn(int dtype, const void* x, const float* bias,
                          void* y, int N, int H, int W, int C, int OH, int OW,
                          int up, int down, int py0, int px0, int fh, int fw,
                          const float* taps, int act, float alpha, float gain,
                          void* stream) {
  if (fh * fw > kMaxTaps) return (int)cudaErrorInvalidValue;
  Filter f;
  for (int i = 0; i < fh * fw; ++i) f.v[i] = taps[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == GT_DTYPE_F32)
    launch<float>(x, bias, y, N, H, W, C, OH, OW, up, down, py0, px0, fh, fw,
                  f, act, alpha, gain, s);
  else if (dtype == GT_DTYPE_BF16)
    launch<__nv_bfloat16>(x, bias, y, N, H, W, C, OH, OW, up, down, py0, px0,
                          fh, fw, f, act, alpha, gain, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
