// Backward of the bipartite attention, both directions, over heads folded
// into the batch: (dq, dk, dv) of out = softmax(q k^T * scale) v at the
// cotangent do, with P = exp(s - lse) rebuilt from a fp32 row statistic
// and every product, sum and exp in fp32 whatever the storage type.
//
// grid_to_latent backward (replaces gansformer_tpu/ops/pallas_attention.py
//   _grid_to_latent_bwd -> pl.pallas_call, body _grid_to_latent_bwd_kernel):
//   q/do [B, n, D|Dv] grid rows, k/v [B, L, D|Dv] with L <= 64 latents.
//   Per row: S = q K^T * scale, the row's max and lse = max + log(sum
//   exp(S - max)) from that S, P = exp(S - lse), dP = do V^T, the row
//   delta rowsum(dP * P) inside the kernel (as the TPU body does, not
//   from o), dS = P (dP - delta), dq = dS K * scale written once per row.
//   The TPU body rebuilds P from the forward's lse; the forward kernel
//   (attention.cu) sums S in another order than this kernel, and where
//   the softmax saturates (|logit| >= 1e3 in fp32) one ulp of that
//   disagreement makes sum P != 1 and dS = P (dP - delta) is no longer
//   ~0: dq and dk took 4-6x the plain pair's error against float64 at
//   1e3 and ~770x at 1e4.  A row is L <= 64 values (one warp on the
//   fp32 route, one quad's fragments on the tensor cores), so its lse
//   costs two reductions of the kind delta already takes, and P sums to
//   1 in the kernel's own arithmetic; the forward's lse is not read.
//   dk and dv are sums over all n rows: the TPU carries them in fp32
//   scratch across its sequential grid;
//   Hopper blocks run in no order, so each block writes fp32 partials [B,
//   blocks, L, D|Dv] and g2l_bwd_reduce_kernel sums them in block order
//   (deterministic), one launch for dk and dv.  Rows past n add nothing.
//   Two routes (g2l_bwd_path):
//   * g2l_bwd_mma_kernel<LP> (bf16, L <= 32, D and Dv multiples of 64 up
//     to 512: every preset launch): kernel 9's design with the roles
//     swapped.  K and V resident in shared memory, q and do tiles through
//     a cp.async ring (key_tiling in hopper.cuh), each read from HBM once
//     (the CUDA-core kernel read them twice); S, dP, dq, dK and dV on
//     mma.sync m16n8k16.  dK and dV stay in fp32 registers across a span
//     of tiles, 64 columns of [LP, Dv + D] a chunk and at most two chunks
//     a warp; only a launch that splits n into spans writes partials (at
//     ffhq256's b128 launch 2 MB, where the CUDA-core route wrote 33.5 MB),
//     one span writes dk and dv itself.  P and dS as hi + lo bf16 terms
//     (split_bf16), as kernel 9 (tests/test_torch_g2l_bwd_plan.py holds an
//     emulation of this decomposition to the Pallas kernel within 2e-5 of
//     each output's max).  The tiles hold 16-64 rows (16 at D = Dv =
//     512), so one 16-row group a warp would idle four to seven of the
//     eight warps: S and dP split their depth over the warps of a row
//     group (fp32 parts summed in fixed order), and dq is not kept in the
//     row group's warp but read back from the staged dS in items spread
//     over all warps beside the dK/dV chunks.
//   * g2l_bwd_kernel (fp32, other shapes): one block per 64-row chunk
//     (kRows) on the CUDA cores, one row a warp with warp reductions; past
//     32 latents a thread's column sums run in two 32-latent halves, so
//     no instantiation spills.
//
// latent_to_grid backward (replaces _latent_to_grid_bwd -> pl.pallas_call,
//   body _latent_to_grid_bwd_kernel): q/do [B, L, D|Dv] latents, k/v
//   [B, n, D|Dv] grid keys, softmax over n.  delta = rowsum(do * o) comes
//   from the caller (computed outside, as the JAX package computes it
//   outside its pallas_call).  dk and dv are per key; dq = dS K * scale is
//   a sum over all n keys: each span of keys writes an fp32 partial
//   [B, spans, L, D] and a fixed-order reduce sums them (one span writes
//   dq itself).  Keys past n add nothing (the TPU masks its padded
//   columns).  Two routes (l2g_bwd_path):
//   * l2g_bwd_mma_kernel<LP> (bf16, L <= 32, D and Dv multiples of 64 up
//     to 512: every preset launch): Q and dO resident in shared memory, K
//     and V tiles through a cp.async ring (key_tiling in hopper.cuh: 32
//     keys a tile, 16 at D = Dv = 512), each read from HBM once (the K
//     tile in shared memory also feeds dq, where the CUDA-core kernel
//     read k a second time); the five products on mma.sync m16n8k16.
//     mma.sync and not wgmma: the kernel is bytes-bound (below), and
//     M = 16 latents and 16-key tiles are what mma.sync's tiles fit.  The
//     TPU keeps p and ds in fp32 in its products; the tensor cores round
//     their operands to bf16, so P^T and dS^T enter as hi + lo bf16 terms
//     (split_bf16): one rounding of each would move dq, dk, dv by ~2e-3
//     of their max, hi + lo by fp32's own noise
//     (tests/test_torch_l2g_plan.py holds an emulation of this
//     decomposition to the Pallas kernel within 2e-5 of each output's max).
//   * l2g_bwd_kernel + l2g_bwd_reduce_kernel (fp32, other shapes): one
//     block per 64-key chunk (kRows) on the CUDA cores, each warp walking
//     keys, dq through per-chunk partials.
//
// Bound: bytes.  q, k, v, do (and kernel 9's lse and delta) are read once
// and dq, dk, dv written once; the
// five products of the flash backward are 2 Lq Lk (3 D + 2 Dv) flops, a
// few dozen per byte at L = 16, far under Hopper's ridge (~295): mma.sync
// serves both directions where wgmma would buy nothing.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxL = 64;       // latents on the short side
constexpr int kWarps = 8;       // warps per block
// Grid rows (keys) per block, both CUDA-core kernels: small enough that
// small grids (n = 256, 1024 at batch 8) still launch a few dozen blocks.
constexpr int kRows = 64;
// The backward routes of both directions: the tensor-core kernels
// (g2l_bwd_mma_kernel, l2g_bwd_mma_kernel; bf16 at the shapes of
// key_shape_ok, their rows a tile from key_tiling) and the CUDA-core
// kernels on kRows-row chunks.
enum { kBwdSimt = 0, kBwdMma = 1 };

// dq [B, L, D] of the latent->grid backward: the fixed-order sum over the
// spans' (chunks') fp32 partials [B, spans, M], M = L * D.
template <typename T>
__global__ void __launch_bounds__(256)
    l2g_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int B, int chunks, long long M) {
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

// dk [B, L, D] and dv [B, L, Dv] of the grid->latent backward, each the
// fixed-order sum over the blocks' fp32 partials [B, blocks, L, D|Dv]
// (either route): one launch for both.
template <typename T>
__global__ void __launch_bounds__(256)
    g2l_bwd_reduce_kernel(const float* __restrict__ dk_part,
                          const float* __restrict__ dv_part,
                          T* __restrict__ dk, T* __restrict__ dv, int B,
                          int blocks, int L, int D, int Dv) {
  const int W = D + Dv;
  const long long total = (long long)B * L * W;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long bl = idx / W;                // b * L + l
    const int c = (int)(idx % W);
    const bool is_k = c < D;
    const int width = is_k ? D : Dv, cc = is_k ? c : c - D;
    const long long b = bl / L, l = bl % L;
    const float* p = (is_k ? dk_part : dv_part) +
                     (b * blocks * L + l) * width + cc;
    float acc = 0.f;
    for (int s = 0; s < blocks; ++s) acc += p[(long long)s * L * width];
    (is_k ? dk : dv)[bl * width + cc] = from_f<T>(acc);
  }
}

template <typename T, int LMAX>
__global__ void __launch_bounds__(256)
    g2l_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   T* __restrict__ dq,
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
    // lane l keeps S (then P) and dP of latent l, and of latent l + 32
    float p0 = 0.f, p1 = 0.f, dp0 = 0.f, dp1 = 0.f;
    for (int l = 0; l < L; ++l) {
      float s = 0.f, t = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[d] * Ks[l * D + d];
      for (int d = lane; d < Dv; d += 32) t += dos[d] * Vs[l * Dv + d];
      s = warp_sum(s);
      t = warp_sum(t);
      if (lane == (l & 31)) {
        if (l < 32) {
          p0 = s * scale;
          dp0 = t;
        } else {
          p1 = s * scale;
          dp1 = t;
        }
      }
    }
    // the row's lse from its own S, then P = exp(S - lse)
    const bool in0 = lane < L, in1 = lane + 32 < L;
    const float mx = warp_max(fmaxf(in0 ? p0 : -INFINITY,
                                    in1 ? p1 : -INFINITY));
    const float lr = mx + logf(warp_sum((in0 ? expf(p0 - mx) : 0.f) +
                                        (in1 ? expf(p1 - mx) : 0.f)));
    p0 = in0 ? expf(p0 - lr) : 0.f;
    p1 = in1 ? expf(p1 - lr) : 0.f;
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
  // dk[l, d] = scale * sum_r dS[r, l] q[r, d]; a thread owns one column
  // and sums at most 32 latents at a time (64 sums in registers spilled).
  constexpr int LH = LMAX > 32 ? 32 : LMAX;
  for (int col = threadIdx.x; col < Dv + D; col += blockDim.x) {
    const bool is_v = col < Dv;
    const float* coef = is_v ? Pc : dSc;
    const T* src = is_v ? dout : q;
    const int width = is_v ? Dv : D;
    const int cc = is_v ? col : col - Dv;
    float* part = is_v ? dv_part : dk_part;
    const float mul = is_v ? 1.f : scale;
    for (int l0 = 0; l0 < L; l0 += LH) {
      float acc[LH];
#pragma unroll
      for (int l = 0; l < LH; ++l) acc[l] = 0.f;
      for (int rr = 0; rr < cn; ++rr) {
        const float x = to_f(src[((long long)b * n + r0 + rr) * width + cc]);
#pragma unroll
        for (int l = 0; l < LH; ++l)
          if (l0 + l < L) acc[l] += coef[rr * L + l0 + l] * x;
      }
#pragma unroll
      for (int l = 0; l < LH; ++l)
        if (l0 + l < L)
          part[(((long long)b * nchunks + c) * L + l0 + l) * width + cc] =
              acc[l] * mul;
    }
  }
}

// grid_to_latent backward on the tensor cores (bf16; key_shape_ok).  One
// block of kKeyWarps warps per (span of tiles, batch entry); K [LP, D] and
// V [LP, Dv] resident (swizzled, rows past L zero); each tile's q and do
// rows landed whole in one slot of a `stages`-slot cp.async ring
// (load_key_tile), so q and do are read once.  Per tile, three
// phases between barriers (they set a tile's time, with the issue of the
// next tile's 16-byte cp.async copies sharing their memory pipe, not the
// bytes; PERF.md section 6):
//   1a. S = q K^T and dP = dO V^T on mma.sync m16n8k16 (fp32 out): warp w
//       takes row group w % (kt / 16) and every nsl-th 16-deep step from
//       w / (kt / 16), nsl = the warps a row group gets, and writes its
//       partial sums to shared memory (a 16-row tile at D = Dv = 512
//       would leave one warp walking 64 steps while seven wait);
//   1b. one warp a row group sums the parts in step order, then in
//       registers the row's max and lse of S scale over the quad's lanes,
//       P = exp(S scale - lse) (0 past n and past L), the row's
//       delta = rowsum(P dP) over the quad's lanes and dS = P (dP -
//       delta), P and dS written as hi + lo bf16 (split_bf16) in the
//       [row, latent] layout; meanwhile the other warps issue the loads
//       of the tile stages - 1 ahead into the slot the last tile left;
//   2.  every warp, its items: the dV and dK chunks it owns (64 columns
//       of [LP, Dv + D], chunk c on warp c % kKeyWarps), dV += P^T dO and
//       dK += dS^T q over the tile's rows (P^T and dS^T through
//       ldmatrix.trans as the A operand, dO and q from the slot through
//       ldmatrix.trans), hi and lo one product each, in fp32 registers
//       across the span; then 16-row x 64-column items of dq = scale dS K
//       (dS through ldmatrix, K through ldmatrix.trans) in one round
//       robin after the chunks, each rounded once to bf16, staged in the
//       warp's 2 KB tile and written 16 bytes a thread.
// At the end dK is scaled and dK, dV written in bf16 (one span) or as fp32
// partials [B, spans, L, D|Dv] for g2l_bwd_reduce_kernel.
template <int LP>
__global__ void __launch_bounds__(kKeyWarps * 32, 1)
    g2l_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ dk_part,
                       float* __restrict__ dv_part,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int n, int L, int D,
                       int Dv, float scale, int kt, int stages, int tps) {
  constexpr int MT = LP / 16;
  constexpr int AS = LP + kKeyPad;            // [row, latent] row stride
  // dK/dV chunks a warp: [LP, Dv + D] in 64-column chunks over the warps
  constexpr int CW = 2 * kKeyMaxCols / 64 / kKeyWarps;
  extern __shared__ __align__(128) unsigned char g2l_bwd_smem_raw[];
  const int tile_bytes = kt * (D + Dv) * 2;                // q, do
  unsigned char* ring = g2l_bwd_smem_raw;
  unsigned char* Ks = ring + stages * tile_bytes;            // [LP, D]
  unsigned char* Vs = Ks + LP * D * 2;                       // [LP, Dv]
  // phase 1's fp32 parts [warps][4 MT][32 lanes] float4, and phase 2's
  // dq staging tiles [warps][2 KB] in the same bytes
  unsigned char* stg_all = Vs + LP * Dv * 2;
  float4* part = reinterpret_cast<float4*>(stg_all);
  __nv_bfloat16* Phi =
      reinterpret_cast<__nv_bfloat16*>(stg_all + kKeyWarps * 128 * LP);
  __nv_bfloat16* Plo = Phi + kt * AS;                        // [kt, AS]
  __nv_bfloat16* dShi = Plo + kt * AS;
  __nv_bfloat16* dSlo = dShi + kt * AS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int sp = blockIdx.x, spans = gridDim.x, b = blockIdx.y;
  const int tile0 = sp * tps;
  const int ntiles = min(tps, (n + kt - 1) / kt - tile0);
  unsigned char* stg = stg_all + warp * 2048;                // [16, 64] bf16
  load_latent_rows(Ks, k + (size_t)b * L * D, L, LP, D);
  load_latent_rows(Vs, v + (size_t)b * L * Dv, L, LP, Dv);
  const int rgs = kt / 16, nsl = kKeyWarps / rgs;     // row groups, steps
  // A tile's loads are issued by the warps that phase 1b leaves idle (w
  // >= rgs, at least four): issuing them stalls on the memory system, so
  // they run beside 1b.  A thread's cp.async groups are its own; every
  // thread commits one group a tile.
  const int ltid = tid - rgs * 32, lthreads = (kKeyWarps - rgs) * 32;
  auto prefetch = [&](int j) {
    if (j < ntiles && ltid >= 0) {
      unsigned char* slot = ring + (j % stages) * tile_bytes;
      const int r0 = (tile0 + j) * kt;
      load_key_tile(slot, slot + kt * D * 2, q, dout, b, n, r0, kt, D, Dv,
                    ltid, lthreads);
    }
    cp_async_commit();
  };
  for (int j = 0; j < stages - 1; ++j) prefetch(j);   // K, V ride with tile 0

  const int dvc = Dv / 64, nch = dvc + D / 64;
  const int ndq = rgs * (D / 64);
  // dq items follow the dK/dV chunks in one round robin over the warps
  const int dq_first = ((warp - nch) % kKeyWarps + kKeyWarps) % kKeyWarps;
  float acc[CW][MT][8][4];
#pragma unroll
  for (int cw = 0; cw < CW; ++cw)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cw][mt][t][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_ring(stages);        // tile j has landed ...
    __syncthreads();                   // ... for all, and slot j - 1 is free
    const unsigned char* slot = ring + (j % stages) * tile_bytes;
    const unsigned char* dslot = slot + kt * D * 2;
    const int row0 = (tile0 + j) * kt;

    // 1a. S and dP parts: row group w % rgs, steps w / rgs + i nsl
    {
      const int rg = warp % rgs, sl = warp / rgs;
      float s[2 * MT][4] = {}, dp[2 * MT][4] = {};
      const int br = (lane & 7) + ((lane >> 4) << 3);
      for (int ks = sl; ks < D / 16; ks += nsl) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, smem_u32(slot + swz(rg * 16 + (lane & 15),
                                           ks * 2 + (lane >> 4), D * 2)));
#pragma unroll
        for (int lg = 0; lg < MT; ++lg) {
          ldmatrix_x4(bb, smem_u32(Ks + swz(lg * 16 + br,
                                            ks * 2 + ((lane >> 3) & 1),
                                            D * 2)));
          mma_m16n8k16(s[2 * lg], a, bb[0], bb[1]);
          mma_m16n8k16(s[2 * lg + 1], a, bb[2], bb[3]);
        }
      }
      for (int ks = sl; ks < Dv / 16; ks += nsl) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, smem_u32(dslot + swz(rg * 16 + (lane & 15),
                                            ks * 2 + (lane >> 4), Dv * 2)));
#pragma unroll
        for (int lg = 0; lg < MT; ++lg) {
          ldmatrix_x4(bb, smem_u32(Vs + swz(lg * 16 + br,
                                            ks * 2 + ((lane >> 3) & 1),
                                            Dv * 2)));
          mma_m16n8k16(dp[2 * lg], a, bb[0], bb[1]);
          mma_m16n8k16(dp[2 * lg + 1], a, bb[2], bb[3]);
        }
      }
      float4* mine = part + warp * 4 * MT * 32 + lane;   // 16 bytes a lane
#pragma unroll
      for (int t = 0; t < 2 * MT; ++t) {
        mine[2 * t * 32] = make_float4(s[t][0], s[t][1], s[t][2], s[t][3]);
        mine[(2 * t + 1) * 32] =
            make_float4(dp[t][0], dp[t][1], dp[t][2], dp[t][3]);
      }
    }
    __syncthreads();

    // 1b. warp rg < rgs: its row group's S and dP, then P, delta, dS
    if (warp < rgs) {
      const int rg = warp;
      float s[2 * MT][4] = {}, dp[2 * MT][4] = {};
      for (int sl = 0; sl < nsl; ++sl) {
        const float4* src = part + (sl * rgs + rg) * 4 * MT * 32 + lane;
#pragma unroll
        for (int t = 0; t < 2 * MT; ++t) {
          const float4 x = src[2 * t * 32], y = src[(2 * t + 1) * 32];
          s[t][0] += x.x; s[t][1] += x.y; s[t][2] += x.z; s[t][3] += x.w;
          dp[t][0] += y.x; dp[t][1] += y.y; dp[t][2] += y.z; dp[t][3] += y.w;
        }
      }
      // rows g and g + 8 (h = 0, 1); a row's latents over the quad's lanes
      float mx[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 2 * MT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, lat = t * 8 + 2 * tq + (e & 1);
          s[t][e] *= scale;
          if (row0 + rg * 16 + g + 8 * h < n && lat < L)
            mx[h] = fmaxf(mx[h], s[t][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
#pragma unroll
      for (int t = 0; t < 2 * MT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, lat = t * 8 + 2 * tq + (e & 1);
          if (row0 + rg * 16 + g + 8 * h < n && lat < L)
            den[h] += expf(s[t][e] - mx[h]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
        den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
        mx[h] += logf(den[h]);                   // the row's lse
      }
#pragma unroll
      for (int t = 0; t < 2 * MT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, lat = t * 8 + 2 * tq + (e & 1);
          const bool live = row0 + rg * 16 + g + 8 * h < n && lat < L;
          s[t][e] = live ? expf(s[t][e] - mx[h]) : 0.f;
          delta[h] += s[t][e] * dp[t][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 1);
        delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 2);
      }
#pragma unroll
      for (int t = 0; t < 2 * MT; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat16 ph[2], pl[2], dh[2], dl[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = s[t][2 * h + e];
            split_bf16(p, &ph[e], &pl[e]);
            split_bf16(p * (dp[t][2 * h + e] - delta[h]), &dh[e], &dl[e]);
          }
          const int at = (rg * 16 + g + 8 * h) * AS + t * 8 + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(Phi + at) = __halves2bfloat162(ph[0], ph[1]);
          *reinterpret_cast<__nv_bfloat162*>(Plo + at) = __halves2bfloat162(pl[0], pl[1]);
          *reinterpret_cast<__nv_bfloat162*>(dShi + at) = __halves2bfloat162(dh[0], dh[1]);
          *reinterpret_cast<__nv_bfloat162*>(dSlo + at) = __halves2bfloat162(dl[0], dl[1]);
        }
    }
    prefetch(j + stages - 1);          // beside 1b, into slot j - 1
    __syncthreads();

    // 2. the warp's dV / dK chunks over the tile's rows ...
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      const int c = warp + cw * kKeyWarps;
      if (c >= nch) continue;
      const bool is_v = c < dvc;
      const int cc = is_v ? c : c - dvc, width = is_v ? Dv : D;
      const __nv_bfloat16* Ahi = is_v ? Phi : dShi;
      const __nv_bfloat16* Alo = is_v ? Plo : dSlo;
      const unsigned char* Bs = is_v ? dslot : slot;
      for (int kg = 0; kg < rgs; ++kg) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // P^T / dS^T [latent, row] from [row, latent] (.trans)
          const int off = (kg * 16 + (lane & 7) + ((lane >> 4) << 3)) * AS +
                          mt * 16 + (((lane >> 3) & 1) << 3);
          ldmatrix_x4_trans(ah[mt], smem_u32(Ahi + off));
          ldmatrix_x4_trans(al[mt], smem_u32(Alo + off));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          const int r = kg * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = cc * 8 + np * 2 + (lane >> 4);
          ldmatrix_x4_trans(bb, smem_u32(Bs + swz(r, col, width * 2)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_m16n8k16(acc[cw][mt][2 * np], ah[mt], bb[0], bb[1]);
            mma_m16n8k16(acc[cw][mt][2 * np + 1], ah[mt], bb[2], bb[3]);
            mma_m16n8k16(acc[cw][mt][2 * np], al[mt], bb[0], bb[1]);
            mma_m16n8k16(acc[cw][mt][2 * np + 1], al[mt], bb[2], bb[3]);
          }
        }
      }
    }

    // ... and its dq items: 16 rows x 64 columns = scale (dS_hi K + dS_lo K)
    for (int it = dq_first; it < ndq; it += kKeyWarps) {
      const int rg = it % rgs, c = it / rgs;
      float o[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MT; ++ks) {
        uint32_t ah[4], al[4];
        const int off = (rg * 16 + (lane & 15)) * AS + ks * 16 +
                        (lane >> 4) * 8;
        ldmatrix_x4(ah, smem_u32(dShi + off));
        ldmatrix_x4(al, smem_u32(dSlo + off));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          const int r = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = c * 8 + np * 2 + (lane >> 4);
          ldmatrix_x4_trans(bb, smem_u32(Ks + swz(r, col, D * 2)));
          mma_m16n8k16(o[2 * np], ah, bb[0], bb[1]);
          mma_m16n8k16(o[2 * np + 1], ah, bb[2], bb[3]);
          mma_m16n8k16(o[2 * np], al, bb[0], bb[1]);
          mma_m16n8k16(o[2 * np + 1], al, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        *reinterpret_cast<uint32_t*>(stg + swz(g, t, 128) + tq * 4) =
            pack_bf16(o[t][0] * scale, o[t][1] * scale);
        *reinterpret_cast<uint32_t*>(stg + swz(g + 8, t, 128) + tq * 4) =
            pack_bf16(o[t][2] * scale, o[t][3] * scale);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = i * 32 + lane, rr = idx >> 3, ch = idx & 7;
        const int row = row0 + rg * 16 + rr;
        if (row < n)
          *reinterpret_cast<uint4*>(dq + ((size_t)b * n + row) * D + c * 64 +
                                    ch * 8) =
              *reinterpret_cast<const uint4*>(stg + swz(rr, ch, 128));
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();

  const size_t blk = (size_t)b * spans + sp;
#pragma unroll
  for (int cw = 0; cw < CW; ++cw) {
    const int c = warp + cw * kKeyWarps;
    if (c >= nch) continue;
    const bool is_v = c < dvc;
    const int cc = is_v ? c : c - dvc, width = is_v ? Dv : D;
    const float mul = is_v ? 1.f : scale;
    __nv_bfloat16* out = is_v ? dv : dk;
    float* out_part = is_v ? dv_part : dk_part;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lat = mt * 16 + g + 8 * h;
        if (lat >= L) continue;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int col = cc * 64 + t * 8 + 2 * tq;
          const float x0 = acc[cw][mt][t][2 * h] * mul;
          const float x1 = acc[cw][mt][t][2 * h + 1] * mul;
          if (spans == 1)
            *reinterpret_cast<uint32_t*>(out + ((size_t)b * L + lat) * width +
                                         col) = pack_bf16(x0, x1);
          else
            *reinterpret_cast<float2*>(out_part + (blk * L + lat) * width +
                                       col) = make_float2(x0, x1);
        }
      }
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

// latent_to_grid backward on the tensor cores (bf16; key_shape_ok).  One
// block of kKeyWarps warps per (span of tiles, batch entry); Q [LP, D] and
// dO [LP, Dv] resident (swizzled, rows past L zero), lse and delta in
// shared memory; each tile's K and V rows landed whole in one slot of a
// `stages`-slot cp.async ring, so k is read once for S, dP and dq.  Per
// tile, two phases between barriers:
//   1. one 16-key x 16-latent block a warp: S^T = K Q^T (depth D) and
//      dP^T = V dO^T (depth Dv) on mma.sync m16n8k16 (fp32 out), then in
//      registers P^T = exp(S^T scale - lse) (0 past n and past L) and
//      dS^T = P^T (dP^T - delta); both written as hi + lo bf16
//      (split_bf16) in the [key, latent] layout (the A operand of dV and
//      dK) and dS also as [latent, key] (the A operand of dq);
//   2. the products, every warp: 16-key x 64-column chunks of
//      dV = P^T dO (dO through ldmatrix.trans) and dK = scale dS^T Q (Q
//      through ldmatrix.trans), hi and lo one product each, each chunk
//      rounded once to bf16, staged in the warp's 2 KB tile and written
//      16 bytes a thread; and dq[LP, 64 warp ..] += dS K (K from the
//      tile's slot through ldmatrix.trans) in fp32 registers across the
//      span.
// The span's dq is scaled once at the end and written in bf16 (one span)
// or as an fp32 partial [B, spans, L, D] for l2g_bwd_reduce_kernel's
// fixed-order sum.
template <int LP>
__global__ void __launch_bounds__(kKeyWarps * 32, 1)
    l2g_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ dq_part,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int n, int L, int D,
                       int Dv, float scale, int kt, int stages, int tps) {
  constexpr int MT = LP / 16;
  constexpr int AS = LP + kKeyPad;            // [key, latent] row stride
  extern __shared__ __align__(128) unsigned char l2g_bwd_smem_raw[];
  const int kv_bytes = kt * (D + Dv) * 2;
  const int ds_stride = kt + kKeyPad;         // [latent, key] row stride
  unsigned char* ring = l2g_bwd_smem_raw;
  unsigned char* Qs = ring + stages * kv_bytes;             // [LP, D]
  unsigned char* dOs = Qs + LP * D * 2;                      // [LP, Dv]
  unsigned char* stg_all = dOs + LP * Dv * 2;                // [warps][2 KB]
  __nv_bfloat16* PThi =
      reinterpret_cast<__nv_bfloat16*>(stg_all + kKeyWarps * 2048);
  __nv_bfloat16* PTlo = PThi + kt * AS;                      // [kt, AS]
  __nv_bfloat16* dSThi = PTlo + kt * AS;
  __nv_bfloat16* dSTlo = dSThi + kt * AS;
  __nv_bfloat16* dShi = dSTlo + kt * AS;                     // [LP, kt+pad]
  __nv_bfloat16* dSlo = dShi + LP * ds_stride;
  float* lse_s = reinterpret_cast<float*>(dSlo + LP * ds_stride);
  float* delta_s = lse_s + LP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int sp = blockIdx.x, spans = gridDim.x, b = blockIdx.y;
  const int tile0 = sp * tps;
  const int ntiles = min(tps, (n + kt - 1) / kt - tile0);
  unsigned char* stg = stg_all + warp * 2048;                // [16, 64] bf16
  load_latent_rows(Qs, q + (size_t)b * L * D, L, LP, D);
  load_latent_rows(dOs, dout + (size_t)b * L * Dv, L, LP, Dv);
  if (tid < LP) {
    lse_s[tid] = tid < L ? lse[(size_t)b * L + tid] : 0.f;
    delta_s[tid] = tid < L ? delta[(size_t)b * L + tid] : 0.f;
  }
  auto prefetch = [&](int j) {
    if (j < ntiles) {
      unsigned char* slot = ring + (j % stages) * kv_bytes;
      load_key_tile(slot, slot + kt * D * 2, k, v, b, n, (tile0 + j) * kt,
                    kt, D, Dv);
    }
    cp_async_commit();
  };
  for (int j = 0; j < stages - 1; ++j) prefetch(j);   // Q, dO ride with tile 0

  const int kgs = kt / 16;
  const bool dq_owner = warp * 64 < D;        // owns 64 columns of dq
  float dqa[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqa[mt][t][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_ring(stages);        // tile j has landed ...
    __syncthreads();                   // ... for all, and slot j - 1 is free
    prefetch(j + stages - 1);
    const unsigned char* slot = ring + (j % stages) * kv_bytes;
    const unsigned char* vslot = slot + kt * D * 2;
    const int key0 = (tile0 + j) * kt;

    // 1. S^T, dP^T, P^T and dS^T of 16 keys x 16 latents a warp
    for (int item = warp; item < kgs * MT; item += kKeyWarps) {
      const int kg = item % kgs, lg = item / kgs;
      // even and odd 16-deep steps in separate accumulators: four
      // independent mma chains a warp, summed below
      float s2[2][2][4] = {}, dp2[2][2][4] = {};
      const int br = lg * 16 + (lane & 7) + ((lane >> 4) << 3);
      for (int k2 = 0; k2 < D / 16; k2 += 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = k2 + h;
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, smem_u32(slot + swz(kg * 16 + (lane & 15),
                                           ks * 2 + (lane >> 4), D * 2)));
        ldmatrix_x4(bb, smem_u32(Qs + swz(br, ks * 2 + ((lane >> 3) & 1),
                                          D * 2)));
        mma_m16n8k16(s2[h][0], a, bb[0], bb[1]);
        mma_m16n8k16(s2[h][1], a, bb[2], bb[3]);
      }
      for (int k2 = 0; k2 < Dv / 16; k2 += 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = k2 + h;
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, smem_u32(vslot + swz(kg * 16 + (lane & 15),
                                            ks * 2 + (lane >> 4), Dv * 2)));
        ldmatrix_x4(bb, smem_u32(dOs + swz(br, ks * 2 + ((lane >> 3) & 1),
                                           Dv * 2)));
        mma_m16n8k16(dp2[h][0], a, bb[0], bb[1]);
        mma_m16n8k16(dp2[h][1], a, bb[2], bb[3]);
      }
      float s[2][4], dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = s2[0][t][e] + s2[1][t][e];
          dp[t][e] = dp2[0][t][e] + dp2[1][t][e];
        }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = kg * 16 + g + 8 * h;
          const int lat = lg * 16 + t * 8 + 2 * tq;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = key0 + key < n && lat + e < L;
            p[e] = live ? expf(s[t][2 * h + e] * scale - lse_s[lat + e])
                        : 0.f;
            ds[e] = p[e] * (dp[t][2 * h + e] - delta_s[lat + e]);
          }
          __nv_bfloat16 ph[2], pl[2], dh[2], dl[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            split_bf16(p[e], &ph[e], &pl[e]);
            split_bf16(ds[e], &dh[e], &dl[e]);
            dShi[(lat + e) * ds_stride + key] = dh[e];
            dSlo[(lat + e) * ds_stride + key] = dl[e];
          }
          const int at = key * AS + lat;
          *reinterpret_cast<__nv_bfloat162*>(PThi + at) = __halves2bfloat162(ph[0], ph[1]);
          *reinterpret_cast<__nv_bfloat162*>(PTlo + at) = __halves2bfloat162(pl[0], pl[1]);
          *reinterpret_cast<__nv_bfloat162*>(dSThi + at) = __halves2bfloat162(dh[0], dh[1]);
          *reinterpret_cast<__nv_bfloat162*>(dSTlo + at) = __halves2bfloat162(dl[0], dl[1]);
        }
    }
    __syncthreads();

    // 2a. dV and dK in 16-key x 64-column chunks
    const int vchunks = Dv / 64;
    for (int item = warp; item < kgs * (vchunks + D / 64);
         item += kKeyWarps) {
      const int kg = item % kgs, c = item / kgs;
      const bool is_v = c < vchunks;
      const int cc = is_v ? c : c - vchunks, width = is_v ? Dv : D;
      const __nv_bfloat16* Ahi = is_v ? PThi : dSThi;
      const __nv_bfloat16* Alo = is_v ? PTlo : dSTlo;
      const unsigned char* Bs = is_v ? dOs : Qs;
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MT; ++ks) {
        uint32_t ah[4], al[4];
        const int off = (kg * 16 + (lane & 15)) * AS + ks * 16 +
                        (lane >> 4) * 8;
        ldmatrix_x4(ah, smem_u32(Ahi + off));
        ldmatrix_x4(al, smem_u32(Alo + off));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          const int r = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = cc * 8 + np * 2 + (lane >> 4);
          ldmatrix_x4_trans(bb, smem_u32(Bs + swz(r, col, width * 2)));
          mma_m16n8k16(acc[2 * np], ah, bb[0], bb[1]);
          mma_m16n8k16(acc[2 * np + 1], ah, bb[2], bb[3]);
          mma_m16n8k16(acc[2 * np], al, bb[0], bb[1]);
          mma_m16n8k16(acc[2 * np + 1], al, bb[2], bb[3]);
        }
      }
      const float mul = is_v ? 1.f : scale;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        *reinterpret_cast<uint32_t*>(stg + swz(g, t, 128) + tq * 4) =
            pack_bf16(acc[t][0] * mul, acc[t][1] * mul);
        *reinterpret_cast<uint32_t*>(stg + swz(g + 8, t, 128) + tq * 4) =
            pack_bf16(acc[t][2] * mul, acc[t][3] * mul);
      }
      __syncwarp();
      __nv_bfloat16* out = is_v ? dv : dk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = i * 32 + lane, rr = idx >> 3, ch = idx & 7;
        const int key = key0 + kg * 16 + rr;
        if (key < n)
          *reinterpret_cast<uint4*>(out + ((size_t)b * n + key) * width +
                                    cc * 64 + ch * 8) =
              *reinterpret_cast<const uint4*>(stg + swz(rr, ch, 128));
      }
      __syncwarp();
    }

    // 2b. dq[:, 64 warp ..] += dS_hi K + dS_lo K over the tile's keys
    if (dq_owner) {
      for (int ks = 0; ks < kgs; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int off = (mt * 16 + (lane & 15)) * ds_stride + ks * 16 +
                          (lane >> 4) * 8;
          ldmatrix_x4(ah[mt], smem_u32(dShi + off));
          ldmatrix_x4(al[mt], smem_u32(dSlo + off));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          const int r = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = warp * 8 + np * 2 + (lane >> 4);
          ldmatrix_x4_trans(bb, smem_u32(slot + swz(r, col, D * 2)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_m16n8k16(dqa[mt][2 * np], ah[mt], bb[0], bb[1]);
            mma_m16n8k16(dqa[mt][2 * np + 1], ah[mt], bb[2], bb[3]);
            mma_m16n8k16(dqa[mt][2 * np], al[mt], bb[0], bb[1]);
            mma_m16n8k16(dqa[mt][2 * np + 1], al[mt], bb[2], bb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!dq_owner) return;
  const size_t part = (size_t)b * spans + sp;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= L) continue;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = warp * 64 + t * 8 + 2 * tq;
        const float x0 = dqa[mt][t][2 * h] * scale;
        const float x1 = dqa[mt][t][2 * h + 1] * scale;
        if (spans == 1)
          *reinterpret_cast<uint32_t*>(dq + ((size_t)b * L + r) * D + col) =
              pack_bf16(x0, x1);
        else
          *reinterpret_cast<float2*>(dq_part + (part * L + r) * D + col) =
              make_float2(x0, x1);
      }
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

// Shared memory of l2g_bwd_mma_kernel beside its ring: Q and dO, the
// warps' staging tiles, P^T and dS^T as hi + lo [kt, LP + pad], dS as hi +
// lo [LP, kt + pad], lse and delta.
size_t l2g_bwd_mma_fixed(int lp, int kt, int D, int Dv) {
  return (size_t)lp * (D + Dv) * 2 + (size_t)kKeyWarps * 2048 +
         4 * (size_t)kt * (lp + kKeyPad) * 2 +
         2 * (size_t)lp * (kt + kKeyPad) * 2 + 2 * (size_t)lp * 4;
}

// Shared memory of g2l_bwd_mma_kernel beside its ring: K and V, the
// warps' S and dP parts (128 LP bytes a warp; the 2 KB dq staging tiles
// reuse them), P and dS as hi + lo [kt, LP + pad].
size_t g2l_bwd_mma_fixed(int lp, int kt, int D, int Dv) {
  return (size_t)lp * (D + Dv) * 2 + (size_t)kKeyWarps * 128 * lp +
         4 * (size_t)kt * (lp + kKeyPad) * 2;
}

KeyTiling g2l_bwd_tiling(int B, int n, int L, int D, int Dv) {
  const int lp = key_lp(L);
  return key_tiling(
      [&](int kt) { return g2l_bwd_mma_fixed(lp, kt, D, Dv); },
      (D + Dv) * 2, B, n);
}

int g2l_bwd_path(int dtype, int L, int D, int Dv) {
  if (dtype == GT_DTYPE_BF16 && key_shape_ok(L, D, Dv) &&
      g2l_bwd_tiling(1, 1, L, D, Dv).kt > 0)
    return kBwdMma;
  return kBwdSimt;
}

KeyTiling l2g_bwd_tiling(int B, int n, int L, int D, int Dv) {
  const int lp = key_lp(L);
  return key_tiling(
      [&](int kt) { return l2g_bwd_mma_fixed(lp, kt, D, Dv); },
      (D + Dv) * 2, B, n);
}

int l2g_bwd_path(int dtype, int L, int D, int Dv) {
  if (dtype == GT_DTYPE_BF16 && key_shape_ok(L, D, Dv) &&
      l2g_bwd_tiling(1, 1, L, D, Dv).kt > 0)
    return kBwdMma;
  return kBwdSimt;
}

unsigned reduce_blocks(long long elems) {
  const long long blocks = (elems + 255) / 256;
  return (unsigned)(blocks < 132LL * 32 ? blocks : 132LL * 32);
}

template <typename T>
int launch_l2g_reduce(const float* part, T* out, int B, int chunks,
                      long long M, cudaStream_t st) {
  l2g_bwd_reduce_kernel<T><<<reduce_blocks((long long)B * M), 256, 0, st>>>(
      part, out, B, chunks, M);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g2l_reduce(const float* dk_part, const float* dv_part, void* dk,
                      void* dv, int B, int blocks, int L, int D, int Dv,
                      cudaStream_t st) {
  g2l_bwd_reduce_kernel<T>
      <<<reduce_blocks((long long)B * L * (D + Dv)), 256, 0, st>>>(
          dk_part, dv_part, (T*)dk, (T*)dv, B, blocks, L, D, Dv);
  return (int)cudaGetLastError();
}

template <typename T, int LMAX>
int g2l_bwd_launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* dk_part, float* dv_part, int B, int n, int L, int D,
                   int Dv, float scale, cudaStream_t st) {
  const int nchunks = (n + kRows - 1) / kRows;
  const size_t smem = g2l_bwd_smem(L, D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      g2l_bwd_kernel<T, LMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  g2l_bwd_kernel<T, LMAX><<<dim3(nchunks, B), 32 * kWarps, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq,
      dk_part, dv_part, n, L, D, Dv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_g2l_reduce<T>(dk_part, dv_part, dk, dv, B, nchunks, L, D, Dv,
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
  return launch_l2g_reduce<T>(dq_part, (T*)dq, B, nchunks, (long long)L * D,
                              st);
}

template <typename T>
int g2l_bwd_dispatch(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* dk_part, float* dv_part, int B, int n, int L,
                     int D, int Dv, float scale, cudaStream_t st) {
  if (L <= 16)
    return g2l_bwd_launch<T, 16>(q, k, v, dout, dq, dk, dv, dk_part,
                                 dv_part, B, n, L, D, Dv, scale, st);
  if (L <= 32)
    return g2l_bwd_launch<T, 32>(q, k, v, dout, dq, dk, dv, dk_part,
                                 dv_part, B, n, L, D, Dv, scale, st);
  return g2l_bwd_launch<T, 64>(q, k, v, dout, dq, dk, dv, dk_part, dv_part,
                               B, n, L, D, Dv, scale, st);
}

template <int LP>
int g2l_bwd_mma_launch(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       float* dk_part, float* dv_part, int B, int n, int L,
                       int D, int Dv, float scale, cudaStream_t st) {
  const KeyTiling t = g2l_bwd_tiling(B, n, L, D, Dv);
  if (t.spans > 1 && (dk_part == nullptr || dv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem(g2l_bwd_mma_kernel<LP>, (int)t.smem);
  if (err != 0) return err;
  using bf16 = __nv_bfloat16;
  g2l_bwd_mma_kernel<LP><<<dim3(t.spans, B), kKeyWarps * 32, t.smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (bf16*)dq, dk_part, dv_part, (bf16*)dk, (bf16*)dv, n, L, D, Dv, scale,
      t.kt, t.stages, t.tps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || t.spans == 1) return (int)e;
  return launch_g2l_reduce<bf16>(dk_part, dv_part, dk, dv, B, t.spans, L, D,
                                 Dv, st);
}

template <int LP>
int l2g_bwd_mma_launch(const void* q, const void* k, const void* v,
                       const float* lse, const float* delta, const void* dout,
                       void* dq, void* dk, void* dv, float* dq_part, int B,
                       int n, int L, int D, int Dv, float scale,
                       cudaStream_t st) {
  const KeyTiling t = l2g_bwd_tiling(B, n, L, D, Dv);
  if (t.spans > 1 && dq_part == nullptr) return (int)cudaErrorInvalidValue;
  const int err = set_smem(l2g_bwd_mma_kernel<LP>, (int)t.smem);
  if (err != 0) return err;
  using bf16 = __nv_bfloat16;
  l2g_bwd_mma_kernel<LP><<<dim3(t.spans, B), kKeyWarps * 32, t.smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, lse, delta,
      (const bf16*)dout, (bf16*)dq, dq_part, (bf16*)dk, (bf16*)dv, n, L, D,
      Dv, scale, t.kt, t.stages, t.tps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || t.spans == 1) return (int)e;
  return launch_l2g_reduce<bf16>(dq_part, (bf16*)dq, B, t.spans,
                                 (long long)L * D, st);
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

// The plan of a backward launch, for the wrapper's check: {path, LP, rows
// (keys) a tile, tiles a span, spans, ring stages, dynamic shared memory};
// the CUDA-core route reports its kRows chunk as the tile, one tile a
// span, LP and stages 0.
template <typename Tiling>
void bwd_plan(int path, Tiling tiling, int L, int n, size_t simt_smem,
              int* out) {
  if (path == kBwdMma) {
    const KeyTiling t = tiling();
    const int plan[7] = {path, key_lp(L), t.kt, t.tps, t.spans, t.stages,
                         (int)t.smem};
    for (int i = 0; i < 7; ++i) out[i] = plan[i];
    return;
  }
  const int plan[7] = {path, 0, kRows, 1, (n + kRows - 1) / kRows, 0,
                       (int)simt_smem};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
}

}  // namespace

extern "C" int gt_attn_bwd_rows() { return kRows; }

// grid_to_latent backward: n grid rows are the tiled side.
extern "C" void gt_g2l_bwd_plan(int dtype, int B, int n, int L, int D,
                                int Dv, int* out) {
  bwd_plan(g2l_bwd_path(dtype, L, D, Dv),
           [&] { return g2l_bwd_tiling(B, n, L, D, Dv); }, L, n,
           g2l_bwd_smem(L, D, Dv), out);
}

// latent_to_grid backward: n grid keys are the tiled side.
extern "C" void gt_l2g_bwd_plan(int dtype, int B, int n, int L, int D,
                                int Dv, int* out) {
  bwd_plan(l2g_bwd_path(dtype, L, D, Dv),
           [&] { return l2g_bwd_tiling(B, n, L, D, Dv); }, L, n,
           l2g_bwd_smem(L, D, Dv), out);
}

// `path` must be the route g2l_bwd_path gives (the wrapper's plan);
// dk_part and dv_part hold the plan's spans (chunks on the CUDA-core
// route), null where the tensor-core plan has one span.
extern "C" int gt_grid_to_latent_bwd(int path, int dtype, const void* q,
                                     const void* k, const void* v,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, float* dk_part,
                                     float* dv_part, int B, int n, int L,
                                     int D, int Dv, float scale,
                                     void* stream) {
  if (L < 1 || L > kMaxL || n < 1 || path != g2l_bwd_path(dtype, L, D, Dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == kBwdMma) {
    if (L <= 16)
      return g2l_bwd_mma_launch<16>(q, k, v, dout, dq, dk, dv, dk_part,
                                    dv_part, B, n, L, D, Dv, scale, st);
    return g2l_bwd_mma_launch<32>(q, k, v, dout, dq, dk, dv, dk_part,
                                  dv_part, B, n, L, D, Dv, scale, st);
  }
  if (dtype == GT_DTYPE_F32)
    return g2l_bwd_dispatch<float>(q, k, v, dout, dq, dk, dv, dk_part,
                                   dv_part, B, n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return g2l_bwd_dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv,
                                           dk_part, dv_part, B, n, L, D, Dv,
                                           scale, st);
  return (int)cudaErrorInvalidValue;
}

// `path` must be the route l2g_bwd_path gives (the wrapper's plan);
// dq_part holds the plan's spans (chunks on the CUDA-core route), null
// where the tensor-core plan has one span.
extern "C" int gt_latent_to_grid_bwd(int path, int dtype, const void* q,
                                     const void* k, const void* v,
                                     const float* lse, const float* delta,
                                     const void* dout, void* dq, void* dk,
                                     void* dv, float* dq_part, int B, int n,
                                     int L, int D, int Dv, float scale,
                                     void* stream) {
  if (L < 1 || L > kMaxL || n < 1 || path != l2g_bwd_path(dtype, L, D, Dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == kBwdMma) {
    if (L <= 16)
      return l2g_bwd_mma_launch<16>(q, k, v, lse, delta, dout, dq, dk, dv,
                                    dq_part, B, n, L, D, Dv, scale, st);
    return l2g_bwd_mma_launch<32>(q, k, v, lse, delta, dout, dq, dk, dv,
                                  dq_part, B, n, L, D, Dv, scale, st);
  }
  if (dtype == GT_DTYPE_F32)
    return l2g_bwd_dispatch<float>(q, k, v, lse, delta, dout, dq, dk, dv,
                                   dq_part, B, n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return l2g_bwd_dispatch<__nv_bfloat16>(q, k, v, lse, delta, dout, dq, dk,
                                           dv, dq_part, B, n, L, D, Dv, scale,
                                           st);
  return (int)cudaErrorInvalidValue;
}
