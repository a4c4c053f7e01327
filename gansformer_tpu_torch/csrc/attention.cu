// Bipartite attention, both directions, over heads folded into the batch:
// out = softmax(q k^T / sqrt(D)) v with fp32 logits, max, exp and sums.
//
// grid_to_latent  (replaces gansformer_tpu/ops/pallas_attention.py
//   _grid_to_latent_kernel via _grid_to_latent_fwd): q [B, n, D] grid rows,
//   k/v [B, L, D|Dv] with L <= 64 latents.  The softmax axis is the tiny L,
//   so every grid row is independent.  Bound on this card: bytes (q read
//   once, out written once; 2 L (D + Dv) operations a row, 16-64 per byte
//   against Hopper's ~295).  Two routes (g2l_path):
//   * g2l_mma_kernel<LP> (bf16, D and Dv multiples of 64): tensor-core
//     rows.  A block of 4 warps keeps K [L, D] and V [L, Dv] of its batch
//     entry in shared memory as bf16 (16-byte cp.async, the 16-byte
//     chunks of a row XOR-swizzled by the row so ldmatrix reads no bank
//     twice; rows L..LP-1 zero).  Each warp owns 16 query rows at a time
//     and streams them in 64-column chunks through its own 3-slot cp.async
//     ring (swizzled the same way), so the next rows' q is in flight while
//     the current ones multiply.  S = q K^T is mma.sync m16n8k16 (bf16 in,
//     fp32 out) with the 16 x LP logits in registers; the softmax is fp32
//     in registers (row max and sum by quad shuffles; padded keys -inf);
//     P = e / den rounded to bf16 is exactly the reference's (e /
//     den).astype(v.dtype) (_grid_to_latent_kernel) and, being the m16n8
//     accumulator layout, already the A fragment of O = P V, so it never
//     touches shared memory; V is the B operand through ldmatrix.trans.
//     Each 64-column chunk of O is rounded once, staged in shared memory
//     and written 16 bytes a thread.  LP, L padded to 16, 32 or 64, is a
//     compile-time bucket.
//   * g2l_kernel<T> (fp32, other shapes): K and V staged in shared memory
//     as fp32, each warp walks query rows, keeping its logits in registers
//     (one per lane) and its probabilities in a per-warp smem row,
//     rounded to the value dtype before the mix.
//
// latent_to_grid  (replaces gansformer_tpu/ops/pallas_attention.py
//   _latent_to_grid_kernel via _latent_to_grid_fwd -> pl.pallas_call):
//   q [B, L, D] latents, k/v [B, n, D|Dv], softmax over the long n axis.
//   Bound on this card: bytes.  k and v are read once, 2 (D + Dv) bytes a
//   key, against 2 L (D + Dv) operations a key: 16 a byte at L = 16,
//   against Hopper's ~295, so the least time is the bytes over 3.35 TB/s
//   (0.05 ms for the 168 MB of ffhq256's b128 launch at batch 8).  The
//   TPU carries the online-softmax state (m, s, acc) across a sequential
//   grid; Hopper blocks run in no order, so n is split into spans, each
//   block carrying (m, s, acc) over its span's tiles and writing them in
//   fp32 for a combine kernel's fixed-order sum (deterministic), or, with
//   one span (the small grids), o and lse itself.  Two routes (l2g_path):
//   * l2g_mma_kernel<LP> (bf16, L <= 32, D and Dv multiples of 64 up to
//     512: every preset launch): K and V tiles stream through a cp.async
//     ring (key_tiling in hopper.cuh picks the keys a tile by D + Dv: 32,
//     or 16 at L = 32 with D = 512); logits and the mix on mma.sync
//     m16n8k16.  mma.sync and not wgmma: at 16 operations a byte the
//     tensor cores are not the limit (mma.sync runs an order of magnitude
//     above what the bytes allow), and a 16-latent M dimension is what
//     mma.sync's 16-row tiles fit.  The TPU keeps p in fp32 in p @ v; the
//     tensor cores round their operands to bf16, so P enters as hi + lo
//     bf16 terms (split_bf16): two products, P carried to ~2^-17, where
//     one rounding would move o by ~1e-4 of its max, a rounding point the
//     TPU kernel lacks (tests/test_torch_l2g_plan.py holds an emulation of
//     this decomposition to the Pallas kernel within 1e-5 of max |o|, and
//     shows the one-rounding variant outside that).
//   * l2g_partial_kernel + l2g_combine_kernel (fp32, other shapes): each
//     256-key chunk writes (m, s, acc[L, Dv]) in fp32 on the CUDA cores,
//     the combine sums the chunks.
//
// Both forwards take an optional fp32 ``lse`` [B, Lq] output, the row
// statistic max + log(denominator), in natural-log units, that the
// backward kernels (attention_bwd.cu) rebuild P from.  With a null pointer
// nothing is written: the serving path passes null, as the TPU's no-grad
// path declares no lse output.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxL = 64;       // latents a grid row attends to
constexpr int kWarps = 8;       // warps per block
constexpr int kG2LRows = 128;   // grid rows per grid_to_latent block
constexpr int kChunk = 256;     // key rows per latent_to_grid block

// grid_to_latent routes, and the tensor-core route's shape: 4 warps of 16
// query rows, each streaming q in 64-column chunks through 3 ring slots of
// 16 x 64 bf16 (2 KB) plus one 2 KB slot to stage its output.
enum { kG2LSimt = 0, kG2LMma = 1 };
constexpr int kMmaWarps = 4;
constexpr int kQStages = 3;
constexpr int kQChunk = 64;
constexpr int kSlot = 16 * kQChunk * 2;
constexpr int kSms = 132;

// latent_to_grid routes: the tensor-core kernel (l2g_mma_kernel, bf16 at
// the shapes of key_shape_ok) and the CUDA-core kernels.
enum { kL2GSimt = 0, kL2GMma = 1 };

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

template <int LP>
__global__ void __launch_bounds__(kMmaWarps * 32)
    g2l_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int n, int L, int D, int Dv, float scale, int tpw) {
  constexpr int NT = LP / 8;          // n-tiles of the logits
  extern __shared__ __align__(128) unsigned char g2l_smem_raw[];
  unsigned char* Ks = g2l_smem_raw;                 // [LP, D] swizzled
  unsigned char* Vs = Ks + LP * D * 2;              // [LP, Dv] swizzled
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = Vs + LP * Dv * 2 + warp * (kQStages + 1) * kSlot;
  unsigned char* stage = ring + kQStages * kSlot;   // [16, 64] swizzled
  const int b = blockIdx.y;

  {
    const int kc = D / 8, vc = Dv / 8;
    const __nv_bfloat16* kb = k + (size_t)b * L * D;
    const __nv_bfloat16* vb = v + (size_t)b * L * Dv;
    for (int i = threadIdx.x; i < L * kc; i += blockDim.x)
      cp_async16(Ks + swz(i / kc, i % kc, D * 2), kb + (size_t)i * 8, 16);
    for (int i = threadIdx.x; i < L * vc; i += blockDim.x)
      cp_async16(Vs + swz(i / vc, i % vc, Dv * 2), vb + (size_t)i * 8, 16);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < (LP - L) * kc; i += blockDim.x)
      reinterpret_cast<uint4*>(Ks + L * D * 2)[i] = zero;
    for (int i = threadIdx.x; i < (LP - L) * vc; i += blockDim.x)
      reinterpret_cast<uint4*>(Vs + L * Dv * 2)[i] = zero;
  }
  cp_async_commit();

  // this warp's 16-row tiles: t = 0 .. tpw - 1 at rows r_blk + (t * 4 +
  // warp) * 16; those inside n are a prefix.  Stage j of the ring is
  // chunk j % nch of tile j / nch.
  const int nch = D / kQChunk;
  const int r_blk = blockIdx.x * 16 * kMmaWarps * tpw;
  int ntiles = 0;
  while (ntiles < tpw && r_blk + (ntiles * kMmaWarps + warp) * 16 < n)
    ++ntiles;
  const int J = ntiles * nch;
  auto tile_row = [&](int t) { return r_blk + (t * kMmaWarps + warp) * 16; };
  auto prefetch = [&](int j) {
    if (j < J) {
      const int rbase = tile_row(j / nch), c = j % nch;
      unsigned char* slot = ring + (j % kQStages) * kSlot;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = i * 32 + lane, rr = idx >> 3, ch = idx & 7;
        const bool in = rbase + rr < n;
        const __nv_bfloat16* src =
            q + ((size_t)b * n + (in ? rbase + rr : rbase)) * D +
            c * kQChunk + ch * 8;
        cp_async16(slot + swz(rr, ch, kQChunk * 2), src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kQStages - 1; ++j) prefetch(j);
  cp_async_wait<kQStages - 1>();       // K and V have landed
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;
  float s[NT][4];
  for (int j = 0; j < J; ++j) {
    prefetch(j + kQStages - 1);
    cp_async_wait<kQStages - 1>();     // stage j has landed
    __syncwarp();
    const int c = j % nch;
    if (c == 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    }
    const unsigned char* slot = ring + (j % kQStages) * kSlot;
#pragma unroll
    for (int ks = 0; ks < kQChunk / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(slot + swz(lane & 15, ks * 2 + (lane >> 4),
                                         kQChunk * 2)));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int kc = c * 8 + ks * 2 + ((lane >> 3) & 1);
        ldmatrix_x4(bk, smem_u32(Ks + swz(kr, kc, D * 2)));
        mma_m16n8k16(s[2 * np], a, bk[0], bk[1]);
        mma_m16n8k16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncwarp();                      // the slot may be refilled
    if (c != nch - 1) continue;

    // softmax of rows g and g + 8 over the logits this quad holds
    const int rbase = tile_row(j / nch);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool key = t * 8 + tq * 2 + e < L;
        s[t][e] = key ? s[t][e] * scale : -INFINITY;
        s[t][2 + e] = key ? s[t][2 + e] * scale : -INFINITY;
        m0 = fmaxf(m0, s[t][e]);
        m1 = fmaxf(m1, s[t][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[t][e] = expf(s[t][e] - m0);
        s[t][2 + e] = expf(s[t][2 + e] - m1);
        d0 += s[t][e];
        d1 += s[t][2 + e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    if (lse != nullptr && tq == 0) {
      if (rbase + g < n) lse[(size_t)b * n + rbase + g] = m0 + logf(d0);
      if (rbase + g + 8 < n)
        lse[(size_t)b * n + rbase + g + 8] = m1 + logf(d1);
    }
    const float i0 = 1.f / d0, i1 = 1.f / d1;
    // P in bf16: the A fragments of O = P V, 16 keys each
    uint32_t pa[LP / 16][4];
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0);
      pa[kk][1] = pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1);
    }
    for (int dc = 0; dc < Dv / kQChunk; ++dc) {
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < LP / 16; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bv[4];
          const int vr = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int vc = dc * 8 + np * 2 + (lane >> 4);
          ldmatrix_x4_trans(bv, smem_u32(Vs + swz(vr, vc, Dv * 2)));
          mma_m16n8k16(acc[2 * np], pa[kk], bv[0], bv[1]);
          mma_m16n8k16(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
        }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        *reinterpret_cast<uint32_t*>(stage + swz(g, t, 128) + tq * 4) =
            pack_bf16(acc[t][0], acc[t][1]);
        *reinterpret_cast<uint32_t*>(stage + swz(g + 8, t, 128) + tq * 4) =
            pack_bf16(acc[t][2], acc[t][3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = i * 32 + lane, rr = idx >> 3, ch = idx & 7;
        if (rbase + rr < n)
          *reinterpret_cast<uint4*>(o + ((size_t)b * n + rbase + rr) * Dv +
                                    dc * kQChunk + ch * 8) =
              *reinterpret_cast<const uint4*>(stage + swz(rr, ch, 128));
      }
      __syncwarp();
    }
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

// latent_to_grid on the tensor cores (bf16; key_shape_ok).  One block of
// kKeyWarps warps per (span of tiles, batch entry); Q [LP, D] resident
// (swizzled, rows past L zero), each tile's K [kt, D] and V [kt, Dv] rows
// landed whole in one slot of a `stages`-slot cp.async ring (16-byte
// copies, zero-filled past n, swizzled).  Per tile, three phases between
// barriers:
//   1. logits: S^T[keys, latents] = K Q^T on mma.sync m16n8k16 (K the A
//      operand, Q the B operand; bf16 in, fp32 out), one 16-key x
//      16-latent block a warp, scaled and written to Ss [LP, kt] (keys
//      past n at -inf);
//   2. the online softmax of each latent over the tile, kept per block in
//      fp32: 256 / LP threads a latent row, tile max and sum by shuffles,
//      m and s in registers, corr = exp(m_prev - m_new); P = exp(s - m_new)
//      written as hi + lo bf16 [LP, kt + pad] (split_bf16), so P V in the
//      tensor cores carries P to fp32's precision as the TPU's fp32 p @ v
//      does (one bf16 rounding of P would be a rounding point the TPU
//      kernel lacks);
//   3. the mix: warp w owns Dv columns [64 w, 64 w + 64): acc[LP, 64] fp32
//      in registers, rescaled by corr, += P_hi V + P_lo V (P through
//      ldmatrix, V through ldmatrix.trans).
// With one span the block writes o = acc / s (bf16, 16 bytes a thread
// through a staging tile) and lse = m + log(s); else (m, s, acc) of its
// span in fp32 for l2g_combine_kernel's fixed-order sum over spans.
template <int LP>
__global__ void __launch_bounds__(kKeyWarps * 32, 1)
    l2g_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   float* __restrict__ m_part, float* __restrict__ s_part,
                   float* __restrict__ acc_part, int n, int L, int D,
                   int Dv, float scale, int kt, int stages, int tps) {
  constexpr int MT = LP / 16;                 // 16-latent row tiles
  constexpr int TPR = kKeyWarps * 32 / LP;    // softmax threads a latent
  extern __shared__ __align__(128) unsigned char l2g_smem_raw[];
  const int kv_bytes = kt * (D + Dv) * 2;
  const int pstride = kt + kKeyPad;
  unsigned char* ring = l2g_smem_raw;
  unsigned char* Qs = ring + stages * kv_bytes;            // [LP, D]
  float* Ss = reinterpret_cast<float*>(Qs + LP * D * 2);   // [LP, kt]
  __nv_bfloat16* Phi = reinterpret_cast<__nv_bfloat16*>(Ss + LP * kt);
  __nv_bfloat16* Plo = Phi + LP * pstride;                  // [LP, pstride]
  float* corr_s = reinterpret_cast<float*>(Plo + LP * pstride);
  float* fin_m = corr_s + LP;
  float* fin_s = fin_m + LP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int sp = blockIdx.x, spans = gridDim.x, b = blockIdx.y;
  const int tile0 = sp * tps;
  const int ntiles = min(tps, (n + kt - 1) / kt - tile0);
  load_latent_rows(Qs, q + (size_t)b * L * D, L, LP, D);
  auto prefetch = [&](int j) {
    if (j < ntiles) {
      unsigned char* slot = ring + (j % stages) * kv_bytes;
      load_key_tile(slot, slot + kt * D * 2, k, v, b, n, (tile0 + j) * kt,
                    kt, D, Dv);
    }
    cp_async_commit();
  };
  for (int j = 0; j < stages - 1; ++j) prefetch(j);   // Q rides with tile 0

  const int row = tid / TPR, sub = tid % TPR;   // this thread's softmax row
  const bool mixer = warp * 64 < Dv;            // owns 64 columns of O
  const int kgs = kt / 16;
  float m_run = -INFINITY, s_run = 0.f;
  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_ring(stages);        // tile j has landed ...
    __syncthreads();                   // ... for all, and slot j - 1 is free
    prefetch(j + stages - 1);
    const unsigned char* slot = ring + (j % stages) * kv_bytes;
    const unsigned char* vslot = slot + kt * D * 2;
    const int key0 = (tile0 + j) * kt;

    // 1. logits of 16 keys x 16 latents a warp
    for (int item = warp; item < kgs * MT; item += kKeyWarps) {
      const int kg = item % kgs, lg = item / kgs;
      // even and odd 16-deep steps in separate accumulators: four
      // independent mma chains a warp
      float s[2][2][4] = {};
      for (int k2 = 0; k2 < D / 16; k2 += 2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = k2 + h;
        uint32_t a[4], bq[4];
        ldmatrix_x4(a, smem_u32(slot + swz(kg * 16 + (lane & 15),
                                           ks * 2 + (lane >> 4), D * 2)));
        ldmatrix_x4(bq, smem_u32(Qs + swz(lg * 16 + (lane & 7) +
                                              ((lane >> 4) << 3),
                                          ks * 2 + ((lane >> 3) & 1),
                                          D * 2)));
        mma_m16n8k16(s[h][0], a, bq[0], bq[1]);
        mma_m16n8k16(s[h][1], a, bq[2], bq[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kg * 16 + g + ((e >> 1) << 3);
          const int lat = lg * 16 + t * 8 + 2 * tq + (e & 1);
          Ss[lat * kt + key] = key0 + key < n
                                   ? (s[0][t][e] + s[1][t][e]) * scale
                                   : -INFINITY;
        }
    }
    __syncthreads();

    // 2. the online softmax over this tile, latent row `row`
    {
      const float* sr = Ss + row * kt;
      float tmax = -INFINITY;
      for (int i = sub; i < kt; i += TPR) tmax = fmaxf(tmax, sr[i]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run, tmax);
      const float corr = expf(m_run - m_new);
      float tsum = 0.f;
      for (int i = sub; i < kt; i += TPR) {
        const float p = expf(sr[i] - m_new);
        tsum += p;
        split_bf16(p, Phi + row * pstride + i, Plo + row * pstride + i);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      s_run = s_run * corr + tsum;
      m_run = m_new;
      if (sub == 0) corr_s[row] = corr;
    }
    __syncthreads();

    // 3. O[:, 64 warp ..] = O * corr + P_hi V + P_lo V
    if (mixer) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float c0 = corr_s[mt * 16 + g], c1 = corr_s[mt * 16 + g + 8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          acc[mt][t][0] *= c0;
          acc[mt][t][1] *= c0;
          acc[mt][t][2] *= c1;
          acc[mt][t][3] *= c1;
        }
      }
      for (int ks = 0; ks < kgs; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int off = (mt * 16 + (lane & 15)) * pstride + ks * 16 +
                          (lane >> 4) * 8;
          ldmatrix_x4(ah[mt], smem_u32(Phi + off));
          ldmatrix_x4(al[mt], smem_u32(Plo + off));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bv[4];
          const int vr = ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int vcol = warp * 8 + np * 2 + (lane >> 4);
          ldmatrix_x4_trans(bv, smem_u32(vslot + swz(vr, vcol, Dv * 2)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_m16n8k16(acc[mt][2 * np], ah[mt], bv[0], bv[1]);
            mma_m16n8k16(acc[mt][2 * np + 1], ah[mt], bv[2], bv[3]);
            mma_m16n8k16(acc[mt][2 * np], al[mt], bv[0], bv[1]);
            mma_m16n8k16(acc[mt][2 * np + 1], al[mt], bv[2], bv[3]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  if (sub == 0) {
    fin_m[row] = m_run;
    fin_s[row] = s_run;
  }
  __syncthreads();                     // the ring is free for staging
  if (spans == 1) {
    if (mixer) {
      unsigned char* stage = ring + warp * LP * 128;      // [LP, 64] bf16
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = mt * 16 + g;
        const float s0 = fin_s[r0], s1 = fin_s[r0 + 8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          *reinterpret_cast<uint32_t*>(stage + swz(r0, t, 128) + tq * 4) =
              pack_bf16(acc[mt][t][0] / s0, acc[mt][t][1] / s0);
          *reinterpret_cast<uint32_t*>(stage + swz(r0 + 8, t, 128) +
                                       tq * 4) =
              pack_bf16(acc[mt][t][2] / s1, acc[mt][t][3] / s1);
        }
      }
      __syncwarp();
      for (int i = lane; i < LP * 8; i += 32) {
        const int rr = i >> 3, ch = i & 7;
        if (rr < L)
          *reinterpret_cast<uint4*>(o + ((size_t)b * L + rr) * Dv +
                                    warp * 64 + ch * 8) =
              *reinterpret_cast<const uint4*>(stage + swz(rr, ch, 128));
      }
    }
    if (lse != nullptr && tid < L)
      lse[(size_t)b * L + tid] = fin_m[tid] + logf(fin_s[tid]);
    return;
  }
  const size_t part = (size_t)b * spans + sp;
  if (mixer) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= L) continue;
        float* dst = acc_part + (part * L + r) * Dv + warp * 64 + 2 * tq;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          *reinterpret_cast<float2*>(dst + t * 8) =
              make_float2(acc[mt][t][2 * h], acc[mt][t][2 * h + 1]);
      }
  }
  if (tid < L) {
    m_part[part * L + tid] = fin_m[tid];
    s_part[part * L + tid] = fin_s[tid];
  }
}

size_t g2l_simt_smem(int L, int D, int Dv) {
  return sizeof(float) *
         ((size_t)L * D + (size_t)L * Dv + kWarps * D + kWarps * kMaxL);
}

int g2l_lp(int L) { return L <= 16 ? 16 : (L <= 32 ? 32 : 64); }

size_t g2l_mma_smem(int L, int D, int Dv) {
  return (size_t)g2l_lp(L) * (D + Dv) * 2 +
         (size_t)kMmaWarps * (kQStages + 1) * kSlot;
}

int g2l_path(int dtype, int L, int D, int Dv) {
  if (dtype == GT_DTYPE_BF16 && L >= 1 && L <= kMaxL && D > 0 && Dv > 0 &&
      D % kQChunk == 0 && Dv % kQChunk == 0 &&
      g2l_mma_smem(L, D, Dv) <= (size_t)kMaxSmem)
    return kG2LMma;
  return kG2LSimt;
}

size_t g2l_smem(int path, int L, int D, int Dv) {
  return path == kG2LMma ? g2l_mma_smem(L, D, Dv) : g2l_simt_smem(L, D, Dv);
}

// 16-row tiles a warp takes in turn: 1 while one tile a warp gives fewer
// than two blocks an SM, up to 4 on the large grids, so K and V are staged
// once for up to 256 rows.
int g2l_tiles_per_warp(int B, int n) {
  const long long blocks = (long long)B * ((n + 16 * kMmaWarps - 1) /
                                           (16 * kMmaWarps));
  const long long t = blocks / (2 * kSms);
  return t < 1 ? 1 : (t > 4 ? 4 : (int)t);
}

int g2l_rows_per_block(int path, int B, int n) {
  return path == kG2LMma ? 16 * kMmaWarps * g2l_tiles_per_warp(B, n)
                         : kG2LRows;
}

size_t l2g_smem(int L, int D) {
  return sizeof(float) * ((size_t)L * D + (size_t)L * kChunk + kWarps * D);
}

// Shared memory of l2g_mma_kernel beside its ring: Q, the logits, P as
// hi + lo, and three per-latent rows (corr, final m and s).
size_t l2g_mma_fixed(int lp, int kt, int D) {
  return (size_t)lp * D * 2 + (size_t)lp * kt * 4 +
         2 * (size_t)lp * (kt + kKeyPad) * 2 + 3 * (size_t)lp * 4;
}

KeyTiling l2g_tiling(int B, int n, int L, int D, int Dv) {
  const int lp = key_lp(L);
  return key_tiling([&](int kt) { return l2g_mma_fixed(lp, kt, D); },
                    (D + Dv) * 2, B, n);
}

// latent_to_grid's route: the tensor cores for bf16 at the shapes they
// take (their ring fits), else the CUDA-core kernels.
int l2g_path(int dtype, int L, int D, int Dv) {
  if (dtype == GT_DTYPE_BF16 && key_shape_ok(L, D, Dv) &&
      l2g_tiling(1, 1, L, D, Dv).kt > 0)
    return kL2GMma;
  return kL2GSimt;
}

template <typename T>
int g2l_launch(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int n, int L, int D, int Dv, float scale,
               cudaStream_t st) {
  const size_t smem = g2l_simt_smem(L, D, Dv);
  const int err = set_smem(g2l_kernel<T>, (int)smem);
  if (err != 0) return err;
  dim3 grid((n + kG2LRows - 1) / kG2LRows, B);
  g2l_kernel<T><<<grid, 32 * kWarps, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, n, L, D, Dv, scale);
  return (int)cudaGetLastError();
}

template <int LP>
int g2l_mma_launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int n, int L, int D, int Dv,
                   float scale, cudaStream_t st) {
  const int smem = (int)g2l_mma_smem(L, D, Dv);
  const int err = set_smem(g2l_mma_kernel<LP>, smem);
  if (err != 0) return err;
  const int tpw = g2l_tiles_per_warp(B, n);
  const int rows = g2l_rows_per_block(kG2LMma, B, n);
  g2l_mma_kernel<LP><<<dim3((n + rows - 1) / rows, B), kMmaWarps * 32, smem,
                       st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, n, L, D, Dv, scale,
      tpw);
  return (int)cudaGetLastError();
}

// The fixed-order sum over the partials of `parts` spans or chunks.
template <typename T>
int l2g_combine(const float* m_part, const float* s_part,
                const float* acc_part, void* o, float* lse, int B, int parts,
                int L, int Dv, cudaStream_t st) {
  const long long total = (long long)B * L * Dv;
  long long blocks = (total + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  l2g_combine_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      m_part, s_part, acc_part, (T*)o, lse, B, parts, L, Dv);
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
  return l2g_combine<T>(m_part, s_part, acc_part, o, lse, B, nchunks, L, Dv,
                        st);
}

template <int LP>
int l2g_mma_launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, float* m_part, float* s_part, float* acc_part,
                   int B, int n, int L, int D, int Dv, float scale,
                   cudaStream_t st) {
  const KeyTiling t = l2g_tiling(B, n, L, D, Dv);
  if (t.spans > 1 && (m_part == nullptr || s_part == nullptr ||
                      acc_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = set_smem(l2g_mma_kernel<LP>, (int)t.smem);
  if (err != 0) return err;
  l2g_mma_kernel<LP><<<dim3(t.spans, B), kKeyWarps * 32, t.smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, m_part, s_part,
      acc_part, n, L, D, Dv, scale, t.kt, t.stages, t.tps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || t.spans == 1) return (int)e;
  return l2g_combine<__nv_bfloat16>(m_part, s_part, acc_part, o, lse, B,
                                    t.spans, L, Dv, st);
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

// The plan of a grid_to_latent launch, for the wrapper's check: {path,
// LP (0 off the tensor-core route), 16-row tiles a warp, rows a block,
// dynamic shared memory}.
extern "C" void gt_g2l_plan(int dtype, int B, int n, int L, int D, int Dv,
                            int* out) {
  const int path = g2l_path(dtype, L, D, Dv);
  out[0] = path;
  out[1] = path == kG2LMma ? g2l_lp(L) : 0;
  out[2] = path == kG2LMma ? g2l_tiles_per_warp(B, n) : 0;
  out[3] = g2l_rows_per_block(path, B, n);
  out[4] = (int)g2l_smem(path, L, D, Dv);
}

// The plan of a latent_to_grid launch, for the wrapper's check: {path,
// LP, keys a tile, tiles a span, spans, ring stages, dynamic shared
// memory}; the CUDA-core route reports its chunk as the tile, one tile a
// span, LP and stages 0.
extern "C" void gt_l2g_plan(int dtype, int B, int n, int L, int D, int Dv,
                            int* out) {
  const int path = l2g_path(dtype, L, D, Dv);
  if (path == kL2GMma) {
    const KeyTiling t = l2g_tiling(B, n, L, D, Dv);
    const int plan[7] = {path, key_lp(L), t.kt, t.tps, t.spans, t.stages,
                         (int)t.smem};
    for (int i = 0; i < 7; ++i) out[i] = plan[i];
    return;
  }
  const int plan[7] = {path, 0, kChunk, 1, (n + kChunk - 1) / kChunk, 0,
                       (int)l2g_smem(L, D)};
  for (int i = 0; i < 7; ++i) out[i] = plan[i];
}

// `path` must be the route g2l_path gives (the wrapper's g2l_path).
extern "C" int gt_grid_to_latent(int path, int dtype, const void* q,
                                 const void* k, const void* v, void* o,
                                 float* lse, int B, int n, int L, int D,
                                 int Dv, float scale, void* stream) {
  if (L < 1 || L > kMaxL || path != g2l_path(dtype, L, D, Dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == kG2LMma) {
    if (L <= 16)
      return g2l_mma_launch<16>(q, k, v, o, lse, B, n, L, D, Dv, scale, st);
    if (L <= 32)
      return g2l_mma_launch<32>(q, k, v, o, lse, B, n, L, D, Dv, scale, st);
    return g2l_mma_launch<64>(q, k, v, o, lse, B, n, L, D, Dv, scale, st);
  }
  if (dtype == GT_DTYPE_F32)
    return g2l_launch<float>(q, k, v, o, lse, B, n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return g2l_launch<__nv_bfloat16>(q, k, v, o, lse, B, n, L, D, Dv, scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}

// `path` must be the route l2g_path gives (the wrapper's l2g_plan); the
// partials are those of the plan's spans (chunks on the CUDA-core route),
// null where the tensor-core plan has one span.
extern "C" int gt_latent_to_grid(int path, int dtype, const void* q,
                                 const void* k, const void* v, void* o,
                                 float* lse, float* m_part, float* s_part,
                                 float* acc_part, int B, int n, int L, int D,
                                 int Dv, float scale, void* stream) {
  if (L < 1 || L > kMaxL || n < 1 || path != l2g_path(dtype, L, D, Dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (path == kL2GMma) {
    if (L <= 16)
      return l2g_mma_launch<16>(q, k, v, o, lse, m_part, s_part, acc_part, B,
                                n, L, D, Dv, scale, st);
    return l2g_mma_launch<32>(q, k, v, o, lse, m_part, s_part, acc_part, B,
                              n, L, D, Dv, scale, st);
  }
  if (dtype == GT_DTYPE_F32)
    return l2g_dispatch<float>(q, k, v, o, lse, m_part, s_part, acc_part, B,
                               n, L, D, Dv, scale, st);
  if (dtype == GT_DTYPE_BF16)
    return l2g_dispatch<__nv_bfloat16>(q, k, v, o, lse, m_part, s_part,
                                       acc_part, B, n, L, D, Dv, scale, st);
  return (int)cudaErrorInvalidValue;
}
