// Dense half of one AR decode layer: the port of the TPU kernels
// valle_tpu/ops/fused_dense.py:_ln_qkv_kernel (:114, fused_ln_qkv) and
// valle_tpu/ops/fused_dense.py:_tail_kernel (:201, fused_tail).
//
// What bounds it on the H100: at decode shapes (B <= 64 rows, one token
// each) every product is a skinny GEMM whose cost is reading the weights
// once: W_in is 6 MiB in bf16 per layer at D = 1024, the tail's
// out-proj + lin1 + lin2 another 18 MiB (half that in int8), against
// 2 * B * D * N operations, far below the card's ~295 operations per
// byte. So every SM must keep many weight bytes in flight from the start
// of the kernel to its end, and everything else has to hide under that
// stream.
//
// dense_wgmma_kernel (bf16 activations; bf16 or int8 weights) computes
// out[b, n] = epi(sum_k LN?(x)[b, k] * W[n, k]) for W in PyTorch's (N, K)
// layout:
// - Weights are the wide operand of wgmma ("swap AB"): a block computes a
//   64-column tile of out^T = W_tile . x^T with m64n64k16, A the 64 x 64
//   weight tile and B the x rows, both K-major in csrc/hopper.cuh's
//   128-byte swizzled layout (rows past B are never read back: at B 32
//   half the product is padding, a fraction of a microsecond).
// - The grid splits N into 64-column tiles and K over the blocks of a
//   thread-block cluster (up to 16, H100's non-portable size), so that a
//   block streams on nearly every SM at every decode shape (QKV 48 tiles
//   x 4, out-proj and lin2 16 x 8, lin1 64 x 4). K's 64-wide tiles spread
//   over the cluster as evenly as they go, so every K that is a multiple
//   of 64 runs. One thread requests the block's whole weight slice (<= 8
//   tiles of 64 x 64) as TMA tiles onto mbarriers (tensor maps encoded
//   once per weight and cached), so all of its bytes are in flight at
//   once and no other thread's loads queue behind them; x, the bias,
//   scale and LayerNorm parameters are requested before that burst. A
//   slice wider than 8 tiles (K past 8192) is taken in chunks of 8, each
//   loaded after the last is consumed (LayerNorm statistics then come
//   from x in device memory first). int8 tiles (half the bytes) are
//   converted exactly to bf16 tiles in shared memory as they land; their
//   per-channel scale multiplies the fp32 sum in the epilogue.
// - The K-split partial sums meet in distributed shared memory: each block
//   pushes each row's partial to the block that finalizes that row (row b
//   to block b % split) and signals its mbarrier; the owner sums them in
//   rank order (no atomics: two launches give the same bits) and applies
//   the epilogue. Point-to-point signals cost less than cluster barriers.
// - LayerNorm runs in the prologue: each block stages its K slice of the
//   rows, takes the slice's mean and squared deviations, pushes them to
//   the cluster's blocks, and merges what it receives in rank order
//   (weighted by the slices' widths) before normalizing its slice in
//   place (fp32 statistics, parameters in bf16, output rounded to bf16,
//   as ops/fused_dense.py:34-39). fused_ln_qkv is
//   one launch; fused_tail three (out-proj + residual; LN2 + lin1 +
//   activation; lin2 + residual), since LN2 needs the whole row of h1.
// - B > 64 rows loops over 64-row passes with the weight slice kept in
//   shared memory, so weights are read from device memory once (per pass
//   when the slice takes several chunks).
// - Programmatic dependent launch: every launch takes the attribute, so
//   a kernel is scheduled while its predecessor drains; it waits
//   (griddepcontrol.wait) before its first load, which makes this safe
//   after any kernel.
// - The epilogue is a template parameter and the loops stay rolled: the
//   kernel is a chain of latencies run once per block, and straight-line
//   code (unrolled loops, every epilogue variant inlined) measured slower.
// - Rounding as the TPU kernel's _mms: fp32 accumulation; the int8 scale
//   multiplies the fp32 sum before the cast, then the bias is added, then
//   the activation or the residual.
//
// dense_rows_kernel (fp32 activations, the verification path of the
// token-exact codes) runs on the CUDA cores: 2 columns per warp, tiles of
// 8 rows staged in shared memory, 4 weight vectors in flight per lane;
// its LayerNorm is ln_rows_kernel (one warp per row), so the fp32
// fused_ln_qkv is two launches and fused_tail four.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using vt::from_f;
using vt::round_to;
using vt::to_f;

constexpr int kCols = 2;       // output columns per warp
constexpr int kPrefetch = 4;   // weight vectors in flight per lane and column
constexpr int kRows = 8;       // accumulator rows per lane (CUDA cores)
constexpr int kSmemBudget = 128 * 1024;

enum Epi { kEpiBias = 0, kEpiRelu = 1, kEpiGelu = 2, kEpiResid = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Converts one 16-byte vector of T to floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&out)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) out[j] = to_f(e[j]);
}

// Bias, scale, activation and residual of one output, rounded where the
// TPU kernel rounds.
template <typename T>
__device__ __forceinline__ float epilogue(float sum, float scale, float bias,
                                          int epi, float resid) {
  float y = round_to<T>(sum * scale);
  y = round_to<T>(y + bias);
  if (epi == kEpiRelu) y = fmaxf(y, 0.f);
  if (epi == kEpiGelu) y = gelu_tanh(y);
  if (epi == kEpiResid) y = resid + y;
  return y;
}

// One warp per row: LayerNorm in fp32, output cast to T.
template <typename T>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const T* __restrict__ x, int B, int K, const T* __restrict__ ln_w,
    const T* __restrict__ ln_b, T* __restrict__ out, float eps) {
  constexpr int TV = 16 / sizeof(T);
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const T* xr = x + (size_t)row * K;
  float v[TV];
  float s = 0.f;
  for (int k = lane * TV; k < K; k += 32 * TV) {
    unpack<T>(*reinterpret_cast<const uint4*>(xr + k), v);
#pragma unroll
    for (int j = 0; j < TV; ++j) s += v[j];
  }
  const float mean = vt::warp_sum(s) / K;
  float var = 0.f;
  for (int k = lane * TV; k < K; k += 32 * TV) {
    unpack<T>(*reinterpret_cast<const uint4*>(xr + k), v);
#pragma unroll
    for (int j = 0; j < TV; ++j) var += (v[j] - mean) * (v[j] - mean);
  }
  const float rstd = rsqrtf(vt::warp_sum(var) / K + eps);
  for (int k = lane * TV; k < K; k += 32 * TV) {
    float w[TV], b[TV];
    unpack<T>(*reinterpret_cast<const uint4*>(xr + k), v);
    unpack<T>(*reinterpret_cast<const uint4*>(ln_w + k), w);
    unpack<T>(*reinterpret_cast<const uint4*>(ln_b + k), b);
    alignas(16) T o[TV];
#pragma unroll
    for (int j = 0; j < TV; ++j)
      o[j] = from_f<T>((v[j] - mean) * rstd * w[j] + b[j]);
    *reinterpret_cast<uint4*>(out + (size_t)row * K + k) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <typename T, typename WT, int EPI>
__global__ void __launch_bounds__(256) dense_rows_kernel(
    const T* __restrict__ x, int B, int K, const WT* __restrict__ w, int N,
    const float* __restrict__ wscale, const T* __restrict__ bias,
    const T* __restrict__ resid, T* __restrict__ out, int row_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  constexpr int VEC = 16 / sizeof(WT);   // weights per 16-byte load
  constexpr int TV = 16 / sizeof(T);     // activations per 16-byte load
  constexpr int XV = VEC / TV;           // 16-byte activation loads per VEC
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * warps + warp) * kCols;
  const int step = 32 * VEC;             // k advance per loop iteration
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load_w = [&](int c, int k) {
    return (n0 + c < N && k < K)
               ? *reinterpret_cast<const uint4*>(w + (size_t)(n0 + c) * K + k)
               : zero;
  };

  for (int r0 = 0; r0 < B; r0 += row_tile) {
    const int rt = min(row_tile, B - r0);
    uint4 ring[kPrefetch][kCols];
#pragma unroll
    for (int p = 0; p < kPrefetch; ++p)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ring[p][c] = load_w(c, lane * VEC + p * step);

    __syncthreads();  // the previous tile is fully consumed
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r0 * K);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = threadIdx.x; i < rt * K / TV; i += blockDim.x) dst[i] = src[i];
    __syncthreads();

    float acc[kCols][kRows];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;

    for (int k0 = lane * VEC; k0 < K; k0 += kPrefetch * step) {
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const int k = k0 + p * step;
        if (k < K) {
          float wv[kCols][VEC];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            unpack<WT>(ring[p][c], wv[c]);
            ring[p][c] = load_w(c, k + kPrefetch * step);
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rt) {
#pragma unroll
              for (int q = 0; q < XV; ++q) {
                float xv[TV];
                unpack<T>(*reinterpret_cast<const uint4*>(
                              xs + r * K + k + q * TV), xv);
#pragma unroll
                for (int j = 0; j < TV; ++j)
#pragma unroll
                  for (int c = 0; c < kCols; ++c)
                    acc[c][r] += xv[j] * wv[c][q * TV + j];
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rt) {  // uniform across the warp
          const float sum = vt::warp_sum(acc[c][r]);
          const int n = n0 + c;
          if (lane == ((c * kRows + r) & 31) && n < N) {
            const size_t o = (size_t)(r0 + r) * N + n;
            out[o] = from_f<T>(epilogue<T>(
                sum, wscale ? wscale[n] : 1.f, to_f(bias[n]), EPI,
                EPI == kEpiResid ? to_f(resid[o]) : 0.f));
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 activations: wgmma over swizzled tiles, K split over a cluster
// ---------------------------------------------------------------------------

constexpr int kTile = 64;          // weight rows, x rows and k of a tile
constexpr int kThreads = 256;      // warpgroup 0 runs the products; both
                                   // stage x, LayerNorm and reduce
constexpr int kMaxTiles = 8;       // k tiles of weights (and x) a block
                                   // holds at once: one chunk
constexpr int kMaxSplit = 16;      // blocks of a cluster (16: H100's
                                   // non-portable size)
constexpr int kPartLd = 68;        // floats a row of a partial tile:
                                   // conflict-free stores from wgmma's layout
constexpr int kInt8TileBytes = kTile * kTile;
constexpr int kPartBytes = kTile * kPartLd * sizeof(float);
constexpr int kLnTiles = 4;        // k tiles a block with LayerNorm should
                                   // own (the split grows until it does)

struct DenseArgs {
  const __nv_bfloat16* x;          // (B, K)
  const void* w;                   // (N, K) bf16 or int8
  const float* wscale;             // (N,) for int8 weights, else null
  const __nv_bfloat16* bias;       // (N,)
  const __nv_bfloat16* resid;      // (B, N) for kEpiResid, else null
  const __nv_bfloat16* ln_w;       // (K,) LayerNorm of x first, or null
  const __nv_bfloat16* ln_b;
  __nv_bfloat16* out;              // (B, N)
  int B, K, N, epi;
  int cs;                          // k tiles of a chunk (<= kMaxTiles)
  float eps;
};

// Shared memory, for chunks of cs k tiles: weight tiles (bf16, or
// converted from int8); x tiles, which hold the block's own partial tile
// once the product is done; the partials it receives; row statistics;
// LayerNorm parameters; raw int8 tiles.
__host__ __device__ constexpr int dense_w_bytes(int cs) {
  return cs * vt::kSwTileBytes;
}
__host__ __device__ constexpr int dense_x_bytes(int cs) {
  return cs * vt::kSwTileBytes > kPartBytes ? cs * vt::kSwTileBytes
                                            : kPartBytes;
}
constexpr int kStatBytes = kMaxSplit * kTile * 2 * sizeof(float);
constexpr size_t dense_smem_bytes(int cs, bool w8) {
  return 1024 + dense_w_bytes(cs) + dense_x_bytes(cs) + kPartBytes +
         kStatBytes + (size_t)cs * 2 * kTile * 2 +
         (w8 ? (size_t)cs * kInt8TileBytes : 0);
}

// The first k tile of block q's K slice: the nkt tiles of K spread over
// the split blocks as evenly as they go (slices differ by at most one).
__device__ __forceinline__ int slice_start(int q, int nkt, int split) {
  return q * nkt / split;
}

__device__ __forceinline__ uint8_t* x_chunk_ptr(uint8_t* sx, int r, int cc) {
  return sx + (cc >> 3) * vt::kSwTileBytes + vt::sw128_offset(r, cc & 7);
}

// Thread tid handles 16-byte chunks sub, sub + tpr, ... (< cpr) of x row
// r: the rows of a pass spread over all threads (tpr a power of two <=
// 32, so a row's threads are neighbouring lanes of one warp); r >= rv:
// idle (those rows of the x tiles are never read back: the product's
// columns past rv are discarded).
struct RowMap {
  int r, sub, tpr;
};
__device__ __forceinline__ RowMap row_map(int rv, int cpr) {
  int rows = 1;
  while (rows < rv) rows <<= 1;
  int tpr = min(kThreads / rows, 32);
  while (tpr > cpr) tpr >>= 1;
  return {(int)threadIdx.x / tpr, (int)threadIdx.x % tpr, tpr};
}

__device__ __forceinline__ float row_sum(float v, int tpr) {
  for (int o = 1; o < tpr; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sum8(const float (&f)[8]) {
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

// One cp.async group: this thread's chunks of rows r0 .. r0 + rv of x's
// nt k tiles from k0 straight into the swizzled x tiles (.cg: read
// through L2).
__device__ __forceinline__ void copy_x(const DenseArgs& a, uint8_t* sx,
                                       int r0, int rv, int k0, int nt) {
  const int cpr = nt * 8;
  const RowMap m = row_map(rv, cpr);
  if (m.r < rv) {
    const __nv_bfloat16* src = a.x + (size_t)(r0 + m.r) * a.K + k0;
    for (int cc = m.sub; cc < cpr; cc += m.tpr)
      vt::cp_async16(vt::smem_addr(x_chunk_ptr(sx, m.r, cc)), src + cc * 8,
                     true);
  }
  vt::cp_async_commit();
}

// Four bf16 packed in a uint2, exactly as floats.
__device__ __forceinline__ void bf16x4_to_f(uint2 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// (x - mean) * rstd * w + b, rounded to bf16, in place over the chunks
// sub, sub + tpr, ... (< cpr) of staged row r (lnp: the chunk's LayerNorm
// weights then biases).
__device__ __forceinline__ void normalize_row(uint8_t* sx, const uint4* lnp,
                                              int r, int sub, int tpr,
                                              int cpr, float mean,
                                              float rstd) {
#pragma unroll 2
  for (int cc = sub; cc < cpr; cc += tpr) {
    uint4* chunk = reinterpret_cast<uint4*>(x_chunk_ptr(sx, r, cc));
    float f[8], w[8], b[8], y[8];
    unpack<__nv_bfloat16>(*chunk, f);
    unpack<__nv_bfloat16>(lnp[cc], w);
    unpack<__nv_bfloat16>(lnp[cpr + cc], b);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = (f[e] - mean) * rstd * w[e] + b[e];
    *chunk = make_uint4(vt::pack_bf16(y[0], y[1]), vt::pack_bf16(y[2], y[3]),
                        vt::pack_bf16(y[4], y[5]), vt::pack_bf16(y[6], y[7]));
  }
}

// LayerNorm of the rv rows r0 .. of this pass. Each block holds the nk k
// tiles from k0 of every row, so it takes its slice's mean and squared
// deviations (one pass, shifted by the slice's first value so the squares
// do not cancel), pushes them to stat[kr][row] of every block of the
// cluster and signals their barrier `bar`, waits for its own, and merges
// them in rank order (Chan et al.'s pairwise update, weighted by each
// slice's width) into the row's mean and variance: fp32 statistics,
// output rounded to bf16. `whole`: the slice is staged in sx (one
// chunk), read from there and normalized in place (lnp: the slice's
// parameters); else the statistics are read from x in device memory and
// (mean, rstd) written to row_stat for ln_apply to use chunk by chunk.
__device__ __forceinline__ void layer_norm_x(
    const DenseArgs& a, uint8_t* sx, float* stat, const uint4* lnp,
    float2* row_stat, bool whole, int r0, int rv, int k0, int nk,
    uint32_t bar, uint32_t parity, bool first) {
  const int cpr = nk * 8, n = nk * kTile;
  const int split = gridDim.x, kr = blockIdx.x, nkt = a.K / kTile;
  const RowMap rm = row_map(rv, cpr);
  const bool act = rm.r < rv;
  const int r = min(rm.r, kTile - 1);
  const __nv_bfloat16* xr = a.x + (size_t)(r0 + r) * a.K + k0;
  auto chunk = [&](int cc) {
    return whole ? *reinterpret_cast<const uint4*>(x_chunk_ptr(sx, r, cc))
                 : __ldcg(reinterpret_cast<const uint4*>(xr + cc * 8));
  };
  float f[8], sum = 0.f, sq = 0.f;
  const float shift = __shfl_sync(
      0xffffffffu,
      act ? __bfloat162float(whole ? *reinterpret_cast<const __nv_bfloat16*>(
                                         x_chunk_ptr(sx, r, 0))
                                   : xr[0])
          : 0.f,
      (threadIdx.x & 31) & ~(rm.tpr - 1));
#pragma unroll 2
  for (int cc = rm.sub; cc < cpr && act; cc += rm.tpr) {
    unpack<__nv_bfloat16>(chunk(cc), f);
    float d2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      f[e] -= shift;
      d2[e] = f[e] * f[e];
    }
    sum += sum8(f);
    sq += sum8(d2);
  }
  sum = row_sum(sum, rm.tpr);
  const float m = shift + sum / n;
  sq = row_sum(sq, rm.tpr) - sum * sum / n;
  const uint32_t slot = vt::smem_addr(stat + (kr * kTile + r) * 2);
  if (first) vt::cluster_wait();   // the peers' barriers are set up
  for (int q = rm.sub; q < split && act; q += rm.tpr)
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(
                     vt::cluster_addr(slot, q)),
                 "f"(m), "f"(sq)
                 : "memory");
  __syncthreads();
  if (threadIdx.x < split)
    vt::mbar_arrive_cluster(vt::cluster_addr(bar, threadIdx.x));
  vt::mbar_wait_cluster(bar, parity);
  if (!act) return;
  float m2 = 0.f, mean = 0.f;
  const float2* st = reinterpret_cast<const float2*>(stat) + r;
  for (int q = 0; q < split; ++q)
    mean += (slice_start(q + 1, nkt, split) - slice_start(q, nkt, split)) *
            st[q * kTile].x;
  mean /= nkt;
  for (int q = 0; q < split; ++q) {
    const float2 p = st[q * kTile];
    const int nq =
        (slice_start(q + 1, nkt, split) - slice_start(q, nkt, split)) * kTile;
    m2 += p.y + nq * (p.x - mean) * (p.x - mean);
  }
  const float rstd = rsqrtf(m2 / a.K + a.eps);
  if (whole)
    normalize_row(sx, lnp, r, rm.sub, rm.tpr, cpr, mean, rstd);
  else if (rm.sub == 0)
    row_stat[r] = make_float2(mean, rstd);
}

// LayerNorm of a staged chunk of nt k tiles with the statistics in
// row_stat.
__device__ __forceinline__ void ln_apply(uint8_t* sx, const uint4* lnp,
                                         const float2* row_stat, int rv,
                                         int nt) {
  const RowMap rm = row_map(rv, nt * 8);
  if (rm.r >= rv) return;
  const float2 s = row_stat[rm.r];
  normalize_row(sx, lnp, rm.r, rm.sub, rm.tpr, nt * 8, s.x, s.y);
}

// Raw int8 tile `raw` (64 rows of 64 bytes), converted (exactly) to bf16
// in the swizzled tile.
__device__ __forceinline__ void convert_int8_tile(const uint8_t* raw,
                                                  uint8_t* tile) {
  for (int idx = threadIdx.x; idx < kTile * 4; idx += kThreads) {
    const int r = idx >> 2, c = idx & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * 64 + c * 16);
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = vt::pack_bf16((float)e[2 * i], (float)e[2 * i + 1]);
    *reinterpret_cast<uint4*>(tile + vt::sw128_offset(r, 2 * c)) =
        make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(tile + vt::sw128_offset(r, 2 * c + 1)) =
        make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// Barrier of warpgroup 0 alone.
__device__ __forceinline__ void named_sync_wg0() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Grid (split, N / 64), clusters of (split, 1, 1): block (kr, y) owns
// output columns 64 y .. 64 y + 63 and k tiles slice_start(kr) ..
// slice_start(kr + 1) - 1, taken in chunks of up to a.cs tiles, and
// finalizes the rows b with b % split == kr.
template <bool W8, bool LN, int EPI>
__global__ void __launch_bounds__(kThreads) dense_wgmma_kernel(
    const DenseArgs a, const __grid_constant__ CUtensorMap wmap) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int cs = a.cs;
  uint8_t* sw = vt::align1024(smem_raw);            // weight tiles
  uint8_t* sx = sw + dense_w_bytes(cs);             // x tiles
  float* part = reinterpret_cast<float*>(sx);       // after the product
  float* recv = reinterpret_cast<float*>(sx + dense_x_bytes(cs));
  float* stat = recv + kTile * kPartLd;   // [kr][row] slice (mean, M2)
  uint4* lnp = reinterpret_cast<uint4*>(stat + kStatBytes / 4);
  uint8_t* sraw = reinterpret_cast<uint8_t*>(lnp + cs * 16);  // int8
  __shared__ __align__(8) uint64_t wbar[kMaxTiles];  // weight tile i landed
  // every block's LayerNorm statistics / partial sums have landed here
  __shared__ __align__(8) uint64_t stat_bar, recv_bar;
  __shared__ float2 row_stat[kTile];   // (mean, rstd) when chunks > 1

  // the cluster: the split blocks (blockIdx.x) of one column tile
  const int split = gridDim.x, kr = blockIdx.x, nkt = a.K / kTile;
  const int t0 = slice_start(kr, nkt, split);
  const int nk = slice_start(kr + 1, nkt, split) - t0;  // k tiles owned
  const int nch = (nk + cs - 1) / cs;   // chunks: 1 but past kMaxTiles
  const bool multi = nch > 1;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * kTile, k0 = t0 * kTile;
  const int rpo = kTile / split;        // rows a block finalizes a pass

  // Every small operand is requested before the weights (a load issued
  // after the weight burst waits behind it); the weights of a chunk then
  // follow as TMA tiles, one barrier each, issued by one thread.
  if (tid == 0) {
    vt::prefetch_tmap(&wmap);
    for (int i = 0; i < cs; ++i) vt::mbar_init(vt::smem_addr(&wbar[i]), 1);
    vt::mbar_init(vt::smem_addr(&stat_bar), split);
    vt::mbar_init(vt::smem_addr(&recv_bar), split);
    vt::fence_mbar_init();
  }
  // the other blocks may signal this one's barriers only once they are
  // initialized: the matching wait comes just before this block first
  // writes to another (its latency hides under the loads)
  vt::cluster_arrive();
  vt::griddep_launch_dependents();
  vt::griddep_wait();   // x, resid and the small operands may come from
                        // the previous kernel
  // this thread's LayerNorm parameters of chunk c (nt tiles)
  auto ln_param = [&](int c, int nt) {
    const int cpr = nt * 8;
    return __ldcg(reinterpret_cast<const uint4*>(
        (tid < cpr ? a.ln_w : a.ln_b) + k0 + c * cs * kTile +
        (tid % cpr) * 8));
  };
  auto load_weights = [&](int c, int nt) {
    for (int i = 0; i < nt; ++i)
      vt::tma_load_2d(vt::smem_addr(W8 ? sraw + i * kInt8TileBytes
                                       : sw + i * vt::kSwTileBytes),
                      &wmap, vt::smem_addr(&wbar[i]),
                      k0 + (c * cs + i) * kTile, n0,
                      W8 ? kInt8TileBytes : vt::kSwTileBytes);
  };
  const int nt0 = min(nk, cs);
  copy_x(a, sx, 0, min(kTile, a.B), k0, nt0);
  uint4 lnv = make_uint4(0, 0, 0, 0);   // chunk 0's LayerNorm parameters
  if (LN && tid < 2 * nt0 * 8) lnv = ln_param(0, nt0);
  // this thread's 4 output columns in the epilogue, and their operands
  // (kept as loaded: a conversion here would wait for them)
  const int c4 = (tid & 15) * 4, n = n0 + c4;
  const uint2 bias_raw = __ldcg(reinterpret_cast<const uint2*>(a.bias + n));
  const float4 scale = a.wscale ? __ldcg(reinterpret_cast<const float4*>(
                                      a.wscale + n))
                                : make_float4(1.f, 1.f, 1.f, 1.f);
  if (tid == 0) load_weights(0, nt0);
  if (LN && tid < 2 * nt0 * 8) lnp[tid] = lnv;

  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  uint32_t wphase = 0;   // bit i: the phase of wbar[i] to wait for
  for (int r0 = 0; r0 < a.B; r0 += kTile) {
    const int rv = min(kTile, a.B - r0);
    const uint32_t parity = (r0 / kTile) & 1;
    // one chunk: the weights stay in shared memory for every pass
    const bool fresh = multi || r0 == 0;
    if (LN && multi)
      layer_norm_x(a, sx, stat, lnp, row_stat, false, r0, rv, k0, nk,
                   vt::smem_addr(&stat_bar), parity, r0 == 0);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const int nt = min(cs, nk - c * cs);
      if (r0 > 0 || c > 0) {
        copy_x(a, sx, r0, rv, k0 + c * cs * kTile, nt);
        if (multi) {
          if (LN && tid < 2 * nt * 8) lnp[tid] = ln_param(c, nt);
          if (tid == 0) load_weights(c, nt);
        }
      }
      vt::cp_async_wait<0>();
      if constexpr (LN) {
        if (!multi) {
          layer_norm_x(a, sx, stat, lnp, row_stat, true, r0, rv, k0, nk,
                       vt::smem_addr(&stat_bar), parity, r0 == 0);
        } else {
          __syncthreads();   // lnp and row_stat are written
          ln_apply(sx, lnp, row_stat, rv, nt);
        }
      }
      vt::fence_proxy_async();
      __syncthreads();

      if (W8 && fresh) {   // int8 tiles to bf16 as they land
        for (int i = 0; i < nt; ++i) {
          vt::mbar_wait(vt::smem_addr(&wbar[i]), (wphase >> i) & 1);
          convert_int8_tile(sraw + i * kInt8TileBytes,
                            sw + i * vt::kSwTileBytes);
        }
        vt::fence_proxy_async();
        __syncthreads();
      }
      if (tid < 128) {   // warpgroup 0: the products
        for (int i = 0; i < nt; ++i) {
          uint8_t* wt = sw + i * vt::kSwTileBytes;
          if (!W8 && fresh)
            vt::mbar_wait(vt::smem_addr(&wbar[i]), (wphase >> i) & 1);
          const uint64_t dw = vt::sw128_desc(vt::smem_addr(wt)),
                         dx = vt::sw128_desc(vt::smem_addr(
                             sx + i * vt::kSwTileBytes));
          vt::wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k)
            vt::wgmma_ss(acc, dw + 2 * k, dx + 2 * k, 1);
          vt::wgmma_commit();
        }
        vt::wgmma_wait<0>();
      }
      if (fresh) wphase ^= (1u << nt) - 1;
      // the next chunk's loads overwrite this one's tiles
      if (multi) __syncthreads();
    }
    if (tid < 128) {
      vt::fence_regs(acc);
      // acc[4 j + e] = out^T[16 warp + g + 8 (e / 2)][8 j + 2 t + e % 2];
      // the x tiles are free: every product is done
      named_sync_wg0();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(8 * j + 2 * t + (e & 1)) * kPartLd + 16 * warp + g +
               8 * (e >> 1)] = acc[4 * j + e];
    }
    __syncthreads();
    // push row b's partial to block b % split, slot [kr][b / split], and
    // signal every block's barrier
    if (!LN && r0 == 0) vt::cluster_wait();   // the peers are set up
    for (int c = tid; c < rv * 16; c += kThreads) {
      const int b = c >> 4, cc = (c & 15) * 4;
      const float4 p =
          *reinterpret_cast<const float4*>(part + b * kPartLd + cc);
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::
                       "r"(vt::cluster_addr(
                           vt::smem_addr(recv + (kr * rpo + b / split) *
                                                    kPartLd + cc),
                           b % split)),
                   "f"(p.x), "f"(p.y), "f"(p.z), "f"(p.w)
                   : "memory");
    }
    __syncthreads();
    if (tid < split)
      vt::mbar_arrive_cluster(vt::cluster_addr(vt::smem_addr(&recv_bar), tid));
    vt::mbar_wait_cluster(vt::smem_addr(&recv_bar), parity);

    // finalize this block's rows: the partials in rank order, epilogue
    const float sc[4] = {scale.x, scale.y, scale.z, scale.w};
    float bf[4];
    bf16x4_to_f(bias_raw, bf);
#pragma unroll 1
    for (int slot = tid >> 4; kr + split * slot < rv;
         slot += kThreads / 16) {
      const int b = kr + split * slot;
      const size_t o = (size_t)(r0 + b) * a.N + n;
      float rf[4] = {0.f, 0.f, 0.f, 0.f};
      if (EPI == kEpiResid)
        bf16x4_to_f(__ldcg(reinterpret_cast<const uint2*>(a.resid + o)), rf);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < split; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(
            recv + (q * rpo + slot) * kPartLd + c4);
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      }
      const float sum[4] = {s.x, s.y, s.z, s.w};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = epilogue<T>(sum[e], sc[e], bf[e], EPI, rf[e]);
      *reinterpret_cast<uint2*>(a.out + o) =
          make_uint2(vt::pack_bf16(y[0], y[1]), vt::pack_bf16(y[2], y[3]));
    }
    // before the next pass's signals: every block is done with recv, stat
    if (r0 + kTile < a.B) {
      vt::cluster_arrive();
      vt::cluster_wait();
    }
  }
}

// The TMA descriptor of a weight (N, K), bf16 in 128-byte swizzled 64 x 64
// tiles or int8 in plain 64 x 64 byte tiles. Encoded once per (address,
// shape, type) through cudaGetDriverEntryPoint and cached: the decode loop
// passes the same weights every step, so a call pays only the lookup. A
// descriptor holds nothing but these four, so a reused address stays
// valid. The cache is emptied when it reaches kMaxMaps entries, so weights
// made anew for every request (fused_w8 quantizes them per decode call)
// cannot grow it without bound; the maps in use are encoded again.
constexpr size_t kMaxMaps = 1024;
cudaError_t weight_map(const void* w, int N, int K, bool w8,
                       CUtensorMap* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, bool>, CUtensorMap> cache;
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(w, N, K, w8);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const int esize = w8 ? 1 : 2;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  cuuint64_t strides[1] = {(cuuint64_t)K * esize};
  cuuint32_t box[2] = {kTile, kTile};
  cuuint32_t estr[2] = {1, 1};
  CUtensorMap m;
  const CUresult r = encode(
      &m, w8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(w), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      w8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(key, m);
  *out = m;
  return cudaSuccess;
}

template <bool W8, bool LN, int EPI>
cudaError_t launch_wgmma(DenseArgs a, cudaStream_t stream) {
  int sms = 0;
  cudaError_t se = vt::device_sms(&sms);
  if (se != cudaSuccess) return se;
  if (a.K % kTile != 0 || a.N % kTile != 0 || a.B <= 0)
    return cudaErrorInvalidValue;
  const int tiles = a.N / kTile, nkt = a.K / kTile;
  // the fewest blocks a cluster that put a block on 7/8 of the SMs and
  // leave a block with LayerNorm at most kLnTiles k tiles (a larger
  // cluster costs more in the exchange than the last few SMs add); a
  // block takes its slice in chunks of at most kMaxTiles
  auto widest = [&](int s) { return (nkt + s - 1) / s; };
  int split = 1;
  while (split < kMaxSplit && 2 * split <= nkt &&
         (8 * tiles * split < 7 * sms ||
          widest(split) > (LN ? kLnTiles : kMaxTiles)))
    split *= 2;
  a.cs = min(widest(split), kMaxTiles);
  CUtensorMap wmap;
  cudaError_t me = weight_map(a.w, a.N, a.K, W8, &wmap);
  if (me != cudaSuccess) return me;
  auto kern = dense_wgmma_kernel<W8, LN, EPI>;
  static std::atomic<uint64_t> attr_set{0};
  cudaError_t ae = vt::once_per_device(attr_set, [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dense_smem_bytes(kMaxTiles, W8));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (ae != cudaSuccess) return ae;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dense_smem_bytes(a.cs, W8);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, wmap);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, typename WT, int EPI>
cudaError_t launch_rows(const void* x, int B, int K, const void* w, int N,
                        const float* wscale, const void* bias,
                        const void* resid, void* out, cudaStream_t stream) {
  const size_t row_bytes = (size_t)K * sizeof(T);
  int rows = (int)(kSmemBudget / row_bytes);
  if (rows < 1 || K % 16 != 0) return cudaErrorInvalidValue;
  rows = min(min(rows, kRows), B);
  auto kern = dense_rows_kernel<T, WT, EPI>;
  static std::atomic<uint64_t> attr_set{0};
  cudaError_t ae = vt::once_per_device(attr_set, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  });
  if (ae != cudaSuccess) return ae;
  const int warps = N >= 2048 ? 8 : 4;
  dim3 grid((N + warps * kCols - 1) / (warps * kCols));
  kern<<<grid, warps * 32, rows * row_bytes, stream>>>(
      static_cast<const T*>(x), B, K, static_cast<const WT*>(w), N, wscale,
      static_cast<const T*>(bias), static_cast<const T*>(resid),
      static_cast<T*>(out), rows);
  return cudaGetLastError();
}

template <bool W8>
cudaError_t dispatch_wgmma(const DenseArgs& a, cudaStream_t s) {
  const bool ln = a.ln_w != nullptr;
  switch (a.epi) {
    case kEpiBias:
      return ln ? launch_wgmma<W8, true, kEpiBias>(a, s)
                : launch_wgmma<W8, false, kEpiBias>(a, s);
    case kEpiRelu:
      return ln ? launch_wgmma<W8, true, kEpiRelu>(a, s)
                : launch_wgmma<W8, false, kEpiRelu>(a, s);
    case kEpiGelu:
      return ln ? launch_wgmma<W8, true, kEpiGelu>(a, s)
                : launch_wgmma<W8, false, kEpiGelu>(a, s);
    case kEpiResid:   // the residual kernels take no LayerNorm
      return ln ? cudaErrorInvalidValue
                : launch_wgmma<W8, false, kEpiResid>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename WT>
cudaError_t dispatch_rows(int epi, const void* x, int B, int K, const void* w,
                          int N, const float* wscale, const void* bias,
                          const void* resid, void* out, cudaStream_t s) {
#define VT_ARGS x, B, K, w, N, wscale, bias, resid, out, s
  switch (epi) {
    case kEpiBias: return launch_rows<float, WT, kEpiBias>(VT_ARGS);
    case kEpiRelu: return launch_rows<float, WT, kEpiRelu>(VT_ARGS);
    case kEpiGelu: return launch_rows<float, WT, kEpiGelu>(VT_ARGS);
    case kEpiResid: return launch_rows<float, WT, kEpiResid>(VT_ARGS);
  }
#undef VT_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// fp32 rows only (the bf16 LayerNorm runs inside dense_wgmma_kernel).
extern "C" int vt_layer_norm_rows(const float* x, int B, int K,
                                  const float* ln_w, const float* ln_b,
                                  float* out, float eps, void* stream) {
  if (K % 4 != 0) return cudaErrorInvalidValue;
  ln_rows_kernel<float><<<(B + 7) / 8, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, B, K, ln_w, ln_b, out, eps);
  return cudaGetLastError();
}

// out = epi(LN?(x) @ w^T * scale + bias) (B, N). ln_w/ln_b non-null: the
// LayerNorm prologue (bf16 only).
extern "C" int vt_dense_rows(int dtype, int w_int8, int epi, const void* x,
                             int B, int K, const void* w, int N,
                             const float* wscale, const void* bias,
                             const void* resid, void* out, const void* ln_w,
                             const void* ln_b, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi < kEpiBias || epi > kEpiResid) return cudaErrorInvalidValue;
  if (dtype == vt::kF32) {
    if (ln_w != nullptr) return cudaErrorInvalidValue;
#define VT_ARGS epi, x, B, K, w, N, wscale, bias, resid, out, s
    return w_int8 ? dispatch_rows<int8_t>(VT_ARGS)
                  : dispatch_rows<float>(VT_ARGS);
#undef VT_ARGS
  }
  if (dtype != vt::kBF16) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  DenseArgs a;
  a.x = static_cast<const T*>(x);
  a.w = w;
  a.wscale = wscale;
  a.bias = static_cast<const T*>(bias);
  a.resid = static_cast<const T*>(resid);
  a.ln_w = static_cast<const T*>(ln_w);
  a.ln_b = static_cast<const T*>(ln_b);
  a.out = static_cast<T*>(out);
  a.B = B;
  a.K = K;
  a.N = N;
  a.epi = epi;
  a.cs = 0;
  a.eps = eps;
  return w_int8 ? dispatch_wgmma<true>(a, s) : dispatch_wgmma<false>(a, s);
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
