// The backward of flash attention with dropout: the port of the TPU kernel
// valle_tpu/ops/flash_mha.py:_bwd_kernel (reached through _pallas_bwd).
//
// With p = exp(s - lse) the forward's normalized probabilities (recomputed
// from q, k and the saved log-sum-exp, never stored), keep(i, j) the
// forward's dropout mask (regenerated from the same Philox counter, or
// read from the same bits) and c = 1 / (1 - thresh / 256):
//   delta_i = sum_d out_id * g_id                        (fp32)
//   dpd     = g v^T
//   pd      = keep ? p * c : 0,  dp = keep ? dpd * c : 0
//   dv     += pd^T g             (pd rounded to g's dtype first)
//   ds      = p * (dp - delta)   (rounded to q's dtype)
//   dq      = ds k * scale,  dk += ds^T q * scale        (fp32 accumulation)
// exactly what _bwd_kernel computes (flash_mha.py:193-223). As in the JAX
// kernel, a row that sees no key gets p = exp(-1e30 - lse) = 1, not the
// forward's 1 / T: such rows must carry a zero cotangent (VALL-E's masks
// have none).
//
// What bounds it on the H100: at the AR training shape (B*H = 256, S = T =
// 471, Dh = 64) the work is at most 5 products of 2*S*T*Dh per (b, h):
// 36.3 GFLOP, 37 us of bf16 tensor-core time, and it moves ~123 MB (q, k,
// v, out, g, dq, dk, dv, lse): 37 us of HBM time (Dh 128 doubles both).
// The TPU kernel walks the q-blocks of one (b, h) in order and keeps dk/dv
// in VMEM scratch across them; Hopper blocks run in no order, so the work
// splits into launches that need no atomics and give the same bits on
// every run:
//
// - flash_bwd_dq_wgmma: one warpgroup per (b, h, tile of 64 queries, 64
//   columns of dq: one block at Dh 64, two at Dh 128). It first takes
//   delta = rowsum(out * g) of its rows (fp32, written for the dk/dv
//   launch), then walks the key tiles with dq in registers: S = q k^T and
//   dP = g v^T as wgmma chains from shared memory, dS in registers as the
//   A operand of dq += dS k (k read transposed).
// - flash_bwd_dkdv_wgmma: one warpgroup per (b, h, tile of 64 keys, 64
//   columns of dk and dv), walking the query tiles with dk and dv in
//   registers: S^T = k q^T and
//   dP^T = v g^T, then dv += Pd^T g and dk += dS^T q with the score
//   accumulators as register A operands and q, g read transposed.
//   Recomputing P and dP in both launches costs 7 products where one
//   kernel with dq atomics would do 5, but the result is deterministic.
// - Both bring their streamed tiles (q/g or k/v, with their codes, lse and
//   delta) by cp.async into a two-stage ring in the 128-byte swizzled
//   layout (hopper.cuh), so the next tile loads while this one multiplies
//   and the operand reads are free of bank conflicts.
// - Both skip the tiles of the other side that cannot hold a visible pair
//   (flash_mha.cuh:build_tile_list, the forward's rule). That is exact
//   under the contract above: in a skipped pair p = 0 when the row sees a
//   key, and g = 0 (so dS = Pd^T g = 0) when it sees none.
// - p is recomputed with the fast __expf (ex2.approx), as the forward's
//   wgmma kernel does; the CUDA-core kernels use expf.
// - Dropout bytes: each 16-byte Philox output is computed once per warp
//   and staged in shared memory; the dk/dv tiles have keys as rows, so
//   there one output (16 keys of one query) is a column (flash_mha.cuh).
//
// fp32 (the verification path) runs on the CUDA cores, Dh / 64 threads per
// key (dkdv) or per query (dq), after flash_bwd_delta_kernel. Ragged S/T
// edges are masked in the kernels.
//
// Not yet used: TMA, warp specialisation, one kernel with dq reduced
// across blocks, overlap of a tile's elementwise work with the next
// tile's products.

#include <math.h>

#include "flash_mha.cuh"

namespace {

using vt::Dropout;
using vt::kNegInf;

// delta = rowsum(out * g), one warp a row.
template <int DH>
__global__ void __launch_bounds__(128) flash_bwd_delta_kernel(
    const float* __restrict__ out, const float* __restrict__ g,
    float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = out + (size_t)row * DH;
  const float* gg = g + (size_t)row * DH;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32) s += o[d] * gg[d];
  s = vt::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// Masked, scaled score of query i (code qc, segment qs) and key j.
__device__ __forceinline__ float masked(float dot, int kc, int ks, int qc,
                                        int qs, bool packed, int add_diag,
                                        int i, int j, float sm_scale) {
  bool vis = kc <= qc;
  if (packed) vis = vis && (qs == ks);
  if (add_diag) vis = vis || (i == j);
  return vis ? dot * sm_scale : kNegInf;
}

// The dot over DH of two rows split over TPR = DH / 64 neighbouring
// threads, each holding dims c * TPR + part (c < 64): every thread of the
// group gets the sum.
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: 64 threads a block, DH / 64 threads per key
// (dkdv) or query (dq), each holding 64 of its dims (interleaved) and
// running every loop (a group's shuffles need all its threads; an inactive
// row computes on zeros and writes nothing).
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 64;
constexpr int kF32QTile = 16;    // queries per shared-memory tile (dkdv, Dh 64)
constexpr int kF32KTile = 32;    // keys per shared-memory tile (dq, Dh 64)

template <int DH>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ g, float* __restrict__ dk,
    float* __restrict__ dv, int H, int S, int T_, float sm_scale) {
  constexpr int TPR = DH / 64, NK = kF32Threads / TPR, QT = kF32QTile / TPR;
  __shared__ float kr[NK][DH + 1];   // own rows, padded: no bank conflict
  __shared__ float vr[NK][DH + 1];
  __shared__ float qs_[QT][DH];
  __shared__ float gs[QT][DH];
  __shared__ float lse_s[QT], delta_s[QT];
  __shared__ int qc_s[QT], qsg_s[QT];

  const int bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, jl = tid / TPR, part = tid % TPR;
  const int j = blockIdx.x * NK + jl;
  const bool active = j < T_;
  const bool packed = qseg != nullptr;
  for (int idx = tid; idx < NK * DH; idx += kF32Threads) {
    const int r = idx / DH, d = idx % DH, jj = blockIdx.x * NK + r;
    kr[r][d] = jj < T_ ? k[((size_t)bh * T_ + jj) * DH + d] : 0.f;
    vr[r][d] = jj < T_ ? v[((size_t)bh * T_ + jj) * DH + d] : 0.f;
  }
  const int kc = active ? kcode[(size_t)b * T_ + j] : 0;
  const int ks = (active && packed) ? kseg[(size_t)b * T_ + j] : 0;

  float dka[64], dva[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) dka[c] = dva[c] = 0.f;

  for (int i0 = 0; i0 < S; i0 += QT) {
    const int n = min(QT, S - i0);
    __syncthreads();
    for (int idx = tid; idx < n * DH; idx += kF32Threads) {
      const size_t off = ((size_t)bh * S + i0) * DH + idx;
      qs_[idx / DH][idx % DH] = q[off];
      gs[idx / DH][idx % DH] = g[off];
    }
    if (tid < n) {
      lse_s[tid] = lse[(size_t)bh * S + i0 + tid];
      delta_s[tid] = delta[(size_t)bh * S + i0 + tid];
      qc_s[tid] = qcode[(size_t)b * S + i0 + tid];
      qsg_s[tid] = packed ? qseg[(size_t)b * S + i0 + tid] : 0;
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const int i = i0 + r;
      float sd = 0.f, gd = 0.f;
#pragma unroll
      for (int c = 0; c < 64; ++c) {
        const int d = c * TPR + part;
        sd += qs_[r][d] * kr[jl][d];
        gd += gs[r][d] * vr[jl][d];
      }
      sd = group_sum<TPR>(sd);
      gd = group_sum<TPR>(gd);
      const float s = masked(sd, kc, ks, qc_s[r], qsg_s[r], packed, add_diag,
                             i, j, sm_scale);
      const float p = expf(s - lse_s[r]);
      float pd = p, dp = gd;
      if (dr.thresh > 0) {
        const bool keep = vt::dropout_keep(dr, bh, i, j, S, T_);
        pd = keep ? p * dr.scale : 0.f;
        dp = keep ? gd * dr.scale : 0.f;
      }
      const float ds = p * (dp - delta_s[r]);
#pragma unroll
      for (int c = 0; c < 64; ++c) {
        dva[c] += pd * gs[r][c * TPR + part];
        dka[c] += ds * qs_[r][c * TPR + part];
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < 64; ++c) {
      const size_t o = ((size_t)bh * T_ + j) * DH + c * TPR + part;
      dk[o] = dka[c] * sm_scale;
      dv[o] = dva[c];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ g, float* __restrict__ dq, int H, int S,
    int T_, float sm_scale) {
  constexpr int TPR = DH / 64, NQ = kF32Threads / TPR, KT = kF32KTile / TPR;
  __shared__ float ks_[KT][DH];
  __shared__ float vs[KT][DH];
  __shared__ float gr[NQ][DH + 1];  // own g rows, padded
  __shared__ int kc_s[KT], ksg_s[KT];

  const int bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, il = tid / TPR, part = tid % TPR;
  const int i = blockIdx.x * NQ + il;
  const bool active = i < S;
  const bool packed = qseg != nullptr;
  float qr[64], acc[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) {
    const int d = c * TPR + part;
    qr[c] = active ? q[((size_t)bh * S + i) * DH + d] : 0.f;
    gr[il][d] = active ? g[((size_t)bh * S + i) * DH + d] : 0.f;
    acc[c] = 0.f;
  }
  const int qc = active ? qcode[(size_t)b * S + i] : 0;
  const int qsg = (active && packed) ? qseg[(size_t)b * S + i] : 0;
  const float lse_i = active ? lse[(size_t)bh * S + i] : 0.f;
  const float delta_i = active ? delta[(size_t)bh * S + i] : 0.f;

  for (int j0 = 0; j0 < T_; j0 += KT) {
    const int n = min(KT, T_ - j0);
    __syncthreads();
    for (int idx = tid; idx < n * DH; idx += kF32Threads) {
      const size_t off = ((size_t)bh * T_ + j0) * DH + idx;
      ks_[idx / DH][idx % DH] = k[off];
      vs[idx / DH][idx % DH] = v[off];
    }
    if (tid < n) {
      kc_s[tid] = kcode[(size_t)b * T_ + j0 + tid];
      ksg_s[tid] = packed ? kseg[(size_t)b * T_ + j0 + tid] : 0;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const int j = j0 + c;
      float sd = 0.f, gd = 0.f;
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int d = e * TPR + part;
        sd += qr[e] * ks_[c][d];
        gd += gr[il][d] * vs[c][d];
      }
      sd = group_sum<TPR>(sd);
      gd = group_sum<TPR>(gd);
      const float s = masked(sd, kc_s[c], ksg_s[c], qc, qsg, packed,
                             add_diag, i, j, sm_scale);
      const float p = expf(s - lse_i);
      float dp = gd;
      if (dr.thresh > 0)
        dp = vt::dropout_keep(dr, bh, i, j, S, T_) ? gd * dr.scale : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += ds * ks_[c][e * TPR + part];
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < 64; ++c)
      dq[((size_t)bh * S + i) * DH + c * TPR + part] = acc[c] * sm_scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one warpgroup (128 threads) per block. Thread
// (warp w, g = lane / 4, t = lane % 4) owns rows 16 w + g and 16 w + g + 8
// of the block's 64 (queries in dq, keys in dk/dv) and columns
// 8 j + 2 t (+1) of a 64-wide tile (hopper.cuh). Both kernels are held to
// 168 registers so that three blocks share an SM: with dropout they would
// take 179-186 and fit two, and the dropout backward at the AR training
// shape took 0.296 ms instead of 0.243 (H100 80GB HBM3, 700 W).
//
// Head dim 128: the score products (q k^T, g v^T and their transposes)
// run over the whole row, DH / 16 steps deep, but each block produces 64
// output columns, the half blockIdx.z of dq (or of dk and dv). So the
// accumulators stay those of Dh 64 (dk and dv of the whole row would need
// 128 fp32 registers a thread beside the scores), and the price is the
// score products computed once per half: 12 products of 64 x 64 x 64 a
// tile pair where one block would do 8.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kT = vt::kFlashTile;
constexpr int kStages = 2;
constexpr int kTB = vt::kSwTileBytes;

// Dynamic shared memory (1 KB of slack for the alignment): two own row
// blocks of DH / 64 tiles, kStages x two streamed row blocks, kStages x
// kRowInts per-row words of the streamed tile, the dropout bytes (4 warps
// x 1 KB), the tile list.
template <int DH>
struct BwdSmem {
  static constexpr int kRowTiles = DH / 64 * kTB;   // one row block
  static constexpr int kStreamOff = 2 * kRowTiles;
  static constexpr int kRowOff = kStreamOff + kStages * 2 * kRowTiles;
  static size_t bytes(int row_ints, int n_oth) {
    return 1024 + kRowOff + kStages * row_ints * 4 + 4 * 1024 +
           4 * ((n_oth + kT - 1) / kT + 1);
  }
};

// Blocks an SM: three at Dh 64 (~55 KB of shared memory each, registers
// held to 168); at Dh 128 ~105 KB a block leaves room for two only, so
// the cap is 255 registers.
template <int DH>
constexpr int kMinBlocks = DH == 64 ? 3 : 2;

template <bool kDrop, int DH>
__global__ void __launch_bounds__(128, kMinBlocks<DH>) flash_bwd_dq_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const bf16* __restrict__ out, const float* __restrict__ lse,
    const bf16* __restrict__ g, float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int S, int T_, float sm_scale) {
  using L = BwdSmem<DH>;
  constexpr int kRowInts = 2 * kT;   // kcode, kseg
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = vt::align1024(smem_raw);
  const uint32_t q_s = vt::smem_addr(sm), g_s = q_s + L::kRowTiles;
  const uint32_t kv_s = vt::smem_addr(sm + L::kStreamOff);
  int* codes = reinterpret_cast<int*>(sm + L::kRowOff);
  uint8_t* drop = sm + L::kRowOff + kStages * kRowInts * 4;
  int* list = reinterpret_cast<int*>(drop + 4 * 1024);
  float* delta_s = reinterpret_cast<float*>(sm + L::kRowOff);  // before ring

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int half = DH == 64 ? 0 : blockIdx.z;   // the column half of dq
  const int i0 = blockIdx.x * kT;
  const int rows[2] = {i0 + warp * 16 + g8, i0 + warp * 16 + g8 + 8};
  const bool packed = qseg != nullptr;
  const int* qc_b = qcode + (size_t)b * S;
  const int* kc_b = kcode + (size_t)b * T_;
  const int* qs_b = packed ? qseg + (size_t)b * S : nullptr;
  const int* ks_b = packed ? kseg + (size_t)b * T_ : nullptr;
  const bf16* kb = k + (size_t)bh * T_ * DH;
  const bf16* vb = v + (size_t)bh * T_ * DH;

  vt::load_rows_sw128<DH>(q_s, q + ((size_t)bh * S + i0) * DH, S - i0, tid,
                          DH);
  vt::load_rows_sw128<DH>(g_s, g + ((size_t)bh * S + i0) * DH, S - i0, tid,
                          DH);
  vt::cp_async_commit();

  // delta of the block's rows: two threads a row, DH / 2 values each
  {
    const int r = tid >> 1, hf = tid & 1, i = i0 + r;
    float sum = 0.f;
    if (i < S) {
      const uint4* op = reinterpret_cast<const uint4*>(
          out + ((size_t)bh * S + i) * DH + hf * (DH / 2));
      const uint4* gp = reinterpret_cast<const uint4*>(
          g + ((size_t)bh * S + i) * DH + hf * (DH / 2));
#pragma unroll
      for (int c = 0; c < DH / 16; ++c) {
        const uint4 a = op[c], bb = gp[c];
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t bw[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 af = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
          const float2 bf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
          sum += af.x * bf.x + af.y * bf.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (hf == 0) {
      delta_s[r] = sum;
      if (i < S && half == 0) delta[(size_t)bh * S + i] = sum;
    }
  }
  if (warp == 0)
    vt::build_tile_list(list, true, qc_b, qs_b, i0, S, kc_b, ks_b, T_,
                        add_diag, lane);
  __syncthreads();
  int qc[2], qsg[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < S;
    qc[h] = ok ? qc_b[rows[h]] : -1;
    qsg[h] = (ok && packed) ? qs_b[rows[h]] : 0;
    lse_r[h] = ok ? lse[(size_t)bh * S + rows[h]] : 0.f;
    delta_r[h] = delta_s[warp * 16 + g8 + 8 * h];
  }
  __syncthreads();   // delta_s shares its space with the ring's codes

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int nv = list[0];
  auto issue = [&](int n) {
    if (n < nv) {
      const int st = n % kStages, j0 = list[1 + n] * kT, nk = T_ - j0;
      const uint32_t ks = kv_s + st * 2 * L::kRowTiles;
      vt::load_rows_sw128<DH>(ks, kb + (size_t)j0 * DH, nk, tid, DH);
      vt::load_rows_sw128<DH>(ks + L::kRowTiles, vb + (size_t)j0 * DH, nk,
                              tid, DH);
      const int c = tid & (kT - 1);
      const bool ok = c < nk;
      if (tid < kT)
        vt::cp_async4(vt::smem_addr(codes + st * kRowInts + c),
                      kc_b + (ok ? j0 + c : 0), ok);
      else if (packed)
        vt::cp_async4(vt::smem_addr(codes + st * kRowInts + kT + c),
                      ks_b + (ok ? j0 + c : 0), ok);
    }
    vt::cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < nv; ++n) {
    vt::cp_async_wait<kStages - 2>();
    vt::fence_proxy_async();
    __syncthreads();
    issue(n + kStages - 1);
    const int st = n % kStages, j0 = list[1 + n] * kT;
    const uint32_t ks = kv_s + st * 2 * L::kRowTiles;
    const int* kcs = codes + st * kRowInts;

    float s[32], dp[32];
    vt::wgmma_fence();
    vt::wgmma_rows_ss<DH>(s, q_s, ks);
    vt::wgmma_rows_ss<DH>(dp, g_s, ks + L::kRowTiles);
    vt::wgmma_commit();
    uint8_t* buf = drop + warp * 1024;
    if (kDrop)
      vt::stage_row_bytes(buf, dr, bh, i0 + warp * 16, j0 / 16, S, T_, lane);
    vt::wgmma_wait<0>();
    vt::fence_regs(s);
    vt::fence_regs(dp);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int2 kc2 = *reinterpret_cast<const int2*>(kcs + c);
      const int2 ks2 = packed ? *reinterpret_cast<const int2*>(kcs + kT + c)
                              : make_int2(0, 0);
      uint2 w = make_uint2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, e1 = e & 1, key = j0 + c + e1;
        const bool vis = vt::visible(qc[h], qsg[h], e1 ? kc2.y : kc2.x,
                                 e1 ? ks2.y : ks2.x, packed, add_diag,
                                 rows[h], key);
        const float sv = vis ? s[4 * j + e] * sm_scale : kNegInf;
        const float p = key < T_ ? __expf(sv - lse_r[h]) : 0.f;
        float y = dp[4 * j + e];
        if (kDrop) {
          if (e1 == 0) w = vt::row_bytes(buf, g8 + 8 * h, j >> 1, t);
          const uint32_t word = (j & 1) ? w.y : w.x;
          const int byte = (word >> (16 * (t & 1) + 8 * e1)) & 255;
          y = byte >= dr.thresh ? y * dr.scale : 0.f;
        }
        s[4 * j + e] = p * (y - delta_r[h]);
      }
    }
    uint32_t a[4][4];
    vt::pack_a(a, s);
    vt::fence_regs(acc);
    vt::wgmma_fence();
    vt::wgmma_tile_rs_t(acc, a, ks + half * kTB);
    vt::wgmma_commit();
    vt::wgmma_wait<0>();
    vt::fence_regs(acc);
  }
  vt::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] < S) {
      bf16* op = dq + ((size_t)bh * S + rows[h]) * DH + half * 64;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + t * 2) = vt::pack_bf16(
            acc[4 * d + 2 * h] * sm_scale, acc[4 * d + 2 * h + 1] * sm_scale);
    }
  }
}

template <bool kDrop, int DH>
__global__ void __launch_bounds__(128, kMinBlocks<DH>) flash_bwd_dkdv_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ g, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int S, int T_, float sm_scale) {
  using L = BwdSmem<DH>;
  constexpr int kRowInts = 4 * kT;   // lse, delta, qcode, qseg
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = vt::align1024(smem_raw);
  const uint32_t k_s = vt::smem_addr(sm), v_s = k_s + L::kRowTiles;
  const uint32_t qg_s = vt::smem_addr(sm + L::kStreamOff);
  int* rowv = reinterpret_cast<int*>(sm + L::kRowOff);
  uint8_t* drop = sm + L::kRowOff + kStages * kRowInts * 4;
  int* list = reinterpret_cast<int*>(drop + 4 * 1024);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int half = DH == 64 ? 0 : blockIdx.z;   // the column half of dk, dv
  const int j0 = blockIdx.x * kT;
  const int key0 = j0 + warp * 16;
  const int keys[2] = {key0 + g8, key0 + g8 + 8};
  const bool packed = qseg != nullptr;
  const int* qc_b = qcode + (size_t)b * S;
  const int* kc_b = kcode + (size_t)b * T_;
  const int* qs_b = packed ? qseg + (size_t)b * S : nullptr;
  const int* ks_b = packed ? kseg + (size_t)b * T_ : nullptr;
  const bf16* qb = q + (size_t)bh * S * DH;
  const bf16* gb = g + (size_t)bh * S * DH;

  vt::load_rows_sw128<DH>(k_s, k + ((size_t)bh * T_ + j0) * DH, T_ - j0, tid,
                          DH);
  vt::load_rows_sw128<DH>(v_s, v + ((size_t)bh * T_ + j0) * DH, T_ - j0, tid,
                          DH);
  vt::cp_async_commit();
  int kc[2], ksg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = keys[h] < T_;
    kc[h] = ok ? kc_b[keys[h]] : 0;
    ksg[h] = (ok && packed) ? ks_b[keys[h]] : 0;
  }
  if (warp == 0)
    vt::build_tile_list(list, false, kc_b, ks_b, j0, T_, qc_b, qs_b, S,
                        add_diag, lane);
  __syncthreads();

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  const int nv = list[0];
  auto issue = [&](int n) {
    if (n < nv) {
      const int st = n % kStages, i0 = list[1 + n] * kT, nq = S - i0;
      const uint32_t qs = qg_s + st * 2 * L::kRowTiles;
      vt::load_rows_sw128<DH>(qs, qb + (size_t)i0 * DH, nq, tid, DH);
      vt::load_rows_sw128<DH>(qs + L::kRowTiles, gb + (size_t)i0 * DH, nq,
                              tid, DH);
      int* rv = rowv + st * kRowInts;
      const int c = tid & (kT - 1);
      const bool ok = c < nq;
      const size_t src = ok ? (size_t)bh * S + i0 + c : 0;
      if (tid < kT) {
        vt::cp_async4(vt::smem_addr(rv + c), lse + src, ok);
        vt::cp_async4(vt::smem_addr(rv + kT + c), delta + src, ok);
      } else {
        vt::cp_async4(vt::smem_addr(rv + 2 * kT + c),
                      qc_b + (ok ? i0 + c : 0), ok);
        if (packed)
          vt::cp_async4(vt::smem_addr(rv + 3 * kT + c),
                        qs_b + (ok ? i0 + c : 0), ok);
      }
    }
    vt::cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < nv; ++n) {
    vt::cp_async_wait<kStages - 2>();
    vt::fence_proxy_async();
    __syncthreads();
    issue(n + kStages - 1);
    const int st = n % kStages, i0 = list[1 + n] * kT;
    const uint32_t qs = qg_s + st * 2 * L::kRowTiles;
    const int* rv = rowv + st * kRowInts;
    const float* lse_s = reinterpret_cast<const float*>(rv);
    const float* delta_s = lse_s + kT;

    float sT[32], dpT[32];   // rows = keys, columns = the tile's queries
    vt::wgmma_fence();
    vt::wgmma_rows_ss<DH>(sT, k_s, qs);
    vt::wgmma_rows_ss<DH>(dpT, v_s, qs + L::kRowTiles);
    vt::wgmma_commit();
    uint8_t* buf = drop + warp * 1024;
    if (kDrop)
      vt::stage_key_bytes(buf, dr, bh, i0, key0 / 16, S, T_, lane);
    vt::wgmma_wait<0>();
    vt::fence_regs(sT);
    vt::fence_regs(dpT);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int c = 8 * j + 2 * t + e1, qi = i0 + c;
        const float lse_c = lse_s[c], delta_c = delta_s[c];
        const int qc_c = rv[2 * kT + c];
        const int qs_c = packed ? rv[3 * kT + c] : 0;
        uint2 w = make_uint2(0, 0);
        if (kDrop) w = vt::key_bytes(buf, c, g8);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + e1;
          const bool vis = vt::visible(qc_c, qs_c, kc[h], ksg[h], packed,
                                   add_diag, qi, keys[h]);
          const float sv = vis ? sT[4 * j + e] * sm_scale : kNegInf;
          const float p = qi < S ? __expf(sv - lse_c) : 0.f;
          float pd = p, y = dpT[4 * j + e];
          if (kDrop) {
            const int byte = ((h ? w.y : w.x) >> (8 * (g8 & 3))) & 255;
            const bool keep = byte >= dr.thresh;
            pd = keep ? p * dr.scale : 0.f;
            y = keep ? y * dr.scale : 0.f;
          }
          sT[4 * j + e] = pd;
          dpT[4 * j + e] = p * (y - delta_c);
        }
      }
    }
    uint32_t apd[4][4], ads[4][4];
    vt::pack_a(apd, sT);
    vt::pack_a(ads, dpT);
    vt::fence_regs(dva);
    vt::fence_regs(dka);
    vt::wgmma_fence();
    vt::wgmma_tile_rs_t(dva, apd, qs + L::kRowTiles + half * kTB);
    vt::wgmma_tile_rs_t(dka, ads, qs + half * kTB);
    vt::wgmma_commit();
    vt::wgmma_wait<0>();
    vt::fence_regs(dva);
    vt::fence_regs(dka);
  }
  vt::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] < T_) {
      const size_t row = ((size_t)bh * T_ + keys[h]) * DH + half * 64;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        *reinterpret_cast<uint32_t*>(dk + row + d * 8 + t * 2) = vt::pack_bf16(
            dka[4 * d + 2 * h] * sm_scale, dka[4 * d + 2 * h + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + row + d * 8 + t * 2) =
            vt::pack_bf16(dva[4 * d + 2 * h], dva[4 * d + 2 * h + 1]);
      }
    }
  }
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qcode, const int* kcode, const int* qseg,
           const int* kseg, int add_diag, const Dropout& dr, const void* out,
           const float* lse, const void* g, float* delta, void* dq, void* dk,
           void* dv, int B, int H, int S, int T_, float sm_scale,
           cudaStream_t s) {
  if (dtype == vt::kF32) {
    constexpr int TPR = DH / 64;
    const int rows = B * H * S;
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    flash_bwd_delta_kernel<DH><<<(rows + 3) / 4, 128, 0, s>>>(
        f(out), f(g), delta, rows);
    flash_bwd_dq_f32<DH><<<dim3((S * TPR + kF32Threads - 1) / kF32Threads,
                                B * H),
                           kF32Threads, 0, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<float*>(dq), H, S, T_, sm_scale);
    flash_bwd_dkdv_f32<DH><<<dim3((T_ * TPR + kF32Threads - 1) / kF32Threads,
                                  B * H),
                             kF32Threads, 0, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<float*>(dk), static_cast<float*>(dv), H, S, T_,
        sm_scale);
    return cudaGetLastError();
  }
  if (dtype == vt::kBF16) {
    using L = BwdSmem<DH>;
    auto f = [](const void* p) { return static_cast<const bf16*>(p); };
    const bool drop = dr.thresh > 0;
    // dq first: it writes delta, which dk/dv reads
    auto dq_k = drop ? flash_bwd_dq_wgmma<true, DH>
                     : flash_bwd_dq_wgmma<false, DH>;
    const size_t dq_smem = L::bytes(2 * kT, T_);
    if (int rc = vt::allow_smem(dq_k, dq_smem)) return rc;
    dq_k<<<dim3((S + kT - 1) / kT, B * H, DH / 64), 128, dq_smem, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, f(out), lse,
        f(g), delta, static_cast<bf16*>(dq), H, S, T_, sm_scale);
    if (int rc = cudaGetLastError()) return rc;
    auto kv_k = drop ? flash_bwd_dkdv_wgmma<true, DH>
                     : flash_bwd_dkdv_wgmma<false, DH>;
    const size_t kv_smem = L::bytes(4 * kT, S);
    if (int rc = vt::allow_smem(kv_k, kv_smem)) return rc;
    kv_k<<<dim3((T_ + kT - 1) / kT, B * H, DH / 64), 128, kv_smem, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, T_,
        sm_scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int vt_flash_bwd(int dtype, int dh, const void* q, const void* k,
                            const void* v, const int* qcode, const int* kcode,
                            const int* qseg, const int* kseg, int add_diag,
                            int thresh, float drop_scale,
                            unsigned long long seed, const uint8_t* bits,
                            const void* out, const float* lse, const void* g,
                            float* delta, void* dq, void* dk, void* dv, int B,
                            int H, int S, int T_, float sm_scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout dr{thresh, drop_scale, (uint32_t)(seed & 0xffffffffull),
                   (uint32_t)(seed >> 32), bits};
  if (dh == 64)
    return launch<64>(dtype, q, k, v, qcode, kcode, qseg, kseg, add_diag, dr,
                      out, lse, g, delta, dq, dk, dv, B, H, S, T_, sm_scale,
                      s);
  if (dh == 128)
    return launch<128>(dtype, q, k, v, qcode, kcode, qseg, kseg, add_diag,
                       dr, out, lse, g, delta, dq, dk, dv, B, H, S, T_,
                       sm_scale, s);
  return cudaErrorInvalidValue;
}
