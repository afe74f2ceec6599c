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
// 471, Dh = 64) the work is 5 products of 2*S*T*Dh per (b, h): 36.3 GFLOP,
// 37 us of bf16 tensor-core time, and it moves ~123 MB (q, k, v, out, g,
// dq, dk, dv, lse): 37 us of HBM time. The TPU kernel walks the q-blocks of
// one (b, h) in order and keeps dk/dv in VMEM scratch across them; Hopper
// blocks run in no order, so the work splits into three launches:
//
// - flash_bwd_delta_kernel: delta = rowsum(out * g) in fp32, one warp per
//   row.
// - flash_bwd_dkdv_*: one block per (b, h, tile of 64 keys) loops over all
//   query tiles with dk and dv in registers (fp32); each key's sums are
//   owned by one thread, so no atomics.
// - flash_bwd_dq_*: one block per (b, h, tile of 64 queries) loops over all
//   key tiles with dq in registers. Recomputing P and dP^T twice (once per
//   kernel) costs more operations than fp32 atomics on dq would, but the
//   result is deterministic.
//
// bf16 (the main path) runs on the tensor cores with mma.sync m16n8k16
// (helpers in common.cuh): in the dkdv kernel each warp owns 16 keys and
// computes S^T = k q^T and dP^T = v g^T, so the score accumulators are the
// A operand of dv += Pd^T g and dk += dS^T q directly. fp32 (the
// verification path) runs on the CUDA cores, one thread per key (dkdv) or
// per query (dq). Ragged S/T edges are masked in the kernels.
//
// Not yet used: wgmma, TMA, a single kernel with dq atomics.

#include <math.h>

#include "common.cuh"

namespace {

using vt::Dropout;
using vt::kNegInf;
using vt::to_f;

template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ g,
    float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + (size_t)row * 64;
  const T* gg = g + (size_t)row * 64;
  float s = to_f(o[lane]) * to_f(gg[lane]) +
            to_f(o[lane + 32]) * to_f(gg[lane + 32]);
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

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;     // keys (threads) per dkdv block
constexpr int kF32QTile = 16;    // queries per shared-memory tile (dkdv)
constexpr int kF32Queries = 64;  // queries (threads) per dq block
constexpr int kF32KTile = 32;    // keys per shared-memory tile (dq)

__global__ void __launch_bounds__(kF32Keys) flash_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ g, float* __restrict__ dk,
    float* __restrict__ dv, int H, int S, int T_, float sm_scale) {
  __shared__ float kr[kF32Keys][65];   // own rows, padded: no bank conflict
  __shared__ float vr[kF32Keys][65];
  __shared__ float qs_[kF32QTile][64];
  __shared__ float gs[kF32QTile][64];
  __shared__ float lse_s[kF32QTile], delta_s[kF32QTile];
  __shared__ int qc_s[kF32QTile], qsg_s[kF32QTile];

  const int bh = blockIdx.y, b = bh / H;
  const int jl = threadIdx.x;
  const int j = blockIdx.x * kF32Keys + jl;
  const bool active = j < T_;
  const bool packed = qseg != nullptr;
  for (int d = 0; d < 64; ++d) {
    kr[jl][d] = active ? k[((size_t)bh * T_ + j) * 64 + d] : 0.f;
    vr[jl][d] = active ? v[((size_t)bh * T_ + j) * 64 + d] : 0.f;
  }
  const int kc = active ? kcode[(size_t)b * T_ + j] : 0;
  const int ks = (active && packed) ? kseg[(size_t)b * T_ + j] : 0;

  float dka[64], dva[64];
#pragma unroll
  for (int d = 0; d < 64; ++d) dka[d] = dva[d] = 0.f;

  for (int i0 = 0; i0 < S; i0 += kF32QTile) {
    const int n = min(kF32QTile, S - i0);
    __syncthreads();
    for (int idx = jl; idx < n * 64; idx += kF32Keys) {
      const size_t off = ((size_t)bh * S + i0) * 64 + idx;
      qs_[idx / 64][idx % 64] = q[off];
      gs[idx / 64][idx % 64] = g[off];
    }
    if (jl < n) {
      lse_s[jl] = lse[(size_t)bh * S + i0 + jl];
      delta_s[jl] = delta[(size_t)bh * S + i0 + jl];
      qc_s[jl] = qcode[(size_t)b * S + i0 + jl];
      qsg_s[jl] = packed ? qseg[(size_t)b * S + i0 + jl] : 0;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < n; ++r) {
      const int i = i0 + r;
      float sd = 0.f, gd = 0.f;
#pragma unroll
      for (int d = 0; d < 64; ++d) {
        sd += qs_[r][d] * kr[jl][d];
        gd += gs[r][d] * vr[jl][d];
      }
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
      for (int d = 0; d < 64; ++d) {
        dva[d] += pd * gs[r][d];
        dka[d] += ds * qs_[r][d];
      }
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < 64; ++d) {
      dk[((size_t)bh * T_ + j) * 64 + d] = dka[d] * sm_scale;
      dv[((size_t)bh * T_ + j) * 64 + d] = dva[d];
    }
  }
}

__global__ void __launch_bounds__(kF32Queries) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ g, float* __restrict__ dq, int H, int S,
    int T_, float sm_scale) {
  __shared__ float ks_[kF32KTile][64];
  __shared__ float vs[kF32KTile][64];
  __shared__ float gr[kF32Queries][65];  // own g rows, padded
  __shared__ int kc_s[kF32KTile], ksg_s[kF32KTile];

  const int bh = blockIdx.y, b = bh / H;
  const int il = threadIdx.x;
  const int i = blockIdx.x * kF32Queries + il;
  const bool active = i < S;
  const bool packed = qseg != nullptr;
  float qr[64], acc[64];
#pragma unroll
  for (int d = 0; d < 64; ++d) {
    qr[d] = active ? q[((size_t)bh * S + i) * 64 + d] : 0.f;
    gr[il][d] = active ? g[((size_t)bh * S + i) * 64 + d] : 0.f;
    acc[d] = 0.f;
  }
  const int qc = active ? qcode[(size_t)b * S + i] : 0;
  const int qsg = (active && packed) ? qseg[(size_t)b * S + i] : 0;
  const float lse_i = active ? lse[(size_t)bh * S + i] : 0.f;
  const float delta_i = active ? delta[(size_t)bh * S + i] : 0.f;

  for (int j0 = 0; j0 < T_; j0 += kF32KTile) {
    const int n = min(kF32KTile, T_ - j0);
    __syncthreads();
    for (int idx = il; idx < n * 64; idx += kF32Queries) {
      const size_t off = ((size_t)bh * T_ + j0) * 64 + idx;
      ks_[idx / 64][idx % 64] = k[off];
      vs[idx / 64][idx % 64] = v[off];
    }
    if (il < n) {
      kc_s[il] = kcode[(size_t)b * T_ + j0 + il];
      ksg_s[il] = packed ? kseg[(size_t)b * T_ + j0 + il] : 0;
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < n; ++c) {
      const int j = j0 + c;
      float sd = 0.f, gd = 0.f;
#pragma unroll
      for (int d = 0; d < 64; ++d) {
        sd += qr[d] * ks_[c][d];
        gd += gr[il][d] * vs[c][d];
      }
      const float s = masked(sd, kc_s[c], ksg_s[c], qc, qsg, packed,
                             add_diag, i, j, sm_scale);
      const float p = expf(s - lse_i);
      float dp = gd;
      if (dr.thresh > 0)
        dp = vt::dropout_keep(dr, bh, i, j, S, T_) ? gd * dr.scale : 0.f;
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int d = 0; d < 64; ++d) acc[d] += ds * ks_[c][d];
    }
  }
  if (active) {
#pragma unroll
    for (int d = 0; d < 64; ++d)
      dq[((size_t)bh * S + i) * 64 + d] = acc[d] * sm_scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: 4 warps x 16 rows, tiles of 64 (common.cuh
// layouts: thread (g, t) holds rows g and g + 8 of its warp's 16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;

// 64 rows x 64 Dh of src (rows r0.., n valid) into shared memory, zeros
// past n; plus the rows' codes (and segments).
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* src,
                                            int n) {
  for (int i = threadIdx.x; i < kTile * 64 / 8; i += 128)
    reinterpret_cast<uint4*>(dst)[i] =
        i / 8 < n ? reinterpret_cast<const uint4*>(src)[i]
                  : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(128) flash_bwd_dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ g, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int H, int S, int T_, float sm_scale) {
  __shared__ __align__(16) bf16 qs_[kTile * 64];
  __shared__ __align__(16) bf16 gs[kTile * 64];
  __shared__ float lse_s[kTile], delta_s[kTile];
  __shared__ int qc_s[kTile], qsg_s[kTile];
  __shared__ __align__(16) uint8_t keep_bytes[4][kTile * 16];

  const int bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const bool packed = qseg != nullptr;
  const int key0 = blockIdx.x * kTile + warp * 16;
  const int keys[2] = {key0 + g8, key0 + g8 + 8};

  uint4 kf[2][2], vf[2][2];
  vt::load_rows64(kf, k + ((size_t)bh * T_ + keys[0]) * 64, keys[0] < T_,
                  k + ((size_t)bh * T_ + keys[1]) * 64, keys[1] < T_, t);
  vt::load_rows64(vf, v + ((size_t)bh * T_ + keys[0]) * 64, keys[0] < T_,
                  v + ((size_t)bh * T_ + keys[1]) * 64, keys[1] < T_, t);
  int kc[2], ksg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = keys[h] < T_;
    kc[h] = ok ? kcode[(size_t)b * T_ + keys[h]] : 0;
    ksg[h] = (ok && packed) ? kseg[(size_t)b * T_ + keys[h]] : 0;
  }
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  uint8_t* kb8 = keep_bytes[warp];

  for (int i0 = 0; i0 < S; i0 += kTile) {
    const int n = min(kTile, S - i0);
    __syncthreads();
    load_tile64(qs_, q + ((size_t)bh * S + i0) * 64, n);
    load_tile64(gs, g + ((size_t)bh * S + i0) * 64, n);
    for (int r = threadIdx.x; r < kTile; r += 128) {
      const bool ok = r < n;
      lse_s[r] = ok ? lse[(size_t)bh * S + i0 + r] : 0.f;
      delta_s[r] = ok ? delta[(size_t)bh * S + i0 + r] : 0.f;
      qc_s[r] = ok ? qcode[(size_t)b * S + i0 + r] : 0;
      qsg_s[r] = (ok && packed) ? qseg[(size_t)b * S + i0 + r] : 0;
    }
    __syncthreads();
    if (dr.thresh > 0)   // bytes of the tile's 64 queries x the warp's keys
      vt::fill_bytes(kb8, kTile, 1, i0, key0 / 16, dr, bh, S, T_, lane);

    // P^T and dP^T: rows = this thread's keys, columns = queries
    float p[8][4], dp[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[jt][e] = dp[jt][e] = 0.f;
      vt::mma_dot64(p[jt], kf, qs_ + (jt * 8 + g8) * 64, t);
      vt::mma_dot64(dp[jt], vf, gs + (jt * 8 + g8) * 64, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = jt * 8 + t * 2 + (e & 1);   // query in the tile
        const int h = e >> 1;                      // key half
        const bool valid = r < n && keys[h] < T_;
        const float s = masked(p[jt][e], kc[h], ksg[h], qc_s[r], qsg_s[r],
                               packed, add_diag, i0 + r, keys[h], sm_scale);
        p[jt][e] = valid ? expf(s - lse_s[r]) : 0.f;
      }
    }
    // dv += Pd^T g (Pd rounded to bf16 at the pack), then dS^T in place
    float pd[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = jt * 8 + t * 2 + (e & 1);
        float x = p[jt][e], y = dp[jt][e];
        if (dr.thresh > 0) {
          const bool keep = kb8[r * 16 + g8 + 8 * (e >> 1)] >= dr.thresh;
          x = keep ? x * dr.scale : 0.f;
          y = keep ? y * dr.scale : 0.f;
        }
        pd[jt][e] = x;
        dp[jt][e] = p[jt][e] * (y - delta_s[r]);
      }
    vt::mma_pm64(dva, pd, gs, g8, t);
    vt::mma_pm64(dka, dp, qs_, g8, t);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] < T_) {
      const size_t row = ((size_t)bh * T_ + keys[h]) * 64;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        *reinterpret_cast<uint32_t*>(dk + row + d * 8 + t * 2) = vt::pack_bf16(
            dka[d][2 * h] * sm_scale, dka[d][2 * h + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + row + d * 8 + t * 2) =
            vt::pack_bf16(dva[d][2 * h], dva[d][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(128) flash_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const bf16* __restrict__ g, bf16* __restrict__ dq, int H, int S, int T_,
    float sm_scale) {
  __shared__ __align__(16) bf16 ks_[kTile * 64];
  __shared__ __align__(16) bf16 vs[kTile * 64];
  __shared__ int kc_s[kTile], ksg_s[kTile];
  __shared__ __align__(16) uint8_t keep_bytes[4][16 * kTile];

  const int bh = blockIdx.y, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t = lane & 3;
  const bool packed = qseg != nullptr;
  const int row0 = blockIdx.x * kTile + warp * 16;
  const int rows[2] = {row0 + g8, row0 + g8 + 8};

  uint4 qf[2][2], gf[2][2];
  vt::load_rows64(qf, q + ((size_t)bh * S + rows[0]) * 64, rows[0] < S,
                  q + ((size_t)bh * S + rows[1]) * 64, rows[1] < S, t);
  vt::load_rows64(gf, g + ((size_t)bh * S + rows[0]) * 64, rows[0] < S,
                  g + ((size_t)bh * S + rows[1]) * 64, rows[1] < S, t);
  int qc[2], qsg[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < S;
    qc[h] = ok ? qcode[(size_t)b * S + rows[h]] : 0;
    qsg[h] = (ok && packed) ? qseg[(size_t)b * S + rows[h]] : 0;
    lse_r[h] = ok ? lse[(size_t)bh * S + rows[h]] : 0.f;
    delta_r[h] = ok ? delta[(size_t)bh * S + rows[h]] : 0.f;
  }
  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  uint8_t* kb8 = keep_bytes[warp];

  for (int j0 = 0; j0 < T_; j0 += kTile) {
    const int n = min(kTile, T_ - j0);
    __syncthreads();
    load_tile64(ks_, k + ((size_t)bh * T_ + j0) * 64, n);
    load_tile64(vs, v + ((size_t)bh * T_ + j0) * 64, n);
    for (int c = threadIdx.x; c < kTile; c += 128) {
      kc_s[c] = c < n ? kcode[(size_t)b * T_ + j0 + c] : 0;
      ksg_s[c] = (c < n && packed) ? kseg[(size_t)b * T_ + j0 + c] : 0;
    }
    __syncthreads();
    if (dr.thresh > 0)
      vt::fill_bytes(kb8, 16, kTile / 16, row0, j0 / 16, dr, bh, S, T_, lane);

    float ds[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[jt][e] = 0.f;
      vt::mma_dot64(s, qf, ks_ + (jt * 8 + g8) * 64, t);
      vt::mma_dot64(ds[jt], gf, vs + (jt * 8 + g8) * 64, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = jt * 8 + t * 2 + (e & 1);   // key in the tile
        const int h = e >> 1;
        const float sm = masked(s[e], kc_s[c], ksg_s[c], qc[h], qsg[h],
                                packed, add_diag, rows[h], j0 + c, sm_scale);
        const float p = c < n ? expf(sm - lse_r[h]) : 0.f;
        float y = ds[jt][e];
        if (dr.thresh > 0)
          y = kb8[(g8 + 8 * h) * kTile + c] >= dr.thresh ? y * dr.scale : 0.f;
        ds[jt][e] = p * (y - delta_r[h]);
      }
    }
    vt::mma_pm64(acc, ds, ks_, g8, t);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] < S) {
      bf16* op = dq + ((size_t)bh * S + rows[h]) * 64;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + t * 2) = vt::pack_bf16(
            acc[d][2 * h] * sm_scale, acc[d][2 * h + 1] * sm_scale);
    }
  }
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
  if (dh != 64) return cudaErrorInvalidValue;
  const Dropout dr{thresh, drop_scale, (uint32_t)(seed & 0xffffffffull),
                   (uint32_t)(seed >> 32), bits};
  const int rows = B * H * S;
  const dim3 dgrid((rows + 3) / 4);
  if (dtype == vt::kF32) {
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    flash_bwd_delta_kernel<float><<<dgrid, 128, 0, s>>>(f(out), f(g), delta,
                                                        rows);
    flash_bwd_dq_f32<<<dim3((S + kF32Queries - 1) / kF32Queries, B * H),
                       kF32Queries, 0, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<float*>(dq), H, S, T_, sm_scale);
    flash_bwd_dkdv_f32<<<dim3((T_ + kF32Keys - 1) / kF32Keys, B * H),
                         kF32Keys, 0, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<float*>(dk), static_cast<float*>(dv), H, S, T_,
        sm_scale);
    return cudaGetLastError();
  }
  if (dtype == vt::kBF16) {
    auto f = [](const void* p) { return static_cast<const bf16*>(p); };
    flash_bwd_delta_kernel<bf16><<<dgrid, 128, 0, s>>>(f(out), f(g), delta,
                                                       rows);
    flash_bwd_dq_mma<<<dim3((S + kTile - 1) / kTile, B * H), 128, 0, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<bf16*>(dq), H, S, T_, sm_scale);
    flash_bwd_dkdv_mma<<<dim3((T_ + kTile - 1) / kTile, B * H), 128, 0, s>>>(
        f(q), f(k), f(v), qcode, kcode, qseg, kseg, add_diag, dr, lse, delta,
        f(g), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, T_,
        sm_scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
