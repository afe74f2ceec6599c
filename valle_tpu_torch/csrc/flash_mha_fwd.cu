// Exact softmax attention with the mask rebuilt from int32 codes and
// dropout on the probabilities: the port of the TPU kernel
// valle_tpu/ops/flash_mha.py:_fwd_kernel (the forward of flash_mha_train,
// reached through _pallas_fwd).
//
// visible(i, j) = kcode[j] <= qcode[i]  (and qseg[i] == kseg[j] when
// segments are given)  (or i == j under add_diag). Masked scores take the
// finite NEG_INF = -1e30 of flash_mha.py:66, so a fully masked row stays
// finite and uniform. The output is dropout(softmax(q k^T / sqrt(Dh))) v in
// q's dtype, plus the log-sum-exp (B, H, S) in fp32 for the backward.
//
// Dropout keeps JAX's order (flash_mha.py:143-154): l = sum_j exp(s - m) is
// taken BEFORE the drop; a kept p is scaled by 1 / (1 - thresh / 256); then
// p / l is rounded to v's dtype before P.V. keep(i, j) = byte >= thresh,
// the byte from the in-kernel Philox4x32-10 (common.cuh) or from an
// explicit bits tensor. The TPU draws from its hardware PRNG, which cannot
// be replayed; Philox can, so the plain version (ops/philox.py) and the
// backward regenerate the same mask bit for bit.
//
// What bounds it on the H100: at the training shapes (B*H = 256, S = T =
// 471, Dh = 64) the work is ~4*B*H*S*T*Dh = 14.5 GFLOP over 61.7 MB of
// q/k/v/o: 14.7 us of bf16 tensor-core time against 18.4 us of HBM time,
// so bytes bound it; the score matrix (B, H, S, T) is what must never
// reach device memory. The TPU kernel held a whole key row in VMEM; a
// Hopper block cannot, so:
//
// - Dh = 64 only (16 heads at d_model 1024).
// - bf16 (the main path) runs flash_fwd_mma_kernel on the tensor cores:
//   one block per (b, h, tile of 64 queries), 4 warps of 16 query rows,
//   key tiles of 64 through shared memory, mma.sync m16n8k16 with fp32
//   accumulation for both q.k and P.V. With dropout each warp fills a
//   16 x 64 byte tile in shared memory per key tile (one Philox call per
//   16 keys of a row, 2 per lane) before it forms P.
// - fp32 (the verification path) runs flash_fwd_kernel on the CUDA cores:
//   one thread per query row, its q row and output row in registers,
//   every thread reading the same key row (a shared-memory broadcast).
// - Both make two passes over the keys. Pass 1 finds each row's max and
//   sum of exp with an online update. Pass 2 recomputes each score, forms
//   p / l (dropped and rescaled) and rounds it to v's dtype before the
//   P.V product, so the result follows the TPU kernel's order of rounding,
//   not only its math.
// - The kernels mask the ragged edges themselves (queries past S, keys
//   past T) instead of padding copies in device memory
//   (flash_mha.py:408-424).
//
// Not yet used: a single online pass, TMA, wgmma, warp specialisation.

#include <math.h>

#include "common.cuh"

namespace {

using vt::Dropout;
using vt::from_f;
using vt::kNegInf;
using vt::round_to;
using vt::to_f;

constexpr int kBQ = 64;          // queries (threads) per block
constexpr int kTileFloats = 4096;  // K (and V) tile: kTileFloats / Dh keys

template <typename T, int DH>
__global__ void __launch_bounds__(kBQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qcode, const int* __restrict__ kcode,
    const int* __restrict__ qseg, const int* __restrict__ kseg, int add_diag,
    Dropout dr, T* __restrict__ o, float* __restrict__ lse, int H, int S,
    int T_, float sm_scale) {
  constexpr int BK = kTileFloats / DH;
  __shared__ float ks[kTileFloats];
  __shared__ float vs[kTileFloats];
  __shared__ int kcs[BK];
  __shared__ int kss[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int i = blockIdx.x * kBQ + threadIdx.x;
  const bool active = i < S;
  const bool packed = qseg != nullptr;

  float qr[DH];
  int qc = 0, qs = 0;
  if (active) {
    const T* qp = q + ((size_t)bh * S + i) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = to_f(qp[d]);
    qc = qcode[(size_t)b * S + i];
    if (packed) qs = qseg[(size_t)b * S + i];
  }
  const T* kb = k + (size_t)bh * T_ * DH;
  const T* vb = v + (size_t)bh * T_ * DH;

  auto load_tile = [&](int t0, int n, bool with_v) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * DH; idx += kBQ) {
      ks[idx] = to_f(kb[(size_t)t0 * DH + idx]);
      if (with_v) vs[idx] = to_f(vb[(size_t)t0 * DH + idx]);
    }
    for (int j = threadIdx.x; j < n; j += kBQ) {
      kcs[j] = kcode[(size_t)b * T_ + t0 + j];
      if (packed) kss[j] = kseg[(size_t)b * T_ + t0 + j];
    }
    __syncthreads();
  };
  auto score = [&](int t0, int j) {
    // four independent partial sums: a single 64-long FMA chain is
    // latency bound at this kernel's occupancy
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < DH; ++d) part[d & 3] += qr[d] * ks[j * DH + d];
    const float dot = (part[0] + part[1]) + (part[2] + part[3]);
    bool vis = kcs[j] <= qc;
    if (packed) vis = vis && (qs == kss[j]);
    if (add_diag) vis = vis || (i == t0 + j);
    return vis ? dot * sm_scale : kNegInf;
  };

  // pass 1: row max m and sum l of exp(s - m)
  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < T_; t0 += BK) {
    const int n = min(BK, T_ - t0);
    load_tile(t0, n, false);
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float s = score(t0, j);
        if (s > m) {
          l = l * expf(m - s) + 1.f;
          m = s;
        } else {
          l += expf(s - m);
        }
      }
    }
  }

  // pass 2: out = sum_j round_T(drop(exp(s_j - m)) / l) * v_j
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int t0 = 0; t0 < T_; t0 += BK) {
    const int n = min(BK, T_ - t0);
    load_tile(t0, n, true);
    if (active) {
      for (int j = 0; j < n; ++j) {
        float e = expf(score(t0, j) - m);
        if (dr.thresh > 0)
          e = vt::dropout_keep(dr, bh, i, t0 + j, S, T_) ? e * dr.scale : 0.f;
        const float p = round_to<T>(e / l);
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] += p * vs[j * DH + d];
      }
    }
  }
  if (active) {
    T* op = o + ((size_t)bh * S + i) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) op[d] = from_f<T>(acc[d]);
    lse[(size_t)bh * S + i] = m + logf(l);
  }
}

// bf16, Dh = 64, on the tensor cores (mma.sync m16n8k16, fp32 accumulate).
// Block: 4 warps x 16 query rows; key tiles of 64 through shared memory.
// Thread (g = lane / 4, t = lane % 4) holds rows g and g + 8 of its warp's
// 16 (layouts in common.cuh).
// kDrop: dropout compiled in or out (the NAR passes run without it, and
// the Philox code would cost them registers).
constexpr int kMmaQ = 64;
constexpr int kMmaK = 64;
constexpr int kMmaDh = 64;

template <bool kDrop>
__global__ void __launch_bounds__(128) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int S,
    int T_, float sm_scale) {
  using T = __nv_bfloat16;
  __shared__ __align__(16) T ks[kMmaK * kMmaDh];
  __shared__ __align__(16) T vs[kMmaK * kMmaDh];
  __shared__ int kcs[kMmaK];
  __shared__ int kss[kMmaK];
  __shared__ __align__(16) uint8_t keep_bytes[kDrop ? 4 : 1][16 * kMmaK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool packed = qseg != nullptr;
  const int row0 = blockIdx.x * kMmaQ + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};

  uint4 qf[2][2];
  vt::load_rows64(qf, q + ((size_t)bh * S + rows[0]) * kMmaDh, rows[0] < S,
                  q + ((size_t)bh * S + rows[1]) * kMmaDh, rows[1] < S, t);
  int qc[2], qs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < S;
    qc[h] = ok ? qcode[(size_t)b * S + rows[h]] : -1;
    qs[h] = (ok && packed) ? qseg[(size_t)b * S + rows[h]] : 0;
  }
  const T* kb = k + (size_t)bh * T_ * kMmaDh;
  const T* vb = v + (size_t)bh * T_ * kMmaDh;

  auto load_tile = [&](int t0, bool with_v) {
    __syncthreads();
    const int n = min(kMmaK, T_ - t0);
    for (int i = threadIdx.x; i < kMmaK * kMmaDh / 8; i += 128) {
      const int key = i / (kMmaDh / 8);
      const uint4 zero = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(ks)[i] =
          key < n ? reinterpret_cast<const uint4*>(kb + (size_t)t0 * kMmaDh)[i]
                  : zero;
      if (with_v)
        reinterpret_cast<uint4*>(vs)[i] =
            key < n
                ? reinterpret_cast<const uint4*>(vb + (size_t)t0 * kMmaDh)[i]
                : zero;
    }
    for (int j = threadIdx.x; j < kMmaK; j += 128) {
      kcs[j] = j < n ? kcode[(size_t)b * T_ + t0 + j] : 0;
      kss[j] = (j < n && packed) ? kseg[(size_t)b * T_ + t0 + j] : 0;
    }
    __syncthreads();
  };

  // scores of this thread's 2 rows x (8 key tiles x 2 keys), masked
  auto scores = [&](int t0, float (&sc)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      vt::mma_dot64(sc[j], qf, ks + (j * 8 + g) * kMmaDh, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = j * 8 + t * 2 + (e & 1);
        const int h = e >> 1;
        bool vis = kcs[kj] <= qc[h];
        if (packed) vis = vis && (qs[h] == kss[kj]);
        if (add_diag) vis = vis || (rows[h] == t0 + kj);
        const float s = vis ? sc[j][e] * sm_scale : kNegInf;
        sc[j][e] = (t0 + kj < T_) ? s : -INFINITY;   // ragged edge: absent
      }
    }
  };

  // pass 1: row max m and sum l of exp(s - m), rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t0 = 0; t0 < T_; t0 += kMmaK) {
    load_tile(t0, false);
    float sc[8][4];
    scores(t0, sc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mt = fmaxf(mt, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[h], mt);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ps += expf(sc[j][2 * h] - mn) + expf(sc[j][2 * h + 1] - mn);
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[h] = l[h] * expf(m[h] - mn) + ps;
      m[h] = mn;
    }
  }

  // pass 2: out = sum_j round_bf16(drop(exp(s_j - m)) / l) * v_j
  float acc[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  uint8_t* kb8 = keep_bytes[kDrop ? warp : 0];
  for (int t0 = 0; t0 < T_; t0 += kMmaK) {
    load_tile(t0, true);
    if (kDrop)
      vt::fill_bytes(kb8, 16, kMmaK / 16, row0, t0 / 16, dr, bh, S, T_,
                     lane);
    float p[8][4];
    scores(t0, p);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = expf(p[j][e] - m[h]);
        if (kDrop) {
          const int kj = j * 8 + t * 2 + (e & 1);
          x = kb8[(g + 8 * h) * kMmaK + kj] >= dr.thresh ? x * dr.scale
                                                         : 0.f;
        }
        p[j][e] = x / l[h];
      }
    vt::mma_pm64(acc, p, vs, g, t);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] < S) {
      T* op = o + ((size_t)bh * S + rows[h]) * kMmaDh;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + t * 2) =
            vt::pack_bf16(acc[d][2 * h], acc[d][2 * h + 1]);
      if (t == 0) lse[(size_t)bh * S + rows[h]] = m[h] + logf(l[h]);
    }
  }
}

}  // namespace

extern "C" int vt_flash_fwd(int dtype, int dh, const void* q, const void* k,
                            const void* v, const int* qcode, const int* kcode,
                            const int* qseg, const int* kseg, int add_diag,
                            int thresh, float drop_scale,
                            unsigned long long seed, const uint8_t* bits,
                            void* o, float* lse, int B, int H, int S, int T_,
                            float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != 64) return cudaErrorInvalidValue;
  const Dropout dr{thresh, drop_scale, (uint32_t)(seed & 0xffffffffull),
                   (uint32_t)(seed >> 32), bits};
  if (dtype == vt::kF32) {
    dim3 grid((S + kBQ - 1) / kBQ, B * H);
    flash_fwd_kernel<float, 64><<<grid, kBQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qcode, kcode, qseg, kseg, add_diag, dr,
        static_cast<float*>(o), lse, H, S, T_, sm_scale);
    return cudaGetLastError();
  }
  if (dtype == vt::kBF16) {
    dim3 grid((S + kMmaQ - 1) / kMmaQ, B * H);
    auto kernel = thresh > 0 ? flash_fwd_mma_kernel<true>
                             : flash_fwd_mma_kernel<false>;
    kernel<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qcode, kcode, qseg, kseg,
        add_diag, dr, static_cast<__nv_bfloat16*>(o), lse, H, S, T_,
        sm_scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
