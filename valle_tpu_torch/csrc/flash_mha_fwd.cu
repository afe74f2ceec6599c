// Exact softmax attention with the mask rebuilt from int32 codes and
// dropout on the probabilities: the port of the TPU kernel
// valle_tpu/ops/flash_mha.py:_fwd_kernel (the forward of flash_mha_train,
// reached through _pallas_fwd).
//
// visible(i, j) = kcode[j] <= qcode[i]  (and qseg[i] == kseg[j] when
// segments are given)  (or i == j under add_diag). Masked scores take the
// finite NEG_INF = -1e30 of flash_mha.py:66, so a fully masked row stays
// finite and uniform over all T keys. The output is
// dropout(softmax(q k^T / sqrt(Dh))) v in q's dtype, plus the log-sum-exp
// (B, H, S) in fp32 for the backward. keep(i, j) = byte >= thresh, the
// byte from the in-kernel Philox4x32-10 (common.cuh) or from an explicit
// bits tensor. The TPU draws from its hardware PRNG, which cannot be
// replayed; Philox can, so the plain version (ops/philox.py) and the
// backward regenerate the same mask bit for bit.
//
// What bounds it on the H100: at the AR training shape (B*H = 256, S = T =
// 471, Dh = 64) the work is at most 4*B*H*S*T*Dh = 14.5 GFLOP (14.7 us
// of bf16 tensor-core time, before the mask hides part of it) against
// 61.7 MB of q/k/v/o (18.4 us of HBM time): bytes bound it, and the
// score matrix (B, H, S, T) must never reach device memory (at Dh 128
// both figures double). The TPU kernel held a whole key row in VMEM; a
// Hopper block cannot, so:
//
// - Dh 64 and 128 (16 heads, or 8, at d_model 1024).
// - bf16 (the main path) runs flash_fwd_wgmma<DH, kMaskCodes (or
//   kMaskSegments for packed rows), drop>
//   (flash_fwd.cuh, the body B6/B7 share): one warpgroup per (b, h, tile
//   of 64 queries), ONE online-softmax pass over key tiles of 64, q.k^T a
//   wgmma chain from shared memory, P.V from registers against v read
//   transposed, K/V tiles by cp.async into a two-stage ring of 128-byte
//   swizzled tiles (a Dh-128 row is two 64-column tiles).
// - Dropout keeps JAX's order (flash_mha.py:143-154) inside the one pass:
//   l sums the UNDROPPED exp(s - m) with the running rescale, the
//   numerator adds round_bf16(keep ? e / (1 - thresh / 256) : 0) . v, and
//   out = acc / l at the end, lse = m + log l. The rounding point moved
//   from the TPU's p / l to the unnormalised p (as B6/B7 do), and the
//   exponentials use the fast __expf (ex2.approx) where the CUDA-core
//   kernels use expf; both move the bf16 error (flash_mha_bwd.cu's wgmma
//   kernels use __expf too), and the bf16 check stays 2e-2 of the largest
//   entry against reference_mha. Each 16-byte Philox output is
//   computed once per warp and staged in swizzled shared memory
//   (flash_mha.cuh).
// - Key tiles that no query of the block can see are skipped: one warp
//   lists the visible tiles from the block's largest qcode and each
//   tile's smallest kcode (and the segment ranges when packed; tiles on
//   the diagonal under add_diag) before the pass. A row that sees no key
//   must average all T keys, so if any row of the block saw none after
//   the pass, the block runs again over every tile (VALL-E's codes never
//   need that: key 0 is text with code 0).
// - fp32 (the verification path) runs flash_fwd_kernel on the CUDA
//   cores: Dh / 64 threads per query row, each holding 64 of its q and
//   output dims in registers (interleaved; a shuffle sums the dot), every
//   row reading the same key row (a shared-memory broadcast), two passes
//   over the keys.
// - The kernels mask the ragged edges themselves (queries past S, keys
//   past T; S != T allowed) instead of padding copies in device memory
//   (flash_mha.py:408-424).
//
// Not yet used: TMA, warp specialisation (a producer warp), overlapping
// one tile's softmax with the next tile's q.k^T inside the warpgroup,
// 128-row blocks sharing a K/V tile.

#include <math.h>

#include "flash_fwd.cuh"

namespace {

using vt::Dropout;
using vt::from_f;
using vt::kNegInf;
using vt::round_to;
using vt::to_f;

constexpr int kThreads = 64;       // threads per fp32 block
constexpr int kTileFloats = 4096;  // K (and V) tile: kTileFloats / Dh keys

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qcode, const int* __restrict__ kcode,
    const int* __restrict__ qseg, const int* __restrict__ kseg, int add_diag,
    Dropout dr, T* __restrict__ o, float* __restrict__ lse, int H, int S,
    int T_, float sm_scale) {
  constexpr int TPR = DH / 64;          // threads per query row
  constexpr int BK = kTileFloats / DH;  // keys per tile
  __shared__ float ks[kTileFloats];
  __shared__ float vs[kTileFloats];
  __shared__ int kcs[BK];
  __shared__ int kss[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int i = blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;   // this thread's dims: c * TPR + part
  const bool active = i < S;
  const bool packed = qseg != nullptr;

  float qr[64];
  int qc = 0, qs = 0;
#pragma unroll
  for (int c = 0; c < 64; ++c) qr[c] = 0.f;
  if (active) {
    const T* qp = q + ((size_t)bh * S + i) * DH;
#pragma unroll
    for (int c = 0; c < 64; ++c) qr[c] = to_f(qp[c * TPR + part]);
    qc = qcode[(size_t)b * S + i];
    if (packed) qs = qseg[(size_t)b * S + i];
  }
  const T* kb = k + (size_t)bh * T_ * DH;
  const T* vb = v + (size_t)bh * T_ * DH;

  auto load_tile = [&](int t0, int n, bool with_v) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * DH; idx += kThreads) {
      ks[idx] = to_f(kb[(size_t)t0 * DH + idx]);
      if (with_v) vs[idx] = to_f(vb[(size_t)t0 * DH + idx]);
    }
    for (int j = threadIdx.x; j < n; j += kThreads) {
      kcs[j] = kcode[(size_t)b * T_ + t0 + j];
      if (packed) kss[j] = kseg[(size_t)b * T_ + t0 + j];
    }
    __syncthreads();
  };
  // every thread runs the loops (a row's shuffles need all its threads);
  // an inactive row computes on zeros and writes nothing
  auto score = [&](int t0, int j) {
    // four independent partial sums: a single 64-long FMA chain is
    // latency bound at this kernel's occupancy
    float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 64; ++c)
      pd[c & 3] += qr[c] * ks[j * DH + c * TPR + part];
    float dot = (pd[0] + pd[1]) + (pd[2] + pd[3]);
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
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

  // pass 2: out = sum_j round_T(drop(exp(s_j - m)) / l) * v_j
  float acc[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) acc[c] = 0.f;
  for (int t0 = 0; t0 < T_; t0 += BK) {
    const int n = min(BK, T_ - t0);
    load_tile(t0, n, true);
    for (int j = 0; j < n; ++j) {
      float e = expf(score(t0, j) - m);
      if (dr.thresh > 0)
        e = vt::dropout_keep(dr, bh, i, t0 + j, S, T_) ? e * dr.scale : 0.f;
      const float p = round_to<T>(e / l);
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[c] += p * vs[j * DH + c * TPR + part];
    }
  }
  if (active) {
    T* op = o + ((size_t)bh * S + i) * DH;
#pragma unroll
    for (int c = 0; c < 64; ++c) op[c * TPR + part] = from_f<T>(acc[c]);
    if (part == 0) lse[(size_t)bh * S + i] = m + logf(l);
  }
}

template <int DH>
int launch(int dtype, const void* q, const void* k, const void* v,
           const int* qcode, const int* kcode, const int* qseg,
           const int* kseg, int add_diag, const Dropout& dr, void* o,
           float* lse, int B, int H, int S, int T_, float sm_scale,
           cudaStream_t s) {
  if (dtype == vt::kF32) {
    dim3 grid((S * (DH / 64) + kThreads - 1) / kThreads, B * H);
    flash_fwd_kernel<float, DH><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qcode, kcode, qseg, kseg, add_diag, dr,
        static_cast<float*>(o), lse, H, S, T_, sm_scale);
    return cudaGetLastError();
  }
  if (dtype == vt::kBF16) {
    using bf16 = __nv_bfloat16;
    vt::FwdParams p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.q_b = (long)H * S * DH, p.q_h = (long)S * DH, p.q_t = DH;
    p.k_b = p.v_b = (long)H * T_ * DH, p.k_h = p.v_h = (long)T_ * DH;
    p.k_t = p.v_t = DH;
    p.o = static_cast<bf16*>(o);
    p.lse = lse;
    p.H = H, p.S = S, p.T = T_, p.sm_scale = sm_scale;
    p.qcode = qcode, p.kcode = kcode, p.qseg = qseg, p.kseg = kseg;
    p.add_diag = add_diag, p.dr = dr;
    using vt::launch_flash_fwd;
    constexpr int kSeg = vt::kMaskSegments, kCodes = vt::kMaskCodes;
    if (qseg != nullptr)
      return dr.thresh > 0 ? launch_flash_fwd<DH, kSeg, true>(p, B, s)
                           : launch_flash_fwd<DH, kSeg, false>(p, B, s);
    return dr.thresh > 0 ? launch_flash_fwd<DH, kCodes, true>(p, B, s)
                         : launch_flash_fwd<DH, kCodes, false>(p, B, s);
  }
  return cudaErrorInvalidValue;
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
  const Dropout dr{thresh, drop_scale, (uint32_t)(seed & 0xffffffffull),
                   (uint32_t)(seed >> 32), bits};
  if (dh == 64)
    return launch<64>(dtype, q, k, v, qcode, kcode, qseg, kseg, add_diag, dr,
                      o, lse, B, H, S, T_, sm_scale, s);
  if (dh == 128)
    return launch<128>(dtype, q, k, v, qcode, kcode, qseg, kseg, add_diag, dr,
                       o, lse, B, H, S, T_, sm_scale, s);
  return cudaErrorInvalidValue;
}
