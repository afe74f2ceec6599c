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
// score matrix (B, H, S, T) must never reach device memory. The TPU
// kernel held a whole key row in VMEM; a Hopper block cannot, so:
//
// - Dh = 64 only (16 heads at d_model 1024).
// - bf16 (the main path) runs flash_fwd_wgmma: one warpgroup (128
//   threads) per (b, h, tile of 64 queries), ONE online-softmax pass over
//   key tiles of 64. q.k^T is a wgmma m64n64k16 chain with q and k from
//   shared memory; P.V takes p from registers (the score accumulators,
//   packed to bf16) and v from shared memory read transposed. K/V tiles
//   arrive by cp.async into a ring of kStages stages in the 128-byte
//   swizzled layout (hopper.cuh), so tile n + 1 loads while tile n
//   multiplies and no operand read has a bank conflict.
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
//   cores: one thread per query row, its q row and output row in
//   registers, every thread reading the same key row (a shared-memory
//   broadcast), two passes over the keys.
// - The kernels mask the ragged edges themselves (queries past S, keys
//   past T; S != T allowed) instead of padding copies in device memory
//   (flash_mha.py:408-424).
//
// Not yet used: TMA, warp specialisation (a producer warp), overlapping
// one tile's softmax with the next tile's q.k^T inside the warpgroup,
// 128-row blocks sharing a K/V tile.

#include <math.h>

#include "flash_mha.cuh"

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

// bf16, Dh = 64, on the tensor cores: one warpgroup per 64 queries.
// Thread (warp w, g = lane / 4, t = lane % 4) owns query rows
// 16 w + g and 16 w + g + 8 of the block (the wgmma accumulator layout,
// hopper.cuh). kDrop: dropout compiled in or out (the NAR passes run
// without it).
using bf16 = __nv_bfloat16;
constexpr int kT = vt::kFlashTile;
constexpr int kStages = 2;

// Dynamic shared memory: the q tile, kStages x (k, v) tiles, kStages x
// (kcode, kseg) of the tile, the dropout bytes (4 warps x 1 KB), the tile
// list; 1 KB of slack for the 1024-byte alignment.
constexpr int kQOff = 0;
constexpr int kKVOff = vt::kSwTileBytes;
constexpr int kCodeOff = kKVOff + kStages * 2 * vt::kSwTileBytes;
constexpr int kDropOff = kCodeOff + kStages * 2 * kT * 4;

size_t fwd_smem_bytes(bool drop, int T_) {
  return 1024 + kDropOff + (drop ? 4 * 1024 : 0) +
         4 * ((T_ + kT - 1) / kT + 1);
}

template <bool kDrop>
__global__ void __launch_bounds__(128) flash_fwd_wgmma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ qcode,
    const int* __restrict__ kcode, const int* __restrict__ qseg,
    const int* __restrict__ kseg, int add_diag, Dropout dr,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int S, int T_,
    float sm_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = vt::align1024(smem_raw);
  const uint32_t q_s = vt::smem_addr(sm + kQOff);
  const uint32_t kv_s = vt::smem_addr(sm + kKVOff);
  int* codes = reinterpret_cast<int*>(sm + kCodeOff);
  uint8_t* drop = sm + kDropOff;
  int* list = reinterpret_cast<int*>(drop + (kDrop ? 4 * 1024 : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int i0 = blockIdx.x * kT;
  const int rows[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  const bool packed = qseg != nullptr;
  const int* qc_b = qcode + (size_t)b * S;
  const int* kc_b = kcode + (size_t)b * T_;
  const int* qs_b = packed ? qseg + (size_t)b * S : nullptr;
  const int* ks_b = packed ? kseg + (size_t)b * T_ : nullptr;
  const bf16* kb = k + (size_t)bh * T_ * 64;
  const bf16* vb = v + (size_t)bh * T_ * 64;

  vt::load_tile_sw128(q_s, q + ((size_t)bh * S + i0) * 64, S - i0, tid);
  vt::cp_async_commit();
  int qc[2], qsg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = rows[h] < S;
    qc[h] = ok ? qc_b[rows[h]] : -1;
    qsg[h] = (ok && packed) ? qs_b[rows[h]] : 0;
  }
  if (warp == 0)
    vt::build_tile_list(list, true, qc_b, qs_b, i0, S, kc_b, ks_b, T_,
                        add_diag, lane);
  __syncthreads();

  float acc[32], m[2], l[2];
  // pass 0 visits the listed tiles; pass 1 (only when a row of the block
  // saw no key) visits all of them
  for (int pass = 0; pass < 2; ++pass) {
    const int nv = pass == 0 ? list[0] : (T_ + kT - 1) / kT;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    auto tile_of = [&](int n) { return pass == 0 ? list[1 + n] : n; };
    auto issue = [&](int n) {   // tile n of the visit into stage n % kStages
      if (n < nv) {
        const int st = n % kStages, j0 = tile_of(n) * kT, nk = T_ - j0;
        const uint32_t ks = kv_s + st * 2 * vt::kSwTileBytes;
        vt::load_tile_sw128(ks, kb + (size_t)j0 * 64, nk, tid);
        vt::load_tile_sw128(ks + vt::kSwTileBytes, vb + (size_t)j0 * 64, nk,
                            tid);
        const int c = tid & (kT - 1);
        const bool ok = c < nk;
        if (tid < kT)
          vt::cp_async4(vt::smem_addr(codes + st * 2 * kT + c),
                        kc_b + (ok ? j0 + c : 0), ok);
        else if (packed)
          vt::cp_async4(vt::smem_addr(codes + st * 2 * kT + kT + c),
                        ks_b + (ok ? j0 + c : 0), ok);
      }
      vt::cp_async_commit();
    };

#pragma unroll
    for (int n = 0; n < kStages - 1; ++n) issue(n);
    for (int n = 0; n < nv; ++n) {
      vt::cp_async_wait<kStages - 2>();
      vt::fence_proxy_async();
      __syncthreads();   // tile n landed; tile n - 1's stage is free
      issue(n + kStages - 1);
      const int st = n % kStages, j0 = tile_of(n) * kT;
      const uint32_t ks = kv_s + st * 2 * vt::kSwTileBytes;
      const int* kcs = codes + st * 2 * kT;

      float s[32];
      vt::wgmma_fence();
      vt::wgmma_tile_ss(s, q_s, ks);
      vt::wgmma_commit();
      uint8_t* buf = drop + warp * 1024;
      if (kDrop)   // Philox while the tensor cores run
        vt::stage_row_bytes(buf, dr, bh, i0 + warp * 16, j0 / 16, S, T_,
                            lane);
      vt::wgmma_wait<0>();
      vt::fence_regs(s);

      // mask: hidden keys NEG_INF, keys past T absent (-inf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const int2 kc2 = *reinterpret_cast<const int2*>(kcs + c);
        const int2 ks2 = packed ? *reinterpret_cast<const int2*>(kcs + kT + c)
                                : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, e1 = e & 1, key = j0 + c + e1;
          const bool vis = vt::visible(qc[h], qsg[h], e1 ? kc2.y : kc2.x,
                                       e1 ? ks2.y : ks2.x, packed, add_diag,
                                       rows[h], key);
          const float x = vis ? s[4 * j + e] * sm_scale : kNegInf;
          s[4 * j + e] = key < T_ ? x : -INFINITY;
        }
      }
      // online softmax: rescale l and acc by exp(m_old - m_new); the tile
      // holds a key < T, so m_new is finite
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mt = fmaxf(mt, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mn = fmaxf(m[h], mt);
        const float alpha = __expf(m[h] - mn);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const float x = __expf(s[4 * j + e] - mn);
            s[4 * j + e] = x;
            ps += x;
          }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[h] = l[h] * alpha + ps;
        m[h] = mn;
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          acc[4 * d + 2 * h] *= alpha;
          acc[4 * d + 2 * h + 1] *= alpha;
        }
      }
      if (kDrop) {   // after l: l sums the undropped values
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int sg = 0; sg < 4; ++sg) {
            const uint2 w = vt::row_bytes(buf, g + 8 * h, sg, t);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = 2 * sg + half;
              const uint32_t word = half ? w.y : w.x;
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1) {
                const int byte = (word >> (16 * (t & 1) + 8 * e1)) & 255;
                float& x = s[4 * j + 2 * h + e1];
                x = byte >= dr.thresh ? x * dr.scale : 0.f;
              }
            }
          }
      }
      uint32_t pa[4][4];
      vt::pack_a(pa, s);
      vt::fence_regs(acc);
      vt::wgmma_fence();
      vt::wgmma_tile_rs_t(acc, pa, ks + vt::kSwTileBytes);
      vt::wgmma_commit();
      vt::wgmma_wait<0>();
      vt::fence_regs(acc);
    }
    vt::cp_async_wait<0>();
    if (pass == 1) break;
    bool unseen = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) unseen |= rows[h] < S && !(m[h] > kNegInf);
    if (!__syncthreads_or(unseen)) break;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] < S) {
      const float inv = 1.f / l[h];
      bf16* op = o + ((size_t)bh * S + rows[h]) * 64;
#pragma unroll
      for (int d = 0; d < 8; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + t * 2) = vt::pack_bf16(
            acc[4 * d + 2 * h] * inv, acc[4 * d + 2 * h + 1] * inv);
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
    dim3 grid((S + kT - 1) / kT, B * H);
    auto kernel = thresh > 0 ? flash_fwd_wgmma<true> : flash_fwd_wgmma<false>;
    const size_t smem = fwd_smem_bytes(thresh > 0, T_);
    if (int rc = vt::allow_smem(kernel, smem)) return rc;
    kernel<<<grid, 128, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), qcode, kcode, qseg, kseg, add_diag, dr,
        static_cast<bf16*>(o), lse, H, S, T_, sm_scale);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
