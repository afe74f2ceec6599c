// The bf16 flash-attention forward on the tensor cores, one body for three
// kernels: B4 (flash_mha_fwd.cu: the mask from int32 codes, dropout, the
// log-sum-exp for the backward), B6 and B7 (flash_attention.cu: an
// additive fp32 bias, or the mask rebuilt from per-row lengths). The mask
// is a template parameter; head dims 64 and 128.
//
// One warpgroup (128 threads) per (b, h, tile of 64 queries), ONE
// online-softmax pass over key tiles of 64 (kFlashTile). Thread (warp w,
// g = lane / 4, t = lane % 4) owns query rows 16 w + g and 16 w + g + 8 of
// the block (the wgmma accumulator layout, hopper.cuh). q.k^T is a wgmma
// m64n64k16 chain with q and k from shared memory, DH / 16 steps deep; P.V
// takes p from registers (the score accumulators, packed to bf16) and v
// from shared memory read transposed, one n64 product per 64 output
// columns. K/V tiles (and the mask's per-tile data: the keys' codes, or
// the bias tile) arrive by cp.async into a ring of kFwdStages stages in
// the 128-byte swizzled layout, so tile n + 1 loads while tile n
// multiplies and no operand read has a bank conflict. q, k and v are read
// through their (b, h, row) strides, so views of a fused projection need
// no copy; queries past S and keys past T are masked here.
//
// Masks:
// - kMaskCodes (B4): visible(i, j) = kcode[j] <= qcode[i] (or i == j
//   under add_diag); kMaskSegments the same and equal segments (packed
//   rows). Hidden scores take NEG_INF = -1e30, so a row that sees no key
//   averages all T keys. Segments are a mask of their own so that the
//   unpacked loop carries no test for them (as one runtime test per score
//   it made B4 16% slower at Dh 64, H100).
// - kMaskBias (B6): s + max(bias, -1e30). With a zero query stride (the
//   NAR's (B, 1, 1, T) key bias) a stage holds one row of 64 floats; else
//   a 64 x 64 fp32 tile, its 16-byte chunks swizzled so that a warp's
//   8-byte reads hit distinct banks. Loaded 4 bytes at a time: a row of
//   the (B, 1, S, T) prefill bias starts 16-byte aligned only when T is a
//   multiple of 4. Every tile is visited: a bias gives no skip list.
// - kMaskLens (B7): text keys j < min(x_len, S_text), audio keys with
//   j - S_text < y_len; under audio_causal text queries see text keys
//   only and audio queries text keys and audio keys j <= i. Masked scores
//   take NEG_INF.
// - kMaskNone: every key < T is visible.
// Under codes and lengths one warp first lists the key tiles that some
// query of the block can see, and the pass visits only those; if a row of
// the block then saw no key, the block runs again over every tile, so that
// row still averages all T keys.
//
// Rounding: l sums the unrounded exp(s - m) with the running rescale; p is
// rounded to bf16 before P.V (unnormalised), out = acc / l at the end. The
// exponentials use the fast __expf (ex2.approx).
#pragma once

#include <math.h>

#include "flash_mha.cuh"

namespace vt {

enum FwdMask { kMaskCodes, kMaskSegments, kMaskBias, kMaskLens,
               kMaskNone };

constexpr int kFwdStages = 2;

struct FwdParams {
  const __nv_bfloat16 *q, *k, *v;      // (b, h, row) strides in elements,
  long q_b, q_h, q_t, k_b, k_h, k_t;   // unit feature stride, rows 16-byte
  long v_b, v_h, v_t;                  // aligned
  __nv_bfloat16* o;                    // contiguous (B, H, S, DH)
  float* lse;                          // (B, H, S); the codes masks only
  int H, S, T;
  float sm_scale;
  // kMaskCodes / kMaskSegments: (B, S) / (B, T) int32
  const int *qcode, *kcode, *qseg, *kseg;
  int add_diag;
  Dropout dr;
  // kMaskBias: element (b, h, i, j) at bias + b bs_b + h bs_h + i bs_i + j
  const float* bias;
  long bs_b, bs_h, bs_i;
  // kMaskLens: (B,) int32
  const int *x_lens, *y_lens;
  int s_text, causal;
};

// Bytes of a stage's mask data.
template <int MASK>
__host__ __device__ __forceinline__ int fwd_extra_bytes(long bs_i) {
  if (MASK == kMaskCodes || MASK == kMaskSegments)
    return 2 * kFlashTile * 4;   // kcode, kseg
  if (MASK == kMaskBias) return bs_i == 0 ? kFlashTile * 4
                                          : kFlashTile * kFlashTile * 4;
  return 0;
}

// Dynamic shared memory: the q tiles, kFwdStages x (k, v) tiles, kFwdStages
// x the mask data, the dropout bytes (4 warps x 1 KB), the tile list; 1 KB
// of slack for the 1024-byte alignment.
template <int DH, int MASK, bool kDrop>
size_t fwd_smem_bytes(const FwdParams& p) {
  return 1024 + (DH / 64) * kSwTileBytes * (1 + 2 * kFwdStages) +
         kFwdStages * fwd_extra_bytes<MASK>(p.bs_i) + (kDrop ? 4 * 1024 : 0) +
         4 * ((p.T + kFlashTile - 1) / kFlashTile + 1);
}

// Byte offset of fp32 element (r, c) of a swizzled 64 x 64 bias tile: the
// 16-byte chunk c / 4 of row r moves to chunk (c / 4) ^ (2 (r % 4)).
__device__ __forceinline__ int bias_offset(int r, int c) {
  return r * 256 + ((((c >> 2) ^ ((r & 3) << 1))) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ bool lens_visible(int i, int j, int s_text,
                                             int x_len, int y_len,
                                             int causal) {
  const bool k_text = j < s_text;
  bool vis = k_text ? j < x_len : j - s_text < y_len;
  if (causal) vis = vis && (k_text || (i >= s_text && j <= i));
  return vis;
}

// One thread lists the key tiles that a query of rows i0 .. i0 + 63 (those
// < S) can see under the lengths mask: list[0] = their count, list[1..]
// their indices in order.
__device__ __forceinline__ void build_lens_list(int* list, int i0, int S,
                                                int T, int s_text, int x_len,
                                                int y_len, int causal) {
  const int text_end = min(min(s_text, x_len), T);
  int audio_end = min(T, s_text + max(y_len, 0));
  if (causal) audio_end = min(audio_end, min(i0 + kFlashTile, S));
  int cnt = 0;
  for (int t0 = 0; t0 < T; t0 += kFlashTile) {
    const bool text = t0 < text_end;
    const bool audio = max(t0, s_text) < min(t0 + kFlashTile, audio_end);
    if (text || audio) list[1 + cnt++] = t0 / kFlashTile;
  }
  list[0] = cnt;
}

template <int MASK>
__host__ __device__ constexpr bool is_codes() {
  return MASK == kMaskCodes || MASK == kMaskSegments;
}

// B4 and B7 at Dh 64 are held to 128 registers, four blocks an SM.
template <int DH, int MASK, bool kDrop>
__global__ void __launch_bounds__(
    128, (is_codes<MASK>() || MASK == kMaskLens) && DH == 64 ? 4 : 1)
    flash_fwd_wgmma(const FwdParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int kT = kFlashTile, NH = DH / 64;
  constexpr int kQBytes = NH * kSwTileBytes, kKVBytes = 2 * kQBytes;
  constexpr bool kCodes = is_codes<MASK>();
  constexpr bool packed = MASK == kMaskSegments;
  constexpr bool kSkip = kCodes || MASK == kMaskLens;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  const int xbytes = fwd_extra_bytes<MASK>(p.bs_i);
  const bool row_bias = MASK == kMaskBias && p.bs_i == 0;
  const uint32_t q_s = smem_addr(sm);
  const uint32_t kv_s = q_s + kQBytes;
  uint8_t* extra = sm + kQBytes + kFwdStages * kKVBytes;
  uint8_t* drop = extra + kFwdStages * xbytes;
  int* list = reinterpret_cast<int*>(drop + (kDrop ? 4 * 1024 : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, hd = bh % p.H;
  const int S = p.S, T_ = p.T;
  const int i0 = blockIdx.x * kT;
  const int rows[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  // B4's operands are contiguous (B, H, rows, DH): their row stride is
  // known here, which keeps the tile loads' offsets constant
  const int q_t = kCodes ? DH : (int)p.q_t;
  const int k_t = kCodes ? DH : (int)p.k_t;
  const int v_t = kCodes ? DH : (int)p.v_t;
  const bf16* kb = p.k + b * p.k_b + hd * p.k_h;
  const bf16* vb = p.v + b * p.v_b + hd * p.v_h;

  load_rows_sw128<DH>(q_s, p.q + b * p.q_b + hd * p.q_h + (long)i0 * q_t,
                      S - i0, tid, q_t);
  cp_async_commit();

  // the mask's per-block state
  const int* kc_b = nullptr;
  const int* ks_b = nullptr;
  int qc[2] = {0, 0}, qsg[2] = {0, 0};
  const float* bias_b = nullptr;
  int x_len = 0, y_len = 0;
  if constexpr (kCodes) {
    const int* qc_b = p.qcode + (size_t)b * S;
    const int* qs_b = packed ? p.qseg + (size_t)b * S : nullptr;
    kc_b = p.kcode + (size_t)b * T_;
    ks_b = packed ? p.kseg + (size_t)b * T_ : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = rows[h] < S;
      qc[h] = ok ? qc_b[rows[h]] : -1;
      qsg[h] = (ok && packed) ? qs_b[rows[h]] : 0;
    }
    if (warp == 0)
      build_tile_list(list, true, qc_b, qs_b, i0, S, kc_b, ks_b, T_,
                      p.add_diag, lane);
  } else if constexpr (MASK == kMaskBias) {
    bias_b = p.bias + b * p.bs_b + hd * p.bs_h;
  } else if constexpr (MASK == kMaskLens) {
    x_len = p.x_lens[b];
    y_len = p.y_lens[b];
    if (tid == 0)
      build_lens_list(list, i0, S, T_, p.s_text, x_len, y_len, p.causal);
  }
  __syncthreads();

  float acc[NH][32], m[2], l[2];
  const int n_tiles = (T_ + kT - 1) / kT;
  // pass 0 visits the listed tiles (every tile under a bias or none); pass 1
  // (only when a row of the block saw no key) visits all of them
  for (int pass = 0; pass < 2; ++pass) {
    const bool listed = kSkip && pass == 0;
    const int nv = listed ? list[0] : n_tiles;
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;

    auto tile_of = [&](int n) { return listed ? list[1 + n] : n; };
    auto issue = [&](int n) {   // tile n of the visit into stage n % kFwdStages
      if (n < nv) {
        const int st = n % kFwdStages, j0 = tile_of(n) * kT, nk = T_ - j0;
        const uint32_t ks = kv_s + st * kKVBytes;
        load_rows_sw128<DH>(ks, kb + (long)j0 * k_t, nk, tid, k_t);
        load_rows_sw128<DH>(ks + kQBytes, vb + (long)j0 * v_t, nk, tid, v_t);
        const uint32_t xs = smem_addr(extra + st * xbytes);
        if constexpr (kCodes) {
          const int c = tid & (kT - 1);
          const bool ok = c < nk;
          if (tid < kT)
            cp_async4(xs + 4 * c, kc_b + (ok ? j0 + c : 0), ok);
          else if constexpr (packed)
            cp_async4(xs + 4 * (kT + c), ks_b + (ok ? j0 + c : 0), ok);
        } else if constexpr (MASK == kMaskBias) {
          if (row_bias) {
            const bool ok = tid < nk;
            if (tid < kT)
              cp_async4(xs + 4 * tid, bias_b + (ok ? j0 + tid : 0), ok);
          } else {
#pragma unroll 8
            for (int e = tid; e < kT * kT; e += 128) {
              const int r = e >> 6, c = e & 63;
              const bool ok = i0 + r < S && c < nk;
              cp_async4(xs + bias_offset(r, c),
                        bias_b + (ok ? (i0 + r) * p.bs_i + j0 + c : 0), ok);
            }
          }
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int n = 0; n < kFwdStages - 1; ++n) issue(n);
    for (int n = 0; n < nv; ++n) {
      cp_async_wait<kFwdStages - 2>();
      fence_proxy_async();
      __syncthreads();   // tile n landed; tile n - 1's stage is free
      issue(n + kFwdStages - 1);
      const int st = n % kFwdStages, j0 = tile_of(n) * kT;
      const uint32_t ks = kv_s + st * kKVBytes;
      const uint8_t* xt = extra + st * xbytes;

      float s[32];
      wgmma_fence();
      wgmma_rows_ss<DH>(s, q_s, ks);
      wgmma_commit();
      uint8_t* buf = drop + warp * 1024;
      if constexpr (kDrop)   // Philox while the tensor cores run
        stage_row_bytes(buf, p.dr, bh, i0 + warp * 16, j0 / 16, S, T_, lane);
      wgmma_wait<0>();
      fence_regs(s);

      // mask: hidden keys NEG_INF, keys past T absent (-inf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        int2 kc2 = make_int2(0, 0), ks2 = make_int2(0, 0);
        float2 bv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if constexpr (kCodes) {
          const int* kcs = reinterpret_cast<const int*>(xt);
          kc2 = *reinterpret_cast<const int2*>(kcs + c);
          if constexpr (packed)
            ks2 = *reinterpret_cast<const int2*>(kcs + kT + c);
        } else if constexpr (MASK == kMaskBias) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            bv[h] = *reinterpret_cast<const float2*>(
                xt + (row_bias ? 4 * c
                               : bias_offset(warp * 16 + g + 8 * h, c)));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, e1 = e & 1, key = j0 + c + e1;
          const float sc = s[4 * j + e] * p.sm_scale;
          float x;
          if constexpr (kCodes) {
            x = visible(qc[h], qsg[h], e1 ? kc2.y : kc2.x, e1 ? ks2.y : ks2.x,
                        packed, p.add_diag, rows[h], key)
                    ? sc
                    : kNegInf;
          } else if constexpr (MASK == kMaskBias) {
            x = sc + fmaxf(e1 ? bv[h].y : bv[h].x, kNegInf);
          } else if constexpr (MASK == kMaskLens) {
            x = lens_visible(rows[h], key, p.s_text, x_len, y_len, p.causal)
                    ? sc
                    : kNegInf;
          } else {
            x = sc;
          }
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
        for (int jh = 0; jh < NH; ++jh)
#pragma unroll
          for (int d = 0; d < 8; ++d) {
            acc[jh][4 * d + 2 * h] *= alpha;
            acc[jh][4 * d + 2 * h + 1] *= alpha;
          }
      }
      if constexpr (kDrop) {   // after l: l sums the undropped values
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int sg = 0; sg < 4; ++sg) {
            const uint2 w = row_bytes(buf, g + 8 * h, sg, t);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = 2 * sg + half;
              const uint32_t word = half ? w.y : w.x;
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1) {
                const int byte = (word >> (16 * (t & 1) + 8 * e1)) & 255;
                float& x = s[4 * j + 2 * h + e1];
                x = byte >= p.dr.thresh ? x * p.dr.scale : 0.f;
              }
            }
          }
      }
      uint32_t pa[4][4];
      pack_a(pa, s);
      fence_regs(acc);
      wgmma_fence();
      wgmma_rows_rs_t<DH>(acc, pa, ks + kQBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    cp_async_wait<0>();
    if (!kSkip || pass == 1) break;
    bool unseen = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) unseen |= rows[h] < S && !(m[h] > kNegInf);
    if (!__syncthreads_or(unseen)) break;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] < S) {
      const float inv = 1.f / l[h];
      bf16* op = p.o + ((size_t)bh * S + rows[h]) * DH;
#pragma unroll
      for (int jh = 0; jh < NH; ++jh)
#pragma unroll
        for (int d = 0; d < 8; ++d)
          *reinterpret_cast<uint32_t*>(op + 64 * jh + d * 8 + t * 2) =
              pack_bf16(acc[jh][4 * d + 2 * h] * inv,
                        acc[jh][4 * d + 2 * h + 1] * inv);
      if constexpr (kCodes)
        if (t == 0) p.lse[(size_t)bh * S + rows[h]] = m[h] + logf(l[h]);
    }
  }
}

// Launches the instance for p on stream s (B * H blocks of each query
// tile); returns the CUDA error code.
template <int DH, int MASK, bool kDrop>
int launch_flash_fwd(const FwdParams& p, int B, cudaStream_t s) {
  auto kernel = flash_fwd_wgmma<DH, MASK, kDrop>;
  const size_t smem = fwd_smem_bytes<DH, MASK, kDrop>(p);
  if (int rc = allow_smem(kernel, smem)) return rc;
  dim3 grid((p.S + kFlashTile - 1) / kFlashTile, B * p.H);
  kernel<<<grid, 128, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace vt
