// Softmax attention with an additive bias or with the mask rebuilt from
// per-row lengths: the ports of the TPU kernels
//   B6 valle_tpu/ops/attention.py:flash_attention (_flash_forward), bias
//      fp32 (B, 1|H, S, T) clamped to NEG_INF = -1e30,
//   B7 valle_tpu/ops/attention.py:flash_attention_lens
//      (_flash_lens_forward), the [text; audio] mask from x_lens, y_lens,
//      S_text and audio_causal (attention.py:185-201).
// out = softmax(q k^T / sqrt(Dh) + mask) v in q's dtype; no dropout, no
// log-sum-exp (the backward recomputes through the plain version, as the
// JAX package's custom VJPs do).
//
// What bounds it on the H100: at the AR prefill (B 8, H 16, S = T = 289,
// Dh 64) and the NAR passes (S = T = 439) the work is 4 B H S T Dh flops
// over the visible pairs (at most 1.4 and 3.2 GFLOP, 1.4-3.2 us of bf16
// tensor-core time) against q, k, v, out and the bias in memory (bias
// (B, 1, S, T) fp32: 2.7 MB at the prefill; the NAR's (B, 1, 1, T) key
// bias is read with stride 0, never broadcast in memory): bytes bound it
// (6.0 and 7.8 us with k and v of the keys some row sees), and the (S, T)
// score matrix is what must never reach device memory. Dh 128 doubles the
// q/k/v/out bytes and the flops. So:
//
// - bf16 (the main path) runs B4's forward body (flash_fwd.cuh,
//   flash_fwd_wgmma<DH, mask, false>): one warpgroup per (b, h, tile of
//   64 queries), ONE online-softmax pass over key tiles of 64, q.k^T a
//   wgmma chain from shared memory and P.V from registers against v read
//   transposed; K/V tiles, and B6's bias tile beside them, by cp.async
//   into a two-stage ring of 128-byte swizzled tiles, so the next tile
//   loads while this one multiplies. The bias is clamped to -1e30 as it
//   is read from shared memory; the NAR's key bias is one row of 64
//   floats a stage. B7 skips the key tiles that no query of the block can
//   see (wholly past x_len / y_len, or above the causal diagonal) and
//   reruns over every tile for a block with a row that sees no key. p is
//   rounded to bf16 before P.V, which is B7's rounding
//   (p.astype(v.dtype)); B6's TPU kernel keeps p fp32, so at bf16 the
//   port of B6 follows B7's rounding (the sum l is taken over the
//   unrounded p in both);
// - fp32 (the verification path) runs flash_attn_f32_kernel on the CUDA
//   cores: DH / 32 threads per query row, each holding 32 of its q and
//   output dims in registers (interleaved, so the threads of a row read
//   neighbouring shared-memory banks); a shuffle over the row's threads
//   sums the dot. p stays fp32, as in B6;
// - q, k, v are read through their strides (the views of the fused
//   in-projection), the bias through its own (stride 0 on broadcast
//   dims, unit key stride), so nothing is copied or padded; queries past
//   S and keys past T are masked here. JAX pads T to a multiple of 128
//   with masked zero keys, so a fully masked row (every key at -1e30,
//   uniform weights) averages over T keys here and over the padded width
//   there: both finite.
//
// Not yet used: TMA and a producer warp, 16-byte bias copies (a prefill
// bias row is 16-byte aligned only when T is a multiple of 4, so the tile
// is copied 4 bytes at a time), skip lists from a bias, two consumer
// warpgroups sharing a K/V tile, overlap of one tile's softmax with the
// next tile's q.k^T.

#include <math.h>

#include "flash_fwd.cuh"

namespace {

using vt::kNegInf;

enum MaskKind { kNone = 0, kBias = 1, kLens = 2 };

struct Mask {
  const float* bias;       // kBias: element (b, h, i, j) at
  long bsb, bsh, bsi;      //   b * bsb + h * bsh + i * bsi + j
  const int* x_lens;       // kLens: text keys < x_len are valid,
  const int* y_lens;       //   audio keys j with j - s_text < y_len
  int s_text, causal;
};

struct Strides {
  long qb, qh, qt, kb, kh, kt, vb, vh, vt;
};

// The masked, scaled score of query i and key j. brow: the bias row of
// query i (kBias); x_len / y_len: the block's row lengths (kLens).
template <int MASK>
__device__ __forceinline__ float masked(float s, const float* brow, int i,
                                        int j, int x_len, int y_len,
                                        const Mask& mk) {
  if constexpr (MASK == kBias) {
    return s + fmaxf(brow[j], kNegInf);
  } else if constexpr (MASK == kLens) {
    return vt::lens_visible(i, j, mk.s_text, x_len, y_len, mk.causal)
               ? s
               : kNegInf;
  } else {
    return s;
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;           // query rows per block
constexpr int kTileFloats = 4096;   // K (and V) tile: kTileFloats / DH keys

template <int DH, int MASK>
__global__ void __launch_bounds__(kRows * DH / 32) flash_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, Strides st, Mask mk, float* __restrict__ o,
    int H, int S, int T, float sm_scale) {
  constexpr int TPR = DH / 32;      // threads per query row
  constexpr int BK = kTileFloats / DH;
  constexpr int NT = kRows * TPR;
  __shared__ float ks[kTileFloats];
  __shared__ float vs[kTileFloats];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i = blockIdx.x * kRows + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool active = i < S;

  // this thread's dims: c * TPR + part
  float qr[32], acc[32];
  const float* qp = q + b * st.qb + h * st.qh + (long)min(i, S - 1) * st.qt;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    qr[c] = active ? qp[c * TPR + part] : 0.f;
    acc[c] = 0.f;
  }
  const float* brow = nullptr;
  if (MASK == kBias && active)
    brow = mk.bias + b * mk.bsb + h * mk.bsh + (long)i * mk.bsi;
  const int x_len = MASK == kLens ? mk.x_lens[b] : 0;
  const int y_len = MASK == kLens ? mk.y_lens[b] : 0;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  float m = -INFINITY, l = 0.f;
  for (int t0 = 0; t0 < T; t0 += BK) {
    const int n = min(BK, T - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * DH; idx += NT) {
      const int key = idx / DH, d = idx % DH;
      ks[idx] = kb[(long)(t0 + key) * st.kt + d];
      vs[idx] = vb[(long)(t0 + key) * st.vt + d];
    }
    __syncthreads();
    // every thread runs the loop (the row's shuffles need all its
    // threads); an inactive row computes on zeros and writes nothing
    for (int j = 0; j < n; ++j) {
      float part_dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 32; ++c)
        part_dot[c & 3] += qr[c] * ks[j * DH + c * TPR + part];
      float dot = (part_dot[0] + part_dot[1]) + (part_dot[2] + part_dot[3]);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float s = active ? masked<MASK>(dot * sm_scale, brow, i, t0 + j,
                                            x_len, y_len, mk)
                             : 0.f;
      float p = 1.f;
      if (s > m) {
        const float alpha = expf(m - s);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] *= alpha;
        m = s;
      } else {
        p = expf(s - m);
      }
      l += p;
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] += p * vs[j * DH + c * TPR + part];
    }
  }
  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* op = o + ((long)bh * S + i) * DH;
#pragma unroll
    for (int c = 0; c < 32; ++c) op[c * TPR + part] = acc[c] * inv;
  }
}

template <int DH, int MASK>
int launch(int dtype, const void* q, const void* k, const void* v,
           const Strides& st, const Mask& mk, void* o, int B, int H, int S,
           int T, float sm_scale, cudaStream_t s) {
  if (dtype == vt::kF32) {
    dim3 grid((S + kRows - 1) / kRows, B * H);
    flash_attn_f32_kernel<DH, MASK><<<grid, kRows * DH / 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), st, mk, static_cast<float*>(o), H, S, T,
        sm_scale);
    return cudaGetLastError();
  }
  if (dtype == vt::kBF16) {   // the wgmma body of flash_fwd.cuh
    using bf16 = __nv_bfloat16;
    vt::FwdParams p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.q_b = st.qb, p.q_h = st.qh, p.q_t = st.qt;
    p.k_b = st.kb, p.k_h = st.kh, p.k_t = st.kt;
    p.v_b = st.vb, p.v_h = st.vh, p.v_t = st.vt;
    p.o = static_cast<bf16*>(o);
    p.H = H, p.S = S, p.T = T, p.sm_scale = sm_scale;
    p.bias = mk.bias, p.bs_b = mk.bsb, p.bs_h = mk.bsh, p.bs_i = mk.bsi;
    p.x_lens = mk.x_lens, p.y_lens = mk.y_lens;
    p.s_text = mk.s_text, p.causal = mk.causal;
    constexpr int kFwd = MASK == kBias   ? vt::kMaskBias
                         : MASK == kLens ? vt::kMaskLens
                                         : vt::kMaskNone;
    return vt::launch_flash_fwd<DH, kFwd, false>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

template <int DH>
int launch_mask(int dtype, const void* q, const void* k, const void* v,
                const Strides& st, const Mask& mk, void* o, int B, int H,
                int S, int T, float sm_scale, cudaStream_t s) {
  if (mk.x_lens != nullptr)
    return launch<DH, kLens>(dtype, q, k, v, st, mk, o, B, H, S, T, sm_scale,
                             s);
  if (mk.bias != nullptr)
    return launch<DH, kBias>(dtype, q, k, v, st, mk, o, B, H, S, T, sm_scale,
                             s);
  return launch<DH, kNone>(dtype, q, k, v, st, mk, o, B, H, S, T, sm_scale,
                           s);
}

}  // namespace

// q, k, v: (B, H, S|T, dh) through the given (b, h, t) strides in
// elements (unit feature stride); bias: fp32 through (bsb, bsh, bsi) and a
// unit key stride, or null; x_lens / y_lens (B,) int32 select B7's mask
// instead; o: contiguous (B, H, S, dh) in `dtype`.
extern "C" int vt_flash_attention(
    int dtype, int dh, const void* q, const void* k, const void* v, long qsb,
    long qsh, long qst, long ksb, long ksh, long kst, long vsb, long vsh,
    long vst, const float* bias, long bsb, long bsh, long bsi,
    const int* x_lens, const int* y_lens, int s_text, int causal, void* o,
    int B, int H, int S, int T, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0) return cudaErrorInvalidValue;
  const Strides st{qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  const Mask mk{bias, bsb, bsh, bsi, x_lens, y_lens, s_text, causal};
  if (dh == 64)
    return launch_mask<64>(dtype, q, k, v, st, mk, o, B, H, S, T, sm_scale,
                           s);
  if (dh == 128)
    return launch_mask<128>(dtype, q, k, v, st, mk, o, B, H, S, T, sm_scale,
                            s);
  return cudaErrorInvalidValue;
}
