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
// (1.4 and 3.2 GFLOP, 1.4-3.2 us of bf16 tensor-core time) against q, k,
// v, out and the bias in memory (bias (B, 1, S, T) fp32: 2.7 MB at the
// prefill; the NAR's (B, 1, 1, T) key bias is read with stride 0, never
// broadcast in memory): bytes bound it, and the (S, T) score matrix is
// what must never reach device memory. So:
//
// - one block per (b, h, tile of 64 queries), key tiles through shared
//   memory, one online-softmax pass (running max, sum and output per row);
// - bf16 runs flash_attn_mma_kernel on the tensor cores: 4 warps of 16
//   query rows, key tiles of 64, mma.sync m16n8k16 with fp32 accumulation
//   for q.k and for P.V. The P.V product takes p rounded to bf16, which is
//   B7's rounding (p.astype(v.dtype)); B6's TPU kernel keeps p fp32, so at
//   bf16 the port of B6 follows B7's rounding (the sum l is taken over the
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
// Not yet used: skipping fully masked key tiles, cp.async/TMA, wgmma.

#include <math.h>

#include "common.cuh"

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
    const bool k_text = j < mk.s_text;
    bool vis = k_text ? j < x_len : j - mk.s_text < y_len;
    // audio_causal: text queries see text keys, audio queries text keys
    // and keys up to their own position
    if (mk.causal) vis = vis && (k_text || (i >= mk.s_text && j <= i));
    return vis ? s : kNegInf;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, fp32 accumulate). Thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of its warp's 16
// (layouts in common.cuh); DH = 32 * NC.
// ---------------------------------------------------------------------------

constexpr int kMmaQ = 64;   // query rows per block (4 warps x 16)
constexpr int kMmaK = 64;   // keys per tile

using bf16 = __nv_bfloat16;

// A operand over DH = 32 * NC: per 32-wide chunk, thread t holds the 8
// values 8t..8t+7 of rows g and g + 8 (the Dh order common.cuh's
// load_rows64 permutes; B operands use the same order).
template <int NC>
__device__ __forceinline__ void load_rows(uint4 (&af)[2][NC], const bf16* r0,
                                          bool ok0, const bf16* r1, bool ok1,
                                          int t) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    af[0][c] = ok0 ? *reinterpret_cast<const uint4*>(r0 + c * 32 + t * 8)
                   : make_uint4(0, 0, 0, 0);
    af[1][c] = ok1 ? *reinterpret_cast<const uint4*>(r1 + c * 32 + t * 8)
                   : make_uint4(0, 0, 0, 0);
  }
}

// c (16 x 8) += A (16 x DH) . B (8 x DH)^T, row g of B at brow.
template <int NC>
__device__ __forceinline__ void mma_dot(float (&c)[4],
                                        const uint4 (&af)[2][NC],
                                        const bf16* brow, int t) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const uint4 bf = *reinterpret_cast<const uint4*>(brow + ch * 32 + t * 8);
    vt::mma_bf16(c, af[0][ch].x, af[1][ch].x, af[0][ch].y, af[1][ch].y,
                 bf.x, bf.y);
    vt::mma_bf16(c, af[0][ch].z, af[1][ch].z, af[0][ch].w, af[1][ch].w,
                 bf.z, bf.w);
  }
}

// acc (16 x DH) += P (16 x 64) . V (64 x DH), P rounded to bf16 (the eight
// 8-column accumulator tiles mma_dot leaves), V row-major in shared memory.
template <int DH>
__device__ __forceinline__ void mma_pv(float (&acc)[DH / 8][4],
                                       const float (&p)[8][4], const bf16* vm,
                                       int g, int t) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const int j0 = 2 * st, j1 = 2 * st + 1;
    const uint32_t a0 = vt::pack_bf16(p[j0][0], p[j0][1]);
    const uint32_t a1 = vt::pack_bf16(p[j0][2], p[j0][3]);
    const uint32_t a2 = vt::pack_bf16(p[j1][0], p[j1][1]);
    const uint32_t a3 = vt::pack_bf16(p[j1][2], p[j1][3]);
    const int r = st * 16 + t * 2;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const int col = d * 8 + g;
      const uint32_t b0 =
          vt::pack_raw(vm[r * DH + col], vm[(r + 1) * DH + col]);
      const uint32_t b1 =
          vt::pack_raw(vm[(r + 8) * DH + col], vm[(r + 9) * DH + col]);
      vt::mma_bf16(acc[d], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int DH, int MASK>
__global__ void __launch_bounds__(128) flash_attn_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, Strides st, Mask mk, bf16* __restrict__ o,
    int H, int S, int T, float sm_scale) {
  constexpr int NC = DH / 32;
  __shared__ __align__(16) bf16 ks[kMmaK * DH];
  __shared__ __align__(16) bf16 vs[kMmaK * DH];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kMmaQ + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};

  const bf16* qb = q + b * st.qb + h * st.qh;
  uint4 qf[2][NC];
  load_rows<NC>(qf, qb + (long)rows[0] * st.qt, rows[0] < S,
                qb + (long)rows[1] * st.qt, rows[1] < S, t);
  const float* brow[2] = {nullptr, nullptr};
  if (MASK == kBias) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < S)
        brow[r] = mk.bias + b * mk.bsb + h * mk.bsh + (long)rows[r] * mk.bsi;
  }
  const int x_len = MASK == kLens ? mk.x_lens[b] : 0;
  const int y_len = MASK == kLens ? mk.y_lens[b] : 0;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;

  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t0 = 0; t0 < T; t0 += kMmaK) {
    const int n = min(kMmaK, T - t0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kMmaK * DH / 8; idx += 128) {
      const int key = idx / (DH / 8), c8 = idx % (DH / 8);
      const uint4 zero = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(ks)[idx] =
          key < n ? *reinterpret_cast<const uint4*>(
                        kb + (long)(t0 + key) * st.kt + c8 * 8)
                  : zero;
      reinterpret_cast<uint4*>(vs)[idx] =
          key < n ? *reinterpret_cast<const uint4*>(
                        vb + (long)(t0 + key) * st.vt + c8 * 8)
                  : zero;
    }
    __syncthreads();

    // scores of rows g, g + 8 x (8 key tiles x 2 keys), masked; keys past
    // T are absent (-inf)
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
      mma_dot<NC>(p[j], qf, ks + (j * 8 + g) * DH, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kj = t0 + j * 8 + t * 2 + (e & 1);
        p[j][e] = kj >= T ? -INFINITY
                  : rows[r] < S
                      ? masked<MASK>(p[j][e] * sm_scale, brow[r], rows[r],
                                     kj, x_len, y_len, mk)
                      : 0.f;
      }
    }
    // online softmax per row: rescale the running sum and output by
    // exp(m_old - m_new), then p = exp(s - m_new)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mt = fmaxf(mt, fmaxf(p[j][2 * r], p[j][2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[r], mt);   // finite: the tile has a key
      const float alpha = expf(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          p[j][e] = expf(p[j][e] - mn);
          ps += p[j][e];
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[r] = l[r] * alpha + ps;
      m[r] = mn;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }
    mma_pv<DH>(acc, p, vs, g, t);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] < S) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      bf16* op = o + ((long)bh * S + rows[r]) * DH;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        *reinterpret_cast<uint32_t*>(op + d * 8 + t * 2) =
            vt::pack_bf16(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
    }
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
  if (dtype == vt::kBF16) {
    dim3 grid((S + kMmaQ - 1) / kMmaQ, B * H);
    flash_attn_mma_kernel<DH, MASK><<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), st, mk, static_cast<bf16*>(o), H, S, T,
        sm_scale);
    return cudaGetLastError();
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
