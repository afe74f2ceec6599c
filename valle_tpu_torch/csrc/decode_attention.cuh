// One-query attention over a KV cache, reading only the valid keys: the
// shared body of the decode-attention kernels (csrc/decode_attention.cu,
// B10/B11) and of the attention half of csrc/fused_attn_tail.cu (B12).
// B3, over the int8 cache, has a body of its own
// (csrc/decode_attention_int8.cu).
//
// Valid keys of row b: p < x_len (the text) or S <= p <= write_pos (the
// audio so far); the text pad S > p >= x_len and the unwritten tail are
// never read. A block owns one (row, head). The cache row of a key holds
// [K | V] (2 * DH elements): head-major (B, H, T, 2DH) rows, or lane rows
// (B, T, H * 2DH) with head h at [h * 2DH, (h + 1) * 2DH).
//
// What bounds it on the H100: reading the valid K|V bytes once (a few
// flops per byte). So each key row is read with 16-byte loads by a group
// of LPR neighbouring lanes (the K half and the V half side by side; a
// row wider than 32 vectors, fp32 at DH 128, gives each lane VPL of them),
// and every lane keeps kDecUnroll rows in flight. The K lanes hold q in
// registers; a butterfly over the group gives every lane of it the score.
// Each group keeps its own running max, sum and V accumulator (online
// softmax, fp32), and the groups of the block merge in shared memory at the
// end. The result is acc / max(l, 1e-30) in fp32; the caller casts it.
#pragma once

#include "common.cuh"

namespace vt {

constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecUnroll = 4;   // key rows in flight per lane

enum KvLayout { kHeadMajor = 0, kLaneRows = 1 };
// the weight of V in P.V: p (fp32), or p rounded to the cache type (the
// lane kernels feed the rounded p to the MXU)
enum PWeight { kPlainP = 0, kRoundP = 1 };

template <typename CT>
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         float (&out)[16 / sizeof(CT)]) {
  const CT* e = reinterpret_cast<const CT*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(CT)); ++j) out[j] = to_f(e[j]);
}

template <typename CT, int DH>
struct DecGeom {
  static constexpr int E = 16 / sizeof(CT);    // elements per 16-byte load
  static constexpr int VR = 2 * DH / E;        // 16-byte vectors per key row
  static constexpr int LPR = VR < 32 ? VR : 32;  // lanes per key row [K | V]
  static constexpr int VPL = VR / LPR;         // vectors per lane and row
  static constexpr int EL = VPL * E;           // elements per lane and row
  static constexpr int GPW = 32 / LPR;         // key rows per warp and load
  static constexpr int NG = kDecWarps * GPW;   // row groups per block
  static_assert(LPR >= 2 && 32 % LPR == 0 && VR % LPR == 0,
                "a key row must split evenly over the lanes of a warp");
};

// Attention of query (b, h) into res[DH] (shared, fp32, normalized).
// Ends with __syncthreads(), so every thread of the block may read res.
template <typename QT, typename CT, int DH, int LAYOUT, int PW>
__device__ __forceinline__ void decode_attend(
    const QT* __restrict__ q, long q_bstride, const CT* __restrict__ kv,
    const int* __restrict__ x_lens,
    const int* __restrict__ write_pos, int b, int h, int H, int T, int S,
    float sm_scale, float* res) {
  using G = DecGeom<CT, DH>;
  constexpr int E = G::E, LPR = G::LPR, VPL = G::VPL, EL = G::EL;
  constexpr int GPW = G::GPW, NG = G::NG;
  __shared__ float sm_m[NG], sm_l[NG];
  __shared__ float sm_acc[NG][DH];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % LPR;              // lane within its row group
  const int grp = warp * GPW + lane / LPR;
  const bool is_k = gl < LPR / 2;
  const int d0 = (gl % (LPR / 2)) * EL;   // first of this lane's dims

  float qv[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j)
    qv[j] = is_k ? to_f(q[(size_t)b * q_bstride + h * DH + d0 + j]) : 0.f;

  // a key row: head-major rows are 2DH apart, lane rows H * 2DH apart
  const CT* base;
  size_t row_stride;
  if (LAYOUT == kHeadMajor) {
    base = kv + ((size_t)b * H + h) * T * (2 * DH);
    row_stride = 2 * DH;
  } else {
    base = kv + (size_t)b * T * H * (2 * DH) + (size_t)h * (2 * DH);
    row_stride = (size_t)H * (2 * DH);
  }

  const int n_text = min(max(x_lens[b], 0), S);
  const int wp = min(write_pos[b], T - 1);
  const int n = n_text + max(wp - S + 1, 0);   // valid keys of this row

  float m = kNegInf, l = 0.f, acc[EL];
#pragma unroll
  for (int j = 0; j < EL; ++j) acc[j] = 0.f;

  // the loop bound is uniform over the warp, so every lane reaches the
  // shuffles; a lane past the last key loads nothing and updates nothing
  for (int i0 = warp * GPW; i0 < n; i0 += NG * kDecUnroll) {
    uint4 raw[kDecUnroll][VPL];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int i = i0 + u * NG + lane / LPR;
#pragma unroll
      for (int c = 0; c < VPL; ++c) raw[u][c] = make_uint4(0, 0, 0, 0);
      if (i < n) {
        const int t = i < n_text ? i : S + (i - n_text);
        const uint4* src = reinterpret_cast<const uint4*>(
            base + t * row_stride + gl * EL);
#pragma unroll
        for (int c = 0; c < VPL; ++c) raw[u][c] = src[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int i = i0 + u * NG + lane / LPR;
      float x[EL];
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        const CT* e = reinterpret_cast<const CT*>(&raw[u][c]);
#pragma unroll
        for (int j = 0; j < E; ++j) x[c * E + j] = to_f(e[j]);
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < EL; ++j) s += qv[j] * x[j];  // 0 on the V lanes
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (i < n) {
        s = s * sm_scale;
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        float pw = p;
        if constexpr (PW == kRoundP) pw = round_to<CT>(p);
#pragma unroll
        for (int j = 0; j < EL; ++j) acc[j] = acc[j] * alpha + pw * x[j];
        m = m_new;
      }
    }
  }

  if (gl == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
  if (!is_k) {
#pragma unroll
    for (int j = 0; j < EL; ++j) sm_acc[grp][d0 + j] = acc[j];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, sm_m[g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float c = expf(sm_m[g] - mx);
      lsum += sm_l[g] * c;
      a += sm_acc[g][d] * c;
    }
    res[d] = a / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
}

}  // namespace vt
