// One-query decode attention over a TRANSPOSED KV cache, K and V each
// (B, H, Dh, T): the port of the TPU kernels
//   B8 valle_tpu/ops/decode_attention.py:decode_attention (one row per
//      program, blocks of 256 keys up to the row's write position),
//   B9 valle_tpu/ops/decode_attention_grouped.py:decode_attention_grouped
//      (8 rows per program, block-diagonal dots, blocks of 128 keys up to
//      the group's largest write position).
// Both compute, per (row b, head h), softmax over the valid keys of
// q . K / sqrt(Dh) times V, in fp32 with p unrounded; key p is valid iff
// p < x_len (the text) or S <= p <= write_pos (the audio so far). The
// 8-row grouping and the block-diagonal dots of B9 exist for the TPU's
// matrix unit and give each row the same result, so one kernel serves
// both; each mode keeps its wrapper and its launch count.
//
// What bounds it on the H100: reading the valid K and V once (at the bench
// step, B 32, H 16, Dh 64, ~365 valid keys a row, ~48 MB of bf16 per
// layer, ~14 us at 3.35 TB/s). In this layout the keys of one d row are
// contiguous, so a 16-byte load takes E neighbouring keys of one row (E =
// 8 in bf16, 4 in fp32): a "key vector". The design:
//
// - a block per (row, head); DH / 8 warps, warp w owning the 8 d rows
//   8w .. 8w + 7 and lane l the key vector l of each chunk of 32 vectors.
//   A thread loads its 8 K vectors and 8 V vectors of a chunk at once (16
//   loads in flight, each warp load 512 contiguous bytes), q's 8 values in
//   registers: no Dh-sized register array, no spill.
// - the valid keys are walked as vectors: the text's [0, x_len) rounded up
//   to a vector, then the audio's [S, write_pos] from the vector holding
//   S; the pad and the unwritten tail are never read, and keys of a
//   boundary vector outside the two ranges are masked.
// - per chunk: each thread's 8-row partial scores of its E keys go to
//   shared memory; the block sums the DH / 8 partials of each key, takes
//   the chunk's max (online softmax: the running sums scale by
//   exp(m_old - m_new)) and writes p; each thread then adds p times its V
//   vectors into 8 fp32 accumulators. The next chunk's K loads are issued
//   as soon as this chunk's partial scores are taken, its V loads once P.V
//   is done, so they fly during the block's reductions. At Dh 128 (512
//   threads, one block an SM) a chunk's V loads wait for its scores and
//   the next K for P.V instead, which measured faster there (and slower
//   at Dh 32/64).
// - the end: a butterfly of shuffles sums each warp's 32 lanes (8 values
//   a lane, 9 shuffles), l is summed over the block in warp order; all
//   sums run in a fixed order (no atomics), so two launches give the same
//   bits.
// - rows of T % E != 0 (not 16-byte aligned) take the same path with
//   element loads (VEC = false).

#include "common.cuh"

namespace {

using vt::from_f;
using vt::kNegInf;
using vt::to_f;

constexpr int kRowsPerWarp = 8;   // d rows a warp owns
constexpr int kChunk = 32;        // key vectors a chunk: one per lane

// The E keys t0 .. t0 + E - 1 of one d row as a packed 16-byte vector,
// zeros where !ok (or, element-wise, past T).
template <typename CT, bool VEC>
__device__ __forceinline__ uint4 load_keys(const CT* __restrict__ row,
                                           int t0, int T, bool ok) {
  if (!ok) return make_uint4(0, 0, 0, 0);
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(row + t0));
  } else {
    constexpr int E = 16 / sizeof(CT);
    uint4 r;
    CT* e = reinterpret_cast<CT*>(&r);
#pragma unroll
    for (int j = 0; j < E; ++j)
      e[j] = t0 + j < T ? row[t0 + j] : from_f<CT>(0.f);
    return r;
  }
}

// After it, lane l holds the warp's sum of acc[j], j = 4 * bit4(l) +
// 2 * bit3(l) + bit2(l), in acc[0] (each of the 8 values is reduced by 4
// lanes: halving steps at offsets 16, 8, 4, then plain sums at 2, 1).
__device__ __forceinline__ void warp_sum8(float (&acc)[8], int lane) {
#pragma unroll
  for (int o = 16, n = 8; o >= 4; o >>= 1, n >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int d = 0; d < n / 2; ++d) {
      const float send = up ? acc[d] : acc[d + n / 2];
      const float keep = up ? acc[d + n / 2] : acc[d];
      acc[d] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

__device__ __forceinline__ int sum8_index(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

template <int DH>
constexpr int threads_for() {
  return DH / kRowsPerWarp * 32;
}

template <typename CT, int DH, bool VEC>
__global__ void __launch_bounds__(DH / kRowsPerWarp * 32, DH == 128 ? 1 : 2)
    decode_attention_t_kernel(const CT* __restrict__ q, long q_bstride,
                              const CT* __restrict__ kc,
                              const CT* __restrict__ vc,
                              const int* __restrict__ x_lens,
                              const int* __restrict__ write_pos,
                              CT* __restrict__ out, int H, int T, int S,
                              float sm_scale) {
  constexpr int E = 16 / sizeof(CT);
  constexpr int NW = DH / kRowsPerWarp, NT = NW * 32;
  constexpr int CK = kChunk * E;               // keys a chunk
  constexpr int KPT = (CK + NT - 1) / NT;      // keys a thread scores
  __shared__ float sp[NW][CK];                 // partial scores per warp
  __shared__ float ps[CK];                     // p of the chunk's keys
  __shared__ float red[2][NW];                 // chunk max, double-buffered
  __shared__ float lsum[NW];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = warp * kRowsPerWarp;

  float qv[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    qv[i] = to_f(q[(size_t)b * q_bstride + h * DH + d0 + i]);
  const CT* kb = kc + ((size_t)bh * DH + d0) * T;
  const CT* vb = vc + ((size_t)bh * DH + d0) * T;

  // the row's key vectors: text vectors 0 .. ntv - 1, then the audio's
  // from the vector holding S to the one holding write_pos
  const int n_text = min(max(x_lens[b], 0), min(S, T));
  const int wp = min(write_pos[b], T - 1);
  const int ntv = (n_text + E - 1) / E;
  const int a0 = S / E;
  const int nv = ntv + (wp >= S ? wp / E - a0 + 1 : 0);
  auto first_key = [&](int i) { return (i < ntv ? i : a0 + i - ntv) * E; };
  auto valid = [&](int i, int t) {
    return i < nv && (i < ntv ? t < n_text : (t >= S && t <= wp));
  };
  auto fetch = [&](uint4 (&r)[kRowsPerWarp], const CT* base, int c0) {
    const int i = c0 + lane;
    const bool ok = i < nv;
    const int t0 = ok ? first_key(i) : 0;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      r[j] = load_keys<CT, VEC>(base + (size_t)j * T, t0, T, ok);
  };

  float m = kNegInf, l = 0.f, acc[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) acc[j] = 0.f;
  constexpr bool kLateV = DH == 128;   // V after the scores (see above)
  uint4 kr[kRowsPerWarp], vr[kRowsPerWarp];
  if (nv > 0) {
    fetch(kr, kb, 0);
    if (!kLateV) fetch(vr, vb, 0);
  }
  int buf = 0;
  for (int c0 = 0; c0 < nv; c0 += kChunk, buf ^= 1) {
    const bool more = c0 + kChunk < nv;
    // this warp's 8 rows of the E scores of this lane's vector
    float s8[E];
#pragma unroll
    for (int e = 0; e < E; ++e) s8[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const CT* x = reinterpret_cast<const CT*>(&kr[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) s8[e] += qv[j] * to_f(x[e]);
    }
    if (kLateV)
      fetch(vr, vb, c0);
    else if (more)
      fetch(kr, kb, c0 + kChunk);
#pragma unroll
    for (int e = 0; e < E; ++e) sp[warp][lane * E + e] = s8[e];
    __syncthreads();

    // each key's score, the chunk's max
    float s[KPT], mx = kNegInf;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int k = tid + u * NT;
      s[u] = kNegInf;
      if (k < CK) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) a += sp[w][k];
        const int i = c0 + k / E;
        if (valid(i, first_key(i) + k % E)) s[u] = a * sm_scale;
      }
      mx = fmaxf(mx, s[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[buf][warp] = mx;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int w = 0; w < NW; ++w) m_new = fmaxf(m_new, red[buf][w]);
    const float alpha = expf(m - m_new);
    float lp = 0.f;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int k = tid + u * NT;
      if (k < CK) {
        const float p = s[u] > kNegInf ? expf(s[u] - m_new) : 0.f;
        ps[k] = p;
        lp += p;
      }
    }
    l = l * alpha + lp;
    m = m_new;
    __syncthreads();

    // P.V over this lane's vector
    float pe[E];
#pragma unroll
    for (int e = 0; e < E; ++e) pe[e] = ps[lane * E + e];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const CT* x = reinterpret_cast<const CT*>(&vr[j]);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) a += pe[e] * to_f(x[e]);
      acc[j] = acc[j] * alpha + a;
    }
    if (more) {
      if (kLateV)
        fetch(kr, kb, c0 + kChunk);
      else
        fetch(vr, vb, c0 + kChunk);
    }
  }

  warp_sum8(acc, lane);
  const float lw = vt::warp_sum(l);
  if (lane == 0) lsum[warp] = lw;
  __syncthreads();
  float lt = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) lt += lsum[w];
  if ((lane & 3) == 0)
    out[(size_t)bh * DH + d0 + sum8_index(lane)] =
        from_f<CT>(acc[0] / fmaxf(lt, 1e-30f));
}

template <typename CT, int DH>
int launch_dh(const CT* q, long q_bstride, const CT* kc, const CT* vc,
              const int* x_lens, const int* write_pos, CT* out, int B, int H,
              int T, int S, float sm_scale, cudaStream_t s) {
  constexpr int E = 16 / sizeof(CT);
  const bool vec = T % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(kc) |
                     reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
  if (vec)
    decode_attention_t_kernel<CT, DH, true>
        <<<B * H, threads_for<DH>(), 0, s>>>(q, q_bstride, kc, vc, x_lens,
                                             write_pos, out, H, T, S,
                                             sm_scale);
  else
    decode_attention_t_kernel<CT, DH, false>
        <<<B * H, threads_for<DH>(), 0, s>>>(q, q_bstride, kc, vc, x_lens,
                                             write_pos, out, H, T, S,
                                             sm_scale);
  return cudaGetLastError();
}

template <typename CT>
int launch(int dh, const void* q, long q_bstride, const void* kc,
           const void* vc, const int* x_lens, const int* write_pos, void* out,
           int B, int H, int T, int S, float sm_scale, cudaStream_t s) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
#define VT_ARGS                                                           \
  static_cast<const CT*>(q), q_bstride, static_cast<const CT*>(kc),       \
      static_cast<const CT*>(vc), x_lens, write_pos, static_cast<CT*>(out), \
      B, H, T, S, sm_scale, s
  if (dh == 64) return launch_dh<CT, 64>(VT_ARGS);
  if (dh == 128) return launch_dh<CT, 128>(VT_ARGS);
  if (dh == 32) return launch_dh<CT, 32>(VT_ARGS);
#undef VT_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, dh) rows q_bstride apart, k / v caches (B, H, dh, T) and out
// (B, H, dh), all in `dtype`.
extern "C" int vt_decode_attention_t(int dtype, int dh, const void* q,
                                     long q_bstride, const void* kc,
                                     const void* vc, const int* x_lens,
                                     const int* write_pos, void* out, int B,
                                     int H, int T, int S, float sm_scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch<float>(dh, q, q_bstride, kc, vc, x_lens, write_pos, out, B,
                         H, T, S, sm_scale, s);
  if (dtype == vt::kBF16)
    return launch<__nv_bfloat16>(dh, q, q_bstride, kc, vc, x_lens, write_pos,
                                 out, B, H, T, S, sm_scale, s);
  return cudaErrorInvalidValue;
}
