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
// layer, ~14 us at 3.35 TB/s). In this layout a key's Dh values are T
// elements apart, so a key row cannot be read with wide loads (the body of
// decode_attention.cuh does not apply). Instead:
//
// - one block of 128 threads per (row, head), a thread per key: thread i
//   takes the row's valid keys i, i + 128, ... (the text [0, x_len) then
//   the audio [S, write_pos]; the pad and the unwritten tail are never
//   read), so neighbouring threads read neighbouring t and every load of
//   K[d][t] and V[d][t] is coalesced across the warp;
// - q sits in shared memory (fp32); each thread keeps its own online
//   softmax (max, sum) and DH fp32 accumulators in registers;
// - the threads merge at the end: the block's max through warp shuffles
//   and shared memory; every thread scales its accumulators, each warp
//   sums its 32 threads' by a butterfly of shuffles that halves the dims
//   a lane keeps at each step (lane l ends with dims l DH/32 .. + DH/32 -
//   1: DH - DH/32 shuffles a thread, not 5 DH), and the 4 warps' partial
//   rows meet in shared memory (2 KB at Dh 128), summed in a fixed order
//   (no atomics), so the result does not change from run to run.
// - Dh 32, 64 and 128; a thread's DH accumulators are registers.
//
// Not yet used: wide loads across neighbouring keys, a split over keys
// for small batches.

#include "common.cuh"

namespace {

using vt::from_f;
using vt::kNegInf;
using vt::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One step of the warp's butterfly over acc[0 .. N): at lane offset O a
// lane keeps the upper half when (lane & O), the lower half otherwise, and
// adds the partner's copy of the half it keeps into acc[0 .. N / 2); then
// the next step at O / 2. Compile-time indices keep acc in registers.
template <int DH, int N, int O>
__device__ __forceinline__ void butterfly(float (&acc)[DH], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int d = 0; d < N / 2; ++d) {
    const float send = up ? acc[d] : acc[d + N / 2];
    const float keep = up ? acc[d + N / 2] : acc[d];
    acc[d] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) butterfly<DH, N / 2, O / 2>(acc, lane);
}

template <typename CT, int DH>
__global__ void __launch_bounds__(kThreads) decode_attention_t_kernel(
    const CT* __restrict__ q, long q_bstride, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const int* __restrict__ x_lens,
    const int* __restrict__ write_pos, CT* __restrict__ out, int H, int T,
    int S, float sm_scale) {
  __shared__ float qs[DH];
  __shared__ float sm_max[kWarps], sm_sum[kWarps];
  __shared__ float sm_acc[kWarps][DH];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < DH; d += kThreads)
    qs[d] = to_f(q[(size_t)b * q_bstride + h * DH + d]);
  __syncthreads();

  const CT* kb = kc + ((size_t)b * H + h) * DH * T;
  const CT* vb = vc + ((size_t)b * H + h) * DH * T;
  const int n_text = min(max(x_lens[b], 0), S);
  const int wp = min(write_pos[b], T - 1);
  const int n = n_text + max(wp - S + 1, 0);   // valid keys of this row

  float m = kNegInf, l = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const int t = i < n_text ? i : S + (i - n_text);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < DH; ++d)
      part[d & 3] += qs[d] * to_f(kb[(size_t)d * T + t]);
    const float s = ((part[0] + part[1]) + (part[2] + part[3])) * sm_scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      acc[d] = acc[d] * alpha + p * to_f(vb[(size_t)d * T + t]);
    m = m_new;
  }

  // the block's max, then each thread's share scaled to it
  float mx = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) sm_max[warp] = mx;
  __syncthreads();
  mx = sm_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_max[w]);
  const float c = expf(m - mx);
  const float ls = vt::warp_sum(l * c);
  if (lane == 0) sm_sum[warp] = ls;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] *= c;
  butterfly<DH, DH, 16>(acc, lane);
  constexpr int kPer = DH / 32;   // dims a lane holds: lane * kPer + d
#pragma unroll
  for (int d = 0; d < kPer; ++d) sm_acc[warp][lane * kPer + d] = acc[d];
  __syncthreads();
  for (int d = tid; d < DH; d += kThreads) {
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lsum += sm_sum[w];
      a += sm_acc[w][d];
    }
    out[((size_t)b * H + h) * DH + d] = from_f<CT>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename CT>
int launch(int dh, const void* q, long q_bstride, const void* kc,
           const void* vc, const int* x_lens, const int* write_pos, void* out,
           int B, int H, int T, int S, float sm_scale, cudaStream_t s) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
#define VT_ARGS                                                           \
  static_cast<const CT*>(q), q_bstride, static_cast<const CT*>(kc),       \
      static_cast<const CT*>(vc), x_lens, write_pos, static_cast<CT*>(out), \
      H, T, S, sm_scale
  if (dh == 64)
    decode_attention_t_kernel<CT, 64><<<B * H, kThreads, 0, s>>>(VT_ARGS);
  else if (dh == 128)
    decode_attention_t_kernel<CT, 128><<<B * H, kThreads, 0, s>>>(VT_ARGS);
  else if (dh == 32)
    decode_attention_t_kernel<CT, 32><<<B * H, kThreads, 0, s>>>(VT_ARGS);
  else
    return cudaErrorInvalidValue;
#undef VT_ARGS
  return cudaGetLastError();
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
