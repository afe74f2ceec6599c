// One-query decode attention over a KV cache: the ports of the TPU kernels
//   B10 valle_tpu/ops/decode_attention_kv.py:decode_attention_kv
//       (combined K|V cache (B, H, T, 2DH) in the compute type, p in fp32),
//   B11 valle_tpu/ops/decode_attention_lanes.py:decode_attention_lanes
//       (lane rows (B, T, H * 2DH), p rounded to the cache type for P.V).
//
// What bounds them on the H100: the valid K|V bytes, read once (at the
// bench shape, B 32, H 16, ~365 valid keys a row, ~48 MB of bf16 per layer,
// ~14 us at 3.35 TB/s). The TPU kernels' 8-row groups, block-diagonal
// masked dots over a shared buffer and zero-padded [Q | 0] operands exist
// for the TPU's matrix unit and VMEM; here one block per (row, head) reads
// only its own row's valid keys (csrc/decode_attention.cuh), so it takes
// any batch size and no row waits for its group's longest cache.
//
// Not yet used: a split over keys (flash-decoding) for small batches, TMA.
// B3, over the int8 cache, is csrc/decode_attention_int8.cu.

#include "decode_attention.cuh"

namespace {

using vt::from_f;
using vt::kDecThreads;

template <typename QT, typename CT, int DH, int LAYOUT, int PW>
__global__ void __launch_bounds__(kDecThreads) decode_attention_kernel(
    const QT* __restrict__ q, long q_bstride, const CT* __restrict__ kv,
    const int* __restrict__ x_lens, const int* __restrict__ write_pos,
    QT* __restrict__ out, int H, int T, int S, float sm_scale) {
  __shared__ float res[DH];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  vt::decode_attend<QT, CT, DH, LAYOUT, PW>(q, q_bstride, kv, x_lens,
                                            write_pos, b, h, H, T, S,
                                            sm_scale, res);
  for (int d = threadIdx.x; d < DH; d += blockDim.x)
    out[((size_t)b * H + h) * DH + d] = from_f<QT>(res[d]);
}

template <typename QT, typename CT, int LAYOUT, int PW>
int launch(int dh, const void* q, long q_bstride, const void* kv,
           const int* x_lens, const int* write_pos, void* out, int B, int H,
           int T, int S, float sm_scale, cudaStream_t s) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
#define VT_ARGS                                                          \
  static_cast<const QT*>(q), q_bstride, static_cast<const CT*>(kv),      \
      x_lens, write_pos, static_cast<QT*>(out), H, T, S, sm_scale
  if (dh == 64)
    decode_attention_kernel<QT, CT, 64, LAYOUT, PW>
        <<<B * H, kDecThreads, 0, s>>>(VT_ARGS);
  else if (dh == 128)
    decode_attention_kernel<QT, CT, 128, LAYOUT, PW>
        <<<B * H, kDecThreads, 0, s>>>(VT_ARGS);
  else if (dh == 32)
    decode_attention_kernel<QT, CT, 32, LAYOUT, PW>
        <<<B * H, kDecThreads, 0, s>>>(VT_ARGS);
  else
    return cudaErrorInvalidValue;
#undef VT_ARGS
  return cudaGetLastError();
}

}  // namespace

// B10: q (B, H, DH) rows q_bstride apart and the head-major cache, in
// `dtype`.
extern "C" int vt_decode_attention_kv(int dtype, int dh, const void* q,
                                      long q_bstride, const void* kv,
                                      const int* x_lens, const int* write_pos,
                                      void* out, int B, int H, int T, int S,
                                      float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VT_ARGS dh, q, q_bstride, kv, x_lens, write_pos, out, B, H, T, S, \
                sm_scale, s
  if (dtype == vt::kF32)
    return launch<float, float, vt::kHeadMajor, vt::kPlainP>(VT_ARGS);
  if (dtype == vt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, vt::kHeadMajor,
                  vt::kPlainP>(VT_ARGS);
  return cudaErrorInvalidValue;
}

// B11: q and the lane-row cache in `dtype`.
extern "C" int vt_decode_attention_lanes(int dtype, int dh, const void* q,
                                         long q_bstride, const void* kv,
                                         const int* x_lens,
                                         const int* write_pos, void* out,
                                         int B, int H, int T, int S,
                                         float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch<float, float, vt::kLaneRows, vt::kRoundP>(VT_ARGS);
  if (dtype == vt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, vt::kLaneRows,
                  vt::kRoundP>(VT_ARGS);
  return cudaErrorInvalidValue;
#undef VT_ARGS
}
