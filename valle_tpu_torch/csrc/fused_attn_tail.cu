// Attention + head-wise out-projection + residual + LayerNorm2 of one AR
// decode layer: the port of the TPU kernel
// valle_tpu/ops/fused_attn_tail.py:fused_attn_tail (B12, decode mode
// "mega"). The FFN that completes the layer runs on the dense kernels of
// csrc/fused_dense.cu (lin1 + activation, lin2 + residual).
//
// What it fuses, and what bounds it on the H100: the TPU kernel keeps each
// head's attention output in VMEM and multiplies it by that head's rows of
// out_w, so the (H, B, Dh) -> (B, D) head merge never reaches HBM. Here
// attn_outproj_kernel does the same per (row, head) block: the attention
// of csrc/decode_attention.cuh (lane-row cache, p rounded to the cache type
// as the TPU kernel does) lands in shared memory, rounded to the compute
// type, and the block multiplies it by out_w[:, h * Dh:(h + 1) * Dh] into
// fp32 partial sums part (B, H, D). The bytes that bound it are the valid
// K|V rows (as B11) plus out_w, which every row's blocks read again (from
// L2 after the first). LN2 needs the whole row, and a GPU has no ordered
// grid, so tail_combine_kernel (a block per row) then sums the partials in
// head order 0..H-1 (the TPU kernel's order, and no atomics: fp32 results
// do not depend on the run), rounds, adds b_out and the residual, and
// normalizes.
//
// Not yet used: the out-projection on the tensor cores, a cluster that
// keeps the partials on chip, TMA.

#include "decode_attention.cuh"

namespace {

using vt::from_f;
using vt::kDecThreads;
using vt::kDecWarps;
using vt::round_to;
using vt::to_f;

constexpr int kOutUnroll = 8;     // out_w vectors in flight per lane
constexpr int kCombineThreads = 256;

template <typename DT, int DH>
__global__ void __launch_bounds__(kDecThreads) attn_outproj_kernel(
    const DT* __restrict__ q, long q_bstride, const DT* __restrict__ kv,
    const int* __restrict__ x_lens, const int* __restrict__ write_pos,
    const DT* __restrict__ out_w, float* __restrict__ part, int H, int T,
    int S, float sm_scale) {
  __shared__ float res[DH];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  vt::decode_attend<DT, DT, DH, vt::kLaneRows, vt::kRoundP>(
      q, q_bstride, kv, nullptr, x_lens, write_pos, b, h, H, T, S, sm_scale,
      res);

  // part[b, h, n] = sum_d attn[d] * out_w[n, h * DH + d]: LPN lanes read
  // the DH weights of one output column with 16-byte loads
  constexpr int E = 16 / sizeof(DT);
  constexpr int LPN = DH / E;
  constexpr int NPW = 32 / LPN;        // columns per warp and load
  static_assert(LPN >= 2 && 32 % LPN == 0, "DH must split over the lanes");
  const int D = H * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % LPN, col = lane / LPN;
  float a[E];
#pragma unroll
  for (int j = 0; j < E; ++j) a[j] = round_to<DT>(res[gl * E + j]);
  const DT* wbase = out_w + (size_t)h * DH + gl * E;
  float* pout = part + ((size_t)b * H + h) * D;
  for (int n0 = warp * NPW; n0 < D; n0 += kDecWarps * NPW * kOutUnroll) {
    uint4 raw[kOutUnroll];
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {
      const int n = n0 + u * kDecWarps * NPW + col;
      raw[u] = n < D ? *reinterpret_cast<const uint4*>(wbase + (size_t)n * D)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {
      const int n = n0 + u * kDecWarps * NPW + col;
      float w[E];
      vt::unpack16<DT>(raw[u], w);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) s += a[j] * w[j];
#pragma unroll
      for (int o = 1; o < LPN; o <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (gl == 0 && n < D) pout[n] = s;
    }
  }
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = vt::warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += scratch[w];
  __syncthreads();   // scratch may be reused
  return t;
}

// h1 = resid + round(round(sum_h part) + b_out); nrm = LN2(h1). Rounding as
// the TPU kernel: the fp32 sum cast to DT, the bias added in DT.
template <typename DT>
__global__ void __launch_bounds__(kCombineThreads) tail_combine_kernel(
    const float* __restrict__ part, int H, int D, const DT* __restrict__ out_b,
    const DT* __restrict__ resid, const DT* __restrict__ ln_w,
    const DT* __restrict__ ln_b, DT* __restrict__ h1, DT* __restrict__ nrm,
    float eps) {
  extern __shared__ float row[];   // D values of h1
  __shared__ float scratch[kCombineThreads / 32];
  const int b = blockIdx.x;
  const float* pb = part + (size_t)b * H * D;
  float sum = 0.f;
  for (int n = threadIdx.x; n < D; n += blockDim.x) {
    float y = pb[n];
    for (int hh = 1; hh < H; ++hh) y += pb[(size_t)hh * D + n];
    y = round_to<DT>(y);
    y = round_to<DT>(y + to_f(out_b[n]));
    const float v = round_to<DT>(to_f(resid[(size_t)b * D + n]) + y);
    h1[(size_t)b * D + n] = from_f<DT>(v);
    row[n] = v;
    sum += v;
  }
  const float mean = block_sum(sum, scratch) / D;
  float var = 0.f;
  for (int n = threadIdx.x; n < D; n += blockDim.x)
    var += (row[n] - mean) * (row[n] - mean);
  const float rstd = rsqrtf(block_sum(var, scratch) / D + eps);
  for (int n = threadIdx.x; n < D; n += blockDim.x)
    nrm[(size_t)b * D + n] =
        from_f<DT>((row[n] - mean) * rstd * to_f(ln_w[n]) + to_f(ln_b[n]));
}

template <typename DT>
int launch_outproj(int dh, const void* q, long q_bstride, const void* kv,
                   const int* x_lens, const int* write_pos, const void* out_w,
                   float* part, int B, int H, int T, int S, float sm_scale,
                   cudaStream_t s) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
#define VT_ARGS                                                            \
  static_cast<const DT*>(q), q_bstride, static_cast<const DT*>(kv), x_lens,  \
      write_pos, static_cast<const DT*>(out_w), part, H, T, S, sm_scale
  if (dh == 64)
    attn_outproj_kernel<DT, 64><<<B * H, kDecThreads, 0, s>>>(VT_ARGS);
  else if (dh == 128)
    attn_outproj_kernel<DT, 128><<<B * H, kDecThreads, 0, s>>>(VT_ARGS);
  else if (dh == 32)
    attn_outproj_kernel<DT, 32><<<B * H, kDecThreads, 0, s>>>(VT_ARGS);
  else
    return cudaErrorInvalidValue;
#undef VT_ARGS
  return cudaGetLastError();
}

template <typename DT>
int launch_combine(const float* part, int B, int H, int D, const void* out_b,
                   const void* resid, const void* ln_w, const void* ln_b,
                   void* h1, void* nrm, float eps, cudaStream_t s) {
  const size_t smem = (size_t)D * sizeof(float);
  if (B <= 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  tail_combine_kernel<DT><<<B, kCombineThreads, smem, s>>>(
      part, H, D, static_cast<const DT*>(out_b), static_cast<const DT*>(resid),
      static_cast<const DT*>(ln_w), static_cast<const DT*>(ln_b),
      static_cast<DT*>(h1), static_cast<DT*>(nrm), eps);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, dh) rows q_bstride apart; kv lane rows (B, T, H * 2dh); out_w
// (D, D) row-major (out, in), D = H * dh; part (B, H, D) fp32 out.
extern "C" int vt_attn_outproj(int dtype, int dh, const void* q,
                               long q_bstride, const void* kv,
                               const int* x_lens, const int* write_pos,
                               const void* out_w, float* part, int B, int H,
                               int T, int S, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch_outproj<float>(dh, q, q_bstride, kv, x_lens, write_pos,
                                 out_w, part, B, H, T, S, sm_scale, s);
  if (dtype == vt::kBF16)
    return launch_outproj<__nv_bfloat16>(dh, q, q_bstride, kv, x_lens,
                                         write_pos, out_w, part, B, H, T, S,
                                         sm_scale, s);
  return cudaErrorInvalidValue;
}

// part (B, H, D) fp32 -> h1 (B, D) and nrm = LN2(h1) (B, D), in `dtype`.
extern "C" int vt_attn_tail_combine(int dtype, const float* part, int B,
                                    int H, int D, const void* out_b,
                                    const void* resid, const void* ln_w,
                                    const void* ln_b, void* h1, void* nrm,
                                    float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch_combine<float>(part, B, H, D, out_b, resid, ln_w, ln_b, h1,
                                 nrm, eps, s);
  if (dtype == vt::kBF16)
    return launch_combine<__nv_bfloat16>(part, B, H, D, out_b, resid, ln_w,
                                         ln_b, h1, nrm, eps, s);
  return cudaErrorInvalidValue;
}
