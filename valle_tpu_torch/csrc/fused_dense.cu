// Dense half of one AR decode layer: the port of the TPU kernels
// valle_tpu/ops/fused_dense.py:_ln_qkv_kernel (fused_ln_qkv) and
// valle_tpu/ops/fused_dense.py:_tail_kernel (fused_tail).
//
// What bounds it on the H100: at decode shapes (B <= 64 rows, one token
// each) every product is a skinny GEMM whose cost is reading the weights
// once: W_in is 6 MiB in bf16 per layer at D = 1024, the tail's
// out-proj + lin1 + lin2 another 18 MiB, against 2*B*D*N operations, far
// below the card's ~295 operations per byte. So the design reads each
// weight byte from device memory once, keeps many weight loads in flight,
// and does everything else on chip:
//
// - ln_rows_kernel normalizes each input row once (fp32 statistics, output
//   cast to the activation dtype, as ops/fused_dense.py:34-39) into a
//   small scratch buffer, instead of every GEMM block recomputing it.
// - dense_mma_kernel (bf16 activations) computes out[b, n] = epi(sum_k
//   x[b, k] * W[n, k]) for W in PyTorch's (N, K) layout on the tensor
//   cores (mma.sync m16n8k16, bf16 in, fp32 accumulate). A block owns
//   8 * NT output columns; its 8 warps split K into interleaved 32-wide
//   chunks, so the block reads x once and each weight byte once, and
//   reduce their partial sums through shared memory. Each lane loads one
//   16-byte vector per weight row and 32-wide chunk (8 consecutive k); the
//   mma's k order is permuted to match (any permutation applied to both
//   operands leaves the sum unchanged), so no shuffles are needed.
// - dense_rows_kernel (fp32 activations, the verification path) does the
//   same on the CUDA cores: 2 columns per warp, tiles of 8 rows staged in
//   shared memory, 4 weight vectors in flight per lane.
// - Products accumulate in fp32. Int8 weights are converted exactly and
//   their per-output-channel scale multiplies the fp32 sum before the cast
//   back, then the bias is added (the TPU kernel's _mms order).
// - LN2 needs the whole row of h1 = r + a W_out + b_out: a dependency
//   across blocks that the TPU's single sequential program did not have.
//   fused_tail is therefore four launches: out-proj + residual, LN2,
//   lin1 + activation, lin2 + residual. A later change may fuse them with
//   a cluster or a grid barrier.
//
// Not yet used: wgmma, TMA, persistent blocks, a cluster-fused tail.

#include <type_traits>

#include "common.cuh"

namespace {

using vt::from_f;
using vt::mma_bf16;
using vt::round_to;
using vt::to_f;

constexpr int kCols = 2;       // output columns per warp
constexpr int kPrefetch = 4;   // weight vectors in flight per lane and column
constexpr int kRows = 8;       // accumulator rows per lane (CUDA cores)
constexpr int kSmemBudget = 128 * 1024;

enum Epi { kEpiBias = 0, kEpiRelu = 1, kEpiGelu = 2, kEpiResid = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// Converts one 16-byte vector of T to floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&out)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < (int)(16 / sizeof(T)); ++j) out[j] = to_f(e[j]);
}

// One warp per row: LayerNorm in fp32, output cast to T.
template <typename T>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const T* __restrict__ x, int B, int K, const T* __restrict__ ln_w,
    const T* __restrict__ ln_b, T* __restrict__ out, float eps) {
  constexpr int TV = 16 / sizeof(T);
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const T* xr = x + (size_t)row * K;
  float v[TV];
  float s = 0.f;
  for (int k = lane * TV; k < K; k += 32 * TV) {
    unpack<T>(*reinterpret_cast<const uint4*>(xr + k), v);
#pragma unroll
    for (int j = 0; j < TV; ++j) s += v[j];
  }
  const float mean = vt::warp_sum(s) / K;
  float var = 0.f;
  for (int k = lane * TV; k < K; k += 32 * TV) {
    unpack<T>(*reinterpret_cast<const uint4*>(xr + k), v);
#pragma unroll
    for (int j = 0; j < TV; ++j) var += (v[j] - mean) * (v[j] - mean);
  }
  const float rstd = rsqrtf(vt::warp_sum(var) / K + eps);
  for (int k = lane * TV; k < K; k += 32 * TV) {
    float w[TV], b[TV];
    unpack<T>(*reinterpret_cast<const uint4*>(xr + k), v);
    unpack<T>(*reinterpret_cast<const uint4*>(ln_w + k), w);
    unpack<T>(*reinterpret_cast<const uint4*>(ln_b + k), b);
    alignas(16) T o[TV];
#pragma unroll
    for (int j = 0; j < TV; ++j)
      o[j] = from_f<T>((v[j] - mean) * rstd * w[j] + b[j]);
    *reinterpret_cast<uint4*>(out + (size_t)row * K + k) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <typename T, typename WT, int EPI>
__global__ void __launch_bounds__(256) dense_rows_kernel(
    const T* __restrict__ x, int B, int K, const WT* __restrict__ w, int N,
    const float* __restrict__ wscale, const T* __restrict__ bias,
    const T* __restrict__ resid, T* __restrict__ out, int row_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  constexpr int VEC = 16 / sizeof(WT);   // weights per 16-byte load
  constexpr int TV = 16 / sizeof(T);     // activations per 16-byte load
  constexpr int XV = VEC / TV;           // 16-byte activation loads per VEC
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * warps + warp) * kCols;
  const int step = 32 * VEC;             // k advance per loop iteration
  const uint4 zero = make_uint4(0, 0, 0, 0);

  auto load_w = [&](int c, int k) {
    return (n0 + c < N && k < K)
               ? *reinterpret_cast<const uint4*>(w + (size_t)(n0 + c) * K + k)
               : zero;
  };

  for (int r0 = 0; r0 < B; r0 += row_tile) {
    const int rt = min(row_tile, B - r0);
    uint4 ring[kPrefetch][kCols];
#pragma unroll
    for (int p = 0; p < kPrefetch; ++p)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ring[p][c] = load_w(c, lane * VEC + p * step);

    __syncthreads();  // the previous tile is fully consumed
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r0 * K);
    uint4* dst = reinterpret_cast<uint4*>(xs);
    for (int i = threadIdx.x; i < rt * K / TV; i += blockDim.x) dst[i] = src[i];
    __syncthreads();

    float acc[kCols][kRows];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;

    for (int k0 = lane * VEC; k0 < K; k0 += kPrefetch * step) {
#pragma unroll
      for (int p = 0; p < kPrefetch; ++p) {
        const int k = k0 + p * step;
        if (k < K) {
          float wv[kCols][VEC];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            unpack<WT>(ring[p][c], wv[c]);
            ring[p][c] = load_w(c, k + kPrefetch * step);
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rt) {
#pragma unroll
              for (int q = 0; q < XV; ++q) {
                float xv[TV];
                unpack<T>(*reinterpret_cast<const uint4*>(
                              xs + r * K + k + q * TV), xv);
#pragma unroll
                for (int j = 0; j < TV; ++j)
#pragma unroll
                  for (int c = 0; c < kCols; ++c)
                    acc[c][r] += xv[j] * wv[c][q * TV + j];
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rt) {  // uniform across the warp
          const float sum = vt::warp_sum(acc[c][r]);
          const int n = n0 + c;
          if (lane == ((c * kRows + r) & 31) && n < N) {
            const size_t o = (size_t)(r0 + r) * N + n;
            float y = round_to<T>(sum * (wscale ? wscale[n] : 1.f));
            y = round_to<T>(y + to_f(bias[n]));
            if (EPI == kEpiRelu) y = fmaxf(y, 0.f);
            if (EPI == kEpiGelu) y = gelu_tanh(y);
            if (EPI == kEpiResid) y = to_f(resid[o]) + y;
            out[o] = from_f<T>(y);
          }
        }
      }
    }
  }
}

// 8 consecutive weights of row n at k as 4 packed bf16 pairs.
__device__ __forceinline__ void load_w8(const __nv_bfloat16* w, bool ok,
                                        uint32_t (&r)[4]) {
  const uint4 v = ok ? *reinterpret_cast<const uint4*>(w)
                     : make_uint4(0, 0, 0, 0);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void load_w8(const int8_t* w, bool ok,
                                        uint32_t (&r)[4]) {
  const uint2 v = ok ? *reinterpret_cast<const uint2*>(w) : make_uint2(0, 0);
  const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // int8 -> bf16 is exact
    __nv_bfloat162 p = __floats2bfloat162_rn((float)e[2 * i],
                                             (float)e[2 * i + 1]);
    r[i] = *reinterpret_cast<uint32_t*>(&p);
  }
}

constexpr int kMmaWarps = 8;
constexpr int kMmaRows = 64;   // rows per pass: 4 m-tiles of 16

template <typename WT, int EPI, int NT>
__global__ void __launch_bounds__(kMmaWarps * 32) dense_mma_kernel(
    const __nv_bfloat16* __restrict__ x, int B, int K,
    const WT* __restrict__ w, int N, const float* __restrict__ wscale,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ resid,
    __nv_bfloat16* __restrict__ out) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) float part[];  // [warp][mt][nt][lane][4]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // mma group: row (A) / column (B)
  const int t = lane & 3;        // thread in group: k slice 8t..8t+7
  const int n_base = blockIdx.x * 8 * NT;
  const int chunks = K / 32;

  for (int r0 = 0; r0 < B; r0 += kMmaRows) {
    const int mts = min(4, (B - r0 + 15) / 16);
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

#pragma unroll 2
    for (int ch = warp; ch < chunks; ch += kMmaWarps) {
      const int k = ch * 32 + t * 8;
      uint32_t wr[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n_base + nt * 8 + g;
        load_w8(w + (size_t)n * K + k, n < N, wr[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mts) {
          const int ra = r0 + mt * 16 + g, rb = ra + 8;
          const uint4 zero = make_uint4(0, 0, 0, 0);
          const uint4 xa = ra < B ? *reinterpret_cast<const uint4*>(
                                        x + (size_t)ra * K + k) : zero;
          const uint4 xb = rb < B ? *reinterpret_cast<const uint4*>(
                                        x + (size_t)rb * K + k) : zero;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // k order: mma step 0 takes physical k 8t..8t+3, step 1 the rest
            mma_bf16(acc[mt][nt], xa.x, xb.x, xa.y, xb.y, wr[nt][0],
                     wr[nt][1]);
            mma_bf16(acc[mt][nt], xa.z, xb.z, xa.w, xb.w, wr[nt][2],
                     wr[nt][3]);
          }
        }
      }
    }

    // cross-warp reduction of the K split, then the epilogue
    const int per_warp = mts * NT * 128;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt < mts) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part[warp * per_warp + ((mt * NT + nt) * 32 + lane) * 4 + j] =
                acc[mt][nt][j];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < per_warp; e += kMmaWarps * 32) {
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kMmaWarps; ++wi) sum += part[wi * per_warp + e];
      const int j = e & 3, l = (e >> 2) & 31, tile = e >> 7;
      const int mt = tile / NT, nt = tile % NT;
      const int row = r0 + mt * 16 + (l >> 2) + (j >= 2 ? 8 : 0);
      const int n = n_base + nt * 8 + (l & 3) * 2 + (j & 1);
      if (row < B && n < N) {
        const size_t o = (size_t)row * N + n;
        float y = round_to<T>(sum * (wscale ? wscale[n] : 1.f));
        y = round_to<T>(y + to_f(bias[n]));
        if (EPI == kEpiRelu) y = fmaxf(y, 0.f);
        if (EPI == kEpiGelu) y = gelu_tanh(y);
        if (EPI == kEpiResid) y = to_f(resid[o]) + y;
        out[o] = from_f<T>(y);
      }
    }
    __syncthreads();
  }
}

template <typename WT, int EPI, int NT>
cudaError_t launch_mma(const void* x, int B, int K, const void* w, int N,
                       const float* wscale, const void* bias,
                       const void* resid, void* out, cudaStream_t stream) {
  if (K % 32 != 0) return cudaErrorInvalidValue;
  const int mts = min(4, (B + 15) / 16);
  const size_t smem = (size_t)kMmaWarps * mts * NT * 128 * sizeof(float);
  auto kern = dense_mma_kernel<WT, EPI, NT>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMmaWarps * 4 * NT * 128 * sizeof(float));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((N + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), B, K, static_cast<const WT*>(w),
      N, wscale, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

template <typename T, typename WT, int EPI>
cudaError_t launch_rows(const void* x, int B, int K, const void* w, int N,
                        const float* wscale, const void* bias,
                        const void* resid, void* out, cudaStream_t stream) {
  const size_t row_bytes = (size_t)K * sizeof(T);
  int rows = (int)(kSmemBudget / row_bytes);
  if (rows < 1 || K % 16 != 0) return cudaErrorInvalidValue;
  rows = min(min(rows, kRows), B);
  auto kern = dense_rows_kernel<T, WT, EPI>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int warps = N >= 2048 ? 8 : 4;
  dim3 grid((N + warps * kCols - 1) / (warps * kCols));
  kern<<<grid, warps * 32, rows * row_bytes, stream>>>(
      static_cast<const T*>(x), B, K, static_cast<const WT*>(w), N, wscale,
      static_cast<const T*>(bias), static_cast<const T*>(resid),
      static_cast<T*>(out), rows);
  return cudaGetLastError();
}

template <typename T, typename WT, int EPI>
cudaError_t launch_dense(const void* x, int B, int K, const void* w, int N,
                         const float* wscale, const void* bias,
                         const void* resid, void* out, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 32 columns per block for wide outputs, 16 below (N = 1024 -> 64)
    if (N >= 2048)
      return launch_mma<WT, EPI, 4>(x, B, K, w, N, wscale, bias, resid, out,
                                    s);
    return launch_mma<WT, EPI, 2>(x, B, K, w, N, wscale, bias, resid, out, s);
  } else {
    return launch_rows<T, WT, EPI>(x, B, K, w, N, wscale, bias, resid, out,
                                   s);
  }
}

template <typename T, typename WT>
cudaError_t dispatch_epi(int epi, const void* x, int B, int K, const void* w,
                         int N, const float* wscale, const void* bias,
                         const void* resid, void* out, cudaStream_t s) {
#define VT_ARGS x, B, K, w, N, wscale, bias, resid, out, s
  switch (epi) {
    case kEpiBias: return launch_dense<T, WT, kEpiBias>(VT_ARGS);
    case kEpiRelu: return launch_dense<T, WT, kEpiRelu>(VT_ARGS);
    case kEpiGelu: return launch_dense<T, WT, kEpiGelu>(VT_ARGS);
    case kEpiResid: return launch_dense<T, WT, kEpiResid>(VT_ARGS);
  }
#undef VT_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int vt_layer_norm_rows(int dtype, const void* x, int B, int K,
                                  const void* ln_w, const void* ln_b,
                                  void* out, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0) return cudaErrorInvalidValue;
  dim3 grid((B + 7) / 8);
  if (dtype == vt::kF32)
    ln_rows_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), B, K, static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<float*>(out), eps);
  else if (dtype == vt::kBF16)
    ln_rows_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), B, K,
        static_cast<const __nv_bfloat16*>(ln_w),
        static_cast<const __nv_bfloat16*>(ln_b),
        static_cast<__nv_bfloat16*>(out), eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int vt_dense_rows(int dtype, int w_int8, int epi, const void* x,
                             int B, int K, const void* w, int N,
                             const float* wscale, const void* bias,
                             const void* resid, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VT_ARGS epi, x, B, K, w, N, wscale, bias, resid, out, s
  if (dtype == vt::kF32)
    return w_int8 ? dispatch_epi<float, int8_t>(VT_ARGS)
                  : dispatch_epi<float, float>(VT_ARGS);
  if (dtype == vt::kBF16)
    return w_int8 ? dispatch_epi<__nv_bfloat16, int8_t>(VT_ARGS)
                  : dispatch_epi<__nv_bfloat16, __nv_bfloat16>(VT_ARGS);
#undef VT_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
