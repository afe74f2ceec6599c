// Shared helpers for the port's hand-written Hopper kernels.
//
// Element types: T is float or __nv_bfloat16 (activations), WT is T or
// int8_t (weights). All arithmetic is fp32; round_to<T> reproduces a cast
// to T and back, which is where the JAX package rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace vt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Launch state that belongs to a device (function attributes, the SM
// count) is kept per device (cudaGetDevice at each launch), never once a
// process: a process may launch on several cards. Devices past
// kMaxDevices set their attributes on every launch.
constexpr int kMaxDevices = 64;

// Runs set() (a cudaError_t) the first time the current device launches
// through `done` (one flag a device), and again until it succeeds.
template <typename F>
inline cudaError_t once_per_device(std::atomic<uint64_t>& done, F&& set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < kMaxDevices ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit))
    return cudaSuccess;
  e = set();
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return e;
}

// The current device's SM count, read once a device.
inline cudaError_t device_sms(int* sms) {
  static std::atomic<int> known[kMaxDevices];   // 0: not read yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*sms = known[dev].load(
                                std::memory_order_relaxed)) != 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices)
    known[dev].store(*sms, std::memory_order_relaxed);
  return e;
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16.
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Masked attention scores take this finite value (flash_mha.py:66), so a
// fully masked row stays finite and uniform.
constexpr float kNegInf = -1e30f;

// Two floats rounded to bf16 and packed (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// ---------------------------------------------------------------------------
// Dropout bytes: Philox4x32-10 (Salmon et al., SC'11), the function that
// valle_tpu_torch/ops/philox.py computes in plain PyTorch. Byte (b, h, i, j)
// is byte j % 16 (little-endian within each word) of
// philox(counter = (b * H + h, i, j / 16, 0), key = seed).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

struct Dropout {
  int thresh;            // keep iff byte >= thresh; 0 = no dropout
  float scale;           // 1 / (1 - thresh / 256), the kept values' rescale
  uint32_t k0, k1;       // Philox key: the seed's low and high words
  const uint8_t* bits;   // explicit (B, H, S, T) bytes instead, or null
};

// The 16 bytes of query row i, keys 16 * j16 .. 16 * j16 + 15.
__device__ __forceinline__ uint4 dropout_bytes16(const Dropout& dr, int bh,
                                                 int i, int j16, int S,
                                                 int T) {
  if (dr.bits == nullptr)
    return philox4x32_10(make_uint4(bh, i, j16, 0), dr.k0, dr.k1);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (i < S) {
    const uint8_t* row = dr.bits + ((size_t)bh * S + i) * T;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int j = j16 * 16 + b;
      if (j < T) w[b >> 2] |= (uint32_t)row[j] << (8 * (b & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int byte_of(uint4 w, int b) {
  const uint32_t x = b < 4 ? w.x : b < 8 ? w.y : b < 12 ? w.z : w.w;
  return (x >> (8 * (b & 3))) & 255;
}

// keep(i, j) for one element (the CUDA-core kernels: one call per element).
__device__ __forceinline__ bool dropout_keep(const Dropout& dr, int bh, int i,
                                             int j, int S, int T) {
  return byte_of(dropout_bytes16(dr, bh, i, j >> 4, S, T), j & 15) >=
         dr.thresh;
}

}  // namespace vt
