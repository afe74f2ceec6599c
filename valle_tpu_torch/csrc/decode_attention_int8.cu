// B3: one-query decode attention over the combined int8 K|V cache, the
// port of
//   valle_tpu/ops/decode_attention_int8_grouped.py:decode_attention_int8_grouped
// (cache (B, H, T, 2DH) int8, K in [..., :DH] and V in [..., DH:]; scales
// (B, 2H, T) fp32, K rows 0:H and V rows H:2H; dequantization after the
// dots: s = (q . kq) * ks * sm_scale and acc += (p * vs) * vq, so no
// dequantized copy reaches device memory). Row b attends to its valid keys,
// p < x_len (the text) or S <= p <= write_pos (the audio so far).
//
// What bounds it on the H100: the valid keys' bytes, 2DH int8 and two fp32
// scales a key and head (bench step, B 32, H 16, DH 64, 365 valid keys a
// row: 25 MB, 7.6 us at 3.35 TB/s). At that rate an SM gets ~9.5 cycles
// a key and head, and a conversion per int8 element alone (16 a cycle on
// an SM) would take ~8 of them, so the work is to spend few instructions
// a byte:
//
// - A block of 128 threads owns one (row, head). Its valid keys are two
//   runs of its contiguous (T, 2DH) slab, [0, x_len) and [S, write_pos].
//   Thread 0 copies them in chunks of 128 keys (a chunk may end one run and
//   start the other) with 1-D bulk copies onto one mbarrier a stage, into a
//   ring of kStages chunks; each chunk's K and V scales come with it, every
//   scale run rounded outwards to 16 bytes (never past T: T % 4 == 0). No
//   other thread issues a load of the cache.
// - Scores: thread t takes key t of the chunk, its whole K row. q is held
//   as three int8 digits of a 23-bit fixed-point copy (q * 2^E, E from
//   max |q|), so q . kq is three integer sums of __dp4a (4 products an
//   instruction, no conversion of the cache, exact), joined in fp32: as
//   accurate as the fp32 dot. A lane starts its row at a rotated 16-byte
//   chunk, so the 8 lanes of a shared-memory phase spread over the banks.
// - Softmax per chunk: one block max; exp2 once a key (log2 e folded into
//   the scale); w = p * vs in fp32 to shared memory; the accumulators are
//   rescaled only when the max grew (alpha is 1 otherwise).
// - P.V: thread (c, j) keeps the 16 dims of V chunk c and takes the chunk's
//   keys j, j + SLOTS, ...; a byte becomes a float by one byte permute into
//   the mantissa of 2^23 (after one xor a word) and one subtraction.
// - The slots' sums meet in shared memory at the end, in a fixed order (two
//   launches give the same bits).
// The TPU kernel's 8-row groups and block-diagonal masked dots feed its
// matrix unit; here a (row, head) has one query, so tensor cores would use
// one row in 16, and each block reads only its own row's valid keys.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using vt::from_f;
using vt::to_f;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;   // keys a stage: one a thread for scores
constexpr int kStages = 3;
constexpr int kScSlack = 16;       // floats a scale array holds past kChunk

template <int DH>
struct Geom {
  static constexpr int ROW = 2 * DH;            // bytes a key row [K | V]
  static constexpr int NC = DH / 16;            // 16-byte chunks a half row
  static constexpr int SLOTS = kThreads / NC;   // key slots of P.V
  static constexpr int KPS = kChunk / SLOTS;    // keys a slot and chunk
  static constexpr int SC = kChunk + kScSlack;  // floats a scale array
  static constexpr int KV_BYTES = kChunk * ROW;
  static constexpr int STAGE = KV_BYTES + 2 * SC * 4;
  static constexpr int SMEM = kStages * STAGE;
  // rows that share a 128-byte line (the rotation of a lane's K chunks)
  static constexpr int ROT_DIV = ROW >= 128 ? 1 : 128 / ROW;
  static_assert(DH % 16 == 0 && kThreads % NC == 0 && SLOTS % 4 == 0,
                "a half row must split into 16-byte chunks");
  static_assert(SLOTS * DH * 4 <= KV_BYTES, "the slot sums fit a stage");
  static_assert(STAGE % 16 == 0, "stages must stay 16-byte aligned");
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 2^e as a float, for e in [-126, 127]
__device__ __forceinline__ float exp2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// The keys of chunk c: valid indices [i0, i0 + len) of the row's n, the
// first na text keys (cache rows i0 ...), the rest audio keys (cache rows
// tb ...). Their rows sit in the stage in that order. The text piece's
// scales land at float 0 (key r at (i0 & 3) + r, sb floats), the audio
// piece's at sb (key r at sb + (tb & 3) + r - na): each piece's copy
// starts at a multiple of 4 keys.
struct Chunk {
  int i0, len, na, tb, sb;
  __device__ __forceinline__ Chunk(int c, int n, int n_text, int S)
      : i0(c * kChunk),
        len(min(kChunk, n - c * kChunk)),
        na(max(min(len, n_text - i0), 0)),
        tb(S + max(i0 - n_text, 0)),
        sb(na > 0 ? ((i0 + na + 3) & ~3) - (i0 & ~3) : 0) {}
  __device__ __forceinline__ int scale_idx(int r) const {
    return r < na ? (i0 & 3) + r : sb + (tb & 3) + r - na;
  }
};

// Thread 0: the chunk's rows and scales into the stage at `stage` (shared
// address), counted on the barrier `bar`.
template <int DH>
__device__ __forceinline__ void issue_chunk(const Chunk& ch,
                                            const int8_t* slab,
                                            const float* ksc,
                                            const float* vsc, uint32_t stage,
                                            uint32_t bar) {
  using G = Geom<DH>;
  const int nb = ch.len - ch.na;
  const int b0 = ch.tb & ~3;
  const int nbs = nb > 0 ? ((ch.tb + nb + 3) & ~3) - b0 : 0;
  const uint32_t sk = stage + G::KV_BYTES, sv = sk + G::SC * 4;
  vt::mbar_arrive_expect_tx(bar, ch.len * G::ROW + 8 * (ch.sb + nbs));
  if (ch.na > 0) {
    const int a0 = ch.i0 & ~3;
    vt::bulk_load(stage, slab + (size_t)ch.i0 * G::ROW, ch.na * G::ROW, bar);
    vt::bulk_load(sk, ksc + a0, 4 * ch.sb, bar);
    vt::bulk_load(sv, vsc + a0, 4 * ch.sb, bar);
  }
  if (nb > 0) {
    vt::bulk_load(stage + ch.na * G::ROW, slab + (size_t)ch.tb * G::ROW,
                  nb * G::ROW, bar);
    vt::bulk_load(sk + 4 * ch.sb, ksc + b0, 4 * nbs, bar);
    vt::bulk_load(sv + 4 * ch.sb, vsc + b0, 4 * nbs, bar);
  }
}

// acc[e] += w * v[e] for the 16 int8 of v: byte u ^ 0x80 into the low
// mantissa byte of 2^23 gives 2^23 + 128 + u exactly
__device__ __forceinline__ void axpy16(float (&acc)[16], float w, uint4 v) {
  const uint32_t x[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[4 * i + j] = fmaf(
          w,
          __int_as_float(__byte_perm(x[i], 0x4B000000u, 0x7540 + j)) -
              8388736.f,
          acc[4 * i + j]);
}

template <typename QT, int DH>
__global__ void __launch_bounds__(kThreads, DH == 128 ? 2 : 4)
    decode_int8_kernel(const QT* __restrict__ q, long q_bstride,
                       const int8_t* __restrict__ kv,
                       const float* __restrict__ scales,
                       const int* __restrict__ x_lens,
                       const int* __restrict__ write_pos,
                       QT* __restrict__ out, int H, int T, int S,
                       float sm_scale) {
  using G = Geom<DH>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(16) int8_t sm_qd[3][DH];   // q's digits, by dim
  __shared__ float sm_red[kWarps];
  __shared__ float sm_w[kChunk];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_text = min(max(x_lens[b], 0), min(S, T));
  const int n = n_text + max(min(write_pos[b], T - 1) - S + 1, 0);
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int8_t* slab = kv + ((size_t)b * H + h) * T * G::ROW;
  const float* ksc = scales + ((size_t)b * 2 * H + h) * T;
  const float* vsc = ksc + (size_t)H * T;
  const uint32_t bar0 = vt::smem_addr(&full[0]);   // stage s: bar0 + 8 s
  const uint32_t stage0 = vt::smem_addr(smem);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) vt::mbar_init(bar0 + 8 * s, 1);
    vt::fence_mbar_init();
    for (int c = 0; c < min(kStages, nchunks); ++c)
      issue_chunk<DH>(Chunk(c, n, n_text, S), slab, ksc, vsc,
                      stage0 + c * G::STAGE, bar0 + 8 * c);
  }

  // q -> Q = rint(q * 2^E), |Q| < 2^22, as digits Q2 2^16 + Q1 2^8 + Q0
  // (each in [-128, 127])
  float qv = 0.f;
  if (tid < DH) qv = to_f(q[(size_t)b * q_bstride + h * DH + tid]);
  const float qa = warp_max(fabsf(qv));
  if (lane == 0) sm_red[warp] = qa;
  __syncthreads();
  float qmax = sm_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) qmax = fmaxf(qmax, sm_red[w]);
  int ex;
  frexpf(qmax, &ex);   // qmax < 2^ex
  const int E = min(max(22 - ex, -126), 126);
  if (tid < DH) {
    const int Q = __float2int_rn(qv * exp2i(E));
    const int d0 = (int)(int8_t)(Q & 0xFF);
    const int r1 = (Q - d0) >> 8;
    const int d1 = (int)(int8_t)(r1 & 0xFF);
    sm_qd[0][tid] = (int8_t)d0;
    sm_qd[1][tid] = (int8_t)d1;
    sm_qd[2][tid] = (int8_t)((r1 - d1) >> 8);
  }
  __syncthreads();
  const int rot = (lane / G::ROT_DIV) & (G::NC - 1);
  int qd[3][G::NC][4];   // the digits of the K chunk a lane reads j-th
#pragma unroll
  for (int j = 0; j < G::NC; ++j)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int4 w = *reinterpret_cast<const int4*>(
          &sm_qd[g][((j + rot) & (G::NC - 1)) * 16]);
      qd[g][j][0] = w.x;
      qd[g][j][1] = w.y;
      qd[g][j][2] = w.z;
      qd[g][j][3] = w.w;
    }
  // log2 e folded in: p = exp2(s - m)
  const float qscale = sm_scale * 1.4426950408889634f * exp2i(-E);

  const int vc = tid % G::NC, slot = tid / G::NC;
  float m = -INFINITY, l = 0.f, acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kStages;
    const uint8_t* stage = smem + st * G::STAGE;
    const float* sk = reinterpret_cast<const float*>(stage + G::KV_BYTES);
    const float* sv = sk + G::SC;
    const Chunk ch(c, n, n_text, S);
    vt::mbar_wait(bar0 + 8 * st, (c / kStages) & 1);

    // scores, one key a thread
    float s = -INFINITY;
    if (tid < ch.len) {
      const uint8_t* row = stage + tid * G::ROW;
      int d0 = 0, d1 = 0, d2 = 0;
#pragma unroll
      for (int j = 0; j < G::NC; ++j) {
        const int4 k = *reinterpret_cast<const int4*>(
            row + ((j + rot) & (G::NC - 1)) * 16);
        const int kw[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d0 = __dp4a(kw[i], qd[0][j][i], d0);
          d1 = __dp4a(kw[i], qd[1][j][i], d1);
          d2 = __dp4a(kw[i], qd[2][j][i], d2);
        }
      }
      s = fmaf((float)d2, 65536.f, fmaf((float)d1, 256.f, (float)d0)) *
          (qscale * sk[ch.scale_idx(tid)]);
    }
    const float cm = warp_max(s);
    if (lane == 0) sm_red[warp] = cm;
    __syncthreads();   // every thread is past chunk c - 1: refill its stage
    if (tid == 0 && c > 0 && c - 1 + kStages < nchunks) {
      const int sp = (c - 1) % kStages;
      issue_chunk<DH>(Chunk(c - 1 + kStages, n, n_text, S), slab, ksc, vsc,
                      stage0 + sp * G::STAGE, bar0 + 8 * sp);
    }
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, sm_red[w]);
    const float alpha = exp2f(m - m_new);
    const float p = exp2f(s - m_new);
    l = l * alpha + p;
    sm_w[tid] = tid < ch.len ? p * sv[ch.scale_idx(tid)] : 0.f;
    __syncthreads();
    if (m_new > m) {   // uniform over the block
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] *= alpha;
    }
    m = m_new;

    // P.V: V chunk vc of keys slot, slot + SLOTS, ...
#pragma unroll
    for (int i = 0; i < G::KPS; ++i) {
      const int r = slot + i * G::SLOTS;
      if (r < ch.len)
        axpy16(acc, sm_w[r],
               *reinterpret_cast<const uint4*>(stage + r * G::ROW + DH +
                                               vc * 16));
    }
  }

  const float lt = vt::warp_sum(l);
  __syncthreads();   // the stages are free
  if (lane == 0) sm_red[warp] = lt;
  float* part = reinterpret_cast<float*>(smem);   // [SLOTS][DH]
#pragma unroll
  for (int e = 0; e < 16; e += 4)
    *reinterpret_cast<float4*>(&part[slot * DH + vc * 16 + e]) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  __syncthreads();
  if (tid < DH) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < G::SLOTS; j += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += part[(j + u) * DH + tid];
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lsum += sm_red[w];
    out[((size_t)b * H + h) * DH + tid] =
        from_f<QT>(((a[0] + a[1]) + (a[2] + a[3])) / fmaxf(lsum, 1e-30f));
  }
}

template <typename QT, int DH>
int launch(const void* q, long q_bstride, const void* kv,
           const float* scales, const int* x_lens, const int* write_pos,
           void* out, int B, int H, int T, int S, float sm_scale,
           cudaStream_t s) {
  auto kern = decode_int8_kernel<QT, DH>;
  static std::atomic<uint64_t> attr_set{0};
  cudaError_t e = vt::once_per_device(attr_set, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<DH>::SMEM);
  });
  if (e != cudaSuccess) return e;
  kern<<<B * H, kThreads, Geom<DH>::SMEM, s>>>(
      static_cast<const QT*>(q), q_bstride, static_cast<const int8_t*>(kv),
      scales, x_lens, write_pos, static_cast<QT*>(out), H, T, S, sm_scale);
  return cudaGetLastError();
}

template <typename QT>
int launch_dh(int dh, const void* q, long q_bstride, const void* kv,
              const float* scales, const int* x_lens, const int* write_pos,
              void* out, int B, int H, int T, int S, float sm_scale,
              cudaStream_t s) {
#define VT_ARGS q, q_bstride, kv, scales, x_lens, write_pos, out, B, H, T, S, \
                sm_scale, s
  if (dh == 64) return launch<QT, 64>(VT_ARGS);
  if (dh == 128) return launch<QT, 128>(VT_ARGS);
  if (dh == 32) return launch<QT, 32>(VT_ARGS);
#undef VT_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// B3: q (B, H, DH) rows q_bstride apart, in `dtype`; kv (B, H, T, 2DH)
// int8 and scales (B, 2H, T) fp32, contiguous and 16-byte aligned; T a
// multiple of 4 (a scale row starts 16-byte aligned).
extern "C" int vt_decode_attention_int8(int dtype, int dh, const void* q,
                                        long q_bstride, const void* kv,
                                        const float* scales,
                                        const int* x_lens,
                                        const int* write_pos, void* out,
                                        int B, int H, int T, int S,
                                        float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kF32)
    return launch_dh<float>(dh, q, q_bstride, kv, scales, x_lens, write_pos,
                            out, B, H, T, S, sm_scale, s);
  if (dtype == vt::kBF16)
    return launch_dh<__nv_bfloat16>(dh, q, q_bstride, kv, scales, x_lens,
                                    write_pos, out, B, H, T, S, sm_scale, s);
  return cudaErrorInvalidValue;
}
