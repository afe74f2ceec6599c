// Attention + head-wise out-projection + residual + LayerNorm2 of one AR
// decode layer: the port of the TPU kernel
// valle_tpu/ops/fused_attn_tail.py:fused_attn_tail (B12, decode mode
// "mega"). The FFN that completes the layer runs on the dense kernels of
// csrc/fused_dense.cu (lin1 + activation, lin2 + residual).
//
// What it fuses, and what bounds it on the H100: the TPU kernel keeps each
// head's attention output in VMEM and multiplies it by that head's columns
// of out_w, so the (H, B, Dh) -> (B, D) head merge never reaches HBM, and
// it starts the weights' DMAs at entry so they stream under the attention.
// The bytes that bound it here are the valid K|V rows (as B11) plus out_w
// once.
//
// bf16: attn_outproj_mma_kernel, in thread-block clusters of G (8 or 16)
// rows of one head. Each block
//   1. runs B11's attention body (csrc/decode_attention.cuh, lane-row
//      cache, p rounded to bf16) for its (row, head); a padding block (row
//      >= B) runs none and holds zeros;
//   2. copies its share of the head's out_w columns (D / G output rows of
//      Dh, cp.async): the TPU kernel streams its weights under the
//      attention, but here the copy at entry slowed the attention's loads,
//      so it flies during the row exchange;
//   3. pushes its row, rounded to bf16 as the TPU kernel's (H, B, Dh)
//      scratch, into every block of the cluster (st.shared::cluster) and
//      signals each one's barrier (mbarrier arrive, release at cluster
//      scope: point-to-point signals cost less than cluster barriers, and
//      no block reads another's memory, so none waits for the others to
//      finish before it exits);
//   4. multiplies its out_w share by the G rows on the tensor cores
//      (mma.sync m16n8k16, fp32 sums): each cluster reads its head's out_w
//      slice once, 2 * 16 / G MB a call in all instead of 64 MB;
//   5. writes the fp32 head partials part (B, H, D) of the real rows.
// fp32: attn_outproj_kernel, a block per (row, head), the out-projection
// on the CUDA cores (TF32 is not fp32: this is what holds mode "mega"'s
// fp32 greedy codes equal to "exact"'s).
// LN2 needs the whole row, and a GPU has no ordered grid, so
// tail_combine_kernel (a block per row, a thread per column) then sums the
// partials in head order 0..H-1 (the TPU kernel's order, and no atomics:
// fp32 results do not depend on the run), rounds, adds b_out and the
// residual, and normalizes.

#include "decode_attention.cuh"
#include "hopper.cuh"

namespace {

using vt::from_f;
using vt::kDecThreads;
using vt::kDecWarps;
using vt::round_to;
using vt::to_f;

constexpr int kOutUnroll = 8;     // out_w vectors in flight per lane
constexpr int kCombineThreads = 1024;
constexpr int kMaxCluster = 16;   // H100's non-portable cluster size

template <typename DT, int DH>
__global__ void __launch_bounds__(kDecThreads) attn_outproj_kernel(
    const DT* __restrict__ q, long q_bstride, const DT* __restrict__ kv,
    const int* __restrict__ x_lens, const int* __restrict__ write_pos,
    const DT* __restrict__ out_w, float* __restrict__ part, int H, int T,
    int S, float sm_scale) {
  __shared__ float res[DH];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  vt::decode_attend<DT, DT, DH, vt::kLaneRows, vt::kRoundP>(
      q, q_bstride, kv, x_lens, write_pos, b, h, H, T, S, sm_scale,
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

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (G * H, rows padded to G / G), clusters (G, 1, 1): block x of row
// group y owns row y * G + x % G of head x / G for the attention and
// output columns rank * D / G .. + D / G of that head's out-projection
// for the cluster's G rows. Consecutive blocks cover every head of a row
// group, so the lane rows of its keys are read together, as B11's order
// (row-major, head-minor) reads them. Dynamic shared memory: the D / G
// rows of out_w (DH + 8 apart).
template <int DH>
__global__ void __launch_bounds__(kDecThreads) attn_outproj_mma_kernel(
    const __nv_bfloat16* __restrict__ q, long q_bstride,
    const __nv_bfloat16* __restrict__ kv, const int* __restrict__ x_lens,
    const int* __restrict__ write_pos, const __nv_bfloat16* __restrict__ out_w,
    float* __restrict__ part, int B, int H, int T, int S, float sm_scale) {
  using BT = __nv_bfloat16;
  constexpr int LD = DH + 8;   // padded rows: conflict-free fragment loads
  constexpr int CPR = DH / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  BT* ws = reinterpret_cast<BT*>(smem_raw);
  __shared__ __align__(16) BT rows[kMaxCluster][LD];  // the cluster's rows
  __shared__ float res[DH];
  __shared__ __align__(8) uint64_t rows_bar;   // all G rows have landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = cluster_size(), rank = cluster_rank();
  const int h = blockIdx.x / G, b0 = blockIdx.y * G, b = b0 + rank;
  const int D = H * DH, NC = D / G, n0 = rank * NC;

  // 1. the barrier the peers will signal, set up before the cluster's
  // arrival (the matching wait comes after the attention, its latency
  // hidden)
  if (tid == 0) {
    vt::mbar_init(vt::smem_addr(&rows_bar), G);
    vt::fence_mbar_init();
  }
  vt::cluster_arrive();
  vt::griddep_wait();

  // 2. the attention row (zeros in a padding block)
  if (b < B) {
    vt::decode_attend<BT, BT, DH, vt::kLaneRows, vt::kRoundP>(
        q, q_bstride, kv, x_lens, write_pos, b, h, H, T, S,
        sm_scale, res);
  } else {
    for (int d = tid; d < DH; d += kDecThreads) res[d] = 0.f;
    __syncthreads();
  }
  // this block's out_w share: copied now, its latency hidden under the
  // row exchange (copied at entry, it slowed the attention's own loads)
  for (int c = tid; c < NC * CPR; c += kDecThreads) {
    const int r = c / CPR, cc = c % CPR;
    vt::cp_async16(vt::smem_addr(ws + r * LD + cc * 8),
                   out_w + (size_t)(n0 + r) * D + h * DH + cc * 8, true);
  }
  vt::cp_async_commit();
  vt::griddep_launch_dependents();

  // 3. push the row, rounded to bf16, into slot `rank` of every block of
  // the cluster and signal their barriers; wait for the G rows
  vt::cluster_wait();   // the peers' barriers are set up
  for (int c = tid; c < G * CPR; c += kDecThreads) {
    const int g = c / CPR, cc = c % CPR;
    const float* r = res + cc * 8;
    const uint32_t dst =
        vt::cluster_addr(vt::smem_addr(&rows[rank][cc * 8]), g);
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     dst),
                 "r"(vt::pack_bf16(r[0], r[1])),
                 "r"(vt::pack_bf16(r[2], r[3])),
                 "r"(vt::pack_bf16(r[4], r[5])),
                 "r"(vt::pack_bf16(r[6], r[7]))
                 : "memory");
  }
  __syncthreads();
  if (tid < G)
    vt::mbar_arrive_cluster(vt::cluster_addr(vt::smem_addr(&rows_bar), tid));
  vt::cp_async_wait<0>();
  vt::mbar_wait_cluster(vt::smem_addr(&rows_bar), 0);
  __syncthreads();   // every thread's weight copies have landed

  // 4. part[b0 + g, h, n0 + n] = sum_d out_w[n0 + n, h DH + d] rows[g][d]:
  // warps over (16 output columns x 8 rows) tiles, DH / 16 steps each
  const int gid = lane >> 2, tig = lane & 3;
  const int ntn = G / 8, tiles = NC / 16 * ntn;
  for (int tile = warp; tile < tiles; tile += kDecWarps) {
    const int m0 = tile / ntn * 16, g0 = tile % ntn * 8;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = 0; k0 < DH; k0 += 16) {
      const BT* wa = ws + (m0 + gid) * LD + k0 + tig * 2;
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(wa),
          *reinterpret_cast<const uint32_t*>(wa + 8 * LD),
          *reinterpret_cast<const uint32_t*>(wa + 8),
          *reinterpret_cast<const uint32_t*>(wa + 8 * LD + 8)};
      const BT* rb = &rows[g0 + gid][k0 + tig * 2];
      mma_16816(c, a, *reinterpret_cast<const uint32_t*>(rb),
                *reinterpret_cast<const uint32_t*>(rb + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + m0 + gid + (e >> 1) * 8;
      const int row = b0 + g0 + tig * 2 + (e & 1);
      if (row < B) part[((size_t)row * H + h) * D + n] = c[e];
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

// h1 = resid + round(round(sum_h part) + b_out), the sum in head order;
// nrm = LN2(h1). Rounding as the TPU kernel: the fp32 sum cast to DT, the
// bias added in DT. A block per row, a thread per column (8 heads'
// partials in flight).
template <typename DT>
__global__ void __launch_bounds__(kCombineThreads) tail_combine_kernel(
    const float* __restrict__ part, int H, int D, const DT* __restrict__ out_b,
    const DT* __restrict__ resid, const DT* __restrict__ ln_w,
    const DT* __restrict__ ln_b, DT* __restrict__ h1, DT* __restrict__ nrm,
    float eps) {
  extern __shared__ float row[];   // D values of h1
  __shared__ float scratch[kCombineThreads / 32];
  vt::griddep_launch_dependents();
  vt::griddep_wait();
  const int b = blockIdx.x;
  const float* pb = part + (size_t)b * H * D;
  float sum = 0.f;
  for (int n = threadIdx.x; n < D; n += blockDim.x) {
    float y = pb[n];
#pragma unroll 8
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

// Launches kern with the attribute of programmatic dependent launch and,
// when cluster > 1, clusters of (cluster, 1, 1).
template <typename... KArgs, typename... Args>
cudaError_t launch_ex(void (*kern)(KArgs...), dim3 grid, int threads,
                      size_t smem, int cluster, cudaStream_t s,
                      Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int DH>
int launch_mma(const void* q, long q_bstride, const void* kv,
               const int* x_lens, const int* write_pos, const void* out_w,
               float* part, int B, int H, int T, int S, float sm_scale,
               int G, cudaStream_t s) {
  const int D = H * DH;
  if ((G != 8 && G != kMaxCluster) || D % (16 * G) != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(D / G) * (DH + 8) * sizeof(__nv_bfloat16);
  auto kern = attn_outproj_mma_kernel<DH>;
  if (smem > 160 * 1024) return cudaErrorInvalidValue;
  // set on every launch: the attributes belong to the current device
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             160 * 1024);
  if (e != cudaSuccess) return e;
  using BT = __nv_bfloat16;
  return launch_ex(kern, dim3(G * H, (B + G - 1) / G), kDecThreads, smem, G,
                   s, static_cast<const BT*>(q), q_bstride,
                   static_cast<const BT*>(kv), x_lens, write_pos,
                   static_cast<const BT*>(out_w), part, B, H, T, S,
                   sm_scale);
}

template <typename DT>
int launch_outproj(int dh, const void* q, long q_bstride, const void* kv,
                   const int* x_lens, const int* write_pos, const void* out_w,
                   float* part, int B, int H, int T, int S, float sm_scale,
                   cudaStream_t s) {
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
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  return launch_ex(tail_combine_kernel<DT>, dim3(B),
                   min(kCombineThreads, (D + 31) / 32 * 32), smem, 1, s, part,
                   H, D, static_cast<const DT*>(out_b),
                   static_cast<const DT*>(resid),
                   static_cast<const DT*>(ln_w), static_cast<const DT*>(ln_b),
                   static_cast<DT*>(h1), static_cast<DT*>(nrm), eps);
}

}  // namespace

// q (B, H, dh) rows q_bstride apart; kv lane rows (B, T, H * 2dh); out_w
// (D, D) row-major (out, in), D = H * dh; part (B, H, D) fp32 out. bf16
// runs in clusters of `cluster` rows (8 or 16); fp32 ignores it.
extern "C" int vt_attn_outproj(int dtype, int dh, const void* q,
                               long q_bstride, const void* kv,
                               const int* x_lens, const int* write_pos,
                               const void* out_w, float* part, int B, int H,
                               int T, int S, float sm_scale, int cluster,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  if (dtype == vt::kF32)
    return launch_outproj<float>(dh, q, q_bstride, kv, x_lens, write_pos,
                                 out_w, part, B, H, T, S, sm_scale, s);
  if (dtype != vt::kBF16) return cudaErrorInvalidValue;
#define VT_ARGS                                                         \
  q, q_bstride, kv, x_lens, write_pos, out_w, part, B, H, T, S, sm_scale, \
      cluster, s
  if (dh == 64) return launch_mma<64>(VT_ARGS);
  if (dh == 128) return launch_mma<128>(VT_ARGS);
  if (dh == 32) return launch_mma<32>(VT_ARGS);
#undef VT_ARGS
  return cudaErrorInvalidValue;
}

// part (B, H, D) fp32 -> h1 (B, D) and nrm = LN2(h1) (B, D), in `dtype`.
extern "C" int vt_attn_tail_combine(int dtype, const float* part, int B,
                                    int H, int D, const void* out_b,
                                    const void* resid, const void* ln_w,
                                    const void* ln_b, void* h1, void* nrm,
                                    float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  if (dtype == vt::kF32)
    return launch_combine<float>(part, B, H, D, out_b, resid, ln_w, ln_b, h1,
                                 nrm, eps, s);
  if (dtype == vt::kBF16)
    return launch_combine<__nv_bfloat16>(part, B, H, D, out_b, resid, ln_w,
                                         ln_b, h1, nrm, eps, s);
  return cudaErrorInvalidValue;
}
