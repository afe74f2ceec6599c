// Hopper (sm_90a) building blocks for the tensor-core kernels (flash
// attention, the dense decode layer): asynchronous global -> shared
// copies (cp.async with zero fill; TMA tiles onto mbarriers), signals
// between the blocks of a cluster, programmatic dependent launch, 64 x 64
// bf16 tiles in the 128-byte swizzled layout, and warpgroup products
// (wgmma m64n64k16, fp32 accumulation) reading that layout through
// matrix descriptors. A head dim of 128 is two such tiles side by side
// (column halves), reduced or produced by chains of the 64-wide steps.
//
// Tile layout: 64 rows of 64 bf16 (128 bytes). The 16-byte chunk c of row
// r sits at r * 128 + ((c ^ (r % 8)) * 16), the layout TMA's and wgmma's
// 128-byte swizzle mode expects from a 1024-byte aligned base. A column of
// chunks then spreads over all 32 banks. One tile serves as a K-major
// operand (rows = M or N, the 64 columns = the reduced dimension) and, read
// transposed, as an MN-major B operand (rows = the reduced dimension).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vt {

constexpr int kSwTileBytes = 64 * 64 * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after p (the launch asks for
// 1024 bytes of slack).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// cp.async: 16 (or 4) bytes global -> shared, zeros when !ok (src-size 0:
// nothing is read, so src may be any valid address)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers and TMA tile loads (a tensor map in kernel parameter space)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Blocks until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// Brings a tensor map into the cache ahead of its first TMA load.
__device__ __forceinline__ void prefetch_tmap(const void* tmap) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(tmap))
               : "memory");
}

// One thread: the tile of the 2-D tensor map at (c0 innermost, c1) into
// shared memory at dst; the barrier completes when its bytes have landed.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One thread: arms the barrier's current phase for `bytes` more bytes and
// arrives on it once (a barrier initialized with count 1 then completes
// when those bytes have landed).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// One thread: a 1-D bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from global to shared memory at dst, counted on the
// barrier as it lands.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread-block clusters: point-to-point signals between blocks through
// mbarriers, and the split cluster barrier
// ---------------------------------------------------------------------------

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// One arrival on the barrier at cluster address `bar`, releasing (at
// cluster scope) this thread's earlier writes and those ordered before
// them.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// mbar_wait that also acquires, at cluster scope, what the arrivals
// released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// The two halves of a cluster barrier (every thread of every block).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Programmatic dependent launch: let the next kernel on the stream start
// (it still waits for this one before reading its results), and wait for
// the previous kernel to complete with its memory visible. Both are no-ops
// in a kernel launched without the attribute.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Makes this thread's completed shared-memory writes (cp.async included)
// visible to the async proxy that wgmma reads through; a barrier after it
// covers the other threads' writes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}



// 64 rows of 64 bf16 into the swizzled tile at dst: row r is the 64
// elements at src + r * stride (src already offset to the wanted 64
// columns); rows >= n become zeros. 128 threads, 4 chunks each; 8
// neighbouring threads read one 128-byte row. src and stride must keep
// every row 16-byte aligned.
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int n, int tid,
                                                int stride) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + 128 * i;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r < n;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               src + (ok ? r * stride + c * 8 : 0), ok);
  }
}

// Rows of DH = 64 * h columns as h swizzled tiles, column half j at
// dst + j * kSwTileBytes (the layout the DH-wide products below read).
template <int DH>
__device__ __forceinline__ void load_rows_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int n, int tid, int stride) {
#pragma unroll
  for (int j = 0; j < DH / 64; ++j)
    load_tile_sw128(dst + j * kSwTileBytes, src + 64 * j, n, tid, stride);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile.
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// ---------------------------------------------------------------------------
// wgmma m64n64k16, bf16 in, fp32 accumulators. A warpgroup (128 threads)
// issues each product together; accumulator d[4 * j + e] of thread
// (warp w, g = lane / 4, t = lane % 4) is row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + e % 2 -- mma.sync m16n8's layout repeated over 8
// column chunks. An A operand in registers has mma.sync m16n8k16's A
// layout, so two neighbouring 8-column accumulator chunks, packed to
// bf16, are the A operand of one 16-deep step.
// ---------------------------------------------------------------------------

// Descriptor of a swizzled tile at shared address a. Both offsets are 1024
// bytes (the distance between 8-row groups); for a K-major operand the
// hardware ignores the leading one, for an MN-major one of 64 columns it
// is never reached. K-major step k (16 columns): + 2 * k (32 bytes);
// MN-major step k (16 rows): + 128 * k (2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][32]) {
#pragma unroll
  for (int j = 0; j < N; ++j) fence_regs(d[j]);
}

#define VT_WGMMA_D32                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define VT_WGMMA_D32_LIST                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

// d (64 x 64) (+)= A (64 x 16) . B (64 x 16)^T, both K-major tiles in
// shared memory. scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VT_WGMMA_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64), B an MN-major tile
// in shared memory (its rows are the reduced dimension).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VT_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef VT_WGMMA_D32
#undef VT_WGMMA_D32_LIST

// d += P . M with P (64 x 64) as four register A operands (one per 16
// columns) and M the MN-major tile at shared address m.
__device__ __forceinline__ void wgmma_tile_rs_t(float (&d)[32],
                                                const uint32_t (&p)[4][4],
                                                uint32_t m) {
  const uint64_t dm = sw128_desc(m);
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_rs_t(d, p[k], dm + 128 * k);
}

// d (64 x 64) = A (64 x DH) . B (64 x DH)^T, each operand DH / 64 column
// halves of swizzled tiles (load_rows_sw128), both K-major: a chain of
// DH / 16 steps 16 deep, the first overwriting d.
template <int DH>
__device__ __forceinline__ void wgmma_rows_ss(float (&d)[32], uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int j = 0; j < DH / 64; ++j) {
    const uint64_t da = sw128_desc(a + j * kSwTileBytes);
    const uint64_t db = sw128_desc(b + j * kSwTileBytes);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_ss(d, da + 2 * k, db + 2 * k, j + k);
  }
}

// d[j] += P . M[:, 64 j : 64 j + 64] for each column half j of the
// MN-major rows at m: DH / 64 products of n64, one accumulator tile each.
template <int DH>
__device__ __forceinline__ void wgmma_rows_rs_t(float (&d)[DH / 64][32],
                                                const uint32_t (&p)[4][4],
                                                uint32_t m) {
#pragma unroll
  for (int j = 0; j < DH / 64; ++j)
    wgmma_tile_rs_t(d[j], p, m + j * kSwTileBytes);
}

}  // namespace vt
