// Pieces shared by the bf16 tensor-core kernels of flash_mha_fwd.cu and
// flash_mha_bwd.cu: which tiles a block must visit, and the dropout bytes
// of a tile staged in shared memory without bank conflicts.
#pragma once

#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

namespace vt {

constexpr int kFlashTile = 64;   // rows of a block = keys of a tile; Dh 64

// Code and segment extremes over rows base .. base + 63 (those < n) of one
// batch row's codes, reduced over the warp (every lane gets them).
struct CodeRange {
  int cmin, cmax, smin, smax;
};

__device__ __forceinline__ CodeRange code_range(const int* code,
                                                const int* seg, int base,
                                                int n, int lane) {
  CodeRange r{INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
  for (int c = lane; c < kFlashTile; c += 32) {
    if (base + c < n) {
      const int x = code[base + c];
      r.cmin = min(r.cmin, x);
      r.cmax = max(r.cmax, x);
      if (seg != nullptr) {
        const int y = seg[base + c];
        r.smin = min(r.smin, y);
        r.smax = max(r.smax, y);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r.cmin = min(r.cmin, __shfl_xor_sync(0xffffffffu, r.cmin, o));
    r.cmax = max(r.cmax, __shfl_xor_sync(0xffffffffu, r.cmax, o));
    r.smin = min(r.smin, __shfl_xor_sync(0xffffffffu, r.smin, o));
    r.smax = max(r.smax, __shfl_xor_sync(0xffffffffu, r.smax, o));
  }
  return r;
}

// visible(query i, key j): kcode <= qcode, equal segments when packed, or
// i == j under add_diag.
__device__ __forceinline__ bool visible(int qc, int qs, int kc, int ks,
                                        bool packed, int add_diag, int qi,
                                        int ki) {
  bool vis = kc <= qc;
  if (packed) vis = vis && qs == ks;
  if (add_diag) vis = vis || qi == ki;
  return vis;
}

// Can some query of qr see some key of kr? (kcode <= qcode, and equal
// segments when packed; necessary, not sufficient.)
__device__ __forceinline__ bool may_see(const CodeRange& qr,
                                        const CodeRange& kr, bool packed) {
  return qr.cmax >= kr.cmin &&
         (!packed || (qr.smin <= kr.smax && kr.smin <= qr.smax));
}

// One warp lists the tiles of the other side (queries or keys, n_oth of
// them, codes oth_code / oth_seg of this batch row) that may hold a
// visible pair with the block's own 64 rows from own0 (n_own in all):
// list[0] = their count, list[1..] their indices in order. Under
// add_diag a tile that shares an index with the own rows is always
// listed. Every other tile is fully masked, so skipping it changes no
// sum of a row that sees a key.
__device__ __forceinline__ void build_tile_list(
    int* list, bool own_is_query, const int* own_code, const int* own_seg,
    int own0, int n_own, const int* oth_code, const int* oth_seg, int n_oth,
    int add_diag, int lane) {
  const bool packed = own_seg != nullptr;
  const CodeRange own = code_range(own_code, own_seg, own0, n_own, lane);
  const int own_end = min(own0 + kFlashTile, n_own);
  int cnt = 0;
  for (int t0 = 0; t0 < n_oth; t0 += kFlashTile) {
    const CodeRange oth = code_range(oth_code, oth_seg, t0, n_oth, lane);
    bool vis = own_is_query ? may_see(own, oth, packed)
                            : may_see(oth, own, packed);
    if (add_diag)
      vis = vis || max(own0, t0) < min(own_end, min(t0 + kFlashTile, n_oth));
    if (vis) {
      ++cnt;
      if (lane == 0) list[cnt] = t0 / kFlashTile;
    }
  }
  if (lane == 0) list[0] = cnt;
}

// ---------------------------------------------------------------------------
// Dropout bytes. One Philox output (dropout_bytes16) covers 16 keys of one
// query row; a warp computes each output of its tile once (two per lane)
// and stages it as one 16-byte store, words permuted to (w0, w2, w1, w3)
// so that the two words a thread needs from it are one 8-byte load.
// ---------------------------------------------------------------------------

// Rows are queries (the forward, dq): the warp's 16 rows x 64 keys, 1024
// bytes. Output (row r, group s) goes to slot s ^ ((r / 2) % 4) of row r,
// so the 8-byte loads of a warp hit 32 distinct banks.
__device__ __forceinline__ void stage_row_bytes(uint8_t* buf,
                                                const Dropout& dr, int bh,
                                                int row0, int j16_0, int S,
                                                int T, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int o = lane + 32 * k, r = o >> 2, s = o & 3;
    const uint4 w = dropout_bytes16(dr, bh, row0 + r, j16_0 + s, S, T);
    *reinterpret_cast<uint4*>(buf + (r * 4 + (s ^ ((r >> 1) & 3))) * 16) =
        make_uint4(w.x, w.z, w.y, w.w);
  }
  __syncwarp();
}

// Words t / 2 (.x: keys 16 s + 2 t, +1) and 2 + t / 2 (.y: keys
// 16 s + 8 + 2 t, +1) of row r's group s; the byte of key 2 t + e of a
// word is (w >> (16 (t % 2) + 8 e)) & 255.
__device__ __forceinline__ uint2 row_bytes(const uint8_t* buf, int r, int s,
                                           int t) {
  return *reinterpret_cast<const uint2*>(
      buf + (r * 4 + (s ^ ((r >> 1) & 3))) * 16 + 8 * (t >> 1));
}

// Rows are keys (dk/dv): 64 query columns x the warp's 16 keys, which are
// one 16-key Philox group j16. Column c's output goes to bytes 16 c.
__device__ __forceinline__ void stage_key_bytes(uint8_t* buf,
                                                const Dropout& dr, int bh,
                                                int q0, int j16, int S, int T,
                                                int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = lane + 32 * k;
    const uint4 w = dropout_bytes16(dr, bh, q0 + c, j16, S, T);
    *reinterpret_cast<uint4*>(buf + c * 16) = make_uint4(w.x, w.z, w.y, w.w);
  }
  __syncwarp();
}

// Words g / 4 (.x: key g) and 2 + g / 4 (.y: key g + 8) of column c; the
// key's byte is (w >> (8 (g % 4))) & 255.
__device__ __forceinline__ uint2 key_bytes(const uint8_t* buf, int c, int g) {
  return *reinterpret_cast<const uint2*>(buf + c * 16 + 8 * (g >> 2));
}

// The four bf16 A operands of a P.M product from a 64-column accumulator
// tile (rounding each value to bf16 here).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&p)[32]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = pack_bf16(p[8 * k + 2 * r], p[8 * k + 2 * r + 1]);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace vt
