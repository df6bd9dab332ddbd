// Pieces shared by the attention kernels, K1 (flash_fwd.cu) and the fused
// backward (flash_bwd.cu): mma.sync and cp.async for K1's decode form, the
// per-tile min/max statistics, and the reference's block-skip predicate and
// element mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBK = 64;            // keys per kv tile of K1's decode form
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kIntMax = 0x7fffffff;
constexpr int kIntMin = -kIntMax - 1;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane L gives the address of
// row L % 8 of matrix L / 8. Thread t receives, of each matrix, row t / 4,
// columns 2 (t % 4) and 2 (t % 4) + 1 (transposed: those rows, column t / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global -> shared without a register round trip; zeros when !full.
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two floats to one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// min/max of positions and segment ids over the entries held by the first
// 64 threads (invalid entries pass the identities). Every thread gets the
// result in out[0..3] = pos min, pos max, seg min, seg max. Every thread of
// the block must call it.
__device__ __forceinline__ void tile_stats(bool valid, int pos, int seg,
                                           int (*part)[4], int (&out)[4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();   // every thread has read the previous call's part[]
  if (warp < 2) {
    int r0 = warp_min(valid ? pos : kIntMax);
    int r1 = warp_max(valid ? pos : kIntMin);
    int r2 = warp_min(valid ? seg : kIntMax);
    int r3 = warp_max(valid ? seg : kIntMin);
    if (lane == 0) {
      part[warp][0] = r0; part[warp][1] = r1;
      part[warp][2] = r2; part[warp][3] = r3;
    }
  }
  __syncthreads();
  out[0] = min(part[0][0], part[1][0]);
  out[1] = max(part[0][1], part[1][1]);
  out[2] = min(part[0][2], part[1][2]);
  out[3] = max(part[0][3], part[1][3]);
}

// The min/max of the positions and segment ids of the 128 rows at `r0` of
// a (B, n) row, by one warp: every lane of the warp gets them.
__device__ __forceinline__ int4 row_tile_stats(const int* pos, const int* seg,
                                               int n, int r0, int lane) {
  int st[4] = {kIntMax, kIntMin, kIntMax, kIntMin};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + lane + 32 * i;
    if (r < n) {
      const int ps = pos[r], sg = seg != nullptr ? seg[r] : 0;
      st[0] = min(st[0], ps); st[1] = max(st[1], ps);
      st[2] = min(st[2], sg); st[3] = max(st[3], sg);
    }
  }
  return make_int4(warp_min(st[0]), warp_max(st[1]), warp_min(st[2]),
                   warp_max(st[3]));
}

// `_live_terms` (src/repro/kernels/flash_attention.py:67) on the (min, max)
// statistics of a query tile and a key tile: false only if no pair of the
// two tiles can be visible.
__device__ __forceinline__ bool tiles_live(const int (&q)[4], const int (&k)[4],
                                           bool segmented, int causal,
                                           int window) {
  bool live = true;
  if (segmented)
    live = q[3] >= k[2] && k[3] >= q[2] && k[3] >= 0 && q[3] >= 0;
  if (causal) {
    live = live && q[1] >= k[0];
    if (window > 0) live = live && q[0] - k[1] < window;
  }
  return live;
}

// Every pair of the tiles' valid rows and keys is visible, so the element
// mask can be skipped; the caller adds the ragged-tail conditions.
__device__ __forceinline__ bool tiles_full(const int (&q)[4], const int (&k)[4],
                                           bool segmented, int causal,
                                           int window) {
  bool f = true;
  if (segmented) f = q[2] == q[3] && k[2] == k[3] && q[2] == k[2] && k[2] >= 0;
  if (causal) {
    f = f && q[0] >= k[1];
    if (window > 0) f = f && q[1] - k[0] < window;
  }
  return f;
}

// The reference's `_element_mask` for one (query, key) pair.
__device__ __forceinline__ bool visible(int qp, int qs, int kp, int ks,
                                        bool segmented, int causal, int window) {
  bool ok = true;
  if (segmented) ok = qs == ks && ks >= 0;
  if (causal) {
    const int d = qp - kp;
    ok = ok && d >= 0;
    if (window > 0) ok = ok && d < window;
  }
  return ok;
}

}  // namespace flash
