// K2 and K3 — attention backward for Hopper (sm_90a), bf16 in and out, fp32
// inside.
//
// Replace the two TPU kernels of `mha_backward` in
// src/repro/kernels/flash_attention.py:
//   K2, the dq pass    (pl.pallas_call at :404, body `_dq_body` at :225),
//   K3, the dk/dv pass (pl.pallas_call at :438, body `_dkv_body` at :258),
// in both the plain (`flash_attention`) and the segmented
// (`ragged_attention`) entry points.
//
// What they compute, from the forward's residuals (q, k, v, o, lse) and the
// output gradient do, with delta = rowsum(do * o) (B,H,T) fp32 computed by
// the caller as the reference does outside its kernels (:392):
//   s   = q k^T / sqrt(D), capped: s1 = cap tanh(s / cap) when softcap is on
//   p   = exp(s1 - lse), 0 where the element mask hides the pair
//   dp  = do v^T
//   ds  = p (dp - delta), times (1 - tanh^2) when softcap is on
//   dq  = ds k / sqrt(D)                         (K2, (B,T,H,D) bf16)
//   dv  = sum over the GQA group of p^T do       (K3, (B,S,KV,D) bf16)
//   dk  = sum over the GQA group of ds^T q / sqrt(D)
// The mask is the reference's `_element_mask` (flash_common.cuh `visible`),
// and pairs are chosen by select, never by multiplying with a mask: on a
// row with no visible key lse is the finite sentinel -1e30, and exp(s - lse)
// overflows to inf there. Keys past S (loaded as zeros) and, in K3, query
// rows past T are masked too, so any T and S work.
//
// Design. Both kernels keep the forward's 64 x 64 tiles and its skip
// predicate: a (query tile, key tile) pair that K1 skips (`tiles_live`, the
// reference's `_live_terms` on the tiles' min/max) is never visited, and a
// pair every element of which is visible skips the element mask. Products
// run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// fragments read from shared memory with ldmatrix; p and ds are rounded to
// bf16 as operands of the second products. Tiles stream in with cp.async,
// the next live one loading into a second buffer while the current one is
// computed.
//  - K2: one block of 4 warps per (64 query rows, q head, batch row). The q
//    and do tiles stay in shared memory; the kv loop runs inside the block
//    and each warp keeps the dq of its 16 rows in registers (fp32) until the
//    single bf16 store.
//  - K3: one block of 8 warps per (64 keys, KV head, batch row). The k and v
//    tiles stay in shared memory; the block loops over the live query tiles
//    and, inside each, over the q heads of its GQA group, so dk and dv sum
//    the whole group in registers and are written once, without atomics
//    (deterministic, as the reference's group-inner grid). Each tile is two
//    phases: the warps compute p^T and ds^T for (16 keys x 32 rows) each and
//    store them to shared memory as bf16; then each warp adds p^T do and
//    ds^T q for 16 keys x D/2 columns. So a thread holds 2 x D/2 x 16 / 32
//    accumulators (64 floats at D = 128), not the 128 that one warp per 16
//    keys x D would need.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at the
// training shapes (T = S = 2048, D = 128) both are bound by operations,
// 6 D FLOPs per visible pair in K2 (s, dp, dq) and 8 D in K3 (s, dp, dv,
// dk), against reading q, k, v, do once and writing one or two gradients.
// What the design does about it: every product of a tile runs from shared
// memory and registers, dead tiles cost no products, and no gradient leaves
// the chip before its last sum. Not yet done: TMA, wgmma and warp
// specialisation; K3 recomputes the scores that K2 also computes.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;              // query rows per tile
constexpr int kThreadsDq = 4 * 32;
constexpr int kThreadsDkv = 8 * 32;

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dout;
  const float* lse;
  const float* delta;
  const int* qpos;
  const int* kpos;
  const int* qseg;   // nullptr: not segmented
  const int* kseg;
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  int B, T, S, H, KV;
  int causal, window;
  float softcap;     // 0: none
  float sm_scale;
};

// ----------------------------------------------------------------------
// K2: dq
// ----------------------------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kThreadsDq)
mha_bwd_dq_kernel(const Params p) {
  constexpr int kStride = kD + 8;   // bf16 per shared row: ldmatrix rows on
                                    // distinct banks
  constexpr int kNT = kBK / 8;      // 8-key n-tiles of a kv tile
  // dynamic shared memory: the q and do tiles, [kBQ][kStride] each, two
  // buffers of (k tile, v tile) [kBK][kStride], then two buffers of the kv
  // tile's positions and segment ids, [kBK] int each
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const q_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* const do_s = q_s + kBQ * kStride;
  uint16_t* const kv_s = do_s + kBQ * kStride;
  int* const kpos_s = reinterpret_cast<int*>(kv_s + 4 * kBK * kStride);
  int* const kseg_s = kpos_s + 2 * kBK;
  __shared__ int part[2][4];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;   // mma fragment row group / column pair
  const int mi = lane >> 3, r8 = lane & 7; // ldmatrix: matrix and row this lane addresses
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvh = h / (p.H / p.KV);
  const bool segmented = p.qseg != nullptr;

  // ---- q and do tiles into shared memory (zeros past T) ----
  const size_t q_rs = (size_t)p.H * kD;    // token stride of q and do
  const size_t q_base = (size_t)b * p.T * q_rs + (size_t)h * kD;
  load_rows<kD, kThreadsDq>(q_s, kStride, p.q + q_base, q_rs, q0, kBQ, p.T, tid);
  load_rows<kD, kThreadsDq>(do_s, kStride, p.dout + q_base, q_rs, q0, kBQ, p.T, tid);
  cp_async_commit();

  // ---- this thread's two query rows, and the q tile's statistics ----
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  bool row_ok[2];
  int qp[2], qs[2];
  float lse2[2], dlt[2];   // lse in log2 units, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = row[i] < p.T;
    qp[i] = row_ok[i] ? p.qpos[(size_t)b * p.T + row[i]] : 0;
    qs[i] = (row_ok[i] && segmented) ? p.qseg[(size_t)b * p.T + row[i]] : 0;
    const size_t li = ((size_t)b * p.H + h) * p.T + row[i];
    lse2[i] = row_ok[i] ? p.lse[li] * kLog2e : 0.f;
    dlt[i] = row_ok[i] ? p.delta[li] : 0.f;
  }
  int qstat[4];
  {
    const int r = q0 + tid;
    const bool ok = tid < kBQ && r < p.T;
    const int pos = ok ? p.qpos[(size_t)b * p.T + r] : 0;
    const int seg = (ok && segmented) ? p.qseg[(size_t)b * p.T + r] : 0;
    tile_stats(ok, pos, seg, part, qstat);
  }
  const bool warp_active = q0 + warp * 16 < p.T;

  float dq[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const size_t kv_rs = (size_t)p.KV * kD;   // token stride of k and v
  const size_t kv_base = (size_t)b * p.S * kv_rs + (size_t)kvh * kD;
  const int n_tiles = (p.S + kBK - 1) / kBK;

  // The first live kv tile at or after t, n_tiles if none; its positions and
  // segment ids go to buffer buf. As in K1.
  auto find_live = [&](int t, int buf, bool& full_out) -> int {
    for (; t < n_tiles; ++t) {
      const int kk = t * kBK + tid;
      const bool ok = tid < kBK && kk < p.S;
      const int pos = ok ? p.kpos[(size_t)b * p.S + kk] : 0;
      const int seg = (ok && segmented) ? p.kseg[(size_t)b * p.S + kk] : 0;
      if (tid < kBK) { kpos_s[buf * kBK + tid] = pos; kseg_s[buf * kBK + tid] = seg; }
      int kstat[4];
      tile_stats(ok, pos, seg, part, kstat);
      if (!tiles_live(qstat, kstat, segmented, p.causal, p.window))
        continue;   // uniform over the block
      full_out = t * kBK + kBK <= p.S &&
                 tiles_full(qstat, kstat, segmented, p.causal, p.window);
      return t;
    }
    return n_tiles;
  };

  auto issue = [&](int t, int buf) {
    uint16_t* const kb = kv_s + buf * 2 * kBK * kStride;
    load_rows<kD, kThreadsDq>(kb, kStride, p.k + kv_base, kv_rs, t * kBK, kBK, p.S, tid);
    load_rows<kD, kThreadsDq>(kb + kBK * kStride, kStride, p.v + kv_base, kv_rs,
                              t * kBK, kBK, p.S, tid);
    cp_async_commit();
  };

  bool full = false, full_next = false;
  int cur = find_live(0, 0, full);
  if (cur < n_tiles) issue(cur, 0);
  for (int buf = 0; cur < n_tiles; buf ^= 1) {
    const int next = find_live(cur + 1, buf ^ 1, full_next);
    if (next < n_tiles) {
      issue(next, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // q, do and tile cur are in shared memory
    const int k0 = cur * kBK;
    const uint16_t* const ks = kv_s + buf * 2 * kBK * kStride;
    const uint16_t* const vs = ks + kBK * kStride;
    const int* const kpos_b = kpos_s + buf * kBK;
    const int* const kseg_b = kseg_s + buf * kBK;
    if (warp_active) {
      // ---- s = q k^T and dp = do v^T for this warp's 16 rows x 64 keys ----
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_a(qa, q_s + warp * 16 * kStride + kk * 16, kStride, lane);
        ldsm_a(da, do_s + warp * 16 * kStride + kk * 16, kStride, lane);
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          const int off = ((n + (mi >> 1)) * 8 + r8) * kStride + kk * 16 + (mi & 1) * 8;
          uint32_t kb[4], vb[4];   // b0, b1 of n-tiles n and n + 1
          ldsm_x4(kb, ks + off);
          mma_bf16(s[n], qa, kb[0], kb[1]);
          mma_bf16(s[n + 1], qa, kb[2], kb[3]);
          ldsm_x4(vb, vs + off);
          mma_bf16(dp[n], da, vb[0], vb[1]);
          mma_bf16(dp[n + 1], da, vb[2], vb[3]);
        }
      }

      // ---- p from lse, ds = p (dp - delta) (1 - th^2), into s ----
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;                        // which of the two rows
          const int key = n * 8 + c * 2 + (e & 1);     // key within the tile
          float z = s[n][e] * p.sm_scale;
          float chain = 1.f;
          if (p.softcap > 0.f) {
            const float th = tanhf(z / p.softcap);
            z = p.softcap * th;
            chain = 1.f - th * th;
          }
          float pe = exp2f(z * kLog2e - lse2[i]);
          if (!full && !(k0 + key < p.S &&
                         visible(qp[i], qs[i], kpos_b[key], kseg_b[key],
                                 segmented, p.causal, p.window)))
            pe = 0.f;
          s[n][e] = pe * (dp[n][e] - dlt[i]) * chain;
        }
      }

      // ---- dq += ds k: ds from the s fragments, k by transposed ldmatrix ----
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const uint16_t* k0p = ks + (kk * 16 + (mi & 1) * 8 + r8) * kStride + (mi >> 1) * 8;
#pragma unroll
        for (int n = 0; n < kD / 8; n += 2) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, k0p + n * 8);
          mma_bf16(dq[n], a, kb[0], kb[1]);
          mma_bf16(dq[n + 1], a, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();   // buffer buf is free for the tile after next
    cur = next;
    full = full_next;
  }
  cp_async_wait<0>();  // no copy outlives the block, even with no live tile

  if (!warp_active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    uint16_t* drow = p.dq + (((size_t)b * p.T + row[i]) * p.H + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + c * 2) =
          pack_bf16(dq[n][2 * i] * p.sm_scale, dq[n][2 * i + 1] * p.sm_scale);
  }
}

// ----------------------------------------------------------------------
// K3: dk and dv
// ----------------------------------------------------------------------
template <int kD>
__global__ void __launch_bounds__(kThreadsDkv)
mha_bwd_dkv_kernel(const Params p) {
  constexpr int kStride = kD + 8;
  constexpr int kPS = kBQ + 8;       // bf16 per row of the p^T / ds^T tiles
  constexpr int kNB = kD / 16;       // 8-column n-tiles of a warp's D / 2
  // dynamic shared memory: the k and v tiles [kBK][kStride]; two buffers of
  // (q tile, do tile) [kBQ][kStride]; p^T and ds^T [kBK][kPS] bf16; then two
  // buffers each of the q tile's lse (log2 units), delta, positions and
  // segment ids, [kBQ] each
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const k_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* const v_s = k_s + kBK * kStride;
  uint16_t* const qd_s = v_s + kBK * kStride;
  uint16_t* const pt_s = qd_s + 4 * kBQ * kStride;
  uint16_t* const dst_s = pt_s + kBK * kPS;
  float* const lse_s = reinterpret_cast<float*>(dst_s + kBK * kPS);
  float* const dlt_s = lse_s + 2 * kBQ;
  int* const qpos_s = reinterpret_cast<int*>(dlt_s + 2 * kBQ);
  int* const qseg_s = qpos_s + 2 * kBQ;
  __shared__ int part[2][4];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kBK;
  const int group = p.H / p.KV;
  const bool segmented = p.qseg != nullptr;
  const int kr = (warp & 3) * 16;         // this warp's 16 keys
  const int qc = (warp >> 2) * 32;        // phase A: its 32 query rows
  const int dh = (warp >> 2) * (kD / 2);  // phase B: its D / 2 columns

  // ---- k and v tiles into shared memory (zeros past S) ----
  const size_t kv_rs = (size_t)p.KV * kD;
  const size_t kv_base = (size_t)b * p.S * kv_rs + (size_t)kvh * kD;
  load_rows<kD, kThreadsDkv>(k_s, kStride, p.k + kv_base, kv_rs, k0, kBK, p.S, tid);
  load_rows<kD, kThreadsDkv>(v_s, kStride, p.v + kv_base, kv_rs, k0, kBK, p.S, tid);
  cp_async_commit();

  // ---- this thread's two keys (rows of s^T), and the key tile's statistics ----
  bool key_ok[2];
  int kp[2], ks[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + kr + g + 8 * j;
    key_ok[j] = key < p.S;
    kp[j] = key_ok[j] ? p.kpos[(size_t)b * p.S + key] : 0;
    ks[j] = (key_ok[j] && segmented) ? p.kseg[(size_t)b * p.S + key] : 0;
  }
  int kstat[4];
  {
    const int key = k0 + tid;
    const bool ok = tid < kBK && key < p.S;
    const int pos = ok ? p.kpos[(size_t)b * p.S + key] : 0;
    const int seg = (ok && segmented) ? p.kseg[(size_t)b * p.S + key] : 0;
    tile_stats(ok, pos, seg, part, kstat);
  }

  float dk[kNB][4], dv[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const size_t q_rs = (size_t)p.H * kD;
  const int n_qt = (p.T + kBQ - 1) / kBQ;
  const int n_items = n_qt * group;   // (query tile, head of the group) pairs

  // The first live item at or after `it` (query tile it / group, q head
  // kvh * group + it % group), n_items if none. Its lse, delta, positions
  // and segment ids go to buffer buf.
  auto find_live = [&](int it, int buf, bool& full_out) -> int {
    while (it < n_items) {
      const int t = it / group, hq = kvh * group + it % group, q0 = t * kBQ;
      const int r = q0 + tid;
      const bool ok = tid < kBQ && r < p.T;
      const int pos = ok ? p.qpos[(size_t)b * p.T + r] : 0;
      const int seg = (ok && segmented) ? p.qseg[(size_t)b * p.T + r] : 0;
      if (tid < kBQ) {
        const size_t li = ((size_t)b * p.H + hq) * p.T + r;
        lse_s[buf * kBQ + tid] = ok ? p.lse[li] * kLog2e : 0.f;
        dlt_s[buf * kBQ + tid] = ok ? p.delta[li] : 0.f;
        qpos_s[buf * kBQ + tid] = pos;
        qseg_s[buf * kBQ + tid] = seg;
      }
      int qstat[4];
      tile_stats(ok, pos, seg, part, qstat);
      if (!tiles_live(qstat, kstat, segmented, p.causal, p.window)) {
        it = (t + 1) * group;   // dead for every head: next query tile
        continue;
      }
      full_out = q0 + kBQ <= p.T && k0 + kBK <= p.S &&
                 tiles_full(qstat, kstat, segmented, p.causal, p.window);
      return it;
    }
    return n_items;
  };

  auto issue = [&](int it, int buf) {
    const int t = it / group, hq = kvh * group + it % group;
    const size_t base = (size_t)b * p.T * q_rs + (size_t)hq * kD;
    uint16_t* const qb = qd_s + buf * 2 * kBQ * kStride;
    load_rows<kD, kThreadsDkv>(qb, kStride, p.q + base, q_rs, t * kBQ, kBQ, p.T, tid);
    load_rows<kD, kThreadsDkv>(qb + kBQ * kStride, kStride, p.dout + base, q_rs,
                               t * kBQ, kBQ, p.T, tid);
    cp_async_commit();
  };

  bool full = false, full_next = false;
  int cur = find_live(0, 0, full);
  if (cur < n_items) issue(cur, 0);
  for (int buf = 0; cur < n_items; buf ^= 1) {
    const int next = find_live(cur + 1, buf ^ 1, full_next);
    if (next < n_items) {
      issue(next, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // k, v and item cur's q and do are in shared memory
    const int q0 = (cur / group) * kBQ;
    const uint16_t* const qs_b = qd_s + buf * 2 * kBQ * kStride;
    const uint16_t* const dos_b = qs_b + kBQ * kStride;
    const float* const lse_b = lse_s + buf * kBQ;
    const float* const dlt_b = dlt_s + buf * kBQ;
    const int* const qpos_b = qpos_s + buf * kBQ;
    const int* const qseg_b = qseg_s + buf * kBQ;

    // ---- phase A: s^T = k q^T, dp^T = v do^T for 16 keys x 32 rows ----
    {
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_a(ka, k_s + kr * kStride + kk * 16, kStride, lane);
        ldsm_a(va, v_s + kr * kStride + kk * 16, kStride, lane);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          const int off = (qc + (n + (mi >> 1)) * 8 + r8) * kStride + kk * 16 + (mi & 1) * 8;
          uint32_t qb[4], db[4];
          ldsm_x4(qb, qs_b + off);
          mma_bf16(s[n], ka, qb[0], qb[1]);
          mma_bf16(s[n + 1], ka, qb[2], qb[3]);
          ldsm_x4(db, dos_b + off);
          mma_bf16(dp[n], va, db[0], db[1]);
          mma_bf16(dp[n + 1], va, db[2], db[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e >> 1;                          // which of the two keys
          const int qi = qc + n * 8 + c * 2 + (e & 1);   // row within the tile
          float z = s[n][e] * p.sm_scale;
          float chain = 1.f;
          if (p.softcap > 0.f) {
            const float th = tanhf(z / p.softcap);
            z = p.softcap * th;
            chain = 1.f - th * th;
          }
          float pe = exp2f(z * kLog2e - lse_b[qi]);
          if (!full && !(q0 + qi < p.T && key_ok[j] &&
                         visible(qpos_b[qi], qseg_b[qi], kp[j], ks[j],
                                 segmented, p.causal, p.window)))
            pe = 0.f;
          s[n][e] = pe;
          dp[n][e] = pe * (dp[n][e] - dlt_b[qi]) * chain;
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = qc + n * 8 + c * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = (kr + g + 8 * j) * kPS + col;
          *reinterpret_cast<uint32_t*>(pt_s + r) = pack_bf16(s[n][2 * j], s[n][2 * j + 1]);
          *reinterpret_cast<uint32_t*>(dst_s + r) = pack_bf16(dp[n][2 * j], dp[n][2 * j + 1]);
        }
      }
    }
    __syncthreads();   // p^T and ds^T of the whole tile are in shared memory

    // ---- phase B: dv += p^T do, dk += ds^T q for 16 keys x D / 2 ----
#pragma unroll
    for (int kq = 0; kq < kBQ / 16; ++kq) {
      uint32_t pa[4], sa[4];
      ldsm_a(pa, pt_s + kr * kPS + kq * 16, kPS, lane);
      ldsm_a(sa, dst_s + kr * kPS + kq * 16, kPS, lane);
      const int off = (kq * 16 + (mi & 1) * 8 + r8) * kStride + dh + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n + 1 < kNB; n += 2) {
        uint32_t db[4], qb[4];
        ldsm_x4_trans(db, dos_b + off + n * 8);
        mma_bf16(dv[n], pa, db[0], db[1]);
        mma_bf16(dv[n + 1], pa, db[2], db[3]);
        ldsm_x4_trans(qb, qs_b + off + n * 8);
        mma_bf16(dk[n], sa, qb[0], qb[1]);
        mma_bf16(dk[n + 1], sa, qb[2], qb[3]);
      }
      if constexpr (kNB % 2) {   // D = 16: one n-tile per warp
        uint32_t db[2], qb[2];
        ldsm_x2_trans(db, dos_b + off + (kNB - 1) * 8);
        mma_bf16(dv[kNB - 1], pa, db[0], db[1]);
        ldsm_x2_trans(qb, qs_b + off + (kNB - 1) * 8);
        mma_bf16(dk[kNB - 1], sa, qb[0], qb[1]);
      }
    }
    __syncthreads();   // buffer buf and the p^T / ds^T tiles are free
    cur = next;
    full = full_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!key_ok[j]) continue;
    const size_t r = ((size_t)b * p.S + k0 + kr + g + 8 * j) * kv_rs + (size_t)kvh * kD + dh;
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int d = n * 8 + c * 2;
      *reinterpret_cast<uint32_t*>(p.dk + r + d) =
          pack_bf16(dk[n][2 * j] * p.sm_scale, dk[n][2 * j + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(p.dv + r + d) = pack_bf16(dv[n][2 * j], dv[n][2 * j + 1]);
    }
  }
}

template <int kD>
void launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int kBytes = (2 * kBQ + 4 * kBK) * (kD + 8) * 2 + 4 * kBK * 4;
  cudaFuncSetAttribute(mha_bwd_dq_kernel<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  mha_bwd_dq_kernel<kD><<<dim3((p.T + kBQ - 1) / kBQ, p.H, p.B), kThreadsDq,
                          kBytes, stream>>>(p);
}

template <int kD>
void launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int kBytes = (2 * kBK + 4 * kBQ) * (kD + 8) * 2 +
                         2 * kBK * (kBQ + 8) * 2 + 8 * kBQ * 4;
  cudaFuncSetAttribute(mha_bwd_dkv_kernel<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  mha_bwd_dkv_kernel<kD><<<dim3((p.S + kBK - 1) / kBK, p.KV, p.B), kThreadsDkv,
                           kBytes, stream>>>(p);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qpos,
                   const void* kpos, const void* qseg, const void* kseg,
                   int B, int T, int S, int H, int KV, int D, int causal,
                   int window, float softcap) {
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.dout = static_cast<const uint16_t*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dq = p.dk = p.dv = nullptr;
  p.B = B; p.T = T; p.S = S; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.softcap = softcap;
  p.sm_scale = 1.0f / sqrtf((float)D);
  return p;
}

bool bad_shape(int B, int T, int S, int H, int KV) {
  return KV <= 0 || H % KV != 0 || B <= 0 || T <= 0 || S <= 0;
}

}  // namespace

// q, do, dq: bf16 (B,T,H,D); k, v: bf16 (B,S,KV,D); lse, delta: fp32
// (B,H,T); positions and segment ids int32 (B,T) / (B,S), segment ids both
// null or both set; all contiguous, D in {16, 32, 64, 128}. Launch K2 on
// `stream` and return cudaGetLastError().
extern "C" int mha_bwd_dq_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* qpos,
                               const void* kpos, const void* qseg,
                               const void* kseg, void* dq, int B, int T, int S,
                               int H, int KV, int D, int causal, int window,
                               float softcap, void* stream) {
  if (bad_shape(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, qpos, kpos, qseg, kseg,
                         B, T, S, H, KV, D, causal, window, softcap);
  p.dq = static_cast<uint16_t*>(dq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch_dq<16>(p, st); break;
    case 32: launch_dq<32>(p, st); break;
    case 64: launch_dq<64>(p, st); break;
    case 128: launch_dq<128>(p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As mha_bwd_dq_bf16, writing dk and dv (bf16 (B,S,KV,D)): launch K3.
extern "C" int mha_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* qpos,
                                const void* kpos, const void* qseg,
                                const void* kseg, void* dk, void* dv, int B,
                                int T, int S, int H, int KV, int D, int causal,
                                int window, float softcap, void* stream) {
  if (bad_shape(B, T, S, H, KV)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, lse, delta, qpos, kpos, qseg, kseg,
                         B, T, S, H, KV, D, causal, window, softcap);
  p.dk = static_cast<uint16_t*>(dk);
  p.dv = static_cast<uint16_t*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch_dkv<16>(p, st); break;
    case 32: launch_dkv<32>(p, st); break;
    case 64: launch_dkv<64>(p, st); break;
    case 128: launch_dkv<128>(p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
