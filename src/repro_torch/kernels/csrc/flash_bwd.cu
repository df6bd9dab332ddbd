// The attention backward for Hopper (sm_90a): one kernel computes dq, dk
// and dv. bf16 in and out, fp32 inside.
//
// Replaces the two TPU kernels of `mha_backward` in
// src/repro/kernels/flash_attention.py:
//   K2, the dq pass    (pl.pallas_call at :404, body `_dq_body` at :225),
//   K3, the dk/dv pass (pl.pallas_call at :438, body `_dkv_body` at :258),
// in both the plain (`flash_attention`) and the segmented
// (`ragged_attention`) entry points.
//
// What it computes, from the forward's residuals (q, k, v, o, lse) and the
// output gradient do, with delta = rowsum(do * o) (B,H,T) fp32 computed by
// the caller as the reference does outside its kernels (:392):
//   s   = q k^T / sqrt(D), capped: s1 = cap tanh(s / cap) when softcap is on
//   p   = exp(s1 - lse), 0 where the element mask hides the pair
//   dp  = do v^T
//   ds  = p (dp - delta), times (1 - tanh^2) when softcap is on
//   dq  = ds k / sqrt(D)
//   dv  = sum over the GQA group of p^T do
//   dk  = sum over the GQA group of ds^T q / sqrt(D)
// The mask is the reference's `_element_mask` (flash_common.cuh `visible`),
// and pairs are chosen by select, never by multiplying with a mask: on a
// row with no visible key lse is the finite sentinel -1e30, and exp(s - lse)
// overflows to inf there. Keys past S and query rows past T (loaded as
// zeros) are masked too, so any T and S work.
//
// Bound. On an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) the
// training shapes (T = S = 2048, D = 128, 32 heads) are bound by
// operations: 10 D FLOPs per visible pair (s, dp, dv, dk and dq, 2 D each)
// against reading q, k, v, do once and writing dq, dk and dv once. The
// reference's two passes (and this port's first two kernels) computed s and
// dp twice, 14 D per pair.
//
// Design (D up to 128; D 256 has its own form, `mha_bwd_d256_kernel`, at
// the end of this file). One pass over the live (query tile, key tile)
// pairs.
//  - One block per (128 keys, KV head, batch row): a producer warpgroup and
//    two consumer warpgroups of 64 keys each. The k and v tiles stay in
//    shared memory for the whole pass; the block loops over the live
//    (64-row query tile, q head of the GQA group) items, query tiles from
//    the last to the first.
//  - The producer warpgroup's warps 1-3 first take the min/max of the
//    positions and segment ids of the key tiles up to the block's own into
//    a table in shared memory (at most kMaxKeyTiles tiles: S <= 65536).
//    Warp 0 then scans the query tiles' liveness against the block's key
//    tile (`tiles_live`, the reference's `_live_terms`) and keeps two
//    stages of (q, do, lse, delta, positions, segment ids) in flight: q and
//    do by TMA from 4-D tensor maps over (D, heads, T, B), whose
//    out-of-bounds fill gives the zero rows past T; mbarriers hand stages
//    to the consumers and back. setmaxnreg moves registers from the
//    producer warpgroup to the consumers.
//  - Per item, each consumer warpgroup runs five wgmma products: s^T = k q^T
//    and dp^T = v do^T from shared memory; p^T and ds^T in registers (fp32,
//    rounded to bf16 as operands), in one of four forms chosen per item
//    (softcap or not, element mask or not, the mask skipped where every
//    pair is visible); dv += p^T do and dk += ds^T q with A from registers
//    and do, q read transposed through the descriptors; ds^T to shared
//    memory, then dq = ds k for the warpgroup's half of D over the block's
//    128 keys. dk and dv stay in fp32 registers until one bf16 store,
//    summed over the GQA group without atomics.
//  - dq, scaled by 1/sqrt(D), goes to one of two shared-memory slots as
//    128-byte-swizzled fp32 boxes, item by item in turn. Warps 1 and 2 of
//    the producer warpgroup, one per slot, add each tile into the caller's
//    zeroed fp32 accumulator (B, H, T rounded up to 64, D) by TMA
//    reduce-adds, while the consumers go on with the next item.
//
// Sum order. For every (batch row, q head, 64-row query tile), dq's tiles
// are added in ascending key tile, so dq is repeatable bit for bit, as dk
// and dv are. An int32 counter per (batch row, q head, query tile), zeroed
// by the caller beside the accumulator, counts the key tiles that have
// added theirs. Before adding, the block of key tile j waits (acquire)
// until the counter reaches the number of live key tiles before j for
// that query tile, which warp 0 counts from the table with the same
// `tiles_live` predicate that skips dead pairs, so a dead pair is never
// waited for. The block then adds its tile, waits until the adds are
// complete in global memory and bumps the counter (release). A block waits
// only on blocks of lower blockIdx.x in its own (KV head, batch row),
// which are launched before it, so every wait ends. Because every block
// walks the query tiles in the same (descending) order, the blocks of a
// (KV head, batch row) reach a query tile at about the same time, and
// the waits are short.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kBQ = 64;              // query rows per item
constexpr int kBKB = 128;            // keys per block
constexpr int kStages = 2;           // (q, do, lse, delta) tiles in flight
constexpr int kDQSlots = 2;          // dq tiles between the consumers and the adds
constexpr int kMaxKeyTiles = 512;    // key tiles in the statistics table
constexpr int kConsumers = 2 * 128;  // two consumer warpgroups
constexpr int kThreads = 128 + kConsumers;

struct Params {
  const float* lse;
  const float* delta;
  const int* qpos;
  const int* kpos;
  const int* qseg;   // nullptr: not segmented
  const int* kseg;
  int* dq_sem;       // (B, H, T_acc / kBQ): key tiles added into dq's tile
  uint16_t* dk;
  uint16_t* dv;
  int B, T, S, H, KV;
  int causal, window;
  float softcap;     // 0: none
  float sm_scale;
};

// Shared memory, each tile on a 1024-byte boundary. A tile of rows of D
// bf16 is stored as TMA writes it: boxes of 64 columns (one box for
// D <= 64), each box rows of kRB bytes with the kRB-byte swizzle.
template <int kD>
struct Smem {
  // a tile is whole boxes of 64 columns, or one narrower box: any other
  // D would load and store only part of each row
  static_assert(kD == 16 || kD == 32 || kD == 64 || kD % 64 == 0,
                "head dim: 16, 32, 64 or a multiple of 64");
  static constexpr int kRB = kD >= 64 ? 128 : kD * 2;
  static constexpr int kKBox = kBKB * kRB;   // one box of k or v
  static constexpr int kQBox = kBQ * kRB;    // one box of q or do
  static constexpr int kKV = kBKB * kD * 2;
  static constexpr int kQ = kBQ * kD * 2;
  static constexpr int kK = 0, kV = kKV;
  static constexpr int kQD = 2 * kKV;                      // [stage][q, do]
  static constexpr int kDS = kQD + kStages * 2 * kQ;       // ds^T [128][64] bf16
  static constexpr int kDQ = kDS + kBKB * kBQ * 2;         // dq, fp32 boxes [slot]
  static constexpr int kDQRB = kD >= 32 ? 128 : kD * 4;    // bytes of a box row
  static constexpr int kDQBox = kBQ * kDQRB;               // [64][32] or [64][16]
  static constexpr int kDQTile = kBQ * kD * 4;
  static constexpr int kMeta = kDQ + kDQSlots * kDQTile;   // [stage][4][kBQ]
  static constexpr int kItem = kMeta + kStages * 4 * kBQ * 4;   // int4 [stage]
  static constexpr int kDQInfo = kItem + kStages * 16;     // int4 [slot]
  static constexpr int kStat = kDQInfo + kDQSlots * 16;    // int4 [kMaxKeyTiles]
  static constexpr int kBar = kStat + kMaxKeyTiles * 16;   // kv, full[], empty[],
                                                           // dq_full[], dq_empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages + 2 * kDQSlots) + 1024;
};

// Barriers of the block, in shared memory from L::kBar.
struct Bars {
  uint32_t kv, full, empty, dq_full, dq_empty;   // full[s] = full + 8 s, ...
  __device__ explicit Bars(uint32_t base)
      : kv(base), full(base + 8), empty(base + 8 + 8 * kStages),
        dq_full(base + 8 + 16 * kStages),
        dq_empty(base + 8 + 16 * kStages + 8 * kDQSlots) {}
};

// Warps 1-3 of the producer warpgroup: the min/max of the positions and
// segment ids of the key tiles up to the block's own, into the table at
// L::kStat.
template <int kD>
__device__ __forceinline__ void key_tile_table(const Params& p, uint8_t* smem,
                                               int warp, int lane) {
  using L = Smem<kD>;
  const int b = blockIdx.z;
  int4* const stats = reinterpret_cast<int4*>(smem + L::kStat);
  const int* const kseg = p.kseg != nullptr ? p.kseg + (size_t)b * p.S : nullptr;
  for (int i = warp - 1; i <= (int)blockIdx.x; i += 3) {
    const int4 st = row_tile_stats(p.kpos + (size_t)b * p.S, kseg, p.S,
                                   i * kBKB, lane);
    if (lane == 0) stats[i] = st;
  }
}

// `tiles_live` on a key tile's entry of the table: the producer's skip
// predicate, and the one that counts the key tiles whose dq tiles come
// before this block's.
__device__ __forceinline__ bool pair_live(const int (&q)[4], int4 k4,
                                          bool segmented, const Params& p) {
  const int k[4] = {k4.x, k4.y, k4.z, k4.w};
  return tiles_live(q, k, segmented, p.causal, p.window);
}

// The producer warp: the k and v tiles, then for each live (query tile, q
// head) item, query tiles from the last to the first, its lse (log2 units),
// delta, positions and segment ids and, by TMA, its q and do tiles into the
// next free stage, with the number of live key tiles before this block's
// for that query tile (the count dq's adds wait for); a sentinel item
// (q0 = -1) ends the consumers' loop.
template <int kD>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, const Params& p,
                                        uint8_t* smem, int lane) {
  using L = Smem<kD>;
  const int b = blockIdx.z, kvh = blockIdx.y, kt = blockIdx.x, k0 = kt * kBKB;
  const int group = p.H / p.KV;
  const bool segmented = p.qseg != nullptr;
  const Bars bar(smem_u32(smem + L::kBar));
  const int4* const stats = reinterpret_cast<const int4*>(smem + L::kStat);

  if (lane == 0) {
    mbar_arrive_tx(bar.kv, 2 * L::kKV);
#pragma unroll
    for (int x = 0; x < kD / 64 + (kD < 64); ++x) {
      tma_load_4d(smem_u32(smem + L::kK + x * L::kKBox), tk, bar.kv, 64 * x, kvh, k0, b);
      tma_load_4d(smem_u32(smem + L::kV + x * L::kKBox), tv, bar.kv, 64 * x, kvh, k0, b);
    }
  }
  named_barrier(2, 128);   // warps 1-3 have filled the key tiles' table
  const int4 kstat = stats[kt];

  int stage = 0;
  uint32_t phase = 0;
  // A tile of padding keys (segment -1) is seen by no query: no live item.
  const int n_qt = segmented && kstat.w < 0 ? 0 : (p.T + kBQ - 1) / kBQ;
  // the positions and segment ids of tile t - 1 load while tile t is handled
  int pos_next[2], seg_next[2];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = t * kBQ + lane + 32 * i;
      pos_next[i] = r < p.T ? p.qpos[(size_t)b * p.T + r] : 0;
      seg_next[i] = (r < p.T && segmented) ? p.qseg[(size_t)b * p.T + r] : 0;
    }
  };
  if (n_qt > 0) load(n_qt - 1);
  for (int t = n_qt - 1; t >= 0; --t) {
    const int q0 = t * kBQ;
    bool ok[2];
    int pos[2], seg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ok[i] = q0 + lane + 32 * i < p.T;
      pos[i] = pos_next[i];
      seg[i] = seg_next[i];
    }
    if (t > 0) load(t - 1);
    int qstat[4];
    qstat[0] = warp_min(min(ok[0] ? pos[0] : kIntMax, ok[1] ? pos[1] : kIntMax));
    qstat[1] = warp_max(max(ok[0] ? pos[0] : kIntMin, ok[1] ? pos[1] : kIntMin));
    qstat[2] = warp_min(min(ok[0] ? seg[0] : kIntMax, ok[1] ? seg[1] : kIntMax));
    qstat[3] = warp_max(max(ok[0] ? seg[0] : kIntMin, ok[1] ? seg[1] : kIntMin));
    if (!pair_live(qstat, kstat, segmented, p)) continue;
    const int ks[4] = {kstat.x, kstat.y, kstat.z, kstat.w};
    const int full = q0 + kBQ <= p.T && k0 + kBKB <= p.S &&
                     tiles_full(qstat, ks, segmented, p.causal, p.window);
    int before = 0;   // live key tiles before this one for query tile t
    for (int i0 = 0; i0 < kt; i0 += 32) {
      const int i = i0 + lane;
      before += __popc(__ballot_sync(
          0xffffffffu,
          i < kt && pair_live(qstat, stats[min(i, kt - 1)], segmented, p)));
    }
    for (int gi = 0; gi < group; ++gi) {
      const int hq = kvh * group + gi;
      mbar_wait(bar.empty + 8 * stage, phase ^ 1);
      float* const lse_s = reinterpret_cast<float*>(smem + L::kMeta) + stage * 4 * kBQ;
      float* const dlt_s = lse_s + kBQ;
      int* const qpos_s = reinterpret_cast<int*>(dlt_s + kBQ);
      int* const qseg_s = qpos_s + kBQ;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = lane + 32 * i;
        const size_t li = ((size_t)b * p.H + hq) * p.T + q0 + rr;
        lse_s[rr] = ok[i] ? p.lse[li] * kLog2e : 0.f;
        dlt_s[rr] = ok[i] ? p.delta[li] : 0.f;
        qpos_s[rr] = pos[i];
        qseg_s[rr] = seg[i];
      }
      const uint32_t fb = bar.full + 8 * stage;
      if (lane == 0) {
        reinterpret_cast<int4*>(smem + L::kItem)[stage] = make_int4(q0, hq, full, before);
        mbar_arrive_tx(fb, 2 * L::kQ);
        uint8_t* const qb = smem + L::kQD + stage * 2 * L::kQ;
#pragma unroll
        for (int x = 0; x < kD / 64 + (kD < 64); ++x) {
          tma_load_4d(smem_u32(qb + x * L::kQBox), tq, fb, 64 * x, hq, q0, b);
          tma_load_4d(smem_u32(qb + L::kQ + x * L::kQBox), tdo, fb, 64 * x, hq, q0, b);
        }
      } else {
        mbar_arrive(fb);
      }
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
  }
  mbar_wait(bar.empty + 8 * stage, phase ^ 1);
  if (lane == 0)
    reinterpret_cast<int4*>(smem + L::kItem)[stage] = make_int4(-1, 0, 0, 0);
  mbar_arrive(bar.full + 8 * stage);
}

// Warp 1 + slot of the producer warpgroup: adds each dq tile the consumers
// hand over in its slot into the accumulator, in ascending key tile per
// (batch row, q head, query tile). For each: wait until the tile's counter
// holds the number of live key tiles before this block's, add the tile by
// TMA reduce-adds, free the slot once they have read it, and bump the
// counter once they are complete in global memory. The two slots hold
// different items, so their adds need no order between them. Info with
// q0 = -1 ends it.
template <int kD>
__device__ __forceinline__ void add_dq(const CUtensorMap* tdq, const Params& p,
                                       uint8_t* smem, int lane, int slot) {
  using L = Smem<kD>;
  const int b = blockIdx.z;
  const int n_qt = (p.T + kBQ - 1) / kBQ;
  const Bars bar(smem_u32(smem + L::kBar));
  const int4* const info = reinterpret_cast<const int4*>(smem + L::kDQInfo);
  for (uint32_t phase = 0;; phase ^= 1) {
    mbar_wait(bar.dq_full + 8 * slot, phase);
    const int4 it = info[slot];   // q0, q head, -, live key tiles before
    if (it.x < 0) break;
    if (lane == 0) {
      int* const sem = p.dq_sem + ((size_t)b * p.H + it.y) * n_qt + it.x / kBQ;
      while (ld_acquire_gpu(sem) < it.w) __nanosleep(64);
      fence_proxy_async_global();   // the earlier tiles' adds before ours
      const uint32_t src = smem_u32(smem + L::kDQ + slot * L::kDQTile);
#pragma unroll
      for (int x = 0; x < kD * 4 / L::kDQRB; ++x)
        tma_reduce_add_4d(tdq, src + x * L::kDQBox, x * L::kDQRB / 4, it.x,
                          it.y, b);
      bulk_commit();
      bulk_wait_read();
      mbar_arrive(bar.dq_empty + 8 * slot);   // the slot may be written again
      bulk_wait();
      fence_proxy_async_global();
      red_release_gpu_add(sem, 1);
    }
    __syncwarp();
  }
}

// p^T and ds^T in place of s^T and dp^T for this thread's elements: element
// i is key (i % 4) / 2 of the thread's two, query row 8 (i / 4) + 2c + i % 2.
template <bool kCap, bool kMask>
__device__ __forceinline__ void p_ds(float (&s)[32], float (&dp)[32],
                                     const float* lse2, const float* dlt,
                                     const int* qpos, const int* qseg,
                                     const bool (&key_ok)[2], const int (&kp)[2],
                                     const int (&ks)[2], int q0, int c,
                                     const Params& p) {
  const bool segmented = p.qseg != nullptr;
  const float scale_log2 = p.sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qi = 8 * j + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + qi);
    const float2 dl = *reinterpret_cast<const float2*>(dlt + qi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, kj = e >> 1, r = qi + (e & 1);
      float pe, ds = dp[i] - ((e & 1) ? dl.y : dl.x);
      if constexpr (kCap) {
        const float th = tanhf(s[i] * p.sm_scale / p.softcap);
        pe = exp2f(p.softcap * th * kLog2e - ((e & 1) ? l2.y : l2.x));
        ds *= 1.f - th * th;
      } else {
        pe = exp2f(s[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
      }
      if constexpr (kMask)
        if (!(q0 + r < p.T && key_ok[kj] &&
              visible(qpos[r], qseg[r], kp[kj], ks[kj], segmented, p.causal,
                      p.window)))
          pe = 0.f;
      s[i] = pe;
      dp[i] = pe * ds;
    }
  }
}

// The two consumer warpgroups: warpgroup wg takes keys [64 wg, 64 wg + 64)
// of the block's tile for s^T, dp^T, dv and dk, and columns
// [wg D / 2, (wg + 1) D / 2) of dq, whose tile goes to the next dq slot
// for add_dq.
template <int kD>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem,
                                        int ct) {
  using L = Smem<kD>;
  constexpr int kRB = L::kRB;
  const int wg = ct / 128, w4 = (ct / 32) % 4, lane = ct % 32;
  const int g = lane >> 2, c = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kBKB;
  const bool segmented = p.qseg != nullptr;
  uint8_t* const ds_s = smem + L::kDS;
  int4* const dq_info = reinterpret_cast<int4*>(smem + L::kDQInfo);
  const Bars bar(smem_u32(smem + L::kBar));

  // this thread's two keys: rows g and g + 8 of its warp's 16 in s^T
  int key[2], kp[2], ks[2];
  bool key_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    key[j] = wg * 64 + w4 * 16 + g + 8 * j;
    key_ok[j] = k0 + key[j] < p.S;
    kp[j] = key_ok[j] ? p.kpos[(size_t)b * p.S + k0 + key[j]] : 0;
    ks[j] = (key_ok[j] && segmented) ? p.kseg[(size_t)b * p.S + k0 + key[j]] : 0;
  }

  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_a = smem_u32(smem + L::kK) + wg * 64 * kRB;
  const uint32_t v_a = smem_u32(smem + L::kV) + wg * 64 * kRB;
  const int col0 = wg * (kD / 2);
  const uint32_t kq_a = smem_u32(smem + L::kK) + (col0 / 64) * L::kKBox + (col0 % 64) * 2;
  const uint32_t ds_a = smem_u32(ds_s);

  mbar_wait(bar.kv, 0);
  int stage = 0, slot = 0;
  uint32_t phase = 0, dq_phase = 0;
  for (;;) {
    mbar_wait(bar.full + 8 * stage, phase);
    const int4 item = reinterpret_cast<const int4*>(smem + L::kItem)[stage];
    if (item.x < 0) break;
    const int q0 = item.x;
    const bool full = item.z != 0;
    const uint32_t q_a = smem_u32(smem + L::kQD + stage * 2 * L::kQ);
    const uint32_t do_a = q_a + L::kQ;
    const float* const lse_b = reinterpret_cast<const float*>(smem + L::kMeta) + stage * 4 * kBQ;
    const float* const dlt_b = lse_b + kBQ;
    const int* const qpos_b = reinterpret_cast<const int*>(dlt_b + kBQ);
    const int* const qseg_b = qpos_b + kBQ;

    // ---- s^T = k q^T and dp^T = v do^T: 64 keys x 64 rows per warpgroup ----
    float s[32], dp[32];   // the first k-step overwrites them
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t ko = (kk / 4) * L::kKBox + (kk % 4) * 32;
      const uint32_t qo = (kk / 4) * L::kQBox + (kk % 4) * 32;
      wgmma_ss<64, 0, 0>(s, desc<kRB>(k_a + ko, 16, 8 * kRB),
                         desc<kRB>(q_a + qo, 16, 8 * kRB), kk > 0);
      wgmma_ss<64, 0, 0>(dp, desc<kRB>(v_a + ko, 16, 8 * kRB),
                         desc<kRB>(do_a + qo, 16, 8 * kRB), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2), in one of
    // four forms chosen per item: with or without softcap, with or without
    // the element mask ----
    const bool mask = !full, cap = p.softcap > 0.f;
    if (cap && mask) p_ds<true, true>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, c, p);
    else if (cap) p_ds<true, false>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, c, p);
    else if (mask) p_ds<false, true>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, c, p);
    else p_ds<false, false>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, c, p);
    // as bf16 A fragments, one per 16 query rows
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kq][r] = pack_bf16(s[8 * kq + 2 * r], s[8 * kq + 2 * r + 1]);
        sa[kq][r] = pack_bf16(dp[8 * kq + 2 * r], dp[8 * kq + 2 * r + 1]);
      }

    // ---- dv += p^T do, dk += ds^T q: do and q read transposed ----
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      wgmma_rs<kD, 1>(dv, pa[kq], desc<kRB>(do_a + kq * 16 * kRB, L::kQBox, 8 * kRB), 1);
      wgmma_rs<kD, 1>(dk, sa[kq], desc<kRB>(q_a + kq * 16 * kRB, L::kQBox, 8 * kRB), 1);
    }
    wgmma_commit();

    // ---- ds^T to shared memory: 64 query rows (128 B) per key, swizzled ----
    named_barrier(1, kConsumers);    // both warpgroups are done with the last ds^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int kj = 0; kj < 2; ++kj)
        *reinterpret_cast<uint32_t*>(ds_s + key[kj] * 128 + ((j ^ g) << 4) + 4 * c) =
            sa[j >> 1][(j & 1) * 2 + kj];
    fence_proxy_async();
    named_barrier(1, kConsumers);    // ds^T of all 128 keys is in shared memory

    // ---- dq = ds k for this warpgroup's half of D, over the 128 keys ----
    float dqa[kD / 4];
#pragma unroll
    for (int i = 0; i < kD / 4; ++i) dqa[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKB / 16; ++kk)
      wgmma_ss<kD / 2, 1, 1>(dqa, desc<128>(ds_a + kk * 16 * 128, 16, 1024),
                             desc<kRB>(kq_a + kk * 16 * kRB, L::kKBox, 8 * kRB), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      fence_regs(pa[kq]);
      fence_regs(sa[kq]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.empty + 8 * stage);   // q, do, meta are free

    // ---- the dq tile, scaled by 1/sqrt(D), to the next dq slot as swizzled
    // boxes of kDQRB-byte rows, for add_dq: rows 16 w4 + g (+ 8), columns
    // col0 + 8 j + 2 c ----
    mbar_wait(bar.dq_empty + 8 * slot, dq_phase ^ 1);
    uint8_t* const dq_s = smem + L::kDQ + slot * L::kDQTile;
#pragma unroll
    for (int j = 0; j < kD / 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = (col0 + 8 * j + 2 * c) * 4;   // in bytes
        const int row = w4 * 16 + g + 8 * i;
        *reinterpret_cast<float2*>(
            dq_s + (col / L::kDQRB) * L::kDQBox +
            swizzle<L::kDQRB>(row * L::kDQRB + col % L::kDQRB)) =
            make_float2(dqa[4 * j + 2 * i] * p.sm_scale,
                        dqa[4 * j + 2 * i + 1] * p.sm_scale);
      }
    fence_proxy_async();
    if (ct == 0) dq_info[slot] = item;   // q0, q head, -, key tiles before
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.dq_full + 8 * slot);
    if (++slot == kDQSlots) { slot = 0; dq_phase ^= 1; }
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  }
  // the end of both add_dq loops
  for (int k = 0; k < kDQSlots; ++k) {
    mbar_wait(bar.dq_empty + 8 * slot, dq_phase ^ 1);
    if (ct == 0) dq_info[slot] = make_int4(-1, 0, 0, 0);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.dq_full + 8 * slot);
    if (++slot == kDQSlots) { slot = 0; dq_phase ^= 1; }
  }

  // ---- dk, dv: element i of this thread's keys, column 8 (i / 4) + 2c ----
  const size_t kv_rs = (size_t)p.KV * kD;
#pragma unroll
  for (int kj = 0; kj < 2; ++kj) {
    if (!key_ok[kj]) continue;
    const size_t r = ((size_t)b * p.S + k0 + key[kj]) * kv_rs + (size_t)kvh * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int d = 8 * j + 2 * c, i = 4 * j + 2 * kj;
      *reinterpret_cast<uint32_t*>(p.dk + r + d) =
          pack_bf16(dk[i] * p.sm_scale, dk[i + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(p.dv + r + d) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdq, const Params p) {
  using L = Smem<kD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  if (tid == 0) {
    const Bars bar(smem_u32(smem + L::kBar));
    mbar_init(bar.kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.full + 8 * s, 32);                // the producer warp
      mbar_init(bar.empty + 8 * s, kConsumers / 32);  // each consumer warp
    }
    for (int s = 0; s < kDQSlots; ++s) {
      mbar_init(bar.dq_full + 8 * s, kConsumers / 32);   // each consumer warp
      mbar_init(bar.dq_empty + 8 * s, 1);                // its add_dq warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Registers: the launch gives every thread 168 (65536 / 384, rounded
  // down to 8). The producer warpgroup gives back 168 - 40 a thread and
  // the consumers take 232 - 168; the two must match (40 + 2 x 232 =
  // 3 x 168), or setmaxnreg.inc waits for ever.
  if (tid < 128) {   // the producer warpgroup: warp 0 feeds, 1 and 2 add dq
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = tid / 32, lane = tid % 32;
    if (warp > 0) key_tile_table<kD>(p, smem, warp, lane);
    if (warp == 0) produce<kD>(&tq, &tdo, &tk, &tv, p, smem, lane);
    else named_barrier_arrive(2, 128);
    if (warp == 1 || warp == 2) add_dq<kD>(&tdq, p, smem, lane, warp - 1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<kD>(p, smem, tid - 128);
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq_acc, int T_acc, const Params& p, cudaStream_t stream) {
  using L = Smem<kD>;
  constexpr auto kBF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t inner = L::kRB / 2;
  // q and do (B, T, H, D), k and v (B, S, KV, D) in bf16; the accumulator
  // (B, H, T_acc, D) in fp32
  const cuuint64_t qdims[4] = {kD, (cuuint64_t)p.H, (cuuint64_t)p.T, (cuuint64_t)p.B};
  const cuuint64_t kdims[4] = {kD, (cuuint64_t)p.KV, (cuuint64_t)p.S, (cuuint64_t)p.B};
  const cuuint64_t adims[4] = {kD, (cuuint64_t)T_acc, (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint32_t qbox[4] = {inner, 1, kBQ, 1}, kbox[4] = {inner, 1, kBKB, 1};
  const cuuint32_t abox[4] = {L::kDQRB / 4, kBQ, 1, 1};
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!make_map(&tq, kBF16, 2, q, qdims, qbox) ||
      !make_map(&tdo, kBF16, 2, dout, qdims, qbox) ||
      !make_map(&tk, kBF16, 2, k, kdims, kbox) ||
      !make_map(&tv, kBF16, 2, v, kdims, kbox) ||
      !make_map(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, adims, abox))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(mha_bwd_kernel<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Smem<kD>::kBytes);
  mha_bwd_kernel<kD><<<dim3((p.S + kBKB - 1) / kBKB, p.KV, p.B), kThreads,
                       Smem<kD>::kBytes, stream>>>(tq, tdo, tk, tv, tdq, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// head dim 256
// ---------------------------------------------------------------------
// The wgmma form above does not fit at D 256: k and v resident at 64 KiB
// each, two stages of q and do at 128 KiB and two fp32 dq slots of 64 rows
// x 256 at 128 KiB come to about 421000 B of shared memory against
// 232448, and dk and dv would take 256 fp32 registers of each consumer
// thread. This form is simple instead, on mma.sync m16n8k16 with ldmatrix
// from shared rows padded to 264 bf16:
//  - One block per (64 keys, KV head, batch row), eight warps. Warp w
//    takes keys [16 (w % 4), +16) and columns [128 (w / 4), +128): its
//    dk and dv are 16 keys x 128 columns, 64 fp32 registers each. The two
//    warps of a key group both compute s^T = k q^T and dp^T = v do^T over
//    the whole of D (the products of s and dp are done twice: 14 D FLOPs a
//    pair where 10 D are needed), so no partial sums cross warps.
//  - The block walks the live (64-row query tile, q head of the GQA group)
//    items, query tiles from the last to the first, as the other form;
//    every warp finds the live query tiles itself (`tiles_live` on the
//    tiles' min/max), and the next item's q, do, lse, delta, positions and
//    segment ids load by cp.async into the second of two stages while this
//    one is computed.
//  - Per item: p^T and ds^T in registers (the softcap chain as the other
//    form), dv += p^T do and dk += ds^T q (do and q read transposed by
//    ldmatrix), ds^T to shared memory, then dq = ds k with warp w taking
//    query rows [16 (w % 4), +16) and columns [128 (w / 4), +128).
//  - dq's tile is added into the caller's zeroed fp32 accumulator in the
//    same order as the other form: the block waits until the counter of
//    (batch row, q head, query tile) holds the number of live key tiles
//    before its own (counted by warp 0 from a table of the key tiles'
//    statistics), then every thread adds its part with loads and stores
//    that bypass L1, and after a fence and a barrier one thread bumps the
//    counter (release). So dq is repeatable bit for bit, its sums taken
//    in ascending key tile as fp32 adds, as the reduce-adds of the other
//    form take them.
// Shared memory: k and v 64 x 264 bf16 (67584 B), two stages of q and do
// (135168 B), ds^T 64 x 72 bf16 (9216 B), two stages of lse, delta,
// positions and segment ids (2048 B), the statistics of up to 1024 key
// tiles (16384 B: S <= 65536 as the other form): 230400 B of the 232448 a
// block may have. Bound as the other form: 10 D FLOPs per visible pair.
constexpr int kD256 = 256;
constexpr int kStride256 = kD256 + 8;       // bf16 per shared row of k, v, q, do
constexpr int kBK256 = 64;                  // keys per block
constexpr int kDSStride = kBQ + 8;          // bf16 per shared row of ds^T
constexpr int kMaxKeyTiles256 = kMaxKeyTiles * kBKB / kBK256;
constexpr int kThreads256 = 256;
struct Smem256 {
  static constexpr int kTile = 64 * kStride256 * 2;          // 64 rows of k, v, q or do
  static constexpr int kK = 0, kV = kTile;
  static constexpr int kQD = 2 * kTile;                      // [stage][q, do]
  static constexpr int kDS = kQD + kStages * 2 * kTile;      // ds^T [key][row]
  static constexpr int kMeta = kDS + kBK256 * kDSStride * 2; // [stage][lse, delta, pos, seg][kBQ]
  static constexpr int kStat = kMeta + kStages * 4 * kBQ * 4;   // int4 [kMaxKeyTiles256]
  static constexpr int kBytes = kStat + kMaxKeyTiles256 * 16;
};
static_assert(kBQ == 64 && Smem256::kBytes <= 232448, "shared memory of a block");

__global__ void __launch_bounds__(kThreads256, 1)
mha_bwd_d256_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    float* dq_acc, int T_acc, const Params p) {
  using L = Smem256;
  constexpr int kD = kD256, kStride = kStride256;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const k_s = reinterpret_cast<uint16_t*>(smem + L::kK);
  uint16_t* const v_s = reinterpret_cast<uint16_t*>(smem + L::kV);
  uint16_t* const ds_s = reinterpret_cast<uint16_t*>(smem + L::kDS);
  int4* const stats = reinterpret_cast<int4*>(smem + L::kStat);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;   // mma fragment row group / column pair
  const int mi = lane >> 3, r8 = lane & 7; // ldmatrix: matrix and row this lane addresses
  const int kg = warp & 3, col0 = (warp >> 2) * 128;   // key (and dq row) group, columns
  const int b = blockIdx.z, kvh = blockIdx.y, kt = blockIdx.x, k0 = kt * kBK256;
  const int group = p.H / p.KV;
  const bool segmented = p.qseg != nullptr;
  const int* const kpos = p.kpos + (size_t)b * p.S;
  const int* const kseg = segmented ? p.kseg + (size_t)b * p.S : nullptr;
  const int* const qpos = p.qpos + (size_t)b * p.T;
  const int* const qseg = segmented ? p.qseg + (size_t)b * p.T : nullptr;
  const size_t q_rs = (size_t)p.H * kD, kv_rs = (size_t)p.KV * kD;

  // ---- k and v of the block's keys, zeros past S: one cp.async group ----
#pragma unroll
  for (int j = 0; j < kBK256 * (kD / 8) / kThreads256; ++j) {
    const int i = tid + j * kThreads256;
    const int r = i / (kD / 8), ch = i % (kD / 8);
    const bool in = k0 + r < p.S;
    const size_t off = in ? ((size_t)b * p.S + k0 + r) * kv_rs + (size_t)kvh * kD + ch * 8 : 0;
    cp_async16(k_s + r * kStride + ch * 8, k + off, in);
    cp_async16(v_s + r * kStride + ch * 8, v + off, in);
  }
  cp_async_commit();
  // ---- the statistics of key tiles 0..kt ----
  for (int i = warp; i <= kt; i += kThreads256 / 32) {
    const int4 st = row_tile_stats<kBK256>(kpos, kseg, p.S, i * kBK256, lane);
    if (lane == 0) stats[i] = st;
  }
  __syncthreads();
  const int kstat[4] = {stats[kt].x, stats[kt].y, stats[kt].z, stats[kt].w};

  // this thread's two keys: rows g and g + 8 of its warp's 16 in s^T
  int key[2], kp[2], ks[2];
  bool key_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    key[j] = kg * 16 + g + 8 * j;
    key_ok[j] = k0 + key[j] < p.S;
    kp[j] = key_ok[j] ? kpos[k0 + key[j]] : 0;
    ks[j] = (key_ok[j] && segmented) ? kseg[k0 + key[j]] : 0;
  }

  // The next live query tile at or below t (-1 if none), and whether every
  // pair of it and the block's keys is visible.
  auto next_live = [&](int t, bool& full) -> int {
    for (; t >= 0; --t) {
      const int4 q4 = row_tile_stats<kBQ>(qpos, qseg, p.T, t * kBQ, lane);
      const int qstat[4] = {q4.x, q4.y, q4.z, q4.w};
      if (!tiles_live(qstat, kstat, segmented, p.causal, p.window)) continue;
      full = (t + 1) * kBQ <= p.T && k0 + kBK256 <= p.S &&
             tiles_full(qstat, kstat, segmented, p.causal, p.window);
      return t;
    }
    return -1;
  };
  // q and do of (query tile t, q head hq), zeros past T, their lse (log2
  // units), delta, positions and segment ids, into stage `stage`
  auto issue = [&](int t, int hq, int stage) {
    uint16_t* const qb = reinterpret_cast<uint16_t*>(smem + L::kQD + stage * 2 * L::kTile);
    uint16_t* const db = qb + kBQ * kStride;
#pragma unroll
    for (int j = 0; j < kBQ * (kD / 8) / kThreads256; ++j) {
      const int i = tid + j * kThreads256;
      const int r = i / (kD / 8), ch = i % (kD / 8);
      const int row = t * kBQ + r;
      const bool in = row < p.T;
      const size_t off = in ? ((size_t)b * p.T + row) * q_rs + (size_t)hq * kD + ch * 8 : 0;
      cp_async16(qb + r * kStride + ch * 8, q + off, in);
      cp_async16(db + r * kStride + ch * 8, dout + off, in);
    }
    cp_async_commit();
    if (tid < kBQ) {
      float* const meta = reinterpret_cast<float*>(smem + L::kMeta) + stage * 4 * kBQ;
      const int row = t * kBQ + tid;
      const bool ok = row < p.T;
      const size_t li = ((size_t)b * p.H + hq) * p.T + row;
      meta[tid] = ok ? p.lse[li] * kLog2e : 0.f;
      meta[kBQ + tid] = ok ? p.delta[li] : 0.f;
      reinterpret_cast<int*>(meta)[2 * kBQ + tid] = ok ? qpos[row] : 0;
      reinterpret_cast<int*>(meta)[3 * kBQ + tid] = (ok && segmented) ? qseg[row] : 0;
    }
  };

  float dk[kD / 16][4], dv[kD / 16][4];   // 16 keys x 128 columns each
#pragma unroll
  for (int n = 0; n < kD / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale_log2 = p.sm_scale * kLog2e;
  const uint16_t* const kw = k_s + kg * 16 * kStride;
  const uint16_t* const vw = v_s + kg * 16 * kStride;

  const int n_qt = (p.T + kBQ - 1) / kBQ;
  bool full = false, full_next = false;
  int t = next_live(n_qt - 1, full), gi = 0, stage = 0;
  if (t >= 0) issue(t, kvh * group, 0);
  while (t >= 0) {
    const int hq = kvh * group + gi;
    int t_next = t, gi_next = gi + 1;   // the item after this one
    full_next = full;
    if (gi_next == group) {
      gi_next = 0;
      t_next = next_live(t - 1, full_next);
    }
    if (t_next >= 0) {
      issue(t_next, kvh * group + gi_next, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // k, v and this item's stage are in shared memory
    const uint16_t* const qb = reinterpret_cast<const uint16_t*>(
        smem + L::kQD + stage * 2 * L::kTile);
    const uint16_t* const db = qb + kBQ * kStride;
    const float* const lse2 = reinterpret_cast<const float*>(smem + L::kMeta) + stage * 4 * kBQ;
    const float* const dlt = lse2 + kBQ;
    const int* const qpos_b = reinterpret_cast<const int*>(dlt + kBQ);
    const int* const qseg_b = qpos_b + kBQ;
    const int q0 = t * kBQ;

    // ---- s^T = k q^T and dp^T = v do^T: the warp's 16 keys x 64 rows ----
    float s[kBQ / 8][4], dp[kBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t ka[4], va[4];   // A fragments: the warp's keys, dims 16 kk..
      ldsm_x4(ka, kw + ((mi & 1) * 8 + r8) * kStride + kk * 16 + (mi >> 1) * 8);
      ldsm_x4(va, vw + ((mi & 1) * 8 + r8) * kStride + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int n = 0; n < kBQ / 8; n += 2) {
        uint32_t qf[4], df[4];   // b0, b1 of n-tiles (query rows) n and n + 1
        const int off = ((n + (mi >> 1)) * 8 + r8) * kStride + kk * 16 + (mi & 1) * 8;
        ldsm_x4(qf, qb + off);
        ldsm_x4(df, db + off);
        mma_bf16(s[n], ka, qf[0], qf[1]);
        mma_bf16(s[n + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[n], va, df[0], df[1]);
        mma_bf16(dp[n + 1], va, df[2], df[3]);
      }
    }

    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2): element e of
    // n-tile n is key g + 8 (e / 2), query row 8 n + 2 c + e % 2 ----
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = e >> 1, r = 8 * n + 2 * c + (e & 1);
        float pe, ds = dp[n][e] - dlt[r];
        if (p.softcap > 0.f) {
          const float th = tanhf(s[n][e] * p.sm_scale / p.softcap);
          pe = exp2f(p.softcap * th * kLog2e - lse2[r]);
          ds *= 1.f - th * th;
        } else {
          pe = exp2f(s[n][e] * scale_log2 - lse2[r]);
        }
        if (!full &&
            !(q0 + r < p.T && key_ok[kj] &&
              visible(qpos_b[r], qseg_b[r], kp[kj], ks[kj], segmented,
                      p.causal, p.window)))
          pe = 0.f;
        s[n][e] = pe;
        dp[n][e] = pe * ds;
      }
    }
    // as bf16 A fragments (keys x 16 query rows), one per 16 rows
    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
#pragma unroll
    for (int kq = 0; kq < kBQ / 16; ++kq) {
      pa[kq][0] = pack_bf16(s[2 * kq][0], s[2 * kq][1]);
      pa[kq][1] = pack_bf16(s[2 * kq][2], s[2 * kq][3]);
      pa[kq][2] = pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]);
      pa[kq][3] = pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3]);
      sa[kq][0] = pack_bf16(dp[2 * kq][0], dp[2 * kq][1]);
      sa[kq][1] = pack_bf16(dp[2 * kq][2], dp[2 * kq][3]);
      sa[kq][2] = pack_bf16(dp[2 * kq + 1][0], dp[2 * kq + 1][1]);
      sa[kq][3] = pack_bf16(dp[2 * kq + 1][2], dp[2 * kq + 1][3]);
    }

    // ---- dv += p^T do, dk += ds^T q over the warp's 128 columns ----
#pragma unroll
    for (int kq = 0; kq < kBQ / 16; ++kq) {
      const int off = (kq * 16 + (mi & 1) * 8 + r8) * kStride + col0 + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kD / 16; n += 2) {
        uint32_t bf[4];   // b0, b1 of n-tiles (columns) n and n + 1
        ldsm_x4_trans(bf, db + off + n * 8);
        mma_bf16(dv[n], pa[kq], bf[0], bf[1]);
        mma_bf16(dv[n + 1], pa[kq], bf[2], bf[3]);
        ldsm_x4_trans(bf, qb + off + n * 8);
        mma_bf16(dk[n], sa[kq], bf[0], bf[1]);
        mma_bf16(dk[n + 1], sa[kq], bf[2], bf[3]);
      }
    }

    // ---- ds^T to shared memory, [key][query row], by the warps of the
    // first column half (the second holds the same) ----
    if (col0 == 0) {
#pragma unroll
      for (int kq = 0; kq < kBQ / 16; ++kq)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<uint32_t*>(
              ds_s + (kg * 16 + g + 8 * (r & 1)) * kDSStride + kq * 16 +
              8 * (r >> 1) + 2 * c) = sa[kq][r];
    }
    __syncthreads();   // ds^T of the block's 64 keys is in shared memory

    // ---- dq = ds k: query rows 16 kg.., columns col0.., over the 64 keys;
    // ds read transposed from ds^T ----
    float dqa[kD / 16][4];
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK256 / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4_trans(af, ds_s + (kk * 16 + (mi >> 1) * 8 + r8) * kDSStride +
                            kg * 16 + (mi & 1) * 8);
      const uint16_t* const kb = k_s + (kk * 16 + (mi & 1) * 8 + r8) * kStride +
                                 col0 + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < kD / 16; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, kb + n * 8);
        mma_bf16(dqa[n], af, bf[0], bf[1]);
        mma_bf16(dqa[n + 1], af, bf[2], bf[3]);
      }
    }

    // ---- dq's tile into the accumulator, after the live key tiles before
    // this one (for this query tile), in ascending order ----
    int* const sem = p.dq_sem + ((size_t)b * p.H + hq) * n_qt + t;
    if (warp == 0) {
      const int4 q4 = row_tile_stats<kBQ>(qpos, qseg, p.T, q0, lane);
      const int qstat[4] = {q4.x, q4.y, q4.z, q4.w};
      int before = 0;
      for (int i0 = 0; i0 < kt; i0 += 32) {
        const int i = min(i0 + lane, kt - 1);
        const int st[4] = {stats[i].x, stats[i].y, stats[i].z, stats[i].w};
        before += __popc(__ballot_sync(
            0xffffffffu, i0 + lane < kt &&
                             tiles_live(qstat, st, segmented, p.causal, p.window)));
      }
      if (lane == 0)
        while (ld_acquire_gpu(sem) < before) __nanosleep(64);
    }
    __syncthreads();   // the earlier key tiles' adds are complete
    float* const acc = dq_acc + (((size_t)b * p.H + hq) * T_acc + q0 + kg * 16) * kD + col0;
#pragma unroll
    for (int n = 0; n < kD / 16; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float2* const a = reinterpret_cast<float2*>(acc + (g + 8 * i) * kD + 8 * n + 2 * c);
        float2 x = __ldcg(a);
        x.x += dqa[n][2 * i] * p.sm_scale;
        x.y += dqa[n][2 * i + 1] * p.sm_scale;
        __stcg(a, x);
      }
    __threadfence();
    __syncthreads();   // every thread's adds are in global memory
    if (tid == 0) red_release_gpu_add(sem, 1);

    t = t_next;
    gi = gi_next;
    full = full_next;
    stage ^= 1;
  }
  cp_async_wait<0>();   // k and v, where no item was live

  // ---- dk, dv: element e of n-tile n is key g + 8 (e / 2), column col0 +
  // 8 n + 2 c + e % 2 ----
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!key_ok[j]) continue;
    const size_t r = ((size_t)b * p.S + k0 + key[j]) * kv_rs + (size_t)kvh * kD + col0;
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      const int d = 8 * n + 2 * c;
      *reinterpret_cast<uint32_t*>(p.dk + r + d) =
          pack_bf16(dk[n][2 * j] * p.sm_scale, dk[n][2 * j + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(p.dv + r + d) = pack_bf16(dv[n][2 * j], dv[n][2 * j + 1]);
    }
  }
}

int launch_d256(const void* q, const void* k, const void* v, const void* dout,
                void* dq_acc, int T_acc, const Params& p, cudaStream_t stream) {
  cudaFuncSetAttribute(mha_bwd_d256_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, Smem256::kBytes);
  // blocks of lower blockIdx.x in a (KV head, batch row) launch first: the
  // dq order's waits end, as in the other form
  mha_bwd_d256_kernel<<<dim3((p.S + kBK256 - 1) / kBK256, p.KV, p.B), kThreads256,
                        Smem256::kBytes, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<float*>(dq_acc), T_acc, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, do: bf16 (B,T,H,D); k, v: bf16 (B,S,KV,D); lse, delta: fp32 (B,H,T);
// positions and segment ids int32 (B,T) / (B,S), segment ids both null or
// both set; all contiguous and 16-byte aligned, D in {16, 32, 64, 128, 256};
// sm_scale is 1/sqrt(D), or 1/sqrt of the caller's head dim where it
// padded q, k, v and do with zero columns up to D.
// Adds ds k x sm_scale into dq_acc, fp32 (B,H,T_acc,D) zeroed by the
// caller, where T_acc must be T rounded up to kBQ (refused otherwise, so
// the reduce-adds never pass the buffer's end), in ascending key tile per
// (batch row, head, query tile), ordered by dq_sem, int32 (B,H,T_acc / kBQ)
// zeroed by the caller (refused when null); writes dk, dv: bf16
// (B,S,KV,D). S is at most kMaxKeyTiles x 128 = 65536. D 256 takes its
// own form, mha_bwd_d256_kernel, with the same arguments. Launches on
// `stream` and returns a CUDA error code (0: launched).
extern "C" int mha_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* qpos,
                            const void* kpos, const void* qseg,
                            const void* kseg, void* dq_acc, int T_acc,
                            void* dq_sem, void* dk, void* dv, int B, int T,
                            int S, int H,
                            int KV, int D, int causal, int window,
                            float softcap, float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || T <= 0 || S <= 0 ||
      S > kMaxKeyTiles * kBKB || T_acc != (T + kBQ - 1) / kBQ * kBQ ||
      dq_sem == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dq_sem = static_cast<int*>(dq_sem);
  p.dk = static_cast<uint16_t*>(dk);
  p.dv = static_cast<uint16_t*>(dv);
  p.B = B; p.T = T; p.S = S; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.softcap = softcap;
  p.sm_scale = sm_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, dout, dq_acc, T_acc, p, st);
    case 32: return launch<32>(q, k, v, dout, dq_acc, T_acc, p, st);
    case 64: return launch<64>(q, k, v, dout, dq_acc, T_acc, p, st);
    case 128: return launch<128>(q, k, v, dout, dq_acc, T_acc, p, st);
    case 256: return launch_d256(q, k, v, dout, dq_acc, T_acc, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of the backward at head dim D, in bytes (the
// wgmma form's up to D 128, alignment slack included; at D 256 the
// mma.sync form's), or 0 for a head dim it does not take.
extern "C" int mha_bwd_smem(int D) {
  switch (D) {
    case 16: return Smem<16>::kBytes;
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    case 128: return Smem<128>::kBytes;
    case 256: return Smem256::kBytes;
    default: return 0;
  }
}
