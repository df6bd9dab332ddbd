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
// Design (D up to 128; D 256 has its own wgmma form, `mha_bwd_d256_kernel`,
// at the end of this file). One pass over the live (query tile, key tile)
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
// segment ids of the key tiles of kKeys keys up to the block's own, into
// the table `stats`.
template <int kKeys>
__device__ __forceinline__ void key_tile_table(const Params& p, int4* stats,
                                               int warp, int lane) {
  const int b = blockIdx.z;
  const int* const kseg = p.kseg != nullptr ? p.kseg + (size_t)b * p.S : nullptr;
  for (int i = warp - 1; i <= (int)blockIdx.x; i += 3) {
    const int4 st = row_tile_stats<kKeys>(p.kpos + (size_t)b * p.S, kseg, p.S,
                                          i * kKeys, lane);
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
    if (warp > 0)
      key_tile_table<kBKB>(p, reinterpret_cast<int4*>(smem + L::kStat), warp, lane);
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
// The form above does not fit at D 256: for 128 keys, k and v resident
// (128 KiB), two stages of q and do (128 KiB) and two fp32 dq slots
// (128 KiB) come to about 421000 B of shared memory against 232448, and dk
// and dv would take 256 fp32 registers of a consumer thread. This form
// splits the work of an item otherwise, each product done once (10 D
// FLOPs per pair):
//  - One block per (64 keys, KV head, batch row): a producer warpgroup and
//    two consumer warpgroups. k and v stay in shared memory; the block
//    walks the live (64-row query tile, q head of the GQA group) items,
//    query tiles from the last to the first, as the other form.
//  - Per item, consumer warpgroup w takes query rows [32 w, 32 w + 32):
//    s^T = k q^T and dp^T = v do^T over the whole of D (wgmma, 64 keys x 32
//    rows), then p^T and ds^T = p^T (dp^T - delta) (1 - tanh^2) in fp32
//    registers (the softcap chain and the element mask in one of four
//    forms, as the other form), rounded to bf16 into the item's buffer of
//    p^T and ds^T in shared memory. The two warpgroups do this elementwise
//    work side by side, each on half of the item.
//  - Two barriers of both warpgroups (named barriers 2, the last item's
//    p^T and ds^T are no longer read, and 1, this item's are written)
//    frame the writes. Then each warpgroup owns one 128-column half of D:
//    dv += p^T do and dk += ds^T q, both operands from shared memory (64 +
//    64 fp32 registers a thread), and dq = ds k in two 64-column quarters
//    (32 fp32), ds read transposed from ds^T through its descriptor.
//  - q and do have one buffer each, released on their own as soon as their
//    last readers are done: do after dp^T and both dv products, q (with the
//    item's lse, delta, positions and segment ids) after s^T and both dk
//    products. The producer loads the next item's do during the dk and dq
//    products, and its q during the dq products. A second stage of q and
//    do (+65536 B) does not fit; a cluster of two blocks sharing them by
//    TMA multicast would, at the cost of pairing blocks whose items differ
//    (their key tiles see different query tiles), so this form keeps one
//    block and the early release.
//  - Warpgroup w stages its dq quarters, scaled by 1/sqrt(D), in its own
//    two slots, 2 w and 2 w + 1 (64 x 64 fp32 each, as 128-byte-swizzled
//    boxes of 32 columns), so that it waits for the adds only when they
//    are a whole item behind. Warp 1 + w of the producer warpgroup adds
//    them into the caller's zeroed accumulator by TMA reduce-adds, after
//    waiting (acquire) until the counter of (batch row, q head, query tile)
//    reaches twice the number of live key tiles before its own, and bumps
//    it (release) once the second quarter is complete in global memory:
//    each key tile bumps it twice, once per column half. So dq's sums are
//    taken in ascending key tile, as the other form takes them, and dq, dk
//    and dv repeat bit for bit.
// Shared memory: k, v, q and do 64 x 256 bf16 each (131072 B); p^T and
// ds^T (16384 B); four dq slots (65536 B); lse, delta, positions and
// segment ids (1024 B); items; the statistics of up to 1024 key tiles
// (16384 B: S <= 65536 as the other form); barriers and the alignment
// slack: 231608 B of the 232448 a block may have. Registers: dk and dv
// (128 fp32) and s^T and dp^T (32) or a dq quarter (32) a consumer thread,
// under the 232 setmaxnreg gives it. Bound as the other form: 10 D FLOPs
// per visible pair.
constexpr int kD256 = 256;
constexpr int kBK256 = 64;                  // keys per block
constexpr int kMaxKeyTiles256 = kMaxKeyTiles * kBKB / kBK256;
struct Smem256 {
  static constexpr int kRB = 128;                   // bytes of a box row: 64 bf16
  static constexpr int kBox = 64 * kRB;             // 64 rows x 64 columns
  static constexpr int kTile = kD256 / 64 * kBox;   // 64 rows x 256: k, v, q, do
  static constexpr int kK = 0, kV = kTile, kQ = 2 * kTile, kDO = 3 * kTile;
  static constexpr int kPS = 4 * kTile;             // p^T, ds^T bf16 [key][row]
  static constexpr int kDQBox = 64 * 128;           // 64 rows of 32 fp32
  static constexpr int kDQTile = 2 * kDQBox;        // a dq quarter, 64 x 64 fp32
  static constexpr int kDQ = kPS + 2 * kBox;        // [2 w + quarter] dq quarter
  static constexpr int kMeta = kDQ + 4 * kDQTile;   // lse, delta, pos, seg [kBQ] each
  static constexpr int kItem = kMeta + 4 * kBQ * 4; // int4
  static constexpr int kDQInfo = kItem + 16;        // int4 [slot]
  static constexpr int kStat = kDQInfo + 4 * 16;    // int4 [kMaxKeyTiles256]
  // barriers: kv, q full, q empty, do full, do empty, dq full [4], dq empty [4]
  static constexpr int kBar = kStat + kMaxKeyTiles256 * 16;
  static constexpr int kBytes = kBar + 8 * 13 + 1024;
};
static_assert(kBQ == 64 && Smem256::kBytes <= 232448, "shared memory of a block");

struct Bars256 {
  uint32_t kv, q_full, q_empty, do_full, do_empty, dq_full, dq_empty;   // dq_*[slot]
  __device__ explicit Bars256(uint32_t base)
      : kv(base), q_full(base + 8), q_empty(base + 16), do_full(base + 24),
        do_empty(base + 32), dq_full(base + 40), dq_empty(base + 72) {}
};

// The producer warp: the k and v tiles, then for each live (query tile,
// q head) item, query tiles from the last to the first, its do tile, then
// its lse (log2 units), delta, positions and segment ids, the item (q0,
// q head, full, live key tiles before this block's) and its q tile, each
// into its buffer once the consumers have freed it; a sentinel item
// (q0 = -1) ends the consumers' loop.
__device__ __forceinline__ void produce256(const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const Params& p, uint8_t* smem,
                                           int lane) {
  using L = Smem256;
  const int b = blockIdx.z, kvh = blockIdx.y, kt = blockIdx.x, k0 = kt * kBK256;
  const int group = p.H / p.KV;
  const bool segmented = p.qseg != nullptr;
  const Bars256 bar(smem_u32(smem + L::kBar));
  const int4* const stats = reinterpret_cast<const int4*>(smem + L::kStat);

  if (lane == 0) {
    mbar_arrive_tx(bar.kv, 2 * L::kTile);
#pragma unroll
    for (int x = 0; x < kD256 / 64; ++x) {
      tma_load_4d(smem_u32(smem + L::kK + x * L::kBox), tk, bar.kv, 64 * x, kvh, k0, b);
      tma_load_4d(smem_u32(smem + L::kV + x * L::kBox), tv, bar.kv, 64 * x, kvh, k0, b);
    }
  }
  named_barrier(5, 128);   // warps 1-3 have filled the key tiles' table
  const int4 kstat = stats[kt];

  uint32_t phase = 0;
  // A tile of padding keys (segment -1) is seen by no query: no live item.
  const int n_qt = segmented && kstat.w < 0 ? 0 : (p.T + kBQ - 1) / kBQ;
  for (int t = n_qt - 1; t >= 0; --t) {
    const int q0 = t * kBQ;
    bool ok[2];
    int pos[2], seg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + lane + 32 * i;
      ok[i] = r < p.T;
      pos[i] = ok[i] ? p.qpos[(size_t)b * p.T + r] : 0;
      seg[i] = (ok[i] && segmented) ? p.qseg[(size_t)b * p.T + r] : 0;
    }
    int qstat[4];
    qstat[0] = warp_min(min(ok[0] ? pos[0] : kIntMax, ok[1] ? pos[1] : kIntMax));
    qstat[1] = warp_max(max(ok[0] ? pos[0] : kIntMin, ok[1] ? pos[1] : kIntMin));
    qstat[2] = warp_min(min(ok[0] ? seg[0] : kIntMax, ok[1] ? seg[1] : kIntMax));
    qstat[3] = warp_max(max(ok[0] ? seg[0] : kIntMin, ok[1] ? seg[1] : kIntMin));
    if (!pair_live(qstat, kstat, segmented, p)) continue;
    const int ks[4] = {kstat.x, kstat.y, kstat.z, kstat.w};
    const int full = q0 + kBQ <= p.T && k0 + kBK256 <= p.S &&
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
      mbar_wait(bar.do_empty, phase ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(bar.do_full, L::kTile);
#pragma unroll
        for (int x = 0; x < kD256 / 64; ++x)
          tma_load_4d(smem_u32(smem + L::kDO + x * L::kBox), tdo, bar.do_full,
                      64 * x, hq, q0, b);
      }
      mbar_wait(bar.q_empty, phase ^ 1);
      float* const lse_s = reinterpret_cast<float*>(smem + L::kMeta);
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
      if (lane == 0) {
        *reinterpret_cast<int4*>(smem + L::kItem) = make_int4(q0, hq, full, before);
        mbar_arrive_tx(bar.q_full, L::kTile);
#pragma unroll
        for (int x = 0; x < kD256 / 64; ++x)
          tma_load_4d(smem_u32(smem + L::kQ + x * L::kBox), tq, bar.q_full,
                      64 * x, hq, q0, b);
      } else {
        mbar_arrive(bar.q_full);
      }
      phase ^= 1;
    }
  }
  mbar_wait(bar.q_empty, phase ^ 1);
  if (lane == 0) *reinterpret_cast<int4*>(smem + L::kItem) = make_int4(-1, 0, 0, 0);
  mbar_arrive(bar.q_full);
}

// Warp 1 + w of the producer warpgroup: adds the dq quarters that consumer
// warpgroup w stages in its slots 2 w and 2 w + 1 into the accumulator,
// item by item. Before an item's first quarter it waits until the tile's
// counter holds twice the live key tiles before this block's; after its
// second, once the adds are complete in global memory, it bumps the
// counter. Info with q0 = -1 in slot 2 w ends it.
__device__ __forceinline__ void add_dq256(const CUtensorMap* tdq,
                                          const Params& p, uint8_t* smem,
                                          int lane, int w) {
  using L = Smem256;
  const int b = blockIdx.z;
  const int n_qt = (p.T + kBQ - 1) / kBQ;
  const Bars256 bar(smem_u32(smem + L::kBar));
  const int4* const info = reinterpret_cast<const int4*>(smem + L::kDQInfo);
  for (uint32_t phase = 0;; phase ^= 1) {
    int* sem = nullptr;
#pragma unroll 1
    for (int qt = 0; qt < 2; ++qt) {
      const int slot = 2 * w + qt;
      mbar_wait(bar.dq_full + 8 * slot, phase);
      const int4 it = info[slot];   // q0, q head, -, live key tiles before
      if (it.x < 0) return;
      if (lane == 0) {
        if (qt == 0) {
          sem = p.dq_sem + ((size_t)b * p.H + it.y) * n_qt + it.x / kBQ;
          while (ld_acquire_gpu(sem) < 2 * it.w) __nanosleep(64);
          fence_proxy_async_global();   // the earlier tiles' adds before ours
        }
        const uint32_t src = smem_u32(smem + L::kDQ + slot * L::kDQTile);
#pragma unroll
        for (int x = 0; x < 2; ++x)
          tma_reduce_add_4d(tdq, src + x * L::kDQBox, 128 * w + 64 * qt + 32 * x,
                            it.x, it.y, b);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(bar.dq_empty + 8 * slot);   // the slot may be written again
        if (qt == 1) {
          bulk_wait();
          fence_proxy_async_global();
          red_release_gpu_add(sem, 1);
        }
      }
      __syncwarp();
    }
  }
}

// p^T and ds^T in place of s^T and dp^T for this thread's elements of a
// warpgroup's 32 query rows: element i is key (i % 4) / 2 of the thread's
// two, query row r0 + 8 (i / 4) + 2c + i % 2 of the item's tile.
template <bool kCap, bool kMask>
__device__ __forceinline__ void p_ds256(float (&s)[16], float (&dp)[16],
                                        const float* lse2, const float* dlt,
                                        const int* qpos, const int* qseg,
                                        const bool (&key_ok)[2], const int (&kp)[2],
                                        const int (&ks)[2], int q0, int r0, int c,
                                        const Params& p) {
  const bool segmented = p.qseg != nullptr;
  const float scale_log2 = p.sm_scale * kLog2e;
  const float cap_in = kCap ? p.sm_scale / p.softcap : 0.f;
  const float cap_mul = kCap ? p.softcap * kLog2e : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qi = r0 + 8 * j + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + qi);
    const float2 dl = *reinterpret_cast<const float2*>(dlt + qi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, kj = e >> 1, r = qi + (e & 1);
      float pe, ds = dp[i] - ((e & 1) ? dl.y : dl.x);
      if constexpr (kCap) {
        const float th = tanhf(s[i] * cap_in);
        pe = ex2(cap_mul * th - ((e & 1) ? l2.y : l2.x));
        ds *= 1.f - th * th;
      } else {
        pe = ex2(s[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
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

// This warpgroup's 32 query rows of a 64 x 64 bf16 operand tile ([key][query
// row], 128-byte rows, swizzled) from its fp32 accumulator elements.
__device__ __forceinline__ void store_keys_by_rows(uint8_t* dst, const float (&x)[16],
                                                   const int (&key)[2], int wg,
                                                   int g, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int kj = 0; kj < 2; ++kj)
      *reinterpret_cast<uint32_t*>(dst + key[kj] * 128 + (((4 * wg + j) ^ g) << 4) +
                                   4 * c) =
          pack_bf16(x[4 * j + 2 * kj], x[4 * j + 2 * kj + 1]);
}

// The two consumer warpgroups (see the notes above): warpgroup wg computes
// s^T, dp^T, p^T and ds^T for query rows [32 wg, 32 wg + 32) of the item,
// then dv, dk and dq for columns [128 wg, 128 wg + 128), its dq quarters
// staged in slot wg for add_dq256.
__device__ __forceinline__ void consume256(const Params& p, uint8_t* smem,
                                           int ct) {
  using L = Smem256;
  constexpr int kRB = L::kRB;
  const int wg = ct / 128, t = ct % 128, w4 = t / 32, lane = ct % 32;
  const int g = lane >> 2, c = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kBK256;
  const bool segmented = p.qseg != nullptr;
  const Bars256 bar(smem_u32(smem + L::kBar));
  int4* const dq_info = reinterpret_cast<int4*>(smem + L::kDQInfo);

  // this thread's two keys: rows g and g + 8 of its warp's 16 in s^T
  int key[2], kp[2], ks[2];
  bool key_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    key[j] = w4 * 16 + g + 8 * j;
    key_ok[j] = k0 + key[j] < p.S;
    kp[j] = key_ok[j] ? p.kpos[(size_t)b * p.S + k0 + key[j]] : 0;
    ks[j] = (key_ok[j] && segmented) ? p.kseg[(size_t)b * p.S + k0 + key[j]] : 0;
  }

  float dk[64], dv[64];   // 64 keys x this warpgroup's 128 columns
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_a = smem_u32(smem + L::kK), v_a = smem_u32(smem + L::kV);
  const uint32_t q_a = smem_u32(smem + L::kQ), do_a = smem_u32(smem + L::kDO);
  const uint32_t half = 2 * wg * L::kBox;   // this warpgroup's columns in a tile
  const uint32_t rows = wg * 32 * kRB;      // its query rows in a q or do tile
  const float* const lse_b = reinterpret_cast<const float*>(smem + L::kMeta);
  const float* const dlt_b = lse_b + kBQ;
  const int* const qpos_b = reinterpret_cast<const int*>(dlt_b + kBQ);
  const int* const qseg_b = qpos_b + kBQ;
  const bool cap = p.softcap > 0.f;

  // x^T = a b^T over D: 64 keys x this warpgroup's 32 query rows, a and b
  // K-major
  auto keys_by_rows = [&](float (&x)[16], uint32_t a, uint32_t bb) {
#pragma unroll
    for (int kk = 0; kk < kD256 / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kBox + (kk % 4) * 32;
      wgmma_ss<32, 0, 0>(x, desc<kRB>(a + off, 16, 8 * kRB),
                         desc<kRB>(bb + rows + off, 16, 8 * kRB), kk > 0);
    }
  };
  // acc += x^T y for this warpgroup's half: x^T [key][row] from shared
  // memory, y (64 rows x D) read MN-major
  auto add_half = [&](float (&acc)[64], uint32_t xt, uint32_t y) {
#pragma unroll
    for (int kq = 0; kq < kBQ / 16; ++kq)
      wgmma_ss<128, 0, 1>(acc, desc<128>(xt + kq * 32, 16, 1024),
                          desc<kRB>(y + half + kq * 16 * kRB, L::kBox, 8 * kRB), 1);
  };

  mbar_wait(bar.kv, 0);
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(bar.q_full, phase);
    const int4 item = *reinterpret_cast<const int4*>(smem + L::kItem);
    if (item.x < 0) break;
    const int q0 = item.x;
    mbar_wait(bar.do_full, phase);

    // ---- s^T = k q^T and dp^T = v do^T for this warpgroup's rows ----
    float s[16], dp[16];   // the first k-step overwrites them
    wgmma_fence();
    keys_by_rows(s, k_a, q_a);
    keys_by_rows(dp, v_a, do_a);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ---- p^T from lse, ds^T = p^T (dp^T - delta) (1 - th^2), in one of
    // four forms, to shared memory as bf16 ----
    const bool mask = item.z == 0;
    if (cap && mask) p_ds256<true, true>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, 32 * wg, c, p);
    else if (cap) p_ds256<true, false>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, 32 * wg, c, p);
    else if (mask) p_ds256<false, true>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, 32 * wg, c, p);
    else p_ds256<false, false>(s, dp, lse_b, dlt_b, qpos_b, qseg_b, key_ok, kp, ks, q0, 32 * wg, c, p);
    uint8_t* const ps = smem + L::kPS;
    named_barrier(2, kConsumers);   // both are done with the last p^T and ds^T
    store_keys_by_rows(ps, s, key, wg, g, c);
    store_keys_by_rows(ps + L::kBox, dp, key, wg, g, c);
    fence_proxy_async();
    named_barrier(1, kConsumers);   // both warpgroups' rows are written
    const uint32_t pb_a = smem_u32(ps), ds_a = pb_a + L::kBox;

    // ---- dv += p^T do, dk += ds^T q for this warpgroup's half ----
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    add_half(dv, pb_a, do_a);
    wgmma_commit();
    add_half(dk, ds_a, q_a);
    wgmma_commit();
    wgmma_wait<1>();   // dv's products
    fence_regs(dv);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.do_empty);   // do is free
    wgmma_wait<0>();   // dk's
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.q_empty);    // q and the item's metadata are free

    // ---- dq = ds k for this warpgroup's half, a 64-column quarter at a
    // time, scaled by 1/sqrt(D) into slot 2 wg + quarter for add_dq256: rows
    // 16 w4 + g (+ 8), columns 8 j + 2 c of the quarter ----
#pragma unroll 1
    for (int qt = 0; qt < 2; ++qt) {
      const int slot = 2 * wg + qt;
      uint8_t* const dq_s = smem + L::kDQ + slot * L::kDQTile;
      float dqa[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK256 / 16; ++kk)
        wgmma_ss<64, 1, 1>(dqa, desc<128>(ds_a + kk * 16 * 128, 16, 1024),
                           desc<kRB>(k_a + half + qt * L::kBox + kk * 16 * kRB,
                                     L::kBox, 8 * kRB), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      mbar_wait(bar.dq_empty + 8 * slot, phase ^ 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = (8 * j + 2 * c) * 4;   // in bytes
          const int row = w4 * 16 + g + 8 * i;
          *reinterpret_cast<float2*>(
              dq_s + (col / 128) * L::kDQBox + swizzle<128>(row * 128 + col % 128)) =
              make_float2(dqa[4 * j + 2 * i] * p.sm_scale,
                          dqa[4 * j + 2 * i + 1] * p.sm_scale);
        }
      fence_proxy_async();
      if (t == 0) dq_info[slot] = make_int4(q0, item.y, 0, item.w);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.dq_full + 8 * slot);
    }
    phase ^= 1;
  }
  // the end of this warpgroup's add_dq256 loop, in its first slot
  mbar_wait(bar.dq_empty + 16 * wg, phase ^ 1);
  if (t == 0) dq_info[2 * wg] = make_int4(-1, 0, 0, 0);
  __syncwarp();
  if (lane == 0) mbar_arrive(bar.dq_full + 16 * wg);

  // ---- dk, dv: element i of this thread's keys, column 128 wg + 8 (i / 4)
  // + 2c ----
  const size_t kv_rs = (size_t)p.KV * kD256;
#pragma unroll
  for (int kj = 0; kj < 2; ++kj) {
    if (!key_ok[kj]) continue;
    const size_t r = ((size_t)b * p.S + k0 + key[kj]) * kv_rs + (size_t)kvh * kD256 +
                     128 * wg;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * c, i = 4 * j + 2 * kj;
      *reinterpret_cast<uint32_t*>(p.dk + r + d) =
          pack_bf16(dk[i] * p.sm_scale, dk[i + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(p.dv + r + d) = pack_bf16(dv[i], dv[i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_d256_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdq, const Params p) {
  using L = Smem256;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  if (tid == 0) {
    const Bars256 bar(smem_u32(smem + L::kBar));
    mbar_init(bar.kv, 1);
    mbar_init(bar.q_full, 32);                 // the producer warp
    mbar_init(bar.do_full, 1);                 // its lane 0
    mbar_init(bar.q_empty, kConsumers / 32);   // each consumer warp
    mbar_init(bar.do_empty, kConsumers / 32);
    for (int s = 0; s < 4; ++s) {
      mbar_init(bar.dq_full + 8 * s, 4);       // the warps of consumer warpgroup s / 2
      mbar_init(bar.dq_empty + 8 * s, 1);      // its add_dq256 warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Registers as in the other form: 40 + 2 x 232 = 3 x 168.
  if (tid < 128) {   // the producer warpgroup: warp 0 feeds, 1 and 2 add dq
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = tid / 32, lane = tid % 32;
    if (warp > 0) {
      key_tile_table<kBK256>(p, reinterpret_cast<int4*>(smem + L::kStat), warp,
                             lane);
      named_barrier_arrive(5, 128);
    } else {
      produce256(&tq, &tdo, &tk, &tv, p, smem, lane);
    }
    if (warp == 1 || warp == 2) add_dq256(&tdq, p, smem, lane, warp - 1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume256(p, smem, tid - 128);
  }
}

int launch_d256(const void* q, const void* k, const void* v, const void* dout,
                void* dq_acc, int T_acc, const Params& p, cudaStream_t stream) {
  using L = Smem256;
  constexpr auto kBF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t qdims[4] = {kD256, (cuuint64_t)p.H, (cuuint64_t)p.T, (cuuint64_t)p.B};
  const cuuint64_t kdims[4] = {kD256, (cuuint64_t)p.KV, (cuuint64_t)p.S, (cuuint64_t)p.B};
  const cuuint64_t adims[4] = {kD256, (cuuint64_t)T_acc, (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint32_t box[4] = {64, 1, 64, 1}, abox[4] = {32, kBQ, 1, 1};
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!make_map(&tq, kBF16, 2, q, qdims, box) ||
      !make_map(&tdo, kBF16, 2, dout, qdims, box) ||
      !make_map(&tk, kBF16, 2, k, kdims, box) ||
      !make_map(&tv, kBF16, 2, v, kdims, box) ||
      !make_map(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, adims, abox))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(mha_bwd_d256_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  // blocks of lower blockIdx.x in a (KV head, batch row) launch first: the
  // dq order's waits end, as in the other form
  mha_bwd_d256_kernel<<<dim3((p.S + kBK256 - 1) / kBK256, p.KV, p.B), kThreads,
                        L::kBytes, stream>>>(tq, tdo, tk, tv, tdq, p);
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
// own form, mha_bwd_d256_kernel, with the same arguments (there the dq
// counters count two per key tile). Launches on
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

// The dynamic shared memory of the backward at head dim D, in bytes,
// alignment slack included, or 0 for a head dim it does not take.
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
