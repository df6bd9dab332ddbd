// K1 — attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces the TPU kernel `mha_forward` in src/repro/kernels/flash_attention.py
// (pl.pallas_call at :354, body `_fwd_body` at :162), in both its plain form
// (`flash_attention`) and its segmented form (`ragged_attention`).
//
// What it computes, for q (B,T,H,D), k/v (B,S,KV,D) with a head dim D of 16,
// 32, 64, 128 or 256 (gpt-paper: 128; gemma2-2b: 256; the reduced widths:
// 16), positions and
// segment ids (B,T)/(B,S) int32:
//   o   (B,T,H,D) bf16 = softmax(mask(cap(q k^T / sqrt(D)))) v
//   lse (B,H,T)   fp32 = m + log(max(l, 1e-30)), the finite sentinel -1e30
//                        standing in for -inf on rows with no visible key.
// The mask is the reference's `_element_mask`: same segment and segment >= 0
// (segmented), 0 <= q_pos - k_pos (< window) (causal). Keys past S are masked
// too, so any T and S work, T = 1 included; the tile is never shrunk.
// Masked pairs are chosen by select, never by multiplying with a mask.
//
// Both forms loop over the kv tiles inside the block in place of the TPU
// grid's sequential kv axis, with the running max m, the running sum l and
// the output accumulator in fp32 registers (online softmax, in the log2
// domain). k/v are read at head h / (H / KV): GQA repeats nothing in memory.
// A kv tile that no (row, key) pair can see is skipped, by the reference's
// `_live_terms` on the min/max of the tiles' positions and segment ids
// (`tiles_live`); a tile that every pair sees skips the element mask
// (`tiles_full`). p is rounded to bf16 for the p·v product.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//  - prefill (T = S = bucket length, causal) is bound by operations:
//    4·D FLOPs per visible pair against (3·S + T)·H·D·2 bytes per batch row;
//  - decode (T = 1 against an S-long cache) is bound by the bytes of the live
//    k/v cache, which it need read only once per KV head: 4·G·T·D FLOPs per
//    key against 4·D bytes, a few FLOPs per byte.
//
// Prefill (T > 16), `mha_fwd_prefill_kernel`, one form at every head dim:
// one block per (128 query rows, q head, batch row), over key tiles of kBN
// keys, 128 up to D 128 and 64 at D 256. The query tile is the fastest
// grid axis, reversed:
// the blocks in flight together share a few heads, whose k and v stay in
// L2, and within a head the late (for a causal mask the heaviest) tiles
// start first. Three warpgroups:
//  - the producer warpgroup's four warps take the min/max of every key
//    tile into a table in shared memory (512 tiles at a time: at D 256
//    the walk past 32768 keys goes in chunks), with many loads in flight;
//    warp 0 loads the q tile once by TMA and walks the table: a dead tile
//    costs no load, and for each live one it sends the tile's item (index, and
//    whether every pair is visible) with its k tile, and its v tile, by
//    TMA (4-D tensor maps over (D, heads, rows, batch), whose out-of-bounds
//    fill gives the zero rows past S) into two rings of two stages, handed
//    over by mbarriers; a tile that needs the element mask also carries its
//    key positions and segment ids. An end item closes the k ring, so a q
//    tile without a live kv tile writes o = 0 and lse = -1e30 at once;
//  - two consumer warpgroups own 64 query rows each and share every k/v
//    tile. A turn on the tensor cores issues s = q k^T of kv tile n (wgmma,
//    both operands in shared memory) and o += p v of tile n - 1 (wgmma, p
//    from registers, v read MN-major through its descriptor, one product
//    per 128 columns of o at D 256); the softmax
//    of tile n follows, on the fp32 accumulator in one of four forms
//    chosen per tile (softcap or not, element mask or not). Named barriers
//    make the warpgroups take their turns in alternation, so that one's
//    softmax runs while the other's products do;
//  - setmaxnreg moves registers from the producer to the consumers.
// The epilogue writes o through this warpgroup's half of the q tile in
// shared memory and one TMA store (rows past T are not written).
// This keeps the tensor cores fed from shared memory, reads each k/v tile
// from L2 once per 128 query rows, takes the copies and the liveness scan
// off the warps that do the products, and keeps the per-element work of
// the softmax small: one fused multiply-add and one ex2 per entry, and an
// element mask of three integer compares against a per-row interval.
// At D 256 the 64-key tiles are what fit: the q tile (65536 B), two stages
// each of k and v (131072 B), the metadata, items, tile statistics (8192 B)
// and barriers come to 206936 B of the 232448 a block may have (128-key
// tiles would take 339032 B); a consumer thread holds o (128 fp32), s (32)
// and p's bf16 fragments (16) in the 232 registers setmaxnreg gives it.
//
// Decode (T <= 16), `mha_fwd_decode_kernel`, built around the cache bytes:
//  - one block per (cache split, KV head, batch row) takes all G·T rows of
//    that KV head's GQA group (G q heads x T positions, head-major), so each
//    k/v tile is read once per group and a decode step fills G rows of the
//    mma tile, not 1. G·T <= 16 is one m16 row tile; up to 64 rows (32 at
//    D 256) take more, and beyond that the group's heads are cut into row
//    groups, each a block of its own;
//  - the cache is split over blocks: the host picks n_split from the shapes
//    and the SM count alone (about two blocks per SM over the grid), each
//    block finds the batch row's live 64-key tiles itself (each lane one
//    tile's min/max, 32 tiles a warp with their loads in flight, a ballot
//    into bits in shared memory: no barrier per tile) and takes its share
//    of them, ranks [n_live · j / n_split, n_live · (j + 1) / n_split), so a
//    window leaves no split idle that the live tiles can fill;
//  - the k/v tiles stream through a ring of three stages by cp.async (two in
//    flight behind the one computed), 64 keys a stage, 32 at D 256, so that
//    a block stays near 110 KB of shared memory and two fit on an SM;
//  - the products stay on mma.sync m16n8k16 (ldmatrix from rows padded to
//    D + 8): the form is bound by bytes, so the tensor cores are not its
//    limit, and a row tile of 16 wastes less of them than wgmma's 64. The
//    four warps share a stage: s = q k^T by keys, the stage's row maxima
//    through shared memory, p in bf16 through shared memory, o += p v by
//    16-column chunks of o; q's fragments stay in registers where they take
//    at most 64 (one row tile at every D), else q is loaded once into
//    shared memory;
//  - with one split the block writes o and lse; with more it writes fp32
//    (acc, m, l) into a workspace the wrapper allocates, and the last block
//    of each (KV head, batch row) to finish, found by a zeroed int32
//    counter, merges the splits in ascending order: no second launch.
//    Every sum runs in a fixed order, so a call repeats bit for bit.
//
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const int* qpos;
  const int* kpos;
  const int* qseg;   // nullptr: not segmented
  const int* kseg;
  uint16_t* o;
  float* lse;
  int B, T, S, H, KV;
  int causal, window;
  float softcap;     // 0: none
  float sm_scale;
};

// The decode form's: cache splits, q heads per block, 32-tile words of the
// tile search, and with n_split > 1 the splits' fp32 workspace and the
// zeroed int32 counters after it, one per (batch row, KV head and row
// group). The prefill form takes Params alone.
struct DecParams : Params {
  int n_split, gh, words;
  float* ws;
  int* sem;
  int o_f32;         // o written in fp32, unrounded (a partial to merge)
};

// ---------------------------------------------------------------------
// decode (T <= 16)
// ---------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDecStages = 3;        // stages of the decode form's k/v ring

// The decode form's plan at head dim kD with kMT row tiles of 16 (the
// block's G·T rows, head-major). A stage holds kBN keys of k and of v, rows
// of kD + 8 bf16 (ldmatrix's rows land on distinct banks), and the keys'
// positions and segment ids; a live tile of kBK keys is kSub stages. Then
// p (bf16, the tile's probabilities), the warps' row maxima, q where its
// fragments do not stay in registers, and the tiles' live and full bits
// (their size, 8 bytes per 32 tiles, is added at launch).
template <int kD, int kMT>
struct DecSmem {
  static constexpr int kBN = kD > 128 ? 32 : 64;
  static constexpr int kSub = kBK / kBN;
  static constexpr int kStride = kD + 8;
  static constexpr int kRows = 16 * kMT;
  static constexpr int kPStride = kBN + 8;
  // q's A fragments take kMT * kD / 4 registers: kept up to 64
  static constexpr bool kQRegs = kMT * kD <= 256;
  static constexpr int kKV = 0;                                  // [stage][k, v][kBN][kStride]
  static constexpr int kPos = kKV + kDecStages * 2 * kBN * kStride * 2;   // [stage][pos, seg][kBN]
  static constexpr int kP = kPos + kDecStages * 2 * kBN * 4;     // [kRows][kPStride] bf16
  static constexpr int kRed = kP + kRows * kPStride * 2;         // [kWarps][kRows] fp32
  static constexpr int kQ = kRed + kWarps * kRows * 4;           // [kRows][kStride] bf16
  static constexpr int kBits = kQ + (kQRegs ? 0 : kRows * kStride * 2);
};

// The largest row tiles per block at head dim kD: 64 rows up to D 128, 32
// at D 256 (o's accumulator would take 128 registers a thread beyond).
template <int kD>
constexpr int dec_max_mt() { return kD > 128 ? 2 : 4; }

// Row `row` of o (B, T, H) from the splits' partials (acc, m, l) in the
// workspace, by one warp: m = max m_j, l = sum l_j 2^(m_j - m), o = sum
// acc_j 2^(m_j - m) / l, lse = m + log l. Lane j reads split j's (m, l), 32
// splits at a time; every lane then adds the splits in ascending order, so
// the sums run in one fixed order whichever block merges. The partials are
// read past L1 (other blocks wrote them).
template <int kD>
__device__ __forceinline__ void merge_row(const DecParams& p, size_t row, int lane) {
  constexpr int kCols = (kD + 31) / 32;
  const size_t n_all = (size_t)p.B * p.T * p.H;
  const float* const ml = p.ws + (size_t)p.n_split * n_all * kD;
  float mx = kNegInf;
  for (int j = lane; j < p.n_split; j += 32)
    mx = fmaxf(mx, __ldcg(ml + (j * n_all + row) * 2));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float lsum = 0.f, acc[kCols];
#pragma unroll
  for (int x = 0; x < kCols; ++x) acc[x] = 0.f;
  for (int j0 = 0; j0 < p.n_split; j0 += 32) {
    float2 mj = make_float2(kNegInf, 0.f);
    if (j0 + lane < p.n_split)
      mj = __ldcg(reinterpret_cast<const float2*>(ml + ((j0 + lane) * n_all + row) * 2));
    const float wl = ex2(mj.x - mx);   // 0 for a split that saw no key
    const int nj = min(32, p.n_split - j0);
#pragma unroll 4
    for (int jj = 0; jj < nj; ++jj) {
      const float w = __shfl_sync(0xffffffffu, wl, jj);
      lsum += w * __shfl_sync(0xffffffffu, mj.y, jj);
      const float* const oj = p.ws + ((j0 + jj) * n_all + row) * kD;
#pragma unroll
      for (int x = 0; x < kCols; ++x)
        if (lane + 32 * x < kD) acc[x] += w * __ldcg(oj + lane + 32 * x);
    }
  }
  lsum = fmaxf(lsum, 1e-30f);
  const float inv = 1.f / lsum;
#pragma unroll
  for (int x = 0; x < kCols; ++x)
    if (lane + 32 * x < kD) {
      if (p.o_f32)
        reinterpret_cast<float*>(p.o)[row * kD + lane + 32 * x] = acc[x] * inv;
      else
        reinterpret_cast<__nv_bfloat16*>(p.o)[row * kD + lane + 32 * x] =
            __float2bfloat16_rn(acc[x] * inv);
    }
  if (lane == 0) {
    const int h = row % p.H, t = (row / p.H) % p.T;
    const size_t bb = row / ((size_t)p.H * p.T);
    const float mn = mx == kNegInf ? kNegInf : mx * kLn2;
    p.lse[(bb * p.H + h) * p.T + t] = mn + logf(lsum);
  }
}

// One block per (cache split, KV head and row group, batch row): the rows
// of the row group's q heads (heads-per-block · T, head-major) against the
// live key tiles of its split. The four warps share each stage: s = q k^T
// by keys (kBN / 4 each), the tile's row maxima through shared memory, p to
// shared memory in bf16, then o += p v by 16-column chunks of o. Every
// sum runs in a fixed order; with one split the block writes o and lse,
// with more it writes fp32 (acc, m, l) to the workspace, and the last block
// of its (KV head and row group, batch row) to count itself on their int32
// counter merges the group's rows (merge_row) and sets the counter back to
// zero.
template <int kD, int kMT>
__global__ void __launch_bounds__(kThreads)
mha_fwd_decode_kernel(const DecParams p) {
  using L = DecSmem<kD, kMT>;
  constexpr int kBN = L::kBN, kStride = L::kStride, kRows = L::kRows;
  constexpr int kPStride = L::kPStride;
  constexpr int kNTw = kBN / 32;                 // 8-key n-tiles per warp in s
  constexpr int kC = kD / 16;                    // 16-column chunks of o a row tile
  constexpr int kU = (kMT * kC + kWarps - 1) / kWarps;   // chunks per warp
  static_assert(kMT == 1 || kC % kU == 0, "a warp's chunks lie in one row tile");
  static_assert(kNTw == 2 || kC % 2 == 0, "k fragments of two k-steps at once");
  static_assert(kBN * (kD / 8) % kThreads == 0, "a stage's copies over the block");
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const kv_s = reinterpret_cast<uint16_t*>(smem + L::kKV);
  int* const pos_s = reinterpret_cast<int*>(smem + L::kPos);
  uint16_t* const p_s = reinterpret_cast<uint16_t*>(smem + L::kP);
  float* const red_s = reinterpret_cast<float*>(smem + L::kRed);
  uint16_t* const q_s = reinterpret_cast<uint16_t*>(smem + L::kQ);
  uint32_t* const live_w = reinterpret_cast<uint32_t*>(smem + L::kBits);
  uint32_t* const full_w = live_w + p.words;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;   // mma fragment row group / column pair
  const int mi = lane >> 3, r8 = lane & 7; // ldmatrix: matrix and row this lane addresses
  const int split = blockIdx.x, b = blockIdx.z;
  const int G = p.H / p.KV, n_rg = (G + p.gh - 1) / p.gh;
  const int kvh = blockIdx.y / n_rg, rg = blockIdx.y % n_rg;
  const int h0 = kvh * G + rg * p.gh;                  // the block's first q head
  const int n_rows = min(p.gh, G - rg * p.gh) * p.T;
  const bool segmented = p.qseg != nullptr;
  const int n_tiles = (p.S + kBK - 1) / kBK;
  const int* const kpos = p.kpos + (size_t)b * p.S;
  const int* const kseg = segmented ? p.kseg + (size_t)b * p.S : nullptr;
  // the q element (row r, column d) of the block, r < n_rows
  auto q_at = [&](int r, int d) {
    return p.q + (((size_t)b * p.T + r % p.T) * p.H + h0 + r / p.T) * kD + d;
  };

  // ---- this thread's rows (g and g + 8 of each row tile) and their mask:
  // key (kp, ks) is visible iff ks == qs (segmented) and lo <= kp <= hi; a
  // row past n_rows or of padding sees nothing (an empty interval) ----
  int qs[kMT][2], lo[kMT][2], hi[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mt * 16 + g + 8 * i;
      const bool ok = r < n_rows;
      const size_t at = (size_t)b * p.T + r % p.T;
      const int qp = ok ? p.qpos[at] : 0;
      qs[mt][i] = (ok && segmented) ? p.qseg[at] : 0;
      const bool sees = ok && qs[mt][i] >= 0;
      hi[mt][i] = !sees ? kIntMin : p.causal ? qp : kIntMax;
      lo[mt][i] = !sees ? kIntMax
                : (p.causal && p.window > 0) ? qp - p.window + 1 : kIntMin;
    }

  // ---- q: its A fragments in registers (loaded first, so that they are
  // in flight during the tile search), or once into shared memory ----
  uint32_t qa[L::kQRegs ? kMT : 1][L::kQRegs ? kC : 1][4];
  if constexpr (L::kQRegs) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int kk = 0; kk < kC; ++kk) {
        const int d = kk * 16 + c * 2;
        qa[mt][kk][0] = r0 < n_rows ? load_u32(q_at(r0, d)) : 0u;
        qa[mt][kk][1] = r1 < n_rows ? load_u32(q_at(r1, d)) : 0u;
        qa[mt][kk][2] = r0 < n_rows ? load_u32(q_at(r0, d + 8)) : 0u;
        qa[mt][kk][3] = r1 < n_rows ? load_u32(q_at(r1, d + 8)) : 0u;
      }
    }
  } else {
    for (int i = tid; i < kRows * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), ch = i % (kD / 8);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows) x = *reinterpret_cast<const uint4*>(q_at(r, ch * 8));
      *reinterpret_cast<uint4*>(q_s + r * kStride + ch * 8) = x;
    }
  }

  // ---- the tile search: each lane one key tile's min and max, 32 tiles a
  // warp at a time with all its loads in flight (16 of int4 where the tile
  // is whole and 16-byte aligned), against the statistics of the batch
  // row's T query rows (a lane each, reduced while the keys' loads are in
  // flight), and a ballot of which tiles are live and which need no
  // element mask ----
  const size_t q_at_lane = (size_t)b * p.T + lane;
  const int lane_qp = lane < p.T ? p.qpos[q_at_lane] : 0;
  const int lane_qs = lane < p.T && segmented ? p.qseg[q_at_lane] : 0;
  for (int wd = warp; wd < p.words; wd += kWarps) {
    const int t = wd * 32 + lane, k0 = t * kBK;
    const int n = t < n_tiles ? min(kBK, p.S - k0) : 0;
    const bool vec = n == kBK && ((size_t)b * p.S + k0) % 4 == 0;
    int st[4] = {kIntMax, kIntMin, kIntMax, kIntMin};
    // min and max of the tile's n ints at x into st[i], st[i + 1]; with
    // `vec`, their loads issued first and reduced by reduce()
    int4 v[kBK / 4];
    auto load = [&](const int* x) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) v[j] = reinterpret_cast<const int4*>(x)[j];
      }
    };
    auto reduce = [&](const int* x, int i) {
      if (vec) {
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) {
          st[i] = min(st[i], min(min(v[j].x, v[j].y), min(v[j].z, v[j].w)));
          st[i + 1] = max(st[i + 1], max(max(v[j].x, v[j].y), max(v[j].z, v[j].w)));
        }
      } else {
#pragma unroll 16
        for (int j = 0; j < kBK; ++j)
          if (j < n) {
            st[i] = min(st[i], x[j]);
            st[i + 1] = max(st[i + 1], x[j]);
          }
      }
    };
    load(kpos + k0);
    const bool q_ok = lane < p.T;
    const int qstat[4] = {warp_min(q_ok ? lane_qp : kIntMax),
                          warp_max(q_ok ? lane_qp : kIntMin),
                          warp_min(q_ok ? lane_qs : kIntMax),
                          warp_max(q_ok ? lane_qs : kIntMin)};
    reduce(kpos + k0, 0);
    if (segmented) {
      load(kseg + k0);
      reduce(kseg + k0, 2);
    } else {
      st[2] = st[3] = 0;
    }
    const bool live = t < n_tiles &&
                      tiles_live(qstat, st, segmented, p.causal, p.window);
    const bool full = live && k0 + kBK <= p.S &&
                      tiles_full(qstat, st, segmented, p.causal, p.window);
    const uint32_t lw = __ballot_sync(0xffffffffu, live);
    const uint32_t fw = __ballot_sync(0xffffffffu, full);
    if (lane == 0) { live_w[wd] = lw; full_w[wd] = fw; }
  }
  __syncthreads();   // the tiles' bits (and q, where it is in shared memory)

  // ---- this split's share of the live tiles: ranks [rank0, rank1) of
  // n_live, in ascending tile order ----
  int n_live = 0;
  for (int wd = 0; wd < p.words; ++wd) n_live += __popc(live_w[wd]);
  const int rank0 = (int)((long long)n_live * split / p.n_split);
  const int rank1 = (int)((long long)n_live * (split + 1) / p.n_split);
  // the first live tile at or after t (n_tiles if none)
  auto next_live = [&](int t) -> int {
    int wd = t >> 5;
    if (wd >= p.words) return n_tiles;
    uint32_t w = live_w[wd] & (0xffffffffu << (t & 31));
    while (w == 0) {
      if (++wd >= p.words) return n_tiles;
      w = live_w[wd];
    }
    return wd * 32 + __ffs(w) - 1;
  };
  auto is_full = [&](int t) { return (full_w[t >> 5] >> (t & 31)) & 1u; };
  int first = n_tiles;
  if (rank1 > rank0) {   // the live tile of rank rank0
    int r = rank0;
    for (int wd = 0; wd < p.words; ++wd) {
      uint32_t w = live_w[wd];
      const int cnt = __popc(w);
      if (r < cnt) {
        for (; r > 0; --r) w &= w - 1;
        first = wd * 32 + __ffs(w) - 1;
        break;
      }
      r -= cnt;
    }
  }
  const int n_st = (rank1 - rank0) * L::kSub;   // stages this block computes

  // stage j of the walk is (tile t, part sub): advance to the next
  auto advance = [&](int& t, int& sub) {
    if (++sub == L::kSub) { sub = 0; t = next_live(t + 1); }
  };
  // k and v of part sub of tile t into ring stage j % kDecStages, zeros
  // past S, and the keys' positions and segment ids where the tile needs
  // the element mask: one group of cp.async, every copy in flight at once
  auto issue = [&](int j, int t, int sub) {
    const int stage = j % kDecStages, k0 = t * kBK + sub * kBN;
    uint16_t* const kb = kv_s + stage * 2 * kBN * kStride;
    uint16_t* const vb = kb + kBN * kStride;
    const size_t kv_rs = (size_t)p.KV * kD;   // token stride of k and v
#pragma unroll
    for (int jj = 0; jj < kBN * (kD / 8) / kThreads; ++jj) {
      const int i = tid + jj * kThreads;
      const int r = i / (kD / 8), ch = i % (kD / 8);
      const bool in = k0 + r < p.S;
      const size_t off = in ? ((size_t)b * p.S + k0 + r) * kv_rs +
                              (size_t)kvh * kD + ch * 8 : 0;
      cp_async16(kb + r * kStride + ch * 8, p.k + off, in);
      cp_async16(vb + r * kStride + ch * 8, p.v + off, in);
    }
    if (!is_full(t) && tid < kBN) {
      int* const ps = pos_s + stage * 2 * kBN;
      const bool in = k0 + tid < p.S;
      cp_async4(ps + tid, in ? kpos + k0 + tid : kpos, in);
      if (segmented) cp_async4(ps + kBN + tid, in ? kseg + k0 + tid : kseg, in);
    }
  };

  float acc[kU][2][4];   // o of this warp's chunks, rows g and g + 8
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[u][n][0] = acc[u][n][1] = acc[u][n][2] = acc[u][n][3] = 0.f;
  float m[kMT][2], l[kMT][2];   // running max (log2 domain), this thread's share of the sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) m[mt][0] = m[mt][1] = kNegInf, l[mt][0] = l[mt][1] = 0.f;
  // the row tile of this warp's chunks (a constant with one row tile, so
  // that the per-row arrays below stay in registers)
  const int mtw = kMT == 1 ? 0 : warp * kU / kC;
  // of a per-row array, this thread's two rows of row tile mtw
  auto pick = [&](const float (&x)[kMT][2], int i) {
    float y = x[0][i];
#pragma unroll
    for (int mt = 1; mt < kMT; ++mt) y = mt == mtw ? x[mt][i] : y;
    return y;
  };
  const bool has_o = warp * kU < kMT * kC && mtw * 16 < n_rows;
  const float qscale = p.sm_scale * kLog2e;
  const bool cap = p.softcap > 0.f;
  const float cap_in = cap ? p.sm_scale / p.softcap : 0.f;
  const float cap_mul = p.softcap * kLog2e;

  // ---- the walk: a ring of kDecStages stages, kDecStages - 1 in flight
  // behind the one computed ----
  int it_t = first, it_sub = 0, ct_t = first, ct_sub = 0;
#pragma unroll
  for (int j = 0; j < kDecStages - 1; ++j) {
    if (j < n_st) { issue(j, it_t, it_sub); advance(it_t, it_sub); }
    cp_async_commit();
  }
  for (int j = 0; j < n_st; ++j) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();   // stage j is in shared memory; stage j - 1 is free
    if (j + kDecStages - 1 < n_st) {
      issue(j + kDecStages - 1, it_t, it_sub);
      advance(it_t, it_sub);
    }
    cp_async_commit();
    const int stage = j % kDecStages;
    const int k0 = ct_t * kBK + ct_sub * kBN;
    const bool full = is_full(ct_t);
    advance(ct_t, ct_sub);
    const uint16_t* const ks = kv_s + stage * 2 * kBN * kStride;
    const uint16_t* const vs = ks + kBN * kStride;
    const int* const kp_s = pos_s + stage * 2 * kBN;
    const int* const kg_s = kp_s + kBN;
    const int koff = warp * (kBN / 4);   // this warp's first key of the stage

    // ---- s = q k^T: every row tile x this warp's kBN / 4 keys ----
    float s[kMT][kNTw][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kNTw; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    auto qfrag = [&](uint32_t (&qf)[4], int mt, int kk) {
      if constexpr (L::kQRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) qf[x] = qa[mt][kk][x];
      } else {
        ldsm_x4(qf, q_s + (mt * 16 + (mi & 1) * 8 + r8) * kStride + kk * 16 + (mi >> 1) * 8);
      }
    };
#pragma unroll
    for (int kk = 0; kk < kC; kk += 3 - kNTw) {
      uint32_t kb[4];
      if constexpr (kNTw == 2)   // b0, b1 of n-tiles 0 and 1 at k-step kk
        ldsm_x4(kb, ks + (koff + (mi >> 1) * 8 + r8) * kStride + kk * 16 + (mi & 1) * 8);
      else                       // b0, b1 of the n-tile at k-steps kk and kk + 1
        ldsm_x4(kb, ks + (koff + r8) * kStride + kk * 16 + mi * 8);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (mt * 16 >= n_rows) continue;
        uint32_t qf[4];
        qfrag(qf, mt, kk);
        mma_bf16(s[mt][0], qf, kb[0], kb[1]);
        if constexpr (kNTw == 2) {
          mma_bf16(s[mt][1], qf, kb[2], kb[3]);
        } else {
          qfrag(qf, mt, kk + 1);
          mma_bf16(s[mt][0], qf, kb[2], kb[3]);
        }
      }
    }

    // ---- to the log2 domain (and capped), masked; the warp's row maxima ----
    float mx[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      mx[mt][0] = mx[mt][1] = kNegInf;
#pragma unroll
      for (int n = 0; n < kNTw; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = koff + n * 8 + c * 2 + (e & 1);
          float x = cap ? cap_mul * tanhf(s[mt][n][e] * cap_in)
                        : s[mt][n][e] * qscale;
          if (!full) {
            const int kp = kp_s[key];
            bool ok = k0 + key < p.S && kp >= lo[mt][i] && kp <= hi[mt][i];
            if (segmented) ok = ok && kg_s[key] == qs[mt][i];
            if (!ok) x = kNegInf;
          }
          s[mt][n][e] = x;
          mx[mt][i] = fmaxf(mx[mt][i], x);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[mt][i] = fmaxf(mx[mt][i], __shfl_xor_sync(0xffffffffu, mx[mt][i], 1));
        mx[mt][i] = fmaxf(mx[mt][i], __shfl_xor_sync(0xffffffffu, mx[mt][i], 2));
        if (c == 0) red_s[warp * kRows + mt * 16 + g + 8 * i] = mx[mt][i];
      }
    }
    __syncthreads();   // every warp's row maxima

    // ---- the stage's row maxima, the running max and sum rescaled, p into
    // shared memory ----
    float alpha[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + g + 8 * i;
        float t4 = red_s[r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t4 = fmaxf(t4, red_s[w * kRows + r]);
        const float mnew = fmaxf(m[mt][i], t4);
        alpha[mt][i] = ex2(m[mt][i] - mnew);
        m[mt][i] = mnew;
        l[mt][i] *= alpha[mt][i];
      }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int n = 0; n < kNTw; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          // a masked entry holds exactly kNegInf; it contributes nothing,
          // also on a row that has seen no key yet (m = kNegInf)
          const float pe = s[mt][n][e] == kNegInf ? 0.f : ex2(s[mt][n][e] - m[mt][i]);
          s[mt][n][e] = pe;
          l[mt][i] += pe;
        }
        uint16_t* const pr = p_s + (mt * 16 + g) * kPStride + koff + n * 8 + c * 2;
        *reinterpret_cast<uint32_t*>(pr) = pack_bf16(s[mt][n][0], s[mt][n][1]);
        *reinterpret_cast<uint32_t*>(pr + 8 * kPStride) = pack_bf16(s[mt][n][2], s[mt][n][3]);
      }
    }
    __syncthreads();   // p of the whole stage

    // ---- o += p v: this warp's chunks of o over the stage's kBN keys ----
    if (has_o) {
      const float a0 = pick(alpha, 0), a1 = pick(alpha, 1);
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[u][n][0] *= a0; acc[u][n][1] *= a0;
          acc[u][n][2] *= a1; acc[u][n][3] *= a1;
        }
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        ldsm_x4(pa[kk], p_s + (mtw * 16 + (mi & 1) * 8 + r8) * kPStride + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int gu = warp * kU + u;
        if (gu >= kMT * kC) break;
        const int col = (gu % kC) * 16;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          uint32_t vb[4];   // b0, b1 of the chunk's two n-tiles
          ldsm_x4_trans(vb, vs + (kk * 16 + (mi & 1) * 8 + r8) * kStride + col + (mi >> 1) * 8);
          mma_bf16(acc[u][0], pa[kk], vb[0], vb[1]);
          mma_bf16(acc[u][1], pa[kk], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // the empty groups of the ring's tail

  // ---- the row sums: over the four threads of a row, then over the warps
  // in ascending order (no barrier before: every read of red_s in the walk
  // came before its last barrier) ----
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 1);
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 2);
      if (c == 0) red_s[warp * kRows + mt * 16 + g + 8 * i] = l[mt][i];
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mt * 16 + g + 8 * i;
      float x = red_s[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += red_s[w * kRows + r];
      l[mt][i] = x;
    }

  // ---- out: o = acc / l and lse = m + log l (natural log), or with more
  // than one split (acc, m, l) into the workspace ----
  const size_t n_all = (size_t)p.B * p.T * p.H;   // rows of o
  auto o_row = [&](int r) {   // row r of the block as a row of o (B, T, H)
    return ((size_t)b * p.T + r % p.T) * p.H + h0 + r / p.T;
  };
  if (has_o) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mtw * 16 + g + 8 * i;
      if (r >= n_rows) continue;
      const float inv = 1.f / fmaxf(pick(l, i), 1e-30f);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int gu = warp * kU + u;
        if (gu >= kMT * kC) break;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = (gu % kC) * 16 + n * 8 + c * 2;
          if (p.n_split == 1 && p.o_f32) {
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.o) + o_row(r) * kD + col) =
                make_float2(acc[u][n][2 * i] * inv, acc[u][n][2 * i + 1] * inv);
          } else if (p.n_split == 1) {
            *reinterpret_cast<uint32_t*>(p.o + o_row(r) * kD + col) =
                pack_bf16(acc[u][n][2 * i] * inv, acc[u][n][2 * i + 1] * inv);
          } else {
            *reinterpret_cast<float2*>(p.ws + ((size_t)split * n_all + o_row(r)) * kD + col) =
                make_float2(acc[u][n][2 * i], acc[u][n][2 * i + 1]);
          }
        }
      }
    }
  }
  if (warp == 0 && c == 0) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + g + 8 * i;
        if (r >= n_rows) continue;
        if (p.n_split == 1) {
          const float mn = m[mt][i] == kNegInf ? kNegInf : m[mt][i] * kLn2;
          p.lse[((size_t)b * p.H + h0 + r / p.T) * p.T + r % p.T] =
              mn + logf(fmaxf(l[mt][i], 1e-30f));
        } else {
          *reinterpret_cast<float2*>(p.ws + (size_t)p.n_split * n_all * kD +
                                     ((size_t)split * n_all + o_row(r)) * 2) =
              make_float2(m[mt][i], l[mt][i]);
        }
      }
  }

  // ---- with more than one split, the group's last block merges its rows:
  // every block's partials are visible before its count (the fences), so
  // the last to count reads them all ----
  if (p.n_split > 1) {
    __shared__ int last;
    __threadfence();
    __syncthreads();
    int* const count = p.sem + (size_t)b * gridDim.y + blockIdx.y;
    if (tid == 0) last = atomicAdd(count, 1) == p.n_split - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int r = warp; r < n_rows; r += kWarps) merge_row<kD>(p, o_row(r), lane);
      if (tid == 0) *count = 0;   // for the workspace's next use
    }
  }
}

// ---------------------------------------------------------------------
// prefill (T > 16)
// ---------------------------------------------------------------------
constexpr int kBM = 128;             // query rows per block
constexpr int kStages = 2;           // stages of the k ring and of the v ring
constexpr int kStatTiles = 512;      // key tiles whose min/max are held at once
constexpr int kNoKey = -2;           // segment id of the keys past S in a tile's metadata
constexpr int kConsumers = 2 * 128;  // two consumer warpgroups of 64 rows
constexpr int kPrefillThreads = 128 + kConsumers;

// Shared memory, each tile on a 1024-byte boundary. A tile of rows of D
// bf16 is stored as TMA writes it: boxes of 64 columns (one box for
// D <= 64), each box rows of kRB bytes with the kRB-byte swizzle. The q
// tile has kBM rows, a k or v tile kBN: 128 up to D 128, 64 at D 256,
// where two stages of 128-key tiles beside the q tile would take 339032 B.
template <int kD>
struct Smem {
  // a tile is whole boxes of 64 columns, or one narrower box: any other
  // D would load and store only part of each row
  static_assert(kD == 16 || kD == 32 || kD == 64 || kD % 64 == 0,
                "head dim: 16, 32, 64 or a multiple of 64");
  static constexpr int kBN = kD > 128 ? 64 : 128;          // keys per kv tile
  static constexpr int kRB = kD >= 64 ? 128 : kD * 2;
  static constexpr int kBoxes = kD > 64 ? kD / 64 : 1;
  static constexpr int kQBox = kBM * kRB;                  // one box of the q tile
  static constexpr int kKBox = kBN * kRB;                  // one box of a k or v tile
  static constexpr int kQTile = kBM * kD * 2;
  static constexpr int kKTile = kBN * kD * 2;              // a k or v tile
  static constexpr int kQ = 0;                             // q, then o
  static constexpr int kK = kQTile;                        // [stage] k
  static constexpr int kV = kK + kStages * kKTile;         // [stage] v
  static constexpr int kMeta = kV + kStages * kKTile;      // [stage][pos, seg][kBN]
  static constexpr int kItem = kMeta + kStages * 2 * kBN * 4;  // int2 [stage]
  static constexpr int kStat = kItem + kStages * 8;        // int4 [kStatTiles]
  // barriers: q, then per stage k full, v full, k empty, v empty
  static constexpr int kBar = kStat + kStatTiles * 16;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};
static_assert(Smem<256>::kBytes <= 232448, "shared memory of a block");

// The mbarriers: q (one arrival and the q tile's bytes), and per stage of
// the rings k full (the producer warp's 32 arrivals and the k tile's
// bytes), v full (one arrival and the v tile's bytes), and k empty and v
// empty (one arrival from each consumer warp).
struct Bars {
  uint32_t q, k_full, v_full, k_empty, v_empty;
  __device__ __forceinline__ explicit Bars(uint32_t base)
      : q(base), k_full(base + 8), v_full(base + 8 + 8 * kStages),
        k_empty(base + 8 + 16 * kStages), v_empty(base + 8 + 24 * kStages) {}
};

// The query tile of this block: within each (head, batch row) the last
// tile first.
__device__ __forceinline__ int tile_q0() {
  return (gridDim.x - 1 - blockIdx.x) * kBM;
}

// The producer warpgroup. Its four warps take the min/max of every key
// tile into shared memory (kStatTiles at a time), with many loads in
// flight, so that a dead tile costs the walk below no load. Warp 0 loads
// the q tile by TMA, takes its statistics and walks the key tiles: for
// each live one, its item (tile index, full) and, where the element mask
// is needed, its key positions and segment ids into the next free k stage
// with its k tile, and its v tile into the v stage of the same index,
// each stage freed on its own; an item with tile index -1 ends the
// consumers' loop.
template <int kD>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, const Params& p,
                                        uint8_t* smem, int pt) {
  using L = Smem<kD>;
  constexpr int kBN = L::kBN;
  const int warp = pt / 32, lane = pt % 32;
  const int h = blockIdx.y, b = blockIdx.z, q0 = tile_q0();
  const int kvh = h / (p.H / p.KV);
  const bool segmented = p.qseg != nullptr;
  const Bars bar(smem_u32(smem + L::kBar));
  int2* const items = reinterpret_cast<int2*>(smem + L::kItem);
  int4* const stats = reinterpret_cast<int4*>(smem + L::kStat);
  const int* const kpos = p.kpos + (size_t)b * p.S;
  const int* const kseg = segmented ? p.kseg + (size_t)b * p.S : nullptr;

  int4 q4 = make_int4(0, 0, 0, 0);
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_tx(bar.q, L::kQTile);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load_4d(smem_u32(smem + L::kQ + x * L::kQBox), tq, bar.q, 64 * x,
                    h, q0, b);
    }
    q4 = row_tile_stats(p.qpos + (size_t)b * p.T,
                        segmented ? p.qseg + (size_t)b * p.T : nullptr, p.T,
                        q0, lane);
  }
  const int qstat[4] = {q4.x, q4.y, q4.z, q4.w};
  // A tile of padding rows (segment -1) sees no key: no live tile.
  const bool none = segmented && qstat[3] < 0;
  const int n_tiles = (p.S + kBN - 1) / kBN;
  int stage = 0;
  uint32_t phase = 0;
  for (int c0 = 0; c0 < n_tiles; c0 += kStatTiles) {
    const int n = min(kStatTiles, n_tiles - c0);
#pragma unroll 4
    for (int i = warp; i < n; i += 4) {
      const int4 st = row_tile_stats<kBN>(kpos, kseg, p.S, (c0 + i) * kBN, lane);
      if (lane == 0) stats[i] = st;
    }
    named_barrier(5, 128);   // the chunk's statistics are in shared memory
    for (int i = 0; warp == 0 && !none && i < n; ++i) {
      const int4 s4 = stats[i];
      const int kstat[4] = {s4.x, s4.y, s4.z, s4.w};
      if (!tiles_live(qstat, kstat, segmented, p.causal, p.window)) continue;
      const int t = c0 + i, k0 = t * kBN;
      const int full = k0 + kBN <= p.S &&
                       tiles_full(qstat, kstat, segmented, p.causal, p.window);
      int pos[kBN / 32], seg[kBN / 32];   // loaded before the wait, which hides their latency
      if (!full) {
#pragma unroll
        for (int j = 0; j < kBN / 32; ++j) {
          const int kk = k0 + lane + 32 * j;
          pos[j] = kk < p.S ? kpos[kk] : 0;
          seg[j] = kk < p.S ? (segmented ? kseg[kk] : 0) : kNoKey;
        }
      }
      mbar_wait(bar.k_empty + 8 * stage, phase ^ 1);
      if (!full) {
        int* const meta = reinterpret_cast<int*>(smem + L::kMeta) + stage * 2 * kBN;
#pragma unroll
        for (int j = 0; j < kBN / 32; ++j) {
          meta[lane + 32 * j] = pos[j];
          meta[kBN + lane + 32 * j] = seg[j];
        }
      }
      if (lane == 0) {
        items[stage] = make_int2(t, full);
        mbar_arrive_tx(bar.k_full + 8 * stage, L::kKTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(smem_u32(smem + L::kK + stage * L::kKTile + x * L::kKBox),
                      tk, bar.k_full + 8 * stage, 64 * x, kvh, k0, b);
      } else {
        mbar_arrive(bar.k_full + 8 * stage);
      }
      mbar_wait(bar.v_empty + 8 * stage, phase ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(bar.v_full + 8 * stage, L::kKTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(smem_u32(smem + L::kV + stage * L::kKTile + x * L::kKBox),
                      tv, bar.v_full + 8 * stage, 64 * x, kvh, k0, b);
      }
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
    named_barrier(5, 128);   // warp 0 is done with them
  }
  if (warp != 0) return;
  mbar_wait(bar.k_empty + 8 * stage, phase ^ 1);
  if (lane == 0) items[stage] = make_int2(-1, 0);
  mbar_arrive(bar.k_full + 8 * stage);
}

// The online softmax on one tile's s (64 rows x kBN keys per warpgroup,
// fp32 accumulator layout: element 4 j + e is row g + 8 (e / 2), key 8 j +
// 2 c + e % 2): the running max and sum in the log2 domain, masked entries chosen
// by select, o rescaled (no product may be writing it); s is left holding
// p. kCap and kMask choose the form. Without softcap, s stays unscaled
// until one fused multiply-add per entry takes it to the log2 domain.
// The element mask (the reference's `_element_mask`, `visible`) is taken
// per row as a segment and an interval of key positions: key (kp, ks) is
// visible to row i iff ks == qs[i] and lo[i] <= kp <= hi[i] (see consume).
template <int kD, bool kCap, bool kMask, int kBN = Smem<kD>::kBN>
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], float (&m)[2],
                                             float (&l)[2], float (&o)[kD / 2],
                                             const int* kpos, const int* kseg,
                                             const int (&lo)[2],
                                             const int (&hi)[2],
                                             const int (&qs)[2], int c,
                                             const Params& p) {
  // without softcap: log2-domain score = s * qscale; with it: cap_mul *
  // tanh(s * cap_in), already in the log2 domain
  const float qscale = p.sm_scale * kLog2e;
  const float cap_in = kCap ? p.sm_scale / p.softcap : 0.f;
  const float cap_mul = kCap ? p.softcap * kLog2e : 0.f;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    int2 kp2, ks2;   // the positions and segment ids of keys 8 j + 2 c (+ 1)
    if constexpr (kMask) {
      kp2 = *reinterpret_cast<const int2*>(kpos + 8 * j + 2 * c);
      ks2 = *reinterpret_cast<const int2*>(kseg + 8 * j + 2 * c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float x = s[4 * j + e];
      if constexpr (kCap) x = cap_mul * tanhf(x * cap_in);
      if constexpr (kMask) {
        const int kp = (e & 1) ? kp2.y : kp2.x, ks = (e & 1) ? ks2.y : ks2.x;
        x = (ks == qs[i]) & (kp >= lo[i]) & (kp <= hi[i]) ? x : kNegInf;
      }
      s[4 * j + e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
  }
  float mnew[2], mscale[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // a row masked so far keeps the exact sentinel kNegInf
    if constexpr (!kCap) mx[i] = mx[i] == kNegInf ? kNegInf : mx[i] * qscale;
    mnew[i] = fmaxf(m[i], mx[i]);
    const float alpha = ex2(m[i] - mnew[i]);
    m[i] = mnew[i];
    l[i] *= alpha;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[4 * n + 2 * i] *= alpha;
      o[4 * n + 2 * i + 1] *= alpha;
    }
    mscale[i] = kCap ? 1.f : qscale;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      // a masked entry holds exactly kNegInf; it contributes nothing, also
      // on a row that has seen no key yet (mnew = kNegInf)
      float pe = ex2(fmaf(s[4 * j + e], mscale[i], -mnew[i]));
      if constexpr (kMask) pe = s[4 * j + e] == kNegInf ? 0.f : pe;
      s[4 * j + e] = pe;
      l[i] += pe;
    }
  }
}

// The two consumer warpgroups: warpgroup wg owns query rows
// [64 wg, 64 wg + 64) of the block's tile; thread (warp w4, lane 4 g + c)
// holds rows 16 w4 + g and 16 w4 + g + 8 of them. Each loop step is one
// turn on the tensor cores, s = q k^T of tile n and o += p v of tile n - 1,
// then the softmax of tile n. The warpgroups take their turns in
// alternation (named barriers 1 + wg; warpgroup 0 goes first), so that
// one's softmax runs while the other's products do.
template <int kD>
__device__ __forceinline__ void consume(const CUtensorMap* to, const Params& p,
                                        uint8_t* smem, int ct) {
  using L = Smem<kD>;
  constexpr int kRB = L::kRB, kBN = L::kBN;
  const int wg = ct / 128, w4 = (ct / 32) % 4, lane = ct % 32;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, q0 = tile_q0();
  const bool segmented = p.qseg != nullptr;
  const Bars bar(smem_u32(smem + L::kBar));
  const int2* const items = reinterpret_cast<const int2*>(smem + L::kItem);

  // rows within the block's tile, and their element mask: key (kp, ks) is
  // visible to row i iff ks == qs[i] and lo[i] <= kp <= hi[i]. Keys past S
  // carry segment kNoKey; a row past T or of padding (segment -1) sees
  // nothing: its interval is empty.
  int rloc[2], qs[2], lo[2], hi[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rloc[i] = 64 * wg + 16 * w4 + g + 8 * i;
    row_ok[i] = q0 + rloc[i] < p.T;
    const size_t r = (size_t)b * p.T + q0 + rloc[i];
    const int qp = row_ok[i] ? p.qpos[r] : 0;
    qs[i] = (row_ok[i] && segmented) ? p.qseg[r] : 0;
    const bool sees = row_ok[i] && qs[i] >= 0;
    hi[i] = !sees ? kIntMin : p.causal ? qp : kIntMax;
    lo[i] = !sees ? kIntMax
          : (p.causal && p.window > 0) ? qp - p.window + 1 : kIntMin;
  }
  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums
  uint32_t pa[kBN / 16][4];          // p of the previous tile, bf16 A fragments

  const uint32_t q_a = smem_u32(smem + L::kQ) + wg * 64 * kRB;
  const bool cap = p.softcap > 0.f;
  int stage = 0, prev = 0;             // prev: the stage of the last tile
  uint32_t phase = 0, prev_phase = 0;

  // One turn on the tensor cores: wait for it (named barrier 1 + wg), issue
  // this warpgroup's products, hand the turn to the other warpgroup, wait
  // for the products. Warpgroup 1's last turn hands over none, as
  // warpgroup 0 takes no turn after its own last.
  auto turn = [&](auto&& issue, bool last) {
    named_barrier(1 + wg, 256);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pa[kk]);
    fence_regs(o);
    wgmma_fence();
    issue();
    wgmma_commit();
    if (!(last && wg == 1)) named_barrier_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_regs(o);
  };
  float s[kBN / 2];   // the first k-step of s = q k^T overwrites it
  auto qk = [&]() {   // s = q k^T: 64 rows x kBN keys
    const uint32_t k_a = smem_u32(smem + L::kK + stage * L::kKTile);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<kBN, 0, 0>(s, desc<kRB>(q_a + (kk / 4) * L::kQBox + off, 16, 8 * kRB),
                          desc<kRB>(k_a + (kk / 4) * L::kKBox + off, 16, 8 * kRB),
                          kk > 0);
    }
  };
  auto pv = [&]() {   // o += p v of the last tile, v read MN-major
    const uint32_t v_a = smem_u32(smem + L::kV + prev * L::kKTile);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      if constexpr (kD <= 128) {
        wgmma_rs<kD, 1>(o, pa[kk], desc<kRB>(v_a + kk * 16 * kRB, L::kKBox, 8 * kRB), 1);
      } else {   // wgmma_rs stops at n128: one product per 128 columns
#pragma unroll
        for (int n = 0; n < kD / 128; ++n)
          wgmma_rs<128, 1>(*reinterpret_cast<float(*)[64]>(o + 64 * n), pa[kk],
                           desc<kRB>(v_a + 2 * n * L::kKBox + kk * 16 * kRB,
                                     L::kKBox, 8 * kRB), 1);
      }
    }
  };
  // The softmax of the tile in `stage` (s holds its scores), its k stage
  // freed, p to bf16 A fragments.
  auto softmax = [&](int2 item) {
    fence_regs(s);
    const int* const kpos = reinterpret_cast<const int*>(smem + L::kMeta) +
                            stage * 2 * kBN;
    const int* const kseg = kpos + kBN;
    const bool mask = item.y == 0;
    if (cap && mask) softmax_tile<kD, true, true>(s, m, l, o, kpos, kseg, lo, hi, qs, c, p);
    else if (cap) softmax_tile<kD, true, false>(s, m, l, o, kpos, kseg, lo, hi, qs, c, p);
    else if (mask) softmax_tile<kD, false, true>(s, m, l, o, kpos, kseg, lo, hi, qs, c, p);
    else softmax_tile<kD, false, false>(s, m, l, o, kpos, kseg, lo, hi, qs, c, p);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.k_empty + 8 * stage);   // k and meta are free
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      fence_regs(pa[kk]);
    }
    fence_regs(o);
    prev = stage;
    prev_phase = phase;
    if (++stage == kStages) { stage = 0; phase ^= 1; }
  };
  auto release_v = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar.v_empty + 8 * prev);   // v is free
  };

  // the q tile has landed (also when no kv tile is live: the epilogue
  // writes o over it)
  mbar_wait(bar.q, 0);
  if (wg == 1) named_barrier_arrive(1, 256);   // warpgroup 0's first turn
  mbar_wait(bar.k_full, 0);
  int2 item = items[0];
  if (item.x < 0) {
    // no live tile: warpgroup 0 takes the turn warpgroup 1 handed over
    if (wg == 0) named_barrier(1, 256);
  } else {
    turn(qk, false);                 // tile 0: s only
    softmax(item);
    for (;;) {
      mbar_wait(bar.k_full + 8 * stage, phase);
      item = items[stage];
      mbar_wait(bar.v_full + 8 * prev, prev_phase);
      if (item.x < 0) break;
      turn([&]() { qk(); pv(); }, false);   // s of tile n, o += p v of n - 1
      release_v();
      softmax(item);
    }
    turn(pv, true);                  // o += p v of the last tile
    release_v();
  }

  // ---- o = acc / l into this warpgroup's 64 rows of the q tile, which
  // its products no longer read, then one TMA store; lse = m + log l ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = (8 * j + 2 * c) * 2;   // in bytes
      *reinterpret_cast<uint32_t*>(
          smem + L::kQ + (col / kRB) * L::kQBox +
          swizzle<kRB>(rloc[i] * kRB + col % kRB)) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
  }
  fence_proxy_async();
  named_barrier(3 + wg, 128);   // this warpgroup's o rows are in shared memory
  if (ct % 128 == 0 && q0 + 64 * wg < p.T) {
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x)
      tma_store_4d(to, smem_u32(smem + L::kQ + x * L::kQBox + 64 * wg * kRB),
                   64 * x, h, q0 + 64 * wg, b);
    bulk_commit();
    bulk_wait_read();
  }
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!row_ok[i]) continue;
      const float mn = m[i] == kNegInf ? kNegInf : m[i] * kLn2;
      p.lse[((size_t)b * p.H + h) * p.T + q0 + rloc[i]] = mn + logf(l[i]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kPrefillThreads, 1)
mha_fwd_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const Params p) {
  using L = Smem<kD>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  if (tid == 0) {
    const Bars bar(smem_u32(smem + L::kBar));
    mbar_init(bar.q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.k_full + 8 * s, 32);               // the producer warp
      mbar_init(bar.v_full + 8 * s, 1);                // its lane 0
      mbar_init(bar.k_empty + 8 * s, kConsumers / 32);   // each consumer warp
      mbar_init(bar.v_empty + 8 * s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Registers: the launch gives every thread 168 (65536 / 384, rounded
  // down to 8). The producer warpgroup gives back 168 - 40 a thread and
  // the consumers take 232 - 168; the two must match (40 + 2 x 232 =
  // 3 x 168), or setmaxnreg.inc waits for ever.
  if (tid < 128) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    produce<kD>(&tq, &tk, &tv, p, smem, tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<kD>(&to, p, smem, tid - 128);
  }
}

template <int kD>
int launch_prefill(const void* q, const void* k, const void* v, void* o,
                   const Params& p, cudaStream_t stream);

// The decode form with kMT row tiles.
template <int kD, int kMT>
int launch_decode(const DecParams& p, cudaStream_t stream) {
  using L = DecSmem<kD, kMT>;
  const int bytes = L::kBits + 2 * 4 * p.words;
  const int n_rg = (p.H / p.KV + p.gh - 1) / p.gh;
  if (bytes > 232448 || (long long)p.KV * n_rg > 65535 || p.B > 65535)
    return (int)cudaErrorInvalidValue;
  // above 48 KB only when asked for; set per launch, as it is per device.
  // The whole carve-out to shared memory: two blocks of about 110 KB fit
  // on an SM
  cudaFuncSetAttribute(mha_fwd_decode_kernel<kD, kMT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncSetAttribute(mha_fwd_decode_kernel<kD, kMT>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  mha_fwd_decode_kernel<kD, kMT><<<dim3(p.n_split, p.KV * n_rg, p.B), kThreads,
                                   bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// K1 at head dim kD: the decode form for T <= 16 (one row tile where the
// block's gh · T rows fit in 16), else a prefill form.
template <int kD>
int launch(const void* q, const void* k, const void* v, void* o,
           const DecParams& p, cudaStream_t stream) {
  if (p.T <= 16) {
    if (p.gh <= 0 || p.gh > p.H / p.KV || p.gh * p.T > 16 * dec_max_mt<kD>() ||
        p.n_split <= 0 || (p.n_split > 1 && p.ws == nullptr))
      return (int)cudaErrorInvalidValue;
    return p.gh * p.T <= 16 ? launch_decode<kD, 1>(p, stream)
                            : launch_decode<kD, dec_max_mt<kD>()>(p, stream);
  }
  return launch_prefill<kD>(q, k, v, o, p, stream);
}

// The prefill form.
template <int kD>
int launch_prefill(const void* q, const void* k, const void* v, void* o,
                   const Params& p, cudaStream_t stream) {
  using L = Smem<kD>;
  const int n_qt = (p.T + kBM - 1) / kBM;
  if (p.H > 65535 || p.B > 65535) return (int)cudaErrorInvalidValue;
  constexpr auto kBF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t inner = L::kRB / 2;
  // q and o (B, T, H, D), k and v (B, S, KV, D), all bf16; o is stored by
  // each consumer warpgroup, 64 rows at a time
  const cuuint64_t qdims[4] = {kD, (cuuint64_t)p.H, (cuuint64_t)p.T, (cuuint64_t)p.B};
  const cuuint64_t kdims[4] = {kD, (cuuint64_t)p.KV, (cuuint64_t)p.S, (cuuint64_t)p.B};
  const cuuint32_t qbox[4] = {inner, 1, kBM, 1}, kbox[4] = {inner, 1, L::kBN, 1};
  const cuuint32_t obox[4] = {inner, 1, 64, 1};
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, kBF16, 2, q, qdims, qbox) ||
      !make_map(&tk, kBF16, 2, k, kdims, kbox) ||
      !make_map(&tv, kBF16, 2, v, kdims, kbox) ||
      !make_map(&to, kBF16, 2, o, qdims, obox))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(mha_fwd_prefill_kernel<kD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  // the query tile is the fastest grid axis, reversed in tile_q0: the
  // blocks in flight together share a few heads, whose k and v stay in L2,
  // and within each head the last (for a causal mask the heaviest) tiles
  // start first
  mha_fwd_prefill_kernel<kD><<<dim3(n_qt, p.H, p.B), kPrefillThreads,
                               L::kBytes, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16, contiguous (B,T,H,D) / (B,S,KV,D), 16-byte aligned, with
// D in {16, 32, 64, 128, 256}; positions and segment ids: int32 (B,T) / (B,S),
// segment ids both null or both set; lse: fp32 (B,H,T). sm_scale multiplies
// q k^T: 1/sqrt(D), or 1/sqrt of the caller's own head dim where it padded
// q, k and v with zero columns up to D. For T <= 16 (the decode form),
// n_split splits of the live key tiles and gh q heads per block (gh · T at
// most 64 rows, 32 at D 256), and with n_split > 1 a workspace `ws` of
// ws_numel >= n_split · B · T · H · (D + 2) fp32 elements and then B · KV ·
// ceil(H / KV / gh) zeroed int32 counters, which the kernel leaves at zero;
// the prefill form reads none of the three. With o_f32 (the decode form
// only) o is an fp32 (B,T,H,D) tensor written unrounded: one slice's partial
// for a merge over a KV cache split by sequence (spmd.merge_attention), which
// then rounds once. Launches on `stream` the decode form for T <= 16, else
// the prefill form, and returns a CUDA error code (0: launched).
extern "C" int mha_fwd_bf16(const void* q, const void* k, const void* v,
                            const void* qpos, const void* kpos,
                            const void* qseg, const void* kseg,
                            void* o, void* lse, void* ws,
                            int B, int T, int S, int H, int KV, int D,
                            int causal, int window, float softcap,
                            float sm_scale, int n_split, int gh,
                            long long ws_numel, int o_f32, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || T <= 0 || S <= 0 ||
      (o_f32 && T > 16))
    return (int)cudaErrorInvalidValue;
  const long long partials = (long long)n_split * B * T * H * (D + 2);
  if (T <= 16 && n_split > 1 &&
      (gh <= 0 || ws_numel < partials + (long long)B * KV * ((H / KV + gh - 1) / gh)))
    return (int)cudaErrorInvalidValue;
  DecParams p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.o = static_cast<uint16_t*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.T = T; p.S = S; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.softcap = softcap;
  p.sm_scale = sm_scale;
  p.n_split = n_split; p.gh = gh;
  p.words = ((S + kBK - 1) / kBK + 31) / 32;
  p.ws = static_cast<float*>(ws);
  p.sem = ws == nullptr ? nullptr : reinterpret_cast<int*>(p.ws + partials);
  p.o_f32 = o_f32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, p, st);
    case 32: return launch<32>(q, k, v, o, p, st);
    case 64: return launch<64>(q, k, v, o, p, st);
    case 128: return launch<128>(q, k, v, o, p, st);
    case 256: return launch<256>(q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of the prefill form at head dim D, in bytes,
// alignment slack included, or 0 for a head dim it does not take.
extern "C" int mha_fwd_prefill_smem(int D) {
  switch (D) {
    case 16: return Smem<16>::kBytes;
    case 32: return Smem<32>::kBytes;
    case 64: return Smem<64>::kBytes;
    case 128: return Smem<128>::kBytes;
    case 256: return Smem<256>::kBytes;
    default: return 0;
  }
}

// The dynamic shared memory of the decode form at head dim D for blocks of
// `rows` query rows (G·T), before the tiles' bits (8 bytes per 32 key
// tiles), in bytes, or 0 for a head dim it does not take or more rows than
// a block takes (64, 32 at D 256).
template <int kD>
int decode_smem(int rows) {
  return rows <= 0 ? 0
       : rows <= 16 ? DecSmem<kD, 1>::kBits
       : rows <= 16 * dec_max_mt<kD>() ? DecSmem<kD, dec_max_mt<kD>()>::kBits
       : 0;
}

extern "C" int mha_fwd_decode_smem(int D, int rows) {
  switch (D) {
    case 16: return decode_smem<16>(rows);
    case 32: return decode_smem<32>(rows);
    case 64: return decode_smem<64>(rows);
    case 128: return decode_smem<128>(rows);
    case 256: return decode_smem<256>(rows);
    default: return 0;
  }
}
