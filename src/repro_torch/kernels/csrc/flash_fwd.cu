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
//    kv cache, read once per q head, at a few FLOPs per byte.
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
// Decode (T <= 16), `mha_fwd_decode_kernel`: one block per (16 query rows,
// head, batch row) on mma.sync m16n8k16 with ldmatrix; the four warps share
// the rows and each takes 16 keys of every 64-key tile; their partial
// (m, l, acc) are merged through shared memory at the end. It loads the
// next live tile with cp.async into a second buffer while the current one
// is computed. Not yet done: splitting the cache across blocks. At D 256
// q's fragments would take 64 registers beside o's 128, so they are
// re-read from a copy of q in shared memory for every tile.
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

// ---------------------------------------------------------------------
// decode (T <= 16)
// ---------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// kD: head dim, a multiple of 16 (one mma k-step).
template <int kD>
__global__ void __launch_bounds__(kThreads)
mha_fwd_decode_kernel(const Params p) {
  constexpr int kStride = kD + 8;            // bf16 per shared row: ldmatrix
                                             // rows land on distinct banks
  constexpr int kRows = 16;                  // query rows per block
  constexpr int kNT = 2;                     // 8-key n-tiles per warp per tile
  // q's fragments: in registers up to D 128; at D 256 they would take 64 of
  // the registers o needs, so they are re-read from shared memory
  constexpr bool kQSmem = kD > 128;
  // dynamic shared memory: two buffers of (k tile, v tile), each
  // [kBK][kStride] bf16, then two buffers of the tile's positions and
  // segment ids, [kBK] int each, then at D 256 q, [kRows][kStride] bf16
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const kv_s = reinterpret_cast<uint16_t*>(smem);
  int* const kpos_s = reinterpret_cast<int*>(kv_s + 4 * kBK * kStride);
  int* const kseg_s = kpos_s + 2 * kBK;
  uint16_t* const q_s = reinterpret_cast<uint16_t*>(kseg_s + 2 * kBK);
  __shared__ int part[2][4];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;   // mma fragment row group / column pair
  const int mi = lane >> 3, r8 = lane & 7; // ldmatrix: matrix and row this lane addresses
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (p.H / p.KV);
  const bool segmented = p.qseg != nullptr;
  const int koff = warp * 16;              // first key of this warp in a tile
  const float qscale = p.softcap > 0.f ? p.sm_scale : p.sm_scale * kLog2e;

  // ---- this thread's two query rows, and the q tile's statistics ----
  const int row[2] = {g, g + 8};
  bool row_ok[2];
  int qp[2], qs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = row[i] < p.T;
    qp[i] = row_ok[i] ? p.qpos[(size_t)b * p.T + row[i]] : 0;
    qs[i] = (row_ok[i] && segmented) ? p.qseg[(size_t)b * p.T + row[i]] : 0;
  }
  // ---- at D 256, q (16 rows, zeros past T) into shared memory, read
  // after the barriers of tile_stats ----
  if constexpr (kQSmem) {
    const size_t rs = (size_t)p.H * kD;   // token stride of q
#pragma unroll
    for (int j = 0; j < kRows * (kD / 8) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kD / 8), ch = i % (kD / 8);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < p.T)
        x = *reinterpret_cast<const uint4*>(
            p.q + ((size_t)b * p.T + r) * rs + (size_t)h * kD + ch * 8);
      *reinterpret_cast<uint4*>(q_s + r * kStride + ch * 8) = x;
    }
  }
  int qstat[4];
  {
    const bool ok = tid < kRows && tid < p.T;
    const int pos = ok ? p.qpos[(size_t)b * p.T + tid] : 0;
    const int seg = (ok && segmented) ? p.qseg[(size_t)b * p.T + tid] : 0;
    tile_stats(ok, pos, seg, part, qstat);
  }

  // ---- q fragments: 16 rows x kD dims, in registers (up to D 128) ----
  uint32_t qa[kQSmem ? 1 : kD / 16][4];
  if constexpr (!kQSmem) {
    const size_t rs = (size_t)p.H * kD;   // token stride of q
    const uint16_t* q_r0 = p.q + ((size_t)b * p.T + row[0]) * rs + (size_t)h * kD;
    const uint16_t* q_r1 = p.q + ((size_t)b * p.T + row[1]) * rs + (size_t)h * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int d = kk * 16 + c * 2;
      qa[kk][0] = row_ok[0] ? load_u32(q_r0 + d) : 0u;
      qa[kk][1] = row_ok[1] ? load_u32(q_r1 + d) : 0u;
      qa[kk][2] = row_ok[0] ? load_u32(q_r0 + d + 8) : 0u;
      qa[kk][3] = row_ok[1] ? load_u32(q_r1 + d + 8) : 0u;
    }
  }

  float oacc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  const size_t kv_rs = (size_t)p.KV * kD;   // token stride of k and v
  const int n_tiles = (p.S + kBK - 1) / kBK;

  // Positions and segment ids of key k0 + tid (threads < kBK); `ok` false
  // past S or for the other threads.
  auto load_key = [&](int t, int& pos, int& seg, bool& ok) {
    const int kk = t * kBK + tid;
    ok = tid < kBK && kk < p.S;
    pos = ok ? p.kpos[(size_t)b * p.S + kk] : 0;
    seg = (ok && segmented) ? p.kseg[(size_t)b * p.S + kk] : 0;
  };
  // Those of the tile after the one last looked at, loaded ahead so that
  // the next search does not wait for them.
  int pf_t = -1, pf_pos = 0, pf_seg = 0;
  bool pf_ok = false;

  // The first live tile at or after t, n_tiles if none; its positions and
  // segment ids go to buffer buf, and `full` says whether every (row, key)
  // pair of it is visible, so that it needs no element mask.
  auto find_live = [&](int t, int buf, bool& full_out) -> int {
    for (; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      int pos, seg;
      bool ok;
      if (t == pf_t) {
        pos = pf_pos; seg = pf_seg; ok = pf_ok;
      } else {
        load_key(t, pos, seg, ok);
      }
      pf_t = t + 1;
      if (pf_t < n_tiles) load_key(pf_t, pf_pos, pf_seg, pf_ok);
      if (tid < kBK) { kpos_s[buf * kBK + tid] = pos; kseg_s[buf * kBK + tid] = seg; }
      int kstat[4];
      tile_stats(ok, pos, seg, part, kstat);
      if (!tiles_live(qstat, kstat, segmented, p.causal, p.window))
        continue;   // uniform over the block
      const bool f = k0 + kBK <= p.S &&
                     tiles_full(qstat, kstat, segmented, p.causal, p.window);
      full_out = f;
      return t;
    }
    return n_tiles;
  };

  // k and v of tile t into buffer buf, zeros past S: one group of
  // cp.async, every copy of the thread in flight at once.
  auto issue = [&](int t, int buf) {
    const int k0 = t * kBK;
    uint16_t* const kb = kv_s + buf * 2 * kBK * kStride;
    uint16_t* const vb = kb + kBK * kStride;
#pragma unroll
    for (int j = 0; j < kBK * (kD / 8) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (kD / 8), ch = i % (kD / 8);
      const bool in = k0 + r < p.S;
      const size_t off = in ? ((size_t)b * p.S + k0 + r) * kv_rs +
                              (size_t)kvh * kD + ch * 8 : 0;
      cp_async16(kb + r * kStride + ch * 8, p.k + off, in);
      cp_async16(vb + r * kStride + ch * 8, p.v + off, in);
    }
    cp_async_commit();
  };

  // Two buffers: the next live tile loads while this one is computed.
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
    __syncthreads();   // tile cur is in buffer buf for every thread
    const int k0 = cur * kBK;
    const uint16_t* const ks = kv_s + buf * 2 * kBK * kStride;
    const uint16_t* const vs = ks + kBK * kStride;
    const int* const kpos_b = kpos_s + buf * kBK;
    const int* const kseg_b = kseg_s + buf * kBK;
    {
      // ---- s = q k^T for the 16 rows x (kNT * 8) keys of this warp ----
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t qf[4];   // at D 256, the A fragment of rows 0-15, dims 16 kk..
        if constexpr (kQSmem)
          ldsm_x4(qf, q_s + ((mi & 1) * 8 + r8) * kStride + kk * 16 + (mi >> 1) * 8);
        const uint32_t (&qk)[4] = kQSmem ? qf : qa[kk];
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t kb[4];   // b0, b1 of n-tiles n and n + 1
          ldsm_x4(kb, ks + (koff + (n + (mi >> 1)) * 8 + r8) * kStride +
                          kk * 16 + (mi & 1) * 8);
          mma_bf16(s[n], qk, kb[0], kb[1]);
          mma_bf16(s[n + 1], qk, kb[2], kb[3]);
        }
      }

      // ---- scale (to log2), cap, mask; online softmax update ----
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;                            // which of the two rows
          const int key = koff + n * 8 + c * 2 + (e & 1);  // key within the tile
          float x = s[n][e] * qscale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap) * kLog2e;
          if (!full) {
            const bool ok = k0 + key < p.S &&
                            visible(qp[i], qs[i], kpos_b[key], kseg_b[key],
                                    segmented, p.causal, p.window);
            if (!ok) x = kNegInf;
          }
          s[n][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      float alpha[2], mnew[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mnew[i] = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - mnew[i]);
        m[i] = mnew[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          // a masked entry holds exactly kNegInf; it contributes nothing
          const float pe = s[n][e] == kNegInf ? 0.f : exp2f(s[n][e] - mnew[i]);
          s[n][e] = pe;
          l[i] += pe;
        }
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        oacc[n][0] *= alpha[0]; oacc[n][1] *= alpha[0];
        oacc[n][2] *= alpha[1]; oacc[n][3] *= alpha[1];
      }

      // ---- o += p v: p from the s fragments, v by transposed ldmatrix ----
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const uint16_t* v0 = vs + (koff + kk * 16 + (mi & 1) * 8 + r8) * kStride +
                             (mi >> 1) * 8;
#pragma unroll
        for (int n = 0; n < kD / 8; n += 2) {
          uint32_t vb[4];   // b0, b1 of n-tiles n and n + 1
          ldsm_x4_trans(vb, v0 + n * 8);
          mma_bf16(oacc[n], pa, vb[0], vb[1]);
          mma_bf16(oacc[n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();   // buffer buf is free for the tile after next
    cur = next;
    full = full_next;
  }

  // ---- row sums over the four threads of a row ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // ---- merge the four warps' partial rows; warp 0 writes the result ----
  __shared__ float ml_s[kWarps][2][16];
  __syncthreads();   // the tiles in shared memory are no longer read
  // warps 1..3's accumulators, [3][kD/8][4][32] floats, over the tiles
  static_assert(3 * kD / 8 * 4 * 32 * 4 <= 4 * kBK * kStride * 2, "smem");
  float* acc_s = reinterpret_cast<float*>(kv_s);
  if (c == 0) {
    ml_s[warp][0][g] = m[0];     ml_s[warp][0][g + 8] = m[1];
    ml_s[warp][1][g] = l[0];     ml_s[warp][1][g + 8] = l[1];
  }
  __syncthreads();
  float sc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = g + 8 * i;
    float mt = ml_s[0][0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, ml_s[w][0][r]);
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lt += ml_s[w][1][r] * exp2f(ml_s[w][0][r] - mt);
    sc[i] = exp2f(m[i] - mt);
    m[i] = mt;
    l[i] = lt;
  }
  if (warp > 0) {
    float* dst = acc_s + (size_t)(warp - 1) * (kD / 8) * 4 * 32;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(n * 4 + e) * 32 + lane] = oacc[n][e] * sc[e >> 1];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = oacc[n][e] * sc[e >> 1];
#pragma unroll
      for (int w = 0; w < kWarps - 1; ++w)
        x += acc_s[((size_t)w * (kD / 8) * 4 + n * 4 + e) * 32 + lane];
      oacc[n][e] = x;
    }

  // ---- finalize: o = acc / l, lse = m + log l (natural log) ----
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    uint16_t* orow = p.o + (((size_t)b * p.T + row[i]) * p.H + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + c * 2) =
          pack_bf16(oacc[n][2 * i] * inv[i], oacc[n][2 * i + 1] * inv[i]);
    }
    if (c == 0) {
      const float mn = m[i] == kNegInf ? kNegInf : m[i] * kLn2;
      p.lse[((size_t)b * p.H + h) * p.T + row[i]] = mn + logf(l[i]);
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

// K1 at head dim kD: the decode form for T <= 16, else a prefill form.
template <int kD>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  if (p.T <= 16) {
    // at D 256 q's 16 rows are kept in shared memory too
    constexpr int kBytes = 4 * kBK * (kD + 8) * 2 + 4 * kBK * 4 +
                           (kD > 128 ? 16 * (kD + 8) * 2 : 0);
    // above 48 KB only when asked for; set per launch, as it is per device
    cudaFuncSetAttribute(mha_fwd_decode_kernel<kD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    mha_fwd_decode_kernel<kD><<<dim3(1, p.H, p.B), kThreads, kBytes, stream>>>(p);
    return (int)cudaGetLastError();
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
// q, k and v with zero columns up to D. Launches on `stream` the decode
// form for T <= 16, else the prefill form, and returns a CUDA error code
// (0: launched).
extern "C" int mha_fwd_bf16(const void* q, const void* k, const void* v,
                            const void* qpos, const void* kpos,
                            const void* qseg, const void* kseg,
                            void* o, void* lse,
                            int B, int T, int S, int H, int KV, int D,
                            int causal, int window, float softcap,
                            float sm_scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
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
