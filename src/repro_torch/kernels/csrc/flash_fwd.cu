// K1 — attention forward for Hopper (sm_90a), bf16 in, fp32 statistics.
//
// Replaces the TPU kernel `mha_forward` in src/repro/kernels/flash_attention.py
// (pl.pallas_call at :354, body `_fwd_body` at :162), in both its plain form
// (`flash_attention`) and its segmented form (`ragged_attention`).
//
// What it computes, for q (B,T,H,D), k/v (B,S,KV,D) with a head dim D of 16,
// 32, 64 or 128 (gpt-paper: 128; its reduced widths: 16), positions and
// segment ids (B,T)/(B,S) int32:
//   o   (B,T,H,D) bf16 = softmax(mask(cap(q k^T / sqrt(D)))) v
//   lse (B,H,T)   fp32 = m + log(max(l, 1e-30)), the finite sentinel -1e30
//                        standing in for -inf on rows with no visible key.
// The mask is the reference's `_element_mask`: same segment and segment >= 0
// (segmented), 0 <= q_pos - k_pos (< window) (causal). Keys past S are masked
// too, so any T and S work, T = 1 included; the tile is never shrunk.
//
// Design. A loop over kv tiles of 64 keys inside the block stands in for the
// TPU grid's sequential kv axis, with the running max m, the running sum l
// and the output accumulator kept in registers in fp32 (online softmax, in
// the log2 domain). k/v are read at head h / (H / KV): GQA repeats nothing in
// memory. Before a kv tile is loaded, the block evaluates the reference's
// `_live_terms` on the min/max of the tile's positions and segment ids and
// skips a tile no pair can see (the causal upper triangle, other samples,
// padding); a tile every pair sees skips the element mask too. Products run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate), the
// k and v fragments read from shared memory with ldmatrix; p is rounded to
// bf16 for the p·v product. Two shapes of block:
//  - prefill (T > 16): one block per (64 query rows, head, batch row), each of
//    its four warps owns 16 rows and every key of a tile;
//  - decode (T <= 16): one block per (16 query rows, head, batch row), the
//    four warps share the rows and each takes 16 keys of every tile; their
//    partial (m, l, acc) are merged through shared memory at the end.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
//  - prefill (T = S = bucket length, causal) is bound by operations:
//    4·B·H·T·S·D/2 FLOPs against (3·S + T)·H·D·2 bytes per batch row;
//  - decode (T = 1 against an S-long cache) is bound by the bytes of the live
//    kv cache, read once per q head, at a few FLOPs per byte.
// What this design does about it: prefill keeps every operand of the inner
// products in shared memory or registers and does products only on live
// tiles; decode reads each live k/v tile once per block and spreads the
// products of a tile over all four warps. Both load the next live tile with
// cp.async into a second buffer while the current one is computed. Not yet
// done: TMA and wgmma, and splitting the cache across blocks in decode.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

// kD: head dim, a multiple of 16 (one mma k-step).
// kSplit: decode shape; the warps share 16 rows and split each tile's keys.
template <int kD, bool kSplit>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const Params p) {
  constexpr int kStride = kD + 8;            // bf16 per shared row: ldmatrix
                                             // rows land on distinct banks
  constexpr int kRows = kSplit ? 16 : 64;    // query rows per block
  constexpr int kNT = kSplit ? 2 : kBK / 8;  // 8-key n-tiles per warp per tile
  // dynamic shared memory: two buffers of (k tile, v tile), each
  // [kBK][kStride] bf16, then two buffers of the tile's positions and
  // segment ids, [kBK] int each
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* const kv_s = reinterpret_cast<uint16_t*>(smem);
  int* const kpos_s = reinterpret_cast<int*>(kv_s + 4 * kBK * kStride);
  int* const kseg_s = kpos_s + 2 * kBK;
  __shared__ int part[2][4];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;   // mma fragment row group / column pair
  const int mi = lane >> 3, r8 = lane & 7; // ldmatrix: matrix and row this lane addresses
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (p.H / p.KV);
  const bool segmented = p.qseg != nullptr;
  const int rw = kSplit ? 0 : warp;        // which 16 rows this warp owns
  const int koff = kSplit ? warp * 16 : 0; // first key of this warp in a tile
  const float qscale = p.softcap > 0.f ? p.sm_scale : p.sm_scale * kLog2e;

  // ---- this thread's two query rows, and the q tile's statistics ----
  const int row[2] = {q0 + rw * 16 + g, q0 + rw * 16 + g + 8};
  bool row_ok[2];
  int qp[2], qs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = row[i] < p.T;
    qp[i] = row_ok[i] ? p.qpos[(size_t)b * p.T + row[i]] : 0;
    qs[i] = (row_ok[i] && segmented) ? p.qseg[(size_t)b * p.T + row[i]] : 0;
  }
  int qstat[4];
  {
    const int r = q0 + tid;
    const bool ok = tid < kRows && r < p.T;
    const int pos = ok ? p.qpos[(size_t)b * p.T + r] : 0;
    const int seg = (ok && segmented) ? p.qseg[(size_t)b * p.T + r] : 0;
    tile_stats(ok, pos, seg, part, qstat);
  }
  const bool warp_active = q0 + rw * 16 < p.T;

  // ---- q fragments: 16 rows x kD dims per warp, in registers ----
  uint32_t qa[kD / 16][4];
  {
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
    if (warp_active) {
      // ---- s = q k^T for this warp's 16 rows x (kNT * 8) keys ----
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t kb[4];   // b0, b1 of n-tiles n and n + 1
          ldsm_x4(kb, ks + (koff + (n + (mi >> 1)) * 8 + r8) * kStride +
                          kk * 16 + (mi & 1) * 8);
          mma_bf16(s[n], qa[kk], kb[0], kb[1]);
          mma_bf16(s[n + 1], qa[kk], kb[2], kb[3]);
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

  if constexpr (kSplit) {
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
  }

  // ---- finalize: o = acc / l, lse = m + log l (natural log) ----
  if (!warp_active) return;
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

template <int kD, bool kSplit>
void launch_shape(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int kBytes = 4 * kBK * (kD + 8) * 2 + 4 * kBK * 4;
  // above 48 KB only when asked for; set per launch, as it is per device
  cudaFuncSetAttribute(mha_fwd_kernel<kD, kSplit>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  mha_fwd_kernel<kD, kSplit><<<grid, kThreads, kBytes, stream>>>(p);
}

template <int kD>
void launch(const Params& p, cudaStream_t stream) {
  if (p.T <= 16)
    launch_shape<kD, true>(p, dim3(1, p.H, p.B), stream);
  else
    launch_shape<kD, false>(p, dim3((p.T + 63) / 64, p.H, p.B), stream);
}

}  // namespace

// q, k, v, o: bf16, contiguous (B,T,H,D) / (B,S,KV,D) with D in {16, 32,
// 64, 128}; positions and segment ids: int32 (B,T) / (B,S), segment ids both
// null or both set; lse: fp32 (B,H,T). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int mha_fwd_bf16(const void* q, const void* k, const void* v,
                            const void* qpos, const void* kpos,
                            const void* qseg, const void* kseg,
                            void* o, void* lse,
                            int B, int T, int S, int H, int KV, int D,
                            int causal, int window, float softcap,
                            void* stream) {
  if (H % KV != 0 || B <= 0 || T <= 0 || S <= 0)
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
  p.sm_scale = 1.0f / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch<16>(p, st); break;
    case 32: launch<32>(p, st); break;
    case 64: launch<64>(p, st); break;
    case 128: launch<128>(p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
