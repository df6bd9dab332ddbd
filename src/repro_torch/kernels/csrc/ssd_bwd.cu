// K4's backward — the gradient of the Mamba2 SSD (the chunked scan) for
// Hopper (sm_90a): chunks walked in reverse by blocks in flight together,
// every product on the tensor cores.
//
// Replaces no TPU kernel: the reference differentiates its SSD through the
// plain chunked oracle (`ref.ssd_ref_chunked` under `jax.grad`, see
// src/repro/kernels/ops.py:116-130), and its Pallas kernel `ssd_chunked`
// (src/repro/kernels/ssd.py:114) has no backward. This is the backward of
// K4 (ssd_fwd.cu), so that a CUDA tensor that requires grad launches
// kernels in both directions.
//
// What it computes, per chunk of kL = 64 steps with a = dt·A, cum its
// in-chunk prefix sum, a_tot its last value, L_ts = e^{clip(cum_t - cum_s,
// -60, 0)} for s <= t, E_t = e^{max(cum_t, -60)}, u_s = e^{clip(a_tot -
// cum_s, -60, 0)} dt_s, S the chunk's start state and dS' the gradient of
// the next chunk's start state (of the final state for the last chunk:
// d_final, or zero):
//   W = (C Bᵀ) ∘ L ∘ dt,  M = (dy xᵀ) ∘ L ∘ dt  (both 64 x 64, lower)
//   dx  = Wᵀ dy + u ∘ (B dS'ᵀ)
//   dC  = M B + E ∘ (dy S)
//   dB  = Mᵀ C + u ∘ (x dS')                    summed over a group's heads
//   ddt = colsum((C Bᵀ) ∘ (dy xᵀ) ∘ L) + e^{clip(a_tot - cum)} ∘ x·(dS' B)
//         + A da,    dA = Σ dt da                 summed over batch rows
//   da_r = Σ_{t >= r} dcum_t, dcum from G = (C Bᵀ) ∘ (dy xᵀ) ∘ L ∘ dt: its
//   row sums less its column sums, + E_t dy_t·(S C_t), - V_t with V_s =
//   u_s x_s·(dS' B_s), and the last step + Σ V + e^{a_tot} <dS', S>; each
//   term only where its clip does not bite (the gradient of a clip is zero
//   there, in torch.clamp and in the reference's jnp.clip alike)
//   dS  = e^{max(a_tot, -60)} dS' + (E ∘ dy)ᵀ C, carried to the chunk before;
//         after the first chunk it is d_initial
// `ref.ssd_chunked_bwd` is the same walk in plain PyTorch. Any T works: x,
// dy, dt, B and C are zero-filled past T, so the padded steps add nothing,
// and nothing past T is stored.
//
// The start states. The walk needs every chunk's start state S. K4 writes
// them when asked (its chunk_state buffer, bf16 hi and lo), and the
// autograd forward asks for them whenever a gradient is needed; the first
// chunk starts from the initial state (fp32, split here) or zero. Reading
// them costs 195 MB a layer at the train shape below, about 0.06 ms; a
// recompute in this kernel would have to walk the chunks forward first and
// keep all the states anyway, since the walk here goes backward.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), at the
// mamba2-130m train shape (B 8, T 2048, H 24, P 64, N 128, G 1): the
// least traffic is x, dy and dx (50.3 MB each), B, C, dB and dC (4.2 MB
// each), dt and ddt (1.6 MB each), 171 MB, 0.051 ms; the products of the
// chunked algorithm, 2 L (L (2 N + 2 P) + 4 N P) per (batch row, head,
// 64-step chunk) and 2 L² N per (batch row, group, chunk) for C Bᵀ, which
// a group's heads share, come to 45.4 GFLOP, 0.046 ms, about twice K4's
// 23. Bound by bytes, operations close behind; the products this kernel
// issues (C Bᵀ per head, hi and lo parts, whole 16 x 16 blocks on the
// diagonal) come to 77.7 GFLOP.
//
// Design. The mirror of K4: one block of eight warps per (head, batch row)
// walks its chunks in reverse and carries dS (P x N, fp32) in registers as
// K4 carries S (192 blocks at the train shape, one per SM: 165 KB of
// shared memory at P 64, N 128). Per chunk, after the chunk's x, dy, B,
// C, dt and start state are in shared memory:
//  - one warp scans cum; each warp computes C Bᵀ and dy xᵀ for 16 steps
//    and its share of the 16 x 16 blocks up to the diagonal, and builds W,
//    M (to shared memory as bf16 hi and lo) and G in registers, G's row
//    and column sums reduced by shuffles in a fixed order;
//  - each warp takes 16 rows of dx (half of P), of dC and of dB (every
//    other 16 columns of N); the state terms first (B dS'ᵀ, dy S, x dS'),
//    scaled by u or E, then W and M's products added; the dot products
//    that dcum needs are taken from those accumulators;
//  - then dS <- e^{max(a_tot, -60)} dS + (E ∘ dy)ᵀ C in registers, E ∘ dy
//    formed from dyᵀ's fragments, and dS goes to shared memory (hi, lo)
//    for the next chunk's products; one warp assembles dcum, scans da in
//    reverse and writes ddt.
// Products on mma.sync m16n8k16, bf16 operands, fp32 sums. An fp32 operand
// (W, M, dS', S, E ∘ dy) is split into bf16 hi = bf16(v) and lo = bf16(v -
// hi), one mma each, as K4 does: about 16 bits of mantissa.
// Repeatable bit for bit: every sum has a fixed order and nothing is added
// by atomics. dB and dC are shared by the heads of a group: each head
// writes its chunk's fp32 partials, counts itself on a zeroed int32
// counter per (batch row, group, chunk), and the group's last head to count
// sums the partials in ascending head order and casts them to bf16; dA,
// shared by the batch rows, is merged the same way behind a counter per
// head. The counters order the reads, not the sums, so the result does
// not depend on which block comes last.
// Rows are read by 16-byte cp.async: x, dy, B and C need 16-byte aligned
// pointers and batch, time and head (group) strides (the wrapper checks),
// P a multiple of 16 up to 128, N a multiple of 16 up to 128, and the
// shared memory of the instantiation within the card's 227 KB (P 128 takes
// N up to 112; the launcher checks).
#include "flash_common.cuh"

namespace {

using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;

constexpr int kL = 64;          // steps per chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSW = kL + 8;     // row stride of the W and M tiles
constexpr int kMaxSmem = 232448;

struct Params {
  const uint16_t* x;
  const float* dt;
  const float* A;
  const uint16_t* b;
  const uint16_t* c;
  const uint16_t* dy;
  const uint16_t* starts;       // (B, H, nc - 1, 2, P, N) bf16 hi, lo
  const float* init;            // (B, H, P, N) fp32, or null
  const float* dfinal;          // (B, H, P, N) fp32, or null
  uint16_t* dx;                 // (B, T, H, P) bf16
  float* ddt;                   // (B, T, H) fp32
  float* dA;                    // (H,) fp32
  uint16_t* db;                 // (B, T, G, N) bf16
  uint16_t* dc;
  float* dinit;                 // (B, H, P, N) fp32
  float* part_b;                // (B, H, nc * 64, N) fp32, per head
  float* part_c;
  float* part_a;                // (B, H) fp32
  int* count;                   // B * G * nc chunk counters, then H head ones
  long long sx_b, sx_t, sx_h;   // element strides
  long long sdt_b, sdt_t, sdt_h;
  long long sb_b, sb_t, sb_g;
  long long sc_b, sc_t, sc_g;
  long long sdy_b, sdy_t, sdy_h;
  int batch, T, H, G, P, N, nc;
};

// 4 bytes global -> shared; zero when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 4 : 0));
}

// Two floats as bf16 pairs hi and lo with hi + lo within 2^-16 of them
// (relative), as in ssd_fwd.cu.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 bf16x2(const uint16_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The mma operands of a 16 x 16 tile from shared memory (row stride ld):
// A at rows m0, columns k0 of a row-major [m][k] matrix, or of the
// transpose of a [k][m] one; B (two 8-column n tiles, n0 and n0 + 8) of a
// matrix stored [n][k], or [k][n].
__device__ __forceinline__ void lda_rm(uint32_t (&a)[4], const uint16_t* base,
                                       int ld, int m0, int k0, int lane) {
  ldsm_x4(a, base + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + k0 +
                 (lane >> 4) * 8);
}
__device__ __forceinline__ void lda_tr(uint32_t (&a)[4], const uint16_t* base,
                                       int ld, int m0, int k0, int lane) {
  ldsm_x4_trans(a, base + (k0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ld +
                       m0 + ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const uint16_t* base,
                                       int ld, int n0, int k0, int lane) {
  ldsm_x4(b, base + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const uint16_t* base,
                                       int ld, int n0, int k0, int lane) {
  ldsm_x4_trans(b, base + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                       n0 + (lane >> 4) * 8);
}

// acc[0] += a b[0..1], acc[1] += a b[2..3]: the two n tiles of one ldb_*.
__device__ __forceinline__ void mma2(float (&acc)[2][4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  mma_bf16(acc[0], a, b[0], b[1]);
  mma_bf16(acc[1], a, b[2], b[3]);
}

// Shared memory, in bf16 elements from the start: x and dy [kL][kP + 8];
// B and C [kL][N + 8]; the start state S and the carried dS', each as hi
// and lo [2][kP][N + 8]; W and M as hi and lo [2][kL][kL + 8]; then floats.
template <int kP>
struct Smem {
  static constexpr int sx = kP + 8;
  int sn, xs, dys, bs, cs, st, ds, w, m, f;
  __host__ __device__ explicit Smem(int N)
      : sn(N + 8), xs(0), dys(kL * sx), bs(2 * kL * sx), cs(bs + kL * sn),
        st(cs + kL * sn), ds(st + 2 * kP * sn), w(ds + 2 * kP * sn),
        m(w + 2 * kL * kSW), f(m + 2 * kL * kSW) {}
  // floats: dt, cum, eu, u, E [kL]; row sums of G [2][kL]; column sums
  // of G and of (C Bᵀ) ∘ (dy xᵀ) ∘ L [4][kL] each; x·(dS' B) [2][kL];
  // E dy·(S C) [2][kL]; <dS', S> per warp [8]; a_tot, decay; the flag
  static constexpr int kFloats = 5 * kL + 2 * kL + 8 * kL + 2 * kL + 2 * kL +
                                 kWarps + 4;
  __host__ __device__ int bytes() const { return 2 * f + kFloats * 4; }
};

// One block of eight warps per (head, batch row) walks the chunks in
// reverse (see the header).
template <int kP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const Params p) {
  constexpr int sx = kP + 8;
  constexpr int kPG = kP / 16;               // groups of 16 rows of P
  constexpr int kWPG = kWarps / kPG;         // warps per group, for dS
  constexpr int kPairs = 8 / kWPG;           // a warp's pairs of dS tiles
  constexpr int kYC = kP == 16 ? 16 : kP / 2;   // columns of dx per warp
  constexpr int kYT = kYC / 8;
  const Smem<kP> L(p.N);
  const int sn = L.sn, n16 = p.N / 16, p16 = p.P / 16;
  const int h = blockIdx.x, bi = blockIdx.y, rep = p.H / p.G, g = h / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, qc = lane & 3;
  const int rg = warp & 3, ph = warp >> 2, pc0 = ph * kYC;
  const bool y_warp = kP > 16 || ph == 0;
  const int pg = warp % kPG, wn = warp / kPG;
  const bool s_warp = 16 * pg < p.P;
  const int r0 = 16 * rg + gr, r1 = r0 + 8;   // this thread's rows

  extern __shared__ uint4 smem4[];
  uint16_t* const sm = reinterpret_cast<uint16_t*>(smem4);
  uint16_t* const xs = sm + L.xs;
  uint16_t* const dys = sm + L.dys;
  uint16_t* const bs = sm + L.bs;
  uint16_t* const cs = sm + L.cs;
  uint16_t* const st = sm + L.st;
  uint16_t* const ds = sm + L.ds;
  uint16_t* const wt = sm + L.w;
  uint16_t* const mt = sm + L.m;
  float* const f_dt = reinterpret_cast<float*>(sm + L.f);
  float* const f_cum = f_dt + kL;
  float* const f_eu = f_cum + kL;
  float* const f_u = f_eu + kL;
  float* const f_e = f_u + kL;
  float* const f_row = f_e + kL;           // [2][kL]
  float* const f_colg = f_row + 2 * kL;    // [4][kL]
  float* const f_cold = f_colg + 4 * kL;   // [4][kL]
  float* const f_xq = f_cold + 4 * kL;     // [2][kL]
  float* const f_ecs = f_xq + 2 * kL;      // [2][kL]
  float* const f_sdot = f_ecs + 2 * kL;    // [kWarps]
  float* const f_scal = f_sdot + kWarps;   // a_tot, decay
  int* const last_flag = reinterpret_cast<int*>(f_scal + 2);

  // everything starts at zero: the rows of S and dS' past P, and the
  // padding of every tile, are read as zeros
  for (int e = tid; e < L.bytes() / 16; e += kThreads)
    smem4[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const uint16_t* const xb = p.x + bi * p.sx_b + h * p.sx_h;
  const uint16_t* const dyb = p.dy + bi * p.sdy_b + h * p.sdy_h;
  const float* const dtb = p.dt + bi * p.sdt_b + h * p.sdt_h;
  const uint16_t* const bb = p.b + bi * p.sb_b + g * p.sb_g;
  const uint16_t* const cb = p.c + bi * p.sc_b + g * p.sc_g;
  const float a_h = p.A[h];
  const int nq = p.N / 8;   // 16-byte pieces of a row of N
  const size_t bh = (size_t)bi * p.H + h;
  const size_t part_rows = (size_t)p.nc * kL;

  // dS: this warp's part, rows 16 pg + gr (+ 8), columns 16 (wn + kWPG i)
  // + 8 t + 2 qc (+ 1), from d_final or zero; also to shared memory
  float s[kPairs][2][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][t][e] = 0.f;
  const int pr = 16 * pg + gr;
  if (p.dfinal != nullptr && s_warp) {
    const float* const in = p.dfinal + bh * p.P * p.N;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = wn + kWPG * i;
      if (pair >= n16) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = 16 * pair + 8 * t + 2 * qc;
          const float2 v = *reinterpret_cast<const float2*>(
              in + (size_t)(pr + 8 * r) * p.N + q);
          s[i][t][2 * r] = v.x;
          s[i][t][2 * r + 1] = v.y;
          const int off = (pr + 8 * r) * sn + q;
          split_bf16(v.x, v.y, *reinterpret_cast<uint32_t*>(ds + off),
                     *reinterpret_cast<uint32_t*>(ds + kP * sn + off));
        }
    }
  }
  float da_acc = 0.f;   // warp 0: this lane's share of dA

  for (int c = p.nc - 1; c >= 0; --c) {
    const int t0 = c * kL, len = min(kL, p.T - t0);
    __syncthreads();   // the chunk after this one is done everywhere
    // ---- load x, dy, B, C, dt and the start state ----
    for (int e = tid; e < kL * nq; e += kThreads) {
      const int j = e / nq, q = (e - j * nq) * 8;
      const bool ok = t0 + j < p.T;
      cp_async16(bs + j * sn + q, ok ? bb + (t0 + j) * p.sb_t + q : bb, ok);
      cp_async16(cs + j * sn + q, ok ? cb + (t0 + j) * p.sc_t + q : cb, ok);
    }
    for (int e = tid; e < kL * kP / 8; e += kThreads) {
      const int j = e / (kP / 8), q = (e % (kP / 8)) * 8;
      const bool ok = t0 + j < p.T && q < p.P;
      cp_async16(xs + j * sx + q, ok ? xb + (t0 + j) * p.sx_t + q : xb, ok);
      cp_async16(dys + j * sx + q, ok ? dyb + (t0 + j) * p.sdy_t + q : dyb,
                 ok);
    }
    if (tid < kL) {
      const bool ok = t0 + tid < p.T;
      cp_async4(f_dt + tid, ok ? dtb + (t0 + tid) * p.sdt_t : dtb, ok);
    }
    if (c > 0) {
      const uint16_t* const src =
          p.starts + (bh * (p.nc - 1) + c - 1) * 2 * p.P * p.N;
      for (int e = tid; e < 2 * p.P * nq; e += kThreads) {
        const int row = e / nq, q = (e - row * nq) * 8;   // row: part P + p
        const int part = row / p.P, pp = row - part * p.P;
        cp_async16(st + (part * kP + pp) * sn + q, src + (size_t)row * p.N + q,
                   true);
      }
    } else {
      for (int e = tid; e < p.P * p.N / 2; e += kThreads) {
        const int pp = e / (p.N / 2), q = (e - pp * (p.N / 2)) * 2;
        float2 v = make_float2(0.f, 0.f);
        if (p.init != nullptr)
          v = *reinterpret_cast<const float2*>(p.init + bh * p.P * p.N +
                                               (size_t)pp * p.N + q);
        split_bf16(v.x, v.y, *reinterpret_cast<uint32_t*>(st + pp * sn + q),
                   *reinterpret_cast<uint32_t*>(st + (kP + pp) * sn + q));
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- cum, e^{clip(a_tot - cum)}, u, E, decay (warp 0) ----
    if (warp == 0) {
      const float a0 = f_dt[2 * lane] * a_h, a1 = f_dt[2 * lane + 1] * a_h;
      float sum = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, sum, off);
        if (lane >= off) sum += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, sum, 1);
      if (lane == 0) excl = 0.f;
      const float a_tot = __shfl_sync(0xffffffffu, sum, 31);
      const float cm[2] = {excl + a0, sum};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * lane + i;
        f_cum[j] = cm[i];
        f_eu[j] = expf(fminf(fmaxf(a_tot - cm[i], -60.f), 0.f));
        f_u[j] = f_eu[j] * f_dt[j];
        f_e[j] = expf(fmaxf(cm[i], -60.f));
      }
      if (lane == 0) {
        f_scal[0] = a_tot;
        f_scal[1] = expf(fmaxf(a_tot, -60.f));
      }
    }

    // ---- C Bᵀ and dy xᵀ on this warp's 16 x 16 blocks (rows 16 rg,
    // columns 16 jb for jb = ph, ph + 2 up to the diagonal) ----
    float cbt[2][2][4], dxt[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) cbt[i][t][e] = dxt[i][t][e] = 0.f;
    for (int kk = 0; kk < n16; ++kk) {
      uint32_t a[4];
      lda_rm(a, cs, sn, 16 * rg, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jb = ph + 2 * i;
        if (jb > rg) break;
        uint32_t bq[4];
        ldb_nk(bq, bs, sn, 16 * jb, 16 * kk, lane);
        mma2(cbt[i], a, bq);
      }
    }
    for (int kk = 0; kk < p16; ++kk) {
      uint32_t a[4];
      lda_rm(a, dys, sx, 16 * rg, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jb = ph + 2 * i;
        if (jb > rg) break;
        uint32_t bq[4];
        ldb_nk(bq, xs, sx, 16 * jb, 16 * kk, lane);
        mma2(dxt[i], a, bq);
      }
    }
    __syncthreads();   // cum, u, E

    // ---- W, M (hi, lo) to shared memory; G's row and column sums ----
    {
      float row_g[2] = {0.f, 0.f};
      const float cr[2] = {f_cum[r0], f_cum[r1]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jb = ph + 2 * i;
        if (jb > rg) break;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float col_g[2] = {0.f, 0.f}, col_d[2] = {0.f, 0.f};
          const int s0 = 16 * jb + 8 * t + 2 * qc;
          float wv[4], mv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1, col = s0 + (e & 1);
            const float diff = cr[e >> 1] - f_cum[col];
            const bool on = col <= row;
            const float l = on ? expf(fminf(fmaxf(diff, -60.f), 0.f)) : 0.f;
            const float dtc = f_dt[col];
            const float cbdx = cbt[i][t][e] * dxt[i][t][e] * l;
            const float gv = on && diff >= -60.f ? cbdx * dtc : 0.f;
            wv[e] = cbt[i][t][e] * l * dtc;
            mv[e] = dxt[i][t][e] * l * dtc;
            row_g[e >> 1] += gv;
            col_g[e & 1] += gv;
            col_d[e & 1] += cbdx;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int off = (r ? r1 : r0) * kSW + s0;
            split_bf16(wv[2 * r], wv[2 * r + 1],
                       *reinterpret_cast<uint32_t*>(wt + off),
                       *reinterpret_cast<uint32_t*>(wt + kL * kSW + off));
            split_bf16(mv[2 * r], mv[2 * r + 1],
                       *reinterpret_cast<uint32_t*>(mt + off),
                       *reinterpret_cast<uint32_t*>(mt + kL * kSW + off));
          }
          // column sums over this warp's 16 rows: the lanes of one qc
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              col_g[e] += __shfl_xor_sync(0xffffffffu, col_g[e], o);
              col_d[e] += __shfl_xor_sync(0xffffffffu, col_d[e], o);
            }
          }
          if (gr == 0) {
            f_colg[rg * kL + s0] = col_g[0];
            f_colg[rg * kL + s0 + 1] = col_g[1];
            f_cold[rg * kL + s0] = col_d[0];
            f_cold[rg * kL + s0 + 1] = col_d[1];
          }
        }
      }
      // row sums over this warp's columns: the four lanes of a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_g[r] += __shfl_xor_sync(0xffffffffu, row_g[r], 1);
        row_g[r] += __shfl_xor_sync(0xffffffffu, row_g[r], 2);
      }
      if (qc == 0) {
        f_row[ph * kL + r0] = row_g[0];
        f_row[ph * kL + r1] = row_g[1];
      }
    }
    __syncthreads();   // W and M

    const float u0 = f_u[r0], u1 = f_u[r1];
    // ---- dx rows 16 rg, columns pc0..: u ∘ (B dS'ᵀ) + Wᵀ dy ----
    if (y_warp) {
      float acc[kYT / 2][2][4];
#pragma unroll
      for (int np = 0; np < kYT / 2; ++np)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[np][t][e] = 0.f;
      for (int kk = 0; kk < n16; ++kk) {
        uint32_t a[4];
        lda_rm(a, bs, sn, 16 * rg, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < kYT / 2; ++np)
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            uint32_t bq[4];
            ldb_nk(bq, ds + part * kP * sn, sn, pc0 + 16 * np, 16 * kk, lane);
            mma2(acc[np], a, bq);
          }
      }
      // x·(dS' B) for rows r0, r1 over this warp's columns
      float xq[2] = {0.f, 0.f};
#pragma unroll
      for (int np = 0; np < kYT / 2; ++np)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int q = pc0 + 16 * np + 8 * t + 2 * qc;
          const float2 x0 = bf16x2(xs + r0 * sx + q);
          const float2 x1 = bf16x2(xs + r1 * sx + q);
          xq[0] += acc[np][t][0] * x0.x + acc[np][t][1] * x0.y;
          xq[1] += acc[np][t][2] * x1.x + acc[np][t][3] * x1.y;
          acc[np][t][0] *= u0; acc[np][t][1] *= u0;
          acc[np][t][2] *= u1; acc[np][t][3] *= u1;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xq[r] += __shfl_xor_sync(0xffffffffu, xq[r], 1);
        xq[r] += __shfl_xor_sync(0xffffffffu, xq[r], 2);
      }
      if (qc == 0) {
        f_xq[ph * kL + r0] = xq[0];
        f_xq[ph * kL + r1] = xq[1];
      }
      for (int kk = rg; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        lda_tr(ah, wt, kSW, 16 * rg, 16 * kk, lane);
        lda_tr(al, wt + kL * kSW, kSW, 16 * rg, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < kYT / 2; ++np) {
          uint32_t bq[4];
          ldb_kn(bq, dys, sx, pc0 + 16 * np, 16 * kk, lane);
          mma2(acc[np], ah, bq);
          mma2(acc[np], al, bq);
        }
      }
#pragma unroll
      for (int np = 0; np < kYT / 2; ++np)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int q = pc0 + 16 * np + 8 * t + 2 * qc;
          if (q >= p.P) continue;
          if (r0 < len)
            *reinterpret_cast<uint32_t*>(
                p.dx + (((size_t)bi * p.T + t0 + r0) * p.H + h) * p.P + q) =
                pack_bf16(acc[np][t][0], acc[np][t][1]);
          if (r1 < len)
            *reinterpret_cast<uint32_t*>(
                p.dx + (((size_t)bi * p.T + t0 + r1) * p.H + h) * p.P + q) =
                pack_bf16(acc[np][t][2], acc[np][t][3]);
        }
    }

    // ---- dC rows 16 rg, column blocks ph, ph + 2, ...:
    // E ∘ (dy S) + M B, and dB rows 16 rg: u ∘ (x dS') + Mᵀ C ----
    {
      float acc[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
      for (int kk = 0; kk < p16; ++kk) {
        uint32_t a[4];
        lda_rm(a, dys, sx, 16 * rg, 16 * kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nb = ph + 2 * i;
          if (nb >= n16) break;
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            uint32_t bq[4];
            ldb_kn(bq, st + part * kP * sn, sn, 16 * nb, 16 * kk, lane);
            mma2(acc[i], a, bq);
          }
        }
      }
      const float e0 = f_e[r0], e1 = f_e[r1];
      float ecs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nb = ph + 2 * i;
        if (nb >= n16) break;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int q = 16 * nb + 8 * t + 2 * qc;
          acc[i][t][0] *= e0; acc[i][t][1] *= e0;
          acc[i][t][2] *= e1; acc[i][t][3] *= e1;
          const float2 c0 = bf16x2(cs + r0 * sn + q);
          const float2 c1 = bf16x2(cs + r1 * sn + q);
          ecs[0] += acc[i][t][0] * c0.x + acc[i][t][1] * c0.y;
          ecs[1] += acc[i][t][2] * c1.x + acc[i][t][3] * c1.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ecs[r] += __shfl_xor_sync(0xffffffffu, ecs[r], 1);
        ecs[r] += __shfl_xor_sync(0xffffffffu, ecs[r], 2);
      }
      if (qc == 0) {
        f_ecs[ph * kL + r0] = ecs[0];
        f_ecs[ph * kL + r1] = ecs[1];
      }
      for (int kk = 0; kk <= rg; ++kk) {
        uint32_t ah[4], al[4];
        lda_rm(ah, mt, kSW, 16 * rg, 16 * kk, lane);
        lda_rm(al, mt + kL * kSW, kSW, 16 * rg, 16 * kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nb = ph + 2 * i;
          if (nb >= n16) break;
          uint32_t bq[4];
          ldb_kn(bq, bs, sn, 16 * nb, 16 * kk, lane);
          mma2(acc[i], ah, bq);
          mma2(acc[i], al, bq);
        }
      }
      float* const out_c = p.part_c + (bh * part_rows + t0) * p.N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nb = ph + 2 * i;
        if (nb >= n16) break;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int q = 16 * nb + 8 * t + 2 * qc;
          *reinterpret_cast<float2*>(out_c + (size_t)r0 * p.N + q) =
              make_float2(acc[i][t][0], acc[i][t][1]);
          *reinterpret_cast<float2*>(out_c + (size_t)r1 * p.N + q) =
              make_float2(acc[i][t][2], acc[i][t][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
        }
      }
      // dB
      for (int kk = 0; kk < p16; ++kk) {
        uint32_t a[4];
        lda_rm(a, xs, sx, 16 * rg, 16 * kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nb = ph + 2 * i;
          if (nb >= n16) break;
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            uint32_t bq[4];
            ldb_kn(bq, ds + part * kP * sn, sn, 16 * nb, 16 * kk, lane);
            mma2(acc[i], a, bq);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          acc[i][t][0] *= u0; acc[i][t][1] *= u0;
          acc[i][t][2] *= u1; acc[i][t][3] *= u1;
        }
      for (int kk = rg; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        lda_tr(ah, mt, kSW, 16 * rg, 16 * kk, lane);
        lda_tr(al, mt + kL * kSW, kSW, 16 * rg, 16 * kk, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nb = ph + 2 * i;
          if (nb >= n16) break;
          uint32_t bq[4];
          ldb_kn(bq, cs, sn, 16 * nb, 16 * kk, lane);
          mma2(acc[i], ah, bq);
          mma2(acc[i], al, bq);
        }
      }
      float* const out_b = p.part_b + (bh * part_rows + t0) * p.N;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nb = ph + 2 * i;
        if (nb >= n16) break;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int q = 16 * nb + 8 * t + 2 * qc;
          *reinterpret_cast<float2*>(out_b + (size_t)r0 * p.N + q) =
              make_float2(acc[i][t][0], acc[i][t][1]);
          *reinterpret_cast<float2*>(out_b + (size_t)r1 * p.N + q) =
              make_float2(acc[i][t][2], acc[i][t][3]);
        }
      }
    }

    // ---- <dS', S> over this warp's part of dS' ----
    {
      float sd = 0.f;
      if (s_warp) {
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int pair = wn + kWPG * i;
          if (pair >= n16) break;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int off = (pr + 8 * r) * sn + 16 * pair + 8 * t + 2 * qc;
              const float2 hi = bf16x2(st + off), lo = bf16x2(st + kP * sn + off);
              sd += s[i][t][2 * r] * (hi.x + lo.x) +
                    s[i][t][2 * r + 1] * (hi.y + lo.y);
            }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sd += __shfl_xor_sync(0xffffffffu, sd, o);
      if (lane == 0) f_sdot[warp] = sd;
    }
    // the partials of dB and dC are visible before this block counts
    __threadfence();
    __syncthreads();
    if (tid == 0)
      *last_flag = atomicAdd(p.count + ((size_t)bi * p.G + g) * p.nc + c, 1) ==
                   rep - 1;

    // ---- dS <- e^{max(a_tot, -60)} dS + (E ∘ dy)ᵀ C, to shared memory ----
    if (s_warp) {
      const float d = f_scal[1];
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][t][e] *= d;
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t ya[4], ah[4], al[4];
        lda_tr(ya, dys, sx, 16 * pg, 16 * kk, lane);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 16 * kk + 2 * qc + 8 * (r >> 1);
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ya[r]));
          split_bf16(v.x * f_e[j], v.y * f_e[j + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int pair = wn + kWPG * i;
          if (pair >= n16) break;
          uint32_t bq[4];
          ldb_kn(bq, cs, sn, 16 * pair, 16 * kk, lane);
          mma2(s[i], ah, bq);
          mma2(s[i], al, bq);
        }
      }
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int pair = wn + kWPG * i;
        if (pair >= n16) break;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int off = (pr + 8 * r) * sn + 16 * pair + 8 * t + 2 * qc;
            split_bf16(s[i][t][2 * r], s[i][t][2 * r + 1],
                       *reinterpret_cast<uint32_t*>(ds + off),
                       *reinterpret_cast<uint32_t*>(ds + kP * sn + off));
          }
      }
    }

    // ---- dcum, da (a reverse scan), ddt and dA's share (warp 0) ----
    if (warp == 0) {
      const float a_tot = f_scal[0], decay = f_scal[1];
      float dcum[2], ddt[2], vsum = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * lane + i;
        float colg = 0.f, cold = 0.f;
        for (int r = j / 16; r < 4; ++r) {
          colg += f_colg[r * kL + j];
          cold += f_cold[r * kL + j];
        }
        const float xq = f_xq[j] + (kP > 16 ? f_xq[kL + j] : 0.f);
        const float cj = f_cum[j];
        const float v = a_tot - cj >= -60.f ? f_u[j] * xq : 0.f;
        dcum[i] = f_row[j] + f_row[kL + j] - colg - v +
                  (cj >= -60.f ? f_ecs[j] + f_ecs[kL + j] : 0.f);
        ddt[i] = cold + f_eu[j] * xq;
        vsum += v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) vsum += __shfl_xor_sync(0xffffffffu, vsum, o);
      if (lane == 31) {
        float sd = 0.f;
        for (int w = 0; w < kWarps; ++w) sd += f_sdot[w];
        dcum[1] += vsum + (a_tot >= -60.f ? decay * sd : 0.f);
      }
      // da_r = Σ_{t >= r} dcum_t: a suffix scan over the lanes' pairs
      float sum = dcum[0] + dcum[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, sum, off);
        if (lane + off < 32) sum += o;
      }
      float excl = __shfl_down_sync(0xffffffffu, sum, 1);
      if (lane == 31) excl = 0.f;
      const float da1 = dcum[1] + excl, da0 = dcum[0] + da1;
      const float das[2] = {da0, da1};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * lane + i;
        if (t0 + j < p.T)
          p.ddt[((size_t)bi * p.T + t0 + j) * p.H + h] = ddt[i] + a_h * das[i];
        da_acc += f_dt[j] * das[i];
      }
    }
    __syncthreads();   // the flag; dS' for the next chunk

    // ---- the group's last head merges dB and dC of this chunk ----
    if (*last_flag) {
      __threadfence();
      const int n2 = p.N / 2;
      for (int e = tid; e < len * n2; e += kThreads) {
        const int j = e / n2, q = (e - j * n2) * 2;
        float2 vb = make_float2(0.f, 0.f), vc = make_float2(0.f, 0.f);
        for (int hh = g * rep; hh < (g + 1) * rep; ++hh) {
          const size_t off = (((size_t)bi * p.H + hh) * part_rows + t0 + j) * p.N + q;
          const float2 b2 = __ldcg(reinterpret_cast<const float2*>(p.part_b + off));
          const float2 c2 = __ldcg(reinterpret_cast<const float2*>(p.part_c + off));
          vb.x += b2.x; vb.y += b2.y;
          vc.x += c2.x; vc.y += c2.y;
        }
        const size_t o = (((size_t)bi * p.T + t0 + j) * p.G + g) * p.N + q;
        *reinterpret_cast<uint32_t*>(p.db + o) = pack_bf16(vb.x, vb.y);
        *reinterpret_cast<uint32_t*>(p.dc + o) = pack_bf16(vc.x, vc.y);
      }
    }
  }

  // ---- d_initial, the gradient of the first chunk's start state ----
  if (s_warp) {
    float* const out = p.dinit + bh * p.P * p.N;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = wn + kWPG * i;
      if (pair >= n16) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(
              out + (size_t)(pr + 8 * r) * p.N + 16 * pair + 8 * t + 2 * qc) =
              make_float2(s[i][t][2 * r], s[i][t][2 * r + 1]);
    }
  }
  // ---- dA: this block's share, then the head's last batch row sums them
  // in ascending order ----
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da_acc += __shfl_xor_sync(0xffffffffu, da_acc, o);
    if (lane == 0) {
      p.part_a[bh] = da_acc;
      __threadfence();
      int* const cnt_h = p.count + (size_t)p.batch * p.G * p.nc + h;
      if (atomicAdd(cnt_h, 1) == p.batch - 1) {
        __threadfence();
        float v = 0.f;
        for (int b2 = 0; b2 < p.batch; ++b2)
          v += __ldcg(p.part_a + (size_t)b2 * p.H + h);
        p.dA[h] = v;
      }
    }
  }
}

template <int kP>
int smem_bytes(int N) { return Smem<kP>(N).bytes(); }

int smem_for(int P, int N) {
  if (P <= 16) return smem_bytes<16>(N);
  if (P <= 32) return smem_bytes<32>(N);
  if (P <= 64) return smem_bytes<64>(N);
  return smem_bytes<128>(N);
}

template <int kP>
int launch(const Params& p, cudaStream_t stream) {
  const int bytes = Smem<kP>(p.N).bytes();
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<kP><<<dim3(p.H, p.batch), kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of the instantiation for (P, N), in bytes.
extern "C" int ssd_bwd_smem(int P, int N) { return smem_for(P, N); }

// x and dy (B,T,H,P), B and C (B,T,G,N) bf16 with their last axis
// contiguous and rows 16-byte aligned; dt (B,T,H) and A (H,) fp32; starts
// K4's chunk_state (B,H,ceil(T/64) - 1,2,P,N) bf16 contiguous; init and
// dfinal null or fp32 (B,H,P,N) contiguous. Outputs, contiguous: dx
// (B,T,H,P) bf16, ddt (B,T,H) fp32, dA (H,) fp32, db and dc (B,T,G,N)
// bf16, dinit (B,H,P,N) fp32. Workspace: part_b and part_c fp32
// (B,H,ceil(T/64) * 64,N), part_a fp32 (B,H), count int32 B G ceil(T/64) +
// H, zeroed. Launches on `stream` and returns a CUDA error code (0:
// launched).
extern "C" int ssd_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* b,
    const void* c, const void* dy, const void* starts, const void* init,
    const void* dfinal, void* dx, void* ddt, void* dA, void* db, void* dc,
    void* dinit, void* part_b, void* part_c, void* part_a, void* count,
    int batch, int T, int H, int G, int P, int N, long long sx_b,
    long long sx_t, long long sx_h, long long sdt_b, long long sdt_t,
    long long sdt_h, long long sb_b, long long sb_t, long long sb_g,
    long long sc_b, long long sc_t, long long sc_g, long long sdy_b,
    long long sdy_t, long long sdy_h, void* stream) {
  if (batch <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || P % 16 != 0 || P > 128 || N % 16 != 0 || N > 128 ||
      batch > 65535 || smem_for(P, N) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.b = static_cast<const uint16_t*>(b);
  p.c = static_cast<const uint16_t*>(c);
  p.dy = static_cast<const uint16_t*>(dy);
  p.starts = static_cast<const uint16_t*>(starts);
  p.init = static_cast<const float*>(init);
  p.dfinal = static_cast<const float*>(dfinal);
  p.dx = static_cast<uint16_t*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.db = static_cast<uint16_t*>(db);
  p.dc = static_cast<uint16_t*>(dc);
  p.dinit = static_cast<float*>(dinit);
  p.part_b = static_cast<float*>(part_b);
  p.part_c = static_cast<float*>(part_c);
  p.part_a = static_cast<float*>(part_a);
  p.count = static_cast<int*>(count);
  p.sx_b = sx_b; p.sx_t = sx_t; p.sx_h = sx_h;
  p.sdt_b = sdt_b; p.sdt_t = sdt_t; p.sdt_h = sdt_h;
  p.sb_b = sb_b; p.sb_t = sb_t; p.sb_g = sb_g;
  p.sc_b = sc_b; p.sc_t = sc_t; p.sc_g = sc_g;
  p.sdy_b = sdy_b; p.sdy_t = sdy_t; p.sdy_h = sdy_h;
  p.batch = batch; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N;
  p.nc = (T + kL - 1) / kL;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 16) return launch<16>(p, st);
  if (P <= 32) return launch<32>(p, st);
  if (P <= 64) return launch<64>(p, st);
  return launch<128>(p, st);
}
