// K4 — Mamba2 SSD forward (the chunked scan) for Hopper (sm_90a): chunks
// walked by blocks in flight together, every product on the tensor cores.
//
// Replaces the TPU kernel `ssd_chunked` in src/repro/kernels/ssd.py
// (pl.pallas_call at :114, body `_ssd_kernel` at :31).
//
// What it computes, for x (B,T,H,P) bf16, dt (B,T,H) fp32 (> 0), A (H,) fp32
// (< 0), B/C (B,T,G,N) bf16 read at group h / (H / G), from a zero state or
// from a given fp32 initial state (B,H,P,N):
// per chunk of kL = 64 steps, with a = dt·A and cum its in-chunk prefix sum,
//   y     = ((C Bᵀ) ∘ L ∘ dt) x + e^{max(cum, -60)} ∘ (C stateᵀ)
//           L[i][j] = e^{clip(cum_i - cum_j, -60, 0)} for j <= i, else 0
//   state = e^{max(a_tot, -60)} state + xᵀ (B ∘ e^{clip(a_tot - cum, -60, 0)} dt)
// y (B,T,H,P) in bf16, the final state (B,H,P,N) in fp32. The clips are the
// reference's (`ssd.py:63, :74, :80, :85`); the chunking is exact algebra,
// so only rounding (and where the -60 clips bite, far under the tolerance)
// differs from its 128-step chunks. Any T works: x, dt, B and C are
// zero-filled past T in the last chunk, so its padded steps add no decay
// (a = 0) and nothing to the state (dt = 0), and y is stored only below T.
// x, dt, B and C are read in place through their batch, time and head
// (group) strides, so the slices of the conv output that `mamba_fwd` passes
// need no copy.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), at the
// mamba2-130m serve shape (B 8, T 2048, H 24, P 64, N 128, G 1): about
// 23 GFLOP at 64-step chunks (0.023 ms) against 117 MB of x, y, B, C, dt
// and the final state, each moved once (0.035 ms): bound by bytes.
//
// Design. The TPU grid carries the (P, N) state in VMEM across its
// sequential chunk axis. Here one block of eight warps per (head, batch
// row) walks its chunks in order and carries the state in fp32 registers
// (a warp holds 16 rows of P by a share of N), so nothing but x, B, C, dt,
// y and the final state crosses device memory: no chunk states are stored
// on the way. The blocks of all heads and batch rows run together: at the
// serve shape 192 blocks, two per SM (104 KB of shared memory and at most
// 128 registers a thread at P <= 64), so that one block's loads and
// barriers hide behind the other's products. The chunks of a block run in
// series, not in parallel: a chunk-parallel form (every chunk's state
// first, then the pass over chunks, then y) ran slower on the H100, its
// chunk states, split as below, costing more than the series loses. A
// chunk's C, x and dt load by cp.async while the chunk before is
// computed, its B as soon as the chunk before has used its own. Per
// chunk, on mma.sync (m16n8k16, bf16 operands, fp32 accumulators) from
// ldmatrix reads of padded rows in shared memory:
//  - one warp scans cum with shuffles, and u = e^{clip(a_tot - cum, -60,
//    0)} dt;
//  - each warp adds y = e^{max(cum, -60)} ∘ (C Sᵀ) for its 16 steps and
//    half of P, computes C Bᵀ for its steps up to the diagonal, builds
//    W = (C Bᵀ) ∘ L ∘ dt in registers and feeds it to mma as the A operand
//    without a trip through shared memory, and adds W x, skipping the
//    k-steps above the diagonal (L = 0);
//  - then S <- e^{max(a_tot, -60)} S + (x ∘ u)ᵀ B in registers, x ∘ u
//    formed from xᵀ's fragments in registers, and S goes to shared memory
//    for the next chunk's C Sᵀ.
// C Bᵀ does not depend on the head but is recomputed per head (1 MFLOP a
// chunk, against about 3 MFLOP of the rest): sharing it across the heads
// of a group would mean either storing each chunk's start state or walking
// all heads in one block, and both cost more than the products.
// Precision: C Bᵀ has two bf16 operands, as the inputs are; the three
// products with an fp32 operand (W, x ∘ u, and the carried state in C Sᵀ)
// take it split into two bf16 parts, hi = bf16(v) and lo = bf16(v - hi),
// one mma each: about 16 bits of mantissa.
// Rounded to bf16 alone, they failed the elementwise tolerance where y
// cancels (errors near 0.1 where |y| is small); TF32 would keep 11 bits.
// Every sum is fp32, nothing is added by atomics and every sum has a fixed
// order, so K4 is repeatable bit for bit.
// With a chunk_state buffer the block also writes the state at each
// chunk's start after the first (as bf16 hi and lo), so that a check can
// hold the state's recurrence apart from y, and so that the backward
// (ssd_bwd.cu) can read them; the serving path passes none. With an initial
// state the registers start from it in place of zeros, and the first chunk
// adds its C Sᵀ term as every later one does.
// Rows are read by 16-byte cp.async: x, B and C need 16-byte aligned
// pointers and batch, time and head (group) strides (the wrapper checks),
// P a multiple of 16 up to 128, N a multiple of 16 up to 128 (the
// launcher checks).
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

struct Params {
  const uint16_t* x;
  const float* dt;
  const float* A;
  const uint16_t* b;
  const uint16_t* c;
  uint16_t* y;
  float* state;                 // (B, H, P, N) fp32
  uint16_t* chunk_state;        // (B, H, chunks - 1, 2, P, N) bf16 hi, lo, or null
  const float* init;            // (B, H, P, N) fp32 initial state, or null
  long long sx_b, sx_t, sx_h;   // element strides
  long long sdt_b, sdt_t, sdt_h;
  long long sb_b, sb_t, sb_g;
  long long sc_b, sc_t, sc_g;
  int T, H, G, P, N, nc;
};

// 4 bytes global -> shared; zero when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 4 : 0));
}

// Two floats as bf16 pairs hi and lo with hi + lo within 2^-16 of them
// (relative): the fp32 operand of a product, fed to mma as two bf16 ones.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// One warp: cum = cumsum(dt·A) over a chunk's 64 steps, steps 2l and
// 2l + 1 on lane l, into cum[]; returns a_tot on every lane.
__device__ __forceinline__ float chunk_cumsum(const float* dts, float a_h,
                                              float* cum, int lane) {
  const float a0 = dts[2 * lane] * a_h, a1 = dts[2 * lane + 1] * a_h;
  float s = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  cum[2 * lane] = excl + a0;
  cum[2 * lane + 1] = s;
  return __shfl_sync(0xffffffffu, s, 31);
}

// Shared memory, in bf16 elements from the start: two stages of the C tile
// [kL][N + 8], the x tile [kL][kP + 8] and dt (kL floats); one B tile
// [kL][N + 8]; the state at the chunk's start as hi and lo tiles
// [2][kP][N + 8]; then floats cum, u, e^{max(cum, -60)} [kL] and the
// chunk's decay. At P 64, N 128: 104.3 KB, two blocks per SM.
template <int kP>
struct Smem {
  static constexpr int sx = kP + 8;
  int sn, stage, bt, s, f;
  __host__ __device__ explicit Smem(int N)
      : sn(N + 8), stage(kL * sn + kL * sx + 2 * kL), bt(2 * stage),
        s(bt + kL * sn), f(s + 2 * kP * sn) {}
  __host__ __device__ int c(int st) const { return st * stage; }
  __host__ __device__ int x(int st) const { return st * stage + kL * sn; }
  __host__ __device__ int dt(int st) const {
    return st * stage + kL * sn + kL * sx;
  }
  __host__ __device__ int bytes() const { return 2 * f + (3 * kL + 4) * 4; }
};

// One block of eight warps per (head, batch row) walks the chunks in order.
// Per chunk: warp 0 scans cum; warps (rg, ph) take rows 16 rg of the chunk
// and half ph of P for y (with kP 16, only ph 0): C Sᵀ, then C Bᵀ for their
// rows and W x; then warps (pg, wn) take rows 16 pg of the state and pairs
// of its 8-column tiles wn, wn + kWPG, ... for the update
// S <- e^{max(a_tot, -60)} S + (x ∘ u)ᵀ B, x ∘ u formed in registers, and
// write the new state to shared memory for the next chunk's y. The next
// chunk's C, x and dt load during the chunk, its B once this one's update
// has read B.
template <int kP>
__global__ void __launch_bounds__(kThreads, kP <= 64 ? 2 : 1)
ssd_fwd_kernel(const Params p) {
  constexpr int sx = kP + 8;
  constexpr int kPG = kP / 16;               // groups of 16 rows of P
  constexpr int kWPG = kWarps / kPG;         // warps per group, for S
  constexpr int kPairs = 8 / kWPG;           // a warp's pairs of S tiles (N <= 128)
  constexpr int kYC = kP == 16 ? 16 : kP / 2;   // columns of y per warp
  constexpr int kYT = kYC / 8;
  const Smem<kP> L(p.N);
  const int sn = L.sn, n16 = p.N / 16;
  const int h = blockIdx.x, bi = blockIdx.y, g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, qc = lane & 3;
  const int rg = warp & 3, ph = warp >> 2, pc0 = ph * kYC;
  const bool y_warp = kP > 16 || ph == 0;
  const int pg = warp % kPG, wn = warp / kPG;
  const bool s_warp = 16 * pg < p.P;

  extern __shared__ uint4 smem4[];
  uint16_t* const sm = reinterpret_cast<uint16_t*>(smem4);
  float* const cum = reinterpret_cast<float*>(sm + L.f);
  float* const u = cum + kL;
  float* const ecum = u + kL;
  float* const decay = ecum + kL;

  const uint16_t* const xb = p.x + bi * p.sx_b + h * p.sx_h;
  const float* const dtb = p.dt + bi * p.sdt_b + h * p.sdt_h;
  const uint16_t* const bb = p.b + bi * p.sb_b + g * p.sb_g;
  const uint16_t* const cb = p.c + bi * p.sc_b + g * p.sc_g;
  const float a_h = p.A[h];
  const int nq = p.N / 8;   // 16-byte pieces of a row of N

  auto load_b = [&](int c) {   // B of chunk c; committed with the next load
    const int t0 = c * kL;
    for (int e = tid; e < kL * nq; e += kThreads) {
      const int j = e / nq, q = (e - j * nq) * 8;
      const bool ok = t0 + j < p.T;
      cp_async16(sm + L.bt + j * sn + q, ok ? bb + (t0 + j) * p.sb_t + q : bb,
                 ok);
    }
  };
  auto load = [&](int c, int st) {   // C, x and dt of chunk c
    const int t0 = c * kL;
    uint16_t* const cs = sm + L.c(st);
    uint16_t* const xs = sm + L.x(st);
    for (int e = tid; e < kL * nq; e += kThreads) {
      const int j = e / nq, q = (e - j * nq) * 8;
      const bool ok = t0 + j < p.T;
      cp_async16(cs + j * sn + q, ok ? cb + (t0 + j) * p.sc_t + q : cb, ok);
    }
    for (int e = tid; e < kL * kP / 8; e += kThreads) {
      const int j = e / (kP / 8), q = (e % (kP / 8)) * 8;
      const bool ok = t0 + j < p.T && q < p.P;
      cp_async16(xs + j * sx + q, ok ? xb + (t0 + j) * p.sx_t + q : xb, ok);
    }
    if (tid < kL) {
      const bool ok = t0 + tid < p.T;
      cp_async4(reinterpret_cast<float*>(sm + L.dt(st)) + tid,
                ok ? dtb + (t0 + tid) * p.sdt_t : dtb, ok);
    }
    cp_async_commit();
  };

  // this warp's part of the state: rows 16 pg + gr (+ 8), columns
  // 16 (wn + kWPG i) + 8 t + 2 qc (+ 1); zero, or the initial state, which
  // also goes to shared memory (hi and lo) for the first chunk's C Sᵀ
  float s[kPairs][2][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][t][e] = 0.f;
  if (p.init != nullptr && s_warp) {
    const float* const in = p.init + ((size_t)bi * p.H + h) * p.P * p.N;
    const int pr = 16 * pg + gr;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = wn + kWPG * i;
      if (pair >= n16) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = 16 * pair + 8 * t + 2 * qc;
          const float2 v = pr + 8 * r < p.P
              ? *reinterpret_cast<const float2*>(in + (size_t)(pr + 8 * r) * p.N + q)
              : make_float2(0.f, 0.f);
          s[i][t][2 * r] = v.x;
          s[i][t][2 * r + 1] = v.y;
          const int off = (pr + 8 * r) * sn + q;
          split_bf16(v.x, v.y, *reinterpret_cast<uint32_t*>(sm + L.s + off),
                     *reinterpret_cast<uint32_t*>(sm + L.s + kP * sn + off));
        }
    }
  }
  const int r0 = 16 * rg + gr, r1 = r0 + 8;   // this thread's rows of y

  load_b(0);
  load(0, 0);
  for (int c = 0; c < p.nc; ++c) {
    const int st = c & 1, t0 = c * kL, len = min(kL, p.T - t0);
    cp_async_wait<0>();
    __syncthreads();   // chunk c has landed; chunk c - 1 is done everywhere
    if (c + 1 < p.nc) load(c + 1, st ^ 1);
    const uint16_t* const cs = sm + L.c(st);
    const uint16_t* const bs = sm + L.bt;
    const uint16_t* const xs = sm + L.x(st);
    const float* const dts = reinterpret_cast<const float*>(sm + L.dt(st));
    if (warp == 0) {
      const float a_tot = chunk_cumsum(dts, a_h, cum, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * lane + i;
        u[j] = expf(fminf(fmaxf(a_tot - cum[j], -60.f), 0.f)) * dts[j];
        ecum[j] = expf(fmaxf(cum[j], -60.f));
      }
      if (lane == 0) *decay = expf(fmaxf(a_tot, -60.f));
    }
    __syncthreads();   // cum, u, ecum, decay
    if (y_warp) {
      float acc[kYT][4];
#pragma unroll
      for (int nt = 0; nt < kYT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      if (c > 0 || p.init != nullptr) {
        // e^{max(cum, -60)} ∘ (C Sᵀ): the start state's hi, then lo rows
        for (int kk = 0; kk < n16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, cs + (16 * rg + ((lane >> 3) & 1) * 8 + (lane & 7)) * sn
                         + 16 * kk + (lane >> 4) * 8);
#pragma unroll
          for (int part = 0; part < 2; ++part) {
#pragma unroll
            for (int np = 0; np < kYT / 2; ++np) {
              uint32_t bq[4];
              ldsm_x4(bq, sm + L.s + (part * kP + pc0 + 16 * np + (lane >> 4) * 8
                                      + (lane & 7)) * sn
                              + 16 * kk + ((lane >> 3) & 1) * 8);
              mma_bf16(acc[2 * np], a, bq[0], bq[1]);
              mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
            }
          }
        }
        const float e0 = ecum[r0], e1 = ecum[r1];
#pragma unroll
        for (int nt = 0; nt < kYT; ++nt) {
          acc[nt][0] *= e0; acc[nt][1] *= e0;
          acc[nt][2] *= e1; acc[nt][3] *= e1;
        }
      }
      // C Bᵀ for rows 16 rg, columns up to the diagonal (n-tiles <= 2 rg + 1)
      float cbt[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cbt[nt][e] = 0.f;
      for (int kk = 0; kk < n16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, cs + (16 * rg + ((lane >> 3) & 1) * 8 + (lane & 7)) * sn
                       + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (jp > rg) break;
          uint32_t bq[4];
          ldsm_x4(bq, bs + (16 * jp + (lane >> 4) * 8 + (lane & 7)) * sn
                          + 16 * kk + ((lane >> 3) & 1) * 8);
          mma_bf16(cbt[2 * jp], a, bq[0], bq[1]);
          mma_bf16(cbt[2 * jp + 1], a, bq[2], bq[3]);
        }
      }
      // + W x over the steps j <= these rows, W = (C Bᵀ) ∘ L ∘ dt as hi, lo
      const float cum0 = cum[r0], cum1 = cum[r1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > rg) break;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kk + half, j = 8 * nt + 2 * qc;
          const float cj0 = cum[j], cj1 = cum[j + 1];
          const float d0 = dts[j], d1 = dts[j + 1];
          auto w = [](float cbv, float ci, float cj, float dj, bool on) {
            return on ? cbv * expf(fminf(fmaxf(ci - cj, -60.f), 0.f)) * dj
                      : 0.f;
          };
          split_bf16(w(cbt[nt][0], cum0, cj0, d0, j <= r0),
                     w(cbt[nt][1], cum0, cj1, d1, j + 1 <= r0),
                     ah[2 * half], al[2 * half]);
          split_bf16(w(cbt[nt][2], cum1, cj0, d0, j <= r1),
                     w(cbt[nt][3], cum1, cj1, d1, j + 1 <= r1),
                     ah[2 * half + 1], al[2 * half + 1]);
        }
#pragma unroll
        for (int np = 0; np < kYT / 2; ++np) {
          uint32_t bq[4];
          ldsm_x4_trans(bq, xs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * sx
                               + pc0 + 16 * np + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], ah, bq[0], bq[1]);
          mma_bf16(acc[2 * np + 1], ah, bq[2], bq[3]);
          mma_bf16(acc[2 * np], al, bq[0], bq[1]);
          mma_bf16(acc[2 * np + 1], al, bq[2], bq[3]);
        }
      }
      // y rows t0 + r0 and t0 + r1, below T
#pragma unroll
      for (int nt = 0; nt < kYT; ++nt) {
        const int q = pc0 + 8 * nt + 2 * qc;
        if (q >= p.P) continue;
        if (r0 < len)
          *reinterpret_cast<uint32_t*>(
              p.y + (((size_t)bi * p.T + t0 + r0) * p.H + h) * p.P + q) =
              pack_bf16(acc[nt][0], acc[nt][1]);
        if (r1 < len)
          *reinterpret_cast<uint32_t*>(
              p.y + (((size_t)bi * p.T + t0 + r1) * p.H + h) * p.P + q) =
              pack_bf16(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();   // the start state has been read
    if (s_warp) {
      const int pr = 16 * pg + gr;
      if (p.chunk_state != nullptr && c > 0) {   // the start state, hi and lo
        uint16_t* const out = p.chunk_state +
            (((size_t)bi * p.H + h) * (p.nc - 1) + c - 1) * 2 * p.P * p.N;
        const size_t lo = (size_t)p.P * p.N;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int pair = wn + kWPG * i;
          if (pair >= n16) break;
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              uint16_t* const o =
                  out + (size_t)(pr + 8 * r) * p.N + 16 * pair + 8 * t + 2 * qc;
              split_bf16(s[i][t][2 * r], s[i][t][2 * r + 1],
                         *reinterpret_cast<uint32_t*>(o),
                         *reinterpret_cast<uint32_t*>(o + lo));
            }
        }
      }
      const float d = *decay;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][t][e] *= d;
      // S += (x ∘ u)ᵀ B: A = xᵀ read transposed, times u of its steps
      // (2 qc, + 1, + 8, + 9 of the k-step) in registers, as hi and lo
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        uint32_t xa[4];
        ldsm_x4_trans(xa, xs + (16 * kk + ((lane >> 4) & 1) * 8 + (lane & 7)) * sx
                              + 16 * pg + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 16 * kk + 2 * qc + 8 * (r >> 1);
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xa[r]));
          split_bf16(xv.x * u[j], xv.y * u[j + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const int pair = wn + kWPG * i;
          if (pair >= n16) break;
          uint32_t bq[4];
          ldsm_x4_trans(bq, bs + (16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * sn
                               + 16 * pair + (lane >> 4) * 8);
          mma_bf16(s[i][0], ah, bq[0], bq[1]);
          mma_bf16(s[i][1], ah, bq[2], bq[3]);
          mma_bf16(s[i][0], al, bq[0], bq[1]);
          mma_bf16(s[i][1], al, bq[2], bq[3]);
        }
      }
      // the new state, hi and lo, for the next chunk's y
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
                       *reinterpret_cast<uint32_t*>(sm + L.s + off),
                       *reinterpret_cast<uint32_t*>(sm + L.s + kP * sn + off));
          }
      }
    }
    if (c + 1 < p.nc) {
      __syncthreads();   // every warp is done with this chunk's B
      load_b(c + 1);
      cp_async_commit();
    }
  }
  if (s_warp) {   // the final state in fp32
    float* const out = p.state + ((size_t)bi * p.H + h) * p.P * p.N;
    const int pr = 16 * pg + gr;
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
}

template <int kP>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int bytes = Smem<kP>(p.N).bytes();
  // above 48 KB only when asked for; set per launch, as it is per device
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<kP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<kP><<<dim3(p.H, batch), kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,T,H,P), B and C (B,T,G,N) bf16 with their last axis contiguous and
// rows 16-byte aligned; dt (B,T,H) and A (H,) fp32; y (B,T,H,P) bf16 and
// state (B,H,P,N) fp32 contiguous; chunk_state null, or bf16
// (B,H,ceil(T/64) - 1,2,P,N) contiguous, filled with the state at each
// chunk's start after the first, as hi and lo parts; init null (a zero
// initial state), or fp32 (B,H,P,N) contiguous. Launches on `stream` and
// returns a CUDA error code (0: launched).
extern "C" int ssd_fwd_bf16(
    const void* x, const void* dt, const void* A, const void* b,
    const void* c, void* y, void* state, void* chunk_state, const void* init,
    int batch, int T,
    int H, int G, int P, int N, long long sx_b, long long sx_t,
    long long sx_h, long long sdt_b, long long sdt_t, long long sdt_h,
    long long sb_b, long long sb_t, long long sb_g, long long sc_b,
    long long sc_t, long long sc_g, void* stream) {
  if (batch <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || P % 16 != 0 || P > 128 || N % 16 != 0 || N > 128 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.b = static_cast<const uint16_t*>(b);
  p.c = static_cast<const uint16_t*>(c);
  p.y = static_cast<uint16_t*>(y);
  p.state = static_cast<float*>(state);
  p.chunk_state = static_cast<uint16_t*>(chunk_state);
  p.init = static_cast<const float*>(init);
  p.sx_b = sx_b; p.sx_t = sx_t; p.sx_h = sx_h;
  p.sdt_b = sdt_b; p.sdt_t = sdt_t; p.sdt_h = sdt_h;
  p.sb_b = sb_b; p.sb_t = sb_t; p.sb_g = sb_g;
  p.sc_b = sc_b; p.sc_t = sc_t; p.sc_g = sc_g;
  p.T = T; p.H = H; p.G = G; p.P = P; p.N = N;
  p.nc = (T + kL - 1) / kL;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 16) return launch<16>(p, batch, st);
  if (P <= 32) return launch<32>(p, batch, st);
  if (P <= 64) return launch<64>(p, batch, st);
  return launch<128>(p, batch, st);
}
