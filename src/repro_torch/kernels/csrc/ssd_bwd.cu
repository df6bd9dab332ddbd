// K4's backward — the gradient of the Mamba2 SSD (the chunked scan) for
// Hopper (sm_90a): a walk over chunks for the state's gradient alone, then
// every chunk at once, every product on the tensor cores.
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
// its end state (the next chunk's start state; for the last chunk d_final,
// or zero):
//   dS' of the chunk before = e^{max(a_tot, -60)} dS' + (E ∘ dy)ᵀ C; after
//         the first chunk it is d_initial
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
// `ref.ssd_chunked_bwd_parallel` is the two passes below in plain PyTorch
// (`ref.ssd_bwd_dstates`, then `ref.ssd_bwd_chunks`), `ref.ssd_chunked_bwd`
// the same function as one reverse walk. Any T works: x, dy, dt, B and C are
// zero-filled past T, so the padded steps add nothing, and nothing past T
// is stored.
//
// The start states. The chunk pass needs every chunk's start state S. K4
// writes them when asked (its chunk_state buffer, bf16 hi and lo), and the
// autograd forward asks for them whenever a gradient is needed; the first
// chunk starts from the initial state (fp32, split here) or zero.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), at the
// mamba2-130m train shape (B 8, T 2048, H 24, P 64, N 128, G 1): the
// least traffic is x, dy and dx (50.3 MB each), B, C, dB and dC (4.2 MB
// each), dt and ddt (1.6 MB each), 170.9 MB, 0.0510 ms; the products of
// the chunked algorithm, 2 L (L (2 N + 2 P) + 4 N P) per (batch row, head,
// 64-step chunk) and 2 L² N per (batch row, group, chunk) for C Bᵀ, come
// to 45.4 GFLOP, 0.046 ms. Bound by bytes, operations close behind. The
// floor of this design adds the start states read (195.0 MB) and dS'
// written by the walk and read by the chunk pass (201.3 MB each way): 768.6
// MB, 0.229 ms.
//
// Design. The only dependence across chunks is the one on dS', so two
// passes, each launch's error checked:
//  1. ssd_bwd_dstate_kernel, the walk, carries only dS'. One block of
//     P/16 warps per (64 columns of N, head, batch row), 384 at the train
//     shape, three an SM (the first form, 192 blocks of one (head, row)
//     each, walked every gradient in series: 1.45 waves of serial walks).
//     A warp holds 16 rows of P by the block's 64 columns in fp32
//     registers and per chunk adds (E ∘ dy)ᵀ C, E ∘ dy split into hi and
//     lo; dy, C's 64 columns and dt arrive by cp.async a chunk ahead, in a
//     ring of two stages;
//     each warp scans cum for itself. Every chunk's dS' (the last's is
//     d_final or zero) goes out as bf16 hi and lo, in the layout of K4's
//     chunk-start states: a warp splits its tile into one of its two
//     staging tiles (swizzled as TMA reads them) and its lane 0 stores it
//     by TMA, asynchronously, waiting only for the store before last;
//     d_initial in fp32. Its first block zeroes the chunk pass's counters.
//  2. ssd_bwd_chunk_kernel: every other gradient, chunk-parallel. One
//     block of sixteen warps per (batch row, chunk, tile of a group's
//     heads) holds the chunk's B and C, computes C Bᵀ once for all its
//     heads (the first form: once a head, 77.7 GFLOP issued), and walks
//     the tile's heads in ascending order with dB and dC of the whole tile
//     in fp32 registers, so that the heads are summed in a fixed order
//     with no per-head partials (the first form wrote 805 MB of them).
//     Per head, the state terms come first, over slices of S and dS' (32
//     whole rows of P, hi and lo), two slots deep: TMA boxes an item
//     ahead, one thread issuing them on the slot's mbarrier, the head's x,
//     dy and dt (by cp.async) with its first slice: B dS'ᵀ into dx's
//     accumulators, dy S and x dS' scaled by E and u into the tile's dC
//     and dB, E dy·(S C) and <dS', S> (from the operand fragments already
//     in registers) summed on the way. With the first slice, the warps
//     below the diagonal also build W = (C Bᵀ) ∘ L ∘ dt and M = (dy xᵀ) ∘
//     L ∘ dt (hi and lo, to shared memory) and G's row and column sums.
//     Then dx = u ∘ (B dS'ᵀ) + Wᵀ dy (stored), M B and Mᵀ C into the
//     tile's dC and dB. Every warp scans the head's cum; dcum, the reverse
//     scan of da, ddt and the head's share of dA are one warp's, in turn
//     one of the six warps above the diagonal, at the start of the next
//     head while the others compute (the first form left them to warp 0
//     while seven waited), from sums kept apart by the head's parity. Heads per
//     tile: the wrapper picks the fewest tiles that keep the card's blocks
//     busy (one at the train shape: 256 blocks). Where a group's heads are
//     split over tiles, each tile writes its fp32 dB and dC of the chunk,
//     and the last tile to count itself on the chunk's counter adds them
//     in ascending tile order; dA's shares per (batch row, chunk, head),
//     by the last block of each (group, tile) to count itself, in a fixed
//     order.
// Each pass has two instantiations a head dim: one for whole shapes (the
// walk: N a multiple of 64; the chunk pass: N 128; both: P its kP), whose
// loop bounds are constants (at the train shape the chunk pass takes 0.44
// in place of 0.54 ms: with bounds read at run time every product loop
// ends in a branch on N or P), and one for any other shape.
// Products on mma.sync m16n8k16, bf16 operands, fp32 sums. An fp32 operand
// (W, M, dS', S, E ∘ dy) is split into bf16 hi = bf16(v) and lo = bf16(v -
// hi), one mma each, as K4 does: about 16 bits of mantissa.
// Repeatable bit for bit: every sum has a fixed order, and the counters
// order the reads, not the sums; nothing is added by atomics.
// x, dy, B and C need 16-byte aligned pointers and batch, time and head
// (group) strides (the wrapper checks), P a multiple of 16 up to 128, N a
// multiple of 16 up to 128 (the launcher checks; every such shape fits the
// card's shared memory, jamba's P 128, N 128 the largest at 220856 bytes).
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ldsm_x4;
using flash::ldsm_x4_trans;
using flash::mma_bf16;
using flash::pack_bf16;

constexpr int kL = 64;          // steps per chunk
constexpr int kSW = kL + 8;     // row stride of the W and M tiles
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

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
  uint16_t* dstates;            // (B, H, nc, 2, P, N) bf16 hi, lo: dS'
  uint16_t* dx;                 // (B, T, H, P) bf16
  float* ddt;                   // (B, T, H) fp32
  float* dA;                    // (H,) fp32
  uint16_t* db;                 // (B, T, G, N) bf16
  uint16_t* dc;
  float* dinit;                 // (B, H, P, N) fp32
  float* part_bc;               // (nt, 2, B, T, G, N) fp32 (dB, dC), or null
  float* part_a;                // (B, nc, H) fp32
  int* count;                   // G nt (group, tile) counters, then B nc G
                                // (batch row, chunk, group) ones: ncount,
                                // zeroed by the walk for the chunk pass
  long long sx_b, sx_t, sx_h;   // element strides
  long long sdt_b, sdt_t, sdt_h;
  long long sb_b, sb_t, sb_g;
  long long sc_b, sc_t, sc_g;
  long long sdy_b, sdy_t, sdy_h;
  int batch, T, H, G, P, N, nc, rep, ht, nt, ncount;
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

// The in-chunk scan of one warp, two steps a lane: cum at 2 lane and 2 lane
// + 1 (cm), and the chunk's a_tot.
__device__ __forceinline__ float scan_cum(float a0, float a1, int lane,
                                          float (&cm)[2]) {
  float sum = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, sum, off);
    if (lane >= off) sum += o;
  }
  float excl = __shfl_up_sync(kFull, sum, 1);
  if (lane == 0) excl = 0.f;
  cm[0] = excl + a0;
  cm[1] = sum;
  return __shfl_sync(kFull, sum, 31);
}

// ---------------------------------------------------------------------
// Pass 1: dS' of every chunk, a reverse walk per (batch row, head, 64
// columns of N).
// ---------------------------------------------------------------------
constexpr int kCols1 = 64;      // columns of N a block of the walk takes
constexpr int kNI1 = kCols1 / 16;

// Waits until at most one of this thread's bulk stores has its shared
// memory still to read.
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// From a 1024-byte boundary: each warp's two staging tiles of dS' (hi and
// lo, its 16 rows by the block's 64 columns, one TMA box each, swizzled as
// TMA reads them; the chunks alternate between them); then kS stages of dy
// [kL][kP + 8] and C [kL][64 + 8] in bf16 and dt [kL] fp32; then each
// warp's E [kL].
template <int kP>
struct Smem1 {
  static constexpr int kWarps = kP / 16;               // a warp per 16 rows
  static constexpr int kS = 2;                         // stages of the ring
  static constexpr int sdy = kP + 8;
  static constexpr int sc = kCols1 + 8;
  static constexpr int kTile = 2 * 16 * kCols1 * 2;    // hi and lo, bytes
  static constexpr int kStg = 2 * kTile;               // a warp's two tiles
  static constexpr int stage = 2 * kL * (sdy + sc) + 4 * kL;
  static constexpr int bytes = kWarps * kStg + kS * stage + kWarps * 4 * kL + 1024;
};

// Warp w takes rows 16 w of P and the block's 64 columns of N, dS' in 32
// fp32 registers a thread.
// kWhole: P is kP and N a multiple of 64, so that every warp and column
// block is live and every loop bound a constant.
template <int kP, bool kWhole>
__global__ void __launch_bounds__(32 * Smem1<kP>::kWarps)
ssd_bwd_dstate_kernel(const __grid_constant__ CUtensorMap tds, const Params p) {
  using Ly = Smem1<kP>;
  constexpr int kThreads = 32 * Ly::kWarps, kS1 = Ly::kS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  unsigned char* const stg0 =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const sm = stg0 + Ly::kWarps * Ly::kStg;
  const int n0 = kCols1 * blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / p.rep, n16 = p.N / 16, nb0 = n0 / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, qc = lane & 3;
  const int pr = 16 * warp + gr;  // this thread's rows of P: pr, pr + 8
  const bool live = kWhole || 16 * warp < p.P;
  const size_t bh = (size_t)bi * p.H + h;
  const size_t pn = (size_t)p.P * p.N;
  float* const f_e = reinterpret_cast<float*>(sm + kS1 * Ly::stage) + warp * kL;
  const uint16_t* const dyb = p.dy + bi * p.sdy_b + h * p.sdy_h;
  const uint16_t* const cb = p.c + bi * p.sc_b + g * p.sc_g + n0;
  const float* const dtb = p.dt + bi * p.sdt_b + h * p.sdt_h;

  // walk step k takes chunk nc - 1 - k, in stage k % kS1
  auto issue = [&](int k) {
    if (k < p.nc) {
      const int t0 = (p.nc - 1 - k) * kL;
      uint16_t* const dys = reinterpret_cast<uint16_t*>(sm + (k % kS1) * Ly::stage);
      uint16_t* const cs = dys + kL * Ly::sdy;
      float* const dts = reinterpret_cast<float*>(cs + kL * Ly::sc);
      for (int e = tid; e < kL * kP / 8; e += kThreads) {
        const int j = e / (kP / 8), q = (e % (kP / 8)) * 8;
        const bool ok = t0 + j < p.T && q < p.P;
        cp_async16(dys + j * Ly::sdy + q, ok ? dyb + (t0 + j) * p.sdy_t + q : dyb,
                   ok);
      }
      for (int e = tid; e < kL * kCols1 / 8; e += kThreads) {
        const int j = e / (kCols1 / 8), q = (e % (kCols1 / 8)) * 8;
        const bool ok = t0 + j < p.T && n0 + q < p.N;
        cp_async16(cs + j * Ly::sc + q, ok ? cb + (t0 + j) * p.sc_t + q : cb, ok);
      }
      for (int j = tid; j < kL; j += kThreads) {
        const bool ok = t0 + j < p.T;
        cp_async4(dts + j, ok ? dtb + (t0 + j) * p.sdt_t : dtb, ok);
      }
    }
    cp_async_commit();
  };

  // dS': rows pr (+ 8), columns n0 + 16 i + 8 t + 2 qc (+ 1), from d_final
  // or zero
  float s[kNI1][2][4];
#pragma unroll
  for (int i = 0; i < kNI1; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][t][e] = 0.f;
  if (p.dfinal != nullptr && live) {
    const float* const in = p.dfinal + bh * pn;
#pragma unroll
    for (int i = 0; i < kNI1; ++i) {
      if (!kWhole && nb0 + i >= n16) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              in + (size_t)(pr + 8 * r) * p.N + n0 + 16 * i + 8 * t + 2 * qc);
          s[i][t][2 * r] = v.x;
          s[i][t][2 * r + 1] = v.y;
        }
    }
  }
  const float a_h = p.A[h];
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = tid; i < p.ncount; i += kThreads) p.count[i] = 0;
  for (int k = 0; k < kS1 - 1; ++k) issue(k);

  for (int k = 0; k < p.nc; ++k) {
    const int c = p.nc - 1 - k;
    cp_async_wait<kS1 - 2>();
    __syncthreads();   // chunk c is in its stage; chunk c + 1's is free
    issue(k + kS1 - 1);
    if (!live) continue;
    const uint16_t* const dys =
        reinterpret_cast<const uint16_t*>(sm + (k % kS1) * Ly::stage);
    const uint16_t* const cs = dys + kL * Ly::sdy;
    const float* const dts = reinterpret_cast<const float*>(cs + kL * Ly::sc);
    // ---- dS' of chunk c (the gradient of its end state; of the last,
    // d_final or zero), hi and lo: the warp's tile into its staging boxes,
    // then its lane 0 stores them by TMA, asynchronously, once the store
    // before last has read the tile ----
    {
      unsigned char* const stg = stg0 + warp * Ly::kStg + (k & 1) * Ly::kTile;
      if (lane == 0) bulk_wait_read1();
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kNI1; ++i) {
        if (!kWhole && nb0 + i >= n16) break;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int col = 16 * i + 8 * t + 2 * qc;   // within the block's
            const uint32_t off =
                hopper::swizzle<2 * kCols1>((gr + 8 * r) * 2 * kCols1 + col * 2);
            split_bf16(s[i][t][2 * r], s[i][t][2 * r + 1],
                       *reinterpret_cast<uint32_t*>(stg + off),
                       *reinterpret_cast<uint32_t*>(stg + Ly::kTile / 2 + off));
          }
      }
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int part = 0; part < 2; ++part)
          hopper::tma_store_4d(&tds, hopper::smem_u32(stg + part * (Ly::kTile / 2)),
                               n0, 16 * warp, 2 * c + part, (int)bh);
        hopper::bulk_commit();
      }
    }
    // ---- this warp's scan: E of the chunk's steps, and its decay ----
    float cm[2];
    const float a_tot =
        scan_cum(dts[2 * lane] * a_h, dts[2 * lane + 1] * a_h, lane, cm);
    f_e[2 * lane] = expf(fmaxf(cm[0], -60.f));
    f_e[2 * lane + 1] = expf(fmaxf(cm[1], -60.f));
    __syncwarp();
    // ---- dS' <- e^{max(a_tot, -60)} dS' + (E ∘ dy)ᵀ C ----
    const float d = expf(fmaxf(a_tot, -60.f));
#pragma unroll
    for (int i = 0; i < kNI1; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][t][e] *= d;
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t ya[4], ah[4], al[4];
      lda_tr(ya, dys, Ly::sdy, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 16 * kk + 2 * qc + 8 * (r >> 1);
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ya[r]));
        split_bf16(v.x * f_e[j], v.y * f_e[j + 1], ah[r], al[r]);
      }
#pragma unroll
      for (int i = 0; i < kNI1; ++i) {
        if (!kWhole && nb0 + i >= n16) break;
        uint32_t bq[4];
        ldb_kn(bq, cs, Ly::sc, 16 * i, 16 * kk, lane);
        mma2(s[i], ah, bq);
        mma2(s[i], al, bq);
      }
    }
    __syncwarp();   // f_e is rewritten at the next chunk
  }
  cp_async_wait<0>();
  if (live && lane == 0) hopper::bulk_wait();   // the stores, before exit
  // ---- d_initial, the gradient of the first chunk's start state ----
  if (live) {
    float* const out = p.dinit + bh * pn;
#pragma unroll
    for (int i = 0; i < kNI1; ++i) {
      if (!kWhole && nb0 + i >= n16) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(out + (size_t)(pr + 8 * r) * p.N + n0 +
                                     16 * i + 8 * t + 2 * qc) =
              make_float2(s[i][t][2 * r], s[i][t][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// Pass 2: every chunk at once, a block per (batch row, chunk, head tile).
// ---------------------------------------------------------------------
constexpr int kWarps2 = 16;
constexpr int kThreads2 = 32 * kWarps2;
constexpr int kNI = 2;           // a warp's column blocks of N: cq + 4 i
// the warps (rg, cq) = (w % 4, w / 4) with cq > rg
__device__ constexpr int kTailWarp[6] = {4, 8, 12, 9, 13, 14};

// B of the n tile at n0 (8 columns) by 16 of k, of a matrix stored [k][n]:
// ldmatrix of two 8 x 8 tiles, transposed.
__device__ __forceinline__ void ldb1_kn(uint32_t (&b)[2], const uint16_t* base,
                                        int ld, int n0, int k0, int lane) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(
      base + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(a));
}

// Shared memory, in bf16 elements from a 1024-byte boundary: ring B, two
// slots of S hi, S lo, dS' hi, dS' lo (kPS rows of P, whole), each as two
// TMA boxes of 64 columns in rows of 128 bytes, swizzled as TMA writes
// them; B and C [kL][N + 8]; ring A, two slots of x and dy [kL][kP + 8];
// W and M as hi and lo [2][kL][kSW]; then floats and ring B's two
// mbarriers.
template <int kP>
struct Smem2 {
  static constexpr int kPS = kP < 32 ? kP : 32;   // rows of P a slice holds
  static constexpr int sx = kP + 8;
  static constexpr int kBox = kPS * 64;           // a box: kPS rows x 64
  static constexpr int kSlot = 8 * kBox;
  // per head parity: its scan (dt, cum, E, u [4][kL], a_tot, decay); G's
  // row sums [4][kL] (by column quarter); column sums of G and of
  // (C Bᵀ) ∘ (dy xᵀ) ∘ L [4][kL] each (by row group); x·(dS' B) [4][kL]
  // and E dy·(S C) [4][kL] (by column quarter); <dS', S> per warp
  static constexpr int kScan = 4 * kL + 4;
  static constexpr int kPart = 20 * kL + kWarps2;
  static constexpr int kFloats = 2 * kL + 2 * kScan + 2 * kPart;
  int sn, bs, cs, xa, w, m, f;
  __host__ __device__ explicit Smem2(int N)
      : sn(N + 8), bs(2 * kSlot), cs(bs + kL * sn), xa(cs + kL * sn),
        w(xa + 4 * kL * sx), m(w + 2 * kL * kSW), f(m + 2 * kL * kSW) {}
  // with the mbarriers and the slack for the alignment
  // with the mbarriers, the two merge flags and the slack for the
  // alignment
  __host__ __device__ int bytes() const { return 2 * f + kFloats * 4 + 24 + 1024; }
};

// Element (r, n) of a slice's part: its box of 64 columns, the 128-byte
// swizzle within it.
template <int kBox>
__device__ __forceinline__ const uint16_t* sw_at(const uint16_t* part, int r,
                                                 int n) {
  return part + (n >> 6) * kBox +
         (hopper::swizzle<128>(r * 128 + (n & 63) * 2) >> 1);
}
// The mma B operands from a slice's parts (rows r of P, columns n of N),
// read through the swizzle: of the 8-column n tile at n0 of a matrix stored
// [n][k], the hi and lo parts at once (lo = hi + 2 kBox; lanes 0-15 address
// the hi part, 16-31 the lo part; b[0..1] hi, b[2..3] lo); or two n tiles
// of a matrix stored [k][n].
template <int kBox>
__device__ __forceinline__ void ldb1_nk_sw_hilo(uint32_t (&b)[4],
                                                const uint16_t* hi, int n0,
                                                int k0, int lane) {
  ldsm_x4(b, sw_at<kBox>(hi + (lane >> 4) * 2 * kBox, n0 + (lane & 7),
                         k0 + ((lane >> 3) & 1) * 8));
}
template <int kBox>
__device__ __forceinline__ void ldb_kn_sw(uint32_t (&b)[4], const uint16_t* part,
                                          int n0, int k0, int lane) {
  ldsm_x4_trans(b, sw_at<kBox>(part, k0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                               n0 + (lane >> 4) * 8));
}

// Sixteen warps: warp (rg, cq) = (w % 4, w / 4) takes rows 16 rg of the
// chunk; of dC and dB the column blocks cq + 4 i; of dx 8 columns of each
// slice, kPS ps + 8 cq; of C Bᵀ, dy xᵀ, W and M the block (rg, cq) below
// the diagonal.
// kWhole: P is kP and N 128, so that every loop bound is a constant.
template <int kP, bool kWhole>
__global__ void __launch_bounds__(kThreads2, 1)
ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap ts,
                     const __grid_constant__ CUtensorMap td, const Params p) {
  using Ly = Smem2<kP>;
  constexpr int sx = Ly::sx, kPS = Ly::kPS, kNPS = kP / kPS, kBox = Ly::kBox;
  const int NN = kWhole ? 128 : p.N, PP = kWhole ? kP : p.P;
  const Ly L(NN);
  const int sn = L.sn, n16 = NN / 16, p16 = PP / 16;
  const int tile = blockIdx.x % p.nt, g = blockIdx.x / p.nt;
  const int c = blockIdx.y, bi = blockIdx.z;
  const int h0 = g * p.rep + tile * p.ht;
  const int nh = min(p.ht, (g + 1) * p.rep - h0);   // this block's heads
  const int t0 = c * kL, len = min(kL, p.T - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, qc = lane & 3;
  const int rg = warp & 3, cq = warp >> 2;
  const bool y_warp = 8 * cq < kPS;          // a warp with columns of dx
  const bool d_warp = cq <= rg;              // a warp with a block of W, M
  const int r0 = 16 * rg + gr, r1 = r0 + 8;  // this thread's rows
  const int nps = (PP + kPS - 1) / kPS;      // slices a head
  const int total = nh * nps;
  const size_t pn = (size_t)PP * NN;

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* const sm = reinterpret_cast<uint16_t*>(
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023));
  uint16_t* const bs = sm + L.bs;
  uint16_t* const cs = sm + L.cs;
  uint16_t* const wt = sm + L.w;
  uint16_t* const mt = sm + L.m;
  float* const f_dta = reinterpret_cast<float*>(sm + L.f);   // [2][kL]
  float* const f_scan0 = f_dta + 2 * kL;                      // [2][kScan]
  float* const f_part0 = f_scan0 + 2 * Ly::kScan;             // [2][kPart]
  const uint32_t bar0 = hopper::smem_u32(f_part0 + 2 * Ly::kPart);
  int* const flags = reinterpret_cast<int*>(f_part0 + 2 * Ly::kPart + 4);
  if (tid == 0) {
    hopper::mbar_init(bar0, 1);
    hopper::mbar_init(bar0 + 8, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // ---- loads: B and C ride with the first item; item k is slice k % nps
  // of head k / nps, its head's x, dy and dt with its first slice ----
  {
    const uint16_t* const bb = p.b + bi * p.sb_b + g * p.sb_g;
    const uint16_t* const cb = p.c + bi * p.sc_b + g * p.sc_g;
    // rows of N by 16-byte chunks: a warp takes two rows at a time, a lane
    // one chunk (N <= 128: at most 16 a row)
    const int q = (lane & 15) * 8;
    if (q < NN)
      for (int j = 2 * warp + (lane >> 4); j < kL; j += 2 * kWarps2) {
        const bool ok = t0 + j < p.T;
        cp_async16(bs + j * sn + q, ok ? bb + (t0 + j) * p.sb_t + q : bb, ok);
        cp_async16(cs + j * sn + q, ok ? cb + (t0 + j) * p.sc_t + q : cb, ok);
      }
  }
  auto issue = [&](int k) {
    if (k < total) {
      const int hh = k / nps, ps = k - hh * nps;
      const int h = h0 + hh;
      const size_t bh = (size_t)bi * p.H + h;
      if (ps == 0) {
        uint16_t* const xs = sm + L.xa + (hh & 1) * 2 * kL * sx;
        uint16_t* const dys = xs + kL * sx;
        float* const dts = f_dta + (hh & 1) * kL;
        const uint16_t* const xb = p.x + bi * p.sx_b + h * p.sx_h;
        const uint16_t* const dyb = p.dy + bi * p.sdy_b + h * p.sdy_h;
        const float* const dtb = p.dt + bi * p.sdt_b + h * p.sdt_h;
        for (int e = tid; e < kL * kP / 8; e += kThreads2) {
          const int jj = e / (kP / 8), q = (e % (kP / 8)) * 8;
          const bool ok = t0 + jj < p.T && q < PP;
          cp_async16(xs + jj * sx + q, ok ? xb + (t0 + jj) * p.sx_t + q : xb, ok);
          cp_async16(dys + jj * sx + q, ok ? dyb + (t0 + jj) * p.sdy_t + q : dyb,
                     ok);
        }
        if (tid < kL) {
          const bool ok = t0 + tid < p.T;
          cp_async4(dts + tid, ok ? dtb + (t0 + tid) * p.sdt_t : dtb, ok);
        }
      }
      // S: K4's start state of chunk c (by TMA), or at the first chunk the
      // initial state (split here) or zero; dS': pass 1's (by TMA); rows
      // kPS ps .. of P, whole, on slot k % 2's mbarrier
      uint16_t* const slot = sm + (k & 1) * Ly::kSlot;
      const uint32_t bar = bar0 + 8 * (k & 1);
      const int prow0 = kPS * ps, nbox = (NN + 63) / 64;
      if (tid == 0) {
        hopper::mbar_arrive_tx(bar, (c > 0 ? 2 : 1) * 2u * nbox * kBox * 2);
        for (int which = c > 0 ? 0 : 1; which < 2; ++which)
          for (int part = 0; part < 2; ++part)
            for (int x = 0; x < nbox; ++x)
              hopper::tma_load_4d(
                  hopper::smem_u32(slot + (2 * which + part) * 2 * kBox + x * kBox),
                  which ? &td : &ts, bar, 64 * x, prow0,
                  2 * (which ? c : c - 1) + part, (int)bh);
      }
      if (c == 0) {
        // every load first, then the splits: a thread's pairs of columns
        constexpr int kPer = (kPS * 64 + kThreads2 - 1) / kThreads2;
        const int n2 = NN / 2;
        float2 v[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = tid + i * kThreads2, r = e / n2, n = (e - r * n2) * 2;
          v[i] = make_float2(0.f, 0.f);
          if (p.init != nullptr && e < kPS * n2 && prow0 + r < PP)
            v[i] = *reinterpret_cast<const float2*>(
                p.init + bh * pn + (size_t)(prow0 + r) * NN + n);
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = tid + i * kThreads2, r = e / n2, n = (e - r * n2) * 2;
          if (e < kPS * n2)
            split_bf16(v[i].x, v[i].y,
                       *reinterpret_cast<uint32_t*>(const_cast<uint16_t*>(sw_at<kBox>(slot, r, n))),
                       *reinterpret_cast<uint32_t*>(const_cast<uint16_t*>(sw_at<kBox>(slot + 2 * kBox, r, n))));
        }
        hopper::fence_proxy_async();
      }
    }
    cp_async_commit();
  };

  // dcum, the reverse scan of da, ddt and dA's share of head hq, from its
  // scan and the sums of its parity
  auto head_tail = [&](int hq) {
    const int h = h0 + hq;
    const float* const sc = f_scan0 + (hq & 1) * Ly::kScan;
    const float* const s_dt = sc;
    const float* const s_cum = sc + kL;
    const float* const s_u = sc + 3 * kL;
    const float* const part = f_part0 + (hq & 1) * Ly::kPart;
    const float* const f_row = part;
    const float* const f_colg = part + 4 * kL;
    const float* const f_cold = part + 8 * kL;
    const float* const f_xq = part + 12 * kL;
    const float* const f_ecs = part + 16 * kL;
    const float* const f_sdot = part + 20 * kL;
    const float a_tot = sc[4 * kL], decay = sc[4 * kL + 1], a_h = p.A[h];
    float dcum[2], ddt[2], vsum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = 2 * lane + i;
      float colg = 0.f, cold = 0.f;
      for (int r = j / 16; r < 4; ++r) {
        colg += f_colg[r * kL + j];
        cold += f_cold[r * kL + j];
      }
      float row = 0.f, xq = 0.f, ecs = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        row += f_row[q * kL + j];
        xq += f_xq[q * kL + j];
        ecs += f_ecs[q * kL + j];
      }
      const float cj = s_cum[j];
      const float v = a_tot - cj >= -60.f ? s_u[j] * xq : 0.f;
      dcum[i] = row - colg - v + (cj >= -60.f ? ecs : 0.f);
      ddt[i] = cold + expf(fminf(fmaxf(a_tot - cj, -60.f), 0.f)) * xq;
      vsum += v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vsum += __shfl_xor_sync(kFull, vsum, o);
    if (lane == 31) {
      float sd = 0.f;
      for (int w = 0; w < kWarps2; ++w) sd += f_sdot[w];
      dcum[1] += vsum + (a_tot >= -60.f ? decay * sd : 0.f);
    }
    // da_r = Σ_{t >= r} dcum_t: a suffix scan over the lanes' pairs
    float sum = dcum[0] + dcum[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(kFull, sum, off);
      if (lane + off < 32) sum += o;
    }
    float excl = __shfl_down_sync(kFull, sum, 1);
    if (lane == 31) excl = 0.f;
    const float da1 = dcum[1] + excl, da0 = dcum[0] + da1;
    const float das[2] = {da0, da1};
    float da_acc = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = 2 * lane + i;
      if (t0 + j < p.T)
        p.ddt[((size_t)bi * p.T + t0 + j) * p.H + h] = ddt[i] + a_h * das[i];
      da_acc += s_dt[j] * das[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da_acc += __shfl_xor_sync(kFull, da_acc, o);
    if (lane == 0) p.part_a[((size_t)bi * p.nc + c) * p.H + h] = da_acc;
  };

  issue(0);

  // C Bᵀ on this warp's block (rows 16 rg, columns 16 cq), the same for
  // every head
  float cbt[2][4];
  // dC and dB of the tile's heads: rows 16 rg, column blocks cq + 4 i
  float gc[kNI][2][4], gb[kNI][2][4];
#pragma unroll
  for (int i = 0; i < kNI; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) gc[i][t][e] = gb[i][t][e] = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) cbt[t][e] = 0.f;

  int k = 0;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const uint16_t* const xs = sm + L.xa + (hh & 1) * 2 * kL * sx;
    const uint16_t* const dys = xs + kL * sx;
    float* const sc = f_scan0 + (hh & 1) * Ly::kScan;
    float* const part = f_part0 + (hh & 1) * Ly::kPart;
    // dx's accumulators: rows 16 rg, columns kPS ps + 8 cq (+ 8)
    float acc[kNPS][4];
#pragma unroll
    for (int ps = 0; ps < kNPS; ++ps)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ps][e] = 0.f;
    float ecs[2] = {0.f, 0.f}, sd = 0.f;

#pragma unroll
    for (int ps = 0; ps < kNPS; ++ps) {
      if (ps >= nps) break;
      // ---- item k: wait for its slice; the slot of item k - 1 is free ----
      cp_async_wait<0>();
      __syncthreads();
      issue(k + 1);
      hopper::mbar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);
      const uint16_t* const s_hi = sm + (k & 1) * Ly::kSlot;
      const uint16_t* const s_lo = s_hi + 2 * kBox;
      const uint16_t* const d_hi = s_lo + 2 * kBox;
      const uint16_t* const d_lo = d_hi + 2 * kBox;
      if (k == 0 && d_warp) {
        for (int kk = 0; kk < n16; ++kk) {
          uint32_t a[4], bq[4];
          lda_rm(a, cs, sn, 16 * rg, 16 * kk, lane);
          ldb_nk(bq, bs, sn, 16 * cq, 16 * kk, lane);
          mma2(cbt, a, bq);
        }
      }
      if (ps == 0) {
        // the head before's dcum, one warp a head, while the others go on:
        // in turn the six warps above the diagonal, which build no W, M
        if (hh > 0 && warp == kTailWarp[(hh - 1) % 6]) head_tail(hh - 1);
        // the head's scan: every warp computes it and writes it whole, so
        // that it reads back its own (or an equal) value
        const float* const dts = f_dta + (hh & 1) * kL;
        const float a_h = p.A[h];
        const float dd[2] = {dts[2 * lane], dts[2 * lane + 1]};
        float cm[2];
        const float a_tot = scan_cum(dd[0] * a_h, dd[1] * a_h, lane, cm);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = 2 * lane + i;
          sc[j] = dd[i];
          sc[kL + j] = cm[i];
          sc[2 * kL + j] = __expf(fmaxf(cm[i], -60.f));
          sc[3 * kL + j] =
              __expf(fminf(fmaxf(a_tot - cm[i], -60.f), 0.f)) * dd[i];
        }
        if (lane == 0) {
          sc[4 * kL] = a_tot;
          sc[4 * kL + 1] = __expf(fmaxf(a_tot, -60.f));
        }
        __syncwarp();
      // ---- dy xᵀ; W, M (hi, lo) to shared memory; G's row and column
      // sums (the warps below the diagonal, a block each), while the
      // others start on the state products; read after the next barrier ----
      {
        float* const f_row = part;
        float* const f_colg = part + 4 * kL;
        float* const f_cold = part + 8 * kL;
        float row_g[2] = {0.f, 0.f};
        if (d_warp) {
          float dxt[2][4];
  #pragma unroll
          for (int t = 0; t < 2; ++t)
  #pragma unroll
            for (int e = 0; e < 4; ++e) dxt[t][e] = 0.f;
          for (int kk = 0; kk < p16; ++kk) {
            uint32_t a[4], bq[4];
            lda_rm(a, dys, sx, 16 * rg, 16 * kk, lane);
            ldb_nk(bq, xs, sx, 16 * cq, 16 * kk, lane);
            mma2(dxt, a, bq);
          }
          const float* const s_dt = sc;
          const float* const s_cum = sc + kL;
          const float cr[2] = {s_cum[r0], s_cum[r1]};
  #pragma unroll
          for (int t = 0; t < 2; ++t) {
            float col_g[2] = {0.f, 0.f}, col_d[2] = {0.f, 0.f};
            const int s0 = 16 * cq + 8 * t + 2 * qc;
            float wv[4], mv[4];
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = e < 2 ? r0 : r1, col = s0 + (e & 1);
              const float diff = cr[e >> 1] - s_cum[col];
              const bool on = col <= row;
              const float l = on ? __expf(fminf(fmaxf(diff, -60.f), 0.f)) : 0.f;
              const float dtc = s_dt[col];
              const float cbdx = cbt[t][e] * dxt[t][e] * l;
              const float gv = on && diff >= -60.f ? cbdx * dtc : 0.f;
              wv[e] = cbt[t][e] * l * dtc;
              mv[e] = dxt[t][e] * l * dtc;
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
                col_g[e] += __shfl_xor_sync(kFull, col_g[e], o);
                col_d[e] += __shfl_xor_sync(kFull, col_d[e], o);
              }
            }
            if (gr == 0) {
              f_colg[rg * kL + s0] = col_g[0];
              f_colg[rg * kL + s0 + 1] = col_g[1];
              f_cold[rg * kL + s0] = col_d[0];
              f_cold[rg * kL + s0 + 1] = col_d[1];
            }
          }
          // row sums over this warp's columns: the four lanes of a row
  #pragma unroll
          for (int r = 0; r < 2; ++r) {
            row_g[r] += __shfl_xor_sync(kFull, row_g[r], 1);
            row_g[r] += __shfl_xor_sync(kFull, row_g[r], 2);
          }
        }
        if (qc == 0) {   // every column quarter writes its share, zero above
          f_row[cq * kL + r0] = row_g[0];
          f_row[cq * kL + r1] = row_g[1];
        }
      }
      }
      // ---- B dS'ᵀ over N, into dx's 8 columns of the slice ----
      if (y_warp) {
        for (int kk = 0; kk < n16; ++kk) {
          uint32_t a[4], bq[4];
          lda_rm(a, bs, sn, 16 * rg, 16 * kk, lane);
          ldb1_nk_sw_hilo<kBox>(bq, d_hi, 8 * cq, 16 * kk, lane);
          mma_bf16(acc[ps], a, bq[0], bq[1]);
          mma_bf16(acc[ps], a, bq[2], bq[3]);
        }
      }
      // ---- dy S and x dS' over the slice's rows of P, on this warp's
      // column blocks, into the tile's dC (scaled by E) and dB (by u) ----
      {
        const int kmax = kWhole ? kPS / 16 : min(kPS, PP - kPS * ps) / 16;
        uint32_t ya[kPS / 16][4], xa[kPS / 16][4];
#pragma unroll
        for (int kk = 0; kk < kPS / 16; ++kk) {
          if (kk >= kmax) break;
          lda_rm(ya[kk], dys, sx, 16 * rg, kPS * ps + 16 * kk, lane);
          lda_rm(xa[kk], xs, sx, 16 * rg, kPS * ps + 16 * kk, lane);
        }
        const float e0 = sc[2 * kL + r0], e1 = sc[2 * kL + r1];
        const float u0 = sc[3 * kL + r0], u1 = sc[3 * kL + r1];
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          const int nb = cq + 4 * i;
          if (nb >= n16) break;
          float tc[2][4], tb[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) tc[t][e] = tb[t][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kPS / 16; ++kk) {
            if (kk >= kmax) break;
            uint32_t sh[4], sl[4], dh[4], dl[4];
            ldb_kn_sw<kBox>(sh, s_hi, 16 * nb, 16 * kk, lane);
            ldb_kn_sw<kBox>(sl, s_lo, 16 * nb, 16 * kk, lane);
            ldb_kn_sw<kBox>(dh, d_hi, 16 * nb, 16 * kk, lane);
            ldb_kn_sw<kBox>(dl, d_lo, 16 * nb, 16 * kk, lane);
            mma2(tc, ya[kk], sh);
            mma2(tc, ya[kk], sl);
            mma2(tb, xa[kk], dh);
            mma2(tb, xa[kk], dl);
            // <dS', S> on this 16 x 16 block: the fragments hold each of
            // its elements once; one warp of the four row groups sums it
            if (((2 * i + kk) & 3) == rg) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 a = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&sh[e]));
                const float2 b = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&sl[e]));
                const float2 c2 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&dh[e]));
                const float2 d2 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&dl[e]));
                sd += (c2.x + d2.x) * (a.x + b.x) + (c2.y + d2.y) * (a.y + b.y);
              }
            }
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int q = 16 * nb + 8 * t + 2 * qc;
            tc[t][0] *= e0; tc[t][1] *= e0;
            tc[t][2] *= e1; tc[t][3] *= e1;
            const float2 c0 = bf16x2(cs + r0 * sn + q);
            const float2 c1 = bf16x2(cs + r1 * sn + q);
            ecs[0] += tc[t][0] * c0.x + tc[t][1] * c0.y;
            ecs[1] += tc[t][2] * c1.x + tc[t][3] * c1.y;
            gc[i][t][0] += tc[t][0]; gc[i][t][1] += tc[t][1];
            gc[i][t][2] += tc[t][2]; gc[i][t][3] += tc[t][3];
            gb[i][t][0] += u0 * tb[t][0]; gb[i][t][1] += u0 * tb[t][1];
            gb[i][t][2] += u1 * tb[t][2]; gb[i][t][3] += u1 * tb[t][3];
          }
        }
      }
      ++k;
    }

    if (nps == 1) __syncthreads();   // W and M (else the last slice's barrier)

    // ---- dx = u ∘ (B dS'ᵀ) + Wᵀ dy, and x·(dS' B) on the way ----
    {
      const float u0 = sc[3 * kL + r0], u1 = sc[3 * kL + r1];
      float xq[2] = {0.f, 0.f};
      if (y_warp) {
#pragma unroll
        for (int ps = 0; ps < kNPS; ++ps) {
          const int q = kPS * ps + 8 * cq + 2 * qc;
          const float2 x0 = bf16x2(xs + r0 * sx + q);
          const float2 x1 = bf16x2(xs + r1 * sx + q);
          xq[0] += acc[ps][0] * x0.x + acc[ps][1] * x0.y;
          xq[1] += acc[ps][2] * x1.x + acc[ps][3] * x1.y;
          acc[ps][0] *= u0; acc[ps][1] *= u0;
          acc[ps][2] *= u1; acc[ps][3] *= u1;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xq[r] += __shfl_xor_sync(kFull, xq[r], 1);
          xq[r] += __shfl_xor_sync(kFull, xq[r], 2);
        }
        for (int kk = rg; kk < 4; ++kk) {
          uint32_t ah[4], al[4];
          lda_tr(ah, wt, kSW, 16 * rg, 16 * kk, lane);
          lda_tr(al, wt + kL * kSW, kSW, 16 * rg, 16 * kk, lane);
#pragma unroll
          for (int ps = 0; ps < kNPS; ++ps) {
            uint32_t bq[2];
            ldb1_kn(bq, dys, sx, kPS * ps + 8 * cq, 16 * kk, lane);
            mma_bf16(acc[ps], ah, bq[0], bq[1]);
            mma_bf16(acc[ps], al, bq[0], bq[1]);
          }
        }
#pragma unroll
        for (int ps = 0; ps < kNPS; ++ps) {
          const int q = kPS * ps + 8 * cq + 2 * qc;
          if (q >= PP) continue;
          if (r0 < len)
            *reinterpret_cast<uint32_t*>(
                p.dx + (((size_t)bi * p.T + t0 + r0) * p.H + h) * PP + q) =
                pack_bf16(acc[ps][0], acc[ps][1]);
          if (r1 < len)
            *reinterpret_cast<uint32_t*>(
                p.dx + (((size_t)bi * p.T + t0 + r1) * p.H + h) * PP + q) =
                pack_bf16(acc[ps][2], acc[ps][3]);
        }
      }
      if (qc == 0) {
        part[12 * kL + cq * kL + r0] = xq[0];
        part[12 * kL + cq * kL + r1] = xq[1];
      }
    }
    // ---- the tile's dC += M B (rows 16 rg), dB += Mᵀ C (rows 16 rg) ----
    for (int kk = 0; kk <= rg; ++kk) {
      uint32_t ah[4], al[4];
      lda_rm(ah, mt, kSW, 16 * rg, 16 * kk, lane);
      lda_rm(al, mt + kL * kSW, kSW, 16 * rg, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int nb = cq + 4 * i;
        if (nb >= n16) break;
        uint32_t bq[4];
        ldb_kn(bq, bs, sn, 16 * nb, 16 * kk, lane);
        mma2(gc[i], ah, bq);
        mma2(gc[i], al, bq);
      }
    }
    for (int kk = rg; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      lda_tr(ah, mt, kSW, 16 * rg, 16 * kk, lane);
      lda_tr(al, mt + kL * kSW, kSW, 16 * rg, 16 * kk, lane);
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int nb = cq + 4 * i;
        if (nb >= n16) break;
        uint32_t bq[4];
        ldb_kn(bq, cs, sn, 16 * nb, 16 * kk, lane);
        mma2(gb[i], ah, bq);
        mma2(gb[i], al, bq);
      }
    }
    // ---- E dy·(S C) and <dS', S> of this head, for its dcum ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ecs[r] += __shfl_xor_sync(kFull, ecs[r], 1);
      ecs[r] += __shfl_xor_sync(kFull, ecs[r], 2);
    }
    if (qc == 0) {
      part[16 * kL + cq * kL + r0] = ecs[0];
      part[16 * kL + cq * kL + r1] = ecs[1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sd += __shfl_xor_sync(kFull, sd, o);
    if (lane == 0) part[20 * kL + warp] = sd;
  }
  cp_async_wait<0>();
  __syncthreads();   // the last head's sums
  if (warp == kTailWarp[(nh - 1) % 6]) head_tail(nh - 1);

  // ---- the tile's dB and dC: bf16, or fp32 sums for the tiles' merge ----
  const size_t plane = (size_t)p.batch * p.T * p.G * NN;
#pragma unroll
  for (int i = 0; i < kNI; ++i) {
    const int nb = cq + 4 * i;
    if (nb >= n16) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = 16 * nb + 8 * t + 2 * qc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? r1 : r0;
        if (row >= len) continue;
        const size_t o = (((size_t)bi * p.T + t0 + row) * p.G + g) * NN + q;
        if (p.nt == 1) {
          *reinterpret_cast<uint32_t*>(p.db + o) =
              pack_bf16(gb[i][t][2 * r], gb[i][t][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(p.dc + o) =
              pack_bf16(gc[i][t][2 * r], gc[i][t][2 * r + 1]);
        } else {
          float* const out = p.part_bc + (size_t)tile * 2 * plane + o;
          *reinterpret_cast<float2*>(out) =
              make_float2(gb[i][t][2 * r], gb[i][t][2 * r + 1]);
          *reinterpret_cast<float2*>(out + plane) =
              make_float2(gc[i][t][2 * r], gc[i][t][2 * r + 1]);
        }
      }
    }
  }

  // ---- the merges, each by the last block to count itself on a counter
  // that the walk zeroed, in a fixed order: where a group's heads are split over tiles,
  // the chunk's dB and dC, the tiles' fp32 sums added in ascending tile
  // order; dA of the tile's heads, the shares of every (batch row, chunk).
  // The counters order the reads, not the sums ----
  __threadfence();   // this block's sums are visible before it counts
  __syncthreads();
  if (tid == 0) {
    int* const cnt_bc = p.count + p.G * p.nt + ((size_t)bi * p.nc + c) * p.G + g;
    flags[0] = p.nt > 1 && atomicAdd(cnt_bc, 1) == p.nt - 1;
    flags[1] = atomicAdd(p.count + g * p.nt + tile, 1) == p.batch * p.nc - 1;
  }
  __syncthreads();
  if (flags[0]) {
    __threadfence();
    const int n2 = NN / 2;
    for (int e = tid; e < len * n2; e += kThreads2) {
      const int j = e / n2, q = (e - j * n2) * 2;
      const size_t o = (((size_t)bi * p.T + t0 + j) * p.G + g) * NN + q;
      float2 vb = make_float2(0.f, 0.f), vc = make_float2(0.f, 0.f);
      for (int tl = 0; tl < p.nt; ++tl) {
        const float* const in = p.part_bc + (size_t)tl * 2 * plane + o;
        const float2 b2 = __ldcg(reinterpret_cast<const float2*>(in));
        const float2 c2 = __ldcg(reinterpret_cast<const float2*>(in + plane));
        vb.x += b2.x; vb.y += b2.y;
        vc.x += c2.x; vc.y += c2.y;
      }
      *reinterpret_cast<uint32_t*>(p.db + o) = pack_bf16(vb.x, vb.y);
      *reinterpret_cast<uint32_t*>(p.dc + o) = pack_bf16(vc.x, vc.y);
    }
  }
  if (flags[1]) {
    // a warp a head: lane l sums the shares l, l + 32, ... of the (batch
    // row, chunk) order, then the lanes' sums by a fixed tree
    __threadfence();
    for (int hh = warp; hh < nh; hh += kWarps2) {
      const int h = h0 + hh;
      float v = 0.f;
      for (int r = lane; r < p.batch * p.nc; r += 32)
        v += __ldcg(p.part_a + (size_t)r * p.H + h);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (lane == 0) p.dA[h] = v;
    }
  }
}

// Raises kKernel's dynamic shared memory limit to `bytes` once per device,
// so that a call spends no host time on it.
template <auto kKernel>
bool attr_set(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
  if (!done[dev]) {
    if (cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return false;
    done[dev] = true;
  }
  return true;
}

int kernel_p(int P) { return P <= 16 ? 16 : P <= 32 ? 32 : P <= 64 ? 64 : 128; }

int smem_for(int pass, int P, int N) {
  switch (kernel_p(P)) {
    case 16: return pass == 1 ? Smem1<16>::bytes : Smem2<16>(N).bytes();
    case 32: return pass == 1 ? Smem1<32>::bytes : Smem2<32>(N).bytes();
    case 64: return pass == 1 ? Smem1<64>::bytes : Smem2<64>(N).bytes();
    default: return pass == 1 ? Smem1<128>::bytes : Smem2<128>(N).bytes();
  }
}

template <int kP>
int launch_dstate(const Params& p, cudaStream_t stream) {
  // the TMA map dS' is stored through: (N, P, 2 nc, B H) bf16, boxes of
  // the block's 64 columns by a warp's 16 rows
  CUtensorMap tds{};
  const cuuint64_t dims[4] = {(cuuint64_t)p.N, (cuuint64_t)p.P,
                              2 * (cuuint64_t)p.nc, (cuuint64_t)p.batch * p.H};
  const cuuint32_t box[4] = {(cuuint32_t)kCols1, 16, 1, 1};
  if (!hopper::make_map(&tds, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.dstates,
                        dims, box))
    return (int)cudaErrorInvalidValue;
  using Ly = Smem1<kP>;
  const dim3 grid((p.N + kCols1 - 1) / kCols1, p.H, p.batch);
  if (p.N % kCols1 == 0 && p.P == kP) {
    if (!attr_set<ssd_bwd_dstate_kernel<kP, true>>(Ly::bytes))
      return (int)cudaErrorInvalidValue;
    ssd_bwd_dstate_kernel<kP, true><<<grid, 32 * Ly::kWarps, Ly::bytes, stream>>>(tds, p);
  } else {
    if (!attr_set<ssd_bwd_dstate_kernel<kP, false>>(Ly::bytes))
      return (int)cudaErrorInvalidValue;
    ssd_bwd_dstate_kernel<kP, false><<<grid, 32 * Ly::kWarps, Ly::bytes, stream>>>(tds, p);
  }
  return (int)cudaGetLastError();
}

template <int kP>
int launch_chunk(const Params& p, cudaStream_t stream) {
  // TMA maps of the start states (N, P, 2 (nc - 1), B H) and of dS' (N, P,
  // 2 nc, B H), bf16, boxes of 64 columns by a slice's rows
  CUtensorMap ts{}, td{};
  const cuuint32_t box[4] = {64, (cuuint32_t)Smem2<kP>::kPS, 1, 1};
  const cuuint64_t dims_s[4] = {(cuuint64_t)p.N, (cuuint64_t)p.P,
                                2 * (cuuint64_t)(p.nc - 1),
                                (cuuint64_t)p.batch * p.H};
  const cuuint64_t dims_d[4] = {dims_s[0], dims_s[1], 2 * (cuuint64_t)p.nc,
                                dims_s[3]};
  if ((p.nc > 1 && !hopper::make_map(&ts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                     p.starts, dims_s, box)) ||
      !hopper::make_map(&td, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.dstates,
                        dims_d, box))
    return (int)cudaErrorInvalidValue;
  const int bytes = Smem2<kP>(p.N).bytes();
  const dim3 grid(p.G * p.nt, p.nc, p.batch);
  if (p.N == 128 && p.P == kP) {
    if (!attr_set<ssd_bwd_chunk_kernel<kP, true>>(kMaxSmem))
      return (int)cudaErrorInvalidValue;
    ssd_bwd_chunk_kernel<kP, true><<<grid, kThreads2, bytes, stream>>>(ts, td, p);
  } else {
    if (!attr_set<ssd_bwd_chunk_kernel<kP, false>>(kMaxSmem))
      return (int)cudaErrorInvalidValue;
    ssd_bwd_chunk_kernel<kP, false><<<grid, kThreads2, bytes, stream>>>(ts, td, p);
  }
  return (int)cudaGetLastError();
}

// The passes in `passes` (1: the dS' walk, 2: the chunk pass), in order.
template <int kP>
int launch(const Params& p, int passes, cudaStream_t stream) {
  if (passes & 1) {
    const int rc = launch_dstate<kP>(p, stream);
    if (rc != 0) return rc;
  }
  return (passes & 2) ? launch_chunk<kP>(p, stream) : 0;
}

}  // namespace

// The dynamic shared memory of pass 1 (the dS' walk) or 2 (the chunk
// pass) at (P, N), in bytes.
extern "C" int ssd_bwd_smem(int pass, int P, int N) { return smem_for(pass, P, N); }

// x and dy (B,T,H,P), B and C (B,T,G,N) bf16 with their last axis
// contiguous and rows 16-byte aligned; dt (B,T,H) and A (H,) fp32; starts
// K4's chunk_state (B,H,ceil(T/64) - 1,2,P,N) bf16 contiguous; init and
// dfinal null or fp32 (B,H,P,N) contiguous. Outputs, contiguous: dx
// (B,T,H,P) bf16, ddt (B,T,H) fp32, dA (H,) fp32, db and dc (B,T,G,N)
// bf16, dinit (B,H,P,N) fp32. Workspace, written before it is read:
// dstates bf16 (B,H,ceil(T/64),2,P,N); part_bc fp32 (nt,2,B,T,G,N) where
// nt > 1 (else null); part_a fp32 (B,ceil(T/64),H); count int32 G nt + B
// ceil(T/64) G, which the walk zeroes. ht heads a tile, nt = ceil((H / G)
// / ht) tiles a group. Launches the passes in `passes` on `stream`: 3, the
// walk and the chunk pass, as the backward does; 1 and then 2 in two calls
// on the same buffers, to time each. Checks each launch and returns a CUDA
// error code (0: launched).
extern "C" int ssd_bwd_bf16(
    const void* x, const void* dt, const void* A, const void* b,
    const void* c, const void* dy, const void* starts, const void* init,
    const void* dfinal, void* dstates, void* dx, void* ddt, void* dA,
    void* db, void* dc, void* dinit, void* part_bc, void* part_a, void* count,
    int batch, int T, int H, int G, int P, int N, int ht, int passes,
    long long sx_b, long long sx_t,
    long long sx_h, long long sdt_b, long long sdt_t, long long sdt_h,
    long long sb_b, long long sb_t, long long sb_g, long long sc_b,
    long long sc_t, long long sc_g, long long sdy_b, long long sdy_t,
    long long sdy_h, void* stream) {
  if (batch <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || P % 16 != 0 || P > 128 || N % 16 != 0 || N > 128 ||
      batch > 65535 || ht <= 0 || (T + kL - 1) / kL > 65535 ||
      passes < 1 || passes > 3 ||
      smem_for(2, P, N) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.rep = H / G;
  p.ht = ht;
  p.nt = (p.rep + ht - 1) / ht;
  if (p.nt > 1 && part_bc == nullptr) return (int)cudaErrorInvalidValue;
  p.x = static_cast<const uint16_t*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.b = static_cast<const uint16_t*>(b);
  p.c = static_cast<const uint16_t*>(c);
  p.dy = static_cast<const uint16_t*>(dy);
  p.starts = static_cast<const uint16_t*>(starts);
  p.init = static_cast<const float*>(init);
  p.dfinal = static_cast<const float*>(dfinal);
  p.dstates = static_cast<uint16_t*>(dstates);
  p.dx = static_cast<uint16_t*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.db = static_cast<uint16_t*>(db);
  p.dc = static_cast<uint16_t*>(dc);
  p.dinit = static_cast<float*>(dinit);
  p.part_bc = static_cast<float*>(part_bc);
  p.part_a = static_cast<float*>(part_a);
  p.count = static_cast<int*>(count);
  p.sx_b = sx_b; p.sx_t = sx_t; p.sx_h = sx_h;
  p.sdt_b = sdt_b; p.sdt_t = sdt_t; p.sdt_h = sdt_h;
  p.sb_b = sb_b; p.sb_t = sb_t; p.sb_g = sb_g;
  p.sc_b = sc_b; p.sc_t = sc_t; p.sc_g = sc_g;
  p.sdy_b = sdy_b; p.sdy_t = sdy_t; p.sdy_h = sdy_h;
  p.batch = batch; p.T = T; p.H = H; p.G = G; p.P = P; p.N = N;
  p.nc = (T + kL - 1) / kL;
  p.ncount = G * p.nt + batch * p.nc * G;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kernel_p(P)) {
    case 16: return launch<16>(p, passes, st);
    case 32: return launch<32>(p, passes, st);
    case 64: return launch<64>(p, passes, st);
    default: return launch<128>(p, passes, st);
  }
}
