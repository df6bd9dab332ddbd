// K4 — Mamba2 SSD forward (the chunked scan) for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunked` in src/repro/kernels/ssd.py
// (pl.pallas_call at :114, body `_ssd_kernel` at :31).
//
// What it computes, for x (B,T,H,P) bf16, dt (B,T,H) fp32 (> 0), A (H,) fp32
// (< 0), B/C (B,T,G,N) bf16 read at group h / (H / G), from a zero state:
// per chunk of kChunk steps, with a = dt·A and cum its in-chunk prefix sum,
//   y     = ((C Bᵀ) ∘ L ∘ dt) x + e^{max(cum, -60)} ∘ (C stateᵀ)
//           L[i][j] = e^{clip(cum_i - cum_j, -60, 0)} for j <= i, else 0
//   state = e^{max(a_tot, -60)} state + xᵀ (B ∘ e^{clip(a_tot - cum, -60, 0)} dt)
// y (B,T,H,P) in bf16, the final state (B,H,P,N) in fp32. The clips are the
// reference's (`ssd.py:63, :74, :80, :85`). Every product runs in fp32 FMA
// from fp32 copies in shared memory, as the reference computes them from
// fp32 copies; the chunking is exact algebra, so only rounding (and where
// the -60 clips bite, far under the tolerance) differs from its 128-step
// chunks. Any T works: x, dt, B and C are zero-filled past T in the last
// chunk, so its padded steps add no decay (a = 0) and nothing to the state
// (dt = 0), and y is stored only below T. x, dt, B and C are read through
// their batch, time and head (group) strides, so the slices of the conv
// output that `mamba_fwd` passes need no copy; the last axis of x, B and C
// must be contiguous. y and the state are written contiguous.
//
// Design. The TPU grid runs its chunk axis in order and carries the state
// in VMEM scratch across grid steps. Here one block per (head, batch row)
// loops over the chunks itself and keeps the (P, N) fp32 state in shared
// memory for the whole sequence (32 KB at mamba2-130m's P 64, N 128); it
// writes the state once, after the last chunk. Blocks never communicate, so
// the result is deterministic. Per chunk, 256 threads: one warp scans
// cum = cumsum(dt·A) in fp32 (shuffles, two steps per lane); then each
// thread computes a 4 × 4 register tile of W = (C Bᵀ) ∘ L ∘ dt, then a 4 × 4
// tile of y, then a 4 × 8 tile of the state update, each from float4 reads
// of shared rows padded by 4 floats so that the rows a quarter-warp reads
// fall on distinct banks. The chunk length is 64, not the reference's 128:
// shared memory holds x, B, C, W and the state in fp32 (137 KB at P 64,
// N 128; 128 steps would need 258 KB), and the in-chunk work per step,
// 2 kChunk (N + P) FLOPs, halves with it.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM), at the
// mamba2-130m serve shape (B 8, T 2048, H 24, P 64, N 128, G 1): about
// 23 GFLOP at kChunk 64 (0.023 ms) against 117 MB of x, y, B, C, dt and
// the state (0.035 ms), so by bytes, with operations close behind. This
// first kernel is far from either: its products run on the fp32 FMA pipes
// and its operands come from shared memory, one block of 137 KB per SM, and
// 192 blocks fill 132 SMs in 1.5 waves. Not yet done: bf16 tensor-core
// products (mma/wgmma) for C Bᵀ, and a chunk-parallel three-pass design
// (chunk states, then the scan over chunks, then y) that puts B · T / 64
// blocks in flight instead of B · H.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;            // floats added to every shared row

struct Params {
  const __nv_bfloat16* x;
  const float* dt;
  const float* A;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  __nv_bfloat16* y;
  float* state;
  long long sx_b, sx_t, sx_h;      // element strides
  long long sdt_b, sdt_t, sdt_h;
  long long sb_b, sb_t, sb_g;
  long long sc_b, sc_t, sc_g;
  int T, H, G, P, N;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int kChunk>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const Params p) {
  static_assert(kChunk == 64, "the scan gives each lane two steps and the "
                "W tile maps 16 x 4 rows");
  const int h = blockIdx.x, bi = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int P = p.P, N = p.N, PQ = P / 4, NQ = N / 8;
  const int sx = P + kPad, sn = N + kPad, sw = kChunk + kPad;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [kChunk][sx]  x
  float* bs = xs + kChunk * sx;                  // [kChunk][sn]  B
  float* cs = bs + kChunk * sn;                  // [kChunk][sn]  C
  float* ss = cs + kChunk * sn;                  // [P][sn]       the state
  float* ws = ss + P * sn;                       // [kChunk][sw]  W
  float* dts = ws + kChunk * sw;                 // [kChunk]      dt
  float* cum = dts + kChunk;                     // [kChunk]      cumsum(dt·A)
  float* cdec = cum + kChunk;                    // [kChunk]      e^{max(cum,-60)}
  float* u = cdec + kChunk;                      // [kChunk]      decay to end · dt

  for (int e = tid; e < P * sn; e += kThreads) ss[e] = 0.f;
  const float a_h = p.A[h];
  const __nv_bfloat16* xb = p.x + bi * p.sx_b + h * p.sx_h;
  const float* dtb = p.dt + bi * p.sdt_b + h * p.sdt_h;
  const __nv_bfloat16* bb = p.b + bi * p.sb_b + g * p.sb_g;
  const __nv_bfloat16* cb = p.c + bi * p.sc_b + g * p.sc_g;

  for (int t0 = 0; t0 < p.T; t0 += kChunk) {
    const int len = min(kChunk, p.T - t0);
    // ---- load the chunk in fp32, zeros past T
    for (int e = tid; e < kChunk * P; e += kThreads) {
      const int i = e / P, q = e - i * P;
      xs[i * sx + q] = i < len
          ? __bfloat162float(xb[(t0 + i) * p.sx_t + q]) : 0.f;
    }
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      const bool in = i < len;
      bs[i * sn + n] = in ? __bfloat162float(bb[(t0 + i) * p.sb_t + n]) : 0.f;
      cs[i * sn + n] = in ? __bfloat162float(cb[(t0 + i) * p.sc_t + n]) : 0.f;
    }
    if (tid < kChunk) dts[tid] = tid < len ? dtb[(t0 + tid) * p.sdt_t] : 0.f;
    __syncthreads();

    // ---- cum = cumsum(dt·A): one warp, steps 2l and 2l + 1 on lane l
    if (tid < 32) {
      const float a0 = dts[2 * tid] * a_h, a1 = dts[2 * tid + 1] * a_h;
      float s = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) excl = 0.f;
      const float a_tot = __shfl_sync(0xffffffffu, s, 31);
      const float c0 = excl + a0;
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = s;
      cdec[2 * tid] = expf(fmaxf(c0, -60.f));
      cdec[2 * tid + 1] = expf(fmaxf(s, -60.f));
      u[2 * tid] = expf(fminf(fmaxf(a_tot - c0, -60.f), 0.f)) * dts[2 * tid];
      u[2 * tid + 1] = expf(fminf(fmaxf(a_tot - s, -60.f), 0.f))
                       * dts[2 * tid + 1];
    }
    __syncthreads();

    // ---- W = (C Bᵀ) ∘ L ∘ dt: rows ti + 16 r, columns tj + 16 c
    {
      const int ti = tid >> 4, tj = tid & 15;
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ti + 16 * r) * sn + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = ld4(bs + (tj + 16 * c) * sn + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = dot4(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          float w = 0.f;
          if (j <= i)
            w = acc[r][c] * expf(fminf(fmaxf(cum[i] - cum[j], -60.f), 0.f))
                * dts[j];
          ws[i * sw + j] = w;
        }
    }
    __syncthreads();

    // ---- y = W x + e^{cum} ∘ (C stateᵀ): rows ti + 16 r, columns tp + PQ c
    for (int wi = tid; wi < 16 * PQ; wi += kThreads) {
      const int ti = wi / PQ, tp = wi - ti * PQ;
      float acc[4][4] = {}, st[4][4] = {};
      for (int j = 0; j < kChunk; j += 4) {
        float4 wv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = ld4(ws + (ti + 16 * r) * sw + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = xs[(j + jj) * sx + tp + PQ * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(comp(wv[r], jj), xv[c], acc[r][c]);
        }
      }
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ti + 16 * r) * sn + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = ld4(ss + (tp + PQ * c) * sn + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[r][c] = dot4(cv[r], sv[c], st[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= len) continue;
        __nv_bfloat16* yrow =
            p.y + (((long long)bi * p.T + t0 + i) * p.H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          yrow[tp + PQ * c] =
              __float2bfloat16(fmaf(cdec[i], st[r][c], acc[r][c]));
      }
    }
    __syncthreads();

    // ---- state = e^{a_tot} state + xᵀ (B ∘ u): rows tp + PQ r, columns
    // 4 tn .. 4 tn + 3 and N / 2 + 4 tn .. N / 2 + 4 tn + 3
    {
      const float decay = expf(fmaxf(cum[kChunk - 1], -60.f));
      for (int wi = tid; wi < PQ * NQ; wi += kThreads) {
        const int tp = wi / NQ, tn = wi - tp * NQ;
        const int n0 = 4 * tn, n1 = N / 2 + 4 * tn;
        float acc[4][8] = {};
        for (int j = 0; j < kChunk; ++j) {
          const float uj = u[j];
          const float4 b0 = ld4(bs + j * sn + n0), b1 = ld4(bs + j * sn + n1);
          const float bv[8] = {b0.x * uj, b0.y * uj, b0.z * uj, b0.w * uj,
                               b1.x * uj, b1.y * uj, b1.z * uj, b1.w * uj};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float xv = xs[j * sx + tp + PQ * r];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(xv, bv[k], acc[r][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* s0 = reinterpret_cast<float4*>(ss + (tp + PQ * r) * sn + n0);
          float4* s1 = reinterpret_cast<float4*>(ss + (tp + PQ * r) * sn + n1);
          float4 v0 = *s0, v1 = *s1;
          v0.x = fmaf(v0.x, decay, acc[r][0]);
          v0.y = fmaf(v0.y, decay, acc[r][1]);
          v0.z = fmaf(v0.z, decay, acc[r][2]);
          v0.w = fmaf(v0.w, decay, acc[r][3]);
          v1.x = fmaf(v1.x, decay, acc[r][4]);
          v1.y = fmaf(v1.y, decay, acc[r][5]);
          v1.z = fmaf(v1.z, decay, acc[r][6]);
          v1.w = fmaf(v1.w, decay, acc[r][7]);
          *s0 = v0;
          *s1 = v1;
        }
      }
    }
    __syncthreads();
  }

  float* out = p.state + ((long long)bi * p.H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    out[e] = ss[q * sn + n];
  }
}

constexpr int kChunkLen = 64;

// Shared memory of one block, in bytes. Past what a block may have,
// cudaFuncSetAttribute refuses it and the launcher returns its error.
int smem_bytes(int P, int N) {
  const int c = kChunkLen;
  return 4 * (c * (P + kPad) + 2 * c * (N + kPad) + P * (N + kPad)
              + c * (c + kPad) + 4 * c);
}

}  // namespace

extern "C" int ssd_fwd_bf16(const void* x, const void* dt, const void* A,
                            const void* b, const void* c, void* y, void* state,
                            int batch, int T, int H, int G, int P, int N,
                            long long sx_b, long long sx_t, long long sx_h,
                            long long sdt_b, long long sdt_t, long long sdt_h,
                            long long sb_b, long long sb_t, long long sb_g,
                            long long sc_b, long long sc_t, long long sc_g,
                            void* stream) {
  if (batch <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || P % 4 != 0 || N % 8 != 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.c = static_cast<const __nv_bfloat16*>(c);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.state = static_cast<float*>(state);
  p.sx_b = sx_b; p.sx_t = sx_t; p.sx_h = sx_h;
  p.sdt_b = sdt_b; p.sdt_t = sdt_t; p.sdt_h = sdt_h;
  p.sb_b = sb_b; p.sb_t = sb_t; p.sb_g = sb_g;
  p.sc_b = sc_b; p.sc_t = sc_t; p.sc_g = sc_g;
  p.T = T; p.H = H; p.G = G; p.P = P; p.N = N;
  const int bytes = smem_bytes(P, N);
  // above 48 KB only when asked for; set per launch, as it is per device
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<kChunkLen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<kChunkLen><<<dim3(H, batch), kThreads, bytes,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
