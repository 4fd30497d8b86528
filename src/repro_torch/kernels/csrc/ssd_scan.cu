// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (wrapper
// ssd_scan, with the D-skip added by kernels/ops.py::mamba_ssd), the Pallas
// mirror of repro/models/ssm.py::ssd_chunked. It computes the same function,
// every operand upcast to f32: per chunk of Q steps, with a = dt * A and
// cum = inclusive cumsum(a),
//   y = (C Bᵀ ⊙ L) (x·dt) + (C hᵀ) · exp(cum),   L[i][t] = exp(cum_i - cum_t), t <= i
//   h <- h · exp(cum_last) + (x·dt·exp(cum_last - cum))ᵀ B
// with an f32 (hd, ds) state carried from chunk to chunk. y comes back in
// x's dtype, and the final state h (Bb, nh, hd, ds) in f32, which
// ssd_chunked returns and the Pallas kernel drops.
//
// Design (simple and right first; SIMT f32 FMA, no tensor cores):
//   - One block per (head, batch), looping over the chunks in order: the
//     TPU grid's sequential chunk axis, whose VMEM scratch carried the
//     state, becomes a loop inside the block, with the state in shared
//     memory. At the serve shape (B 4, nh 24) that is 96 blocks on the
//     H100's 132 SMs: a quarter of the card idles. The chunk-parallel
//     three-pass layout is for a later PR.
//   - Every decay is exp of a difference of cumulative sums, never a ratio
//     of exps: with dt ~ 0.75 and A = -1, cum falls to about -96 within one
//     chunk of 128, past f32's exp underflow.
//   - Shared memory: B and x of the chunk (f32, converted once on load), the
//     (hd, ds) state, and C and the score tile for 64 rows at a time, not
//     all Q: at Q 128, hd 64, ds 128 that is 199,424 bytes, where staging
//     the whole Q x Q score tile and C as well would pass the 227 KB a block
//     may have. Rows of B, C and h are padded to an odd length so that
//     threads reading one column touch distinct banks.
//   - Score tiles wholly above the causal diagonal are skipped (the first
//     64-row tile reads only the first 64 keys).
//   - x, B and C are read in place from the (B, S, conv_ch) activation that
//     the model splits them from: the kernel takes their batch and position
//     strides, so the wrapper makes no copy. B and C come with g groups; head
//     h reads group h / (nh / g), so they are not repeated for every head.
//   - Q, hd and ds are padded to multiples of 16 with zeros (dt = 0 in the
//     padding, so cum stays flat and padded steps add nothing).
//
// Bound at the serve shape (mamba2-130m prefill, B 4, S 1024, nh 24, hd 64,
// ds 128, g 1, bf16): bytes = x in + y out (12.58 MB each) + B and C
// (2.10 MB) + dt in f32 (0.39 MB) + h out in f32 (3.15 MB) = 30.8 MB, 9.2 us
// at 3.35 TB/s; the work the algorithm needs (C Bᵀ and its product with x·dt
// over the causal half of each tile, C hᵀ and the state update in full) is
// 5.66 GFLOP, 5.7 us at 989 TFLOP/s (H100 SXM published peaks, 700 W). So it
// is bytes-bound. This kernel does its arithmetic on the CUDA cores
// (67 TFLOP/s f32) from shared memory, one scalar load for every two or three
// FMAs, in 96 blocks: chip_smoke.py timed it at 0.70 ms on an NVIDIA H100
// 80GB HBM3 at 700 W, 1.3 % of the bound. A later PR moves the three
// products to the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int QMAX = 128;     // longest chunk
constexpr int RT = 64;        // rows of a score tile
constexpr int HDMAX = 64;
constexpr int DSMAX = 128;

__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// Offsets (in floats) into dynamic shared memory.
struct Layout {
  int ldb;  // row length of sB, sC and sH: ds padded, plus one (odd)
  int ldx;  // row length of sX: hd padded
  int ldp;  // row length of sP: Q padded, plus one
  int b, x, h, c, p, dt, cum, w, total;
};

__host__ __device__ inline Layout layout(int Q, int hd, int ds) {
  const int QP = up16(Q), HDP = up16(hd), DSP = up16(ds);
  Layout L;
  L.ldb = DSP + 1;
  L.ldx = HDP;
  L.ldp = QP + 1;
  L.b = 0;                  // [QP][ldb]  B of the chunk
  L.x = L.b + QP * L.ldb;   // [QP][ldx]  x of the chunk
  L.h = L.x + QP * L.ldx;   // [HDP][ldb] the state
  L.c = L.h + HDP * L.ldb;  // [RT][ldb]  C of a row tile
  L.p = L.c + RT * L.ldb;   // [RT][ldp]  (C Bᵀ ⊙ L) · dt of a row tile
  L.dt = L.p + RT * L.ldp;  // [QP]
  L.cum = L.dt + QP;        // [QP]       inclusive cumsum of dt * A
  L.w = L.cum + QP;         // [QP]       dt_t exp(cum_last - cum_t)
  L.total = L.w + QP;
  return L;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x: (Bb, S, nh, hd) at strides (xsb, xss, hd, 1); B, C: (Bb, S, g, ds) at
// strides (bsb, bss, ds, 1) and (csb, css, ds, 1); dt: (Bb, S, nh) f32,
// contiguous; A: (nh,) f32; y: (Bb, S, nh, hd) contiguous; h: (Bb, nh, hd, ds)
// f32 contiguous. Grid (nh, Bb).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_scan(const T* __restrict__ x, long xsb, long xss, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm, long bsb, long bss,
             const T* __restrict__ Cm, long csb, long css, T* __restrict__ y,
             float* __restrict__ hout, int S, int nh, int hd, int g, int ds, int Q) {
  extern __shared__ float smem[];
  const Layout L = layout(Q, hd, ds);
  float* sB = smem + L.b;
  float* sX = smem + L.x;
  float* sH = smem + L.h;
  float* sC = smem + L.c;
  float* sP = smem + L.p;
  float* sDt = smem + L.dt;
  float* sCum = smem + L.cum;
  float* sW = smem + L.w;

  const int QP = up16(Q), HDP = up16(hd), DSP = up16(ds);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int head = blockIdx.x, b = blockIdx.y;
  const int grp = head / (nh / g);
  const float a_rate = A[head];

  const T* xb = x + b * xsb + (long)head * hd;
  const T* bb = Bm + b * bsb + (long)grp * ds;
  const T* cb = Cm + b * csb + (long)grp * ds;
  const float* dtb = dt + (long)b * S * nh + head;
  T* yb = y + ((long)b * S * nh + head) * hd;

  for (int e = tid; e < HDP * L.ldb; e += THREADS) sH[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is done with sB, sX, sH, sW
    for (int e = tid; e < QP * DSP; e += THREADS) {
      const int t = e / DSP, s = e % DSP;
      sB[t * L.ldb + s] = (t < Q && s < ds) ? to_f32(bb[(c0 + t) * bss + s]) : 0.f;
    }
    for (int e = tid; e < QP * HDP; e += THREADS) {
      const int t = e / HDP, d = e % HDP;
      sX[t * L.ldx + d] = (t < Q && d < hd) ? to_f32(xb[(c0 + t) * xss + d]) : 0.f;
    }
    for (int t = tid; t < QP; t += THREADS) sDt[t] = t < Q ? dtb[(long)(c0 + t) * nh] : 0.f;
    __syncthreads();

    // inclusive cumsum of dt * A by warp 0, in f64: four steps a lane, then a
    // scan of the lanes' sums. Each cum is then f32's rounding of the exact
    // sum, so exp(cum_i - cum_t) keeps its relative accuracy where cum falls
    // to about -96; an f32 tree scan there was off by 4e-4 at |y| ~ 1e2.
    if (tid < 32) {
      double v[QMAX / 32], run = 0.0;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int t = tid * (QMAX / 32) + k;
        run += t < QP ? (double)(sDt[t] * a_rate) : 0.0;
        v[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0;
#pragma unroll
      for (int k = 0; k < QMAX / 32; ++k) {
        const int t = tid * (QMAX / 32) + k;
        if (t < QP) sCum[t] = (float)(excl + v[k]);
      }
    }
    __syncthreads();
    const float cum_last = sCum[QP - 1];  // padded steps add 0
    for (int t = tid; t < QP; t += THREADS) sW[t] = sDt[t] * expf(cum_last - sCum[t]);

    for (int i0 = 0; i0 < QP; i0 += RT) {
      const int tcount = min(QP, i0 + RT);  // keys t <= i of this tile's rows
      const int nb = tcount / 16;
      if (i0 > 0) __syncthreads();  // the previous tile is done with sC and sP
      for (int e = tid; e < RT * DSP; e += THREADS) {
        const int r = e / DSP, s = e % DSP, i = i0 + r;
        sC[r * L.ldb + s] = (i < Q && s < ds) ? to_f32(cb[(c0 + i) * css + s]) : 0.f;
      }
      __syncthreads();

      // scores of rows ty + 16a against keys tx + 16b, times L and dt
      float acc[4][QMAX / 16];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < QMAX / 16; ++j) acc[a][j] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float cv[4], bv[QMAX / 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * L.ldb + s];
#pragma unroll
        for (int j = 0; j < QMAX / 16; ++j)
          bv[j] = j < nb ? sB[(tx + 16 * j) * L.ldb + s] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < QMAX / 16; ++j) acc[a][j] = fmaf(cv[a], bv[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
        for (int j = 0; j < QMAX / 16; ++j) {
          const int t = tx + 16 * j;
          if (j < nb)
            sP[il * L.ldp + t] =
                (t <= i && i < QP) ? acc[a][j] * expf(sCum[i] - sCum[t]) * sDt[t] : 0.f;
        }
      }
      __syncthreads();

      // y of rows ty + 16a, columns tx + 16c: the intra-chunk term, then the
      // carried state's
      float yi[4][HDMAX / 16], yh[4][HDMAX / 16];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < HDMAX / 16; ++c) yi[a][c] = yh[a][c] = 0.f;
      for (int t = 0; t < tcount; ++t) {
        float pv[4], xv[HDMAX / 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) pv[a] = sP[(ty + 16 * a) * L.ldp + t];
#pragma unroll
        for (int c = 0; c < HDMAX / 16; ++c)
          xv[c] = 16 * c < HDP ? sX[t * L.ldx + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < HDMAX / 16; ++c) yi[a][c] = fmaf(pv[a], xv[c], yi[a][c]);
      }
      if (c0 > 0) {  // h is 0 before the first chunk
        for (int s = 0; s < ds; ++s) {
          float cv[4], hv[HDMAX / 16];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = sC[(ty + 16 * a) * L.ldb + s];
#pragma unroll
          for (int c = 0; c < HDMAX / 16; ++c)
            hv[c] = 16 * c < HDP ? sH[(tx + 16 * c) * L.ldb + s] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < HDMAX / 16; ++c) yh[a][c] = fmaf(cv[a], hv[c], yh[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
        const float decay_in = expf(sCum[i]);
#pragma unroll
        for (int c = 0; c < HDMAX / 16; ++c) {
          const int d = tx + 16 * c;
          if (d < hd) store(&yb[(long)(c0 + i) * nh * hd + d], yi[a][c] + yh[a][c] * decay_in);
        }
      }
    }
    __syncthreads();  // every row tile is done reading sH

    // h <- h exp(cum_last) + Σ_t x_t w_t B_tᵀ, rows ty + 16a, columns tx + 16j
    float hn[HDMAX / 16][DSMAX / 16];
#pragma unroll
    for (int a = 0; a < HDMAX / 16; ++a)
#pragma unroll
      for (int j = 0; j < DSMAX / 16; ++j) hn[a][j] = 0.f;
    for (int t = 0; t < QP; ++t) {
      const float w = sW[t];
      float xw[HDMAX / 16], bv[DSMAX / 16];
#pragma unroll
      for (int a = 0; a < HDMAX / 16; ++a)
        xw[a] = 16 * a < HDP ? sX[t * L.ldx + ty + 16 * a] * w : 0.f;
#pragma unroll
      for (int j = 0; j < DSMAX / 16; ++j) bv[j] = 16 * j < DSP ? sB[t * L.ldb + tx + 16 * j] : 0.f;
#pragma unroll
      for (int a = 0; a < HDMAX / 16; ++a)
#pragma unroll
        for (int j = 0; j < DSMAX / 16; ++j) hn[a][j] = fmaf(xw[a], bv[j], hn[a][j]);
    }
    const float total = expf(cum_last);
#pragma unroll
    for (int a = 0; a < HDMAX / 16; ++a)
#pragma unroll
      for (int j = 0; j < DSMAX / 16; ++j)
        if (16 * a < HDP && 16 * j < DSP) {
          float* hp = &sH[(ty + 16 * a) * L.ldb + tx + 16 * j];
          *hp = *hp * total + hn[a][j];
        }
  }
  __syncthreads();

  float* hb = hout + ((long)b * nh + head) * hd * ds;
  for (int e = tid; e < hd * ds; e += THREADS) hb[e] = sH[(e / ds) * L.ldb + e % ds];
}

template <typename T>
cudaError_t launch(const void* x, long xsb, long xss, const float* dt, const float* A,
                   const void* B, long bsb, long bss, const void* C, long csb, long css, void* y,
                   float* h, int Bb, int S, int nh, int hd, int g, int ds, int Q,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * layout(Q, hd, ds).total;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<T><<<dim3(nh, Bb), THREADS, smem, stream>>>(
      static_cast<const T*>(x), xsb, xss, dt, A, static_cast<const T*>(B), bsb, bss,
      static_cast<const T*>(C), csb, css, static_cast<T*>(y), h, S, nh, hd, g, ds, Q);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements. x, B and C share one dtype (is_bf16: bfloat16,
// else float32); Q divides S, Q <= 128, hd <= 64, ds <= 128, g divides nh.
// Launches on `stream` and returns cudaGetLastError() as an int (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, long xsb, long xss, const float* dt, const float* A,
                            const void* B, long bsb, long bss, const void* C, long csb,
                            long css, void* y, float* h, int Bb, int S, int nh, int hd, int g,
                            int ds, int Q, int is_bf16, void* stream) {
  if (Bb <= 0 || S <= 0 || nh <= 0 || g <= 0 || nh % g != 0 || hd <= 0 || hd > HDMAX ||
      ds <= 0 || ds > DSMAX || Q <= 0 || Q > QMAX || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, xsb, xss, dt, A, B, bsb, bss, C, csb, css, y,
                                               h, Bb, S, nh, hd, g, ds, Q, st)
                       : launch<float>(x, xsb, xss, dt, A, B, bsb, bss, C, csb, css, y, h, Bb,
                                       S, nh, hd, g, ds, Q, st));
}

// Dynamic shared memory one block takes at chunk Q, head size hd and state
// size ds (bytes).
extern "C" int ssd_scan_smem_bytes(int Q, int hd, int ds) {
  return (int)(sizeof(float) * layout(Q, hd, ds).total);
}
