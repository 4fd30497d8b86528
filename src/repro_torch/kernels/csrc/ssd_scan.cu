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
// Two kernels, one per input type: bf16 (the serve path) on the tensor cores,
// below; f32 on the CUDA cores (namespace simt, the kernel both types used
// before: one block per (head, batch) with the f32 state in shared memory),
// which matches the plain version to summation order where TF32 would not.
//
// What both do differently from the TPU design: CUDA blocks run in parallel
// and in no order, so the TPU grid's sequential chunk axis, whose VMEM scratch
// carried the state, becomes a loop over chunks inside a block. Every decay
// is exp of a difference of cumulative sums, never a ratio of exps: with
// dt ~ 0.75 and A = -1, cum falls to about -96 within a chunk of 128, past
// f32's exp underflow; the sums run in f64 (an f32 tree scan was off by 4e-4
// at |y| ~ 1e2). x, B and C are read in place from the (B, S, conv_ch)
// activation the model splits them from (batch and position strides), B and
// C by group h / (nh / g); Q, hd and ds pad to multiples of 16 with zeros
// (dt = 0 in the padding, so cum stays flat).
//
// Bound at the serve shape (mamba2-130m prefill, B 4, S 1024, nh 24, hd 64,
// ds 128, g 1, bf16): bytes = x in + y out (12.58 MB each) + B and C
// (2.10 MB) + dt in f32 (0.39 MB) + h out in f32 (3.15 MB) = 30.8 MB, 9.2 us
// at 3.35 TB/s; the work the algorithm needs (C Bᵀ and its product with x·dt
// over the causal half of each tile, C hᵀ and the state update in full) is
// 5.66 GFLOP, 5.7 us at 989 TFLOP/s (H100 SXM data sheet, 700 W): bytes-bound.
//
// The bf16 kernel, and what it does about what held that SIMT kernel back
// (f32 FMA from shared memory, 96 blocks, one 199 KB block a SM, no overlap,
// a cumsum that stalled the block):
//   - Tensor cores: the four products run as mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) from ldmatrix fragments of bf16 tiles. C Bᵀ has bf16
//     operands, so it is f32 up to summation order, as the Pallas kernel
//     keeps it. The three products with an f32 operand (C Bᵀ ⊙ L · dt
//     against x, C against h, x·w against B) split that operand into a bf16
//     high part and residual, two products into one f32 sum, so the bf16
//     output stays within 1e-4 of the f32 plain version beyond its rounding.
//   - The card filled: y[:, d] and h[d, :] depend only on x[:, d], so a block
//     owns a slice of SW = 32 columns of hd: grid (hd slices, nh, Bb), 192
//     blocks at the serve shape. Each slice recomputes C Bᵀ and the decays.
//     B, C and x are staged in bf16 (104,448 B a block), so two blocks share
//     an SM; the state (a 16 x 32 tile a warp) stays in registers, with a
//     bf16 high/residual copy in shared memory for C hᵀ.
//   - Overlap: chunk c + 1's C loads (cp.async) while chunk c's state is
//     updated, and its B and x as soon as chunk c is done with them; dt of
//     chunk c + 1 is read into registers when chunk c starts.
//   - The cumsum: warp 0, whose rows of the causal triangle are the lightest,
//     scans chunk c + 1 (f64, as before) while the other warps finish chunk
//     c's rows, so it no longer holds the block. Warps w and w + 4, which
//     share a scheduler, own a light and a heavy 16-row block of the
//     triangle.
//   - Host: the shared-memory attribute is set once.
//   - Exps: ex2.approx (the SFU) on log2-scaled sums; below a warp's 16-row
//     diagonal block a decay factors into 2^(cum_i - cum_i0) 2^(cum_i0 -
//     cum_t), both <= 1, one exp per key and per row instead of one per
//     pair; the diagonal block keeps one exp per pair (its factors could
//     overflow).
//
// Measured (chip_smoke.py, scripts/kernel_ab.py and scripts/kernel_ablate.py;
// NVIDIA H100 80GB HBM3, 700 W): 0.0964-0.0973 ms at the serve shape (device
// time of a CUDA graph), 9.5 % of the bound, against 0.702-0.712 ms for the
// SIMT kernel timed in turns in the same call; 0.105 ms with its loops not
// unrolled. Without the state update it takes 19 % less, without the
// intra-chunk term 36 % less, and with the loads, scans and barriers alone
// 37 % of the time: each block reads B and C (64 KB
// a chunk) for its own 32 columns, so the 48 blocks of a batch read the same
// B and C from L2 (192 blocks x 8 chunks x 64 KB = 98 MB of loads, against
// the 30.8 MB the kernel must move), and B and x of the next chunk load only
// after the state update.
//
// Left on the table: B and C shared by the blocks of a batch (TMA multicast
// over a cluster); C Bᵀ recomputed for each hd slice; mma.sync, not wgmma;
// the chunk loop is serial within a block (the chunk-parallel three-pass
// layout was not needed for the 0.1 ms target).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int QMAX = 128;  // longest chunk
constexpr int HDMAX = 64;
constexpr int DSMAX = 128;

__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// ================================================================ f32: SIMT FMA

namespace simt {

constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int RT = 64;        // rows of a score tile


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


}  // namespace simt

// ================================================ bf16: tensor cores, hd slices

namespace tc {

constexpr int THREADS = 256;   // 8 warps
constexpr int SW = 32;         // columns of hd a block owns (its slice)
constexpr int LDB = DSMAX + 8;  // row pitch (bf16) of sB, sC, sHhi, sHlo: ldmatrix rows on
constexpr int LDX = SW + 8;     // distinct banks; row pitch of sX

// Dynamic shared memory (bytes): B, C and the x slice of a chunk in bf16, the
// slice's state as a bf16 high part and residual, two buffers each of dt,
// cum (log2 units) and w = dt exp(cum_last - cum), and each warp's decays.
constexpr int SMEM =
    2 * (2 * QMAX * LDB + QMAX * LDX + 2 * SW * LDB) + 4 * (3 * 2 * QMAX + THREADS / 32 * QMAX);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 2^x by the SFU's approximation (relative error about 2^-22); decays below
// 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += (a_hi + a_lo) b: an f32 left operand in f32 precision, residual first
__device__ __forceinline__ void mma2(float (&d)[4], const unsigned (&hi)[4],
                                     const unsigned (&lo)[4], unsigned b0, unsigned b1) {
  mma(d, lo, b0, b1);
  mma(d, hi, b0, b1);
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
// Two f32 values as a bf16 pair `hi` plus the bf16 pair of what `hi` missed
// (about 16 bits of mantissa together: within 2^-17 of f32 in a product).
__device__ __forceinline__ void split(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}
// a bf16 pair times two f32 weights, split as above
__device__ __forceinline__ void scale_split(unsigned pair, float w0, float w1, unsigned& hi,
                                            unsigned& lo) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pair));
  split(v.x * w0, v.y * w1, hi, lo);
}

// Rows [0, rows_pad) and columns [0, cols_pad) of a bf16 tile with row pitch
// ld: src[r * stride + c] where r < rows and c < cols, else 0. vec: 16-byte
// cp.async copies (rows 16-byte aligned, cols a multiple of 8), left in
// flight; else plain loads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long stride, int rows, int rows_pad, int cols,
                                          int cols_pad, bool vec) {
  if (vec) {
    const int chunks = cols_pad / 8;
    for (int e = threadIdx.x; e < rows_pad * chunks; e += THREADS) {
      const int r = e / chunks, c = (e % chunks) * 8;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * ld + c, src + (in ? r * stride + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < rows_pad * cols_pad; e += THREADS) {
      const int r = e / cols_pad, c = e % cols_pad;
      dst[r * ld + c] = r < rows && c < cols ? src[r * stride + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// One warp, lane l: dt of steps 4 l .. 4 l + 3 of a chunk (0 past Q).
__device__ __forceinline__ void load_dt(const float* dtc, int nh, int Q, float (&d)[QMAX / 32]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    const int t = lane * (QMAX / 32) + k;
    d[k] = t < Q ? dtc[(long)t * nh] : 0.f;
  }
}

// One warp: dt, cum = inclusive cumsum(dt A) in log2 units and
// w = dt exp(cum_last - cum) of one chunk. The sum runs in f64 (four steps a
// lane, then a scan of the lanes' sums), so each cum is f32's rounding of the
// exact sum and exp of a difference keeps its relative accuracy where cum
// falls to about -96.
__device__ __forceinline__ void chunk_scan(const float (&d)[QMAX / 32], float a_rate, float* sDt,
                                           float* sCum, float* sW) {
  constexpr double LOG2E_D = 1.4426950408889634;
  const int lane = threadIdx.x % 32;
  double v[QMAX / 32], run = 0.0;
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    run += (double)(d[k] * a_rate);
    v[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double last = __shfl_sync(0xffffffffu, incl, 31);  // padded steps add 0
#pragma unroll
  for (int k = 0; k < QMAX / 32; ++k) {
    const int t = lane * (QMAX / 32) + k;
    const double cum = excl + v[k];
    sDt[t] = d[k];
    sCum[t] = (float)(cum * LOG2E_D);
    sW[t] = d[k] * exp2_approx((float)((last - cum) * LOG2E_D));
  }
}

// Grid (hd slices, nh, Bb). Per chunk of Q steps, with cum in log2 units:
//   y   = (C hᵀ) · 2^cum + (C Bᵀ ⊙ L · dt) x,   L[i][t] = 2^(cum_i - cum_t), t <= i
//   h  <- h · 2^cum_last + (x w)ᵀ B
// Warp layout (mma.m16n8k16, lane = 4 g + t): for y, a warp owns 16 rows of
// the chunk (warps w and w + 4, which share a scheduler, take rows light and
// heavy in the causal triangle); for h, a 16 x 32 tile of the slice's
// (32, ds) state, kept in registers from chunk to chunk. FULL: Q and ds are
// 128 (the serve shape), so every loop over them unrolls.
template <bool FULL>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_tc(const __nv_bfloat16* __restrict__ x, long xsb, long xss,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const __nv_bfloat16* __restrict__ Bm, long bsb, long bss,
                  const __nv_bfloat16* __restrict__ Cm, long csb, long css,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ hout, int S, int nh, int hd,
                  int g, int ds, int Q, int vec) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem_tc);  // [QMAX][LDB]  B[t][s]
  __nv_bfloat16* sC = sB + QMAX * LDB;                          // [QMAX][LDB]  C[i][s]
  __nv_bfloat16* sX = sC + QMAX * LDB;                          // [QMAX][LDX]  x[t][d]
  __nv_bfloat16* sHhi = sX + QMAX * LDX;                        // [SW][LDB]    h[d][s]
  __nv_bfloat16* sHlo = sHhi + SW * LDB;
  float* sDt = reinterpret_cast<float*>(sHlo + SW * LDB);  // [2][QMAX]
  float* sCum = sDt + 2 * QMAX;                            // [2][QMAX]
  float* sW = sCum + 2 * QMAX;                             // [2][QMAX]
  float* sKd = sW + 2 * QMAX;                              // [warps][QMAX]

  const int QP = FULL ? QMAX : up16(Q), DSP = FULL ? DSMAX : up16(ds);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;     // fragment row and column pair
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: which 8x8 matrix, which of its rows
  const int d0 = blockIdx.x * SW, head = blockIdx.y, b = blockIdx.z;
  const int nd = min(SW, hd - d0);            // columns of the slice inside hd
  const int grp = head / (nh / g);
  const float a_rate = A[head];
  const int chunks = S / Q;

  const __nv_bfloat16* xb = x + b * xsb + (long)head * hd + d0;
  const __nv_bfloat16* bb = Bm + b * bsb + (long)grp * ds;
  const __nv_bfloat16* cb = Cm + b * csb + (long)grp * ds;
  const float* dtb = dt + (long)b * S * nh + head;
  __nv_bfloat16* yb = y + ((long)b * S * nh + head) * hd + d0;
  const long y_row = (long)nh * hd;

  // rows of y this warp owns, and its tile of the state
  const int rb = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * rb;
  const int hr = 16 * (warp & 1), hc = 32 * (warp >> 1);

  load_tile(sB, LDB, bb, bss, Q, QP, ds, DSP, vec);
  load_tile(sC, LDB, cb, css, Q, QP, ds, DSP, vec);
  load_tile(sX, LDX, xb, xss, Q, QP, nd, SW, vec);
  cp_async_commit();
  if (warp == 0) {
    float d[QMAX / 32];
    load_dt(dtb, nh, Q, d);
    chunk_scan(d, a_rate, sDt, sCum, sW);
  }

  float hacc[4][4];  // state rows hr + gq (+8), columns hc + 8 j + 2 tq (+1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    const float* cDt = sDt + cur * QMAX;
    const float* cCum = sCum + cur * QMAX;
    const float* cW = sW + cur * QMAX;
    cp_async_wait_all();
    __syncthreads();  // chunk c's B, C, x, scan, and the state h before it are in place
    float dt_next[QMAX / 32];  // warp 0 scans the next chunk after its rows of y
    if (warp == 0 && c + 1 < chunks) load_dt(dtb + (long)(c + 1) * Q * nh, nh, Q, dt_next);

    if (i0 < QP) {
      float yacc[SW / 8][4];
#pragma unroll
      for (int n = 0; n < SW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
      const float cum_r[2] = {cCum[i0 + gq], cCum[i0 + gq + 8]};
      // below the warp's diagonal block (t < i0) a decay factors into two that
      // are both <= 1: L[i][t] dt_t = 2^(cum_i - cum_i0) (dt_t 2^(cum_i0 - cum_t))
      float* kd = sKd + warp * QMAX;
      for (int tt = lane; tt < i0; tt += 32) kd[tt] = cDt[tt] * exp2_approx(cCum[i0] - cCum[tt]);
      __syncwarp();
      const float rdec[2] = {exp2_approx(cum_r[0] - cCum[i0]), exp2_approx(cum_r[1] - cCum[i0])};

      // the carried state's term, C hᵀ, times 2^cum_i (h is 0 before chunk 0);
      // h's bf16 high part and residual are two products into one f32 sum
      if (c > 0) {
#pragma unroll
        for (int ks = 0; ks < DSP / 16; ++ks) {
          unsigned cf[4];
          ldsm_x4(cf, sC + (i0 + lane % 16) * LDB + ks * 16 + (lane / 16) * 8);
#pragma unroll
          for (int dp = 0; dp < SW / 16; ++dp) {
            unsigned hh[4], hl[4];
            const int off = (dp * 16 + mrow + (mat / 2) * 8) * LDB + ks * 16 + (mat % 2) * 8;
            ldsm_x4(hh, sHhi + off);
            ldsm_x4(hl, sHlo + off);
            mma(yacc[2 * dp], cf, hl[0], hl[1]);
            mma(yacc[2 * dp], cf, hh[0], hh[1]);
            mma(yacc[2 * dp + 1], cf, hl[2], hl[3]);
            mma(yacc[2 * dp + 1], cf, hh[2], hh[3]);
          }
        }
        const float decay[2] = {exp2_approx(cum_r[0]), exp2_approx(cum_r[1])};
#pragma unroll
        for (int n = 0; n < SW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) yacc[n][e] *= decay[e / 2];
      }

      // the intra-chunk term in two halves of 64 keys: G = C Bᵀ (bf16 in,
      // exact products), M = G ⊙ L · dt in f32, y += M x with M split
#pragma unroll
      for (int th = 0; th < 2; ++th) {
        const int t0 = 64 * th;
        if (t0 >= QP || t0 > i0 + 15) continue;  // keys past the chunk or this warp's rows
        float sg[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sg[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DSP / 16; ++ks) {
          unsigned cf[4];
          ldsm_x4(cf, sC + (i0 + lane % 16) * LDB + ks * 16 + (lane / 16) * 8);
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {  // two key n-tiles per ldmatrix.x4
            if (t0 + 16 * jp > i0 + 15 || t0 + 16 * jp >= QP) continue;
            unsigned bf[4];
            ldsm_x4(bf, sB + (t0 + 16 * jp + mrow + (mat / 2) * 8) * LDB + ks * 16 + (mat % 2) * 8);
            mma(sg[2 * jp], cf, bf[0], bf[1]);
            mma(sg[2 * jp + 1], cf, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k8 = t0 + 8 * j;
          if (k8 + 8 <= i0) {
            const float2 w2 = *reinterpret_cast<const float2*>(kd + k8 + 2 * tq);
            sg[j][0] *= rdec[0] * w2.x;
            sg[j][1] *= rdec[0] * w2.y;
            sg[j][2] *= rdec[1] * w2.x;
            sg[j][3] *= rdec[1] * w2.y;
          } else if (k8 < i0 + 16) {  // the diagonal block: masked, one exp each
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tt = k8 + 2 * tq + (e % 2), ii = i0 + gq + 8 * (e / 2);
              sg[j][e] = tt <= ii ? sg[j][e] * exp2_approx(cum_r[e / 2] - cCum[tt]) * cDt[tt] : 0.f;
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (t0 + 16 * kk > i0 + 15) continue;
          unsigned mh[4], ml[4];
          split(sg[2 * kk][0], sg[2 * kk][1], mh[0], ml[0]);
          split(sg[2 * kk][2], sg[2 * kk][3], mh[1], ml[1]);
          split(sg[2 * kk + 1][0], sg[2 * kk + 1][1], mh[2], ml[2]);
          split(sg[2 * kk + 1][2], sg[2 * kk + 1][3], mh[3], ml[3]);
#pragma unroll
          for (int dp = 0; dp < SW / 16; ++dp) {
            unsigned xf[4];
            ldsm_x4_t(xf, sX + (t0 + 16 * kk + mrow + (mat % 2) * 8) * LDX + dp * 16 +
                              (mat / 2) * 8);
            mma2(yacc[2 * dp], mh, ml, xf[0], xf[1]);
            mma2(yacc[2 * dp + 1], mh, ml, xf[2], xf[3]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + gq + 8 * r;
        if (i >= Q) continue;
        __nv_bfloat16* yr = yb + (long)(c * Q + i) * y_row;
#pragma unroll
        for (int n = 0; n < SW / 8; ++n) {
          const int d = 8 * n + 2 * tq;
          if (d + 1 < nd && hd % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(yr + d) =
                __floats2bfloat162_rn(yacc[n][2 * r], yacc[n][2 * r + 1]);
          } else {
            if (d < nd) yr[d] = __float2bfloat16_rn(yacc[n][2 * r]);
            if (d + 1 < nd) yr[d + 1] = __float2bfloat16_rn(yacc[n][2 * r + 1]);
          }
        }
      }
    }
    // warp 0, whose rows are the lightest, scans the next chunk meanwhile
    if (warp == 0 && c + 1 < chunks)
      chunk_scan(dt_next, a_rate, sDt + (cur ^ 1) * QMAX, sCum + (cur ^ 1) * QMAX,
                 sW + (cur ^ 1) * QMAX);
    __syncthreads();  // every warp is done with sC and with the state's copy in sHhi, sHlo
    if (c + 1 < chunks) {  // the next chunk's C loads while the state is updated
      load_tile(sC, LDB, cb + (long)(c + 1) * Q * css, css, Q, QP, ds, DSP, vec);
      cp_async_commit();
    }

    // h <- h 2^cum_last + (x w)ᵀ B on this warp's 16 x 32 tile: A = (x w)ᵀ from
    // x by ldmatrix.trans, times w, split; B = B[t][s] by ldmatrix.trans
    if (hc < DSP) {
      const float total = exp2_approx(cCum[QP - 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= total;
#pragma unroll
      for (int kt = 0; kt < QP / 16; ++kt) {
        unsigned xa[4], ah[4], al[4];
        ldsm_x4_t(xa, sX + (16 * kt + (mat / 2) * 8 + mrow) * LDX + hr + (mat % 2) * 8);
        const int t = 16 * kt + 2 * tq;
        scale_split(xa[0], cW[t], cW[t + 1], ah[0], al[0]);
        scale_split(xa[1], cW[t], cW[t + 1], ah[1], al[1]);
        scale_split(xa[2], cW[t + 8], cW[t + 9], ah[2], al[2]);
        scale_split(xa[3], cW[t + 8], cW[t + 9], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (hc + 16 * np >= DSP) continue;
          unsigned bf[4];
          ldsm_x4_t(bf, sB + (16 * kt + mrow + (mat % 2) * 8) * LDB + hc + 16 * np + (mat / 2) * 8);
          mma2(hacc[2 * np], ah, al, bf[0], bf[1]);
          mma2(hacc[2 * np + 1], ah, al, bf[2], bf[3]);
        }
      }
      // the new state's copy for the next chunk's C hᵀ
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (hr + gq + 8 * r) * LDB + hc + 8 * j + 2 * tq;
          unsigned hi, lo;
          split(hacc[j][2 * r], hacc[j][2 * r + 1], hi, lo);
          *reinterpret_cast<unsigned*>(sHhi + o) = hi;
          *reinterpret_cast<unsigned*>(sHlo + o) = lo;
        }
    }
    __syncthreads();  // every warp is done with sB and sX
    if (c + 1 < chunks) {
      load_tile(sB, LDB, bb + (long)(c + 1) * Q * bss, bss, Q, QP, ds, DSP, vec);
      load_tile(sX, LDX, xb + (long)(c + 1) * Q * xss, xss, Q, QP, nd, SW, vec);
      cp_async_commit();
    }
  }

  // the final state of the slice, f32
  float* hb = hout + (((long)b * nh + head) * hd + d0) * ds;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = hr + gq + 8 * (e / 2), s = hc + 8 * j + 2 * tq + (e % 2);
      if (d < nd && s < ds) hb[(long)d * ds + s] = hacc[j][e];
    }
}

cudaError_t launch(const void* x, long xsb, long xss, const float* dt, const float* A,
                   const void* B, long bsb, long bss, const void* C, long csb, long css, void* y,
                   float* h, int Bb, int S, int nh, int hd, int g, int ds, int Q,
                   cudaStream_t stream) {
  const bool full = Q == QMAX && ds == DSMAX;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(ssd_chunk_scan_tc<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM),
      cudaFuncSetAttribute(ssd_chunk_scan_tc<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM)};
  if (attr[full] != cudaSuccess) return attr[full];
  // 16-byte copies when every row of x, B and C starts on 16 bytes and the
  // columns a block reads come in whole 16-byte chunks
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = a16(x) && a16(B) && a16(C) && xsb % 8 == 0 && xss % 8 == 0 && bsb % 8 == 0 &&
                   bss % 8 == 0 && csb % 8 == 0 && css % 8 == 0 && hd % 8 == 0 && ds % 8 == 0;
  const dim3 grid((hd + SW - 1) / SW, nh, Bb);
  const auto kernel = full ? ssd_chunk_scan_tc<true> : ssd_chunk_scan_tc<false>;
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), xsb, xss, dt, A, static_cast<const __nv_bfloat16*>(B),
      bsb, bss, static_cast<const __nv_bfloat16*>(C), csb, css, static_cast<__nv_bfloat16*>(y), h,
      S, nh, hd, g, ds, Q, (int)vec);
  return cudaGetLastError();
}

}  // namespace tc

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
  return (int)(is_bf16 ? tc::launch(x, xsb, xss, dt, A, B, bsb, bss, C, csb, css, y, h, Bb, S, nh,
                                    hd, g, ds, Q, st)
                       : simt::launch<float>(x, xsb, xss, dt, A, B, bsb, bss, C, csb, css, y, h,
                                             Bb, S, nh, hd, g, ds, Q, st));
}

// The launch of `is_bf16`'s kernel at these shapes, into out[3]: blocks,
// threads a block, dynamic shared memory a block (bytes).
extern "C" int ssd_scan_plan(int Bb, int nh, int hd, int ds, int Q, int is_bf16, int* out) {
  if (is_bf16) {
    out[0] = (hd + tc::SW - 1) / tc::SW * nh * Bb;
    out[1] = tc::THREADS;
    out[2] = tc::SMEM;
  } else {
    out[0] = nh * Bb;
    out[1] = simt::THREADS;
    out[2] = (int)(sizeof(float) * simt::layout(Q, hd, ds).total);
  }
  return 0;
}
