// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (wrapper flash_attention, reached through kernels/ops.py::gqa_flash_attention
// when cfg.attn_impl == "pallas"). It computes the same function: scores
// (q k^T) * hd^-0.5, a causal mask with an optional window k > q - window
// (the window only when causal), masked scores -1e30, an online softmax with
// an f32 running max, denominator and (bq, hd) accumulator, denom =
// max(l, 1e-30), and the output in the input dtype.
//
// Two kernels, one per input type:
//   - bf16 (the serve path): both products on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate). Four warps own 16 query
//     rows each of a 64-row Q tile; K and V tiles of 64 keys arrive by
//     cp.async into a two-stage ring in shared memory, so the next tile loads
//     while this one is computed. P V keeps P in f32 precision, as the TPU
//     kernel does: P goes to the tensor cores as a bf16 high part plus a bf16
//     residual, two products into one f32 accumulator (V is bf16, so exact).
//   - f32: f32 FMA on the CUDA cores, 256 threads each owning a 4 x 4 block
//     of the 64 x 64 score tile, so the f32 result matches the plain version
//     to summation order (tensor-core TF32 would not).
//
// What differs from the TPU design, in both:
//   - One CUDA block per (q tile, head, batch). The TPU grid's sequential K
//     axis, whose VMEM scratch carried the softmax state, becomes a loop over
//     K tiles inside the block; the state lives in registers.
//   - q/k/v are read in their (B, S, H|KV, hd) layout, and query head h reads
//     KV head h / (H / KV): no transpose copies and no repeated KV heads.
//   - K tiles fully above the causal diagonal, or fully below the window, are
//     skipped. A ragged last tile (S not a multiple of 64) is masked: rows past
//     S are neither read nor written, keys past S score -1e30.
//   - The heaviest causal q tiles (those near the end of the sequence) are
//     issued first, so the short ones fill the tail of the wave.
//
// Bound at the serve slice's shapes (qwen2-1.5b prefill, B=4, S=512, H=12,
// KV=2, hd=128, bf16, causal): FLOPs = 4 * B * H * hd * S(S+1)/2 = 3.23 GFLOP
// (about 2 * B * H * S^2 * hd); bytes = q + o (6.29 MB each) + k + v (1.05 MB
// each, read once thanks to the GQA indexing) = 14.7 MB. At the H100 SXM's
// published peaks (989 TFLOP/s bf16, 3.35 TB/s, 700 W) that is
// max(3.3 us, 4.4 us) = 4.4 us: memory-bound at this short prompt.
//
// What this simple design leaves on the table: mma.sync reaches about two
// thirds of the tensor cores' rate, where wgmma reaches all of it; P V in
// two bf16 products costs half as many tensor-core operations again as one
// (P in bf16 would halve that, at a bf16 rounding of every weight); every
// thread issues its own cp.async copies instead of one TMA copy per tile;
// the 6 query heads that share a KV head each load it again (from L2);
// 384 blocks of 64 rows fill the 132 SMs in about 1.5 waves, with causal
// tiles of unequal length. A later PR moves to wgmma with TMA loads and a
// persistent, warp-specialised schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;  // query rows of a tile
constexpr int BK = 64;  // keys of a tile

// Key tiles a q tile visits: [begin, end).
__device__ __forceinline__ void key_tiles(int q0, int S, int causal, int window, int& begin,
                                          int& end) {
  begin = 0;
  end = (S + BK - 1) / BK;
  if (causal) {
    end = min(end, (min(q0 + BQ, S) - 1) / BK + 1);
    if (window > 0) begin = max(0, q0 - window + 1) / BK;
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int S, int causal, int window) {
  bool k = kp < S;
  if (causal) {
    k = k && kp <= qp;
    if (window > 0) k = k && kp > qp - window;
  }
  return k;
}

// ============================================================ bf16: mma.sync

namespace tc {

constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int PAD = 8;        // bf16 elements of row padding: ldmatrix rows fall on distinct banks

__host__ __device__ constexpr int ld(int hd) { return hd + PAD; }
// Q tile, then two stages of K and of V
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return sizeof(__nv_bfloat16) * (BQ + 4 * BK) * ld(hd);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (then nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// Two f32 values as a bf16 pair `hi` plus the bf16 pair of what `hi` missed:
// hi + lo keeps about 16 bits of each value's mantissa, so P V on the tensor
// cores as two bf16 products is within about 2^-17 of P V in f32.
__device__ __forceinline__ void split(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// rows [row0, row0 + n) of a (S, *, HD) operand into a tile of row length ld(HD)
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long row_stride, int row0, int n, int S) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < n * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8, s = row0 + r;
    const bool in = s < S;
    cp_async16(dst + r * ld(HD) + col, src + (in ? s : 0) * row_stride + col, in);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. An accumulator
// holds rows g and g + 8, columns 2t and 2t + 1 of its 16 x 8 tile.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int H,
              int KV, int causal, int window, float scale_log2) {
  constexpr int LD = ld(HD);
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int DT = HD / 8;       // 8-wide column tiles of O
  constexpr int NT = BK / 8;       // 8-wide key tiles of S
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BQ][LD]
  __nv_bfloat16* sK = sQ + BQ * LD;                              // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * BK * LD;                          // [2][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: which 8x8 matrix, which of its rows
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;

  const long q_row = (long)H * HD;  // elements between consecutive positions
  const long kv_row = (long)KV * HD;
  const __nv_bfloat16* qb = q + ((long)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((long)b * S * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long)b * S * KV + kvh) * HD;
  __nv_bfloat16* ob = o + ((long)b * S * H + h) * HD;

  int kt_begin, kt_end;
  key_tiles(q0, S, causal, window, kt_begin, kt_end);

  load_rows<HD>(sQ, qb, q_row, q0, BQ, S);
  load_rows<HD>(sK, kb, kv_row, kt_begin * BK, BK, S);
  load_rows<HD>(sV, vb, kv_row, kt_begin * BK, BK, S);
  cp_async_commit();

  unsigned qf[KSTEPS][4];
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int row0 = q0 + warp * 16 + g;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile loads while this one is computed
      load_rows<HD>(sK + (stage ^ 1) * BK * LD, kb, kv_row, (kt + 1) * BK, BK, S);
      load_rows<HD>(sV + (stage ^ 1) * BK * LD, vb, kv_row, (kt + 1) * BK, BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(qf[ks], sQ + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* cK = sK + stage * BK * LD;
    const __nv_bfloat16* cV = sV + stage * BK * LD;

    // S = Q K^T: this warp's 16 rows against the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {  // two key tiles per ldmatrix.x4
        unsigned kf[4];
        ldsm_x4(kf, cK + (jp * 16 + mrow + (mat / 2) * 8) * LD + ks * 16 + (mat % 2) * 8);
        mma(s[2 * jp], qf[ks], kf[0], kf[1]);
        mma(s[2 * jp + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // online softmax in the log2 domain: scores and m carry a factor log2e, so
    // exp2 of their differences is exp of the true ones
    const int k0 = kt * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + (e / 2) * 8, kp = k0 + j * 8 + 2 * t + (e % 2);
        s[j][e] = keep(qp, kp, S, causal, window) ? s[j][e] * scale_log2 : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = corr[i] * l[i] + sum[i];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= corr[e / 2];

    // O += P V in f32 precision: two key tiles of P form one A fragment, split
    // into a bf16 high part and a bf16 residual, each multiplied by V (bf16,
    // exact) on the tensor cores into the f32 accumulator
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {  // two column tiles per ldmatrix.x4.trans
        unsigned vf[4];
        ldsm_x4_t(vf, cV + (kk * 16 + mrow + (mat % 2) * 8) * LD + dp * 16 + (mat / 2) * 8);
        mma(acc[2 * dp], pl, vf[0], vf[1]);
        mma(acc[2 * dp], ph, vf[0], vf[1]);
        mma(acc[2 * dp + 1], pl, vf[2], vf[3]);
        mma(acc[2 * dp + 1], ph, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles from now
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int sp = row0 + i * 8;
    if (sp >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(&ob[sp * q_row + d * 8 + 2 * t]) =
          __floats2bfloat162_rn(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HD);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_mma<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, KV, causal,
      window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

// =============================================================== f32: SIMT FMA

namespace simt {

constexpr int THREADS = 256;  // 16 x 16 threads: ty owns 4 query rows, tx 4 keys
constexpr int PAD = 4;        // row padding of transposed tiles (keeps float4 alignment)
constexpr int LQ = BQ + PAD;  // row length of sQt and of sPt
constexpr int LK = BK + PAD;  // row length of sKt

static_assert(BQ == 16 * 4 && BK == 16 * 4, "a thread owns a 4 x 4 score tile");
static_assert(LQ == LK, "P^T ([BK][LQ]) is staged in the K tile's rows ([HD][LK])");

// Max and sum over the 16 lanes that share ty (one half of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows of the space shared by the K tile ([HD][LK]) and P^T ([BK][LQ]).
__host__ __device__ constexpr int kp_rows(int hd) { return hd > BK ? hd : BK; }

__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return sizeof(float) * (hd * LQ + kp_rows(hd) * LK + BK * hd);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
              int causal, int window, float scale) {
  constexpr int NC = HD / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [HD][LQ]  Q tile, transposed
  float* sKt = sQt + HD * LQ;                    // [HD][LK]  K tile, transposed
  float* sV = sKt + kp_rows(HD) * LK;            // [BK][HD]  V tile
  float* sPt = sKt;                              // [BK][LQ]  P^T, once the scores are read

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;

  const long q_row = (long)H * HD;   // elements between consecutive positions
  const long kv_row = (long)KV * HD;
  const float* qb = q + ((long)b * S * H + h) * HD;
  const float* kb = k + ((long)b * S * KV + kvh) * HD;
  const float* vb = v + ((long)b * S * KV + kvh) * HD;
  float* ob = o + ((long)b * S * H + h) * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    sQt[d * LQ + r] = s < S ? qb[s * q_row + d] : 0.f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int kt_begin, kt_end;
  key_tiles(q0, S, causal, window, kt_begin, kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P^T and V are no longer read
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, s = k0 + r;
      const bool in = s < S;
      sKt[d * LK + r] = in ? kb[s * kv_row + d] : 0.f;
      sV[r * HD + d] = in ? vb[s * kv_row + d] : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4+i against keys tx*4+j
    float sc[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQt[d * LQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&sKt[d * LK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = keep(qp, k0 + tx * 4 + j, S, causal, window) ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l[i] = corr * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread has read sKt: its space now takes P^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPt[(tx * 4 + j) * LQ + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(&sPt[kk * LQ + ty * 4]);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[s * q_row + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HD);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_simt<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace simt

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*, void*, int, int, int, int,
                                 int, int, float, cudaStream_t);

// The launcher of `is_bf16`'s kernel at head size hd, or nullptr.
LaunchFn launcher(int hd, int is_bf16) {
  switch (hd) {
#define REPRO_HD(N) \
  case N:           \
    return is_bf16 ? tc::launch<N> : simt::launch<N>;
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(48)
    REPRO_HD(64)
    REPRO_HD(80)
    REPRO_HD(96)
    REPRO_HD(112)
    REPRO_HD(128)
#undef REPRO_HD
    default:
      return nullptr;
  }
}

}  // namespace

// q: (B, S, H, hd); k, v: (B, S, KV, hd); o: (B, S, H, hd); all contiguous,
// of one dtype (is_bf16: bfloat16, else float32), bf16 pointers 16-byte
// aligned. hd is a multiple of 16 up to 128 and H a multiple of KV. Launches
// on `stream` and returns cudaGetLastError() as an int (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int KV, int hd, int causal, int window,
                                   float scale, int is_bf16, void* stream) {
  const LaunchFn fn = launcher(hd, is_bf16);
  if (fn == nullptr || B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  return (int)fn(q, k, v, o, B, S, H, KV, causal, window, scale,
                 static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one block of the kernel for `is_bf16` takes at head
// size hd (bytes).
extern "C" int flash_attention_smem_bytes(int hd, int is_bf16) {
  return (int)(is_bf16 ? tc::smem_bytes(hd) : simt::smem_bytes(hd));
}
