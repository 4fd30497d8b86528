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
//   - bf16 (the serve path): TMA loads and wgmma, below.
//   - f32: f32 FMA on the CUDA cores, 256 threads each owning a 4 x 4 block
//     of the 64 x 64 score tile, so the f32 result matches the plain version
//     to summation order (TF32 would not pass its 2e-5 gate). One block per
//     (64-row q tile, head, batch), the softmax state in registers.
//
// What both do differently from the TPU design: CUDA blocks run in parallel
// and in no order, so the TPU grid's sequential K axis, whose VMEM scratch
// carried the softmax state, becomes a loop over K tiles inside a block; q/k/v
// are read in their (B, S, H|KV, hd) layout and query head h reads KV head
// h / (H / KV) (no repeated KV heads, no transposes); K tiles wholly above
// the causal diagonal or below the window are skipped; a ragged last tile is
// masked.
//
// Bound at the serve slice's shapes (qwen2-1.5b prefill: B 4, S 512, H 12,
// KV 2, hd 128, bf16, causal): 14.68 MB (q and o 6.29 MB each, k and v 1.05 MB
// each, read once) is 4.38 us at 3.35 TB/s; 3.23 GFLOP is 3.26 us at 989
// TFLOP/s (H100 SXM data sheet, 700 W). Memory-bound at this prompt length.
//
// The bf16 kernel, and what it does about what held its mma.sync predecessor
// back (128 threads and 87 KB of shared memory a block, each query head
// loading its K and V again, cp.async addresses computed by every thread):
//   - GQA: one block serves HEADS = 2 query heads of one KV head at one
//     64-row q tile, so each K and V tile is loaded once for both: a third of
//     the K/V traffic through L2 at G = 6. Two heads, not three or six: at the
//     causal serve shape a first build with three heads a block (128 blocks)
//     ran slower than with two (192 blocks) on the H100; with causal q tiles
//     of 1 to 8 K tiles, more and smaller blocks fill the 132 SMs better. Any
//     G works: the last block of a KV head leaves its second warpgroup idle
//     when G is odd.
//   - Loads: a producer warpgroup, of which one thread issues TMA copies
//     (a 4-D tensor map over (hd, heads, S, B), boxes of 64 rows x 64
//     columns, 128-byte swizzle) into a two-stage K/V ring with mbarriers.
//     TMA fills what lies past S or hd with zeros, so hd pads to 64 or 128
//     and the ragged tile needs no special load.
//   - wgmma: each consumer warpgroup (setmaxnreg 240, the producer 24) owns
//     its head's 64 query rows. S = Q K^T reads both operands from shared
//     memory (K-major); O += P V takes P from registers and V from shared
//     memory (MN-major), with P in f32 precision as a bf16 high part plus a
//     bf16 residual: two products into one f32 accumulator, as the
//     predecessor did, so the bf16 output stays within 1e-4 of the f32
//     plain version beyond its own rounding.
//   - Latency: the two consumer warpgroups interleave, one's softmax on the
//     CUDA cores beside the other's products on the tensor cores, and the
//     producer keeps the next tile's K and V in flight. The online softmax
//     is the predecessor's (log2 domain, -1e30, max(l, 1e-30)), with exp2
//     by the SFU's approximation; the mask, applied only on tiles that need
//     it, is two column bounds a row.
//   - Causal imbalance: a 1-D grid in which the q tile varies slowest, the
//     heaviest tiles first, so the first wave takes the longest blocks.
//   - Host: the shared-memory attribute is set once per kernel; each launch
//     encodes three tensor maps (cuTensorMapEncodeTiled, fetched from the
//     driver at first use).
//
// Measured (chip_smoke.py, scripts/kernel_ab.py and scripts/kernel_ablate.py;
// NVIDIA H100 80GB HBM3, 700 W): 0.0203-0.0206 ms at the serve shape (device
// time of a CUDA graph), 21.5 % of the bound, against 0.0426-0.0429 ms for
// the mma.sync predecessor timed in turns in the same call and 0.0176-0.0177
// ms for scaled_dot_product_attention (which rounds P to bf16). Not tensor-bound:
// without Q K^T at all it takes 9 % less, with one P V product instead of two
// 12 % less; each tile's chain of waits in the two warpgroups sets the pace.
// Tried on the card and dropped: three query heads a block, overlapping the
// softmax of tile i + 1 with P V of tile i inside a warpgroup, a ping-pong of
// the two warpgroups on named barriers, a third K/V stage, 128-key tiles
// (each as fast or slower).
//
// Left on the table: P V as two bf16 products costs half as many tensor-core
// operations again as one; two heads a block still load K and V three times
// per KV head at G = 6; no persistent schedule, so the heaviest causal q
// tiles (8 K tiles) set the critical path; the output is stored from
// registers, not by TMA.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ======================================================= bf16: TMA + wgmma

namespace wg {

constexpr int HEADS = 2;            // query heads a block: one consumer warpgroup each
constexpr int THREADS = 128 * (HEADS + 1);  // and one producer warpgroup
constexpr int STAGES = 2;           // K/V tiles in flight
constexpr int ATOM = 64;            // bf16 columns of one 128-byte swizzled row
constexpr int SUBTILE = 64 * 128;   // bytes of a 64-row x 64-column swizzled sub-tile
constexpr int MIN_SMEM = 116 * 1024;  // above half an SM's shared memory: one block per SM,
                                      // so setmaxnreg always finds the registers it asks for

template <int HDP>
__host__ __device__ constexpr int tile_bytes() {  // a 64-row x HDP-column tile
  return HDP / ATOM * SUBTILE;
}
// Q tiles of the block's heads, K and V rings, barriers; 1024 bytes of slack
// to align the base for the 128-byte swizzle
template <int HDP>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + (HEADS + 2 * STAGES) * tile_bytes<HDP>() + 8 * (1 + 3 * STAGES) > MIN_SMEM
             ? 1024 + (HEADS + 2 * STAGES) * tile_bytes<HDP>() + 8 * (1 + 3 * STAGES)
             : MIN_SMEM;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One (64 columns, 1, 64 rows, 1) box of a (B, S, N, hd) tensor into shared
// memory, 128-byte swizzled; what lies past hd or S arrives as zeros.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int col, int head, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte swizzled tiles (rows of 128
// bytes, groups of 8 rows 1024 bytes apart). K-major: the leading offset is
// unused. MN-major (V, read along its rows): a 64-column instruction covers
// one swizzle atom across, so only the 8-row stride is read; both offsets
// carry it.
__device__ __forceinline__ uint64_t desc_kmajor(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}
__device__ __forceinline__ uint64_t desc_mnmajor(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(1024 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a register across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }

// 2^x by the SFU's approximation (relative error about 2^-22); results below
// 2^-126 flush to 0, far under what the softmax's sums can see.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B, A and B in shared memory (both K-major), 64 x 64 x 16, f32 accumulate
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16) in registers, B in shared memory MN-major (trans-b), 64 x 64 x 16
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

// One query head's online softmax over a 64 x 64 score tile `sc` (wgmma
// layout, scaled to the log2 domain and masked here): updates the running
// max m and denominator l, returns the accumulator's correction in corr, and
// P in f32 precision as a bf16 high part and residual, the A fragments of
// P V (keys 16 kk .. 16 kk + 15 are n-tiles 2 kk and 2 kk + 1 of S).
__device__ __forceinline__ void softmax(float (&sc)[32], bool edge, int row0, int k0, int t, int S,
                                        int causal, int window, float scale_log2, float (&m)[2],
                                        float (&l)[2], float (&corr)[2], unsigned (&ph)[4][4],
                                        unsigned (&pl)[4][4]) {
  float mx[2] = {NEG_INF, NEG_INF};
  if (edge) {
    // keep() as column bounds of the tile: row r keeps columns lo[r] .. hi[r]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      hi[r] = (causal ? min(qp, S - 1) : S - 1) - k0;
      lo[r] = causal && window > 0 ? qp - window + 1 - k0 : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sc[4 * j + e];
        const int col = 8 * j + 2 * t + (e % 2);
        x = col < lo[e / 2] || col > hi[e / 2] ? NEG_INF : x * scale_log2;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] *= scale_log2;
      mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sc[e]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    sc[e] = exp2_approx(sc[e] - m[(e % 4) / 2]);
    sum[(e % 4) / 2] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = corr[r] * l[r] + sum[r];
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r], pl[kk][r]);
}

// Block = one 64-row q tile of HEADS query heads that share one KV head.
// Warpgroups 0..HEADS-1 consume, one query head each; warpgroup HEADS
// produces. Accumulator layout (wgmma m64nN): warp w of a warpgroup holds
// rows 16 w + g and 16 w + g + 8 (lane = 4 g + t); element 4 j + e is column
// 8 j + 2 t + (e & 1) of row 16 w + g + 8 (e >> 1).
template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                int H, int KV, int hd, int causal, int window, float scale_log2) {
  constexpr int TILE = tile_bytes<HDP>();
  constexpr int NC = HDP / ATOM;                     // 64-column chunks of hd
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned bars = base + (HEADS + 2 * STAGES) * TILE;
  // barriers: Q full; K full and V full of each stage; each stage empty
  const unsigned q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto q_tile = [&](int w) { return base + w * TILE; };
  auto k_tile = [&](int s) { return base + (HEADS + s) * TILE; };
  auto v_tile = [&](int s) { return base + (HEADS + STAGES + s) * TILE; };

  // blocks in order of their q tile, the heaviest causal tiles first
  const int G = H / KV, sets = (G + HEADS - 1) / HEADS;
  const int nq = (S + BQ - 1) / BQ, per_tile = gridDim.x / nq;
  const int qt = nq - 1 - blockIdx.x / per_tile;
  int rest = blockIdx.x % per_tile;
  const int set = rest % sets;
  rest /= sets;
  const int kvh = rest % KV, b = rest / KV;
  const int h0 = kvh * G + set * HEADS;           // first query head of the block
  const int active = min(HEADS, G - set * HEADS);  // warpgroups with a head
  const int q0 = qt * BQ;
  int kt_begin, kt_end;
  key_tiles(q0, S, causal, window, kt_begin, kt_end);
  const int n = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 128 == HEADS) {
    // producer: one thread keeps the ring full by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, active * TILE);
      for (int w = 0; w < active; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(q_tile(w) + c * SUBTILE, &tq, q_full, c * ATOM, h0 + w, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), (i / STAGES - 1) & 1);
        const int k0 = (kt_begin + i) * BK;
        mbar_expect_tx(k_full(s), TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(k_tile(s) + c * SUBTILE, &tk, k_full(s), c * ATOM, kvh, k0, b);
        mbar_expect_tx(v_full(s), TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(v_tile(s) + c * SUBTILE, &tv, v_full(s), c * ATOM, kvh, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgi = threadIdx.x / 128;
    if (wgi < active) {
      const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
      const int g = lane / 4, t = lane % 4;
      const int h = h0 + wgi;
      const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8
      // a tile needs the mask where some key lies past S, after a row, or
      // outside a row's window
      auto edge = [&](int k0) {
        return k0 + BK > S ||
               (causal && (k0 + BK - 1 > q0 || (window > 0 && k0 <= q0 + BQ - 1 - window)));
      };
      // S = Q K^T of stage s into sc, 64 x 64, K-steps of 16 along hd (32
      // bytes of a swizzled row); issued, not waited for
      auto issue_qk = [&](float (&sc)[32], int s) {
#pragma unroll
        for (int ks = 0; ks < HDP / 16; ++ks) {
          const unsigned off = (ks / 4) * SUBTILE + (ks % 4) * 32;
          wgmma_ss(sc, desc_kmajor(q_tile(wgi) + off), desc_kmajor(k_tile(s) + off), 1);
        }
        wgmma_commit();
      };

      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      mbar_wait(q_full, 0);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const unsigned parity = (i / STAGES) & 1;
        const int k0 = (kt_begin + i) * BK;

        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        mbar_wait(k_full(s), parity);
#pragma unroll
        for (int e = 0; e < 32; ++e) pin(sc[e]);
        wgmma_fence();
        issue_qk(sc, s);
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) pin(sc[e]);

        float corr[2];
        unsigned ph[4][4], pl[4][4];
        softmax(sc, edge(k0), row0, k0, t, S, causal, window, scale_log2, m, l, corr, ph, pl);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            acc[c][e] *= corr[(e % 4) / 2];
            pin(acc[c][e]);
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pin(ph[kk][r]);
            pin(pl[kk][r]);
          }

        // O += P V: V's rows are the K dimension (16 keys = 2048 bytes a step)
        mbar_wait(v_full(s), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const uint64_t dv = desc_mnmajor(v_tile(s) + c * SUBTILE + kk * 2048);
            wgmma_rs(acc[c], pl[kk], dv);
            wgmma_rs(acc[c], ph[kk], dv);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) pin(acc[c][e]);
        mbar_arrive(empty(s));
      }

      const long q_row = (long)H * hd;  // elements between consecutive positions
      __nv_bfloat16* ob = o + ((long)b * S * H + h) * hd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int sp = row0 + r * 8;
        if (sp >= S) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * ATOM + 8 * j + 2 * t;
            if (col < hd)
              *reinterpret_cast<__nv_bfloat162*>(&ob[sp * q_row + col]) = __floats2bfloat162_rn(
                  acc[c][4 * j + 2 * r] * inv, acc[c][4 * j + 2 * r + 1] * inv);
          }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once (no link to libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A TMA map of a contiguous (B, S, N, hd) bf16 tensor in boxes of 64 rows by
// 64 columns of one head, 128-byte swizzled; reads past hd or S give zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int N, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)N * hd * 2,
                                 (cuuint64_t)S * N * hd * 2};
  const cuuint32_t box[4] = {ATOM, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int blocks(int B, int S, int H, int KV) {
  const int G = H / KV;
  return (S + BQ - 1) / BQ * B * KV * ((G + HEADS - 1) / HEADS);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KV, int hd, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HDP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, S, H, hd) || !tensor_map(&tk, k, B, S, KV, hd) ||
      !tensor_map(&tv, v, B, S, KV, hd))
    return cudaErrorInvalidValue;
  flash_fwd_wgmma<HDP><<<blocks(B, S, H, KV), THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, KV, hd, causal, window,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace wg

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
                                 int, int, int, float, cudaStream_t);

// f32: the SIMT kernel at head size hd
template <int HD>
cudaError_t simt_launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                        int KV, int, int causal, int window, float scale, cudaStream_t stream) {
  return simt::launch<HD>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
}

LaunchFn simt_launcher(int hd) {
  switch (hd) {
#define REPRO_HD(N) \
  case N:           \
    return simt_launch<N>;
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

// bf16: the wgmma kernel with hd padded to 64 or 128 columns
LaunchFn wg_launcher(int hd) { return hd > wg::ATOM ? wg::launch<128> : wg::launch<64>; }

bool valid(int B, int S, int H, int KV, int hd) {
  return B > 0 && S > 0 && KV > 0 && H % KV == 0 && hd > 0 && hd % 16 == 0 && hd <= 128;
}

}  // namespace

// q: (B, S, H, hd); k, v: (B, S, KV, hd); o: (B, S, H, hd); all contiguous,
// of one dtype (is_bf16: bfloat16, else float32), pointers 16-byte aligned.
// hd is a multiple of 16 up to 128 and H a multiple of KV. Launches on
// `stream` and returns cudaGetLastError() as an int (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int KV, int hd, int causal, int window,
                                   float scale, int is_bf16, void* stream) {
  if (!valid(B, S, H, KV, hd)) return (int)cudaErrorInvalidValue;
  const LaunchFn fn = is_bf16 ? wg_launcher(hd) : simt_launcher(hd);
  return (int)fn(q, k, v, o, B, S, H, KV, hd, causal, window, scale,
                 static_cast<cudaStream_t>(stream));
}

// The launch of `is_bf16`'s kernel at these shapes, into out[4]: blocks,
// threads a block, dynamic shared memory a block (bytes), query heads a
// block. Returns 0, or cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int flash_attention_plan(int B, int S, int H, int KV, int hd, int is_bf16, int* out) {
  if (!valid(B, S, H, KV, hd)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    out[0] = wg::blocks(B, S, H, KV);
    out[1] = wg::THREADS;
    out[2] = hd > wg::ATOM ? wg::smem_bytes<128>() : wg::smem_bytes<64>();
    out[3] = wg::HEADS;
  } else {
    out[0] = (S + BQ - 1) / BQ * H * B;
    out[1] = simt::THREADS;
    out[2] = (int)simt::smem_bytes(hd);
    out[3] = 1;
  }
  return 0;
}
