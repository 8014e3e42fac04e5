// Mamba-2 chunked SSD scan forward for Hopper (sm_90a) in bf16 on the tensor
// cores: wgmma fed by TMA, warp-specialised.  Plain C interface for ctypes,
// beside ssd_scan.cu's.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (_ssd_kernel,
// driven by ssd_scan_fwd and reached through repro/kernels/ops.py:ssd_scan)
// for bf16 inputs at head dim P = 64, state dim S = 128 and chunk Q = 128,
// with any B/C group count G dividing H; kernels/ssd_scan.py routes every
// other case to ssd_scan.cu.  Same function and the same sequential-over-
// chunks algorithm, per chunk of Q rows of one (batch, head):
//   cum_i   = cumsum(da)_i
//   y_intra = ((c b^T) * exp(cum_i - cum_j) * [j <= i]) xdt
//   y_inter = (c state^T) * exp(cum)
//   state'  = exp(cum_Q) state + (exp(cum_Q - cum) * xdt)^T b
// with the (P, S) state carried from chunk to chunk inside the block, in
// f32 registers, as the TPU kernel keeps it in VMEM scratch.
//
// Bound on an H100 SXM at the training slice's shape, xdt (8,32,4096,64),
// b/c (8,1,4096,128) bf16, chunk 128: 0.289 GB moved (xdt, da, b, c read
// once, y written once), 86 us at 3.35 TB/s, which binds it; the products
// the function needs are 43.6 GFLOP, 44 us at 989 TFLOP/s.  This kernel
// issues 16.8 MFLOP of wgmma a chunk (137 GFLOP at the slice, 139 us at the
// peak): c b^T over the whole tile, and three products twice each, as a
// bf16 hi + lo pair (below).
//
// Design:
// - Work split.  One CTA per (batch, head), heads of a batch side by side
//   so that they read their shared b/c through L2; it loops over its
//   chunks.  Three warpgroups (384 threads): warpgroup 2 is the producer,
//   one thread of which issues every TMA load; warpgroups 0 and 1 are
//   consumers.  Consumer wg owns chunk rows [64 wg, 64 wg + 64) of the
//   output products (the wgmma M) and state columns [64 wg, 64 wg + 64) of
//   the update.  setmaxnreg gives the producer 24 registers a thread and
//   the consumers 240.  No wait ends in __trap(): with one, ptxas keeps
//   the consumers at the 168 registers a 384-thread block starts with.
// - Loads.  xdt, b and c are 4-D tensor maps over (P, L, H, B) and
//   (S, L, G, B) with the caller's strides, so the model's (B, L, H, P)
//   and (B, L, G, S) views are read without a copy, and a box past L reads
//   zeros, never the next head's rows: exactly the TPU wrapper's zero
//   padding (da = 0 leaves the state alone, xdt = b = c = 0 add nothing).
//   Rows past L are never stored.  A stage holds one chunk's c and b (two
//   (128, 64) panels each) and xdt (one panel) as 128-byte rows under
//   TMA's 128-byte swizzle, 80 KB; two stages on full/empty mbarriers, so
//   chunk k+1 loads while chunk k computes.  da is read by the scan warp
//   of each consumer warpgroup a chunk ahead into registers.
// - The cumsum is a warp scan of da * log2(e) in each consumer warpgroup
//   (its own copy, so the two need no barrier for it); exponents are
//   ex2.approx of differences.  exp(cum_i - cum_j) is never factored as
//   exp(cum_i) exp(-cum_j): over a chunk cum reaches values whose negative
//   overflows f32.
// - The four products on wgmma, f32 accumulators:
//   1. c b^T: m64n128k16, c and b K-major from shared memory (exact).
//   2. The decay on the accumulator in registers, the mask applied before
//      the exponent; M is rounded to bf16 as the register A operand of
//      M xdt (the f32 accumulator layout is the bf16 A layout, so it is a
//      pack of pairs), xdt an MN-major B operand.
//   3. c state^T: m64n64k16 with the bf16 copy of the state in shared
//      memory as a K-major B operand; the rows of the accumulator are
//      scaled by exp(cum_i), then M xdt accumulates onto it.
//   4. The update: w^T b with w = exp(cum_Q - cum) xdt built in registers
//      as the A operand (ldmatrix.trans of the xdt tile, scaled by row),
//      b an MN-major B operand (the warpgroup's 64-column panel).  The
//      state stays f32 in the consumers' registers across all chunks and
//      is scaled by exp(cum_Q) before each update.  Only its operand copy
//      for product 3 is rounded, once per chunk, so rounding never
//      compounds.
// - Precision.  Each of the three bf16 operands built in the kernel (M, w
//   and the state copy) is a hi + lo pair, hi = bf16(v), lo = bf16(v - hi),
//   and its product is two wgmmas: a single rounding of any of them, at
//   2^-9 relative, puts the output past one ulp of the row's largest value
//   (tests/test_torch_ssd_sm90.py emulates this arithmetic on the CPU).
// - Order within a chunk, per consumer warpgroup: scan; w; barrier R (the
//   other warpgroup's half of the previous state copy is written); issue
//   c state^T, then c b^T; wait for the first, issue the update (the
//   critical path: update -> state copy -> next chunk's c state^T); wait for
//   c b^T and decay it while the update runs; barrier R2 (both warpgroups
//   have finished reading the old state copy), write the new one; issue
//   M xdt, wait, store y from registers through the output's strides.
//
// Shared memory: 2 stages x 80 KB + the state copy (hi, lo: 32 KB) + the
// scan results (4 KB) = 197 KB, one CTA per SM; 256 CTAs at the slice's
// shape run in two waves over 132 SMs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;             // rows per chunk
constexpr int P = 64;              // head dim
constexpr int S = 128;             // state dim
constexpr int STAGES = 2;          // chunk ring depth
constexpr int CONSUMERS = 256;     // two warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int PANEL = 64;          // bf16 columns in one 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory from a 1024-byte-aligned base (swizzle atoms need it).
constexpr int C_BYTES = Q * S * 2;                 // two (Q, 64) panels
constexpr int B_BYTES = Q * S * 2;
constexpr int X_BYTES = Q * P * 2;                 // one (Q, 64) panel
constexpr int STAGE_BYTES = C_BYTES + B_BYTES + X_BYTES;
constexpr int ST_BYTES = P * S * 2;                // two (P, 64) panels
constexpr int OFF_ST_HI = STAGES * STAGE_BYTES;
constexpr int OFF_ST_LO = OFF_ST_HI + ST_BYTES;
constexpr int OFF_SCAN = OFF_ST_LO + ST_BYTES;
// per consumer warpgroup and chunk parity: cum2[Q] then wq[Q]
constexpr int SCAN_FLOATS = 2 * Q;
constexpr int OFF_BAR = OFF_SCAN + 2 * 2 * SCAN_FLOATS * 4;
// barriers: per stage full, then per stage empty
constexpr int SMEM_BYTES = OFF_BAR + 8 * 2 * STAGES + 1024;

// named barriers (0 is __syncthreads)
constexpr int BAR_STATE_READY = 1;  // both halves of the state copy written
constexpr int BAR_SCAN = 2;         // + wg: this warpgroup's scan written
constexpr int BAR_STATE_FREE = 4;   // both warpgroups done reading the copy

struct Params {
  const float* da;
  __nv_bfloat16* y;
  long long da_sb, da_sh, da_sl;   // element strides
  long long y_sb, y_sh, y_sl;
  int h, g, l, n_chunks;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart (SBO).  LBO is the byte distance between
// 64-column panels of an MN-major operand; K-major swizzled operands ignore
// it.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes, so the compiler moves
// no access to them across the wgmma's issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The pair (x0, x1) as bf16 hi + lo: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 b16 matrices, transposed: lane i names row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// wgmma instructions.  The f32 accumulator of m64nNk16 holds, in thread t
// of the warpgroup (warp w = t / 32, lane l), d[4j + 2h + e] at row
// 16w + l/4 + 8h and column 8j + 2(l%4) + e.  ss: A and B are K-major
// descriptors.  rs: A is four bf16x2 registers in the same row/column
// pattern over a 16-wide K slice, B an MN-major (transposed) descriptor.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
    const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  auto c_s = [&](int s) { return base + s * STAGE_BYTES; };
  auto b_s = [&](int s) { return base + s * STAGE_BYTES + C_BYTES; };
  auto x_s = [&](int s) {
    return base + s * STAGE_BYTES + C_BYTES + B_BYTES;
  };
  const uint32_t bars = base + OFF_BAR;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  // heads of one batch side by side: with G < H they share b/c in L2
  const int bi = static_cast<int>(blockIdx.x) / p.h;
  const int hi = static_cast<int>(blockIdx.x) % p.h;
  const int grp = hi / (p.h / p.g);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      for (int k = 0; k < p.n_chunks; ++k) {
        const int s = k % STAGES;
        const int l0 = k * Q;
        mbar_wait(empty(s), ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < S / PANEL; ++c) {
          tma_load(c_s(s) + c * Q * 128, &tc, full(s), c * PANEL, l0, grp, bi);
          tma_load(b_s(s) + c * Q * 128, &tb, full(s), c * PANEL, l0, grp, bi);
        }
        tma_load(x_s(s), &tx, full(s), 0, l0, hi, bi);
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row = 64 * wg + 16 * warp + lane / 4;   // chunk row (h = 0)
  const int col = 2 * (lane % 4);                    // and column pair
  float* const scan_base =
      reinterpret_cast<float*>(base_ptr + OFF_SCAN) + wg * 2 * SCAN_FLOATS;
  const float* const da_p = p.da + bi * p.da_sb + hi * p.da_sh;
  __nv_bfloat16* const y_p = p.y + bi * p.y_sb + hi * p.y_sh;
  const uint32_t st_hi = base + OFF_ST_HI, st_lo = base + OFF_ST_LO;
  const uint32_t c_wg = 64 * wg * 128;               // this wg's rows of c

  // da * log2(e) of a chunk, 4 rows a lane, read a chunk ahead (warp 0)
  float da_next[4];
  auto load_da = [&](int k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int l = k * Q + 4 * lane + r;
      da_next[r] = l < p.l ? da_p[l * p.da_sl] * LOG2E : 0.f;
    }
  };
  if (warp == 0) load_da(0);

  float st[32];    // state rows p, this wg's 64 state columns, f32
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;
  float y[32];     // output rows of this wg, P columns
  float cb[64];    // c b^T, then M, rows of this wg, 128 columns
  uint32_t wa[64];  // w^T as A fragments: [0, 32) hi, [32, 64) lo
  uint32_t ma[64];  // M as A fragments: hi, lo

  for (int k = 0; k < p.n_chunks; ++k) {
    const int s = k % STAGES;
    float* const cum2 = scan_base + (k & 1) * SCAN_FLOATS;
    float* const wq = cum2 + Q;
    if (warp == 0) {
      // inclusive scan of the chunk's da * log2(e), 4 rows a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        run += da_next[r];
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float cu = excl + v[r];
        cum2[4 * lane + r] = cu;
        wq[4 * lane + r] = exp2_approx(total - cu);   // exp(cum_Q - cum)
      }
      if (k + 1 < p.n_chunks) load_da(k + 1);
    }
    named_sync(BAR_SCAN + wg, 128);
    const float total2 = cum2[Q - 1];
    mbar_wait(full(s), (k / STAGES) & 1);

    // w^T as A fragments (M = P, K = Q rows): warp w takes p in
    // [16w, 16w + 16); matrix i / 8 of the ldmatrix is (rows + 8 (i / 2),
    // p + 8 (i % 2)), so register r holds rows 16kk + 8 (r / 2) + col + e.
    {
      const int mi = lane / 8, r8 = lane % 8;
      const uint32_t chunk16 = 2 * warp + (mi & 1);
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        const int q = 16 * kk + 8 * (mi / 2) + r8;
        uint32_t a[4];
        ldmatrix_x4_trans(a, x_s(s) + q * 128 + ((chunk16 ^ r8) << 4));
        const float2 w0 = *reinterpret_cast<const float2*>(wq + 16 * kk + col);
        const float2 w1 =
            *reinterpret_cast<const float2*>(wq + 16 * kk + 8 + col);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 sc = r < 2 ? w0 : w1;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&a[r]);
          split_bf16(__low2float(xv) * sc.x, __high2float(xv) * sc.y,
                     wa[4 * kk + r], wa[32 + 4 * kk + r]);
        }
      }
    }

    if (k > 0) {
      // y_inter = c state^T over both halves of the state copy
      named_sync(BAR_STATE_READY, CONSUMERS);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S / 16; ++kk) {
        const uint32_t off = (kk / 4) * Q * 128 + c_wg + (kk % 4) * 32;
        const uint32_t soff = (kk / 4) * P * 128 + (kk % 4) * 32;
        wgmma_ss_m64n64k16(y, desc_sw128(c_s(s) + off, 16),
                           desc_sw128(st_hi + soff, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < S / 16; ++kk) {
        const uint32_t off = (kk / 4) * Q * 128 + c_wg + (kk % 4) * 32;
        const uint32_t soff = (kk / 4) * P * 128 + (kk % 4) * 32;
        wgmma_ss_m64n64k16(y, desc_sw128(c_s(s) + off, 16),
                           desc_sw128(st_lo + soff, 16), 1);
      }
      wgmma_commit();
    }
    // c b^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk) {
      const uint32_t off = (kk / 4) * Q * 128 + (kk % 4) * 32;
      wgmma_ss_m64n128k16(cb, desc_sw128(c_s(s) + off + c_wg, 16),
                          desc_sw128(b_s(s) + off, 16), kk > 0);
    }
    wgmma_commit();
    if (k > 0) {
      wgmma_wait<1>();
      fence_regs(y);
    }

    // the update: state = exp(cum_Q) state + w^T b (this wg's b panel)
    {
      const float decay = exp2_approx(total2);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] *= decay;
      const uint32_t bp = b_s(s) + wg * Q * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk)
        wgmma_rs_m64n64k16(st, wa + 4 * kk,
                           desc_sw128(bp + kk * 16 * 128, Q * 128));
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk)
        wgmma_rs_m64n64k16(st, wa + 32 + 4 * kk,
                           desc_sw128(bp + kk * 16 * 128, Q * 128));
      wgmma_commit();
    }

    // decay c b^T into M while the update runs; the mask comes before the
    // exponent (j > i gives exp2(-inf) = 0)
    wgmma_wait<1>();
    fence_regs(cb);
    float ci[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) ci[h] = cum2[row + 8 * h];
#pragma unroll
    for (int j = 0; j < Q / 8; ++j) {
      const float2 cj = *reinterpret_cast<const float2*>(cum2 + 8 * j + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = row + 8 * h;
        const int jc = 8 * j + col;
        const float a0 = jc <= i ? ci[h] - cj.x : -INFINITY;
        const float a1 = jc + 1 <= i ? ci[h] - cj.y : -INFINITY;
        cb[4 * j + 2 * h] *= exp2_approx(a0);
        cb[4 * j + 2 * h + 1] *= exp2_approx(a1);
      }
    }

    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(wa);
    // the new state copy, once both warpgroups have read the old one
    named_sync(BAR_STATE_FREE, CONSUMERS);
    {
      const int pr = 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pp = pr + 8 * h;
          const uint32_t off = wg * P * 128 + pp * 128 +
                               ((j ^ (pp & 7)) << 4) + 2 * col;
          uint32_t hi_v, lo_v;
          split_bf16(st[4 * j + 2 * h], st[4 * j + 2 * h + 1], hi_v, lo_v);
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(st_hi + off),
                       "r"(hi_v)
                       : "memory");
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(st_lo + off),
                       "r"(lo_v)
                       : "memory");
        }
      }
      fence_proxy_async();
    }

    // y = y_inter exp(cum_i) + M xdt
#pragma unroll
    for (int i = 0; i < 32; ++i) split_bf16(cb[2 * i], cb[2 * i + 1], ma[i],
                                            ma[32 + i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = k > 0 ? exp2_approx(ci[h]) : 0.f;
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        y[4 * j + 2 * h] = k > 0 ? y[4 * j + 2 * h] * e : 0.f;
        y[4 * j + 2 * h + 1] = k > 0 ? y[4 * j + 2 * h + 1] * e : 0.f;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      wgmma_rs_m64n64k16(y, ma + 4 * kk,
                         desc_sw128(x_s(s) + kk * 16 * 128, Q * 128));
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      wgmma_rs_m64n64k16(y, ma + 32 + 4 * kk,
                         desc_sw128(x_s(s) + kk * 16 * 128, Q * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(ma);
    mbar_arrive(empty(s));

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = k * Q + row + 8 * h;
      if (l >= p.l) continue;
      __nv_bfloat16* const out = y_p + static_cast<long long>(l) * p.y_sl;
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col) =
            __floats2bfloat162_rn(y[4 * j + 2 * h], y[4 * j + 2 * h + 1]);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already loaded, so the
// library links against nothing beyond the CUDA runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

enum : int {
  ERR_NO_DRIVER = -1,      // cuTensorMapEncodeTiled not found
  ERR_TENSOR_MAP = -2,     // the driver refused a tensor map
  ERR_ALIGNMENT = -3,      // a base address or stride is not 16-byte aligned
};

// A 4-D map (cols, L, heads or groups, B) of a bf16 tensor with unit column
// stride and element strides (sl, sm, sb); its box is one 64-column panel of
// Q rows under 128-byte swizzle.
int make_map(CUtensorMap* map, const void* ptr, int cols, int l, int m,
             int b, long long sl, long long sm, long long sb) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || (sl * 2) % 16 ||
      (sm * 2) % 16 || (sb * 2) % 16)
    return ERR_ALIGNMENT;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_DRIVER;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sm) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {PANEL, Q, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16; da is float32), p 64, s 128, chunk 128 and
// h % g == 0.  strides holds element strides, 3 per tensor in the order
// xdt (b, h, l), da (b, h, l), b (b, g, l), c (b, g, l), y (b, h, l); the
// last dim of xdt, b, c and y is unit-stride.  Returns 0, a cudaError_t,
// or one of the negative codes above.
int ssd_scan_sm90_fwd(const void* xdt, const void* da, const void* b,
                      const void* c, void* y, int dtype, int batch, int h,
                      int g, int l, int p, int s, int chunk,
                      const long long* strides, void* stream) {
  if (dtype != 1 || p != P || s != S || chunk != Q || g < 1 || h % g != 0 ||
      l < 1 || batch < 1)
    return cudaErrorInvalidValue;
  const long long* sx = strides;
  const long long* sd = strides + 3;
  const long long* sbm = strides + 6;
  const long long* scm = strides + 9;
  const long long* sy = strides + 12;
  CUtensorMap tx, tb, tc;
  int err = make_map(&tx, xdt, P, l, h, batch, sx[2], sx[1], sx[0]);
  if (err == 0) err = make_map(&tb, b, S, l, g, batch, sbm[2], sbm[1], sbm[0]);
  if (err == 0) err = make_map(&tc, c, S, l, g, batch, scm[2], scm[1], scm[0]);
  if (err == 0 && (reinterpret_cast<uintptr_t>(y) % 4 || sy[0] % 2 ||
                   sy[1] % 2 || sy[2] % 2))
    err = ERR_ALIGNMENT;
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return e;
  Params prm;
  prm.da = static_cast<const float*>(da);
  prm.y = static_cast<__nv_bfloat16*>(y);
  prm.da_sb = sd[0];
  prm.da_sh = sd[1];
  prm.da_sl = sd[2];
  prm.y_sb = sy[0];
  prm.y_sh = sy[1];
  prm.y_sl = sy[2];
  prm.h = h;
  prm.g = g;
  prm.l = l;
  prm.n_chunks = (l + Q - 1) / Q;
  ssd_scan_sm90_kernel<<<batch * h, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(tx, tb, tc, prm);
  return cudaGetLastError();
}

const char* ssd_scan_sm90_error_string(int err) {
  switch (err) {
    case ERR_NO_DRIVER:
      return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_ALIGNMENT:
      return "a base address or stride is not aligned (TMA needs 16 bytes)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
