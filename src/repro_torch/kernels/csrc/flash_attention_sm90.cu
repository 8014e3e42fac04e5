// Flash attention forward for Hopper (sm_90a) in bf16 on the tensor cores:
// wgmma fed by TMA, warp-specialised.  Plain C interface for ctypes, the same
// as flash_attention.cu's.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_fwd_kernel, driven by flash_attention_fwd and reached through
// repro/kernels/ops.py:flash_attention) for bf16 inputs at head dims 64, 72
// (the 2D DiT's) and 128; kernels/flash_attention.py routes every other
// (dtype, head dim) to flash_attention.cu.  Same function: blocked
// online-softmax attention with GQA (query head h reads KV head h / (Hq /
// Hkv)), causal masking, a sliding window (pos - window, pos], tanh
// soft-capping before the mask, a static q_offset, and a fully masked row
// that outputs 0.  Max, sum and the output accumulator stay in f32; P is
// rounded to bf16 for the P V product (the tensor cores take bf16
// operands), which the bf16 bar of chip_smoke.py absorbs
// (tests/test_torch_kernels.py pins that on the CPU).
//
// Bound on an H100 SXM at the serving slice's shape, q (1,40,2048,128),
// k/v (1,8,2048,128), causal: 4 * 128 * 40 * 2048 * 2049 / 2 = 4.30e10 FLOP,
// 43 us at 989 TFLOP/s (bf16 tensor cores); 50 MB moved (q, k, v read once,
// o written once), 15 us at 3.35 TB/s.  Bound by operations, so the design
// keeps the tensor cores fed:
//
// - Work split.  A CTA owns BQ = 128 query rows of one (batch, q head) and
//   has three warpgroups (384 threads).  Warpgroups 0 and 1 are consumers,
//   64 rows each (the wgmma M); warpgroup 2 is the producer, one thread of
//   which issues every TMA load.  setmaxnreg lowers the producer to 24
//   registers a thread and raises the consumers to 240, which ptxas then
//   allocates to the consumers' code (the block starts with 168, all a
//   384-thread block can have).  No wait in the kernel may end in __trap():
//   with one, ptxas keeps every path at the 168 and spills.
// - Loads.  q, k and v are 3-D tensor maps (D, S, B*H): a box past S reads
//   zeros, never the next head's rows.  The Q tile is loaded once.  K and V
//   tiles of BK = 128 rows pass through a ring of STAGES = 2 shared-memory
//   stages, each with its own full/empty mbarrier pair for K and for V, so
//   the producer keeps the next tile's loads in flight while the consumers
//   compute and Q K^T can start before V has landed.  Tiles are stored as
//   (rows, 64) panels of 128-byte rows under TMA's 128-byte swizzle, which
//   the wgmma descriptors name.
// - S = Q K^T: wgmma m64n128k16, Q and K both K-major from shared memory,
//   f32 accumulators (64 registers a thread).
// - Softmax in registers in f32: a row's 32 values of a tile lie in the
//   four lanes of a quad, so its max reduces with two shuffles; the row sum
//   stays a per-thread partial until the end.  Soft-cap, then the mask
//   (kpos < Skv, causal, window), which runs only on tiles that cross Skv,
//   the diagonal or the window's edge; both choices are made once per tile,
//   so the common tile runs straight-line code.  Without soft-cap the scores
//   stay raw and the scale is folded into the FFMA before ex2.approx.
// - O += P V: wgmma m64nDk16 with P as the A operand in registers (the f32
//   accumulator layout of S is the bf16 A layout, so the conversion is a
//   pack of pairs) and V as an MN-major B operand from shared memory.  O
//   stays in f32 registers, is divided by l at the end (l = 0 gives 0) and
//   is written in bf16 straight from registers.
// - Overlap inside a warpgroup.  Tile j's Q K^T and tile j-1's P V are
//   issued back to back; the warpgroup waits for the first only, runs tile
//   j's softmax while the tensor cores work on P V, then waits for P V
//   before O is rescaled and P_j packed.  S, P and O are live at once.
// - Ping-pong across warpgroups.  The two take turns to issue their
//   products (two named barriers), so one warpgroup's softmax runs while
//   the other's products hold the tensor cores.
// - Block order.  Under causal masking the grid walks the q tiles from the
//   last to the first, all heads of a tile together: the heaviest tiles
//   start first, so the tail of the grid is short at B = 1, and neighbouring
//   CTAs (the Hq / Hkv heads of one KV head) read the same K/V through L2.
//   Without it every tile weighs the same, and the grid walks one head's q
//   tiles together, so the CTAs on the card share a few heads' K/V in L2
//   (the DiT's 64 folded heads of 1.2 MB of K/V each would not all fit).
//
// Tiles, shared memory and registers.  D = 128: Q 32 KB + 2 stages x (K 32 KB
// + V 32 KB) = 160 KB, one CTA per SM; a consumer thread holds S (64 f32),
// P (32 x bf16x2) and O (64 f32) at once, ~230 of its 240 registers.
// D = 64: 80 KB, O 32 f32.  A larger D costs per thread D / 2 f32
// registers of O and per stage 2 x BK x D x 2 bytes: D = 256 would hold O
// in 128 registers beside S and P (96 more), past the 240, and need 64 KB
// per K or V tile, so it would take BK = 64, one stage and no overlap.
// Those head dims stay on flash_attention.cu, and so does D = 160.
//
// D = 72, not a multiple of the 64-column panel, splits the head dim three
// ways.  The true 72 sets the tensor maps' dims and row stride (144 B, a
// multiple of 16, as TMA needs), the stored columns and the scale (the
// wrapper's 72^-0.5).  Shared memory holds ceil(72 / 64) = 2 panels of a
// tile, the D = 128 layout (160 KB): TMA zero-fills the second box past
// column 72, and the mbarriers' transaction counts are whole boxes, which
// include the fill.  Q K^T runs ceil(72 / 16) = 5 wgmma K steps, the fifth
// at offset 0 of panel 1, over 80 columns: the 8 zero columns add nothing.
// P V is one m64n72k16 a K step, N = 72 reaching 8 columns into panel 1
// through the same LBO as D = 128, so O is 36 f32 and its padded columns
// are never formed.
//
// Not yet: reading q/k/v in the model's (B, S, H, D) layout through
// strides, which would drop the caller's layout copies.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;            // query rows per CTA
constexpr int BK = 128;            // key rows per K/V tile
constexpr int STAGES = 2;          // K/V ring depth
constexpr int CONSUMERS = 256;     // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 128;
constexpr int PANEL = 64;          // bf16 columns in one 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  // a tile's panels: D rounded up to whole panels, which TMA fills (with
  // zeros past D)
  static constexpr int PANELS = (D + PANEL - 1) / PANEL;
  static constexpr int Q_BYTES = BQ * PANELS * PANEL * 2;
  static constexpr int KV_BYTES = BK * PANELS * PANEL * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: Q full, then per stage K full, V full, K empty, V empty
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

struct Params {
  __nv_bfloat16* o;
  int hq, hkv, sq, skv, n_bh, n_mblocks;
  float scale_log2, softcap, softcap_log2, scale_over_cap;
  int causal, window, q_offset;
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
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
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
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
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

__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
    const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

__device__ __forceinline__ void wgmma_rs_m64n72k16(float (&d)[36],
    const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ bool visible(int kpos, int pos, const Params& p) {
  return kpos < p.skv && (!p.causal || kpos <= pos) &&
         (p.window <= 0 || kpos > pos - p.window);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax for this thread's two rows (h = 0: row r, h = 1:
// row r + 8).  s holds Q K^T on entry and P (f32, unnormalised) on exit; the
// running max m is in log2 units; alpha gets the factor by which the output
// accumulator must shrink, which the caller applies.  FOLD (no soft-cap and
// a positive scale, which keeps the scores' order) leaves the scores raw and
// folds the scale into the exponent's FFMA; otherwise each score is scaled
// or soft-capped first.  MASK and FOLD are uniform per tile, so each
// instantiation is straight-line code.
template <bool MASK, bool FOLD>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int k0,
                                             int pos_r, int col) {
  const float c = FOLD ? p.scale_log2 : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = pos_r + 8 * h;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * h + e];
        if (!FOLD)
          x = p.softcap > 0.f ? p.softcap_log2 * tanhf(x * p.scale_over_cap)
                              : x * p.scale_log2;
        if (MASK && !visible(k0 + 8 * j + col + e, pos, p)) x = -INFINITY;
        s[4 * j + 2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * c);
    // no visible column yet: exp2(-inf - 0) keeps everything at zero
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2_approx(m[h] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2_approx(fmaf(s[4 * j + 2 * h + e], c, -m_use));
        s[4 * j + 2 * h + e] = pe;
        sum += pe;
      }
    }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t bar_q = bars;
  auto k_s = [&](int s) { return base + L::K_OFF + s * L::KV_BYTES; };
  auto v_s = [&](int s) { return base + L::V_OFF + s * L::KV_BYTES; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

  // causal: heaviest q tiles first, all heads of one tile side by side;
  // otherwise every q tile of one head side by side
  const int idx = static_cast<int>(blockIdx.x);
  const int mblock = p.causal ? p.n_mblocks - 1 - idx / p.n_bh
                              : idx % p.n_mblocks;
  const int bh = p.causal ? idx % p.n_bh : idx / p.n_mblocks;   // b * hq + h
  const int bh_kv = (bh / p.hq) * p.hkv + (bh % p.hq) / (p.hq / p.hkv);
  const int row0 = mblock * BQ;

  // KV range that any row of this tile can see, from whole tiles
  const int pos_first = p.q_offset + row0;
  const int pos_last = p.q_offset + min(row0 + BQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, pos_last + 1);
  if (p.window > 0) kv_lo = max(0, pos_first - p.window + 1);
  kv_lo = kv_lo / BK * BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::PANELS; ++c)
        tma_load(q_s + c * BQ * 128, &tq, bar_q, c * PANEL, row0, bh);
      int it = 0;
      for (int k0 = kv_lo; k0 < kv_hi; k0 += BK, ++it) {
        const int s = it % STAGES;
        const uint32_t free_parity = ((it / STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::PANELS; ++c)
          tma_load(k_s(s) + c * BK * 128, &tk, k_full(s), c * PANEL, k0, bh_kv);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::PANELS; ++c)
          tma_load(v_s(s) + c * BK * 128, &tv, v_full(s), c * PANEL, k0, bh_kv);
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int r = row0 + 64 * wg + 16 * warp + lane / 4;   // this thread's row
    const int col = 2 * (lane % 4);                         // and column pair
    const int pos_r = p.q_offset + r;
    const int wg_pos_lo = p.q_offset + row0 + 64 * wg;
    const int wg_pos_hi = wg_pos_lo + 63;
    const uint32_t q_wg = q_s + 64 * wg * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sacc[64];
    uint32_t pa[32];   // P as the A operand of P V: S's layout, pairs packed

    // S = Q K^T of tile `it` (issued, not waited for)
    auto issue_qk = [&](int it) {
      const int s = it % STAGES;
      mbar_wait(k_full(s), (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk) {   // depth padded to 16s
        const uint32_t off = (kk % 4) * 32;   // 16 columns of a panel
        wgmma_ss_m64n128k16(
            sacc, desc_sw128(q_wg + (kk / 4) * BQ * 128 + off, 16),
            desc_sw128(k_s(s) + (kk / 4) * BK * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of tile `it` (issued, not waited for)
    auto issue_pv = [&](int it) {
      const int s = it % STAGES;
      mbar_wait(v_full(s), (it / STAGES) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_sw128(v_s(s) + kk * 16 * 128, BK * 128);
        if constexpr (D == 128)
          wgmma_rs_m64n128k16(o, pa + 4 * kk, dv);
        else if constexpr (D == 72)
          wgmma_rs_m64n72k16(o, pa + 4 * kk, dv);
        else
          wgmma_rs_m64n64k16(o, pa + 4 * kk, dv);
      }
      wgmma_commit();
    };
    // softmax of tile `it`, S to P in place in sacc; alpha as softmax_tile's
    auto softmax = [&](int it, float (&alpha)[2]) {
      const int k0 = kv_lo + it * BK;
      const bool mask = k0 + BK > p.skv ||
                        (p.causal && k0 + BK - 1 > wg_pos_lo) ||
                        (p.window > 0 && k0 <= wg_pos_hi - p.window);
      const bool fold = p.softcap <= 0.f && p.scale_log2 > 0.f;
      if (mask) {
        if (fold)
          softmax_tile<true, true>(sacc, m, l, alpha, p, k0, pos_r, col);
        else
          softmax_tile<true, false>(sacc, m, l, alpha, p, k0, pos_r, col);
      } else {
        if (fold)
          softmax_tile<false, true>(sacc, m, l, alpha, p, k0, pos_r, col);
        else
          softmax_tile<false, false>(sacc, m, l, alpha, p, k0, pos_r, col);
      }
    };
    auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] *= alpha[h];
          o[4 * j + 2 * h + 1] *= alpha[h];
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        pa[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);
    };

    const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
    mbar_wait(bar_q, 0);
    // Turns to issue products: warpgroup wg waits on named barrier 1 + wg,
    // which the other warpgroup's arrival completes.  Each takes n_tiles + 1
    // turns and hands over as many: warpgroup 1 once before its first turn
    // and after every turn but its last.
    auto my_turn = [&]() { named_sync(1 + wg, CONSUMERS); };
    auto your_turn = [&]() { named_arrive(2 - wg, CONSUMERS); };
    if (wg == 1 && n_tiles > 0) your_turn();   // warpgroup 0 goes first
    // Tile it's softmax overlaps tile it-1's P V: issue S_it and PV_(it-1),
    // wait for S_it only, softmax, then wait for PV_(it-1) before O is
    // rescaled and P_it packed over P_(it-1).
    if (n_tiles > 0) {
      float alpha[2];
      my_turn();
      issue_qk(0);
      your_turn();
      wgmma_wait<0>();
      fence_regs(sacc);
      mbar_arrive(k_empty(0));
      softmax(0, alpha);
      rescale_and_pack(alpha);
      for (int it = 1; it < n_tiles; ++it) {
        my_turn();
        issue_qk(it);
        issue_pv(it - 1);
        your_turn();
        wgmma_wait<1>();
        fence_regs(sacc);
        mbar_arrive(k_empty(it % STAGES));
        softmax(it, alpha);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(v_empty((it - 1) % STAGES));
        rescale_and_pack(alpha);
      }
      my_turn();
      issue_pv(n_tiles - 1);
      if (wg == 0) your_turn();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(v_empty((n_tiles - 1) % STAGES));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = r + 8 * h;
      if (row >= p.sq) continue;
      const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];   // fully masked -> 0
      __nv_bfloat16* out = p.o + (static_cast<size_t>(bh) * p.sq + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                  o[4 * j + 2 * h + 1] * inv);
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
  ERR_ALIGNMENT = -3,      // a base address is not 16-byte aligned
};

// A (D, S, B*H) map of a contiguous (B, H, S, D) bf16 tensor whose box is
// one 64-column panel of `rows` rows under 128-byte swizzle.
int make_map(CUtensorMap* map, const void* ptr, int d, int s, int bh,
             int rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return ERR_ALIGNMENT;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_DRIVER;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           int window, float softcap, int q_offset, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, sq, b * hq, BQ);
  if (err == 0) err = make_map(&tk, k, D, skv, b * hkv, BK);
  if (err == 0) err = make_map(&tv, v, D, skv, b * hkv, BK);
  if (err == 0 && reinterpret_cast<uintptr_t>(o) % 16) err = ERR_ALIGNMENT;
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::BYTES);
  if (e != cudaSuccess) return e;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.n_bh = b * hq;
  p.n_mblocks = (sq + BQ - 1) / BQ;
  p.scale_log2 = scale * LOG2E;
  p.softcap = softcap;
  p.softcap_log2 = softcap * LOG2E;
  p.scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  const unsigned grid = static_cast<unsigned>(p.n_mblocks) * p.n_bh;
  flash_fwd_sm90_kernel<D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16) and d 64, 72 or 128.  window <= 0 means no
// window and softcap <= 0 no soft-cap.  Returns 0, a cudaError_t, or one of the
// negative codes above.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* o, int dtype, int b, int hq, int hkv,
                             int sq, int skv, int d, float scale, int causal,
                             int window, float softcap, int q_offset,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (d == 64)
    return launch<64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window,
                      softcap, q_offset, st);
  if (d == 72)
    return launch<72>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window,
                      softcap, q_offset, st);
  if (d == 128)
    return launch<128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window,
                       softcap, q_offset, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_sm90_error_string(int err) {
  switch (err) {
    case ERR_NO_DRIVER:
      return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_TENSOR_MAP:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_ALIGNMENT:
      return "a base address is not 16-byte aligned (TMA needs it)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
