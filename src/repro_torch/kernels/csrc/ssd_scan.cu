// Mamba-2 chunked SSD scan forward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (_ssd_kernel,
// driven by ssd_scan_fwd and reached through repro/kernels/ops.py:ssd_scan).
// It computes the same function.  Per chunk of Q rows of one (batch, head),
// in f32:
//   cum_i   = cumsum(da)_i
//   y_intra = ((c b^T) * exp(cum_i - cum_j) * [j <= i]) xdt
//   y_inter = (c state^T) * exp(cum)
//   state'  = exp(cum_Q) state + (exp(cum_Q - cum) * xdt)^T b
// with the (P, S) state carried from chunk to chunk.  Head h reads B/C
// group h / (H / G).
//
// Bound on an H100 SXM at the training slice's shape, xdt (8,32,4096,64),
// b/c (8,1,4096,128) bf16, chunk 128: it moves 0.289 GB (xdt, da, b, c
// read once, y written once), 86 us at 3.35 TB/s, and that binds it.  The
// products it needs are 43.6 GFLOP, 44 us at 989 TFLOP/s (bf16 tensor
// cores): per chunk, c b^T over its causal triangle once per B/C group,
// SQ(Q+1) FLOP; per head the masked product with xdt, PQ(Q+1), and the
// inter-chunk output and the state update, 4PQS.
//
// Design, simple first: one block of 256 threads owns one (batch, head)
// and loops over the chunks itself -- that loop replaces the TPU's
// sequential ("arbitrary") chunk axis, and the state stays in shared
// memory between chunks instead of VMEM scratch.  A chunk's xdt, b and c
// are staged in shared memory as f32 (b and c with a padded stride), the
// (Q, Q) decayed c b^T is built 32 columns at a time (a 128 x 32 tile, so
// the whole working set is 211 KB of dynamic shared memory instead of the
// 256.5 KB a full (Q, Q) tile would need), and tiles wholly above the
// diagonal are skipped.  Every product runs on the CUDA cores in f32 FMAs
// from shared memory; tensor cores (wgmma) and TMA are left for a later
// change, so the kernel runs far below the bound above.  The cumsum is a
// warp scan.  The mask comes before exp: entries with j > i are 0, never
// exp of a positive number, and exp(cum_Q - cum) has a non-positive
// exponent since da <= 0.
//
// Any L works: the last chunk is short, and rows past L load as zeros
// (da = 0: decay 1; xdt = b = c = 0: no contribution) and are not stored,
// which is exactly the TPU wrapper's zero padding.  Likewise chunk < 128,
// P < 64 and S < 128 sit zero-padded in the fixed 128/64/128 tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QM = 128;          // rows per chunk tile (max chunk)
constexpr int PM = 64;           // max head dim P
constexpr int SMX = 128;         // max state dim S
constexpr int THREADS = 256;
constexpr int JT = 32;           // columns of one decayed c b^T tile
constexpr int XS = PM;           // xdt row stride in shared memory
constexpr int BS = SMX + 1;      // b, c, state row stride (padded)
constexpr int MS = JT + 1;       // decayed tile row stride (padded)

struct Smem {
  static constexpr int xdt = 0;
  static constexpr int b = xdt + QM * XS;
  static constexpr int c = b + QM * BS;
  static constexpr int state = c + QM * BS;
  static constexpr int m = state + PM * BS;
  static constexpr int cum = m + QM * MS;
  static constexpr int ecum = cum + QM;     // exp(cum)
  static constexpr int wq = ecum + QM;      // exp(total - cum)
  static constexpr int floats = wq + QM;
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Row layout shared by the output and the decayed tile: thread t owns rows
// (t >> 3) + 32 i, i < 4, and output columns (t & 7) + 8 c, c < 8, or tile
// columns (t & 7) + 8 k, k < 4.
//
// Tile J covers columns j in [32 J, 32 J + 32).  Row blocks i < J lie wholly
// above the diagonal, so only rows i >= J are computed and accumulated.
template <int J>
__device__ __forceinline__ void intra_tile(const float* sm_c,
                                           const float* sm_b,
                                           const float* sm_cum,
                                           const float* sm_x, float* sm_m,
                                           float (&acc)[4][8], int s_dim) {
  constexpr int NI = 4 - J;
  const int rq = threadIdx.x >> 3, cj = threadIdx.x & 7;
  float dot[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dot[i][k] = 0.f;
#pragma unroll 4
  for (int s = 0; s < s_dim; ++s) {
    float cv[NI], bv[4];
#pragma unroll
    for (int i = 0; i < NI; ++i) cv[i] = sm_c[(rq + 32 * (J + i)) * BS + s];
#pragma unroll
    for (int k = 0; k < 4; ++k) bv[k] = sm_b[(32 * J + cj + 8 * k) * BS + s];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) dot[i][k] = fmaf(cv[i], bv[k], dot[i][k]);
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int q = rq + 32 * (J + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 32 * J + cj + 8 * k;
      // mask before exp: cum_q - cum_j <= 0 wherever j <= q
      const float m = j <= q ? dot[i][k] * expf(sm_cum[q] - sm_cum[j]) : 0.f;
      sm_m[q * MS + cj + 8 * k] = m;
    }
  }
  __syncthreads();
#pragma unroll 4
  for (int jj = 0; jj < JT; ++jj) {
    float xv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) xv[c] = sm_x[(32 * J + jj) * XS + cj + 8 * c];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float mv = sm_m[(rq + 32 * (J + i)) * MS + jj];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[J + i][c] = fmaf(mv, xv[c], acc[J + i][c]);
    }
  }
  __syncthreads();   // the tile is consumed before the next one is written
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ da,
                const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, int h_dim, int g_dim, int l_dim,
                int p_dim, int s_dim, int chunk) {
  extern __shared__ float smem[];
  float* sm_x = smem + Smem::xdt;
  float* sm_b = smem + Smem::b;
  float* sm_c = smem + Smem::c;
  float* sm_st = smem + Smem::state;
  float* sm_m = smem + Smem::m;
  float* sm_cum = smem + Smem::cum;
  float* sm_ecum = smem + Smem::ecum;
  float* sm_wq = smem + Smem::wq;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int grp = h / (h_dim / g_dim);
  const size_t xo = ((size_t)bi * h_dim + h) * l_dim;
  const size_t bo = ((size_t)bi * g_dim + grp) * l_dim;
  const T* xp = xdt + xo * p_dim;
  const float* dp = da + xo;
  const T* bp = bm + bo * s_dim;
  const T* cp = cm + bo * s_dim;
  T* yp = y + xo * p_dim;

  for (int i = tid; i < PM * BS; i += THREADS) sm_st[i] = 0.f;

  // output / decayed-tile layout and state-update layout
  const int rq = tid >> 3, cp8 = tid & 7;
  const int sp = tid >> 4, ss = tid & 15;

  for (int l0 = 0; l0 < l_dim; l0 += chunk) {
    const int n = min(chunk, l_dim - l0);    // valid rows of this chunk
    // ---- stage the chunk; rows >= n and columns >= P / S are zeros
    for (int i = tid; i < QM * PM; i += THREADS) {
      const int r = i / PM, col = i % PM;
      sm_x[r * XS + col] = r < n && col < p_dim
          ? to_float(xp[(size_t)(l0 + r) * p_dim + col]) : 0.f;
    }
    for (int i = tid; i < QM * SMX; i += THREADS) {
      const int r = i / SMX, col = i % SMX;
      const bool in = r < n && col < s_dim;
      const size_t gi = (size_t)(l0 + r) * s_dim + col;
      sm_b[r * BS + col] = in ? to_float(bp[gi]) : 0.f;
      sm_c[r * BS + col] = in ? to_float(cp[gi]) : 0.f;
    }
    if (tid < QM) sm_cum[tid] = tid < n ? dp[l0 + tid] : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of da over the 128 rows: one warp, 4 per lane
    if (tid < 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        run += sm_cum[tid * 4 + r];
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float cu = excl + v[r];
        sm_cum[tid * 4 + r] = cu;
        sm_ecum[tid * 4 + r] = expf(cu);
        sm_wq[tid * 4 + r] = expf(total - cu);
      }
    }
    __syncthreads();

    // ---- inter-chunk term from the state entering this chunk
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    if (l0 > 0) {
#pragma unroll 4
      for (int s = 0; s < s_dim; ++s) {
        float cv[4], sv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sm_c[(rq + 32 * i) * BS + s];
#pragma unroll
        for (int c = 0; c < 8; ++c) sv[c] = sm_st[(cp8 + 8 * c) * BS + s];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(cv[i], sv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = sm_ecum[rq + 32 * i];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] *= e;
      }
    }

    // ---- intra-chunk term, 32 columns of the decayed c b^T at a time;
    // tiles past the valid rows hold only zeros and are skipped
    intra_tile<0>(sm_c, sm_b, sm_cum, sm_x, sm_m, acc, s_dim);
    if (n > 32) intra_tile<1>(sm_c, sm_b, sm_cum, sm_x, sm_m, acc, s_dim);
    if (n > 64) intra_tile<2>(sm_c, sm_b, sm_cum, sm_x, sm_m, acc, s_dim);
    if (n > 96) intra_tile<3>(sm_c, sm_b, sm_cum, sm_x, sm_m, acc, s_dim);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = rq + 32 * i;
      if (q >= n) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int p = cp8 + 8 * c;
        if (p < p_dim) store(yp + (size_t)(l0 + q) * p_dim + p, acc[i][c]);
      }
    }

    // ---- state update.  Every read of the old state (the inter-chunk
    // term) happened before intra_tile<0>'s barriers.
    const float et = sm_ecum[QM - 1];          // exp(total)
    float st[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        st[a][k] = et * sm_st[(sp + 16 * a) * BS + ss + 16 * k];
#pragma unroll 2
    for (int q = 0; q < n; ++q) {
      const float w = sm_wq[q];
      float xv[4], bv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = w * sm_x[q * XS + sp + 16 * a];
#pragma unroll
      for (int k = 0; k < 8; ++k) bv[k] = sm_b[q * BS + ss + 16 * k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 8; ++k) st[a][k] = fmaf(xv[a], bv[k], st[a][k]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        sm_st[(sp + 16 * a) * BS + ss + 16 * k] = st[a][k];
    __syncthreads();   // state written, chunk buffers free for the next one
  }
}

template <typename T>
cudaError_t launch(const void* xdt, const float* da, const void* b,
                   const void* c, void* y, int batch, int h, int g, int l,
                   int p, int s, int chunk, cudaStream_t stream) {
  const size_t smem = Smem::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(h, batch);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), da, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), h, g, l, p, s, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of xdt, b, c and y: 0 = float32, 1 = bfloat16; da is float32.
// Requires 1 <= chunk <= 128, 1 <= p <= 64, 1 <= s <= 128, h % g == 0.
// Returns the launch's cudaError_t.
int ssd_scan_fwd(const void* xdt, const void* da, const void* b,
                 const void* c, void* y, int dtype, int batch, int h, int g,
                 int l, int p, int s, int chunk, void* stream) {
  if (chunk < 1 || chunk > QM || p < 1 || p > PM || s < 1 || s > SMX ||
      g < 1 || h % g != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* daf = static_cast<const float*>(da);
  if (dtype == 0)
    return launch<float>(xdt, daf, b, c, y, batch, h, g, l, p, s, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xdt, daf, b, c, y, batch, h, g, l, p, s,
                                 chunk, st);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
