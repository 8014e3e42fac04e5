// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_fwd_kernel, driven by flash_attention_fwd and reached through
// repro/kernels/ops.py:flash_attention).  It computes the same function:
// blocked online-softmax attention with GQA (query head h reads KV head
// h / (Hq / Hkv), no repeat), causal masking, a sliding window
// (pos - window, pos], tanh soft-capping, a static q_offset, and a
// fully masked row that outputs 0.  Max, sum and accumulator stay in f32.
//
// Bound on an H100 SXM at the serving slice's shape, q (1,40,2048,128),
// k/v (1,8,2048,128), bf16, causal: 4 * 40 * 128 * 2048 * 2049 / 2
// = 4.3e10 FLOP, 43 us at 989 TFLOP/s (bf16 tensor cores); it moves
// 50 MB (q, k, v read once, o written once), 15 us at 3.35 TB/s.  So the
// function is bound by operations.
//
// Design, simple first: one block of 128 threads owns a 64-row Q tile of
// one (batch, head); the grid is (q tiles, Hq, B).  The block loops over
// its own KV range, whose ends it derives from causal, window and Skv --
// that loop replaces the TPU's sequential grid axis and scratch carry, and
// tiles wholly outside the range are never loaded.  Q, K and V tiles are
// staged in shared memory as f32 (dynamic shared memory: 214 KB at D=256),
// scores and P V run on the CUDA cores in f32 FMAs; the tensor cores
// (wgmma) and TMA are left for a later change, so this kernel runs well
// below the bound above.  Thread (ty, tx) of a 16 x 8 layout owns query
// rows 4ty..4ty+3 and score columns tx + 8j, so a row's 8 owners are
// neighbouring lanes of one warp and the row max and sum reduce with three
// shuffles.  The ragged edges (Sq, Skv not multiples of 64) are masked
// here; the wrapper pads nothing.  Each head dim is one instantiation
// (dispatch below); D must be a multiple of TX.  72 is the 2D DiT's
// (transformer2d-720m, 1152 / 16 heads): in bf16 it takes the tensor-core
// route (flash_attention_sm90.cu), in f32 this kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // KV rows per tile
constexpr int THREADS = 128;
constexpr int TX = 8;           // threads sharing one query row group
constexpr int RQ = BQ / (THREADS / TX);   // query rows per thread (4)
constexpr int RK = BK / TX;     // score columns per thread (8)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static constexpr int QS = D + 1;    // padded strides: no bank conflicts
  static constexpr int KS = D + 1;    // when lanes read different rows
  static constexpr int VS = D;
  static constexpr int SS = BK + 1;
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * SS);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, float scale, int causal, int window,
                 float softcap, int q_offset) {
  using L = Layout<D>;
  constexpr int DC = D / TX;        // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * L::QS;
  float* vs = ks + BK * L::KS;
  float* ss = vs + BK * L::VS;

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int row0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const T* qp = q + (size_t)(b * hq + h) * sq * D;
  const T* kp = k + (size_t)(b * hkv + hk) * skv * D;
  const T* vp = v + (size_t)(b * hkv + hk) * skv * D;
  T* op = o + (size_t)(b * hq + h) * sq * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    qs[r * L::QS + c] =
        row0 + r < sq ? to_float(qp[(size_t)(row0 + r) * D + c]) : 0.f;
  }

  // KV range that any row of this tile can see
  const int pos_first = q_offset + row0;
  const int pos_last = q_offset + min(row0 + BQ, sq) - 1;
  int kv_lo = 0, kv_hi = skv;
  if (causal) kv_hi = min(kv_hi, pos_last + 1);
  if (window > 0) kv_lo = max(0, pos_first - window + 1);
  kv_lo = kv_lo / BK * BK;

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // Q staged; the previous tile's K, V, P consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < skv;
      const size_t g = (size_t)(k0 + r) * D + c;
      ks[r * L::KS + c] = in ? to_float(kp[g]) : 0.f;
      vs[r * L::VS + c] = in ? to_float(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = qs[(ty * RQ + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = ks[(tx + j * TX) * L::KS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int pos = pos_first + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + j * TX;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= pos;
        if (window > 0) ok = ok && kpos > pos - window;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // no visible column yet: keep everything at zero
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p =
            s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        ss[(ty * RQ + i) * L::SS + tx + j * TX] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();      // a row's P is written and read by the same warp

    for (int c = 0; c < BK; ++c) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ss[(ty * RQ + i) * L::SS + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = vs[c * L::VS + tx + cc * TX];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = row0 + ty * RQ + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];   // fully masked row -> 0
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(op + (size_t)row * D + tx + c * TX, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int sq, int skv, float scale,
                   int causal, int window, float softcap, int q_offset,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, scale,
      causal, window, softcap, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, int b, int hq, int hkv, int sq, int skv,
                     float scale, int causal, int window, float softcap,
                     int q_offset, cudaStream_t stream) {
#define FA_CASE(DIM)                                                        \
  case DIM:                                                                 \
    return launch<T, DIM>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal,   \
                          window, softcap, q_offset, stream);
  switch (d) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(72)
    FA_CASE(128)
    FA_CASE(160)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window and
// softcap <= 0 no soft-cap.  Returns the launch's cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int b, int hq, int hkv, int sq, int skv,
                        int d, float scale, int causal, int window,
                        float softcap, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, o, b, hq, hkv, sq, skv, scale, causal,
                           window, softcap, q_offset, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, sq, skv, scale,
                                   causal, window, softcap, q_offset, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
