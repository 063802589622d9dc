// SAME-padded depthwise conv1d over time for Hopper (sm_90a): forward and backward.
//
// The forward replaces the TPU kernel zipvoice_tpu/ops/pallas_conv.py::_dwconv_kernel
// (reached through depthwise_conv1d), the backward replaces ::_dwconv_bwd_kernel (the
// VJP of depthwise_conv1d_vjp).  In the port's (B, T, C) layout, channels contiguous,
// with an odd kernel size K, pad = K / 2, and x[b, t, c] = 0 outside 0 <= t < T:
//
//   out[b, t, c] = sum_j x[b, t + j - pad, c] * w[c, j] + bias[c]
//   dv[b, t, c]  = sum_j g[b, t + j - pad, c] * w[c, K - 1 - j]      (flipped filter)
//   dw[c, j]     = sum_b sum_t x[b, t + j - pad, c] * g[b, t, c]
//   db[c]        = sum_b sum_t g[b, t, c]
//
// w is the reference parameter depthwise_conv.weight (C, 1, K) read as (C, K).  Taps
// are summed in f32 in the order j = 0..K-1, the bias is added in f32, and each
// output is rounded once to the input dtype; dw and db are f32 sums rounded once to
// the weight's dtype, as the JAX package returns them.
//
// What bounds it: bytes.  At the main path's largest call (B=16, T=1280, C=512,
// K=31, bf16) the forward moves 42 MB against 0.33 G multiply-adds, about 12.5 us at
// 3.35 TB/s.  A block owns a tile of kTileRows time rows by kTileChannels channels:
// it stages the tile and its K-1 halo rows in shared memory (zero-filled past the
// sequence ends: the SAME padding costs no copy of the input), and each thread slides
// a register window of kRowsPerThread + K - 1 inputs over its channel, so a staged
// value is read from shared memory about (kRowsPerThread + K - 1) / kRowsPerThread
// times instead of K times.
//
// The TPU backward accumulates dw and db in an output block revisited by a
// sequential grid.  Here blocks run in no order, so each block of the dw pass sums
// its share of (batch, time tile) tiles into registers, folds its four row groups in
// a fixed order and writes one f32 partial row per channel; a fold kernel then sums
// the partials in index order.  No atomics: the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileChannels = 64;                        // threadIdx.x % 64
constexpr int kRowGroups = kThreads / kTileChannels;     // threadIdx.x / 64
constexpr int kRowsPerThread = 16;
constexpr int kTileRows = kRowGroups * kRowsPerThread;   // 64
constexpr int kTargetBlocks = 264;                       // two per SM for the dw pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [t_lo, t_lo + rows) of x (one sequence, (seq, C)) and channels
// [c0, c0 + kTileChannels) into dst[rows][kTileChannels] as f32, zero outside.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, float* __restrict__ dst,
                                      int t_lo, int rows, int c0, int seq, int C) {
  for (int i = threadIdx.x; i < rows * kTileChannels; i += kThreads) {
    const int t = t_lo + i / kTileChannels;
    const int c = c0 + i % kTileChannels;
    dst[i] = (t >= 0 && t < seq && c < C) ? to_float(x[(size_t)t * C + c]) : 0.f;
  }
}

// The tap loop.  kFlip = false: the forward, out = conv(x, w) + bias.
// kFlip = true: dv = conv(g, flipped w), no bias.
// grid = (ceil(C / 64), ceil(seq / 64), B); block = kThreads.
template <typename T, int K, bool kFlip>
__global__ void __launch_bounds__(kThreads)
dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ out, int seq, int C) {
  constexpr int kPad = K / 2;
  constexpr int kWin = kRowsPerThread + K - 1;
  __shared__ float x_s[(kTileRows + K - 1) * kTileChannels];
  __shared__ float w_s[K * kTileChannels];

  const int c0 = blockIdx.x * kTileChannels;
  const int t0 = blockIdx.y * kTileRows;
  const int b = blockIdx.z;
  const int cx = threadIdx.x % kTileChannels;
  const int r0 = (threadIdx.x / kTileChannels) * kRowsPerThread;

  stage(x + (size_t)b * seq * C, x_s, t0 - kPad, kTileRows + K - 1, c0, seq, C);
  for (int i = threadIdx.x; i < K * kTileChannels; i += kThreads) {
    const int j = i / kTileChannels;
    const int c = c0 + i % kTileChannels;
    w_s[i] = c < C ? to_float(w[(size_t)c * K + (kFlip ? K - 1 - j : j)]) : 0.f;
  }
  __syncthreads();

  const int c = c0 + cx;
  if (c >= C) return;
  float wr[K];
#pragma unroll
  for (int j = 0; j < K; ++j) wr[j] = w_s[j * kTileChannels + cx];
  float win[kWin];
#pragma unroll
  for (int i = 0; i < kWin; ++i) win[i] = x_s[(r0 + i) * kTileChannels + cx];
  const float bv = kFlip ? 0.f : to_float(bias[c]);
  T* ob = out + (size_t)b * seq * C + c;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) acc = fmaf(win[r + j], wr[j], acc);
    const int t = t0 + r0 + r;
    if (t < seq) ob[(size_t)t * C] = from_float<T>(acc + bv);
  }
}

// Number of dw partials: enough blocks to fill the card, at most one per tile.
int dw_partials(int B, int seq, int C) {
  const int tiles = B * ((seq + kTileRows - 1) / kTileRows);
  const int channel_tiles = (C + kTileChannels - 1) / kTileChannels;
  int p = kTargetBlocks / channel_tiles;
  if (p < 1) p = 1;
  return p < tiles ? p : tiles;
}

// dw and db partials.  grid = (ceil(C / 64), P); block p sums tiles p, p + P, ...
// of the B * ceil(seq / 64) (sequence, time tile) pairs and writes
// partial[p][j][c] (j < K) and partial[p][K][c] (the bias), f32.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dwconv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ partial,
                 int B, int seq, int C) {
  constexpr int kPad = K / 2;
  constexpr int kWin = kRowsPerThread + K - 1;
  __shared__ float x_s[(kTileRows + K - 1) * kTileChannels];
  __shared__ float g_s[kTileRows * kTileChannels];

  const int c0 = blockIdx.x * kTileChannels;
  const int cx = threadIdx.x % kTileChannels;
  const int group = threadIdx.x / kTileChannels;
  const int r0 = group * kRowsPerThread;
  const int tiles_per_seq = (seq + kTileRows - 1) / kTileRows;
  const int tiles = B * tiles_per_seq;

  float dw[K];
#pragma unroll
  for (int j = 0; j < K; ++j) dw[j] = 0.f;
  float db = 0.f;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int b = tile / tiles_per_seq;
    const int t0 = (tile - b * tiles_per_seq) * kTileRows;
    __syncthreads();  // the previous tile is consumed
    stage(x + (size_t)b * seq * C, x_s, t0 - kPad, kTileRows + K - 1, c0, seq, C);
    stage(g + (size_t)b * seq * C, g_s, t0, kTileRows, c0, seq, C);
    __syncthreads();
    float win[kWin];
#pragma unroll
    for (int i = 0; i < kWin; ++i) win[i] = x_s[(r0 + i) * kTileChannels + cx];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float gr = g_s[(r0 + r) * kTileChannels + cx];
      db += gr;
#pragma unroll
      for (int j = 0; j < K; ++j) dw[j] = fmaf(win[r + j], gr, dw[j]);
    }
  }

  // fold the row groups in order 0, 1, 2, 3 through shared memory (x_s is free)
  float* red = x_s;  // [K + 1][kTileChannels]
  for (int s = 0; s < kRowGroups; ++s) {
    __syncthreads();
    if (group == s) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        red[j * kTileChannels + cx] = (s ? red[j * kTileChannels + cx] : 0.f) + dw[j];
      red[K * kTileChannels + cx] = (s ? red[K * kTileChannels + cx] : 0.f) + db;
    }
  }
  __syncthreads();
  const int c = c0 + cx;
  if (group == 0 && c < C) {
    float* dst = partial + (size_t)blockIdx.y * (K + 1) * C + c;
#pragma unroll
    for (int j = 0; j <= K; ++j) dst[(size_t)j * C] = red[j * kTileChannels + cx];
  }
}

// dw[c, j] = sum_p partial[p][j][c], db[c] = sum_p partial[p][K][c], summed in order
// of p and rounded once to T.  One thread per (j, c).
template <typename T>
__global__ void dwconv_fold_kernel(const float* __restrict__ partial, int P, int K, int C,
                                   T* __restrict__ dw, T* __restrict__ db) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (K + 1) * C) return;
  const int j = i / C;
  const int c = i - j * C;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[((size_t)p * (K + 1) + j) * C + c];
  if (j < K)
    dw[(size_t)c * K + j] = from_float<T>(s);
  else
    db[c] = from_float<T>(s);
}

dim3 tap_grid(int B, int seq, int C) {
  return dim3((C + kTileChannels - 1) / kTileChannels, (seq + kTileRows - 1) / kTileRows, B);
}

template <typename T, int K>
cudaError_t forward(const void* x, const void* w, const void* bias, void* out, int B, int seq,
                    int C, cudaStream_t stream) {
  dwconv_kernel<T, K, false><<<tap_grid(B, seq, C), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), seq, C);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t backward(const void* x, const void* g, const void* w, void* dv, void* dw, void* db,
                     float* partial, int B, int seq, int C, cudaStream_t stream) {
  dwconv_kernel<T, K, true><<<tap_grid(B, seq, C), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), nullptr, static_cast<T*>(dv), seq, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = dw_partials(B, seq, C);
  dwconv_dw_kernel<T, K><<<dim3((C + kTileChannels - 1) / kTileChannels, P), kThreads, 0,
                           stream>>>(static_cast<const T*>(x), static_cast<const T*>(g), partial,
                                     B, seq, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (K + 1) * C;
  dwconv_fold_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(partial, P, K, C,
                                                              static_cast<T*>(dw),
                                                              static_cast<T*>(db));
  return cudaGetLastError();
}

// The kernel sizes the ZipVoice models use (31, 15, 7 in the fm_decoder, 9 in the
// text encoder) and the small ones of the tests (3, 5).  The wrapper rejects others.
#define ZV_DWCONV_SIZES(X) X(3) X(5) X(7) X(9) X(15) X(31)

template <typename T>
cudaError_t forward_k(int k, const void* x, const void* w, const void* bias, void* out, int B,
                      int seq, int C, cudaStream_t s) {
  switch (k) {
#define ZV_CASE(K) \
  case K: return forward<T, K>(x, w, bias, out, B, seq, C, s);
    ZV_DWCONV_SIZES(ZV_CASE)
#undef ZV_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward_k(int k, const void* x, const void* g, const void* w, void* dv, void* dw,
                       void* db, float* partial, int B, int seq, int C, cudaStream_t s) {
  switch (k) {
#define ZV_CASE(K) \
  case K: return backward<T, K>(x, g, w, dv, dw, db, partial, B, seq, C, s);
    ZV_DWCONV_SIZES(ZV_CASE)
#undef ZV_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x: (B, seq, C); w: (C, k); bias: (C,); out:
// (B, seq, C); all contiguous and of one dtype.  Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int zv_depthwise_conv1d(int dtype, int k, const void* x, const void* w,
                                   const void* bias, void* out, int B, int seq, int C,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return forward_k<float>(k, x, w, bias, out, B, seq, C, s);
    case 1: return forward_k<__nv_bfloat16>(k, x, w, bias, out, B, seq, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward: dv (B, seq, C), dw (C, k) and db (C,) in the inputs' dtype from x and
// the upstream gradient g (both (B, seq, C)) and w (C, k).  partial is f32 scratch of
// zv_depthwise_conv1d_bwd_scratch_floats(B, seq, C, k) floats.
extern "C" int zv_depthwise_conv1d_bwd(int dtype, int k, const void* x, const void* g,
                                       const void* w, void* dv, void* dw, void* db,
                                       void* partial, int B, int seq, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(partial);
  switch (dtype) {
    case 0: return backward_k<float>(k, x, g, w, dv, dw, db, scratch, B, seq, C, s);
    case 1:
      return backward_k<__nv_bfloat16>(k, x, g, w, dv, dw, db, scratch, B, seq, C, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" long long zv_depthwise_conv1d_bwd_scratch_floats(int B, int seq, int C, int k) {
  return (long long)dw_partials(B, seq, C) * (k + 1) * C;
}
