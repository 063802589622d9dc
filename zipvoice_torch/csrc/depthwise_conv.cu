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
// What bounds the tap loop (the forward, and dv): bytes, with the multiply-adds
// close behind.  At the main path's largest call (B=16, T=1280, C=512, K=31, bf16)
// the forward moves 42 MB, about 12.5 us at 3.35 TB/s, and does 325 M f32
// multiply-adds, about 10 us at the f32 CUDA-core rate: the loop has to keep bytes
// flowing and the FMA stream dense at once.  The design (dwconv_kernel):
// - A block owns 64 channels of one sequence and walks down time over a run of
//   64-row tiles.  The input streams through a ring of four 64-row chunks in
//   shared memory, in the input dtype, filled by 16-byte cp.async two chunks ahead
//   of the tile being computed, so each tile's copy overlaps earlier tiles' taps.
//   A tile reads its own chunk and the next chunk's first K - 1 rows: the halo is
//   kept, not fetched again, and only the rows at the ends of a block's run are
//   read twice (by the neighbouring blocks).  SAME padding is the copy's zero fill.
// - The ring's first K - 1 rows are mirrored past its end, so a thread's window of
//   rows is contiguous in shared memory and every load has a constant offset.
// - A thread owns a channel pair (a bf16x2 or float2 load, a warp reading one
//   128- or 256-byte row segment without bank conflicts) and 8 output rows; it
//   keeps the pair's filter (2K floats) and 16 sums in registers and walks its
//   8 + K - 1 input rows once, adding each row into every sum it reaches: K f32
//   FMAs per output, in tap order, for 1 + (K - 1) / 8 row loads per output row.
// - Stores are 4-byte bf16x2 (8-byte float2) per lane: a warp writes 128 (256)
//   contiguous bytes a row.
// - Ragged C is masked (a C that is no multiple of 16 bytes is copied element by
//   element, an odd C stored element by element); ragged T, and T < K, are the
//   zero fill and masked stores.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) that shape takes about 2.6x
// its byte bound, and what is left is the taps' instruction stream (f32 FMAs, the
// bf16 pairs' unpacking, the loads) more than the copies: the next step is the
// tensor cores.
//
// The TPU backward accumulates dw and db in an output block revisited by a
// sequential grid.  Here blocks run in no order, so each block of the dw pass sums
// its share of (batch, time tile) tiles into registers, folds its four row groups in
// a fixed order and writes one f32 partial row per channel; a fold kernel then sums
// the partials in index order.  No atomics: the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// the dw pass
constexpr int kThreads = 256;
constexpr int kTileChannels = 64;                        // threadIdx.x % 64
constexpr int kRowGroups = kThreads / kTileChannels;     // threadIdx.x / 64
constexpr int kRowsPerThread = 16;
constexpr int kTileRows = kRowGroups * kRowsPerThread;   // 64
constexpr int kTargetBlocks = 264;                       // two per SM for the dw pass

// the tap loop (forward and dv)
constexpr int kTapWarps = 8;
constexpr int kTapThreads = kTapWarps * 32;
constexpr int kTapChannels = 64;                  // a channel pair per lane
constexpr int kTapRows = 8;                       // output rows per thread and tile
constexpr int kTileT = kTapWarps * kTapRows;      // 64 rows a tile (and a chunk)
constexpr int kRingRows = 4 * kTileT;             // the ring: four chunks
constexpr int kTargetTapBlocks = 528;             // two waves of two blocks an SM

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a channel pair from shared memory, and stored packed to device memory
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return zv::unpack_bf16(*reinterpret_cast<const unsigned*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = zv::pack_bf16(a, b);
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

template <typename T, int K> constexpr int tap_smem_bytes() {
  return (kRingRows + K - 1) * kTapChannels * (int)sizeof(T) + K * kTapChannels * 4;
}

// The tap loop.  kFlip = false: the forward, out = conv(x, w) + bias.
// kFlip = true: dv = conv(g, flipped w), no bias.
// grid = (ceil(C / kTapChannels), ceil(ceil(seq / kTileT) / tiles), B); block =
// kTapThreads; tap_smem_bytes<T, K>() of dynamic shared memory.  Block (x, y, z)
// computes channels [kTapChannels x, + kTapChannels) of sequence z at the rows of
// tiles [tiles y, tiles (y + 1)).
template <typename T, int K, bool kFlip>
__global__ void __launch_bounds__(kTapThreads, 2)
dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ out, int seq, int C, int tiles) {
  constexpr int kPad = K / 2;
  constexpr int kRowElems = kTapChannels;
  constexpr int kElems = 16 / (int)sizeof(T);     // channels a 16-byte chunk
  constexpr int kChunks = kRowElems / kElems;     // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_c[];
  T* ring = reinterpret_cast<T*>(smem_c);         // [kRingRows + K - 1][kRowElems]
  float* w_s = reinterpret_cast<float*>(ring + (kRingRows + K - 1) * kRowElems);  // [K][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kTapChannels;
  const int tb = blockIdx.y * tiles * kTileT;     // the run's first output row
  const int ntiles = min(tiles, (seq - tb + kTileT - 1) / kTileT);
  const T* xb = x + (size_t)blockIdx.z * seq * C;
  T* ob = out + (size_t)blockIdx.z * seq * C;
  const bool vec = C % kElems == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // Chunk m: input rows [tb - kPad + m kTileT, + kTileT) into ring rows
  // [(m % 4) kTileT, + kTileT), the first K - 1 of chunk 0 (mod 4) also past the
  // ring's end; the last chunk (m = ntiles) only its first K - 1 rows, the last
  // tile's right halo.
  auto load_chunk = [&](int m) {
    const int t_lo = tb - kPad + m * kTileT;
    const int rows = m < ntiles ? kTileT : K - 1;
    for (int i = tid; i < rows * kChunks; i += kTapThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const int t = t_lo + r;
      const int c = c0 + ch * kElems;
      const int slot = (m & 3) * kTileT + r;
      T* dst = ring + slot * kRowElems + ch * kElems;
      const bool mirror = slot < K - 1;
      if (vec) {
        const bool ok = t >= 0 && t < seq && c < C;
        const T* src = xb + (ok ? (size_t)t * C + c : 0);
        zv::cp_async16(zv::smem_addr(dst), src, ok);
        if (mirror) zv::cp_async16(zv::smem_addr(dst + kRingRows * kRowElems), src, ok);
      } else {
        for (int e = 0; e < kElems; ++e) {
          const T v = t >= 0 && t < seq && c + e < C ? xb[(size_t)t * C + c + e]
                                                     : from_float<T>(0.f);
          dst[e] = v;
          if (mirror) dst[kRingRows * kRowElems + e] = v;
        }
      }
    }
  };

  for (int i = tid; i < K * kTapChannels; i += kTapThreads) {
    const int j = i / kTapChannels;
    const int c = c0 + i % kTapChannels;
    w_s[i] = c < C ? to_float(w[(size_t)c * K + (kFlip ? K - 1 - j : j)]) : 0.f;
  }
  const int nchunks = ntiles + 1;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (m < nchunks) load_chunk(m);
    zv::cp_async_commit();
  }
  __syncthreads();  // w_s is written

  const int c = c0 + 2 * lane;  // this thread's channel pair
  float wr[K][2];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(w_s + j * kTapChannels + 2 * lane);
    wr[j][0] = v.x;
    wr[j][1] = v.y;
  }
  float b0 = 0.f, b1 = 0.f;
  if constexpr (!kFlip) {
    if (c < C) b0 = to_float(bias[c]);
    if (c + 1 < C) b1 = to_float(bias[c + 1]);
  }
  // (t C + c) is even for an even C: the pair is one aligned store
  const bool packed = C % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0;
  const int r0 = warp * kTapRows;

  for (int n = 0; n < ntiles; ++n) {
    zv::cp_async_wait<1>();  // chunks n and n + 1 have landed (this thread's copies)
    __syncthreads();         // ... everyone's; everyone is done with tile n - 1
    if (n + 3 < nchunks) load_chunk(n + 3);  // into tile n - 1's chunk
    zv::cp_async_commit();
    // output row r0 + r of the tile reads window rows r .. r + K - 1
    const T* win = ring + ((n & 3) * kTileT + r0) * kRowElems + 2 * lane;
    float acc[kTapRows][2];
#pragma unroll
    for (int r = 0; r < kTapRows; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
    for (int u = 0; u < kTapRows + K - 1; ++u) {
      const float2 v = load_pair(win + u * kRowElems);
#pragma unroll
      for (int r = 0; r < kTapRows; ++r) {
        const int j = u - r;  // the tap this row is to output r0 + r
        if (j >= 0 && j < K) {
          acc[r][0] = fmaf(v.x, wr[j][0], acc[r][0]);
          acc[r][1] = fmaf(v.y, wr[j][1], acc[r][1]);
        }
      }
    }
    if (c >= C) continue;
    const int t0 = tb + n * kTileT + r0;
#pragma unroll
    for (int r = 0; r < kTapRows; ++r) {
      const int t = t0 + r;
      if (t >= seq) break;
      T* dst = ob + (size_t)t * C + c;
      if (packed && c + 1 < C) {
        store_pair(dst, acc[r][0] + b0, acc[r][1] + b1);
      } else {
        dst[0] = from_float<T>(acc[r][0] + b0);
        if (c + 1 < C) dst[1] = from_float<T>(acc[r][1] + b1);
      }
    }
  }
  zv::cp_async_wait<0>();
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

// The tap loop's grid and each block's run of tiles: enough blocks to fill the
// card, the fewest tiles a block that gives them.
dim3 tap_grid(int B, int seq, int C, int* tiles) {
  const int total = (seq + kTileT - 1) / kTileT;
  const int slices = (C + kTapChannels - 1) / kTapChannels;
  const int pairs = B * slices;
  int splits = (kTargetTapBlocks + pairs - 1) / pairs;
  splits = splits < 1 ? 1 : splits > total ? total : splits;
  *tiles = (total + splits - 1) / splits;
  return dim3(slices, (total + *tiles - 1) / *tiles, B);
}

template <typename T, int K, bool kFlip>
cudaError_t taps(const void* x, const void* w, const void* bias, void* out, int B, int seq,
                 int C, cudaStream_t stream) {
  constexpr int smem = tap_smem_bytes<T, K>();
  auto kernel = dwconv_kernel<T, K, kFlip>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int tiles;
  const dim3 grid = tap_grid(B, seq, C, &tiles);
  kernel<<<grid, kTapThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), seq, C, tiles);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t backward(const void* x, const void* g, const void* w, void* dv, void* dw, void* db,
                     float* partial, int B, int seq, int C, cudaStream_t stream) {
  cudaError_t err = taps<T, K, true>(g, w, nullptr, dv, B, seq, C, stream);
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
  case K: return taps<T, K, false>(x, w, bias, out, B, seq, C, s);
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
