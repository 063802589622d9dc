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
// What bounds the tap loop (the forward): bytes, with the multiply-adds close
// behind.  At the main path's largest call (B=16, T=1280, C=512, K=31, bf16) the
// forward moves 42 MB, about 12.5 us at 3.35 TB/s, and does 325 M f32 multiply-adds,
// about 10 us at the f32 CUDA-core rate: the loop has to keep bytes flowing and the
// FMA stream dense at once.  The design (dwconv_kernel):
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
// The backward (dwconv_bwd_kernel) is one pass over x and g.  At B=8, T=1280,
// C=512, K=31 in bf16 it must move 31.5 MB (x and g read, dv written: 9.4 us at
// 3.35 TB/s) and do 325 M f32 multiply-adds (dv's and dw's 162.5 M each), as many
// as the forward at B=16.  Three launches (a dv pass, a dw pass staging x and
// g again, a fold of per-block partials) spent more on their passes than on the
// work, so the design reads x and g once, writes dv once, and takes one launch:
// - The forward's block and ring, twice: g and x stream through two rings of four
//   64-row chunks (the halo kept, the first K - 1 rows mirrored past the end) on
//   the same 16-byte cp.async schedule.
// - Half the warps compute dv from g's window and the flipped filter, as the
//   forward does (the same sums in the same order: the same bits as the forward's
//   tap loop with the filter flipped); the other half compute dw and db from the
//   same tiles: x's window against g's centre rows.  A thread owns a channel pair
//   and R rows of a tile; a dv thread keeps the filter (2K floats) and 2R sums, a
//   dw thread its 2K dw sums, 2 db sums and 2R g values, in registers: splitting
//   the two jobs between warps keeps either under 128 registers.  R = 8 at K = 31
//   (16 warps, one block an SM), R = 16 at K <= 15 (8 warps, two blocks an SM):
//   on an H100 each was the faster at its sizes (at K = 31 with R = 16 a thread's
//   unrolled walk over a tile is 1000 FMAs).
// - A dw thread carries its sums across the block's run of tiles; at the end the
//   dw warps fold their sums in warp order into one f32 partial row per channel
//   and tap, which the block writes to the scratch.  The last block of a 64-channel
//   slice to finish (a completion counter per slice: __threadfence, then atomicAdd
//   on the counter alone) sums the slice's partials in block order, 16 partials'
//   loads in flight at once, rounds dw and db once, and sets the counter back to
//   zero for the next call.  The sums take no atomics: the result is the same on
//   every run.
// - The grid is one wave where the work allows, each block the fewest tiles that
//   give it, so a slice has as few partials as the card's width needs.
// What is left at the top level is the fold's tail (the counter's and the
// partials' round trips to L2 after the last tile) and the taps' instruction
// stream; the tensor cores (dv as a Toeplitz product over many tiles) would be the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// the tap loop (the forward)
constexpr int kTapWarps = 8;
constexpr int kTapThreads = kTapWarps * 32;
constexpr int kTapChannels = 64;                  // a channel pair per lane
constexpr int kTapRows = 8;                       // output rows per thread and tile
constexpr int kTileT = kTapWarps * kTapRows;      // 64 rows a tile (and a chunk)
constexpr int kRingRows = 4 * kTileT;             // the ring: four chunks
constexpr int kTargetTapBlocks = 528;             // two waves of two blocks an SM

// the backward: as many dv warps as dw warps over the same rings; 8 rows a
// thread, 8 warps a role and one block an SM at K = 31, 16 rows, 4 warps and two
// blocks at K <= 15 (the faster of the two at each size on an H100)
constexpr int bwd_blocks_per_sm(int K) { return K > 16 ? 1 : 2; }
template <int K> struct Bwd {
  static constexpr int kRoleWarps = 8 / bwd_blocks_per_sm(K);
  static constexpr int kThreads = 2 * kRoleWarps * 32;
  static constexpr int kRows = kTileT / kRoleWarps;  // rows a thread and tile
};
constexpr int kSMs = 132;                         // an H100 SXM's
constexpr int kCounters = 1024;                   // the scratch's head: C <= 65536

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

// Chunk m of a block's run of tiles from one sequence xb ((seq, C)): input rows
// [tb - K / 2 + m kTileT, + kTileT), channels [c0, c0 + kTapChannels), into ring
// rows [(m % 4) kTileT, + kTileT), the first K - 1 of chunk 0 (mod 4) also past the
// ring's end; the last chunk (m = ntiles) only its first K - 1 rows, the last
// tile's right halo.  Rows and channels outside the input are zero.  By 16-byte
// cp.async (committed by the caller) when vec, else element by element.
template <typename T, int K, int kThreads>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ xb, T* ring, int m,
                                           int ntiles, int tb, int c0, int seq, int C,
                                           bool vec) {
  constexpr int kRowElems = kTapChannels;
  constexpr int kElems = 16 / (int)sizeof(T);     // channels a 16-byte chunk
  constexpr int kChunks = kRowElems / kElems;     // 16-byte chunks a row
  const int t_lo = tb - K / 2 + m * kTileT;
  const int rows = m < ntiles ? kTileT : K - 1;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
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
}

template <typename T, int K> constexpr int tap_smem_bytes() {
  return (kRingRows + K - 1) * kTapChannels * (int)sizeof(T) + K * kTapChannels * 4;
}

// The tap loop: out = conv(x, w) + bias.
// grid = (ceil(C / kTapChannels), ceil(ceil(seq / kTileT) / tiles), B); block =
// kTapThreads; tap_smem_bytes<T, K>() of dynamic shared memory.  Block (x, y, z)
// computes channels [kTapChannels x, + kTapChannels) of sequence z at the rows of
// tiles [tiles y, tiles (y + 1)).
template <typename T, int K>
__global__ void __launch_bounds__(kTapThreads, 2)
dwconv_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ out, int seq, int C, int tiles) {
  constexpr int kRowElems = kTapChannels;
  constexpr int kElems = 16 / (int)sizeof(T);     // channels a 16-byte chunk
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
  auto load_chunk = [&](int m) {
    copy_chunk<T, K, kTapThreads>(xb, ring, m, ntiles, tb, c0, seq, C, vec);
  };

  for (int i = tid; i < K * kTapChannels; i += kTapThreads) {
    const int j = i / kTapChannels;
    const int c = c0 + i % kTapChannels;
    w_s[i] = c < C ? to_float(w[(size_t)c * K + j]) : 0.f;
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
  if (c < C) b0 = to_float(bias[c]);
  if (c + 1 < C) b1 = to_float(bias[c + 1]);
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

// the dw warps' barrier (named barrier 1, their kWarps warps)
template <int kWarps> __device__ __forceinline__ void dw_warps_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32) : "memory");
}

template <typename T, int K> constexpr int bwd_smem_bytes() {
  return 2 * (kRingRows + K - 1) * kTapChannels * (int)sizeof(T) +
         (K + 1) * kTapChannels * 4;
}

// The backward in one pass: dv, and this block's partial of dw and db; the last
// block of a channel slice to finish sums the slice's partials into dw and db.
// grid = bwd_grid (as tap_grid: channel slice, run of tiles, sequence); block =
// Bwd<K>::kThreads; bwd_smem_bytes<T, K>() of dynamic shared memory.  partial holds
// gridDim.x * gridDim.y * gridDim.z rows of (K + 1) x 64 floats; counters[x] is 0
// on entry and is left 0.
template <typename T, int K>
__global__ void __launch_bounds__(Bwd<K>::kThreads, bwd_blocks_per_sm(K))
dwconv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ w,
                  T* __restrict__ dv, T* __restrict__ dw, T* __restrict__ db,
                  float* __restrict__ partial, unsigned* __restrict__ counters, int seq,
                  int C, int tiles) {
  constexpr int kPad = K / 2;
  constexpr int kRowElems = kTapChannels;
  constexpr int kElems = 16 / (int)sizeof(T);     // channels a 16-byte chunk
  constexpr int kSums = (K + 1) * kTapChannels;   // a partial: dw's K taps, then db
  constexpr int kRoleWarps = Bwd<K>::kRoleWarps;
  constexpr int kBwdThreads = Bwd<K>::kThreads;
  constexpr int kBwdRows = Bwd<K>::kRows;
  extern __shared__ __align__(16) unsigned char smem_c[];
  T* g_ring = reinterpret_cast<T*>(smem_c);       // [kRingRows + K - 1][kRowElems]
  T* x_ring = g_ring + (kRingRows + K - 1) * kRowElems;
  // the flipped filter [K][64] for the dv warps; then the block's sums [K + 1][64]
  float* w_s = reinterpret_cast<float*>(x_ring + (kRingRows + K - 1) * kRowElems);
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kTapChannels;
  const int tb = blockIdx.y * tiles * kTileT;     // the run's first output row
  const int ntiles = min(tiles, (seq - tb + kTileT - 1) / kTileT);
  const size_t seq0 = (size_t)blockIdx.z * seq * C;
  const bool vec = C % kElems == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  auto load_chunk = [&](int m) {
    copy_chunk<T, K, kBwdThreads>(g + seq0, g_ring, m, ntiles, tb, c0, seq, C, vec);
    copy_chunk<T, K, kBwdThreads>(x + seq0, x_ring, m, ntiles, tb, c0, seq, C, vec);
  };

  for (int i = tid; i < K * kTapChannels; i += kBwdThreads) {
    const int j = i / kTapChannels;
    const int c = c0 + i % kTapChannels;
    w_s[i] = c < C ? to_float(w[(size_t)c * K + K - 1 - j]) : 0.f;
  }
  const int nchunks = ntiles + 1;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (m < nchunks) load_chunk(m);
    zv::cp_async_commit();
  }
  __syncthreads();  // w_s is written

  // before tile n: chunks n and n + 1 have landed and everyone is done with tile
  // n - 1, whose chunk takes chunk n + 3
  auto advance = [&](int n) {
    zv::cp_async_wait<1>();
    __syncthreads();
    if (n + 3 < nchunks) load_chunk(n + 3);
    zv::cp_async_commit();
  };
  const bool dv_warp = warp < kRoleWarps;
  const int rw = warp % kRoleWarps;               // the warp's place in its role
  const int r0 = rw * kBwdRows;                   // the thread's first row of a tile
  const int c = c0 + 2 * lane;                    // and its channel pair
  if (dv_warp) {
    // dv: the forward's taps over g's window with the flipped filter
    float wr[K][2];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(w_s + j * kTapChannels + 2 * lane);
      wr[j][0] = v.x;
      wr[j][1] = v.y;
    }
    const bool packed =
        C % 2 == 0 && reinterpret_cast<uintptr_t>(dv) % (2 * sizeof(T)) == 0;
    for (int n = 0; n < ntiles; ++n) {
      advance(n);
      const T* win = g_ring + ((n & 3) * kTileT + r0) * kRowElems + 2 * lane;
      float acc[kBwdRows][2];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
      for (int u = 0; u < kBwdRows + K - 1; ++u) {
        const float2 v = load_pair(win + u * kRowElems);
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          const int j = u - r;
          if (j >= 0 && j < K) {
            acc[r][0] = fmaf(v.x, wr[j][0], acc[r][0]);
            acc[r][1] = fmaf(v.y, wr[j][1], acc[r][1]);
          }
        }
      }
      if (c >= C) continue;
      const int t0 = tb + n * kTileT + r0;
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const int t = t0 + r;
        if (t >= seq) break;
        T* dst = dv + seq0 + (size_t)t * C + c;
        if (packed && c + 1 < C) {
          store_pair(dst, acc[r][0], acc[r][1]);
        } else {
          dst[0] = from_float<T>(acc[r][0]);
          if (c + 1 < C) dst[1] = from_float<T>(acc[r][1]);
        }
      }
    }
  } else {
    // dw and db: x's window against g's centre rows (window row r + kPad), the
    // sums carried across the run of tiles
    float s[K][2], s_b0 = 0.f, s_b1 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) s[j][0] = s[j][1] = 0.f;
    for (int n = 0; n < ntiles; ++n) {
      advance(n);
      const int base = ((n & 3) * kTileT + r0) * kRowElems + 2 * lane;
      const T* xw = x_ring + base;
      const T* gc = g_ring + base + kPad * kRowElems;
      float gr[kBwdRows][2];
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const float2 v = load_pair(gc + r * kRowElems);
        gr[r][0] = v.x;
        gr[r][1] = v.y;
        s_b0 += v.x;
        s_b1 += v.y;
      }
#pragma unroll
      for (int u = 0; u < kBwdRows + K - 1; ++u) {
        const float2 v = load_pair(xw + u * kRowElems);
#pragma unroll
        for (int r = 0; r < kBwdRows; ++r) {
          const int j = u - r;  // x row r + j against g row r
          if (j >= 0 && j < K) {
            s[j][0] = fmaf(v.x, gr[r][0], s[j][0]);
            s[j][1] = fmaf(v.y, gr[r][1], s[j][1]);
          }
        }
      }
    }
    zv::cp_async_wait<0>();
    // the four dw warps' sums into w_s, in warp order (the dv warps read the
    // filter before the first tile's barrier, which every dw warp has passed)
    for (int q = 0; q < kRoleWarps; ++q) {
      dw_warps_sync<kRoleWarps>();
      if (rw != q) continue;
#pragma unroll
      for (int j = 0; j <= K; ++j) {
        float2* dst = reinterpret_cast<float2*>(w_s + j * kTapChannels + 2 * lane);
        const float a = j < K ? s[j][0] : s_b0, b = j < K ? s[j][1] : s_b1;
        const float2 o = q ? *dst : make_float2(0.f, 0.f);
        *dst = make_float2(o.x + a, o.y + b);
      }
    }
  }
  zv::cp_async_wait<0>();
  __syncthreads();  // the block's sums are in w_s

  // this block's partial, then the slice's count of finished blocks
  constexpr int kQuads = kSums / 4;
  const int P = gridDim.y * gridDim.z;
  const float4* w_q = reinterpret_cast<const float4*>(w_s);
  float4* slice = reinterpret_cast<float4*>(partial) + (size_t)blockIdx.x * P * kQuads;
  float4* mine = slice + (size_t)(blockIdx.z * gridDim.y + blockIdx.y) * kQuads;
  for (int i = tid; i < kQuads; i += kBwdThreads) mine[i] = w_q[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + blockIdx.x, 1u) == (unsigned)P - 1;
    if (last) counters[blockIdx.x] = 0;  // every block of the slice has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the slice's partials summed in block order, from L2, the
  // loads of kBatch partials in flight at once
  constexpr int kBatch = 16;
  for (int i = tid; i < kQuads; i += kBwdThreads) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < P; q0 += kBatch) {
      float4 part[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (q0 + b < P) part[b] = __ldcg(slice + (size_t)(q0 + b) * kQuads + i);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (q0 + b >= P) break;
        sum.x += part[b].x;
        sum.y += part[b].y;
        sum.z += part[b].z;
        sum.w += part[b].w;
      }
    }
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
    const int j = 4 * i / kTapChannels;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = c0 + 4 * i % kTapChannels + e;
      if (cc >= C) break;
      if (j < K)
        dw[(size_t)cc * K + j] = from_float<T>(v[e]);
      else
        db[cc] = from_float<T>(v[e]);
    }
  }
}

// The backward's grid (channel slice, run of tiles, sequence) and each block's run
// of tiles: as many blocks as one wave holds, where the work allows, the fewest
// tiles a block that gives them.
dim3 bwd_grid(int B, int seq, int C, int K, int* tiles) {
  const int total = (seq + kTileT - 1) / kTileT;
  const int slices = (C + kTapChannels - 1) / kTapChannels;
  int splits = kSMs * bwd_blocks_per_sm(K) / (B * slices);
  splits = splits < 1 ? 1 : splits > total ? total : splits;
  *tiles = (total + splits - 1) / splits;
  return dim3(slices, (total + *tiles - 1) / *tiles, B);
}

template <typename T, int K>
cudaError_t taps(const void* x, const void* w, const void* bias, void* out, int B, int seq,
                 int C, cudaStream_t stream) {
  constexpr int smem = tap_smem_bytes<T, K>();
  auto kernel = dwconv_kernel<T, K>;
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
                     float* scratch, int B, int seq, int C, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<T, K>();
  auto kernel = dwconv_bwd_kernel<T, K>;
  int tiles;
  const dim3 grid = bwd_grid(B, seq, C, K, &tiles);
  if (grid.x > (unsigned)kCounters) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Bwd<K>::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<T*>(dv), static_cast<T*>(dw), static_cast<T*>(db), scratch + kCounters,
      reinterpret_cast<unsigned*>(scratch), seq, C, tiles);
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
  case K: return taps<T, K>(x, w, bias, out, B, seq, C, s);
    ZV_DWCONV_SIZES(ZV_CASE)
#undef ZV_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t backward_k(int k, const void* x, const void* g, const void* w, void* dv, void* dw,
                       void* db, float* scratch, int B, int seq, int C, cudaStream_t s) {
  switch (k) {
#define ZV_CASE(K) \
  case K: return backward<T, K>(x, g, w, dv, dw, db, scratch, B, seq, C, s);
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
// the upstream gradient g (both (B, seq, C)) and w (C, k), in one launch.  scratch is
// f32 of zv_depthwise_conv1d_bwd_scratch_floats(B, seq, C, k) floats whose head (the
// completion counters) is zero: zero it once and keep it for the calls on one stream,
// which leave the head zero.
extern "C" int zv_depthwise_conv1d_bwd(int dtype, int k, const void* x, const void* g,
                                       const void* w, void* dv, void* dw, void* db,
                                       void* scratch, int B, int seq, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  switch (dtype) {
    case 0: return backward_k<float>(k, x, g, w, dv, dw, db, f, B, seq, C, s);
    case 1: return backward_k<__nv_bfloat16>(k, x, g, w, dv, dw, db, f, B, seq, C, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" long long zv_depthwise_conv1d_bwd_scratch_floats(int B, int seq, int C, int k) {
  int tiles;
  const dim3 grid = bwd_grid(B, seq, C, k, &tiles);
  return kCounters + (long long)grid.x * grid.y * grid.z * (k + 1) * kTapChannels;
}
