// Relative-position attention weights fused with NonlinAttention's application of
// head 0's weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel zipvoice_tpu/ops/pallas_attention.py::_attn_weights_nonlin_kernel
// (reached through rel_pos_attention_weights_nonlin).  For every (b, h, query row i, key j):
//
//   w[b,h,i,j] = softmax_j( q_i . k_j + p_i . pe[h, j - i + T - 1] ),  a masked key's
//                score replaced by -1000 (a fully masked row stays uniform at 1/T),
//   na[b,i,:]  = sum_j wc[b,0,i,j] * nv[b,j,:],   wc = w rounded to the output dtype
//                                                 as the TPU kernel's `wc` is,
//
// in f32, each output rounded once.  Against the inference weights kernel plus a
// product it saves a launch, and head 0's (B, T, T) weights are read back by the
// block that has just written them (so mostly from L2) instead of by another kernel.
//
// What bounds it: the (B, h, T, T) write, 210 MB at the main path's shape (B=16
// after CFG doubling, h=4, T=1280, bf16, hid 384), about 63 us at 3.35 TB/s,
// against 20 GFLOP of na products (20 us on the tensor cores at their peak) and,
// for the softmax, an exp per score (105 M) on the special-function units.
//
// The bf16 build (nonlin_mma_kernel) is laid out for that:
// - Its weights come from the two sweeps of rel_pos_sweeps.cuh, the code the
//   inference weights kernel (rel_pos_attention.cu, bf16) runs too: 64-row blocks of
//   8 warps, tensor-core q.k^T, the rel-pos term on the CUDA cores from an f32 pe
//   window, an online max and sum in sweep 1, one rounding per weight in sweep 2,
//   warp-local 16-byte stores.  That header says what each step does.
// - Head 0's block then computes na on the tensor cores from the weights it has just
//   written (mostly still in L2): 64 x 64 weight tiles and nv tiles stream through a
//   two-stage ring, A by ldmatrix, B by ldmatrix.trans, f32 sums in registers; warp
//   w takes 32 rows and a quarter of the channels, in passes of at most 192
//   channels (48 accumulators).  nv is read once per 64-row tile: T/64 times a
//   sequence instead of T/8.  Holding na's 64 x 384 sums through sweep 2 (the
//   score registers as A, FlashAttention-2's reuse) would take 96 more registers a
//   thread: one block an SM instead of two, or a second head-0 block recomputing the
//   scores for the other half of hid (a first version did that, and was the slower
//   on an H100).  Head 0's blocks, the heavier ones, come first in the grid so that
//   the other heads' blocks fill in behind them.
// - What is left bounds it by latency more than by any one unit: two blocks of 8
//   warps an SM (128 registers), a barrier per chunk and a chain of dependent steps
//   per score (mma, the rel-pos FMAs, the fill, the max, the exp).

// The f32 build (nonlin_f32_kernel) stays on the CUDA cores, where TF32 would cost
// precision: it is the first version of this kernel, kept for f32.  A block owns
// kRows query rows of one (b, h), computes their full f32 score rows into shared
// memory and normalises them there; a block of head 0 then applies its rows'
// rounded weights to nv, streamed through two cp.async buffers of kNvKeys keys,
// four groups of 64 threads each taking a quarter of a tile's keys and folded in a
// fixed order at the end.
//
// Ragged T is masked in both builds (no tile-multiple rule); a T that is no multiple
// of 8 (the weight rows are then not 16-byte aligned) stores the bf16 weights one
// by one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rel_pos_sweeps.cuh"

namespace {

using namespace zv;

// ---- the bf16 build: tensor cores -------------------------------------------

constexpr int kKeysNa = 64;             // keys per chunk of na's pass
constexpr int kStagesNa = 2;            // ring depth of na's pass
constexpr int kPassHid = 192;           // na's channels per pass, at most
constexpr int kWcNaTileBytes = kRowsN * kKeysNa * 2;   // na's weight tiles

// Shapes of one build: na's channels per pass, and the nv tile's row in 16-byte
// chunks (odd, so that eight consecutive rows at one chunk hit eight banks); the
// ring serves the sweeps first, then na's pass.
template <int QD, int kHid> struct NonlinShape {
  static constexpr int kPasses = (kHid + kPassHid - 1) / kPassHid;
  static constexpr int kHP = kHid / kPasses;          // channels per pass
  static constexpr int kNT = kHP / 8;                 // n-tiles per pass
  static constexpr int kNvLd = kNT % 2 ? kNT : kNT + 1;
  static constexpr int kNaStageBytes = kWcNaTileBytes + kKeysNa * kNvLd * 16;
  static constexpr int kNPG = (kNT + 3) / 4;          // n-tiles per channel group
  static constexpr int kSweepRingBytes = SweepShape<QD>::kSweepRingBytes;
  static constexpr int kRingBytes = kSweepRingBytes > kStagesNa * kNaStageBytes
                                        ? kSweepRingBytes
                                        : kStagesNa * kNaStageBytes;
  static_assert(kHid % (8 * kPasses) == 0, "hid must split into whole 8-wide n-tiles");
};

template <int QD, int kHid> constexpr int nonlin_mma_smem(int seq) {
  return NonlinShape<QD, kHid>::kRingBytes + sweep_tail_bytes(seq);
}

// grid = (ceil(T / kRowsN), H * B), blockIdx.y = h * B + b, so that head 0's heavier
// blocks are dispatched first; block = kThreadsN.
// q, k: (B, H, T, QD); p: (B, H, T, kPD); pe: (H, 2T-1, kPD); mask: (B, T) bytes,
// nonzero = padded key; out: (B, H, T, T); nv, na: (B, T, kHid).  All bf16 but the
// mask, contiguous.
template <int QD, int kHid>
__global__ void __launch_bounds__(kThreadsN, 2)
nonlin_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ pe,
                  const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ nv, __nv_bfloat16* __restrict__ na,
                  int B, int H, int seq) {
  using S = NonlinShape<QD, kHid>;
  extern __shared__ __align__(128) unsigned char smem_n[];
  const int h = blockIdx.y / B;
  const int b = blockIdx.y - h * B;
  const int i0 = blockIdx.x * kRowsN;
  rel_pos_sweeps<QD>(q, k, p, pe, mask, out, smem_n, smem_n + S::kRingBytes, b, h, H, i0, seq);
  if (h != 0) return;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, a = lane & 3;
  const bool aligned = seq % 8 == 0;  // weight rows 16-byte aligned
  __nv_bfloat16* out_bh = out + ((size_t)b * H + h) * seq * seq;

  // Head 0's na from the weights this block has just written (mostly still in L2),
  // on the tensor cores, kPasses passes over hid: warp w takes rows 32 (w % 2) ..
  // + 32 and channel group w / 2 of the pass, 2 x kNPG m16n8 accumulators.
  __syncthreads();  // this block's weights are written and visible to all its threads
  const __nv_bfloat16* nv_b = nv + (size_t)b * seq * kHid;
  const int mh = warp & 1, cg = warp >> 1;
  const int akey = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int nc_na = (seq + kKeysNa - 1) / kKeysNa;
  for (int pass = 0; pass < S::kPasses; ++pass) {
    auto load_na = [&](int c) {
      unsigned char* st = smem_n + (c % kStagesNa) * S::kNaStageBytes;
      const int j0 = c * kKeysNa;
      if (aligned) {
        for (int x = tid; x < kRowsN * (kKeysNa / 8); x += kThreadsN) {
          const int r = x >> 3, ch = x & 7;
          const int i = i0 + r, j = j0 + 8 * ch;
          const bool ok = i < seq && j < seq;
          zv::cp_async16(zv::smem_addr(st + wc_off<kKeysNa>(r, ch)),
                         out_bh + (ok ? (size_t)i * seq + j : 0), ok);
        }
      } else {
        for (int x = tid; x < kRowsN * kKeysNa; x += kThreadsN) {
          const int r = x / kKeysNa, u = x % kKeysNa;
          const int i = i0 + r, j = j0 + u;
          const __nv_bfloat16 e =
              i < seq && j < seq ? out_bh[(size_t)i * seq + j] : __float2bfloat16(0.f);
          *reinterpret_cast<__nv_bfloat16*>(st + wc_off<kKeysNa>(r, u >> 3) + 2 * (u & 7)) = e;
        }
      }
      unsigned char* nv_t = st + kWcNaTileBytes;
      for (int x = tid; x < kKeysNa * S::kNT; x += kThreadsN) {
        const int r = x / S::kNT, ch = x - r * S::kNT;
        const int j = j0 + r;
        const bool ok = j < seq;
        zv::cp_async16(zv::smem_addr(nv_t + (r * S::kNvLd + ch) * 16),
                       nv_b + (ok ? (size_t)j * kHid + pass * S::kHP + ch * 8 : 0), ok);
      }
    };
    float acc[2][S::kNPG][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < S::kNPG; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kStagesNa - 1; ++s) {
      if (s < nc_na) load_na(s);
      zv::cp_async_commit();
    }
    for (int c = 0; c < nc_na; ++c) {
      zv::cp_async_wait<kStagesNa - 2>();
      __syncthreads();  // chunk c has landed for all; everyone is done with chunk c - 1
      if (c + kStagesNa - 1 < nc_na) load_na(c + kStagesNa - 1);
      zv::cp_async_commit();
      const unsigned char* st = smem_n + (c % kStagesNa) * S::kNaStageBytes;
      const unsigned wt = zv::smem_addr(st);
      const unsigned nvt = zv::smem_addr(st + kWcNaTileBytes);
#pragma unroll
      for (int ks = 0; ks < kKeysNa / 16; ++ks) {
        unsigned af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          zv::ldmatrix_x4(
              wt + wc_off<kKeysNa>(32 * mh + 16 * mt + (lane & 15), 2 * ks + (lane >> 4)),
              af[mt][0], af[mt][1], af[mt][2], af[mt][3]);
        const unsigned brow = nvt + (16 * ks + akey) * S::kNvLd * 16;
#pragma unroll
        for (int t = 0; t < S::kNPG; t += 2) {
          const int nt = cg * S::kNPG + t;  // this group's n-tile within the pass
          if (nt >= S::kNT) break;
          if (t + 1 < S::kNPG && nt + 1 < S::kNT) {
            unsigned b0, b1, b2, b3;
            zv::ldmatrix_x4_trans(brow + (nt + (lane >> 4)) * 16, b0, b1, b2, b3);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              zv::mma_bf16(acc[mt][t], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
              zv::mma_bf16(acc[mt][t + 1], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b2, b3);
            }
          } else {
            unsigned b0, b1;
            zv::ldmatrix_x2_trans(brow + nt * 16, b0, b1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              zv::mma_bf16(acc[mt][t], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
          }
        }
      }
    }
    zv::cp_async_wait<0>();
    __syncthreads();  // everyone is done with the ring before the next pass fills it
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + 32 * mh + 16 * mt + g + 8 * half;
        if (i >= seq) continue;
        __nv_bfloat16* na_row = na + ((size_t)b * seq + i) * kHid + pass * S::kHP;
#pragma unroll
        for (int t = 0; t < S::kNPG; ++t) {
          const int nt = cg * S::kNPG + t;
          if (nt >= S::kNT) break;
          *reinterpret_cast<unsigned*>(na_row + 8 * nt + 2 * a) =
              zv::pack_bf16(acc[mt][t][2 * half], acc[mt][t][2 * half + 1]);
        }
      }
  }
}

// ---- the f32 build: CUDA cores -----------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                      // query rows per block
constexpr int kKeysPerThread = 2;             // keys each thread scores per chunk
constexpr int kChunk = kThreads * kKeysPerThread;
constexpr int kWindow = kChunk + kRows - 1;   // pe rows one chunk can read
constexpr int kNvKeys = 32;                   // keys per nv tile
constexpr int kKeyGroups = kThreads / 64;     // 64 threads per group
constexpr int kGroupKeys = kNvKeys / kKeyGroups;
static_assert(kGroupKeys % 4 == 0, "a group reads its keys' weights as float4s");

// One contiguous row of QD floats (16-byte aligned) into registers.
template <int QD>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&dst)[QD]) {
  static_assert(QD % 4 == 0, "a row must be a whole number of 16-byte vectors");
#pragma unroll
  for (int v = 0; v < QD / 4; ++v) {
    const float4 e = __ldg(reinterpret_cast<const float4*>(src) + v);
    dst[4 * v] = e.x;
    dst[4 * v + 1] = e.y;
    dst[4 * v + 2] = e.z;
    dst[4 * v + 3] = e.w;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid = (ceil(T / kRows), B * H); block = kThreads.
// q, k: (B, H, T, QD); p: (B, H, T, kPD); pe: (H, 2T-1, kPD); mask: (B, T) bytes,
// nonzero = padded key; out: (B, H, T, T); nv, na: (B, T, kHid).  All f32 but the
// mask, contiguous.
template <int QD, int kHid>
__global__ void __launch_bounds__(kThreads)
nonlin_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ p, const float* __restrict__ pe,
                  const uint8_t* __restrict__ mask, float* __restrict__ out,
                  const float* __restrict__ nv, float* __restrict__ na, int H, int seq) {
  extern __shared__ __align__(16) float smem[];
  // score rows, padded to whole nv tiles
  const int ld = (seq + kNvKeys - 1) / kNvKeys * kNvKeys;
  float* q_s = smem;                          // [kRows][QD]
  float* p_s = q_s + kRows * QD;              // [kRows][kPD]
  float* pe_s = p_s + kRows * kPD;            // [kWindow][kPD]
  float* scores = pe_s + kWindow * kPD;       // [kRows][ld]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.x * kRows;
  const int nrows = min(kRows, seq - i0);
  const size_t row0 = (size_t)bh * seq + i0;  // first query row, counted over (B, H, T)

  for (int x = threadIdx.x; x < kRows * QD; x += kThreads)
    q_s[x] = x / QD < nrows ? q[row0 * QD + x] : 0.f;
  for (int x = threadIdx.x; x < kRows * kPD; x += kThreads)
    p_s[x] = x / kPD < nrows ? p[row0 * kPD + x] : 0.f;

  const float* k_bh = k + (size_t)bh * seq * QD;
  const float* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;
  const uint8_t* mask_b = mask + (size_t)b * seq;

  for (int j0 = 0; j0 < seq; j0 += kChunk) {
    __syncthreads();  // q_s/p_s are written; the previous chunk is done with pe_s
    // Row i0 + r reads pe row n = j - (i0 + r) + seq - 1.  Over this chunk's keys
    // and the block's rows, n runs over [n_lo, n_lo + kWindow).
    const int n_lo = j0 - i0 - (kRows - 1) + seq - 1;
    for (int x = threadIdx.x; x < kWindow * kPD; x += kThreads) {
      const int n = n_lo + x / kPD;
      pe_s[x] = (n >= 0 && n < 2 * seq - 1) ? pe_h[(size_t)n * kPD + x % kPD] : 0.f;
    }
    __syncthreads();

    float kr[kKeysPerThread][QD];
    bool live[kKeysPerThread];
    bool masked[kKeysPerThread];
#pragma unroll
    for (int u = 0; u < kKeysPerThread; ++u) {
      const int j = j0 + u * kThreads + threadIdx.x;
      live[u] = j < seq;
      masked[u] = live[u] && mask_b[j] != 0;
      if (live[u]) {
        load_row<QD>(k_bh + (size_t)j * QD, kr[u]);
      } else {
#pragma unroll
        for (int d = 0; d < QD; ++d) kr[u][d] = 0.f;
      }
    }

    for (int r = 0; r < nrows; ++r) {
      float acc[kKeysPerThread];
#pragma unroll
      for (int u = 0; u < kKeysPerThread; ++u) acc[u] = 0.f;
      const float4* qv = reinterpret_cast<const float4*>(q_s + r * QD);
#pragma unroll
      for (int d4 = 0; d4 < QD / 4; ++d4) {
        const float4 qq = qv[d4];
#pragma unroll
        for (int u = 0; u < kKeysPerThread; ++u) {
          acc[u] = fmaf(qq.x, kr[u][4 * d4 + 0], acc[u]);
          acc[u] = fmaf(qq.y, kr[u][4 * d4 + 1], acc[u]);
          acc[u] = fmaf(qq.z, kr[u][4 * d4 + 2], acc[u]);
          acc[u] = fmaf(qq.w, kr[u][4 * d4 + 3], acc[u]);
        }
      }
      const float4 pp = reinterpret_cast<const float4*>(p_s)[r];
#pragma unroll
      for (int u = 0; u < kKeysPerThread; ++u) {
        const int jl = u * kThreads + threadIdx.x;  // key within the chunk
        // window row of n = j - (i0 + r) + seq - 1
        const float4 ee = reinterpret_cast<const float4*>(pe_s)[jl + kRows - 1 - r];
        float pos = pp.x * ee.x;
        pos = fmaf(pp.y, ee.y, pos);
        pos = fmaf(pp.z, ee.z, pos);
        pos = fmaf(pp.w, ee.w, pos);
        if (live[u]) {
          const float score = acc[u] + pos;
          scores[(size_t)r * ld + j0 + jl] = masked[u] ? -1000.f : score;
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Row softmax: one warp per row, in f32, then one write per weight.
  for (int r = warp; r < nrows; r += kWarps) {
    float* row = scores + (size_t)r * ld;
    float m = -INFINITY;
    for (int j = lane; j < seq; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    float* orow = out + (row0 + r) * (size_t)seq;
    for (int j = lane; j < seq; j += 32) {
      row[j] *= inv;  // wc, as head 0 applies it
      orow[j] = row[j];
    }
    for (int j = seq + lane; j < ld; j += 32) row[j] = 0.f;
  }

  if (h != 0) return;  // the whole block: only head 0 applies its weights
  static_assert(kHid % 2 == 0 && (kHid * sizeof(float)) % 16 == 0,
                "nv rows must be whole 16-byte vectors of channel pairs");
  constexpr int kPairs = kHid / 2;
  constexpr int kNaPairs = (kPairs + 63) / 64;  // channel pairs per thread
  constexpr int kRowVecs = kHid * (int)sizeof(float) / 16;
  constexpr int kTileElems = kNvKeys * kHid;
  float* tiles = scores + (size_t)kRows * ld;  // [2][kNvKeys][kHid]
  const int group = threadIdx.x / 64;
  const int cl = threadIdx.x % 64;
  const float* nv_b = nv + (size_t)b * seq * kHid;
  auto fetch = [&](int tile, float* dst) {
    const int j0 = tile * kNvKeys;
    for (int x = threadIdx.x; x < kNvKeys * kRowVecs; x += kThreads) {
      const int j = j0 + x / kRowVecs;
      const float* src = nv_b + (size_t)(j < seq ? j : 0) * kHid;
      zv::cp_async16(zv::smem_addr(reinterpret_cast<uint4*>(dst) + x),
                     reinterpret_cast<const uint4*>(src) + x % kRowVecs, j < seq);
    }
    zv::cp_async_commit();
  };
  float acc[kRows][2 * kNaPairs];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int m = 0; m < 2 * kNaPairs; ++m) acc[r][m] = 0.f;

  const int ntiles = ld / kNvKeys;
  fetch(0, tiles);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      fetch(t + 1, tiles + ((t + 1) & 1) * kTileElems);
    else
      zv::cp_async_commit();  // an empty group keeps "all but the newest" exact
    zv::cp_async_wait<1>();  // all but the newest group have landed
    __syncthreads();  // tile t has landed for every thread; the weights are final
    const float* tile = tiles + (t & 1) * kTileElems;
    const int jg = t * kNvKeys + group * kGroupKeys;
#pragma unroll
    for (int c4 = 0; c4 < kGroupKeys / 4; ++c4) {
      float4 wq[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        wq[r] = r < nrows
                    ? *reinterpret_cast<const float4*>(scores + (size_t)r * ld + jg + 4 * c4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = tile + (group * kGroupKeys + 4 * c4 + u) * kHid;
#pragma unroll
        for (int m = 0; m < kNaPairs; ++m) {
          const int pr = cl + 64 * m;
          if (pr < kPairs) {
            const float2 v = *reinterpret_cast<const float2*>(vrow + 2 * pr);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float wv = lane_of(wq[r], u);
              acc[r][2 * m] = fmaf(wv, v.x, acc[r][2 * m]);
              acc[r][2 * m + 1] = fmaf(wv, v.y, acc[r][2 * m + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // done with this buffer before it is refilled
  }

  // fold the key groups in order 0..3 over the tiles: red[kRows][kHid]
  float* red = tiles;
  for (int s = 0; s < kKeyGroups; ++s) {
    if (group == s) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int m = 0; m < kNaPairs; ++m) {
          const int pr = cl + 64 * m;
          if (pr < kPairs && r < nrows) {
            float* dst = red + (size_t)r * kHid + 2 * pr;
            dst[0] = (s ? dst[0] : 0.f) + acc[r][2 * m];
            dst[1] = (s ? dst[1] : 0.f) + acc[r][2 * m + 1];
          }
        }
    }
    __syncthreads();
  }
  float* na_rows = na + ((size_t)b * seq + i0) * kHid;
  for (int x = threadIdx.x; x < nrows * kHid; x += kThreads) na_rows[x] = red[x];
}

long long f32_smem_bytes(int qd, int seq, int hid) {
  const long long head = (long long)kRows * qd + kRows * kPD + kWindow * kPD;
  const long long ld = (seq + kNvKeys - 1) / kNvKeys * kNvKeys;
  const long long tiles = 2LL * kNvKeys * hid * sizeof(float);  // two nv tiles
  const long long fold = (long long)kRows * hid * sizeof(float);
  return (long long)sizeof(float) * (head + kRows * ld) + (tiles > fold ? tiles : fold);
}

// ---- launches ------------------------------------------------------------------

template <int QD, int kHid>
cudaError_t launch(int dtype, const void* q, const void* k, const void* p, const void* pe,
                   const void* mask, void* out, const void* nv, void* na, int B, int H,
                   int seq, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (dtype == 1) {
    const int smem = nonlin_mma_smem<QD, kHid>(seq);
    auto kernel = nonlin_mma_kernel<QD, kHid>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + kRowsN - 1) / kRowsN, H * B);
    kernel<<<grid, kThreadsN, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(p),
        static_cast<const bf16*>(pe), static_cast<const uint8_t*>(mask),
        static_cast<bf16*>(out), static_cast<const bf16*>(nv), static_cast<bf16*>(na), B, H,
        seq);
    return cudaGetLastError();
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes(QD, seq, kHid);
  auto kernel = nonlin_f32_kernel<QD, kHid>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(p),
      static_cast<const float*>(pe), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), static_cast<const float*>(nv), static_cast<float*>(na), H,
      seq);
  return cudaGetLastError();
}

template <int kHid>
cudaError_t dispatch_qd(int dtype, int qd, const void* q, const void* k, const void* p,
                        const void* pe, const void* mask, void* out, const void* nv, void* na,
                        int B, int H, int seq, cudaStream_t stream) {
  // 32: the ZipVoice models' query_head_dim; 8: the tests' small models
  switch (qd) {
    case 8: return launch<8, kHid>(dtype, q, k, p, pe, mask, out, nv, na, B, H, seq, stream);
    case 32: return launch<32, kHid>(dtype, q, k, p, pe, mask, out, nv, na, B, H, seq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core build), 1 = bfloat16 (the tensor-core build).
// out (B, H, seq, seq) receives the weights and na (B, seq, hid) head 0's rounded
// weights applied to nv (B, seq, hid).  hid is one of the NonlinAttention widths of
// the ZipVoice models (384 in the fm_decoder, 144 in the text encoder) or 48 (the
// tests' small layers).  Returns cudaGetLastError() after the launch (0 on
// success); launches on `stream` and does not synchronise.
extern "C" int zv_rel_pos_attention_weights_nonlin(int dtype, int qd, const void* q,
                                                   const void* k, const void* p,
                                                   const void* pe, const void* mask, void* out,
                                                   const void* nv, void* na, int hid, int B,
                                                   int H, int seq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hid) {
#define ZV_CASE(HID) \
  case HID: return dispatch_qd<HID>(dtype, qd, q, k, p, pe, mask, out, nv, na, B, H, seq, s);
    ZV_CASE(48)
    ZV_CASE(144)
    ZV_CASE(384)
#undef ZV_CASE
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one block of the given dtype's build needs at (qd, seq,
// hid); the wrapper checks it against the card's limit before launching.
extern "C" long long zv_rel_pos_attention_nonlin_smem_bytes(int dtype, int qd, int seq,
                                                             int hid) {
  if (dtype != 1) return f32_smem_bytes(qd, seq, hid);
#define ZV_SMEM(QD, HID) \
  if (qd == QD && hid == HID) return nonlin_mma_smem<QD, HID>(seq);
  ZV_SMEM(8, 48) ZV_SMEM(8, 144) ZV_SMEM(8, 384)
  ZV_SMEM(32, 48) ZV_SMEM(32, 144) ZV_SMEM(32, 384)
#undef ZV_SMEM
  return 0;
}
