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
// - A block owns kRowsN = 64 query rows of one (b, h), 8 warps: warp w holds rows
//   16 (w % 4) .. + 16 and the key half w / 4 of every kKeysN = 128-key chunk.  Keys
//   and the chunk's pe window stream through a ring of kStagesN shared-memory
//   stages filled by cp.async two chunks ahead.
// - q.k^T runs on the tensor cores (mma.sync m16n8k16; qd = 8 is padded to 16 with
//   zeros): q's A fragments stay in registers, k's B fragments come by ldmatrix
//   from XOR-swizzled rows.  The rel-pos term p.pe^T (pd = 4) stays on the CUDA
//   cores, four FMAs onto the score; the skew j - i + T - 1 is an index into the pe
//   window (widened to f32 once per chunk), and one window row serves the element
//   (i, j) and the element (i + 8, j + 8) a lane holds.
// - No score row is held: sweep 1 over the keys keeps each row's running max and
//   sum (online rescaling); the two key halves meet in shared memory.  Sweep 2
//   recomputes the scores, rounds wc = exp(s - max) / sum once, and each warp
//   stages its 16 x 64 weights in shared memory and stores them itself as 16-byte,
//   coalesced stores (no block barrier).
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

#include "mma_bf16.cuh"

namespace {

constexpr int kPD = 4;  // pos_head_dim

// ---- the bf16 build: tensor cores -------------------------------------------

constexpr int kWarpsN = 8;
constexpr int kThreadsN = kWarpsN * 32;
constexpr int kRowsN = 64;              // query rows per block
constexpr int kKeysN = 128;             // keys per chunk of the sweeps
constexpr int kKeysNa = 64;             // keys per chunk of na's pass
constexpr int kStagesN = 3;             // ring depth of the sweeps
constexpr int kStagesNa = 2;            // ring depth of na's pass
constexpr int kPassHid = 192;           // na's channels per pass, at most
constexpr int kWinN = kKeysN + kRowsN - 1;   // pe rows one chunk reads
constexpr int kWinPad = 192;                 // kWinN, padded
constexpr int kPeTileBytes = kWinPad * 8;    // kWinN rows of 4 bf16
constexpr int kWcTileBytes = kRowsN * kKeysN * 2;      // sweep 2's staged weights
constexpr int kWcNaTileBytes = kRowsN * kKeysNa * 2;   // na's weight tiles
constexpr int kNTW = kKeysN / 2 / 8;                   // n-tiles of a warp's key half
constexpr float kLog2e = 1.4426950408889634f;

// Shapes of one build: the k tile's row (qd padded to 16); na's channels per pass,
// and the nv tile's row in 16-byte chunks (odd, so that eight consecutive rows at
// one chunk hit eight banks).
template <int QD, int kHid> struct NonlinShape {
  static constexpr int kQDP = QD < 16 ? 16 : QD;
  static constexpr int kKChunks = kQDP / 8;
  static constexpr int kKTileBytes = kKeysN * kQDP * 2;
  static constexpr int kSweepStageBytes = kKTileBytes + kPeTileBytes;
  static constexpr int kPasses = (kHid + kPassHid - 1) / kPassHid;
  static constexpr int kHP = kHid / kPasses;          // channels per pass
  static constexpr int kNT = kHP / 8;                 // n-tiles per pass
  static constexpr int kNvLd = kNT % 2 ? kNT : kNT + 1;
  static constexpr int kNaStageBytes = kWcNaTileBytes + kKeysNa * kNvLd * 16;
  static constexpr int kNPG = (kNT + 3) / 4;          // n-tiles per channel group
  static constexpr int kRingBytes = kStagesN * kSweepStageBytes > kStagesNa * kNaStageBytes
                                        ? kStagesN * kSweepStageBytes
                                        : kStagesNa * kNaStageBytes;
  static_assert(kHid % (8 * kPasses) == 0, "hid must split into whole 8-wide n-tiles");
  static_assert(QD == 8 || QD % 16 == 0, "qd must be 8 or a multiple of 16");
};

// (key, 16-byte chunk) of a k tile: the chunk is XORed with the key's bits above
// those that already separate eight rows' banks.
template <int kKChunks> __device__ __forceinline__ int k_off(int key, int chunk) {
  constexpr int kShift = kKChunks == 4 ? 1 : 2;  // 64-byte rows: key / 2; 32-byte: key / 4
  return key * kKChunks * 16 + ((chunk ^ ((key >> kShift) & (kKChunks - 1))) << 4);
}
// (row, 16-byte chunk) of a weight tile of kKeys keys a row: the chunk is XORed
// with row % 8, so eight consecutive rows at one chunk hit eight banks
template <int kKeys> __device__ __forceinline__ int wc_off(int row, int chunk) {
  return row * (kKeys * 2) + ((chunk ^ (row & 7)) << 4);
}

// s + p . e
__device__ __forceinline__ float add_pos(float s, const float4& p, const float4& e) {
  s = fmaf(p.x, e.x, s);
  s = fmaf(p.y, e.y, s);
  s = fmaf(p.z, e.z, s);
  return fmaf(p.w, e.w, s);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int QD, int kHid> constexpr int nonlin_mma_smem(int seq) {
  return NonlinShape<QD, kHid>::kRingBytes + kWcTileBytes + 2 * kRowsN * 2 * (int)sizeof(float) +
         2 * kWinPad * 16 + (seq + kKeysN - 1) / kKeysN * kKeysN * (int)sizeof(float);
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
  unsigned char* wc_s = smem_n + S::kRingBytes;                   // [64 rows][kKeysN]
  float* ml_s = reinterpret_cast<float*>(wc_s + kWcTileBytes);    // [2 halves][64 rows][2]
  float4* pe_f = reinterpret_cast<float4*>(ml_s + 2 * kRowsN * 2);  // [2][kWinPad]
  float* fill_s = reinterpret_cast<float*>(pe_f + 2 * kWinPad);   // [nc * kKeysN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, a = lane & 3;
  const int h = blockIdx.y / B;
  const int b = blockIdx.y - h * B;
  const int bh = b * H + h;
  const int i0 = blockIdx.x * kRowsN;
  const int nc = (seq + kKeysN - 1) / kKeysN;
  const bool aligned = seq % 8 == 0;  // weight rows 16-byte aligned

  const __nv_bfloat16* k_bh = k + (size_t)bh * seq * QD;
  const __nv_bfloat16* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;
  __nv_bfloat16* out_bh = out + (size_t)bh * seq * seq;
  // what replaces a key's score: 0 = nothing, -1000 = a padded key, -inf = past T
  const uint8_t* mask_b = mask + (size_t)b * seq;
  for (int x = tid; x < nc * kKeysN; x += kThreadsN)
    fill_s[x] = x >= seq ? -INFINITY : mask_b[x] ? -1000.f : 0.f;

  // step s < nc: sweep 1 over chunk s; s >= nc: sweep 2 over chunk s - nc
  auto load = [&](int step) {
    const int c = step < nc ? step : step - nc;
    unsigned char* st = smem_n + (step % kStagesN) * S::kSweepStageBytes;
    const int j0 = c * kKeysN;
    for (int x = tid; x < kKeysN * S::kKChunks; x += kThreadsN) {
      const int r = x / S::kKChunks, ch = x % S::kKChunks;
      const int j = j0 + r;
      const bool ok = j < seq && ch * 8 < QD;  // qd = 8: chunk 1 is zero padding
      zv::cp_async16(zv::smem_addr(st + k_off<S::kKChunks>(r, ch)),
                     k_bh + (ok ? (size_t)j * QD + ch * 8 : 0), ok);
    }
    // pe rows n = j - i + T - 1 over this chunk's keys and the block's rows
    const int n_lo = j0 - i0 - (kRowsN - 1) + seq - 1;
    unsigned char* pe_t = st + S::kKTileBytes;
    for (int x = tid; x < kWinN; x += kThreadsN) {
      const int n = n_lo + x;
      const bool ok = n >= 0 && n < 2 * seq - 1;
      zv::cp_async8(zv::smem_addr(pe_t + 8 * x), pe_h + (ok ? (size_t)n * kPD : 0), ok);
    }
  };

  // a step's pe window in f32, from its stage into one of two buffers: read in the
  // step, written at the end of the step before.  A thread widens the rows it copied
  // itself (the same x = tid loop as in load), so its own cp.async wait suffices.
  auto widen_pe = [&](int step) {
    const unsigned char* pe_t =
        smem_n + (step % kStagesN) * S::kSweepStageBytes + S::kKTileBytes;
    float4* dst = pe_f + (step & 1) * kWinPad;
    for (int x = tid; x < kWinN; x += kThreadsN) {
      const uint2 raw = *reinterpret_cast<const uint2*>(pe_t + 8 * x);
      const float2 e01 = zv::unpack_bf16(raw.x), e23 = zv::unpack_bf16(raw.y);
      dst[x] = make_float4(e01.x, e01.y, e23.x, e23.y);
    }
  };

  const int nsteps = 2 * nc;
#pragma unroll
  for (int s = 0; s < kStagesN - 1; ++s) {
    if (s < nsteps) load(s);
    zv::cp_async_commit();
  }
  zv::cp_async_wait<kStagesN - 2>();
  widen_pe(0);

  // this warp's 16 rows and key half; q's A fragments and p's rows in registers
  const int rg = warp & 3, kh = warp >> 2;
  const int r_lo = 16 * rg + g;  // rows r_lo and r_lo + 8 of the tile
  constexpr int kKSteps = S::kQDP / 16;
  unsigned qa[kKSteps][4];
  float4 pr[2];
  {
    const __nv_bfloat16* q_bh = q + (size_t)bh * seq * QD;
    const __nv_bfloat16* p_bh = p + (size_t)bh * seq * kPD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + r_lo + 8 * half;
      const bool ok = i < seq;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int d = 16 * ks + 8 * hi + 2 * a;
          qa[ks][half + 2 * hi] =
              ok && d < QD ? *reinterpret_cast<const unsigned*>(q_bh + (size_t)i * QD + d) : 0u;
        }
      const uint2 raw = ok ? *reinterpret_cast<const uint2*>(p_bh + (size_t)i * kPD)
                           : make_uint2(0u, 0u);
      const float2 p01 = zv::unpack_bf16(raw.x), p23 = zv::unpack_bf16(raw.y);
      pr[half] = make_float4(p01.x, p01.y, p23.x, p23.y);
    }
  }

  // Scores of this warp's 16 rows x 32 keys of chunk c, in the C layout: s[nt][0..1]
  // row r_lo, keys 8 nt + 2a (+1) of the half; s[nt][2..3] row r_lo + 8.  A key past
  // T is -inf (no weight), a masked key -1000.
  const int key_lo = kKeysN / 2 * kh;  // this warp's first key of a chunk
  const int krow = key_lo + (lane & 7);
  auto scores = [&](const unsigned char* st, int step, int c, float (&s)[kNTW][4]) {
    const unsigned kt = zv::smem_addr(st);
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if constexpr (kKSteps == 2) {
        unsigned b0, b1, b2, b3;
        zv::ldmatrix_x4(kt + k_off<S::kKChunks>(krow + 8 * nt, lane >> 3), b0, b1, b2, b3);
        zv::mma_bf16(s[nt], qa[0][0], qa[0][1], qa[0][2], qa[0][3], b0, b1);
        zv::mma_bf16(s[nt], qa[1][0], qa[1][1], qa[1][2], qa[1][3], b2, b3);
      } else {
        unsigned b0, b1;
        zv::ldmatrix_x2(kt + k_off<S::kKChunks>(krow + 8 * nt, (lane >> 3) & 1), b0, b1);
        zv::mma_bf16(s[nt], qa[0][0], qa[0][1], qa[0][2], qa[0][3], b0, b1);
      }
    }
    // p.pe: window row (j - j0) - (i - i0) + kRowsN - 1; for key 8 nt + 2a + e of the
    // half and row r_lo + 8 rh that is base + 8 (nt - rh) + e
    const float4* win =
        pe_f + (step & 1) * kWinPad + key_lo - 16 * rg - g + 2 * a + kRowsN - 1;
#pragma unroll
    for (int dd = -1; dd < kNTW; ++dd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 row = win[8 * dd + e];
        if (dd >= 0) s[dd][e] = add_pos(s[dd][e], pr[0], row);
        if (dd + 1 < kNTW) s[dd + 1][2 + e] = add_pos(s[dd + 1][2 + e], pr[1], row);
      }
    const float* fill = fill_s + c * kKeysN + key_lo + 2 * a;
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt) {
      const float2 f = *reinterpret_cast<const float2*>(fill + 8 * nt);
      if (f.x != 0.f) s[nt][0] = s[nt][2] = f.x;
      if (f.y != 0.f) s[nt][1] = s[nt][3] = f.y;
    }
  };

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // running max and sum, rows r_lo (+8)
  float ms[2], inv[2];                                // sweep 2: max * log2(e), 1 / sum
  for (int step = 0; step < nsteps; ++step) {
    zv::cp_async_wait<kStagesN - 2>();
    __syncthreads();  // this step's stage has landed; everyone is done with the last step
    if (step + kStagesN - 1 < nsteps) load(step + kStagesN - 1);
    zv::cp_async_commit();
    const unsigned char* st = smem_n + (step % kStagesN) * S::kSweepStageBytes;
    float s[kNTW][4];
    if (step < nc) {
      scores(st, step, step, s);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float cm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt)
          cm = fmaxf(cm, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
        const float mn = fmaxf(m[half], quad_max(cm));
        const float mns = mn * kLog2e;
        float sum = l[half] * zv::exp2_approx((m[half] - mn) * kLog2e);
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt) {
          sum += zv::exp2_approx(fmaf(s[nt][2 * half], kLog2e, -mns));
          sum += zv::exp2_approx(fmaf(s[nt][2 * half + 1], kLog2e, -mns));
        }
        m[half] = mn;
        l[half] = sum;
      }
      if (step == nc - 1) {
        // this half's (max, sum) of each row for the other half's warp; the quad's
        // four lanes share the max, and lane a == 0 writes
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float total = quad_sum(l[half]);
          if (a == 0) {
            float* dst = ml_s + 2 * (kh * kRowsN + r_lo + 8 * half);
            dst[0] = m[half];
            dst[1] = total;
          }
        }
      }
      if (step + 1 < nsteps) {
        zv::cp_async_wait<kStagesN - 2>();  // the next step's stage has landed
        widen_pe(step + 1);
      }
      continue;
    }
    const int c = step - nc;
    if (step == nc) {
      // the two key halves' (max, sum), combined in a fixed order by both warps
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* h0 = ml_s + 2 * (r_lo + 8 * half);
        const float* h1 = ml_s + 2 * (kRowsN + r_lo + 8 * half);
        const float mx = fmaxf(h0[0], h1[0]);
        const float sum = h0[1] * zv::exp2_approx((h0[0] - mx) * kLog2e) +
                          h1[1] * zv::exp2_approx((h1[0] - mx) * kLog2e);
        ms[half] = mx * kLog2e;
        inv[half] = 1.f / sum;
      }
    }
    scores(st, step, c, s);
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r_lo + 8 * half;
        const float w0 = zv::exp2_approx(fmaf(s[nt][2 * half], kLog2e, -ms[half])) * inv[half];
        const float w1 =
            zv::exp2_approx(fmaf(s[nt][2 * half + 1], kLog2e, -ms[half])) * inv[half];
        *reinterpret_cast<unsigned*>(wc_s + wc_off<kKeysN>(row, kNTW * kh + nt) + 4 * a) =
            zv::pack_bf16(w0, w1);
      }
    __syncwarp();  // the warp's 16 x 64 weights are staged; it stores them itself
    const int j0 = c * kKeysN;
#pragma unroll
    for (int u = 0; u < 16 * 8 / 32; ++u) {
      const int r = 16 * rg + (lane >> 3) + 4 * u, ch = kNTW * kh + (lane & 7);
      const int i = i0 + r, j = j0 + 8 * ch;
      if (i >= seq || j >= seq) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(wc_s + wc_off<kKeysN>(r, ch));
      __nv_bfloat16* dst = out_bh + (size_t)i * seq + j;
      if (aligned) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
        for (int u = 0; u < 8 && j + u < seq; ++u) dst[u] = e[u];
      }
    }
    if (step + 1 < nsteps) {
      zv::cp_async_wait<kStagesN - 2>();
      widen_pe(step + 1);
    }
  }
  zv::cp_async_wait<0>();
  if (h != 0) return;

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
