// The bf16 relative-position attention weights on Hopper's tensor cores: the two
// sweeps over the keys that one 64-row block runs, shared by the inference weights
// kernel (rel_pos_attention.cu, rel_pos_mma_kernel) and the fused weights +
// NonlinAttention kernel (rel_pos_attention_nonlin.cu, nonlin_mma_kernel), so that
// both write the same weights from one copy of the code.  For a block's rows i and
// every key j:
//
//   w[b,h,i,j] = softmax_j( q_i . k_j + p_i . pe[h, j - i + T - 1] ),  a masked key's
//                score replaced by -1000 (a fully masked row stays uniform at 1/T),
//
// in f32, each weight rounded once to bf16.  The layout:
// - A block owns kRowsN = 64 query rows of one (b, h), 8 warps: warp w holds rows
//   16 (w % 4) .. + 16 and the key half w / 4 of every kKeysN = 128-key chunk.  Keys
//   and the chunk's pe window stream through a ring of kStagesN shared-memory
//   stages filled by cp.async two chunks ahead.
// - q.k^T runs on the tensor cores (mma.sync m16n8k16; qd = 8 is padded to 16 with
//   zeros): q's A fragments stay in registers, k's B fragments come by ldmatrix
//   from XOR-swizzled rows.  Each score tile's mma starts from zero (the tensor
//   cores' f32 accumulation does not round to nearest, so no sum is carried in
//   them).  The rel-pos term p.pe^T (pd = 4) stays on the CUDA cores, four FMAs onto
//   the score; the skew j - i + T - 1 is an index into the pe window (widened to
//   f32 once per chunk), and one window row serves the element (i, j) and the
//   element (i + 8, j + 8) a lane holds.
// - No score row is held: sweep 1 over the keys keeps each row's running max and
//   sum (online rescaling); the two key halves meet in shared memory.  Sweep 2
//   recomputes the scores, rounds exp(s - max) / sum once, and each warp stages its
//   16 x 64 weights in shared memory and stores them itself as 16-byte, coalesced
//   stores (no block barrier); a T that is no multiple of 8 (the weight rows are
//   then not 16-byte aligned) stores them one by one.  Keys past T score -inf.
// - With kBlockMax (the bf16 training forward, rel_pos_attention.cu), sweep 1 also
//   keeps the thread's largest |score| before the mask's -1000 fill, over the keys
//   j < T (a row past T scores 0), and hands it to the caller to reduce.  Without it
//   the code is the inference kernels' as it was.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace zv {

constexpr int kPD = 4;                  // pos_head_dim
constexpr int kWarpsN = 8;
constexpr int kThreadsN = kWarpsN * 32;
constexpr int kRowsN = 64;              // query rows per block
constexpr int kKeysN = 128;             // keys per chunk of the sweeps
constexpr int kStagesN = 3;             // ring depth of the sweeps
constexpr int kWinN = kKeysN + kRowsN - 1;   // pe rows one chunk reads
constexpr int kWinPad = 192;                 // kWinN, padded
constexpr int kPeTileBytes = kWinPad * 8;    // kWinN rows of 4 bf16
constexpr int kWcTileBytes = kRowsN * kKeysN * 2;      // sweep 2's staged weights
constexpr int kNTW = kKeysN / 2 / 8;                   // n-tiles of a warp's key half
constexpr float kLog2e = 1.4426950408889634f;

// The k tile's row (qd padded to 16) and one stage of the sweeps' ring.
template <int QD> struct SweepShape {
  static constexpr int kQDP = QD < 16 ? 16 : QD;
  static constexpr int kKChunks = kQDP / 8;
  static constexpr int kKTileBytes = kKeysN * kQDP * 2;
  static constexpr int kSweepStageBytes = kKTileBytes + kPeTileBytes;
  static constexpr int kSweepRingBytes = kStagesN * kSweepStageBytes;
  static_assert(QD == 8 || QD % 16 == 0, "qd must be 8 or a multiple of 16");
};

// Shared memory the sweeps use after their ring: the staged weights, the halves'
// (max, sum), two f32 pe windows and the keys' fills.
constexpr int sweep_tail_bytes(int seq) {
  return kWcTileBytes + 2 * kRowsN * 2 * (int)sizeof(float) + 2 * kWinPad * 16 +
         (seq + kKeysN - 1) / kKeysN * kKeysN * (int)sizeof(float);
}

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

// Both sweeps for query rows [i0, i0 + kRowsN) of (b, h), with kThreadsN threads.
// q, k: (B, H, T, QD); p: (B, H, T, kPD); pe: (H, 2T-1, kPD); mask: (B, T) bytes,
// nonzero = padded key; out: (B, H, T, T).  All bf16 but the mask, contiguous.
// `ring` holds kStagesN stages of SweepShape<QD>::kSweepStageBytes, `tail`
// sweep_tail_bytes(seq), both in shared memory.  Returns with every cp.async of
// the thread complete and the block's weights stored (not yet visible to the
// block: the caller's barrier does that).  With kBlockMax, *abs_max receives the
// thread's largest |pre-mask score|.
template <int QD, bool kBlockMax = false>
__device__ __forceinline__ void rel_pos_sweeps(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ pe,
    const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, unsigned char* ring,
    unsigned char* tail, int b, int h, int H, int i0, int seq, float* abs_max = nullptr) {
  using S = SweepShape<QD>;
  unsigned char* wc_s = tail;                                     // [64 rows][kKeysN]
  float* ml_s = reinterpret_cast<float*>(wc_s + kWcTileBytes);    // [2 halves][64 rows][2]
  float4* pe_f = reinterpret_cast<float4*>(ml_s + 2 * kRowsN * 2);  // [2][kWinPad]
  float* fill_s = reinterpret_cast<float*>(pe_f + 2 * kWinPad);   // [nc * kKeysN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, a = lane & 3;
  const int bh = b * H + h;
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
    unsigned char* st = ring + (step % kStagesN) * S::kSweepStageBytes;
    const int j0 = c * kKeysN;
    for (int x = tid; x < kKeysN * S::kKChunks; x += kThreadsN) {
      const int r = x / S::kKChunks, ch = x % S::kKChunks;
      const int j = j0 + r;
      const bool ok = j < seq && ch * 8 < QD;  // qd = 8: chunk 1 is zero padding
      cp_async16(smem_addr(st + k_off<S::kKChunks>(r, ch)),
                 k_bh + (ok ? (size_t)j * QD + ch * 8 : 0), ok);
    }
    // pe rows n = j - i + T - 1 over this chunk's keys and the block's rows
    const int n_lo = j0 - i0 - (kRowsN - 1) + seq - 1;
    unsigned char* pe_t = st + S::kKTileBytes;
    for (int x = tid; x < kWinN; x += kThreadsN) {
      const int n = n_lo + x;
      const bool ok = n >= 0 && n < 2 * seq - 1;
      cp_async8(smem_addr(pe_t + 8 * x), pe_h + (ok ? (size_t)n * kPD : 0), ok);
    }
  };

  // a step's pe window in f32, from its stage into one of two buffers: read in the
  // step, written at the end of the step before.  A thread widens the rows it copied
  // itself (the same x = tid loop as in load), so its own cp.async wait suffices.
  auto widen_pe = [&](int step) {
    const unsigned char* pe_t = ring + (step % kStagesN) * S::kSweepStageBytes + S::kKTileBytes;
    float4* dst = pe_f + (step & 1) * kWinPad;
    for (int x = tid; x < kWinN; x += kThreadsN) {
      const uint2 raw = *reinterpret_cast<const uint2*>(pe_t + 8 * x);
      const float2 e01 = unpack_bf16(raw.x), e23 = unpack_bf16(raw.y);
      dst[x] = make_float4(e01.x, e01.y, e23.x, e23.y);
    }
  };

  const int nsteps = 2 * nc;
#pragma unroll
  for (int s = 0; s < kStagesN - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }
  cp_async_wait<kStagesN - 2>();
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
      const float2 p01 = unpack_bf16(raw.x), p23 = unpack_bf16(raw.y);
      pr[half] = make_float4(p01.x, p01.y, p23.x, p23.y);
    }
  }

  // Scores of this warp's 16 rows x 32 keys of chunk c, in the C layout: s[nt][0..1]
  // row r_lo, keys 8 nt + 2a (+1) of the half; s[nt][2..3] row r_lo + 8.  A key past
  // T is -inf (no weight), a masked key -1000.
  const int key_lo = kKeysN / 2 * kh;  // this warp's first key of a chunk
  const int krow = key_lo + (lane & 7);
  float amax = 0.f;  // kBlockMax: the largest |pre-mask score| this thread scored
  auto scores = [&](const unsigned char* st, int step, int c, float (&s)[kNTW][4]) {
    const unsigned kt = smem_addr(st);
#pragma unroll
    for (int nt = 0; nt < kNTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if constexpr (kKSteps == 2) {
        unsigned b0, b1, b2, b3;
        ldmatrix_x4(kt + k_off<S::kKChunks>(krow + 8 * nt, lane >> 3), b0, b1, b2, b3);
        mma_bf16(s[nt], qa[0][0], qa[0][1], qa[0][2], qa[0][3], b0, b1);
        mma_bf16(s[nt], qa[1][0], qa[1][1], qa[1][2], qa[1][3], b2, b3);
      } else {
        unsigned b0, b1;
        ldmatrix_x2(kt + k_off<S::kKChunks>(krow + 8 * nt, (lane >> 3) & 1), b0, b1);
        mma_bf16(s[nt], qa[0][0], qa[0][1], qa[0][2], qa[0][3], b0, b1);
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
      if constexpr (kBlockMax) {
        if (step < nc) {  // sweep 1, before the fill; keys past T (fill -inf) excluded
          if (f.x != -INFINITY) amax = fmaxf(amax, fmaxf(fabsf(s[nt][0]), fabsf(s[nt][2])));
          if (f.y != -INFINITY) amax = fmaxf(amax, fmaxf(fabsf(s[nt][1]), fabsf(s[nt][3])));
        }
      }
      if (f.x != 0.f) s[nt][0] = s[nt][2] = f.x;
      if (f.y != 0.f) s[nt][1] = s[nt][3] = f.y;
    }
  };

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // running max and sum, rows r_lo (+8)
  float ms[2], inv[2];                                // sweep 2: max * log2(e), 1 / sum
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStagesN - 2>();
    __syncthreads();  // this step's stage has landed; everyone is done with the last step
    if (step + kStagesN - 1 < nsteps) load(step + kStagesN - 1);
    cp_async_commit();
    const unsigned char* st = ring + (step % kStagesN) * S::kSweepStageBytes;
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
        float sum = l[half] * exp2_approx((m[half] - mn) * kLog2e);
#pragma unroll
        for (int nt = 0; nt < kNTW; ++nt) {
          sum += exp2_approx(fmaf(s[nt][2 * half], kLog2e, -mns));
          sum += exp2_approx(fmaf(s[nt][2 * half + 1], kLog2e, -mns));
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
        cp_async_wait<kStagesN - 2>();  // the next step's stage has landed
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
        const float sum = h0[1] * exp2_approx((h0[0] - mx) * kLog2e) +
                          h1[1] * exp2_approx((h1[0] - mx) * kLog2e);
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
        const float w0 = exp2_approx(fmaf(s[nt][2 * half], kLog2e, -ms[half])) * inv[half];
        const float w1 = exp2_approx(fmaf(s[nt][2 * half + 1], kLog2e, -ms[half])) * inv[half];
        *reinterpret_cast<unsigned*>(wc_s + wc_off<kKeysN>(row, kNTW * kh + nt) + 4 * a) =
            pack_bf16(w0, w1);
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
      cp_async_wait<kStagesN - 2>();
      widen_pe(step + 1);
    }
  }
  cp_async_wait<0>();
  if constexpr (kBlockMax) *abs_max = amax;
}

}  // namespace zv
