// Backward of the relative-position attention weights for Hopper (sm_90a).
//
// Replaces the TPU kernel zipvoice_tpu/ops/pallas_attention.py::
// _attn_weights_bwd_kernel (reached through rel_pos_attention_weights_trainable's
// backward).  With w = softmax(mask_fill(s)), s[i,j] = q_i.k_j + p_i.pe[j-i+T-1],
// upstream gradient g, and per (b, h):
//
//   ds[i,j] = w[i,j] (g[i,j] - sum_j' g[i,j'] w[i,j'])
//             + coin * 1e-4 * sign(s[i,j]) * [|s[i,j]| > 25]   (the failsafe penalty)
//   dq[i]  = sum_j ds[i,j] k_j          dp[i] = sum_j ds[i,j] pe[j-i+T-1]
//   dk[j]  = sum_i ds[i,j] q_i          dpe[n] = sum_{b,i} ds[i, i+n-T+1] p_i
//
// all in f32.  `coin` is a device scalar (1 when the caller's penalty coin landed
// and the forward saw |s| > 25); s is recomputed only when it is set.  As in the
// JAX package, ds is not masked: a fully masked row (uniform weights) sends
// gradient into q and k.
//
// What bounds it: reading g and w, (B, h, T, T) each.  At the training shape
// (B=8, h=4, T=1280, bf16) that is 210 MB against ~10 MB of other reads and
// writes, so on an H100 the floor is the memory rate (~68 us at 3.35 TB/s).
// Neither build uses an atomic, so the result is the same bits from run to run.
// The TPU kernel's exchange-matrix row reversal and strided roll are only index
// arithmetic here (drel[i, n] = ds[i, i + n - (T-1)]).
//
// The bf16 build (what the training step runs) reads g and w twice, on the
// tensor cores:
// - Pass A (bwd_rows_mma_kernel), a block per (b, h, 64 query rows), streams
//   128-key chunks of g, w, k and the pe window through a cp.async ring.  It reads
//   each chunk once, so the row sum r = sum_j w g is not known while it goes; it
//   sums instead, with x = w g + penalty, U = x.k and V = w.k on the tensor cores
//   and dpx = sum_j x pe, dpw = sum_j w pe on the CUDA cores, and ends with
//   dq = U - r V and dp = dpx - r dpw (ds = x - r w).  It writes r for pass B.
// - Pass B (bwd_keys_mma_kernel), a block per (b, h, 64 keys), streams 64-row
//   chunks of g, w, q, p and r, forms ds = w (g - r) + penalty directly and sums
//   dk = ds^T q on the tensor cores.  For dpe it stores the chunk's ds into two
//   skew tiles D[i][j - i + 63] (bf16 hi and lo), so that each diagonal is a column,
//   and after a barrier sums the columns on the tensor cores (p^T, its 4 rows padded
//   to 16, times D) into the block's window of 64 + T - 1 positional rows in shared
//   memory.  The window is written per block.
// - The fold (bwd_fold_mma_kernel) sums, for each dpe element, the windows that
//   cover it: eight threads a element, each over its own b's and the key tiles,
//   then the eight partial sums in order.  The 64-key tiles of pass B make twice as
//   many windows as the f32 build's 128-key tiles (14 MB written and read at the
//   training shape): a 128-key block would need 8 warps on one key tile each and a
//   191-column skew tile, and fit one block an SM instead of two.
// Precision: the backward is held to 1e-4 of each output's largest |value|, and a
// bf16 rounding of ds (2^-9) would miss that.  So ds (pass B) and x (pass A) enter
// the tensor cores as hi + lo bf16 halves, two products summed in f32: x = w g is a
// product of two bf16 and hi + lo hold it exactly; q, k, w and p are bf16 already.
// The tensor cores' f32 accumulation does not round to nearest, so each chunk's
// products start from zero and are added to the running sums in f32.  The row-sum
// identity of pass A cancels a row constant of g in f32 (U and r V), where its
// rounding is ~1e-7 of the constant's share.  r is summed in f32 on the CUDA cores.
// The penalty's scores are the forward's (rel_pos_sweeps.cuh) in its arithmetic:
// q.k^T on the tensor cores with q as A and k as B, from zero, then p.pe in the same
// FMA order; pass B computes them in that orientation and moves the signs into its
// transposed layout with movmatrix.  So the forward's largest |score| and the
// backward's |s| > 25 test see the same numbers.  Occupancy: pass A holds U, V,
// their chunk sums and dp's sums for two rows a lane, and runs one block an SM
// with the registers it needs (a development build held to 128 registers for two
// blocks an SM spilled and was slower); it takes a fixed 91 KB of shared memory.
// Pass B runs two blocks an SM (one an SM, with a deeper ring, was slower) in 85 KB
// + 16 bytes a key of T (one block an SM from T ~ 1800: 125 KB at T = 2560).
//
// The f32 build (bwd_rows_kernel, bwd_keys_kernel, bwd_fold_kernel) stays on the
// CUDA cores, where the tensor cores' TF32 would cost precision:
//   pass 1, a block per (b, h, tile of rows): the row sums of g.w, then ds for
//     its rows chunk by chunk of keys in shared memory, dq and dp;
//   pass 2, a block per (b, h, tile of 128 keys): ds again for its columns,
//     16 rows at a time, dk, and dpe summed along the diagonals into a window of
//     (128 + T - 1) positional rows in shared memory, written per block;
//   then the fold.  Passes 1 and 2 read g and w again (three reads in all).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rel_pos_sweeps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPD = 4;                 // pos_head_dim
constexpr int kChunk = 128;            // pass 1: keys per shared-memory chunk
constexpr int kKeys = 128;             // pass 2: keys per block
constexpr int kRowChunk = 16;          // pass 2: rows per shared-memory chunk
constexpr float kLimit = 25.f;         // the score penalty's limit
constexpr float kPenalty = 1.0e-4f;    // and its slope

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The forward kernel's score, in its order of summation, so that the penalty
// fires on the same elements as the forward's |s| > 25 test.
template <int QD>
__device__ __forceinline__ float score(const float* qr, const float* kr, const float* pr,
                                       const float* er) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < QD; ++d) acc = fmaf(qr[d], kr[d], acc);
  float pos = pr[0] * er[0];
  pos = fmaf(pr[1], er[1], pos);
  pos = fmaf(pr[2], er[2], pos);
  pos = fmaf(pr[3], er[3], pos);
  return acc + pos;
}

__device__ __forceinline__ float penalty_grad(float s) {
  return fabsf(s) > kLimit ? copysignf(kPenalty, s) : 0.f;
}

template <int QD>
__host__ __device__ constexpr int rows1() { return kThreads / QD; }  // pass 1: rows per block

template <int QD>
constexpr size_t smem1_floats() {
  return (size_t)rows1<QD>() * QD + rows1<QD>() * kPD + kChunk * (QD + 1) +
         (kChunk + rows1<QD>() - 1) * kPD + rows1<QD>() * (kChunk + 1) + rows1<QD>();
}

template <int QD>
size_t smem2_floats(int seq) {
  return (size_t)kKeys * (QD + 1) + kRowChunk * QD + kRowChunk * kPD + kRowChunk +
         (kKeys + kRowChunk - 1) * kPD + kRowChunk * (kKeys + 1) +
         (size_t)(kKeys + seq - 1) * kPD;
}

// Pass 1.  grid = (ceil(T / R), B * H), R = kThreads / QD; thread (r, d) owns
// dq[r][d] and, for d < kPD, dp[r][d].
template <int QD>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ p, const float* __restrict__ pe,
                const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ coin, float* __restrict__ dq,
                float* __restrict__ dp, float* __restrict__ rowsum, int H, int seq) {
  constexpr int R = rows1<QD>();
  constexpr int KS = QD + 1;           // padded k row: conflict-free column reads
  constexpr int DS = kChunk + 1;
  constexpr int PW = kChunk + R - 1;   // pe rows one chunk can read
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [R][QD]
  float* p_s = q_s + R * QD;           // [R][kPD]
  float* k_s = p_s + R * kPD;          // [kChunk][KS]
  float* pe_s = k_s + kChunk * KS;     // [PW][kPD]
  float* ds_s = pe_s + PW * kPD;       // [R][DS]
  float* rs_s = ds_s + R * DS;         // [R]

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int i0 = blockIdx.x * R;
  const int nrows = min(R, seq - i0);
  const size_t row0 = (size_t)bh * seq + i0;
  const bool penalty = *coin != 0.f;
  const float* k_bh = k + (size_t)bh * seq * QD;
  const float* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;

  for (int x = threadIdx.x; x < R * QD; x += kThreads)
    q_s[x] = x / QD < nrows ? q[row0 * QD + x] : 0.f;
  for (int x = threadIdx.x; x < R * kPD; x += kThreads)
    p_s[x] = x / kPD < nrows ? p[row0 * kPD + x] : 0.f;

  // row sums of g.w: one warp per row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += kWarps) {
    float acc = 0.f;
    if (r < nrows) {
      const float* gr = g + (row0 + r) * seq;
      const float* wr = w + (row0 + r) * seq;
      for (int j = lane; j < seq; j += 32) acc = fmaf(gr[j], wr[j], acc);
      acc = warp_sum(acc);
      if (lane == 0) rowsum[row0 + r] = acc;
    }
    if (lane == 0) rs_s[r] = acc;
  }

  const int tr = threadIdx.x / QD;
  const int td = threadIdx.x % QD;
  float acc_q = 0.f, acc_p = 0.f;
  for (int j0 = 0; j0 < seq; j0 += kChunk) {
    __syncthreads();  // q_s, p_s, rs_s written; the previous chunk is consumed
    for (int x = threadIdx.x; x < kChunk * QD; x += kThreads) {
      const int j = j0 + x / QD;
      k_s[(x / QD) * KS + x % QD] = j < seq ? k_bh[(size_t)j * QD + x % QD] : 0.f;
    }
    // row i0 + r, key j reads pe row n = j - (i0 + r) + seq - 1, window index
    // (j - j0) + R - 1 - r
    const int n_lo = j0 - i0 - (R - 1) + seq - 1;
    for (int x = threadIdx.x; x < PW * kPD; x += kThreads) {
      const int n = n_lo + x / kPD;
      pe_s[x] = (n >= 0 && n < 2 * seq - 1) ? pe_h[(size_t)n * kPD + x % kPD] : 0.f;
    }
    __syncthreads();
    for (int x = threadIdx.x; x < R * kChunk; x += kThreads) {
      const int r = x / kChunk;
      const int jl = x % kChunk;
      const int j = j0 + jl;
      float d = 0.f;
      if (r < nrows && j < seq) {
        const size_t off = (row0 + r) * seq + j;
        d = w[off] * (g[off] - rs_s[r]);
        if (penalty)
          d += penalty_grad(score<QD>(q_s + r * QD, k_s + jl * KS, p_s + r * kPD,
                                      pe_s + (jl + R - 1 - r) * kPD));
      }
      ds_s[r * DS + jl] = d;
    }
    __syncthreads();
    for (int jl = 0; jl < kChunk; ++jl) {
      const float d = ds_s[tr * DS + jl];
      acc_q = fmaf(d, k_s[jl * KS + td], acc_q);
      if (td < kPD) acc_p = fmaf(d, pe_s[(jl + R - 1 - tr) * kPD + td], acc_p);
    }
  }
  if (tr < nrows) {
    dq[(row0 + tr) * QD + td] = acc_q;
    if (td < kPD) dp[(row0 + tr) * kPD + td] = acc_p;
  }
}

// Pass 2.  grid = (ceil(T / kKeys), B * H); thread t owns dk[key t % kKeys] over
// QD / 2 of its dims.  win: (B * H, gridDim.x, kKeys + T - 1, kPD); block
// (bh, tile) writes its window, whose row m is positional row n = tile * kKeys + m.
template <int QD>
__global__ void __launch_bounds__(kThreads)
bwd_keys_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ p, const float* __restrict__ pe,
                const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ coin, const float* __restrict__ rowsum,
                float* __restrict__ dk, float* __restrict__ win, int H, int seq) {
  constexpr int KS = QD + 1;
  constexpr int DS = kKeys + 1;
  constexpr int RC = kRowChunk;
  constexpr int PW = kKeys + RC - 1;
  constexpr int kDims = QD * kKeys / kThreads;   // dk dims per thread
  static_assert(kThreads % kKeys == 0 && QD % (kThreads / kKeys) == 0, "dk ownership");
  const int W = kKeys + seq - 1;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                   // [kKeys][KS]
  float* q_s = k_s + kKeys * KS;       // [RC][QD]
  float* p_s = q_s + RC * QD;          // [RC][kPD]
  float* rs_s = p_s + RC * kPD;        // [RC]
  float* pe_s = rs_s + RC;             // [PW][kPD]
  float* ds_s = pe_s + PW * kPD;       // [RC][DS]
  float* win_s = ds_s + RC * DS;       // [W][kPD]

  const int bh = blockIdx.y;
  const int h = bh % H;
  const int j0 = blockIdx.x * kKeys;
  const int nkeys = min(kKeys, seq - j0);
  const bool penalty = *coin != 0.f;
  const float* q_bh = q + (size_t)bh * seq * QD;
  const float* p_bh = p + (size_t)bh * seq * kPD;
  const float* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;
  const size_t gw_bh = (size_t)bh * seq * seq;

  for (int x = threadIdx.x; x < kKeys * QD; x += kThreads) {
    const int jl = x / QD;
    k_s[jl * KS + x % QD] =
        jl < nkeys ? k[((size_t)bh * seq + j0 + jl) * QD + x % QD] : 0.f;
  }
  for (int x = threadIdx.x; x < W * kPD; x += kThreads) win_s[x] = 0.f;

  const int jt = threadIdx.x % kKeys;
  const int d0 = (threadIdx.x / kKeys) * kDims;
  float acc[kDims];
#pragma unroll
  for (int u = 0; u < kDims; ++u) acc[u] = 0.f;

  for (int i0 = 0; i0 < seq; i0 += RC) {
    const int nr = min(RC, seq - i0);
    __syncthreads();  // the previous chunk is consumed (and k_s, win_s are set)
    for (int x = threadIdx.x; x < RC * QD; x += kThreads)
      q_s[x] = x / QD < nr ? q_bh[(size_t)i0 * QD + x] : 0.f;
    for (int x = threadIdx.x; x < RC * kPD; x += kThreads)
      p_s[x] = x / kPD < nr ? p_bh[(size_t)i0 * kPD + x] : 0.f;
    for (int x = threadIdx.x; x < RC; x += kThreads)
      rs_s[x] = x < nr ? rowsum[(size_t)bh * seq + i0 + x] : 0.f;
    const int n_lo = j0 - i0 - (RC - 1) + seq - 1;
    for (int x = threadIdx.x; x < PW * kPD; x += kThreads) {
      const int n = n_lo + x / kPD;
      pe_s[x] = (n >= 0 && n < 2 * seq - 1) ? pe_h[(size_t)n * kPD + x % kPD] : 0.f;
    }
    __syncthreads();
    for (int x = threadIdx.x; x < RC * kKeys; x += kThreads) {
      const int il = x / kKeys;
      const int jl = x % kKeys;
      float d = 0.f;
      if (il < nr && jl < nkeys) {
        const size_t off = gw_bh + (size_t)(i0 + il) * seq + j0 + jl;
        d = w[off] * (g[off] - rs_s[il]);
        if (penalty)
          d += penalty_grad(score<QD>(q_s + il * QD, k_s + jl * KS, p_s + il * kPD,
                                      pe_s + (jl + RC - 1 - il) * kPD));
      }
      ds_s[il * DS + jl] = d;
    }
    __syncthreads();
    for (int il = 0; il < RC; ++il) {
      const float d = ds_s[il * DS + jt];
#pragma unroll
      for (int u = 0; u < kDims; ++u) acc[u] = fmaf(d, q_s[il * QD + d0 + u], acc[u]);
    }
    // dpe along the diagonals: diagonal dl holds the (il, jl) with
    // jl - il = dl - (RC - 1), i.e. positional row n = j0 + m with window row
    // m = dl - (RC - 1) + seq - 1 - i0.  Distinct diagonals are distinct rows.
    for (int x = threadIdx.x; x < PW * kPD; x += kThreads) {
      const int dl = x / kPD;
      const int c = x % kPD;
      const int m = dl - (RC - 1) + seq - 1 - i0;
      if (m < 0 || m >= W) continue;
      const int il_lo = max(0, RC - 1 - dl);
      const int il_hi = min(RC, kKeys + RC - 1 - dl);
      float sum = 0.f;
      for (int il = il_lo; il < il_hi; ++il)
        sum = fmaf(ds_s[il * DS + dl - (RC - 1) + il], p_s[il * kPD + c], sum);
      win_s[m * kPD + c] += sum;
    }
  }
  __syncthreads();
  if (jt < nkeys) {
#pragma unroll
    for (int u = 0; u < kDims; ++u)
      dk[((size_t)bh * seq + j0 + jt) * QD + d0 + u] = acc[u];
  }
  float* win_b = win + ((size_t)bh * gridDim.x + blockIdx.x) * W * kPD;
  for (int x = threadIdx.x; x < W * kPD; x += kThreads) win_b[x] = win_s[x];
}

// ---------------------------------------------------------------------------
// The bf16 build: tensor cores for ds.k and ds^T.q and for the dpe diagonals.

using bf16 = __nv_bfloat16;

constexpr int kRowsA = 64;                   // pass A: query rows per block
constexpr int kKeysA = 128;                  // pass A: keys per chunk
constexpr int kStagesA = 2;                  // pass A: ring depth
constexpr int kWinA = kKeysA + kRowsA - 1;   // pass A: pe rows one chunk reads
constexpr int kWinAPad = 192;
constexpr int kKeysB = 64;                   // pass B: keys per block
constexpr int kRowsB = 64;                   // pass B: query rows per chunk
constexpr int kStagesB = 2;                  // pass B: ring depth
constexpr int kDiagB = kKeysB + kRowsB;      // pass B: diagonals of a chunk (127 used)
constexpr int kSkewPitch = kDiagB * 2 + 16;  // bytes a skew row, padded off the banks' period

template <int QD> struct BwdShape {
  static constexpr int kQDP = QD < 16 ? 16 : QD;   // q and k rows padded to 16 dims
  static constexpr int kKChunks = kQDP / 8;        // 16-byte chunks of such a row
  static constexpr int kKSteps = kQDP / 16;        // mma k-steps of a score
  static constexpr int kNT = QD / 8;               // n-tiles of a dq or dk row
  // pass A: one stage holds the g and w tiles [64 rows][128 keys], the k tile
  // [128 keys][kQDP] and the chunk's pe window (kWinA rows of 4 bf16)
  static constexpr int kTileA = kRowsA * kKeysA * 2;
  static constexpr int kKTileA = kKeysA * kQDP * 2;
  static constexpr int kStageA = 2 * kTileA + kKTileA + kWinAPad * 8;
  static constexpr int kRingA = kStagesA * kStageA;
  static constexpr int kSmemA = kRingA + 2 * kWinAPad * 16;  // + two f32 pe windows
  // pass A's exchange between the key halves, per lane: U, V, r, dpx, dpw
  static constexpr int kXA = 8 * kNT + 18;
  // pass B: one stage holds the g and w tiles [64 rows][64 keys], the q tile
  // [64 rows][kQDP], p [64 rows][8 bf16, the last 4 zero] and r [64 rows] in f32
  static constexpr int kTileB = kRowsB * kKeysB * 2;
  static constexpr int kQTileB = kRowsB * kQDP * 2;
  static constexpr int kStageB = 2 * kTileB + kQTileB + kRowsB * 16 + kRowsB * 4;
  static constexpr int kRingB = kStagesB * kStageB;
  static constexpr int kSkewB = kRowsB * kSkewPitch;  // one skew tile (hi or lo)
  static_assert(kRingA >= 4 * 32 * kXA * 4, "pass A's exchange fits its ring");
  static_assert(kRingB >= 4 * 32 * 4 * kNT * 4, "pass B's exchange fits its ring");
};

// f32 positions of pass B's dpe window: kKeysB + T - 1, rounded up to 4
__host__ __device__ inline int win_b_len(int seq) { return (kKeysB + seq - 1 + 3) & ~3; }

// rows of the row sums a (b, h) holds: T rounded up to pass A's tile
__host__ __device__ inline int rows_pad(int seq) {
  return (seq + kRowsA - 1) / kRowsA * kRowsA;
}

template <int QD> int smem_b_bytes(int seq) {
  using S = BwdShape<QD>;
  return S::kRingB + 2 * S::kSkewB + kPD * win_b_len(seq) * (int)sizeof(float);
}

// Eight consecutive elements (i, j .. j+7) of g and of w into 16 bytes of shared
// memory each, zero past T: cp.async when the rows are 16-byte aligned (T % 8 == 0),
// else element by element.
__device__ __forceinline__ void load_gw8(unsigned char* gs, unsigned char* ws,
                                         const bf16* __restrict__ g,
                                         const bf16* __restrict__ w, int i, int j,
                                         int seq, bool aligned) {
  if (aligned) {
    const bool ok = i < seq && j < seq;
    const size_t src = ok ? (size_t)i * seq + j : 0;
    zv::cp_async16(zv::smem_addr(gs), g + src, ok);
    zv::cp_async16(zv::smem_addr(ws), w + src, ok);
    return;
  }
  const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  unsigned gv[4] = {0u, 0u, 0u, 0u}, wv[4] = {0u, 0u, 0u, 0u};
  if (i < seq) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (j + u < seq) {
        const size_t off = (size_t)i * seq + j + u;
        gv[u >> 1] |= (unsigned)gu[off] << (16 * (u & 1));
        wv[u >> 1] |= (unsigned)wu[off] << (16 * (u & 1));
      }
    }
  }
  *reinterpret_cast<uint4*>(gs) = make_uint4(gv[0], gv[1], gv[2], gv[3]);
  *reinterpret_cast<uint4*>(ws) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
}

// hi + lo = x to about 2^-17 of |x| (exactly when x is a product of two bf16)
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = zv::pack_bf16(x0, x1);
  const float2 h = zv::unpack_bf16(hi);
  lo = zv::pack_bf16(x0 - h.x, x1 - h.y);
}

// Pass A.  grid = (ceil(T / kRowsA), B * H); block = kThreads.  A block owns 64
// query rows of one (b, h) and streams 128-key chunks of g, w, k and the pe window
// through a cp.async ring.  Warp w holds rows 16 (w % 4) .. + 16 and the key half
// w / 4 of each chunk, its elements in the mma A layout (ldmatrix of the g and w
// tiles).  With x = w g + penalty, it sums per row
//   r = sum_j w g,  U = x.k,  V = w.k  (tensor cores: x as hi + lo, w as it is),
//   dpx = sum_j x pe[j - i + T - 1],  dpw = sum_j w pe[...]  (CUDA cores),
// and at the end dq = U - r V, dp = dpx - r dpw (ds = x - r w), and r itself for
// pass B, over rows_pad(T) rows (zero past T).
template <int QD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ p, const bf16* __restrict__ pe,
                    const bf16* __restrict__ g, const bf16* __restrict__ w,
                    const float* __restrict__ coin, float* __restrict__ dq,
                    float* __restrict__ dp, float* __restrict__ rowsum, int H, int seq) {
  using S = BwdShape<QD>;
  extern __shared__ __align__(128) unsigned char smem_a[];
  unsigned char* ring = smem_a;
  float4* pe_f = reinterpret_cast<float4*>(smem_a + S::kRingA);  // [2][kWinAPad]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, a = lane & 3;
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int i0 = blockIdx.x * kRowsA;
  const bool penalty = *coin != 0.f;
  const bool aligned = seq % 8 == 0;
  const int nc = (seq + kKeysA - 1) / kKeysA;
  const bf16* g_bh = g + (size_t)bh * seq * seq;
  const bf16* w_bh = w + (size_t)bh * seq * seq;
  const bf16* k_bh = k + (size_t)bh * seq * QD;
  const bf16* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;

  auto load = [&](int c) {
    unsigned char* st = ring + (c % kStagesA) * S::kStageA;
    const int j0 = c * kKeysA;
    for (int x = tid; x < kRowsA * (kKeysA / 8); x += kThreads) {
      const int r = x / (kKeysA / 8), ch = x % (kKeysA / 8);
      const int off = zv::wc_off<kKeysA>(r, ch);
      load_gw8(st + off, st + S::kTileA + off, g_bh, w_bh, i0 + r, j0 + 8 * ch, seq, aligned);
    }
    unsigned char* kt = st + 2 * S::kTileA;
    for (int x = tid; x < kKeysA * S::kKChunks; x += kThreads) {
      const int r = x / S::kKChunks, ch = x % S::kKChunks;
      const int j = j0 + r;
      const bool ok = j < seq && ch * 8 < QD;  // qd = 8: chunk 1 is zero padding
      zv::cp_async16(zv::smem_addr(kt + zv::k_off<S::kKChunks>(r, ch)),
                     k_bh + (ok ? (size_t)j * QD + ch * 8 : 0), ok);
    }
    // pe rows n = j - i + T - 1 over this chunk's keys and the block's rows
    unsigned char* pt = kt + S::kKTileA;
    const int n_lo = j0 - i0 - (kRowsA - 1) + seq - 1;
    for (int x = tid; x < kWinA; x += kThreads) {
      const int n = n_lo + x;
      const bool ok = n >= 0 && n < 2 * seq - 1;
      zv::cp_async8(zv::smem_addr(pt + 8 * x), pe_h + (ok ? (size_t)n * kPD : 0), ok);
    }
  };
  // a chunk's pe window in f32 (the thread widens the rows it copied itself)
  auto widen_pe = [&](int c) {
    const unsigned char* pt =
        ring + (c % kStagesA) * S::kStageA + 2 * S::kTileA + S::kKTileA;
    float4* dst = pe_f + (c & 1) * kWinAPad;
    for (int x = tid; x < kWinA; x += kThreads) {
      const uint2 raw = *reinterpret_cast<const uint2*>(pt + 8 * x);
      const float2 e01 = zv::unpack_bf16(raw.x), e23 = zv::unpack_bf16(raw.y);
      dst[x] = make_float4(e01.x, e01.y, e23.x, e23.y);
    }
  };

#pragma unroll
  for (int s = 0; s < kStagesA - 1; ++s) {
    if (s < nc) load(s);
    zv::cp_async_commit();
  }
  zv::cp_async_wait<kStagesA - 2>();
  widen_pe(0);

  // this warp's 16 rows and key half
  const int rg = warp & 3, kh = warp >> 2;
  const int r_lo = 16 * rg + gq;  // rows r_lo and r_lo + 8 of the tile
  const bf16* q_bh = q + (size_t)bh * seq * QD;
  const bf16* p_bh = p + (size_t)bh * seq * kPD;

  float U[S::kNT][4], V[S::kNT][4];
  float dpx[2][4], dpw[2][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) U[nt][e] = V[nt][e] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 4; ++e) dpx[half][e] = dpw[half][e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    zv::cp_async_wait<kStagesA - 2>();
    __syncthreads();  // this chunk's stage has landed; everyone is done with the last
    if (c + kStagesA - 1 < nc) load(c + kStagesA - 1);
    zv::cp_async_commit();
    const unsigned gt = zv::smem_addr(ring + (c % kStagesA) * S::kStageA);
    const unsigned wt = gt + S::kTileA, kt = gt + 2 * S::kTileA;
    // window row of (row r_lo, key 64 kh + 2a of the chunk); element (row r_lo + 8 rh,
    // key 64 kh + kl) reads row kl - 2a - 8 rh of it
    const float4* win = pe_f + (c & 1) * kWinAPad + 64 * kh - 16 * rg - gq + 2 * a + kRowsA - 1;
    const int j0 = c * kKeysA;
    float cx[S::kNT][4], cw[S::kNT][4];  // this chunk's x.k and w.k, from zero
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cx[nt][e] = cw[nt][e] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int kb = 64 * kh + 16 * t;  // the tile's first key in the chunk
      // A fragments: u = 0 (row r_lo, keys kb + 2a + e), 1 (row r_lo + 8), 2 (row r_lo,
      // keys + 8), 3 (row r_lo + 8, keys + 8)
      unsigned wa[4], ga[4];
      {
        const int r = 16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int ch = kb / 8 + (lane >> 4);
        zv::ldmatrix_x4(wt + zv::wc_off<kKeysA>(r, ch), wa[0], wa[1], wa[2], wa[3]);
        zv::ldmatrix_x4(gt + zv::wc_off<kKeysA>(r, ch), ga[0], ga[1], ga[2], ga[3]);
      }
      float wf[4][2], x[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 wv = zv::unpack_bf16(wa[u]), gv = zv::unpack_bf16(ga[u]);
        wf[u][0] = wv.x;
        wf[u][1] = wv.y;
        x[u][0] = wv.x * gv.x;  // exact: a product of two bf16
        x[u][1] = wv.y * gv.y;
      }
      rs[0] += (x[0][0] + x[0][1]) + (x[2][0] + x[2][1]);
      rs[1] += (x[1][0] + x[1][1]) + (x[3][0] + x[3][1]);
      if (penalty) {
        // the forward's scores of n-tiles kb / 8 and kb / 8 + 1, in its arithmetic:
        // q's A fragments and p's rows as rel_pos_sweeps.cuh holds them (read here,
        // not held, to spare registers on the path without the penalty)
        unsigned qa[S::kKSteps][4];
        float4 pr[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + r_lo + 8 * half;
          const bool ok = i < seq;
#pragma unroll
          for (int ks = 0; ks < S::kKSteps; ++ks)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const int d = 16 * ks + 8 * hi + 2 * a;
              qa[ks][half + 2 * hi] =
                  ok && d < QD ? *reinterpret_cast<const unsigned*>(q_bh + (size_t)i * QD + d)
                               : 0u;
            }
          const uint2 raw = ok ? *reinterpret_cast<const uint2*>(p_bh + (size_t)i * kPD)
                               : make_uint2(0u, 0u);
          const float2 p01 = zv::unpack_bf16(raw.x), p23 = zv::unpack_bf16(raw.y);
          pr[half] = make_float4(p01.x, p01.y, p23.x, p23.y);
        }
        float s[2][4];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[v][e] = 0.f;
          const int krow = kb + 8 * v + (lane & 7);
          if constexpr (S::kKSteps == 2) {
            unsigned b0, b1, b2, b3;
            zv::ldmatrix_x4(kt + zv::k_off<S::kKChunks>(krow, lane >> 3), b0, b1, b2, b3);
            zv::mma_bf16(s[v], qa[0][0], qa[0][1], qa[0][2], qa[0][3], b0, b1);
            zv::mma_bf16(s[v], qa[1][0], qa[1][1], qa[1][2], qa[1][3], b2, b3);
          } else {
            unsigned b0, b1;
            zv::ldmatrix_x2(kt + zv::k_off<S::kKChunks>(krow, (lane >> 3) & 1), b0, b1);
            zv::mma_bf16(s[v], qa[0][0], qa[0][1], qa[0][2], qa[0][3], b0, b1);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[v][e] = zv::add_pos(s[v][e], pr[0], win[16 * t + 8 * v + e]);
            s[v][2 + e] = zv::add_pos(s[v][2 + e], pr[1], win[16 * t + 8 * v + e - 8]);
          }
        }
        const int i = i0 + r_lo;
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (j0 + kb + 8 * v + 2 * a + e >= seq) continue;
            if (i < seq) x[2 * v][e] += penalty_grad(s[v][e]);
            if (i + 8 < seq) x[2 * v + 1][e] += penalty_grad(s[v][2 + e]);
          }
      }
      unsigned hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_bf16(x[u][0], x[u][1], hi[u], lo[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int half = u & 1;
          const float4 ev = win[16 * t + 8 * (u >> 1) + e - 8 * half];
          dpx[half][0] = fmaf(x[u][e], ev.x, dpx[half][0]);
          dpx[half][1] = fmaf(x[u][e], ev.y, dpx[half][1]);
          dpx[half][2] = fmaf(x[u][e], ev.z, dpx[half][2]);
          dpx[half][3] = fmaf(x[u][e], ev.w, dpx[half][3]);
          dpw[half][0] = fmaf(wf[u][e], ev.x, dpw[half][0]);
          dpw[half][1] = fmaf(wf[u][e], ev.y, dpw[half][1]);
          dpw[half][2] = fmaf(wf[u][e], ev.z, dpw[half][2]);
          dpw[half][3] = fmaf(wf[u][e], ev.w, dpw[half][3]);
        }
      // B fragments of k (keys kb.. as the k dimension, dims as n) by ldmatrix.trans
      const int key = kb + (lane & 7) + 8 * ((lane >> 3) & 1);
      if constexpr (S::kNT >= 2) {
#pragma unroll
        for (int nt = 0; nt < S::kNT; nt += 2) {
          unsigned b0, b1, b2, b3;
          zv::ldmatrix_x4_trans(kt + zv::k_off<S::kKChunks>(key, nt + (lane >> 4)), b0, b1,
                                b2, b3);
          zv::mma_bf16(cx[nt], hi[0], hi[1], hi[2], hi[3], b0, b1);
          zv::mma_bf16(cx[nt], lo[0], lo[1], lo[2], lo[3], b0, b1);
          zv::mma_bf16(cw[nt], wa[0], wa[1], wa[2], wa[3], b0, b1);
          zv::mma_bf16(cx[nt + 1], hi[0], hi[1], hi[2], hi[3], b2, b3);
          zv::mma_bf16(cx[nt + 1], lo[0], lo[1], lo[2], lo[3], b2, b3);
          zv::mma_bf16(cw[nt + 1], wa[0], wa[1], wa[2], wa[3], b2, b3);
        }
      } else
      {
        unsigned b0, b1;
        zv::ldmatrix_x2_trans(kt + zv::k_off<S::kKChunks>(key, 0), b0, b1);
        zv::mma_bf16(cx[0], hi[0], hi[1], hi[2], hi[3], b0, b1);
        zv::mma_bf16(cx[0], lo[0], lo[1], lo[2], lo[3], b0, b1);
        zv::mma_bf16(cw[0], wa[0], wa[1], wa[2], wa[3], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        U[nt][e] += cx[nt][e];
        V[nt][e] += cw[nt][e];
      }
    if (c + 1 < nc) {
      zv::cp_async_wait<kStagesA - 2>();  // the next chunk's stage has landed
      widen_pe(c + 1);
    }
  }
  zv::cp_async_wait<0>();

  // each row's sums over its quad's keys
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    rs[half] = zv::quad_sum(rs[half]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dpx[half][e] = zv::quad_sum(dpx[half][e]);
      dpw[half][e] = zv::quad_sum(dpw[half][e]);
    }
  }
  __syncthreads();  // the ring becomes the key halves' exchange
  float* xs = reinterpret_cast<float*>(smem_a) + (rg * 32 + lane) * S::kXA;
  if (kh == 1) {
    int o = 0;
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[o++] = U[nt][e];
        xs[o++] = V[nt][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      xs[o++] = rs[half];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[o++] = dpx[half][e];
        xs[o++] = dpw[half][e];
      }
    }
  }
  __syncthreads();
  if (kh == 1) return;
  {
    int o = 0;
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        U[nt][e] += xs[o++];
        V[nt][e] += xs[o++];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rs[half] += xs[o++];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpx[half][e] += xs[o++];
        dpw[half][e] += xs[o++];
      }
    }
  }
  const int tpad = rows_pad(seq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r_lo + 8 * half;
    const float r = rs[half];
    if (a == 0) rowsum[(size_t)bh * tpad + i] = r;  // zero past T
    if (i >= seq) continue;
    const size_t row = (size_t)bh * seq + i;
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
      *reinterpret_cast<float2*>(dq + row * QD + 8 * nt + 2 * a) =
          make_float2(fmaf(-r, V[nt][2 * half], U[nt][2 * half]),
                      fmaf(-r, V[nt][2 * half + 1], U[nt][2 * half + 1]));
    if (a == 0)
      *reinterpret_cast<float4*>(dp + row * kPD) =
          make_float4(fmaf(-r, dpw[half][0], dpx[half][0]), fmaf(-r, dpw[half][1], dpx[half][1]),
                      fmaf(-r, dpw[half][2], dpx[half][2]), fmaf(-r, dpw[half][3], dpx[half][3]));
  }
}

// Pass B.  grid = (ceil(T / kKeysB), B * H); block = kThreads.  A block owns 64
// keys of one (b, h) and streams 64-row chunks of g, w, q, p and pass A's row
// sums.  Warp w holds keys 16 (w % 4) .. + 16 and the row half w / 4 of each chunk,
// its elements in the A layout of ds^T (ldmatrix.trans of the g and w tiles):
//   ds = w (g - r) + penalty, split into hi + lo bf16,
//   dk += ds^T q  (tensor cores), and hi and lo stored into two skew tiles
//   D[i][j - i + 63] of the chunk.
// After a barrier, warp w sums the diagonals 16 w .. + 16 of D on the tensor cores,
// dpe_window[c][n] += sum_i p_i[c] D[i][n], with p^T (c padded to 16) as A, and adds
// them to the block's window in shared memory.  The window, row n - j0 of positional
// row n, is written per block and folded by bwd_fold_kernel.
template <int QD>
__global__ void __launch_bounds__(kThreads, 2)
bwd_keys_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ p, const bf16* __restrict__ pe,
                    const bf16* __restrict__ g, const bf16* __restrict__ w,
                    const float* __restrict__ coin, const float* __restrict__ rowsum,
                    float* __restrict__ dk, float* __restrict__ win, int H, int seq) {
  using S = BwdShape<QD>;
  extern __shared__ __align__(128) unsigned char smem_b[];
  unsigned char* ring = smem_b;
  unsigned char* skew = smem_b + S::kRingB;  // hi, then lo: [64 rows][kSkewPitch bytes]
  float* win_s = reinterpret_cast<float*>(skew + 2 * S::kSkewB);  // [kPD][wlen]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, a = lane & 3;
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int j0 = blockIdx.x * kKeysB;
  const int W = kKeysB + seq - 1;  // positional rows the block's window covers
  const int wlen = win_b_len(seq);
  const bool penalty = *coin != 0.f;
  const bool aligned = seq % 8 == 0;
  const int nrc = (seq + kRowsB - 1) / kRowsB;
  const bf16* g_bh = g + (size_t)bh * seq * seq;
  const bf16* w_bh = w + (size_t)bh * seq * seq;
  const bf16* q_bh = q + (size_t)bh * seq * QD;
  const bf16* p_bh = p + (size_t)bh * seq * kPD;
  const bf16* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;
  const float* rs_bh = rowsum + (size_t)bh * rows_pad(seq);

  // zero what no chunk writes: the skew tiles outside a chunk's parallelogram, the
  // pad of each stage's p rows, and the window
  for (int x = tid; x < 2 * S::kSkewB / 16; x += kThreads)
    reinterpret_cast<uint4*>(skew)[x] = make_uint4(0u, 0u, 0u, 0u);
  for (int x = tid; x < kStagesB * kRowsB; x += kThreads) {
    unsigned char* pt = ring + (x / kRowsB) * S::kStageB + 2 * S::kTileB + S::kQTileB;
    *reinterpret_cast<uint2*>(pt + 16 * (x % kRowsB) + 8) = make_uint2(0u, 0u);
  }
  for (int x = tid; x < kPD * wlen; x += kThreads) win_s[x] = 0.f;

  auto load = [&](int rc) {
    unsigned char* st = ring + (rc % kStagesB) * S::kStageB;
    const int i0 = rc * kRowsB;
    for (int x = tid; x < kRowsB * (kKeysB / 8); x += kThreads) {
      const int r = x / (kKeysB / 8), ch = x % (kKeysB / 8);
      const int off = zv::wc_off<kKeysB>(r, ch);
      load_gw8(st + off, st + S::kTileB + off, g_bh, w_bh, i0 + r, j0 + 8 * ch, seq, aligned);
    }
    unsigned char* qt = st + 2 * S::kTileB;
    for (int x = tid; x < kRowsB * S::kKChunks; x += kThreads) {
      const int r = x / S::kKChunks, ch = x % S::kKChunks;
      const int i = i0 + r;
      const bool ok = i < seq && ch * 8 < QD;
      zv::cp_async16(zv::smem_addr(qt + zv::k_off<S::kKChunks>(r, ch)),
                     q_bh + (ok ? (size_t)i * QD + ch * 8 : 0), ok);
    }
    unsigned char* pt = qt + S::kQTileB;
    for (int x = tid; x < kRowsB; x += kThreads) {
      const int i = i0 + x;
      const bool ok = i < seq;
      zv::cp_async8(zv::smem_addr(pt + 16 * x), p_bh + (ok ? (size_t)i * kPD : 0), ok);
    }
    unsigned char* rt = pt + kRowsB * 16;
    for (int x = tid; x < kRowsB / 4; x += kThreads)
      zv::cp_async16(zv::smem_addr(rt + 16 * x), rs_bh + i0 + 4 * x, true);
  };

  __syncthreads();  // the zeroed pads before any cp.async lands beside them
#pragma unroll
  for (int s = 0; s < kStagesB - 1; ++s) {
    if (s < nrc) load(s);
    zv::cp_async_commit();
  }

  // this warp's 16 keys and row half; k's B fragments for the penalty's scores
  // (keys as the n dimension), the values the forward's ldmatrix gives
  const int mt = warp & 3, rh = warp >> 2;
  unsigned kf[2][S::kKSteps][2];
  {
    const bf16* k_bh = k + (size_t)bh * seq * QD;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int j = j0 + 16 * mt + 8 * v + gq;
#pragma unroll
      for (int ks = 0; ks < S::kKSteps; ++ks)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int d = 16 * ks + 8 * hi + 2 * a;
          kf[v][ks][hi] = j < seq && d < QD
                              ? *reinterpret_cast<const unsigned*>(k_bh + (size_t)j * QD + d)
                              : 0u;
        }
    }
  }

  float DK[S::kNT][4];
#pragma unroll
  for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) DK[nt][e] = 0.f;

  for (int rc = 0; rc < nrc; ++rc) {
    zv::cp_async_wait<kStagesB - 2>();
    __syncthreads();  // this chunk's stage has landed; the last chunk's dpe is done
    if (rc + kStagesB - 1 < nrc) load(rc + kStagesB - 1);
    zv::cp_async_commit();
    const unsigned char* st = ring + (rc % kStagesB) * S::kStageB;
    const unsigned gt = zv::smem_addr(st), wt = gt + S::kTileB;
    const unsigned qt = gt + 2 * S::kTileB, pt = qt + S::kQTileB;
    const unsigned char* pt_g = st + 2 * S::kTileB + S::kQTileB;
    const float* rt = reinterpret_cast<const float*>(pt_g + kRowsB * 16);
    const int i0 = rc * kRowsB;
    float cacc[S::kNT][4];  // this chunk's ds^T q, from zero
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[nt][e] = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int R = 32 * rh + 16 * t;  // the k-step's first row in the chunk
      const int K = 16 * mt;           // the warp's first key in the block
      // A fragments of ds^T: u = 0 (key K + gq, rows R + 2a + e), 1 (key + 8),
      // 2 (rows + 8), 3 (key + 8, rows + 8)
      unsigned wa[4], ga[4];
      {
        const int m = lane >> 3;
        const int r = R + (lane & 7) + 8 * (m >> 1);
        const int ch = K / 8 + (m & 1);
        zv::ldmatrix_x4_trans(wt + zv::wc_off<kKeysB>(r, ch), wa[0], wa[1], wa[2], wa[3]);
        zv::ldmatrix_x4_trans(gt + zv::wc_off<kKeysB>(r, ch), ga[0], ga[1], ga[2], ga[3]);
      }
      const float2 r01 = *reinterpret_cast<const float2*>(rt + R + 2 * a);
      const float2 r89 = *reinterpret_cast<const float2*>(rt + R + 2 * a + 8);
      float ds[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 wv = zv::unpack_bf16(wa[u]), gv = zv::unpack_bf16(ga[u]);
        const float2 rr = (u >> 1) ? r89 : r01;
        ds[u][0] = wv.x * (gv.x - rr.x);
        ds[u][1] = wv.y * (gv.y - rr.y);
      }
      if (penalty) {
        // the forward's scores S = q k^T of rows R.. (m) and the warp's keys (n), in
        // its arithmetic; their penalty signs, as bf16 in the C layout, are moved into
        // ds^T's layout by movmatrix
        unsigned qa[S::kKSteps][4];
#pragma unroll
        for (int ks = 0; ks < S::kKSteps; ++ks) {
          const int m = lane >> 3;
          zv::ldmatrix_x4(qt + zv::k_off<S::kKChunks>(R + (lane & 7) + 8 * (m & 1),
                                                      2 * ks + (m >> 1)),
                          qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3]);
        }
        float4 prow[2];
#pragma unroll
        for (int rhf = 0; rhf < 2; ++rhf) {
          const uint2 raw = *reinterpret_cast<const uint2*>(pt_g + 16 * (R + gq + 8 * rhf));
          const float2 p01 = zv::unpack_bf16(raw.x), p23 = zv::unpack_bf16(raw.y);
          prow[rhf] = make_float4(p01.x, p01.y, p23.x, p23.y);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < S::kKSteps; ++ks)
            zv::mma_bf16(s, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], kf[v][ks][0],
                         kf[v][ks][1]);
#pragma unroll
          for (int rhf = 0; rhf < 2; ++rhf) {
            float sg[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = i0 + R + gq + 8 * rhf;
              const int j = j0 + 16 * mt + 8 * v + 2 * a + e;
              sg[e] = 0.f;
              if (i < seq && j < seq) {
                const uint2 raw =
                    __ldg(reinterpret_cast<const uint2*>(pe_h + (size_t)(j - i + seq - 1) * kPD));
                const float2 e01 = zv::unpack_bf16(raw.x), e23 = zv::unpack_bf16(raw.y);
                const float sc = zv::add_pos(s[2 * rhf + e], prow[rhf],
                                             make_float4(e01.x, e01.y, e23.x, e23.y));
                sg[e] = fabsf(sc) > kLimit ? copysignf(1.f, sc) : 0.f;
              }
            }
            const float2 tv = zv::unpack_bf16(zv::movmatrix_trans(zv::pack_bf16(sg[0], sg[1])));
            ds[v + 2 * rhf][0] += kPenalty * tv.x;
            ds[v + 2 * rhf][1] += kPenalty * tv.y;
          }
        }
      }
      unsigned hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_bf16(ds[u][0], ds[u][1], hi[u], lo[u]);
      // B fragments of q (rows R.. as the k dimension, dims as n) by ldmatrix.trans
      const int row = R + (lane & 7) + 8 * ((lane >> 3) & 1);
      if constexpr (S::kNT >= 2) {
#pragma unroll
        for (int nt = 0; nt < S::kNT; nt += 2) {
          unsigned b0, b1, b2, b3;
          zv::ldmatrix_x4_trans(qt + zv::k_off<S::kKChunks>(row, nt + (lane >> 4)), b0, b1,
                                b2, b3);
          zv::mma_bf16(cacc[nt], hi[0], hi[1], hi[2], hi[3], b0, b1);
          zv::mma_bf16(cacc[nt], lo[0], lo[1], lo[2], lo[3], b0, b1);
          zv::mma_bf16(cacc[nt + 1], hi[0], hi[1], hi[2], hi[3], b2, b3);
          zv::mma_bf16(cacc[nt + 1], lo[0], lo[1], lo[2], lo[3], b2, b3);
        }
      } else {
        unsigned b0, b1;
        zv::ldmatrix_x2_trans(qt + zv::k_off<S::kKChunks>(row, 0), b0, b1);
        zv::mma_bf16(cacc[0], hi[0], hi[1], hi[2], hi[3], b0, b1);
        zv::mma_bf16(cacc[0], lo[0], lo[1], lo[2], lo[3], b0, b1);
      }
      // hi and lo into the skew tiles: element (row il, key jl) at D[il][jl - il + 63]
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int il = R + 2 * a + e + 8 * (u >> 1);
          const int jl = K + gq + 8 * (u & 1);
          const int off = il * kSkewPitch + 2 * (jl - il + kRowsB - 1);
          *reinterpret_cast<unsigned short*>(skew + off) =
              static_cast<unsigned short>(hi[u] >> (16 * e));
          *reinterpret_cast<unsigned short*>(skew + S::kSkewB + off) =
              static_cast<unsigned short>(lo[u] >> (16 * e));
        }
    }
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) DK[nt][e] += cacc[nt][e];
    __syncthreads();  // the chunk's skew tiles are complete

    // dpe: diagonals d = 16 warp .. + 16 of the chunk, over its 64 rows
    {
      float pacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kRowsB / 16; ++ks) {
        const int row = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
        unsigned pa0, pa2;  // p^T: (c = gq, rows 2a, 2a + 1) and (rows + 8); c >= 4 zero
        zv::ldmatrix_x2_trans(pt + 16 * row, pa0, pa2);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          unsigned b0, b1, b2, b3;
          zv::ldmatrix_x4_trans(zv::smem_addr(skew + part * S::kSkewB + row * kSkewPitch +
                                              16 * (2 * warp + (lane >> 4))),
                                b0, b1, b2, b3);
          zv::mma_bf16(pacc[0], pa0, 0u, pa2, 0u, b0, b1);
          zv::mma_bf16(pacc[1], pa0, 0u, pa2, 0u, b2, b3);
        }
      }
      if (gq < kPD) {
        // diagonal d holds positional row n = j0 - i0 + d - 63 + T - 1, window row
        // n - j0; rows past T give d's whose window row falls below 0 (their ds is 0)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = 16 * warp + 8 * v + 2 * a + e;
            const int m = d - (kRowsB - 1) - i0 + seq - 1;
            if (m >= 0 && m < W) win_s[gq * wlen + m] += pacc[v][e];
          }
      }
    }
  }
  zv::cp_async_wait<0>();
  __syncthreads();  // the ring becomes the row halves' exchange
  float* xs = reinterpret_cast<float*>(smem_b) + (mt * 32 + lane) * 4 * S::kNT;
  if (rh == 1) {
#pragma unroll
    for (int nt = 0; nt < S::kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[4 * nt + e] = DK[nt][e];
  }
  __syncthreads();
  if (rh == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + 16 * mt + gq + 8 * half;
      if (j >= seq) continue;
      const size_t row = (size_t)bh * seq + j;
#pragma unroll
      for (int nt = 0; nt < S::kNT; ++nt)
        *reinterpret_cast<float2*>(dk + row * QD + 8 * nt + 2 * a) =
            make_float2(DK[nt][2 * half] + xs[4 * nt + 2 * half],
                        DK[nt][2 * half + 1] + xs[4 * nt + 2 * half + 1]);
    }
  }
  float4* win_b = reinterpret_cast<float4*>(
      win + ((size_t)bh * gridDim.x + blockIdx.x) * kPD * wlen);
  for (int x = tid; x < kPD * wlen / 4; x += kThreads)
    win_b[x] = reinterpret_cast<const float4*>(win_s)[x];
}

// The f32 build's fold.  One thread per dpe element (h, n, c): the windows of
// every b and key tile that cover row n, summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
bwd_fold_kernel(const float* __restrict__ win, float* __restrict__ dpe, int B, int H,
                int seq, int tiles) {
  const int rows = 2 * seq - 1;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= H * rows * kPD) return;
  const int c = x % kPD;
  const int n = (x / kPD) % rows;
  const int h = x / (kPD * rows);
  const int W = kKeys + seq - 1;
  const int lo = n - W + 1;  // tile t covers n when t * kKeys <= n < t * kKeys + W
  const int t_lo = lo <= 0 ? 0 : (lo + kKeys - 1) / kKeys;
  const int t_hi = min(tiles - 1, n / kKeys);
  float sum = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* win_bh = win + (size_t)(b * H + h) * tiles * W * kPD;
    for (int t = t_lo; t <= t_hi; ++t)
      sum += win_bh[((size_t)t * W + n - t * kKeys) * kPD + c];
  }
  dpe[x] = sum;
}

// The bf16 build's fold.  grid = (ceil((2T - 1) / 32), H * kPD), block = (32, 8):
// thread (x, y) of block (nx, h * kPD + c) sums, for positional row n = 32 nx + x,
// the windows [c][n - 64 t] of pass B's key tiles t that cover n, over the b = y,
// y + 8, ...; the eight partial sums of a row are then added in order.  A warp
// reads 32 neighbouring window rows.
__global__ void __launch_bounds__(kThreads)
bwd_fold_mma_kernel(const float* __restrict__ win, float* __restrict__ dpe, int B, int H,
                    int seq, int tiles) {
  constexpr int kGroups = kThreads / 32;
  __shared__ float part[kGroups][33];
  const int rows = 2 * seq - 1;
  const int n = blockIdx.x * 32 + threadIdx.x;
  const int c = blockIdx.y % kPD, h = blockIdx.y / kPD;
  const int W = kKeysB + seq - 1;
  const int wlen = win_b_len(seq);
  float sum = 0.f;
  if (n < rows) {
    const int lo = n - W + 1;  // tile t covers n when t * kKeysB <= n < t * kKeysB + W
    const int t_lo = lo <= 0 ? 0 : (lo + kKeysB - 1) / kKeysB;
    const int t_hi = min(tiles - 1, n / kKeysB);
    for (int b = threadIdx.y; b < B; b += kGroups) {
      const float* win_c = win + (size_t)(b * H + h) * tiles * kPD * wlen + (size_t)c * wlen;
      for (int t = t_lo; t <= t_hi; ++t) sum += win_c[(size_t)t * kPD * wlen + n - t * kKeysB];
    }
  }
  part[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && n < rows) {
    float total = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kGroups; ++y) total += part[y][threadIdx.x];
    dpe[((size_t)h * rows + n) * kPD + c] = total;
  }
}

// The f32 build: passes 1 and 2 on the CUDA cores, then the fold.
template <int QD>
cudaError_t launch_f32(const void* q, const void* k, const void* p, const void* pe,
                       const void* g, const void* w, const void* coin, void* dq, void* dk,
                       void* dp, void* dpe, void* scratch, int B, int H, int seq,
                       cudaStream_t stream) {
  constexpr int R = rows1<QD>();
  float* rowsum = static_cast<float*>(scratch);
  float* win = rowsum + (size_t)B * H * seq;
  const int tiles = (seq + kKeys - 1) / kKeys;

  const size_t smem1 = sizeof(float) * smem1_floats<QD>();
  auto k1 = bwd_rows_kernel<QD>;
  cudaError_t err =
      cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3((seq + R - 1) / R, B * H), kThreads, smem1, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(p), static_cast<const float*>(pe),
      static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<const float*>(coin), static_cast<float*>(dq), static_cast<float*>(dp),
      rowsum, H, seq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem2 = sizeof(float) * smem2_floats<QD>(seq);
  auto k2 = bwd_keys_kernel<QD>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  k2<<<dim3(tiles, B * H), kThreads, smem2, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(p), static_cast<const float*>(pe),
      static_cast<const float*>(g), static_cast<const float*>(w),
      static_cast<const float*>(coin), rowsum, static_cast<float*>(dk), win, H, seq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int n_out = H * (2 * seq - 1) * kPD;
  bwd_fold_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      win, static_cast<float*>(dpe), B, H, seq, tiles);
  return cudaGetLastError();
}

// The bf16 build: passes A and B on the tensor cores, then the fold.
template <int QD>
cudaError_t launch_mma(const void* q, const void* k, const void* p, const void* pe,
                       const void* g, const void* w, const void* coin, void* dq, void* dk,
                       void* dp, void* dpe, void* scratch, int B, int H, int seq,
                       cudaStream_t stream) {
  using S = BwdShape<QD>;
  float* rowsum = static_cast<float*>(scratch);
  float* win = rowsum + (size_t)B * H * rows_pad(seq);
  const int tiles_a = (seq + kRowsA - 1) / kRowsA;
  const int tiles_b = (seq + kKeysB - 1) / kKeysB;

  auto ka = bwd_rows_mma_kernel<QD>;
  cudaError_t err =
      cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemA);
  if (err != cudaSuccess) return err;
  ka<<<dim3(tiles_a, B * H), kThreads, S::kSmemA, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(p),
      static_cast<const bf16*>(pe), static_cast<const bf16*>(g), static_cast<const bf16*>(w),
      static_cast<const float*>(coin), static_cast<float*>(dq), static_cast<float*>(dp),
      rowsum, H, seq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem_b_len = smem_b_bytes<QD>(seq);
  auto kb = bwd_keys_mma_kernel<QD>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b_len);
  if (err != cudaSuccess) return err;
  kb<<<dim3(tiles_b, B * H), kThreads, smem_b_len, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(p),
      static_cast<const bf16*>(pe), static_cast<const bf16*>(g), static_cast<const bf16*>(w),
      static_cast<const float*>(coin), rowsum, static_cast<float*>(dk), win, H, seq);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_fold_mma_kernel<<<dim3((2 * seq - 1 + 31) / 32, H * kPD), dim3(32, kThreads / 32), 0,
                        stream>>>(win, static_cast<float*>(dpe), B, H, seq, tiles_b);
  return cudaGetLastError();
}

template <int QD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* p, const void* pe,
                   const void* g, const void* w, const void* coin, void* dq, void* dk,
                   void* dp, void* dpe, void* scratch, int B, int H, int seq,
                   cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_f32<QD>(q, k, p, pe, g, w, coin, dq, dk, dp, dpe, scratch, B, H, seq, s);
    case 1: return launch_mma<QD>(q, k, p, pe, g, w, coin, dq, dk, dp, dpe, scratch, B, H, seq, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core build), 1 = bfloat16 (the tensor-core build),
// for q, k, p, pe, g and w alike; coin, dq, dk, dp, dpe and scratch are f32.
// scratch holds zv_rel_pos_attention_bwd_scratch_floats(dtype, B, H, seq) floats.
// Launches the three kernels on `stream` without synchronising; returns
// cudaGetLastError() (0 on success).
extern "C" int zv_rel_pos_attention_bwd(int dtype, int qd, const void* q, const void* k,
                                        const void* p, const void* pe, const void* g,
                                        const void* w, const void* coin, void* dq, void* dk,
                                        void* dp, void* dpe, void* scratch, int B, int H,
                                        int seq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 32: the ZipVoice models' query_head_dim; 8: the tests' small models
  switch (qd) {
    case 8:
      return launch<8>(dtype, q, k, p, pe, g, w, coin, dq, dk, dp, dpe, scratch, B, H, seq, s);
    case 32:
      return launch<32>(dtype, q, k, p, pe, g, w, coin, dq, dk, dp, dpe, scratch, B, H, seq, s);
    default: return cudaErrorInvalidValue;
  }
}

// f32 scratch the backward of `dtype` needs: the row sums and the dpe windows.
extern "C" long long zv_rel_pos_attention_bwd_scratch_floats(int dtype, int B, int H, int seq) {
  const long long bh = (long long)B * H;
  if (dtype == 1)
    return bh * rows_pad(seq) +
           bh * ((seq + kKeysB - 1) / kKeysB) * kPD * (long long)win_b_len(seq);
  const long long tiles = (seq + kKeys - 1) / kKeys;
  return bh * seq + bh * tiles * (kKeys + seq - 1) * kPD;
}

// Dynamic shared memory of the larger kernel of the build of `dtype`; the
// wrapper checks it against the card's limit before launching.
extern "C" long long zv_rel_pos_attention_bwd_smem_bytes(int dtype, int qd, int seq) {
  long long f1, f2;
  switch (qd) {
    case 8:
      f1 = dtype == 1 ? BwdShape<8>::kSmemA : sizeof(float) * smem1_floats<8>();
      f2 = dtype == 1 ? smem_b_bytes<8>(seq) : sizeof(float) * smem2_floats<8>(seq);
      break;
    case 32:
      f1 = dtype == 1 ? BwdShape<32>::kSmemA : sizeof(float) * smem1_floats<32>();
      f2 = dtype == 1 ? smem_b_bytes<32>(seq) : sizeof(float) * smem2_floats<32>(seq);
      break;
    default: return -1;
  }
  return f1 > f2 ? f1 : f2;
}
