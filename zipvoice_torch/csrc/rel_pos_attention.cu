// Relative-position attention weights for Hopper (sm_90a).
//
// Replaces the TPU kernel zipvoice_tpu/ops/pallas_attention.py::_attn_weights_kernel
// (reached through rel_pos_attention_weights).  For every (b, h, query row i, key j):
//
//   out[b,h,i,j] = softmax_j( q_i . k_j + p_i . pe[h, j - i + T - 1] ),
//   with a masked key's score replaced by -1000 (not -inf, so that a row whose
//   keys are all masked stays finite and uniform),
//
// accumulated in f32 and written once in the input dtype.
//
// What bounds it: the (B, h, T, T) write.  At the main path's shape (B=16
// after CFG doubling, h=4, T=1280, bf16) that is 210 MB against ~11 MB of reads
// and ~8 GFLOP, so on an H100 the floor is the memory rate (about 66 us at
// 3.35 TB/s).  Between the floor and a kernel stand the q.k products (3.4 G
// multiply-adds at that shape, about 0.1 ms on the f32 CUDA cores alone), the
// exp of every score, and the bytes a block re-reads.
//
// Three builds:
// - bf16 inference (rel_pos_mma_kernel): the two sweeps of rel_pos_sweeps.cuh, the
//   same code as the fused weights + NonlinAttention kernel's
//   (rel_pos_attention_nonlin.cu) without its na phase.  A block owns 64 query rows
//   (k is read T/64 times a sequence from L2, not T/8), q.k^T runs on the tensor
//   cores, 128-key chunks stream through a cp.async ring, no score row is held (an
//   online max and sum in sweep 1, the scores recomputed in sweep 2 and each weight
//   rounded once), and each warp stores its weights as 16-byte coalesced stores.
//   Its shared memory is a fixed ring plus 4 bytes a key, so T is not bounded by a
//   score row.  On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py) it takes about
//   3.6x its byte bound at the main path's shape: like the fused kernel it is bound
//   by latency (a barrier per chunk, a dependent chain per score) and by two exps a
//   score (sweep 1's sum, sweep 2's weight).
// - f32 inference and the training build in both dtypes (rel_pos_weights_kernel):
//   the CUDA cores in f32, where TF32 would cost precision.  A block owns kRows
//   query rows of one (b, h), computes their full score rows into shared memory,
//   normalises them there and writes each weight exactly once.  The TPU kernel's
//   strided roll for the rel->abs skew is only an index here: key j of row i reads
//   positional row j - i + T - 1 from a window of the pe table staged in shared
//   memory for each chunk of keys.
// - The training build (kBlockMax = true) replaces
//   zipvoice_tpu/ops/pallas_attention.py::_attn_weights_train_kernel: the same
//   weights, and each block also writes the largest |pre-mask score| of its rows
//   to block_max[(b, h), row tile], from which the wrapper takes one amax.  The
//   backward uses it to skip the score penalty when no |score| exceeds its limit.
//
// Ragged T is masked in every build (no tile-multiple rule).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rel_pos_sweeps.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                      // query rows per block
constexpr int kKeysPerThread = 2;             // keys each thread scores per chunk
constexpr int kChunk = kThreads * kKeysPerThread;
constexpr int kPD = 4;                        // pos_head_dim
constexpr int kWindow = kChunk + kRows - 1;   // pe rows one chunk can read

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One contiguous row of QD elements (16-byte aligned) into f32 registers.
template <typename T, int QD>
__device__ __forceinline__ void load_row(const T* __restrict__ src, float (&dst)[QD]) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(QD % kVec == 0, "a row must be a whole number of 16-byte vectors");
#pragma unroll
  for (int v = 0; v < QD / kVec; ++v) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + v);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[v * kVec + u] = to_float(e[u]);
  }
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
// nonzero = padded key; out: (B, H, T, T); block_max (training build only):
// (B * H, ceil(T / kRows)) f32.  All contiguous.
template <typename T, int QD, bool kBlockMax>
__global__ void __launch_bounds__(kThreads)
rel_pos_weights_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ p, const T* __restrict__ pe,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       float* __restrict__ block_max, int H, int seq) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [kRows][QD]
  float* p_s = q_s + kRows * QD;              // [kRows][kPD]
  float* pe_s = p_s + kRows * kPD;            // [kWindow][kPD]
  float* scores = pe_s + kWindow * kPD;       // [kRows][seq]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.x * kRows;
  const int nrows = min(kRows, seq - i0);
  const size_t row0 = (size_t)bh * seq + i0;  // first query row, counted over (B, H, T)

  for (int x = threadIdx.x; x < kRows * QD; x += kThreads)
    q_s[x] = x / QD < nrows ? to_float(q[row0 * QD + x]) : 0.f;
  for (int x = threadIdx.x; x < kRows * kPD; x += kThreads)
    p_s[x] = x / kPD < nrows ? to_float(p[row0 * kPD + x]) : 0.f;

  const T* k_bh = k + (size_t)bh * seq * QD;
  const T* pe_h = pe + (size_t)h * (2 * seq - 1) * kPD;
  const uint8_t* mask_b = mask + (size_t)b * seq;
  float abs_max = 0.f;  // training build: largest |pre-mask score| seen here

  for (int j0 = 0; j0 < seq; j0 += kChunk) {
    __syncthreads();  // q_s/p_s are written; the previous chunk is done with pe_s
    // Row i0 + r reads pe row n = j - (i0 + r) + seq - 1.  Over this chunk's keys
    // and the block's rows, n runs over [n_lo, n_lo + kWindow).
    const int n_lo = j0 - i0 - (kRows - 1) + seq - 1;
    for (int x = threadIdx.x; x < kWindow * kPD; x += kThreads) {
      const int n = n_lo + x / kPD;
      pe_s[x] = (n >= 0 && n < 2 * seq - 1) ? to_float(pe_h[(size_t)n * kPD + x % kPD]) : 0.f;
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
        load_row<T, QD>(k_bh + (size_t)j * QD, kr[u]);
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
          if constexpr (kBlockMax) abs_max = fmaxf(abs_max, fabsf(score));
          scores[(size_t)r * seq + j0 + jl] = masked[u] ? -1000.f : score;
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if constexpr (kBlockMax) {
    __shared__ float warp_maxes[kWarps];
    abs_max = warp_max(abs_max);
    if (lane == 0) warp_maxes[warp] = abs_max;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = warp_maxes[0];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_maxes[w]);
      block_max[(size_t)bh * gridDim.x + blockIdx.x] = m;
    }
  }

  // Row softmax: one warp per row, in f32, then one write per weight.
  for (int r = warp; r < nrows; r += kWarps) {
    float* row = scores + (size_t)r * seq;
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
    T* orow = out + (row0 + r) * (size_t)seq;
    for (int j = lane; j < seq; j += 32) orow[j] = from_float<T>(row[j] * inv);
  }
}

// The bf16 inference build.  grid = (ceil(T / zv::kRowsN), B * H), blockIdx.y =
// b * H + h, so that the blocks of one (b, h) run together and share k from L2;
// block = zv::kThreadsN.  Arguments as rel_pos_weights_kernel's, all bf16 but the mask.
template <int QD>
__global__ void __launch_bounds__(zv::kThreadsN, 2)
rel_pos_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ pe,
                   const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, int H,
                   int seq) {
  extern __shared__ __align__(128) unsigned char smem_w[];
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  zv::rel_pos_sweeps<QD>(q, k, p, pe, mask, out, smem_w,
                         smem_w + zv::SweepShape<QD>::kSweepRingBytes, b, h, H,
                         blockIdx.x * zv::kRowsN, seq);
}

long long mma_smem_bytes(int qd, int seq) {
  const int ring = qd == 8 ? zv::SweepShape<8>::kSweepRingBytes
                           : zv::SweepShape<32>::kSweepRingBytes;
  return (long long)ring + zv::sweep_tail_bytes(seq);
}

long long cuda_core_smem_bytes(int qd, int seq) {
  return (long long)sizeof(float) *
         ((long long)kRows * qd + kRows * kPD + kWindow * kPD + (long long)kRows * seq);
}

template <int QD>
cudaError_t launch_mma(const void* q, const void* k, const void* p, const void* pe,
                       const void* mask, void* out, int B, int H, int seq,
                       cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int smem = (int)mma_smem_bytes(QD, seq);
  auto kernel = rel_pos_mma_kernel<QD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + zv::kRowsN - 1) / zv::kRowsN, B * H);
  kernel<<<grid, zv::kThreadsN, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(p),
      static_cast<const bf16*>(pe), static_cast<const uint8_t*>(mask), static_cast<bf16*>(out),
      H, seq);
  return cudaGetLastError();
}

template <typename T, int QD, bool kBlockMax>
cudaError_t launch(const void* q, const void* k, const void* p, const void* pe,
                   const void* mask, void* out, float* block_max, int B, int H, int seq,
                   cudaStream_t stream) {
  if constexpr (!kBlockMax && sizeof(T) == 2) {  // the bf16 inference build
    return launch_mma<QD>(q, k, p, pe, mask, out, B, H, seq, stream);
  } else {
    const size_t smem = cuda_core_smem_bytes(QD, seq);
    auto kernel = rel_pos_weights_kernel<T, QD, kBlockMax>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + kRows - 1) / kRows, B * H);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(p),
        static_cast<const T*>(pe), static_cast<const uint8_t*>(mask), static_cast<T*>(out),
        block_max, H, seq);
    return cudaGetLastError();
  }
}

template <typename T, bool kBlockMax>
cudaError_t dispatch_qd(int qd, const void* q, const void* k, const void* p, const void* pe,
                        const void* mask, void* out, float* block_max, int B, int H, int seq,
                        cudaStream_t stream) {
  // 32: the ZipVoice models' query_head_dim; 8: the tests' small models
  switch (qd) {
    case 8:
      return launch<T, 8, kBlockMax>(q, k, p, pe, mask, out, block_max, B, H, seq, stream);
    case 32:
      return launch<T, 32, kBlockMax>(q, k, p, pe, mask, out, block_max, B, H, seq, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBlockMax>
int dispatch(int dtype, int qd, const void* q, const void* k, const void* p, const void* pe,
             const void* mask, void* out, float* block_max, int B, int H, int seq,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_qd<float, kBlockMax>(qd, q, k, p, pe, mask, out, block_max, B, H, seq, s);
    case 1:
      return dispatch_qd<__nv_bfloat16, kBlockMax>(qd, q, k, p, pe, mask, out, block_max, B, H,
                                                   seq, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core build), 1 = bfloat16 (the tensor-core build).
// Returns cudaGetLastError() after the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int zv_rel_pos_attention_weights(int dtype, int qd, const void* q, const void* k,
                                            const void* p, const void* pe, const void* mask,
                                            void* out, int B, int H, int seq, void* stream) {
  return dispatch<false>(dtype, qd, q, k, p, pe, mask, out, nullptr, B, H, seq, stream);
}

// The training build (CUDA cores in both dtypes): as above, and block_max ((B * H, ceil(seq / kRows)) f32)
// receives each block's largest |pre-mask score|.
extern "C" int zv_rel_pos_attention_weights_train(int dtype, int qd, const void* q,
                                                  const void* k, const void* p, const void* pe,
                                                  const void* mask, void* out, void* block_max,
                                                  int B, int H, int seq, void* stream) {
  return dispatch<true>(dtype, qd, q, k, p, pe, mask, out, static_cast<float*>(block_max), B,
                        H, seq, stream);
}

// Query rows per block of the training build: the width of block_max's second
// axis is ceil(seq / this).
extern "C" int zv_rel_pos_attention_rows_per_block() { return kRows; }

// Dynamic shared memory one block of the build that (dtype, train) selects needs
// at (qd, seq); the wrapper checks it against the card's limit before launching.
extern "C" long long zv_rel_pos_attention_smem_bytes(int dtype, int train, int qd, int seq) {
  return dtype == 1 && !train ? mma_smem_bytes(qd, seq) : cuda_core_smem_bytes(qd, seq);
}
