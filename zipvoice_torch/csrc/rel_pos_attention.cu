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
// 3.35 TB/s).  The design therefore keeps every intermediate out of device
// memory: a block owns kRows query rows of one (b, h), computes their full score
// rows into shared memory, normalises them there and writes each weight exactly
// once.  The TPU kernel's strided roll for the rel->abs skew is only an index
// here: key j of row i reads positional row j - i + T - 1 from a window of the
// pe table staged in shared memory for each chunk of keys.
//
// Ragged T is masked (no tile-multiple rule).  This first version does the dot
// products on the CUDA cores in f32; tensor cores (wgmma) and TMA are later work.
//
// The training build (kBlockMax = true) replaces
// zipvoice_tpu/ops/pallas_attention.py::_attn_weights_train_kernel: the same
// weights, and each block also writes the largest |pre-mask score| of its rows
// to block_max[(b, h), row tile], from which the wrapper takes one amax.  The
// backward uses it to skip the score penalty when no |score| exceeds its limit.
// It adds one register-resident max per key and one block reduction, nothing
// to the bytes; the inference build (kBlockMax = false) compiles to the code it
// had before the training build existed.
//
// The nonlin build (kHid > 0) replaces
// zipvoice_tpu/ops/pallas_attention.py::_attn_weights_nonlin_kernel: the same weights,
// and a block of head 0 also applies its rows' weights, rounded to the output dtype
// as the TPU kernel's `wc` is, to NonlinAttention's gated values:
//
//   na[b, i, :] = sum_j wc[b, 0, i, j] * nv[b, j, :]    (f32 sums, rounded once),
//
// which saves the (B, T, T) re-read of head 0's weights and a launch.  The weights
// stay in shared memory after the softmax; nv (B, T, kHid) streams through two
// shared-memory buffers of kNvKeys keys, filled by cp.async one tile ahead of the
// sums; four groups of 64 threads each take a quarter of a tile's keys, each thread
// holds its channel pairs of all kRows rows in registers, and the four groups are
// folded in a fixed order at the end.  This adds 2 T kHid multiply-adds per row to
// head 0's blocks (about 10x a weights block's work at kHid = 384) on the CUDA cores
// in f32, and each head-0 block reads its sequence's nv from L2; tensor cores and
// row tiles that share nv are later work.  The other heads' blocks do exactly what
// the inference build does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                      // query rows per block
constexpr int kKeysPerThread = 2;             // keys each thread scores per chunk
constexpr int kChunk = kThreads * kKeysPerThread;
constexpr int kPD = 4;                        // pos_head_dim
constexpr int kWindow = kChunk + kRows - 1;   // pe rows one chunk can read
constexpr int kNvKeys = 32;                   // nonlin build: keys per nv tile
constexpr int kKeyGroups = kThreads / 64;     // nonlin build: 64 threads per group
constexpr int kGroupKeys = kNvKeys / kKeyGroups;
static_assert(kGroupKeys % 4 == 0, "a group reads its keys' weights as float4s");

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

// Two neighbouring channels of nv: raw (to stage them) and as f32.
template <typename T> struct Pair;
template <> struct Pair<float> {
  using Raw = uint2;
  static __device__ __forceinline__ float2 get(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};
template <> struct Pair<__nv_bfloat16> {
  using Raw = uint32_t;
  static __device__ __forceinline__ float2 get(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// 16 bytes global -> shared without registers; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group have landed
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
// nonzero = padded key; out: (B, H, T, T); block_max (training build only):
// (B * H, ceil(T / kRows)) f32; nv, na (nonlin build only): (B, T, kHid).  All
// contiguous.
template <typename T, int QD, bool kBlockMax, int kHid>
__global__ void __launch_bounds__(kThreads)
rel_pos_weights_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ p, const T* __restrict__ pe,
                       const uint8_t* __restrict__ mask, T* __restrict__ out,
                       float* __restrict__ block_max, const T* __restrict__ nv,
                       T* __restrict__ na, int H, int seq) {
  extern __shared__ __align__(16) float smem[];
  // score rows; the nonlin build pads them to whole nv tiles
  const int ld = kHid > 0 ? (seq + kNvKeys - 1) / kNvKeys * kNvKeys : seq;
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
          scores[(size_t)r * ld + j0 + jl] = masked[u] ? -1000.f : score;
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
    T* orow = out + (row0 + r) * (size_t)seq;
    for (int j = lane; j < seq; j += 32) {
      const T wv = from_float<T>(row[j] * inv);
      orow[j] = wv;
      if constexpr (kHid > 0) row[j] = to_float(wv);  // wc, as head 0 applies it
    }
    if constexpr (kHid > 0)
      for (int j = seq + lane; j < ld; j += 32) row[j] = 0.f;
  }

  if constexpr (kHid > 0) {
    if (h != 0) return;  // the whole block: only head 0 applies its weights
    static_assert(kHid % 2 == 0 && (kHid * sizeof(T)) % 16 == 0,
                  "nv rows must be whole 16-byte vectors of channel pairs");
    constexpr int kPairs = kHid / 2;
    constexpr int kNaPairs = (kPairs + 63) / 64;  // channel pairs per thread
    constexpr int kRowVecs = kHid * (int)sizeof(T) / 16;
    constexpr int kTileElems = kNvKeys * kHid;
    T* tiles = reinterpret_cast<T*>(scores + (size_t)kRows * ld);  // [2][kNvKeys][kHid]
    const int group = threadIdx.x / 64;
    const int cl = threadIdx.x % 64;
    const T* nv_b = nv + (size_t)b * seq * kHid;
    auto fetch = [&](int tile, T* dst) {
      const int j0 = tile * kNvKeys;
      for (int x = threadIdx.x; x < kNvKeys * kRowVecs; x += kThreads) {
        const int j = j0 + x / kRowVecs;
        const T* src = nv_b + (size_t)(j < seq ? j : 0) * kHid;
        cp_async16(reinterpret_cast<uint4*>(dst) + x,
                   reinterpret_cast<const uint4*>(src) + x % kRowVecs, j < seq);
      }
      cp_async_commit();
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
        cp_async_commit();  // an empty group keeps "all but the newest" exact
      cp_async_wait_one();
      __syncthreads();  // tile t has landed for every thread; the weights are final
      const T* tile = tiles + (t & 1) * kTileElems;
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
          const T* vrow = tile + (group * kGroupKeys + 4 * c4 + u) * kHid;
#pragma unroll
          for (int m = 0; m < kNaPairs; ++m) {
            const int pr = cl + 64 * m;
            if (pr < kPairs) {
              const float2 v = Pair<T>::get(vrow + 2 * pr);
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
    float* red = reinterpret_cast<float*>(tiles);
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
    T* na_rows = na + ((size_t)b * seq + i0) * kHid;
    for (int x = threadIdx.x; x < nrows * kHid; x += kThreads) na_rows[x] = from_float<T>(red[x]);
  }
}

// Dynamic shared memory of one block; hid = 0 for the builds without na.
long long smem_bytes(int qd, int seq, int hid, int itemsize) {
  const long long head = (long long)kRows * qd + kRows * kPD + kWindow * kPD;
  if (hid == 0) return (long long)sizeof(float) * (head + (long long)kRows * seq);
  const long long ld = (seq + kNvKeys - 1) / kNvKeys * kNvKeys;
  const long long tiles = 2LL * kNvKeys * hid * itemsize;  // two nv tiles
  const long long fold = (long long)kRows * hid * sizeof(float);
  return (long long)sizeof(float) * (head + kRows * ld) + (tiles > fold ? tiles : fold);
}

template <typename T, int QD, bool kBlockMax, int kHid>
cudaError_t launch(const void* q, const void* k, const void* p, const void* pe,
                   const void* mask, void* out, float* block_max, const void* nv, void* na,
                   int B, int H, int seq, cudaStream_t stream) {
  const size_t smem = smem_bytes(QD, seq, kHid, sizeof(T));
  auto kernel = rel_pos_weights_kernel<T, QD, kBlockMax, kHid>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(p),
      static_cast<const T*>(pe), static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      block_max, static_cast<const T*>(nv), static_cast<T*>(na), H, seq);
  return cudaGetLastError();
}

template <typename T, bool kBlockMax, int kHid>
cudaError_t dispatch_qd(int qd, const void* q, const void* k, const void* p, const void* pe,
                        const void* mask, void* out, float* block_max, const void* nv,
                        void* na, int B, int H, int seq, cudaStream_t stream) {
  // 32: the ZipVoice models' query_head_dim; 8: the tests' small models
  switch (qd) {
    case 8:
      return launch<T, 8, kBlockMax, kHid>(q, k, p, pe, mask, out, block_max, nv, na, B, H,
                                           seq, stream);
    case 32:
      return launch<T, 32, kBlockMax, kHid>(q, k, p, pe, mask, out, block_max, nv, na, B, H,
                                            seq, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBlockMax, int kHid>
int dispatch(int dtype, int qd, const void* q, const void* k, const void* p, const void* pe,
             const void* mask, void* out, float* block_max, const void* nv, void* na, int B,
             int H, int seq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_qd<float, kBlockMax, kHid>(qd, q, k, p, pe, mask, out, block_max, nv, na,
                                                 B, H, seq, s);
    case 1:
      return dispatch_qd<__nv_bfloat16, kBlockMax, kHid>(qd, q, k, p, pe, mask, out, block_max,
                                                         nv, na, B, H, seq, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int zv_rel_pos_attention_weights(int dtype, int qd, const void* q, const void* k,
                                            const void* p, const void* pe, const void* mask,
                                            void* out, int B, int H, int seq, void* stream) {
  return dispatch<false, 0>(dtype, qd, q, k, p, pe, mask, out, nullptr, nullptr, nullptr, B, H,
                            seq, stream);
}

// The training build: as above, and block_max ((B * H, ceil(seq / kRows)) f32)
// receives each block's largest |pre-mask score|.
extern "C" int zv_rel_pos_attention_weights_train(int dtype, int qd, const void* q,
                                                  const void* k, const void* p, const void* pe,
                                                  const void* mask, void* out, void* block_max,
                                                  int B, int H, int seq, void* stream) {
  return dispatch<true, 0>(dtype, qd, q, k, p, pe, mask, out, static_cast<float*>(block_max),
                           nullptr, nullptr, B, H, seq, stream);
}

// The nonlin build: as zv_rel_pos_attention_weights, and na (B, seq, hid) receives
// head 0's rounded weights applied to nv (B, seq, hid).  hid is one of the
// NonlinAttention widths of the ZipVoice models (384 in the fm_decoder, 144 in the
// text encoder) or 48 (the tests' small layers).
extern "C" int zv_rel_pos_attention_weights_nonlin(int dtype, int qd, const void* q,
                                                   const void* k, const void* p,
                                                   const void* pe, const void* mask, void* out,
                                                   const void* nv, void* na, int hid, int B,
                                                   int H, int seq, void* stream) {
  switch (hid) {
#define ZV_CASE(HID)                                                                    \
  case HID:                                                                             \
    return dispatch<false, HID>(dtype, qd, q, k, p, pe, mask, out, nullptr, nv, na, B, H, \
                                seq, stream);
    ZV_CASE(48)
    ZV_CASE(144)
    ZV_CASE(384)
#undef ZV_CASE
    default: return cudaErrorInvalidValue;
  }
}

// Query rows per block: the width of block_max's second axis is ceil(seq / this).
extern "C" int zv_rel_pos_attention_rows_per_block() { return kRows; }

// Dynamic shared memory one block needs (hid = 0: the inference and training builds;
// else the nonlin build at that hid, itemsize the bytes of the dtype); the wrapper
// checks it against the card's limit before launching.
extern "C" long long zv_rel_pos_attention_smem_bytes(int qd, int seq, int hid, int itemsize) {
  return smem_bytes(qd, seq, hid, itemsize);
}
