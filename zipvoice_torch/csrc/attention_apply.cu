// Attention application for Hopper (sm_90a): SelfAttention's weights @ values.
//
// Replaces the TPU kernel zipvoice_tpu/ops/pallas_attention.py::_attn_apply_kernel
// (reached through attention_apply).  For every (b, h, query row i):
//
//   out[b, h, i, :] = sum_j w[b, h, i, j] * v[b, h, j, :],   VD = 12 values per head,
//
// summed in f32 and rounded once to v's dtype.
//
// What bounds it: bytes.  At the main path's shape (B=16 after CFG doubling, h=4,
// T=1280, bf16) it reads the 210 MB of weights against 1.3 G multiply-adds, about
// 64 us at 3.35 TB/s.  On the CUDA cores those multiply-adds alone take some 40 us
// at the f32 rate, plus a conversion per weight and a shared-memory read per four,
// so a CUDA-core loop is bound by issue slots before it reaches the bytes.
//
// The bf16 build (attn_apply_mma_kernel) therefore runs the product on the tensor
// cores: mma.sync m16n8k16, A = a 16-row x 16-key tile of weights, B = a 16-key x 8
// tile of values (two n-tiles cover VD = 12, padded to 16 with zero columns in
// shared memory), f32 sums in registers, so no butterfly is left.  A block owns
// kRowsM = 64 query rows of one (b, h), one warp per 16 rows; 64-key chunks of
// its weights (8 KB) and values (bf16, 2 KB) stream through a ring of kStagesM = 4
// shared-memory stages filled by cp.async three chunks ahead, so each SM keeps
// enough bytes in flight to cover HBM latency (40 KB a block, whatever T, five
// blocks an SM).  Fragments come from shared memory by ldmatrix (.trans for the
// values), on tiles whose 16-byte chunks are XOR-swizzled so that the eight rows
// one ldmatrix phase reads fall in distinct banks.  Each head's values are read
// T/64 times (from L2) instead of T/32 times.  Products of two bf16 values are exact
// in f32; each chunk's sums start from zero on the tensor cores and join the row's
// total by an f32 add, because the tensor cores' accumulation does not round to
// nearest and, carried over all T keys, drifted past a bf16 rounding on an H100
// where a row's sum nearly cancels (T=2560).  So the sums differ from the plain
// version's by their order, as the CUDA-core build's do.  A T that
// is no multiple of 8 (the weight rows are then not 16-byte aligned) stages the
// weights with scalar loads instead of cp.async.
//
// The f32 build (attn_apply_kernel) stays on the CUDA cores, where TF32 would cost
// precision: a block owns kRowsPerBlock query rows of one (b, h) and stages that
// head's values (T x 12) in shared memory in f32, transposed to [VD][T] so that
// the 32 lanes of a warp, each taking kVec neighbouring keys, read them at most two
// ways conflicted (a thread stages one key's values with 8-byte loads).  A warp owns
// kWarpRows rows: each staged value it reads serves all of them.  The lanes' partial
// sums meet in a butterfly of shuffles.  A T that is no multiple of kVec (the rows
// are then not 16-byte aligned) takes a loop of scalar loads instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---- the bf16 build: tensor cores ------------------------------------------

constexpr int kWarpsM = 4;
constexpr int kThreadsM = kWarpsM * 32;
constexpr int kRowsM = kWarpsM * 16;    // query rows per block
constexpr int kKeysM = 64;              // keys per chunk
constexpr int kStagesM = 4;             // ring depth
constexpr int kVdPad = 16;              // values per key as staged (12 + 4 zeros)
constexpr int kWTileBytes = kRowsM * kKeysM * 2;   // [64 rows][64 keys] bf16
constexpr int kVTileBytes = kKeysM * kVdPad * 2;   // [64 keys][16] bf16
constexpr int kStageBytesM = kWTileBytes + kVTileBytes;
constexpr int kSmemM = kStagesM * kStageBytesM;

// Byte offset of (row, 16-byte chunk) in a weight tile of 128-byte rows: the chunk
// is XORed with row % 8, so eight consecutive rows at one chunk hit eight banks.
__device__ __forceinline__ int w_off(int row, int chunk) {
  return row * (kKeysM * 2) + ((chunk ^ (row & 7)) << 4);
}
// Byte offset of (key, half) in a value tile of 32-byte rows (half 0: values 0-7,
// half 1: 8-15); the half is XORed with bit 2 of the key for the same reason.
__device__ __forceinline__ int v_off(int key, int half) {
  return key * (kVdPad * 2) + ((half ^ ((key >> 2) & 1)) << 4);
}

// grid = (ceil(T / kRowsM), B * H); block = kThreadsM; dynamic smem = kSmemM.
// w: (B, H, T, T); v: (B, H, T, 12); out: (B, H, T, 12), bf16, contiguous.
__global__ void __launch_bounds__(kThreadsM)
attn_apply_mma_kernel(const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int seq) {
  constexpr int VD = 12;
  extern __shared__ __align__(128) unsigned char smem_m[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * kRowsM;
  const bool aligned = seq % 8 == 0;  // weight rows 16-byte aligned
  const __nv_bfloat16* wb = w + (size_t)bh * seq * seq;
  const __nv_bfloat16* vb = v + (size_t)bh * seq * VD;
  const int nchunks = (seq + kKeysM - 1) / kKeysM;

  // the pad values 12-15 of every staged key are zero, in every stage, for good
  for (int x = tid; x < kStagesM * kKeysM; x += kThreadsM) {
    const int key = x % kKeysM;
    unsigned char* tile = smem_m + (x / kKeysM) * kStageBytesM + kWTileBytes;
    *reinterpret_cast<uint2*>(tile + v_off(key, 1) + 8) = make_uint2(0u, 0u);
  }

  auto load = [&](int c) {
    unsigned char* st = smem_m + (c % kStagesM) * kStageBytesM;
    const int j0 = c * kKeysM;
    if (aligned) {
      for (int x = tid; x < kRowsM * (kKeysM / 8); x += kThreadsM) {
        const int r = x >> 3, ch = x & 7;
        const int i = i0 + r, j = j0 + 8 * ch;
        const bool ok = i < seq && j < seq;
        zv::cp_async16(zv::smem_addr(st + w_off(r, ch)),
                       wb + (ok ? (size_t)i * seq + j : 0), ok);
      }
    } else {
      for (int x = tid; x < kRowsM * kKeysM; x += kThreadsM) {
        const int r = x / kKeysM, u = x % kKeysM;
        const int i = i0 + r, j = j0 + u;
        const __nv_bfloat16 e =
            i < seq && j < seq ? wb[(size_t)i * seq + j] : __float2bfloat16(0.f);
        *reinterpret_cast<__nv_bfloat16*>(st + w_off(r, u >> 3) + 2 * (u & 7)) = e;
      }
    }
    // values: three 8-byte pieces (4 values each) a key
    unsigned char* vt = st + kWTileBytes;
    for (int x = tid; x < kKeysM * 3; x += kThreadsM) {
      const int key = x / 3, u = x % 3;
      const int j = j0 + key;
      const bool ok = j < seq;
      zv::cp_async8(zv::smem_addr(vt + v_off(key, u >> 1) + 8 * (u & 1)),
                    vb + (ok ? (size_t)j * VD + 4 * u : 0), ok);
    }
  };

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int s = 0; s < kStagesM - 1; ++s) {
    if (s < nchunks) load(s);
    zv::cp_async_commit();
  }
  const int arow = warp * 16 + (lane & 15);          // A: this lane's ldmatrix row
  const int akey = (lane & 7) + 8 * ((lane >> 3) & 1);  // B: this lane's ldmatrix key
  for (int c = 0; c < nchunks; ++c) {
    zv::cp_async_wait<kStagesM - 2>();
    __syncthreads();  // chunk c has landed for all; everyone is done with chunk c - 1
    if (c + kStagesM - 1 < nchunks) load(c + kStagesM - 1);
    zv::cp_async_commit();
    const unsigned char* st = smem_m + (c % kStagesM) * kStageBytesM;
    const unsigned wt = zv::smem_addr(st);
    const unsigned vt = zv::smem_addr(st + kWTileBytes);
    // the chunk's sums on the tensor cores, from zero, then one f32 add each: the
    // tensor cores' own accumulation does not round to nearest, which over a whole
    // row of keys drifts past a bf16 rounding where the sum nearly cancels
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kKeysM / 16; ++ks) {
      unsigned a0, a1, a2, a3, b0, b1, b2, b3;
      zv::ldmatrix_x4(wt + w_off(arow, 2 * ks + (lane >> 4)), a0, a1, a2, a3);
      zv::ldmatrix_x4_trans(vt + v_off(16 * ks + akey, lane >> 4), b0, b1, b2, b3);
      zv::mma_bf16(part[0], a0, a1, a2, a3, b0, b1);
      zv::mma_bf16(part[1], a0, a1, a2, a3, b2, b3);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
  zv::cp_async_wait<0>();

  // acc[n] holds rows g, g+8 of this warp and values 8 n + 2a, 8 n + 2a + 1
  const int g = lane >> 2, a = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + warp * 16 + g + 8 * half;
    if (i >= seq) continue;
    unsigned* orow = reinterpret_cast<unsigned*>(out + ((size_t)bh * seq + i) * VD);
    orow[a] = zv::pack_bf16(acc[0][2 * half], acc[0][2 * half + 1]);
    if (a < 2) orow[4 + a] = zv::pack_bf16(acc[1][2 * half], acc[1][2 * half + 1]);
  }
}

cudaError_t launch_mma(const void* w, const void* v, void* out, int BH, int seq,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_apply_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemM);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRowsM - 1) / kRowsM, BH);
  attn_apply_mma_kernel<<<grid, kThreadsM, kSmemM, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), seq);
  return cudaGetLastError();
}

// ---- the f32 build: CUDA cores -----------------------------------------------


constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 4;
constexpr int kRowsPerBlock = kWarps * kWarpRows;  // 32

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Staged values' row length: a multiple of 4 floats, so each [VD] row is 16-byte aligned.
__host__ __device__ __forceinline__ int staged_len(int seq) { return (seq + 3) / 4 * 4; }

// grid = (ceil(T / kRowsPerBlock), B * H); block = kThreads.
// w: (B, H, T, T); v: (B, H, T, VD); out: (B, H, T, VD).  All contiguous.
template <typename T, int VD>
__global__ void __launch_bounds__(kThreads)
attn_apply_kernel(const T* __restrict__ w, const T* __restrict__ v, T* __restrict__ out,
                  int seq) {
  constexpr int kVec = 16 / sizeof(T);  // keys per 16-byte load
  extern __shared__ __align__(16) float v_s[];  // [VD][staged_len(seq)]
  const int ld = staged_len(seq);
  const int bh = blockIdx.y;
  const T* vb = v + (size_t)bh * seq * VD;
  // one key's VD values a thread, in 8-byte loads; neighbouring threads write
  // neighbouring keys, so the transposing stores meet no bank conflicts
  static_assert((VD * sizeof(T)) % 8 == 0, "a value row must be whole 8-byte words");
  constexpr int kWords = VD * sizeof(T) / 8;
  for (int j = threadIdx.x; j < seq; j += kThreads) {
    uint2 raw[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u)
      raw[u] = __ldg(reinterpret_cast<const uint2*>(vb + (size_t)j * VD) + u);
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int d = 0; d < VD; ++d) v_s[d * ld + j] = to_float(e[d]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * kRowsPerBlock + warp * kWarpRows;
  if (i0 >= seq) return;
  const T* wrows[kWarpRows];
  bool live[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    live[r] = i0 + r < seq;
    wrows[r] = w + ((size_t)bh * seq + (live[r] ? i0 + r : i0)) * seq;
  }
  float acc[kWarpRows][VD];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
    for (int d = 0; d < VD; ++d) acc[r][d] = 0.f;

  if (seq % kVec == 0) {
    for (int j0 = lane * kVec; j0 < seq; j0 += 32 * kVec) {
      float wv[kWarpRows][kVec];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const uint4 raw = live[r] ? __ldg(reinterpret_cast<const uint4*>(wrows[r] + j0))
                                  : make_uint4(0u, 0u, 0u, 0u);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < kVec; ++u) wv[r][u] = to_float(e[u]);
      }
#pragma unroll
      for (int d = 0; d < VD; ++d) {
#pragma unroll
        for (int u4 = 0; u4 < kVec / 4; ++u4) {
          const float4 vv = *reinterpret_cast<const float4*>(v_s + d * ld + j0 + 4 * u4);
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            acc[r][d] = fmaf(wv[r][4 * u4 + 0], vv.x, acc[r][d]);
            acc[r][d] = fmaf(wv[r][4 * u4 + 1], vv.y, acc[r][d]);
            acc[r][d] = fmaf(wv[r][4 * u4 + 2], vv.z, acc[r][d]);
            acc[r][d] = fmaf(wv[r][4 * u4 + 3], vv.w, acc[r][d]);
          }
        }
      }
    }
  } else {
    for (int j = lane; j < seq; j += 32) {
      float wv[kWarpRows];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) wv[r] = live[r] ? to_float(wrows[r][j]) : 0.f;
#pragma unroll
      for (int d = 0; d < VD; ++d) {
        const float vv = v_s[d * ld + j];
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) acc[r][d] = fmaf(wv[r], vv, acc[r][d]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
    for (int d = 0; d < VD; ++d) acc[r][d] = warp_sum(acc[r][d]);
  if (lane == 0) {
    T* orow = out + ((size_t)bh * seq + i0) * VD;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
      if (live[r])
#pragma unroll
        for (int d = 0; d < VD; ++d) orow[r * VD + d] = from_float<T>(acc[r][d]);
  }
}

template <typename T, int VD>
cudaError_t launch(const void* w, const void* v, void* out, int BH, int seq,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)VD * staged_len(seq);
  auto kernel = attn_apply_kernel<T, VD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kRowsPerBlock - 1) / kRowsPerBlock, BH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(w), static_cast<const T*>(v),
                                           static_cast<T*>(out), seq);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core build), 1 = bfloat16 (the tensor-core build);
// vd must be 12 (the ZipVoice models' value head dim).  Returns cudaGetLastError()
// after the launch (0 on success); launches on `stream` and does not synchronise.
extern "C" int zv_attention_apply(int dtype, int vd, const void* w, const void* v, void* out,
                                  int B, int H, int seq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vd != 12) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float, 12>(w, v, out, B * H, seq, s);
    case 1: return launch_mma(w, v, out, B * H, seq, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one block of the given dtype's build needs; the wrapper
// checks it against the card's limit before launching.
extern "C" long long zv_attention_apply_smem_bytes(int dtype, int vd, int seq) {
  if (dtype == 1) return kSmemM;
  return (long long)sizeof(float) * vd * staged_len(seq);
}
