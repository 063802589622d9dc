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
// 64 us at 3.35 TB/s; the product's narrow N (12) leaves nothing for a tensor core
// to amortise.  So the design reads each weight once, with 16-byte loads, and keeps
// the rest on chip: a block owns kRowsPerBlock query rows of one (b, h) and stages
// that head's values (T x 12) in shared memory in f32, transposed to [VD][T] so that
// the 32 lanes of a warp, each taking kVec neighbouring keys, read them at most two
// ways conflicted (a thread stages one key's values with 8-byte loads).  A warp owns
// kWarpRows rows: each staged value it reads serves all of them.  The lanes' partial
// sums meet in a butterfly of shuffles.  A T that is no multiple of kVec (the rows
// are then not 16-byte aligned) takes a loop of scalar loads instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// dtype: 0 = float32, 1 = bfloat16; vd must be 12 (the ZipVoice models' value head
// dim).  Returns cudaGetLastError() after the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int zv_attention_apply(int dtype, int vd, const void* w, const void* v, void* out,
                                  int B, int H, int seq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vd != 12) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float, 12>(w, v, out, B * H, seq, s);
    case 1: return launch<__nv_bfloat16, 12>(w, v, out, B * H, seq, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one block needs; the wrapper checks it against the card's
// limit before launching.
extern "C" long long zv_attention_apply_smem_bytes(int vd, int seq) {
  return (long long)sizeof(float) * vd * staged_len(seq);
}
