// Device code shared by the fused NeRF forward (fused_nerf.cu, K1), the
// recompute backward (fused_nerf_train.cu, K2), the fused ray render
// (fused_ray_render.cu, K3) and the ablations (fused_nerf_ablation.cu, P2):
// the packed-model descriptor and the TPU kernels' sin/cos
// (fourier_feature_nets_tpu/ops/fused_nerf.py::_fast_sincos), so that every
// kernel's encode, K2's recomputed forward among them, rounds where K1's
// does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ffn {

constexpr int kMaxLayers = 16;
constexpr int kMaxChannels = 256;
constexpr int kHeadWidth = 16;  // heads padded to the MMA tile width

// The packed model, read from the int64 meta array of the Python pack:
// num_layers, channels, P, V, e_pos, e_view, include_inputs, skip_mask,
// then num_layers + 4 weight offsets (elements) and as many bias offsets.
// Layer order: body 0..L-1, opacity head, bottleneck, hidden, color head.
struct Desc {
  int num_layers;
  int channels;
  int pos_width;    // P: [cos E | sin E | raw 3 | zero pad] rounded to 16
  int view_width;   // V: the same for the view encode
  int e_pos;
  int e_view;
  int include_inputs;
  unsigned skip_mask;
  long long w_off[kMaxLayers + 4];
  long long b_off[kMaxLayers + 4];
};

// Fills `d` from `meta`; false if the kernels cannot take the model.
inline bool parse_desc(const long long* m, Desc* d) {
  d->num_layers = static_cast<int>(m[0]);
  d->channels = static_cast<int>(m[1]);
  d->pos_width = static_cast<int>(m[2]);
  d->view_width = static_cast<int>(m[3]);
  d->e_pos = static_cast<int>(m[4]);
  d->e_view = static_cast<int>(m[5]);
  d->include_inputs = static_cast<int>(m[6]);
  d->skip_mask = static_cast<unsigned>(m[7]);
  if (d->num_layers < 1 || d->num_layers > kMaxLayers
      || d->channels % 32 != 0 || d->channels > kMaxChannels
      || d->pos_width % 16 != 0 || d->view_width % 16 != 0
      || (d->skip_mask & 1u)) {
    return false;
  }
  const int num_packed = d->num_layers + 4;
  for (int i = 0; i < num_packed; ++i) {
    d->w_off[i] = m[8 + i];
    d->b_off[i] = m[8 + num_packed + i];
  }
  return true;
}

// Same reduction and polynomial as ops/fused_nerf.py::_fast_sincos.
__device__ __forceinline__ void fast_sincos(float x, float* s, float* c) {
  const float two_pi = 6.283185307179586f;
  float f = x * 0.15915494309189535f;
  f = f - rintf(f);
  const float t = f * two_pi;
  const float t2 = t * t;
  *c = 1.0f + t2 * (-0.5f + t2 * (4.1666666666666664e-2f + t2 * (
      -1.3888888888888889e-3f + t2 * (2.4801587301587302e-5f + t2 * (
          -2.7557319223985893e-7f + t2 * (2.08767569878681e-9f
                                          - t2 * 1.1470745597729725e-11f))))));
  *s = t * (1.0f + t2 * (-1.6666666666666666e-1f + t2 * (
      8.3333333333333332e-3f + t2 * (-1.9841269841269841e-4f + t2 * (
          2.7557319223985893e-6f + t2 * (-2.5052108385441720e-8f
                                         + t2 * 1.6059043836821613e-10f))))));
}

}  // namespace ffn
