// Native batch packer for the host input pipeline.
//
// The reference leans on torch DataLoader worker *processes* for host-side
// batch assembly (SURVEY.md L2); our equivalent runtime component is this
// small C++ library: it pads variable-length region features into the
// static [B, F*N, ...] device layout (features, box geometry with area,
// classes, mask) in one OpenMP-parallel pass, reading each example's
// arrays in place via pointer tables (no staging copies on the Python
// side).
//
// The port's copy of native/pack.cc: built by cvc_tpu_torch/native.py
// with g++ into cvc_tpu_torch/_build/ and loaded via ctypes.  Pure C ABI;
// no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Pack one batch from per-example pointers.
//  feats_ptrs[b] : [frames[b] * regions[b], feat_dim] floats
//  boxes_ptrs[b] : [frames[b] * regions[b], 4] floats
//  cls_ptrs[b]   : [frames[b] * regions[b]] int32
// Outputs (pre-allocated):
//  out_feats [batch, num_frames*num_regions, feat_dim]
//  out_geom  [batch, num_frames*num_regions, 5]   (x1,y1,x2,y2,area)
//  out_cls   [batch, num_frames*num_regions]
//  out_mask  [batch, num_frames*num_regions]
void cvc_pack_batch(const float** feats_ptrs, const float** boxes_ptrs,
                    const int32_t** cls_ptrs,
                    const int32_t* frames, const int32_t* regions,
                    int32_t batch, int32_t num_frames, int32_t num_regions,
                    int32_t feat_dim, float* out_feats, float* out_geom,
                    int32_t* out_cls, float* out_mask) {
  const int64_t S = (int64_t)num_frames * num_regions;
#pragma omp parallel for schedule(dynamic)
  for (int32_t b = 0; b < batch; ++b) {
    const int32_t F = std::min(frames[b], num_frames);
    const int32_t Nin = regions[b];
    const float* src_f = feats_ptrs[b];
    const float* src_b = boxes_ptrs[b];
    const int32_t* src_c = cls_ptrs[b];
    float* bf = out_feats + (int64_t)b * S * feat_dim;
    float* bg = out_geom + (int64_t)b * S * 5;
    int32_t* bc = out_cls + (int64_t)b * S;
    float* bm = out_mask + (int64_t)b * S;
    std::memset(bg, 0, sizeof(float) * S * 5);
    std::memset(bc, 0, sizeof(int32_t) * S);
    std::memset(bm, 0, sizeof(float) * S);
    const int32_t n = std::min(Nin, num_regions);
    for (int32_t f = 0; f < F; ++f) {
      const int64_t src_row = (int64_t)f * Nin;
      const int64_t dst_slot = (int64_t)f * num_regions;
      std::memcpy(bf + dst_slot * feat_dim, src_f + src_row * feat_dim,
                  sizeof(float) * n * feat_dim);
      if (n < num_regions)  // zero the padded tail slots of this frame
        std::memset(bf + (dst_slot + n) * feat_dim, 0,
                    sizeof(float) * (num_regions - n) * feat_dim);
      for (int32_t r = 0; r < n; ++r) {
        const float* box = src_b + (src_row + r) * 4;
        float* g = bg + (dst_slot + r) * 5;
        const float x1 = box[0], y1 = box[1], x2 = box[2], y2 = box[3];
        g[0] = x1; g[1] = y1; g[2] = x2; g[3] = y2;
        const float w = x2 > x1 ? x2 - x1 : 0.0f;
        const float h = y2 > y1 ? y2 - y1 : 0.0f;
        g[4] = w * h;
        bc[dst_slot + r] = src_c[src_row + r];
        bm[dst_slot + r] = 1.0f;
      }
    }
    if (F < num_frames)  // zero remaining frames' feature slots
      std::memset(bf + (int64_t)F * num_regions * feat_dim, 0,
                  sizeof(float) * (int64_t)(num_frames - F) * num_regions
                      * feat_dim);
  }
}

// Pack many captions' precomputed word ids into fixed buffers.
//  ids_ptrs[b] : [lengths[b]] int32
//  out_tokens [batch, max_tokens], out_mask [batch, max_tokens]
void cvc_pack_tokens(const int32_t** ids_ptrs, const int32_t* lengths,
                     int32_t batch, int32_t seq_length, int32_t max_tokens,
                     int32_t bos, int32_t eos, int32_t pad,
                     int32_t* out_tokens, float* out_mask) {
#pragma omp parallel for schedule(static)
  for (int32_t b = 0; b < batch; ++b) {
    const int32_t n = std::min(lengths[b], seq_length);
    const int32_t* src = ids_ptrs[b];
    int32_t* t = out_tokens + (int64_t)b * max_tokens;
    float* m = out_mask + (int64_t)b * max_tokens;
    for (int32_t j = 0; j < max_tokens; ++j) { t[j] = pad; m[j] = 0.0f; }
    t[0] = bos;
    for (int32_t j = 0; j < n; ++j) t[1 + j] = src[j];
    t[1 + n] = eos;
    for (int32_t j = 1; j <= 1 + n; ++j) m[j] = 1.0f;
  }
}

int32_t cvc_pack_version() { return 2; }

}  // extern "C"
