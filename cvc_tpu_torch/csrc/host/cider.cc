// CIDEr-D scorer in C++ (native runtime component).
//
// The SCST reward calls CIDEr-D on every training batch (sample + greedy
// baseline), making the scorer a host-side hot path; the evaluator calls
// it over whole splits.  This implementation mirrors
// cvc_tpu_torch/evaluation/cider.py (the pure-Python oracle) exactly:
// TF-IDF-weighted n-gram (1..N) cosine similarity with candidate-count
// clipping and a Gaussian length penalty, document frequency computed
// over the reference sets.
//
// The port's copy of native/cider.cc, built by cvc_tpu_torch/native.py.
// Works on integer token ids (the Python binding tokenizes and interns);
// n-grams are hashed with a 64-bit FNV-1a over the id bytes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxN = 4;

struct Vec {
  // per n: ngram-hash -> tfidf weight
  std::unordered_map<uint64_t, double> w[kMaxN];
  double norm[kMaxN] = {0, 0, 0, 0};
  int64_t length = 0;  // unigram count
};

uint64_t fnv1a(const int32_t* ids, int n) {
  uint64_t h = 1469598103934665603ull;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(ids);
  for (size_t i = 0; i < sizeof(int32_t) * (size_t)n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  // mix in n so ("a","b") != ("a b") collisions across orders are avoided
  h ^= (uint64_t)n * 0x9e3779b97f4a7c15ull;
  return h;
}

void count_ngrams(const int32_t* ids, int len, int max_n,
                  std::unordered_map<uint64_t, int> out[kMaxN]) {
  for (int n = 1; n <= max_n; ++n)
    for (int i = 0; i + n <= len; ++i)
      out[n - 1][fnv1a(ids + i, n)] += 1;
}

}  // namespace

struct CvcCiderDf {
  std::unordered_map<uint64_t, double> df;
  double log_num_images = 0.0;
};

extern "C" {

// Build a corpus document-frequency table from reference sets (one set
// per image): the SCST reward precomputes this over the train corpus.
void* cvc_cider_df_build(const int32_t* ref_ids, const int64_t* ref_off,
                         const int64_t* ref_img_off, int32_t n_images,
                         int32_t max_n) {
  if (max_n > kMaxN) max_n = kMaxN;
  auto* h = new CvcCiderDf();
  for (int32_t i = 0; i < n_images; ++i) {
    std::unordered_map<uint64_t, char> seen;
    for (int64_t r = ref_img_off[i]; r < ref_img_off[i + 1]; ++r) {
      std::unordered_map<uint64_t, int> counts[kMaxN];
      count_ngrams(ref_ids + ref_off[r],
                   (int)(ref_off[r + 1] - ref_off[r]), max_n, counts);
      for (int n = 0; n < max_n; ++n)
        for (auto& kv : counts[n]) seen[kv.first] = 1;
    }
    for (auto& kv : seen) h->df[kv.first] += 1.0;
  }
  h->log_num_images = std::log((double)(n_images > 1 ? n_images : 1));
  return h;
}

void cvc_cider_df_free(void* handle) {
  delete reinterpret_cast<CvcCiderDf*>(handle);
}

// candidates: cand_ids[cand_off[i] .. cand_off[i+1]) for image i
// references: for image i, refs r in [ref_img_off[i], ref_img_off[i+1]):
//             ref_ids[ref_off[r] .. ref_off[r+1])
// df_handle: optional corpus DF from cvc_cider_df_build (NULL -> compute
//            the DF from the given references, toolkit default)
// out_scores: [n_images]
void cvc_cider_score(const int32_t* cand_ids, const int64_t* cand_off,
                     const int32_t* ref_ids, const int64_t* ref_off,
                     const int64_t* ref_img_off, int32_t n_images,
                     int32_t max_n, double sigma, const void* df_handle,
                     double* out_scores) {
  if (max_n > kMaxN) max_n = kMaxN;
  const int64_t n_refs_total = ref_img_off[n_images];

  // --- reference n-gram counts (+ DF unless precomputed) ---------------
  std::vector<std::unordered_map<uint64_t, int>> ref_counts(
      (size_t)n_refs_total * kMaxN);
  std::unordered_map<uint64_t, double> local_df;
  for (int32_t i = 0; i < n_images; ++i) {
    std::unordered_map<uint64_t, char> seen;
    for (int64_t r = ref_img_off[i]; r < ref_img_off[i + 1]; ++r) {
      auto* counts = &ref_counts[(size_t)r * kMaxN];
      count_ngrams(ref_ids + ref_off[r],
                   (int)(ref_off[r + 1] - ref_off[r]), max_n, counts);
      if (df_handle == nullptr)
        for (int n = 0; n < max_n; ++n)
          for (auto& kv : counts[n]) seen[kv.first] = 1;
    }
    if (df_handle == nullptr)
      for (auto& kv : seen) local_df[kv.first] += 1.0;
  }
  const auto* pre = reinterpret_cast<const CvcCiderDf*>(df_handle);
  const std::unordered_map<uint64_t, double>& df =
      pre ? pre->df : local_df;
  const double log_num_images =
      pre ? pre->log_num_images : std::log((double)n_images);

  auto vectorize = [&](const std::unordered_map<uint64_t, int>* counts,
                       Vec* v) {
    for (int n = 0; n < max_n; ++n) {
      for (auto& kv : counts[n]) {
        auto it = df.find(kv.first);
        const double d = it == df.end() ? 0.0 : it->second;
        const double idf = log_num_images - std::log(d > 1.0 ? d : 1.0);
        const double w = (double)kv.second * idf;
        v->w[n][kv.first] = w;
        v->norm[n] += w * w;
        if (n == 0) v->length += kv.second;
      }
      v->norm[n] = std::sqrt(v->norm[n]);
    }
  };

#pragma omp parallel for schedule(dynamic)
  for (int32_t i = 0; i < n_images; ++i) {
    std::unordered_map<uint64_t, int> ccounts[kMaxN];
    count_ngrams(cand_ids + cand_off[i],
                 (int)(cand_off[i + 1] - cand_off[i]), max_n, ccounts);
    Vec vh;
    vectorize(ccounts, &vh);
    double score[kMaxN] = {0, 0, 0, 0};
    const int64_t n_refs = ref_img_off[i + 1] - ref_img_off[i];
    for (int64_t r = ref_img_off[i]; r < ref_img_off[i + 1]; ++r) {
      Vec vr;
      vectorize(&ref_counts[(size_t)r * kMaxN], &vr);
      const double delta = (double)(vh.length - vr.length);
      const double pen = std::exp(-(delta * delta) / (2.0 * sigma * sigma));
      for (int n = 0; n < max_n; ++n) {
        double val = 0.0;
        for (auto& kv : vh.w[n]) {
          auto it = vr.w[n].find(kv.first);
          if (it != vr.w[n].end()) {
            const double wr = it->second;
            val += (kv.second < wr ? kv.second : wr) * wr;
          }
        }
        if (vh.norm[n] != 0.0 && vr.norm[n] != 0.0)
          val /= vh.norm[n] * vr.norm[n];
        score[n] += val * pen;
      }
    }
    double avg = 0.0;
    for (int n = 0; n < max_n; ++n) avg += score[n];
    avg = avg / max_n / (double)(n_refs > 0 ? n_refs : 1) * 10.0;
    out_scores[i] = avg;
  }
}

int32_t cvc_cider_version() { return 1; }

}  // extern "C"
