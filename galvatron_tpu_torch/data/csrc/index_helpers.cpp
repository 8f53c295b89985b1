// Native sample-index helper for the indexed GPT dataset.
//
// TPU-era equivalent of the reference's vendored Megatron dataset helper
// (site_package/megatron/core/datasets/helpers.cpp: build_sample_idx), which
// the reference compiles at runtime (core/runtime/dataloader.py:12-20). Same
// contract: walk the (epoch-repeated, shuffled) document order and emit, for
// every training sample, the (document-index position, within-document offset)
// where the sample's seq_len+1 token window starts. The walk is O(tokens) and
// dominates dataset startup for billion-token corpora — the reason both the
// reference and this build keep it native.
//
// The port's own copy of galvatron_tpu/data/csrc/index_helpers.cpp.
// galvatron_tpu_torch/data/dataset.py builds it with `g++ -O3 -shared -fPIC`
// at first use into build/galvatron_tpu_torch/ (keyed by a hash of this file)
// and loads it with ctypes; a failed build raises. The numpy versions in
// dataset.py are the plain versions the tests hold this one against.

#include <cstdint>

extern "C" {

// doc_lens:  token count per document id                      [n_docs]
// doc_idx:   document ids in epoch-shuffled traversal order   [n_doc_idx]
// sample_idx: out, (n_samples+1) rows of (doc_idx_pos, offset) [2*(n_samples+1)]
// Returns the number of samples actually emitted (<= n_samples).
int64_t build_sample_idx(const int32_t* doc_lens,
                         const int32_t* doc_idx,
                         int64_t n_doc_idx,
                         int64_t seq_len,
                         int64_t n_samples,
                         int64_t* sample_idx) {
    int64_t sample = 0;
    int64_t pos = 0;      // position in doc_idx
    int64_t offset = 0;   // token offset within doc_idx[pos]
    sample_idx[0] = pos;
    sample_idx[1] = offset;
    while (sample < n_samples && pos < n_doc_idx) {
        // advance seq_len tokens (sample windows overlap by 1 token: the
        // language-model target shift, matching Megatron's sample walk)
        int64_t remaining = seq_len;
        while (remaining > 0 && pos < n_doc_idx) {
            int64_t doc_left = (int64_t)doc_lens[doc_idx[pos]] - offset;
            if (doc_left > remaining) {
                offset += remaining;
                remaining = 0;
            } else {
                remaining -= doc_left;
                ++pos;
                offset = 0;
            }
        }
        if (remaining > 0) break;  // ran out of tokens
        ++sample;
        sample_idx[2 * sample] = pos;
        sample_idx[2 * sample + 1] = offset;
    }
    return sample;
}

// Greedy corpus-blend schedule (reference helpers.cpp
// build_blending_indices, which Megatron's blended datasets consume):
// sample i draws from the dataset whose running count lags its normalised
// weight most, so every stream prefix tracks the requested proportions.
//
// weights:    normalised blend weights                [n_datasets]
// ds_index:   out, dataset id per sample              [n_samples]
// ds_sample:  out, within-dataset sample id           [n_samples]
void build_blending_indices(const double* weights,
                            int64_t n_datasets,
                            int64_t n_samples,
                            int32_t* ds_index,
                            int64_t* ds_sample) {
    int64_t* counts = new int64_t[n_datasets]();
    for (int64_t i = 0; i < n_samples; ++i) {
        int64_t best = 0;
        double best_err = 0.0;
        for (int64_t j = 0; j < n_datasets; ++j) {
            // key = (count+1)/w — the per-step common 1/(i+1) factor is
            // dropped so the numpy fallback (a lexsort merge of the same
            // per-dataset key sequences) computes bit-identical doubles
            double err = (double)(counts[j] + 1) / weights[j];
            if (j == 0 || err < best_err) {
                best = j;
                best_err = err;
            }
        }
        ds_index[i] = (int32_t)best;
        ds_sample[i] = counts[best];
        ++counts[best];
    }
    delete[] counts;
}

}  // extern "C"
