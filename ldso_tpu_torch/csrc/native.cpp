// Native host-side runtime for ldso_tpu.
//
// The reference implements its host runtime in C++ (DBoW3 vocabulary +
// inverted-index database, feature bookkeeping; SURVEY.md §2.2). The TPU
// build keeps device compute in XLA/Pallas and implements the
// latency-sensitive host paths here:
//   * bag-of-words vocabulary transform (tree descent with popcount)
//   * inverted-index keyframe database with L1 scoring and exclusion query
//     (DBoW3::Database / LoopClosing::DetectLoop semantics)
//   * greedy radius non-max suppression for corner selection
//     (FeatureDetector.cc:97-118's O(n^2) loop)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <map>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// popcount helpers
// ---------------------------------------------------------------------------
static inline int hamming256(const uint32_t* a, const uint32_t* b) {
    int d = 0;
    for (int i = 0; i < 8; i++) d += __builtin_popcount(a[i] ^ b[i]);
    return d;
}

// ---------------------------------------------------------------------------
// vocabulary transform: descend a k-ary tree by Hamming argmin
// node_desc: (M, 8) uint32; children: (M, k) int32 (-1 pad);
// word_id: (M,) int32. out: (n,) int32 word ids.
// ---------------------------------------------------------------------------
void bow_transform(const uint32_t* desc, int n,
                   const uint32_t* node_desc, const int32_t* children,
                   int M, int k, int L, const int32_t* word_id,
                   int32_t* out_words) {
    (void)M;
    for (int i = 0; i < n; i++) {
        const uint32_t* d = desc + 8 * i;
        int cur = 0;
        for (int lvl = 0; lvl <= L; lvl++) {
            const int32_t* kids = children + (size_t)cur * k;
            int best = -1, best_d = 1 << 30;
            for (int c = 0; c < k; c++) {
                int node = kids[c];
                if (node < 0) continue;
                int dist = hamming256(d, node_desc + 8 * (size_t)node);
                if (dist < best_d) { best_d = dist; best = node; }
            }
            if (best < 0) break;   // reached a leaf
            cur = best;
        }
        out_words[i] = word_id[cur];
    }
}

// ---------------------------------------------------------------------------
// brute-force Hamming matching with NN-ratio test
// (FeatureMatcher::DescriptorDistance + matching loops)
// ---------------------------------------------------------------------------
void hamming_match(const uint32_t* da, int na, const uint32_t* db, int nb,
                   float nn_ratio, int th_low, int32_t* out_match,
                   int32_t* out_dist) {
    for (int i = 0; i < na; i++) {
        int best = -1, d1 = 1 << 30, d2 = 1 << 30;
        const uint32_t* a = da + 8 * i;
        for (int j = 0; j < nb; j++) {
            int d = hamming256(a, db + 8 * j);
            if (d < d1) { d2 = d1; d1 = d; best = j; }
            else if (d < d2) { d2 = d; }
        }
        out_dist[i] = d1;
        out_match[i] = (d1 < th_low && (float)d1 < nn_ratio * (float)d2)
                           ? best : -1;
    }
}

// ---------------------------------------------------------------------------
// BoW-feature-vector-bucketed matching (FeatureMatcher::SearchByBoW,
// FeatureMatcher.cc:66-124): features are matched only within the same
// vocabulary-tree node (the DBoW3 FeatureVector bucket), with the NN-ratio
// test applied per bucket. nodes == -1 features never match.
// ---------------------------------------------------------------------------
void bow_bucketed_match(const uint32_t* da, const int32_t* nodes_a, int na,
                        const uint32_t* db, const int32_t* nodes_b, int nb,
                        float nn_ratio, int th_low,
                        int32_t* out_match, int32_t* out_dist) {
    std::unordered_map<int32_t, std::vector<int>> buckets;
    buckets.reserve(nb);
    for (int j = 0; j < nb; j++)
        if (nodes_b[j] >= 0) buckets[nodes_b[j]].push_back(j);
    for (int i = 0; i < na; i++) {
        out_match[i] = -1;
        out_dist[i] = 1 << 30;
        if (nodes_a[i] < 0) continue;
        auto it = buckets.find(nodes_a[i]);
        if (it == buckets.end()) continue;
        int best = -1, d1 = 1 << 30, d2 = 1 << 30;
        const uint32_t* a = da + 8 * i;
        for (int j : it->second) {
            int d = hamming256(a, db + 8 * j);
            if (d < d1) { d2 = d1; d1 = d; best = j; }
            else if (d < d2) { d2 = d; }
        }
        out_dist[i] = d1;
        if (d1 <= th_low && (float)d1 < nn_ratio * (float)d2)
            out_match[i] = best;
    }
}

// ---------------------------------------------------------------------------
// inverted-index database (handle-based)
// ---------------------------------------------------------------------------
struct BowDatabase {
    // word -> list of (kf, weight)
    std::unordered_map<int32_t, std::vector<std::pair<int32_t, float>>> inverted;
    std::unordered_map<int32_t, float> norm;  // kf -> L1 norm (==1 normalized)
};

void* db_create() { return new BowDatabase(); }
void db_destroy(void* h) { delete (BowDatabase*)h; }

void db_add(void* h, int32_t kf_id, const int32_t* words,
            const float* weights, int n) {
    auto* db = (BowDatabase*)h;
    float norm = 0.f;
    for (int i = 0; i < n; i++) {
        db->inverted[words[i]].push_back({kf_id, weights[i]});
        norm += std::fabs(weights[i]);
    }
    db->norm[kf_id] = norm > 0 ? norm : 1.f;
}

// L1 score: s = 0.5 * sum_w (|a| + |b| - |a - b|)  over shared words,
// with both vectors L1-normalized (DBoW3 ScoringObject L1_NORM).
int db_query(void* h, const int32_t* words, const float* weights, int n,
             const int32_t* exclude, int n_exclude,
             int32_t* out_ids, float* out_scores, int max_results) {
    auto* db = (BowDatabase*)h;
    float qnorm = 0.f;
    for (int i = 0; i < n; i++) qnorm += std::fabs(weights[i]);
    if (qnorm <= 0) qnorm = 1.f;

    std::unordered_map<int32_t, float> acc;
    for (int i = 0; i < n; i++) {
        auto it = db->inverted.find(words[i]);
        if (it == db->inverted.end()) continue;
        float a = std::fabs(weights[i]) / qnorm;
        for (auto& e : it->second) {
            float b = std::fabs(e.second) / db->norm[e.first];
            acc[e.first] += a + b - std::fabs(a - b);
        }
    }
    for (int i = 0; i < n_exclude; i++) acc.erase(exclude[i]);

    std::vector<std::pair<float, int32_t>> scored;
    scored.reserve(acc.size());
    for (auto& kv : acc) scored.push_back({0.5f * kv.second, kv.first});
    std::sort(scored.begin(), scored.end(),
              [](auto& p, auto& q) { return p.first > q.first; });
    int m = std::min((int)scored.size(), max_results);
    for (int i = 0; i < m; i++) {
        out_ids[i] = scored[i].second;
        out_scores[i] = scored[i].first;
    }
    return m;
}

// ---------------------------------------------------------------------------
// greedy radius NMS: keep the highest-scoring point in each radius
// neighbourhood; processes in descending score order.
// ---------------------------------------------------------------------------
void radius_nms(const float* u, const float* v, const float* score, int n,
                float radius, uint8_t* keep) {
    std::vector<int> order(n);
    for (int i = 0; i < n; i++) order[i] = i;
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return score[a] > score[b]; });
    std::memset(keep, 0, n);
    const float r2 = radius * radius;
    // simple spatial hash for O(n) expected
    const float cell = radius;
    std::unordered_map<int64_t, std::vector<int>> grid;
    auto key = [&](float x, float y) {
        return ((int64_t)(int32_t)std::floor(x / cell) << 32)
               ^ (uint32_t)(int32_t)std::floor(y / cell);
    };
    for (int oi = 0; oi < n; oi++) {
        int i = order[oi];
        bool ok = true;
        int cx = (int)std::floor(u[i] / cell);
        int cy = (int)std::floor(v[i] / cell);
        for (int dx = -1; dx <= 1 && ok; dx++)
            for (int dy = -1; dy <= 1 && ok; dy++) {
                int64_t kk = ((int64_t)(int32_t)(cx + dx) << 32)
                             ^ (uint32_t)(int32_t)(cy + dy);
                auto it = grid.find(kk);
                if (it == grid.end()) continue;
                for (int j : it->second) {
                    float du = u[i] - u[j], dv = v[i] - v[j];
                    if (du * du + dv * dv < r2) { ok = false; break; }
                }
            }
        if (ok) {
            keep[i] = 1;
            grid[key(u[i], v[i])].push_back(i);
        }
    }
}

}  // extern "C"
