// Native host runtime kernels for the SoA map.
//
// The reference implements its entire runtime in C++ (SURVEY.md §2); in this
// engine the device compute path is PyTorch and CUDA, and the host-side
// bookkeeping hot paths live here: covisibility voting over the
// keyframe->point table (one keyframe's row, or the whole [K, K] matrix for
// the essential graph) and medoid-descriptor selection over observation
// groups (the per-point pairwise-Hamming loops that are slow as interpreted
// code). Copied from orbslam2_tpu/native/mapops.cpp; exposed via a plain C
// ABI and loaded with ctypes (native/__init__.py).
//
// Build (done on first use by _build.py, into build/ at the repo root):
//   g++ -O3 -march=native -shared -fPIC mapops.cpp -o libmapops.so

#include <cstdint>
#include <cstring>

extern "C" {

// Shared-point counts between keyframe `k` and every other keyframe.
// kf_pt: [K, N] int32 (point index per feature, -1 = none)
// kf_valid: [K] uint8; out: [K] int64
// scratch_seen: [P] uint8 caller-provided zeroed buffer (reset on exit).
void covis_weights(const int32_t* kf_pt, const uint8_t* kf_valid,
                   int64_t K, int64_t N, int64_t P, int64_t k,
                   uint8_t* scratch_seen, int64_t* out) {
    const int32_t* row = kf_pt + k * N;
    for (int64_t i = 0; i < N; ++i) {
        int32_t p = row[i];
        if (p >= 0 && p < P) scratch_seen[p] = 1;
    }
    for (int64_t j = 0; j < K; ++j) {
        int64_t w = 0;
        if (kf_valid[j] && j != k) {
            const int32_t* r = kf_pt + j * N;
            for (int64_t i = 0; i < N; ++i) {
                int32_t p = r[i];
                if (p >= 0 && p < P && scratch_seen[p]) ++w;
            }
        }
        out[j] = w;
    }
    for (int64_t i = 0; i < N; ++i) {
        int32_t p = row[i];
        if (p >= 0 && p < P) scratch_seen[p] = 0;
    }
}

// Full covisibility edge accumulation: for every valid keyframe pair count
// shared points (used by pose-graph edge construction).
// out: [K, K] int32 upper-triangular counts.
void covis_matrix(const int32_t* kf_pt, const uint8_t* kf_valid,
                  int64_t K, int64_t N, int64_t P,
                  int32_t* pt_owner_scratch,  // [P] int32, init -1
                  int32_t* out) {
    std::memset(out, 0, sizeof(int32_t) * K * K);
    // invert: for each point remember last keyframe seen; simple O(K*N + E)
    // accumulation via per-point observer chains is overkill here — do
    // per-point bitsets in chunks instead: for each keyframe, walk its
    // points and scatter into a per-point "first owner" then count.
    for (int64_t p = 0; p < P; ++p) pt_owner_scratch[p] = -1;
    // For each keyframe j, for each point p in j: for all earlier owners we
    // need counts; store linked ownership via repeated passes is O(K^2 N) in
    // the worst case — instead use per-point observer lists built once.
    // counts[j1, j2] built by bucketing observers.
    // observer list head/next arrays:
    // (heads in pt_owner_scratch, next chained through a local buffer)
    int32_t* next = new int32_t[K * N];
    for (int64_t j = 0; j < K; ++j) {
        if (!kf_valid[j]) continue;
        const int32_t* r = kf_pt + j * N;
        for (int64_t i = 0; i < N; ++i) {
            int32_t p = r[i];
            if (p < 0 || p >= P) continue;
            int64_t slot = j * N + i;
            next[slot] = pt_owner_scratch[p];
            pt_owner_scratch[p] = (int32_t)slot;
        }
    }
    for (int64_t p = 0; p < P; ++p) {
        for (int32_t a = pt_owner_scratch[p]; a >= 0; a = next[a]) {
            int64_t ja = a / N;
            for (int32_t b = next[a]; b >= 0; b = next[b]) {
                int64_t jb = b / N;
                if (ja == jb) continue;
                int64_t lo = ja < jb ? ja : jb, hi = ja < jb ? jb : ja;
                out[lo * K + hi] += 1;
            }
        }
        pt_owner_scratch[p] = -1;
    }
    delete[] next;
}

static inline int popcount256(const uint32_t* a, const uint32_t* b) {
    int d = 0;
    for (int w = 0; w < 8; ++w) d += __builtin_popcount(a[w] ^ b[w]);
    return d;
}

// Medoid descriptor per observation group.
// descs: [M, 8] uint32 descriptors of all observations, grouped contiguously
// offsets: [G+1] int64 group boundaries; out: [G] int64 index (into descs)
// of each group's medoid (min summed Hamming distance to its group).
void medoid_descriptors(const uint32_t* descs, const int64_t* offsets,
                        int64_t G, int64_t* out) {
    for (int64_t g = 0; g < G; ++g) {
        int64_t s = offsets[g], e = offsets[g + 1];
        int64_t best = s;
        long best_sum = 1L << 60;
        for (int64_t i = s; i < e; ++i) {
            long sum = 0;
            for (int64_t j = s; j < e; ++j)
                sum += popcount256(descs + i * 8, descs + j * 8);
            if (sum < best_sum) { best_sum = sum; best = i; }
        }
        out[g] = best;
    }
}

}  // extern "C"
