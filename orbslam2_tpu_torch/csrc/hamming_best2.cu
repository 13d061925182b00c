// Masked best / second-best Hamming match of 256-bit ORB descriptors, for
// Hopper (sm_90a): the fused form of the Hamming kernel (hamming.cu).
//
// The matchers of the JAX package take the Pallas TPU kernel's [A, B] matrix
// (orbslam2_tpu/ops/pallas_kernels.py `hamming_matrix_pallas`) and reduce it
// under a candidate mask (orbslam2_tpu/ops/matching.py `masked_best_match`:
// where, argmin, min, scatter, min). On the TPU the matrix stays in HBM
// between the two; here the two are one kernel, and the distances never leave
// the SM. For every row, over the columns where cand is true:
//   best    the lowest distance (BIG = 1 << 20 if the row has no candidate),
//   idx     the lowest column that attains it (0 if none),
//   second  the lowest distance over all other columns (BIG if there is no
//           other candidate; equal to best on a tie),
// which is exactly d = where(cand, dist, BIG); argmin; scatter BIG; amin.
//
// What bounds it on the card: the bytes, and they are few. The mask is one
// byte a pair (4.2 MB at [4096, 1024]), the descriptors 160 KB, the outputs
// 12 bytes a row. The arithmetic is hamming_tile.cuh's tensor-core tile; the
// reduction costs 3 integer min/max per candidate and nothing for a column
// that is no candidate, so the work follows the mask's density.
//
// Layout: one block owns 16 whole rows (one mma tile of rows), so the
// reduction needs no atomics and no second pass and is deterministic. Its 16
// warps share the columns: warp w takes the 64-column chunks w, w+16, ..., so
// at 1024 columns every warp has one chunk and all of a block's loads are in
// flight at once ([1024, 1024] gives only 64 blocks).
// The column order inside a chunk (hamming_tile.cuh) gives a lane 16
// neighbouring columns of rows g and g+8, so it reads its share of the mask
// as one 16-byte load per row (the 4 lanes of a group: 64 contiguous bytes).
// A chunk whose 16x64 mask is empty skips its loads of B and its mma.
//
// The reduction keeps, per row, the two smallest keys (distance << 22 | column).
// Keys of one row are distinct, the smallest key is the best distance at its
// lowest column, and the second key's distance is the best of all other
// columns. Pushing a key and merging two partial results are branch-free:
//   k2 = min(k2, max(k1, k)); k1 = min(k1, k).
// Lanes of a group merge by warp shuffles, warps through 1 KB of shared
// memory. Only candidates are pushed: a non-candidate's BIG can only ever be
// the answer where no (other) candidate exists, which the empty key decodes to.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhamming_best2.so hamming_best2.cu

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

constexpr int kRows = hamming::kTileRows;  // rows per block: one mma tile
constexpr int kWarps = 16;           // warps per block, sharing the columns
constexpr int kNT = 8;               // mma tiles per chunk: 16 columns a lane
constexpr int kChunkCols = 8 * kNT;  // 64
constexpr int kLaneCols = 2 * kNT;   // 16
constexpr int kColBits = 22;         // columns per key: n_b <= 1 << 22
constexpr uint32_t kColMask = (1u << kColBits) - 1u;
constexpr uint32_t kEmpty = 0xffffffffu;  // above every key (distance <= 256)
constexpr int kBig = 1 << 20;        // ops/matching.py BIG

struct Top2 {
    uint32_t k1, k2;  // smallest and second-smallest key
};

__device__ __forceinline__ void push(Top2& s, uint32_t k) {
    s.k2 = min(s.k2, max(s.k1, k));
    s.k1 = min(s.k1, k);
}

__device__ __forceinline__ void merge(Top2& s, const Top2& o) {
    s.k2 = min(min(s.k2, o.k2), max(s.k1, o.k1));
    s.k1 = min(s.k1, o.k1);
}

// The 16 mask bytes of `row` from column `col` on, as 4 words; zeros past
// the edges. vec: every such run is whole and 16-byte aligned.
__device__ __forceinline__ uint4 load_mask(const uint8_t* __restrict__ cand,
                                           int row, int col, int n_a, int n_b,
                                           bool vec) {
    if (row >= n_a || col >= n_b) return make_uint4(0u, 0u, 0u, 0u);
    const uint8_t* p = cand + (int64_t)row * n_b + col;
    if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < kLaneCols; ++e) {
        if (col + e < n_b && p[e]) w[e >> 2] |= 0xffu << (8 * (e & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kWarps * 32)
hamming_best2_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     const uint8_t* __restrict__ cand, int32_t* __restrict__ idx,
                     int32_t* __restrict__ best, int32_t* __restrict__ second,
                     int n_a, int n_b) {
    constexpr int R = 2;  // rows a lane holds: g and g + 8
    __shared__ Top2 part[kWarps][kRows];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = blockIdx.x * kRows;
    const hamming::RowFrag fa = hamming::load_rows(a, row0, n_a, g, t);
    // Every lane's 16-byte run of the mask is whole and aligned iff rows are
    // a multiple of 16 bytes long (and the base is aligned; the wrapper checks).
    const bool vec = (n_b % kLaneCols) == 0;

    Top2 s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = Top2{kEmpty, kEmpty};

    for (int col0 = warp * kChunkCols; col0 < n_b; col0 += kWarps * kChunkCols) {
        const int col = col0 + t * kLaneCols;  // first of this lane's 16 columns
        uint4 m[R];
        uint32_t any = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            m[r] = load_mask(cand, row0 + g + 8 * r, col, n_a, n_b, vec);
            any |= m[r].x | m[r].y | m[r].z | m[r].w;
        }
        if (!__any_sync(0xffffffffu, any != 0u)) continue;  // the whole warp
        uint2 bw[kNT];
        int acc[R][kLaneCols];
        hamming::load_cols<kNT>(b, n_b, col0, g, t, bw);
        hamming::hamming_chunk<kNT>(fa, bw, acc);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const uint32_t w[4] = {m[r].x, m[r].y, m[r].z, m[r].w};
            if ((w[0] | w[1] | w[2] | w[3]) == 0u) continue;
#pragma unroll
            for (int e = 0; e < kLaneCols; ++e) {
                if ((w[e >> 2] >> (8 * (e & 3))) & 0xffu) {
                    push(s[r], ((uint32_t)acc[r][e] << kColBits) | (uint32_t)(col + e));
                }
            }
        }
    }

    // the 4 lanes of a group hold parts of the same rows
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            Top2 o;
            o.k1 = __shfl_xor_sync(0xffffffffu, s[r].k1, off);
            o.k2 = __shfl_xor_sync(0xffffffffu, s[r].k2, off);
            merge(s[r], o);
        }
        if (t == 0) part[warp][g + 8 * r] = s[r];
    }
    __syncthreads();

    if (threadIdx.x < kRows) {
        const int row = row0 + threadIdx.x;
        if (row >= n_a) return;
        Top2 f = part[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) merge(f, part[w][threadIdx.x]);
        idx[row] = f.k1 == kEmpty ? 0 : (int32_t)(f.k1 & kColMask);
        best[row] = f.k1 == kEmpty ? kBig : (int32_t)(f.k1 >> kColBits);
        second[row] = f.k2 == kEmpty ? kBig : (int32_t)(f.k2 >> kColBits);
    }
}

}  // namespace

extern "C" {

// desc_a: [n_a, 8] int32 bit-views of the u32 words; desc_b: [n_b, 8];
// cand: [n_a, n_b] bytes, non-zero where the pair is a candidate;
// idx, best, second: [n_a] int32. 0 < n_b <= 1 << 22. All contiguous, the
// descriptors 8-byte aligned, cand 16-byte aligned if n_b is a multiple of
// 16, on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not sync.
int hamming_best2_launch(const void* desc_a, const void* desc_b, const void* cand,
                         void* idx, void* best, void* second, int n_a, int n_b,
                         void* stream) {
    if (n_a <= 0) return 0;
    if (n_b <= 0 || n_b > (1 << kColBits)) return static_cast<int>(cudaErrorInvalidValue);
    hamming_best2_kernel<<<(n_a + kRows - 1) / kRows, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(desc_a), static_cast<const uint32_t*>(desc_b),
        static_cast<const uint8_t*>(cand), static_cast<int32_t*>(idx),
        static_cast<int32_t*>(best), static_cast<int32_t*>(second), n_a, n_b);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
