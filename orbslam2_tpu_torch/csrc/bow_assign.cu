// Vocabulary-tree descent of 256-bit ORB descriptors, for Hopper (sm_90a).
//
// Replaces orbslam2_tpu/ops/bow.py `assign_words`. The JAX package has no
// Pallas kernel for it: it computes the XOR-popcount inline in an XLA
// program, on children gathered from the tree (one gather and one argmin
// per level), the one Hamming computation outside `hamming_matrix_pallas`.
// PyTorch has no popcount: a plain port is a byte-table lookup over
// [M, k, 32] at every level, some sixty eager kernels a call. This kernel
// does the whole descent in one launch.
//
// The tree comes as its children-block table (io/vocabulary.py
// pack_child_blocks): every node that steps (it has a child and no word)
// owns a block of k rows of 48 bytes, row c for its child c: the child's 32
// descriptor bytes, then the child's own block (-1 where the child does not
// step), its word (-1 for none), its node id (-1: no child c) and a pad.
//
// For each of M descriptors: start at the root (its block and word, node
// 0); at each of `levels` levels, if the current node has a block, take
// the Hamming distance to each row's descriptor (1 << 20 for an empty
// row), the first row of lowest distance (argmin's tie rule), and move to
// that child, whose block, word and id come with its row; remember the node
// after `gate_depth` levels. Then ok = valid & (word >= 0) and the outputs
// are (ok ? word : 0, ok, ok ? gate : -1). All integer, all exact.
//
// What bounds it on the card. Neither bytes nor operations: a call reads
// about 1 MB of the 8.4 MB table of the default vocabulary (0.3 us at the
// memory rate) and does 8 * k * levels popcounts a descriptor. The time is
// a chain of dependent loads: a node's rows can be read only once the node
// is known. The first design read a level in two trips (the children's
// ids, then their descriptors) and the node's word, about 11 trips in all.
// Here a level is one trip: lane c < k loads row c of the block as three
// 16-byte loads issued together; one redux.sync takes the minimum of the
// key distance * 32 + c (the lowest distance, and among equals the lowest
// child), the winner's block, word and id are shuffled to the warp, and
// the next level's loads go out at once. The word arrives with the last
// winner's row. The first two levels do not wait for L2 at all: every
// block of threads first copies the table's first n_top_rows rows (the
// root's block and its children's, first in breadth-first order: 12
// blocks, 6.3 KB for the default tree) into shared memory with cp.async,
// and the descriptor's loads go out beside that copy. So a descent costs
// the copy and levels - 2 trips: 4 for the default 5-level tree, where the
// first design took 11. One warp a descriptor, 16 warps a block (the copy
// is shared by 16 descriptors), no other __syncthreads.
//
// bow_assign_variant_launch (timed by utils/probe_hamming.py beside the
// kernel) runs the same walk without the copy (4 warps a block) or with
// other block sizes.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbow_assign.so bow_assign.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;            // warps (descriptors) per block
constexpr int kRowVecs = 3;           // 16-byte loads a row of the table
constexpr int kMaxTopRows = 1024;     // 48 KB of staged rows at most
constexpr int kNoChild = 1 << 20;     // distance of an empty row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int hamming(const int4& c0, const int4& c1,
                                       const uint4& d0, const uint4& d1) {
    return __popc(static_cast<unsigned>(c0.x) ^ d0.x) +
           __popc(static_cast<unsigned>(c0.y) ^ d0.y) +
           __popc(static_cast<unsigned>(c0.z) ^ d0.z) +
           __popc(static_cast<unsigned>(c0.w) ^ d0.w) +
           __popc(static_cast<unsigned>(c1.x) ^ d1.x) +
           __popc(static_cast<unsigned>(c1.y) ^ d1.y) +
           __popc(static_cast<unsigned>(c1.z) ^ d1.z) +
           __popc(static_cast<unsigned>(c1.w) ^ d1.w);
}

template <int kW, bool kStaged>
__global__ void __launch_bounds__(kW * 32)
bow_assign_kernel(const int4* __restrict__ rows,      // [n_blocks * k, 3]
                  const uint4* __restrict__ desc,     // [M, 2]
                  const uint8_t* __restrict__ valid,  // [M]
                  int32_t* __restrict__ words, uint8_t* __restrict__ ok_out,
                  int32_t* __restrict__ gate_out, int m, int k, int levels,
                  int gate_depth, int root_block, int root_word, int n_top_rows) {
    extern __shared__ int4 top[];  // the staged variant's first rows
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kW + (threadIdx.x >> 5);
    if (kStaged) {
        for (int i = threadIdx.x; i < n_top_rows * kRowVecs; i += kW * 32) {
            const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(top + i));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(dst), "l"(rows + i) : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // every lane holds the whole descriptor (the loads coalesce to a
    // broadcast); they do not wait for the tree
    uint4 d0 = make_uint4(0u, 0u, 0u, 0u), d1 = d0;
    if (row < m) {
        d0 = desc[2 * (int64_t)row];
        d1 = desc[2 * (int64_t)row + 1];
    }
    if (kStaged) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }
    if (row >= m) return;  // the whole warp

    int block = root_block, word = root_word, node = 0, gate = 0;
    for (int lv = 0; lv < levels; ++lv) {
        if (block >= 0) {  // the same in every lane
            // lanes beyond k never win: their key is above every row's
            int key = 0x7fffffff, next_block = -1, next_word = -1, next_node = -1;
            if (lane < k) {
                const int64_t r = (int64_t)block * k + lane;
                int4 c0, c1, c2;
                if (kStaged && r < n_top_rows) {
                    c0 = top[kRowVecs * r];
                    c1 = top[kRowVecs * r + 1];
                    c2 = top[kRowVecs * r + 2];
                } else {
                    c0 = __ldg(rows + kRowVecs * r);
                    c1 = __ldg(rows + kRowVecs * r + 1);
                    c2 = __ldg(rows + kRowVecs * r + 2);
                }
                next_block = c2.x;
                next_word = c2.y;
                next_node = c2.z;
                key = (next_node >= 0 ? hamming(c0, c1, d0, d1) : kNoChild) * 32 + lane;
            }
            const int src = __reduce_min_sync(kFull, key) & 31;
            block = __shfl_sync(kFull, next_block, src);
            word = __shfl_sync(kFull, next_word, src);
            node = __shfl_sync(kFull, next_node, src);
        }
        if (lv == gate_depth - 1) gate = node;
    }
    if (lane == 0) {
        const bool ok = valid[row] != 0 && word >= 0;
        words[row] = ok ? word : 0;
        ok_out[row] = ok ? 1 : 0;
        gate_out[row] = ok ? gate : -1;
    }
}

template <int kW, bool kStaged>
int launch(const void* rows, const void* desc, const void* valid, void* words,
           void* ok, void* gate, int m, int k, int levels, int gate_depth,
           int root_block, int root_word, int n_top_rows, void* stream) {
    if (m <= 0) return 0;
    if (k < 1 || k > 32 || n_top_rows < 0 || n_top_rows > kMaxTopRows)
        return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (m + kW - 1) / kW;
    const size_t smem = kStaged ? sizeof(int4) * kRowVecs * n_top_rows : 0;
    bow_assign_kernel<kW, kStaged><<<grid, kW * 32, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(rows), static_cast<const uint4*>(desc),
        static_cast<const uint8_t*>(valid), static_cast<int32_t*>(words),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(gate), m, k, levels,
        gate_depth, root_block, root_word, n_top_rows);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rows: the children-block table, [n_blocks, k, 12] int32, 1 <= k <= 32;
// root_block / root_word: the root's block (-1 if it does not step) and
// word; n_top_rows: the rows to stage in shared memory (0 to 1024, the
// table's first ones); desc: [m, 8] int32 bit-views of the u32 words;
// valid: [m] bool (one byte each). Outputs words [m] int32, ok [m] bool,
// gate [m] int32. All contiguous, rows and desc 16-byte aligned, on the
// current device. Launches on `stream` and returns cudaGetLastError() (0
// on success); does not sync.
int bow_assign_launch(const void* rows, const void* desc, const void* valid,
                      void* words, void* ok, void* gate, int m, int k, int levels,
                      int gate_depth, int root_block, int root_word, int n_top_rows,
                      void* stream) {
    return launch<kWarps, true>(rows, desc, valid, words, ok, gate, m, k, levels,
                                gate_depth, root_block, root_word, n_top_rows, stream);
}

// As bow_assign_launch, for variant 0 (no copy, 4 warps a block), 1 (8
// warps a block) or 2 (32 warps a block).
int bow_assign_variant_launch(int variant, const void* rows, const void* desc,
                              const void* valid, void* words, void* ok, void* gate,
                              int m, int k, int levels, int gate_depth,
                              int root_block, int root_word, int n_top_rows,
                              void* stream) {
    switch (variant) {
        case 0:
            return launch<4, false>(rows, desc, valid, words, ok, gate, m, k, levels,
                                    gate_depth, root_block, root_word, 0, stream);
        case 1:
            return launch<8, true>(rows, desc, valid, words, ok, gate, m, k, levels,
                                   gate_depth, root_block, root_word, n_top_rows,
                                   stream);
        case 2:
            return launch<32, true>(rows, desc, valid, words, ok, gate, m, k, levels,
                                    gate_depth, root_block, root_word, n_top_rows,
                                    stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // extern "C"
