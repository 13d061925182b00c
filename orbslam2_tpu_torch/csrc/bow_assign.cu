// Vocabulary-tree descent of 256-bit ORB descriptors, for Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for this: orbslam2_tpu/ops/bow.py
// `assign_words` computes the XOR-popcount inline in an XLA program, on
// children gathered from the tree (one gather and one argmin per level), so
// it is the one Hamming computation outside `hamming_matrix_pallas`. PyTorch
// has no popcount: a plain port is a byte-table lookup over [M, k, 32] at
// every level, some sixty eager kernels a call. This kernel does the whole
// descent in one launch.
//
// For each of M descriptors: start at node 0; at each of `levels` levels take
// the node's k children, the Hamming distance to each child's descriptor
// (1 << 20 for a -1 child), the first child of lowest distance (argmin's tie
// rule), and step there only if the node has a child and is no leaf
// (node_word < 0); remember the node reached after `gate_depth` steps. Then
// word = node_word[node], ok = valid & (word >= 0), and the outputs are
// (ok ? word : 0, ok, ok ? gate : -1). All integer, all exact.
//
// What bounds it on the card. Neither bytes nor operations: a descriptor
// touches levels * k * (32 + 4) bytes of the tables (2 MB for 1024
// descriptors on a k = 11, 5-level tree, under 1 us at the memory rate) and
// 8 * k * levels popcounts. The time is a chain of dependent loads: the
// children of a node can be read only when the node is known, a child's
// descriptor only when the child is, so every level costs two trips to L2 or
// device memory and nothing overlaps them within one descriptor. The design
// therefore spends lanes, not time: one warp a descriptor, lane c < k takes
// child c (its 32 descriptor bytes as two 16-byte loads), so a level's k
// children are in flight together, and 4 warps a block with many blocks a
// SM keep enough descriptors in flight to hide each other's trips. The argmin
// is a warp shuffle reduction on the key distance * 32 + c, whose minimum is
// the lowest distance and among equals the lowest child. No shared memory and
// no __syncthreads.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbow_assign.so bow_assign.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // warps (descriptors) per block
constexpr int kNoChild = 1 << 20;     // distance of a -1 child
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
bow_assign_kernel(const uint4* __restrict__ node_desc,      // [N, 2] 16-byte halves
                  const int32_t* __restrict__ node_children,  // [N, k]
                  const int32_t* __restrict__ node_word,      // [N]
                  const uint4* __restrict__ desc,             // [M, 2]
                  const uint8_t* __restrict__ valid,          // [M]
                  int32_t* __restrict__ words, uint8_t* __restrict__ ok_out,
                  int32_t* __restrict__ gate_out, int m, int k, int levels,
                  int gate_depth) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= m) return;  // the whole warp

    // every lane holds the whole descriptor (the loads coalesce to a broadcast)
    const uint4 d0 = desc[2 * (int64_t)row];
    const uint4 d1 = desc[2 * (int64_t)row + 1];

    int node = 0;
    int gate = 0;
    for (int lv = 0; lv < levels; ++lv) {
        int child = -1;
        if (lane < k) child = node_children[(int64_t)node * k + lane];
        // lanes beyond k never win: their key is above every child's
        int key = 0x7fffffff;
        if (lane < k) {
            int dist = kNoChild;
            if (child >= 0) {
                const uint4 c0 = node_desc[2 * (int64_t)child];
                const uint4 c1 = node_desc[2 * (int64_t)child + 1];
                dist = __popc(c0.x ^ d0.x) + __popc(c0.y ^ d0.y) +
                       __popc(c0.z ^ d0.z) + __popc(c0.w ^ d0.w) +
                       __popc(c1.x ^ d1.x) + __popc(c1.y ^ d1.y) +
                       __popc(c1.z ^ d1.z) + __popc(c1.w ^ d1.w);
            }
            key = dist * 32 + lane;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            key = min(key, __shfl_xor_sync(kFull, key, off));
        const int best = __shfl_sync(kFull, child, key & 31);
        const bool has_child = key < kNoChild * 32;
        if (has_child && node_word[node] < 0) node = best;
        if (lv == gate_depth - 1) gate = node;
    }
    if (lane == 0) {
        const int w = node_word[node];
        const bool ok = valid[row] != 0 && w >= 0;
        words[row] = ok ? w : 0;
        ok_out[row] = ok ? 1 : 0;
        gate_out[row] = ok ? gate : -1;
    }
}

}  // namespace

extern "C" {

// node_desc: [n_nodes, 8] int32 bit-views of the u32 words; node_children:
// [n_nodes, k] int32 (-1 = none), 1 <= k <= 32; node_word: [n_nodes] int32;
// desc: [m, 8] int32; valid: [m] bool (one byte each). Outputs words [m]
// int32, ok [m] bool, gate [m] int32. All contiguous, both descriptor arrays
// 16-byte aligned, on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not sync.
int bow_assign_launch(const void* node_desc, const void* node_children,
                      const void* node_word, const void* desc, const void* valid,
                      void* words, void* ok, void* gate, int m, int k, int levels,
                      int gate_depth, void* stream) {
    if (m <= 0) return 0;
    if (k < 1 || k > 32) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (m + kWarps - 1) / kWarps;
    bow_assign_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(node_desc),
        static_cast<const int32_t*>(node_children),
        static_cast<const int32_t*>(node_word), static_cast<const uint4*>(desc),
        static_cast<const uint8_t*>(valid), static_cast<int32_t*>(words),
        static_cast<uint8_t*>(ok), static_cast<int32_t*>(gate), m, k, levels,
        gate_depth);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
