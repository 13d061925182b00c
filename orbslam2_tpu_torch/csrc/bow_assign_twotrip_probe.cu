// The first design of the vocabulary-descent kernel, kept as a probe:
// utils/probe_hamming.py and chip_smoke.py phase 3c time it in turns with
// csrc/bow_assign.cu, which replaced it. Built only by the probe; on no path.
//
// It descends the JAX package's layout of the tree (node descriptors
// [N, 8], children [N, k], words [N]): at each level lane c < k loads child
// c's id, then that child's 32 descriptor bytes, and after the argmin the
// node's word decides whether to step, so a level costs two dependent
// trips to L2 or device memory and a word load, and the end one more word
// load: about 12 trips for the default 5-level tree. One warp a
// descriptor, 4 warps a block, a shuffle argmin on distance * 32 + c.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbow_assign_twotrip_probe.so bow_assign_twotrip_probe.cu

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
int bow_assign_twotrip_launch(const void* node_desc, const void* node_children,
                              const void* node_word, const void* desc,
                              const void* valid,
                              void* words, void* ok, void* gate, int m, int k,
                              int levels, int gate_depth, void* stream) {
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
