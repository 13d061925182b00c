// Order-fixed segment sum of float rows, for Hopper (sm_90a).
//
// Replaces `jax.ops.segment_sum` in orbslam2_tpu/ops/ba.py:44 (the
// Schur-complement BA's block assembly: Hcc, bc, Hpp, bp, the coupling G,
// the CG matvec and the back-substitution) and orbslam2_tpu/ops/pose_graph.py:74
// (the essential graph's block diagonal, b and matvec). XLA adds those in
// a fixed order, on the TPU as on the CPU, so the JAX package repeats
// itself run to run. PyTorch's `index_add_` on a card adds with float
// atomics, whose order (and so whose last bits) changes from run to run;
// over a local BA's fifteen LM iterations that moved the final cost by
// 1.3% between fresh runs on an H100.
//
// What it computes: out[s, c] = sum of x[perm[k], c] for k in
// [offsets[s], offsets[s + 1]), for x of shape [E, D] and out [n, D],
// starting from 0 and adding in increasing k. `perm` is the stable sort of
// the rows' segment indices (ops/cuda_kernels.py seg_plan), so a segment
// adds its rows in increasing row order: the order of `index_add_` on the
// CPU, which loops over the rows one after the other. On the same inputs
// the card's result therefore equals the CPU's bit for bit. No fast-math:
// flushing denormals or contracting would change the bits.
//
// Design: one thread a (segment, column), threads numbered segment-major,
// so the threads of one segment read one row's D neighbouring values
// together (the rows of the BA and the pose graph are 1 to 49 floats) and
// write the segment's output row together; the segment's perm entries are
// broadcast loads. A thread walks its segment in chunks of kUnroll rows:
// the chunk's kUnroll values are loaded at once, the next chunk's perm
// entries are loaded behind them, and only then are the values added in
// order. So a chunk costs one trip to memory, not two (perm, then x), and
// only the adds form a chain (on an H100 at 700 W, the local BA's Hcc took
// 29.7 us warm when a chunk of 8 loaded perm and x in two trips, 26 us
// this way). The grid is capped at 8 blocks an SM, whose threads stride
// over the pairs: the global BA's coupling G has 1,048,576 mostly empty
// segments, and one block a 256 pairs (73,728 blocks, 46 us to schedule
// with nothing in them) took 122 us where the capped grid took 106. Pair
// indices are 32-bit where they fit, since each pair costs a division by D.
//
// What bounds it on the card: bytes. A call reads x, perm and offsets once
// and writes out once; it does one add per value read, far below the
// float32 rate. The long chains (16 segments of about 512 rows for the
// local BA's Hcc) are latency, not bytes: 576 threads, each 512 / kUnroll
// trips, where `index_add_` spreads 295,000 atomics over 576 floats.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libseg_sum.so seg_sum.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;       // rows in flight a thread
constexpr int kBlocksPerSm = 8;   // the grid's cap: 2,048 threads an SM

// I: the index type of the (segment, column) pairs, int32_t whenever their
// count fits (a 32-bit division by d is a third of a 64-bit one).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const T* __restrict__ x,             // [E, d]
               const int32_t* __restrict__ perm,    // [E]
               const int32_t* __restrict__ offsets, // [n + 1]
               T* __restrict__ out,                 // [n, d]
               I total, int d) {
    const I stride = static_cast<I>(gridDim.x) * kThreads;
    for (I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; t < total;
         t += stride) {
        const I s = t / d;
        const int c = static_cast<int>(t - s * d);
        const int hi = __ldg(offsets + s + 1);
        int k = __ldg(offsets + s);
        T acc = T(0);
        int p[kUnroll];
        if (k + kUnroll <= hi) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) p[u] = __ldg(perm + k + u);
        }
        for (; k + kUnroll <= hi; k += kUnroll) {
            T v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                v[u] = __ldg(x + static_cast<int64_t>(p[u]) * d + c);
            if (k + 2 * kUnroll <= hi) {
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) p[u] = __ldg(perm + k + kUnroll + u);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) acc += v[u];
        }
        for (; k < hi; ++k)
            acc += __ldg(x + static_cast<int64_t>(__ldg(perm + k)) * d + c);
        out[t] = acc;
    }
}

template <typename T>
int launch(const void* x, const void* perm, const void* offsets, void* out,
           int n, int d, int max_blocks, void* stream) {
    const int64_t total = static_cast<int64_t>(n) * d;
    if (total == 0) return 0;
    int64_t grid = (total + kThreads - 1) / kThreads;
    if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
    if (grid > 0x7fffffff) grid = 0x7fffffff;  // the threads stride over the rest
    const auto xs = static_cast<const T*>(x);
    const auto ps = static_cast<const int32_t*>(perm);
    const auto os = static_cast<const int32_t*>(offsets);
    const auto cs = static_cast<cudaStream_t>(stream);
    if (total + static_cast<int64_t>(grid) * kThreads <= 0x7fffffff)
        seg_sum_kernel<T, int32_t><<<static_cast<unsigned>(grid), kThreads, 0, cs>>>(
            xs, ps, os, static_cast<T*>(out), static_cast<int32_t>(total), d);
    else
        seg_sum_kernel<T, int64_t><<<static_cast<unsigned>(grid), kThreads, 0, cs>>>(
            xs, ps, os, static_cast<T*>(out), total, d);
    return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* perm, const void* offsets, void* out, int n,
             int d, int elem_bytes, int max_blocks, void* stream) {
    if (n < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (elem_bytes == 4)
        return launch<float>(x, perm, offsets, out, n, d, max_blocks, stream);
    if (elem_bytes == 8)
        return launch<double>(x, perm, offsets, out, n, d, max_blocks, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [E, d], perm [E] int32, offsets [n + 1] int32, out [n, d], all
// contiguous on the card; elem_bytes 4 (float) or 8 (double). The grid is
// one block a 256 (segment, column) pairs, at most kBlocksPerSm an SM.
// Returns the CUDA error of the launch (0: launched, or nothing to do).
extern "C" int seg_sum_launch(const void* x, const void* perm, const void* offsets,
                              void* out, int n, int d, int elem_bytes,
                              void* stream) {
    static int sms = 0;
    if (sms == 0) {
        int device = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    return dispatch(x, perm, offsets, out, n, d, elem_bytes, kBlocksPerSm * sms, stream);
}
