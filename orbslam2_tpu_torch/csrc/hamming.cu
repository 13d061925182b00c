// Dense Hamming-distance matrix of 256-bit ORB descriptors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orbslam2_tpu/ops/pallas_kernels.py
// `hamming_matrix_pallas` (body `_hamming_kernel`): for every pair (a, b),
// XOR the 8 descriptor words, popcount each and sum. The TPU kernel works in
// 256x256 VMEM tiles and needs A and B to be multiples of 256; this kernel
// takes any A and B and masks the ragged edge itself.
//
// What bounds it on the card: the [A, B] int32 output. At the tracker's
// local-map shape [4096, 1024] the inputs are 160 KB and the output is 16 MB,
// while the work is 8 popcounts per output (32M __popc for the whole matrix,
// a few microseconds of issue on 132 SMs). So the design goal is coalesced
// output stores: each thread owns a 4x4 block of outputs whose 4 columns are
// contiguous and stores them as one 16-byte int4 where the row allows it, so
// a warp writes two 256-byte row segments per store. Fusing the masked
// best/second-best reduction (ops/matching.py masked_best_match) into this
// kernel, so the matrix never reaches device memory, is the next step.
//
// Layout: one block of 16x16 threads computes a 64x64 output tile. The tile's
// 64 A descriptors and 64 B descriptors are staged in shared memory word-major
// (s[w][row]), so a thread reads the words of its 4 rows (or 4 columns) as one
// uint4: the 16 threads of a half-warp read 256 contiguous bytes of the B tile
// (conflict-free) and one broadcast address of the A tile.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhamming.so hamming.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // rows of A and columns of B per block
constexpr int kThreads = 16;  // threads per block along each axis
constexpr int kPer = kTile / kThreads;  // outputs per thread along each axis
constexpr int kWords = 8;     // 32-bit words per descriptor

__global__ void __launch_bounds__(kThreads * kThreads)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n_a, int n_b) {
    __shared__ __align__(16) uint32_t sa[kWords][kTile];
    __shared__ __align__(16) uint32_t sb[kWords][kTile];

    const int a0 = blockIdx.y * kTile;
    const int b0 = blockIdx.x * kTile;
    const int tid = threadIdx.y * kThreads + threadIdx.x;

    // Stage both tiles: 64 descriptors x 8 words each, read row-major from
    // device memory (coalesced), stored word-major. Rows past the edge are 0.
    for (int i = tid; i < kTile * kWords; i += kThreads * kThreads) {
        const int row = i / kWords;
        const int w = i % kWords;
        const int ra = a0 + row;
        const int rb = b0 + row;
        sa[w][row] = ra < n_a ? a[(int64_t)ra * kWords + w] : 0u;
        sb[w][row] = rb < n_b ? b[(int64_t)rb * kWords + w] : 0u;
    }
    __syncthreads();

    const int ra = threadIdx.y * kPer;  // first of this thread's 4 rows
    const int cb = threadIdx.x * kPer;  // first of this thread's 4 columns
    int acc[kPer][kPer] = {};
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
        const uint4 av = *reinterpret_cast<const uint4*>(&sa[w][ra]);
        const uint4 bv = *reinterpret_cast<const uint4*>(&sb[w][cb]);
        const uint32_t ar[kPer] = {av.x, av.y, av.z, av.w};
        const uint32_t br[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                acc[i][j] += __popc(ar[i] ^ br[j]);
            }
        }
    }

    const int col = b0 + cb;
    // A row starts 16-byte aligned iff n_b is a multiple of 4 (the output
    // comes from torch.empty, whose base is at least 256-byte aligned).
    const bool vec = (n_b % kPer) == 0 && col + kPer <= n_b;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int row = a0 + ra + i;
        if (row >= n_a) break;
        int32_t* dst = out + (int64_t)row * n_b + col;
        if (vec) {
            *reinterpret_cast<int4*>(dst) =
                make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                if (col + j < n_b) dst[j] = acc[i][j];
            }
        }
    }
}

}  // namespace

extern "C" {

// desc_a: [n_a, 8] int32 bit-views of the u32 words; desc_b: [n_b, 8];
// out: [n_a, n_b] int32. All contiguous, on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not sync.
int hamming_matrix_launch(const void* desc_a, const void* desc_b, void* out,
                          int n_a, int n_b, void* stream) {
    if (n_a <= 0 || n_b <= 0) return 0;
    const dim3 grid((n_b + kTile - 1) / kTile, (n_a + kTile - 1) / kTile);
    const dim3 block(kThreads, kThreads);
    hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(desc_a),
        static_cast<const uint32_t*>(desc_b), static_cast<int32_t*>(out), n_a,
        n_b);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
