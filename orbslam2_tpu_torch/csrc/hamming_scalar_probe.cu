// Probe source, not on any path of the package: the scalar-pipe Hamming
// kernel that hamming.cu's tensor-core design replaced, with the variants
// that separate its costs on the card (utils/probe_hamming.py times them).
//
// The scalar design: a 64x64 output tile per block of 16x16 threads, both
// descriptor tiles staged word-major in shared memory, 4x4 outputs a thread,
// 8 __popc(a ^ b) per output, int4 stores.
//
// Variants (same grid, same block):
//   0  the kernel as it was
//   1  an empty kernel with that grid and block: the fixed cost of a launch
//   2  stores kept, every __popc(x) replaced by a plain add of x: the time
//      of the stores (and the staging) without the popcount issue
//   3  popcounts kept, one 4-byte store per thread instead of 16: the time
//      of the popcount issue without the output traffic
// and a tensor-core rate loop: back-to-back m16n8k256 .and.popc mma.sync.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//             -Xcompiler -fPIC -o libhamming_scalar_probe.so hamming_scalar_probe.cu

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

constexpr int kTile = 64;     // rows of A and columns of B per block
constexpr int kThreads = 16;  // threads per block along each axis
constexpr int kPer = kTile / kThreads;  // outputs per thread along each axis
constexpr int kWords = 8;     // 32-bit words per descriptor

__global__ void empty_kernel() {}

template <int V>
__global__ void __launch_bounds__(kThreads * kThreads)
scalar_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              int32_t* __restrict__ out, int n_a, int n_b) {
    __shared__ __align__(16) uint32_t sa[kWords][kTile];
    __shared__ __align__(16) uint32_t sb[kWords][kTile];

    const int a0 = blockIdx.y * kTile;
    const int b0 = blockIdx.x * kTile;
    const int tid = threadIdx.y * kThreads + threadIdx.x;

    for (int i = tid; i < kTile * kWords; i += kThreads * kThreads) {
        const int row = i / kWords;
        const int w = i % kWords;
        const int ra = a0 + row;
        const int rb = b0 + row;
        sa[w][row] = ra < n_a ? a[(int64_t)ra * kWords + w] : 0u;
        sb[w][row] = rb < n_b ? b[(int64_t)rb * kWords + w] : 0u;
    }
    __syncthreads();

    const int ra = threadIdx.y * kPer;
    const int cb = threadIdx.x * kPer;
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
                acc[i][j] += V == 2 ? (int)(ar[i] ^ br[j]) : __popc(ar[i] ^ br[j]);
            }
        }
    }

    const int col = b0 + cb;
    if (V == 3) {
        int s = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
#pragma unroll
            for (int j = 0; j < kPer; ++j) s += acc[i][j];
        }
        if (a0 + ra < n_a && col < n_b) out[(int64_t)(a0 + ra) * n_b + col] = s;
        return;
    }
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

constexpr int kRateChains = 8;  // independent accumulator chains per warp

// Each warp issues iters * kRateChains mma.sync; out keeps the sums alive.
__global__ void __launch_bounds__(256)
mma_rate_kernel(int32_t* __restrict__ out, int iters) {
    const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;
    const uint32_t a[4] = {x, x ^ 0x9e3779b9u, x * 3u, x * 5u};
    int c[kRateChains][4] = {};
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < kRateChains; ++k) {
            hamming::mma_and_popc(c[k], a, x + k, x ^ (uint32_t)k);
        }
    }
    int s = 0;
#pragma unroll
    for (int k = 0; k < kRateChains; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// As hamming_matrix_launch, for variant 0..3 of the scalar kernel.
int scalar_probe_launch(int variant, const void* desc_a, const void* desc_b,
                        void* out, int n_a, int n_b, void* stream) {
    if (n_a <= 0 || n_b <= 0) return 0;
    const dim3 grid((n_b + kTile - 1) / kTile, (n_a + kTile - 1) / kTile);
    const dim3 block(kThreads, kThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* pa = static_cast<const uint32_t*>(desc_a);
    const auto* pb = static_cast<const uint32_t*>(desc_b);
    auto* po = static_cast<int32_t*>(out);
    switch (variant) {
        case 0: scalar_kernel<0><<<grid, block, 0, s>>>(pa, pb, po, n_a, n_b); break;
        case 1: empty_kernel<<<grid, block, 0, s>>>(); break;
        case 2: scalar_kernel<2><<<grid, block, 0, s>>>(pa, pb, po, n_a, n_b); break;
        case 3: scalar_kernel<3><<<grid, block, 0, s>>>(pa, pb, po, n_a, n_b); break;
        default: return -1;
    }
    return static_cast<int>(cudaGetLastError());
}

// An empty kernel of any grid: the floor under a kernel with that grid.
int empty_launch(int grid_x, int grid_y, int threads, void* stream) {
    empty_kernel<<<dim3(grid_x, grid_y), threads, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

// blocks x 256 threads, each warp iters * 8 mma.sync; out: [blocks * 256] int32.
int mma_rate_launch(void* out, int blocks, int iters, void* stream) {
    mma_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(out), iters);
    return static_cast<int>(cudaGetLastError());
}

int mma_rate_chains() { return kRateChains; }

}  // extern "C"
