// Dense Hamming-distance matrix of 256-bit ORB descriptors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel orbslam2_tpu/ops/pallas_kernels.py
// `hamming_matrix_pallas` (body `_hamming_kernel`): for every pair (a, b),
// XOR the 8 descriptor words, popcount each and sum. The TPU kernel works in
// 256x256 VMEM tiles and needs A and B to be multiples of 256; this kernel
// takes any A and B and masks the ragged edge itself.
//
// What bounds it on the card. The bytes: the [A, B] int32 output, 16.8 MB at
// the local-map shape [4096, 1024] against 160 KB of input. The operations:
// on the scalar pipes a pair costs 8 __popc, which issue at 16 a clock and
// SM, a quarter of the integer rate, and that issue time (not the stores)
// held the first, scalar version of this kernel at twice its byte bound
// (PERF.md has the measurements that separate the two). So the arithmetic
// runs on the tensor cores instead (hamming_tile.cuh: two single-bit
// mma.sync per 16x8 tile, no __popc), and what is left is the stores.
//
// Layout: a block of 4 warps computes a 64x64 output tile, one warp 16 rows.
// The warp keeps its rows as mma fragments in registers and walks the 64
// columns in chunks of 16; the column order inside a chunk is chosen
// (hamming_tile.cuh) so that a lane holds 4 neighbouring columns of rows g and
// g+8 and stores each as one 16-byte int4: the 4 lanes of a group write 64
// contiguous bytes of a row, a warp store 8 such segments, every 32-byte
// sector whole. Where n_b is no multiple of 4 the rows are not 16-byte
// aligned: the stores are 4-byte then, and a second column order puts the 4
// lanes of a group on 4 neighbouring columns per register. No shared memory
// and no __syncthreads. [1024, 1024] gives 256 blocks (1024 warps),
// [4096, 1024] gives 1024.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhamming.so hamming.cu

#include <cstdint>
#include <cuda_runtime.h>

#include "hamming_tile.cuh"

namespace {

constexpr int kWarps = 4;                               // warps per block
constexpr int kBlockRows = kWarps * hamming::kTileRows;  // 64
constexpr int kBlockCols = 64;
constexpr int kNT = 2;               // mma tiles per chunk: 4 columns a lane
constexpr int kChunkCols = 8 * kNT;  // 16

__global__ void __launch_bounds__(kWarps * 32)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n_a, int n_b) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = blockIdx.x * kBlockRows + (threadIdx.x >> 5) * hamming::kTileRows;
    if (row0 >= n_a) return;  // the whole warp
    const hamming::RowFrag fa = hamming::load_rows(a, row0, n_a, g, t);
    // A row starts 16-byte aligned iff n_b is a multiple of 4 (the output
    // comes from torch.empty, whose base is at least 256-byte aligned).
    const bool vec = (n_b % 4) == 0;

    if (vec) {
#pragma unroll
        for (int c = 0; c < kBlockCols / kChunkCols; ++c) {
            const int col0 = blockIdx.y * kBlockCols + c * kChunkCols;
            if (col0 >= n_b) break;  // the whole warp
            uint2 bw[kNT];
            int acc[2][2 * kNT];
            hamming::load_cols<kNT, true>(b, n_b, col0, g, t, bw);
            hamming::hamming_chunk<kNT>(fa, bw, acc);
            const int col = col0 + t * 2 * kNT;  // first of this lane's 4 columns
            if (col >= n_b) continue;            // else col + 4 <= n_b as well
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = row0 + g + 8 * r;
                if (row >= n_a) continue;
                *reinterpret_cast<int4*>(out + (int64_t)row * n_b + col) =
                    make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            }
        }
    } else {
        // 4-byte stores: register e of the group's 4 lanes covers 4
        // neighbouring columns, so a warp store writes 8 runs of 16 bytes
#pragma unroll
        for (int c = 0; c < kBlockCols / kChunkCols; ++c) {
            const int col0 = blockIdx.y * kBlockCols + c * kChunkCols;
            if (col0 >= n_b) break;  // the whole warp
            uint2 bw[kNT];
            int acc[2][2 * kNT];
            hamming::load_cols<kNT, false>(b, n_b, col0, g, t, bw);
            hamming::hamming_chunk<kNT>(fa, bw, acc);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = row0 + g + 8 * r;
                if (row >= n_a) continue;
#pragma unroll
                for (int e = 0; e < 2 * kNT; ++e) {
                    const int col = col0 + 4 * e + t;  // chunk_col<kNT, false>
                    if (col < n_b) out[(int64_t)row * n_b + col] = acc[r][e];
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// desc_a: [n_a, 8] int32 bit-views of the u32 words; desc_b: [n_b, 8];
// out: [n_a, n_b] int32, n_b <= 1 << 22. All contiguous, the descriptors
// 8-byte and out 16-byte aligned, on the current device. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not sync.
int hamming_matrix_launch(const void* desc_a, const void* desc_b, void* out,
                          int n_a, int n_b, void* stream) {
    if (n_a <= 0 || n_b <= 0) return 0;
    // row tiles on x (no limit that matters), column tiles on y (<= 65535)
    const dim3 grid((n_a + kBlockRows - 1) / kBlockRows,
                    (n_b + kBlockCols - 1) / kBlockCols);
    hamming_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(desc_a),
        static_cast<const uint32_t*>(desc_b), static_cast<int32_t*>(out), n_a,
        n_b);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
