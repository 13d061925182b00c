// Tile arithmetic shared by the two Hamming kernels (hamming.cu,
// hamming_best2.cu): Hamming distances of 256-bit descriptors on Hopper's
// tensor cores.
//
// A descriptor is 256 bits, exactly the depth of the single-bit
// mma.sync.m16n8k256 instruction, which gives a 16x8 tile of popc(a & b) per
// warp instruction. The distance is taken as
//     popc(a ^ b) = popc(a & ~b) + popc(~a & b):
// two .and.popc instructions that accumulate into the same registers, no
// epilogue and no __popc at all (the scalar __popc issues at a quarter of
// the integer rate, 8 a pair; that issue rate, not the bytes, bounded the
// scalar kernel). Measured on an H100 (utils/probe_hamming.py; PERF.md):
// .and.popc runs at 0.59 instructions a clock and SM, so the 65,536 of a
// [4096, 1024] matrix take under half a microsecond. Two alternatives were
// timed in the same calls and lost: one .and.popc with popc(a) + popc(b) -
// 2 popc(a & b) as an epilogue (row and column popcounts by __popc and warp
// shuffles), and the one-instruction .xor.popc form, which nvcc 12.8 still
// assembles for sm_90a and which is exact there.
//
// Fragment layout (PTX ISA, m16n8k256 with .b1): lane = 4 g + t.
//   A (16 rows x 256 bits): a0 row g bits 32t.., a1 row g+8 bits 32t..,
//                           a2 row g bits 128+32t.., a3 row g+8 bits 128+32t..
//   B (256 bits x 8 cols):  b0 col g bits 32t.., b1 col g bits 128+32t..
//   C (16 x 8 int32):       c0, c1 row g cols 2t, 2t+1; c2, c3 row g+8.
// popc(a & b) does not care which bit meets which as long as both operands
// use the same order, so lane t feeds the descriptor's words 2t and 2t+1 as
// the k-ranges 32t.. and 128+32t..: one 8-byte load per descriptor and lane,
// the 4 lanes of a group read one descriptor's 32 bytes, a warp 8 descriptors.
//
// The tile's column index is free as well. A chunk is NT tiles side by side
// (8 NT columns), and tile j's column n stands for the chunk's column
//     (n / 2) * 2 NT + 2 j + n % 2,
// so that lane t ends up with 2 NT neighbouring columns, t * 2 NT onwards, of
// rows g and g+8: 16 bytes of int32 output at NT = 2 (hamming.cu's stores),
// 16 bytes of mask at NT = 8 (hamming_best2.cu's loads). chunk_col has this
// order and a second one for output rows that are not 16-byte aligned.
//
// Nothing is staged in shared memory: the descriptors of a call are some
// hundred KB, every block reads all of its B columns through L1 (__ldg),
// and a warp's A rows stay in 8 registers.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hamming {

constexpr int kWords = 8;      // 32-bit words per descriptor
constexpr int kTileRows = 16;  // rows of A per warp (the mma's m)

// Words 2t and 2t+1 of descriptor `row`; zeros past the edge.
__device__ __forceinline__ uint2 load_words(const uint32_t* __restrict__ desc,
                                            int row, int n_rows, int t) {
    if (row >= n_rows) return make_uint2(0u, 0u);
    return __ldg(reinterpret_cast<const uint2*>(desc + (int64_t)row * kWords) + t);
}

// c += popc(a & b) over a 16x8 tile, k = 256.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 rows of A as mma fragments, plain and complemented.
struct RowFrag {
    uint32_t a[4];
    uint32_t na[4];
};

// Rows row0 .. row0+15 (rows past n_a read as zero; their outputs are never
// stored).
__device__ __forceinline__ RowFrag load_rows(const uint32_t* __restrict__ a,
                                             int row0, int n_a, int g, int t) {
    const uint2 lo = load_words(a, row0 + g, n_a, t);
    const uint2 hi = load_words(a, row0 + g + 8, n_a, t);
    RowFrag f;
    f.a[0] = lo.x; f.a[1] = hi.x; f.a[2] = lo.y; f.a[3] = hi.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) f.na[i] = ~f.a[i];
    return f;
}

// Column of the chunk that tile j's column n stands for.
// LANE_RUNS: lane t ends up with the 2 NT neighbouring columns t * 2 NT + e.
// Otherwise: for each of its registers e = 2 j + i, the 4 lanes of a group
// hold the 4 neighbouring columns 8 j + 4 i + t (for 4-byte stores to rows
// that are not 16-byte aligned).
template <int NT, bool LANE_RUNS>
__device__ __forceinline__ int chunk_col(int j, int n) {
    return LANE_RUNS ? (n >> 1) * (2 * NT) + 2 * j + (n & 1)
                     : 8 * j + 4 * (n & 1) + (n >> 1);
}

// This lane's share of the chunk's 8 NT descriptors of B, col0 onwards:
// words 2t, 2t+1 of the column that stands at n = g in each tile. Columns
// past n_b read as zeros; the caller does not use their distances.
template <int NT, bool LANE_RUNS = true>
__device__ __forceinline__ void load_cols(const uint32_t* __restrict__ b, int n_b,
                                          int col0, int g, int t, uint2 (&bw)[NT]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        bw[j] = load_words(b, col0 + chunk_col<NT, LANE_RUNS>(j, g), n_b, t);
    }
}

// Distances of the warp's 16 rows to the chunk's 8 NT columns: acc[r][e] is
// row g + 8 r and the column that chunk_col gives lane t's register e.
template <int NT>
__device__ __forceinline__ void hamming_chunk(const RowFrag& f, const uint2 (&bw)[NT],
                                              int (&acc)[2][2 * NT]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        int c[4] = {0, 0, 0, 0};
        mma_and_popc(c, f.a, ~bw[j].x, ~bw[j].y);
        mma_and_popc(c, f.na, bw[j].x, bw[j].y);
        acc[0][2 * j] = c[0];
        acc[0][2 * j + 1] = c[1];
        acc[1][2 * j] = c[2];
        acc[1][2 * j + 1] = c[3];
    }
}

}  // namespace hamming
