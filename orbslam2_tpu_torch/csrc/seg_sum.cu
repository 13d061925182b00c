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
// the rows' segment indices and `seg` the sorted indices themselves
// (ops/cuda_kernels.py seg_plan), so a segment adds its rows in increasing
// row order: the order of `index_add_` on the CPU, which loops over the
// rows one after the other. On the same inputs the card's result therefore
// equals the CPU's bit for bit. No fast-math: flushing denormals or
// contracting would change the bits. Every path below changes only how the
// rows reach the adder, never the order of the adds.
//
// Three paths, chosen on the host from the shapes alone (E / n, the rows a
// segment on average: ops/cuda_kernels.py seg_sum_path):
//
// - Long segments (E >= 64 n: the sums by camera, 512 rows a segment).
//   What bounds them is the chain: each output is 512 dependent adds, and
//   a thread that fetches its own rows waits on memory between them (one
//   thread a (segment, column) took 24.5 us warm at the local BA's Hcc, 16
//   segments of 6x6 rows, on an H100 at 700 W; `index_add_` 10.0). Here a
//   block of 128 threads owns a segment and a group of 16 bytes of columns
//   (4 floats or 2 doubles: 9 groups of a 36-float row, so 144 blocks and
//   not 16 work at that shape). All its threads gather the group's slice of
//   128 rows a stage through `perm` into a ring of 4 shared-memory stages
//   with cp.async (16-byte copies where the row and the rows' base are
//   16-byte aligned, a 36-float row being 144 B; else 8 or 4), each
//   thread's perm entry for the next stage loaded behind its copies. The
//   group's column threads add a landed stage in row order while the next
//   stages land: only the adds form a chain, about 4 cycles each, so 512
//   rows cost about 1.2 us at the card's clock whatever the memory does
//   (6.2 us in all at the local BA's Hcc, 10.9 at the global BA's).
// - Sparse plans (E < n: the coupling G, 65,536 rows in 1,048,576
//   segments). What bounds them is the bytes of the output, nearly all
//   zeros (75.5 MB at the global BA's G, 25 us at 3.35 TB/s), and the
//   latency of the few sums between the zeros: a thread a (segment,
//   column), each waiting on its offsets, took 86.8 us there on an H100 at
//   700 W. Here a block owns a tile of `out`: it issues the loads of its
//   rows, zeroes the tile with 16-byte stores while they fly, then, after a
//   barrier, sums the tile's few non-empty segments, driven by the sorted
//   rows: their rows are contiguous in the sorted order, and the thread at
//   a segment's first row (its sorted index differs from the row before's)
//   adds the segment's rows in order. No thread is spent on an empty
//   segment, the sums land on lines the block has just written, and other
//   tiles' fills run while a block waits on its sums (37.5 us; a whole
//   fill, then a pass over the rows, took 44).
// - Short segments (the rest: by point, 4 to 8 rows; the pose graph, about
//   7): one thread a (segment, column), numbered segment-major, so the
//   threads of a segment read one row's D neighbouring values together and
//   write the segment's output row together. A thread walks its segment in
//   chunks of 16 rows, loaded at once, the next chunk's perm entries loaded
//   behind them, then added in order. At these shapes the launch itself is
//   most of the time (4.1 to 4.7 us, an empty kernel 2.0).
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libseg_sum.so seg_sum.cu

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // short and sparse paths
constexpr int kUnroll = 16;        // rows in flight a thread (short, sparse)
constexpr int kBlocksPerSm = 8;    // the grid's cap: 2,048 threads an SM
constexpr int kLongThreads = 128;  // long path: threads a block, rows a stage
constexpr int kStages = 4;         // long path: the ring of stages
constexpr int kGroupBytes = 16;    // long path: a block's columns of a row
constexpr int kTilesPerSm = 16;    // sparse path: tiles of out an SM, about

// the paths; ops/cuda_kernels.py SEG_PATHS names them in this order
enum Path { kShort = 0, kSparse = 1, kLong = 2 };

// x[perm[k], c] added to acc (0 by default) over k in [k, hi), in
// increasing k: kUnroll values loaded at once, the next chunk's perm entries
// behind them, then added in order.
template <typename T>
__device__ __forceinline__ T sum_rows(const T* __restrict__ x,
                                      const int32_t* __restrict__ perm, int k, int hi,
                                      int d, int c, T acc = T(0)) {
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
    return acc;
}

// Short path: one thread a (segment, column). I: the index type of the
// pairs, int32_t whenever their count fits (a 32-bit division by d is a
// third of a 64-bit one).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
seg_sum_short_kernel(const T* __restrict__ x,             // [E, d]
                     const int32_t* __restrict__ perm,    // [E]
                     const int32_t* __restrict__ offsets, // [n + 1]
                     T* __restrict__ out,                 // [n, d]
                     I total, int d) {
    const I stride = static_cast<I>(gridDim.x) * kThreads;
    for (I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; t < total;
         t += stride) {
        const I s = t / d;
        const int c = static_cast<int>(t - s * d);
        out[t] = sum_rows(x, perm, __ldg(offsets + s), __ldg(offsets + s + 1), d, c);
    }
}

// Sparse path: block b owns a tile of `tile` 16-byte words of out (the
// first tile also the elements before out's first 16-byte boundary, the
// last those after its last). It zeroes the tile with 16-byte stores; then,
// after a barrier, it sums the tile's non-empty segments: the rows of the
// segments that overlap the tile are contiguous in the sorted order,
// [offsets[first], offsets[last + 1]), and a thread a (row, column) whose
// row is its segment's first (its sorted index differs from the row
// before's) and whose element lies in the tile adds the segment's rows in
// order and overwrites the zero. A thread takes kRowBatch such pairs at
// once and loads, for all of them, the sorted indices around the row and
// the row's perm entry, then the values: a segment of one row (most of
// them) costs two trips to memory, and the first batch's trips overlap the
// fill's stores.
constexpr int kRowBatch = 4;

template <typename T>
struct RowBatch {
    int k[kRowBatch], c[kRowBatch], s[kRowBatch], before[kRowBatch], after[kRowBatch],
        p[kRowBatch];
    T v[kRowBatch];
};

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
seg_sum_sparse_kernel(const T* __restrict__ x,             // [E, d]
                      const int32_t* __restrict__ perm,    // [E]
                      const int32_t* __restrict__ offsets, // [n + 1]
                      const int32_t* __restrict__ seg,     // [E] sorted indices
                      T* __restrict__ out,                 // [n, d]
                      I head, I n_words, I total, I tile, int d, int e) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    const bool first_tile = blockIdx.x == 0, last_tile = blockIdx.x == gridDim.x - 1;
    const I w0 = static_cast<I>(blockIdx.x) * tile;
    const I w1 = min(w0 + tile, n_words);
    const I e0 = first_tile ? 0 : head + w0 * kPer;
    const I e1 = last_tile ? total : head + w1 * kPer;
    const int k0 = __ldg(offsets + e0 / d);
    const I items = static_cast<I>(__ldg(offsets + (e1 - 1) / d + 1) - k0) * d;

    RowBatch<T> b;
    auto load = [&](I base) {  // the batch's indices and perm entries, then values
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i) {
            const I q = base + i * kThreads + threadIdx.x;
            const bool on = q < items;
            const I r = on ? q / d : 0;
            b.k[i] = k0 + static_cast<int>(r);
            b.c[i] = static_cast<int>(q - r * d);
            b.s[i] = on ? __ldg(seg + b.k[i]) : -1;
            b.before[i] = on && b.k[i] > 0 ? __ldg(seg + b.k[i] - 1) : -1;
            b.after[i] = on && b.k[i] + 1 < e ? __ldg(seg + b.k[i] + 1) : -1;
            b.p[i] = on ? __ldg(perm + b.k[i]) : 0;
        }
    };
    auto finish = [&]() {  // the sums of the batch's first rows
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i)
            b.v[i] = b.s[i] >= 0 ? __ldg(x + static_cast<int64_t>(b.p[i]) * d + b.c[i]) : T(0);
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i) {
            const I el = static_cast<I>(b.s[i]) * d + b.c[i];
            if (b.s[i] < 0 || b.before[i] == b.s[i] || el < e0 || el >= e1) continue;
            T acc = T(0) + b.v[i];
            if (b.after[i] == b.s[i])
                acc = sum_rows(x, perm, b.k[i] + 1, __ldg(offsets + b.s[i] + 1), d, b.c[i], acc);
            out[el] = acc;
        }
    };

    load(0);
    uint4* body = reinterpret_cast<uint4*>(out + head);
    for (I w = w0 + threadIdx.x; w < w1; w += kThreads) body[w] = make_uint4(0, 0, 0, 0);
    if (first_tile && threadIdx.x < head) out[threadIdx.x] = T(0);
    const I tail = head + n_words * kPer + threadIdx.x;
    if (last_tile && tail < total) out[tail] = T(0);
    __syncthreads();  // the block's zeros before its sums
    finish();
    for (I base = kThreads * kRowBatch; base < items; base += kThreads * kRowBatch) {
        load(base);
        finish();
    }
}

template <int U>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (U == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
                     "n"(U)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Long path: block b owns segment b / groups and the 16 bytes of columns
// (b % groups) of each of its rows. U: the bytes of one cp.async copy, which
// divides the row's bytes and the rows' alignment.
template <typename T, int U>
__global__ void __launch_bounds__(kLongThreads)
seg_sum_long_kernel(const T* __restrict__ x,             // [E, d]
                    const int32_t* __restrict__ perm,    // [E]
                    const int32_t* __restrict__ offsets, // [n + 1]
                    T* __restrict__ out,                 // [n, d]
                    int d, int groups) {
    constexpr int kCols = kGroupBytes / static_cast<int>(sizeof(T));
    constexpr int kCopies = kGroupBytes / U;  // copies a row, at most
    __shared__ __align__(16) T stage[kStages][kLongThreads][kCols];

    const int s = static_cast<int>(blockIdx.x / groups);
    const int c0 = static_cast<int>(blockIdx.x - static_cast<unsigned>(s) * groups) * kCols;
    const int w = min(kCols, d - c0);                          // the group's columns
    const int copies = w * static_cast<int>(sizeof(T)) / U;    // its copies a row
    const int lo = __ldg(offsets + s);
    const int len = __ldg(offsets + s + 1) - lo;
    const int chunks = (len + kLongThreads - 1) / kLongThreads;
    const int tid = threadIdx.x;
    const char* base = reinterpret_cast<const char*>(x + c0);
    const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);

    // p: this thread's perm entry of the next stage to issue
    int p = tid < len ? __ldg(perm + lo + tid) : 0;
    auto issue = [&](int j) {
        const int r = j * kLongThreads + tid;
        if (r < len) {
            const char* src = base + static_cast<int64_t>(p) * row_bytes;
            char* dst = reinterpret_cast<char*>(&stage[j % kStages][tid][0]);
#pragma unroll
            for (int u = 0; u < kCopies; ++u)
                if (u < copies) cp_async<U>(dst + u * U, src + u * U);
        }
        if (r + kLongThreads < len) p = __ldg(perm + lo + r + kLongThreads);
        cp_async_commit();  // one group a stage, empty or not
    };

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) issue(j);
    T acc = T(0);
    for (int i = 0; i < chunks; ++i) {
        cp_async_wait<kStages - 2>();  // this thread's copies of stage i landed
        __syncthreads();               // everyone's; and stage i - 1 is added
        issue(i + kStages - 1);        // into stage i - 1's slot
        if (tid < w) {
            const T* col = &stage[i % kStages][0][tid];
            const int rows = min(kLongThreads, len - i * kLongThreads);
            int r = 0;
            for (; r + 8 <= rows; r += 8) {
                T v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) v[u] = col[(r + u) * kCols];
#pragma unroll
                for (int u = 0; u < 8; ++u) acc += v[u];
            }
            for (; r < rows; ++r) acc += col[r * kCols];
        }
    }
    cp_async_wait<0>();
    if (tid < w) out[static_cast<int64_t>(s) * d + c0 + tid] = acc;
}

// The grid of each path: blocks (threads a block on the path: kThreads,
// kThreads, kLongThreads). One place, which both the launches and
// `seg_sum_grid` read.
int64_t short_blocks(int64_t total, int sms) {
    return std::min<int64_t>((total + kThreads - 1) / kThreads, kBlocksPerSm * sms);
}

// the sparse path's elements before out's first 16-byte boundary, its
// 16-byte words, its tile of words and its tiles
struct SparseGrid {
    int64_t head, n_words, tile, tiles;
};

SparseGrid sparse_grid(int64_t total, uintptr_t out_addr, int elem_bytes, int sms) {
    const int64_t per = 16 / elem_bytes;
    SparseGrid g;
    g.head = std::min<int64_t>(total, ((16 - out_addr % 16) % 16) / elem_bytes);
    g.n_words = (total - g.head) / per;
    // about kTilesPerSm tiles an SM, of 2 to 16 words a thread (on an H100
    // at 700 W the global BA's G took 37.5 us at 2,048 to 4,096 words a tile,
    // 43 at 1,024 or 8,192; the local BA's 4.8 at 512, 6 at 1,024)
    g.tile = std::min<int64_t>(
        16 * kThreads, std::max<int64_t>(2 * kThreads, g.n_words / (kTilesPerSm * sms)));
    g.tiles = std::max<int64_t>(1, (g.n_words + g.tile - 1) / g.tile);
    return g;
}

int64_t long_blocks(int n, int d, int elem_bytes) {
    const int cols = kGroupBytes / elem_bytes;
    return static_cast<int64_t>(n) * ((d + cols - 1) / cols);
}

template <typename T>
int launch_short(const T* x, const int32_t* perm, const int32_t* offsets, T* out,
                 int n, int d, int sms, cudaStream_t cs) {
    const int64_t total = static_cast<int64_t>(n) * d;
    const int grid = static_cast<int>(short_blocks(total, sms));
    if (total + static_cast<int64_t>(grid) * kThreads <= 0x7fffffff)
        seg_sum_short_kernel<T, int32_t><<<grid, kThreads, 0, cs>>>(
            x, perm, offsets, out, static_cast<int32_t>(total), d);
    else
        seg_sum_short_kernel<T, int64_t><<<grid, kThreads, 0, cs>>>(x, perm, offsets, out,
                                                                   total, d);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sparse(const T* x, const int32_t* perm, const int32_t* offsets,
                  const int32_t* seg, T* out, int n, int d, int e, int sms,
                  cudaStream_t cs) {
    const int64_t total = static_cast<int64_t>(n) * d;
    const SparseGrid g = sparse_grid(total, reinterpret_cast<uintptr_t>(out),
                                     static_cast<int>(sizeof(T)), sms);
    const int64_t head = g.head, n_words = g.n_words, tile = g.tile;
    if (g.tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const auto grid = static_cast<unsigned>(g.tiles);
    const int64_t span = static_cast<int64_t>(kThreads) * kRowBatch;
    if (total + tile <= 0x7fffffff && static_cast<int64_t>(e) * d + span <= 0x7fffffff)
        seg_sum_sparse_kernel<T, int32_t><<<grid, kThreads, 0, cs>>>(
            x, perm, offsets, seg, out, static_cast<int32_t>(head),
            static_cast<int32_t>(n_words), static_cast<int32_t>(total),
            static_cast<int32_t>(tile), d, e);
    else
        seg_sum_sparse_kernel<T, int64_t><<<grid, kThreads, 0, cs>>>(
            x, perm, offsets, seg, out, head, n_words, total, tile, d, e);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_long(const T* x, const int32_t* perm, const int32_t* offsets, T* out, int n,
                int d, cudaStream_t cs) {
    constexpr int kCols = kGroupBytes / static_cast<int>(sizeof(T));
    const int groups = (d + kCols - 1) / kCols;
    const int64_t blocks = long_blocks(n, d, static_cast<int>(sizeof(T)));
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    // the widest copy that divides the row's bytes and the rows' alignment
    const auto row = static_cast<uintptr_t>(d) * sizeof(T);
    const auto align = reinterpret_cast<uintptr_t>(x) | row;
    const auto grid = static_cast<unsigned>(blocks);
    if (align % 16 == 0)
        seg_sum_long_kernel<T, 16><<<grid, kLongThreads, 0, cs>>>(x, perm, offsets, out, d,
                                                                  groups);
    else if (align % 8 == 0)
        seg_sum_long_kernel<T, 8><<<grid, kLongThreads, 0, cs>>>(x, perm, offsets, out, d,
                                                                 groups);
    else if constexpr (sizeof(T) == 4)
        seg_sum_long_kernel<T, 4><<<grid, kLongThreads, 0, cs>>>(x, perm, offsets, out, d,
                                                                 groups);
    else
        return static_cast<int>(cudaErrorMisalignedAddress);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* perm, const void* offsets, const void* seg,
           void* out, int n, int d, int e, int path, int sms, void* stream) {
    if (static_cast<int64_t>(n) * d == 0) return 0;
    const auto xs = static_cast<const T*>(x);
    const auto ps = static_cast<const int32_t*>(perm);
    const auto os = static_cast<const int32_t*>(offsets);
    const auto out_t = static_cast<T*>(out);
    const auto cs = static_cast<cudaStream_t>(stream);
    switch (path) {
    case kShort:
        return launch_short(xs, ps, os, out_t, n, d, sms, cs);
    case kSparse:
        return launch_sparse(xs, ps, os, static_cast<const int32_t*>(seg), out_t, n, d, e,
                             sms, cs);
    case kLong:
        return launch_long(xs, ps, os, out_t, n, d, cs);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int device = 0;
        cudaGetDevice(&device);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    return sms;
}

}  // namespace

// x [E, d], perm [E] int32, offsets [n + 1] int32, seg [E] int32 (the sorted
// segment indices, read by the sparse path only), out [n, d], all contiguous
// on the card; elem_bytes 4 (float) or 8 (double); path 0 short, 1 sparse,
// 2 long. Grids: short, a block a 256 (segment, column) pairs, at most
// kBlocksPerSm an SM; sparse, a block a tile of out, about kTilesPerSm an
// SM; long, a block a (segment, 16-byte column group). Returns the CUDA
// error of the launch (0: launched, or nothing to do).
extern "C" int seg_sum_launch(const void* x, const void* perm, const void* offsets,
                              const void* seg, void* out, int n, int d, int e,
                              int elem_bytes, int path, void* stream) {
    const int sms = sm_count();
    if (n < 0 || d < 1 || e < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (elem_bytes == 4)
        return launch<float>(x, perm, offsets, seg, out, n, d, e, path, sms, stream);
    if (elem_bytes == 8)
        return launch<double>(x, perm, offsets, seg, out, n, d, e, path, sms, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The grid seg_sum_launch gives the same arguments (out: its address, which
// places the sparse path's tiles), as *blocks and *threads: 0 blocks when
// it launches nothing. Returns 0, or cudaErrorInvalidValue where
// seg_sum_launch would refuse the arguments.
extern "C" int seg_sum_grid(const void* out, int n, int d, int elem_bytes, int path,
                            int64_t* blocks, int* threads) {
    if (n < 0 || d < 1 || (elem_bytes != 4 && elem_bytes != 8))
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t total = static_cast<int64_t>(n) * d;
    *blocks = 0;
    *threads = path == kLong ? kLongThreads : kThreads;
    if (total == 0) return 0;
    switch (path) {
    case kShort:
        *blocks = short_blocks(total, sm_count());
        return 0;
    case kSparse:
        *blocks = sparse_grid(total, reinterpret_cast<uintptr_t>(out), elem_bytes,
                              sm_count()).tiles;
        return 0;
    case kLong:
        *blocks = long_blocks(n, d, elem_bytes);
        return 0;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}
