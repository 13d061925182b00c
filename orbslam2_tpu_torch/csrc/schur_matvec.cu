// The BA solver's CG matvec: the reduced camera system's Schur product,
// order-fixed, for Hopper (sm_90a).
//
// What it computes (ops/ba.py `_schur_mv`, ops/cuda_kernels.py
// `schur_matvec`): for x [C, 6] (the CG search direction), the camera mask
// f [C] (1 for a free camera, else 0), W [E, 6, 3] (each edge's
// camera-point coupling), Hpp^-1 [P, 3, 3] and Hcc [C, 6, 6], with
// x_m = x f,
//
//   wp[p] = Hpp^-1[p] (sum over the edges e of point p of W_e^T x_m[cam(e)])
//   s[c]  = sum over the edges e of camera c of W_e wp[pt(e)]
//   y[c]  = (Hcc[c] x_m[c] - s[c]) f[c]
//
// y is S x, the reduced camera system's product. A rank of a sharded solve
// passes no Hcc and takes s alone, since the ranks' s are added up first.
// The JAX package writes it as a mask, two gathers, four batched einsums
// and two `jax.ops.segment_sum`s (orbslam2_tpu/ops/ba.py:161, `S_mv` in
// `_pcg`), which the port ran the same way: cuBLAS's strided-batched gemv
// over a million 6x3 matrices, the [E, 3] and [E, 6] products written out
// between kernels, two `seg_sum`s: 44 kernels and 2.5 ms a step at the
// global BA's shape on an H100. Here it is two kernels that keep every
// per-edge product on chip.
//
// Add order. Each sum adds its rows in increasing edge order within its
// segment, from 0.0, the order of `seg_sum` (csrc/seg_sum.cu) and of the
// plain version's `index_add_` on the CPU. Each per-edge product is written
// out in one fixed order: u_e[j] = W[0][j] x0, then fmaf over i = 1..5;
// ze_e[i] = W[i][0] wp0, then fmaf over j = 1, 2; wp[p][i] = Hinv[i][0] a0,
// then fmaf over j = 1, 2; (Hcc x)[i] = Hcc[i][0] x0, then fmaf over
// j = 1..5. No atomics and no fast-math, so a CG solve on the
// card repeats itself bit for bit. The products round otherwise than
// cuBLAS's, so the card's result is not the CPU's bit for bit: the tests
// hold it to the plain version within float32 rounding.
//
// The order comes from the two segment-sum plans of the solve
// (ops/cuda_kernels.py `SchurPlan`): by point (`pt`, 16 rows a segment on
// average at the global BA) and by camera (`cam`, 2,048). Each pass reads
// its rows in its plan's order, so nothing is gathered through a perm: W's
// rows are copied into both orders once an LM iteration (`schur_terms`,
// with Hpp^-1 made contiguous; the 24 CG steps share them), and each row's
// other index (`pt_cam`, `cam_pt`, int32) once a solve. What bounds the pair is the bytes: W's 72
// bytes a row, read once a pass.
//
// - Point pass: a block owns kPoints points, whose rows are contiguous in
//   the plan, and walks them in tiles of kThreads rows: each thread makes
//   u_e of one row into shared memory, then the 3 column threads of each
//   point add the tile's rows of their point in order, carrying their sum
//   from tile to tile. Last, each point's 3 sums go through Hpp^-1 and out.
// - Camera pass: a block owns a camera and walks its segment in tiles of
//   kThreads rows: each thread makes ze_e of one row into shared memory,
//   then 6 column threads add the tile in row order (the long path of
//   seg_sum, with the rows made in place of loaded). Two tile buffers let
//   the next tile's rows be made while the column threads add. Last, each
//   column thread forms its row of Hcc x and writes y (or s alone).
//
// On an H100 at 700 W, at the global BA's shape (C = 512, P = 65,536,
// E = 1,048,576; chip_smoke.py phase 3g, queued CUDA events, S x): the point
// pass 36.7 us (83.1 MB each read or written once: 24.8 us, 68% of the
// byte bound at 3.35 TB/s), the camera pass 48.5 us (80.6 MB: 24.1 us,
// 50%), the pair 86.0 us warm and 86.2 cold (162.1 MB: 48.4 us, 56%),
// against 2,479 us for the einsums and seg_sums it replaces. In a call
// where this layout read 91 us, the pair read through the plans' perm from
// W in edge order took 155 us, with only the other index in plan order 138,
// with only W 109 (the copies take 187 to 194 us an LM iteration). Each
// thread loads its own 72-byte row in 8-byte words; a tile first copied
// into shared memory by coalesced loads took 99 us against this layout's 85.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libschur_matvec.so schur_matvec.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block, rows a tile
constexpr int kPoints = 64;    // point pass: points a block, 3 column threads each
constexpr int kRow = 18;       // floats of a W row (6 x 3)

enum Pass { kPointPass = 0, kCamPass = 1 };

// Row k of W, 18 floats, by 8-byte loads (a row is 72 bytes).
__device__ __forceinline__ void load_row(const float* __restrict__ w, int k,
                                         float (&v)[kRow]) {
    const float2* r = reinterpret_cast<const float2*>(w + static_cast<int64_t>(k) * kRow);
#pragma unroll
    for (int q = 0; q < kRow / 2; ++q) {
        const float2 t = __ldg(r + q);
        v[2 * q] = t.x;
        v[2 * q + 1] = t.y;
    }
}

__global__ void __launch_bounds__(kThreads)
point_pass_kernel(const float* __restrict__ w,          // [E, 6, 3] in the plan's order
                  const int32_t* __restrict__ offsets,  // [P + 1]
                  const int32_t* __restrict__ cam,      // [E] each row's camera
                  const float* __restrict__ x,          // [C, 6]
                  const float* __restrict__ mask,       // [C] 1 for a free camera, else 0
                  const float* __restrict__ hinv,       // [P, 3, 3]
                  float* __restrict__ wp,               // [P, 3]
                  int n_points) {
    __shared__ float u[2][kThreads][3];
    __shared__ float sums[kPoints][3];
    const int tid = threadIdx.x;
    const int p0 = blockIdx.x * kPoints;
    const int np = min(kPoints, n_points - p0);
    const int r0 = __ldg(offsets + p0), r1 = __ldg(offsets + p0 + np);
    // column thread (j, col): point p0 + j, column col
    const int j = tid / 3, col = tid - 3 * (tid / 3);
    const bool owner = j < np;
    const int lo = owner ? __ldg(offsets + p0 + j) : 0;
    const int hi = owner ? __ldg(offsets + p0 + j + 1) : 0;
    float acc = 0.0f;
    int b = 0;
    for (int t0 = r0; t0 < r1; t0 += kThreads, b ^= 1) {
        const int k = t0 + tid;
        if (k < r1) {
            float v[kRow];
            load_row(w, k, v);
            const int c = __ldg(cam + k);
            const float2* xr = reinterpret_cast<const float2*>(x + static_cast<int64_t>(c) * 6);
            const float2 x01 = __ldg(xr), x23 = __ldg(xr + 1), x45 = __ldg(xr + 2);
            const float f = __ldg(mask + c);  // x masked to the free cameras
            const float xs[6] = {x01.x * f, x01.y * f, x23.x * f, x23.y * f, x45.x * f,
                                 x45.y * f};
#pragma unroll
            for (int q = 0; q < 3; ++q) {  // u[q] = sum over i of W[i][q] x[i]
                float s = v[q] * xs[0];
#pragma unroll
                for (int i = 1; i < 6; ++i) s = fmaf(v[3 * i + q], xs[i], s);
                u[b][tid][q] = s;
            }
        }
        __syncthreads();  // the tile's rows made; the tile before it added
        if (owner) {
            const int end = min(hi, t0 + kThreads);
            for (int q = max(lo, t0); q < end; ++q) acc += u[b][q - t0][col];
        }
    }
    if (owner) sums[j][col] = acc;
    __syncthreads();
    if (owner) {
        const int64_t p = p0 + j;
        const float* h = hinv + p * 9 + col * 3;
        float v = __ldg(h) * sums[j][0];
        v = fmaf(__ldg(h + 1), sums[j][1], v);
        v = fmaf(__ldg(h + 2), sums[j][2], v);
        wp[p * 3 + col] = v;
    }
}

__global__ void __launch_bounds__(kThreads)
cam_pass_kernel(const float* __restrict__ w,          // [E, 6, 3] in the plan's order
                const int32_t* __restrict__ offsets,  // [C + 1]
                const int32_t* __restrict__ pt,       // [E] each row's point
                const float* __restrict__ wp,         // [P, 3]
                const float* __restrict__ hcc,        // [C, 6, 6], or null: write s
                const float* __restrict__ x,          // [C, 6]
                const float* __restrict__ mask,       // [C]
                float* __restrict__ out) {            // [C, 6]
    __shared__ float z[2][kThreads][6];
    const int tid = threadIdx.x;
    const int c = blockIdx.x;
    const int r0 = __ldg(offsets + c), r1 = __ldg(offsets + c + 1);
    float acc = 0.0f;
    int b = 0;
    for (int t0 = r0; t0 < r1; t0 += kThreads, b ^= 1) {
        const int k = t0 + tid;
        if (k < r1) {
            float v[kRow];
            load_row(w, k, v);
            const float* wr = wp + static_cast<int64_t>(__ldg(pt + k)) * 3;
            const float w0 = __ldg(wr), w1 = __ldg(wr + 1), w2 = __ldg(wr + 2);
#pragma unroll
            for (int i = 0; i < 6; ++i) {  // ze[i] = sum over j of W[i][j] wp[j]
                float t = v[3 * i] * w0;
                t = fmaf(v[3 * i + 1], w1, t);
                t = fmaf(v[3 * i + 2], w2, t);
                z[b][tid][i] = t;
            }
        }
        __syncthreads();  // the tile's rows made; the tile before it added
        if (tid < 6) {
            const float* colv = &z[b][0][tid];
            const int n = min(kThreads, r1 - t0);
            int r = 0;
            for (; r + 8 <= n; r += 8) {
                float t[8];
#pragma unroll
                for (int q = 0; q < 8; ++q) t[q] = colv[(r + q) * 6];
#pragma unroll
                for (int q = 0; q < 8; ++q) acc += t[q];
            }
            for (; r < n; ++r) acc += colv[r * 6];
        }
    }
    if (tid >= 6) return;
    const int64_t o = static_cast<int64_t>(c) * 6 + tid;
    if (hcc == nullptr) {  // s alone: a rank of a sharded solve adds the ranks' s first
        out[o] = acc;
        return;
    }
    // (Hcc x - s) masked, x masked: hx = Hcc[tid][0] x0, then fmaf over j = 1..5
    const float f = __ldg(mask + c);
    const float* h = hcc + o * 6;
    const float* xc = x + static_cast<int64_t>(c) * 6;
    float hx = __ldg(h) * (__ldg(xc) * f);
#pragma unroll
    for (int j = 1; j < 6; ++j) hx = fmaf(__ldg(h + j), __ldg(xc + j) * f, hx);
    out[o] = (hx - acc) * f;
}

}  // namespace

// One pass of the matvec on `stream`; x [C, 6] and mask [C] (1 for a free
// camera, else 0) for both. pass 0, the point pass: w = W in the point plan's order,
// offsets the point plan's, other = each row's camera, mat = Hpp^-1
// [P, 3, 3], wp unused, out = wp [P, 3], n = P. pass 1, the camera pass:
// w = W in the camera plan's order, offsets the camera plan's, other = each
// row's point, mat = Hcc [C, 6, 6] or null, wp = the point pass's, out =
// [C, 6]: (Hcc x - s) masked, or s where mat is null; n = C. Every tensor
// contiguous, w and x 8-byte aligned, E < 2^31. Grids: the point pass a
// block a kPoints points, the camera pass a block a camera, of kThreads
// threads. Returns the CUDA error of the launch (0: launched, or nothing
// to do).
extern "C" int schur_matvec_launch(int pass, const void* w, const void* offsets,
                                   const void* other, const void* x, const void* mask,
                                   const void* mat, const void* wp, void* out, int n,
                                   void* stream) {
    if (n < 0 || (pass != kPointPass && pass != kCamPass))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const auto ws = static_cast<const float*>(w);
    const auto os = static_cast<const int32_t*>(offsets);
    const auto ot = static_cast<const int32_t*>(other);
    const auto xs = static_cast<const float*>(x);
    const auto fs = static_cast<const float*>(mask);
    const auto ms = static_cast<const float*>(mat);
    const auto out_f = static_cast<float*>(out);
    const auto cs = static_cast<cudaStream_t>(stream);
    if (pass == kPointPass)
        point_pass_kernel<<<(n + kPoints - 1) / kPoints, kThreads, 0, cs>>>(
            ws, os, ot, xs, fs, ms, out_f, n);
    else
        cam_pass_kernel<<<n, kThreads, 0, cs>>>(ws, os, ot, static_cast<const float*>(wp), ms,
                                                 xs, fs, out_f);
    return static_cast<int>(cudaGetLastError());
}
