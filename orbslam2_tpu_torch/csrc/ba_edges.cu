// The BA solver's per-edge linearization, for Hopper (sm_90a).
//
// What it computes (ops/ba.py `_edge_terms`, ops/cuda_kernels.py
// `ba_edges`): for each observation edge e of camera c = cam(e) (Tcw =
// [R | t], [3, 4]) and world point X = pts[pt(e)], observed at (u, v, u_r)
// with information `info` (1/sigma^2), stereo or monocular,
//
//   pc    = R X + t, z = pc.z, iz = 1 / (|z| > 1e-6 ? z : 1e-6)
//   res   = (fx x iz + cx - u, fy y iz + cy - v, stereo ? fx x iz + cx - bf iz - u_r : 0)
//   chi2  = |res|^2 info, the Huber weight w (1 without the robust kernel),
//           rho the (robust) cost of chi2
//   m     = (active && z > min_depth && chi2 < chi2_trim) w info
//   cost  = active && z > min_depth ? min(rho, chi2_trim) : 0
//   Jp    [3, 6]: d res / d (left twist [v, w] of Tcw) = J_pc [I | [pc]x]
//   Jpt   [3, 3]: d res / d X = J_pc R
//
// and, in the "blocks" mode, each edge's terms of the normal equations:
// Hcc_e = (Jp m)^T Jp [6, 6], bc_e = -(Jp m)^T res [6], Hpp_e = (Jpt m)^T
// Jpt [3, 3], bp_e = -(Jpt m)^T res [3], W_e = (Jp m)^T Jpt [6, 3], m and
// cost, in edge order. The "cost" mode writes cost alone (an LM trial
// step's objective) or chi2 and z alone (the outlier classification), and
// forms no Jacobian. An edge with m = 0 gives blocks of zeros.
//
// The JAX package writes it as XLA ops (orbslam2_tpu/ops/ba.py `_edge_terms`
// and `_lm_iteration`'s block products, with ops/ba_core.py): no Pallas
// source. The port ran the same composition: gathers of the poses and the
// points, the Jacobians stacked, catted and multiplied by cuBLAS's 32x32
// gemm tiles and batched gemvs over a million 3x3 to 6x6 matrices, every
// intermediate written to device memory between about 131 kernels a call:
// 6.6 ms a call of `_edge_terms` and 10.5 ms of the block products at the
// global BA's shape on an H100. Here one thread an edge keeps the residual,
// the Jacobians and the weights in registers; only the blocks reach device
// memory.
//
// What bounds it is the bytes: an edge's fields read once (the indices as
// int64, the observation, the stereo and active flags, the information:
// 34 bytes) and its blocks written once (Hcc 144, bc 24, Hpp 36, bp 12, W
// 72, m 4, cost 4: 296 bytes); the poses (24 KB at the global BA) and the
// points (786 KB) are gathered from L2. At E = 1,048,576 that is 0.35 GB,
// 103 us at 3.35 TB/s, and 12 us for a trial cost (38 bytes an edge). A
// thread writes its blocks with 16-byte (Hcc) and 8-byte (bc, W) stores
// where their rows' alignment allows.
//
// On an H100 at 700 W, at the global BA's shape (chip_smoke.py phase 3h,
// queued CUDA events): "blocks" 571 us warm and cold, 18% of its byte
// bound, against 15.4 ms for the composition it replaces; "cost" 20.9 us
// (58%) against 1.8 ms. A thread's rows lie 144, 24, 36 and 72 bytes from
// its neighbours', so each warp store touches 32 separate pieces; staging a
// block's rows through shared memory for coalesced stores is untried.
//
// Float32 on the CUDA cores, no fast-math, no atomics: a call repeats
// itself bit for bit. The products round otherwise than cuBLAS's (and than
// the CPU's), so the tests hold the kernel to the plain version within
// float32 rounding of each output's sum of absolute terms.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libba_edges.so ba_edges.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block, an edge each

enum Mode { kBlocksMode = 0, kCostMode = 1 };

// The camera model and the solver's constants, by value.
struct Params {
    float fx, fy, cx, cy, bf;
    float min_depth, chi2_trim;
    float chi2_mono, chi2_stereo;  // the Huber thresholds (squared deltas)
    int robust;                    // 1: Huber weight and cost, 0: plain
};

// The outputs, each [E, ...] float32 in edge order; null where not asked for.
struct Outputs {
    float* hcc;   // [E, 6, 6]
    float* bc;    // [E, 6]
    float* hpp;   // [E, 3, 3]
    float* bp;    // [E, 3]
    float* w;     // [E, 6, 3]
    float* m;     // [E]
    float* cost;  // [E]
    float* chi2;  // [E]
    float* z;     // [E]
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
ba_edges_kernel(const float* __restrict__ cam_T,      // [C, 3, 4], 16-byte aligned
                const float* __restrict__ pts,        // [P, 3]
                const long long* __restrict__ e_cam,  // [E] int64
                const long long* __restrict__ e_pt,   // [E] int64
                const float* __restrict__ e_obs,      // [E, 3] (u, v, u_r)
                const uint8_t* __restrict__ e_stereo, // [E] bool
                const float* __restrict__ e_info,     // [E]
                const uint8_t* __restrict__ e_active, // [E] bool
                const Params q, const Outputs o, const int n) {
    const int e = blockIdx.x * kThreads + threadIdx.x;
    if (e >= n) return;
    const float4* T = reinterpret_cast<const float4*>(cam_T + __ldg(e_cam + e) * 12);
    const float4 T0 = __ldg(T), T1 = __ldg(T + 1), T2 = __ldg(T + 2);
    const float R[3][3] = {{T0.x, T0.y, T0.z}, {T1.x, T1.y, T1.z}, {T2.x, T2.y, T2.z}};
    const float* Xp = pts + __ldg(e_pt + e) * 3;
    const float X0 = __ldg(Xp), X1 = __ldg(Xp + 1), X2 = __ldg(Xp + 2);
    const float x = R[0][0] * X0 + R[0][1] * X1 + R[0][2] * X2 + T0.w;
    const float y = R[1][0] * X0 + R[1][1] * X1 + R[1][2] * X2 + T1.w;
    const float z = R[2][0] * X0 + R[2][1] * X1 + R[2][2] * X2 + T2.w;
    const float iz = 1.0f / (fabsf(z) > 1e-6f ? z : 1e-6f);
    const bool stereo = __ldg(e_stereo + e) != 0;
    const float* ob = e_obs + static_cast<int64_t>(e) * 3;
    const float u = q.fx * x * iz + q.cx;
    const float res[3] = {u - __ldg(ob), q.fy * y * iz + q.cy - __ldg(ob + 1),
                          stereo ? (u - q.bf * iz) - __ldg(ob + 2) : 0.0f};
    const float info = __ldg(e_info + e);
    const float chi2 = (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) * info;
    if (kMode == kCostMode && o.chi2 != nullptr) {
        o.chi2[e] = chi2;
        o.z[e] = z;
    }
    if (kMode == kCostMode && o.cost == nullptr) return;

    // the Huber weight and cost (g2o RobustKernelHuber); comparisons written
    // so that a NaN passes through as the plain version's torch ops pass it
    float w = 1.0f, rho = chi2;
    if (q.robust) {
        const float d2 = stereo ? q.chi2_stereo : q.chi2_mono;
        const float delta = sqrtf(d2);
        const float norm = sqrtf(chi2 < 1e-12f ? 1e-12f : chi2);
        w = norm <= delta ? 1.0f : delta / norm;
        rho = chi2 <= d2 ? chi2 : 2.0f * delta * norm - d2;
    }
    const bool seen = __ldg(e_active + e) != 0 && z > q.min_depth;
    const float cost = seen ? (rho > q.chi2_trim ? q.chi2_trim : rho) : 0.0f;
    o.cost[e] = cost;
    if (kMode == kCostMode) return;

    const float m = ((seen && chi2 < q.chi2_trim) ? 1.0f : 0.0f) * w * info;
    // J_pc with the clamped depth; [pc]x with the raw one (ops/ba_core.py)
    const float iz2 = iz * iz;
    const float J[3][3] = {
        {q.fx * iz, 0.0f, -q.fx * x * iz2},
        {0.0f, q.fy * iz, -q.fy * y * iz2},
        {stereo ? q.fx * iz : 0.0f, 0.0f, stereo ? -q.fx * x * iz2 + q.bf * iz2 : 0.0f}};
    float Jp[3][6], Jpt[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        Jp[r][0] = J[r][0];
        Jp[r][1] = J[r][1];
        Jp[r][2] = J[r][2];
        Jp[r][3] = J[r][2] * y - J[r][1] * z;
        Jp[r][4] = J[r][0] * z - J[r][2] * x;
        Jp[r][5] = J[r][1] * x - J[r][0] * y;
#pragma unroll
        for (int k = 0; k < 3; ++k)
            Jpt[r][k] = J[r][0] * R[0][k] + J[r][1] * R[1][k] + J[r][2] * R[2][k];
    }
    float a[3][6], at[3][3];  // the rows weighted by m
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int i = 0; i < 6; ++i) a[r][i] = Jp[r][i] * m;
#pragma unroll
        for (int k = 0; k < 3; ++k) at[r][k] = Jpt[r][k] * m;
    }

    const int64_t e64 = e;
    float4* hcc = reinterpret_cast<float4*>(o.hcc + e64 * 36);
#pragma unroll
    for (int q4 = 0; q4 < 9; ++q4) {  // Hcc_e row-major, 4 entries a store
        float v[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int i = (4 * q4 + s) / 6, j = (4 * q4 + s) % 6;
            v[s] = a[0][i] * Jp[0][j] + a[1][i] * Jp[1][j] + a[2][i] * Jp[2][j];
        }
        hcc[q4] = make_float4(v[0], v[1], v[2], v[3]);
    }
    float2* bc = reinterpret_cast<float2*>(o.bc + e64 * 6);
#pragma unroll
    for (int i = 0; i < 6; i += 2)
        bc[i / 2] = make_float2(-(a[0][i] * res[0] + a[1][i] * res[1] + a[2][i] * res[2]),
                                -(a[0][i + 1] * res[0] + a[1][i + 1] * res[1] +
                                  a[2][i + 1] * res[2]));
    float2* wr = reinterpret_cast<float2*>(o.w + e64 * 18);
#pragma unroll
    for (int q2 = 0; q2 < 9; ++q2) {  // W_e row-major, 2 entries a store
        float v[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = (2 * q2 + s) / 3, k = (2 * q2 + s) % 3;
            v[s] = a[0][i] * Jpt[0][k] + a[1][i] * Jpt[1][k] + a[2][i] * Jpt[2][k];
        }
        wr[q2] = make_float2(v[0], v[1]);
    }
    float* hpp = o.hpp + e64 * 9;
    float* bp = o.bp + e64 * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int l = 0; l < 3; ++l)
            hpp[3 * k + l] = at[0][k] * Jpt[0][l] + at[1][k] * Jpt[1][l] + at[2][k] * Jpt[2][l];
        bp[k] = -(at[0][k] * res[0] + at[1][k] * res[1] + at[2][k] * res[2]);
    }
    o.m[e] = m;
}

}  // namespace

// One call on `stream`. mode 0 ("blocks"): every output but chi2 and z;
// mode 1 ("cost"): cost, or chi2 and z, each pair null where not asked for.
// intr = (fx, fy, cx, cy, bf), consts = (min_depth, chi2_trim, chi2_mono,
// chi2_stereo). cam_T [C, 3, 4] 16-byte aligned, pts [P, 3], e_cam and e_pt
// int64 [E] (each index in range: not checked), e_obs [E, 3], e_stereo and
// e_active bool [E], e_info [E]; hcc 16-byte aligned, bc and w 8-byte
// aligned; every tensor contiguous, E < 2^31. Grid: a block of kThreads a
// kThreads edges. Returns the CUDA error of the launch (0: launched, or
// nothing to do).
extern "C" int ba_edges_launch(int mode, const void* cam_T, const void* pts,
                               const void* e_cam, const void* e_pt, const void* e_obs,
                               const void* e_stereo, const void* e_info,
                               const void* e_active, const float* intr, const float* consts,
                               int robust, void* hcc, void* bc, void* hpp, void* bp,
                               void* w, void* m, void* cost, void* chi2, void* z, int n,
                               void* stream) {
    if (n < 0 || (mode != kBlocksMode && mode != kCostMode))
        return static_cast<int>(cudaErrorInvalidValue);
    if (mode == kBlocksMode && (hcc == nullptr || bc == nullptr || hpp == nullptr ||
                                bp == nullptr || w == nullptr || m == nullptr ||
                                cost == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (mode == kCostMode && (chi2 == nullptr) != (z == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const Params q{intr[0],   intr[1],   intr[2],   intr[3],   intr[4],
                   consts[0], consts[1], consts[2], consts[3], robust != 0};
    const Outputs o{static_cast<float*>(hcc), static_cast<float*>(bc),
                    static_cast<float*>(hpp), static_cast<float*>(bp),
                    static_cast<float*>(w),   static_cast<float*>(m),
                    static_cast<float*>(cost), static_cast<float*>(chi2),
                    static_cast<float*>(z)};
    const auto ct = static_cast<const float*>(cam_T);
    const auto pt = static_cast<const float*>(pts);
    const auto ec = static_cast<const long long*>(e_cam);
    const auto ep = static_cast<const long long*>(e_pt);
    const auto eo = static_cast<const float*>(e_obs);
    const auto es = static_cast<const uint8_t*>(e_stereo);
    const auto ei = static_cast<const float*>(e_info);
    const auto ea = static_cast<const uint8_t*>(e_active);
    const int grid = (n + kThreads - 1) / kThreads;
    const auto cs = static_cast<cudaStream_t>(stream);
    if (mode == kBlocksMode)
        ba_edges_kernel<kBlocksMode><<<grid, kThreads, 0, cs>>>(ct, pt, ec, ep, eo, es, ei,
                                                                ea, q, o, n);
    else
        ba_edges_kernel<kCostMode><<<grid, kThreads, 0, cs>>>(ct, pt, ec, ep, eo, es, ei, ea,
                                                              q, o, n);
    return static_cast<int>(cudaGetLastError());
}
