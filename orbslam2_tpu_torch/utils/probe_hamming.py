"""What bounds the Hamming kernels on one CUDA device.

    python3 -m orbslam2_tpu_torch.utils.probe_hamming

Builds csrc/hamming_scalar_probe.cu (the scalar-pipe kernel that the
tensor-core design replaced, and its variants) beside the package's two
kernels, and prints, at the three shapes of chip_smoke.py, device times from
CUDA events around calls queued behind a spin kernel (utils/cuda_timing.py):

1. the scalar kernel split into its costs: an empty kernel with its grid
   (the fixed cost of a launch), the stores without the popcounts, the
   popcounts without the stores, and the kernel whole, warm and cold;
2. whether nvcc takes the single-bit mma's .xor.popc form for sm_90a, and
   the rate of the .and.popc form (mma.sync per clock and SM);
3. `hamming_matrix` (exact against its plain version first), warm and cold,
   in the same call as the scalar kernel it replaced;
4. `hamming_best2` (exact first) under the three mask kinds of `best2_cases`,
   warm and cold, beside the unfused pair it replaces (hamming_matrix, then
   the plain masked reduction on the matrix); also at [4096,2048], to show
   how it grows with the pairs, and under the masks of the stereo and the
   monocular-initialization matcher and under the same-node mask of
   `match_by_bow` on the default vocabulary (`best2_path_cases`);
5. `bow_assign` (exact first, against both plain versions, inside guard
   rows) at M = 1024 and 2048 on the default vocabulary, warm and cold,
   beside its empty kernel, its byte bound and its plain version, in turns
   with the kernel it replaced (csrc/bow_assign_twotrip_probe.cu, two
   dependent loads a level) and with its variants (`BOW_VARIANTS`: without
   the shared-memory copy of the top two levels, other block sizes).

`--bow` runs part 5 alone. Every line carries numbers of this run only; the
first line is the card's name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..ops import cuda_kernels as CK
from .cuda_timing import (HBM_BYTES_PER_S, card_line, cold_count, fmt_ms,
                          queued_cold_ms, queued_ms)

SHAPES = ((4096, 1024), (1024, 1024), (1000, 777))
LARGER = (4096, 2048)  # hamming_best2 only
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
GUARD = 64               # guard elements (rows for a matrix) on each side
SENTINEL = 0x5A5A5A5A    # an int32 guard; a bool output's guard bytes: 0xA5
_XOR_POPC = """
__global__ void k(int* out, unsigned a, unsigned b) {
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
        "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%5, %5}, {%0, %1, %2, %3};"
        : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3) : "r"(a), "r"(b));
    out[threadIdx.x] = c0 + c1 + c2 + c3;
}
"""


def descriptors(rng, n: int) -> np.ndarray:
    """[n, 8] random descriptor words as the int32 bit-views the port uses."""
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)


def best2_cases(A: int, B: int, seed: int = 0):
    """Seeded inputs for `hamming_best2`, as (kind, desc_a, desc_b, cand)
    numpy arrays, one per kind of mask:

    sparse  about 1% true: the density a radius gate leaves;
    full    all true;
    edges   desc_b holds every descriptor twice (columns 2k and 2k+1 are
            equal, so every best distance is tied), the mask is 5% true, and
            of every 4 rows one has no candidate, one has exactly one, one
            has exactly one tied pair of columns, one is left as drawn."""
    rng = np.random.default_rng(seed)
    a, b = descriptors(rng, A), descriptors(rng, B)
    yield "sparse", a, b, rng.random((A, B)) < 0.01
    yield "full", a, b, np.ones((A, B), bool)
    b2 = b.copy()
    b2[1::2] = b2[0:B - 1:2]
    cand = rng.random((A, B)) < 0.05
    cand[0::4] = False
    cand[1::4] = False
    one = np.arange(1, A, 4)
    cand[one, rng.integers(0, B, one.size)] = True
    if B >= 2:
        cand[2::4] = False
        pair = np.arange(2, A, 4)
        first = 2 * rng.integers(0, B // 2, pair.size)
        cand[pair, first] = True
        cand[pair, first + 1] = True
    yield "edges", a, b2, cand


def gate_nodes(voc, desc: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Gate node of every descriptor ([n, 8] int32) under vocabulary `voc`,
    from the plain version of `bow_assign` on the CPU."""
    from ..ops.bow import GATE_DEPTH
    tables = (torch.from_numpy(t) for t in voc.device_tables())
    return CK.bow_assign_ref(*tables, torch.from_numpy(desc), torch.from_numpy(valid),
                             voc.levels, GATE_DEPTH)[2].numpy()


def bow_assign_bytes(voc, desc: np.ndarray,
                     valid: np.ndarray) -> tuple[int, int, int]:
    """Bytes of one `bow_assign` call on these descriptors, as (distinct,
    touched, blocks). All count each descriptor (32) and its valid flag (1)
    read and its three outputs (9) written. `distinct` is what the function
    must move: every node that some valid descriptor's descent stands on
    counted once for the whole call, with its word id (4) and, if it is an
    inner node, its row of children (4 k) and the descriptor (32) of every
    child it has; the bound is made from it. `touched` counts a node once
    per descriptor and level that visits it in the JAX layout (the first
    kernel descends invalid rows too): its loads, most of which the L2
    serves. `blocks` is what the same descents read of the children-block
    table: each block they expand once, k rows of 48 bytes."""
    from ..io.vocabulary import _pack_u64, _unpack_bits
    packed = _pack_u64(_unpack_bits(desc))
    node_packed = _pack_u64(_unpack_bits(voc.node_desc))
    n = len(desc)
    nid = np.zeros(n, np.int64)
    touched = n * (32 + 1 + 9)
    stood_on, expanded = [], []
    for _ in range(voc.levels):
        ch = voc.node_children[nid]
        inner = voc.node_word[nid] < 0
        touched += 4 * n + int(inner.sum()) * 4 * voc.k + 32 * int((ch[inner] >= 0).sum())
        stood_on.append(nid[valid])
        expanded.append(nid[valid & inner])
        dist = np.bitwise_count(node_packed[np.clip(ch, 0, None)]
                                ^ packed[:, None, :]).sum(-1, dtype=np.int32)
        dist[ch < 0] = 1 << 20
        step = (ch >= 0).any(-1) & inner
        nid = np.where(step, ch[np.arange(n), dist.argmin(-1)], nid)
    stood_on.append(nid[valid])
    expanded = np.unique(np.concatenate(expanded))
    distinct = (n * (32 + 1 + 9) + 4 * len(np.unique(np.concatenate(stood_on)))
                + 4 * voc.k * len(expanded)
                + 32 * int((voc.node_children[expanded] >= 0).sum()))
    blocks = n * (32 + 1 + 9) + 48 * voc.k * len(expanded)
    return distinct, touched, blocks


def guarded(n: int, dtype: torch.dtype, tail: tuple = ()):
    """(buffer, view): a CUDA buffer of n + 2 GUARD rows of shape `tail`
    filled with the sentinel, and its middle n rows (contiguous, 16-byte
    aligned whenever a row's bytes times GUARD are), to hand a kernel as its
    output. A bool output's buffer is uint8 and the view a bool view of it."""
    store = torch.uint8 if dtype == torch.bool else dtype
    fill = 0xA5 if dtype == torch.bool else SENTINEL
    buf = torch.full((n + 2 * GUARD, *tail), fill, dtype=store, device="cuda")
    view = buf[GUARD:GUARD + n]
    return buf, view.view(torch.bool) if dtype == torch.bool else view


def check_guards(what: str, bufs) -> None:
    """Raise unless every guard row of every (buffer, view) of `guarded`
    still holds its sentinel (after a synchronize)."""
    torch.cuda.synchronize()
    for buf, view in bufs:
        fill = 0xA5 if buf.dtype == torch.uint8 else SENTINEL
        n = view.shape[0]
        for side, rows in (("before", buf[:GUARD]), ("after", buf[GUARD + n:])):
            bad = int((rows != fill).sum())
            if bad:
                raise AssertionError(f"{what}: {bad} guard elements {side} the "
                                     "output were overwritten")


def best2_path_cases(seed: int = 0, voc=None):
    """Seeded inputs for `hamming_best2` at the shapes the stereo, the
    monocular and (given a vocabulary) the relocalization paths give it, as
    (kind, desc_a, desc_b, cand), with keypoints drawn in a 640x480 image:

    stereo-band  [1024, 1024], ops/stereo.stereo_match's mask: the right
                 keypoint within 2 * 1.2^octave rows, within one octave, at
                 a disparity in (0.1, 500], 1000 of 1024 rows valid;
    init-window  [2048, 2048], ops/matching.search_for_initialization's
                 mask: within +-100 px in x and in y (about a tenth of the
                 pairs), 2000 of 2048 rows valid;
    node-gate    [1024, 1024] and node-gate-mono [2048, 1024] (a monocular
                 keyframe is 2048 wide), frontend/matcher.match_by_bow's
                 mask: both features under the same depth-2 node of `voc`,
                 the keyframe's feature bound to a point (3 of 4), the
                 frame's valid (1000 of 1024)."""
    rng = np.random.default_rng(seed)

    def keypoints(n, n_valid):
        xy = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
        # ORB's budget per level falls by 1 / 1.2 a level
        p = 1.2 ** -np.arange(8.0)
        octave = rng.choice(8, n, p=p / p.sum()).astype(np.int32)
        return xy, octave, np.arange(n) < n_valid

    (lxy, loct, lv), (rxy, roct, rv) = keypoints(1024, 1000), keypoints(1024, 1000)
    band = 2.0 * (1.2 ** roct.astype(np.float32))
    d_oct = loct[:, None] - roct[None, :]
    disp = lxy[:, None, 0] - rxy[None, :, 0]
    cand = ((np.abs(lxy[:, None, 1] - rxy[None, :, 1]) <= band[None, :])
            & (np.abs(d_oct) <= 1) & (disp > 0.1) & (disp <= 500.0)
            & lv[:, None] & rv[None, :])
    yield "stereo-band", descriptors(rng, 1024), descriptors(rng, 1024), cand

    (axy, _, av), (bxy, _, bv) = keypoints(2048, 2000), keypoints(2048, 2000)
    dxy = np.abs(axy[:, None, :] - bxy[None, :, :])
    cand = (dxy[..., 0] < 100.0) & (dxy[..., 1] < 100.0) & av[:, None] & bv[None, :]
    yield "init-window", descriptors(rng, 2048), descriptors(rng, 2048), cand

    if voc is None:
        return
    b, bv = descriptors(rng, 1024), np.arange(1024) < 1000
    node_b = gate_nodes(voc, b, bv)
    for kind, n in (("node-gate", 1024), ("node-gate-mono", 2048)):
        a, has_pt = descriptors(rng, n), rng.random(n) < 0.75
        node_a = gate_nodes(voc, a, np.ones(n, bool))
        cand = ((node_a[:, None] == node_b[None, :]) & (node_a >= 0)[:, None]
                & has_pt[:, None] & bv[None, :])
        yield kind, a, b, cand


def xor_popc_compiles() -> tuple[bool, str]:
    """Whether nvcc accepts mma.sync ... .b1 .xor.popc for sm_90a."""
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "xor_popc.cu"
        src.write_text(_XOR_POPC)
        proc = subprocess.run(
            [_build._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-cubin", "-o", str(Path(tmp) / "xor_popc.cubin"), str(src)],
            capture_output=True, text=True, timeout=300)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    return proc.returncode == 0, lines[0] if lines else ""


def twotrip_lib():
    """The first bow_assign kernel (csrc/bow_assign_twotrip_probe.cu):
    bow_assign_twotrip_launch, on the JAX layout of the tree."""
    src = _build.PKG_DIR / "csrc" / "bow_assign_twotrip_probe.cu"
    lib = ctypes.CDLL(str(_build.build_library("bow_assign_twotrip_probe", [src],
                                               "nvcc")))
    lib.bow_assign_twotrip_launch.argtypes = [_PTR] * 8 + [_INT] * 4 + [_PTR]
    return lib


# bow_assign_variant_launch's variants: name, warps a block
BOW_VARIANTS = (("no copy, 4 warps", 4), ("8 warps", 8), ("32 warps", 32))
BOW_WARPS = 16  # the kernel's


def variant_launcher():
    """bow_assign_variant_launch of the package's bow_assign library."""
    fn = ctypes.CDLL(str(CK._library("bow_assign"))).bow_assign_variant_launch
    fn.argtypes = [_INT] + [_PTR] * 6 + [_INT] * 7 + [_PTR]
    return fn


def probe_lib():
    """The probe library: scalar_probe_launch, empty_launch, mma_rate_launch."""
    src = _build.PKG_DIR / "csrc" / "hamming_scalar_probe.cu"
    lib = ctypes.CDLL(str(_build.build_library(
        "hamming_scalar_probe", [src], "nvcc",
        headers=(_build.PKG_DIR / "csrc" / "hamming_tile.cuh",))))
    lib.scalar_probe_launch.argtypes = [_INT, _PTR, _PTR, _PTR, _INT, _INT, _PTR]
    lib.empty_launch.argtypes = [_INT, _INT, _INT, _PTR]
    lib.mma_rate_launch.argtypes = [_PTR, _INT, _INT, _PTR]
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def empty_kernel_ms(lib, grid_x: int, grid_y: int, threads: int) -> float | None:
    """Device time of an empty kernel of that grid (queued events)."""
    return queued_ms(lambda: _check(
        lib.empty_launch(grid_x, grid_y, threads, _stream()), "empty kernel"), reps=20)


def mma_per_second(lib) -> float | None:
    """Rate of mma.sync m16n8k256 .b1 .and.popc over the whole card, from a
    kernel of 4 blocks an SM whose 8 warps each issue 8 independent chains."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 2048
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    ms = queued_ms(lambda: _check(
        lib.mma_rate_launch(out.data_ptr(), blocks, iters, _stream()), "mma rate"), reps=5)
    return None if ms is None else blocks * 8 * iters * lib.mma_rate_chains() / (ms * 1e-3)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def probe_scalar(lib, a, b) -> None:
    A, B = a.shape[0], b.shape[0]
    out_bytes = 4 * A * B
    n_sets = cold_count(out_bytes)
    outs = [torch.empty((A, B), dtype=torch.int32, device="cuda")
            for _ in range(n_sets)]

    def launch(variant, i=0):
        _check(lib.scalar_probe_launch(variant, a.data_ptr(), b.data_ptr(),
                                       outs[i].data_ptr(), A, B, _stream()),
               f"scalar probe variant {variant}")

    launch(0)
    if not torch.equal(outs[0], CK.hamming_matrix_ref(a, b)):
        raise AssertionError(f"scalar kernel disagrees at [{A},{B}]")
    names = ("whole", "empty", "stores, add for popc", "popc, one store a thread")
    warm = [queued_ms(lambda v=v: launch(v), reps=20) for v in range(4)]
    cold = queued_cold_ms(lambda i: launch(0, i), n_sets)
    print(f"scalar kernel [{A},{B}] device ms (queued events, warm): "
          + "; ".join(f"{n} {fmt_ms(t)}" for n, t in zip(names, warm))
          + f"; whole, cold over {n_sets} outputs {fmt_ms(cold)}; byte bound "
          f"{1e3 * (out_bytes + 32 * (A + B)) / HBM_BYTES_PER_S:.4f} ms", flush=True)


def probe_mma_rate(lib) -> None:
    per_s = mma_per_second(lib)
    if per_s is None:
        print("mma rate: not measured", flush=True)
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"mma.sync m16n8k256 b1 and.popc: {per_s:.4g} a second, "
          f"{per_s * 16 * 8 * 256 * 2 / 1e12:.1f} Tbitop/s, "
          f"{per_s / sms / clock_hz:.3f} per SM and clock at the card's maximum "
          f"SM clock of {clock_hz / 1e6:.0f} MHz", flush=True)


def probe_matrix(a, b) -> None:
    A, B = a.shape[0], b.shape[0]
    got = CK.hamming_matrix(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got, CK.hamming_matrix_ref(a, b)):
        raise AssertionError(f"hamming_matrix disagrees at [{A},{B}]")
    n_sets = cold_count(4 * A * B)
    keep = []
    warm = queued_ms(lambda: CK.hamming_matrix(a, b), reps=20)
    cold = queued_ms(lambda: keep.append(CK.hamming_matrix(a, b)), reps=n_sets)
    print(f"hamming_matrix [{A},{B}] exact; device ms (queued events): warm "
          f"{fmt_ms(warm)}, cold over {n_sets} kept outputs {fmt_ms(cold)}",
          flush=True)


def probe_best2(cases) -> None:
    for kind, a_np, b_np, cand_np in cases:
        A, B = cand_np.shape
        a, b, cand = (torch.from_numpy(x).cuda() for x in (a_np, b_np, cand_np))
        got = CK.hamming_best2(a, b, cand)
        torch.cuda.synchronize()
        ref = CK.hamming_best2_ref(a, b, cand)
        for name, x, y in zip(("idx", "best", "second"), got, ref):
            if not torch.equal(x, y):
                bad = int((x != y).sum())
                raise AssertionError(f"hamming_best2 {name} disagrees at [{A},{B}] "
                                     f"{kind} on {bad} rows")
        n_sets = cold_count(A * B)
        masks = [cand.clone() for _ in range(n_sets)]
        warm = queued_ms(lambda: CK.hamming_best2(a, b, cand), reps=20)
        cold = queued_cold_ms(lambda i: CK.hamming_best2(a, b, masks[i]), n_sets)
        unfused = queued_ms(
            lambda: CK.masked_best2(CK.hamming_matrix(a, b), cand), reps=20)
        print(f"hamming_best2 [{A},{B}] {kind} ({100 * cand_np.mean():.2f}% true) "
              f"exact; device ms (queued events): warm {fmt_ms(warm)}, cold over "
              f"{n_sets} masks {fmt_ms(cold)}; unfused (hamming_matrix + plain "
              f"reduction) warm {fmt_ms(unfused)}; byte bound "
              f"{1e3 * (A * B + 32 * (A + B) + 12 * A) / HBM_BYTES_PER_S:.4f} ms",
              flush=True)


def bow_cases(voc, seed: int = 0, sizes=(1024, 2048)):
    """Seeded inputs for `bow_assign`: (kind, desc [M, 8] int32, valid [M])
    at each M of `sizes`, a tenth of the rows invalid."""
    rng = np.random.default_rng(seed)
    for m in sizes:
        yield f"random-{m}", descriptors(rng, m), rng.random(m) < 0.9


def bow_row(lib, twotrip, voc, kind: str, desc_np, valid_np, reps: int = 10,
            timed: bool = True) -> dict:
    """One case of `bow_assign` on the card: words, ok and gate exact
    against both plain versions (the children-block walk and the JAX
    layout), written inside guard rows; the first kernel and the variants
    exact too. Then, if `timed`: per-call and device times (warm: the
    tables in L2; cold: one of many copies of the tables per call, so that
    the bytes the calls read exceed the L2), each kernel in turns with the
    others, the empty kernels of their grids and the byte bound (the
    distinct bytes of `bow_assign_bytes`)."""
    from ..ops.bow import GATE_DEPTH
    from .cuda_timing import time_ms
    M = len(desc_np)
    tables = voc.device_tables_on("cuda")
    blocks = voc.child_blocks_on("cuda")
    d, v = torch.from_numpy(desc_np).cuda(), torch.from_numpy(valid_np).cuda()
    args = (d, v, voc.levels, GATE_DEPTH)
    bufs = [guarded(M, torch.int32), guarded(M, torch.bool), guarded(M, torch.int32)]
    got = CK.bow_assign(*tables, *args, blocks=blocks, out=[b[1] for b in bufs])
    check_guards(f"bow_assign M={M} ({kind})", bufs)
    variant_fn = variant_launcher()

    def outputs():
        return (torch.empty(M, dtype=torch.int32, device="cuda"),
                torch.empty(M, dtype=torch.bool, device="cuda"),
                torch.empty(M, dtype=torch.int32, device="cuda"))

    def old(t=tables, out=None):
        out = out or outputs()
        _check(twotrip.bow_assign_twotrip_launch(
            *(x.data_ptr() for x in (*t, d, v, *out)), M, voc.k, voc.levels,
            GATE_DEPTH, _stream()), "bow_assign_twotrip")
        return out

    def variant(i, b=blocks, out=None):
        out = out or outputs()
        _check(variant_fn(i, *(x.data_ptr() for x in (b.table, d, v, *out)), M,
                          voc.k, voc.levels, GATE_DEPTH, b.root_block, b.root_word,
                          CK.top_rows(b, voc.k), _stream()), f"bow_assign variant {i}")
        return out

    checks = {"kernel vs children-block walk": (got, CK.bow_assign_blocks_ref(
                  blocks, *args)),
              "kernel vs JAX layout": (got, CK.bow_assign_ref(*tables, *args)),
              "first kernel": (old(), got)}
    checks.update({name: (variant(i), got) for i, (name, _) in enumerate(BOW_VARIANTS)})
    torch.cuda.synchronize()
    for what, (xs, ys) in checks.items():
        for name, x, y in zip(("words", "ok", "gate"), xs, ys):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"bow_assign {name} disagrees at M={M} ({kind}), "
                                     f"{what}, on {int((x != y).sum())} rows")
    row = dict(err=0, shape=f"M={M}", kind=kind, n_valid=int(valid_np.sum()))
    if not timed:
        return row
    # a call reads only n_bytes distinct bytes of the tables: as many copies
    # of them as `cold_count` allows, so that the parts the calls read exceed
    # the L2 together
    n_bytes, n_touched, n_blocks = bow_assign_bytes(voc, desc_np, valid_np)
    n_sets, n_old_sets = cold_count(n_blocks), cold_count(n_bytes)
    fixed = outputs()
    copies = [blocks._replace(table=blocks.table.clone()) for _ in range(n_sets)]
    old_copies = [[t.clone() for t in tables] for _ in range(n_old_sets)]
    # name -> (warm call, cold call of copy i, copies, grid's warps a block)
    kernels = {"kernel": (lambda: CK.bow_assign(*tables, *args, blocks=blocks,
                                                out=fixed),
                          lambda i: CK.bow_assign(*tables, *args, blocks=copies[i],
                                                  out=fixed), n_sets, BOW_WARPS)}
    for i, (name, warps) in enumerate(BOW_VARIANTS):
        kernels[name] = (lambda i=i: variant(i, out=fixed),
                         lambda j, i=i: variant(i, copies[j], fixed), n_sets, warps)
    kernels["first kernel"] = (lambda: old(out=fixed),
                               lambda j: old(old_copies[j], fixed), n_old_sets, 4)
    order = list(kernels) + list(kernels)[::-1]
    warm = {name: [] for name in kernels}
    for name in order:  # in turns: each kernel before and after the others
        warm[name].append(queued_ms(kernels[name][0], reps=reps))
    times = {}
    for name, (_, cold_fn, n, warps) in kernels.items():
        runs = [x for x in warm[name] if x is not None]
        times[name] = dict(dev=sum(runs) / len(runs) if runs else None,
                           warm_runs=warm[name], cold=queued_cold_ms(cold_fn, n),
                           cold_sets=n,
                           floor=empty_kernel_ms(lib, -(-M // warps), 1, 32 * warps))
    del copies, old_copies
    k_t, o_t = times["kernel"], times["first kernel"]
    row.update(ms=time_ms(kernels["kernel"][0]), old_ms=time_ms(kernels["first kernel"][0]),
               plain_ms=time_ms(lambda: CK.bow_assign_blocks_ref(blocks, *args), reps=5),
               jax_layout_plain_ms=time_ms(lambda: CK.bow_assign_ref(*tables, *args),
                                           reps=5),
               dev=k_t["dev"], cold=k_t["cold"], floor=k_t["floor"],
               old_dev=o_t["dev"], old_cold=o_t["cold"], old_floor=o_t["floor"],
               variants={name: times[name] for name, _ in BOW_VARIANTS},
               plain_dev=queued_ms(lambda: CK.bow_assign_blocks_ref(blocks, *args),
                                   reps=3),
               bytes=n_bytes, touched_bytes=n_touched, block_bytes=n_blocks,
               bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes")
    print(f"bow_assign M={M} ({kind}, {row['n_valid']} valid) on {len(voc.node_desc)} "
          f"nodes (k={voc.k}, {voc.levels} levels, {len(blocks.table)} blocks): words, "
          f"ok, gate exact against both plain versions, guard rows intact "
          f"(max_abs_err 0); per call (CUDA events, back-to-back) kernel "
          f"{row['ms']:.4f} ms, first kernel (no wrapper) {row['old_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms (JAX layout {row['jax_layout_plain_ms']:.4f}); "
          f"device time (CUDA events, queued; warm runs in turns "
          f"{' / '.join(order)}), warm (the runs) / cold (copies) / empty kernel of "
          f"the grid: " + "; ".join(
              f"{name} {fmt_ms(t['dev'])} ({', '.join(fmt_ms(x) for x in t['warm_runs'])})"
              f" / {fmt_ms(t['cold'])} ({t['cold_sets']}) / {fmt_ms(t['floor'])}"
              for name, t in times.items())
          + f"; plain {fmt_ms(row['plain_dev'])}; bound {row['bound_ms']:.5f} ms by "
          f"bytes ({n_bytes} distinct bytes: each node the valid rows' descents "
          f"stand on counted once; {n_touched} counting it once per row and level; "
          f"{n_blocks} of the block table, each expanded block once; the popcounts "
          f"are {8 * voc.k * voc.levels * M} in all)", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this probe runs only on the card", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    from ..io.vocabulary import default_vocabulary
    voc = default_vocabulary()
    if "--bow" in sys.argv[1:]:
        CK.build_kernels()
        lib, twotrip = probe_lib(), twotrip_lib()
        print(f"built (compile seconds by library: {_build.build_seconds})", flush=True)
        for kind, desc, valid in bow_cases(voc):
            bow_row(lib, twotrip, voc, kind, desc, valid, reps=20)
        return 0
    ok, msg = xor_popc_compiles()
    print(f"mma.sync b1 .xor.popc for sm_90a: "
          f"{'accepted' if ok else 'refused'} by nvcc ({msg})", flush=True)
    CK.build_kernels()
    lib = probe_lib()
    print(f"built (compile seconds by library: {_build.build_seconds})", flush=True)
    probe_mma_rate(lib)
    rng = np.random.default_rng(0)
    for A, B in SHAPES:
        a = torch.from_numpy(descriptors(rng, A)).cuda()
        b = torch.from_numpy(descriptors(rng, B)).cuda()
        probe_scalar(lib, a, b)
        probe_matrix(a, b)
        probe_best2(best2_cases(A, B))
    probe_best2(best2_cases(*LARGER))
    probe_best2(best2_path_cases(voc=voc))
    twotrip = twotrip_lib()
    for kind, desc, valid in bow_cases(voc):
        bow_row(lib, twotrip, voc, kind, desc, valid, reps=20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
