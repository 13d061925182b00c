"""Background, abortable global bundle adjustment.

Counterpart of orbslam2_tpu/global_ba.py (LoopClosing::
RunGlobalBundleAdjustment, src/LoopClosing.cpp:726-905): the reference runs
GBA in a fourth thread, aborts it when a new loop arrives (mbStopGBA /
mnFullBAIdx, src/LoopClosing.cpp:815-824), and, because tracking and
mapping kept growing the map during the solve, corrects the keyframes and
points created mid-BA through the spanning tree before writing results
(:843-905).

Here the solve iterates on a device-side SNAPSHOT of the map (a bucketed
BAProblem built at launch by local_mapping.build_ba_problem) in
bounded-iteration chunks of ops/ba.ba_solve on a worker thread, checking an
abort flag between chunks. Nothing touches the live map until the solve
completes; `poll()`, called from the mapping thread, then applies:

- snapshot keyframes: pose <- GBA pose (the reference's mTcwGBA staging)
- keyframes created during the solve: chained through the spanning tree,
  T_child_new = T_child_cur ∘ T_anc_cur^-1 ∘ T_anc_new, processed in
  creation order so late children chain through corrected late parents
  (src/LoopClosing.cpp:852-875)
- snapshot points: position <- GBA position (mPosGBA)
- points created during the solve: re-anchored via their reference
  keyframe's pre/post-GBA poses (src/LoopClosing.cpp:876-905)

On a CUDA device the worker issues its kernels on a CUDA stream of its own.
It first waits for the stream that built the snapshot (an event recorded
at launch), waits for its own stream after every chunk, and publishes the
result only as host arrays read back after that wait. The snapshot's
tensors stay referenced by the worker until the solve has ended.

When torch.distributed is initialized over more than one rank and the
snapshot has at least `dist_min_cams` (bucketed) cameras, the chunks run
sharded over the default group (`_solver_fn`, the JAX package's
distributed branch): this GBA, on rank 0, broadcasts the snapshot's
problem and a header before each chunk (parallel/multihost.py), and every
other rank joins the chunks in `multihost.serve_global_ba`. An abort
between chunks ends the solve on every rank.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import SlamConfig
from .map.mapstate import MapState
from .ops import ba as BA
from .ops import cuda_kernels as CK
from .ops import features as F
from .parallel import dist_ba, multihost
from .utils.metrics import log_event


class GlobalBA:
    def __init__(self, cfg: SlamConfig, mp: MapState,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.map = mp
        self.device = torch.device(device)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._abort = threading.Event()
        self._result = None          # (cam_T [C,3,4], pts [P,3]) host arrays
        self._snapshot = None        # dict: kf ids, pt ids, meta
        self.full_ba_idx = 0         # mnFullBAIdx: counts launches
        self.n_aborted = 0
        self.n_applied = 0
        # ms of each chunk of the last solve that ran to its end, and of
        # the whole solve (host clock around work that ends in a wait)
        self.chunk_ms: list[float] = []
        self.solve_ms: list[float] = []
        # test hook: called between chunks (may block to make timing
        # deterministic in tests)
        self.chunk_hook = None

    # distributed dispatch threshold: below this (bucketed) camera count the
    # sharded CG cannot amortize its collectives; tests lower it to force
    # the distributed path
    dist_min_cams = 64

    # ------------------------------------------------------------------ launch
    def launch(self, fixed_kf: int, chunks: int = 5, chunk_iters=(1, 2),
               background: bool = True):
        """Start a global BA over the current map. If one is already
        running it is aborted first (the reference's CorrectLoop stop+abort
        sequence, src/LoopClosing.cpp:519-542)."""
        self.abort_and_join()
        mp = self.map
        from .local_mapping import build_ba_problem
        kfs = [int(k) for k in mp.kf_ids]
        if len(kfs) < 2:
            return
        prob, meta = build_ba_problem(mp, self.cfg, self.sigma2, kfs,
                                      fixed=[int(fixed_kf)], device=self.device)
        self._snapshot = {
            "kfs": np.asarray(kfs, np.int64),
            "kf_set": set(kfs),
            "pts": meta["points"].astype(np.int64),
            "pt_set": set(int(p) for p in meta["points"]),
            "meta": meta,
        }
        self._result = None
        self._abort.clear()
        self.full_ba_idx += 1
        # the snapshot's uploads were issued on this thread's stream
        uploaded = None
        if self.device.type == "cuda":
            uploaded = torch.cuda.Event()
            uploaded.record()
        if background:
            self._thread = threading.Thread(
                target=self._solve, args=(prob, chunks, chunk_iters, uploaded),
                daemon=True)
            self._thread.start()
        else:
            self._solve(prob, chunks, chunk_iters, uploaded)

    def _solver_fn(self, prob: BA.BAProblem):
        """Pick the solve: sharded by point owner over the default group when
        it has more than one rank and the problem has at least
        `dist_min_cams` cameras (the peers are then sent the problem), the
        single-process solve otherwise. Returns (solve(prob, i1, i2), the
        number of ranks)."""
        cam = self.cfg.camera
        intr = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        n = dist.get_world_size() if dist.is_initialized() else 1
        if n > 1 and prob.cam_T.shape[0] >= self.dist_min_cams:
            group = dist.group.WORLD
            multihost.header(group, self.device, multihost.SOLVE, intrinsics=intr)
            multihost.broadcast_problem(prob, group)

            def solve(prob, i1, i2):
                multihost.header(group, self.device, multihost.CHUNK, iters=(i1, i2))
                return dist_ba.dist_ba_solve(prob, group, *intr, iters1=i1, iters2=i2)
            return solve, n

        def solve(prob, i1, i2):
            return BA.ba_solve(prob, *intr, iters1=i1, iters2=i2)
        return solve, 1

    def _solve(self, prob: BA.BAProblem, chunks: int, chunk_iters, uploaded):
        stream = None
        if uploaded is not None:
            stream = torch.cuda.Stream(device=self.device)
            stream.wait_event(uploaded)
        t0 = time.perf_counter()
        chunk_ms = []
        res = None
        # no-op without a stream (the CPU); the solve's kernel launches count
        # under "gba"
        with torch.cuda.stream(stream), CK.launches_counted_as("gba"):
            solve, n_dev = self._solver_fn(prob)
            if n_dev > 1:
                log_event("gba_distributed", devices=n_dev,
                          cams=int(prob.cam_T.shape[0]))
            try:
                for c in range(chunks):
                    tc = time.perf_counter()
                    res = solve(prob, chunk_iters[0], chunk_iters[1])
                    if stream is not None:
                        stream.synchronize()
                    chunk_ms.append((time.perf_counter() - tc) * 1e3)
                    if self.chunk_hook is not None:
                        self.chunk_hook(c)
                    if self._abort.is_set():
                        self.n_aborted += 1
                        log_event("gba_aborted", chunk=c)
                        return
                    prob = prob._replace(cam_T=res.cam_T, pts=res.pts)
            finally:
                if n_dev > 1:  # the peers leave the solve, ended or aborted
                    multihost.header(dist.group.WORLD, self.device, multihost.END)
            # host copies, read back on this stream after its last chunk
            result = (res.cam_T.cpu().numpy(), res.pts.cpu().numpy())
        with self._lock:
            self._result = result
            self.chunk_ms = chunk_ms
            self.solve_ms.append((time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------------- abort
    def request_abort(self):
        self._abort.set()

    def abort_and_join(self, timeout: float = 120.0):
        t = self._thread
        if t is not None and t.is_alive():
            self._abort.set()
            t.join(timeout=timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------------- apply
    def poll(self) -> bool:
        """Apply finished GBA results to the live map. Call from the
        mapping thread, so that map writes stay on one thread. Returns True
        if a correction was applied."""
        with self._lock:
            res, snap = self._result, self._snapshot
            if res is None or snap is None:
                return False
            self._result = None
            self._snapshot = None
        with self.map.lock:
            self._apply(res, snap)
        self.n_applied += 1
        return True

    def wait_and_apply(self, timeout: float = 600.0) -> bool:
        """Block until the worker finishes, then apply (System.shutdown)."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        return self.poll()

    def _apply(self, res, snap):
        mp = self.map
        cam_T, pts_new = res
        kfs, kf_set = snap["kfs"], snap["kf_set"]
        pt_ids, pt_set = snap["pts"], snap["pt_set"]

        # pre-apply poses of snapshot KFs (the reference's mTcwBefGBA)
        pre_pose = {int(k): mp.kf_pose[int(k)].copy() for k in kfs}
        post_pose = {int(k): cam_T[i] for i, k in enumerate(kfs)}

        # late keyframes, corrected through the spanning tree in creation
        # order so children of late parents chain correctly (:852-875)
        late = [int(k) for k in mp.kf_ids if int(k) not in kf_set]
        late.sort(key=lambda k: int(mp.kf_frame_id[k]))
        for k in late:
            anc = int(mp.kf_parent[k])
            hops = 0
            while anc >= 0 and anc not in pre_pose and hops < 64:
                anc = int(mp.kf_parent[anc])
                hops += 1
            if anc < 0 or anc not in pre_pose:
                continue  # no corrected ancestor: leave as-is
            T_child = mp.kf_pose[k]
            Ta_old, Ta_new = pre_pose[anc], post_pose[anc]
            # T_rel = T_child ∘ Ta_old^-1 ; T_new = T_rel ∘ Ta_new
            Ra, ta = Ta_old[:, :3], Ta_old[:, 3]
            Ta_inv = np.hstack([Ra.T, (-Ra.T @ ta)[:, None]])
            T_rel = np.hstack([
                T_child[:, :3] @ Ta_inv[:, :3],
                (T_child[:, :3] @ Ta_inv[:, 3] + T_child[:, 3])[:, None]])
            T_new = np.hstack([
                T_rel[:, :3] @ Ta_new[:, :3],
                (T_rel[:, :3] @ Ta_new[:, 3] + T_rel[:, 3])[:, None]])
            pre_pose[k] = mp.kf_pose[k].copy()
            post_pose[k] = T_new.astype(np.float32)
            mp.kf_pose[k] = T_new.astype(np.float32)

        # snapshot keyframes: adopt GBA poses (mTcwGBA)
        for i, k in enumerate(kfs):
            k = int(k)
            if mp.kf_valid[k]:
                mp.kf_pose[k] = cam_T[i]

        # snapshot points: adopt GBA positions (mPosGBA)
        still = pt_ids[mp.pt_valid[pt_ids]]
        slot = {int(p): i for i, p in enumerate(pt_ids)}
        if len(still):
            mp.pt_xyz[still] = pts_new[[slot[int(p)] for p in still]]

        # late points: re-anchor via the reference keyframe's pre/post poses
        # (:876-905)
        all_pts = np.flatnonzero(mp.pt_valid)
        late_pts = np.array([p for p in all_pts if int(p) not in pt_set], np.int64)
        for p in late_pts:
            ref = int(mp.pt_ref_kf[p])
            while ref >= 0 and ref not in post_pose and ref in mp.kf_retired:
                ref = mp.kf_retired[ref][0]
            if ref not in post_pose:
                continue
            T_old, T_new = pre_pose[ref], post_pose[ref]
            Xc = T_old[:, :3] @ mp.pt_xyz[p] + T_old[:, 3]
            mp.pt_xyz[p] = (T_new[:, :3].T @ (Xc - T_new[:, 3])).astype(np.float32)
        mp.mark_points_dirty(np.flatnonzero(mp.pt_valid))
        log_event("gba_applied", kfs=len(kfs), late_kfs=len(late),
                  pts=len(still), late_pts=len(late_pts))
