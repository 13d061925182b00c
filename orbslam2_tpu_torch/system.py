"""System facade: the public entry point of the port.

Counterpart of orbslam2_tpu/system.py (src/System.cpp). It builds the map,
the tracker of the configured sensor and the local mapper, and exposes the
reference's API surface (include/System.h:63-110):

    System(cfg, device="cuda", async_mapping=False, vocabulary=None,
           use_viewer=False, viewer_port=0)
    track_monocular(img, t) -> Tcw [3,4] or None
    track_stereo(left, right, t) -> Tcw [3,4] or None
    track_rgbd(rgb, depth, t) -> Tcw [3,4] or None
    run_sequence(frames, progress_every=0, pipelined=True)
    activate_localization_mode() / deactivate_localization_mode()
    save_trajectory_tum / save_keyframe_trajectory_tum /
        save_trajectory_kitti(path)
    save_map(path) / load_map(path)
    map_stats()
    wait_for_mapping() / request_reset() / reset() / shutdown()

`vocabulary` is a Vocabulary, the path of an .npz or of an ORBvoc text file;
None loads the vocabulary shipped with the package. With it the System builds
the keyframe database and the relocalizer: the mapper registers every
keyframe's BoW vector, a lost tracker relocalizes against the database, and
localization mode tracks against the frozen map.

Local mapping runs per keyframe: inline by default, or with
async_mapping=True on a worker thread fed through a bounded queue (the
reference's InsertKeyFrame handoff, src/LocalMapping.cpp:147-153). On a
CUDA device the worker issues its device work on a CUDA stream of its own.
The tracker and the mapper share no device tensor: the tracker's point
mirror is refreshed from the host map under the map lock, and the mapper's
keyframe cache (local_mapping.KFStore) is its own.

Loop closing is the last stage of every mapped keyframe, on the mapping
thread (loop_closing.LoopCloser). A closed loop launches the global BA
(global_ba.GlobalBA) on a thread and CUDA stream of its own; the loop
closer applies its result at a later keyframe, and shutdown() waits for it
and applies it.

A map checkpoint is one npz in the JAX package's layout, so either package
loads the other's file. load_map rebuilds everything that sees the map and
leaves the tracker LOST, so the next frame relocalizes against it.

use_viewer=True starts the live viewer (viz/live_viewer.LiveViewer, an
HTTP server on 127.0.0.1:viewer_port, 0 for a free port) with its own
render thread; every frame tracked through track_* updates it, the block
driver of run_sequence(pipelined=True) does not (as in the JAX package).
"""
from __future__ import annotations

import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .config import SlamConfig, Sensor
from .global_ba import GlobalBA
from .io import trajectory as traj_io
from .io.vocabulary import Vocabulary, default_vocabulary, load_orbvoc_text
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map.keyframe_db import KeyFrameDatabase
from .map.mapstate import MapState
from .ops.cuda_kernels import launches_counted_as
from .ops.features import padded_capacity
from .relocalization import Relocalizer
from .tracking import Tracker, TrackState, sequence_item
from .utils.metrics import MetricsLog


class System:
    def __init__(self, cfg: SlamConfig, device: torch.device | str = "cuda",
                 async_mapping: bool = False,
                 vocabulary: Vocabulary | str | Path | None = None,
                 use_viewer: bool = False, viewer_port: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        if vocabulary is None:
            vocabulary = default_vocabulary()
        elif isinstance(vocabulary, (str, Path)):
            vocabulary = (Vocabulary.load(vocabulary)
                          if str(vocabulary).endswith(".npz")
                          else load_orbvoc_text(vocabulary))
        self.vocabulary = vocabulary
        self.metrics = MetricsLog()
        self._async = async_mapping
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        self._error: Exception | None = None  # the mapping worker's failure
        # a reset asked for off the tracking thread (request_reset)
        self._reset_pending = False
        self._build()
        if async_mapping:
            self._queue = queue.Queue(maxsize=3)
            self._worker = threading.Thread(target=self._mapping_loop, daemon=True)
            self._worker.start()
        # the live viewer thread (the System constructor's bUseViewer,
        # src/System.cpp:111-114)
        self.viewer = None
        if use_viewer:
            from .viz.live_viewer import LiveViewer
            self.viewer = LiveViewer(self, port=viewer_port)
            print(f"[viewer] http://{self.viewer.host}:{self.viewer.port}/", flush=True)

    def _build(self, mp: MapState | None = None):
        """Build the map (or take `mp`) and everything that sees it."""
        # keyframes are as wide as the widest frame: monocular
        # initialization extracts twice the feature budget
        wide = 2 if self.cfg.sensor == Sensor.MONOCULAR else 1
        self.map = mp if mp is not None else MapState(
            self.cfg, padded_capacity(self.cfg.orb.n_features * wide))
        self.kf_db = KeyFrameDatabase(self.cfg, self.map, self.vocabulary.n_words)
        self.relocalizer = Relocalizer(self.cfg, self.map, self.vocabulary,
                                       self.kf_db, device=self.device)
        self.local_mapper = LocalMapper(self.cfg, self.map, kf_db=self.kf_db,
                                        bow_encode=self.relocalizer,
                                        device=self.device)
        self.global_ba = GlobalBA(self.cfg, self.map, device=self.device)
        self.loop_closer = LoopCloser(self.cfg, self.map, self.kf_db, self.global_ba,
                                      device=self.device)
        self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracker(self.cfg, self.map,
                               self._mapper_proxy(self.local_mapper),
                               relocalizer=self.relocalizer, device=self.device)
        self.tracker.reset_callback = self.reset

    # --------------------------------------------------------------- pipeline
    def _mapper_proxy(self, mapper: LocalMapper):
        sys_self = self

        class _Proxy:
            """The tracker's handle on local mapping: inline, or the queue
            of the mapping worker. Queue items carry their mapper, so a
            keyframe queued before a reset is processed on the map it came
            from."""

            def __init__(self):
                # keyframes that met a full queue (nearly unreachable: the
                # keyframe decision applies the reference's < 3 backpressure
                # through queue_depth); retried on the next proxy call, never
                # processed inline, which would race the worker
                self._pending: list[int] = []

            def _flush_pending(self):
                while self._pending:
                    try:
                        sys_self._queue.put_nowait((mapper, self._pending[0]))
                    except queue.Full:
                        return
                    self._pending.pop(0)

            def process(self, kf):
                if not sys_self._async:
                    mapper.process(kf)
                    return
                # never block: the tracker calls this holding the map lock,
                # which the worker needs to drain the queue
                self._flush_pending()
                try:
                    sys_self._queue.put_nowait((mapper, kf))
                except queue.Full:
                    self._pending.append(kf)

            def queue_depth(self):
                """KeyframesInQueue (src/LocalMapping.cpp:941): the keyframe
                decision's backpressure (src/Tracking.cpp:1417)."""
                if not sys_self._async:
                    return 0
                self._flush_pending()
                return sys_self._queue.qsize() + len(self._pending)

            def idle(self):
                """AcceptKeyFrames (src/LocalMapping.cpp:794): no queued and
                no running work. The queue's unfinished-task count drops only
                after process() returns."""
                if not sys_self._async:
                    return True
                self._flush_pending()
                return sys_self._queue.unfinished_tasks == 0 and not self._pending

            def interrupt_ba(self):
                """LocalMapping::InterruptBA (src/Tracking.cpp:1412)."""
                mapper.interrupt_ba()

            def run_ba(self, *args, **kwargs):
                """The BA of the initial monocular map, on the tracker's
                thread: no keyframe has reached the worker yet."""
                return mapper.run_ba(*args, **kwargs)

            def register(self, kf):
                """Enter a keyframe of an initial map into the database, on
                the tracker's thread."""
                mapper.register_keyframe(kf)

        self._proxy = _Proxy()
        return self._proxy

    def _mapping_loop(self):
        """The mapping worker. After a failure it keeps draining the queue
        without mapping, so the tracker never blocks on it, and shutdown()
        raises the failure."""
        stream = (torch.cuda.Stream(device=self.device)
                  if self.device.type == "cuda" else None)
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                mapper, kf = item
                if self._error is not None:
                    continue
                if stream is None:
                    mapper.process(kf)
                else:
                    with torch.cuda.stream(stream):
                        mapper.process(kf)
            except Exception as e:
                self._error = e
            finally:
                self._queue.task_done()

    # ------------------------------------------------------------- public API
    def _need(self, sensor: Sensor, entry: str):
        if self.cfg.sensor != sensor:
            raise ValueError(f"{entry} on a {self.cfg.sensor.name} system")

    def track_monocular(self, img: np.ndarray, timestamp: float):
        self._need(Sensor.MONOCULAR, "track_monocular")
        gray = self._gray(img)
        return self._tracked(timestamp, gray, lambda: self.tracker.process_image(
            gray, timestamp))

    def track_stereo(self, left: np.ndarray, right: np.ndarray, timestamp: float):
        self._need(Sensor.STEREO, "track_stereo")
        gl, gr = self._gray(left), self._gray(right)
        return self._tracked(timestamp, gl, lambda: self.tracker.process_image(
            gl, timestamp, right_img=gr))

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float):
        self._need(Sensor.RGBD, "track_rgbd")
        gray = self._gray(img)
        return self._tracked(timestamp, gray, lambda: self.tracker.process_image(
            gray, timestamp, depth_map=depth))

    def _record(self, timestamp: float, ms: float, created_keyframe: bool):
        self.metrics.append(
            frame_id=len(self.metrics.records), timestamp=timestamp,
            state=self.tracker.state.name,
            inliers=self.tracker.matches_inliers,
            keyframes=self.map.n_keyframes, points=self.map.n_points,
            loops=self.loop_closer.n_loops_closed, track_ms=ms,
            created_keyframe=created_keyframe)

    def _tracked(self, timestamp: float, gray: np.ndarray, fn):
        if self._reset_pending:
            # the reference's mbReset handshake (src/System.cpp:255-262):
            # a reset asked for off-thread is applied on the tracking thread
            self._reset_pending = False
            self.reset()
        kfs_before = self.map.n_keyframes
        t0 = time.perf_counter()
        pose = fn()
        ms = (time.perf_counter() - t0) * 1e3
        if self.viewer is not None and self.tracker.last_frame is not None:
            self.viewer.update(gray, self.tracker.last_frame)
        self._record(timestamp, ms, self.map.n_keyframes != kfs_before)
        return pose

    def run_sequence(self, frames, progress_every: int = 0, pipelined: bool = True):
        """Sequence runner over (timestamp, {"image", "depth"?, "right"?})
        pairs: a depth map for RGB-D, a right image for stereo. Returns the
        number of tracked frames; with progress_every = n it prints the
        map's statistics every n frames.

        pipelined=True: the block driver (Tracker.run_blocked), 6 frames
        per device call with two blocks in flight; each frame's track_ms is
        its share of its block (the driver's last_frame_ms).
        pipelined=False: one synchronous frame at a time, which is also
        what localization mode runs."""
        if pipelined and not self.localization_mode_active:
            poses = self._track_blocked(frames)
        else:
            poses = (self._track_item(ts, data) for ts, data in frames)
        tracked = 0
        for n, pose in enumerate(poses, 1):
            tracked += int(pose is not None)
            if progress_every and n % progress_every == 0:
                print(f"frame {n}: {self.map_stats()}", flush=True)
        return tracked

    def _track_blocked(self, frames):
        for ts, pose in self.tracker.run_blocked(frames, self._gray):
            self._record(ts, self.tracker.last_frame_ms, False)
            yield pose

    def _track_item(self, ts: float, data: dict):
        img, depth, right = sequence_item(data, self.cfg.sensor)
        if self.cfg.sensor == Sensor.RGBD:
            return self.track_rgbd(img, depth, ts)
        if self.cfg.sensor == Sensor.STEREO:
            return self.track_stereo(img, right, ts)
        return self.track_monocular(img, ts)

    @staticmethod
    def _gray(img: np.ndarray) -> np.ndarray:
        """Gray u8 image (the reference's CV_8U input)."""
        if img.ndim == 3:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        if img.dtype == np.uint8:
            return img
        return np.clip(np.round(img), 0, 255).astype(np.uint8)

    # ------------------------------------------------------------------ state
    def activate_localization_mode(self):
        """Tracking only, against the frozen map
        (System::ActivateLocalizationMode, src/System.cpp:267)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    @property
    def localization_mode_active(self) -> bool:
        return self.tracker.localization_only

    @property
    def tracking_state(self) -> TrackState:
        return self.tracker.state

    def map_stats(self) -> dict:
        """Keyframes, points, tracking state, the last frame's inliers and
        the loops closed so far."""
        return {
            "keyframes": self.map.n_keyframes,
            "points": self.map.n_points,
            "state": self.tracker.state.name,
            "last_inliers": self.tracker.matches_inliers,
            "loops": self.loop_closer.n_loops_closed,
        }

    def wait_for_mapping(self):
        """Block until the mapping worker has processed every queued
        keyframe (it keeps running, unlike after shutdown); raises the
        worker's failure. Nothing to wait for with the mapper inline."""
        if self._worker is not None:
            while self._proxy._pending:
                self._proxy._flush_pending()
                self._queue.join()
            self._queue.join()
        if self._error is not None:
            raise RuntimeError("the mapping worker failed") from self._error

    def shutdown(self):
        """System::Shutdown (src/System.cpp:285): stop the viewer, drain the
        mapping queue, stop the worker, then wait for a running global BA
        and apply its result."""
        if self.viewer is not None:
            self.viewer.stop()
            self.viewer = None
        if self._worker is not None:
            # the tracking thread holds no map lock here: blocking puts are safe
            for kf in self._proxy._pending:
                self._queue.put((self.local_mapper, kf))
            self._proxy._pending.clear()
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            if self._error is not None:
                raise RuntimeError("the mapping worker failed") from self._error
        self.global_ba.wait_and_apply()

    def request_reset(self):
        """Ask for a reset from another thread (System::Reset's flag,
        src/System.cpp:279): applied on the tracking thread at the next
        track_* call."""
        self._reset_pending = True

    def reset(self):
        """System::Reset (src/System.cpp:279; Tracking::Reset :2030): a
        running global BA is aborted, then a new map, keyframe database,
        relocalizer, mapper, loop closer, global BA and tracker are built.
        Keyframes already queued are mapped into the old map, which nothing
        reads any more."""
        self.global_ba.abort_and_join()
        self._build()

    # ------------------------------------------------------------- checkpoint
    def save_map(self, path):
        """Checkpoint the map (MapState.save; the reference's SaveMap is a
        TODO, include/System.h:112-114)."""
        with self.map.lock:
            self.map.save(path)

    def load_map(self, path):
        """Restore a saved map of either package and relocalize against it:
        a running global BA is aborted, the database, relocalizer, mapper,
        loop closer, global BA and tracker are rebuilt on the loaded map
        (keyframes already queued are mapped into the old one, as after a
        reset), every keyframe is registered in the database, and the
        tracker is LOST with the last keyframe as its reference, so the next
        frame relocalizes."""
        self.global_ba.abort_and_join()
        self._build(MapState.load(path, self.cfg))
        with launches_counted_as("checkpoint"):
            for k in self.map.kf_ids:
                self.local_mapper.register_keyframe(int(k))
        self.tracker.state = TrackState.LOST
        self.tracker.ref_kf = int(self.map.kf_ids[-1]) if self.map.n_keyframes else -1

    # -------------------------------------------------------------- trajectory
    def save_trajectory_tum(self, path):
        ts, poses = self.tracker.trajectory()
        traj_io.save_tum(path, ts, poses)

    def save_keyframe_trajectory_tum(self, path):
        """The live keyframes' poses in the TUM format, in time order
        (System::SaveKeyFrameTrajectoryTUM, src/System.cpp:351-408)."""
        ids = self.map.kf_ids
        order = ids[np.argsort(self.map.kf_timestamp[ids])]
        traj_io.save_tum(path, self.map.kf_timestamp[order], self.map.kf_pose[order])

    def save_trajectory_kitti(self, path):
        """Every tracked frame's pose in the KITTI format
        (System::SaveTrajectoryKITTI, src/System.cpp:409-462)."""
        _, poses = self.tracker.trajectory()
        traj_io.save_kitti(path, poses)
