"""Per-frame tracking: the front-end state machine of all three sensors.

Counterpart of orbslam2_tpu/tracking.py (src/Tracking.cpp): RGB-D, stereo
and monocular frames, with the local mapper and the relocalizer on or off:

- steady state, synchronous: one fused call per frame
  (engine_step.track_frame_full), one readback, then host bookkeeping;
- steady state, pipelined (`run_blocked`): 6 frames per device call
  (engine_step.track_frames_block), two blocks in flight, each block's
  outputs copied back without stalling the host;
- first frame, RGB-D and stereo: StereoInitialization from depth;
- monocular: one fused initialization attempt per frame
  (engine_step.mono_init_step, a 16-float readback), the first frame with
  enough features as the reference, then CreateInitialMapMonocular with a
  two-keyframe BA and the median-depth scale;
- fallbacks (staged): TrackWithMotionModel, TrackReferenceKeyFrame (the
  node-gated SearchByBoW when the keyframe has gate nodes, else the ratio
  match) and TrackLocalMap, on the same kernels;
- LOST: Relocalization (relocalization.Relocalizer) on every frame until
  one succeeds; without a relocalizer, the reference keyframe is retried;
- localization-only mode (`localization_only`): tracking against the frozen
  map, no keyframes, with the temporal points of the motion model for
  stereo and RGB-D (Tracking::UpdateLastFrame), on the synchronous path;
- keyframes: NeedNewKeyFrame's rule set with the mapper's backpressure,
  CreateNewKeyFrame with close-depth point spawning, then the local mapper.

State machine {NOT_INITIALIZED, OK, LOST} (include/Tracking.h:81-87). The JAX
package's staged `_monocular_initialization` is reached by nothing once the
fused one drives `process_image`, and is not ported.
"""
from __future__ import annotations

import time
from enum import IntEnum

import numpy as np
import torch

from . import engine_step as ES
from .config import SlamConfig, Sensor
from .frontend import matcher as FM
from .frontend.frame import Frame, FrameBuilder
from .geometry import camera as cam_mod
from .geometry import se3_np
from .map.mapstate import MapState
from .ops import cuda_kernels as CK
from .ops import features as F
from .ops import pose_opt as PO
from .ops import refine as RF
from .utils.device import upload


class TrackState(IntEnum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


DEPTH_WIRE_Q = 2048.0  # fixed-point depth: 1/2048 m (0.49 mm), 32 m range


def _depth_wire(depth_map: np.ndarray, cfg_factor: float):
    """Depth map in the JAX package's wire form: (u16 array, scale to
    meters). u16 maps pass as they are (TUM depth PNGs are u16 sensor
    units); float maps are quantized to 1/2048 m. The quantization is part
    of the result (the fused frame's depths come from it), so the port
    keeps it."""
    if depth_map.dtype == np.uint16:
        return depth_map, float(cfg_factor)
    if cfg_factor < 1.0 / 1024.0:
        # float carrying raw u16 sensor units: the round trip is exact
        return np.round(depth_map).astype(np.uint16), float(cfg_factor)
    m = np.asarray(depth_map, np.float32) * np.float32(cfg_factor)
    q = m * np.float32(DEPTH_WIRE_Q)
    # out-of-range depth (>= 32 m) becomes 0 = "no depth"
    q = np.where((q >= 65535.0) | (q < 0.0), 0.0, q)
    return q.astype(np.uint16), 1.0 / DEPTH_WIRE_Q


def _to_u8(patch: np.ndarray) -> np.ndarray:
    """Photometric windows rounded to u8, as the map stores them. The JAX
    package carries the last frame's windows in this form, so the rounding
    is part of the result."""
    return np.clip(np.round(patch), 0, 255).astype(np.uint8)


SENSOR_NAME = {Sensor.MONOCULAR: "mono", Sensor.STEREO: "stereo",
               Sensor.RGBD: "rgbd"}


def sequence_item(data: dict, sensor: Sensor):
    """(image, depth or None, right image or None) of a sequence item
    {"image", "depth"?, "right"?}; ValueError when the item lacks what the
    sensor needs."""
    depth, right = data.get("depth"), data.get("right")
    if sensor == Sensor.RGBD and depth is None:
        raise ValueError("an RGB-D system needs a 'depth' map in every item")
    if sensor == Sensor.STEREO and right is None:
        raise ValueError("a stereo system needs a 'right' image in every item")
    return data["image"], depth, right


def _readback(tensors: dict, device: torch.device):
    """Start copying device tensors to the host without waiting: pinned
    buffers, non-blocking copies, and an event to wait on (None on the CPU,
    where the tensors already are host memory)."""
    if device.type != "cuda":
        return {k: t.numpy() for k, t in tensors.items()}, None
    host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True) for k, t in tensors.items()}
    event = torch.cuda.Event()
    event.record()
    return host, event


def _ensure_patch(frame: Frame):
    """Read a fused frame's photometric windows back from the device
    (deferred: they are only needed for fallback matching and keyframe
    creation)."""
    pd = getattr(frame, "_patch_dev", None)
    if frame.patch is None and pd is not None:
        frame.patch = pd.cpu().numpy().astype(np.float32)
        frame._patch_dev = None


class Tracker:
    def __init__(self, cfg: SlamConfig, mp: MapState, local_mapper=None,
                 relocalizer=None, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.map = mp
        self.device = torch.device(device)
        # LocalMapper or System's proxy of the mapping worker: process(k),
        # optionally idle(), interrupt_ba(), queue_depth()
        self.local_mapper = local_mapper
        self.relocalizer = relocalizer
        self.reset_callback = None  # wired by System (System::Reset path)
        self.sf = F.scale_factors(cfg.orb)
        self.sigma2 = F.sigma2_per_octave(cfg.orb)
        self.builder = FrameBuilder(cfg, self.device)
        # monocular initialization extracts with twice the feature budget
        # (src/Tracking.cpp:148-149); its frames have a frame-id counter of
        # their own, as in the JAX package
        self.init_builder = (
            FrameBuilder(cfg, self.device, cfg.orb.n_features * 2)
            if cfg.sensor == Sensor.MONOCULAR else self.builder)
        # the minimal sets of the two-view RANSAC are drawn from this
        # generator (seed 0), on the tracker's device
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(0)

        self.state = TrackState.NOT_INITIALIZED
        self.last_frame: Frame | None = None
        self.velocity: np.ndarray | None = None  # T_cur_last [3,4]
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.init_frame_id: int = -1
        self.matches_inliers: int = 0
        self.localization_only = False  # ActivateLocalizationMode
        self.last_reloc_frame_id: int = -1  # mnLastRelocFrameId
        # frames whose motion model ran with temporal points
        self.n_temporal_frames = 0
        # trajectory log: (timestamp, ref_kf, T_frame_wrt_refkf, lost)
        # (mlRelativeFramePoses etc., include/Tracking.h:109-112)
        self.frame_log: list[tuple[float, int, np.ndarray, bool]] = []
        self.n_lost_frames = 0
        # fused-path state: device mirror of the map point table and the
        # last frame's device-side feature tensors (chained between frames)
        self._mirror = None
        self._mirror_gen = -1
        self._last_dev = None
        self._last_dev_frame_id = -1
        self._sf_dev = self._dev(self.sf)
        self._sig2_dev = self._dev(self.sigma2)
        # block driver: the device chain the next block starts from, and the
        # bindings of the last finished frame (its local-map selection)
        self._blk_chain = None
        self._blk_bindings = None
        # amortized time of the frame the block driver yielded last
        self.last_frame_ms = 0.0
        # fused mono init: the reference attempt's device outputs (chained,
        # never uploaded again), its (frame_id, timestamp, n_valid), the
        # tensors the next attempt matches against, and the all-zero
        # placeholder of an attempt without a reference
        self._init_out = None
        self._init_meta = None
        self._init_ref_args = None
        self._init_zero = None

    # ------------------------------------------------------------------ utils
    def _dev(self, a) -> torch.Tensor:
        """Host numpy array -> tensor on the tracker's device."""
        return upload(a, self.device)

    def _refine_measurements(self, frame: Frame, mask: np.ndarray,
                             templates: np.ndarray):
        """Feature-metric re-measurement (ops/refine.py): align the masked
        features' windows to the given templates [N, 11, 11] and shift their
        measured positions by the recovered offset. Skips features already
        refined this frame (windows are centered on the ORIGINAL detection,
        so a second application would double-count the shift)."""
        _ensure_patch(frame)
        if frame.patch is None:
            return
        if not hasattr(frame, "_refined"):
            frame._refined = np.zeros(frame.capacity, bool)
        mask = mask & ~frame._refined
        if not mask.any():
            return
        delta, ok = RF.refine_offsets(
            self._dev(frame.patch), self._dev(templates.astype(np.float32)),
            self._dev(mask))
        ok = ok.cpu().numpy() & mask
        if not ok.any():
            return
        delta = delta.cpu().numpy()
        frame._refined |= ok
        sf = self.sf[np.clip(frame.octave, 0, len(self.sf) - 1)]
        frame.xy_raw = frame.xy_raw + delta * (sf * ok)[:, None]
        und = cam_mod.undistort_pixels(
            self.cfg.camera, torch.from_numpy(frame.xy_raw)).numpy()
        # the offset is measured in raw-image pixels; for the undistorted
        # coords this assumes a locally-identity undistortion Jacobian
        frame.xy = np.where(ok[:, None], und, frame.xy)
        # the virtual or matched right-u shifts with u (keeps the disparity
        # for stereo, and ur == u - bf/z for RGB-D)
        has_ur = ok & (frame.ur >= 0)
        frame.ur = np.where(has_ur, frame.ur + delta[:, 0] * sf, frame.ur)

    def _refine_against_points(self, frame: Frame, feat_mask: np.ndarray):
        """Refine the masked features against their bound map points'
        anchor templates."""
        pt = np.clip(frame.pt_idx, 0, None)
        mask = feat_mask & (frame.pt_idx >= 0)
        if not mask.any():
            return
        self._refine_measurements(frame, mask, self.map.pt_patch[pt])

    def _pose_optimize(self, frame: Frame) -> int:
        """Motion-only BA on the frame's current point associations; prunes
        outlier associations (src/Tracking.cpp:1034-1057). Returns the number
        of MAP-point inliers (the reference's nmatchesMap, :1230-1241)."""
        pt = frame.pt_idx
        bound = (pt >= 0) & frame.valid & self.map.pt_valid[np.clip(pt, 0, None)]
        ok = bound | (frame.tmp_valid & frame.valid)
        pts_xyz = np.where(bound[:, None], self.map.pt_xyz[np.clip(pt, 0, None)],
                           frame.tmp_xyz)
        obs = np.concatenate([frame.xy, frame.ur[:, None]], -1).astype(np.float32)
        is_st = frame.ur >= 0
        info = (1.0 / self.sigma2)[np.clip(frame.octave, 0, len(self.sigma2) - 1)]
        cam = self.cfg.camera
        res = PO.pose_optimize(
            self._dev(frame.pose), self._dev(pts_xyz.astype(np.float32)),
            self._dev(obs), self._dev(is_st & ok),
            self._dev(info.astype(np.float32)), self._dev(ok),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        frame.pose = res.T.cpu().numpy()
        inl = res.inliers.cpu().numpy()
        frame.pt_idx = np.where(ok & ~inl, -1, frame.pt_idx)
        frame.tmp_valid = frame.tmp_valid & inl
        return int((inl & bound).sum())

    # ------------------------------------------------------------- main entry
    def process_image(self, img: np.ndarray, timestamp: float,
                      depth_map: np.ndarray | None = None,
                      right_img: np.ndarray | None = None) -> np.ndarray | None:
        if (self.state == TrackState.OK and self.last_frame is not None
                and self.last_frame.pose is not None):
            # steady state: the whole per-frame hot path is one fused call
            # on the device + one readback. velocity None (first frame after
            # init) runs it with a zero-velocity prediction; the staged
            # TrackReferenceKeyFrame fallback fires when that fails.
            return self._track_fused(img, timestamp, depth_map, right_img)
        if (self.state == TrackState.NOT_INITIALIZED
                and self.cfg.sensor == Sensor.MONOCULAR):
            # one fused call and a 16-float readback per attempt
            return self._mono_init_fused(img, timestamp)
        frame = self.builder.build(img, timestamp, depth_map=depth_map,
                                   right_img=right_img)
        return self.track(frame)

    def track(self, frame: Frame) -> np.ndarray | None:
        # staged path: init and fallbacks, under the map lock for the whole
        # frame (the reference holds mMutexMapUpdate, src/Tracking.cpp:336)
        with self.map.lock:
            return self._track_locked(frame)

    def _track_locked(self, frame: Frame) -> np.ndarray | None:
        if self.state == TrackState.NOT_INITIALIZED:
            self._stereo_initialization(frame)
            if self.state == TrackState.OK:
                self._log_frame(frame, lost=False)
                return frame.pose
            return None

        # CheckReplacedInLastFrame (src/Tracking.cpp:372)
        if self.last_frame is not None:
            self.last_frame.pt_idx = self.map.resolve_point_ids(
                self.last_frame.pt_idx)
        self.map.release_retired_points()

        ok = False
        if self.state == TrackState.OK:
            if self.velocity is not None:
                ok = self._track_with_motion_model(frame)
            if not ok:
                ok = self._track_reference_keyframe(frame)
        else:  # LOST
            ok = self._relocalize(frame)

        if ok:
            ok = self._track_local_map(frame)

        return self._finish_frame(frame, ok)

    def _finish_frame(self, frame: Frame, ok: bool) -> np.ndarray | None:
        """Shared per-frame tail: state transition, velocity update, keyframe
        decision, trajectory log (the end of Tracking::Track,
        src/Tracking.cpp:526-626)."""
        if ok:
            self.state = TrackState.OK
            if self.last_frame is not None and self.last_frame.pose is not None:
                # orthonormalized: f32 scale leakage in this composition is
                # amplified by the prediction recurrence
                self.velocity = se3_np.orthonormalize(se3_np.compose(
                    frame.pose, se3_np.inverse(self.last_frame.pose)))
            # localization-only mode: track against the frozen map
            # (System::ActivateLocalizationMode, src/System.cpp:267)
            if not self.localization_only and self._need_new_keyframe(frame):
                self._create_keyframe(frame)
            self.n_lost_frames = 0
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.n_lost_frames += 1
            # reset when lost right after initialization with a tiny map
            # (src/Tracking.cpp:590-598), and only for an EARLY loss
            early = (self.init_frame_id >= 0 and
                     frame.frame_id - self.init_frame_id <= 10)
            if (not self.localization_only and self.map.n_keyframes <= 5
                    and self.n_lost_frames == 1 and early
                    and self.reset_callback is not None
                    and self.map.n_keyframes > 0):
                self.reset_callback()

        self._log_frame(frame, lost=not ok)
        self.last_frame = frame
        return frame.pose if ok else None

    def _log_frame(self, frame: Frame, lost: bool):
        if frame.pose is None or self.ref_kf < 0:
            self.frame_log.append((frame.timestamp, -1,
                                   np.eye(3, 4, dtype=np.float32), True))
            return
        T_ref = self.map.kf_pose[self.ref_kf]
        T_rel = se3_np.compose(frame.pose, se3_np.inverse(T_ref))
        self.frame_log.append((frame.timestamp, self.ref_kf, T_rel, lost))

    # --------------------------------------------------------- initialization
    def _stereo_initialization(self, frame: Frame):
        """StereoInitialization (src/Tracking.cpp:637-727): single-frame
        bootstrap from depth."""
        if frame.n_valid < 500:
            return
        mp = self.map
        frame.pose = se3_np.identity()
        has_depth = (frame.depth > 0) & frame.valid
        ids = np.flatnonzero(has_depth)
        if len(ids) < 100:
            return
        z = frame.depth[ids]
        cam = self.cfg.camera
        x = (frame.xy[ids, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[ids, 1] - cam.cy) / cam.fy * z
        X = np.stack([x, y, z], -1).astype(np.float32)
        pt_ids = mp.add_points(X, frame.desc[ids], ref_kf=0, first_kf=0,
                               patch=(RF.template_of(frame.patch[ids])
                                      if frame.patch is not None else None))
        pt_of = np.full(frame.capacity, -1, np.int32)
        pt_of[ids] = pt_ids
        mp.add_keyframe(frame.pose, frame.timestamp, frame.frame_id, frame.xy,
                        frame.octave, frame.angle, frame.desc, frame.valid,
                        pt_of, depth=frame.depth, ur=frame.ur,
                        patch=frame.patch, xy0=frame.xy0, ur0=frame.ur0)
        mp.refresh_point_stats(pt_ids)
        frame.pt_idx = pt_of
        self.ref_kf = 0
        self.last_kf_frame_id = frame.frame_id
        self.last_frame = frame
        self._register_keyframes(0)
        self.init_frame_id = frame.frame_id
        self.state = TrackState.OK

    def _register_keyframes(self, *kfs):
        """Enter the keyframes of an initial map into the keyframe database
        (they never pass through LocalMapper.process), through the `register`
        hook of System's mapper proxy."""
        register = getattr(self.local_mapper, "register", None)
        if register is not None:
            for k in kfs:
                register(k)

    # ---------------------------------------------- monocular initialization
    def _create_initial_map_monocular(self, ref: Frame, frame: Frame, idx,
                                      good, R, t, X):
        """CreateInitialMapMonocular (src/Tracking.cpp:834-1004): the two
        keyframes, their triangulated points, a BA over both, and the
        median-depth scale."""
        mp = self.map
        T0 = se3_np.identity()
        T1 = np.hstack([R, t[:, None]]).astype(np.float32)
        ref.pose = T0
        frame.pose = T1

        pt_ids = mp.add_points(X[good].astype(np.float32), ref.desc[good],
                               ref_kf=0, first_kf=0,
                               patch=RF.template_of(ref.patch[good]))
        pt_of_ref = np.full(ref.capacity, -1, np.int32)
        pt_of_ref[np.flatnonzero(good)] = pt_ids
        pt_of_cur = np.full(frame.capacity, -1, np.int32)
        pt_of_cur[idx[good]] = pt_ids

        k0 = mp.add_keyframe(T0, ref.timestamp, ref.frame_id, ref.xy, ref.octave,
                             ref.angle, ref.desc, ref.valid, pt_of_ref,
                             patch=ref.patch, xy0=ref.xy0)
        k1 = mp.add_keyframe(T1, frame.timestamp, frame.frame_id, frame.xy,
                             frame.octave, frame.angle, frame.desc, frame.valid,
                             pt_of_cur, patch=frame.patch, xy0=frame.xy0)
        mp.pt_ref_kf[pt_ids] = k1

        # BA over the initial map, 20 iterations (src/Tracking.cpp:907)
        if self.local_mapper is not None:
            self.local_mapper.run_ba([k0, k1], fixed=[k0], iters=(5, 15))
            self._register_keyframes(k0, k1)

        # median-depth scale normalization (src/Tracking.cpp:913-938)
        pc = mp.pt_xyz[pt_ids] @ mp.kf_pose[k0, :, :3].T + mp.kf_pose[k0, :, 3]
        median_depth = float(np.median(pc[:, 2]))
        if median_depth < 0 or (mp.kf_pt[k1] >= 0).sum() < 80:
            self._reset_initialization(pt_ids, [k0, k1])
            return
        inv = 1.0 / median_depth
        mp.kf_pose[k1, :, 3] *= inv
        mp.pt_xyz[pt_ids] *= inv
        mp.refresh_point_stats(pt_ids)

        frame.pose = mp.kf_pose[k1].copy()
        frame.pt_idx = pt_of_cur
        self.ref_kf = k1
        self.last_kf_frame_id = frame.frame_id
        # the init frame carries twice the tracker's feature budget; it is
        # squeezed to the tracker's capacity so that the NEXT frame can run
        # the fused or blocked path, whose shapes are those of n_features.
        # pt_idx entries are map point ids, so subsetting rows keeps every
        # binding valid.
        self.last_frame = self._squeeze_frame(
            frame, F.padded_capacity(self.builder.orb.n_features))
        self.init_frame_id = frame.frame_id
        self.state = TrackState.OK

    def _squeeze_frame(self, frame: Frame, n: int) -> Frame:
        """Row-subset a frame to capacity n: point-bound rows first, then
        the unbound valid rows of highest response. The frame itself when
        it already fits."""
        if frame.capacity <= n:
            return frame
        bound = frame.pt_idx >= 0
        resp = np.where(frame.valid, frame.response, -np.inf)
        order = np.lexsort((-resp, ~bound))  # bound rows first, by response
        rows = np.sort(order[:n])
        fr = Frame(
            frame_id=frame.frame_id, timestamp=frame.timestamp,
            xy=frame.xy[rows], xy_raw=frame.xy_raw[rows],
            octave=frame.octave[rows], angle=frame.angle[rows],
            response=frame.response[rows], desc=frame.desc[rows],
            valid=frame.valid[rows], depth=frame.depth[rows],
            ur=frame.ur[rows], patch=frame.patch[rows], xy0=frame.xy0[rows],
            ur0=frame.ur0[rows])
        fr.pose = frame.pose
        fr.pt_idx = frame.pt_idx[rows]
        fr._refined = frame._refined[rows]
        return fr

    def _reset_initialization(self, pt_ids, kfs):
        self.map.remove_points(pt_ids)
        for k in kfs:
            self.map.remove_keyframe(k)

    def _frame_from_mats(self, fmat, imat, desc, patch, frame_id,
                         timestamp) -> Frame:
        """A host Frame from the packed feature arrays of TrackFrameOut /
        MonoInitOut (the decode of _ensure_features)."""
        fr = Frame(
            frame_id=frame_id, timestamp=timestamp,
            xy=fmat[:, 0:2].copy(), xy_raw=fmat[:, 2:4].copy(),
            octave=imat[:, 0].copy(), angle=fmat[:, 9].copy(),
            response=fmat[:, 10].copy(), desc=desc,
            valid=imat[:, 4] != 0, depth=fmat[:, 8].copy(),
            ur=fmat[:, 6].copy(), patch=patch.astype(np.float32),
            xy0=fmat[:, 4:6].copy(), ur0=fmat[:, 7].copy())
        fr._refined = imat[:, 3] != 0
        return fr

    def _mono_init_fused(self, img, timestamp) -> np.ndarray | None:
        """MonocularInitialization (src/Tracking.cpp:729-832) on the fused
        device step (engine_step.mono_init_step): one call and one 16-float
        readback per attempt; the feature and point tensors of both frames
        are read once, on success."""
        ib = self.init_builder
        N = F.padded_capacity(ib.orb.n_features)
        dev = self.device
        frame_id = ib._next_id
        ib._next_id += 1
        if self._init_ref_args is None:
            if self._init_zero is None:
                self._init_zero = (
                    torch.zeros((N, 2), dtype=torch.float32, device=dev),
                    torch.zeros((N, 8), dtype=torch.int32, device=dev),
                    torch.zeros((N,), dtype=torch.bool, device=dev),
                    torch.zeros((N,), dtype=torch.float32, device=dev),
                    torch.zeros((N, F.PATCH_WIN, F.PATCH_WIN), dtype=torch.uint8,
                                device=dev))
            ref_args = self._init_zero
        else:
            ref_args = self._init_ref_args
        with CK.launches_counted_as("mono_init"):
            out = ES.mono_init_step(
                self._dev(img), *ref_args, self._sf_dev, params=ib.orb,
                cam=self.cfg.camera, generator=self._rng)
        hdr = out.hdr.cpu().numpy()
        n_valid, n_matches, success, n_good = (int(v) for v in hdr[:4])

        def set_ref():
            self._init_out = out
            self._init_meta = (frame_id, timestamp, n_valid)
            self._init_ref_args = (out.fmat[:, 0:2], out.desc,
                                   out.imat[:, 4] != 0, out.fmat[:, 9], out.patch)

        def clear_ref():
            self._init_out = self._init_meta = self._init_ref_args = None

        if self._init_out is None or self._init_meta[2] < 100:
            # (re)pick the reference frame (src/Tracking.cpp:735-754)
            if n_valid > 100:
                set_ref()
            else:
                clear_ref()
            return None
        if n_valid <= 100 or n_matches < 100:  # src/Tracking.cpp:784-790
            clear_ref()
            return None
        if not success or n_good < 50:
            return None  # keep the reference, try the next frame

        # success: read both frames and the init geometry back in one go,
        # then build the initial map
        ro = self._init_out
        host, event = _readback(dict(
            r_fmat=ro.fmat, r_imat=ro.imat, r_desc=ro.desc, r_patch=ro.patch,
            c_fmat=out.fmat, c_imat=out.imat, c_desc=out.desc, c_patch=out.patch,
            idx=out.idx, good=out.good, X=out.X, xy2=out.xy2,
            xy2_raw=out.xy2_raw, refok=out.ref_ok), dev)
        if event is not None:
            event.synchronize()
            host = {k: v.numpy() for k, v in host.items()}
        ref_id, ref_ts, _ = self._init_meta
        ref = self._frame_from_mats(host["r_fmat"], host["r_imat"], host["r_desc"],
                                    host["r_patch"], ref_id, ref_ts)
        frame = self._frame_from_mats(host["c_fmat"], host["c_imat"], host["c_desc"],
                                      host["c_patch"], frame_id, timestamp)
        # the step's feature-metric refinement, applied to the frame's copy
        idx, refok = host["idx"], host["refok"]
        frame.xy[idx[refok]] = host["xy2"][refok]
        frame.xy_raw[idx[refok]] = host["xy2_raw"][refok]
        good = host["good"] & (idx >= 0)
        R = hdr[4:13].reshape(3, 3).astype(np.float32)
        t = hdr[13:16].astype(np.float32)
        with self.map.lock:
            self._create_initial_map_monocular(ref, frame, idx, good, R, t,
                                               host["X"])
            if self.state == TrackState.OK:
                clear_ref()
                self._log_frame(frame, lost=False)
                return frame.pose
        return None

    # --------------------------------------------------------------- tracking
    def _track_with_motion_model(self, frame: Frame) -> bool:
        """TrackWithMotionModel (src/Tracking.cpp:1161-1243), staged."""
        last = self.last_frame
        self._ensure_features(last)
        frame.pose = se3_np.orthonormalize(
            se3_np.compose(self.velocity, last.pose))
        pt = last.pt_idx
        ok = (pt >= 0) & self.map.pt_valid[np.clip(pt, 0, None)]
        pts_xyz = self.map.pt_xyz[np.clip(pt, 0, None)]
        pt_desc = self.map.pt_desc[np.clip(pt, 0, None)]
        cam = self.cfg.camera
        if self._temporal_points(last):
            # temporal "VO" points: unmatched last-frame features with depth
            # are backprojected for motion-model matching
            # (Tracking::UpdateLastFrame, src/Tracking.cpp:1065-1160).
            # Localization-only, as upstream ORB-SLAM2 gates it on
            # mbOnlyTracking: in mapping mode these points backproject the
            # LAST frame's pose error into pseudo-landmarks that outvote the
            # map in the pose optimization.
            tmp = (~ok) & last.valid & (last.depth > 0) & \
                (last.depth < 2 * self.cfg.close_depth_threshold)
            if tmp.any() and last.pose is not None:
                self.n_temporal_frames += 1
                pts_xyz[tmp] = self._backproject(last, tmp)
                pt_desc[tmp] = last.desc[tmp]
                ok = ok | tmp
        if ok.sum() < 10:
            return False
        th = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        for radius_th in (th, 2 * th):  # widening retry (src/Tracking.cpp:1192)
            res = FM.match_motion_model(
                self._dev(frame.pose), self._dev(pts_xyz), self._dev(ok),
                self._dev(pt_desc), self._dev(last.octave),
                self._dev(last.angle), self._dev(frame.xy),
                self._dev(frame.octave), self._dev(frame.desc),
                self._dev(frame.valid), self._dev(frame.angle),
                self._dev(frame.ur), self._sf_dev,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, float(radius_th))
            midx = res.idx.cpu().numpy()
            n = int((midx >= 0).sum())
            if n >= 20:
                break
        if n < 20:
            return False
        frame.pt_idx = np.full(frame.capacity, -1, np.int32)
        src = np.flatnonzero(midx >= 0)
        frame.pt_idx[midx[src]] = pt[src]
        # temporal matches carry the backprojected position instead
        tmp_src = src[pt[src] < 0]
        if len(tmp_src):
            frame.tmp_xyz[midx[tmp_src]] = pts_xyz[tmp_src]
            frame.tmp_valid[midx[tmp_src]] = True
        # feature-metric re-measurement: map-point matches align to the
        # point's anchor template, temporal matches to the last frame's
        # window (frame-to-frame consistency)
        templates = self.map.pt_patch[np.clip(frame.pt_idx, 0, None)]
        mask = frame.pt_idx >= 0
        if len(tmp_src):
            _ensure_patch(last)
        if len(tmp_src) and last.patch is not None:
            cur = midx[tmp_src]
            templates[cur] = RF.template_of(last.patch[tmp_src])
            mask[cur] = True
        self._refine_measurements(frame, mask, templates)
        n_inl = self._pose_optimize(frame)
        self.matches_inliers = n_inl
        return n_inl >= 10

    def _temporal_points(self, last: Frame) -> bool:
        """Whether the motion model adds the last frame's temporal points:
        stereo and RGB-D, localization-only, and the last frame no keyframe
        (its depth points are in the map then)."""
        return (self.cfg.sensor != Sensor.MONOCULAR and self.localization_only
                and last.frame_id != self.last_kf_frame_id)

    def _backproject(self, frame: Frame, rows) -> np.ndarray:
        """World positions of a frame's features from their depth."""
        cam = self.cfg.camera
        z = frame.depth[rows]
        x = (frame.xy[rows, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[rows, 1] - cam.cy) / cam.fy * z
        Rwc = frame.pose[:, :3].T
        Ow = -Rwc @ frame.pose[:, 3]
        return (np.stack([x, y, z], -1) @ Rwc.T + Ow).astype(np.float32)

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """TrackReferenceKeyFrame (src/Tracking.cpp:1007-1063).

        The match is the node-gated SearchByBoW when a vocabulary is there
        and the keyframe has its gate nodes (the reference always gates by
        FeatureVector node, src/ORBmatcher.cpp:243-299: the gate rejects
        perceptually aliased matches that the global ratio test admits);
        else the ungated ratio match."""
        if self.ref_kf < 0:
            return False
        mp = self.map
        k = self.ref_kf
        has_pt = mp.kf_pt[k] >= 0
        kf_nodes = mp.kf_bow_node[k]
        kf_args = (self._dev(mp.kf_desc[k]), self._dev(has_pt),
                   self._dev(mp.kf_angle[k]))
        fr_args = (self._dev(frame.desc), self._dev(frame.valid),
                   self._dev(frame.angle))
        if self.relocalizer is not None and (kf_nodes >= 0).any():
            _, qnodes = self.relocalizer.frame_bow(frame.desc, frame.valid)
            res = FM.match_by_bow(*kf_args, self._dev(kf_nodes),
                                  *fr_args, self._dev(qnodes))
        else:
            res = FM.match_descriptors_ratio(*kf_args, *fr_args)
        midx = res.idx.cpu().numpy()
        if int((midx >= 0).sum()) < 15:
            return False
        frame.pose = (self.last_frame.pose.copy()
                      if self.last_frame is not None and self.last_frame.pose is not None
                      else mp.kf_pose[k].copy())
        frame.pt_idx = np.full(frame.capacity, -1, np.int32)
        src = np.flatnonzero(midx >= 0)
        frame.pt_idx[midx[src]] = mp.kf_pt[k, src]
        self._refine_against_points(frame, frame.pt_idx >= 0)
        n_inl = self._pose_optimize(frame)
        self.matches_inliers = n_inl
        return n_inl >= 10

    # ----------------------------------------------------------- fused frame
    def _refresh_mirror(self):
        """Sync the device mirror of the map point table: rows dirtied since
        the last sync are copied in place (`index_copy_` on the mirror
        tensors, the counterpart of engine_step.mirror_scatter); a new table
        shape or unknown churn uploads it whole. Patches go as u8 (the
        map's window storage)."""
        mp = self.map
        if self._mirror is not None and self._mirror_gen == mp.generation:
            return

        def host_rows(ids=None):
            sl = slice(None) if ids is None else ids
            return (mp.pt_xyz[sl], mp.pt_desc[sl], _to_u8(mp.pt_patch[sl]),
                    mp.pt_normal[sl], mp.pt_min_dist[sl], mp.pt_max_dist[sl],
                    mp.pt_valid[sl])

        dirty = mp.drain_dirty_points()
        if (self._mirror is None or dirty is None
                or self._mirror[0].shape[0] != mp.pt_xyz.shape[0]):
            self._mirror = tuple(self._dev(a) for a in host_rows())
        elif len(dirty):
            ids = self._dev(dirty.astype(np.int64))
            for m, rows in zip(self._mirror, host_rows(dirty)):
                m.index_copy_(0, ids, self._dev(rows))
        self._mirror_gen = mp.generation

    def _last_dev_arrays(self, last: Frame):
        """Device tensors of the last frame's per-feature arrays — chained
        from the previous fused output when possible, uploaded otherwise."""
        if self._last_dev_frame_id != last.frame_id or self._last_dev is None:
            self._ensure_features(last)
            _ensure_patch(last)
            patch = last.patch if last.patch is not None else np.zeros(
                (last.capacity, F.PATCH_WIN, F.PATCH_WIN), np.float32)
            self._last_dev = dict(
                xy=self._dev(last.xy), desc=self._dev(last.desc),
                octave=self._dev(last.octave), angle=self._dev(last.angle),
                patch=self._dev(_to_u8(patch)),
                valid=self._dev(last.valid), depth=self._dev(last.depth))
            self._last_dev_frame_id = last.frame_id
        return self._last_dev

    def _track_fused(self, img, timestamp, depth_map=None, right_img=None):
        """Steady-state frame: one fused device call
        (engine_step.track_frame_full) + one readback, then host bookkeeping.
        Falls back to the staged path when the motion model fails."""
        mp = self.map
        cfg = self.cfg
        cam = cfg.camera
        last = self.last_frame
        with mp.lock:
            # CheckReplacedInLastFrame + quarantine release
            # (src/Tracking.cpp:372)
            last.pt_idx = mp.resolve_point_ids(last.pt_idx)
            mp.release_retired_points()
            self._refresh_mirror()

            lp_pad, pvalid, best_kf = self._select_local_points(last.pt_idx)
            if lp_pad is None:
                frame = self.builder.build(img, timestamp, depth_map=depth_map,
                                           right_img=right_img)
                return self.track(frame)

            # velocity None -> zero-velocity prediction
            T_pred = (last.pose if self.velocity is None
                      else se3_np.orthonormalize(
                          se3_np.compose(self.velocity, last.pose)))
            tmp_enable = self._temporal_points(last)
            self.n_temporal_frames += int(tmp_enable)
            sensor = SENSOR_NAME[cfg.sensor]
            img_dev = self._dev(img)
            wire_factor = float(cfg.depth_map_factor)
            if sensor == "rgbd":
                d16, wire_factor = _depth_wire(depth_map, cfg.depth_map_factor)
                aux = self._dev(d16.astype(np.int32))
            elif sensor == "stereo":
                aux = self._dev(right_img)
            else:
                aux = img_dev
            ld = self._last_dev_arrays(last)
            out = ES.track_frame_full(
                img_dev, aux, self._dev(T_pred), self._dev(last.pose),
                self._dev(last.pt_idx), ld["xy"], ld["desc"], ld["octave"],
                ld["angle"], ld["patch"], ld["valid"], ld["depth"],
                self._dev(np.asarray(tmp_enable)),
                *self._mirror, self._dev(lp_pad), self._dev(pvalid),
                3.0 if self.n_lost_frames > 0 else 1.0,
                self._sf_dev, self._sig2_dev,
                params=self.builder.orb, cam=cam, sensor=sensor,
                close_th=float(cfg.close_depth_threshold),
                depth_factor=wire_factor,
                log_scale=float(np.log(cfg.orb.scale_factor)))

        # the frame's readback (the photometric windows stay on the device
        # until a fallback or keyframe creation needs them)
        hdr, fmat, imat, desc, in_frustum = (
            t.cpu().numpy() for t in (out.hdr, out.fmat, out.imat, out.desc,
                                      out.in_frustum))
        T2 = hdr[12:24].reshape(3, 4)
        n_cand, n_mm, n_inl1_map, n_inl2_map = (int(v) for v in hdr[24:28])
        with mp.lock:
            return self._track_fused_finish(
                mp, cam, last, timestamp, T2, n_cand, n_mm, n_inl1_map,
                n_inl2_map, imat[:, 1], imat[:, 2], fmat, imat, desc,
                in_frustum, lp_pad, pvalid, best_kf, out)

    def _track_fused_finish(self, mp, cam, last, timestamp, T2, n_cand, n_mm,
                            n_inl1_map, n_inl2_map, kp_mm_row, kp_src_arr,
                            fmat, imat, desc, in_frustum, lp_pad, pvalid,
                            best_kf, out):
        frame = Frame(
            frame_id=self.builder._next_id, timestamp=timestamp,
            xy=fmat[:, 0:2].copy(), xy_raw=fmat[:, 2:4].copy(),
            octave=imat[:, 0].copy(), angle=fmat[:, 9].copy(),
            response=fmat[:, 10].copy(), desc=desc,
            valid=imat[:, 4] != 0, depth=fmat[:, 8].copy(),
            ur=fmat[:, 6].copy(), patch=None,
            xy0=fmat[:, 4:6].copy(), ur0=fmat[:, 7].copy())
        frame._patch_dev = out.patch
        self.builder._next_id += 1
        frame._refined = imat[:, 3] != 0

        N = frame.capacity
        if not (n_cand >= 10 and n_mm >= 20 and n_inl1_map >= 10):
            # staged fallback (TrackReferenceKeyFrame path); frame._refined
            # prevents double refinement of what the fused call refined
            self._last_dev = None
            ok = self._track_reference_keyframe(frame)
            if ok:
                ok = self._track_local_map(frame)
            return self._finish_frame(frame, ok)

        # decode final bindings: kp_src is a last-frame slot (< N) or
        # N + local-map row
        src = kp_src_arr
        is_mm = (src >= 0) & (src < N)
        is_lp = src >= N
        pt_from_mm = last.pt_idx[np.clip(src, 0, N - 1)]
        frame.pt_idx = np.where(
            is_mm, pt_from_mm,
            np.where(is_lp, lp_pad[np.clip(src - N, 0, len(lp_pad) - 1)], -1)
        ).astype(np.int32)
        tmp_kp = is_mm & (pt_from_mm < 0)
        frame.pt_idx[tmp_kp] = -1
        frame.pt_idx = mp.resolve_point_ids(frame.pt_idx)
        frame.tmp_valid = tmp_kp
        if tmp_kp.any():
            self._ensure_features(last)
            frame.tmp_xyz[tmp_kp] = self._backproject(last, src[tmp_kp])
        frame.pose = T2.copy()
        self.ref_kf = best_kf

        # visibility / found bookkeeping (src/Tracking.cpp:1592-1616 + :1286)
        surv_rows = kp_mm_row[kp_mm_row >= 0]
        cur_pts = last.pt_idx[surv_rows]
        cur_pts = cur_pts[cur_pts >= 0]
        mp.pt_visible[lp_pad[in_frustum & pvalid]] += 1
        mp.pt_visible[cur_pts] += 1
        matched = frame.pt_idx[frame.pt_idx >= 0]
        mp.pt_found[matched] += 1

        n_inl = n_inl2_map
        self.matches_inliers = n_inl
        need = 50 if self.n_lost_frames > 0 else 30
        ok = n_inl >= need
        if ok:
            # chain this frame's device tensors into the next fused call
            self._last_dev = dict(
                xy=out.fmat[:, 0:2], desc=out.desc, octave=out.imat[:, 0],
                angle=out.fmat[:, 9], patch=out.patch,
                valid=out.imat[:, 4] != 0, depth=out.fmat[:, 8])
            self._last_dev_frame_id = frame.frame_id
        else:
            self._last_dev = None
        return self._finish_frame(frame, ok)

    def _relocalize(self, frame: Frame) -> bool:
        """Relocalization (src/Tracking.cpp:1800-2028) of a LOST frame."""
        if self.relocalizer is None:
            return self._track_reference_keyframe(frame)
        ok = self.relocalizer.relocalize(frame)
        if ok:
            self.matches_inliers = int((frame.pt_idx >= 0).sum())
            self.last_reloc_frame_id = frame.frame_id
        return ok

    # --------------------------------------------------------------- local map
    def _select_local_points(self, ref_bindings: np.ndarray):
        """Select the local-map slice from a frame's point bindings:
        covisibility voting + neighbour expansion (UpdateLocalKeyFrames,
        src/Tracking.cpp:1665-1760) then the covered point set
        (UpdateLocalPoints, :1630-1663). Returns (lp_pad [cap] int32,
        pvalid [cap] bool, best_kf) or (None, None, -1)."""
        mp = self.map
        cur_pts = ref_bindings[ref_bindings >= 0]
        if len(cur_pts) == 0:
            return None, None, -1
        seen = np.zeros(mp.pt_xyz.shape[0], bool)
        seen[cur_pts] = True
        votes = (seen[np.clip(mp.kf_pt, 0, None)] & (mp.kf_pt >= 0)).sum(axis=1)
        votes[~mp.kf_valid] = 0
        k1 = np.flatnonzero(votes > 0)
        if len(k1) == 0:
            return None, None, -1
        best_kf = int(k1[np.argmax(votes[k1])])
        local_kfs = list(k1[np.argsort(-votes[k1])][:60])
        for k in local_kfs[:10]:
            for kn in mp.covisible_kfs(k, 10):
                if kn not in local_kfs:
                    local_kfs.append(int(kn))
            if len(local_kfs) >= 80:  # cap (src/Tracking.cpp:1730)
                break
        local_kfs = local_kfs[:80]
        # points ordered by keyframe covisibility rank: when the slice
        # exceeds the device cap, the strongest keyframes' points survive
        rows = mp.kf_pt[local_kfs].ravel()
        first = np.unique(rows, return_index=True)[1]
        lp = rows[np.sort(first)]
        lp = lp[(lp >= 0) & mp.pt_valid[np.clip(lp, 0, None)]]
        cap = self.cfg.local_points_cap
        if len(lp) > cap:
            from .utils.metrics import log_event
            log_event("local_points_truncated", total=int(len(lp)), cap=cap)
            lp = lp[:cap]
        pad = cap - len(lp)
        lp_pad = np.concatenate([lp, np.zeros(pad, lp.dtype)]).astype(np.int32)
        pvalid = np.concatenate([np.ones(len(lp), bool), np.zeros(pad, bool)])
        return lp_pad, pvalid, best_kf

    def _track_local_map(self, frame: Frame) -> bool:
        """TrackLocalMap (src/Tracking.cpp:1247-1306) + SearchLocalPoints,
        staged."""
        mp = self.map
        cur_pts = frame.pt_idx[frame.pt_idx >= 0]
        lp_pad, pvalid, best_kf = self._select_local_points(frame.pt_idx)
        if lp_pad is None:
            return False
        self.ref_kf = best_kf
        already = pvalid & np.isin(lp_pad, cur_pts)

        cam = self.cfg.camera
        th = 3.0 if self.n_lost_frames > 0 else 1.0
        res, in_frustum = FM.match_local_points(
            self._dev(frame.pose), self._dev(mp.pt_xyz[lp_pad]),
            self._dev(pvalid), self._dev(mp.pt_desc[lp_pad]),
            self._dev(mp.pt_normal[lp_pad]), self._dev(mp.pt_min_dist[lp_pad]),
            self._dev(mp.pt_max_dist[lp_pad]), self._dev(already),
            self._dev(frame.xy), self._dev(frame.octave),
            self._dev(frame.desc), self._dev(frame.valid),
            self._dev(frame.ur), self._sf_dev,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            cam.width, cam.height, self.cfg.orb.n_levels,
            float(np.log(self.cfg.orb.scale_factor)), float(th))
        midx = res.idx.cpu().numpy()
        frus = in_frustum.cpu().numpy()
        # IncreaseVisible for frustum points + currently matched
        mp.pt_visible[lp_pad[frus & pvalid]] += 1
        mp.pt_visible[cur_pts] += 1
        # bind new associations (only unmatched keypoints get them)
        src = np.flatnonzero(midx >= 0)
        free = frame.pt_idx[midx[src]] < 0
        frame.pt_idx[midx[src[free]]] = lp_pad[src[free]]

        # refine the NEW associations (earlier-stage ones are already done)
        self._refine_against_points(frame, frame.pt_idx >= 0)
        n_inl = self._pose_optimize(frame)
        matched = frame.pt_idx[frame.pt_idx >= 0]
        mp.pt_found[matched] += 1
        self.matches_inliers = n_inl
        # stricter right after a loss (src/Tracking.cpp:1294-1300)
        need = 50 if self.n_lost_frames > 0 else 30
        return n_inl >= need

    # -------------------------------------------------------------- keyframes
    def _need_new_keyframe(self, frame: Frame) -> bool:
        """NeedNewKeyFrame (src/Tracking.cpp:1308-1434):

        - relocalization cooldown: no insert within mMaxFrames of the last
          relocalization while the map is large (:1329)
        - ratioMap (RGB-D): tracked-in-map close points / all close-depth
          candidates (:1352-1372)
        - thRefRatio 0.75, 0.4 when nKFs<2, 0.9 monocular (:1378-1383)
        - thMapRatio 0.35, 0.20 when inliers>300 (:1386-1388)
        - c1a: >= mMaxFrames since the last keyframe
        - c1b: >= mMinFrames and the mapper is idle
        - c1c: non-mono and (inliers < 0.25*ref or ratioMap < 0.3)
        - c2: (inliers < thRefRatio*ref or ratioMap < thMapRatio) and
          inliers > 15
        - insert iff (c1a|c1b|c1c) & c2; when the mapper is busy, interrupt
          its BA (InterruptBA, :1412) and insert only with a short queue
          (< 3, :1417). A mapper without idle() counts as idle."""
        if self.ref_kf < 0:
            return False
        mp = self.map
        n_kfs = mp.n_keyframes
        max_f = self.cfg.max_frames_between_kf
        if (self.last_reloc_frame_id >= 0
                and frame.frame_id < self.last_reloc_frame_id + max_f
                and n_kfs > max_f):
            return False
        min_obs = 3 if n_kfs > 2 else 2
        obs_counts = mp.point_obs_count()
        ref_pts = mp.kf_pt[self.ref_kf]
        ref_matches = int(((ref_pts >= 0) &
                           (obs_counts[np.clip(ref_pts, 0, None)] >= min_obs)).sum())
        ratio_map = 1.0
        if self.cfg.sensor != Sensor.MONOCULAR:
            close = (frame.depth > 0) & \
                (frame.depth < self.cfg.close_depth_threshold) & frame.valid
            pt = frame.pt_idx
            in_map = (pt >= 0) & (obs_counts[np.clip(pt, 0, None)] > 0)
            ratio_map = int((close & in_map).sum()) / max(1, int(close.sum()))
        th_ref = 0.75
        if n_kfs < 2:
            th_ref = 0.4
        if self.cfg.sensor == Sensor.MONOCULAR:
            th_ref = 0.9
        th_map = 0.20 if self.matches_inliers > 300 else 0.35
        lm = self.local_mapper
        idle = getattr(lm, "idle", lambda: True)()
        frames_since = frame.frame_id - self.last_kf_frame_id
        c1a = frames_since >= self.cfg.max_frames_between_kf
        c1b = frames_since >= self.cfg.min_frames_between_kf and idle
        c1c = self.cfg.sensor != Sensor.MONOCULAR and \
            (self.matches_inliers < 0.25 * ref_matches or ratio_map < 0.3)
        c2 = (self.matches_inliers < th_ref * ref_matches
              or ratio_map < th_map) and self.matches_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        lm.interrupt_ba()
        if self.cfg.sensor == Sensor.MONOCULAR:
            return False
        return lm.queue_depth() < 3

    def _create_keyframe(self, frame: Frame):
        """CreateNewKeyFrame (src/Tracking.cpp:1436-1534): the pose is first
        re-optimized against the live map (a block frame's pose was computed
        against a point mirror up to two blocks old; the polish also prunes
        associations that became outliers), then close-depth points are
        spawned for unmatched features (:1459-1519), then the local mapper
        takes the keyframe and the frame adopts its (possibly
        bundle-adjusted) pose."""
        mp = self.map
        lazy = getattr(frame, "_lazy", None)
        polish = frame.pose is not None and (frame.pt_idx >= 0).sum() >= 10
        if lazy is not None and polish:
            # block frame: polish on the device feature slices of the block
            _, outs, row = lazy
            pt = frame.pt_idx
            bound = (pt >= 0) & frame.valid & mp.pt_valid[np.clip(pt, 0, None)]
            fmat_d = outs.fmat[row]
            obs_d = torch.cat([fmat_d[:, 0:2], fmat_d[:, 6:7]], -1)
            info_d = (1.0 / self._sig2_dev)[
                outs.imat[row][:, 0].clamp(0, len(self.sigma2) - 1).long()]
            bound_d = self._dev(bound)
            cam = self.cfg.camera
            res = PO.pose_optimize(
                self._dev(frame.pose), self._dev(mp.pt_xyz[np.clip(pt, 0, None)]),
                obs_d, (fmat_d[:, 6] >= 0) & bound_d, info_d, bound_d,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
            self._ensure_features(frame)
            frame.pose = res.T.cpu().numpy()
            frame.pt_idx = np.where(bound & ~res.inliers.cpu().numpy(), -1,
                                    frame.pt_idx)
            _ensure_patch(frame)
        else:
            self._ensure_features(frame)
            _ensure_patch(frame)
            if polish:
                self._pose_optimize(frame)
        k = mp.add_keyframe(frame.pose, frame.timestamp, frame.frame_id,
                            frame.xy, frame.octave, frame.angle, frame.desc,
                            frame.valid, frame.pt_idx,
                            depth=frame.depth, ur=frame.ur, patch=frame.patch,
                            xy0=frame.xy0, ur0=frame.ur0)
        if self.cfg.sensor != Sensor.MONOCULAR:
            self._spawn_depth_points(frame, k)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        if self.local_mapper is not None:
            self.local_mapper.process(k)
            frame.pose = mp.kf_pose[k].copy()

    def _spawn_depth_points(self, frame: Frame, k: int):
        has_depth = (frame.depth > 0) & frame.valid & (frame.pt_idx < 0)
        close = has_depth & (frame.depth < self.cfg.close_depth_threshold)
        # the reference sorts candidates by depth and inserts every close one
        # PLUS the 100 nearest even beyond ThDepth (src/Tracking.cpp:1477-1487)
        cand = np.flatnonzero(has_depth)
        order = cand[np.argsort(frame.depth[cand])]
        ids = order[close[order] | (np.arange(len(order)) < 100)]
        if len(ids) == 0:
            return
        cam = self.cfg.camera
        mp = self.map
        Twc_R = mp.kf_pose[k, :, :3].T
        Ow = -Twc_R @ mp.kf_pose[k, :, 3]
        z = frame.depth[ids]
        x = (frame.xy[ids, 0] - cam.cx) / cam.fx * z
        y = (frame.xy[ids, 1] - cam.cy) / cam.fy * z
        Xw = np.stack([x, y, z], -1) @ Twc_R.T + Ow
        pt_ids = mp.add_points(Xw.astype(np.float32), frame.desc[ids],
                               ref_kf=k, first_kf=k,
                               patch=(RF.template_of(frame.patch[ids])
                                      if frame.patch is not None else None))
        mp.kf_pt[k, ids] = pt_ids
        frame.pt_idx[ids] = pt_ids
        mp.refresh_point_stats(pt_ids)

    # ----------------------------------------------------------- block driver
    def run_blocked(self, frames, to_gray, block: int = 6,
                    pipeline_depth: int = 2):
        """The pipelined driver: `block` frames per device call
        (engine_step.track_frames_block), with up to `pipeline_depth` blocks
        in flight. Block i+1 is dispatched (its chain = block i's output
        tensors) before block i is read back, so the host's bookkeeping of
        one block overlaps the device work of the next.

        Host bookkeeping (state machine, keyframe decisions, mapping) runs
        per frame after each block's readback; map updates reach the device
        at the next dispatch (staleness of at most 2 blocks, the lag class
        of the reference's concurrent LocalMapping). Initialization, loss
        and tails the chain cannot take fall back to the synchronous
        per-frame path, and so does localization-only mode (the block runs
        without temporal points). A frame that breaks the chain re-tracks the rest of
        its block and every block dispatched on top synchronously.

        frames: (timestamp, {"image", "depth"?, "right"?}) pairs, as the
        sensor needs. While the state is NOT_INITIALIZED (monocular
        initialization takes several frames) each frame runs synchronously.
        Yields (ts, pose or
        None) in order; `last_frame_ms` holds each yielded frame's share of
        its block's time (the gap between yields would charge a whole block
        to its first frame)."""
        buf: list = []
        inflight: list = []  # dispatched, not finished blocks, oldest first
        self.last_frame_ms = 0.0

        def sync_one(item):
            t0 = time.perf_counter()
            pose = self._process_item(item)
            self.last_frame_ms = (time.perf_counter() - t0) * 1e3
            self._blk_chain = None
            return item[0], pose

        def finish_oldest():
            """Finish the oldest in-flight block; on a chain break, drop
            every block dispatched on top of it (their chain started from a
            broken carry) and re-track their frames synchronously."""
            nonlocal inflight
            ok = yield from self._blk_finish(inflight.pop(0))
            if not ok:
                bad, inflight = inflight, []
                self._blk_chain = None
                for ctx in bad:
                    for item in ctx["chunk"][:ctx["n_real"]]:
                        yield sync_one(item)

        def dispatch(chunk, n_real):
            """Dispatch a block, or track its frames synchronously when no
            local-map slice exists."""
            ctx = self._blk_dispatch(chunk)
            if ctx is not None:
                ctx["n_real"] = n_real
                inflight.append(ctx)
                return
            while inflight:
                yield from finish_oldest()
            self._blk_chain = None
            for item in chunk[:n_real]:
                yield sync_one(item)

        def flush(full_only):
            nonlocal buf
            while True:
                # velocity None (first frame after init) is fine: the block
                # seed falls back to a zero-velocity prediction
                can = (self.state == TrackState.OK and self.last_frame is not None
                       and self.last_frame.pose is not None
                       and not self.localization_only)
                if can and len(buf) >= block:
                    chunk, buf = buf[:block], buf[block:]
                    yield from dispatch(chunk, block)
                    if len(inflight) > pipeline_depth:
                        yield from finish_oldest()
                    continue
                # the last, partial block: padded to `block` frames by
                # repeating its last frame; _blk_finish drops the padding
                if not full_only and can and buf:
                    n_real = len(buf)
                    chunk, buf = buf + [buf[-1]] * (block - n_real), []
                    yield from dispatch(chunk, n_real)
                    continue
                # a synchronous frame runs only when frames wait that no
                # block can take (not OK, or the final flush); otherwise the
                # in-flight blocks stay in flight: that overlap is the
                # pipeline
                need_sync = bool(buf) and not (full_only and can)
                if (need_sync or not full_only) and inflight:
                    yield from finish_oldest()
                    continue  # the state may have changed
                if need_sync:
                    item, buf = buf[0], buf[1:]
                    yield sync_one(item)
                    continue
                return

        for ts, data in frames:
            img, depth, right = sequence_item(data, self.cfg.sensor)
            buf.append((ts, to_gray(img), depth,
                        None if right is None else to_gray(right)))
            yield from flush(full_only=True)
        yield from flush(full_only=False)

    def _process_item(self, item):
        """One (ts, gray, depth, right) item of run_blocked through the
        synchronous frame."""
        ts, gray, depth_map, right = item
        return self.process_image(gray, ts, depth_map=depth_map, right_img=right)

    def _blk_seed(self):
        """The chain of the first block after a synchronous frame: the last
        frame's device tensors and the two poses of the constant-velocity
        prediction."""
        last = self.last_frame
        with self.map.lock:
            last.pt_idx = self.map.resolve_point_ids(last.pt_idx)
            ld = self._last_dev_arrays(last)
        # velocity None -> zero-velocity seed (T_prev == T_last makes the
        # on-device constant-velocity prediction the identity)
        T_prev = (last.pose if self.velocity is None else se3_np.compose(
            se3_np.inverse(self.velocity), last.pose).astype(np.float32))
        self._blk_chain = (self._dev(last.pose), self._dev(T_prev),
                           self._dev(last.pt_idx), ld["xy"], ld["desc"],
                           ld["octave"], ld["angle"], ld["patch"], ld["valid"],
                           ld["depth"])
        self._blk_bindings = last.pt_idx

    def _blk_dispatch(self, chunk):
        """Host prep and device call of one block, and the start of its
        readback; nothing waits for the device. Returns a ctx for
        _blk_finish, or None when no local-map slice exists."""
        t0 = time.perf_counter()
        mp = self.map
        cfg = self.cfg
        if self._blk_chain is None:
            self._blk_seed()
        with mp.lock:
            self._refresh_mirror()
            lp_pad, pvalid, best_kf = self._select_local_points(self._blk_bindings)
            if lp_pad is None:
                self._blk_chain = None
                return None
            lp_d, pvalid_d = self._dev(lp_pad), self._dev(pvalid)
        # the device work runs outside the map lock: its inputs are tensors
        # already on the tracker's stream, and the mapper never touches them
        sensor = SENSOR_NAME[cfg.sensor]
        imgs = self._dev(np.stack([c[1] for c in chunk]))
        wire_factor = float(cfg.depth_map_factor)
        if sensor == "rgbd":
            wired = [_depth_wire(c[2], cfg.depth_map_factor) for c in chunk]
            wire_factor = wired[0][1]
            auxs = self._dev(np.stack([w[0] for w in wired]).astype(np.int32))
        elif sensor == "stereo":
            auxs = self._dev(np.stack([c[3] for c in chunk]))
        else:
            auxs = imgs
        outs, chain = ES.track_frames_block(
            imgs, auxs, *self._blk_chain, *self._mirror, lp_d, pvalid_d,
            self._sf_dev, self._sig2_dev, params=self.builder.orb,
            cam=cfg.camera, sensor=sensor,
            close_th=float(cfg.close_depth_threshold),
            depth_factor=wire_factor, log_scale=float(np.log(cfg.orb.scale_factor)))
        self._blk_chain = chain
        host, event = _readback(dict(
            hdr=outs.hdr, fmat=outs.fmat, imat=outs.imat, desc=outs.desc,
            kp_pt=outs.kp_pt, frus=outs.in_frustum), self.device)
        return dict(outs=outs, host=host, event=event, chunk=chunk,
                    lp_pad=lp_pad, pvalid=pvalid, best_kf=best_kf,
                    dispatch_ms=(time.perf_counter() - t0) * 1e3)

    def _blk_finish(self, ctx):
        """Wait for one block's readback and run the per-frame host
        bookkeeping. Yields (ts, pose); returns True while the chain stays
        intact (False: the caller drops the blocks dispatched on top)."""
        t0 = time.perf_counter()
        mp = self.map
        if ctx["event"] is not None:
            ctx["event"].synchronize()
            ctx["host"] = {k: t.numpy() for k, t in ctx["host"].items()}
        h = ctx["host"]
        chunk, n_real = ctx["chunk"], ctx["n_real"]
        lp_pad, pvalid, best_kf = ctx["lp_pad"], ctx["pvalid"], ctx["best_kf"]
        # a frame's share of the block: issuing the block's device work
        # (eager PyTorch spends the block's host time there) and waiting
        # for its readback
        blk_share = (ctx["dispatch_ms"] + (time.perf_counter() - t0) * 1e3) / n_real
        for k in range(n_real):
            t_fin = time.perf_counter()
            ts = chunk[k][0]
            hdr = h["hdr"][k]
            T2 = hdr[12:24].reshape(3, 4)
            n_cand, n_mm, n_inl1_map, n_inl2_map = (int(v) for v in hdr[24:28])
            mm_success = n_cand >= 10 and n_mm >= 20 and n_inl1_map >= 10
            with mp.lock:
                kp_pt = mp.resolve_point_ids(h["kp_pt"][k])
                pose = self._blk_finish_frame(
                    ctx, k, ts, T2, n_inl2_map, kp_pt, lp_pad, pvalid, best_kf,
                    mm_success)
                mp.release_retired_points()
            self.last_frame_ms = blk_share + (time.perf_counter() - t_fin) * 1e3
            yield ts, pose
            if pose is None or self.state != TrackState.OK or not mm_success:
                # chain broken mid-block: the rest of the block re-tracks
                # synchronously
                self._blk_chain = None
                for item in chunk[k + 1:n_real]:
                    t0s = time.perf_counter()
                    pose2 = self._process_item(item)
                    self.last_frame_ms = (time.perf_counter() - t0s) * 1e3
                    yield item[0], pose2
                return False
            self._blk_bindings = self.last_frame.pt_idx
        if n_real < len(chunk):
            self._blk_chain = None  # the chain consumed the padding frames
        return True

    def _blk_finish_frame(self, ctx, k, timestamp, T2, n_inl2_map, kp_pt,
                          lp_pad, pvalid, best_kf, mm_success):
        """Per-frame host bookkeeping of the block driver: a lazy frame (its
        features stay in the block's outputs until keyframe creation or a
        fallback needs them, _ensure_features), the visibility and found
        counters, and the shared state-machine tail."""
        h = ctx["host"]
        frame = Frame(
            frame_id=self.builder._next_id, timestamp=timestamp,
            xy=None, xy_raw=None, octave=None, angle=None, response=None,
            desc=None, valid=h["imat"][k, :, 4] != 0,
            depth=h["fmat"][k, :, 8].copy(), ur=None, n_feat=len(kp_pt))
        self.builder._next_id += 1
        frame._lazy = (h, ctx["outs"], k)
        frame._patch_dev = ctx["outs"].patch[k]
        if not mm_success:
            # the staged fallback needs the features
            self._ensure_features(frame)
            self._last_dev = None
            ok = self._track_reference_keyframe(frame)
            if ok:
                ok = self._track_local_map(frame)
            return self._finish_frame(frame, ok)

        # the block runs without temporal VO candidates: every binding is a
        # map point
        frame.pt_idx = kp_pt.astype(np.int32)
        frame.pose = T2.copy()
        self.ref_kf = best_kf

        # visibility / found bookkeeping (src/Tracking.cpp:1592-1616 + :1286)
        kp_mm = h["imat"][k, :, 1]
        cur_pts = self.last_frame.pt_idx[kp_mm[kp_mm >= 0]]
        mp = self.map
        mp.pt_visible[lp_pad[h["frus"][k] & pvalid]] += 1
        mp.pt_visible[cur_pts[cur_pts >= 0]] += 1
        mp.pt_found[frame.pt_idx[frame.pt_idx >= 0]] += 1

        self.matches_inliers = n_inl2_map
        need = 50 if self.n_lost_frames > 0 else 30
        return self._finish_frame(frame, n_inl2_map >= need)

    def _ensure_features(self, frame: Frame):
        """Fill a lazy block frame's per-feature arrays from its block's
        readback (the photometric windows stay on the device until
        _ensure_patch)."""
        lazy = getattr(frame, "_lazy", None)
        if lazy is None:
            return
        h, _, k = lazy
        frame._lazy = None
        fmat, imat = h["fmat"][k], h["imat"][k]
        frame.xy = fmat[:, 0:2].copy()
        frame.xy_raw = fmat[:, 2:4].copy()
        frame.xy0 = fmat[:, 4:6].copy()
        frame.ur = fmat[:, 6].copy()
        frame.ur0 = fmat[:, 7].copy()
        frame.angle = fmat[:, 9].copy()
        frame.response = fmat[:, 10].copy()
        frame.octave = imat[:, 0].copy()
        frame.desc = h["desc"][k].copy()
        frame._refined = imat[:, 3] != 0

    # ------------------------------------------------------------- trajectory
    def trajectory(self):
        """Recover the full frame trajectory by chaining relative poses
        through the reference keyframes (System::SaveTrajectoryTUM,
        src/System.cpp:307-370)."""
        out_ts, out_T = [], []
        for ts, ref, T_rel, lost in self.frame_log:
            if ref < 0 or lost:  # lost frames carry no reliable pose
                continue
            T_ref = self.map.resolve_kf_pose(ref)
            if T_ref is None:
                continue
            T = se3_np.compose(T_rel, T_ref)
            if not np.isfinite(T).all():
                continue
            out_ts.append(ts)
            out_T.append(T)
        return np.array(out_ts), (np.stack(out_T) if out_T else
                                  np.zeros((0, 3, 4), np.float32))
