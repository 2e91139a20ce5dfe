"""Procedural synthetic RGB-D sequences (no files needed).

The port's own copy of `vtgaussian_slam_tpu/datasets/synthetic.py`; frames
are bit-identical to it for the same arguments (tests/test_torch_slice.py).
A textured box-room interior rendered analytically: per pixel, the camera
ray is intersected with the room's axis-aligned walls; color comes from a
smooth 3D procedural texture, depth is exact camera z. Ground-truth camera
poses follow a smooth trajectory.
"""
from __future__ import annotations

import numpy as np


def _look_at_c2w(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w with camera convention x-right, y-down, z-forward."""
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    up_world = np.array([0.0, 1.0, 0.0])  # room's "down" is +y here
    right = np.cross(up_world, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = pos
    return c2w


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation matrix."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _texture(p: np.ndarray) -> np.ndarray:
    """Smooth multi-frequency 3D texture in [0, 1], shape (..., 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.3 * np.sin(3.1 * x + 1.7 * y) + 0.2 * np.sin(9.3 * z + 0.5)
    g = 0.5 + 0.3 * np.sin(2.3 * y + 1.1 * z) + 0.2 * np.sin(7.7 * x + 1.9)
    b = 0.5 + 0.3 * np.sin(2.9 * z + 1.3 * x) + 0.2 * np.sin(8.5 * y + 0.7)
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


class SyntheticRoomDataset:
    """Implements the RGBDDataset frame contract procedurally."""

    def __init__(
        self,
        num_frames: int = 40,
        height: int = 64,
        width: int = 80,
        room_size=(6.0, 4.0, 6.0),
        seed: int = 0,
        motion_scale: float = 1.0,
        relative_pose: bool = True,
        desired_height: int | None = None,
        desired_width: int | None = None,
        sensor: dict | bool | None = None,
        rot_profile_deg: float = 0.0,
        start: int = 0,
        end: int = -1,
        stride: int = 1,
        **kwargs,
    ):
        # desired_* override the scene config's base resolution (e.g. the 2x
        # densification stream, basedataset contract) — FOV stays constant
        # because fx/fy scale with width, and the seeded trajectory is
        # resolution-independent, so frames at different resolutions are
        # renders of the SAME scene and camera path
        if desired_height:
            height = desired_height
        if desired_width:
            width = desired_width
        self.num_imgs = num_frames
        self.desired_height = height
        self.desired_width = width
        self.room = np.asarray(room_size)
        self.fx = self.fy = 0.8 * width
        self.cx, self.cy = width / 2.0 - 0.5, height / 2.0 - 0.5
        self.name = "synthetic"
        self.png_depth_scale = 1.0

        # smooth trajectory inside the room
        rng = np.random.default_rng(seed)
        c = self.room / 2.0
        t = np.linspace(0, 1, num_frames)
        radius = 0.25 * min(room_size[0], room_size[2]) * motion_scale
        phase = rng.uniform(0, 2 * np.pi)
        pos = np.stack(
            [
                c[0] + radius * np.sin(2 * np.pi * t * 0.5 + phase),
                c[1] + 0.2 * motion_scale * np.sin(2 * np.pi * t * 0.8),
                c[2] + radius * np.cos(2 * np.pi * t * 0.5 + phase) * 0.5,
            ],
            -1,
        )
        # look-target sweep scaled by motion_scale too: real RGB-D sequences
        # rotate well under a degree per frame — keep the synthetic in the
        # same regime so tracking difficulty matches the target domain
        la = 2 * np.pi * t * 0.3 * motion_scale + phase + 0.7
        look = np.stack(
            [
                c[0] + 2.5 * np.sin(la),
                c[1] + 0.3 * np.sin(2 * np.pi * t * 0.4 * motion_scale),
                c[2] + 2.5 * np.cos(la),
            ],
            -1,
        )
        self._poses_abs = np.stack(
            [_look_at_c2w(pos[i], look[i]) for i in range(num_frames)])

        # TUM-like rotational motion profile: integrate a smoothed random
        # angular-velocity signal (peak |omega| = rot_profile_deg per frame)
        # on top of the look-at sweep. fr1-class handheld sequences rotate
        # ~0.8 deg/frame on average with multi-degree peaks — the look-at
        # path alone stays well under that, so tracking never sees the
        # rotation-dominated regime real data lives in.
        if rot_profile_deg:
            om = rng.standard_normal((num_frames, 3))
            k = np.ones(9) / 9.0
            om = np.stack([np.convolve(om[:, i], k, mode="same")
                           for i in range(3)], -1)
            om *= np.deg2rad(rot_profile_deg) / (
                np.linalg.norm(om, axis=1).max() + 1e-12)
            R = np.eye(3)
            for i in range(num_frames):
                R = R @ _so3_exp(om[i])
                self._poses_abs[i, :3, :3] = self._poses_abs[i, :3, :3] @ R

        # RGB-D sensor model (VERDICT round-2 item 3: "depth
        # holes/quantization/noise, exposure variation"). All effects are
        # deterministic per (seed, frame): repeated reads of the same index
        # are bit-identical (prefetchers and the densify stream re-read).
        # sensor={} means "enable with defaults" ({} is falsy)
        if sensor or sensor == {}:
            defaults = dict(
                axial_a=0.0012, axial_b=0.0019,  # sigma(z) = a + b(z-0.4)^2
                #                                   (Kinect axial noise model)
                fb=43.5, disp_levels=8.0,        # disparity quantization:
                #                                   z = fb / (round(d*L)/L)
                hole_rate=0.02,                  # random blob dropout frac
                edge_hole_slope=5.0,             # tan(incidence) = |dz/dpx|
                #                                   * f / z above which depth
                #                                   drops out (grazing/edges;
                #                                   5 ~ 79 deg incidence,
                #                                   resolution-independent)
                exposure=0.10,                   # peak per-frame gain swing
                exposure_period=47.0,
                shot_noise=1.5,                  # RGB sigma in [0,255] units
            )
            defaults.update(sensor if isinstance(sensor, dict) else {})
            self.sensor = defaults
        else:
            self.sensor = None
        self._sensor_seed = seed
        # honor the RGBDDataset start/end/stride contract (base.py:84-88):
        # the pipeline forwards these for every dataset, and silently
        # running the full sequence would make subset configs a no-op
        end = self._poses_abs.shape[0] if end == -1 else end
        self._frame_ids = list(range(start, end, stride))
        self.num_imgs = len(self._frame_ids)
        self._poses_abs = self._poses_abs[start:end:stride]
        if relative_pose:
            from .base import relative_poses_np
            self.poses = relative_poses_np(self._poses_abs)
        else:
            self.poses = self._poses_abs

    def __len__(self):
        return self.num_imgs

    def scaled_intrinsics(self) -> np.ndarray:
        out = np.eye(4, dtype=np.float32)
        out[0, 0], out[1, 1] = self.fx, self.fy
        out[0, 2], out[1, 2] = self.cx, self.cy
        return out

    def render_frame(self, c2w: np.ndarray):
        H, W = self.desired_height, self.desired_width
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        d_cam = np.stack(
            [(u - self.cx) / self.fx, (v - self.cy) / self.fy, np.ones_like(u, float)],
            -1,
        )
        o = c2w[:3, 3]
        d_world = d_cam @ c2w[:3, :3].T  # (H, W, 3)

        # exit distance through the box [0, L]^3 for an interior origin
        with np.errstate(divide="ignore"):
            bound = np.where(d_world > 0, self.room[None, None, :], 0.0)
            t_ax = (bound - o[None, None, :]) / d_world
        t_ax = np.where(np.isfinite(t_ax) & (t_ax > 0), t_ax, np.inf)
        t = t_ax.min(-1)  # (H, W): camera z-depth (d_cam z-component is 1)

        hit = o[None, None, :] + t[..., None] * d_world
        color = _texture(hit) * 255.0
        return color.astype(np.float32), t.astype(np.float32)[..., None]

    def _apply_sensor(self, index: int, color: np.ndarray,
                      depth: np.ndarray):
        """Degrade the ideal render like an RGB-D sensor would. Holes are
        encoded as depth 0 (the invalid-depth convention every loader and
        the loss mask stack already use)."""
        sn = self.sensor
        rng = np.random.default_rng([self._sensor_seed, index])
        z = depth[..., 0].copy()
        H, W = z.shape

        # axial noise grows quadratically with range
        sigma = sn["axial_a"] + sn["axial_b"] * (z - 0.4) ** 2
        z = z + sigma * rng.standard_normal(z.shape).astype(np.float32)

        # structured-light disparity quantization: depth resolution degrades
        # ~z^2 with range (stair-stepping on far walls)
        L = sn["disp_levels"]
        disp_q = np.maximum(np.round(sn["fb"] / z * L) / L, 1e-6)
        z = (sn["fb"] / disp_q).astype(np.float32)

        # dropout: grazing-incidence pixels + random blobs. tan(incidence)
        # ~= |dz per pixel| * f / z — resolution-independent, so the same
        # walls drop out in the base and 2x densify streams
        gy, gx = np.gradient(depth[..., 0])
        zs = np.maximum(depth[..., 0], 1e-6)
        holes = np.hypot(gx, gy) * self.fx / zs > sn["edge_hole_slope"]
        if sn["hole_rate"] > 0:
            # ceil-divide so the tiled blob mask COVERS the frame for any
            # H/W (120 or 680 are not 16-multiples), then crop
            cells = rng.standard_normal((-(-H // 16), -(-W // 16)))
            thresh = np.quantile(cells, 1.0 - sn["hole_rate"],
                                 method="higher")
            holes |= np.kron(cells >= thresh, np.ones((16, 16),
                                                      bool))[:H, :W]
        z[holes] = 0.0

        # exposure variation (auto-exposure drift) + shot noise
        gain = 1.0 + sn["exposure"] * np.sin(
            2 * np.pi * index / sn["exposure_period"]
            + 2 * np.pi * (self._sensor_seed % 97) / 97.0)
        color = color * gain + sn["shot_noise"] * \
            rng.standard_normal(color.shape).astype(np.float32)
        return (np.clip(color, 0.0, 255.0).astype(np.float32),
                z[..., None].astype(np.float32))

    def __getitem__(self, index: int):
        c2w = self._poses_abs[index]
        color, depth = self.render_frame(c2w)
        if self.sensor is not None:
            # key noise by the ORIGINAL frame id so a strided/subset run
            # sees the same per-frame sensor state as the full sequence
            color, depth = self._apply_sensor(self._frame_ids[index],
                                              color, depth)
        return (
            color,
            depth,
            self.scaled_intrinsics(),
            self.poses[index].astype(np.float32),
        )
