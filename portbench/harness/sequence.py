"""The frame stream of a cell: a seeded synthetic room, written to disk in
the upstream dataset's own format so that the port reads it through its
loaders, as a user's run reads a Replica or TUM folder.

A frozen, re-parametrised copy of `vtgaussian_slam_tpu_torch/datasets/
synthetic.py` (the box room, its procedural texture and its Kinect sensor
model), in PyTorch so that it renders on the card during set-up. What
changed against that file:

- motion is given per frame (metres and degrees of rotation), not per
  sequence: positions follow a smooth closed curve walked at a constant
  speed, orientations integrate a body-frame angular velocity whose mean
  magnitude is the traffic's rate;
- the camera is the configuration's (size and intrinsics), not one made
  from the image width;
- the sensor model's random draws come from a `torch.Generator` per frame
  keyed by (seed, frame), so one seed gives the same files on any device.

The traffic file (`portbench/traffic/<name>.json`) holds every parameter
of a mix, its camera path (`path_seed`) and its texture (`texture_seed`)
among them, so that every run of a cell does the same work; a run's seed
draws the sensor's noise (and, in the run, the frames the check samples).
`write_sequence` renders the mix and writes the files.
"""
from __future__ import annotations

import json
import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

KINECT = dict(
    axial_a=0.0012, axial_b=0.0019,   # sigma(z) = a + b (z - 0.4)^2 metres
    fb=43.5, disp_levels=8.0,         # z = fb / (round(fb / z * L) / L)
    hole_rate=0.02,                   # share of 16 x 16 blobs dropped
    edge_hole_slope=5.0,              # grazing dropout: |dz/dpx| f / z above
    exposure=0.10, exposure_period=47.0,
    shot_noise=1.5)                   # RGB sigma, 0..255 units
RENDER_BATCH = 8                      # frames rendered per device call


def _smooth(x: np.ndarray, width: int) -> np.ndarray:
    width = min(width, x.shape[0])
    k = np.ones(width) / width
    return np.stack([np.convolve(x[:, i], k, mode="same")
                     for i in range(x.shape[1])], -1)


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def trajectory(traffic: dict) -> np.ndarray:
    """(n, 4, 4) float64 c2w poses (x right, y down, z forward) of the
    traffic's motion: every step moves `trans_m_per_frame` along a smooth
    closed curve, and the mean rotation per frame is `rot_deg_per_frame`
    exactly. The path comes from the mix's own `path_seed`, so every run
    of a cell sees the same geometry in the same order."""
    n = int(traffic["frames"])
    rng = np.random.default_rng([int(traffic["path_seed"]), 7])
    room = np.asarray(traffic["room_size"], np.float64)
    amp = np.asarray(traffic["path_amplitude_m"], np.float64)
    freq = np.array([1.0, 2.0, 1.0]) * rng.uniform(0.8, 1.25, 3)
    phase = rng.uniform(0.0, 2 * np.pi, 3)
    # the curve, densely, then cut at equal arc lengths
    s = np.linspace(0.0, 40 * np.pi, 400_000)
    curve = room / 2 + amp * np.sin(freq[None] * s[:, None] + phase[None])
    arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(curve, axis=0), axis=1))])
    want = np.arange(n) * float(traffic["trans_m_per_frame"])
    if want[-1] > arc[-1]:
        raise ValueError("the path is too short for the traffic's frames")
    pos = np.stack([np.interp(want, arc, curve[:, i]) for i in range(3)], -1)

    # body-frame angular velocity: a steady turn about the camera's down
    # axis, smoothed noise, and bursts; scaled to the mean rate
    w = (np.asarray(traffic["turn_axis"], np.float64)[None] * np.ones((n, 1))
         + float(traffic["rot_noise"]) * np.asarray(
             traffic["rot_noise_axes"], np.float64)[None]
         * _smooth(rng.standard_normal((n, 3)), int(traffic["rot_smooth"])))
    bursts = traffic.get("bursts") or {}
    if bursts:
        env = np.ones(n)
        n_b = max(1, int(round(n / float(bursts["every_frames"]))))
        for c in rng.uniform(0, n, n_b):
            env += float(bursts["gain"]) * np.exp(
                -0.5 * ((np.arange(n) - c) / float(bursts["width_frames"])) ** 2)
        w = w * env[:, None]
    w[0] = 0.0
    mean = np.linalg.norm(w[1:], axis=1).mean()
    w *= np.deg2rad(float(traffic["rot_deg_per_frame"])) / max(mean, 1e-12)

    yaw = rng.uniform(0, 2 * np.pi)
    fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    down = np.array([0.0, 1.0, 0.0])
    right = np.cross(down, fwd)
    R = np.stack([right, down, fwd], 1)
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        R = R @ _so3_exp(w[i])
        poses[i, :3, :3] = R
        poses[i, :3, 3] = pos[i]
        poses[i, 3, 3] = 1.0
    return poses


def texture_phases(texture_seed: int) -> list[float]:
    """The six phases of the room's texture."""
    return [float(x) for x in np.random.default_rng(
        [int(texture_seed), 13]).uniform(0, 2 * np.pi, 6)]


def _texture(p: torch.Tensor, ph) -> torch.Tensor:
    """The synthetic room's smooth 3D texture in [0, 1], its sinusoids
    shifted by the phases `ph` (same frequencies for every seed)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = (0.5 + 0.3 * torch.sin(3.1 * x + 1.7 * y + ph[0])
         + 0.2 * torch.sin(9.3 * z + 0.5 + ph[1]))
    g = (0.5 + 0.3 * torch.sin(2.3 * y + 1.1 * z + ph[2])
         + 0.2 * torch.sin(7.7 * x + 1.9 + ph[3]))
    b = (0.5 + 0.3 * torch.sin(2.9 * z + 1.3 * x + ph[4])
         + 0.2 * torch.sin(8.5 * y + 0.7 + ph[5]))
    return torch.clamp(torch.stack([r, g, b], -1), 0.0, 1.0)


def render(poses: torch.Tensor, cam: dict, room, phases) -> tuple:
    """(B, 4, 4) c2w -> colour (B, H, W, 3) in 0..255 and camera z-depth
    (B, H, W) in metres of the box room's walls, float32."""
    H, W = int(cam["image_height"]), int(cam["image_width"])
    dev = poses.device
    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                          torch.arange(W, device=dev, dtype=torch.float32),
                          indexing="ij")
    d_cam = torch.stack([(u - cam["cx"]) / cam["fx"],
                         (v - cam["cy"]) / cam["fy"], torch.ones_like(u)], -1)
    R = poses[:, :3, :3].float()
    o = poses[:, :3, 3].float()
    d = torch.einsum("hwj,bij->bhwi", d_cam, R)
    L = torch.as_tensor(room, dtype=torch.float32, device=dev)
    bound = torch.where(d > 0, L, torch.zeros_like(L))
    t_ax = (bound - o[:, None, None, :]) / d
    t_ax = torch.where(torch.isfinite(t_ax) & (t_ax > 0), t_ax,
                       torch.full_like(t_ax, float("inf")))
    t = t_ax.min(-1).values
    hit = o[:, None, None, :] + t[..., None] * d
    return _texture(hit, phases) * 255.0, t


def apply_sensor(color: torch.Tensor, depth: torch.Tensor, fx: float,
                 sn: dict, seed: int, index: int):
    """The Kinect model on one frame (H, W, 3) / (H, W): axial noise,
    disparity quantisation, grazing and blob dropout (depth 0), exposure
    drift and shot noise."""
    dev = depth.device
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + int(index)) % (1 << 62))
    z = depth.clone()
    H, W = z.shape
    sigma = sn["axial_a"] + sn["axial_b"] * (z - 0.4) ** 2
    z = z + sigma * torch.randn(z.shape, generator=g, device=dev)
    L = sn["disp_levels"]
    disp_q = torch.clamp(torch.round(sn["fb"] / z * L) / L, min=1e-6)
    z = sn["fb"] / disp_q
    gy, gx = torch.gradient(depth)
    zs = torch.clamp(depth, min=1e-6)
    holes = torch.hypot(gx, gy) * fx / zs > sn["edge_hole_slope"]
    if sn["hole_rate"] > 0:
        cells = torch.randn((-(-H // 16), -(-W // 16)), generator=g, device=dev)
        k = max(1, int(math.ceil(cells.numel() * sn["hole_rate"])))
        thresh = torch.topk(cells.reshape(-1), k).values[-1]
        blob = (cells >= thresh).repeat_interleave(16, 0).repeat_interleave(16, 1)
        holes |= blob[:H, :W]
    z = torch.where(holes, torch.zeros_like(z), z)
    gain = 1.0 + sn["exposure"] * math.sin(
        2 * math.pi * index / sn["exposure_period"]
        + 2 * math.pi * (int(seed) % 97) / 97.0)
    color = color * gain + sn["shot_noise"] * torch.randn(
        color.shape, generator=g, device=dev)
    return torch.clamp(color, 0.0, 255.0), z


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_quat()


def write_sequence(out_dir: str, fmt: str, cam: dict, traffic: dict,
                   seed: int, device, threads: int = 8) -> dict:
    """Render the traffic's frames from `seed` and write them to `out_dir`
    in `fmt` ("replica": results/frame*.jpg, results/depth*.png, traj.txt;
    "tum": rgb/, depth/, rgb.txt, depth.txt, groundtruth.txt at 30 Hz),
    with the camera as `camera.yaml` beside them. Written to
    `<out_dir>.partial` and renamed, so a cut run leaves no half sequence.
    Returns {"frames", "bytes"}."""
    import cv2

    poses = trajectory(traffic)
    phases = texture_phases(traffic["texture_seed"])
    n = poses.shape[0]
    tmp = out_dir + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    sub = ("results",) if fmt == "replica" else ("rgb", "depth")
    for s in sub:
        os.makedirs(os.path.join(tmp, s))
    scale = float(cam["png_depth_scale"])
    sensor = traffic.get("sensor")
    sn = dict(KINECT, **sensor) if sensor is not None else None
    t0 = 1305031102.175304
    stamps = [f"{t0 + i / 30.0:.6f}" for i in range(n)]
    if fmt == "replica":
        names = [(f"results/frame{i:06d}.jpg", f"results/depth{i:06d}.png")
                 for i in range(n)]
    elif fmt == "tum":
        names = [(f"rgb/{s}.png", f"depth/{s}.png") for s in stamps]
    else:
        raise ValueError(f"unknown sequence format {fmt!r}")
    jpeg = [cv2.IMWRITE_JPEG_QUALITY, int(traffic.get("jpeg_quality", 95))]

    def encode(i, rgb, dep):
        c_path, d_path = (os.path.join(tmp, x) for x in names[i])
        params = jpeg if c_path.endswith(".jpg") else []
        if not cv2.imwrite(c_path, rgb[..., ::-1], params):
            raise OSError(f"cannot write {c_path}")
        if not cv2.imwrite(d_path, dep):
            raise OSError(f"cannot write {d_path}")

    futures = []
    with ThreadPoolExecutor(threads) as pool:
        for a in range(0, n, RENDER_BATCH):
            b = min(a + RENDER_BATCH, n)
            color, depth = render(torch.as_tensor(poses[a:b], device=device),
                                  cam, traffic["room_size"], phases)
            for j in range(b - a):
                c, z = color[j], depth[j]
                if sn is not None:
                    c, z = apply_sensor(c, z, float(cam["fx"]), sn, seed, a + j)
                rgb = torch.round(c).clamp(0, 255).to(torch.uint8)
                dep = torch.round(z * scale).clamp(0, 65535).to(torch.int32)
                futures.append(pool.submit(
                    encode, a + j, rgb.cpu().numpy(),
                    dep.cpu().numpy().astype(np.uint16)))
        for f in futures:
            f.result()

    if fmt == "replica":
        with open(os.path.join(tmp, "traj.txt"), "w") as f:
            for p in poses:
                f.write(" ".join(f"{v:.12e}" for v in p.reshape(-1)) + "\n")
    else:
        for kind, col in (("rgb", 0), ("depth", 1)):
            with open(os.path.join(tmp, f"{kind}.txt"), "w") as f:
                f.write(f"# {kind} images\n# timestamp filename\n")
                for s, nm in zip(stamps, names):
                    f.write(f"{s} {nm[col]}\n")
        with open(os.path.join(tmp, "groundtruth.txt"), "w") as f:
            f.write("# ground truth trajectory\n"
                    "# timestamp tx ty tz qx qy qz qw\n")
            for s, p in zip(stamps, poses):
                q = _quat_xyzw(p[:3, :3])
                f.write(s + " " + " ".join(f"{v:.12f}" for v in
                                           (*p[:3, 3], *q)) + "\n")
    with open(os.path.join(tmp, "camera.yaml"), "w") as f:
        json.dump({"dataset_name": fmt, "camera_params": cam}, f, indent=1)
    size = sum(os.path.getsize(os.path.join(r, x))
               for r, _, fs in os.walk(tmp) for x in fs)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.replace(tmp, out_dir)
    return {"frames": n, "bytes": size}
