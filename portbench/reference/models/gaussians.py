"""View-tied Gaussian sections as capacity-padded buffers.

Parity: `vtgaussian_slam_tpu/models/gaussians.py`. Each section keeps
capacity-padded tensors plus an `n_active` count and grows along the same
geometric `round_capacity` ladder, so shapes match the JAX package in the
tests. `n_active` is a host integer here: the engine knows it without a
device read.

Parameter semantics are the reference's: means3D (N,3); rgb_colors (N,3);
unnorm_rotations (N,4) wxyz, init identity; logit_opacities (N,1), init 0;
log_scales (N,1) isotropic, init log(sqrt(mean3_sq_dist)).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.common import resolve_device

DEFAULT_CAPACITY_QUANTUM = 1 << 15  # 32768

PARAM_KEYS = (("means3D", "means3d"), ("rgb_colors", "rgb_colors"),
              ("unnorm_rotations", "unnorm_rotations"),
              ("logit_opacities", "logit_opacities"),
              ("log_scales", "log_scales"))


@dataclass
class GaussianParams:
    means3d: torch.Tensor           # (cap, 3)
    rgb_colors: torch.Tensor        # (cap, 3)
    unnorm_rotations: torch.Tensor  # (cap, 4)
    logit_opacities: torch.Tensor   # (cap, 1)
    log_scales: torch.Tensor        # (cap, 1) isotropic | (cap, 3)

    @property
    def capacity(self) -> int:
        return self.means3d.shape[0]

    @property
    def isotropic(self) -> bool:
        return self.log_scales.shape[1] == 1

    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.logit_opacities[:, 0])

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, a) for _, a in PARAM_KEYS]


@dataclass
class GaussianVars:
    """Side state mirroring the reference `variables` dict."""
    max_2d_radius: torch.Tensor       # (cap,)
    means2d_grad_accum: torch.Tensor  # (cap,)
    denom: torch.Tensor               # (cap,)
    timestep: torch.Tensor            # (cap,)
    scene_radius: float


@dataclass
class Section:
    params: GaussianParams
    vars: GaussianVars
    n_active: int

    @property
    def capacity(self) -> int:
        return self.params.capacity

    def active_mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.params.means3d.device)
                < self.n_active)

    def replace(self, **kw) -> "Section":
        return dataclasses.replace(self, **kw)


@dataclass
class CameraTrajectory:
    quats: torch.Tensor   # (T, 4) unnormalized wxyz w2c rotations
    trans: torch.Tensor   # (T, 3) w2c translations

    @classmethod
    def create(cls, num_frames: int, device="cuda",
               dtype=torch.float32) -> "CameraTrajectory":
        device = resolve_device(device)
        q = torch.zeros((num_frames, 4), dtype=dtype, device=device)
        q[:, 0] = 1.0
        return cls(quats=q, trans=torch.zeros((num_frames, 3), dtype=dtype,
                                              device=device))


def round_capacity(n: int, quantum: int = DEFAULT_CAPACITY_QUANTUM) -> int:
    """Capacity bucket for n gaussians: a geometric ladder of x1.25 steps,
    quantum-aligned, so a run sees few distinct buffer shapes."""
    cap = quantum
    while cap < n:
        cap = -(-int(cap * 1.25) // quantum) * quantum
    return cap


def pad_rows(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    if pad == 0:
        return x
    fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], 0)


def _log_scales(mean3_sq_dist: torch.Tensor, isotropic: bool) -> torch.Tensor:
    ls = 0.5 * torch.log(torch.clamp(mean3_sq_dist, min=1e-20))[:, None]
    return ls if isotropic else ls.repeat(1, 3)


def _identity_quats(m: int, like: torch.Tensor) -> torch.Tensor:
    q = torch.zeros((m, 4), dtype=like.dtype, device=like.device)
    q[:, 0] = 1.0
    return q


def init_section(points: torch.Tensor, colors: torch.Tensor,
                 mean3_sq_dist: torch.Tensor, n_valid: int, capacity: int,
                 timestep: float, scene_radius: float,
                 isotropic: bool = True) -> Section:
    """Build a capacity-padded Section from a (possibly padded) point cloud
    whose first n_valid rows are real."""
    M = points.shape[0]
    assert capacity >= M, (capacity, M)
    pad = capacity - M
    params = GaussianParams(
        means3d=pad_rows(points, pad),
        rgb_colors=pad_rows(colors, pad),
        unnorm_rotations=pad_rows(_identity_quats(M, points), pad),
        logit_opacities=pad_rows(points.new_zeros((M, 1)), pad),
        log_scales=pad_rows(_log_scales(mean3_sq_dist, isotropic), pad),
    )
    zeros = points.new_zeros((capacity,))
    vars_ = GaussianVars(
        max_2d_radius=zeros, means2d_grad_accum=zeros.clone(),
        denom=zeros.clone(),
        timestep=pad_rows(points.new_full((M,), float(timestep)), pad),
        scene_radius=float(scene_radius))
    return Section(params=params, vars=vars_, n_active=int(n_valid))


def repad_section(section: Section, new_capacity: int) -> Section:
    """Grow (or shrink to >= n_active) a section's capacity."""
    cap = section.capacity
    assert new_capacity >= section.n_active, (
        "repad below n_active would silently truncate live gaussians")
    if new_capacity == cap:
        return section

    def repad(x):
        if new_capacity > cap:
            return pad_rows(x, new_capacity - cap)
        return x[:new_capacity]

    p, v = section.params, section.vars
    return Section(
        params=GaussianParams(*[repad(x) for x in p.tensors()]),
        vars=GaussianVars(repad(v.max_2d_radius), repad(v.means2d_grad_accum),
                          repad(v.denom), repad(v.timestep), v.scene_radius),
        n_active=section.n_active)


VAR_KEYS = ("max_2d_radius", "means2d_grad_accum", "denom", "timestep")


def map_section(section: Section, fn: Callable[[torch.Tensor], torch.Tensor]
                ) -> Section:
    """The section with `fn` applied to each of its tensors (the Gaussian
    fields and the per-Gaussian statistics), e.g. to move it."""
    p, v = section.params, section.vars
    return Section(
        params=GaussianParams(*[fn(x) for x in p.tensors()]),
        vars=GaussianVars(*[fn(getattr(v, k)) for k in VAR_KEYS],
                          v.scene_radius),
        n_active=section.n_active)


def section_tensors(section: Section) -> list[torch.Tensor]:
    return (section.params.tensors()
            + [getattr(section.vars, k) for k in VAR_KEYS])


def concat_sections(sections: Sequence[Section], capacity: int | None = None,
                    quantum: int = DEFAULT_CAPACITY_QUANTUM
                    ) -> tuple[Section, list[int]]:
    """Fuse sections into one buffer: their active prefixes back to back,
    zero-padded to `capacity` (default round_capacity of the total), with
    the LAST section's scene radius. Returns the fused Section and the
    per-section active sizes (for `split_section`)."""
    sizes = [int(s.n_active) for s in sections]
    total = sum(sizes)
    if capacity is None:
        capacity = round_capacity(total, quantum)

    def cat(xs):
        return pad_rows(torch.cat([x[:n] for x, n in zip(xs, sizes)]),
                        capacity - total)

    params = GaussianParams(*[cat([s.params.tensors()[i] for s in sections])
                              for i in range(len(PARAM_KEYS))])
    vars_ = GaussianVars(*[cat([getattr(s.vars, k) for s in sections])
                           for k in VAR_KEYS], sections[-1].vars.scene_radius)
    return Section(params=params, vars=vars_, n_active=total), sizes


def split_section(fused: Section, sizes: Sequence[int],
                  originals: Sequence[Section]) -> list[Section]:
    """Split a fused buffer back into per-section stores: each original
    keeps its own capacity and has its active prefix overwritten."""
    out = []
    off = 0
    for size, orig in zip(sizes, originals):
        def take(fx, ox):
            return torch.cat([fx[off:off + size], ox[size:]])

        out.append(Section(
            params=GaussianParams(*[take(f, o) for f, o in zip(
                fused.params.tensors(), orig.params.tensors())]),
            vars=GaussianVars(*[take(getattr(fused.vars, k),
                                     getattr(orig.vars, k)) for k in VAR_KEYS],
                              orig.vars.scene_radius),
            n_active=orig.n_active))
        off += size
    return out


@torch.no_grad()
def append_gaussians(section: Section, new_points: torch.Tensor,
                     new_colors: torch.Tensor,
                     new_mean3_sq_dist: torch.Tensor, keep: torch.Tensor,
                     timestep: float) -> Section:
    """Write the kept candidates into the padded tail, in order. Resets
    the densification statistics of every Gaussian like the reference's
    insert. The caller guarantees n_active + sum(keep) <= capacity. The
    section's buffers are updated in place."""
    cap = section.capacity
    n0 = section.n_active
    kept = torch.nonzero(keep).flatten()
    n_new = int(kept.numel())
    assert n0 + n_new <= cap, (n0, n_new, cap)
    dest = slice(n0, n0 + n_new)
    p = section.params
    p.means3d[dest] = new_points[kept]
    p.rgb_colors[dest] = new_colors[kept]
    p.unnorm_rotations[dest] = _identity_quats(n_new, new_points)
    p.logit_opacities[dest] = 0.0
    p.log_scales[dest] = _log_scales(new_mean3_sq_dist[kept], p.isotropic)
    v = section.vars
    zeros = p.means3d.new_zeros((cap,))
    v.timestep[dest] = float(timestep)
    vars_ = GaussianVars(zeros, zeros.clone(), zeros.clone(), v.timestep,
                         v.scene_radius)
    return Section(params=p, vars=vars_, n_active=n0 + n_new)


def section_to_numpy_params(section: Section, traj: CameraTrajectory) -> dict:
    """One section as a reference-format params dict: per-Gaussian arrays
    cropped to n_active, trajectory as [1, 4, T] / [1, 3, T]."""
    n = section.n_active
    p = section.params
    out = {k: getattr(p, a)[:n].detach().cpu().numpy() for k, a in PARAM_KEYS}
    out["cam_unnorm_rots"] = traj.quats.detach().cpu().numpy().T[None]
    out["cam_trans"] = traj.trans.detach().cpu().numpy().T[None]
    return out


def section_from_numpy_params(p: dict, quantum: int = DEFAULT_CAPACITY_QUANTUM,
                              timestep: float = 0.0, device="cuda"
                              ) -> tuple[Section, CameraTrajectory]:
    """Load a reference-format params dict (the JAX package's
    `section_to_numpy_params` output) into a port Section on `device`."""
    device = resolve_device(device)
    n = np.asarray(p["means3D"]).shape[0]
    cap = round_capacity(n, quantum)

    def pp(x):
        t = torch.as_tensor(np.array(x, np.float32), device=device)
        return pad_rows(t, cap - n)

    params = GaussianParams(*[pp(p[k]) for k, _ in PARAM_KEYS])
    zeros = torch.zeros((cap,), dtype=torch.float32, device=device)
    vars_ = GaussianVars(zeros, zeros.clone(), zeros.clone(),
                         torch.full((cap,), float(timestep), device=device),
                         1.0)
    traj = CameraTrajectory(
        quats=torch.as_tensor(np.asarray(p["cam_unnorm_rots"], np.float32)[0].T
                              .copy(), device=device),
        trans=torch.as_tensor(np.asarray(p["cam_trans"], np.float32)[0].T
                              .copy(), device=device))
    return Section(params=params, vars=vars_, n_active=n), traj
