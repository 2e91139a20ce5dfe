"""The ranks of the CPU process groups that tests/test_torch_parallel.py
starts (gloo, `torch.multiprocessing.spawn`). Importable without JAX, so a
spawned rank starts fast: it reads its inputs from `inputs.npz` in the run
directory and writes what it computed to `rank<r>.npz` there."""
import os
import socket
import time

import numpy as np
import torch

from torch_port_util import H, W, smoke_config, torch_cam, torch_params

TRACK_ITERS = MAP_ITERS = 6
MPT = 128
ENGINE_FRAMES = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_group(fn, world: int, args: tuple, timeout_s: float = 300.0):
    """Run fn(rank, *args) in `world` spawned processes; raise if any fails
    or the group is not done within timeout_s (its ranks are killed)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"the {world}-rank group did not finish "
                                   f"within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def engine_config(workdir, mesh_devices: int = 1):
    """The smoke config at 40 x 48 with 3 iterations per loop,
    baseframe_every 2 (frame 2 is a boundary, frame 3 maps with the global
    term), on the cached tracking and binned mapping routes."""
    cfg = smoke_config(workdir, frames=8, height=H, width=W, iters=3,
                       baseframe_every=2, use_wandb=False)
    cfg["tpu"].update(map_binned=True, track_cache=True, prefetch=0,
                      mesh_devices=mesh_devices)
    return cfg


def _loss_cfgs():
    from vtgaussian_slam_tpu_torch.core.losses import LossConfig
    bk = tuple(sorted({"span_cap": 2, "max_pairs_per_tile": MPT,
                       "chunk": 128}.items()))
    track = LossConfig(tracking=True, use_sil_for_loss=True,
                       ignore_outlier_depth_loss=True, adaptive_sil=True,
                       im_weight=0.5, depth_weight=0.025, backend_kwargs=bk)
    mapping = LossConfig(tracking=False, use_sil_for_loss=False,
                         ignore_outlier_depth_loss=False, adaptive_sil=False,
                         im_weight=0.5, depth_weight=1.0, backend_kwargs=bk)
    return track, mapping


def run_loops(inp: dict, group=None) -> dict:
    """The cached tracking loop and the binned mapping loop (with the global
    term) on the inputs, sharded over `group` (None: one process), and the
    first tracking render's accum."""
    from vtgaussian_slam_tpu_torch.core import map_cache as MC
    from vtgaussian_slam_tpu_torch.core.losses import Frame
    from vtgaussian_slam_tpu_torch.core.mapping import (KeyframeBuffer,
                                                        MappingConfig,
                                                        map_frame_binned)
    from vtgaussian_slam_tpu_torch.core.track_cache import (build_track_cache,
                                                            render_cached)
    from vtgaussian_slam_tpu_torch.core.tracking import (TrackingConfig,
                                                         init_track_state,
                                                         track_frame_cached)
    from vtgaussian_slam_tpu_torch.parallel import engine as PE
    cam = torch_cam()
    tp = PE.tile_pad_for(2)
    params = torch_params(inp_params(inp, "p"))
    fixed = torch_params(inp_params(inp, "f"))
    n, nf = params.means3d.shape[0], fixed.means3d.shape[0]
    act, f_act = torch.ones(n, dtype=torch.bool), torch.ones(nf, dtype=torch.bool)
    frame = Frame(color=torch.as_tensor(inp["color"]),
                  depth=torch.as_tensor(inp["depth"]))
    q0, t0 = torch.as_tensor(inp["q0"]), torch.as_tensor(inp["t0"])
    lt, lm = _loss_cfgs()
    track_fn, map_fn = track_frame_cached, map_frame_binned
    if group is not None:
        track_fn = PE.make_track_frame_cached_sharded(group)
        map_fn = PE.make_map_frame_binned_sharded(group)

    cache = build_track_cache(params, act, q0, t0, cam, span_cap=2,
                              max_pairs_per_tile=MPT, chunk=128, tile_pad=tp)
    with torch.no_grad():
        r0 = (render_cached(cache, q0, t0, cam) if group is None else
              PE.render_cached_sharded(cache, q0, t0, cam, group))
    tcfg = TrackingConfig(num_iters=TRACK_ITERS, lr_quat=4e-4, lr_trans=2e-3,
                          metric="loss", loss_cfg=lt)
    st, im_h, d_h = track_fn(cache, init_track_state(q0, t0, 0.99), frame,
                             None, cam, tcfg)

    qi, ti = torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)
    kfc = MC.build_kf_cache(params, act, qi, ti, cam, span_cap=2,
                            max_pairs_per_tile=MPT, tile_pad=tp)
    gc = MC.build_global_cache(fixed, f_act, params, act, qi, ti, cam,
                               span_cap=2, max_pairs_per_tile=MPT, tile_pad=tp)
    kf = KeyframeBuffer(colors=frame.color[None], depths=frame.depth[None],
                        count=1, quats=qi[None], trans=ti[None],
                        frame_ids=[40])      # a base frame: the global term on
    mcfg = MappingConfig(
        num_iters=MAP_ITERS,
        lrs=(("log_scales", 0.005), ("logit_opacities", 0.05),
             ("means3D", 0.0), ("rgb_colors", 0.0025),
             ("unnorm_rotations", 0.0)),
        loss_cfg=lm, use_global=True, baseframe_every=40)
    mp, m_h = map_fn(params, kf, [kfc], [0], cam, mcfg,
                     draws=[0] * MAP_ITERS, gc=gc)
    return dict(img0=torch.cat([r0.im, r0.depth, r0.silhouette[None]]).numpy(),
                best_quat=st.best_quat.numpy(), best_trans=st.best_trans.numpy(),
                im_h=im_h.numpy(), d_h=d_h.numpy(), map_h=m_h.numpy(),
                rgb=mp.rgb_colors.numpy(), lo=mp.logit_opacities.numpy(),
                ls=mp.log_scales.numpy())


def inp_params(inp: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in inp.items()
            if k.startswith(prefix + "_")}


def run_render_and_steps(inp: dict, group=None) -> dict:
    """`sharded_render` (group) or `render_tiled` (None) of the scene, and
    two sharded tracking / mapping steps (group) or their one-process
    counterparts."""
    from vtgaussian_slam_tpu_torch.ops.rasterizer.tiled import render_tiled
    from vtgaussian_slam_tpu_torch.parallel import sharded as PS
    from vtgaussian_slam_tpu_torch.parallel.engine import TileGroup
    cam = torch_cam()
    p = torch_params(inp_params(inp, "p"))
    n = p.means3d.shape[0]
    act = torch.ones(n, dtype=torch.bool)
    kw = dict(max_pairs_per_tile=MPT, chunk=128)
    one = TileGroup(rank=0, world=1) if group is None else group
    if group is None:
        img = render_tiled(p.means3d, p.unnorm_rotations,
                           torch.exp(p.log_scales), p.opacities(),
                           p.rgb_colors, cam, act, **kw)[0]
    else:
        img = PS.sharded_render(p.means3d, p.unnorm_rotations,
                                torch.exp(p.log_scales), p.opacities(),
                                p.rgb_colors, cam, group, act, **kw)
    gt_c = torch.as_tensor(inp["color"])
    gt_d = torch.as_tensor(inp["depth"])
    q, t = torch.as_tensor(inp["q0"]), torch.as_tensor(inp["t0"])
    rk = tuple(sorted(kw.items()))
    out = dict(img=img.detach().numpy())
    for i in range(2):
        loss, q, t = PS.sharded_tracking_step(p, act, q, t, gt_c, gt_d, cam,
                                              one, raster_kwargs=rk)
        out[f"track_loss{i}"] = loss.numpy()
        mloss, p = PS.sharded_mapping_step(
            p, act, torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), gt_c, gt_d,
            cam, one, raster_kwargs=rk, lr=0.01)
        out[f"map_loss{i}"] = mloss.numpy()
    out.update(q=q.numpy(), t=t.numpy(), rgb=p.rgb_colors.numpy(),
               ls=p.log_scales.numpy())
    return out


def run_engine(workdir, mesh_devices: int):
    """ENGINE_FRAMES frames of the engine on the CPU: the trajectory and
    the export."""
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    eng = VTGaussianSLAM(engine_config(workdir, mesh_devices), device="cpu")
    try:
        eng.run(ENGINE_FRAMES)
    finally:
        eng.close()
    assert len(eng.sections) == 2 and eng.fixed_section_ids is not None
    out = dict(quats=eng.traj.quats[:ENGINE_FRAMES].numpy(),
               trans=eng.traj.trans[:ENGINE_FRAMES].numpy())
    for i, sec in enumerate(eng.export_params_ls()):
        for k, v in sec.items():
            out[f"sec{i}_{k}"] = v
    return out


def rank_main(rank: int, world: int, port: int, run_dir: str):
    """One rank: join the gloo group, run every sharded scenario on the
    inputs and save the results."""
    torch.set_num_threads(1)
    from vtgaussian_slam_tpu_torch.parallel import engine as PE
    PE.init_process_group(rank, world, "cpu", "gloo",
                          f"tcp://localhost:{port}", timeout_s=120.0)
    try:
        group = PE.make_mesh(world)
        inp = dict(np.load(os.path.join(run_dir, "inputs.npz")))
        out = {}
        for k, v in run_loops(inp, group).items():
            out[f"loops_{k}"] = v
        for k, v in run_render_and_steps(inp, group).items():
            out[f"render_{k}"] = v
        for k, v in run_engine(os.path.join(run_dir, f"engine{rank}"),
                               world).items():
            out[f"engine_{k}"] = v
        try:
            PE.make_mesh(world + 1)
        except ValueError as e:
            out["mismatch_error"] = np.array(str(e))
        np.savez(os.path.join(run_dir, f"rank{rank}.npz"), **out)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
