"""Where the port's SLAM run parts from the JAX engine's, frame by frame, on
the CPU (a diagnostic, not a test; it takes minutes).

    JAX_PLATFORMS=cpu python tests/trace_cli_parity.py configs/synthetic/smoke.py [FRAMES]

Runs the config's first FRAMES frames (default: all) through the JAX
engine, then through the port twice: with the JAX engine's random draws
injected (mapping keyframes, selection pixels; `test_torch_boundaries`'
recorder) and with its own torch generators. Both packages take their CPU
routes (tracking through the track cache, mapping on the generic route)
and the numpy Canny mask. Per frame it prints each run's Gaussian count
and the port runs' distance from the JAX engine's committed pose; at the
end each run's `eval_sequence` at its training budget (per-frame PSNR,
depth L1, ATE). The first frame whose pose or count differs beyond the
kernels' rounding (poses ~2e-4) is where the runs part.
"""
import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from test_torch_boundaries import _Recorder  # noqa: E402
from vtgaussian_slam_tpu.core import pipeline as JP  # noqa: E402
from vtgaussian_slam_tpu.eval import evaluate as JE  # noqa: E402
from vtgaussian_slam_tpu.ops import image as JI  # noqa: E402
from vtgaussian_slam_tpu_torch.core import pipeline as TP  # noqa: E402
from vtgaussian_slam_tpu_torch.eval import evaluate as TE  # noqa: E402


def _w2c(q, t):
    from scipy.spatial.transform import Rotation
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
    m[:3, 3] = np.asarray(t, np.float64)
    return m


def _pose_gap(a, b):
    """(translation gap m, rotation gap deg) between two w2c matrices."""
    d = np.linalg.inv(a) @ b
    ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(ang)


def main(path, frames=None):
    spec = importlib.util.spec_from_file_location("trace_cfg", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cfg = module.config
    cfg["use_wandb"] = False
    workdir = tempfile.mkdtemp(prefix="trace_")
    cfg["workdir"] = workdir
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)         # the numpy Canny on both
        rec = _Recorder(mp)
        jeng = JP.VTGaussianSLAM(cfg)
        n = min(frames or jeng.num_frames, jeng.num_frames)
        jn = []
        for t in range(n):
            rec.t = t
            if t == 0:
                jeng.process_frame_zero()
            else:
                jeng.process_frame(t)
            jn.append([int(s.n_active) for s in jeng.sections])
            print(f"[jax] frame {t}: n_active {jn[-1]}", flush=True)
        jeng._page_cold_finish()
    jq, jt = np.asarray(jeng.traj.quats), np.asarray(jeng.traj.trans)
    runs = {}
    for name, hooks in (("port, JAX draws", rec.port_hooks()),
                        ("port, own draws", {})):
        torch.manual_seed(0)
        teng = TP.VTGaussianSLAM(cfg, device="cpu", **hooks)
        teng.frame_limit = n
        for t in range(n):
            teng.process_frame(t)
            tq = teng.traj.quats[t].numpy()
            tt = teng.traj.trans[t].numpy()
            dtr, drot = _pose_gap(_w2c(jq[t], jt[t]), _w2c(tq, tt))
            ns = [s.n_active for s in teng.sections]
            print(f"[{name}] frame {t}: n_active {ns} (JAX {jn[t]}, "
                  f"{'same' if ns == jn[t] else 'DIFFERENT'}) | pose vs JAX "
                  f"{dtr * 100:.5f} cm, {drot:.5f} deg | max |dq| "
                  f"{np.abs(tq - jq[t]).max():.2e}, max |dt| "
                  f"{np.abs(tt - jt[t]).max():.2e}", flush=True)
        teng._page_cold_finish()
        runs[name] = teng
    kw = lambda e: dict(
        sil_thres=cfg["mapping"]["sil_thres"],
        mapping_iters=cfg["mapping"]["num_iters"],
        add_new_gaussians=cfg["mapping"]["add_new_gaussians"],
        eval_every=1, baseframe_every=cfg["baseframe_every"])
    res = {"jax": JE.eval_sequence(
        jeng.dataset, jeng.export_params_ls(), n,
        os.path.join(workdir, "jax"), backend_kwargs=dict(jeng.backend_kwargs),
        **kw(jeng))}
    res["jax"]["psnr_list"] = np.atleast_1d(np.loadtxt(
        os.path.join(workdir, "jax", "psnr.txt")))
    for name, teng in runs.items():
        d = os.path.join(workdir, name.replace(" ", "_").replace(",", ""))
        res[name] = TE.eval_sequence(
            teng.dataset, teng.export_params_ls(), n, d,
            backend_kwargs=dict(teng.backend_kwargs), device="cpu",
            **kw(teng))
        res[name]["psnr_list"] = np.atleast_1d(
            np.loadtxt(os.path.join(d, "psnr.txt")))
        teng.close()
    for name, r in res.items():
        print(f"[{name}] {n} frames: PSNR {r['psnr']:.4f} dB, depth L1 "
              f"{r['depth_l1'] * 100:.4f} cm, ATE {r['ate_rmse'] * 100:.4f} "
              f"cm | per frame PSNR "
              + " ".join(f"{v:.2f}" for v in r["psnr_list"]))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None)
