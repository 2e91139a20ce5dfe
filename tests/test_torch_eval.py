"""The port's evaluation against the JAX package's, on the CPU.

- `ms_ssim` on numpy images from a seed at 48x64 (3 scales), 240x320 and
  680x1200 (5 scales; 680 is odd after 3 halvings, so the zero-padded
  pooling runs), and at an odd size: relative error <= 1e-5 (f32 blurs and
  means summed in another order).
- `eval_backend_kwargs` equal to JAX's (less its `use_pallas`) on several
  (N, H, W).
- `eval_sequence` of both packages on one params_ls: the JAX `init_section`
  of smoke frame 0 (the synthetic smoke scene, 48x64), exported with a
  3-frame trajectory near the ground truth, scored over 3 frames with
  eval_every 1 (default budget) and 2 (`eval_backend_kwargs`' budget, the
  skip path reading `dataset.poses`): per-frame PSNR within 1e-3 dB,
  depth L1 / RMSE, MS-SSIM and LPIPS within 1e-5 relative, the ATE within
  1e-6 m, and the same files and PNG folders.
- `frame_metrics`' silhouette masking; `_save_frame_pngs`' files equal to
  the JAX package's byte for byte, and a clear error before any render
  when OpenCV, which writes them, does not import.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtgaussian_slam_tpu.core.densify import \
    first_frame_pointcloud as j_first_pc
from vtgaussian_slam_tpu.core.losses import Frame as JFrame
from vtgaussian_slam_tpu.datasets.synthetic import SyntheticRoomDataset
from vtgaussian_slam_tpu.eval import evaluate as JE
from vtgaussian_slam_tpu.eval.lpips import lpips_fn as j_lpips_fn
from vtgaussian_slam_tpu.models import gaussians as JG
from vtgaussian_slam_tpu.ops import geometry as jgeo
from vtgaussian_slam_tpu.ops.camera import setup_camera as j_setup_camera
from vtgaussian_slam_tpu.ops.ssim import ms_ssim as j_ms_ssim
from vtgaussian_slam_tpu_torch.eval import evaluate as TE
from vtgaussian_slam_tpu_torch.eval.lpips import lpips_fn as t_lpips_fn
from vtgaussian_slam_tpu_torch.ops.ssim import ms_ssim as t_ms_ssim

SMOKE = dict(num_frames=11, height=48, width=64, seed=1, motion_scale=0.1)
EVAL_FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def _first_exp_spent():
    """In a process that also imports JAX, the first multi-threaded
    `torch.exp` on the CPU can come back ~1e-4 off on one thread's share of
    the tensor; later calls are exact. Spend that first call here."""
    torch.exp(torch.randn(1 << 20))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Whole engines and evaluations on the CPU: one intra-op thread, so
    that pytest-xdist's workers (each with torch's default of a thread per
    core) do not oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


@pytest.mark.parametrize("hw", [(48, 64), (240, 320), (680, 1200), (75, 91)])
def test_ms_ssim_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    a = rng.uniform(0, 1, (3,) + hw).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    want = float(j_ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(t_ms_ssim(torch.as_tensor(a), torch.as_tensor(b)))
    assert _rel(got, want) <= 1e-5, (got, want)
    # identical images: every clipped term is 1
    assert float(t_ms_ssim(torch.as_tensor(a), torch.as_tensor(a))) == \
        pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("n,hw,tpu", [
    (3000, (48, 64), dict(span_cap=3, max_pairs_per_tile=256, blend_chunk=64)),
    (120_000, (240, 320), dict(span_cap=2, max_pairs_per_tile=1024)),
    (816_000, (680, 1200), dict(span_cap=2)),
    (2_400_000, (680, 1200), None),
    (0, (40, 48), {}),
])
def test_eval_backend_kwargs_match_jax(n, hw, tpu):
    params_ls = [{"means3D": np.zeros((n // 2, 3), np.float32)},
                 {"means3D": np.zeros((n, 3), np.float32)}]
    want = JE.eval_backend_kwargs(params_ls, *hw, tpu)
    want.pop("use_pallas")
    assert TE.eval_backend_kwargs(params_ls, *hw, tpu) == want


def _smoke_params_ls():
    """The JAX init_section of smoke frame 0, exported with a trajectory of
    EVAL_FRAMES poses: the ground truth, perturbed from frame 1 on."""
    ds = SyntheticRoomDataset(**SMOKE)
    color, depth, K, _ = ds[0]
    cam = j_setup_camera(color.shape[1], color.shape[0], K[:3, :3])
    frame = JFrame(color=jnp.asarray(np.transpose(color, (2, 0, 1)) / 255.0),
                   depth=jnp.asarray(np.transpose(depth, (2, 0, 1))))
    pts, cols, msq, keep = (np.asarray(x) for x in j_first_pc(frame, cam))
    n = int(keep.sum())
    cap = JG.round_capacity(n, 4096)
    fit = lambda x, fill=0.0: np.concatenate(
        [x[keep], np.full((cap - n,) + x.shape[1:], fill, x.dtype)])
    sec = JG.init_section(jnp.asarray(fit(pts)), jnp.asarray(fit(cols)),
                          jnp.asarray(fit(msq, 1.0)), n, cap, 0.0,
                          float(depth.max()) / 3)
    rng = np.random.default_rng(7)
    quats, trans = [], []
    for t in range(EVAL_FRAMES):
        w2c = np.linalg.inv(np.asarray(ds.poses[t], np.float64))
        if t:
            w2c[:3, 3] += rng.normal(0, 0.004, 3)
        q, tr = jgeo.w2c_to_pose(jnp.asarray(w2c, jnp.float32))
        quats.append(np.asarray(q))
        trans.append(np.asarray(tr))
    traj = JG.CameraTrajectory(quats=jnp.asarray(np.stack(quats)),
                               trans=jnp.asarray(np.stack(trans)))
    return ds, [JG.section_to_numpy_params(sec, traj)]


@pytest.fixture(scope="module")
def smoke_case():
    return _smoke_params_ls()


def _both_evals(tmp_path, ds, params_ls, eval_every, budget):
    kw = dict(sil_thres=0.5, mapping_iters=60, add_new_gaussians=True,
              eval_every=eval_every, baseframe_every=5, save_frames=True)
    j_bk = t_bk = None
    if budget:
        j_bk = JE.eval_backend_kwargs(params_ls, 48, 64, {"span_cap": 3})
        t_bk = TE.eval_backend_kwargs(params_ls, 48, 64, {"span_cap": 3})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = JE.eval_sequence(ds, params_ls, EVAL_FRAMES, jdir,
                            lpips_fn=j_lpips_fn(), backend_kwargs=j_bk, **kw)
    got = TE.eval_sequence(ds, params_ls, EVAL_FRAMES, tdir,
                           lpips_fn=t_lpips_fn(device="cpu"),
                           backend_kwargs=t_bk, device="cpu", **kw)
    return want, got, jdir, tdir


@pytest.mark.parametrize("eval_every,budget", [(1, False), (2, True)])
def test_eval_sequence_matches_jax(tmp_path, smoke_case, eval_every, budget):
    ds, params_ls = smoke_case
    want, got, jdir, tdir = _both_evals(tmp_path, ds, params_ls, eval_every,
                                        budget)
    n_eval = len(range(0, EVAL_FRAMES, eval_every))
    load = lambda d, k: np.atleast_1d(np.loadtxt(os.path.join(d, f"{k}.txt")))
    for k in ("psnr", "rmse", "l1", "ssim", "lpips"):
        j, t = load(jdir, k), load(tdir, k)
        assert j.shape == t.shape == (n_eval,), (k, j.shape, t.shape)
        assert np.isfinite(t).all(), (k, t)
        if k == "psnr":
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)
        else:
            assert _rel(t, j).max() <= 1e-5, (k, t, j)
    assert abs(got["ate_rmse"] - want["ate_rmse"]) <= 1e-6
    assert 0 < got["ate_rmse"] < 0.05
    for sub in ("rendered_rgb", "rendered_depth", "rgb", "depth"):
        assert sorted(os.listdir(os.path.join(tdir, sub))) == \
            sorted(os.listdir(os.path.join(jdir, sub)))
        assert len(os.listdir(os.path.join(tdir, sub))) == n_eval


def test_eval_sequence_covered_prefix_and_presence_mask(tmp_path, smoke_case,
                                                        capsys):
    """More frames than the saved trajectory covers: the covered prefix is
    scored, with a warning; mapping_iters 0 without densification masks by
    the silhouette on both sides."""
    ds, params_ls = smoke_case
    kw = dict(mapping_iters=0, add_new_gaussians=False, baseframe_every=5)
    want = JE.eval_sequence(ds, params_ls, 11, str(tmp_path / "j"), **kw)
    got = TE.eval_sequence(ds, params_ls, 11, str(tmp_path / "t"),
                           device="cpu", **kw)
    assert "covered prefix" in capsys.readouterr().out
    for k in ("psnr", "depth_l1", "depth_rmse", "ms_ssim"):
        assert _rel(got[k], want[k]) <= (1e-4 if k == "psnr" else 1e-5), k
    assert np.isnan(got["lpips"]) and np.isnan(want["lpips"])
    assert len(np.atleast_1d(np.loadtxt(tmp_path / "t" / "psnr.txt"))) == 3


def test_frame_pngs_equal_jax_files(tmp_path):
    """The four PNGs of a frame, out-of-range values included, byte for
    byte as the JAX package writes them."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    im = rng.uniform(-0.1, 1.1, (3, 37, 53)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 37, 53))
    depth = rng.uniform(-1, 7, (1, 37, 53)).astype(np.float32)
    gt_depth = rng.uniform(0, 6, (1, 37, 53))
    subs = ("rendered_rgb", "rendered_depth", "rgb", "depth")
    for d, save in ((tmp_path / "jax", JE._save_frame_pngs),
                    (tmp_path / "port", TE._save_frame_pngs)):
        for sub in subs:
            os.makedirs(d / sub)
        save(str(d), 4, im, depth, gt, gt_depth)
    for sub in subs:
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        assert len(names) == 1
        assert ((tmp_path / "port" / sub / names[0]).read_bytes()
                == (tmp_path / "jax" / sub / names[0]).read_bytes())


def test_frame_pngs_without_cv2_fail_before_rendering(tmp_path, smoke_case,
                                                      monkeypatch):
    """save_frames without OpenCV: an ImportError that names cv2, raised
    before the first render, and no frame folder written."""
    ds, params_ls = smoke_case
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_cv2)

    def no_render(*args, **kwargs):
        raise AssertionError("rendered before the cv2 check")
    monkeypatch.setattr(TE, "render_slam", no_render)
    with pytest.raises(ImportError, match="cv2"):
        TE.eval_sequence(ds, params_ls, EVAL_FRAMES, str(tmp_path / "t"),
                         baseframe_every=5, save_frames=True, device="cpu")
    assert not (tmp_path / "t" / "rgb").exists()
