"""The tile-sharded engine (`vtgaussian_slam_tpu_torch/parallel/`) on the
CPU: two ranks over gloo, started by `torch.multiprocessing.spawn`
(tests/torch_parallel_worker.py), against one process and against the JAX
package's sharded loops on `make_mesh(2)` (the conftest gives JAX 8 CPU
devices).

- The plain K1-K6 on a row slice at tile_offset = r * Tl (and on
  permuted rows through tile_ids) equal the full call's rows.
- Every value the two ranks computed is the same bits on both.
- The sharded tracking and mapping loops equal the one-process loops to
  the bit: the renders, the loss histories, the best pose and the trained
  fields (the backwards gather the kernels' outputs and reduce them in the
  one-process order).
- Against JAX's sharded loops: loss curves within rtol 1e-3 and the best
  pose within 1e-5, as tests/test_torch_track_map.py bounds the one-card
  loops; fields within 99% at 5e-4 + 1e-3 rel and all within lr x
  iterations (Adam turns the kernels' ~1e-4 into ~lr x 1e-3).
- `sharded_render` and the sharded steps equal `render_tiled` and the
  one-process steps to the bit (tests/test_parallel.py holds the JAX
  version within 2e-5).
- A `tpu.mesh_devices = 2` engine run of 4 frames across a boundary: the
  ranks bit-equal, the trajectory and the export equal to the one-rank
  engine's (well inside the 1e-3 m `__graft_entry__.dryrun_multichip`
  allows); the refusals raise."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as PW
from torch_port_util import (H, N_TILES, TILES_X, W, first_exp_spent,  # noqa: F401
                             jax_cam, jax_params, np_, one_thread, scene_np,
                             torch_cam, torch_params)
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS

Q0 = np.array([1.0, 0.004, -0.003, 0.002], np.float32)
T0 = np.array([0.01, -0.008, 0.004], np.float32)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K6", "K4", "K5"])
def test_plain_kernels_on_row_slices_equal_full_rows(kernel):
    from test_torch_cuda import _case, _records
    cam = torch_cam()
    Tl = 4
    if kernel in ("K4", "K5"):
        recs, counts = _records(seed=3)
        out = CB.blend_forward(recs, counts, TILES_X)
        g = torch.as_tensor(np.random.default_rng(5).standard_normal(
            out.shape).astype(np.float32))
        fn = {"K4": lambda sl, **kw: CB.blend_forward(
            recs[sl], counts[sl], TILES_X, **kw),
              "K5": lambda sl, **kw: CB.blend_backward(
            recs[sl], counts[sl], out[sl], g[sl], TILES_X, **kw)}[kernel]
    else:
        slots, counts, R9, t, g = _case()
        out = CS.splat_forward(slots, R9, t, counts, cam, TILES_X)
        wrap = {"K1": None, "K2": CS.splat_backward_pose,
                "K3": CS.splat_backward_vals_rows,
                "K6": CS.splat_backward_all}[kernel]

        def fn(sl, **kw):
            if wrap is None:
                return CS.splat_forward(slots[sl], R9, t, counts[sl], cam,
                                        TILES_X, **kw)
            return wrap(slots[sl], R9, t, counts[sl], out[sl], g[sl], cam,
                        TILES_X, **kw)
    full = fn(slice(None))
    for r in range(-(-N_TILES // Tl)):
        sl = slice(r * Tl, (r + 1) * Tl)
        np.testing.assert_array_equal(np_(fn(sl, tile_offset=r * Tl)),
                                      np_(full[sl]))
    # rows in another order, their image tiles through tile_ids
    perm = torch.as_tensor(np.random.default_rng(1).permutation(N_TILES))
    if kernel in ("K4", "K5"):
        recs, counts = recs[perm].contiguous(), counts[perm].contiguous()
        if kernel == "K5":
            out, g = out[perm].contiguous(), g[perm].contiguous()
    else:
        slots, counts = slots[perm].contiguous(), counts[perm].contiguous()
        out, g = out[perm].contiguous(), g[perm].contiguous()
    got = fn(slice(None), tile_ids=perm.to(torch.int32))
    np.testing.assert_array_equal(np_(got), np_(full[perm]))


def _inputs():
    """A scene, a frozen prefix and a target frame (a render of a denser
    scene), as numpy arrays for both packages and the spawned ranks."""
    from vtgaussian_slam_tpu_torch.core.losses import render_slam
    p, f = scene_np(220, 3), scene_np(150, 6)
    tgt = scene_np(400, 7, logit_lo=1.0, logit_hi=4.0)
    with torch.no_grad():
        r = render_slam(torch_params(tgt), torch.ones(400, dtype=torch.bool),
                        torch.tensor([1.0, 0, 0, 0]), torch.zeros(3),
                        torch_cam(), {"max_pairs_per_tile": 128, "chunk": 128})
    inp = {f"p_{k}": v for k, v in p.items()}
    inp.update({f"f_{k}": v for k, v in f.items()})
    inp.update(color=r.im.numpy(), depth=np.maximum(r.depth.numpy(), 0.1),
               q0=Q0, t0=T0)
    return inp


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and the one-process references."""
    d = str(tmp_path_factory.mktemp("group"))
    inp = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    PW.spawn_group(PW.rank_main, 2, (2, PW.free_port(), d), timeout_s=300.0)
    ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in (0, 1)]
    ref = {f"loops_{k}": v for k, v in PW.run_loops(inp).items()}
    ref.update({f"render_{k}": v for k, v in
                PW.run_render_and_steps(inp).items()})
    ref.update({f"engine_{k}": v for k, v in PW.run_engine(
        os.path.join(d, "one"), 1).items()})
    return inp, ranks, ref


def test_ranks_are_bit_equal(run):
    _, (a, b), _ = run
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_loops_match_one_process(run):
    _, (a, _), ref = run
    for k in ("img0", "best_quat", "best_trans", "im_h", "d_h", "map_h",
              "rgb", "lo", "ls"):
        np.testing.assert_array_equal(a[f"loops_{k}"], ref[f"loops_{k}"],
                                      err_msg=k)


def test_sharded_loops_match_jax_mesh(run):
    from vtgaussian_slam_tpu.core import losses as JL
    from vtgaussian_slam_tpu.core import map_cache as JMC
    from vtgaussian_slam_tpu.core import mapping as JMP
    from vtgaussian_slam_tpu.core import tracking as JT
    from vtgaussian_slam_tpu.core.p2p import make_p2p_target
    from vtgaussian_slam_tpu.core.track_cache import build_track_cache
    from vtgaussian_slam_tpu.parallel.engine import (
        make_map_frame_binned_sharded, make_mesh,
        make_track_frame_cached_sharded, tile_pad_for)
    inp, (a, _), _ = run
    mesh = make_mesh(2)
    tp = tile_pad_for(mesh)
    cam = jax_cam()
    p = jax_params(PW.inp_params(inp, "p"))
    f = jax_params(PW.inp_params(inp, "f"))
    n, nf = p.means3d.shape[0], f.means3d.shape[0]
    frame = JL.Frame(color=jnp.asarray(inp["color"]),
                     depth=jnp.asarray(inp["depth"]))
    bk = tuple(sorted(dict(span_cap=2, max_pairs_per_tile=PW.MPT, chunk=128,
                           use_pallas=True).items()))
    cache = build_track_cache(p, jnp.ones(n, bool), jnp.asarray(Q0),
                              jnp.asarray(T0), cam, span_cap=2,
                              max_pairs_per_tile=PW.MPT, chunk=128,
                              tile_pad=tp)
    tcfg = JT.TrackingConfig(
        num_iters=PW.TRACK_ITERS, lr_quat=4e-4, lr_trans=2e-3, metric="loss",
        p2p_method="sum", loss_cfg=JL.LossConfig(
            tracking=True, use_sil_for_loss=True,
            ignore_outlier_depth_loss=True, adaptive_sil=True, im_weight=0.5,
            depth_weight=0.025, backend_kwargs=bk))
    p2p = make_p2p_target(jnp.zeros((1, 8, 8), jnp.float32), jnp.eye(3),
                          jnp.eye(4))
    st, im_h, d_h = make_track_frame_cached_sharded(mesh)(
        cache, JT.init_track_state(jnp.asarray(Q0), jnp.asarray(T0), 0.99),
        frame, jnp.ones((H, W), bool), p2p, cam, tcfg)
    np.testing.assert_allclose(a["loops_im_h"], np.asarray(im_h), rtol=1e-3)
    np.testing.assert_allclose(a["loops_d_h"], np.asarray(d_h), rtol=1e-3)
    np.testing.assert_allclose(a["loops_best_quat"], np.asarray(st.best_quat),
                               atol=1e-5)
    np.testing.assert_allclose(a["loops_best_trans"],
                               np.asarray(st.best_trans), atol=1e-5)

    qi, ti = jnp.asarray([1.0, 0, 0, 0]), jnp.zeros(3)
    kfc = JMC.build_kf_cache(p, jnp.ones(n, bool), qi, ti, cam, span_cap=2,
                             max_pairs_per_tile=PW.MPT, tile_pad=tp)
    gc = JMC.build_global_cache(f, jnp.ones(nf, bool), p, jnp.ones(n, bool),
                                qi, ti, cam, span_cap=2,
                                max_pairs_per_tile=PW.MPT, tile_pad=tp)
    kf = JMP.KeyframeBuffer(
        colors=frame.color[None], depths=frame.depth[None], quats=qi[None],
        trans=ti[None], frame_ids=jnp.asarray([40], jnp.int32),
        count=jnp.asarray(1, jnp.int32))
    lrs = (("log_scales", 0.005), ("logit_opacities", 0.05), ("means3D", 0.0),
           ("rgb_colors", 0.0025), ("unnorm_rotations", 0.0))
    mcfg = JMP.MappingConfig(
        num_iters=PW.MAP_ITERS, lrs=lrs, loss_cfg=JL.LossConfig(
            tracking=False, use_sil_for_loss=False,
            ignore_outlier_depth_loss=False, adaptive_sil=False,
            im_weight=0.5, depth_weight=1.0, backend_kwargs=bk),
        use_global=True, baseframe_every=40)
    jp, jh = make_map_frame_binned_sharded(mesh)(
        p, kf, jax.tree.map(lambda x: x[None], kfc),
        jnp.zeros((1,), jnp.int32), gc, jax.random.PRNGKey(2), cam, mcfg)
    np.testing.assert_allclose(a["loops_map_h"], np.asarray(jh), rtol=1e-3)
    for key, field, lr in (("rgb", "rgb_colors", 0.0025),
                           ("lo", "logit_opacities", 0.05),
                           ("ls", "log_scales", 0.005)):
        got, ref = a[f"loops_{key}"], np.asarray(getattr(jp, field))
        close = np.abs(got - ref) <= 5e-4 + 1e-3 * np.abs(ref)
        assert close.mean() > 0.99, (field, close.mean())
        assert np.abs(got - ref).max() <= lr * PW.MAP_ITERS, field


def test_sharded_render_and_steps_match_one_process(run):
    _, (a, _), ref = run
    for k in ("img", "track_loss0", "track_loss1", "map_loss0", "map_loss1",
              "q", "t", "rgb", "ls"):
        np.testing.assert_array_equal(a[f"render_{k}"], ref[f"render_{k}"],
                                      err_msg=k)
    assert a["render_track_loss1"] < a["render_track_loss0"]
    assert a["render_map_loss1"] < a["render_map_loss0"]


def test_engine_on_two_ranks_matches_one_rank(run):
    _, (a, _), ref = run
    keys = [k for k in ref if k.startswith("engine_")]
    assert any(k.startswith("engine_sec1_") for k in keys), "a boundary"
    for k in keys:
        np.testing.assert_array_equal(a[k], ref[k], err_msg=k)


def test_refusals(run, tmp_path):
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    _, (a, _), _ = run
    assert "mesh_devices=3" in str(a["mismatch_error"])
    cfg = PW.engine_config(tmp_path, mesh_devices=2)
    cfg["tpu"]["track_cache"] = False
    with pytest.raises(ValueError, match="generic"):
        VTGaussianSLAM(cfg, device="cpu")
    # accepting the unsharded generic loops still needs the process group
    cfg["tpu"]["allow_unsharded_fallback"] = True
    with pytest.raises(ValueError, match="not initialized"):
        VTGaussianSLAM(cfg, device="cpu")
    with pytest.raises(ValueError, match="process group has 1 rank"):
        VTGaussianSLAM(PW.engine_config(tmp_path, mesh_devices=2),
                       device="cpu")
