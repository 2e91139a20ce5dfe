"""PyTorch port vs the JAX package: the fused splat kernels K1-K3.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs the plain PyTorch versions its wrappers take for CPU tensors. The Pallas
kernels build transmittance as exp(cumsum(log1p(-alpha))) with the cumsum as
a matmul and evaluate the Gaussian's quadratic form as an expanded matmul
(pallas_splat.py docstrings: ~1e-4 relative on composited channels); the
port multiplies (1 - alpha) directly. Hence forward rtol 1e-4 / atol 1e-5,
and 1e-3 of the largest entry for gradients (sums of those terms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (N_TILES, POSE_Q, POSE_T, TILES_X,
                             assert_close_scaled, jax_cam, jax_params, np_,
                             scene_np, torch_cam, torch_params)
from vtgaussian_slam_tpu.core import map_cache as JM
from vtgaussian_slam_tpu.core.track_cache import build_track_cache
from vtgaussian_slam_tpu.ops import geometry as jgeo
from vtgaussian_slam_tpu.ops.rasterizer import pallas_splat as PS
from vtgaussian_slam_tpu_torch.core import map_cache as TM
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS

MPT = 128


@pytest.fixture(scope="module")
def case():
    """600 Gaussians on 3 x 3 tiles at mpt 128: saturated tiles, opaque
    splats that end pixels mid-chunk."""
    p = scene_np(600, 0)
    cam = jax_cam()
    q, t = jnp.asarray(POSE_Q), jnp.asarray(POSE_T)
    cache = build_track_cache(jax_params(p), jnp.ones(600, bool), q, t, cam,
                              span_cap=3, max_pairs_per_tile=MPT, chunk=128,
                              select="importance")
    R9 = jgeo.quat_to_rotmat(jgeo.normalize(q)).reshape(9)
    zoff = jnp.zeros((), jnp.int32)
    out = PS._fwd_call(cache.slots8, R9, t, cache.counts, zoff, cam, TILES_X,
                       128, True)
    g = np.random.default_rng(1).standard_normal(out.shape).astype(np.float32)
    g[:, 6:] = 0.0              # channels 6-7 carry no gradient
    pose = PS._bwd_call(cache.slots8, R9, t, cache.counts, zoff, out,
                        jnp.asarray(g), cam, TILES_X, 128, True, "pose")
    rows = PS._bwd_call(cache.slots8, R9, t, cache.counts, zoff, out,
                        jnp.asarray(g), cam, TILES_X, 128, True, "vals_rows")
    T = N_TILES
    tt = lambda x: torch.as_tensor(np.asarray(x)[:T].copy())
    return dict(slots=tt(cache.slots8), counts=tt(cache.counts),
                R9=torch.as_tensor(np.asarray(R9).copy()), t=torch.as_tensor(POSE_T),
                out_ref=np.asarray(out)[:T], g=tt(g),
                pose_ref=np.asarray(pose)[:, 0, :12].sum(0),
                rows_ref=np.asarray(rows)[:T])


def test_camera_vector_matches_jax_and_reuses_constants(case):
    """cp_vector gives the JAX `_cp_vector`'s first 18 entries for any pose,
    and keeps one tensor of camera constants per camera and device."""
    cam, jcam = torch_cam(), jax_cam()
    for k in range(3):
        R9 = case["R9"] * (1.0 + k)
        t = case["t"] + float(k)
        want = np.asarray(PS._cp_vector(jnp.asarray(np_(R9)),
                                        jnp.asarray(np_(t)), jcam))[:18]
        np.testing.assert_array_equal(np_(CS.cp_vector(R9, t, cam)), want)
    consts = CS._CAM_CONSTS[(cam, case["R9"].device)]
    CS.cp_vector(case["R9"], case["t"], cam)
    assert CS._CAM_CONSTS[(cam, case["R9"].device)] is consts
    other = cam._replace(fx=cam.fx * 2.0)
    assert float(CS.cp_vector(case["R9"], case["t"], other)[12]) == other.fx
    assert CS._CAM_CONSTS[(cam, case["R9"].device)] is consts


def test_scene_exercises_saturation_and_termination(case):
    assert int(case["counts"].max()) == MPT
    T_end = case["out_ref"][:, 6]
    assert (T_end == 0).any() and (T_end > 0).any()


def test_k1_forward_matches_pallas(case):
    got = CS.splat_forward(case["slots"], case["R9"], case["t"], case["counts"],
                           torch_cam(), TILES_X)
    assert got.shape == (N_TILES, 8, 256)
    np.testing.assert_allclose(np_(got)[:, :7], case["out_ref"][:, :7],
                               rtol=1e-4, atol=1e-5)


def test_k2_pose_backward_matches_pallas(case):
    out = torch.as_tensor(case["out_ref"].copy())
    part = CS.splat_backward_pose(case["slots"], case["R9"], case["t"],
                                  case["counts"], out, case["g"], torch_cam(),
                                  TILES_X)
    assert part.shape == (N_TILES, 12)
    assert_close_scaled(part.sum(0), case["pose_ref"], 1e-3, "dR, dt")


def test_k3_vals_rows_backward_matches_pallas(case):
    out = torch.as_tensor(case["out_ref"].copy())
    rows = CS.splat_backward_vals_rows(case["slots"], case["R9"], case["t"],
                                       case["counts"], out, case["g"],
                                       torch_cam(), TILES_X)
    assert rows.shape == (N_TILES, MPT, 8)
    ref = case["rows_ref"]
    np.testing.assert_array_equal(np_(rows)[..., :3], 0.0)
    for c in range(3, 8):
        assert_close_scaled(rows[..., c], ref[..., c], 1e-3, f"column {c}")


def test_splat_pose_autograd_gives_k2(case):
    """splat_blend's "pose" backward is K2 summed over tiles."""
    R9 = case["R9"].clone().requires_grad_(True)
    t = case["t"].clone().requires_grad_(True)
    acc = CS.splat_blend(case["slots"], R9, t, case["counts"], torch_cam(),
                         TILES_X, grad_mode="pose")
    (acc * case["g"]).sum().backward()
    got = torch.cat([R9.grad, t.grad])
    assert_close_scaled(got, case["pose_ref"], 1e-3, "autograd dR, dt")


@pytest.mark.parametrize("seed", [2, 5])
def test_splat_binned_gradient_matches_jax(seed):
    """gather + K1 + K3 + inverse map vs the JAX custom VJP under jax.grad."""
    p = scene_np(500, seed)
    jp = jax_params(p)
    cam = jax_cam()
    q, t = jnp.asarray(POSE_Q), jnp.asarray(POSE_T)
    kfc = JM.build_kf_cache(jp, jnp.ones(500, bool), q, t, cam, span_cap=2,
                            max_pairs_per_tile=MPT, select="importance")
    f8 = JM.pack_fields8(jp)
    G = np.random.default_rng(seed).standard_normal(
        (kfc.tab.shape[0], 8, 256)).astype(np.float32)
    G[:, 6:] = 0.0
    G[N_TILES:] = 0.0

    def loss(v8):
        acc = JM.splat_binned(v8, kfc.tab, kfc.inv, kfc.quat, kfc.trans,
                              kfc.counts, cam, 128, True)
        return jnp.sum(acc * jnp.asarray(G)), acc

    (_, acc_ref), g_ref = jax.value_and_grad(loss, has_aux=True)(f8)

    tp = torch_params(p)
    tk = TM.build_kf_cache(tp, torch.ones(500, dtype=torch.bool),
                           torch.as_tensor(POSE_Q), torch.as_tensor(POSE_T),
                           torch_cam(), span_cap=2, max_pairs_per_tile=MPT,
                           select="importance")
    np.testing.assert_array_equal(np_(tk.tab), np.asarray(kfc.tab)[:N_TILES])
    np.testing.assert_array_equal(np_(tk.counts),
                                  np.asarray(kfc.counts)[:N_TILES])
    v8 = TM.pack_fields8(tp).requires_grad_(True)
    acc = TM.splat_binned(v8, tk.tab, tk.inv, tk.quat, tk.trans, tk.counts,
                          torch_cam())
    (acc * torch.as_tensor(G[:N_TILES])).sum().backward()
    np.testing.assert_allclose(np_(acc)[:, :6], np.asarray(acc_ref)[:N_TILES, :6],
                               rtol=1e-4, atol=1e-5)
    g = np_(v8.grad)
    np.testing.assert_array_equal(g[:, :3], 0.0)
    for c in range(3, 8):
        assert_close_scaled(g[:, c], np.asarray(g_ref)[:, c], 1e-3,
                            f"d fields8[:, {c}]")

