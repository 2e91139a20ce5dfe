"""PyTorch port vs the JAX package: the record-space blend (K4) and the
tile renderer over it.

The Pallas blend multiplies (1 - alpha) by a log-step lane product and sums
colors with a matmul; the port multiplies in slot order. Forward tolerance:
rtol 1e-4 / atol 1e-5 (f32 product and summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (H, N_TILES, POSE_Q, POSE_T, TILES_X, W, jax_cam,
                             jax_params, np_, scene_np, torch_cam,
                             torch_params)
from vtgaussian_slam_tpu.core.losses import render_slam as j_render
from vtgaussian_slam_tpu.ops.rasterizer.pallas_blend import blend_tiles
from vtgaussian_slam_tpu_torch.core.losses import render_slam as t_render
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB

MPT = 128
C = 8


def make_records(seed, dense=True):
    """Random per-tile records (n_tiles, 16, mpt) + counts, as the Pallas
    blend tests build them; dense cases fill whole tiles."""
    rng = np.random.default_rng(seed)
    recs = np.zeros((N_TILES, MPT, 16), np.float32)
    counts = rng.integers(5, MPT + 1 if dense else 20, N_TILES).astype(np.int32)
    counts[0] = MPT
    for t in range(N_TILES):
        ty, tx = divmod(t, TILES_X)
        n = counts[t]
        recs[t, :n, 0] = tx * 16 + rng.uniform(-2, 18, n)
        recs[t, :n, 1] = ty * 16 + rng.uniform(-2, 18, n)
        a = rng.uniform(0.05, 0.5, n)
        cc = rng.uniform(0.05, 0.5, n)
        recs[t, :n, 2] = a
        recs[t, :n, 3] = rng.uniform(-0.1, 0.1, n) * np.sqrt(a * cc)
        recs[t, :n, 4] = cc
        recs[t, :n, 5] = rng.uniform(0.1, 0.99, n)
        recs[t, :n, 6:6 + C] = rng.uniform(0, 1, (n, C))
    return np.ascontiguousarray(recs.transpose(0, 2, 1)), counts


@pytest.mark.parametrize("seed,dense", [(0, True), (3, False), (7, True)])
def test_k4_matches_pallas(seed, dense):
    recs, counts = make_records(seed, dense)
    ref = blend_tiles(jnp.asarray(recs), jnp.asarray(counts), TILES_X, 128, C,
                      True)
    got = CB.blend_forward(torch.as_tensor(recs), torch.as_tensor(counts),
                           TILES_X, C)
    assert got.shape == (N_TILES, 256, C)
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("span_cap,mpt", [(3, 128), (2, 256)])
def test_render_tiled_matches_jax(span_cap, mpt):
    p = scene_np(700, 4)
    bk = {"span_cap": span_cap, "max_pairs_per_tile": mpt, "chunk": 128}
    active = np.ones(700, bool)
    active[-50:] = False
    ref = j_render(jax_params(p), jnp.asarray(active), jnp.asarray(POSE_Q),
                   jnp.asarray(POSE_T), jax_cam(), dict(bk, use_pallas=True))
    got = t_render(torch_params(p), torch.as_tensor(active),
                   torch.as_tensor(POSE_Q), torch.as_tensor(POSE_T),
                   torch_cam(), bk)
    assert got.im.shape == (3, H, W)
    for f in ("im", "depth", "silhouette", "depth_sq"):
        np.testing.assert_allclose(np_(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np_(got.radii), np.asarray(ref.radii))



def test_render_tiled_five_channels_matches_jax():
    """render_tiled itself, with fewer colour channels than the kernel's 8."""
    from vtgaussian_slam_tpu.ops.rasterizer.tiled import render_tiled as j_rt
    from vtgaussian_slam_tpu_torch.ops.rasterizer.tiled import render_tiled as t_rt
    p = scene_np(500, 6)
    rng = np.random.default_rng(6)
    cols = rng.uniform(0, 1, (500, 5)).astype(np.float32)
    scales = np.exp(p["log_scales"]).astype(np.float32)
    op = (1 / (1 + np.exp(-p["logit_opacities"][:, 0]))).astype(np.float32)
    kw = dict(span_cap=3, max_pairs_per_tile=200, chunk=128)
    ref_img, ref_r = j_rt(jnp.asarray(p["means3D"]),
                          jnp.asarray(p["unnorm_rotations"]),
                          jnp.asarray(scales), jnp.asarray(op),
                          jnp.asarray(cols), jax_cam(), None, use_pallas=True,
                          **kw)
    img, radii = t_rt(torch.as_tensor(p["means3D"]),
                      torch.as_tensor(p["unnorm_rotations"]),
                      torch.as_tensor(scales), torch.as_tensor(op),
                      torch.as_tensor(cols), torch_cam(), None, **kw)
    assert img.shape == (5, H, W)
    np.testing.assert_allclose(np_(img), np.asarray(ref_img), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(np_(radii), np.asarray(ref_r))
