"""PyTorch port vs the JAX package: projection and tile binning.

Integer outputs (tables, counts, inverse maps) must match bit for bit on the
same projected inputs: both sides sort the same fused int32 key stably."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (N_TILES, TILES_X, assert_close_scaled, jax_cam,
                             np_, scene_np, torch_cam)
from vtgaussian_slam_tpu.ops.rasterizer import binning as JB
from vtgaussian_slam_tpu.ops.rasterizer.projection import \
    project_gaussians as j_project
from vtgaussian_slam_tpu_torch.ops.rasterizer import binning as TB
from vtgaussian_slam_tpu_torch.ops.rasterizer.projection import \
    ProjectedGaussians as TProj
from vtgaussian_slam_tpu_torch.ops.rasterizer.projection import \
    project_gaussians as t_project

MPT = 128


def _means_cam(n, seed):
    p = scene_np(n, seed)
    m = p["means3D"].copy()
    m[:5, 2] = 0.1          # behind the near plane: culled
    return p, m


def _project_both(n=600, seed=0):
    p, m = _means_cam(n, seed)
    scales = np.exp(p["log_scales"])
    op = 1 / (1 + np.exp(-p["logit_opacities"][:, 0]))
    active = np.ones(n, bool)
    active[-7:] = False
    jproj = j_project(jnp.asarray(m), jnp.asarray(p["unnorm_rotations"]),
                      jnp.asarray(scales), jnp.asarray(op, jnp.float32),
                      jax_cam(), jnp.asarray(active))
    tproj = t_project(torch.as_tensor(m), torch.as_tensor(p["unnorm_rotations"]),
                      torch.as_tensor(scales),
                      torch.as_tensor(op.astype(np.float32)), torch_cam(),
                      torch.as_tensor(active))
    return jproj, tproj


def test_projection_matches_jax():
    jproj, tproj = _project_both()
    np.testing.assert_array_equal(np_(tproj.valid), np.asarray(jproj.valid))
    assert (~np.asarray(jproj.valid)).sum() >= 12
    # f32 elementwise math in another order: ~1 ulp (1e-6 relative)
    for f in ("mean2d", "conic", "depth", "opacity"):
        np.testing.assert_allclose(np_(getattr(tproj, f)),
                                   np.asarray(getattr(jproj, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(np_(tproj.radius), np.asarray(jproj.radius))


def _same_proj(jproj):
    """The JAX projection handed to the port (identical float inputs)."""
    return TProj(*[torch.as_tensor(np.asarray(x).copy()) for x in jproj])


@pytest.mark.parametrize("select", ["depth", "importance"])
@pytest.mark.parametrize("span_cap", [2, 3])
def test_bin_gaussians_bit_exact(select, span_cap):
    jproj, _ = _project_both()
    ref = JB.bin_gaussians(jproj, 16, span_cap, TILES_X, 3, MPT,
                           with_inverse=True, select=select)
    got = TB.bin_gaussians(_same_proj(jproj), 16, span_cap, TILES_X, 3, MPT,
                           with_inverse=True, select=select)
    counts = np.asarray(ref.counts)
    assert counts.max() == MPT, "the scene must saturate some tiles"
    np.testing.assert_array_equal(np_(got.counts), counts)
    np.testing.assert_array_equal(np_(got.tab), np.asarray(ref.tab))
    np.testing.assert_array_equal(np_(got.inv_pos), np.asarray(ref.inv_pos))
    j_inv = JB.slot_inverse(ref.inv_pos)
    t_inv = TB.slot_inverse(got.inv_pos)
    np.testing.assert_array_equal(np_(t_inv.pos), np.asarray(j_inv.pos))
    np.testing.assert_array_equal(np_(t_inv.w), np.asarray(j_inv.w))


def test_binning_of_own_projection_matches():
    """End to end from each side's own projection (radii are exact)."""
    jproj, tproj = _project_both(seed=3)
    ref = JB.bin_gaussians(jproj, 16, 3, TILES_X, 3, MPT, with_inverse=True,
                           select="importance")
    got = TB.bin_gaussians(tproj, 16, 3, TILES_X, 3, MPT, with_inverse=True,
                           select="importance")
    np.testing.assert_array_equal(np_(got.counts), np.asarray(ref.counts))
    np.testing.assert_array_equal(np_(got.tab), np.asarray(ref.tab))
    np.testing.assert_array_equal(np_(got.inv_pos), np.asarray(ref.inv_pos))


def test_gather_and_apply_slot_inverse():
    jproj, _ = _project_both(seed=1)
    ref = JB.bin_gaussians(jproj, 16, 2, TILES_X, 3, MPT, with_inverse=True,
                           select="importance")
    n = jproj.mean2d.shape[0]
    vals = np.random.default_rng(2).standard_normal((n, 8)).astype(np.float32)
    tab = torch.as_tensor(np.asarray(ref.tab).copy())
    got = TB.gather_channels(torch.as_tensor(vals), tab)
    np.testing.assert_array_equal(
        np_(got), np.asarray(JB.gather_channels(jnp.asarray(vals), ref.tab)))
    flat = np.random.default_rng(3).standard_normal(
        (N_TILES * MPT, 8)).astype(np.float32)
    j_inv = JB.slot_inverse(ref.inv_pos)
    t_inv = TB.slot_inverse(torch.as_tensor(np.asarray(ref.inv_pos).copy()))
    # sums of up to s2 = 4 terms in the same order: 1e-6
    np.testing.assert_allclose(
        np_(TB.apply_slot_inverse(torch.as_tensor(flat), t_inv)),
        np.asarray(JB.apply_slot_inverse(jnp.asarray(flat), j_inv)),
        rtol=1e-6, atol=1e-6)
    # the inverse is the transpose of the gather: <gather(v), f> = <v, inv(f)>
    g3 = np_(got).transpose(0, 2, 1).reshape(-1, 8)
    live = (np.arange(MPT)[None, :] < np.asarray(ref.counts)[:, None]).reshape(-1)
    lhs = (g3[live] * flat[live]).sum()
    flat_live = flat * live[:, None]
    rhs = (vals * np_(TB.apply_slot_inverse(torch.as_tensor(flat_live),
                                            t_inv))).sum()
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_table_gather_matches_jax():
    """Forward bit for bit; the gradient of a loss over in-count slots (the
    only ones the renderers give a cotangent) against `jax.grad` through
    the JAX package's custom VJP, on a real table with its inverse map."""
    import jax
    jproj, _ = _project_both(seed=3)
    ref = JB.bin_gaussians(jproj, 16, 2, TILES_X, 3, MPT, with_inverse=True,
                           select="importance")
    n = jproj.mean2d.shape[0]
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((n, 5)).astype(np.float32)
    w = rng.standard_normal((*ref.tab.shape, 5)).astype(np.float32)
    mask = (np.arange(MPT)[None, :] < np.asarray(ref.counts)[:, None]
            )[..., None].astype(np.float32)
    assert mask.mean() < 1, "some tiles must have slots past their count"
    tab = torch.as_tensor(np.asarray(ref.tab).copy())
    inv = torch.as_tensor(np.asarray(ref.inv_pos).copy())
    v = torch.tensor(vals, requires_grad=True)
    out = TB.table_gather(v, tab, inv)
    np.testing.assert_array_equal(
        np_(out), np.asarray(JB.table_gather(jnp.asarray(vals), ref.tab,
                                             ref.inv_pos)))
    (out * torch.as_tensor(w) * torch.as_tensor(mask)).sum().backward()
    g_ref = jax.grad(lambda x: jnp.sum(JB.table_gather(x, ref.tab, ref.inv_pos)
                                       * w * mask))(jnp.asarray(vals))
    assert_close_scaled(v.grad, g_ref, 1e-6, "table_gather grad")


def test_table_gather_gradcheck():
    """f64 gradcheck on a hand-made table of 2 tiles x 3 slots: slot (1, 2)
    lies past its tile's count (masked), Gaussian 2 owns two slots."""
    tab = torch.tensor([[0, 2, 1], [2, 3, 3]])
    inv = torch.tensor([[0, -1], [2, -1], [1, 3], [4, -1]], dtype=torch.int32)
    mask = torch.tensor([[1.0, 1, 1], [1, 1, 0]])[..., None]
    v = torch.randn(4, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: TB.table_gather(x, tab, inv) * mask, (v,))
