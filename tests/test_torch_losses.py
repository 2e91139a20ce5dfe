"""PyTorch port vs the JAX package: the masked SLAM losses and SSIM.

Values and gradients with respect to the rendered colour and depth; the
mask stack (valid depth, outlier median, silhouette with the adaptive
threshold sweep, auxiliary mask) must select the same pixels. Sums over
~2k pixels in another order: rtol 1e-5; SSIM's blur runs as two 1D
convolutions instead of shift-adds: 1e-5 on values, 1e-4 relative to the
largest entry on gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import H, W, assert_close_scaled, np_
from vtgaussian_slam_tpu.core import losses as JL
from vtgaussian_slam_tpu.ops.ssim import ssim as j_ssim
from vtgaussian_slam_tpu_torch.core import losses as TL
from vtgaussian_slam_tpu_torch.ops.ssim import ssim as t_ssim


def _render_and_frame(seed):
    rng = np.random.default_rng(seed)
    gt_d = rng.uniform(1.0, 3.0, (1, H, W)).astype(np.float32)
    gt_d[0, :5, :7] = 0.0                                 # sensor holes
    gt_c = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    im = np.clip(gt_c + 0.1 * rng.standard_normal(gt_c.shape), 0, 1).astype(
        np.float32)
    depth = (gt_d + 0.05 * rng.standard_normal(gt_d.shape)).astype(np.float32)
    depth[0, 10, 10] += 5.0                               # an outlier
    sil = rng.uniform(0.985, 1.0, (H, W)).astype(np.float32)
    dsq = (depth * depth + 0.01).astype(np.float32)
    aux = rng.uniform(size=(H, W)) > 0.1
    return gt_c, gt_d, im, depth, sil, dsq, aux


def _cfg(mod, tracking, adaptive, outlier):
    if tracking:
        return mod.LossConfig(tracking=True, use_sil_for_loss=True,
                              ignore_outlier_depth_loss=outlier,
                              adaptive_sil=adaptive, im_weight=0.5,
                              depth_weight=0.025)
    return mod.LossConfig(tracking=False, use_sil_for_loss=False,
                          ignore_outlier_depth_loss=outlier, adaptive_sil=False,
                          im_weight=1.0, depth_weight=1.0)


@pytest.mark.parametrize("tracking,adaptive,outlier,use_aux,first", [
    (True, True, False, False, True),
    (True, True, False, True, False),
    (True, False, True, True, False),
    (False, False, False, False, False),
    (False, False, True, False, False),
])
def test_loss_from_render_matches_jax(tracking, adaptive, outlier, use_aux,
                                      first):
    gt_c, gt_d, im, depth, sil, dsq, aux = _render_and_frame(0)

    def j_loss(im_, d_):
        r = JL.RenderResult(im=im_, depth=d_, silhouette=jnp.asarray(sil),
                            depth_sq=jnp.asarray(dsq), radii=jnp.zeros(1))
        out = JL.loss_from_render(
            r, JL.Frame(color=jnp.asarray(gt_c), depth=jnp.asarray(gt_d)),
            _cfg(JL, tracking, adaptive, outlier), jnp.asarray(0.99),
            jnp.asarray(first), jnp.asarray(aux) if use_aux else None)
        return out.loss, out

    (ref, rout), (g_im, g_d) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(im), jnp.asarray(depth))

    t_im = torch.as_tensor(im).requires_grad_(True)
    t_d = torch.as_tensor(depth).requires_grad_(True)
    r = TL.RenderResult(im=t_im, depth=t_d, silhouette=torch.as_tensor(sil),
                        depth_sq=torch.as_tensor(dsq), radii=torch.zeros(1))
    out = TL.loss_from_render(
        r, TL.Frame(color=torch.as_tensor(gt_c), depth=torch.as_tensor(gt_d)),
        _cfg(TL, tracking, adaptive, outlier), 0.99, first,
        torch.as_tensor(aux) if use_aux else None)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(out.im_loss), float(rout.im_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out.depth_loss), float(rout.depth_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out.sil_thres_out),
                               float(rout.sil_thres_out))
    assert_close_scaled(t_im.grad, g_im, 1e-4, "d im")
    assert_close_scaled(t_d.grad, g_d, 1e-4, "d depth")


def test_adaptive_threshold_picks_a_nonempty_candidate():
    gt_c, gt_d, im, depth, sil, dsq, _ = _render_and_frame(1)
    sil = np.full_like(sil, 0.9955)       # only 0.990 / 0.993 / 0.995 cover
    r = TL.RenderResult(im=torch.as_tensor(im), depth=torch.as_tensor(depth),
                        silhouette=torch.as_tensor(sil),
                        depth_sq=torch.as_tensor(dsq), radii=torch.zeros(1))
    out = TL.loss_from_render(
        r, TL.Frame(color=torch.as_tensor(gt_c), depth=torch.as_tensor(gt_d)),
        _cfg(TL, True, True, False), 0.99, True)
    assert float(out.sil_thres_out) in (np.float32(0.990), np.float32(0.993),
                                        np.float32(0.995))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ref, g_ref = jax.value_and_grad(j_ssim)(jnp.asarray(a), jnp.asarray(b))
    ta = torch.as_tensor(a).requires_grad_(True)
    val = t_ssim(ta, torch.as_tensor(b))
    val.backward()
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-5)
    assert_close_scaled(ta.grad, g_ref, 1e-4, "d ssim")


def test_lower_median_is_torch_median():
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(100).astype(
        np.float32))
    assert float(TL.lower_median(x)) == float(torch.median(x))
    assert float(TL.lower_median(x)) == float(
        jnp.quantile(jnp.asarray(np_(x)), 0.5, method="lower"))
