"""The port's dense reference renderer and public `render` API against the
JAX package's, on tests/test_rasterizer.py's inputs (its random scenes
from `jax.random`, converted to numpy and handed to both sides).

Tolerances: the dense images within 1e-5 of JAX's dense images and the
radii exact; the port's tiled route (the plain K4 here) within 2e-4 of the
port's dense render and the radii exact, as tests/test_rasterizer.py holds
the JAX tiled route to its dense one; the dense gradients within 5e-5 of
JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import first_exp_spent, np_, one_thread  # noqa: F401
from vtgaussian_slam_tpu.ops.camera import Camera as JCam
from vtgaussian_slam_tpu.ops.rasterizer import api as JA
from vtgaussian_slam_tpu.ops.rasterizer import render_dense as j_dense
from vtgaussian_slam_tpu_torch.ops.camera import Camera as TCam
from vtgaussian_slam_tpu_torch.ops.rasterizer import api as TA
from vtgaussian_slam_tpu_torch.ops.rasterizer.dense import render_dense


CAM = dict(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)


def make_scene(key, n=200, depth_range=(1.0, 4.0), cam=CAM):
    """tests/test_rasterizer.py's random Gaussians inside the frustum."""
    ks = jax.random.split(key, 6)
    z = jax.random.uniform(ks[0], (n,), minval=depth_range[0],
                           maxval=depth_range[1])
    u = jax.random.uniform(ks[1], (n,), minval=4.0, maxval=cam["width"] - 4.0)
    v = jax.random.uniform(ks[2], (n,), minval=4.0, maxval=cam["height"] - 4.0)
    x = (u - cam["cx"]) / cam["fx"] * z
    y = (v - cam["cy"]) / cam["fy"] * z
    means = jnp.stack([x, y, z], -1)
    quats = jax.random.normal(ks[3], (n, 4))
    scales = jnp.exp(jax.random.uniform(ks[4], (n, 3), minval=-3.5,
                                        maxval=-2.5))
    opac = jax.nn.sigmoid(jax.random.normal(ks[5], (n,)))
    colors = jax.random.uniform(key, (n, 3))
    return tuple(np.array(a) for a in (means, quats, scales, opac, colors))


def _both(scene, cam=CAM, active=None, **kw):
    j = JA.render(*[jnp.asarray(a) for a in scene], JCam(**cam),
                  None if active is None else jnp.asarray(active), **kw)
    t = TA.render(*[torch.as_tensor(a) for a in scene], TCam(**cam),
                  None if active is None else torch.as_tensor(active), **kw)
    return j, t


SCENES = {
    "random0": lambda: make_scene(jax.random.PRNGKey(0)),
    "random1": lambda: make_scene(jax.random.PRNGKey(1)),
    "anisotropic": lambda: make_scene(jax.random.PRNGKey(7), n=64)[:2]
    + (np.array(jnp.exp(jax.random.uniform(
        jax.random.PRNGKey(7), (64, 3), minval=-4.0, maxval=-2.0))),)
    + make_scene(jax.random.PRNGKey(7), n=64)[3:],
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_dense_matches_jax(name):
    scene = SCENES[name]()
    j, t = _both(scene, backend="dense")
    np.testing.assert_allclose(np_(t.image), np.asarray(j.image), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(np_(t.radii), np.asarray(j.radii))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tiled_api_matches_dense_and_jax(name):
    scene = SCENES[name]()
    kw = dict(max_pairs_per_tile=256, chunk=64)
    j, t = _both(scene, backend="tiled", **kw)
    td = TA.render(*[torch.as_tensor(a) for a in scene], TCam(**CAM),
                   backend="dense")
    np.testing.assert_allclose(np_(t.image), np_(td.image), atol=2e-4, rtol=0)
    np.testing.assert_array_equal(np_(t.radii), np_(td.radii))
    np.testing.assert_allclose(np_(t.image), np.asarray(j.image), atol=2e-4,
                               rtol=0)


def test_non_multiple_of_tile_image():
    cam = dict(height=50, width=70, fx=60.0, fy=60.0, cx=35.0, cy=25.0)
    scene = make_scene(jax.random.PRNGKey(5), n=64)
    j, t = _both(scene, cam, backend="dense")
    assert tuple(t.image.shape) == (3, 50, 70)
    np.testing.assert_allclose(np_(t.image), np.asarray(j.image), atol=1e-5,
                               rtol=0)
    tt = TA.render(*[torch.as_tensor(a) for a in scene], TCam(**cam),
                   max_pairs_per_tile=128, chunk=32)
    np.testing.assert_allclose(np_(tt.image), np_(t.image), atol=2e-4, rtol=0)


def test_inactive_and_depth_channels_match():
    means = np.array([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0]], np.float32)
    z = means[:, 2]
    colors = np.stack([z, np.ones_like(z), z * z], -1)
    scene = (means, np.ones((2, 4), np.float32),
             np.full((2, 3), 0.1, np.float32), np.array([0.9, 0.99],
                                                        np.float32), colors)
    j, t = _both(scene, active=np.array([True, False]), backend="dense")
    np.testing.assert_allclose(np_(t.image), np.asarray(j.image), atol=1e-5,
                               rtol=0)
    single = render_dense(*[torch.as_tensor(a[:1]) for a in scene],
                          TCam(**CAM))[0]
    np.testing.assert_allclose(np_(t.image), np_(single), atol=1e-6, rtol=0)


def test_dense_gradients_match_jax():
    means, quats, scales, opac, colors = make_scene(jax.random.PRNGKey(3),
                                                    n=64)
    target = np.zeros((3, CAM["height"], CAM["width"]), np.float32)

    def jloss(m, o, c, s):
        img, _ = j_dense(m, jnp.asarray(quats), s, o, c, JCam(**CAM))
        return jnp.mean(jnp.abs(img - target))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(means), jnp.asarray(opac), jnp.asarray(colors),
        jnp.asarray(scales))
    ts = [torch.as_tensor(a).requires_grad_(True)
          for a in (means, opac, colors, scales)]
    img, _ = render_dense(ts[0], torch.as_tensor(quats), ts[3], ts[1], ts[2],
                          TCam(**CAM))
    (img - torch.as_tensor(target)).abs().mean().backward()
    for a, b in zip(ts, jg):
        np.testing.assert_allclose(np_(a.grad), np.asarray(b), atol=5e-5,
                                   rtol=0)


def test_unknown_backend_raises():
    scene = make_scene(jax.random.PRNGKey(0), n=4)
    with pytest.raises(ValueError):
        TA.render(*[torch.as_tensor(a) for a in scene], TCam(**CAM),
                  backend="nope")
