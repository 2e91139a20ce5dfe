"""PyTorch port vs the JAX package: the generic render route's kernels and
its gradients.

K5 (the blend backward) and K6 (the splat "all" backward) run as the plain
PyTorch versions their wrappers take for CPU tensors; the JAX side runs its
Pallas kernels in interpret mode. Tolerances, each relative to the largest
entry of the compared array:
  - K5 1e-3, as K2 / K3: both sides do the same f32 sums in another order
    (~1e-6 apart), but the JAX reference itself moves by up to 2e-4
    between a fresh XLA:CPU compile and one loaded from the persistent
    compilation cache (measured on these cases);
  - K6 1e-3, as K2 / K3 (test_torch_splat.py): the Pallas splat kernels
    evaluate transmittance and the quadratic form through matmuls;
  - render_slam gradients 1e-4: K5's sums, carried through the projection
    chain and summed onto the Gaussians in another order (the inverse-map
    gather here, XLA's scatter-add there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (N_TILES, POSE_Q, POSE_T, TILES_X,
                             assert_close_scaled, jax_cam, jax_params,
                             k5_records, np_, scene_np, torch_cam,
                             torch_params)
from vtgaussian_slam_tpu.core import losses as JL
from vtgaussian_slam_tpu.core.track_cache import build_track_cache
from vtgaussian_slam_tpu.ops import geometry as jgeo
from vtgaussian_slam_tpu.ops.rasterizer import pallas_splat as PS
from vtgaussian_slam_tpu.ops.rasterizer.pallas_blend import blend_tiles
from vtgaussian_slam_tpu_torch.core import losses as TL
from vtgaussian_slam_tpu_torch.models import gaussians as TG
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS
from vtgaussian_slam_tpu_torch.ops.rasterizer.projection import \
    project_gaussians as t_project

MPT = 128
C = 8
BK = {"span_cap": 3, "max_pairs_per_tile": 256, "chunk": 128}


@pytest.mark.parametrize("case", [
    dict(seed=0, count_hi=MPT),             # full counts
    dict(seed=3, count_hi=20),              # sparse counts
    # clamped pairs, and tiles whose every pixel stops before the count
    dict(seed=5, count_hi=MPT, op=(0.6, 1.0), conic=(0.005, 0.05)),
])
def test_k5_matches_pallas_vjp(case):
    recs, counts = k5_records(**case)
    f = lambda r: blend_tiles(r, jnp.asarray(counts), TILES_X, 128, C, True)
    out, vjp = jax.vjp(f, jnp.asarray(recs))
    g = np.random.default_rng(case["seed"] + 1).standard_normal(
        out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref).transpose(0, 2, 1)                    # (T, mpt, 16)

    t_recs, t_counts = torch.as_tensor(recs), torch.as_tensor(counts)
    got = np_(CB.blend_backward(t_recs, t_counts,
                                torch.as_tensor(np.asarray(out).copy()),
                                torch.as_tensor(g), TILES_X))
    assert got.shape == (N_TILES, MPT, 16)
    for c in range(6 + C):
        assert_close_scaled(got[..., c], ref[..., c], 1e-3, f"row {c}")
    np.testing.assert_array_equal(got[..., 6 + C:], 0.0)

    w = CB._blend_walk(t_recs, t_counts, TILES_X, torch.arange(N_TILES))
    unwalked = ~np_(w["walked"].any(1))                         # (T, mpt)
    np.testing.assert_array_equal(got[unwalked], 0.0)
    np.testing.assert_array_equal(ref[unwalked], 0.0)
    in_count = np.arange(MPT)[None] < counts[:, None]
    assert unwalked[~in_count].all() and (~in_count).any()
    if "op" in case:
        assert bool((w["clamped"] & w["blended"]).any()), "no clamped pair"
        assert (unwalked & in_count).any(), "no record left after the stop"


@pytest.fixture(scope="module")
def splat_case():
    """The test_torch_splat scene: 600 Gaussians on 3 x 3 tiles at mpt 128
    (saturated tiles, pixels that stop mid-chunk)."""
    p = scene_np(600, 0)
    q, t = jnp.asarray(POSE_Q), jnp.asarray(POSE_T)
    cache = build_track_cache(jax_params(p), jnp.ones(600, bool), q, t,
                              jax_cam(), span_cap=3, max_pairs_per_tile=MPT,
                              chunk=128, select="importance")
    R9 = jgeo.quat_to_rotmat(jgeo.normalize(q)).reshape(9)
    G = np.random.default_rng(1).standard_normal(
        (cache.slots8.shape[0], 8, 256)).astype(np.float32)
    G[:, 6:] = 0.0
    G[N_TILES:] = 0.0          # the JAX kernels' block-padding tiles
    return dict(slots=cache.slots8, counts=cache.counts, R9=R9, t=t, G=G)


@pytest.mark.parametrize("mode", ["all", "vals", "vals_rows"])
def test_splat_blend_grads_match_pallas(splat_case, mode):
    """K6 ("all") and K3 ("vals", "vals_rows") through splat_blend's
    backward vs jax.grad of the JAX splat_blend (mode "vals" there)."""
    c = splat_case
    zoff = jnp.zeros((), jnp.int32)
    jmode = "all" if mode == "all" else "vals"

    def loss(s, R, t):
        acc = PS.splat_blend(s, R, t, c["counts"], zoff, jax_cam(), TILES_X,
                             128, True, jmode)
        return jnp.sum(acc * jnp.asarray(c["G"]))

    gs, gR, gt = jax.grad(loss, argnums=(0, 1, 2))(c["slots"], c["R9"], c["t"])
    tt = lambda x: torch.as_tensor(np.asarray(x)[:N_TILES].copy())
    slots = tt(c["slots"]).requires_grad_(True)
    R9 = torch.as_tensor(np.asarray(c["R9"]).copy()).requires_grad_(True)
    t = torch.as_tensor(np.asarray(c["t"]).copy()).requires_grad_(True)
    acc = CS.splat_blend(slots, R9, t, tt(c["counts"]), torch_cam(), TILES_X,
                         grad_mode=mode)
    (acc * tt(c["G"])).sum().backward()
    ref = np.asarray(gs)[:N_TILES]
    for row in range(8):
        assert_close_scaled(slots.grad[:, row], ref[:, row], 1e-3,
                            f"d slots row {row}")
    assert_close_scaled(R9.grad, gR, 1e-3, "d R")
    assert_close_scaled(t.grad, gt, 1e-3, "d t")
    if mode == "all":
        assert np.abs(ref[:, :3]).max() > 0 and np.abs(np.asarray(gR)).max() > 0


def test_k6_zero_fills_unwalked_slots(splat_case):
    c = splat_case
    tt = lambda x: torch.as_tensor(np.asarray(x)[:N_TILES].copy())
    slots, counts = tt(c["slots"]), tt(c["counts"])
    R9, t = torch.as_tensor(np.asarray(c["R9"]).copy()), torch.as_tensor(POSE_T)
    cam = torch_cam()
    out = CS.splat_forward(slots, R9, t, counts, cam, TILES_X)
    rows = CS.splat_backward_all(slots, R9, t, counts, out, tt(c["G"]), cam,
                                 TILES_X)
    assert rows.shape == (N_TILES, 8, MPT)
    w = CS._walk(slots, counts, CS.cp_vector(R9, t, cam), TILES_X, None)
    unwalked = ~w["walked"].any(1)                              # (T, mpt)
    assert bool(unwalked.any())
    np.testing.assert_array_equal(np_(rows.transpose(1, 2)[unwalked]), 0.0)


def _aniso_np(n, seed):
    """Reference-format params with (N, 3) log-scales and random rotations."""
    p = scene_np(n, seed)
    rng = np.random.default_rng(seed + 100)
    p["log_scales"] = (p["log_scales"] + rng.uniform(-0.4, 0.4, (n, 3))).astype(
        np.float32)
    p["unnorm_rotations"] = rng.standard_normal((n, 4)).astype(np.float32)
    return p


def test_anisotropic_projection_matches_jax():
    from vtgaussian_slam_tpu.ops.rasterizer.projection import \
        project_gaussians as j_project
    p = _aniso_np(500, 8)
    m = p["means3D"].copy()
    m[:4, 2] = 0.1
    sc = np.exp(p["log_scales"])
    op = (1 / (1 + np.exp(-p["logit_opacities"][:, 0]))).astype(np.float32)
    jp = j_project(jnp.asarray(m), jnp.asarray(p["unnorm_rotations"]),
                   jnp.asarray(sc), jnp.asarray(op), jax_cam())
    tp = t_project(torch.as_tensor(m), torch.as_tensor(p["unnorm_rotations"]),
                   torch.as_tensor(sc), torch.as_tensor(op), torch_cam())
    np.testing.assert_array_equal(np_(tp.valid), np.asarray(jp.valid))
    # f32 elementwise math in another order: a few ulps
    for f in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(np_(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(np_(tp.radius), np.asarray(jp.radius))


@pytest.mark.parametrize("aniso", [False, True])
def test_render_slam_gradients_match_jax(aniso):
    """d (sum of a random cotangent times the 6-channel render) with
    respect to the pose and every field: the port's K4 / K5 route with
    autograd through the projection vs jax.grad of the Pallas route."""
    n = 600
    p = _aniso_np(n, 9) if aniso else scene_np(n, 9)
    active = np.ones(n, bool)
    active[-40:] = False
    rng = np.random.default_rng(10)
    from torch_port_util import H, W
    Gs = [rng.standard_normal(s).astype(np.float32)
          for s in ((3, H, W), (1, H, W), (H, W), (1, H, W))]

    def j_loss(params, q, t):
        r = JL.render_slam(params, jnp.asarray(active), q, t, jax_cam(),
                           dict(BK, use_pallas=True))
        return sum(jnp.sum(a * jnp.asarray(b)) for a, b in zip(
            (r.im, r.depth, r.silhouette, r.depth_sq), Gs))

    jg, jq, jt = jax.grad(j_loss, argnums=(0, 1, 2))(
        jax_params(p), jnp.asarray(POSE_Q), jnp.asarray(POSE_T))

    tp = torch_params(p)
    for x in tp.tensors():
        x.requires_grad_(True)
    q = torch.as_tensor(POSE_Q).requires_grad_(True)
    t = torch.as_tensor(POSE_T).requires_grad_(True)
    r = TL.render_slam(tp, torch.as_tensor(active), q, t, torch_cam(), BK)
    loss = sum((a * torch.as_tensor(b)).sum() for a, b in zip(
        (r.im, r.depth, r.silhouette, r.depth_sq), Gs))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss(
        jax_params(p), jnp.asarray(POSE_Q), jnp.asarray(POSE_T))), rtol=1e-5)
    for _, a in TG.PARAM_KEYS:
        x = getattr(tp, a)       # isotropic renders never read the rotations
        g = torch.zeros_like(x) if x.grad is None else x.grad
        assert_close_scaled(g, getattr(jg, a), 1e-4, a)
    assert_close_scaled(q.grad, jq, 1e-4, "d quat")
    assert_close_scaled(t.grad, jt, 1e-4, "d trans")
    assert float(torch.abs(tp.means3d.grad).max()) > 0
    if aniso:
        assert float(torch.abs(tp.unnorm_rotations.grad).max()) > 0


def test_render_slam_without_grad_skips_the_inverse_map(monkeypatch):
    """Densify and eval render under no_grad: K4 only, no K5 residuals."""
    from vtgaussian_slam_tpu_torch.ops.rasterizer import binning as TB
    seen = []
    orig = TB.bin_gaussians

    def spy(*a, **kw):
        seen.append(kw.get("with_inverse", False))
        return orig(*a, **kw)

    from vtgaussian_slam_tpu_torch.ops.rasterizer import tiled
    monkeypatch.setattr(tiled, "bin_gaussians", spy)
    p = scene_np(200, 3)
    tp = torch_params(p)
    q = torch.as_tensor(POSE_Q).requires_grad_(True)
    with torch.no_grad():
        r = TL.render_slam(tp, torch.ones(200, dtype=torch.bool), q,
                           torch.as_tensor(POSE_T), torch_cam(), BK)
    assert not r.im.requires_grad
    TL.render_slam(tp, torch.ones(200, dtype=torch.bool), q,
                   torch.as_tensor(POSE_T), torch_cam(), BK)
    assert seen == [False, True]


def test_section_from_numpy_params_keeps_anisotropic_scales():
    p = _aniso_np(50, 2)
    p["cam_unnorm_rots"] = np.ones((1, 4, 2), np.float32)
    p["cam_trans"] = np.zeros((1, 3, 2), np.float32)
    sec, _ = TG.section_from_numpy_params(p, quantum=64, device="cpu")
    assert sec.params.log_scales.shape == (64, 3)
    assert not sec.params.isotropic
    np.testing.assert_array_equal(np_(sec.params.log_scales[:50]),
                                  p["log_scales"])
