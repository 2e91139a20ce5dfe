"""Two-class binning in the port against the JAX package.

- `bin_two_class`: tables, counts, tile ids, the row merge and the inverse
  map bit for bit in both select modes, the dense set covering every tile
  over the sparse budget or not;
- `splat_pose_2c` / `render_cached_2c` and `splat_binned_2c` /
  `render_binned_2c`: forward within rtol 1e-4 / atol 1e-5 (as
  `tests/test_torch_splat.py` bounds K1: JAX takes the transmittance
  through logs, the port multiplies) and gradients within 1e-3 of the
  largest entry (f32 sums in another order); with the dense set covering every tile over the sparse
  budget, the merged forward equals the single-class render at the dense
  budget bit for bit (binning.py's exactness note);
- `trunc_probe` at k_dense > 0 against JAX's, within one pixel;
- the engine with `tpu.two_class_frac = 0.25`: the same k_dense and sparse
  divisor as the JAX engine (also through the VTGS_TWO_CLASS_* overrides),
  and 3 frames with the JAX engine's mapping draws injected, poses within
  2e-4 as `tests/test_torch_slice.py` bounds them;
- a padded row (count 0, tile 0) under a nonzero cotangent row: the K2 and
  K3 plain versions give exact zeros there.
The JAX side runs its Pallas kernels in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (assert_close_scaled,
                             assert_splat_within_rounding, crowded_scene_np,
                             first_exp_spent,  # noqa: F401
                             jax_params, np_, one_thread, random_tile_slots,
                             torch_params)
from vtgaussian_slam_tpu.core import map_cache as JMC
from vtgaussian_slam_tpu.core import track_cache as JTC
from vtgaussian_slam_tpu.ops.camera import Camera as JCam
from vtgaussian_slam_tpu.ops.rasterizer import binning as JB
from vtgaussian_slam_tpu.ops.rasterizer.projection import \
    project_gaussians as j_project
from vtgaussian_slam_tpu_torch.core import map_cache as TMC
from vtgaussian_slam_tpu_torch.core import track_cache as TTC
from vtgaussian_slam_tpu_torch.ops.camera import Camera as TCam
from vtgaussian_slam_tpu_torch.ops.rasterizer import binning as TB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS
from vtgaussian_slam_tpu_torch.ops.rasterizer.projection import \
    project_gaussians as t_project

# 48 x 64 pixels: 3 x 4 tiles, so a k_dense of 8 leaves a sparse class of 4
H, W = 48, 64
TX, TY = 4, 3
N_TILES = TX * TY
FX = 50.0
CAM_KW = dict(height=H, width=W, fx=FX, fy=FX, cx=W / 2, cy=H / 2)
MPT_D, MPT_S = 256, 128
Q = np.array([0.9998, 0.01, -0.012, 0.008], np.float32)
T = np.array([0.004, -0.003, 0.002], np.float32)


def scene(n=900, seed=7):
    """The crowded scene (heavy-tailed tile counts: a genuine sparse
    class) at this file's camera."""
    return crowded_scene_np(n, seed, H, W, FX)


def _proj(p):
    n = p["means3D"].shape[0]
    jp = j_project(jnp.asarray(p["means3D"]), jnp.asarray(p["unnorm_rotations"]),
                   jnp.exp(jnp.asarray(p["log_scales"])),
                   jax.nn.sigmoid(jnp.asarray(p["logit_opacities"][:, 0])),
                   JCam(**CAM_KW), jnp.ones(n, bool))
    tp = t_project(torch.as_tensor(p["means3D"]),
                   torch.as_tensor(p["unnorm_rotations"]),
                   torch.exp(torch.as_tensor(p["log_scales"])),
                   torch.sigmoid(torch.as_tensor(p["logit_opacities"][:, 0])),
                   TCam(**CAM_KW), torch.ones(n, dtype=torch.bool))
    return jp, tp


def _n_over(tproj) -> int:
    """The tiles with more than MPT_S pairs."""
    full = TB.bin_gaussians(tproj, 16, 2, TX, TY, 4096)
    return int((full.counts > MPT_S).sum())


@pytest.fixture(scope="module")
def case():
    """A scene whose tiles over MPT_S fit in the dense class (k = 8)."""
    p = scene()
    jp, tp = _proj(p)
    assert 0 < _n_over(tp) <= 8
    return p, jp, tp, 8


@pytest.mark.parametrize("select", ["depth", "importance"])
@pytest.mark.parametrize("cover", [True, False])
def test_bin_two_class_bit_exact(case, select, cover):
    p, jp, tp, k = case
    if not cover:       # a denser scene: more tiles over MPT_S than k
        p = scene(n=1200)
        jp, tp = _proj(p)
        assert _n_over(tp) > k
    a = JB.bin_two_class(jp, 16, 2, TX, TY, MPT_D, MPT_S, k, 8,
                         with_inverse=True, select=select)
    b = TB.bin_two_class(tp, 16, 2, TX, TY, MPT_D, MPT_S, k, 8,
                         with_inverse=True, select=select)
    for f in a._fields:
        np.testing.assert_array_equal(np_(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)
    # a dense row is bin_gaussians(MPT_D)'s row of its tile, a sparse one
    # bin_gaussians(MPT_S)'s
    for tab, counts, tids, mpt in ((b.tab_d, b.counts_d, b.tids_d, MPT_D),
                                   (b.tab_s, b.counts_s, b.tids_s, MPT_S)):
        one = TB.bin_gaussians(tp, 16, 2, TX, TY, mpt, select=select)
        real = counts > 0
        ids = tids[real].long()
        np.testing.assert_array_equal(np_(counts[real]), np_(one.counts[ids]))
        for r in torch.nonzero(real)[:, 0].tolist():
            c = int(counts[r])
            np.testing.assert_array_equal(np_(tab[r, :c]),
                                          np_(one.tab[int(tids[r]), :c]))
    assert sorted(np_(b.merge).tolist()) == sorted(
        set(np_(b.merge).tolist())), "merge is injective"
    assert bool((b.counts_s <= MPT_S).all())
    if not cover:
        assert int(b.counts_s.max()) == MPT_S, "the sparse class saturates"


def test_render_cached_2c_matches_jax_and_single_class(case):
    p, _, _, k = case
    n = p["means3D"].shape[0]
    jc = JTC.build_track_cache_2c(
        jax_params(p), jnp.ones(n, bool), jnp.asarray(Q), jnp.asarray(T),
        JCam(**CAM_KW), span_cap=2, max_pairs_per_tile=MPT_D,
        mpt_sparse=MPT_S, k_dense=k, select="importance")
    tc = TTC.build_track_cache_2c(
        torch_params(p), torch.ones(n, dtype=torch.bool), torch.as_tensor(Q),
        torch.as_tensor(T), TCam(**CAM_KW), span_cap=2,
        max_pairs_per_tile=MPT_D, mpt_sparse=MPT_S, k_dense=k,
        select="importance")
    for f in ("counts_d", "tids_d", "counts_s", "tids_s", "merge"):
        np.testing.assert_array_equal(np_(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    w = np.random.default_rng(1).standard_normal((3, H, W)).astype(np.float32)
    # a pose nudged off the binning pose (the tracking regime)
    q1 = Q + np.float32([0.0, 0.002, -0.001, 0.001])
    t1 = T + np.float32([0.003, -0.002, 0.001])

    def jloss(q, t):
        im = JTC.render_cached_2c(jc, q, t, JCam(**CAM_KW)).im
        return jnp.sum(im * w), im

    (_, jim), (jgq, jgt) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(q1), jnp.asarray(t1))
    qv = torch.as_tensor(q1).requires_grad_(True)
    tv = torch.as_tensor(t1).requires_grad_(True)
    r = TTC.render_cached_2c(tc, qv, tv, TCam(**CAM_KW))
    (r.im * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(np_(r.im), np.asarray(jim), rtol=1e-4,
                               atol=1e-5)
    assert_close_scaled(qv.grad, jgq, 1e-3, "d quat")
    assert_close_scaled(tv.grad, jgt, 1e-3, "d trans")
    with torch.no_grad():
        R9 = TTC._pose_R9(torch.as_tensor(q1))
        merged = TTC.splat_pose_2c(R9, torch.as_tensor(t1), tc,
                                   TCam(**CAM_KW), TX)
        single = {}
        for m in (MPT_D, MPT_S):
            one = TTC.build_track_cache(
                torch_params(p), torch.ones(n, dtype=torch.bool),
                torch.as_tensor(Q), torch.as_tensor(T), TCam(**CAM_KW),
                span_cap=2, max_pairs_per_tile=m, select="importance")
            single[m] = CS.splat_forward(one.slots8, R9, torch.as_tensor(t1),
                                         one.counts, TCam(**CAM_KW), TX)
            if m == MPT_D:
                terms = (one.slots8, one.counts, CS.cp_vector(
                    R9, torch.as_tensor(t1), TCam(**CAM_KW)))
    assert_single_class_rows(merged, tc.merge, tc.tids_d.shape[0], single,
                             terms)


def assert_single_class_rows(merged, merge, Kp, single, terms_d):
    """The dense set covers every tile over MPT_S, so each tile's row of
    the merged two-class render equals, bit for bit, the single-class
    render's row at its class's budget. A sparse tile's MPT_D table keeps
    no slot past MPT_S that the walk blends (its weights there are exactly
    0), so its MPT_D and MPT_S renders sum the same terms; on the CPU the
    plain K1 sums them through an einsum whose blocking follows the table
    width and MKL's sgemm kernel, so both, and every row of the merged
    render, are held to the exact value of the MPT_D walk
    (torch_port_util.assert_splat_within_rounding; `terms_d`: the MPT_D
    render's slots, counts and camera vector). They were held to each
    other within 1e-6, which read 0.954 on MKL's default sgemm path of an
    AVX-512 host and 0 under MKL_CBWR=COMPATIBLE or AVX2; the kernel walks
    only the count and matches both (the card test and chip_smoke check
    that)."""
    dense = merge < Kp
    assert bool(dense.any()) and bool((~dense).any())
    np.testing.assert_array_equal(np_(merged[dense]), np_(single[MPT_D][dense]))
    np.testing.assert_array_equal(np_(merged[~dense]),
                                  np_(single[MPT_S][~dense]))
    slots_d, counts_d, cp = terms_d
    w = CS._walk(slots_d, counts_d, cp, TX, None)
    np.testing.assert_array_equal(np_(w["weight"][~dense][..., MPT_S:]), 0.0)
    for what, out in (("merged", merged), ("single-class", single[MPT_D])):
        print(what, assert_splat_within_rounding(out, slots_d, counts_d, cp,
                                                 TX, None, what))


def test_render_binned_2c_matches_jax_and_single_class(case):
    p, _, _, k = case
    n = p["means3D"].shape[0]
    jk = JMC.build_kf_cache_2c(
        jax_params(p), jnp.ones(n, bool), jnp.asarray(Q), jnp.asarray(T),
        JCam(**CAM_KW), span_cap=2, max_pairs_per_tile=MPT_D,
        mpt_sparse=MPT_S, k_dense=k, select="importance")
    tk = kf_cache_2c(p, k)
    np.testing.assert_array_equal(np_(tk.inv.pos), np.asarray(jk.inv.pos))
    np.testing.assert_array_equal(np_(tk.inv.w), np.asarray(jk.inv.w))
    w = np.random.default_rng(2).standard_normal((3, H, W)).astype(np.float32)
    jf8 = JMC.pack_fields8(jax_params(p))

    def jloss(v):
        im = JMC.render_binned_2c(v, jk, JCam(**CAM_KW)).im
        return jnp.sum(im * w), im

    jg, jim = jax.grad(jloss, has_aux=True)(jf8)
    v8 = TMC.pack_fields8(torch_params(p)).requires_grad_(True)
    r = TMC.render_binned_2c(v8, tk, TCam(**CAM_KW))
    (r.im * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(np_(r.im), np.asarray(jim), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(np_(v8.grad)[:, :3], 0.0)
    for col in range(3, 8):
        assert_close_scaled(v8.grad[:, col], np.asarray(jg)[:, col], 1e-3,
                            f"d fields8 column {col}")
    assert_single_class_rows(*binned_rows(p, tk))


@torch.no_grad()
def binned_rows(p, tk):
    """(merged render, merge, Kp, single-class renders, MPT_D terms) of the
    kf cache `tk` of scene `p`, for assert_single_class_rows."""
    n = p["means3D"].shape[0]
    f8 = TMC.pack_fields8(torch_params(p))
    R9 = TTC._pose_R9(torch.as_tensor(Q))
    merged = TMC.splat_forward_2c(f8, tk, R9, TCam(**CAM_KW))[2]
    single = {}
    for m in (MPT_D, MPT_S):
        one = TMC.build_kf_cache(
            torch_params(p), torch.ones(n, dtype=torch.bool),
            torch.as_tensor(Q), torch.as_tensor(T), TCam(**CAM_KW),
            span_cap=2, max_pairs_per_tile=m, select="importance")
        slots = TB.gather_channels(f8, one.tab)
        single[m] = CS.splat_forward(slots, R9, torch.as_tensor(T),
                                     one.counts, TCam(**CAM_KW), TX)
        if m == MPT_D:
            terms = (slots, one.counts, CS.cp_vector(
                R9, torch.as_tensor(T), TCam(**CAM_KW)))
    return merged, tk.merge, tk.tids_d.shape[0], single, terms


def kf_cache_2c(p, k):
    """The port's two-class kf cache of scene `p` at the file's pose."""
    n = p["means3D"].shape[0]
    return TMC.build_kf_cache_2c(
        torch_params(p), torch.ones(n, dtype=torch.bool), torch.as_tensor(Q),
        torch.as_tensor(T), TCam(**CAM_KW), span_cap=2,
        max_pairs_per_tile=MPT_D, mpt_sparse=MPT_S, k_dense=k,
        select="importance")


def test_trunc_probe_two_class_matches_jax():
    # a dense scene whose translucent layers a starved budget cannot cover
    p = scene(n=3000, seed=5)
    p["logit_opacities"] = np.full_like(p["logit_opacities"], -1.5)
    n = p["means3D"].shape[0]
    kw = dict(span_cap=2, mpt=128, select="importance", k_dense=8,
              sparse_div=4)
    jh = float(JMC.trunc_probe(jax_params(p), jnp.ones(n, bool),
                               jnp.asarray(Q), jnp.asarray(T), JCam(**CAM_KW),
                               **kw))
    th = float(TMC.trunc_probe(torch_params(p), torch.ones(n, dtype=torch.bool),
                               torch.as_tensor(Q), torch.as_tensor(T),
                               TCam(**CAM_KW), **kw))
    one = float(TMC.trunc_probe(torch_params(p),
                                torch.ones(n, dtype=torch.bool),
                                torch.as_tensor(Q), torch.as_tensor(T),
                                TCam(**CAM_KW), span_cap=2, mpt=128,
                                select="importance"))
    assert jh > 0.01, "the starved two-class point truncates"
    assert abs(th - jh) <= 1.0 / (H * W) + 1e-7, (th, jh)
    assert th >= one - 1e-7, "two classes can only truncate more"


def test_padded_rows_backward_is_zero():
    """A padded row (count 0, tile 0) gets the cotangent of a real tile's
    row (g[tids]); K2 and K3 must give it exact zeros."""
    rng = np.random.default_rng(4)
    slots = torch.as_tensor(random_tile_slots([0, 3, 0, 0], TX, 128, seed=9,
                                              fx=FX, fy=FX, cx=W / 2,
                                              cy=H / 2))
    counts = torch.tensor([128, 100, 0, 0], dtype=torch.int32)
    tids = torch.tensor([0, 3, 0, 0], dtype=torch.int32)
    R9, t = torch.eye(3).reshape(9), torch.zeros(3)
    cam = TCam(**CAM_KW)
    out = CS.splat_forward(slots, R9, t, counts, cam, TX, tids)
    np.testing.assert_array_equal(np_(out[2:, :6]), 0.0)
    g = torch.as_tensor(rng.standard_normal((4, 8, 256)).astype(np.float32))
    g[2:] = g[0]
    pose = CS.splat_backward_pose(slots, R9, t, counts, out, g, cam, TX, tids)
    rows = CS.splat_backward_vals_rows(slots, R9, t, counts, out, g, cam, TX,
                                       tids)
    assert bool(pose[0].abs().sum() > 0) and bool(rows[0].abs().sum() > 0)
    np.testing.assert_array_equal(np_(pose[2:]), 0.0)
    np.testing.assert_array_equal(np_(rows[2:]), 0.0)


def _engine_config(workdir):
    from test_torch_slice import _config
    cfg = _config(workdir)
    cfg["data"]["synthetic"].update(height=H, width=W)
    cfg["data"].update(desired_image_height=H, desired_image_width=W,
                       densification_image_height=2 * H,
                       densification_image_width=2 * W)
    cfg["tpu"]["two_class_frac"] = 0.25
    return cfg


def test_engine_operating_point_matches_jax(tmp_path, monkeypatch):
    """k_dense and the sparse divisor as the JAX engine sets them (0.25 or
    0.5 x 12 tiles, rounded up to 8 and below the tile count), from the
    config and from the overrides."""
    from vtgaussian_slam_tpu.core import pipeline as JP
    from vtgaussian_slam_tpu_torch.core import pipeline as TP
    cfg = _engine_config(tmp_path)
    for env in ({}, {"VTGS_TWO_CLASS_FRAC": "0.5", "VTGS_TWO_CLASS_DIV": "2"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        j = JP.VTGaussianSLAM(cfg)
        t = TP.VTGaussianSLAM(cfg, device="cpu")
        t.close()
        assert (t._k_dense, t._two_class_div) == (j._k_dense,
                                                  j._two_class_div), env
        assert t.map_store.k_dense == t._k_dense > 0
    assert (t._k_dense, t._two_class_div) == (8, 2)


def test_three_frames_two_class_match_jax_engine(tmp_path, monkeypatch):
    from test_torch_slice import FRAMES, slice_draws
    from vtgaussian_slam_tpu.core import pipeline as JP
    from vtgaussian_slam_tpu.ops import image as JI
    from vtgaussian_slam_tpu_torch.core import pipeline as TP
    monkeypatch.setattr(JI, "cv2", None)        # the numpy Canny on both
    cfg = _engine_config(tmp_path)
    jeng = JP.VTGaussianSLAM(cfg)
    draws = slice_draws(cfg)
    for t in range(FRAMES):
        jeng.process_frame(t)
    teng = TP.VTGaussianSLAM(cfg, device="cpu",
                             map_draws=lambda t, n, count: draws[t][:n])
    try:
        for t in range(FRAMES):
            teng.process_frame(t)
    finally:
        teng.close()
    assert teng._k_dense == jeng._k_dense == 8
    assert isinstance(teng.map_store.slots[0], TMC.KFBinCache2C)
    assert teng.sections[0].n_active == int(jeng.sections[0].n_active)
    np.testing.assert_allclose(np_(teng.traj.quats[:FRAMES]),
                               np.asarray(jeng.traj.quats[:FRAMES]), atol=2e-4)
    np.testing.assert_allclose(np_(teng.traj.trans[:FRAMES]),
                               np.asarray(jeng.traj.trans[:FRAMES]), atol=2e-4)
    assert teng.stats["tile_truncation_frac_max"] == pytest.approx(
        jeng.stats["tile_truncation_frac_max"])
