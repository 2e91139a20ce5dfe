"""The global-consistency term and the closed-loop pair budget against the
JAX package.

- `build_global_cache`: [frozen prefix; trainable section] binned at one
  pose; tables, counts and the trainable rows' inverse map bit for bit;
- `render_binned_global`: forward within 2e-5 and the field-table gradient
  (only the trainable rows, the frozen prefix takes none) within 2e-3 of
  the largest entry, as the kernel tests bound K1 / K3;
- `map_frame_binned` and `map_frame` with `use_global` and the JAX draws
  injected: the loss history within rtol 1e-3 and the fields as the mapping
  test bounds them (Adam turns the kernels' ~1e-4 into ~lr x 1e-3); the
  term carries gradient on the first iteration only, and skipping its
  value-only renders leaves the parameters bit-identical;
- `trunc_probe`: the same share of differing pixels within one pixel, on a
  scene whose translucent layers a starved budget cannot cover;
- the boost hysteresis driven through the port's `_update_pair_budget` on
  a stub engine, beside the JAX engine's on the same readings."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_track_map import BK, JBK, _lcfg, _target_frames
from torch_port_util import (H, N_TILES, W, first_exp_spent,  # noqa: F401
                             jax_cam, jax_params, np_, scene_np, torch_cam,
                             torch_params)
from vtgaussian_slam_tpu.core import losses as JL
from vtgaussian_slam_tpu.core import map_cache as JMC
from vtgaussian_slam_tpu.core import mapping as JMP
from vtgaussian_slam_tpu.core.pipeline import VTGaussianSLAM as JEngine
from vtgaussian_slam_tpu_torch.core import losses as TL
from vtgaussian_slam_tpu_torch.core import map_cache as TMC
from vtgaussian_slam_tpu_torch.core import mapping as TMP
from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM as TEngine

MPT = 256
LRS = (("log_scales", 0.005), ("logit_opacities", 0.05), ("means3D", 0.0),
       ("rgb_colors", 0.0025), ("unnorm_rotations", 0.0))
Q0 = np.array([1.0, 0, 0, 0], np.float32)
T0 = np.zeros(3, np.float32)


def _pair(n_fixed=300, n=400, seed=30):
    """(fixed, trainable) reference-format scenes; the fixed one padded by
    zero rows past its 300 active ones, as the engine's concat is."""
    fixed = scene_np(n_fixed, seed)
    cap = n_fixed + 84
    fixed = {k: (np.concatenate([v, np.zeros((cap - n_fixed,) + v.shape[1:],
                                             v.dtype)])
                 if v.shape[0] == n_fixed else v) for k, v in fixed.items()}
    f_act = np.arange(cap) < n_fixed
    return fixed, f_act, scene_np(n, seed + 1)


def _caches(fixed, f_act, p, q=Q0, t=T0):
    n = p["means3D"].shape[0]
    jgc = JMC.build_global_cache(
        jax_params(fixed), jnp.asarray(f_act), jax_params(p),
        jnp.ones(n, bool), jnp.asarray(q), jnp.asarray(t), jax_cam(),
        span_cap=2, max_pairs_per_tile=MPT, select="importance")
    tgc = TMC.build_global_cache(
        torch_params(fixed), torch.as_tensor(f_act), torch_params(p),
        torch.ones(n, dtype=torch.bool), torch.as_tensor(q),
        torch.as_tensor(t), torch_cam(), span_cap=2, max_pairs_per_tile=MPT,
        select="importance")
    return jgc, tgc


def test_build_global_cache_bit_exact():
    fixed, f_act, p = _pair()
    jgc, tgc = _caches(fixed, f_act, p)
    np.testing.assert_array_equal(np_(tgc.counts),
                                  np.asarray(jgc.counts)[:N_TILES])
    np.testing.assert_array_equal(np_(tgc.tab),
                                  np.asarray(jgc.tab)[:N_TILES])
    np.testing.assert_array_equal(np_(tgc.inv.pos), np.asarray(jgc.inv.pos))
    np.testing.assert_array_equal(np_(tgc.inv.w), np.asarray(jgc.inv.w))
    np.testing.assert_array_equal(np_(tgc.fixed_fields8),
                                  np.asarray(jgc.fixed_fields8))
    # the inverse covers the trainable rows only, and the table holds both
    assert tgc.inv.pos.shape[0] == p["means3D"].shape[0]
    tab = np_(tgc.tab)[np.arange(MPT)[None] < np_(tgc.counts)[:, None]]
    assert (tab < len(f_act)).any() and (tab >= len(f_act)).any()


def test_render_binned_global_forward_and_gradient():
    fixed, f_act, p = _pair(seed=32)
    jgc, tgc = _caches(fixed, f_act, p)
    jf8 = JMC.pack_fields8(jax_params(p))

    def jloss(v8):
        return jnp.sum(JMC.render_binned_global(v8, jgc, jax_cam()).im ** 2)

    jr = JMC.render_binned_global(jf8, jgc, jax_cam())
    jg = jax.grad(jloss)(jf8)
    tf8 = TMC.pack_fields8(torch_params(p)).requires_grad_(True)
    tr = TMC.render_binned_global(tf8, tgc, torch_cam())
    (tg,) = torch.autograd.grad((tr.im ** 2).sum(), (tf8,))
    np.testing.assert_allclose(np_(tr.im), np.asarray(jr.im), atol=2e-5)
    np.testing.assert_allclose(np_(tr.depth), np.asarray(jr.depth),
                               rtol=2e-5, atol=2e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(np_(tg), np.asarray(jg), rtol=0,
                               atol=2e-3 * scale)
    assert np.abs(np_(tg)[:, 3:]).max() > 0
    np.testing.assert_array_equal(np_(tg)[:, :3], 0.0)
    assert tgc.fixed_fields8.grad is None


def _mapping_inputs(frame_ids):
    poses = [(Q0, T0), (np.array([0.999, 0.01, -0.02, 0.005], np.float32),
                        np.array([0.02, -0.01, 0.03], np.float32))]
    frames = _target_frames(poses, seed=33)
    colors = np.stack([c for c, _ in frames]).astype(np.float32)
    depths = np.stack([d for _, d in frames]).astype(np.float32)
    quats = np.stack([q for q, _ in poses])
    trans = np.stack([t for _, t in poses])
    jkf = JMP.KeyframeBuffer(
        colors=jnp.asarray(colors), depths=jnp.asarray(depths),
        quats=jnp.asarray(quats), trans=jnp.asarray(trans),
        frame_ids=jnp.asarray(frame_ids, jnp.int32),
        count=jnp.asarray(2, jnp.int32))
    tkf = TMP.KeyframeBuffer(
        colors=torch.as_tensor(colors), depths=torch.as_tensor(depths),
        count=2, quats=torch.as_tensor(quats), trans=torch.as_tensor(trans),
        frame_ids=list(frame_ids))
    return poses, jkf, tkf


def _draws(rng, iters, count=2):
    return [int(jax.random.randint(jax.random.fold_in(rng, i), (), 0,
                                   jnp.asarray(count, jnp.int32)))
            for i in range(iters)]


def _rng_with_first_draw(first, iters):
    """A key whose loop draws start with keyframe `first` and visit both."""
    for s in range(100):
        d = _draws(jax.random.PRNGKey(s), iters)
        if d[0] == first and len(set(d)) == 2:
            return jax.random.PRNGKey(s), d
    raise AssertionError("no such key")


def _assert_fields(tparams, jparams, iters):
    f_t = np_(TMC.pack_fields8(tparams))[:, 3:]
    f_j = np.asarray(JMC.pack_fields8(jparams))[:, 3:]
    diff = np.abs(f_t - f_j)
    assert (diff <= 5e-4 + 1e-3 * np.abs(f_j)).mean() > 0.99
    lr = dict(LRS)
    reach = iters * np.array([lr["logit_opacities"], lr["log_scales"]]
                             + [lr["rgb_colors"]] * 3)
    assert (diff <= reach).all(), (diff / reach).max(0)


@pytest.mark.parametrize("route", ["binned", "generic"])
def test_mapping_with_global_term_matches(route):
    """Frame ids (40, 41) with baseframe_every 40: keyframe 0 is a base
    frame, so the global term enters whenever it is drawn; iteration 0
    draws it, so the term's gradient enters once."""
    iters = 6
    fixed, f_act, p = _pair(seed=34)
    poses, jkf, tkf = _mapping_inputs([40, 41])
    rng, draws = _rng_with_first_draw(0, iters)
    jcfg = JMP.MappingConfig(num_iters=iters, lrs=LRS,
                             loss_cfg=_lcfg(JL, False)._replace(
                                 backend_kwargs=tuple(sorted(JBK.items()))),
                             use_global=True, baseframe_every=40)
    tcfg = TMP.MappingConfig(num_iters=iters, lrs=LRS,
                             loss_cfg=_lcfg(TL, False)._replace(
                                 backend_kwargs=tuple(sorted(BK.items()))),
                             use_global=True, baseframe_every=40)
    n = p["means3D"].shape[0]
    if route == "binned":
        jstore = JMC.MapCacheStore(select="importance")
        tstore = TMC.MapCacheStore(select="importance")
        for ring, (q, t) in enumerate(poses):
            jstack, jslot_ids, _ = jstore.update(
                jax_params(p), jnp.ones(n, bool), n, ring, jnp.asarray(q),
                jnp.asarray(t), jax_cam(), 2, MPT, 2)
            tslots, tslot_ids, _ = tstore.update(
                torch_params(p), torch.ones(n, dtype=torch.bool), n, ring,
                torch.as_tensor(q), torch.as_tensor(t), torch_cam(), 2, MPT,
                2)
        jgc, tgc = _caches(fixed, f_act, p)
        jparams, jhist = JMP.map_frame_binned(jax_params(p), jkf, jstack,
                                              jslot_ids, jgc, rng, jax_cam(),
                                              jcfg)
        tparams, thist = TMP.map_frame_binned(torch_params(p), tkf, tslots,
                                              tslot_ids, torch_cam(), tcfg,
                                              draws=draws, gc=tgc)
    else:
        jparams, jhist = JMP.map_frame(
            jax_params(p), jnp.ones(n, bool), jax_params(fixed),
            jnp.asarray(f_act), jkf, rng, jax_cam(), jcfg)
        tparams, thist = TMP.map_frame(
            torch_params(p), torch.ones(n, dtype=torch.bool), tkf,
            torch_cam(), tcfg, draws=draws, fixed_params=torch_params(fixed),
            fixed_active=torch.as_tensor(f_act))
    np.testing.assert_allclose(np_(thist), np.asarray(jhist), rtol=1e-3)
    _assert_fields(tparams, jparams, iters)


def _binned_setup(seed=35):
    fixed, f_act, p = _pair(seed=seed)
    poses, _, tkf = _mapping_inputs([40, 41])
    n = p["means3D"].shape[0]
    store = TMC.MapCacheStore(select="importance")
    for ring, (q, t) in enumerate(poses):
        slots, slot_ids, _ = store.update(
            torch_params(p), torch.ones(n, dtype=torch.bool), n, ring,
            torch.as_tensor(q), torch.as_tensor(t), torch_cam(), 2, MPT, 2)
    _, tgc = _caches(fixed, f_act, p)

    def run(draws, use_global, log):
        cfg = TMP.MappingConfig(num_iters=len(draws), lrs=LRS,
                                loss_cfg=_lcfg(TL, False), use_global=use_global,
                                baseframe_every=40, log_global_loss=log)
        params, hist = TMP.map_frame_binned(torch_params(p), tkf, slots,
                                            slot_ids, torch_cam(), cfg,
                                            draws=draws, gc=tgc)
        return np_(TMC.pack_fields8(params)), np_(hist)
    return run


def test_global_term_gradient_on_first_iteration_only():
    run = _binned_setup()
    base_first = [0, 1, 0, 0]       # keyframe 0 (frame 40) is the base frame
    base_later = [1, 0, 0, 1]
    f_off, h_off = run(base_first, False, True)
    f_on, h_on = run(base_first, True, True)
    assert not np.array_equal(f_on, f_off)      # iteration 0's gradient
    assert h_on[0, 0] > h_off[0, 0]
    f_later, h_later = run(base_later, True, True)
    f_plain, h_plain = run(base_later, False, True)
    # base frames drawn after iteration 0 add value, never gradient
    np.testing.assert_array_equal(f_later, f_plain)
    assert (h_later[1:3, 0] > h_plain[1:3, 0]).all()
    np.testing.assert_array_equal(h_later[:, 1:], h_plain[:, 1:])


def test_skipping_value_only_global_keeps_params_identical():
    run = _binned_setup(seed=36)
    draws = [0, 0, 1, 0, 1]
    f_log, h_log = run(draws, True, True)
    f_skip, h_skip = run(draws, True, False)
    np.testing.assert_array_equal(f_skip, f_log)
    np.testing.assert_array_equal(h_skip[0], h_log[0])
    assert h_skip[1, 0] < h_log[1, 0] and h_skip[3, 0] < h_log[3, 0]


def _hostile():
    """20 translucent planes of 12 x 12 Gaussians: ~2900 pairs over 9 tiles
    of near-equal alpha, so a starved budget drops blend weight."""
    rng = np.random.default_rng(0)
    layers = []
    for li in range(20):
        z = 2.0 + 0.1 * li
        gx, gy = np.meshgrid(np.linspace(-0.45, 0.45, 12) * z,
                             np.linspace(-0.4, 0.4, 12) * z)
        layers.append(np.stack([gx.ravel(), gy.ravel(),
                                np.full(gx.size, z)], 1))
    pts = np.concatenate(layers).astype(np.float32)
    n = len(pts)
    return {"means3D": pts,
            "rgb_colors": rng.random((n, 3)).astype(np.float32),
            "unnorm_rotations": np.tile(np.array([[1.0, 0, 0, 0]],
                                                 np.float32), (n, 1)),
            "logit_opacities": np.full((n, 1), -1.0, np.float32),
            "log_scales": np.full((n, 1), np.log(0.07), np.float32)}


@pytest.mark.parametrize("mpt", [128, 512])
def test_trunc_probe_matches(mpt):
    p = _hostile()
    n = p["means3D"].shape[0]
    j = float(JMC.trunc_probe(jax_params(p), jnp.ones(n, bool),
                              jnp.asarray(Q0), jnp.asarray(T0), jax_cam(),
                              span_cap=2, mpt=mpt, select="importance"))
    t = float(TMC.trunc_probe(torch_params(p), torch.ones(n, dtype=torch.bool),
                              torch.as_tensor(Q0), torch.as_tensor(T0),
                              torch_cam(), span_cap=2, mpt=mpt,
                              select="importance"))
    assert abs(t - j) <= 1.0 / (H * W) + 1e-7, (t, j)
    if mpt == 128:
        assert t > 0.01, t      # starved: above the boost threshold


def _stub(port: bool, boost=1):
    s = types.SimpleNamespace()
    s.config = {"tpu": {"span_cap": 2, "max_pairs_per_tile": 256}}
    s.cam = torch_cam() if port else jax_cam()
    s._harm_hist, s._mpt_boost = [], boost
    s._pending_harm, s._pending_harm_mpt = None, 256
    s.stats = {"trunc_probe_diff_max": 0.0}
    s.probe_log = []
    s.sections = [types.SimpleNamespace(n_active=3000)]   # mpt 512 x boost
    kw = dict(span_cap=2, max_pairs_per_tile=256, chunk=128)
    if port:
        s.backend_kwargs = dict(kw)
    else:   # the JAX engine keeps a second budget for mapping
        s.backend_kwargs = s.map_backend_kwargs = tuple(sorted(kw.items()))
    return s


@pytest.mark.parametrize("boost, readings, final", [
    (1, [None, 0.5, 0.3], 2),                    # x2 after two harmful
    (4, [0.0001] * 4, 2),                        # /2 after four clean
    (1, [0.05, 0.0001, 0.05, 0.0001, 0.05], 1),  # mixed: holds
    (2, [0.5, 0.3] + [0.0001] * 4, 2)])          # up, then back down
def test_boost_hysteresis_matches(boost, readings, final):
    port, ref = _stub(True, boost), _stub(False, boost)
    for h in readings:
        port._pending_harm = None if h is None else torch.tensor(h)
        ref._pending_harm = None if h is None else jnp.asarray(h)
        TEngine._update_pair_budget(port)
        JEngine._update_pair_budget(ref)
        assert port._mpt_boost == ref._mpt_boost
        assert port._harm_hist == pytest.approx(ref._harm_hist)
        assert (port.backend_kwargs["max_pairs_per_tile"]
                == dict(ref.backend_kwargs)["max_pairs_per_tile"])
    assert port._mpt_boost == final
