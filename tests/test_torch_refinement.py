"""The port's refinement (prune, opacity reset, clone / split densify, the
screen-gradient statistics) against the JAX package's, on the cases of
tests/test_refinement.py with every row made distinct (random fields and
Adam moments from a numpy seed), so that the compaction's permutation
shows.

Tolerances: n_active, the compaction order and the zeroed tail exact;
values within 1e-6 (the split's jitter is JAX's normal draws handed to the
port; the opacity reset's constant is log(0.01 / 0.99) in each package's
rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import np_
from vtgaussian_slam_tpu.models import gaussians as JG
from vtgaussian_slam_tpu.models import refinement as JR
from vtgaussian_slam_tpu.models.optimizer import AdamState as JAdam
from vtgaussian_slam_tpu_torch.models import gaussians as TG
from vtgaussian_slam_tpu_torch.models import refinement as TR
from vtgaussian_slam_tpu_torch.models.optimizer import AdamState as TAdam

N, CAP = 10, 64
FIELDS = ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities",
          "log_scales")

PRUNE = dict(start_after=0, remove_big_after=0, stop_after=20, prune_every=20,
             removal_opacity_threshold=0.005,
             final_removal_opacity_threshold=0.005,
             reset_opacities=False, reset_opacities_every=500)
DENSIFY = dict(start_after=0, remove_big_after=10000, stop_after=5000,
               densify_every=1, grad_thresh=0.1, num_to_split_into=2,
               removal_opacity_threshold=0.005,
               final_removal_opacity_threshold=0.005,
               reset_opacities_every=3000)


def _sections(opac_logits=None, scales=None, grad_rows=(), seed=0):
    """The same section in both packages: distinct means / colours /
    rotations per row, the given opacities and scales, gradient statistics
    of 1.0 on `grad_rows`."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    msq = np.full((N,), 0.01, np.float32)
    j = JG.init_section(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(msq),
                        N, CAP, 0.0, scene_radius=1.0)
    t = TG.init_section(torch.as_tensor(pts), torch.as_tensor(cols),
                        torch.as_tensor(msq), N, CAP, 0.0, scene_radius=1.0)
    rots = np.zeros((CAP, 4), np.float32)
    rots[:N] = rng.normal(size=(N, 4))
    lo = np.asarray(j.params.logit_opacities).copy()
    ls = np.asarray(j.params.log_scales).copy()
    if opac_logits is not None:
        lo[:N, 0] = opac_logits
    if scales is not None:
        ls[:N, 0] = np.log(scales)
    accum = np.zeros((CAP,), np.float32)
    accum[list(grad_rows)] = 1.0
    denom = np.zeros((CAP,), np.float32)
    denom[:N] = 1.0
    ts = np.zeros((CAP,), np.float32)
    ts[:N] = np.arange(N)
    j = j.replace(params=j.params.replace(
        unnorm_rotations=jnp.asarray(rots), logit_opacities=jnp.asarray(lo),
        log_scales=jnp.asarray(ls)),
        vars=j.vars.replace(means2d_grad_accum=jnp.asarray(accum),
                            denom=jnp.asarray(denom), timestep=jnp.asarray(ts)))
    p = t.params
    t = t.replace(params=p.replace(
        unnorm_rotations=torch.as_tensor(rots), logit_opacities=torch.as_tensor(lo),
        log_scales=torch.as_tensor(ls)),
        vars=TG.GaussianVars(t.vars.max_2d_radius, torch.as_tensor(accum),
                             torch.as_tensor(denom), torch.as_tensor(ts),
                             t.vars.scene_radius))
    return j, t


def _adams(seed=1):
    """Random Adam moments with a live head and a zero tail, both sides."""
    rng = np.random.default_rng(seed)
    shapes = [(CAP, 3), (CAP, 3), (CAP, 4), (CAP, 1), (CAP, 1)]
    mu, nu = [], []
    for s in shapes:
        for lst in (mu, nu):
            a = np.zeros(s, np.float32)
            a[:N] = rng.normal(size=(N,) + s[1:])
            lst.append(a)
    jmu = JG.GaussianParams(*[jnp.asarray(a) for a in mu])
    jnu = JG.GaussianParams(*[jnp.asarray(a) for a in nu])
    return (JAdam(mu=jmu, nu=jnu, count=jnp.asarray(3)),
            TAdam(mu=[torch.as_tensor(a) for a in mu],
                  nu=[torch.as_tensor(a) for a in nu], count=3))


def _assert_same(jsec, tsec, jopt=None, topt=None, atol=1e-6):
    assert int(jsec.n_active) == tsec.n_active
    for f in FIELDS:
        np.testing.assert_allclose(np_(getattr(tsec.params, f)),
                                   np.asarray(getattr(jsec.params, f)),
                                   atol=atol, rtol=0, err_msg=f)
    for f in ("max_2d_radius", "means2d_grad_accum", "denom", "timestep"):
        np.testing.assert_allclose(np_(getattr(tsec.vars, f)),
                                   np.asarray(getattr(jsec.vars, f)),
                                   atol=atol, rtol=0, err_msg=f)
    if jopt is not None:
        for i, f in enumerate(FIELDS):
            for jm, tm in ((jopt.mu, topt.mu), (jopt.nu, topt.nu)):
                np.testing.assert_allclose(np_(tm[i]),
                                           np.asarray(getattr(jm, f)),
                                           atol=atol, rtol=0, err_msg=f)


@pytest.mark.parametrize("case", ["low_opacity", "big", "outside_schedule",
                                  "opacity_reset"])
def test_prune_matches(case):
    if case == "low_opacity":
        j, t = _sections(opac_logits=[-10.0, 2.0, -10.0, 2.0, 2.0, -10.0, 2.0,
                                      2.0, 2.0, 2.0])
        it, pd = 20, PRUNE
    elif case == "big":
        j, t = _sections(scales=[0.01, 0.5, 0.01, 0.01, 0.9, 0.01, 0.01,
                                 0.01, 0.01, 0.01])
        it, pd = 20, PRUNE
    elif case == "outside_schedule":
        j, t = _sections(opac_logits=np.full(N, -10.0))
        it, pd = 7, PRUNE
    else:
        j, t = _sections(opac_logits=np.full(N, 3.0))
        it, pd = 5, dict(PRUNE, reset_opacities=True, reset_opacities_every=5,
                         prune_every=100)
    jopt, topt = _adams()
    jo, jopt2 = JR.prune_gaussians(j, jopt, it=it, prune_dict=pd)
    to, topt2 = TR.prune_gaussians(t, topt, it=it, prune_dict=pd)
    _assert_same(jo, to, jopt2, topt2)
    want = {"low_opacity": 7, "big": 8, "outside_schedule": 10,
            "opacity_reset": 10}[case]
    assert to.n_active == want


@pytest.mark.parametrize("case", ["clone", "split"])
def test_densify_matches(case):
    if case == "clone":
        j, t = _sections(scales=np.full(N, 0.005), grad_rows=(1, 4, 7))
    else:
        j, t = _sections(scales=[0.001, 0.05, 0.001, 0.001, 0.05, 0.001,
                                 0.001, 0.001, 0.001, 0.001],
                         grad_rows=(1, 4))
    jopt, topt = _adams()
    key = jax.random.PRNGKey(0)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, k),
                                                   (CAP, 3)))
                      for k in range(DENSIFY["num_to_split_into"])])
    jo, jopt2 = JR.densify_split_clone(j, jopt, it=1, densify_dict=DENSIFY,
                                       rng=key)
    to, topt2 = TR.densify_split_clone(t, topt, it=1, densify_dict=DENSIFY,
                                       noise=torch.as_tensor(noise))
    _assert_same(jo, to, jopt2, topt2)
    assert to.n_active == (13 if case == "clone" else 12)


def test_grad_stats_accumulate_matches():
    j, t = _sections()
    rng = np.random.default_rng(4)
    g = rng.normal(size=(CAP, 3)).astype(np.float32)
    seen = rng.uniform(size=CAP) < 0.5
    jv = JR.accumulate_mean2d_gradient(j.vars, jnp.asarray(g),
                                       jnp.asarray(seen))
    tv = TR.accumulate_mean2d_gradient(t.vars, torch.as_tensor(g),
                                       torch.as_tensor(seen))
    for f in ("means2d_grad_accum", "denom"):
        np.testing.assert_allclose(np_(getattr(tv, f)),
                                   np.asarray(getattr(jv, f)), atol=1e-6,
                                   rtol=0)
