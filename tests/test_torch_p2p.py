"""The point-to-plane candidate metric (core/p2p.py) against the JAX package.

Inputs: two frames of the synthetic room (64 x 96, the JAX test_p2p.py
scene) and their ground-truth poses, with the source pose moved off by a
few seeded offsets. Checks:
  - the target's packed (H*W, 8) rows [point, normal, valid, 0]: points and
    valid flags within 1e-6 (f32 back-projection and one rigid transform),
    normals within 1e-5 (a cross product of central differences,
    normalized);
  - the metric for "sum", "max" and "max100" against an exact yardstick:
    the port's own function on f64 copies of the same inputs. Both sides
    keep the same pairs as it, exactly. Each side's f32 residuals, pair by
    pair, are within the f32 rounding bound of the f64 ones that their
    points' magnitudes set (`_residual_bound`: the tight check), and each
    side's metric within what its own residuals' gaps to f64 allow
    (`_metric_bound`);
  - no surviving pair (the source camera turned away, or a NaN pose):
    +inf on both sides, for every method.

Why each side's metric is held to its own residuals' gaps, and not to a
fixed relative tolerance: the port's f32 rounding follows the sgemm kernel
that MKL dispatches for the 3x3 / 4x4 products of `invert_se3`,
`transform_points`, `backproject` and the normals' rotation. At seed 0 the
port's "sum" sits 1.57e-4 (relative) off its f64 value on MKL's default
path of an AVX-512 host and on `MKL_ENABLE_INSTRUCTIONS=AVX2`, with the
same bits as the JAX package's (XLA contracts the same products into
FMAs), and 2.69e-6 off under `MKL_CBWR=COMPATIBLE`: 58x apart; "max100"
1.80e-5 / 6.15e-6. A fixed 1e-5, set on a host whose MKL ran the second
path, failed on the first. Measured gap over `_metric_bound` at seed 0
(sum / max / max100; torch 2.13 CPU, numpy 2.0, AVX-512 host): default
and AVX2 paths 0.34 / 0.43 / 0.22, COMPATIBLE 0.006 / 0.31 / 0.055; the
residual check 0.043 and 0.060 of `_residual_bound`. JAX's metric reads
0.34 / 0.43 / 0.22 on every path. `test_metric_on_mkl_path` runs the
check in a child process on each path, so that no host passes a check
another host fails.

`_metric_bound` follows a side's residuals wherever they go, so it holds
the metric's reduction (the sum, max and top-100 mean and their f32
accumulation), not the residuals: those are held by the pair masks and
`_residual_bound`, and a fault at every precision by the JAX side's
checks around the port's f64 value. tests/test_torch_parity_controls.py
seeds a fault into each layer."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import first_exp_spent, np_, on_mkl_path  # noqa: F401
from vtgaussian_slam_tpu.core import p2p as JP2P
from vtgaussian_slam_tpu.datasets.synthetic import SyntheticRoomDataset
from vtgaussian_slam_tpu.ops import geometry as JG
from vtgaussian_slam_tpu_torch.core import p2p as TP2P
from vtgaussian_slam_tpu_torch.ops import geometry as TG

METHODS = ("sum", "max", "max100")


@pytest.fixture(scope="module")
def frames():
    return load_frames()


def load_frames():
    """(depth 0, depth 1, K, w2c 0, w2c 1) of the 64 x 96 synthetic room."""
    ds = SyntheticRoomDataset(num_frames=20, height=64, width=96, seed=3,
                              motion_scale=0.3)
    _, d0, K, p0 = ds[0]
    _, d1, _, p1 = ds[1]
    K3 = np.asarray(K[:3, :3], np.float32)
    w2c0 = np.linalg.inv(np.asarray(p0, np.float64)).astype(np.float32)
    w2c1 = np.linalg.inv(np.asarray(p1, np.float64)).astype(np.float32)
    return d0[..., 0].astype(np.float32), d1[..., 0].astype(np.float32), \
        K3, w2c0, w2c1


def _targets(d, K, w2c):
    j = JP2P.make_p2p_target(jnp.asarray(d), jnp.asarray(K), jnp.asarray(w2c))
    t = TP2P.make_p2p_target(torch.as_tensor(d), torch.as_tensor(K),
                             torch.as_tensor(w2c))
    return j, t


def test_target_rows_match(frames):
    d0, _, K, w2c0, _ = frames
    j, t = _targets(d0, K, w2c0)
    a, b = np_(t.packed), np.asarray(j.packed)
    assert a.shape == b.shape == (d0.size, 8)
    np.testing.assert_allclose(a[:, :3], b[:, :3], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a[:, 3:6], b[:, 3:6], atol=1e-5)
    np.testing.assert_array_equal(a[:, 6:], b[:, 6:])
    assert 0 < a[:, 6].mean() <= 1


def _offset(w2c, seed):
    if seed == 0:
        return w2c
    rng = np.random.default_rng(seed)
    q = np.concatenate([[1.0], rng.normal(0, 0.01, 3)]).astype(np.float32)
    dt = rng.normal(0, 0.01, 3).astype(np.float32)
    off = np_(TG.pose_to_w2c(TG.normalize(torch.as_tensor(q)),
                             torch.as_tensor(dt)))
    return (off @ w2c).astype(np.float32)


U = 2.0 ** -24      # the f32 unit roundoff


class _WhereSpy:
    """Stands in for a module's array library and records each `where`:
    both metrics select their residuals with where(pair, resid, 0), which
    gives the pair mask and the residuals they summed."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def where(self, cond, *args):
        out = self.lib.where(cond, *args)
        self.calls.append((np_(cond), np_(out)))
        return out


def _metric(module, name, call, n):
    """(metric, pair mask, residuals) of `call()`, the metric of `module`
    whose array library is its global `name`, over n source pixels."""
    lib = getattr(module, name)
    spy = _WhereSpy(lib)
    setattr(module, name, spy)
    try:
        m = float(call())
    finally:
        setattr(module, name, lib)
    (pair, resid), = [(c, o) for c, o in spy.calls
                      if c.dtype == bool and c.shape == (n,)]
    return m, pair, resid.astype(np.float64)


def port_metric(target_of, d, K, w2c, dtype, method):
    t = target_of(dtype)
    return _metric(TP2P, "torch", lambda: TP2P.point2plane_metric(
        t, torch.as_tensor(d).to(dtype), torch.as_tensor(K).to(dtype),
        torch.as_tensor(w2c).to(dtype), method=method), d.size)


def jax_metric(target, d, K, w2c, method):
    return _metric(JP2P, "jnp", lambda: JP2P.point2plane_metric(
        target, jnp.asarray(d), jnp.asarray(K), jnp.asarray(w2c),
        method=method), d.size)


def _residual_bound(d, K, w2c, pair):
    """How far an f32 evaluation may put each kept residual from the exact
    one. Residual i = n . (p_src - p_tgt) is a difference of two world
    points of magnitude |p| (the target point within 0.02 m of the source
    one); each is a back-projection (2 roundings) and a rigid transform (3
    products, 3 sums per coordinate) in f32, so each of its coordinates
    carries up to ~8 u (|p|_1 + |t|_1) of rounding, and the unit normal
    weighs the three: delta_i = 8 u sqrt(3) (2 (|p_src|_1 + |t|_1) +
    0.06)."""
    H, W = d.shape
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    K = K.astype(np.float64)
    z = d.astype(np.float64)
    cam = np.stack([(u + 0.5 - K[0, 2]) / K[0, 0] * z,
                    (v + 0.5 - K[1, 2]) / K[1, 1] * z, z], -1).reshape(-1, 3)
    c2w = np.linalg.inv(w2c.astype(np.float64))
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    mag = np.abs(world).sum(-1) + np.abs(c2w[:3, 3]).sum()
    return (8 * U * np.sqrt(3.0) * (2 * mag + 0.06))[pair]


def _metric_bound(method, pair, resid, exact):
    """How far the metric of the f32 residuals `resid` may sit from the
    exact metric (residuals `exact`): "sum" moves by sum_i (2 |r_i| e_i +
    e_i^2), e_i = |resid_i - exact_i|, plus its f32 accumulation's
    n_pairs u sum_i r_i^2; "max" by max_i e_i (1-Lipschitz in each entry,
    and a max does not round); the top-100 mean by max_i e_i plus its
    100 u m."""
    r, e = np.abs(exact[pair]), np.abs(resid - exact)[pair]
    if method == "sum":
        return float((2 * r * e + e ** 2).sum() + pair.sum() * U
                     * (resid[pair] ** 2).sum())
    m = r.max() if method == "max" else np.sort(r)[-100:].mean()
    return float(e.max() + (100 * U * m if method == "max100" else 0.0))


def check_metric(frames, method, seed):
    """The port's metric against its f64 self and the JAX package's.
    Returns each check's largest gap over its limit (MARGINS), each
    side's relative gap to f64 beside its bound's, and whether the port's
    f32 metric has the JAX package's bits."""
    d0, d1, K, w2c0, w2c1 = frames
    src = _offset(w2c1, seed)
    j, _ = _targets(d0, K, w2c0)

    def target_of(dtype):
        return TP2P.make_p2p_target(torch.as_tensor(d0).to(dtype),
                                    torch.as_tensor(K).to(dtype),
                                    torch.as_tensor(w2c0).to(dtype))

    m64, p64, r64 = port_metric(target_of, d1, K, src, torch.float64, method)
    mt, pt, rt = port_metric(target_of, d1, K, src, torch.float32, method)
    mj, pj, rj = jax_metric(j, d1, K, src, method)
    assert np.isfinite(mj) and mj > 0 and p64.sum() > 1000
    # the same pairs on all three: the association and its culls agree
    np.testing.assert_array_equal(pt, p64)
    np.testing.assert_array_equal(pj, p64)
    out = {"same_bits": mt == mj}
    # each side's metric within what its own residuals' gaps allow, then
    # its residuals pair by pair within f32 rounding of the exact ones
    for side, m, r in (("port", mt, rt), ("jax", mj, rj)):
        bound = _metric_bound(method, p64, r, r64)
        out[side] = abs(m - m64) / bound
        out[side + " relative"] = (abs(m - m64) / m64, bound / m64)
        assert abs(m - m64) <= bound, (
            f"{side} metric {method!r}: {m!r} is {abs(m - m64):.3e} from "
            f"f64 {m64!r}, over its bound {bound:.3e}")
    delta = _residual_bound(d1, K, src, p64)
    for side, r in (("port", rt), ("jax", rj)):
        out[side + " residuals"] = float((np.abs(r - r64)[p64] / delta).max())
        assert out[side + " residuals"] <= 1.0, (
            f"{side} residuals {method!r}: {out[side + ' residuals']:.3f} "
            "of the rounding bound")
    return out


MARGINS = ("port", "jax", "port residuals", "jax residuals")
MKL_VARS = ("MKL_CBWR", "MKL_ENABLE_INSTRUCTIONS")


def metric_margins(seed=0) -> dict:
    """check_metric's margins for every method at `seed`, with the MKL
    settings they ran under: what `test_metric_on_mkl_path` runs in its
    child process."""
    frames = load_frames()
    return {"mkl": {k: os.environ.get(k) for k in MKL_VARS},
            **{m: check_metric(frames, m, seed) for m in METHODS}}


def print_margins(res: dict) -> None:
    print("MKL", res["mkl"])
    for m in METHODS:
        r = res[m]
        print(f"  {m}: port metric {r['port']:.3f}, jax metric "
              f"{r['jax']:.3f}, residuals {r['port residuals']:.3f} / "
              f"{r['jax residuals']:.3f} of their bounds; relative gap to "
              f"f64 (bound) port {r['port relative'][0]:.3e} "
              f"({r['port relative'][1]:.3e}), jax {r['jax relative'][0]:.3e}"
              f" ({r['jax relative'][1]:.3e}); the port's bits equal JAX's: "
              f"{r['same_bits']}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_matches(frames, method, seed):
    check_metric(frames, method, seed)


@pytest.mark.parametrize("path", ["compatible", "avx2"])
def test_metric_on_mkl_path(path):
    """check_metric at seed 0 for every method in a child process whose
    MKL runs another sgemm path (`torch_port_util.MKL_PATHS`): the
    COMPATIBLE branch (no FMA) and the AVX2 one; the in-process cases run
    the host's default. -rP prints the margins."""
    if not torch.backends.mkl.is_available():
        pytest.skip("torch without MKL: no MKL sgemm path to pick")
    res = on_mkl_path(path, "test_torch_p2p", "metric_margins")
    print_margins(res)
    for m in METHODS:
        assert max(res[m][k] for k in MARGINS) <= 1.0


@pytest.mark.parametrize("method", METHODS)
def test_no_pairs_score_infinite(frames, method):
    d0, d1, K, w2c0, _ = frames
    j, t = _targets(d0, K, w2c0)
    flip = np_(TG.pose_to_w2c(torch.tensor([0.0, 0.0, 1.0, 0.0]),
                              torch.tensor([50.0, 0.0, 0.0])))
    nan_pose = np.full((4, 4), np.nan, np.float32)
    for pose in (flip, nan_pose):
        mj = float(JP2P.point2plane_metric(j, jnp.asarray(d1), jnp.asarray(K),
                                           jnp.asarray(pose), method=method))
        mt = float(TP2P.point2plane_metric(t, torch.as_tensor(d1),
                                           torch.as_tensor(K),
                                           torch.as_tensor(pose),
                                           method=method))
        assert mj == mt == float("inf")
    # and the flip is the JAX test's own: the JAX geometry agrees on it
    np.testing.assert_allclose(
        flip, np.asarray(JG.pose_to_w2c(jnp.array([0.0, 0.0, 1.0, 0.0]),
                                        jnp.array([50.0, 0.0, 0.0]))))
