"""Negative controls: a real fault monkeypatched into the port's CPU route
must fail the parity checks that hold the port against the JAX package.

Engine (test_torch_slice's config, 3 frames): the JAX engine and its
one-ulp spread run once; each control runs the port with one fault and
names the check it trips: the exact Gaussian counts, or the trained fields
on the spread yardstick (torch_port_util.assert_fields_within_spread).
test_torch_boundaries.py holds the first fault against that yardstick on
its four-section run as well.

A fault that scales a gradient by a constant (e.g. K3's opacity row x 1.01)
trips neither: Adam divides each entry's step by its own gradient's RMS,
so the trained fields come out the same up to rounding (measured: its gap
to JAX was smaller than the unfaulted port's). Such faults are held by the
kernel tests, which compare K3's rows with JAX's directly.

Point-to-plane metric (test_torch_p2p's frames): a fault in the port's
association or its normals reaches the port's f64 yardstick too, so it
must break the pair set JAX keeps or JAX's rounding bound around it
(test_torch_p2p.check_metric). A sign flip of some normals is no control:
every method squares or takes |n . dp|."""
import pytest
import torch

import test_torch_p2p as P2P
from test_torch_slice import (FRAMES, ITERS, _config, run_jax_slice,
                              run_port_slice, slice_draws)
from torch_port_util import (assert_fields_within_spread,  # noqa: F401
                             one_thread)
from vtgaussian_slam_tpu.ops import image as JI
from vtgaussian_slam_tpu_torch.core import densify as TD
from vtgaussian_slam_tpu_torch.core import mapping as TMP
from vtgaussian_slam_tpu_torch.core import p2p as TP2P
from vtgaussian_slam_tpu_torch.core import pipeline as TP
from vtgaussian_slam_tpu_torch.ops import geometry as geo
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS

frames = P2P.frames


def _k3_opacity_without_sigmoid_factor(mp):
    """K3's opacity row without the sigmoid's (1 - sig) factor."""
    rows_of = CS.splat_backward_vals_rows_plain

    def faulty(slots8, counts, cp, tiles_x, out, g, tile_ids=None, sums=None):
        q, s = sums or CS._backward_sums(slots8, counts, cp, tiles_x, out, g,
                                         tile_ids)
        rows = rows_of(slots8, counts, cp, tiles_x, out, g, tile_ids,
                       sums=(q, s)).clone()
        rows[..., 3] = s["s_ge"] * q["sig"] * q["ok"].float()
        return rows

    mp.setattr(CS, "splat_backward_vals_rows_plain", faulty)


def _k3_rgb_sign_on_a_tenth(mp):
    """K3's colour rows negated on every tenth slot of a tile."""
    rows_of = CS.splat_backward_vals_rows_plain

    def faulty(*args, **kw):
        rows = rows_of(*args, **kw).clone()
        rows[:, ::10, 5:8] *= -1.0
        return rows

    mp.setattr(CS, "splat_backward_vals_rows_plain", faulty)


def _mapping_adam_eps_of_tracking(mp):
    """The mapping loop stepping Adam with the tracking eps (1e-8)."""
    mp.setattr(TMP, "MAP_EPS", 1e-8)


def _densify_threshold_plus_1pct(mp):
    """Densification's silhouette threshold 1% high."""
    nonpresence = TD.densify_nonpresence

    def faulty(params, active, quat, trans, frame, cam, sil_thres,
               backend_kwargs=()):
        return nonpresence(params, active, quat, trans, frame, cam,
                           sil_thres * 1.01, backend_kwargs)

    mp.setattr(TP, "densify_nonpresence", faulty)


@pytest.fixture(scope="module")
def jax_slice(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)          # the numpy Canny on both
        cfg = _config(tmp_path_factory.mktemp("controls"))
        jeng, jrun, spread = run_jax_slice(cfg)
    return cfg, jrun, spread, slice_draws(cfg)


@pytest.mark.parametrize("fault, trips", [
    (_k3_opacity_without_sigmoid_factor, "fields"),
    (_k3_rgb_sign_on_a_tenth, "fields"),
    (_mapping_adam_eps_of_tracking, "counts"),
    (_densify_threshold_plus_1pct, "counts"),
])
def test_engine_fault_fails_the_parity_check(jax_slice, fault, trips):
    cfg, (j_n, _, j_end), spread, draws = jax_slice
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)
        fault(mp)
        _, (t_n, _, t_end) = run_port_slice(cfg, draws)
    if t_n != j_n:
        tripped = "counts"
    else:
        try:
            assert_fields_within_spread(t_end, j_end, spread,
                                        cfg["mapping"]["lrs"], FRAMES * ITERS)
            tripped = None
        except AssertionError:
            tripped = "fields"
    assert tripped == trips, (fault.__doc__, t_n, j_n)


def _round_not_floor(mp):
    """Association to the nearest pixel (round) instead of the pixel the
    ray went through (floor)."""

    class Lib:
        def __getattr__(self, name):
            return getattr(torch, name)

        floor = staticmethod(torch.round)

    mp.setattr(TP2P, "torch", Lib())


def _densify_depth_factor(mp):
    """Points back-projected with densification's x1.005 depth factor
    instead of the metric's 1."""

    class Geo:
        def __getattr__(self, name):
            return getattr(geo, name)

        @staticmethod
        def backproject(depth, K, c2w=None, depth_factor=1.0, **kw):
            return geo.backproject(depth, K, c2w=c2w, depth_factor=1.005,
                                   **kw)

    mp.setattr(TP2P, "geo", Geo())


@pytest.mark.parametrize("fault", [_round_not_floor, _densify_depth_factor])
@pytest.mark.parametrize("method", P2P.METHODS)
def test_p2p_fault_fails_the_parity_check(frames, fault, method):
    with pytest.MonkeyPatch.context() as mp:
        fault(mp)
        with pytest.raises(AssertionError):
            P2P.check_metric(frames, method, 1)
