"""Negative controls: a real fault monkeypatched into the port's CPU route
must fail the parity checks that hold the port against the JAX package.

Engine (test_torch_slice's config, 3 frames): the JAX engine and its
one-ulp spread run once; each control runs the port with one fault and
names the check it trips: the exact Gaussian counts, or the trained fields
on the spread yardstick (torch_port_util.assert_fields_within_spread), or
the densified means held at the poses they were built from
(torch_port_util.assert_means_at_own_poses).
test_torch_boundaries.py holds the first fault against that yardstick on
its four-section run as well.

Depth-prefix truncation (test_torch_truncation_parity's config, binned
route; and its 66-tile case, both routes): a tile window that keeps the
wrong pairs at the budget must move the port's truncation loss (W6), and
its route gap (W2) or densify counts, off the JAX package's by more than
that test allows.

A fault that scales a gradient by a constant (e.g. K3's opacity row x 1.01)
trips neither: Adam divides each entry's step by its own gradient's RMS,
so the trained fields come out the same up to rounding (measured: its gap
to JAX was smaller than the unfaulted port's). Such faults are held by the
kernel tests, which compare K3's rows with JAX's directly.

Point-to-plane metric (test_torch_p2p's frames): a fault in the port's
association or its normals reaches the port's f64 yardstick too, so it
must break the pair set JAX keeps or JAX's rounding bound around it
(test_torch_p2p.check_metric). A sign flip of some normals is no control:
every method squares or takes |n . dp|. A fault in the metric's reduction
(residuals scaled by 1 + 1e-3 after they are selected) passes the pair and
residual checks and must trip a metric check on every MKL sgemm path: the
port's own against its f64 value where the fault is on f32 inputs alone,
the JAX side's where it moves the f64 yardstick too.

ScanNet++ route (test_torch_scannetpp's run): a wrong odometer init must
move the port's tracking-loss histories outside the JAX engine's one-ulp
spread (test_torch_scannetpp.assert_histories_within_spread).

Splat and blend forwards held to the exact value of the plain walk
(torch_port_util.assert_splat_within_rounding /
assert_blend_within_rounding: the grouped rehearsals of K1 and K4, and
test_torch_two_class's single-class rows): a 1e-4 scale of the grouped
outputs, and of the weights of a walk wider than the sparse budget, must
fail them."""
import pytest
import torch

import test_torch_p2p as P2P
import test_torch_scannetpp as SNPP
import test_torch_two_class as TWO
import test_torch_walk_boxes as WB
import test_torch_truncation_parity as TR
from test_torch_boundaries import _port_run
from test_torch_slice import (FRAMES, ITERS, _config, run_jax_slice,
                              run_port_slice, slice_draws)
from torch_port_util import (assert_blend_within_rounding,  # noqa: F401
                             assert_fields_within_spread,
                             assert_means_at_own_poses,
                             assert_splat_within_rounding, k5_records,
                             on_mkl_path, one_thread)
from test_torch_scannetpp import runs, spread  # noqa: F401
from vtgaussian_slam_tpu.ops import image as JI
from vtgaussian_slam_tpu_torch.core import densify as TD
from vtgaussian_slam_tpu_torch.core import mapping as TMP
from vtgaussian_slam_tpu_torch.core import p2p as TP2P
from vtgaussian_slam_tpu_torch.core import pipeline as TP
from vtgaussian_slam_tpu_torch.ops import geometry as geo
from vtgaussian_slam_tpu_torch.ops.rasterizer import binning as TB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB
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


def _densify_points(mp, move):
    """densify_from_pixels' camera-frame points passed through `move`."""
    from_pixels = TP.densify_from_pixels

    def faulty(cam_quat, cam_trans, depth_vals, colors, idx, valid, cam):
        c = from_pixels(cam_quat, cam_trans, depth_vals, colors, idx, valid,
                        cam)
        w2c = geo.pose_to_w2c(geo.normalize(cam_quat), cam_trans)
        pts_cam = move(geo.transform_points(w2c, c.points), cam)
        return c._replace(points=geo.transform_points(geo.invert_se3(w2c),
                                                      pts_cam))

    mp.setattr(TP, "densify_from_pixels", faulty)


def _densify_points_scaled(mp):
    """Densified camera-frame points scaled by a further x1.001 (~4e-3 m
    at 4 m)."""
    _densify_points(mp, lambda p, cam: p * 1.001)


def _densify_without_pixel_centre_x(mp):
    """Densified points without the +0.5 pixel centre on the x axis
    (0.5 / fx of the depth)."""
    _densify_points(mp, lambda p, cam: torch.stack(
        [p[:, 0] - 0.5 / cam.fx * p[:, 2], p[:, 1], p[:, 2]], -1))


@pytest.fixture(scope="module")
def jax_slice(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)          # the numpy Canny on both
        cfg = _config(tmp_path_factory.mktemp("controls"))
        jeng, jrun, spread = run_jax_slice(cfg)
    return cfg, jrun, spread, slice_draws(cfg), jeng


@pytest.mark.parametrize("fault, trips", [
    (_k3_opacity_without_sigmoid_factor, "fields"),
    (_k3_rgb_sign_on_a_tenth, "fields"),
    (_mapping_adam_eps_of_tracking, "counts"),
    (_densify_threshold_plus_1pct, "counts"),
])
def test_engine_fault_fails_the_parity_check(jax_slice, fault, trips):
    cfg, (j_n, _, j_end), spread, draws, _ = jax_slice
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


@pytest.mark.parametrize("fault", [_densify_points_scaled,
                                   _densify_without_pixel_centre_x])
def test_densify_fault_fails_the_means_check(jax_slice, fault):
    """Neither fault is a rigid motion of the camera, so holding each mean
    at the pose it was built from cannot absorb it. Both also change frame
    2's count (5245 against 5240, measured), which the count check
    catches; the means check is held on the rows of frames 0 and 1, which
    both runs share."""
    cfg, (j_n, _, _), _, draws, jeng = jax_slice
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JI, "cv2", None)
        fault(mp)
        teng, (t_n, _, _) = run_port_slice(cfg, draws)
    assert t_n[:2] == j_n[:2], (fault.__doc__, t_n, j_n)
    with pytest.raises(AssertionError, match="means at their own poses"
                       ) as err:
        assert_means_at_own_poses(teng.sections[0], jeng.sections[0],
                                  teng.traj, jeng.traj, j_n[1])
    print(fault.__name__, [line.strip() for line in str(err.value).splitlines()
                           if "Mismatched" in line or "Max abs" in line])


def _keep_last_pairs_by_depth(mp):
    """Each tile's depth-ordered window keeps the last mpt pairs by depth
    instead of the first (the prefix)."""
    windows = TB._windows

    def faulty(ps, tids, mpt, select):
        if select == "depth":
            ps = dict(ps, start=torch.maximum(ps["start"], ps["end"] - mpt))
        return windows(ps, tids, mpt, select)

    mp.setattr(TB, "_windows", faulty)


def test_prefix_cut_fault_fails_the_truncation_check(tmp_path):
    """test_torch_truncation_parity's check on the binned route alone (its
    W6: the eval_mode budget minus the training budget)."""
    jax_s, port_s, nudged, _ = TR.run_routes(tmp_path, ("binned",),
                                             _keep_last_pairs_by_depth)
    with pytest.raises(AssertionError, match="W6 binned"):
        TR.assert_port_shares(jax_s, port_s, nudged)


def test_prefix_cut_fault_fails_the_route_gap_check(tmp_path):
    """test_torch_truncation_parity's 66-tile W2 check (trace_w2_scale's
    room0 proxy at 96 x 176) with the same wrong window."""
    jax_s, port_s, nudged = TR.run_scale(tmp_path, _keep_last_pairs_by_depth)
    with pytest.raises(AssertionError, match="W2 at the eval budget"):
        TR.assert_scale_shares(jax_s, port_s, nudged)


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


def _p2p_reduction_scaled(mp, precision):
    """The port's metric reduced from its residuals scaled by 1 + 1e-3
    after the pairs' residuals are selected (the sum of squares x (1 +
    1e-3)^2, the max and the top-100 mean x (1 + 1e-3)): on f32 inputs
    alone ("f32"), or at every precision ("every")."""
    metric = TP2P.point2plane_metric

    def faulty(target, src_depth, *args, method="sum", **kw):
        m = metric(target, src_depth, *args, method=method, **kw)
        if precision == "f32" and src_depth.dtype != torch.float32:
            return m
        return m * (1 + 1e-3) ** (2 if method == "sum" else 1)

    mp.setattr(TP2P, "point2plane_metric", faulty)


# which of test_torch_p2p.check_metric's checks each precision must trip
P2P_TRIPS = {"f32": "port metric", "every": "jax metric"}


def p2p_fault_trips() -> dict:
    """{"<precision> <method>": the first line of check_metric's assertion
    message at seed 0 under _p2p_reduction_scaled, or None if it passed}."""
    frames = P2P.load_frames()
    out = {}
    for precision in P2P_TRIPS:
        for method in P2P.METHODS:
            with pytest.MonkeyPatch.context() as mp:
                _p2p_reduction_scaled(mp, precision)
                try:
                    P2P.check_metric(frames, method, 0)
                    out[f"{precision} {method}"] = None
                except AssertionError as err:
                    out[f"{precision} {method}"] = str(err).splitlines()[0]
    return out


@pytest.mark.parametrize("path", ["default", "compatible", "avx2"])
def test_p2p_reduction_fault_fails_the_metric_check(path):
    """On the host's default MKL path in process, on the others in a child
    process (torch_port_util.on_mkl_path). -rP prints each message."""
    if path == "default":
        trips = p2p_fault_trips()
    elif not torch.backends.mkl.is_available():
        pytest.skip("torch without MKL: no MKL sgemm path to pick")
    else:
        trips = on_mkl_path(path, "test_torch_parity_controls",
                            "p2p_fault_trips")
    for key, msg in trips.items():
        print(f"{path} {key}: {msg}")
    for precision, want in P2P_TRIPS.items():
        for method in P2P.METHODS:
            msg = trips[f"{precision} {method}"]
            assert msg is not None and msg.startswith(want), (
                path, precision, method, msg)


def _odometer_inverted(self, t, rel_c2w):
    """The odometer's relative pose applied inverted: c2w_{t-1} . rel^-1."""
    rel = torch.as_tensor(rel_c2w, dtype=torch.float32)
    c2w = geo.invert_se3(self._traj_w2c(t - 1)) @ geo.invert_se3(rel)
    w2c = geo.invert_se3(c2w)
    return geo.rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3]


def _odometer_composed_on_the_left(self, t, rel_c2w):
    """The odometer's relative pose composed on the wrong side:
    rel . c2w_{t-1} for c2w_{t-1} . rel."""
    rel = torch.as_tensor(rel_c2w, dtype=torch.float32)
    c2w = rel @ geo.invert_se3(self._traj_w2c(t - 1))
    w2c = geo.invert_se3(c2w)
    return geo.rotmat_to_quat(w2c[:3, :3]), w2c[:3, 3]


@pytest.mark.parametrize("fault", [_odometer_inverted,
                                   _odometer_composed_on_the_left])
def test_odometer_fault_fails_the_history_check(  # noqa: F811
        runs, spread, fault):
    """Both keep the rescue decisions, iteration counts and Gaussian counts
    (measured), so the histories' spread check is what must trip."""
    cfg, jeng, _, _, _, _, _, rec = runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP.VTGaussianSLAM, "_pose_from_rel", fault)
        teng, _, _ = _port_run(cfg, rec, jeng, SNPP.FRAMES)
    with pytest.raises(AssertionError, match="outside the JAX engine's spread"
                       ) as err:
        SNPP.assert_histories_within_spread(teng, jeng, spread)
    print(fault.__name__, str(err.value).splitlines()[0])


def _scaled(out, channels):
    """`out` with `channels` (an index) x (1 + 1e-4)."""
    out = out.clone()
    out[channels] *= 1 + 1e-4
    return out


def test_grouped_splat_fault_fails_the_rounding_check():
    """test_torch_walk_boxes' smoke case: the grouped K1 rehearsal with its
    colour and depth channels x (1 + 1e-4)."""
    slots, counts, cp, tiles_x, ids = WB._slot_case("smoke")
    got = _scaled(CS.splat_forward_grouped(slots, counts, cp, tiles_x, ids),
                  (slice(None), slice(0, 6)))
    with pytest.raises(AssertionError, match="f32 rounding bound") as err:
        assert_splat_within_rounding(got, slots, counts, cp, tiles_x, ids,
                                     "grouped")
    print(str(err.value).splitlines()[0])


def test_grouped_blend_fault_fails_the_rounding_check():
    """A full-count record case: the grouped K4 rehearsal x (1 + 1e-4)."""
    recs, counts = (torch.as_tensor(a) for a in k5_records(0, 128))
    got = _scaled(CB.blend_forward_grouped(recs, counts, WB.TILES_X, 8),
                  (Ellipsis,))
    with pytest.raises(AssertionError, match="f32 rounding bound") as err:
        assert_blend_within_rounding(got, recs, counts, WB.TILES_X, 8,
                                     "grouped")
    print(str(err.value).splitlines()[0])


def test_width_dependent_splat_fault_fails_the_single_class_check():
    """test_torch_two_class's binned case with the plain K1's weights x (1
    + 1e-4) on tables wider than the sparse budget: the dense rows and the
    MPT_D render move together, the sparse rows (MPT_S wide) do not."""
    walk = CS._walk

    def faulty(slots8, *args):
        w = walk(slots8, *args)
        if slots8.shape[2] > TWO.MPT_S:
            w = dict(w, weight=w["weight"] * (1 + 1e-4))
        return w

    p, _, _, k = TWO.case.__wrapped__()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CS, "_walk", faulty)
        rows = TWO.binned_rows(p, TWO.kf_cache_2c(p, k))
        with pytest.raises(AssertionError, match="merged channels 0-5"
                           ) as err:
            TWO.assert_single_class_rows(*rows)
    print(str(err.value).splitlines()[0])
