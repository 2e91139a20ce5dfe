"""The splat backwards' tensor-core reduction, rehearsed on the CPU.

K2, K3 and K6 (csrc/splat.cu) take each slot's sums over the tile's pixels
as two products, Mg = GP . PHI over the pixel moments about the tile centre
and Mw = W . GC over the cotangent columns, with TF32 operands split into
hi + lo, and rebuild the dx / dy sums from the moments. The kernel runs
only on the card; `cuda_splat.backward_sums_tf32` repeats its arithmetic
(hi rounded to TF32 as cvt.rna does it, lo cut to its TF32 part as the mma
reads it, the split products, the epilogue) in plain PyTorch. Held
against the direct sums of `_backward_sums`: each sum within 1e-5 of its
largest |value| (the split leaves ~2^-22 of each product; the moment
expansion cancels at most a few hundred times that), and the gradients
after the chain within 1e-3 of their largest entry, the tolerance of the
kernels' card tests.

Beside them, the rows of a tile subset (the tile-id operand): a padded row
(count 0, tile 0) under a nonzero cotangent row gets exact zeros from the
K2 and K3 plain versions."""
import numpy as np
import pytest
import torch

from torch_port_util import (POSE_Q, POSE_T, TILES_X, assert_close_scaled,
                             np_, random_tile_slots, scene_np, slots_at,
                             torch_cam, torch_params)
from vtgaussian_slam_tpu_torch.core.track_cache import build_track_cache
from vtgaussian_slam_tpu_torch.ops import geometry as geo
from vtgaussian_slam_tpu_torch.ops.camera import Camera
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS

SUMS_RTOL = 1e-5
CHAIN_RTOL = 1e-3
EYE9 = torch.eye(3).reshape(9)
ZERO3 = torch.zeros(3)


def _cotangent(shape, seed, rows_in_image=16):
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    g[:, 6:] = 0.0
    g = g.reshape(shape[0], 8, 16, 16)
    g[:, :, rows_in_image:] = 0.0      # pixel rows below the image
    return torch.as_tensor(g.reshape(shape))


def _smoke():
    """600 Gaussians on the 3 x 3 test tiles at mpt 128 (the card tests'
    case): saturated tiles and pixels that stop mid-chunk."""
    prm = torch_params(scene_np(600, 0))
    q, t = torch.as_tensor(POSE_Q), torch.as_tensor(POSE_T)
    cam = torch_cam()
    tc = build_track_cache(prm, torch.ones(600, dtype=torch.bool), q, t, cam,
                           span_cap=3, max_pairs_per_tile=128,
                           select="importance")
    R9 = geo.quat_to_rotmat(geo.normalize(q)).reshape(9)
    return tc.slots8, tc.counts, CS.cp_vector(R9, t, cam), TILES_X, None, 16


def _last_tile_row():
    """A 680-row frame: its last tile row (42) holds 8 image rows; the
    cotangent is zero on the 8 pixel rows below the image."""
    cam = Camera(height=680, width=48, fx=600.0, fy=600.0, cx=24.0, cy=340.0)
    ids = torch.tensor([126, 127, 128])
    slots = torch.as_tensor(random_tile_slots(
        ids, 3, 96, seed=3, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy))
    counts = torch.tensor([96, 70, 33], dtype=torch.int32)
    return slots, counts, CS.cp_vector(EYE9, ZERO3, cam), 3, ids, 8


def _far_means():
    """Slots whose means lie a full tile span (16 px) or more outside the
    centre tile, wide enough to reach into it: the moment expansion's worst
    cancellation (|mx| up to 31.5 about the tile centre)."""
    far = [(-16, 8), (32, 8), (8, -16), (8, 32), (-16, -16), (32, 32),
           (-20, 4), (36, 12)]
    px = np.array([16 + a for a, _ in far], np.float64)
    py = np.array([16 + b for _, b in far], np.float64)
    near = random_tile_slots([4], TILES_X, 24, seed=8)[0]
    rows = np.concatenate([slots_at(px, py, 2.0, 9.0, 2.0, (0.3, 0.6, 0.9)),
                           near], 1)
    slots = torch.as_tensor(rows[None].copy())
    counts = torch.tensor([rows.shape[1]], dtype=torch.int32)
    return slots, counts, CS.cp_vector(EYE9, ZERO3, torch_cam()), TILES_X, \
        torch.tensor([4]), 16


CASES = {"smoke": _smoke, "last_tile_row_680": _last_tile_row,
         "far_means": _far_means}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    slots, counts, cp, tiles_x, ids, rows = CASES[request.param]()
    out = CS.splat_forward_plain(slots, counts, cp, tiles_x, ids)
    g = _cotangent(tuple(out.shape), 1, rows)
    return request.param, (slots, counts, cp, tiles_x, out, g, ids)


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 3.14159, -0.0, 225.0])
    np.testing.assert_array_equal(
        CS.tf32_round(x).numpy(),
        np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                  -(1.0 + 2.0 ** -10), 3.140625, -0.0, 225.0], np.float32))
    phi = CS.pixel_moment_basis()
    np.testing.assert_array_equal(CS.tf32_round(phi).numpy(), phi.numpy())


def test_case_exercises_what_it_names(case):
    name, (slots, counts, cp, tiles_x, out, g, ids) = case
    w = CS._walk(slots, counts, cp, tiles_x, ids)
    blended = (w["keep"] & w["include"]).any(1)          # (T, M)
    assert bool(blended.any())
    if name == "far_means":
        assert bool(blended[0, :8].all())                # every far slot blends
    if name == "last_tile_row_680":
        assert bool((counts % 16 != 0).any())
        assert float(g.reshape(-1, 8, 16, 16)[:, :, 8:].abs().max()) == 0.0


def test_moment_sums_match_direct_sums(case):
    _, args = case
    errs = CS.moment_sums_error(*args)
    assert errs["max"] <= SUMS_RTOL, errs


def test_gradients_from_moment_sums(case):
    _, args = case
    sums = CS.backward_sums_tf32(*args)
    assert_close_scaled(CS.splat_backward_pose_plain(*args, sums=sums),
                        CS.splat_backward_pose_plain(*args), CHAIN_RTOL,
                        "K2 partials")
    got = CS.splat_backward_vals_rows_plain(*args, sums=sums)
    ref = CS.splat_backward_vals_rows_plain(*args)
    for col in range(3, 8):
        assert_close_scaled(got[..., col], ref[..., col], CHAIN_RTOL,
                            f"K3 column {col}")
    got = CS.splat_backward_all_plain(*args, sums=sums)
    ref = CS.splat_backward_all_plain(*args)
    for row in range(8):
        assert_close_scaled(got[:, row], ref[:, row], CHAIN_RTOL,
                            f"K6 row {row}")


def test_padded_rows_backward_is_zero():
    """A padded row (count 0, tile 0) gets the cotangent of a real tile's
    row (g[tids]); K2 and K3 must give it exact zeros."""
    H, W, fx, tiles_x = 48, 64, 50.0, 4
    rng = np.random.default_rng(4)
    slots = torch.as_tensor(random_tile_slots([0, 3, 0, 0], tiles_x, 128,
                                              seed=9, fx=fx, fy=fx, cx=W / 2,
                                              cy=H / 2))
    counts = torch.tensor([128, 100, 0, 0], dtype=torch.int32)
    tids = torch.tensor([0, 3, 0, 0], dtype=torch.int32)
    R9, t = torch.eye(3).reshape(9), torch.zeros(3)
    cam = Camera(height=H, width=W, fx=fx, fy=fx, cx=W / 2, cy=H / 2)
    out = CS.splat_forward(slots, R9, t, counts, cam, tiles_x, tids)
    np.testing.assert_array_equal(np_(out[2:, :6]), 0.0)
    g = torch.as_tensor(rng.standard_normal((4, 8, 256)).astype(np.float32))
    g[2:] = g[0]
    pose = CS.splat_backward_pose(slots, R9, t, counts, out, g, cam, tiles_x,
                                  tids)
    rows = CS.splat_backward_vals_rows(slots, R9, t, counts, out, g, cam,
                                       tiles_x, tids)
    assert bool(pose[0].abs().sum() > 0) and bool(rows[0].abs().sum() > 0)
    np.testing.assert_array_equal(np_(pose[2:]), 0.0)
    np.testing.assert_array_equal(np_(rows[2:]), 0.0)
