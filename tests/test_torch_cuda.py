"""The port's kernels and device rules without the JAX package.

This file imports no JAX, so its card tests also run on a machine with a
GPU and no JAX:  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
Tests marked `cuda` skip without a card (the kernels have no CPU mode).
Kernel vs plain tolerances: the same f32 math in another order, rtol 1e-4 /
atol 1e-5 forward and 1e-3 of the largest entry for gradients (K2, K3, K5,
K6 and the generic render's gradients)."""
import numpy as np
import pytest
import torch

from torch_port_util import (POSE_Q, POSE_T, TILES_X, assert_close_scaled, np_,
                             random_tile_slots, scene_np, slots_at, torch_cam,
                             torch_params)
from vtgaussian_slam_tpu_torch.core.track_cache import build_track_cache
from vtgaussian_slam_tpu_torch.ops import geometry as geo
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS
from vtgaussian_slam_tpu_torch.utils.common import resolve_device


def _case(device="cpu", n=600, seed=0):
    p = scene_np(n, seed)
    prm = torch_params(p)
    q, t = torch.as_tensor(POSE_Q), torch.as_tensor(POSE_T)
    tc = build_track_cache(prm, torch.ones(n, dtype=torch.bool), q, t,
                           torch_cam(), span_cap=3, max_pairs_per_tile=128,
                           select="importance")
    R9 = geo.quat_to_rotmat(geo.normalize(q)).reshape(9)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (tc.slots8.shape[0], 8, 256)).astype(np.float32))
    g[:, 6:] = 0.0
    d = lambda x: x.to(device).contiguous()
    return d(tc.slots8), d(tc.counts), d(R9), d(t), d(g)


def _records(n_tiles=9, mpt=128, seed=0, op_hi=0.99, conic=(0.05, 0.5)):
    """Random depth-ordered records. With op_hi > 0.99 every 8th record is
    fully opaque and centred on a pixel (clamped alpha); small conics make
    wide splats, so whole tiles stop before their count."""
    rng = np.random.default_rng(seed)
    recs = np.zeros((n_tiles, 16, mpt), np.float32)
    counts = rng.integers(1, mpt + 1, n_tiles).astype(np.int32)
    counts[0] = mpt
    for t in range(n_tiles):
        ty, tx = divmod(t, TILES_X)
        k = counts[t]
        recs[t, 0, :k] = tx * 16 + rng.uniform(-2, 18, k)
        recs[t, 1, :k] = ty * 16 + rng.uniform(-2, 18, k)
        recs[t, 2, :k] = rng.uniform(*conic, k)
        recs[t, 4, :k] = rng.uniform(*conic, k)
        recs[t, 3, :k] = rng.uniform(-0.1, 0.1, k) * conic[0]
        recs[t, 5, :k] = rng.uniform(0.1, op_hi, k)
        recs[t, 6:14, :k] = rng.uniform(0, 1, (8, k))
        if op_hi > 0.99:
            recs[t, 5, :k:8] = 1.0
            recs[t, :2, :k:8] = np.round(recs[t, :2, :k:8])
    return torch.as_tensor(recs), torch.as_tensor(counts)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    p = scene_np(10, 0)
    p["cam_unnorm_rots"] = np.ones((1, 4, 2), np.float32)
    p["cam_trans"] = np.zeros((1, 3, 2), np.float32)
    from vtgaussian_slam_tpu_torch.models import gaussians as G
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.section_from_numpy_params(p)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.CameraTrajectory.create(2)
    assert G.section_from_numpy_params(p, device="cpu")[0].n_active == 10
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VTGaussianSLAM({"data": {}, "baseframe_every": 2})


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count
    nothing."""
    slots, counts, R9, t, g = _case()
    wrappers = (CS.splat_forward, CS.splat_backward_pose,
                CS.splat_backward_vals_rows, CS.splat_backward_all,
                CB.blend_forward, CB.blend_backward)
    before = [w.launches for w in wrappers]
    cam = torch_cam()
    out = CS.splat_forward(slots, R9, t, counts, cam, TILES_X)
    np.testing.assert_array_equal(
        np_(out), np_(CS.splat_forward_plain(slots, counts,
                                             CS.cp_vector(R9, t, cam), TILES_X)))
    CS.splat_backward_pose(slots, R9, t, counts, out, g, cam, TILES_X)
    CS.splat_backward_vals_rows(slots, R9, t, counts, out, g, cam, TILES_X)
    CS.splat_backward_all(slots, R9, t, counts, out, g, cam, TILES_X)
    recs, rc = _records()
    b_out = CB.blend_forward(recs, rc, TILES_X)
    CB.blend_backward(recs, rc, b_out, torch.ones_like(b_out), TILES_X)
    assert [w.launches for w in wrappers] == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 3])
def test_splat_kernels_match_plain(card, seed):
    cam = torch_cam()
    c_slots, c_counts, c_R9, c_t, c_g = _case("cpu", seed=seed)
    slots, counts, R9, t, g = _case(card, seed=seed)
    n0 = CS.splat_forward.launches
    out = CS.splat_forward(slots, R9, t, counts, cam, TILES_X)
    assert CS.splat_forward.launches == n0 + 1
    ref = CS.splat_forward(c_slots, c_R9, c_t, c_counts, cam, TILES_X)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-4, atol=1e-5)
    c_out = out.cpu()
    got = CS.splat_backward_pose(slots, R9, t, counts, out, g, cam, TILES_X)
    ref = CS.splat_backward_pose(c_slots, c_R9, c_t, c_counts, c_out, c_g, cam,
                                 TILES_X)
    assert_close_scaled(got, ref, 1e-3, "pose partials")
    got = CS.splat_backward_vals_rows(slots, R9, t, counts, out, g, cam,
                                      TILES_X)
    ref = CS.splat_backward_vals_rows(c_slots, c_R9, c_t, c_counts, c_out, c_g,
                                      cam, TILES_X)
    for col in range(8):
        assert_close_scaled(got[..., col], ref[..., col], 1e-3, f"col {col}")
    n6 = CS.splat_backward_all.launches
    got = CS.splat_backward_all(slots, R9, t, counts, out, g, cam, TILES_X)
    assert CS.splat_backward_all.launches == n6 + 1
    ref = CS.splat_backward_all(c_slots, c_R9, c_t, c_counts, c_out, c_g, cam,
                                TILES_X)
    for row in range(8):
        assert_close_scaled(got[:, row], ref[:, row], 1e-3, f"K6 row {row}")
    # slots no pixel walked are zero, as in the plain version
    walked = CS._walk(c_slots, c_counts, CS.cp_vector(c_R9, c_t, cam), TILES_X,
                      None)["walked"].any(1)
    assert bool((~walked).any())
    np.testing.assert_array_equal(np_(got.transpose(1, 2))[np_(~walked)], 0.0)


def _hand_case(kind):
    """The 9 test tiles, 128 hand-placed slots each (identity pose).
    "ragged_counts": counts 0 and others that are no multiple of the
    kernels' 16-slot sub-chunk; "early_stop": the centre tile starts with 8
    wide opaque splats, so all its pixels stop within the first
    sub-chunk; "no_box": the centre tile's slots are too faint (opacity
    below 1/255) or too far away for any cull box to touch it."""
    slots = random_tile_slots(range(9), TILES_X, 128, seed=12)
    counts = np.full(9, 128, np.int32)
    if kind == "ragged_counts":
        counts[:] = [0, 1, 15, 17, 33, 63, 65, 100, 128]
    elif kind == "no_box":
        slots[4, 3, 0::2] = -7.0
        slots[4, :, 1::2] = slots_at(np.full(64, 24.0) + 200.0, np.full(64, 24.0),
                                     slots[4, 2, 1::2], 2.0, 2.0,
                                     (0.5, 0.5, 0.5))
    else:
        slots[4, :, :8] = slots_at(np.full(8, 24.0), np.full(8, 24.0), 1.0,
                                   48.0, 8.0, (0.5, 0.5, 0.5))
    g = np.random.default_rng(13).standard_normal((9, 8, 256)).astype(
        np.float32)
    g[:, 6:] = 0.0
    return (torch.as_tensor(slots), torch.as_tensor(counts),
            torch.eye(3).reshape(9), torch.zeros(3), torch.as_tensor(g))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["track_cache", "ragged_counts", "early_stop"])
def test_splat_backwards_edge_cases_repeat_bitwise(card, kind):
    """K2, K3 and K6 against their plain versions on a tile with count 0,
    counts off the sub-chunk and a tile whose pixels all stop in its first
    sub-chunk; a second launch on the same inputs gives the same bits; the
    slots no pixel walked get exact zeros."""
    cam = torch_cam()
    slots, counts, R9, t, g = (_case("cpu", seed=0) if kind == "track_cache"
                               else _hand_case(kind))
    out = CS.splat_forward(slots, R9, t, counts, cam, TILES_X)
    c_args = (slots, R9, t, counts, out, g, cam, TILES_X)
    d_args = tuple(x.to(card) if isinstance(x, torch.Tensor) else x
                   for x in c_args)
    walked = CS._walk(slots, counts, CS.cp_vector(R9, t, cam), TILES_X,
                      None)["walked"].any(1)                     # (T, M)
    if kind == "early_stop":
        assert bool(walked[4, :16].any()) and not bool(walked[4, 16:].any())
    for fn in (CS.splat_backward_pose, CS.splat_backward_vals_rows,
               CS.splat_backward_all):
        got = fn(*d_args)
        again = fn(*d_args)
        assert torch.equal(got, again), f"{fn.__name__}: launches differ"
        ref = fn(*c_args)
        if fn is CS.splat_backward_pose:
            assert_close_scaled(got, ref, 1e-3, "pose partials")
            if kind == "ragged_counts":
                np.testing.assert_array_equal(np_(got)[0], 0.0)
            continue
        if fn is CS.splat_backward_all:
            got, ref = got.transpose(1, 2), ref.transpose(1, 2)
        else:
            np.testing.assert_array_equal(np_(got)[..., :3], 0.0)
        for col in range(8):
            assert_close_scaled(got[..., col], ref[..., col], 1e-3,
                                f"{fn.__name__} col {col}")
        np.testing.assert_array_equal(np_(got)[np_(~walked)], 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["track_cache", "ragged_counts", "early_stop",
                                  "no_box"])
def test_splat_forward_edge_cases_repeat_bitwise(card, kind):
    """K1 against its plain version on a tile with count 0, counts off the
    kernel's chunks, a tile whose pixels all stop within its first 16
    slots and a tile no cull box touches; a second launch on the same
    inputs gives the same bits."""
    cam = torch_cam()
    slots, counts, R9, t, _ = (_case("cpu", seed=0) if kind == "track_cache"
                               else _hand_case(kind))
    ref = CS.splat_forward(slots, R9, t, counts, cam, TILES_X)
    d = [x.to(card) for x in (slots, R9, t, counts)]
    got = CS.splat_forward(*d, cam, TILES_X)
    assert torch.equal(got, CS.splat_forward(*d, cam, TILES_X))
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-4, atol=1e-5)
    if kind == "ragged_counts":
        np.testing.assert_array_equal(np_(got)[0, :6], 0.0)
        np.testing.assert_array_equal(np_(got)[0, 6], 1.0)
    if kind == "early_stop":
        np.testing.assert_array_equal(np_(got)[4, 6], 0.0)      # all stopped
    if kind == "no_box":
        cp = CS.cp_vector(R9, t, cam)
        meets = CS.box_meets_blocks(CS.slot_box(slots, cp, TILES_X))
        assert not bool(meets[4].any()) and bool(meets[3].any())
        np.testing.assert_array_equal(np_(got)[4, :6], 0.0)
        np.testing.assert_array_equal(np_(got)[4, 6], 1.0)


@pytest.mark.cuda
def test_splat_blend_all_mode_matches_cpu_autograd(card):
    """splat_blend(grad_mode="all") on the card (K1 + K6 and the wrapper's
    dR / dt contraction) vs the same call on CPU tensors."""
    cam = torch_cam()
    grads = []
    for dev in ("cpu", card):
        slots, counts, R9, t, g = _case(dev, seed=5)
        xs = [x.clone().requires_grad_(True) for x in (slots, R9, t)]
        acc = CS.splat_blend(xs[0], xs[1], xs[2], counts, cam, TILES_X,
                             grad_mode="all")
        (acc * g).sum().backward()
        grads.append([x.grad for x in xs])
    for what, a, b in zip(("slots", "R", "t"), grads[1], grads[0]):
        if what == "slots":
            for row in range(8):
                assert_close_scaled(a[:, row], b[:, row], 1e-3, f"slots {row}")
        else:
            assert_close_scaled(a, b, 1e-3, what)


def _tile_id_case(how):
    """The track-cache case (9 tiles) with its rows rearranged: "tids", the
    rows permuted with their image tiles in the tile-id operand; "offset",
    rows 4-8 alone at tile_offset 4; both with 3 padded rows appended
    (count 0, tile 0, slots and cotangent rows of row 0), as tile-sharded
    caches pad. Returns (slots, counts, tids,
    offset, R9, t, g)."""
    slots, counts, R9, t, g = _case("cpu", seed=2)
    if how == "tids":
        perm = torch.as_tensor(np.random.default_rng(3).permutation(9))
        slots, counts, g = slots[perm], counts[perm], g[perm]
        tids, off = perm.to(torch.int32), 0
    else:
        slots, counts, g = slots[4:], counts[4:], g[4:]
        tids, off = None, 4
    pad = lambda x, fill: torch.cat([x, fill.expand(3, *x.shape[1:])])
    slots = pad(slots, slots[:1]).contiguous()
    counts = pad(counts, torch.zeros(1, dtype=torch.int32)).contiguous()
    g = pad(g, g[:1]).contiguous()
    if tids is not None:
        tids = pad(tids, torch.zeros(1, dtype=torch.int32)).contiguous()
    return slots, counts, tids, off, R9, t, g


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["tids", "offset"])
def test_splat_kernels_with_tile_ids_and_offset_match_plain(card, how):
    """K1, K2, K3 and K6 with the tile-id operand and a nonzero tile offset
    against their plain versions; the padded rows (count 0) give exact
    zeros under a nonzero cotangent, and K1's T_end 1 there."""
    cam = torch_cam()
    slots, counts, tids, off, R9, t, g = _tile_id_case(how)
    kw = dict(tile_ids=tids, tile_offset=off)
    dk = dict(tile_ids=None if tids is None else tids.to(card),
              tile_offset=off)
    d = [x.to(card) for x in (slots, R9, t, counts)]
    ref = CS.splat_forward(slots, R9, t, counts, cam, TILES_X, **kw)
    got = CS.splat_forward(*d, cam, TILES_X, **dk)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np_(got)[-3:, :6], 0.0)
    np.testing.assert_array_equal(np_(got)[-3:, 6], 1.0)
    out, gd = ref, g.to(card)
    for fn in (CS.splat_backward_pose, CS.splat_backward_vals_rows,
               CS.splat_backward_all):
        r = fn(slots, R9, t, counts, out, g, cam, TILES_X, **kw)
        k = fn(*d[:3], d[3], out.to(card), gd, cam, TILES_X, **dk)
        assert torch.equal(k, fn(*d[:3], d[3], out.to(card), gd, cam, TILES_X,
                                 **dk))
        np.testing.assert_array_equal(np_(k)[-3:], 0.0)
        assert bool(k[0].abs().sum() > 0)
        if fn is CS.splat_backward_pose:
            assert_close_scaled(k, r, 1e-3, "pose partials")
            continue
        if fn is CS.splat_backward_all:
            k, r = k.transpose(1, 2), r.transpose(1, 2)
        for col in range(8):
            assert_close_scaled(k[..., col], r[..., col], 1e-3,
                                f"{fn.__name__} col {col}")


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["tids", "offset"])
def test_blend_kernels_with_tile_ids_and_offset_match_plain(card, how):
    """K4 and K5 with the tile-id operand and a nonzero tile offset against
    their plain versions; a padded row (count 0) under a nonzero cotangent
    gives exact zeros."""
    recs, counts = _records(seed=8)
    if how == "tids":
        perm = torch.as_tensor(np.random.default_rng(4).permutation(9))
        recs, counts = recs[perm], counts[perm]
        tids, off = perm.to(torch.int32), 0
    else:
        recs, counts, tids, off = recs[4:], counts[4:], None, 4
    recs = torch.cat([recs, recs[:1]]).contiguous()
    counts = torch.cat([counts, torch.zeros(1, dtype=torch.int32)])
    if tids is not None:
        tids = torch.cat([tids, torch.zeros(1, dtype=torch.int32)])
    kw = dict(tile_ids=tids, tile_offset=off)
    dk = dict(tile_ids=None if tids is None else tids.to(card),
              tile_offset=off)
    ref = CB.blend_forward(recs, counts, TILES_X, 8, **kw)
    got = CB.blend_forward(recs.to(card), counts.to(card), TILES_X, 8, **dk)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-4, atol=1e-5)
    g = torch.as_tensor(np.random.default_rng(5).standard_normal(
        tuple(ref.shape)).astype(np.float32))
    g[-1] = g[0]
    r5 = CB.blend_backward(recs, counts, ref, g, TILES_X, **kw)
    k5 = CB.blend_backward(recs.to(card), counts.to(card), ref.to(card),
                           g.to(card), TILES_X, **dk)
    for col in range(16):
        assert_close_scaled(k5[..., col], r5[..., col], 1e-3, f"col {col}")
    np.testing.assert_array_equal(np_(k5)[-1], 0.0)
    assert bool(k5[0].abs().sum() > 0)


@pytest.mark.cuda
def test_blend_kernel_matches_plain(card):
    recs, counts = _records(seed=4)
    got = CB.blend_forward(recs.to(card), counts.to(card), TILES_X, 8)
    np.testing.assert_allclose(np_(got), np_(CB.blend_forward(recs, counts,
                                                              TILES_X, 8)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse", "clamped_and_stopped"])
def test_blend_backward_kernel_matches_plain(card, kind):
    """K5 on the card vs its plain version: full and sparse counts, clamped
    alpha and tiles whose every pixel stops before the count; exact zeros
    on the records no pixel walked."""
    kw = dict(dense=dict(seed=5), sparse=dict(seed=6, mpt=256),
              clamped_and_stopped=dict(seed=7, op_hi=1.0, conic=(0.005, 0.05))
              )[kind]
    recs, counts = _records(**kw)
    if kind == "sparse":
        counts = torch.clamp(counts, max=20)
    out = CB.blend_forward(recs, counts, TILES_X, 8)
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(out.shape)).astype(np.float32))
    ref = CB.blend_backward(recs, counts, out, g, TILES_X)
    n5 = CB.blend_backward.launches
    got = CB.blend_backward(recs.to(card), counts.to(card), out.to(card),
                            g.to(card), TILES_X)
    assert CB.blend_backward.launches == n5 + 1
    assert got.shape == ref.shape
    for col in range(16):
        assert_close_scaled(got[..., col], ref[..., col], 1e-3, f"col {col}")
    walked = CB._blend_walk(recs, counts, TILES_X,
                            torch.arange(recs.shape[0]))["walked"].any(1)
    np.testing.assert_array_equal(np_(got)[np_(~walked)], 0.0)
    assert bool((~walked).any())


def _hand_records(kind):
    """The 9 test tiles, 128 random records each. "ragged_counts": counts 0
    and others off K5's 16-record sub-chunk and 32-record chunk;
    "ragged_chunks": 640 faint records per tile (no pixel stops) and
    counts 0 and others either side of K4's 256-record chunks, so its ring
    of stages goes round; "early_stop": the centre tile starts with 8 wide,
    nearly opaque records, so all its pixels stop within the first
    sub-chunk; "no_box": the centre tile's records are too faint (opacity
    below 1/255) or too far away for any cull box to touch it;
    "det_nonpositive": the centre tile's conics have det = 0 or det < 0, so
    their box is the whole tile."""
    mpt = 640 if kind == "ragged_chunks" else 128
    recs, counts = _records(seed=21, mpt=mpt)
    recs, counts = recs.clone(), torch.full_like(counts, mpt)
    rng = np.random.default_rng(22)
    recs[:, 0] = torch.as_tensor(rng.uniform(-2, 18, (9, mpt)).astype(
        np.float32)) + 16.0 * (torch.arange(9) % TILES_X)[:, None]
    recs[:, 1] = torch.as_tensor(rng.uniform(-2, 18, (9, mpt)).astype(
        np.float32)) + 16.0 * (torch.arange(9) // TILES_X)[:, None]
    recs[:, 2] = recs[:, 4] = 0.2
    recs[:, 3] = 0.05
    recs[:, 5] = torch.as_tensor(rng.uniform(0.1, 0.9, (9, mpt)).astype(
        np.float32))
    recs[:, 6:14] = torch.as_tensor(rng.uniform(0, 1, (9, 8, mpt)).astype(
        np.float32))
    if kind == "ragged_counts":
        counts[:] = torch.tensor([0, 1, 15, 17, 33, 63, 65, 100, 128])
    elif kind == "ragged_chunks":
        recs[:, 5] *= 0.1
        counts[:] = torch.tensor([0, 1, 255, 257, 300, 511, 513, 600, 640])
    elif kind == "early_stop":
        recs[4, 2:5, :8] = torch.tensor([1e-3, 0.0, 1e-3])[:, None]
        recs[4, 5, :8] = 0.95
    elif kind == "det_nonpositive":
        recs[4, 3, 0::2] = 0.2
        recs[4, 3, 1::2] = -0.4
    else:
        recs[4, 5, 0::2] = 0.0039
        recs[4, 0, 1::2] += 300.0
    return recs, counts


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 8])
@pytest.mark.parametrize("kind", ["ragged_counts", "ragged_chunks",
                                  "early_stop", "no_box", "det_nonpositive"])
def test_blend_forward_edge_cases_repeat_bitwise(card, kind, C):
    """K4 with 3 and 8 channels against its plain version on a tile with
    count 0, counts off the kernel's chunks and groups, a tile whose pixels
    all stop within its first 16 records, a tile no cull box touches and a
    tile of det <= 0 conics (whole-tile boxes); a second launch on the same
    inputs gives the same bits."""
    recs, counts = _hand_records(kind)
    ref = CB.blend_forward(recs, counts, TILES_X, C)
    d = [x.to(card) for x in (recs, counts)]
    n4 = CB.blend_forward.launches
    got = CB.blend_forward(*d, TILES_X, C)
    assert CB.blend_forward.launches == n4 + 1
    assert torch.equal(got, CB.blend_forward(*d, TILES_X, C))
    assert got.shape == ref.shape == (9, 256, C)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-4, atol=1e-5)
    w = CB._blend_walk(recs, counts, TILES_X, torch.arange(9))
    box = CB.record_box(recs, TILES_X)
    meets = CS.box_meets_blocks(box)
    if kind in ("ragged_counts", "ragged_chunks"):
        np.testing.assert_array_equal(np_(got)[0], 0.0)         # count 0
    if kind == "ragged_chunks":
        assert bool(w["walked"][8, :, 512:].any())    # the third chunk is walked
    if kind == "early_stop":
        walked = w["walked"].any(1)
        assert bool(walked[4, :16].any()) and not bool(walked[4, 16:].any())
    if kind == "no_box":
        assert not bool(meets[4].any()) and bool(meets[3].any())
        np.testing.assert_array_equal(np_(got)[4], 0.0)
    if kind == "det_nonpositive":
        det = recs[4, 2] * recs[4, 4] - recs[4, 3] ** 2
        assert bool((det <= 0).all()) and bool((det == 0).any())
        assert bool((box[4] == torch.tensor(CS.WHOLE_BOX)).all())
        assert bool(w["keep"][4].any())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 8])
@pytest.mark.parametrize("kind", ["ragged_counts", "early_stop", "no_box"])
def test_blend_backward_edge_cases_repeat_bitwise(card, kind, C):
    """K5 with 3 and 8 channels against its plain version on a tile with
    count 0, counts off the kernel's chunks, a tile whose pixels all stop
    within its first sub-chunk and a tile no cull box touches; a second
    launch gives the same bits; records no pixel walked, or every warp's
    box skipped, get exact zeros in all 16 columns."""
    recs, counts = _hand_records(kind)
    out = CB.blend_forward(recs, counts, TILES_X, C)
    g = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(out.shape)).astype(np.float32))
    ref = CB.blend_backward(recs, counts, out, g, TILES_X)
    d = [x.to(card) for x in (recs, counts, out, g)]
    got = CB.blend_backward(*d, TILES_X)
    assert torch.equal(got, CB.blend_backward(*d, TILES_X))
    assert got.shape == ref.shape == (9, 128, 16)
    for col in range(6 + C):
        assert_close_scaled(got[..., col], ref[..., col], 1e-3, f"col {col}")
    np.testing.assert_array_equal(np_(got)[..., 6 + C:], 0.0)
    w = CB._blend_walk(recs, counts, TILES_X, torch.arange(9))
    walked = w["walked"].any(1)
    np.testing.assert_array_equal(np_(got)[np_(~walked)], 0.0)
    meets = CS.box_meets_blocks(CB.record_box(recs, TILES_X)).any(1)
    np.testing.assert_array_equal(np_(got)[np_(~meets)], 0.0)
    if kind == "ragged_counts":
        np.testing.assert_array_equal(np_(got)[0], 0.0)
    if kind == "early_stop":
        assert bool(walked[4, :16].any()) and not bool(walked[4, 16:].any())
    if kind == "no_box":
        assert not bool(meets[4].any()) and bool(walked[4].all())
        np.testing.assert_array_equal(np_(got)[4], 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("aniso", [False, True])
def test_render_slam_gradients_on_card_match_cpu(card, aniso):
    """The generic route's differentiable render (K4, K5 and the inverse
    map, autograd through the projection) on the card vs on the CPU."""
    from vtgaussian_slam_tpu_torch.core import losses as TL
    n = 600
    p = scene_np(n, 9)
    if aniso:
        rng = np.random.default_rng(10)
        p["log_scales"] = (np.repeat(p["log_scales"], 3, 1) + rng.uniform(
            -0.3, 0.3, (n, 3))).astype(np.float32)
        p["unnorm_rotations"] = rng.standard_normal((n, 4)).astype(np.float32)
    G = torch.as_tensor(np.random.default_rng(11).standard_normal(
        (6, 40, 48)).astype(np.float32))
    grads = []
    for dev in ("cpu", card):
        prm = torch_params(p)
        prm = type(prm)(*[x.to(dev).requires_grad_(True)
                          for x in prm.tensors()])
        q = torch.as_tensor(POSE_Q).to(dev).requires_grad_(True)
        t = torch.as_tensor(POSE_T).to(dev).requires_grad_(True)
        r = TL.render_slam(prm, torch.ones(n, dtype=torch.bool, device=dev),
                           q, t, torch_cam(),
                           dict(span_cap=3, max_pairs_per_tile=256, chunk=128))
        img = torch.cat([r.im, r.depth, r.silhouette[None], r.depth_sq])
        (img * G.to(dev)).sum().backward()
        grads.append([x.grad for x in prm.tensors()] + [q.grad, t.grad])
    for i, (a, b) in enumerate(zip(grads[1], grads[0])):
        if b is None:
            assert a is None
            continue
        assert_close_scaled(a, b, 1e-3, f"grad {i}")


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(card):
    slots, counts, R9, t, g = _case(card)
    cam = torch_cam()
    with pytest.raises(ValueError):
        CS.splat_forward(slots.double(), R9, t, counts, cam, TILES_X)
    with pytest.raises(ValueError):
        CS.splat_forward(slots, R9, t, counts.long(), cam, TILES_X)
    with pytest.raises(ValueError):
        CS.splat_forward(slots.transpose(1, 2).contiguous().transpose(1, 2),
                         R9, t, counts, cam, TILES_X)
    recs, rc = _records()
    with pytest.raises(ValueError):
        CB.blend_forward(recs.to(card), rc.to(card), TILES_X, 9)


def _paging_engine(device, n_sections=3, n=5000):
    """The engine's paging state and methods around a few sections, without
    a dataset: the methods under test are the engine's own."""
    from vtgaussian_slam_tpu_torch.core.pipeline import (STAT_TOTALS,
                                                          VTGaussianSLAM)
    from vtgaussian_slam_tpu_torch.models import gaussians as G
    from vtgaussian_slam_tpu_torch.utils.observability import Trace
    eng = object.__new__(VTGaussianSLAM)
    eng.device = torch.device(device)
    eng.section_paging = True
    eng._page_pending, eng._paged = {}, {}
    eng._page_stream = (torch.cuda.Stream(eng.device)
                        if eng.device.type == "cuda" else None)
    eng.stats = {k: 0 for k in ("t_page", "t_page_in", "t_page_fin",
                                "section_page_ins", "section_prefetched_ins",
                                "section_page_outs")}
    eng.trace = Trace(eng.stats, STAT_TOTALS)
    eng.sections = [G.section_from_numpy_params(scene_np(n, 40 + i),
                                                quantum=1024,
                                                device=device)[0]
                    for i in range(n_sections)]
    return eng


def _section_bits(sec):
    from vtgaussian_slam_tpu_torch.models import gaussians as G
    return [x.detach().cpu().clone() for x in G.section_tensors(sec)]


def test_paging_bookkeeping_on_the_cpu():
    """On a CPU engine nothing moves, but the cold lists and counters run."""
    eng = _paging_engine("cpu")
    before = [x.data_ptr() for x in eng.sections[1].params.tensors()]
    eng._page_cold_sections({0})
    assert sorted(eng._page_pending) == [1, 2] and eng.paged_sections() == []
    eng._page_cold_finish(hot={2})          # 2 became hot again: stays
    assert eng.paged_sections() == [1]
    assert eng.stats["section_page_outs"] == 1
    sec = eng._sec(1)
    assert eng.paged_sections() == [] and eng.stats["section_page_ins"] == 1
    assert [x.data_ptr() for x in sec.params.tensors()] == before


@pytest.mark.cuda
def test_paging_round_trip_is_bit_exact(card):
    """A page-out copies on the side stream behind the compute stream's
    work; reading the pinned host copy must wait for it, and the device
    memory it copies from must not be handed out again before it lands."""
    from vtgaussian_slam_tpu_torch.models import gaussians as G
    eng = _paging_engine(card, n=200_000)
    want = _section_bits(eng.sections[1])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of compute-stream work
    eng._page_cold_sections({0, 2})
    eng._page_cold_finish()
    assert eng.paged_sections() == [1]
    host = eng.sections[1]
    assert all(x.device.type == "cpu" and x.is_pinned()
               for x in G.section_tensors(host))
    event = eng._paged[1]
    assert not event.query(), "the copy ended before the check could race it"
    # allocations on the compute stream while the copy waits: the freed
    # device blocks of section 1 must not be reused under the copy
    junk = [torch.full(x.shape, 7.0, device=card) for x in want
            for _ in range(2)]
    got = _section_bits(eng.host_section(1))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    del junk
    back = eng._sec(1)
    assert eng.paged_sections() == [] and eng.stats["section_page_ins"] == 1
    assert all(x.device.type == "cuda" for x in G.section_tensors(back))
    for a, b in zip(_section_bits(back), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mpt", [128, 384, 1024, 2048])
def test_global_cache_kernels_match_plain(card, mpt):
    """K1 and K3 on a global binning ([frozen prefix; trainable section])
    at the pair-budget widths the ladder gives, against their plain
    versions on the same slots (rtol 1e-4 / atol 1e-5 forward, 1e-3 of the
    largest entry for the rows); the render's gradient reaches the
    trainable rows only."""
    from vtgaussian_slam_tpu_torch.core import map_cache as TMC
    from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import \
        gather_channels
    cam = torch_cam()
    fixed, prm = torch_params(scene_np(1500, 50)), torch_params(scene_np(
        2000, 51))
    d = lambda p: type(p)(*[x.to(card) for x in p.tensors()])
    q, t = torch.as_tensor(POSE_Q).to(card), torch.as_tensor(POSE_T).to(card)
    gc = TMC.build_global_cache(
        d(fixed), torch.ones(1500, dtype=torch.bool, device=card), d(prm),
        torch.ones(2000, dtype=torch.bool, device=card), q, t, cam,
        span_cap=2, max_pairs_per_tile=mpt, select="importance")
    assert gc.tab.shape[1] == mpt
    f8 = TMC.pack_fields8(d(prm))
    slots = gather_channels(torch.cat([gc.fixed_fields8, f8]), gc.tab)
    R9 = geo.quat_to_rotmat(geo.normalize(q)).reshape(9)
    n1 = CS.splat_forward.launches
    out = CS.splat_forward(slots, R9, t, gc.counts, cam, TILES_X)
    assert CS.splat_forward.launches == n1 + 1
    cp = CS.cp_vector(R9.cpu(), t.cpu(), cam)
    ref = CS.splat_forward_plain(slots.cpu(), gc.counts.cpu(), cp, TILES_X)
    np.testing.assert_allclose(np_(out), np_(ref), rtol=1e-4, atol=1e-5)
    g = torch.as_tensor(np.random.default_rng(mpt).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(card)
    rows = CS.splat_backward_vals_rows(slots, R9, t, gc.counts, out, g, cam,
                                       TILES_X)
    ref_rows = CS.splat_backward_vals_rows_plain(
        slots.cpu(), gc.counts.cpu(), cp, TILES_X, out.cpu(), g.cpu())
    for col in range(3, 8):
        assert_close_scaled(rows[..., col], ref_rows[..., col], 1e-3,
                            f"col {col}")
    v8 = f8.detach().clone().requires_grad_(True)
    r = TMC.render_binned_global(v8, gc, cam)
    (r.im ** 2).sum().backward()
    assert v8.grad.shape == f8.shape and bool(v8.grad[:, 3:].abs().max() > 0)
    assert gc.fixed_fields8.grad is None


def _deep_records(mpt, seed, n_tiles=9):
    """Depth-ordered records that keep the pixels open deep into the list:
    opacities just above the 1/255 alpha cut, so a record blends only near
    its centre and the transmittance falls slowly; tile 0 holds mpt
    records, the others fewer, one a count off every chunk."""
    rng = np.random.default_rng(seed)
    recs = np.zeros((n_tiles, 16, mpt), np.float32)
    counts = rng.integers(mpt // 2, mpt + 1, n_tiles).astype(np.int32)
    counts[0], counts[1] = mpt, mpt - 37
    for t in range(n_tiles):
        ty, tx = divmod(t, TILES_X)
        k = counts[t]
        recs[t, 0, :k] = tx * 16 + rng.uniform(-2, 18, k)
        recs[t, 1, :k] = ty * 16 + rng.uniform(-2, 18, k)
        recs[t, 2, :k] = recs[t, 4, :k] = rng.uniform(0.1, 0.6, k)
        recs[t, 5, :k] = rng.uniform(0.004, 0.012, k)
        recs[t, 6:14, :k] = rng.uniform(0, 1, (8, k))
    return torch.as_tensor(recs), torch.as_tensor(counts)


def _scaled_errors(got, ref):
    """|got - ref| over each channel's largest |ref|: (max, 99.9th pct)."""
    got, ref = got.double().reshape(-1, got.shape[-1]), ref.double().reshape(
        -1, ref.shape[-1])
    scaled = ((got - ref).abs() / ref.abs().amax(0).clamp(min=1e-30)).reshape(
        -1)
    return scaled.max().item(), torch.quantile(scaled, 0.999).item()


@pytest.mark.cuda
@pytest.mark.parametrize("mpt", [2048, 16384])
def test_blend_forward_at_eval_budgets(card, mpt):
    """K4 at the pair budgets evaluation renders use (eval_pair_budget:
    2048 at 680x1200, up to 16384 on small frames) against its plain
    version on the card: errors scaled by each channel's largest value,
    99.9% within 3e-4 and all within 2e-2 (chip_smoke's tolerances: the
    plain version's transmittance is a cumprod over up to mpt factors, and
    a pair at a threshold can be kept by one side and dropped by the
    other); the walk reaches past half the list; a second launch gives the
    same bits."""
    recs, counts = (x.to(card) for x in _deep_records(mpt, mpt))
    n4 = CB.blend_forward.launches
    got = CB.blend_forward(recs, counts, TILES_X, 8)
    assert CB.blend_forward.launches == n4 + 1
    assert torch.equal(got, CB.blend_forward(recs, counts, TILES_X, 8))
    ref = torch.cat([CB.blend_forward_plain(recs[i:i + 1], counts[i:i + 1],
                                            TILES_X, 8, torch.tensor([i],
                                                                     device=card))
                     for i in range(recs.shape[0])])
    err, p999 = _scaled_errors(got, ref)
    assert err <= 2e-2 and p999 <= 3e-4, (err, p999)
    w = CB._blend_walk(recs[:1], counts[:1], TILES_X,
                       torch.zeros(1, dtype=torch.long, device=card))
    assert bool(w["walked"][0, :, mpt // 2:].any())


@pytest.mark.cuda
def test_ms_ssim_and_lpips_on_card_match_cpu(card):
    """MS-SSIM (depthwise f32 convolutions, TF32 off) within 1e-5 relative;
    LPIPS within 1e-4 relative: cuDNN may pick another algorithm (Winograd,
    FFT, implicit GEMM) for the AlexNet convolutions than the CPU does,
    each rounding f32 sums of up to 3456 products differently."""
    from vtgaussian_slam_tpu_torch.eval.lpips import lpips_fn
    from vtgaussian_slam_tpu_torch.ops.ssim import ms_ssim
    rng = np.random.default_rng(0)
    for hw in ((48, 64), (240, 320), (680, 1200)):
        a = rng.uniform(0, 1, (3,) + hw).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
        ta, tb = torch.as_tensor(a), torch.as_tensor(b)
        want = float(ms_ssim(ta, tb))
        got = float(ms_ssim(ta.to(card), tb.to(card)))
        assert abs(got - want) <= 1e-5 * abs(want), (hw, got, want)
        want = lpips_fn(device="cpu")(a, b)
        got = lpips_fn(device=card)(a, b)
        assert abs(got - want) <= 1e-4 * abs(want), (hw, got, want)


@pytest.mark.cuda
def test_smoke_cli_on_card(card, tmp_path, capsys):
    """The CLI's contract on the card: 3 smoke frames through the kernels
    (K1-K3 in the loops, K4 in densify and every eval render), the config
    copy, params_ls.npy and eval/."""
    import os
    from vtgaussian_slam_tpu_torch.__main__ import main
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wrappers = (CS.splat_forward, CS.splat_backward_pose,
                CS.splat_backward_vals_rows, CB.blend_forward)
    before = [w.launches for w in wrappers]
    assert main([os.path.join(repo, "configs", "synthetic", "smoke.py"),
                 "--device", "cuda", "--frames", "3", "--set",
                 f"workdir={tmp_path}"]) == 0
    assert all(w.launches > b for w, b in zip(wrappers, before))
    out = capsys.readouterr().out
    assert "Final Average ATE RMSE" in out
    rdir = tmp_path / "smoke_3"
    assert (rdir / "config.py").exists()
    params_ls = np.load(rdir / "params_ls.npy", allow_pickle=True)
    assert len(params_ls) == 1 and params_ls[0]["cam_trans"].shape == (1, 3, 3)
    psnr = np.loadtxt(rdir / "eval" / "psnr.txt")
    assert psnr.shape == (3,) and (psnr > 20).all(), psnr
    for k in ("rmse", "l1", "ssim", "lpips"):
        assert np.isfinite(np.loadtxt(rdir / "eval" / f"{k}.txt")).all(), k
    for sub in ("rendered_rgb", "rendered_depth", "rgb", "depth"):
        assert len(os.listdir(rdir / "eval" / sub)) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["point_to_plane", "hybrid"])
def test_odometry_on_card_matches_cpu(card, method):
    """The visual odometer's relative pose on the card within 1e-4 of the
    CPU's (float32 6x6 solves in another rounding)."""
    from vtgaussian_slam_tpu_torch.core.odometry import VisualOdometer
    from vtgaussian_slam_tpu_torch.datasets.synthetic import \
        SyntheticRoomDataset
    ds = SyntheticRoomDataset(num_frames=30, height=96, width=128, seed=2,
                              motion_scale=0.3)
    c0, d0, K, _ = ds[0]
    c1, d1, _, _ = ds[1]
    rel = {}
    for dev in ("cpu", card):
        odo = VisualOdometer(K[:3, :3], method_name=method, device=dev)
        odo.update_last_rgbd(c0, d0)
        rel[str(dev)] = odo.estimate_rel_pose(c1, d1)
    np.testing.assert_allclose(rel["cuda"], rel["cpu"], atol=1e-4, rtol=0)


def _mesh_views(n=3, H=48, W=64, seed=0):
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:H, 0:W]
        depth = (2.0 + 0.1 * np.sin(xx / 7.0 + i)
                 + rng.normal(0, 0.003, (H, W))).astype(np.float32)
        color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        w2c = np.eye(4)
        w2c[:3, 3] = [0.03 * i, -0.02 * i, 0.01 * i]
        out.append((color, depth, K, w2c))
    return out


@pytest.mark.cuda
def test_tsdf_integrate_and_extract_on_card_match_cpu(card):
    """The TSDF integrate on the card against the CPU's: weights equal on
    all but 1e-4 of the voxels (a voxel within an ulp of a cut), tsdf within
    two float32 ulps of the largest depth over sdf_trunc where the weights
    agree (the card may fuse the voxel coordinate's multiply-add), colours
    within 1e-6; the mesh of the card's volume, extracted on the card and
    on the CPU, with identical faces."""
    from vtgaussian_slam_tpu_torch.eval.mesh import TSDFVolume, marching_cubes
    vols = {}
    for dev in ("cpu", card):
        v = TSDFVolume([-1.6, -1.2, 1.6], [1.6, 1.2, 2.5], voxel_length=0.03,
                       sdf_trunc=0.09, device=dev, slab_voxels=25000)
        for view in _mesh_views():
            v.integrate(*view)
        vols[str(dev)] = v
    c, g = vols["cpu"], vols["cuda"]
    same_w = g.weight.cpu() == c.weight
    assert same_w.float().mean() >= 1 - 1e-4
    atol = 2 * float(np.spacing(np.float32(2.2))) / 0.09
    assert (g.tsdf.cpu() - c.tsdf)[same_w].abs().max() <= atol
    assert (g.color.cpu() - c.color)[same_w].abs().max() <= 1e-6
    tsdf = torch.where(g.weight > 0, g.tsdf, torch.full_like(g.tsdf, np.nan))
    vg, fg = marching_cubes(tsdf)
    vc, fc = marching_cubes(tsdf.cpu())
    assert len(fg) > 500
    np.testing.assert_array_equal(fg, fc)
    np.testing.assert_allclose(vg, vc, atol=1e-12, rtol=0)


@pytest.mark.cuda
def test_mesh_depth_zbuffer_on_card_matches_cpu(card):
    """render_mesh_depth on the card within 1e-5 of the CPU's on a
    subdivided slanted quad over a far one (scatter-min is order-free)."""
    from vtgaussian_slam_tpu_torch.eval.mesh import (render_mesh_depth,
                                                     subdivide_to_edge)
    v = np.array([[-0.2, -0.2, 1.8], [0.2, -0.2, 2.2], [0.2, 0.2, 2.2],
                  [-0.2, 0.2, 1.8], [-0.5, -0.5, 3.0], [0.5, -0.5, 3.0],
                  [0.5, 0.5, 3.0], [-0.5, 0.5, 3.0]])
    f = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]])
    v, f = subdivide_to_edge(v, f, 0.05)
    K = torch.tensor([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    out = {}
    for dev in ("cpu", card):
        out[str(dev)] = render_mesh_depth(
            torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev),
            torch.eye(4, device=dev), K.to(dev), 48, 64, chunk=64).cpu()
    assert (out["cpu"] > 0).sum() > 400       # both quads' pixels
    assert torch.equal(out["cuda"] > 0, out["cpu"] > 0)
    assert (out["cuda"] - out["cpu"]).abs().max() <= 1e-5
