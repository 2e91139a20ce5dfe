"""What K1 and K5 do only on the card, rehearsed on the CPU.

The redesigned splat forward (K1, csrc/splat.cu) and blend backward (K5,
csrc/blend.cu) cull (8 x 4 pixel block, slot) steps with a per-slot box,
blend four slots at a time with selects, and K5 takes its per-record pixel
sums as split TF32 tensor-core products. The kernels run only on the card;
the mirrors beside the plain versions repeat their arithmetic in PyTorch:

  (a) box cover: `cuda_splat.slot_box` and `cuda_blend.record_box` contain
      every pixel of every pair the plain walk keeps (so a culled step
      drops nothing), and do cull (so the test is not vacuous);
  (b) K5 mirror: `cuda_blend.backward_sums_tf32` within 1e-5 of each sum's
      largest |value| of the direct sums (the split leaves ~2^-22 of each
      product; the moment expansion cancels a few hundred times that), and
      its rows within 1e-3 of the largest entry of jax.vjp of the
      interpret-mode `blend_tiles` (the tolerance the plain K5 is held to
      in test_torch_generic.py), exact zeros on unwalked records;
  (c) grouped forward: `cuda_splat.splat_forward_grouped` (box cull, four
      slots per group, torch.where blends, the stop rule) within 1e-6 of
      each channel's largest value of `splat_forward_plain` (the same f32
      products; the plain version's cumprod associates differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import _hand_case
from test_torch_splat_moments import CASES as SLOT_CASES
from torch_port_util import (N_TILES, TILES_X, assert_close_scaled, k5_records,
                             np_, slots_at, torch_cam)
from vtgaussian_slam_tpu.ops.rasterizer.pallas_blend import blend_tiles
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS

ALPHA_MIN = np.float32(1.0 / 255.0)
EYE9 = torch.eye(3).reshape(9)
ZERO3 = torch.zeros(3)


def _logit(p):
    p = np.asarray(p, np.float64)
    return np.log(p / (1.0 - p))


def _slot_thresholds():
    """The centre tile: opacities a few ulps and a few per cent either side
    of 1/255 and of 0.99, each at three widths, every other mean on a
    pixel centre (so alpha reaches the opacity itself there)."""
    ops = np.concatenate([float(ALPHA_MIN) * (1 + np.array(
        [-1e-2, -1e-6, -1e-7, 0.0, 1e-7, 1e-6, 1e-2, 0.3])),
        0.99 * (1 + np.array([-1e-2, -1e-6, 0.0, 1e-6, 5e-3]))])
    sig = np.array([0.6, 2.0, 7.0])
    op = np.tile(ops, len(sig))
    n = len(op)
    rng = np.random.default_rng(2)
    px, py = 16 + rng.uniform(-3, 19, n), 16 + rng.uniform(-3, 19, n)
    px[::2], py[::2] = np.round(px[::2]), np.round(py[::2])
    rows = slots_at(px, py, np.sort(rng.uniform(1.5, 3.5, n)),
                    np.repeat(sig, len(ops)), _logit(op), (0.2, 0.5, 0.8))
    slots = torch.as_tensor(rows[None].copy())
    counts = torch.tensor([n], dtype=torch.int32)
    return slots, counts, CS.cp_vector(EYE9, ZERO3, torch_cam()), TILES_X, \
        torch.tensor([4]), 16


def _slot_case(name):
    if name == "opacity_thresholds":
        return _slot_thresholds()[:5]
    if name in ("ragged_counts", "early_stop"):
        slots, counts, R9, t, _ = _hand_case(name)
        return slots, counts, CS.cp_vector(R9, t, torch_cam()), TILES_X, None
    return SLOT_CASES[name]()[:5]


def _pixels_in_box(box):
    """(T, M, 4) tile-local boxes -> (T, 256, M): is the pixel inside?"""
    lin = torch.arange(CS.TPX)
    lx = (lin % 16).float()[None, :, None]
    ly = (lin // 16).float()[None, :, None]
    b = box[:, None]
    return ((b[..., 0] <= lx) & (lx <= b[..., 1])
            & (b[..., 2] <= ly) & (ly <= b[..., 3]))


def _assert_cover(kept, box):
    """Every kept (pixel, slot) pair lies in the slot's box, and every
    (block, slot) step with a kept pair passes the kernels' block test."""
    assert bool(kept.any())
    assert not bool((kept & ~_pixels_in_box(box)).any())
    kept_b = CS.block_pixels(kept).any(2)
    assert not bool((kept_b & ~CS.box_meets_blocks(box)).any())


# ---- (a) box cover ---------------------------------------------------------
@pytest.mark.parametrize("name", ["smoke", "last_tile_row_680", "far_means",
                                  "opacity_thresholds", "early_stop"])
def test_slot_box_covers_kept_pairs(name):
    slots, counts, cp, tiles_x, ids = _slot_case(name)
    w = CS._walk(slots, counts, cp, tiles_x, ids)
    box = CS.slot_box(slots, cp, tiles_x, ids)
    _assert_cover(w["keep"], box)
    if name == "opacity_thresholds":
        op = w["q"]["op"][0]
        below, above = op < ALPHA_MIN, op >= ALPHA_MIN
        assert bool(below.any()) and bool(above.any())
        assert bool((w["clamped"] & w["keep"]).any())
        assert bool((box[0, below, 0] > box[0, below, 1]).all())    # empty
        assert not bool(w["keep"][0][:, below].any())


def _random_records(seed=0):
    recs, counts = k5_records(seed, 128)
    return torch.as_tensor(recs), torch.as_tensor(counts)


def _anisotropic_records(seed=1, mpt=96):
    """Records whose conic is the inverse of a rotated covariance with axes
    0.5-30 px (aspect up to 60:1, b != 0), as `projection.py`'s (N, 3)
    branch makes them, +0.3 dilation."""
    rng = np.random.default_rng(seed)
    recs = np.zeros((N_TILES, 16, mpt), np.float32)
    for t in range(N_TILES):
        ty, tx = divmod(t, TILES_X)
        th = rng.uniform(0, np.pi, mpt)
        s1, s2 = rng.uniform(2, 30, mpt) ** 2, rng.uniform(0.5, 2, mpt) ** 2
        c, s = np.cos(th), np.sin(th)
        v00 = c * c * s1 + s * s * s2 + 0.3
        v11 = s * s * s1 + c * c * s2 + 0.3
        v01 = c * s * (s1 - s2)
        det = v00 * v11 - v01 * v01
        recs[t, 0] = tx * 16 + rng.uniform(-20, 36, mpt)
        recs[t, 1] = ty * 16 + rng.uniform(-20, 36, mpt)
        recs[t, 2], recs[t, 3], recs[t, 4] = v11 / det, -v01 / det, v00 / det
        recs[t, 5] = rng.uniform(0.02, 0.9, mpt)
        recs[t, 6:14] = rng.uniform(0, 1, (8, mpt))
    counts = rng.integers(20, mpt + 1, N_TILES).astype(np.int32)
    return torch.as_tensor(recs), torch.as_tensor(counts)


def _det_nonpositive_records():
    """Conics with det = 0, just below 0 and well below 0 (b^2 >= ac):
    power <= 0 holds on an unbounded set, so the box must be the whole
    tile. Flat conics, so exp(power) stays finite where power > 0."""
    recs, counts = k5_records(4, 128, conic=(0.002, 0.02))
    recs = torch.as_tensor(recs).clone()
    a, c = recs[:, 2], recs[:, 4]
    recs[:, 3, 0::3] = (torch.sqrt(a * c) * (1 + 1e-6))[:, 0::3]
    recs[:, 3, 1::3] = -2.0 * torch.sqrt(a * c)[:, 1::3]
    recs[:, 2:5, 2::3] = 1.0 / 64                              # det = 0
    return recs, torch.as_tensor(counts)


def _record_thresholds():
    recs, counts = _random_records(6)
    recs = recs.clone()
    one = np.float32(1.0)
    cut = np.array([np.nextafter(ALPHA_MIN, 0, dtype=np.float32), ALPHA_MIN,
                    np.nextafter(ALPHA_MIN, one, dtype=np.float32),
                    np.float32(0.99), np.nextafter(np.float32(0.99), one),
                    np.float32(0.0), one, np.float32(0.0039)], np.float32)
    recs[:, 5] = torch.as_tensor(np.resize(cut, recs.shape[2]))[None]
    return recs, counts


RECORD_CASES = {"random": _random_records, "anisotropic": _anisotropic_records,
                "det_nonpositive": _det_nonpositive_records,
                "opacity_thresholds": _record_thresholds}


@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_record_box_covers_kept_pairs(name):
    recs, counts = RECORD_CASES[name]()
    w = CB._blend_walk(recs, counts, TILES_X, torch.arange(recs.shape[0]))
    box = CB.record_box(recs, TILES_X)
    _assert_cover(w["keep"], box)
    if name == "det_nonpositive":
        det = recs[:, 2] * recs[:, 4] - recs[:, 3] ** 2
        assert bool((det <= 0).all()) and bool((det == 0).any())
        whole = torch.tensor(CS.WHOLE_BOX)
        assert bool((box[recs[:, 5] >= ALPHA_MIN] == whole).all())
    if name == "anisotropic":
        assert float((recs[:, 3].abs() / torch.sqrt(recs[:, 2] * recs[:, 4])
                      ).max()) > 0.99
    if name == "opacity_thresholds":
        below = recs[:, 5] < ALPHA_MIN
        assert bool((box[below][:, 0] > box[below][:, 1]).all())    # empty
        assert bool((w["clamped"] & w["keep"]).any())


def test_boxes_cull_most_block_steps_of_the_smoke_case():
    """Not vacuous: on the 600-Gaussian case the boxes drop more than half
    of the (8 x 4 block, slot) steps in count, and keep every one in which
    a lane blends."""
    slots, counts, cp, tiles_x, ids = _slot_case("smoke")
    w = CS._walk(slots, counts, cp, tiles_x, ids)
    meets = CS.box_meets_blocks(CS.slot_box(slots, cp, tiles_x, ids))
    in_count = torch.arange(slots.shape[2])[None, None] < counts[:, None, None]
    steps = in_count.expand_as(meets)
    assert int((meets & steps).sum()) < 0.5 * int(steps.sum())
    blended_b = CS.block_pixels(w["keep"] & w["include"]).any(2)
    assert not bool((blended_b & ~meets).any())
    recs, rcounts = _random_records()
    rmeets = CS.box_meets_blocks(CB.record_box(recs, TILES_X))
    assert int(rmeets.sum()) < 0.5 * rmeets.numel()


def test_block_pixels_is_the_kernels_warp_layout():
    lin = torch.arange(256)[None]
    b = CS.block_pixels(lin)                                    # (1, 8, 32)
    for warp in range(8):
        for lane in (0, 7, 8, 31):
            x = 8 * (warp & 1) + (lane & 7)
            y = 4 * (warp >> 1) + (lane >> 3)
            assert int(b[0, warp, lane]) == y * 16 + x


# ---- (b) the K5 mirror -----------------------------------------------------
def _k5_inputs(recs, counts, seed=1):
    out = CB.blend_forward_plain(recs, counts, TILES_X, 8)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        tuple(out.shape)).astype(np.float32))
    return recs, counts, out, g, TILES_X


@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_k5_moment_sums_match_direct_sums(name):
    args = _k5_inputs(*RECORD_CASES[name]())
    ids = torch.arange(args[0].shape[0])
    ref = CB._backward_sums(*args, ids)
    got = CB.backward_sums_tf32(*args)
    for k, r in ref.items():
        scale = max(float(r.abs().max()), 1e-30)
        err = float((got[k] - r).abs().max()) / scale
        assert err <= 1e-5, (k, err)
    rows = CB.blend_backward_plain(*args, sums=got)
    unwalked = ~CB._blend_walk(args[0], args[1], TILES_X, ids)["walked"].any(1)
    assert bool(unwalked.any())
    np.testing.assert_array_equal(np_(rows)[np_(unwalked)], 0.0)


@pytest.mark.parametrize("case", [
    dict(seed=0, count_hi=128),             # full counts
    # clamped pairs, and tiles whose every pixel stops before the count
    dict(seed=5, count_hi=128, op=(0.6, 1.0), conic=(0.005, 0.05)),
])
def test_k5_mirror_rows_match_pallas_vjp(case):
    recs, counts = k5_records(**case)
    f = lambda r: blend_tiles(r, jnp.asarray(counts), TILES_X, 128, 8, True)
    out, vjp = jax.vjp(f, jnp.asarray(recs))
    g = np.random.default_rng(case["seed"] + 1).standard_normal(
        out.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref).transpose(0, 2, 1)                    # (T, mpt, 16)
    args = (torch.as_tensor(recs), torch.as_tensor(counts),
            torch.as_tensor(np.asarray(out).copy()), torch.as_tensor(g),
            TILES_X)
    got = np_(CB.blend_backward_plain(
        *args, sums=CB.backward_sums_tf32(*args)))
    for c in range(14):
        assert_close_scaled(got[..., c], ref[..., c], 1e-3, f"row {c}")
    w = CB._blend_walk(args[0], args[1], TILES_X, torch.arange(N_TILES))
    unwalked = ~np_(w["walked"].any(1))
    assert unwalked.any()
    np.testing.assert_array_equal(got[unwalked], 0.0)
    np.testing.assert_array_equal(got[..., 14:], 0.0)


# ---- (c) the grouped-select forward ----------------------------------------
@pytest.mark.parametrize("name", ["smoke", "last_tile_row_680", "far_means",
                                  "opacity_thresholds", "ragged_counts",
                                  "early_stop"])
def test_grouped_forward_matches_plain(name):
    slots, counts, cp, tiles_x, ids = _slot_case(name)
    ref = CS.splat_forward_plain(slots, counts, cp, tiles_x, ids)
    got = CS.splat_forward_grouped(slots, counts, cp, tiles_x, ids)
    assert got.shape == ref.shape
    for ch in range(8):
        assert_close_scaled(got[:, ch], ref[:, ch], 1e-6, f"channel {ch}")
    # channel 6: 0 on a stopped pixel, else the final transmittance
    stopped = CS._walk(slots, counts, cp, tiles_x, ids)["T_after"][..., -1] \
        < CS.T_TERMINATE
    np.testing.assert_array_equal(np_(got[:, 6])[np_(stopped)], 0.0)
    if name == "ragged_counts":
        np.testing.assert_array_equal(np_(got[0, :6]), 0.0)     # count 0
        np.testing.assert_array_equal(np_(got[0, 6]), 1.0)


def test_grouped_forward_stops_inside_a_group():
    """A pixel whose stop falls on the first to third slot of a group of
    four, with a kept slot after it in the same group: the selects must
    blend neither the stopping slot nor the one after it."""
    slots, counts, cp, tiles_x, ids = _slot_case("early_stop")
    w = CS._walk(slots, counts, cp, tiles_x, ids)
    stop = w["keep"] & ~w["include"] & (w["T_in"] >= CS.T_TERMINATE)
    k = torch.arange(slots.shape[2])
    inside = stop[..., :-1] & w["keep"][..., 1:] & ((k[:-1] % 4) < 3)
    assert bool(inside.any())
    for ng in (1, 3, 4):
        got = CS.splat_forward_grouped(slots, counts, cp, tiles_x, ids, ng=ng)
        ref = CS.splat_forward_plain(slots, counts, cp, tiles_x, ids)
        for ch in range(8):
            assert_close_scaled(got[:, ch], ref[:, ch], 1e-6, f"channel {ch}")
