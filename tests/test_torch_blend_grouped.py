"""What the blend forward (K4, csrc/blend.cu) does only on the card,
rehearsed on the CPU.

K4 culls (8 x 4 pixel block, record) steps with the per-record box, compacts
each warp's live records of a chunk into a list, and blends the list four
records at a time with selects. `cuda_blend.blend_forward_grouped` repeats
that in PyTorch (`ng` records per group, `chunk` records per list):

  (a) it and `blend_forward_plain` each within the f32 rounding bound of
      the exact value of the plain walk's alphas and stop decisions
      (torch_port_util.assert_blend_within_rounding: gamma(2M + 1) of the
      sum of the exact products' absolute values), on the record cases of
      test_torch_walk_boxes.py, on ragged counts (0, off the chunk, off a
      multiple of the group; up to 640 records, past the kernel's
      256-record chunks) and on tiles whose pixels stop early. They were
      held to each other within 1e-6 of each channel's largest value,
      which read 0.66 on MKL's default sgemm path of an AVX-512 host and
      0.77 under MKL_CBWR=COMPATIBLE or MKL_ENABLE_INSTRUCTIONS=AVX2 (the
      plain version sums through an einsum); the bound reads <= 0.05 on
      both, and test_torch_parity_controls.py holds a 1e-4 scale of the
      grouped output against it;
  (b) a stop that falls inside a group, with a record the pixel would have
      kept after it in the same group, blends neither;
  (c) against the JAX package's interpret-mode `blend_tiles` at rtol 1e-4 /
      atol 1e-5 (f32 product and summation order), with 8 and 5 channels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import _hand_records
from test_torch_walk_boxes import RECORD_CASES
from torch_port_util import (N_TILES, TILES_X, assert_blend_within_rounding,
                             k5_records, np_)
from vtgaussian_slam_tpu.ops.rasterizer.pallas_blend import blend_tiles
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_blend as CB
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS


@pytest.fixture(autouse=True, scope="module")
def _first_exp_spent():
    """In a process that also imports JAX, the first multi-threaded
    `torch.exp` on the CPU can come back ~1e-4 off on one thread's share of
    the tensor; later calls are exact. The 1e-6 comparisons below take exp
    on each side, so spend that first call here."""
    torch.exp(torch.randn(1 << 20))


CASES = dict(RECORD_CASES,
             ragged_counts=lambda: _hand_records("ragged_counts"),
             ragged_chunks=lambda: _hand_records("ragged_chunks"),
             early_stop=lambda: _hand_records("early_stop"))
# records per list beside each group size: one chunk for the whole tile, a
# chunk the group does not divide, and several whole chunks
CHUNK_OF = {1: 256, 3: 64, 4: 32}


@pytest.mark.parametrize("ng", sorted(CHUNK_OF))
@pytest.mark.parametrize("name", sorted(CASES))
def test_grouped_blend_matches_plain(name, ng):
    recs, counts = CASES[name]()
    ref = CB.blend_forward_plain(recs, counts, TILES_X, 8)
    got = CB.blend_forward_grouped(recs, counts, TILES_X, 8, ng=ng,
                                   chunk=CHUNK_OF[ng])
    assert got.shape == ref.shape == (recs.shape[0], 256, 8)
    for what, out in (("plain", ref), ("grouped", got)):
        print(name, ng, what, assert_blend_within_rounding(
            out, recs, counts, TILES_X, 8, what))
    if name.startswith("ragged"):
        assert int(counts[0]) == 0
        assert any(int(n) % CHUNK_OF[ng] and int(n) % 4 for n in counts)
        np.testing.assert_array_equal(np_(got[0]), 0.0)         # count 0
    if name == "ragged_chunks":               # no pixel stops: all is walked
        w = CB._blend_walk(recs, counts, TILES_X, torch.arange(recs.shape[0]))
        assert bool(w["walked"][8, :, 512:].any())
    if name == "early_stop":
        w = CB._blend_walk(recs, counts, TILES_X, torch.arange(recs.shape[0]))
        assert not bool(w["walked"][4, :, 16:].any())


@pytest.mark.parametrize("ng", [3, 4])
def test_grouped_blend_stops_inside_a_group(ng):
    """Pixels whose stop falls on a record that is not the last of its
    group in their warp's list, with a kept record after it in the same
    group: the selects must blend neither."""
    recs, counts = _hand_records("early_stop")
    T, _, M = recs.shape
    w = CB._blend_walk(recs, counts, TILES_X, torch.arange(T))
    live = CS.box_meets_blocks(CB.record_box(recs, TILES_X)) \
        & (torch.arange(M)[None] < counts[:, None])[:, None]    # (T, 8, M)
    pos = torch.cumsum(live, -1) - 1                  # place in the warp's list
    stop = CS.block_pixels(w["keep"] & ~w["blended"]
                           & (w["T_in"] >= CB.T_TERMINATE))     # (T, 8, 32, M)
    keep = CS.block_pixels(w["keep"])
    inside = (pos % ng < ng - 1)[:, :, None, :-1] & stop[..., :-1] \
        & keep[..., 1:] & live[:, :, None, 1:]
    assert bool(inside.any())
    ref = CB.blend_forward_plain(recs, counts, TILES_X, 8)
    got = CB.blend_forward_grouped(recs, counts, TILES_X, 8, ng=ng)
    for what, out in (("plain", ref), ("grouped", got)):
        assert_blend_within_rounding(out, recs, counts, TILES_X, 8, what)


@pytest.mark.parametrize("C", [8, 5])
@pytest.mark.parametrize("case", [
    dict(seed=0, count_hi=128),             # full counts
    dict(seed=3, count_hi=19),              # sparse tiles
    # clamped pairs, and tiles whose every pixel stops before the count
    dict(seed=5, count_hi=128, op=(0.6, 1.0), conic=(0.005, 0.05)),
], ids=["dense", "sparse", "clamped_and_stopped"])
def test_grouped_blend_matches_pallas(case, C):
    recs, counts = k5_records(**case)
    ref = blend_tiles(jnp.asarray(recs), jnp.asarray(counts), TILES_X, 128, C,
                      True)
    got = CB.blend_forward_grouped(torch.as_tensor(recs),
                                   torch.as_tensor(counts), TILES_X, C,
                                   chunk=32)
    assert got.shape == (N_TILES, 256, C)
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-4, atol=1e-5)
