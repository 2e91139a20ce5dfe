"""The binned mapping renderer's row movement as two kernels
(ops/rasterizer/cuda_slots.py, csrc/slots.cu): the slot gather SG and the
slot-inverse sum SI, and where `map_cache.SplatBinned` takes them.

The reference is the composition they replace: `gather_channels(f8, tab)`
for the planes (whose slots past a tile's count no kernel reads) and
`weighted_inverse` for K3's rows mapped back onto the field table.

CPU: the plain gather equals `gather_channels` on every slot inside a
tile's count and is 0 past it; the plain inverse is `weighted_inverse`
bit for bit at s2 4 and 9 with -1 pads; `render_binned` and
`render_binned_global` give the old composition's render and field
gradient bit for bit; the wrappers take the plain versions for CPU
tensors; `mapping.SLOTS` (the engine's `map.slot_kernels`) counts the
iterations whose own render launched SG, not the global term's. Card
(marked `cuda`): SG and SI equal their plain versions bit for bit at
room0 shapes (3225 tiles, mpt 512 and 2048, N ~2M, tiles at count 0 and
at count mpt); the renders, field gradients and Adam steps of the binned
route equal the old composition's bit for bit; a binned mapping call
synchronises nothing; an engine counts 100 in `map.slot_kernels` for a
100-iteration mapping call.

This file imports no JAX: on the card,
python -m pytest --noconftest tests/test_torch_slot_kernels.py -m cuda
"""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from torch_port_util import smoke_config
from vtgaussian_slam_tpu_torch.core import map_cache as MC
from vtgaussian_slam_tpu_torch.core import mapping as M
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_slots as CSL
from vtgaussian_slam_tpu_torch.ops.rasterizer.binning import (gather_channels,
                                                              slot_inverse,
                                                              weighted_inverse)

ROOM0_TILES = 43 * 75      # 680 x 1200 in 16-pixel tiles


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def assert_same_bits(a, b, what):
    assert a.shape == b.shape, (what, a.shape, b.shape)
    same = torch.equal(bits(a), bits(b))
    assert same, (f"{what}: {int((bits(a) != bits(b)).sum())} entries "
                  f"differ in their bits")


def gather_case(T, mpt, M, seed=0, device="cpu"):
    """(f8 (M, 8), tab (T, mpt) int64, counts (T,) int32): random rows with
    some -0.0 entries, random ids (a tile's slots past its count hold
    clamped ids, as a binning's do), counts in [0, mpt] with the first
    tiles at 0 and at mpt."""
    g = torch.Generator().manual_seed(seed)
    f8 = torch.randn((M, 8), generator=g)
    f8[torch.rand((M, 8), generator=g) < 0.05] = -0.0
    tab = torch.randint(0, M, (T, mpt), generator=g)
    counts = torch.randint(0, mpt + 1, (T,), generator=g).to(torch.int32)
    counts[0::7] = 0
    counts[1::7] = mpt
    return f8.to(device), tab.to(device), counts.to(device)


def inverse_case(P, N, s2, seed=0, device="cpu"):
    """(rows (P, 8), pos (N, s2), w (N, s2)): a raw inverse map with -1
    pads (30%, some Gaussians all pads) sorted by `slot_inverse`, and rows
    with -0.0 entries, row 0 among them (every pad reads it)."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randn((P, 8), generator=g)
    rows[torch.rand((P, 8), generator=g) < 0.05] = -0.0
    rows[0, ::2] = -0.0
    raw = torch.randint(0, P, (N, s2), generator=g)
    raw[torch.rand((N, s2), generator=g) < 0.3] = -1
    raw[::11] = -1
    inv = slot_inverse(raw.to(torch.int32))
    return rows.to(device), inv.pos.to(device), inv.w.to(device)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,mpt,M", [(12, 128, 300), (7, 256, 5000)])
def test_plain_gather_is_the_table_gather_inside_each_count(T, mpt, M):
    f8, tab, counts = gather_case(T, mpt, M, seed=T)
    got = CSL.slot_gather_plain(f8, tab, counts)
    ref = gather_channels(f8, tab)
    live = torch.arange(mpt)[None, :] < counts[:, None]
    assert got.shape == (T, 8, mpt) and got.is_contiguous()
    assert_same_bits(got.transpose(1, 2)[live], ref.transpose(1, 2)[live],
                     "in-count slots")
    past = got.transpose(1, 2)[~live]
    assert past.numel() > 0
    assert torch.equal(bits(past), torch.zeros_like(bits(past)))   # +0.0


@pytest.mark.parametrize("s2", [4, 9])
def test_plain_inverse_is_weighted_inverse_bit_for_bit(s2):
    rows, pos, w = inverse_case(4096, 3000, s2, seed=s2)
    assert (w == 0).any() and (w == 0).all(1).any()
    got = CSL.slot_inverse_sum(rows, pos, w)
    assert_same_bits(got, weighted_inverse(rows, pos, w), f"s2 {s2}")
    # the sum in column order, each product and sum rounded on its own
    ref = rows[pos[:, 0]] * w[:, :1]
    for k in range(1, s2):
        ref = ref + rows[pos[:, k]] * w[:, k:k + 1]
    assert_same_bits(got, ref, f"s2 {s2} written out")


def test_the_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel library was asked for")
    monkeypatch.setattr(CSL._build, "library", refuse)
    n = (CSL.slot_gather.launches, CSL.slot_inverse_sum.launches)
    f8, tab, counts = gather_case(5, 128, 64)
    assert_same_bits(CSL.slot_gather(f8, tab, counts),
                     CSL.slot_gather_plain(f8, tab, counts), "SG")
    rows, pos, w = inverse_case(640, 64, 4)
    assert_same_bits(CSL.slot_inverse_sum(rows, pos, w),
                     weighted_inverse(rows, pos, w), "SI")
    assert (CSL.slot_gather.launches, CSL.slot_inverse_sum.launches) == n


def room0_camera(height=680, width=1200):
    from vtgaussian_slam_tpu_torch.ops.camera import Camera
    return Camera(height=height, width=width, fx=width / 2.0,
                  fy=width / 2.0, cx=(width - 1) / 2.0,
                  cy=(height - 1) / 2.0)


def scene(cam, n, seed, device):
    """n isotropic Gaussians filling the camera's view at 1-5 m."""
    from vtgaussian_slam_tpu_torch.models.gaussians import GaussianParams
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 5.0, n)
    u = rng.uniform(-20, cam.width + 20, n)
    v = rng.uniform(-20, cam.height + 20, n)
    means = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z,
                      z], -1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return GaussianParams(
        means3d=f32(means), rgb_colors=f32(rng.uniform(0, 1, (n, 3))),
        unnorm_rotations=f32(np.tile([[1.0, 0, 0, 0]], (n, 1))),
        logit_opacities=f32(rng.uniform(-1.0, 4.0, (n, 1))),
        log_scales=f32(np.log(rng.uniform(0.004, 0.02, (n, 1)))))


def binned_case(cam, n, mpt, device, seed=0):
    """A keyframe cache and a global cache ([frozen; trainable] at a pose
    1 cm away) over `n` trainable Gaussians, at pair budget mpt."""
    from vtgaussian_slam_tpu_torch.ops import geometry as geo
    prm = scene(cam, n, seed, device)
    fixed = scene(cam, n // 2, seed + 1, device)
    on = lambda k: torch.ones(k, dtype=torch.bool, device=device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    q0, t0 = f32([1.0, 0, 0, 0]), f32([0.0, 0, 0])
    q1 = geo.normalize(f32([1.0, 0.002, -0.001, 0.0015]))
    t1 = f32([0.01, -0.004, 0.006])
    kfc = MC.build_kf_cache(prm, on(n), q0, t0, cam, span_cap=2,
                            max_pairs_per_tile=mpt, select="importance")
    gc = MC.build_global_cache(fixed, on(n // 2), prm, on(n), q1, t1, cam,
                               span_cap=2, max_pairs_per_tile=mpt,
                               select="importance")
    return prm, kfc, gc


@contextlib.contextmanager
def old_composition():
    """`SplatBinned` as it was before the kernels: `gather_channels` for
    the planes, `weighted_inverse` for the field gradient."""
    with mock.patch.object(MC, "slot_gather",
                           lambda f8, tab, counts: gather_channels(f8, tab)), \
            mock.patch.object(MC, "slot_inverse_sum", weighted_inverse):
        yield


def render_and_grad(f8, render):
    """A render's image, depth and silhouette and the gradient of a loss
    on all three to the field table."""
    v8 = f8.detach().clone().requires_grad_(True)
    r = render(v8)
    loss = ((r.im - 0.5) ** 2).sum() + r.depth.abs().sum() \
        + r.silhouette.sum()
    (g8,) = torch.autograd.grad(loss, (v8,))
    return r.im, r.depth, r.silhouette, g8


def assert_render_unchanged(f8, kfc, gc, cam):
    for name, render in (
            ("local", lambda v: MC.render_binned(v, kfc, cam)),
            ("global", lambda v: MC.render_binned_global(v, gc, cam))):
        got = render_and_grad(f8, render)
        with old_composition():
            ref = render_and_grad(f8, render)
        for what, a, b in zip(("im", "depth", "silhouette", "g8"), got, ref):
            assert_same_bits(a, b, f"{name} {what}")
        assert got[3].abs().sum() > 0, name


def test_binned_renders_and_gradients_unchanged_on_the_cpu():
    cam = room0_camera(64, 96)
    prm, kfc, gc = binned_case(cam, 1500, 128, "cpu")
    assert (kfc.counts < 128).any()      # slots past the count to zero
    assert_render_unchanged(MC.pack_fields8(prm), kfc, gc, cam)


@pytest.mark.parametrize("use_global", [False, True])
def test_slot_iterations_count_the_loops_own_renders(use_global):
    """`mapping.SLOTS` counts an iteration when its own render launched
    SG, by the wrapper's launch count: a render that launches it (a
    stand-in here, on the CPU) counts once an iteration, and the global
    term's launches (its first iteration here) are not counted."""
    from vtgaussian_slam_tpu_torch.core.losses import (LossConfig,
                                                       RenderResult)
    n, iters = 6, 4

    def render(v8, *a):
        CSL.slot_gather.launches += 1
        return RenderResult(im=v8[:, 5:8].sum() * torch.ones(3, 4, 5),
                            depth=torch.ones(1, 4, 5),
                            silhouette=torch.ones(4, 5),
                            depth_sq=torch.ones(1, 4, 5), radii=None)

    g = torch.Generator().manual_seed(0)
    prm = M.GaussianParams(
        means3d=torch.rand(n, 3, generator=g),
        rgb_colors=torch.rand(n, 3, generator=g),
        unnorm_rotations=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
        logit_opacities=torch.zeros(n, 1), log_scales=torch.zeros(n, 1))
    kf = M.KeyframeBuffer(colors=torch.zeros(1, 3, 4, 5),
                          depths=torch.ones(1, 1, 4, 5), count=1,
                          frame_ids=[0])
    loss_cfg = LossConfig(tracking=False, use_sil_for_loss=False,
                          ignore_outlier_depth_loss=False, adaptive_sil=False,
                          im_weight=0.5, depth_weight=1.0)
    mcfg = M.MappingConfig(num_iters=iters, lrs=(("rgb_colors", 0.01),),
                           loss_cfg=loss_cfg, use_global=use_global,
                           baseframe_every=2)
    n0, s0 = CSL.slot_gather.launches, M.SLOTS.iters
    M.map_binned_loop(render, prm, kf, [None], [0], mcfg,
                      render_global=render)
    assert M.SLOTS.iters - s0 == iters
    assert CSL.slot_gather.launches - n0 == iters + (iters if use_global
                                                     else 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mpt", [512, 2048])
def test_slot_gather_equals_plain_at_room0_shapes(card, mpt):
    f8, tab, counts = gather_case(ROOM0_TILES, mpt, 2_000_000, seed=mpt,
                                  device=card)
    n0 = CSL.slot_gather.launches
    got = CSL.slot_gather(f8, tab, counts)
    assert CSL.slot_gather.launches == n0 + 1
    torch.cuda.synchronize()
    assert_same_bits(got, CSL.slot_gather_plain(f8, tab, counts), f"SG {mpt}")
    assert_same_bits(got, CSL.slot_gather(f8, tab, counts), "SG repeated")


@pytest.mark.cuda
@pytest.mark.parametrize("mpt,s2", [(512, 4), (2048, 4), (512, 9)])
def test_slot_inverse_equals_plain_at_room0_shapes(card, mpt, s2):
    rows, pos, w = inverse_case(ROOM0_TILES * mpt, 2_000_000, s2, seed=mpt,
                                device=card)
    n0 = CSL.slot_inverse_sum.launches
    got = CSL.slot_inverse_sum(rows, pos, w)
    assert CSL.slot_inverse_sum.launches == n0 + 1
    torch.cuda.synchronize()
    assert_same_bits(got, weighted_inverse(rows, pos, w), f"SI {mpt} {s2}")
    assert_same_bits(got, CSL.slot_inverse_sum(rows, pos, w), "SI repeated")


@pytest.fixture(scope="module")
def room0_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cam = room0_camera()
    prm, kfc, gc = binned_case(cam, 400_000, 512, torch.device("cuda"))
    return cam, prm, kfc, gc


@pytest.mark.cuda
def test_binned_renders_and_gradients_unchanged_on_the_card(room0_case):
    cam, prm, kfc, gc = room0_case
    n0 = (CSL.slot_gather.launches, CSL.slot_inverse_sum.launches)
    assert_render_unchanged(MC.pack_fields8(prm), kfc, gc, cam)
    # local and global, each forward and backward, twice (old beside new)
    assert (CSL.slot_gather.launches - n0[0],
            CSL.slot_inverse_sum.launches - n0[1]) == (2, 2)


def map_call(cam, prm, kfc, gc, iters, old=False):
    """map_frame_binned over the local cache (and the global term on the
    first iteration) for `iters` iterations, with room0's lrs."""
    from vtgaussian_slam_tpu_torch.core.losses import LossConfig
    dev = prm.means3d.device
    with torch.no_grad():
        r = MC.render_binned(MC.pack_fields8(prm), kfc, cam)
    kf = M.KeyframeBuffer(
        colors=torch.clamp(r.im + 0.05, 0, 1)[None].contiguous(),
        depths=(r.depth * 1.01)[None].contiguous(), count=1, frame_ids=[0])
    lrs = {"rgb_colors": 0.0025, "logit_opacities": 0.05,
           "log_scales": 0.001}
    loss_cfg = LossConfig(tracking=False, use_sil_for_loss=False,
                          ignore_outlier_depth_loss=False, adaptive_sil=False,
                          im_weight=0.5, depth_weight=1.0)
    mcfg = M.MappingConfig(num_iters=iters, lrs=tuple(sorted(lrs.items())),
                           loss_cfg=loss_cfg, use_global=True,
                           baseframe_every=1, log_global_loss=False)
    assert kf.colors.device == dev
    with old_composition() if old else contextlib.nullcontext():
        return M.map_frame_binned(prm, kf, [kfc], [0], cam, mcfg,
                                  draws=[0] * iters, gc=gc)


@pytest.mark.cuda
def test_adam_steps_unchanged_on_the_card(room0_case):
    cam, prm, kfc, gc = room0_case
    new, h_new = map_call(cam, prm, kfc, gc, 3)
    old, h_old = map_call(cam, prm, kfc, gc, 3, old=True)
    for name in ("logit_opacities", "log_scales", "rgb_colors"):
        assert_same_bits(getattr(new, name), getattr(old, name), name)
    assert_same_bits(h_new, h_old, "loss history")


@pytest.mark.cuda
def test_a_binned_mapping_call_synchronises_nothing(room0_case):
    cam, prm, kfc, gc = room0_case
    map_call(cam, prm, kfc, gc, 4)                # warms up
    torch.cuda.synchronize()
    n0 = (CSL.slot_gather.launches, CSL.slot_inverse_sum.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        map_call(cam, prm, kfc, gc, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the keyframe's render (no gradient), 4 local renders and the first
    # iteration's global term
    assert (CSL.slot_gather.launches - n0[0],
            CSL.slot_inverse_sum.launches - n0[1]) == (6, 5)


@pytest.mark.cuda
def test_an_engine_counts_every_mapping_iteration_in_slot_kernels(
        card, tmp_path):
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    cfg = smoke_config(tmp_path, frames=3, iters=100)
    eng = VTGaussianSLAM(cfg, device="cuda")
    try:
        assert eng.map_binned
        for t in range(3):
            eng.process_frame(t)
        counts = [eng.frame_times[t]["counts"] for t in range(3)]
    finally:
        eng.close()
    assert all(c["map.slot_kernels"] == c["map.iters"] == 100
               for c in counts), counts
