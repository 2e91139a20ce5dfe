"""The mapping loss kernel (ops/map_loss.py, csrc/maploss.cu) and where
`losses.loss_from_render` takes it.

The reference is `loss_from_render`'s own mapping branch (its PyTorch
ops): in f64 on the CPU for the exact values, in f32 on the card with the
kernel's dispatch turned off for the plain path.

CPU: the closed form of the gradient that the kernel computes (the SSIM
term as B(a) + 2 x B(b) + y B(c)) equals autograd's in f64; the f32
rounding bound the card tests hold the kernel to holds for the plain f32
path and fails a gradient with a term left out; only the mapping branch
without outlier rejection or an auxiliary mask, on a card, takes the
kernel, so the CPU and the tracking branch keep their PyTorch ops, and the
kernel's wrapper refuses CPU tensors; `mapping.FUSED` (the engine's
`map.loss_fused`) counts the iterations whose own loss launched the kernel,
not the global term's. Card (marked `cuda`): the kernel within f32
rounding of the exact loss and gradients at 680 x 1200 and at 77 x 131
(not a multiple of the 32-pixel tile), with NaN depths, zero depths and
colour ties, and with every depth masked; two calls repeat bit for bit,
and without the gradient the loss keeps its bits; mapping iterations of
`map_frame_binned` synchronise nothing; three of them land within the
plain path's own one-ulp spread; and an engine on the card counts every
mapping iteration in `map.loss_fused`, as many as the kernel's launches.

This file imports no JAX: on the card,
python -m pytest --noconftest tests/test_torch_map_loss.py -m cuda
"""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import assert_within_f32_rounding, smoke_config
from vtgaussian_slam_tpu_torch.core import losses
from vtgaussian_slam_tpu_torch.core import mapping as M
from vtgaussian_slam_tpu_torch.core.losses import (Frame, LossConfig,
                                                   LossOutput, RenderResult,
                                                   fused_mapping_loss,
                                                   loss_from_render)
from vtgaussian_slam_tpu_torch.ops import map_loss as ML
from vtgaussian_slam_tpu_torch.ops.ssim import _gaussian_kernel1d

W_IM, W_D = 0.5, 1.0     # the mapping weights of configs/common.py
N_LOSS = 128             # roundings in a loss: the per-pixel chain + the sums
N_GRAD = 80              # roundings in a gradient entry's longest chain


def map_cfg(**over):
    kw = dict(tracking=False, use_sil_for_loss=False,
              ignore_outlier_depth_loss=False, adaptive_sil=False,
              im_weight=W_IM, depth_weight=W_D)
    kw.update(over)
    return LossConfig(**kw)


def loss_inputs(H, W, seed=0, device="cpu", all_masked=False):
    """A render and its keyframe at H x W: the render's planes are views
    of a (6, H + 8, W + 16) leaf, as the assembled tile image's are; a
    smooth texture and noise, 2% of the colours equal to the keyframe's,
    3% zero keyframe depths (all with `all_masked`), 1% NaN depths and 1%
    NaN depth_sq. Returns (img6 leaf, RenderResult, Frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    gt = np.stack([0.5 + 0.4 * np.sin(xx / (7 + 3 * c) + yy / (11 + c) + c)
                   for c in range(3)])
    im = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1)
    tie = rng.uniform(size=gt.shape) < 0.02
    im[tie] = gt[tie]
    gd = rng.uniform(1.0, 5.0, (1, H, W))
    gd[rng.uniform(size=gd.shape) < (1.0 if all_masked else 0.03)] = 0.0
    d = gd + rng.normal(0, 0.05, gd.shape)
    dsq = d * d + rng.uniform(0, 0.01, d.shape)
    d[rng.uniform(size=d.shape) < 0.01] = np.nan
    dsq[rng.uniform(size=d.shape) < 0.01] = np.nan
    img6 = np.zeros((6, H + 8, W + 16))
    img6[:3, :H, :W], img6[3, :H, :W], img6[5, :H, :W] = im, d[0], dsq[0]
    img6[4, :H, :W] = 1.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    leaf = f32(img6).requires_grad_(True)
    view = leaf[:, :H, :W]
    r = RenderResult(im=view[:3], depth=view[3:4], silhouette=view[4],
                     depth_sq=view[5:6], radii=leaf.new_zeros((1,)))
    return leaf, r, Frame(color=f32(gt), depth=f32(gd))


@contextlib.contextmanager
def plain_path():
    """`loss_from_render` with its PyTorch ops on a card too."""
    with mock.patch.object(losses, "fused_mapping_loss",
                           lambda *a, **k: False):
        yield


def plain_outputs(leaf, r, frame, cfg=None):
    """loss_from_render's PyTorch ops: (loss, im_loss, depth_loss, d
    img6)."""
    with plain_path():
        out = loss_from_render(r, frame, cfg or map_cfg(), 0.5, False)
    (g,) = torch.autograd.grad(out.loss, (leaf,))
    return out.loss, out.im_loss, out.depth_loss, g


def kernel_outputs(leaf, r, frame):
    """map_loss's (loss, im_loss, depth_loss, d img6)."""
    loss, il, dl = ML.map_loss(r.im, r.depth, r.depth_sq, frame.color,
                               frame.depth, W_IM, W_D)
    (g,) = torch.autograd.grad(loss, (leaf,))
    return loss, il, dl, g


# ---------------------------------------------------------------------------
# the exact values, the kernel's closed form and its rounding bound (f64)
# ---------------------------------------------------------------------------
def blur64(img):
    """The SSIM window (its f32 taps) over a (C, H, W) f64 image, zero
    'same' padding."""
    w = torch.as_tensor(_gaussian_kernel1d(11, 1.5), dtype=torch.float64,
                        device=img.device)
    C = img.shape[0]
    x = F.conv2d(img[None], w.view(1, 1, 11, 1).expand(C, 1, 11, 1),
                 padding=(5, 0), groups=C)
    x = F.conv2d(x, w.view(1, 1, 1, 11).expand(C, 1, 1, 11),
                 padding=(0, 5), groups=C)
    return x[0]


def exact_outputs(r, frame, cfg=None):
    """`loss_from_render`'s mapping branch (`cfg`, by default `map_cfg()`)
    in f64 on the CPU, on the same f32 inputs: (loss, im_loss, depth_loss,
    d im, d depth), the exact values the f32 evaluations are held to."""
    f64 = lambda t: t.detach().cpu().double()
    im = f64(r.im).requires_grad_(True)
    d = f64(r.depth).requires_grad_(True)
    r64 = RenderResult(im=im, depth=d, silhouette=f64(r.silhouette),
                       depth_sq=f64(r.depth_sq), radii=None)
    out = loss_from_render(r64, Frame(color=f64(frame.color),
                                      depth=f64(frame.depth)),
                           cfg or map_cfg(), 0.5, False)
    g_im, g_d = torch.autograd.grad(out.loss, (im, d))
    return (out.loss.detach(), out.im_loss.detach(), out.depth_loss.detach(),
            g_im, g_d)


def ssim_parts(x, y):
    """The blurred statistics and the per-pixel SSIM terms of csrc/
    maploss.cu in f64, with the magnitudes a first-order rounding analysis
    gives each: the blurs' sums of |terms|, and each quantity's relative
    condition (a sum's |terms| over its value) carried through the
    products and quotients."""
    B = blur64
    mx, my, exx, eyy, exy = B(x), B(y), B(x * x), B(y * y), B(x * y)
    mxm, mym, exym = B(x.abs()), B(y.abs()), B((x * y).abs())
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s1, s2, s12 = exx - mx * mx, eyy - my * my, exy - mx * my
    A1, B1 = 2 * mx * my + c1, mx * mx + my * my + c1
    A2, B2 = 2 * s12 + c2, s1 + s2 + c2
    A1m, B1m = 2 * mxm * mym + c1, mxm ** 2 + mym ** 2 + c1
    A2m = 2 * (exym + mxm * mym) + c2
    B2m = exx + eyy + mxm ** 2 + mym ** 2 + c2
    kB1, kB2 = B1m / B1.abs(), B2m / B2.abs()
    L, C = A1 / B1, A2 / B2
    sL = (A1m + A1.abs() * kB1) / B1.abs()       # |L| (k(A1) + k(B1))
    sC = (A2m + A2.abs() * kB2) / B2.abs()
    S = L * C
    sS = sL * C.abs() + L.abs() * sC
    D1 = 2 * my - 2 * mx * L
    D1m = 2 * mym + 2 * mxm * (L.abs() + sL)
    t1 = C * D1 / B1
    st1 = (sC * D1.abs() + C.abs() * D1m) / B1.abs() + t1.abs() * kB1
    D2 = 2 * mx * C - 2 * my
    D2m = 2 * mxm * (C.abs() + sC) + 2 * mym
    t2 = L * D2 / B2
    st2 = (sL * D2.abs() + L.abs() * D2m) / B2.abs() + t2.abs() * kB2
    return dict(S=S, sS=sS, a=t1 + t2, sa=st1 + st2, b=-S / B2,
                sb=(sS + S.abs() * kB2) / B2.abs(), c=2 * L / B2,
                sc=2 * (sL + L.abs() * kB2) / B2.abs())


def depth_parts(d, dsq, gd):
    m = (gd > 0) & ~torch.isnan(d) & ~torch.isnan(dsq - d * d)
    diff = torch.where(m, gd - d, torch.zeros_like(d))
    return m, diff, torch.clamp(m.sum(), min=1).double()


def closed_form_grads(r, frame, terms=(1.0, 2.0, 1.0)):
    """The kernel's gradient in f64: d im = w_im (0.8 sign(x - y) - 0.2
    (B(a) + 2 x B(b) + y B(c))) / N, d depth = -w_d sign(gd - d) m /
    max(sum m, 1). `terms` scales the three SSIM terms (a control leaves
    one out)."""
    x, y = r.im.detach().double(), frame.color.double()
    p = ssim_parts(x, y)
    g_ssim = (terms[0] * blur64(p["a"]) + terms[1] * x * blur64(p["b"])
              + terms[2] * y * blur64(p["c"]))
    g_im = W_IM * (0.8 * torch.sign(x - y) - 0.2 * g_ssim) / x.numel()
    m, diff, den = depth_parts(r.depth.detach().double(),
                               r.depth_sq.detach().double(),
                               frame.depth.double())
    return g_im, -W_D * torch.sign(diff) / den


def rounding_scales(r, frame, cfg=None):
    """|terms| for the f32 rounding bound: loss, im_loss, depth_loss and
    the two gradients (the bound is gamma(n) x these), at `cfg`'s
    weights."""
    cfg = cfg or map_cfg()
    w_im, w_d = cfg.im_weight, cfg.depth_weight
    x, y = r.im.detach().double(), frame.color.double()
    p = ssim_parts(x, y)
    n = x.numel()
    s_im = 0.8 * (x - y).abs().mean() + 0.2 * (1 + p["sS"].mean())
    m, diff, den = depth_parts(r.depth.detach().double(),
                               r.depth_sq.detach().double(),
                               frame.depth.double())
    s_d = diff.abs().sum() / den
    g_im = w_im * (0.8 + 0.2 * (blur64(p["sa"]) + 2 * x.abs()
                                * blur64(p["sb"]) + y.abs()
                                * blur64(p["sc"]))) / n
    g_d = w_d * m.double() / den
    return w_im * s_im + w_d * s_d, s_im, s_d, g_im, g_d


def within_rounding(got, r, frame, what, cfg=None):
    """(loss, im_loss, depth_loss, d im, d depth) of `r` against `frame`
    under `cfg` held to the exact values within the f32 rounding bound;
    returns the largest share of the bound."""
    exact = exact_outputs(r, frame, cfg)
    scales = rounding_scales(r, frame, cfg)
    worst = 0.0
    for i, name in enumerate(("loss", "im_loss", "depth_loss", "d im",
                              "d depth")):
        a, e, s = (x.detach().cpu() for x in (got[i], exact[i], scales[i]))
        if i < 3:
            a, e, s = a.reshape(1), e.reshape(1), s.reshape(1)
        worst = max(worst, assert_within_f32_rounding(
            a, e, s, N_LOSS if i < 3 else N_GRAD, f"{what} {name}"))
    return worst


def assert_within_rounding(got, r, frame, what):
    """(loss, im_loss, depth_loss, d img6) held to the exact values within
    the f32 rounding bound; returns the largest share of the bound."""
    loss, il, dl, g = got
    H, W = r.im.shape[1:]
    worst = within_rounding((loss, il, dl, g[:3, :H, :W], g[3:4, :H, :W]),
                            r, frame, what)
    # nothing reaches the silhouette, depth_sq or the padding
    assert not g[4:].any() and not g[:, H:].any() and not g[:, :, W:].any()
    return worst


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(21, 37), (40, 70)])
def test_closed_form_gradient_equals_autograd_in_f64(shape):
    """The kernel's algebra (csrc/maploss.cu's header) is the gradient of
    the plain loss: a, b, c, their blurs with zero padding and the masked
    depth sign, against autograd in f64."""
    leaf, r, frame = loss_inputs(*shape, seed=2)
    _, _, _, g_im, g_d = exact_outputs(r, frame)
    c_im, c_d = closed_form_grads(r, frame)
    assert torch.allclose(c_im.cpu(), g_im, rtol=1e-10, atol=1e-14 * float(
        g_im.abs().max()))
    assert torch.equal(c_d.cpu(), g_d)


def test_the_rounding_bound_holds_for_the_plain_f32_path():
    """The yardstick the card tests hold the kernel to: the plain f32
    path lies within it (with room), and a gradient whose 2 x B(b) term is
    off by a thousandth does not."""
    leaf, r, frame = loss_inputs(40, 70, seed=3)
    worst = assert_within_rounding(plain_outputs(leaf, r, frame), r, frame,
                                   "plain f32")
    assert worst < 0.5, worst
    g_im, g_d = closed_form_grads(r, frame, terms=(1.0, 2.002, 1.0))
    s = rounding_scales(r, frame)[3]
    with pytest.raises(AssertionError):
        assert_within_f32_rounding(g_im.float(), exact_outputs(r, frame)[3],
                                   s, N_GRAD, "control")


def test_the_kernels_wrapper_refuses_cpu_tensors():
    """The kernel runs on a card only; on the CPU its wrapper says so
    before it builds anything."""
    leaf, r, frame = loss_inputs(21, 37, seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        ML.map_loss(r.im, r.depth, r.depth_sq, frame.color, frame.depth,
                    W_IM, W_D)


@pytest.mark.parametrize("route,use_global", [("binned", False),
                                              ("binned", True),
                                              ("generic", True)])
def test_fused_iterations_count_the_loops_own_losses(monkeypatch, route,
                                                     use_global):
    """`mapping.FUSED` counts an iteration when its own loss launched the
    kernel, by the wrapper's launch count: a loss that launches it (a
    stand-in here, on the CPU) counts once an iteration, and the global
    term's launches (every iteration here) are not counted."""
    n, iters = 6, 4

    def launching_loss(first, *a, **k):
        ML.map_loss_forward.launches += 1
        x = first.im if isinstance(first, RenderResult) else first.rgb_colors
        s = x.sum()
        return LossOutput(loss=s, im_loss=s.detach(), depth_loss=s.detach(),
                          sil_thres_out=s.detach())

    monkeypatch.setattr(M, "loss_from_render", launching_loss)
    monkeypatch.setattr(M, "compute_loss", launching_loss)
    g = torch.Generator().manual_seed(0)
    prm = M.GaussianParams(
        means3d=torch.rand(n, 3, generator=g),
        rgb_colors=torch.rand(n, 3, generator=g),
        unnorm_rotations=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
        logit_opacities=torch.zeros(n, 1), log_scales=torch.zeros(n, 1))
    kf = M.KeyframeBuffer(colors=torch.zeros(1, 3, 4, 5),
                          depths=torch.ones(1, 1, 4, 5), count=1,
                          quats=torch.tensor([[1.0, 0, 0, 0]]),
                          trans=torch.zeros(1, 3), frame_ids=[0])
    mcfg = M.MappingConfig(num_iters=iters, lrs=(("rgb_colors", 0.01),),
                           loss_cfg=map_cfg(), use_global=use_global,
                           baseframe_every=2)
    render = lambda v8, *a: RenderResult(
        im=v8[:, 5:8].sum() * torch.ones(3, 4, 5), depth=None,
        silhouette=None, depth_sq=None, radii=None)
    n0, f0 = ML.map_loss_forward.launches, M.FUSED.iters
    if route == "binned":
        M.map_binned_loop(render, prm, kf, [None], [0], mcfg,
                          render_global=render)
    else:
        M.map_frame(prm, torch.ones(n, dtype=torch.bool), kf, None, mcfg,
                    fixed_params=prm, fixed_active=torch.ones(
                        n, dtype=torch.bool))
    assert M.FUSED.iters - f0 == iters
    assert ML.map_loss_forward.launches - n0 == iters * (1 + use_global)


@pytest.mark.parametrize("cfg,device,aux,fused", [
    (map_cfg(), "cuda", False, True),
    (map_cfg(), "cpu", False, False),
    (map_cfg(tracking=True, use_sil_for_loss=True), "cuda", False, False),
    (map_cfg(ignore_outlier_depth_loss=True), "cuda", False, False),
    (map_cfg(), "cuda", True, False),
])
def test_only_the_mapping_branch_on_a_card_takes_the_kernel(cfg, device, aux,
                                                            fused):
    mask = torch.ones((2, 3), dtype=torch.bool) if aux else None
    assert fused_mapping_loss(cfg, torch.device(device), mask) is fused
    assert fused_mapping_loss(cfg, device, mask) is fused


@pytest.mark.parametrize("tracking", [False, True])
def test_the_cpu_keeps_the_pytorch_ops(monkeypatch, tracking):
    """On CPU tensors neither branch reaches the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper ran")
    monkeypatch.setattr(ML.MapLoss, "apply", refuse)
    monkeypatch.setattr(losses, "map_loss", refuse)
    leaf, r, frame = loss_inputs(21, 37, seed=4)
    cfg = map_cfg(tracking=tracking, use_sil_for_loss=tracking)
    out = loss_from_render(r, frame, cfg, 0.5, False)
    torch.autograd.grad(out.loss, (leaf,))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,all_masked", [((680, 1200), False),
                                              ((77, 131), False),
                                              ((77, 131), True)])
def test_kernel_within_f32_rounding_of_the_exact_loss(card, shape,
                                                      all_masked):
    leaf, r, frame = loss_inputs(*shape, seed=5, device=card,
                                 all_masked=all_masked)
    n0 = (ML.map_loss_forward.launches, ML.map_loss_backward.launches)
    got = kernel_outputs(leaf, r, frame)
    assert (ML.map_loss_forward.launches - n0[0],
            ML.map_loss_backward.launches - n0[1]) == (1, 1)
    worst = assert_within_rounding(got, r, frame, f"kernel {shape}")
    plain = assert_within_rounding(plain_outputs(leaf, r, frame), r, frame,
                                   f"plain f32 {shape}")
    print(f"{shape} all_masked={all_masked}: kernel {worst:.4f}, plain "
          f"{plain:.4f} of the bound")
    if all_masked:
        assert float(got[2]) == 0.0 and not got[3][3].any()
        assert float(got[0].detach()) == W_IM * float(got[1])


@pytest.mark.cuda
def test_two_calls_repeat_bit_for_bit_and_no_grad_keeps_the_loss(card):
    leaf, r, frame = loss_inputs(680, 1200, seed=6, device=card)
    a, b = kernel_outputs(leaf, r, frame), kernel_outputs(leaf, r, frame)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with torch.no_grad():
        c = ML.map_loss(r.im, r.depth, r.depth_sq, frame.color, frame.depth,
                        W_IM, W_D)
    for x, y in zip(a[:3], c):
        assert torch.equal(x, y)


def map_case(dev, n=400_000, seed=0, iters=3):
    """Replica room0's camera over n Gaussians filling its view at 1-5 m,
    two keyframes rendered 1 cm apart with their frozen binnings at mpt
    512, and the mapping config (room0's lrs) for `iters` iterations."""
    from vtgaussian_slam_tpu_torch.core.map_cache import build_kf_cache
    from vtgaussian_slam_tpu_torch.core.mapping import (KeyframeBuffer,
                                                        MappingConfig)
    from vtgaussian_slam_tpu_torch.models.gaussians import GaussianParams
    from vtgaussian_slam_tpu_torch.ops import geometry as geo
    from vtgaussian_slam_tpu_torch.ops.camera import Camera
    cam = Camera(height=680, width=1200, fx=600.0, fy=600.0, cx=599.5,
                 cy=339.5)
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 5.0, n)
    u = rng.uniform(-20, cam.width + 20, n)
    v = rng.uniform(-20, cam.height + 20, n)
    means = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z,
                      z], -1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    prm = GaussianParams(
        means3d=f32(means), rgb_colors=f32(rng.uniform(0, 1, (n, 3))),
        unnorm_rotations=f32(np.tile([[1.0, 0, 0, 0]], (n, 1))),
        logit_opacities=f32(rng.uniform(-1.0, 4.0, (n, 1))),
        log_scales=f32(np.log(rng.uniform(0.004, 0.02, (n, 1)))))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    poses = [(f32([1.0, 0, 0, 0]), f32([0.0, 0, 0])),
             (geo.normalize(f32([1.0, 0.002, -0.001, 0.0015])),
              f32([0.01, -0.004, 0.006]))]
    # the keyframes: a render of perturbed colours, so the loss has work
    other = prm.replace(rgb_colors=torch.clamp(
        prm.rgb_colors + f32(rng.normal(0, 0.1, (n, 3))), 0, 1))
    colors, depths, kfc = [], [], []
    with torch.no_grad():
        for q, t in poses:
            rr = losses.render_slam(other, active, q, t, cam,
                                    {"max_pairs_per_tile": 512,
                                     "span_cap": 2})
            colors.append(rr.im)
            depths.append(rr.depth)
            kfc.append(build_kf_cache(prm, active, q, t, cam, span_cap=2,
                                      max_pairs_per_tile=512,
                                      select="importance"))
    kf = KeyframeBuffer(colors=torch.stack(colors).contiguous(),
                        depths=torch.stack(depths).contiguous(), count=2,
                        frame_ids=[0, 1])
    lrs = {"rgb_colors": 0.0025, "logit_opacities": 0.05,
           "log_scales": 0.001}
    mcfg = MappingConfig(num_iters=iters, lrs=tuple(sorted(lrs.items())),
                         loss_cfg=map_cfg(), use_global=False)
    return dict(prm=prm, kf=kf, kfc=kfc, cam=cam, mcfg=mcfg)


def run_map(c, plain=False, kf=None):
    """map_frame_binned over the case's keyframes with the draws [0, 1, 1,
    ...]; `plain` takes the PyTorch ops on the card instead of the
    kernel. Returns (fields after, loss history)."""
    from vtgaussian_slam_tpu_torch.core.mapping import map_frame_binned
    n = c["mcfg"].num_iters
    with plain_path() if plain else contextlib.nullcontext():
        return map_frame_binned(c["prm"], kf or c["kf"], c["kfc"], [0, 1],
                                c["cam"], c["mcfg"],
                                draws=[0] + [1] * (n - 1))


@pytest.mark.cuda
def test_mapping_iterations_synchronise_nothing(card):
    """No host-device wait in a mapping iteration of the binned loop (the
    SSIM window's upload was one each iteration)."""
    c = map_case(card, iters=4)
    run_map(c)                                   # builds and warms up
    torch.cuda.synchronize()
    n0 = ML.map_loss_forward.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_map(c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ML.map_loss_forward.launches - n0 == 4


def leaf_gaps(a, b, base):
    """Per field leaf (opacity, scale, colours): the norm of a's change
    from `base` minus b's over the norm of b's change."""
    out = []
    for name in ("logit_opacities", "log_scales", "rgb_colors"):
        da = getattr(a, name).double() - getattr(base, name).double()
        db = getattr(b, name).double() - getattr(base, name).double()
        out.append(float(torch.linalg.vector_norm(da - db)
                         / torch.linalg.vector_norm(db)))
    return np.array(out)


@pytest.mark.cuda
def test_three_iterations_land_within_the_plain_paths_one_ulp_spread(
        card):
    """Fields after three iterations with the kernel against the plain
    path on the card, beside the plain path's own spread under keyframe
    colours one ulp up: the kernel's rounding moves the fields no more
    than rounding the inputs does."""
    c = map_case(card)
    fused, h_f = run_map(c)
    plain, h_p = run_map(c, plain=True)
    kf_ulp = c["kf"]._replace(colors=torch.nextafter(
        c["kf"].colors, torch.full_like(c["kf"].colors, 2.0)))
    ulp, _ = run_map(c, plain=True, kf=kf_ulp)
    gap = leaf_gaps(fused, plain, c["prm"])
    spread = leaf_gaps(ulp, plain, c["prm"])
    print(f"fields after 3 iterations: kernel - plain {gap}, one-ulp "
          f"spread {spread}; losses {h_f[:, 0].tolist()} / "
          f"{h_p[:, 0].tolist()}")
    assert (gap <= np.maximum(2 * spread, 1e-6)).all(), (gap, spread)
    # the first iteration's loss (same fields, same keyframe)
    assert abs(float(h_f[0, 0] - h_p[0, 0])) <= 1e-5 * float(h_p[0, 0])


@pytest.mark.cuda
def test_an_engine_counts_every_mapping_iteration_as_fused(card, tmp_path):
    from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
    cfg = smoke_config(tmp_path, frames=4, iters=5)
    eng = VTGaussianSLAM(cfg, device="cuda")
    n0 = ML.map_loss_forward.launches
    try:
        for t in range(4):
            eng.process_frame(t)
        counts = [eng.frame_times[t]["counts"] for t in range(4)]
    finally:
        eng.close()
    assert all(c["map.loss_fused"] == c["map.iters"] == 5 for c in counts)
    # no global term on the smoke run's frames 0-3: one launch a loss
    assert ML.map_loss_forward.launches - n0 == 20
