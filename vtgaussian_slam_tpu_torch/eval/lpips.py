"""LPIPS (AlexNet backbone) in PyTorch: an eval-only perceptual metric.

Parity: `vtgaussian_slam_tpu/eval/lpips.py`. The reference scores LPIPS
through torchmetrics' pretrained AlexNet; no pretrained weights ship with
the repository, so:

- the architecture (AlexNet feature trunk, per-layer 1x1 linear heads,
  unit-normalised feature differences, spatial mean; Zhang et al. 2018) is
  `AlexNetLPIPS`, and its convolutions run on the eval device (cuDNN on the
  card; the JAX package computes them with `lax.conv`, outside any Pallas
  kernel);
- weights load from an .npz whose arrays follow torch naming
  (`net.slice*.{idx}.weight/bias`, `lin{i}.model.1.weight`; see
  `lpips_convert`) via `load_lpips_weights(path)` or `VTGS_LPIPS_WEIGHTS`;
- without weights, `lpips_fn()` falls back to deterministic seeded
  (untrained) backbone weights with uniform lin heads, drawn with the same
  numpy calls as the JAX package, so the fallback is the same network on
  both sides. Its values compare runs of this system with each other, not
  with published pretrained-AlexNet LPIPS. The returned callable carries
  `.source` ("file" | "untrained-fallback"); VTGS_LPIPS_FALLBACK=0 makes
  `lpips_fn()` return None instead.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.common import resolve_device

# AlexNet feature trunk: (kind, out_ch, kernel, stride, pad)
_ALEX_CFG = [
    ("conv", 64, 11, 4, 2), ("relu",), ("pool",),
    ("conv", 192, 5, 1, 2), ("relu",), ("pool",),
    ("conv", 384, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
]
# features taken at these layer counts (after each of the five relus)
_SLICE_ENDS = (2, 5, 8, 10, 12)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# (name, out_ch, in_ch, kernel) of the AlexNet conv stack, torch-named
_CONV_SHAPES = (
    ("net.slice1.0", 64, 3, 11), ("net.slice2.3", 192, 64, 5),
    ("net.slice3.6", 384, 192, 3), ("net.slice4.8", 256, 384, 3),
    ("net.slice5.10", 256, 256, 3),
)


def load_lpips_weights(path: str | None = None) -> dict | None:
    path = path or os.environ.get("VTGS_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    data = np.load(path)
    return {k: np.asarray(data[k]) for k in data.files}


def synthetic_lpips_weights(seed: int = 0) -> dict:
    """Deterministic untrained-backbone weights: He-scaled conv filters,
    zero biases, uniform 1/C lin heads (the uniform weighting of Zhang et
    al. over unit-normalised feature differences)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, out_c, in_c, k in _CONV_SHAPES:
        fan_in = in_c * k * k
        state[f"{name}.weight"] = (rng.standard_normal((out_c, in_c, k, k))
                                   * np.sqrt(2.0 / fan_in)).astype(np.float32)
        state[f"{name}.bias"] = np.zeros(out_c, np.float32)
    for i, (_, out_c, _, _) in enumerate(_CONV_SHAPES):
        state[f"lin{i}.model.1.weight"] = np.full(
            (1, out_c, 1, 1), 1.0 / out_c, np.float32)
    return state


class AlexNetLPIPS(torch.nn.Module):
    """LPIPS of two (N, 3, H, W) batches in [0, 1] (normalize=True): the
    AlexNet trunk on both, unit-normalised features, squared differences
    weighted by the lin heads, spatial mean, summed over the five taps.
    A trunk that an image is too small for (a pooling window wider than
    its map) gives NaN, as the JAX package's empty reduction does."""

    def __init__(self, convs: list, lins: list):
        super().__init__()
        for i, (w, b) in enumerate(convs):
            self.register_buffer(f"w{i}", torch.as_tensor(np.asarray(w, np.float32)))
            self.register_buffer(f"b{i}", torch.as_tensor(np.asarray(b, np.float32)))
        for i, w in enumerate(lins):
            self.register_buffer(f"lin{i}", torch.as_tensor(
                np.asarray(w, np.float32)).reshape(1, -1, 1, 1))
        self.register_buffer("shift", torch.as_tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.as_tensor(_SCALE).view(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list | None:
        """x (N, 3, H, W) in [-1, 1] -> the five feature maps, or None when
        a layer's output would be empty."""
        feats = []
        h = (x - self.shift) / self.scale
        conv_i = 0
        for li, layer in enumerate(_ALEX_CFG):
            if layer[0] == "conv":
                _, _, k, stride, pad = layer
                if min(h.shape[2:]) + 2 * pad < k:
                    return None
                h = F.conv2d(h, getattr(self, f"w{conv_i}"),
                             getattr(self, f"b{conv_i}"), stride, pad)
                conv_i += 1
            elif layer[0] == "relu":
                h = F.relu(h)
            else:
                if min(h.shape[2:]) < 3:
                    return None
                h = F.max_pool2d(h, 3, 2)
            if li + 1 in _SLICE_ENDS:
                feats.append(h)
        return feats

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        f0 = self.features(2 * img0 - 1)
        f1 = self.features(2 * img1 - 1)
        if f0 is None:
            return torch.full((), float("nan"), device=img0.device)
        total = torch.zeros((), device=img0.device)
        for i, (a, b) in enumerate(zip(f0, f1)):
            d = (_normalize(a) - _normalize(b)) ** 2
            total = total + torch.mean(torch.sum(d * getattr(self, f"lin{i}"),
                                                 dim=1))
        return total


def _normalize(feat, eps=1e-10):
    n = torch.sqrt(torch.sum(feat * feat, dim=1, keepdim=True))
    return feat / (n + eps)


def _remap(weights: dict):
    """(convs [(w, b)] x 5, lins x 5) from torch-style names, or from the
    direct names conv{i}.weight / conv{i}.bias / lin{i}.weight; None when
    neither gives five of each (a weight key without its bias twin means a
    filtered or partial conversion)."""
    convs = []
    try:
        for k in sorted(weights):
            if ".weight" in k and k.startswith("net"):
                convs.append((weights[k], weights[k.replace("weight", "bias")]))
    except KeyError:
        return None
    lins = [weights[k] for k in sorted(weights) if "lin" in k and "weight" in k]
    if len(convs) != 5 or len(lins) != 5:
        try:
            convs = [(weights[f"conv{i}.weight"], weights[f"conv{i}.bias"])
                     for i in range(5)]
            lins = [weights[f"lin{i}.weight"] for i in range(5)]
        except KeyError:
            return None
    return convs, lins


def lpips_fn(weights: dict | None = None, device="cuda"):
    """Build `f(img0, img1) -> float` (with a `.source` attribute) or None.
    Images are (3, H, W) or (1, 3, H, W) in [0, 1], numpy or tensors; the
    network runs on `device`.

    Weights: the explicit `weights` dict, else the VTGS_LPIPS_WEIGHTS npz,
    else the untrained fallback (module docstring; VTGS_LPIPS_FALLBACK=0
    returns None instead)."""
    source = "file"
    if weights is None:
        weights = load_lpips_weights()
        if weights is None and os.environ.get(
                "VTGS_LPIPS_FALLBACK", "1") != "0":
            weights = synthetic_lpips_weights()
            source = "untrained-fallback"
    if weights is None:
        return None
    parts = _remap(weights)
    if parts is None:
        return None
    dev = resolve_device(device)
    net = AlexNetLPIPS(*parts).to(dev)

    @torch.no_grad()
    def score(a, b) -> float:
        x0 = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                             dtype=torch.float32, device=dev)
        x1 = torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b,
                             dtype=torch.float32, device=dev)
        if x0.ndim == 3:
            x0, x1 = x0[None], x1[None]
        return float(net(x0, x1))

    score.source = source
    return score
