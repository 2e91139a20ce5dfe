"""The port's LPIPS and its checkpoint converter against the JAX package's.

Tolerance: 1e-5 relative on the score (f32 convolutions, norms and means
summed in another order; the scores are ~2e-3 for the untrained fallback
and ~1e-1 for random trained-layout weights, far from 0). The random torch
LPIPS state dict is built as `tests/test_lpips_convert.py` builds it (the
`lpips` package's key layout) and converted by the port's own
`lpips_convert`; the JAX side reads the .npz that conversion writes.
"""
import numpy as np
import pytest
import torch

from test_lpips_convert import _random_state_dict, _torch_lpips
from vtgaussian_slam_tpu.eval import lpips as JL
from vtgaussian_slam_tpu_torch.eval import lpips as TL
from vtgaussian_slam_tpu_torch.eval import lpips_convert as TC

SIZES = [(48, 64), (96, 128), (75, 91)]


@pytest.fixture(autouse=True, scope="module")
def _first_exp_spent():
    """In a process that also imports JAX, the first multi-threaded
    `torch.exp` on the CPU can come back ~1e-4 off on one thread's share of
    the tensor; later calls are exact. Spend that first call here."""
    torch.exp(torch.randn(1 << 20))


def _pair(hw, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3,) + hw).astype(np.float32)
    b = np.clip(a + noise * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    return a, b


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("hw", SIZES)
def test_untrained_fallback_matches_jax(hw, monkeypatch):
    monkeypatch.delenv("VTGS_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("VTGS_LPIPS_FALLBACK", raising=False)
    j, t = JL.lpips_fn(), TL.lpips_fn(device="cpu")
    assert j.source == t.source == "untrained-fallback"
    a, b = _pair(hw)
    assert _rel(t(a, b), j(a, b)) <= 1e-5
    # (1, 3, H, W) batches and tensors score the same
    assert t(torch.as_tensor(a)[None], torch.as_tensor(b)[None]) == t(a, b)
    assert t(a, a) < 1e-6


def test_fallback_weights_are_jax_draws():
    want, got = JL.synthetic_lpips_weights(), TL.synthetic_lpips_weights()
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_too_small_for_the_trunk_is_nan():
    """24x32 leaves the second pooling window wider than its map: JAX's
    empty reduction gives NaN, and so does the port."""
    a, b = _pair((24, 32))
    assert np.isnan(JL.lpips_fn()(a, b))
    assert np.isnan(TL.lpips_fn(device="cpu")(a, b))


@pytest.mark.parametrize("wrap", ["lpips", "torchmetrics"])
def test_converted_weights_match_jax_and_torch_forward(tmp_path, wrap):
    state = _random_state_dict(3)
    saved = state if wrap == "lpips" else {
        **{f"net.{k}": v for k, v in state.items()},
        "sum_scores": torch.zeros(()), "total": torch.zeros(())}
    pth, npz = tmp_path / "lpips.pth", tmp_path / "lpips.npz"
    torch.save(saved, str(pth))
    out = TC.convert(str(pth), str(npz))
    assert sorted(out) == sorted(state)
    w_t, w_j = TL.load_lpips_weights(str(npz)), JL.load_lpips_weights(str(npz))
    t, j = TL.lpips_fn(w_t, device="cpu"), JL.lpips_fn(w_j)
    assert t.source == j.source == "file"
    for hw in SIZES:
        a, b = _pair(hw, seed=1, noise=0.2)
        got = t(a, b)
        assert _rel(got, j(a, b)) <= 1e-5, hw
        ref = _torch_lpips(state, torch.from_numpy(a)[None],
                           torch.from_numpy(b)[None])
        assert _rel(got, ref) <= 1e-5, hw


def test_weights_from_the_environment(tmp_path, monkeypatch):
    state = TC.convert_state_dict(_random_state_dict(4))
    np.savez(tmp_path / "w.npz", **state)
    monkeypatch.setenv("VTGS_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    t, j = TL.lpips_fn(device="cpu"), JL.lpips_fn()
    assert t.source == j.source == "file"
    a, b = _pair((48, 64), seed=2)
    assert _rel(t(a, b), j(a, b)) <= 1e-5
    monkeypatch.setenv("VTGS_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    monkeypatch.setenv("VTGS_LPIPS_FALLBACK", "0")
    assert TL.lpips_fn(device="cpu") is None and JL.lpips_fn() is None
    monkeypatch.setenv("VTGS_LPIPS_FALLBACK", "1")
    assert TL.lpips_fn(device="cpu").source == "untrained-fallback"


def test_name_remapping_and_its_none_paths():
    w = TL.synthetic_lpips_weights(5)
    # direct names conv{i}.weight / conv{i}.bias / lin{i}.weight
    names = [n for n, *_ in TL._CONV_SHAPES]
    direct = {}
    for i, n in enumerate(names):
        direct[f"conv{i}.weight"] = w[f"{n}.weight"]
        direct[f"conv{i}.bias"] = w[f"{n}.bias"]
        direct[f"lin{i}.weight"] = w[f"lin{i}.model.1.weight"]
    a, b = _pair((48, 64), seed=3)
    want = JL.lpips_fn(dict(direct))(a, b)
    assert _rel(TL.lpips_fn(direct, device="cpu")(a, b), want) <= 1e-5
    assert _rel(TL.lpips_fn(w, device="cpu")(a, b), want) <= 1e-5
    # a weight without its bias twin, or a lin head short: None on both
    for drop in ("net.slice2.3.bias", "lin4.model.1.weight"):
        part = {k: v for k, v in w.items() if k != drop}
        assert TL.lpips_fn(part, device="cpu") is None
        assert JL.lpips_fn(part) is None
