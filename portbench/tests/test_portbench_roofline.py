"""The frozen roofline counts give chip_smoke.py's numbers on toy inputs,
and the reference and the measuring code load nothing of JAX."""
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from portbench.harness import roofline as rl
from portbench.reference.ops.camera import Camera
from portbench.reference.ops.rasterizer import cuda_splat as rsplat
from portbench.harness.spec import ROOT


def toy_slots(T=6, M=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    tiles_x = 3
    slots = torch.zeros((T, 8, M))
    tx = (torch.arange(T) % tiles_x).float()[:, None] * 16 + 8
    ty = (torch.arange(T) // tiles_x).float()[:, None] * 16 + 8
    z = 2.0 + torch.rand((T, M), generator=g)
    slots[:, 0] = (tx - 24 + 6 * torch.randn((T, M), generator=g)) / 32 * z
    slots[:, 1] = (ty - 16 + 6 * torch.randn((T, M), generator=g)) / 32 * z
    slots[:, 2] = z
    slots[:, 3] = torch.randn((T, M), generator=g)
    slots[:, 4] = torch.log(0.02 + 0.03 * torch.rand((T, M), generator=g))
    slots[:, 5:] = torch.rand((T, 3, M), generator=g)
    counts = torch.randint(M // 2, M + 1, (T,), generator=g).int()
    cam = Camera(height=32, width=48, fx=32.0, fy=32.0, cx=23.5, cy=15.5)
    R9 = torch.eye(3).reshape(9)
    return slots, counts, rsplat.cp_vector(R9, torch.zeros(3), cam), tiles_x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_work_and_bound_match_chip_smoke(seed, monkeypatch):
    slots, counts, cp, tiles_x = toy_slots(seed=seed)
    monkeypatch.setattr(chip_smoke, "batched", lambda T, size: (
        torch.arange(s, min(T, s + size)) for s in range(0, T, size)))
    ref = chip_smoke.splat_work(slots, counts, cp, tiles_x)
    got = rl.walk_work(slots, counts, cp, tiles_x)
    assert got["walked"] > 0 and got["blended"] > 0
    for k in ("walked", "blended", "slots"):
        assert got[k] == ref[k], k
    T, _, M = slots.shape
    for name in ("K2", "K3"):
        nbytes = rl.kernel_bytes(name, T, M, got["slots"])
        smoke_bytes = (got["slots"] * 8 * 4 + T * 4 + 2 * T * 8 * 256 * 4
                       + (T * 12 * 4 if name == "K2" else T * M * 8 * 4))
        assert nbytes == smoke_bytes
        b, by = rl.bound_s(name, got, nbytes)
        ms, by_s = chip_smoke.bound(name, nbytes, ref)
        assert b * 1e3 == pytest.approx(ms, rel=1e-12) and by == by_s


def _loaded_after(imports: str) -> set:
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    return set(out.stdout.split())


def test_reference_loads_neither_jax_nor_the_port():
    mods = _loaded_after(
        "import portbench.reference.core.tracking, "
        "portbench.reference.core.map_cache, portbench.reference.core.densify, "
        "portbench.reference.models.optimizer, portbench.reference.ops.image")
    for bad in ("jax", "jaxlib", "flax", "vtgaussian_slam_tpu",
                "vtgaussian_slam_tpu_torch"):
        assert bad not in mods, bad


def test_harness_loads_no_jax():
    from portbench.harness.session import FORBIDDEN
    mods = _loaded_after(
        "import portbench.harness.session, portbench.harness.check, "
        "portbench.harness.sequence, portbench.harness.roofline, "
        "vtgaussian_slam_tpu_torch.core.pipeline")
    assert "vtgaussian_slam_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_guard_compares_whole_top_level_names(monkeypatch):
    from portbench.harness import session
    monkeypatch.setitem(sys.modules, "vtgaussian_slam_tpu_torch_x", object())
    assert "vtgaussian_slam_tpu" not in session.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vtgaussian_slam_tpu.core", object())
    assert session.forbidden_modules() == ["vtgaussian_slam_tpu"]
