"""The frames the check samples: in every scene family a frame drawn from
the seed that is no section boundary, and the first section boundary, so
that every seed of a cell checks the same numbers."""
import numpy as np
import pytest
import torch

from portbench.harness.session import MEM_FRAMES, check_frames
from portbench.harness.spec import load_cell
from portbench.tests.tiny import run_tiny, tiny_cell

FIRST = MEM_FRAMES + 2
SEEDS = list(range(64)) + [2**31 - 1, 2**31 + 12345, 2147447777]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def replica_rule(cfg: dict, seed: int, first: int) -> list[int]:
    """The rule before every scene family sampled a boundary: one frame
    among `first` to `first` + 2, and the boundary for Replica alone."""
    rng = np.random.default_rng([int(seed), 11])
    frames = [first + int(rng.integers(0, 3))]
    bfe = int(cfg["baseframe_every"])
    b = bfe * -(-first // bfe)
    if b not in frames:
        frames.append(b)
    return frames


@pytest.mark.parametrize("cell,boundary", [("room0.scan", 40),
                                           ("fr1.desk", 60)])
def test_every_family_samples_its_first_boundary(cell, boundary, fr1_root):
    cfg = load_cell(cell, fr1_root).config["config"]
    drawn = {}
    for seed in SEEDS:
        split, b = check_frames(cfg, seed, FIRST)
        assert b == boundary
        drawn.setdefault(split, seed)
        if cell == "room0.scan":
            assert [split, b] == replica_rule(cfg, seed, FIRST)
    assert sorted(drawn) == [FIRST, FIRST + 1, FIRST + 2]
    # at the tiny size a boundary falls among the three frames: the draw
    # passes over it
    tiny = tiny_cell(cell, fr1_root).config["config"]
    assert {tuple(check_frames(tiny, s, 2)) for s in SEEDS} == {
        (2, 3), (4, 3), (5, 3)}


@pytest.mark.parametrize("seed", [0, 2, 1])     # draws frames 2, 4 and 5
def test_every_seed_of_a_tum_cell_checks_every_number(seed, fr1_root,
                                                      tmp_path):
    cfg = tiny_cell("fr1.desk", fr1_root).config["config"]
    split, _ = check_frames(cfg, seed, 2)
    assert split == {0: 2, 2: 4, 1: 5}[seed]
    r = run_tiny("fr1.desk", tmp_path, root=fr1_root, seed=seed)
    assert r["correct"], r["check"]
    assert set(r["check"]) == set(load_cell("fr1.desk", fr1_root).limits)
    assert all(c["value"] is not None for c in r["check"].values())
