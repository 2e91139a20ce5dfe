"""A tum-style section boundary on the generic route against the JAX engine.

Both engines run the 40 x 48 proxy of test_torch_slice.py with
selection_style "tum", baseframe_every 2 and overlap_every 1 for 4 frames
on the generic route (render from scratch every iteration; the JAX
engine's Pallas blend in interpret mode). Frame 2 is the boundary: the
all-pixel visibility scoring picks the candidate section, phase 1 tracks
against it by loss for 31 iterations, phase 2 resets the candidate metric
and runs the remaining 2 iterations with the visibility-masked loss and
the point-to-plane metric; frames 2 and 3 map with the global term over
the concat of sections (0, 0). The port gets the JAX engine's mapping
draws injected (test_torch_boundaries.py).

Tolerances as in test_torch_boundaries.py (each frame tracked from the
JAX engine's state): counts and selections exact, tracked poses within
2e-4 but for one near-tie frame held to one Adam step, trained fields
every entry within Adam's reach and on the JAX engine's own rounding
spread (its runs on one-ulp frames with the first run's poses).
The generic route bins afresh every mapping iteration, so a pair at the
edge of a tile's reach that one side bins and the other not changes which
pairs a saturated tile's depth window keeps (at frame 0 here tile 4 keeps
three Gaussians in the JAX engine, among them 1659, and three others in
the port and in the JAX package's own op-by-op evaluation)"""
from test_torch_boundaries import (_assert_fields, _assert_poses, _jax_spread,
                                   _run_pair)
from test_torch_slice import _config
from torch_port_util import first_exp_spent  # noqa: F401

FRAMES = 4


def test_tum_style_generic_route_matches(tmp_path):
    cfg = _config(tmp_path)
    cfg.update(baseframe_every=2, selection_style="tum", overlap_every=1,
               far_depth_factor=2.0)
    cfg["tpu"].update(track_cache=False, map_binned=False)
    # phase 1 takes min(31, num_iters) iterations: 33 leaves phase 2 two
    cfg["tracking"]["num_iters"] = 33
    jeng, teng, jstates, tstates, rec, tracked = _run_pair(tmp_path, cfg,
                                                            FRAMES)
    for t, (j, p) in enumerate(zip(jstates, tstates)):
        assert p == j, (t, p, j)
    assert len(teng.sections) == 2
    assert tstates[-1]["earliest_corr"] == [[2, "selected_baseframes", [0]]]
    assert tstates[-1]["fixed"] == (0, 0)
    _assert_poses(tracked, jeng, cfg["tracking"]["lrs"])
    _assert_fields(teng, jeng, cfg, FRAMES, _jax_spread(cfg, jeng, FRAMES))
