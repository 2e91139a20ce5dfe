"""The port's config intake (core/config.py:prepare_config) refuses the JAX
engine's tuning keys it does not implement (`RETIRED_TPU`): each at
another value raises a ValueError naming it, and a config that spells the
value the port implements runs as one that leaves the key out."""
import pytest

from vtgaussian_slam_tpu_torch.core.config import RETIRED_TPU, prepare_config

# a value of each retired key that the port does not implement
OTHER = {"two_class_frac": 0.25, "two_class_sparse_div": 2,
         "track_rebin_every": 20, "map_cache_refresh": 2,
         "trunc_probe_every": 5, "map_cache_slots": 8,
         "map_max_pairs_per_tile": 1024}


@pytest.mark.parametrize("key", sorted(RETIRED_TPU))
def test_retired_tpu_options_are_refused(key):
    with pytest.raises(ValueError, match=f"tpu.{key}="):
        prepare_config({"tpu": {"max_pairs_per_tile": 512, key: OTHER[key]}})


def test_retired_tpu_options_at_their_value_are_accepted():
    tpu = {"max_pairs_per_tile": 256, "two_class_frac": 0.0,
           "two_class_sparse_div": 4, "track_rebin_every": 0,
           "map_cache_refresh": 1, "trunc_probe_every": 10,
           "map_cache_slots": 64, "map_max_pairs_per_tile": 256}
    assert set(tpu) - {"max_pairs_per_tile"} == set(RETIRED_TPU)
    out = prepare_config({"tpu": tpu})["tpu"]
    bare = prepare_config({"tpu": {"max_pairs_per_tile": 256}})["tpu"]
    assert {k: v for k, v in out.items() if k not in RETIRED_TPU} == bare
