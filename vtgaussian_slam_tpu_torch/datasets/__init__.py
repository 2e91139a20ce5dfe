"""Dataset factory (the synthetic generator; real-data loaders come later)."""
from .synthetic import SyntheticRoomDataset


def get_dataset(config_dict, basedir, sequence, **kwargs):
    name = config_dict["dataset_name"].lower()
    if name == "synthetic":
        return SyntheticRoomDataset(**{**config_dict.get("synthetic", {}),
                                       **kwargs})
    raise NotImplementedError(
        f"dataset {config_dict['dataset_name']!r}: the port reads the "
        "synthetic generator only so far")
