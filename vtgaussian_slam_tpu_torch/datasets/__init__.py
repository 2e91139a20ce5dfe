"""Dataset factory: the real-data loaders and the synthetic generator, by
the gradslam config's `dataset_name` (the JAX package's `get_dataset`)."""
from .base import RGBDDataset
from .dataconfig import load_dataset_config
from .loaders import (
    Ai2thorDataset,
    AzureKinectDataset,
    ICLDataset,
    KittiDataset,
    NeRFCaptureDataset,
    Record3DDataset,
    RealsenseDataset,
    ReplicaDataset,
    ReplicaV2Dataset,
    ScannetDataset,
    ScannetPPDataset,
    TUMDataset,
)
from .synthetic import SyntheticRoomDataset

_FACTORY = {
    "icl": ICLDataset,
    "replica": ReplicaDataset,
    "replicav2": ReplicaV2Dataset,
    "azure": AzureKinectDataset,
    "azurekinect": AzureKinectDataset,
    "scannet": ScannetDataset,
    "ai2thor": Ai2thorDataset,
    "record3d": Record3DDataset,
    "realsense": RealsenseDataset,
    "tum": TUMDataset,
}


def get_dataset(config_dict, basedir, sequence, **kwargs):
    name = config_dict["dataset_name"].lower()
    if name == "scannetpp":
        return ScannetPPDataset(basedir, sequence, **kwargs)
    if name == "nerfcapture":
        return NeRFCaptureDataset(basedir, sequence, **kwargs)
    if name == "synthetic":
        return SyntheticRoomDataset(**{**config_dict.get("synthetic", {}),
                                       **kwargs})
    if name in _FACTORY:
        return _FACTORY[name](config_dict, basedir, sequence, **kwargs)
    raise ValueError(f"Unknown dataset name {config_dict['dataset_name']}")
