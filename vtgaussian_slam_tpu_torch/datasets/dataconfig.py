"""Dataset/camera YAML config loading with recursive `inherit_from` merge.

The port's own copy of `vtgaussian_slam_tpu/datasets/dataconfig.py`: child
values override parent values, nested dicts merge key by key, and an
inheritance cycle raises. PyYAML is imported when a file is read: the
synthetic configs carry no YAML.
"""
from __future__ import annotations


def _deep_update(base: dict, child: dict) -> dict:
    out = dict(base)
    for k, v in child.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def load_dataset_config(path: str, default_path: str | None = None,
                        _visited: tuple = ()) -> dict:
    import yaml

    if path in _visited:
        chain = " -> ".join(list(_visited) + [path])
        raise ValueError(f"inherit_from cycle: {chain}")
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        raise ValueError(f"empty dataset config: {path}")
    base = {}
    if "inherit_from" in cfg:
        base = load_dataset_config(cfg["inherit_from"], default_path,
                                   _visited + (path,))
    elif default_path is not None:
        with open(default_path, "r") as f:
            base = yaml.safe_load(f) or {}
    return _deep_update(base, cfg)
