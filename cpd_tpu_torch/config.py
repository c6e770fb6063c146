"""YAML config system with ``_BASE_CONFIG_`` inheritance and CLI overrides
(port of cpd_tpu/config.py).

The same ``ConfigDict``, ``merge_new_config``, ``cfg_from_yaml_file``,
``cfg_from_list`` and global ``cfg`` as the JAX package, reading yaml with
``utils.yaml_subset`` instead of PyYAML (the card's machine has none).
"""
from __future__ import annotations

import ast
import copy
from pathlib import Path

from .utils.yaml_subset import load_file


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        elif isinstance(value, list):
            value = [ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v
                     for v in value]
        super().__setitem__(key, value)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get(self, key, default=None):
        return dict.get(self, key, default)

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigDict) else x for x in v]
            else:
                out[k] = v
        return out


def merge_new_config(config: ConfigDict, new_config: dict) -> ConfigDict:
    """Recursively merge ``new_config`` into ``config``, loading ``_BASE_CONFIG_`` first."""
    if "_BASE_CONFIG_" in new_config:
        merge_new_config(config, load_file(new_config["_BASE_CONFIG_"]))
    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), dict):
                config[key] = ConfigDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config: ConfigDict | None = None) -> ConfigDict:
    config = config if config is not None else ConfigDict()
    merge_new_config(config, load_file(cfg_file))
    config["TAG"] = Path(cfg_file).stem
    config["EXP_GROUP_PATH"] = "/".join(str(cfg_file).split("/")[1:-1])
    return config


def cfg_from_list(cfg_list, config: ConfigDict) -> ConfigDict:
    """Set config keys from a ``[KEY1, V1, KEY2, V2, ...]`` list (CLI ``--set``)."""
    if len(cfg_list) % 2:
        raise ValueError(f"override list must be key/value pairs, got {list(cfg_list)}")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                d[subkey] = ConfigDict()
            d = d[subkey]
        subkey = key_list[-1]
        try:
            value = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if subkey in d and d[subkey] is not None and type(value) is not type(d[subkey]):
            # allow int->float promotion; otherwise keep strictness like the reference
            if isinstance(value, int) and isinstance(d[subkey], float):
                value = float(value)
            elif not isinstance(d[subkey], (ConfigDict, dict)):
                raise ValueError(f"type mismatch for {full_key}: {type(value)} vs "
                                 f"{type(d[subkey])}")
        d[subkey] = value
    return config


# global config namespace, like the reference's `from cpd.config import cfg`
cfg = ConfigDict()
cfg["LOCAL_RANK"] = 0
