"""What the drivers share: the port's configuration built from a
configuration file, and the run's seeds."""

from __future__ import annotations

import dataclasses
from typing import Dict

from portbench import gen


def port_config(conf: Dict, seed: int):
    """The port's ``Config`` for a cell: the file's preset, each of its
    groups laid over it, the dtypes of its ``precision``, and the run's
    seeds for the dropout stream and the batch order. A key of a group
    that the port's configuration does not have raises: a misspelt width
    would otherwise run the preset's value under the file's name."""
    from vag_nmt_tpu_torch.core import config as pc

    cfg = pc.preset(conf["preset"])
    groups = {"model": pc.ModelConfig, "data": pc.DataConfig,
              "train": pc.TrainConfig, "decode": pc.DecodeConfig}
    upd = {}
    for group, cls in groups.items():
        names = {f.name for f in dataclasses.fields(cls)}
        vals = conf.get(group, {})
        unknown = sorted(set(vals) - names)
        if unknown:
            raise KeyError(f"{conf['name']}: {group} has no key "
                           f"{', '.join(unknown)} in the port's configuration")
        upd[group] = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in vals.items()}
    upd["decode"]["compute_dtype"] = conf["precision"]["decode"]
    upd["model"]["compute_dtype"] = conf["precision"]["train"]
    upd["train"]["seed"] = gen.sub_seed(seed, "dropout", 31)
    upd["data"]["shuffle_seed"] = gen.sub_seed(seed, "order", 31)
    return cfg.replace(**upd)
