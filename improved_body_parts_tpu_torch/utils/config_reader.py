"""Reference-INI compatibility loader (a copy of the JAX package's
``utils/config_reader.py`` over the port's ``configs``).

The reference keeps inference/post-processing thresholds in a configobj INI
file (utils/config, parsed by utils/config_reader.py:6-37). Our single
source of truth is ``configs.InferenceConfig``; this module lets users who
carry a tuned reference INI apply it on top:

    cfg = apply_ini(CanonicalConfig(), "path/to/config")

Parses the configobj dialect (inline ``#`` comments, ``[[1]]`` nested model
section, comma lists) with no configobj dependency.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

from improved_body_parts_tpu_torch.configs import CanonicalConfig


def _parse_value(raw: str):
    raw = raw.split("#", 1)[0].strip()
    if raw.startswith("[") and raw.endswith("]"):
        return [v.strip() for v in raw[1:-1].split(",")]
    if "," in raw:
        return [_parse_value(v) for v in raw.split(",")]
    if raw.startswith(("'", '"')) and raw.endswith(("'", '"')):
        return raw[1:-1]
    try:
        f = float(raw)
        return int(f) if f.is_integer() and "." not in raw else f
    except ValueError:
        return raw


def read_ini(path: str) -> Tuple[Dict, Dict]:
    """Returns (param, model) dicts like the reference config_reader()."""
    sections: Dict[str, Dict] = {}
    stack = [sections]
    current = sections
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = re.match(r"^(\[+)([^\[\]]+)(\]+)\s*$", line)
            if m:
                depth = len(m.group(1))
                name = m.group(2).strip()
                del stack[depth:]
                parent = stack[-1]
                parent[name] = {}
                stack.append(parent[name])
                current = parent[name]
                continue
            if "=" in line:
                key, raw = line.split("=", 1)
                current[key.strip()] = _parse_value(raw)
    param = sections.get("param", {})
    models = sections.get("models", {})
    model = models.get(str(param.get("modelID", 1)), {})
    return param, model


def apply_ini(config: CanonicalConfig, path: str) -> CanonicalConfig:
    """Overlay a reference INI's thresholds onto an InferenceConfig."""
    param, model = read_ini(path)

    def tup(v):
        return tuple(float(x) for x in v) if isinstance(v, list) else (float(v),)

    overrides = {}
    mapping = {
        "scale_search": ("scale_search", tup),
        "thre1": ("thre1", float),
        "thre2": ("thre2", float),
        "connect_ration": ("connect_ration", float),
        "mid_num": ("mid_num", int),
        "len_rate": ("len_rate", float),
        "connection_tole": ("connection_tole", float),
        "offset_radius": ("offset_radius", int),
        "remove_recon": ("remove_recon", lambda v: bool(int(v))),
    }
    for ini_key, (field, conv) in mapping.items():
        if ini_key in param:
            overrides[field] = conv(param[ini_key])
    for ini_key, (field, conv) in {
        "boxsize": ("boxsize", int),
        "padValue": ("pad_value", int),
        "stride": ("stride", int),
        "max_downsample": ("max_downsample", int),
    }.items():
        if ini_key in model:
            overrides[field] = conv(model[ini_key])

    infer = dataclasses.replace(config.infer, **overrides)
    return dataclasses.replace(config, infer=infer)
