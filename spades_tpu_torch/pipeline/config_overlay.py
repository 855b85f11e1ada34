"""User-editable config overlay files.

SPAdes lets users tune every stage threshold through layered `.info`
config files applied on top of the built-ins
(`src/common/configs/config_struct.cpp` + per-mode overlays
under `projects/spades/configs/`, applied in order by
`spades_iteration_stage.py:22-46`).  This module is the same user surface
for the dataclass-based configs: a YAML (or simple `key value` .info-style)
file with per-stage sections is loaded once and overlaid onto the stage
config objects after mode defaults are applied — file wins, exactly like
SPAdes' overlay order (base config -> mode overlay -> user file).

Sections map to config dataclasses:

    simplification:       graph.simplify.SimplifyConfig fields
    path_extend:          paired.path_extend.PEConfig fields
    construction:         {min_count, early_tip_clip, early_at_clip}
    binning:              graph.binning.BinningConfig fields
    corrector:            polish.corrector.CorrectorConfig fields

Unknown sections or field names are a hard error (SPAdes' config
parser also rejects unknown keys) — silent typos in a tuning file are worse
than a crash.
"""
from __future__ import annotations

import dataclasses
import logging

log = logging.getLogger("spades_tpu_torch.config")

KNOWN_SECTIONS = (
    "simplification", "path_extend", "construction", "binning", "corrector",
)

_CONSTRUCTION_KEYS = {"min_count", "early_tip_clip", "early_at_clip"}


def load_overlay(path: str) -> dict:
    """Parse a YAML overlay file (also accepts flat `section.key value`
    .info-style lines).  Returns {section: {key: value}}."""
    with open(path) as fh:
        text = fh.read()
    data = None
    try:
        import yaml

        data = yaml.safe_load(text)
    except Exception:  # noqa: BLE001 — fall through to the .info-ish parser
        data = None
    if not isinstance(data, dict):
        # flat "section.key value" lines
        data = {}
        for ln in text.splitlines():
            ln = ln.split(";")[0].split("#")[0].strip()
            if not ln:
                continue
            key, _, val = ln.partition(" ")
            sec, _, field = key.partition(".")
            if not field or not val.strip():
                raise ValueError(f"config overlay: cannot parse line {ln!r}")
            data.setdefault(sec, {})[field] = _coerce(val.strip())
    for sec in data:
        if sec not in KNOWN_SECTIONS:
            raise ValueError(
                f"config overlay: unknown section {sec!r} (known: {KNOWN_SECTIONS})"
            )
        if not isinstance(data[sec], dict):
            raise ValueError(f"config overlay: section {sec!r} must be a mapping")
    return data


def _coerce(v: str):
    for conv in (int, float):
        try:
            return conv(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def apply_overlay(cfg_obj, overlay: dict | None, section: str):
    """Overlay `overlay[section]` onto a config dataclass instance in place.
    Unknown field names raise.  Returns cfg_obj for chaining."""
    if not overlay or section not in overlay:
        return cfg_obj
    valid = {f.name for f in dataclasses.fields(cfg_obj)}
    for key, val in overlay[section].items():
        if key not in valid:
            raise ValueError(
                f"config overlay: unknown field {section}.{key!r} "
                f"(valid: {sorted(valid)})"
            )
        setattr(cfg_obj, key, val)
        log.info("config overlay: %s.%s = %r", section, key, val)
    return cfg_obj


def construction_kwargs(overlay: dict | None) -> dict:
    """The construction section as Construction-stage kwargs."""
    if not overlay or "construction" not in overlay:
        return {}
    out = {}
    for key, val in overlay["construction"].items():
        if key not in _CONSTRUCTION_KEYS:
            raise ValueError(
                f"config overlay: unknown field construction.{key!r} "
                f"(valid: {sorted(_CONSTRUCTION_KEYS)})"
            )
        out[key] = val
    return out
