"""Dataclass + YAML + dotlist config system.

Counterpart of `youreditableavatar_tpu/utils/config.py` (plain Python, the
same code); `yaml` is imported inside the functions that parse with it.

Capability parity with the reference config stack (`tetgs_spatial/utils/config.py:11-124`
plus `utils/base.py:57-64`): YAML experiment files, ``key.sub=value`` CLI dotlist
overrides, and per-component re-parsing of a raw dict into a typed nested
dataclass. One system spans all pipeline stages (the reference hand-codes the
texture stages); scheduled values stay as raw lists interpreted by
:func:`youreditableavatar_tpu_torch.utils.schedule.C`.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


def _coerce(value: Any, annot: Any) -> Any:
    """Best-effort coercion of a YAML/CLI value into the annotated type."""
    if annot is Any or value is None:
        return value
    origin = get_origin(annot)
    if origin is Union:
        args = [a for a in get_args(annot) if a is not type(None)]
        if value is None:
            return None
        for a in args:
            try:
                return _coerce(value, a)
            except (TypeError, ValueError):
                continue
        return value
    if is_dataclass(annot) and isinstance(value, dict):
        return parse_structured(annot, value)
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        args = get_args(annot)
        elem = args[0] if args else Any
        out = [_coerce(v, elem) for v in value]
        return tuple(out) if origin is tuple else out
    if origin is dict and isinstance(value, dict):
        return dict(value)
    if annot is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if annot in (int, float, str) and not isinstance(value, (list, dict)):
        # Scheduled hyperparameters are lists even when annotated scalar — keep them.
        return annot(value)
    return value


def parse_structured(cls: Type[T], cfg: Optional[Dict[str, Any]] = None) -> T:
    """Parse a raw dict into dataclass ``cls``, recursing into nested dataclasses.

    Unknown keys raise (the reference's OmegaConf struct mode behaves the same);
    scheduled list values pass through untouched.
    """
    cfg = dict(cfg or {})
    if not is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    kwargs: Dict[str, Any] = {}
    known = {f.name: f for f in fields(cls)}
    for key, value in cfg.items():
        if key not in known:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        annot = known[key].type
        if isinstance(value, list) and not (
            get_origin(annot) in (list, tuple) or annot in (list, tuple)
        ):
            kwargs[key] = value  # schedule spec, e.g. [0, 0.98, 0.5, 5000]
        else:
            kwargs[key] = _coerce(value, annot)
    return cls(**kwargs)


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(f"cannot descend into non-dict at {k!r} of {dotted!r}")
    node[keys[-1]] = value


def _parse_cli_value(raw: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def apply_dotlist(cfg: Dict[str, Any], dotlist: List[str]) -> Dict[str, Any]:
    """Apply ``key.sub=value`` overrides in place (values YAML-parsed)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist override must look like key=value, got {item!r}")
        key, raw = item.split("=", 1)
        _set_dotted(cfg, key.strip(), _parse_cli_value(raw))
    return cfg


@dataclass
class ExperimentConfig:
    """Top-level experiment config (reference: `utils/config.py:38-77`)."""

    name: str = "default"
    tag: str = ""
    exp_root_dir: str = "outputs"
    seed: int = 0
    system_type: str = ""
    data_type: str = ""
    data: Dict[str, Any] = field(default_factory=dict)
    system: Dict[str, Any] = field(default_factory=dict)
    trial_name: str = ""
    resume: Optional[str] = None
    trainer: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Dict[str, Any] = field(default_factory=dict)

    @property
    def trial_dir(self) -> str:
        parts = [self.exp_root_dir, self.name]
        if self.trial_name:
            parts.append(self.trial_name)
        elif self.tag:
            parts.append(self.tag)
        return os.path.join(*parts)


def load_config(
    path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> ExperimentConfig:
    """Load a YAML experiment config, apply CLI dotlist overrides, return typed cfg."""
    raw: Dict[str, Any] = {}
    if path is not None:
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    if extra:
        raw.update(extra)
    if overrides:
        apply_dotlist(raw, overrides)
    return parse_structured(ExperimentConfig, raw)


def to_dict(cfg: Any) -> Any:
    """Recursively convert dataclasses to plain dicts (for snapshotting)."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg
