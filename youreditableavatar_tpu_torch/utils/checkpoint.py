"""Checkpoint / resume: training-state files and flat npz checkpoints.

Counterpart of `youreditableavatar_tpu/utils/checkpoint.py`:

  * `save_state` / `load_state` — one `torch.save` file holding the dict
    {params, opt_state, step, epoch, extra} that the JAX package writes with
    orbax: `params` a module's `state_dict()`, `opt_state` the optimizer's
    `state_dict()`, read back with `weights_only=True`. Orbax's directory
    format is not carried over, and neither is `restore_like` (it rebuilds
    optax NamedTuple states from orbax's dict form; a torch optimizer loads
    its own `state_dict`).
  * `load_module_weights` — only the parameters under a key prefix
    ("geometry.*" slicing), ready for `module.load_state_dict`.
  * `save_simple` / `load_simple` — the texture stages' flat npz layout:
    leaf i of tree `name` as `name__i`, in JAX's pytree order (dict keys
    sorted; lists, tuples and NamedTuples in order; None holds no leaf),
    plus the tree's structure as text under `__treedef__name`. A file
    written by either package loads in the other against a template.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import Tensor


def _state(obj: Any) -> Any:
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _storable(x: Any) -> Any:
    """numpy arrays as tensors (`weights_only` loading reads no numpy)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, dict):
        return {k: _storable(v) for k, v in x.items()}
    return x


def save_state(
    path: str,
    params: Any,
    opt_state: Any = None,
    step: int = 0,
    epoch: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a training-state checkpoint to the file `path` (atomically)."""
    state = {"params": _state(params), "step": int(step), "epoch": int(epoch)}
    if opt_state is not None:
        state["opt_state"] = _state(opt_state)
    if extra:
        state["extra"] = _storable(extra)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_state(path: str, map_location=None) -> Dict[str, Any]:
    """Read a `save_state` checkpoint; `map_location` as for `torch.load`."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def load_module_weights(path: str, module_prefix: str, map_location=None
                        ) -> Dict[str, Tensor]:
    """The saved parameters under `module_prefix` (e.g. "geometry"), with
    the prefix stripped: a state dict for that submodule."""
    params = load_state(path, map_location)["params"]
    prefix = module_prefix.strip(".")
    if not prefix:
        return dict(params)
    cut = prefix + "."
    return {k[len(cut):]: v for k, v in params.items() if k.startswith(cut)}


# ---- flat npz checkpoints in JAX's pytree order ----------------------------

def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Append `tree`'s leaves in JAX's order; return its structure as JAX's
    `PyTreeDef` prints it."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        items = ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                          for k in sorted(tree))
        return "{" + items + "}"
    if _is_namedtuple(tree):
        kids = ", ".join(_flatten(v, leaves) for v in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{kids}])"
    if isinstance(tree, list):
        return "[" + ", ".join(_flatten(v, leaves) for v in tree) + "]"
    if isinstance(tree, tuple):
        kids = [_flatten(v, leaves) for v in tree]
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    leaves.append(tree)
    return "*"


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return leaves.pop(0)


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def save_simple(path: str, **arrays) -> None:
    """Texture-stage style flat checkpoint (npz)."""
    flat = {}
    for name, tree in arrays.items():
        leaves: List[Any] = []
        treedef = f"PyTreeDef({_flatten(tree, leaves)})"
        flat[f"__treedef__{name}"] = np.frombuffer(treedef.encode(),
                                                   dtype=np.uint8)
        for i, leaf in enumerate(leaves):
            flat[f"{name}__{i}"] = _host(leaf)
    np.savez(path, **flat)


def load_simple(path: str, templates: Dict[str, Any]) -> Dict[str, Any]:
    """Load a `save_simple` checkpoint into template-structured trees of
    tensors (on each template leaf's device where it is a tensor)."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for name, template in templates.items():
            shape: List[Any] = []
            _flatten(template, shape)
            restored = [
                torch.as_tensor(z[f"{name}__{i}"],
                                device=t.device if isinstance(t, Tensor) else None)
                for i, t in enumerate(shape)
            ]
            out[name] = _unflatten(template, restored)
    return out
