"""Checkpoints in the JAX package's ``.npz`` key layout.

The JAX package saves a state pytree as one ``.npz`` whose keys are the
leaves' tree paths as ``jax.tree_util.keystr`` writes them, e.g.
``['params']['t_ext']['block']['layers'][0]['conv']['weight']`` for a dict
key and a list index, and ``['mstate']['t_ext']['res_bn'].mean`` for a
field of the ``BNStats`` NamedTuple.  The port's state is the same nesting
of dictionaries, lists and ``BNStats`` over tensors, so both packages read
each other's files:

* ``save_checkpoint`` writes a port state under those keys;
* ``from_jax_params`` turns such a flat ``{key: array}`` mapping back into
  a port state;
* ``restore_checkpoint`` does both for a file, keeping only the keys under
  the given prefixes (serving needs params and BatchNorm statistics, not the
  optimizer state a training checkpoint also holds).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..ops.batchnorm import BNStats

_TOKEN = re.compile(r"\['([^'\]]*)'\]|\[(\d+)\]|\.(\w+)")


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", v) for k, v in tree.items())
    elif isinstance(tree, BNStats):
        items = ((f".{f}", getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    flat = {}
    for suffix, value in items:
        flat.update(_flatten(value, prefix + suffix))
    return flat


def save_checkpoint(path: str, state) -> None:
    """Serialize a state's tensors keyed by their tree paths."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_flatten(state))


def _parse_key(key: str):
    tokens, pos = [], 0
    for m in _TOKEN.finditer(key):
        if m.start() != pos:
            break
        name, index, field = m.groups()
        if index is not None:
            tokens.append(int(index))  # list index
        elif name is not None:
            tokens.append(name)  # dict key
        else:
            tokens.append("." + field)  # NamedTuple field
        pos = m.end()
    if pos != len(key) or not tokens:
        raise ValueError(f"not a tree-path key: {key!r}")
    return tokens


def _build(node, device):
    if not isinstance(node, dict):
        return torch.from_numpy(np.asarray(node)).to(device)
    keys = list(node)
    if all(isinstance(k, int) for k in keys):
        if sorted(keys) != list(range(len(keys))):
            raise ValueError(f"list indices {sorted(keys)} are not 0..n-1")
        return [_build(node[i], device) for i in range(len(keys))]
    if all(isinstance(k, str) and k.startswith(".") for k in keys):
        if sorted(keys) != [".mean", ".var"]:
            raise ValueError(f"unknown NamedTuple fields {sorted(keys)}")
        return BNStats(_build(node[".mean"], device), _build(node[".var"], device))
    return {k: _build(v, device) for k, v in node.items()}


def from_jax_params(flat: Dict[str, np.ndarray], device="cpu"):
    """A port state (nested dicts, lists and ``BNStats`` of tensors on
    ``device``) from the JAX package's flat ``{keystr: array}`` mapping."""
    root: dict = {}
    for key, value in flat.items():
        tokens = _parse_key(key)
        node = root
        for tok in tokens[:-1]:
            node = node.setdefault(tok, {})
        node[tokens[-1]] = value
    return _build(root, device)


def restore_checkpoint(path: str, prefixes: Optional[Iterable[str]] = None, device="cpu"):
    """Load ``path`` (``.npz`` added if missing) into a port state, keeping
    only the keys that start with one of ``prefixes`` (all when None)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    keep = tuple(prefixes) if prefixes is not None else ("",)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k.startswith(keep)}
    if not flat:
        raise KeyError(f"{path} holds no key under {keep}")
    return from_jax_params(flat, device)
