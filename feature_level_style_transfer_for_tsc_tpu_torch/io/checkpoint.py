"""Checkpoints in the JAX package's ``.npz`` key layout.

The JAX package saves a state pytree as one ``.npz`` whose keys are the
leaves' tree paths as ``jax.tree_util.keystr`` writes them, e.g.
``['params']['t_ext']['block']['layers'][0]['conv']['weight']`` for a dict
key and a list index, and ``['mstate']['t_ext']['res_bn'].mean`` for a
field of a NamedTuple (``BNStats``, ``NoiseTransferState``, ``CriticState``).
The port's state is the same nesting of dictionaries, lists and those
NamedTuples over tensors, so both packages read each other's files:

* ``save_checkpoint`` writes a port state under those keys (``flatten``
  gives the flat mapping, ``save_flat`` writes one);
* ``from_jax_params`` turns such a flat ``{key: array}`` mapping back into
  a port state;
* ``restore_checkpoint`` does both for a file, keeping only the keys under
  the given prefixes (serving needs params and BatchNorm statistics, not the
  optimizer state a training checkpoint also holds); ``load_flat`` reads
  the flat mapping alone.

A leaf is a tensor, a numpy array or a numpy or Python scalar (the counters,
flags and learning rates of a full training state); any NamedTuple is
written by its fields.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..models.adapters import NoiseTransferState
from ..models.critics import CriticState
from ..ops.batchnorm import BNStats

#: the NamedTuples of a state, by their sorted field names
_NAMED = {}
_TOKEN = re.compile(r"\['([^'\]]*)'\]|\[(\d+)\]|\.(\w+)")


def register_namedtuples(*types) -> None:
    """Let ``from_jax_params`` rebuild these NamedTuples from their fields."""
    for t in types:
        fields = tuple(sorted(t._fields))
        if _NAMED.setdefault(fields, t) is not t:
            raise ValueError(f"{t.__name__} and {_NAMED[fields].__name__} share fields {fields}")


register_namedtuples(BNStats, NoiseTransferState, CriticState)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(key, leaf) of every leaf of a tree of dicts, lists and NamedTuples,
    in order."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, bool, int, float)):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", v) for k, v in tree.items())
    elif hasattr(tree, "_fields"):
        items = ((f".{f}", getattr(tree, f)) for f in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {prefix!r}")
    for suffix, value in items:
        yield from tree_items(value, prefix + suffix)


def flatten(tree) -> Dict[str, np.ndarray]:
    """``{key: array}`` of a tree's leaves, keyed by their tree paths."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tree_items(tree)}


def save_flat(path: str, flat: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def save_checkpoint(path: str, state) -> None:
    """Serialize a state's leaves keyed by their tree paths."""
    save_flat(path, flatten(state))


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
        t = torch.from_numpy(np.array(node))
        # integer scalars are host counters (NoiseTransfer, critics)
        return t if t.dim() == 0 and not t.is_floating_point() else t.to(device)
    keys = list(node)
    if all(isinstance(k, int) for k in keys):
        if sorted(keys) != list(range(len(keys))):
            raise ValueError(f"list indices {sorted(keys)} are not 0..n-1")
        return [_build(node[i], device) for i in range(len(keys))]
    if all(isinstance(k, str) and k.startswith(".") for k in keys):
        named = _NAMED.get(tuple(sorted(k[1:] for k in keys)))
        if named is None:
            raise ValueError(f"unknown NamedTuple fields {sorted(keys)}")
        return named(**{f: _build(node["." + f], device) for f in named._fields})
    return {k: _build(v, device) for k, v in node.items()}


def from_jax_params(flat: Dict[str, np.ndarray], device="cpu"):
    """A port state (nested dicts, lists and NamedTuples of tensors on
    ``device``) from the JAX package's flat ``{keystr: array}`` mapping."""
    root: dict = {}
    for key, value in flat.items():
        tokens = _parse_key(key)
        node = root
        for tok in tokens[:-1]:
            node = node.setdefault(tok, {})
        node[tokens[-1]] = value
    return _build(root, device)


def load_flat(path: str, prefixes: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """The ``{key: array}`` mapping of ``path`` (``.npz`` added if missing),
    only the keys that start with one of ``prefixes`` (all when None)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    keep = tuple(prefixes) if prefixes is not None else ("",)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k.startswith(keep)}
    if not flat:
        raise KeyError(f"{path} holds no key under {keep}")
    return flat


def restore_checkpoint(path: str, prefixes: Optional[Iterable[str]] = None, device="cpu"):
    """Load ``path`` into a port state, keeping only the keys under
    ``prefixes`` (all when None)."""
    return from_jax_params(load_flat(path, prefixes), device)
