"""The benchmark's weights: drawn on the device from the seed, in a few large calls.

``materialize`` walks a tree of ``reference.model.Leaf`` specs and gives every leaf a
leading axis of ``runs``: one ``torch.rand`` for all uniform leaves of all runs, one
``torch.randn`` for the normal ones and the rotations, each from a ``torch.Generator`` on
the device seeded from the benchmark's seed.  The same seed on the same device gives the
same weights, so the reference draws them again after the window rather than keeping a
copy.  ``served_members`` turns classifier weights into members whose predictions vary.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import model

_INT = torch.int32


def _walk(tree, fn):
    if isinstance(tree, model.Leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, fn) for v in tree))
    return [_walk(v, fn) for v in tree]


def _specs(tree):
    out = []
    _walk(tree, lambda leaf: out.append(leaf))
    return out


def materialize(specs, runs: int, seed: int, device) -> dict:
    """Every leaf of ``specs`` as a tensor of shape (runs, *shape) on ``device``; host int32
    counters are 0-d CPU tensors shared by the runs."""
    leaves = _specs(specs)
    n_u = sum(int(np.prod(l.shape)) for l in leaves if l.kind == "u")
    n_n = sum(int(np.prod(l.shape)) for l in leaves if l.kind in ("n", "orth"))
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    uni = torch.rand((runs, n_u), generator=gen, device=device).mul_(2.0).sub_(1.0)
    nrm = torch.randn((runs, n_n), generator=gen, device=device)
    cursor = {"u": 0, "n": 0}

    def take(kind: str, shape) -> torch.Tensor:
        n = int(np.prod(shape))
        src = uni if kind == "u" else nrm
        at = cursor[kind]
        cursor[kind] = at + n
        return src[:, at:at + n].reshape(runs, *shape)

    def draw(leaf: model.Leaf):
        if leaf.kind == "int":
            return torch.tensor(leaf.arg, dtype=_INT)
        if leaf.kind == "c":
            return torch.full((runs, *leaf.shape), float(leaf.arg), device=device)
        if leaf.kind == "wn_g":
            return None  # filled from its sibling "v" below
        if leaf.kind == "u":
            bound = torch.as_tensor(leaf.arg, dtype=torch.float32, device=device)
            t = take("u", leaf.shape) * bound
            if leaf.mask is not None:
                t = t * torch.as_tensor(leaf.mask, device=device)
            return t.contiguous()
        if leaf.kind == "n":
            return (take("n", leaf.shape) * float(leaf.arg)).contiguous()
        if leaf.kind == "orth":
            q, _ = torch.linalg.qr(take("n", leaf.shape).double())
            flip = torch.linalg.det(q) < 0
            q[:, :, 0] = torch.where(flip[:, None], -q[:, :, 0], q[:, :, 0])
            return q.float().contiguous()
        raise ValueError(f"unknown leaf kind {leaf.kind}")

    out = _walk(specs, draw)
    _fill_weight_norm(out)
    return out


def _fill_weight_norm(tree) -> None:
    """Each weight-normed layer's g: the norm of its v per output channel (the init of
    torch's ``weight_norm``)."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree and tree["g"] is None:
            v = tree["v"]
            tree["g"] = torch.sqrt(torch.sum(v * v, dim=(1, 2)))
        for v in tree.values():
            _fill_weight_norm(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _fill_weight_norm(v)


def run_slice(tree, i: int):
    """Run ``i`` of a materialized tree (views; host counters as they are)."""
    def one(t):
        return t if t.dim() == 0 and t.device.type == "cpu" else t[i]

    return _map(tree, one)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    return [_map(v, fn) for v in tree]


def with_random_bn(tree, gen: torch.Generator, key: str = ""):
    """Non-trivial BatchNorm state and affine parameters, drawn on the device: running means
    0.3 N(0, 1), variances U(0.5, 2), scales U(0.5, 1.5), biases 0.3 N(0, 1)."""
    def like(t, fn):
        return fn(torch.empty_like(t))

    if isinstance(tree, model.BNStats):
        return model.BNStats(like(tree.mean, lambda e: e.normal_(0.0, 0.3, generator=gen)),
                             like(tree.var, lambda e: e.uniform_(0.5, 2.0, generator=gen)))
    if isinstance(tree, dict):
        return {k: with_random_bn(v, gen, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [with_random_bn(v, gen, key) for v in tree]
    if key.endswith("bn_scale"):
        return like(tree, lambda e: e.uniform_(0.5, 1.5, generator=gen))
    if key.endswith("bn_bias"):
        return like(tree, lambda e: e.normal_(0.0, 0.3, generator=gen))
    return tree


def served_members(specs, runs: int, seed: int, device, x: torch.Tensor, logits_fn,
                   head_scale: float) -> dict:
    """``runs`` classifiers with random BatchNorm state, each head's weight scaled by
    ``head_scale`` and its bias set to minus the median of the scaled products over the
    series ``x`` (the reference's logits, ``logits_fn(member, x)``), so that every member
    predicts every class."""
    tree = materialize(specs, runs, seed, device)
    gen = torch.Generator(device=device).manual_seed((int(seed) + 1) % 2**63)
    tree = with_random_bn(tree, gen)
    head = tree["params"]["cls"]["hidden"]
    with torch.no_grad():
        for i in range(runs):
            logits = logits_fn(run_slice(tree, i), x)
            head["weight"][i] *= head_scale
            head["bias"][i] = -torch.median(head_scale * (logits - head["bias"][i]), dim=0).values
    return tree
