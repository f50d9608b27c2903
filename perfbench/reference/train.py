"""Plain PyTorch reference of one run's joint (phase-5) training steps.

Follows the program's K-run step for one run from the same weights, batches and seeds:
the forward of ``model.phase5_forward``; the gradient of the GradNorm-weighted total by
every module; GradNorm's trunk norms from the merged pulls (t_nf + s_nf, t_c + s_c,
s2t2s_c, each through the two OS blocks of the extractors); GradNorm's closed-form weight
update with its own Adam; torch RMSprop (alpha 0.99, eps 1e-8) for every module but CPC,
whose optimizer is Adam (0.9, 0.999, 1e-8); the WGAN clamp of both critics.  The CPC
anchors and the critic's dropout come from a CPU ``torch.Generator`` of the run's seed, in
the order the program draws them: two anchors, then the four dropout multipliers, a step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import model

MODULES = ("t_ext", "t_cls", "s_ext", "dim_uni", "s_cls", "prob_trans", "nf", "noise", "ad",
           "fd", "cpc")
GRADNORM_LOSSES = ("t_nf", "t_c", "s_nf", "s_c", "s2t2s_c")
LOSSES = ("t_nf", "s_nf", "t_c", "s_c", "t_sl", "s_sl", "cdan", "s2t2s_c", "fd")
LR = {"t_ext": 1e-3, "t_cls": 3e-3, "s_ext": 1e-3, "dim_uni": 1e-3, "s_cls": 3e-3,
      "prob_trans": 1e-3, "nf": 1e-3, "noise": 5e-3, "ad": 1e-3, "fd": 1e-3, "cpc": 2e-3}
CLIP = {"ad": 5e-4, "fd": 1e-2}
GRADNORM = {"t": {"init": (2.0, 5.0), "lr": 2e-4, "sum": 7.0},
            "s": {"init": (2.0, 2.0, 4.0), "lr": 1e-3, "sum": 8.0}}
ALPHA = 3.0


def named_leaves(tree, prefix: str = "") -> List:
    """(path, tensor) of every tensor of a tree of dicts, lists and NamedTuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    return [kv for k, v in items for kv in named_leaves(v, f"{prefix}.{k}" if prefix else str(k))]


def draws(generator: torch.Generator, timestep: int, batch: int, hidden: int):
    """One step's CPC anchors and dropout multipliers, as the program draws them."""
    anchors = [int(torch.randint(0, timestep // 2, (), generator=generator)) for _ in range(2)]
    masks = [[(torch.rand((batch, hidden), generator=generator) >= 0.2).float() / 0.8
              for _ in range(2)] for _ in range(2)]
    return anchors, masks


def staged_weights(epoch: int) -> List[float]:
    stages = ([3.0, 3.0, 2.0, 2.0], [2.0, 3.0, 1.8, 1.5], [1.5, 2.0, 1.8, 1.8],
              [1.5, 1.5, 2.5, 2.5])
    return stages[sum(epoch >= e for e in (12, 24, 50))]


class GradNorm:
    def __init__(self, init, lr, weight_sum, device, dtype=torch.float32):
        self.w = torch.tensor(init, device=device, dtype=dtype)
        self.m = torch.zeros_like(self.w)
        self.v = torch.zeros_like(self.w)
        self.t = 0
        self.lr, self.sum, self.initial = lr, weight_sum, None

    @torch.no_grad()
    def step(self, losses: torch.Tensor, norms: torch.Tensor) -> None:
        sig = torch.sigmoid(losses)
        if self.initial is None:
            self.initial = sig.clone()
        ratio = sig / self.initial
        rate = ratio / ratio.mean()
        n = self.w * norms
        grad = torch.sign(n - n.mean() * rate ** ALPHA) * norms
        adam(self.w, grad, self.m, self.v, self.t + 1, self.lr)
        self.t += 1
        self.w.clamp_(min=0.0)
        self.w.mul_(self.sum / self.w.sum())


@torch.no_grad()
def adam(p, g, m, v, t: int, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    m.lerp_(g, 1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
    p.add_(-(lr / (1 - b1 ** t)) * m / denom)


@torch.no_grad()
def rmsprop(p, g, sq, lr: float, alpha=0.99, eps=1e-8) -> None:
    sq.mul_(alpha).addcmul_(g, g, value=1 - alpha)
    p.add_(-lr * g / sq.sqrt().add_(eps))


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_detached(v) for v in tree))
    return [_detached(v) for v in tree]


def run_steps(params, mstate, consts, sh: model.Shapes, masks: model.Masks,
              batches: Sequence, seed: int, epoch: int, channels: int,
              clamp: float = 0.0) -> Dict:
    """``len(batches)`` joint steps of one run from ``params`` (copied), each batch
    (bt, lt, bs, ls) on the device, the flow's log-scale bounded by ``clamp``
    (``model.soft_clamp``).  Returns each step's losses (floats), each parameter leaf's
    first and second gradient norms and its change's norm over the steps, by path."""
    params = {m: [(k, t.detach().clone().requires_grad_(True)) for k, t in named_leaves(params[m])]
              for m in MODULES}
    tree = _rebuild(params)
    start = {m: [t.detach().clone() for _, t in params[m]] for m in MODULES}
    sq = {m: [torch.zeros_like(t) for _, t in params[m]] for m in MODULES}
    adam_m = [torch.zeros_like(t) for _, t in params["cpc"]]
    adam_v = [torch.zeros_like(t) for _, t in params["cpc"]]
    device, dtype = params["t_ext"][0][1].device, params["t_ext"][0][1].dtype
    gn = {k: GradNorm(v["init"], v["lr"], v["sum"], device, dtype) for k, v in GRADNORM.items()}
    gen = torch.Generator().manual_seed(int(seed))
    timestep = len(tree["cpc"]["wk"])
    hidden = tree["ad"]["l1"]["weight"].shape[-1]
    out = {"losses": [], "first_grad": {}, "second_grad": {}, "change": {}}
    t_trunk = [t for _, t in named_leaves(tree["t_ext"]["block"])]
    s_trunk = [t for _, t in named_leaves(tree["s_ext"]["block"])]
    for step, (bt, lt, bs, ls) in enumerate(batches):
        anchors, drop = draws(gen, timestep, bt.shape[0], hidden)
        drop = [[m.to(device) for m in pair] for pair in drop]
        losses, new = model.phase5_forward(tree, mstate, consts, masks, bt, lt, bs, ls, anchors,
                                           drop, channels, clamp)
        w = staged_weights(epoch)
        loss_t = torch.stack([losses["t_nf"], losses["t_c"]])
        loss_s = torch.stack([losses["s_nf"], losses["s_c"], losses["s2t2s_c"]])
        total = ((gn["t"].w.clone() * loss_t).sum() + (gn["s"].w.clone() * loss_s).sum()
                 + w[0] * losses["cdan"] + w[1] * losses["fd"] + w[2] * losses["t_sl"]
                 + w[3] * losses["s_sl"])
        flat = [t for m in MODULES for _, t in params[m]]
        grads = torch.autograd.grad(total, flat, retain_graph=True, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]

        def trunk_norms(outs, trunks, retain=True):
            gs = torch.autograd.grad(sum(outs), [p for tr in trunks for p in tr],
                                     retain_graph=retain, allow_unused=True)
            res, j = [], 0
            for tr in trunks:
                res.append(sum(torch.linalg.vector_norm(g) for g in gs[j:j + len(tr)]
                               if g is not None))
                j += len(tr)
            return res

        n_nf_t, n_nf_s = trunk_norms([losses["t_nf"], losses["s_nf"]], (t_trunk, s_trunk))
        n_c_t, n_c_s = trunk_norms([losses["t_c"], losses["s_c"]], (t_trunk, s_trunk))
        (n_5,) = trunk_norms([losses["s2t2s_c"]], (s_trunk,), retain=False)
        vec = torch.stack([losses[k] for k in GRADNORM_LOSSES]).detach()
        gn["t"].step(vec[:2], torch.stack([n_nf_t, n_c_t]).detach())
        gn["s"].step(vec[2:], torch.stack([n_nf_s, n_c_s, n_5]).detach())
        i = 0
        for m in MODULES:
            for j, (path, p) in enumerate(params[m]):
                g = grads[i]
                i += 1
                if step < 2:
                    key = ("first_grad", "second_grad")[step]
                    out[key][f"{m}.{path}"] = float(torch.linalg.vector_norm(g))
                if m == "cpc":
                    adam(p, g, adam_m[j], adam_v[j], step + 1, LR[m])
                else:
                    rmsprop(p, g, sq[m][j], LR[m])
                if m in CLIP:
                    with torch.no_grad():
                        p.clamp_(-CLIP[m], CLIP[m])
        mstate = _detached(new)
        out["losses"].append({k: float(losses[k].detach()) for k in LOSSES})
        del losses, new, total, grads
    for m in MODULES:
        for (path, p), p0 in zip(params[m], start[m]):
            out["change"][f"{m}.{path}"] = float(torch.linalg.vector_norm(p.detach() - p0))
    return out


def _rebuild(params):
    """The module trees of the leaves in ``params`` (path, tensor), as nested dicts and
    lists."""
    out = {}
    for m, items in params.items():
        root: Dict = {}
        for path, t in items:
            keys = path.split(".")
            node = root
            for a, b in zip(keys[:-1], keys[1:]):
                node = node.setdefault(a, {})
            node[keys[-1]] = t
        out[m] = _lists(root)
    return out


def _lists(node):
    """Dicts whose keys are 0..n-1 as lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and sorted(map(int, node)) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node
