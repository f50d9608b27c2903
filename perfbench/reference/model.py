"""Plain PyTorch reference of the style-transfer model stack, for the benchmark's checks.

A frozen, independent copy of the model math the benchmark holds the program to: the
OS-CNN extractors and classifiers with their masked omni-scale convs, DimensionUnification,
NoiseTransfer, ProbTransfer, CPC, the simplified WaveGlow with its WaveNet coupling nets,
the CDAN critic with its random multilinear map, and the WGAN feature critic.  Every conv is
``torch.nn.functional.conv1d`` and every product a plain matmul: no hand-written kernel and
nothing of the program is imported.  Layout is channel-last, (B, T, C), and parameters sit in
nested dicts under the keys the program uses, so the benchmark can hand one set of weights to
both sides.

``init_specs`` lays out every leaf of a model with the distribution it is drawn from, and
``perfbench/harness/weights.py`` draws them on the device.  The running statistics and the
critics' and NoiseTransfer's counters are NamedTuples with the program's field names.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ structure ---
# The OS-CNN layer lists of the reference's OS_CNN_Structure_build.py: a "prime"
# kernel set by the naive test that admits 1 and 2, a width per layer from its parameter
# budget, and a last layer of kernels 1 and 2.


def primes(start: int, end: int) -> List[int]:
    return [v for v in range(start, end + 1) if all(v % n for n in range(2, v))]


def layer_specs(in_channels: int, length: int, max_kernel: int = 89,
                budget_scale: float = 1.0) -> Tuple[list, list]:
    """(extractor layers, classifier layers): each layer a list of (in, out, kernel)."""
    budgets = [int(b * budget_scale) for b in (8 * 128 * in_channels, 5 * 128 * 256 + 2 * 256 * 128)]
    rf = min(int(length / 4), max_kernel)
    ks = primes(1, rf)
    layers, c_in = [], in_channels
    for budget in budgets:
        out = int(budget / (c_in * sum(ks)))
        if out < 1:
            raise ValueError(f"budget {budget} leaves no channels for kernels 1..{rf}")
        layers.append([(c_in, out, k) for k in ks])
        c_in = len(ks) * out
    first = len(ks) * int(budgets[0] / (in_channels * sum(ks)))
    layers.append([(c_in, first, 1), (c_in, first, 2)])
    feat = sum(o for _, o, _ in layers[-1])
    cls = [[(feat, o, k) for _, o, k in layers[0]]] + layers[1:]
    return layers, cls


def mask_bounds(k: int, largest: int) -> Tuple[int, int]:
    right = math.ceil((largest - 1) / 2) - math.ceil((k - 1) / 2)
    left = largest - k - right
    return left, left + k


def os_mask(layer: list) -> np.ndarray:
    """(K, 1, C_out): ones on each branch's centred band of taps."""
    largest = layer[-1][-1]
    cols = []
    for _, out, k in layer:
        band = np.zeros((largest, 1, out), np.float32)
        lo, hi = mask_bounds(k, largest)
        band[lo:hi] = 1.0
        cols.append(band)
    return np.concatenate(cols, axis=-1)


def width(layer: list) -> int:
    return sum(o for _, o, _ in layer)


# -------------------------------------------------------------------- state types ---

class BNStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


class NoiseTransferState(NamedTuple):
    target_avg: torch.Tensor
    source_avg: torch.Tensor
    time: torch.Tensor
    cal_num_target: torch.Tensor
    cal_num_source: torch.Tensor


class CriticState(NamedTuple):
    iter_num: torch.Tensor


# -------------------------------------------------------------------- leaf specs ---
# A spec is (shape, kind, arg): "u" U(-arg, arg) per element or per last-axis column when
# arg is a list, "n" N(0, arg^2), "c" the constant arg, "orth" a random rotation,
# "wn_g" the norm of the sibling "v" per output channel, "int" a host int32 counter.


class Leaf(NamedTuple):
    shape: tuple
    kind: str
    arg: object = None
    mask: object = None


def _linear(n_in: int, n_out: int) -> Dict:
    b = 1.0 / math.sqrt(n_in)
    return {"weight": Leaf((n_in, n_out), "u", b), "bias": Leaf((n_out,), "u", b)}


def _os_layer(layer: list) -> Tuple[Dict, Dict]:
    largest, c_in = layer[-1][-1], layer[0][0]
    bounds = [1.0 / math.sqrt(c_in * k) for _, o, k in layer for _ in range(o)]
    out = width(layer)
    params = {"conv": {"weight": Leaf((largest, c_in, out), "u", bounds, os_mask(layer)),
                       "bias": Leaf((out,), "u", bounds)},
              "bn_scale": Leaf((out,), "c", 1.0), "bn_bias": Leaf((out,), "c", 0.0)}
    return params, {"bn": BNStats(Leaf((out,), "c", 0.0), Leaf((out,), "c", 1.0))}


def _os_block(layers: list) -> Tuple[Dict, Dict]:
    pairs = [_os_layer(layer) for layer in layers]
    return {"layers": [p for p, _ in pairs]}, {"layers": [s for _, s in pairs]}


def os_cnn_specs(layers: list, n_class: int) -> Tuple[Dict, Dict]:
    bp, bs = _os_block(layers)
    return {"block": bp, "hidden": _linear(width(layers[-1]), n_class)}, {"block": bs}


def os_cnn_res_specs(layers: list) -> Tuple[Dict, Dict]:
    bp, bs = _os_block(layers)
    out, c_in = width(layers[-1]), layers[0][0][0]
    params = {"block": bp, "res": _linear(c_in, out),
              "res_bn_scale": Leaf((out,), "c", 1.0), "res_bn_bias": Leaf((out,), "c", 0.0)}
    return params, {"block": bs, "res_bn": BNStats(Leaf((out,), "c", 0.0), Leaf((out,), "c", 1.0))}


def _wn_layer(k: int, c_in: int, c_out: int) -> Dict:
    b = 1.0 / math.sqrt(c_in * k)
    return {"v": Leaf((k, c_in, c_out), "u", b), "g": Leaf((c_out,), "wn_g"),
            "bias": Leaf((c_out,), "u", b)}


def wn_specs(n_half: int, channels: int, layers: int) -> Dict:
    """Weight-normed start, cond, dilated and res/skip layers; the end projection is zero, so
    each coupling starts as the identity (Simplified_NF_WaveGlow.py:75-78)."""
    return {
        "start": _wn_layer(1, n_half, channels),
        "cond": _wn_layer(1, n_half, 2 * channels * layers),
        "end": {"weight": Leaf((channels, 2 * n_half), "c", 0.0),
                "bias": Leaf((2 * n_half,), "c", 0.0)},
        "in_layers": [_wn_layer(3, channels, 2 * channels) for _ in range(layers)],
        "res_skip_layers": [_wn_layer(1, channels, 2 * channels if i < layers - 1 else channels)
                            for i in range(layers)],
    }


def _rnn(n_in: int, hidden: int, gates: int) -> Dict:
    b = 1.0 / math.sqrt(hidden)
    return {"w_ih": Leaf((n_in, gates * hidden), "u", b), "w_hh": Leaf((hidden, gates * hidden), "u", b),
            "b_ih": Leaf((gates * hidden,), "u", b), "b_hh": Leaf((gates * hidden,), "u", b)}


def _xavier(n_in: int, n_out: int) -> Dict:
    return {"weight": Leaf((n_in, n_out), "n", math.sqrt(2.0 / (n_in + n_out))),
            "bias": Leaf((n_out,), "c", 0.0)}


def _critic() -> CriticState:
    return CriticState(Leaf((), "int", -1))


class Shapes(NamedTuple):
    """The pipeline's shapes: target and source (channels, length, classes) and the widths."""

    t: Tuple[int, int, int]
    s: Tuple[int, int, int]
    t_ext: list
    cls: list
    s_ext: list
    feat: int
    s_feat: int


def shapes(target: Sequence[int], source: Sequence[int], budget_scale: float = 1.0,
           max_kernel: int = 89) -> Shapes:
    t_ext, cls = layer_specs(target[0], target[1], max_kernel, budget_scale)
    s_ext, _ = layer_specs(source[0], source[1], max_kernel, budget_scale)
    return Shapes(tuple(target), tuple(source), t_ext, cls, s_ext, width(t_ext[-1]), width(s_ext[-1]))


def pipeline_specs(sh: Shapes, flow: Dict, cdan_dim: int, cpc_hidden: int) -> Dict:
    """Every leaf of the style-transfer pipeline (params, mstate, consts)."""
    (_, t_t, n_t), (_, t_s, n_s) = sh.t, sh.s
    t_ext_p, t_ext_s = os_cnn_res_specs(sh.t_ext)
    t_cls_p, t_cls_s = os_cnn_specs(sh.cls, n_t)
    s_ext_p, s_ext_s = os_cnn_res_specs(sh.s_ext)
    s_cls_p, s_cls_s = os_cnn_specs(sh.cls, n_s)
    c = sh.feat
    nf = {"convinv": [{"weight": Leaf((c, c), "orth")} for _ in range(flow["n_flows"])],
          "wn": [wn_specs(c // 2, flow["wn_channels"], flow["wn_layers"])
                 for _ in range(flow["n_flows"])]}
    counter = Leaf((), "int", 0)
    zeros = Leaf((t_t, c), "c", 0.0)
    return {
        "params": {
            "t_ext": t_ext_p, "t_cls": t_cls_p, "s_ext": s_ext_p,
            "dim_uni": {"length": _linear(t_s, t_t), "channel": _linear(sh.s_feat, c)},
            "s_cls": s_cls_p, "prob_trans": {"lstm": _rnn(c, c, 4)}, "nf": nf,
            "noise": {"conv": _linear(c, c)},
            "ad": {"l1": _xavier(cdan_dim, 1024), "l2": _xavier(1024, 1024), "l3": _xavier(1024, 1)},
            "fd": {f"l{i + 1}": _linear(d0, d1)
                   for i, (d0, d1) in enumerate(zip((c, 800, 400, 50), (800, 400, 50, 1)))},
            "cpc": {"gru": _rnn(c, cpc_hidden, 3),
                    "wk": [_linear(cpc_hidden, c) for _ in range(t_t // 2)]},
        },
        "mstate": {
            "t_ext": t_ext_s, "t_cls": t_cls_s, "s_ext": s_ext_s, "s_cls": s_cls_s,
            "noise": NoiseTransferState(zeros, zeros, counter, counter, counter),
            "ad": _critic(), "fd": _critic(),
        },
        "consts": {"random_layer": {"matrices": [Leaf((c * t_t, cdan_dim), "n", 1.0),
                                                 Leaf((n_t, cdan_dim), "n", 1.0)],
                                    "output_dim": Leaf((), "c", float(cdan_dim))}},
    }


def classifier_specs(channels: int, length: int, n_class: int, budget_scale: float = 1.0,
                     max_kernel: int = 89) -> Dict:
    """A served target model: extractor and classifier (an ensemble member's layout)."""
    ext, cls = layer_specs(channels, length, max_kernel, budget_scale)
    ext_p, ext_s = os_cnn_res_specs(ext)
    cls_p, cls_s = os_cnn_specs(cls, n_class)
    return {"params": {"ext": ext_p, "cls": cls_p}, "mstate": {"ext": ext_s, "cls": cls_s}}


# ------------------------------------------------------------------- primitives ---

def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["weight"] + p["bias"]


def batch_norm(x, scale, bias, stats: BNStats, training: bool, momentum=0.1, eps=1e-5):
    """torch BatchNorm1d over every axis but the last; the new running statistics keep
    their gradient (the s2t pass normalises with them)."""
    if not training:
        return (x - stats.mean) * (torch.rsqrt(stats.var + eps) * scale) + bias, stats
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims)
    var = torch.square(x - mean).mean(dim=dims)
    n = x.numel() // x.shape[-1]
    new = BNStats((1 - momentum) * stats.mean + momentum * mean,
                  (1 - momentum) * stats.var + momentum * var * (n / max(n - 1, 1)))
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias, new


def os_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Masked omni-scale "same" conv: weight (K, C_in, C_out), padding ((K-1)//2, K//2)."""
    k = weight.shape[0]
    w = (weight * mask).permute(2, 1, 0)
    xp = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
    return F.conv1d(xp, w).transpose(1, 2) + bias


def os_block(p, s, masks, x, training: bool, relu_last: bool = True):
    new = []
    for i, (lp, ls, m) in enumerate(zip(p["layers"], s["layers"], masks)):
        y = os_conv(x, lp["conv"]["weight"], lp["conv"]["bias"], m)
        y, bn = batch_norm(y, lp["bn_scale"], lp["bn_bias"], ls["bn"], training)
        x = torch.relu(y) if (i < len(masks) - 1 or relu_last) else y
        new.append({"bn": bn})
    return x, {"layers": new}


def os_cnn(p, s, masks, x, training: bool):
    """(logits, pooled, new state)."""
    y, nb = os_block(p["block"], s["block"], masks, x, training)
    pooled = y.mean(dim=1)
    return linear(p["hidden"], pooled), pooled, {"block": nb}


def os_cnn_res(p, s, masks, x, training: bool):
    main, nb = os_block(p["block"], s["block"], masks, x, training, relu_last=False)
    short, nbn = batch_norm(linear(p["res"], x), p["res_bn_scale"], p["res_bn_bias"],
                            s["res_bn"], training)
    return torch.relu(main + short), {"block": nb, "res_bn": nbn}


def lstm_cell(p, x, h, c):
    hid = h.shape[-1]
    z = x @ p["w_ih"] + p["b_ih"] + h @ p["w_hh"] + p["b_hh"]
    i, f = torch.sigmoid(z[..., :hid]), torch.sigmoid(z[..., hid:2 * hid])
    g, o = torch.tanh(z[..., 2 * hid:3 * hid]), torch.sigmoid(z[..., 3 * hid:])
    c = f * c + i * g
    return o * torch.tanh(c), c


def gru_scan(p, xs, h):
    hid = h.shape[-1]
    hs = []
    for t in range(xs.shape[1]):
        gi = xs[:, t] @ p["w_ih"] + p["b_ih"]
        gh = h @ p["w_hh"] + p["b_hh"]
        r = torch.sigmoid(gi[..., :hid] + gh[..., :hid])
        z = torch.sigmoid(gi[..., hid:2 * hid] + gh[..., hid:2 * hid])
        n = torch.tanh(gi[..., 2 * hid:] + r * gh[..., 2 * hid:])
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coeff):
        ctx.coeff = coeff
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.coeff * g, None


def grl_coeff(it: int, alpha: float, max_iter: float) -> float:
    it = min(float(it), max_iter)
    return 2.0 / (1.0 + math.exp(-alpha * it / max_iter)) - 1.0


# ------------------------------------------------------------------------ modules ---

def dimension_unification(p, x):
    y = torch.relu(torch.einsum("bsc,st->btc", x, p["length"]["weight"])
                   + p["length"]["bias"][None, :, None])
    return torch.relu(linear(p["channel"], y))


def prob_transfer(p, pooled):
    h = torch.zeros_like(pooled)
    c = torch.zeros_like(pooled)
    for _ in range(2):
        h, c = lstm_cell(p["lstm"], pooled, h, c)
    return h


def noise_transfer(p, st: NoiseTransferState, t_noise, s_noise):
    b_t, b_s = t_noise.shape[0], s_noise.shape[0]
    first = int(st.time) == 0
    ct = 1.0 if first else b_t / max(float(st.cal_num_target), 1.0)
    cs = 1.0 if first else b_s / max(float(st.cal_num_source), 1.0)
    t_avg = st.target_avg + ct * t_noise.mean(dim=0)
    s_avg = st.source_avg + cs * s_noise.mean(dim=0)
    delta = F.selu(linear(p["conv"], t_avg - s_avg))
    new = NoiseTransferState(t_avg.detach(), s_avg.detach(), st.time + 1,
                             st.cal_num_target + b_t, st.cal_num_source + b_s)
    return delta[None] + s_noise, new


def cpc_pair(p, fa, fb, anchors):
    """Two InfoNCE losses, one GRU scan over both batches' first timestep//2 steps."""
    ts = len(p["wk"])
    b = fa.shape[0]
    both = torch.cat([fa, fb], dim=0)
    ctx = gru_scan(p["gru"], both[:, :max(ts // 2, 1)],
                   both.new_zeros(both.shape[0], p["gru"]["w_hh"].shape[0]))
    out = []
    for z, c, a in ((fa, ctx[:b], anchors[0]), (fb, ctx[b:], anchors[1])):
        enc = z[:, a + 1:a + 1 + ts].transpose(0, 1)  # (ts, B, C)
        c_t = c[:, a]
        pred = torch.stack([c_t @ w["weight"] + w["bias"] for w in p["wk"]])
        total = torch.einsum("sbc,sdc->sbd", enc, pred)
        nce = torch.diagonal(torch.log_softmax(total, dim=-1), dim1=1, dim2=2).sum()
        out.append(nce / (-1.0 * z.shape[0] * ts))
    return out[0], out[1]


def wn_weight(p):
    v, g = p["v"], p["g"]
    return v * (g / torch.clamp(torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True)), min=1e-12))


def wn(p, x, channels: int):
    """The WaveNet coupling net, x (B, T, n_half) -> (B, T, 2 n_half)."""
    n_layers = len(p["in_layers"])
    audio = x @ wn_weight(p["start"])[0] + p["start"]["bias"]
    spect = x @ wn_weight(p["cond"])[0] + p["cond"]["bias"]
    out = torch.zeros_like(audio)
    for i in range(n_layers):
        w = wn_weight(p["in_layers"][i])  # (3, C, 2C)
        d = 2 ** i
        a = F.conv1d(audio.transpose(1, 2), w.permute(2, 1, 0), padding=d, dilation=d)
        a = a.transpose(1, 2) + p["in_layers"][i]["bias"]
        z = a + spect[..., i * 2 * channels:(i + 1) * 2 * channels]
        acts = torch.tanh(z[..., :channels]) * torch.sigmoid(z[..., channels:])
        rs = acts @ wn_weight(p["res_skip_layers"][i])[0] + p["res_skip_layers"][i]["bias"]
        if i < n_layers - 1:
            audio = audio + rs[..., :channels]
            out = out + rs[..., channels:]
        else:
            out = out + rs
    return out @ p["end"]["weight"] + p["end"]["bias"]


def soft_clamp(log_s, clamp: float):
    """The coupling's log-scale bounded as ``clamp * tanh(log_s / clamp)``; 0 leaves it."""
    return clamp * torch.tanh(log_s / clamp) if clamp else log_s


def waveglow_forward(p, x, channels: int, clamp: float = 0.0):
    log_s_list, log_det = [], []
    audio = x
    for k in range(len(p["convinv"])):
        w = p["convinv"][k]["weight"]
        audio = audio @ w.T
        log_det.append(audio.shape[0] * audio.shape[1] * torch.linalg.slogdet(w)[1])
        h = audio.shape[-1] // 2
        a0, a1 = audio[..., :h], audio[..., h:]
        o = wn(p["wn"][k], a0, channels)
        log_s = soft_clamp(o[..., h:], clamp)
        a1 = torch.exp(log_s) * a1 + o[..., :h]
        log_s_list.append(log_s)
        audio = torch.cat([a0, a1], dim=-1)
    return audio, log_s_list, log_det


def waveglow_pair(p, xa, xb, channels: int, clamp: float = 0.0):
    ba, bb = xa.shape[0], xb.shape[0]
    z, ls, ld = waveglow_forward(p, torch.cat([xa, xb], dim=0), channels, clamp)
    return ((z[:ba], [s[:ba] for s in ls], [d * (ba / (ba + bb)) for d in ld]),
            (z[ba:], [s[ba:] for s in ls], [d * (bb / (ba + bb)) for d in ld]))


def waveglow_infer(p, noise, channels: int, clamp: float = 0.0):
    audio = noise
    for k in reversed(range(len(p["convinv"]))):
        h = audio.shape[-1] // 2
        a0, a1 = audio[..., :h], audio[..., h:]
        o = wn(p["wn"][k], a0, channels)
        a1 = (a1 - o[..., :h]) * torch.exp(-soft_clamp(o[..., h:], clamp))
        audio = torch.cat([a0, a1], dim=-1) @ torch.linalg.inv(p["convinv"][k]["weight"]).T
    return audio


def waveglow_loss(out):
    z, ls, ld = out
    loss = torch.sum(z * z) / 2 - sum(torch.sum(s) for s in ls) - sum(ld)
    return loss / z.numel()


def cross_entropy(logits, labels):
    return -torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[:, None])[:, 0].mean()


def random_layer(p, inputs):
    proj = [x @ m for x, m in zip(inputs, p["matrices"])]
    out = proj[0] / torch.pow(p["output_dim"], 1.0 / len(proj))
    for q in proj[1:]:
        out = out * q
    return out


def _advance(st: CriticState) -> CriticState:
    return CriticState(torch.clamp(st.iter_num + 1, max=20))


def ad_net(p, st: CriticState, x, masks):
    st = _advance(st)
    h = _Reverse.apply(x, grl_coeff(int(st.iter_num), 100.0, 20.0))
    h = torch.relu(linear(p["l1"], h)) * masks[0]
    h = torch.relu(linear(p["l2"], h)) * masks[1]
    return linear(p["l3"], h), st


def cdan(p, st, t_feat, s2t_feat, t_logits, s2t_logits, rl, masks):
    pt, ps = torch.softmax(t_logits, dim=1), torch.softmax(s2t_logits, dim=1)

    def flat(x):
        return x.transpose(1, 2).reshape(x.shape[0], -1)

    t_out, st = ad_net(p, st, random_layer(rl, [flat(t_feat), pt]), masks[0])
    s_out, st = ad_net(p, st, random_layer(rl, [flat(s2t_feat), ps]), masks[1])
    coeff = grl_coeff(int(st.iter_num), 100.0, 20.0)

    def weight(prob):
        ent = -torch.sum(prob * torch.log(prob + 1e-5), dim=1)
        w = 1.0 + torch.exp(-_Reverse.apply(ent, coeff))
        return w / w.sum().detach()

    return weight(pt).sum() * t_out[:, 0].sum() - weight(ps).sum() * s_out[:, 0].sum(), st


def feature_critic(p, st: CriticState, x):
    st = _advance(st)
    h = _Reverse.apply(x, grl_coeff(int(st.iter_num), 100.0, 20.0))
    for name in ("l1", "l2", "l3"):
        h = F.leaky_relu(linear(p[name], h), 0.2)
    return linear(p["l4"], h), st


# ----------------------------------------------------------------- phase-5 forward ---

class Masks(NamedTuple):
    t_ext: list
    cls: list
    s_ext: list


def masks_for(sh: Shapes, device) -> Masks:
    def m(layers):
        return [torch.from_numpy(os_mask(layer)).to(device) for layer in layers]

    return Masks(m(sh.t_ext), m(sh.cls), m(sh.s_ext))


def phase5_forward(params, mstate, consts, masks: Masks, bt, lt, bs, ls, anchors, drop,
                   channels: int, clamp: float = 0.0):
    """The joint step's forward (reference train_and_test.py:539-621): every loss and the
    new model state.  ``drop``: the critic's dropout multipliers, target call then s2t
    call, two each.  ``clamp``: the flow's log-scale bound (``soft_clamp``)."""
    new = dict(mstate)
    t_feat, new["t_ext"] = os_cnn_res(params["t_ext"], mstate["t_ext"], masks.t_ext, bt, True)
    s_raw, new["s_ext"] = os_cnn_res(params["s_ext"], mstate["s_ext"], masks.s_ext, bs, True)
    s_feat = dimension_unification(params["dim_uni"], s_raw)
    t_sl, s_sl = cpc_pair(params["cpc"], t_feat, s_feat, anchors)
    t_out, s_out = waveglow_pair(params["nf"], t_feat, s_feat, channels, clamp)
    t_nf, s_nf = waveglow_loss(t_out), waveglow_loss(s_out)
    s2t_noise, new["noise"] = noise_transfer(params["noise"], mstate["noise"], t_out[0], s_out[0])
    s2t_feat = waveglow_infer(params["nf"], s2t_noise, channels, clamp)
    t_logits, t_pool, new["t_cls"] = os_cnn(params["t_cls"], mstate["t_cls"], masks.cls, t_feat, True)
    s2t_logits, s2t_pool, _ = os_cnn(params["t_cls"], new["t_cls"], masks.cls, s2t_feat, False)
    s_logits, s_pool, new["s_cls"] = os_cnn(params["s_cls"], mstate["s_cls"], masks.cls, s_feat, True)
    cdan_l, new["ad"] = cdan(params["ad"], mstate["ad"], t_feat, s2t_feat, t_logits, s2t_logits,
                             consts["random_layer"], drop)
    t2s = prob_transfer(params["prob_trans"], t_pool)
    s2t2s = prob_transfer(params["prob_trans"], s2t_pool)
    s2t2s_logits = linear(params["s_cls"]["hidden"], s2t2s)
    fd_t, st = feature_critic(params["fd"], mstate["fd"], t2s)
    fd_m, st = feature_critic(params["fd"], st, s2t2s)
    fd_s, new["fd"] = feature_critic(params["fd"], st, s_pool)
    losses = {
        "t_nf": t_nf, "s_nf": s_nf, "t_c": cross_entropy(t_logits, lt),
        "s_c": cross_entropy(s_logits, ls), "t_sl": t_sl, "s_sl": s_sl, "cdan": cdan_l,
        "s2t2s_c": cross_entropy(s2t2s_logits, ls),
        "fd": -fd_t.mean() - fd_m.mean() + fd_s.mean(),
    }
    return losses, new


# ------------------------------------------------------------------------ serving ---

def classifier_logits(params, mstate, masks_ext, masks_cls, x):
    """A served target model's logits, eval mode (running statistics)."""
    feat, _ = os_cnn_res(params["ext"], mstate["ext"], masks_ext, x, False)
    return os_cnn(params["cls"], mstate["cls"], masks_cls, feat, False)[0]
