"""Operations and bytes the algorithm needs, from shapes alone (frozen with the benchmark).

Every multiply-add counts 2 operations and is counted once, whatever a kernel recomputes or
splits (a 3xTF32 product is one product here).  An OS conv counts the live taps of its
mask: branch b of kernel k contributes k taps to each of its output channels.  A WN
dilated tap that reads across a series' edge reads the zero padding and is not counted.
Bytes count each input read once and each output written once, float32.

``step_table`` is the joint training step of one run by module: its forward, and the
backward of the four merged pulls the default configuration takes (the total; t_nf + s_nf,
t_c + s_c and s2t2s_c, each only to the extractors' OS blocks).  A backward counts an input
gradient for every product whose input needs one and a weight gradient for every product
whose weight is trained or is on the way to a trunk the pull asks for.
"""

from __future__ import annotations

from typing import Dict

from reference import model

F32 = 4
#: NVIDIA H100 SXM, dense, at 700 W (NVIDIA's data sheet): TF32 tensor cores, HBM3
PEAK_FLOPS = 494.7e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float):
    """(least seconds, "compute" or "memory"): the larger of the two bounds."""
    c, m = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (c, "compute") if c >= m else (m, "memory")


# -------------------------------------------------------------------------- OS conv ---

def os_layer_macs(layer) -> int:
    """Live multiply-adds per output time step of one OS layer: C_in x sum(out x k)."""
    return layer[0][0] * sum(o * k for _, o, k in layer)


def os_conv(layer, batch: int, length: int) -> Dict[str, float]:
    """One masked OS conv forward over (batch, length, C_in)."""
    c_in, c_out = layer[0][0], model.width(layer)
    live_w = os_layer_macs(layer)
    return {"flops": 2.0 * batch * length * live_w,
            "bytes": F32 * (batch * length * (c_in + c_out) + live_w + c_out)}


def os_block(layers, batch: int, length: int) -> Dict[str, float]:
    out = {"flops": 0.0, "bytes": 0.0}
    for layer in layers:
        w = os_conv(layer, batch, length)
        out["flops"] += w["flops"]
        out["bytes"] += w["bytes"]
    return out


# ----------------------------------------------------------------------------- WN -----

def _wn_parts(b: int, t: int, h: int, c: int, n_layers: int) -> Dict[str, float]:
    rows = b * t
    taps = [rows + 2 * b * max(t - 2 ** i, 0) for i in range(n_layers)]
    rs = [2 * c if i < n_layers - 1 else c for i in range(n_layers)]
    return {
        "start": 2.0 * rows * h * c,
        "cond": 2.0 * rows * h * 2 * c * n_layers,
        "in": sum(2.0 * tr * c * 2 * c for tr in taps),
        "res_skip": sum(2.0 * rows * c * n for n in rs),
        "end": 2.0 * rows * c * 2 * h,
    }


def _wn_weights(h: int, c: int, n_layers: int) -> int:
    return (h * c + c + h * 2 * c * n_layers + 2 * c * n_layers + n_layers * 3 * c * 2 * c
            + n_layers * 2 * c + sum(c * (2 * c if i < n_layers - 1 else c) for i in range(n_layers))
            + n_layers * 2 * c + c * 2 * h + 2 * h)


def wn_fwd(b: int, t: int, h: int, c: int, n_layers: int) -> Dict[str, float]:
    """One fused WN forward of (b, t, h) -> (b, t, 2h); it also writes the per-layer
    activations and the skip sum its backward reads."""
    rows = b * t
    flops = sum(_wn_parts(b, t, h, c, n_layers).values())
    nbytes = F32 * (rows * h + _wn_weights(h, c, n_layers) + rows * 2 * h
                    + n_layers * rows * c + rows * c)
    return {"flops": flops, "bytes": nbytes}


def wn_bwd(b: int, t: int, h: int, c: int, n_layers: int) -> Dict[str, float]:
    """One fused WN backward: the input gradient and every weight gradient but the end
    projection's (taken outside the kernel): twice each product, less the end's weight
    gradient."""
    rows = b * t
    p = _wn_parts(b, t, h, c, n_layers)
    flops = 2 * sum(p.values()) - p["end"]
    weights = _wn_weights(h, c, n_layers)
    nbytes = F32 * (rows * h + rows * 2 * h + n_layers * rows * c + rows * c + weights
                    + rows * h + weights - c * 2 * h - 2 * h)
    return {"flops": flops, "bytes": nbytes}


# ------------------------------------------------------------- the whole training step ---

def step_table(sh: model.Shapes, batch: int, flow: Dict, cdan_dim: int, cpc_hidden: int) -> Dict:
    """Operations of one run's joint step by module: {module: {"fwd", "bwd"}}."""
    (c_t, t_t, n_t), (c_s, t_s, _) = sh.t, sh.s
    f, b = sh.feat, batch
    h, wc, wl, nfl = f // 2, flow["wn_channels"], flow["wn_layers"], flow["n_flows"]

    def ext(layers, length, c_in):
        blk = os_block(layers, b, length)["flops"]
        first = os_conv(layers[0], b, length)["flops"]
        res = 2.0 * b * length * c_in * model.width(layers[-1])
        return blk, first, res

    te_blk, te_first, te_res = ext(sh.t_ext, t_t, c_t)
    se_blk, se_first, se_res = ext(sh.s_ext, t_s, c_s)
    du = 2.0 * b * c_s * t_s * t_t * sh.s_feat + 2.0 * b * t_t * sh.s_feat * f
    cls = os_block(sh.cls, b, t_t)["flops"] + 2.0 * b * f * n_t
    s_cls = os_block(sh.cls, b, t_t)["flops"] + 2.0 * b * f * sh.s[2]
    wn_pair = wn_fwd(2 * b, t_t, h, wc, wl)["flops"]
    wn_inf = wn_fwd(b, t_t, h, wc, wl)["flops"]
    inv = 2.0 * t_t * f * f
    nf_pair = nfl * (wn_pair + 2 * b * inv)
    nf_inf = nfl * (wn_inf + b * inv)
    noise = 2.0 * t_t * f * f
    lstm = 2 * 2.0 * b * (f * 4 * f + f * 4 * f)  # two cell steps
    rl_proj = 2.0 * b * f * t_t * cdan_dim + 2.0 * b * n_t * cdan_dim
    ad_mlp = 2.0 * b * (cdan_dim * 1024 + 1024 * 1024 + 1024)
    fd = 2.0 * b * (f * 800 + 800 * 400 + 400 * 50 + 50)
    ts = t_t // 2
    gru = 2.0 * (2 * b) * (ts // 2) * (f * 3 * cpc_hidden + cpc_hidden * 3 * cpc_hidden)
    cpc_heads = 2 * (2.0 * b * cpc_hidden * f * ts + 2.0 * ts * b * b * f)

    fwd = {
        "t_ext": te_blk + te_res, "s_ext": se_blk + se_res, "dim_uni": du,
        "t_cls": 2 * cls,  # the target pass and the s2t pass
        "s_cls": s_cls + 2.0 * b * f * sh.s[2],  # and the s2t2s head
        "nf": nf_pair + nf_inf, "noise": noise, "prob_trans": 2 * lstm,
        "ad": 2 * (rl_proj + ad_mlp), "fd": 3 * fd, "cpc": gru + cpc_heads,
    }
    # the total: every input gradient (not the data's, not the constants' weights) and every
    # weight gradient
    total = {m: 2 * v for m, v in fwd.items()}
    total["t_ext"] -= te_first / 2 + te_res / 2  # no gradient into the series
    total["s_ext"] -= se_first / 2 + se_res / 2
    total["ad"] -= 2 * rl_proj / 2  # the random layer is constant
    # the trunk pulls: input gradients along the path, weight gradients of the OS blocks
    trunk = {"t_ext": te_blk + te_blk - te_first, "s_ext": se_blk + se_blk - se_first,
             "dim_uni": du}
    pull_nf = {**trunk, "nf": nf_pair}
    pull_c = {**trunk, "t_cls": cls, "s_cls": s_cls}
    pull_5 = {**trunk, "nf": nf_pair + nf_inf, "noise": noise, "t_cls": 2 * cls,
              "prob_trans": lstm, "s_cls": 2.0 * b * f * sh.s[2]}
    table = {}
    for m in fwd:
        bwd = total[m] + sum(p.get(m, 0.0) for p in (pull_nf, pull_c, pull_5))
        table[m] = {"fwd": fwd[m], "bwd": bwd}
    return table


def classifier_fwd(channels: int, length: int, n_class: int, batch: int,
                   budget_scale: float, max_kernel: int) -> Dict[str, float]:
    """A served target model's forward over ``batch`` series: its two OS blocks, the
    extractor's shortcut and the head."""
    ext, cls = model.layer_specs(channels, length, max_kernel, budget_scale)
    feat = model.width(ext[-1])
    a = os_block(ext, batch, length)
    c = os_block(cls, batch, length)
    return {"flops": a["flops"] + c["flops"] + 2.0 * batch * length * channels * feat
            + 2.0 * batch * feat * n_class,
            "conv_flops": a["flops"] + c["flops"], "conv_bytes": a["bytes"] + c["bytes"]}
