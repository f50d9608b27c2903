"""The rank side of tests/test_torch_port_sequence.py: no JAX here.

``rank_main`` runs in each of the test's spawned gloo processes.  It takes
the cases as numpy arrays (the JAX package's parameters, flattened by their
tree paths), runs the port's time-sharded ops on its own shard on the CPU,
and returns numpy arrays: each output's shard, the input gradient's shard
and the rank's share of each parameter gradient (the gradient of
``sum(out_local * r_local)``, or of the rank's share of the WaveGlow loss).
"""

from __future__ import annotations

import numpy as np
import torch

from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import from_jax_params, tree_items
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import mesh as port_mesh
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import sequence as seq


def _tree(flat, grad=True):
    """The port tree of a flat JAX mapping, and its (key, leaf) pairs, each
    leaf a leaf tensor that takes a gradient."""
    tree = from_jax_params(flat)
    items = list(tree_items(tree))
    for _, t in items:
        t.requires_grad_(grad)
    return tree, items


def _grads(items):
    return {k: t.grad.numpy().copy() for k, t in items}


def _shard(a, m, axis="data", grad=False):
    x = seq.shard_time(torch.from_numpy(a), m, axis)
    return x.requires_grad_(grad)


def _projected(m, outs, rs):
    """sum(out_local * r_local) over pairs of local outputs and whole projections."""
    return sum((o * _shard(r, m)).sum() for o, r in zip(outs, rs))


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def os_conv_case(m, c):
    x = _shard(c["x"], m, grad=True)
    w, b = (torch.from_numpy(c[k]).requires_grad_() for k in ("w", "b"))
    y = seq.time_sharded_os_conv(m, x, w, b, torch.from_numpy(c["mask"]))
    _projected(m, [y], [c["r"]]).backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(), "db": b.grad.numpy()}


def dilated_case(m, c, axis="data"):
    out = {}
    for d in c["dilations"]:
        x = seq.shard_time(torch.from_numpy(c["x"]), m, axis).requires_grad_()
        w, b = (torch.from_numpy(c[k]).requires_grad_() for k in ("w", "b"))
        y = seq.time_sharded_dilated_conv(m, x, w, b, d, axis=axis)
        (y * seq.shard_time(torch.from_numpy(c["r"]), m, axis)).sum().backward()
        out[d] = {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(),
                  "db": b.grad.numpy()}
    return out


def wn_case(m, c):
    params, items = _tree(c["params"])
    x = _shard(c["x"], m, grad=True)
    y = seq.time_sharded_wn_apply(m, params, x, c["n_ch"])
    _projected(m, [y], [c["r"]]).backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "grads": _grads(items)}


def waveglow_case(m, c):
    """The rank's share of the WaveGlow NLL: its own z and log_s terms and
    1/P of the replicated log-determinants, all over B * T_global * C."""
    params, items = _tree(c["params"])
    x = _shard(c["x"], m, grad=True)
    z, log_s, log_det = seq.time_sharded_waveglow_forward(m, params, x, c["n_ch"])
    n = m.size(0)
    b, t_local, ch = z.shape
    loss = (torch.sum(z * z) / 2 - sum(ls.sum() for ls in log_s)
            - sum(log_det) / n) / (b * t_local * n * ch)
    loss.backward()
    return {"z": z.detach().numpy(), "log_s": [ls.detach().numpy() for ls in log_s],
            "log_det": [float(v) for v in log_det], "loss": float(loss),
            "dx": x.grad.numpy(), "grads": _grads(items)}


def ext_case(m, c):
    out = {}
    for training in (False, True):
        params, items = _tree(c["params"])
        state = from_jax_params(c["state"])
        masks = [torch.from_numpy(k) for k in c["masks"]]
        x = _shard(c["x"], m, grad=True)
        y, new_state = seq.time_sharded_os_cnn_res_apply(m, params, state, masks, x,
                                                          training=training)
        _projected(m, [y], [c["r"]]).backward()
        out[training] = {"y": y.detach().numpy(), "dx": x.grad.numpy(), "grads": _grads(items),
                         "state": {k: v.detach().numpy() for k, v in tree_items(new_state)}}
    return out


def rank_main(rank, world_size, init_method, cases):
    """Every case on this rank's shards; the meshes' names, shapes and
    coordinates; the refusals."""
    torch.set_num_threads(1)
    with launch.process_group(rank, world_size, init_method, "gloo", timeout=120):
        m = port_mesh.make_mesh(data=4, device="cpu")
        m22 = port_mesh.make_mesh(data=2, domain=2, device="cpu")
        out = {
            "mesh": {"names": m.mesh_dim_names, "shape": tuple(m.shape),
                     "coordinate": tuple(m.get_coordinate()),
                     "default": tuple(port_mesh.make_mesh(device="cpu").shape)},
            "mesh22": {"names": m22.mesh_dim_names, "shape": tuple(m22.shape),
                       "coordinate": tuple(m22.get_coordinate())},
            "too_many": _raises(lambda: port_mesh.make_mesh(data=8, device="cpu")),
            "os_conv": os_conv_case(m, cases["os_conv"]),
            "dilated": dilated_case(m, cases["dilated"]),
            "dilated22": dilated_case(m22, cases["dilated22"]),
            "wn": wn_case(m, cases["wn"]),
            "waveglow": waveglow_case(m, cases["waveglow"]),
            "ext": ext_case(m, cases["ext"]),
        }
        short = cases["short"]
        out["short_shard"] = _raises(lambda: seq.time_sharded_dilated_conv(
            m, _shard(short["x"], m), torch.from_numpy(short["w"]), torch.from_numpy(short["b"]),
            short["dilation"]))
        out["indivisible"] = _raises(lambda: seq.shard_time(torch.from_numpy(cases["indivisible"]), m))
        gathered = seq.gather_time(_shard(cases["dilated"]["x"], m), m).numpy()
        out["gather_round_trip"] = bool(np.array_equal(gathered, cases["dilated"]["x"]))
    return out
