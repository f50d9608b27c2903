#!/usr/bin/env python3
"""Where chip_smoke.py phase 21's sharded gradients leave the unsharded ones, on one CUDA card.

Three passes at phase 21's inputs (``chip_smoke.sequence_inputs``: EigenWorms'
shape, batch 20), each on 4 ranks that share the card (gloo) and on the
unsharded ops, the relative L2 distance of every gradient printed:

* ``flow_grad``: the flow alone on the training-mode features, the
  gradient of phase 21's projection at the features;
* ``ext_train``: the extractor alone in training mode (BatchNorm statistics
  over the ranks), the gradient of a fixed random projection of its
  features to the input and every parameter;
* ``ext_eval``: the same in eval mode (running statistics, no all-reduce),
  where the features agree bit for bit.

Each pass also counts the final ReLU's inputs that fall on the other side
of zero than the unsharded ones.  Run from the repository root:
``python3 experiments/sequence_grad_gap.py`` (about a minute with the build).
"""

import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def passes(inp, seq=None, mesh=None) -> dict:
    """The three passes on ``mesh`` (each rank its shards) or unsharded."""
    from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import tree_items
    from feature_level_style_transfer_for_tsc_tpu_torch.models.flow import waveglow_forward
    from feature_level_style_transfer_for_tsc_tpu_torch.models.os_cnn import os_cnn_res_apply

    gen = torch.Generator(device="cuda").manual_seed(7)
    proj_f = torch.randn(*inp["x"].shape[:2], inp["proj_z"].shape[2], device="cuda", generator=gen)

    def shard(t):
        return seq.shard_time(t, mesh) if mesh is not None else t.clone()

    leaves = list(tree_items(inp["ext_p"]))
    out = {}
    for name in ("flow_grad", "ext_train", "ext_eval"):
        for _, p in leaves:
            p.requires_grad_(True)
            p.grad = None
        x = shard(inp["x"]).requires_grad_(True)
        training = name != "ext_eval"
        if mesh is None:
            f, _ = os_cnn_res_apply(inp["ext_p"], inp["ext_s"], inp["masks"], x, training)
        else:
            f, _ = seq.time_sharded_os_cnn_res_apply(mesh, inp["ext_p"], inp["ext_s"],
                                                     inp["masks"], x, training=training)
        positive = (f > 0).cpu()
        if name == "flow_grad":
            f = f.detach().requires_grad_(True)
            if mesh is None:
                z, log_s, log_det = waveglow_forward(inp["flow_p"], f, inp["n_wn"])
                parts = 1
            else:
                z, log_s, log_det = seq.time_sharded_waveglow_forward(mesh, inp["flow_p"], f,
                                                                      inp["n_wn"])
                parts = mesh.size(0)
            loss = (z * shard(inp["proj_z"])).sum() \
                + sum((a * shard(b)).sum() for a, b in zip(log_s, inp["proj_ls"])) \
                + (torch.stack(log_det) * inp["proj_ld"]).sum() / parts
            loss.backward()
            out[name] = {"positive": positive, "features": f.grad.cpu()}
        else:
            (f * shard(proj_f)).sum().backward()
            out[name] = {"positive": positive, "input": x.grad.cpu(),
                         **{k: p.grad.cpu() for k, p in leaves}}
    return out


def rank(r: int, world: int, init_method: str, out_dir: str, batch: int) -> int:
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch, make_mesh
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import sequence as seq

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with launch.process_group(r, world, init_method, cs.SEQ_BACKEND):
        mesh = make_mesh(data=world)
        torch.save(passes(cs.sequence_inputs(batch), seq, mesh), Path(out_dir) / f"rank{r}.pt")
    return r


def main() -> None:
    from feature_level_style_transfer_for_tsc_tpu_torch.ops import _build, gate, osconv
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build_kernels(_build, ["os_conv", "tap_conv", "gate"])
    osconv._lib(), osconv._tap_lib(), gate._lib()
    batch = 20
    inp = cs.sequence_inputs(batch)
    with cs.environ(**cs.OP_BY_OP):
        ref = passes(inp)
    del inp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        launch.spawn(rank, cs.SEQ_RANKS, (f"file://{d}/rendezvous", d, batch), timeout=cs.SEQ_TIMEOUT)
        shards = [torch.load(Path(d) / f"rank{r}.pt") for r in range(cs.SEQ_RANKS)]
    for name, want in ref.items():
        pos = torch.cat([s[name]["positive"] for s in shards], dim=1)
        print(f"{name}: final ReLU flips {int((pos != want['positive']).sum())} of {pos.numel()}")
        for k, v in want.items():
            if k == "positive":
                continue
            if k in ("features", "input"):
                got = torch.cat([s[name][k] for s in shards], dim=1)
            else:
                got = sum(s[name][k] for s in shards)
            print(f"  {k}: relative L2 {cs.rel_l2(got, v)[1]:.3e}, max|unsharded| "
                  f"{v.abs().max().item():.3e}", flush=True)


if __name__ == "__main__":
    main()
