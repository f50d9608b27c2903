"""Loop: one served checkpoint, ``cli.predict``'s path, one client, closed loop.

A request is the program's ``TargetPredictor.predict_target`` on a test split (the config's
``test`` series), in batches of the configuration's batch size dispatched ahead, with the
predictions back on the host.  Requests take the pool's splits in turn.  The model is
random from the seed, its BatchNorm state random too, its head scaled and centred on the
train split so that it predicts every class.  Every request's logits, recorded where the
program produces them, are held against the reference's, and its predictions against the
reference's best logits.

Traffic keys: ``pool``, ``warmup``, ``head_scale``, ``trace_requests``, ``limits``
(``logit_gap``, ``answer_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from harness import cell, data, port, precision, serving, trace, weights, work
from reference import model
from reference import serve as ref


def program_config(config):
    return port.module("config").PipelineConfig(
        batch_size=config["batch_size"], max_kernel_size=config["max_kernel_size"],
        budget_multiplier=config.get("budget_scale", 1.0))


def members(config, traffic, n: int, seed: int, x_center: np.ndarray, device):
    """``n`` served classifiers on the device (a leading member axis), and the masks."""
    t = config["target"]
    ext, cls = model.layer_specs(t["channels"], t["length"], config["max_kernel_size"],
                                 config.get("budget_scale", 1.0))
    specs = model.classifier_specs(t["channels"], t["length"], t["classes"],
                                   config.get("budget_scale", 1.0), config["max_kernel_size"])
    m_ext, m_cls = ref.masks(ext, device), ref.masks(cls, device)
    tree = weights.served_members(specs, n, seed, device, torch.as_tensor(x_center).to(device),
                                  lambda m, x: ref.logits(m, m_ext, m_cls, x),
                                  traffic["head_scale"])
    return tree, m_ext, m_cls


def make_inputs(r: "cell.Run"):
    """(the weights' seed, the train split (x, y), the pool of test splits) from the seed."""
    t = r.config["target"]
    rng = np.random.default_rng(r.seed)
    w_seed = int(rng.integers(0, 2**62))
    train = data.series(t["train"], t["channels"], t["length"], t["classes"], rng)
    pool = [data.series(t["test"], t["channels"], t["length"], t["classes"], rng)[0]
            for _ in range(r.traffic["pool"])]
    return w_seed, train, pool


def control(r: "cell.Run") -> dict:
    """The control's numbers: the reference's logits in TF32 served in the program's place."""
    t = r.config["target"]
    w_seed, (x_train, _), pool = make_inputs(r)
    tree, m_ext, m_cls = members(r.config, r.traffic, 1, w_seed, x_train, r.device)
    member = weights.run_slice(tree, 0)
    logit_gap = answer_gap = 0.0
    for x in pool:
        x = torch.as_tensor(x).to(r.device)
        want = ref.logits(member, m_ext, m_cls, x)
        with precision.tf32(r.device):
            low = ref.logits(member, m_ext, m_cls, x)
        logit_gap = max(logit_gap, serving.rel_gap(low, want))
        answer_gap = max(answer_gap, serving.served_gap(low.argmax(-1).cpu().numpy(), want))
    return {"logit_gap": logit_gap, "answer_gap": answer_gap}


def run(r: "cell.Run") -> "cell.Outcome":
    config, traffic, device = r.config, r.traffic, r.device
    t = config["target"]
    w_seed, (x_train, _), pool = make_inputs(r)
    tree, m_ext, m_cls = members(config, traffic, 1, w_seed, x_train, device)
    member = weights.run_slice(tree, 0)
    state = port.to_program({"params": {"t_ext": member["params"]["ext"],
                                        "t_cls": member["params"]["cls"]},
                             "mstate": {"t_ext": member["mstate"]["ext"],
                                        "t_cls": member["mstate"]["cls"]}})
    predictor = port.module("train.pipeline").TargetPredictor(
        t["channels"], t["length"], t["classes"], config=program_config(config), device=device)
    recorder = serving.Recorder(predictor, "predict_logits")
    n_pool = len(pool)

    def request(i: int):
        return i % n_pool, predictor.predict_target(state, pool[i % n_pool])

    for i in range(traffic["warmup"]):
        request(i)
    recorder.take()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    loop = serving.closed_loop(request, r.seconds, device, trace.Tracer(r.trace),
                               traffic["trace_requests"] if r.trace else 0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    calls = recorder.take()
    del predictor, state
    cell.free_device()

    # the reference, once the window has closed: the weights drawn again, each split once
    tree, m_ext, m_cls = members(config, traffic, 1, w_seed, x_train, device)
    member = weights.run_slice(tree, 0)
    with torch.no_grad():
        want = [ref.logits(member, m_ext, m_cls, torch.as_tensor(x).to(device)) for x in pool]
    per = -(-t["test"] // config["batch_size"])
    logit_gap = answer_gap = 0.0
    for i, (p, preds) in enumerate(loop.results):
        got = torch.cat(calls[i * per:(i + 1) * per])[:t["test"]]
        logit_gap = max(logit_gap, serving.rel_gap(got, want[p]))
        answer_gap = max(answer_gap, serving.served_gap(preds, want[p]))
    if len(calls) != per * len(loop.results):
        logit_gap = float("inf")
    fwd = work.classifier_fwd(t["channels"], t["length"], t["classes"], config["batch_size"],
                              config.get("budget_scale", 1.0), config["max_kernel_size"])
    per_request = {k: per * v for k, v in fwd.items()}
    n = len(loop.latencies)
    return cell.Outcome(
        metrics={"serve_series_per_s": n * t["test"] / loop.window_s,
                 "serve_request_p95_ms": 1e3 * cell.p95(loop.latencies)},
        attempted=len(loop.results), failed=0,
        checks=[cell.Check("logit_gap", logit_gap, r.limit("logit_gap")),
                cell.Check("answer_gap", answer_gap, r.limit("answer_gap"))],
        memory_peak_bytes=int(peak), window_start=loop.window_start, slice=loop.slice,
        traced_window_s=loop.traced_s,
        traced_units=n + (loop.slice.units if loop.slice is not None else 0),
        work={"model_flops": per_request["flops"], "osconv_flops": per_request["conv_flops"],
              "osconv_bytes": per_request["conv_bytes"],
              "osconv_calls": per * (len(m_ext) + len(m_cls))})
