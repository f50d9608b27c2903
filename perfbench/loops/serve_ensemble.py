"""Loop: a multi-source ensemble served as ``cli.predict`` serves several checkpoints.

A request is what ``cli.predict`` does once its members are loaded: the program's
``MultiSourceEnsemble.compute_class_weights`` on the target's train split,
``member_logits`` on a test split, ``entropy_precision_vote``, and the predictions back on
the host.  The members run under one ``torch.func.vmap``.  One client sends requests back to
back, each on the pool's next test split.  The members are random from the seed, each with
random BatchNorm state and its head scaled and centred on the train split, so that each
predicts every class and the vote has something to weigh.  Every ``member_logits`` result
(train split and test split) and every request's class weights, recorded where the program
produces them, are held against the reference's, and the served predictions against the
reference's vote under the class weights the reference accepts (``accepted_weights``).

The members are one a source of the configuration (``sources``), voted with its ``vote``
constants by the program and the reference alike.

Traffic keys: ``pool``, ``warmup``, ``head_scale``, ``trace_requests``,
``limits`` (``logit_gap``, ``weights_gap``, ``answer_gap``).
"""

from __future__ import annotations

import sys

import torch

from loops.serve_single import make_inputs, members, program_config
from harness import cell, port, precision, serving, trace, weights, work
from reference import model
from reference import serve as ref


def reference(r: "cell.Run", built, x_train, y_train, pool):
    """The reference's member logits on the train split, class weights, member logits on
    each pool split and vote scores on each, of the members ``built`` by ``members``."""
    t, device = r.config["target"], r.device
    tree, m_ext, m_cls = built
    ms = [weights.run_slice(tree, m) for m in range(len(r.config["sources"]))]
    vote = r.config["vote"]

    def member_logits(x):
        x = torch.as_tensor(x).to(device)
        return torch.stack([ref.logits(m, m_ext, m_cls, x) for m in ms])

    with torch.no_grad():
        want_train = member_logits(x_train)
        labels = torch.as_tensor(y_train).to(device)
        want_w = ref.class_weights(want_train.argmax(-1), labels, t["classes"])
        want = [member_logits(x) for x in pool]
        scores = [ref.vote_scores(lg, want_w, vote["entropy_scale"], vote["weight_base"])
                  for lg in want]
    return want_train, want_w, want, scores


def accepted_weights(r: "cell.Run", served_train_logits, want_train, y_train):
    """The reference's class weights on the train-split predictions it accepts of the served
    ones (``reference.serve.accepted``, within the logit limit of its best): a near tie
    broken the other way by rounding is no fault.  None where the shapes differ."""
    if served_train_logits.shape != want_train.shape:
        return None
    labels = torch.as_tensor(y_train).to(want_train.device)
    pred = ref.accepted(served_train_logits.argmax(-1), want_train, r.limit("logit_gap"))
    return ref.class_weights(pred, labels, r.config["target"]["classes"])


def weights_gap(r: "cell.Run", served_w, served_train_logits, want_train, y_train) -> float:
    """The served class weights against ``accepted_weights``."""
    want = accepted_weights(r, served_train_logits, want_train, y_train)
    if want is None:
        return float("inf")
    return float((served_w.double() - want.double()).abs().max())


def answer_gap(r: "cell.Run", preds, served_train_logits, want_train, y_train, want_logits) -> float:
    """The served vote against the reference's vote scores on the split's reference logits
    under ``accepted_weights``: the class weights a near tie in the train split moves are
    judged by ``weights_gap``, and the vote is judged under the weights it was given."""
    w = accepted_weights(r, served_train_logits, want_train, y_train)
    if w is None:
        return float("inf")
    vote = r.config["vote"]
    return serving.served_gap(preds, ref.vote_scores(want_logits, w, vote["entropy_scale"],
                                                     vote["weight_base"]))


def control(r: "cell.Run") -> dict:
    """The control's numbers: the reference in TF32 (logits, class weights, vote) served in
    the program's place."""
    w_seed, (x_train, y_train), pool = make_inputs(r)
    built = members(r.config, r.traffic, len(r.config["sources"]), w_seed, x_train, r.device)
    want_train, want_w, want, scores = reference(r, built, x_train, y_train, pool)
    with precision.tf32(r.device):
        low_train, low_w, low, low_scores = reference(r, built, x_train, y_train, pool)
    return {"logit_gap": max([serving.rel_gap(low_train, want_train)]
                             + [serving.rel_gap(a, b) for a, b in zip(low, want)]),
            "weights_gap": weights_gap(r, low_w, low_train, want_train, y_train),
            "answer_gap": max(answer_gap(r, s.argmax(-1).cpu().numpy(), low_train, want_train,
                                         y_train, lg) for s, lg in zip(low_scores, want))}


def run(r: "cell.Run") -> "cell.Outcome":
    config, traffic, device = r.config, r.traffic, r.device
    t = config["target"]
    n_members = len(config["sources"])
    w_seed, (x_train, y_train), pool = make_inputs(r)
    tree, _, _ = members(config, traffic, n_members, w_seed, x_train, device)
    voting = port.module("config").VotingConfig(
        entropy_scale=config["vote"]["entropy_scale"], weight_base=config["vote"]["weight_base"])
    ens = port.module("parallel.multi_source").MultiSourceEnsemble(
        t["channels"], t["length"], t["classes"], config=program_config(config), device=device,
        voting=voting)
    stacked = ens.stack([port.to_program(weights.run_slice(tree, m)) for m in range(n_members)])
    del tree
    vote = port.module("evaluation.voting").entropy_precision_vote
    recorder = serving.Recorder(ens, "member_logits")
    tracer = trace.Tracer(r.trace)
    n_pool = len(pool)

    def request(i: int):
        w = ens.compute_class_weights(stacked, x_train, y_train)
        logits = ens.member_logits(stacked, pool[i % n_pool])
        with tracer.span("vote"):
            preds = vote(logits, w, ens.voting).cpu().numpy()
        return i % n_pool, w, preds

    for i in range(traffic["warmup"]):
        request(i)
    recorder.take()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    loop = serving.closed_loop(request, r.seconds, device, tracer,
                               traffic["trace_requests"] if r.trace else 0)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    calls = recorder.take()
    del ens, stacked
    cell.free_device()

    # the reference, once the window has closed: the weights drawn again, each split once
    built = members(config, traffic, n_members, w_seed, x_train, device)
    want_train, want_w, want, scores = reference(r, built, x_train, y_train, pool)
    logit_gap = w_gap = a_gap = own_gap = 0.0
    moved = 0
    if len(calls) != 2 * len(loop.results):
        logit_gap = a_gap = float("inf")
    for i, (p, w, preds) in enumerate(loop.results):
        for got, exp in zip(calls[2 * i:2 * i + 2], (want_train, want[p])):
            logit_gap = max(logit_gap, serving.rel_gap(got, exp))
        if len(calls) > 2 * i:
            w_gap = max(w_gap, weights_gap(r, w, calls[2 * i], want_train, y_train))
            a_gap = max(a_gap, answer_gap(r, preds, calls[2 * i], want_train, y_train, want[p]))
            moved += int(not torch.equal(calls[2 * i].argmax(-1), want_train.argmax(-1)))
        own_gap = max(own_gap, serving.served_gap(preds, scores[p]))
    print(f"detail requests whose train-split predictions differ from the reference's: {moved} "
          f"of {len(loop.results)}; the vote against the reference's own weights: {own_gap!r}",
          file=sys.stderr)
    n_layers = sum(len(l) for l in model.layer_specs(t["channels"], t["length"],
                                                      config["max_kernel_size"],
                                                      config.get("budget_scale", 1.0)))
    fwd = [work.classifier_fwd(t["channels"], t["length"], t["classes"], n,
                               config.get("budget_scale", 1.0), config["max_kernel_size"])
           for n in (t["train"], t["test"])]
    per_request = {k: n_members * (fwd[0][k] + fwd[1][k]) for k in fwd[0]}
    n = len(loop.latencies)
    return cell.Outcome(
        metrics={"serve_series_per_s": n * t["test"] / loop.window_s,
                 "serve_request_p95_ms": 1e3 * cell.p95(loop.latencies)},
        attempted=len(loop.results), failed=0,
        checks=[cell.Check("logit_gap", logit_gap, r.limit("logit_gap")),
                cell.Check("weights_gap", w_gap, r.limit("weights_gap")),
                cell.Check("answer_gap", a_gap, r.limit("answer_gap"))],
        memory_peak_bytes=int(peak), window_start=loop.window_start, slice=loop.slice,
        traced_window_s=loop.traced_s,
        traced_units=n + (loop.slice.units if loop.slice is not None else 0),
        work={"model_flops": per_request["flops"], "osconv_flops": per_request["conv_flops"],
              "osconv_bytes": per_request["conv_bytes"],
              "osconv_calls": 2 * n_layers})
