"""The port's time-sharded sequence parallelism against the JAX package's, on the CPU.

The port's ``parallel/sequence.py`` and ``parallel/mesh.py`` run in 4 gloo
processes, spawned once for this module (``tests/_torch_port_sequence_ranks.py``,
one torch thread a rank, rendezvous through a file under ``tmp_path``); each
rank runs every case on its own time shard and sends back its output
shards, input-gradient shards and its share of each parameter gradient.
They are held against:

* JAX's ``time_sharded_*`` on ``make_mesh(data=4)`` (4 of the 8 virtual CPU
  devices of conftest.py), and JAX's unsharded op, as tests/test_parallel.py
  holds JAX's own: atol 1e-5 on outputs, 1e-4 on log-determinants, rtol
  1e-5 on the WaveGlow loss;
* for gradients, ``jax.grad`` through JAX's ``time_sharded_*`` (which
  transposes its ``ppermute``/``psum``) and the port's unsharded autograd,
  of ``sum(out * r)`` for a fixed random r (the WaveGlow NLL for the flow);
  the ranks' parameter-gradient shares summed first.  Tolerance: f32 on
  both sides with sums over the batch rows in another order, rtol 1e-5 and
  atol 1e-5 of the largest |gradient|.  The input-gradient rows within a
  halo of a shard edge, where a missing adjoint shows first, are asserted
  on their own before the whole.

The inputs are numpy arrays from a seed and the parameters are the JAX
package's, carried across by their tree paths (``from_jax_params``).  On
the CPU the port runs the kernels' plain versions; ``chip_smoke.py`` phase
21 runs the kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_sequence_ranks import rank_main

from feature_level_style_transfer_for_tsc_tpu.models import flow as j_flow
from feature_level_style_transfer_for_tsc_tpu.models import os_cnn as j_os_cnn
from feature_level_style_transfer_for_tsc_tpu.ops import osconv as j_osconv
from feature_level_style_transfer_for_tsc_tpu.ops.batchnorm import BNStats as JBNStats
from feature_level_style_transfer_for_tsc_tpu.parallel import make_mesh as j_make_mesh
from feature_level_style_transfer_for_tsc_tpu.parallel import sequence as j_seq
from feature_level_style_transfer_for_tsc_tpu_torch.io.checkpoint import from_jax_params, tree_items
from feature_level_style_transfer_for_tsc_tpu_torch.models import flow
from feature_level_style_transfer_for_tsc_tpu_torch.models import os_cnn
from feature_level_style_transfer_for_tsc_tpu_torch.ops import osconv
from feature_level_style_transfer_for_tsc_tpu_torch.parallel import launch

P = 4
OUT = {"atol": 1e-5, "rtol": 0}
LOGDET = {"atol": 1e-4, "rtol": 0}
DILATIONS = (1, 2, 4, 8)
BN_FED_NOISE = 1e-4  # |gradient| of a conv bias feeding a training-mode BatchNorm (zero exactly)
OS_SPEC = [(3, 4, 1), (3, 4, 3), (3, 4, 5)]
EXT_SPECS = [OS_SPEC, [(12, 5, 1), (12, 5, 2)]]  # the last layer's K = 2: halos (0, 1)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _with_ends(wn, rng, scale=0.3):
    """A WN whose end projection is not the init's zero, so that every
    layer has a gradient."""
    return {**wn, "end": {"weight": jnp.asarray(_rand(rng, *wn["end"]["weight"].shape, scale=scale)),
                          "bias": jnp.asarray(_rand(rng, *wn["end"]["bias"].shape, scale=scale))}}


def _cases():
    rng = np.random.default_rng(0)
    os_p = j_osconv.init_os_conv_params(jax.random.PRNGKey(0), OS_SPEC)
    wn = _with_ends(j_flow.wn_init(jax.random.PRNGKey(0), 4, n_layers=3, n_channels=8), rng)
    wg = j_flow.waveglow_init(jax.random.PRNGKey(0), 2, 6, 8, n_wn_layers=3)
    wg = {**wg, "wn": [_with_ends(w, rng) for w in wg["wn"]]}
    ext_p, ext_s = j_os_cnn.os_cnn_res_init(jax.random.PRNGKey(0), EXT_SPECS)
    # non-trivial running statistics, so that eval mode normalizes with them
    ext_s = jax.tree_util.tree_map(
        lambda s: JBNStats(jnp.asarray(_rand(rng, *s.mean.shape, scale=0.2)),
                           jnp.asarray(rng.uniform(0.5, 1.5, s.var.shape).astype(np.float32))),
        ext_s, is_leaf=lambda s: isinstance(s, JBNStats))
    return {
        "os_conv": {"x": _rand(rng, 2, 32, 3), "w": np.asarray(os_p["weight"]),
                    "b": np.asarray(os_p["bias"]), "mask": j_osconv.build_os_mask(OS_SPEC),
                    "r": _rand(rng, 2, 32, 12)},
        "dilated": {"x": _rand(rng, 2, 32, 6), "w": _rand(rng, 3, 6, 10, scale=0.2),
                    "b": _rand(rng, 10, scale=0.1), "r": _rand(rng, 2, 32, 10),
                    "dilations": DILATIONS},
        "dilated22": {"x": _rand(rng, 2, 16, 6), "w": _rand(rng, 3, 6, 10, scale=0.2),
                      "b": _rand(rng, 10, scale=0.1), "r": _rand(rng, 2, 16, 10),
                      "dilations": (1, 4, 8)},
        "wn": {"params": _flat(wn), "x": _rand(rng, 2, 32, 4), "r": _rand(rng, 2, 32, 8),
               "n_ch": 8},
        "waveglow": {"params": _flat(wg), "x": _rand(rng, 3, 32, 6), "n_ch": 8},
        "ext": {"params": _flat(ext_p), "state": _flat(ext_s),
                "masks": j_os_cnn.os_block_masks(EXT_SPECS), "x": _rand(rng, 2, 32, 3),
                "r": _rand(rng, 2, 32, 10)},
        "short": {"x": _rand(rng, 2, 8, 6), "w": _rand(rng, 3, 6, 10), "b": _rand(rng, 10),
                  "dilation": 4},
        "indivisible": _rand(rng, 2, 30, 6),
    }


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here, as in the ranks: the suite runs several
    worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(cases, each rank's results): the 4 gloo ranks, spawned once."""
    cases = _cases()
    rdv = tmp_path_factory.mktemp("rendezvous") / "store"
    results = launch.spawn(rank_main, P, (f"file://{rdv}", cases), timeout=240)
    return cases, results


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(data=P, domain=1)


def _at(result, path):
    for p in path:
        result = result[p]
    return result


def _cat(results, *path):
    """The whole series from the ranks' shards at ``path``."""
    return np.concatenate([_at(r, path) for r in results], axis=1)


def _summed(results, *path):
    """The sum over the ranks of their shares at ``path`` (an array, or a
    mapping of arrays)."""
    first = _at(results[0], path)
    if isinstance(first, dict):
        return {k: sum(_at(r, path)[k] for r in results) for k in first}
    return sum(_at(r, path) for r in results)


def _close_grad(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _edge_rows(t: int, halo: int):
    """The time rows within ``halo`` of an inner shard edge."""
    s = t // P
    return sorted({r for e in range(s, t, s) for r in range(e - halo, e + halo) if 0 <= r < t})


def _close_dx(got, want, halo, what):
    rows = _edge_rows(got.shape[1], halo)
    _close_grad(got[:, rows], np.asarray(want)[:, rows], f"{what}: rows at the shard edges")
    _close_grad(got, want, what)


def _jax_tree(flat):
    """The JAX tree of a flat mapping (through the port's reader: dicts,
    lists and the BNStats of each package line up by their tree paths)."""
    tree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), from_jax_params(flat))
    return jax.tree_util.tree_map(lambda s: JBNStats(*s) if isinstance(s, tuple) else s, tree,
                                  is_leaf=lambda s: isinstance(s, tuple))


def _grad(fn, *args):
    """``jax.grad`` of ``fn`` in every argument, jitted: eager dispatch
    through the shard_maps takes minutes, and the extractor's (whose
    shard_map has ``check_vma=False``) is refused outside ``jit``."""
    return jax.jit(jax.grad(fn, argnums=tuple(range(len(args)))))(*args)


def _torch_leaves(flat):
    tree = from_jax_params(flat)
    items = list(tree_items(tree))
    for _, t in items:
        t.requires_grad_(True)
    return tree, items


# ------------------------------------------------------------------ mesh --

def test_mesh_names_sizes_and_coordinates(ranks):
    """``make_mesh(data=4)`` and ``make_mesh(data=2, domain=2)`` on the four
    ranks: JAX's axis names and sizes, rank r at (r // domain, r % domain);
    the default puts every rank on "data"."""
    _, results = ranks
    j4, j22 = j_make_mesh(data=4, domain=1), j_make_mesh(data=2, domain=2)
    for r, res in enumerate(results):
        assert res["mesh"]["names"] == tuple(j4.axis_names) == ("data", "domain")
        assert res["mesh"]["shape"] == j4.devices.shape == (4, 1)
        assert res["mesh"]["default"] == (4, 1)
        assert res["mesh"]["coordinate"] == (r, 0)
        assert res["mesh22"]["names"] == tuple(j22.axis_names)
        assert res["mesh22"]["shape"] == j22.devices.shape == (2, 2)
        assert res["mesh22"]["coordinate"] == (r // 2, r % 2)


def test_mesh_refuses_more_ranks_than_exist(ranks):
    """JAX's message: "need N devices, have M"."""
    _, results = ranks
    with pytest.raises(AssertionError) as jax_err:
        j_make_mesh(data=8, domain=1, devices=jax.devices()[:P])
    for res in results:
        assert res["too_many"] == str(jax_err.value) == "need 8 devices, have 4"


def test_make_mesh_needs_a_process_group():
    from feature_level_style_transfer_for_tsc_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(data=1, device="cpu")


# ------------------------------------------------------------- refusals --

def test_refusals(ranks):
    """A shard shorter than its halo (JAX's message), T not divisible by the
    axis size; and the gather puts the shards back in order."""
    _, results = ranks
    for res in results:
        assert res["short_shard"] == ("time shard of 2 steps cannot donate a 4-step halo; "
                                      "use fewer shards")
        assert "not divisible by the 4 shards" in res["indivisible"]
        assert res["gather_round_trip"]


# --------------------------------------------------------------- OS conv --

def test_os_conv_matches_jax(ranks, jmesh):
    """tests/test_parallel.py:128's case: the 3-branch spec, K = 5."""
    cases, results = ranks
    c = cases["os_conv"]
    args = [jnp.asarray(c[k]) for k in ("x", "w", "b", "mask")]
    got = _cat(results, "os_conv", "y")
    np.testing.assert_allclose(got, np.asarray(j_seq.time_sharded_os_conv(jmesh, *args)), **OUT)
    np.testing.assert_allclose(got, np.asarray(j_osconv.masked_os_conv(*args)), **OUT)


def test_os_conv_grads(ranks, jmesh):
    cases, results = ranks
    c = cases["os_conv"]
    x, w, b, mask, r = (jnp.asarray(c[k]) for k in ("x", "w", "b", "mask", "r"))
    want = _grad(lambda x, w, b: jnp.sum(j_seq.time_sharded_os_conv(jmesh, x, w, b, mask) * r),
                 x, w, b)
    got = (_cat(results, "os_conv", "dx"), _summed(results, "os_conv", "dw"),
           _summed(results, "os_conv", "db"))
    xt, wt, bt = (torch.tensor(c[k], requires_grad=True) for k in ("x", "w", "b"))
    y = osconv.masked_os_conv(xt, wt, bt, torch.from_numpy(c["mask"]))
    port = torch.autograd.grad((y * torch.from_numpy(c["r"])).sum(), (xt, wt, bt))
    for ref, wants in (("JAX sharded", want), ("port unsharded", [p.numpy() for p in port])):
        _close_dx(got[0], wants[0], 2, f"dx vs {ref}")
        _close_grad(got[1], wants[1], f"dw vs {ref}")
        _close_grad(got[2], wants[2], f"db vs {ref}")


# ----------------------------------------------------------- dilated conv --

@pytest.mark.parametrize("dilation", DILATIONS)
def test_dilated_conv_matches_jax(ranks, jmesh, dilation):
    """tests/test_parallel.py:240's case, value and gradients; at d = 8 each
    8-step shard gives its whole self as the halo."""
    cases, results = ranks
    c = cases["dilated"]
    x, w, b, r = (jnp.asarray(c[k]) for k in ("x", "w", "b", "r"))
    got = _cat(results, "dilated", dilation, "y")
    np.testing.assert_allclose(
        got, np.asarray(j_seq.time_sharded_dilated_conv(jmesh, x, w, b, dilation)), **OUT)
    np.testing.assert_allclose(got, np.asarray(j_flow._dilated_conv_same(x, w, b, dilation)), **OUT)
    want = _grad(
        lambda x, w, b: jnp.sum(j_seq.time_sharded_dilated_conv(jmesh, x, w, b, dilation) * r),
        x, w, b)
    xt, wt, bt = (torch.tensor(c[k], requires_grad=True) for k in ("x", "w", "b"))
    y = flow._dilated_conv_same(xt, wt, bt, dilation)
    port = torch.autograd.grad((y * torch.from_numpy(c["r"])).sum(), (xt, wt, bt))
    for ref, wants in (("JAX sharded", want), ("port unsharded", [p.numpy() for p in port])):
        _close_dx(_cat(results, "dilated", dilation, "dx"), wants[0], dilation, f"dx vs {ref}")
        _close_grad(_summed(results, "dilated", dilation, "dw"), wants[1], f"dw vs {ref}")
        _close_grad(_summed(results, "dilated", dilation, "db"), wants[2], f"db vs {ref}")


def test_dilated_conv_on_a_2x2_mesh(ranks):
    """Axis "data" of ``make_mesh(data=2, domain=2)``: each "domain" column
    is a group of 2 ranks (0, 2 and 1, 3) that shards the series in halves,
    against JAX's same mesh; each column's parameter shares summed."""
    cases, results = ranks
    c = cases["dilated22"]
    jmesh22 = j_make_mesh(data=2, domain=2)
    x, w, b, r = (jnp.asarray(c[k]) for k in ("x", "w", "b", "r"))
    for d in c["dilations"]:
        want_y = np.asarray(j_seq.time_sharded_dilated_conv(jmesh22, x, w, b, d))
        want = _grad(
            lambda x, w, b: jnp.sum(j_seq.time_sharded_dilated_conv(jmesh22, x, w, b, d) * r),
            x, w, b)
        for column in ((0, 2), (1, 3)):
            col = [results[i] for i in column]
            np.testing.assert_allclose(_cat(col, "dilated22", d, "y"), want_y, **OUT)
            _close_grad(_cat(col, "dilated22", d, "dx"), want[0], f"dx d={d} ranks {column}")
            _close_grad(_summed(col, "dilated22", d, "dw"), want[1], f"dw d={d} ranks {column}")
            _close_grad(_summed(col, "dilated22", d, "db"), want[2], f"db d={d} ranks {column}")


# --------------------------------------------------------------------- WN --

def test_wn_matches_jax(ranks, jmesh):
    """tests/test_parallel.py:260's case (3 layers, 8 channels) with a
    non-zero end projection."""
    cases, results = ranks
    c = cases["wn"]
    params, x = _jax_tree(c["params"]), jnp.asarray(c["x"])
    got = _cat(results, "wn", "y")
    sharded = jax.jit(lambda p, x: j_seq.time_sharded_wn_apply(jmesh, p, x, 8))(params, x)
    np.testing.assert_allclose(got, np.asarray(sharded), **OUT)
    np.testing.assert_allclose(got, np.asarray(jax.jit(j_flow.wn_apply, static_argnums=2)(
        params, x, 8)), **OUT)


def test_wn_grads(ranks, jmesh):
    cases, results = ranks
    c = cases["wn"]
    params, x, r = _jax_tree(c["params"]), jnp.asarray(c["x"]), jnp.asarray(c["r"])
    want_p, want_x = _grad(
        lambda p, x: jnp.sum(j_seq.time_sharded_wn_apply(jmesh, p, x, 8) * r), params, x)
    tree, items = _torch_leaves(c["params"])
    xt = torch.tensor(c["x"], requires_grad=True)
    loss = (flow.wn_apply(tree, xt, 8, dilated_conv=flow._dilated_conv_same)
            * torch.from_numpy(c["r"])).sum()
    port = torch.autograd.grad(loss, [xt] + [t for _, t in items])
    got = _summed(results, "wn", "grads")
    halo = 2 ** 2  # the widest layer's
    _close_dx(_cat(results, "wn", "dx"), want_x, halo, "dx vs JAX sharded")
    _close_dx(_cat(results, "wn", "dx"), port[0].numpy(), halo, "dx vs port unsharded")
    want_flat = _flat(want_p)
    for (k, _), pg in zip(items, port[1:]):
        _close_grad(got[k], want_flat[k], f"{k} vs JAX sharded")
        _close_grad(got[k], pg.numpy(), f"{k} vs port unsharded")


# --------------------------------------------------------------- WaveGlow --

def test_waveglow_matches_jax(ranks, jmesh):
    """tests/test_parallel.py:275's case (2 flows of a 3-layer WN over 6
    channels, B = 3), non-zero WN ends: z, log_s, the global-length
    log-determinants (the same on every rank) and the NLL."""
    cases, results = ranks
    c = cases["waveglow"]
    params, x = _jax_tree(c["params"]), jnp.asarray(c["x"])
    sharded = jax.jit(lambda p, x: j_seq.time_sharded_waveglow_forward(jmesh, p, x, 8))(params, x)
    whole = jax.jit(lambda p, x: j_flow.waveglow_forward(p, x, 8))(params, x)
    z = _cat(results, "waveglow", "z")
    log_s = [np.concatenate([r["waveglow"]["log_s"][k] for r in results], axis=1) for k in range(2)]
    for want in (sharded, whole):
        np.testing.assert_allclose(z, np.asarray(want[0]), **OUT)
        for a, b in zip(log_s, want[1]):
            np.testing.assert_allclose(a, np.asarray(b), **OUT)
        for res in results:
            np.testing.assert_allclose(res["waveglow"]["log_det"], [float(v) for v in want[2]],
                                       **LOGDET)
    want_loss = float(j_flow.waveglow_loss(whole))
    np.testing.assert_allclose(float(j_flow.waveglow_loss(sharded)), want_loss, rtol=1e-5)
    got_loss = sum(res["waveglow"]["loss"] for res in results)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


def test_waveglow_grads(ranks, jmesh):
    """The NLL's gradients: the ranks' shares (each rank's z and log_s
    terms and 1/P of the replicated log-determinants) summed."""
    cases, results = ranks
    c = cases["waveglow"]
    params, x = _jax_tree(c["params"]), jnp.asarray(c["x"])
    want_p, want_x = _grad(
        lambda p, x: j_flow.waveglow_loss(j_seq.time_sharded_waveglow_forward(jmesh, p, x, 8)),
        params, x)
    tree, items = _torch_leaves(c["params"])
    xt = torch.tensor(c["x"], requires_grad=True)
    z, ls, ld = flow.waveglow_forward(tree, xt, 8)
    port = torch.autograd.grad(flow.waveglow_loss((z, ls, ld)), [xt] + [t for _, t in items])
    got = _summed(results, "waveglow", "grads")
    halo = 2 ** 2
    _close_dx(_cat(results, "waveglow", "dx"), want_x, halo, "dx vs JAX sharded")
    _close_dx(_cat(results, "waveglow", "dx"), port[0].numpy(), halo, "dx vs port unsharded")
    want_flat = _flat(want_p)
    for (k, _), pg in zip(items, port[1:]):
        _close_grad(got[k], want_flat[k], f"{k} vs JAX sharded")
        _close_grad(got[k], pg.numpy(), f"{k} vs port unsharded")


# -------------------------------------------------------------- extractor --

@pytest.mark.parametrize("training", [False, True])
def test_extractor_matches_jax(ranks, jmesh, training):
    """tests/test_parallel.py:303's case (OS_CNN_res of two layers, the last
    K = 2) with non-trivial running statistics: the features and the new
    running statistics (global in training, the same on every rank)."""
    cases, results = ranks
    c = cases["ext"]
    params, state = _jax_tree(c["params"]), _jax_tree(c["state"])
    masks = [jnp.asarray(m) for m in c["masks"]]
    x = jnp.asarray(c["x"])
    sharded = jax.jit(lambda p, s, x: j_seq.time_sharded_os_cnn_res_apply(
        jmesh, p, s, masks, x, training=training))(params, state, x)
    whole = jax.jit(lambda p, s, x: j_os_cnn.os_cnn_res_apply(p, s, masks, x, training))(
        params, state, x)
    got = _cat(results, "ext", training, "y")
    for want_y, want_state in (sharded, whole):
        np.testing.assert_allclose(got, np.asarray(want_y), **OUT)
        want_flat = _flat(want_state)
        for res in results:
            for k, v in res["ext"][training]["state"].items():
                np.testing.assert_allclose(v, want_flat[k], **OUT, err_msg=k)


@pytest.mark.parametrize("training", [False, True])
def test_extractor_grads(ranks, jmesh, training):
    """In training the gradient runs through the all-reduced statistics.
    There the conv biases, which feed a training-mode BatchNorm, have a zero
    gradient in exact arithmetic (the batch mean takes them out again): each
    side's value is rounding noise of sums that cancel, about 1e-6 here
    beside gradients of order 1, so those leaves are held to zero within
    BN_FED_NOISE rather than to each other."""
    cases, results = ranks
    c = cases["ext"]
    params, state = _jax_tree(c["params"]), _jax_tree(c["state"])
    masks = [jnp.asarray(m) for m in c["masks"]]
    x, r = jnp.asarray(c["x"]), jnp.asarray(c["r"])
    want_p, want_x = _grad(
        lambda p, x: jnp.sum(j_seq.time_sharded_os_cnn_res_apply(
            jmesh, p, state, masks, x, training=training)[0] * r), params, x)
    tree, items = _torch_leaves(c["params"])
    xt = torch.tensor(c["x"], requires_grad=True)
    y, _ = os_cnn.os_cnn_res_apply(tree, from_jax_params(c["state"]),
                                   [torch.from_numpy(m) for m in c["masks"]], xt, training)
    port = torch.autograd.grad((y * torch.from_numpy(c["r"])).sum(), [xt] + [t for _, t in items])
    got = _summed(results, "ext", training, "grads")
    halo = 2  # the first layer's K = 5; the rows it reaches through both layers
    _close_dx(_cat(results, "ext", training, "dx"), want_x, 2 * halo, "dx vs JAX sharded")
    _close_dx(_cat(results, "ext", training, "dx"), port[0].numpy(), 2 * halo,
              "dx vs port unsharded")
    want_flat = _flat(want_p)
    for (k, _), pg in zip(items, port[1:]):
        if training and k.endswith("['conv']['bias']"):
            for what, g in (("port sharded", got[k]), ("JAX sharded", want_flat[k]),
                            ("port unsharded", pg.numpy())):
                assert np.abs(g).max() <= BN_FED_NOISE, f"{k} ({what}): {np.abs(g).max():.3e}"
            continue
        _close_grad(got[k], want_flat[k], f"{k} vs JAX sharded")
        _close_grad(got[k], pg.numpy(), f"{k} vs port unsharded")
