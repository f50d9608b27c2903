"""The port's native ``.ts`` parser, ``data/preprocess.py`` and
``utils/profiling.py`` against the JAX package's, on the CPU.

The native parser is the root ``native/ts_parser.cpp``, built by each
package's own binding (the port's into ``build/native/``).  Both bindings
and the Python reader must give the same arrays, NaN where a value is
missing or past the end of a shorter series, and the same labels; the
port's ``load_from_tsfile`` must dispatch as the JAX package's does and
count which parser served.  The preprocessing functions run on
numpy-seeded inputs through both packages (float32 both sides, rel 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_level_style_transfer_for_tsc_tpu.data import native as jax_native
from feature_level_style_transfer_for_tsc_tpu.data import preprocess as jax_pre
from feature_level_style_transfer_for_tsc_tpu.data import ts_parser as jax_parser
from feature_level_style_transfer_for_tsc_tpu_torch.data import native, preprocess, ts_parser
from feature_level_style_transfer_for_tsc_tpu_torch.data.synthetic import make_arrays, write_ts_file
from feature_level_style_transfer_for_tsc_tpu_torch.utils.profiling import phase_scope, profile_trace

OUT_TOL = {"rtol": 1e-5, "atol": 1e-6}
CASES = {
    "missing": "@problemName q\n@classLabel true a b\n@data\n1.0,?,3.0:a\n?,2.0,4.0:b\n",
    "unequal": ("@problemName u\n@dimensions 2\n@classLabel true x y\n@data\n"
                "1,2,3:4,5:x\n6,7:8,9,10:y\n"),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def built():
    assert native.native_available(), "g++ could not build native/ts_parser.cpp"
    assert jax_native.native_available()


def _same(a, b):
    xa, ya = a
    xb, yb = b
    assert xa.dtype == xb.dtype == np.float32 and xa.shape == xb.shape
    np.testing.assert_array_equal(np.isnan(xa), np.isnan(xb))
    np.testing.assert_array_equal(np.nan_to_num(xa), np.nan_to_num(xb))
    assert list(ya) == list(yb)


def test_the_library_is_built_under_build_native(built):
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.REPO / "build" / "native"
    assert native.CXX_FLAGS[1] == "-march=native"  # in the hash: one machine's build
    assert lib.name.startswith("libtsparse_") and lib.suffix == ".so"


@pytest.mark.parametrize("shape", [(20, 3, 40, 4), (9, 1, 150, 2)])
def test_native_matches_jax_native_and_both_python_readers(built, tmp_path, shape):
    x, y = make_arrays(*shape, seed=shape[0])
    path = str(tmp_path / "P" / "P_TRAIN.ts")
    write_ts_file(path, x, y)
    got = native.load_from_tsfile_native(path)
    _same(got, jax_native.load_from_tsfile_native(path))
    _same(got, jax_parser._load_from_tsfile_py(path))
    _same(got, ts_parser._load_from_tsfile_py(path))
    np.testing.assert_allclose(got[0], x, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_missing_values_and_unequal_lengths_as_jax(built, tmp_path, case):
    p = tmp_path / f"{case}_TRAIN.ts"
    p.write_text(CASES[case])
    ts_parser.reset_parse_counts()
    got = ts_parser.load_from_tsfile(str(p))
    assert ts_parser.PARSES == {"native": 1, "python": 0}
    _same(got, jax_parser.load_from_tsfile(str(p)))
    _same(got, native.load_from_tsfile_native(str(p)))
    _same(got, ts_parser._load_from_tsfile_py(str(p)))
    x = got[0]
    if case == "missing":
        assert x.shape == (2, 1, 3) and np.isnan(x[0, 0, 1]) and np.isnan(x[1, 0, 0])
    else:
        assert x.shape == (2, 2, 3) and np.isnan(x[0, 1, 2]) and x[1, 1, 2] == 10


@pytest.mark.parametrize("header,line", [
    ("@timestamps true\n@classLabel true a b", "(0,1.0),(1,2.0):a"),
    ('@classLabel true "a x" b', '1.0,2.0:"a x"'),
])
def test_timestamps_and_quoted_labels_take_the_python_reader(built, tmp_path, header, line):
    p = tmp_path / "S_TRAIN.ts"
    p.write_text(f"@problemName s\n{header}\n@data\n{line}\n")
    ts_parser.reset_parse_counts()
    got = ts_parser.load_from_tsfile(str(p))
    assert ts_parser.PARSES == {"native": 0, "python": 1}
    _same(got, jax_parser.load_from_tsfile(str(p)))


def test_native_path_checks_the_header_as_jax(built, tmp_path):
    """@equalLength with series of two lengths and no '?': the native path's
    NaN padding is refused, as in the JAX package; with a '?' it passes."""
    p = tmp_path / "E_TRAIN.ts"
    p.write_text("@problemName e\n@equalLength true\n@classLabel true a\n@data\n1,2,3:a\n4,5:a\n")
    for load in (ts_parser.load_from_tsfile, jax_parser.load_from_tsfile):
        with pytest.raises(ValueError, match="lengths differ"):
            load(str(p))
    p.write_text("@problemName e\n@equalLength true\n@classLabel true a\n@data\n1,?,3:a\n4,5,6:a\n")
    _same(ts_parser.load_from_tsfile(str(p)), jax_parser.load_from_tsfile(str(p)))
    p.write_text("@problemName e\n@classLabel true a\n@data\n1,2:b\n")
    for load in (ts_parser.load_from_tsfile, jax_parser.load_from_tsfile):
        with pytest.raises(ValueError, match="not in the declared"):
            load(str(p))


def test_the_python_reader_serves_without_the_toolchain(tmp_path, monkeypatch):
    x, y = make_arrays(5, 2, 16, 2, seed=3)
    path = str(tmp_path / "N" / "N_TRAIN.ts")
    write_ts_file(path, x, y)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    ts_parser.reset_parse_counts()
    got = ts_parser.load_from_tsfile(path)
    assert ts_parser.PARSES == {"native": 0, "python": 1}
    _same(got, jax_parser._load_from_tsfile_py(path))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.load_from_tsfile_native(path)


# ------------------------------------------------------------- preprocess --

def _inputs(seed=0, n=4, t=37, c=3):
    rng = np.random.default_rng(seed)
    x = (3.0 + 2.0 * rng.standard_normal((n, t, c))).astype(np.float32)
    x[0, 30:, 1] = np.nan  # a shorter series' padding
    x[2, 5, 0] = np.nan  # a missing value
    return x


def test_znormalize_and_nan_to_zero_match_jax():
    x = _inputs()
    got = preprocess.znormalize(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pre.znormalize(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **OUT_TOL)
    np.testing.assert_array_equal(preprocess.nan_to_zero(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_pre.nan_to_zero(jnp.asarray(x))))


@pytest.mark.parametrize("t,window,stride", [(37, 8, 3), (200, 10, 2), (16, 16, 1)])
def test_sliding_windows_and_windows_as_batch_match_jax(t, window, stride):
    """(200, 10, 2) gives 96 windows: the JAX function's vmap branch."""
    x = np.nan_to_num(_inputs(1, t=t))
    y = np.arange(x.shape[0], dtype=np.int32)
    got = preprocess.sliding_windows(torch.from_numpy(x), window, stride)
    want = np.asarray(jax_pre.sliding_windows(jnp.asarray(x), window, stride))
    np.testing.assert_array_equal(got.numpy(), want)
    xb, yb = preprocess.windows_as_batch(torch.from_numpy(x), torch.from_numpy(y), window, stride)
    jxb, jyb = jax_pre.windows_as_batch(jnp.asarray(x), jnp.asarray(y), window, stride)
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jxb))
    np.testing.assert_array_equal(yb.numpy(), np.asarray(jyb))


def test_sliding_windows_refuses_a_window_past_the_series():
    x = torch.zeros(2, 5, 1)
    with pytest.raises(ValueError, match="longer than series"):
        preprocess.sliding_windows(x, 6, 1)


# -------------------------------------------------------------- profiling --

def test_profile_trace_writes_a_trace_with_the_phase(tmp_path):
    with profile_trace(str(tmp_path)):
        with phase_scope("p1_target_pretrain"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "p1_target_pretrain" in traces[0].read_text()
