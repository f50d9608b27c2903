"""`.ts` (UCR/UEA sktime format) parser: native fast path, Python reader.

The reference loads datasets with `sktime.datasets.load_from_tsfile`
(reference `DataSource.py:3,12-14`) returning a numpy3d ``[N, C, T]``
float array plus string labels.  This is a dependency-free replacement that
parses the standard `.ts` layout:

* ``#`` comment lines;
* ``@problemName/@univariate/@dimensions/@seriesLength/...`` header tags;
* ``@classLabel true <labels...>`` (labels may be double-quoted);
* ``@data`` followed by one case per line, dimensions separated by ``:``,
  values comma-separated, the final field being the class label;
* ``@timestamps true`` data lines, where each value is a ``(timestamp,value)``
  tuple — timestamps may be ints or date/times containing ``:`` and spaces;
  only the values are kept (the archive's classifiers never use timestamps);
* ``?`` marks a missing value (mapped to NaN).

Consistency checks (sktime parity): a declared ``@classLabel`` set rejects
undeclared labels; ``@equalLength true`` (or ``@seriesLength``) rejects
series of any other length.  Unequal-length datasets (``@equalLength
false``) are right-padded with NaN to the maximum length (sktime's numpy3d
would refuse them; padding is the TPU-friendly choice — static shapes — and
the z-normalized UCR archive is equal-length anyway).

As in the JAX package, ``load_from_tsfile`` hands plain files to the C++
parser of ``data/native.py`` and checks its result against the header.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_TUPLE_RE = re.compile(r"\(([^)]*)\)")

#: Files parsed by each parser, counted by ``load_from_tsfile``.
PARSES = {"native": 0, "python": 0}


def reset_parse_counts() -> None:
    for name in PARSES:
        PARSES[name] = 0


def _read_header(path: str) -> Dict[str, str]:
    """Cheap pre-scan of the @tags (lowercased tag -> rest-of-line)."""
    tags: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("@"):
                tag, _, rest = line.partition(" ")
                tag = tag[1:].lower()
                tags[tag] = rest.strip()
                if tag == "data":
                    break
            else:  # malformed: data before @data — let the parser complain
                break
    return tags


def _is_true(tags: Dict[str, str], key: str) -> bool:
    return tags.get(key, "").split()[:1] == ["true"]


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    return s


def _declared_labels(tags: Dict[str, str]) -> Optional[List[str]]:
    for key in ("classlabel", "targetlabel"):
        if key in tags:
            parts = tags[key].split()
            if not parts or parts[0].lower() != "true":
                return None
            rest = tags[key][len(parts[0]):].strip()
            # labels may be quoted (and then contain spaces)
            if '"' in rest or "'" in rest:
                return [
                    _unquote(m.group(0))
                    for m in re.finditer(r'"[^"]*"|\'[^\']*\'|\S+', rest)
                ]
            return parts[1:]
    return None


def _split_top_level(line: str) -> List[str]:
    """Split on ':' outside parentheses (timestamps contain ':' in times)."""
    fields, depth, start = [], 0, 0
    for i, ch in enumerate(line):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        elif ch == ":" and depth == 0:
            fields.append(line[start:i])
            start = i + 1
    fields.append(line[start:])
    return fields


def _parse_value(v: str) -> float:
    v = v.strip()
    return np.nan if v in ("?", "") else float(v)


def _parse_dim(dim: str, timestamps: bool) -> np.ndarray:
    dim = dim.strip()
    if not dim:
        return np.asarray([], np.float32)
    if timestamps or dim.startswith("("):
        # (timestamp,value) tuples; the value is the LAST comma field inside
        # each tuple (timestamps — ints or datetimes — contain no commas)
        vals = [
            _parse_value(m.group(1).rpartition(",")[2])
            for m in _TUPLE_RE.finditer(dim)
        ]
    else:
        vals = [_parse_value(v) for v in dim.split(",")]
    return np.asarray(vals, np.float32)


def load_from_tsfile(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a .ts file -> (X[N, C, T] float32, y[N] of strings).

    Uses the native C++ parser (``data/native.py``) for the common clean
    layout; files using @timestamps or quoted labels take the pure-python
    path (the native parser handles only the fast plain format), as does
    every file where the native library cannot be built.  ``PARSES``
    counts which parser served each file.
    """
    from .native import load_from_tsfile_native, native_available

    if not os.path.exists(path):
        raise FileNotFoundError(f"no such .ts file: {path}")
    tags = _read_header(path)
    declared = _declared_labels(tags)
    needs_py = _is_true(tags, "timestamps") or any(
        q in tags.get("classlabel", tags.get("targetlabel", "")) for q in ("\"", "'")
    )
    if native_available() and not needs_py:
        x, y = load_from_tsfile_native(path)
        _check_consistency(path, tags, declared, x=x, y=y)
        PARSES["native"] += 1
        return x, y
    x, y = _load_from_tsfile_py(path)
    PARSES["python"] += 1
    return x, y


def _check_consistency(path, tags, declared, *, x=None, y=None, lengths=None):
    """sktime-parity validation of declared-header vs observed data."""
    if declared is not None and y is not None:
        seen = set(str(v) for v in y) - set(declared)
        if seen:
            raise ValueError(
                f"{path}: data labels {sorted(seen)} not in the declared "
                f"@classLabel set {declared}"
            )
    want = None
    if "serieslength" in tags:
        want = int(tags["serieslength"].split()[0])
    if _is_true(tags, "equallength") or want is not None:
        if lengths is None and x is not None:
            # native path: padded [N,C,T]. NaN can mean either a '?' missing
            # value or pad from a length mismatch — disambiguate by checking
            # whether the file contains any '?' marker at all.
            if np.isnan(x).any():
                with open(path, "r", encoding="utf-8") as f:
                    has_missing_marker = "?" in f.read()
                if not has_missing_marker:
                    raise ValueError(
                        f"{path}: @equalLength/@seriesLength declared but "
                        "series lengths differ (NaN padding without any '?' "
                        "missing-value markers)"
                    )
            if want is not None and x.shape[2] != want:
                raise ValueError(
                    f"{path}: @seriesLength {want} but longest series has "
                    f"{x.shape[2]} values"
                )
            return
        if lengths:
            want = want if want is not None else lengths[0][1]
            for idx, ln in lengths:
                if ln != want:
                    raise ValueError(
                        f"{path}: @equalLength/@seriesLength declares length "
                        f"{want} but case {idx} has a dimension of length {ln}"
                    )


def _load_from_tsfile_py(path: str) -> Tuple[np.ndarray, np.ndarray]:
    tags = _read_header(path)
    declared = _declared_labels(tags)
    timestamps = _is_true(tags, "timestamps")

    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()

    data_started = False
    has_class_labels = False
    cases: List[List[np.ndarray]] = []
    labels: List[str] = []
    lengths: List[Tuple[int, int]] = []  # (case index, dim length)

    for raw in lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if not data_started:
            low = line.lower()
            if low.startswith("@classlabel") or low.startswith("@targetlabel"):
                parts = line.split()
                has_class_labels = len(parts) > 1 and parts[1].lower() == "true"
            elif low.startswith("@data"):
                data_started = True
            continue

        # data line
        fields = _split_top_level(line)
        if has_class_labels:
            if len(fields) < 2:
                raise ValueError(
                    f"{path}: case {len(cases)} has no ':<label>' field"
                )
            label = _unquote(fields[-1])
            labels.append(label)
            fields = fields[:-1]
        case = [_parse_dim(dim, timestamps) for dim in fields]
        for d in case:
            lengths.append((len(cases), len(d)))
        cases.append(case)

    if not cases:
        raise ValueError(f"no data lines found in {path}")
    _check_consistency(
        path, tags, declared,
        y=np.asarray(labels) if has_class_labels else None, lengths=lengths,
    )

    n = len(cases)
    c = max(len(case) for case in cases)
    t = max(len(d) for case in cases for d in case)
    x = np.full((n, c, t), np.nan, np.float32)
    for i, case in enumerate(cases):
        for j, dim in enumerate(case):
            x[i, j, : len(dim)] = dim
    y = np.asarray(labels if has_class_labels else [""] * n)
    return x, y


def load_dataset_split(root: str, relpath: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load ``os.path.join(root, relpath)`` like the reference's
    ``TrainData(file_path_begin, file_path_end)`` (DataSource.py:12-14)."""
    return load_from_tsfile(os.path.join(root, relpath))
