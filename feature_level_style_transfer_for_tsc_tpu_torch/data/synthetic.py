"""Synthetic time-series classification datasets for tests and benchmarks.

The UCR/UEA archives are not shipped with the repo, so tests and the
benchmark generate class-separable synthetic series (distinct frequencies /
phases per class + noise, z-normalized per channel like the archive data).
A `.ts` writer round-trips through the parser so the full data path
is exercised end-to-end.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .dataset import TsClassificationData


def make_arrays(
    n: int,
    channels: int,
    length: int,
    num_class: int,
    seed: int = 0,
    noise: float = 0.3,
) -> tuple:
    """(X[N, C, T] float32, y[N] str) with per-class frequency signatures."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_class, size=n)
    t = np.arange(length, dtype=np.float32)[None, None, :]  # (1,1,T)
    freqs = 1.0 + np.arange(num_class, dtype=np.float32) * 0.7
    phase = rng.uniform(0, 2 * np.pi, size=(n, channels, 1)).astype(np.float32)
    chan_scale = 1.0 + 0.3 * np.arange(channels, dtype=np.float32)[None, :, None]
    f = freqs[y][:, None, None]
    x = np.sin(2 * np.pi * f * t / length * 4 + phase) * chan_scale
    x += noise * rng.standard_normal((n, channels, length)).astype(np.float32)
    # per-series per-channel z-normalization, like the UCR archive
    x = (x - x.mean(axis=-1, keepdims=True)) / (x.std(axis=-1, keepdims=True) + 1e-8)
    labels = np.asarray([f"cls_{int(v)}" for v in y])
    return x.astype(np.float32), labels


def make_dataset(
    n: int,
    channels: int,
    length: int,
    num_class: int,
    seed: int = 0,
    label_dict: Optional[dict] = None,
    is_train: bool = True,
) -> TsClassificationData:
    arrays = make_arrays(n, channels, length, num_class, seed)
    if label_dict is None:
        label_dict = {}
    return TsClassificationData(label_dict=label_dict, is_train=is_train, arrays=arrays)


def _shared_template_bank(num_class: int, n_harmonics: int, latent_dim: int, seed: int):
    """Per-class latent templates over a SHARED harmonic set.

    Every class uses the same frequencies with same-scale amplitude draws, so
    the class signature lives in the template *shape* (relative amplitudes +
    phases across harmonics), not the spectrum envelope — pooled
    spectral-energy features can't separate the classes, motif detectors can.
    """
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(np.arange(1, n_harmonics + 1, dtype=np.float32))
    amp = rng.normal(0.0, 1.0, (num_class, latent_dim, n_harmonics)).astype(np.float32)
    amp *= scale[None, None, :]
    phase = rng.uniform(0, 2 * np.pi, (num_class, latent_dim, n_harmonics)).astype(np.float32)
    return amp, phase


def _render_domain(bank, y, length, mixing, noise, rng):
    """Evaluate the shared latent templates on this domain's sampling grid,
    mix latents into the domain's channels, add domain noise, z-norm."""
    amp, phase = bank
    n_harmonics = amp.shape[-1]
    u = np.arange(length, dtype=np.float32) / length  # domain sampling grid
    freqs = np.arange(1, n_harmonics + 1, dtype=np.float32)
    tau = rng.uniform(0.0, 1.0, (len(y), 1, 1, 1)).astype(np.float32)  # circular shift
    arg = (
        2 * np.pi * freqs[None, None, :, None] * (u[None, None, None, :] + tau)
        + phase[y][:, :, :, None]
    )
    latent = (amp[y][:, :, :, None] * np.sin(arg)).sum(axis=2)  # (N, L, T)
    gain = (1.0 + 0.1 * rng.standard_normal((len(y), 1, 1))).astype(np.float32)
    x = np.einsum("cl,nlt->nct", mixing, latent) * gain
    x = x + noise * rng.standard_normal(x.shape).astype(np.float32)
    x = (x - x.mean(axis=-1, keepdims=True)) / (x.std(axis=-1, keepdims=True) + 1e-8)
    return x.astype(np.float32)


def _balanced_labels(n, num_class, rng):
    y = np.tile(np.arange(num_class), (n + num_class - 1) // num_class)[:n]
    rng.shuffle(y)
    return y.astype(np.int64)


def make_shared_domain_pair(
    n_target: int,
    n_source: int,
    n_test: int,
    num_class: int = 4,
    t_target: int = 144,
    c_target: int = 2,
    t_source: int = 96,
    c_source: int = 1,
    noise_target: float = 1.8,
    noise_source: float = 0.4,
    n_harmonics: int = 8,
    latent_dim: int = 2,
    seed: int = 0,
    template_seed: int = 0,
) -> dict:
    """Two domains with genuinely SHARED generative class structure.

    The positive-control pair for the style-transfer efficacy question
    (reference purpose: train_and_test.py:552-561): class templates are
    identical latent processes in both domains; the domains differ only in
    channel mixing, sampling rate (series length), and noise level.  The
    target is label-scarce and noisy, the source label-rich and clean — so
    the source carries class-shape information the target's own labels
    cannot supply, which is exactly what feature-level style transfer is
    supposed to move across.

    Returns {t_train, t_test, s_train, s_test}: (x[N, C, T] float32, y[N] int64).
    Labels are class-balanced (scarce targets must still see every class).
    """
    bank = _shared_template_bank(num_class, n_harmonics, latent_dim, template_seed)
    mix_rng = np.random.default_rng(template_seed + 1)
    mix_t = mix_rng.normal(0.0, 1.0, (c_target, latent_dim)).astype(np.float32)
    mix_s = mix_rng.normal(0.0, 1.0, (c_source, latent_dim)).astype(np.float32)
    out = {}
    for name, (n, length, mixing, noise, s_off) in {
        "t_train": (n_target, t_target, mix_t, noise_target, 10),
        "t_test": (n_test, t_target, mix_t, noise_target, 20),
        "s_train": (n_source, t_source, mix_s, noise_source, 30),
        "s_test": (n_test, t_source, mix_s, noise_source, 40),
    }.items():
        rng = np.random.default_rng(seed + s_off)
        y = _balanced_labels(n, num_class, rng)
        x = _render_domain(bank, y, length, mixing, noise, rng)
        out[name] = (x, y)
    return out


def write_ts_file(path: str, x: np.ndarray, y: np.ndarray, problem: str = "Synthetic"):
    """Write (X[N,C,T], y[N]) in sktime .ts format."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n, c, t = x.shape
    classes = sorted(set(y.tolist()))
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"@problemName {problem}\n")
        f.write("@timeStamps false\n")
        f.write(f"@univariate {'true' if c == 1 else 'false'}\n")
        if c > 1:
            f.write(f"@dimensions {c}\n")
        f.write("@equalLength true\n")
        f.write(f"@seriesLength {t}\n")
        f.write(f"@classLabel true {' '.join(classes)}\n")
        f.write("@data\n")
        for i in range(n):
            dims = [",".join(f"{v:.6f}" for v in x[i, j]) for j in range(c)]
            f.write(":".join(dims) + ":" + str(y[i]) + "\n")
