"""Configuration with the reference's hard-coded values as defaults.

The port's copy of the JAX package's ``config.py``: the phase lengths,
learning rates, schedules, GradNorm and flow settings of the five-phase
curriculum, and the voting constants, with the JAX package's execution
switches: ``compute_dtype``, ``fused_optimizers``, ``merged_pullbacks`` and
``stacked_pullbacks`` (JAX ``config.py:92-125``), which no CLI sets, as in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class FlowConfig:
    """Simplified WaveGlow (reference Simplified_NF_WaveGlow.py:125-146,
    instantiated train_and_test.py:71)."""

    n_flows: int = 3
    wn_channels: int = 120
    wn_layers: int = 8  # kernel 3, dilation 2**i (the only geometry ported)


@dataclass(frozen=True)
class OptimConfig:
    """LRs and schedules (reference train_and_test.py:97-134)."""

    lr_target_ext: float = 1e-3
    lr_target_cls: float = 3e-3
    lr_source_ext: float = 1e-3
    lr_dim_uni: float = 1e-3
    lr_source_cls: float = 3e-3
    lr_prob_trans: float = 1e-3
    lr_nf: float = 1e-3
    lr_noise_trans: float = 5e-3
    lr_ad_net: float = 1e-3
    lr_feat_disc: float = 1e-3
    lr_cpc: float = 2e-3

    steplr_step: int = 25
    steplr_gamma: float = 0.8
    cpc_steplr_gamma: float = 0.7
    noise_steplr_step: int = 55
    noise_steplr_gamma: float = 0.6
    plateau_factor: float = 0.7
    plateau_min_lr: float = 1e-4

    ad_net_clip: float = 5e-4
    feat_disc_clip: float = 1e-2


@dataclass(frozen=True)
class GradNormConfig:
    """GradNorm weights (reference train_and_test.py:500-511,753-761)."""

    alpha: float = 3.0
    weights_t_init: Tuple[float, ...] = (2.0, 5.0)
    weights_s_init: Tuple[float, ...] = (2.0, 2.0, 4.0)
    weights_t_sum: float = 7.0
    weights_s_sum: float = 8.0
    lr_weights_t: float = 2e-4
    lr_weights_s: float = 1e-3


@dataclass(frozen=True)
class PipelineConfig:
    """The five-phase curriculum (reference train_and_test.py:22-798)."""

    batch_size: int = 20  # reference train_and_test.py
    max_kernel_size: int = 89  # reference train_and_test.py:40
    cdan_dim: int = 1024  # reference :76
    cpc_hidden: int = 64  # reference :131
    #: scales the OS-CNN parameter budgets (1.0 = reference budgets
    #: train_and_test.py:38-39); tests shrink it to keep models tiny.
    budget_multiplier: float = 1.0
    #: "bfloat16" runs the OS-CNN convs in bf16 (the weights and BatchNorm
    #: statistics stay f32); any other value keeps them f32, as in the JAX package
    compute_dtype: str = "float32"
    #: >0 soft-clamps the coupling's log-scale to ``c*tanh(log_s/c)``;
    #: 0.0 = exact reference semantics
    log_s_clamp: float = 0.0
    #: step the 10 RMSprop modules as ONE flat update with a learning rate
    #: per element (``train/optim.py`` ``FusedRMSprop``; the same element math)
    fused_optimizers: bool = False
    #: merge the GradNorm trunk pulls whose cross-trunk gradients are
    #: structurally zero (t_nf + s_nf, t_c + s_c): 4 pulls a step instead of 6
    #: (JAX ``train/pipeline.py:700-752``)
    merged_pullbacks: bool = True
    #: under merged pulls, the total, t_nf + s_nf and s2t2s_c as ONE backward
    #: under a batch of three cotangents (the classifier pull stays alone);
    #: no effect when ``merged_pullbacks`` is False, as in the JAX package
    stacked_pullbacks: bool = False

    target_pretrain_epochs: int = 3  # reference :143
    source_pretrain_epochs: int = 70  # reference :182
    selfsup_epochs: int = 325  # 65*5, reference :222
    selfsup_supervised_every: int = 50  # reference :231
    nf_pretrain_epochs: int = 600  # reference :375
    nf_supervised_every: int = 75  # reference :388
    joint_epochs: int = 720  # reference :23

    eval_every: int = 2  # reference :778
    seed: int = 0

    flow: FlowConfig = field(default_factory=FlowConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    gradnorm: GradNormConfig = field(default_factory=GradNormConfig)


@dataclass(frozen=True)
class VotingConfig:
    """Ensemble voting constants (reference multi_source_voting.py:405-420)."""

    entropy_scale: float = 120.0
    weight_base: float = 9.0
