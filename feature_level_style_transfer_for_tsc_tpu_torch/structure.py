"""Omni-Scale CNN architecture builder.

Pure-Python math that decides the per-layer (in_channels, out_channels,
kernel_size) tuples of every OS-CNN in the framework.  Behavioral parity with
the reference builder (reference `OS_CNN/OS_CNN_Structure_build.py:1-43`
and reference `OS_CNN/OS_CNN.py:9-12,142-152`), including its quirks:

* the naive primality test admits 1 (and 2), so with ``start=1`` the kernel
  set is ``[1, 2, 3, 5, 7, ...]`` — this *defines* the omni-scale kernel set
  and is replicated deliberately (reference OS_CNN_Structure_build.py:3-13);
* the final layer always holds two convs with kernel sizes ``start`` and
  ``start + 1`` (reference OS_CNN_Structure_build.py:36-41).

A copy of the JAX package's ``structure.py``: the port imports nothing of
that package.  Everything here runs on the host, never on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

# A "layer" is a list of parallel conv branches (in_ch, out_ch, kernel_size).
ConvSpec = Tuple[int, int, int]
LayerSpec = List[ConvSpec]

#: Maximum omni-scale kernel size, fixed by the OS-CNN authors
#: (reference train_and_test.py:40).
MAX_KERNEL_SIZE = 89

#: Default per-layer parameter budgets as a function of the raw input channel
#: count (reference train_and_test.py:38-39).
def default_parameter_budgets(in_channels: int) -> List[int]:
    return [8 * 128 * in_channels, 5 * 128 * 256 + 2 * 256 * 128]


def primes_in_range(start: int, end: int) -> List[int]:
    """All "primes" in [start, end] under the reference's naive test.

    The reference test (OS_CNN_Structure_build.py:3-13) checks divisibility
    by ``range(2, val)`` which is empty for val <= 2, so 1 and 2 are admitted.
    """
    out = []
    for val in range(start, end + 1):
        is_prime = True
        for n in range(2, val):
            if val % n == 0:
                is_prime = False
                break
        if is_prime:
            out.append(val)
    return out


def out_channels_for_budget(budget: int, in_channels: int, prime_list: Sequence[int]) -> int:
    """Per-branch output channels so that total params ≈ budget.

    Reference OS_CNN_Structure_build.py:16-18.
    """
    return int(budget / (in_channels * sum(prime_list)))


def generate_layer_parameter_list(
    start: int,
    end: int,
    parameter_budget_list: Sequence[int],
    in_channel: int = 1,
) -> List[LayerSpec]:
    """Build the nested layer-parameter list for an OS-CNN stack.

    Reference OS_CNN_Structure_build.py:20-43: one LayerSpec per budget, each
    holding one branch per prime kernel size, then a final layer of two
    branches with kernel sizes ``start`` and ``start + 1`` and the same width
    as layer 0's total output.
    """
    prime_list = primes_in_range(start, end)
    if not prime_list:
        raise ValueError(f"start={start} is larger than end={end}: empty kernel set")

    input_in_channel = in_channel
    layer_parameter_list: List[LayerSpec] = []
    for budget in parameter_budget_list:
        if in_channel == 0:
            # the previous layer's budget starved its width to 0 (possible
            # with a small budget_multiplier; the reference's fixed budgets
            # never hit this) — fail clearly instead of ZeroDivisionError
            raise ValueError(
                f"parameter budget too small for kernel set "
                f"{prime_list[0]}..{prime_list[-1]} (sum {sum(prime_list)}): "
                "a layer's out_channels collapsed to 0. Raise "
                "budget_multiplier or reduce the receptive field."
            )
        out_channel = out_channels_for_budget(budget, in_channel, prime_list)
        if out_channel == 0:
            # also catches the LAST layer collapsing (no subsequent consumer
            # would trip the in_channel==0 guard above)
            raise ValueError(
                f"parameter budget {budget} too small for kernel set "
                f"{prime_list[0]}..{prime_list[-1]} (sum {sum(prime_list)}): "
                "out_channels collapsed to 0. Raise budget_multiplier or "
                "reduce the receptive field."
            )
        layer = [(in_channel, out_channel, prime) for prime in prime_list]
        in_channel = len(prime_list) * out_channel
        layer_parameter_list.append(layer)

    first_out_channel = len(prime_list) * out_channels_for_budget(
        parameter_budget_list[0], input_in_channel, prime_list
    )
    layer_parameter_list.append(
        [(in_channel, first_out_channel, start), (in_channel, first_out_channel, start + 1)]
    )
    return layer_parameter_list


def layer_parameter_list_input_change(
    layer_parameter_list: List[LayerSpec], input_channel: int
) -> List[LayerSpec]:
    """Rewrite the first layer's in_channels (reference OS_CNN.py:142-152).

    Used to build a classifier that consumes extracted features instead of
    the raw signal.
    """
    new_list: List[LayerSpec] = []
    for i, layer in enumerate(layer_parameter_list):
        if i == 0:
            new_list.append([(input_channel, out, k) for (_, out, k) in layer])
        else:
            new_list.append(layer)
    return new_list


def receptive_field(time_length: int, max_kernel_size: int = MAX_KERNEL_SIZE) -> int:
    """Omni-scale receptive-field cap (reference train_and_test.py:42)."""
    return min(int(time_length / 4), max_kernel_size)


def total_out_channels(layer_spec: LayerSpec) -> int:
    """Sum of branch output channels of a layer (reference OS_CNN.py:96-98)."""
    return sum(out for (_, out, _) in layer_spec)


def mask_bounds(kernel_size: int, largest_kernel_size: int) -> Tuple[int, int]:
    """[left, right) bounds of the non-zero taps when a kernel of size
    ``kernel_size`` is centered inside a kernel of ``largest_kernel_size``.

    Reference OS_CNN.py:9-12 (`calculate_mask_index`).
    """
    right_zero = math.ceil((largest_kernel_size - 1) / 2) - math.ceil((kernel_size - 1) / 2)
    left_zero = largest_kernel_size - kernel_size - right_zero
    return left_zero, left_zero + kernel_size


@dataclass(frozen=True)
class OSLayerShapes:
    """Static shape summary for one fused omni-scale layer."""

    in_channels: int
    out_channels: int
    max_kernel_size: int
    pad_left: int
    pad_right: int


def layer_shapes(layer_spec: LayerSpec) -> OSLayerShapes:
    """Fused-conv shapes for a LayerSpec.

    All branches of a layer share in_channels; they are fused into ONE conv
    at the layer's largest kernel size whose weight is masked per-branch
    (reference OS_CNN.py:44-68).  "Same" padding is asymmetric:
    ``((K-1)//2, K//2)`` (reference OS_CNN.py:59).
    """
    max_k = layer_spec[-1][-1]
    in_ch = layer_spec[0][0]
    out_ch = total_out_channels(layer_spec)
    return OSLayerShapes(
        in_channels=in_ch,
        out_channels=out_ch,
        max_kernel_size=max_k,
        pad_left=(max_k - 1) // 2,
        pad_right=max_k // 2,
    )
