"""The control's precision: the step below float32 with TF32 off, which is TF32.

On a CUDA card the control turns PyTorch's TF32 switches on (matmuls and cuDNN convs then
round their operands to TF32).  A CPU has no TF32, so there every float32 operand of a
matmul, an einsum or a conv is rounded to TF32's 10-bit mantissa before the op, as the
tensor cores round it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_ROUNDED = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
            torch.einsum, torch.bmm, torch.mm, F.conv1d, F.linear}


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest value with a 10-bit mantissa; the gradient passes
    through unchanged."""
    with torch.no_grad():
        bits = t.detach().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(t.shape)
    return t + (rounded - t).detach() if t.requires_grad else rounded


class _TF32(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _ROUNDED:
            def r(a):
                return to_tf32(a) if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a
            args = tuple(r(a) if not isinstance(a, (list, tuple)) else type(a)(map(r, a))
                         for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32(device: torch.device):
    if device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    else:
        with _TF32():
            yield
