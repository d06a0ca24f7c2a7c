"""The control: the reference put in the program's place one precision
below what the configuration states.  A bfloat16 stage becomes
float8 (e4m3): every conv and linear takes its weight and its input
rounded to float8 with a per-tensor scale, the rest runs in bfloat16.
A float32 stage becomes TF32 (``tf32``): the backends' TF32 switches on,
and every conv, linear and matmul takes its float32 operands rounded to
TF32 (10 mantissa bits, to nearest even) on any device, so the CPU shows
what the card's TF32 does.  A float32 elementwise stage (the rotation
metric) takes bfloat16-rounded inputs (``bf16_round``).
"""

from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest even;
    gradients pass straight through."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0xFFF + ((bits >> 13) & 1)) & -8192).view(torch.float32)
    return t + (rounded - t).detach()


class TF32Products(TorchFunctionMode):
    """Every conv, linear and matmul on TF32-rounded float32 operands."""

    PRODUCTS = {F.conv2d, F.linear, torch.matmul, torch.bmm, torch.baddbmm, torch.einsum, torch.Tensor.matmul}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(tf32_round(a) if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a
                         for a in args)
        return func(*args, **(kwargs or {}))


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _quantize_input(module, args):
    return (fp8_round(args[0]),) + tuple(args[1:])


def fp8_copy(module: nn.Module) -> nn.Module:
    """A bfloat16 copy of ``module`` whose convs and linears compute on
    float8-rounded weights and inputs."""
    low = copy.deepcopy(module).to(torch.bfloat16)
    for m in low.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                m.weight.copy_(fp8_round(m.weight))
            m.register_forward_pre_hook(_quantize_input)
    return low


@contextlib.contextmanager
def tf32():
    """float32 matmuls and convs on the TF32 tensor cores, their operands
    rounded to TF32 on any device."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with TF32Products():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
