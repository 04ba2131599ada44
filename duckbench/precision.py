"""The control's precision, TF32 matrix products, and a run whose rounding
alone changes, on any device.

The configurations run in float32 with TF32 off. The correctness check's
control is the plain reference computed one precision below: every Linear
layer's product with its inputs rounded to TF32 (10 explicit mantissa bits,
round to nearest) in the forward pass and in both products of the backward
pass, accumulated in float32, as the card's TF32 tensor cores do. Emulated
by rounding, so that the control reads the same on the CPU, where the
control's test runs, as on the card.

A rounding reading sets the room between a sound run and a limit: the plain
reference in float32, TF32 off, with its sums in another order
(``reordered``), put in the program's place. A later change to the program
that only reorders its arithmetic reads about as much.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


class _Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        xr, wr = tf32(x), tf32(weight)
        ctx.save_for_backward(xr, wr)
        return torch.matmul(xr, wr.T) + bias

    @staticmethod
    def backward(ctx, grad):
        xr, wr = ctx.saved_tensors
        g = tf32(grad)
        gx = torch.matmul(g, wr)
        gw = torch.matmul(g.reshape(-1, g.shape[-1]).T, xr.reshape(-1, xr.shape[-1]))
        gb = grad.reshape(-1, grad.shape[-1]).sum(0)
        return gx, gw, gb


@contextlib.contextmanager
def tf32_linears(module: nn.Module):
    """Every nn.Linear under `module` computes its product in TF32 inside
    the block."""
    layers = [m for m in module.modules() if isinstance(m, nn.Linear)]
    for m in layers:
        m.forward = (lambda layer: lambda x: _Linear.apply(x, layer.weight, layer.bias))(m)
    try:
        yield
    finally:
        for m in layers:
            del m.forward


def _halves(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias with the input width summed as two halves, then added."""
    h = weight.shape[1] // 2
    return torch.matmul(x[..., :h], weight[:, :h].T) + torch.matmul(x[..., h:], weight[:, h:].T) \
        + bias


@contextlib.contextmanager
def reordered(module: nn.Module):
    """Inside the block every nn.Linear under `module` sums its product's
    terms in another order (two halves of the input width apart, then
    added; autograd's backward products follow), and the plain physics
    step's velocities come out one unit in the last place higher, as a
    kernel that sums in another order would round them."""
    from duckbench.ref.ops.twin import TwinPhysics

    layers = [m for m in module.modules() if isinstance(m, nn.Linear)]
    for m in layers:
        m.forward = (lambda layer: lambda x: _halves(x, layer.weight, layer.bias))(m)
    step = TwinPhysics.__call__

    def rounded(self, *a, **k):
        out = dict(step(self, *a, **k))
        out["qvel"] = torch.nextafter(out["qvel"], torch.full_like(out["qvel"], float("inf")))
        return out

    TwinPhysics.__call__ = rounded
    try:
        yield
    finally:
        TwinPhysics.__call__ = step
        for m in layers:
            del m.forward
