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
that only reorders its arithmetic reads about as much. A run on many ranks
sums over envs in parts, one per rank, and adds the parts: its own rounding
reading is the reference with its sums over envs taken so
(``rank_partials``).
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


def _parts(x: torch.Tensor, dim: int, world: int) -> list:
    """`x` in `world` parts along `dim` (as many as it has rows, at most)."""
    return list(torch.tensor_split(x, min(world, max(x.shape[dim], 1)), dim=dim))


def _added(parts) -> torch.Tensor:
    """The parts' sum, the last part first."""
    out = parts[-1]
    for p in reversed(parts[:-1]):
        out = out + p
    return out


class _PartialLinear(torch.autograd.Function):
    """A Linear whose forward is the plain one and whose weight and bias
    gradients are sums over `world` parts of the env axis (the second to
    last of the input), added last part first."""

    @staticmethod
    def forward(ctx, x, weight, bias, world):
        ctx.save_for_backward(x, weight)
        ctx.world = world
        return torch.nn.functional.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        env = grad.dim() - 2 if grad.dim() >= 2 else 0
        gs, xs = _parts(grad, env, ctx.world), _parts(x, env, ctx.world)
        gw = _added([torch.matmul(g.reshape(-1, g.shape[-1]).T, xp.reshape(-1, xp.shape[-1]))
                     for g, xp in zip(gs, xs)])
        gb = _added([g.reshape(-1, g.shape[-1]).sum(0) for g in gs])
        return torch.matmul(grad, weight), gw, gb, None


class _PartialTorch:
    """The torch module with `sum` and `mean` over several axes (the
    normalizer's statistics), or over all of them (the loss's means), taken
    as `world` parts of the last axis reduced, added last part first."""

    def __init__(self, world: int):
        self.world = world

    def __getattr__(self, name):
        return getattr(torch, name)

    def sum(self, x, dim=None, **kw):
        if dim is None:
            return _added([p.sum() for p in _parts(x, x.dim() - 1, self.world)])
        if isinstance(dim, (tuple, list)) and len(dim) > 1:
            last = max(d % x.dim() for d in dim)
            return _added([torch.sum(p, dim=dim, **kw) for p in _parts(x, last, self.world)])
        return torch.sum(x, dim=dim, **kw)

    def mean(self, x, dim=None, **kw):
        if dim is None:
            return self.sum(x) / x.numel()
        return torch.mean(x, dim=dim, **kw)


@contextlib.contextmanager
def rank_partials(module: nn.Module, world: int):
    """Inside the block the reference sums over envs as `world` ranks do:
    each rank its own part, the parts then added (last first): every
    nn.Linear's weight and bias gradients under `module`, and the module
    level sums and means of the reference's PPO loss and observation
    normalizer over envs. The forward passes and each row's arithmetic are
    the plain ones."""
    from duckbench.ref.train import networks as ref_networks
    from duckbench.ref.train import ppo as ref_ppo

    layers = [m for m in module.modules() if isinstance(m, nn.Linear)]
    for m in layers:
        m.forward = (lambda layer: lambda x: _PartialLinear.apply(x, layer.weight, layer.bias,
                                                                  world))(m)
    proxy = _PartialTorch(world)
    mods = (ref_networks, ref_ppo)
    for mod in mods:
        mod.torch = proxy
    try:
        yield
    finally:
        for mod in mods:
            mod.torch = torch
        for m in layers:
            del m.forward
