"""optax's ``chain(clip_by_global_norm(max_norm), adam(lr))``, as two plain
functions over a list of parameters.

The state is optax's ``ScaleByAdamState(count, mu, nu)``: an int32 step
count and one first and one second moment per parameter, in the order of
the parameter list (``interop.adam_state_to_numpy`` gives the brax layout).
The arithmetic follows optax term for term:
- the clip is optax's select, ``g if |g| < max else g / |g| * max``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and would give
  another update);
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction by the incremented count, ``eps`` outside the sqrt, then
  ``p + (-lr) * update``.
No step reads a value back to the host.

The state's tensors are persistent buffers: ``adam`` updates the count and
the moments in place, as it does the params, so that a captured CUDA graph
of the SGD step (``ppo.SGDStepProgram``) reads and writes the same
addresses at every replay. Each moment is still the functional update term
for term, every product and sum rounded on its own (a fused
``m.mul_(b1).add_(g, alpha=1-b1)`` or ``lerp`` could round as one FMA), so
the result is the functional one bit for bit. A restore copies into the
buffers (``copy_state_``); it does not rebind them.

The trainer's step is `clip_and_adam`, chosen by the tensors' device: on
the CPU the two plain functions, on CUDA the norm and the bias corrections
as torch ops and then one launch of the hand-written kernel
(``ops/csrc/adam.cu``) that does the clip's select, both moments and the
update for every tensor, rounded as the plain functions round: the same
result bit for bit. The tracer counts the steps of each kind:
``optim.plain_steps`` (``PLAIN``) and ``optim.fused_steps``, the kernel's
launches (``cuda_step.ADAM``, to which a CUDA graph's replay adds the
launches its capture recorded: utils.graphs.GraphedBody).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from open_duck_playground_tpu_torch.ops import cuda_step
from open_duck_playground_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class AdamState:
    count: torch.Tensor  # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    dev = params[0].device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


@torch.no_grad()
def adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamState,
         learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> AdamState:
    """One Adam step: updates `params` and `state` in place, returns `state`."""
    for g, m, v in zip(grads, state.mu, state.nu):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * (g * g))
    bc1, bc2 = _count_step(state, b1, b2)
    for p, m, v in zip(params, state.mu, state.nu):
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.copy_(p + (-learning_rate) * update)
    return state


def _count_step(state: AdamState, b1: float, b2: float):
    """Increment the count; the bias corrections by it, as device scalars."""
    state.count.add_(1)
    return (1 - b1 ** state.count.to(torch.float32), 1 - b2 ** state.count.to(torch.float32))


class PlainSteps:
    """Steps of a trainer function on its plain functions (the CPU's path):
    `clip_and_adam`'s here, ppo.gae's and networks.swish's there."""

    def __init__(self):
        self.steps = 0


PLAIN = PlainSteps()
profiling.watch(PLAIN, "steps", "optim.plain_steps")
# a fused step is one launch of the optimizer's kernel, counted where it launches
profiling.watch(cuda_step.ADAM, "launches", "optim.fused_steps")


@torch.no_grad()
def clip_and_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  state: AdamState, learning_rate: float, max_grad_norm: Optional[float],
                  b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> AdamState:
    """optax's ``chain(clip_by_global_norm(max_grad_norm), adam(lr))``, one
    step (no clip when `max_grad_norm` is None): updates `params` and
    `state` in place, returns `state`. CPU tensors run `clip_by_global_norm`
    and `adam`; CUDA tensors the norm (`global_norm`) and the bias
    corrections as those do, then the optimizer's kernel
    (`cuda_step.adam_step`) for the rest, with the same result bit for bit."""
    if params[0].device.type != "cuda":
        if max_grad_norm is not None:
            grads = clip_by_global_norm(grads, max_grad_norm)
        PLAIN.steps += 1
        return adam(params, grads, state, learning_rate, b1, b2, eps)
    norm = None if max_grad_norm is None else global_norm(grads)
    bc1, bc2 = _count_step(state, b1, b2)
    cuda_step.adam_step(params, grads, state.mu, state.nu, norm, bc1, bc2, max_grad_norm, b1,
                        b2, eps, learning_rate)
    return state


def clone_state(state: AdamState) -> AdamState:
    return AdamState(count=state.count.clone(), mu=[m.clone() for m in state.mu],
                     nu=[v.clone() for v in state.nu])


@torch.no_grad()
def copy_state_(dst: AdamState, src: AdamState) -> AdamState:
    """`src`'s values copied into `dst`'s buffers; returns `dst`."""
    if len(dst.mu) != len(src.mu):
        raise ValueError(f"{len(src.mu)} moments into a state of {len(dst.mu)}")
    for a, b in zip([dst.count, *dst.mu, *dst.nu], [src.count, *src.mu, *src.nu]):
        a.copy_(b)
    return dst
