"""Carry-across from numpy: models and env states built elsewhere (the JAX
package's, converted to numpy arrays by the caller) into the port's types.

- ``model_from_numpy(fields)``: a ``Model`` from a dict of its fields, as
  numpy arrays and python numbers. ``names`` is ``{kind: {name: id}}``,
  ``keyframes`` ``{name: (qpos, ctrl)}``, ``opt`` a dict of ``Option``'s
  fields. The domain-randomized fields may carry a leading env dim.
  ``model_to_numpy`` is its inverse.
- ``data_from_numpy(tree)`` / ``state_from_numpy(tree)``: a batched ``Data``
  or ``TrainEnv`` state from a nested dict of numpy arrays (env dim first).
  Every field of the port's ``Data`` and ``Contact`` the tree holds is
  carried (the optional ones, which only the general pipeline fills, stay
  None where the tree lacks them); others are ignored, and so is the JAX
  state's ``info["rng"]`` (the port draws from ``torch.Generator``s).

- ``ppo_params_to_numpy(networks)`` / ``ppo_params_from_numpy(tree)``: a
  ``train.networks.PPONetworks`` as the brax parameter tree
  ``{"policy": {"params": {"hidden_0": {"kernel", "bias"}, ...}}, "value":
  ...}``, where a kernel ``(in, out)`` is ``Linear.weight.T``.
- ``normalizer_to_numpy`` / ``normalizer_from_numpy``: a
  ``RunningStatisticsState`` as ``{"count", "mean", "summed_variance",
  "std"}``, the last three keyed by obs key.
- ``adam_state_to_numpy`` / ``adam_state_from_numpy``: a
  ``train.optim.AdamState`` as the fields of optax's ``ScaleByAdamState``,
  ``{"count", "mu", "nu"}``, with ``mu`` and ``nu`` brax parameter trees.

Float arrays become float32 tensors; integer and bool arrays keep their
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from open_duck_playground_tpu_torch.envs.types import State
from open_duck_playground_tpu_torch.ops import types as T
from open_duck_playground_tpu_torch.train.networks import PPONetworks, RunningStatisticsState
from open_duck_playground_tpu_torch.train.optim import AdamState
from open_duck_playground_tpu_torch.utils.static import StaticArray

_STATIC = {f.name for f in dataclasses.fields(T.Model) if f.type == "StaticArray"}
_TENSOR = {f.name for f in dataclasses.fields(T.Model)
           if f.type in ("torch.Tensor", "Optional[torch.Tensor]")}


def _tensor(x, device="cpu") -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


def model_from_numpy(fields: Dict[str, Any], device="cpu") -> T.Model:
    kw = {}
    for f in dataclasses.fields(T.Model):
        v = fields[f.name]
        if f.name == "opt":
            v = T.Option(**{**v, "gravity": _tensor(v["gravity"], device)})
        elif f.name == "names":
            v = T.Names(**v)
        elif f.name == "keyframes":
            v = T.Keyframes(v)
        elif f.name in _STATIC:
            v = StaticArray(np.asarray(v))
        elif f.name in _TENSOR:
            v = None if v is None else _tensor(v, device)
        kw[f.name] = v
    return T.Model(**kw)


def model_to_numpy(m: T.Model) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(T.Model):
        v = getattr(m, f.name)
        if f.name == "opt":
            v = {g.name: getattr(v, g.name) for g in dataclasses.fields(T.Option)}
            v["gravity"] = v["gravity"].cpu().numpy()
        elif f.name == "names":
            v = {k: dict(d) for k, d in v._d.items()}
        elif f.name == "keyframes":
            v = {k: (np.asarray(q), np.asarray(c)) for k, (q, c) in v._frames.items()}
        elif isinstance(v, StaticArray):
            v = v.np
        elif isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        out[f.name] = v
    return out


def _fields_from_numpy(cls, tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The fields of dataclass `cls` that `tree` holds, as tensors (an
    optional field the tree lacks or holds as None stays None)."""
    return {f.name: _tensor(tree[f.name], device) for f in dataclasses.fields(cls)
            if f.name != "contact" and tree.get(f.name) is not None}


def data_from_numpy(tree: Dict[str, Any], device="cpu") -> T.Data:
    contact = T.Contact(**_fields_from_numpy(T.Contact, tree["contact"], device))
    return T.Data(contact=contact, **_fields_from_numpy(T.Data, tree, device))


def state_from_numpy(tree: Dict[str, Any], device="cpu") -> State:
    info = {}
    for k, v in tree["info"].items():
        if k == "rng":
            continue
        if k == "first_data":
            info[k] = data_from_numpy(v, device)
        elif isinstance(v, dict):
            info[k] = {kk: _tensor(vv, device) for kk, vv in v.items()}
        else:
            info[k] = _tensor(v, device)
    return State(
        data=data_from_numpy(tree["data"], device),
        obs={k: _tensor(v, device) for k, v in tree["obs"].items()},
        reward=_tensor(tree["reward"], device),
        done=_tensor(tree["done"], device),
        metrics={k: _tensor(v, device) for k, v in tree["metrics"].items()},
        info=info,
    )


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def brax_paths(networks: PPONetworks):
    """(brax path, parameter) of each parameter of `networks`, in the order
    of ``networks.parameters()``; a path ends in "kernel" (the transposed
    weight) or "bias"."""
    out = []
    for name, p in networks.named_parameters():
        net, layer, kind = name.split(".")  # e.g. policy.hidden_0.weight
        out.append(((net, "params", layer, "kernel" if kind == "weight" else "bias"), p))
    return out


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _brax_tree(networks: PPONetworks, tensors) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for (path, _), t in zip(brax_paths(networks), tensors):
        a = _numpy(t)
        _tree_set(tree, path, np.ascontiguousarray(a.T) if path[-1] == "kernel" else a)
    return tree


def _from_brax_tree(networks: PPONetworks, tree, device) -> list:
    out = []
    for path, _ in brax_paths(networks):
        a = np.asarray(_tree_get(tree, path))
        out.append(_tensor(a.T if path[-1] == "kernel" else a, device))
    return out


def ppo_params_to_numpy(networks: PPONetworks) -> Dict[str, Any]:
    return _brax_tree(networks, list(networks.parameters()))


def ppo_params_from_numpy(tree: Dict[str, Any], networks: PPONetworks = None, *,
                          policy_obs_key: str = "state",
                          value_obs_key: str = "privileged_state",
                          device="cpu") -> PPONetworks:
    """The brax tree's values copied into `networks` (in place), or into a
    new PPONetworks whose widths are read off the tree's kernels."""
    if networks is None:
        widths = {}
        for net in ("policy", "value"):
            layers = tree[net]["params"]
            kernels = [np.asarray(layers[f"hidden_{i}"]["kernel"]) for i in range(len(layers))]
            widths[net] = [kernels[0].shape[0]] + [k.shape[1] for k in kernels]
        networks = PPONetworks(
            {policy_obs_key: widths["policy"][0], value_obs_key: widths["value"][0]},
            widths["policy"][-1] // 2, tuple(widths["policy"][1:-1]),
            tuple(widths["value"][1:-1]), policy_obs_key, value_obs_key, device=device)
    dev = next(networks.parameters()).device
    with torch.no_grad():
        for p, t in zip(networks.parameters(), _from_brax_tree(networks, tree, dev)):
            p.copy_(t)
    return networks


def normalizer_to_numpy(rs: RunningStatisticsState) -> Dict[str, Any]:
    return {"count": _numpy(rs.count),
            **{f: {k: _numpy(v) for k, v in getattr(rs, f).items()}
               for f in ("mean", "summed_variance", "std")}}


def normalizer_from_numpy(tree: Dict[str, Any], device="cpu") -> RunningStatisticsState:
    return RunningStatisticsState(
        count=_tensor(tree["count"], device),
        **{f: {k: _tensor(v, device) for k, v in tree[f].items()}
           for f in ("mean", "summed_variance", "std")})


def adam_state_to_numpy(state: AdamState, networks: PPONetworks) -> Dict[str, Any]:
    return {"count": _numpy(state.count), "mu": _brax_tree(networks, state.mu),
            "nu": _brax_tree(networks, state.nu)}


def adam_state_from_numpy(tree: Dict[str, Any], networks: PPONetworks, device="cpu") -> AdamState:
    """optax's ScaleByAdamState fields for the parameters of `networks`."""
    return AdamState(count=torch.as_tensor(np.asarray(tree["count"], np.int32), device=device),
                     mu=_from_brax_tree(networks, tree["mu"], device),
                     nu=_from_brax_tree(networks, tree["nu"], device))


__all__ = ["model_from_numpy", "model_to_numpy", "data_from_numpy", "state_from_numpy",
           "ppo_params_to_numpy", "ppo_params_from_numpy", "normalizer_to_numpy",
           "normalizer_from_numpy", "adam_state_to_numpy", "adam_state_from_numpy"]
