"""Checkpoints as single npz files.

Counterpart of the JAX package's ``train/checkpoint.py``, without orbax:

- ``save``/``load``: ``(normalizer, params)`` per eval step, one npz keyed
  by the brax tree path (``params/policy/params/hidden_0/kernel`` in the
  ``(in, out)`` layout, ``normalizer/mean/state``, ``normalizer/count``,
  ...), restored via ``--restore_checkpoint_path``.
- ``save_full``/``load_full``/``list_full``/``latest_full``: the complete
  training state (a flat ``{name: array}`` dict, see ``ppo.full_state``),
  saved per epoch as ``<dir>/full_<epoch:05d>.npz``, written to a tmp file
  and renamed, with rotation to the newest ``keep``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from open_duck_playground_tpu_torch import interop


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays as {"a/b/c": array}, in insertion order."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _npz(path: str) -> str:
    path = os.path.abspath(str(path))
    return path if path.endswith(".npz") else path + ".npz"


def _write(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save(path: str, params) -> str:
    """params = (normalizer, PPONetworks); writes `path`.npz."""
    normalizer, networks = params
    path = _npz(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write(path, flatten({"normalizer": interop.normalizer_to_numpy(normalizer),
                          "params": interop.ppo_params_to_numpy(networks)}))
    return path


def load(path: str, target) -> Tuple[Any, Any]:
    """(normalizer, PPONetworks) from `path`, on the device of `target`'s
    networks; `target` itself is left as it is."""
    _, networks = target
    tree = unflatten(_read(_npz(path)))
    dev = next(networks.parameters()).device
    restored = interop.ppo_params_from_numpy(tree["params"], copy.deepcopy(networks))
    return interop.normalizer_from_numpy(tree["normalizer"], dev), restored


# ---------------------------------------------------------------------------
# full-state checkpoints (curve-preserving resume)
# ---------------------------------------------------------------------------

_FULL_NPZ_RE = re.compile(r"^full_(\d+)\.npz$")


def full_path(directory: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(directory), f"full_{epoch:05d}.npz")


def save_full(directory: str, epoch: int, state: Dict[str, np.ndarray], keep: int = 2) -> str:
    """Save the full train state of `epoch`; prune to the newest `keep`."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = full_path(directory, epoch)
    _write(path, state)
    for _, old_path in list_full(directory)[:-keep]:
        try:
            os.remove(old_path)
        except OSError:
            pass
    return path


def list_full(directory: str) -> List[Tuple[int, str]]:
    """(epoch, path) of complete full-state checkpoints, oldest first."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _FULL_NPZ_RE.match(name)
        path = os.path.join(directory, name)
        if m and os.path.isfile(path):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_full(directory: str) -> Optional[Tuple[int, str]]:
    entries = list_full(directory)
    return entries[-1] if entries else None


def load_full(path: str) -> Dict[str, np.ndarray]:
    """The {name: array} dict `save_full` wrote."""
    return _read(_npz(path))
