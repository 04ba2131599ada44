"""Export a trained policy to ONNX (reference-compatible graph contract).

Counterpart of the JAX package's ``export/export.py``, emitting the same
bytes for the same parameters:
- input  "obs": float32 (1, obs_size)
- normalization baked in: (obs - mean) / std from the running statistics
- swish MLP with the trained hidden sizes
- deterministic head: tanh(loc) of the first half of the 2*act_size logits
- output "continuous_actions": float32 (1, act_size), opset 11

The port's ``(normalizer, PPONetworks)`` is turned into numpy in the brax
layout first (kernels ``(in, out)``, ``interop.ppo_params_to_numpy``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.export import onnx_model as om


def export_onnx(params, act_size: int, ppo_params=None, obs_size: Optional[int] = None,
                output_path: str = "ONNX.onnx", metadata=None) -> str:
    """params = (normalizer, PPONetworks) as returned by ppo.train."""
    del ppo_params
    normalizer, networks = params
    norm = interop.normalizer_to_numpy(normalizer)
    mean = np.asarray(norm["mean"]["state"], np.float32)
    std = np.asarray(norm["std"]["state"], np.float32)
    if obs_size is None:
        obs_size = mean.shape[-1]

    mlp = interop.ppo_params_to_numpy(networks)["policy"]["params"]
    n_layers = len(mlp)

    nodes = []
    initializers = [
        om.tensor("obs_mean", mean.reshape(1, -1)),
        om.tensor("obs_std", std.reshape(1, -1)),
    ]

    nodes.append(om.node("Sub", ["obs", "obs_mean"], ["norm_centered"], "normalize_sub"))
    nodes.append(om.node("Div", ["norm_centered", "obs_std"], ["norm"], "normalize_div"))

    x = "norm"
    for i in range(n_layers):
        layer = mlp[f"hidden_{i}"]
        w = np.asarray(layer["kernel"], np.float32)
        b = np.asarray(layer["bias"], np.float32)
        initializers.append(om.tensor(f"w_{i}", w))
        initializers.append(om.tensor(f"b_{i}", b.reshape(1, -1)))
        nodes.append(om.node("MatMul", [x, f"w_{i}"], [f"mm_{i}"], f"dense_{i}_matmul"))
        nodes.append(om.node("Add", [f"mm_{i}", f"b_{i}"], [f"dense_{i}"], f"dense_{i}_add"))
        x = f"dense_{i}"
        if i < n_layers - 1:  # swish on hidden layers
            nodes.append(om.node("Sigmoid", [x], [f"sig_{i}"], f"swish_{i}_sigmoid"))
            nodes.append(om.node("Mul", [x, f"sig_{i}"], [f"act_{i}"], f"swish_{i}_mul"))
            x = f"act_{i}"

    initializers.append(om.tensor("slice_starts", np.asarray([0], np.int64)))
    initializers.append(om.tensor("slice_ends", np.asarray([act_size], np.int64)))
    initializers.append(om.tensor("slice_axes", np.asarray([1], np.int64)))
    nodes.append(
        om.node("Slice", [x, "slice_starts", "slice_ends", "slice_axes"], ["loc"], "take_loc")
    )
    nodes.append(om.node("Tanh", ["loc"], ["continuous_actions"], "tanh_head"))

    g = om.graph(
        "duck_policy",
        nodes=nodes,
        inputs=[om.value_info("obs", (1, obs_size))],
        outputs=[om.value_info("continuous_actions", (1, act_size))],
        initializers=initializers,
    )
    data = om.model(g, opset=11, metadata=metadata)
    # spec conformance gate on every export (independent wire-level checker)
    from open_duck_playground_tpu_torch.export.onnx_checker import check_model

    check_model(data)
    with open(output_path, "wb") as f:
        f.write(data)
    print(f" === EXPORT ONNX === wrote {output_path} "
          f"(obs {obs_size} -> act {act_size}, {n_layers} layers)")
    return output_path
