"""Policy export: ONNX writer + numpy ONNX interpreter.

Copies of the JAX package's numpy-only modules (``proto``, ``onnx_model``,
``onnx_checker``, ``onnx_infer``), and ``export.export_onnx``, which takes
the port's ``(normalizer, PPONetworks)`` and emits the same graph: input
"obs" (1, obs_size) float32, baked (x-mean)/std normalization, swish MLP,
tanh(loc) head, output "continuous_actions", opset 11.
"""
