"""ONNX policy inference (parity with reference common/onnx_infer.py).

Prefers onnxruntime when installed (the real robot's deployment runtime);
falls back to a numpy interpreter covering the op set our exporter emits
(Sub, Div, MatMul, Add, Sigmoid, Mul, Slice, Tanh, Split) so exported
policies are verifiable in this image with zero extra dependencies.

`python -m open_duck_playground_tpu_torch.export.onnx_infer -o model.onnx`
micro-benchmarks average inference latency/fps over 1000 calls, like the
reference harness (onnx_infer.py:24-46).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from open_duck_playground_tpu_torch.export.onnx_model import ParsedModel, load_model


class NumpyOnnxSession:
    """Reference interpreter for the exported policy graphs."""

    def __init__(self, path: str, model: ParsedModel | None = None):
        self.model = model if model is not None else load_model(path)

    def run(self, output_names, feeds: Dict[str, np.ndarray]):
        env: Dict[str, np.ndarray] = dict(self.model.initializers)
        env.update({k: np.asarray(v, np.float32) for k, v in feeds.items()})
        for n in self.model.nodes:
            i = [env[name] for name in n.inputs]
            if n.op_type == "Sub":
                out = i[0] - i[1]
            elif n.op_type == "Div":
                out = i[0] / i[1]
            elif n.op_type == "MatMul":
                out = i[0] @ i[1]
            elif n.op_type == "Add":
                out = i[0] + i[1]
            elif n.op_type == "Sigmoid":
                out = 1.0 / (1.0 + np.exp(-i[0]))
            elif n.op_type == "Mul":
                out = i[0] * i[1]
            elif n.op_type == "Tanh":
                out = np.tanh(i[0])
            elif n.op_type == "Slice":
                data, starts, ends, axes = i[0], i[1], i[2], i[3]
                sl = [slice(None)] * data.ndim
                for s, e, ax in zip(starts, ends, axes):
                    sl[int(ax)] = slice(int(s), int(e))
                out = data[tuple(sl)]
            elif n.op_type == "Split":
                parts = np.split(i[0], len(n.outputs), axis=n.attrs.get("axis", 0))
                for name, part in zip(n.outputs, parts):
                    env[name] = part
                continue
            else:
                raise NotImplementedError(f"op {n.op_type}")
            env[n.outputs[0]] = out
        names = output_names or self.model.outputs
        return [env[name] for name in names]


class OnnxInfer:
    def __init__(self, onnx_model_path: str, input_name: str = "obs", awd: bool = False):
        self.onnx_model_path = onnx_model_path
        self.input_name = input_name
        self.awd = awd
        # recipe constants carried in metadata_props (e.g. the gait-clock
        # command law) — parsed with our own reader for both backends;
        # the single parse is shared with the numpy fallback session
        parsed = load_model(onnx_model_path)
        self.metadata = parsed.metadata
        try:
            import onnxruntime  # noqa: PLC0415

            self.ort_session = onnxruntime.InferenceSession(
                onnx_model_path, providers=["CPUExecutionProvider"]
            )
            self._run = lambda feeds: self.ort_session.run(None, feeds)
        except ImportError:
            session = NumpyOnnxSession(onnx_model_path, model=parsed)
            self._run = lambda feeds: session.run(None, feeds)

    def infer(self, inputs):
        if self.awd:
            outputs = self._run({self.input_name: [np.asarray(inputs, np.float32)]})
            return outputs[0][0]
        outputs = self._run({self.input_name: np.asarray(inputs, np.float32)})
        return outputs[0]


if __name__ == "__main__":
    import argparse
    import time

    parser = argparse.ArgumentParser()
    parser.add_argument("-o", "--onnx_model_path", type=str, required=True)
    parser.add_argument("--obs_size", type=int, default=101)
    args = parser.parse_args()

    oi = OnnxInfer(args.onnx_model_path, awd=True)
    times = []
    for _ in range(1000):
        inputs = np.random.uniform(size=args.obs_size).astype(np.float32)
        start = time.time()
        oi.infer(inputs)
        times.append(time.time() - start)
    print("Average time: ", sum(times) / len(times))
    print("Average fps: ", 1 / (sum(times) / len(times)))
