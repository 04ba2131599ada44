"""The port's ONNX export: the counterparts of tests/test_export.py, and the
same carried-across params giving byte-identical ONNX from both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_duck_playground_tpu.export.export import export_onnx as jax_export_onnx
from open_duck_playground_tpu.train import networks as jnets
from open_duck_playground_tpu_torch import interop
from open_duck_playground_tpu_torch.export import onnx_model as om
from open_duck_playground_tpu_torch.export.export import export_onnx
from open_duck_playground_tpu_torch.export.onnx_checker import OnnxCheckError, check_model
from open_duck_playground_tpu_torch.export.onnx_infer import NumpyOnnxSession, OnnxInfer
from open_duck_playground_tpu_torch.train import networks as nets
from tests.torch_helpers import numpy_tree

pytest_plugins = ["tests.torch_lock"]  # never beside tests/test_resume.py (see there)


def _make_params(obs_size=101, act_size=14, seed=0):
    obs_sizes = {"state": obs_size, "privileged_state": 212}
    network = nets.PPONetworks(obs_sizes, act_size,
                               generator=torch.Generator().manual_seed(seed))
    # non-trivial normalizer stats
    g = torch.Generator().manual_seed(seed + 1)
    normalizer = nets.rs_update(nets.rs_init(obs_sizes), {
        "state": 2.0 + 3.0 * torch.randn((64, obs_size), generator=g),
        "privileged_state": torch.zeros(64, 212)})
    return network, (normalizer, network)


def test_onnx_roundtrip(tmp_path):
    obs_size, act_size = 101, 14
    network, full_params = _make_params(obs_size, act_size)
    path = str(tmp_path / "policy.onnx")
    export_onnx(full_params, act_size, None, obs_size, output_path=path)

    policy = network.make_policy_fn(deterministic=True)
    session = NumpyOnnxSession(path)
    rng = np.random.RandomState(0)
    for _ in range(5):
        obs = rng.randn(1, obs_size).astype(np.float32)
        action = policy(full_params, {"state": torch.as_tensor(obs),
                                      "privileged_state": torch.zeros(1, 212)})[0][0].numpy()
        onnx_action = session.run(None, {"obs": obs})[0][0]
        np.testing.assert_allclose(onnx_action, action, rtol=1e-4, atol=1e-5)


def test_onnx_infer_wrapper(tmp_path):
    obs_size, act_size = 46, 14
    _, full_params = _make_params(obs_size, act_size)
    path = str(tmp_path / "policy.onnx")
    export_onnx(full_params, act_size, None, obs_size, output_path=path)
    out = OnnxInfer(path, awd=True).infer(np.zeros(obs_size, np.float32))
    assert out.shape == (act_size,)
    assert np.isfinite(out).all()
    assert (np.abs(out) <= 1.0).all()  # tanh head


def test_model_proto_structure(tmp_path):
    """Exported file parses and exposes the reference graph contract."""
    _, full_params = _make_params(101, 14)
    path = str(tmp_path / "policy.onnx")
    export_onnx(full_params, 14, None, 101, output_path=path)
    m = om.load_model(path)
    assert m.inputs == ["obs"]
    assert m.outputs == ["continuous_actions"]
    ops = [n.op_type for n in m.nodes]
    assert ops.count("MatMul") == 4  # 3 hidden + 1 head
    assert ops.count("Sigmoid") == 3  # swish on hidden layers
    assert ops[-1] == "Tanh"


def test_onnx_checker_validates_and_rejects():
    """The port's copy of the wire-level checker accepts a fresh graph and
    rejects targeted corruptions (wrong opset, broken SSA, bad shapes)."""

    def build(opset=11, hide_init=False, bad_matmul=False, out_name="continuous_actions"):
        w = np.ones((5 if bad_matmul else 4, 3), np.float32)
        nodes = [om.node("MatMul", ["obs", "w"], ["mm"], "mm"),
                 om.node("Tanh", ["mm"], [out_name], "head")]
        g = om.graph("g", nodes=nodes, inputs=[om.value_info("obs", (1, 4))],
                     outputs=[om.value_info(out_name, (1, 3))],
                     initializers=[] if hide_init else [om.tensor("w", w)])
        return om.model(g, opset=opset)

    info = check_model(build())
    assert info["obs_size"] == 4 and info["act_size"] == 3
    with pytest.raises(OnnxCheckError, match="opset"):
        check_model(build(opset=13))
    with pytest.raises(OnnxCheckError, match="SSA"):
        check_model(build(hide_init=True))
    with pytest.raises(OnnxCheckError, match="incompatible"):
        check_model(build(bad_matmul=True))
    with pytest.raises(OnnxCheckError, match="output"):
        check_model(build(out_name="wrong_name"))


def test_onnx_checker_on_real_export(tmp_path):
    obs_sizes = {"state": 12, "privileged_state": 20}
    network = nets.PPONetworks(obs_sizes, 5, policy_hidden_layer_sizes=(8, 8),
                               generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.onnx")
    export_onnx((nets.rs_init(obs_sizes), network), 5, output_path=path)
    info = check_model(path)
    assert info["obs_size"] == 12 and info["act_size"] == 5


def test_onnx_bytes_identical_to_the_jax_export(tmp_path):
    """The JAX package's params and normalizer, carried across with interop,
    export to the same bytes from both packages, metadata included."""
    obs_sizes = {"state": 101, "privileged_state": 212}
    network = jnets.PPONetworks(obs_sizes, 14)
    params = network.init(jax.random.PRNGKey(3))
    normalizer = jnets.rs_update(jnets.rs_init(obs_sizes), {
        "state": 2.0 + 3.0 * jax.random.normal(jax.random.PRNGKey(4), (64, 101)),
        "privileged_state": jnp.zeros((64, 212))})
    port = (interop.normalizer_from_numpy(numpy_tree(normalizer)),
            interop.ppo_params_from_numpy(numpy_tree(params)))
    meta = {"phase_frequency_vx_ref": repr(0.094), "phase_frequency_max": repr(1.4)}
    a, b = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    jax_export_onnx((normalizer, params), 14, None, 101, output_path=a, metadata=meta)
    export_onnx(port, 14, None, 101, output_path=b, metadata=meta)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
