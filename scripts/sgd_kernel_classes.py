"""Device time of the trainer's SGD step by kernel class, on one GPU.

    python3 scripts/sgd_kernel_classes.py [--root DIR] [--label NAME]

Runs the SGD step of the joystick recipe (obs 101 / 212, 14 actions, (512,
256, 128) networks, 8192 envs x unroll 20, 32 minibatches of 256, 4
updates) on seeded inputs, with the port of the checkout at `--root`
(default: this one; an earlier checkout from `git archive <commit> | tar -x
-C build/parent`). Reports:

- `sgd_ms`: one replay of `ppo.make_sgd_step`'s program (a CUDA graph),
  CUDA events over 5 replays, and its kernel and memcpy nodes;
- `classes`: the replay's device time by kernel name (the profiler's trace
  of 2 replays, per replay), largest first;
- `swish`: the swish's share of the replay. Eagerly (the body,
  `ppo.sgd_step`, under the profiler with shapes), the self device time of
  aten::sigmoid, sigmoid_backward, mul and add on tensors of the MLPs'
  activations ([20, 256, w], w in 512, 256, 128), by op (the bootstrap
  value's forward on [256, w], 0.7% of the swish's bytes, is left out: a
  [256, 512] mul there cannot be told from one on a weight's gradient); in
  the replay, the kernels named `duck_swish_*`.

Prints one "SGD_CLASSES {json}" line and writes it to
`build/sgd_kernel_classes_<label>.json` of this checkout. Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, ACT, NF = {"state": 101, "privileged_state": 212}, 14, (512, 256, 128)
N, T, NMB, B, E = 8192, 20, 32, 256, 4
WIDTHS = (512, 256, 128)
SWISH_OPS = ("aten::sigmoid", "aten::sigmoid_backward", "aten::mul", "aten::add", "aten::add_")


def _inputs(ts, ppo, nets, dev, seed: int):
    """A seeded rollout's Transition at the recipe's shapes (actions from the
    state's policy), the epochs' permutations and the entropy noise."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    obs = {k: f32(T, N, n) * 2.0 + 0.5 for k, n in OBS.items()}
    nxt = {k: v + 0.1 * f32(T, N, v.shape[-1]) for k, v in obs.items()}
    action, raw, log_prob = nets.sample_actions(ts.params, ts.normalizer, obs, f32(T, N, ACT))
    done = (torch.rand((T, N), generator=gen, device=dev) < 0.1).float()
    trunc = (torch.rand((T, N), generator=gen, device=dev) < 0.5).float() * done
    data = ppo.Transition(observation=obs, action=action, reward=f32(T, N), discount=1.0 - done,
                          next_observation=nxt, truncation=trunc, raw_action=raw,
                          log_prob=log_prob)
    perms = torch.stack([torch.randperm(N, generator=gen, device=dev) for _ in range(E)])
    return data, perms, f32(E, NMB, T, B, ACT)


def _activation(shape) -> bool:
    return tuple(shape[:-1]) == (T, B) and shape[-1] in WIDTHS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("sgd_kernel_classes: CUDA is not available", file=sys.stderr)
        return 2
    from open_duck_playground_tpu_torch.train import networks as nets
    from open_duck_playground_tpu_torch.train import ppo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    hp = ppo.Hyper(num_envs=N, unroll_length=T, num_minibatches=NMB, batch_size=B,
                   num_updates_per_batch=E, action_repeat=1, learning_rate=3e-4,
                   entropy_cost=1e-2, discounting=0.97, gae_lambda=0.95, clipping_epsilon=0.2,
                   normalize_advantage=True, reward_scaling=1.0, normalize_observations=True,
                   max_grad_norm=1.0)
    nf = {"policy_hidden_layer_sizes": NF, "value_hidden_layer_sizes": NF}
    ts = ppo.init_training_state(OBS, ACT, nf, torch.Generator(device=dev).manual_seed(0), dev)
    data, perms, ent = _inputs(ts, ppo, nets, dev, 1)

    # eagerly, by op and shape: the swish's torch ops on activation tensors
    ppo.sgd_step(ts, data, perms, ent, hp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        ppo.sgd_step(ts, data, perms, ent, hp)
        torch.cuda.synchronize()
    eager = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages(group_by_input_shape=True):
        shapes = [s for s in (ev.input_shapes or []) if s]
        if ev.key in SWISH_OPS and shapes and _activation(shapes[0]):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            eager[ev.key][0] += us / 1e3
            eager[ev.key][1] += ev.count
    del prof

    # the program: one CUDA graph a call
    sgd = ppo.make_sgd_step(ts, hp)
    sgd(ts, data, perms, ent, hp)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        sgd(ts, data, perms, ent, hp)
    b.record()
    torch.cuda.synchronize()
    sgd_ms = a.elapsed_time(b) / 5
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, f"sgd_kernel_classes_{args.label}.trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            sgd(ts, data, perms, ent, hp)
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    classes = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.get("cat") == "kernel":
            name = ev["name"][:96]
            classes[name][0] += ev["dur"] / 1e3 / 2
            classes[name][1] += 1
    busy = sum(v[0] for v in classes.values())
    swish_fused = {k: v for k, v in classes.items() if "duck_swish" in k}
    info = sgd.info
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = {
        "label": args.label, "root": root, "gpu": gpu, "torch": torch.__version__,
        "sgd_ms": round(sgd_ms, 3), "kernel_ms": round(busy, 3),
        "nodes": {k: info.get(k) for k in ("kernel_nodes", "memcpy_nodes", "memset_nodes",
                                           "pool_bytes", "fused_launches_per_replay",
                                           "launches_per_replay")},
        "swish_eager_ms": {k: [round(v[0], 4), v[1]] for k, v in eager.items()},
        "swish_eager_ms_total": round(sum(v[0] for v in eager.values()), 4),
        "swish_replay_ms": {k: [round(v[0], 4), v[1] // 2] for k, v in swish_fused.items()},
        "swish_replay_ms_total": round(sum(v[0] for v in swish_fused.values()), 4),
        "classes": [[k, round(v[0], 4), v[1] // 2] for k, v in
                    sorted(classes.items(), key=lambda kv: -kv[1][0])[:24]],
        "at": time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
    }
    line = json.dumps(result)
    print(f"SGD_CLASSES {line}", flush=True)
    with open(os.path.join(out_dir, f"sgd_kernel_classes_{args.label}.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
