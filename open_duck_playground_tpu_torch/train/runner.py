"""Training runner CLI (parity with the reference's open_duck_mini_v2/runner.py
+ common/runner.py): picks the env and task, wires domain randomization,
trains PPO, writes scalars, checkpoints and an ONNX policy at every eval.

Counterpart of the JAX package's ``train/runner.py``, with the same recipe
overrides, gait-clock flags and ONNX metadata. Scalars go to
``<output_dir>/metrics.jsonl``, one JSON line per eval (``{"step": N,
"<metric>": value, ...}``), in place of TensorBoard.

Usage (on the card; ``--device cpu`` runs the kernel's plain version):
    python -m open_duck_playground_tpu_torch.train.runner \
        --env joystick|standing --task flat_terrain_backlash --num_timesteps 150000000 \
        --output_dir checkpoints [--restore_checkpoint_path P] \
        [--num_envs 8192] [--no_domain_randomization]

Env-sharded over N processes (``parallel/dist.py``): the same command under
``torch.distributed.run``; each rank steps ``num_envs / N`` envs on its own
card (NCCL), or ranks share cards with ``--dist_backend gloo``:
    python -m torch.distributed.run --nproc_per_node N \
        -m open_duck_playground_tpu_torch.train.runner --task flat_terrain_backlash ...
or one process per host, as the JAX runner's flags name it:
    ... runner --coordinator_address HOST:PORT --num_processes N --process_id R
Only rank 0 writes the metrics, checkpoints, ONNX files and full states. A
full state resumes at any world size that divides its envs.
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path
from typing import Optional, Sequence

import torch

from open_duck_playground_tpu_torch.envs import joystick, randomize, standing
from open_duck_playground_tpu_torch.export.onnx_checker import OnnxCheckError
from open_duck_playground_tpu_torch.parallel import dist as pdist
from open_duck_playground_tpu_torch.train import checkpoint as ckpt
from open_duck_playground_tpu_torch.train import ppo
from open_duck_playground_tpu_torch.train.config import brax_ppo_config


class BaseRunner:
    """Train orchestration: metrics file, PPO recipe, progress/ckpt callbacks.
    With a `shard` (``pdist.init_distributed``), the envs and the learner run
    on the shard's device and only rank 0 prints."""

    def __init__(self, args: argparse.Namespace,
                 shard: Optional[pdist.EnvShard] = None) -> None:
        self.args = args
        self.shard = shard
        self.device = torch.device(args.device) if shard is None else shard.device
        self.log = print if shard is None or shard.is_main else (lambda *a, **k: None)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the runner trains on the card unless given "
                               "--device cpu")
        self.output_dir = Path.cwd() / Path(args.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.output_dir / "metrics.jsonl"
        self.env = None
        self.eval_env = None
        self.randomizer = None
        self.action_size = None
        self.obs_size = None
        self.num_timesteps = args.num_timesteps
        self.restore_checkpoint_path = None
        self.deploy_metadata = None

    def progress_callback(self, num_steps: int, metrics: dict) -> None:
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps({"step": num_steps, **metrics}) + "\n")
        print("-----------")
        reward = metrics.get("eval/episode_reward", float("nan"))
        reward_std = metrics.get("eval/episode_reward_std", float("nan"))
        print(f"STEP: {num_steps} reward: {reward} reward_std: {reward_std}")
        if "training/sps" in metrics:
            print(f"  env-steps/s: {metrics['training/sps']:.0f}")
        print("-----------", flush=True)

    def policy_params_fn(self, current_step, make_policy, params):
        del make_policy
        d = datetime.now().strftime("%Y_%m_%d_%H%M%S")
        path = f"{self.output_dir}/{d}_{current_step}"
        print(f"Saving checkpoint (step: {current_step}): {path}.npz")
        ckpt.save(path, params)
        if not self.args.skip_onnx_export:
            from open_duck_playground_tpu_torch.export.export import export_onnx

            onnx_path = f"{self.output_dir}/{d}_{current_step}.onnx"
            try:
                export_onnx(params, self.action_size, self.ppo_params, self.obs_size,
                            output_path=onnx_path, metadata=self.deploy_metadata)
            except (OSError, ValueError, OnnxCheckError) as e:  # keep training alive
                print(f"ONNX export failed: {e}")

    def train_kwargs(self) -> dict:
        """ppo.train's keyword arguments: the recipe with this run's
        overrides, the callbacks and the checkpoint options."""
        self.ppo_params = brax_ppo_config("BerkeleyHumanoidJoystickFlatTerrain")
        overrides = {
            "num_timesteps": self.num_timesteps,
            "num_envs": self.args.num_envs,
            "batch_size": self.args.num_envs // self.ppo_params.num_minibatches,
            "num_evals": self.args.num_evals,
            "num_eval_envs": self.args.num_eval_envs,
        }
        self.ppo_params.update(overrides)
        training_params = dict(self.ppo_params)
        network_cfg = dict(training_params.pop("network_factory"))
        for k in ("policy_hidden_layer_sizes", "value_hidden_layer_sizes"):
            network_cfg[k] = tuple(network_cfg[k])
        self.log(f"PPO params: {training_params}")
        return dict(
            **training_params,
            network_factory=network_cfg,
            randomization_fn=self.randomizer,
            progress_fn=self.progress_callback,
            policy_params_fn=self.policy_params_fn,
            restore_checkpoint_path=self.restore_checkpoint_path,
            seed=self.args.seed,
            save_full_state_dir=(None if self.args.no_full_state_checkpoints
                                 else str(self.output_dir)),
            auto_resume=self.args.auto_resume,
            keep_full_states=self.args.keep_full_states,
            save_full_state_every=self.args.save_full_state_every,
            device=self.device,
            shard=self.shard,
        )

    def train(self, **extra):
        """Trains with `train_kwargs()` (updated by `extra`, e.g.
        profile_breakdown=True); returns (normalizer, params)."""
        kwargs = {**self.train_kwargs(), **extra}
        _, params, _ = ppo.train(environment=self.env, eval_env=self.eval_env, **kwargs)
        return params


class OpenDuckMiniV2Runner(BaseRunner):
    def __init__(self, args, shard: Optional[pdist.EnvShard] = None):
        super().__init__(args, shard)
        available_envs = {
            "joystick": joystick.Joystick,
            "standing": standing.Standing,
        }
        if args.env not in available_envs:
            raise ValueError(f"Unknown env {args.env}")
        cls = available_envs[args.env]
        # gait-clock conditioning overrides (joystick only; see
        # envs/joystick.py default_config for the law)
        overrides = {}
        if args.env == "joystick":
            if args.phase_freq_range is not None:
                overrides["phase_frequency_range"] = list(args.phase_freq_range)
            if args.phase_freq_vx_ref > 0.0:
                overrides["phase_frequency_vx_ref"] = args.phase_freq_vx_ref
                overrides["phase_frequency_max"] = args.phase_freq_max
                # carried in the exported ONNX so deploy applies the same
                # law with no CLI knob
                self.deploy_metadata = {
                    "phase_frequency_vx_ref": repr(args.phase_freq_vx_ref),
                    "phase_frequency_max": repr(args.phase_freq_max),
                }
        self.env = cls(task=args.task, config_overrides=overrides or None, device=self.device)
        self.eval_env = cls(task=args.task, config_overrides=overrides or None,
                            device=self.device)
        self.randomizer = (
            None if args.no_domain_randomization else randomize.domain_randomize
        )
        self.action_size = self.env.action_size
        self.obs_size = int(self.env.observation_size["state"][0])
        self.restore_checkpoint_path = args.restore_checkpoint_path
        self.log(f"Observation size: {self.obs_size}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Open Duck Mini Runner Script")
    parser.add_argument("--output_dir", type=str, default="checkpoints")
    parser.add_argument("--num_timesteps", type=int, default=150_000_000)
    parser.add_argument("--env", type=str, default="joystick")
    parser.add_argument("--task", type=str, default="flat_terrain")
    parser.add_argument("--restore_checkpoint_path", type=str, default=None)
    parser.add_argument("--num_envs", type=int, default=8192)
    parser.add_argument("--num_eval_envs", type=int, default=1024)
    parser.add_argument("--num_evals", type=int, default=15)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_domain_randomization", action="store_true")
    # gait-clock conditioning (defaults = reference parity)
    parser.add_argument("--phase_freq_range", type=float, nargs=2, default=None,
                        metavar=("LO", "HI"),
                        help="per-episode gait-clock factor ~ U(LO, HI)")
    parser.add_argument("--phase_freq_vx_ref", type=float, default=0.0,
                        help="enable factor=clip(|cmd_vx|/REF, 1, max); "
                             "carried into ONNX metadata for deploy")
    parser.add_argument("--phase_freq_max", type=float, default=1.4)
    parser.add_argument("--skip_onnx_export", action="store_true")
    # curve-preserving resume: the full train state (params + optimizer +
    # env batch + generators) is checkpointed per epoch under output_dir with
    # rotation; --auto_resume continues a killed run exactly
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--keep_full_states", type=int, default=2)
    # save every N epochs (final/stop epochs always saved)
    parser.add_argument("--save_full_state_every", type=int, default=1)
    parser.add_argument("--no_full_state_checkpoints", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the fused kernel) or 'cpu' (its plain version)")
    # env-sharded runs: torch.distributed.run's environment, or these flags
    # (one process per host, as the JAX runner's); see parallel/dist.py
    parser.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="default: nccl when every rank has a card of its own; gloo "
                             "lets ranks share cards")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="HOST:PORT of rank 0 (tcp:// rendezvous)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser


def init_distributed(args: argparse.Namespace) -> pdist.EnvShard:
    """The process group of this run, from torch.distributed.run's
    environment or the --coordinator_address/--num_processes/--process_id
    flags (world size 1 without either)."""
    addr = args.coordinator_address
    return pdist.init_distributed(args.dist_backend, device=args.device,
                                  init_method=None if addr is None else f"tcp://{addr}",
                                  rank=args.process_id, world_size=args.num_processes)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    shard = init_distributed(args)
    try:
        OpenDuckMiniV2Runner(args, shard).train()
    finally:
        pdist.destroy()


if __name__ == "__main__":
    main()
