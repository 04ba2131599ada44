"""Whether what the timed path produced is correct: the plain reference
(``ref/``, plain PyTorch, no part of the port) follows it, and each number
compared is held to its limit (``limits/<cell>.json``).

Training cells. Set-up drives the program from the seed through its first
``follow`` training steps, through the window's own calls, and records
(``TrainRecord``) their reset state, transitions, draws, mean losses, the
normalizer after each step, the Adam moments after the first step and the
params after the last. After the window the reference works out, from the
same seed and the same draws:

- the reset, from its own compile of the scene, its own domain
  randomization and its own env (every tensor of the state), and the first
  ``physics_steps`` env steps of the first rollout from its own reset with
  its own policy's actions (the actions, the next observations, rewards,
  discounts and truncations): the fused kernel, the env's reward and
  observation, the autoreset (``env_gap``, the largest gap of them all);
- each followed step's policy on the program's observations with the step's
  noise (``policy_gap``: raw actions and log-probs), and its SGD step on the
  program's transitions with the step's permutations and entropy noise,
  from its own learner state (``loss_gap``: each step's total loss,
  relative; ``grad_gap``: the first step's Adam first moment, the gradient
  as the optimizer holds it; ``change_gap``: the params' change over the
  followed steps; both by the worst leaf, the gap between the program's
  norm and the reference's against the reference's norm of that leaf or of
  the median leaf, whichever is larger). Leaves whose reference moment is
  under a thousandth of the median leaf's are left out of ``change_gap``.

The reference follows the program step by step: the SGD reads the
program's transitions (the physics of steps 2 to unroll_length of each
rollout is not worked out again: the twin takes seconds per control step),
and the start and the stages this skips are checked by themselves
(``env_gap``, ``policy_gap``). On a cell of many cards the reference
follows the program's observation normalizer too: its policy and SGD step
take the program's normalizer after each step, and the program's is held
by itself (``norm_gap``) to the reference's own chain of updates over the
same observations, from the reference's own state before each. The first
update's variance of a near-constant observation is the small difference
of large sums, so that another order of the sums (the ranks' partials)
moves that feature's std by tens of percent, and the normalized inputs,
the policy and the gradients with it; followed, they read rounding.

Eval cells. Set-up runs one whole episode through the window's own calls;
the harness records its reset (with the generators' states before it) and,
at a few steps drawn from the seed, the carry before and after the step.
The reference works out the reset and each sampled step from the program's
carry before it: the policy's action with the eval generator's noise and
the env step (``env_gap``: the largest gap over the reset state, the action
taken, the next observations, rewards and dones, and the carried sums).

The control is the reference computed with TF32 products
(``precision.py``), put in the program's place; the rounding reading is the
reference with its sums in another order (``precision.reordered``) in the
program's place, the room a limit leaves above a sound run; a cell on more
cards than one has a reading of its own, the reference with its sums over
envs taken as the ranks' partials (``precision.rank_partials``).

A cell on more cards than one is checked against the same one-process
reference: rank 0 holds every rank's followed steps, rows in rank order
(``ranks.gather_train``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
from typing import Dict, List, Optional

import torch

from duckbench import precision, traffic
from duckbench.program import param_shapes


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------


def leaves(x, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tensors of a tree of dataclasses, dicts and tensors by path."""
    if x is None:
        return {}
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(x, (list, tuple)):
        out = {}
        for i, v in enumerate(x):
            out.update(leaves(v, f"{prefix}/{i}"))
        return out
    out = {}
    for f in dataclasses.fields(x):
        out.update(leaves(getattr(x, f.name), f"{prefix}/{f.name}"))
    return out


def clone(x) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in leaves(x).items()}


def max_gap(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    """The largest |a - b| over the tensors of `b` (NaN where both are NaN
    counts 0, NaN on one side infinity); a tensor missing or of another
    shape in `a` is infinity."""
    worst = 0.0
    for k, y in b.items():
        x = a.get(k)
        if x is None or x.shape != y.shape:
            return float("inf")
        if y.numel() == 0:
            continue
        x, y = x.double(), y.double()
        d = torch.where(torch.isnan(x) & torch.isnan(y), 0.0, (x - y).abs())
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return worst


def leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
              keep: Optional[List[bool]] = None) -> List[Optional[float]]:
    """Each leaf's | |prog| - |ref| | / max(|ref|, median leaf |ref|), None
    for a leaf not kept."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = statistics.median(rn)
    keep = keep or [True] * len(rn)
    return [(abs(p - r) / max(r, med) if max(r, med) > 0 else abs(p - r)) if k else None
            for p, r, k in zip(pn, rn, keep)]


def worst_leaf(prog: List[torch.Tensor], ref: List[torch.Tensor],
               keep: Optional[List[bool]] = None) -> float:
    """The largest of leaf_gaps (0 with none kept)."""
    return max((g for g in leaf_gaps(prog, ref, keep) if g is not None), default=0.0)


def _transition(data: Dict[str, torch.Tensor], cls):
    """A Transition of class `cls` from its leaves (clone's paths)."""
    out = {}
    for f in dataclasses.fields(cls):
        keys = {k[len(f.name) + 2:]: v for k, v in data.items() if k.startswith(f"/{f.name}/")}
        out[f.name] = keys if keys else data[f"/{f.name}"]
    return cls(**out)


def _state_leaves(state) -> Dict[str, torch.Tensor]:
    """The state's tensors without the autoreset cache (it repeats them)."""
    return {k: v for k, v in leaves(state).items()
            if not k.startswith(("/info/first_data", "/info/first_obs"))}


# ---------------------------------------------------------------------------
# training cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainRecord:
    """What the program produced on the followed training steps."""

    reset: Dict[str, torch.Tensor]
    data: List[Dict[str, torch.Tensor]]
    draws: List[tuple]
    losses: List[Dict[str, float]]
    mu1: List[torch.Tensor]
    params_end: List[torch.Tensor]
    normalizers: List[Dict[str, torch.Tensor]] = dataclasses.field(default_factory=list)


def follow_train(prog, n: int) -> TrainRecord:
    """Drive the program through its first `n` training steps (the window's
    own calls and feed; the rollout's transitions copied as they come)."""
    reset = {k: v.clone() for k, v in _state_leaves(prog.state).items()}
    data, draws_all, losses_all = [], [], []
    roll = prog.roll

    def recording_roll(*args):
        state, d = roll(*args)
        data.append(clone(d))
        return state, d

    mu1, norms = None, []
    for k in range(n):
        draws = prog.draws()
        losses = prog.step(draws, roll=recording_roll)
        draws_all.append(draws)
        losses_all.append({key: float(v) for key, v in losses.items()})
        norms.append(clone(prog.ts.normalizer))
        if k == 0:
            mu1 = [m.detach().clone() for m in prog.ts.opt_state.mu]
    params = [p.detach().clone() for p in prog.ts.params.parameters()]
    return TrainRecord(reset, data, draws_all, losses_all, mu1, params, norms)


def _nominal(model, num_envs: int, generator=None):
    """The model with every randomized field given a leading env dim and its
    own value in every row: the plain physics then takes the fields as the
    kernel's randomized path does, which reproduces the kernel's path
    without randomization bit for bit on the card (the plain physics without
    them folds some constants in float64, as the port's CPU path does)."""
    from duckbench.ref.envs import randomize

    return model.tree_replace({f: getattr(model, f).expand((num_envs,) + getattr(model, f).shape)
                               .clone() for f in randomize.RANDOMIZED_FIELDS})


def ref_env_class(name: str):
    """The reference's env class for a configuration's ``env``: the class
    named after it (``joystick``: ``Joystick``) in ``ref/envs/<env>.py``, so
    that a configuration of another env brings its reference as a file."""
    import importlib
    import re

    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"env {name!r} is not a module name")
    path = f"duckbench/ref/envs/{name}.py"
    try:
        mod = importlib.import_module(f"duckbench.ref.envs.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"the reference has no {name} env: no module {path}") from e
    cls = "".join(part.capitalize() for part in name.split("_"))
    if not hasattr(mod, cls):
        raise ValueError(f"the reference's {path} has no class {cls}")
    return getattr(mod, cls)


def _ref_env(cfg: dict, sd: Dict[str, int], device, num_envs: int, randomized: bool):
    from duckbench.ref.envs import randomize
    from duckbench.ref.envs.wrapper import TrainEnv

    env = ref_env_class(cfg["env"])(task=cfg["task"],
                                    config_overrides=cfg["env_overrides"] or None, device=device)
    env.generator.manual_seed(sd["env"])
    p = cfg["ppo"]
    return env, TrainEnv(env, num_envs=num_envs, episode_length=p["episode_length"],
                         action_repeat=p["action_repeat"],
                         randomization_fn=(randomize.domain_randomize if randomized else
                                           _nominal if torch.device(device).type == "cuda"
                                           else None),
                         randomization_generator=traffic.generator(sd["randomization"], device))


def _ref_networks(cfg: dict, sd: Dict[str, int], device):
    from duckbench.ref.train import networks as nets

    net = cfg["network"]
    nw = nets.PPONetworks(cfg["obs_sizes"], cfg["action_size"],
                          policy_hidden_layer_sizes=tuple(net["policy_hidden_layer_sizes"]),
                          value_hidden_layer_sizes=tuple(net["value_hidden_layer_sizes"]),
                          policy_obs_key=net["policy_obs_key"],
                          value_obs_key=net["value_obs_key"], device=device)
    with torch.no_grad():
        for p, w in zip(nw.parameters(), traffic.weights(sd["weights"], param_shapes(cfg), device),
                        strict=True):
            p.copy_(w)
    return nw


@torch.no_grad()
def _policy(nw, normalizer, obs, noise):
    from duckbench.ref.train import networks as nets

    loc, scale = nets.dist_create(nw.policy_logits(normalizer, obs))
    raw = loc + scale * noise
    return raw, nets.dist_log_prob(loc, scale, raw)


def _variant(nw, control: bool, rounding: bool, partials: int = 0):
    if control:
        return precision.tf32_linears(nw)
    if partials:
        return precision.rank_partials(nw, partials)
    return precision.reordered(nw) if rounding else contextlib.nullcontext()


def _normalizer(leaves_: Dict[str, torch.Tensor]):
    """A normalizer state of the reference's class from clone()'s leaves."""
    from duckbench.ref.train import networks as nets

    def group(name):
        return {k[len(name) + 2:]: v.clone() for k, v in leaves_.items()
                if k.startswith(f"/{name}/")}

    return nets.RunningStatisticsState(count=leaves_["/count"].clone(), mean=group("mean"),
                                       summed_variance=group("summed_variance"),
                                       std=group("std"))


def reference_start(cfg: dict, sd: Dict[str, int], device, rec: TrainRecord,
                    physics_steps: int, control: bool = False, rounding: bool = False) -> dict:
    """The reference's reset and the first `physics_steps` env steps of its
    first rollout, with its own policy's actions on the first draw's noise
    (control: TF32 products; rounding: its sums reordered). It depends on
    the seed alone, not on the program's record beyond that draw."""
    from duckbench.ref.train import networks as nets

    _, te = _ref_env(cfg, sd, device, cfg["ppo"]["num_envs"], cfg["domain_randomization"])
    nw = _ref_networks(cfg, sd, device)
    normalizer = nets.rs_init(cfg["obs_sizes"], device)
    steps = []
    with _variant(nw, control, rounding):
        state = reset = te.reset(traffic.generator(sd["reset"], device))
        for t in range(physics_steps):
            raw, _ = _policy(nw, normalizer, state.obs, rec.draws[0][0][t])
            action = torch.tanh(raw)
            state = te.step(state, action)
            steps.append({"action": action, "reward": state.reward,
                          "discount": 1.0 - state.done, "truncation": state.info["truncation"],
                          **{f"next_obs/{k}": v for k, v in state.obs.items()}})
    return {"reset": _state_leaves(reset), "step": steps}


def reference_train(cfg: dict, sd: Dict[str, int], device, rec: TrainRecord,
                    physics_steps: int, control: bool = False, rounding: bool = False,
                    partials: int = 0, follow_normalizer: bool = False,
                    start: Optional[dict] = None) -> dict:
    """The reference's record of the followed steps (control: with TF32
    products; rounding: with its sums reordered; partials: with its sums
    over envs taken as that many ranks' partials), in program_train's
    layout. `start` is reference_start's record to take instead of working
    it out (an empty one leaves the start, and env_gap, out). With
    `follow_normalizer` the policy and the SGD step of each followed step
    take the program's normalizer, and the record holds the reference's own
    chain of normalizer updates (``norm_gap``)."""
    from duckbench.ref.train import networks as nets
    from duckbench.ref.train import optim
    from duckbench.ref.train import ppo

    p = cfg["ppo"]
    out = dict(reference_start(cfg, sd, device, rec, physics_steps, control, rounding)
               if start is None else start)
    out.update(raw=[], logp=[], losses=[], normalizers=[])
    nw = _ref_networks(cfg, sd, device)
    with _variant(nw, control, rounding, partials):
        learner = ppo.Learner(params=nw, normalizer=nets.rs_init(cfg["obs_sizes"], device),
                              opt_state=optim.adam_init(list(nw.parameters())))
        own = learner.normalizer
        hp = ppo.Hyper(**{f.name: p[f.name] for f in dataclasses.fields(ppo.Hyper)})
        for k, (data, (noise, perms, ent)) in enumerate(zip(rec.data, rec.draws)):
            data = _transition(data, ppo.Transition)
            # one control step at a time, as the rollout computes them
            steps = [_policy(nw, learner.normalizer, {key: v[t] for key, v in
                                                      data.observation.items()}, noise[t])
                     for t in range(noise.shape[0])]
            out["raw"].append(torch.stack([r for r, _ in steps]))
            out["logp"].append(torch.stack([lp for _, lp in steps]))
            step_hp = hp
            if follow_normalizer and hp.normalize_observations:
                own = nets.rs_update(own, data.observation)
                out["normalizers"].append(clone(own))
                learner.normalizer = _normalizer(rec.normalizers[k])
                step_hp = dataclasses.replace(hp, normalize_observations=False)
            losses = ppo.sgd_step(learner, data, perms, ent, step_hp)
            out["losses"].append({key: float(v.mean()) for key, v in losses.items()})
            if k == 0:
                out["mu1"] = [m.clone() for m in learner.opt_state.mu]
        out["params_end"] = [q.detach().clone() for q in nw.parameters()]
    return out


def program_train(rec: TrainRecord, physics_steps: int) -> dict:
    """The program's record in the reference's layout."""
    d0 = rec.data[0]
    step = []
    for t in range(physics_steps):
        step.append({"action": d0["/action"][t], "reward": d0["/reward"][t],
                     "discount": d0["/discount"][t], "truncation": d0["/truncation"][t],
                     **{f"next_obs/{k.split('/')[-1]}": v[t] for k, v in d0.items()
                        if k.startswith("/next_observation/")}})
    return {"reset": rec.reset, "step": step,
            "raw": [d["/raw_action"] for d in rec.data], "logp": [d["/log_prob"] for d in rec.data],
            "losses": rec.losses, "mu1": rec.mu1, "params_end": rec.params_end,
            "normalizers": rec.normalizers}


def norm_gap(got: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]]) -> float:
    """The largest gap of the program's normalizer after each followed step
    (`got`) from the reference's own chain of updates (`ref`): the count's,
    relative; each feature's mean's, against the root mean square of the
    observations seen (sqrt(variance + mean^2)); and its summed variance's,
    against their sum of squares (count times variance + mean^2). Rounding
    reads ~1e-7 on every feature, a near-constant one too."""
    worst = 0.0
    for g, r in zip(got, ref, strict=True):
        count = r["/count"].double()
        worst = max(worst, float((g["/count"].double() - count).abs() / count))
        for key in (k for k in r if k.startswith("/mean/")):
            var = key.replace("/mean/", "/summed_variance/", 1)
            m_r, v_r = r[key].double(), r[var].double()
            square = (v_r / count + m_r ** 2).clamp_min(1e-30)
            gaps = torch.cat([(g[key].double() - m_r).abs() / square.sqrt(),
                              (g[var].double() - v_r).abs() / (count * square)])
            worst = max(worst, float(torch.nan_to_num(gaps, nan=float("inf")).max()))
    return worst


def compare_train(got: dict, ref: dict, params0: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers of a training cell: `got` (the program's record, or the
    control's) against the reference's (without its start: no env_gap)."""
    out = {}
    if "reset" in ref:
        step = max((max_gap(g, r) for g, r in zip(got["step"], ref["step"], strict=True)),
                   default=0.0)
        out["env_gap"] = max(max_gap(got["reset"], ref["reset"]), step)
    out["policy_gap"] = max(
        max(max_gap({"": g}, {"": r}) for g, r in zip(got["raw"], ref["raw"])),
        max(max_gap({"": g}, {"": r}) for g, r in zip(got["logp"], ref["logp"])))
    out["loss_gap"] = max(abs(g["total_loss"] - r["total_loss"]) / max(abs(r["total_loss"]), 1e-12)
                          for g, r in zip(got["losses"], ref["losses"], strict=True))
    out["grad_gap"] = worst_leaf(got["mu1"], ref["mu1"])
    out["change_gap"] = worst_leaf(*changes(got, ref, params0))
    if ref["normalizers"]:
        out["norm_gap"] = norm_gap(got["normalizers"], ref["normalizers"])
    return out


def changes(got: dict, ref: dict, params0: List[torch.Tensor]) -> tuple:
    """change_gap's leaves: the params' change over the followed steps on
    each side, and which leaves count (the reference's first moment at
    least a thousandth of the median leaf's)."""
    mu_norms = [float(torch.linalg.vector_norm(m.double())) for m in ref["mu1"]]
    med = statistics.median(mu_norms)
    return ([a - b for a, b in zip(got["params_end"], params0)],
            [a - b for a, b in zip(ref["params_end"], params0)],
            [n >= 1e-3 * med for n in mu_norms])


# ---------------------------------------------------------------------------
# eval cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvalRecord:
    """What the program produced in the followed episode."""

    g_eval: torch.Tensor  # the eval generator's state before the reset
    g_env: torch.Tensor  # the env generator's state before the reset
    reset: Dict[str, torch.Tensor]
    steps: List[dict]  # per sampled step: generators' states, carry before and after


def follow_eval(prog, sampled: List[int]) -> EvalRecord:
    """One whole episode through the window's own calls, the carries around
    the `sampled` steps copied as they come."""
    g_eval, g_env = prog.g_eval.get_state(), prog.env.generator.get_state()
    carry = prog.reset()
    reset = {k: v.clone() for k, v in _state_leaves(carry.state).items()}
    steps = []
    want = set(sampled)
    for i in range(prog.steps):
        if i in want:
            before = {"g_eval": prog.g_eval.get_state(), "g_env": prog.env.generator.get_state(),
                      "carry": as_ref(carry)}
        carry = prog.step(carry)
        if i in want:
            before["after"] = clone(carry)
            steps.append(before)
    prog.summary(carry)
    return EvalRecord(g_eval, g_env, reset, steps)


def as_ref(x):
    """A copy of a tree of the program's (State, Data, Contact, EvalCarry,
    dicts, tensors) in the reference's classes (an EvalCarry as a dict)."""
    from duckbench.ref.envs.types import State
    from duckbench.ref.ops.types import Contact, Data

    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: as_ref(v) for k, v in x.items()}
    fields = {f.name: as_ref(getattr(x, f.name)) for f in dataclasses.fields(x)}
    cls = {"State": State, "Data": Data, "Contact": Contact}.get(type(x).__name__)
    return fields if cls is None else cls(**fields)


def reference_eval(cfg: dict, sd: Dict[str, int], device, rec: EvalRecord,
                   control: bool = False, rounding: bool = False) -> dict:
    """The reference's reset and sampled steps (control: TF32 products;
    rounding: its sums reordered)."""
    from duckbench.ref.train import networks as nets

    p = cfg["ppo"]
    env, te = _ref_env(cfg, sd, device, p["num_eval_envs"], False)
    nw = _ref_networks(cfg, sd, device)
    stats = traffic.normalizer_stats(sd["normalizer"], cfg["obs_sizes"], device)
    normalizer = nets.rs_init(cfg["obs_sizes"], device).replace(
        mean={k: m for k, (m, _) in stats.items()}, std={k: s for k, (_, s) in stats.items()})
    g_eval = torch.Generator(device=device)
    out = {"steps": []}
    with _variant(nw, control, rounding), torch.no_grad():
        g_eval.set_state(rec.g_eval)
        env.generator.set_state(rec.g_env)
        out["reset"] = _state_leaves(te.reset(g_eval))
        for s in rec.steps:
            g_eval.set_state(s["g_eval"])
            env.generator.set_state(s["g_env"])
            c = s["carry"]
            obs = c["state"].obs
            if p["deterministic_eval"]:
                loc, _ = nets.dist_create(nw.policy_logits(normalizer, obs))
                action = torch.tanh(loc)
            else:
                noise = torch.randn((te.num_envs, cfg["action_size"]), generator=g_eval,
                                    device=device)
                raw, _ = _policy(nw, normalizer, obs, noise)
                action = torch.tanh(raw)
            state = te.step(c["state"], action)
            active = c["active"]
            out["steps"].append({
                "action": action, "reward": state.reward, "done": state.done,
                **{f"obs/{k}": v for k, v in state.obs.items()},
                "sums": c["sums"] + state.reward * active,
                "length": c["length"] + active, "active": active * (1.0 - state.done)})
    return out


def program_eval(rec: EvalRecord) -> dict:
    steps = []
    for s in rec.steps:
        a = s["after"]
        steps.append({"action": a["/state/info/last_act"], "reward": a["/state/reward"],
                      "done": a["/state/done"],
                      **{f"obs/{k.split('/')[-1]}": v for k, v in a.items()
                         if k.startswith("/state/obs/")},
                      "sums": a["/sums"], "length": a["/length"], "active": a["/active"]})
    return {"reset": rec.reset, "steps": steps}


def compare_eval(got: dict, ref: dict) -> Dict[str, float]:
    steps = max((max_gap(g, r) for g, r in zip(got["steps"], ref["steps"], strict=True)),
                default=0.0)
    return {"env_gap": max(max_gap(got["reset"], ref["reset"]), steps)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number without a limit fails)."""
    return all(k in limits and numbers[k] <= limits[k] for k in numbers)
