"""MatInvent: the RL loop (``matinvent_tpu/pipeline/mat_invent.py``), and the
port's entry point.

Per RL iteration: sample -> invalid filter -> ``OptFilter`` (optional) ->
cap at ``max_num`` -> save extxyz -> reward -> long-term memory and its
metrics -> diversity filter -> top-k -> experience replay -> fine-tune ->
run state and periodic checkpoint. The model is either family: the recipe's
model section names its suite under ``class`` (``MatterGenSuite`` when
absent, or ``DiffCSPSuite``). The fine-tune is the reward-weighted one of
the agent against the frozen prior, or with ``finetune_mode: ddpo`` PPO
policy gradients over the trajectory the sampler recorded this iteration
(``parallel/train.py``), which write the ``ddpo_ratio_mean``,
``ddpo_ratio_max`` and ``ddpo_clip_frac`` columns of ``metrics.csv``.
Sampling, the fine-tune and the device-side reward models (the property
predictors, SynScore) run on the model's device; everything else on the
host.

Options, as the JAX package has them: ``resume`` continues from the run
state under ``<save_dir>/state`` (saved every ``state_save_freq`` steps and
on the last), ``profile_dir`` writes a ``torch.profiler`` Chrome trace of
the first ``profile_steps`` iterations, and ``async_sampling`` samples
iteration t+1 with the pre-fine-tune-t weights while the host filters and
scores iteration t (not with ``ddpo``, which raises ``ValueError``: DDPO
needs the current iteration's trajectory). ``sample_cfg.mlip_opt`` relaxes
the valid samples (and rewrites their extxyz) before the filter, which then
reads the relaxer's energies; it and the filter's ``relaxer`` are named as
``{"class": "SoftSphereRelaxer", ...keyword arguments}`` (``RELAXERS``).
The model section's ``sample_cfg.target_compositions_dict`` samples in CSP
mode. Every calculator of the JAX package is ported (``CALCULATORS``): the
ALIGNN calculator runs on the model's device, the DFT bridge on the host.

    python -m matinvent_tpu_torch.pipeline.mat_invent --recipe rl_hhi_rich5 \\
        --rl-epoch 2 --out runs/hhi [--reward NAME] [--device cpu] \\
        [--set key.path=value ...]

runs a recipe of ``recipes.py`` on the card (or on the CPU with ``--device
cpu``), writing ``hparams.json``, ``metrics.csv``, ``samples/``, ``models/``
and ``state/`` under ``--out``. ``--set`` overrides one value of the recipe
(the value read as JSON, else as a string); ``--set pipeline.resume=true``
continues a run in the same ``--out``.
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from matinvent_tpu_torch.chem.relax import SoftSphereRelaxer
from matinvent_tpu_torch.models.diffcsp import DiffCSPDiffusion
from matinvent_tpu_torch.models.sample import batch_to_structures, collate_data_list
from matinvent_tpu_torch.models.suite.base import ModelSuite
from matinvent_tpu_torch.models.suite.diffcsp import DiffCSPSuite
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite
from matinvent_tpu_torch.ops import fused_edge
from matinvent_tpu_torch.parallel.train import DDPOFinetuneStep, MatterGenDDPOStep
from matinvent_tpu_torch.pipeline.base import ReinL
from matinvent_tpu_torch.pipeline.filters import build_filter, invalid_filter
from matinvent_tpu_torch.pipeline.logger import CSVLogger, Logger, setup_logging
from matinvent_tpu_torch.pipeline.save import save_structures
from matinvent_tpu_torch.recipes import RECIPES, REPO_PATHS, REWARDS
from matinvent_tpu_torch.rewards.calculators import Empirical, PropertyPredictor, SynScore
from matinvent_tpu_torch.rewards.calculators.alignn import ALIGNN
from matinvent_tpu_torch.rewards.calculators.dft import DFTCalc
from matinvent_tpu_torch.rewards.calculators.mlip import MLIPBridge
from matinvent_tpu_torch.rewards.reward import Reward
from matinvent_tpu_torch.utils.checkpoint import (
    load_run_state,
    save_run_state,
    set_generator_state,
)

ROOT = Path(__file__).resolve().parents[2]
# a calculator config's ``class`` (the last component of the JAX config's
# ``_target_``; Empirical when absent) -> (class, runs on the device?)
CALCULATORS = {
    "Empirical": (Empirical, False),
    "PropertyPredictor": (PropertyPredictor, True),
    "SynScore": (SynScore, True),
    "MLIPBridge": (MLIPBridge, True),
    "ALIGNN": (ALIGNN, True),
    "DFTCalc": (DFTCalc, False),
}
# a relaxer config's ``class`` (``sample_cfg.mlip_opt``, the filter's
# ``relaxer``); every relaxer runs on the model's device
RELAXERS = {"SoftSphereRelaxer": SoftSphereRelaxer}
# a model section's ``class`` (the last component of the JAX config's
# ``_target_``; MatterGenSuite when absent)
SUITES = {"MatterGenSuite": MatterGenSuite, "DiffCSPSuite": DiffCSPSuite}


class MatInvent(ReinL):
    def __init__(
        self,
        rl_epoch: int,
        model_suite: ModelSuite,
        reward: Reward,
        sample_cfg: dict,
        finetune_cfg: dict,
        topk_ratio: float,
        save_dir: str,
        save_freq: int = 50,
        logger: Logger | None = None,
        replay: bool = False,
        replay_args: Dict | None = None,
        div_filter: bool = False,
        df_args: Dict | None = None,
        seed: int = 0,
        resume: bool = False,
        profile_dir: str | None = None,
        profile_steps: int = 1,
        async_sampling: bool = False,
        state_save_freq: int = 1,
        finetune_mode: str = "reward_weighted",
        **kwargs,
    ) -> None:
        if finetune_mode not in ("reward_weighted", "ddpo"):
            raise ValueError(f"unknown finetune_mode {finetune_mode!r}")
        if finetune_mode == "ddpo" and async_sampling:
            raise ValueError("ddpo finetuning is incompatible with async_sampling")
        super().__init__(
            rl_epoch=rl_epoch, model_suite=model_suite, reward=reward,
            sample_cfg=sample_cfg, finetune_cfg=finetune_cfg, save_dir=save_dir,
            save_freq=save_freq, logger=logger, replay=replay, replay_args=replay_args,
            seed=seed, **kwargs,
        )
        self.mlip_opt = build_relaxer(self.sample_cfg.get("mlip_opt"), model_suite.device)
        filter_cfg = self.sample_cfg.get("filter")
        if isinstance(filter_cfg, dict) and filter_cfg.get("relaxer") is not None:
            filter_cfg = {**filter_cfg,
                          "relaxer": build_relaxer(filter_cfg["relaxer"], model_suite.device)}
        self.filter = build_filter(
            filter_cfg, device=model_suite.device,
            syn_root_dir=os.path.join(save_dir, "rewards", "syn_filter"),
        )
        if not 0.0 < topk_ratio <= 1.0:
            raise ValueError(f"topk_ratio must be in (0, 1], got {topk_ratio}")
        self.topk_ratio = topk_ratio
        self.div_filter = div_filter
        self.df_args = df_args or {}
        self.load_model()
        self.finetuner = self.model_suite.get_finetuner(**self.finetune_cfg)
        # the fine-tune's draws: a stream of their own, apart from the
        # sampler's (seeded with ``seed``)
        self.generator = torch.Generator(device=self.agent.device).manual_seed(seed + 1)
        # 'ddpo' trains on this iteration's recorded trajectory only (replay
        # entries carry none)
        self.finetune_mode = finetune_mode
        self.ddpo = self._ddpo_step() if finetune_mode == "ddpo" else None

        # iteration t+1's sampling runs in a worker thread, launched before
        # the host filters and scores iteration t and joined before the
        # fine-tune writes the weights; every launch goes through the thread
        self.async_sampling = async_sampling
        self._sampling_pool: ThreadPoolExecutor | None = None
        self._pending: Future | None = None
        if async_sampling:
            if self.agent.device.type == "cuda" and getattr(self.sampler, "fused_edge", False):
                fused_edge._launch_fn()  # build and load the kernel before the thread
            self._sampling_pool = ThreadPoolExecutor(1, thread_name_prefix="sampling")

        self.profile_dir = profile_dir
        self.profile_steps = profile_steps

        self.state_save_freq = max(int(state_save_freq), 1)
        self.state_dir = os.path.join(save_dir, "state")
        self._start_step = 0
        if resume:
            self._try_resume()

    def _ddpo_step(self) -> DDPOFinetuneStep:
        self.sampler.record_trajectories = True
        ft = self.finetune_cfg
        # the recorded trajectory always has the model's full T steps
        t_traj = int(self.agent.config.timesteps)
        accum = int(ft.get("accum_steps", 50))
        common = dict(
            lr=float(ft.get("lr", 1e-5)),
            clip_eps=float(ft.get("clip_eps", 0.2)),
            chunk=accum if t_traj % accum == 0 else t_traj,
            adv_norm=bool(ft.get("adv_norm", True)),
            epochs=int(ft.get("ddpo_epochs", 1)),
            max_grad_norm=float(ft.get("max_grad_norm", 1.0)),
        )
        if isinstance(self.agent, DiffCSPDiffusion):
            return DDPOFinetuneStep(step_lr=self.sampler.resolved_step_lr(), **common)
        return MatterGenDDPOStep(**common)

    def _try_resume(self):
        loaded = load_run_state(self.state_dir)
        if loaded is None:
            logging.info("resume requested but no run state found; starting fresh")
            return
        sd, host, tables = loaded
        self.agent.load_state_dict(sd, strict=True)
        self._start_step = host["step"] + 1
        self.cost = host["cost"]
        self.sampler._rng.bit_generator.state = host["sampler"]["rng"]
        if host["sampler"]["generator"] is not None:
            set_generator_state(self.sampler._generator_for(self.agent.device),
                                host["sampler"]["generator"])
        set_generator_state(self.generator, host["finetune_generator"])
        if self.replay is not None and tables["replay"] is not None:
            self.replay.buffer = tables["replay"]
            self.replay._rng.bit_generator.state = host["replay_rng"]
        self.ltm.memory = tables["ltm"]
        self.ltm.unique_comps = list(dict.fromkeys(row["comp"] for row in self.ltm.memory))
        logging.info(f"resumed run state at step {self._start_step}")

    def _save_state(self):
        save_run_state(self.state_dir, self.agent, self.step, self.cost, self.sampler,
                       self.generator, self.ltm, self.replay)

    def load_model(self):
        """The agent, trained, and the prior, frozen: two loads of one
        checkpoint."""
        self.agent = self.model_suite.load_model()
        self.prior = self.model_suite.load_model().requires_grad_(False)

    def _launch_sampling(self):
        return self.sampler.launch(
            self.agent,
            batch_size=self.sample_cfg.get("batch_size"),
            num_batches=self.sample_cfg.get("num_batches"),
        )

    def sample_step(self):
        if self.async_sampling:
            current = self._pending or self._sampling_pool.submit(self._launch_sampling)
            # queue the next iteration's sampling before any host work, but
            # for the last iteration, whose batch would go unused
            self._pending = (
                self._sampling_pool.submit(self._launch_sampling)
                if self.step + 1 < self.rl_epoch else None
            )
            sample_data, sample_struc = batch_to_structures(current.result())
        else:
            sample_data, sample_struc = self.sampler.generate(
                self.agent,
                batch_size=self.sample_cfg.get("batch_size"),
                num_batches=self.sample_cfg.get("num_batches"),
            )
        for i, d in enumerate(sample_data):
            d["batch_index"] = i
        if self.sample_cfg.get("invalid_filter", True):
            sample_data, sample_struc = invalid_filter(sample_data, sample_struc)
        logging.info(f"Number of valid samples: {len(sample_struc)}")
        valid_xyz_path = save_structures(
            sample_struc, self.sample_dir, f"step_{self.step:0>4d}_valid.extxyz"
        )
        energies = None
        if self.mlip_opt is not None:
            sample_struc, energies = self.mlip_opt(sample_struc, valid_xyz_path)
        metrics = {}
        if self.filter is not None:
            sample_data, sample_struc, metrics = self.filter(sample_data, sample_struc, energies)
            logging.info(f"Number of filtered samples: {len(sample_struc)}")
        if metrics:
            logging.info(", ".join(f"{k}: {v:.6f}" for k, v in metrics.items()))
        max_num = self.sample_cfg.get("max_num")
        if max_num and len(sample_struc) > max_num:
            sample_data = sample_data[:max_num]
            sample_struc = sample_struc[:max_num]
        eval_xyz_path = save_structures(
            sample_struc, self.sample_dir, f"step_{self.step:0>4d}_eval.extxyz"
        )
        return sample_data, sample_struc, eval_xyz_path, metrics

    def ft_step(self, data_list: List[dict], rewards: np.ndarray):
        if len(data_list) == 0:
            logging.warning("ft_step skipped: no finetune data this iteration")
            return
        device = self.agent.device
        batch = collate_data_list(data_list, max_atoms=self.sampler.max_atoms).to(device)
        props = getattr(self.sampler, "properties_to_condition_on", None)
        conditions = (
            {k: torch.full((len(data_list),), float(v), device=device) for k, v in props.items()}
            if props else None
        )
        # as in the JAX package, the raw reward weighs the loss: no baseline
        logging.info(f"Fine-tune batch: {len(data_list)} crystals")
        epoch_metrics = self.finetuner.run(
            self.agent, self.prior, batch,
            torch.as_tensor(rewards, dtype=torch.float32, device=device),
            generator=self.generator, conditions=conditions,
        )
        for e, m in enumerate(epoch_metrics):
            logging.info(f"Epoch {e}: " + ", ".join(f"{k}: {v:.4f}" for k, v in m.items()))

    def ft_step_ddpo(self, sample_list: List[dict], rewards: np.ndarray):
        """DDPO over the rows of this iteration's recorded trajectory that
        were scored (``batch_index``); returns the ``ddpo_*`` metrics."""
        traj = self.sampler.last_trajectory
        if traj is None or len(sample_list) == 0:
            logging.warning("ddpo ft skipped: no trajectory or no scored samples")
            return {}
        device = self.agent.device
        num_atoms = self.sampler.last_num_atoms
        rows = torch.as_tensor([d["batch_index"] for d in sample_list], device=device)
        mask = torch.arange(self.sampler.max_atoms, device=device)[None, :] < num_atoms[:, None]
        replay = {}
        if isinstance(self.ddpo, MatterGenDDPOStep):
            # replay under the behaviour policy's conditioning, guidance and
            # fixed types (whole-batch tensors: the replay takes the rows)
            replay = dict(conditions=self.sampler.last_conditions,
                          guidance=float(self.sampler.last_guidance),
                          fixed_types=self.sampler.last_fixed_types)
        logging.info(f"DDPO batch: {len(sample_list)} of {num_atoms.shape[0]} crystals")
        loss = self.ddpo.run(
            self.agent, traj, num_atoms, mask,
            torch.as_tensor(rewards, dtype=torch.float32, device=device), rows=rows, **replay,
        )
        stats = self.ddpo.last_stats
        logging.info(f"DDPO loss: {loss:.5f}" + "".join(f" {k}={v:.4f}" for k, v in stats.items()))
        for e, st in enumerate(self.ddpo.epoch_stats):
            logging.info(f"DDPO epoch {e}: " + ", ".join(f"{k}={v!r}" for k, v in st.items()))
        return {f"ddpo_{k}": v for k, v in stats.items()}

    def rl_step(self):
        logging.info(f"*****   LOOP {self.step} START   *****")
        start_time = time.time()
        with self.timer.phase("sample"):
            sample_list, sample_struc, xyz_path, sample_metrics = self.sample_step()
        with self.timer.phase("score"):
            sample_list, sample_struc, rewards, prop_dict = self.reward_step(
                sample_list, sample_struc, xyz_path, f"step_{self.step:0>4d}"
            )

        log_dict = {f"{k} mean": v.mean() for k, v in prop_dict.items() if len(v)}
        log_dict.update({f"{k} std": v.std() for k, v in prop_dict.items() if len(v)})
        if len(rewards):
            log_dict.update({"reward mean": rewards.mean(), "reward std": rewards.std()})
        log_dict.update(sample_metrics)

        if len(sample_struc) == 0:
            logging.warning("no valid scored samples this iteration; skipping finetune")
            log_dict.update(crystal_num=len(self.ltm), cost=self.cost)
            if self.logger is not None:
                self.logger.log(log_dict, step=self.step)
            return

        self.ltm.extend(sample_struc, rewards, self.step)
        metrics = self.ltm.calc_metrics(self.reward.threshold)
        self.ltm.save(os.path.join(self.sample_dir, "long_term_memory.csv"))
        log_dict.update(
            crystal_num=len(self.ltm),
            unique_comps=len(self.ltm.unique_comps),
            burden=metrics[0],
            div_ratio=metrics[1],
            cost=self.cost,
        )

        penalty_strucs: list = []
        if self.div_filter:
            rewards, penalty_idx, tol_n, buff_n = self.ltm.div_filter(
                sample_struc, rewards, **self.df_args
            )
            penalty_strucs = [sample_struc[p] for p in penalty_idx]
            logging.info(f"Diversity filter: tol_n={tol_n}, buff_n={buff_n}")

        # top-k selection, ties ordered as numpy's default sort orders them
        sort_idx = np.argsort(rewards)[::-1]
        topk_idx = sort_idx[: int(self.finetune_cfg["batch_size"] * self.topk_ratio)]
        sample_topk = [sample_list[i] for i in topk_idx]
        strucs_topk = [sample_struc[i] for i in topk_idx]
        reward_topk = rewards[topk_idx]

        if self.replay is not None:
            if self.div_filter and len(penalty_strucs) > 0:
                self.replay.memory_purge(penalty_strucs)
            data_replay, reward_replay = self.replay.sample()
            ft_data = sample_topk + data_replay
            ft_reward = np.concatenate((reward_topk, reward_replay))
            self.replay.extend(sample_topk, strucs_topk, reward_topk)
            logging.info(f"replay buffer size={len(self.replay)}")
        else:
            ft_data, ft_reward = sample_topk, reward_topk

        with self.timer.phase("finetune"):
            if self._pending is not None:
                # the pending launch samples with these weights: wait for it
                # (re-raising its exception) before the fine-tune writes them
                self._pending.result()
            if self.finetune_mode == "ddpo":
                # policy gradients over this iteration's recorded trajectory
                log_dict.update(self.ft_step_ddpo(sample_list, rewards))
            else:
                self.ft_step(ft_data, ft_reward)

        log_dict.update(self.timer.pop())
        if self.logger is not None:
            self.logger.log(log_dict, step=self.step)
        logging.info(f"*****   LOOP {self.step} FINISH   *****")
        logging.info(f"Total time taken: {(time.time() - start_time) / 60:.2f} min.")

    def run_rl(self):
        logging.info("*****   RL START   *****")
        start_time = time.time()
        profiler = None
        try:
            for step in range(self._start_step, self.rl_epoch):
                self.step = step
                if self.profile_dir and step == self._start_step:
                    profiler = self._start_profiler()
                self.rl_step()
                if profiler is not None and step + 1 >= self._start_step + self.profile_steps:
                    self._stop_profiler(profiler)
                    profiler = None
                # the run state every state_save_freq steps and on the last
                if (step + 1) % self.state_save_freq == 0 or step + 1 == self.rl_epoch:
                    self._save_state()
                if (step + 1) % self.save_freq == 0:
                    self.model_suite.save_model(
                        self.agent, os.path.join(self.models_dir, f"loop_{step:0>4d}")
                    )
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            if self._sampling_pool is not None:
                self._sampling_pool.shutdown(wait=True, cancel_futures=True)
        self.model_suite.save_model(self.agent, os.path.join(self.models_dir, "final"))
        logging.info("*****   RL END   *****")
        logging.info(f"Total time taken: {int(time.time() - start_time)} s.")

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.agent.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_step{self._start_step:0>4d}.json")
        profiler.export_chrome_trace(path)
        logging.info(f"profiler trace written to {path}")


def _set(cfg: dict, dotted: str, value) -> None:
    *parents, last = dotted.split(".")
    node = cfg
    for p in parents:
        node = node.setdefault(p, {})
    node[last] = value


def _parse_value(text: str):
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def build_relaxer(cfg, device=None):
    """The relaxer of a config ``{"class": name, ...keyword arguments}`` on
    ``device``; ``None`` for none. A relaxer object (the config entry
    point's ``instantiate`` builds one) is returned as it is."""
    if not cfg:
        return None
    if callable(cfg):
        return cfg
    if not isinstance(cfg, dict) or cfg.get("class") not in RELAXERS:
        raise ValueError(f"a relaxer config names one of {sorted(RELAXERS)} under 'class', "
                         f"got {cfg!r}")
    kwargs = dict(cfg)
    return RELAXERS[kwargs.pop("class")](**kwargs, device=device)


def build_calculator(cfg: dict, out_dir: Path, device=None):
    """The calculator of one ``prop_cfg`` entry, its ``root_dir`` under
    ``out_dir``; those that run on the device get ``device``."""
    kwargs = dict(cfg)
    name = kwargs.pop("class", "Empirical")
    if name not in CALCULATORS:
        raise NotImplementedError(f"the calculator class {name!r} is not ported")
    cls, on_device = CALCULATORS[name]
    kwargs["root_dir"] = str(out_dir / kwargs["root_dir"])
    if on_device:
        kwargs["device"] = device
    return cls(**kwargs)


def build(cfg: dict, out: str, device: str | None = None) -> MatInvent:
    """The pipeline of a resolved recipe, writing under ``out``."""
    out_dir = Path(out)
    model_cfg = dict(cfg["model"])
    name = model_cfg.pop("class", "MatterGenSuite")
    if name not in SUITES:
        raise NotImplementedError(f"the model suite {name!r} is not ported")
    suite = SUITES[name](**model_cfg, device=device)
    r = cfg["reward"]
    props = [
        {**p, "calculator": build_calculator(p["calculator"], out_dir, suite.device)}
        for p in r["prop_cfg"]
    ]
    reward = Reward(
        root_dir=str(out_dir / r["root_dir"]), prop_cfg=props,
        reward_threshold=r["reward_threshold"],
        **{k: v for k, v in r.items() if k not in ("root_dir", "prop_cfg", "reward_threshold")},
    )
    logger = CSVLogger(save_dir=str(out_dir / cfg["logger"]["save_dir"]))
    pipe = dict(cfg["pipeline"])
    pipe["save_dir"] = str(out_dir / pipe.get("save_dir", "./"))
    return MatInvent(model_suite=suite, reward=reward, logger=logger, **pipe)


def resolve(
    recipe: str, rl_epoch: int | None = None, overrides=(), reward: str | None = None
) -> dict:
    """A recipe with the reward section ``reward`` of ``REWARDS`` (if given),
    ``--set`` overrides and ``rl_epoch`` applied, and its repository paths
    made absolute."""
    cfg = copy.deepcopy(RECIPES[recipe])
    if reward is not None:
        cfg["reward"] = copy.deepcopy(REWARDS[reward])
    for item in overrides:
        key, _, text = item.partition("=")
        _set(cfg, key, _parse_value(text))
    if rl_epoch is not None:
        cfg["rl_epoch"] = cfg["pipeline"]["rl_epoch"] = rl_epoch
    for path in REPO_PATHS:
        node = cfg
        for p in path[:-1]:
            node = node.get(p) if isinstance(node, dict) else None
        if isinstance(node, dict) and node.get(path[-1]) is not None:
            node[path[-1]] = str(ROOT / node[path[-1]])
    return cfg


def main(argv: list[str] | None = None) -> MatInvent:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", default="rl_hhi_rich5", choices=sorted(RECIPES))
    parser.add_argument("--rl-epoch", type=int, default=None)
    parser.add_argument("--reward", default=None, choices=sorted(REWARDS),
                        help="a reward section of recipes.REWARDS instead of the recipe's")
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU")
    parser.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE")
    args = parser.parse_args(argv)
    setup_logging()
    cfg = resolve(args.recipe, args.rl_epoch, args.set, args.reward)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "hparams.json"), "w") as fh:
        json.dump(cfg, fh, indent=2)
    pipeline = build(cfg, args.out, args.device)
    pipeline.run_rl()
    return pipeline


if __name__ == "__main__":
    main(sys.argv[1:])
