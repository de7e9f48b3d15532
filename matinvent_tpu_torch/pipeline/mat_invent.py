"""MatInvent: the RL loop (``matinvent_tpu/pipeline/mat_invent.py``), and the
port's entry point.

Per RL iteration: sample -> invalid filter -> cap at ``max_num`` -> save
extxyz -> reward -> long-term memory and its metrics -> diversity filter ->
top-k -> experience replay -> reward-weighted fine-tune of the agent against
the frozen prior -> periodic checkpoint. Sampling and the fine-tune run on
the model's device; everything else on the host.

Only the reward-weighted fine-tune is ported: DDPO, asynchronous sampling,
resume and run state, the profiler, MLIP relaxation and ``OptFilter`` raise
when asked for.

    python -m matinvent_tpu_torch.pipeline.mat_invent --recipe rl_hhi_rich5 \\
        --rl-epoch 2 --out runs/hhi [--device cpu] [--set key.path=value ...]

runs a recipe of ``recipes.py`` on the card (or on the CPU with ``--device
cpu``), writing ``hparams.json``, ``metrics.csv``, ``samples/`` and
``models/`` under ``--out``. ``--set`` overrides one value of the recipe
(the value read as JSON, else as a string).
"""
from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from matinvent_tpu_torch.models.sample import collate_data_list
from matinvent_tpu_torch.models.suite.mattergen import MatterGenSuite
from matinvent_tpu_torch.pipeline.base import ReinL
from matinvent_tpu_torch.pipeline.filters import invalid_filter
from matinvent_tpu_torch.pipeline.logger import CSVLogger, Logger, setup_logging
from matinvent_tpu_torch.pipeline.save import save_structures
from matinvent_tpu_torch.recipes import RECIPES, REPO_PATHS
from matinvent_tpu_torch.rewards.calculators.empirical import Empirical
from matinvent_tpu_torch.rewards.reward import Reward

ROOT = Path(__file__).resolve().parents[2]


class MatInvent(ReinL):
    def __init__(
        self,
        rl_epoch: int,
        model_suite: MatterGenSuite,
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
        async_sampling: bool = False,
        state_save_freq: int | None = None,
        finetune_mode: str = "reward_weighted",
    ) -> None:
        not_ported = dict(
            resume=resume, profile_dir=profile_dir, async_sampling=async_sampling,
            state_save_freq=state_save_freq,
            ddpo=finetune_mode != "reward_weighted",
        )
        asked = [k for k, v in not_ported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported: {asked}")
        super().__init__(
            rl_epoch=rl_epoch, model_suite=model_suite, reward=reward,
            sample_cfg=sample_cfg, finetune_cfg=finetune_cfg, save_dir=save_dir,
            save_freq=save_freq, logger=logger, replay=replay, replay_args=replay_args,
            seed=seed,
        )
        for key in ("filter", "mlip_opt"):
            if self.sample_cfg.get(key):
                raise NotImplementedError(f"sample_cfg {key!r} is not ported")
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

    def load_model(self):
        """The agent, trained, and the prior, frozen: two loads of one
        checkpoint."""
        self.agent = self.model_suite.load_model()
        self.prior = self.model_suite.load_model().requires_grad_(False)

    def sample_step(self):
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
        save_structures(sample_struc, self.sample_dir, f"step_{self.step:0>4d}_valid.extxyz")
        max_num = self.sample_cfg.get("max_num")
        if max_num and len(sample_struc) > max_num:
            sample_data = sample_data[:max_num]
            sample_struc = sample_struc[:max_num]
        eval_xyz_path = save_structures(
            sample_struc, self.sample_dir, f"step_{self.step:0>4d}_eval.extxyz"
        )
        return sample_data, sample_struc, eval_xyz_path, {}

    def ft_step(self, data_list: List[dict], rewards: np.ndarray):
        if len(data_list) == 0:
            logging.warning("ft_step skipped: no finetune data this iteration")
            return
        device = self.agent.device
        batch = collate_data_list(data_list, max_atoms=self.sampler.max_atoms).to(device)
        props = self.sampler.properties_to_condition_on
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
            self.ft_step(ft_data, ft_reward)

        log_dict.update(self.timer.pop())
        if self.logger is not None:
            self.logger.log(log_dict, step=self.step)
        logging.info(f"*****   LOOP {self.step} FINISH   *****")
        logging.info(f"Total time taken: {(time.time() - start_time) / 60:.2f} min.")

    def run_rl(self):
        for step in range(self.rl_epoch):
            self.step = step
            self.rl_step()
            if (step + 1) % self.save_freq == 0:
                self.model_suite.save_model(
                    self.agent, os.path.join(self.models_dir, f"loop_{step:0>4d}")
                )
        self.model_suite.save_model(self.agent, os.path.join(self.models_dir, "final"))


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


def build(cfg: dict, out: str, device: str | None = None) -> MatInvent:
    """The pipeline of a resolved recipe, writing under ``out``."""
    out_dir = Path(out)
    model_cfg = dict(cfg["model"])
    suite = MatterGenSuite(**model_cfg, device=device)
    r = cfg["reward"]
    props = [
        {**p, "calculator": Empirical(**{**p["calculator"],
                                         "root_dir": str(out_dir / p["calculator"]["root_dir"])})}
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


def resolve(recipe: str, rl_epoch: int | None = None, overrides=()) -> dict:
    """A recipe with ``--set`` overrides and ``rl_epoch`` applied, and its
    repository paths made absolute."""
    cfg = copy.deepcopy(RECIPES[recipe])
    for item in overrides:
        key, _, text = item.partition("=")
        _set(cfg, key, _parse_value(text))
    if rl_epoch is not None:
        cfg["rl_epoch"] = cfg["pipeline"]["rl_epoch"] = rl_epoch
    for path in REPO_PATHS:
        node = cfg
        for p in path[:-1]:
            node = node[p]
        if node.get(path[-1]) is not None:
            node[path[-1]] = str(ROOT / node[path[-1]])
    return cfg


def main(argv: list[str] | None = None) -> MatInvent:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", default="rl_hhi_rich5", choices=sorted(RECIPES))
    parser.add_argument("--rl-epoch", type=int, default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default=None, help="cpu to run on the CPU")
    parser.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE")
    args = parser.parse_args(argv)
    setup_logging()
    cfg = resolve(args.recipe, args.rl_epoch, args.set)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "hparams.json"), "w") as fh:
        json.dump(cfg, fh, indent=2)
    pipeline = build(cfg, args.out, args.device)
    pipeline.run_rl()
    return pipeline


if __name__ == "__main__":
    main(sys.argv[1:])
