"""Baseline: sampling and scoring with no fine-tune
(``matinvent_tpu/pipeline/baseline.py``), the control that measures the
model as it was loaded.

Per iteration: sample -> invalid filter -> ``step_XXXX_valid.extxyz`` ->
reward -> long-term memory (``long_term_memory.csv``) -> one metrics row.
No weights are saved: they never change.
"""
from __future__ import annotations

import logging
import os

from matinvent_tpu_torch.pipeline.base import ReinL
from matinvent_tpu_torch.pipeline.filters import invalid_filter
from matinvent_tpu_torch.pipeline.logger import Logger
from matinvent_tpu_torch.pipeline.save import save_structures
from matinvent_tpu_torch.rewards.reward import Reward


class Baseline(ReinL):
    def __init__(
        self,
        rl_epoch: int,
        model_suite,
        reward: Reward,
        sample_cfg: dict,
        finetune_cfg: dict,
        save_dir: str,
        save_freq: int = 100,
        logger: Logger | None = None,
        seed: int = 0,
        **kwargs,
    ) -> None:
        super().__init__(
            rl_epoch=rl_epoch, model_suite=model_suite, reward=reward,
            sample_cfg=sample_cfg, finetune_cfg=finetune_cfg, save_dir=save_dir,
            save_freq=save_freq, logger=logger, seed=seed, **kwargs,
        )
        self.load_model()

    def load_model(self):
        self.agent = self.model_suite.load_model().requires_grad_(False)

    def sample_step(self):
        sample_data, sample_struc = self.sampler.generate(
            self.agent,
            batch_size=self.sample_cfg.get("batch_size"),
            num_batches=self.sample_cfg.get("num_batches"),
        )
        sample_data, sample_struc = invalid_filter(sample_data, sample_struc)
        xyz_path = save_structures(
            sample_struc, self.sample_dir, f"step_{self.step:0>4d}_valid.extxyz"
        )
        return sample_data, sample_struc, xyz_path, {}

    def rl_step(self):
        logging.info(f"*****   LOOP {self.step} START   *****")
        sample_list, sample_struc, xyz_path, _ = self.sample_step()
        sample_list, sample_struc, rewards, prop_dict = self.reward_step(
            sample_list, sample_struc, xyz_path, f"step_{self.step:0>4d}"
        )
        log_dict = {f"{k} mean": v.mean() for k, v in prop_dict.items() if len(v)}
        log_dict.update({f"{k} std": v.std() for k, v in prop_dict.items() if len(v)})
        if len(rewards):
            log_dict.update({"reward mean": rewards.mean(), "reward std": rewards.std()})

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
        if self.logger is not None:
            self.logger.log(log_dict, step=self.step)
        logging.info(f"*****   LOOP {self.step} FINISH   *****")

    def run_rl(self):
        logging.info("*****   BASELINE START   *****")
        for step in range(self.rl_epoch):
            self.step = step
            self.rl_step()
        logging.info("*****   BASELINE END   *****")
