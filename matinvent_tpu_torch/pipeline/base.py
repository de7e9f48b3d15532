"""RL pipeline base class (``matinvent_tpu/pipeline/base.py``).

Holds the model suite, the reward, the long-term memory, the replay buffer
and the save directories, merges the suite's sample and fine-tune configs
with the pipeline's, and scores samples in ``reward_step``.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.memory.ltm import LongTimeMem
from matinvent_tpu_torch.memory.replay_buffer import ReplayBuffer
from matinvent_tpu_torch.pipeline.logger import Logger, PhaseTimer
from matinvent_tpu_torch.rewards.reward import Reward


class ReinL:
    def __init__(
        self,
        rl_epoch: int,
        model_suite,
        reward: Reward,
        sample_cfg: dict,
        finetune_cfg: dict,
        save_dir: str,
        save_freq: int,
        logger: Logger | None = None,
        replay: bool = False,
        replay_args: Dict | None = None,
        seed: int = 0,
        **kwargs,
    ) -> None:
        self.rl_epoch = rl_epoch
        self.model_suite = model_suite
        self.reward = reward
        self.save_dir = save_dir
        self.save_freq = save_freq
        self.logger = logger
        self.seed = seed
        # keys of a pipeline config that the loop does not read, kept as JAX keeps them
        self.cfg = dict(kwargs)
        self.step = 0
        self.cost = 0
        self.timer = PhaseTimer()
        self.sample_cfg = {**model_suite.sample_cfg, **(sample_cfg or {})}
        self.finetune_cfg = {**model_suite.finetune_cfg, **(finetune_cfg or {})}
        self.sampler = model_suite.get_sampler()
        self.ltm = LongTimeMem()
        self.models_dir = os.path.join(save_dir, "models")
        self.sample_dir = os.path.join(save_dir, "samples")
        os.makedirs(self.models_dir, exist_ok=True)
        os.makedirs(self.sample_dir, exist_ok=True)
        self.replay = ReplayBuffer(**(replay_args or {})) if replay else None

    def reward_step(
        self, sample_data: list, sample_struc: List[Structure], xyz_path: str, label: str = "tmp"
    ):
        """Score the samples; drop those whose properties failed."""
        rewards, prop_dict, failed_mask = self.reward.scoring((sample_struc, xyz_path), label)
        self.cost += len(sample_struc)
        success_rewards = rewards[~failed_mask].astype(float)
        success_prop_dict = {k: v[~failed_mask] for k, v in prop_dict.items()}
        success_data = [d for d, f in zip(sample_data, failed_mask) if not f]
        success_struc = [s for s, f in zip(sample_struc, failed_mask) if not f]
        logging.info(f"Evaluation costs to date: {self.cost}")
        logging.info(f"Number of samples that successfully obtained rewards: {len(success_struc)}")
        if len(success_rewards):
            logging.info(f"reward mean={success_rewards.mean():.4f} std={success_rewards.std():.4f}")
        return success_data, success_struc, success_rewards, success_prop_dict
