"""Run recipes of the port's RL entry point, as Python dicts.

``rl_hhi_rich5`` holds the values of the archived JAX run's resolved config
(``experiments/results/rl_hhi_rich5/hparams.yaml``) without its Hydra
``_target_`` keys: the h256/L6 start checkpoint, 64 samples from the
``corpus_r5`` histogram per iteration, the invalid filter, the HHI reward,
the diversity filter, replay, and the reward-weighted fine-tune. Paths of
the repository are relative to its root; the other paths are relative to
the run's output directory.
"""
from __future__ import annotations

_SAMPLE = {"num_batches": 1, "max_num": 16, "filter": None}
_FINETUNE = {"batch_size": 16, "accum_steps": 25, "epochs": 3, "sigma": 0.1}

RECIPES = {
    "rl_hhi_rich5": {
        "expname": "rl_hhi_rich5",
        "seed": 0,
        "rl_epoch": 60,
        "sample_cfg": dict(_SAMPLE),
        "eval_size": 16,
        "pipeline": {
            "rl_epoch": 60,
            "seed": 0,
            "save_dir": "./",
            "save_freq": 60,
            "sample_cfg": dict(_SAMPLE),
            "topk_ratio": 0.5,
            "replay": True,
            "replay_args": {"buffer_size": 100, "sample_size": 10, "reward_cutoff": 0.1},
            "div_filter": True,
            "df_args": {"tol": 3, "buff": 6},
            "finetune_cfg": dict(_FINETUNE),
        },
        "model": {
            "model_name": "mattergen_base",
            "seed": 0,
            "model_cfg": {"hidden_dim": 256, "num_layers": 6, "time_dim": 256, "timesteps": 1000},
            "sample_cfg": {
                "batch_size": 64,
                "num_batches": 1,
                "num_atoms_distribution": "corpus_r5",
                "max_atoms": 20,
                "diffusion_guidance_factor": 0.0,
                "num_atoms_distribution_file": "experiments/data/corpus_r5_num_atoms.json",
            },
            "finetune_cfg": {"batch_size": 16, "timesteps": 1000, "lr": 0.0001},
            "model_path": "experiments/results/pretrained_geneval_r5_r5_long_s120000_ema",
            "config_overrides": {"sample_clip": 30.0},
        },
        "reward": {
            "root_dir": "rewards",
            "prop_cfg": [
                {
                    "name": "hhi",
                    "calculator": {"root_dir": "rewards/hhi", "task": "hhi"},
                    "target": "descending",
                    "minv": 750,
                    "maxv": 3250,
                }
            ],
            "reward_threshold": 0.8,
        },
        "logger": {"save_dir": "./"},
    },
}

# keys of the model section that name files of the repository
REPO_PATHS = (("model", "model_path"), ("model", "sample_cfg", "num_atoms_distribution_file"))
