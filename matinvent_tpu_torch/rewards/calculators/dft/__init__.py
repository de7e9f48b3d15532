"""The DFT reward: remote scheduler jobs, one per structure (host code)."""
import os

DFT_CONFIG_PATH = os.path.join(os.path.dirname(__file__), "config.yaml")

from matinvent_tpu_torch.rewards.calculators.dft.calc import DFTCalc  # noqa: E402
from matinvent_tpu_torch.rewards.calculators.dft.job import RemoteQueueJob  # noqa: E402

__all__ = ["DFTCalc", "RemoteQueueJob", "DFT_CONFIG_PATH"]
