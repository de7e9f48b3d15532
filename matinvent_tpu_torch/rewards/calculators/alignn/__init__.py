"""Published ALIGNN checkpoints as a reward: jarvis-semantics graphs on the
host, the forward in PyTorch on the card over the torch state dict, the HF
folder and figshare zip loaders, and the calculator (``calc.py``)."""
from matinvent_tpu_torch.rewards.calculators.alignn.calc import ALIGNN, ALIGNNModel
from matinvent_tpu_torch.rewards.calculators.alignn.graphs import ALIGNNBatch, build_batch
from matinvent_tpu_torch.rewards.calculators.alignn.load import load_alignn_checkpoint
from matinvent_tpu_torch.rewards.calculators.alignn.model import (
    ALIGNNSpec,
    alignn_forward,
    run_batch,
)

__all__ = [
    "ALIGNN", "ALIGNNModel", "ALIGNNBatch", "build_batch",
    "load_alignn_checkpoint", "ALIGNNSpec", "alignn_forward", "run_batch",
]
