"""Property calculators of the port: the empirical ones (host), the GNN
property predictors and the SynScore ensemble (on the calculator's device);
the MLIP bridge is ``rewards.calculators.mlip``, the published-ALIGNN
calculator ``rewards.calculators.alignn`` (on the device) and the remote DFT
bridge ``rewards.calculators.dft`` (host)."""
from matinvent_tpu_torch.rewards.calculators.base import Calculator
from matinvent_tpu_torch.rewards.calculators.empirical import Empirical
from matinvent_tpu_torch.rewards.calculators.predictor import PropertyPredictor
from matinvent_tpu_torch.rewards.calculators.syn_score import SynScore

__all__ = ["Calculator", "Empirical", "PropertyPredictor", "SynScore"]
