"""The MLIP workflow bridge (``matinvent_tpu/rewards/calculators/mlip/``):
``MLIPBridge`` runs the bulk-modulus (``elastic.py``) or heat-capacity
(``phonon.py``) worker script in a subprocess."""
from matinvent_tpu_torch.rewards.calculators.mlip.calc import (
    ELASTIC_PATH,
    PHONON_PATH,
    MLIPBridge,
)

__all__ = ["MLIPBridge", "ELASTIC_PATH", "PHONON_PATH"]
