"""Standard scaler of lattice and property values (``matinvent_tpu/utils/scaler.py``)."""
from __future__ import annotations

import numpy as np
import torch


class StandardScaler:
    def __init__(self, means=None, stds=None):
        self.means = None if means is None else torch.as_tensor(np.asarray(means))
        self.stds = None if stds is None else torch.as_tensor(np.asarray(stds))

    def fit(self, x) -> "StandardScaler":
        x = torch.as_tensor(np.asarray(x))
        self.means = torch.mean(x, dim=0)
        # the population std (ddof 0) plus 1e-5, as the reference fits it
        self.stds = torch.std(x, dim=0, correction=0) + 1e-5
        return self

    def transform(self, x):
        return (torch.as_tensor(x) - self.means) / self.stds

    def inverse_transform(self, x):
        return torch.as_tensor(x) * self.stds + self.means

    def state_dict(self) -> dict:
        return {"means": self.means.numpy(), "stds": self.stds.numpy()}

    @classmethod
    def from_state_dict(cls, state: dict) -> "StandardScaler":
        return cls(means=state["means"], stds=state["stds"])

    def copy(self) -> "StandardScaler":
        return StandardScaler(self.means, self.stds)
