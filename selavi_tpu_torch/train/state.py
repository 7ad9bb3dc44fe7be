"""Host-side SeLaVi training state (``selavi_tpu/train/state.py``'s
``SelfLabelState``), checkpointed beside the model and the optimizer.

JAX's ``TrainState`` has no counterpart: the ``nn.Module`` holds the
parameters and BN statistics, ``torch.optim.SGD`` the momentum, and the
Trainer counts optimizer steps (JAX's ``TrainState.step``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from selavi_tpu_torch.selflabel.marginals import MarginalState


@dataclasses.dataclass
class SelfLabelState:
    selflabels: np.ndarray  # [N, H] int32
    marginals: MarginalState
    sk_counter: int = 0
    epoch: int = 0

    @classmethod
    def init(cls, n: int, headcount: int) -> "SelfLabelState":
        return cls(
            selflabels=np.zeros((n, headcount), np.int32),
            marginals=MarginalState(),
        )
