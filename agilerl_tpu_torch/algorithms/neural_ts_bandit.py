"""NeuralTS contextual bandit: the port of
``agilerl_tpu/algorithms/neural_ts_bandit.py``.

Thompson sampling over the same per-arm gradients as NeuralUCB: arm a's
reward is drawn from ``N(f(x_a), (nu * sigma_a)^2)`` with ``sigma_a^2 = lamb
* sum(g_a^2 / U)`` (floored at 1e-12), and the arm with the largest draw is
pulled. The standard normals come from the agent's generator, on the
device; ``get_action(..., draws=)`` takes them instead (``[num_arms]``), so
a test can replay another stream's draws (a deviation: the JAX agent draws
from its key inside the jitted step).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.neural_ucb_bandit import NeuralUCB
from agilerl_tpu_torch.utils.spaces import as_tensor


class NeuralTS(NeuralUCB):
    def get_action(self, context: Any, training: bool = True,
                   draws: Optional[Any] = None, **kw) -> np.ndarray:
        context = self.preprocess_observation(context)
        if not training:
            return self._greedy(context)
        values, sq, grads = self._arm_stats(context)
        sigma = torch.sqrt(torch.clamp_min(self.lamb * sq, 1e-12))
        if draws is None:
            noise = torch.randn(values.shape, generator=self.next_key(self.dev),
                                device=self.dev)
        else:
            noise = as_tensor(draws, self.dev).float()
        return self._pull(values + self.gamma * sigma * noise, grads)
