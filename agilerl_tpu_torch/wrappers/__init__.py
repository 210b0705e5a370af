"""Wrappers of the port: agent wrappers (``RSNorm``, ``RunningMeanStd``,
``AsyncAgentsWrapper``), learning wrappers (``BanditEnv``, ``Skill``) and the
PettingZoo autoreset wrapper. ``MakeEvolvable`` waits for its slice."""

from agilerl_tpu_torch.wrappers.agent import AsyncAgentsWrapper, RSNorm, RunningMeanStd
from agilerl_tpu_torch.wrappers.learning import BanditEnv, Skill
from agilerl_tpu_torch.wrappers.pettingzoo_wrappers import PettingZooAutoResetParallelWrapper

__all__ = ["RSNorm", "RunningMeanStd", "AsyncAgentsWrapper", "BanditEnv", "Skill",
           "PettingZooAutoResetParallelWrapper"]
