"""Wrappers of the port: agent wrappers (``RSNorm``, ``RunningMeanStd``,
``AsyncAgentsWrapper``), learning wrappers (``BanditEnv``, ``Skill``), the
PettingZoo autoreset wrapper and ``MakeEvolvable`` (a ``torch.nn`` module
reflected into an evolvable clone)."""

from agilerl_tpu_torch.wrappers.agent import AsyncAgentsWrapper, RSNorm, RunningMeanStd
from agilerl_tpu_torch.wrappers.learning import BanditEnv, Skill
from agilerl_tpu_torch.wrappers.make_evolvable import MakeEvolvable
from agilerl_tpu_torch.wrappers.pettingzoo_wrappers import PettingZooAutoResetParallelWrapper

__all__ = ["RSNorm", "RunningMeanStd", "AsyncAgentsWrapper", "BanditEnv", "Skill",
           "MakeEvolvable", "PettingZooAutoResetParallelWrapper"]
