"""PettingZoo vector envs of the port (host numpy): the synchronous
``PettingZooVecEnv``, the multiprocess ``AsyncPettingZooVecEnv`` and
``sanitize_ma_transition``."""

from agilerl_tpu_torch.vector.pz_async_vec_env import AsyncPettingZooVecEnv
from agilerl_tpu_torch.vector.pz_vec_env import PettingZooVecEnv, sanitize_ma_transition

__all__ = ["PettingZooVecEnv", "AsyncPettingZooVecEnv", "sanitize_ma_transition"]
