"""Vector-env helpers of the port. Only ``sanitize_ma_transition`` of the
JAX package's ``agilerl_tpu/vector/`` is ported so far: the PettingZoo
vector envs and their wrappers come with Queue 1's item 5d-pz."""

from agilerl_tpu_torch.vector.pz_vec_env import sanitize_ma_transition

__all__ = ["sanitize_ma_transition"]
