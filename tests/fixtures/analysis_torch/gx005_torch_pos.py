"""GX005 positive: retry wrappers around torch.distributed and the port's
hand-run collectives."""
import torch.distributed as dist

from agilerl_tpu_torch.parallel import comm
from agilerl_tpu_torch.parallel.comm import gather_shards
from agilerl_tpu_torch.resilience.retry import RetryPolicy, call_with_retries


def sync(t, group):
    call_with_retries(lambda: dist.all_reduce(t), attempts=3)
    call_with_retries(gather_shards, t, group)        # imported-name form
    return RetryPolicy(lambda: comm.sum_to_all(t, group))
