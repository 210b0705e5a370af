"""GX005 negative: retries around host I/O; collectives behind the
fail-fast timeout."""
import torch.distributed as dist

from agilerl_tpu_torch.resilience.membership import call_with_collective_timeout
from agilerl_tpu_torch.resilience.retry import call_with_retries


def load(path, read_file):
    data = call_with_retries(read_file, path, attempts=3)
    call_with_collective_timeout(dist.barrier, timeout_s=30.0)
    return data
