"""GX004 negative: torch.save into a buffer, published atomically."""
import io

import torch

from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes


def save_snapshot(state, path):
    buf = io.BytesIO()
    torch.save(state, buf)                 # a buffer: nothing on disk yet
    atomic_write_bytes(path, buf.getvalue())
