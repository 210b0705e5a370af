"""GX003 negative: threaded generators."""
import numpy as np
import torch


def init_member(shape, x, seed):
    g = torch.Generator().manual_seed(seed)   # a constructor, not a draw
    a = torch.rand(shape, generator=g)
    perm = torch.randperm(8, generator=g)
    x.uniform_(-1.0, 1.0, generator=g)
    g.manual_seed(seed + 1)                   # reseeds its own generator
    rng = np.random.default_rng(seed)
    return a, perm, rng.normal()
