"""GX002 negative: compile once, reuse."""
import torch

SCALE = torch.compile(lambda x: x * 2)   # module scope binds once


def make_step(model):
    return torch.compile(model)          # not a lambda, not in a loop


def train(step, batches):
    graph = torch.cuda.CUDAGraph()       # one capture, before the loop
    for batch in batches:
        step(batch)
    return graph
