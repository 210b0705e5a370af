"""GX002 positive: compiles and graph captures made per iteration or per
call."""
import torch


def train(model, batches):
    for batch in batches:
        step = torch.compile(model)           # a fresh compile per iteration
        scripted = torch.jit.script(model)    # ditto
        graph = torch.cuda.CUDAGraph()        # a fresh capture per iteration
        with torch.cuda.graph(graph):         # ditto
            step(batch)
        scripted(batch)


def make_step(model):
    return torch.compile(lambda x: model(x) * 2)  # new closure per call
