"""GX003 positive: draws on the global torch stream and reseeding it."""
import torch


def init_member(shape, x):
    a = torch.rand(shape)                 # global stream
    b = torch.randint(0, 5, (2,))         # global stream
    perm = torch.randperm(8)              # global stream
    c = torch.randn_like(x)               # *_like: no generator at all
    x.uniform_(-1.0, 1.0)                 # in place, global stream
    x.normal_(0.0, 0.02)                  # in place, global stream
    torch.manual_seed(0)                  # reseeds the global stream
    torch.cuda.manual_seed_all(0)         # ditto, every card
    return a, b, perm, c
