"""GX004 positive: torch.save straight to a path in a durability module."""
from pathlib import Path

import torch


def save_snapshot(state, path, directory):
    torch.save(state, path)                          # a path: in place
    torch.save(state, "latest.pt")                   # a literal path
    torch.save(state, f"{directory}/step.pt")        # an f-string path
    torch.save(state, Path(directory) / "opt.pt")    # a path expression
