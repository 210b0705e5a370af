"""GX001 negative: the same calls outside loops, and host values in loops."""
import numpy as np
import torch


def evaluate(agent, env, steps):
    final = agent.q_values.cpu().numpy()     # once, after training: fine
    torch.cuda.synchronize()                 # outside any loop
    done = np.zeros(4, bool)
    for _ in range(steps):
        if np.any(done):                     # numpy module: host
            break
        if any(x > 0 for x in [1, 2]):       # builtin any on host values
            continue
        done = np.logical_or(done, np.unique(done).size > 1)
        for key, value in agent.stats.items():  # dict.items(): not .item()
            _ = (key, value)
    return final
