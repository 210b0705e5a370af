"""GX001 positive: the torch spellings of a host sync in hot-path loops."""
import torch


def train(agent, batches, steps):
    history = []
    for _ in range(steps):
        loss = agent.learn()
        history.append(loss.cpu())               # sync: copy to host
        history.append(loss.detach().cpu().numpy())  # one sync (the .cpu())
        q = agent.q_values.numpy()                # sync: .numpy()
        torch.cuda.synchronize()                  # sync: the whole queue
        if agent.done.any():                      # branch on a tensor
            break
        keep = q if torch.equal(agent.a, agent.b) else None  # ternary branch
        idx = agent.mask.nonzero()                # data-dependent shape
        rows = torch.masked_select(agent.q_values, agent.mask)  # ditto
        uniq = torch.unique(agent.actions)        # ditto
        history.append((keep, idx, rows, uniq))
    while not agent.converged.all():              # while on a tensor
        agent.learn()
    return history
