"""Role factories for tests/test_torch_launch.py and tests/test_torch_proc.py.

A module of its own, importing neither jax nor the JAX package: the port's
launcher children import their factories by ``module:function``
(``tests.torch_launch_roles:make_agent``), and a child must end with no jax
loaded. The tiny GRPO recipe is test_launch.py's (2 layers, d_model 32, char
vocab, group 2, 4 new tokens), on the CPU.
"""

from pathlib import Path

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.grpo import GRPO
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy
from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym

torch.set_num_threads(1)

TOK = CharTokenizer()
MODEL = dict(vocab_size=TOK.vocab_size, n_layer=2, n_head=4, d_model=32, max_seq_len=64)
CFG = TM.GPTConfig(dtype=torch.float32, **MODEL)
AGENT = dict(pad_token_id=TOK.pad_token_id, eos_token_id=TOK.eos_token_id, group_size=2,
             batch_size=8, max_output_tokens=4)


def reasoning_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"question": f"{a}+{b}=", "answer": str(a + b)}
            for a, b in rng.integers(0, 5, (n, 2))]


def spread_reward(completion, answer, prompt):
    return 0.1 * len(completion) + float(completion.startswith(str(answer)))


class RecordingEnv:
    """Forwards to the wrapped env and saves each training step's
    completion ids as ``<record>/step_<k>.npy`` (the trajectory store
    deletes consumed batches, so this is what a test reads back)."""

    def __init__(self, env, record):
        self.env = env
        self.record = Path(record)
        self.record.mkdir(parents=True, exist_ok=True)
        self.n = len(list(self.record.glob("step_*.npy")))

    def step(self, completion_ids, completion_mask):
        np.save(self.record / f"step_{self.n:04d}.npy", np.asarray(completion_ids))
        self.n += 1
        return self.env.step(completion_ids, completion_mask)

    def __getattr__(self, name):
        return getattr(self.env, name)


def make_env(record=None, Gym=ReasoningGym, tok=TOK):
    env = Gym(reasoning_rows(16, 0), reasoning_rows(4, 1), tok, reward_fn=spread_reward,
              data_batch_size=4)
    return RecordingEnv(env, record) if record else env


def _unflatten(flat, prefix):
    out = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def make_agent(seed=0, npz=None):
    """The port's GRPO on the CPU: from ``seed``, or on the weights in
    ``npz`` (keys ``base/...``, ``actor/...``, ``reference/...``: a JAX
    agent's arrays, carried as numpy)."""
    if npz is None:
        return GRPO(config=CFG, seed=seed, device="cpu", **AGENT)
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    agent = GRPO(config=CFG, seed=seed, device="cpu",
                 base_params=params_from_numpy(_unflatten(flat, "base/"), CFG, device="cpu"),
                 **AGENT)
    agent.actor.params = lora_from_numpy(_unflatten(flat, "actor/"), device="cpu")
    agent.reference.params = lora_from_numpy(_unflatten(flat, "reference/"), device="cpu")
    agent.optimizer.init(agent.actor.params)
    return agent


def flaky_role(ctx):
    """Crashes on its first incarnation and completes after the respawn."""
    if ctx.spec.incarnation == 0:
        raise RuntimeError("injected first-incarnation crash")
    ticks = {"n": 0}

    def tick():
        ticks["n"] += 1
        return ticks["n"] >= 2

    return tick


def always_crash_role(ctx):
    raise RuntimeError("injected crash (every incarnation)")


def race_writer(directory, writer, n):
    """Publish ``n`` entries under the SAME names as a sibling writer: the
    pid-prefixed staging must keep the racers out of each other's
    in-flight ``.tmp`` dirs."""
    from agilerl_tpu_torch.resilience.store import publish_entry

    for seq in range(n):
        publish_entry(directory, f"entry_{seq:08d}", {"writer": writer, "seq": seq},
                      manifest_extra={"writer": writer, "seq": seq})
    print("WRITER_OK", writer)


class _PausedLearner:
    """``learner_role`` that idles (ticks without stepping) once it has
    published epoch ``pause_at``, in its first incarnation only: a test then
    kills it at a known epoch, whatever the host's speed. The respawn
    (incarnation 1) never pauses."""

    def __init__(self, ctx):
        from agilerl_tpu_torch.training.launch import learner_role

        self.role = learner_role(ctx)
        self.pause_at = None if ctx.spec.incarnation else int(ctx.spec.kwargs["pause_at"])

    def tick(self):
        if self.pause_at is not None and self.role.pod.epoch >= self.pause_at:
            return False
        return self.role.tick()


def paused_learner_role(ctx):
    return _PausedLearner(ctx)


def gather_worker(rank, world, port, out):
    """One rank of a gloo process group on this host: all-gather and mean a
    per-rank value through the port's host helpers, then write them to
    ``out`` as JSON."""
    import json

    import torch.distributed as dist

    from agilerl_tpu_torch.utils.utils import aggregate_metrics_across_hosts, gather_across_hosts

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        gathered = gather_across_hosts(np.asarray([rank, 10 * rank], np.int64))
        mean = aggregate_metrics_across_hosts(float(rank + 1))
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps({"gathered": gathered.tolist(), "mean": mean}))
