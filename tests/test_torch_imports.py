"""Hygiene of the PyTorch port: it imports neither jax nor agilerl_tpu, and it
never falls back to the CPU on its own."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# the classic RL slice's modules (Queue 1's slice 5a)
_CLASSIC_IMPORTS = (
    "import agilerl_tpu_torch.typing, agilerl_tpu_torch.utils.spaces\n"
    "import agilerl_tpu_torch.modules.base, agilerl_tpu_torch.modules.mlp\n"
    "import agilerl_tpu_torch.modules.configs, agilerl_tpu_torch.networks.distributions\n"
    "import agilerl_tpu_torch.networks.base, agilerl_tpu_torch.networks.actors\n"
    "import agilerl_tpu_torch.networks.value_networks\n"
    "import agilerl_tpu_torch.components.rollout_buffer, agilerl_tpu_torch.envs.core\n"
    "import agilerl_tpu_torch.envs.classic, agilerl_tpu_torch.envs.probe\n"
    "import agilerl_tpu_torch.rollouts.on_policy, agilerl_tpu_torch.algorithms.ppo\n"
    "import agilerl_tpu_torch.training.train_on_policy\n"
    # the population program and the other encoders (Queue 1's slices 5e-head, 5b)
    "import agilerl_tpu_torch.parallel, agilerl_tpu_torch.parallel.generation\n"
    "import agilerl_tpu_torch.parallel.population, agilerl_tpu_torch.protocols\n"
    "import agilerl_tpu_torch.modules.custom_components, agilerl_tpu_torch.modules.cnn\n"
    "import agilerl_tpu_torch.modules.resnet, agilerl_tpu_torch.modules.simba\n"
    "import agilerl_tpu_torch.modules.lstm, agilerl_tpu_torch.modules.multi_input\n"
    "import agilerl_tpu_torch.modules.dummy\n"
    # replay buffers, the DQN family and the off-policy loop (Queue 1's slice 5c-i)
    "import agilerl_tpu_torch.components.replay_buffer, agilerl_tpu_torch.components.sampler\n"
    "import agilerl_tpu_torch.components.segment_tree, agilerl_tpu_torch.components.data\n"
    "import agilerl_tpu_torch.algorithms.core.fused, agilerl_tpu_torch.networks.q_networks\n"
    "import agilerl_tpu_torch.algorithms.dqn, agilerl_tpu_torch.algorithms.dqn_rainbow\n"
    "import agilerl_tpu_torch.algorithms.cqn, agilerl_tpu_torch.training.train_off_policy\n"
    # DDPG, TD3, offline and the off-policy population program (slices 5c-ii, 5c-scan)
    "import agilerl_tpu_torch.algorithms.ddpg, agilerl_tpu_torch.algorithms.td3\n"
    "import agilerl_tpu_torch.utils.minari_utils, agilerl_tpu_torch.training.train_offline\n"
    "import agilerl_tpu_torch.parallel.off_policy\n"
    # multi-agent RL and its population program (Queue 1's slice 5d)
    "import agilerl_tpu_torch.envs.multi_agent, agilerl_tpu_torch.envs.probe_ma\n"
    "import agilerl_tpu_torch.vector, agilerl_tpu_torch.vector.pz_vec_env\n"
    "import agilerl_tpu_torch.components.multi_agent_replay_buffer\n"
    "import agilerl_tpu_torch.algorithms.maddpg, agilerl_tpu_torch.algorithms.matd3\n"
    "import agilerl_tpu_torch.algorithms.ippo, agilerl_tpu_torch.parallel.multi_agent\n"
    "import agilerl_tpu_torch.training.train_multi_agent_off_policy\n"
    "import agilerl_tpu_torch.training.train_multi_agent_on_policy\n"
    # the evolvable transformers, the bandits and the PettingZoo stack (Queue
    # 1's items 8, 7 and 6, with wrappers/agent.py)
    "import agilerl_tpu_torch.modules, agilerl_tpu_torch.modules.gpt\n"
    "import agilerl_tpu_torch.modules.bert, agilerl_tpu_torch.wrappers\n"
    "import agilerl_tpu_torch.wrappers.learning, agilerl_tpu_torch.wrappers.agent\n"
    "import agilerl_tpu_torch.wrappers.pettingzoo_wrappers\n"
    "import agilerl_tpu_torch.algorithms.neural_ucb_bandit\n"
    "import agilerl_tpu_torch.algorithms.neural_ts_bandit\n"
    "import agilerl_tpu_torch.training.train_bandits\n"
    "import agilerl_tpu_torch.vector.pz_async_vec_env\n"
    # whole-run snapshots, preemption, retry and fault injection, then
    # MakeEvolvable and the host helpers (slice 6's resilience facade and
    # Queue 1's item 9)
    "import agilerl_tpu_torch.resilience.retry, agilerl_tpu_torch.resilience.preemption\n"
    "import agilerl_tpu_torch.resilience.faults, agilerl_tpu_torch.resilience.snapshot\n"
    "import agilerl_tpu_torch.wrappers.make_evolvable, agilerl_tpu_torch.utils.algo_utils\n"
)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys\n"
        "import agilerl_tpu_torch, agilerl_tpu_torch.ops\n"
        "import agilerl_tpu_torch.llm.model, agilerl_tpu_torch.llm.generate\n"
        "import agilerl_tpu_torch.llm.presets, agilerl_tpu_torch.llm.convert\n"
        "import agilerl_tpu_torch.ops.flash_attention, agilerl_tpu_torch.ops.fused_loss\n"
        "import agilerl_tpu_torch.ops.decode_attention, agilerl_tpu_torch.ops._build\n"
        "import agilerl_tpu_torch.ops.flash_attention_vjp\n"
        "import agilerl_tpu_torch.algorithms.grpo, agilerl_tpu_torch.algorithms.core.base\n"
        "import agilerl_tpu_torch.algorithms.core.optimizer\n"
        "import agilerl_tpu_torch.algorithms.core.registry, agilerl_tpu_torch.hpo\n"
        "import agilerl_tpu_torch.hpo.mutation, agilerl_tpu_torch.hpo.tournament\n"
        "import agilerl_tpu_torch.utils.rng, agilerl_tpu_torch.utils.tree\n"
        "import agilerl_tpu_torch.utils.utils, agilerl_tpu_torch.utils.llm_utils\n"
        "import agilerl_tpu_torch.data.language_environment\n"
        "import agilerl_tpu_torch.training.train_llm\n"
        "import agilerl_tpu_torch.algorithms.dpo, agilerl_tpu_torch.algorithms.ilql\n"
        "import agilerl_tpu_torch.modules.layers, agilerl_tpu_torch.data.rl_data\n"
        "import agilerl_tpu_torch.llm.hf, agilerl_tpu_torch.llm.moe\n"
        "import agilerl_tpu_torch.llm.serving, agilerl_tpu_torch.llm.speculate\n"
        "import agilerl_tpu_torch.observability, agilerl_tpu_torch.observability.registry\n"
        "import agilerl_tpu_torch.observability.trace\n"
        "import agilerl_tpu_torch.resilience, agilerl_tpu_torch.resilience.atomic\n"
        "import agilerl_tpu_torch.resilience.store, agilerl_tpu_torch.resilience.membership\n"
        "import agilerl_tpu_torch.resilience.facade, agilerl_tpu_torch.llm.router\n"
        "import agilerl_tpu_torch.llm.fleet, agilerl_tpu_torch.llm.autoscale\n"
        "import agilerl_tpu_torch.llm.flywheel, agilerl_tpu_torch.training.train_llm_online\n"
        "import agilerl_tpu_torch.observability.events, agilerl_tpu_torch.observability.lineage\n"
        "import agilerl_tpu_torch.observability.timeline, agilerl_tpu_torch.observability.facade\n"
        "import agilerl_tpu_torch.observability.export, agilerl_tpu_torch.observability.slo\n"
        "import agilerl_tpu_torch.utils.log_utils, agilerl_tpu_torch.utils.profiling\n"
        + _CLASSIC_IMPORTS +
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'agilerl_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            root = stripped.split()[1].split(".")[0]
            assert root not in ("jax", "jaxlib", "agilerl_tpu"), line


def test_default_device_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.ops import resolve_device

    cfg = TM.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_lora(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_kv_cache(cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_slice_3_entry_points_default_to_the_card():
    """DPO, ILQL, BC_LM and load_hf_model take device=None as the card and
    raise without one, rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.algorithms.dpo import DPO
    from agilerl_tpu_torch.algorithms.ilql import BC_LM, ILQL
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.llm.hf import load_hf_model

    cfg = TM.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8, dtype=torch.float32)
    for make in (lambda: DPO(config=cfg, seed=0), lambda: ILQL(config=cfg, seed=0),
                 lambda: BC_LM(config=cfg, seed=0),
                 lambda: load_hf_model(str(REPO / "tests" / "fixtures" / "hf_llama_tiny"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert DPO(config=cfg, seed=0, device="cpu").dev == torch.device("cpu")


def test_serving_entry_points_default_to_the_card():
    """The serving generators, the paged pool and GRPO's routes take
    device=None as the card and raise without one: no quiet CPU serving."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.llm.serving import BucketedGenerator, ContinuousGenerator

    cfg = TM.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8, dtype=torch.float32)
    for make in (lambda: BucketedGenerator(cfg), lambda: ContinuousGenerator(cfg),
                 lambda: TM.init_paged_cache(cfg, 4, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert ContinuousGenerator(cfg, device="cpu").dev == torch.device("cpu")


def test_fleet_entry_points_default_to_the_card(tmp_path):
    """The serving fleet, its prefill worker and the online flywheel's
    rollouts take device=None as the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.llm.fleet import PrefillWorker, ServingFleet

    cfg = TM.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8, dtype=torch.float32)
    for make in (lambda: ServingFleet(cfg, 1, prompt_buckets=(32,)),
                 lambda: ServingFleet(cfg, 1, topology="disaggregated", transfer_dir=tmp_path,
                                      prompt_buckets=(32,)),
                 lambda: PrefillWorker(cfg, prompt_buckets=(32,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    fleet = ServingFleet(cfg, 2, prompt_buckets=(32,), device="cpu")
    assert {m.gen.dev for m in fleet._members.values()} == {torch.device("cpu")}
    fleet.scale_up()
    assert fleet._members[2].gen.dev == torch.device("cpu")


def test_item_9_entry_points_default_to_the_card():
    """MakeEvolvable (both modes) and chkpt_attribute_to_device take
    device=None as the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import warnings

    from agilerl_tpu_torch.utils.algo_utils import chkpt_attribute_to_device
    from agilerl_tpu_torch.wrappers import MakeEvolvable

    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for make in (lambda: MakeEvolvable(network=net, input_tensor=torch.zeros(1, 4)),
                     lambda: MakeEvolvable(num_inputs=4, num_outputs=2),
                     lambda: chkpt_attribute_to_device({"w": torch.zeros(2)})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    cpu = MakeEvolvable(network=net, input_tensor=torch.zeros(1, 4), device="cpu")
    assert cpu.device == torch.device("cpu")


def test_kernel_build_raises_without_nvcc():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present: the build would succeed")
    from agilerl_tpu_torch.ops import _build

    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["flash_attention_fwd"])


def test_kernel_sources_exist_for_every_wrapper():
    from agilerl_tpu_torch.ops import _kernel_wrappers, kernel_counters

    wrappers = _kernel_wrappers()
    assert [f.kernel_name for f in wrappers] == list(kernel_counters())
    for f in wrappers:
        assert (REPO / "agilerl_tpu_torch" / "csrc" / f"{f.source}.cu").exists(), f.kernel_name


def test_counters_reset_and_cpu_calls_do_not_count():
    from agilerl_tpu_torch.ops import kernel_counters, reset_kernel_counters
    from agilerl_tpu_torch.ops.flash_attention_vjp import flash_attention_diff
    from agilerl_tpu_torch.ops.fused_loss import fused_token_logprob

    reset_kernel_counters()
    q = torch.randn(1, 2, 8, 4)
    flash_attention_diff(q, q, q)
    fused_token_logprob(torch.randn(3, 4), torch.randn(4, 5), torch.tensor([0, 1, 2]))
    assert set(kernel_counters().values()) == {0}


def test_classic_slice_imports_neither_gymnasium_nor_yaml():
    """The device envs and PPO need neither: gymnasium is imported only by
    make_vect_envs for an env id outside the port's registry, PyYAML only
    when a YAML path is loaded."""
    code = ("import json, sys\n" + _CLASSIC_IMPORTS
            + "import agilerl_tpu_torch.utils.utils, agilerl_tpu_torch.hpo.mutation\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('gymnasium', 'gym', 'yaml', 'jax',\n"
            "                                               'agilerl_tpu'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_classic_entry_points_default_to_the_card(tmp_path):
    """PPO (flat and recurrent), TorchVecEnv, make_vect_envs,
    create_population("PPO"), EvolvableMLP and the other five encoders, the
    actor and value networks, RolloutBuffer, EvoPPO and ScanRun, the three
    replay buffers, DQN, RainbowDQN and CQN, and load /
    load_population_checkpoint of a file saved on the CPU take device=None as
    the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.algorithms.ppo import PPO
    from agilerl_tpu_torch.components.rollout_buffer import RolloutBuffer
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.envs.core import TorchVecEnv
    from agilerl_tpu_torch.modules.mlp import EvolvableMLP
    from agilerl_tpu_torch.networks.actors import StochasticActor
    from agilerl_tpu_torch.networks.value_networks import ValueNetwork
    from agilerl_tpu_torch.modules.cnn import EvolvableCNN
    from agilerl_tpu_torch.modules.lstm import EvolvableLSTM
    from agilerl_tpu_torch.modules.multi_input import EvolvableMultiInput
    from agilerl_tpu_torch.modules.resnet import EvolvableResNet
    from agilerl_tpu_torch.modules.simba import EvolvableSimBa
    from agilerl_tpu_torch.algorithms.cqn import CQN
    from agilerl_tpu_torch.algorithms.dqn import DQN
    from agilerl_tpu_torch.algorithms.dqn_rainbow import RainbowDQN
    from agilerl_tpu_torch.components.replay_buffer import (
        MultiStepReplayBuffer,
        PrioritizedReplayBuffer,
        ReplayBuffer,
    )
    from agilerl_tpu_torch.parallel import ScanRun
    from agilerl_tpu_torch.utils.spaces import Box, Dict
    from agilerl_tpu_torch.utils.tree import tree_leaves
    from agilerl_tpu_torch.utils.utils import (
        create_population,
        load_population_checkpoint,
        make_vect_envs,
        save_population_checkpoint,
    )

    env = CartPole()
    saved = DQN(env.observation_space, env.action_space, seed=0, device="cpu")
    saved.save_checkpoint(tmp_path / "dqn.ckpt")
    save_population_checkpoint([saved], str(tmp_path / "pop.ckpt"))
    for make in (lambda: PPO(env.observation_space, env.action_space, seed=0),
                 lambda: TorchVecEnv(env, 2),
                 lambda: make_vect_envs("CartPole-v1", 2),
                 lambda: create_population("PPO", env.observation_space, env.action_space,
                                           population_size=2, seed=0),
                 lambda: EvolvableMLP(num_inputs=4, num_outputs=2, hidden_size=(8,)),
                 lambda: StochasticActor(env.observation_space, env.action_space),
                 lambda: ValueNetwork(env.observation_space),
                 lambda: RolloutBuffer(capacity=4, num_envs=2),
                 lambda: PPO(env.observation_space, env.action_space, seed=0, recurrent=True),
                 lambda: EvolvableCNN(input_shape=(8, 8, 3), num_outputs=2),
                 lambda: EvolvableResNet(input_shape=(8, 8, 3), num_outputs=2),
                 lambda: EvolvableSimBa(num_inputs=4, num_outputs=2),
                 lambda: EvolvableLSTM(num_inputs=4, num_outputs=2),
                 lambda: EvolvableMultiInput(Dict({"a": Box(-1.0, 1.0, (3,))}), num_outputs=2),
                 lambda: _evo_ppo(env, None),
                 lambda: ReplayBuffer(16), lambda: MultiStepReplayBuffer(16),
                 lambda: PrioritizedReplayBuffer(16),
                 lambda: DQN(env.observation_space, env.action_space, seed=0),
                 lambda: RainbowDQN(env.observation_space, env.action_space, seed=0),
                 lambda: CQN(env.observation_space, env.action_space, seed=0),
                 lambda: create_population("RainbowDQN", env.observation_space,
                                           env.action_space, population_size=2, seed=0),
                 lambda: DQN.load(tmp_path / "dqn.ckpt"),
                 lambda: load_population_checkpoint("DQN", str(tmp_path / "pop.ckpt"), [0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    evo = _evo_ppo(env, "cpu")
    assert evo.device == torch.device("cpu")
    run = ScanRun(evo, pop_size=2, seed=0)
    assert {x.device for x in tree_leaves(run.pop) if isinstance(x, torch.Tensor)} == {evo.device}
    agent = PPO(env.observation_space, env.action_space, seed=0, device="cpu")
    assert agent.dev == torch.device("cpu")
    assert {p.device for p in agent.actor.params["head"]["output"].values()} == {agent.dev}
    assert make_vect_envs("CartPole-v1", 2, device="cpu").device == torch.device("cpu")
    assert EvolvableMLP(num_inputs=4, num_outputs=2, hidden_size=(8,),
                        device="cpu").device == torch.device("cpu")
    assert ValueNetwork(env.observation_space, device="cpu").device == torch.device("cpu")
    assert RolloutBuffer(capacity=4, num_envs=2, device="cpu").device == torch.device("cpu")
    for cls in (ReplayBuffer, MultiStepReplayBuffer, PrioritizedReplayBuffer):
        assert cls(16, device="cpu").device == torch.device("cpu")
    for cls in (DQN, RainbowDQN, CQN):
        q = cls(env.observation_space, env.action_space, seed=0, device="cpu")
        assert {p.device for p in q.actor_target.params["head"]["output"].values()} == {q.dev}
    for q in (DQN.load(tmp_path / "dqn.ckpt", device="cpu"),
              load_population_checkpoint("DQN", str(tmp_path / "pop.ckpt"), [0],
                                         device="cpu")[0]):
        assert q.dev == torch.device("cpu")
        assert {p.device for p in q.actor.params["head"]["output"].values()} == {q.dev}


def test_off_policy_slice_imports_no_h5py_and_defaults_to_the_card():
    """DDPG, TD3, the offline loop and the off-policy population programs
    import neither jax, the JAX package, h5py, gymnasium nor PyYAML; DDPG,
    TD3, create_population("DDPG" / "TD3"), EvoDQN, EvoRainbow, EvoDDPG,
    EvoTD3 and collect_offline_dataset (on a device env) take device=None as
    the card and raise without one."""
    code = ("import json, sys\n" + _CLASSIC_IMPORTS
            + "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('h5py', 'gymnasium', 'yaml', 'jax',\n"
            "                                               'agilerl_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.algorithms.ddpg import DDPG
    from agilerl_tpu_torch.algorithms.td3 import TD3
    from agilerl_tpu_torch.envs.classic import CartPole, Pendulum
    from agilerl_tpu_torch.networks.actors import DeterministicActor
    from agilerl_tpu_torch.networks.q_networks import ContinuousQNetwork, QNetwork, RainbowQNetwork
    from agilerl_tpu_torch.parallel import EvoDDPG, EvoDQN, EvoRainbow, EvoTD3
    from agilerl_tpu_torch.utils.minari_utils import collect_offline_dataset
    from agilerl_tpu_torch.utils.utils import create_population

    pend, cart = Pendulum(), CartPole()
    q = QNetwork(cart.observation_space, cart.action_space, device="cpu").config
    rq = RainbowQNetwork(cart.observation_space, cart.action_space, device="cpu").config
    a = DeterministicActor(pend.observation_space, pend.action_space, device="cpu").config
    c = ContinuousQNetwork(pend.observation_space, pend.action_space, device="cpu").config
    for make in (lambda: DDPG(pend.observation_space, pend.action_space, seed=0),
                 lambda: TD3(pend.observation_space, pend.action_space, seed=0),
                 lambda: create_population("DDPG", pend.observation_space, pend.action_space,
                                           population_size=2, seed=0),
                 lambda: create_population("TD3", pend.observation_space, pend.action_space,
                                           population_size=2, seed=0),
                 lambda: EvoDQN(cart, q), lambda: EvoRainbow(cart, rq),
                 lambda: EvoDDPG(pend, a, c), lambda: EvoTD3(pend, a, c),
                 lambda: collect_offline_dataset(cart, steps=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for cls in (DDPG, TD3):
        agent = cls(pend.observation_space, pend.action_space, seed=0, device="cpu")
        assert {p.device for p in agent.critic_target.params["head"]["output"].values()} == \
            {agent.dev} == {torch.device("cpu")}
    assert EvoDDPG(pend, a, c, device="cpu").init_population(0, 2).obs.device.type == "cpu"
    assert collect_offline_dataset(cart, steps=8, num_envs=2,
                                   device="cpu")["observations"].shape == (8, 4)


def _evo_ppo(env, device):
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks import distributions as D
    from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config
    from agilerl_tpu_torch.parallel import EvoPPO

    kind, enc = default_encoder_config(env.observation_space, 8)
    cfgs = [NetworkConfig(kind, enc, MLPConfig(num_inputs=8, num_outputs=n, hidden_size=(8,)),
                          latent_dim=8) for n in (2, 1)]
    return EvoPPO(env, *cfgs, D.dist_config_from_space(env.action_space), adam(1e-3),
                  num_envs=2, rollout_len=4, device=device)


def test_off_policy_scan_tier_still_raises():
    """The off-policy population as one program runs on one card (slice
    5c-scan); its pod-sharded generation still raises, naming slice 6."""
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.parallel import ScanOffPolicy

    engine = ScanOffPolicy(CartPole(), None, num_envs=2, device="cpu")
    assert engine.env_steps_per_generation == 2 * 128
    with pytest.raises(NotImplementedError, match="slice 6"):
        engine.make_pod_generation()


def test_multi_agent_entry_points_default_to_the_card():
    """The multi-agent slice imports neither jax, the JAX package, gymnasium
    nor PyYAML (the _CLASSIC_IMPORTS tests above); SimpleSpreadTorch (a
    stateless env, through its vector env), MultiAgentTorchVecEnv,
    MultiAgentReplayBuffer, MADDPG, MATD3, IPPO, create_population of each
    and EvoIPPO take device=None as the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.algorithms.ippo import IPPO
    from agilerl_tpu_torch.algorithms.maddpg import MADDPG
    from agilerl_tpu_torch.algorithms.matd3 import MATD3
    from agilerl_tpu_torch.components.multi_agent_replay_buffer import MultiAgentReplayBuffer
    from agilerl_tpu_torch.envs.multi_agent import MultiAgentTorchVecEnv, SimpleSpreadTorch
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks import distributions as D
    from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config
    from agilerl_tpu_torch.parallel import EvoIPPO
    from agilerl_tpu_torch.utils.utils import create_population

    env = SimpleSpreadTorch(2)
    obs, act, ids = env.observation_spaces, env.action_spaces, env.agent_ids
    kind, enc = default_encoder_config(obs[ids[0]], 8)
    cfgs = [NetworkConfig(kind, enc, MLPConfig(num_inputs=8, num_outputs=n, hidden_size=(8,)),
                          latent_dim=8) for n in (5, 1)]
    dist = D.dist_config_from_space(act[ids[0]])
    makes = [lambda: MultiAgentTorchVecEnv(env, 2), lambda: MultiAgentReplayBuffer(16, ids),
             lambda: EvoIPPO(env, *cfgs, dist, adam(1e-3), num_envs=2, rollout_len=4)]
    for cls in (MADDPG, MATD3, IPPO):
        makes.append(lambda cls=cls: cls(obs, act, agent_ids=ids, seed=0))
        makes.append(lambda cls=cls: create_population(cls.__name__, obs, act,
                                                       population_size=2, seed=0))
    for make in makes:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert MultiAgentTorchVecEnv(env, 2, device="cpu").reset()[0][ids[0]].device.type == "cpu"
    assert MultiAgentReplayBuffer(16, ids, device="cpu").device == torch.device("cpu")
    for cls in (MADDPG, MATD3, IPPO):
        agent = create_population(cls.__name__, obs, act, population_size=1, seed=0,
                                  device="cpu")[0]
        assert agent.dev == torch.device("cpu")
        assert {p.device for p in agent.actors[next(iter(agent.actors))].params["head"][
            "output"].values()} == {agent.dev}
    evo = EvoIPPO(env, *cfgs, dist, adam(1e-3), num_envs=2, rollout_len=4, device="cpu")
    assert evo.init_population(0, 2).obs.device.type == "cpu"


def test_transformer_and_bandit_entry_points_default_to_the_card():
    """EvolvableGPT, EvolvableBERT, NeuralUCB, NeuralTS and
    create_population of the bandits take device=None as the card and raise
    without one; device="cpu" builds them on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from agilerl_tpu_torch.algorithms.neural_ts_bandit import NeuralTS
    from agilerl_tpu_torch.algorithms.neural_ucb_bandit import NeuralUCB
    from agilerl_tpu_torch.modules import EvolvableBERT, EvolvableGPT
    from agilerl_tpu_torch.utils.spaces import Box, Discrete
    from agilerl_tpu_torch.utils.utils import create_population

    gpt = dict(vocab_size=17, n_layer=1, n_head=2, d_model=16, max_seq_len=8)
    bert = dict(vocab_size=17, n_encoder_layers=1, n_decoder_layers=1, n_head=2, d_model=16,
                max_seq_len=8)
    obs, act = Box(-1.0, 1.0, (6,)), Discrete(3)
    makes = [lambda: EvolvableGPT(**gpt), lambda: EvolvableBERT(**bert),
             lambda: NeuralUCB(obs, act, seed=0), lambda: NeuralTS(obs, act, seed=0),
             lambda: create_population("NeuralUCB", obs, act, population_size=1, seed=0)]
    for make in makes:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert EvolvableGPT(**gpt, device="cpu").params["ln_f"].device.type == "cpu"
    assert EvolvableBERT(**bert, device="cpu").params["lm_head"].device.type == "cpu"
    agent = create_population("NeuralTS", obs, act, population_size=1, seed=0, device="cpu")[0]
    assert agent.dev == torch.device("cpu") and agent.U["head"]["output"]["bias"].device == \
        agent.dev
