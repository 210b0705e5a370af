"""LLM finetuning loops: the port of ``agilerl_tpu/training/train_llm.py``:
``finetune_llm_reasoning`` (GRPO over a ReasoningGym) and
``finetune_llm_preference`` (DPO over a PreferenceGym), each with the
per-epoch reference refresh, and tournament selection and hyperparameter
mutation every ``evaluation_interval`` steps.

Not ported yet, and raising when asked for: the ``telemetry=`` and
``resilience=`` hooks (observability and resilience layers), population
checkpoints and resume, and saving the elite.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.utils.utils import print_hyperparams, tournament_selection_and_mutation


def _assert_llm_mutations(mutation) -> None:
    """LLMs only mutate RL hyperparameters."""
    if mutation is None:
        return
    assert mutation.architecture_mut == 0, "architecture mutation must be 0 for LLMs"
    assert mutation.parameters_mut == 0, "parameter mutation must be 0 for LLMs"
    assert mutation.activation_mut == 0, "activation mutation must be 0 for LLMs"


def _refuse_unported(loop: str, **hooks) -> None:
    """The observability, resilience and checkpoint hooks are not ported yet."""
    for name, value in hooks.items():
        if value:
            raise NotImplementedError(f"{loop} {name}= is not ported yet")


def finetune_llm_reasoning(
    pop: List,
    env,
    INIT_HP: Optional[Dict] = None,
    max_reward: Optional[float] = None,
    wb: bool = False,
    evaluation_interval: int = 10,
    verbose: bool = True,
    accelerator=None,
    checkpoint_interval: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    overwrite_checkpoints: bool = False,
    max_steps: int = 200,
    evo_steps: Optional[int] = None,
    tournament=None,
    mutation=None,
    wandb_api_key: Optional[str] = None,
    save_elite: bool = False,
    elite_path: Optional[str] = None,
    resume: bool = False,
    telemetry=None,
    resilience=None,
) -> Tuple[List, List[List[float]]]:
    """GRPO reasoning finetune. Returns (population, per-agent fitnesses)."""
    _assert_llm_mutations(mutation)
    _refuse_unported("finetune_llm_reasoning", telemetry=telemetry, resilience=resilience,
                     wb=wb, resume=resume, checkpoint_path=checkpoint_path,
                     save_elite=save_elite)
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    prompts = env.reset()
    for step in range(1, max_steps + 1):
        for agent in pop:
            agent.set_reference_policy(env.num_epochs)
            completions, completion_mask = agent.get_action(prompts)
            ids, action_masks = env.assemble_learn_batch(completions, completion_mask)
            next_prompts, rewards = env.step(completions, completion_mask)
            loss, kl = agent.learn((ids, action_masks, rewards))
            agent.steps[-1] += int(np.asarray(rewards).size)
            if verbose:
                print(f"[{step}] agent {agent.index} loss {loss:.4f} "
                      f"reward {np.mean(rewards):.3f}")
            prompts = next_prompts

        stop = False
        if step % evaluation_interval == 0:
            fitnesses = [agent.test(env) for agent in pop]
            for i, f in enumerate(fitnesses):
                pop_fitnesses[i].append(f)
            if verbose:
                print(f"=== eval @ {step}: {[f'{f:.3f}' for f in fitnesses]}")
                print_hyperparams(pop)
            if tournament is not None and mutation is not None:
                pop = tournament_selection_and_mutation(pop, tournament, mutation,
                                                        language_model=True)
            stop = max_reward is not None and np.max(fitnesses) >= max_reward
        if stop:
            break
    return pop, pop_fitnesses


def finetune_llm_preference(
    pop: List,
    env,
    INIT_HP: Optional[Dict] = None,
    max_reward: Optional[float] = None,
    wb: bool = False,
    evaluation_interval: int = 10,
    verbose: bool = True,
    accelerator=None,
    checkpoint_interval: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    overwrite_checkpoints: bool = False,
    max_steps: int = 200,
    tournament=None,
    mutation=None,
    wandb_api_key: Optional[str] = None,
    save_elite: bool = False,
    elite_path: Optional[str] = None,
    resume: bool = False,
    telemetry=None,
    resilience=None,
) -> Tuple[List, List[List[float]]]:
    """DPO preference finetune. Returns (population, per-agent fitnesses)."""
    _assert_llm_mutations(mutation)
    _refuse_unported("finetune_llm_preference", telemetry=telemetry, resilience=resilience,
                     wb=wb, resume=resume, checkpoint_path=checkpoint_path,
                     save_elite=save_elite)
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    for step in range(1, max_steps + 1):
        batch = env.reset()
        for agent in pop:
            agent.set_reference_policy(env.num_epochs)
            loss, acc = agent.learn(batch)
            agent.steps[-1] += len(batch["chosen_ids"])
            if verbose:
                print(f"[{step}] agent {agent.index} dpo loss {loss:.4f} acc {acc:.3f}")

        stop = False
        if step % evaluation_interval == 0:
            fitnesses = [agent.test(env) for agent in pop]
            for i, f in enumerate(fitnesses):
                pop_fitnesses[i].append(f)
            if verbose:
                print(f"=== eval @ {step}: {[f'{f:.3f}' for f in fitnesses]}")
            if tournament is not None and mutation is not None:
                pop = tournament_selection_and_mutation(pop, tournament, mutation,
                                                        language_model=True)
            stop = max_reward is not None and np.max(fitnesses) >= max_reward
        if stop:
            break
    return pop, pop_fitnesses
