#!/usr/bin/env python3
"""Drive the PyTorch port (agilerl_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It imports neither jax nor agilerl_tpu. Phases, each
of which ends the run with a non-zero exit on any failure:

1. the device, and the card's name and power limit from nvidia-smi;
2. build every kernel of the port from agilerl_tpu_torch/csrc (one nvcc per
   source, all started together) through the compile cache
   (``parallel/compile_cache.py``) into a fresh store that every child
   process of the run then loads from, with each kernel's registers, shared
   memory and spills, and the count of wgmma (HGMMA), mma.sync (HMMA) and
   f32 FMA (FFMA) instructions in each of the four libraries where cuobjdump
   is present (the bf16 flash forward must show HGMMA and no HMMA, and its
   kernel of two warpgroups past head dim 256 no spill);
3. hold each kernel, forward and backward, against its plain PyTorch version
   on the card, over dtypes, masks, ragged lengths, head dims, GQA groups,
   the lse cotangent, vocab sizes and ragged row counts, with stated
   tolerances (the bf16 flash forward and backward also at T = 2048, with a
   kv tile of padding, q tiles wholly in padding and the model's strided
   GQA 32/8 views, and twice for bit-identical results; the fused dH and dW
   also at D = 200 with ragged row counts), the flash forward, dQ and dK/dV
   at head dims 16, 20, 32, 68, 72, 80, 96 and 256 (zero-padded to the
   built 64, 128 or 256) and past 256 at 272, 320, 384, 512, 768, 1,024 and
   1,088 (the wide kernels, d zero-padded to a multiple of 64; the bf16
   forward and dQ a block of two warpgroups a q tile up to 512, the bf16
   dK/dV one thread-block cluster of ceil(d / 128) blocks a kv tile up to
   1,024, each launch's kind read back from the library), and the 3xTF32
   operand split against its plain version bit for bit;
4. slice 1's path at llama3-8b, full width and depth, seeded random
   weights: sampled and greedy ``generate`` for 4 ragged prompts x group 4,
   then ``token_logprobs`` (fused kernel + flash kernel) over prompt +
   completion under two LoRA adapters; launch counts, finiteness, agreement
   with the plain path, and a small model checked against the CPU;
4b. slice 2's path on the same model: two GRPO iterations of ``get_action``
   -> a reward computed from the completion ids -> ``learn`` (old and
   reference passes, then the update through all four backward kernels);
   launch counts per learn, finite losses, a moved adapter, and the adapter
   gradient of one update through the kernels and through the plain path;
   the rollouts go through ``BucketedGenerator`` (``last_generation_info``);
4d. slice 3's path on the same weights: two ``DPO.learn`` calls on
   PreferenceGym batches of 8 preference pairs of seeded text (rows of at
   most 320 tokens), each timed as its reference passes and its update
   (flash forward, dQ, dK/dV and fused forward, dH; launch counts per
   learn), ``DPO.test`` over one eval batch, each of those kernels against
   its plain version at the learn's chosen and rejected shapes, and the
   adapter gradient of one update through the kernels and the plain path;
   then one f32 copy of the weights holds both adapter gradients (4b's and
   4d's) against an f32 run: the kernel path no further from it than twice
   the plain path;
4f. slice 4a's serving tier on the same bf16 weights: ``ContinuousGenerator``
   (8 slots, 32-token blocks, prompt buckets 64/128/256, 64 new tokens,
   decode chunks of 16) serving phase 4's 4 prompts x 4 repeats, greedy
   (held against phase 4's dense greedy rows: equal up to a first
   difference where the two tokens' dense logits lie within twice phase 4's
   kernel-vs-plain logprob spread), speculative (greedy, the repeat batch
   served twice so the completion cache drafts it), and sampled
   (temperature 1, top-k 50) with decode-captured logprobs held against
   ``token_logprobs`` through the flash and fused kernels and through the
   plain path; TTFT, decode time per token, tokens/s, prefix hits, free
   blocks after draining and the pool's size; then a small f32 model on the
   card against the CPU: continuous (plain and speculative) and bucketed
   greedy equal to dense greedy, a verify step at draft_len 0 equal to one
   decode step, captured logprobs equal to ``token_logprobs``;
4g. slice 4b on the same bf16 weights: a unified ``ServingFleet`` of 2
   replicas (4f's recipe, captured logprobs) serving 4f's 16 requests (held
   to 4f's single-generator rows by the near-tie rule; affinity, prefix hits
   per replica, TTFT, decode per replica step, tokens/s, free blocks,
   program count), the same batch with replica 1 killed after the first
   chunk, and the disaggregated topology on 4 of the requests (every prompt
   once; 1 prefill worker, KV through the transfer store:
   transfers, MB, export/import seconds, a warm repeat with no transfer),
   both held to the unified rows by the same rule; then
   ``finetune_llm_reasoning_online`` on the arithmetic recipe (16 rows, 64
   new tokens, staleness 1, 2 epochs) with the rollouts through the unified
   fleet under an ``AutoscalePolicy``: per epoch rollout and learner times,
   launches per learner step (flash forward, dQ, dK/dV, fused forward, dH)
   and per rollout (none: the fleet's captured logprobs stand in for the
   dense behavior forward, which is checked once after), stalls, stale
   drops, autoscale decisions, finite losses, a moving adapter, and each
   learner kernel against its plain version at a learner batch's shapes;
   then a small f32 model on the card against the CPU: unified,
   disaggregated and failover fleets, one generator and dense greedy
   token-identical, the staleness-0 flywheel equal to the interleaved loop
   and its batches through a learner on the CPU giving the card's adapter,
   and a weight bump flushing every replica's prefix cache;
4c. the evolution loop: ``finetune_llm_reasoning`` over a population of 2
   on the arithmetic ReasoningGym recipe, llama3-8b widths cut to 4 layers,
   through one tournament and one mutation round;
4e. the rest of slice 3 at small size: ``finetune_llm_preference`` over a
   population of 2 at llama3-8b widths cut to 4 layers, and the same loop
   at a small f32 size on the card against the CPU; one ILQL learn and its
   greedy and beam generation against the CPU; the HF checkpoint loader on
   both committed fixtures against their golden logits; an MoE forward with
   ``return_aux`` against the CPU;
4h. slice 5a, evolutionary PPO at configs/training/ppo.yaml's widths
   (CartPole-v1 as a ``TorchVecEnv`` of 16 envs, population 4, learn_step
   128, batch 256, 4 epochs, latent 32, hidden [64]; evo_steps cut from
   10,240 to 2,048 and max_steps from 200,000 to 4,096 = 2 generations):
   ``train_on_policy`` through
   ``create_population("PPO")`` and ``make_vect_envs`` (env-steps/s; per
   generation the seconds collecting, learning, evaluating and evolving, ms
   per learn, fitnesses, mutations; no kernel is on this path); on a clone
   of the elite one mutation of each class, each followed by a collect and
   a finite learn, with preserved slabs bit-equal and the buffer following
   learn_step; the host syncs of one collect_rollouts and one learn; both
   PPO probe checks; the env step, logp and value, GAE and one learn on the
   card against the CPU;
4i. slice 5e's head, the population as one program at bench.py's width
   (``EvoPPO`` through ``ScanRun``: CartPole-v1, population 64 x 128 envs x
   64 steps, latent 64, hidden [64], 1 epoch x 4 minibatches; 1 warm-up + 2
   timed generations): env-steps/s, the seconds of rollout, GAE + update
   and evolve, host syncs per generation (<= 1), peak memory, launches and
   the device's busy time of a profiled generation; a member alone against
   its slice of the batched iteration and one update on the card against
   the CPU; the JAX package's learning gate on seeds 0, 1, 2, each in a
   process of its own (``chip_smoke.py --population-gate SEED``), at least
   two passing;
4j. slice 5b: ``train_on_policy`` on configs/training/ppo/ppo_image.yaml
   (CNN on VisualCartPole-v0) and ppo_recurrent.yaml (LSTM, recurrent PPO)
   at their widths, evo_steps cut to 1,024 and max_steps to 2,048 (2
   generations of one collect + learn pair per agent); the recurrent memory
   gate on ``MemoryEnv``; each new
   encoder's apply on the card against the CPU;
4k. slice 5c-i: ``train_off_policy`` on configs/training/dqn/dqn_rainbow.yaml
   (Rainbow: PER + 3-step + C51 + noisy nets; CartPole-v1 as a
   ``TorchVecEnv`` of 16 envs, population 4, buffers of 20,000 rows;
   evo_steps cut from 10,000 to 768 and max_steps from 200,000 to 1,536
   = 2 generations): env-steps/s, per generation
   the seconds acting and stepping the env, dispatching the learn steps,
   waiting for the device, evaluating and evolving, fitnesses, peak memory;
   the host syncs of one ``learn_from_buffer`` (0) and per env step of the
   loop (<= 1), ms and launches per ``learn_from_buffer``; DQN's Q-learning
   probes (ConstantReward, ObsDependentReward, DiscountedReward, Policy)
   and Rainbow's on ConstantReward; a checkpoint round trip; one DQN, CQN
   and Rainbow learn and the PER sample on the card against the CPU (no
   kernel is on this path);
4l. slice 5c-ii: ``train_off_policy`` on configs/training/ddpg/ddpg.yaml
   (DDPG, OU noise) and td3.yaml (TD3) at their widths (Pendulum-v1 as a
   ``TorchVecEnv`` of 16 envs, population 4, batch 128, a 100,000-row
   buffer, latent 64, hidden [64]; evo_steps cut to 256 and max_steps to
   512 = 2 generations), DDPG once more on a PER buffer through the loop's
   sampled path (1 generation): env-steps/s and the parts of each
   generation; the host syncs of one DDPG ``learn_from_buffer`` (0) and per
   env step (<= 1), its ms and launches; both policy probes; a DDPG
   checkpoint round trip; one DDPG and one TD3 learn on the card against the
   CPU; then configs/training/cqn.yaml through ``train_offline`` on a
   20,000-row dataset that ``collect_offline_dataset`` collects on the
   device CartPole-v1 (evo_steps cut to 100, max_steps to 200 = 2
   generations);
4m. slice 5c-scan, the off-policy population as one program: bench.py's
   bench_anakin programs at its defaults (``EvoDQN`` on CartPole-v1 and
   ``EvoDDPG`` on Pendulum-v1, 8 envs x 256 steps, population 1; 1 warm-up
   + 2 timed generations through ``ScanRun``) beside the per-agent loop at
   the same widths; ``EvoDQN`` at the distributed harness's member widths at
   population 8; ``EvoRainbow`` and ``EvoTD3`` at a small width (one
   generation each); host syncs
   per generation (<= 1), the launches and busy share of one profiled
   generation (of EvoDQN at 64 ticks); a member alone against its batched
   slice; the cross-tier
   gate (the scan DQN's and DDPG's per-tick losses against the per-agent
   ``learn_from_buffer`` on the same transitions and draws, rtol 1e-4); one
   ``EvoDDPG`` generation on the card against the CPU (no kernel is on
   these paths);
4n. slice 5d, part A: ``train_multi_agent_off_policy`` on
   configs/training/multi_agent/maddpg.yaml (MADDPG) and matd3.yaml (MATD3)
   at their widths on ``SimpleSpreadTorch(n_agents=2)`` (a
   ``MultiAgentTorchVecEnv`` of 8 envs, population 4, batch 128, a
   100,000-row ``MultiAgentReplayBuffer``, latent 64, hidden [64];
   evo_steps cut to 120 and max_steps to 240 = 2 generations):
   env-steps/s and the parts of each generation; the host syncs of one
   learn (1, the loss read) and of the loop's vector steps without learns;
   ms and launches per learn; a discrete and a continuous MADDPG probe and
   MATD3's discounting probe; a MADDPG checkpoint round trip; one MADDPG and
   one MATD3 learn on the card against the CPU;
4o. slice 5d, part B: ``train_multi_agent_on_policy`` on ippo.yaml (IPPO,
   8 envs, population 4, learn_step 128, 4 epochs; evo_steps cut to 1,024
   and max_steps to 2,048 = 2 generations): env-steps/s, the host syncs of
   one ``collect_rollouts`` and one ``learn`` (1 each), the IPPO policy
   probes (FixedObsPolicyEnvMA; PolicyEnvMA on one of seeds 0-2); then
   ``EvoIPPO`` through ``ScanRun``
   (population 8 x 32 envs x 32 steps, 2 epochs x 2 minibatches, ippo.yaml's
   network widths; 1 warm-up + 2 timed generations): env-steps/s, host
   syncs per generation (<= 1), the launches and busy share of one profiled
   generation, a member alone against its batched slice, one generation's
   rollout and update on the card against the CPU (no kernel is on these
   paths);
4q. the evolvable transformers with flash on: ``EvolvableGPT`` at
   llm/presets.py's gpt2-small (12 layers x 12 heads, d 768, vocab 50,257,
   bf16 blocks, random weights from seed 0): forward and backward of
   next-token cross-entropy on 8 x 1,024 tokens (ms, peak memory, 12 + 12 +
   12 flash launches, ``estimate_mfu``), then add_node, add_layer,
   remove_node, remove_layer and add_expert on an MoE variant, each with the
   new head dim, the preserved slabs bit-equal, a step through the kernels
   and phase 4's agreement rule; the same preset at 2 heads of 256
   node-mutated by 32 to head dim 272 (the wide kernels): one step, its 12 +
   12 + 12 launches, the logprob rule and phase 4b's gradient rule against
   the plain path; the flash kernels' time at head dims 64,
   68, 80 and 128 (the padding's cost); ``EvolvableBERT`` at the
   Transformer-base widths (6 + 6 layers, d 512, 8 heads, vocab 37,000, T
   256) forward and backward and each mutation; a small f32 GPT (head dim
   20) and BERT on the card against the CPU;
4p. the contextual bandits: NeuralUCB and NeuralTS through
   ``train_bandits`` at configs/training/bandit/*.yaml's widths on their
   iris (tests/fixtures/iris/iris.csv; population 4, batch 64, a 10,000-row
   buffer, latent 32, hidden [64]; evo_steps cut to 125 and max_steps to
   250 = 2 generations): pulls/s, the parts of each generation, the best
   final fitness (>= 0.6), the host syncs, ms and launches of a pull and a
   learn; both on the card against the CPU at carried weights (arms, U, a
   learn's loss and weights);
4r. the PettingZoo path: a parallel-API env over one CPU SimpleSpreadTorch(2)
   vectorised by ``make_multi_agent_vect_envs`` in worker processes and in
   this one (8 envs), MADDPG through ``train_multi_agent_off_policy`` on each
   (maddpg.yaml's widths, evo_steps 120, max_steps 240): env-steps/s, the
   host syncs of a vector step, the workers' start-up seconds; then
   ``AsyncAgentsWrapper(RSNorm(MADDPG))`` over 2 envs (in this process)
   whose agent_1 dies mid-episode (no kernel is on 4p or 4r);
4s. the resilience facade: GRPO through ``finetune_llm_reasoning`` with
   ``resilience=`` at llama3-8b (full width and depth, bf16 blocks, char
   vocab, LoRA rank 8; population 2 on one base, data batch 2, group 4, 16
   new tokens, eval every 2 steps with a tournament and RL-HP mutation):
   run A takes 3 steps; run B is sent a real SIGTERM during step 2 and ends
   with one preempt snapshot (its bytes on disk, its save seconds, no base
   weights in it); run C, a fresh population from the same seeds, resumes
   it (resume seconds) and must equal run A: completions token for token,
   losses, rewards, fitnesses, actor and reference adapters and Adam
   moments bit for bit (launches of #1, #3, #4, #5, #6 counted over A, B,
   C; each kernel against its plain version at the learn's shapes, and
   twice on the same inputs for bit-identical output); ``train_off_policy``
   DQN at dqn.yaml's widths on the device CartPole with a crash injected
   into the second snapshot's commit, resumed from the first to the
   uninterrupted run's fitness stream and weights; ``ScanRun(EvoPPO)`` at
   4i's widths snapshotted after 1 generation and resumed into another
   seed, 2 generations bit-equal; ``MakeEvolvable`` of a torch.nn MLP and
   CNN on the card against the module;
4t. the stack as supervised OS processes (``training/launch.py``,
   ``resilience/proc.py``): GRPO at llama3-8b as in 4s (full depth, char
   vocab, data batch 2 x group 4, 16 new tokens; rollouts on the continuous
   tier with captured logprobs), staleness 0, 4 epochs: (a) the in-process
   ``OnlineGRPOFlywheel`` of two clones from one seed; (g) its learner's
   adapters through ``save_llm_checkpoint`` / ``load_llm_checkpoint`` (DCP)
   bit for bit, bytes and seconds; (b) ``launch_flywheel`` with learner and
   rollout each an OS process on the card, its loss stream and final adapter
   equal to (a) bit for bit, seconds per epoch, clean exits and no orphans;
   (e) the learner process's kernel launches (#1, #3-#6) and both children's
   peak memory, read back through the telemetry plane (the rollout launches
   none); (c) ``kill -9`` of the learner once epoch 2 is published: respawned
   as incarnation 1, restored from the store, the final stream equal to (a)
   bit for bit, the seconds from the kill to its first published epoch; (d)
   ``shutdown()`` mid-run: every role preempted or done, no process left, the
   drain seconds; (h) ``grpo_hbm_budget`` at fsdp = tp = 1 and phase 4b's
   shapes beside 4b's learn peak, its base term equal to the bytes the base
   allocates and its KV term to the dense cache ``generate`` allocates; (f)
   ``TrafficDriver`` over a 2-replica ``ServingFleet`` at llama3-8b on
   ``scenario_suite``'s four shapes (5 virtual seconds at 4 requests/s),
   then the flash crowd with replica 1 killed: every request completes, TTFT
   p50 / p95;
4u. sharding plans and long context (GRPO.to_mesh on the one-card mesh, the
   sp learn, the ring on two ranks sharing the card, the pod generation on
   a one-rank mesh; see the phase's comment);
4v. several hosts: (a) the GPipe pipeline (``parallel/pipeline.py``) at
   llama3-8b width, 8 layers, f32, on two ranks sharing the card over gloo,
   its logits, loss and every gradient against the plain ``apply`` at
   world size 1; (b) elastic EvoPPO (``parallel/elastic.py``) at 4i's
   widths in one process, a host killed at a snapshot boundary and
   recovered bit for bit; (c) one pod-mode controller per rank on two
   ranks, the stream of (b), a SIGKILLed rank detected by the bounded
   watchdog and the run resumed at world size 1 through
   ``train_elastic_pbt(resume=True)`` bit for bit (no kernel is on 4v);
4w. the port's tooling (``analysis/``, ``parallel/compile_cache.py``,
   ``parallel/layout_search.py``): (a) a child process loads the four
   libraries from phase 2's store with no nvcc build (``CompileGuard()``),
   launches #1 and #5 once against their plain versions, and skips a planted
   torn entry and a planted sha mismatch in a copy of the store; (b) at
   llama3-8b, ``SyncGuard`` on a GRPO learn against the script's former
   counter, ``CompileGuard(gen)`` over a ragged bucket stream through
   ``BucketedGenerator`` (a planted new bucket raises) and ``CompileGuard()``
   over a learn (no build), and in 4k ``SyncGuard(max_syncs=0)`` on the fused
   ``learn_from_buffer``; (c) ``search_layouts`` over the default one-device
   plan and 4u (a)'s plan on 4u (a)'s agent; (d) ``python -m
   agilerl_tpu_torch.analysis`` exits 0 against the committed baseline (see
   the phase's comment);
4x. per-block remat and KV caches placed by a plan: (a) on 4b's model and
   last batch, two GRPO learns with ``remat=False`` and two with
   ``remat=True`` from the same fresh adapters: losses and adapters
   within 4u (a)'s bound (and whether bit for bit), launches (#1 4 x 32
   with remat, 3 x 32 without), host syncs (equal), peaks and times; (b) one
   remat learn at 16 rows x 1,024 tokens (a built batch): its peak under
   the card's memory, beside ``grpo_hbm_budget`` and the eager peak that
   (a)'s bytes per token predict (4t (h) reads (a)'s remat peak); (c)
   ``BucketedGenerator`` and ``ContinuousGenerator`` under
   ``make_grpo_plan(tp=2)`` on two ranks sharing the card over gloo
   (``chip_smoke.py --serve-rank``), llama3-8b widths cut to 4 layers, f32:
   greedy tokens equal to one rank's unplaced run, each rank's dense cache
   and pool half of the whole, no all-gather of a tp-sharded weight; then
   both generators under ``make_grpo_plan(fsdp=2)`` at Qwen2-0.5B's widths
   (2 f32 layers, 4 new tokens): tokens equal to the unplaced run, half of
   every sharded weight a rank, only ``comm.all_gather_cat`` gathers; and a
   GRPO learn under that plan against the unplaced learn (loss, the
   gradient handed to the optimizer, launches); (d) ``grpo-tp4`` over
   Qwen2-0.5B's 14 query and 2 KV heads, 2 f32 layers, on four gloo ranks
   of the card (``chip_smoke.py --uneven-rank``): both generators' tokens
   (8 prompts x 16 new) and a placed learn against rank 0's unplaced run,
   attention whole over tp, and what that costs a rank; then a learn under
   ``make_grpo_plan(fsdp=2, tp=2)`` on the same four ranks against the same
   unplaced learn; (a) and (b) run
   after 4d (beside the second process's phases), (c) after 4v (a), (d)
   last in the second process. The earlier phases pass
   ``remat=False`` to the presets (which now default to remat), so their
   numbers stay comparable;
5. each kernel's time at the main path's shapes beside its plain version,
   one PyTorch library call computing the same function, and its bound (for
   the fused forward, dH and dW: the 3xTF32 tensor-core bound and the f32
   FMA bound, and each one's operand preparation; for flash, the bytes read
   counted from the mask: only the rows and keys that meet a visible key);
   the flash forward and backward also on one unmasked causal row at
   T = 2048 and, for the wide kernels, at [8, 2, 1,024, 512] and at 4q's
   [8, 2, 1,024, 320], with the kind of kernel each ran; SDPA
   (forward, or backward) on each of its backends that takes the inputs, in
   rounds with the SM clock read after each.

Phases 4h-4r but 4q, then 4v (b) and (c) and 4x (d), need nothing of the LLM phases: a
second process runs them, in that order, alongside 4f-4t (it starts after 4d; its log is printed
when it ends, before 4q and phase 5 run on their own), so their host times
and those of 4f-4t are taken on a shared host. 4x (d) starts only once the
main side's 4v (a) has ended (``RL_PHASE_AFTER``: their six ranks together
overflow the card's memory).

Prints a ``report: {...}`` line with every number the run took, then a
``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --flash-fwd-rows ROOT OUT.json

times only the bf16 flash forward at phase 5's wide rows and at d = 128 on
one unmasked causal row at T = 2048, with ``agilerl_tpu_torch`` imported
from the checkout at ROOT, and writes the rows to OUT.json. Run on two
checkouts in turns in one call (parent, change, change, parent), it
compares two versions of the kernel on one card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
# f32: outside the tensor cores; tf32: dense, on the tensor cores
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}

GROUP_SIZE = 4
PROMPT_LENS = (64, 128, 200, 256)
MAX_NEW_TOKENS = 64
LORA_RANK = 8

# End-to-end, the kernel path (flash + fused) and the plain path (dense
# attention + chunked logprobs) of the bf16 8B model differ by bf16 rounding
# at different places (the dense path rounds the scores to bf16, the flash
# kernel keeps them f32 and rounds p), carried through 32 layers. Both are
# held against an f32 run of the same (bf16-valued) weights: the kernel path
# must be no further from it than the plain path, within these factors. The
# fused kernel alone, on the same hidden states, must agree with the chunked
# path to f32 summation order.
E2E_MEAN_FACTOR = 1.5
E2E_MAX_FACTOR = 2.0
E2E_FLOOR = 1e-3  # f32 summation order, where the plain path is exact
FUSED_E2E_ATOL = 1e-3
SMALL_MODEL_ATOL = 1e-4  # f32 small model, card kernels vs CPU plain path

# Backward kernels vs their plain versions: f32 at the repo's flash (5e-4)
# and fused (2e-4) gradient tolerances (summation order); bf16 at 1 % of the
# output's largest magnitude (one bf16 rounding of the output, and of p or dS
# where their f32 values straddle a bf16 step).
FLASH_BWD_ATOL_F32 = 5e-4
FLASH_BWD_REL_BF16 = 1e-2
FUSED_BWD_ATOL = 2e-4
# The adapter gradient of one GRPO update (4 rows) through the kernels must
# be no further from an f32 run's than GRAD_FACTOR x the plain bf16 path's,
# in relative L2 over all adapter entries (+ GRAD_FLOOR for summation order).
GRAD_FACTOR = 2.0
GRAD_FLOOR = 1e-2
EVO_LAYERS = 4  # phase 4c: llama3-8b widths, cut to 4 layers


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_clocks() -> str:
    """SM clock, power draw and temperature right after a timed phase."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean time of one call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_abba(torch, fns, iters, clocks=None):
    """Mean ms of each named function over two rounds, the second in reverse
    order (a, b, c, c, b, a), so a drift of the card's clock during the
    phase weighs on every function alike. Returns {name: [round1, round2]};
    a list given as ``clocks`` gets nvidia-smi's SM clock, power and
    temperature after each round."""
    rounds = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            rounds[name].append(cuda_ms(torch, fns[name], iters[name]))
        if clocks is not None:
            clocks.append(nvidia_smi_clocks())
    return rounds


def host_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound(flops: float, nbytes: float, kind: str):
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tf32x3_bounds(flops: float, nbytes: float):
    """For `flops` f32 operations done in 3xTF32: (bound ms, bound_by) of
    the 3 x flops of TF32 tensor-core work, and the bound ms of the same f32
    operations on the FMA units."""
    b_ms, b_by = bound(3.0 * flops, nbytes, "tf32")
    return b_ms, b_by, bound(flops, nbytes, "f32")[0]


SASS_OPS = ("HGMMA", "HMMA", "FFMA")  # wgmma, mma.sync, f32 FMA


def ptxas_entries(text, name):
    """What ptxas reported (nvcc -Xptxas -v) for each kernel whose mangled
    name holds `name` (each template instance): a list of its registers,
    stack frame and spill bytes, in the log's order."""
    found, got = [], None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            got = {} if name in entry.group(1) else None
            if got is not None:
                found.append(got)
        elif got is not None:
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
            if spill:
                got.update(stack=int(spill[1]), spill_stores=int(spill[2]),
                           spill_loads=int(spill[3]))
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                got["registers"] = int(regs[1])
    return found


def sass_counts(_build, names):
    """{library: {op: count}} of SASS_OPS in each built library's SASS
    (cuobjdump), or None where the toolkit has no cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for n in names:
        try:
            sass = subprocess.run([tool, "-sass", str(_build.library_path(n))],
                                  capture_output=True, text=True, timeout=120).stdout
        except OSError:
            counts[n] = None
            continue
        counts[n] = {op: len(re.findall(rf"\b{op}[\s.]", sass)) for op in SASS_OPS}
    log(f"  SASS instructions (cuobjdump -sass): {counts}")
    fwd = counts.get("flash_attention_fwd")
    if fwd is not None:
        check(fwd["HGMMA"] > 0 and fwd["HMMA"] == 0,
              f"flash_attention_fwd: expected wgmma and no mma.sync, got {fwd}")
    return counts


# ------------------------------- phase 3 ----------------------------------- #


def check_flash(torch, tfa, report):
    """Kernel vs plain version over dtype x causal x mask at ragged T=200,
    d=128, GQA 4 over 2 heads, plus head_dim 64; real query rows only."""
    atol = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
    why = {torch.float32: "f32 summation order and expf",
           torch.bfloat16: "bf16 output rounding, p rounded to bf16 at another max"}
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for masked in (False, True):
                for T, d in ((200, 128), (96, 64)):
                    B, H, Hkv = 3, 4, 2
                    q = torch.randn(B, H, T, d, device="cuda", generator=g).to(dtype)
                    k = torch.randn(B, Hkv, T, d, device="cuda", generator=g).to(dtype)
                    v = torch.randn(B, Hkv, T, d, device="cuda", generator=g).to(dtype)
                    mask = None
                    rows = torch.ones(B, T, dtype=torch.bool, device="cuda")
                    if masked:  # left padding
                        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
                        mask[1, :37] = 0
                        mask[2, :T - 5] = 0
                        rows = mask.bool()
                    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
                    ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, causal)
                    torch.cuda.synchronize()
                    err = lerr = 0.0
                    for b in range(B):
                        r = rows[b]
                        err = max(err, (out[b][:, r].float() - ref[b][:, r].float())
                                  .abs().max().item())
                        lerr = max(lerr, (lse[b][:, r] - ref_lse[b][:, r]).abs().max().item())
                    case = f"{str(dtype)[6:]} causal={causal} mask={masked} T={T} d={d}"
                    log(f"  flash {case}: max|out-plain| {err:.3e} (tol {atol[dtype]:.0e}: "
                        f"{why[dtype]}), max|lse-plain| {lerr:.3e} (tol 1e-04: f32 sums)")
                    check(err <= atol[dtype] and lerr <= 1e-4, f"flash kernel disagrees: {case}")
                    check(bool(torch.isfinite(out.float()).all()), f"flash non-finite: {case}")
                    worst[case] = err
    report["flash_checks"] = worst


def flash_inputs(torch, B, H, Hkv, T, d, dtype, strided, g):
    """q [B, H, T, d], k and v [B, Hkv, T, d]; strided: [B, T, heads, d]
    storage seen through transpose(1, 2), as the model passes them."""
    shape = (lambda n: (B, T, n, d)) if strided else (lambda n: (B, n, T, d))
    q, k, v = (torch.randn(shape(n), device="cuda", generator=g).to(dtype) for n in (H, Hkv, Hkv))
    return tuple(t.transpose(1, 2) for t in (q, k, v)) if strided else (q, k, v)


def rows_with_a_visible_key(tfa, mask, causal, B, T):
    """[B, 1, T] bool: query rows that see at least one key."""
    import torch
    return tfa._visible(T, mask, causal, torch.device("cuda")).expand(B, 1, T, T).any(-1)


# bf16 flash cases of the wgmma kernels beyond check_flash's grid: long T,
# a kv tile of padding (row 1: keys 64..127) beside left padding over two
# whole q tiles (row 0, 150 keys: those tiles visit no kv tile), first visible
# keys on the skip rule's edges, and the model's strided views at GQA 32/8
# with the learn step's left padding. (B, H, Hkv, T, d, left pads, hole, strided)
FLASH_BF16_CASES = {
    "T=2048 d=128 GQA 8/2": (1, 8, 2, 2048, 128, None, False, False),
    "T=2048 d=64 GQA 4/1": (1, 4, 1, 2048, 64, None, False, False),
    "padding kv tile + padding q tiles": (2, 4, 2, 200, 128, (150, 0), True, False),
    "first keys on tile edges": (3, 4, 2, 200, 64, (63, 199, 127), False, False),
    "model views GQA 32/8": (4, 32, 8, 320, 128, (192, 128, 56, 0), False, True),
}


def flash_bf16_mask(torch, B, T, pads, hole):
    if pads is None:
        return None
    mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    for b, n in enumerate(pads):
        mask[b, :n] = 0
    if hole:
        mask[1, 64:128] = 0
    return mask


def check_flash_bf16_cases(torch, tfa, report):
    """The bf16 forward on FLASH_BF16_CASES, causal and not: rows with a
    visible key against the plain version (out 2e-2, lse 1e-4); rows with
    none come out 0 with lse = -1e30 + log(1e-30); every row finite. Then two
    launches at the model's views, bit-identical."""
    import math

    g = torch.Generator(device="cuda").manual_seed(13)
    worst = {}
    empty_lse = torch.tensor(-1e30, dtype=torch.float32) + math.log(1e-30)
    for name, (B, H, Hkv, T, d, pads, hole, strided) in FLASH_BF16_CASES.items():
        q, k, v = flash_inputs(torch, B, H, Hkv, T, d, torch.bfloat16, strided, g)
        mask = flash_bf16_mask(torch, B, T, pads, hole)
        for causal in (True, False):
            out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
            ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, causal)
            torch.cuda.synchronize()
            r = rows_with_a_visible_key(tfa, mask, causal, B, T).expand(lse.shape)
            err = (out[r].float() - ref[r].float()).abs().max().item()
            lerr = (lse[r] - ref_lse[r]).abs().max().item()
            case = f"bfloat16 causal={causal} {name}"
            n_empty = int((~r).sum())
            log(f"  flash {case}: max|out-plain| {err:.3e} (tol 2e-02), max|lse-plain| "
                f"{lerr:.3e} (tol 1e-04) over rows with a visible key; {n_empty} rows "
                f"without one")
            check(err <= 2e-2 and lerr <= 1e-4, f"flash kernel disagrees: {case}")
            check(bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()),
                  f"flash non-finite: {case}")
            check(not out[~r].any() and bool((lse[~r] == empty_lse).all()),
                  f"flash rows without a visible key are not out = 0, lse = -1e30: {case}")
            worst[case] = err
    runs = [tfa.flash_attention_fwd_cuda(q, k, v, mask, True) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1]),
          "two launches of the bf16 flash forward differ")
    log("  flash bf16 [4, 32/8, 320, 128] model views, learn padding: two launches "
        "bit-identical (out, lse)")
    report["flash_bf16_checks"] = worst


# (V, N) of the fused checks: the learn shapes, a vocab that is no tile
# multiple, and row counts below, at and past one 128-row tile
FUSED_CASES = ((128_256, None), (50_257, 1000), (50_257, 129), (50_257, 65), (50_257, 1))


def check_split(torch, tfl, report):
    """The 3xTF32 operand split (tf32x3_split) against split_tf32, bit for
    bit, plain and transposed, with a padded row stride."""
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(300, 201, device="cuda", generator=g) * 10.0 ** torch.randint(
        -5, 5, (300, 201), device="cuda", generator=g)
    for transpose, ld in ((False, 0), (False, 204), (True, 0), (True, 304)):
        hi, lo = tfl._split_cuda(x, transpose=transpose, ld=ld)
        want_hi, want_lo = tfl.split_tf32(x, transpose=transpose, ld=ld)
        torch.cuda.synchronize()
        check(torch.equal(hi, want_hi) and torch.equal(lo, want_lo),
              f"tf32x3_split differs from split_tf32 (transpose={transpose}, ld={ld})")
    log("  tf32x3_split: hi/lo bit for bit equal to split_tf32 (plain and transposed, each "
        "also with a padded row stride)")
    report["split_check"] = "bit-exact"


def check_fused(torch, tfl, report, n_rows, d_model):
    """Kernel vs plain version at the scoring shapes: V = 128,256 and a V
    that is not a tile multiple (50,257), ragged row counts, temperature 1.0
    and 1.7."""
    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for V, N in FUSED_CASES:
        N = N or n_rows
        h = torch.randn(N, d_model, device="cuda", generator=g)
        w = 0.02 * torch.randn(d_model, V, device="cuda", generator=g)
        t = torch.randint(0, V, (N,), device="cuda", generator=g)
        for temp in (1.0, 1.7):
            got, lse = tfl.fused_logprob_fwd_cuda(h, w, t, temp)
            want, want_lse = tfl._plain_fwd(h, w, t, temp)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lerr = (lse - want_lse).abs().max().item()
            case = f"N={N} V={V} T={temp}"
            log(f"  fused {case}: max|lp-plain| {err:.3e}, max|lse-plain| {lerr:.3e} "
                f"(tol 1e-04: 3xTF32 products, f32 sums in another order)")
            check(err <= 1e-4 and lerr <= 1e-4, f"fused kernel disagrees: {case}")
            worst[case] = err
        del h, w, t
    report["fused_checks"] = worst


def flash_bwd_inputs(torch, tfa, B, H, Hkv, T, d, dtype, mask, causal, with_lse, g):
    q = torch.randn(B, H, T, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Hkv, T, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Hkv, T, d, device="cuda", generator=g).to(dtype)
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
    dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
    dd = (dout.float() * out.float()).sum(-1)
    if with_lse:  # an lse cotangent enters as D - dlse
        dd = dd - torch.randn(lse.shape, device="cuda", generator=g)
    return q, k, v, dout, lse, dd.contiguous()


def bwd_error(torch, got, want, dtype):
    """(max |kernel - plain|, tolerance) for one backward output."""
    err = (got.float() - want.float()).abs().max().item()
    tol = (FLASH_BWD_ATOL_F32 if dtype == torch.float32
           else FLASH_BWD_REL_BF16 * want.float().abs().max().item())
    return err, tol


def flash_bwd_case(torch, tfa, worst, g, B, H, Hkv, T, d, dtype, mask, causal, with_lse, case):
    """dQ and dK/dV kernels vs the plain backward on one case; returns (dk, dv)."""
    q, k, v, dout, lse, dd = flash_bwd_inputs(torch, tfa, B, H, Hkv, T, d, dtype, mask, causal,
                                              with_lse, g)
    dq = tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, causal)
    dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, causal)
    want = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, causal)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err, tol = bwd_error(torch, got, ref, dtype)
        check(bool(torch.isfinite(got.float()).all()), f"flash backward non-finite {name}: {case}")
        check(err <= tol, f"flash {name} kernel disagrees ({err} > {tol}): {case}")
        errs[name] = (err, tol)
    log(f"  flash bwd {case}: " + ", ".join(
        f"{n} {e:.2e} (tol {t:.1e})" for n, (e, t) in errs.items()))
    worst[case] = {n: e for n, (e, _) in errs.items()}
    return dk, dv


def check_flash_bwd(torch, tfa, report):
    """dQ and dK/dV kernels vs the plain backward over dtype x causal x mask x
    (ragged T, head_dim, GQA group of 4 or 2) x lse cotangent; then the bf16
    kernels at T = 2048 and with a kv tile of padding, and twice at the learn
    shape for bit-identical results."""
    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            for masked in (False, True):
                for T, d, H, Hkv, with_lse in ((200, 128, 8, 2, False), (96, 64, 4, 2, True),
                                               (77, 128, 4, 2, True), (130, 64, 8, 2, False)):
                    B = 3
                    mask = None
                    if masked:  # left padding, one row all but 5 keys
                        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
                        mask[1, :37] = 0
                        mask[2, :T - 5] = 0
                    flash_bwd_case(torch, tfa, worst, g, B, H, Hkv, T, d, dtype, mask, causal,
                                   with_lse, f"{str(dtype)[6:]} causal={causal} mask={masked} "
                                   f"T={T} d={d} GQA {H}/{Hkv} lse_cotangent={with_lse}")
    # T = 2048: 32 tile products per output tile, 4 heads per GQA group; and a
    # kv tile whose keys are all padding (row 1: keys 64..127) beside left
    # padding past two tiles (row 0)
    for causal in (True, False):
        for T, d, H, Hkv, hole in ((2048, 128, 8, 2, False), (2048, 64, 4, 1, False),
                                   (200, 128, 4, 2, True)):
            mask = None
            if hole:
                mask = torch.ones(2, T, dtype=torch.int32, device="cuda")
                mask[0, :150] = 0
                mask[1, 64:128] = 0
            case = f"bfloat16 causal={causal} T={T} d={d} GQA {H}/{Hkv}" + (
                " masked kv tile" if hole else "")
            dk, dv = flash_bwd_case(torch, tfa, worst, g, 2, H, Hkv, T, d, torch.bfloat16, mask,
                                    causal, False, case)
            if hole:
                check(not dk[1, :, 64:128].any() and not dv[1, :, 64:128].any(),
                      f"the all-padding kv tile got a non-zero dK/dV: {case}")
    # determinism: two launches at the learn step's shape and padding
    B, T = 16, max(PROMPT_LENS) + MAX_NEW_TOKENS
    mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, :max(PROMPT_LENS) - PROMPT_LENS[b // GROUP_SIZE]] = 0
    q, k, v, dout, lse, dd = flash_bwd_inputs(torch, tfa, B, 32, 8, T, 128, torch.bfloat16,
                                              mask, True, False, g)
    runs = [(tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True),
             *tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "two launches of the bf16 flash backward differ")
    log("  flash bwd bf16 [16, 32/8, 320, 128], learn padding: two launches bit-identical "
        "(dQ, dK, dV)")
    log("  flash bwd tolerances: f32 5e-4 (summation order); bf16 1 % of the plain "
        "output's max (bf16 rounding of the output and of p / dS)")
    report["flash_bwd_checks"] = worst
    report["flash_bwd_deterministic"] = True


# Head dims past the built 64 / 128 (run zero-padded to 64, 128 or 256) and
# 256 itself: the tutorials' small models (16, 20, 32), the evolvable GPT's
# node mutations at gpt2-small (68, 72, 80) and 96; past 256 the wide
# kernels (d zero-padded to a multiple of 64; the bf16 forward and dQ a
# block of two warpgroups a q tile up to 512, the bf16 dK/dV one cluster of
# ceil(d / 128) blocks a kv tile up to 1,024): an EvolvableGPT at 2 heads of
# 512 after +32 (272, cluster 3), 320, 384, 512 (4), 768 (6), 1024 (8: the
# default max_d_model with one head), and 1088, past the cluster limit.
PADDED_HEAD_DIMS = (16, 20, 32, 68, 72, 80, 96, 256, 272, 320, 384, 512, 768, 1024, 1088)


def check_flash_head_dims(torch, tfa, report):
    """Flash forward, dQ and dK/dV at PADDED_HEAD_DIMS, f32 and bf16, causal,
    with a ragged mask and GQA 4/2, against the plain versions at the true d
    (forward: check_flash's tolerances over rows with a visible key; backward:
    bwd_error's); every call counted as a launch; bf16 repeated for
    bit-identical results."""
    from agilerl_tpu_torch.ops import kernel_counters, reset_kernel_counters

    g = torch.Generator(device="cuda").manual_seed(14)
    atol = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
    worst = {}
    B, H, Hkv, T = 3, 4, 2, 150
    mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
    mask[1, :37] = 0
    mask[2, :T - 5] = 0
    r = rows_with_a_visible_key(tfa, mask, True, B, T).expand(B, H, T)
    for d in PADDED_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            hd = tfa.flash_head_dim_plan(d)
            case = f"{str(dtype)[6:]} d={d} (run at {hd})"
            q, k, v = flash_inputs(torch, B, H, Hkv, T, d, dtype, True, g)
            reset_kernel_counters()
            out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, True)
            dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
            dd = (dout.float() * out.float()).sum(-1).contiguous()
            dq = tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True)
            dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True)
            torch.cuda.synchronize()
            counts = kernel_counters()
            check(counts["flash_attention_fwd"] == counts["flash_attention_dq"] ==
                  counts["flash_attention_dkv"] == 1, f"flash kernels not launched: {case}")
            # what the library launched, read back from it; the bf16 wide
            # kernels are to compute the scores once a tile: the forward and
            # dQ a block of two warpgroups up to 512, dK/dV a cluster of
            # ceil(d / 128) up to 1,024
            fwd = tfa.flash_fwd_last_launch()
            ran = {n: tfa.flash_bwd_last_launch(n) for n in ("dq", "dkv")}
            case += f", fwd {fwd['kind']}" + "".join(
                f", {n} {r['kind']}" + (f" x{r['cluster']}" if r["cluster"] > 1 else "")
                for n, r in ran.items())
            if dtype == torch.float32:
                want_fwd = ("f32", 256) if hd <= 256 else ("column_groups_f32", 256)
            elif hd <= 256:
                want_fwd = ("wgmma", 160)
            else:
                want_fwd = ("fwd_split", 256) if hd <= 512 else ("column_groups", 160)
            check((fwd["kind"], fwd["threads"]) == want_fwd,
                  f"flash forward launched {fwd}, not {want_fwd}: {case}")
            if dtype == torch.bfloat16 and hd > 256:
                want_dq = "dq_split" if hd <= 512 else "column_groups"
                want_dkv = ("dkv_cluster", -(-hd // 128)) if hd <= 1024 else ("column_groups", 1)
                check(ran["dq"]["kind"] == want_dq and
                      (ran["dkv"]["kind"], ran["dkv"]["cluster"]) == want_dkv,
                      f"wide backward launched {ran}, not dQ {want_dq}, dK/dV {want_dkv}: {case}")
            ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, True)
            want = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, True)
            check(out.shape == q.shape and dq.shape == q.shape and dk.shape == k.shape,
                  f"flash output shapes: {case}")
            err = (out[r].float() - ref[r].float()).abs().max().item()
            lerr = (lse[r] - ref_lse[r]).abs().max().item()
            check(err <= atol[dtype] and lerr <= 1e-4,
                  f"flash forward disagrees ({err}, {lerr}): {case}")
            errs = {"out": err, "lse": lerr}
            for name, got, ref_g in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                e, tol = bwd_error(torch, got, ref_g, dtype)
                check(bool(torch.isfinite(got.float()).all()) and e <= tol,
                      f"flash {name} disagrees ({e} > {tol}): {case}")
                errs[name] = e
            if dtype == torch.bfloat16:
                again = (tfa.flash_attention_fwd_cuda(q, k, v, mask, True)[0],
                         tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True),
                         *tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip((out, dq, dk, dv), again)),
                      f"two launches differ: {case}")
            log(f"  flash head dim {case}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                + (", repeats bit-identical" if dtype == torch.bfloat16 else ""))
            worst[case] = errs
    report["flash_head_dim_checks"] = worst


def check_fused_bwd(torch, tfl, report, n_rows, d_model):
    """dH and dW kernels vs the plain backward at the learn shapes (V =
    128,256), at a vocab that is no tile multiple (50,257) and at ragged row
    counts, temperature 1.0 and 1.7; then at D = 200 (no multiple of the
    32-deep stage) with N = 1, 65, 129, 300 (dW's contraction: ragged, and
    its transposed operands' rows padded)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {}
    cases = [(V, N or n_rows, d_model) for V, N in FUSED_CASES] + [
        (50_257, N, 200) for N in (1, 65, 129, 300)]
    for V, N, D in cases:
        h = torch.randn(N, D, device="cuda", generator=g)
        w = 0.02 * torch.randn(D, V, device="cuda", generator=g)
        t = torch.randint(0, V, (N,), device="cuda", generator=g)
        up = torch.randn(N, device="cuda", generator=g)
        for temp in (1.0, 1.7):
            _, lse = tfl.fused_logprob_fwd_cuda(h, w, t, temp)
            case = f"N={N} D={D} V={V} T={temp}"
            errs = []
            for name, kern, plain in (("dH", tfl.fused_logprob_dh_cuda, tfl.plain_dh),
                                      ("dW", tfl.fused_logprob_dw_cuda, tfl.plain_dw)):
                got = kern(h, w, t, lse, up, temp)
                want = plain(h, w, t, lse, up, temp)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(err <= FUSED_BWD_ATOL, f"fused {name} kernel disagrees ({err}): {case}")
                errs.append(err)
                del got, want
            log(f"  fused bwd {case}: max|dH-plain| {errs[0]:.3e}, max|dW-plain| {errs[1]:.3e} "
                f"(tol {FUSED_BWD_ATOL:.0e}: 3xTF32 products, sums in another order)")
            worst[case] = max(errs)
        del h, w, t, up
        torch.cuda.empty_cache()
    report["fused_bwd_checks"] = worst


# ------------------------------- phase 4 ----------------------------------- #


def make_adapter(torch, M, cfg, seed):
    lora = M.init_lora(seed, cfg, rank=LORA_RANK, targets=("wq", "wv"))
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    for layer in lora["blocks"].values():
        for ab in layer.values():  # B non-zero so the adapter matters
            ab["B"].normal_(0.0, 0.02, generator=g)
    return lora


def small_model_check(torch, M, ops, report):
    """A small f32 model through the kernels on the card vs its plain path on
    the CPU (which the CPU tests tie to the JAX package)."""
    cfg = M.GPTConfig(vocab_size=1000, n_layer=2, n_head=4, n_kv_head=2, d_model=256,
                      max_seq_len=128, tie_embeddings=False, dtype=torch.float32)
    params = M.init_params(7, cfg, device="cpu")
    lora = M.init_lora(8, cfg, device="cpu")
    gb = torch.Generator().manual_seed(9)
    for layer in lora["blocks"].values():
        for ab in layer.values():
            ab["B"].normal_(0.0, 0.05, generator=gb)
    tokens = torch.randint(1, 1000, (3, 40), generator=torch.Generator().manual_seed(3))
    mask = torch.ones_like(tokens, dtype=torch.int32)
    mask[1, :9] = 0
    mask[2, :30] = 0
    tokens = tokens * mask
    to_cuda = lambda tree: {k: to_cuda(v) if isinstance(v, dict) else v.cuda()  # noqa: E731
                            for k, v in tree.items()}
    cpu = M.token_logprobs(cfg, params, tokens, mask, lora=lora, use_fused=True, flash=True)
    before = ops.kernel_counters()
    gpu = M.token_logprobs(cfg, to_cuda(params), tokens.cuda(), mask.cuda(), lora=to_cuda(lora),
                           use_fused=True, flash=True).cpu()
    after = ops.kernel_counters()
    check(after["flash_attention_fwd"] - before["flash_attention_fwd"] == cfg.n_layer
          and after["fused_logprob_fwd"] - before["fused_logprob_fwd"] == 1,
          "small model did not go through the kernels")
    real = (mask[:, :-1] > 0) & (mask[:, 1:] > 0)
    err = (gpu - cpu)[real].abs().max().item()
    log(f"  small f32 model, card kernels vs CPU plain path: max|dlogprob| {err:.3e} "
        f"(tol {SMALL_MODEL_ATOL:.0e})")
    check(err <= SMALL_MODEL_ATOL, "small model on the card disagrees with the CPU")
    report["small_model_err"] = err


def recording_caches(torch, M, into, fn):
    """``fn()`` with ``M.init_caches`` recording the KV cache it allocates:
    k + v bytes, the mask's bytes, k's shape and the allocator's delta."""
    init_caches = M.init_caches

    def recording(*a, **kw):
        before = torch.cuda.memory_allocated()
        c = init_caches(*a, **kw)
        into.update(kv_delta=torch.cuda.memory_allocated() - before,
                    kv_bytes=c.k.numel() * c.k.element_size() + c.v.numel() * c.v.element_size(),
                    mask_bytes=c.mask.numel() * c.mask.element_size(), kv_shape=list(c.k.shape))
        return c

    M.init_caches = recording
    try:
        return fn()
    finally:
        M.init_caches = init_caches


def run_slice(torch, M, G, ops, presets, report):
    # remat off: the earlier phases' numbers stay comparable (4x runs remat)
    cfg = presets.preset("llama3-8b", remat=False)
    log(f"phase 4: llama3-8b slice: {cfg.n_layer} layers, d_model {cfg.d_model}, "
        f"{cfg.n_head}/{cfg.kv_heads} heads, d_ff {cfg.ff_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    # what the base and generate's dense KV cache allocate, for phase 4t's budget
    alloc = report["alloc"] = {}
    before = torch.cuda.memory_allocated()
    params, t_init = host_s(torch, lambda: M.init_params(0, cfg))
    alloc["base_bytes"] = torch.cuda.memory_allocated() - before
    actor = make_adapter(torch, M, cfg, 1)
    reference = make_adapter(torch, M, cfg, 2)
    n_params = sum(t.numel() for blk in params["blocks"].values() for t in blk.values()) + \
        params["tok_emb"].numel() + params["lm_head"].numel()
    log(f"  weights: {n_params / 1e9:.3f}B parameters drawn on the card in {t_init:.1f} s")

    g = torch.Generator(device="cuda").manual_seed(5)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), device="cuda", generator=g).tolist()
               for n in PROMPT_LENS]
    ptoks, pmask = G.left_pad(prompts, pad_id=0)
    prompt = torch.as_tensor(ptoks, device="cuda").repeat_interleave(GROUP_SIZE, dim=0)
    prompt_mask = torch.as_tensor(pmask, device="cuda").repeat_interleave(GROUP_SIZE, dim=0)
    B, P = prompt.shape

    # warm the path (cuBLAS handles, allocator) outside the timed run
    G.generate(cfg, params, prompt[:2, -16:], prompt_mask[:2, -16:], None, max_new_tokens=2,
               lora=actor, temperature=0.0)

    ops.reset_kernel_counters()
    gen = torch.Generator(device="cuda").manual_seed(11)
    (comp, comp_mask), t_gen = host_s(torch, lambda: recording_caches(torch, M, alloc, lambda: (
        G.generate(cfg, params, prompt, prompt_mask, gen, max_new_tokens=MAX_NEW_TOKENS,
                   lora=actor, temperature=0.9))))
    (greedy, greedy_mask), t_greedy = host_s(torch, lambda: G.generate(
        cfg, params, prompt, prompt_mask, None, max_new_tokens=MAX_NEW_TOKENS, lora=actor,
        temperature=0.0))
    full = torch.cat([prompt, comp], dim=1)
    full_mask = torch.cat([prompt_mask, comp_mask], dim=1)
    lp_actor, t_score_a = host_s(torch, lambda: M.token_logprobs(
        cfg, params, full, full_mask, lora=actor, use_fused=True, flash=True))
    lp_ref, t_score_r = host_s(torch, lambda: M.token_logprobs(
        cfg, params, full, full_mask, lora=reference, use_fused=True, flash=True))
    launches = ops.kernel_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- checks on the main path's outputs ----
    log(f"  launches on the main path: {launches}")
    check(launches["flash_attention_fwd"] == 2 * cfg.n_layer,
          f"flash launches {launches['flash_attention_fwd']} != 32 per scoring call x 2")
    check(launches["fused_logprob_fwd"] == 2,
          f"fused launches {launches['fused_logprob_fwd']} != 1 per scoring call x 2")
    check(tuple(comp.shape) == (B, MAX_NEW_TOKENS) and tuple(greedy.shape) == comp.shape,
          "completion shape")
    check(bool(((comp >= 0) & (comp < cfg.vocab_size)).all()), "sampled tokens out of range")
    check(bool(comp_mask.all()) and bool(greedy_mask.all()), "no EOS set: every token emits")
    # greedy rows of one group share a prompt and must share a completion
    grp = greedy.view(len(PROMPT_LENS), GROUP_SIZE, -1)
    check(bool((grp == grp[:, :1]).all()), "greedy completions differ within a group")
    distinct = len(set(map(tuple, comp.tolist())))
    log(f"  sampled completions: {distinct} distinct of {B}; greedy: "
        f"{len(set(map(tuple, greedy.tolist())))} distinct")
    real = (full_mask[:, :-1] > 0) & (full_mask[:, 1:] > 0)
    T = full.shape[1]
    check(tuple(lp_actor.shape) == (B, T - 1), "logprob shape")
    for name, lp in (("actor", lp_actor), ("reference", lp_ref)):
        check(bool(torch.isfinite(lp[real]).all()), f"{name} logprobs not finite")
        check(bool((lp[real] <= 0).all()), f"{name} logprobs above 0")
    adapters_differ = (lp_actor - lp_ref)[real].abs().max().item()
    log(f"  max|logprob(actor) - logprob(reference)| {adapters_differ:.3e} (adapters matter)")
    check(adapters_differ > 1e-3, "the two adapters give the same logprobs")

    # kernel path vs plain path on the same weights (comparison launches
    # come after the main-path counts were read), both against f32
    plain = M.token_logprobs(cfg, params, full, full_mask, lora=actor, use_fused=False,
                             flash=False)
    fused_dense = M.token_logprobs(cfg, params, full, full_mask, lora=actor, use_fused=True,
                                   flash=False)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: ({i: {n: w.float() for n, w in blk.items()} for i, blk in v.items()}
                    if k == "blocks" else v.float()) for k, v in params.items()}
    exact = M.token_logprobs(cfg32, params32, full, full_mask, lora=actor, use_fused=False,
                             flash=False)
    del params32
    torch.cuda.empty_cache()
    d_kernel = (lp_actor - exact)[real].abs()
    d_plain = (plain - exact)[real].abs()
    d_both = (lp_actor - plain)[real].abs()
    d_fused = (fused_dense - plain)[real].abs().max().item()
    log(f"  vs an f32 run of the same weights: kernel path max|d| {d_kernel.max().item():.3e} "
        f"mean|d| {d_kernel.mean().item():.3e}; plain path max|d| {d_plain.max().item():.3e} "
        f"mean|d| {d_plain.mean().item():.3e} (kernel path within x{E2E_MAX_FACTOR} max, "
        f"x{E2E_MEAN_FACTOR} mean of the plain path's)")
    log(f"  kernel path vs plain path: max|d| {d_both.max().item():.3e}, mean|d| "
        f"{d_both.mean().item():.3e}; fused alone on the same hidden states: max|d| "
        f"{d_fused:.3e} (tol {FUSED_E2E_ATOL:.0e})")
    check(d_kernel.mean().item() <= E2E_MEAN_FACTOR * d_plain.mean().item() + E2E_FLOOR
          and d_kernel.max().item() <= E2E_MAX_FACTOR * d_plain.max().item() + E2E_FLOOR,
          "kernel-path logprobs are further from f32 than the plain path's")
    check(d_fused <= FUSED_E2E_ATOL, "fused kernel disagrees with the chunked path")

    # prefill alone: generate with one new token is the prefill + first sample
    _, t_prefill = host_s(torch, lambda: G.generate(
        cfg, params, prompt, prompt_mask, None, max_new_tokens=1, lora=actor,
        temperature=0.0))
    t_decode = (t_greedy - t_prefill) / (MAX_NEW_TOKENS - 1)
    n_real = int(full_mask.sum())
    log(f"  prefill {B}x{P}: {t_prefill * 1e3:.1f} ms; decode: {t_decode * 1e3:.2f} ms per "
        f"step of {B} rows; generate (sampled) {t_gen:.2f} s, (greedy) {t_greedy:.2f} s")
    log(f"  scoring [{B}, {T}] (flash + fused): {t_score_a * 1e3:.1f} ms and "
        f"{t_score_r * 1e3:.1f} ms; peak memory {peak_gb:.1f} GB")
    report["slice"] = dict(
        model="llama3-8b",
        layers=cfg.n_layer, rows=B, prompt_len=P, new_tokens=MAX_NEW_TOKENS,
        real_tokens=n_real, params_b=n_params / 1e9, prefill_ms=t_prefill * 1e3,
        decode_ms_per_step=t_decode * 1e3, generate_sampled_s=t_gen,
        generate_greedy_s=t_greedy, scoring_ms=[t_score_a * 1e3, t_score_r * 1e3],
        peak_memory_gb=peak_gb, launches=launches,
        kernel_vs_f32_max=d_kernel.max().item(), kernel_vs_f32_mean=d_kernel.mean().item(),
        plain_vs_f32_max=d_plain.max().item(), plain_vs_f32_mean=d_plain.mean().item(),
        kernel_vs_plain_max=d_both.max().item(), kernel_vs_plain_mean=d_both.mean().item(),
        fused_e2e_max_abs=d_fused, adapters_max_abs=adapters_differ)
    return cfg, params, (ptoks, pmask), full_mask, greedy.cpu().numpy()


# ------------------------------- phase 4b ---------------------------------- #


def completion_reward(comp):
    """Deterministic reward from the completion ids: the share of ids that
    are multiples of 7 (random weights make any text reward meaningless)."""
    return ((comp % 7) == 0).mean(axis=1)


def timed_calls(torch, fn, into):
    """``fn`` with the host time of each call (synchronized) appended to ``into``."""
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out

    return run


def lora_grad(torch, tree, lora, loss_of):
    """The gradient of ``loss_of(adapter)`` with respect to the adapter, flat."""
    lo = tree.tree_map(lambda t: t.detach().clone().requires_grad_(True), lora)
    grads = torch.autograd.grad(loss_of(lo), tree.tree_leaves(lo))
    return torch.cat([g.flatten() for g in grads])


def grpo_loss_of(M, TG, cfg, params, batch, knobs, flash, fused):
    """One GRPO update's loss on ``batch`` as a function of the adapter.
    knobs: (lora_scale, clip_coef, beta)."""
    lora_scale, clip, beta = knobs

    def loss_of(lo):
        lp = M.token_logprobs(cfg, params, batch["tokens"], attention_mask=batch["mask"],
                              lora=lo, lora_scale=lora_scale, flash=flash, use_fused=fused)
        return TG._grpo_loss_core(lp, batch, clip, beta)[0]

    return loss_of


def bf16_grads(torch, tree, lora, loss_of_path, cfg, params, label):
    """The first half of phase 4b's rule: the adapter gradient through the
    kernels and through the plain bf16 path (dense attention + chunked
    logprobs). ``loss_of_path(cfg, params, flash, fused)`` builds the loss;
    ``f32_grad_agreement`` finishes the rule once the weights are f32."""
    return dict(label=label, lora=lora, loss_of_path=loss_of_path,
                kernel=lora_grad(torch, tree, lora, loss_of_path(cfg, params, True, True)),
                plain=lora_grad(torch, tree, lora, loss_of_path(cfg, params, False, False)))


def f32_grad_agreement(torch, tree, pending, cfg32, params32):
    """Phase 4b's rule: the adapter gradient through the kernels must be no
    further from an f32 run's than GRAD_FACTOR x the plain bf16 path's
    (relative L2) + GRAD_FLOOR. ``pending`` comes from ``bf16_grads``."""
    g_kernel, g_plain = pending["kernel"], pending["plain"]
    g_32 = lora_grad(torch, tree, pending["lora"],
                     pending["loss_of_path"](cfg32, params32, False, False))
    torch.cuda.empty_cache()
    norm = g_32.norm().item()
    out = dict(grad_norm_f32=norm, grad_rel_kernel=(g_kernel - g_32).norm().item() / norm,
               grad_rel_plain=(g_plain - g_32).norm().item() / norm,
               grad_rel_kernel_vs_plain=(g_kernel - g_plain).norm().item() / norm,
               grad_cosine_kernel_f32=torch.nn.functional.cosine_similarity(
                   g_kernel, g_32, dim=0).item(), entries=g_32.numel())
    log(f"  {pending['label']}: adapter gradient ({out['entries']} entries, |g| {norm:.3e}): "
        f"relative L2 to f32: kernel path {out['grad_rel_kernel']:.3e}, plain path "
        f"{out['grad_rel_plain']:.3e}; kernel vs plain {out['grad_rel_kernel_vs_plain']:.3e}; "
        f"cosine(kernel, f32) {out['grad_cosine_kernel_f32']:.5f} (bound: kernel <= "
        f"{GRAD_FACTOR} x plain + {GRAD_FLOOR})")
    check(out["grad_rel_kernel"] <= GRAD_FACTOR * out["grad_rel_plain"] + GRAD_FLOOR,
          f"{pending['label']}: the kernel path's adapter gradient is further from f32 than "
          f"the plain path's")
    return out


def f32_weights(torch, cfg, params):
    """An f32 copy of the bf16 weights, block by block, dropping the bf16
    blocks as it goes (the last use of the bf16 8B weights)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: v.float() for k, v in params.items() if k != "blocks"}
    params32["blocks"] = {}
    for i in list(params["blocks"]):
        params32["blocks"][i] = {n: w.float() for n, w in params["blocks"].pop(i).items()}
    return cfg32, params32


def run_learn(torch, M, ops, cfg, params, prompts, report):
    """Slice 2's path: two GRPO iterations at llama3-8b, then the adapter
    gradient of one update through the kernels and the plain path (held
    against f32 by ``f32_grad_agreement``). Returns the path's launch counts
    and the pending gradients."""
    import numpy as np

    from agilerl_tpu_torch.algorithms import grpo as TG
    from agilerl_tpu_torch.ops import fused_loss as tfl
    from agilerl_tpu_torch.utils import tree

    ptoks, pmask = prompts
    n_prompts, P = ptoks.shape
    log(f"phase 4b: GRPO learn at llama3-8b: {n_prompts} prompts x group {GROUP_SIZE}, "
        f"{MAX_NEW_TOKENS} new tokens, rank-{LORA_RANK} LoRA on wq/wv, batch_size 16, "
        f"update_epochs 1")
    agent = TG.GRPO(config=cfg, base_params=params, pad_token_id=0, seed=0, batch_size=16,
                    update_epochs=1, group_size=GROUP_SIZE, max_output_tokens=MAX_NEW_TOKENS,
                    lora_rank=LORA_RANK, lora_targets=("wq", "wv"))
    b_before = [ab["B"].clone() for layer in agent.actor.params["blocks"].values()
                for ab in layer.values()]
    times = {"logprobs": [], "update": []}
    lp_fn, up_fn = agent._learn_fns()
    agent._jit_cache["logprobs"] = timed_calls(torch, lp_fn, times["logprobs"])
    agent._jit_cache["update"] = timed_calls(torch, up_fn, times["update"])
    L = cfg.n_layer
    want = {"flash_attention_fwd": 3 * L, "flash_attention_dq": L, "flash_attention_dkv": L,
            "fused_logprob_fwd": 3, "fused_logprob_dh": 1, "fused_logprob_dw": 0}
    learns = []
    ops.reset_kernel_counters()
    for it in range(2):
        (comp, cmask), t_gen = host_s(torch, lambda: agent.get_action(
            {"input_ids": ptoks, "attention_mask": pmask}))
        info = agent.last_generation_info
        check(info is not None, f"iteration {it}: get_action fell back to the dense path")
        bg = agent._bucketed_gen
        exited = bg.n_chunks - (info["decode_steps"] - 1) // bg.decode_chunk
        log(f"  iteration {it}: rollout through BucketedGenerator: {info}; chunks skipped by "
            f"the early exit: {exited}")
        rewards = completion_reward(comp).reshape(n_prompts, GROUP_SIZE).astype(np.float32)
        ids = np.concatenate([np.repeat(ptoks, GROUP_SIZE, 0), comp], axis=1)
        attn = np.concatenate([np.repeat(pmask, GROUP_SIZE, 0), cmask], axis=1)
        action = np.zeros((ids.shape[0], ids.shape[1] - 1), np.float32)
        action[:, P - 1:] = cmask
        before = ops.kernel_counters()
        splits_before = tfl._split_cuda.launches
        n_lp, n_up = len(times["logprobs"]), len(times["update"])
        torch.cuda.reset_peak_memory_stats()
        (loss, kl), t_learn = host_s(torch, lambda: agent.learn((ids, action, rewards, attn)))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        after = ops.kernel_counters()
        counts = {k: after[k] - before[k] for k in after}
        splits = tfl._split_cuda.launches - splits_before
        check(counts == want, f"learn {it}: launches {counts} != {want}")
        check(np.isfinite(loss) and np.isfinite(kl), f"learn {it}: loss {loss}, kl {kl}")
        t_lp, t_up = times["logprobs"][n_lp:], times["update"][n_up:]
        learns.append(dict(loss=loss, kl=kl, reward_mean=float(rewards.mean()),
                           generation_info=info, early_exit_chunks=exited,
                           generate_s=t_gen, learn_s=t_learn, old_ref_passes_s=t_lp,
                           update_s=t_up, peak_memory_gb=peak_gb, launches=counts,
                           operand_splits=splits))
        log(f"  iteration {it}: generate {t_gen:.2f} s; learn {t_learn:.3f} s = old/ref passes "
            f"{t_lp[0]:.3f} + {t_lp[1]:.3f} s, update {t_up[0]:.3f} s; loss {loss:.5f}, "
            f"kl {kl:.3e}, mean reward {rewards.mean():.3f}; peak memory {peak_gb:.1f} GB")
        log(f"    launches in this learn: {counts}; 3xTF32 operand splits: {splits}")
    launches = ops.kernel_counters()
    check(all(launches[k] == 2 * want[k] for k in want),
          f"generation launched a training kernel: {launches}")
    moved = max((ab["B"] - b0).abs().max().item() for ab, b0 in zip(
        (ab for layer in agent.actor.params["blocks"].values() for ab in layer.values()),
        b_before))
    log(f"  LoRA B moved by up to {moved:.3e} (lr {agent.lr}, two AdamW steps)")
    check(moved > 0, "the LoRA B matrices did not move")

    # the adapter gradient of one update on 4 rows (one per prompt), through
    # the kernels and through the plain path (dense attention + chunked
    # logprobs); the f32 run comes after phase 4d
    rows = torch.arange(0, n_prompts * GROUP_SIZE, GROUP_SIZE, device="cuda")
    tokens, mask, loss_mask = agent._learn_masks(ids, action, attn)
    tokens, mask, loss_mask = tokens[rows], mask[rows], loss_mask[rows]
    adv = agent._calculate_advantage(torch.as_tensor(rewards, device="cuda"))[rows]
    with torch.no_grad():
        old = M.token_logprobs(cfg, params, tokens, attention_mask=mask,
                               lora=agent.actor.params, use_fused=True, flash=True)
        ref = M.token_logprobs(cfg, params, tokens, attention_mask=mask,
                               lora=agent.reference.params, use_fused=True, flash=True)
    batch = dict(tokens=tokens, mask=mask, loss_mask=loss_mask, old_lp=old * loss_mask,
                 ref_lp=ref * loss_mask, advantage=adv)
    actor = agent.actor.params
    knobs = (agent.lora_scale, agent.clip_coef, agent.beta)
    del agent
    grads = bf16_grads(
        torch, tree, actor,
        lambda c, p, flash, fused: grpo_loss_of(M, TG, c, p, batch, knobs, flash, fused),
        cfg, params, "GRPO, one update on 4 rows (one per prompt)")
    report["learn"] = dict(iterations=learns, lora_b_moved=moved, launches=launches)
    return launches, grads, (ids, action, rewards, attn)


# ------------------------------- phase 4x ---------------------------------- #

# (b): the JAX docstring's recipe, preset("llama3-8b", max_seq_len=1024,
# remat=True): 16 rows of a 512-token prompt and 512 completion tokens
REMAT_ROWS, REMAT_PROMPT, REMAT_NEW = 16, 512, 512


def grpo_agent(TG, cfg, params):
    """Phase 4b's GRPO recipe on ``cfg`` (fresh adapters from seed 0)."""
    return TG.GRPO(config=cfg, base_params=params, pad_token_id=0, seed=0, batch_size=16,
                   update_epochs=1, group_size=GROUP_SIZE, max_output_tokens=MAX_NEW_TOKENS,
                   lora_rank=LORA_RANK, lora_targets=("wq", "wv"))


def measured_learn(torch, ops, agent, batch):
    """One learn: (loss, kl), seconds, peak memory (GB), launches, syncs."""
    from agilerl_tpu_torch.analysis import SyncGuard

    before = ops.kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with SyncGuard(device="cuda") as g:
        out = agent.learn(batch)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = ops.kernel_counters()
    return out, t, peak, {k: after[k] - before[k] for k in after}, g.syncs


def run_remat(torch, M, ops, cfg, params, batch, report):
    """Phase 4x (a) and (b) on phase 4b's model: the learn with and without
    per-block remat on 4b's last batch, and one remat learn at 16 x 1,024.
    Returns the launches of (a)'s two remat learns."""
    import numpy as np

    from agilerl_tpu_torch.algorithms import grpo as TG
    from agilerl_tpu_torch.utils.hbm_budget import device_memory_gib, grpo_hbm_budget
    from agilerl_tpu_torch.utils.tree import tree_copy

    out = report["remat"] = {}
    L = cfg.n_layer
    want = {"flash_attention_fwd": 3 * L, "flash_attention_dq": L, "flash_attention_dkv": L,
            "fused_logprob_fwd": 3, "fused_logprob_dh": 1, "fused_logprob_dw": 0}
    want_remat = dict(want, flash_attention_fwd=4 * L)
    rows, T = batch[0].shape
    log(f"phase 4x (a): two GRPO learns with remat=False and two with remat=True on phase 4b's "
        f"last batch ({rows} rows x {T} tokens), fresh adapters from one seed")
    runs = {}
    for remat in (False, True):
        agent = grpo_agent(TG, dataclasses.replace(cfg, remat=remat), params)
        start = tree_copy(agent.actor.params)
        learns = [measured_learn(torch, ops, agent, batch) for _ in range(2)]
        for (loss, kl), _, _, counts, _ in learns:
            check(np.isfinite(loss) and np.isfinite(kl),
                  f"4x (a) remat={remat}: loss {loss}, kl {kl}")
            check(counts == (want_remat if remat else want),
                  f"4x (a) remat={remat}: launches {counts}")
        runs[remat] = dict(loss=[x[0][0] for x in learns], kl=[x[0][1] for x in learns],
                           learn_s=[x[1] for x in learns],
                           peak_memory_gb=max(x[2] for x in learns), launches=learns[-1][3],
                           syncs=[x[4] for x in learns],
                           moved=adapter_change(torch, agent.actor.params, start),
                           actor=agent.actor.params,
                           path_launches={k: sum(x[3][k] for x in learns) for k in want})
        del agent
        torch.cuda.empty_cache()
    eager, remat = runs[False], runs[True]
    diff = adapter_change(torch, remat.pop("actor"), eager.pop("actor"))
    loss_d = max(abs(a - b) for a, b in zip(remat["loss"], eager["loss"]))
    out["a"] = dict(eager=eager, remat=remat, max_adapter_diff=diff, loss_diff=loss_d,
                    bit_for_bit=diff == 0.0 and remat["loss"] == eager["loss"]
                    and remat["kl"] == eager["kl"])
    log(f"  eager: learns {[round(t, 3) for t in eager['learn_s']]} s, peak "
        f"{eager['peak_memory_gb']:.2f} GB, syncs {eager['syncs']}; remat: learns "
        f"{[round(t, 3) for t in remat['learn_s']]} s (the first also imports what "
        f"torch.utils.checkpoint needs), peak {remat['peak_memory_gb']:.2f} GB, syncs "
        f"{remat['syncs']}; losses {eager['loss']} vs {remat['loss']}; max|d adapter| "
        f"{diff:.3e} (moved {eager['moved']:.3e}), max|d loss| {loss_d:.3e}, bit for bit "
        f"{out['a']['bit_for_bit']}; launches per remat learn {remat['launches']}")
    # the two learns differ in when the blocks run, not in what they compute:
    # held as 4u (a) holds the placed learn to the unplaced one
    check(eager["moved"] > 0 and diff <= PLACED_ADAPTER_REL * eager["moved"]
          and loss_d <= 1e-6 + 1e-3 * max(abs(x) for x in eager["loss"]),
          "4x (a): the remat learn disagrees with the eager learn")
    check(remat["syncs"] == eager["syncs"],
          f"4x (a): the recompute added host syncs: {remat['syncs']} vs {eager['syncs']}")

    # (b) 16 x 1,024 with remat: a built batch, no generation
    rng = np.random.default_rng(23)
    T_b = REMAT_PROMPT + REMAT_NEW
    ids = rng.integers(1, cfg.vocab_size, (REMAT_ROWS, T_b)).astype(np.int64)
    ids[3, T_b - 100:] = 0  # two completions end early
    ids[9, T_b - 300:] = 0
    action = np.zeros((REMAT_ROWS, T_b - 1), np.float32)
    action[:, REMAT_PROMPT - 1:] = ids[:, REMAT_PROMPT:] != 0
    rewards = rng.normal(size=(REMAT_ROWS // GROUP_SIZE, GROUP_SIZE)).astype(np.float32)
    bcfg = dataclasses.replace(cfg, remat=True, max_seq_len=T_b)
    log(f"phase 4x (b): one remat GRPO learn at {REMAT_ROWS} rows x {T_b} tokens "
        f"(prompt {REMAT_PROMPT} + {REMAT_NEW} completion)")
    agent = grpo_agent(TG, bcfg, params)
    (loss_b, kl_b), t_b, peak_b, counts_b, syncs_b = measured_learn(
        torch, ops, agent, (ids, action, rewards))
    del agent
    torch.cuda.empty_cache()
    base_gb = report["alloc"]["base_bytes"] / 1e9
    per_token = (eager["peak_memory_gb"] - base_gb) / (rows * T)
    predicted_eager = base_gb + per_token * REMAT_ROWS * T_b
    budget = grpo_hbm_budget(bcfg, fsdp=1, tp=1, batch_global=REMAT_ROWS, seq_len=T_b)
    card_gb = device_memory_gib() * 1024 ** 3 / 1e9
    out["b"] = dict(rows=REMAT_ROWS, T=T_b, loss=loss_b, kl=kl_b, learn_s=t_b,
                    peak_memory_gb=peak_b, launches=counts_b, syncs=syncs_b,
                    budget_total_gb=budget["total"] / 1e9,
                    budget_terms_gb={k: v / 1e9 for k, v in budget.items()
                                     if k not in ("meta", "total")},
                    predicted_eager_peak_gb=predicted_eager, card_gb=card_gb)
    log(f"  learn {t_b:.3f} s, peak {peak_b:.2f} GB of the card's {card_gb:.1f} GB; "
        f"grpo_hbm_budget at these shapes {budget['total'] / 1e9:.2f} GB; the eager peak (a)'s "
        f"bytes per token predict: {predicted_eager:.1f} GB; loss {loss_b:.5f}, {syncs_b} syncs, "
        f"launches {counts_b}")
    check(np.isfinite(loss_b) and np.isfinite(kl_b), f"4x (b): loss {loss_b}, kl {kl_b}")
    check(peak_b < card_gb, f"4x (b): peak {peak_b:.1f} GB over the card's {card_gb:.1f} GB")
    check(counts_b == want_remat, f"4x (b): launches {counts_b}")
    return remat["path_launches"]


# ------------------------------- phase 4f ---------------------------------- #

SERVE = dict(slots=8, block_size=32, prompt_buckets=(64, 128, 256),
             max_new_tokens=MAX_NEW_TOKENS, decode_chunk=16)
SERVE_TOP_K = 50
# Decode-captured logprobs against token_logprobs over prompt + completion:
# both are bf16 through 32 layers, on other attention paths (paged decode
# against flash / dense prefill). Within CAPTURE_FACTOR x the two scoring
# paths' own disagreement (kernels vs plain), mean and max, or these floors.
CAPTURE_FACTOR = 3.0
CAPTURE_FLOOR = {"mean": 2e-2, "max": 0.25}
# A greedy divergence between two bf16 paths is rounding when the dense
# path's logits of the two tokens lie within GAP_FACTOR x phase 4's
# kernel-vs-plain max logprob difference (two bf16 evaluations of one
# sequence) of each other.
GAP_FACTOR = 2.0
SMALL_SERVE_LP_ATOL = 1e-4  # f32 small model: captured vs token_logprobs


def timed_method(torch, obj, name, into, ops=None, extra=None):
    """Wrap ``obj.name`` (a method of an instance, or of a class) so each
    call's synchronized host time lands in ``into``; given ``ops``, a dict
    of the time, the call's kernel launches, its arguments, its output and
    ``extra()`` read after it. Returns the unwrapped method."""
    fn = getattr(obj, name)

    def run(*args, **kw):
        torch.cuda.synchronize()
        before = ops.kernel_counters() if ops is not None else None
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if ops is None:
            into.append(seconds)
        else:
            after = ops.kernel_counters()
            into.append(dict(s=seconds, launches={k: after[k] - before[k] for k in after},
                             args=args, out=out, extra=extra() if extra is not None else None))
        return out

    setattr(obj, name, run)
    return fn


def serve_once(torch, S, cfg, params, lora, seqs, label, gen=None, greedy=True, **kw):
    """One ``ContinuousGenerator.generate`` over ``seqs`` (a new generator
    unless ``gen`` is given), with its TTFTs, decode time and throughput."""
    import numpy as np

    from agilerl_tpu_torch.observability import MetricsRegistry

    if gen is None:
        gen = S.ContinuousGenerator(cfg, metrics=MetricsRegistry(), **SERVE, **kw)
    decode_s, verify_s = [], []
    timed_method(torch, gen, "_decode_chunk", decode_s)
    timed_method(torch, gen, "_verify", verify_s)
    ttft0 = len(gen._recent_ttft)
    summ0 = gen.latency_summary()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp, cmask, info = gen.generate(seqs, 7, params, lora=lora, greedy=greedy)
    wall = time.perf_counter() - t0
    summ = gen.latency_summary()
    for name in ("_decode_chunk", "_verify"):
        delattr(gen, name)
    ttft = np.asarray(list(gen._recent_ttft)[ttft0:])
    tokens = int(cmask.sum())
    misses = len(seqs) - info["prefix_cache_hits"]
    steps = len(decode_s) * gen.decode_chunk + len(verify_s)
    dec_s = sum(decode_s) + sum(verify_s)
    proposed = int(summ["spec_proposed_tokens_total"] - summ0["spec_proposed_tokens_total"])
    accepted = int(summ["spec_accepted_tokens_total"] - summ0["spec_accepted_tokens_total"])
    out = dict(
        requests=len(seqs), tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p95_s=float(np.percentile(ttft, 95)),
        decode_steps=steps, decode_s=dec_s,
        decode_ms_per_step=1e3 * dec_s / max(steps, 1),
        # the miss path's first token comes from the prefill; the rest from decode
        decode_ms_per_token=1e3 * dec_s / max(tokens - misses, 1),
        verify_steps=len(verify_s), prefix_hits=info["prefix_cache_hits"],
        free_blocks=info["free_blocks"], n_blocks=gen.n_blocks,
        compiled_programs=info["compiled_programs"], pool_gb=gen.pool_bytes / 1e9,
        spec_proposed=proposed, spec_accepted=accepted,
        accept_rate=accepted / proposed if proposed else None)
    log(f"  {label}: {tokens} tokens in {wall:.2f} s ({out['tokens_per_s']:.1f} tokens/s); "
        f"TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms, p95 {out['ttft_p95_s'] * 1e3:.1f} ms; "
        f"decode {out['decode_ms_per_step']:.1f} ms/step over {steps} steps "
        f"({out['decode_ms_per_token']:.2f} ms per decoded token); prefix hits "
        f"{out['prefix_hits']}; free blocks after draining {out['free_blocks']} of "
        f"{gen.n_blocks - 1}; pool {out['pool_gb']:.3f} GB"
        + (f"; speculation: {accepted}/{proposed} drafts accepted in {len(verify_s)} verify "
           f"steps" if proposed else ""))
    check(comp.shape == (len(seqs), MAX_NEW_TOKENS), f"{label}: completion shape")
    check(bool(((comp >= 0) & (comp < cfg.vocab_size)).all()), f"{label}: token out of range")
    check(bool(cmask.all()), f"{label}: no EOS set, yet a row stopped early")
    check(info["free_blocks"] == gen.n_blocks - 1, f"{label}: blocks not all returned")
    return gen, comp, info, out


def greedy_divergence(torch, M, cfg, params, lora, prompt_np, dense, cont, spread,
                      label="greedy continuous vs dense generate"):
    """Rows of ``cont`` equal ``dense`` up to their first difference; there
    the dense path's logits of the two tokens differ by at most GAP_FACTOR x
    ``spread``. Returns (identical rows, largest gap)."""
    import numpy as np

    B, P = prompt_np[0].shape
    diff = [(b, int(np.argmax(cont[b] != dense[b]))) for b in range(B)
            if (cont[b] != dense[b]).any()]
    gaps = []
    if diff:
        rows = [b for b, _ in diff]
        toks = torch.as_tensor(np.concatenate([prompt_np[0][rows], dense[rows]], 1),
                               device="cuda")
        mask = torch.as_tensor(np.concatenate([prompt_np[1][rows], np.ones_like(dense[rows])],
                                              1), device="cuda")
        hidden, _ = M.forward(cfg, params, toks, attention_mask=mask, lora=lora, flash=False)
        for i, (b, t) in enumerate(diff):
            logits = M.logits_fn(cfg, params, hidden[i:i + 1, P + t - 1])[0]
            gaps.append((logits[int(dense[b, t])] - logits[int(cont[b, t])]).item())
    worst = max(gaps, default=0.0)
    log(f"  {label}: {B - len(diff)} of {B} rows identical; "
        f"first differences at tokens {[t for _, t in diff]}, dense logit gaps "
        f"{[round(g, 4) for g in gaps]} (bound {GAP_FACTOR} x {spread:.3e})")
    check(worst <= GAP_FACTOR * spread,
          f"{label}: a greedy divergence is larger than bf16 rounding explains")
    return B - len(diff), worst


def captured_vs_scoring(torch, M, ops, cfg, params, lora, prompt_np, comp, lps):
    """Decode-captured logprobs against token_logprobs over prompt +
    completion, through the kernels (flash #1, fused #5: counted) and
    through the plain path. Returns (kernel-path launches, numbers)."""
    import numpy as np

    P = prompt_np[0].shape[1]
    full = torch.as_tensor(np.concatenate([prompt_np[0], comp], 1), device="cuda")
    mask = torch.as_tensor(np.concatenate([prompt_np[1], np.ones_like(comp)], 1),
                           device="cuda")
    before = ops.kernel_counters()
    kernel = M.token_logprobs(cfg, params, full, mask, lora=lora, use_fused=True, flash=True)
    after = ops.kernel_counters()
    launches = {k: after[k] - before[k] for k in after}
    plain = M.token_logprobs(cfg, params, full, mask, lora=lora, use_fused=False, flash=False)
    cap = torch.as_tensor(lps, device="cuda")
    kernel, plain = kernel[:, P - 1:], plain[:, P - 1:]
    d = {"kernel": (cap - kernel).abs(), "plain": (cap - plain).abs(),
         "scoring": (kernel - plain).abs()}
    out = {f"{k}_{s}": getattr(v, s)().item() for k, v in d.items() for s in ("mean", "max")}
    out["launches"] = launches
    log(f"  captured logprobs vs token_logprobs over prompt + completion: kernel path "
        f"(flash {launches['flash_attention_fwd']} launches, fused "
        f"{launches['fused_logprob_fwd']}) mean|d| {out['kernel_mean']:.3e} max|d| "
        f"{out['kernel_max']:.3e}; plain path mean {out['plain_mean']:.3e} max "
        f"{out['plain_max']:.3e}; kernel vs plain mean {out['scoring_mean']:.3e} max "
        f"{out['scoring_max']:.3e} (bound: {CAPTURE_FACTOR} x kernel vs plain, floors "
        f"{CAPTURE_FLOOR})")
    check(launches["flash_attention_fwd"] == cfg.n_layer and launches["fused_logprob_fwd"] == 1,
          f"captured-logprob check did not go through the kernels: {launches}")
    for path in ("kernel", "plain"):
        for s in ("mean", "max"):
            bound = max(CAPTURE_FACTOR * out[f"scoring_{s}"], CAPTURE_FLOOR[s])
            check(out[f"{path}_{s}"] <= bound,
                  f"captured logprobs: {path} path {s}|d| {out[f'{path}_{s}']:.3e} > {bound:.3e}")
    return launches, out


def serve_small(torch, M, G, S, TSP, ops, report):
    """A small f32 model on the card against the CPU: continuous (plain and
    speculative) and bucketed greedy serving equal dense greedy ``generate``
    on both devices; a verify step at draft_len 0 equals one decode step
    (sampled: the same draw); captured logprobs equal ``token_logprobs``
    (the f32 flash and fused kernels on the card)."""
    import numpy as np

    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.utils.tree import tree_map

    cfg = M.GPTConfig(vocab_size=1000, n_layer=2, n_head=4, n_kv_head=2, d_model=256,
                      max_seq_len=256, tie_embeddings=False, dtype=torch.float32)
    params = M.init_params(7, cfg, device="cpu")
    # wider weights give decisive, varied argmaxes
    params = {k: ({i: {n: (w * 8 if w.dim() == 2 else w) for n, w in b.items()}
                   for i, b in v.items()} if k == "blocks" else v * 8)
              for k, v in params.items()}
    on = {"cpu": params, "cuda": tree_map(lambda t: t.cuda(), params)}
    rng = np.random.default_rng(0)
    base = [rng.integers(1, 1000, size=n).astype(np.int32) for n in (9, 30, 17, 60)]
    seqs = base + base[:3]
    kw = dict(max_new_tokens=12, prompt_buckets=(32, 64), block_size=16, slots=3,
              decode_chunk=4, n_blocks=40)
    rows = {Pb: [i for i, s in enumerate(seqs) if (32 if len(s) <= 32 else 64) == Pb]
            for Pb in (32, 64)}
    out = {}
    for dev, p in on.items():
        dense = {}
        for Pb, idx in rows.items():
            toks, mask = G.left_pad([seqs[i] for i in idx], 0, Pb)
            comp, _ = G.generate(cfg, p, torch.as_tensor(toks, device=dev),
                                 torch.as_tensor(mask, device=dev), None, max_new_tokens=12,
                                 temperature=0.0)
            dense.update(zip(idx, comp.cpu().numpy()))
        want = np.stack([dense[i] for i in range(len(seqs))])
        got = {}
        for name, spec in (("continuous", None), ("speculative", {"k": 3})):
            gen = S.ContinuousGenerator(cfg, metrics=MetricsRegistry(), speculate=spec,
                                        device=dev, **kw)
            got[name], _, info = gen.generate(seqs, 0, p, greedy=True)
            check(info["prefix_cache_hits"] == 3, f"small {dev} {name}: prefix hits {info}")
        bucketed = S.BucketedGenerator(cfg, max_new_tokens=12, prompt_buckets=(64,),
                                       row_buckets=(8,), decode_chunk=4, device=dev,
                                       metrics=MetricsRegistry())
        got["bucketed"] = bucketed.generate(seqs, None, p, greedy=True)[0]
        for name, comp in got.items():
            check(np.array_equal(comp, want), f"small {dev}: {name} greedy != dense greedy")
        out[dev] = want
        # a verify step at draft_len 0 is one decode step (sampled: same draw)
        gen = S.ContinuousGenerator(cfg, metrics=MetricsRegistry(), device=dev, **kw)
        for s_ in seqs[:3]:
            gen.submit(s_)
        gen._admit(p, None, greedy=False)
        knobs = dict(lora=None, lora_scale=2.0, temperature=0.8, top_k=20, top_p=None,
                     eos_id=None, pad_id=0, min_new_tokens=None)
        dc, (dt, _) = G.paged_decode_step(cfg, p, gen._device_carry(), **knobs)
        drafts = torch.full((kw["slots"], 3), 5, dtype=torch.int32, device=dev)
        vc, (vt, _, vn, _) = TSP.paged_verify_step(
            cfg, p, gen._device_carry(), drafts,
            torch.zeros(kw["slots"], dtype=torch.int32, device=dev), **knobs)
        check(bool((vt[:, 0] == dt).all()) and bool((vn == 1).all())
              and all(bool((a == b.to(a.dtype)).all()) for a, b in zip(vc[2:], dc[2:])),
              f"small {dev}: verify at draft_len 0 != one decode step")
        # captured logprobs (sampled) against token_logprobs through the
        # kernels and the plain path, on the init weights (unscaled: the
        # f32 tolerance is absolute, as small_model_check's)
        p0 = M.init_params(7, cfg, device=dev)
        gen = S.ContinuousGenerator(cfg, metrics=MetricsRegistry(), device=dev,
                                    capture_logprobs=True, temperature=0.9, top_k=30, **kw)
        comp, cmask, info = gen.generate(seqs, 3, p0)
        ptoks, pmask = G.left_pad(seqs, 0, 64)
        full = torch.as_tensor(np.concatenate([ptoks, comp], 1), device=dev)
        fmask = torch.as_tensor(np.concatenate([pmask, cmask], 1), device=dev)
        for path, fused in (("kernel", True), ("plain", False)):
            before = ops.kernel_counters()
            lp = M.token_logprobs(cfg, p0, full, fmask, use_fused=fused, flash=fused)
            launched = {k: v - before[k] for k, v in ops.kernel_counters().items()}
            lp = lp[:, 63:].cpu().numpy()
            err = float(np.abs(info["logprobs"] - lp)[cmask == 1].max())
            check(err <= SMALL_SERVE_LP_ATOL,
                  f"small {dev}: captured logprobs off the {path} path by {err:.3e}")
            if dev == "cuda" and fused:
                check(launched["flash_attention_fwd"] == 2 and launched["fused_logprob_fwd"] == 1,
                      f"small model scoring did not go through the kernels: {launched}")
            out[f"{dev}_capture_{path}_err"] = err
    check(np.array_equal(out["cuda"], out["cpu"]), "small model: card and CPU greedy differ")
    errs = {k: v for k, v in out.items() if k.endswith("_err")}
    log(f"  small f32 model (2 layers, d_model 256, 4/2 heads), card and CPU: continuous, "
        f"speculative and bucketed greedy == dense greedy; verify at draft_len 0 == one "
        f"decode step; captured logprobs vs token_logprobs max|d| {errs} "
        f"(tol {SMALL_SERVE_LP_ATOL:.0e})")
    report["serving"]["small"] = errs


def run_serving(torch, M, G, ops, cfg, params, prompts, dense_greedy, report):
    """Slice 4a's path at llama3-8b: ContinuousGenerator serving phase 4's
    4 prompts x 4 repeats (more requests than slots, 12 prefix hits) greedy,
    sampled, speculative and with captured logprobs. Returns the launch
    counts of the path (the captured-logprob check through the kernels) and
    the greedy rows."""
    from agilerl_tpu_torch.llm import serving as S
    from agilerl_tpu_torch.llm import speculate as TSP

    ptoks, pmask = prompts
    n_prompts, P = ptoks.shape
    log(f"phase 4f: serving at llama3-8b: {n_prompts} prompts x {GROUP_SIZE} repeats on "
        f"{SERVE['slots']} slots, blocks of {SERVE['block_size']} tokens, prompt buckets "
        f"{SERVE['prompt_buckets']}, {MAX_NEW_TOKENS} new tokens, decode chunks of "
        f"{SERVE['decode_chunk']}, rank-{LORA_RANK} LoRA on wq/wv")
    seqs = [row[m.astype(bool)] for row, m in zip(ptoks, pmask) for _ in range(GROUP_SIZE)]
    prompt_np = (ptoks.repeat(GROUP_SIZE, 0), pmask.repeat(GROUP_SIZE, 0))
    lora = make_adapter(torch, M, cfg, 1)  # phase 4's actor adapter
    report["serving"] = {}
    ops.reset_kernel_counters()
    # warm the path (allocator, cuBLAS shapes) outside the timed runs
    serve_once(torch, S, cfg, params, lora, seqs[:2], "warm-up (2 requests)")
    gen, greedy, _, r = serve_once(torch, S, cfg, params, lora, seqs, "greedy")
    check(r["prefix_hits"] == n_prompts * (GROUP_SIZE - 1), f"prefix hits {r['prefix_hits']}")
    report["serving"]["greedy"] = r
    same, gap = greedy_divergence(torch, M, cfg, params, lora, prompt_np, dense_greedy,
                                  greedy, report["slice"]["kernel_vs_plain_max"])
    report["serving"]["greedy"].update(rows_identical_to_dense=same, worst_dense_gap=gap)
    spec, first, _, r1 = serve_once(torch, S, cfg, params, lora, seqs,
                                    "speculative greedy, first pass", speculate=True)
    _, second, _, r2 = serve_once(torch, S, cfg, params, lora, seqs,
                                  "speculative greedy, the same batch again", gen=spec)
    report["serving"]["speculative"] = dict(
        first=r1, second=r2,
        rows_identical_to_plain=[int((first == greedy).all(1).sum()),
                                 int((second == greedy).all(1).sum())])
    log(f"  speculative rows identical to the plain greedy run: "
        f"{report['serving']['speculative']['rows_identical_to_plain']} of {len(seqs)}")
    gen, comp, info, r = serve_once(torch, S, cfg, params, lora, seqs,
                                    "sampled with captured logprobs", greedy=False,
                                    top_k=SERVE_TOP_K, temperature=1.0,
                                    capture_logprobs=True)
    launches, cap = captured_vs_scoring(torch, M, ops, cfg, params, lora, prompt_np, comp,
                                        info["logprobs"])
    report["serving"]["captured"] = dict(r, **cap)
    path_launches = ops.kernel_counters()
    check(path_launches == {k: launches[k] for k in path_launches},
          f"serving launched a kernel outside the scoring check: {path_launches}")
    serve_small(torch, M, G, S, TSP, ops, report)
    return path_launches, greedy


# ------------------------------- phase 4g ---------------------------------- #

FLY_EPOCHS = 2
FLY_PROMPTS = 4  # data batch: x group 4 = 16 rows
SMALL_FLY_ADAPTER_RTOL = 1e-3  # small f32 flywheel, card learner vs CPU learner


def fly_reward(completion, answer, prompt):
    """The arithmetic reward plus the share of digits in the completion:
    at random weights only the digit share differs between completions."""
    return arith_reward(completion, answer, prompt) + \
        sum(ch.isdigit() for ch in completion) / max(len(completion), 1)


def folded_char_tokenizer():
    """phase 4c's CharTokenizer, whose decode folds every id outside its
    alphabet onto it. llama3-8b's random weights emit ids across all 128,256
    entries; the plain decode drops those, so every completion would decode
    empty and every reward would be equal (zero advantage, no update)."""
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer

    class Folded(CharTokenizer):
        def decode(self, ids):
            n = self.vocab_size - 2
            return "".join(self._i2c[2 + (int(i) - 2) % n] for i in ids if int(i) >= 2)

    return Folded()


# TTFT buckets of the fleets: 1 ms steps to 2 s, 10 ms steps to 60 s (the
# serving default's steps of 0.1 to 30 s would blur p50 and p95 of 16 requests)
TTFT_FINE = tuple(round(1e-3 * i, 6) for i in range(1, 2000)) + tuple(
    round(1e-2 * i, 6) for i in range(200, 6001)) + (120.0,)


def dump_percentile(h, q):
    """The q-th percentile of a histogram dump, interpolated inside its
    bucket as the registry's ``Histogram.percentile`` does."""
    rank, cum = q / 100.0 * h["count"], 0
    for i, c in enumerate(h["counts"]):
        if c and cum + c >= rank:
            if i == len(h["bounds"]):
                return h["bounds"][-1]
            lo = 0.0 if i == 0 else h["bounds"][i - 1]
            return lo + (h["bounds"][i] - lo) * (rank - cum) / c
        cum += c
    return float("nan")


def fleet_run(torch, fleet, seqs, params, lora, label, kill_after_first_step=None):
    """Serve ``seqs`` (greedy) through ``fleet`` by submit / step / result,
    timing every replica's decode chunks; routing comes from the fleet's
    ``fleet_route`` events, TTFT from its merged ``serving/ttft_s``
    histogram (this run's share). Returns (rows, numbers)."""
    import numpy as np

    members = list(fleet._serving_members().values())
    decode_s = []
    for m in members:
        timed_method(torch, m.gen, "_decode_chunk", decode_s)

    def ttft_hist():
        return fleet.merged_dump(counters=[], histograms=["serving/ttft_s"])["histograms"].get(
            "serving/ttft_s")

    ttft0 = ttft_hist()
    hits0 = {m.rid: m.gen.metrics.counter("serving/prefix_cache_hits_total").value
             for m in members}
    events = fleet.metrics.sink.events
    n_events = len(events)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [fleet.submit(s, key=[7, i], no_shed=True) for i, s in enumerate(seqs)]
    if kill_after_first_step is not None:
        fleet.step(params, lora=lora, greedy=True)
        fleet.kill_replica(kill_after_first_step)
    fleet.run_until_drained(params, lora=lora, greedy=True)
    rows = [fleet.result(t) for t in tickets]
    wall = time.perf_counter() - t0
    for m in members:
        delattr(m.gen, "_decode_chunk")
    comp = np.stack([r[0] for r in rows])
    cmask = np.stack([r[1] for r in rows])
    routes = {t: [e["replica"] for e in events[n_events:]
                  if e["kind"] == "fleet_route" and e["ticket"] == t and "replica" in e]
              for t in tickets}
    ttft = ttft_hist()
    if ttft0 is not None:
        ttft = dict(bounds=ttft["bounds"], count=ttft["count"] - ttft0["count"],
                    counts=[x - y for x, y in zip(ttft["counts"], ttft0["counts"])])
    tokens = int(cmask.sum())
    steps = len(decode_s) * members[0].gen.decode_chunk
    alive = fleet._serving_members(alive=True).values()
    out = dict(
        requests=len(seqs), tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        ttft_p50_s=dump_percentile(ttft, 50), ttft_p95_s=dump_percentile(ttft, 95),
        decode_steps=steps, decode_ms_per_step=1e3 * sum(decode_s) / max(steps, 1),
        routed_to=[routes[t][0] for t in tickets], served_by=[routes[t][-1] for t in tickets],
        prefix_hits={m.rid: m.gen.metrics.counter("serving/prefix_cache_hits_total").value
                     - hits0[m.rid] for m in members},
        free_blocks={m.rid: m.gen.allocator.available() for m in alive},
        n_blocks=members[0].gen.n_blocks, compiled_programs=fleet.compiled_programs,
        rebalanced=fleet.latency_summary()["fleet"]["rebalanced_requests_total"])
    log(f"  {label}: {tokens} tokens in {wall:.2f} s ({out['tokens_per_s']:.1f} tokens/s); "
        f"TTFT p50 {out['ttft_p50_s'] * 1e3:.1f} ms, p95 {out['ttft_p95_s'] * 1e3:.1f} ms; "
        f"decode {out['decode_ms_per_step']:.1f} ms per replica step over {steps} steps; "
        f"routed to {out['routed_to']}; served by {out['served_by']}; prefix hits per "
        f"replica {out['prefix_hits']}; free blocks {out['free_blocks']} of "
        f"{out['n_blocks'] - 1}; {out['compiled_programs']} program signatures; "
        f"re-dispatched {out['rebalanced']:.0f}")
    # a re-dispatched request observes its first token again on the survivor
    check(ttft["count"] >= len(seqs), f"{label}: {ttft['count']} first tokens observed")
    check(comp.shape == (len(seqs), MAX_NEW_TOKENS) and bool(cmask.all()),
          f"{label}: completion shape or an early stop without EOS")
    check(all(v == out["n_blocks"] - 1 for v in out["free_blocks"].values()),
          f"{label}: blocks not all returned")
    return comp, out


def run_fleet_and_flywheel(torch, M, G, ops, tfa, tfl, cfg, params, prompts, served_greedy,
                           report):
    """Slice 4b's path at llama3-8b on phase 4's bf16 weights: a unified
    ServingFleet of 2 replicas serving phase 4f's 16 requests (held to 4f's
    single-generator rows by the near-tie rule), the same batch with a
    replica killed after the first chunk, the disaggregated topology (1
    prefill worker + 2 decode replicas, KV through the transfer store), then
    finetune_llm_reasoning_online on the arithmetic recipe with the rollouts
    through the unified fleet under an AutoscalePolicy, and each learner
    kernel at a learner batch's shapes against its plain version. Returns
    the path's launch counts."""
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.algorithms.grpo import GRPO
    from agilerl_tpu_torch.llm.autoscale import AutoscalePolicy
    from agilerl_tpu_torch.llm.convert import lora_from_numpy
    from agilerl_tpu_torch.llm.fleet import ServingFleet
    from agilerl_tpu_torch.llm.flywheel import RolloutPod, WeightStore
    from agilerl_tpu_torch.observability import MemorySink, MetricsRegistry, RunTelemetry
    from agilerl_tpu_torch.training.train_llm_online import finetune_llm_reasoning_online
    from agilerl_tpu_torch.utils.llm_utils import ReasoningGym
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_to_numpy

    ptoks, pmask = prompts
    n_prompts = ptoks.shape[0]
    seqs = [row[m.astype(bool)] for row, m in zip(ptoks, pmask) for _ in range(GROUP_SIZE)]
    prompt_np = (ptoks.repeat(GROUP_SIZE, 0), pmask.repeat(GROUP_SIZE, 0))
    spread = report["slice"]["kernel_vs_plain_max"]
    lora = make_adapter(torch, M, cfg, 1)  # phase 4's actor adapter, as 4f
    tok = folded_char_tokenizer()
    # no EOS: the fleet serves 4f's requests with 4f's recipe, every row 64 tokens
    agent = GRPO(config=cfg, base_params=params, pad_token_id=tok.pad_token_id,
                 eos_token_id=None, seed=0, batch_size=16,
                 group_size=GROUP_SIZE, max_output_tokens=MAX_NEW_TOKENS,
                 lora_rank=LORA_RANK, lora_targets=("wq", "wv"))
    grid = 2 * len(SERVE["prompt_buckets"]) + 2  # prefill + import per bucket, decode, copy
    knobs = dict(SERVE, **{k: v for k, v in agent._serving_knobs().items()
                           if k != "max_new_tokens"})

    def new_fleet(**kw):
        return ServingFleet(cfg, 2, metrics=MetricsRegistry(sink=MemorySink()),
                            capture_logprobs=True,
                            bucket_overrides={"serving/ttft_s": TTFT_FINE}, **knobs, **kw)

    log(f"phase 4g: serving fleet at llama3-8b: 2 replicas x {SERVE['slots']} slots, "
        f"{n_prompts} prompts x {GROUP_SIZE} repeats, captured logprobs")
    fr = report["fleet"] = {}
    ops.reset_kernel_counters()
    t0 = time.perf_counter()
    fleet = new_fleet()
    unified, fr["unified"] = fleet_run(torch, fleet, seqs, params, lora, "unified fleet")
    check(sum(fr["unified"]["prefix_hits"].values()) == n_prompts * (GROUP_SIZE - 1),
          "unified fleet: the repeats did not hit the prefix cache")
    check(all(len(set(fr["unified"]["routed_to"][i:i + GROUP_SIZE])) == 1
              for i in range(0, len(seqs), GROUP_SIZE)),
          "unified fleet: a prompt's repeats were routed to two replicas")
    check(fr["unified"]["compiled_programs"] <= 2 * grid, "unified fleet: program count")
    same, gap = greedy_divergence(torch, M, cfg, params, lora, prompt_np, served_greedy,
                                  unified, spread, "unified fleet vs phase 4f's generator")
    fr["unified"].update(rows_identical_to_4f=same, worst_gap=gap)

    failover = new_fleet()
    rows, fr["failover"] = fleet_run(torch, failover, seqs, params, lora,
                                     "failover (replica 1 killed after the first chunk)",
                                     kill_after_first_step=1)
    check(fr["failover"]["rebalanced"] > 0, "failover: nothing was re-dispatched")
    check(set(fr["failover"]["served_by"]) == {0}, "failover: a row was served by the dead replica")
    same, gap = greedy_divergence(torch, M, cfg, params, lora, prompt_np, unified, rows,
                                  spread, "failover vs the unified fleet")
    fr["failover"].update(rows_identical_to_unified=same, worst_gap=gap)
    del failover

    with tempfile.TemporaryDirectory() as xfer:
        dis = new_fleet(topology="disaggregated", n_prefill=1, transfer_dir=xfer)
        exports, import_s = [], []
        timed_method(torch, dis.store, "export", exports, ops=ops)
        timed_method(torch, dis.store, "load", import_s)
        # a quarter of the batch: every prompt once (half of it, every
        # prompt with two repeats, until phase 4t came)
        rows, fr["disaggregated"] = fleet_run(torch, dis, seqs[::GROUP_SIZE], params, lora,
                                              "disaggregated (1 prefill worker, 2 decode), 4 "
                                              "of the 16 requests")
        reg = dis.metrics
        transfers = reg.counter("fleet/kv_transfers_total").value
        export_s = [r["s"] for r in exports]
        sizes = [(r["args"][1]["k"].nbytes + r["args"][1]["v"].nbytes) / 2 ** 20
                 for r in exports]
        del exports
        _, warm = fleet_run(torch, dis, seqs[:1], params, lora, "warm repeat of one prompt")
        warm_transfers = reg.counter("fleet/kv_transfers_total").value - transfers
    fr["disaggregated"].update(
        transfers=transfers, mb_per_transfer=sizes, export_s=export_s, import_s=import_s,
        imports=reg.counter("fleet/kv_imports_total").value, warm_repeat_transfers=warm_transfers,
        warm_repeat_hits=warm["prefix_hits"])
    log(f"  KV transfers {transfers:.0f}: {[round(x, 2) for x in sizes]} MB each; export "
        f"{[round(x, 3) for x in export_s]} s, import {[round(x, 3) for x in import_s]} s; "
        f"a warm repeat made {warm_transfers:.0f} transfers")
    check(transfers > 0 and warm_transfers == 0, "disaggregated: transfers, or the warm repeat")
    check(fr["disaggregated"]["compiled_programs"] <= 2 * grid + len(SERVE["prompt_buckets"]),
          "disaggregated fleet: program count")
    same, gap = greedy_divergence(torch, M, cfg, params, lora,
                                  tuple(a[::GROUP_SIZE] for a in prompt_np), unified[::GROUP_SIZE],
                                  rows, spread, "disaggregated vs the unified fleet")
    fr["disaggregated"].update(rows_identical_to_unified=same, worst_gap=gap)
    del dis
    fleet_launches = ops.kernel_counters()
    check(set(fleet_launches.values()) == {0}, f"the fleet launched a kernel: {fleet_launches}")
    fr["seconds"] = time.perf_counter() - t0

    # ---- the online flywheel, rollouts through the unified fleet ----
    log(f"phase 4g: finetune_llm_reasoning_online at llama3-8b: {FLY_PROMPTS} prompts x group "
        f"{GROUP_SIZE}, {MAX_NEW_TOKENS} new tokens, max_staleness_epochs 1, {FLY_EPOCHS} "
        f"epochs, rollouts through the unified fleet under AutoscalePolicy(1..3)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    env = ReasoningGym(arith_rows(64, 0), arith_rows(8, 1), tok, reward_fn=fly_reward,
                       data_batch_size=FLY_PROMPTS)
    sink = MemorySink()
    telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
    reg = telem.registry
    policy = AutoscalePolicy(min_replicas=1, max_replicas=3, metrics=reg)
    applies = []
    timed_method(torch, policy, "apply", applies, ops=ops, extra=lambda: policy.last_decision)

    def counters():
        return {k: reg.counter(k).value for k in (
            "flywheel/decode_stalls_total", "flywheel/trajectories_dropped_stale_total",
            "flywheel/logprob_forwards_saved_total", "flywheel/decode_stall_s")}

    rollouts, learns = [], []
    real_rollout = timed_method(torch, RolloutPod, "rollout_once", rollouts, ops=ops)
    # the adapter after each learner step: the epoch it publishes
    adapters = [tree_to_numpy(agent.actor.params)]

    def after_learn():
        adapters.append(tree_to_numpy(agent.actor.params))
        return counters()

    timed_method(torch, agent, "learn_from_trajectory", learns, ops=ops, extra=after_learn)
    ops.reset_kernel_counters()
    with tempfile.TemporaryDirectory() as work:
        try:
            t1 = time.perf_counter()
            _, fitnesses = finetune_llm_reasoning_online(
                agent, env, work, max_epochs=FLY_EPOCHS, evaluation_interval=FLY_EPOCHS,
                max_staleness_epochs=1, fleet=fleet, autoscaler=policy, telemetry=telem,
                telemetry_export_dir=f"{work}/telemetry", verbose=True)
            fly_s = time.perf_counter() - t1
        finally:
            RolloutPod.rollout_once = real_rollout
        fly_launches = ops.kernel_counters()
        store = WeightStore(f"{work}/weights", metrics=MetricsRegistry())
        epochs = store.epochs()
        latest, published = store.load_latest()
        snapshots = sorted(p.name for p in (Path(work) / "telemetry").iterdir())
    del agent.learn_from_trajectory
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.n_layer
    want = {"flash_attention_fwd": 3 * L, "flash_attention_dq": L, "flash_attention_dkv": L,
            "fused_logprob_fwd": 3, "fused_logprob_dh": 1, "fused_logprob_dw": 0}
    losses = [e["train/loss"] for e in sink.events if e["kind"] == "metrics"
              and "train/loss" in e]
    moved = [max(float(np.abs(a["blocks"][i][t]["B"] - b["blocks"][i][t]["B"]).max())
                 for i in a["blocks"] for t in a["blocks"][i])
             for a, b in zip(adapters, adapters[1:])]
    decisions = [dict(verdict=r["extra"]["verdict"], triggers=r["extra"]["triggers"],
                      actioned=r["out"], replicas=r["extra"]["signals"]["replicas"])
                 for r in applies]
    per_epoch = [dict(rollout_s=r["s"], rollout_launches=r["launches"],
                      learner_step_s=l_["s"], learner_launches=l_["launches"],
                      after=l_["extra"])
                 for r, l_ in zip(rollouts, learns)]
    for i, e in enumerate(per_epoch):
        log(f"  epoch {i + 1}: rollout {e['rollout_s']:.2f} s, learner step "
            f"{e['learner_step_s']:.3f} s; launches per learner step {e['learner_launches']}; "
            f"per rollout {e['rollout_launches']}; counters {e['after']}")
    log(f"  autoscaler decisions: {decisions}")
    log(f"  losses {losses}; fitness {fitnesses}; adapter moved between published epochs by "
        f"{moved}; epochs {epochs}; telemetry pods {snapshots}; {fly_s:.1f} s; peak memory "
        f"{peak_gb:.1f} GB")
    check(len(learns) == FLY_EPOCHS and len(losses) == FLY_EPOCHS, "flywheel: learner epochs")
    check(all(np.isfinite(x) for x in losses), f"flywheel: losses {losses}")
    check(all(e["learner_launches"] == want for e in per_epoch),
          f"flywheel: launches per learner step != {want}")
    check(all(set(e["rollout_launches"].values()) == {0} for e in per_epoch),
          "flywheel: a rollout with captured logprobs launched a kernel")
    check(reg.counter("flywheel/logprob_forwards_saved_total").value == len(rollouts),
          "flywheel: a rollout did not use its captured logprobs")
    check(epochs == list(range(FLY_EPOCHS + 1)) and all(m > 0 for m in moved),
          "flywheel: the adapter did not move between published epochs")
    check(latest == FLY_EPOCHS and all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(published), tree_leaves(adapters[-1]))),
          "flywheel: the newest published epoch is not the learner's adapter")
    check(all(fly_launches[k] == FLY_EPOCHS * want[k] for k in want),
          f"flywheel path launches {fly_launches} != {FLY_EPOCHS} learner steps")
    check(snapshots == ["pod_rollout_0"], f"telemetry export: {snapshots}")

    # a rollout without captured logprobs runs the dense behavior forward:
    # one scoring pass through flash #1 and fused #5 (comparison launches,
    # after the path's counts were read), here under the adapter epoch the
    # last batch was decoded with
    last = rollouts[-1]["out"]
    agent.actor.params = lora_from_numpy(adapters[last.weight_epoch], device="cuda")
    before = ops.kernel_counters()
    dense = agent.behavior_logprobs(last.ids, last.action_masks)
    after = ops.kernel_counters()
    dense_launches = {k: after[k] - before[k] for k in after}
    check(dense_launches["flash_attention_fwd"] == L and dense_launches["fused_logprob_fwd"] == 1,
          f"dense behavior forward: launches {dense_launches}")
    am = last.action_masks > 0
    d = np.abs(last.behavior_lp - dense)[am]
    log(f"  captured behavior record vs the dense forward (flash {L}, fused 1 launches): "
        f"mean|d| {d.mean():.3e}, max|d| {d.max():.3e}")
    check(d.mean() <= max(CAPTURE_FACTOR * report["serving"]["captured"]["scoring_mean"],
                          CAPTURE_FLOOR["mean"])
          and d.max() <= max(CAPTURE_FACTOR * report["serving"]["captured"]["scoring_max"],
                             CAPTURE_FLOOR["max"]),
          "flywheel: captured behavior logprobs far from the dense forward")
    report["flywheel"] = dict(
        epochs=per_epoch, losses=losses, fitnesses=fitnesses, autoscale=decisions,
        adapter_moved=moved, seconds=fly_s, peak_memory_gb=peak_gb, launches=fly_launches,
        dense_behavior_launches=dense_launches, captured_vs_dense_mean=float(d.mean()),
        captured_vs_dense_max=float(d.max()), replicas_after=len(fleet.replica_ids))

    # each learner kernel at the shapes of the last learner batch
    tokens, mask, loss_mask = agent._learn_masks(last.ids, last.action_masks,
                                                 last.attention_mask)
    report["flywheel"]["kernel_checks"] = check_learn_kernels(
        torch, M, tfa, tfl, cfg, params, agent.actor.params,
        [("learner batch", tokens, mask, loss_mask)], "flywheel learner")
    del fleet, agent, rollouts, learns, adapters, applies
    torch.cuda.empty_cache()
    fleet_small(torch, M, G, ops, report)
    return fly_launches


def fleet_small(torch, M, G, ops, report):
    """A small f32 model on the card against the CPU: the unified fleet, the
    disaggregated fleet, a fleet after kill_replica, one ContinuousGenerator
    and dense greedy generate give the same tokens on both devices; on the
    card the staleness-0 flywheel gives the interleaved loop's losses on the
    same batches, and a weight-epoch bump flushes every replica's prefix
    cache; the card's flywheel batches through a learner pod on the CPU
    give the card's losses and adapter."""
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.algorithms.grpo import GRPO
    from agilerl_tpu_torch.llm.fleet import ServingFleet
    from agilerl_tpu_torch.llm.flywheel import (LearnerPod, OnlineGRPOFlywheel, RolloutPod,
                                                TrajectoryStore, WeightStore)
    from agilerl_tpu_torch.llm.serving import ContinuousGenerator
    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.training.train_llm import finetune_llm_reasoning
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = M.GPTConfig(vocab_size=1000, n_layer=2, n_head=4, n_kv_head=2, d_model=256,
                      max_seq_len=256, tie_embeddings=False, dtype=torch.float32)
    params = M.init_params(7, cfg, device="cpu")
    params = {k: ({i: {n: (w * 8 if w.dim() == 2 else w) for n, w in b.items()}
                   for i, b in v.items()} if k == "blocks" else v * 8)
              for k, v in params.items()}
    on = {"cpu": params, "cuda": tree_map(lambda t: t.cuda(), params)}
    rng = np.random.default_rng(0)
    base = [rng.integers(1, 1000, size=n).astype(np.int32) for n in (9, 30, 17, 60)]
    seqs = base + base[:3]
    kw = dict(max_new_tokens=12, prompt_buckets=(32, 64), block_size=16, slots=3,
              decode_chunk=4)
    out = {}
    with tempfile.TemporaryDirectory() as xfer:
        for dev, p in on.items():
            rows = {}
            dense = {}
            for Pb in (32, 64):
                idx = [i for i, s in enumerate(seqs) if (32 if len(s) <= 32 else 64) == Pb]
                toks, mask = G.left_pad([seqs[i] for i in idx], 0, Pb)
                comp, _ = G.generate(cfg, p, torch.as_tensor(toks, device=dev),
                                     torch.as_tensor(mask, device=dev), None,
                                     max_new_tokens=12, temperature=0.0)
                dense.update(zip(idx, comp.cpu().numpy()))
            rows["dense"] = np.stack([dense[i] for i in range(len(seqs))])
            gen = ContinuousGenerator(cfg, metrics=MetricsRegistry(), device=dev, **kw)
            rows["single"] = gen.generate(seqs, 0, p, greedy=True)[0]
            fl = ServingFleet(cfg, 2, metrics=MetricsRegistry(), device=dev, **kw)
            rows["unified"] = fl.generate(seqs, 0, p, greedy=True)[0]
            fl = ServingFleet(cfg, 2, topology="disaggregated", transfer_dir=f"{xfer}/{dev}",
                              metrics=MetricsRegistry(), device=dev, **kw)
            rows["disaggregated"] = fl.generate(seqs, 0, p, greedy=True)[0]
            check(fl.metrics.counter("fleet/kv_imports_total").value > 0,
                  f"small {dev}: no KV import")
            fl = ServingFleet(cfg, 2, metrics=MetricsRegistry(), device=dev, **kw)
            tickets = [fl.submit(s, key=[0, i], no_shed=True) for i, s in enumerate(seqs)]
            fl.step(p, greedy=True)
            fl.kill_replica(fl.replica_ids[0])
            fl.run_until_drained(p, greedy=True)
            rows["failover"] = np.stack([fl.result(t)[0] for t in tickets])
            for name, r in rows.items():
                check(np.array_equal(r, rows["dense"]), f"small {dev}: {name} != dense greedy")
            out[dev] = rows["dense"]
    check(np.array_equal(out["cuda"], out["cpu"]), "small fleet: card and CPU greedy differ")

    # the staleness-0 flywheel against the interleaved loop, on the card
    tok = CharTokenizer()

    def env():
        # distinct characters: a reward that differs between sampled
        # completions, so no group's advantage is all zero
        return ReasoningGym(arith_rows(16, 0), arith_rows(4, 1), tok,
                            reward_fn=lambda c, a, p: float(len(set(c))), data_batch_size=2)

    # the char vocabulary and unscaled init weights: sampled completions vary
    cfg_fly = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    p0 = M.init_params(7, cfg_fly, device="cuda")

    def agent():
        return GRPO(config=cfg_fly, base_params=p0, pad_token_id=0,
                    eos_token_id=tok.eos_token_id, seed=0, group_size=2, batch_size=4,
                    max_output_tokens=4, lr=1e-3)

    ref, losses = agent(), []
    learn = ref.learn
    ref.learn = lambda batch: losses.append(learn(batch)[0]) or (losses[-1], 0.0)
    finetune_llm_reasoning([ref], env(), max_steps=3, evaluation_interval=10, verbose=False)
    rollouts = []
    with tempfile.TemporaryDirectory() as work:
        fa, reg = agent(), MetricsRegistry()
        ws = WeightStore(f"{work}/w", metrics=reg)
        ts = TrajectoryStore(f"{work}/t", metrics=reg)
        start = tree_map(lambda t: t.detach().cpu(), fa.actor.params)
        pod = RolloutPod(fa, env(), ws, ts, metrics=reg)
        timed_method(torch, pod, "rollout_once", rollouts, ops=ops)
        fly = OnlineGRPOFlywheel(pod, LearnerPod(fa, ws, ts, max_staleness_epochs=0,
                                                 metrics=reg), metrics=reg)
        fly.run(3)
        # the card's batches through a learner pod on the CPU (the plain
        # versions): rollouts are not replayed there, as a sampled rollout
        # draws from a torch.Generator, whose stream differs by device (as
        # do the seeded initial weights: the CPU learner starts from the card's)
        fc = GRPO(config=cfg_fly, base_params=tree_map(lambda t: t.cpu(), p0), pad_token_id=0,
                  eos_token_id=tok.eos_token_id, seed=0, group_size=2, batch_size=4,
                  max_output_tokens=4, lr=1e-3, device="cpu")
        fc.actor.params = start
        ws_c = WeightStore(f"{work}/wc", metrics=reg)
        ts_c = TrajectoryStore(f"{work}/tc", metrics=reg)
        learner_c = LearnerPod(fc, ws_c, ts_c, max_staleness_epochs=0, metrics=reg)
        for r in rollouts:
            ts_c.publish(r["out"])
            learner_c.step()
    # the first step's loss of equal-length rows is zero up to rounding (the
    # z-scored advantages cancel over the tokens), but its gradient is not:
    # the adapters carry the comparison
    check(np.allclose(fly.learner.losses, losses, rtol=1e-4, atol=1e-7),
          f"small flywheel: losses {fly.learner.losses} != the interleaved loop's {losses}")
    pairs = list(zip(tree_leaves(ref.actor.params), tree_leaves(fa.actor.params)))
    adapter_err = max((a - b).abs().max().item() for a, b in pairs)
    moved = max(a.abs().max().item() for a, _ in pairs[1::2])  # the B matrices start at 0
    check(adapter_err <= 1e-4 * moved and moved > 0,
          f"small flywheel: adapter {adapter_err:.3e} from the interleaved loop's "
          f"(moved {moved:.3e})")
    # the CPU learner shuffles its rows with its own generator: another
    # summation order, which AdamW's per-entry normalisation magnifies where
    # an entry's gradient is small. Its losses are sums of O(1) terms that
    # cancel to zero up to rounding (equal-length rows), so the adapters
    # carry the comparison, in relative L2 over the adapter's change.
    card = [a.cpu() for a in tree_leaves(fa.actor.params)]
    cpu_err = max((a - b).abs().max().item() for a, b in zip(card, tree_leaves(fc.actor.params)))
    cpu_rel = (sum(((a - b) ** 2).sum() for a, b in zip(card, tree_leaves(fc.actor.params)))
               / sum(((a - b) ** 2).sum() for a, b in zip(card, tree_leaves(start)))).sqrt().item()
    check(learner_c.trained_seqs == fly.learner.trained_seqs
          and np.allclose(learner_c.losses, fly.learner.losses, rtol=1e-4, atol=1e-5),
          f"small flywheel: CPU learner losses {learner_c.losses} != the card's "
          f"{fly.learner.losses}")
    check(cpu_rel <= SMALL_FLY_ADAPTER_RTOL,
          f"small flywheel: CPU learner adapter {cpu_rel:.3e} (relative L2) from the card's")

    # a weight-epoch bump flushes every replica's prefix cache
    lora_a = M.init_lora(1, cfg, 4, ("wq", "wv"))
    lora_b = tree_map(lambda t: t + 0.01, lora_a)
    fl = ServingFleet(cfg, 2, metrics=MetricsRegistry(), device="cuda", **kw)
    fl.generate(seqs, 2, on["cuda"], lora=lora_a, greedy=True)
    fl.generate(seqs, 3, on["cuda"], lora=lora_b, greedy=True)
    flushes = [m.gen.metrics.counter("serving/prefix_cache_invalidations_total").value
               for m in fl._serving_members().values()]
    check(all(f >= 1 for f in flushes), f"small fleet: a replica kept its prefix cache {flushes}")
    log(f"  small f32 model, card and CPU: unified, disaggregated and failover fleets, one "
        f"generator and dense greedy give the same tokens; flywheel (staleness 0) losses "
        f"{[round(x, 6) for x in fly.learner.losses]} == the interleaved loop's "
        f"{[round(x, 6) for x in losses]} (rtol 1e-4), adapter max|d| {adapter_err:.3e} "
        f"(moved {moved:.3e}); the card's batches through a CPU learner: losses "
        f"{[round(x, 6) for x in learner_c.losses]}, adapter max|d| {cpu_err:.3e}, relative "
        f"L2 {cpu_rel:.3e} (tol {SMALL_FLY_ADAPTER_RTOL:.0e}); "
        f"prefix-cache flushes per replica on a weight bump {flushes}")
    report["flywheel"]["small"] = dict(losses=fly.learner.losses, interleaved=losses,
                                       adapter_err=adapter_err, adapter_moved=moved,
                                       cpu_losses=learner_c.losses, cpu_adapter_err=cpu_err,
                                       cpu_adapter_rel=cpu_rel,
                                       flushes=flushes)


# ------------------------------- phase 4c ---------------------------------- #


def arith_rows(n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"question": f"{a}+{b}=", "answer": str(a + b)} for a, b in rng.integers(0, 9, (n, 2))]


def arith_reward(completion, answer, prompt):
    return 0.1 * len(completion) + float(completion.startswith(str(answer)))


def run_evolution(torch, M, ops, presets, report):
    """finetune_llm_reasoning over a population of 2 on the arithmetic
    ReasoningGym recipe (CharTokenizer, data batch 4, group 4), llama3-8b
    widths cut to EVO_LAYERS layers; the eval at step 2 runs one tournament
    and one mutation round."""
    import numpy as np

    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.training.train_llm import finetune_llm_reasoning
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym
    from agilerl_tpu_torch.utils.utils import create_population

    tok = CharTokenizer()
    cfg = presets.preset("llama3-8b", n_layer=EVO_LAYERS, vocab_size=tok.vocab_size,
                         max_seq_len=256, remat=False)
    log(f"phase 4c: evolution loop: population 2, llama3-8b widths, {cfg.n_layer} layers, "
        f"char vocab {cfg.vocab_size}")
    env = ReasoningGym(arith_rows(64, 0), arith_rows(8, 1), tok, reward_fn=arith_reward,
                       data_batch_size=4)
    pop = create_population("GRPO", population_size=2, seed=0, config=cfg,
                            base_params=M.init_params(1, cfg), pad_token_id=tok.pad_token_id,
                            eos_token_id=tok.eos_token_id, group_size=4, batch_size=16,
                            max_output_tokens=16, lora_rank=LORA_RANK)
    tournament = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
    mutation = Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0, activation=0.0,
                         rl_hp=0.5, rand_seed=0)
    ops.reset_kernel_counters()
    (new_pop, fitnesses), t_loop = host_s(torch, lambda: finetune_llm_reasoning(
        pop, env, max_steps=2, evaluation_interval=2, verbose=True, tournament=tournament,
        mutation=mutation))
    launches = ops.kernel_counters()
    log(f"  2 steps + eval + tournament + mutation in {t_loop:.1f} s; fitnesses {fitnesses}; "
        f"next generation {[(a.index, a.mut) for a in new_pop]}; launches {launches}")
    check(len(new_pop) == 2 and all(len(f) == 1 and np.isfinite(f[0]) for f in fitnesses),
          "evolution loop: population or fitnesses")
    check(max(a.index for a in new_pop) == 2, "no tournament winner was cloned")
    check(all(a.mut in ("None", "lr", "beta", "group_size") for a in new_pop),
          "evolution loop: unexpected mutation")
    check(all(launches[k] > 0 for k in launches if k != "fused_logprob_dw"),
          f"evolution loop missed a kernel: {launches}")
    report["evolution"] = dict(layers=cfg.n_layer, seconds=t_loop, fitnesses=fitnesses,
                               mutations=[a.mut for a in new_pop], launches=launches)


# ------------------------------- phase 4d ---------------------------------- #

DPO_PAIRS = 8  # preference pairs per learn
DPO_GRAD_PAIRS = 2  # pairs in the f32 gradient check (f32 8B weights + activations)
TEXT = "0123456789+-*=() abcdefghijklmnopqrstuvwxyz"  # CharTokenizer's alphabet


def text_rows(n, seed, prompt_len, completion_len):
    """Preference rows of seeded text: a prompt and chosen and rejected
    completions, their lengths drawn from the (low, high) ranges given."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chars = np.array(list(TEXT))

    def text(bounds):
        return "".join(rng.choice(chars, int(rng.integers(bounds[0], bounds[1] + 1))))

    return [{"prompt": text(prompt_len), "chosen": text(completion_len),
             "rejected": text(completion_len)} for _ in range(n)]


def check_learn_kernels(torch, M, tfa, tfl, cfg, params, lora, sides, path):
    """Each kernel of a learn path against its plain version at the shapes
    the path gave it, at phase 3's tolerances, for each (name, ids, mask,
    loss mask) in ``sides``: the fused forward and dH on that pass's own
    hidden states [B (T-1), 4096] against the [4096, 128256] head (dH's
    upstream: a seeded coefficient per row times the loss mask, as the
    sequence losses give it); the bf16 flash forward, dQ and dK/dV on seeded
    q/k/v [B, 32/8, T, 128] and dO in the model's strided views, under the
    side's padding mask. Returns the worst errors."""
    g = torch.Generator(device="cuda").manual_seed(21)
    head = M._head(cfg, params).float().contiguous()
    H, Hkv, d = cfg.n_head, cfg.kv_heads, cfg.head_dim
    worst = {}
    for side, ids, mask, loss_mask in sides:
        B, T = ids.shape
        with torch.no_grad():
            hidden, _ = M.forward(cfg, params, ids, attention_mask=mask, lora=lora, flash=True)
        h = hidden[:, :-1].reshape(-1, hidden.shape[-1])
        t = ids[:, 1:].reshape(-1)
        lp, lse = tfl.fused_logprob_fwd_cuda(h, head, t)
        want_lp, want_lse = tfl._plain_fwd(h, head, t, 1.0)
        up = (torch.randn(B, 1, device="cuda", generator=g) * loss_mask).reshape(-1).contiguous()
        dh = tfl.fused_logprob_dh_cuda(h, head, t, lse, up)
        want_dh = tfl.plain_dh(h, head, t, lse, up)
        torch.cuda.synchronize()
        errs = {"lp": (lp - want_lp).abs().max().item(),
                "lse": (lse - want_lse).abs().max().item(),
                "dh": (dh - want_dh).abs().max().item()}
        case = f"{side} hidden [{h.shape[0]}, {h.shape[1]}] x head {list(head.shape)}"
        log(f"  fused {case}: max|lp-plain| {errs['lp']:.3e}, max|lse-plain| "
            f"{errs['lse']:.3e} (tol 1e-04), max|dH-plain| {errs['dh']:.3e} "
            f"(tol {FUSED_BWD_ATOL:.0e})")
        check(errs["lp"] <= 1e-4 and errs["lse"] <= 1e-4 and errs["dh"] <= FUSED_BWD_ATOL,
              f"fused kernels disagree at the {path} shape: {case}")
        worst[f"fused {side}"] = errs
        del hidden, h, want_lp, want_lse, dh, want_dh
        torch.cuda.empty_cache()

        q, k, v = flash_inputs(torch, B, H, Hkv, T, d, torch.bfloat16, True, g)
        out, flse = tfa.flash_attention_fwd_cuda(q, k, v, mask, True)
        ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, True)
        dout = torch.randn(B, T, H, d, device="cuda", generator=g).to(torch.bfloat16)
        dout = dout.transpose(1, 2)  # the gradient of the model's [B, T, H d] reshape
        dd = (dout.float() * out.float()).sum(-1).contiguous()
        dq = tfa.flash_attention_dq_cuda(q, k, v, dout, flse, dd, mask, True)
        dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, flse, dd, mask, True)
        want = tfa.flash_attention_bwd_reference(q, k, v, dout, flse, dd, mask, True)
        torch.cuda.synchronize()
        r = rows_with_a_visible_key(tfa, mask, True, B, T).expand(flse.shape)
        ferr = {"out": (out[r].float() - ref[r].float()).abs().max().item(),
                "lse": (flse[r] - ref_lse[r]).abs().max().item()}
        case = f"{side} bf16 [{B}, {H}/{Hkv}, {T}, {d}] model views"
        check(ferr["out"] <= 2e-2 and ferr["lse"] <= 1e-4,
              f"flash forward disagrees at the {path} shape: {case}")
        check(bool(torch.isfinite(out.float()).all() and torch.isfinite(flse).all()),
              f"flash forward non-finite at the {path} shape: {case}")
        for name, got, wnt in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err, tol = bwd_error(torch, got, wnt, torch.bfloat16)
            check(bool(torch.isfinite(got.float()).all()) and err <= tol,
                  f"flash {name} disagrees at the {path} shape ({err} > {tol}): {case}")
            ferr[name] = err
        log(f"  flash {case}: max|out-plain| {ferr['out']:.3e} (tol 2e-02), max|lse-plain| "
            f"{ferr['lse']:.3e} (tol 1e-04) over rows with a visible key; dq {ferr['dq']:.2e}, "
            f"dk {ferr['dk']:.2e}, dv {ferr['dv']:.2e} (tol 1 % of the plain output's max)")
        worst[f"flash {side}"] = ferr
        del q, k, v, out, ref, dout, dq, dk, dv, want
        torch.cuda.empty_cache()
    return worst


def run_dpo(torch, M, ops, tfa, tfl, cfg, params, report):
    """Slice 3's path: two DPO learns at llama3-8b (phase 4's weights,
    rank-8 LoRA on wq/wv) on PreferenceGym batches of 8 pairs, DPO.test over
    one eval batch, each kernel at the learn's shapes against its plain
    version, then the adapter gradient of one update through the kernels
    and the plain path (held against f32 by ``f32_grad_agreement``). Returns
    the path's launch counts (set to 0 before the two learns, read after
    them) and the pending gradients."""
    import numpy as np

    from agilerl_tpu_torch.algorithms import dpo as TD
    from agilerl_tpu_torch.utils import tree
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, PreferenceGym

    tok = CharTokenizer()
    lens = ((64, 256), (32, 63))  # rows of at most 256 + 63 + eos = 320 tokens
    env = PreferenceGym(text_rows(DPO_PAIRS, 0, *lens), text_rows(DPO_PAIRS, 1, *lens), tok,
                        data_batch_size=DPO_PAIRS)
    agent = TD.DPO(config=cfg, base_params=params, pad_token_id=tok.pad_token_id,
                   eos_token_id=tok.eos_token_id, seed=0, lora_rank=LORA_RANK,
                   lora_targets=("wq", "wv"))
    log(f"phase 4d: DPO learn at llama3-8b: {DPO_PAIRS} preference pairs (prompts "
        f"{lens[0]} chars, completions {lens[1]}), rank-{LORA_RANK} LoRA on wq/wv, beta "
        f"{agent.beta}, lr {agent.lr}")
    b_before = [ab["B"].clone() for layer in agent.actor.params["blocks"].values()
                for ab in layer.values()]
    times = {"reference": [], "update": []}
    agent._jit_cache["dpo_reference"] = timed_calls(torch, agent._dpo_reference_fn(),
                                                    times["reference"])
    agent._jit_cache["dpo_update"] = timed_calls(torch, agent._dpo_update_fn(), times["update"])
    L = cfg.n_layer
    want = {"flash_attention_fwd": 4 * L, "flash_attention_dq": 2 * L,
            "flash_attention_dkv": 2 * L, "fused_logprob_fwd": 4, "fused_logprob_dh": 2,
            "fused_logprob_dw": 0}
    learns = []
    ops.reset_kernel_counters()
    for it in range(2):
        batch = env.reset()
        before = ops.kernel_counters()
        n_ref, n_up = len(times["reference"]), len(times["update"])
        torch.cuda.reset_peak_memory_stats()
        (loss, acc), t_learn = host_s(torch, lambda: agent.learn(batch))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        after = ops.kernel_counters()
        counts = {k: after[k] - before[k] for k in after}
        check(counts == want, f"DPO learn {it}: launches {counts} != {want}")
        check(np.isfinite(loss), f"DPO learn {it}: loss {loss}")
        t_ref, t_up = times["reference"][n_ref:], times["update"][n_up:]
        shapes = {side: list(batch[f"{side}_ids"].shape) for side in ("chosen", "rejected")}
        learns.append(dict(loss=loss, accuracy=acc, learn_s=t_learn, reference_passes_s=t_ref,
                           update_s=t_up, peak_memory_gb=peak_gb, launches=counts,
                           shapes=shapes))
        log(f"  learn {it}: {t_learn:.3f} s = reference passes {t_ref[0]:.3f} s, update "
            f"{t_up[0]:.3f} s; loss {loss:.5f}, accuracy {acc:.3f}; chosen/rejected "
            f"{shapes['chosen']}/{shapes['rejected']}; peak memory {peak_gb:.1f} GB")
        log(f"    launches in this learn: {counts}")
    launches = ops.kernel_counters()
    moved = max((ab["B"] - b0).abs().max().item() for ab, b0 in zip(
        (ab for layer in agent.actor.params["blocks"].values() for ab in layer.values()),
        b_before))
    log(f"  LoRA B moved by up to {moved:.3e} (two AdamW steps)")
    check(moved > 0, "the LoRA B matrices did not move")
    fitness, t_test = host_s(torch, lambda: agent.test(env))
    log(f"  test over the eval split ({DPO_PAIRS} pairs, one batch): preference accuracy "
        f"{fitness:.3f} in {t_test:.3f} s")
    check(0.0 <= fitness <= 1.0 and agent.fitness == [fitness], "DPO.test fitness")

    # each kernel at the shapes of the last learn's batch
    full = agent._dpo_batch(batch)
    report["dpo_kernel_checks"] = check_learn_kernels(
        torch, M, tfa, tfl, cfg, params, agent.actor.params,
        [(side, full[f"{side}_ids"], full[f"{side}_mask"], full[f"{side}_loss_mask"])
         for side in ("chosen", "rejected")], "DPO")

    # the adapter gradient of one update on the first pairs of the last
    # batch, the reference logprobs (kernels, no gradient) held fixed
    b = {k: v[:DPO_GRAD_PAIRS] for k, v in full.items()}
    ref_c, ref_r = agent._dpo_reference_fn()(agent.reference.params, b)
    beta, smooth, actor = agent.beta, agent.label_smoothing, agent.actor.params
    del agent, full

    def loss_of_path(c, p, flash, fused):
        def seq(lo, side):  # lora_scale left at its default, as DPO's update leaves it
            lp = M.token_logprobs(c, p, b[f"{side}_ids"], attention_mask=b[f"{side}_mask"],
                                  lora=lo, flash=flash, use_fused=fused)
            return (lp * b[f"{side}_loss_mask"]).sum(dim=-1)

        return lambda lo: TD._dpo_loss(seq(lo, "chosen"), seq(lo, "rejected"), ref_c, ref_r,
                                       beta, smooth)[0]

    grads = bf16_grads(torch, tree, actor, loss_of_path, cfg, params,
                       f"DPO, one update on {DPO_GRAD_PAIRS} pairs")
    report["dpo"] = dict(pairs=DPO_PAIRS, learns=learns, lora_b_moved=moved, launches=launches,
                         test_fitness=fitness, test_s=t_test)
    return launches, grads


# ------------------------------- phase 4e ---------------------------------- #


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def recording(fn, into):
    """``fn`` with each result appended to ``into``."""
    def run(*args):
        into.append(fn(*args))
        return into[-1]

    return run


def run_preference_loop(torch, M, ops, presets, report):
    """finetune_llm_preference over a population of 2, llama3-8b widths cut
    to EVO_LAYERS layers; then the same loop at a small f32 size on the card
    and on the CPU from the same weights: the same losses (rtol 1e-5),
    fitnesses and selection."""
    import numpy as np

    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.training.train_llm import finetune_llm_preference
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, PreferenceGym
    from agilerl_tpu_torch.utils.utils import create_population

    tok = CharTokenizer()
    lens = ((16, 48), (4, 12))

    def engines():
        return (TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0)),
                Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0, activation=0.0,
                          rl_hp=0.5, rand_seed=0))

    def env():
        return PreferenceGym(text_rows(16, 2, *lens), text_rows(8, 3, *lens), tok,
                             data_batch_size=4)

    def population(cfg, device, base, lr):
        return create_population("DPO", population_size=2, seed=0, device=device, config=cfg,
                                 base_params=base, pad_token_id=tok.pad_token_id,
                                 eos_token_id=tok.eos_token_id, lora_rank=4,
                                 INIT_HP={"LR": lr})

    cfg = presets.preset("llama3-8b", n_layer=EVO_LAYERS, vocab_size=tok.vocab_size,
                         max_seq_len=256, remat=False)
    log(f"phase 4e: preference loop: population 2, llama3-8b widths, {cfg.n_layer} layers, "
        f"char vocab {cfg.vocab_size}")
    pop = population(cfg, "cuda", M.init_params(1, cfg), 5e-6)
    ops.reset_kernel_counters()
    (new_pop, fitnesses), t_loop = host_s(torch, lambda: finetune_llm_preference(
        pop, env(), max_steps=2, evaluation_interval=2, verbose=True, tournament=engines()[0],
        mutation=engines()[1]))
    launches = ops.kernel_counters()
    log(f"  2 steps + eval + tournament + mutation in {t_loop:.1f} s; fitnesses {fitnesses}; "
        f"next generation {[(a.index, a.mut) for a in new_pop]}; launches {launches}")
    check(len(new_pop) == 2 and all(len(f) == 1 and 0 <= f[0] <= 1 for f in fitnesses),
          "preference loop: population or fitnesses")
    check(max(a.index for a in new_pop) == 2, "no tournament winner was cloned")
    check(launches["fused_logprob_dw"] == 0 and all(
        launches[k] > 0 for k in launches if k != "fused_logprob_dw"),
        f"preference loop: launches {launches}")
    out = dict(layers=cfg.n_layer, seconds=t_loop, fitnesses=fitnesses,
               mutations=[a.mut for a in new_pop], launches=launches)

    small = M.GPTConfig(vocab_size=tok.vocab_size, n_layer=2, n_head=4, n_kv_head=2,
                        d_model=256, max_seq_len=128, dtype=torch.float32)
    base = M.init_params(1, small, device="cpu")
    runs = {}
    for device in ("cpu", "cuda"):
        pop = population(small, device, to_device(base, device), 1e-3)
        if device == "cuda":  # the CPU population's adapters, on the card
            for a, c in zip(pop, runs["cpu"]["pop"]):
                a.actor.params = to_device(c["actor"], device)
                a.reference.params = to_device(c["reference"], device)
                a.optimizer.init(a.actor.params)
        start = [dict(actor=a.actor.params, reference=a.reference.params) for a in pop]
        losses = []
        for a in pop:
            a.learn = recording(a.learn, losses)
        np.random.seed(0)  # clones draw their seeds from the global numpy stream
        new_pop, fitnesses = finetune_llm_preference(
            pop, env(), max_steps=2, evaluation_interval=2, verbose=False,
            tournament=engines()[0], mutation=engines()[1])
        runs[device] = dict(pop=start, losses=losses, fitnesses=fitnesses,
                            selection=[(a.index, a.mut) for a in new_pop])
    cpu, gpu = runs["cpu"], runs["cuda"]
    err = max(abs(g[0] - c[0]) / abs(c[0]) for g, c in zip(gpu["losses"], cpu["losses"]))
    log(f"  small f32 loop, card vs CPU: losses rel err {err:.2e} (tol 1e-5); fitnesses "
        f"{gpu['fitnesses']} / {cpu['fitnesses']}; selection {gpu['selection']}")
    check(err <= 1e-5 and [g[1] for g in gpu["losses"]] == [c[1] for c in cpu["losses"]],
          "small preference loop: the card's losses differ from the CPU's")
    check(gpu["fitnesses"] == cpu["fitnesses"] and gpu["selection"] == cpu["selection"],
          "small preference loop: fitnesses or selection differ from the CPU's")
    out.update(small_loss_rel_err=err, small_fitnesses=gpu["fitnesses"])
    report["preference_loop"] = out


def run_offline_hf_moe(torch, M, report):
    """ILQL (one learn, greedy and beam generate) at test_ilql.py's size, the
    HF loader on both committed fixtures, and an MoE forward with
    return_aux: each on the card against the same call on the CPU, or
    against the fixtures' golden logits."""
    from pathlib import Path

    import numpy as np

    from agilerl_tpu_torch.algorithms import ilql as TI
    from agilerl_tpu_torch.data.rl_data import Language_Observation, RL_Dataset
    from agilerl_tpu_torch.llm import hf as H
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer
    from agilerl_tpu_torch.utils.tree import tree_leaves

    out = {}
    tok = CharTokenizer()
    cfg = M.GPTConfig(vocab_size=tok.vocab_size, n_layer=2, n_head=4, d_model=64,
                      max_seq_len=32, dtype=torch.float32)
    rng = np.random.default_rng(0)
    obs = []
    for _ in range(32):
        a, good = int(rng.integers(0, 5)), bool(rng.random() < 0.5)
        obs.append(Language_Observation(sequence=[(f"{a}+1=", None),
                                                  (str(a + good), 1.0 if good else -1.0)]))
    batch = RL_Dataset(obs, tok, max_len=8).sample_batch(8, np.random.default_rng(0))
    agents = {d: TI.ILQL(config=cfg, lr=1e-3, seed=0, device=d) for d in ("cpu", "cuda")}
    agents["cuda"].actor.params = to_device(agents["cpu"].actor.params, "cuda")
    agents["cuda"].target_q.params = to_device(agents["cpu"].target_q.params, "cuda")
    agents["cuda"].optimizer.init(agents["cuda"].actor.params)
    steps = {}
    for d, agent in agents.items():
        step = agent.jit_fn("train", agent._loss_fn)
        p, tq, opt, total, terms = step(agent.actor.params, agent.target_q.params,
                                        agent.optimizer.opt_state,
                                        TI._offline_batch(batch, torch.device(d)))
        agent.actor.params, agent.target_q.params, agent.optimizer.opt_state = p, tq, opt
        steps[d] = [total.item(), *(t.item() for t in terms)], opt.inner_state[0].mu, tq
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(steps["cuda"][0], steps["cpu"][0]))
    grad_err = max((g.cpu() - c).abs().max().item() / c.abs().max().item()
                   for g, c in zip(tree_leaves(steps["cuda"][1]), tree_leaves(steps["cpu"][1])))
    tq_err = max((g.cpu() - c).abs().max().item()
                 for g, c in zip(tree_leaves(steps["cuda"][2]), tree_leaves(steps["cpu"][2])))
    prompts = np.array([tok.encode("3+1="), tok.encode("4+1=")], np.int32)
    gen = {d: [a.generate(prompts, np.ones_like(prompts), max_new_tokens=3, mode=m,
                          beam_width=3) for m in ("greedy", "beam")] for d, a in agents.items()}
    same = all(np.array_equal(g, c) for gm, cm in zip(gen["cuda"], gen["cpu"])
               for g, c in zip(gm, cm))
    log(f"  ILQL at test size, card vs CPU: loss and its 4 terms rel err {loss_err:.2e} (tol "
        f"1e-5); gradients {grad_err:.2e} of each leaf's largest (tol 1e-5); polyak target "
        f"{tq_err:.2e} (tol 5e-6); greedy and beam tokens identical: {same}")
    check(loss_err <= 1e-5 and grad_err <= 1e-5 and tq_err <= 5e-6 and same,
          "ILQL on the card disagrees with the CPU")
    out["ilql"] = dict(loss_rel_err=loss_err, grad_rel_err=grad_err, target_err=tq_err,
                       tokens_identical=same)

    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures"
    for name in ("hf_llama_tiny", "hf_qwen2_tiny"):
        golden = np.load(fixtures / name / "golden_logits.npz")
        ids = torch.as_tensor(golden["token_ids"]).long().cuda()
        c32, p32 = H.load_hf_model(str(fixtures / name), dtype=torch.float32)
        got = M.apply(c32, p32, ids)[0].cpu().numpy()
        err = float(np.max(np.abs(got - golden["logits"]) - 1e-4 * np.abs(golden["logits"])))
        c16, p16 = H.load_hf_model(str(fixtures / name))
        coarse = M.apply(dataclasses.replace(c16, dtype=torch.float32), p16, ids)[0]
        scale = float(np.abs(golden["logits"]).max())
        err16 = float(np.max(np.abs(coarse.cpu().numpy() - golden["logits"]))) / scale
        log(f"  HF loader {name} on the card vs golden logits: f32 max(|d| - 1e-4 |ref|) "
            f"{err:.2e} (tol 2e-4); bf16 max|d| / max|ref| {err16:.2e} (tol 3e-2)")
        check(err <= 2e-4 and err16 <= 3e-2, f"{name}: loaded weights disagree with golden")
        out[name] = dict(f32_err=err, bf16_rel_err=err16)

    moe = M.GPTConfig(vocab_size=64, n_layer=4, n_head=2, d_model=32, max_seq_len=32,
                      n_experts=4, moe_every=2, dtype=torch.float32)
    params = M.init_params(3, moe, device="cpu")
    tokens = (torch.arange(24).reshape(2, 12) * 5) % 64
    res = {d: M.apply(moe, to_device(params, d), tokens.to(d), return_aux=True)
           for d in ("cpu", "cuda")}
    l_err = ((res["cuda"][0].cpu() - res["cpu"][0]).abs()
             - 1e-5 * res["cpu"][0].abs()).max().item()
    a_err = abs(res["cuda"][2].item() - res["cpu"][2].item()) / res["cpu"][2].item()
    log(f"  MoE forward (moe_every 2, 4 experts) card vs CPU: logits max(|d| - 1e-5 |ref|) "
        f"{l_err:.2e} (tol 1e-5); aux {res['cuda'][2].item():.6f}, rel err {a_err:.2e} "
        f"(tol 1e-5)")
    check(l_err <= 1e-5 and a_err <= 1e-5, "MoE on the card disagrees with the CPU")
    out["moe"] = dict(logits_err=l_err, aux_rel_err=a_err, aux=res["cuda"][2].item())
    report["offline_hf_moe"] = out


# ------------------------------- phase 4h ---------------------------------- #
# configs/training/ppo.yaml (the card's machine has no PyYAML): evolutionary
# PPO on CartPole-v1, 16 envs, population 4. Cuts, for time: MAX_STEPS
# 200,000 -> 4,096 and EVO_STEPS 10,240 -> 2,048 (2 generations of one
# collect + learn pair per agent, 2,048 steps each; 8,192 / 5,120, two pairs,
# until the resilience phase 4s came; 10,240 ran a third generation until
# the slice of the evolvable transformers, the bandits and the PettingZoo
# envs came).
PPO_ENV = "CartPole-v1"
PPO_INIT_HP = {"POP_SIZE": 4, "BATCH_SIZE": 256, "LR": 3e-4, "GAMMA": 0.99, "GAE_LAMBDA": 0.95,
               "CLIP_COEF": 0.2, "ENT_COEF": 0.01, "VF_COEF": 0.5, "MAX_GRAD_NORM": 0.5,
               "UPDATE_EPOCHS": 4, "LEARN_STEP": 128, "NUM_ENVS": 16}
PPO_NET = {"latent_dim": 32, "encoder_config": {"hidden_size": (64,)}}
PPO_MUTATION = dict(no_mutation=0.4, architecture=0.2, parameters=0.2, activation=0.0,
                    rl_hp=0.2)
PPO_TOURNAMENT = (2, True, 4, 1)  # size, elitism, population, eval loop
PPO_EVO_STEPS = 2_048  # cut from 10,240
PPO_MAX_STEPS = 4_096  # cut from 200,000
# tests/test_algorithms/test_ppo.py:87-108: the probe checks' settings
PPO_PROBE = dict(num_envs=8, learn_step=16, batch_size=64, update_epochs=4, lr=3e-3, gamma=0.5,
                 ent_coef=0.05, seed=3,
                 net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}})
PPO_PROBE_ITERS = 80
# card against CPU, f32 with TF32 off: env steps within a few ulps of
# sin/cos (atol 1e-5; a termination flag may differ only within 1e-5 of its
# bound); logp and value atol 1e-5; GAE atol 1e-5 (128 steps of
# accumulation); one learn of one minibatch: loss rtol 1e-5, Adam's first
# moment within 1e-5 of each leaf's largest entry, weights atol 5e-6 where
# |g| >= 1e-6 or g == 0 (below, Adam's first step turns summation order
# into steps of up to lr)
PPO_ENV_ATOL = 1e-5
PPO_NET_ATOL = 1e-5
PPO_GAE_ATOL = 1e-5
PPO_LOSS_RTOL = 1e-5
PPO_WEIGHT_ATOL = 5e-6


def flat_params(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def preserved_ok(torch, before, after):
    """Every leaf's overlap with its pre-mutation self equals it bit for bit."""
    for path, new in flat_params(after).items():
        old = before.get(path)
        if old is None or old.dim() != new.dim():
            continue
        sl = tuple(slice(0, min(o, n)) for o, n in zip(old.shape, new.shape))
        if not torch.equal(old[sl], new[sl]):
            return False
    return True


def count_syncs_reference(torch, fn):
    """(result, host syncs, {"file:line": count} of where they happened) of
    ``fn`` under torch.cuda.set_sync_debug_mode: the script's own counter
    from before ``agilerl_tpu_torch.analysis.SyncGuard``, which every phase
    now counts with. Kept only so that phase 4w (b) holds the guard to it."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            # the innermost frames of the port or of torch's Python code
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "agilerl_tpu_torch" in f.filename or "/torch/" in f.filename]
            sites[" < ".join(f"{Path(f.filename).parent.name}/{Path(f.filename).name}"
                             f":{f.lineno}" for f in frames[::-1][:3])] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    return out, sum(sites.values()), dict(sites)


def ppo_mutation_checks(torch, agent, env, report):
    """One mutation of each class on ``agent`` (a clone of the elite), each
    followed by a collect and a learn: finite losses, preserved slabs
    bit-equal to the pre-mutation weights, the buffer's horizon following
    learn_step."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.core.registry import HyperparameterConfig
    from agilerl_tpu_torch.algorithms.ppo import default_hp_config
    from agilerl_tpu_torch.hpo import Mutations
    from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts

    hp_all = default_hp_config()
    rows = []
    steps = (["encoder.add_layer", "encoder.add_node", "encoder.remove_node", "add_latent_node",
              "param", "batch_size", "learn_step"])
    for i, what in enumerate(steps):
        before = {n: flat_params(getattr(agent, n).params) for n in ("actor", "critic")}
        mut = Mutations(no_mutation=0, architecture=0, parameters=0, activation=0, rl_hp=0,
                        rand_seed=100 + i)
        if what == "param":
            mut.parameter_mutation(agent)
            changed = sum(int((before["actor"][p] != v).sum())
                          for p, v in flat_params(agent.actor.params).items())
            total = sum(v.numel() for v in before["actor"].values())
            check(0.05 < changed / total < 0.15,
                  f"parameter noise touched {changed} of {total} entries")
            check(preserved_ok(torch, before["critic"], agent.critic.params),
                  "parameter noise moved the critic")
        elif what in ("batch_size", "learn_step"):
            kept = agent.registry.hp_config
            agent.registry.hp_config = HyperparameterConfig(**{what: hp_all[what]})
            mut.rl_hyperparam_mutation(agent)
            agent.registry.hp_config = kept
            check(agent.mut == what, f"rl-hp draw gave {agent.mut}")
        else:
            seed = 7 + i
            for n in ("actor", "critic"):
                getattr(agent, n).apply_mutation(what, rng=np.random.default_rng(seed))
            agent.reinit_optimizers()
            agent.mutation_hook()
            agent.mut = what
            for n in ("actor", "critic"):
                check(preserved_ok(torch, before[n], getattr(agent, n).params),
                      f"{what}: {n}'s preserved slabs moved")
        agent._last_obs = None
        reward = collect_rollouts(agent, env)
        loss = agent.learn()
        rows.append(dict(mutation=agent.mut, loss=loss, reward=reward,
                         learn_step=agent.learn_step, batch_size=agent.batch_size,
                         buffer_rows=int(agent.rollout_buffer.state.data["obs"].shape[0]),
                         encoder=list(agent.actor.config.encoder.hidden_size),
                         head=list(agent.actor.config.head.hidden_size),
                         latent=agent.actor.config.latent_dim))
        check(np.isfinite(loss), f"{what}: learn gave {loss}")
        check(agent.rollout_buffer.capacity == agent.learn_step == rows[-1]["buffer_rows"],
              f"{what}: buffer rows {rows[-1]['buffer_rows']} for learn_step {agent.learn_step}")
        log(f"  {what}: {rows[-1]}")
    report["mutations"] = rows


def ppo_card_vs_cpu(torch, agent, report):
    """The env step, get_action_and_value's logp and value, GAE and one learn
    on the card against the CPU, on the same states, weights and buffer."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy
    from agilerl_tpu_torch.algorithms.ppo import PPO
    from agilerl_tpu_torch.components.rollout_buffer import _compute_gae
    from agilerl_tpu_torch.envs import classic
    from agilerl_tpu_torch.utils.tree import tree_to_numpy

    out = {}
    rng = np.random.default_rng(0)
    n = 4096
    bounds = {"CartPole-v1": [(0, 2.4), (2, 12 * 3.141592653589793 / 180)],
              "MountainCar-v0": [(0, 0.5)]}
    for name, fields in (("CartPole-v1", [(-2.6, 2.6), (-3, 3), (-0.25, 0.25), (-3, 3)]),
                         ("Pendulum-v1", [(-7, 7), (-8, 8)]),
                         ("MountainCar-v0", [(-1.25, 0.6), (-0.07, 0.07)])):
        env = classic.make(name)
        vals = [rng.uniform(lo, hi, n).astype(np.float32) for lo, hi in fields]
        if hasattr(env.action_space, "n"):
            act = rng.integers(0, env.action_space.n, n)
        else:
            act = rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)
        res = {}
        for dev in ("cuda", "cpu"):
            state = type(env.reset_fn(1, torch.Generator(device=dev))[0])(
                *(torch.from_numpy(v).to(dev) for v in vals))
            res[dev] = env.step_fn(state, torch.from_numpy(act).to(dev),
                                   torch.Generator(device=dev))
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            [*res["cuda"][0], res["cuda"][1], res["cuda"][2]],
            [*res["cpu"][0], res["cpu"][1], res["cpu"][2]]))
        flips = res["cuda"][3].cpu() != res["cpu"][3]
        near = torch.zeros(n, dtype=torch.bool)
        obs = res["cpu"][1]
        for col, b in bounds.get(name, []):
            near |= (obs[:, col].abs() - b).abs() <= PPO_ENV_ATOL
        check(err <= PPO_ENV_ATOL, f"{name} step on the card vs CPU: {err}")
        check(not bool((flips & ~near).any()), f"{name}: termination differs off its bound")
        out[f"env_{name}"] = dict(max_abs_err=err, flag_flips=int(flips.sum()))

    args = dict(agent.init_dict, update_epochs=1,
                batch_size=agent.learn_step * agent.num_envs)
    cuda_agent = PPO(**{**args, "device": "cuda"}, seed=1)
    cpu_agent = PPO(**{**args, "device": "cpu"}, seed=1)
    trees = {n: tree_to_numpy(getattr(agent, n).params) for n in ("actor", "critic")}
    for a in (cuda_agent, cpu_agent):
        for n in ("actor", "critic"):  # the elite's mutated architecture
            getattr(a, n).config = getattr(agent, n).config
        load_params_from_numpy(a, trees)
    T, N = cuda_agent.learn_step, cuda_agent.num_envs
    obs = rng.uniform(-1, 1, (T, N, 4)).astype(np.float32) * np.array([2.4, 3, 0.2, 3], np.float32)
    actions = rng.integers(0, 2, (T, N))
    logp_v = {}
    for a, dev in ((cuda_agent, "cuda"), (cpu_agent, "cpu")):
        o = torch.from_numpy(obs.reshape(-1, 4)).to(dev)
        lp, _ = a.actor.evaluate_actions(o, torch.from_numpy(actions.reshape(-1)).to(dev))
        logp_v[dev] = (lp.cpu(), a.value_of(o).cpu())
    err = max(float((x - y).abs().max()) for x, y in zip(logp_v["cuda"], logp_v["cpu"]))
    check(err <= PPO_NET_ATOL, f"logp/value on the card vs CPU: {err}")
    out["logp_value_max_abs_err"] = err

    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.05).astype(np.float32)
    values = logp_v["cpu"][1].numpy().reshape(T, N)
    last = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
    gae = {dev: _compute_gae(*(torch.from_numpy(x).to(dev) for x in
                               (rewards, values, dones, values[-1])), None, 0.99, 0.95)
           for dev in ("cuda", "cpu")}
    err = max(float((x.cpu() - y).abs().max()) for x, y in zip(gae["cuda"], gae["cpu"]))
    check(err <= PPO_GAE_ATOL, f"GAE on the card vs CPU: {err}")
    out["gae_max_abs_err"] = err

    noise = rng.normal(size=(T, N)).astype(np.float32) * 0.2
    for a in (cuda_agent, cpu_agent):
        lp = logp_v["cpu"][0].numpy().reshape(T, N) + noise
        for t in range(T):
            a.rollout_buffer.add(obs=obs[t], action=actions[t], reward=rewards[t],
                                 done=dones[t], value=values[t], log_prob=lp[t])
        a._last_obs = last
        a._last_done = torch.zeros(N, device=a.dev)
    losses = [cuda_agent.learn(), cpu_agent.learn()]
    check(abs(losses[0] - losses[1]) <= PPO_LOSS_RTOL * abs(losses[1]) + 1e-7,
          f"learn loss on the card vs CPU: {losses}")
    mu = [flat_params(a.optimizer.opt_state[1].inner_state[0].mu) for a in
          (cuda_agent, cpu_agent)]
    worst_mu, worst_w, exempt, total = 0.0, 0.0, 0, 0
    for (p, m_gpu), w_gpu, w_cpu in zip(
            mu[0].items(),
            flat_params({"actor": cuda_agent.actor.params, "critic": cuda_agent.critic.params}).values(),
            flat_params({"actor": cpu_agent.actor.params, "critic": cpu_agent.critic.params}).values()):
        m_cpu = mu[1][p]
        scale = float(m_cpu.abs().max()) + 1e-12
        worst_mu = max(worst_mu, float((m_gpu.cpu() - m_cpu).abs().max()) / scale)
        g = m_cpu.abs() / 0.1
        ok = (g >= 1e-6) | (g == 0)
        exempt += int((~ok).sum())
        total += ok.numel()
        if ok.any():
            worst_w = max(worst_w, float((w_gpu.cpu() - w_cpu)[ok].abs().max()))
    check(worst_mu <= 1e-5, f"Adam first moment on the card vs CPU: {worst_mu}")
    check(worst_w <= PPO_WEIGHT_ATOL, f"weights after learn on the card vs CPU: {worst_w}")
    check(exempt < 0.1 * total, f"{exempt} of {total} weights held by gradient alone")
    out.update(learn_loss=losses, first_moment_rel_err=worst_mu, weight_max_abs_err=worst_w,
               weights_held_by_gradient=exempt, weights=total)
    log(f"  card vs CPU: {out}")
    report["card_vs_cpu"] = out


def run_on_policy(torch, ops, report):
    """Phase 4h: evolutionary PPO at configs/training/ppo.yaml's widths
    through train_on_policy (2 generations), each mutation class followed
    by a learn, both PPO probe checks, the card against the CPU, and the
    host syncs of one collect_rollouts."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.ppo import PPO
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.envs.probe import (
        FixedObsPolicyEnv,
        PolicyEnv,
        check_policy_on_policy_with_probe_env,
    )
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts
    from agilerl_tpu_torch.training.train_on_policy import train_on_policy
    from agilerl_tpu_torch.utils.utils import create_population, make_vect_envs

    out = {}
    log(f"phase 4h: evolutionary PPO on {PPO_ENV}, {PPO_INIT_HP['NUM_ENVS']} envs, "
        f"population {PPO_INIT_HP['POP_SIZE']}, max_steps {PPO_MAX_STEPS} (cut from 200,000)")
    # clones (the tournament's) and rollout buffers draw their seeds from the
    # global numpy stream, as in the JAX package: seed it so the phase replays
    np.random.seed(0)
    env = make_vect_envs(PPO_ENV, PPO_INIT_HP["NUM_ENVS"])
    check(env.device.type == "cuda", f"make_vect_envs put the env on {env.device}")
    pop = create_population("PPO", env.single_observation_space, env.single_action_space,
                            PPO_NET, PPO_INIT_HP, num_envs=PPO_INIT_HP["NUM_ENVS"], seed=0)
    check(all(a.dev.type == "cuda" for a in pop), "create_population left the card")
    sink = MemorySink()
    telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
    tournament = TournamentSelection(*PPO_TOURNAMENT, rng=np.random.default_rng(0))
    mutation = Mutations(**PPO_MUTATION, rand_seed=0)
    ops.reset_kernel_counters()
    (pop, fitnesses), t_loop = host_s(torch, lambda: train_on_policy(
        env, PPO_ENV, "PPO", pop, INIT_HP=PPO_INIT_HP, max_steps=PPO_MAX_STEPS,
        evo_steps=PPO_EVO_STEPS, tournament=tournament, mutation=mutation, telemetry=telem,
        verbose=False))
    launches = ops.kernel_counters()
    gens = [e for e in sink.events if e["kind"] == "generation"]
    env_steps = gens[-1]["total_steps"]
    for g in gens:
        g["ms_per_learn"] = 1e3 * g["learn_s"] / g["learn_calls"]
        log(f"  generation {g['generation']}: collect {g['collect_s']:.2f} s, learn "
            f"{g['learn_s']:.2f} s ({g['ms_per_learn']:.1f} ms per learn), eval "
            f"{g['eval_s']:.2f} s, tournament + mutation {g['evo_s']:.3f} s; fitness "
            f"{[round(f, 1) for f in g['fitness']]}; mutations {g['mutations']}")
    out.update(loop_s=t_loop, env_steps=env_steps, env_steps_per_s=env_steps / t_loop,
               generations=[{k: g[k] for k in ("generation", "collect_s", "learn_s",
                                               "learn_calls", "ms_per_learn", "eval_s",
                                               "evo_s", "fitness", "mutations")} for g in gens],
               launches=launches)
    log(f"  {env_steps} env steps in {t_loop:.1f} s: {env_steps / t_loop:.0f} env-steps/s; "
        f"kernel launches {launches}")
    # a learn_step mutation can leave an agent short of EVO_STEPS per
    # generation (evo_steps // (learn_step * num_envs) learns): one more then.
    # Every agent adds at least the fewest steps any learn_step of its range
    # gives a generation, which bounds the count from above.
    ls_range = pop[0].registry.hp_config["learn_step"]
    n_envs = PPO_INIT_HP["NUM_ENVS"]
    fewest = min(max(PPO_EVO_STEPS // (ls * n_envs), 1) * ls * n_envs
                 for ls in range(int(ls_range.min), int(ls_range.max) + 1))
    most_gens = -(-PPO_MAX_STEPS // fewest)
    out.update(most_generations=most_gens)
    check(PPO_MAX_STEPS // PPO_EVO_STEPS <= len(gens) <= most_gens,
          f"{len(gens)} generations, not {PPO_MAX_STEPS // PPO_EVO_STEPS}..{most_gens}")
    check(all(np.isfinite(f).all() and len(f) == len(gens) for f in fitnesses),
          f"fitnesses {fitnesses}")
    check(all(a.steps[-1] >= PPO_MAX_STEPS for a in pop), "agents short of max_steps")

    elite = pop[0].clone(index=100)
    t0 = time.perf_counter()
    ppo_mutation_checks(torch, elite, env, out)
    out["mutation_checks_s"] = time.perf_counter() - t0

    # host syncs of one collect_rollouts and one learn (design target: O(1))
    elite._last_obs = None
    with SyncGuard(device="cuda", label="4h collect") as g:
        reward = collect_rollouts(elite, env)
    syncs, sites = g.syncs, g.sites
    with SyncGuard(device="cuda", label="4h learn") as g:
        elite.learn()
    learn_syncs, learn_sites = g.syncs, g.sites
    out.update(collect_syncs=syncs, collect_sync_sites=sites, collect_steps=elite.learn_step,
               learn_syncs=learn_syncs, learn_sync_sites=learn_sites)
    log(f"  host syncs: {syncs} in one collect_rollouts of {elite.learn_step} steps {sites}, "
        f"{learn_syncs} in one learn {learn_sites}")
    # one for the mean reward, one inside torch.cuda (not traced yet); without
    # target_kl a learn reads its losses once
    check(syncs <= 2, f"{syncs} host syncs in one collect_rollouts of {elite.learn_step} steps")
    check(elite.target_kl is None and learn_syncs <= 1, f"{learn_syncs} host syncs in one learn")

    probes = {}
    for env_cls in (FixedObsPolicyEnv, PolicyEnv):
        probe = env_cls()
        t0 = time.perf_counter()
        check_policy_on_policy_with_probe_env(
            probe, PPO, dict(PPO_PROBE, observation_space=probe.observation_space,
                             action_space=probe.action_space), train_iters=PPO_PROBE_ITERS)
        probes[env_cls.__name__] = time.perf_counter() - t0
        log(f"  probe {env_cls.__name__}: passed in {probes[env_cls.__name__]:.1f} s")
    out["probes_s"] = probes

    ppo_card_vs_cpu(torch, elite, out)
    report["on_policy"] = out
    return launches


# ------------------------------- phase 4i ---------------------------------- #
# bench.py's bench_evoppo at its TPU defaults (BASELINE.md's workload):
# CartPole-v1, population 64 x 128 envs x 64 rollout steps, actor and critic
# with an MLP encoder (latent 64, hidden [64]) and an MLP head (hidden [64]),
# adam(3e-4), 1 epoch of 4 minibatches; one warm-up generation, then 2 timed
# (5 until phases 4l and 4m came, 3 until phases 4n and 4o came).
POP = dict(pop=64, num_envs=128, rollout_len=64, latent=64, hidden=64, update_epochs=1,
           num_minibatches=4, lr=3e-4, warmup=1, timed=2)
# tests/test_parallel/test_population.py:100-122, the JAX package's learning
# gate: pop 4, 16 envs, rollout 32, latent 32, hidden 64, 2 epochs, 4
# minibatches, 180 generations; early (first 10) best < 150, late (last 30)
# best > 250 and > 4 x early, mid (55..85) best > 1.5 x early. Seeds fixed
# before the first run; at least two of three must pass.
POP_GATE = dict(pop=4, num_envs=16, rollout_len=32, latent=32, hidden=64, update_epochs=2,
                num_minibatches=4, lr=3e-4, generations=180)
POP_GATE_SEEDS = (0, 1, 2)
# a member alone against its slice of the batched iteration, on the same
# draws (atol 1e-5); one _ppo_update card vs CPU on the same state and rows.
# Weights wherever the member's Adam first moment is >= 1e-6: below it,
# Adam's normalised step turns summation order (bmm against mm, card
# against CPU) into steps of up to lr, so those entries are held through
# their moments alone (phase 4h's rule)
POP_MEMBER_ATOL = 1e-5
POP_WEIGHT_ATOL = 5e-6
POP_MOMENT_RTOL = 1e-5


def evo_ppo(torch, cfg, device=None):
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks import distributions as D
    from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config
    from agilerl_tpu_torch.parallel import EvoPPO

    env = CartPole()
    latent, hidden = cfg["latent"], cfg["hidden"]
    kind, enc = default_encoder_config(env.observation_space, latent_dim=latent,
                                       encoder_config={"hidden_size": (hidden,)})
    nets = [NetworkConfig(encoder_kind=kind, encoder=enc, latent_dim=latent,
                          head=MLPConfig(num_inputs=latent, num_outputs=n, hidden_size=(hidden,)))
            for n in (2, 1)]
    return EvoPPO(env, *nets, D.dist_config_from_space(env.action_space), adam(cfg["lr"]),
                  num_envs=cfg["num_envs"], rollout_len=cfg["rollout_len"],
                  update_epochs=cfg["update_epochs"], num_minibatches=cfg["num_minibatches"],
                  device=device)


def population_gate_child(seed: int) -> None:
    """One learning-gate run on the card, in its own process (the parent runs
    the three seeds side by side): prints {"seed", "best", "s"}."""
    import torch

    from agilerl_tpu_torch.parallel import ScanRun

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    torch.set_num_threads(1)  # three of these share the host's cores
    run = ScanRun(evo_ppo(torch, POP_GATE), POP_GATE["pop"], seed=seed)
    t0 = time.perf_counter()
    best = [float(f.max()) for f in run.run(POP_GATE["generations"])]
    print(json.dumps({"seed": seed, "best": best, "s": time.perf_counter() - t0}), flush=True)


def gate_verdict(best):
    early, mid, late = (float(sum(x) / len(x)) for x in (best[:10], best[55:85], best[-30:]))
    ok = early < 150 and late > 250 and late > 4 * early and mid > 1.5 * early
    return dict(early=early, mid=mid, late=late, passed=ok)


def parts_of_a_generation(torch, evo, pop, gen):
    """One generation with each part ended on a synchronize: (pop, fitness,
    {"rollout_s", "gae_update_s", "evolve_s"})."""
    t = [time.perf_counter()]
    draws = evo.draw_iteration(pop.ep_ret.shape[0], gen)
    traj, env_state, count, obs, ep_ret, fitness = evo._rollout(pop, draws, gen)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    adv, ret = evo._gae(traj, evo._value_v(pop.critic, obs))
    actor, critic, opt, _ = evo._ppo_update(pop.actor, pop.critic, pop.opt_state, traj, adv,
                                            ret, draws["perm"])
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    pop = pop._replace(actor=actor, critic=critic, opt_state=opt, env_state=env_state,
                       step_count=count, obs=obs, ep_ret=ep_ret)
    pop = evo.evolve(pop, fitness, gen)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    return pop, fitness, dict(rollout_s=t[1] - t[0], gae_update_s=t[2] - t[1],
                              evolve_s=t[3] - t[2])


def profile_generation(torch, fn):
    """Kernel launches and device-busy ms of one call of ``fn`` under
    torch.profiler, with its wall ms; None where the trace shows no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        return dict(launches=None, device_busy_ms=None, wall_ms=1e3 * wall)
    return dict(launches=len(kernels), device_busy_ms=busy_us / 1e3, wall_ms=1e3 * wall,
                idle_share=1.0 - busy_us / 1e3 / (1e3 * wall))


def slice_member(torch, tree, p):
    from agilerl_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x[p:p + 1] if isinstance(x, torch.Tensor) else x, tree)


def weights_rule(torch, got, want, mu):
    """Max |got - want| over entries whose |mu| >= 1e-6 (or mu == 0), and
    the share of entries exempted."""
    from agilerl_tpu_torch.utils.tree import tree_leaves

    worst, exempt, total = 0.0, 0, 0
    for g, w, m in zip(tree_leaves(got), tree_leaves(want), tree_leaves(mu)):
        g, w, m = g.float().cpu(), w.float().cpu(), m.float().cpu()
        ok = (m.abs() >= 1e-6) | (m == 0)
        if ok.any():
            worst = max(worst, float((g - w).abs()[ok].max()))
        exempt += int((~ok).sum())
        total += m.numel()
    return worst, exempt / max(total, 1)


def run_population(torch, ops, report):
    """Phase 4i: the evolutionary population as one program (EvoPPO through
    ScanRun) at bench.py's pop-64 width: env-steps/s of 2 timed
    generations, the seconds of each part, host syncs, peak memory, launches
    and the device's busy share of one generation; a member's slice against
    the member alone; one update card vs CPU; the JAX package's learning
    gate on seeds 0, 1, 2 in three processes side by side."""
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.parallel import ScanRun
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    out = {"config": POP}
    P, N, T = POP["pop"], POP["num_envs"], POP["rollout_len"]
    log(f"phase 4i: EvoPPO population as one program on CartPole-v1: population {P} x {N} "
        f"envs x {T} steps, latent {POP['latent']}, hidden [{POP['hidden']}], "
        f"{POP['update_epochs']} epoch x {POP['num_minibatches']} minibatches")
    evo = evo_ppo(torch, POP)
    check(evo.device.type == "cuda", f"EvoPPO put its population on {evo.device}")
    run = ScanRun(evo, P, seed=0)
    check({x.device.type for x in tree_leaves(run.pop) if isinstance(x, torch.Tensor)}
          == {"cuda"}, "ScanRun's population left the card")
    ops.reset_kernel_counters()
    (first,), warm_s = host_s(torch, lambda: run.run(POP["warmup"]))
    torch.cuda.reset_peak_memory_stats()
    hist, timed_s = host_s(torch, lambda: run.run(POP["timed"]))
    launches = ops.kernel_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = P * N * T * POP["timed"]
    check(hist.shape == (POP["timed"], P) and bool((hist == hist).all()),
          f"fitness history {hist.shape}")
    out.update(warmup_s=warm_s, timed_s=timed_s, env_steps=steps,
               env_steps_per_s=steps / timed_s, s_per_generation=timed_s / POP["timed"],
               peak_gb=peak_gb, launches=launches, first_best=float(first.max()),
               first_mean=float(first.mean()), final_best=float(hist[-1].max()),
               final_mean=float(hist[-1].mean()), smi=nvidia_smi_line(),
               clocks=nvidia_smi_clocks())
    log(f"  {steps} env steps in {timed_s:.3f} s: {steps / timed_s:.0f} env-steps/s, "
        f"{1e3 * timed_s / POP['timed']:.1f} ms per generation (warm-up {warm_s:.2f} s); "
        f"peak {peak_gb:.3f} GB; fitness best/mean {first.max():.1f}/{first.mean():.1f} -> "
        f"{hist[-1].max():.1f}/{hist[-1].mean():.1f}; {out['smi']}")
    # a site that SyncGuard also reports around a region that does nothing is
    # the instrument's own (torch/cuda's set_sync_debug_mode), not the run's
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    with SyncGuard(device="cuda", label="4i generation") as g:
        run.run(1)
    sites = g.sites
    syncs = sum(n for site, n in sites.items() if site not in base_sites)
    out.update(syncs_per_generation=syncs, sync_sites=sites, instrument_sites=base_sites)
    check(syncs <= 1, f"{syncs} host syncs in one generation {sites} (the instrument alone: "
          f"{base_sites})")
    gen = torch.Generator(device="cuda").manual_seed(5)
    parts = []
    pop = run.pop
    for _ in range(3):
        pop, _, p = parts_of_a_generation(torch, evo, pop, gen)
        parts.append(p)
    out["parts"] = parts
    prof = profile_generation(torch, lambda: run.run(1))
    out["profile"] = prof
    log(f"  host syncs per generation: {syncs} {sites} (the instrument alone: {base_sites}); "
        f"parts (s) "
        f"{[{k: round(v, 4) for k, v in p.items()} for p in parts]}; one generation under "
        f"torch.profiler: {prof}")

    # a member's slice of the batched iteration against the member alone
    pop = run.pop
    draws = evo.draw_iteration(P, gen)
    batched, fit = evo.member_iteration(pop, draws)
    member = {}
    for p in (0, min(37, P - 1)):
        alone_draws = {"action": draws["action"][:, p:p + 1], "perm": draws["perm"][:, p:p + 1],
                       "reset": tree_map(lambda x, _p=p: x[:, _p:_p + 1], draws["reset"])}
        alone, fit1 = evo.member_iteration(slice_member(torch, pop, p), alone_draws)
        mine = slice_member(torch, batched, p)
        state_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(tree_leaves((alone.obs, alone.ep_ret, alone.env_state)),
                                        tree_leaves((mine.obs, mine.ep_ret, mine.env_state))))
        w_err, exempt = weights_rule(torch, (alone.actor, alone.critic),
                                     (mine.actor, mine.critic), alone.opt_state[0].mu)
        fit_err = float((fit1[0] - fit[p]).abs())
        member[p] = dict(fitness_err=fit_err, state_err=state_err, weight_err=w_err,
                         exempt_share=exempt)
        check(fit_err <= POP_MEMBER_ATOL * max(1.0, float(fit[p].abs())) and
              state_err <= POP_MEMBER_ATOL and w_err <= POP_MEMBER_ATOL and exempt < 0.15,
              f"member {p} alone vs its slice of the batched iteration: {member[p]}")
    out["member_vs_batched"] = member

    # one _ppo_update, card vs CPU, on the same 4 members, trajectory and rows
    evo_cpu = evo_ppo(torch, POP, device="cpu")
    sub = tree_map(lambda x: x[:4] if isinstance(x, torch.Tensor) else x, pop)
    sub_draws = {"action": draws["action"][:, :4], "perm": draws["perm"][:, :4],
                 "reset": tree_map(lambda x: x[:, :4], draws["reset"])}
    traj, _, _, obs, _, _ = evo._rollout(sub, sub_draws)
    adv, ret = evo._gae(traj, evo._value_v(sub.critic, obs))
    cpu = lambda t: tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, t)  # noqa
    args = (sub.actor, sub.critic, sub.opt_state, traj, adv, ret, sub_draws["perm"])
    ca, cc, copt, closs = evo._ppo_update(*args)
    ha, hc, hopt, hloss = evo_cpu._ppo_update(*cpu(args))
    loss_err = float((closs.cpu() - hloss).abs().max() / hloss.abs().max())
    mu_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
                 for a, b in zip(tree_leaves(copt[0].mu), tree_leaves(hopt[0].mu)))
    w_err, exempt = weights_rule(torch, (ca, cc), (ha, hc), hopt[0].mu)
    out["card_vs_cpu"] = dict(loss_rel_err=loss_err, mu_rel_err=mu_err, weight_err=w_err,
                              exempt_share=exempt)
    log(f"  member alone vs batched {member}; card vs CPU update {out['card_vs_cpu']}")
    check(loss_err <= POP_MOMENT_RTOL and mu_err <= POP_MOMENT_RTOL and
          w_err <= POP_WEIGHT_ATOL and exempt < 0.15, f"update card vs CPU: {out['card_vs_cpu']}")

    # the learning gate, three seeds in three processes side by side
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--population-gate", str(s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for s in POP_GATE_SEEDS]
    gates = {}
    try:
        for s, proc in zip(POP_GATE_SEEDS, procs):
            stdout, stderr = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"gate seed {s} exited {proc.returncode}: {stderr[-2000:]}")
            res = json.loads(stdout.strip().splitlines()[-1])
            gates[s] = dict(gate_verdict(res["best"]), s=res["s"],
                            best_every_10=res["best"][::10])
            log(f"  learning gate seed {s}: {gates[s]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out.update(gates=gates, gates_s=time.perf_counter() - t0)
    passed = sum(g["passed"] for g in gates.values())
    check(passed >= 2, f"the learning gate passed on {passed} of seeds {POP_GATE_SEEDS}")
    report["population"] = out
    return launches


# ------------------------------- phase 4j ---------------------------------- #
# configs/training/ppo/ppo_image.yaml (CNN on VisualCartPole-v0) and
# configs/training/ppo/ppo_recurrent.yaml (LSTM; its RECURRENT: true is
# passed as PPO's recurrent=True) at their widths, each through
# train_on_policy. Cuts, for time: EVO_STEPS 10,000 -> 1,024 and MAX_STEPS
# 200,000 -> 2,048 (2 generations of one collect + learn pair per agent;
# 2,048 / 4,096, two pairs, until phases 4n and 4o came).
PPO_5B_COMMON = {"POP_SIZE": 4, "BATCH_SIZE": 128, "GAMMA": 0.99, "GAE_LAMBDA": 0.95,
                 "LEARN_STEP": 128, "VF_COEF": 0.5, "MAX_GRAD_NORM": 0.5, "UPDATE_EPOCHS": 4,
                 "NUM_ENVS": 8, "ENT_COEF": 0.01}
PPO_5B = {
    "image": dict(env="VisualCartPole-v0", hp={**PPO_5B_COMMON, "LR": 0.00025, "CLIP_COEF": 0.1},
                  net={"latent_dim": 128, "encoder_config": {
                      "channel_size": (16, 32), "kernel_size": (4, 3), "stride_size": (2, 2)}},
                  kind="cnn", recurrent=False),
    "recurrent": dict(env="CartPole-v1", hp={**PPO_5B_COMMON, "LR": 0.0003, "CLIP_COEF": 0.2},
                      net={"latent_dim": 64, "recurrent": True,
                           "encoder_config": {"hidden_size": 64}},
                      kind="lstm", recurrent=True),
}
PPO_5B_MUTATION = dict(no_mutation=0.4, architecture=0.2, parameters=0.2, activation=0.0,
                       rl_hp=0.2, mutation_sd=0.1)
PPO_5B_EVO_STEPS = 1_024  # cut from 10,000
PPO_5B_MAX_STEPS = 2_048  # cut from 200,000
# tests/test_algorithms/test_recurrent_memory.py:15-43
MEMORY_GATE = dict(num_envs=8, learn_step=24, seq_len=3, batch_size=96, update_epochs=4,
                   lr=5e-3, gamma=0.9, ent_coef=0.02, recurrent=True, seed=1,
                   net_config={"latent_dim": 16,
                               "encoder_config": {"hidden_size": 32, "num_layers": 1}})
MEMORY_ITERS = 60
ENCODER_ATOL = 1e-5  # f32 with TF32 off: summation order


def encoders_card_vs_cpu(torch, out):
    """Each new encoder's apply on the card against the CPU, on the same
    (carried) weights and inputs."""
    import numpy as np

    from agilerl_tpu_torch.modules.cnn import EvolvableCNN
    from agilerl_tpu_torch.modules.lstm import EvolvableLSTM
    from agilerl_tpu_torch.modules.multi_input import EvolvableMultiInput
    from agilerl_tpu_torch.modules.resnet import EvolvableResNet
    from agilerl_tpu_torch.modules.simba import EvolvableSimBa
    from agilerl_tpu_torch.utils.spaces import Box, Dict, Discrete
    from agilerl_tpu_torch.utils.tree import tree_map

    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (32, 24, 24, 1)).astype(np.float32)
    vec = rng.normal(size=(32, 6)).astype(np.float32)
    space = Dict({"img": Box(0.0, 1.0, (24, 24, 1)), "vec": Box(-1.0, 1.0, (6,)),
                  "d": Discrete(3)})
    cases = {
        "cnn": (lambda d: EvolvableCNN(input_shape=(24, 24, 1), num_outputs=128,
                                       channel_size=(16, 32), kernel_size=(4, 3),
                                       stride_size=(2, 2), device=d), img),
        "resnet": (lambda d: EvolvableResNet(input_shape=(24, 24, 1), num_outputs=64,
                                             device=d), img),
        "simba": (lambda d: EvolvableSimBa(num_inputs=6, num_outputs=64, device=d), vec),
        "lstm": (lambda d: EvolvableLSTM(num_inputs=6, num_outputs=64, num_layers=2, device=d),
                 rng.normal(size=(16, 32, 6)).astype(np.float32)),
        "multi_input": (lambda d: EvolvableMultiInput(space, num_outputs=64, device=d),
                        {"img": img, "vec": vec,
                         "d": np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]}),
    }
    errs = {}
    for name, (make, x) in cases.items():
        m_cpu = make("cpu")
        m_card = make("cuda")
        m_card.params = tree_map(lambda t: t.cuda(), m_cpu.params)
        xs = tree_map(lambda a: torch.from_numpy(a), x)
        got = type(m_card).apply(m_card.config, m_card.params, tree_map(lambda t: t.cuda(), xs))
        want = type(m_cpu).apply(m_cpu.config, m_cpu.params, xs)
        errs[name] = float((got.cpu() - want).abs().max())
        check(bool(torch.isfinite(got).all()) and errs[name] <= ENCODER_ATOL,
              f"{name} encoder on the card vs CPU: {errs[name]}")
    out["encoders_card_vs_cpu"] = errs
    log(f"  encoders, card vs CPU (max abs err): {errs}")


def run_encoders_and_recurrent(torch, ops, report):
    """Phase 4j: Queue 1's slice 5b on the card: train_on_policy on the image
    (CNN) and recurrent (LSTM) configs for 2 generations each, the
    recurrent memory gate on MemoryEnv, and each new encoder's apply card
    vs CPU."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.ppo import PPO
    from agilerl_tpu_torch.envs.core import TorchVecEnv
    from agilerl_tpu_torch.envs.probe import MemoryEnv
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts
    from agilerl_tpu_torch.training.train_on_policy import train_on_policy
    from agilerl_tpu_torch.utils.utils import create_population, make_vect_envs

    out = {}
    launches = {k: 0 for k in ops.kernel_counters()}
    for name, c in PPO_5B.items():
        log(f"phase 4j: train_on_policy, {name} config ({c['kind']}) on {c['env']}: "
            f"{c['hp']['NUM_ENVS']} envs, population {c['hp']['POP_SIZE']}, evo_steps "
            f"{PPO_5B_EVO_STEPS}, max_steps {PPO_5B_MAX_STEPS} (cut from 10,000 / 200,000)")
        np.random.seed(0)
        env = make_vect_envs(c["env"], c["hp"]["NUM_ENVS"])
        pop = create_population("PPO", env.single_observation_space, env.single_action_space,
                                c["net"], c["hp"], num_envs=c["hp"]["NUM_ENVS"], seed=0,
                                recurrent=c["recurrent"])
        check(all(a.actor.config.encoder_kind == c["kind"] and a.recurrent == c["recurrent"]
                  and a.dev.type == "cuda" for a in pop), f"{name}: population {pop[0].actor.config}")
        sink = MemorySink()
        telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
        ops.reset_kernel_counters()
        (pop, fitnesses), t_loop = host_s(torch, lambda: train_on_policy(
            env, c["env"], "PPO", pop, INIT_HP=c["hp"], max_steps=PPO_5B_MAX_STEPS,
            evo_steps=PPO_5B_EVO_STEPS,
            tournament=TournamentSelection(2, True, c["hp"]["POP_SIZE"], 1,
                                           rng=np.random.default_rng(0)),
            mutation=Mutations(**PPO_5B_MUTATION, rand_seed=0), telemetry=telem, verbose=False))
        for k, v in ops.kernel_counters().items():
            launches[k] += v
        gens = [e for e in sink.events if e["kind"] == "generation"]
        env_steps = gens[-1]["total_steps"]
        check(PPO_5B_MAX_STEPS // PPO_5B_EVO_STEPS <= len(gens) <= 6
              and all(np.isfinite(f).all() for f in fitnesses),
              f"{name}: {len(gens)} generations, fitnesses {fitnesses}")
        out[name] = dict(loop_s=t_loop, env_steps=env_steps, env_steps_per_s=env_steps / t_loop,
                         generations=[{k: g[k] for k in ("generation", "collect_s", "learn_s",
                                                         "learn_calls", "eval_s", "evo_s",
                                                         "fitness", "mutations")}
                                      for g in gens])
        log(f"  {name}: {env_steps} env steps in {t_loop:.1f} s ({env_steps / t_loop:.0f} "
            f"env-steps/s); per generation collect / learn / eval s "
            f"{[(round(g['collect_s'], 2), round(g['learn_s'], 2), round(g['eval_s'], 2)) for g in gens]}; "
            f"fitness {[[round(x, 1) for x in g['fitness']] for g in gens]}; mutations "
            f"{[g['mutations'] for g in gens]}")

    log(f"phase 4j: recurrent memory gate on MemoryEnv, {MEMORY_GATE['num_envs']} envs, "
        f"{MEMORY_ITERS} iterations")
    probe = MemoryEnv()
    vec = TorchVecEnv(probe, num_envs=MEMORY_GATE["num_envs"], seed=0)
    agent = PPO(probe.observation_space, probe.action_space, **MEMORY_GATE)
    t0 = time.perf_counter()
    rewards = []
    for _ in range(MEMORY_ITERS):
        rewards.append(collect_rollouts(agent, vec, n_steps=agent.learn_step))
        agent.learn()
    late = float(np.mean(rewards[-10:]))
    greedy = agent.test(vec, loop=1)
    out["memory_gate"] = dict(late_mean_reward=late, s=time.perf_counter() - t0,
                              greedy_return=greedy, rewards_every_10=rewards[::10])
    log(f"  memory gate: late mean reward {late:.3f} (> 0.15), greedy return per episode "
        f"{greedy:.2f}, {out['memory_gate']['s']:.1f} s")
    check(late > 0.15, f"recurrent PPO failed the memory gate: {late:.3f}")

    encoders_card_vs_cpu(torch, out)
    report["encoders_recurrent"] = out
    return launches


# ------------------------------- phase 4k ---------------------------------- #
# configs/training/dqn/dqn_rainbow.yaml (the card's machine has no PyYAML),
# wired as benchmarking/benchmarking_rainbow.py:24-40 wires it: CartPole-v1
# as a TorchVecEnv of 16 envs, population 4, batch 64, lr 1e-3, gamma 0.99,
# learn_step 4, tau 0.01, a PER buffer (alpha 0.6) and a paired 3-step buffer
# of 20,000 rows each, 51 atoms on [0, 200], noisy nets, latent 32, hidden
# [64]. Cuts, for time: evo_steps 10,000 -> 768 and max_steps 200,000 ->
# 1,536 (2 generations of 48 vector steps per agent: the 4 agents' 6,144
# env steps fill 31 % of the rings; 1,536 / 3,072 until phase 4t came;
# 2,560 / 5,120, whose 20,480 steps wrapped them, until phase 4s came;
# 3,200 / 6,400 until phases 4n and 4o came). evo_steps is cut, not
# max_steps alone, to keep a second generation: only there do the
# tournament's clones and mutated agents
# learn from the buffer. At 10,000 / 20,000 the phase took 174.5 s, at
# 4,000 / 8,000 92.8-110.4 s (its Rainbow loop 48.8-71.0 s) and at 3,200 /
# 6,400 57.2-71.1 s on an H100 80GB HBM3 at 700 W.
# configs/training/dqn/dqn.yaml's 1-generation loop (double DQN, a uniform
# buffer of 20,000 rows) was cut when phases 4l and 4m came: its learn stays
# held card vs CPU, and phase 4m runs the per-agent DQN loop.
OFF_ENV = "CartPole-v1"
RAINBOW_HP = {"POP_SIZE": 4, "BATCH_SIZE": 64, "LR": 1e-3, "GAMMA": 0.99, "LEARN_STEP": 4,
              "TAU": 0.01, "NUM_ATOMS": 51, "V_MIN": 0.0, "V_MAX": 200.0, "N_STEP": 3,
              "PER": True, "NUM_ENVS": 16}
OFF_NET = {"latent_dim": 32, "encoder_config": {"hidden_size": (64,)}}
OFF_MUTATION = dict(no_mutation=0.4, architecture=0.2, parameters=0.2, activation=0.0,
                    rl_hp=0.2, mutation_sd=0.1)
OFF_MEMORY = 20_000
OFF_ALPHA = 0.6
OFF_EVO_STEPS = 768  # cut from 10,000
OFF_LOOPS = (("rainbow", "RainbowDQN", RAINBOW_HP, 1_536),)  # cut from 200,000
OFF_SYNC_STEPS = 1_024  # the short run whose host syncs are counted (64 vector steps)
# tests/test_algorithms/test_probe_grid.py:55-67 (DQN) and
# test_learning_correctness.py:17-27 (Rainbow on ConstantReward)
DQN_PROBE = dict(lr=2e-3, gamma=0.9, tau=0.5, double=False, seed=0,
                 net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}})
RAINBOW_PROBE = dict(num_atoms=21, v_min=0.0, v_max=2.0, lr=2e-3, tau=0.5, gamma=0.9, seed=0,
                     net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}})
# card against CPU, f32 with TF32 off: one learn's loss rtol 1e-5, each
# weight within 1e-5 of its leaf's largest entry where |g| >= 1e-6 or g == 0
# (below, Adam's first step turns summation order into steps of up to lr);
# Rainbow at noise_std 0, its noise scales (kernel_sigma, bias_sigma) left
# out: their gradient is the noise, drawn from each device's own generator;
# the PER sample on the same draws: the same indices, weights atol 1e-6
OFF_RTOL = 1e-5
PER_WEIGHT_ATOL = 1e-6


def off_policy_card_vs_cpu(torch, memory, out):
    """One DQN (double), CQN and Rainbow learn (noise_std 0, a PER tuple with
    the paired n-step batch) on the card against the CPU on the same batch
    and weights, and the PER sample of the Rainbow run's buffer on the same
    draws."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy
    from agilerl_tpu_torch.algorithms.cqn import CQN
    from agilerl_tpu_torch.algorithms.dqn import DQN
    from agilerl_tpu_torch.algorithms.dqn_rainbow import RainbowDQN
    from agilerl_tpu_torch.components.replay_buffer import PrioritizedReplayBuffer, _per_sample
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.utils.tree import tree_to_numpy

    env = CartPole()
    rng = np.random.default_rng(6)
    scale = np.array([2.4, 3, 0.2, 3], np.float32)

    def batch(n=64):
        return {"obs": rng.uniform(-1, 1, (n, 4)).astype(np.float32) * scale,
                "action": rng.integers(0, 2, n),
                "reward": rng.uniform(0, 1, n).astype(np.float32),
                "next_obs": rng.uniform(-1, 1, (n, 4)).astype(np.float32) * scale,
                "done": (rng.random(n) < 0.1).astype(np.float32)}

    res = {}
    for name, cls, kw in (("dqn", DQN, dict(double=True)), ("cqn", CQN, {}),
                          ("rainbow", RainbowDQN, dict(num_atoms=51, v_min=0.0, v_max=200.0,
                                                       noise_std=0.0))):
        agents = {dev: cls(env.observation_space, env.action_space, net_config=OFF_NET,
                           lr=1e-3, gamma=0.99, tau=0.01, seed=1, device=dev, **kw)
                  for dev in ("cuda", "cpu")}
        load_params_from_numpy(agents["cuda"], {n: tree_to_numpy(getattr(agents["cpu"], n).params)
                                                for n in ("actor", "actor_target")})
        exp = batch()
        if name == "rainbow":
            exp = (exp, np.arange(64), rng.uniform(0.3, 1.0, 64).astype(np.float32), batch())
        losses = {dev: a.learn(exp) for dev, a in agents.items()}
        if name == "rainbow":
            pri_err = float(np.abs(losses["cuda"][1] - losses["cpu"][1]).max()
                            / np.abs(losses["cpu"][1]).max())
            losses = {dev: v[0] for dev, v in losses.items()}
        loss_err = abs(losses["cuda"] - losses["cpu"]) / max(abs(losses["cpu"]), 1e-12)
        mu = agents["cpu"].optimizer.opt_state.inner_state[0].mu
        worst, exempt, total = 0.0, 0, 0
        for net in ("actor", "actor_target"):
            got = flat_params(getattr(agents["cuda"], net).params)
            for p, w in flat_params(getattr(agents["cpu"], net).params).items():
                if p.endswith(("/kernel_sigma", "/bias_sigma")):
                    continue
                g = flat_params(mu)[p].abs() / 0.1
                ok = (g >= 1e-6) | (g == 0)
                exempt += int((~ok).sum())
                total += ok.numel()
                if ok.any():
                    d = (got[p].cpu() - w).abs()[ok].max() / (w.abs().max() + 1e-12)
                    worst = max(worst, float(d))
        res[name] = dict(loss=losses, loss_rel_err=loss_err, weight_rel_err=worst,
                         weights_held_by_gradient=exempt, weights=total)
        if name == "rainbow":
            res[name]["priority_rel_err"] = pri_err
            check(pri_err <= OFF_RTOL, f"rainbow priorities on the card vs CPU: {pri_err}")
        check(loss_err <= OFF_RTOL, f"{name} learn loss on the card vs CPU: {losses}")
        check(worst <= OFF_RTOL, f"{name} weights after learn on the card vs CPU: {worst}")
        check(exempt < 0.1 * total, f"{name}: {exempt} of {total} weights held by gradient")

    cpu_mem = PrioritizedReplayBuffer(memory.max_size, alpha=memory.alpha, device="cpu")
    cpu_mem.load_state_dict(memory.state_dict())
    u = torch.rand(256, generator=torch.Generator().manual_seed(3))
    _, idx_c, w_c = _per_sample(memory.per_state, u.cuda(), 0.4)
    _, idx, w = _per_sample(cpu_mem.per_state, u, 0.4)
    same = bool(torch.equal(idx_c.cpu(), idx))
    w_err = float((w_c.cpu() - w).abs().max())
    res["per_sample"] = dict(rows=len(memory), same_indices=same, weight_max_abs_err=w_err)
    check(same and w_err <= PER_WEIGHT_ATOL,
          f"PER sample on the card vs CPU: indices equal {same}, weights {w_err}")
    out["card_vs_cpu"] = res
    log(f"  card vs CPU: {res}")


def run_off_policy(torch, ops, report):
    """Phase 4k: Queue 1's slice 5c-i on the card: train_off_policy on the
    Rainbow config (2 generations), the host syncs of one learn_from_buffer
    (0) and per env step (<= 1), ms and
    launches per learn_from_buffer, the Q-learning probes, a checkpoint round
    trip, and one learn of each algorithm and the PER sample card vs CPU."""
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.algorithms.dqn import DQN
    from agilerl_tpu_torch.algorithms.dqn_rainbow import RainbowDQN
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.components.replay_buffer import (
        MultiStepReplayBuffer,
        PrioritizedReplayBuffer,
        ReplayBuffer,
    )
    from agilerl_tpu_torch.envs.probe import (
        ConstantRewardEnv,
        DiscountedRewardEnv,
        ObsDependentRewardEnv,
        PolicyEnv,
        check_q_learning_with_probe_env,
    )
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.training.train_off_policy import train_off_policy
    from agilerl_tpu_torch.utils.utils import create_population, make_vect_envs

    out = {}
    launches = {k: 0 for k in ops.kernel_counters()}
    np.random.seed(0)
    env = make_vect_envs(OFF_ENV, 16)
    check(env.device.type == "cuda", f"make_vect_envs put the env on {env.device}")
    for name, algo, hp, max_steps in OFF_LOOPS:
        per = hp.get("PER", False)
        log(f"phase 4k: train_off_policy, {algo} on {OFF_ENV}: {hp['NUM_ENVS']} envs, population "
            f"{hp['POP_SIZE']}, {'PER + 3-step' if per else 'uniform'} buffer of {OFF_MEMORY} "
            f"rows, evo_steps {OFF_EVO_STEPS}, max_steps {max_steps} (cut from 10,000 / 200,000)")
        pop = create_population(algo, env.single_observation_space, env.single_action_space,
                                OFF_NET, hp, seed=0)
        check(all(a.dev.type == "cuda" for a in pop), "create_population left the card")
        memory = (PrioritizedReplayBuffer(OFF_MEMORY, alpha=OFF_ALPHA) if per
                  else ReplayBuffer(OFF_MEMORY))
        n_mem = MultiStepReplayBuffer(OFF_MEMORY, n_step=3, gamma=hp["GAMMA"]) if per else None
        sink = MemorySink()
        telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
        ops.reset_kernel_counters()
        torch.cuda.reset_peak_memory_stats()
        (pop, fitnesses), t_loop = host_s(torch, lambda: train_off_policy(
            env, OFF_ENV, algo, pop, memory, INIT_HP=hp, max_steps=max_steps,
            evo_steps=OFF_EVO_STEPS, n_step=per, per=per, n_step_memory=n_mem,
            tournament=TournamentSelection(2, True, hp["POP_SIZE"], 1,
                                           rng=np.random.default_rng(0)),
            mutation=Mutations(**OFF_MUTATION, rand_seed=0), telemetry=telem, verbose=False,
            seed=0))
        for k, v in ops.kernel_counters().items():
            launches[k] += v
        gens = [e for e in sink.events if e["kind"] == "generation"]
        env_steps = gens[-1]["total_steps"]
        # each agent adds evo_steps // num_envs vector steps per generation
        per_gen = OFF_EVO_STEPS // hp["NUM_ENVS"] * hp["NUM_ENVS"]
        check(len(gens) == -(-max_steps // per_gen)
              and all(np.isfinite(f).all() and len(f) == len(gens) for f in fitnesses)
              and all(np.isfinite(g["last_losses"]).all() for g in gens),
              f"{name}: {len(gens)} generations, fitnesses {fitnesses}")
        # every env step writes a row; each agent's run leaves its last
        # n_step - 1 vector steps unfolded
        rows = env_steps - (hp["POP_SIZE"] * len(gens) * 2 * 16 if per else 0)
        check(len(memory) == min(OFF_MEMORY, rows) and (n_mem is None or len(n_mem) == len(memory)),
              f"{name}: buffers hold {len(memory)} / {n_mem and len(n_mem)} rows, not {rows}")
        keys = ("generation", "act_s", "learn_s", "sync_s", "eval_s", "evo_s", "learn_calls",
                "fitness", "mutations", "last_losses")
        # learn_step 4 < 16 envs: every vector step learns once the buffer
        # holds a batch, so the vector steps without a learn are the warm-up
        vec_steps = hp["POP_SIZE"] * (OFF_EVO_STEPS // hp["NUM_ENVS"])
        for g in gens:
            g["warmup_share"] = 1.0 - g["learn_calls"] / vec_steps
        out[name] = dict(loop_s=t_loop, env_steps=env_steps, env_steps_per_s=env_steps / t_loop,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         generations=[{k: g[k] for k in keys + ("warmup_share",)}
                                      for g in gens])
        for g in gens:
            log(f"  {name} generation {g['generation']}: act + env step {g['act_s']:.2f} s, "
                f"learn {g['learn_s']:.2f} s ({g['learn_calls']} calls of {vec_steps} vector "
                f"steps, warm-up share {g['warmup_share']:.4f}), device wait "
                f"{g['sync_s']:.3f} s, eval {g['eval_s']:.2f} s, tournament + mutation "
                f"{g['evo_s']:.3f} s; fitness {[round(f, 1) for f in g['fitness']]}; mutations "
                f"{g['mutations']}")
        log(f"  {name}: {env_steps} env steps in {t_loop:.1f} s ({env_steps / t_loop:.0f} "
            f"env-steps/s); peak {out[name]['peak_gb']:.3f} GB")
        if per:
            rainbow_pop, rainbow_mem, rainbow_nmem = pop, memory, n_mem
    out["launches"] = launches

    # one learn_from_buffer on the Rainbow run's buffers: host syncs, ms, launches
    agent = rainbow_pop[0]
    learn = lambda: agent.learn_from_buffer(rainbow_mem, rainbow_nmem)  # noqa: E731
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    # the fused learn holds a budget of no host sync at all (the guard raises
    # past it)
    with SyncGuard(device="cuda", max_syncs=0, label="4k fused learn_from_buffer") as g:
        learn()
    sites, learn_syncs = g.sites, g.syncs
    for _ in range(5):
        learn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        learn()
    torch.cuda.synchronize()
    ms_learn = 1e3 * (time.perf_counter() - t0) / 50
    prof = profile_generation(torch, learn)
    out.update(learn_from_buffer_syncs=learn_syncs, learn_sync_sites=sites,
               ms_per_learn_from_buffer=ms_learn, learn_from_buffer_profile=prof)
    log(f"  learn_from_buffer (Rainbow, PER + 3-step, batch 64): {learn_syncs} host syncs "
        f"{sites}, {ms_learn:.2f} ms per call (50 calls), under torch.profiler {prof}")

    # host syncs per env step: the same loop, one agent, OFF_SYNC_STEPS env
    # steps, everything counted (the agent's last-loss and return reads,
    # and a one-step evaluation, included)
    probe_agent = agent.clone(index=50)
    probe_agent.steps = [0]
    with SyncGuard(device="cuda", label="4k loop") as g:
        train_off_policy(
            env, OFF_ENV, "RainbowDQN", [probe_agent], rainbow_mem, max_steps=OFF_SYNC_STEPS,
            evo_steps=OFF_SYNC_STEPS, eval_steps=1, n_step=True, per=True,
            n_step_memory=rainbow_nmem, verbose=False)
    sites = g.sites
    step_syncs = sum(n for site, n in sites.items() if site not in base_sites)
    vec_steps = OFF_SYNC_STEPS // 16
    out.update(loop_syncs=step_syncs, loop_sync_sites=sites,
               syncs_per_env_step=step_syncs / vec_steps)
    log(f"  host syncs in {vec_steps} vector steps of the loop (evaluation included): "
        f"{step_syncs} {sites}")
    check(step_syncs <= vec_steps, f"{step_syncs} host syncs in {vec_steps} env steps")

    probes = {}
    for env_cls in (ConstantRewardEnv, ObsDependentRewardEnv, DiscountedRewardEnv, PolicyEnv):
        probe = env_cls()
        t0 = time.perf_counter()
        check_q_learning_with_probe_env(
            probe, DQN, dict(DQN_PROBE, observation_space=probe.observation_space,
                             action_space=probe.action_space), learn_steps=400)
        probes[f"DQN/{env_cls.__name__}"] = time.perf_counter() - t0
    probe = ConstantRewardEnv()
    t0 = time.perf_counter()
    check_q_learning_with_probe_env(
        probe, RainbowDQN, dict(RAINBOW_PROBE, observation_space=probe.observation_space,
                                action_space=probe.action_space), learn_steps=300, atol=0.2)
    probes["RainbowDQN/ConstantRewardEnv"] = time.perf_counter() - t0
    out["probes_s"] = probes
    log(f"  Q-learning probes passed: {probes}")

    # a checkpoint round trip on the card: save, load, the same greedy actions
    obs = torch.rand(256, 4, device="cuda", generator=torch.Generator(device="cuda").manual_seed(
        2)) * 2 - 1
    # (a file written on the CPU loads onto the card too: device=None is the card)
    with tempfile.TemporaryDirectory() as work:
        path, cpu_path = Path(work) / "rainbow.ckpt", Path(work) / "rainbow_cpu.ckpt"
        agent.save_checkpoint(path)
        loaded = RainbowDQN.load(path)
        RainbowDQN.load(path, device="cpu").save_checkpoint(cpu_path)
        from_cpu = RainbowDQN.load(cpu_path)
    want = agent.get_action(obs, training=False)
    same = bool(torch.equal(loaded.get_action(obs, training=False), want))
    same_cpu = bool(torch.equal(from_cpu.get_action(obs, training=False), want))
    check(loaded.dev.type == "cuda" and same, f"checkpoint round trip: same actions {same}")
    check(from_cpu.dev.type == "cuda" and same_cpu,
          f"CPU-saved checkpoint loads onto the card ({from_cpu.dev}): same actions {same_cpu}")
    out["checkpoint_round_trip"] = dict(same_greedy_actions=same,
                                        cpu_saved_on_card_same_greedy_actions=same_cpu)

    off_policy_card_vs_cpu(torch, rainbow_mem, out)
    report["off_policy"] = out
    return launches


# ------------------------------- phase 4l ---------------------------------- #
# configs/training/ddpg/ddpg.yaml and configs/training/td3.yaml (the card's
# machine has no PyYAML): Pendulum-v1 as a TorchVecEnv of 16 envs,
# population 4, batch 128, lr 1e-4 / 1e-3, gamma 0.99, learn_step 2, tau
# 0.005, policy_freq 2, OU noise for DDPG (theta 0.15, dt 0.01) and Gaussian
# for TD3 (expl_noise 0.1), a uniform buffer of 100,000 rows, latent 64,
# hidden [64]. Cuts, for time: evo_steps 10,000 -> 256 and max_steps
# 200,000 -> 512 (2 generations: the tournament's clones and mutated agents
# learn from the buffer in the second; 400 / 800 until phase 4s came, 800 /
# 1,600 until phases 4q, 4p and 4r came). Then DDPG on a
# PrioritizedReplayBuffer (alpha 0.6) through the loop's sampled path for 1
# generation (max_steps -> 256), and
# configs/training/cqn.yaml through train_offline: batch 64, lr 1e-3,
# learn_step 1, tau 0.01, double, a buffer of 20,000 rows filled once
# from a 20,000-row dataset that collect_offline_dataset makes on the device
# CartPole-v1 (16 envs, random actions: the config's DATASET file is not in
# the repository), latent 32, hidden [64]; evo_steps cut 5,000 -> 100 and
# max_steps 50,000 -> 200 (2 generations; at 250 / 500 the loop took 15.2 s
# and at 150 / 300 6.8-10.3 s on an H100 80GB HBM3 at 700 W, every learn
# reading its loss).
CONT_ENV = "Pendulum-v1"
DDPG_HP = {"POP_SIZE": 4, "BATCH_SIZE": 128, "LR_ACTOR": 1e-4, "LR_CRITIC": 1e-3,
           "GAMMA": 0.99, "LEARN_STEP": 2, "TAU": 0.005, "POLICY_FREQ": 2, "O_U_NOISE": True,
           "EXPL_NOISE": 0.1, "THETA": 0.15, "DT": 0.01, "NUM_ENVS": 16}
TD3_HP = dict(DDPG_HP, O_U_NOISE=False)
CONT_NET = {"latent_dim": 64, "encoder_config": {"hidden_size": (64,)}}
CONT_MEMORY = 100_000
CONT_EVO_STEPS = 256  # cut from 10,000 (400 until phase 4s came)
CONT_LOOPS = (("ddpg", "DDPG", DDPG_HP, False, 512),  # max_steps cut from 200,000
              ("td3", "TD3", TD3_HP, False, 512),
              ("ddpg_per", "DDPG", DDPG_HP, True, 256))
CONT_SYNC_STEPS = 512  # the short run whose host syncs are counted (32 vector steps)
# tests/test_algorithms/test_ddpg_probe.py's settings, for DDPG and TD3
CONT_PROBE = dict(lr_actor=3e-3, lr_critic=5e-3, gamma=0.9, tau=0.3, policy_freq=1,
                  O_U_noise=False, seed=2,
                  net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}})
CQN_HP = {"POP_SIZE": 4, "BATCH_SIZE": 64, "LR": 1e-3, "GAMMA": 0.99, "LEARN_STEP": 1,
          "TAU": 0.01, "DOUBLE": True}
CQN_NET = {"latent_dim": 32, "encoder_config": {"hidden_size": (64,)}}
CQN_MEMORY = 20_000
CQN_ROWS = 20_000
CQN_EVO_STEPS = 100  # cut from 5,000
CQN_MAX_STEPS = 200  # cut from 50,000


def continuous_card_vs_cpu(torch, out):
    """One DDPG learn (critic and actor steps) and one TD3 learn (its
    smoothing normals given) on the card against the CPU, on the same batch
    and weights: the loss and every weight by phase 4k's rule."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.core import fused as F
    from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy
    from agilerl_tpu_torch.algorithms.ddpg import DDPG
    from agilerl_tpu_torch.algorithms.td3 import TD3
    from agilerl_tpu_torch.envs.classic import Pendulum
    from agilerl_tpu_torch.utils.tree import tree_map, tree_to_numpy

    env = Pendulum()
    rng = np.random.default_rng(7)
    batch = {"obs": rng.uniform(-1, 1, (128, 3)).astype(np.float32) * [1, 1, 8],
             "action": rng.uniform(-2, 2, (128, 1)).astype(np.float32),
             "reward": rng.uniform(-16, 0, 128).astype(np.float32),
             "next_obs": rng.uniform(-1, 1, (128, 3)).astype(np.float32) * [1, 1, 8],
             "done": np.zeros(128, np.float32)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    normal = torch.randn(128, 1, generator=torch.Generator().manual_seed(4))
    res = {}
    for name, cls in (("ddpg", DDPG), ("td3", TD3)):
        agents = {dev: cls(env.observation_space, env.action_space, net_config=CONT_NET,
                           lr_actor=1e-3, lr_critic=1e-3, gamma=0.99, tau=0.005,
                           policy_freq=1, seed=1, device=dev) for dev in ("cuda", "cpu")}
        names = agents["cpu"].registry.all_network_names()
        load_params_from_numpy(agents["cuda"], {n: tree_to_numpy(getattr(agents["cpu"], n).params)
                                                for n in names})
        losses = {}
        for dev, a in agents.items():
            if name == "ddpg":
                losses[dev] = a.learn(batch)
            else:
                pre = F.preprocess_batch(batch, a.observation_space, a.dev)
                losses[dev] = float(a._twin_update(pre, None, normal.to(a.dev), True))
                a._actor_update(pre)
        loss_err = abs(losses["cuda"] - losses["cpu"]) / max(abs(losses["cpu"]), 1e-12)
        worst, exempt = 0.0, 0.0
        for cfg in agents["cpu"].registry.optimizer_configs:
            # the first step's gradient (Adam's first moment / (1 - b1))
            grad = tree_map(lambda m: m / 0.1,
                            getattr(agents["cpu"], cfg.name).opt_state.inner_state[0].mu)
            for net in cfg.networks:
                w, e = weights_rule(torch, getattr(agents["cuda"], net).params,
                                    getattr(agents["cpu"], net).params, grad)
                worst, exempt = max(worst, w), max(exempt, e)
        res[name] = dict(loss=losses, loss_rel_err=loss_err, weight_max_abs_err=worst,
                         exempt_share=exempt)
        check(loss_err <= OFF_RTOL, f"{name} learn loss on the card vs CPU: {losses}")
        check(worst <= OFF_RTOL, f"{name} weights after learn on the card vs CPU: {worst}")
        check(exempt < 0.1, f"{name}: {exempt:.3f} of the weights held by gradient")
    out["card_vs_cpu"] = res
    log(f"  card vs CPU: {res}")


def run_off_policy_continuous(torch, ops, report):
    """Phase 4l: Queue 1's slice 5c-ii on the card: train_off_policy with
    DDPG and TD3 on their configs (2 generations each) and DDPG on PER
    through the sampled path (1 generation), the host syncs of one DDPG
    learn_from_buffer (0) and per env step (<= 1), ms and launches per
    learn_from_buffer, both policy probes, a DDPG checkpoint round trip, one
    DDPG and one TD3 learn card vs CPU; then cqn.yaml through train_offline
    on a dataset collected on the device. Returns the kernel launches of the
    continuous loops and of the offline loop."""
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.algorithms.cqn import CQN
    from agilerl_tpu_torch.algorithms.ddpg import DDPG
    from agilerl_tpu_torch.algorithms.td3 import TD3
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.components.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
    from agilerl_tpu_torch.envs.probe import (
        FixedObsPolicyEnv,
        check_policy_q_learning_with_probe_env,
    )
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.training.train_off_policy import train_off_policy
    from agilerl_tpu_torch.training.train_offline import train_offline
    from agilerl_tpu_torch.utils.minari_utils import collect_offline_dataset
    from agilerl_tpu_torch.utils.utils import create_population, make_vect_envs

    out = {}
    launches = {k: 0 for k in ops.kernel_counters()}
    np.random.seed(0)
    env = make_vect_envs(CONT_ENV, 16)
    check(env.device.type == "cuda", f"make_vect_envs put the env on {env.device}")
    keys = ("generation", "act_s", "learn_s", "sync_s", "eval_s", "evo_s", "learn_calls",
            "fitness", "mutations", "last_losses")
    for name, algo, hp, per, max_steps in CONT_LOOPS:
        log(f"phase 4l: train_off_policy, {algo} on {CONT_ENV}: 16 envs, population "
            f"{hp['POP_SIZE']}, {'PER (sampled path)' if per else 'uniform'} buffer of "
            f"{CONT_MEMORY} rows, evo_steps {CONT_EVO_STEPS}, max_steps {max_steps} (cut from "
            f"10,000 / 200,000)")
        pop = create_population(algo, env.single_observation_space, env.single_action_space,
                                CONT_NET, hp, seed=0)
        check(all(a.dev.type == "cuda" for a in pop), "create_population left the card")
        memory = (PrioritizedReplayBuffer(CONT_MEMORY, alpha=OFF_ALPHA) if per
                  else ReplayBuffer(CONT_MEMORY))
        sink = MemorySink()
        telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
        ops.reset_kernel_counters()
        torch.cuda.reset_peak_memory_stats()
        (pop, fitnesses), t_loop = host_s(torch, lambda: train_off_policy(
            env, CONT_ENV, algo, pop, memory, INIT_HP=hp, max_steps=max_steps,
            evo_steps=CONT_EVO_STEPS, per=per,
            tournament=TournamentSelection(2, True, hp["POP_SIZE"], 1,
                                           rng=np.random.default_rng(0)),
            mutation=Mutations(**OFF_MUTATION, rand_seed=0), telemetry=telem, verbose=False,
            seed=0))
        for k, v in ops.kernel_counters().items():
            launches[k] += v
        gens = [e for e in sink.events if e["kind"] == "generation"]
        env_steps = gens[-1]["total_steps"]
        check(len(gens) == max_steps // CONT_EVO_STEPS
              and all(np.isfinite(f).all() and len(f) == len(gens) for f in fitnesses)
              and all(np.isfinite(g["last_losses"]).all() and g["learn_calls"] > 0
                      for g in gens),
              f"{name}: {len(gens)} generations, fitnesses {fitnesses}")
        check(len(memory) == min(CONT_MEMORY, env_steps),
              f"{name}: the buffer holds {len(memory)} rows, not {env_steps}")
        if per:
            # DDPG's learn has no priority output: every row keeps the first max
            check(float(memory.per_state.max_priority) == 1.0,
                  f"{name}: max priority {float(memory.per_state.max_priority)}")
        out[name] = dict(loop_s=t_loop, env_steps=env_steps, env_steps_per_s=env_steps / t_loop,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         generations=[{k: g[k] for k in keys} for g in gens])
        for g in gens:
            log(f"  {name} generation {g['generation']}: act + env step {g['act_s']:.2f} s, "
                f"learn {g['learn_s']:.2f} s ({g['learn_calls']} calls), device wait "
                f"{g['sync_s']:.3f} s, eval {g['eval_s']:.2f} s, tournament + mutation "
                f"{g['evo_s']:.3f} s; fitness {[round(f, 1) for f in g['fitness']]}; mutations "
                f"{g['mutations']}")
        log(f"  {name}: {env_steps} env steps in {t_loop:.1f} s ({env_steps / t_loop:.0f} "
            f"env-steps/s); peak {out[name]['peak_gb']:.3f} GB")
        if name == "ddpg":
            ddpg_pop, ddpg_mem = pop, memory

    # one DDPG learn_from_buffer on the DDPG run's buffer: host syncs, ms, launches
    agent = ddpg_pop[0]
    learn = lambda: agent.learn_from_buffer(ddpg_mem)  # noqa: E731
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    with SyncGuard(device="cuda", label="4l learn_from_buffer") as g:
        learn()
    sites = g.sites
    learn_syncs = sum(n for site, n in sites.items() if site not in base_sites)
    check(learn_syncs == 0, f"{learn_syncs} host syncs in one learn_from_buffer {sites}")
    for _ in range(5):
        learn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        learn()
    torch.cuda.synchronize()
    ms_learn = 1e3 * (time.perf_counter() - t0) / 50
    prof = [profile_generation(torch, learn) for _ in range(2)]  # one with the actor step
    out.update(learn_from_buffer_syncs=learn_syncs, learn_sync_sites=sites,
               ms_per_learn_from_buffer=ms_learn, learn_from_buffer_profile=prof)
    log(f"  learn_from_buffer (DDPG, batch 128): {learn_syncs} host syncs {sites}, "
        f"{ms_learn:.2f} ms per call (50 calls), two calls under torch.profiler {prof}")

    # host syncs per env step: the same loop, one agent, CONT_SYNC_STEPS env steps
    probe_agent = agent.clone(index=50)
    probe_agent.steps = [0]
    with SyncGuard(device="cuda", label="4l loop") as g:
        train_off_policy(
            env, CONT_ENV, "DDPG", [probe_agent], ddpg_mem, max_steps=CONT_SYNC_STEPS,
            evo_steps=CONT_SYNC_STEPS, eval_steps=1, verbose=False)
    sites = g.sites
    step_syncs = sum(n for site, n in sites.items() if site not in base_sites)
    vec_steps = CONT_SYNC_STEPS // 16
    out.update(loop_syncs=step_syncs, loop_sync_sites=sites,
               syncs_per_env_step=step_syncs / vec_steps)
    log(f"  host syncs in {vec_steps} vector steps of the loop (evaluation included): "
        f"{step_syncs} {sites}")
    check(step_syncs <= vec_steps, f"{step_syncs} host syncs in {vec_steps} env steps")

    probes = {}
    for cls in (DDPG, TD3):
        probe = FixedObsPolicyEnv(continuous=True)
        t0 = time.perf_counter()
        check_policy_q_learning_with_probe_env(
            probe, cls, dict(CONT_PROBE, observation_space=probe.observation_space,
                             action_space=probe.action_space), learn_steps=400)
        probes[f"{cls.__name__}/FixedObsPolicyEnv(continuous)"] = time.perf_counter() - t0
    out["probes_s"] = probes
    log(f"  policy probes passed: {probes}")

    obs = torch.rand(256, 3, device="cuda", generator=torch.Generator(device="cuda").manual_seed(
        2)) * 2 - 1
    with tempfile.TemporaryDirectory() as work:
        path = Path(work) / "ddpg.ckpt"
        agent.save_checkpoint(path)
        loaded = DDPG.load(path)
    same = bool(torch.equal(loaded.get_action(obs, training=False),
                            agent.get_action(obs, training=False)))
    check(loaded.dev.type == "cuda" and same, f"DDPG checkpoint round trip: same actions {same}")
    out["checkpoint_round_trip"] = dict(same_greedy_actions=same)
    continuous_card_vs_cpu(torch, out)
    report["off_policy_continuous"] = out

    # cqn.yaml through train_offline, on a dataset collected on the device
    off = {}
    cart = make_vect_envs("CartPole-v1", 16)
    ds, collect_s = host_s(torch, lambda: collect_offline_dataset(cart, steps=CQN_ROWS, seed=0))
    rows = len(ds["observations"])
    check(rows == CQN_ROWS and all(len(v) == rows for v in ds.values())
          and 0 < ds["terminals"].sum() < rows and isinstance(ds["actions"], np.ndarray),
          f"dataset: {rows} rows, {ds['terminals'].sum()} terminals")
    log(f"phase 4l: train_offline, CQN on a {rows}-row CartPole-v1 dataset collected on the "
        f"card in {collect_s:.2f} s: population {CQN_HP['POP_SIZE']}, batch 64, buffer "
        f"{CQN_MEMORY}, evo_steps {CQN_EVO_STEPS}, max_steps {CQN_MAX_STEPS} (cut from 5,000 / "
        f"50,000)")
    pop = create_population("CQN", cart.single_observation_space, cart.single_action_space,
                            CQN_NET, CQN_HP, seed=0)
    memory = ReplayBuffer(CQN_MEMORY)
    ops.reset_kernel_counters()
    (pop, fitnesses), t_loop = host_s(torch, lambda: train_offline(
        cart, "CartPole-v1", ds, "CQN", pop, memory, INIT_HP=CQN_HP, max_steps=CQN_MAX_STEPS,
        evo_steps=CQN_EVO_STEPS,
        tournament=TournamentSelection(2, True, CQN_HP["POP_SIZE"], 1,
                                       rng=np.random.default_rng(0)),
        mutation=Mutations(**OFF_MUTATION, rand_seed=0), verbose=False))
    offline_launches = ops.kernel_counters()
    # the loop's steps: learn_step per learn (1 unless a mutation moved it)
    steps = sum(a.steps[-1] for a in pop)
    gens = len(fitnesses[0])
    check(len(memory) == CQN_ROWS and all(isinstance(a, CQN) for a in pop)
          and gens >= CQN_MAX_STEPS // CQN_EVO_STEPS
          and all(a.steps[-1] >= CQN_MAX_STEPS for a in pop)
          and all(np.isfinite(f).all() and len(f) == gens for f in fitnesses),
          f"train_offline: fitnesses {fitnesses}")
    off.update(collect_s=collect_s, rows=rows, terminals=int(ds["terminals"].sum()),
               loop_s=t_loop, generations=gens, steps=steps, steps_per_s=steps / t_loop,
               fitness=[list(map(float, f)) for f in fitnesses], launches=offline_launches)
    log(f"  {gens} generations, {steps} learn steps in {t_loop:.1f} s ({steps / t_loop:.0f} "
        f"per s, evaluation included); fitness {off['fitness']}")
    report["offline"] = off
    return launches, offline_launches


# ------------------------------- phase 4m ---------------------------------- #
# bench.py's bench_anakin at its defaults (bench.py:1059-1232): EvoDQN on
# CartPole-v1 and EvoDDPG on Pendulum-v1, 8 envs x 256 steps, buffer 10,000,
# batch 64, learn_every 4, latent 32, hidden [64], adam(1e-3) (EvoDDPG:
# adam(1e-4) / adam(1e-3)), population 1; 1 warm-up + 2 timed generations (3
# until phases 4n and 4o came),
# beside the per-agent loop at the same widths as bench_anakin runs it
# (staging, flush every 8, learn_from_buffer every 4 vector steps; 64 warm-up
# + 256 timed steps). Then EvoDQN at benchmarking_off_policy_distributed.py's
# member widths (32 envs x 128 steps, batch 64, learn_every 1, buffer 10,000)
# at population 8 (two members per device x four devices, here on one
# card), and EvoRainbow / EvoTD3 at a small width (8 envs x 64 steps, buffer
# 2,048, batch 32, population 4; 1 generation each, its first-call costs
# included: the warm-up generation went when phases 4n and 4o came).
ANAKIN = dict(num_envs=8, steps_per_iter=256, buffer_size=10_000, batch_size=64,
              learn_every=4, latent=32, hidden=64, warmup=1, timed=2)
SCAN_DIST = dict(num_envs=32, steps_per_iter=128, buffer_size=10_000, batch_size=64,
                 learn_every=1, pop=8)
SCAN_SMALL = dict(num_envs=8, steps_per_iter=64, buffer_size=2_048, batch_size=32, pop=4)
PROFILE_TICKS = 64  # the profiled bench_anakin EvoDQN generation (256 ticks before 4n and 4o)
# tests/test_parallel/test_cross_tier.py's gate: 30 ticks, 4 envs, batch 16,
# buffer 128, latent 16, hidden [32], losses rtol 1e-4 (atol 1e-6)
CROSS_TIER = dict(ticks=30, num_envs=4, batch_size=16, buffer_size=128, rtol=1e-4, atol=1e-6,
                  net={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}})
SCAN_MEMBER_ATOL = 1e-5  # a member alone against its batched slice (summation order)


def scan_net(env, outputs, latent, hidden, **head_kw):
    """bench_anakin's net_cfg: an MLP encoder and an MLP head."""
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config

    kind, enc = default_encoder_config(env.observation_space, latent_dim=latent,
                                       encoder_config={"hidden_size": (hidden,)})
    return NetworkConfig(encoder_kind=kind, encoder=enc,
                         head=MLPConfig(num_inputs=head_kw.pop("num_inputs", latent),
                                        num_outputs=outputs, hidden_size=(hidden,), **head_kw),
                         latent_dim=latent)


def scan_engines(cfg, device=None):
    """bench_anakin's EvoDQN and EvoDDPG at ``cfg``'s widths."""
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.envs.classic import CartPole, Pendulum
    from agilerl_tpu_torch.parallel import EvoDDPG, EvoDQN

    kw = {k: cfg[k] for k in ("num_envs", "steps_per_iter", "buffer_size", "batch_size",
                              "learn_every")}
    L, H = cfg["latent"], cfg["hidden"]
    cart, pend = CartPole(), Pendulum()
    dqn = EvoDQN(cart, scan_net(cart, 2, L, H), adam(1e-3), device=device, **kw)
    ddpg = EvoDDPG(pend, scan_net(pend, 1, L, H, output_activation="Tanh"),
                   scan_net(pend, 1, L, H, num_inputs=L + 1), device=device, **kw)
    return dqn, ddpg


def per_agent_sps(torch, algo):
    """bench_anakin's per-agent protocol at its widths on the device env:
    env-steps/s of 256 timed vector steps after 64 warm-up steps."""
    from agilerl_tpu_torch.algorithms.ddpg import DDPG
    from agilerl_tpu_torch.algorithms.dqn import DQN
    from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
    from agilerl_tpu_torch.envs.classic import CartPole, Pendulum
    from agilerl_tpu_torch.envs.core import TorchVecEnv

    N, B, every = ANAKIN["num_envs"], ANAKIN["batch_size"], ANAKIN["learn_every"]
    net = {"latent_dim": ANAKIN["latent"], "encoder_config": {"hidden_size": (ANAKIN["hidden"],)}}
    if algo == "dqn":
        env = TorchVecEnv(CartPole(), num_envs=N, seed=0)
        agent = DQN(env.single_observation_space, env.single_action_space, batch_size=B,
                    lr=1e-3, net_config=net, seed=0)
        act = lambda obs: agent.get_action(obs, epsilon=0.1)  # noqa: E731
    else:
        env = TorchVecEnv(Pendulum(), num_envs=N, seed=0)
        agent = DDPG(env.single_observation_space, env.single_action_space, batch_size=B,
                     O_U_noise=False, net_config=net, seed=0)
        act = lambda obs: agent.get_action(obs)  # noqa: E731
    memory = ReplayBuffer(ANAKIN["buffer_size"], seed=0, flush_every=8)

    def loop(n_steps):
        obs, _ = env.reset()
        for t in range(n_steps):
            action = act(obs)
            next_obs, reward, term, trunc, _ = env.step(action)
            memory.stage({"obs": obs, "action": action, "reward": reward.float(),
                          "next_obs": next_obs, "done": term.float()}, batched=True)
            obs = next_obs
            if t % every == 0:
                memory.flush()
                if len(memory) >= B:
                    agent.learn_from_buffer(memory)

    loop(max(ANAKIN["steps_per_iter"] // 4, 2 * every * B // N))
    _, t = host_s(torch, lambda: loop(ANAKIN["steps_per_iter"]))
    return ANAKIN["steps_per_iter"] * N / t


def timed_scan(torch, evo, pop_size, warmup, timed, seed=0):
    """(ScanRun, {warm-up s, timed s, env-steps/s, ms per generation, peak
    GB, fitness}) of ``warmup`` + ``timed`` generations."""
    import numpy as np

    from agilerl_tpu_torch.parallel import ScanRun

    run = ScanRun(evo, pop_size, seed=seed)
    _, warm_s = host_s(torch, lambda: run.run(warmup))
    torch.cuda.reset_peak_memory_stats()
    hist, timed_s = host_s(torch, lambda: run.run(timed))
    steps = pop_size * evo.env_steps_per_generation * timed
    check(hist.shape == (timed, pop_size) and bool(np.isfinite(hist).all()),
          f"{type(evo).__name__}: fitness history {hist}")
    return run, dict(warmup_s=warm_s, timed_s=timed_s, env_steps=steps,
                     env_steps_per_s=steps / timed_s, ms_per_generation=1e3 * timed_s / timed,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     fitness=hist.tolist(), learn_count=run.pop.learn_count)


def member_slice(torch, tree, p, dim=0):
    from agilerl_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.narrow(dim, p, 1).clone() if isinstance(x, torch.Tensor) else x,
                    tree)


def scan_cross_tier(torch, kind):
    """The JAX cross-tier gate on the card: CROSS_TIER's ticks of one member
    against the per-agent learn_from_buffer on the member's transitions and
    sample indices, from the member's weights and Adam state. Returns the
    count compared and the worst relative loss error."""
    from agilerl_tpu_torch.algorithms.ddpg import DDPG
    from agilerl_tpu_torch.algorithms.dqn import DQN
    from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
    from agilerl_tpu_torch.envs.classic import CartPole, Pendulum
    from agilerl_tpu_torch.parallel import EvoDDPG, EvoDQN
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    c = CROSS_TIER
    kw = dict(num_envs=c["num_envs"], steps_per_iter=c["ticks"], buffer_size=c["buffer_size"],
              batch_size=c["batch_size"], gamma=0.99, tau=0.01)
    if kind == "dqn":
        env = CartPole()
        agent = DQN(env.observation_space, env.action_space, batch_size=c["batch_size"],
                    lr=1e-3, gamma=0.99, tau=0.01, net_config=c["net"], seed=0)
        evo = EvoDQN(env, agent.actor.config, agent.optimizer.tx, **kw)
        pairs = (("actor", "params"), ("actor_target", "target"))
        opts = (("optimizer", "opt_state"),)
    else:
        env = Pendulum()
        agent = DDPG(env.observation_space, env.action_space, batch_size=c["batch_size"],
                     lr_actor=1e-4, lr_critic=1e-3, gamma=0.99, tau=0.01, policy_freq=2,
                     O_U_noise=False, net_config=c["net"], seed=0)
        evo = EvoDDPG(env, agent.actor.config, agent.critic.config,
                      tx_actor=agent.actor_optimizer.tx, tx_critic=agent.critic_optimizer.tx,
                      policy_freq=2, **kw)
        pairs = (("actor", "actor"), ("actor_target", "actor_target"), ("critic", "critic"),
                 ("critic_target", "critic_target"))
        opts = (("actor_optimizer", "actor_opt"), ("critic_optimizer", "critic_opt"))
    pop = evo.init_population(1, 1)
    first = lambda x: x[0].clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
    for mine, theirs in pairs:
        getattr(agent, mine).params = tree_map(first, getattr(pop.learner, theirs))
    for mine, theirs in opts:
        getattr(agent, mine).opt_state = tree_map(first, getattr(pop.learner, theirs))
    draws = evo.draw_iteration(pop, torch.Generator(device="cuda").manual_seed(2))
    end, _, record = evo.member_iteration_debug(pop, draws)
    memory = ReplayBuffer(c["buffer_size"])
    worst, compared = 0.0, 0
    for rec in record:
        memory.add({k: rec["transition"][k][0] for k in ("obs", "action", "reward", "next_obs",
                                                         "done")}, batched=True)
        if rec["do_learn"]:
            got = float(agent.learn_from_buffer(memory, draws=rec["sample"][0]))
            want = float(rec["loss"][0])
            check(abs(got - want) <= c["atol"] + c["rtol"] * abs(want),
                  f"{kind} cross-tier: tick loss {want} (scan) vs {got} (per agent)")
            worst = max(worst, abs(got - want) / max(abs(want), 1e-12))
            compared += 1
    check(compared >= c["ticks"] // 2, f"{kind} cross-tier: only {compared} learns compared")
    for mine, theirs in pairs:
        for a, b in zip(tree_leaves(getattr(agent, mine).params),
                        tree_leaves(getattr(end.learner, theirs))):
            check(bool(torch.allclose(a, b[0], rtol=c["rtol"], atol=c["atol"])),
                  f"{kind} cross-tier: end weights of {mine}")
    return dict(compared=compared, worst_loss_rel_err=worst)


def scan_card_vs_cpu(torch, out):
    """One EvoDDPG generation (SCAN_SMALL widths, learn_every 1, population
    2: continuous actions, so rounding moves no discrete choice) on the card
    and on the CPU from the same population and draws: fitness rtol 1e-4,
    the rings' rows atol 1e-3, every learner weight atol 1e-4 where its Adam
    first moment is >= 1e-6 (phase 4i's rule)."""
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = dict(SCAN_SMALL, learn_every=1, latent=32, hidden=64)
    _, evo = scan_engines(cfg)
    _, evo_cpu = scan_engines(cfg, device="cpu")
    pop = evo.init_population(3, 2)
    draws = evo.draw_iteration(pop, torch.Generator(device="cuda").manual_seed(3))
    to_cpu = lambda x: x.cpu().clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
    cpu_pop, cpu_draws = tree_map(to_cpu, pop), tree_map(to_cpu, draws)
    card, fit = evo.member_iteration(pop, draws)
    cpu, fit_cpu = evo_cpu.member_iteration(cpu_pop, cpu_draws)
    fit_err = float((fit.cpu() - fit_cpu).abs().max() / fit_cpu.abs().max())
    worst, exempt = 0.0, 0.0
    for net, opt in (("actor", "actor_opt"), ("critic", "critic_opt")):
        mu = getattr(cpu.learner, opt)[0].mu
        w, e = weights_rule(torch, getattr(card.learner, net), getattr(cpu.learner, net), mu)
        worst, exempt = max(worst, w), max(exempt, e)
    ring_err = max(float((a.cpu().float() - b.float()).abs().max())
                   for a, b in zip(tree_leaves(card.ring.storage), tree_leaves(cpu.ring.storage)))
    out["card_vs_cpu"] = dict(fitness_rel_err=fit_err, weight_max_abs_err=worst,
                              exempt_share=exempt, ring_max_abs_err=ring_err,
                              learn_count=card.learn_count)
    log(f"  one EvoDDPG generation card vs CPU: {out['card_vs_cpu']}")
    # the actor's first moments at lr 1e-4 sit below 1e-6 for ~8-13 % of
    # its entries after a generation's learns: those are held by them alone
    check(fit_err <= 1e-4 and worst <= 1e-4 and ring_err <= 1e-3 and exempt < 0.25,
          f"EvoDDPG generation card vs CPU: {out['card_vs_cpu']}")


def run_off_policy_scan(torch, ops, report):
    """Phase 4m: Queue 1's slice 5c-scan on the card: bench_anakin's
    EvoDQN and EvoDDPG through ScanRun (1 warm-up + 2 timed generations)
    beside the per-agent loop, EvoDQN at the distributed harness's member
    widths at population 8, EvoRainbow and EvoTD3 at a small width; host
    syncs (<= 1), launches and busy share of one generation; a member alone
    against its batched slice; the cross-tier loss gate for DQN and DDPG;
    one EvoDDPG generation card vs CPU. Returns the kernel launches."""
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.envs.classic import CartPole, Pendulum
    from agilerl_tpu_torch.networks.q_networks import RainbowQNetwork
    from agilerl_tpu_torch.parallel import EvoDQN, EvoRainbow, EvoTD3, ScanRun
    from agilerl_tpu_torch.utils.tree import tree_copy, tree_leaves

    out = {"anakin": ANAKIN, "distributed": SCAN_DIST, "small": SCAN_SMALL, "parts_s": {}}
    launches = {k: 0 for k in ops.kernel_counters()}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        out["parts_s"][name] = now - t_part[0]
        t_part[0] = now

    def count(fn):
        ops.reset_kernel_counters()
        result = fn()
        for k, v in ops.kernel_counters().items():
            launches[k] += v
        return result

    dqn, ddpg = scan_engines(ANAKIN)
    check(dqn.device.type == "cuda" and ddpg.device.type == "cuda", "a scan engine left the card")
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    for name, evo in (("dqn", dqn), ("ddpg", ddpg)):
        log(f"phase 4m: {type(evo).__name__} through ScanRun at bench_anakin's defaults: "
            f"{ANAKIN['num_envs']} envs x {ANAKIN['steps_per_iter']} steps, population 1")
        run, res = count(lambda: timed_scan(torch, evo, 1, ANAKIN["warmup"], ANAKIN["timed"]))
        with SyncGuard(device="cuda", label=f"4m {name} generation") as g:
            count(lambda: run.run(1))
        sites = g.sites
        syncs = sum(n for site, n in sites.items() if site not in base_sites)
        check(syncs <= 1, f"{name}: {syncs} host syncs in one generation {sites}")
        # one generation under torch.profiler, of the same program at 64
        # ticks (event processing took ~20 s for a 256-tick generation's
        # 36,909 launches): one profile for the phase
        prof = None
        if name == "dqn":
            short = scan_engines(dict(ANAKIN, steps_per_iter=PROFILE_TICKS))[0]
            short_run = ScanRun(short, 1, seed=0)
            count(lambda: short_run.run(1))
            prof = count(lambda: profile_generation(torch, lambda: short_run.run(1)))
            prof["ticks"] = PROFILE_TICKS
        res.update(syncs_per_generation=syncs, sync_sites=sites, profile=prof,
                   per_agent_env_steps_per_s=per_agent_sps(torch, name))
        res["speedup_over_per_agent"] = res["env_steps_per_s"] / res["per_agent_env_steps_per_s"]
        out[f"anakin_{name}"] = res
        log(f"  {res['env_steps_per_s']:.0f} env-steps/s ({res['ms_per_generation']:.1f} ms per "
            f"generation, warm-up {res['warmup_s']:.2f} s; per-agent loop "
            f"{res['per_agent_env_steps_per_s']:.0f}, x{res['speedup_over_per_agent']:.2f}); "
            f"{res['learn_count']} learns; peak {res['peak_gb']:.3f} GB; {syncs} host syncs "
            f"{sites}; one generation under torch.profiler {prof}")
        part(f"anakin_{name}")

    log(f"phase 4m: EvoDQN at the distributed harness's member widths: population "
        f"{SCAN_DIST['pop']} x {SCAN_DIST['num_envs']} envs x {SCAN_DIST['steps_per_iter']} steps")
    cart = CartPole()
    dist = EvoDQN(cart, scan_net(cart, 2, 32, 64),
                  **{k: v for k, v in SCAN_DIST.items() if k != "pop"})
    run, res = count(lambda: timed_scan(torch, dist, SCAN_DIST["pop"], 1, ANAKIN["timed"]))
    with SyncGuard(device="cuda", label="4m distributed generation") as g:
        count(lambda: run.run(1))
    sites = g.sites
    syncs = sum(n for site, n in sites.items() if site not in base_sites)
    check(syncs <= 1, f"distributed: {syncs} host syncs in one generation {sites}")
    res.update(syncs_per_generation=syncs)
    # a member alone against its slice of the batched program (same draws)
    pop = run.pop
    draws = dist.draw_iteration(pop, torch.Generator(device="cuda").manual_seed(9))
    batched, fit = dist.member_iteration(tree_copy(pop), draws)
    p = 5
    alone, fit1 = dist.member_iteration(member_slice(torch, pop, p),
                                        member_slice(torch, draws, p, dim=1))
    worst = 0.0
    for a, b in zip(tree_leaves(alone), tree_leaves(member_slice(torch, batched, p))):
        if isinstance(a, torch.Tensor):
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        else:
            check(a == b, f"member {p} alone: host value {a} != {b}")
    fit_err = float((fit1 - fit[p:p + 1]).abs().max())
    res.update(member_alone_max_abs_err=worst, member_alone_fitness_err=fit_err)
    check(worst <= SCAN_MEMBER_ATOL and fit_err <= SCAN_MEMBER_ATOL,
          f"member {p} alone vs its batched slice: {worst}, fitness {fit_err}")
    out["distributed_dqn"] = res
    log(f"  {res['env_steps_per_s']:.0f} env-steps/s ({res['ms_per_generation']:.1f} ms per "
        f"generation); peak {res['peak_gb']:.3f} GB; {syncs} host syncs; member {p} alone vs "
        f"its slice: max abs err {worst}, fitness {fit_err}")
    part("distributed_dqn")

    pend = Pendulum()
    small = {k: SCAN_SMALL[k] for k in ("num_envs", "steps_per_iter", "buffer_size", "batch_size")}
    rq = RainbowQNetwork(cart.observation_space, cart.action_space, num_atoms=51, v_min=0.0,
                         v_max=200.0, latent_dim=32, encoder_config={"hidden_size": (64,)},
                         head_config={"hidden_size": (64,)})
    for name, evo in (("rainbow", EvoRainbow(cart, rq.config, **small)),
                      ("td3", EvoTD3(pend, scan_net(pend, 1, 32, 64, output_activation="Tanh"),
                                     scan_net(pend, 1, 32, 64, num_inputs=33), **small))):
        log(f"phase 4m: {type(evo).__name__} through ScanRun: population {SCAN_SMALL['pop']} x "
            f"{SCAN_SMALL['num_envs']} envs x {SCAN_SMALL['steps_per_iter']} steps")
        _, res = count(lambda: timed_scan(torch, evo, SCAN_SMALL["pop"], 0, 1))
        out[name] = res
        log(f"  {res['env_steps_per_s']:.0f} env-steps/s ({res['ms_per_generation']:.1f} ms per "
            f"generation); {res['learn_count']} learns; fitness {res['fitness']}")
        part(name)

    out["cross_tier"] = {k: scan_cross_tier(torch, k) for k in ("dqn", "ddpg")}
    log(f"  cross-tier loss gate (scan vs per-agent learn_from_buffer): {out['cross_tier']}")
    part("cross_tier")
    scan_card_vs_cpu(torch, out)
    part("card_vs_cpu")
    log(f"  phase 4m parts (s): {out['parts_s']}")
    out["launches"] = dict(launches)
    report["off_policy_scan"] = out
    return launches


# ------------------------------- phase 4n ---------------------------------- #
# configs/training/multi_agent/maddpg.yaml and matd3.yaml at their widths
# (the card's machine has no PyYAML) on SimpleSpreadTorch(n_agents=2), the
# in-repo stand-in of BASELINE config #3 (simple_speaker_listener_v4 is not
# in the repository): 8 envs, population 4, batch 128, learn_step 5, tau
# 0.01, gamma 0.95, expl_noise 0.1, a buffer of 100,000 rows, latent 64,
# hidden [64]; MATD3 policy_freq 2; the yaml's mutation probabilities. Cuts,
# for time: evo_steps 10,000 -> 120 and max_steps 100,000 -> 240 (2
# generations, so that the tournament's clones and mutated agents learn; at
# 800 / 1,600 the two loops took 35.3 s on an H100 80GB HBM3 at 700 W, at
# 400 / 800 24.3 s; 200 / 400 until phase 4s came).
MA_AGENTS = 2
MADDPG_HP = {"POP_SIZE": 4, "BATCH_SIZE": 128, "LR_ACTOR": 1e-4, "LR_CRITIC": 1e-3,
             "GAMMA": 0.95, "LEARN_STEP": 5, "TAU": 0.01, "EXPL_NOISE": 0.1, "NUM_ENVS": 8}
MATD3_HP = dict(MADDPG_HP, POLICY_FREQ=2)
MA_NET = {"latent_dim": 64, "encoder_config": {"hidden_size": (64,)}}
MA_MUTATION = dict(no_mutation=0.4, architecture=0.2, parameters=0.2, activation=0.0,
                   rl_hp=0.2, mutation_sd=0.1)
MA_MEMORY = 100_000
MA_EVO_STEPS = 120  # cut from 10,000 (200 until phase 4s came)
MA_MAX_STEPS = 240  # cut from 100,000 (400 until phase 4s came)
MA_SYNC_STEPS = 256  # the short run whose host syncs are counted (32 vector steps)
# tests/test_envs/test_probe_ma.py's settings (one discrete and one
# continuous MADDPG probe, the discounting probe for MATD3) at 250 learns
# each (500 / 400 / 400 there: 32.7 s here on an H100 80GB HBM3 at 700 W;
# each passes on seeds 0-3 or 0-5 at 250 on the CPU)
MA_PROBE_NET = {"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}}
MA_PROBES = (("PolicyEnvMA", "MADDPG", dict(lr_actor=3e-3, lr_critic=5e-3, gamma=0.9, tau=0.3),
              250, {}),
             ("FixedObsPolicyContActionsEnvMA", "MADDPG",
              dict(lr_actor=3e-3, lr_critic=5e-3, gamma=0.9, tau=0.3, expl_noise=0.2), 250, {}),
             ("DiscountedRewardEnvMA", "MATD3",
              dict(lr_actor=1e-3, lr_critic=5e-3, gamma=0.9, tau=0.3, policy_freq=1), 250,
              dict(atol=0.3)))
MA_RTOL = 1e-5  # a learn on the card against the CPU (phase 4k's rule for the weights)


def ma_batch(rng, n, continuous):
    """A sampled-buffer-like batch of SimpleSpread transitions (2 agents)."""
    import numpy as np

    ids = [f"agent_{i}" for i in range(MA_AGENTS)]
    obs_dim = 2 + 2 * MA_AGENTS

    def act():
        return (rng.uniform(-1, 1, (n, 2)).astype(np.float32) if continuous
                else rng.integers(0, 5, n).astype(np.int32))

    return {"obs": {a: rng.uniform(-1.5, 1.5, (n, obs_dim)).astype(np.float32) for a in ids},
            "action": {a: act() for a in ids},
            "reward": {a: rng.uniform(-4, 0, n).astype(np.float32) for a in ids},
            "next_obs": {a: rng.uniform(-1.5, 1.5, (n, obs_dim)).astype(np.float32) for a in ids},
            "done": {a: np.zeros(n, np.float32) for a in ids}}


def multi_agent_card_vs_cpu(torch, out):
    """One MADDPG learn and one MATD3 learn (its smoothing normals given, on
    the policy cadence) on the card against the CPU, on the same batch and
    weights: the loss, every weight by phase 4k's rule (entries whose first
    gradient is below 1e-6 held through their Adam moments) and the
    moments rtol 1e-5."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy
    from agilerl_tpu_torch.algorithms.maddpg import MADDPG
    from agilerl_tpu_torch.algorithms.matd3 import MATD3
    from agilerl_tpu_torch.envs.multi_agent import SimpleSpreadTorch
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map, tree_to_numpy

    res = {}
    for name, cls, continuous in (("maddpg", MADDPG, False), ("matd3", MATD3, True)):
        env = SimpleSpreadTorch(MA_AGENTS, continuous=continuous)
        batch = ma_batch(np.random.default_rng(7), 128, continuous)
        agents = {dev: cls(env.observation_spaces, env.action_spaces, agent_ids=env.agent_ids,
                           net_config=MA_NET, lr_actor=1e-3, lr_critic=1e-3, seed=1, device=dev)
                  for dev in ("cuda", "cpu")}
        names = agents["cpu"].registry.all_network_names()
        load_params_from_numpy(agents["cuda"], {
            n: {a: tree_to_numpy(net.params) for a, net in getattr(agents["cpu"], n).items()}
            for n in names})
        normals = {a: torch.randn(128, 2, generator=torch.Generator().manual_seed(4))
                   for a in env.agent_ids}
        losses = {}
        for dev, agent in agents.items():
            if name == "maddpg":
                losses[dev] = agent.learn(batch)
            else:
                losses[dev] = float(agent.twin_train_step(
                    agent._prepare(batch), {a: v.to(dev) for a, v in normals.items()}, True))
        loss_err = abs(losses["cuda"] - losses["cpu"]) / max(abs(losses["cpu"]), 1e-12)
        worst, exempt, mu_err = 0.0, 0.0, 0.0
        for cfg in agents["cpu"].registry.optimizer_configs:
            # the first step's gradient (Adam's first moment / (1 - b1))
            mu = getattr(agents["cpu"], cfg.name).opt_state.inner_state[0].mu
            mu_card = getattr(agents["cuda"], cfg.name).opt_state.inner_state[0].mu
            mu_err = max([mu_err] + [float((a.cpu() - b).abs().max()
                                           / b.abs().max().clamp(min=1e-30))
                                     for a, b in zip(tree_leaves(mu_card), tree_leaves(mu))])
            grad = tree_map(lambda m: m / 0.1, mu)
            for net in cfg.networks:
                w, e = weights_rule(
                    torch, {a: n.params for a, n in getattr(agents["cuda"], net).items()},
                    {a: n.params for a, n in getattr(agents["cpu"], net).items()}, grad)
                worst, exempt = max(worst, w), max(exempt, e)
        res[name] = dict(loss=losses, loss_rel_err=loss_err, weight_max_abs_err=worst,
                         exempt_share=exempt, mu_rel_err=mu_err)
        check(loss_err <= MA_RTOL, f"{name} learn loss on the card vs CPU: {losses}")
        check(worst <= MA_RTOL and mu_err <= MA_RTOL,
              f"{name} weights after a learn on the card vs CPU: {worst}, moments {mu_err}")
        # a discrete actor's expected-Q gradient is below 1e-6 on about a sixth
        # of its entries at this batch: those are held through their moments
        check(exempt < 0.5, f"{name}: {exempt:.3f} of the weights held by gradient")
    out["card_vs_cpu"] = res
    log(f"  card vs CPU: {res}")


def run_multi_agent_off_policy(torch, ops, report):
    """Phase 4n: Queue 1's slice 5d, part A, on the card: MADDPG and MATD3
    through train_multi_agent_off_policy on their configs (2 generations
    each), the host syncs of one learn (the loss read: 1) and per vector step
    of the loop, ms and launches per learn, a discrete and a continuous
    MADDPG probe and MATD3's discounting probe, a MADDPG checkpoint round
    trip, one MADDPG and one MATD3 learn card vs CPU. Returns the kernel
    launches of the loops."""
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.algorithms.maddpg import MADDPG
    from agilerl_tpu_torch.algorithms.matd3 import MATD3
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.components.multi_agent_replay_buffer import MultiAgentReplayBuffer
    from agilerl_tpu_torch.envs import probe_ma as PM
    from agilerl_tpu_torch.envs.multi_agent import MultiAgentTorchVecEnv, SimpleSpreadTorch
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.training.train_multi_agent_off_policy import (
        train_multi_agent_off_policy,
    )
    from agilerl_tpu_torch.utils.utils import create_population

    out = {}
    launches = {k: 0 for k in ops.kernel_counters()}
    np.random.seed(0)
    env = MultiAgentTorchVecEnv(SimpleSpreadTorch(MA_AGENTS), MADDPG_HP["NUM_ENVS"], seed=0)
    check(env.device.type == "cuda", f"MultiAgentTorchVecEnv put the env on {env.device}")
    keys = ("generation", "act_s", "learn_s", "eval_s", "evo_s", "learn_calls", "fitness",
            "mutations", "last_losses")
    runs = {}
    for name, hp in (("MADDPG", MADDPG_HP), ("MATD3", MATD3_HP)):
        log(f"phase 4n: train_multi_agent_off_policy, {name} on SimpleSpreadTorch({MA_AGENTS}): "
            f"{hp['NUM_ENVS']} envs, population {hp['POP_SIZE']}, buffer {MA_MEMORY}, evo_steps "
            f"{MA_EVO_STEPS}, max_steps {MA_MAX_STEPS} (cut from 10,000 / 100,000)")
        pop = create_population(name, env.observation_spaces, env.action_spaces, MA_NET, hp,
                                seed=0, agent_ids=env.agent_ids)
        check(all(a.dev.type == "cuda" for a in pop), "create_population left the card")
        memory = MultiAgentReplayBuffer(MA_MEMORY, env.agent_ids)
        sink = MemorySink()
        telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
        ops.reset_kernel_counters()
        torch.cuda.reset_peak_memory_stats()
        (pop, fitnesses), t_loop = host_s(torch, lambda: train_multi_agent_off_policy(
            env, "simple_spread", name, pop, memory, INIT_HP=hp, max_steps=MA_MAX_STEPS,
            evo_steps=MA_EVO_STEPS,
            tournament=TournamentSelection(2, True, hp["POP_SIZE"], 1,
                                           rng=np.random.default_rng(0)),
            mutation=Mutations(**MA_MUTATION, rand_seed=0), telemetry=telem, verbose=False,
            seed=0))
        for k, v in ops.kernel_counters().items():
            launches[k] += v
        gens = [e for e in sink.events if e["kind"] == "generation"]
        env_steps = gens[-1]["total_steps"]
        check(len(gens) == MA_MAX_STEPS // MA_EVO_STEPS
              and all(np.isfinite(f).all() and len(f) == len(gens) for f in fitnesses)
              and all(np.isfinite(g["last_losses"]).all() and g["learn_calls"] > 0
                      for g in gens), f"{name}: {len(gens)} generations, fitnesses {fitnesses}")
        check(len(memory) == min(MA_MEMORY, env_steps),
              f"{name}: the buffer holds {len(memory)} rows, not {env_steps}")
        out[name] = dict(loop_s=t_loop, env_steps=env_steps, env_steps_per_s=env_steps / t_loop,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         generations=[{k: g[k] for k in keys} for g in gens])
        for g in gens:
            log(f"  {name} generation {g['generation']}: act + env step {g['act_s']:.2f} s, "
                f"learn {g['learn_s']:.2f} s ({g['learn_calls']} calls), eval {g['eval_s']:.2f} "
                f"s, tournament + mutation {g['evo_s']:.3f} s; fitness "
                f"{[round(f, 1) for f in g['fitness']]}; mutations {g['mutations']}")
        log(f"  {name}: {env_steps} env steps in {t_loop:.1f} s ({env_steps / t_loop:.0f} "
            f"env-steps/s); peak {out[name]['peak_gb']:.3f} GB")
        runs[name] = (pop, memory)

    # one learn of each on its run's buffer: host syncs, ms, launches
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    for name, (pop, memory) in runs.items():
        agent = pop[0]
        learn = lambda: agent.learn(memory.sample(agent.batch_size))  # noqa: E731
        with SyncGuard(device="cuda", label=f"4n {name} learn") as g:
            learn()
        sites = g.sites
        syncs = sum(n for site, n in sites.items() if site not in base_sites)
        check(syncs <= 1, f"{name}: {syncs} host syncs in one learn {sites}")
        for _ in range(3):
            learn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            learn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 20
        # MATD3: one learn off the policy cadence and one on it
        prof = [profile_generation(torch, learn) for _ in range(1 if name == "MADDPG" else 2)]
        out[name].update(learn_syncs=syncs, learn_sync_sites=sites, ms_per_learn=ms,
                         learn_profile=prof)
        log(f"  {name} learn (batch {agent.batch_size}, sample included): {syncs} host syncs "
            f"{sites}, {ms:.2f} ms per call (20 calls), under torch.profiler {prof}")

    # host syncs per vector step of the loop: MADDPG, one agent, no learn
    # (learning_delay past the run), one evaluation step
    probe_agent = runs["MADDPG"][0][0].clone(index=50)
    probe_agent.steps = [0]
    with SyncGuard(device="cuda", label="4n loop") as g:
        train_multi_agent_off_policy(
            env, "simple_spread", "MADDPG", [probe_agent], runs["MADDPG"][1],
            max_steps=MA_SYNC_STEPS, evo_steps=MA_SYNC_STEPS, eval_steps=1,
            learning_delay=10 ** 9, verbose=False)
    sites = g.sites
    loop_syncs = sum(n for site, n in sites.items() if site not in base_sites)
    vec_steps = MA_SYNC_STEPS // MADDPG_HP["NUM_ENVS"]
    out.update(loop_syncs=loop_syncs, loop_sync_sites=sites,
               syncs_per_vector_step=loop_syncs / vec_steps)
    log(f"  host syncs in {vec_steps} vector steps of the loop without learns (one evaluation "
        f"step included): {loop_syncs} {sites}")
    check(loop_syncs <= 2, f"{loop_syncs} host syncs in {vec_steps} vector steps and one "
          f"evaluation step")

    probes = {}
    for env_name, algo, kw, steps, extra in MA_PROBES:
        probe = getattr(PM, env_name)()
        t0 = time.perf_counter()
        PM.check_ma_q_learning_with_probe_env(
            probe, {"MADDPG": MADDPG, "MATD3": MATD3}[algo],
            dict(observation_spaces=probe.observation_spaces, action_spaces=probe.action_spaces,
                 agent_ids=probe.agent_ids, net_config=MA_PROBE_NET, seed=0, **kw),
            learn_steps=steps, **extra)
        probes[f"{algo}/{env_name}"] = time.perf_counter() - t0
    out["probes_s"] = probes
    log(f"  probes passed: {probes}")

    agent = runs["MADDPG"][0][0]
    obs = {a: torch.rand(256, 2 + 2 * MA_AGENTS, device="cuda") * 2 - 1 for a in env.agent_ids}
    with tempfile.TemporaryDirectory() as work:
        path = Path(work) / "maddpg.ckpt"
        agent.save_checkpoint(path)
        loaded = MADDPG.load(path)
    same = all(torch.equal(loaded.get_action(obs, training=False)[a],
                           agent.get_action(obs, training=False)[a]) for a in env.agent_ids)
    check(loaded.dev.type == "cuda" and same, f"MADDPG checkpoint round trip: same actions {same}")
    out["checkpoint_round_trip"] = dict(same_greedy_actions=same)
    multi_agent_card_vs_cpu(torch, out)
    out["launches"] = dict(launches)
    report["multi_agent_off_policy"] = out
    return launches


# ------------------------------- phase 4o ---------------------------------- #
# configs/training/multi_agent/ippo.yaml at its widths on
# SimpleSpreadTorch(n_agents=2): 8 envs, population 4, batch 128, lr 3e-4,
# learn_step 128, 4 epochs, clip 0.2, ent 0.01, vf 0.5, max_grad_norm 0.5,
# latent 64, hidden [64]. Cuts, for time: evo_steps 10,000 -> 1,024 and
# max_steps 100,000 -> 2,048 (2 generations of one collect + learn per
# agent). Then EvoIPPO at its constructor's widths (32 envs x 32 steps, 2
# epochs, 2 minibatches) with ippo.yaml's network widths and adam(3e-4), at
# population 8: 1 warm-up + 2 timed generations through ScanRun.
IPPO_HP = {"POP_SIZE": 4, "BATCH_SIZE": 128, "LR": 3e-4, "GAMMA": 0.99, "GAE_LAMBDA": 0.95,
           "LEARN_STEP": 128, "CLIP_COEF": 0.2, "ENT_COEF": 0.01, "VF_COEF": 0.5,
           "MAX_GRAD_NORM": 0.5, "UPDATE_EPOCHS": 4, "NUM_ENVS": 8}
IPPO_EVO_STEPS = 1_024  # cut from 10,000
IPPO_MAX_STEPS = 2_048  # cut from 100,000
# tests/test_envs/test_probe_ma.py's IPPO probe settings. PolicyEnvMA (that
# test's probe) is solved on 0.7-0.8 of seeds in both packages (on the CPU:
# the port 28 of seeds 0-39, the JAX package 18 of seeds 0-22; a solved
# one-step probe can collapse under PPO's normalised noise), so it must
# solve on one of seeds 0-2 (each package fails that on 1-3 % of seed
# triples); FixedObsPolicyEnvMA (16 of 16 seeds on the CPU) on seed 0.
IPPO_PROBE = dict(num_envs=8, learn_step=32, batch_size=64, update_epochs=4, lr=5e-3,
                  gamma=0.9, ent_coef=0.01,
                  net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}})
EVO_IPPO = dict(pop=8, num_envs=32, rollout_len=32, update_epochs=2, num_minibatches=2,
                latent=64, hidden=64, lr=3e-4, warmup=1, timed=2)


def evo_ippo(torch, device=None):
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.envs.multi_agent import SimpleSpreadTorch
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks import distributions as D
    from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config
    from agilerl_tpu_torch.parallel import EvoIPPO

    env = SimpleSpreadTorch(MA_AGENTS)
    dist = D.dist_config_from_space(env.action_spaces[env.agent_ids[0]])
    L, H = EVO_IPPO["latent"], EVO_IPPO["hidden"]
    kind, enc = default_encoder_config(env.observation_spaces[env.agent_ids[0]], L,
                                       encoder_config={"hidden_size": (H,)})
    a, c = (NetworkConfig(kind, enc, MLPConfig(num_inputs=L, num_outputs=n, hidden_size=(H,)),
                          latent_dim=L) for n in (D.head_output_dim(dist), 1))
    return EvoIPPO(env, a, c, dist, adam(EVO_IPPO["lr"]), num_envs=EVO_IPPO["num_envs"],
                   rollout_len=EVO_IPPO["rollout_len"], update_epochs=EVO_IPPO["update_epochs"],
                   num_minibatches=EVO_IPPO["num_minibatches"], device=device)


def evo_ippo_update_card_vs_cpu(torch, evo, pop, draws, out):
    """One EvoIPPO generation's rollout on the card and on the CPU from the
    same 2 members and draws (the share of equal actions), then GAE and the
    PPO epochs on both devices from the card's trajectory: the weights by
    phase 4i's rule, the Adam moments rtol 1e-5."""
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    evo_cpu = evo_ippo(torch, device="cpu")
    cpu = lambda t: tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, t)  # noqa
    sub = member_slice(torch, pop, 0)
    sub = tree_map(lambda a, b: torch.cat([a, b]) if isinstance(a, torch.Tensor) else a, sub,
                   member_slice(torch, pop, 1))
    d = tree_map(lambda x: x.narrow(1, 0, 2), {"action": draws["action"],
                                               "reset": draws["reset"],
                                               "perm": draws["perm"]})
    traj, _, _, obs, _, _ = evo._rollout(sub, d)
    traj_cpu = evo_cpu._rollout(cpu(sub), cpu(d))[0]
    same_actions = float((traj["action"].cpu() == traj_cpu["action"]).float().mean())
    ca, cc, copt = evo._learn(sub, traj, obs, d["perm"])
    ha, hc, hopt = evo_cpu._learn(cpu(sub), cpu(traj), cpu(obs), cpu(d["perm"]))
    mu_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30))
                 for a, b in zip(tree_leaves(copt[0].mu), tree_leaves(hopt[0].mu)))
    w_err, exempt = weights_rule(torch, (ca, cc), (ha, hc), hopt[0].mu)
    out["card_vs_cpu"] = dict(rollout_equal_action_share=same_actions, mu_rel_err=mu_err,
                              weight_err=w_err, exempt_share=exempt)
    log(f"  EvoIPPO card vs CPU: {out['card_vs_cpu']}")
    check(same_actions >= 0.99, f"EvoIPPO rollout card vs CPU: {same_actions:.4f} of the "
          f"actions equal")
    check(mu_err <= POP_MOMENT_RTOL and w_err <= POP_WEIGHT_ATOL and exempt < 0.15,
          f"EvoIPPO update card vs CPU: {out['card_vs_cpu']}")


def run_multi_agent_on_policy(torch, ops, report):
    """Phase 4o: Queue 1's slice 5d, part B, on the card: IPPO through
    train_multi_agent_on_policy on ippo.yaml (2 generations), the host syncs
    of one collect_rollouts (1) and one learn (1), ms per collect and learn,
    the IPPO policy probes; then EvoIPPO through ScanRun (1 warm-up + 2 timed
    generations): env-steps/s, host syncs (<= 1), launches and busy share of
    one generation, a member alone against its batched slice, and one
    generation's rollout and update card vs CPU. Returns the kernel
    launches of the per-agent loop and of the population program."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.ippo import IPPO
    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.envs import probe_ma as PM
    from agilerl_tpu_torch.envs.multi_agent import MultiAgentTorchVecEnv, SimpleSpreadTorch
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.parallel import ScanRun
    from agilerl_tpu_torch.training.train_multi_agent_on_policy import (
        train_multi_agent_on_policy,
    )
    from agilerl_tpu_torch.utils.tree import tree_leaves
    from agilerl_tpu_torch.utils.utils import create_population

    out = {}
    hp = IPPO_HP
    env = MultiAgentTorchVecEnv(SimpleSpreadTorch(MA_AGENTS), hp["NUM_ENVS"], seed=0)
    log(f"phase 4o: train_multi_agent_on_policy, IPPO on SimpleSpreadTorch({MA_AGENTS}): "
        f"{hp['NUM_ENVS']} envs, population {hp['POP_SIZE']}, learn_step {hp['LEARN_STEP']}, "
        f"evo_steps {IPPO_EVO_STEPS}, max_steps {IPPO_MAX_STEPS} (cut from 10,000 / 100,000)")
    np.random.seed(0)
    pop = create_population("IPPO", env.observation_spaces, env.action_spaces, MA_NET, hp,
                            seed=0, agent_ids=env.agent_ids, num_envs=hp["NUM_ENVS"])
    check(all(a.dev.type == "cuda" for a in pop), "create_population left the card")
    sink = MemorySink()
    telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
    ops.reset_kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    (pop, fitnesses), t_loop = host_s(torch, lambda: train_multi_agent_on_policy(
        env, "simple_spread", "IPPO", pop, INIT_HP=hp, max_steps=IPPO_MAX_STEPS,
        evo_steps=IPPO_EVO_STEPS,
        tournament=TournamentSelection(2, True, hp["POP_SIZE"], 1, rng=np.random.default_rng(0)),
        mutation=Mutations(**MA_MUTATION, rand_seed=0), telemetry=telem, verbose=False))
    loop_launches = ops.kernel_counters()
    gens = [e for e in sink.events if e["kind"] == "generation"]
    env_steps = gens[-1]["total_steps"]
    check(len(gens) == IPPO_MAX_STEPS // IPPO_EVO_STEPS
          and all(np.isfinite(f).all() and len(f) == len(gens) for f in fitnesses),
          f"IPPO: {len(gens)} generations, fitnesses {fitnesses}")
    out["loop"] = dict(loop_s=t_loop, env_steps=env_steps, env_steps_per_s=env_steps / t_loop,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       generations=[{k: g[k] for k in ("generation", "collect_s", "learn_s",
                                                       "learn_calls", "eval_s", "evo_s",
                                                       "fitness", "mutations")} for g in gens])
    parts = [tuple(round(g[k], 2) for k in ("collect_s", "learn_s", "eval_s")) for g in gens]
    log(f"  {env_steps} env steps in {t_loop:.1f} s ({env_steps / t_loop:.0f} env-steps/s); "
        f"per generation collect / learn / eval s {parts}; "
        f"fitness {[[round(x, 1) for x in g['fitness']] for g in gens]}; mutations "
        f"{[g['mutations'] for g in gens]}; peak {out['loop']['peak_gb']:.3f} GB")

    agent = pop[0]
    agent._last_obs = None
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    with SyncGuard(device="cuda", label="4o collect") as g:
        agent.collect_rollouts(env)
    sites_c = g.sites
    with SyncGuard(device="cuda", label="4o learn") as g:
        loss = agent.learn()
    sites_l = g.sites
    _, t_collect = host_s(torch, lambda: agent.collect_rollouts(env))
    _, t_learn = host_s(torch, agent.learn)
    syncs_c = sum(n for s, n in sites_c.items() if s not in base_sites)
    syncs_l = sum(n for s, n in sites_l.items() if s not in base_sites)
    check(syncs_c <= 1 and syncs_l <= 1 and np.isfinite(loss),
          f"IPPO: {syncs_c} host syncs in a collect {sites_c}, {syncs_l} in a learn {sites_l}")
    # (a profile of one learn, 34,400 launches, costs ~15 s of event processing)
    out.update(collect_syncs=syncs_c, learn_syncs=syncs_l, collect_s=t_collect, learn_s=t_learn,
               ms_per_collect_step=1e3 * t_collect / agent.learn_step)
    log(f"  one collect_rollouts ({agent.learn_step} steps): {t_collect:.3f} s, {syncs_c} host "
        f"syncs; one learn: {t_learn:.3f} s, {syncs_l} host syncs")

    probes = {}
    for env_name, seeds in (("FixedObsPolicyEnvMA", (0,)), ("PolicyEnvMA", (0, 1, 2))):
        t0 = time.perf_counter()
        results = {}
        for seed in seeds:
            probe = getattr(PM, env_name)()
            try:
                PM.check_ma_on_policy_with_probe_env(
                    probe, IPPO, dict(observation_spaces=probe.observation_spaces,
                                      action_spaces=probe.action_spaces,
                                      agent_ids=probe.agent_ids, seed=seed, **IPPO_PROBE),
                    train_iters=50)
                results[seed] = True
                break  # the gate below is decided
            except AssertionError:
                results[seed] = False
        probes[env_name] = dict(results=results, s=time.perf_counter() - t0)
        check(any(results.values()), f"the IPPO probe {env_name} passed on no seed: {results}")
    out["probes"] = probes
    log(f"  IPPO policy probes (FixedObsPolicyEnvMA on seed 0; PolicyEnvMA on the first of "
        f"seeds 0-2 that solves it): {probes}")
    report["multi_agent_on_policy"] = out

    # EvoIPPO, the population as one program
    scan = {"config": EVO_IPPO}
    P = EVO_IPPO["pop"]
    evo = evo_ippo(torch)
    check(evo.device.type == "cuda", f"EvoIPPO put its population on {evo.device}")
    log(f"phase 4o: EvoIPPO through ScanRun on SimpleSpreadTorch({MA_AGENTS}): population {P} "
        f"x {evo.num_envs} envs x {evo.rollout_len} steps, {evo.update_epochs} epochs x "
        f"{evo.num_minibatches} minibatches, latent {EVO_IPPO['latent']}, hidden "
        f"[{EVO_IPPO['hidden']}]")
    run = ScanRun(evo, P, seed=0)
    check({x.device.type for x in tree_leaves(run.pop) if isinstance(x, torch.Tensor)}
          == {"cuda"}, "ScanRun's population left the card")
    ops.reset_kernel_counters()
    (first,), warm_s = host_s(torch, lambda: run.run(EVO_IPPO["warmup"]))
    torch.cuda.reset_peak_memory_stats()
    hist, timed_s = host_s(torch, lambda: run.run(EVO_IPPO["timed"]))
    steps = P * evo.env_steps_per_generation * EVO_IPPO["timed"]
    check(hist.shape == (EVO_IPPO["timed"], P) and bool(np.isfinite(hist).all()),
          f"EvoIPPO fitness history {hist}")
    with SyncGuard(device="cuda", label="4o EvoIPPO generation") as g:
        run.run(1)
    sites = g.sites
    syncs = sum(n for site, n in sites.items() if site not in base_sites)
    check(syncs <= 1, f"EvoIPPO: {syncs} host syncs in one generation {sites}")
    prof = profile_generation(torch, lambda: run.run(1))
    scan_launches = ops.kernel_counters()
    scan.update(warmup_s=warm_s, timed_s=timed_s, env_steps=steps,
                env_steps_per_s=steps / timed_s,
                ms_per_generation=1e3 * timed_s / EVO_IPPO["timed"],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, syncs_per_generation=syncs,
                sync_sites=sites, profile=prof, fitness=run.fitness_history,
                smi=nvidia_smi_line())
    log(f"  {steps} env steps in {timed_s:.3f} s: {steps / timed_s:.0f} env-steps/s, "
        f"{scan['ms_per_generation']:.1f} ms per generation (warm-up {warm_s:.2f} s); peak "
        f"{scan['peak_gb']:.3f} GB; {syncs} host syncs {sites}; one generation under "
        f"torch.profiler {prof}; fitness {[[round(f, 2) for f in g] for g in run.fitness_history]}")

    # a member alone against its slice of the batched iteration
    draws = evo.draw_iteration(P, torch.Generator(device="cuda").manual_seed(11))
    pop = run.pop
    batched, fit = evo.member_iteration(pop, draws)
    p = min(5, P - 1)
    alone, fit1 = evo.member_iteration(member_slice(torch, pop, p),
                                       member_slice(torch, draws, p, dim=1))
    mine = member_slice(torch, batched, p)
    state_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves((alone.obs, alone.ep_ret, alone.env_state)),
                                    tree_leaves((mine.obs, mine.ep_ret, mine.env_state))))
    w_err, exempt = weights_rule(torch, (alone.actor, alone.critic), (mine.actor, mine.critic),
                                 alone.opt_state[0].mu)
    fit_err = float((fit1[0] - fit[p]).abs())
    scan["member_vs_batched"] = dict(fitness_err=fit_err, state_err=state_err, weight_err=w_err,
                                     exempt_share=exempt)
    log(f"  member {p} alone vs its batched slice: {scan['member_vs_batched']}")
    check(fit_err <= POP_MEMBER_ATOL * max(1.0, float(fit[p].abs()))
          and state_err <= POP_MEMBER_ATOL and w_err <= POP_MEMBER_ATOL and exempt < 0.15,
          f"EvoIPPO member {p} alone vs its slice: {scan['member_vs_batched']}")
    evo_ippo_update_card_vs_cpu(torch, evo, pop, draws, scan)
    report["multi_agent_scan"] = scan
    return loop_launches, scan_launches


# ------------------------------- phase 4q ---------------------------------- #
# The evolvable transformers with flash on. EvolvableGPT at llm/presets.py's
# "gpt2-small" (the public GPT-2 small widths: vocab 50,257, 12 layers x 12
# heads, d 768, d_ff 3,072, T 1,024; bf16 blocks, f32 head, random weights
# from seed 0): one forward and backward of next-token cross-entropy on
# 8 x 1,024 seeded tokens (1 warm-up + GPT_TIMED timed steps), then
# add_node, add_layer, remove_node and remove_layer (max_layers 13, so that
# add_layer adds a block), each followed by a step through the kernels, and
# add_expert on an MoE variant (4 experts on every second layer). Each
# mutated model is held to the plain path by phase 4's agreement rule on
# GPT_AGREE_ROWS rows. EvolvableBERT at the Transformer-base widths
# (Vaswani et al. 2017: 6 + 6 layers, d 512, 8 heads, d_ff 2,048, vocab
# 37,000, T 256; f32) forward and backward on 16 x 256, and each mutation.
GPT_BATCH, GPT_T, GPT_TIMED, GPT_AGREE_ROWS = 8, 1024, 3, 2
GPT_MOE = dict(n_experts=4, expert_top_k=2, moe_every=2)
# the wide case: gpt2-small's preset at 2 heads of 256 (d_model 512), node-
# mutated by 32 to head dim 272 (the wide flash kernels, run at 320)
GPT_WIDE, GPT_WIDE_NODES = dict(n_head=2, n_kv_head=2, d_model=512), 32
BERT_BASE = dict(vocab_size=37_000, n_encoder_layers=6, n_decoder_layers=6, n_head=8,
                 d_model=512, d_ff=2_048, max_seq_len=256)
BERT_BATCH = 16
SMALL_GPT = dict(vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=80, max_seq_len=64,
                 use_flash_attention=True)  # head dim 20
SMALL_BERT = dict(vocab_size=97, n_encoder_layers=2, n_decoder_layers=2, n_head=4, d_model=64,
                  max_seq_len=32)


def gpt_loss_and_grads(torch, F, gpt_cls, cfg, params, tokens):
    """Next-token cross-entropy of ``tokens`` and its gradient in every
    parameter (flash forward, dQ and dK/dV on the model's attention)."""
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        logits = gpt_cls.apply(cfg, p, tokens)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1).long())
        grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), grads


def transformer_logprobs(torch, gpt_cls, cfg, params, tokens):
    logits = gpt_cls.apply(cfg, params, tokens)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return lp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]


def gpt_agreement(torch, gpt_cls, cfg, params, tokens):
    """Phase 4's rule on a mutated model: token logprobs through the flash
    kernels no further from an f32 run of the same weights than the plain
    bf16 path's (x1.5 mean, x2 max, + E2E_FLOOR)."""
    kernel = transformer_logprobs(torch, gpt_cls, cfg, params, tokens)
    plain = transformer_logprobs(torch, gpt_cls,
                                 dataclasses.replace(cfg, use_flash_attention=False), params,
                                 tokens)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, use_flash_attention=False)
    params32 = {k: ({i: {n: w.float() for n, w in blk.items()} for i, blk in v.items()}
                    if k == "blocks" else v.float()) for k, v in params.items()}
    exact = transformer_logprobs(torch, gpt_cls, cfg32, params32, tokens)
    d_k, d_p = (kernel - exact).abs(), (plain - exact).abs()
    res = dict(kernel_mean=d_k.mean().item(), kernel_max=d_k.max().item(),
               plain_mean=d_p.mean().item(), plain_max=d_p.max().item())
    ok = (res["kernel_mean"] <= E2E_MEAN_FACTOR * res["plain_mean"] + E2E_FLOOR
          and res["kernel_max"] <= E2E_MAX_FACTOR * res["plain_max"] + E2E_FLOOR)
    return ok, res


def preserved_slabs(torch, old, new):
    """(slabs compared, whether each leaf's overlap with its old self holds
    the old weights bit for bit)."""
    old_f, new_f = flat_params(old), flat_params(new)
    n, same = 0, True
    for path, o in old_f.items():
        w = new_f.get(path)
        if w is None or w.dim() != o.dim():
            continue
        sl = tuple(slice(0, min(a, b)) for a, b in zip(o.shape, w.shape))
        same = same and torch.equal(o[sl], w[sl])
        n += 1
    return n, same


def time_padding(torch, tfa):
    """The flash forward + dQ + dK/dV at gpt2-small's attention shape
    ([8, 12, 1024, d] bf16, causal, no mask) at head dim 64 (built), 68 and
    80 (run zero-padded to 128, the wrappers' copies included) and 128:
    ms per call of the three, in two rounds."""
    g = torch.Generator(device="cuda").manual_seed(21)
    fns = {}
    for d in (64, 68, 80, 128):
        q, k, v = flash_inputs(torch, GPT_BATCH, 12, 12, GPT_T, d, torch.bfloat16, True, g)
        out, lse = tfa.flash_attention_fwd_cuda(q, k, v, None, True)
        dout = torch.randn_like(out)
        dd = (dout.float() * out.float()).sum(-1).contiguous()

        def call(q=q, k=k, v=v, dout=dout, lse=lse, dd=dd):
            tfa.flash_attention_fwd_cuda(q, k, v, None, True)
            tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, None, True)
            tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, None, True)
        fns[f"d{d}"] = call
    rounds = timed_abba(torch, fns, {n: 20 for n in fns})
    return {n: sum(r) / 2 for n, r in rounds.items()}


def small_transformers_card_vs_cpu(torch, F, out):
    """A small f32 GPT (flash on, head dim 20: the f32 kernels run padded to
    64) and a small BERT on the card against the CPU on the same weights:
    logits, and the GPT loss's gradient, within SMALL_MODEL_ATOL of the
    output's scale."""
    from agilerl_tpu_torch.modules.bert import EvolvableBERT
    from agilerl_tpu_torch.modules.gpt import EvolvableGPT
    from agilerl_tpu_torch.utils.tree import tree_map

    gpt = EvolvableGPT(dtype=torch.float32, device="cpu", key=torch.Generator().manual_seed(3),
                       **SMALL_GPT)
    bert = EvolvableBERT(device="cpu", key=torch.Generator().manual_seed(4), **SMALL_BERT)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 97, (3, 48), generator=g)
    src = torch.randint(0, 97, (3, 20), generator=g)
    tgt = torch.randint(0, 97, (3, 12), generator=g)
    res = {}
    for name, model, args in (("gpt", gpt, (tokens,)), ("bert", bert, (src, tgt))):
        cuda = tree_map(lambda t: t.cuda(), model.params)
        got = type(model).apply(model.config, cuda, *(a.cuda() for a in args))
        want = type(model).apply(model.config, model.params, *args)
        res[f"{name}_logits"] = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    _, gg = gpt_loss_and_grads(torch, F, EvolvableGPT, gpt.config,
                               tree_map(lambda t: t.cuda(), gpt.params), tokens.cuda())
    _, gc = gpt_loss_and_grads(torch, F, EvolvableGPT, gpt.config, gpt.params, tokens)
    res["gpt_grads"] = max((a.cpu() - b).abs().max().item() / b.abs().max().clamp(min=1e-30).item()
                           for a, b in zip(gg, gc))
    out["small_card_vs_cpu"] = res
    log(f"  small f32 GPT (head dim 20, flash) and BERT, card vs CPU (max |d| / max |out|): {res}")
    check(all(v <= SMALL_MODEL_ATOL for v in res.values()),
          f"small transformers card vs CPU: {res}")


def wide_gpt_step(torch, F, gpt_cls, tfa, cfg, step, tokens):
    """4q's wide case: an EvolvableGPT with GPT_WIDE node-mutated past head
    dim 256, then one train step through the flash kernels (#1, #3, #4 once
    a layer, the wide kernels) against the plain path (dense attention) of
    the same bf16 weights, both held to an f32 run: the logprob rule of
    gpt_agreement and the gradient rule of phase 4b (relative L2 over every
    parameter, within GRAD_FACTOR x the plain path's + GRAD_FLOOR)."""
    import numpy as np

    gpt = gpt_cls(config=dataclasses.replace(cfg, **GPT_WIDE), key=torch.Generator().manual_seed(6))
    info = gpt.add_node(numb_new_nodes=GPT_WIDE_NODES, rng=np.random.default_rng(0))
    c = gpt.config
    check(c.head_dim > 256, f"4q wide: head dim {c.head_dim} after add_node {info}")
    t0 = time.perf_counter()
    loss, counts, finite = step(gpt)
    step_s = time.perf_counter() - t0
    rows = tokens[:GPT_AGREE_ROWS]
    _, g_kernel = gpt_loss_and_grads(torch, F, gpt_cls, c, gpt.params, rows)
    plain_cfg = dataclasses.replace(c, use_flash_attention=False)
    _, g_plain = gpt_loss_and_grads(torch, F, gpt_cls, plain_cfg, gpt.params, rows)
    cfg32 = dataclasses.replace(plain_cfg, dtype=torch.float32)
    p32 = {k: ({i: {n: w.float() for n, w in blk.items()} for i, blk in v.items()}
               if k == "blocks" else v.float()) for k, v in gpt.params.items()}
    _, g32 = gpt_loss_and_grads(torch, F, gpt_cls, cfg32, p32, rows)

    def rel(grads):
        num = sum(float(((a.float() - b) ** 2).sum()) for a, b in zip(grads, g32))
        return (num / sum(float((b ** 2).sum()) for b in g32)) ** 0.5

    ok, agree = gpt_agreement(torch, gpt_cls, c, gpt.params, rows)
    grads = dict(kernel=rel(g_kernel), plain=rel(g_plain))
    per = {k: v for k, v in counts.items() if v}
    rec = dict(info=info, d_model=c.d_model, head_dim=c.head_dim,
               kernel_head_dim=tfa.flash_head_dim_plan(c.head_dim), loss=loss, step_s=step_s,
               launches=per, agreement=agree, grad_rel_l2=grads)
    log(f"  wide: EvolvableGPT {GPT_WIDE} add_node {info}: d {c.d_model}, head dim {c.head_dim} "
        f"(kernels at {rec['kernel_head_dim']}); step loss {loss:.4f} in {step_s:.3f} s, "
        f"launches {per}; logprobs vs f32 {agree}; gradient rel. L2 to f32 {grads}")
    check(finite and per == {"flash_attention_fwd": c.n_layer, "flash_attention_dq": c.n_layer,
                             "flash_attention_dkv": c.n_layer}, f"4q wide step: {rec}")
    check(ok and grads["kernel"] <= GRAD_FACTOR * grads["plain"] + GRAD_FLOOR,
          f"4q wide step: kernel path against the plain path: {rec}")
    del gpt, g_kernel, g_plain, g32, p32
    torch.cuda.empty_cache()
    return rec


def run_transformers(torch, ops, presets, report):
    """Phase 4q: the evolvable transformers on the card (see the constants
    above). Returns the kernel launches of the GPT steps (the main path)."""
    import numpy as np
    import torch.nn.functional as F

    from agilerl_tpu_torch.modules.bert import EvolvableBERT
    from agilerl_tpu_torch.modules.gpt import EvolvableGPT
    from agilerl_tpu_torch.ops import flash_attention_vjp as tfa
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    out = {}
    launches = {k: 0 for k in ops.kernel_counters()}
    cfg = presets.preset("gpt2-small", remat=False)
    check(cfg.use_flash_attention and cfg.dtype == torch.bfloat16, f"gpt2-small preset: {cfg}")
    gpt = EvolvableGPT(config=cfg, max_layers=13, key=torch.Generator().manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_T), generator=g, device="cuda")
    agree_tokens = tokens[:GPT_AGREE_ROWS]

    def step(model, toks=tokens):
        ops.reset_kernel_counters()
        loss, grads = gpt_loss_and_grads(torch, F, EvolvableGPT, model.config, model.params,
                                         toks)
        torch.cuda.synchronize()
        counts = ops.kernel_counters()
        for k, v in counts.items():
            launches[k] += v
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(x).all()) for x in grads)
        return float(loss), counts, finite

    log(f"phase 4q: EvolvableGPT at gpt2-small ({cfg.n_layer} layers x {cfg.n_head} heads, d "
        f"{cfg.d_model}, head dim {cfg.head_dim}, vocab {cfg.vocab_size}), flash on, bf16 "
        f"blocks; forward + backward of next-token cross-entropy on {GPT_BATCH} x {GPT_T}")
    step(gpt)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(GPT_TIMED):
        loss, counts, finite = step(gpt)
    ms = 1e3 * (time.perf_counter() - t0) / GPT_TIMED
    per = {k: v for k, v in counts.items() if v}
    mfu = gpt.estimate_mfu(GPT_BATCH * GPT_T, ms / 1e3)
    out["gpt2_small"] = dict(ms_per_step=ms, loss=loss, launches_per_step=per,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9, mfu=mfu,
                             params=gpt.param_count())
    log(f"  gpt2-small step: {ms:.2f} ms ({GPT_TIMED} steps, host clock + synchronize), loss "
        f"{loss:.4f}, peak {out['gpt2_small']['peak_gb']:.2f} GB, flash launches per step "
        f"{per}, estimate_mfu at the card's bf16 peak {mfu}")
    check(finite and per == {"flash_attention_fwd": cfg.n_layer, "flash_attention_dq": cfg.n_layer,
                             "flash_attention_dkv": cfg.n_layer},
          f"gpt2-small step: finite {finite}, launches {per}")

    mutations = []
    for name in ("add_node", "add_layer", "remove_node", "remove_layer"):
        old = tree_map(lambda t: t.clone(), gpt.params)
        t0 = time.perf_counter()
        info = getattr(gpt, name)(rng=np.random.default_rng(len(mutations)))
        torch.cuda.synchronize()
        t_mut = time.perf_counter() - t0
        n_slabs, same = preserved_slabs(torch, old, gpt.params)
        del old
        loss, counts, finite = step(gpt)
        ok, agree = gpt_agreement(torch, EvolvableGPT, gpt.config, gpt.params, agree_tokens)
        c = gpt.config
        rec = dict(mutation=name, info=info, n_layer=c.n_layer, d_model=c.d_model,
                   head_dim=c.head_dim, kernel_head_dim=tfa.flash_head_dim_plan(c.head_dim),
                   mutate_s=t_mut, slabs=n_slabs, preserved=same, loss=loss,
                   launches={k: v for k, v in counts.items() if v}, agreement=agree)
        mutations.append(rec)
        log(f"  {name} {info}: {c.n_layer} layers, d {c.d_model}, head dim {c.head_dim} (kernels "
            f"at {rec['kernel_head_dim']}), {t_mut:.2f} s; {n_slabs} slabs preserved bit-equal "
            f"{same}; step loss {loss:.4f}, launches {rec['launches']}; vs f32 {agree}")
        check(same and finite and counts["flash_attention_dq"] == c.n_layer
              and counts["flash_attention_dkv"] == c.n_layer and ok,
              f"gpt2-small after {name}: {rec}")
    del gpt
    torch.cuda.empty_cache()

    moe = EvolvableGPT(config=dataclasses.replace(cfg, **GPT_MOE),
                       key=torch.Generator().manual_seed(1))
    old = tree_map(lambda t: t.clone(), moe.params)
    info = moe.add_expert()
    n_slabs, same = preserved_slabs(torch, old, moe.params)
    del old
    loss, counts, finite = step(moe, tokens[:2])
    ok, agree = gpt_agreement(torch, EvolvableGPT, moe.config, moe.params, agree_tokens)
    rec = dict(mutation="add_expert", info=info, n_experts=moe.config.n_experts, slabs=n_slabs,
               preserved=same, loss=loss, launches={k: v for k, v in counts.items() if v},
               agreement=agree)
    mutations.append(rec)
    log(f"  MoE variant {GPT_MOE} add_expert: {rec}")
    check(same and finite and counts["flash_attention_dkv"] == moe.config.n_layer and ok,
          f"MoE add_expert: {rec}")
    out["mutations"] = mutations
    del moe
    torch.cuda.empty_cache()
    out["wide"] = wide_gpt_step(torch, F, EvolvableGPT, tfa, cfg, step, tokens)

    out["padding_ms"] = time_padding(torch, tfa)
    log(f"  flash forward + dQ + dK/dV at [8, 12, 1024, d] bf16 causal, ms per call by head dim "
        f"(68 and 80 run padded to 128): {out['padding_ms']}")

    bert = EvolvableBERT(key=torch.Generator().manual_seed(2), **BERT_BASE)
    src = torch.randint(0, BERT_BASE["vocab_size"], (BERT_BATCH, BERT_BASE["max_seq_len"]),
                        generator=g, device="cuda")
    tgt = torch.randint(0, BERT_BASE["vocab_size"], (BERT_BATCH, BERT_BASE["max_seq_len"]),
                        generator=g, device="cuda")

    def bert_step():
        p = tree_map(lambda t: t.detach().requires_grad_(True), bert.params)
        with torch.enable_grad():
            logits = EvolvableBERT.apply(bert.config, p, src, tgt=tgt)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1))
            grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        return float(loss), all(bool(torch.isfinite(x).all()) for x in grads)

    bert_step()
    t0 = time.perf_counter()
    for _ in range(GPT_TIMED):
        loss, finite = bert_step()
    bert_ms = 1e3 * (time.perf_counter() - t0) / GPT_TIMED
    bert_muts = []
    for i, name in enumerate(("add_layer", "add_node", "remove_node", "remove_layer")):
        old = tree_map(lambda t: t.clone(), bert.params)
        info = getattr(bert, name)(rng=np.random.default_rng(10 + i))
        n_slabs, same = preserved_slabs(torch, old, bert.params)
        del old
        m_loss, m_finite = bert_step()
        c = bert.config
        bert_muts.append(dict(mutation=name, info=info, layers=[c.n_encoder_layers,
                                                                c.n_decoder_layers],
                              d_model=c.d_model, slabs=n_slabs, preserved=same, loss=m_loss))
        check(same and m_finite, f"EvolvableBERT after {name}: {bert_muts[-1]}")
    out["bert_base"] = dict(ms_per_step=bert_ms, loss=loss, params=bert.param_count(),
                            mutations=bert_muts)
    log(f"  EvolvableBERT Transformer-base, {BERT_BATCH} x {BERT_BASE['max_seq_len']} f32: "
        f"forward + backward {bert_ms:.2f} ms, loss {loss:.4f}; mutations {bert_muts}")
    check(finite, "EvolvableBERT step not finite")
    del bert
    torch.cuda.empty_cache()
    small_transformers_card_vs_cpu(torch, F, out)
    out["launches"] = dict(launches)
    report["evolvable_gpt"] = out
    return launches


# ------------------------------- phase 4p ---------------------------------- #
# configs/training/bandit/neural_ucb.yaml and neural_ts.yaml at their widths
# on their BANDIT_DATASET, iris (tests/fixtures/iris/iris.csv: 150 x 4, 3
# classes, so 3 arms of 12-wide contexts): population 4, batch 64, lr 1e-3,
# lambda 1, reg 6.25e-4, learn_step 2, a 10,000-row buffer, latent 32,
# hidden [64], tournament 2 with elitism, the yamls' mutation
# probabilities. Cuts, for time: evo_steps 1,000 -> 125 and max_steps
# 10,000 -> 250 (2 generations, so that mutated clones learn; at 250 / 500
# the NeuralUCB loop alone took 29.6 s on an H100 80GB HBM3 at 700 W).
BANDIT_HP = {"POP_SIZE": 4, "BATCH_SIZE": 64, "LR": 1e-3, "LAMBDA": 1.0, "REG": 0.000625,
             "LEARN_STEP": 2}
BANDIT_NET = {"latent_dim": 32, "encoder_config": {"hidden_size": (64,)}}
BANDIT_MUTATION = dict(no_mutation=0.4, architecture=0.2, parameters=0.2, activation=0.0,
                       rl_hp=0.2, mutation_sd=0.1)
BANDIT_MEMORY = 10_000
BANDIT_EVO_STEPS = 125  # cut from 1,000
BANDIT_MAX_STEPS = 250  # cut from 10,000
BANDIT_GATE = 0.6  # best final fitness (random pulls score 1/3)
BANDIT_RTOL = 1e-5
IRIS = Path(__file__).resolve().parent / "tests" / "fixtures" / "iris" / "iris.csv"


def bandits_card_vs_cpu(torch, env, out):
    """NeuralUCB and NeuralTS (on the same normal draws) on the card against
    the CPU at carried weights: three pulls (the arms, U) and one learn (the
    loss, the weights by phase 4k's rule), rtol 1e-5."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy
    from agilerl_tpu_torch.algorithms.neural_ts_bandit import NeuralTS
    from agilerl_tpu_torch.algorithms.neural_ucb_bandit import NeuralUCB
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_to_numpy

    res = {}
    for name, cls in (("NeuralUCB", NeuralUCB), ("NeuralTS", NeuralTS)):
        agents = {dev: cls(env.observation_space, env.action_space, net_config=BANDIT_NET,
                           lamb=1.0, reg=BANDIT_HP["REG"], seed=3, device=dev)
                  for dev in ("cuda", "cpu")}
        load_params_from_numpy(agents["cuda"], {"actor": tree_to_numpy(agents["cpu"].actor.params)})
        agents["cuda"]._reinit_bandit_grads()
        rng = np.random.default_rng(5)
        arms, u_err = {"cuda": [], "cpu": []}, 0.0
        for _ in range(3):
            ctx = env._context(int(rng.integers(0, env.num_samples)))
            draws = rng.normal(size=env.arms).astype(np.float32)
            for dev, agent in agents.items():
                kw = {"draws": draws} if name == "NeuralTS" else {}
                arms[dev].append(int(agent.get_action(ctx, **kw)))
            u_err = max([u_err] + [float((a.cpu() - b).abs().max() / b.abs().max())
                                   for a, b in zip(tree_leaves(agents["cuda"].U),
                                                   tree_leaves(agents["cpu"].U))])
        batch = {"obs": rng.normal(size=(64, env.context_dim)).astype(np.float32),
                 "reward": rng.integers(0, 2, 64).astype(np.float32)}
        losses = {dev: agent.learn(batch) for dev, agent in agents.items()}
        mu = agents["cpu"].optimizer.opt_state.inner_state[0].mu
        w_err, exempt = weights_rule(torch, agents["cuda"].actor.params,
                                     agents["cpu"].actor.params, mu)
        loss_err = abs(losses["cuda"] - losses["cpu"]) / max(abs(losses["cpu"]), 1e-12)
        res[name] = dict(arms=arms, u_rel_err=u_err, loss_rel_err=loss_err, weight_err=w_err,
                         exempt_share=exempt)
        check(arms["cuda"] == arms["cpu"] and u_err <= BANDIT_RTOL and loss_err <= BANDIT_RTOL
              and w_err <= BANDIT_RTOL and exempt < 0.15, f"{name} card vs CPU: {res[name]}")
    out["card_vs_cpu"] = res
    log(f"  card vs CPU: {res}")


def run_bandits(torch, ops, report):
    """Phase 4p: NeuralUCB and NeuralTS through train_bandits on iris (see
    the constants above): pulls/s, the parts of each generation, fitnesses
    and the learning gate; ms, launches and host syncs of one pull and one
    learn; card vs CPU. Returns the kernel launches of the loops."""
    import numpy as np

    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.training.train_bandits import train_bandits
    from agilerl_tpu_torch.utils.utils import create_population
    from agilerl_tpu_torch.wrappers.learning import BanditEnv

    data = np.loadtxt(IRIS, delimiter=",", skiprows=1)
    check(data.shape == (150, 5), f"iris fixture shape {data.shape}")
    env = BanditEnv(data[:, :4], data[:, 4].astype(np.int64))
    out = {"env": dict(samples=env.num_samples, arms=env.arms, context_dim=env.context_dim)}
    launches = {k: 0 for k in ops.kernel_counters()}
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    for algo in ("NeuralUCB", "NeuralTS"):
        log(f"phase 4p: train_bandits, {algo} on iris ({env.num_samples} x {env.dim}, "
            f"{env.arms} arms): population {BANDIT_HP['POP_SIZE']}, batch "
            f"{BANDIT_HP['BATCH_SIZE']}, buffer {BANDIT_MEMORY}, evo_steps {BANDIT_EVO_STEPS}, "
            f"max_steps {BANDIT_MAX_STEPS} (cut from 1,000 / 10,000)")
        np.random.seed(0)
        pop = create_population(algo, env.observation_space, env.action_space, BANDIT_NET,
                                BANDIT_HP, seed=0)
        check(all(a.dev.type == "cuda" for a in pop), "create_population left the card")
        sink = MemorySink()
        telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
        ops.reset_kernel_counters()
        (pop, fitnesses), t_loop = host_s(torch, lambda: train_bandits(
            env, "iris", algo, pop, ReplayBuffer(BANDIT_MEMORY, seed=0), INIT_HP=BANDIT_HP,
            max_steps=BANDIT_MAX_STEPS, evo_steps=BANDIT_EVO_STEPS,
            tournament=TournamentSelection(2, True, BANDIT_HP["POP_SIZE"], 1,
                                           rng=np.random.default_rng(0)),
            mutation=Mutations(**BANDIT_MUTATION, rand_seed=0), telemetry=telem,
            verbose=False))
        for k, v in ops.kernel_counters().items():
            launches[k] += v
        gens = [e for e in sink.events if e["kind"] == "generation"]
        pulls = sum(g["pulls"] for g in gens)
        best = max(f[-1] for f in fitnesses)
        rec = dict(loop_s=t_loop, pulls=pulls, pulls_per_s=pulls / t_loop,
                   fitness=fitnesses, best_final_fitness=best,
                   generations=[{k: g[k] for k in ("generation", "act_s", "learn_s", "eval_s",
                                                   "evo_s", "learn_calls", "fitness",
                                                   "mutations")} for g in gens])
        for gen in gens:
            log(f"  {algo} generation {gen['generation']}: pulls {gen['act_s']:.2f} s, learns "
                f"{gen['learn_s']:.2f} s ({gen['learn_calls']} calls), eval {gen['eval_s']:.2f} "
                f"s, tournament + mutation {gen['evo_s']:.3f} s; fitness "
                f"{[round(f, 3) for f in gen['fitness']]}; mutations {gen['mutations']}")
        log(f"  {algo}: {pulls} pulls in {t_loop:.1f} s ({pulls / t_loop:.0f} pulls/s); best "
            f"final fitness {best:.3f} (gate {BANDIT_GATE})")
        check(len(gens) == BANDIT_MAX_STEPS // BANDIT_EVO_STEPS and best >= BANDIT_GATE,
              f"{algo}: {len(gens)} generations, fitnesses {fitnesses}")

        agent = pop[0]
        ctx = env.reset()
        memory = ReplayBuffer(256, seed=1)
        for _ in range(128):
            arm = agent.get_action(ctx)
            nxt, r = env.step(arm)
            memory.add({"obs": ctx[int(arm)], "reward": r})
            ctx = nxt
        learn = lambda: agent.learn(memory.sample(agent.batch_size))  # noqa: E731
        for what, fn in (("pull", lambda: agent.get_action(ctx)), ("learn", learn)):
            with SyncGuard(device="cuda", label=f"4p {what}") as g:
                fn()
            sites = g.sites
            syncs = sum(n for site, n in sites.items() if site not in base_sites)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(30):
                fn()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 30
            prof = profile_generation(torch, fn)
            rec[what] = dict(syncs=syncs, sync_sites=sites, ms=ms, profile=prof)
            log(f"  {algo} {what}: {syncs} host syncs {sites}, {ms:.2f} ms per call (30 calls), "
                f"under torch.profiler {prof}")
            # a pull uploads the host env's context and reads the arm back
            check(syncs <= (2 if what == "pull" else 1), f"{algo}: {syncs} host syncs in one "
                  f"{what}")
        out[algo] = rec
    bandits_card_vs_cpu(torch, env, out)
    out["launches"] = dict(launches)
    report["bandits"] = out
    return launches


# ------------------------------- phase 4r ---------------------------------- #
# The PettingZoo path: a parallel-API env over one CPU SimpleSpreadTorch(2)
# (numpy in, numpy out; agents empty at the episode's end), vectorised by
# make_multi_agent_vect_envs in worker processes and in this one, 8 envs;
# MADDPG through train_multi_agent_off_policy at 4n's maddpg.yaml widths,
# evo_steps 120 and max_steps 240 (cut from 10,000 / 100,000: 2
# generations; at 200 / 400 the phase took 28.5-34.8 s on an H100 80GB HBM3
# at 700 W); then AsyncAgentsWrapper and RSNorm over 2 envs in this process
# whose second agent dies mid-episode.
PZ_ENVS = 8
PZ_EVO_STEPS = 120  # cut from 10,000
PZ_MAX_STEPS = 240  # cut from 100,000
PZ_WRAPPER_STEPS = 12


class SpreadParallelEnv:
    """A PettingZoo parallel env over one SimpleSpreadTorch(2) on the CPU;
    with ``die_at``, agent_1 leaves the dicts from that step to the end of
    the episode. Module-level, so spawned workers can unpickle it."""

    def __init__(self, die_at=None, seed=0):
        import torch

        from agilerl_tpu_torch.envs.multi_agent import SimpleSpreadTorch

        self._env = SimpleSpreadTorch(2)
        self.possible_agents = list(self._env.agent_ids)
        self.agents = []
        self.die_at = die_at
        self._gen = torch.Generator().manual_seed(seed)
        self._state = None

    def observation_space(self, agent):
        return self._env.observation_spaces[agent]

    def action_space(self, agent):
        return self._env.action_spaces[agent]

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._gen.manual_seed(seed)
        self._state, obs = self._env.reset_fn(1, self._gen)
        self.agents = list(self.possible_agents)
        return {a: o[0].numpy() for a, o in obs.items()}, {}

    def step(self, actions):
        import torch

        acts = {a: torch.as_tensor([int(actions.get(a, 0))]) for a in self.possible_agents}
        self._state, obs, rew, term, trunc = self._env.step_fn(self._state, acts)
        if self.die_at is not None and int(self._state.t[0]) >= self.die_at:
            self.agents = [a for a in self.agents if a != "agent_1"]
        alive = self.agents
        out = ({a: obs[a][0].numpy() for a in alive}, {a: float(rew[a][0]) for a in alive},
               {a: bool(term[a][0]) for a in alive}, {a: bool(trunc[a][0]) for a in alive}, {})
        if bool(trunc[self.possible_agents[0]][0]):
            self.agents = []
        return out

    def close(self):
        pass


def run_pettingzoo(torch, ops, report):
    """Phase 4r (see the constants above): env-steps/s of MADDPG's loop on
    the sync and the async PettingZoo vector envs, the host syncs of a
    vector step, the async workers' start-up seconds; AsyncAgentsWrapper and
    RSNorm over a dying agent. Returns the kernel launches of the loops."""
    import numpy as np

    from agilerl_tpu_torch.analysis import SyncGuard
    from agilerl_tpu_torch.components.multi_agent_replay_buffer import MultiAgentReplayBuffer
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.training.train_multi_agent_off_policy import (
        train_multi_agent_off_policy,
    )
    from agilerl_tpu_torch.utils.utils import create_population, make_multi_agent_vect_envs
    from agilerl_tpu_torch.wrappers import AsyncAgentsWrapper, RSNorm

    out = {}
    launches = {k: 0 for k in ops.kernel_counters()}
    with SyncGuard(device="cuda") as g:
        pass
    base_sites = g.sites
    for mode in (False, True):
        name = "async" if mode else "sync"
        t0 = time.perf_counter()
        env = make_multi_agent_vect_envs(SpreadParallelEnv, num_envs=PZ_ENVS,
                                         should_async_vector=mode)
        try:
            env.reset(seed=0)
            start_s = time.perf_counter() - t0
            log(f"phase 4r: train_multi_agent_off_policy, MADDPG on the {name} PettingZoo vector "
                f"env ({PZ_ENVS} x SimpleSpreadTorch(2) on the CPU; started in {start_s:.2f} s): "
                f"population {MADDPG_HP['POP_SIZE']}, evo_steps {PZ_EVO_STEPS}, max_steps "
                f"{PZ_MAX_STEPS} (cut from 10,000 / 100,000)")
            np.random.seed(0)
            pop = create_population("MADDPG", env.observation_spaces, env.action_spaces, MA_NET,
                                    MADDPG_HP, seed=0, agent_ids=env.agent_ids)
            memory = MultiAgentReplayBuffer(MA_MEMORY, env.agent_ids)
            sink = MemorySink()
            telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
            ops.reset_kernel_counters()
            (pop, fitnesses), t_loop = host_s(torch, lambda: train_multi_agent_off_policy(
                env, "simple_spread_pz", "MADDPG", pop, memory, INIT_HP=MADDPG_HP,
                max_steps=PZ_MAX_STEPS, evo_steps=PZ_EVO_STEPS,
                tournament=TournamentSelection(2, True, MADDPG_HP["POP_SIZE"], 1,
                                               rng=np.random.default_rng(0)),
                mutation=Mutations(**MA_MUTATION, rand_seed=0), telemetry=telem,
                verbose=False, seed=0))
            for k, v in ops.kernel_counters().items():
                launches[k] += v
            gens = [e for e in sink.events if e["kind"] == "generation"]
            env_steps = gens[-1]["total_steps"]
            check(len(gens) == PZ_MAX_STEPS // PZ_EVO_STEPS and len(memory) == env_steps
                  and all(np.isfinite(f).all() for f in fitnesses)
                  and all(g["learn_calls"] > 0 for g in gens),
                  f"MADDPG on the {name} PettingZoo env: {len(gens)} generations, {fitnesses}")
            agent = pop[0]
            obs, _ = env.reset(seed=1)

            def vector_step():
                acts = agent.get_action(obs)
                return env.step({a: v.cpu().numpy() for a, v in acts.items()})

            with SyncGuard(device="cuda", label=f"4r {name} vector step") as g:
                vector_step()
            sites = g.sites
            syncs = sum(n for site, n in sites.items() if site not in base_sites)
            out[name] = dict(start_s=start_s, loop_s=t_loop, env_steps=env_steps,
                             env_steps_per_s=env_steps / t_loop, syncs_per_vector_step=syncs,
                             sync_sites=sites,
                             generations=[{k: g[k] for k in ("generation", "act_s", "learn_s",
                                                             "eval_s", "evo_s", "learn_calls",
                                                             "fitness")} for g in gens])
            log(f"  MADDPG on the {name} env: {env_steps} env steps in {t_loop:.1f} s "
                f"({env_steps / t_loop:.0f} env-steps/s); {syncs} host syncs per vector step "
                f"{sites}; generations {out[name]['generations']}")
        finally:
            env.close()
        if mode:
            check(not any(p.is_alive() for p in env._procs), "async env workers outlive close")

    # a dying agent through both wrappers (the vector env in this process:
    # the async one's start-up is timed above)
    env = make_multi_agent_vect_envs(SpreadParallelEnv, num_envs=2, should_async_vector=False,
                                     die_at=3)
    try:
        wrapped = AsyncAgentsWrapper(RSNorm(pop[0]))
        obs, _ = env.reset(seed=2)
        closed, nan_rows = 0, 0
        for _ in range(PZ_WRAPPER_STEPS):
            nan_rows += int(np.isnan(obs["agent_1"]).all(axis=1).sum())
            acts = wrapped.get_action(obs)
            obs, rew, term, trunc, info = env.step(
                {a: np.nan_to_num(np.asarray(v, np.float64)).astype(np.int64)
                 for a, v in acts.items()})
            closed += len(wrapped.record_step(obs, acts, rew, term))
        rms = wrapped.agent.obs_rms["agent_0"]
        out["wrappers"] = dict(steps=PZ_WRAPPER_STEPS, nan_rows_seen=nan_rows,
                               transitions_closed=closed, rms_count=rms.count,
                               stats=type(rms.mean).__name__)
        log(f"  AsyncAgentsWrapper(RSNorm(MADDPG)) over 2 envs whose agent_1 dies at step 3: "
            f"{out['wrappers']}")
        check(nan_rows > 0 and closed > 0 and rms.count > 1, f"wrappers: {out['wrappers']}")
    finally:
        env.close()
    out["launches"] = dict(launches)
    report["pettingzoo"] = out
    return launches


# ------------------------------- phase 4s ---------------------------------- #
# Slice 6's resilience facade on the card.
# (a) GRPO through finetune_llm_reasoning with resilience= at llama3-8b (the
# public Llama-3-8B dims at full width and depth, bf16 blocks, f32 head, the
# char vocab of 4c's arithmetic ReasoningGym recipe, LoRA rank 8 on wq/wv,
# random weights from seed 1): population 2 sharing one base, data batch 2,
# group 4, 16 new tokens, beta 0.04, evaluation_interval 2 with a tournament
# and RL-HP mutation, a test split of 2 rows. Run A: 3 steps. Run B: the
# same, with a real SIGTERM sent to this process during step 2
# (handle_signals=True): it ends cleanly with one preempt snapshot at step
# 2. Run C: a fresh population from the same seeds resumes it. C equals A:
# completions token for token, losses, rewards and fitnesses, actor and
# reference adapters and Adam moments bit for bit.
RES_STEPS = 3  # 4 until phase 4t came
RES_PREEMPT_STEP = 2
RES_PROMPTS = 2
RES_NEW_TOKENS = 16
RES_EVAL_ROWS = 2
# (b) train_off_policy DQN at dqn.yaml's widths (16 envs, batch 64, lr 1e-3,
# learn_step 4, tau 0.01, double, a 20,000-row buffer, latent 32, hidden
# [64]) on the device CartPole, population 2, evo_steps 512 and max_steps
# 1,536 (cut from 10,000 / 200,000: 3 generations, a snapshot at each
# boundary): the FaultInjector crashes the second snapshot's commit; the
# resume comes from the first complete one
RES_DQN_HP = {"POP_SIZE": 2, "BATCH_SIZE": 64, "LR": 1e-3, "GAMMA": 0.99, "LEARN_STEP": 4,
              "TAU": 0.01, "DOUBLE": True, "NUM_ENVS": 16}
RES_DQN_NET = {"latent_dim": 32, "encoder_config": {"hidden_size": (64,)}}
RES_DQN_MEMORY = 20_000
RES_DQN_EVO = 512
RES_DQN_MAX = 1_536
RES_DQN_EVAL = 200
# (c) ScanRun(EvoPPO) at 4i's widths: a snapshot after 1 generation, resumed
# into a run of another seed, 2 generations bit-equal. (d) MakeEvolvable of
# a torch.nn MLP and CNN on the card against the module (f32, TF32 off)
MAKE_EVOLVABLE_ATOL = 1e-5


class RecordingGym:
    """A ReasoningGym proxy that keeps every training step's and eval's
    completion ids and rewards, and sends SIGTERM to this process after
    its ``sigterm_after``-th training step (the owning env's state_dict is
    what a snapshot captures: the proxy forwards every other attribute)."""

    def __init__(self, env, sigterm_after=None):
        self.env = env
        self.sigterm_after = sigterm_after
        self.steps = 0
        self.completions = []
        self.rewards = []
        self.last_batch = None

    def _keep(self, completion_ids, rewards):
        import numpy as np

        self.completions.append(np.array(completion_ids, copy=True))
        self.rewards.append(np.array(rewards, copy=True))

    def step(self, completion_ids, completion_mask):
        import os
        import signal

        out = self.env.step(completion_ids, completion_mask)
        self._keep(completion_ids, out[1])
        self.steps += 1
        if self.steps == self.sigterm_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    def step_eval(self, completion_ids, completion_mask):
        out = self.env.step_eval(completion_ids, completion_mask)
        self._keep(completion_ids, out[1])
        return out

    def assemble_learn_batch(self, completion_ids, completion_mask):
        self.last_batch = self.env.assemble_learn_batch(completion_ids, completion_mask)
        return self.last_batch

    def __getattr__(self, name):
        return getattr(self.env, name)


def leaves_equal(torch, a, b):
    from agilerl_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y) for x, y in zip(la, lb))


def max_abs_diff(torch, a, b):
    from agilerl_tpu_torch.utils.tree import tree_leaves

    return max((float((x.double() - y.double()).abs().max()) for x, y in
                zip(tree_leaves(a), tree_leaves(b)) if isinstance(x, torch.Tensor)), default=0.0)


def kernel_repeats(torch, tfa, tfl, cfg, base, ids, mask, loss_mask):
    """Each learn kernel called twice on the same inputs at phase 4s's learn
    shapes (the fused forward and dH on the batch's hidden states against
    the head; the bf16 flash forward, dQ and dK/dV on seeded q/k/v in the
    model's strided views under the batch's mask): True where the two
    outputs are bit-identical."""
    from agilerl_tpu_torch.llm import model as M

    g = torch.Generator(device="cuda").manual_seed(43)
    B, T = ids.shape
    head = M._head(cfg, base).float().contiguous()
    with torch.no_grad():
        hidden, _ = M.forward(cfg, base, ids, attention_mask=mask, flash=True)
    h = hidden[:, :-1].reshape(-1, hidden.shape[-1]).float().contiguous()
    t = ids[:, 1:].reshape(-1)
    _, lse = tfl.fused_logprob_fwd_cuda(h, head, t)
    up = (torch.randn(B, 1, device="cuda", generator=g) * loss_mask).reshape(-1).contiguous()
    q, k, v = flash_inputs(torch, B, cfg.n_head, cfg.kv_heads, T, cfg.head_dim, torch.bfloat16,
                           True, g)
    out, flse = tfa.flash_attention_fwd_cuda(q, k, v, mask, True)
    dout = torch.randn(B, T, cfg.n_head, cfg.head_dim, device="cuda",
                       generator=g).to(torch.bfloat16).transpose(1, 2)
    dd = (dout.float() * out.float()).sum(-1).contiguous()
    calls = {
        "fused_logprob_fwd": lambda: tfl.fused_logprob_fwd_cuda(h, head, t),
        "fused_logprob_dh": lambda: tfl.fused_logprob_dh_cuda(h, head, t, lse, up),
        "flash_attention_fwd": lambda: tfa.flash_attention_fwd_cuda(q, k, v, mask, True),
        "flash_attention_dq": lambda: tfa.flash_attention_dq_cuda(q, k, v, dout, flse, dd, mask,
                                                                  True),
        "flash_attention_dkv": lambda: tfa.flash_attention_dkv_cuda(q, k, v, dout, flse, dd,
                                                                    mask, True),
    }
    return {name: leaves_equal(torch, fn(), fn()) for name, fn in calls.items()}


def run_resilience(torch, ops, tfa, tfl, presets, report):
    """Phase 4s (see the constants above). Returns the kernel launches of
    (a), the GRPO runs A, B and C."""
    import pickle
    import random
    import signal
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
    from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
    from agilerl_tpu_torch.llm import model as M
    from agilerl_tpu_torch.observability.events import MemorySink
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.parallel import ScanRun
    from agilerl_tpu_torch.resilience import (
        FaultInjector,
        InjectedCrash,
        Resilience,
        base_fingerprint,
    )
    from agilerl_tpu_torch.training.train_llm import finetune_llm_reasoning
    from agilerl_tpu_torch.training.train_off_policy import train_off_policy
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym
    from agilerl_tpu_torch.utils.tree import tree_leaves
    from agilerl_tpu_torch.utils.utils import create_population, make_vect_envs

    out = {}
    workdir = Path(tempfile.mkdtemp(prefix="phase4s_"))

    # ---- (a) GRPO at llama3-8b, preempted by SIGTERM and resumed ----
    tok = CharTokenizer()
    cfg = presets.preset("llama3-8b", vocab_size=tok.vocab_size, max_seq_len=256, remat=False)
    torch.cuda.reset_peak_memory_stats()
    base, t_init = host_s(torch, lambda: M.init_params(1, cfg))
    base_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(base))
    log(f"phase 4s: GRPO through finetune_llm_reasoning with resilience= at llama3-8b: "
        f"{cfg.n_layer} layers, d_model {cfg.d_model}, char vocab {cfg.vocab_size}; "
        f"{sum(t.numel() for t in tree_leaves(base)) / 1e9:.3f}B base parameters "
        f"({base_bytes / 1e9:.2f} GB) in {t_init:.1f} s; population 2, data batch "
        f"{RES_PROMPTS}, group {GROUP_SIZE}, {RES_NEW_TOKENS} new tokens, {RES_STEPS} steps, "
        f"eval every 2, SIGTERM during step {RES_PREEMPT_STEP}")

    def make():
        np.random.seed(0)
        random.seed(0)
        env = ReasoningGym(arith_rows(64, 0), arith_rows(RES_EVAL_ROWS, 1), tok,
                           reward_fn=arith_reward, data_batch_size=RES_PROMPTS, seed=3)
        pop = create_population("GRPO", population_size=2, seed=0, config=cfg,
                                base_params=base, pad_token_id=tok.pad_token_id,
                                eos_token_id=tok.eos_token_id, group_size=GROUP_SIZE,
                                batch_size=RES_PROMPTS * GROUP_SIZE,
                                max_output_tokens=RES_NEW_TOKENS, lora_rank=LORA_RANK)
        return env, pop

    def go(env, pop, res, resume=False):
        sink = MemorySink()
        telem = RunTelemetry(registry=MetricsRegistry(sink=sink))
        try:
            (new_pop, fit), t = host_s(torch, lambda: finetune_llm_reasoning(
                pop, env, max_steps=RES_STEPS, evaluation_interval=2, verbose=False,
                tournament=TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0)),
                mutation=Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0,
                                   activation=0.0, rl_hp=0.5, rand_seed=0),
                telemetry=telem, resilience=res, resume=resume))
        finally:
            telem.close()
        losses = [e["train/loss"] for e in sink.events if "train/loss" in e]
        mfu = [e["mfu"] for e in sink.events if e["kind"] == "step" and "mfu" in e]
        return new_pop, fit, losses, mfu, telem.registry, t

    def state(pop):
        return [(a.actor.params, a.reference.params, a.optimizer.opt_state,
                 a._reference_epoch, a.index, a.mut, a.lr, a.beta, a.group_size) for a in pop]

    ops.reset_kernel_counters()
    env, pop = make()
    env_a = RecordingGym(env)
    pop_a, fit_a, loss_a, mfu_a, _, t_a = go(env_a, pop, Resilience(
        workdir / "a", handle_signals=False))
    log(f"  run A: {RES_STEPS} steps in {t_a:.1f} s; losses {loss_a}; fitnesses {fit_a}; "
        f"MFU per step {mfu_a}")
    check(len(mfu_a) > 0 and all(m > 0 for m in mfu_a), "run A's telemetry emitted no MFU")

    env, pop = make()
    env_b = RecordingGym(env, sigterm_after=2 * RES_PREEMPT_STEP)
    res_b = Resilience(workdir / "b", handle_signals=True)
    handler_before = signal.getsignal(signal.SIGTERM)
    _, fit_b, loss_b, _, reg_b, t_b = go(env_b, pop, res_b)
    snaps = res_b.manager.snapshots()
    check([(s.kind, s.step) for s in snaps] == [("preempt", RES_PREEMPT_STEP)],
          f"run B: snapshots {[(s.kind, s.step) for s in snaps]}, not one preempt at step "
          f"{RES_PREEMPT_STEP}")
    check(signal.getsignal(signal.SIGTERM) == handler_before,
          "run B left its SIGTERM handler installed")
    info = snaps[0]
    save_s = reg_b.gauge("resilience/snapshot_time_s").value
    with open(info.path / "population.pkl", "rb") as f:
        saved = pickle.load(f)
    no_base = all(b["ckpt"]["init_dict"]["base_params"] is None for b in saved) and all(
        b["base_fingerprint"] == base_fingerprint(base) for b in saved)
    # per agent: actor, reference and Adam's m and v, each an adapter's size
    adapter_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(pop[0].actor.params))
    expected = 2 * 4 * adapter_bytes
    check(no_base and info.nbytes < expected + 2 ** 20,
          f"the snapshot holds more than the adapters and moments ({info.nbytes} bytes on "
          f"disk, {expected} expected)")
    log(f"  run B: SIGTERM after training step {env_b.steps} of {2 * RES_STEPS}; stopped "
        f"cleanly after {t_b:.1f} s with one preempt snapshot at step {info.step}: "
        f"{info.nbytes / 1e6:.2f} MB on disk (adapters and moments {expected / 1e6:.2f} MB; "
        f"the base alone {base_bytes / 1e9:.2f} GB), "
        f"saved in {save_s:.3f} s; entries {sorted(info.manifest['entries'])}")

    env, pop = make()
    env_c = RecordingGym(env)
    res_c = Resilience(workdir / "b", handle_signals=False)
    resume_s = []
    resume = res_c.resume

    def timed_resume(*a, **kw):
        t0 = time.perf_counter()
        try:
            return resume(*a, **kw)
        finally:
            resume_s.append(time.perf_counter() - t0)

    res_c.resume = timed_resume
    pop_c, fit_c, loss_c, _, _, t_c = go(env_c, pop, res_c, resume=True)
    launches = ops.kernel_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  run C: resumed in {resume_s[0]:.3f} s, {RES_STEPS - RES_PREEMPT_STEP} steps in "
        f"{t_c:.1f} s; losses {loss_c}; fitnesses {fit_c}; launches over A, B, C {launches}; "
        f"peak {peak_gb:.1f} GB")
    comp_equal = (len(env_a.completions) == len(env_b.completions) + len(env_c.completions)
                  and all(np.array_equal(x, y) for x, y in
                          zip(env_a.completions, env_b.completions + env_c.completions)))
    rew_equal = all(np.array_equal(x, y) for x, y in
                    zip(env_a.rewards, env_b.rewards + env_c.rewards))
    equal = dict(completions=comp_equal, rewards=rew_equal,
                 losses=loss_a == loss_b + loss_c, fitnesses=fit_a == fit_c,
                 adapters_and_moments=leaves_equal(torch, state(pop_a), state(pop_c)))
    # each kernel against its plain version at this path's learn shapes (the
    # last learn batch of run C), and twice on the same inputs
    ids, mask, loss_mask = pop_c[0]._learn_masks(*env_c.last_batch, None)
    worst = check_learn_kernels(torch, M, tfa, tfl, cfg, base, pop_c[0].actor.params,
                                [("grpo", ids, mask, loss_mask)], "phase 4s")
    repeats = kernel_repeats(torch, tfa, tfl, cfg, base, ids, mask, loss_mask)
    diff = max_abs_diff(torch, state(pop_a), state(pop_c))
    log(f"  run C against run A: {equal}; max |C - A| over adapters and moments {diff:.3g}; "
        f"each learn kernel repeats bit for bit: {repeats}")
    if not all(equal.values()):
        check(not all(repeats.values()), f"run C is not run A ({equal}) and every kernel repeats "
              "bit for bit: the fault is outside the kernels")
        fail(f"run C is not run A ({equal}); kernels that do not repeat bit for bit: "
             f"{[k for k, ok in repeats.items() if not ok]}")
    check(all(launches[k] > 0 for k in launches if k != "fused_logprob_dw"),
          f"phase 4s (a) missed a kernel: {launches}")
    out["grpo"] = dict(layers=cfg.n_layer, vocab=cfg.vocab_size, base_gb=base_bytes / 1e9,
                       init_s=t_init, run_a_s=t_a, run_b_s=t_b, run_c_s=t_c,
                       snapshot_bytes=info.nbytes, adapter_moment_bytes=expected,
                       snapshot_save_s=save_s,
                       resume_s=resume_s[0], entries=sorted(info.manifest["entries"]),
                       holds_no_base=no_base, equal=equal, max_abs_diff=diff,
                       kernels_repeat=repeats, kernels_vs_plain=worst, losses=loss_a, fitnesses=fit_a, mfu=mfu_a,
                       launches=dict(launches), peak_gb=peak_gb)
    del base, pop_a, pop_c, pop
    torch.cuda.empty_cache()

    # ---- (b) train_off_policy DQN: a crash injected into a snapshot's commit ----
    log(f"phase 4s: train_off_policy, DQN at dqn.yaml's widths on the device CartPole: "
        f"{RES_DQN_HP['NUM_ENVS']} envs, population 2, evo_steps {RES_DQN_EVO}, max_steps "
        f"{RES_DQN_MAX} (cut from 10,000 / 200,000); the second snapshot's commit crashed")
    save_every = RES_DQN_HP["POP_SIZE"] * RES_DQN_EVO

    def dqn(res, resume=False):
        np.random.seed(0)
        random.seed(0)
        env = make_vect_envs("CartPole-v1", RES_DQN_HP["NUM_ENVS"], seed=0)
        pop = create_population("DQN", env.single_observation_space, env.single_action_space,
                                RES_DQN_NET, RES_DQN_HP, seed=0)
        return host_s(torch, lambda: train_off_policy(
            env, "CartPole-v1", "DQN", pop, ReplayBuffer(RES_DQN_MEMORY, seed=0),
            INIT_HP=RES_DQN_HP, max_steps=RES_DQN_MAX, evo_steps=RES_DQN_EVO,
            eval_steps=RES_DQN_EVAL,
            tournament=TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0)),
            mutation=Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0,
                               activation=0.0, rl_hp=0.5, rand_seed=0),
            verbose=False, resilience=res, resume=resume))

    (pop_a, fit_a), t_a = dqn(Resilience(workdir / "dqn_a", save_every=save_every,
                                         handle_signals=False))
    crashed = False
    t0 = time.perf_counter()
    with FaultInjector(kill_at_op=1, match=("commit",)):
        try:
            dqn(Resilience(workdir / "dqn_b", save_every=save_every, handle_signals=False))
        except InjectedCrash:
            crashed = True
    t_b = time.perf_counter() - t0
    res = Resilience(workdir / "dqn_b", save_every=save_every, handle_signals=False)
    kept = [s.step for s in res.manager.snapshots()]
    check(crashed and kept == [save_every], f"DQN: crash {crashed}, snapshots {kept}")
    (pop_c, fit_c), t_c = dqn(res, resume=True)
    dqn_state = [[a.actor.params, a.actor_target.params, a.optimizer.opt_state] for a in pop_a]
    dqn_state_c = [[a.actor.params, a.actor_target.params, a.optimizer.opt_state]
                   for a in pop_c]
    dqn_equal = dict(fitnesses=fit_a == fit_c,
                     weights_and_moments=leaves_equal(torch, dqn_state, dqn_state_c))
    log(f"  uninterrupted {t_a:.1f} s, fitnesses {fit_a}; crashed run {t_b:.1f} s, kept "
        f"snapshots at {kept}; resumed {t_c:.1f} s, fitnesses {fit_c}; equal {dqn_equal}")
    check(all(dqn_equal.values()) and all(len(f) == 3 for f in fit_a),
          f"DQN resume: {dqn_equal}")
    out["dqn"] = dict(run_a_s=t_a, run_b_s=t_b, run_c_s=t_c, fitnesses=fit_a, equal=dqn_equal,
                      snapshot_bytes=res.manager.snapshots()[0].nbytes)

    # ---- (c) ScanRun(EvoPPO) at 4i's widths ----
    engine = evo_ppo(torch, POP)
    run = ScanRun(engine, POP["pop"], seed=0)
    run.run(1)
    res = Resilience(workdir / "scan", handle_signals=False)
    res.attach(pop=[run])
    path, t_save = host_s(torch, lambda: res.snapshot(step=1))
    expected = run.run(2)
    run2 = ScanRun(engine, POP["pop"], seed=1234)
    res2 = Resilience(workdir / "scan", handle_signals=False)
    res2.attach(pop=[run2])
    _, t_resume = host_s(torch, res2.resume)
    got = run2.run(2)
    scan_equal = dict(fitness=bool(np.array_equal(got, expected)),
                      population=leaves_equal(torch, run.pop, run2.pop),
                      generation=run2.generation == run.generation == 3)
    nbytes = res.manager.snapshots()[0].nbytes
    log(f"phase 4s: ScanRun(EvoPPO) at population {POP['pop']} x {POP['num_envs']} envs x "
        f"{POP['rollout_len']} steps: snapshot after 1 generation {nbytes / 1e6:.1f} MB in "
        f"{t_save:.2f} s, resumed into seed 1234 in {t_resume:.2f} s; 2 generations {scan_equal}")
    check(all(scan_equal.values()), f"ScanRun resume: {scan_equal}")
    out["scan"] = dict(snapshot_bytes=nbytes, save_s=t_save, resume_s=t_resume,
                       equal=scan_equal, fitness=got.tolist())
    res.close()
    res2.close()
    del run, run2

    # ---- (d) MakeEvolvable on the card ----
    import torch.nn as nn

    from agilerl_tpu_torch.wrappers import MakeEvolvable

    torch.manual_seed(0)
    mlp = nn.Sequential(nn.Linear(8, 64), nn.LayerNorm(64), nn.ReLU(), nn.Linear(64, 64),
                        nn.LayerNorm(64), nn.ReLU(), nn.Linear(64, 4)).cuda()
    cnn = nn.Sequential(nn.Conv2d(3, 16, 3, stride=2), nn.ReLU(), nn.Conv2d(16, 32, 3),
                        nn.ReLU(), nn.Flatten(), nn.Linear(32 * 5 * 5, 6)).cuda()
    errs = {}
    for name, net, x in (("mlp", mlp, torch.randn(32, 8, device="cuda")),
                         ("cnn", cnn, torch.randn(16, 3, 15, 15, device="cuda"))):
        module = MakeEvolvable(network=net, input_tensor=x)
        check(all(t.device.type == "cuda" for t in tree_leaves(module.params)),
              f"MakeEvolvable {name} left the card")
        xin = x if name == "mlp" else x.permute(0, 2, 3, 1).contiguous()
        with torch.no_grad():
            errs[name] = float((module(xin) - net(x)).abs().max())
    log(f"phase 4s: MakeEvolvable of a torch.nn MLP and CNN on the card: max |clone - module| "
        f"{errs} (atol {MAKE_EVOLVABLE_ATOL})")
    check(all(e <= MAKE_EVOLVABLE_ATOL for e in errs.values()), f"MakeEvolvable: {errs}")
    out["make_evolvable"] = errs
    report["resilience"] = out
    return dict(out["grpo"]["launches"])


# ------------------------------- phase 4t ---------------------------------- #
# The stack as supervised OS processes (training/launch.py, resilience/proc.py):
# GRPO at llama3-8b full depth with 4s's char vocab and arithmetic recipe (data
# batch 2 x group 4, 16 new tokens), staleness 0, 4 epochs; rollouts decode
# through the continuous tier with captured logprobs (as 4g's fleet)
LAUNCH_EPOCHS = 4
LAUNCH_KILL_EPOCH = 2
LAUNCH_PROMPTS = 2
LAUNCH_NEW_TOKENS = 16
LAUNCH_LEASE_S = 10.0
LAUNCH_GRACE_S = 60.0
LAUNCH_TIMEOUT_S = 300.0
#: the children import the factories below as chip_smoke:<fn>, from this
#: checkout's root (which may be a copy of the tree)
LAUNCH_PATH = str(Path(__file__).resolve().parent)
LAUNCH_KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                  "fused_logprob_fwd", "fused_logprob_dh")
# (f) TrafficDriver over 4g's 2-replica fleet at llama3-8b (decode chunks of
# 4 tokens): scenario_suite's four shapes at 5 virtual seconds of 4
# requests/s, up to 16 new tokens, 1 fleet step per virtual second, then the
# flash crowd again with replica 1 killed at its second 2
TRAFFIC = dict(vocab=512, duration_s=5.0, base_rate_rps=4.0, max_prompt=28, max_new=16)
TRAFFIC_STEPS_PER_S = 1.0
TRAFFIC_DECODE_CHUNK = 4
TRAFFIC_KILL = {2: 1}
# (h) the budget at phase 4b's shapes (16 rows of 320 tokens, 64 new), against
# what phase 4's base and its dense generate (the same shapes) allocated
BUDGET_ROWS = GROUP_SIZE * len(PROMPT_LENS)
BUDGET_PROMPT = max(PROMPT_LENS)


def launch_agent(seed=0, device=None, **cfg_over):
    """Phase 4t's role factory (``chip_smoke:launch_agent``): GRPO at
    llama3-8b (full width and depth, char vocab, bf16 blocks), the base drawn
    on the device from seed 1 as phase 4s draws it, continuous decode with
    captured logprobs. Every process that calls it with one seed holds the
    same agent."""
    from agilerl_tpu_torch.algorithms.grpo import GRPO
    from agilerl_tpu_torch.llm import model as M, presets
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer

    tok = CharTokenizer()
    cfg = presets.preset("llama3-8b", **dict(dict(vocab_size=tok.vocab_size, max_seq_len=256,
                                                  remat=False), **cfg_over))
    return GRPO(config=cfg, base_params=M.init_params(1, cfg, device=device),
                pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id, seed=seed,
                group_size=GROUP_SIZE, batch_size=LAUNCH_PROMPTS * GROUP_SIZE,
                max_output_tokens=LAUNCH_NEW_TOKENS, lora_rank=LORA_RANK,
                continuous_decode=True, capture_logprobs=True, device=device)


def launch_env():
    """Phase 4t's env factory (``chip_smoke:launch_env``): phase 4s's
    arithmetic ReasoningGym."""
    from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym

    return ReasoningGym(arith_rows(64, 0), arith_rows(RES_EVAL_ROWS, 1), CharTokenizer(),
                        reward_fn=arith_reward, data_batch_size=LAUNCH_PROMPTS, seed=3)


class CountedRole:
    """A flywheel role that, at its drain, writes this process's kernel
    launches and peak device memory into the role's registry as counters
    (``launch/<role>/kernel/<name>``, ``launch/<role>/peak_bytes``): the
    harness publishes them after the drain, so they reach the launcher
    through the telemetry plane."""

    def __init__(self, ctx, role):
        self.ctx, self.role = ctx, role

    def tick(self):
        return self.role.tick()

    def drain(self):
        import torch

        from agilerl_tpu_torch import ops

        name = self.ctx.spec.name
        for kernel, n in ops.kernel_counters().items():
            self.ctx.metrics.counter(f"launch/{name}/kernel/{kernel}").inc(n)
        if torch.cuda.is_available():
            self.ctx.metrics.counter(f"launch/{name}/peak_bytes").inc(
                torch.cuda.max_memory_allocated())


def counted_learner_role(ctx):
    from agilerl_tpu_torch.training.launch import learner_role

    return CountedRole(ctx, learner_role(ctx))


def counted_rollout_role(ctx):
    from agilerl_tpu_torch.training.launch import rollout_role

    return CountedRole(ctx, rollout_role(ctx))


def launch_kwargs(**over):
    """launch_flywheel's / flywheel_launcher's arguments in phase 4t."""
    from agilerl_tpu_torch.observability import MetricsRegistry

    return dict(dict(make_agent="chip_smoke:launch_agent", make_env="chip_smoke:launch_env",
                     max_epochs=LAUNCH_EPOCHS,
                     lease_timeout=LAUNCH_LEASE_S, grace_s=LAUNCH_GRACE_S,
                     env={"PYTHONPATH": LAUNCH_PATH}, registry=MetricsRegistry()), **over)


def np_leaves_equal(a, b):
    import numpy as np

    from agilerl_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                      for x, y in zip(la, lb))


def np_max_diff(a, b):
    import numpy as np

    from agilerl_tpu_torch.utils.tree import tree_leaves

    return max((float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
                for x, y in zip(tree_leaves(a), tree_leaves(b))), default=0.0)


def wait_until(cond, what, launcher=None, timeout=LAUNCH_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"phase 4t: timed out waiting for {what}")
        if launcher is not None:
            launcher.poll()
        time.sleep(0.05)


def epoch_publish_times(root):
    """{epoch: the commit time of its weight-store entry} (the directory's
    mtime, set by the commit's rename)."""
    from agilerl_tpu_torch.resilience.store import committed_entries

    return {int(p.name.split("_")[1]): p.stat().st_mtime
            for p in committed_entries(Path(root) / "weights", "epoch_")}


def run_launcher(torch, ops, report):
    """Phase 4t (see the constants above). Returns the kernel launches of the
    learner process of (b), read back through the telemetry plane."""
    import gc
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.benchmarking.traffic import (
        TrafficDriver,
        generate_trace,
        scenario_suite,
    )
    from agilerl_tpu_torch.llm import model as M, presets
    from agilerl_tpu_torch.llm.fleet import ServingFleet
    from agilerl_tpu_torch.llm.flywheel import (
        LearnerPod,
        OnlineGRPOFlywheel,
        RolloutPod,
        TrajectoryStore,
        WeightStore,
    )
    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.resilience.faults import FaultInjector
    from agilerl_tpu_torch.resilience.membership import pid_alive
    from agilerl_tpu_torch.training.launch import (
        flywheel_launcher,
        launch_flywheel,
        read_loss_stream,
    )
    from agilerl_tpu_torch.utils.checkpoint import load_llm_checkpoint, save_llm_checkpoint
    from agilerl_tpu_torch.utils.hbm_budget import (
        device_memory_gib,
        grpo_hbm_budget,
        param_counts,
        render_budget_md,
    )
    from agilerl_tpu_torch.utils.tree import tree_leaves

    out = report["launcher"] = {}
    workdir = Path(tempfile.mkdtemp(prefix="phase4t_"))

    # ---- (a) the in-process reference: two clones from one seed ----
    reg = MetricsRegistry()
    ws = WeightStore(workdir / "ref" / "w", keep_last=LAUNCH_EPOCHS + 1, metrics=reg)
    ts = TrajectoryStore(workdir / "ref" / "t", metrics=reg)
    (learner_agent, rollout_agent), t_build = host_s(
        torch, lambda: (launch_agent(0), launch_agent(0)))
    cfg = learner_agent.model_config
    learner = LearnerPod(learner_agent, ws, ts, max_staleness_epochs=0, metrics=reg,
                         carry_state=True)
    rollout = RolloutPod(rollout_agent, launch_env(), ws, ts, metrics=reg)
    ops.reset_kernel_counters()
    _, t_ref = host_s(torch, lambda: OnlineGRPOFlywheel(rollout, learner, metrics=reg).run(
        LAUNCH_EPOCHS))
    ref_launches = ops.kernel_counters()
    ref_losses = list(learner.losses)
    ref_epoch, ref_lora = ws.load_latest()
    log(f"phase 4t: GRPO at llama3-8b ({cfg.n_layer} layers, char vocab {cfg.vocab_size}), "
        f"{LAUNCH_PROMPTS} prompts x group {GROUP_SIZE}, {LAUNCH_NEW_TOKENS} new tokens, "
        f"staleness 0, {LAUNCH_EPOCHS} epochs")
    log(f"  (a) in process: 2 agents built in {t_build:.1f} s, {LAUNCH_EPOCHS} epochs in "
        f"{t_ref:.1f} s; losses {ref_losses}; launches {ref_launches}")
    check(ref_epoch == LAUNCH_EPOCHS and len(ref_losses) == LAUNCH_EPOCHS
          and all(np.isfinite(ref_losses)), f"(a): epoch {ref_epoch}, losses {ref_losses}")
    out["inprocess"] = dict(build_s=t_build, run_s=t_ref, losses=ref_losses,
                            launches=ref_launches)

    # ---- (g) an llama3-8b agent's adapters through DCP, no base ----
    ckpt = workdir / "llm_ckpt"
    learner_agent.fitness = [0.5]
    # the first save pays for DCP's import and set-up; the second is timed
    _, t_first = host_s(torch, lambda: save_llm_checkpoint(learner_agent, workdir / "first"))
    _, t_save = host_s(torch, lambda: save_llm_checkpoint(learner_agent, ckpt))
    nbytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    rollout_agent.fitness = []
    _, t_load = host_s(torch, lambda: load_llm_checkpoint(rollout_agent, ckpt))
    same = dict(actor=leaves_equal(torch, learner_agent.actor.params,
                                   rollout_agent.actor.params),
                reference=leaves_equal(torch, learner_agent.reference.params,
                                       rollout_agent.reference.params),
                fitness=rollout_agent.fitness == [0.5],
                on_the_card=all(t.device.type == learner_agent.dev.type
                                for t in tree_leaves(rollout_agent.actor.params)),
                no_base=not (ckpt / "base_params").exists())
    log(f"  (g) save_llm_checkpoint / load_llm_checkpoint (DCP, adapters only): "
        f"{nbytes / 1e6:.2f} MB, save {t_save:.3f} s (the first {t_first:.3f} s), load "
        f"{t_load:.3f} s; {same}")
    check(all(same.values()), f"(g): the adapters did not round-trip: {same}")
    out["checkpoint"] = dict(bytes=nbytes, save_s=t_save, first_save_s=t_first,
                             load_s=t_load, equal=same)
    del learner, rollout, learner_agent, rollout_agent
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"  before the children: {free / 1e9:.1f} of {total / 1e9:.1f} GB free on the card")

    # ---- (b) launch_flywheel: learner and rollout as OS processes ----
    root = workdir / "launch"
    started = time.time()
    summary, t_launch = host_s(torch, lambda: launch_flywheel(root, **launch_kwargs(
        timeout=LAUNCH_TIMEOUT_S, learner_target="chip_smoke:counted_learner_role",
        rollout_target="chip_smoke:counted_rollout_role")))
    times = epoch_publish_times(root)
    got_epoch, got_lora = WeightStore(root / "weights", metrics=MetricsRegistry()).load_latest()
    counters = summary["telemetry"]["counters"]
    child = {role: {k: int(counters.get(f"launch/{role}/kernel/{k}", 0)) for k in ref_launches}
             for role in ("learner", "rollout_0")}
    peaks = {role: counters.get(f"launch/{role}/peak_bytes", 0) / 1e9
             for role in ("learner", "rollout_0")}
    per_epoch = (times[LAUNCH_EPOCHS] - times[0]) / LAUNCH_EPOCHS
    equal = dict(losses=summary["losses"] == ref_losses,
                 adapter=got_epoch == ref_epoch and np_leaves_equal(got_lora, ref_lora))
    log(f"  (b) launch_flywheel: {t_launch:.1f} s (epoch 0 published after "
        f"{times[0] - started:.1f} s, then {per_epoch:.2f} s per epoch); exits "
        f"{summary['exits']}, orphans {summary['orphans']}; losses {summary['losses']}")
    log(f"      against (a): {equal} (max |d| adapter {np_max_diff(got_lora, ref_lora):.3g}); "
        f"child launches {child}; child peaks {peaks} GB")
    check(summary["exits"] == {"learner": 0, "rollout_0": 0} and summary["orphans"] == [],
          f"(b): exits {summary['exits']}, orphans {summary['orphans']}")
    check(all(not s.get("jax_loaded") and s.get("loaded_at_guard") == []
              for s in summary["statuses"].values()), f"(b): statuses {summary['statuses']}")
    check(all(equal.values()), f"(b) is not (a) bit for bit: {equal}")
    # (e) the kernels in the learner's process; the rollout decodes on
    # captured logprobs and launches none
    check(all(child["learner"][k] > 0 for k in LAUNCH_KERNELS),
          f"(e): the learner process missed a kernel: {child['learner']}")
    check(sum(child["rollout_0"].values()) == 0, f"(e): the rollout launched {child['rollout_0']}")
    out["launch"] = dict(s=t_launch, per_epoch_s=per_epoch, exits=summary["exits"],
                         losses=summary["losses"], equal=equal, child_launches=child,
                         child_peak_gb=peaks)

    # ---- (c) kill -9 the learner once epoch 2 is published ----
    root = workdir / "kill"
    launcher = flywheel_launcher(root, **launch_kwargs())
    launcher.start(join_timeout=LAUNCH_TIMEOUT_S)
    store = WeightStore(root / "weights", metrics=MetricsRegistry())
    wait_until(lambda: (store.latest_epoch() or 0) >= LAUNCH_KILL_EPOCH, "epoch 2", launcher)
    victim = launcher.supervisor.procs["learner"]
    alive = victim.alive
    os.kill(victim.pid, signal.SIGKILL)
    victim.popen.wait(timeout=60)
    t_kill = time.perf_counter()
    killed_at = store.latest_epoch()
    restarted = []
    wait_until(lambda: restarted.extend(e for e in launcher.poll() if e["role"] == "learner"
                                        and e["action"] == "restarted") or restarted,
               "the learner's respawn")
    wait_until(lambda: (store.latest_epoch() or 0) > killed_at, "the respawn's first epoch",
               launcher)
    warm_s = time.perf_counter() - t_kill
    summary = launcher.run(timeout=LAUNCH_TIMEOUT_S)
    got_epoch, got_lora = store.load_latest()
    losses = read_loss_stream(root)
    st = summary["statuses"]["learner"]
    restores = launcher.aggregate_telemetry()["counters"].get("flywheel/learner_restores_total")
    equal = dict(losses=losses == ref_losses,
                 adapter=got_epoch == ref_epoch and np_leaves_equal(got_lora, ref_lora))
    log(f"  (c) kill -9 of the learner at epoch {killed_at} (alive {alive}): respawned as "
        f"incarnation {st['incarnation']}, {restores} restore; {warm_s:.1f} s from the kill to "
        f"its first published epoch; final state {st['state']}, orphans {summary['orphans']}; "
        f"against (a): {equal}")
    check(alive and st["state"] == "done" and st["incarnation"] == 1 and restores == 1
          and summary["orphans"] == [], f"(c): {st}, restores {restores}, {summary['orphans']}")
    check(all(equal.values()), f"(c) is not (a) bit for bit: {equal}")
    out["kill9"] = dict(killed_at_epoch=killed_at, warm_restart_s=warm_s, equal=equal,
                        incarnation=st["incarnation"])

    # ---- (d) drain: shutdown() mid-run ----
    root = workdir / "drain"
    launcher = flywheel_launcher(root, **launch_kwargs())
    launcher.start(join_timeout=LAUNCH_TIMEOUT_S)
    store = WeightStore(root / "weights", metrics=MetricsRegistry())
    wait_until(lambda: (store.latest_epoch() or 0) >= 1, "epoch 1", launcher)
    pids = [p.pid for p in launcher.supervisor.procs.values()]
    summary, drain_s = host_s(torch, launcher.shutdown)
    states = {n: s["state"] for n, s in summary["statuses"].items()}
    left = [pid for pid in pids if pid_alive(pid)]
    log(f"  (d) shutdown() at epoch {store.latest_epoch()}: drained in {drain_s:.2f} s; "
        f"states {states}, exits {summary['exits']}, escalated {summary['escalated']}, "
        f"orphans {summary['orphans']}, processes left {left}")
    check(all(s in ("preempted", "done") for s in states.values()) and len(states) == 2
          and summary["orphans"] == [] and summary["escalated"] == [] and left == [],
          f"(d): {states}, {summary['orphans']}, {summary['escalated']}, {left}")
    out["drain"] = dict(s=drain_s, states=states, exits=summary["exits"])
    shutil.rmtree(workdir, ignore_errors=True)

    # ---- (h) the budget against phase 4's allocations and 4b's peak ----
    full = presets.preset("llama3-8b")
    budget = grpo_hbm_budget(full, fsdp=1, tp=1, batch_global=BUDGET_ROWS,
                             seq_len=BUDGET_PROMPT + MAX_NEW_TOKENS,
                             gen_batch_global=BUDGET_ROWS,
                             gen_total_len=BUDGET_PROMPT + MAX_NEW_TOKENS)
    alloc = report["alloc"]
    # the learn at these shapes with remat (phase 4x (a)), as the budget assumes
    learn_peak = report["remat"]["a"]["remat"]["peak_memory_gb"]
    check(math.isfinite(learn_peak) and learn_peak > 0, f"(h): phase 4x's remat peak {learn_peak}")
    terms = {k: v / 1e9 for k, v in budget.items() if k not in ("meta", "total")}
    eager = learn_peak - terms["base_weights"] - terms["lora_adapter_state"]
    remat = terms["remat_checkpoints"] + terms["block_recompute_peak"] + \
        terms["lm_head_loss_chunk"]
    log(f"  (h) grpo_hbm_budget at fsdp = tp = 1, {BUDGET_ROWS} rows x "
        f"{BUDGET_PROMPT + MAX_NEW_TOKENS} tokens ({MAX_NEW_TOKENS} new), GB: "
        + ", ".join(f"{k} {v:.3f}" for k, v in terms.items())
        + f", total {budget['total'] / 1e9:.3f}; phase 4x (a)'s remat learn peak "
        f"{learn_peak:.1f} GB: its activations {eager:.1f} GB against the remat terms' "
        f"{remat:.2f} GB; card "
        f"{device_memory_gib():.1f} GiB")
    log(f"      phase 4's base allocated {alloc['base_bytes']} B (term "
        f"{budget['base_weights']:.0f} B); its generate's dense KV cache {alloc['kv_bytes']} B "
        f"(+ mask {alloc['mask_bytes']} B, allocated {alloc['kv_delta']} B, k "
        f"{alloc['kv_shape']}; term {budget['kv_cache_generation']:.0f} B)")
    check(alloc["base_bytes"] == budget["base_weights"] == param_counts(full)["base_bytes"],
          f"(h): base allocated {alloc['base_bytes']} B, term {budget['base_weights']} B")
    check(alloc["kv_bytes"] == budget["kv_cache_generation"]
          and alloc["kv_delta"] == alloc["kv_bytes"] + alloc["mask_bytes"]
          and alloc["kv_shape"] == [full.n_layer, BUDGET_ROWS, BUDGET_PROMPT + MAX_NEW_TOKENS,
                                    full.kv_heads, full.head_dim],
          f"(h): the KV cache {alloc} against {budget['kv_cache_generation']}")
    out["budget"] = dict(terms_gb=terms, total_gb=budget["total"] / 1e9, learn_peak_gb=learn_peak,
                         eager_activations_gb=eager, remat_terms_gb=remat, alloc=alloc,
                         table=render_budget_md(budget))
    torch.cuda.empty_cache()
    params = M.init_params(0, full)

    # ---- (f) TrafficDriver over the 2-replica fleet ----
    fleet_kw = dict(SERVE, decode_chunk=TRAFFIC_DECODE_CHUNK, pad_id=0, eos_id=None,
                    bucket_overrides={"serving/ttft_s": TTFT_FINE})
    runs = [(s.name, s, None) for s in scenario_suite(**TRAFFIC)]
    runs.append(("flash_crowd+kill", runs[2][1], TRAFFIC_KILL))
    ops.reset_kernel_counters()
    traffic = {}
    for name, spec, kill in runs:
        fleet = ServingFleet(full, 2, metrics=MetricsRegistry(), **fleet_kw)
        trace = generate_trace(spec, seed=0)
        driver = TrafficDriver(fleet, steps_per_s=TRAFFIC_STEPS_PER_S, seed=0,
                               fault_injector=FaultInjector(kill_host_at=kill) if kill else None)
        res = driver.run(trace, params, greedy=True)
        h = fleet.merged_dump(counters=[], histograms=["serving/ttft_s"])["histograms"][
            "serving/ttft_s"]
        traffic[name] = dict(n=res.n_requests, submitted=res.submitted, shed=res.shed,
                             completed=res.completed, steps=res.steps, wall_s=res.wall_s,
                             tokens=res.delivered_tokens, kills=res.kills,
                             ttft_p50_ms=1e3 * dump_percentile(h, 50),
                             ttft_p95_ms=1e3 * dump_percentile(h, 95))
        t = traffic[name]
        log(f"  (f) {name}: {t['completed']} of {t['n']} completed ({t['shed']} shed), "
            f"{t['steps']} steps in {t['wall_s']:.1f} s, {t['tokens']} tokens; TTFT p50 "
            f"{t['ttft_p50_ms']:.1f} ms, p95 {t['ttft_p95_ms']:.1f} ms; kills {t['kills']}")
        check(res.completed == res.submitted == res.n_requests and res.shed == 0,
              f"(f) {name}: {t}")
        del fleet
    check(traffic["flash_crowd+kill"]["kills"] == [{"virtual_s": 2.0, "replica": 1}],
          f"(f): the kill {traffic['flash_crowd+kill']['kills']}")
    out["traffic"] = dict(runs=traffic, launches=ops.kernel_counters())
    del params
    torch.cuda.empty_cache()
    return dict(child["learner"])


# ------------------------------- phase 4u ---------------------------------- #
# Queue 1's items 4 and 6 on the card. (a) GRPO.to_mesh with the committed
# 7B plan degraded onto the one-card mesh (every rule axis drops: DTensors
# replicated on a 1-rank mesh; the flash and fused calls run through
# local_map on flash_shard_axes / fused_loss_shard_axes): two learns at
# llama3-8b on 4b's batch shape against two unplaced learns on the same
# batch, bit for bit or within PLACED_ADAPTER_REL of the adapters' own
# movement, with 4b's launches per learn. (b) GRPO(sequence_parallel_axis=
# "sp") at world size 1 and full depth on 2 right-padded rows x 2,048 (f32
# ring attention through the f32 flash kernels, dense f32 head): its
# logprobs against the plain token_logprobs within E2E_MAX_FACTOR /
# E2E_MEAN_FACTOR of the kernel path's own spread at the same inputs (phase
# 4's rule), then one learn. (c) two ranks on the one card over gloo
# (``chip_smoke.py --ring-rank``: two child processes; NCCL takes one rank
# per card) on a 4-layer model at llama3-8b width with an f32 base (every
# product in f32: the two sides differ only by f32 roundings), 2 rows x
# 8,192 (2,048 of padding on the second), 4,096 tokens per rank, against the
# same model at world size 1 in this process: the adapter gradient the
# optimizer is handed (summed over the ranks, before clipping) within
# RING_GRAD_REL in relative L2, the adapter update within RING_UPDATE_REL
# (one Adam step is about lr * sign(gradient): entries near zero may flip),
# the logprobs within the JAX long-context test's atol and the loss at the
# JAX sp test's tolerance (in the first epoch the ratio is 1 and the KL 0,
# so the loss is -mean(advantage) and shows only that the learn ran);
# adapters and Adam moments bit-identical across the ranks, and each rank's
# flash launches exact (rank r: r + 1 per layer per pass). (d) EvoPPO
# through ScanRun on a one-rank population mesh at pop 8 against ScanRun
# without one, bit for bit. (a) and (b) run on phase 4's weights after 4g;
# (c) and (d) after 4t, when this process holds no 8B weights.
SHARD_PLAN = "configs/sharding/grpo_7b_fsdp16xtp4.yaml"
ONE_CARD_BACKEND = "nccl"  # a one-card mesh's group (gloo on a CPU rehearsal)
SHARD_AXES = dict(flash_shard_axes=(("dp", "fsdp"), ("tp",)), fused_loss_shard_axes=("dp", "fsdp"))
PLACED_ADAPTER_REL = 1e-2
SP_ROWS, SP_T, SP_PAD = 2, 2_048, 256
RING_LAYERS, RING_ROWS, RING_T, RING_PAD, RING_SEED = 4, 2, 8_192, 2_048, 17
RING_LOSS_TOL = dict(rtol=2e-3, atol=2e-4)  # tests/test_parallel/test_mesh.py:97
RING_LP_ATOL = 2e-4  # tests/test_llm/test_long_context.py:28
RING_GRAD_REL = 1e-3
RING_UPDATE_REL = 5e-2
RING_TIMEOUT_S = 300.0
POD = dict(pop=8, num_envs=16, rollout_len=32, latent=32, hidden=64, update_epochs=1,
           num_minibatches=2, lr=3e-4, generations=2)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class one_rank_group:
    """A world-size-1 process group in this process for the one-card meshes
    (NCCL on the card); destroyed on exit, so later phases see none."""

    def __enter__(self):
        import torch.distributed as dist

        dist.init_process_group(ONE_CARD_BACKEND,
                                init_method=f"tcp://127.0.0.1:{free_port()}",
                                rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        return False


def flat_leaves(tree):
    from agilerl_tpu_torch.utils.tree import tree_leaves

    return [x for x in tree_leaves(tree) if hasattr(x, "shape")]


def adapter_change(torch, new, old):
    """max |new - old| over the adapter leaves (DTensors as whole values)."""
    from agilerl_tpu_torch.utils.tree import tree_to_numpy

    import numpy as np

    a, b = flat_leaves(tree_to_numpy(new)), flat_leaves(tree_to_numpy(old))
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def placed_batch(np, cfg, prompts):
    """4b's batch shape: phase 4's prompts x group 4 with seeded completions
    (two end early), the action mask of their predictions, rewards."""
    ptoks, pmask = prompts
    n, P = ptoks.shape
    rng = np.random.default_rng(21)
    comp = rng.integers(1, cfg.vocab_size, (n * GROUP_SIZE, MAX_NEW_TOKENS))
    cmask = np.ones(comp.shape, np.int32)
    cmask[1, 40:] = cmask[6, 10:] = 0
    comp = comp * cmask
    ids = np.concatenate([np.repeat(ptoks, GROUP_SIZE, 0), comp], axis=1)
    attn = np.concatenate([np.repeat(pmask, GROUP_SIZE, 0), cmask], axis=1)
    action = np.zeros((ids.shape[0], ids.shape[1] - 1), np.float32)
    action[:, P - 1:] = cmask
    rewards = completion_reward(comp).reshape(n, GROUP_SIZE).astype(np.float32)
    return ids, action, rewards, attn


def run_sharding(torch, M, ops, cfg, params, prompts, report):
    """Phase 4u (a) and (b) on phase 4's weights, with phase 4w (b) and (c)
    between them. Returns the launches of 4u (a)'s placed learns (the plan
    path), of the sp learn and of 4w (c)'s layout search."""
    import dataclasses

    import numpy as np

    from agilerl_tpu_torch.algorithms import grpo as TG
    from agilerl_tpu_torch.parallel.plan import ShardingPlan
    from agilerl_tpu_torch.utils.tree import tree_copy, tree_to_numpy

    out = report["sharding"] = {}
    torch.cuda.empty_cache()
    L = cfg.n_layer
    want = {"flash_attention_fwd": 3 * L, "flash_attention_dq": L, "flash_attention_dkv": L,
            "fused_logprob_fwd": 3, "fused_logprob_dh": 1, "fused_logprob_dw": 0}
    batch = placed_batch(np, cfg, prompts)
    scfg = dataclasses.replace(cfg, **SHARD_AXES)
    kw = dict(config=scfg, base_params=params, pad_token_id=0, seed=0, batch_size=16,
              update_epochs=1, group_size=GROUP_SIZE, max_output_tokens=MAX_NEW_TOKENS,
              lora_rank=LORA_RANK, lora_targets=("wq", "wv"))
    plan = ShardingPlan.from_yaml(SHARD_PLAN)
    log(f"phase 4u (a): GRPO.to_mesh(plan={plan.name!r}) on the one-card mesh, two learns on "
        f"{batch[0].shape[0]} rows x {batch[0].shape[1]} tokens at llama3-8b")
    with one_rank_group():
        placed = TG.GRPO(**kw)
        start = tree_copy(placed.actor.params)
        (_, t_place) = host_s(torch, lambda: placed.to_mesh(
            mesh=ShardingPlan("one-card", {"fsdp": 1}).build_mesh(), plan=plan))
        wq = placed.base_params["blocks"]["0"]["wq"]
        check(type(wq).__name__ == "DTensor", "to_mesh left the base weights plain")
        ops.reset_kernel_counters()
        learns = []
        for it in range(2):
            before = ops.kernel_counters()
            torch.cuda.reset_peak_memory_stats()
            with torch.enable_grad():
                loss, t = host_s(torch, lambda: placed.learn(batch))
            after = ops.kernel_counters()
            counts = {k: after[k] - before[k] for k in after}
            check(counts == want, f"4u (a) placed learn {it}: launches {counts} != {want}")
            learns.append(dict(loss=loss, learn_s=t, launches=counts,
                               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9))
        plan_launches = ops.kernel_counters()
        plain = TG.GRPO(**kw)
        plain_learns = []
        for it in range(2):
            with torch.enable_grad():
                loss, t = host_s(torch, lambda: plain.learn(batch))
            plain_learns.append(dict(loss=loss, learn_s=t))
        moved = adapter_change(torch, plain.actor.params, start)
        diff = adapter_change(torch, placed.actor.params, plain.actor.params)
        loss_d = max(abs(a["loss"][i] - b["loss"][i]) for a, b in zip(learns, plain_learns)
                     for i in (0, 1))
        log(f"  placed learns {[round(x['learn_s'], 3) for x in learns]} s (to_mesh "
            f"{t_place:.2f} s), unplaced {[round(x['learn_s'], 3) for x in plain_learns]} s; "
            f"losses {[x['loss'] for x in learns]} vs {[x['loss'] for x in plain_learns]}; "
            f"max|d loss| {loss_d:.3e}, max|d adapter| {diff:.3e} (the adapters moved by "
            f"{moved:.3e}); peak memory {learns[-1]['peak_memory_gb']:.1f} GB; launches per "
            f"learn {learns[-1]['launches']}")
        check(moved > 0, "4u (a): the adapters did not move")
        check(diff <= PLACED_ADAPTER_REL * moved and loss_d <= 1e-6 + 1e-3 * abs(
            plain_learns[0]["loss"][0]), "4u (a): the placed learn disagrees with the unplaced")
        out["plan"] = dict(plan=plan.name, placed=learns, unplaced=plain_learns,
                           to_mesh_s=t_place, bit_for_bit=diff == 0.0 and loss_d == 0.0,
                           max_adapter_diff=diff, adapter_moved=moved, max_loss_diff=loss_d)

        # phase 4w (b) and (c) on this agent pair, its batch and the weights
        t_4w = time.perf_counter()
        run_guards(torch, cfg, params, plain, batch, report)
        layout_launches = run_layout_search(torch, ops, cfg, placed, batch, plan, learns,
                                            plain_learns, report)
        report["phase_4w_bc_s"] = time.perf_counter() - t_4w
        log(f"phase 4w (b), (c): {report['phase_4w_bc_s']:.1f} s")
        del placed, plain
        torch.cuda.empty_cache()

        # (b) the sp learn at world size 1, full depth
        log(f"phase 4u (b): GRPO(sequence_parallel_axis='sp') on a 1-rank sp mesh, "
            f"{SP_ROWS} rows x {SP_T} (the second right-padded by {SP_PAD}), {L} layers")
        rng = np.random.default_rng(22)
        ids = rng.integers(1, cfg.vocab_size, (SP_ROWS, SP_T)).astype(np.int64)
        ids[1, SP_T - SP_PAD:] = 0
        action = np.zeros((SP_ROWS, SP_T - 1), np.float32)
        action[:, SP_T // 2:] = ids[:, SP_T // 2 + 1:] != 0
        sp = TG.GRPO(config=dataclasses.replace(cfg, use_flash_attention=True),
                     base_params=params, pad_token_id=0, seed=0, batch_size=SP_ROWS,
                     update_epochs=1, group_size=2, lora_rank=LORA_RANK,
                     lora_targets=("wq", "wv"), sequence_parallel_axis="sp")
        lora0 = tree_copy(sp.actor.params)
        sp.to_mesh(mesh=ShardingPlan("sp1", {"sp": 1}).build_mesh())
        tokens, mask, _ = sp._learn_masks(ids, action, None)
        lp_fn, _ = sp._learn_fns(tokens, mask)
        ops.reset_kernel_counters()
        lp, t_pass = host_s(torch, lambda: lp_fn(sp.actor.params, tokens, mask))
        pass_counts = ops.kernel_counters()
        check(pass_counts["flash_attention_fwd"] == L and pass_counts["fused_logprob_fwd"] == 0,
              f"4u (b): one sp pass launched {pass_counts}")
        real = (mask[:, 1:] > 0) & (mask[:, :-1] > 0)
        plain = M.token_logprobs(cfg, params, tokens, mask, lora=lora0, flash=False,
                                 use_fused=False)
        kernels = M.token_logprobs(cfg, params, tokens, mask, lora=lora0, flash=True,
                                   use_fused=True)
        d_sp, d_k = (lp - plain)[real].abs(), (kernels - plain)[real].abs()
        log(f"  sp logprobs vs plain token_logprobs: max|d| {d_sp.max().item():.3e} mean|d| "
            f"{d_sp.mean().item():.3e}; the kernel path vs plain at the same inputs: max|d| "
            f"{d_k.max().item():.3e} mean|d| {d_k.mean().item():.3e}; one sp pass "
            f"{t_pass:.3f} s")
        check(bool(torch.isfinite(lp[real]).all()), "4u (b): sp logprobs not finite")
        check(d_sp.max().item() <= E2E_MAX_FACTOR * d_k.max().item() + E2E_FLOOR
              and d_sp.mean().item() <= E2E_MEAN_FACTOR * d_k.mean().item() + E2E_FLOOR,
              "4u (b): the sp logprobs are further from the plain path than the kernel path's")
        del plain, kernels
        ops.reset_kernel_counters()
        torch.cuda.reset_peak_memory_stats()
        rewards = np.array([[1.0, 0.0]], np.float32)
        with torch.enable_grad():
            (loss, kl), t_learn = host_s(torch, lambda: sp.learn((ids, action, rewards)))
        sp_launches = ops.kernel_counters()
        sp_peak = torch.cuda.max_memory_allocated() / 1e9
        sp_want = {"flash_attention_fwd": 3 * L, "flash_attention_dq": L,
                   "flash_attention_dkv": L}
        check(all(sp_launches[k] == v for k, v in sp_want.items()),
              f"4u (b): sp learn launches {sp_launches} != {sp_want}")
        sp_moved = adapter_change(torch, sp.actor.params, lora0)
        check(np.isfinite(loss) and sp_moved > 0, f"4u (b): loss {loss}, adapter moved {sp_moved}")
        log(f"  sp learn {t_learn:.3f} s, loss {loss:.5f}, adapter moved {sp_moved:.3e}, peak "
            f"memory {sp_peak:.1f} GB, launches {sp_launches}")
        out["sp"] = dict(rows=SP_ROWS, T=SP_T, pad=SP_PAD, pass_s=t_pass, learn_s=t_learn,
                         loss=loss, kl=kl, adapter_moved=sp_moved, peak_memory_gb=sp_peak,
                         lp_vs_plain_max=d_sp.max().item(), lp_vs_plain_mean=d_sp.mean().item(),
                         kernel_vs_plain_max=d_k.max().item(),
                         kernel_vs_plain_mean=d_k.mean().item(), launches=sp_launches)
        del sp, lp
        torch.cuda.empty_cache()
    return plan_launches, sp_launches, layout_launches


def ring_batch(np, vocab):
    """2 rows x RING_T, the second right-padded by RING_PAD; completion
    predictions in the second half; one group of 2."""
    rng = np.random.default_rng(RING_SEED)
    ids = rng.integers(1, vocab, (RING_ROWS, RING_T)).astype(np.int64)
    ids[1, RING_T - RING_PAD:] = 0
    action = np.zeros((RING_ROWS, RING_T - 1), np.float32)
    action[:, RING_T // 2:] = ids[:, RING_T // 2 + 1:] != 0
    return ids, action, np.array([[1.0, 0.0]], np.float32)


def capture_grads(tx, sink):
    """``tx`` that also keeps each gradient tree it is handed, as numpy
    leaves, in ``sink``."""
    from agilerl_tpu_torch.algorithms.core.optimizer import Transform
    from agilerl_tpu_torch.utils.tree import tree_to_numpy

    def update(grads, state, params=None):
        sink.append(flat_leaves(tree_to_numpy(grads)))
        return tx.update(grads, state, params)

    return Transform(tx.init, update)


def ring_learn(torch, ops, world):
    """(c)'s 4-layer sp learn on a mesh whose sp axis has ``world`` ranks
    (this process's group): one no-grad logprob pass and one learn, each
    with its launches and host-staged bytes, and the gradient the learn's
    optimizer step was handed."""
    import numpy as np

    from agilerl_tpu_torch.algorithms.grpo import GRPO
    from agilerl_tpu_torch.llm import model as M, presets
    from agilerl_tpu_torch.parallel import comm
    from agilerl_tpu_torch.parallel.plan import ShardingPlan
    from agilerl_tpu_torch.utils.tree import tree_copy, tree_to_numpy

    cfg = presets.preset("llama3-8b", n_layer=RING_LAYERS, max_seq_len=RING_T,
                         dtype=torch.float32, remat=False)
    params = M.init_params(RING_SEED, cfg, device="cuda")
    agent = GRPO(config=cfg, base_params=params, pad_token_id=0, seed=0, group_size=2,
                 batch_size=RING_ROWS, update_epochs=1, lora_rank=LORA_RANK,
                 lora_targets=("wq", "wv"), sequence_parallel_axis="sp")
    start = tree_to_numpy(tree_copy(agent.actor.params))
    agent.to_mesh(mesh=ShardingPlan("ring", {"sp": world}).build_mesh())
    grads = []
    agent.optimizer.tx = capture_grads(agent.optimizer.tx, grads)
    ids, action, rewards = ring_batch(np, cfg.vocab_size)
    tokens, mask, _ = agent._learn_masks(ids, action, None)
    lp_fn, _ = agent._learn_fns(tokens, mask)
    ops.reset_kernel_counters()
    staged0 = comm.staged_bytes
    lp, t_pass = host_s(torch, lambda: lp_fn(agent.actor.params, tokens, mask))
    pass_launches = ops.kernel_counters()
    staged1 = comm.staged_bytes
    ops.reset_kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        (loss, kl), t_learn = host_s(torch, lambda: agent.learn((ids, action, rewards)))
    return dict(lp=lp.cpu().numpy(), loss=loss, kl=kl, pass_s=t_pass, learn_s=t_learn,
                pass_launches=pass_launches, learn_launches=ops.kernel_counters(),
                pass_staged_bytes=staged1 - staged0,
                learn_staged_bytes=comm.staged_bytes - staged1,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, start=start,
                grad=grads[0], actor=tree_to_numpy(agent.actor.params),
                adam=flat_leaves(tree_to_numpy(agent.optimizer.opt_state)))


def ring_rank_child(rank: int, port: int, out_dir: str) -> None:
    """One rank of (c) (``chip_smoke.py --ring-rank RANK PORT DIR``): both
    ranks on card 0, over gloo; its numbers into DIR/rank<RANK>.pkl."""
    import pickle

    import torch
    import torch.distributed as dist

    from agilerl_tpu_torch import ops

    torch_settings(torch)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        res = ring_learn(torch, ops, 2)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))


def update_rel(new, ref, start):
    """|(new - start) - (ref - start)| / |ref - start| over the adapter."""
    import numpy as np

    a = np.concatenate([x.ravel() for x in flat_leaves(new)])
    b = np.concatenate([x.ravel() for x in flat_leaves(ref)])
    s = np.concatenate([x.ravel() for x in flat_leaves(start)])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b - s), 1e-30))


def grad_rel(got, want):
    """|got - want| / |want| over the concatenated gradient leaves."""
    import numpy as np

    a = np.concatenate([x.ravel() for x in got])
    b = np.concatenate([x.ravel() for x in want])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_ring_and_pod(torch, ops, report):
    """Phase 4u (c) and (d). Returns the launches of the two ranks' learns
    (by rank) and of the pod generations."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.parallel.generation import ScanRun
    from agilerl_tpu_torch.parallel.plan import make_population_plan

    out = report.setdefault("sharding", {})
    log(f"phase 4u (c): the sp learn on {RING_LAYERS} layers at llama3-8b width, "
        f"{RING_ROWS} rows x {RING_T} (the second right-padded by {RING_PAD}): world size 1 "
        "here, then two ranks on the card over gloo")
    torch.cuda.empty_cache()
    with one_rank_group():
        one = ring_learn(torch, ops, 1)
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ring_"))
    port = free_port()
    procs = []
    try:
        for r in range(2):
            with open(work / f"rank{r}.log", "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--ring-rank", str(r),
                     str(port), str(work)], stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.perf_counter() + RING_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                pass
        for r in range(2):
            text = (work / f"rank{r}.log").read_text()
            if text.strip():
                log(f"  rank {r} log:\n{text.rstrip()}")
        check(all(p.returncode == 0 for p in procs),
              f"4u (c): the ranks exited {[p.returncode for p in procs]}")
        ranks = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
    L = RING_LAYERS
    for r, res in enumerate(ranks):
        fwd = res["pass_launches"]["flash_attention_fwd"]
        check(fwd == (r + 1) * L, f"4u (c): rank {r} launched {fwd} flash forwards in one pass, "
              f"not {(r + 1) * L}")
        ll = res["learn_launches"]
        check(ll["flash_attention_fwd"] == 3 * (r + 1) * L
              and ll["flash_attention_dq"] == (r + 1) * L
              and ll["flash_attention_dkv"] == (r + 1) * L,
              f"4u (c): rank {r}'s learn launched {ll}")
    check(one["pass_launches"]["flash_attention_fwd"] == L, "4u (c): world size 1 launches")
    for key in ("actor", "adam"):
        a, b = flat_leaves(ranks[0][key]), flat_leaves(ranks[1][key])
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"4u (c): the ranks' {key} trees differ")
    ids = ring_batch(np, 128_256)[0]
    real = (ids[:, 1:] != 0) & (ids[:, :-1] != 0)
    d_lp = np.abs(ranks[0]["lp"] - one["lp"])[real]
    rel = update_rel(ranks[0]["actor"], one["actor"], one["start"])
    g_rel = grad_rel(ranks[0]["grad"], one["grad"])
    g_norm = float(np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in one["grad"])))
    loss2, loss1 = ranks[0]["loss"], one["loss"]
    shifts = L * (3 + 1)  # one shift per layer per pass (P - 1 = 1), and the backward's
    staged = ranks[0]["learn_staged_bytes"]
    log(f"  2 ranks vs 1: logprobs max|d| {d_lp.max():.3e} mean|d| {d_lp.mean():.3e}; loss "
        f"{loss2:.6f} vs {loss1:.6f}; adapter gradient relative L2 {g_rel:.3e} (|g| "
        f"{g_norm:.4e} at 1 rank); adapter update relative L2 {rel:.3e}; learn "
        f"{[round(r['learn_s'], 3) for r in ranks]} s at 2 ranks, {one['learn_s']:.3f} s at 1; "
        f"one pass {[round(r['pass_s'], 3) for r in ranks]} s vs {one['pass_s']:.3f} s; "
        f"host-staged bytes per ring step {staged / shifts:.4g} (learn {staged:.4g} over "
        f"{shifts} shifts; one pass {ranks[0]['pass_staged_bytes']:.4g}); peak memory "
        f"{[round(r['peak_memory_gb'], 1) for r in ranks]} GB per rank, "
        f"{one['peak_memory_gb']:.1f} GB at 1")
    check(abs(loss2 - loss1) <= RING_LOSS_TOL["atol"] + RING_LOSS_TOL["rtol"] * abs(loss1),
          "4u (c): the 2-rank loss disagrees with world size 1")
    check(d_lp.max() <= RING_LP_ATOL,
          f"4u (c): the 2-rank logprobs are further than {RING_LP_ATOL} from world size 1")
    check(g_norm > 0 and g_rel <= RING_GRAD_REL,
          f"4u (c): the 2-rank adapter gradient is {g_rel:.3e} from world size 1 in relative "
          f"L2 (bound {RING_GRAD_REL})")
    check(rel <= RING_UPDATE_REL,
          f"4u (c): the 2-rank adapter update is {rel:.3e} from world size 1 in relative L2 "
          f"(bound {RING_UPDATE_REL})")
    out["ring"] = dict(
        layers=L, rows=RING_ROWS, T=RING_T, pad=RING_PAD, lp_max=float(d_lp.max()),
        lp_mean=float(d_lp.mean()), loss=[loss2, loss1], grad_rel=g_rel, grad_norm=g_norm,
        update_rel=rel,
        learn_s=[r["learn_s"] for r in ranks], learn_s_one=one["learn_s"],
        pass_s=[r["pass_s"] for r in ranks], pass_s_one=one["pass_s"],
        staged_bytes_per_step=staged / shifts, peak_memory_gb=[r["peak_memory_gb"]
                                                               for r in ranks],
        peak_memory_gb_one=one["peak_memory_gb"],
        launches=[r["learn_launches"] for r in ranks])

    log(f"phase 4u (d): EvoPPO through ScanRun on a one-rank population mesh, pop "
        f"{POD['pop']}, {POD['generations']} generations")
    ops.reset_kernel_counters()
    with one_rank_group():
        pod = ScanRun(evo_ppo(torch, POD), POD["pop"], seed=0, plan=make_population_plan(1))
        fit_pod, t_pod = host_s(torch, lambda: pod.run(POD["generations"]))
    ref = ScanRun(evo_ppo(torch, POD), POD["pop"], seed=0)
    fit_ref, t_ref = host_s(torch, lambda: ref.run(POD["generations"]))
    same = np.array_equal(fit_pod, fit_ref) and all(
        torch.equal(a, b) if hasattr(a, "shape") else a == b
        for a, b in zip(flat_leaves(pod.pop), flat_leaves(ref.pop)))
    log(f"  pod {t_pod:.2f} s vs vmapped {t_ref:.2f} s; fitness {fit_pod[-1].tolist()}; "
        f"bit for bit: {same}")
    check(same, "4u (d): the pod generation differs from ScanRun without a mesh")
    out["pod"] = dict(pop=POD["pop"], generations=POD["generations"], pod_s=t_pod,
                      vmap_s=t_ref, bit_for_bit=same)
    return {r: ranks[r]["learn_launches"] for r in range(2)}


# ------------------------------- phase 4v ---------------------------------- #
# Queue 1's item 5 on the card. (a) the GPipe pipeline
# (``parallel/pipeline.py``) at llama3-8b width, cut to PIPE_LAYERS layers,
# in f32 with TF32 off (the pipelined and the plain model then differ only
# by f32 roundings: GEMMs over microbatch row counts, gradients summed over
# microbatches), dense attention (the pipeline's stage body never calls
# flash): PIPE_ROWS rows x PIPE_T tokens (the last two right-padded by
# PIPE_PADS), PIPE_MICRO microbatches, on two ranks sharing the card over
# gloo (``chip_smoke.py --pipe-rank``; NCCL takes one rank per card).
# Rank 0 first runs the unpipelined ``apply`` at world size 1 on the same
# weights; then both ranks run the pipelined forward + backward. Held: the
# logits (valid positions) and every gradient (each stacked block leaf, ln_f,
# tok_emb, lm_head) in relative L2 within PIPE_REL, the loss within
# PIPE_LOSS_RTOL, and the ranks' logits and replicated gradients bit-equal.
# Reported: the seconds of forward + backward per rank, comm.staged_bytes,
# the peak memory per rank. (b) elastic EvoPPO at 4i's widths (POP) in one
# process: 2 emulated hosts x 4 slots; host 1 killed at boundary 2
# (restore_from="latest"): the 4-generation stream equals the unkilled
# run's bit for bit (fitness and members), the layout 4 slots x 16 members;
# MTTR, the snapshot's bytes and save seconds. (c) two ranks on the card
# over gloo (``chip_smoke.py --elastic-rank``), one pod-mode controller
# each, pop 64, generation_timeout ELASTIC_TIMEOUT_S: ``broadcast_seed``
# (rank 0 proposes ELASTIC_SEED, rank 1 999) gives rank 0's on both; their
# 2-generation stream equals (b)'s unkilled rows bit for bit; the parent
# SIGKILLs rank 1 once rank 0 committed the snapshot of generation 2, and
# rank 0's next dispatch raises MembershipChange within ELASTIC_TIMEOUT_S +
# ELASTIC_SLACK_S, counted under resilience/collective_timeouts_total; a
# fresh process (``chip_smoke.py --elastic-resume``) then runs
# train_elastic_pbt(resume=True) at world size 1 from that store and
# continues (b)'s unkilled stream bit for bit. (a) runs after 4u (c), when
# this process holds no 8B weights; (b) and (c) last on the 4h-4r side.
PIPE_LAYERS, PIPE_ROWS, PIPE_T, PIPE_MICRO, PIPE_SEED = 8, 8, 512, 4, 23
PIPE_PADS = (0, 0, 0, 0, 0, 0, 128, 200)
PIPE_REL = 1e-4  # relative L2 of the logits and of each gradient leaf
PIPE_LOSS_RTOL = 1e-5
PIPE_TIMEOUT_S = 400.0
ELASTIC_SEED = 11
ELASTIC_HEARTBEAT_S = 2.0
ELASTIC_TIMEOUT_S = 60.0  # the pod mode's generation_timeout
ELASTIC_SLACK_S = 15.0  # detection bound past it: a generation of the survivor's members
ELASTIC_CHILD_TIMEOUT_S = 300.0


def pipe_batch(torch, vocab):
    """PIPE_ROWS rows of seeded tokens, the last ones right-padded."""
    g = torch.Generator().manual_seed(PIPE_SEED)
    tokens = torch.randint(1, vocab, (PIPE_ROWS, PIPE_T), generator=g)
    mask = torch.ones((PIPE_ROWS, PIPE_T), dtype=torch.int32)
    for r, pad in enumerate(PIPE_PADS):
        if pad:
            mask[r, PIPE_T - pad:] = 0
            tokens[r, PIPE_T - pad:] = 0
    return tokens.cuda(), mask.cuda()


def pipe_loss(torch, logits, tokens, mask):
    """Mean next-token NLL over the pairs whose token and target are valid."""
    lp = torch.log_softmax(logits[:, :-1], -1).gather(-1, tokens[:, 1:, None])[..., 0]
    valid = (mask[:, 1:] * mask[:, :-1]).float()
    return -(lp * valid).sum() / valid.sum()


def digest(torch, t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def pipe_rank_child(rank: int, port: int, out_dir: str) -> None:
    """One rank of 4v (a) (``chip_smoke.py --pipe-rank RANK PORT DIR``): both
    ranks on card 0 over gloo. Rank 0 runs the plain model first and, after
    the pipelined step, receives rank 1's block gradients and holds
    everything; its numbers go to DIR/rank<RANK>.json."""
    import torch
    import torch.distributed as dist

    from agilerl_tpu_torch import ops
    from agilerl_tpu_torch.llm import model as M, presets
    from agilerl_tpu_torch.parallel import comm
    from agilerl_tpu_torch.parallel.multihost import init_multihost
    from agilerl_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        shard_stacked_blocks,
        stack_blocks,
    )
    from agilerl_tpu_torch.parallel.plan import ShardingPlan

    torch_settings(torch)
    torch.set_grad_enabled(True)
    torch.cuda.set_device(0)
    init_multihost(f"127.0.0.1:{port}", 2, rank)
    cfg = presets.preset("llama3-8b", n_layer=PIPE_LAYERS, max_seq_len=PIPE_T,
                         dtype=torch.float32, use_flash_attention=False, remat=False)
    tokens, mask = pipe_batch(torch, cfg.vocab_size)
    valid = mask.bool()
    L = cfg.n_layer
    out = {}
    if rank == 0:
        params = M.init_params(PIPE_SEED, cfg, device="cuda")
        leaves = [params[k] for k in params if k != "blocks"] + [
            t for blk in params["blocks"].values() for t in blk.values()]
        for t in leaves:
            t.requires_grad_(True)
        ops.reset_kernel_counters()
        torch.cuda.reset_peak_memory_stats()

        def plain():
            logits, _ = M.apply(cfg, params, tokens, attention_mask=mask)
            loss = pipe_loss(torch, logits, tokens, mask)
            return logits.detach(), loss.detach(), torch.autograd.grad(loss, leaves)

        (logits, loss, grads), out["plain_s"] = host_s(torch, plain)
        out["plain_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["plain_launches"] = ops.kernel_counters()
        ref = {"logits": logits[valid].cpu(), "loss": float(loss)}
        names = [k for k in params if k != "blocks"]
        ref.update({k: g.cpu() for k, g in zip(names, grads[:len(names)])})
        per = len(params["blocks"]["0"])
        keys = list(params["blocks"]["0"])
        block_grads = grads[len(names):]
        ref["blocks"] = {k: torch.stack([block_grads[i * per + j] for i in range(L)]).cpu()
                         for j, k in enumerate(keys)}
        del params, leaves, logits, grads, block_grads
        torch.cuda.empty_cache()
    dist.barrier()
    params = M.init_params(PIPE_SEED, cfg, device="cuda")
    mesh = ShardingPlan("pipe", {"pp": 2}).build_mesh()
    stacked = shard_stacked_blocks(stack_blocks(params, cfg), mesh, "pp")
    rest = {k: v for k, v in params.items() if k != "blocks"}
    del params
    torch.cuda.empty_cache()
    leaves = list(rest.values()) + list(stacked.values())
    for t in leaves:
        t.requires_grad_(True)
    ops.reset_kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    staged0 = comm.staged_bytes
    dist.barrier()

    def piped():
        logits = pipeline_apply(cfg, {**rest, "blocks": {}}, tokens, mesh, PIPE_MICRO,
                                attention_mask=mask, stacked=stacked)
        loss = pipe_loss(torch, logits, tokens, mask)
        return logits.detach(), loss.detach(), torch.autograd.grad(loss, leaves)

    (logits, loss, grads), out["pipe_s"] = host_s(torch, piped)
    out.update(staged_bytes=comm.staged_bytes - staged0, launches=ops.kernel_counters(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, loss=float(loss))
    names = list(rest)
    out["digests"] = {"logits": digest(torch, logits),
                      **{k: digest(torch, g) for k, g in zip(names, grads)}}
    block = dict(zip(stacked, grads[len(names):]))
    if rank == 1:
        for k in stacked:
            dist.send(block[k].detach().cpu().contiguous(), dst=0)
    else:
        mine = {k: v.detach() for k, v in block.items()}
        theirs = {}
        for k, v in stacked.items():
            buf = torch.empty(v.shape, dtype=v.dtype)
            dist.recv(buf, src=1)
            theirs[k] = buf.cuda()

        def rel(got, want):
            want = want.cuda()
            return float(torch.linalg.vector_norm(got.float() - want.float())
                         / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))

        rels = {"logits": rel(logits[valid], ref["logits"])}
        rels.update({k: rel(g, ref[k]) for k, g in zip(names, grads)})
        rels.update({f"blocks/{k}": rel(torch.cat([mine[k], theirs[k]]), ref["blocks"][k])
                     for k in stacked})
        out.update(rel=rels, plain_loss=ref["loss"],
                   logits_max_abs=float((logits[valid] - ref["logits"].cuda()).abs().max()))
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def run_children(args_of, n, work, timeout, what):
    """Start ``n`` copies of this script (``args_of(i)``), each in a session
    of its own with its output into WORK/child<i>.log; wait up to
    ``timeout`` s for all; print their logs; fail on a non-zero exit or a
    timeout. The processes are always killed and reaped."""
    procs = []
    try:
        for i in range(n):
            with open(work / f"child{i}.log", "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), *args_of(i)], stdout=f,
                    stderr=subprocess.STDOUT, start_new_session=True))
        deadline = time.perf_counter() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                pass
        for i in range(n):
            text = (work / f"child{i}.log").read_text()
            if text.strip():
                log(f"  {what} {i} log:\n{text.rstrip()}")
        check(all(p.returncode == 0 for p in procs),
              f"{what}: the processes exited {[p.returncode for p in procs]}")
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def run_pipeline(torch, ops, report):
    """Phase 4v (a). Returns the two ranks' kernel launches."""
    import shutil
    import tempfile

    log(f"phase 4v (a): GPipe pipeline, llama3-8b width, {PIPE_LAYERS} layers, f32, "
        f"{PIPE_ROWS} rows x {PIPE_T} (pads {PIPE_PADS[-2:]}), {PIPE_MICRO} microbatches, "
        "2 ranks on the card over gloo; the plain apply at world size 1 first")
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_pipe_"))
    try:
        port = free_port()
        run_children(lambda r: ["--pipe-rank", str(r), str(port), str(work)], 2, work,
                     PIPE_TIMEOUT_S, "pipe rank")
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0, r1 = ranks
    worst = max(r0["rel"].items(), key=lambda kv: kv[1])
    log(f"  pipelined fwd+bwd {[round(r['pipe_s'], 3) for r in ranks]} s per rank; plain "
        f"{r0['plain_s']:.3f} s; loss {r0['loss']:.7f} vs {r0['plain_loss']:.7f}; logits rel L2 "
        f"{r0['rel']['logits']:.3e} (max |d| {r0['logits_max_abs']:.3e}); worst gradient "
        f"{worst[0]} {worst[1]:.3e}; lm_head {r0['rel']['lm_head']:.3e}, tok_emb "
        f"{r0['rel']['tok_emb']:.3e}, ln_f {r0['rel']['ln_f']:.3e}; staged "
        f"{[r['staged_bytes'] for r in ranks]} B; peak {[round(r['peak_gb'], 2) for r in ranks]}"
        f" GB per rank ({r0['plain_peak_gb']:.2f} GB plain)")
    check(all(v <= PIPE_REL for v in r0["rel"].values()),
          f"4v (a): pipelined vs plain relative L2 past {PIPE_REL}: {worst}")
    check(abs(r0["loss"] - r0["plain_loss"]) <= PIPE_LOSS_RTOL * abs(r0["plain_loss"]),
          "4v (a): the pipelined loss disagrees with the plain model's")
    check(r0["digests"] == r1["digests"] and r0["loss"] == r1["loss"],
          "4v (a): the ranks' logits, loss or replicated gradients differ")
    report["pipeline"] = dict(
        layers=PIPE_LAYERS, rows=PIPE_ROWS, T=PIPE_T, micro=PIPE_MICRO, rel=r0["rel"],
        logits_max_abs=r0["logits_max_abs"], loss=[r0["loss"], r0["plain_loss"]],
        pipe_s=[r["pipe_s"] for r in ranks], plain_s=r0["plain_s"],
        staged_bytes=[r["staged_bytes"] for r in ranks], peak_gb=[r["peak_gb"] for r in ranks],
        plain_peak_gb=r0["plain_peak_gb"], launches=[r["launches"] for r in ranks])
    return [r["launches"] for r in ranks]


# 4x (c): the serving tier under make_grpo_plan(tp=2) on two ranks sharing the
# card over gloo (``chip_smoke.py --serve-rank``; NCCL takes one rank per
# card), llama3-8b widths cut to 4 layers, an f32 base (the placed and the
# unplaced decode differ only by f32 roundings): both generators' greedy
# tokens equal to rank 0's unplaced run token for token, each rank's dense
# caches and paged pool half of the whole, and no all-gather of a
# tp-sharded weight (the decode's only gathers are the logits' vocab halves)
SERVE_TP_LAYERS, SERVE_TP_ROWS, SERVE_TP_SEED = 4, 8, 31
SERVE_TP = dict(max_new_tokens=16, pad_id=0, eos_id=None, prompt_buckets=(128,),
                decode_chunk=8, temperature=0.0)
SERVE_TP_TIMEOUT_S = 400.0
# 4x (c)'s fsdp serving: 4 new tokens (each step gathers every weight through
# host buffers: 2.2-3.2 s a step a rank at Qwen2-0.5B's widths, 16 tokens
# took 38-54 s a generator on an H100 80GB HBM3 at 700 W)
SERVE_FSDP = dict(SERVE_TP, max_new_tokens=4)
# the placed learns of 4x (c) and (d): rows x tokens of one GRPO batch (group
# 2, the second half of each row the completion), rank-8 adapters on wq / wv
# (the actor's B drawn from N(0, 0.05^2), so that the loss and the KL are not
# 0 up to rounding), lr 1e-3; held to the unplaced learn of rank 0: loss at
# rtol 1e-5 (tests/test_torch_sharded.py's bound) + atol PLACED_LOSS_ATOL (the
# first step's loss is a mean of ~256 ratio x advantage terms of order 1
# whose z-scored advantages cancel: its f32 rounding), and the gradient the
# optimizer step is handed (Adam's first step is a sign step, 4u (c)) within
# PLACED_GRAD_REL of it in relative L2 (f32 sums over the rows split
# between ranks and summed by gloo)
PLACED_LEARN_ROWS, PLACED_LEARN_T, PLACED_GRAD_REL, PLACED_LOSS_ATOL = 8, 64, 1e-4, 1e-5


def placed_learn(torch, cfg, params, plan, seed):
    """One GRPO learn on a batch drawn from ``seed``, placed by ``plan``
    (None: unplaced): loss, the gradient handed to the optimizer (flat
    numpy leaves), seconds, this rank's kernel launches and the ops of its
    all-gathers (``collective_log``)."""
    import numpy as np

    from agilerl_tpu_torch import ops
    from agilerl_tpu_torch.algorithms.grpo import GRPO
    from agilerl_tpu_torch.parallel.comm import collective_log

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (PLACED_LEARN_ROWS, PLACED_LEARN_T))
    lm = np.zeros((PLACED_LEARN_ROWS, PLACED_LEARN_T - 1), np.float32)
    lm[:, PLACED_LEARN_T // 2:] = 1
    rewards = rng.normal(size=(PLACED_LEARN_ROWS // 2, 2)).astype(np.float32)
    agent = GRPO(config=cfg, base_params=params, pad_token_id=0, seed=0, lr=1e-3,
                 batch_size=PLACED_LEARN_ROWS, group_size=2, lora_rank=LORA_RANK,
                 lora_targets=("wq", "wv"))
    g = torch.Generator(device=agent.dev).manual_seed(seed)
    for layer in agent.actor.params["blocks"].values():
        for ab in layer.values():
            ab["B"].copy_(0.05 * torch.randn(ab["B"].shape, generator=g, device=agent.dev))
    if plan is not None:
        agent.to_mesh(plan=plan)
    grads = []
    agent.optimizer.tx = capture_grads(agent.optimizer.tx, grads)
    ops.reset_kernel_counters()
    with collective_log() as log, torch.enable_grad():
        (loss, _), s = host_s(torch, lambda: agent.learn((ids, lm, rewards)))
    return dict(loss=float(loss), grads=grads[0], s=s,
                launches={k: v for k, v in ops.kernel_counters().items() if v},
                gather_ops=sorted({op for op, _ in log if "gather" in op}))


def save_grads(out, out_dir, rank):
    """Move the learns' gradients out of ``out`` into DIR/grads<RANK>_<key>.npz."""
    import numpy as np

    for k, v in out.items():
        if isinstance(v, dict) and "grads" in v:
            np.savez(Path(out_dir, f"grads{rank}_{k}.npz"), *v.pop("grads"))


def load_grads(out, out_dir, rank):
    """The inverse of save_grads, for the keys whose file is there."""
    import numpy as np

    for k, v in out.items():
        f = Path(out_dir, f"grads{rank}_{k}.npz")
        if isinstance(v, dict) and f.exists():
            with np.load(f) as z:
                v["grads"] = [z[f"arr_{i}"] for i in range(len(z.files))]
    return out


def learn_agreement(placed, unplaced):
    """(loss difference, gradient relative L2) of a placed learn."""
    import numpy as np

    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(placed["grads"], unplaced["grads"]))
    den = sum(float((b ** 2).sum()) for b in unplaced["grads"])
    return abs(placed["loss"] - unplaced["loss"]), float(np.sqrt(num / max(den, 1e-30)))


def weight_bytes(tree):
    """(bytes this rank holds of a weight tree, of which in replicated leaves)."""
    from agilerl_tpu_torch.utils.tree import tree_leaves

    held = repl = 0
    for w in tree_leaves(tree):
        local = w.to_local() if hasattr(w, "to_local") else w
        n = local.numel() * local.element_size()
        held += n
        if not any(p.is_shard() for p in getattr(w, "placements", ())):
            repl += n
    return held, repl


def serve_rank_child(rank: int, port: int, out_dir: str) -> None:
    """One rank of 4x (c) (``chip_smoke.py --serve-rank RANK PORT DIR``): rank
    0 serves unplaced first; both then serve under the tp plan. Then the
    fsdp plan, on 4x (d)'s Qwen2-0.5B-width model (fsdp serving gathers
    every weight at every decode step through host buffers: at llama3-8b's
    vocab and width that is ~4 GB a step a rank): rank 0 serves and learns
    unplaced, both serve and learn under the plan. Its numbers go to
    DIR/rank<RANK>.json (the gradients to DIR/grads<RANK>_<key>.npz)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from agilerl_tpu_torch.llm import model as M, presets
    from agilerl_tpu_torch.llm.serving import BucketedGenerator, ContinuousGenerator
    from agilerl_tpu_torch.parallel.comm import collective_log
    from agilerl_tpu_torch.parallel.multihost import init_multihost
    from agilerl_tpu_torch.parallel.plan import make_grpo_plan

    torch_settings(torch)
    torch.cuda.set_device(0)
    init_multihost(f"127.0.0.1:{port}", 2, rank)
    cfg = presets.preset("llama3-8b", n_layer=SERVE_TP_LAYERS, max_seq_len=256,
                         dtype=torch.float32)
    out = {}

    def prompts(cfg):
        rng = np.random.default_rng(SERVE_TP_SEED)
        return [rng.integers(1, cfg.vocab_size, int(n))
                for n in rng.integers(20, 120, SERVE_TP_ROWS)]

    def serve(cfg, params, plan, knobs=SERVE_TP):
        """Both generators' greedy tokens, seconds and the caches they
        allocated; the collectives they ran."""
        bg = BucketedGenerator(cfg, row_buckets=(SERVE_TP_ROWS,), sharding_plan=plan,
                               device="cuda", **knobs)
        cg = ContinuousGenerator(cfg, slots=SERVE_TP_ROWS, block_size=32, sharding_plan=plan,
                                 device="cuda", **knobs)
        caches, real = [], bg._kv
        bg._kv = lambda group, make: caches.append(real(group, make)) or caches[-1]
        placed = bg.place_params(params)
        seqs = prompts(cfg)
        res = {}
        with collective_log() as log:
            (toks, _, _), res["bucketed_s"] = host_s(torch, lambda: bg.generate(
                seqs, None, placed, greedy=True))
            (ctoks, _, _), res["continuous_s"] = host_s(torch, lambda: cg.generate(
                seqs, 0, placed, greedy=True))
        res.update(bucketed=toks.tolist(), continuous=ctoks.tolist(),
                   dense_bytes=M.cache_bytes(caches[0]), pool_bytes=cg.pool_bytes,
                   gathers=sorted({shape for op, shape in log if "gather" in op}),
                   collectives=sorted({op for op, _ in log}))
        res["weight_bytes"], res["replicated_bytes"] = weight_bytes(placed)
        res["gather_ops"] = sorted({op for op, _ in log if "gather" in op})
        if plan is not None:
            res["tp_weights"] = sorted({tuple(w.to_local().shape)
                                        for blk in placed["blocks"].values()
                                        for w in blk.values()
                                        if any(pl.is_shard() for pl in w.placements)}
                                       | {tuple(placed[k].to_local().shape)
                                          for k in ("tok_emb", "lm_head") if k in placed})
            res["dense_placements"] = str(tuple(caches[0].k.placements))
            res["pool_placements"] = str(tuple(cg._pool.k.placements))
        return res

    params = M.init_params(SERVE_TP_SEED, cfg, device="cuda")
    if rank == 0:
        out["unplaced"] = serve(cfg, params, None)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    out["placed"] = serve(cfg, params, make_grpo_plan(tp=2))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    qcfg = uneven_config(torch)
    qparams = M.init_params(0, qcfg, device="cuda")
    if rank == 0:
        out["fsdp_unplaced"] = serve(qcfg, qparams, None, SERVE_FSDP)
        out["unplaced_learn"] = placed_learn(torch, qcfg, qparams, None, SERVE_TP_SEED)
    dist.barrier()
    out["fsdp"] = serve(qcfg, qparams, make_grpo_plan(fsdp=2), SERVE_FSDP)
    out["fsdp_learn"] = placed_learn(torch, qcfg, qparams, make_grpo_plan(fsdp=2), SERVE_TP_SEED)
    save_grads(out, out_dir, rank)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


LEARN_KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                 "fused_logprob_fwd", "fused_logprob_dh")


def check_placed_learn(what, placed, unplaced):
    """A placed learn against the unplaced one (PLACED_LEARN_*): loss and
    gradient, only comm's all-gathers, and every kernel of the learn
    launched on this rank."""
    dl, dg = learn_agreement(placed, unplaced)
    log(f"  {what}: loss {placed['loss']:.8e} vs unplaced {unplaced['loss']:.8e} (|d| "
        f"{dl:.2e}), gradient rel. L2 {dg:.2e}, {placed['s']:.2f} s vs {unplaced['s']:.2f} s "
        f"unplaced, all-gathers {placed['gather_ops']}, launches {placed['launches']}")
    check(dl <= 1e-5 * abs(unplaced["loss"]) + PLACED_LOSS_ATOL and dg <= PLACED_GRAD_REL,
          f"{what}: loss |d| {dl}, gradient rel. L2 {dg} ({PLACED_GRAD_REL})")
    check(placed["gather_ops"] == ["comm.all_gather_cat"],
          f"{what}: all-gathers {placed['gather_ops']}")
    check(all(placed["launches"].get(k, 0) > 0 for k in LEARN_KERNELS),
          f"{what}: launches {placed['launches']}")
    return dict(loss=placed["loss"], unplaced_loss=unplaced["loss"], loss_diff=dl, grad_rel_l2=dg,
                s=placed["s"], unplaced_s=unplaced["s"], launches=placed["launches"])


def run_serving_tp(torch, report):
    """Phase 4x (c) in two child processes."""
    import shutil
    import tempfile

    log(f"phase 4x (c): BucketedGenerator and ContinuousGenerator under make_grpo_plan(tp=2) "
        f"(llama3-8b width, {SERVE_TP_LAYERS} layers) and make_grpo_plan(fsdp=2) (Qwen2-0.5B "
        f"widths, {UNEVEN_LAYERS} layers), then a GRPO learn under make_grpo_plan(fsdp=2) "
        f"({PLACED_LEARN_ROWS} x {PLACED_LEARN_T}); f32, {SERVE_TP_ROWS} prompts, "
        f"{SERVE_TP['max_new_tokens']} new tokens (fsdp: {SERVE_FSDP['max_new_tokens']}), 2 ranks "
        f"on the card over gloo; rank 0 serves and learns unplaced first")
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_tp_"))
    try:
        port = free_port()
        run_children(lambda r: ["--serve-rank", str(r), str(port), str(work)], 2, work,
                     SERVE_TP_TIMEOUT_S, "serve rank")
        ranks = [load_grads(json.loads((work / f"rank{r}.json").read_text()), work, r)
                 for r in range(2)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    from agilerl_tpu_torch.llm import presets

    ref = ranks[0]["unplaced"]
    placed = [r["placed"] for r in ranks]
    vocab_half = presets.preset("llama3-8b").vocab_size // 2
    for r, got in enumerate(placed):
        for name in ("bucketed", "continuous"):
            check(got[name] == ref[name], f"4x (c) rank {r}: {name} tokens differ from unplaced")
        check(2 * got["dense_bytes"] == ref["dense_bytes"] and
              2 * got["pool_bytes"] == ref["pool_bytes"],
              f"4x (c) rank {r}: cache {got['dense_bytes']} / pool {got['pool_bytes']} B of "
              f"{ref['dense_bytes']} / {ref['pool_bytes']} B")
        shapes = {tuple(x) for x in got["gathers"]}
        tp_weights = {tuple(x) for x in got["tp_weights"]}
        check(not shapes & tp_weights and all(x[-1] == vocab_half for x in shapes),
              f"4x (c) rank {r}: gathers {sorted(shapes)} (tp-sharded weights "
              f"{sorted(tp_weights)})")
    log(f"  tokens equal to unplaced on both ranks; dense cache {placed[0]['dense_bytes']} B "
        f"and pool {placed[0]['pool_bytes']} B per rank of {ref['dense_bytes']} / "
        f"{ref['pool_bytes']} B ({placed[0]['dense_placements']} / "
        f"{placed[0]['pool_placements']}); gathers {placed[0]['gathers']}; collectives "
        f"{placed[0]['collectives']}; bucketed {[round(p['bucketed_s'], 2) for p in placed]} s "
        f"placed vs {ref['bucketed_s']:.2f} s unplaced, continuous "
        f"{[round(p['continuous_s'], 2) for p in placed]} s vs {ref['continuous_s']:.2f} s; peak "
        f"{[round(r['peak_gb'], 2) for r in ranks]} GB per rank")
    report["serving_tp"] = dict(
        layers=SERVE_TP_LAYERS, rows=SERVE_TP_ROWS, new_tokens=SERVE_TP["max_new_tokens"],
        dense_bytes=[p["dense_bytes"] for p in placed], pool_bytes=[p["pool_bytes"] for p in placed],
        whole_dense_bytes=ref["dense_bytes"], whole_pool_bytes=ref["pool_bytes"],
        gathers=placed[0]["gathers"], collectives=placed[0]["collectives"],
        bucketed_s=[p["bucketed_s"] for p in placed], continuous_s=[p["continuous_s"] for p in placed],
        unplaced_s=[ref["bucketed_s"], ref["continuous_s"]], peak_gb=[r["peak_gb"] for r in ranks])

    fsdp, fref = [r["fsdp"] for r in ranks], ranks[0]["fsdp_unplaced"]
    for r, got in enumerate(fsdp):
        for name in ("bucketed", "continuous"):
            check(got[name] == fref[name],
                  f"4x (c) fsdp rank {r}: {name} tokens differ from unplaced")
        sharded, whole = got["weight_bytes"] - got["replicated_bytes"], fref["weight_bytes"]
        check(2 * sharded == whole - got["replicated_bytes"],
              f"4x (c) fsdp rank {r}: weights {got['weight_bytes']} B of {whole} B "
              f"({got['replicated_bytes']} B replicated)")
        check(got["gather_ops"] == ["comm.all_gather_cat"],
              f"4x (c) fsdp rank {r}: all-gathers {got['gather_ops']}")
    log(f"  fsdp2 (Qwen2-0.5B widths, {UNEVEN_LAYERS} layers, f32): tokens equal to unplaced on "
        f"both ranks; weights {fsdp[0]['weight_bytes']} B per rank of {fref['weight_bytes']} B "
        f"({fsdp[0]['replicated_bytes']} B replicated: the norms and biases); all-gathers "
        f"{fsdp[0]['gather_ops']} of shapes {fsdp[0]['gathers']}; bucketed "
        f"{[round(p['bucketed_s'], 2) for p in fsdp]} s vs {fref['bucketed_s']:.2f} s unplaced, "
        f"continuous {[round(p['continuous_s'], 2) for p in fsdp]} s vs "
        f"{fref['continuous_s']:.2f} s")
    report["serving_fsdp"] = dict(
        layers=UNEVEN_LAYERS, unplaced_s=[fref["bucketed_s"], fref["continuous_s"]],
        weight_bytes=[p["weight_bytes"] for p in fsdp], whole_weight_bytes=fref["weight_bytes"],
        replicated_bytes=fsdp[0]["replicated_bytes"], gather_ops=fsdp[0]["gather_ops"],
        gathers=fsdp[0]["gathers"], dense_bytes=[p["dense_bytes"] for p in fsdp],
        bucketed_s=[p["bucketed_s"] for p in fsdp], continuous_s=[p["continuous_s"] for p in fsdp])
    report["fsdp_learn"] = [check_placed_learn(f"4x (c) fsdp2 learn rank {r}",
                                               ranks[r]["fsdp_learn"], ranks[0]["unplaced_learn"])
                            for r in range(2)]


# 4x (d): a tp split that divides neither head count. Qwen2-0.5B's widths
# (config.json of Qwen/Qwen2-0.5B: 14 query heads, 2 KV heads, head dim 64,
# d_model 896, d_ff 4,864, vocab 151,936, tied embeddings, qkv bias, rope
# theta 1e6), cut to 2 layers, f32, seed-0 random weights; grpo-tp4 on four
# gloo ranks of the card: 8 prompts x 16 new tokens through both generators
# and one placed learn, against rank 0's unplaced run; then one learn under
# make_grpo_plan(fsdp=2, tp=2) (tp2 divides both head counts), held to the
# same unplaced learn by the same rules.
QWEN2_05B = dict(vocab_size=151_936, n_head=14, n_kv_head=2, d_model=896, d_ff=4_864,
                 rope_theta=1_000_000.0, tie_embeddings=True, qkv_bias=True)
UNEVEN_LAYERS, UNEVEN_RANKS, UNEVEN_TIMEOUT_S = 2, 4, 400.0


def heads_whole_bytes(cfg, tp):
    """Bytes a rank holds beyond its 1/tp share when a tp split keeps the
    attention projections (and their biases) whole: (1 - 1/tp) of them, in
    the blocks' dtype, over every layer."""
    import torch

    D, q, kv = cfg.d_model, cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    per_layer = 2 * D * q + 2 * D * kv + ((q + 2 * kv) if cfg.qkv_bias else 0)
    size = torch.empty((), dtype=cfg.dtype).element_size()
    return per_layer * cfg.n_layer * size * (1 - 1 / tp)


def uneven_config(torch):
    from agilerl_tpu_torch.llm.model import GPTConfig

    return GPTConfig(n_layer=UNEVEN_LAYERS, max_seq_len=256, dtype=torch.float32,
                     use_flash_attention=True, **QWEN2_05B)


def uneven_rank_child(rank: int, port: int, out_dir: str) -> None:
    """One rank of 4x (d) (``chip_smoke.py --uneven-rank RANK PORT DIR``):
    rank 0 serves and learns unplaced first; every rank then serves and
    learns under make_grpo_plan(tp=4), and learns under
    make_grpo_plan(fsdp=2, tp=2). Its numbers go to DIR/rank<RANK>.json (the
    gradients to DIR/grads<RANK>_<key>.npz)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from agilerl_tpu_torch.llm import model as M
    from agilerl_tpu_torch.llm.serving import BucketedGenerator, ContinuousGenerator
    from agilerl_tpu_torch.parallel.comm import collective_log
    from agilerl_tpu_torch.parallel.multihost import init_multihost
    from agilerl_tpu_torch.parallel.plan import make_grpo_plan

    torch_settings(torch)
    torch.cuda.set_device(0)
    init_multihost(f"127.0.0.1:{port}", UNEVEN_RANKS, rank)
    cfg = uneven_config(torch)
    rng = np.random.default_rng(SERVE_TP_SEED)
    seqs = [rng.integers(1, cfg.vocab_size, int(n)) for n in rng.integers(20, 120, SERVE_TP_ROWS)]
    params = M.init_params(0, cfg, device="cuda")
    plan = make_grpo_plan(tp=UNEVEN_RANKS)
    out = {}

    def serve(plan):
        bg = BucketedGenerator(cfg, row_buckets=(SERVE_TP_ROWS,), sharding_plan=plan,
                               device="cuda", **SERVE_TP)
        cg = ContinuousGenerator(cfg, slots=SERVE_TP_ROWS, block_size=32, sharding_plan=plan,
                                 device="cuda", **SERVE_TP)
        placed = bg.place_params(params)
        res = {}
        with collective_log() as log:
            (toks, _, _), res["bucketed_s"] = host_s(torch, lambda: bg.generate(
                seqs, None, placed, greedy=True))
            (ctoks, _, _), res["continuous_s"] = host_s(torch, lambda: cg.generate(
                seqs, 0, placed, greedy=True))
        res.update(bucketed=toks.tolist(), continuous=ctoks.tolist(),
                   gather_ops=sorted({op for op, _ in log if "gather" in op}),
                   weight_bytes=weight_bytes(placed)[0], pool_bytes=cg.pool_bytes)
        if plan is not None:
            blk = placed["blocks"]["0"]
            res["placements"] = {k: str(tuple(blk[k].placements)) for k in ("wq", "wk", "w_up")}
            res["pool_placements"] = str(tuple(cg._pool.k.placements))
        return res

    if rank == 0:
        out["unplaced"] = serve(None)
        out["unplaced_learn"] = placed_learn(torch, cfg, params, None, SERVE_TP_SEED)
    dist.barrier()
    out["placed"] = serve(plan)
    out["placed_learn"] = placed_learn(torch, cfg, params, plan, SERVE_TP_SEED)
    torch.cuda.empty_cache()
    out["fsdp_tp_learn"] = placed_learn(torch, cfg, params, make_grpo_plan(fsdp=2, tp=2),
                                        SERVE_TP_SEED)
    save_grads(out, out_dir, rank)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def run_uneven_tp(torch, ops, report):
    """Phase 4x (d) in four child processes (on the 4h-4r side). Returns
    rank 0's launches in its placed learn."""
    import shutil
    import tempfile

    log(f"phase 4x (d): grpo-tp4 over Qwen2-0.5B's 14 query and 2 KV heads (head dim 64, d "
        f"{QWEN2_05B['d_model']}, d_ff {QWEN2_05B['d_ff']}), {UNEVEN_LAYERS} f32 layers: both "
        f"generators ({SERVE_TP_ROWS} prompts x {SERVE_TP['max_new_tokens']} new tokens) and a "
        f"GRPO learn ({PLACED_LEARN_ROWS} x {PLACED_LEARN_T}) on {UNEVEN_RANKS} gloo ranks of "
        "the card, then a learn under make_grpo_plan(fsdp=2, tp=2); rank 0 unplaced first")
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_uneven_"))
    try:
        port = free_port()
        run_children(lambda r: ["--uneven-rank", str(r), str(port), str(work)], UNEVEN_RANKS,
                     work, UNEVEN_TIMEOUT_S, "uneven-tp rank")
        ranks = [load_grads(json.loads((work / f"rank{r}.json").read_text()), work, r)
                 for r in range(UNEVEN_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ref = ranks[0]["unplaced"]
    for r, rank in enumerate(ranks):
        got = rank["placed"]
        for name in ("bucketed", "continuous"):
            check(got[name] == ref[name], f"4x (d) rank {r}: {name} tokens differ from unplaced")
        check(got["placements"] == {"wq": "(Replicate(),)", "wk": "(Replicate(),)",
                                    "w_up": "(Shard(dim=1),)"}
              and got["pool_placements"] == "(Replicate(),)" and got["pool_bytes"] ==
              ref["pool_bytes"] and got["gather_ops"] == ["comm.all_gather_cat"],
              f"4x (d) rank {r}: {got}")
    placed = ranks[0]["placed"]
    log(f"  tokens equal to unplaced on all {UNEVEN_RANKS} ranks; placements {placed['placements']} "
        f"(attention whole over tp, MLP tp-parallel), pool {placed['pool_placements']}; weights "
        f"{placed['weight_bytes']} B per rank of {ref['weight_bytes']} B; all-gathers "
        f"{placed['gather_ops']}; bucketed {placed['bucketed_s']:.2f} s vs {ref['bucketed_s']:.2f} "
        f"s unplaced, continuous {placed['continuous_s']:.2f} s vs {ref['continuous_s']:.2f} s")
    learns = [check_placed_learn(f"4x (d) tp4 learn rank {r}", ranks[r]["placed_learn"],
                                 ranks[0]["unplaced_learn"]) for r in range(UNEVEN_RANKS)]
    fsdp_tp = [check_placed_learn(f"4x (d) fsdp2 x tp2 learn rank {r}", ranks[r]["fsdp_tp_learn"],
                                  ranks[0]["unplaced_learn"]) for r in range(UNEVEN_RANKS)]
    from agilerl_tpu_torch.llm import presets
    from agilerl_tpu_torch.llm.model import GPTConfig

    cost = {"qwen2-0.5b (24 layers, bf16) tp4": heads_whole_bytes(
                GPTConfig(n_layer=24, dtype=torch.bfloat16, **QWEN2_05B), 4),
            "qwen2-7b (bf16) tp8": heads_whole_bytes(presets.preset("qwen2-7b"), 8)}
    log(f"  attention whole over tp costs each rank, beyond its 1/tp share of the weights: "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in cost.items()))
    report["uneven_tp"] = dict(
        layers=UNEVEN_LAYERS, ranks=UNEVEN_RANKS, placements=placed["placements"],
        weight_bytes=[r["placed"]["weight_bytes"] for r in ranks],
        whole_weight_bytes=ref["weight_bytes"], gather_ops=placed["gather_ops"],
        bucketed_s=[r["placed"]["bucketed_s"] for r in ranks],
        continuous_s=[r["placed"]["continuous_s"] for r in ranks],
        unplaced_s=[ref["bucketed_s"], ref["continuous_s"]], learns=learns,
        fsdp_tp_learns=fsdp_tp, heads_whole_bytes=cost)
    launches = {k: 0 for k in ops.kernel_counters()}
    launches.update(ranks[0]["placed_learn"]["launches"])
    return launches


def elastic_engine(torch):
    return evo_ppo(torch, POP)


def elastic_rank_child(rank: int, port: int, work: str) -> None:
    """One rank of 4v (c) (``chip_smoke.py --elastic-rank RANK PORT DIR``):
    agree on the seed, run 2 generations in pod mode, write DIR/rank<R>.json
    and DIR/ready<R>; rank 1 then waits to be killed, rank 0 waits for
    DIR/go and runs one more generation, which must raise MembershipChange."""
    import torch

    from agilerl_tpu_torch.observability import get_registry
    from agilerl_tpu_torch.parallel.elastic import ElasticPBTController, EmulatedHost, device_slots
    from agilerl_tpu_torch.parallel.multihost import broadcast_seed, init_multihost
    from agilerl_tpu_torch.resilience.membership import MembershipChange

    torch_settings(torch)
    torch.cuda.set_device(0)
    init_multihost(f"127.0.0.1:{port}", 2, rank)
    seed = broadcast_seed(ELASTIC_SEED if rank == 0 else 999)
    ctl = ElasticPBTController(elastic_engine(torch), POP["pop"], Path(work, "store"), seed=seed,
                               hosts=[EmulatedHost(rank, device_slots(1))],
                               heartbeat_timeout=ELASTIC_HEARTBEAT_S,
                               generation_timeout=ELASTIC_TIMEOUT_S)
    t0 = time.perf_counter()
    hist = ctl.run(2)
    out = dict(seed=seed, hist=hist, layout=ctl.layout(), run_s=time.perf_counter() - t0,
               snapshots=[s.step for s in ctl.manager.snapshots()])
    Path(work, f"rank{rank}.json").write_text(json.dumps(out))
    Path(work, f"ready{rank}").write_text("")
    if rank == 1:
        time.sleep(ELASTIC_CHILD_TIMEOUT_S)  # killed before this ends
        os._exit(3)
    while not Path(work, "go").exists():
        time.sleep(0.05)
    reg = get_registry()
    before = reg.counter("resilience/collective_timeouts_total").value
    t0 = time.perf_counter()
    try:
        ctl.step_generation()
        raised = None
    except MembershipChange as e:
        raised = str(e)
    out.update(raised=raised, detect_s=time.perf_counter() - t0,
               timeouts=reg.counter("resilience/collective_timeouts_total").value - before)
    Path(work, "rank0.json").write_text(json.dumps(out))
    # the group is broken: leave without tearing it down
    os._exit(0)


def elastic_resume_child(work: str) -> None:
    """4v (c)'s fresh process (``chip_smoke.py --elastic-resume DIR``): world
    size 1, ``train_elastic_pbt(resume=True)`` for 2 generations from the
    store; its fitness history into DIR/resumed.json."""
    import torch

    from agilerl_tpu_torch.parallel.elastic import device_slots, make_emulated_hosts
    from agilerl_tpu_torch.training import train_elastic_pbt

    torch_settings(torch)
    t0 = time.perf_counter()
    ctl = train_elastic_pbt(elastic_engine(torch), POP["pop"], 2, Path(work, "store"),
                            seed=0, hosts=make_emulated_hosts(1, device_slots(1)),
                            heartbeat_timeout=ELASTIC_HEARTBEAT_S, resume=True)
    Path(work, "resumed.json").write_text(json.dumps(dict(
        hist=ctl.fitness_history, generation=ctl.generation, layout=ctl.layout(),
        s=time.perf_counter() - t0)))


def run_elastic(torch, ops, report):
    """Phase 4v (b) and (c), on the 4h-4r side. Returns the launches of the
    one-process runs (the engine launches none of the seven kernels)."""
    import shutil
    import tempfile

    import numpy as np

    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.parallel.elastic import (
        ElasticPBTController,
        device_slots,
        make_emulated_hosts,
    )
    from agilerl_tpu_torch.parallel.generation import population_state_dict
    from agilerl_tpu_torch.resilience import FaultInjector

    out = report.setdefault("elastic", {})
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    try:
        log(f"phase 4v (b): elastic EvoPPO, pop {POP['pop']} x {POP['num_envs']} envs x "
            f"{POP['rollout_len']} steps, 2 emulated hosts x 4 slots, host 1 killed at "
            "boundary 2 (restore from the latest snapshot), beside the unkilled run")

        def controller(store, **kw):
            return ElasticPBTController(
                elastic_engine(torch), POP["pop"], work / store, seed=ELASTIC_SEED,
                hosts=make_emulated_hosts(2, device_slots(8)),
                heartbeat_timeout=ELASTIC_HEARTBEAT_S, **kw)

        ops.reset_kernel_counters()
        ref = controller("ref")
        want, t_ref = host_s(torch, lambda: ref.run(4))
        reg = MetricsRegistry()
        inj = FaultInjector(kill_host_at={2: 1})
        kill = controller("kill", fault_injector=inj, restore_from="latest", registry=reg)
        got, t_kill = host_s(torch, lambda: kill.run(4))
        launches = ops.kernel_counters()
        same = got == want and all(np.array_equal(a, b) for a, b in zip(
            population_state_dict(kill.pop)["leaves"], population_state_dict(ref.pop)["leaves"]))
        snap = kill.manager.latest()
        mttr = reg.gauge("elastic/mttr_s").value
        save_s = reg.gauge("resilience/snapshot_time_s").value
        log(f"  unkilled {t_ref:.2f} s, killed {t_kill:.2f} s for 4 generations; bit for bit: "
            f"{same}; layout {kill.layout()}; MTTR {mttr:.3f} s (lease {ELASTIC_HEARTBEAT_S} s); "
            f"snapshot {snap.nbytes / 1e6:.2f} MB saved in {save_s:.3f} s; restored "
            f"{reg.counter('elastic/members_restored_total').value:.0f}; best fitness "
            f"{max(want[-1]):.2f}")
        check(inj.hosts_killed == [(2, 1)], "4v (b): the scripted kill did not happen")
        check(same, "4v (b): the killed run's stream or members differ from the unkilled run")
        check(kill.layout() == {"devices": 4, "pop": POP["pop"],
                                "members_per_device": POP["pop"] // 4},
              f"4v (b): layout {kill.layout()}")
        check(reg.counter("resilience/collective_timeouts_total").value >= 1
              and reg.counter("elastic/members_restored_total").value == POP["pop"] // 2,
              "4v (b): the loss was not detected or the members not restored")
        check(all(np.isfinite(f) for row in want for f in row), "4v (b): fitness not finite")
        out["emulated"] = dict(bit_for_bit=same, unkilled_s=t_ref, killed_s=t_kill, mttr_s=mttr,
                               snapshot_bytes=snap.nbytes, snapshot_save_s=save_s,
                               layout=kill.layout(), fitness_best=max(want[-1]))

        log(f"phase 4v (c): 2 ranks on the card over gloo, one pod-mode controller each, pop "
            f"{POP['pop']}, generation_timeout {ELASTIC_TIMEOUT_S} s; rank 1 SIGKILLed at the "
            "generation-2 snapshot; then a fresh process resumes at world size 1")
        port = free_port()
        procs = []
        try:
            for r in range(2):
                with open(work / f"rank{r}.log", "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()), "--elastic-rank", str(r),
                         str(port), str(work)], stdout=f, stderr=subprocess.STDOUT,
                        start_new_session=True))
            deadline = time.perf_counter() + ELASTIC_CHILD_TIMEOUT_S
            while not all((work / f"ready{r}").exists() for r in range(2)):
                check(all(p.poll() is None for p in procs) and time.perf_counter() < deadline,
                      f"4v (c): a rank ended or stalled before generation 2: "
                      f"{[p.poll() for p in procs]}\n"
                      + "\n".join((work / f"rank{r}.log").read_text() for r in range(2)))
                time.sleep(0.05)
            os.killpg(procs[1].pid, signal.SIGKILL)
            procs[1].wait()
            (work / "go").write_text("")
            try:
                procs[0].wait(timeout=ELASTIC_TIMEOUT_S + ELASTIC_SLACK_S + 30.0)
            except subprocess.TimeoutExpired:
                pass
            for r in range(2):
                text = (work / f"rank{r}.log").read_text()
                if text.strip():
                    log(f"  elastic rank {r} log:\n{text.rstrip()}")
            check(procs[0].returncode == 0, f"4v (c): rank 0 exited {procs[0].returncode}")
        finally:
            for p in procs:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
        r0 = ranks[0]
        run_children(lambda _: ["--elastic-resume", str(work)], 1, work,
                     ELASTIC_CHILD_TIMEOUT_S, "elastic resume")
        resumed = json.loads((work / "resumed.json").read_text())
        log(f"  seeds {[r['seed'] for r in ranks]}; pod stream == (b)'s unkilled rows: "
            f"{[r['hist'] == want[:2] for r in ranks]}; layout {r0['layout']}; 2 generations "
            f"{[round(r['run_s'], 2) for r in ranks]} s per rank; snapshots {r0['snapshots']}; "
            f"after the kill rank 0 raised in {r0['detect_s']:.3f} s (timeouts counted "
            f"{r0['timeouts']:.0f}): {str(r0['raised'])[:120]}; resumed at world size 1 in "
            f"{resumed['s']:.2f} s: rows 3-4 == unkilled: {resumed['hist'][2:] == want[2:]}")
        check([r["seed"] for r in ranks] == [ELASTIC_SEED] * 2, "4v (c): broadcast_seed")
        check(all(r["hist"] == want[:2] for r in ranks),
              "4v (c): the pod stream differs from (b)'s unkilled stream")
        check(r0["layout"] == {"devices": 2, "pop": POP["pop"],
                               "members_per_device": POP["pop"] // 2},
              f"4v (c): layout {r0['layout']}")
        check(r0["raised"] is not None and r0["timeouts"] >= 1
              and r0["detect_s"] <= ELASTIC_TIMEOUT_S + ELASTIC_SLACK_S,
              "4v (c): the lost rank was not detected as a MembershipChange in time")
        check(resumed["generation"] == 4 and resumed["hist"] == want,
              "4v (c): the resumed run does not continue the unkilled stream")
        out["pod"] = dict(seeds=[r["seed"] for r in ranks], bit_for_bit=True,
                          run_s=[r["run_s"] for r in ranks], detect_s=r0["detect_s"],
                          raised=r0["raised"], timeouts=r0["timeouts"],
                          resumed_s=resumed["s"], resumed_layout=resumed["layout"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ------------------------------- phase 4w ---------------------------------- #
# The port's tooling over the main path. (a) The compile cache: phase 2
# builds the four libraries into a fresh store (AGILERL_TPU_COMPILE_CACHE,
# which every child process inherits), then a child process
# (``chip_smoke.py --warm-child STORE OUT``, alongside phase 3) loads all
# four from it with no nvcc build under CompileGuard(), launches #1 and #5
# once each against their plain versions, and in a copy of the store skips
# a planted torn entry (a newer, truncated library: the walk falls back to
# the good one) and a planted sha mismatch (a library's bytes changed under
# its manifest: a probe misses and loads nothing), both counted. (b) The
# guards at llama3-8b on 4u (a)'s unplaced agent and batch: SyncGuard on a
# GRPO learn against the former counter on the same learn, CompileGuard(gen)
# over a ragged bucket stream through BucketedGenerator (0 after warm-up; a
# planted new bucket raises), CompileGuard() over a second learn (0 builds);
# the fused learn_from_buffer's SyncGuard(max_syncs=0) runs in 4k. (c)
# search_layouts over the default one-device plan and 4u (a)'s plan on 4u
# (a)'s agent and the one-card mesh. (d) ``python -m
# agilerl_tpu_torch.analysis`` in a process of its own (no jax on the
# card's machine), exit 0 against analysis_baseline_torch.json.
KERNEL_SOURCES = ("flash_attention_fwd", "fused_logprob_fwd", "flash_attention_bwd",
                  "fused_logprob_bwd")
WARM_CHILD_TIMEOUT_S = 300.0
LINT_TIMEOUT_S = 300.0
GUARD_NEW_TOKENS = 8
GUARD_BUCKETS = dict(prompt_buckets=(64, 128, 256), row_buckets=(4, 8, 16), decode_chunk=4)
# (rows, shortest, longest prompt): the warm-up covers buckets 64 x 4 and
# 128 x 8, the steady stream stays inside them, the planted batch needs 256
GUARD_WARM = ((4, 40, 60), (8, 100, 120))
GUARD_STEADY = ((3, 30, 60), (6, 70, 128), (2, 10, 50), (7, 65, 110))
GUARD_PLANTED = (4, 150, 200)
LAYOUT_WARMUP, LAYOUT_STEPS = 1, 2


def build_through_store(torch, report):
    """Phase 2: the four libraries through the compile cache into a fresh
    store (the cold path: a miss and an nvcc build each, all started
    together); returns nvcc's logs and the store directory."""
    import tempfile

    from agilerl_tpu_torch.ops import _build
    from agilerl_tpu_torch.parallel import compile_cache as CC

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    os.environ[CC.CACHE_ENV] = store_dir  # children inherit the store
    store = CC.default_store()
    t0 = time.perf_counter()
    got = CC.load_or_compile_all(KERNEL_SOURCES, store=store)
    report["build_s"] = time.perf_counter() - t0
    for name, (lib, _) in got.items():
        _build._LIBS[name] = lib
    misses = store.metrics.counter("compile_cache/misses_total").value
    report["compile_cache_cold"] = dict(
        store=store_dir, misses=misses, builds=CC.build_count(),
        compile_s={n: info["compile_s"] for n, (_, info) in got.items()},
        published={n: bool(info.get("published")) for n, (_, info) in got.items()})
    log(f"phase 2: built {list(KERNEL_SOURCES)} in {report['build_s']:.1f} s through the "
        f"compile cache at {store_dir}: {misses:.0f} misses, {CC.build_count()} nvcc builds, "
        f"compile_s {report['compile_cache_cold']['compile_s']}")
    check(misses == len(KERNEL_SOURCES) and CC.build_count() == len(KERNEL_SOURCES)
          and all(report["compile_cache_cold"]["published"].values()),
          f"phase 2: the cold build through the store: {report['compile_cache_cold']}")
    return {n: info.get("nvcc_log", "") for n, (_, info) in got.items()}, store_dir


def plant_torn(src, how):
    """A damaged copy of the newest entry of one fingerprint directory:
    ``newer`` adds a NEWER entry whose library is truncated (a kill mid-
    write); ``sha`` flips the last byte of the only entry's library under
    its manifest (bit rot, same size)."""
    import shutil

    entries = sorted(d for d in src.iterdir() if d.is_dir() and d.name.startswith("lib_"))
    good = entries[-1]
    lib = good / "library.so"
    if how == "newer":
        bad = good.with_name(good.name[:-8] + f"{int(good.name[-8:]) + 1:08d}")
        shutil.copytree(good, bad)
        (bad / "library.so").write_bytes(lib.read_bytes()[:4096])
        return good, bad
    data = bytearray(lib.read_bytes())
    data[-1] ^= 0xFF
    lib.write_bytes(bytes(data))
    return good, good


def warm_child(store_dir: str, out_path: str) -> None:
    """Phase 4w (a), in a process of its own: the four libraries from the
    store with no nvcc build, #1 and #5 once each against their plain
    versions, then the torn and corrupt entries in a copy of the store."""
    import shutil
    import tempfile

    import torch

    from agilerl_tpu_torch import ops
    from agilerl_tpu_torch.analysis import CompileGuard
    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.ops import _build
    from agilerl_tpu_torch.ops import flash_attention_vjp as tfa
    from agilerl_tpu_torch.ops import fused_loss as tfl
    from agilerl_tpu_torch.parallel import compile_cache as CC

    torch_settings(torch)
    out = {}
    t0 = time.perf_counter()
    store = CC.ExecutableStore(store_dir, metrics=MetricsRegistry())
    with CompileGuard(label="4w (a) warm child") as guard:
        got = CC.load_or_compile_all(KERNEL_SOURCES, store=store)
    out["load_all_s"] = time.perf_counter() - t0
    for name, (lib, _) in got.items():
        _build._LIBS[name] = lib
    out.update(builds=guard.new_compilations, nvcc_builds=CC.build_count(),
               hits=store.metrics.counter("compile_cache/hits_total").value,
               misses=store.metrics.counter("compile_cache/misses_total").value,
               load_s={n: info["load_s"] for n, (_, info) in got.items()})
    check(out["builds"] == 0 and out["nvcc_builds"] == 0 and out["hits"] == 4
          and out["misses"] == 0, f"4w (a): the warm child did not load all four: {out}")

    # #1 and #5 once each, on the card, against their plain versions
    g = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(2, 4, 128, 128, device="cuda", generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, 2, 128, 128, device="cuda", generator=g).to(torch.bfloat16)
            for _ in range(2))
    h = torch.randn(256, 512, device="cuda", generator=g)
    w = 0.02 * torch.randn(512, 1000, device="cuda", generator=g)
    t = torch.randint(0, 1000, (256,), device="cuda", generator=g)
    ops.reset_kernel_counters()
    o, lse = tfa.flash_attention_fwd_cuda(q, k, v, None, True)
    lp, lp_lse = tfl.fused_logprob_fwd_cuda(h, w, t, 1.0)
    launched = ops.kernel_counters()
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, None, True)
    want, want_lse = tfl._plain_fwd(h, w, t, 1.0)
    torch.cuda.synchronize()
    out.update(launches=launched,
               flash_err=(o.float() - ref.float()).abs().max().item(),
               flash_lse_err=(lse - ref_lse).abs().max().item(),
               fused_err=(lp - want).abs().max().item(),
               fused_lse_err=(lp_lse - want_lse).abs().max().item())
    check(launched["flash_attention_fwd"] == 1 and launched["fused_logprob_fwd"] == 1,
          f"4w (a): launches from the loaded libraries {launched}")
    check(out["flash_err"] <= 2e-2 and out["flash_lse_err"] <= 1e-4
          and out["fused_err"] <= 1e-4 and out["fused_lse_err"] <= 1e-4,
          f"4w (a): the loaded kernels disagree with their plain versions {out}")

    # a torn entry and a sha mismatch, in a copy of the store
    copy = Path(tempfile.mkdtemp(prefix="chip_smoke_torn_")) / "store"
    try:
        shutil.copytree(store_dir, copy)
        digests = {n: info["fingerprint"] for n, (_, info) in got.items()}
        fwd_good, fwd_bad = plant_torn(copy / f"fp_{digests['flash_attention_fwd']}", "newer")
        plant_torn(copy / f"fp_{digests['fused_logprob_fwd']}", "sha")
        torn = CC.ExecutableStore(copy, metrics=MetricsRegistry())
        with CompileGuard(label="4w (a) torn store") as guard:
            _, fwd_info = CC.load_or_compile("flash_attention_fwd", store=torn)
            fused_entry = torn.get_entry(digests["fused_logprob_fwd"])
        out["torn"] = dict(
            torn_total=torn.metrics.counter("compile_cache/torn_entries_total").value,
            builds=guard.new_compilations, fwd_loaded=fwd_info.get("path"),
            fwd_fell_back_to=str(fwd_good / "library.so"), planted_newer=str(fwd_bad),
            fused_entry=None if fused_entry is None else str(fused_entry[0]))
        check(out["torn"]["torn_total"] == 2 and guard.new_compilations == 0
              and fwd_info["hit"] and fwd_info["path"] == str(fwd_good / "library.so")
              and fused_entry is None,
              f"4w (a): the torn and corrupt entries: {out['torn']}")
    finally:
        shutil.rmtree(copy.parent, ignore_errors=True)
    Path(out_path).write_text(json.dumps(out, default=str))


def start_side_processes(store_dir):
    """Phase 4w (a)'s warm child and (d)'s linter, both started after phase
    2, each logging into a file of its own; joined by join_side_processes."""
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_4w_"))
    procs = {}
    with open(work / "child.log", "w") as f:
        procs["child"] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--warm-child", store_dir,
             str(work / "child.json")], stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
    with open(work / "lint.log", "w") as f:
        procs["lint"] = subprocess.Popen(
            [sys.executable, "-m", "agilerl_tpu_torch.analysis"], stdout=f,
            stderr=subprocess.STDOUT, cwd=str(Path(__file__).resolve().parent),
            start_new_session=True)
    log(f"phase 4w (a), (d): the warm child (pid {procs['child'].pid}) and the linter "
        f"(pid {procs['lint'].pid}) started")
    return procs, work, time.perf_counter()


def join_side_process(side, which, timeout, report):
    """Wait for one side process, print its log; fail on a non-zero exit."""
    procs, work, t0 = side
    proc = procs[which]
    try:
        proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        pass
    text = (work / f"{which}.log").read_text()
    for line in text.splitlines()[-40:]:
        log(f"  [{which}] {line}")
    check(proc.returncode == 0, f"phase 4w: the {which} process exited {proc.returncode}")
    report.setdefault("tooling", {})[f"{which}_s"] = time.perf_counter() - t0
    return text


def stop_side_processes(side) -> None:
    import shutil

    procs, work, _ = side
    for proc in procs.values():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    shutil.rmtree(work, ignore_errors=True)


def join_warm_child(side, report):
    procs, work, t0 = side
    join_side_process(side, "child", WARM_CHILD_TIMEOUT_S, report)
    got = json.loads((work / "child.json").read_text())
    report.setdefault("tooling", {})["warm_child"] = got
    log(f"phase 4w (a): the warm child loaded {got['hits']:.0f} libraries with "
        f"{got['nvcc_builds']} nvcc builds in {got['load_all_s']:.3f} s (load_s {got['load_s']}); "
        f"#1 / #5 from them: max|d| {got['flash_err']:.3e} / {got['fused_err']:.3e}; the torn "
        f"copy: {got['torn']['torn_total']:.0f} entries skipped, {got['torn']['builds']} builds, "
        f"flash fell back to the good entry, the corrupt fused entry loaded nothing")


def join_linter(side, report):
    text = join_side_process(side, "lint", LINT_TIMEOUT_S, report)
    summary = [line for line in text.splitlines() if line.startswith("graftcheck:")]
    report["tooling"]["lint"] = summary[-1] if summary else text[-500:]
    log(f"phase 4w (d): python -m agilerl_tpu_torch.analysis exited 0: {report['tooling']['lint']}")
    check(bool(summary) and " 0 finding(s)" in summary[-1], f"4w (d): linter said {text[-500:]}")


def ragged_batch(np, rng, vocab, rows, lo, hi):
    return [rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1))).astype(np.int32)
            for _ in range(rows)]


def run_guards(torch, cfg, params, plain, batch, report):
    """Phase 4w (b) at llama3-8b on 4u (a)'s unplaced agent and batch."""
    import numpy as np

    from agilerl_tpu_torch.analysis import CompileGuard, CompileGuardError, SyncGuard
    from agilerl_tpu_torch.llm import serving as S
    from agilerl_tpu_torch.observability import MetricsRegistry

    out = report.setdefault("tooling", {})["guards"] = {}
    # SyncGuard against the former counter: the same learn, on the same
    # agent and batch, once under each (both own the warnings hook, so
    # they cannot share one call); each first around nothing
    _, _, ref_base = count_syncs_reference(torch, lambda: None)
    with SyncGuard(device="cuda") as g:
        pass
    base = g.sites
    with torch.enable_grad():
        _, ref_n, ref_sites = count_syncs_reference(torch, lambda: plain.learn(batch))
        with SyncGuard(device="cuda", label="4w (b) GRPO learn") as g:
            plain.learn(batch)
    out["learn_syncs"] = dict(guard=g.syncs, guard_sites=g.sites, conversions=g.by_kind,
                              reference=ref_n, reference_sites=ref_sites,
                              instrument=dict(guard=base, reference=ref_base))
    log(f"phase 4w (b): SyncGuard on a GRPO learn ({batch[0].shape[0]} x {batch[0].shape[1]}): "
        f"{g.syncs} syncs {g.sites} (conversions {g.by_kind}); the former counter on the same "
        f"learn: {ref_n} {ref_sites}")
    check(g.syncs == ref_n and g.sites == ref_sites,
          f"4w (b): SyncGuard {g.syncs} {g.sites} != the former counter {ref_n} {ref_sites}")
    with torch.enable_grad(), CompileGuard(label="4w (b) learn builds") as cg:
        plain.learn(batch)
    out["learn_builds"] = cg.new_compilations
    check(cg.new_compilations == 0 and cg.global_mode, "4w (b): a learn built a library")

    gen = S.BucketedGenerator(cfg, max_new_tokens=GUARD_NEW_TOKENS, pad_id=0, temperature=0.0,
                              metrics=MetricsRegistry(), **GUARD_BUCKETS)
    rng = np.random.default_rng(31)
    reads = []
    t0 = time.perf_counter()
    for spec in GUARD_WARM:
        gen.generate(ragged_batch(np, rng, cfg.vocab_size, *spec), None, params, greedy=True)
    warm_programs = gen.compiled_programs
    for spec in GUARD_STEADY:
        with CompileGuard(gen, label="4w (b) steady bucket stream") as cg:
            gen.generate(ragged_batch(np, rng, cfg.vocab_size, *spec), None, params,
                         greedy=True)
        reads.append(cg.new_compilations)
    raised = None
    try:
        with CompileGuard(gen, label="4w (b) planted bucket") as planted:
            gen.generate(ragged_batch(np, rng, cfg.vocab_size, *GUARD_PLANTED), None, params,
                         greedy=True)
    except CompileGuardError as e:
        raised = str(e)
    out["bucket_stream"] = dict(warm_programs=warm_programs, steady=reads,
                                planted=planted.new_compilations, raised=raised,
                                programs=gen.compiled_programs, s=time.perf_counter() - t0)
    log(f"  CompileGuard(gen) over the bucket stream at llama3-8b: warm-up made "
        f"{warm_programs} programs, the steady batches read {reads}, the planted bucket "
        f"read {planted.new_compilations} and raised: {raised is not None} "
        f"({out['bucket_stream']['s']:.1f} s)")
    check(reads == [0] * len(GUARD_STEADY) and planted.new_compilations == 2
          and raised is not None, f"4w (b): the bucket stream {out['bucket_stream']}")
    del gen


def run_layout_search(torch, ops, cfg, placed, batch, plan, learns, plain_learns, report):
    """Phase 4w (c): search_layouts over the default one-device plan and
    4u (a)'s plan on 4u (a)'s agent and the one-card mesh, LAYOUT_WARMUP
    untimed and LAYOUT_STEPS timed learns each. Returns their launches."""
    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.parallel import plan as PL
    from agilerl_tpu_torch.parallel.layout_search import search_layouts

    candidates = [PL.get_plan(n) for n in PL.register_default_plans(1)] + [plan]
    mesh = PL.ShardingPlan("one-card", {"fsdp": 1}).build_mesh()

    def args_for(p, m):
        placed.to_mesh(mesh=m, plan=p)
        return (batch,)

    reg = MetricsRegistry()
    ops.reset_kernel_counters()
    t0 = time.perf_counter()
    with torch.enable_grad():
        result = search_layouts(placed.learn, (None,), args_for, plans=candidates, mesh=mesh,
                                warmup=LAYOUT_WARMUP, steps=LAYOUT_STEPS, registry=reg)
    launches = ops.kernel_counters()
    seconds = time.perf_counter() - t0
    report.setdefault("tooling", {})["layout_search"] = dict(
        result.to_dict(), s=seconds, launches=launches,
        best_gauge=reg.gauge("layout_search/best_step_time_s").value,
        placed_learn_s=[x["learn_s"] for x in learns],
        unplaced_learn_s=[x["learn_s"] for x in plain_learns])
    ranked = [(c.plan.name, round(c.step_time_s, 3), [round(t, 3) for t in c.step_times_s])
              for c in result.ranked]
    log(f"phase 4w (c): layout search over {[c.name for c in candidates]} on the one-card "
        f"mesh, {LAYOUT_WARMUP} + {LAYOUT_STEPS} learns each, in {seconds:.1f} s: ranked "
        f"{ranked}; 4u (a)'s placed learns {[round(x['learn_s'], 3) for x in learns]} s, "
        f"unplaced {[round(x['learn_s'], 3) for x in plain_learns]} s; launches {launches}")
    check(all(c.ok for c in result.candidates),
          f"4w (c): a candidate failed: {[c.error for c in result.candidates]}")
    n = len(candidates) * (LAYOUT_WARMUP + LAYOUT_STEPS)
    L = cfg.n_layer
    want = {"flash_attention_fwd": 3 * L * n, "flash_attention_dq": L * n,
            "flash_attention_dkv": L * n, "fused_logprob_fwd": 3 * n, "fused_logprob_dh": n,
            "fused_logprob_dw": 0}
    check(launches == want, f"4w (c): launches {launches} != {want}")
    return launches


# ------------------------------- phase 5 ----------------------------------- #


def sdpa_forward(torch, F, q, k, v, backends, **kw):
    """SDPA's forward (on repeated K/V) on each named backend that takes
    these inputs: {backend name: callable}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    calls = {}
    for name in backends:
        def call(backend=getattr(SDPBackend, name)):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, kr, vr, **kw)
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError as e:
            log(f"  SDPA backend {name} does not take these inputs: {str(e)[:120]}")
            continue
        calls[name] = call
    return calls


def flash_fwd_row(torch, F, tfa, B, H, Hkv, T, d, mask, g, backends, sdpa_kw, iters):
    """The bf16 forward kernel, its plain version and SDPA's forward on each
    backend, timed in two rounds with the SM clock after each; returns the
    numbers of one row (error over the rows with a visible key)."""
    q, k, v = flash_inputs(torch, B, H, Hkv, T, d, torch.bfloat16, False, g)
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, True)
    ref, _ = tfa.flash_attention_reference(q, k, v, mask, True)
    torch.cuda.synchronize()
    r = rows_with_a_visible_key(tfa, mask, True, B, T).expand(lse.shape)
    err = (out[r].float() - ref[r].float()).abs().max().item()
    check(err <= 2e-2, f"flash kernel at [{B}, {H}/{Hkv}, {T}, {d}] disagrees: {err}")
    del out, ref
    fns = {"kernel": lambda: tfa.flash_attention_fwd_cuda(q, k, v, mask, True),
           "plain": lambda: tfa.flash_attention_reference(q, k, v, mask, True)}
    sdpa = sdpa_forward(torch, F, q, k, v, backends, **sdpa_kw)
    fns.update({f"sdpa_{n}": f for n, f in sdpa.items()})
    clocks = []
    rounds = timed_abba(torch, fns, {n: iters.get(n, iters["default"]) for n in fns}, clocks)
    ms = {n: sum(rd) / 2 for n, rd in rounds.items()}
    lib = min(sdpa, key=lambda n: ms[f"sdpa_{n}"]) if sdpa else None
    pairs = B * H * T * (T + 1) / 2 if mask is None else visible_pairs(torch, mask, H)
    flops = 4.0 * d * pairs
    # reads: Q of the rows that see a key, K and V of the visible keys;
    # writes: the output and lse in full
    nbytes = flash_read_bytes(torch, B, T, mask, H * 2 * d, Hkv * 2 * 2 * d) + (
        2 * q.numel() + 4 * lse.numel())
    b_ms, b_by = bound(flops, nbytes, "bf16")
    # what the timed kernel's last launch ran, read back from the library (a
    # checkout older than the launch record, timed by --flash-fwd-rows, has none)
    last = getattr(tfa, "flash_fwd_last_launch", None)
    launched = {"kernel": last() if last else {"kind": "not recorded"}}
    log(f"  flash fwd [B={B}, H={H}/{Hkv}, T={T}, d={d}] bf16 "
        f"{'left-padded' if mask is not None else 'unmasked'} causal: kernel {ms['kernel']:.3f} "
        f"ms (rounds {rounds['kernel'][0]:.3f}/{rounds['kernel'][1]:.3f}; launched "
        f"{launched['kernel']}), plain "
        f"{ms['plain']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        + ", ".join(f"SDPA [{n}] {ms['sdpa_' + n]:.3f} ms (rounds "
                    f"{rounds['sdpa_' + n][0]:.3f}/{rounds['sdpa_' + n][1]:.3f})" for n in sdpa)
        + f"; SM clock / power / temperature after each round: {clocks}")
    return dict(shape=[B, H, Hkv, T, d], masked=mask is not None, pairs=pairs, flops=flops,
                bytes=nbytes, bound_ms=b_ms, bound_by=b_by, error=err, rounds_ms=rounds, ms=ms,
                clocks=clocks, launched=launched, sdpa_backend=lib,
                sdpa_ms=ms[f"sdpa_{lib}"] if lib else None)


def time_flash(torch, F, tfa, cfg, full_mask, launches, report):
    """The forward at the learn shape (with the slice's left padding), on
    one unmasked causal row at T = 2048 and at the wide rows (WIDE_ROW,
    WIDE_4Q_ROW). SDPA runs on each backend that takes the inputs (a
    boolean mask rules out its flash backend); the yardstick is the
    fastest."""
    B, T = full_mask.shape
    H, Hkv, d = cfg.n_head, cfg.kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(3)
    mask = full_mask.to(torch.int32)
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))
    learn = flash_fwd_row(torch, F, tfa, B, H, Hkv, T, d, mask, g,
                          ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"),
                          dict(attn_mask=causal[None, None] & mask.bool()[:, None, None, :]),
                          {"default": 20, "plain": 5, "sdpa_MATH": 5})
    long_row = flash_fwd_row(torch, F, tfa, 4, H, Hkv, 2048, d, None, g,
                             ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"),
                             dict(is_causal=True), {"default": 10, "plain": 1})
    wide, wide_4q = (flash_fwd_row(torch, F, tfa, *row, None, g, SDPA_BACKENDS,
                                   dict(is_causal=True),
                                   {"default": 10, "plain": 2, "sdpa_MATH": 2})
                     for row in (WIDE_ROW, WIDE_4Q_ROW))
    report["flash_timing"] = dict(learn=learn, causal_2048=long_row, wide=wide, wide_4q=wide_4q)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "agilerl_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "agilerl_tpu/ops/flash_attention_vjp.py:40",
            "launches": launches["flash_attention_fwd"], "max_abs_err": learn["error"],
            "ms": learn["ms"]["kernel"], "plain_ms": learn["ms"]["plain"],
            "bound_ms": learn["bound_ms"], "bound_by": learn["bound_by"],
            "library_ms": learn["sdpa_ms"], "library": f"SDPA [{learn['sdpa_backend']}]",
            "wide": wide_entry(wide, "kernel", wide["bound_ms"], wide["bound_by"]),
            "wide_4q": wide_entry(wide_4q, "kernel", wide_4q["bound_ms"], wide_4q["bound_by"])}


# The wide kernels' timing row: the EvolvableGPT of phase 4q's wide case at
# 2 heads of 512 (B, H, Hkv, T, d), bf16, unmasked causal; SDPA on every
# backend that takes head dim 512
WIDE_ROW = (8, 2, 2, 1024, 512)
# phase 4q's wide step (head dim 272, run at 320): the second wide row
WIDE_4Q_ROW = (8, 2, 2, 1024, 320)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def wide_entry(row, key, bound_ms, bound_by):
    """The wide-row numbers a kernel's entry of the kernels line carries,
    and the kind of kernel, threads a block and (backward) cluster size (1:
    no cluster) that the library reports its timed launches ran with."""
    entry = {"shape": row["shape"], "ms": row["ms"][key], "plain_ms": row["ms"]["plain"],
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": row["sdpa_ms"],
             "library": f"SDPA [{row['sdpa_backend']}]" if row["sdpa_backend"] else "none"}
    ran = row["launched"][key]
    entry.update(kernel=ran["kind"], **{k: ran[k] for k in ("threads", "cluster") if k in ran})
    return entry


def time_fused(torch, F, tfl, cfg, n_rows, launches, report):
    D, V = cfg.d_model, cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(4)
    h = torch.randn(n_rows, D, device="cuda", generator=g)
    w = 0.02 * torch.randn(D, V, device="cuda", generator=g)
    t = torch.randint(0, V, (n_rows,), device="cuda", generator=g)
    got, _ = tfl.fused_logprob_fwd_cuda(h, w, t, 1.0)
    want = tfl.reference_token_logprob(h, w, t, 1.0)
    err = (got - want).abs().max().item()
    check(err <= 1e-4, f"fused kernel at the main-path shape disagrees: {err}")
    rounds = timed_abba(torch, {
        "kernel": lambda: tfl.fused_logprob_fwd_cuda(h, w, t, 1.0),
        "prep": lambda: tfl.prepare_operands(h, w),
        "plain": lambda: tfl.reference_token_logprob(h, w, t, 1.0),
        "library": lambda: F.cross_entropy(h @ w / 1.0, t, reduction="none"),
    }, {"kernel": 3, "prep": 3, "plain": 3, "library": 3})
    ms, prep_ms, plain_ms, lib_ms = (sum(rounds[n]) / 2
                                     for n in ("kernel", "prep", "plain", "library"))
    flops = 2.0 * n_rows * D * V
    nbytes = 4.0 * (n_rows * D + D * V + n_rows) + 8.0 * n_rows
    b_ms, b_by, fma_ms = tf32x3_bounds(flops, nbytes)
    log(f"  fused [N={n_rows}, D={D}, V={V}] f32 in 3xTF32: kernel {ms:.2f} ms (of which "
        f"operand preparation {prep_ms:.2f} ms), plain {plain_ms:.2f} ms, matmul + "
        f"cross_entropy {lib_ms:.2f} ms, bound {b_ms:.2f} ms ({b_by}, 3xTF32 on the tensor "
        f"cores; {fma_ms:.2f} ms on f32 FMAs)")
    report["fused_timing"] = dict(shape=[n_rows, D, V], flops=flops, bytes=nbytes,
                                  rounds_ms=rounds, clocks=nvidia_smi_clocks())
    return {"name": "fused_logprob_fwd", "route": "cuda",
            "source": "agilerl_tpu_torch/csrc/fused_logprob_fwd.cu",
            "replaces": "agilerl_tpu/ops/fused_loss.py:38",
            "launches": launches["fused_logprob_fwd"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "bound_f32_fma_ms": fma_ms, "prep_ms": prep_ms}


def flash_read_bytes(torch, B, T, mask, row_bytes, key_bytes):
    """Bytes a causal flash kernel must read: `row_bytes` for each query row
    that sees a visible key (a row that sees none needs no input: its p is
    0), `key_bytes` for each visible key, and the mask."""
    if mask is None:
        return B * T * (row_bytes + key_bytes)
    rows = int((mask.cumsum(dim=1) > 0).sum())
    keys = int((mask > 0).sum())
    return rows * row_bytes + keys * key_bytes + 4 * mask.numel()


def visible_pairs(torch, mask, H):
    """(query, visible key) pairs over the real rows of a left-padded causal
    batch, for every query head: the work the data needs."""
    n = mask.sum(dim=1).double()
    return float((n * (n + 1) / 2).sum()) * H


def sdpa_backward(torch, F, q, k, v, dout, backends, **kw):
    """SDPA's backward (dQ, dK, dV of repeated K/V) on each named backend that
    takes these inputs: {backend name: callable}. The forward runs under
    ``sdpa_kernel`` so its autograd node is that backend's backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[1] // k.shape[1]
    calls = {}
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_(True) for t in
                      (q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)))
        for name in backends:
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
                    torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)
                    torch.cuda.synchronize()
            except RuntimeError as e:
                log(f"  SDPA backend {name} does not take these inputs: {str(e)[:120]}")
                continue
            calls[name] = (lambda out=out: torch.autograd.grad(out, (qg, kg, vg), dout,
                                                               retain_graph=True))
    return calls


def flash_bwd_row(torch, F, tfa, B, H, Hkv, T, d, mask, g, backends, sdpa_kw, iters):
    """Kernels, plain backward and SDPA's backward on each backend, timed in
    two rounds with the SM clock after each; returns the numbers of one row."""
    q, k, v, dout, lse, dd = flash_bwd_inputs(torch, tfa, B, H, Hkv, T, d, torch.bfloat16, mask,
                                              True, False, g)
    dq = tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True)
    dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True)
    want = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, True)
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        errs[name], tol = bwd_error(torch, got, ref, torch.bfloat16)
        check(errs[name] <= tol, f"flash {name} at [{B}, {H}/{Hkv}, {T}, {d}] disagrees: "
              f"{errs[name]}")
    del dq, dk, dv, want
    fns = {
        "dq": lambda: tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True),
        "dkv": lambda: tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True),
        "plain": lambda: tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, True),
    }
    sdpa = sdpa_backward(torch, F, q, k, v, dout, backends, **sdpa_kw)
    fns.update({f"sdpa_{n}": f for n, f in sdpa.items()})
    clocks = []
    rounds = timed_abba(torch, fns, {n: iters.get(n, iters["default"]) for n in fns}, clocks)
    # what the timed kernels' last launches ran, read back from the library
    launched = {n: tfa.flash_bwd_last_launch(n) for n in ("dq", "dkv")}
    ms = {n: sum(r) / 2 for n, r in rounds.items()}
    lib = min(sdpa, key=lambda n: ms[f"sdpa_{n}"]) if sdpa else None
    if mask is None:
        pairs = B * H * T * (T + 1) / 2
    else:
        pairs = visible_pairs(torch, mask, H)
    # Q, dO, lse and D of each row; K and V of each key
    io = flash_read_bytes(torch, B, T, mask, H * (2 * 2 * d + 2 * 4), Hkv * 2 * 2 * d)
    row = dict(shape=[B, H, Hkv, T, d], masked=mask is not None, pairs=pairs,
               rounds_ms=rounds, ms=ms, clocks=clocks, errors=errs, sdpa_backend=lib,
               launched=launched,
               sdpa_ms=ms[f"sdpa_{lib}"] if lib else None,
               bounds={})
    for name, flops, nbytes in (("dq", 6.0 * d * pairs, io + 2 * q.numel()),
                                ("dkv", 8.0 * d * pairs, io + 4 * k.numel())):
        row["bounds"][name] = bound(flops, nbytes, "bf16") + (flops, nbytes)
    b_dq, b_dkv = row["bounds"]["dq"][0], row["bounds"]["dkv"][0]
    log(f"  flash bwd [B={B}, H={H}/{Hkv}, T={T}, d={d}] bf16 "
        f"{'left-padded' if mask is not None else 'unmasked'} causal: dQ {ms['dq']:.3f} ms "
        f"(rounds {rounds['dq'][0]:.3f}/{rounds['dq'][1]:.3f}, bound {b_dq:.4f}), dK/dV "
        f"{ms['dkv']:.3f} ms (rounds {rounds['dkv'][0]:.3f}/{rounds['dkv'][1]:.3f}, bound "
        f"{b_dkv:.4f}; launched {launched}), sum {ms['dq'] + ms['dkv']:.3f} ms; "
        f"plain (dQ+dK+dV) {ms['plain']:.3f} ms; "
        + ", ".join(f"SDPA backward [{n}] {ms['sdpa_' + n]:.3f} ms (rounds "
                    f"{rounds['sdpa_' + n][0]:.3f}/{rounds['sdpa_' + n][1]:.3f})" for n in sdpa)
        + f"; SM clock / power / temperature after each round: {clocks}")
    return row


def time_flash_bwd(torch, F, tfa, cfg, full_mask, launches, report):
    """dQ and dK/dV at the learn shapes (with the learn step's left padding)
    and on one unmasked causal row at T = 2048; the plain backward and SDPA's
    backward each compute dQ, dK and dV together (one number, on both rows).
    SDPA runs on each backend that takes the inputs (a boolean mask rules out
    its flash backend); the yardstick is the fastest."""
    B, T = full_mask.shape
    H, Hkv, d = cfg.n_head, cfg.kv_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(8)
    mask = full_mask.to(torch.int32)
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device="cuda"))
    learn = flash_bwd_row(torch, F, tfa, B, H, Hkv, T, d, mask, g,
                          ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION"),
                          dict(attn_mask=causal[None, None] & mask.bool()[:, None, None, :]),
                          {"default": 10, "plain": 3})
    long_row = flash_bwd_row(torch, F, tfa, 4, H, Hkv, 2048, d, None, g,
                             ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"),
                             dict(is_causal=True), {"default": 5, "plain": 1})
    wide = flash_bwd_row(torch, F, tfa, *WIDE_ROW, None, g, SDPA_BACKENDS, dict(is_causal=True),
                         {"default": 5, "plain": 1, "sdpa_MATH": 1})
    wide_4q = flash_bwd_row(torch, F, tfa, *WIDE_4Q_ROW, None, g, SDPA_BACKENDS,
                            dict(is_causal=True), {"default": 5, "plain": 1, "sdpa_MATH": 1})
    entries = []
    for name, replaces in (("flash_attention_dq", 94), ("flash_attention_dkv", 141)):
        key = "dq" if name.endswith("dq") else "dkv"
        errs = learn["errors"]
        err = errs["dq"] if key == "dq" else max(errs["dk"], errs["dv"])
        b_ms, b_by, _, _ = learn["bounds"][key]
        entries.append({"name": name, "route": "cuda",
                        "source": "agilerl_tpu_torch/csrc/flash_attention_bwd.cu",
                        "replaces": f"agilerl_tpu/ops/flash_attention_vjp.py:{replaces}",
                        "launches": launches[name], "max_abs_err": err, "ms": learn["ms"][key],
                        "plain_ms": learn["ms"]["plain"], "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": learn["sdpa_ms"], "library": f"SDPA backward "
                        f"[{learn['sdpa_backend']}] (dQ+dK+dV)",
                        "wide": wide_entry(wide, key, *wide["bounds"][key][:2]),
                        "wide_4q": wide_entry(wide_4q, key, *wide_4q["bounds"][key][:2])})
    report["flash_bwd_timing"] = dict(learn=learn, causal_2048=long_row, wide=wide,
                                      wide_4q=wide_4q)
    return entries


def time_fused_bwd(torch, F, tfl, cfg, n_rows, launches, report):
    """dH and dW at the learn shapes; the library yardstick is autograd of
    cuBLAS f32 GEMM + cross_entropy (TF32 off): GEMM, softmax coefficient, GEMM."""
    D, V = cfg.d_model, cfg.vocab_size
    g = torch.Generator(device="cuda").manual_seed(9)
    h = torch.randn(n_rows, D, device="cuda", generator=g)
    w = 0.02 * torch.randn(D, V, device="cuda", generator=g)
    t = torch.randint(0, V, (n_rows,), device="cuda", generator=g)
    up = torch.randn(n_rows, device="cuda", generator=g)
    _, lse = tfl.fused_logprob_fwd_cuda(h, w, t, 1.0)
    errs = {}
    for name, kern, plain in (("dh", tfl.fused_logprob_dh_cuda, tfl.plain_dh),
                              ("dw", tfl.fused_logprob_dw_cuda, tfl.plain_dw)):
        got, want = kern(h, w, t, lse, up), plain(h, w, t, lse, up)
        torch.cuda.synchronize()
        errs[name] = (got - want).abs().max().item()
        check(errs[name] <= FUSED_BWD_ATOL, f"fused {name} at the learn shape disagrees")
        del got, want

    def library(wrt):
        with torch.enable_grad():
            x = wrt.detach().requires_grad_(True)
            hh, ww = (x, w) if wrt is h else (h, x)
            ce = F.cross_entropy(hh @ ww, t, reduction="none")
            return torch.autograd.grad((ce * -up).sum(), x)[0]

    rounds = timed_abba(torch, {
        "dh": lambda: tfl.fused_logprob_dh_cuda(h, w, t, lse, up),
        "prep_dh": lambda: tfl.prepare_operands(h, w, for_dh=True),
        "dw": lambda: tfl.fused_logprob_dw_cuda(h, w, t, lse, up),
        "prep_dw": lambda: tfl.prepare_operands(h, w, for_dw=True),
        "plain_dh": lambda: tfl.plain_dh(h, w, t, lse, up),
        "plain_dw": lambda: tfl.plain_dw(h, w, t, lse, up),
        "library_dh": lambda: library(h),
        "library_dw": lambda: library(w),
    }, {n: 1 for n in ("dh", "prep_dh", "dw", "prep_dw", "plain_dh", "plain_dw", "library_dh",
                       "library_dw")})
    ms = {n: sum(r) / 2 for n, r in rounds.items()}
    flops = 4.0 * n_rows * D * V
    entries = []
    for key, out_numel, replaces in (("dh", n_rows * D, 95), ("dw", D * V, 119)):
        nbytes = 4.0 * (n_rows * D + D * V + out_numel) + 12.0 * n_rows
        name = f"fused_logprob_{key}"
        # the least time: the work in 3xTF32 on the tensor cores (the FMA
        # bound of the same f32 work is kept beside it)
        b_ms, b_by, fma_ms = tf32x3_bounds(flops, nbytes)
        extra = {"bound_f32_fma_ms": fma_ms, "prep_ms": ms["prep_" + key]}
        how = (f"3xTF32 on the tensor cores; {fma_ms:.2f} ms on f32 FMAs; operand "
               f"preparation {ms['prep_' + key]:.2f} ms of the kernel time")
        log(f"  {name} [N={n_rows}, D={D}, V={V}] f32: kernel {ms[key]:.2f} ms, plain "
            f"{ms['plain_' + key]:.2f} ms, cuBLAS GEMM + cross_entropy backward "
            f"{ms['library_' + key]:.2f} ms, bound {b_ms:.2f} ms ({b_by}, {how})")
        entries.append({"name": name, "route": "cuda",
                        "source": "agilerl_tpu_torch/csrc/fused_logprob_bwd.cu",
                        "replaces": f"agilerl_tpu/ops/fused_loss.py:{replaces}",
                        "launches": launches[name], "max_abs_err": errs[key], "ms": ms[key],
                        "plain_ms": ms["plain_" + key], "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": ms["library_" + key], **extra})
    report["fused_bwd_timing"] = dict(shape=[n_rows, D, V], flops=flops, rounds_ms=rounds,
                                      errors=errs, clocks=nvidia_smi_clocks())
    return entries


# ------------------------ phases 4h-4r alongside --------------------------- #
# The RL phases (4h-4r but 4q) need nothing of the LLM phases and launch the
# port's kernels, if at all, under their own counts: a second process runs
# them (``--rl-phases``) while this one runs 4f-4t, so the run takes the
# longer of the two rather than their sum. The host times of both are taken
# alongside each other; 4q and phase 5 (kernel times) run after it ended.
# (phase, function, the launches_by_path names of what it returns)
RL_PHASES = (
    ("4h", run_on_policy, ("on_policy",)),
    ("4i", run_population, ("population",)),
    ("4j", run_encoders_and_recurrent, ("encoders_recurrent",)),
    ("4k", run_off_policy, ("off_policy",)),
    ("4l", run_off_policy_continuous, ("off_policy_continuous", "offline")),
    ("4m", run_off_policy_scan, ("off_policy_scan",)),
    ("4n", run_multi_agent_off_policy, ("multi_agent_off_policy",)),
    ("4o", run_multi_agent_on_policy, ("multi_agent_on_policy", "multi_agent_scan")),
    ("4p", run_bandits, ("bandits",)),
    ("4r", run_pettingzoo, ("pettingzoo",)),
    ("4v_bc", run_elastic, ("elastic",)),
    ("4x_d", run_uneven_tp, ("uneven_tp_rank0",)),
)
RL_PHASES_BY_S = 1100.0  # the seconds since the start by which they must have ended
# phases of the second process that start only once a phase of the main side
# has ended (its marker file in the second process's work directory): 4x (d)'s
# four ranks beside 4v (a)'s two pipeline ranks overflowed the card's 80 GB
RL_PHASE_AFTER = {"4x_d": "4v_a"}
RL_WAIT_UNTIL_S = 900.0  # past this many seconds since the start, it starts anyway


def torch_settings(torch) -> None:
    # f32 products in full f32 on the card, for the plain versions too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)


def timed_phase(name, fn, *args):
    """``fn(*args)``, its seconds logged and kept as ``report["phase_<name>_s"]``
    (the report is the last argument)."""
    t0 = time.perf_counter()
    out = fn(*args)
    args[-1][f"phase_{name}_s"] = seconds = time.perf_counter() - t0
    log(f"phase {name}: {seconds:.1f} s")
    return out


def rl_phases(out_path: str) -> None:
    """The second process (``chip_smoke.py --rl-phases T0 OUT``): RL_PHASES
    in order, then their report entries and launch counts into OUT (JSON)."""
    import torch

    from agilerl_tpu_torch import ops

    torch_settings(torch)
    report, launches = {}, {}
    for name, fn, paths in RL_PHASES:
        if name in RL_PHASE_AFTER:
            done = Path(out_path).with_name(f"{RL_PHASE_AFTER[name]}.done")
            t0 = time.perf_counter()
            while not done.exists() and time.perf_counter() - _T0 < RL_WAIT_UNTIL_S:
                time.sleep(0.5)
            report[f"phase_{name}_waited_s"] = waited = time.perf_counter() - t0
            log(f"phase {name}: waited {waited:.1f} s for phase {RL_PHASE_AFTER[name]} "
                f"({'ended' if done.exists() else 'not ended'})")
        got = timed_phase(name, fn, torch, ops, report)
        launches.update(zip(paths, got if len(paths) > 1 else (got,)))
    Path(out_path).write_text(json.dumps(dict(report=report, launches=launches)))


def start_rl_phases():
    """Start the second process in a session of its own (its workers go with
    it), its output into a log that join_rl_phases prints."""
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_rl_"))
    with open(work / "log", "w") as f:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rl-phases",
                                 repr(_T0), str(work / "out.json")],
                                stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    log(f"phases 4h-4r (but 4q): started in a second process (pid {proc.pid})")
    return proc, work


def join_rl_phases(rl, report):
    """Wait for the second process, print its log (each line timed from this
    run's start), take its report entries; its launches by path."""
    proc, work = rl
    try:
        proc.wait(timeout=max(RL_PHASES_BY_S - (time.perf_counter() - _T0), 1.0))
    except subprocess.TimeoutExpired:
        pass
    text = (work / "log").read_text()
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    check(proc.returncode is not None,
          f"phases 4h-4r: the second process was still running at {RL_PHASES_BY_S:.0f} s")
    failed = [line for line in text.splitlines() if "FAIL" in line or "Error" in line]
    check(proc.returncode == 0,
          f"phases 4h-4r: the second process exited {proc.returncode}: {failed[-3:]}")
    got = json.loads((work / "out.json").read_text())
    report.update(got["report"])
    return got["launches"]


def stop_rl_phases(rl) -> None:
    """End whatever is left of the second process's session, and its files."""
    import shutil

    proc, work = rl
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()
    shutil.rmtree(work, ignore_errors=True)


def flash_fwd_rows(root: str, out_path: str) -> None:
    """--flash-fwd-rows: the bf16 forward (kernel, plain version, SDPA) at
    phase 5's wide rows and at d = 128 on one unmasked causal row at T =
    2048, timed as phase 5 times them, with agilerl_tpu_torch imported from
    the checkout at `root`; writes the rows and the nvidia-smi line to
    `out_path` as JSON."""
    at = Path(root).resolve()
    sys.path.insert(0, str(at))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check runs on a GPU")
    from agilerl_tpu_torch.ops import flash_attention_vjp as tfa

    check(Path(tfa.__file__).resolve().is_relative_to(at), f"{tfa.__file__} is not under {at}")
    torch_settings(torch)
    g = torch.Generator(device="cuda").manual_seed(3)
    rows = {name: flash_fwd_row(torch, F, tfa, *row, None, g, ("EFFICIENT_ATTENTION",),
                                dict(is_causal=True), {"default": 20, "plain": 1})
            for name, row in (("wide", WIDE_ROW), ("wide_4q", WIDE_4Q_ROW))}
    rows["causal_2048"] = flash_fwd_row(torch, F, tfa, 4, 32, 8, 2048, 128, None, g,
                                        ("FLASH_ATTENTION",), dict(is_causal=True),
                                        {"default": 20, "plain": 1})
    Path(out_path).write_text(json.dumps(dict(root=str(at), nvidia_smi=nvidia_smi_line(),
                                              rows=rows)))


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check runs on a GPU")
    try:
        import torch.nn.functional as F
        from agilerl_tpu_torch import ops
        from agilerl_tpu_torch.llm import generate as G, model as M, presets
        from agilerl_tpu_torch.ops import _build
        from agilerl_tpu_torch.ops import flash_attention_vjp as tfa
        from agilerl_tpu_torch.ops import fused_loss as tfl
        from agilerl_tpu_torch.utils import tree
    except ImportError as e:
        fail(f"run from the root of the repository ({e})")

    torch_settings(torch)
    report = {}

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"phase 1: device {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    report["device"] = dict(kind=kind, count=count, nvidia_smi=smi)

    names = list(KERNEL_SOURCES)
    logs, store_dir = build_through_store(torch, report)
    side = None
    try:
        for n, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  {n}: {line.strip()}")
        report["sass"] = sass_counts(_build, names)
        split = ptxas_entries(logs["flash_attention_fwd"], "flash_fwd_split_kernel")
        log(f"  flash_fwd_split_kernel (bf16, 256 < d <= 512), each instance: {split}")
        check(len(split) == 4 and all(e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                                      for e in split),
              f"flash_fwd_split_kernel spills or is missing: {split}")
        report["fwd_split_ptxas"] = split
        side = start_side_processes(store_dir)
        log("phase 3: kernels vs their plain versions on the card")
        check_split(torch, tfl, report)
        check_flash(torch, tfa, report)
        check_flash_bf16_cases(torch, tfa, report)
        n_rows = GROUP_SIZE * len(PROMPT_LENS) * (max(PROMPT_LENS) + MAX_NEW_TOKENS - 1)
        check_fused(torch, tfl, report, n_rows, 4096)
        check_flash_bwd(torch, tfa, report)
        check_flash_head_dims(torch, tfa, report)
        check_fused_bwd(torch, tfl, report, n_rows, 4096)
        small_model_check(torch, M, ops, report)
        join_warm_child(side, report)

        cfg, params, prompts, full_mask, dense_greedy = run_slice(torch, M, G, ops, presets, report)
        with torch.enable_grad():
            grpo_launches, grpo_grads, last_batch = run_learn(torch, M, ops, cfg, params,
                                                               prompts, report)
            dpo_launches, dpo_grads = run_dpo(torch, M, ops, tfa, tfl, cfg, params, report)
        # phases 4h-4r but 4q in a second process, alongside 4f-4t (see RL_PHASES)
        rl = start_rl_phases()
        try:
            with torch.enable_grad():
                remat_launches = timed_phase("4x_ab", run_remat, torch, M, ops, cfg, params,
                                             last_batch, report)
            del last_batch
            serve_launches, served_greedy = timed_phase(
                "4f", run_serving, torch, M, G, ops, cfg, params, prompts, dense_greedy, report)
            torch.cuda.empty_cache()
            with torch.enable_grad():
                fly_launches = timed_phase("4g", run_fleet_and_flywheel, torch, M, G, ops, tfa, tfl,
                                           cfg, params, prompts, served_greedy, report)
            plan_launches, sp_launches, layout_launches = timed_phase(
                "4u_ab", run_sharding, torch, M, ops, cfg, params, prompts, report)
            join_linter(side, report)
            with torch.enable_grad():
                # one f32 copy of the weights, made from (and replacing) the bf16
                # blocks, serves both gradient checks
                cfg32, params32 = f32_weights(torch, cfg, params)
                del params
                torch.cuda.empty_cache()
                log("phases 4b and 4d: the adapter gradients against an f32 run")
                report["learn"].update(f32_grad_agreement(torch, tree, grpo_grads, cfg32, params32))
                report["dpo"].update(f32_grad_agreement(torch, tree, dpo_grads, cfg32, params32))
                del params32, grpo_grads, dpo_grads
                torch.cuda.empty_cache()
                run_evolution(torch, M, ops, presets, report)
                timed_phase("4e", lambda r: (run_preference_loop(torch, M, ops, presets, r),
                                             run_offline_hf_moe(torch, M, r)), report)
                resilience_launches = timed_phase("4s", run_resilience, torch, ops, tfa, tfl,
                                                  presets, report)
                launcher_launches = timed_phase("4t", run_launcher, torch, ops, report)
            ring_launches = timed_phase("4u_cd", run_ring_and_pod, torch, ops, report)
            with torch.enable_grad():
                pipe_launches = timed_phase("4v_a", run_pipeline, torch, ops, report)
            (rl[1] / "4v_a.done").touch()  # RL_PHASE_AFTER
            timed_phase("4x_c", run_serving_tp, torch, report)
            rl_launches = join_rl_phases(rl, report)
        finally:
            stop_rl_phases(rl)
        gpt_launches = timed_phase("4q", run_transformers, torch, ops, presets, report)
        # each main path's counts were set to 0 just before it and read just after
        launches = {k: grpo_launches[k] + dpo_launches[k] + serve_launches[k] + fly_launches[k]
                    + plan_launches[k] + sp_launches[k] + layout_launches[k]
                    + remat_launches[k] for k in grpo_launches}

        log("phase 5: kernel times at the main path's shapes")
        kernels = [time_flash(torch, F, tfa, cfg, full_mask, launches, report),
                   *time_flash_bwd(torch, F, tfa, cfg, full_mask, launches, report),
                   time_fused(torch, F, tfl, cfg, n_rows, launches, report),
                   *time_fused_bwd(torch, F, tfl, cfg, n_rows, launches, report)]
        for entry in kernels:
            entry["launches_by_path"] = {"grpo_learn": grpo_launches[entry["name"]],
                                         "dpo_learn": dpo_launches[entry["name"]],
                                         "serving_capture": serve_launches[entry["name"]],
                                         "flywheel": fly_launches[entry["name"]],
                                         **{path: n[entry["name"]]
                                            for path, n in rl_launches.items()},
                                         "evolvable_gpt": gpt_launches[entry["name"]],
                                         "resilience": resilience_launches[entry["name"]],
                                         "launcher": launcher_launches[entry["name"]],
                                         "plan_learn": plan_launches[entry["name"]],
                                         "layout_search": layout_launches[entry["name"]],
                                         "sp_learn": sp_launches[entry["name"]],
                                         "remat_learn": remat_launches[entry["name"]],
                                         "ring_rank0": ring_launches[0][entry["name"]],
                                         "ring_rank1": ring_launches[1][entry["name"]],
                                         "pipeline_rank0": pipe_launches[0][entry["name"]],
                                         "pipeline_rank1": pipe_launches[1][entry["name"]]}
            # the LoRA learn steps freeze the head, so dW is not on the paths
            # (phase 3 and the timing above launch it)
            if entry["name"] != "fused_logprob_dw":
                check(entry["launches"] > 0, f"{entry['name']} was not launched on the main path")
                check(resilience_launches[entry["name"]] > 0,
                      f"{entry['name']} was not launched on phase 4s's GRPO runs")
                check(launcher_launches[entry["name"]] > 0,
                      f"{entry['name']} was not launched in phase 4t's learner process")
                check(plan_launches[entry["name"]] > 0,
                      f"{entry['name']} was not launched on phase 4u's plan learns")
                check(layout_launches[entry["name"]] > 0,
                      f"{entry['name']} was not launched on phase 4w's layout search")
                check(remat_launches[entry["name"]] > 0,
                      f"{entry['name']} was not launched on phase 4x's remat learn")
            if entry["name"].startswith("flash"):
                check(sp_launches[entry["name"]] > 0 and ring_launches[1][entry["name"]] > 0,
                      f"{entry['name']} was not launched on phase 4u's ring")
        report["wall_s"] = time.perf_counter() - t_start
        log(f"wall time {report['wall_s']:.1f} s")
        log("report: " + json.dumps(report))

        print(json.dumps({"kernels": kernels}))
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
              flush=True)
    finally:
        import shutil

        if side is not None:
            stop_side_processes(side)
        shutil.rmtree(store_dir, ignore_errors=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--population-gate":
        population_gate_child(int(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "--ring-rank":
        ring_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 5 and sys.argv[1] == "--pipe-rank":
        pipe_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 5 and sys.argv[1] == "--serve-rank":
        serve_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 5 and sys.argv[1] == "--uneven-rank":
        uneven_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 5 and sys.argv[1] == "--elastic-rank":
        elastic_rank_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) == 4 and sys.argv[1] == "--flash-fwd-rows":
        flash_fwd_rows(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "--warm-child":
        warm_child(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "--elastic-resume":
        elastic_resume_child(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "--rl-phases":
        _T0 = float(sys.argv[2])
        rl_phases(sys.argv[3])
    else:
        main()
