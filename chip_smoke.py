#!/usr/bin/env python3
"""Drive the PyTorch port (agilerl_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. It imports neither jax nor agilerl_tpu. Phases, each
of which ends the run with a non-zero exit on any failure:

1. the device, and the card's name and power limit from nvidia-smi;
2. build every kernel of the port from agilerl_tpu_torch/csrc (one nvcc per
   source, all started together), with each kernel's registers, shared
   memory and spills, and the count of wgmma (HGMMA), mma.sync (HMMA) and
   f32 FMA (FFMA) instructions in each of the four libraries where cuobjdump
   is present (the bf16 flash forward must show HGMMA and no HMMA);
3. hold each kernel, forward and backward, against its plain PyTorch version
   on the card, over dtypes, masks, ragged lengths, head dims, GQA groups,
   the lse cotangent, vocab sizes and ragged row counts, with stated
   tolerances (the bf16 flash forward and backward also at T = 2048, with a
   kv tile of padding, q tiles wholly in padding and the model's strided
   GQA 32/8 views, and twice for bit-identical results; the fused dH and dW
   also at D = 200 with ragged row counts), the flash forward, dQ and dK/dV
   at head dims 16, 20, 32, 68, 72, 80, 96 and 256 (zero-padded to the
   built 64, 128 or 256), and the 3xTF32 operand split against its plain
   version bit for bit;
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
   chunk, and the disaggregated topology on 8 of the requests (every prompt
   with two repeats; 1 prefill worker, KV through the transfer store:
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
   evo_steps cut from 10,000 to 1,536 and max_steps from 200,000 to 3,072
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
   and phase 4's agreement rule; the flash kernels' time at head dims 64,
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
   run A takes 4 steps; run B is sent a real SIGTERM during step 2 and ends
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
5. each kernel's time at the main path's shapes beside its plain version,
   one PyTorch library call computing the same function, and its bound (for
   the fused forward, dH and dW: the 3xTF32 tensor-core bound and the f32
   FMA bound, and each one's operand preparation; for flash, the bytes read
   counted from the mask: only the rows and keys that meet a visible key);
   the flash forward and backward also on one unmasked causal row at
   T = 2048; SDPA (forward, or backward) on each of its backends that takes
   the inputs, in rounds with the SM clock read after each.

Prints a ``report: {...}`` line with every number the run took, then a
``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import re
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
# node mutations at gpt2-small (68, 72, 80) and 96.
PADDED_HEAD_DIMS = (16, 20, 32, 68, 72, 80, 96, 256)


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
            case = f"{str(dtype)[6:]} d={d} (run at {tfa.flash_head_dim_plan(d)})"
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
    q = torch.zeros(1, 2, 8, 320, device="cuda")
    try:
        tfa.flash_attention_fwd_cuda(q, q, q)
        fail("flash at head dim 320 did not raise")
    except ValueError as e:
        log(f"  flash head dim 320 raises: {e}")
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


def run_slice(torch, M, G, ops, presets, report):
    cfg = presets.preset("llama3-8b")
    log(f"phase 4: llama3-8b slice: {cfg.n_layer} layers, d_model {cfg.d_model}, "
        f"{cfg.n_head}/{cfg.kv_heads} heads, d_ff {cfg.ff_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    params, t_init = host_s(torch, lambda: M.init_params(0, cfg))
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
    (comp, comp_mask), t_gen = host_s(torch, lambda: G.generate(
        cfg, params, prompt, prompt_mask, gen, max_new_tokens=MAX_NEW_TOKENS, lora=actor,
        temperature=0.9))
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
    return launches, grads


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
        # half of the batch: every prompt with two of its repeats
        rows, fr["disaggregated"] = fleet_run(torch, dis, seqs[::2], params, lora,
                                              "disaggregated (1 prefill worker, 2 decode), 8 "
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
                                  tuple(a[::2] for a in prompt_np), unified[::2], rows, spread,
                                  "disaggregated vs the unified fleet")
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
                         max_seq_len=256)
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
                         max_seq_len=256)
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


def count_syncs(torch, fn):
    """(result, host syncs, {"file:line": count} of where they happened) of
    ``fn`` under torch.cuda.set_sync_debug_mode."""
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
    reward, syncs, sites = count_syncs(torch, lambda: collect_rollouts(elite, env))
    _, learn_syncs, learn_sites = count_syncs(torch, elite.learn)
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
    # a site that count_syncs also reports around a call that does nothing is
    # the instrument's own (torch/cuda's set_sync_debug_mode), not the run's
    _, _, base_sites = count_syncs(torch, lambda: None)
    _, _, sites = count_syncs(torch, lambda: run.run(1))
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
# [64]. Cuts, for time: evo_steps 10,000 -> 1,536 and max_steps 200,000 ->
# 3,072 (2 generations of 96 vector steps per agent: the 4 agents' 12,288
# env steps fill 61 % of the rings; 2,560 / 5,120, whose 20,480 steps
# wrapped them, until phase 4s came; 3,200 / 6,400 until phases 4n and 4o
# came). evo_steps is cut, not max_steps alone, to keep a second
# generation: only there do the tournament's clones and mutated agents
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
OFF_EVO_STEPS = 1_536  # cut from 10,000
OFF_LOOPS = (("rainbow", "RainbowDQN", RAINBOW_HP, 3_072),)  # cut from 200,000
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
    _, _, base_sites = count_syncs(torch, lambda: None)
    _, _, sites = count_syncs(torch, learn)
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
    _, _, sites = count_syncs(torch, lambda: train_off_policy(
        env, OFF_ENV, "RainbowDQN", [probe_agent], rainbow_mem, max_steps=OFF_SYNC_STEPS,
        evo_steps=OFF_SYNC_STEPS, eval_steps=1, n_step=True, per=True,
        n_step_memory=rainbow_nmem, verbose=False))
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
    _, _, base_sites = count_syncs(torch, lambda: None)
    _, _, sites = count_syncs(torch, learn)
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
    _, _, sites = count_syncs(torch, lambda: train_off_policy(
        env, CONT_ENV, "DDPG", [probe_agent], ddpg_mem, max_steps=CONT_SYNC_STEPS,
        evo_steps=CONT_SYNC_STEPS, eval_steps=1, verbose=False))
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
    _, _, base_sites = count_syncs(torch, lambda: None)
    for name, evo in (("dqn", dqn), ("ddpg", ddpg)):
        log(f"phase 4m: {type(evo).__name__} through ScanRun at bench_anakin's defaults: "
            f"{ANAKIN['num_envs']} envs x {ANAKIN['steps_per_iter']} steps, population 1")
        run, res = count(lambda: timed_scan(torch, evo, 1, ANAKIN["warmup"], ANAKIN["timed"]))
        _, _, sites = count(lambda: count_syncs(torch, lambda: run.run(1)))
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
    _, _, sites = count(lambda: count_syncs(torch, lambda: run.run(1)))
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
    _, _, base_sites = count_syncs(torch, lambda: None)
    for name, (pop, memory) in runs.items():
        agent = pop[0]
        learn = lambda: agent.learn(memory.sample(agent.batch_size))  # noqa: E731
        _, _, sites = count_syncs(torch, learn)
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
    _, _, sites = count_syncs(torch, lambda: train_multi_agent_off_policy(
        env, "simple_spread", "MADDPG", [probe_agent], runs["MADDPG"][1],
        max_steps=MA_SYNC_STEPS, evo_steps=MA_SYNC_STEPS, eval_steps=1,
        learning_delay=10 ** 9, verbose=False))
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
    _, _, base_sites = count_syncs(torch, lambda: None)
    _, _, sites_c = count_syncs(torch, lambda: agent.collect_rollouts(env))
    loss, _, sites_l = count_syncs(torch, agent.learn)
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
    _, _, sites = count_syncs(torch, lambda: run.run(1))
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
    cfg = presets.preset("gpt2-small")
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
    _, _, base_sites = count_syncs(torch, lambda: None)
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
            _, _, sites = count_syncs(torch, fn)
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
    _, _, base_sites = count_syncs(torch, lambda: None)
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

            _, _, sites = count_syncs(torch, vector_step)
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
# and RL-HP mutation, a test split of 2 rows. Run A: 4 steps. Run B: the
# same, with a real SIGTERM sent to this process during step 2
# (handle_signals=True): it ends cleanly with one preempt snapshot at step
# 2. Run C: a fresh population from the same seeds resumes it. C equals A:
# completions token for token, losses, rewards and fitnesses, actor and
# reference adapters and Adam moments bit for bit.
RES_STEPS = 4
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
    cfg = presets.preset("llama3-8b", vocab_size=tok.vocab_size, max_seq_len=256)
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
    log(f"  flash fwd [B={B}, H={H}/{Hkv}, T={T}, d={d}] bf16 "
        f"{'left-padded' if mask is not None else 'unmasked'} causal: kernel {ms['kernel']:.3f} "
        f"ms (rounds {rounds['kernel'][0]:.3f}/{rounds['kernel'][1]:.3f}), plain "
        f"{ms['plain']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
        + ", ".join(f"SDPA [{n}] {ms['sdpa_' + n]:.3f} ms (rounds "
                    f"{rounds['sdpa_' + n][0]:.3f}/{rounds['sdpa_' + n][1]:.3f})" for n in sdpa)
        + f"; SM clock / power / temperature after each round: {clocks}")
    return dict(shape=[B, H, Hkv, T, d], masked=mask is not None, pairs=pairs, flops=flops,
                bytes=nbytes, bound_ms=b_ms, bound_by=b_by, error=err, rounds_ms=rounds, ms=ms,
                clocks=clocks, sdpa_backend=lib, sdpa_ms=ms[f"sdpa_{lib}"] if lib else None)


def time_flash(torch, F, tfa, cfg, full_mask, launches, report):
    """The forward at the learn shape (with the slice's left padding) and on
    one unmasked causal row at T = 2048. SDPA runs on each backend that
    takes the inputs (a boolean mask rules out its flash backend); the
    yardstick is the fastest."""
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
    report["flash_timing"] = dict(learn=learn, causal_2048=long_row)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "agilerl_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "agilerl_tpu/ops/flash_attention_vjp.py:40",
            "launches": launches["flash_attention_fwd"], "max_abs_err": learn["error"],
            "ms": learn["ms"]["kernel"], "plain_ms": learn["ms"]["plain"],
            "bound_ms": learn["bound_ms"], "bound_by": learn["bound_by"],
            "library_ms": learn["sdpa_ms"], "library": f"SDPA [{learn['sdpa_backend']}]"}


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
        f"{b_dkv:.4f}), sum {ms['dq'] + ms['dkv']:.3f} ms; plain (dQ+dK+dV) {ms['plain']:.3f} ms; "
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
                        f"[{learn['sdpa_backend']}] (dQ+dK+dV)"})
    report["flash_bwd_timing"] = dict(learn=learn, causal_2048=long_row)
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

    # f32 products in full f32 on the card, for the plain versions too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    report = {}

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    log(f"phase 1: device {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    report["device"] = dict(kind=kind, count=count, nvidia_smi=smi)

    names = ["flash_attention_fwd", "fused_logprob_fwd", "flash_attention_bwd",
             "fused_logprob_bwd"]
    t0 = time.perf_counter()
    logs = _build.build_all(names)
    report["build_s"] = time.perf_counter() - t0
    log(f"phase 2: built {names} in {report['build_s']:.1f} s")
    for n, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {n}: {line.strip()}")
    report["sass"] = sass_counts(_build, names)

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

    cfg, params, prompts, full_mask, dense_greedy = run_slice(torch, M, G, ops, presets, report)
    with torch.enable_grad():
        grpo_launches, grpo_grads = run_learn(torch, M, ops, cfg, params, prompts, report)
        dpo_launches, dpo_grads = run_dpo(torch, M, ops, tfa, tfl, cfg, params, report)
    t0 = time.perf_counter()
    serve_launches, served_greedy = run_serving(torch, M, G, ops, cfg, params, prompts,
                                                dense_greedy, report)
    report["phase_4f_s"] = time.perf_counter() - t0
    log(f"phase 4f: {report['phase_4f_s']:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.enable_grad():
        fly_launches = run_fleet_and_flywheel(torch, M, G, ops, tfa, tfl, cfg, params,
                                              prompts, served_greedy, report)
    report["phase_4g_s"] = time.perf_counter() - t0
    log(f"phase 4g: {report['phase_4g_s']:.1f} s")
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
        t0 = time.perf_counter()
        run_preference_loop(torch, M, ops, presets, report)
        run_offline_hf_moe(torch, M, report)
        report["phase_4e_s"] = time.perf_counter() - t0
    log(f"phase 4e: {report['phase_4e_s']:.1f} s")
    t0 = time.perf_counter()
    on_policy_launches = run_on_policy(torch, ops, report)
    report["phase_4h_s"] = time.perf_counter() - t0
    log(f"phase 4h: {report['phase_4h_s']:.1f} s")
    t0 = time.perf_counter()
    population_launches = run_population(torch, ops, report)
    report["phase_4i_s"] = time.perf_counter() - t0
    log(f"phase 4i: {report['phase_4i_s']:.1f} s")
    t0 = time.perf_counter()
    encoder_launches = run_encoders_and_recurrent(torch, ops, report)
    report["phase_4j_s"] = time.perf_counter() - t0
    log(f"phase 4j: {report['phase_4j_s']:.1f} s")
    t0 = time.perf_counter()
    off_policy_launches = run_off_policy(torch, ops, report)
    report["phase_4k_s"] = time.perf_counter() - t0
    log(f"phase 4k: {report['phase_4k_s']:.1f} s")
    t0 = time.perf_counter()
    continuous_launches, offline_launches = run_off_policy_continuous(torch, ops, report)
    report["phase_4l_s"] = time.perf_counter() - t0
    log(f"phase 4l: {report['phase_4l_s']:.1f} s")
    t0 = time.perf_counter()
    scan_launches = run_off_policy_scan(torch, ops, report)
    report["phase_4m_s"] = time.perf_counter() - t0
    log(f"phase 4m: {report['phase_4m_s']:.1f} s")
    t0 = time.perf_counter()
    ma_off_launches = run_multi_agent_off_policy(torch, ops, report)
    report["phase_4n_s"] = time.perf_counter() - t0
    log(f"phase 4n: {report['phase_4n_s']:.1f} s")
    t0 = time.perf_counter()
    ma_on_launches, ma_scan_launches = run_multi_agent_on_policy(torch, ops, report)
    report["phase_4o_s"] = time.perf_counter() - t0
    log(f"phase 4o: {report['phase_4o_s']:.1f} s")
    t0 = time.perf_counter()
    gpt_launches = run_transformers(torch, ops, presets, report)
    report["phase_4q_s"] = time.perf_counter() - t0
    log(f"phase 4q: {report['phase_4q_s']:.1f} s")
    t0 = time.perf_counter()
    bandit_launches = run_bandits(torch, ops, report)
    report["phase_4p_s"] = time.perf_counter() - t0
    log(f"phase 4p: {report['phase_4p_s']:.1f} s")
    t0 = time.perf_counter()
    pz_launches = run_pettingzoo(torch, ops, report)
    report["phase_4r_s"] = time.perf_counter() - t0
    log(f"phase 4r: {report['phase_4r_s']:.1f} s")
    t0 = time.perf_counter()
    with torch.enable_grad():
        resilience_launches = run_resilience(torch, ops, tfa, tfl, presets, report)
    report["phase_4s_s"] = time.perf_counter() - t0
    log(f"phase 4s: {report['phase_4s_s']:.1f} s")
    # each main path's counts were set to 0 just before it and read just after
    launches = {k: grpo_launches[k] + dpo_launches[k] + serve_launches[k] + fly_launches[k]
                for k in grpo_launches}

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
                                     "on_policy": on_policy_launches[entry["name"]],
                                     "population": population_launches[entry["name"]],
                                     "encoders_recurrent": encoder_launches[entry["name"]],
                                     "off_policy": off_policy_launches[entry["name"]],
                                     "off_policy_continuous": continuous_launches[entry["name"]],
                                     "offline": offline_launches[entry["name"]],
                                     "off_policy_scan": scan_launches[entry["name"]],
                                     "multi_agent_off_policy": ma_off_launches[entry["name"]],
                                     "multi_agent_on_policy": ma_on_launches[entry["name"]],
                                     "multi_agent_scan": ma_scan_launches[entry["name"]],
                                     "evolvable_gpt": gpt_launches[entry["name"]],
                                     "bandits": bandit_launches[entry["name"]],
                                     "pettingzoo": pz_launches[entry["name"]],
                                     "resilience": resilience_launches[entry["name"]]}
        # the LoRA learn steps freeze the head, so dW is not on the paths
        # (phase 3 and the timing above launch it)
        if entry["name"] != "fused_logprob_dw":
            check(entry["launches"] > 0, f"{entry['name']} was not launched on the main path")
            check(resilience_launches[entry["name"]] > 0,
                  f"{entry['name']} was not launched on phase 4s's GRPO runs")
    report["wall_s"] = time.perf_counter() - t_start
    log(f"wall time {report['wall_s']:.1f} s")
    log("report: " + json.dumps(report))

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--population-gate":
        population_gate_child(int(sys.argv[2]))
    else:
        main()
