"""Tracing, profiling and MFU accounting: the port of
``agilerl_tpu/utils/profiling.py``. ``jax.profiler`` becomes
``torch.profiler``; the peak table names the card's published bf16 dense
peak. XLA's cost analysis (``achieved_flops_metrics``) has no counterpart.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Tuple

import torch


@contextlib.contextmanager
def profile_trace(logdir: str = "agilerl_tpu_torch_trace") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU and, where present, CUDA
    activity) and write it as a Chrome trace into ``logdir``, viewable in
    Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))


def annotate(name: str):
    """Named trace span for host-side phases."""
    return torch.profiler.record_function(name)


def transformer_flops_per_token(config) -> float:
    """Approximate fwd+bwd FLOPs per token for the GPT config (6N + attention),
    PaLM-style accounting."""
    d, L = config.d_model, config.n_layer
    ff = config.ff_dim
    # parameter count (mirrors llm/model.init_params)
    attn = d * config.n_head * config.head_dim * 2 + d * config.kv_heads * config.head_dim * 2
    mlp = 3 * d * ff
    n_params = config.vocab_size * d + L * (attn + mlp)
    return 6.0 * n_params + 12.0 * L * config.max_seq_len * d


#: published dense bf16 peak FLOP/s per card, keyed by a lower-case
#: substring of ``torch.cuda.get_device_name``
PEAK_BF16_FLOPS = {
    "h100": 989e12,
}


def peak_flops_info(device=None, registry=None) -> Tuple[Optional[float], bool]:
    """``(peak_bf16_flops, estimated)`` for the device's card.

    ``peak`` is None on the CPU and on a card missing from
    ``PEAK_BF16_FLOPS`` (no fabricated MFU); an unknown card is announced
    once through ``registry`` (the process-default registry otherwise).
    ``estimated`` is always False: the table holds published peaks only."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return None, False
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in name:
            return peak, False
    if registry is None:
        from agilerl_tpu_torch.observability import get_registry

        registry = get_registry()
    registry.warn_once(
        f"peak_flops:{name}",
        f"unknown card {name!r}: no entry in PEAK_BF16_FLOPS, so no MFU is reported",
        device_kind=name)
    return None, False


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak bf16 FLOP/s for the device's card; None when unknown (CPU)."""
    return peak_flops_info(device)[0]


def estimate_mfu(
    config,
    tokens_per_step: int,
    step_time_s: float,
    peak_flops: Optional[float] = None,
) -> Optional[float]:
    """Model FLOPs utilisation; None when no peak is given and the device
    has none in the table."""
    if peak_flops is None:
        peak_flops, _ = peak_flops_info()
        if peak_flops is None:
            return None
    flops = transformer_flops_per_token(config) * tokens_per_step
    return flops / (step_time_s * peak_flops)


class StepTimer:
    """Rolling step-time tracker for training loops."""

    def __init__(self, window: int = 20):
        self.window = window
        self._times = []
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, units_per_step: float) -> float:
        st = self.mean_step_time
        return units_per_step / st if st == st and st > 0 else float("nan")
