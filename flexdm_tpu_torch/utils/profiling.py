"""Profiling helpers.

The port's copy of ``flexdm_tpu/utils/profiling.py``: a ``torch.profiler``
trace context (``--enable_profile``), the analytic FLOPs of a training
step, model FLOPs utilization against the H100's bf16 peak, and a
steps/sec and documents/sec counter usable from any loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# Peak dense bf16 tensor-core rate of one NVIDIA H100 SXM (data sheet, at
# the full 700 W power limit): the MFU denominator.
H100_BF16_PEAK_FLOPS = 989.4e12


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the host and, where there is a
    card, its kernels; written to ``log_dir`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profiler
    plugin also reads) when the context ends.  A no-op when ``log_dir`` is
    None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def analytic_train_flops(
    schema,
    batch_size: int,
    latent_dim: int,
    num_blocks: int,
    seq_type: str = "default",
    ff_dim: Optional[int] = None,
    context: Optional[str] = None,
) -> float:
    """Analytic FLOPs of ONE training step (fwd + bwd, matmul terms).

    * encoder embeddings as one-hot matmuls ``2·B·T·C·(V+2)·D`` (the JAX
      package's count, kept so the two packages' MFU figures compare; the
      port looks the embeddings up with ``F.embedding``), and numerical
      inputs as ``2·B·T·F·D``;
    * per transformer block ``16·B·T·D²`` (fused QKV ``6``, out ``2``,
      2-layer MLP with ``ff=2D`` → ``8``) plus attention ``4·B·T²·D``;
    * fused decoder heads ``2·B·T·D·Σunits``.

    ``T`` is the token count: ``S`` for the default set model, ``S·F`` for
    ``seq_type='flat'`` (VanillaTransformer), ``S(+1)`` with a prepended
    context token.  The total is multiplied by 3 for the backward pass
    (standard fwd + 2x bwd convention).  Elementwise/normalization/loss and
    optimizer work is excluded.
    """
    S = schema.max_length
    seq_cols = [c for c in schema.columns if c.is_sequence and not c.demo_only]
    F = len(seq_cols)
    T = S * F if seq_type == "flat" else S
    if context in ("id", "canvas", "length"):
        T += 1
    B, D = batch_size, latent_dim

    flops = 0.0
    for c in seq_cols:
        channels = c.shape[-1]
        if c.is_categorical:
            flops += 2.0 * B * S * channels * (c.input_dim + 2) * D
        else:
            flops += 2.0 * B * S * channels * D
    ff = ff_dim or 2 * D
    per_block = (
        6.0 * B * T * D * D          # fused QKV
        + 4.0 * B * T * T * D        # scores + attn·V
        + 2.0 * B * T * D * D        # output projection
        + 2.0 * B * T * D * ff * 2   # two-layer MLP
    )
    flops += num_blocks * per_block
    units = sum(
        c.shape[-1] * c.input_dim if c.is_categorical else c.shape[-1]
        for c in seq_cols
    )
    flops += 2.0 * B * S * D * units
    return 3.0 * flops


def mfu(
    flops_per_step: float,
    steps_per_sec: float,
    num_chips: int = 1,
    peak_flops: float = H100_BF16_PEAK_FLOPS,
) -> float:
    """Model FLOPs utilization in percent against the bf16 peak.  A
    float32 run is held to the same peak, so its figure understates the
    card's use: compare MFU across runs at one dtype."""
    return 100.0 * flops_per_step * steps_per_sec / (num_chips * peak_flops)


class StepTimer:
    """Throughput counter: steps/sec and items/sec since the last reset
    (host clock; a caller timing device work synchronises first)."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step
