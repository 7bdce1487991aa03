"""Masked scaled-dot-product attention: plain PyTorch and a CUDA kernel.

Counterpart of ``flexdm_tpu/ops/attention.py``.  The public function keeps
the JAX layout: ``q, k, v`` are ``(B, H, S, Dh)`` and ``key_mask`` is a
``(B, S)`` bool (False keys get the finite additive bias ``-1e9``).

* :func:`attention_reference` is the plain version of ``_attention_xla``.
* :func:`flash_attention_forward` launches the hand-written Hopper kernel
  ``csrc/flash_attention_fwd.cu``, which replaces the TPU kernel
  ``flexdm_tpu/ops/attention.py:_flash_fwd_kernel``.  The kernel note in the
  source says what bounds it on the H100 (at the serving shape B=8, H=8,
  S=50, Dh=32 it is a tiny, latency-bound launch) and what its design does
  about it (16-row query tiles, so 256 blocks fill the 132 SMs instead of
  64).
* :func:`dot_product_attention` dispatches on the device of its inputs: a
  CPU tensor takes the plain version, a CUDA tensor launches the kernel or
  raises.  There is no fallback between the two.

The TPU path's tile padding (``_pad_len``, ``_block_size``) and its
XLA-vs-Pallas rule (``_prefer_pallas``) are not carried over: the kernel
masks the ragged sequence end itself.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e9
SUPPORTED_HEAD_DIMS = (32, 64, 128)

# Launches of the CUDA kernel made by flash_attention_forward.
KERNEL_LAUNCHES = 0
_launches_lock = threading.Lock()

_KERNEL_SOURCES = ("flash_attention_fwd.cu",)


def key_bias(key_mask: Optional[torch.Tensor], b: int, s: int,
             device, dtype=torch.float32) -> torch.Tensor:
    """``(B, S)`` additive bias: 0 for attended keys, ``-1e9`` for masked."""
    if key_mask is None:
        return torch.zeros((b, s), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(key_mask, zero, torch.full_like(zero, NEG_INF))


def _scores(q, k, bias, causal):
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores + bias[:, None, None, :]
    if causal:
        s = q.shape[2]
        band = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~band, NEG_INF)
    return scores


def attention_reference(q, k, v, bias, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch attention (``_attention_xla``): ``bias`` is ``(B, S)``."""
    return torch.einsum(
        "bhqk,bhkd->bhqd", torch.softmax(_scores(q, k, bias, causal), -1), v
    )


def attention_reference_lse(q, k, bias, causal: bool = False) -> torch.Tensor:
    """Row logsumexp ``(B, H, S)`` of the scores, as the kernel writes it."""
    return torch.logsumexp(_scores(q, k, bias, causal), dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The bound C entry point (built with nvcc on first use)."""
    from . import _build

    lib = _build.load_library("flexdm_attention", _KERNEL_SOURCES)
    fn = lib.flexdm_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, key_mask):
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_forward needs CUDA tensors, got {q.device}"
        )
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(
                f"{name} must match q in device, shape and dtype: "
                f"{t.device}/{tuple(t.shape)}/{t.dtype} vs "
                f"{q.device}/{tuple(q.shape)}/{q.dtype}"
            )
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, Dh), got {tuple(q.shape)}")
    if q.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32, got {q.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if key_mask is not None:
        b, _, s, _ = q.shape
        if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, s)
                or key_mask.device != q.device
                or not key_mask.is_contiguous()):
            raise ValueError(
                f"key_mask must be a contiguous ({b}, {s}) bool on "
                f"{q.device}, got {key_mask.dtype} {tuple(key_mask.shape)} "
                f"on {key_mask.device}"
            )


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; returns ``O (B, H, S, Dh)`` and
    ``lse (B, H, S)``.  Raises on anything the kernel does not take."""
    global KERNEL_LAUNCHES
    _check_inputs(q, k, v, key_mask)
    fn = _kernel()
    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, s, dh, int(causal), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    with _launches_lock:
        KERNEL_LAUNCHES += 1
    return o, lse


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Masked scaled-dot-product attention, ``(B, H, S, Dh)`` in and out."""
    if q.device.type == "cuda":
        return flash_attention_forward(q, k, v, key_mask, causal)[0]
    if q.device.type == "cpu":
        b, _, s, _ = q.shape
        bias = key_bias(key_mask, b, s, q.device, q.dtype)
        return attention_reference(q, k, v, bias, causal)
    raise ValueError(f"no attention path for device {q.device}")
