"""Masked scaled-dot-product attention: plain PyTorch and CUDA kernels.

Counterpart of ``flexdm_tpu/ops/attention.py``.  The public function keeps
the JAX layout: ``q, k, v`` are ``(B, H, S, Dh)`` and ``key_mask`` is a
``(B, S)`` bool (False keys get the finite additive bias ``-1e9``).

* :func:`attention_reference` is the plain version of ``_attention_xla``;
  :func:`attention_reference_backward` is the plain version of the backward
  kernels, written out as the formulas autograd computes.
* :func:`flash_attention_forward` launches the hand-written Hopper kernel
  ``csrc/flash_attention_fwd.cu``, which replaces the TPU kernel
  ``_flash_fwd_kernel``: 64-row query tiles, both products (q k^T and
  p v) on the tensor cores with the split-TF32 arithmetic described
  below, K/V tiles by ``cp.async``.  The kernel note in the source says
  what bounds it on the H100.
* :func:`flash_attention_backward` launches ``csrc/flash_attention_bwd.cu``:
  a dq kernel (which also writes ``delta = rowsum(dO * O)``) and a dk/dv
  kernel.  They replace the TPU kernels ``_flash_bwd_dq_kernel`` /
  ``_flash_bwd_dkv_kernel`` and their S >= 4096 stream variants: they keep
  only tiles in shared memory, so one kernel covers every S.  Every
  product runs on the tensor cores (``mma.sync`` TF32) with each operand
  split into two TF32 terms and three products summed in float32, which
  keeps float32-level accuracy (~1e-6); tiles arrive by ``cp.async``.
* :class:`FlashAttention` wires the two into autograd (the JAX package's
  ``jax.custom_vjp``); the key mask gets no gradient.
* :func:`dot_product_attention` dispatches on the device of its inputs: a
  CPU tensor takes the plain version, a CUDA tensor launches the kernels or
  raises.  There is no fallback between the two.

The backward rebuilds probabilities as ``exp(s - m) / l`` from the
forward's row max and row sum, not from the logsumexp: in a fully masked
row every score rounds to exactly ``-1e9`` in float32, so does the
logsumexp, and ``exp(s - lse)`` would give 1 for every key where the
softmax gives ``1/S``.  The port follows the plain path there; the TPU
kernels do not.  The backward kernels compute the scores in other tiles
than the forward kernel, so their p is the forward's to ~1e-6 relative,
not bit for bit; a fully masked row still gets exactly ``1/S`` (its
scores round to ``-1e9`` = m, and the forward summed l = S).

The TPU path's tile padding (``_pad_len``, ``_block_size``) and its
XLA-vs-Pallas rule (``_prefer_pallas``) are not carried over: the kernels
mask the ragged sequence end themselves.
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

# Launches of each CUDA kernel: the forward, and the backward's dq (with
# delta) and dk/dv kernels.
KERNEL_LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
_launches_lock = threading.Lock()

# (library name, sources) of each kernel library, built by ops/_build.py.
FWD_LIBRARY = ("flexdm_attention", ("flash_attention_fwd.cu",))
BWD_LIBRARY = ("flexdm_attention_bwd", ("flash_attention_bwd.cu",))
LIBRARIES = (FWD_LIBRARY, BWD_LIBRARY)


def key_bias(key_mask: Optional[torch.Tensor], b: int, s: int,
             device, dtype=torch.float32) -> torch.Tensor:
    """``(B, S)`` additive bias: 0 for attended keys, ``-1e9`` for masked."""
    if key_mask is None:
        return torch.zeros((b, s), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(key_mask, zero, torch.full_like(zero, NEG_INF))


def _outside_causal_band(q):
    """``(S, S)`` True where a key comes after its query row."""
    s = q.shape[2]
    return torch.ones((s, s), dtype=torch.bool, device=q.device).triu(1)


def _scores(q, k, bias, causal):
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores + bias[:, None, None, :]
    if causal:
        scores = scores.masked_fill(_outside_causal_band(q), NEG_INF)
    return scores


def attention_reference(q, k, v, bias, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch attention (``_attention_xla``): ``bias`` is ``(B, S)``."""
    return torch.einsum(
        "bhqk,bhkd->bhqd", torch.softmax(_scores(q, k, bias, causal), -1), v
    )


def attention_reference_lse(q, k, bias, causal: bool = False) -> torch.Tensor:
    """Row logsumexp ``(B, H, S)`` of the scores, as the kernel writes it."""
    return torch.logsumexp(_scores(q, k, bias, causal), dim=-1)


def attention_reference_backward(q, k, v, bias, o, do, causal: bool = False):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` for the
    cotangent ``do`` of ``o = attention_reference(q, k, v, bias, causal)``.

    ``delta = sum(dO * O)``, ``p = softmax``, ``ds = p (dO V^T - delta)``
    (zero where the causal band replaced the score: that replacement passes
    no gradient), ``dq = scale ds K``, ``dk = scale ds^T Q``,
    ``dv = p^T dO``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, bias, causal), -1)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, v) - delta)
    if causal:
        ds = ds.masked_fill(_outside_causal_band(q), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    return dq, dk, dv


def _bind(name: str, sources, symbol: str, n_pointers: int):
    """The C entry point ``symbol``: ``n_pointers`` pointers, then B, H, S,
    Dh, causal, then the stream."""
    from . import _build

    fn = getattr(_build.load_library(name, sources), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    """The forward's bound C entry point (built with nvcc on first use)."""
    return _bind(*FWD_LIBRARY, "flexdm_flash_attention_fwd", 8)


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    """The backward's bound C entry points ``(dq, dkv)``."""
    return (_bind(*BWD_LIBRARY, "flexdm_flash_attention_bwd_dq", 10),
            _bind(*BWD_LIBRARY, "flexdm_flash_attention_bwd_dkv", 10))


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "copy rows 16 bytes at a time)")


def _check_inputs(q, k, v, key_mask):
    if q.device.type != "cuda":
        raise ValueError(
            f"the attention kernels need CUDA tensors, got {q.device}"
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
    _check_aligned(q=q, k=k, v=v)
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


def _forward(q, k, v, key_mask, causal):
    """Launch the forward kernel: ``O``, and the row ``lse``, max ``m`` and
    sum ``l`` (each ``(B, H, S)``)."""
    global KERNEL_LAUNCHES
    _check_inputs(q, k, v, key_mask)
    fn = _kernel()
    b, h, s, dh = q.shape
    o = torch.empty_like(q)
    lse, m, l = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    _launch(
        "flash_attention_fwd", fn,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
        o.data_ptr(), lse.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, s, dh, int(causal), _stream(q),
    )
    with _launches_lock:
        KERNEL_LAUNCHES += 1
    return o, lse, m, l


def _mask_ptr(key_mask):
    return None if key_mask is None else key_mask.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; returns ``O (B, H, S, Dh)`` and
    ``lse (B, H, S)``.  Raises on anything the kernel does not take."""
    return _forward(q, k, v, key_mask, causal)[:2]


def _check_backward_inputs(q, k, v, key_mask, o, m, l, do):
    _check_inputs(q, k, v, key_mask)
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor like q")
    _check_aligned(o=o, do=do)
    b, h, s, _ = q.shape
    for name, t in (("m", m), ("l", l)):
        if (tuple(t.shape) != (b, h, s) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({b}, {h}, {s}) "
                             f"float32 on {q.device}")


def _backward_dq(q, k, v, key_mask, o, m, l, do, causal=False):
    """Launch the dq kernel; returns ``dq`` and ``delta = rowsum(dO * O)``
    ``(B, H, S)``, which :func:`_backward_dkv` reads."""
    global BWD_DQ_LAUNCHES
    b, h, s, dh = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch(
        "flash_attention_bwd_dq", _bwd_kernels()[0],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
        o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, h, s, dh, int(causal), _stream(q),
    )
    with _launches_lock:
        BWD_DQ_LAUNCHES += 1
    return dq, delta


def _backward_dkv(q, k, v, key_mask, m, l, delta, do, causal=False):
    """Launch the dk/dv kernel; returns ``(dk, dv)``."""
    global BWD_DKV_LAUNCHES
    b, h, s, dh = q.shape
    dk, dv = torch.empty((2,) + tuple(q.shape), dtype=q.dtype,
                         device=q.device)
    _launch(
        "flash_attention_bwd_dkv", _bwd_kernels()[1],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
        do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, s, dh, int(causal), _stream(q),
    )
    with _launches_lock:
        BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_backward(q, k, v, key_mask, o, m, l, do, causal=False):
    """Launch the backward kernels for the cotangent ``do`` of ``o``, with
    the forward's row max ``m`` and row sum ``l``; returns ``(dq, dk, dv)``.
    Raises on anything the kernels do not take."""
    _check_backward_inputs(q, k, v, key_mask, o, m, l, do)
    dq, delta = _backward_dq(q, k, v, key_mask, o, m, l, do, causal)
    dk, dv = _backward_dkv(q, k, v, key_mask, m, l, delta, do, causal)
    return dq, dk, dv


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    global KERNEL_LAUNCHES, BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    with _launches_lock:
        KERNEL_LAUNCHES = BWD_DQ_LAUNCHES = BWD_DKV_LAUNCHES = 0


class FlashAttention(torch.autograd.Function):
    """The CUDA kernels as an autograd op: forward kernel, then the two
    backward kernels; the key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        o, _, m, l = _forward(q, k, v, key_mask, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, key_mask, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, m, l = ctx.saved_tensors
        # The cotangent arrives through o.transpose(1, 2).reshape(...): it
        # is not contiguous.
        dq, dk, dv = flash_attention_backward(
            q, k, v, key_mask, o, m, l, do.contiguous(), ctx.causal
        )
        return dq, dk, dv, None, None


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Masked scaled-dot-product attention, ``(B, H, S, Dh)`` in and out."""
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, key_mask, causal)
    if q.device.type == "cpu":
        b, _, s, _ = q.shape
        bias = key_bias(key_mask, b, s, q.device, q.dtype)
        return attention_reference(q, k, v, bias, causal)
    raise ValueError(f"no attention path for device {q.device}")
