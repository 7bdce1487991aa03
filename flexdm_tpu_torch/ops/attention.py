"""Masked scaled-dot-product attention: plain PyTorch and CUDA kernels.

Counterpart of ``flexdm_tpu/ops/attention.py``.  The public function keeps
the JAX layout: ``q, k, v`` are ``(B, H, S, Dh)`` and ``key_mask`` is a
``(B, S)`` bool (False keys get the finite additive bias ``-1e9``).

* :func:`attention_reference` is the plain version of ``_attention_xla``;
  :func:`attention_reference_backward` is the plain version of the backward
  kernels, written out as the formulas autograd computes.
* :func:`flash_attention_forward` launches the hand-written Hopper kernel
  ``csrc/flash_attention_fwd.cu``, which replaces the TPU kernel
  ``_flash_fwd_kernel``: persistent streams of 64-row query items, both
  products (q k^T and p v) warpgroup ``wgmma`` on the TF32 tensor cores
  with the split-TF32 arithmetic described below, K/V tiles brought in by
  TMA and split once by a warpgroup of their own (V transposed for p v).
  The kernel note in the source says what bounds it on the H100.
* :func:`flash_attention_backward` launches ``csrc/flash_attention_bwd.cu``:
  a dq kernel (which also writes ``delta = rowsum(dO * O)``) and a dk/dv
  kernel.  They replace the TPU kernels ``_flash_bwd_dq_kernel`` /
  ``_flash_bwd_dkv_kernel`` and their S >= 4096 stream variants: they keep
  only tiles in shared memory, so one kernel covers every S.  Every
  product is a warpgroup ``wgmma`` on the TF32 tensor cores with each
  operand split into two TF32 terms and three products summed in float32,
  which keeps float32-level accuracy (~1e-6); tiles arrive by TMA and are
  split once, by a warpgroup of their own (``csrc/wgmma_tf32.cuh``).
* Every head dim Dh from 1 to 128 runs through the kernels above
  (:func:`head_dim_plan`).  Their tile layouts are built at W = 32, 64 and
  128 columns; a call takes the smallest W that holds its rows, and TMA
  fills the columns past Dh with zeros, which change no score, no output
  and no gradient column below Dh (the scale stays 1/sqrt(Dh)).  Every Dh
  above 128 runs through the wide kernels, which compute the scores over
  the full row in chunks, so no tile or accumulator grows with Dh and there
  is no upper limit: ``csrc/flash_attention_fwd_wide.cu`` (the forward in
  both dtypes: persistent blocks over items of 64 query rows and a column
  block of 256 columns of O, so the scores are computed once a row at
  Dh <= 256; float32 on split-TF32 ``wgmma`` over 32-column chunks that
  TMA brings in and a splitter warpgroup splits once, bf16 on ``wgmma``
  over 64-column chunks that a producer warp keeps in flight),
  ``csrc/flash_attention_bwd_wide.cu`` (the float32 dq with delta and
  dk/dv on the same chunk pipeline, ``csrc/wide_tf32.cuh``, a column block
  of 256 columns of dq or 128 of dk and dv) and
  ``csrc/flash_attention_wide.cu`` (the bf16 dq and dk/dv on ``mma.sync``;
  a block owns one column block of its outputs, 128 columns of dq, 64 of
  dk and dv).  A row
  must be a multiple of 16 bytes (TMA, 16-byte copies): where Dh is not
  (Dh % 4 in float32, Dh % 8 in bf16), q, k, v (and O, dO) are copied once
  into a zero-padded buffer of the next such width, and the outputs are
  sliced back.  The copy is plain PyTorch around the kernels; each kernel still
  launches once.  The plain version takes every Dh.
* Both take float32 or bfloat16 (q, k and v of one dtype).  bfloat16
  launches the bf16 instances ``csrc/flash_attention_fwd_bf16.cu`` and
  ``csrc/flash_attention_bwd_bf16.cu``: every product a warpgroup
  ``wgmma`` on the bf16 tensor cores with float32 sums, over tiles that
  TMA copies (``csrc/wgmma_bf16.cuh``); the probabilities and ``ds`` enter
  their products as bf16 operands, and O, dq, dk and dv are rounded to
  bf16 once.  lse, m, l and delta stay float32.  A bf16 input is never
  upcast to reuse the float32 kernels.
* :class:`FlashAttention` wires the two into autograd (the JAX package's
  ``jax.custom_vjp``); the key mask gets no gradient.
* :func:`dot_product_attention` takes JAX's ``impl``: ``"xla"`` is the
  plain version on any device (the caller's choice: no kernel launches),
  ``"pallas"`` the kernels, which need CUDA tensors (a CPU tensor raises,
  as JAX's ``pallas`` without ``interpret`` does off the TPU), and
  ``"auto"`` dispatches on the device of its inputs: a CPU tensor takes the
  plain version, a CUDA tensor launches the kernels or raises.  There is no
  fallback between the two.

The backward rebuilds probabilities as ``exp(s - m) / l`` from the
forward's row max and row sum, not from the logsumexp: in a fully masked
row every score rounds to exactly ``-1e9`` in float32, so does the
logsumexp, and ``exp(s - lse)`` would give 1 for every key where the
softmax gives ``1/S``.  The port follows the plain path there; the TPU
kernels do not.  The backward kernels compute the scores in other tiles
than the forward kernel, so their p is the forward's to ~1e-6 relative,
not bit for bit; a fully masked row still gets exactly ``1/S`` (its
scores round to ``-1e9`` = m, and the forward summed l = S).

The plain versions take bfloat16 with the TPU kernels' semantics: the
inputs are upcast, everything is computed in float32, and O, dq, dk and
dv are cast to the input dtype once (``_flash_fwd_kernel`` and its
backward kernels), not XLA's bf16 scores and probabilities.  The key bias
stays float32 (-1e9) at every dtype; JAX builds it in q's dtype, so in
bf16 a fully masked row's lse there is -998244352 + log S, here
-1e9 + log S (O is the same).

The TPU path's tile padding (``_pad_len``, ``_block_size``) and its
XLA-vs-Pallas rule (``_prefer_pallas``, kernels from S >= 512, a TPU
measurement) are not carried over: the kernels mask the ragged sequence
end themselves, and ``"auto"`` on the card takes them at every S.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9
# The kernels take head dims from 1 to 128 on tile layouts KERNEL_WIDTHS
# columns wide (csrc/hopper.cuh, "Head dims"), and every wider one through
# the wide kernels, whose forward items span WIDE_COLUMNS columns of the
# row at a time (csrc/flash_attention_fwd_wide.cu; the float32 backward,
# csrc/flash_attention_bwd_wide.cu, 256 columns of dq, 128 of dk and dv;
# the bf16 backward, csrc/flash_attention_wide.cu, 128 of dq, 64 of dk and
# dv).
KERNEL_WIDTHS = (32, 64, 128)
WIDE_COLUMNS = 256

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The ``impl`` values of :func:`dot_product_attention` (JAX's names).
ATTENTION_IMPLS = ("auto", "xla", "pallas")

# Launches of each CUDA kernel: the forward, and the backward's dq (with
# delta) and dk/dv kernels; the BF16_ counts are the bf16 instances', the
# WIDE_ counts the wide kernels' (Dh > 128).
KERNEL_LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
BF16_FWD_LAUNCHES = 0
BF16_DQ_LAUNCHES = 0
BF16_DKV_LAUNCHES = 0
WIDE_FWD_LAUNCHES = 0
WIDE_DQ_LAUNCHES = 0
WIDE_DKV_LAUNCHES = 0
BF16_WIDE_FWD_LAUNCHES = 0
BF16_WIDE_DQ_LAUNCHES = 0
BF16_WIDE_DKV_LAUNCHES = 0
_launches_lock = threading.Lock()
# (kernel, bf16, wide) -> (its count's name above, the short name that
# launch_counts() reports it under).
_COUNTERS = {
    ("fwd", False, False): ("KERNEL_LAUNCHES", "fwd"),
    ("dq", False, False): ("BWD_DQ_LAUNCHES", "dq"),
    ("dkv", False, False): ("BWD_DKV_LAUNCHES", "dkv"),
    ("fwd", True, False): ("BF16_FWD_LAUNCHES", "fwd_bf16"),
    ("dq", True, False): ("BF16_DQ_LAUNCHES", "dq_bf16"),
    ("dkv", True, False): ("BF16_DKV_LAUNCHES", "dkv_bf16"),
    ("fwd", False, True): ("WIDE_FWD_LAUNCHES", "fwd_wide"),
    ("dq", False, True): ("WIDE_DQ_LAUNCHES", "dq_wide"),
    ("dkv", False, True): ("WIDE_DKV_LAUNCHES", "dkv_wide"),
    ("fwd", True, True): ("BF16_WIDE_FWD_LAUNCHES", "fwd_wide_bf16"),
    ("dq", True, True): ("BF16_WIDE_DQ_LAUNCHES", "dq_wide_bf16"),
    ("dkv", True, True): ("BF16_WIDE_DKV_LAUNCHES", "dkv_wide_bf16"),
}

# (library name, sources) of each kernel library, built by ops/_build.py.
FWD_LIBRARY = ("flexdm_attention", ("flash_attention_fwd.cu",))
BWD_LIBRARY = ("flexdm_attention_bwd", ("flash_attention_bwd.cu",))
FWD_BF16_LIBRARY = ("flexdm_attention_bf16", ("flash_attention_fwd_bf16.cu",))
BWD_BF16_LIBRARY = ("flexdm_attention_bwd_bf16",
                    ("flash_attention_bwd_bf16.cu",))
WIDE_LIBRARY = ("flexdm_attention_wide", ("flash_attention_wide.cu",))
BWD_WIDE_LIBRARY = ("flexdm_attention_bwd_wide",
                    ("flash_attention_bwd_wide.cu",))
FWD_WIDE_LIBRARY = ("flexdm_attention_fwd_wide",
                    ("flash_attention_fwd_wide.cu",))
LIBRARIES = (FWD_LIBRARY, BWD_LIBRARY, FWD_BF16_LIBRARY, BWD_BF16_LIBRARY,
             WIDE_LIBRARY, BWD_WIDE_LIBRARY, FWD_WIDE_LIBRARY)


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
    """float32 scores of (possibly bf16) q and k: the kernels' products
    take bf16 operands exactly and sum in float32."""
    q, k = q.float(), k.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    scores = scores + bias[:, None, None, :].float()
    if causal:
        scores = scores.masked_fill(_outside_causal_band(q), NEG_INF)
    return scores


def attention_reference(q, k, v, bias, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch attention (``_attention_xla``): ``bias`` is ``(B, S)``.
    Computed in float32 and returned in q's dtype."""
    return torch.einsum(
        "bhqk,bhkd->bhqd", torch.softmax(_scores(q, k, bias, causal), -1),
        v.float(),
    ).to(q.dtype)


def attention_reference_lse(q, k, bias, causal: bool = False) -> torch.Tensor:
    """Row logsumexp ``(B, H, S)`` of the scores (float32), as the kernel
    writes it."""
    return torch.logsumexp(_scores(q, k, bias, causal), dim=-1)


def attention_reference_backward(q, k, v, bias, o, do, causal: bool = False):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` for the
    cotangent ``do`` of ``o = attention_reference(q, k, v, bias, causal)``.

    ``delta = sum(dO * O)``, ``p = softmax``, ``ds = p (dO V^T - delta)``
    (zero where the causal band replaced the score: that replacement passes
    no gradient), ``dq = scale ds K``, ``dk = scale ds^T Q``,
    ``dv = p^T dO``, in float32 from the (possibly bf16) inputs; each
    gradient is cast to its input's dtype once."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_scores(q, k, bias, causal), -1)
    q32, k32, v32, o32, do32 = (t.float() for t in (q, k, v, o, do))
    delta = (do32 * o32).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do32, v32) - delta)
    if causal:
        ds = ds.masked_fill(_outside_causal_band(q), 0.0)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class HeadDimPlan(NamedTuple):
    """How the kernels run a head dim: on the tile layout ``width`` columns
    wide (the template instance; above 128, the columns the wide kernels'
    blocks span), over rows of ``row`` elements (Dh rounded up to 16
    bytes), through a zero-padded copy when ``copy`` (``row != Dh``)."""

    width: int
    row: int
    copy: bool

    @property
    def wide(self) -> bool:
        """The wide kernels (Dh > 128) run this head dim."""
        return self.width > KERNEL_WIDTHS[-1]


def head_dim_plan(dh: int, dtype=torch.float32) -> HeadDimPlan:
    """The kernels' plan for head dim ``dh`` in ``dtype`` (float32 or
    bfloat16): the row of ``dh`` rounded up to 16 bytes (4 float32, 8 bf16
    elements) on the smallest width of :data:`KERNEL_WIDTHS` that holds it,
    or, above 128, on the wide kernels, the row rounded up to
    :data:`WIDE_COLUMNS`.  Raises ``ValueError`` for ``dh < 1``.  The C
    entry points derive the same."""
    if dh < 1:
        raise ValueError(f"head dim {dh}: the attention kernels take every "
                         "Dh >= 1 (Dh = latent_dim / num_heads)")
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    row = -(-dh // per16) * per16
    width = next((w for w in KERNEL_WIDTHS if row <= w),
                 -(-row // WIDE_COLUMNS) * WIDE_COLUMNS)
    return HeadDimPlan(width, row, row != dh)


def check_head_dim(head_dim: int, impl: str = "auto", device="cuda") -> None:
    """Refuse, before any step, a head dim the kernels do not take (below 1)
    where ``impl`` would launch them (``auto`` or ``pallas`` on a CUDA
    ``device``): the training and eval CLIs and the server's load of
    ``args.json`` call it.  ``xla`` and the CPU take every head dim."""
    if impl != "xla" and torch.device(device).type == "cuda":
        head_dim_plan(head_dim)


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
def _kernel(dtype=torch.float32, wide=False):
    """The forward's bound C entry point for ``dtype`` (the wide kernel's
    with ``wide``; built with nvcc on first use)."""
    bf16 = dtype == torch.bfloat16
    library = (FWD_WIDE_LIBRARY if wide else FWD_BF16_LIBRARY if bf16
               else FWD_LIBRARY)
    return _bind(*library, _symbol("fwd", bf16, wide), 8)


@functools.lru_cache(maxsize=None)
def _bwd_kernels(dtype=torch.float32, wide=False):
    """The backward's bound C entry points ``(dq, dkv)`` for ``dtype`` (the
    wide kernels' with ``wide``: float32 in their own library, bf16 in
    ``csrc/flash_attention_wide.cu``)."""
    bf16 = dtype == torch.bfloat16
    if wide:
        library = WIDE_LIBRARY if bf16 else BWD_WIDE_LIBRARY
    else:
        library = BWD_BF16_LIBRARY if bf16 else BWD_LIBRARY
    return tuple(_bind(*library, _symbol(kernel, bf16, wide), 10)
                 for kernel in ("dq", "dkv"))


def _symbol(kernel: str, bf16: bool, wide: bool) -> str:
    """The C entry point of ``kernel`` ("fwd", "dq" or "dkv")."""
    part = "fwd" if kernel == "fwd" else f"bwd_{kernel}"
    return f"flexdm_flash_attention_{part}" + "_wide" * wide + "_bf16" * bf16


def _count(name: str) -> None:
    """One more launch on the counter ``name`` (one of the ``*_LAUNCHES``
    above)."""
    with _launches_lock:
        globals()[name] += 1


def _run(kernel: str, q, dh: int, *args) -> None:
    """Launch ``kernel`` ("fwd", "dq" or "dkv") of the instance that runs
    head dim ``dh`` in q's dtype on ``args`` (pointers, then B, H, S, Dh,
    causal, the stream), and count it."""
    bf16 = q.dtype == torch.bfloat16
    wide = head_dim_plan(dh, q.dtype).wide
    if kernel == "fwd":
        fn = _kernel(q.dtype, wide)
    else:
        fn = _bwd_kernels(q.dtype, wide)[kernel == "dkv"]
    _launch(_symbol(kernel, bf16, wide), fn, *args)
    _count(_COUNTERS[kernel, bf16, wide][0])


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "copy rows 16 bytes at a time)")


def _check_dtypes(q, k, v):
    """float32 and bfloat16 have kernel instances; another dtype, or q, k
    and v of mixed dtypes, raises (nothing is cast to fit)."""
    if q.dtype not in KERNEL_DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(
            "q, k and v must be all float32 or all bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )


def _check_inputs(q, k, v, key_mask, dh=None):
    """What the kernels take: q, k and v alike, contiguous, aligned CUDA
    tensors of a kernel dtype, ``(B, H, S, row)`` for the head dim ``dh``
    (default: their own width, unpadded), whose row the plan of ``dh``
    gives; the key mask a contiguous ``(B, S)`` bool beside them."""
    _check_dtypes(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(
            f"the attention kernels need CUDA tensors, got {q.device}"
        )
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.shape != q.shape:
            raise ValueError(
                f"{name} must match q in device and shape: "
                f"{t.device}/{tuple(t.shape)} vs {q.device}/{tuple(q.shape)}"
            )
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, Dh), got {tuple(q.shape)}")
    _head_dim(q, dh)
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


def _head_dim(q, dh=None) -> int:
    """The head dim ``dh`` (default: q's width) whose kernel rows q's are;
    raises otherwise (a launch on other rows would read past them)."""
    dh = q.shape[-1] if dh is None else dh
    row = head_dim_plan(dh, q.dtype).row
    if q.shape[-1] != row:
        raise ValueError(
            f"head dim {dh} in {q.dtype} runs on rows of {row} elements "
            f"(a zero-padded copy), got {q.shape[-1]}"
        )
    return dh


def _padded(dh, dtype, *tensors):
    """``tensors`` (each ``(..., dh)``) on the kernels' rows for head dim
    ``dh``: themselves, or zero-padded copies."""
    row = head_dim_plan(dh, dtype).row
    return tuple(t if row == dh else F.pad(t, (0, row - dh))
                 for t in tensors)


def _unpadded(dh, *tensors):
    """The first ``dh`` columns of each of ``tensors``, contiguous."""
    return tuple(t if t.shape[-1] == dh else t[..., :dh].contiguous()
                 for t in tensors)


def _launch_forward(q, k, v, key_mask, causal, dh):
    """Launch the forward kernel on q, k, v on the rows of head dim ``dh``
    (checked): ``O`` (as wide), and the row ``lse``, max ``m`` and sum ``l``
    (each ``(B, H, S)``)."""
    _check_inputs(q, k, v, key_mask, dh)
    b, h, s, _ = q.shape
    o = torch.empty_like(q)
    lse, m, l = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    _run("fwd", q, dh,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
         o.data_ptr(), lse.data_ptr(), m.data_ptr(), l.data_ptr(),
         b, h, s, dh, int(causal), _stream(q))
    return o, lse, m, l


def _forward(q, k, v, key_mask, causal):
    """Launch the forward kernel on ``(B, H, S, Dh)`` q, k, v (copied onto
    zero-padded rows where :func:`head_dim_plan` says so): ``O``, and the
    row ``lse``, max ``m`` and sum ``l`` (each ``(B, H, S)``)."""
    _check_dtypes(q, k, v)
    dh = q.shape[-1]
    o, lse, m, l = _launch_forward(*_padded(dh, q.dtype, q, k, v), key_mask,
                                   causal, dh)
    return _unpadded(dh, o) + (lse, m, l)


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


def _check_backward_inputs(q, k, v, key_mask, o, m, l, do, dh=None):
    _check_inputs(q, k, v, key_mask, dh)
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


def _backward_dq(q, k, v, key_mask, o, m, l, do, causal=False, dh=None):
    """Launch the dq kernel; returns ``dq`` and ``delta = rowsum(dO * O)``
    ``(B, H, S)``, which :func:`_backward_dkv` reads.  The tensors are on
    the kernels' rows of head dim ``dh`` (default: their width)."""
    b, h, s, _ = q.shape
    dh = _head_dim(q, dh)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _run("dq", q, dh,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
         o.data_ptr(), do.data_ptr(), m.data_ptr(), l.data_ptr(),
         delta.data_ptr(), dq.data_ptr(), b, h, s, dh, int(causal), _stream(q))
    return dq, delta


def _backward_dkv(q, k, v, key_mask, m, l, delta, do, causal=False, dh=None):
    """Launch the dk/dv kernel; returns ``(dk, dv)`` (rows as
    :func:`_backward_dq`'s)."""
    b, h, s, _ = q.shape
    dh = _head_dim(q, dh)
    dk, dv = torch.empty((2,) + tuple(q.shape), dtype=q.dtype,
                         device=q.device)
    _run("dkv", q, dh,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(key_mask),
         do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
         dk.data_ptr(), dv.data_ptr(), b, h, s, dh, int(causal), _stream(q))
    return dk, dv


def _launch_backward(q, k, v, key_mask, o, m, l, do, causal, dh):
    """Both backward kernels on the rows of head dim ``dh`` (checked)."""
    _check_backward_inputs(q, k, v, key_mask, o, m, l, do, dh)
    dq, delta = _backward_dq(q, k, v, key_mask, o, m, l, do, causal, dh)
    dk, dv = _backward_dkv(q, k, v, key_mask, m, l, delta, do, causal, dh)
    return dq, dk, dv


def flash_attention_backward(q, k, v, key_mask, o, m, l, do, causal=False):
    """Launch the backward kernels for the cotangent ``do`` of ``o``, with
    the forward's row max ``m`` and row sum ``l``; returns ``(dq, dk, dv)``.
    q, k, v, o and do are ``(B, H, S, Dh)`` (copied onto zero-padded rows
    where :func:`head_dim_plan` says so).  Raises on anything the kernels
    do not take."""
    _check_dtypes(q, k, v)
    dh = q.shape[-1]
    q, k, v, o, do = _padded(dh, q.dtype, q, k, v, o, do)
    return _unpadded(dh, *_launch_backward(q, k, v, key_mask, o, m, l, do,
                                           causal, dh))


def instance_names(dtype=torch.float32, dh: int = 32) -> Tuple[str, ...]:
    """The short names (:func:`launch_counts`' keys) of the forward, dq and
    dk/dv kernels that run head dim ``dh`` in ``dtype``."""
    key = (dtype == torch.bfloat16, head_dim_plan(dh, dtype).wide)
    return tuple(_COUNTERS[(kernel,) + key][1]
                 for kernel in ("fwd", "dq", "dkv"))


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _launches_lock:
        for name, _ in _COUNTERS.values():
            globals()[name] = 0


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by the short names the tools print:
    ``fwd``, ``dq``, ``dkv``, their ``*_bf16`` instances and the wide
    kernels' ``*_wide`` and ``*_wide_bf16``."""
    with _launches_lock:
        return {short: globals()[name] for name, short in _COUNTERS.values()}


class FlashAttention(torch.autograd.Function):
    """The CUDA kernels as an autograd op: forward kernel, then the two
    backward kernels; the key mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        # q, k, v and O are kept on the kernels' rows: a padded copy is
        # made once a forward, not again in the backward.
        dh = q.shape[-1]
        q, k, v = _padded(dh, q.dtype, q, k, v)
        o, _, m, l = _launch_forward(q, k, v, key_mask, causal, dh)
        ctx.causal, ctx.dh = causal, dh
        ctx.save_for_backward(q, k, v, key_mask, o, m, l)
        return _unpadded(dh, o)[0]

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, m, l = ctx.saved_tensors
        # The cotangent arrives through o.transpose(1, 2).reshape(...): it
        # is not contiguous.
        (do,) = _padded(ctx.dh, q.dtype, do.contiguous())
        dq, dk, dv = _unpadded(ctx.dh, *_launch_backward(
            q, k, v, key_mask, o, m, l, do, ctx.causal, ctx.dh))
        return dq, dk, dv, None, None


def check_impl(impl: str, device=None) -> None:
    """Raise ``ValueError`` for an ``impl`` not in :data:`ATTENTION_IMPLS`
    and, when ``device`` is given, for ``"pallas"`` off a CUDA device."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {ATTENTION_IMPLS}")
    if impl == "pallas" and device is not None and \
            torch.device(device).type != "cuda":
        raise ValueError(
            f"attention impl 'pallas' runs the CUDA kernels, which need a "
            f"CUDA device, got {device}; 'xla' is the plain version there")


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Masked scaled-dot-product attention, ``(B, H, S, Dh)`` in and out,
    float32 or bfloat16; ``impl`` as the module docstring says."""
    _check_dtypes(q, k, v)
    check_impl(impl, q.device)
    if impl == "pallas" or (impl == "auto" and q.device.type == "cuda"):
        return FlashAttention.apply(q, k, v, key_mask, causal)
    if impl == "xla" or q.device.type == "cpu":
        b, _, s, _ = q.shape
        bias = key_bias(key_mask, b, s, q.device)
        return attention_reference(q, k, v, bias, causal)
    raise ValueError(f"no attention path for device {q.device}")
