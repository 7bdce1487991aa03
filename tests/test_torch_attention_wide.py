"""The wide attention kernels' algorithm (every head dim above 128)
emulated on the CPU and held to the JAX package's Pallas kernels in
interpret mode.

The forward (``csrc/flash_attention_fwd_wide.cu``, both dtypes) is emulated
in its order of work: items of 64 query rows and a column block of 256
columns of O; key tiles of 32 keys (float32) or 64 (bf16); the scores
q k^T over the row's chunks (32 float32 or 64 bf16 columns, the last zero
past the row), float32's in two sums, the small terms (lo hi' + hi lo')
and the large (hi hi') chained over every k8 step of every chunk
(:func:`two_set_scores`); x = s scale log2 e + bias log2 e, the online
softmax in log2 units, m = m2 ln 2 written; then each tile's O += P V, in
float32 from the score accumulators as the A operand times the transposed
V tile (:func:`transposed_product`, 32 columns at a time from zero, added
in float32), in bf16 with P rounded to bf16 and float32 sums, O rounded to
bf16 once (:func:`emulate_forward_wgmma`, :func:`emulate_forward_bf16`).
Every column block computes the same scores in the same order, so m and l
are computed once.

The bf16 backward (``csrc/flash_attention_wide.cu``) is emulated in its
order of work: each output column block (128 columns of dq, 64 of dk and
dv) on its own, the scores (q k^T and dO v^T) summed over the full row in
64-column chunks, tiles of 64 keys (or query rows for dk/dv) in turn, and
delta = rowsum(dO O) over the full row; bf16 operands (p and ds rounded to
bf16) and float32 sums, the outputs rounded to bf16 once.

The float32 backward (``csrc/flash_attention_bwd_wide.cu``, warpgroup
``wgmma`` on TMA-fed chunks) is emulated in its own order
(:func:`emulate_backward_wgmma`): items of 64 rows (query rows for dq, keys
for dk/dv) and one column block of the outputs (256 columns of dq, 128 of
dk and dv); tiles of 32 keys (or query rows) of the other axis; the score
products as the forward's; p and ds in log2 units from the forward's m and
l; then each tile's second product (ds k, p^T dO, ds^T q) from the score
accumulators as the A operand (``a_from_acc_columns``) times the
transposed tile, rows at ``acc_order`` in the 128-byte swizzled K-major
layout the kernels' splitters write and ``wgmma`` reads
(:func:`transposed_product`), 32 columns at a time, each summed from zero
(small terms first) and added in float32.  ``TileLayout``, the split (lo
read to 19 bits), ``a_from_acc_columns`` and ``products`` are those of
``tests/test_torch_attention_tf32_wgmma.py``.  With the transposed tiles'
rows in their own order (V^T in the forward; K^T, Q^T, dO^T in the
backward) the emulation misses the bars.

Rows whose Dh is not a multiple of 16 bytes run on zero-padded copies (Dh
129: 132 float32, 136 bf16), as ``ops/attention.py`` hands them to the
kernels; the scale is 1/sqrt(Dh).  Held to JAX's ``_flash_forward`` and its
Pallas backward (interpret mode, any Dh as one block) on the same seeded
numpy inputs: O and lse within 2e-5, dq, dk and dv within 1e-4 (bf16: one
bf16 ulp + 2^-8 of the largest reference entry).  A fully masked row (the
last batch element, every key masked) is held to JAX's XLA path, which the
port follows there (JAX's padded Pallas path rebuilds p from lse and adds
its causal -1e9 to the key bias).  With the scale of the chunk width or of
a column block the emulation misses the bars.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdm_tpu.ops import attention as jax_attn
from flexdm_tpu_torch.ops import attention as port_attn
from tests.test_torch_attention_tf32_wgmma import (  # noqa: E402
    TileLayout, a_from_acc_columns, acc_order, products)
from tests.test_torch_attention_tf32_wgmma import split as split_read

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
CARD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = 2.0 ** -7

ROWS = 64  # a block's rows, and the other axis's tile
OUT_COLS = 128  # the bf16 backward's column block of dq
KV_COLS = 64  # the bf16 backward's column block of dk and dv
CHUNK = {torch.float32: 32, torch.bfloat16: 64}
# The forward's column block of O (csrc/flash_attention_fwd_wide.cu).
FWD_COLS = 256

# The float32 backward's items, column blocks, other-axis tiles and chunks
# (csrc/flash_attention_bwd_wide.cu).
DQ_COLS = 256
DKV_COLS = 128
OTHER = 32
F32_CHUNK = 32
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
MASKED2 = np.float32(np.float32(-1e9) * LOG2E)  # kMaskedLog2

WIDE_HEAD_DIMS = (129, 136, 192, 256, 264, 512)
SHAPES = ((2, 2, 50), (1, 2, 130))


# ---------------------------------------------------------------------------
# The kernels' arithmetic
# ---------------------------------------------------------------------------

def tf32_round(x):
    """Round to nearest on the low 13 bits (the kernels' hi and lo)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mma_sum(acc, a, b, bf16):
    """``acc + a @ b`` as the kernels chain their products: bf16 operands
    (exact products) with float32 sums, or k8 steps of three TF32 products
    summed from zero and added to the running sum in float32."""
    if bf16:
        return acc + a.bfloat16().float() @ b.bfloat16().float()
    (ah, al), (bh, bl) = split(a), split(b)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        step = al[..., s] @ bh[..., s, :] + ah[..., s] @ bl[..., s, :]
        acc = acc + (step + ah[..., s] @ bh[..., s, :])
    return acc


def chunk_scores(a, b, chunk, bf16):
    """``a b^T`` over the full row, chunk by chunk: a (..., M, ld) and
    b (..., N, ld)."""
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for c0 in range(0, a.shape[-1], chunk):
        out = mma_sum(out, a[..., c0:c0 + chunk],
                      b[..., c0:c0 + chunk].transpose(-1, -2), bf16)
    return out


def _band(rows, keys):
    """True where key index > row index (replaced by the causal band)."""
    return keys[None, :] > rows[:, None]


def emulate_backward(q, k, v, mask, o, do, m, l, causal, dh,
                     scale_dim=None):
    """dq, dk, dv of the bf16 wide dq and dk/dv kernels of
    ``flash_attention_wide.cu`` (rows as :func:`emulate_forward_bf16`'s,
    their values bf16)."""
    bf16 = True
    b, h, s, ld = q.shape
    scale = 1.0 / math.sqrt(scale_dim or dh)
    chunk = CHUNK[torch.bfloat16]
    bias = port_attn.key_bias(mask, b, s, "cpu")
    idx = torch.arange(s)
    delta = (do * o).sum(-1)  # over the full row, before any use
    dq = torch.zeros_like(q)
    for c0 in range(0, ld, OUT_COLS):
        cols = slice(c0, c0 + OUT_COLS)
        acc = torch.zeros_like(q[..., cols])
        for k0 in range(0, s, ROWS):
            keys = slice(k0, k0 + ROWS)
            sc = chunk_scores(q, k[..., keys, :], chunk, bf16) * scale \
                + bias[:, None, None, keys]
            dp = chunk_scores(do, v[..., keys, :], chunk, bf16)
            replaced = (_band(idx, idx[keys]) if causal
                        else torch.zeros(s, len(idx[keys]), dtype=torch.bool))
            sc = sc.masked_fill(replaced, port_attn.NEG_INF)
            p = torch.exp(sc - m[..., None]) * (1.0 / l)[..., None]
            ds = (p * (dp - delta[..., None])).masked_fill(replaced, 0.0)
            acc = mma_sum(acc, ds, k[..., keys, cols], bf16)
        dq[..., cols] = acc * scale
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c0 in range(0, ld, KV_COLS):
        cols = slice(c0, c0 + KV_COLS)
        acc_dk = torch.zeros_like(k[..., cols])
        acc_dv = torch.zeros_like(v[..., cols])
        for i0 in range(0, s, ROWS):
            rws = slice(i0, i0 + ROWS)
            sc = chunk_scores(k, q[..., rws, :], chunk, bf16) * scale \
                + bias[:, None, :, None]
            dp = chunk_scores(v, do[..., rws, :], chunk, bf16)
            replaced = (_band(idx[rws], idx).T if causal
                        else torch.zeros(s, len(idx[rws]), dtype=torch.bool))
            sc = sc.masked_fill(replaced, port_attn.NEG_INF)
            p = torch.exp(sc - m[..., None, rws]) * (
                1.0 / l[..., None, rws])
            ds = (p * (dp - delta[..., None, rws])).masked_fill(replaced, 0.0)
            acc_dv = mma_sum(acc_dv, p, do[..., rws, cols], bf16)
            acc_dk = mma_sum(acc_dk, ds, q[..., rws, cols], bf16)
        dk[..., cols] = acc_dk * scale
        dv[..., cols] = acc_dv
    return tuple(x.bfloat16().float() for x in (dq, dk, dv))


def two_set_scores(a, b):
    """``a b^T`` over the full row as the float32 backward sums it: a
    (..., M, ld) and b (..., N, ld), ld a multiple of the chunk; chunk by
    chunk, every k8 step split (lo read to 19 bits), its small terms
    (lo hi' + hi lo') chained into one sum and its large term (hi hi') into
    another across every chunk, the two added in float32 at the end."""
    small = large = 0
    for c0 in range(0, a.shape[-1], F32_CHUNK):
        for k0 in range(c0, c0 + F32_CHUNK, 8):
            ah, al = split_read(a[..., k0:k0 + 8])
            bh, bl = split_read(b[..., k0:k0 + 8].transpose(-1, -2))
            small = small + al @ bh + ah @ bl
            large = large + ah @ bh
    return large + small


@functools.lru_cache(maxsize=None)
def _transposed_layout(dc):
    """The 128-byte swizzled layout of a (dc, 32) transposed tile (rows the
    output columns, the 32 k positions one 128-byte row): an F32Tile."""
    return TileLayout(dc, OTHER, 128)


def transposed_product(acc, p, x, order=acc_order):
    """``acc + p x`` as the float32 backward's second products run it: p
    (..., 64, 32) the score accumulators, taken as the A operand in place
    (``a_from_acc_columns``: accumulator column 2t at k = t, 2t + 1 at
    k = t + 4), x (..., 32, dc) the other axis's tile, which the splitters
    write transposed into a swizzled K-major tile, row r of x at k position
    ``order(r)`` (acc_order; another order is the mutation case), read k8
    step by k8 step as wgmma reads it, 32 output columns at a time, each
    summed from zero (small terms first, ``products``) and added in
    float32."""
    dc = x.shape[-1]
    layout = _transposed_layout(dc)
    xt = torch.empty(x.shape[:-2] + (dc, OTHER))
    xt[..., torch.tensor([order(r) for r in range(OTHER)])] = \
        x.transpose(-1, -2)
    buf = layout.landed(xt)
    out = acc.clone()
    for c0 in range(0, dc, 32):
        out[..., c0:c0 + 32] += products(
            [(p[..., torch.from_numpy(a_from_acc_columns(j))],
              layout.k_major(buf, j)[..., c0:c0 + 32])
             for j in range(OTHER // 8)])
    return out


def _pad_to(x, rows, cols):
    """``x`` (..., S, ld) zero-padded to ``rows`` rows and ``cols``
    columns (TMA's fill past S and past ld)."""
    return torch.nn.functional.pad(
        x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def _softmax_scale_log2(dh):
    """1/sqrt(Dh) log2 e in float32, as the launches compute it
    (``softmax_scale(Dh, kLog2e)``)."""
    return float(np.float32(np.float32(1.0) / np.sqrt(np.float32(dh)))
                 * LOG2E)


def _key_bias2(mask, s, keys):
    """(B, keys) key biases in log2 units, -1e9 log2 e past S."""
    bias2 = torch.full((mask.shape[0], keys), float(MASKED2))
    bias2[:, :s] = torch.where(mask, 0.0, float(MASKED2))
    return bias2


def _online_step(x, m2, l, acc):
    """One key tile of the online softmax in log2 units: the new row max,
    p = 2^(x - m2), the rescaled sum and accumulator."""
    m_new = torch.maximum(m2, x.amax(-1))
    alpha = torch.exp2(m2 - m_new)
    p = torch.exp2(x - m_new[..., None])
    return m_new, p, l * alpha + p.sum(-1), acc * alpha[..., None]


def _tile_x(sc, c1, bias2, keys, rows, s, causal):
    """x = s scale log2 e + bias log2 e of a key tile, replaced scores
    -1e9 log2 e, keys past S -inf."""
    x = sc * c1 + bias2[:, None, None, None, keys]
    if causal:
        x = torch.where(keys > rows, float(MASKED2), x)
    return torch.where(keys < s, x, -math.inf)


def _forward_stats(acc, m2, l, b, h, sp, s, ld):
    """O = acc / l sliced to (S, ld), and lse, m = m2 ln 2, l."""
    o = (acc / l[..., None]).reshape(b, h, sp, -1)[..., :s, :ld]
    m = (m2 * LN2).reshape(b, h, sp)[..., :s]
    l = l.reshape(b, h, sp)[..., :s]
    return o, m + torch.log(l), m, l


def emulate_forward_wgmma(q, k, v, mask, causal, dh, order=acc_order,
                          scale_dim=None):
    """O, lse, m, l of the float32 forward of
    ``csrc/flash_attention_fwd_wide.cu`` on rows of ``ld`` >= Dh (float32
    tensors): per item (64 query rows) and key tile (32 keys), the scores
    in two sums over the row's chunks (:func:`two_set_scores`), the online
    softmax in log2 units, then O = O alpha + P V with each column block's
    P V from the score accumulators on the transposed V tile, rows at
    ``order`` (acc_order; another order is the mutation case), 32 columns
    at a time from zero, added in float32 (:func:`transposed_product`).
    ``scale_dim``: the dim of the softmax scale (default Dh)."""
    b, h, s, ld = q.shape
    c1 = _softmax_scale_log2(scale_dim or dh)
    sp = -(-s // ROWS) * ROWS  # whole items
    n_t = -(-s // OTHER)       # key tiles an item visits
    lc = -(-ld // FWD_COLS) * FWD_COLS  # whole column blocks
    qp = _pad_to(q, sp, lc)
    kp, vp = (_pad_to(x, n_t * OTHER, lc) for x in (k, v))
    bias2 = _key_bias2(mask, s, n_t * OTHER)
    n_items = sp // ROWS
    qi = qp.reshape(b, h, n_items, ROWS, lc)
    rows = torch.arange(sp).reshape(n_items, ROWS, 1)
    m2 = torch.full((b, h, n_items, ROWS), -math.inf)
    l = torch.zeros(b, h, n_items, ROWS)
    acc = torch.zeros(b, h, n_items, ROWS, lc)
    for j in range(n_t):
        keys = torch.arange(j * OTHER, (j + 1) * OTHER)
        kt, vt = kp[:, :, None, keys], vp[:, :, None, keys]
        x = _tile_x(two_set_scores(qi, kt), c1, bias2, keys, rows, s, causal)
        m2, p, l, acc = _online_step(x, m2, l, acc)
        for c0 in range(0, lc, FWD_COLS):
            cols = slice(c0, c0 + FWD_COLS)
            acc[..., cols] = transposed_product(acc[..., cols], p,
                                                vt[..., cols], order)
    return _forward_stats(acc, m2, l, b, h, sp, s, ld)


def emulate_forward_bf16(q, k, v, mask, causal, dh, scale_dim=None):
    """O, lse, m, l of the bf16 forward of
    ``csrc/flash_attention_fwd_wide.cu`` on rows of ``ld`` >= Dh (float32
    tensors of bf16 values): per item (64 query rows) and key tile (64
    keys), the scores over the row's 64-column chunks (exact bf16 products,
    float32 sums), the online softmax in log2 units (l sums the float32 p),
    then O = O alpha + P V with P rounded to bf16, float32 sums; O rounded
    to bf16 once."""
    b, h, s, ld = q.shape
    c1 = _softmax_scale_log2(scale_dim or dh)
    bk = ROWS  # keys a tile
    sp = -(-s // ROWS) * ROWS  # whole items, and whole key tiles
    qp, kp, vp = (_pad_to(x, sp, ld) for x in (q, k, v))
    bias2 = _key_bias2(mask, s, sp)
    n_items = sp // ROWS
    qi = qp.reshape(b, h, n_items, ROWS, ld)
    rows = torch.arange(sp).reshape(n_items, ROWS, 1)
    m2 = torch.full((b, h, n_items, ROWS), -math.inf)
    l = torch.zeros(b, h, n_items, ROWS)
    acc = torch.zeros(b, h, n_items, ROWS, ld)
    for j in range(sp // bk):
        keys = torch.arange(j * bk, (j + 1) * bk)
        kt, vt = kp[:, :, None, keys], vp[:, :, None, keys]
        sc = chunk_scores(qi, kt, CHUNK[torch.bfloat16], True)
        x = _tile_x(sc, c1, bias2, keys, rows, s, causal)
        m2, p, l, acc = _online_step(x, m2, l, acc)
        acc = acc + p.bfloat16().float() @ vt
    o, lse, m, l = _forward_stats(acc, m2, l, b, h, sp, s, ld)
    return o.bfloat16().float(), lse, m, l


def emulate_backward_wgmma(q, k, v, mask, o, do, m, l, causal, dh,
                           order=acc_order, scale_dim=None):
    """dq, dk, dv of ``csrc/flash_attention_bwd_wide.cu`` on rows of ``ld``
    >= Dh (float32 tensors), from the forward's m and l.  ``order``: the k
    position of a source row in the transposed tiles (another order is the
    mutation case); ``scale_dim``: the dim of the softmax scale (default
    Dh).  Every column block computes the same scores in the same order,
    so they are computed once a tile here; causal dq's key tiles past an
    item's last row add exact zeros (the kernel skips them)."""
    b, h, s, ld = q.shape
    scale = np.float32(1.0) / np.sqrt(np.float32(scale_dim or dh))
    c1 = float(np.float32(scale * LOG2E))
    sp = -(-s // ROWS) * ROWS  # whole items (and whole tiles of 32)
    n_items = sp // ROWS
    n_dq, n_kv = -(-ld // DQ_COLS), -(-ld // DKV_COLS)
    lc = max(n_dq * DQ_COLS, n_kv * DKV_COLS)
    qp, kp, vp, op, dop = (_pad_to(x, sp, lc) for x in (q, k, v, o, do))
    valid = torch.arange(sp) < s
    bias2 = torch.full((b, sp), float(MASKED2))
    bias2[:, :s] = torch.where(mask, 0.0, float(MASKED2))
    m2 = torch.zeros(b, h, sp)
    m2[..., :s] = m * float(LOG2E)
    inv_l = torch.zeros(b, h, sp)
    inv_l[..., :s] = 1.0 / l
    delta = (dop * op).sum(-1)
    idx = torch.arange(sp).reshape(n_items, ROWS, 1)  # own rows, by item

    def items(x):
        return x.reshape(b, h, n_items, ROWS, lc)

    def tile(x, j):  # the other axis's tile j, beside every item
        return x[:, :, None, j * OTHER:(j + 1) * OTHER]

    # dq: per item, per key tile.
    dq = torch.zeros(b, h, n_items, ROWS, lc)
    qi, doi = items(qp), items(dop)
    mi = m2.reshape(b, h, n_items, ROWS, 1)
    li = inv_l.reshape(b, h, n_items, ROWS, 1)
    di = delta.reshape(b, h, n_items, ROWS, 1)
    for j in range(sp // OTHER):
        keys = torch.arange(j * OTHER, (j + 1) * OTHER)
        kt, vt = tile(kp, j), tile(vp, j)
        sc = two_set_scores(qi, kt)
        dp = two_set_scores(doi, vt)
        replaced = causal & (keys > idx)
        x = torch.where(replaced, float(MASKED2),
                        sc * c1 + bias2[:, None, None, None, keys])
        p = torch.exp2(x - mi) * li
        ds = torch.where(valid[keys] & ~replaced, p * (dp - di), 0.0)
        for c0 in range(0, n_dq * DQ_COLS, DQ_COLS):
            cols = slice(c0, c0 + DQ_COLS)
            dq[..., cols] = transposed_product(dq[..., cols], ds,
                                               kt[..., cols], order)
    dq = (dq * float(scale)).reshape(b, h, sp, lc)

    # dk, dv: per item (64 keys), per tile of 32 query rows.
    dk = torch.zeros(b, h, n_items, ROWS, lc)
    dv = torch.zeros_like(dk)
    ki, vi = items(kp), items(vp)
    kbias = bias2.reshape(b, 1, n_items, ROWS, 1)
    for j in range(sp // OTHER):
        r = torch.arange(j * OTHER, (j + 1) * OTHER)
        qt, dot = tile(qp, j), tile(dop, j)
        sc = two_set_scores(ki, qt)  # s^T
        dp = two_set_scores(vi, dot)  # dp^T
        replaced = causal & (idx > r)
        x = torch.where(replaced, float(MASKED2), sc * c1 + kbias)
        p = torch.exp2(x - m2[:, :, None, None, r]) \
            * inv_l[:, :, None, None, r]
        p = torch.where(valid[r] & valid.reshape(n_items, ROWS, 1), p, 0.0)
        ds = torch.where(replaced, 0.0,
                         p * (dp - delta[:, :, None, None, r]))
        for c0 in range(0, n_kv * DKV_COLS, DKV_COLS):
            cols = slice(c0, c0 + DKV_COLS)
            dv[..., cols] = transposed_product(dv[..., cols], p,
                                               dot[..., cols], order)
            dk[..., cols] = transposed_product(dk[..., cols], ds,
                                               qt[..., cols], order)
    dk = (dk * float(scale)).reshape(b, h, sp, lc)
    dv = dv.reshape(b, h, sp, lc)
    return tuple(x[..., :s, :ld] for x in (dq, dk, dv))


# ---------------------------------------------------------------------------
# Inputs and references
# ---------------------------------------------------------------------------

def _inputs(shape, seed, dtype):
    """Seeded q, k, v, dO (float32, bf16-valued for bf16) and a key mask
    dropping the last fifth of the keys and, where B > 1, every key of the
    last batch element (a fully masked row)."""
    rng = np.random.default_rng(seed)
    b, _, s, _ = shape
    arrays = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              .to(dtype).float() for _ in range(4)]
    mask = np.ones((b, s), bool)
    mask[:, s - s // 5:] = False
    if b > 1:
        mask[-1] = False
    return (*arrays, torch.from_numpy(mask))


def _rows(dh, dtype, *tensors):
    """The kernels' rows of head dim ``dh`` in ``dtype``: zero-padded to
    ``head_dim_plan``'s row."""
    return port_attn._padded(dh, dtype, *tensors)


def _emulate(q, k, v, do, mask, causal, dtype, scale_dim=None,
             order=acc_order, fwd_order=acc_order):
    """The emulated forward and backward on the kernels' rows, sliced back
    to Dh: (O, lse, dq, dk, dv); float32's forward and backward in the
    order of ``flash_attention_fwd_wide.cu`` and
    ``flash_attention_bwd_wide.cu`` (``fwd_order``: the forward's V^T rows;
    ``order``: the backward's transposed tiles')."""
    dh = q.shape[-1]
    bf16 = dtype == torch.bfloat16
    rows = _rows(dh, dtype, q, k, v, do)
    if bf16:
        o, lse, m, l = emulate_forward_bf16(*rows[:3], mask, causal, dh,
                                            scale_dim)
        grads = emulate_backward(*rows[:3], mask, o, rows[3], m, l, causal,
                                 dh, scale_dim)
    else:
        o, lse, m, l = emulate_forward_wgmma(*rows[:3], mask, causal, dh,
                                             fwd_order, scale_dim)
        grads = emulate_backward_wgmma(*rows[:3], mask, o, rows[3], m, l,
                                       causal, dh, order, scale_dim)
    return (o[..., :dh], lse) + tuple(g[..., :dh] for g in grads)


def _jax(q, k, v, do, mask, causal, dtype, impl):
    """JAX's O, lse (Pallas only) and gradients on the same inputs:
    ``pallas`` in ``dtype`` through ``_flash_forward`` and the Pallas
    backward in interpret mode (float32 inside), ``xla`` through
    ``_attention_xla`` in float32 (its bf16 path keeps bf16 scores)."""
    bf16 = dtype == torch.bfloat16 and impl == "pallas"
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()).astype(jdtype)
                       for t in (q, k, v, do))
    bias = jnp.asarray(np.where(mask.numpy(), 0.0, jax_attn.NEG_INF)
                       .astype(np.float32))
    if impl == "pallas":
        _, lse = jax_attn._flash_forward(jq, jk, jv, bias, causal, True)
        lse = np.asarray(lse)[..., 0]

        def f(q, k, v):
            return jax_attn._attention_pallas(q, k, v, bias, causal, True)
    else:
        lse = None

        def f(q, k, v):
            return jax_attn._attention_xla(q, k, v, bias.astype(q.dtype),
                                           causal)
    o, vjp = jax.vjp(f, jq, jk, jv)
    grads = vjp(jdo)
    return (np.asarray(o.astype(jnp.float32)), lse,
            *(np.asarray(g.astype(jnp.float32)) for g in grads))


def _close(got, want, dtype, tol, name):
    """Within ``tol`` (float32) or one bf16 ulp + 2^-8 max|want| (bf16)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == torch.bfloat16:
        bar = BF16_ULP * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
        assert (np.abs(got - want) <= bar).all(), (
            name, np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


def _check(shape, causal, dtype, seed):
    q, k, v, do, mask = _inputs(shape, seed, dtype)
    got = _emulate(q, k, v, do, mask, causal, dtype)
    names = ("O", "lse", "dq", "dk", "dv")
    tols = (KERNEL_TOL, KERNEL_TOL, CARD_TOL, CARD_TOL, CARD_TOL)
    # Every batch element but a fully masked one against Pallas.
    kept = slice(None, -1) if not mask[-1].any() else slice(None)
    want = _jax(q, k, v, do, mask, causal, dtype, "pallas")
    for g, w, tol, name in zip(got, want, tols, names):
        g = g.numpy()[kept]
        w = w[kept]
        if name == "lse":
            np.testing.assert_allclose(g, w, err_msg=name, **KERNEL_TOL)
        else:
            _close(g, w, dtype, tol, f"pallas {name}")
    if kept.stop is not None:  # the fully masked row against XLA
        want = _jax(q, k, v, do, mask, causal, dtype, "xla")
        for g, w, tol, name in zip(got, want, tols, names):
            if w is not None:
                _close(g.numpy()[-1:], w[-1:], dtype, tol, f"xla {name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dh", WIDE_HEAD_DIMS)
def test_emulated_wide_kernels_match_jax_pallas(dh, shape, causal):
    """float32 at every wide head dim: Dh 129 through a padded copy, 136,
    192 and 264 a column block partly past the row, 256 and 512 whole
    column blocks; S = 50 (one tile) and 130 (three)."""
    _check(shape + (dh,), causal, torch.float32, dh + shape[2])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [129, 256])
def test_emulated_wide_bf16_kernels_match_jax_pallas(dh, causal):
    """The bf16 instances (Dh 129 through a copy padded to 136, 256
    direct): p and ds rounded to bf16, the outputs once."""
    _check((2, 2, 50, dh), causal, torch.bfloat16, dh)


def test_emulation_with_the_scale_of_the_chunk_width_fails():
    """A kernel that took its scale from the chunk (1/sqrt(32)) or a column
    block instead of the head dim misses the bars: the scale must be
    1/sqrt(Dh)."""
    shape = (2, 2, 50, 256)
    q, k, v, do, mask = _inputs(shape, 7, torch.float32)
    want = _jax(q, k, v, do, mask, False, torch.float32, "pallas")
    for width in (CHUNK[torch.float32], OUT_COLS):
        got = _emulate(q, k, v, do, mask, False, torch.float32, width)
        for g, w in zip(got, want):
            assert not np.allclose(g.numpy()[:-1], w[:-1], **CARD_TOL)


def test_emulated_float32_backward_fails_with_rows_in_their_own_order():
    """The float32 backward's transposed tiles (K^T for ds k; Q^T and dO^T
    for ds^T q and p^T dO) must hold row r at acc_order(r): in the rows'
    own order the products pair accumulator column 2t + 1 with row t + 4,
    and dq, dk and dv miss the bar against JAX's Pallas backward."""
    shape = (2, 2, 50, 256)
    q, k, v, do, mask = _inputs(shape, 9, torch.float32)
    want = _jax(q, k, v, do, mask, False, torch.float32, "pallas")
    right = _emulate(q, k, v, do, mask, False, torch.float32)
    wrong = _emulate(q, k, v, do, mask, False, torch.float32,
                     order=lambda r: r)
    for g, bad, w, name in zip(right[2:], wrong[2:], want[2:],
                               ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy()[:-1], w[:-1], err_msg=name,
                                   **CARD_TOL)
        assert not np.allclose(bad.numpy()[:-1], w[:-1], **CARD_TOL), name


def test_emulated_float32_forward_fails_with_v_rows_in_their_own_order():
    """The float32 forward's V^T tile must hold V's row r at acc_order(r):
    in the rows' own order P V pairs accumulator column 2t + 1 with key
    t + 4, and O misses the bar against JAX's Pallas forward by far (lse,
    from the scores alone, still meets it)."""
    shape = (2, 2, 50, 256)
    q, k, v, do, mask = _inputs(shape, 13, torch.float32)
    want = _jax(q, k, v, do, mask, False, torch.float32, "pallas")
    right = _emulate(q, k, v, do, mask, False, torch.float32)
    wrong = _emulate(q, k, v, do, mask, False, torch.float32,
                     fwd_order=lambda r: r)
    np.testing.assert_allclose(right[0].numpy()[:-1], want[0][:-1],
                               err_msg="O", **KERNEL_TOL)
    np.testing.assert_allclose(wrong[1].numpy()[:-1], want[1][:-1],
                               err_msg="lse", **KERNEL_TOL)
    assert not np.allclose(wrong[0].numpy()[:-1], want[0][:-1], **CARD_TOL)


def other_units():
    """(cq, rg) of the 64 threads that split an other-axis chunk
    (``OtherUnit``, flash_attention_bwd_wide.cu): columns 4 cq .. 4 cq + 3
    of the rows 8 (rg / 2) + rg % 2 + 2m, the row groups 0, 6, 1, 7, 4, 2,
    5, 3 by cq, xor idx / 8."""
    return [(idx % 8, ((0x35247160 >> (4 * (idx % 8))) & 7) ^ (idx // 8))
            for idx in range(64)]


def test_other_units_cover_the_chunk_without_bank_conflicts():
    """The 64 units cover the (32, 32) chunk once; each quarter warp's
    16-byte loads and stores (in place: the chunk's swizzle slot
    (c / 4) ^ (row % 8); transposed: the slot (k / 4) ^ (n % 8) of the
    swizzled (n, k) tile) fall in 8 different slots; the transposed rows
    sit at acc_order, 4 of them in one 16-byte chunk."""
    seen = set()
    units = other_units()
    for cq, rg in units:
        r0 = 8 * (rg // 2) + rg % 2
        assert [acc_order(r0 + 2 * m) for m in range(4)] == \
            [4 * rg + m for m in range(4)]
        for m in range(4):
            for e in range(4):
                seen.add((r0 + 2 * m, 4 * cq + e))
    assert len(seen) == 32 * 32
    for q in range(0, 64, 8):
        quarter = units[q:q + 8]
        for m in range(4):
            slots = {cq ^ ((8 * (rg // 2) + rg % 2 + 2 * m) % 8)
                     for cq, rg in quarter}
            assert len(slots) == 8
        for e in range(4):
            slots = {rg ^ ((4 * cq + e) % 8) for cq, rg in quarter}
            assert len(slots) == 8


def test_transposed_product_is_the_plain_product():
    """The score accumulators as the A operand in place, times the
    transposed tile at acc_order read K-major from its swizzled layout: the
    plain product, exactly (integers), at both column blocks' widths."""
    rng = np.random.default_rng(4)
    for dc in (DQ_COLS, DKV_COLS):
        p = torch.from_numpy(rng.integers(-8, 8, (64, OTHER))
                             .astype(np.float32))
        x = torch.from_numpy(rng.integers(-8, 8, (OTHER, dc))
                             .astype(np.float32))
        got = transposed_product(torch.zeros(64, dc), p, x)
        assert torch.equal(got, p @ x)


def test_emulation_matches_the_plain_version_at_dh_1024():
    """Dh 1024 (eight column blocks of O, four of dq and eight of dk and dv
    in the float32 backward): the emulation against the port's plain
    versions, which take every Dh."""
    shape = (1, 1, 70, 1024)
    q, k, v, do, mask = _inputs(shape, 11, torch.float32)
    got = _emulate(q, k, v, do, mask, True, torch.float32)
    b, _, s, _ = shape
    bias = port_attn.key_bias(mask, b, s, "cpu")
    o = port_attn.attention_reference(q, k, v, bias, True)
    want = (o, port_attn.attention_reference_lse(q, k, bias, True),
            *port_attn.attention_reference_backward(q, k, v, bias, o, do,
                                                    True))
    for g, w, tol in zip(got, want, (KERNEL_TOL,) * 2 + (CARD_TOL,) * 3):
        torch.testing.assert_close(g, w, **tol)
