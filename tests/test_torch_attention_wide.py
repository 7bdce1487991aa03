"""The wide attention kernels' algorithm (``csrc/flash_attention_wide.cu``,
every head dim above 128) emulated on the CPU and held to the JAX
package's Pallas kernels in interpret mode.

The emulation follows the kernels' order of work: each output column block
(128 columns of O and dq, 64 of dk and dv) on its own, the scores (q k^T,
and the backward's dO v^T) summed over the full row in chunks (32 float32
or 64 bf16 columns, the last zero past the row), tiles of 64 keys (or
query rows for dk/dv) in turn, an online softmax in the forward whose m and
l every column block computes alike (the block of column block 0 writes
them), and delta = rowsum(dO O) over the full row.  Products are the
kernels' arithmetic: float32 as k8 steps of three TF32 products (lo hi' +
hi lo' + hi hi', summed from zero and added to the running sum in
float32); bf16 with bf16 operands (p and ds rounded to bf16) and float32
sums, the outputs rounded to bf16 once.  Rows whose Dh is not a multiple
of 16 bytes run on zero-padded copies (Dh 129: 132 float32, 136 bf16), as
``ops/attention.py`` hands them to the kernels; the scale is 1/sqrt(Dh).

Held to JAX's ``_flash_forward`` and its Pallas backward (interpret mode,
any Dh as one block) on the same seeded numpy inputs: O and lse within
2e-5, dq, dk and dv within 1e-4 (bf16: one bf16 ulp + 2^-8 of the largest
reference entry).  A fully masked row (the last batch element, every key
masked) is held to JAX's XLA path, which the port follows there (JAX's
padded Pallas path rebuilds p from lse and adds its causal -1e9 to the key
bias).  With the scale of the chunk width the emulation misses the bars.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdm_tpu.ops import attention as jax_attn
from flexdm_tpu_torch.ops import attention as port_attn

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
CARD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = 2.0 ** -7

ROWS = 64  # a block's rows, and the other axis's tile
OUT_COLS = 128  # column block of O and dq
KV_COLS = 64  # column block of dk and dv
CHUNK = {torch.float32: 32, torch.bfloat16: 64}

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


def emulate_forward(q, k, v, mask, causal, dh, bf16=False, scale_dim=None):
    """O, lse, m, l of the wide forward on rows of ``ld`` >= Dh (float32
    tensors; bf16-valued for the bf16 instance)."""
    b, h, s, ld = q.shape
    scale = 1.0 / math.sqrt(scale_dim or dh)
    chunk = CHUNK[torch.bfloat16 if bf16 else torch.float32]
    bias = port_attn.key_bias(mask, b, s, "cpu")
    rows = torch.arange(s)
    o = torch.zeros_like(q)
    stats = []
    for c0 in range(0, ld, OUT_COLS):
        cols = slice(c0, c0 + OUT_COLS)
        m = torch.full((b, h, s), -math.inf)
        l = torch.zeros((b, h, s))
        acc = torch.zeros_like(q[..., cols])
        for k0 in range(0, s, ROWS):
            keys = slice(k0, k0 + ROWS)
            sc = chunk_scores(q, k[..., keys, :], chunk, bf16) * scale \
                + bias[:, None, None, keys]
            if causal:
                sc = sc.masked_fill(_band(rows, torch.arange(s)[keys]),
                                    port_attn.NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = mma_sum(acc * alpha[..., None], p, v[..., keys, cols], bf16)
            m = m_new
        o[..., cols] = acc / l[..., None]
        stats.append((m, l))
    # Every column block normalises by the same m and l, bitwise.
    assert all(torch.equal(x, stats[0][0]) and torch.equal(y, stats[0][1])
               for x, y in stats)
    m, l = stats[0]
    if bf16:
        o = o.bfloat16().float()
    return o, m + torch.log(l), m, l


def emulate_backward(q, k, v, mask, o, do, m, l, causal, dh, bf16=False,
                     scale_dim=None):
    """dq, dk, dv of the wide dq and dk/dv kernels (rows as
    :func:`emulate_forward`'s)."""
    b, h, s, ld = q.shape
    scale = 1.0 / math.sqrt(scale_dim or dh)
    chunk = CHUNK[torch.bfloat16 if bf16 else torch.float32]
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
    out = (dq, dk, dv)
    return tuple(x.bfloat16().float() for x in out) if bf16 else out


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


def _emulate(q, k, v, do, mask, causal, dtype, scale_dim=None):
    """The emulated forward and backward on the kernels' rows, sliced back
    to Dh: (O, lse, dq, dk, dv)."""
    dh = q.shape[-1]
    bf16 = dtype == torch.bfloat16
    rows = _rows(dh, dtype, q, k, v, do)
    o, lse, m, l = emulate_forward(*rows[:3], mask, causal, dh, bf16,
                                   scale_dim)
    grads = emulate_backward(*rows[:3], mask, o, rows[3], m, l, causal, dh,
                             bf16, scale_dim)
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


def test_emulation_matches_the_plain_version_at_dh_1024():
    """Dh 1024 (eight column blocks of O, sixteen of dk and dv): the
    emulation against the port's plain versions, which take every Dh."""
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
