"""Port attention in bfloat16: the plain versions against the JAX package's
Pallas kernels in interpret mode on the same bf16 inputs, the bf16 CUDA
kernels' operand rounding and tile sums emulated on the CPU, and the
wrappers' dtype checks.  The kernels themselves are held to the plain
versions on the card by tests/test_torch_attention_bf16_cuda.py.

Bars.  The TPU kernels and the plain versions compute in float32 from the
bf16 inputs and round O, dq, dk and dv once, so the two agree to one bf16
ulp: ``|got - want| <= 2^-7 |want|``.  The card's bar for the kernels,
which also round p and ds to bf16 operands, adds ``2^-8 max|want|``
(:func:`assert_bf16_close`).  lse is float32 in both: within 2e-5 abs +
2e-5 rel, except in a fully masked row, where JAX's key bias is -1e9 in
bf16 (-998244352) and the port's -1e9 in float32."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.ops import attention as jax_attn  # noqa: E402
from flexdm_tpu_torch.ops import attention as port_attn  # noqa: E402
from _bf16_bars import (  # noqa: E402
    LSE_TOL, assert_bf16_close, bf16_draw)

JAX_BF16_NEG_INF = float(jnp.asarray(jax_attn.NEG_INF, jnp.bfloat16))


def _case(name, seed=0):
    """(q, k, v, dO, key_mask, causal) per named case, bf16 values held as
    float32 numpy (the cases of tests/test_torch_attention.py)."""
    rng = np.random.default_rng(seed)
    b, h, s, dh = {"masked": (2, 4, 50, 32), "causal": (2, 4, 16, 32),
                   "ragged": (1, 2, 200, 16),
                   "fully_masked": (2, 2, 16, 8)}[name]
    q, k, v, do = (bf16_draw(rng, (b, h, s, dh)) for _ in range(4))
    mask = np.ones((b, s), bool)
    if name == "masked":
        mask = rng.integers(0, 2, (b, s)).astype(bool)
        mask[:, 0] = True
    elif name == "ragged":
        mask[:, 150:] = False
    elif name == "fully_masked":
        mask[1] = False
    return q, k, v, do, mask, name == "causal"


CASES = ("masked", "causal", "ragged", "fully_masked")


def _torch_bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


@pytest.mark.parametrize("name", CASES)
def test_plain_forward_matches_jax_pallas_in_bf16(name):
    """O of the plain bf16 version within one bf16 ulp of the Pallas
    kernel's on the same bf16 inputs (bias built in q's dtype, as
    ``dot_product_attention`` builds it); lse within 2e-5 except in a fully
    masked row, where it differs by exactly the two biases' gap."""
    q, k, v, _, mask, causal = _case(name)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jbias = jnp.where(jnp.asarray(mask), 0.0, jax_attn.NEG_INF).astype(
        jnp.bfloat16)
    want_o, want_lse = jax_attn._flash_forward(jq, jk, jv, jbias, causal, True)
    assert want_o.dtype == jnp.bfloat16
    tq, tk, tv = _torch_bf16(q, k, v)
    tmask = torch.from_numpy(mask)
    got_o = port_attn.dot_product_attention(tq, tk, tv, tmask, causal)
    assert got_o.dtype == torch.bfloat16
    assert_bf16_close(got_o, np.asarray(want_o.astype(jnp.float32)), "O",
                      floor=False)
    b, _, s, _ = q.shape
    got_lse = port_attn.attention_reference_lse(
        tq, tk, port_attn.key_bias(tmask, b, s, "cpu"), causal).numpy()
    want_lse = np.asarray(want_lse)[..., 0]
    dead = ~mask.any(1)
    np.testing.assert_allclose(got_lse[~dead], want_lse[~dead], **LSE_TOL)
    if dead.any():
        # -1e9 + log S against -998244352 + log S (both round in float32).
        gap = jax_attn.NEG_INF - JAX_BF16_NEG_INF
        np.testing.assert_allclose(got_lse[dead] - want_lse[dead], gap,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            got_lse[dead], jax_attn.NEG_INF + math.log(s), rtol=1e-7)


BWD_CASES = {  # name: (shape, causal, valid keys)
    "s50-masked": ((2, 4, 50, 32), False, None),
    "s51-causal": ((2, 4, 51, 32), True, None),
    "s51-causal-masked": ((2, 2, 51, 16), True, 40),
}


def _bwd_inputs(name):
    shape, causal, valid = BWD_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v, do = (bf16_draw(rng, shape) for _ in range(4))
    mask = rng.random((shape[0], shape[2])) > 0.3
    if valid is not None:
        mask[:] = np.arange(shape[2]) < valid
    mask[:, 0] = True
    return q, k, v, do, mask, causal


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_plain_backward_matches_jax_pallas_in_bf16(name):
    """dq, dk, dv of autograd through the plain bf16 forward and of the
    explicit plain backward, against ``jax.vjp`` of the Pallas path in
    interpret mode in bf16: one bf16 ulp plus 2^-8 of the largest
    gradient (delta is summed from the unrounded O in autograd, from the
    bf16 O in the kernels)."""
    q, k, v, do, mask, causal = _bwd_inputs(name)

    def f(q, k, v):
        return jax_attn.dot_product_attention(
            q, k, v, key_mask=jnp.asarray(mask), causal=causal,
            impl="pallas", interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    assert all(w.dtype == jnp.bfloat16 for w in want)
    tq, tk, tv = (t.requires_grad_() for t in _torch_bf16(q, k, v))
    tdo = torch.from_numpy(do).bfloat16()
    tmask = torch.from_numpy(mask)
    o = port_attn.dot_product_attention(tq, tk, tv, tmask, causal)
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo)
    b, _, s, _ = q.shape
    plain = port_attn.attention_reference_backward(
        tq.detach(), tk.detach(), tv.detach(),
        port_attn.key_bias(tmask, b, s, "cpu"), o.detach(), tdo, causal)
    for grads in (auto, plain):
        for gname, g, w in zip(("dq", "dk", "dv"), grads, want):
            assert g.dtype == torch.bfloat16
            assert_bf16_close(g, np.asarray(w.astype(jnp.float32)), gname)


def _rounded(x):
    """float32 rounded to bf16 (nearest even) and back: a bf16 operand."""
    return x.bfloat16().float()


LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
FWD_KEYS = 64  # keys per K/V tile of the bf16 forward kernel


def _emulated_forward(q, k, v, bias, causal, block=FWD_KEYS):
    """The bf16 forward kernel's arithmetic in plain PyTorch: float32 scores
    of the bf16 operands kept in log2 units (x = s scale log2 e + bias
    log2 e, the causal band replaced by -1e9 log2 e), online softmax over
    ``block``-key tiles with p = 2^(x - m2), P rounded to bf16 for P V, O
    rounded once; m2 ln 2 and lse = m2 ln 2 + log l in natural units.
    Returns ``(O, lse)``."""
    c1 = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32) \
        * torch.tensor(LOG2E)
    x = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * c1
    x = x + (bias * torch.tensor(LOG2E))[:, None, None, :]
    if causal:
        masked = torch.tensor(port_attn.NEG_INF, dtype=torch.float32) \
            * torch.tensor(LOG2E)
        x = x.masked_fill(port_attn._outside_causal_band(q), masked.item())
    m = torch.full(x.shape[:-1], -np.inf)
    l = torch.zeros(x.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, x.shape[-1], block):
        tile = x[..., k0:k0 + block]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(tile - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _rounded(p) @ v[..., k0:k0 + block,
                                                       :].float()
        m = m_new
    m_nat = m * torch.tensor(LN2)
    return (acc / l[..., None]).bfloat16(), m_nat + torch.log(l)


# The bf16 backward kernels' tiling (csrc/flash_attention_bwd_bf16.cu): a
# consumer warpgroup owns 64 rows or keys; dq walks K/V tiles of 32 keys
# (64 at Dh >= 64), dk/dv Q/dO tiles of 32 rows; a block runs two
# warpgroups that take the tiles alternately when the grid has fewer than
# 264 blocks.
KERNEL_TILE = 64
DKV_ROWS = 32
SPLIT_BELOW_BLOCKS = 264


def _dq_keys(dh):
    return 32 if dh == 32 else 64


def _consumer_groups(b, h, s, tiles):
    blocks = -(-s // KERNEL_TILE) * b * h
    return 2 if tiles >= 2 and blocks < SPLIT_BELOW_BLOCKS else 1


def _tile_sums(a, x, tile, groups):
    """``a @ x`` as the kernels sum it: one float32 product per ``tile`` of
    the contraction axis, each warpgroup adding its tiles (every
    ``groups``-th) in order, then warpgroup 1's sum added to warpgroup
    0's."""
    n = a.shape[-1]
    sums = [torch.zeros(a.shape[:-1] + x.shape[-1:]) for _ in range(groups)]
    for i, k0 in enumerate(range(0, n, tile)):
        sums[i % groups] = sums[i % groups] + (
            a[..., k0:k0 + tile] @ x[..., k0:k0 + tile, :])
    out = sums[0]
    for part in sums[1:]:
        out = out + part
    return out


def _emulated_backward(q, k, v, bias, o, do, causal):
    """The bf16 backward kernels' arithmetic: float32 p and ds from the bf16
    operands, each rounded to bf16 as the operand of its products; dq summed
    over K/V tiles, dk and dv over Q/dO tiles, per warpgroup."""
    b, h, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    p = torch.softmax(port_attn._scores(q, k, bias, causal), -1)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - delta)
    if causal:
        ds = ds.masked_fill(port_attn._outside_causal_band(q), 0.0)
    p16, ds16 = _rounded(p), _rounded(ds)
    keys = _dq_keys(dh)
    dq_groups = _consumer_groups(b, h, s, -(-s // keys))
    dkv_groups = _consumer_groups(b, h, s, -(-s // DKV_ROWS))
    return ((_tile_sums(ds16, k, keys, dq_groups) * scale).bfloat16(),
            (_tile_sums(ds16.transpose(-1, -2), q, DKV_ROWS, dkv_groups)
             * scale).bfloat16(),
            _tile_sums(p16.transpose(-1, -2), do, DKV_ROWS,
                       dkv_groups).bfloat16())


@pytest.mark.parametrize("shape", [(2, 4, 650, 32), (8, 8, 50, 32),
                                   (1, 1, 4096, 64), (2, 2, 300, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_operand_rounding_meets_the_card_bar(shape, causal):
    """Why the bf16 kernels keep p and ds in one bf16 term: with P (forward)
    and p, ds (backward) rounded to bf16 operands and every sum in float32
    (the backward's per tile and per warpgroup, S=4096 and Dh=128
    included), O, dq, dk and dv stay within the card's bar of the plain
    bf16 versions,
    and lse within 2e-5 (the scores are exact products summed in
    float32), fully masked rows included."""
    rng = np.random.default_rng(17)
    b, h, s, dh = shape
    q, k, v, do = (torch.from_numpy(bf16_draw(rng, shape)).bfloat16()
                   for _ in range(4))
    mask = torch.from_numpy(rng.random((b, s)) > 0.3)
    mask[:, 0] = True
    mask[-1] = False
    bias = port_attn.key_bias(mask, b, s, "cpu")
    o = port_attn.attention_reference(q, k, v, bias, causal)
    got_o, got_lse = _emulated_forward(q, k, v, bias, causal)
    assert_bf16_close(got_o, o, "O")
    torch.testing.assert_close(
        got_lse, port_attn.attention_reference_lse(q, k, bias, causal),
        **LSE_TOL)
    want = port_attn.attention_reference_backward(q, k, v, bias, o, do, causal)
    got = _emulated_backward(q, k, v, bias, o, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_bf16_close(g, w, name)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3,
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.bfloat16),
])
def test_wrappers_refuse_other_dtypes(dtypes):
    """float16 and mixed dtypes raise in the public function and in the
    kernel wrappers, with no launch and nothing cast."""
    q, k, v = (torch.zeros(1, 1, 4, 32, dtype=dt) for dt in dtypes)
    before = _launches()
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        port_attn.dot_product_attention(q, k, v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        port_attn.flash_attention_forward(q, k, v)
    assert _launches() == before


def _launches():
    return tuple(getattr(port_attn, name) for name in (
        "KERNEL_LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES",
        "BF16_FWD_LAUNCHES", "BF16_DQ_LAUNCHES", "BF16_DKV_LAUNCHES"))


def test_bf16_cpu_path_never_upcasts_its_output():
    """A bf16 forward on the CPU returns bf16 and its gradients are bf16,
    through the plain version (the kernels' counts stay put)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(bf16_draw(rng, (1, 2, 9, 32))).bfloat16()
               .requires_grad_() for _ in range(3))
    before = _launches()
    o = port_attn.dot_product_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert _launches() == before
