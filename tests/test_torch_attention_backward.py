"""Port attention backward: the plain backward (explicit formulas) and
autograd through the plain forward against ``jax.vjp`` through the JAX
package's Pallas kernels in interpret mode; the CUDA backward kernels'
split-TF32 arithmetic emulated on the CPU; and the CUDA backward kernels
against the plain backward (on a card only).

Tolerance 2e-4 abs + 2e-4 rel, the bar of the JAX package's own
Pallas-vs-XLA gradient tests; 1e-4 abs + 1e-4 rel (``CARD_TOL``, the bar
of ``chip_smoke.py``) for the kernels and their emulation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.ops import attention as jax_attn  # noqa: E402
from flexdm_tpu_torch.ops import attention as port_attn  # noqa: E402
from tests._torch_parity import tf32_matmul  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
CARD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(shape, seed, fully_masked_row=False, valid=None):
    """q, k, v, dO as float32 numpy, and a (B, S) key mask in which every
    row keeps key 0 (or, with ``fully_masked_row``, the last batch row
    keeps nothing)."""
    rng = np.random.default_rng(seed)
    b, h, s, dh = shape
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    mask = rng.random((b, s)) > 0.3
    if valid is not None:
        mask[:] = np.arange(s) < valid
    mask[:, 0] = True
    if fully_masked_row:
        mask[-1] = False
    return q, k, v, do, mask


def _jax_grads(q, k, v, do, mask, causal, impl):
    def f(q, k, v):
        return jax_attn.dot_product_attention(
            q, k, v, key_mask=jnp.asarray(mask), causal=causal, impl=impl,
            interpret=impl == "pallas",
        )

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, mask, causal):
    """(explicit plain backward, autograd of the plain forward)."""
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    b, _, s, _ = q.shape
    bias = port_attn.key_bias(torch.from_numpy(mask), b, s, "cpu")
    o = port_attn.attention_reference(tq, tk, tv, bias, causal)
    tdo = torch.from_numpy(do)
    auto = torch.autograd.grad(o, (tq, tk, tv), tdo)
    plain = port_attn.attention_reference_backward(
        tq.detach(), tk.detach(), tv.detach(), bias, o.detach(), tdo, causal
    )
    return ([g.numpy() for g in plain], [g.numpy() for g in auto])


CASES = {  # name: (shape, causal, valid keys)
    "s50-masked": ((2, 4, 50, 32), False, None),
    "s51-masked": ((2, 4, 51, 32), False, None),
    "s50-causal": ((2, 4, 50, 32), True, None),
    "s51-causal-masked": ((2, 2, 51, 16), True, 40),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_pallas(name):
    shape, causal, valid = CASES[name]
    q, k, v, do, mask = _inputs(shape, seed=len(name), valid=valid)
    want = _jax_grads(q, k, v, do, mask, causal, "pallas")
    for got in _port_grads(q, k, v, do, mask, causal):
        for g, w, n in zip(got, want, "qkv"):
            np.testing.assert_allclose(g, w, err_msg=f"d{n}", **TOL)


def test_plain_backward_matches_jax_stream_kernels(monkeypatch):
    """The JAX S >= 4096 stream kernels (#4, #5), forced on at S=256 as
    ``tests/test_attention.py`` does."""
    monkeypatch.setattr(jax_attn, "_BWD_STREAM_MIN_S", 1)
    q, k, v, do, mask = _inputs((2, 2, 256, 32), seed=3, valid=200)
    want = _jax_grads(q, k, v, do, mask, True, "pallas")
    for got in _port_grads(q, k, v, do, mask, True):
        for g, w, n in zip(got, want, "qkv"):
            np.testing.assert_allclose(g, w, err_msg=f"d{n}", **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_follows_the_plain_path(causal):
    """In a fully masked row every score rounds to exactly -1e9 in float32,
    and so does its logsumexp.  The port (plain backward and kernels alike)
    follows the plain softmax there (p = 1/S): it matches ``jax.grad`` of
    ``impl='xla'``.  The JAX Pallas backward rebuilds p = exp(s - lse) = 1
    and so departs from its own XLA path on that row."""
    q, k, v, do, mask = _inputs((2, 2, 50, 32), seed=5, fully_masked_row=True)
    want = _jax_grads(q, k, v, do, mask, causal, "xla")
    for got in _port_grads(q, k, v, do, mask, causal):
        for g, w, n in zip(got, want, "qkv"):
            np.testing.assert_allclose(g, w, err_msg=f"d{n}", **TOL)
    pallas_dv = _jax_grads(q, k, v, do, mask, causal, "pallas")[2]
    assert np.abs(pallas_dv[-1] - want[2][-1]).max() > 0.1
    np.testing.assert_allclose(pallas_dv[0], want[2][0], **TOL)


def _tf32_backward(q, k, v, bias, o, do, causal, split):
    """The backward kernels' arithmetic in plain PyTorch: every product
    through :func:`tf32_matmul`; p = exp(s - m) / l with the forward's
    float32 row max and sum."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = port_attn._scores(q, k, bias, causal)
    m = scores.amax(-1, keepdim=True)
    l = torch.exp(scores - m).sum(-1, keepdim=True)
    s = tf32_matmul(q, k.transpose(-1, -2), split) * scale
    s = s + bias[:, None, None, :]
    if causal:
        s = s.masked_fill(port_attn._outside_causal_band(q), port_attn.NEG_INF)
    p = torch.exp(s - m) / l
    dp = tf32_matmul(do, v.transpose(-1, -2), split)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    if causal:
        ds = ds.masked_fill(port_attn._outside_causal_band(q), 0.0)
    return (tf32_matmul(ds, k, split) * scale,
            tf32_matmul(ds.transpose(-1, -2), q, split) * scale,
            tf32_matmul(p.transpose(-1, -2), do, split))


@pytest.mark.parametrize("shape,causal,fully_masked_row", [
    ((8, 8, 50, 32), False, True), ((8, 8, 50, 32), True, True),
    ((1, 1, 1024, 64), False, False), ((1, 1, 1024, 64), True, False),
])
def test_split_tf32_products_meet_the_card_tolerance(shape, causal,
                                                     fully_masked_row):
    """Why the backward kernels split every operand: with the 3-term TF32
    split their products stay within ``CARD_TOL`` of the float32 plain
    backward; a single TF32 pass does not (errors ~1e-3)."""
    q, k, v, do, mask = (torch.from_numpy(a) for a in _inputs(
        shape, seed=11, fully_masked_row=fully_masked_row))
    b, _, s, _ = shape
    bias = port_attn.key_bias(mask, b, s, "cpu")
    o = port_attn.attention_reference(q, k, v, bias, causal)
    want = port_attn.attention_reference_backward(q, k, v, bias, o, do, causal)
    split = _tf32_backward(q, k, v, bias, o, do, causal, split=True)
    single = _tf32_backward(q, k, v, bias, o, do, causal, split=False)
    for g, w, n in zip(split, want, "qkv"):
        torch.testing.assert_close(g, w, **CARD_TOL, msg=f"d{n}")
    for g, w, n in zip(single, want, "qkv"):
        assert not torch.allclose(g, w, **CARD_TOL), f"single-pass d{n}"


def test_kernel_backward_raises_without_cuda():
    """CPU tensors handed to the backward kernels raise; nothing falls back
    and no launch is counted."""
    q = torch.zeros(1, 1, 4, 32)
    stats = torch.zeros(1, 1, 4)
    counts = (port_attn.BWD_DQ_LAUNCHES, port_attn.BWD_DKV_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        port_attn.flash_attention_backward(q, q, q, None, q, stats, stats, q)
    assert (port_attn.BWD_DQ_LAUNCHES, port_attn.BWD_DKV_LAUNCHES) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((256, 8, 50, 32), False), ((8, 8, 51, 32), True), ((2, 4, 512, 64), False),
    ((2, 4, 650, 32), True), ((2, 2, 128, 128), False),
    ((2, 2, 65, 64), True), ((2, 2, 129, 128), True),
])
def test_kernel_backward_matches_plain_on_card(shape, causal):
    """Within ``CARD_TOL`` of the plain backward, and bitwise deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    q, k, v, do, mask = (torch.from_numpy(a).cuda() for a in _inputs(
        shape, seed=7, fully_masked_row=True))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    b, _, s, _ = shape
    bias = port_attn.key_bias(mask, b, s, q.device)
    got, again = (torch.autograd.grad(
        port_attn.dot_product_attention(q, k, v, mask, causal), (q, k, v), do)
        for _ in range(2))
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    ref_o = port_attn.attention_reference(q, k, v, bias, causal)
    want = port_attn.attention_reference_backward(
        q.detach(), k.detach(), v.detach(), bias, ref_o.detach(), do, causal
    )
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **CARD_TOL)


@pytest.mark.cuda
def test_kernel_backward_refuses_unaligned_rows():
    """The kernels copy rows 16 bytes at a time: a tensor that does not
    start on a 16-byte boundary raises, and nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    q = torch.zeros(1 + 2 * 4 * 32, device="cuda")[1:].view(1, 2, 4, 32)
    stats = torch.ones(1, 2, 4, device="cuda")
    counts = (port_attn.BWD_DQ_LAUNCHES, port_attn.BWD_DKV_LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        port_attn.flash_attention_backward(q, q, q, None, q, stats, stats, q)
    assert (port_attn.BWD_DQ_LAUNCHES, port_attn.BWD_DKV_LAUNCHES) == counts
