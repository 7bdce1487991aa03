"""Port attention: plain PyTorch version against the JAX package, the CUDA
forward kernel's split-TF32 arithmetic emulated on the CPU, and the CUDA
kernel against the plain version (on a card only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.ops import attention as jax_attn  # noqa: E402
from flexdm_tpu_torch.ops import attention as port_attn  # noqa: E402
from tests._torch_parity import tf32_matmul  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(name, seed=0):
    """(q, k, v, key_mask, causal) as numpy, per named case."""
    rng = np.random.default_rng(seed)
    b, h, s, dh = {"masked": (2, 4, 50, 32), "causal": (2, 4, 16, 32),
                   "ragged": (1, 2, 200, 16), "fully_masked": (2, 2, 16, 8)}[name]
    q, k, v = (rng.normal(size=(b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), bool)
    if name == "masked":
        mask = rng.integers(0, 2, (b, s)).astype(bool)
        mask[:, 0] = True
    elif name == "ragged":
        mask[:, 150:] = False
    elif name == "fully_masked":
        mask[1] = False
    return q, k, v, mask, name == "causal"


CASES = ("masked", "causal", "ragged", "fully_masked")


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_xla_and_pallas(name):
    q, k, v, mask, causal = _case(name)
    out = port_attn.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        key_mask=torch.from_numpy(mask), causal=causal,
    ).numpy()
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    xla = jax_attn.dot_product_attention(
        jq, jk, jv, key_mask=jm, causal=causal, impl="xla"
    )
    np.testing.assert_allclose(out, np.asarray(xla), **TOL)
    assert np.all(np.isfinite(out))
    if name != "fully_masked":
        # The padded Pallas path averages a fully masked row over its
        # zero-padded keys too; the port (like XLA) uses the S real keys.
        pallas = jax_attn.dot_product_attention(
            jq, jk, jv, key_mask=jm, causal=causal, impl="pallas",
            interpret=True,
        )
        np.testing.assert_allclose(out, np.asarray(pallas), **TOL)


HEAD_DIMS = (8, 16, 20, 25, 48)  # W = 32 and 64; copied or not in each dtype


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_plain_matches_jax_pallas_at_head_dims(dh, causal):
    """Head dims the kernels take on a wider tile: the port's attention
    (the plain version on the CPU) and its three gradients against
    ``jax.vjp`` through the Pallas kernels in interpret mode, which take
    any Dh as one full block, with a seeded key mask."""
    rng = np.random.default_rng(dh)
    shape = (2, 2, 50, dh)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32)
                   for _ in range(4))
    mask = rng.random((2, 50)) > 0.3
    mask[:, 0] = True
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = port_attn.dot_product_attention(
        *leaves, key_mask=torch.from_numpy(mask), causal=causal)
    got = [out] + list(torch.autograd.grad(out, leaves, torch.from_numpy(do)))

    def f(q, k, v):
        return jax_attn.dot_product_attention(
            q, k, v, key_mask=jnp.asarray(mask), causal=causal,
            impl="pallas", interpret=True)

    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    for g, w, name in zip(got, [want, *vjp(jnp.asarray(do))],
                          ("O", "dq", "dk", "dv")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("name", CASES)
def test_plain_lse_matches_flash_forward(name):
    q, k, v, mask, causal = _case(name, seed=1)
    bias = np.where(mask, 0.0, jax_attn.NEG_INF).astype(np.float32)
    _, lse = jax_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        causal, True,
    )
    port = port_attn.attention_reference_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(bias),
        causal,
    ).numpy()
    np.testing.assert_allclose(port, np.asarray(lse)[..., 0], **TOL)


def _tf32_forward(q, k, v, bias, causal, split, block=64):
    """The forward kernel's arithmetic in plain PyTorch: both products
    through :func:`tf32_matmul`, online softmax over ``block``-key tiles.
    Returns ``(O, lse)``."""
    s = tf32_matmul(q, k.transpose(-1, -2), split) / np.sqrt(q.shape[-1])
    s = s + bias[:, None, None, :]
    if causal:
        s = s.masked_fill(port_attn._outside_causal_band(q), port_attn.NEG_INF)
    m = torch.full(s.shape[:-1], -np.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, s.shape[-1], block):
        tile = s[..., k0:k0 + block]
        m_new = torch.maximum(m, tile.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + tf32_matmul(
            p, v[..., k0:k0 + block, :], split)
        m = m_new
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("shape", [(2, 4, 650, 32), (8, 8, 50, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_split_tf32_forward_meets_the_card_tolerance(shape, causal):
    """Why the forward kernel splits both products: with the 3-term TF32
    split, O and lse stay within ``TOL`` (the card's bar) of the float32
    plain version, fully masked rows included; a single TF32 pass does
    not."""
    rng = np.random.default_rng(13)
    b, h, s, dh = shape
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for _ in range(3))
    mask = torch.from_numpy(rng.random((b, s)) > 0.3)
    mask[:, 0] = True
    mask[-1] = False
    bias = port_attn.key_bias(mask, b, s, "cpu")
    want = (port_attn.attention_reference(q, k, v, bias, causal),
            port_attn.attention_reference_lse(q, k, bias, causal))
    split = _tf32_forward(q, k, v, bias, causal, split=True)
    single = _tf32_forward(q, k, v, bias, causal, split=False)
    for got, w, name in zip(split, want, ("O", "lse")):
        torch.testing.assert_close(got, w, **TOL, msg=name)
    assert not torch.allclose(single[0], want[0], **TOL)
    assert not torch.allclose(single[1], want[1], **TOL)


def test_kernel_path_raises_without_cuda():
    """A CPU tensor handed to the kernel wrapper raises; nothing falls back."""
    q = torch.zeros(1, 1, 4, 32)
    launches = port_attn.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        port_attn.flash_attention_forward(q, q, q)
    with pytest.raises(ValueError, match="no attention path"):
        port_attn.dot_product_attention(*(t.to("meta") for t in (q, q, q)))
    assert port_attn.KERNEL_LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 50, 32), (2, 4, 650, 32),
                                   (2, 4, 512, 64), (2, 2, 100, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_plain_on_card(shape, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    b, h, s, dh = shape
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
    mask = torch.rand(b, s, generator=g) > 0.3
    mask[:, 0] = True
    mask[-1] = False  # one fully masked batch row
    mask = mask.cuda()
    o, lse = port_attn.flash_attention_forward(q, k, v, mask, causal)
    bias = port_attn.key_bias(mask, b, s, q.device)
    torch.testing.assert_close(
        o, port_attn.attention_reference(q, k, v, bias, causal), **TOL
    )
    torch.testing.assert_close(
        lse, port_attn.attention_reference_lse(q, k, bias, causal), **TOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 17, 63, 64, 65, 128, 129])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_kernel_tile_edges_on_card(s, dh):
    """The kernel's tile edges (64-row query tiles; 64-key K/V tiles, 32 at
    Dh=128), causal, with a fully masked row: within ``TOL`` of the plain
    version, and a second call bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    shape = (2, 2, s, dh)
    g = torch.Generator().manual_seed(s * dh)
    q, k, v = (torch.randn(shape, generator=g).cuda() for _ in range(3))
    mask = torch.rand(2, s, generator=g) > 0.3
    mask[:, 0] = True
    mask[-1] = False
    mask = mask.cuda()
    got = port_attn.flash_attention_forward(q, k, v, mask, True)
    again = port_attn.flash_attention_forward(q, k, v, mask, True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bias = port_attn.key_bias(mask, 2, s, q.device)
    torch.testing.assert_close(
        got[0], port_attn.attention_reference(q, k, v, bias, True), **TOL)
    torch.testing.assert_close(
        got[1], port_attn.attention_reference_lse(q, k, bias, True), **TOL)
