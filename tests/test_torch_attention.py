"""Port attention: plain PyTorch version against the JAX package, and the
CUDA kernel against the plain version (on a card only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.ops import attention as jax_attn  # noqa: E402
from flexdm_tpu_torch.ops import attention as port_attn  # noqa: E402

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
