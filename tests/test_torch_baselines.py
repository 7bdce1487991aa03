"""The port's baselines CanvasVAE, AutoReg and BART against the JAX
package's on the CPU (LayoutVAE, the slowest to run in JAX, has
``tests/test_torch_baselines_layoutvae.py``): the decode, the zero-noise
training branch with its gradients and the weight round trip per family
(tolerances in ``tests/_torch_baselines.py``), the decoders' causality,
and ``build_model`` for every ``arch_type``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch import config as port_config  # noqa: E402
from flexdm_tpu_torch.convert import init_params  # noqa: E402
from flexdm_tpu_torch.models import baselines as port_baselines  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from tests._torch_baselines import (  # noqa: E402
    SIZES,
    build_family,
    check_decode,
    check_round_trip,
    check_training,
    schema_inputs,
)
from tests._torch_parity import to_torch  # noqa: E402
from tests.test_masking import tiny_schema  # noqa: E402


@pytest.fixture(scope="module", params=["CanvasVAE", "AutoReg", "BART"])
def family(request):
    return build_family(request.param)


def test_decode_matches_jax(family):
    check_decode(family)


def test_training_branch_matches_jax(family):
    check_training(family)


def test_weights_round_trip(family, tmp_path):
    check_round_trip(family, tmp_path)


@pytest.mark.parametrize("name", ["AutoReg", "BART"])
def test_decoder_stack_is_causal(name):
    """The decode's stack at position t reads only slots <= t: slots
    after t changed leave rows <= t as they were."""
    schema = tiny_schema()
    model = init_params(getattr(port_baselines, name)(schema, **SIZES), 0)
    g = torch.Generator().manual_seed(0)
    b, s, d = 4, schema.max_length, SIZES["latent_dim"]
    buf = torch.randn(b, s, d, generator=g)
    memory = torch.randn(b, s, d, generator=g)
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[0, 4:] = False
    for t in range(s - 1):
        other = buf.clone()
        other[:, t + 1:] = torch.randn(b, s - t - 1, d, generator=g)
        with torch.no_grad():
            if name == "AutoReg":
                h1, h2 = (model.blocks(x, mask) for x in (buf, other))
            else:
                h1, h2 = (model.dec_blocks(x, memory, mask, mask)
                          for x in (buf, other))
        np.testing.assert_allclose(h1[:, :t + 1].numpy(),
                                   h2[:, :t + 1].numpy(), rtol=0, atol=1e-6)
        assert not torch.allclose(h1[:, t + 1:], h2[:, t + 1:])


def test_autoreg_decode_is_causal():
    """AutoReg's decode of position t reads the inputs of elements < t
    only: changing every field of the last element leaves the outputs at
    positions <= that element's as they were (the property
    tests/test_baselines.py:107-126 states for JAX)."""
    schema, x, masks, modified = schema_inputs()
    model = init_params(port_baselines.AutoReg(schema, **SIZES), 0)
    other = {k: v.copy() for k, v in modified.items()}
    rng = np.random.default_rng(3)
    last = int(x["length"][1, 0])  # document 1's last element
    for c in schema.modeled:
        if c.is_sequence:
            v = other[c.name]
            if c.is_categorical:
                v[1, last] = rng.integers(0, c.input_dim, v.shape[2:])
            else:
                v[1, last] = rng.normal(size=v.shape[2:])
    with torch.no_grad():
        got1 = model(to_torch(modified), to_torch(x), to_torch(masks))[0]
        got2 = model(to_torch(other), to_torch(x), to_torch(masks))[0]
    for k in got1:
        np.testing.assert_allclose(got1[k][1, :last + 1].numpy(),
                                   got2[k][1, :last + 1].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["oneshot", "canvasvae", "layoutvae",
                                  "autoreg", "bart_autoreg"])
def test_build_model_builds_every_arch_type(arch):
    """Every ``arch_type`` builds, as JAX's ``build_model`` does; a
    baseline ignores ``dtype`` (it computes in float32) and keeps its own
    ``input_dtype``; ``bos`` is drawn N(0, 0.05^2)."""
    schema = tiny_schema()
    config = port_config.TrainConfig(arch_type=arch, dtype="bfloat16",
                                     input_dtype="set", kl=0.5, **SIZES)
    model = init_params(port_config.build_model(config, schema), 0)
    want = {"oneshot": port_mfp.MFPModel, "canvasvae": port_baselines.CanvasVAE,
            "layoutvae": port_baselines.LayoutVAE,
            "autoreg": port_baselines.AutoReg,
            "bart_autoreg": port_baselines.BART}[arch]
    assert type(model) is want
    if arch == "oneshot":
        assert model.dtype == "bfloat16"
        return
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert getattr(model, "input_dtype", "set") == {
        "canvasvae": "sorted_set", "layoutvae": "set"}.get(
            arch, "shuffled_set")
    if arch in ("canvasvae", "layoutvae"):
        assert model.kl == 0.5
    if arch in ("autoreg", "bart_autoreg"):
        assert model.bos.shape == (1, 1, SIZES["latent_dim"])


def test_bos_is_drawn_from_a_normal():
    """``init_params`` draws ``bos`` N(0, 0.05^2), as JAX's
    ``normal(stddev=0.05)`` does, not U(-0.05, 0.05) like the tables."""
    holder = torch.nn.Module()
    holder.bos = torch.nn.Parameter(torch.empty(1, 1, 4096))
    bos = init_params(holder, 1).bos
    assert abs(bos.std().item() - 0.05) < 0.003
    assert abs(bos.mean().item()) < 0.003
    assert bos.abs().max().item() > 0.1  # not U(-0.05, 0.05)


@pytest.mark.parametrize("name", ["CanvasVAE", "LayoutVAE", "AutoReg",
                                  "BART"])
def test_attention_inputs_meet_the_kernels_terms(name, monkeypatch):
    """Every attention call of a training step and a decode hands over
    what the CUDA kernels take (``ops/attention.py`` ``_check_inputs``,
    but for the device): q, k and v contiguous and of one shape and
    dtype, the key mask a contiguous (B, S) bool."""
    from flexdm_tpu_torch.ops import attention as attn

    plain, calls = attn.attention_reference, []

    def checked(q, k, v, bias, causal=False):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        assert q.shape == k.shape == v.shape and q.dim() == 4
        assert q.dtype == k.dtype == v.dtype == torch.float32
        calls.append(causal)
        return plain(q, k, v, bias, causal)

    def key_bias(key_mask, b, s, device, dtype=torch.float32):
        assert key_mask.dtype == torch.bool and key_mask.is_contiguous()
        assert tuple(key_mask.shape) == (b, s)
        return attn_key_bias(key_mask, b, s, device, dtype)

    attn_key_bias = attn.key_bias
    monkeypatch.setattr(attn, "attention_reference", checked)
    monkeypatch.setattr(attn, "key_bias", key_bias)
    schema, x, masks, modified = schema_inputs()
    model = init_params(getattr(port_baselines, name)(schema, **SIZES), 0)
    outputs, _ = port_mfp.apply_model(model, to_torch(modified), to_torch(x),
                                      to_torch(masks), deterministic=False,
                                      dropout=torch.Generator().manual_seed(0))
    sum(v.float().sum() for v in outputs.values()).backward()
    with torch.no_grad():
        port_mfp.apply_model(model, to_torch(modified), to_torch(x),
                             to_torch(masks), deterministic=True)
    assert calls and (any(calls) == (name in ("AutoReg", "BART")))
