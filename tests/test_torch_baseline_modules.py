"""The modules the port's baselines add, against the JAX package's on the
CPU, on the same numpy inputs and weights: cross-attention, the
``CrossBlock`` decoder block, conditional blocks of both types,
``masked_average_pool``, the encoder's ``concat`` and ``none`` fusions,
the decoder's ``detachment='none'`` and ``predict_mask``, the loss's
``predict_context``, ``merge_dicts``/``split_dict`` and the autoregressive
train-path masking.  Outputs within 1e-5 abs / 2e-5 rel (the two
LayerNorms compute the variance differently); masks and losses exactly or
within 1e-5 relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.models import decoder as jax_decoder  # noqa: E402
from flexdm_tpu.models import encoder as jax_encoder  # noqa: E402
from flexdm_tpu.models import losses as jax_losses  # noqa: E402
from flexdm_tpu.models import masking as jax_masking  # noqa: E402
from flexdm_tpu.models import sorting as jax_sorting  # noqa: E402
from flexdm_tpu.models import transformer as jax_transformer  # noqa: E402
from flexdm_tpu.models.baselines import autoreg as jax_autoreg  # noqa: E402
from flexdm_tpu_torch.convert import load_jax_params  # noqa: E402
from flexdm_tpu_torch.models import baselines as port_baselines  # noqa: E402
from flexdm_tpu_torch.models import decoder as port_decoder  # noqa: E402
from flexdm_tpu_torch.models import encoder as port_encoder  # noqa: E402
from flexdm_tpu_torch.models import losses as port_losses  # noqa: E402
from flexdm_tpu_torch.models import masking as port_masking  # noqa: E402
from flexdm_tpu_torch.models import sorting as port_sorting  # noqa: E402
from flexdm_tpu_torch.models import transformer as port_transformer  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    flat_params,
    numpy_batch,
    to_jax,
    to_numpy,
    to_torch,
)
from tests.test_masking import tiny_inputs, tiny_schema  # noqa: E402
from tests.test_torch_train_masking import _replacement_values  # noqa: E402

TOL = dict(rtol=2e-5, atol=1e-5)
B, S, D, H = 3, 6, 16, 2


def _arrays(seed=0, n=3):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(n)]
    mask = np.ones((B, S), bool)
    mask[0, 4:] = False
    mask[2, 1:] = False
    return out, mask


def _pair(jax_module, port_module, *args, **kwargs):
    """Init ``jax_module`` on ``args``, load its weights into
    ``port_module``; returns the params."""
    params = jax_module.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                             **kwargs)
    load_jax_params(port_module, flat_params(params))
    return params


def test_cross_attention_matches_jax():
    """``MultiHeadAttention(x, key_mask, kv=memory)``: q from x, k and v
    from the memory (one fused matmul), the memory's keys masked."""
    (x, memory), mask = _arrays(n=2)
    jax_mha = jax_transformer.MultiHeadAttention(D, H, attention_impl="xla")
    port_mha = port_transformer.MultiHeadAttention(D, H)
    params = _pair(jax_mha, port_mha, x, mask, memory)
    want = jax_mha.apply(params, jnp.asarray(x), jnp.asarray(mask),
                         kv=jnp.asarray(memory))
    got = port_mha(torch.from_numpy(x), torch.from_numpy(mask),
                   kv=torch.from_numpy(memory))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="memory"):
        port_mha(torch.from_numpy(x), None, kv=torch.zeros(B, S + 1, D))


def test_cross_block_matches_jax():
    """BART's decoder block: causal self-attention, cross-attention, MLP."""
    (x, memory), mask = _arrays(1, n=2)
    jax_block = jax_autoreg.CrossBlock(D, H, attention_impl="xla")
    port_block = port_baselines.CrossBlock(D, H)
    params = _pair(jax_block, port_block, x, memory, mask, mask)
    want = jax_block.apply(params, *map(jnp.asarray, (x, memory, mask, mask)))
    got = port_block(*map(torch.from_numpy, (x, memory, mask, mask)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block_type", ["deepsvg", "transformer"])
@pytest.mark.parametrize("lookahead", [True, False])
def test_conditional_blocks_match_jax(block_type, lookahead):
    """``conditional=True``: a Dense of z added to every token (DeepSVG),
    or added and normalised by ``norm3`` (post-norm)."""
    (x,), mask = _arrays(2, n=1)
    z = np.random.default_rng(3).normal(size=(B, D)).astype(np.float32)
    kwargs = dict(latent_dim=D, num_blocks=2, block_type=block_type,
                  num_heads=H, conditional=True, lookahead=lookahead)
    jax_blocks = jax_transformer.Blocks(attention_impl="xla", **kwargs)
    port_blocks = port_transformer.Blocks(**kwargs)
    params = jax_blocks.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(mask), jnp.asarray(z))
    load_jax_params(port_blocks, flat_params(params))
    want = jax_blocks.apply(params, jnp.asarray(x), jnp.asarray(mask),
                            jnp.asarray(z))
    got = port_blocks(torch.from_numpy(x), torch.from_numpy(mask),
                      z=torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert ("norm3" in dict(port_blocks.named_modules())["seq2seq_0"]
            ._modules) == (block_type == "transformer")


def test_masked_average_pool_matches_jax():
    (x,), mask = _arrays(4, n=1)
    mask[1] = False  # no valid token: divides by 1
    want = jax_transformer.masked_average_pool(jnp.asarray(x),
                                               jnp.asarray(mask))
    got = port_transformer.masked_average_pool(torch.from_numpy(x),
                                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def _tiny_modified():
    schema = tiny_schema()
    x = tiny_inputs(schema=schema)
    seq = jax_masking.get_seq_mask(x["length"], schema.max_length)
    rng = np.random.default_rng(5)
    masks = {c.name: seq & jnp.asarray(rng.random(seq.shape) < 0.4)
             if c.is_sequence else jnp.ones(4, bool) for c in schema.modeled}
    modified = jax_masking.preprocess_for_test(x, schema, masks)
    return schema, {k: np.asarray(v) for k, v in modified.items()}


@pytest.mark.parametrize("fusion,input_dtype", [
    ("concat", "set"), ("concat", "shuffled_set"), ("none", "set"),
    ("none", "shuffled_set")])
def test_encoder_fusions_match_jax(fusion, input_dtype):
    """``concat``: the fields concatenated, ``fusion_fc``, ``fusion_norm``
    (then the position embedding where ``input_dtype != 'set'``);
    ``none``: a dict of the fields' embeddings, no position embedding."""
    schema, modified = _tiny_modified()
    jax_enc = jax_encoder.Encoder(schema, latent_dim=D, fusion=fusion,
                                  input_dtype=input_dtype)
    port_enc = port_encoder.Encoder(schema, D, fusion=fusion,
                                    input_dtype=input_dtype)
    params = jax_enc.init(jax.random.PRNGKey(0), to_jax(modified))
    load_jax_params(port_enc, flat_params(params))
    want, want_mask = jax_enc.apply(params, to_jax(modified))
    got, got_mask = port_enc(to_torch(modified))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    if fusion == "none":
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), **TOL,
                                       err_msg=k)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_decoder_none_and_predict_mask_match_jax():
    """``detachment='none'``: each field's head reads that field's
    features, here 64 wide as LayoutVAE's CVAE decoders make them;
    ``predict_mask``: the mask of the argmaxed ``decoder_length`` logits
    (JAX's own method cannot run: flax refuses its inline Dense, so its
    pieces are composed here)."""
    schema = tiny_schema()
    rng = np.random.default_rng(6)
    feats = {c.name: rng.normal(size=(4, S, 64)).astype(np.float32)
             for c in schema.valid_columns()}
    jax_dec = jax_decoder.Decoder(schema, latent_dim=D, detachment="none")
    port_dec = port_decoder.Decoder(schema, D, detachment="none", in_dim=64,
                                    length_head=True)
    params = jax_dec.init(jax.random.PRNGKey(0), to_jax(feats))
    flat = flat_params(params)
    kernel = rng.normal(size=(D, schema["length"].input_dim)).astype(
        np.float32)
    flat["params/decoder_length/kernel"] = kernel
    flat["params/decoder_length/bias"] = np.zeros(
        schema["length"].input_dim, np.float32)
    load_jax_params(port_dec, flat)
    want = jax_dec.apply(params, to_jax(feats))
    got = port_dec(to_torch(feats))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), **TOL, err_msg=k)
    z = rng.normal(size=(4, D)).astype(np.float32)
    want_mask = jax_masking.get_seq_mask(jnp.asarray(z @ kernel),
                                         schema.max_length, from_logits=True)
    got_mask = port_dec.predict_mask(torch.from_numpy(z))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("sort", [False, True])
def test_predict_context_matches_jax(crello_spec, sort):
    """The canvas columns with a prediction scored too, one weight per
    document; with the sort, the ground-truth lengths injected for the
    ordering are not scored."""
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 8)
    rng = np.random.default_rng(8)
    pred = {}
    for c in schema.modeled:
        if c.name == "length" and sort:
            continue
        shape = batch[c.name].shape
        pred[c.name] = rng.normal(size=shape + (c.input_dim,) if
                                  c.is_categorical else shape).astype(
                                      np.float32)
    seq = np.arange(schema.max_length)[None, :] <= batch["length"]
    masks = {c.name: seq & (rng.random(seq.shape) < 0.5) if c.is_sequence
             else rng.random(8) < 0.7 for c in schema.modeled}
    flag = np.arange(8) % 2 == 0
    want_loss, want = jax.jit(lambda b, p, m, f: jax_losses.compute_mfp_loss(
        schema, b, p, m, sort_flag=f, predict_context=True))(
            to_jax(batch), to_jax(pred), to_jax(masks),
            jnp.asarray(flag) if sort else None)
    got_loss, got = port_losses.compute_mfp_loss(
        schema, to_torch(batch), to_torch(pred), to_torch(masks),
        sort_flag=torch.from_numpy(flag) if sort else None,
        predict_context=True)
    assert set(got) == set(want)
    assert ("length_score" in got) == (not sort)
    assert "canvas_width_score" in got
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_merge_and_split_dicts_match_jax():
    rng = np.random.default_rng(9)
    parts = [{"a": rng.normal(size=(2, 3)).astype(np.float32),
              "b": rng.integers(0, 5, (2, 4))} for _ in range(3)]
    for axis in (0, 1):
        if axis == 1:
            parts = [{"a": p["a"]} for p in parts]
        want = jax_sorting.merge_dicts([to_jax(p) for p in parts], axis)
        got = port_sorting.merge_dicts([to_torch(p) for p in parts], axis)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        want_split = jax_sorting.split_dict(want, 3, axis)
        got_split = port_sorting.split_dict(got, 3, axis)
        for g, w, p in zip(got_split, want_split, parts):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
                np.testing.assert_array_equal(g[k].numpy(), p[k])
    with pytest.raises(ValueError, match="equal parts"):
        port_sorting.split_dict(got, 2, 1)


def test_autoreg_train_masking_picks_the_last_element(crello_spec):
    """``preprocess_for_train(is_autoreg=True)`` equals JAX's on the same
    draws (masks exactly, data within 1e-7); its elem task masks the last
    valid element; ``elem_masking`` with ``select_last`` equals JAX's."""
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 8)
    key = jax.random.PRNGKey(4)
    tasks = np.array([1, 0, 1, 2, 1, 3, 1, 0], np.int32)
    uniforms = np.asarray(jax.random.uniform(
        key, port_masking.train_draw_shape(schema, 8)))
    want = jax.jit(lambda b, t, k, u: jax_masking.preprocess_for_train(
        b, schema, t, k, is_autoreg=True, draws=u))(
            to_jax(batch), jnp.asarray(tasks), key, jnp.asarray(uniforms))
    k_random = jax.random.split(key)[0]
    got = port_masking.preprocess_for_train(
        to_torch(batch), schema, torch.from_numpy(tasks),
        torch.from_numpy(uniforms.copy()), torch.rand(8),
        to_torch(_replacement_values(schema, batch, k_random)),
        is_autoreg=True)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            # The jitted replacement normals may round differently from
            # the eager draw handed to the port (a fused 0.1 * normal).
            np.testing.assert_allclose(to_numpy(g)[k], np.asarray(w[k]),
                                       rtol=0, atol=1e-7, err_msg=k)
    elem = np.asarray(got[2]["left"])[tasks == 1]
    last = batch["length"][tasks == 1, 0]
    assert (elem.argmax(1) == last).all() and (elem.sum(1) == 1).all()

    seq = jax_masking.get_seq_mask(jnp.asarray(batch["length"]),
                                   schema.max_length)
    want = jax_masking.elem_masking(to_jax(batch), schema, seq, key,
                                    select_last=True)
    got = port_masking.elem_masking(to_torch(batch), schema,
                                    torch.from_numpy(np.asarray(seq)),
                                    select_last=True)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(to_numpy(g)[k], np.asarray(w[k]),
                                          err_msg=k)
