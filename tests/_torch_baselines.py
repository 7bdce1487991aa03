"""Shared pieces of the baseline parity tests: the port's baselines
(CanvasVAE, LayoutVAE, AutoReg, BART) against the JAX package's, on the
same numpy inputs and the same weights (moved through
``convert.load_jax_params``), on the CPU.

Sizes: ``tiny_schema()`` (S=6), D=16, 2 blocks, 2 heads, JAX's
``attention_impl="xla"``; the weights are the port's seeded
initialisation.  Every argmax the JAX decode takes (the committed
categorical fields; CanvasVAE's length) is asserted to lead its runner-up
by at least ``MARGIN`` = 1e-3, so a near tie cannot pass as a match (the
least margin at these seeds is ~1e-2, so the heads need no scaling).
Tolerances:

* the deterministic forward (the decode) within 1e-5;
* the training branch at dropout 0 with the reparameterisation noise set
  to zero on both sides (JAX: the ``jax`` name inside
  ``flexdm_tpu.models.baselines.cvae`` swapped for a shim whose
  ``random.normal`` gives zeros; the port: no ``vae`` generator): outputs
  within 1e-5, the loss and its ``kl_loss`` / ``length_loss`` terms within
  1e-5 relative (the loss is ~1e2, where float32's spacing is ~1e-5),
  every gradient within 1e-4 (times the leaf's largest |gradient| where
  that is above 1: some leaves' gradients reach ~4e2, whose float32
  spacing is ~3e-5);
* the weight round trips exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from flexdm_tpu.models import baselines as jax_baselines
from flexdm_tpu.models import losses as jax_losses
from flexdm_tpu.models import masking as jax_masking
from flexdm_tpu.models import mfp as jax_mfp
from flexdm_tpu.models.baselines import cvae as jax_cvae
from flexdm_tpu_torch.convert import (
    init_params,
    load_jax_params,
    load_weights,
    params_from_jax,
    params_to_jax,
    save_weights,
)
from flexdm_tpu_torch.models import baselines as port_baselines
from flexdm_tpu_torch.models import losses as port_losses
from flexdm_tpu_torch.models import mfp as port_mfp
from tests._torch_parity import flat_params, to_jax, to_numpy, to_torch
from tests.test_masking import tiny_inputs, tiny_schema

SIZES = dict(latent_dim=16, num_blocks=2, num_heads=2)
MARGIN = 1e-3
OUT_TOL = dict(rtol=0, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)  # the loss is ~1e2: float32's ulp
GRAD_TOL = 1e-4  # times the leaf's largest |gradient|, where that is > 1


def schema_inputs():
    schema = tiny_schema()
    x = {k: np.asarray(v) for k, v in
         tiny_inputs(schema=schema, lengths=(2, 3, 1, 4)).items()}
    rng = np.random.default_rng(7)
    seq = np.arange(schema.max_length)[None, :] <= x["length"]
    masks = {c.name: (seq & (rng.random(seq.shape) < 0.5))
             if c.is_sequence else np.ones(4, bool)
             for c in schema.modeled}
    modified = jax_masking.preprocess_for_test(to_jax(x), schema,
                                               to_jax(masks))
    return schema, x, masks, {k: np.asarray(v) for k, v in modified.items()}


def zero_normal_jax():
    """A stand-in for the ``jax`` module whose ``random.normal`` gives
    zeros; the rest is JAX's."""
    random = types.SimpleNamespace(
        normal=lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    return types.SimpleNamespace(random=random)


def _jax_loss(schema, targets, outputs, masks, aux):
    loss, _ = jax_losses.compute_mfp_loss(schema, targets, outputs, masks)
    for name, value in aux.items():
        if name.endswith("_loss"):
            loss = loss + value
    return loss


def _argmax_margins(schema, outputs, masks, upto):
    """The least top-two gap of the categorical logits at the masked
    positions ``< upto`` (the argmaxes the decode commits)."""
    least = np.inf
    for c in schema.modeled:
        if not (c.is_sequence and c.is_categorical):
            continue
        top = np.sort(np.asarray(outputs[c.name]), -1)
        gap = top[..., -1] - top[..., -2]  # (B, S, C)
        sel = np.asarray(masks[c.name])[:, :upto]
        if sel.any():
            least = min(least, float(gap[:, :upto][sel].min()))
    return least


def build_family(name):
    """JAX's decode and zero-noise training branch with its gradients, and
    the port's model, all on the same weights: JAX's parameter shapes
    (``jax.eval_shape``, no compile) filled by the port's seeded
    initialisation, the two trees held equal."""
    monkeypatch = pytest.MonkeyPatch()
    schema, x, masks, modified = schema_inputs()
    jax_model = getattr(jax_baselines, name)(
        schema=schema, attention_impl="xla", dropout=0.0, **SIZES)
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "noise", "vae", "dropout"))}
    shapes = traverse_util.flatten_dict(jax.eval_shape(
        lambda: jax_model.init(rngs, to_jax(modified), to_jax(x),
                               to_jax(masks), deterministic=False)), sep="/")
    flat = params_to_jax(init_params(getattr(port_baselines, name)(
        schema, **SIZES), 0).state_dict())
    port_model = load_jax_params(getattr(port_baselines, name)(
        schema, dropout=0.0, **SIZES), flat)
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in shapes.items()}
    params = {"params": _unflatten({k: jnp.asarray(v)
                                    for k, v in flat.items()})}
    (decoded, _), state = jax.jit(lambda p: jax_model.apply(
        p, to_jax(modified), to_jax(x), to_jax(masks), True,
        capture_intermediates=lambda mdl, _: mdl.name == "length_fc",
        mutable=["intermediates"]))(params)

    monkeypatch.setattr(jax_cvae, "jax", zero_normal_jax())

    def train_loss(p):
        outputs, aux = jax_mfp.apply_model(
            jax_model, p, to_jax(modified), to_jax(x), to_jax(masks),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(5),
                                       "vae": jax.random.PRNGKey(6)})
        return _jax_loss(schema, to_jax(x), outputs, to_jax(masks), aux), (
            outputs, aux)

    (loss, (outputs, aux)), grads = jax.jit(jax.value_and_grad(
        train_loss, has_aux=True))(params)
    monkeypatch.undo()

    length_logits = state.get("intermediates", {}).get("length_fc")
    return types.SimpleNamespace(
        name=name, schema=schema, x=x, masks=masks, modified=modified,
        flat=flat, decoded=to_numpy(decoded),
        length_logits=None if length_logits is None
        else np.asarray(length_logits["__call__"][0]),
        train=dict(loss=float(loss), outputs=to_numpy(outputs),
                   aux={k: float(v) for k, v in aux.items()},
                   grads=flat_params(grads)),
        port=port_model)


def _unflatten(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")[1:]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _port_apply(f, deterministic):
    return port_mfp.apply_model(
        f.port, to_torch(f.modified), to_torch(f.x), to_torch(f.masks),
        deterministic)


def check_decode(f):
    """The decode within 1e-5 of JAX's, every argmax it takes at least
    ``MARGIN`` clear of a tie."""
    if f.name == "CanvasVAE":
        # The decode's one argmax: the predicted length.
        logits = np.sort(f.length_logits, -1)
        margin = float((logits[:, -1] - logits[:, -2]).min())
    else:
        upto = f.schema.max_length - (f.name != "LayoutVAE")
        margin = _argmax_margins(f.schema, f.decoded, f.masks, upto)
    assert margin >= MARGIN, margin
    with torch.no_grad():
        got, aux = _port_apply(f, deterministic=True)
    assert aux == {}
    assert set(got) == set(f.decoded)
    for k in sorted(f.decoded):
        np.testing.assert_allclose(got[k].numpy(), f.decoded[k], **OUT_TOL,
                                   err_msg=k)


def check_training(f):
    """The zero-noise training branch: outputs, loss, aux terms and every
    gradient against JAX's."""
    f.port.zero_grad()
    outputs, aux = _port_apply(f, deterministic=False)
    loss, _ = port_losses.compute_mfp_loss(f.schema, to_torch(f.x), outputs,
                                           to_torch(f.masks))
    for name, value in aux.items():
        if name.endswith("_loss"):
            loss = loss + value
    loss.backward()
    want = f.train
    assert set(aux) == set(want["aux"])
    if f.name in ("CanvasVAE", "LayoutVAE"):
        assert "kl_loss" in aux
    if f.name == "CanvasVAE":
        assert "length_loss" in aux and "kl_divergence" in aux
    for k in sorted(want["aux"]):
        np.testing.assert_allclose(aux[k].item(), want["aux"][k], **LOSS_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(loss.item(), want["loss"], **LOSS_TOL)
    for k in sorted(want["outputs"]):
        np.testing.assert_allclose(outputs[k].detach().numpy(),
                                   want["outputs"][k], **OUT_TOL, err_msg=k)
    got_grads = params_to_jax({n: p.grad for n, p in
                               f.port.named_parameters()})
    assert set(got_grads) == set(want["grads"])
    for k in sorted(want["grads"]):
        w = want["grads"][k]
        bar = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got_grads[k], w, rtol=0, atol=bar,
                                   err_msg=k)


def check_round_trip(f, tmp_path):
    """The JAX tree maps one to one onto the port's (``bos`` a rank-3
    leaf carried over as it is) and back; the port's weight file reloads
    into a fresh model bit for bit."""
    state = params_from_jax(f.flat)
    assert set(state) == set(f.port.state_dict())
    back = params_to_jax(f.port.state_dict())
    assert set(back) == set(f.flat)
    for k in f.flat:
        np.testing.assert_array_equal(back[k], f.flat[k], err_msg=k)
    if "params/bos" in f.flat:
        assert back["params/bos"].shape == (1, 1, SIZES["latent_dim"])
    path = str(tmp_path / "w.torch.npz")
    save_weights(path, f.port)
    fresh = getattr(port_baselines, f.name)(f.schema, **SIZES)
    load_weights(path, fresh)
    for (n, a), (_, b) in zip(f.port.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
