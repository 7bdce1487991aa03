"""Port MaskGIT decoding (``iterative_decode`` through ``forward_eval``)
against the JAX package on the same batch, masks and weights: the
committed categorical fields equal, every output within ``SLICE_TOL``.

The decoder heads' weights are scaled up so that the softmax confidences
spread out; the test checks that no confidence of a masked field lies
within 1e-6 of its round's threshold (a near tie could flip a commit
between the two packages' float32 roundings, and then the failure says
why)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu import demo as jax_demo  # noqa: E402
from flexdm_tpu.models import mfp as jax_mfp  # noqa: E402
from flexdm_tpu_torch import demo as port_demo  # noqa: E402
from flexdm_tpu_torch.convert import load_jax_params  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    assert_trees_close,
    flat_params,
    model_pair,
    numpy_batch,
    random_masks,
    to_jax,
    to_numpy,
    to_torch,
)

SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
TIE = 1e-6


def _peaky(schema, batch, **kwargs):
    """JAX and port models whose decoder kernels are scaled by 8."""
    import jax

    jax_model, params, port_model = model_pair(schema, batch, **kwargs)
    flat = flat_params(params)
    for name in flat:
        if "/decoder/" in name and name.endswith("kernel"):
            flat[name] = 8.0 * flat[name]
    from flax import traverse_util

    params = jax.tree_util.tree_map(
        np.asarray, traverse_util.unflatten_dict(flat, sep="/"))
    load_jax_params(port_model, flat)
    return jax_model, params, port_model


def _check_no_near_tie(rounds):
    for i, r in enumerate(rounds):
        thr = r["threshold"][:, None]
        for name, conf in r["confidence"].items():
            gap = (conf - thr).abs()
            near = (conf > 0) & (gap > 0) & (gap <= TIE)
            assert not near.any(), (
                f"round {i}: {int(near.sum())} confidence(s) of {name} within "
                f"{TIE} of the threshold; a mismatch there is a near tie")


@pytest.mark.parametrize("dataset,context", [("crello", None), ("rico", "id")])
@pytest.mark.parametrize("num_iter", [2, 3])
@pytest.mark.parametrize("task", ["pos", "random"])
def test_iterative_decode_matches_jax(request, dataset, context, num_iter,
                                      task):
    spec = request.getfixturevalue(f"{dataset}_spec")
    schema = spec.schema
    batch = numpy_batch(spec, 4)
    jax_model, params, port_model = _peaky(schema, batch, context=context)
    if task == "random":
        masks = random_masks(schema, batch, seed=num_iter, p=0.5)
        jax_masks, port_masks = to_jax(masks), to_torch(masks)
    else:
        jax_masks = jax_demo.build_task_masks(schema, to_jax(batch), task)
        port_masks = port_demo.build_task_masks(schema, to_torch(batch), task)
    tasks = None
    if context == "id":
        tasks = np.full(4, schema.task_names.index("pos"), np.int32)
    want = jax_mfp.forward_eval(
        jax_model, params, to_jax(batch), jax_masks,
        tasks=None if tasks is None else to_jax({"t": tasks})["t"],
        num_iter=num_iter,
    )
    rounds = []
    got = port_mfp.forward_eval(
        port_model, to_torch(batch), port_masks,
        tasks=None if tasks is None else torch.from_numpy(tasks),
        num_iter=num_iter, rounds=rounds,
    )
    assert len(rounds) == num_iter
    _check_no_near_tie(rounds)
    assert set(got) == set(want)
    for c in schema.sequence_columns:
        if c.is_categorical:
            masked = port_masks[c.name].numpy()
            np.testing.assert_array_equal(
                got[c.name].argmax(-1).numpy()[masked],
                np.asarray(want[c.name]).argmax(-1)[masked], err_msg=c.name)
    assert_trees_close(to_numpy(got), want, **SLICE_TOL)
    # Every round committed something, and decoding differs from one pass.
    one_pass = port_mfp.forward_eval(port_model, to_torch(batch), port_masks,
                                     tasks=None if tasks is None
                                     else torch.from_numpy(tasks))
    assert any(not torch.equal(one_pass[c.name], got[c.name])
               for c in schema.sequence_columns if c.is_categorical)


def test_num_iter_below_two_is_one_pass(crello_spec):
    schema = crello_spec.schema
    batch = numpy_batch(crello_spec, 2)
    _, _, model = model_pair(schema, batch, num_blocks=1)
    masks = port_demo.build_task_masks(schema, to_torch(batch), "attr")
    one = port_mfp.forward_eval(model, to_torch(batch), masks)
    for num_iter in (0, -1):
        other = port_mfp.forward_eval(model, to_torch(batch), masks,
                                      num_iter=num_iter)
        assert all(torch.equal(one[k], other[k]) for k in one)
