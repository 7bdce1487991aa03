"""The port's layout metrics against ``flexdm_tpu.evaluation.layout_metrics``
on the CPU, within 1e-6: every function on the hand-made documents of
``tests/test_layout_metrics.py`` and on a random crello-like batch, from
labels and from logits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.evaluation import layout_metrics as jax_lm  # noqa: E402
from flexdm_tpu.models import masking as jax_masking  # noqa: E402
from flexdm_tpu_torch.evaluation import layout_metrics as port_lm  # noqa: E402
from tests._torch_parity import to_jax, to_torch  # noqa: E402
from tests.test_layout_metrics import _example  # noqa: E402
from tests.test_masking import tiny_schema  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)

# (boxes as (left, top, width, height), types, length) of
# tests/test_layout_metrics.py.
DOCUMENTS = [
    ([(0, 0, 3, 3), (1, 1, 2, 2)], [1, 2], 2),
    ([(0, 0, 3, 3), (4, 4, 2, 2)], [1, 2], 2),
    ([(2, 0, 2, 2), (2, 4, 3, 2)], [1, 1], 2),
    ([(0, 0, 4, 4), (0, 0, 4, 4)], [1, 1], 2),
    ([(0, 0, 3, 3)], [1], 1),
]


def _hand_made():
    """The documents above stacked into one batch."""
    schema = tiny_schema()
    docs = [{k: np.asarray(v) for k, v in _example(schema, *d).items()}
            for d in DOCUMENTS]
    return schema, {k: np.concatenate([d[k] for d in docs]) for k in docs[0]}


def _random(seed, from_logits):
    """A random batch of 8 documents; with ``from_logits`` each
    categorical field as (B, S, 1, V) logits."""
    schema = tiny_schema()
    rng = np.random.default_rng(seed)
    S = schema.max_length
    x = {"length": rng.integers(0, S, (8, 1)).astype(np.int32),
         "emb": rng.normal(size=(8, S, 4)).astype(np.float32)}
    for c in schema.columns:
        if c.is_sequence and c.is_categorical:
            x[c.name] = (rng.normal(size=(8, S, 1, c.input_dim)).astype(
                np.float32) if from_logits else
                rng.integers(0, c.input_dim, (8, S, 1)).astype(np.int32))
    return schema, x


def _mask(schema, x):
    return np.array(jax_masking.get_seq_mask(jnp.asarray(x["length"]),
                                               schema.max_length))


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["hand_made", "labels", "logits"])
def test_alignment_overlap_scores_match_jax(case):
    from_logits = case == "logits"
    schema, x = _hand_made() if case == "hand_made" else _random(0,
                                                                 from_logits)
    mask = _mask(schema, x)
    want = jax_lm.alignment_overlap_scores(to_jax(x), jnp.asarray(mask),
                                           schema, from_logits)
    got = port_lm.alignment_overlap_scores(to_torch(x),
                                           torch.from_numpy(mask), schema,
                                           from_logits)
    _close(got, want)


@pytest.mark.parametrize("case", ["hand_made", "labels", "logits"])
def test_compute_gridmaps_matches_jax(case):
    from_logits = case == "logits"
    schema, x = _hand_made() if case == "hand_made" else _random(1,
                                                                 from_logits)
    mask = _mask(schema, x)
    want = jax_lm.compute_gridmaps(to_jax(x), jnp.asarray(mask), schema,
                                   from_logits)
    got = port_lm.compute_gridmaps(to_torch(x), torch.from_numpy(mask),
                                   schema, from_logits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "hand_made":
        g = got[0].numpy()
        assert g[0, 0] == 1 and g[2, 2] == 2 and g[7, 7] == 0


def test_layout_acc_miou_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 3, (4, 8, 8))
    b = np.where(rng.random((4, 8, 8)) < 0.3, rng.integers(0, 3, (4, 8, 8)),
                 a)
    b[0] = a[0]  # an identical pair: accuracy and mIoU 1
    for pair in ((a, b), (a, a), (b, a)):
        want = jax_lm.layout_acc_miou(*map(jnp.asarray, pair), 3)
        got = port_lm.layout_acc_miou(*map(torch.from_numpy, pair), 3)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    acc, miou = port_lm.layout_acc_miou(torch.zeros(1, 4, 4, dtype=torch.long),
                                        torch.zeros(1, 4, 4,
                                                    dtype=torch.long).index_fill(
                                            1, torch.arange(2), 1), 2)
    np.testing.assert_allclose([acc.item(), miou.item()], [0.5, 0.25],
                               atol=1e-6)


@pytest.mark.parametrize("use_true_length", [False, True])
def test_layout_metrics_matches_jax(use_true_length):
    schema, y_true = _random(3, from_logits=False)
    _, y_pred = _random(4, from_logits=True)
    y_pred["length"] = np.random.default_rng(5).normal(
        size=(8, 1, schema["length"].input_dim)).astype(np.float32)
    want = jax_lm.layout_metrics(to_jax(y_true), to_jax(y_pred), schema,
                                 use_true_length=use_true_length)
    got = port_lm.layout_metrics(to_torch(y_true), to_torch(y_pred), schema,
                                 use_true_length=use_true_length)
    _close(got, want)
    schema, x = _hand_made()
    want = jax_lm.layout_metrics(to_jax(x), to_jax(x), schema,
                                 from_logits=False, use_true_length=True)
    got = port_lm.layout_metrics(to_torch(x), to_torch(x), schema,
                                 from_logits=False, use_true_length=True)
    _close(got, want)
    assert got["layout_acc"].item() == 1.0
