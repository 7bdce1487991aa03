"""The port's evaluation harness against ``flexdm_tpu.evaluation.harness``.

The same weights (``model_pair``: latent 32, 4 heads) and the same
synthetic split go through JAX's ``evaluate_task`` (its device-resident
scan, on the CPU) and the port's, on the CPU.  Tolerances:

* per-field scores within ``SCORE_ATOL`` = 1e-5 abs of JAX's, for every
  task mode, rico ``pos`` with the sort, a ``context='id'`` model, MaskGIT
  (``num_iter=2``) and crello_flat ``elem``; the ``random`` task with
  JAX's own ``fold_in`` uniforms handed in through ``uniforms_fn``, whose
  masks must equal JAX's exactly;
* ``evaluate_all`` after ``merge_results`` within 1.01e-4 (scores 1e-5
  apart may round to neighbouring 4th decimals);
* ``elem`` against a per-(document, element) loop of batch-1 forwards
  within 1e-4 relative (the JAX package's own test of that protocol);
* the port against itself at batch sizes 4 and 8 within 1e-6 abs.
"""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.data import DatasetSpec as JaxSpec  # noqa: E402
from flexdm_tpu.evaluation import harness as jax_harness  # noqa: E402
from flexdm_tpu_torch import cli  # noqa: E402
from flexdm_tpu_torch.config import TrainConfig, build_model  # noqa: E402
from flexdm_tpu_torch.convert import init_params, save_weights  # noqa: E402
from flexdm_tpu_torch.data import DatasetSpec as PortSpec  # noqa: E402
from flexdm_tpu_torch.data import synthetic  # noqa: E402
from flexdm_tpu_torch.demo import load_model  # noqa: E402
from flexdm_tpu_torch.evaluation import harness  # noqa: E402
from flexdm_tpu_torch.models.masking import (  # noqa: E402
    get_initial_masks,
    get_seq_mask,
)
from flexdm_tpu_torch.train.trainer import to_device  # noqa: E402
from tests._torch_parity import (  # noqa: E402
    model_pair,
    numpy_batch,
    to_jax,
    to_torch,
)

SCORE_ATOL = 1e-5
GROUPS = ("pos", "attr", "img", "txt", "type")


def _both(jax_spec, port_spec, jax_model, params, port_model, task_mode,
          batch_size=8, port_kwargs=None, **kwargs):
    """JAX's and the port's ``evaluate_task`` over the test split
    (``port_kwargs`` go to the port's alone)."""
    groups = jax_spec.schema.attribute_groups
    group = (task_mode, groups[task_mode]) if task_mode in groups else None
    want = jax_harness.evaluate_task(
        jax_model, params, jax_spec.make_dataset("test", batch_size=batch_size),
        task_mode, group, **kwargs)
    got = harness.evaluate_task(
        port_model, port_spec.make_dataset("test", batch_size=batch_size),
        task_mode, group, **kwargs, **(port_kwargs or {}))
    return got, want


def _assert_scores_close(got, want, atol=SCORE_ATOL):
    assert want and set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def crello(crello_spec, crello_dir):
    port_spec = PortSpec("crello", crello_dir, 8)
    models = model_pair(crello_spec.schema, numpy_batch(crello_spec, 4),
                        num_blocks=1)
    return (crello_spec, port_spec) + models


@pytest.mark.parametrize("task_mode", GROUPS + ("elem",))
def test_task_scores_match_jax(crello, task_mode):
    got, want = _both(*crello, task_mode)
    _assert_scores_close(got, want)
    if task_mode in GROUPS:
        assert set(got) == set(crello[0].schema.attribute_groups[task_mode])


def test_elem_matches_per_element_loop(crello):
    """The chunked ``elem`` (chunks of 64 that straddle documents) against
    one batch-1 forward per (document, element): the reference protocol
    (eval.py:66-72), as ``tests/test_eval_harness.py`` holds JAX's."""
    _, port_spec, _, _, model = crello
    schema = model.schema
    fast = harness.evaluate_task(
        model, port_spec.make_dataset("test", batch_size=4), "elem", None,
        elem_chunk=64)
    step, names = harness.make_eval_step(model)
    total = {}
    for host in port_spec.make_dataset("test", batch_size=4):
        batch = to_device(host, "cpu")
        for b in range(host["num_valid"]):
            one = {k: v[b:b + 1] for k, v in batch.items()}
            for i in range(int(one["length"][0, 0]) + 1):
                masks = get_initial_masks(
                    schema, get_seq_mask(one["length"], schema.max_length))
                eye = torch.zeros((1, schema.max_length), dtype=torch.bool)
                eye[0, i] = True
                for c in schema.modeled:
                    if c.is_sequence:
                        masks[c.name] = eye
                harness._accumulate(total, names,
                                    step(one, masks, torch.ones(1)))
    slow = harness._ratios(schema, total)
    assert set(fast) == set(slow)
    for k in slow:
        np.testing.assert_allclose(fast[k], slow[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("picks", [
    [(0, 0), (0, 1), (1, 2), (3, 1), (4, 0), (2, 0)],  # straddles documents
    [(3, 0), (4, 0), (4, 0), (1, -1)],  # a padded row, padding ids
])
def test_elem_chunk_gathers_the_expansion(crello_spec, picks):
    """``_elem_chunk`` gathers the rows, masks and weights of JAX's
    ``_expand_elem`` at the replica ids ``b * S + i`` (an out-of-range id
    and a padded batch row weigh 0)."""
    schema = crello_spec.schema
    S = schema.max_length
    batch = numpy_batch(crello_spec, 4)
    expanded, eye, valid = jax_harness._expand_elem(to_jax(batch), schema)
    idx = torch.tensor([b * S + i % S for b, i in picks])
    weight = torch.tensor([1.0, 1.0, 1.0, 0.0])
    rows, masks, w = harness._elem_chunk(schema, to_torch(batch), idx, weight)
    r = idx.clamp(max=4 * S - 1).numpy()
    for k in rows:
        np.testing.assert_array_equal(rows[k].numpy(),
                                      np.asarray(expanded[k])[r], err_msg=k)
    for c in schema.modeled:
        want_mask = (np.asarray(eye)[r] if c.is_sequence
                     else np.ones(len(picks), dtype=bool))
        np.testing.assert_array_equal(masks[c.name].numpy(), want_mask,
                                      err_msg=c.name)
    want_w = (np.asarray(valid)[r] * weight.numpy()[r // S]
              * (idx < 4 * S).numpy())
    np.testing.assert_array_equal(w.numpy(), want_w.astype(np.float32))
    assert all(w[j] == 0 for j, (b, _) in enumerate(picks) if b >= 3)


def _jax_uniforms(schema, seed, ids):
    """A ``uniforms_fn`` with JAX's draws: ``uniform(fold_in(key, id))``,
    as ``flexdm_tpu.evaluation.harness._random_masks`` draws them."""
    n_seq = sum(1 for c in schema.modeled if c.is_sequence)
    key = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda g: jax.random.fold_in(key, g))(
        jnp.asarray(list(ids), dtype=jnp.uint32))
    draws = jax.vmap(
        lambda k: jax.random.uniform(k, (n_seq, schema.max_length)))(keys)
    return torch.from_numpy(np.array(draws))


def test_random_with_jax_draws_matches_jax(crello):
    jax_spec = crello[0]
    schema = jax_spec.schema
    batch = numpy_batch(jax_spec, 8)
    want = jax_harness._random_masks(
        schema, to_jax(batch), jax.random.PRNGKey(3),
        jnp.arange(8, 16, dtype=jnp.int32))
    got = harness._random_masks(schema, to_torch(batch),
                                _jax_uniforms(schema, 3, range(8, 16)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert sum(int(got[c.name].sum()) for c in schema.sequence_columns) > 0
    got, want = _both(*crello, "random", seed=3,
                      port_kwargs={"uniforms_fn": _jax_uniforms})
    _assert_scores_close(got, want)


def test_rico_pos_sorted_matches_jax(rico_spec, rico_dir, monkeypatch):
    """rico ``pos`` is scored on sorted elements (``sort_flag`` all True;
    rico ``attr`` is not sorted)."""
    schema = rico_spec.schema
    assert schema.sort_pos
    port_spec = PortSpec("rico", rico_dir, 8)
    models = model_pair(schema, numpy_batch(rico_spec, 4), num_blocks=1)
    flags = []
    real_loss = harness.compute_mfp_loss

    def recording_loss(*args, sort_flag=None, **kwargs):
        flags.append(sort_flag)
        return real_loss(*args, sort_flag=sort_flag, **kwargs)

    monkeypatch.setattr(harness, "compute_mfp_loss", recording_loss)
    got, want = _both(rico_spec, port_spec, *models, "pos")
    _assert_scores_close(got, want)
    assert flags and all(f is not None and bool(f.all()) for f in flags)
    flags.clear()
    _assert_scores_close(*_both(rico_spec, port_spec, *models, "attr"))
    assert flags and all(f is None for f in flags)


def test_context_id_threads_task_id(crello_spec, crello_dir):
    schema = crello_spec.schema
    port_spec = PortSpec("crello", crello_dir, 8)
    models = model_pair(schema, numpy_batch(crello_spec, 4), num_blocks=1,
                        context="id")
    got, want = _both(crello_spec, port_spec, *models, "pos")
    _assert_scores_close(got, want)
    loader = port_spec.make_dataset("test", batch_size=8)
    batch, weight, _, _ = next(harness._batches(loader, "cpu"))
    masks = harness._group_masks(schema, batch,
                                 schema.attribute_groups["pos"])
    predictions = []

    def observe(batch, masks, weight, prediction, rounds):
        predictions.append(prediction["left"])

    for task_id in (harness.task_id_for_mode(schema, "pos"), 0):
        step, _ = harness.make_eval_step(models[2], task_id=task_id,
                                         observe=observe)
        step(batch, masks, weight)
    assert not torch.equal(*predictions)  # the task embedding matters


def test_maskgit_matches_jax(crello):
    got, want = _both(*crello, "pos", num_iter=2)
    _assert_scores_close(got, want)
    one_pass, _ = _both(*crello, "pos")
    assert one_pass != got


def test_flat_elem_on_four_documents(tmp_path):
    """crello_flat (S * F = 500 tokens) ``elem`` over a 4-document split."""
    data_dir = synthetic.generate("crello", str(tmp_path / "data"), 8, 4, 4,
                                  seed=2)
    jax_spec = JaxSpec("crello", data_dir, batch_size=4)
    port_spec = PortSpec("crello", data_dir, 4)
    models = model_pair(jax_spec.schema, numpy_batch(jax_spec, 4),
                        num_blocks=1, seq_type="flat",
                        input_dtype="shuffled_set")
    got, want = _both(jax_spec, port_spec, *models, "elem", batch_size=4,
                      elem_chunk=16)
    _assert_scores_close(got, want)


def test_evaluate_all_all_feat_matches_jax(crello):
    jax_spec, port_spec, jax_model, params, port_model = crello
    want = jax_harness.evaluate_all(jax_model, params, jax_spec, "all_feat",
                                    batch_size=8)
    got = harness.evaluate_all(port_model, port_spec, "all_feat",
                               batch_size=8)
    assert set(got) == set(want) == {"pos", "attr", "img", "txt"}
    want, got = jax_harness.merge_results(want), harness.merge_results(got)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1.01e-4, (k, got[k], want[k])


@pytest.mark.parametrize("task_mode", ["pos", "elem", "random"])
def test_scores_do_not_change_with_batch_size(crello, task_mode):
    _, port_spec, _, _, model = crello
    group = None
    if task_mode == "pos":
        group = ("pos", port_spec.schema.attribute_groups["pos"])
    runs = [harness.evaluate_task(
        model, port_spec.make_dataset("test", batch_size=b), task_mode,
        group, seed=5) for b in (4, 8)]
    _assert_scores_close(runs[1], runs[0], atol=1e-6)


def test_empty_split_scores_nothing(crello, tmp_path):
    data_dir = synthetic.generate("crello", str(tmp_path / "data"), 4, 4, 0)
    port_spec = PortSpec("crello", data_dir, 4)
    model = crello[4]
    loader = port_spec.make_dataset("test")
    assert loader.num_records == 0
    assert harness.evaluate_task(model, loader, "elem", None) == {}
    assert harness.merge_results(
        harness.evaluate_all(model, port_spec, "all_feat")) == {}


def test_main_writes_the_csv_of_evaluate_all(crello_dir, tmp_path):
    """The CLI on a job the port's trainer wrote: the CSV holds the keys and
    the values of ``merge_results(evaluate_all(...))``."""
    job = str(tmp_path / "job")
    cli.main(["--preset", "crello_ours_exp", "--data_dir", crello_dir,
              "--job-dir", job, "--num_epochs", "1", "--batch_size", "16",
              "--latent_dim", "32", "--num_blocks", "1", "--device", "cpu",
              "--log_level", "WARNING"])
    out = str(tmp_path / "scores.csv")
    final = harness.main(["--job-dir", job, "--device", "cpu",
                          "--task_mode", "all_feat", "--batch_size", "8",
                          "--result_csv", out])
    model, spec = load_model(job, device="cpu")
    want = harness.merge_results(
        harness.evaluate_all(model, spec, "all_feat", batch_size=8))
    assert final == want
    with open(out) as f:
        keys, values = list(csv.reader(f))
    assert keys == list(want) and [float(v) for v in values] == list(
        want.values())


@pytest.mark.parametrize("flags", [["--attention_impl", "flash"],
                                   ["--attention_impl", "pallas"]])
def test_main_refuses_what_the_port_lacks(flags):
    """An unknown ``--attention_impl``, and the kernels (``pallas``) off a
    card, raise before the job is read."""
    with pytest.raises(ValueError, match="attention impl"):
        harness.main(["--job-dir", "no_such_job", "--device", "cpu", *flags])


def test_main_surfaces_the_elemwise_noise_refusal(crello_dir, tmp_path):
    """``forward_eval`` refuses a ``use_elemwise_noise`` model; the CLI
    raises that error instead of scoring."""
    job = tmp_path / "job"
    os.makedirs(job / "checkpoints")
    args = {"dataset_name": "crello", "data_dir": crello_dir,
            "latent_dim": 32, "num_blocks": 1, "num_heads": 4,
            "use_elemwise_noise": True}
    (job / "args.json").write_text(json.dumps(args))
    schema = PortSpec("crello", crello_dir, 4).schema
    save_weights(str(job / "checkpoints" / "best.torch.npz"),
                 init_params(build_model(TrainConfig.from_args(args),
                                         schema), 0))
    with pytest.raises(ValueError, match="use_elemwise_noise"):
        harness.main(["--job-dir", str(job), "--device", "cpu",
                      "--task_mode", "pos", "--batch_size", "8"])


@pytest.mark.parametrize("chunk", [4, 64])
def test_elem_replicas_are_the_real_elements(chunk):
    """``length`` is zero-based and clipped to ``S``; a row past
    ``num_valid`` (-1) has none; the ids are padded to whole chunks with
    the out-of-range ``B * S``."""
    S = 5
    lengths = np.array([0, 2, -1, 7, 4])
    ids = harness._elem_replicas(lengths, S, chunk)
    real = [b * S + i for b, n in enumerate(lengths)
            for i in range(min(max(n + 1, 0), S))]
    assert len(ids) % chunk == 0
    assert ids[:len(real)].tolist() == real
    assert (ids[len(real):] == len(lengths) * S).all()
