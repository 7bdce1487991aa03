"""The baselines on the card against the port on the CPU: one training
step (dropout 0, the same draws and VAE normals) and the decode, with the
attention kernels' launches counted.  Imports no JAX, so it runs where the
card is:

    python -m pytest --noconftest -m cuda tests/test_torch_baselines_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode).
Sizes: a crello-like schema of S=12, D=64, 2 heads (head dim 32, which the
kernels take), 2 blocks, batch 6."""

import copy

import numpy as np
import pytest
import torch

from flexdm_tpu_torch.data.schema import (
    CATEGORICAL,
    NUMERICAL,
    ColumnSpec,
    LossCondition,
    Schema,
)
from flexdm_tpu_torch.convert import init_params
from flexdm_tpu_torch.models import baselines, make_task_config
from flexdm_tpu_torch.models.masking import draw_train, get_seq_mask
from flexdm_tpu_torch.models.mfp import draw_options, forward_eval
from flexdm_tpu_torch.ops import attention as attn
from flexdm_tpu_torch.train.optim import KerasAdam
from flexdm_tpu_torch.train.trainer import make_train_step

S, B = 12, 6
SIZES = dict(latent_dim=64, num_blocks=2, num_heads=2)
# Attention forward launches per training step and per decode, at
# num_blocks = 2 and S = 12 (BART and CanvasVAE: 1 + 1 blocks).
STEP = {"CanvasVAE": 2, "LayoutVAE": 2 * S, "AutoReg": 2, "BART": 3}
DECODE = {"CanvasVAE": 2, "LayoutVAE": 2 * S, "AutoReg": 2 * S,
          "BART": 1 + 2 * (S - 1) + 2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def _schema():
    cols = (
        ColumnSpec("length", CATEGORICAL, (1,), False, input_dim=S),
        ColumnSpec("type", CATEGORICAL, (1,), True, input_dim=3,
                   primary_label=0),
        ColumnSpec("left", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("width", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("top", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("height", CATEGORICAL, (1,), True, input_dim=8),
        ColumnSpec("emb", NUMERICAL, (4,), True,
                   loss_condition=LossCondition("type", (False, True, False))),
    )
    return Schema("crello", cols, max_length=S)


def _batch(schema):
    rng = np.random.default_rng(0)
    x = {"length": np.array([[3], [11], [0], [7], [5], [9]], np.int32),
         "emb": rng.normal(size=(B, S, 4)).astype(np.float32)}
    for c in schema.modeled:
        if c.is_sequence and c.is_categorical:
            x[c.name] = rng.integers(0, c.input_dim, (B, S, 1)).astype(
                np.int32)
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _launches():
    return (attn.KERNEL_LAUNCHES, attn.BWD_DQ_LAUNCHES,
            attn.BWD_DKV_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STEP))
def test_baseline_step_and_decode_on_card(name):
    _need_card()
    schema = _schema()
    batch = _batch(schema)
    task_config = make_task_config(schema, "random")
    cpu = init_params(getattr(baselines, name)(schema, dropout=0.0, **SIZES),
                      0)
    card = copy.deepcopy(cpu).cuda()
    # The decode, before the step changes the weights.
    seq = get_seq_mask(batch["length"], S)
    g = torch.Generator().manual_seed(3)
    masks = {c.name: seq & (torch.rand(seq.shape, generator=g) < 0.4)
             if c.is_sequence else torch.ones(B, dtype=torch.bool)
             for c in schema.modeled}
    want = forward_eval(cpu, batch, masks)
    attn.reset_launch_counts()
    got = forward_eval(card, {k: v.cuda() for k, v in batch.items()},
                       {k: v.cuda() for k, v in masks.items()})
    assert _launches() == (DECODE[name], 0, 0)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-4,
                                   atol=1e-4, msg=k)

    draws = draw_train(schema, B, task_config.task_probs,
                       torch.Generator().manual_seed(1), **draw_options(cpu))
    results = {}
    for where, model in (("cpu", cpu), ("cuda", card)):
        run = draws.to(where)
        run.vae = torch.Generator().manual_seed(2)  # the same normals
        step = make_train_step(model, task_config,
                               KerasAdam(model.parameters(), 1e-4), 1e-2)
        attn.reset_launch_counts()
        metrics = step({k: v.to(where) for k, v in batch.items()}, run)
        results[where] = ({k: v.item() for k, v in metrics.items()},
                          _launches(),
                          [p.detach().cpu() for p in model.parameters()])
    (want, _, want_p), (got, launches, got_p) = results["cpu"], results["cuda"]
    assert launches == (STEP[name],) * 3
    assert set(got) == set(want)
    for k in want:  # the loss and its terms (the scores count argmaxes)
        if k.endswith(("loss", "_kl", "kl_divergence")):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) + 1e-6, k
    for p, w in zip(got_p, want_p):
        assert (p - w).abs().max().item() <= 2e-4 + 1e-6
