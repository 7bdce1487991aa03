"""``remat``: each block recomputed in the backward.

* With the dropout on, ``remat=True`` gives the loss and gradients of
  ``remat=False`` within 1e-6 (the recomputation replays the block's
  dropout draws from the explicit generator), runs each block's forward
  twice, and leaves the generator where ``remat=False`` leaves it; for the
  default and the flat (crello_flat) model.
* The port's ``remat=True`` step against JAX's ``remat=True`` step
  (``MFPModel(remat=True)``, as ``TrainConfig(remat=True)`` builds it), at
  the tolerances of ``test_train_step_matches_jax``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch.convert import init_params  # noqa: E402
from flexdm_tpu_torch.models import forward_train, make_task_config  # noqa: E402
from flexdm_tpu_torch.models import mfp as port_mfp  # noqa: E402
from flexdm_tpu_torch.models.masking import draw_train  # noqa: E402
from flexdm_tpu_torch.train.optim import l2_penalty  # noqa: E402
from tests._torch_parity import numpy_batch, to_torch  # noqa: E402
from tests.test_torch_train import METHOD, _check_step_matches_jax  # noqa: E402


def _loss_and_grads(spec, remat, **model_kwargs):
    schema = spec.schema
    model = init_params(port_mfp.MFPModel(
        schema, latent_dim=32, num_blocks=2, num_heads=4, dropout=0.1,
        remat=remat, **model_kwargs), 0)
    calls = []
    for block in model.blocks.children():
        block.register_forward_pre_hook(lambda *args: calls.append(1))
    task_config = make_task_config(schema, METHOD)
    generator = torch.Generator().manual_seed(11)
    batch = to_torch(numpy_batch(spec, 8))
    draws = draw_train(schema, 8, task_config.task_probs, generator,
                       **model.draw_options())
    draws.dropout = generator
    loss, _ = forward_train(model, batch, draws, task_config, train=True)
    loss = loss + 1e-2 * l2_penalty(model)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.item(), grads, len(calls), generator.get_state()


@pytest.mark.parametrize("model_kwargs", [
    {}, {"seq_type": "flat", "input_dtype": "shuffled_set"},
], ids=["default", "flat"])
def test_remat_keeps_loss_and_gradients_with_dropout(crello_spec,
                                                     model_kwargs):
    loss, grads, calls, state = _loss_and_grads(crello_spec, False,
                                                **model_kwargs)
    r_loss, r_grads, r_calls, r_state = _loss_and_grads(crello_spec, True,
                                                        **model_kwargs)
    assert (calls, r_calls) == (2, 4)  # 2 blocks; each recomputed once
    assert torch.equal(state, r_state)
    np.testing.assert_allclose(r_loss, loss, rtol=1e-6, atol=1e-6)
    assert sum(bool(g.abs().max() > 0) for g in grads) > len(grads) // 2
    for g, r in zip(grads, r_grads):
        np.testing.assert_allclose(r.numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_remat_train_step_matches_jax(crello_spec):
    _check_step_matches_jax(crello_spec, METHOD, remat=True)
