"""The port's LayoutVAE against the JAX package's on the CPU: the decode,
the zero-noise training branch with its gradients and the weight round
trip (tolerances in ``tests/_torch_baselines.py``); and the CVAE pieces
every VAE baseline shares, ``Head`` and ``gaussian_kl``, against JAX's
within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flexdm_tpu.models.baselines import cvae as jax_cvae  # noqa: E402
from flexdm_tpu_torch.convert import load_jax_params  # noqa: E402
from flexdm_tpu_torch.models import baselines as port_baselines  # noqa: E402
from tests._torch_baselines import (  # noqa: E402
    build_family,
    check_decode,
    check_round_trip,
    check_training,
    zero_normal_jax,
)
from tests._torch_parity import flat_params  # noqa: E402


@pytest.fixture(scope="module")
def layoutvae():
    return build_family("LayoutVAE")


def test_decode_matches_jax(layoutvae):
    check_decode(layoutvae)


def test_training_branch_matches_jax(layoutvae):
    check_training(layoutvae)


def test_weights_round_trip(layoutvae, tmp_path):
    check_round_trip(layoutvae, tmp_path)


def test_head_and_gaussian_kl_match_jax():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(3, 8)).astype(np.float32)
    head = jax_cvae.Head(latent_dim=4, compute_kl=True)
    params = head.init({"params": jax.random.PRNGKey(0),
                        "vae": jax.random.PRNGKey(1)}, jnp.asarray(h), False)
    port = port_baselines.Head(8, 4, compute_kl=True)
    load_jax_params(port, flat_params(params))
    want, want_aux = head.apply(params, jnp.asarray(h), True)
    got, got_aux = port(torch.from_numpy(h), True)
    assert got_aux == {} and not want_aux
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-6)
    # Training with zero noise: z is the mean, the KL is JAX's.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cvae, "jax", zero_normal_jax())
        want, want_aux = head.apply(params, jnp.asarray(h), False,
                                    rngs={"vae": jax.random.PRNGKey(2)})
    got, got_aux = port(torch.from_numpy(h), False, None)
    np.testing.assert_allclose(got["z"].detach().numpy(),
                               np.asarray(want["z"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_aux["kl_divergence"].item(),
                               float(want_aux["kl_divergence"]), rtol=0,
                               atol=1e-6)
    # With a generator the noise is N(0, 1) scaled by exp(0.5 log_sigma).
    g = torch.Generator().manual_seed(0)
    z = port(torch.from_numpy(h), False, g)[0]
    eps = torch.randn(z["z"].shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        z["z"], z["z_mean"] + torch.exp(0.5 * z["z_log_sigma"]) * eps)

    args = [rng.normal(size=(2, 5, 4)).astype(np.float32) for _ in range(4)]
    want = jax_cvae.gaussian_kl(*map(jnp.asarray, args))
    got = port_baselines.gaussian_kl(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


