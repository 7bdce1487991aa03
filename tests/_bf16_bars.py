"""The bars of the bf16 attention tests, shared by the CPU tests (with
JAX) and the card tests (without): one bf16 ulp, the card's bar for the
kernels, and bf16 draws.  Imports neither JAX nor the JAX package."""

import numpy as np
import torch

ULP = 2.0 ** -7
LSE_TOL = dict(rtol=2e-5, atol=2e-5)


def assert_bf16_close(got, want, name="", floor=True):
    """``|got - want| <= 2^-7 |want| + 2^-8 max|want|`` (the card's bar),
    or within one ulp alone (``floor=False``), elementwise in float32."""
    got, want = (x.float() if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x, np.float32))
                 for x in (got, want))
    bound = ULP * want.abs()
    if floor:
        bound = bound + 2.0 ** -8 * want.abs().max()
    err = (got - want).abs()
    assert bool((err <= bound + 1e-30).all()), (
        f"{name}: max error {err.max().item():.3e}, worst excess "
        f"{(err - bound).max().item():.3e}")


def bf16_draw(rng, shape):
    """A standard normal draw rounded to bf16, as numpy float32 (exact)."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()
