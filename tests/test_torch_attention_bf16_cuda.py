"""The bf16 attention kernels on the card: forward and backward against
their plain bf16 versions, the tile edges, and the backward's bitwise
repeatability.  Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bf16_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode)."""

import pytest
import torch

from flexdm_tpu_torch.ops import attention as port_attn
from _bf16_bars import LSE_TOL, assert_bf16_close


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def _card_inputs(shape, seed, fully_masked=True):
    b, _, s, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).bfloat16().cuda()
                   for _ in range(4))
    mask = torch.rand(b, s, generator=g) > 0.3
    mask[:, 0] = True
    if fully_masked:
        mask[-1] = False
    return q, k, v, do, mask.cuda()


def _kernel_grads(q, k, v, do, mask, causal):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(
        port_attn.dot_product_attention(*leaves, mask, causal), leaves, do)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 50, 32), (2, 4, 650, 32),
                                   (2, 4, 512, 64), (2, 2, 100, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernels_match_plain_on_card(shape, causal):
    _need_card()
    q, k, v, do, mask = _card_inputs(shape, sum(shape))
    b, _, s, _ = shape
    before = port_attn.BF16_FWD_LAUNCHES
    o, lse = port_attn.flash_attention_forward(q, k, v, mask, causal)
    assert port_attn.BF16_FWD_LAUNCHES == before + 1
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    bias = port_attn.key_bias(mask, b, s, q.device)
    assert_bf16_close(o, port_attn.attention_reference(q, k, v, bias, causal),
                      "O")
    torch.testing.assert_close(
        lse, port_attn.attention_reference_lse(q, k, bias, causal), **LSE_TOL)
    got = _kernel_grads(q, k, v, do, mask, causal)
    want = port_attn.attention_reference_backward(q, k, v, bias, o, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert_bf16_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 17, 63, 64, 65, 128, 129])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_bf16_kernel_tile_edges_on_card(s, dh):
    """The bf16 kernels' tile edges, causal, with a fully masked row: O,
    dq, dk and dv within the card's bar, and a second call bitwise
    equal."""
    _need_card()
    shape = (2, 2, s, dh)
    q, k, v, do, mask = _card_inputs(shape, s * dh)
    bias = port_attn.key_bias(mask, 2, s, q.device)
    got = port_attn.flash_attention_forward(q, k, v, mask, True)
    again = port_attn.flash_attention_forward(q, k, v, mask, True)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert_bf16_close(
        got[0], port_attn.attention_reference(q, k, v, bias, True), "O")
    want = port_attn.attention_reference_backward(q, k, v, bias, got[0], do,
                                                  True)
    for name, g, w in zip(("dq", "dk", "dv"),
                          _kernel_grads(q, k, v, do, mask, True), want):
        assert_bf16_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((256, 8, 50, 32), False), ((64, 8, 500, 32), False),
    ((1, 2, 4096, 64), False), ((1, 2, 4096, 64), True),
    ((2, 2, 129, 128), True), ((2, 4, 650, 32), True)])
def test_bf16_backward_is_bitwise_repeatable_on_card(shape, causal):
    """dq, dk and dv of two calls on the same inputs are bitwise equal (no
    atomics; every sum in a fixed order), and the launch counters move by
    one per kernel per call."""
    _need_card()
    q, k, v, do, mask = _card_inputs(shape, len(shape) + shape[2])
    o, _, m, l = port_attn._forward(q, k, v, mask, causal)
    runs = []
    for _ in range(2):
        before = (port_attn.BF16_DQ_LAUNCHES, port_attn.BF16_DKV_LAUNCHES)
        runs.append(port_attn.flash_attention_backward(q, k, v, mask, o, m, l,
                                                       do, causal))
        assert (port_attn.BF16_DQ_LAUNCHES, port_attn.BF16_DKV_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(x, y), f"{name} differs between two calls"
