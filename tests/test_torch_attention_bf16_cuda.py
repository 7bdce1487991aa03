"""The bf16 attention kernels on the card: forward and backward against
their plain bf16 versions, the tile edges (the forward's 64-row blocks and
its ring of K/V stages), and bitwise repeatability.  Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_bf16_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode)."""

import threading

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


def _check_forward_and_backward(shape, causal, q, k, v, do, mask):
    """O within the card's bar and lse within 2e-5 of the plain versions, a
    second forward call bitwise equal, and the backward kernels, fed the
    forward's m and l, within the bar."""
    b, _, s, _ = shape
    got = port_attn._forward(q, k, v, mask, causal)
    again = port_attn._forward(q, k, v, mask, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    o, lse, m, l = got
    bias = port_attn.key_bias(mask, b, s, q.device)
    assert_bf16_close(o, port_attn.attention_reference(q, k, v, bias, causal),
                      "O")
    torch.testing.assert_close(
        lse, port_attn.attention_reference_lse(q, k, bias, causal), **LSE_TOL)
    want = port_attn.attention_reference_backward(q, k, v, bias, o, do, causal)
    got = port_attn.flash_attention_backward(q, k, v, mask, o, m, l, do,
                                             causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if s == 1 and name != "dv":
            # A softmax over one key is constant: dq and dk are 0, and
            # both sides hold only the float32 rounding of dO v - delta.
            torch.testing.assert_close(g.float(), torch.zeros_like(w.float()),
                                       rtol=0, atol=1e-5)
        else:
            assert_bf16_close(g, w, name)
    return o


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 191, 192, 193])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_ring_edges_on_card(s, dh, causal):
    """S = 1 and one, two and three 64-key stages of the forward's ring,
    each +- 1 key (the ring has 3 stages, 2 at Dh=128, so 129 and up wrap
    it), with a fully masked row."""
    _need_card()
    shape = (2, 2, s, dh)
    _check_forward_and_backward(shape, causal,
                                *_card_inputs(shape, s + dh + causal))


@pytest.mark.cuda
def test_bf16_forward_at_crello_scaled_width_on_card():
    """configs/crello_scaled.json's attention: D=512 over 8 heads of 64, at
    batch 2048, S=50, the last fifth of the keys masked."""
    _need_card()
    shape = (2048, 8, 50, 64)
    q, k, v, do, _ = _card_inputs(shape, 64)
    mask = torch.ones(2048, 50, dtype=torch.bool)
    mask[:, 40:] = False
    _check_forward_and_backward(shape, False, q, k, v, do, mask.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 128])
def test_bf16_causal_row_with_every_in_band_key_masked_on_card(dh):
    """The causal band is replaced by the finite -1e9, not skipped: rows
    0 .. 69 of the first batch row, whose in-band keys are all masked, tie
    with their out-of-band keys and average V over all S = 130 keys."""
    _need_card()
    shape = (2, 2, 130, dh)
    q, k, v, do, _ = _card_inputs(shape, dh)
    mask = torch.ones(2, 130, dtype=torch.bool)
    mask[0, :70] = False
    o = _check_forward_and_backward(shape, True, q, k, v, do, mask.cuda())
    mean_v = v[0].float().mean(1, keepdim=True).expand(2, 70, dh)
    assert_bf16_close(o[0, :, :70], mean_v, "O of the masked rows")


@pytest.mark.cuda
def test_bf16_kernels_launch_from_a_thread_without_a_context_on_card():
    """A thread that has made no CUDA runtime call of its own has no
    current context, and the kernels' tensor maps need one (their encode
    fails without it).  Forward and backward from a new thread whose
    outputs come from the caching allocator equal the calling thread's."""
    _need_card()
    q, k, v, do, mask = _card_inputs((2, 2, 130, 32), 7)

    def both():
        o, lse, m, l = port_attn._forward(q, k, v, mask, False)
        return (o, lse) + port_attn.flash_attention_backward(
            q, k, v, mask, o, m, l, do)

    want = both()
    del_me = both()  # freed: the thread's outputs reuse its blocks
    del del_me
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = both()
            torch.cuda.synchronize()
        except Exception as e:  # re-raised below, in the test's thread
            out["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "err" not in out, out.get("err")
    for x, y in zip(out["got"], want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16, 20, 25, 48, 96, 120])
@pytest.mark.parametrize("shape", [(8, 8, 50), (2, 4, 500)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernels_at_every_head_dim_on_card(dh, shape, causal):
    """Head dims below the tile widths (20 and 25 through padded copies of
    24 and 32): O, lse, dq, dk and dv within their bars, the forward
    bitwise equal on a repeat, through autograd too."""
    _need_card()
    shape = shape + (dh,)
    q, k, v, do, mask = _card_inputs(shape, dh + shape[2] + causal)
    _check_forward_and_backward(shape, causal, q, k, v, do, mask)
    got, again = (_kernel_grads(q, k, v, do, mask, causal) for _ in range(2))
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def _bf16_close(got, want, name):
    """The card's bf16 bar, in the kernels' dtype."""
    assert got.dtype == torch.bfloat16, name
    assert_bf16_close(got, want, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [129, 136, 160, 256, 264, 512])
@pytest.mark.parametrize("shape", [(8, 8, 50), (2, 4, 500)])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_wide_kernels_at_head_dims_above_128_on_card(dh, shape, causal):
    """The bf16 wide instances (Dh 129 through a copy padded to 136): O,
    dq, dk and dv within one bf16 ulp + 2^-8 max|ref|, lse within 2e-5,
    each kernel launched once a call, two calls bitwise equal."""
    _need_card()
    from test_torch_attention_cuda import check_wide

    check_wide(shape + (dh,), causal, torch.bfloat16, dh + shape[2] + 1,
               _bf16_close)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_wide_kernels_at_s_4096_on_card(causal):
    _need_card()
    from test_torch_attention_cuda import check_wide

    check_wide((1, 2, 4096, 256), causal, torch.bfloat16, 4097, _bf16_close)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 8, 70), (2, 2, 70)])
@pytest.mark.parametrize("dh", [136, 256, 264])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_wide_forward_items_and_sms_on_card(shape, dh, causal):
    """The bf16 wide forward (csrc/flash_attention_fwd_wide.cu) with more
    items than SMs and fewer (as the float32 test): O within the bf16 bar,
    lse within 2e-5, one launch a call, a second call bitwise equal."""
    _need_card()
    from test_torch_attention_cuda import check_wide_forward

    check_wide_forward(shape + (dh,), causal, torch.bfloat16,
                       dh + shape[0] + 1, _bf16_close)
