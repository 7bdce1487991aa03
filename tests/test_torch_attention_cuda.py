"""The float32 attention kernels on the card: forward (O and lse within
2e-5 abs + 2e-5 rel) and backward (dq, dk and dv within 1e-4 abs + 1e-4
rel) against their plain versions, the tile edges, persistent streams of
items, bitwise repeatability, and the tensor maps of both encoded on a
thread with no CUDA context.
Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_attention_cuda.py

Every test skips without a CUDA device (the kernels have no CPU mode)."""

import threading

import pytest
import torch

from flexdm_tpu_torch.ops import attention as port_attn

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def _card_inputs(shape, seed):
    """q, k, v, dO (float32) and a key mask that keeps key 0 in every row
    but masks the whole last batch row."""
    b, _, s, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).cuda() for _ in range(4))
    mask = torch.rand(b, s, generator=g) > 0.3
    mask[:, 0] = True
    mask[-1] = False
    return q, k, v, do, mask.cuda()


def _check_forward(shape, causal, seed):
    q, k, v, _, mask = _card_inputs(shape, seed)
    b, _, s, _ = shape
    before = port_attn.KERNEL_LAUNCHES
    got = port_attn.flash_attention_forward(q, k, v, mask, causal)
    again = port_attn.flash_attention_forward(q, k, v, mask, causal)
    assert port_attn.KERNEL_LAUNCHES == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bias = port_attn.key_bias(mask, b, s, q.device)
    torch.testing.assert_close(
        got[0], port_attn.attention_reference(q, k, v, bias, causal),
        **FWD_TOL)
    torch.testing.assert_close(
        got[1], port_attn.attention_reference_lse(q, k, bias, causal),
        **FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 50, 32), (256, 8, 50, 32),
                                   (2, 4, 650, 32), (2, 4, 512, 64),
                                   (2, 2, 100, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_forward_matches_plain_on_card(shape, causal):
    """O and lse within 2e-5 of the plain version, a fully masked row
    included; a second call bitwise equal."""
    _need_card()
    _check_forward(shape, causal, sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 16, 17, 63, 64, 65, 128, 129])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_f32_forward_tile_edges_on_card(s, dh):
    """The forward's tile edges (64-row query tiles; 64-key K/V tiles, 32
    at Dh=128), causal."""
    _need_card()
    _check_forward((2, 2, s, dh), True, s * dh)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [15, 31, 32, 33, 95, 97])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_forward_key_tile_edges_on_card(s, dh, causal):
    """The forward's key tiles (64 keys at Dh=32, 32 at Dh=64, 16 at
    Dh=128): a last tile of one key, a full one, one short of full; a fully
    masked row."""
    _need_card()
    _check_forward((2, 2, s, dh), causal, s + dh)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((33, 8, 70, 32), False), ((33, 8, 70, 32), True),
    ((17, 16, 130, 64), True), ((9, 8, 130, 128), False),
    ((2, 4, 130, 32), True), ((1, 1, 4096, 32), False)])
def test_f32_forward_streams_on_card(shape, causal):
    """Items (64 query rows of a head) outnumbering the SMs, two streams a
    block at Dh <= 64 with uneven counts and one at Dh = 128, each block
    running several items; and fewer items than SMs (one stream, one item
    a block, S = 4096 a long one)."""
    _need_card()
    _check_forward(shape, causal, sum(shape))


@pytest.mark.cuda
def test_f32_forward_launches_from_a_thread_without_a_context_on_card():
    """The serving engine runs forwards off the main thread: a thread that
    has made no CUDA runtime call of its own has no current context, and
    the forward's tensor maps need one.  The forward from a new thread
    equals the calling thread's, bitwise."""
    _need_card()
    q, k, v, _, mask = _card_inputs((4, 8, 100, 32), 11)
    want = port_attn._forward(q, k, v, mask, False)
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = port_attn._forward(q, k, v, mask, False)
            torch.cuda.synchronize()
        except Exception as e:  # re-raised below, in the test's thread
            out["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "err" not in out, out.get("err")
    for x, y in zip(out["got"], want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((256, 8, 50, 32), False), ((8, 8, 51, 32), True),
    ((2, 4, 512, 64), False), ((2, 4, 650, 32), True),
    ((2, 2, 128, 128), False), ((2, 2, 65, 64), True),
    ((2, 2, 129, 128), True), ((1, 2, 4096, 64), False)])
def test_f32_backward_matches_plain_on_card(shape, causal):
    """dq, dk and dv through autograd within 1e-4 of the plain backward
    (S=4096, the TPU's stream kernels' regime, included); two calls
    bitwise equal; each backward kernel launched once a call."""
    _need_card()
    _check_backward(shape, causal, len(shape) + shape[2])


def _check_backward(shape, causal, seed):
    q, k, v, do, mask = _card_inputs(shape, seed)
    b, _, s, _ = shape
    leaves = [t.requires_grad_() for t in (q, k, v)]
    runs = []
    for _ in range(2):
        before = (port_attn.BWD_DQ_LAUNCHES, port_attn.BWD_DKV_LAUNCHES)
        runs.append(torch.autograd.grad(
            port_attn.dot_product_attention(*leaves, mask, causal), leaves,
            do))
        assert (port_attn.BWD_DQ_LAUNCHES, port_attn.BWD_DKV_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    bias = port_attn.key_bias(mask, b, s, q.device)
    q, k, v = (t.detach() for t in leaves)
    ref_o = port_attn.attention_reference(q, k, v, bias, causal)
    want = port_attn.attention_reference_backward(q, k, v, bias, ref_o, do,
                                                  causal)
    for name, g, w in zip(("dq", "dk", "dv"), runs[0], want):
        torch.testing.assert_close(g, w, **BWD_TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [15, 16, 17, 31, 32, 33, 97])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_f32_backward_tile_edges_on_card(s, dh):
    """The backward's tile edges, causal, a fully masked row: tiles of the
    other axis of 32 rows or keys (16 at Dh=128), items of 64."""
    _need_card()
    _check_backward((2, 2, s, dh), True, s * dh)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [
    ((33, 8, 70, 32), True), ((33, 8, 70, 32), False),
    ((17, 16, 130, 64), True)])
def test_f32_backward_streams_on_card(shape, causal):
    """Enough items for two streams a block (at least two per SM), of
    uneven counts, causal dq items of uneven lengths: the streams' turns
    on the tensor cores balance and every item is written."""
    _need_card()
    _check_backward(shape, causal, sum(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_f32_dq_two_streams_repeat_bitwise_on_card(causal):
    """The two-stream dq instances at Dh 32 (Q and dO held as register
    fragments, their tiles refilled by TMA behind a proxy fence) in
    autograd's order, forward, dq, dk/dv, 3000 times: every dq and delta
    bitwise equal to the first call's.  Without the fence 2 (non-causal)
    and 20 (causal) of 60000 calls wrote wrong rows on an H100
    (tools/torch_kernel_repeats.py)."""
    _need_card()
    shape = (33, 8, 70, 32)
    q, k, v, do, mask = _card_inputs(shape, 21)
    o, _, m, l = port_attn._forward(q, k, v, mask, causal)

    def dq_call():
        port_attn._forward(q, k, v, mask, causal)
        dq, delta = port_attn._backward_dq(q, k, v, mask, o, m, l, do,
                                           causal, shape[3])
        port_attn._backward_dkv(q, k, v, mask, m, l, delta, do, causal,
                                shape[3])
        return dq, delta

    first = dq_call()
    differ = [i for i in range(3000)
              if not all(torch.equal(x, y) for x, y in zip(dq_call(), first))]
    assert differ == []


@pytest.mark.cuda
def test_f32_backward_launches_from_a_thread_without_a_context_on_card():
    """A thread that has made no CUDA runtime call of its own has no
    current context, and the backward kernels' tensor maps need one (their
    encode fails without it).  The backward from a new thread whose
    outputs come from the caching allocator equals the calling thread's."""
    _need_card()
    q, k, v, do, mask = _card_inputs((2, 2, 130, 32), 7)
    o, _, m, l = port_attn._forward(q, k, v, mask, False)

    def backward():
        return port_attn.flash_attention_backward(q, k, v, mask, o, m, l, do)

    want = backward()
    del_me = backward()  # freed: the thread's outputs reuse its blocks
    del del_me
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = backward()
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
def test_f32_kernels_refuse_unaligned_rows_on_card():
    """The kernels copy rows 16 bytes at a time: a tensor that does not
    start on a 16-byte boundary raises, and nothing is launched."""
    _need_card()
    q = torch.zeros(1 + 2 * 4 * 32, device="cuda")[1:].view(1, 2, 4, 32)
    stats = torch.ones(1, 2, 4, device="cuda")
    counts = port_attn.launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        port_attn.flash_attention_forward(q, q, q)
    with pytest.raises(ValueError, match="16-byte"):
        port_attn.flash_attention_backward(q, q, q, None, q, stats, stats, q)
    aligned = torch.zeros(1, 2, 4, 32, device="cuda")
    for args in ((aligned, q, aligned), (aligned, aligned, q)):
        with pytest.raises(ValueError, match="16-byte"):
            port_attn.flash_attention_forward(*args)
    assert port_attn.launch_counts() == counts


# Head dims below the tile widths: 8, 16, 20, 25 on the 32-wide tiles (25
# through a padded copy of 28), 48 on 64, 96 and 120 on 128 (96 leaves a
# column block wholly past the row, zero-filled by TMA).
HEAD_DIMS = (8, 16, 20, 25, 48, 96, 120)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("shape", [(8, 8, 50), (2, 4, 500)])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_kernels_at_every_head_dim_on_card(dh, shape, causal):
    """O and lse within 2e-5, dq, dk and dv within 1e-4 of the plain
    versions at a head dim below the tile width, each call launched once
    and bitwise equal on a repeat."""
    _need_card()
    _check_forward(shape + (dh,), causal, dh + shape[2])
    _check_backward(shape + (dh,), causal, dh + shape[2] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [20, 48])
def test_f32_backward_streams_at_head_dims_on_card(dh):
    """Two streams a block (more items than SMs) on the 32- and 64-wide
    tiles at a head dim below their width."""
    _need_card()
    _check_backward((33, 8, 70, dh), False, dh)


# Head dims above 128: the wide kernels (csrc/flash_attention_wide.cu; the
# float32 backward csrc/flash_attention_bwd_wide.cu).
# 129 through a copy padded to 132, 136, 160 and 264 a column block partly
# past the row, 256 and 512 whole column blocks.
WIDE_HEAD_DIMS = (129, 136, 160, 256, 264, 512)


def check_wide(shape, causal, dtype, seed, close):
    """Forward and backward of the wide kernels at ``shape`` in ``dtype``
    through autograd: each kernel launched once a call and no other, two
    calls bitwise equal, O, lse, dq, dk and dv held to the plain versions
    (the backward's of the kernels' O) by ``close(got, want, name)``.  The
    key mask drops the last fifth of the keys and masks the whole last
    batch row where B > 1.  (Shared with
    tests/test_torch_attention_bf16_cuda.py.)"""
    b, _, s, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", dtype)
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    if b > 1:
        mask[-1] = False
    mask = mask.cuda()
    bf16 = "_bf16" * (dtype == torch.bfloat16)
    runs = []
    for _ in range(2):
        port_attn.reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = port_attn.dot_product_attention(*leaves, mask, causal)
        runs.append((o.detach(),) + torch.autograd.grad(o, leaves, do))
        counts = port_attn.launch_counts()
        assert counts == {n: int(n in (f"fwd_wide{bf16}", f"dq_wide{bf16}",
                                       f"dkv_wide{bf16}"))
                          for n in counts}, counts
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    bias = port_attn.key_bias(mask, b, s, q.device)
    # The plain backward of the kernels' own O (their delta's), as the
    # other card tests hold the backward kernels.
    want = (port_attn.attention_reference(q, k, v, bias, causal),
            ) + port_attn.attention_reference_backward(
        q, k, v, bias, runs[0][0], do, causal)
    for name, got, w in zip(("O", "dq", "dk", "dv"), runs[0], want):
        close(got, w, name)
    _, lse = port_attn.flash_attention_forward(q, k, v, mask, causal)
    torch.testing.assert_close(
        lse, port_attn.attention_reference_lse(q, k, bias, causal),
        **FWD_TOL)


def _f32_close(got, want, name):
    torch.testing.assert_close(got, want, msg=name,
                               **(FWD_TOL if name == "O" else BWD_TOL))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("shape", [(8, 8, 50), (2, 4, 500)])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_wide_kernels_at_head_dims_above_128_on_card(dh, shape, causal):
    """Dh above 128 runs on the wide kernels, where JAX runs it: O and lse
    within 2e-5, dq, dk and dv within 1e-4 of the plain versions."""
    _need_card()
    check_wide(shape + (dh,), causal, torch.float32, dh + shape[2],
               _f32_close)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_f32_wide_kernels_at_s_4096_on_card(causal):
    """The regime of the TPU's stream kernels, at Dh 256: one wide dq and
    one wide dk/dv kernel cover it."""
    _need_card()
    check_wide((1, 2, 4096, 256), causal, torch.float32, 4096, _f32_close)


# The float32 wide backward (csrc/flash_attention_bwd_wide.cu): persistent
# blocks, one an SM, each taking items (64 rows and a column block of the
# outputs) in turn.  (33, 8, 70): 528 dq items and 1056 (Dh 256) dk/dv
# items, more than the SMs; (2, 2, 70): 8 and 16, fewer.  Dh 136 and 264
# end in a chunk partly past the row (and 264 in a column block of 8).
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 8, 70), (2, 2, 70)])
@pytest.mark.parametrize("dh", [136, 256, 264])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_wide_backward_items_and_sms_on_card(shape, dh, causal):
    """dq, dk and dv within 1e-4 of the plain backward, each kernel
    launched once a call, a second call bitwise equal, whether the items
    outnumber the SMs or not."""
    _need_card()
    check_wide(shape + (dh,), causal, torch.float32, dh + shape[0],
               _f32_close)


def check_wide_forward(shape, causal, dtype, seed, close):
    """The wide forward alone at ``shape`` in ``dtype``: launched once a
    call and no other kernel, a second call bitwise equal, O held to the
    plain version by ``close(got, want, "O")`` and lse within 2e-5.  The
    key mask drops the last fifth of the keys and masks the whole last
    batch row where B > 1.  (Shared with
    tests/test_torch_attention_bf16_cuda.py.)"""
    b, _, s, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to("cuda", dtype)
               for _ in range(3))
    mask = torch.ones(b, s, dtype=torch.bool)
    mask[:, s - s // 5:] = False
    if b > 1:
        mask[-1] = False
    mask = mask.cuda()
    port_attn.reset_launch_counts()
    got = port_attn._forward(q, k, v, mask, causal)
    again = port_attn._forward(q, k, v, mask, causal)
    counts = port_attn.launch_counts()
    name = "fwd_wide" + "_bf16" * (dtype == torch.bfloat16)
    assert counts == {n: 2 * (n == name) for n in counts}, counts
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bias = port_attn.key_bias(mask, b, s, q.device)
    close(got[0], port_attn.attention_reference(q, k, v, bias, causal), "O")
    torch.testing.assert_close(
        got[1], port_attn.attention_reference_lse(q, k, bias, causal),
        **FWD_TOL)


# The wide forward (csrc/flash_attention_fwd_wide.cu): persistent blocks,
# one an SM, each taking items (64 query rows and a 256-column block of O)
# in turn.  (33, 8, 70): 528 items at Dh 136 and 256, 1056 at 264 (two
# column blocks), more than the SMs; (2, 2, 70): 8 and 16, fewer.  Dh 136
# and 264 end in a chunk partly past the row, 264 in a column block of 8.
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 8, 70), (2, 2, 70)])
@pytest.mark.parametrize("dh", [136, 256, 264])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_wide_forward_items_and_sms_on_card(shape, dh, causal):
    """O and lse within 2e-5 of the plain versions, one launch a call, a
    second call bitwise equal, whether the items outnumber the SMs or
    not."""
    _need_card()
    check_wide_forward(shape + (dh,), causal, torch.float32, dh + shape[0],
                       _f32_close)


@pytest.mark.cuda
def test_f32_wide_backward_launches_from_a_thread_without_a_context_on_card():
    """The wide backward's tensor maps need a current context too: from a
    new thread (its outputs from the caching allocator) it equals the
    calling thread's, bitwise."""
    _need_card()
    q, k, v, do, mask = _card_inputs((2, 2, 130, 256), 13)
    o, _, m, l = port_attn._forward(q, k, v, mask, False)

    def backward():
        return port_attn.flash_attention_backward(q, k, v, mask, o, m, l, do)

    before = port_attn.launch_counts()
    want = backward()
    after = port_attn.launch_counts()
    assert (after["dq_wide"] - before["dq_wide"],
            after["dkv_wide"] - before["dkv_wide"]) == (1, 1)
    del_me = backward()  # freed: the thread's outputs reuse its blocks
    del del_me
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = backward()
            torch.cuda.synchronize()
        except Exception as e:  # re-raised below, in the test's thread
            out["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "err" not in out, out.get("err")
    for x, y in zip(out["got"], want):
        assert torch.equal(x, y)
