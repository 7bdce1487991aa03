"""The float32 attention kernels' arithmetic (``csrc/flash_attention_fwd.cu``
and ``csrc/flash_attention_bwd.cu`` on ``csrc/wgmma_tf32.cuh``) emulated on
the CPU on the kernels' own tile layouts.

The layouts are mirrored from ``wgmma_tf32.cuh``: a tile as TMA writes it
(``F32Tile``, 128-byte swizzle), its split into hi = tf32(x) and
lo = x - hi, the transposed tiles the splitters write (``TransposedTile``,
rows at ``acc_order`` positions, 16-byte stores of 4 rows by 4 columns), and
the A operand a product takes from another's accumulators without moving
them.  ``wgmma`` reads its shared-memory operands through the K-major
canonical layouts of the PTX ISA (modelled below: byte addresses, then the
128-byte swizzle on address bits 4-6 from bits 7-9).  Every product is three
TF32 products (lo hi' + hi lo' + hi hi', the small terms of all k8 steps
first) whose lo terms the tensor cores read to 19 bits (truncated here, the
worse of truncation and rounding), summed in float32; each tile's second
product (the forward's P V, the backward's ds k, p^T dO, ds^T q) is summed
from zero and added to the running sum, as the kernels do.  The forward's
scores are in log2 units, its online softmax over tiles of 64 keys at
Dh = 32 (32 at Dh = 64, 16 at Dh = 128), P V one product of up to 32 keys
at a time.

A head dim below the tile width runs on the width's tiles with its columns
past the head dim zero (TMA's fill) and the scale of the head dim: held to
the plain versions at Dh 16 and 48 on tiles 32 and 64 wide, and shown to
fail with the scale of the width.

Held to the plain versions within ``KERNEL_TOL`` (the forward's O and lse,
2e-5 abs + 2e-5 rel) and ``CARD_TOL`` (dq, dk, dv, 1e-4 abs + 1e-4 rel), the
bars of ``chip_smoke.py``, and shown to fail them when the transposed tiles
keep the rows in their own order (the permutation of the accumulator-made A
operand not matched) or are not transposed at all.  The forward's emulation
also meets the JAX package's Pallas forward (interpret mode).  The tensor
cores' own float32 summation order and rounding are not emulated."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdm_tpu.ops import attention as jax_attn
from flexdm_tpu_torch.ops import attention as port_attn

CARD_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
TILE = 64  # rows or keys of an item: the wgmma M


# ---------------------------------------------------------------------------
# Layouts (wgmma_tf32.cuh), in bytes
# ---------------------------------------------------------------------------

def other_rows(dh):
    """Keys per K/V tile (dq) and rows per Q/dO tile (dk/dv)."""
    return 16 if dh == 128 else 32


def fwd_keys(dh):
    """Keys per K/V tile of the forward (fwd_keys in the kernel)."""
    return 64 if dh == 32 else other_rows(dh)


def f32_offset(r, c, rows):
    """F32Tile<DH, ROWS>::offset: 32-float column blocks of 128-byte rows,
    chunk c of row r at chunk c ^ (r % 8)."""
    return c // 32 * rows * 128 + r * 128 + ((c % 32 // 4) ^ (r % 8)) * 16 \
        + c % 4 * 4


def tt_offset(n, k, kdim):
    """TransposedTile<N, K>::offset: 8-row by 16-byte core matrices, LBO 128
    along k, SBO 32 K along n."""
    return n // 8 * 32 * kdim + k // 4 * 128 + n % 8 * 16 + k % 4 * 4


def acc_order(r):
    """The k position of source row r in a transposed tile."""
    return 8 * (r // 8) + 4 * (r % 2) + r % 8 // 2


def split_units(rows, dh, threads):
    """(first row, first column) of each unit of split_tile, in the order
    its THREADS threads take them: rows r0 + 2 m (m < 4), columns c .. c+3."""
    units = rows * dh // 16
    out = []
    for tid in range(threads):
        for n in range((units + threads - 1) // threads):
            u = tid + threads * n
            if u >= units:
                break
            rest = u // 16
            out.append((8 * (rest % (rows // 8)) + u // 8 % 2,
                        4 * (rest // (rows // 8) * 8 + u % 8)))
    return out


# ---------------------------------------------------------------------------
# What wgmma reads (PTX ISA, K-major canonical layouts), as float indices
# ---------------------------------------------------------------------------

def swizzle128(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def read_b128(start, n):
    """(8, n) float indices of a k8 step read K-major from a 128-byte
    swizzled tile (SBO 1024) starting at byte ``start``: [k, n]."""
    kk, nn = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    addr = start + nn // 8 * 1024 + nn % 8 * 128 + kk * 4
    return swizzle128(addr) // 4


def read_interleave(start, lbo, sbo, n):
    """(8, n) float indices of a k8 step read K-major from an unswizzled
    tile: core matrices of 8 rows by 16 bytes, LBO along k, SBO along n."""
    kk, nn = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    addr = start + nn // 8 * sbo + nn % 8 * 16 + kk // 4 * lbo + kk % 4 * 4
    return addr // 4


def a_from_acc_columns(j):
    """The accumulator column each k of an m64nNk8 A fragment made from n8
    block j holds: a0..a3 = d[4j], d[4j+2], d[4j+1], d[4j+3] puts accumulator
    column 2t at k = t and 2t + 1 at k = t + 4 (thread 4 g + t)."""
    cols = np.zeros(8, np.int64)
    for t in range(4):
        for i, e in enumerate((0, 2, 1, 3)):
            cols[t + 4 * (i >> 1)] = 8 * j + 2 * t + (e & 1)
    return cols


class TileLayout:
    """Index maps of one (rows, dh) tile kind."""

    def __init__(self, rows, dh, threads, order=acc_order):
        self.rows, self.dh = rows, dh
        rr, cc = np.meshgrid(np.arange(rows), np.arange(dh), indexing="ij")
        # TMA: element (r, c) at float f32_offset // 4.
        self.tma = torch.from_numpy(f32_offset(rr, cc, rows).reshape(-1) // 4)
        # The splitters' transposed stores, unit by unit: element (r, c) at
        # TransposedTile offset (c, order(r)); every element exactly once.
        # (Another order, for the mutation case, element by element.)
        dest = np.full((rows, dh), -1, np.int64)
        if order is acc_order:
            for r0, c in split_units(rows, dh, threads):
                assert order(r0) % 4 == 0
                for m in range(4):
                    assert order(r0 + 2 * m) == order(r0) + m
                    for e in range(4):
                        assert dest[r0 + 2 * m, c + e] == -1
                        dest[r0 + 2 * m, c + e] = tt_offset(
                            c + e, order(r0) + m, rows) // 4
        else:
            dest = tt_offset(cc, order(rr), rows) // 4
        assert (dest >= 0).all()
        self.transposed = torch.from_numpy(dest.reshape(-1))

    def landed(self, x):
        """(..., rows, dh) -> the tile buffer TMA writes (..., rows*dh)."""
        buf = torch.empty(x.shape[:-2] + (self.rows * self.dh,),
                          dtype=x.dtype)
        buf[..., self.tma] = x.reshape(x.shape[:-2] + (-1,))
        return buf

    def transpose(self, buf):
        """The transposed tile the splitters write from a landed buffer."""
        out = torch.empty_like(buf)
        out[..., self.transposed] = buf[..., self.tma]
        return out

    def k_major(self, buf, ks):
        """B (..., 8, rows) of the k8 step ks read K-major from the tile."""
        start = ks // 4 * self.rows * 128 + ks % 4 * 32
        return buf[..., torch.from_numpy(read_b128(start, self.rows))]

    def own_fragments(self, buf, ks):
        """A (..., 64, 8) the consumer loads from an own tile as register
        fragments: thread (w, g, t) element i is (16w + g + 8 (i & 1),
        8 ks + t + 4 (i >> 1))."""
        rr, kk = np.meshgrid(np.arange(self.rows), np.arange(8),
                             indexing="ij")
        return buf[..., torch.from_numpy(f32_offset(rr, 8 * ks + kk,
                                                    self.rows) // 4)]

    def own_k_major(self, buf, ks):
        """A (..., 64, 8) read K-major from an own tile in shared memory
        (the same 128-byte swizzled layout, M = its 64 rows)."""
        return self.k_major(buf, ks).transpose(-1, -2)

    def t_k_major(self, tbuf, c0, j, cols):
        """B (..., 8, cols) of k8 step j, columns c0.., read K-major from
        the transposed tile."""
        start = c0 // 8 * 32 * self.rows + 256 * j
        return tbuf[..., torch.from_numpy(
            read_interleave(start, 128, 32 * self.rows, cols))]


# ---------------------------------------------------------------------------
# The split and the products
# ---------------------------------------------------------------------------

def tf32_round(x):
    """hi: round to nearest (ties away) on the low 13 bits, bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What the tensor cores read of a float32 word: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """(hi, lo as read): x = hi + lo exactly, lo read to 19 bits."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x - hi)


def products(steps):
    """The sum of a b over the k8 steps ``(a, b)`` as the kernels chain it:
    every step's small terms (lo hi', hi lo') first, then the large ones
    (hi hi'), float32 sums."""
    split_steps = [(split(a), split(b)) for a, b in steps]
    d = 0
    for (ah, al), (bh, bl) in split_steps:
        d = d + al @ bh + ah @ bl
    for (ah, _), (bh, _) in split_steps:
        d = d + ah @ bh
    return d


def score_product(own, own_layout, other, layout, in_regs):
    """(..., 64, rows) = own other^T over dh, both landed tiles: the own
    operand from register fragments (Dh = 32) or read K-major from shared
    memory, the other read K-major, k8 step by k8 step."""
    return products(
        [(own_layout.own_fragments(own, ks) if in_regs
          else own_layout.own_k_major(own, ks), layout.k_major(other, ks))
         for ks in range(layout.dh // 8)])


def second_product(acc, p, tile_buf, layout, j0=0, steps=None):
    """acc + p T: p (..., 64, K) accumulators as A fragments, T the
    transposed tile of the (K, dh) landed tile, its k8 steps j0 ..
    j0 + steps (all by default); 32 columns a chunk, each summed from zero
    and added in float32."""
    t = layout.transpose(tile_buf)
    out = acc.clone()
    steps = layout.rows // 8 if steps is None else steps
    for c0 in range(0, layout.dh, 32):
        out[..., c0:c0 + 32] += products(
            [(p[..., torch.from_numpy(a_from_acc_columns(j))],
              layout.t_k_major(t, c0, j, 32))
             for j in range(j0, j0 + steps)])
    return out


# ---------------------------------------------------------------------------
# The backward, item by item and tile by tile as the kernels run it
# ---------------------------------------------------------------------------

def _pad(x, s):
    return torch.nn.functional.pad(x, (0, 0, 0, s - x.shape[-2]))


def _pad_cols(x, width):
    """``x`` with its columns zero-filled to ``width`` (TMA's fill of a
    tile wider than the head dim)."""
    if width is None:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def emulate_backward(q, k, v, key_mask, o, do, m, l, causal,
                     order=acc_order, transposed=True, width=None,
                     scale_dim=None):
    """(dq, dk, dv) of the kernels' arithmetic on their layouts.  ``order``
    and ``transposed`` can break the transposed tiles (mutation cases).
    ``width``: the tile width the head dim runs on (default the head dim),
    its columns past the head dim zero as TMA fills them; ``scale_dim``: the
    dim of the softmax scale (default the head dim; the width is the
    mutation case)."""
    head_dim = q.shape[-1]
    scale = 1.0 / math.sqrt(scale_dim or head_dim)
    q, k, v, o, do = (_pad_cols(x, width) for x in (q, k, v, o, do))
    b, h, s, dh = q.shape
    bo = other_rows(dh)
    c1 = np.float32(scale * np.float32(1.4426950408889634))
    log2e = np.float32(1.4426950408889634)
    masked2 = np.float32(np.float32(-1e9) * log2e)
    sp = -(-s // TILE) * TILE  # padded to whole items and tiles
    qp, kp, vp, dop, op = (_pad(x, sp) for x in (q, k, v, do, o))
    valid = torch.arange(sp) < s
    bias2 = torch.full((b, sp), float(masked2))
    bias2[:, :s] = torch.where(key_mask, 0.0, float(masked2)) \
        if key_mask is not None else 0.0
    m2 = torch.zeros(b, h, sp)
    m2[..., :s] = m * log2e
    inv_l = torch.zeros(b, h, sp)
    inv_l[..., :s] = 1.0 / l
    delta = (dop * op).sum(-1)
    own = TileLayout(TILE, dh, 128)
    tiles = TileLayout(bo, dh, 128)
    if not transposed:
        tiles.transposed = tiles.tma  # the landed tile read as if transposed
    elif order is not acc_order:
        tiles = TileLayout(bo, dh, 128, order)
    rows = torch.arange(sp)

    def items(x):  # (b, h, sp, dh) -> (b, h, items, 64, dh) landed buffers
        return x.reshape(b, h, sp // TILE, TILE, dh)

    # dq: per item (64 rows), per K/V tile.
    qi, doi = items(qp), items(dop)
    q_buf, do_buf = own.landed(qi), own.landed(doi)
    dq = torch.zeros(b, h, sp // TILE, TILE, dh)
    row = rows.reshape(sp // TILE, TILE, 1)
    for j in range(sp // bo):
        key = torch.arange(j * bo, (j + 1) * bo)
        kt = kp[:, :, None, j * bo:(j + 1) * bo]
        vt = vp[:, :, None, j * bo:(j + 1) * bo]
        k_buf, v_buf = tiles.landed(kt), tiles.landed(vt)
        sc = score_product(q_buf, own, k_buf, tiles, dh == 32)
        dp = score_product(do_buf, own, v_buf, tiles, dh == 32)
        replaced = causal & (key > row)
        x = torch.where(replaced, float(masked2),
                        sc * c1 + bias2[:, None, None, None, key])
        mi = m2.reshape(b, h, sp // TILE, TILE, 1)
        p = torch.exp2(x - mi) * inv_l.reshape(b, h, sp // TILE, TILE, 1)
        p = torch.where(valid[key], p, 0.0)
        ds = torch.where(replaced, 0.0,
                         p * (dp - delta.reshape(b, h, sp // TILE, TILE, 1)))
        dq = second_product(dq, ds, k_buf, tiles)
    dq = (dq * scale).reshape(b, h, sp, dh)[..., :s, :]

    # dk, dv: per item (64 keys), per Q/dO tile.
    k_buf, v_buf = own.landed(items(kp)), own.landed(items(vp))
    dk = torch.zeros(b, h, sp // TILE, TILE, dh)
    dv = torch.zeros_like(dk)
    key = rows.reshape(sp // TILE, TILE, 1)
    kbias = bias2.reshape(b, 1, sp // TILE, TILE, 1)
    for j in range(sp // bo):
        r = torch.arange(j * bo, (j + 1) * bo)
        q_t = tiles.landed(qp[:, :, None, j * bo:(j + 1) * bo])
        do_t = tiles.landed(dop[:, :, None, j * bo:(j + 1) * bo])
        sc = score_product(k_buf, own, q_t, tiles, False)  # s^T
        dp = score_product(v_buf, own, do_t, tiles, False)  # dp^T
        replaced = causal & (key > r)
        x = torch.where(replaced, float(masked2), sc * c1 + kbias)
        p = torch.exp2(x - m2[:, :, None, None, r]) \
            * inv_l[:, :, None, None, r]
        p = torch.where(valid[r] & valid[key], p, 0.0)
        ds = torch.where(replaced, 0.0,
                         p * (dp - delta[:, :, None, None, r]))
        dv = second_product(dv, p, do_t, tiles)
        dk = second_product(dk, ds, q_t, tiles)
    dk = (dk * scale).reshape(b, h, sp, dh)[..., :s, :]
    dv = dv.reshape(b, h, sp, dh)[..., :s, :]
    return dq[..., :head_dim], dk[..., :head_dim], dv[..., :head_dim]


LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
MASKED2 = np.float32(np.float32(-1e9) * LOG2E)  # kMaskedLog2


def emulate_forward(q, k, v, key_mask, causal, order=acc_order, width=None,
                    scale_dim=None):
    """(O, lse) of the forward kernel's arithmetic on its layouts: per item
    (64 query rows) and key tile, S = Q K^T from Q (register fragments at
    Dh = 32, else read K-major) and K as landed, x = s scale log2 e + bias
    log2 e, keys past S excluded, replaced scores -1e9 log2 e, the online
    softmax in log2 units, then O += P V with P from the score
    accumulators and V transposed, rows at ``order`` (acc_order; another
    order breaks it, the mutation case), one product of 32 keys (16 at
    Dh = 128) at a time, each summed from zero and added in float32.
    m = m2 ln 2, lse = m + log l.  ``width`` and ``scale_dim`` as
    :func:`emulate_backward`'s."""
    head_dim = q.shape[-1]
    c1 = np.float32(np.float32(1.0) / np.sqrt(np.float32(
        scale_dim or head_dim)) * LOG2E)
    q, k, v = (_pad_cols(x, width) for x in (q, k, v))
    b, h, s, dh = q.shape
    bk = fwd_keys(dh)
    kh = min(bk, 32)  # keys a P V product takes
    sp = -(-s // TILE) * TILE  # whole items
    n_t = -(-s // bk)          # key tiles an item visits
    qp = _pad(q, sp)
    kp, vp = (_pad(x, n_t * bk) for x in (k, v))
    bias2 = torch.full((b, n_t * bk), float(MASKED2))
    bias2[:, :s] = torch.where(key_mask, 0.0, float(MASKED2)) \
        if key_mask is not None else 0.0
    own = TileLayout(TILE, dh, 64)
    tiles = TileLayout(bk, dh, 64, order)
    q_buf = own.landed(qp.reshape(b, h, sp // TILE, TILE, dh))
    rows = torch.arange(sp).reshape(sp // TILE, TILE, 1)
    m2 = torch.full((b, h, sp // TILE, TILE), -math.inf)
    l = torch.zeros(b, h, sp // TILE, TILE)
    acc = torch.zeros(b, h, sp // TILE, TILE, dh)
    for j in range(n_t):
        key = torch.arange(j * bk, (j + 1) * bk)
        k_buf = tiles.landed(kp[:, :, None, j * bk:(j + 1) * bk])
        v_buf = tiles.landed(vp[:, :, None, j * bk:(j + 1) * bk])
        sc = score_product(q_buf, own, k_buf, tiles, dh == 32)
        x = sc * c1 + bias2[:, None, None, None, key]
        if causal:
            x = torch.where(key > rows, float(MASKED2), x)
        x = torch.where(key < s, x, -math.inf)
        m_new = torch.maximum(m2, x.amax(-1))
        alpha = torch.exp2(m2 - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for j0 in range(0, bk // 8, kh // 8):
            acc = second_product(acc, p, v_buf, tiles, j0, kh // 8)
        m2 = m_new
    o = (acc / l[..., None]).reshape(b, h, sp, dh)[..., :s, :head_dim]
    lse = (m2 * LN2 + torch.log(l)).reshape(b, h, sp)[..., :s]
    return o, lse


def _inputs(shape, seed, fully_masked_row):
    rng = np.random.default_rng(seed)
    b, h, s, dh = shape
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for _ in range(4))
    mask = rng.random((b, s)) > 0.3
    mask[:, 0] = True
    if fully_masked_row:
        mask[-1] = False
    return q, k, v, do, torch.from_numpy(mask)


def _reference(q, k, v, do, mask, causal):
    b, _, s, _ = q.shape
    bias = port_attn.key_bias(mask, b, s, "cpu")
    o = port_attn.attention_reference(q, k, v, bias, causal)
    scores = port_attn._scores(q, k, bias, causal)
    m = scores.amax(-1)
    l = torch.exp(scores - m[..., None]).sum(-1)
    want = port_attn.attention_reference_backward(q, k, v, bias, o, do,
                                                  causal)
    return o, m, l, want


CASES = [((8, 8, 50, 32), False, True), ((8, 8, 50, 32), True, True),
         ((2, 2, 129, 64), True, True), ((1, 1, 1024, 64), False, False),
         ((2, 1, 65, 128), True, True)]


@pytest.mark.parametrize("shape,causal,fully_masked_row", CASES)
def test_emulated_wgmma_backward_meets_the_card_tolerance(shape, causal,
                                                           fully_masked_row):
    """dq, dk and dv through the kernels' layouts, split and tile sums
    within CARD_TOL of the plain backward."""
    q, k, v, do, mask = _inputs(shape, 19, fully_masked_row)
    o, m, l, want = _reference(q, k, v, do, mask, causal)
    got = emulate_backward(q, k, v, mask, o, do, m, l, causal)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, **CARD_TOL, msg=n)


@pytest.mark.parametrize("mutation", ["rows in their own order",
                                      "no transpose"])
def test_emulation_fails_with_a_broken_transposed_tile(mutation):
    """The transposed tiles must hold row r at acc_order(r): in their own
    order the sum over k pairs accumulator column 2t + 1 with row t + 4, and
    a landed tile read as if transposed mixes rows and columns."""
    q, k, v, do, mask = _inputs((2, 2, 64, 32), 5, False)
    o, m, l, want = _reference(q, k, v, do, mask, False)
    kwargs = ({"order": lambda r: r} if mutation == "rows in their own order"
              else {"transposed": False})
    got = emulate_backward(q, k, v, mask, o, do, m, l, False, **kwargs)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert not torch.allclose(g, w, **CARD_TOL), n


def test_permuted_k_order_sums_to_the_plain_product():
    """An accumulator set used as the A operand in place (its columns 2t,
    2t + 1 as k = t, t + 4) times the transposed tile with rows at
    acc_order: the plain product, exactly (integers)."""
    layout = TileLayout(32, 64, 64)
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.integers(-8, 8, (64, 32)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-8, 8, (32, 64)).astype(np.float32))
    t = layout.transpose(layout.landed(x))
    got = torch.zeros(64, 64)
    for c0 in range(0, 64, 32):
        for j in range(4):
            a = p[:, torch.from_numpy(a_from_acc_columns(j))]
            got[:, c0:c0 + 32] += a @ layout.t_k_major(t, c0, j, 32)
    assert torch.equal(got, p @ x)


@pytest.mark.parametrize("rows,dh", [(64, 32), (32, 32), (64, 64), (32, 64),
                                     (64, 128), (16, 128)])
def test_tile_layouts_read_back_as_written(rows, dh):
    """A landed tile read K-major gives its columns k8 step by k8 step
    (TMA's swizzle and the descriptors agree); the split covers every
    element once and its 16-byte loads of a quarter warp hit 8 different
    chunk slots."""
    layout = TileLayout(rows, dh, 64)
    x = torch.arange(rows * dh, dtype=torch.float32).reshape(rows, dh)
    buf = layout.landed(x)
    for ks in range(dh // 8):
        assert torch.equal(layout.k_major(buf, ks), x[:, 8 * ks:8 * ks + 8].T)
    units = split_units(rows, dh, 1)
    for u0 in range(0, len(units), 8):
        for m in range(4):
            slots = {f32_offset(r0 + 2 * m, c, rows) // 16 % 8
                     for r0, c in units[u0:u0 + 8]}
            assert len(slots) == 8


def _plain_forward(q, k, v, mask, causal):
    b, _, s, _ = q.shape
    bias = port_attn.key_bias(mask, b, s, "cpu")
    return (port_attn.attention_reference(q, k, v, bias, causal),
            port_attn.attention_reference_lse(q, k, bias, causal))


FORWARD_CASES = [((8, 8, 50, 32), False, True), ((8, 8, 50, 32), True, True),
                 ((2, 2, 63, 32), True, True), ((2, 2, 64, 64), False, True),
                 ((2, 2, 65, 128), True, True), ((2, 2, 129, 32), False, True),
                 ((2, 2, 129, 64), True, False), ((2, 2, 500, 32), False, True)]


@pytest.mark.parametrize("shape,causal,fully_masked_row", FORWARD_CASES)
def test_emulated_wgmma_forward_meets_the_card_tolerance(shape, causal,
                                                          fully_masked_row):
    """O and lse through the forward kernel's layouts, split, log2 scores
    and tile sums within KERNEL_TOL of the plain version: a fully masked
    row, causal, Dh 32, 64 and 128, S at the tile edges and S = 500."""
    q, k, v, _, mask = _inputs(shape, 20, fully_masked_row)
    want = _plain_forward(q, k, v, mask, causal)
    got = emulate_forward(q, k, v, mask, causal)
    for g, w, n in zip(got, want, ("O", "lse")):
        torch.testing.assert_close(g, w, **KERNEL_TOL, msg=n)
    if fully_masked_row:  # V averaged over the S real keys, l = S
        torch.testing.assert_close(got[0][-1], v[-1].mean(-2, keepdim=True)
                                   .expand_as(got[0][-1]), **KERNEL_TOL)


def test_forward_emulation_fails_with_v_rows_in_their_own_order():
    """V's transposed tile must hold key r at acc_order(r): in the keys' own
    order P V pairs accumulator column 2t + 1 with key t + 4."""
    q, k, v, _, mask = _inputs((2, 2, 64, 32), 6, False)
    want = _plain_forward(q, k, v, mask, False)
    got = emulate_forward(q, k, v, mask, False, order=lambda r: r)
    assert not torch.allclose(got[0], want[0], **KERNEL_TOL)


@pytest.mark.parametrize("causal,fully_masked_row", [(False, True),
                                                     (True, False)])
def test_emulated_forward_matches_the_jax_pallas_forward(causal,
                                                         fully_masked_row):
    """The same seeded numpy inputs through JAX's ``_flash_forward`` in
    interpret mode (as the JAX package's tests run it on the CPU) and
    through the emulation: O and lse within 2e-5.  (JAX adds its causal
    -1e9 where the port replaces the score, so a fully masked row is
    compared without the band.)"""
    q, k, v, _, mask = _inputs((2, 4, 96, 32), 21, fully_masked_row)
    bias = np.where(mask.numpy(), 0.0, jax_attn.NEG_INF).astype(np.float32)
    want_o, want_lse = jax_attn._flash_forward(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(bias),
        causal, True)
    got_o, got_lse = emulate_forward(q, k, v, mask, causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               **KERNEL_TOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(want_lse)[..., 0], **KERNEL_TOL)


HEAD_DIMS = [(16, 32), (48, 64)]  # (Dh, the tile width it runs on)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh,width", HEAD_DIMS)
def test_emulated_kernels_on_a_zero_filled_wider_tile(dh, width, causal):
    """Dh 16 and 48 on the 32- and 64-wide tiles, the columns past Dh zero:
    the forward's O and lse within KERNEL_TOL, dq, dk and dv within
    CARD_TOL of the plain versions (a fully masked row, S past a tile)."""
    q, k, v, do, mask = _inputs((2, 2, 70, dh), 22, True)
    want = _plain_forward(q, k, v, mask, causal)
    got = emulate_forward(q, k, v, mask, causal, width=width)
    for g, w, n in zip(got, want, ("O", "lse")):
        assert g.shape == w.shape, n
        torch.testing.assert_close(g, w, **KERNEL_TOL, msg=n)
    o, m, l, want = _reference(q, k, v, do, mask, causal)
    got = emulate_backward(q, k, v, mask, o, do, m, l, causal, width=width)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, n
        torch.testing.assert_close(g, w, **CARD_TOL, msg=n)


@pytest.mark.parametrize("dh,width", HEAD_DIMS)
def test_emulation_with_the_scale_of_the_tile_width_fails(dh, width):
    """A padded instance that took its scale from the tile width (1/sqrt(W)
    for 1/sqrt(Dh)) misses the card's bars: the scale must come from the
    head dim."""
    q, k, v, do, mask = _inputs((2, 2, 70, dh), 23, False)
    want = _plain_forward(q, k, v, mask, False)
    got = emulate_forward(q, k, v, mask, False, width=width,
                          scale_dim=width)
    assert not torch.allclose(got[0], want[0], **KERNEL_TOL)
    assert not torch.allclose(got[1], want[1], **KERNEL_TOL)
    o, m, l, want = _reference(q, k, v, do, mask, False)
    got = emulate_backward(q, k, v, mask, o, do, m, l, False, width=width,
                           scale_dim=width)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert not torch.allclose(g, w, **CARD_TOL), n
