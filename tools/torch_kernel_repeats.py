"""Repeat the float32 flash-attention kernels on one GPU and count the calls
that are not bitwise equal to the first.

    python tools/torch_kernel_repeats.py [--repeats N] [--dq-repeats M]
        [--shape B,H,S,DH ...] [--other NAME=PATH.cu ...]

At each shape (default ``SHAPES``: the two-stream (33, 8, 70, Dh) at Dh
32, 48 and 25 (25 through the padded copy), the one-stream (8, 8, 70, 32)
and (17, 16, 130, 64); a head dim above 128, e.g. ``--shape 8,8,50,256``,
runs the wide kernels), causal and not, the last fifth of the keys masked:

* the port's forward, dq and dk/dv kernels, called in autograd's order
  (forward, dq, dk/dv) ``--repeats`` times, each output compared bitwise
  with the first call's; where one differs: the items (64-row blocks of a
  head, ``(b H + h) blocks + row / 64``) and rows, and the largest
  difference;
* with ``--other`` (builds of ``csrc/flash_attention_bwd.cu`` with the same
  entry points, e.g. a variant of the current file with ``csrc/*.cuh``
  copied beside it, beside the port's own build, ``this``): each build's dq
  kernel in autograd's order (the port's forward, the build's dq, the
  port's dk/dv) ``--dq-repeats`` times at ``DQ_SHAPES``, compared bitwise
  with its first call.

The card's name and power limit come first; the last line is one JSON
object with every count.
"""

import argparse
import ctypes
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SHAPES = ((33, 8, 70, 32), (33, 8, 70, 48), (33, 8, 70, 25), (8, 8, 70, 32),
          (17, 16, 130, 64))
# dq of each build: the two-stream Dh 32 shape, causal and not, and
# crello's training shape.
DQ_SHAPES = (((33, 8, 70, 32), True), ((33, 8, 70, 32), False),
             ((256, 8, 50, 32), False))


def where(x, y, shape):
    """Where ``x`` and ``y`` differ: rows, items, the largest difference."""
    bad = (x != y)
    if bad.dim() == 4:
        bad = bad.any(-1)
    rows = bad.nonzero().tolist()
    blocks = -(-shape[2] // 64)
    items = sorted({(b * shape[1] + h) * blocks + s // 64
                    for b, h, s in rows})
    return {"rows": len(rows), "first_rows": rows[:8], "items": items[:8],
            "max_abs": (x.float() - y.float()).abs().max().item()}


def inputs(shape, causal, g, dtype=None):
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    b, h, s, dh = shape
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", dtype)
                   for _ in range(4))
    mask = chip_smoke.fifth_masked(b, s)
    o, _, m, l = attn._forward(q, k, v, mask, causal)
    rows = attn._padded(dh, q.dtype, q, k, v, o, do)
    return q, k, v, mask, m, l, rows


def repeat_kernels(shape, causal, n, g, dtype=None,
                   kernels=("fwd", "dq", "dkv")):
    """The port's ``kernels`` (of the forward, dq and dk/dv) in autograd's
    order, ``n`` times (those that run ``shape``'s head dim in ``dtype``,
    float32 by default: ``attention.instance_names``)."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    q, k, v, mask, m, l, rows = inputs(shape, causal, g, dtype)
    dh = shape[3]

    def run():
        out = {}
        if "fwd" in kernels:
            out["fwd"] = (("O", "lse", "m", "l"),
                          attn._forward(q, k, v, mask, causal))
        if "dq" in kernels or "dkv" in kernels:
            dq, delta = attn._backward_dq(*rows[:3], mask, rows[3], m, l,
                                          rows[4], causal, dh)
            if "dq" in kernels:
                out["dq"] = (("dq", "delta"), (dq, delta))
        if "dkv" in kernels:
            out["dkv"] = (("dk", "dv"), attn._backward_dkv(
                *rows[:3], mask, m, l, delta, rows[4], causal, dh))
        return out

    first = run()
    out = {name: {"differ": 0, "cases": []} for name in first}
    for i in range(n):
        again = run()
        # One host sync a call: every output's equality at once, the
        # details only where one differs.
        same = torch.stack([torch.eq(x, y).all()
                            for name, (_, got) in again.items()
                            for x, y in zip(got, first[name][1])]).cpu()
        if bool(same.all()):
            continue
        for name, (names, got) in again.items():
            want = first[name][1]
            if all(torch.equal(x, y) for x, y in zip(got, want)):
                continue
            out[name]["differ"] += 1
            if len(out[name]["cases"]) < 3:
                out[name]["cases"].append({
                    "repeat": i, **{o: where(x, y, shape) for o, x, y in
                                    zip(names, got, want)
                                    if not torch.equal(x, y)}})
    torch.cuda.synchronize()
    return out


def repeat_dq(fn, shape, causal, n, g):
    """A build's dq entry point ``fn`` in autograd's order, ``n`` times:
    how many calls differ from the first, and the largest difference."""
    import torch

    from flexdm_tpu_torch.ops import attention as attn

    q, k, v, mask, m, l, rows = inputs(shape, causal, g)
    b, h, s, dh = shape
    delta = torch.zeros((b, h, s), device="cuda")

    def call():
        dq = torch.empty_like(rows[0])
        out_delta = torch.empty((b, h, s), device="cuda")
        err = fn(*(t.data_ptr() for t in rows[:3]), mask.data_ptr(),
                 rows[3].data_ptr(), rows[4].data_ptr(), m.data_ptr(),
                 l.data_ptr(), out_delta.data_ptr(), dq.data_ptr(), b, h, s,
                 dh, int(causal), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dq launch failed: cudaError {err}")
        return dq

    first = call()
    differ, worst = 0, 0.0
    for _ in range(n):
        attn._forward(q, k, v, mask, causal)
        dq = call()
        attn._backward_dkv(*rows[:3], mask, m, l, delta, rows[4], causal, dh)
        if not torch.equal(dq, first):
            differ += 1
            worst = max(worst, (dq - first).abs().max().item())
    torch.cuda.synchronize()
    return {"differ": differ, "max_abs": worst}


def shape_arg(text):
    try:
        shape = tuple(int(x) for x in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 4 or min(shape) < 1:
        raise argparse.ArgumentTypeError(f"B,H,S,DH expected, got {text!r}")
    return shape


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=3000)
    parser.add_argument("--dq-repeats", type=int, default=12000)
    parser.add_argument("--shape", type=shape_arg, action="append",
                        default=[], help="B,H,S,DH (default: SHAPES)")
    parser.add_argument("--other", action="append", default=[],
                        metavar="NAME=PATH.cu",
                        help="another build of flash_attention_bwd.cu")
    args = parser.parse_args(argv)
    for other in args.other:
        if "=" not in other:
            parser.error(f"--other takes NAME=PATH.cu, got {other!r}")
    args.shape = tuple(args.shape) or SHAPES
    return args


def main(argv=None):
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool needs one GPU")
    from flexdm_tpu_torch.ops import attention as attn
    from tools.torch_bwd_bf16_bench import build

    card = chip_smoke.card_line()
    chip_smoke.log(f"[repeats] {card}")
    g = torch.Generator().manual_seed(11)
    out = {"card": card, "repeats": args.repeats, "kernels": {}}
    t0 = time.perf_counter()
    for shape in args.shape:
        for causal in (False, True):
            got = repeat_kernels(shape, causal, args.repeats, g)
            out["kernels"][f"{shape} causal={causal}"] = got
            names = attn.instance_names(torch.float32, shape[3])
            chip_smoke.log(
                f"[repeats] {shape} causal={causal} ({', '.join(names)}): "
                "not bitwise in "
                + ", ".join(f"{k} {v['differ']} of {args.repeats}"
                            for k, v in got.items())
                + "".join(f"; {k} {c}" for k, v in got.items()
                          for c in v["cases"]))
    chip_smoke.log(f"[repeats] {time.perf_counter() - t0:.1f} s")
    if args.other:
        jobs = [("this", None)] + [tuple(o.split("=", 1)) for o in args.other]
        with ThreadPoolExecutor(len(jobs)) as pool:
            builds = list(pool.map(lambda job: build(*job, "float32"), jobs))
        out["dq"] = {"repeats": args.dq_repeats, "ptxas": {}}
        for name, (dq, _), summary, _ in builds:
            out["dq"]["ptxas"][name] = [x for x in summary
                                        if "dq_kernel<32" in x]
            chip_smoke.log(f"[repeats] build {name}: "
                           + "; ".join(out["dq"]["ptxas"][name]))
            for shape, causal in DQ_SHAPES:
                got = repeat_dq(dq, shape, causal, args.dq_repeats, g)
                out["dq"][f"{name} {shape} causal={causal}"] = got
                chip_smoke.log(
                    f"[repeats] dq {name} {shape} causal={causal}: "
                    f"{got['differ']} of {args.dq_repeats} not bitwise "
                    f"(max |d| {got['max_abs']:.3e})")
    chip_smoke.log(json.dumps(out))


if __name__ == "__main__":
    main()
