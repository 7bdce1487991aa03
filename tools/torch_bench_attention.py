"""The port's attention on one GPU: kernels, plain version and library call.

    python tools/torch_bench_attention.py --b 8 --h 8 --s 512 --dh 64
    python tools/torch_bench_attention.py --sweep 256,512,768,1024
    python tools/torch_bench_attention.py --b 64 --h 8 --s 500 --dh 32 \\
        --dtype bfloat16 [--causal]
    python tools/torch_bench_attention.py --shape 256,8,50,256

``--shape B,H,S,DH`` stands for ``--b --h --s --dh``.  Every head dim runs:
above 128 on the wide kernels (``csrc/flash_attention_wide.cu``); the
JSON line's ``kernels`` names the instances that ran.

Counterpart of ``tools/bench_attention.py`` for ``flexdm_tpu_torch``.  At
each ``(b, h, s, dh)`` (q, k, v drawn from seed 0 in ``--dtype``, every
key attended, the causal band with ``--causal``) it times, on CUDA events
(the median over ``--windows`` of the mean of ``--iters`` back-to-back
calls, warm):

* the forward (``fwd_ms``) and the forward with the full backward, all
  three gradients of a fixed cotangent computed (``fwd_bwd_ms``);
* for ``dot_product_attention(impl="pallas")`` (the CUDA kernels),
  ``impl="xla"`` (the plain PyTorch version) and one
  ``scaled_dot_product_attention`` call with the same mask (the library's,
  a yardstick the port never calls);
* beside the bound of each (PERF.md section 6's rule): the larger of the
  bytes the work must move over 3.35 TB/s and its FLOPs over the
  tensor-core peak of the dtype (495 TFLOP/s TF32, 989.4 TFLOP/s bf16),
  the products cut to the causal band with ``--causal``;
* and the exponential floor (``*_exp_floor_ms``): one exponential a score
  (the causal band's with ``--causal``) for the forward and once more in
  each of the two backward kernels, over 16 a clock an SM at the card's
  SM count and ``clocks.max.sm``.

Also the largest |difference| of the kernels' O, dq, dk and dv from the
plain version's, and the kernels' launches.  Prints one JSON line per
shape, with the card's name and power limit (``nvidia-smi``).  A CPU
device is refused: the kernels run only on a card.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tools.torch_kernel_repeats import shape_arg  # noqa: E402

IMPLS = ("pallas", "xla", "library")


def bounds(b, h, s, dh, dtype="float32", causal=False):
    """The bound of the forward and of forward + backward: reads q, k, v
    and the (B, S) byte mask and writes O and float32 lse, m, l; the dq
    kernel reads q, k, v, O, dO, m, l, the mask and writes dq and delta,
    the dk/dv kernel reads q, k, v, dO, m, l, delta, the mask and writes
    dk, dv; 2, 3 and 4 products of 2 S^2 Dh FLOPs per (batch, head), the
    causal band's ``(S + 1) / 2S`` of them with ``causal``.  ``exps``: the
    exponentials, one a score in the forward and in each backward kernel
    (``chip_smoke.attention_exps``)."""
    itemsize, peak = ((2, chip_smoke.BF16_FLOPS) if dtype == "bfloat16"
                      else (4, chip_smoke.TF32_FLOPS))
    rows = b * h * s
    band = (s + 1) / (2 * s) if causal else 1.0
    product = 2 * b * h * s * s * dh * band
    fwd_bytes = itemsize * 4 * rows * dh + 4 * 3 * rows + b * s
    bwd_bytes = 2 * (itemsize * 6 * rows * dh + 4 * 3 * rows + b * s)
    exps = chip_smoke.attention_exps((b, h, s, dh), causal)
    return {"fwd": dict(chip_smoke.bound(fwd_bytes, 2 * product, peak),
                        exps=exps),
            "fwd_bwd": dict(chip_smoke.bound(fwd_bytes + bwd_bytes,
                                             9 * product, peak),
                            exps=3 * exps)}


def measure(b, h, s, dh, dtype="float32", causal=False, iters=20,
            windows=10):
    import torch
    import torch.nn.functional as F

    from flexdm_tpu_torch.ops import attention as attn

    shape = (b, h, s, dh)
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", getattr(
        torch, dtype)) for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    allowed = mask[:, None, None, :]
    if causal:
        allowed = allowed & ~attn._outside_causal_band(q)

    def call(impl, q, k, v):
        if impl == "library":
            return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed)
        return attn.dot_product_attention(q, k, v, mask, causal, impl=impl)

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd_bwd(impl):
        return torch.autograd.grad(call(impl, *leaves), leaves, do)

    with torch.no_grad():
        outs = {impl: call(impl, q, k, v) for impl in ("pallas", "xla")}
    grads = {impl: fwd_bwd(impl) for impl in ("pallas", "xla")}
    err = {"O": (outs["pallas"].float() - outs["xla"].float()).abs().max()}
    for name, x, y in zip(("dq", "dk", "dv"), grads["pallas"],
                          grads["xla"]):
        err[name] = (x.float() - y.float()).abs().max()
    attn.reset_launch_counts()
    out = {"b": b, "h": h, "s": s, "dh": dh, "dtype": dtype,
           "causal": causal,
           "max_abs_err": {k: float(v) for k, v in err.items()}}
    for impl in IMPLS:
        with torch.no_grad():
            out[f"{impl}_fwd_ms"] = chip_smoke.time_ms(
                lambda: call(impl, q, k, v), samples=windows, inner=iters)
        out[f"{impl}_fwd_bwd_ms"] = chip_smoke.time_ms(
            lambda: fwd_bwd(impl), samples=windows, inner=iters)
    names = attn.instance_names(getattr(torch, dtype), dh)
    counts = attn.launch_counts()
    out["kernels"] = list(names)
    out["launches"] = {kernel: counts[name] for kernel, name in
                       zip(("fwd", "dq", "dkv"), names)}
    for part, bd in bounds(b, h, s, dh, dtype, causal).items():
        out[f"{part}_bound_ms"] = bd["bound_ms"]
        out[f"{part}_bound_by"] = bd["bound_by"]
        out[f"{part}_exp_floor_ms"] = chip_smoke.exp_floor_ms(bd["exps"])
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--h", type=int, default=8)
    p.add_argument("--s", type=int, default=512)
    p.add_argument("--dh", type=int, default=64)
    p.add_argument("--shape", type=shape_arg, default=None,
                   help="B,H,S,DH: --b, --h, --s and --dh at once")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--windows", type=int, default=10)
    p.add_argument("--causal", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--sweep", default=None,
                   help="comma-separated S values; overrides --s")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.shape:
        args.b, args.h, args.s, args.dh = args.shape
    return args


def main(argv=None):
    args = parse_args(argv)

    import torch

    if args.device != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: the attention kernels "
                         "run only on a CUDA device")
    card = chip_smoke.card_line()
    s_values = ([int(x) for x in args.sweep.split(",")]
                if args.sweep else [args.s])
    rows = []
    for s in s_values:
        row = dict(measure(args.b, args.h, s, args.dh, args.dtype,
                           args.causal, args.iters, args.windows),
                   card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
