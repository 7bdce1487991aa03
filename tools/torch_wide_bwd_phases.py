"""Where the float32 wide backward's time goes, phase by phase, on one GPU.

    python tools/torch_wide_bwd_phases.py [--shape B,H,S,DH ...]

Builds a copy of ``csrc/flash_attention_bwd_wide.cu``, with its chunk
pipeline ``csrc/wide_tf32.cuh`` inlined, with ``clock64()`` probes
(:func:`instrumented_source`: the port's source text with probe lines
inserted at fixed places; it raises if the source no longer has one of
them) and runs its dq and dk/dv kernels at each shape (default: the
``--latent_dim 2048`` training shape, one 512-wide head, S = 4096 and
S = 500 at Dh 256; the last fifth of the keys masked), after two warm
calls.  Thread 0 of each warpgroup of every block adds up its cycles a
phase in shared memory and writes them out at the end; the tool averages
them over the blocks that ran and prints, per kernel and shape, each
phase's share of its warpgroup's cycles:

* consumers: ``wait_full`` (for the splitters' chunk), ``issue`` (the
  chunk's score products, the wait excluded), ``wgmma_wait`` (for the
  previous chunk's products), ``release`` (the named barrier and thread
  0's refill), ``ds`` (p and ds), ``second`` (the second products),
  ``tile_end`` (the barrier before t_free), and the rest (an item's start
  and its stores);
* splitters: ``wait_loaded`` (for TMA), ``wait_t_free`` (for the
  consumers' previous tile), ``arrive`` (the proxy fence and the full
  barrier), and the rest (the split itself, delta and the vectors).

The probes cost cycles of their own, so the shares describe the
instrumented copy.  Prints one line per kernel and shape and, last, one
JSON object.  Needs a GPU (and nvcc); it raises without one.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = ((256, 8, 50, 256), (256, 1, 50, 512), (1, 2, 4096, 256),
          (64, 8, 500, 256))
SLOTS = {0: "wait_full", 1: "issue_chunk", 2: "wgmma_wait", 3: "release",
         4: "ds", 5: "second", 6: "tile_end", 7: "consumer_total",
         16: "wait_loaded", 17: "wait_t_free", 18: "arrive",
         19: "splitter_total"}

_PRELUDE = """
// Probes of tools/torch_wide_bwd_phases.py: thread 0 of each warpgroup adds
// its cycles a phase into shared memory; the block writes them out.
__device__ unsigned long long g_phase_cycles[4096 * 32];
__shared__ unsigned long long s_phase_cycles[32];
#define PHASE_T0(name) const unsigned long long name = clock64()
#define PHASE_ADD(since, slot) \\
  if (threadIdx.x % 128 == 0) s_phase_cycles[slot] += clock64() - (since)
"""

_READER = """
extern "C" int wide_phase_cycles(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_phase_cycles, sizeof(g_phase_cycles)));
}
"""

# (the source's text, what replaces it, how many times it occurs)
_PROBES = (
    ('#include "wgmma_tf32.cuh"\n', '#include "wgmma_tf32.cuh"\n' + _PRELUDE,
     1),
    ("    const int r = s % P::kStages;\n"
     "    mbar_wait(&bar.full[r], s / P::kStages & 1);\n",
     "    const int r = s % P::kStages;\n"
     "    PHASE_T0(wf0);\n"
     "    mbar_wait(&bar.full[r], s / P::kStages & 1);\n"
     "    PHASE_ADD(wf0, 0);\n", 1),
    ("    issue_chunk(small, large, s++, 1);\n",
     "    {\n      PHASE_T0(is0);\n"
     "      issue_chunk(small, large, s++, 1);\n"
     "      PHASE_ADD(is0, 1);\n    }\n", 1),
    ("      issue_chunk(small, large, s++, 0);\n"
     "      wgmma_wait<1>();\n"
     "      release(lt, refill, (s - 2) % P::kStages);\n",
     "      PHASE_T0(is1);\n"
     "      issue_chunk(small, large, s++, 0);\n"
     "      PHASE_ADD(is1, 1);\n"
     "      PHASE_T0(ww1);\n"
     "      wgmma_wait<1>();\n"
     "      PHASE_ADD(ww1, 2);\n"
     "      PHASE_T0(rl1);\n"
     "      release(lt, refill, (s - 2) % P::kStages);\n"
     "      PHASE_ADD(rl1, 3);\n", 1),
    ("    wgmma_wait<0>();\n#pragma unroll\n    for (int p = 0; p < NP; ++p) {\n",
     "    PHASE_T0(ww0);\n    wgmma_wait<0>();\n    PHASE_ADD(ww0, 2);\n"
     "#pragma unroll\n    for (int p = 0; p < NP; ++p) {\n", 1),
    ("    release(lt, refill, (s - 1) % P::kStages);\n",
     "    PHASE_T0(rl0);\n    release(lt, refill, (s - 1) % P::kStages);\n"
     "    PHASE_ADD(rl0, 3);\n", 1),
    ("      blk.scores(sd, s, lt, refill);\n",
     "      blk.scores(sd, s, lt, refill);\n      PHASE_T0(ds0);\n", 2),
    ("      // dq += ds k: ds from the accumulators, k transposed (K^T hi, lo).\n",
     "      PHASE_ADD(ds0, 4);\n      PHASE_T0(se0);\n", 1),
    ("      // dv += p^T dO and dk += ds^T q (dO and q transposed), one after the\n",
     "      PHASE_ADD(ds0, 4);\n      PHASE_T0(se0);\n"
     "      // dv += p^T dO and dk += ds^T q (dO and q transposed), one after the\n",
     1),
    ("      blk.release(lt, free_tile, 0);\n",
     "      PHASE_ADD(se0, 5);\n      PHASE_T0(te0);\n"
     "      blk.release(lt, free_tile, 0);\n      PHASE_ADD(te0, 6);\n", 2),
    ("  if (tid == 0) {\n    blk.bar.init(P::kStages);\n",
     "  PHASE_T0(all0);\n  if (tid < 32) s_phase_cycles[tid] = 0;\n"
     "  if (tid == 0) {\n    blk.bar.init(P::kStages);\n", 2),
    ("        DqRows{o, delta, ld});\n    return;\n",
     "        DqRows{o, delta, ld});\n    PHASE_ADD(all0, 19);\n"
     "    PHASE_WRITE();\n    return;\n", 1),
    ("        DqRows{});\n    return;\n",
     "        DqRows{});\n    PHASE_ADD(all0, 19);\n"
     "    PHASE_WRITE();\n    return;\n", 1),
    ("          mbar_wait(&bar.loaded[r], s / P::kStages & 1);\n",
     "          PHASE_T0(wl0);\n"
     "          mbar_wait(&bar.loaded[r], s / P::kStages & 1);\n"
     "          PHASE_ADD(wl0, 16);\n", 1),
    ("              if (g > 0) mbar_wait(bar.t_free, (g - 1) & 1);\n",
     "              PHASE_T0(tf0);\n"
     "              if (g > 0) mbar_wait(bar.t_free, (g - 1) & 1);\n"
     "              PHASE_ADD(tf0, 17);\n", 1),
    ("          fence_proxy_async();\n          mbar_arrive(&bar.full[r]);\n",
     "          PHASE_T0(ar0);\n          fence_proxy_async();\n"
     "          mbar_arrive(&bar.full[r]);\n          PHASE_ADD(ar0, 18);\n",
     1),
)
# The consumers' totals: at the end of each kernel's item loop.
_KERNEL_END = "\n  }\n}\n\n// -----"


_HEADER = '#include "wide_tf32.cuh"\n'


def instrumented_source(source: str, header: str = None) -> str:
    """``source`` (flash_attention_bwd_wide.cu) with ``header`` (its chunk
    pipeline, ``csrc/wide_tf32.cuh`` by default) inlined, the phase probes
    and the reader entry point; raises ``ValueError`` where a probe's place
    is not found as often as expected."""
    if header is None:
        from flexdm_tpu_torch.ops import _build

        header = (_build.CSRC_DIR / "wide_tf32.cuh").read_text()
    if source.count(_HEADER) != 1:
        raise ValueError(f"{_HEADER.strip()} found {source.count(_HEADER)} "
                         "times, not 1")
    out = source.replace(_HEADER, header.replace("#pragma once\n", ""))
    for old, new, count in _PROBES:
        found = out.count(old)
        if found != count:
            raise ValueError(f"probe place found {found} times, not {count}:"
                             f" {old.strip()[:60]!r}")
        out = out.replace(old, new)
    # Thread 0 of the consumers writes slots 0-15, of the splitters 16-31.
    write = ("#define PHASE_WRITE() do { "
             "if (threadIdx.x % 128 == 0) "
             "for (int i = threadIdx.x < 128 ? 0 : 16, e = i + 16; i < e; "
             "++i) atomicAdd(&g_phase_cycles[blockIdx.x * 32 + i], "
             "s_phase_cycles[i]); } while (0)\n")
    out = out.replace(_PRELUDE, _PRELUDE + write)
    # Each kernel ends its consumers' item loop with "  }\n}" before the
    # next section rule: add the consumer total and the write there.
    ends = out.count(_KERNEL_END)
    if ends != 2:
        raise ValueError(f"kernel ends found {ends} times, not 2")
    out = out.replace(
        _KERNEL_END,
        "\n  }\n  PHASE_ADD(all0, 7);\n  PHASE_WRITE();\n}\n\n// -----", 2)
    return out + _READER


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", action="append", default=None,
                        metavar="B,H,S,DH",
                        help="a shape to run (repeatable; default SHAPES)")
    args = parser.parse_args(argv)
    shapes = []
    for text in args.shape or ():
        try:
            shape = tuple(int(x) for x in text.split(","))
        except ValueError:
            parser.error(f"--shape takes B,H,S,DH, got {text!r}")
        if len(shape) != 4 or min(shape) < 1 or shape[3] <= 128:
            parser.error(f"--shape takes B,H,S,DH with DH > 128, got {text!r}")
        shapes.append(shape)
    args.shape = tuple(shapes) or SHAPES
    return args


def shares(cycles):
    """``{phase: share}`` of one kernel's mean cycles a block (the
    consumers' phases of their total, the splitters' of theirs), with each
    warpgroup's remainder."""
    c = {name: float(cycles[slot]) for slot, name in SLOTS.items()}
    consumer, splitter = c["consumer_total"], c["splitter_total"]
    issue = c["issue_chunk"] - c["wait_full"]
    out = {"wait_full": c["wait_full"] / consumer, "issue": issue / consumer}
    for name in ("wgmma_wait", "release", "ds", "second", "tile_end"):
        out[name] = c[name] / consumer
    out["consumer_rest"] = 1.0 - sum(out.values())
    sp = {name: c[name] / splitter
          for name in ("wait_loaded", "wait_t_free", "arrive")}
    sp["split_rest"] = 1.0 - sum(sp.values())
    return dict(out, **sp)


def read_cycles(lib):
    """The probes' running sums, (blocks, 32) float64."""
    import numpy as np

    buf = np.zeros(4096 * 32, np.uint64)
    err = lib.wide_phase_cycles(buf.ctypes.data)
    if err:
        raise RuntimeError(f"reading the probes failed: cudaError {err}")
    return buf.reshape(4096, 32).astype(np.float64)


def main(argv=None):
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool needs one GPU")
    import chip_smoke
    from flexdm_tpu_torch.ops import _build
    from flexdm_tpu_torch.ops import attention as attn

    card = chip_smoke.card_line()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "wide_bwd_phases.cu")
    with open(_build.CSRC_DIR / "flash_attention_bwd_wide.cu") as f:
        text = instrumented_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(_build.BUILD_DIR, "libwide_bwd_phases.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC_DIR), "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    fns = []
    for symbol in ("flexdm_flash_attention_bwd_dq_wide",
                   "flexdm_flash_attention_bwd_dkv_wide"):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    lib.wide_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.wide_phase_cycles.restype = ctypes.c_int
    results = {}
    for shape in args.shape:
        b, h, s, dh = shape
        g = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=g).cuda()
                       for _ in range(4))
        mask = torch.ones(b, s, dtype=torch.bool)
        mask[:, s - s // 5:] = False
        mask = mask.cuda()
        o, _, m, l = attn._forward(q, k, v, mask, False)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty((b, h, s), device="cuda")
        stream = attn._stream(q)
        calls = (
            lambda: fns[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           mask.data_ptr(), o.data_ptr(), do.data_ptr(),
                           m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                           dq.data_ptr(), b, h, s, dh, 0, stream),
            lambda: fns[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           mask.data_ptr(), do.data_ptr(), m.data_ptr(),
                           l.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), b, h, s, dh, 0, stream))
        for name, call in zip(("dq", "dkv"), calls):
            for _ in range(2):
                attn._launch(name, call)
            # The probes add up over launches: one launch between two reads.
            before = read_cycles(lib)
            attn._launch(name, call)
            torch.cuda.synchronize()
            cycles = read_cycles(lib) - before
            ran = cycles[:, 7] > 0
            mean = cycles[ran].mean(0)
            got = shares(mean)
            results[f"{shape} {name}"] = dict(
                blocks=int(ran.sum()),
                consumer_cycles=float(mean[7]),
                splitter_cycles=float(mean[19]), shares=got)
            chip_smoke.log(
                f"[phases] {shape} {name}: {int(ran.sum())} blocks, "
                f"consumers {mean[7]:.0f} cycles a block ("
                + ", ".join(f"{k} {got[k] * 100:.1f}%" for k in (
                    "wait_full", "issue", "wgmma_wait", "release", "ds",
                    "second", "tile_end", "consumer_rest"))
                + f"), splitters {mean[19]:.0f} ("
                + ", ".join(f"{k} {got[k] * 100:.1f}%" for k in (
                    "wait_loaded", "wait_t_free", "arrive", "split_rest"))
                + f") [{card}]")
    chip_smoke.log(json.dumps({"card": card, "phases": results}))


if __name__ == "__main__":
    main()
