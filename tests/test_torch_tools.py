"""The port's tools (``tools/torch_*.py``) and ``bin/*_torch.sh`` on the CPU,
at tiny widths: they run end to end and print what they promise (not
speed).  Every tool runs in a subprocess where ``jax``, ``flax``,
``optax``, ``orbax`` and ``flexdm_tpu`` cannot be imported.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from flexdm_tpu_torch import cli  # noqa: E402
from tools import torch_bench_attention  # noqa: E402
from tools.torch_train_baselines import PRESETS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180  # each tool run's hard limit
TINY = ["--latent_dim", "32", "--num_blocks", "1", "--batch_size", "16",
        "--validation_freq", "1", "--num_epochs", "1", "--device", "cpu",
        "--log_level", "WARNING"]

# Runs ``argv[1]`` as ``__main__`` with the JAX package and JAX blocked.
_BLOCKED = r"""
import importlib.abc, runpy, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "flexdm_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def run_tool(name, *args):
    """``tools/<name>`` with ``args``, JAX blocked; its process."""
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED, os.path.join(ROOT, "tools", name),
         *args], cwd=ROOT, capture_output=True, text=True,
        timeout=TIMEOUT_S, env=dict(os.environ, FLEXDM_PLATFORM="cpu"))


def tool_json(name, *args):
    """The JSON object of the tool's last line of output."""
    proc = run_tool(name, *args)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def job(crello_dir, tmp_path_factory):
    job = str(tmp_path_factory.mktemp("tools") / "job")
    cli.main(["--preset", "crello_ours_exp", "--data_dir", crello_dir,
              "--job-dir", job, *TINY])
    return job


def test_profile_step_prints_its_segments():
    out = tool_json("torch_profile_step.py", "--batch-size", "8",
                    "--latent-dim", "32", "--num-blocks", "1", "--iters",
                    "2", "--device", "cpu")
    for key in ("masking_ms", "forward_ms", "forward_backward_ms",
                "optimizer_ms", "full_step_ms"):
        assert out[key] > 0, key
    assert (out["device"], out["clock"], out["card"]) == ("cpu", "host",
                                                          "cpu")
    assert out["config"]["batch_size"] == 8
    assert set(out["launches"].values()) == {0}  # the CPU runs no kernel


def test_bench_serve_runs_on_a_tiny_job(job, tmp_path):
    out = tool_json("torch_bench_serve.py", "--job-dir", job,
                    "--batch-size", "2", "--requests", "2", "--num_iter",
                    "2", "--concurrency", "2", "--device", "cpu", "--out",
                    str(tmp_path / "serve.json"))
    assert out["first_pos_iter1_sec"] > 0
    for key in ("pos_1doc", "pos_2doc", "pos_2doc_changed",
                "elem_1doc_iter2"):
        assert out[key]["n"] == 2
        assert out[key]["p95_ms"] >= out[key]["p50_ms"] > 0, key
    for key in ("load_serial", "load_coalesced"):
        assert out[key]["docs_per_sec"] > 0, key
    with open(tmp_path / "serve.json") as f:
        assert json.load(f)["requests"] == 2


def test_profile_demo_runs_on_a_tiny_job(job):
    out = tool_json("torch_profile_demo.py", "--job-dir", job,
                    "--num-examples", "2", "--device", "cpu")
    assert [r["run"] for r in out["runs"]] == ["cold", "warm1"]
    for run in out["runs"]:
        assert set(run["timings"]) == {"load_model", "load_batch",
                                       "forward_eval", "unbatch",
                                       "svg_html", "total"}


@pytest.mark.parametrize("arch", ["canvasvae", "layoutvae", "autoreg",
                                  "bart_autoreg"])
def test_train_baselines_row(arch):
    out = tool_json("torch_train_baselines.py", "--arch", arch, "--docs",
                    "32", "--epochs", "1", "--latent-dim", "16",
                    "--num-blocks", "1", "--batch-size", "16", "--device",
                    "cpu")
    row = out["baselines"][arch]
    assert row["preset"] == PRESETS[arch]
    assert row["epochs"] == 1 and not row["stopped_on_nan"]
    assert row["loss_last"] == row["loss_last"]  # not NaN
    assert row["num_params"] > 0 and row["wall_sec"] > 0


def test_bench_attention_refuses_the_cpu():
    proc = run_tool("torch_bench_attention.py", "--device", "cpu")
    assert proc.returncode != 0
    assert "only on a CUDA device" in proc.stderr


@pytest.mark.parametrize("dtype, causal", [("float32", False),
                                           ("bfloat16", True)])
def test_bench_attention_bounds_are_a_hand_count(dtype, causal):
    """(2, 2, 64, 32): q, k, v, O of 8192 elements each; lse, m, l 256
    float32 rows; a 128-byte mask.  The forward moves 4 tensors + 3 rows +
    the mask, the backward 12 tensors + 6 rows + 2 masks; 2 + 3 + 4
    products of 2 * 4 * 64 * 64 * 32 FLOPs (the causal band's 65/128)."""
    item, peak = (4, 495e12) if dtype == "float32" else (2, 989.4e12)
    band = 65 / 128 if causal else 1.0
    product = 2 * 4 * 64 * 64 * 32 * band
    fwd_bytes = 4 * 8192 * item + 3 * 256 * 4 + 128
    bwd_bytes = 12 * 8192 * item + 6 * 256 * 4 + 2 * 128
    want = {"fwd": (fwd_bytes, 2 * product),
            "fwd_bwd": (fwd_bytes + bwd_bytes, 9 * product)}
    got = torch_bench_attention.bounds(2, 2, 64, 32, dtype, causal)
    for part, (nbytes, flops) in want.items():
        t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / peak * 1e3
        assert got[part]["bound_ms"] == pytest.approx(max(t_bytes, t_ops),
                                                      rel=1e-12)
        assert got[part]["bound_by"] == ("bytes" if t_bytes >= t_ops
                                         else "operations")


def test_bwd_bench_parses_its_arguments():
    """``tools/torch_bwd_bf16_bench.py``: ``--dtype float32`` builds the
    float32 backward and times it at the three shapes and the baselines'
    causal one; bfloat16 stays the default."""
    from flexdm_tpu_torch.ops import attention as attn
    from tools import torch_bwd_bf16_bench as bench

    args = bench.parse_args(["--dtype", "float32", "--other",
                             "parent=build/parent/flash_attention_bwd.cu",
                             "--steps", "--turns", "4"])
    assert (args.dtype, args.other, args.steps, args.turns) == (
        "float32", ["parent=build/parent/flash_attention_bwd.cu"], True, 4)
    default = bench.parse_args([])
    assert (default.dtype, default.other, default.steps, default.turns) == (
        "bfloat16", [], False, 2)
    assert bench.library("float32") == attn.BWD_LIBRARY
    assert bench.library("bfloat16") == attn.BWD_BF16_LIBRARY
    assert bench.ENTRIES["float32"] == ("flexdm_flash_attention_bwd_dq",
                                        "flexdm_flash_attention_bwd_dkv")
    assert bench.F32_SHAPES == ((256, 8, 50, 32), (64, 8, 500, 32),
                                (1, 2, 4096, 64), (64, 8, 50, 32))
    for bad in (["--dtype", "float16"], ["--other", "parent"]):
        with pytest.raises(SystemExit):
            bench.parse_args(bad)


def test_bwd_bench_takes_the_wide_kernels():
    """``--wide``: the backward of head dims above 128, float32's in
    ``flash_attention_bwd_wide.cu``, bf16's in ``flash_attention_wide.cu``;
    the same entry points in an earlier ``flash_attention_wide.cu``; timed at
    the ``--latent_dim 2048`` training and serving shapes, one 512-wide
    head, S = 4096 and S = 500 at Dh 256, each a wide head dim."""
    from flexdm_tpu_torch.ops import attention as attn
    from tools import torch_bwd_bf16_bench as bench

    parent = "parent=build/parent/flexdm_tpu_torch/csrc/flash_attention_wide.cu"
    args = bench.parse_args(["--dtype", "float32", "--wide", "--other",
                             parent, "--steps", "--turns", "4"])
    assert (args.dtype, args.wide, args.other, args.steps, args.turns) == (
        "float32", True, [parent], True, 4)
    assert not bench.parse_args([]).wide
    assert bench.library("float32", wide=True) == attn.BWD_WIDE_LIBRARY
    assert attn.BWD_WIDE_LIBRARY == ("flexdm_attention_bwd_wide",
                                     ("flash_attention_bwd_wide.cu",))
    assert bench.library("bfloat16", wide=True) == attn.WIDE_LIBRARY
    assert bench.entries("float32") == bench.ENTRIES["float32"]
    assert bench.entries("float32", wide=True) == (
        "flexdm_flash_attention_bwd_dq_wide",
        "flexdm_flash_attention_bwd_dkv_wide")
    assert bench.entries("bfloat16", wide=True) == (
        "flexdm_flash_attention_bwd_dq_wide_bf16",
        "flexdm_flash_attention_bwd_dkv_wide_bf16")
    assert bench.WIDE_SHAPES == ((256, 8, 50, 256), (256, 1, 50, 512),
                                 (8, 8, 50, 256), (1, 2, 4096, 256),
                                 (64, 8, 500, 256))
    assert all(attn.head_dim_plan(s[3]).wide for s in bench.WIDE_SHAPES)
    assert bench.WIDE_LATENT // 8 == 256


def test_bwd_bench_split_floors_are_a_hand_count():
    """The split-TF32 floors at (256, 8, 50, 256): a product is
    2 x 2048 x 50^2 x 256 = 2.62144 GFLOP, dq 3 of them and dk/dv 4, each
    three TF32 products: 23.59 and 31.46 GFLOP, 0.0477 and 0.0636 ms at 495
    TFLOP/s; with S padded to 64 (64^2 / 50^2 = 1.6384x) 0.0781 and 0.1041
    ms."""
    from tools import torch_bwd_bf16_bench as bench

    product = 2 * 2048 * 50 ** 2 * 256
    assert product == 2_621_440_000
    got = bench.split_floors((256, 8, 50, 256))
    for part, n in (("dq", 3), ("dkv", 4)):
        assert got[part]["split_floor_ms"] == pytest.approx(
            3 * n * product / 495e12 * 1e3, rel=1e-12)
        assert got[part]["split_floor_padded_ms"] == pytest.approx(
            3 * n * product * 64 ** 2 / 50 ** 2 / 495e12 * 1e3, rel=1e-12)
    assert got["dq"]["split_floor_ms"] == pytest.approx(0.0477, abs=1e-4)
    assert got["dkv"]["split_floor_ms"] == pytest.approx(0.0636, abs=1e-4)
    assert got["dq"]["split_floor_padded_ms"] == pytest.approx(0.0781,
                                                               abs=1e-4)
    assert got["dkv"]["split_floor_padded_ms"] == pytest.approx(0.1041,
                                                                abs=1e-4)
    # A whole number of items pads nothing.
    whole = bench.split_floors((1, 2, 4096, 256))
    assert whole["dq"]["split_floor_ms"] == \
        whole["dq"]["split_floor_padded_ms"]


def test_wide_bwd_phases_instruments_the_current_source():
    """``tools/torch_wide_bwd_phases.py``: every probe finds its place in
    ``csrc/flash_attention_bwd_wide.cu`` with its chunk pipeline
    ``csrc/wide_tf32.cuh`` inlined (a probe whose place is gone, in either,
    raises), the shapes parse (Dh above 128 only), and each warpgroup's
    shares of its cycles add up to 1."""
    from flexdm_tpu_torch.ops import _build
    from tools import torch_wide_bwd_phases as tool

    source = (_build.CSRC_DIR / "flash_attention_bwd_wide.cu").read_text()
    out = tool.instrumented_source(source)
    # The probes (and the two macros' definitions).
    assert out.count("PHASE_T0(") == 19 and out.count("PHASE_ADD(") == 21
    assert out.count("PHASE_WRITE();") == 4  # 2 kernels x 2 warpgroups
    assert 'extern "C" int wide_phase_cycles' in out
    header = (_build.CSRC_DIR / "wide_tf32.cuh").read_text()
    assert tool.instrumented_source(source, header) == out
    with pytest.raises(ValueError):
        tool.instrumented_source(source, header.replace(
            "mbar_arrive(&bar.full[r])", "mbar_arrive(bar.full + r)"))
    with pytest.raises(ValueError):
        tool.instrumented_source(source.replace(
            "blk.release(lt, free_tile, 0)", "blk.release(lt, free_tile, 1)"))
    assert tool.parse_args([]).shape == tool.SHAPES
    assert tool.parse_args(["--shape", "8,8,50,256"]).shape == (
        (8, 8, 50, 256),)
    for bad in (["--shape", "8,8,50,128"], ["--shape", "8,8,50"]):
        with pytest.raises(SystemExit):
            tool.parse_args(bad)
    cycles = [0.0] * 32
    for slot, value in ((0, 10), (1, 30), (2, 5), (3, 15), (4, 4), (5, 20),
                        (6, 1), (7, 100), (16, 10), (17, 5), (18, 5),
                        (19, 50)):
        cycles[slot] = float(value)
    got = tool.shares(cycles)
    assert got["issue"] == pytest.approx(0.2)  # 30 - 10 of 100
    assert got["consumer_rest"] == pytest.approx(0.25)
    assert got["split_rest"] == pytest.approx(0.6)
    assert sum(v for k, v in got.items() if k in (
        "wait_full", "issue", "wgmma_wait", "release", "ds", "second",
        "tile_end", "consumer_rest")) == pytest.approx(1.0)


def test_wide_bwd_phases_refuses_to_run_without_a_card():
    proc = run_tool("torch_wide_bwd_phases.py")
    assert proc.returncode != 0
    assert "this tool needs one GPU" in proc.stderr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_bench_refuses_to_run_without_a_card(dtype):
    proc = run_tool("torch_bwd_bf16_bench.py", "--dtype", dtype)
    assert proc.returncode != 0
    assert "this bench needs one GPU" in proc.stderr


def test_fwd_bench_parses_its_arguments():
    """``tools/torch_fwd_bench.py``: float32 by default, the parent's file
    as ``--other``, the bf16 mode kept; the float32 shapes of the A/B: the
    aims' shapes, the baselines' causal one, a rank's shapes, then
    crello_scaled's Dh = 64 one."""
    from tools import torch_fwd_bench as bench

    parent = "parent=build/parent/flexdm_tpu_torch/csrc/flash_attention_fwd.cu"
    args = bench.parse_args(["--other", parent, "--steps", "--turns", "4",
                             "--sass-out", "build/sass"])
    assert (args.dtype, args.other, args.steps, args.turns,
            args.sass_out) == ("float32", [parent], True, 4,
                               "build/sass")
    default = bench.parse_args([])
    assert (default.dtype, default.other, default.steps, default.turns,
            default.sass_out) == ("float32", [], False, 2, None)
    assert bench.parse_args(["--dtype", "bfloat16"]).dtype == "bfloat16"
    assert bench.ENTRIES == {"float32": "flexdm_flash_attention_fwd",
                             "bfloat16": "flexdm_flash_attention_fwd_bf16"}
    assert bench.SOURCES["float32"] == "flash_attention_fwd.cu"
    assert bench.CASES["float32"] == (
        ((8, 8, 50, 32), False), ((256, 8, 50, 32), False),
        ((8, 8, 650, 32), False), ((64, 8, 500, 32), False),
        ((256, 8, 500, 32), False), ((64, 8, 50, 32), True),
        ((128, 8, 50, 32), False), ((256, 4, 50, 32), False),
        ((32, 8, 500, 32), False), ((64, 4, 50, 32), False),
        ((64, 4, 50, 32), True), ((2048, 8, 50, 64), False))
    for bad in (["--dtype", "float16"], ["--other", "parent"]):
        with pytest.raises(SystemExit):
            bench.parse_args(bad)


def test_fwd_bench_takes_the_wide_kernels():
    """``--wide``: the forward of head dims above 128 in either dtype, both
    in ``flash_attention_fwd_wide.cu`` under the entry points the parent's
    ``flash_attention_wide.cu`` had; checked and timed at the backward
    bench's ``WIDE_SHAPES``, none causal; ``--steps`` takes the wide flag to
    the ``--latent_dim 2048`` step; ``--eval`` (the narrow float32 forward's
    swap) is refused beside it; a thread forms 16 scores a float32 key tile
    (32 keys) and 32 a bf16 one (64 keys)."""
    from flexdm_tpu_torch.ops import attention as attn
    from tools import torch_bwd_bf16_bench
    from tools import torch_fwd_bench as bench

    parent = "parent=build/parent/flexdm_tpu_torch/csrc/flash_attention_wide.cu"
    for dtype in ("float32", "bfloat16"):
        args = bench.parse_args(["--dtype", dtype, "--wide", "--other",
                                 parent, "--steps", "--turns", "4"])
        assert (args.dtype, args.wide, args.other, args.steps, args.turns,
                args.eval) == (dtype, True, [parent], True, 4, False)
        assert bench.cases(dtype, wide=True) == tuple(
            (shape, False) for shape in torch_bwd_bf16_bench.WIDE_SHAPES)
        assert bench.cases(dtype) == bench.CASES[dtype]
        bf16 = dtype == "bfloat16"
        assert bench.WIDE_ENTRIES[dtype] == attn._symbol("fwd", bf16, True)
    assert not bench.parse_args([]).wide
    assert bench.WIDE_SOURCE == "flash_attention_fwd_wide.cu"
    assert attn.FWD_WIDE_LIBRARY == ("flexdm_attention_fwd_wide",
                                     (bench.WIDE_SOURCE,))
    assert attn.FWD_WIDE_LIBRARY in attn.LIBRARIES
    assert len(attn.LIBRARIES) == 7
    assert [bench.scores_per_pass(d, None, True)
            for d in ("float32", "bfloat16")] == [16, 32]
    for bad in (["--wide", "--eval"], ["--dtype", "bfloat16", "--wide",
                                       "--eval"]):
        with pytest.raises(SystemExit):
            bench.parse_args(bad)


def test_fwd_bench_floors_are_a_hand_count(monkeypatch):
    """The split-TF32 tensor floor: 3 x (2 products of 2 S^2 Dh FLOPs) a
    head, 3 x 16.384 GFLOP at (64, 8, 500, 32), 0.0993 ms at 495 TFLOP/s;
    the causal case's bound counts the band's (S + 1) / 2S of the products
    and of the exponentials, its split floor every tile; a thread forms 32
    scores a float32 key tile at Dh = 32 (16 at Dh = 64, 8 at Dh = 128), 32
    a bf16 one."""
    from tools import torch_fwd_bench as bench

    chip_smoke = bench.chip_smoke
    monkeypatch.setattr(chip_smoke, "card_sm_rate", lambda: (132, 1980.0))
    assert bench.split_floor_ms((64, 8, 500, 32)) == pytest.approx(
        3 * 16.384e9 / 495e12 * 1e3, rel=1e-12)
    assert bench.split_floor_ms((64, 8, 500, 32)) == pytest.approx(0.0993,
                                                                  abs=1e-4)
    flat = bench.case_bounds((64, 8, 500, 32), False, "float32")
    assert flat["bound_by"] == "bytes"
    assert flat["bound_ms"] == pytest.approx(
        (4 * 4 * 64 * 8 * 500 * 32 + 4 * 3 * 64 * 8 * 500 + 64 * 500)
        / 3.35e12 * 1e3, rel=1e-12)
    assert flat["exp_floor_ms"] == pytest.approx(0.0306, abs=1e-4)
    causal = bench.case_bounds((64, 8, 50, 32), True, "float32")
    rows = 64 * 8 * 50
    assert causal["bound_ms"] == pytest.approx(
        max((16 * rows * 32 + 12 * rows + 64 * 50) / 3.35e12,
            4 * 64 * 8 * 50 * 50 * 32 * (51 / 100) / 495e12) * 1e3,
        rel=1e-12)
    assert causal["exp_floor_ms"] == pytest.approx(
        64 * 8 * 50 * 51 / 2 / (16 * 132 * 1980e6) * 1e3, rel=1e-12)
    assert causal["split_floor_ms"] == bench.split_floor_ms((64, 8, 50, 32))
    assert "split_floor_ms" not in bench.case_bounds((64, 8, 500, 32), False,
                                                     "bfloat16")
    assert [bench.scores_per_pass(d, dh) for d, dh in (
        ("float32", 32), ("float32", 64), ("float32", 128),
        ("bfloat16", 32))] == [32, 16, 8, 32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_attention_takes_a_wide_shape(dtype):
    """``--shape 256,8,50,256`` (crello Ours-EXP at ``--latent_dim 2048``):
    the shape's four sizes, the wide kernels' names, and the bound at the
    true Dh: q, k, v, O of 26,214,400 elements, lse, m, l 102,400 float32
    rows, a 12,800-byte mask; 2 products of 2 * 2048 * 50^2 * 256 FLOPs."""
    from flexdm_tpu_torch.ops import attention as attn

    args = torch_bench_attention.parse_args(["--shape", "256,8,50,256",
                                             "--dtype", dtype])
    assert (args.b, args.h, args.s, args.dh) == (256, 8, 50, 256)
    item, peak = (4, 495e12) if dtype == "float32" else (2, 989.4e12)
    suffix = "_bf16" * (dtype == "bfloat16")
    assert attn.instance_names(getattr(torch, dtype), args.dh) == tuple(
        f"{k}_wide{suffix}" for k in ("fwd", "dq", "dkv"))
    got = torch_bench_attention.bounds(*args.shape, dtype)["fwd"]
    nbytes = 4 * 26_214_400 * item + 3 * 102_400 * 4 + 12_800
    flops = 2 * 2 * 2048 * 50 ** 2 * 256
    assert got["bound_ms"] == pytest.approx(
        max(nbytes / 3.35e12, flops / peak) * 1e3, rel=1e-12)
    with pytest.raises(SystemExit):
        torch_bench_attention.parse_args(["--shape", "256,8,50"])


def test_fwd_bench_refuses_to_run_without_a_card():
    proc = run_tool("torch_fwd_bench.py")
    assert proc.returncode != 0
    assert "this bench needs one GPU" in proc.stderr


def test_kernel_repeats_parses_its_arguments():
    """``tools/torch_kernel_repeats.py``: the two-stream shapes (Dh 32, 48
    and the padded 25) and the one-stream controls by default, shapes and
    builds of the float32 backward from the command line."""
    from tools import torch_kernel_repeats as tool

    args = tool.parse_args(["--repeats", "10", "--dq-repeats", "20",
                            "--shape", "33,8,70,32", "--other",
                            "one_stream=build/variants/one_stream.cu"])
    assert (args.repeats, args.dq_repeats, args.shape, args.other) == (
        10, 20, ((33, 8, 70, 32),),
        ["one_stream=build/variants/one_stream.cu"])
    default = tool.parse_args([])
    assert (default.repeats, default.dq_repeats, default.shape,
            default.other) == (3000, 12000, tool.SHAPES, [])
    assert tool.SHAPES[:3] == ((33, 8, 70, 32), (33, 8, 70, 48),
                               (33, 8, 70, 25))
    for bad in (["--shape", "33,8,70"], ["--shape", "0,8,70,32"],
                ["--other", "one_stream"]):
        with pytest.raises(SystemExit):
            tool.parse_args(bad)


def test_kernel_repeats_takes_a_wide_shape():
    """A head dim above 128 from the command line: the wide kernels are
    the instances it repeats."""
    from flexdm_tpu_torch.ops import attention as attn
    from tools import torch_kernel_repeats as tool

    args = tool.parse_args(["--shape", "8,8,50,256", "--shape",
                            "2,4,500,129"])
    assert args.shape == ((8, 8, 50, 256), (2, 4, 500, 129))
    assert [attn.instance_names(torch.float32, s[3]) for s in args.shape] \
        == [("fwd_wide", "dq_wide", "dkv_wide")] * 2


def test_kernel_repeats_refuses_to_run_without_a_card():
    proc = run_tool("torch_kernel_repeats.py", "--repeats", "1")
    assert proc.returncode != 0
    assert "this tool needs one GPU" in proc.stderr


def test_exponential_floor_is_a_hand_count():
    """One exponential a score: 64 x 8 x 500^2 = 128,000,000 in the forward
    at crello_flat's training shape, once more in each backward kernel;
    the causal band's S (S + 1) / 2 a head; over 16 a clock an SM, at 132
    SMs and 1980 MHz, 0.0306 ms."""
    chip_smoke = torch_bench_attention.chip_smoke
    assert chip_smoke.attention_exps((64, 8, 500, 32)) == 128_000_000
    assert chip_smoke.attention_exps((2, 2, 64, 32), causal=True) == \
        4 * 64 * 65 // 2
    got = torch_bench_attention.bounds(64, 8, 500, 32, "bfloat16")
    assert got["fwd"]["exps"] == 128_000_000
    assert got["fwd_bwd"]["exps"] == 3 * 128_000_000
    assert chip_smoke.exp_floor_ms(128_000_000, sms=132, mhz=1980) == \
        pytest.approx(128e6 / (16 * 132 * 1980e6) * 1e3, rel=1e-12)
    assert chip_smoke.exp_floor_ms(128_000_000, sms=132, mhz=1980) == \
        pytest.approx(0.0306, abs=1e-4)


def test_bin_scripts_train_and_evaluate(crello_dir, tmp_path):
    job = str(tmp_path / "job")
    env = dict(os.environ, DATA_DIR=crello_dir, JOB_DIR=job)
    train = subprocess.run(
        ["bash", os.path.join(ROOT, "bin", "train_flexdm_torch.sh"),
         "crello", "--preset", "crello_ours_exp", *TINY], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert train.returncode == 0, train.stderr[-4000:]
    assert f"JOB_DIR={job}" in train.stdout and "test metrics:" in \
        train.stdout
    with open(os.path.join(job, "args.json")) as f:
        assert json.load(f)["data_dir"] == crello_dir
    scores = str(tmp_path / "scores.csv")
    evaluate = subprocess.run(
        ["bash", os.path.join(ROOT, "bin", "eval_flexdm_torch.sh"),
         "--job-dir", job, "--task_mode", "pos", "--batch_size", "8",
         "--device", "cpu", "--result_csv", scores], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert evaluate.returncode == 0, evaluate.stderr[-4000:]
    assert os.path.exists(scores)
