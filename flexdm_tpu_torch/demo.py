"""Demo inference: the notebook workflow as a script.

Counterpart of ``flexdm_tpu/demo.py`` (the reference's
``notebooks/demo_crello.ipynb`` / ``demo_rico.ipynb`` +
``notebooks/util.py``): load a trained job (:func:`load_model`), build
per-task masks (:func:`build_task_masks`), run the model with those masks
on the device, and render ground-truth / masked-input / prediction
documents side by side as SVG into a single HTML page (:func:`run_demo`).

Usage::

    python -m flexdm_tpu_torch.demo --job-dir /path/to/job --task pos \\
        --num-examples 4 --out demo.html [--device cpu]

Not carried over: the JAX demo's packed float32 transport and its jit
wrapping of the device work, which exist for the TPU's host-device relay.
Here the batch goes to the device once and the outputs come back once.
"""

from __future__ import annotations

import argparse
import html
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .config import TrainConfig, build_model
from .convert import load_weights
from .data import DatasetSpec
from .evaluation.harness import _group_masks, task_id_for_mode
from .helpers.svg import SVGBuilder, load_fonts_css
from .models.masking import (
    apply_token,
    filter_padding,
    get_initial_masks,
    get_seq_mask,
    one_hot,
    select_single_element,
)
from .models.mfp import forward_eval
from .train.trainer import to_device


def load_model(job_dir: str, checkpoint: str = "best", batch_size: int = 8,
               device="cuda", data_dir: Optional[str] = None):
    """Rebuild a job's model from ``args.json`` and its port weights file;
    returns ``(model, spec)`` with the model on ``device`` in eval mode.
    ``data_dir`` overrides the data dir that ``args.json`` records (a job
    moved to another machine)."""
    with open(os.path.join(job_dir, "args.json")) as f:
        config = TrainConfig.from_args(json.load(f))
    spec = DatasetSpec(config.dataset_name, data_dir or config.data_dir,
                       batch_size)
    model = build_model(config, spec.schema)
    load_weights(
        os.path.join(job_dir, "checkpoints", f"{checkpoint}.torch.npz"), model
    )
    return model.to(device).eval(), spec


def build_task_masks(schema, batch, task: str,
                     generator: Optional[torch.Generator] = None,
                     element: Optional[torch.Tensor] = None):
    """Masks for a task: ``elem`` masks one element per document, a group
    task masks its fields across all elements.

    ``element`` (elem only): a (B,) int tensor of element indices to mask
    instead of a random draw, intersected with the valid elements.  The
    random draw takes its uniforms from ``generator`` (a CPU generator;
    seed 0 when None).
    """
    seq_mask = get_seq_mask(batch["length"], schema.max_length)
    if task != "elem":
        return _group_masks(schema, batch, schema.attribute_groups[task])
    masks = get_initial_masks(schema, seq_mask)
    if element is not None:
        selected = one_hot(element, schema.max_length, torch.bool) & seq_mask
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = torch.rand(seq_mask.shape[0], generator=generator)
        selected = select_single_element(seq_mask, u)
    for c in schema.modeled:
        if c.is_sequence:
            masks[c.name] = selected
    return masks


def masked_input_view(schema, batch, masks) -> Dict[str, torch.Tensor]:
    """The model's-eye view of the document (the page's middle column):
    padding and ruled-out slots [NULL], masked fields [MASK]."""
    seq_mask = get_seq_mask(batch["length"], schema.max_length)
    filtered = filter_padding(batch, schema, seq_mask)
    out = dict(batch)
    for c in schema.modeled:
        if c.is_sequence:
            out[c.name] = apply_token(filtered[c.name], c, masks[c.name],
                                      "masked")
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: a bf16 model's floats cross as float32 (exact).
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in tensors.items()}


def run_demo(
    job_dir: str,
    task: str = "pos",
    num_examples: int = 4,
    num_iter: int = 1,
    out_path: str = "demo.html",
    checkpoint: str = "best",
    split: str = "test",
    data_dir_override: Optional[str] = None,
    timings: Optional[Dict[str, float]] = None,
    element: Optional[int] = None,
    device="cuda",
    outputs: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
) -> str:
    """Render GT / masked-input / prediction rows to ``out_path``.

    ``timings``: pass a dict to receive the wall time of each stage in
    seconds (``load_model``, ``load_batch``, ``forward_eval``, ``unbatch``,
    ``svg_html``).  ``element`` (elem task only): pin which element index
    is masked in every example instead of the random draw.  ``outputs``:
    pass a dict to receive, before rendering, as numpy arrays: the host
    ``batch``, the ``masks``, the masked-input ``view``, the model's
    ``pred`` (logits where masked, ground truth merged back) and, under
    MaskGIT, its ``rounds`` (per round the fields' ``confidence`` and the
    ``threshold``; empty for one pass).  The forward runs on ``device``;
    there is no fallback to another.
    """
    if element is not None and task != "elem":
        raise ValueError(
            f"element= is only valid for task='elem', got {task!r}"
        )
    t0 = time.perf_counter()

    def _tick(stage):
        nonlocal t0
        now = time.perf_counter()
        if timings is not None:
            timings[stage] = round(now - t0, 3)
        t0 = now

    model, spec = load_model(job_dir, checkpoint, batch_size=num_examples,
                             device=device, data_dir=data_dir_override)
    schema = spec.schema
    _tick("load_model")

    host = next(iter(spec.make_dataset(split, batch_size=num_examples)))
    _tick("load_batch")

    with torch.inference_mode():
        batch = to_device(host, device)
        n = batch["length"].shape[0]
        elem_idx = None
        if element is not None:
            elem_idx = torch.full((n,), element, dtype=torch.int64,
                                  device=device)
        masks = build_task_masks(schema, batch, task, element=elem_idx)
        view = masked_input_view(schema, batch, masks)
        tasks = None
        if getattr(model, "context", None) == "id":
            # Condition the task embedding on the demoed task
            # (reference eval.py:99-101; notebooks pass demo_args["tasks"]).
            tasks = torch.full((n,), task_id_for_mode(schema, task),
                               dtype=torch.int32, device=device)
        rounds = []
        pred = forward_eval(model, batch, masks, tasks=tasks,
                            num_iter=num_iter, rounds=rounds)
        view, pred = _to_numpy(view), _to_numpy(pred)
    _tick("forward_eval")
    if outputs is not None:
        outputs.update(
            batch=host, masks=_to_numpy(masks), view=view, pred=pred,
            rounds=[{"confidence": _to_numpy(r["confidence"]),
                     "threshold": _host(r["threshold"])} for r in rounds])

    builder = SVGBuilder(
        key="type",
        vocab=spec.vocabs["type"].tokens if "type" in spec.vocabs else None,
        max_width=180,
        max_height=180,
        render_text=True,
        # The crello release ships fonts.css (@font-face links); when
        # present in the data dir every rendered SVG embeds the real fonts
        # (reference svg_crello.py:130-147).
        fonts_css=load_fonts_css(spec.path) if spec.path else None,
    )
    gt_items = spec.unbatch(host)
    in_items = spec.unbatch(view)
    pred_items = spec.unbatch(pred)
    _tick("unbatch")

    rows = []
    for gt, inp, pr in zip(gt_items, in_items, pred_items):
        cells = "".join(
            f"<td>{builder(doc)}</td>" for doc in (gt, inp, pr)
        )
        rows.append(f"<tr>{cells}</tr>")
    page = (
        "<html><head><meta charset='utf-8'><title>flexdm demo</title></head>"
        f"<body><h2>task: {html.escape(task)}</h2>"
        "<table border=1 cellpadding=4><tr><th>ground truth</th>"
        "<th>masked input</th><th>prediction</th></tr>"
        + "".join(rows)
        + "</table></body></html>"
    )
    with open(out_path, "w") as f:
        f.write(page)
    _tick("svg_html")
    return out_path


def main(argv=None, timings: Optional[Dict[str, float]] = None,
         outputs: Optional[Dict[str, Dict[str, np.ndarray]]] = None) -> str:
    """The CLI; ``timings`` and ``outputs`` go to :func:`run_demo` for a
    caller that drives it in-process."""
    parser = argparse.ArgumentParser(description="Render demo predictions")
    parser.add_argument("--job-dir", dest="job_dir", required=True)
    parser.add_argument("--task", default="pos",
                        help="elem | type | pos | attr | img | txt")
    parser.add_argument("--num-examples", type=int, default=4)
    parser.add_argument("--num-iter", type=int, default=1)
    parser.add_argument("--out", default="demo.html")
    parser.add_argument("--checkpoint", default="best")
    parser.add_argument("--split", default="test")
    parser.add_argument("--element", type=int, default=None,
                        help="elem task: pin the masked element index "
                             "(default: random per example)")
    parser.add_argument("--data_dir", default=None,
                        help="data dir instead of the one args.json records")
    parser.add_argument("--device", default="cuda",
                        help="device of the forward (cuda or cpu)")
    args = parser.parse_args(argv)
    path = run_demo(
        args.job_dir, args.task, args.num_examples, args.num_iter,
        args.out, args.checkpoint, args.split,
        data_dir_override=args.data_dir, timings=timings,
        element=args.element, device=args.device, outputs=outputs,
    )
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
