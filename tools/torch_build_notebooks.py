"""Generate the port's demo notebooks (single source of truth).

    python tools/torch_build_notebooks.py

Counterpart of ``tools/build_notebooks.py`` for ``flexdm_tpu_torch``: the
same walkthroughs (``notebooks/demo_crello_torch.ipynb``,
``notebooks/demo_rico_torch.ipynb``), cell for cell, on the port —
editable parameters, a toy bootstrap on synthetic data when no trained
job is given, dataset/model loading, hand-built per-task masks from
``get_initial_masks`` and the attribute groups, GT/input/prediction SVG
grids, MaskGIT decoding, retrieval and the eval harness.  The cells import
only ``flexdm_tpu_torch``.  The model runs on ``FLEXDM_DEVICE`` (default
``cuda``, the attention kernels; ``cpu`` on request), with no fallback.
The notebook JSON (nbformat 4.5) is written here without ``nbformat``,
which the card's machine lacks; ``python -m flexdm_tpu_torch.utils.notebook
<notebook>`` runs one there without Jupyter.
"""

import hashlib
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source(text):
    return text.splitlines(keepends=True)


def _nb(name, cells):
    """The notebook's JSON text, as ``nbformat.write`` lays it out; cell
    ids from the notebook's name and the cell's index, so a rebuild writes
    the same bytes."""
    out = []
    for i, (kind, src) in enumerate(cells):
        cell = {"cell_type": "markdown" if kind == "md" else "code",
                "id": hashlib.sha1(f"{name}:{i}".encode()).hexdigest()[:8],
                "metadata": {}, "source": _source(src)}
        if kind != "md":
            cell.update(execution_count=None, outputs=[])
        out.append(cell)
    nb = {"cells": out,
          "metadata": {"kernelspec": {"display_name": "Python 3",
                                      "language": "python",
                                      "name": "python3"}},
          "nbformat": 4, "nbformat_minor": 5}
    return json.dumps(nb, indent=1, sort_keys=True, ensure_ascii=False) + "\n"


GRID_HELPER = '''\
def show_grid(column_names, *item_lists):
    """Render documents side by side, one row per sample (HTML inline)."""
    print("From left to right: " + ", ".join(column_names))
    for docs in zip(*item_lists):
        display(HTML("<div>%s</div>" % " ".join(docs)))'''

IMPORTS = '''\
import numpy as np
import torch
from IPython.display import HTML, display

from flexdm_tpu_torch.data import synthetic
from flexdm_tpu_torch.demo import load_model, masked_input_view
from flexdm_tpu_torch.helpers import SVGBuilder
from flexdm_tpu_torch.models import forward_eval
from flexdm_tpu_torch.models.masking import get_initial_masks, get_seq_mask
from flexdm_tpu_torch.train.trainer import to_device

if torch.device(DEVICE).type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device: set FLEXDM_DEVICE=cpu to run this "
                       "notebook on the CPU")


def to_host(tensors):
    """Device tensors -> numpy (a bf16 model's floats as float32)."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in tensors.items()}'''


def _bootstrap(dataset, seed):
    return f'''\
if not os.path.exists(os.path.join(JOB_DIR, "args.json")):
    from flexdm_tpu_torch.config import TrainConfig
    from flexdm_tpu_torch.train.trainer import train

    synthetic.generate("{dataset}", DATA_DIR, 48, 8, 8, seed={seed})
    train(TrainConfig(
        dataset_name="{dataset}", data_dir=DATA_DIR, job_dir=JOB_DIR,
        latent_dim=32, num_blocks=1, num_heads=1, batch_size=8,
        num_epochs=2, validation_freq=1, device=DEVICE,
    ))'''


BOOTSTRAP_MD = (
    "##### Bootstrap (synthetic toy run when no trained job exists)\n"
    "Skipped entirely when `JOB_DIR` already holds a trained job "
    "(`args.json` + `checkpoints/*.torch.npz`).  One head of 32: the "
    "attention kernels take head dims 32, 64 and 128.")

LOAD = '''\
model, dataspec = load_model(JOB_DIR, batch_size=batch_size, device=DEVICE)
schema = dataspec.schema
example_host = next(iter(dataspec.make_dataset("test", batch_size=batch_size)))
example = to_device(example_host, DEVICE)'''


CRELLO_CELLS = [
    ("md", "# Crello analysis\n"
     "Qualitative analysis of learned models on the crello dataset — the "
     "flexdm_tpu_torch (PyTorch port) counterpart of the reference "
     "`notebooks/demo_crello.ipynb` walkthrough: per-task masked-field "
     "prediction (`elem`, `pos`, `attr`, `img`, `txt`) with hand-built "
     "masks, rendered as side-by-side SVG grids, plus MaskGIT iterative "
     "decoding and asset retrieval."),
    ("md", "##### Editable parameters\n"
     "Point `JOB_DIR`/`DATA_DIR` at a real training run of the port and a "
     "data release. With the defaults, the next section bootstraps a toy "
     "model on synthetic data so every cell below runs end-to-end. The "
     "model runs on `DEVICE`: the card (`cuda`, the attention kernels) "
     "unless `FLEXDM_DEVICE=cpu` asks for the CPU."),
    ("code", '''\
import os
import tempfile

TMP = os.path.join(tempfile.gettempdir(), "flexdm_demo_crello_torch")
JOB_DIR = os.environ.get("FLEXDM_JOB_DIR", os.path.join(TMP, "job"))
DATA_DIR = os.environ.get("FLEXDM_DATA_DIR", os.path.join(TMP, "data"))
DEVICE = os.environ.get("FLEXDM_DEVICE", "cuda")
batch_size = 4
target_task = "pos"  # choose from: elem, pos, attr, txt, img'''),
    ("md", "##### Initialization"),
    ("code", IMPORTS),
    ("md", BOOTSTRAP_MD),
    ("code", _bootstrap("crello", 0)),
    ("md", "##### Load dataset and pre-trained model"),
    ("code", LOAD),
    ("md", "##### Build visualizers\n"
     "`layout` colors elements by type; `visual` additionally renders text "
     "(and, with the retrieval stores below, real images/texts)."),
    ("code", '''\
type_vocab = dataspec.vocabs["type"].tokens if "type" in dataspec.vocabs else None
builders = {
    "layout": SVGBuilder(key="type", vocab=type_vocab,
                         max_width=128, max_height=192),
    "visual": SVGBuilder(key="type", vocab=type_vocab, render_text=True,
                         max_width=128, max_height=192),
}'''),
    ("md", "##### Build per-task masks by hand\n"
     "Masks start from `get_initial_masks` (all-False element masks). For a "
     "group task every field in the attribute group is masked across the "
     "whole sequence; for `elem` every field of one chosen element is "
     "masked (the reference hides element 0)."),
    ("code", '''\
seq_mask = get_seq_mask(example["length"], schema.max_length)
mfp_masks = get_initial_masks(schema, seq_mask)
attr_groups = schema.attribute_groups

for key in list(mfp_masks):
    if not schema[key].is_sequence:
        continue
    if target_task == "elem":
        mask = mfp_masks[key].clone()
        mask[:, 0] = True  # hide the first element of every sample
        mfp_masks[key] = mask
    elif key != "type" and key in attr_groups[target_task]:
        mfp_masks[key] = seq_mask

{k: int(v.sum()) for k, v in mfp_masks.items()}'''),
    ("md", "##### Demo\n"
     "Run the model with the hand-built masks and render ground truth, the "
     "model's-eye masked input, and the prediction side by side.  Unmasked "
     "fields pass through from the input "
     "(`merge_inputs_and_prediction`), so only masked fields change."),
    ("code", '''\
pred = forward_eval(model, example, mfp_masks)
pred = {**{k: v for k, v in example.items() if k not in pred}, **pred}

gt_items = dataspec.unbatch(example_host)
input_items = dataspec.unbatch(
    to_host(masked_input_view(schema, example, mfp_masks)))
pred_items = dataspec.unbatch(to_host(pred))

show_cols = ["gt-layout", "gt-visual", "input", "pred"]
show_grid(
    show_cols,
    [builders["layout"](x) for x in gt_items],
    [builders["visual"](x) for x in gt_items],
    [builders["visual"](x) for x in input_items],
    [builders["visual"](x) for x in pred_items],
)'''.replace("show_grid(", GRID_HELPER + "\n\nshow_grid(", 1)),
    ("md", "##### MaskGIT iterative decoding\n"
     "`num_iter > 1` re-masks low-confidence fields and decodes in rounds "
     "(reference `mfp.py:141-207`)."),
    ("code", '''\
pred_it = forward_eval(model, example, mfp_masks, num_iter=4)
pred_it = {**{k: v for k, v in example.items() if k not in pred_it}, **pred_it}
pred_it_items = dataspec.unbatch(to_host(pred_it))
show_grid(
    ["pred (1 iter)", "pred (4 iters)"],
    [builders["visual"](x) for x in pred_items],
    [builders["visual"](x) for x in pred_it_items],
)'''),
    ("md", "##### Image/text retrieval\n"
     "With the `crello-images` / `crello-texts` stores from the data "
     "release, predicted 512-d embeddings map back to real assets "
     "(brute-force exact top-1 — no faiss dependency). Skipped when the "
     "stores are absent."),
    ("code", '''\
images_dir = os.path.join(os.path.dirname(DATA_DIR), "crello-images")
texts_dir = os.path.join(os.path.dirname(DATA_DIR), "crello-texts")
if os.path.exists(images_dir) and os.path.exists(texts_dir):
    from flexdm_tpu_torch.helpers import ImageRetriever, TextRetriever

    image_db = ImageRetriever(images_dir, image_path=os.path.join(images_dir, "images"))
    image_db.build("test")
    text_db = TextRetriever(texts_dir, text_path=os.path.join(texts_dir, "texts"))
    text_db.build("test")
    visual_builder = SVGBuilder(
        key="type", vocab=type_vocab, render_text=True,
        image_db=image_db, text_db=text_db,
        max_width=128, max_height=192)
    show_grid(["pred with retrieved assets"],
              [visual_builder(x) for x in pred_items])
else:
    print("retrieval stores not found; skipping (see README for the release)")'''),
]


RICO_CELLS = [
    ("md", "# Rico analysis\n"
     "UI-layout (rico) counterpart of the reference "
     "`notebooks/demo_rico.ipynb`, on the PyTorch port: single-element "
     "filling (ELEM) — mask every field of one element and let the model "
     "reconstruct it — plus the `pos` group task on sorted scoring's home "
     "dataset."),
    ("md", "##### Editable parameters\n"
     "The model runs on `DEVICE`: the card (`cuda`) unless "
     "`FLEXDM_DEVICE=cpu` asks for the CPU."),
    ("code", '''\
import os
import tempfile

TMP = os.path.join(tempfile.gettempdir(), "flexdm_demo_rico_torch")
JOB_DIR = os.environ.get("FLEXDM_RICO_JOB_DIR", os.path.join(TMP, "job"))
DATA_DIR = os.environ.get("FLEXDM_RICO_DATA_DIR", os.path.join(TMP, "data"))
DEVICE = os.environ.get("FLEXDM_DEVICE", "cuda")
batch_size = 4'''),
    ("md", "##### Initialization"),
    ("code", IMPORTS),
    ("md", BOOTSTRAP_MD),
    ("code", _bootstrap("rico", 1)),
    ("md", "##### Load dataset and model"),
    ("code", LOAD + '''

type_vocab = dataspec.vocabs["type"].tokens if "type" in dataspec.vocabs else None
builder = SVGBuilder(key="type", vocab=type_vocab, max_width=108, max_height=192)'''),
    ("md", "##### ELEM: hand-built masks hiding one element\n"
     "All-False initial masks, then element 0 of every sample is masked in "
     "every field (mirrors the reference demo cell)."),
    ("code", '''\
seq_mask = get_seq_mask(example["length"], schema.max_length)
mfp_masks = get_initial_masks(schema, seq_mask)
for key in list(mfp_masks):
    if schema[key].is_sequence:
        mask = mfp_masks[key].clone()
        mask[:, 0] = True
        mfp_masks[key] = mask'''),
    ("md", "##### Demo: reconstruct the hidden element"),
    ("code", GRID_HELPER + '''


pred = forward_eval(model, example, mfp_masks)
pred = {**{k: v for k, v in example.items() if k not in pred}, **pred}

gt_items = dataspec.unbatch(example_host)
input_items = dataspec.unbatch(
    to_host(masked_input_view(schema, example, mfp_masks)))
pred_items = dataspec.unbatch(to_host(pred))
show_grid(
    ["gt", "input (element hidden)", "pred"],
    [builder(x) for x in gt_items],
    [builder(x) for x in input_items],
    [builder(x) for x in pred_items],
)'''),
    ("md", "##### POS: predict all element geometry\n"
     "rico's quantitative protocol scores `pos` on lexicographically sorted "
     "elements (reference `eval.py:104-106`); the demo just renders the "
     "reconstruction."),
    ("code", '''\
pos_masks = get_initial_masks(schema, seq_mask)
for key in schema.attribute_groups["pos"]:
    pos_masks[key] = seq_mask
pred_pos = forward_eval(model, example, pos_masks)
pred_pos = {**{k: v for k, v in example.items() if k not in pred_pos}, **pred_pos}
pred_pos_items = dataspec.unbatch(to_host(pred_pos))
show_grid(
    ["gt", "pred-layout"],
    [builder(x) for x in gt_items],
    [builder(x) for x in pred_pos_items],
)'''),
    ("md", "##### Quantitative check\n"
     "The same masks drive the eval harness; scores are exact dataset-level "
     "Σnum/Σden (see `python -m flexdm_tpu_torch.evaluation --task_mode "
     "all_feat`)."),
    ("code", '''\
from flexdm_tpu_torch.evaluation.harness import evaluate_task

scores = evaluate_task(
    model, dataspec.make_dataset("test", batch_size=batch_size),
    "pos", ("pos", schema.attribute_groups["pos"]))
scores'''),
]

NOTEBOOKS = {"demo_crello_torch.ipynb": CRELLO_CELLS,
             "demo_rico_torch.ipynb": RICO_CELLS}


def main():
    for name, cells in NOTEBOOKS.items():
        path = os.path.join(HERE, "notebooks", name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(_nb(name, cells))
        print(f"wrote {path} ({len(cells)} cells)")


if __name__ == "__main__":
    main()
