"""Synthetic dataset generator.

The port's own copy of ``flexdm_tpu/data/synthetic.py``: the same seed
writes the same records.

Writes a complete crello- or rico-shaped data directory (TFRecord shards +
``count.json`` + ``vocabulary.json``) so the full pipeline — record framing,
proto decode, vocab lookup, binning, batching, training, eval — can be
exercised end-to-end without the real (license-gated) datasets.  The layout
matches what the reference's ``DataSpec`` expects (reference
``src/mfp/mfp/data/spec.py:26-36``).

The generated distributions are crude but structured (element geometry is
correlated with element type) so models have signal to learn and scores move
away from chance in integration tests.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Union

import numpy as np
import yaml

from . import example_proto, tfrecord

CRELLO_TYPES = [
    "svgElement",
    "textElement",
    "imageElement",
    "coloredBackground",
    "maskElement",
    "humanElement",
]
CRELLO_GROUPS = ["socialMedia", "poster", "banner", "card"]
CRELLO_FORMATS = ["instagramPost", "facebookCover", "a4", "story"]
CRELLO_CATEGORIES = ["business", "food", "fashion", "travel", "music"]
CRELLO_CANVAS_WIDTHS = [720, 1080, 1280, 1920]
CRELLO_CANVAS_HEIGHTS = [720, 1080, 1280, 1920]
CRELLO_FONTS = [f"Font{i}" for i in range(12)]

RICO_TYPES = [
    "Text",
    "Image",
    "Icon",
    "Text Button",
    "Toolbar",
    "List Item",
    "Web View",
    "Input",
    "Card",
    "Background Image",
]
RICO_ICONS = [f"icon_{i}" for i in range(10)]
RICO_TEXT_BUTTONS = [f"button_{i}" for i in range(8)]


def _unit(rng: np.random.Generator, dim: int) -> List[float]:
    v = rng.normal(size=dim).astype(np.float32)
    v /= np.linalg.norm(v) + 1e-8
    return [float(x) for x in v]


def _crello_doc(
    rng: np.random.Generator, doc_id: int, num_elements: int = 0
) -> bytes:
    n = num_elements or int(rng.integers(1, 16))
    type_probs = np.array([0.3, 0.3, 0.2, 0.1, 0.05, 0.05])
    context = {
        "id": [f"doc{doc_id:06d}".encode()],
        "length": [n],
        "group": [rng.choice(CRELLO_GROUPS).encode()],
        "format": [rng.choice(CRELLO_FORMATS).encode()],
        "canvas_width": [int(rng.choice(CRELLO_CANVAS_WIDTHS))],
        "canvas_height": [int(rng.choice(CRELLO_CANVAS_HEIGHTS))],
        "category": [rng.choice(CRELLO_CATEGORIES).encode()],
    }
    fl: Dict[str, List] = {
        k: []
        for k in (
            "type left top width height opacity color image_embedding "
            "text_embedding font_family uuid".split()
        )
    }
    for j in range(n):
        t = rng.choice(CRELLO_TYPES, p=type_probs)
        # geometry correlated with type so there is learnable structure
        if t == "coloredBackground":
            left, top, w, h = 0.0, 0.0, 1.0, 1.0
        elif t == "textElement":
            left = float(rng.uniform(0.05, 0.5))
            top = float(rng.uniform(0.05, 0.8))
            w = float(rng.uniform(0.3, 0.9))
            h = float(rng.uniform(0.03, 0.15))
        else:
            left = float(rng.uniform(0, 0.6))
            top = float(rng.uniform(0, 0.6))
            w = float(rng.uniform(0.1, 0.5))
            h = float(rng.uniform(0.1, 0.5))
        fl["type"].append([str(t).encode()])
        fl["left"].append([left])
        fl["top"].append([top])
        fl["width"].append([w])
        fl["height"].append([h])
        fl["opacity"].append([float(rng.uniform(0.5, 1.0))])
        fl["color"].append([int(x) for x in rng.integers(0, 256, size=3)])
        fl["image_embedding"].append(
            _unit(rng, 512) if t in ("svgElement", "imageElement", "maskElement")
            else [0.0] * 512
        )
        fl["text_embedding"].append(
            _unit(rng, 512) if t == "textElement" else [0.0] * 512
        )
        fl["font_family"].append(
            [rng.choice(CRELLO_FONTS).encode() if t == "textElement" else b"Font0"]
        )
        fl["uuid"].append([f"uuid-{doc_id}-{j}".encode()])
    return example_proto.encode_sequence_example(context, fl)


def _rico_doc(
    rng: np.random.Generator, doc_id: int, num_elements: int = 0
) -> bytes:
    n = num_elements or int(rng.integers(1, 16))
    context = {"length": [n]}
    fl: Dict[str, List] = {
        k: []
        for k in "left top width height clickable type icon text_button".split()
    }
    for _ in range(n):
        t = rng.choice(RICO_TYPES)
        fl["type"].append([str(t).encode()])
        fl["left"].append([float(rng.uniform(0, 0.8))])
        fl["top"].append([float(rng.uniform(0, 0.9))])
        fl["width"].append([float(rng.uniform(0.05, 0.6))])
        fl["height"].append([float(rng.uniform(0.03, 0.3))])
        fl["clickable"].append([int(t in ("Icon", "Text Button", "Input"))])
        fl["icon"].append(
            [rng.choice(RICO_ICONS).encode() if t == "Icon" else b"none"]
        )
        fl["text_button"].append(
            [
                rng.choice(RICO_TEXT_BUTTONS).encode()
                if t == "Text Button"
                else b"none"
            ]
        )
    return example_proto.encode_sequence_example(context, fl)


def generate(
    dataset: str,
    out_dir: str,
    num_train: int = 256,
    num_val: int = 64,
    num_test: int = 64,
    seed: int = 0,
    shards_per_split: int = 2,
    fixed_length: Union[int, str] = 0,
) -> str:
    """Write a synthetic data directory; returns ``out_dir``.

    ``fixed_length``: give every document exactly this many elements
    (0 = random 1..15; the string ``"max"`` = the dataset's schema
    ``max_length``).  Golden tests use ``"max"`` so that in-batch padding
    coincides with our static padding — the reference stack derives
    tensor widths from the longest in-batch document.
    """
    assert dataset in ("crello", "rico"), dataset
    if fixed_length == "max":
        from .spec import _spec_path_for

        with open(_spec_path_for(dataset)) as f:
            fixed_length = int(yaml.safe_load(f).get("max_length", 50))
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    _doc = _crello_doc if dataset == "crello" else _rico_doc

    def make_doc(r, i):
        return _doc(r, i, num_elements=fixed_length)

    counts = {"train": num_train, "val": num_val, "test": num_test}
    doc_id = 0
    for split, count in counts.items():
        per_shard = -(-count // shards_per_split)
        written = 0
        for s in range(shards_per_split):
            path = os.path.join(
                out_dir, f"{split}-{s:05d}-of-{shards_per_split:05d}.tfrecord"
            )
            with tfrecord.RecordWriter(path) as w:
                for _ in range(min(per_shard, count - written)):
                    w.write(make_doc(rng, doc_id))
                    doc_id += 1
                    written += 1

    with open(os.path.join(out_dir, "count.json"), "w") as f:
        json.dump(counts, f)

    # vocabulary.json maps column -> {token: count}; min_freq filtering in the
    # spec layer drops rare tokens (reference spec.py:117-122), so give
    # font_family a couple of sub-threshold entries to exercise that path.
    if dataset == "crello":
        vocab = {
            "group": {g: 1000 for g in CRELLO_GROUPS},
            "format": {f: 1000 for f in CRELLO_FORMATS},
            "canvas_width": {str(w): 1000 for w in CRELLO_CANVAS_WIDTHS},
            "canvas_height": {str(h): 1000 for h in CRELLO_CANVAS_HEIGHTS},
            "category": {c: 1000 for c in CRELLO_CATEGORIES},
            "type": {t: 1000 for t in CRELLO_TYPES},
            "font_family": {
                **{f: 1000 for f in CRELLO_FONTS},
                "RareFontA": 3,
                "RareFontB": 7,
            },
        }
    else:
        vocab = {
            "type": {t: 1000 for t in RICO_TYPES},
            "icon": {**{i: 1000 for i in RICO_ICONS}, "none": 1000, "rare_icon": 2},
            "text_button": {
                **{b: 1000 for b in RICO_TEXT_BUTTONS},
                "none": 1000,
                "rare_button": 2,
            },
        }
    with open(os.path.join(out_dir, "vocabulary.json"), "w") as f:
        json.dump(vocab, f)
    return out_dir

