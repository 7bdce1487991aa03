"""Build a crello training data directory from raw JSONL template dumps.

    python tools/torch_build_crello_dataset.py --input 'dumps/*.jsonl' \
        --out /data/crello [--shards 8] [--val-frac 0.05 --test-frac 0.05]

Counterpart of ``tools/build_crello_dataset.py`` for ``flexdm_tpu_torch``,
importing nothing of the JAX package: raw crawled templates (read by the
port's ``data/crello`` schema) -> the ``count.json`` / ``vocabulary.json``
/ ``<split>-SSSSS-of-NNNNN.tfrecord`` layout that ``DatasetSpec`` reads,
written through the port's ``data/example_proto`` and
``data/tfrecord.RecordWriter``.  Its output is the JAX tool's byte for
byte: the same records in the same shards, the same JSON in the same key
order.

Field mapping per element (normalized to the unit canvas):
    type / left / top / width / height / opacity / color / font_family /
    uuid, plus canvas-level group / format / category / canvas_width /
    canvas_height / length / id.

Image/text embeddings require the corresponding encoder models (the
released datasets ship them precomputed); they are written as zero
vectors, which ``loss_condition`` gating treats as [NULL] for
non-applicable types anyway.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from flexdm_tpu_torch.data import example_proto, tfrecord  # noqa: E402
from flexdm_tpu_torch.data.crello import (  # noqa: E402
    ColoredBackground,
    GroupElement,
    PersistGroupElement,
    Template,
    TextElement,
)

MAX_ELEMENTS = 50
EMB_DIM = 512


def _parse_color(value) -> List[int]:
    """'#rrggbb' / [r,g,b] / {'r':..} -> [r, g, b] ints."""
    if value is None:
        return [0, 0, 0]
    if isinstance(value, (list, tuple)) and len(value) >= 3:
        return [int(v) for v in value[:3]]
    if isinstance(value, dict):
        return [int(value.get(k, 0)) for k in ("r", "g", "b")]
    s = str(value).lstrip("#")
    if len(s) >= 6:
        try:
            return [int(s[i : i + 2], 16) for i in (0, 2, 4)]
        except ValueError:
            pass
    return [0, 0, 0]


def template_to_example(tpl: Template) -> Optional[Dict]:
    """One Template -> (context, feature_lists) or None if unusable."""
    width = float(tpl.pixelWidth or tpl.width or 0)
    height = float(tpl.pixelHeight or tpl.height or 0)
    if width <= 0 or height <= 0 or not tpl.template:
        return None

    elements = [
        e
        for e in tpl.iter_elements()
        if not isinstance(e, (GroupElement, PersistGroupElement))
        and e.type is not None
    ][:MAX_ELEMENTS]
    if not elements:
        return None

    def norm(v, total):
        v = float(v or 0.0)
        return min(max(v / total, 0.0), 1.0)

    fl: Dict[str, List] = defaultdict(list)
    for el in elements:
        fl["type"].append([str(el.type).encode()])
        fl["left"].append([norm(el.x, width)])
        fl["top"].append([norm(el.y, height)])
        fl["width"].append([norm(el.width, width)])
        fl["height"].append([norm(el.height, height)])
        fl["opacity"].append(
            [min(max(float(el.opacity if el.opacity is not None else 1.0), 0.0), 1.0)]
        )
        color = [0, 0, 0]
        if isinstance(el, ColoredBackground):
            color = _parse_color(el.color)
        fl["color"].append(color)
        fl["image_embedding"].append([0.0] * EMB_DIM)
        fl["text_embedding"].append([0.0] * EMB_DIM)
        font = el.font if isinstance(el, TextElement) and el.font else ""
        fl["font_family"].append([str(font).encode()])
        fl["uuid"].append([str(el.uuid or "").encode()])

    category = tpl.category
    if isinstance(category, list):
        category = category[0] if category else ""
    context = {
        "id": [str(tpl.id).encode()],
        "length": [len(elements)],
        "group": [str(tpl.group or "").encode()],
        "format": [str(tpl.format or "").encode()],
        "canvas_width": [int(width)],
        "canvas_height": [int(height)],
        "category": [str(category or "").encode()],
    }
    return {"context": context, "feature_lists": dict(fl)}


def assign_split(doc_id: str, val_frac: float, test_frac: float) -> str:
    """Deterministic split by id hash."""
    h = int(hashlib.sha1(doc_id.encode()).hexdigest()[:8], 16) / 0xFFFFFFFF
    if h < test_frac:
        return "test"
    if h < test_frac + val_frac:
        return "val"
    return "train"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--input", required=True,
                        help="glob of raw template JSONL files")
    parser.add_argument("--out", required=True)
    parser.add_argument("--shards", type=int, default=8)
    parser.add_argument("--val-frac", type=float, default=0.05)
    parser.add_argument("--test-frac", type=float, default=0.05)
    args = parser.parse_args(argv)

    templates = Template.load(args.input)
    os.makedirs(args.out, exist_ok=True)

    vocab: Dict[str, Counter] = defaultdict(Counter)
    records: Dict[str, List[bytes]] = {"train": [], "val": [], "test": []}
    skipped = 0
    for tpl in templates:
        ex = template_to_example(tpl)
        if ex is None:
            skipped += 1
            continue
        ctx, fl = ex["context"], ex["feature_lists"]
        vocab["group"][ctx["group"][0].decode()] += 1
        vocab["format"][ctx["format"][0].decode()] += 1
        vocab["category"][ctx["category"][0].decode()] += 1
        vocab["canvas_width"][str(ctx["canvas_width"][0])] += 1
        vocab["canvas_height"][str(ctx["canvas_height"][0])] += 1
        for row in fl["type"]:
            vocab["type"][row[0].decode()] += 1
        for row in fl["font_family"]:
            if row[0]:
                vocab["font_family"][row[0].decode()] += 1
        split = assign_split(str(tpl.id), args.val_frac, args.test_frac)
        records[split].append(
            example_proto.encode_sequence_example(ctx, fl)
        )

    counts = {}
    for split, payloads in records.items():
        counts[split] = len(payloads)
        n_shards = max(1, min(args.shards, len(payloads) or 1))
        per = -(-max(len(payloads), 1) // n_shards)
        for s in range(n_shards):
            path = os.path.join(
                args.out, f"{split}-{s:05d}-of-{n_shards:05d}.tfrecord"
            )
            with tfrecord.RecordWriter(path) as w:
                for p in payloads[s * per : (s + 1) * per]:
                    w.write(p)

    with open(os.path.join(args.out, "count.json"), "w") as f:
        json.dump(counts, f)
    with open(os.path.join(args.out, "vocabulary.json"), "w") as f:
        json.dump({k: dict(v) for k, v in vocab.items()}, f)
    print(
        f"wrote {sum(counts.values())} documents "
        f"({counts}) to {args.out}; skipped {skipped}"
    )


if __name__ == "__main__":
    main()
