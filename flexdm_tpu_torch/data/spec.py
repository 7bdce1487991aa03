"""Dataset specification: YAML column schemas + data-dir resources.

The port's own copy of ``flexdm_tpu/data/spec.py``, counterpart of the
reference ``DataSpec`` (reference ``src/mfp/mfp/data/spec.py:24-361``).  It
decodes records with the pure-Python proto codec only (the JAX package's
optional C++ decoder is not carried over); the arrays are the same.
Responsibilities:

* load the per-dataset YAML column spec (bundled under ``data/specs/`` or an
  explicit path) plus ``vocabulary.json`` from the data dir;
* build vocabulary lookups and uniform-bin discretizers with exactly the
  keras ``StringLookup``/``IntegerLookup``/``Discretization`` semantics the
  reference relied on (mask-token at index 0, OOV head indices, min_freq
  filtering, ``linspace(min, max, bins)[1:]`` boundaries — reference
  ``spec.py:87-134`` and ``discretizer.py:20-24``);
* produce the frozen :class:`~flexdm_tpu_torch.data.schema.Schema` that the
  models are built against;
* decode raw TFRecord payloads into fixed-shape ``(B, max_length, C)`` numpy
  batches (the reference padded to the ragged per-batch max instead);
* invert everything for visualization (``unbatch`` / ``logit_to_label``,
  reference ``spec.py:289-344``).

The preprocessing here is host-side numpy by design: string lookups do not
belong on the device, and the arrays are tiny compared to the model compute.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import yaml

from . import example_proto
from .schema import CATEGORICAL, NUMERICAL, ColumnSpec, LossCondition, Schema

_SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")


def _spec_path_for(name: str) -> str:
    cand = os.path.join(_SPEC_DIR, name + ".yml")
    if os.path.exists(cand):
        return cand
    if os.path.exists(name):
        return name
    raise FileNotFoundError(f"no spec for dataset {name!r} (looked in {_SPEC_DIR})")


class Vocab:
    """Token table replicating keras StringLookup / IntegerLookup.

    Full table layout: ``[mask_token?] + [oov] * num_oov_indices + tokens``.
    ``lookup`` maps unknown tokens to the first OOV index when one exists;
    with zero OOV indices unknown tokens are an error (matching TF).
    """

    def __init__(
        self,
        tokens: Sequence,
        mask_token=None,
        num_oov_indices: int = 0,
        oov_token="[UNK]",
    ):
        head: List = []
        if mask_token is not None:
            head.append(mask_token)
        head.extend([oov_token] * num_oov_indices)
        self.tokens = list(head) + list(tokens)
        self.num_oov_indices = num_oov_indices
        self.mask_token = mask_token
        self._oov_index = (1 if mask_token is not None else 0)
        self._index = {t: i for i, t in enumerate(self.tokens)}
        # Vectorized lookup tables (searchsorted over the sorted key set);
        # built from the dict so duplicate tokens keep its later-wins
        # semantics.  Mixed-type vocabularies fall back to the scalar loop.
        self._fast = None
        keys = list(self._index.keys())
        if keys and all(
            isinstance(k, (int, np.integer)) and not isinstance(k, bool)
            for k in keys
        ):
            arr = np.fromiter((int(k) for k in keys), dtype=np.int64)
            kind = "int"
        elif keys and all(isinstance(k, (str, bytes)) for k in keys):
            arr = np.array(
                [k.encode("utf-8") if isinstance(k, str) else k for k in keys],
                dtype=np.bytes_,
            )
            kind = "bytes"
        else:
            arr = None
        if arr is not None:
            vals = np.fromiter(
                (self._index[k] for k in keys), dtype=np.int32
            )
            order = np.argsort(arr, kind="stable")
            self._fast = (kind, arr[order], vals[order])

    def __len__(self) -> int:
        return len(self.tokens)

    def lookup_scalar(self, token) -> int:
        idx = self._index.get(token)
        if idx is None:
            if self.num_oov_indices > 0:
                return self._oov_index
            raise KeyError(f"token {token!r} not in vocabulary and no OOV bucket")
        return idx

    def lookup(self, values: np.ndarray) -> np.ndarray:
        flat = values.reshape(-1)
        out = self._lookup_vectorized(flat)
        if out is None:  # mixed-type vocab or exotic input dtype
            out = np.empty(flat.shape[0], dtype=np.int32)
            for i, v in enumerate(flat):
                if isinstance(v, bytes):
                    v = v.decode("utf-8")
                elif isinstance(v, (np.integer,)):
                    v = int(v)
                out[i] = self.lookup_scalar(v)
        return out.reshape(values.shape)

    def _lookup_vectorized(self, flat: np.ndarray) -> Optional[np.ndarray]:
        """searchsorted-based batch lookup (the per-token Python loop was
        the first-epoch decode bottleneck at corpus scale, VERDICT r2 #6);
        identical outputs to :meth:`lookup_scalar` incl. OOV/KeyError."""
        if self._fast is None:
            return None
        kind, sorted_keys, sorted_vals = self._fast
        if kind == "int" and flat.dtype.kind in "iu":
            q = flat.astype(np.int64, copy=False)
        elif kind == "bytes" and (
            flat.dtype.kind in "SU" or flat.dtype == object
        ):
            if flat.dtype == object and not all(
                isinstance(v, (bytes, str)) for v in flat
            ):
                # np.asarray(np.bytes_) would STRINGIFY non-string scalars
                # (int 1 -> b'1'), silently diverging from lookup_scalar;
                # leave exotic element types to the exact scalar loop.
                return None
            try:
                q = np.asarray(flat, dtype=np.bytes_)
            except (TypeError, UnicodeEncodeError, ValueError):
                return None
        else:
            return None
        pos = np.searchsorted(sorted_keys, q)
        pos_c = np.minimum(pos, len(sorted_keys) - 1)
        hit = sorted_keys[pos_c] == q
        if self.num_oov_indices > 0:
            return np.where(hit, sorted_vals[pos_c], self._oov_index).astype(
                np.int32
            )
        if not hit.all():
            bad = q[~hit].reshape(-1)[0]
            if isinstance(bad, bytes):
                bad = bad.decode("utf-8", errors="replace")
            raise KeyError(
                f"token {bad!r} not in vocabulary and no OOV bucket"
            )
        return sorted_vals[pos_c].astype(np.int32)

    def table(self) -> np.ndarray:
        """Index -> token array for un-preprocessing (spec.py:327-330)."""
        return np.array(self.tokens, dtype=object)


class Discretizer:
    """Uniform-bin discretizer replicating keras ``Discretization``.

    Boundaries are ``linspace(min, max, bins)[1:]`` and the bucket of ``x`` is
    the number of boundaries ``<= x`` — i.e. ``searchsorted(..., 'right')``
    (validated against TF: value v maps to bucket
    ``np.searchsorted(boundaries, v, side='right')``).
    Reference: ``data/spec.py:95-101`` + ``data/discretizer.py:20-24``.
    """

    def __init__(self, minimum: float, maximum: float, bins: int):
        self.minimum = float(minimum)
        self.maximum = float(maximum)
        self.bins = int(bins)
        self.boundaries = np.linspace(minimum, maximum, bins)[1:]

    @property
    def num_bins(self) -> int:
        return len(self.boundaries) + 1

    def __call__(self, values: np.ndarray) -> np.ndarray:
        x = np.asarray(values, dtype=np.float32)
        return np.searchsorted(self.boundaries, x, side="right").astype(np.int32)

    def inverse(self, bucket_ids: np.ndarray) -> np.ndarray:
        """Bucket id -> representative value (reference spec.py:331-334)."""
        scale = (self.maximum - self.minimum) / (self.bins - 1.0)
        return scale * np.asarray(bucket_ids, dtype=np.float32) + self.minimum


_NP_DTYPES = {
    "int64": np.int64,
    "int32": np.int32,
    "int": np.int64,
    "float32": np.float32,
    "float64": np.float32,
    "float": np.float32,
    "string": object,
}


class DatasetSpec:
    """Schema + resources + host-side (de)serialization for one dataset.

    Usage::

        spec = DatasetSpec("crello", "/data/crello")
        schema = spec.schema
        loader = spec.make_dataset("train", batch_size=256, shuffle=True,
                                   repeat=True, seed=0)
        batch = next(iter(loader))      # dict of (B, 50, C) numpy arrays
    """

    def __init__(
        self,
        name: str,
        path: Optional[str] = None,
        batch_size: int = 8,
    ):
        self.path = path
        self.batch_size = batch_size
        with open(_spec_path_for(name)) as f:
            self._spec = yaml.safe_load(f)
        self.name = self._spec.get("name", name)
        self.max_length = int(self._spec.get("max_length", 50))

        vocabulary: Dict[str, Any] = {}
        if path is not None:
            vocab_path = os.path.join(path, "vocabulary.json")
            if os.path.exists(vocab_path):
                with open(vocab_path) as f:
                    vocabulary = json.load(f)

        self._init_preprocessors(vocabulary)
        self._schema: Optional[Schema] = None

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @property
    def columns(self) -> Dict[str, Dict]:
        return self._spec.get("columns", {})

    def _init_preprocessors(self, vocabulary: Dict[str, Any]) -> None:
        self.vocabs: Dict[str, Vocab] = {}
        self.discretizers: Dict[str, Discretizer] = {}
        for name, column in self.columns.items():
            if "lookup" in column:
                self.vocabs[name] = self._build_vocab(name, column, vocabulary)
            elif "discretize" in column:
                d = column["discretize"]
                self.discretizers[name] = Discretizer(
                    d["min"], d["max"], d["bins"]
                )

    def _build_vocab(self, name: str, column: Dict, vocabulary: Dict) -> Vocab:
        """Replicates reference ``_create_lookup`` (spec.py:103-134)."""
        lookup = column["lookup"] if isinstance(column["lookup"], dict) else {}
        is_int = column["dtype"] in ("int", "int32", "int64")

        if name in vocabulary:
            vocab = vocabulary[name]
        else:
            rng = lookup.get("vocabulary")
            if rng is None:
                raise ValueError(
                    f"column {name!r} needs an entry in vocabulary.json or an "
                    "inline integer range"
                )
            vocab = list(range(rng["min"], rng["max"] + 1))
        if isinstance(vocab, dict):
            min_freq = column.get("min_freq", 1)
            vocab = [
                int(k) if is_int else k
                for k, count in vocab.items()
                if count >= min_freq
            ]

        # keras option names differ between the string and int variants.
        mask_token = lookup.get("mask_token", lookup.get("mask_value"))
        num_oov = lookup.get("num_oov_indices", 1)
        oov_token = -1 if is_int else "[UNK]"
        return Vocab(vocab, mask_token, num_oov, oov_token)

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._make_schema()
        return self._schema

    def _make_schema(self) -> Schema:
        """Build the static Schema (reference make_input_columns, spec.py:144-211)."""
        specs: List[ColumnSpec] = []
        for name, column in self.columns.items():
            shape = tuple(column.get("shape", (1,)))
            is_sequence = bool(column.get("is_sequence", False))
            demo_only = bool(column.get("demo_only", False))

            if demo_only:
                specs.append(
                    ColumnSpec(
                        name=name,
                        kind=CATEGORICAL,
                        shape=shape,
                        is_sequence=is_sequence,
                        demo_only=True,
                    )
                )
                continue

            if name in self.discretizers:
                kind, input_dim = CATEGORICAL, self.discretizers[name].num_bins
            elif name in self.vocabs:
                kind, input_dim = CATEGORICAL, len(self.vocabs[name])
            elif column["dtype"] in ("int", "int32", "int64"):
                kind, input_dim = CATEGORICAL, int(column["max"]) + 1
            elif column["dtype"] in ("float", "float32", "float64"):
                kind, input_dim = NUMERICAL, 0
            else:
                raise NotImplementedError(f"column {name}: {column}")

            primary_label = None
            if "primary_label" in column:
                primary_label = self.vocabs[name].lookup_scalar(
                    column["primary_label"]["default"]
                )

            loss_condition = None
            if "loss_condition" in column:
                cond = column["loss_condition"]
                cond_vocab = self.vocabs[cond["key"]]
                loss_condition = LossCondition(
                    key=cond["key"],
                    mask=tuple(t in cond["values"] for t in cond_vocab.tokens),
                )

            specs.append(
                ColumnSpec(
                    name=name,
                    kind=kind,
                    shape=shape,
                    is_sequence=is_sequence,
                    input_dim=input_dim,
                    primary_label=primary_label,
                    loss_condition=loss_condition,
                )
            )
        return Schema(
            name=self.name, columns=tuple(specs), max_length=self.max_length
        )

    # ------------------------------------------------------------------
    # Decoding + preprocessing
    # ------------------------------------------------------------------
    def decode_record(self, payload: bytes) -> Dict[str, np.ndarray]:
        """One serialized SequenceExample -> padded, preprocessed arrays.

        Sequence columns come back ``(max_length, C)``; canvas columns ``(C,)``.
        String demo-only columns stay as object arrays.  Replaces
        ``tf.io.parse_sequence_example`` (reference
        ``src/mfp/mfp/data/spec.py:255-287``) with the Python proto codec.
        """
        context, feature_lists = example_proto.decode_sequence_example(payload)
        S = self.max_length
        out: Dict[str, np.ndarray] = {}
        for name, column, shape, np_dtype, is_seq in self._column_plan:
            if is_seq:
                rows = feature_lists.get(name, [])
                n = min(len(rows), S)
                if np_dtype is object and name in self.vocabs:
                    # Fixed-width 'S' array instead of object: the vocab's
                    # vectorized searchsorted takes it directly, skipping
                    # the per-element type check object arrays require
                    # (S-dtype zeros read back as b"").
                    if n:
                        head = np.asarray(
                            rows[:n], dtype=np.bytes_
                        ).reshape((n,) + shape)
                        arr = np.zeros((S,) + shape, dtype=head.dtype)
                        arr[:n] = head
                    else:
                        arr = np.zeros((S,) + shape, dtype="S1")
                else:
                    arr = np.zeros((S,) + shape, dtype=np_dtype)
                    if np_dtype is object:
                        arr[:] = b""
                    if n:
                        try:  # one bulk conversion (rows are regular)
                            arr[:n] = np.asarray(
                                rows[:n], dtype=np_dtype
                            ).reshape((n,) + shape)
                        except (ValueError, TypeError):  # ragged rows
                            for j, row in enumerate(rows[:n]):
                                arr[j] = np.asarray(
                                    row, dtype=np_dtype
                                ).reshape(shape)
            else:
                vals = context.get(name, [])
                if np_dtype is object and name in self.vocabs and len(vals):
                    arr = np.asarray(vals, dtype=np.bytes_).reshape(shape)
                else:
                    arr = np.zeros(shape, dtype=np_dtype)
                    if np_dtype is object:
                        arr[:] = b""
                    if len(vals):
                        arr[:] = np.asarray(
                            vals, dtype=np_dtype
                        ).reshape(shape)
            out[name] = arr
        return self.preprocess(out)

    @property
    def _column_plan(self):
        """Cached (name, column, shape, np_dtype, is_sequence) tuples — the
        per-record decode loop's dict/shape lookups hoisted out."""
        if not hasattr(self, "_column_plan_cache"):
            self._column_plan_cache = tuple(
                (
                    name,
                    column,
                    tuple(column.get("shape", (1,))),
                    _NP_DTYPES[column["dtype"]],
                    bool(column.get("is_sequence", False)),
                )
                for name, column in self.columns.items()
            )
        return self._column_plan_cache

    def preprocess(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Apply lookups/binning; ints -> int32 (reference spec.py:278-287)."""
        out: Dict[str, np.ndarray] = {}
        for name, column in self.columns.items():
            x = raw[name]
            if column.get("demo_only", False):
                out[name] = x
                continue
            if name in self.vocabs:
                x = self.vocabs[name].lookup(x)
            elif name in self.discretizers:
                x = self.discretizers[name](x)
            if x.dtype in (np.int64, np.int32):
                x = x.astype(np.int32)
            elif x.dtype in (np.float64,):
                x = x.astype(np.float32)
            out[name] = x
        return out

    def batch_documents(
        self, documents: Sequence[Dict]
    ) -> Dict[str, np.ndarray]:
        """Inverse of :meth:`unbatch`: human-readable documents -> a
        preprocessed batch (the serving ingress path; the reference has no
        equivalent — its only entry is TFRecord files).

        Each document is ``{"elements": [{field: value, ...}, ...],
        canvas_field: value, ...}`` with raw values (strings for lookup
        columns, numbers for discretized/numerical ones).  Missing fields
        default to zeros — they are typically the masked prediction targets.
        ``length`` is derived from ``len(elements)``.
        """
        S = self.max_length
        raws = []
        for doc in documents:
            elements = list(doc.get("elements", []))[:S]
            n = len(elements)
            raw: Dict[str, np.ndarray] = {}
            for name, column in self.columns.items():
                shape = tuple(column.get("shape", (1,)))
                np_dtype = _NP_DTYPES[column["dtype"]]
                if column.get("is_sequence", False):
                    arr = np.zeros((S,) + shape, dtype=np_dtype)
                    if np_dtype is object:
                        arr[:] = b""
                    for j, el in enumerate(elements):
                        if name in el:
                            arr[j] = np.asarray(
                                el[name], dtype=np_dtype
                            ).reshape(shape)
                else:
                    arr = np.zeros(shape, dtype=np_dtype)
                    if np_dtype is object:
                        arr[:] = b""
                    if name == "length":
                        # Raw records store the 1-based element count; the
                        # length lookup maps it to the zero-based id.
                        arr[:] = max(n, 1)
                    elif name in doc:
                        arr[:] = np.asarray(
                            doc[name], dtype=np_dtype
                        ).reshape(shape)
                raw[name] = arr
            raws.append(self.preprocess(raw))
        return {k: np.stack([r[k] for r in raws]) for k in raws[0]}

    def make_dataset(self, split: str, **kwargs):
        """Build a host-side loader over this dataset's TFRecord shards."""
        from .pipeline import DataLoader  # local import to avoid cycle

        kwargs.setdefault("batch_size", self.batch_size)
        return DataLoader(self, split, **kwargs)

    # ------------------------------------------------------------------
    # Inverse transforms (for demo / visualization)
    # ------------------------------------------------------------------
    def logit_to_label(self, example: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Argmax any logit-shaped entries (reference spec.py:289-298)."""
        out = dict(example)
        for name, column in self.columns.items():
            if column.get("demo_only", False) or name not in out:
                continue
            rank = 1 + int(column.get("is_sequence", 0)) + len(
                tuple(column.get("shape", (1,)))
            )
            x = np.asarray(out[name])
            if x.ndim >= rank + 1:
                out[name] = np.argmax(x, axis=-1).astype(np.int32)
        return out

    def unbatch(self, example: Dict[str, np.ndarray]) -> List[Dict]:
        """Batch dict -> list of human-readable items (reference spec.py:300-344)."""
        example = self.logit_to_label(example)
        batch_size = np.asarray(example["length"]).shape[0]

        items = []
        for i in range(batch_size):
            length = int(np.squeeze(np.asarray(example["length"])[i])) + 1
            for name, column in self.columns.items():
                if column.get("is_sequence", False) and name in example:
                    length = min(length, np.asarray(example[name])[i].shape[0])
                    break

            item: Dict[str, Any] = {"elements": [{} for _ in range(length)]}
            for name, column in self.columns.items():
                if name not in example:
                    continue
                x = np.asarray(example[name])[i]

                if "lookup" in column and not column.get("demo_only", False):
                    # Tolerate [MASK]/[NULL] ids (vocab_size / vocab_size+1)
                    # so masked model inputs can also be visualized.
                    table = np.concatenate(
                        [self.vocabs[name].table(), ["<MASK>", "<NULL>"]]
                    )
                    x = table[np.clip(x, 0, len(table) - 1)]
                elif "discretize" in column:
                    bins = self.discretizers[name].num_bins
                    x = self.discretizers[name].inverse(np.where(x >= bins, 0, x))

                if column.get("is_sequence", False):
                    for j in range(length):
                        row = x[j]
                        if hasattr(row, "shape") and row.shape and row.shape[0] > 1:
                            # tolist(), not list(): pure-Python values keep
                            # JSON serialization off the per-np-scalar path
                            # (a 768-dim feature row costs ~1 us/element to
                            # walk as np scalars).
                            item["elements"][j][name] = row.tolist()
                        else:
                            item["elements"][j][name] = np.ravel(row)[0]
                else:
                    item[name] = np.ravel(x)[0]
            items.append(item)
        return items

