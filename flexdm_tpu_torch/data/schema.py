"""Static dataset schema that drives the whole port.

The port's own copy of ``flexdm_tpu/data/schema.py`` (same classes, same
values), so that it imports nothing of the JAX package.

The reference implementation threads an ad-hoc ``input_columns`` dict (built by
``DataSpec.make_input_columns``, reference ``src/mfp/mfp/data/spec.py:144-211``)
through every layer of the stack.  Here the same information is carried by
frozen, hashable dataclasses: every model, masking and loss module is generic
over a :class:`Schema`, and all per-column branching is decided by it.

Key invariants preserved from the reference:

* categorical columns reserve two extra embedding rows for the ``[MASK]`` and
  ``[NULL]`` tokens at ids ``input_dim`` and ``input_dim + 1``
  (reference ``models/masking.py:82-85``);
* numerical columns use the sentinel values ``MASK_VALUE = 10.0`` and
  ``NULL_VALUE = 0.0`` broadcast over all channels
  (reference ``models/masking.py:8-9``);
* the ``length`` column is zero-based (value ``L`` means ``L + 1`` elements,
  reference ``models/architecture/mask.py:29``);
* attribute groups define the explicit masking tasks
  (reference ``data/spec.py:364-377``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

CATEGORICAL = "categorical"
NUMERICAL = "numerical"

# Sentinel values written into numerical fields in place of real data.
# Reference: src/mfp/mfp/models/masking.py:8-9
MASK_VALUE = 10.0
NULL_VALUE = 0.0

# Attribute groups per dataset; these define the explicit task suite.
# Reference: src/mfp/mfp/data/spec.py:364-377
ATTRIBUTE_GROUPS: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "rico": {
        "type": ("type",),
        "pos": ("left", "top", "width", "height"),
        "attr": ("icon", "clickable", "text_button"),
    },
    "crello": {
        "type": ("type",),
        "pos": ("left", "top", "width", "height"),
        "attr": ("opacity", "color", "font_family"),
        "img": ("image_embedding",),
        "txt": ("text_embedding",),
    },
}


def dataset_name_from_keys(keys) -> str:
    """Sniff the dataset family from the column names.

    Reference: src/mfp/mfp/data/spec.py:380-385
    """
    return "rico" if "clickable" in set(keys) else "crello"


@dataclasses.dataclass(frozen=True)
class LossCondition:
    """Validity gate for a column, conditioned on another categorical column.

    ``mask[i]`` says whether this column carries a real value when the
    conditioning column (``key``) takes vocabulary id ``i``.  E.g. crello's
    ``image_embedding`` is only valid on svg/image/mask elements.

    Reference: src/mfp/mfp/data/spec.py:195-209
    """

    key: str
    mask: Tuple[bool, ...]


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """One attribute of a document (canvas-level or per-element)."""

    name: str
    kind: str = CATEGORICAL  # CATEGORICAL or NUMERICAL
    shape: Tuple[int, ...] = (1,)  # per-element channels, e.g. (3,) for RGB
    is_sequence: bool = False  # per-element (True) vs per-canvas (False)
    input_dim: int = 0  # vocabulary / bin count (categorical only)
    primary_label: Optional[int] = None
    loss_condition: Optional[LossCondition] = None
    demo_only: bool = False  # carried through for visualization, never modeled

    def __post_init__(self):
        assert self.kind in (CATEGORICAL, NUMERICAL), self.kind

    @property
    def is_categorical(self) -> bool:
        return self.kind == CATEGORICAL

    @property
    def mask_token_id(self) -> int:
        """Categorical id of the [MASK] token (reference masking.py:82-83)."""
        return self.input_dim

    @property
    def null_token_id(self) -> int:
        """Categorical id of the [NULL] token (reference masking.py:84-85)."""
        return self.input_dim + 1


@dataclasses.dataclass(frozen=True)
class Schema:
    """The full, hashable column schema of a dataset.

    Being frozen + hashable, a Schema can be closed over or passed as a static
    argument to jit-compiled functions; every model/masking/loss function in
    this framework is generic over it.
    """

    name: str
    columns: Tuple[ColumnSpec, ...]
    max_length: int = 50  # element-sequence capacity (static shape S)

    # ---- lookups -----------------------------------------------------------
    def __getitem__(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def __iter__(self) -> Iterator[ColumnSpec]:
        return iter(self.columns)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    # ---- views -------------------------------------------------------------
    @property
    def modeled(self) -> Tuple[ColumnSpec, ...]:
        """Columns the model consumes (everything but demo-only).

        Reference: src/mfp/mfp/models/mfp.py:235-237
        """
        return tuple(c for c in self.columns if not c.demo_only)

    def valid_columns(self, use_canvas: bool = False) -> Tuple[ColumnSpec, ...]:
        """Columns the encoder/decoder/loss operate on.

        Drops ``length``, demo-only columns, and (unless ``use_canvas``)
        canvas-level columns.  Reference: src/mfp/mfp/data/spec.py:393-403
        """
        out = []
        for c in self.columns:
            if c.name == "length" or c.demo_only:
                continue
            if not c.is_sequence and not use_canvas:
                continue
            out.append(c)
        return tuple(out)

    @property
    def sequence_columns(self) -> Tuple[ColumnSpec, ...]:
        return tuple(c for c in self.modeled if c.is_sequence)

    # ---- tasks -------------------------------------------------------------
    @property
    def dataset_name(self) -> str:
        return dataset_name_from_keys(self.names)

    @property
    def attribute_groups(self) -> Dict[str, Tuple[str, ...]]:
        """Task groups, restricted to columns present in this schema.

        The group table is keyed by dataset family (spec.py:364-377); group
        names are kept even when empty so task ids stay stable, but missing
        columns are dropped (partial schemas are valid here, unlike the
        reference which assumed the full column set).
        """
        groups = ATTRIBUTE_GROUPS[self.dataset_name]
        names = set(self.names)
        return {
            g: tuple(k for k in keys if k in names)
            for g, keys in groups.items()
        }

    @property
    def task_names(self) -> Tuple[str, ...]:
        """Task id order: random, elem, then the attribute groups.

        Reference: src/mfp/mfp/models/masking.py:18-21
        """
        return ("random", "elem") + tuple(self.attribute_groups.keys())

    @property
    def sort_pos(self) -> bool:
        """rico scores `pos` on lexicographically sorted elements.

        Reference: src/mfp/mfp/models/mfp.py:293-296
        """
        return self.dataset_name == "rico"


def make_task_probs(schema: Schema, masking_method: str) -> List[float]:
    """Uniform task distribution over the tasks named in ``masking_method``.

    ``masking_method`` is an underscore-joined list of task names, e.g.
    ``"elem_pos_attr_img_txt"``.  Reference: src/mfp/mfp/models/mfp.py:34-43
    """
    used = set(masking_method.split("_"))
    probs = [1.0 if name in used else 0.0 for name in schema.task_names]
    total = sum(probs)
    if total <= 0.0:
        raise ValueError(
            f"masking_method {masking_method!r} selects no task out of "
            f"{schema.task_names}"
        )
    return [p / total for p in probs]
