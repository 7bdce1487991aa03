"""The port's data layer: schemas, TFRecord I/O, preprocessing, host loader.

A copy of what the port uses from ``flexdm_tpu/data`` (numpy only), under
the same module names, so the port imports nothing of the JAX package.
"""

from .schema import (
    ATTRIBUTE_GROUPS,
    CATEGORICAL,
    MASK_VALUE,
    NULL_VALUE,
    NUMERICAL,
    ColumnSpec,
    LossCondition,
    Schema,
    dataset_name_from_keys,
    make_task_probs,
)
from .spec import DatasetSpec, Discretizer, Vocab
from .pipeline import NUM_VALID_KEY, DataLoader, split_device_batch

__all__ = [
    "ATTRIBUTE_GROUPS",
    "CATEGORICAL",
    "MASK_VALUE",
    "NULL_VALUE",
    "NUMERICAL",
    "ColumnSpec",
    "LossCondition",
    "Schema",
    "DatasetSpec",
    "Discretizer",
    "Vocab",
    "DataLoader",
    "NUM_VALID_KEY",
    "split_device_batch",
    "dataset_name_from_keys",
    "make_task_probs",
]
