"""Nearest-neighbor asset retrieval: predicted embedding -> real asset.

The port's own copy of ``flexdm_tpu/helpers/retrieve.py``, over the port's
data layer.  Counterpart of reference ``helpers/retrieve.py``.  The hash ->
embedding tables live in the ``crello-images`` / ``crello-texts`` TFRecord
stores (specs in ``data/specs``); the reference builds a faiss
``IndexFlatL2`` (retrieve.py:53-77), here the index is a brute-force L2
top-k in numpy (one (N, 512) matmul per query batch, no external
dependency).
"""

from __future__ import annotations

import os
from base64 import b64encode
from typing import Any, Dict, Optional

import numpy as np

from ..data import NUM_VALID_KEY, DatasetSpec


def make_data_uri(path: str, mime_type: str = "image/png") -> str:
    with open(path, "rb") as f:
        data = b64encode(f.read()).decode("ascii")
    return f"data:{mime_type};base64,{data}"


class _Retriever:
    """Base hash->embedding store with brute-force nearest neighbor."""

    def __init__(
        self,
        path: str,
        spec_name: str,
        key: str,
        value: str,
        condition: Optional[Dict[str, Any]] = None,
        dim: int = 512,
        batch_size: int = 256,
    ):
        self.path = str(path)
        self.key = key
        self.value = value
        self.condition = condition
        self.dim = dim
        self._spec = DatasetSpec(spec_name, self.path, batch_size=batch_size)
        self._labels: Optional[np.ndarray] = None
        self._data: Optional[np.ndarray] = None

    def build(self, split: str = "train") -> None:
        """Load + deduplicate the store (reference retrieve.py:53-77)."""
        dedup: Dict[bytes, np.ndarray] = {}
        for batch in self._spec.make_dataset(split):
            n = batch[NUM_VALID_KEY]  # the final batch's padding dropped
            keys = batch[self.key][:n].reshape(-1)
            values = batch[self.value][:n].reshape(-1, self.dim)
            for i in range(keys.shape[0]):
                k = keys[i]
                if isinstance(k, str):
                    k = k.encode()
                if k:  # skip padding rows
                    dedup[k] = values[i]
        self._labels = np.array(list(dedup.keys()))
        self._data = np.stack(list(dedup.values())).astype(np.float32)

    def _ensure_built(self):
        if self._data is None:
            self.build()

    def search_indices(self, query: np.ndarray, k: int = 1) -> np.ndarray:
        """Top-k nearest rows by L2 distance; query (D,) or (Q, D)."""
        self._ensure_built()
        q = np.asarray(query, dtype=np.float32)
        if q.ndim == 1:
            q = q[None]
        # ||x - q||^2 = ||x||^2 - 2 x.q + const; one GEMM per query batch.
        x = self._data
        d2 = (x * x).sum(-1)[None, :] - 2.0 * (q @ x.T)
        if k == 1:
            return np.argmin(d2, axis=-1)[:, None]
        return np.argsort(d2, axis=-1)[:, :k]

    def get_url(self, index: int) -> str:
        raise NotImplementedError

    def search(self, query, k: int = 1):
        idx = self.search_indices(np.asarray(query), k=max(k, 1))[0]
        urls = [self.get_url(int(i)) for i in idx.tolist()]
        return urls[0] if k == 1 else urls


class ImageRetriever(_Retriever):
    """512-d image embedding -> data-URI of the nearest real asset."""

    def __init__(
        self,
        path: str,
        key: str = "image_hash",
        value: str = "image_embedding",
        condition: Optional[Dict[str, Any]] = None,
        image_path: Optional[str] = None,
        dim: int = 512,
        **kwargs,
    ):
        super().__init__(path, "crello-images", key, value, condition, dim, **kwargs)
        if self.condition is None:
            self.condition = {
                "key": "type",
                "values": ("imageElement", "maskElement", "svgElement"),
            }
        self.image_path = image_path or os.path.join(self.path, "images")

    def get_url(self, index: int) -> str:
        label = self._labels[index]
        if label:
            name = label.decode() if isinstance(label, bytes) else str(label)
            return make_data_uri(os.path.join(self.image_path, name + ".png"))
        return ""


class TextRetriever(_Retriever):
    """512-d text embedding -> the nearest real text string."""

    def __init__(
        self,
        path: str,
        key: str = "text_hash",
        value: str = "text_embedding",
        condition: Optional[Dict[str, Any]] = None,
        text_path: Optional[str] = None,
        dim: int = 512,
        **kwargs,
    ):
        super().__init__(path, "crello-texts", key, value, condition, dim, **kwargs)
        if self.condition is None:
            self.condition = {"key": "type", "values": ("textElement",)}
        self.text_path = text_path or os.path.join(self.path, "texts")

    def get_url(self, index: int) -> str:
        label = self._labels[index]
        if label:
            name = label.decode() if isinstance(label, bytes) else str(label)
            with open(os.path.join(self.text_path, name + ".txt"), "rb") as f:
                return f.read().decode()
        return ""
