"""Inference serving: load a trained job, serve masked-field predictions.

Counterpart of ``flexdm_tpu/serve.py`` on PyTorch:

* :class:`InferenceEngine` — documents in, documents out, through one
  padded fixed-size batch per ``batch_size`` documents on the device;
* :class:`CoalescingEngine` — micro-batches concurrent identical-parameter
  requests into one engine call;
* ``python -m flexdm_tpu_torch.serve --job-dir <job>`` — a stdlib HTTP
  server: ``GET /healthz``, ``GET /schema``, ``POST /predict`` with
  ``{"task": "pos", "documents": [...], "fields": "all"|"changed",
  "element": ..., "seed": ..., "num_iter": 1}``.

The job needs its port weights, ``checkpoints/<name>.torch.npz`` (see
``tools/export_torch_weights.py``).  The JAX engine's packed single-buffer
transport existed for a TPU host relay and is not ported: the batch goes to
the device as a dict of tensors.  What stays is the scoped fetch: only the
columns the task can change come back, categorical ones argmaxed on the
device.  ``elem`` draws its random element from a ``torch.Generator``
seeded with the request's seed, so its picks differ from the JAX engine's;
a pinned ``element`` gives the same masks in both.  ``num_iter`` is any
integer: above 1 the categorical fields are decoded with MaskGIT in that
many rounds, below 2 in one pass (as the JAX engine reads it); a value
that is not an integer is answered with 400.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import DatasetSpec, split_device_batch
from .demo import build_task_masks, load_model
from .evaluation.harness import task_id_for_mode
from .models import forward_eval

logger = logging.getLogger(__name__)


def _jsonable(x):
    """Convert unbatch output (numpy scalars/arrays, bytes) to JSON types.

    Numeric arrays take the ``tolist()`` fast path; object and bytes-dtype
    arrays go element by element so their bytes are decoded.
    """
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, bytes):  # checked before np.generic: np.bytes_ is both
        return x.decode("utf-8", "replace")
    if isinstance(x, np.ndarray):
        if x.dtype.kind in "OSV":
            return [_jsonable(v) for v in x.tolist()]
        return x.tolist()
    if isinstance(x, np.generic):
        return _jsonable(x.item())
    return x


def _normalize_element(element, n: int) -> Optional[List[int]]:
    """``element`` as ``n`` ints (one int is repeated), or ValueError."""
    if element is None:
        return None
    if _is_int(element):
        return [int(element)] * n
    if not isinstance(element, (list, tuple)) or not all(map(_is_int, element)):
        raise ValueError(
            f"element must be an int or a list of ints, got {element!r}"
        )
    if len(element) != n:
        raise ValueError(f"element has {len(element)} entries for {n} documents")
    return [int(e) for e in element]


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _check_request(tasks, task, num_iter, fields):
    if task not in tasks:
        raise ValueError(f"unknown task {task!r}; one of {tasks}")
    if fields not in ("all", "changed"):
        raise ValueError(f"fields must be 'all' or 'changed', got {fields!r}")
    if not _is_int(num_iter):
        raise ValueError(f"num_iter must be an integer, got {num_iter!r}")


class InferenceEngine:
    """Masked-field prediction over a trained job on one device."""

    def __init__(self, job_dir: str, checkpoint: str = "best",
                 batch_size: int = 8, data_dir: Optional[str] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.model, self.spec = load_model(
            job_dir, checkpoint, batch_size=batch_size, device=self.device
        )
        if data_dir:
            self.spec = DatasetSpec(self.spec.name, data_dir, batch_size)
        self.schema = self.spec.schema
        self.batch_size = batch_size
        self._task_ids = {}
        if getattr(self.model, "context", None) == "id":
            self._task_ids = {
                t: task_id_for_mode(self.schema, t) for t in self.tasks
            }
        # One device, one stream: device steps run one at a time.
        self._lock = threading.Lock()

    @property
    def tasks(self) -> List[str]:
        return ["elem"] + list(self.schema.attribute_groups.keys())

    def _in_scope(self, task: str):
        """Sequence columns the task can change (everything else is ground
        truth merged back, so it is echoed from the request)."""
        group = None if task == "elem" else set(self.schema.attribute_groups[task])
        return [
            c for c in self.schema.modeled
            if c.is_sequence and (group is None or c.name in group)
        ]

    @torch.inference_mode()
    def _step(self, numeric: Dict[str, np.ndarray], task: str,
              num_iter: int, seed: int,
              element: Optional[List[int]]) -> Dict[str, np.ndarray]:
        batch = {
            k: torch.from_numpy(v).to(self.device) for k, v in numeric.items()
        }
        elem = None
        if element is not None:
            elem = torch.tensor(element, dtype=torch.int64, device=self.device)
        masks = build_task_masks(
            self.schema, batch, task,
            generator=torch.Generator().manual_seed(seed), element=elem,
        )
        tasks = None
        if task in self._task_ids:
            tasks = torch.full(
                (self.batch_size,), self._task_ids[task],
                dtype=torch.int32, device=self.device,
            )
        pred = forward_eval(self.model, batch, masks, tasks=tasks,
                            num_iter=num_iter)
        fetched = {
            c.name: pred[c.name].argmax(-1).to(torch.int32)
            if c.is_categorical else pred[c.name]
            for c in self._in_scope(task)
        }
        # numpy has no bfloat16: a bf16 model's floats cross as float32
        # (exact).
        return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                for k, v in fetched.items()}

    def predict(self, documents: List[Dict], task: str = "pos",
                num_iter: int = 1, seed: int = 0, fields: str = "all",
                element=None) -> List[Dict]:
        """Documents -> documents with the task's masked fields predicted.

        ``fields="changed"`` returns only the columns the task could change.
        ``element`` (elem only) pins which element is re-predicted: an int
        for every document, or one per document.
        """
        _check_request(self.tasks, task, num_iter, fields)
        if not documents:
            return []
        n = len(documents)
        if element is not None and task != "elem":
            raise ValueError(
                f"element= is only valid for task='elem', got {task!r}"
            )
        element = _normalize_element(element, n)
        if element is not None:
            S = self.schema.max_length
            for i, (doc, e) in enumerate(zip(documents, element)):
                n_el = min(len(doc.get("elements", [])), S)
                if not 0 <= e < n_el:
                    raise ValueError(
                        f"element {e} out of range for document {i} "
                        f"({n_el} elements)"
                    )
        seed = int(seed)
        if not 0 <= seed < 1 << 32:
            raise ValueError(f"seed {seed} outside uint32 range")
        if n > self.batch_size:
            out: List[Dict] = []
            for start in range(0, n, self.batch_size):
                stop = start + self.batch_size
                out.extend(self.predict(
                    documents[start:stop], task, num_iter, seed, fields,
                    element[start:stop] if element is not None else None,
                ))
            return out

        batch = self.spec.batch_documents(
            list(documents) + [documents[-1]] * (self.batch_size - n)
        )
        numeric = split_device_batch(batch)
        if element is not None:
            element = element + [0] * (self.batch_size - n)
        with self._lock:
            host = self._step(numeric, task, int(num_iter), seed, element)
        if fields == "all":
            for k, v in batch.items():
                host.setdefault(k, v)
        else:
            host["length"] = batch["length"]  # unbatch needs it
        host = {k: np.asarray(v)[:n] for k, v in host.items()}
        return [_jsonable(d) for d in self.spec.unbatch(host)]

    def warmup(self, tasks=(("pos", 1),), split: str = "test") -> Dict:
        """Run one real document from ``split`` through ``predict`` for each
        ``(task, num_iter)`` (and, for ``elem``, the pinned-element variant
        as ``elem/<n>/pinned``), so the kernel build and the first launches
        happen before the server takes requests.  Returns seconds per entry;
        failures are logged and skipped."""
        timings: Dict[str, float] = {}
        try:
            host = next(iter(self.spec.make_dataset(split, batch_size=1)))
            doc = _jsonable(self.spec.unbatch(split_device_batch(host))[0])
        except Exception as e:
            logger.warning("warmup skipped: could not load a %s document "
                           "(%s: %s)", split, type(e).__name__, e)
            return timings
        runs = []
        for task, num_iter in tasks:
            runs.append((f"{task}/{num_iter}", task, num_iter, None))
            if task == "elem":
                runs.append((f"{task}/{num_iter}/pinned", task, num_iter, 0))
        for name, task, num_iter, element in runs:
            t0 = time.perf_counter()
            try:
                self.predict([doc], task=task, num_iter=int(num_iter),
                             element=element)
            except Exception as e:
                logger.warning("warmup %s failed: %s: %s",
                               name, type(e).__name__, e)
                continue
            timings[name] = round(time.perf_counter() - t0, 3)
            logger.info("warmed %s in %.3f s", name, timings[name])
        return timings

    def schema_info(self) -> Dict:
        return {
            "dataset": self.spec.name,
            "max_length": self.schema.max_length,
            "tasks": self.tasks,
            "fields": {
                c.name: {
                    "is_sequence": c.is_sequence,
                    "categorical": c.is_categorical,
                    "shape": list(c.shape),
                }
                for c in self.schema.columns
            },
        }


@dataclasses.dataclass
class _PendingRequest:
    docs: List[Dict]
    done: threading.Event
    element: Optional[List[int]] = None
    result: Optional[List[Dict]] = None
    error: Optional[Exception] = None


class CoalescingEngine:
    """Micro-batches concurrent ``predict`` calls into shared engine calls.

    The first request into an empty queue leads: it waits until the queue
    holds a full batch or ``window_ms`` passes, drains the queue, runs one
    ``InferenceEngine.predict`` and hands each caller its documents.  Only
    requests with the same ``(task, num_iter, seed, fields, pinned)`` share
    a queue.  ``element`` is validated before a request is queued, and the
    leader builds the merged batch inside the ``try`` whose ``finally``
    releases every follower, so a malformed request cannot leave others
    waiting.  If the merged call fails, each request is retried alone so
    only the guilty one sees the error.
    """

    def __init__(self, engine: InferenceEngine, window_ms: float = 3.0):
        self._engine = engine
        self._window = window_ms / 1000.0
        self._cond = threading.Condition()
        self._queues: Dict[tuple, List[_PendingRequest]] = {}

    @property
    def tasks(self) -> List[str]:
        return self._engine.tasks

    @property
    def batch_size(self) -> int:
        return self._engine.batch_size

    @property
    def spec(self):
        return self._engine.spec

    def schema_info(self) -> Dict:
        return self._engine.schema_info()

    def predict(self, documents: List[Dict], task: str = "pos",
                num_iter: int = 1, seed: int = 0, fields: str = "all",
                element=None) -> List[Dict]:
        _check_request(self._engine.tasks, task, num_iter, fields)
        if not documents:
            return []
        element = _normalize_element(element, len(documents))
        key = (task, int(num_iter), int(seed), fields, element is not None)
        req = _PendingRequest(list(documents), threading.Event(), element)
        with self._cond:
            queue = self._queues.setdefault(key, [])
            leader = not queue
            queue.append(req)
            if not leader:
                self._cond.notify_all()
        if not leader:
            req.done.wait()
            if req.error is not None:
                raise req.error
            return req.result

        bs = self._engine.batch_size
        deadline = time.monotonic() + self._window
        with self._cond:
            while sum(len(r.docs) for r in self._queues[key]) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
            take = self._queues.pop(key)

        try:
            batch_docs = [d for r in take for d in r.docs]
            batch_elem = None
            if element is not None:
                batch_elem = [e for r in take for e in r.element]
            preds = self._engine.predict(
                batch_docs, task, num_iter, seed, fields, batch_elem
            )
            i = 0
            for r in take:
                r.result = preds[i:i + len(r.docs)]
                i += len(r.docs)
        except Exception:
            if len(take) == 1:
                raise
            for r in take:  # isolate the failure to the guilty request
                try:
                    r.result = self._engine.predict(
                        r.docs, task, num_iter, seed, fields, r.element
                    )
                except Exception as e:
                    r.error = e
        finally:
            for r in take:
                r.done.set()
        if req.error is not None:
            raise req.error
        return req.result


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload: Dict):
            try:
                # allow_nan=False: bare NaN/Infinity tokens are not JSON.
                body = json.dumps(payload, allow_nan=False).encode()
            except ValueError:
                payload = {"error": "non-finite value in prediction"}
                code = 500
                body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/schema":
                self._send(200, engine.schema_info())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                predictions = engine.predict(
                    req["documents"],
                    task=req.get("task", "pos"),
                    num_iter=req.get("num_iter", 1),
                    seed=int(req.get("seed", 0)),
                    fields=req.get("fields", "all"),
                    element=req.get("element"),
                )
                self._send(200, {"predictions": predictions})
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("predict failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8077):
    """The HTTP server over ``engine`` (call ``serve_forever`` on it)."""
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    logger.info("serving on %s:%d", host, server.server_address[1])
    return server


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve masked-field predictions from a trained job "
                    "(PyTorch port)"
    )
    parser.add_argument("--job-dir", dest="job_dir", required=True)
    parser.add_argument("--checkpoint", default="best")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--data-dir", default=None,
                        help="override the data dir recorded in args.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default: cuda)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8077)
    parser.add_argument(
        "--coalesce-ms", dest="coalesce_ms", type=float, default=3.0,
        help="micro-batch concurrent identical-parameter requests, waiting "
             "up to this long to fill a batch (0 disables)",
    )
    parser.add_argument(
        "--warmup", default=None, metavar="TASK:ITER,...",
        help="run these (task, num_iter) entries once before serving, "
             "e.g. 'pos:1,elem:1' (elem also warms the pinned variant)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    engine = InferenceEngine(
        args.job_dir, args.checkpoint, args.batch_size, args.data_dir,
        device=args.device,
    )
    if args.warmup:
        entries = []
        for part in args.warmup.split(","):
            task, _, it = part.strip().partition(":")
            entries.append((task, int(it) if it else 1))
        engine.warmup(entries)
    if args.coalesce_ms > 0:
        engine = CoalescingEngine(engine, args.coalesce_ms)
    server = serve(engine, args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
