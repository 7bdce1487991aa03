"""Serving latency of the port: warm p50/p95 of ``POST /predict``.

    python tools/torch_bench_serve.py --job-dir JOB [--batch-size 8]
        [--requests 30] [--num_iter 4] [--concurrency 8]
        [--coalesce-ms 3] [--device cuda] [--out serve.json]

Counterpart of ``tools/bench_serve.py`` for ``flexdm_tpu_torch``: starts
the port's HTTP server (``flexdm_tpu_torch.serve``) in this process on an
ephemeral port over the job, sends real test documents as JSON over
loopback, and reports, on the host clock:

* the first request of each (task, num_iter): ``pos`` and ``elem`` in one
  pass and ``elem`` at ``--num_iter`` (MaskGIT);
* warm p50/p95 ms a request for ``pos`` on 1 and on ``--batch-size``
  documents (also with ``fields="changed"``) and for ``elem`` on one
  document at ``--num_iter``;
* with ``--concurrency N`` (N > 1), N client threads sending one-document
  ``pos`` requests back to back, to the engine alone and through a
  ``CoalescingEngine`` (``--coalesce-ms``) sharing it: documents/s and
  latency quantiles.

The numbers are what a user of ``python -m flexdm_tpu_torch.serve`` sees:
JSON both ways, batching and padding, the device step, unbatching.  The
result carries the device, the card's name and power limit
(``nvidia-smi``) and the attention kernels' launches over the run.
"""

import argparse
import json
import os
import statistics
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.torch_profile_step import card_name  # noqa: E402


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _quantiles(ms):
    ms = sorted(ms)
    return {"p50_ms": statistics.median(ms),
            "p95_ms": ms[min(len(ms) - 1, int(0.95 * len(ms)))],
            "min_ms": ms[0], "max_ms": ms[-1], "n": len(ms)}


def _latency(port, payload, requests):
    ms = []
    for i in range(requests):
        t0 = time.perf_counter()
        out = _post(port, dict(payload, seed=i))
        ms.append(1000 * (time.perf_counter() - t0))
        if "predictions" not in out:
            raise RuntimeError(f"no predictions: {out}")
    return _quantiles(ms)


def _concurrent_load(port, doc, clients, requests_per_client):
    """``clients`` threads each sending one-document ``pos`` requests back
    to back: documents/s and the latency quantiles."""
    ms, errors = [], []
    lock = threading.Lock()

    def client():
        for _ in range(requests_per_client):
            t0 = time.perf_counter()
            try:
                out = _post(port, {"task": "pos", "documents": [doc]})
                if "predictions" not in out:
                    raise RuntimeError(f"no predictions: {out}")
            except (OSError, RuntimeError, ValueError) as e:
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                return
            with lock:
                ms.append(1000 * (time.perf_counter() - t0))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} requests failed: {errors[:3]}")
    return dict(_quantiles(ms), clients=clients,
                docs_per_sec=len(ms) / wall)


def _serving(engine):
    from flexdm_tpu_torch.serve import serve

    server = serve(engine, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--job-dir", dest="job_dir", required=True)
    parser.add_argument("--data-dir", dest="data_dir", default=None)
    parser.add_argument("--checkpoint", default="best")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--requests", type=int, default=30)
    parser.add_argument("--num_iter", type=int, default=4)
    parser.add_argument("--concurrency", type=int, default=8,
                        help="client threads of the under-load phase "
                             "(below 2 skips it)")
    parser.add_argument("--coalesce-ms", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from flexdm_tpu_torch.data import split_device_batch
    from flexdm_tpu_torch.ops import attention as attn
    from flexdm_tpu_torch.serve import (
        CoalescingEngine,
        InferenceEngine,
        _jsonable,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a CPU run")
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    engine = InferenceEngine(args.job_dir, args.checkpoint, args.batch_size,
                             args.data_dir, device=device)
    result = {"job_dir": args.job_dir, "batch_size": args.batch_size,
              "device": str(device), "card": card_name(device),
              "startup_sec": time.perf_counter() - t0,
              "requests": args.requests}
    host = next(iter(engine.spec.make_dataset(
        "test", batch_size=args.batch_size)))
    docs = _jsonable(engine.spec.unbatch(split_device_batch(host)))

    server = _serving(engine)
    port = server.server_address[1]
    try:
        for task, num_iter in (("pos", 1), ("elem", 1),
                               ("elem", args.num_iter)):
            t0 = time.perf_counter()
            _post(port, {"task": task, "num_iter": num_iter,
                         "documents": docs[:1]})
            result[f"first_{task}_iter{num_iter}_sec"] = \
                time.perf_counter() - t0
        result["pos_1doc"] = _latency(
            port, {"task": "pos", "documents": docs[:1]}, args.requests)
        result[f"pos_{len(docs)}doc"] = _latency(
            port, {"task": "pos", "documents": docs}, args.requests)
        result[f"pos_{len(docs)}doc_changed"] = _latency(
            port, {"task": "pos", "documents": docs, "fields": "changed"},
            args.requests)
        result[f"elem_1doc_iter{args.num_iter}"] = _latency(
            port, {"task": "elem", "num_iter": args.num_iter,
                   "documents": docs[:1]}, args.requests)
        if args.concurrency > 1:
            per_client = max(4, args.requests // 2)
            result["load_serial"] = _concurrent_load(
                port, docs[0], args.concurrency, per_client)
            coalesced = _serving(CoalescingEngine(engine, args.coalesce_ms))
            try:
                result["load_coalesced"] = _concurrent_load(
                    coalesced.server_address[1], docs[0], args.concurrency,
                    per_client)
            finally:
                coalesced.shutdown()
                coalesced.server_close()
    finally:
        server.shutdown()
        server.server_close()
    result["launches"] = {"fwd": attn.KERNEL_LAUNCHES,
                          "fwd_bf16": attn.BF16_FWD_LAUNCHES}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
