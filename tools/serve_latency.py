#!/usr/bin/env python
"""End-to-end serving latency: p50/p99 through tools/serve.py.

Batch-throughput numbers say nothing of request latency; a serving
claim needs it. This spins up the real server in-process
(``make_server`` — HTTP handler threads, batching queue, single device
worker) and measures wall-clock per request at the HTTP client:

* **sequential**: one request at a time — the single-request latency a
  lone client sees: decode + dispatch + upscale + encode;
* **concurrent**: C client threads firing back-to-back for N requests
  each — the batching-queue regime the throughput rows measure, where
  the dispatch cost amortizes across same-shape groups.

Workloads: 1080p luma (SRCNN 9-5-5) and 540p RGB (waifu2x 7-layer),
the two production model families. Prints one JSON line per row.

Run it alone on the device (one process per card):

    python tools/serve_latency.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _png_bytes(rng, h, w):
    """Representative synthetic content (gradients/shapes/texture), not
    noise — noise is PNG's worst case (6.2 MB / 336 ms encode at 1080p
    vs ~32 ms for image-like content) and would overstate the host
    codec share of the latency."""
    from cnn_sr.ops.png import encode_png
    from tools.generate_training_samples import synth_image

    im = synth_image(rng, size=max(h, w)).crop((0, 0, w, h))
    return encode_png(np.asarray(im))


def _post_status(url, body):
    """Returns (seconds, http_status). 503/429 (SLO shedding) return
    fast with the rejection status instead of raising."""
    import urllib.error

    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            resp.read()
        return time.perf_counter() - t0, 200
    except urllib.error.HTTPError as e:
        if e.code in (429, 503):
            return time.perf_counter() - t0, e.code
        raise


def _post(url, body):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        resp.read()
        assert resp.status == 200
    return time.perf_counter() - t0


def _percentiles(ts):
    a = np.sort(np.asarray(ts) * 1e3)
    return {
        "p50_ms": round(float(np.percentile(a, 50)), 1),
        "p90_ms": round(float(np.percentile(a, 90)), 1),
        "p99_ms": round(float(np.percentile(a, 99)), 1),
        "mean_ms": round(float(a.mean()), 1),
        "n": len(a),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n-seq", type=int, default=40)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--n-per-client", type=int, default=12)
    p.add_argument("--bucket", type=int, default=0,
                   help="pad batch groups to this size (kills the "
                        "compile-per-group-size latency tail under "
                        "concurrency: each distinct batch size "
                        "otherwise pays one compile)")
    p.add_argument("--deadline", type=float, default=0.0, metavar="S",
                   help="run the concurrent tables with the server's "
                        "latency SLO on (serve.py --deadline): 503/429 "
                        "rejections are counted as shed, percentiles "
                        "cover SERVED requests, so p99 reflects the "
                        "policy)")
    p.add_argument("--max-queue", type=int, default=0)
    args = p.parse_args(argv)

    from tools.serve import load_slot, make_server

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    slots = {
        "default": load_slot(
            os.path.join(root, "configs", "srcnn_9-5-5.json"), seed=0),
        "rgb": load_slot(
            os.path.join(root, "configs", "waifu2x_7layer_rgb.json"),
            seed=0),
    }
    server, worker = make_server(slots, bucket=args.bucket,
                                 deadline_s=args.deadline,
                                 max_queue=args.max_queue)
    worker.start()
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    host, port = server.server_address
    base = f"http://{host}:{port}/upscale"

    rng = np.random.default_rng(0)
    workloads = [
        ("luma_1080p", f"{base}?model=default", _png_bytes(rng, 1080, 1920)),
        ("rgb_540p", f"{base}?model=rgb", _png_bytes(rng, 540, 960)),
    ]

    try:
        for name, url, body in workloads:
            # warmup / compile (the first request pays the kernel compile)
            t_compile = _post(url, body)
            _post(url, body)
            # sequential single-request latency
            ts = [_post(url, body) for _ in range(args.n_seq)]
            row = {"metric": f"serving_latency_{name}_sequential",
                   **_percentiles(ts),
                   "compile_first_request_s": round(t_compile, 1),
                   "note": "single client, one request at a time"}
            print(json.dumps(row), flush=True)

            # concurrent clients through the batching queue
            all_ts: list = []
            shed = [0]
            lock = threading.Lock()

            def client():
                mine, my_shed = [], 0
                for _ in range(args.n_per_client):
                    dt, status = _post_status(url, body)
                    if status == 200:
                        mine.append(dt)
                    else:
                        my_shed += 1
                with lock:
                    all_ts.extend(mine)
                    shed[0] += my_shed

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client)
                       for _ in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            n_req = args.clients * args.n_per_client
            row = {"metric": f"serving_latency_{name}_concurrent"
                             f"{args.clients}"
                             + (f"_bucket{args.bucket}" if args.bucket
                                else "")
                             + (f"_deadline{args.deadline:g}"
                                if args.deadline else ""),
                   **_percentiles(all_ts),
                   "req_per_s": round(n_req / wall, 1),
                   "note": f"{args.clients} clients back-to-back; "
                           "batching-queue regime"}
            if args.deadline:
                row["shed"] = shed[0]
                row["shed_rate"] = round(shed[0] / n_req, 3)
                row["note"] += ("; percentiles over SERVED requests, "
                                "503/429 shed counted separately")
            print(json.dumps(row), flush=True)
    finally:
        server.shutdown()
        worker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
