"""Latency-SLO policy tests for the serving front-end.

The published concurrent p99 showed that during a backend stall every
queued client blocked for minutes and then still got served; the SLO
policy turns that into fast, honest rejections. These tests drive the
admission control and deadline paths deterministically by seeding the
worker's EWMA / dispatch markers (the real signals are timing-based).
"""

import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


@pytest.fixture
def cfg_path(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(CFG))
    return str(p)


def _make_worker(cfg_path, **kw):
    import serve

    slots = {"default": serve.load_slot(cfg_path, seed=0)}
    return serve.DeviceWorker(slots, **kw)


def _job():
    import serve

    return serve._Job("default", np.zeros((20, 20, 4), np.uint8))


def test_queue_bound_rejects_429(cfg_path):
    import serve

    worker = _make_worker(cfg_path, max_queue=1)  # worker NOT started
    worker.submit(_job())  # fills the queue
    with pytest.raises(serve.Rejected) as e:
        worker.submit(_job())
    assert e.value.code == 429
    assert worker.snapshot()["rejected_queue_full"] == 1


def test_load_shed_rejects_503_with_retry_after(cfg_path):
    import serve

    worker = _make_worker(cfg_path, deadline_s=1.0)
    worker._ewma_job_s = 10.0  # one queued job -> est wait 10 s > 1 s
    worker.submit(_job())
    with pytest.raises(serve.Rejected) as e:
        worker.submit(_job())
    assert e.value.code == 503
    assert e.value.retry_after_s > 0
    assert worker.snapshot()["rejected_load"] == 1


def test_cold_start_never_sheds(cfg_path):
    # EWMA is None until the first round completes: compile warmup must
    # be admitted no matter the deadline or queue depth
    worker = _make_worker(cfg_path, deadline_s=0.001)
    for _ in range(5):
        worker.submit(_job())
    assert worker.snapshot()["rejected_load"] == 0


def test_deadline_exceeded_at_dequeue(cfg_path):
    import serve

    worker = _make_worker(cfg_path, deadline_s=0.5)
    job = _job()
    worker.submit(job)
    job.t_submit -= 10.0  # it "sat queued" past the deadline
    worker.start()
    try:
        assert job.done.wait(30)
        assert isinstance(job.error, serve.DeadlineExceeded)
        assert worker.snapshot()["rejected_deadline"] == 1
    finally:
        worker.stop()


def test_stats_stall_indicator(cfg_path):
    worker = _make_worker(cfg_path)
    snap = worker.snapshot()
    assert snap["stalled"] is False and snap["ewma_job_s"] is None
    worker._ewma_job_s = 0.05
    worker._dispatch_started = time.monotonic() - 100.0
    snap = worker.snapshot()
    assert snap["stalled"] is True
    assert snap["dispatch_elapsed_s"] > 99
    # the in-flight stall also inflates the admission estimate
    assert snap["est_wait_s"] > 99


def test_http_503_shed_and_headers(cfg_path):
    """End-to-end: an overloaded server answers 503 + Retry-After
    immediately, and /stats reports the SLO fields."""
    import serve

    slots = {"default": serve.load_slot(cfg_path, seed=0)}
    server, worker = serve.make_server(slots, "127.0.0.1", 0,
                                       deadline_s=1.0)
    worker.start()
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    port = server.server_address[1]
    try:
        # simulate a stalled in-flight dispatch (the worker thread is
        # idle; the marker is what admission control reads)
        worker._ewma_job_s = 50.0
        worker._dispatch_started = time.monotonic()

        img = np.random.default_rng(0).integers(
            0, 256, (20, 20, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img, "RGB").save(buf, "PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/upscale", data=buf.getvalue(),
            method="POST")
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) >= 1
        assert time.monotonic() - t0 < 5  # fast rejection, no blocking

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats") as r:
            stats = json.load(r)
        assert stats["rejected_load"] == 1
        assert stats["deadline_s"] == 1.0

        # stall clears -> the same request is admitted and served
        worker._dispatch_started = None
        worker._ewma_job_s = 0.01
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/upscale", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req) as r:
            out = np.asarray(Image.open(io.BytesIO(r.read())))
        assert out.shape == (20, 20, 3)
    finally:
        server.shutdown()
        worker.stop()
