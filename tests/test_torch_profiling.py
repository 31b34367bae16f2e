"""The port's profiling utilities (``ergm_tpu_torch/utils/profiling.py``)
on the CPU, modelled on JAX's ``tests/test_profiling.py``: a captured
trace holds the annotated region, the step timer skips its first step,
and the on-demand endpoint writes a trace."""
import json
import os
import threading
import urllib.request

import torch

from ergm_tpu_torch.utils.profiling import (StepTimer, annotate, capture, start_server,
                                            trace_files)

torch.set_num_threads(1)


def test_annotate_and_capture(tmp_path):
    x = torch.ones((64, 64))
    with capture(str(tmp_path)):
        with annotate("matmul-under-test"):
            (x @ x).sum().item()
    traces = trace_files(str(tmp_path))
    assert traces, "no trace written"
    assert os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "matmul-under-test" for e in events)
    assert any("mm" in str(e.get("name")) for e in events)


def test_step_timer():
    timer = StepTimer()
    x = torch.ones((32, 32))
    y = x
    for _ in range(4):
        with timer.step(fetch=lambda: y):
            y = x @ x
    s = timer.summary()
    assert s["steps"] == 3  # first skipped
    assert s["mean_s"] > 0 and s["steps_per_s"] > 0
    assert s["p95_s"] >= s["p50_s"]
    assert StepTimer().summary() == {}


def test_start_server_records_on_demand(tmp_path):
    """``GET /capture`` records for the requested milliseconds into the
    requested directory and answers with the trace's path."""
    srv = start_server(0, str(tmp_path / "default"))
    try:
        port = srv.server_address[1]
        got = {}
        client = threading.Thread(target=lambda: got.update(json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/capture?duration_ms=300&logdir={tmp_path}/asked",
            timeout=60).read())))
        client.start()
        x = torch.ones((128, 128))
        while client.is_alive():
            x = torch.tanh(x @ x)
        client.join()
        assert got["trace"] and got["trace"].startswith(str(tmp_path / "asked"))
        assert os.path.getsize(got["trace"]) > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/capture?duration_ms=10",
                                    timeout=60) as r:
            assert json.loads(r.read())["trace"].startswith(str(tmp_path / "default"))
    finally:
        srv.shutdown()
        srv.server_close()
