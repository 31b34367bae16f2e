"""Profiling and tracing utilities (counterpart of
``ergm_tpu/utils/profiling.py``).

Named regions that show in ``torch.profiler`` traces (and as NVTX ranges
on the card), a capture context that writes a Chrome trace TensorBoard's
profile plugin reads (``tensorboard --logdir``), an on-demand capture
endpoint, and a step timer whose completion barrier is a host read of
the step's result.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, List

import numpy as np
import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region: ``torch.profiler.record_function`` (a span in the
    profiler's trace) and, with a card present, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def capture(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body (host operations, and the card's kernels when one
    is present) and write ``<logdir>/<host>_<pid>.<ms>.pt.trace.json``
    on exit. Yields the profiler (``key_averages()`` for a table)."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


def trace_files(logdir: str) -> List[str]:
    """The trace files ``capture`` wrote under ``logdir``, oldest first."""
    out = []
    for root, _, files in os.walk(logdir):
        out += [os.path.join(root, f) for f in files if ".pt.trace.json" in f]
    return sorted(out, key=os.path.getmtime)


class _CaptureHandler(BaseHTTPRequestHandler):
    """``GET /capture?duration_ms=N&logdir=DIR``: records a trace for N ms
    into DIR and answers ``{"trace": path, "events": count}``."""

    lock = threading.Lock()

    def do_GET(self):  # noqa: N802 - http.server's name
        url = urllib.parse.urlparse(self.path)
        if url.path != "/capture":
            self.send_error(404)
            return
        q = urllib.parse.parse_qs(url.query)
        ms = float(q.get("duration_ms", ["1000"])[0])
        logdir = q.get("logdir", [self.server.logdir])[0]
        with self.lock:  # one profiler at a time
            before = set(trace_files(logdir)) if os.path.isdir(logdir) else set()
            with capture(logdir) as prof:
                time.sleep(ms / 1e3)
            new = [f for f in trace_files(logdir) if f not in before]
            body = {"trace": new[-1] if new else None, "events": len(prof.events())}
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def start_server(port: int = 9012, logdir: str = "profiles", host: str = "127.0.0.1"):
    """An on-demand capture endpoint on ``host:port`` (port 0: a free one),
    served by a daemon thread: ``GET /capture?duration_ms=N&logdir=DIR``
    records everything the process runs for N ms, the card's kernels
    included whichever thread launched them, into DIR (default
    ``logdir``). Returns the server; ``server.server_address`` has the
    port, ``server.shutdown()`` stops it."""
    srv = ThreadingHTTPServer((host, port), _CaptureHandler)
    srv.logdir = logdir
    threading.Thread(target=srv.serve_forever, daemon=True, name="ergm-profiler").start()
    return srv


class StepTimer:
    """Wall-clock step timer whose barrier is a host read of ``fetch()``.

    >>> timer = StepTimer()
    >>> with timer.step(fetch=lambda: metrics["loss"]):
    ...     state, metrics = train_step(state, batch, seed)
    >>> timer.summary()  # {'steps': ..., 'mean_s': ..., 'p50_s': ..., ...}
    """

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self, fetch=None):
        t0 = time.perf_counter()
        yield
        if fetch is not None:
            out = fetch()
            np.asarray(out.detach().cpu() if torch.is_tensor(out) else out)
        self.times.append(time.perf_counter() - t0)

    def summary(self, skip_first: int = 1) -> dict:
        ts = self.times[skip_first:] if len(self.times) > skip_first else self.times
        if not ts:
            return {}
        arr = np.asarray(ts)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / arr.mean()),
        }
