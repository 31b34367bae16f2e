"""The port's HTTP front end (``ergm_tpu_torch/infer/http_server.py``)
over its continuous-batching server, the counterparts of ``ergm_tpu``'s
tests/test_http_server.py: concurrent localhost clients against the
port's greedy ``generate``, block streaming, health and errors, chunked
admission, a streaming client's disconnect, and UTF-8-safe text deltas.
A tiny fp32 model on the CPU; text goes through a stub byte tokenizer.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ergm_tpu_torch.infer.http_server import ServerFrontend
from ergm_tpu_torch.infer.server import ContinuousServer

from test_torch_server import EOS, SP2, _params, make_cfg, oracle_greedy

torch.set_num_threads(1)


class ByteTok:
    """Decodes one token a byte (byte-level BPE's worst case for
    streaming); encodes into the tiny model's vocabulary."""

    def encode(self, text):
        return [b % 50 for b in text.encode()]

    def decode(self, toks):
        return bytes(t % 256 for t in toks).decode("utf-8", errors="replace")


def _frontend(**kw):
    cfg = make_cfg()
    params = _params(cfg)
    base = dict(slots=2, eos_id=EOS, sp2_id=SP2, max_prompt=32, prompt_bucket=16, sync_every=3)
    srv = ContinuousServer(params, cfg, **{**base, **kw})
    return ServerFrontend(srv, tokenizer=ByteTok(), port=0).start(), cfg, params


@pytest.fixture(scope="module")
def frontend():
    fe, cfg, params = _frontend()
    yield fe, cfg, params
    fe.close()


def _post(fe, payload, timeout=120):
    req = urllib.request.Request(f"http://{fe.host}:{fe.port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _health(fe):
    with urllib.request.urlopen(f"http://{fe.host}:{fe.port}/health", timeout=30) as r:
        return json.loads(r.read())


def test_concurrent_requests_match_oracle(frontend):
    fe, cfg, params = frontend
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50, (n,)).tolist() for n in (5, 11, 17, 8)]
    outs = [None] * len(prompts)

    def worker(i):
        with _post(fe, {"prompt": prompts[i], "max_new_tokens": 8, "greedy": True}) as r:
            outs[i] = json.loads(r.read())

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for p, o in zip(prompts, outs):
        assert o["tokens"] == oracle_greedy(params, cfg, p, 8)[0]
        assert o["text"] == ByteTok().decode([t for t in o["tokens"] if t != EOS])
        assert 0 <= o["emotion_id"] < 7 and o["latency_s"] > 0


def test_streaming_chunks_concatenate(frontend):
    """Block-granular chunks concatenate to the oracle's tokens and their
    text to the whole text; a two-turn session streams its second turn."""
    fe, cfg, params = frontend
    rng = np.random.default_rng(1)
    p = rng.integers(0, 50, (9,)).tolist()

    def stream(payload):
        with _post(fe, {**payload, "stream": True}) as r:
            return [json.loads(line) for line in r]

    rows = stream({"prompt": p, "max_new_tokens": 10, "greedy": True, "session_id": "x"})
    assert rows[-1]["done"] is True and "emotion_id" in rows[-1] and not rows[-1].get("tokens")
    toks = [t for row in rows[:-1] for t in row["tokens"]]
    assert toks == oracle_greedy(params, cfg, p, 10)[0] and len(rows) > 2
    assert "".join(row["text"] for row in rows) == ByteTok().decode(
        [t for t in toks if t != EOS])
    p2 = p + toks + rng.integers(0, 50, (4,)).tolist()
    rows = stream({"prompt": p2, "max_new_tokens": 6, "greedy": True, "session_id": "x"})
    assert [t for row in rows[:-1] for t in row["tokens"]] == oracle_greedy(params, cfg, p2, 6)[0]
    assert fe.srv.ext_programs == 1


def test_health_and_errors(frontend):
    fe, _, _ = frontend
    h = _health(fe)
    assert h["slots"] == 2 and h["served"] >= 1 and "prefilling" in h
    for payload in ({"max_new_tokens": 4},                       # no prompt or text
                    {"prompt": list(range(40)), "max_new_tokens": 4},  # past max_prompt
                    {"prompt": [1, 2], "pool": "middle"}):            # unknown pool
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(fe, payload)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{fe.host}:{fe.port}/nope", timeout=30)
    assert e.value.code == 404
    with _post(fe, {"text": "hi", "max_new_tokens": 2, "greedy": True}) as r:
        assert len(json.loads(r.read())["tokens"]) >= 1


def test_chunked_admission_stays_live():
    """The drive loop steps while a chunked admission is in progress (a
    prefilling slot is neither active nor queued)."""
    fe, cfg, params = _frontend(max_prompt=128, sync_every=2, prefill_chunk=16)
    try:
        rng = np.random.default_rng(40)
        short = rng.integers(0, 50, (6,)).tolist()
        long_p = rng.integers(0, 50, (110,)).tolist()
        outs = {}

        def worker(name, prompt, budget):
            with _post(fe, {"prompt": prompt, "max_new_tokens": budget, "greedy": True}) as r:
                outs[name] = json.loads(r.read())

        ts = threading.Thread(target=worker, args=("short", short, 6))
        tl = threading.Thread(target=worker, args=("long", long_p, 4))
        ts.start()
        tl.start()
        ts.join(timeout=120)
        tl.join(timeout=120)
        assert not ts.is_alive() and not tl.is_alive(), "the chunked request hung"
        assert outs["long"]["tokens"] == oracle_greedy(params, cfg, long_p, 4)[0]
        assert outs["short"]["tokens"] == oracle_greedy(params, cfg, short, 6)[0]
        assert fe.srv.ext_programs >= 6
    finally:
        fe.close()


def test_stream_disconnect_cancels_request():
    """A streaming client that disconnects cancels its request (its slot
    frees) without disturbing a concurrent request."""
    fe, cfg, params = _frontend(sync_every=2)
    try:
        rng = np.random.default_rng(41)
        doomed = rng.integers(0, 50, (8,)).tolist()
        survivor = rng.integers(0, 50, (11,)).tolist()
        payload = json.dumps({"prompt": doomed, "max_new_tokens": 200, "greedy": True,
                              "stream": True}).encode()
        sock = socket.create_connection((fe.host, fe.port), timeout=60)
        sock.sendall(b"POST /generate HTTP/1.0\r\nContent-Type: application/json\r\n"
                     + f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
        sock.recv(1)  # the streamed response has started
        sock.close()
        with _post(fe, {"prompt": survivor, "max_new_tokens": 8, "greedy": True}) as r:
            assert json.loads(r.read())["tokens"] == oracle_greedy(params, cfg, survivor, 8)[0]
        deadline = time.time() + 60
        while time.time() < deadline:
            h = _health(fe)
            if h["cancelled"] == 1 and h["active"] == 0:
                break
            time.sleep(0.05)
        assert h["cancelled"] == 1 and h["active"] == 0, h
        assert not fe._replies and not fe._streamed
    finally:
        fe.close()


def test_stream_text_delta_utf8_block_boundary():
    """A multi-byte character split across a block boundary is emitted
    once, whole: the running prefix is decoded and an incomplete tail held
    back."""
    fe = ServerFrontend.__new__(ServerFrontend)
    fe.tok, fe.srv, fe._streamed = ByteTok(), SimpleNamespace(eos_id=999), {}
    s = "héllo wörld"
    data = list(s.encode())
    emitted = "".join(fe._stream_text_delta(7, data[:i + 3]) for i in range(0, len(data), 3))
    emitted += ByteTok().decode(data)[fe._streamed.pop(7, 0):]
    assert emitted == s and "�" not in emitted
