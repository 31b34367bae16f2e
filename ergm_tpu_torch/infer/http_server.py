"""HTTP front end of the continuous-batching server (stdlib only;
counterpart of ``ergm_tpu/infer/http_server.py``).

The online surface: a localhost HTTP endpoint whose requests join the
same ``ContinuousServer`` slots at block boundaries, with optional
per-block streaming.

    POST /generate   {"prompt": [ids...] | "text": "...",
                      "max_new_tokens": 64, "greedy": true,
                      "top_p": 0.95, "temperature": 1.0,  # 0 = greedy
                      "seed": 0, "stop": [[ids...], ...],  # kept in the
                      # output, like eos; at most 16 sequences of 64
                      "logprobs": false, "stream": false,
                      "caption_ids": [...] | "caption": "...",
                      "session_id": "chat-42",  # multi-turn: the next
                      # turn prefills only its new tokens
                      "pool": "long"|"short"}   # tiered pools: pin one
      -> {"tokens": [...], "text": "...", "emotion_id": k,
          "latency_s": s}                            (stream=false)
      -> JSON lines {"tokens": [...], "text": ..., "done": false} ...
         closing with {"done": true, "emotion_id": k, "latency_s": s}
                                                     (stream=true; a chunk
         is one decode block's tokens, Request.stream_cb)
    GET  /health     {"slots": S, "active": n, "prefilling": c,
                      "queued": m, "served": k, "cancelled": x}

A streaming client that disconnects cancels its request: the handler's
failed write enqueues a cancel through the inbox that carries the
submissions (so it cannot overtake its own admission), and the driver
frees the slot at the next block boundary.

Threading: ``ContinuousServer`` has one owner. ONE driver thread owns it
and makes every CUDA call; HTTP handler threads only enqueue (request,
reply queue) pairs onto a thread-safe inbox and wait on their reply
queue, and never touch a tensor. The driver drains the inbox between
decode blocks, so requests join mid-stream. Stream chunks ride the same
reply queue through ``Request.stream_cb``, which the server calls on the
driver thread inside ``step()``. The tokenizer is any object with
``encode(text) -> ids`` and ``decode(ids) -> text``.

Over a mesh (``ContinuousServer(mesh=...)``) the front end listens on
rank 0 only; its driver's steps and flushes carry the submissions and
cancellations to the other ranks, which run ``srv.follow()`` until the
driver sends the stop (on ``close``, or when it fails). While idle the
driver sends ``srv.heartbeat()``, so the followers never wait in a
collective for as long as the process group's timeout.

Start it from Python::

    srv = ContinuousServer(params, cfg, slots=16, eos_id=..., sp2_id=...)
    fe = ServerFrontend(srv, tokenizer=tok, port=8000).start()
    fe.serve_forever()  # or fe.close() when done
"""


from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ergm_tpu_torch.infer.server import ContinuousServer, request_from_json

IDLE_SLEEP_S = 0.002  # driver's pause when no request is queued or running


class ServerFrontend:
    """Owns the driver thread and the HTTP listener.

    Usage::

        fe = ServerFrontend(srv, tokenizer=tok, port=8000)
        fe.start()          # returns immediately; fe.port is bound
        ...
        fe.close()
    """

    def __init__(self, server: ContinuousServer, tokenizer=None,
                 host: str = "127.0.0.1", port: int = 0, default_max_new: int = 128,
                 default_top_p: float = 0.95, default_seed: int = 0):
        self.srv = server
        self.tok = tokenizer
        # what a request that leaves these out gets (the CLI passes --top_p and --seed)
        self.defaults = dict(default_max_new=default_max_new, default_top_p=default_top_p,
                             default_seed=default_seed)
        self._inbox: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._served = 0
        self._cancelled = 0
        self._failure: Optional[str] = None  # driver-thread crash message
        self._replies = {}  # rid -> reply queue (driver thread only)
        self._streamed = {}  # rid -> chars of text already emitted

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            # one response per connection (HTTP/1.0 close semantics) keeps
            # streaming trivial: write chunks, flush, close
            protocol_version = "HTTP/1.0"

            def log_message(self, fmt, *args):  # stay quiet
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/health":
                    self.send_error(404)
                    return
                self._json(200, frontend.health())

            def do_POST(self):
                if self.path != "/generate":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    req, stream = frontend._build_request(payload)
                except Exception as e:  # noqa: BLE001 — user input boundary
                    self._json(400, {"error": str(e)})
                    return
                if frontend._failure is not None:
                    self._json(503, {"error": frontend._failure})
                    return
                reply: "queue.Queue" = queue.Queue()
                frontend._inbox.put((req, reply, stream))
                first = frontend._await(reply)
                if first[0] == "error":
                    self._json(503 if frontend._failure is not None else 400,
                               {"error": first[1]})
                    return
                if not stream:  # ("result", row)
                    self._json(200, first[1])
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.end_headers()
                msg = first
                while True:
                    row = (msg[1] if msg[0] != "error"
                           else {"error": msg[1], "done": True})
                    try:
                        self.wfile.write((json.dumps(row) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        # client went away mid-stream: cancel so the
                        # slot stops decoding a response nobody reads.
                        # Riding the SAME inbox as submissions makes the
                        # cancel arrive after its own request, with no
                        # ordering race against admission.
                        frontend._inbox.put(("cancel", reply, None))
                        return
                    if row.get("done"):
                        break
                    msg = frontend._await(reply)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name="ergm-serve-driver")
        self._listener = threading.Thread(target=self.httpd.serve_forever,
                                          daemon=True, name="ergm-serve-http")

    def _await(self, reply: "queue.Queue"):
        """Block on a reply queue, but never past a driver crash: a
        request enqueued in the instant between the crash and the inbox
        drain would otherwise wait forever."""
        while True:
            try:
                return reply.get(timeout=1.0)
            except queue.Empty:
                if self._failure is not None:
                    return ("error", self._failure)

    # -- request construction (handler threads; touches no server state) --

    def _build_request(self, payload):
        req = request_from_json(payload, self.tok, **self.defaults)
        return req, bool(payload.get("stream", False))

    def _decode(self, tokens):
        if self.tok is None:
            return None
        stop = tokens[:-1] if (tokens and tokens[-1] == self.srv.eos_id) else tokens
        return self.tok.decode(stop)

    # -- driver thread -----------------------------------------------------

    def _stream_text_delta(self, rid, acc_tokens):
        """Safely streamable text for the accumulated continuation.

        Byte-level BPE splits multi-byte UTF-8 characters across tokens,
        and block boundaries fall between arbitrary tokens — decoding
        each block's tokens in isolation would corrupt any character
        straddling the boundary. Decode the RUNNING prefix instead and
        emit only the newly stable delta, holding back a trailing
        replacement char (an incomplete sequence at the tail)."""
        full = self._decode(list(acc_tokens))
        if full is None:
            return None
        stable = full.rstrip("�")
        emitted = self._streamed.get(rid, 0)
        delta = stable[emitted:]
        self._streamed[rid] = max(emitted, len(stable))
        return delta

    def _admit_from_inbox(self):
        while True:
            try:
                req, reply, stream = self._inbox.get_nowait()
            except queue.Empty:
                return
            if req == "cancel":
                # a streaming client disconnected; reply identifies the
                # request (its rid may not exist yet when the disconnect
                # beat the admission — same-queue ordering rules that out)
                rid = next((r for r, (q_, _s) in self._replies.items()
                            if q_ is reply), None)
                if rid is not None:
                    self.srv.cancel(rid)
                    self._replies.pop(rid, None)
                    self._streamed.pop(rid, None)
                    self._cancelled += 1
                continue
            if stream:
                acc = []

                def cb(rid, new, done, _reply=reply, _acc=acc):
                    # driver thread, inside step(); ship the block's chunk
                    _acc.extend(new)
                    row = {"tokens": list(new), "done": False}
                    txt = self._stream_text_delta(rid, _acc)
                    if txt is not None:
                        row["text"] = txt
                    _reply.put(("chunk", row))
                req.stream_cb = cb
            try:
                rid = self.srv.submit(req)
            except ValueError as e:  # too long for the cache: reject loudly
                reply.put(("error", str(e)))
                continue
            self._replies[rid] = (reply, stream)

    def _deliver(self, results):
        for res in results:
            # the frontend owns delivery; don't let the server's results
            # dict grow without bound on a long-running endpoint
            self.srv.results.pop(res.request_id, None)
            entry = self._replies.pop(res.request_id, None)
            if entry is None:
                continue
            reply, stream = entry
            row = {"emotion_id": int(np.argmax(res.emotion_logits)),
                   "latency_s": round(res.latency_s, 4)}
            if res.logprobs is not None:
                row["logprobs"] = [round(x, 5) for x in res.logprobs]
            if stream:
                row["done"] = True
                final = self._decode(res.tokens)
                if final is not None:
                    # flush any text held back by the incomplete-tail
                    # guard so concatenated stream text == batch text
                    row["text"] = final[self._streamed.pop(res.request_id, 0):]
                reply.put(("chunk", row))
            else:
                row["tokens"] = res.tokens
                txt = self._decode(res.tokens)
                if txt is not None:
                    row["text"] = txt
                reply.put(("result", row))
            self._served += 1

    def _fail_all(self, msg: str):
        self._failure = msg
        for reply, _ in self._replies.values():
            reply.put(("error", msg))
        self._replies.clear()
        self._streamed.clear()
        while True:
            try:
                _, reply, _ = self._inbox.get_nowait()
            except queue.Empty:
                break
            reply.put(("error", msg))

    def _drive(self):
        try:
            while not self._stop.is_set():
                self._admit_from_inbox()
                if self.srv.busy():
                    self._deliver(self.srv.step())
                else:
                    # drain a pipelined in-flight block, then idle
                    if self.srv.in_flight():
                        self._deliver(self.srv.flush())
                    self.srv.heartbeat()
                    time.sleep(IDLE_SLEEP_S)
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            # without this every blocked client would hang forever on a
            # dead driver while /health kept answering 200
            self._fail_all(f"serving loop died: {type(e).__name__}: {e}")
            raise
        finally:
            # the thread that issued the mesh's collectives ends its followers
            self.srv.stop_followers()

    # -- lifecycle ----------------------------------------------------------

    def health(self):
        h = {"slots": self.srv.S,
             "active": sum(1 for s in self.srv.slots if s.active),
             "prefilling": sum(1 for s in self.srv.slots if s.prefilling),
             "queued": len(self.srv.queue),
             "served": self._served,
             "cancelled": self._cancelled}
        if self._failure is not None:
            h["error"] = self._failure
        return h

    def start(self):
        self._driver.start()
        self._listener.start()
        return self

    def close(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._driver.join(timeout=30)

    def serve_forever(self):
        """Block until interrupted, then close."""
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            self.close()
