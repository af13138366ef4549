"""`llm-server` of the port: ``python -m tpu_llm_torch.runtime.server``.

Online HTTP serving over the continuous-batching engines
(``tpu_llm/runtime/server.py``): requests arrive over HTTP while decode
runs; one loop thread owns the engine and steps it whenever a slot is
live, admitting arrivals between steps. stdlib ``http.server`` only.

API (JSON over HTTP), the JAX package's:

  POST /v1/completions (and /completions)
    {"prompt": str, "max_tokens", "temperature", "seed", "stop_at_eos",
     "stream", "n" (<= 8), "echo", "stop" (<= 4 strings), "top_k",
     "top_p", "min_p", "frequency_penalty", "presence_penalty",
     "repetition_penalty", "logit_bias", "logprobs" (int N, or a bool)}
    -> {"completion", "tokens", "n_tokens", "ttft_s"} plus OpenAI's
    "id" / "object" / "created" / "model" / "choices" / "usage". With
    "stream": true, ``text/event-stream`` in hand-made chunked framing:
    one ``data: {...}`` event a token (text held back while it could
    still grow into a stop string), a ``{"done": true, ...}`` event and
    the ``data: [DONE]`` sentinel.
  POST /v1/chat/completions
    {"messages": [...], "chat_template", "logprobs" (bool),
     "top_logprobs", ...the same knobs} rendered through a chat template
    (zephyr, plain, llama2, llama3, chatml, gemma): the scaffolding is
    tokenized with special-token parsing, the message bodies without, so
    user text cannot inject control tokens; replies stop at EOS and the
    vocabulary's end-of-generation markers.
  POST /v1/embeddings
    {"input": str or [str]} -> mean-pooled, L2-normalised final hidden
    states of one prefill forward (no classifier), f32.
  GET /v1/models, /health, /stats.
  Errors: 400 (bad request, or an engine refusal), 404 (no route), 501
  (no embedder), 503 (queue full), 504 (timed out).

Threading: handler threads never touch the engine or the card. They
enqueue a (Request, _Tracker) pair and wait on the tracker; the loop
thread submits, steps and publishes each token through the tracker
(``Request.stream`` runs inside ``engine.step()``), and cancels a request
whose stop string matched between steps. Unlike the JAX package, the
embeddings run on the loop thread too: the handler enqueues a job and
waits, and the loop runs it between engine steps. The card's kernels keep
shared state (the K-split and split-decode merge counters, the FFN
megakernel's lazily sized counters), and a CUDA-graph capture fails if
another thread launches work during it, so one thread launches everything.
The responses are the JAX package's. The loop thread runs under
``torch.inference_mode()`` (a per-thread switch), so no step is recorded
for autograd.

--tp / --dp (and --lora) as ``llm-serve`` takes them: rank 0 owns the
HTTP server and the loop, and broadcasts each step's plan to the other
ranks, which run the same step (``ServingLoop``, ``follow``).
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from tpu_llm_torch.runtime.batching import Request, _first_leaf, to_device
from tpu_llm_torch.runtime.engine import _next_bucket


def render_chat_segments(messages, template: str = "zephyr"):
    """An OpenAI-style messages list as (text, is_scaffolding) segments.

    Scaffolding (role headers, turn separators) carries control markers
    that must tokenize to their special-token ids; message bodies are
    tokenized without special-token parsing, so ``<|eot_id|>`` or ``</s>``
    in user content stays literal text.

    "zephyr" is TinyLlama-1.1B-Chat's format: ``<|role|>\\n{content}</s>\\n``
    a message, then the assistant header. "plain": ``role: content``
    lines, then ``assistant:``. "llama2": [INST] turns, the system prompt
    folded into the first user turn inside <<SYS>>, each completed
    assistant turn closed with ``</s><s>`` (llama.cpp's multi-turn
    rendering; the first BOS is the engine's). "llama3": header-id turns
    closed by <|eot_id|>. "chatml": <|im_start|> / <|im_end|> turns.
    "gemma": <start_of_turn>user|model turns, the system prompt folded
    into the first user turn."""
    for m in messages:
        if not isinstance(m, dict) or "content" not in m:
            raise ValueError("each message needs role/content")
    segs = []
    if template == "zephyr":
        for m in messages:
            segs.append((f"<|{m.get('role', 'user')}|>\n", True))
            segs.append((m["content"], False))
            segs.append(("</s>\n", True))
        segs.append(("<|assistant|>\n", True))
        return segs
    if template == "plain":
        for m in messages:
            segs.append((f"{m.get('role', 'user')}: ", True))
            segs.append((m["content"], False))
            segs.append(("\n", True))
        segs.append(("assistant:", True))
        return segs
    if template == "llama2":
        sys_txt = None
        first_user = True
        for m in messages:
            role = m.get("role", "user")
            if role == "system":
                sys_txt = m["content"]
                continue
            if role == "assistant":
                segs.append((" ", True))
                segs.append((m["content"], False))
                segs.append((" </s><s>", True))
                continue
            segs.append(("[INST] ", True))
            if first_user and sys_txt:
                segs.append(("<<SYS>>\n", True))
                segs.append((sys_txt, False))
                segs.append(("\n<</SYS>>\n\n", True))
            segs.append((m["content"], False))
            segs.append((" [/INST]", True))
            first_user = False
        return segs
    if template == "llama3":
        for m in messages:
            segs.append((f"<|start_header_id|>{m.get('role', 'user')}"
                         "<|end_header_id|>\n\n", True))
            segs.append((m["content"], False))
            segs.append(("<|eot_id|>", True))
        segs.append(("<|start_header_id|>assistant<|end_header_id|>\n\n", True))
        return segs
    if template == "chatml":
        for m in messages:
            segs.append((f"<|im_start|>{m.get('role', 'user')}\n", True))
            segs.append((m["content"], False))
            segs.append(("<|im_end|>\n", True))
        segs.append(("<|im_start|>assistant\n", True))
        return segs
    if template == "gemma":
        sys_txt = None
        for m in messages:
            role = m.get("role", "user")
            if role == "system":
                sys_txt = m["content"]
                continue
            turn = "model" if role == "assistant" else "user"
            segs.append((f"<start_of_turn>{turn}\n", True))
            if role != "assistant" and sys_txt:
                segs.append((sys_txt, False))
                segs.append(("\n\n", True))
                sys_txt = None
            segs.append((m["content"], False))
            segs.append(("<end_of_turn>\n", True))
        segs.append(("<start_of_turn>model\n", True))
        return segs
    raise ValueError(f"unknown chat template {template!r}")


def render_chat(messages, template: str = "zephyr") -> str:
    """The rendered prompt string (the segments joined)."""
    return "".join(t for t, _ in render_chat_segments(messages, template))


def encode_chat(tokenizer, messages, template: str = "zephyr"):
    """Token ids of a chat: scaffolding with parse_special=True, message
    bodies without. BOS is the engine's."""
    ids = []
    for text, scaffolding in render_chat_segments(messages, template):
        ids.extend(tokenizer.encode(text, parse_special=scaffolding))
    return ids


class Embedder:
    """/v1/embeddings: mean-pooled (over the real length), L2-normalised
    final hidden states of one prefill forward, in f32, without the
    classifier. Each call runs on a state of its own (one row, the
    input's bucket of at most ``max_len`` rows), never the engine's
    cache or pools. Called on the serving loop's thread only."""

    def __init__(self, params, adapter, max_len: int = 512):
        self.params = params
        self.adapter = adapter
        self.max_len = max_len

    def embed(self, ids) -> np.ndarray:
        ids = ids[:self.max_len]
        pad = min(_next_bucket(len(ids)), self.max_len)
        toks = np.zeros((1, pad), np.int64)
        toks[0, :len(ids)] = ids
        state = self.adapter.init_state(1, pad)
        dev = _first_leaf(state).device
        hidden, _ = self.adapter.apply(self.params, to_device(toks, torch.long, dev), state, 0,
                                       length=len(ids))
        mask = (torch.arange(pad, device=dev) < len(ids))[None, :, None]
        pooled = (hidden.float() * mask).sum(dim=1) / len(ids)
        out = pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return out[0].cpu().numpy()


def _decode_toks(tokenizer, toks) -> str:
    out = tokenizer.decode(toks)
    if isinstance(out, bytes):
        out = out.decode("utf-8", errors="replace")
    return out


class _Tracker:
    """Handler <-> loop handshake for one request."""

    def __init__(self, want_stream: bool):
        self.done = threading.Event()
        self.events: Optional[queue.Queue] = queue.Queue() if want_stream else None
        self.error: Optional[str] = None
        self.t_enqueue = time.monotonic()
        self.t_first: Optional[float] = None
        # stop strings (OpenAI `stop`): the scanner runs on the loop thread
        # a token; a match records the character offset of the earliest
        # stop and asks the loop to cancel the request
        self.stop: list = []
        self._scanner = None         # () -> Optional[int] over the decoded text
        self.stop_cut: Optional[int] = None
        self.want_cancel = False

    # called on the loop thread (from Request.stream)
    def on_token(self, tok: int) -> None:
        if self.t_first is None:
            self.t_first = time.monotonic()
        # scan before publishing, so a stream consumer that takes the token
        # sees stop_cut no later than the token that matched
        if self._scanner is not None and self.stop_cut is None:
            cut = self._scanner()
            if cut is not None:
                self.stop_cut = cut
                self.want_cancel = True
        if self.events is not None:
            self.events.put(tok)

    def finish(self, error: Optional[str] = None) -> None:
        self.error = error
        if self.events is not None:
            self.events.put(None)        # stream sentinel
        self.done.set()


class _Job:
    """A function for the loop thread to run between engine steps;
    ``spec`` describes it to the other ranks of a mesh (the token ids of
    an embedding job, which every rank runs)."""

    def __init__(self, fn: Callable, spec=None):
        self.fn = fn
        self.spec = spec
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


# the Request fields a plan carries to the other ranks (not the callback,
# nor what the engine fills)
_PLAN_FIELDS = ("prompt", "max_new", "temperature", "seed", "stop_at_eos", "top_k", "top_p",
                "min_p", "logprobs", "top_logprobs", "frequency_penalty", "presence_penalty",
                "repetition_penalty", "logit_bias", "stop_token_ids")


class ServingLoop(threading.Thread):
    """Owns the engine: the only thread that calls submit / step /
    _collect / cancel, and the only one that launches work on the card
    (embedding jobs included).

    On a mesh of ranks (``mesh``: the engine placed by
    parallel/serving.shard_engine) this loop runs on the first rank, which
    owns the HTTP queue: before each step it broadcasts the step's plan
    (admissions, cancellations, embedding jobs, stop) on the CPU control
    group, at least every 0.25 s, and every other rank runs the same step
    (``follow``). A failed step there ends the server with an error (a
    rank is gone or out of step): no restart."""

    daemon = True

    def __init__(self, engine, max_queue: int = 256, mesh=None):
        super().__init__(name="llm-serving-loop")
        self.engine = engine
        self.max_queue = max_queue
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.failed: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._pending = []           # [(Request, _Tracker)]
        self._jobs = []              # [_Job]
        self._tracked = {}           # rid -> (Request, _Tracker)
        self._stopping = False
        self.t0 = time.monotonic()
        self.n_requests = 0
        self.n_completed = 0
        self.n_tokens = 0
        self.n_restarts = 0

    # -- handler-thread API -------------------------------------------------

    def enqueue(self, req, tracker: _Tracker) -> bool:
        """Queue a request for the loop thread. False if at capacity."""
        with self._cv:
            if self._stopping:
                return False
            if len(self._pending) + len(self.engine._queue) >= self.max_queue:
                return False
            self._pending.append((req, tracker))
            self.n_requests += 1
            self._cv.notify()
        return True

    def call(self, fn: Callable, timeout: float, spec=None):
        """Run ``fn()`` on the loop thread between engine steps and return
        its result (its exception is raised here). RuntimeError when the
        loop is stopping, TimeoutError when ``timeout`` passes first. On a
        mesh, ``spec`` (an embedding job's token id lists) lets the other
        ranks run it too."""
        if self.mesh is not None and spec is None:
            raise RuntimeError("a job on a mesh of ranks needs its spec")
        job = _Job(fn, spec)
        with self._cv:
            if self._stopping:
                raise RuntimeError("serving loop is stopping")
            self._jobs.append(job)
            self._cv.notify()
        if not job.done.wait(timeout=timeout):
            raise TimeoutError("job timed out")
        if job.error is not None:
            raise job.error
        return job.result

    def shutdown(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self.join(timeout=30)

    def snapshot(self) -> dict:
        eng = self.engine
        out = {
            "uptime_s": round(time.monotonic() - self.t0, 1),
            "requests": self.n_requests,
            "completed": self.n_completed,
            "active": eng.n_active,
            "queued": len(eng._queue) + len(self._pending),
            "generated_tokens": self.n_tokens,
            "engine": type(eng).__name__,
        }
        if self.n_restarts:
            out["engine_restarts"] = self.n_restarts
        stats = getattr(eng, "stats", None)
        if stats and stats.get("spec_forwards"):
            out["spec_tokens_per_forward"] = round(
                stats["spec_tokens"] / stats["spec_forwards"], 2)
        prefix = getattr(eng, "prefix", None)
        if prefix is not None and prefix.queries:
            out["prefix_cache_hit_rate"] = round(prefix.hits / prefix.queries, 3)
            out["hbm_blocks_in_use"] = eng.hbm_blocks_in_use
        return out

    # -- loop thread ---------------------------------------------------------

    def run(self) -> None:
        try:
            with torch.inference_mode():
                self._run()
        except BaseException as e:      # noqa: BLE001 — main() reads .failed
            self.failed = e
            raise

    def _share(self, **plan) -> None:
        """The step's plan to the other ranks of the mesh."""
        if self.mesh is not None:
            self.mesh.broadcast_object(plan)

    def _run(self) -> None:
        eng = self.engine
        while True:
            with self._cv:
                while (not self._stopping and not self._pending and not self._jobs
                       and not (eng._queue or eng.n_active)):
                    self._cv.wait(timeout=0.25)
                    if self.mesh is not None:
                        break                # the other ranks wait for a plan
                if self._stopping and not (self._pending or eng._queue or eng.n_active):
                    for job in self._jobs:
                        job.error = RuntimeError("serving loop is stopping")
                        job.done.set()
                    self._share(stop=True)
                    return
                pending, self._pending = self._pending, []
                jobs, self._jobs = self._jobs, []
            cancels = [rid for rid, (req, tr) in self._tracked.items()
                       if tr.want_cancel and not req.done]
            self._share(stop=False, cancel=cancels, jobs=[job.spec for job in jobs],
                        submit=[{f: getattr(req, f) for f in _PLAN_FIELDS}
                                for req, _ in pending])
            for req, tr in pending:
                try:
                    eng.submit(req)
                except (ValueError, MemoryError) as e:
                    tr.finish(error=str(e))
                    continue
                self._tracked[req.rid] = (req, tr)
            for job in jobs:
                try:
                    job.result = job.fn()
                except Exception as e:     # noqa: BLE001 — handed to the caller
                    job.error = e
                job.done.set()
            # stop-string matches recorded by the token callbacks: cancel
            # between steps (the engine is only touched from this thread)
            for rid in cancels:
                eng.cancel(self._tracked[rid][0])
            if eng._queue or eng.n_active:
                try:
                    eng.step()
                except MemoryError as e:
                    # admission can never fit: fail every queued request
                    # rather than spin (running slots keep decoding)
                    for req in list(eng._queue):
                        tr = self._tracked.pop(req.rid, (None, None))[1]
                        eng._queue.remove(req)
                        if tr:
                            tr.finish(error=str(e))
                except Exception as e:     # noqa: BLE001 — recovery path
                    if self.mesh is not None:
                        self._fail(e)
                        raise
                    self._restart(e)
                if not (eng._queue or eng.n_active):
                    eng._collect()   # flush the pipelined last step
            self._reap()

    def _fail(self, exc: BaseException) -> None:
        """A failed step on a mesh: fail every request and stop."""
        print(f"[llm-server] engine step failed on a mesh of ranks ({exc!r}); "
              f"the server stops", file=sys.stderr, flush=True)
        with self._cv:
            self._stopping = True
        for rid, (req, tr) in list(self._tracked.items()):
            req.done = True
            tr.finish(error=f"engine failed: {exc}")
        self._tracked.clear()

    def _restart(self, exc: BaseException) -> None:
        """Engine-step crash recovery: fail every in-flight and queued
        request loudly, then rebuild all decode state (``engine.reset()``)
        so serving resumes; only the weights survive."""
        import traceback

        self.n_restarts += 1
        print(f"[llm-server] engine step crashed ({exc!r}); restarting engine "
              f"(#{self.n_restarts})", file=sys.stderr, flush=True)
        traceback.print_exc(file=sys.stderr)
        msg = f"engine restarted after internal error: {exc}"
        for rid, (req, tr) in list(self._tracked.items()):
            req.done = True
            tr.finish(error=msg)
            self._tracked.pop(rid, None)
        try:
            self.engine.reset()
        except Exception as e2:          # noqa: BLE001
            # unrecoverable (the device is gone): stop the loop loudly
            print(f"[llm-server] engine reset failed: {e2!r}; serving loop stopping",
                  file=sys.stderr, flush=True)
            with self._cv:
                self._stopping = True
            raise

    def _reap(self) -> None:
        done = [rid for rid, (req, _) in self._tracked.items() if req.done]
        for rid in done:
            req, tr = self._tracked.pop(rid)
            self.n_completed += 1
            self.n_tokens += len(req.tokens)
            tr.finish()


def follow(engine, mesh, embedder) -> None:
    """The serving loop of a rank other than the first: each step's plan
    from the first rank (``ServingLoop``), then the same submissions,
    embedding jobs, cancellations and step, until the plan says stop."""
    from tpu_llm_torch.runtime.batching import Request

    tracked = {}
    with torch.inference_mode():
        while True:
            plan = mesh.broadcast_object()
            if plan["stop"]:
                return
            for fields in plan["submit"]:
                req = Request(**fields)
                try:
                    engine.submit(req)
                except (ValueError, MemoryError):
                    continue
                tracked[req.rid] = req
            for ids in plan["jobs"]:
                [embedder.embed(x) for x in ids]
            for rid in plan["cancel"]:
                engine.cancel(tracked[rid])
            if engine._queue or engine.n_active:
                try:
                    engine.step()
                except MemoryError:
                    engine._queue.clear()
                if not (engine._queue or engine.n_active):
                    engine._collect()
            tracked = {rid: r for rid, r in tracked.items() if not r.done}


def make_handler(loop: ServingLoop, tokenizer, max_new_cap: int,
                 request_timeout_s: float = 600.0, model_name: str = "tpu-llm",
                 chat_template: str = "zephyr", embedder: Optional[Embedder] = None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "llm-server"

        def log_message(self, fmt, *args):  # stderr chatter off by default
            if loop_verbose:
                sys.stderr.write("%s - %s\n" % (self.address_string(), fmt % args))

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _embeddings(self):
            if embedder is None:
                self._json(501, {"error": "embeddings not enabled"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                inputs = body["input"]
                if isinstance(inputs, str):
                    inputs = [inputs]
                if not inputs or not all(isinstance(s, str) and s for s in inputs):
                    raise ValueError("input must be a non-empty string or list of strings")
            except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            ids = [tokenizer.encode(text) for text in inputs[:64]]
            try:
                vecs = loop.call(lambda: [embedder.embed(x) for x in ids],
                                 timeout=request_timeout_s, spec=ids)
            except TimeoutError:
                self._json(504, {"error": "embedding timed out"})
                return
            except RuntimeError as e:
                self._json(503, {"error": str(e)})
                return
            n_tok = sum(len(x) for x in ids)
            data = [{"object": "embedding", "index": i,
                     "embedding": [round(float(x), 7) for x in vec]}
                    for i, vec in enumerate(vecs)]
            self._json(200, {"object": "list", "data": data, "model": model_name,
                             "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}})

        def do_GET(self):
            if self.path == "/health":
                snap = loop.snapshot()
                self._json(200, {"ok": True, "active": snap["active"],
                                 "queued": snap["queued"]})
            elif self.path == "/stats":
                self._json(200, loop.snapshot())
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": model_name, "object": "model", "owned_by": "tpu-llm"}]})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/v1/embeddings":
                self._embeddings()
                return
            chat = self.path == "/v1/chat/completions"
            if not chat and self.path not in ("/v1/completions", "/completions"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if chat:
                    prompt = render_chat(body["messages"],
                                         body.get("chat_template", chat_template))
                else:
                    prompt = body["prompt"]
                if not isinstance(prompt, str) or not prompt:
                    raise ValueError("messages must render to a non-empty prompt"
                                     if chat else "prompt must be a non-empty string")
            except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            want_stream = bool(body.get("stream", False))
            n_choices = max(1, min(int(body.get("n", 1)), 8))
            if want_stream and n_choices > 1:
                self._json(400, {"error": "n > 1 with stream=true is not supported"})
                return
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            stop = [s for s in stop if isinstance(s, str) and s][:4]
            lp_field = body.get("logprobs")
            if chat:
                if body.get("top_logprobs") is not None and not lp_field:
                    # OpenAI: chat top_logprobs requires "logprobs": true
                    self._json(400, {"error": "top_logprobs requires logprobs: true"})
                    return
                want_lp = bool(lp_field)
                want_top_n = int(body.get("top_logprobs") or 0)
            elif isinstance(lp_field, bool):
                want_lp, want_top_n = lp_field, 0
            elif lp_field is None:
                want_lp, want_top_n = False, 0
            else:   # an int, 0 included: chosen-token logprobs on
                want_lp, want_top_n = True, int(lp_field)
            if chat:
                prompt_ids = encode_chat(tokenizer, body["messages"],
                                         body.get("chat_template", chat_template))
            else:
                prompt_ids = tokenizer.encode(prompt)
            # end-of-generation markers beyond the model EOS (llama.cpp's
            # EOG set): chat replies stop at whichever the vocabulary has
            eog = [tid for t, tid in getattr(tokenizer, "special", {}).items()
                   if t in (b"<|eot_id|>", b"<|im_end|>", b"<|end|>", b"<end_of_turn>")]
            pairs = []
            for ci in range(n_choices):
                tracker = _Tracker(want_stream)
                req = Request(
                    prompt=prompt_ids,
                    max_new=min(int(body.get("max_tokens", 64)), max_new_cap),
                    temperature=float(body.get("temperature", 0.0)),
                    # each extra choice gets its own sampling stream
                    seed=int(body.get("seed", 0)) + ci,
                    stop_at_eos=bool(body.get("stop_at_eos", chat)),
                    stop_token_ids=(eog or None) if chat else None,
                    top_k=int(body.get("top_k", 0)),
                    top_p=float(body.get("top_p", 1.0)),
                    min_p=float(body.get("min_p", 0.0)),
                    frequency_penalty=float(body.get("frequency_penalty", 0.0)),
                    presence_penalty=float(body.get("presence_penalty", 0.0)),
                    repetition_penalty=float(body.get("repetition_penalty", 1.0)),
                    logit_bias=(body.get("logit_bias")
                                if isinstance(body.get("logit_bias"), dict) else None),
                    logprobs=want_lp,
                    top_logprobs=min(want_top_n, 20),
                    stream=tracker.on_token,
                )
                if stop:
                    tracker.stop = stop

                    def _scan(req=req, stop=stop):
                        text = _decode_toks(tokenizer, req.tokens)
                        best = None
                        for s in stop:
                            i = text.find(s)
                            if i >= 0 and (best is None or i < best):
                                best = i
                        return best

                    tracker._scanner = _scan
                pairs.append((req, tracker))
            for req, tracker in pairs:
                if not loop.enqueue(req, tracker):
                    self._json(503, {"error": "server at capacity"})
                    return
            if want_stream:
                self._stream_response(pairs[0][0], pairs[0][1], chat)
            else:
                self._block_response(pairs, chat, echo=bool(body.get("echo", False)),
                                     prompt_text=prompt)

        def _finish_reason(self, req) -> str:
            if (req.stop_at_eos and req.tokens
                    and req.tokens[-1] == getattr(loop.engine, "eos_id", -1)):
                return "stop"
            return "length"

        def _visible_tokens(self, req) -> list:
            """Generated tokens without a trailing EOS (OpenAI clients expect
            content and completion_tokens without the stop token)."""
            if self._finish_reason(req) == "stop":
                return req.tokens[:-1]
            return req.tokens

        def _n_prompt(self, req) -> int:
            # the BOS the engine prepends at admission counts
            n_bos = 1 if getattr(loop.engine, "bos_id", -1) >= 0 else 0
            return len(req.prompt) + n_bos

        def _decode(self, toks) -> str:
            return _decode_toks(tokenizer, toks)

        def _finish_one(self, req, tracker: _Tracker):
            """Visible tokens, text and finish_reason of one completed
            request, cut at the earliest stop-string match."""
            vis = self._visible_tokens(req)
            text = self._decode(vis)
            finish = self._finish_reason(req)
            if tracker.stop_cut is not None:
                # text at the character offset, tokens at the shortest
                # prefix that covers it
                finish = "stop"
                cut = tracker.stop_cut
                n = 0
                while n < len(vis) and len(self._decode(vis[:n])) < cut:
                    n += 1
                vis = vis[:n]
                text = self._decode(vis)[:cut]
            return vis, text, finish

        def _block_response(self, pairs, chat: bool = False, echo: bool = False,
                            prompt_text: str = "") -> None:
            deadline = time.monotonic() + request_timeout_s
            for req, tracker in pairs:
                left = max(0.0, deadline - time.monotonic())
                if not tracker.done.wait(timeout=left):
                    self._json(504, {"error": "generation timed out"})
                    return
                if tracker.error is not None:
                    self._json(400, {"error": tracker.error})
                    return
            req0, tracker0 = pairs[0]
            ttft = (tracker0.t_first or time.monotonic()) - tracker0.t_enqueue
            choices = []
            total_completion = 0
            vis0 = text0 = None
            for i, (req, tracker) in enumerate(pairs):
                vis, text, finish = self._finish_one(req, tracker)
                if i == 0:
                    vis0, text0 = vis, text
                total_completion += len(vis)
                if echo and not chat:
                    text = prompt_text + text
                if chat:
                    choice = {"index": i, "finish_reason": finish,
                              "message": {"role": "assistant", "content": text}}
                else:
                    choice = {"index": i, "finish_reason": finish, "text": text}
                if req.logprobs or req.top_logprobs > 0:
                    lps = req.token_logprobs[:len(vis)]
                    tops = req.top_ids[:len(vis)]
                    top_lps = req.top_lps[:len(vis)]
                    if chat:
                        content = []
                        for j, t in enumerate(vis):
                            entry = {"token": self._decode([t]),
                                     "logprob": round(lps[j], 6) if j < len(lps) else None}
                            if j < len(tops):
                                entry["top_logprobs"] = [
                                    {"token": self._decode([ti]), "logprob": round(tl, 6)}
                                    for ti, tl in zip(tops[j], top_lps[j])]
                            content.append(entry)
                        choice["logprobs"] = {"content": content}
                    else:
                        lp_obj = {"tokens": [self._decode([t]) for t in vis],
                                  "token_logprobs": [round(x, 6) for x in lps]}
                        if req.top_logprobs > 0:
                            lp_obj["top_logprobs"] = [
                                {self._decode([ti]): round(tl, 6) for ti, tl in zip(ids, ls)}
                                for ids, ls in zip(tops, top_lps)]
                            offs, acc = [], 0
                            for t in vis:
                                offs.append(acc)
                                acc += len(self._decode([t]))
                            lp_obj["text_offset"] = offs
                        choice["logprobs"] = lp_obj
                choices.append(choice)
            self._json(200, {
                # native fields: the first choice
                "completion": text0,
                "tokens": vis0,
                "n_tokens": len(vis0),
                "ttft_s": round(ttft, 4),
                # the OpenAI superset
                "id": f"{'chatcmpl' if chat else 'cmpl'}-{req0.rid}",
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()),
                "model": model_name,
                "choices": choices,
                "usage": {"prompt_tokens": self._n_prompt(req0),
                          "completion_tokens": total_completion,
                          "total_tokens": self._n_prompt(req0) + total_completion},
            })

        def _stream_response(self, req, tracker: _Tracker, chat: bool = False) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # SSE has no length up front: chunked framing keeps HTTP/1.1
            # keep-alive honest
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            deadline = time.monotonic() + request_timeout_s
            sent = 0        # tokens taken from the queue
            epos = 0        # characters of decoded text already sent
            first = True
            stop_hit = False
            eos_id = getattr(loop.engine, "eos_id", -1)
            stops = tracker.stop

            def emit(tok, delta):
                nonlocal first
                if chat:
                    # OpenAI SDKs expect the role in the first chat delta
                    d = ({"role": "assistant", "content": delta} if first
                         else {"content": delta})
                    choice = {"index": 0, "finish_reason": None, "delta": d}
                else:
                    choice = {"index": 0, "finish_reason": None, "text": delta}
                if ((req.logprobs or req.top_logprobs > 0) and tok is not None
                        and sent <= len(req.token_logprobs)):
                    # the logprob of the token that produced this delta (and
                    # its alternatives when asked)
                    j = sent - 1
                    lp = round(req.token_logprobs[j], 6)
                    tok_s = self._decode([tok])
                    if chat:
                        entry = {"token": tok_s, "logprob": lp}
                        if j < len(req.top_ids):
                            entry["top_logprobs"] = [
                                {"token": self._decode([ti]), "logprob": round(tl, 6)}
                                for ti, tl in zip(req.top_ids[j], req.top_lps[j])]
                        choice["logprobs"] = {"content": [entry]}
                    else:
                        lp_obj = {"tokens": [tok_s], "token_logprobs": [lp]}
                        if j < len(req.top_ids):
                            lp_obj["top_logprobs"] = [
                                {self._decode([ti]): round(tl, 6)
                                 for ti, tl in zip(req.top_ids[j], req.top_lps[j])}]
                        choice["logprobs"] = lp_obj
                first = False
                ev = {"token": tok, "text": delta,
                      "id": f"{'chatcmpl' if chat else 'cmpl'}-{req.rid}",
                      "model": model_name,
                      "object": "chat.completion.chunk" if chat else "text_completion",
                      "choices": [choice]}
                chunk(b"data: " + json.dumps(ev).encode() + b"\n\n")

            try:
                while True:
                    try:
                        tok = tracker.events.get(timeout=1.0)
                    except queue.Empty:
                        if time.monotonic() > deadline:
                            break
                        continue
                    if tok is None:
                        break
                    sent += 1
                    if req.stop_at_eos and tok == eos_id:
                        continue  # the stop token is not content
                    # decode against the whole prefix, so multi-token UTF-8
                    # and whitespace merges stay byte-exact
                    full = self._decode(req.tokens[:sent])
                    cut = None
                    for s in stops:
                        i = full.find(s)
                        if i >= 0 and (cut is None or i < cut):
                            cut = i
                    if cut is not None:
                        stop_hit = True
                        if cut > epos:
                            emit(tok, full[epos:cut])
                            epos = cut
                        break
                    # hold back a suffix that could grow into a stop match
                    # with the next token
                    hold = 0
                    for s in stops:
                        m = min(len(s) - 1, len(full))
                        for k in range(m, 0, -1):
                            if full.endswith(s[:k]):
                                hold = max(hold, k)
                                break
                    new_end = max(epos, len(full) - hold)
                    delta = full[epos:new_end]
                    if delta or first:
                        emit(tok, delta)
                        epos = new_end
                if not stop_hit and tracker.stop_cut is None:
                    # flush what the holdback kept (no match completed)
                    full = self._decode(self._visible_tokens(req))
                    if len(full) > epos:
                        emit(None, full[epos:])
                n_vis = len(self._visible_tokens(req))
                finish = self._finish_reason(req)
                if stop_hit or tracker.stop_cut is not None:
                    finish = "stop"
                    n_vis = min(n_vis, sent)
                fin = {"done": True, "n_tokens": n_vis,
                       "choices": [{"index": 0, "finish_reason": finish,
                                    **({"delta": {}} if chat else {"text": ""})}]}
                if tracker.error is not None:
                    fin["error"] = tracker.error
                chunk(b"data: " + json.dumps(fin).encode() + b"\n\n")
                chunk(b"data: [DONE]\n\n")   # OpenAI's stream sentinel
                chunk(b"")                   # terminal chunk
            except (BrokenPipeError, ConnectionResetError):
                pass                         # the client went away mid-stream

    loop_verbose = False
    return Handler


def build_parser() -> argparse.ArgumentParser:
    from tpu_llm_torch.runtime.serve_cli import build_parser as offline_parser

    p = argparse.ArgumentParser(prog="llm-server", description=__doc__,
                                parents=[offline_parser()], add_help=False,
                                conflict_handler="resolve", allow_abbrev=False)
    p.add_argument("-h", "--help", action="help")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-queue", type=int, default=256,
                   help="503 beyond this many waiting requests")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-request generation timeout (s)")
    p.add_argument("--chat-template", default="zephyr",
                   choices=["zephyr", "plain", "llama2", "llama3", "chatml", "gemma"],
                   help="messages rendering for /v1/chat/completions")
    p.add_argument("--served-model-name", default=None,
                   help="model id reported by /v1/models and responses "
                        "(default: the model file's basename)")
    return p


def serve(engine, tokenizer, host: str, port: int, *, max_queue: int = 256,
          max_new_cap: int = 4096, timeout_s: float = 600.0, model_name: str = "tpu-llm",
          chat_template: str = "zephyr", embedder: Optional[Embedder] = None, mesh=None):
    """Start the loop thread and make the HTTP server: (server, loop); the
    caller runs server.serve_forever(). On a mesh the other ranks run
    ``follow``."""
    loop = ServingLoop(engine, max_queue=max_queue, mesh=mesh)
    loop.start()
    handler = make_handler(loop, tokenizer, max_new_cap, timeout_s, model_name=model_name,
                           chat_template=chat_template, embedder=embedder)
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd, loop


def main(argv=None) -> int:
    import os

    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.config import MambaConfig
    from tpu_llm_torch.runtime.serve_cli import _load, make_engine, spawn_or_mesh

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    rc, mesh = spawn_or_mesh(main, argv, args)
    if rc is not None:
        return rc
    lead = mesh is None or mesh.index == 0
    device = mesh.device if mesh is not None else torch.device(args.device)
    try:
        params, cfg, tokenizer = _load(args, device if mesh is None else "cpu")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    ctx_cap = getattr(cfg, "seq_len", 4096)     # Mamba: O(1) state, no cap
    max_seq = args.max_seq or min(ctx_cap, 1024)
    if args.paged and max_seq > 256 and max_seq % 256:
        max_seq = min(-(-max_seq // 256) * 256, ctx_cap)
    try:
        engine = make_engine(args, params, cfg, tokenizer, max_seq, device, mesh)
    except SystemExit as e:
        if lead:
            print(e, file=sys.stderr)
        return 1
    if mesh is not None:
        from tpu_llm_torch.parallel.serving import make_tp_llama_adapter

        adapter = make_tp_llama_adapter(cfg, mesh)
    elif isinstance(cfg, MambaConfig):
        adapter = ModelAdapter.mamba(cfg, device)
    else:
        adapter = ModelAdapter.llama(cfg, device=device)
    del params
    embedder = Embedder(engine.params, adapter, max_len=min(max_seq, 512))
    if not lead:
        follow(engine, mesh, embedder)
        return 0
    model_name = args.served_model_name or os.path.basename(args.model)
    httpd, loop = serve(engine, tokenizer, args.host, args.port, max_queue=args.max_queue,
                        max_new_cap=max(1, max_seq - 2), timeout_s=args.timeout,
                        model_name=model_name, chat_template=args.chat_template,
                        embedder=embedder, mesh=mesh)
    print(f"llm-server listening on http://{args.host}:{httpd.server_address[1]} "
          f"(engine={type(engine).__name__}, slots={args.batch}, max_seq={max_seq}, "
          f"device={device}"
          + (f", {mesh.describe()}" if mesh is not None else "") + ")",
          file=sys.stderr, flush=True)

    def watch():                 # a loop that stops (a failed mesh step) ends the server
        loop.join()
        httpd.shutdown()

    threading.Thread(target=watch, daemon=True).start()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        loop.shutdown()
    return 1 if loop.failed is not None else 0


if __name__ == "__main__":
    sys.exit(main())
