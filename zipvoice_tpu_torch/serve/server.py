"""Dynamic-batching HTTP TTS server over the port's pipeline.

* **Dynamic batching.** Requests queue on the host; one dispatcher thread
  drains up to ``max_batch`` requests (waiting at most ``max_wait_ms``
  after the first arrival) and runs them through the pipeline's batched
  sampler (``synthesize_batch``), padded to ``max_batch`` rows so that one
  warmed graph serves every group size.  A drain of one request takes the
  one sample + vocoder + PCM16 program (``synthesize_fused``).
* **Shape bucketing.** The pipeline pads tokens and frames to buckets, so a
  handful of captured graphs serves every request size; ``warmup()``
  captures the configured buckets before the listener opens.
* **Stdlib only.** ``ThreadingHTTPServer`` + ``json``/``base64``.

Endpoints:

* ``POST /synthesize`` — JSON body::

      {"text": "...", "prompt_text": "...",
       "prompt_wav_b64": "<base64 of a WAV file>",
       "num_step": 16, "guidance_scale": 1.0, "speed": 1.0, "seed": 666}

  → ``audio/wav`` bytes (or JSON ``{"wav_b64": ...}`` with
  ``Accept: application/json``); ``"long_form": true`` takes the chunked
  path.
* ``POST /synthesize_stream`` — the same body; a chunked-transfer WAV whose
  segments flow as each long-form chunk finishes.
* ``GET /healthz`` — liveness + device string.
* ``GET /stats`` — request/batch counters and latency aggregates.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np


@dataclass
class _Request:
    text: str
    prompt_text: str
    prompt_wav: np.ndarray
    prompt_sr: int
    num_step: int
    guidance_scale: float
    speed: float
    t_shift: float
    seed: int
    long_form: bool = False  # chunked synthesis beyond the ~30 s cap
    precomputed: Optional[Dict] = None  # tokens/prompt feats (HTTP thread)
    done: threading.Event = field(default_factory=threading.Event)
    wav: Optional[np.ndarray] = None
    error: Optional[str] = None
    t_enqueue: float = 0.0
    t_finish: float = 0.0


class DynamicBatcher:
    """Collects concurrent requests into one batched sampler call."""

    def __init__(self, pipeline, max_batch: int = 8, max_wait_ms: float = 30.0,
                 default_num_step: int = 16, default_guidance: float = 1.0):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.default_num_step = default_num_step
        self.default_guidance = default_guidance
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self.stats: Dict[str, float] = {
            "requests": 0, "batches": 0, "errors": 0,
            "audio_seconds": 0.0, "busy_seconds": 0.0,
        }
        self._latencies: List[float] = []  # last 1000 request latencies
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tts-dispatcher")
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, req: _Request, timeout: float = 300.0) -> _Request:
        req.t_enqueue = time.monotonic()
        self.q.put(req)
        if not req.done.wait(timeout):
            req.error = req.error or "timeout"
            # mark abandoned so the dispatcher's shed filter drops it
            # instead of synthesizing for a client that already got a 500
            req.done.set()
        return req

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- dispatcher ---------------------------------------------------------
    def _drain(self) -> List[_Request]:
        try:
            first = self.q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            # shed requests whose client already gave up (submit() timeout
            # set done + error) — don't spend device time on dead work
            batch = [r for r in batch if not r.done.is_set()]
            if not batch:
                continue
            t0 = time.monotonic()
            self._run(batch)
            dt = time.monotonic() - t0
            with self._stats_lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["busy_seconds"] += dt
                for r in batch:
                    if r.error:
                        self.stats["errors"] += 1
                    elif r.wav is not None:
                        self.stats["audio_seconds"] += (
                            len(r.wav) / self.pipeline.feat_cfg.sampling_rate
                        )
            now = time.monotonic()
            with self._stats_lock:
                self._latencies.extend(now - r.t_enqueue for r in batch)
                del self._latencies[:-1000]
            for r in batch:
                r.t_finish = now
                r.done.set()

    def _run(self, batch: List[_Request]):
        # sampling hyperparams must agree within one captured program; split
        # the drain by (num_step, guidance, speed, t_shift) key.  Failures
        # are isolated per group: a crashing group 500s only its own
        # requests, completed groups still return audio.
        by_key: Dict[tuple, List[_Request]] = {}
        for r in batch:
            by_key.setdefault(
                (r.num_step, r.guidance_scale, r.speed, r.t_shift,
                 r.long_form), []
            ).append(r)
        for (num_step, gs, speed, t_shift, long_form), group in by_key.items():
            try:
                if long_form:
                    for r in group:  # chunked path; not batchable
                        res = self.pipeline.synthesize_long(
                            text=r.text, prompt_text=r.prompt_text,
                            prompt_wav=r.prompt_wav, prompt_sr=r.prompt_sr,
                            num_step=num_step, guidance_scale=gs,
                            speed=speed, t_shift=t_shift, seed=r.seed,
                        )
                        r.wav = res.wav
                    continue
                self._run_group(group, num_step, gs, speed, t_shift)
            except Exception as ex:  # noqa: BLE001 — server must stay up
                logging.exception("group failed")
                for r in group:
                    r.error = r.error or repr(ex)

    def _run_group(self, group, num_step, gs, speed, t_shift):
        if len(group) == 1:
            r = group[0]
            res = self.pipeline.synthesize_fused(
                text=r.text, prompt_text=r.prompt_text,
                prompt_wav=r.prompt_wav, prompt_sr=r.prompt_sr,
                num_step=num_step, guidance_scale=gs, speed=speed,
                t_shift=t_shift, seed=r.seed, precomputed=r.precomputed,
            )
            r.wav = res.wav
            return
        # pad the group to the warmed batch size by repeating the last
        # request: group sizes 2..max_batch-1 would otherwise each capture
        # a graph of their own at request time
        padded = group + [group[-1]] * (self.max_batch - len(group))
        results = self.pipeline.synthesize_batch(
            texts=[r.text for r in padded],
            prompt_texts=[r.prompt_text for r in padded],
            prompt_wavs=[r.prompt_wav for r in padded],
            prompt_srs=[r.prompt_sr for r in padded],
            num_step=num_step, guidance_scale=gs, speed=speed,
            t_shift=t_shift,
            seeds=[r.seed for r in padded],
            precomputed=(
                [r.precomputed for r in padded]
                if all(r.precomputed is not None for r in padded) else None
            ),
        )
        for r, res in zip(group, results):
            r.wav = res.wav


class TTSServer:
    """HTTP front over a DynamicBatcher."""

    def __init__(self, pipeline, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: int = 8, max_wait_ms: float = 30.0,
                 num_step: int = 16, guidance_scale: float = 1.0,
                 allow_custom_sampling: bool = False,
                 max_streams: int = 2):
        self.batcher = DynamicBatcher(
            pipeline, max_batch=max_batch, max_wait_ms=max_wait_ms,
            default_num_step=num_step, default_guidance=guidance_scale,
        )
        self.pipeline = pipeline
        self.strict_sampling = not allow_custom_sampling
        # streaming requests dispatch device programs from their handler
        # threads (outside the batcher): cap their concurrency so N clients
        # can't flood the device queue, and count them for /stats
        self._stream_sem = threading.BoundedSemaphore(max_streams)
        self._stream_lock = threading.Lock()
        self.stream_stats = {"streams": 0, "stream_audio_seconds": 0.0,
                             "streams_active": 0, "streams_rejected": 0,
                             "stream_errors": 0}
        handler = self._make_handler()
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_port  # resolved when port=0

    def serve_forever(self):
        logging.info("serving on :%d", self.port)
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.shutdown()

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                logging.debug("http: " + fmt, *args)

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok",
                                     "device": str(server.pipeline.device)})
                elif self.path == "/stats":
                    b = server.batcher
                    with b._stats_lock:
                        st = dict(b.stats)
                        lats = sorted(b._latencies)
                    busy = st.get("busy_seconds") or 0.0
                    if busy > 0:
                        st["aggregate_rtf"] = round(
                            busy / max(st["audio_seconds"], 1e-9), 5
                        )
                    if lats:
                        st["latency_p50"] = round(lats[len(lats) // 2], 4)
                        st["latency_p95"] = round(
                            lats[min(len(lats) - 1,
                                     int(len(lats) * 0.95))], 4
                        )
                    with server._stream_lock:
                        st.update(server.stream_stats)
                    self._json(200, st)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/synthesize_stream":
                    self._stream()
                    return
                if self.path != "/synthesize":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n))
                    req = server._parse_request(payload)
                except Exception as ex:  # noqa: BLE001
                    self._json(400, {"error": f"bad request: {ex!r}"})
                    return
                server.batcher.submit(req)
                if req.error:
                    self._json(500, {"error": req.error})
                    return
                from zipvoice_tpu_torch.audio.wav import wav_bytes

                data = wav_bytes(req.wav,
                                 server.pipeline.feat_cfg.sampling_rate)
                if "application/json" in (self.headers.get("Accept") or ""):
                    self._json(200, {
                        "wav_b64": base64.b64encode(data).decode(),
                        "seconds": len(req.wav) /
                        server.pipeline.feat_cfg.sampling_rate,
                        "latency": req.t_finish - req.t_enqueue,
                    })
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _stream(self):
                """Chunked-transfer streaming WAV: audio starts flowing
                after the FIRST long-form chunk instead of the whole text.
                Device programs run from this handler thread and interleave
                with batched traffic (the pipeline's graph lock serializes
                each replay with its copies in and out); concurrency is
                capped by server._stream_sem and counted in /stats."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n))
                    payload["long_form"] = True  # streaming IS chunked
                    req = server._parse_request(payload)
                except Exception as ex:  # noqa: BLE001
                    self._json(400, {"error": f"bad request: {ex!r}"})
                    return
                if not server._stream_sem.acquire(blocking=False):
                    with server._stream_lock:
                        server.stream_stats["streams_rejected"] += 1
                    self._json(503, {"error": "stream slots exhausted"})
                    return
                try:
                    self._stream_body(req)
                finally:
                    server._stream_sem.release()

            def _stream_body(self, req):
                from zipvoice_tpu_torch.audio.wav import (
                    pcm16_bytes,
                    wav_stream_header,
                )

                sr = server.pipeline.feat_cfg.sampling_rate
                with server._stream_lock:
                    server.stream_stats["streams"] += 1
                    server.stream_stats["streams_active"] += 1
                # header writes live INSIDE the try/finally below: a client
                # that disconnects immediately raises here, and the active
                # counter must still be decremented

                def emit(data: bytes):
                    if not data:
                        # '0\r\n\r\n' is the end-of-stream terminator —
                        # an empty segment must not end the stream early
                        return
                    self.wfile.write(b"%x\r\n" % len(data))
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")

                samples = 0
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    emit(wav_stream_header(sr))
                    for seg in server.pipeline.synthesize_stream(
                        text=req.text, prompt_text=req.prompt_text,
                        prompt_wav=req.prompt_wav, prompt_sr=req.prompt_sr,
                        num_step=req.num_step,
                        guidance_scale=req.guidance_scale,
                        speed=req.speed, t_shift=req.t_shift, seed=req.seed,
                    ):
                        samples += int(np.asarray(seg).shape[-1])
                        emit(pcm16_bytes(seg))
                    self.wfile.write(b"0\r\n\r\n")
                except BrokenPipeError:
                    logging.info("stream client disconnected")
                    self.close_connection = True
                except Exception:  # noqa: BLE001
                    # mid-stream failure: ABORT the connection (no clean
                    # terminator) so clients see a truncated stream instead
                    # of mistaking partial audio for a complete response,
                    # and the (possibly corrupt) chunk framing never
                    # poisons a keep-alive connection
                    logging.exception("stream failed mid-flight")
                    self.close_connection = True
                    with server._stream_lock:
                        server.stream_stats["stream_errors"] += 1
                finally:
                    with server._stream_lock:
                        server.stream_stats["streams_active"] -= 1
                        server.stream_stats["stream_audio_seconds"] = round(
                            server.stream_stats["stream_audio_seconds"]
                            + samples / sr, 3
                        )

        return Handler

    def _parse_request(self, payload: Dict) -> _Request:
        from zipvoice_tpu_torch.audio.wav import read_wav_bytes

        wav_b = base64.b64decode(payload["prompt_wav_b64"])
        prompt_wav, prompt_sr = read_wav_bytes(wav_b)
        b = self.batcher
        num_step = int(payload.get("num_step", b.default_num_step))
        gs = float(payload.get("guidance_scale", b.default_guidance))
        t_shift = float(payload.get("t_shift", 0.5))
        if self.strict_sampling and (
            num_step != b.default_num_step or gs != b.default_guidance
            or t_shift != 0.5
        ):
            # every distinct (num_step, gs, t_shift) tuple is a separate
            # set of captured graphs — reject rather than let clients drive
            # captures (start with allow_custom_sampling=True to opt out)
            raise ValueError(
                "custom sampling params disabled on this server "
                f"(pinned: num_step={b.default_num_step}, "
                f"guidance_scale={b.default_guidance}, t_shift=0.5)"
            )
        if not 1 <= num_step <= 64:
            raise ValueError(f"num_step out of range: {num_step}")
        if not 0.0 <= gs <= 10.0:
            raise ValueError(f"guidance_scale out of range: {gs}")
        if not 0.0 < t_shift <= 1.0:
            raise ValueError(f"t_shift out of range: {t_shift}")
        speed = float(payload.get("speed", 1.0))
        if not 0.25 <= speed <= 4.0:
            raise ValueError(f"speed out of range: {speed}")
        req = _Request(
            text=str(payload["text"]),
            prompt_text=str(payload["prompt_text"]),
            prompt_wav=prompt_wav,
            prompt_sr=prompt_sr,
            num_step=num_step,
            guidance_scale=gs,
            speed=speed,
            t_shift=t_shift,
            seed=int(payload.get("seed", 666)) & 0xFFFFFFFF,
            long_form=bool(payload.get("long_form", False)),
        )
        # tokenize + prompt fbank HERE (per-request HTTP thread) so the
        # single dispatcher thread only launches device programs
        # (long-form chunks re-derive tokens per chunk inside the pipeline)
        if self.pipeline.tokenizer is not None and not req.long_form:
            tok = self.pipeline.tokenizer
            pf, prompt_rms = self.pipeline.prompt_features(
                req.prompt_wav, req.prompt_sr
            )
            req.precomputed = {
                "tokens": tok.texts_to_token_ids([req.text])[0],
                "prompt_tokens": tok.texts_to_token_ids([req.prompt_text])[0],
                "prompt_feats": pf,
                "prompt_rms": prompt_rms,
            }
        return req
