"""Batched serving over the one-token decode step: the counterpart of
``repro/serve/engine.py``.

Static batching: requests go in fixed-size batches, one ``decode_step`` per
token across the whole batch. Prompts are left-aligned and stepped through
the cache (prefill-by-decode: a short prompt repeats its last token, and the
extra steps are overwritten by the first sampled token); rows that emitted
``eos_id`` stop. It serves the LM family: ``lm`` archs and Qwen2-VL
(``vlm``) on text, whose decode positions are (t, t, t); a Whisper spec is
refused, as ``repro``'s server refuses it. No kernel runs on this path: the decode step's attention
is one query against the cache, the einsum path, as in ``repro``.

Greedy decoding (``temperature <= 0``) is the conformance mode: the argmax
of the logits, lower id first on ties, as ``jnp.argmax``. Temperature
sampling draws with ``torch.multinomial`` from a generator seeded with
``cfg.seed`` afresh for each batch, on the logits' device; it cannot
reproduce ``jax.random.categorical``'s draws, so sampled outputs differ from
``repro``'s bit for bit while following the same distribution.

Telemetry (optional, ``telemetry=None`` disables it at one ``is None`` test
a site), as ``repro``'s server: each fixed-size batch is a ``serve.batch``
span, ``serve.queue_depth`` gauges the requests still waiting when a batch
launches, ``serve.request_ns`` observes each request's batch wall time and
``serve.requests`` counts them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models import transformer as T
from repro_torch.obs.trace import span_scope


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 4
    max_new_tokens: int = 32
    cache_len: int = 256
    temperature: float = 0.0  # 0 -> greedy
    eos_id: Optional[int] = None
    seed: int = 0


class BatchedServer:
    def __init__(self, spec: ArchSpec, params: T.LM, cfg: ServeConfig, telemetry=None):
        if spec.kind not in ("lm", "vlm"):
            raise ValueError("LM-family archs only")
        self.spec = spec
        self.lm = spec.lm
        self.params = params
        self.cfg = cfg
        self.device = params.embed.device
        if self.lm.sliding_window:
            self.cache_len = min(cfg.cache_len, self.lm.sliding_window)
        else:
            self.cache_len = cfg.cache_len
        self._tracer = telemetry.tracer if telemetry is not None else None
        if telemetry is not None:
            m = telemetry.metrics
            self._m_queue = m.gauge("serve.queue_depth")
            self._m_request_ns = m.histogram("serve.request_ns")
            self._m_requests = m.counter("serve.requests")
        else:
            self._m_queue = self._m_request_ns = self._m_requests = None

    def _step(self, cache, tok: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tok, np.int64)).to(self.device)
        return T.decode_step(self.params, self.lm, cache, t)

    def _sample(self, logits: torch.Tensor, gen: Optional[torch.Generator]) -> np.ndarray:
        if self.cfg.temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        return nxt.to(torch.int32).cpu().numpy()

    def _run_batch(self, prompts: List[List[int]]) -> List[List[int]]:
        B = self.cfg.batch_size
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts for a batch of {B}")
        pad = B - len(prompts)
        prompts = prompts + [[0]] * pad
        max_p = max(len(p) for p in prompts)
        cache = T.init_cache(self.lm, B, self.cache_len, self.device)
        gen = None
        if self.cfg.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(int(self.cfg.seed))

        logits = None
        for i in range(max_p):
            tok = np.array([p[min(i, len(p) - 1)] for p in prompts], dtype=np.int64)[:, None]
            logits, cache = self._step(cache, tok)

        outs: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        for _ in range(self.cfg.max_new_tokens):
            nxt = self._sample(logits, gen)
            for b in range(B):
                if not done[b]:
                    outs[b].append(int(nxt[b]))
                    if self.cfg.eos_id is not None and nxt[b] == self.cfg.eos_id:
                        done[b] = True
            if done.all():
                break
            logits, cache = self._step(cache, nxt[:, None])
        return outs[: len(outs) - pad if pad else None]

    def generate(self, prompts: Sequence[Sequence[int]]) -> List[List[int]]:
        """Serve any number of requests in fixed-size batches."""
        prompts = [list(p) for p in prompts]
        out: List[List[int]] = []
        B = self.cfg.batch_size
        for lo in range(0, len(prompts), B):
            chunk = prompts[lo:lo + B]
            if self._m_queue is not None:
                # requests still waiting behind this batch: the high-water
                # mark is the burst depth the server absorbed
                self._m_queue.set(len(prompts) - lo)
            t0 = time.perf_counter_ns()
            with span_scope(self._tracer, "serve.batch", cat="serve",
                            requests=len(chunk), queued=len(prompts) - lo):
                out.extend(self._run_batch(chunk))
            if self._m_request_ns is not None:
                # a caller's latency is its batch's wall time
                dur = time.perf_counter_ns() - t0
                for _ in chunk:
                    self._m_request_ns.observe(dur)
                self._m_requests.inc(len(chunk))
            if self._m_queue is not None:
                self._m_queue.set(len(prompts) - lo - len(chunk))
        return out
