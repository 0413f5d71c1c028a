"""Run-health guardrails: flight recorder, stall watchdog, loss anomaly gate.

A copy of ``repro.obs.health`` (stdlib only), so the port imports nothing
of ``repro``. The trainer passes its mp engine's ``GraphClient`` (None
in-process), whose heartbeats the watchdog folds in.

Traces answer *where the time went* after the fact; this module
answers *is the run still healthy right now*, and leaves a usable
post-mortem behind when it is not. One :class:`HealthMonitor` — owned by
the trainer via ``TrainerConfig.health`` — watches three failure families:

- **Stalls.** The step loop beats the monitor once per completed step (and
  the ``PhaseTimer`` pulses it at every phase boundary, so "steps stopped
  but phases still move" is distinguishable from "everything froze"). A
  named watchdog thread checks the beat age every ``poll_interval_s``;
  past ``stall_timeout_s`` it dumps a **flight record** — a Perfetto trace
  snapshot, an all-thread stack dump (``faulthandler``), and the run's
  health/metrics/worker state as JSON — into ``flightrec_dir``, then
  records a :class:`RunStalledError` that the step loop (and the
  prefetcher's poll loop, so a consumer blocked on a wedged producer still
  aborts) raises on its next check. Even when the process is hard-stuck
  and must be killed externally, the dump is already on disk — that is the
  flight recorder's whole point.
- **Loss anomalies.** ``observe_losses`` rides the trainer's *async* loss
  drain — values that were coming to the host anyway, so no extra device
  sync. NaN/Inf fails immediately; divergence is a windowed EWMA z-score
  (``|x - ewma| > zmax * sigma`` after ``divergence_window`` healthy
  observations). Both dump a flight record and raise
  :class:`LossAnomalyError` from the training thread.
- **Worker liveness.** When the trainer runs the mp graph engine, the
  watchdog folds in ``GraphClient.heartbeat()`` rounds (the existing
  ``stats`` control op — no new IPC). A worker silent for
  ``worker_silent_rounds`` consecutive heartbeats marks the run *degraded*
  (counter + trace mark, run continues) before the client's own
  ``EngineWorkerError`` path hard-fails it.

Monitoring never touches the training stream: a beat is two attribute
stores, loss checks see only already-drained host floats, and heartbeats
ride a control channel — so a monitored run's losses are bitwise identical
to an unmonitored one (``tests/test_health.py`` pins this for ``repro``,
``tests/test_torch_obs.py`` for the port).

Timing hygiene (lint rule O001): deadlines use ``time.monotonic``,
timestamps ``time.perf_counter_ns`` — never wall clock.
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger("repro_torch.obs.health")


class RunStalledError(RuntimeError):
    """No training step completed within the stall timeout.

    ``flightrec`` carries the dump directory path (None if the dump
    itself failed)."""

    def __init__(self, message: str, flightrec: Optional[str] = None):
        super().__init__(message)
        self.flightrec = flightrec


class LossAnomalyError(RuntimeError):
    """The loss stream went NaN/Inf or diverged beyond the z-score band."""

    def __init__(self, message: str, flightrec: Optional[str] = None):
        super().__init__(message)
        self.flightrec = flightrec


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the run-health monitor (``TrainerConfig.health``)."""

    # No completed step (or phase pulse) for this long -> flight-record
    # dump + RunStalledError. Size it well above the slowest expected step
    # INCLUDING warm-up: the first step of a run builds the kernels.
    stall_timeout_s: float = 120.0
    # Watchdog wake interval. Stall detection latency is timeout + poll.
    poll_interval_s: float = 1.0
    # Loss checks (cost: a float compare per drained loss).
    nan_check: bool = True
    # Healthy observations required before z-scoring starts, and the
    # rejection band width. 0 window disables divergence detection
    # (NaN/Inf stays on).
    divergence_window: int = 32
    divergence_zmax: float = 8.0
    # EWMA smoothing for the divergence mean/variance estimates.
    ewma_alpha: float = 0.05
    # Worker-liveness heartbeat cadence for the mp engine (0 disables).
    # Each round is one bounded `stats` control op per worker.
    worker_heartbeat_s: float = 10.0
    worker_heartbeat_timeout_s: float = 5.0
    # Consecutive silent heartbeats before the run is marked degraded.
    worker_silent_rounds: int = 3
    # Flight-record dumps land in <flightrec_dir>/<pid>-<seq>-<reason>/.
    flightrec_dir: str = "flightrec"
    # Drained-loss tail retained for the flight record.
    loss_tail: int = 64


class HealthMonitor:
    """Flight recorder + watchdog over one training run.

    Lifecycle: construct, ``start()`` right before the step loop,
    ``beat(step)`` per completed step, ``observe_losses`` on every drained
    window, ``stop()`` in the run's ``finally``. ``check()`` is the cheap
    fault gate (one attribute load when healthy) for poll loops.
    """

    def __init__(
        self,
        config: HealthConfig = HealthConfig(),
        telemetry=None,
        client=None,
    ):
        self.cfg = config
        self._telemetry = telemetry
        self._client = client  # GraphClient (mp engine) or None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Single-writer fields read cross-thread without a lock: Python
        # attribute stores are atomic, and the watchdog only compares ages.
        self._last_beat: float = 0.0
        self._last_pulse: float = 0.0
        self._last_step: int = -1
        self.fault: Optional[BaseException] = None
        self.degraded: bool = False
        # EWMA divergence state (training-thread only)
        self._ewma: float = 0.0
        self._ewma_var: float = 0.0
        self._n_obs: int = 0
        self._loss_tail: List[float] = []
        # dump bookkeeping (any thread)
        self._dump_lock = threading.Lock()
        self._dump_seq = 0
        self._silent: Dict[int, int] = {}  # worker -> consecutive misses
        if telemetry is not None:
            m = telemetry.metrics
            self._c_stall = m.counter("health.stalls")
            self._c_anomaly = m.counter("health.loss_anomalies")
            self._c_silent = m.counter("health.worker_silent")
            self._g_degraded = m.gauge("health.degraded")
        else:
            self._c_stall = self._c_anomaly = self._c_silent = None
            self._g_degraded = None

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Arm the watchdog (idempotent). Beats/pulses start counting now."""
        if self._thread is not None:
            return
        now = time.monotonic()
        self._last_beat = now
        self._last_pulse = now
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch, name="repro-torch-health-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Retire the watchdog. Idempotent; the pending fault (if any)
        survives for a final ``check()``."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
            if thread.is_alive():
                log.warning(
                    "health watchdog still running after stop(); it is a "
                    "daemon and will exit with the process"
                )

    # ------------------------------------------------------------ hot hooks
    def beat(self, step: int) -> None:
        """One completed training step. Raises the pending fault, if any."""
        self._last_step = step
        self._last_beat = time.monotonic()
        if self.fault is not None:
            raise self.fault

    def pulse(self) -> None:
        """Sub-step liveness bump (phase boundaries): steps may be slow,
        but the pipeline is provably still moving."""
        self._last_pulse = time.monotonic()

    def check(self) -> None:
        """Raise the pending fault, if any (for poll loops that may never
        reach the next ``beat``)."""
        if self.fault is not None:
            raise self.fault

    def observe_losses(self, values) -> None:
        """Feed drained host losses (called from the training thread on
        the async drain — values were coming to the host anyway)."""
        cfg = self.cfg
        for v in values:
            v = float(v)
            self._loss_tail.append(v)
            if not math.isfinite(v):
                if not cfg.nan_check:
                    continue
                self._anomaly(
                    f"non-finite loss {v!r} at step <= {self._last_step}"
                )
            if cfg.divergence_window > 0:
                self._observe_one(v)
        del self._loss_tail[: -cfg.loss_tail]

    def _observe_one(self, v: float) -> None:
        cfg = self.cfg
        if self._n_obs >= cfg.divergence_window:
            sigma = math.sqrt(max(self._ewma_var, 1e-12))
            z = abs(v - self._ewma) / sigma
            if z > cfg.divergence_zmax:
                self._anomaly(
                    f"loss diverged: {v:.6g} is {z:.1f} sigma from the "
                    f"EWMA {self._ewma:.6g} (sigma {sigma:.3g}, "
                    f"zmax {cfg.divergence_zmax}) at step <= {self._last_step}"
                )
        a = cfg.ewma_alpha
        if self._n_obs == 0:
            self._ewma = v
        else:
            delta = v - self._ewma
            self._ewma += a * delta
            self._ewma_var = (1.0 - a) * (self._ewma_var + a * delta * delta)
        self._n_obs += 1

    def _anomaly(self, message: str) -> None:
        if self._c_anomaly is not None:
            self._c_anomaly.inc()
        path = self.dump("loss-anomaly", context={"message": message})
        err = LossAnomalyError(
            f"{message} (flight record: {path})", flightrec=path
        )
        self.fault = err
        raise err

    # -------------------------------------------------------------- watchdog
    def _watch(self) -> None:
        cfg = self.cfg
        next_hb = time.monotonic() + cfg.worker_heartbeat_s
        while not self._stop.wait(cfg.poll_interval_s):
            now = time.monotonic()
            alive_age = now - max(self._last_beat, self._last_pulse)
            if self.fault is None and alive_age > cfg.stall_timeout_s:
                self._on_stall(alive_age)
                return  # one dump per run; the fault is armed
            if (
                self._client is not None
                and cfg.worker_heartbeat_s > 0
                and now >= next_hb
            ):
                self._heartbeat_round()
                next_hb = time.monotonic() + cfg.worker_heartbeat_s

    def _on_stall(self, age_s: float) -> None:
        if self._c_stall is not None:
            self._c_stall.inc()
        beat_age = time.monotonic() - self._last_beat
        path = self.dump(
            "stall",
            context={
                "beat_age_s": round(beat_age, 3),
                "alive_age_s": round(age_s, 3),
            },
        )
        self.fault = RunStalledError(
            f"no training step for {beat_age:.1f}s (no activity for "
            f"{age_s:.1f}s, stall_timeout_s={self.cfg.stall_timeout_s}); "
            f"flight record: {path}",
            flightrec=path,
        )
        log.error("%s", self.fault)

    def _heartbeat_round(self) -> None:
        try:
            alive = self._client.heartbeat(
                timeout=self.cfg.worker_heartbeat_timeout_s
            )
        except Exception as e:  # client racing shutdown: not a health event
            log.debug("worker heartbeat skipped: %s", e)
            return
        for w, ok in alive.items():
            if ok:
                self._silent[w] = 0
                continue
            self._silent[w] = self._silent.get(w, 0) + 1
            if self._silent[w] == self.cfg.worker_silent_rounds:
                self._mark_degraded(
                    f"graph worker {w} silent for {self._silent[w]} "
                    "heartbeat rounds"
                )

    def _mark_degraded(self, why: str) -> None:
        self.degraded = True
        if self._c_silent is not None:
            self._c_silent.inc()
        if self._g_degraded is not None:
            self._g_degraded.set(1)
        if self._telemetry is not None:
            self._telemetry.tracer.mark("health.degraded", reason=why)
        log.warning("run degraded: %s", why)

    # --------------------------------------------------------- flight record
    def dump(self, reason: str, context: Optional[Dict] = None) -> str:
        """Write one flight-record directory and return its path.

        Contents (the schema the tests assert):

        - ``trace.json`` — Perfetto-loadable snapshot of the telemetry
          tracer + metrics (present when telemetry is wired),
        - ``stacks.txt`` — ``faulthandler`` dump of every thread,
        - ``health.json`` — reason, step/beat ages, drained-loss tail,
          degraded flag, per-worker last stats, metrics snapshot.
        """
        with self._dump_lock:
            seq = self._dump_seq
            self._dump_seq += 1
        # pid+sequence naming: unique per process without wall-clock reads
        # (lint rule O001 keeps wall time out of obs modules)
        path = os.path.join(
            self.cfg.flightrec_dir, f"{os.getpid()}-{seq:02d}-{reason}"
        )
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "stacks.txt"), "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
        if self._telemetry is not None:
            try:
                self._telemetry.write_trace(os.path.join(path, "trace.json"))
            except Exception as e:  # a failed snapshot must not mask the fault
                log.warning("flight-record trace snapshot failed: %s", e)
        now = time.monotonic()
        payload: Dict = {
            "reason": reason,
            "steps_done": self._last_step + 1,
            "beat_age_s": round(now - self._last_beat, 3),
            "pulse_age_s": round(now - self._last_pulse, 3),
            "degraded": self.degraded,
            "losses_tail": self._loss_tail[-self.cfg.loss_tail:],
            "context": context or {},
        }
        if self._client is not None:
            payload["workers"] = {
                "last_stats": {
                    str(w): s
                    for w, s in getattr(self._client, "_last_stats", {}).items()
                },
                "dead": {
                    str(w): r
                    for w, r in getattr(self._client, "_dead", {}).items()
                },
                "silent_rounds": {str(w): n for w, n in self._silent.items()},
            }
        if self._telemetry is not None:
            payload["metrics"] = self._telemetry.metrics.summary()
        with open(os.path.join(path, "health.json"), "w") as f:
            json.dump(payload, f, indent=1, default=str)
            f.write("\n")
        log.info("flight record (%s) -> %s", reason, path)
        return path
