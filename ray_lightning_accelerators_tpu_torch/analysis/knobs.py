"""Environment knobs the port reads, with the JAX package's names and
defaults.

Port of the part of the JAX package's ``analysis/knobs.py``
the serve engine, the replica tier, the trainer and tune read: the host-agent list, its connect timeout,
the agents' and the queue server's token and bind check, the numeric guardian's seven,
the two chunked-prefill quanta,
the KV-handoff wave bound, the replica controller's seventeen (retries
and their backoff, hedging, the slow p99, the circuit breaker and its
revive backoff, the replica ceiling, the scale-up burn, the brownout
fraction, prefix affinity with its vnodes and residency, the prefill
lane and its handoff threshold), the five SLO knobs, the default
sequence-parallel mode, the flight recorder's five, the logger's two,
the live plane's two (``RLA_TPU_METRICS_PORT``, the server's port, and
``RLA_TPU_LIVE_REFRESH_S``, the cluster view's cadence),
the perf observatory's four (the HBM sample throttle, the leak alarm's
streak and bytes, the timeline ring), the MPMD
pipeline runner's five and the recovery layer's eight (the heartbeat,
the wedge timeout, the preemption grace and drain cadence, the chaos
spec and its namespace, the elastic backoff and its cap).  Reads go through the registry, so an
unregistered name fails loudly, and a malformed value warns and falls
back to the default, as there.  A reader given ``env=`` (a worker's env
overlay) takes the overlay's value where it has the key, else the
process environment's.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping, Optional

log = logging.getLogger("rla_tpu_torch")

# name -> (default, help)
KNOBS: Dict[str, tuple] = {
    "RLA_TPU_AGENTS": (
        "", "comma-separated host:port agent list, set by `rla-tpu-torch "
            "launch` (runtime/agent.py agents_from_env)"),
    "RLA_TPU_AGENT_CONNECT_TIMEOUT": (
        30.0, "seconds a driver keeps retrying an agent that refuses its "
              "connection, while the agent boots (runtime/agent.py)"),
    "RLA_TPU_AGENT_TOKEN": (
        "", "shared secret authenticating connections to a host agent or "
            "a queue server (runtime/agent.py, runtime/queue.py)"),
    "RLA_TPU_ALLOW_TOKENLESS_BIND": (
        False, "allow a queue server to bind a non-loopback address "
               "without RLA_TPU_AGENT_TOKEN (runtime/agent.py)"),
    "RLA_TPU_SERVE_AFFINITY": (
        True, "prefix-affinity routing: send a request to the replica "
              "whose KV cache holds the longest resident run of its "
              "chain-hashed prefix keys (breaker/drain states always "
              "override; hedges are deliberate misses) "
              "(serve/controller.py)"),
    "RLA_TPU_SERVE_AFFINITY_RESIDENCY": (
        4096, "per-replica cap on tracked prefix-key residency (LRU); "
              "bounds router memory, not the replica's real cache "
              "(serve/controller.py)"),
    "RLA_TPU_SERVE_AFFINITY_VNODES": (
        32, "virtual nodes per replica on the prefix-affinity "
            "consistent-hash ring; cold keys place on their ring owner "
            "so repeats converge (serve/controller.py)"),
    "RLA_TPU_SERVE_BREAKER_FAILURES": (
        3, "serve circuit breaker: failures in the rolling window before "
           "the reopen backoff starts growing exponentially (below it "
           "every open waits the base delay) (serve/controller.py)"),
    "RLA_TPU_SERVE_BREAKER_WINDOW_S": (
        30.0, "serve circuit breaker rolling failure window in seconds "
              "(serve/controller.py)"),
    "RLA_TPU_SERVE_BROWNOUT_FRAC": (
        0.9, "queue-depth fraction past which a saturated tier with no "
             "scale-up headroom sheds typed BrownoutShed "
             "(serve/controller.py)"),
    "RLA_TPU_SERVE_CHUNK_BLOCKS": (
        8, "big-chunk quantum, in KV blocks, a streaming long-prompt "
           "prefill advances per engine loop while no decode slot is "
           "active (serve/engine.py)"),
    "RLA_TPU_SERVE_CHUNK_MIN_BLOCKS": (
        1, "small-chunk quantum, in KV blocks, a streaming long-prompt "
           "prefill advances between live decode waves (serve/engine.py)"),
    "RLA_TPU_SERVE_HANDOFF_MIN_BLOCKS": (
        1, "minimum full prompt blocks before a request takes the "
           "prefill-lane + KV-handoff path (below it the request serves "
           "end-to-end on a decode-lane replica) (serve/replicas.py)"),
    "RLA_TPU_SERVE_HANDOFF_WAVE_BYTES": (
        4 << 20, "per-wave byte bound on the KV block copy a prefill->"
                 "decode handoff ships through the object store "
                 "(parallel/redistribute.py wave_schedule; "
                 "serve/engine.py)"),
    "RLA_TPU_SERVE_HEDGE": (
        True, "hedged re-dispatch of a slow replica's oldest in-flight "
              "chunk onto a healthy replica (serve/controller.py)"),
    "RLA_TPU_SERVE_MAX_REPLICAS": (
        None, "autoscale ceiling on serve replica count; unset disables "
              "scale-up (serve/controller.py)"),
    "RLA_TPU_SERVE_MAX_RETRIES": (
        2, "per-request infra-failure retry budget before a serve request "
           "fails typed (serve/controller.py)"),
    "RLA_TPU_SERVE_PREFILL_REPLICAS": (
        0, "replicas dedicated to the prefill lane (lowest ranks); 0 "
           "disables disaggregated lanes and every replica serves "
           "end-to-end (serve/controller.py)"),
    "RLA_TPU_SERVE_RETRY_BACKOFF_S": (
        0.02, "base seconds of the serve request-retry exponential "
              "backoff (utils/backoff.py schedule; serve/controller.py)"),
    "RLA_TPU_SERVE_RETRY_BACKOFF_CAP_S": (
        1.0, "cap on the serve request-retry backoff "
             "(serve/controller.py)"),
    "RLA_TPU_SERVE_REVIVE_BACKOFF_S": (
        0.5, "base seconds of the replica circuit-breaker reopen backoff "
             "(serve/controller.py)"),
    "RLA_TPU_SERVE_REVIVE_BACKOFF_CAP_S": (
        15.0, "cap on the replica circuit-breaker reopen backoff "
              "(serve/controller.py)"),
    "RLA_TPU_SERVE_SCALE_UP_BURN": (
        1.0, "sustained slo_burn_rate at/above which the serve tier "
             "scales replica count up (serve/controller.py)"),
    "RLA_TPU_SERVE_SLOW_P99_S": (
        None, "p99 decode-step latency past which a replica is "
              "classified slow (skipped by routing, hedge-eligible); "
              "unset leaves only the watchdog straggler signal "
              "(serve/controller.py)"),
    "RLA_TPU_CHAOS": (
        "", "deterministic fault-injection spec, e.g. 'hang@rank1:step2' "
            "(testing/chaos.py; the test suite guards it outside "
            "chaos-marked tests)"),
    "RLA_TPU_CHAOS_NS": (
        "", "namespace directory keying once-across-restart chaos token "
            "files (testing/chaos.py)"),
    "RLA_TPU_ELASTIC_BACKOFF_CAP_S": (
        60.0, "cap on the exponential restart backoff "
              "(runtime/elastic.py)"),
    "RLA_TPU_ELASTIC_BACKOFF_S": (
        0.0, "base seconds for ElasticRunner's exponential restart "
             "backoff; <=0 disables (runtime/elastic.py)"),
    "RLA_TPU_GUARD": (
        True, "numeric anomaly guardian: in-step NaN/spike detection "
              "riding the metrics readback, with rewind-and-skip "
              "recovery (runtime/guardian.py)"),
    "RLA_TPU_GUARD_EMA_DECAY": (
        0.9, "decay of the grad-norm EMA envelope the spike check "
             "compares against (runtime/guardian.py)"),
    "RLA_TPU_GUARD_MAX_REWINDS": (
        2, "rewind budget per fit: trips beyond it are terminal "
           "(runtime/guardian.py)"),
    "RLA_TPU_GUARD_SPIKE_FACTOR": (
        10.0, "grad-norm spike threshold as a multiple of the EMA "
              "envelope (runtime/guardian.py)"),
    "RLA_TPU_GUARD_SPIKE_FLOOR": (
        1e-3, "absolute grad norm below which the spike check never "
              "fires; keeps a converged model's near-zero EMA from "
              "tripping on jitter (runtime/guardian.py)"),
    "RLA_TPU_GUARD_UPDATE_RATIO_MAX": (
        0.5, "max update-norm / param-norm ratio before the guard flags "
             "the step (runtime/guardian.py)"),
    "RLA_TPU_GUARD_WARMUP_STEPS": (
        20, "steps before the spike / update-ratio checks arm (the EMA "
            "envelope needs history) (runtime/guardian.py)"),
    "RLA_TPU_LIVE_REFRESH_S": (
        2.0, "driver ClusterView refresh cadence in seconds: how often "
             "every rank's live /snapshot is collected again "
             "(telemetry/live.py)"),
    "RLA_TPU_LOG_JSON": (
        False, "structured-JSON log lines (one object per line with "
               "ts/level/logger/rank/pid/msg) instead of the human "
               "formatter (utils/logging.py)"),
    "RLA_TPU_LOG_LEVEL": (
        "WARNING", "package logger level; unknown names warn and default "
                   "(utils/logging.py)"),
    "RLA_TPU_METRICS_PORT": (
        None, "enable the live telemetry plane: port for the per-process "
              "/metrics + /statusz + /healthz HTTP server (loopback-"
              "bound; 0 = ephemeral; workers always bind ephemeral and "
              "publish the port via a portfile under "
              "RLA_TPU_TELEMETRY_DIR); unset = no server "
              "(telemetry/live.py)"),
    "RLA_TPU_PERF_HBM_SAMPLE_S": (
        2.0, "minimum seconds between HBM-ledger pool samples; the "
             "per-step seam is a no-op inside the window "
             "(telemetry/perf.py)"),
    "RLA_TPU_PERF_LEAK_MIN_BYTES": (
        33554432, "total placed-bytes growth a leak streak must reach "
                  "before the hbm_leak event fires (telemetry/perf.py)"),
    "RLA_TPU_PERF_LEAK_SAMPLES": (
        8, "consecutive growing HBM samples before the leak alarm arms "
           "(telemetry/perf.py)"),
    "RLA_TPU_PERF_TIMELINE_RING": (
        64, "per-step phase-timeline ring capacity in recent-step rows "
            "(telemetry/perf.py)"),
    "RLA_TPU_PIPELINE_CKPT_EVERY": (
        1, "MPMD pipeline checkpoint cadence in optimizer steps: the "
           "replay floor after a stage-group failure "
           "(parallel/mpmd/driver.py)"),
    "RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S": (
        60.0, "seconds a pipeline stage waits on a neighbor's mailbox "
              "handoff before failing typed PipelineHandoffTimeout "
              "(parallel/mpmd/handoff.py)"),
    "RLA_TPU_PIPELINE_MAX_FAILURES": (
        2, "per-stage-group failure budget: charged failures past this "
           "raise terminal PipelineStageFailed (parallel/mpmd/driver.py)"),
    "RLA_TPU_PIPELINE_STAGE": (
        None, "this worker's pipeline stage index, set in each stage "
              "group member's env overlay by the PipelineRunner; read by "
              "chaos 'stageN' fault filtering (parallel/mpmd/driver.py, "
              "testing/chaos.py)"),
    "RLA_TPU_PIPELINE_STEP_DEADLINE_S": (
        None, "driver-side per-step future-gather deadline for MPMD "
              "pipeline steps; unset derives a backstop from the handoff "
              "timeout (parallel/mpmd/driver.py)"),
    "RLA_TPU_PREEMPT_CONSENSUS_EVERY": (
        8, "multi-process drain-consensus cadence in steps: the ranks "
           "max-reduce their notice flags every N steps "
           "(core/trainer.py)"),
    "RLA_TPU_PREEMPT_GRACE_S": (
        None, "preemption grace budget in seconds; setting it installs "
              "the SIGTERM notice handler (runtime/preemption.py)"),
    "RLA_TPU_SEQ_PARALLEL_MODE": (
        "ulysses", "default context-parallel attention strategy for "
                   "Trainer(seq_parallel>1) when seq_parallel_mode is not "
                   "passed: 'ulysses' (all_to_all head-scatter; needs "
                   "heads % seq_parallel == 0) or 'ring' (KV rotation) "
                   "(core/trainer.py)"),
    "RLA_TPU_SLO_DEADLINE_S": (
        None, "serve SLO: end-to-end deadline stamped on each request "
              "at admission; expired requests are shed typed "
              "(DeadlineExceeded) before prefill (serve/slo.py)"),
    "RLA_TPU_SLO_TARGET": (
        0.99, "serve SLO target fraction (e.g. 0.99 = '99% of "
              "requests'); burn rate divides the observed violation "
              "fraction by 1 - target (serve/slo.py)"),
    "RLA_TPU_SLO_TOKEN_CADENCE_S": (
        None, "serve SLO: per-token inter-arrival target; decode gaps "
              "above it count as violations (serve/slo.py)"),
    "RLA_TPU_SLO_TTFT_S": (
        None, "serve SLO: time-to-first-token target; prefills landing "
              "above it count as violations (serve/slo.py)"),
    "RLA_TPU_SLO_WINDOW_S": (
        60.0, "rolling window for serve SLO burn-rate accounting "
              "(serve/slo.py)"),
    "RLA_TPU_TELEMETRY": (
        True, "enable the flight recorder; 0 makes every emit a no-op "
              "(telemetry/recorder.py)"),
    "RLA_TPU_TELEMETRY_DIR": (
        None, "directory for per-rank flight-recorder spill files "
              "(rank{N}.events.json), read by the run report "
              "(telemetry/recorder.py)"),
    "RLA_TPU_TELEMETRY_EVENTS": (
        256, "flight-recorder ring capacity in events "
             "(telemetry/recorder.py)"),
    "RLA_TPU_TELEMETRY_SPILL_S": (
        0.5, "minimum seconds between flight-recorder spills; the first "
             "emit always spills (telemetry/recorder.py)"),
    "RLA_TPU_TRACE_ID": (
        None, "ambient trace id a spawned process stamps on its "
              "flight-recorder events, set in env_per_worker so one run "
              "correlates across the driver and its workers "
              "(telemetry/recorder.py)"),
    "RLA_TPU_WEDGE_TIMEOUT_S": (
        None, "stale-heartbeat threshold; setting it arms the watchdog "
              "(runtime/watchdog.py)"),
    "RLA_TPU_WORKER_HEARTBEAT_S": (
        1.0, "worker heartbeat interval; <=0 disables the channel "
             "(runtime/watchdog.py)"),
}

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off", "")


def _lookup(name: str, env: Optional[Mapping[str, str]] = None
            ) -> Optional[str]:
    """The raw value (the overlay's when it has the key), None when
    unset."""
    if name not in KNOBS:
        raise LookupError(f"env knob {name!r} is not registered in "
                          "analysis/knobs.py")
    if env is not None and name in env:
        return env[name]
    return os.environ.get(name)


_MISSING = object()


def _parse(name: str, cast, default, env=None, malformed=_MISSING):
    raw = _lookup(name, env)
    if raw in (None, ""):
        return default
    try:
        return cast(raw)
    except ValueError:
        fallback = default if malformed is _MISSING else malformed
        log.warning("bad %s=%r; using %r", name, raw, fallback)
        return fallback


def get_raw(name: str, env: Optional[Mapping[str, str]] = None
            ) -> Optional[str]:
    """The unparsed string, or None when unset: presence gates and
    pass-through values (chaos specs, tokens)."""
    return _lookup(name, env)


def get_int(name: str, default: Optional[int] = None,
            env: Optional[Mapping[str, str]] = None) -> Optional[int]:
    """``default`` (the registered one when None) when unset or empty;
    the default, with one warning, when set but unparseable."""
    if default is None and name in KNOBS:
        default = KNOBS[name][0]
    return _parse(name, int, default, env)


def get_float(name: str, default: Optional[float] = None,
              env: Optional[Mapping[str, str]] = None, *,
              malformed=_MISSING) -> Optional[float]:
    """``default`` when unset or empty (None stays None, as in the JAX
    package's reader); ``malformed`` (the default unless given), with one
    warning, when set but unparseable."""
    return _parse(name, float, default, env, malformed)


def get_str(name: str, default: Optional[str] = None,
            env: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """The raw value, or ``default`` when unset or empty."""
    raw = _lookup(name, env)
    return default if raw in (None, "") else raw


def get_bool(name: str, default: bool = False,
             env: Optional[Mapping[str, str]] = None) -> bool:
    """1/true/yes/on or 0/false/no/off; ``default`` when unset, and with
    one warning when it is neither."""
    raw = _lookup(name, env)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    log.warning("bad %s=%r (expected 1/0/true/false); using %r",
                name, raw, default)
    return default
