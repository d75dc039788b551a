"""The ``RLA_TPU_*`` environment-knob registry and its typed getters.

Port of the JAX package's ``analysis/knobs.py``, whole.  Every env knob
the port reads is declared here, with its name, kind, default and one
line of help, and read through a typed getter:

- **malformed values never crash**: a bad value logs one warning and
  falls back to the default (or to ``malformed=`` where the caller
  gives one);
- **unregistered names never parse silently**: a getter called with a
  name missing from ``KNOBS`` raises ``LookupError``, and
  ``analysis/rules/knob_registry.py`` rejects raw ``os.environ`` reads
  of ``RLA_TPU_*`` names anywhere else in the port;
- **per-worker overlays**: a reader given ``env=`` (a worker's env
  overlay) takes the overlay's value where it has the key, else the
  process environment's.

The knobs that name TPU or JAX machinery (the Pallas and int8-kernel
switches, the flash block sizes, the worker and test platforms, the
bench child and inside-worker marks) are not registered: the port reads
none of them.

This module is a dependency leaf (stdlib only): ``utils.logging`` and
the runtime modules import it, never the reverse.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

log = logging.getLogger("rla_tpu_torch")

KINDS = ("str", "int", "float", "bool", "flag")

# values get_bool accepts; anything else warns and uses the default
_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off", ""))


@dataclass(frozen=True)
class Knob:
    """One declared environment knob.

    ``kind``: parse discipline -- ``flag`` is presence-truthiness (any
    non-empty value enables), ``bool`` parses 1/true/yes/on vs
    0/false/no/off.  ``default`` documents the effective default; call
    sites may pass their own.  ``scope``: where the knob is read
    (``package`` knobs are the ones the lint enforces)."""

    name: str
    kind: str
    default: object
    help: str
    scope: str = "package"


KNOBS: Dict[str, Knob] = {}


def _register(knob: Knob) -> Knob:
    if knob.kind not in KINDS:
        raise ValueError(f"unknown knob kind {knob.kind!r} for {knob.name}")
    if knob.name in KNOBS:
        raise ValueError(f"duplicate knob registration: {knob.name}")
    KNOBS[knob.name] = knob
    return knob


# --------------------------------------------------------------------- #
# Registry (alphabetical).  The lint extracts these names statically    #
# (Knob("LITERAL", ...)), so names must stay string literals.           #
# --------------------------------------------------------------------- #
_register(Knob("RLA_TPU_AGENTS", "str", "",
               "comma-separated host:port agent list, set by "
               "`rla-tpu-torch launch` (runtime/agent.py agents_from_env)"))
_register(Knob("RLA_TPU_AGENT_CONNECT_TIMEOUT", "float", 30.0,
               "seconds a driver keeps retrying an agent that refuses its "
               "connection, while the agent boots (runtime/agent.py)"))
_register(Knob("RLA_TPU_AGENT_TOKEN", "str", "",
               "shared secret authenticating connections to a host agent "
               "or a queue server (runtime/agent.py, runtime/queue.py)"))
_register(Knob("RLA_TPU_ALLOW_TOKENLESS_BIND", "bool", False,
               "allow a queue server to bind a non-loopback address "
               "without RLA_TPU_AGENT_TOKEN (runtime/agent.py)"))
_register(Knob("RLA_TPU_CHAOS", "str", "",
               "deterministic fault-injection spec, e.g. "
               "'hang@rank1:step2' (testing/chaos.py; the test suite "
               "guards it outside chaos-marked tests)"))
_register(Knob("RLA_TPU_CHAOS_NS", "str", "",
               "namespace directory keying once-across-restart chaos token"
               " files (testing/chaos.py)"))
_register(Knob("RLA_TPU_ELASTIC_BACKOFF_CAP_S", "float", 60.0,
               "cap on the exponential restart backoff "
               "(runtime/elastic.py)"))
_register(Knob("RLA_TPU_ELASTIC_BACKOFF_S", "float", 0.0,
               "base seconds for ElasticRunner's exponential restart "
               "backoff; <=0 disables (runtime/elastic.py)"))
_register(Knob("RLA_TPU_GLOBAL_SEED", "int", None,
               "global seed honored by seed_everything(); exported to "
               "children (utils/seed.py)"))
_register(Knob("RLA_TPU_GUARD", "bool", True,
               "numeric anomaly guardian: in-step NaN/spike detection "
               "riding the metrics readback, with rewind-and-skip recovery"
               " (runtime/guardian.py)"))
_register(Knob("RLA_TPU_GUARD_EMA_DECAY", "float", 0.9,
               "decay of the grad-norm EMA envelope the spike check "
               "compares against (runtime/guardian.py)"))
_register(Knob("RLA_TPU_GUARD_MAX_REWINDS", "int", 2,
               "rewind budget per fit: trips beyond it are terminal "
               "(runtime/guardian.py)"))
_register(Knob("RLA_TPU_GUARD_SPIKE_FACTOR", "float", 10.0,
               "grad-norm spike threshold as a multiple of the EMA "
               "envelope (runtime/guardian.py)"))
_register(Knob("RLA_TPU_GUARD_SPIKE_FLOOR", "float", 0.001,
               "absolute grad norm below which the spike check never "
               "fires; keeps a converged model's near-zero EMA from "
               "tripping on jitter (runtime/guardian.py)"))
_register(Knob("RLA_TPU_GUARD_UPDATE_RATIO_MAX", "float", 0.5,
               "max update-norm / param-norm ratio before the guard flags "
               "the step (runtime/guardian.py)"))
_register(Knob("RLA_TPU_GUARD_WARMUP_STEPS", "int", 20,
               "steps before the spike / update-ratio checks arm (the EMA "
               "envelope needs history) (runtime/guardian.py)"))
_register(Knob("RLA_TPU_LIVE_REFRESH_S", "float", 2.0,
               "driver ClusterView refresh cadence in seconds: how often "
               "every rank's live /snapshot is collected again "
               "(telemetry/live.py)"))
_register(Knob("RLA_TPU_LOG_JSON", "bool", False,
               "structured-JSON log lines (one object per line with "
               "ts/level/logger/rank/pid/msg) instead of the human "
               "formatter (utils/logging.py)"))
_register(Knob("RLA_TPU_LOG_LEVEL", "str", "WARNING",
               "package logger level; unknown names warn and default "
               "(utils/logging.py)"))
_register(Knob("RLA_TPU_METRICS_PORT", "int", None,
               "enable the live telemetry plane: port for the per-process "
               "/metrics + /statusz + /healthz HTTP server "
               "(loopback-bound; 0 = ephemeral; workers always bind "
               "ephemeral and publish the port via a portfile under "
               "RLA_TPU_TELEMETRY_DIR); unset = no server "
               "(telemetry/live.py)"))
_register(Knob("RLA_TPU_PERF_HBM_SAMPLE_S", "float", 2.0,
               "minimum seconds between HBM-ledger pool samples; the "
               "per-step seam is a no-op inside the window "
               "(telemetry/perf.py)"))
_register(Knob("RLA_TPU_PERF_LEAK_MIN_BYTES", "int", 33554432,
               "total placed-bytes growth a leak streak must reach before "
               "the hbm_leak event fires (telemetry/perf.py)"))
_register(Knob("RLA_TPU_PERF_LEAK_SAMPLES", "int", 8,
               "consecutive growing HBM samples before the leak alarm arms"
               " (telemetry/perf.py)"))
_register(Knob("RLA_TPU_PERF_TIMELINE_RING", "int", 64,
               "per-step phase-timeline ring capacity in recent-step rows "
               "(telemetry/perf.py)"))
_register(Knob("RLA_TPU_PIPELINE_CKPT_EVERY", "int", 1,
               "MPMD pipeline checkpoint cadence in optimizer steps: the "
               "replay floor after a stage-group failure "
               "(parallel/mpmd/driver.py)"))
_register(Knob("RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S", "float", 60.0,
               "seconds a pipeline stage waits on a neighbor's mailbox "
               "handoff before failing typed PipelineHandoffTimeout "
               "(parallel/mpmd/handoff.py)"))
_register(Knob("RLA_TPU_PIPELINE_MAX_FAILURES", "int", 2,
               "per-stage-group failure budget: charged failures past this"
               " raise terminal PipelineStageFailed "
               "(parallel/mpmd/driver.py)"))
_register(Knob("RLA_TPU_PIPELINE_STAGE", "int", None,
               "this worker's pipeline stage index, set in each stage "
               "group member's env overlay by the PipelineRunner; read by "
               "chaos 'stageN' fault filtering (parallel/mpmd/driver.py, "
               "testing/chaos.py)"))
_register(Knob("RLA_TPU_PIPELINE_STEP_DEADLINE_S", "float", None,
               "driver-side per-step future-gather deadline for MPMD "
               "pipeline steps; unset derives a backstop from the handoff "
               "timeout (parallel/mpmd/driver.py)"))
_register(Knob("RLA_TPU_PREEMPT_CONSENSUS_EVERY", "int", 8,
               "multi-process drain-consensus cadence in steps: the ranks "
               "max-reduce their notice flags every N steps "
               "(core/trainer.py)"))
_register(Knob("RLA_TPU_PREEMPT_GRACE_S", "float", None,
               "preemption grace budget in seconds; setting it installs "
               "the SIGTERM notice handler (runtime/preemption.py)"))
_register(Knob("RLA_TPU_SEQ_PARALLEL_MODE", "str", "ulysses",
               "default context-parallel attention strategy for "
               "Trainer(seq_parallel>1) when seq_parallel_mode is not "
               "passed: 'ulysses' (all_to_all head-scatter; needs heads % "
               "seq_parallel == 0) or 'ring' (KV rotation) "
               "(core/trainer.py)"))
_register(Knob("RLA_TPU_SERVE_AFFINITY", "bool", True,
               "prefix-affinity routing: send a request to the replica "
               "whose KV cache holds the longest resident run of its "
               "chain-hashed prefix keys (breaker/drain states always "
               "override; hedges are deliberate misses) "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_AFFINITY_RESIDENCY", "int", 4096,
               "per-replica cap on tracked prefix-key residency (LRU); "
               "bounds router memory, not the replica's real cache "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_AFFINITY_VNODES", "int", 32,
               "virtual nodes per replica on the prefix-affinity "
               "consistent-hash ring; cold keys place on their ring owner "
               "so repeats converge (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_BREAKER_FAILURES", "int", 3,
               "serve circuit breaker: failures in the rolling window "
               "before the reopen backoff starts growing exponentially "
               "(below it every open waits the base delay) "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_BREAKER_WINDOW_S", "float", 30.0,
               "serve circuit breaker rolling failure window in seconds "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_BROWNOUT_FRAC", "float", 0.9,
               "queue-depth fraction past which a saturated tier with no "
               "scale-up headroom sheds typed BrownoutShed "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_CHUNK_BLOCKS", "int", 8,
               "big-chunk quantum, in KV blocks, a streaming long-prompt "
               "prefill advances per engine loop while no decode slot is "
               "active (serve/engine.py)"))
_register(Knob("RLA_TPU_SERVE_CHUNK_MIN_BLOCKS", "int", 1,
               "small-chunk quantum, in KV blocks, a streaming long-prompt"
               " prefill advances between live decode waves "
               "(serve/engine.py)"))
_register(Knob("RLA_TPU_SERVE_HANDOFF_MIN_BLOCKS", "int", 1,
               "minimum full prompt blocks before a request takes the "
               "prefill-lane + KV-handoff path (below it the request "
               "serves end-to-end on a decode-lane replica) "
               "(serve/replicas.py)"))
_register(Knob("RLA_TPU_SERVE_HANDOFF_WAVE_BYTES", "int", 4 << 20,
               "per-wave byte bound on the KV block copy a prefill->decode"
               " handoff ships through the object store "
               "(parallel/redistribute.py wave_schedule; serve/engine.py)"))
_register(Knob("RLA_TPU_SERVE_HEDGE", "bool", True,
               "hedged re-dispatch of a slow replica's oldest in-flight "
               "chunk onto a healthy replica (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_MAX_REPLICAS", "int", None,
               "autoscale ceiling on serve replica count; unset disables "
               "scale-up (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_MAX_RETRIES", "int", 2,
               "per-request infra-failure retry budget before a serve "
               "request fails typed (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_PREFILL_REPLICAS", "int", 0,
               "replicas dedicated to the prefill lane (lowest ranks); 0 "
               "disables disaggregated lanes and every replica serves "
               "end-to-end (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_RETRY_BACKOFF_CAP_S", "float", 1.0,
               "cap on the serve request-retry backoff "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_RETRY_BACKOFF_S", "float", 0.02,
               "base seconds of the serve request-retry exponential "
               "backoff (utils/backoff.py schedule; serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_REVIVE_BACKOFF_CAP_S", "float", 15.0,
               "cap on the replica circuit-breaker reopen backoff "
               "(serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_REVIVE_BACKOFF_S", "float", 0.5,
               "base seconds of the replica circuit-breaker reopen backoff"
               " (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_SCALE_UP_BURN", "float", 1.0,
               "sustained slo_burn_rate at/above which the serve tier "
               "scales replica count up (serve/controller.py)"))
_register(Knob("RLA_TPU_SERVE_SLOW_P99_S", "float", None,
               "p99 decode-step latency past which a replica is classified"
               " slow (skipped by routing, hedge-eligible); unset leaves "
               "only the watchdog straggler signal (serve/controller.py)"))
_register(Knob("RLA_TPU_SLO_DEADLINE_S", "float", None,
               "serve SLO: end-to-end deadline stamped on each request at "
               "admission; expired requests are shed typed "
               "(DeadlineExceeded) before prefill (serve/slo.py)"))
_register(Knob("RLA_TPU_SLO_TARGET", "float", 0.99,
               "serve SLO target fraction (e.g. 0.99 = '99% of requests');"
               " burn rate divides the observed violation fraction by 1 - "
               "target (serve/slo.py)"))
_register(Knob("RLA_TPU_SLO_TOKEN_CADENCE_S", "float", None,
               "serve SLO: per-token inter-arrival target; decode gaps "
               "above it count as violations (serve/slo.py)"))
_register(Knob("RLA_TPU_SLO_TTFT_S", "float", None,
               "serve SLO: time-to-first-token target; prefills landing "
               "above it count as violations (serve/slo.py)"))
_register(Knob("RLA_TPU_SLO_WINDOW_S", "float", 60.0,
               "rolling window for serve SLO burn-rate accounting "
               "(serve/slo.py)"))
_register(Knob("RLA_TPU_SPMD_SANITIZER", "bool", False,
               "opt-in cross-rank collective sanitizer: each process "
               "records its traced collective call sequence and the driver"
               " diffs sequences across ranks after fan-out/chaos runs "
               "(testing/spmd_sanitizer.py)"))
_register(Knob("RLA_TPU_SPMD_SEQ_EVENTS", "int", 512,
               "sanitizer sequence-ring capacity in recorded collective "
               "calls per process (testing/spmd_sanitizer.py)"))
_register(Knob("RLA_TPU_TELEMETRY", "bool", True,
               "enable the flight recorder; 0 makes every emit a no-op "
               "(telemetry/recorder.py)"))
_register(Knob("RLA_TPU_TELEMETRY_DIR", "str", None,
               "directory for per-rank flight-recorder spill files "
               "(rank{N}.events.json), read by the run report "
               "(telemetry/recorder.py)"))
_register(Knob("RLA_TPU_TELEMETRY_EVENTS", "int", 256,
               "flight-recorder ring capacity in events "
               "(telemetry/recorder.py)"))
_register(Knob("RLA_TPU_TELEMETRY_SPILL_S", "float", 0.5,
               "minimum seconds between flight-recorder spills; the first "
               "emit always spills (telemetry/recorder.py)"))
_register(Knob("RLA_TPU_TRACE_ID", "str", None,
               "ambient trace id a spawned process stamps on its "
               "flight-recorder events, set in env_per_worker so one run "
               "correlates across the driver and its workers "
               "(telemetry/recorder.py)"))
_register(Knob("RLA_TPU_WEDGE_TIMEOUT_S", "float", None,
               "stale-heartbeat threshold; setting it arms the watchdog "
               "(runtime/watchdog.py)"))
_register(Knob("RLA_TPU_WORKER_HEARTBEAT_S", "float", 1.0,
               "worker heartbeat interval; <=0 disables the channel "
               "(runtime/watchdog.py)"))


def registered_names() -> frozenset:
    return frozenset(KNOBS)


# --------------------------------------------------------------------- #
# Typed getters                                                          #
# --------------------------------------------------------------------- #
_MISSING = object()


def _lookup(name: str, env: Optional[Mapping[str, str]]) -> Optional[str]:
    """Raw value: the per-worker overlay first (when it has the key),
    then the process env; None when unset in both.  Also the
    registration gate: every read funnels through here."""
    if name not in KNOBS:
        raise LookupError(
            f"env knob {name!r} is not registered in analysis/knobs.py; "
            "declare it (name, type, default, help) before reading it")
    if env is not None and name in env:
        return env[name]
    return os.environ.get(name)


def get_raw(name: str, env: Optional[Mapping[str, str]] = None
            ) -> Optional[str]:
    """The unparsed string, or None when unset: presence gates and
    pass-through values (chaos specs, tokens)."""
    return _lookup(name, env)


def get_str(name: str, default: Optional[str] = None,
            env: Optional[Mapping[str, str]] = None) -> Optional[str]:
    raw = _lookup(name, env)
    return default if raw in (None, "") else raw


def _parse(name: str, cast, default, malformed, env):
    raw = _lookup(name, env)
    if raw in (None, ""):
        return default
    try:
        return cast(raw)
    except ValueError:
        fallback = default if malformed is _MISSING else malformed
        log.warning("bad %s=%r; using %r", name, raw, fallback)
        return fallback


def get_int(name: str, default: Optional[int] = None, *,
            malformed=_MISSING,
            env: Optional[Mapping[str, str]] = None) -> Optional[int]:
    """``default`` when unset or empty; ``malformed`` (defaults to
    ``default``) with one warning when set but unparseable."""
    return _parse(name, int, default, malformed, env)


def get_float(name: str, default: Optional[float] = None, *,
              malformed=_MISSING,
              env: Optional[Mapping[str, str]] = None) -> Optional[float]:
    return _parse(name, float, default, malformed, env)


def get_bool(name: str, default: bool = False,
             env: Optional[Mapping[str, str]] = None) -> bool:
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


def get_flag(name: str, env: Optional[Mapping[str, str]] = None) -> bool:
    """Presence-truthiness: any non-empty value enables (so ``X=0``
    enables a flag knob; new knobs that want parsing use ``bool``)."""
    return bool(_lookup(name, env))
