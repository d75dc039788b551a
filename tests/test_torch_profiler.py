"""The port's profiler (``utils/profiler.py``) against the JAX package's
on the same seeded inputs: span statistics, counters, gauges, the comms
record, the cross-process export and merge (bitwise), the trace reader
on one synthetic event set written in each package's format, memory
stats and FLOPs off the card; and the port's own span, trace and
prefetch hooks on the CPU (tests/test_torch_cuda_kernels.py holds the
sync span and the memory keys on the card)."""

import gzip
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.utils import profiler as jax_prof
from ray_lightning_accelerators_tpu_torch import Trainer
from ray_lightning_accelerators_tpu_torch.data import prefetch
from ray_lightning_accelerators_tpu_torch.utils import profiler as port_prof
from ray_lightning_accelerators_tpu_torch.utils.profiler import Profiler

from .torch_boring import BoringModel, boring_loaders

torch.set_num_threads(2)

COMMS = {"mode": "int8", "exchange_bytes_per_step": 1234,
         "baseline_fp32_bytes_per_step": 4936, "compression_ratio": 4.0,
         "compressed_ratio": 3.9}


def _feed(prof, rng, n, names=("a", "b", "c/d")):
    """The same seeded observations, counters and gauges into a profiler
    of either package."""
    durs = rng.exponential(0.01, size=n)
    which = rng.integers(0, len(names), size=n)
    for dt, w in zip(durs, which):
        prof.observe(names[w], float(dt))
    for i in range(7):
        prof.incr("prefetch_starved_steps", int(i % 3))
        prof.gauge("prefetch_depth", float(rng.integers(0, 4)))
    prof.incr("fsdp_fallback")
    return prof


@pytest.mark.parametrize("n", [50, 9000])
def test_observations_and_merges_match_jax_bitwise(n):
    """Under and over the 4096-sample reservoir: each side's
    ``export_state`` and ``summary`` are bitwise the JAX profiler's, and
    so are two merges (an export dict and a live profiler, the weighted
    A-Res path once the union passes the cap) and ``describe``."""
    ours = _feed(Profiler(), np.random.default_rng(n), n)
    theirs = _feed(jax_prof.Profiler(), np.random.default_rng(n), n)
    ours.record_comms(COMMS)
    theirs.record_comms(COMMS)
    assert ours.export_state() == theirs.export_state()
    assert ours.summary() == theirs.summary()
    assert ours.counters() == theirs.counters()
    assert ours.gauges() == theirs.gauges()
    assert ours.comms() == theirs.comms()
    other_o = _feed(Profiler(), np.random.default_rng(n + 1), n // 2 + 5)
    other_t = _feed(jax_prof.Profiler(), np.random.default_rng(n + 1),
                    n // 2 + 5)
    ours.merge(other_o.export_state()).merge(other_o)
    theirs.merge(other_t.export_state()).merge(other_t)
    assert ours.export_state() == theirs.export_state()
    assert ours.summary() == theirs.summary()
    assert ours.describe() == theirs.describe()
    with pytest.raises(TypeError, match="export_state"):
        Profiler().merge(3)


def test_spans_nest_count_and_reset():
    prof = Profiler()
    for _ in range(3):
        with prof.span("outer"):
            with prof.span("inner"):
                time.sleep(0.001)
    s = prof.summary()
    assert s["outer"]["count"] == s["outer/inner"]["count"] == 3
    assert s["outer"]["total_s"] >= s["outer/inner"]["total_s"] > 0
    assert "outer/inner" in prof.describe()
    prof.reset()
    assert prof.summary() == {} and prof.comms() is None


def test_tail_percentiles_and_exact_max():
    prof = Profiler()
    for i in range(1, 101):
        prof.observe("op", i / 1000.0)
    s = prof.summary()["op"]
    assert (s["p50_s"], s["p95_s"], s["p99_s"]) == (0.05, 0.095, 0.099)
    prof.observe("op", 9.9)
    for _ in range(5000):
        prof.observe("op", 0.001)
    assert prof.summary()["op"]["max_s"] == 9.9


def test_pickle_ships_sync_only():
    """A rank builds its own clean profile from the shipped ``sync``, so
    the driver's merge sees every rank once."""
    prof = _feed(Profiler(sync=True), np.random.default_rng(0), 10)
    back = pickle.loads(pickle.dumps(prof))
    assert back.sync is True and back.summary() == {}
    assert back.counters() == {} and back.comms() is None


def test_sync_span_waits_for_cuda_outputs_only(monkeypatch):
    """On the CPU a sync span's outputs are already computed: nothing is
    synchronised (the card's wait is tests/test_torch_cuda_kernels.py's)."""
    def boom(*a, **k):
        raise AssertionError("synchronised a CPU tensor")

    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    prof = Profiler(sync=True)
    with prof.span("step") as h:
        h.set({"loss": torch.ones(3), "rows": [torch.zeros(2)]})
    assert prof.summary()["step"]["count"] == 1


def test_trace_roundtrip_and_double_start(tmp_path):
    """``trace`` writes a Chrome trace under its dir (the CPU's: no
    device rows, so the reader returns none); a second start raises."""
    prof = Profiler()
    with prof.trace(str(tmp_path / "t")):
        with prof.span("work"):
            torch.ones(64, 64).sum()
    files = [f for f in os.listdir(tmp_path / "t")
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / "t" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "work" in names   # the span's record_function range
    assert port_prof.trace_events(str(tmp_path / "t")) == []
    prof.start_trace(str(tmp_path / "u"))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            prof.start_trace(str(tmp_path / "v"))
    finally:
        assert prof.stop_trace() == str(tmp_path / "u")
    assert prof.stop_trace() is None
    with pytest.raises(FileNotFoundError):
        port_prof.trace_events(str(tmp_path / "empty"))


def _events():
    """One device timeline (pid 0): a kernel of 1000 us holding two
    nested ones (one with a memcpy's bytes, one with flops), a second
    device (pid 1) overlapping it, and a host op spanning everything."""
    return [
        # (name, category, pid, tid, ts_us, dur_us, bytes, flops)
        ("outer_kernel", "kernel", 0, 7, 0, 1000, 0, 0),
        ("Memcpy HtoD", "gpu_memcpy", 0, 8, 10, 400, 10 ** 9, 0),
        ("flash_fwd_kernel_tc", "kernel", 0, 7, 450, 500, 0,
         50 * 10 ** 12 * 500 // 10 ** 6),
        ("rms_norm_kernel", "kernel", 1, 7, 100, 300, 0, 0),
        ("rms_norm_kernel", "kernel", 1, 7, 500, 100, 0, 0),
    ]


def test_trace_op_summary_matches_jax_on_one_event_set(tmp_path):
    """The same events written once as the JAX package's XPlane export
    (``*.trace.json.gz``, device clock in ps) and once as a torch Chrome
    trace (``cat`` kernel / gpu_memcpy, ``ts`` / ``dur`` in us, host rows
    beside the device's): both readers give the same rows' order and
    the same summary, nesting resolved per device and the host op never
    a kernel's parent."""
    jax_events, torch_events = [], []
    for name, cat, pid, tid, ts, dur, nbytes, flops in _events():
        jax_events.append({
            "ph": "X", "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur,
            "args": {"device_offset_ps": str(ts * 10 ** 6),
                     "device_duration_ps": str(dur * 10 ** 6),
                     "hlo_category": cat,
                     "raw_bytes_accessed": str(nbytes),
                     "model_flops": str(flops)}})
        args = {"device": pid, "stream": tid}
        if nbytes:
            args["bytes"] = nbytes
        if flops:
            args["flops"] = flops
        torch_events.append({"ph": "X", "cat": cat, "name": name,
                             "pid": pid, "tid": tid, "ts": float(ts),
                             "dur": float(dur), "args": args})
    jax_events.append({"ph": "X", "name": "host", "pid": 701, "ts": 0,
                       "dur": 5000})
    torch_events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                         "pid": 0, "tid": 1, "ts": 0.0, "dur": 5000.0,
                         "args": {}})
    jd = tmp_path / "jax" / "plugins" / "profile" / "run"
    jd.mkdir(parents=True)
    with gzip.open(jd / "vm.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": jax_events}, f)
    td = tmp_path / "torch"
    td.mkdir()
    with open(td / "rla_1_2.pt.trace.json", "w") as f:
        json.dump({"traceEvents": torch_events}, f)

    ours = port_prof.trace_op_summary(str(td))
    theirs = jax_prof.trace_op_summary(str(tmp_path / "jax"))
    assert ours == theirs
    assert port_prof.trace_op_summary(str(td), top=2) == \
        jax_prof.trace_op_summary(str(tmp_path / "jax"), top=2)
    assert [e["name"] for e in port_prof.trace_events(str(td))] == \
        [e["name"] for e in jax_prof.trace_events(str(tmp_path / "jax"))]
    # pid 0: 1000 us, nothing double-counted; pid 1: 400 us
    assert ours["total_ms"] == pytest.approx(1.4)
    assert ours["by_category"]["gpu_memcpy"]["gbps"] == \
        pytest.approx(2500.0)
    assert ours["by_category"]["kernel"]["tfs"] > 0
    rms = next(o for o in ours["ops"] if o["name"] == "rms_norm_kernel")
    assert rms["count"] == 2 and rms["self_ms"] == pytest.approx(0.4)


def test_memory_stats_flops_and_mfu_off_the_card():
    """Without a card: one empty stats dict and no bytes in use (the
    JAX CPU backend's stats are empty too), MFU 0.0 with no known peak
    (JAX's on its CPU backend as well), and the FLOP counter's matmul
    count exact."""
    assert port_prof.device_memory_stats() == [{}]
    assert port_prof.device_bytes_in_use() is None
    assert all(d == {} for d in jax_prof.device_memory_stats())
    assert jax_prof.device_bytes_in_use() is None
    assert port_prof.mfu(1e9, 1e-3) == jax_prof.mfu(1e9, 1e-3) == 0.0
    assert port_prof.mfu(1e9, 1e-3, peak_flops=1e12) == \
        jax_prof.mfu(1e9, 1e-3, peak_flops=1e12) == pytest.approx(1.0)
    a, b = torch.ones(128, 256), torch.ones(256, 64)
    assert port_prof.flops_estimate(torch.matmul, a, b) == 2 * 128 * 256 * 64
    assert port_prof.flops_estimate(torch.add, a, a) is None


def test_prefetch_pipeline_records_the_jax_hooks():
    """With a profiler the pipeline records each fetch (``data_fetch``),
    each hand-over's wait (``h2d_wait``), the ``prefetch_depth`` gauge
    and the ``prefetch_starved_steps`` counter, beside its own
    ``starved_steps``; the no-thread pipeline (a native-engine source)
    times its fetches too."""
    def slow(n):
        for i in range(n):
            time.sleep(0.02 if i >= 2 else 0.0)
            yield np.full((2,), i, np.float32)

    prof = Profiler()
    pf = prefetch.prefetch_pipeline(slow(6), 2, None, profiler=prof)
    try:
        got = [int(x[0]) for x in pf]
    finally:
        pf.close()
    assert got == list(range(6))
    s = prof.summary()
    assert s["data_fetch"]["count"] == 6 and s["h2d_wait"]["count"] == 6
    assert prof.gauges()["prefetch_depth"]["count"] == 6
    assert prof.counters().get("prefetch_starved_steps", 0) == \
        pf.starved_steps > 0
    prof2 = Profiler()
    pf2 = prefetch.prefetch_pipeline(iter([1, 2, 3]), 2, None,
                                     host_thread=False, profiler=prof2)
    try:
        assert list(pf2) == [1, 2, 3]
    finally:
        pf2.close()
    assert prof2.summary()["data_fetch"]["count"] == 3


@pytest.mark.parametrize("cache", [False, True])
def test_trainer_spans(tmp_path, cache):
    """The synchronous host-fed path takes a ``data_fetch``, an ``h2d``
    and a ``train_step`` span a step and a ``validation`` span an epoch;
    the device-cached step loop takes ``train_step`` only (a profiler
    keeps the fit off the whole-epoch path, as in JAX)."""
    prof = Profiler()
    train, val = boring_loaders()
    t = Trainer(device="cpu", max_epochs=2, precision="f32", profiler=prof,
                enable_checkpointing=False, log_every_n_steps=10 ** 9,
                seed=0, cache_dataset_on_device=cache, prefetch_batches=0,
                default_root_dir=str(tmp_path))
    t.fit(BoringModel(), train, val)
    s = prof.summary()
    assert s["train_step"]["count"] == t.global_step == 16
    assert s["validation"]["count"] == 2
    if cache:
        assert "h2d" not in s and "data_fetch" not in s
    else:
        assert s["h2d"]["count"] == 16 and s["data_fetch"]["count"] >= 16
