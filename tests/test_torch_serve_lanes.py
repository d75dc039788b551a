"""The port's serve-engine lanes against the JAX package's engine on the
same weights: the speculative lane (tests/test_paged_serve.py:299-401),
the KV handoff between a prefill engine and a decode engine
(tests/test_prefix_affinity.py:339-423), the SLO engine and the
``perf_timeline`` hook.  Tokens must be identical to the JAX engine's and
to the port's ``generate()``; handoff descriptors equal field by field
and their payloads within 1e-5 relative.  All f32 on the CPU
(``device="cpu"``: the kernels' plain versions), except one bf16
round trip of the port alone."""

import time

import jax
import numpy as np
import pytest
import torch

from ray_lightning_accelerators_tpu.models.speculative import (
    serve_speculative as jax_serve_speculative)
from ray_lightning_accelerators_tpu.models.transformer import (
    GPT as JaxGPT, TransformerConfig as JaxConfig)
from ray_lightning_accelerators_tpu.runtime import (
    object_store as jax_object_store)
from ray_lightning_accelerators_tpu.serve import ServeEngine as JaxEngine
from ray_lightning_accelerators_tpu.serve.slo import (
    SloPolicy as JaxSloPolicy)
from ray_lightning_accelerators_tpu_torch.models.speculative import (
    serve_speculative)
from ray_lightning_accelerators_tpu_torch.models.transformer import (
    GPT, TransformerConfig)
from ray_lightning_accelerators_tpu_torch.runtime import object_store
from ray_lightning_accelerators_tpu_torch.serve import (
    DeadlineExceeded, RequestRejected, ServeCancelled, ServeEngine,
    SloPolicy)
from ray_lightning_accelerators_tpu_torch.utils.weights import (
    params_from_jax)

pytestmark = [pytest.mark.serve, pytest.mark.paged]

torch.backends.cuda.matmul.allow_tf32 = False

# tests/test_paged_serve.py _model() and _draft()
TARGET = dict(vocab_size=97, d_model=64, n_heads=2, d_ff=128, n_layers=2,
              max_seq_len=64)
DRAFT = dict(vocab_size=97, d_model=32, n_heads=2, d_ff=64, n_layers=1,
             max_seq_len=128)
# tests/test_prefix_affinity.py _CFG
AFFINITY = dict(vocab_size=61, d_model=32, n_heads=2, d_ff=64, n_layers=2,
                max_seq_len=48)


def _pair(cfg, seed):
    jm = JaxGPT(JaxConfig(**cfg))
    jp = jax.device_get(jm.init_params(jax.random.PRNGKey(seed)))
    pm = GPT(TransformerConfig(**cfg), device="cpu")
    return jm, jp, pm, params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET, 0)


@pytest.fixture(scope="module")
def draft():
    return _pair(DRAFT, 5)


@pytest.fixture(scope="module")
def affinity():
    return _pair(AFFINITY, 0)


def _generate(pm, pp, prompt, n):
    return pm.generate(pp, torch.from_numpy(prompt)[None].long(),
                       n)[0].numpy()


# --------------------------------------------------------------------- #
# Speculative lane                                                      #
# --------------------------------------------------------------------- #
SPEC_COUNTERS = ("speculative_requests", "speculative_rounds",
                 "speculative_tokens_accepted", "prefix_hits",
                 "prefix_lookups", "tokens_generated", "completed")


def _spec_prompts():
    rng = np.random.default_rng(9)
    sysp = rng.integers(0, 97, size=(9,)).astype(np.int32)
    p1 = np.concatenate([sysp, rng.integers(0, 97, size=(3,)
                                            ).astype(np.int32)])
    p2 = np.concatenate([sysp, rng.integers(0, 97, size=(4,)
                                            ).astype(np.int32)])
    return [(p1, 9), (p2, 7)]


def test_speculative_lane_matches_jax_engine_and_generate(target, draft):
    """Two prompts sharing a 9-token prefix through the speculative lane
    of an idle engine: tokens equal to the JAX engine's lane and to the
    port's generate(); the lane's counters and the prefix hit equal the
    JAX engine's."""
    jm, jp, pm, pp = target
    jd, jdp, pd, pdp = draft
    reqs = _spec_prompts()
    kw = dict(max_slots=2, queue_depth=8, block_len=4, spec_k=4)
    with JaxEngine(jm, jp, draft_model=jd, draft_params=jdp, **kw) as jeng:
        jouts = [jax_serve_speculative(jeng, p, n, timeout=300)
                 for p, n in reqs]
    with ServeEngine(pm, pp, draft_model=pd, draft_params=pdp,
                     **kw) as eng:
        outs = [serve_speculative(eng, p, n, timeout=300)
                for p, n in reqs]
    for (p, n), out, jout in zip(reqs, outs, jouts):
        np.testing.assert_array_equal(out, np.asarray(jout))
        np.testing.assert_array_equal(out, _generate(pm, pp, p, n))
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in SPEC_COUNTERS} == \
        {k: jst[k] for k in SPEC_COUNTERS}
    assert st["speculative_requests"] == 2 and st["prefix_hits"] >= 1
    assert st["speculative_rounds"] >= 2 and st["steps"] == 0
    assert st["block_pool_used"] == 0


def test_speculative_lane_self_draft_accepts(target):
    """The model drafting for itself (as the card run does): every draft
    is accepted, rounds are few, and the tokens are generate()'s."""
    _, _, pm, pp = target
    p, n = _spec_prompts()[0]
    with ServeEngine(pm, pp, max_slots=2, block_len=4, max_total_len=40,
                     draft_model=pm, draft_params=pp, spec_k=4) as eng:
        out = serve_speculative(eng, p, n, timeout=300)
    np.testing.assert_array_equal(out, _generate(pm, pp, p, n))
    st = eng.stats()
    # 8 tokens after the first, 4 a round: two rounds, 7 of 8 drafts
    # accepted (the budget stops the last one from being checked)
    assert st["speculative_rounds"] == 2
    assert st["speculative_tokens_accepted"] == n - 2


def test_speculative_hint_without_draft_rejects_and_busy_engine_uses_slot(
        target, draft):
    _, _, pm, pp = target
    _, _, pd, pdp = draft
    with ServeEngine(pm, pp, max_slots=2, block_len=4) as eng:
        with pytest.raises(RequestRejected, match="draft model"):
            eng.submit(np.asarray([1, 2, 3], np.int32), 4,
                       speculative=True)
    assert eng.stats()["rejected"] == 1
    rng = np.random.default_rng(2)
    p_bg = rng.integers(0, 97, size=(5,)).astype(np.int32)
    p_sp = rng.integers(0, 97, size=(6,)).astype(np.int32)
    with ServeEngine(pm, pp, max_slots=2, queue_depth=8, block_len=4,
                     draft_model=pd, draft_params=pdp) as eng:
        r_bg = eng.submit(p_bg, 24)          # a long-running occupant
        deadline = time.monotonic() + 60
        while eng.stats()["prefills"] < 1:
            assert time.monotonic() < deadline, "occupant never admitted"
            time.sleep(0.005)
        r_sp = eng.submit(p_sp, 6, speculative=True)
        out_sp = r_sp.result(timeout=300)
        out_bg = r_bg.result(timeout=300)
    np.testing.assert_array_equal(out_bg, _generate(pm, pp, p_bg, 24))
    np.testing.assert_array_equal(out_sp, _generate(pm, pp, p_sp, 6))
    st = eng.stats()
    assert st["completed"] == 2 and st["speculative_requests"] == 0
    assert st["block_pool_used"] == 0


def test_stop_cancel_active_interrupts_speculative_lane(target, draft):
    _, _, pm, pp = target
    _, _, pd, pdp = draft
    eng = ServeEngine(pm, pp, max_slots=2, block_len=4, draft_model=pd,
                      draft_params=pdp, spec_k=4)
    orig = eng._d_propose

    def slow_propose(*a):
        time.sleep(0.05)   # stretch each round: a wide cancel window
        return orig(*a)

    eng._d_propose = slow_propose
    eng.start()
    try:
        r = eng.submit(np.asarray([1, 2, 3, 4], np.int32), 40,
                       speculative=True)
        deadline = time.monotonic() + 60
        while eng.stats()["speculative_rounds"] < 1:
            assert time.monotonic() < deadline, "the lane never started"
            time.sleep(0.005)
        eng.stop(cancel_active=True, timeout=30)
        with pytest.raises(ServeCancelled, match="speculative"):
            r.result(timeout=5)
        assert eng.stats()["cancelled"] >= 1
        assert eng.allocator.stats()["used"] == 0
    finally:
        eng.stop(cancel_active=True, timeout=5)


@pytest.mark.parametrize("case", ["dense", "spec_k", "vocab", "draft_len"])
def test_speculative_constructor_rejections(target, draft, case):
    """The JAX engine's constructor checks, with its messages; the JAX
    engine refuses each the same way."""
    jm, jp, pm, pp = target
    jd, jdp, pd, pdp = draft
    kw, match = {
        "dense": (dict(paged=False), "paged"),
        "spec_k": (dict(spec_k=0), "spec_k"),
        "vocab": (dict(draft_vocab=61), "vocab"),
        "draft_len": (dict(draft_len=32), "draft max_seq_len"),
    }[case]
    if "draft_vocab" in kw or "draft_len" in kw:
        cfg = dict(DRAFT, vocab_size=kw.pop("draft_vocab", 97),
                   max_seq_len=kw.pop("draft_len", 128))
        jd, jdp, pd, pdp = _pair(cfg, 5)
    with pytest.raises(ValueError, match=match):
        ServeEngine(pm, pp, block_len=4, draft_model=pd, draft_params=pdp,
                    **kw)
    with pytest.raises(ValueError, match=match):
        JaxEngine(jm, jp, block_len=4, draft_model=jd, draft_params=jdp,
                  **kw)


# --------------------------------------------------------------------- #
# KV handoff                                                            #
# --------------------------------------------------------------------- #
# per-block payload at the affinity config, k + v in f32:
# 2 * L 2 * H 2 * block_len 8 * D 16 * 4 bytes = 4096; two blocks a wave
WAVE_BYTES = 2 * 4096
DESC_FIELDS = ("first", "pos", "keys", "block_len", "wave_cap", "bytes",
               "max_new_tokens")


def _handoff(engine_cls, model, params, prompt, n, get):
    pre = engine_cls(model, params, max_slots=2, block_len=8,
                     handoff_wave_bytes=WAVE_BYTES).start()
    dec = engine_cls(model, params, max_slots=2, block_len=8,
                     handoff_wave_bytes=WAVE_BYTES).start()
    try:
        desc = pre.submit_handoff(prompt, n).result(timeout=300)
        payloads = [get(ref) for _, ref in desc["waves"]]
        out = np.asarray(dec.submit_import(desc).result(timeout=300))
        pst = pre.stats()
        released = (pre.release_handoff(desc["handoff_id"]),
                    pre.release_handoff(desc["handoff_id"]))
    finally:
        pre.stop(cancel_active=True, timeout=10)
        dec.stop(cancel_active=True, timeout=10)
    return dict(desc=desc, payloads=payloads, out=out, pre=pst,
                released=released, pre_after=pre.stats(),
                dec=dec.stats())


@pytest.mark.parametrize("path", ["whole_prompt", "chunked_cursor"])
def test_kv_handoff_matches_jax_engines(affinity, monkeypatch, path):
    """A prefill engine exports a request's blocks in waves and a decode
    engine imports them: the tokens equal the JAX engines' run and
    generate(); the descriptor equals the JAX descriptor field by field,
    each wave's k / v the JAX payload; the hold releases once.  The
    chunked case streams the prompt through the cursor
    (RLA_TPU_SERVE_CHUNK_BLOCKS=2) before its export.

    Payload bound: rtol 1e-5 with atol 1e-6 for the whole prompt.  For the
    chunked prompt the atol is twice the JAX package's own spread between
    its chunked and its whole-prompt payloads of the same prompt (measured
    here, 1.55e-6 on an 8-core x86 CPU, where the port's chunked and
    whole-prompt payloads are bitwise equal and the port differs from the
    JAX payload by 1.91e-6), never below 1e-6: the prefill's f32 sums
    group differently chunk by chunk in XLA."""
    jm, jp, pm, pp = affinity
    rng = np.random.default_rng(3)
    if path == "chunked_cursor":
        monkeypatch.setenv("RLA_TPU_SERVE_CHUNK_BLOCKS", "2")
        prompt = rng.integers(1, 60, size=37).astype(np.int32)  # 5 blocks
    else:
        prompt = rng.integers(1, 60, size=17).astype(np.int32)  # 3 blocks
    n = 5
    j = _handoff(JaxEngine, jm, jp, prompt, n,
                 jax_object_store.global_store().get)
    t = _handoff(ServeEngine, pm, pp, prompt, n,
                 object_store.global_store().get)
    atol = 1e-6
    if path == "chunked_cursor":
        monkeypatch.delenv("RLA_TPU_SERVE_CHUNK_BLOCKS")
        whole = _handoff(JaxEngine, jm, jp, prompt, n,
                         jax_object_store.global_store().get)
        spread = max(float(np.max(np.abs(np.asarray(a[name])
                                         - np.asarray(b[name]))))
                     for a, b in zip(j["payloads"], whole["payloads"])
                     for name in ("k", "v"))
        atol = max(atol, 2 * spread)
    np.testing.assert_array_equal(t["out"], j["out"])
    np.testing.assert_array_equal(t["out"], _generate(pm, pp, prompt, n))
    for f in DESC_FIELDS:
        assert t["desc"][f] == j["desc"][f], f
    np.testing.assert_array_equal(t["desc"]["prompt"], prompt)
    assert [c for c, _ in t["desc"]["waves"]] == \
        [c for c, _ in j["desc"]["waves"]]
    assert len(t["desc"]["waves"]) >= 2  # more than one wave shipped
    for tp, jpay in zip(t["payloads"], j["payloads"]):
        assert tp["dtype"] == "float32"
        for name in ("k", "v"):
            np.testing.assert_allclose(tp[name], np.asarray(jpay[name]),
                                       rtol=1e-5, atol=atol)
    assert t["released"] == j["released"] == (True, False)
    for key in ("kv_handoffs", "kv_handoff_bytes", "completed",
                "prefill_chunks"):
        assert t["pre"][key] == j["pre"][key], key
    assert t["pre"]["kv_handoff_bytes"] == t["desc"]["bytes"]
    assert t["dec"]["completed"] == j["dec"]["completed"] == 1
    assert t["pre_after"]["block_pool_used"] == 0
    assert t["dec"]["block_pool_used"] == 0


def test_import_rejects_mismatched_block_geometry(affinity):
    _, _, pm, pp = affinity
    p = np.random.default_rng(7).integers(1, 60, size=17).astype(np.int32)
    pre = ServeEngine(pm, pp, max_slots=2, block_len=8).start()
    dec = ServeEngine(pm, pp, max_slots=2, block_len=16).start()
    try:
        desc = pre.submit_handoff(p, 3).result(timeout=300)
        with pytest.raises(RequestRejected, match="block_len"):
            dec.submit_import(desc)
        assert pre.release_handoff(desc["handoff_id"]) is True
    finally:
        pre.stop(cancel_active=True, timeout=10)
        dec.stop(cancel_active=True, timeout=10)
    assert pre.stats()["block_pool_used"] == 0


def test_release_handoff_races_release_exactly_once(affinity, monkeypatch):
    """``release_handoff`` from many threads at once (a short switch
    interval to interleave them): one call wins, the blocks and the
    reservation come back once, the payload's segments are gone."""
    import sys
    import threading
    _, _, pm, pp = affinity
    p = np.random.default_rng(19).integers(1, 60, size=25).astype(np.int32)
    store = object_store.global_store()
    monkeypatch.setattr(store, "threshold", 1)
    pre = ServeEngine(pm, pp, max_slots=2, block_len=8).start()
    interval = sys.getswitchinterval()
    try:
        descs = [pre.submit_handoff(p, 3).result(timeout=300)
                 for _ in range(3)]
        assert pre.stats()["block_pool_used"] > 0
        sys.setswitchinterval(1e-6)
        wins = []
        barrier = threading.Barrier(12)

        def release(hid):
            barrier.wait(timeout=30)
            wins.append((hid, pre.release_handoff(hid)))

        threads = [threading.Thread(target=release,
                                    args=(descs[i % 3]["handoff_id"],))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        pre.stop(cancel_active=True, timeout=10)
    for d in descs:
        assert sorted(w for h, w in wins if h == d["handoff_id"]) == \
            [False, False, False, True]
    assert pre.stats()["block_pool_used"] == 0
    assert pre.batcher._outstanding_blocks == 0
    assert store.total_shm_bytes() == 0


def test_handoff_deadline_passed_in_transit_is_shed(affinity):
    """The descriptor carries the absolute deadline: an import whose
    deadline passed in transit is shed typed before any decode, and the
    source hold still releases."""
    _, _, pm, pp = affinity
    p = np.random.default_rng(5).integers(1, 60, size=17).astype(np.int32)
    pre = ServeEngine(pm, pp, max_slots=2, block_len=8).start()
    dec = ServeEngine(pm, pp, max_slots=2, block_len=8,
                      slo=SloPolicy(ttft_target_s=5.0)).start()
    try:
        desc = pre.submit_handoff(p, 4).result(timeout=300)
        assert desc["t_submit"] is not None and desc["deadline"] is None
        desc = dict(desc, deadline=time.monotonic() - 0.5)
        resp = dec.submit_import(desc)
        with pytest.raises(DeadlineExceeded):
            resp.result(timeout=300)
        st = dec.stats()
        assert st["failed"] == 1 and st["slo_deadline_shed"] == 1
        assert st["steps"] == 0 and st["block_pool_used"] == 0
        assert pre.release_handoff(desc["handoff_id"]) is True
    finally:
        pre.stop(cancel_active=True, timeout=10)
        dec.stop(cancel_active=True, timeout=10)


def test_stale_ref_fails_only_that_import(affinity, monkeypatch):
    """A wave deleted before the import (its owner gone) fails that
    response with ObjectStoreError; the decode engine serves on.  (Every
    leaf rides shm here: these tiny waves would otherwise go inline.)"""
    _, _, pm, pp = affinity
    monkeypatch.setattr(object_store.global_store(), "threshold", 1)
    rng = np.random.default_rng(11)
    p = rng.integers(1, 60, size=17).astype(np.int32)
    q = rng.integers(1, 60, size=9).astype(np.int32)
    pre = ServeEngine(pm, pp, max_slots=2, block_len=8,
                      handoff_wave_bytes=WAVE_BYTES).start()
    dec = ServeEngine(pm, pp, max_slots=2, block_len=8).start()
    try:
        desc = pre.submit_handoff(p, 4).result(timeout=300)
        object_store.global_store().delete(desc["waves"][-1][1])
        with pytest.raises(object_store.ObjectStoreError,
                           match="does not exist"):
            dec.submit_import(desc).result(timeout=300)
        out = dec.submit(q, 4).result(timeout=300)
        np.testing.assert_array_equal(out, _generate(pm, pp, q, 4))
        st = dec.stats()
        assert st["failed"] == 1 and st["completed"] == 1
        assert st["block_pool_used"] == 0
        assert pre.release_handoff(desc["handoff_id"]) is True
    finally:
        pre.stop(cancel_active=True, timeout=10)
        dec.stop(cancel_active=True, timeout=10)


def test_bf16_pool_export_import_roundtrip_bitwise(monkeypatch):
    """A bf16 pool ships its raw 16-bit words through shm segments: the
    payload read back from the store is bitwise the source pool's
    blocks, the decode engine's pool holds the same bits after the
    import, and the tokens equal a normal bf16 engine's (the same bytes
    into the same computation)."""
    monkeypatch.setattr(object_store.global_store(), "threshold", 1)
    cfg = TransformerConfig(**AFFINITY)
    pm = GPT(cfg, device="cpu", compute_dtype=torch.bfloat16)
    pp = pm.init_params(seed=3)
    prompt = np.random.default_rng(13).integers(1, 60, 21).astype(np.int32)
    n = 6
    with ServeEngine(pm, pp, max_slots=2, block_len=8) as ref_eng:
        ref = ref_eng.submit(prompt, n).result(timeout=300)
    pre = ServeEngine(pm, pp, max_slots=2, block_len=8,
                      handoff_wave_bytes=WAVE_BYTES // 2).start()
    dec = ServeEngine(pm, pp, max_slots=2, block_len=8).start()
    try:
        desc = pre.submit_handoff(prompt, n).result(timeout=300)
        src = pre._handoffs[desc["handoff_id"]][1]
        store = object_store.global_store()
        shipped_k, shipped_v = [], []
        for count, ref_ in desc["waves"]:
            pay = store.get(ref_)
            assert pay["dtype"] == "bfloat16" and pay["k"].dtype == np.int16
            shipped_k.append(torch.from_numpy(pay["k"]))
            shipped_v.append(torch.from_numpy(pay["v"]))
        k16 = torch.cat(shipped_k, dim=1)
        v16 = torch.cat(shipped_v, dim=1)
        pool = pre._cache
        assert torch.equal(k16, pool["k"][:, src].view(torch.int16))
        assert torch.equal(v16, pool["v"][:, src].view(torch.int16))
        out = dec.submit_import(desc).result(timeout=300)
        np.testing.assert_array_equal(out, ref)
        # a fresh pool hands out blocks 1, 2, ... in order; the full
        # prompt blocks hold exactly the shipped bits (decode writes only
        # past the prompt)
        full = prompt.size // 8
        got = dec._cache["k"][:, 1:1 + full].view(torch.int16)
        assert torch.equal(got, k16[:, :full])
        assert pre.release_handoff(desc["handoff_id"]) is True
    finally:
        pre.stop(cancel_active=True, timeout=10)
        dec.stop(cancel_active=True, timeout=10)
    assert object_store.global_store().total_shm_bytes() == 0


# --------------------------------------------------------------------- #
# SLO engine                                                            #
# --------------------------------------------------------------------- #
SLO_ENV = ("RLA_TPU_SLO_TTFT_S", "RLA_TPU_SLO_TOKEN_CADENCE_S",
           "RLA_TPU_SLO_DEADLINE_S", "RLA_TPU_SLO_TARGET")


@pytest.mark.parametrize("values", [
    ("0.25", "0.05", "3", "0.95"),
    ("0.5", None, None, None),
    (None, None, "bad", "0.9"),   # a malformed value warns, default kept
    (None, None, None, "0.5"),    # a target alone enables nothing
])
def test_slo_policy_from_env_matches_jax(monkeypatch, values):
    for name, v in zip(SLO_ENV, values):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    got, want = SloPolicy.from_env(), JaxSloPolicy.from_env()
    assert (got is None) == (want is None)
    if got is not None:
        assert got.describe() == want.describe()


def test_expired_queued_request_shed_typed_with_reservation_returned(
        target):
    _, _, pm, pp = target
    eng = ServeEngine(pm, pp, max_slots=2, block_len=4,
                      slo=SloPolicy(deadline_s=0.05))
    p = np.asarray([1, 2, 3, 4, 5], np.int32)
    r = eng.submit(p, 4)              # queued on an unstarted engine
    assert eng.batcher._outstanding_blocks > 0
    assert r.request.deadline == pytest.approx(r.request.t_submit + 0.05)
    time.sleep(0.1)
    with eng:
        with pytest.raises(DeadlineExceeded, match="shed before prefill"):
            r.result(timeout=60)
        assert eng.batcher._outstanding_blocks == 0
        out = eng.submit(p, 4).result(timeout=300)   # served in time
    np.testing.assert_array_equal(out, _generate(pm, pp, p, 4))
    st = eng.stats()
    assert st["slo_deadline_shed"] == 1 and st["failed"] == 1
    assert st["completed"] == 1 and st["prefills"] == 1
    assert st["slo_families"]["deadline"] == {
        "observations": 2, "violations": 1, "violation_fraction": 0.5}
    assert st["slo_burn_rate"] == pytest.approx(0.5 / 0.01)


def test_slo_families_and_gauges_match_jax(target, monkeypatch):
    """With a policy the stats carry the JAX engine's slo_families keys
    and SLO gauges; ``slo="env"`` with no knob set attaches nothing."""
    jm, jp, pm, pp = target
    for name in SLO_ENV:
        monkeypatch.delenv(name, raising=False)
    p = np.asarray([3, 1, 4, 1, 5, 9], np.int32)
    outs, stats = [], []
    for cls, pol, m, prm in ((JaxEngine, JaxSloPolicy, jm, jp),
                             (ServeEngine, SloPolicy, pm, pp)):
        with cls(m, prm, max_slots=2, block_len=4,
                 slo=pol(ttft_target_s=60.0, token_cadence_target_s=60.0,
                         deadline_s=60.0)) as eng:
            outs.append(np.asarray(eng.submit(p, 5).result(timeout=300)))
        stats.append(eng.stats())
        plain = cls(m, prm, max_slots=1, block_len=4)
        assert plain.slo_policy is None
        assert "slo_families" not in plain.stats()
        assert "slo_burn_rate" not in plain.stats()
        plain.stop()
    np.testing.assert_array_equal(outs[0], outs[1])
    jst, st = stats
    assert set(st["slo_families"]) == set(jst["slo_families"])
    for fam, row in st["slo_families"].items():
        assert row == jst["slo_families"][fam], fam
    for key in ("slo_burn_rate", "slo_window_observations",
                "slo_violations", "slo_deadline_shed"):
        assert st[key] == jst[key], key


# --------------------------------------------------------------------- #
# perf_timeline                                                         #
# --------------------------------------------------------------------- #
class _Timeline:
    def __init__(self):
        self.phases = []

    def observe(self, phase, seconds):
        assert seconds >= 0.0
        self.phases.append(phase)


def test_perf_timeline_sees_the_jax_engines_phases(affinity, monkeypatch):
    """Both engines feed a recording timeline the same phase sequence on
    the same traffic: a whole-prompt request, then one streamed through
    three chunks."""
    jm, jp, pm, pp = affinity
    monkeypatch.setenv("RLA_TPU_SERVE_CHUNK_BLOCKS", "2")
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(1, 60, 9).astype(np.int32), 4),
            (rng.integers(1, 60, 40).astype(np.int32), 3)]
    seqs = []
    for cls, m, p in ((JaxEngine, jm, jp), (ServeEngine, pm, pp)):
        tl = _Timeline()
        with cls(m, p, max_slots=2, block_len=8, perf_timeline=tl) as eng:
            for prompt, n in reqs:   # one at a time: a fixed sequence
                eng.submit(prompt, n).result(timeout=300)
        seqs.append(tl.phases)
    assert seqs[1] == seqs[0]
    assert seqs[1] == ["prefill"] + ["decode"] * 3 + ["prefill"] * 3 \
        + ["decode"] * 2
