"""ray_tpu_torch's paged serving engine and block allocator against the JAX
package, on the CPU.

The allocator is pure Python in both packages: each scenario runs on both
and their snapshots must be equal. The engines serve TINY (GQA: 4 query
heads over 2 kv heads) at fp32 compute with the same weights, carried
across with `jax_bridge`; greedy tokens must be equal, request for
request. Every engine is shut down and its thread joined by the `engines`
fixture, every wait has its own timeout, and no assertion reads a clock.
The engine tests named in `test_tiny_moe_engines_match_jax` run again on
TINY_MOE (4 experts, top 2), whose MLPs route dropless in both packages.
"""
import dataclasses
import pathlib
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core import config as jax_config
from ray_tpu.models import configs as jax_configs
from ray_tpu.models import init_params as jax_init
from ray_tpu.serve.kv_cache import KVBlockAllocator as JaxAllocator
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu.serve.llm import PagedLLMEngine as JaxEngine
from ray_tpu_torch.core import config as torch_config
from ray_tpu_torch.models import configs
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models.jax_bridge import params_from_jax
from ray_tpu_torch.serve import llm as serve_llm
from ray_tpu_torch.serve import (
    KVBlockAllocator, LLMEngine, PagedLLMEngine, prefix_digest)

WAIT_S = 120
# The port's whole knob registry: the serving engines' knobs, `address`,
# and those the multi-process runtime reads, each one of JAX's.
KNOBS = ("address", "kv_block_size", "kv_block_count", "kv_block_prefix_sharing",
         "serve_prefill_chunk", "serve_stream_queue_max",
         "serve_speculation_k", "serve_speculation_ngram",
         # control plane and node daemon
         "gcs_storage", "gcs_fsync", "health_check_initial_delay_ms",
         "health_check_period_ms", "health_check_failure_threshold",
         "syncer_enabled", "syncer_report_interval_ms", "syncer_keepalive_ms",
         "syncer_broadcast_interval_ms", "syncer_heartbeat_fallback_factor",
         "heartbeat_backoff_cap_s", "scheduler_spread_threshold",
         "actor_schedule_concurrency", "actor_creation_timeout_s",
         "pg_prepare_ttl_s", "pg_prewarm_enabled",
         # worker pool and zygote
         "num_workers_soft_limit", "worker_lease_timeout_ms",
         "idle_worker_killing_time_threshold_ms", "worker_register_timeout_s",
         "zygote_enabled", "zygote_max", "zygote_preload",
         "zygote_boot_wait_s", "worker_prestart_enabled",
         "zygote_prestart_watermark", "zygote_warm_pool_cap",
         "task_lane_enabled", "task_lane_min_calls", "task_lane_max_inflight",
         "task_lane_idle_s",
         # objects and transfers
         "object_store_memory", "max_inline_object_size", "put_direct_min_bytes",
         "lineage_pinning_enabled", "max_lineage_bytes", "store_lib",
         "object_transfer_chunk_bytes", "transfer_window_bytes",
         "transfer_per_source_inflight", "transfer_chunk_timeout_s",
         "transfer_partial_ttl_s", "transfer_broadcast_fanout",
         "transfer_push_pipeline", "transfer_raw_frames",
         # observability and diagnosis
         "metrics_export_port", "metrics_gcs_export_port", "metrics_rpc_enabled",
         "metrics_loop_probe_ms", "metrics_sync_interval_ms",
         "task_events_enabled", "task_events_flush_ms", "task_events_max_buffer",
         "task_events_profile", "task_events_max_per_job",
         "task_events_finished_job_ttl_s", "task_events_resources",
         "task_events_device_mem", "tracing_enabled", "stack_dump_enabled",
         "hang_threshold_s", "hang_poll_interval_s", "hang_dump_max_bytes",
         "hang_dump_min_interval_s", "memory_monitor_refresh_ms",
         "memory_usage_threshold", "gcs_attribution_enabled",
         "gcs_slow_handler_ms", "gcs_loop_audit_ms",
         "gcs_flight_recorder_enabled", "gcs_flight_max_events",
         "log_dir", "log_to_driver",
         # the serve control plane, its channels and usage stats
         "serve_rails_enabled", "serve_rails_capacity_bytes",
         "serve_rails_max_streams", "serve_rails_tick_s", "serve_rails_probe_s",
         "serve_gauge_ttl_s", "serve_autoscale_stats_ttl_s", "serve_retry_max",
         "serve_retry_backoff_initial_s", "serve_retry_backoff_max_s",
         "serve_retry_backoff_multiplier", "serve_retry_backoff_jitter",
         "serve_drain_timeout_s", "serve_proxy_max_inflight",
         "serve_request_deadline_s", "serve_health_timeout_s",
         "serve_trace_enabled", "serve_metrics_push_s", "serve_disagg_enabled",
         "serve_disagg_prompt_threshold", "serve_disagg_prefill_actors",
         "serve_prefix_registry_enabled", "serve_prefix_registry_max_entries",
         "serve_kv_migrate_enabled", "serve_kv_migrate_inline_max_bytes",
         "serve_kv_migrate_linger_s", "serve_kv_migrate_ttl_s",
         "serve_startup_grace_s", "channel_backoff_us_min",
         "channel_backoff_us_max", "dag_teardown_timeout_s",
         "usage_stats_enabled", "usage_stats_url", "usage_stats_path",
         # durable workflows
         "workflow_storage",
         # the train plane: elastic restarts and train observability
         "elastic_replace_timeout_s", "elastic_backoff_initial_s",
         "elastic_backoff_max_s", "elastic_backoff_multiplier",
         "elastic_backoff_jitter", "elastic_grow_check_s",
         "train_obs_enabled", "train_obs_push_s", "train_obs_gauge_ttl_s",
         "train_obs_window_steps", "train_obs_trace_steps",
         "train_obs_peak_flops",
         # the data layer's streaming executor
         "data_stream_enabled", "data_stream_window_bytes",
         "data_stream_op_inflight_bytes", "data_stream_prefetch_depth",
         "data_stream_shuffle_fanout", "data_stream_spill_threshold",
         "data_stream_stall_timeout_s")


@pytest.fixture(scope="module")
def model(request):
    """TINY, or the config named by an indirect parameter."""
    name = getattr(request, "param", "tiny")
    jcfg = dataclasses.replace(jax_configs.get(name), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get(name), compute_dtype=torch.float32)
    jp = jax_init(jax.random.key(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture
def engines(model, monkeypatch):
    """make(kind, fixed=False, **kw) builds a JAX ("jax") or port
    ("torch") engine on TINY, paged or, with fixed=True, the fixed-slot
    LLMEngine; each is shut down and its thread joined at teardown.

    On the CPU backend `jnp.asarray` returns before it has read a numpy
    argument, and the JAX engine rewrites its block-table row right after
    handing it to the last prefill chunk (`_cow_tail`), so under load that
    chunk can scatter into the copy-on-write block. For the duration of
    the test, `jnp.asarray` reads a private copy instead, which makes the
    reference engine deterministic without changing what it computes.
    """
    jcfg, jp, tcfg, tp = model
    made = []
    asarray = jnp.asarray
    monkeypatch.setattr(jnp, "asarray", lambda a, *args, **kw: asarray(
        np.array(a) if isinstance(a, np.ndarray) else a, *args, **kw))

    def make(kind, fixed=False, **kw):
        if fixed:      # the fixed-slot LLMEngine
            kw = {"num_slots": 2, "max_len": 64, "prefill_buckets": (16, 32),
                  **kw}
            eng = (JaxLLMEngine(jcfg, jp, **kw) if kind == "jax"
                   else LLMEngine(tcfg, tp, device="cpu", **kw))
        else:
            kw = {"num_slots": 4, "max_len": 64, "block_size": 4,
                  "prefill_chunk": 8, **kw}
            eng = (JaxEngine(jcfg, jp, **kw) if kind == "jax"
                   else PagedLLMEngine(tcfg, tp, device="cpu", **kw))
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.shutdown()      # stops the loop and joins its thread
        eng._thread.join(timeout=WAIT_S)
    assert not any(eng._thread.is_alive() for eng in made)


def _both(engines, **kw):
    return engines("jax", **kw), engines("torch", **kw)


def _concurrently(eng, jobs):
    """Run generate(prompt, **kw) for each (prompt, kw) from its own
    thread; returns the outputs in job order."""
    out = [None] * len(jobs)

    def run(i, prompt, kw):
        out[i] = eng.generate(prompt, timeout=WAIT_S, **kw)

    threads = [threading.Thread(target=run, args=(i, p, kw))
               for i, (p, kw) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert all(o is not None for o in out), "a request failed"
    return out


# ---------------------------------------------------------------------------
# config knobs
# ---------------------------------------------------------------------------
def test_knobs_match_the_jax_registry(monkeypatch):
    port, ref = torch_config.Config(), jax_config.Config()
    assert len(set(KNOBS)) == len(KNOBS)
    assert {f.name for f in dataclasses.fields(port)} == set(KNOBS)
    for name in KNOBS:
        assert getattr(port, name) == getattr(ref, name), name
    # Every knob is read somewhere in the port besides its registry.
    root = pathlib.Path(torch_config.__file__).parents[1]
    sources = "\n".join(p.read_text() for p in root.rglob("*.py")
                        if p.name != "config.py" and "_build" not in p.parts)
    unread = [n for n in KNOBS if not re.search(rf"\b{n}\b", sources)]
    assert not unread, unread
    monkeypatch.setenv("RAY_TPU_KV_BLOCK_SIZE", "32")
    monkeypatch.setenv("RAY_TPU_KV_BLOCK_PREFIX_SHARING", "0")
    torch_config.reset_config()
    try:
        knobs = torch_config.get_config()
        assert knobs.kv_block_size == 32
        assert knobs.kv_block_prefix_sharing is False
    finally:
        torch_config.reset_config()   # re-read after monkeypatch restores


# ---------------------------------------------------------------------------
# allocator: the scenarios of tests/test_paged_kv.py on both packages
# ---------------------------------------------------------------------------
def _alloc_free_roundtrip(cls):
    a = cls(9, 4)
    blocks = a.alloc(5)
    assert blocks is not None and len(blocks) == 5 and 0 not in blocks
    assert a.snapshot()["blocks_active"] == 5
    assert a.alloc(4) is None
    a.free(blocks)
    return a


def _prefix_refcount_and_reuse(cls):
    a = cls(9, 4)
    prompt = list(range(1, 9))
    blocks = a.alloc(2)
    a.register_prefix(prompt, blocks, meta="logits")
    assert a.snapshot()["blocks_active"] == 2
    a.free(blocks)
    assert a.snapshot()["blocks_cached"] == 2
    got, covered, meta = a.lookup_prefix(prompt)
    assert got == blocks and covered == 8 and meta == "logits"
    got2, covered2, _ = a.lookup_prefix(prompt)
    assert got2 == blocks and covered2 == 8
    a.free(got)
    assert a.snapshot()["blocks_active"] == 2
    a.free(got2)
    return a


def _cow_shared_block_copies(cls):
    a = cls(9, 4)
    prompt = list(range(1, 7))
    blocks = a.alloc(2)
    a.register_prefix(prompt, blocks, meta="m")
    got, covered, meta = a.lookup_prefix(prompt)
    assert covered == 6 and meta == "m"
    new, copied = a.cow(got[-1])
    assert copied and new != got[-1]
    a.free(blocks)
    a.free(got[:-1] + [new])
    return a


def _cow_sole_owner_unregistered_in_place(cls):
    a = cls(9, 4)
    blocks = a.alloc(1)
    assert a.cow(blocks[0]) == (blocks[0], False)
    a.free(blocks)
    return a


def _cached_prefix_evicted_under_pressure(cls):
    a = cls(5, 4)
    prompt = list(range(1, 9))
    blocks = a.alloc(2)
    a.register_prefix(prompt, blocks)
    a.free(blocks)
    more = a.alloc(4)
    assert more is not None and len(more) == 4
    assert a.lookup_prefix(prompt)[:2] == ([], 0)
    a.free(more)
    return a


def _adopt_registers_and_parks(cls):
    a = cls(9, 4)
    toks = list(range(1, 11))              # 3 blocks, a partial tail
    blocks = a.adopt(toks, meta="m")
    assert len(blocks) == 3 and a.snapshot()["blocks_active"] == 3
    a.free(blocks)
    assert a.snapshot()["blocks_cached"] == 3
    got, covered, meta = a.lookup_prefix(toks)
    assert got == blocks and covered == 10 and meta == "m"
    a.free(got)
    assert a.adopt([]) is None
    assert a.adopt(list(range(40))) is None          # more than the pool
    assert cls(9, 4, prefix_sharing=False).adopt(toks) is None
    return a


def _unregister_block_drops_its_key(cls):
    a = cls(9, 4)
    toks = list(range(1, 9))
    blocks = a.alloc(2)
    a.register_prefix(toks, blocks, meta="m")
    a.unregister_block(blocks[1])
    a.free(blocks)                 # blocks[0] parks cached, [1] goes free
    got, covered, meta = a.lookup_prefix(toks)
    assert got == blocks[:1] and covered == 4 and meta is None
    a.free(got)
    return a


@pytest.mark.parametrize("scenario", [
    _alloc_free_roundtrip, _prefix_refcount_and_reuse,
    _cow_shared_block_copies, _cow_sole_owner_unregistered_in_place,
    _cached_prefix_evicted_under_pressure, _adopt_registers_and_parks,
    _unregister_block_drops_its_key], ids=lambda f: f.__name__[1:])
def test_allocator_scenario_snapshots_match_jax(scenario):
    port, ref = scenario(KVBlockAllocator), scenario(JaxAllocator)
    assert port.snapshot() == ref.snapshot()
    assert port.prefix_digests() == ref.prefix_digests()


def test_prefix_digest_matches_jax():
    from ray_tpu.serve.kv_cache import prefix_digest as jax_digest

    toks = list(range(-3, 40))
    assert prefix_digest(toks) == jax_digest(toks)


def test_unported_options_raise(model, tmp_path):
    """The store arena (`store=`) runs as the JAX package's does: the pool's
    bytes are one object in the node's store, its size the JAX engine's,
    and releasing it (allocator `release`, engine `shutdown`) returns the
    store to its baseline. The paged engine takes no mesh, as the JAX
    package's takes none (`LLMEngine(mesh=...)` serves tensor-parallel:
    tests/test_torch_{world_one,distributed}.py)."""
    from ray_tpu.core.object_store import ObjectStore as JaxStore
    from ray_tpu_torch.core.object_store import ObjectStore

    jcfg, jp, tcfg, tp = model
    stores = {}
    try:
        for kind, cls in (("jax", JaxStore), ("torch", ObjectStore)):
            stores[kind] = cls(str(tmp_path / kind),
                               capacity=32 * 1024 * 1024, num_slots=64)
        arena = {}
        for kind, alloc_cls, eng_cls, cfg, params, kw in (
                ("jax", JaxAllocator, JaxEngine, jcfg, jp, {}),
                ("torch", KVBlockAllocator, PagedLLMEngine, tcfg, tp,
                 {"device": "cpu"})):
            store = stores[kind]
            base = (store.used, store.num_objects)
            a = alloc_cls(17, 4, store=store, bytes_per_block=1024)
            assert a.arena_bytes == 17 * 1024 and store.used > base[0]
            a.free(a.alloc(8))
            a.release()
            assert (store.used, store.num_objects) == base
            eng = eng_cls(cfg, params, num_slots=2, max_len=64, block_size=4,
                          store=store, **kw)
            try:
                assert store.num_objects == base[1] + 1
                arena[kind] = eng.allocator.arena_bytes
                assert eng.generate([1, 2, 3, 4, 5], max_tokens=4,
                                    timeout=WAIT_S) is not None
            finally:
                eng.shutdown()
            assert (store.used, store.num_objects) == base
        assert arena["torch"] == arena["jax"] > 0
        assert KVBlockAllocator(9, 4, store=stores["torch"]).arena_bytes == 0
    finally:
        for kind, store in stores.items():
            store.disconnect()
            (JaxStore if kind == "jax" else ObjectStore).destroy(
                str(tmp_path / kind))
    with pytest.raises(TypeError, match="mesh"):
        JaxEngine(jcfg, jp, mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        PagedLLMEngine(tcfg, tp, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# engine: greedy tokens equal the JAX engine's
# ---------------------------------------------------------------------------
def test_concurrent_requests_match_jax(engines):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).tolist() for n in (5, 11, 17, 26)]
    jobs = [(p, {"max_tokens": 12}) for p in prompts]
    # A sampled request shares the bursts; only its length is checked.
    sampled = (prompts[1], {"max_tokens": 9, "temperature": 0.8})
    jeng, teng = _both(engines)
    want = _concurrently(jeng, jobs)
    got = _concurrently(teng, jobs + [sampled])
    assert got[:-1] == want
    assert len(got[-1]) == 9
    assert teng.stats["completed"] == 5
    assert teng.allocator.snapshot()["blocks_active"] == 0


def test_prefix_sharing_cow_and_divergent_continuation_match_jax(engines):
    prompt = list(range(1, 11))          # partial tail block at bs 4
    divergent = prompt[:8] + [99, 98]
    outs, snaps = {}, {}
    for kind in ("jax", "torch"):
        ref = engines(kind, prefix_sharing=False)
        eng = engines(kind, prefix_sharing=True)
        outs[kind] = [ref.generate(prompt, max_tokens=6, timeout=WAIT_S),
                      ref.generate(divergent, max_tokens=6, timeout=WAIT_S)]
        first = eng.generate(prompt, max_tokens=6, timeout=WAIT_S)
        second = eng.generate(prompt, max_tokens=6, timeout=WAIT_S)
        div = eng.generate(divergent, max_tokens=6, timeout=WAIT_S)
        third = eng.generate(prompt, max_tokens=6, timeout=WAIT_S)
        assert first == second == third == outs[kind][0]
        assert div == outs[kind][1]
        snaps[kind] = eng.allocator.snapshot()
        outs[kind] += [first, div]
    assert outs["torch"] == outs["jax"]
    assert snaps["torch"]["reuse_hits"] > 0
    assert snaps["torch"]["cow_copies"] >= 1
    assert snaps["torch"] == snaps["jax"]


def test_small_pool_waits_and_preempts_like_jax(engines):
    # Waits: one 16-token prompt plus a burst of headroom takes all 6
    # usable blocks, so the second request queues until the first ends.
    wait_jobs = [(list(range(1, 17)), {"max_tokens": 8}),
                 (list(range(101, 117)), {"max_tokens": 8})]
    # Preemption: both requests fit at admission, but their growth needs
    # 12 of the 8 usable blocks, so the younger is preempted and its KV
    # recomputed.
    pre_jobs = [(list(range(1, 9)), {"max_tokens": 16}),
                (list(range(101, 109)), {"max_tokens": 16})]
    pre_kw = dict(num_slots=2, max_len=32, block_size=4, prefill_chunk=16,
                  max_burst=4, prefix_sharing=False)
    for kind in ("jax", "torch"):
        waiter = engines(kind, num_slots=2, max_len=32, num_blocks=7,
                         prefix_sharing=False)
        small = engines(kind, num_blocks=9, **pre_kw)
        roomy = engines(kind, num_blocks=33, **pre_kw)
        got = (_concurrently(waiter, wait_jobs), _concurrently(small, pre_jobs),
               [roomy.generate(p, timeout=WAIT_S, **kw) for p, kw in pre_jobs])
        assert waiter.stats["queue_waits"] >= 1
        assert small.stats["preemptions"] >= 1
        assert got[1] == got[2]          # recompute changes nothing
        for eng in (waiter, small):
            assert eng.allocator.snapshot()["blocks_active"] == 0
        if kind == "jax":
            want = got
    assert got == want


def test_prompt_longer_than_a_chunk_prefills_in_chunks_like_jax(engines):
    prompt = np.random.default_rng(1).integers(1, 512, 30).tolist()
    out = {}
    for kind in ("jax", "torch"):
        eng = engines(kind)
        out[kind] = eng.generate(prompt, max_tokens=10, timeout=WAIT_S)
        assert eng.stats["prefill_chunks"] == 4      # 8 + 8 + 8 + 6
    assert out["torch"] == out["jax"]


def test_stream_and_resume_give_the_generated_tokens(engines):
    eng = engines("torch", prefix_sharing=False)
    prompt = list(range(3, 15))
    full = eng.generate(prompt, max_tokens=10, timeout=WAIT_S)
    assert list(eng.generate_stream(prompt, max_tokens=10,
                                    timeout=WAIT_S)) == full
    assert eng.generate(prompt, max_tokens=10, resume_tokens=full[:4],
                        timeout=WAIT_S) == full[4:]
    assert eng.generate(prompt, max_tokens=4, resume_tokens=full[:4],
                        timeout=WAIT_S) == []
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(list(range(70)), timeout=WAIT_S)
    stats = eng.engine_stats()
    assert stats["completed"] == 3 and stats["active"] == 0
    assert eng.gauges()["occupancy"] == 0.0


def test_failed_prefill_wakes_the_request_queued_behind_it(engines):
    # One slot. The first request's second prefill chunk raises while a
    # second request waits for the slot; the failure must free the slot
    # and wake the loop, or the second request waits for a wake-up that
    # nothing sends.
    eng = engines("torch", num_slots=1, prefix_sharing=False)
    real_chunk, real_put = eng._prefill_chunk_fn, eng._pending_put
    calls, puts, both_queued = [], [], threading.Event()

    def counting_put(req):
        real_put(req)
        puts.append(req)
        if len(puts) == 2:
            both_queued.set()

    def flaky_chunk(*args):
        calls.append(len(calls))
        if len(calls) == 1:
            # Hold the first chunk until the second request is queued.
            assert both_queued.wait(WAIT_S)
        elif len(calls) == 2:
            raise RuntimeError("planted prefill fault")
        return real_chunk(*args)

    eng._pending_put = counting_put
    eng._prefill_chunk_fn = flaky_chunk
    failing, waiting = list(range(1, 13)), list(range(40, 50))
    errors, out = [], []

    def run_failing():
        try:
            eng.generate(failing, max_tokens=4, timeout=WAIT_S)
        except RuntimeError as e:
            errors.append(e)

    first = threading.Thread(target=run_failing)
    first.start()
    for _ in range(WAIT_S * 100):    # the first request is queued first
        if puts or not first.is_alive():
            break
        first.join(timeout=0.01)
    second = threading.Thread(target=lambda: out.append(
        eng.generate(waiting, max_tokens=4, timeout=WAIT_S)))
    second.start()
    for t in (first, second):
        t.join(timeout=WAIT_S)
    assert not first.is_alive() and not second.is_alive()
    assert [str(e) for e in errors] == ["planted prefill fault"]
    assert out == [eng.generate(waiting, max_tokens=4, timeout=WAIT_S)]
    assert eng.allocator.snapshot()["blocks_active"] == 0


# ---------------------------------------------------------------------------
# speculative decoding on the paged pool
# ---------------------------------------------------------------------------
SPEC_PROMPT = [1, 2, 3, 1, 2, 3, 1, 2]


def test_paged_speculation_is_exact_and_matches_jax(engines):
    """Greedy tokens with prompt-lookup speculation are bit-identical to
    the same engine without it, and equal the JAX speculative engine's,
    request for request, with the same drafts proposed and accepted. A
    sampled request falls back per slot. Small bursts make the drafter
    check often; the greedy continuation settles into a loop that the
    n-gram lookup mines (as tests/test_paged_kv.py relies on)."""
    kw = dict(max_len=256, max_burst=2, prefix_sharing=False)
    plain = engines("torch", **kw).generate(SPEC_PROMPT, max_tokens=96,
                                            timeout=WAIT_S)
    stats = {}
    for kind in ("jax", "torch"):
        eng = engines(kind, speculation_k=4, **kw)
        out = eng.generate(SPEC_PROMPT, max_tokens=96, timeout=WAIT_S)
        assert out == plain
        stats[kind] = {k: eng.stats[k]
                       for k in ("spec_proposed", "spec_accepted")}
        sampled = eng.generate(SPEC_PROMPT, max_tokens=6, temperature=0.8,
                               timeout=WAIT_S)
        assert len(sampled) == 6
    assert stats["torch"] == stats["jax"]
    assert 0 < stats["torch"]["spec_accepted"] <= stats["torch"]["spec_proposed"]


def test_paged_speculation_window_longer_than_the_burst(engines):
    """speculation_k 8 over bursts of 2: the tables must grow by the
    verify window, not the burst, or the window scatters past them."""
    kw = dict(max_len=128, max_burst=2, prefix_sharing=False)
    plain = engines("torch", **kw)
    spec = engines("torch", speculation_k=8, **kw)
    assert (spec.generate(SPEC_PROMPT, max_tokens=80, timeout=WAIT_S)
            == plain.generate(SPEC_PROMPT, max_tokens=80, timeout=WAIT_S))
    assert spec.stats["spec_accepted"] > 0
    assert spec.allocator.snapshot()["blocks_active"] == 0


def test_paged_speculation_rejected_drafts_keep_a_shared_prefix(engines):
    """Speculation over a registered prefix writes (rejected drafts too)
    into the copy-on-write copy of its tail only: repeated and divergent
    prompts all give the unshared, non-speculative tokens."""
    prompt = [1, 2, 3, 1, 2, 3]            # partial tail block at bs 4
    divergent = prompt[:4] + [9, 9]
    kw = dict(max_len=256, max_burst=2)
    ref = engines("torch", prefix_sharing=False, **kw)
    want = [ref.generate(prompt, max_tokens=64, timeout=WAIT_S),
            ref.generate(divergent, max_tokens=8, timeout=WAIT_S)]
    eng = engines("torch", prefix_sharing=True, speculation_k=4, **kw)
    first = eng.generate(prompt, max_tokens=64, timeout=WAIT_S)
    second = eng.generate(prompt, max_tokens=64, timeout=WAIT_S)
    assert eng.allocator.snapshot()["cow_copies"] >= 1
    div = eng.generate(divergent, max_tokens=8, timeout=WAIT_S)
    third = eng.generate(prompt, max_tokens=64, timeout=WAIT_S)
    assert [first, div] == want and second == third == first
    assert eng.stats["spec_accepted"] > 0


# ---------------------------------------------------------------------------
# KV import / export (disaggregated prefill, live migration)
# ---------------------------------------------------------------------------
def test_import_prefix_rejects_bad_geometry_like_jax(engines):
    L, H, D = configs.TINY.n_layers, configs.TINY.n_kv_heads, \
        configs.TINY.head_dim
    toks = list(range(1, 9))               # 2 blocks of 4
    frames = [(np.zeros((2, L, 2, 4, H, D), np.float32), 8),  # block size
              (np.zeros((2, L + 1, 2, 4, H, D), np.float32), 4),
              (np.zeros((2, L, 1, 4, H, D), np.float32), 4),  # too few
              (np.zeros((L, 2, 4, H, D), np.float32), 4),     # ndim 5
              (np.zeros((3, L, 2, 4, H, D), np.float32), 4),  # not k/v
              (np.zeros((2, L, 2, 4, H, D + 1), np.float32), 4),
              (np.ones((2, L, 3, 4, H, D), np.float32), 4)]   # imports
    got = {kind: [engines(kind).import_prefix(toks, kv, bs)
                  for kv, bs in frames] for kind in ("jax", "torch")}
    assert got["torch"] == got["jax"] == [0, 0, 0, 0, 0, 0, 2]
    off = engines("torch", prefix_sharing=False)
    assert off.import_prefix(toks, frames[-1][0], 4) == 0


def test_export_import_resume_continues_a_greedy_stream(engines):
    """Engine A streams a greedy request and stops after its first burst
    (its loop ends there: no sleep decides where the cut falls). Its
    ticket goes into engine B, whose resume of prompt + the tokens the
    client saw prefix-hits the imported blocks and continues exactly as
    an uninterrupted engine does."""
    prompt = list(range(3, 15))            # 12 tokens, 3 blocks of 4
    full = engines("torch", prefix_sharing=False).generate(
        prompt, max_tokens=20, timeout=WAIT_S)
    a, b = engines("torch"), engines("torch")
    real_burst = a._decode

    def last_burst(*args, **kw):
        a._stop = True                     # the loop ends after this tick
        return real_burst(*args, **kw)

    a._decode = last_burst
    stream = a.generate_stream(prompt, max_tokens=20, timeout=WAIT_S,
                               trace={"trace_id": "rid-7", "span_id": None})
    seen = [next(stream) for _ in range(5)]
    a._thread.join(timeout=WAIT_S)
    assert not a._thread.is_alive()
    tickets = a.export_streams()
    stream.close()
    assert [t["request_id"] for t in tickets] == ["rid-7"]
    ticket = tickets[0]
    # First token from the prefill, 8 from the burst; the last one's KV is
    # the next step's input, so 20 positions (5 blocks) travel.
    assert ticket["tokens"] == prompt + full[:8]
    assert ticket["kv"].shape == (2, configs.TINY.n_layers, 5, 4,
                                  configs.TINY.n_kv_heads,
                                  configs.TINY.head_dim)
    assert b.import_prefix(ticket["tokens"], ticket["kv"],
                           ticket["block_size"]) == 5
    blocks, covered, _ = b.allocator.lookup_prefix(ticket["tokens"])
    assert covered == 20
    assert np.array_equal(tdec.gather_blocks(b.cache, blocks).numpy(),
                          ticket["kv"])
    b.allocator.free(blocks)
    cont = list(b.generate_stream(prompt, max_tokens=20, resume_tokens=seen,
                                  timeout=WAIT_S))
    assert seen + cont == full
    # 17 context tokens: 16 from the imported chain, one prefilled.
    assert b.stats["prefix_hits"] == 1 and b.stats["prefill_chunks"] == 1


def test_requests_carry_a_trace_context():
    """A request without a caller context mints its own, as the JAX
    engine's serve tracing does by default; a given one is kept."""
    req = serve_llm._Request([1], 1, 0.0)
    assert set(req.trace) == {"trace_id", "span_id"}
    assert len(req.trace["trace_id"]) == 32 and req.trace["span_id"] is None
    assert serve_llm._Request([1], 1, 0.0).trace != req.trace
    given = {"trace_id": "abc", "span_id": "s1", "app": "x"}
    assert serve_llm._Request([1], 1, 0.0, trace=given).trace is given


# ---------------------------------------------------------------------------
# the fixed-slot LLMEngine
# ---------------------------------------------------------------------------
def test_llm_engine_single_and_concurrent_match_jax(engines):
    """One request, then five concurrent ones over two slots (continuous
    batching), on both packages: equal greedy tokens."""
    jobs = [([i + 1, i + 2], {"max_tokens": 4}) for i in range(5)]
    out = {}
    for kind in ("jax", "torch"):
        eng = engines(kind, fixed=True)
        out[kind] = ([eng.generate([1, 2, 3], max_tokens=5, timeout=WAIT_S)]
                     + _concurrently(eng, jobs))
        stats = eng.engine_stats()
        assert stats["completed"] == 6 and stats["p_ttft_mean"] > 0
    assert out["torch"] == out["jax"]
    assert [len(o) for o in out["torch"]] == [5, 4, 4, 4, 4, 4]


def test_llm_engine_prefix_cache_matches_jax(engines):
    """A repeated prompt hits the whole-prompt cache (no prefill) and
    gives the same tokens; the LRU holds two entries. Statistics, cache
    keys and tokens equal the JAX engine's."""
    out, stats, keys = {}, {}, {}
    for kind in ("jax", "torch"):
        eng = engines(kind, fixed=True, prefill_buckets=(16,),
                      prefix_cache_size=2)
        first = eng.generate([5, 6, 7, 8], max_tokens=6, timeout=WAIT_S)
        second = eng.generate([5, 6, 7, 8], max_tokens=6, timeout=WAIT_S)
        assert second == first and eng.stats["prefix_hits"] == 1
        other = eng.generate([9, 10], max_tokens=4, timeout=WAIT_S)
        eng.generate([11, 12, 13], max_tokens=2, timeout=WAIT_S)
        keys[kind] = list(eng._prefix_cache)
        again = eng.generate([9, 10], max_tokens=4, timeout=WAIT_S)
        assert again == other
        out[kind] = [first, other]
        stats[kind] = (eng.stats["prefix_hits"], eng.stats["prefix_misses"])
    assert out["torch"] == out["jax"]
    assert stats["torch"] == stats["jax"] == (2, 3)
    assert keys["torch"] == keys["jax"] == [(9, 10), (11, 12, 13)]
    off = engines("torch", fixed=True, prefix_cache_size=0)
    assert off.generate([1, 2, 3], max_tokens=4, timeout=WAIT_S) == \
        off.generate([1, 2, 3], max_tokens=4, timeout=WAIT_S)
    assert off.stats["prefix_hits"] == 0


def test_llm_engine_speculation_is_exact_and_matches_jax(engines):
    kw = dict(max_len=256, prefill_buckets=(16,), prefix_cache_size=0,
              max_burst=2)
    plain = engines("torch", fixed=True, **kw).generate(
        SPEC_PROMPT, max_tokens=96, timeout=WAIT_S)
    stats = {}
    for kind in ("jax", "torch"):
        eng = engines(kind, fixed=True, speculation_k=4, **kw)
        assert eng.generate(SPEC_PROMPT, max_tokens=96,
                            timeout=WAIT_S) == plain
        stats[kind] = (eng.stats["spec_proposed"], eng.stats["spec_accepted"])
        sampled = eng.generate(SPEC_PROMPT, max_tokens=6, temperature=0.8,
                               timeout=WAIT_S)
        assert len(sampled) == 6
    assert stats["torch"] == stats["jax"]
    assert 0 < stats["torch"][1] <= stats["torch"][0]


def test_llm_engine_stream_resume_and_failures(engines):
    """Streaming gives the generated tokens, resume the rest; a device
    call that raises fails its requests, frees their slots and leaves the
    engine serving."""
    eng = engines("torch", fixed=True)
    full = eng.generate([4, 5, 6, 7], max_tokens=9, timeout=WAIT_S)
    assert list(eng.generate_stream([4, 5, 6, 7], max_tokens=9,
                                    timeout=WAIT_S)) == full
    assert eng.generate([4, 5, 6, 7], max_tokens=9, resume_tokens=full[:3],
                        timeout=WAIT_S) == full[3:]
    real = eng._decode
    eng._decode = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("planted decode fault"))
    with pytest.raises(RuntimeError, match="planted decode fault"):
        eng.generate([4, 5, 6, 7], max_tokens=9, timeout=WAIT_S)
    eng._decode = real
    assert eng._slots == [None, None]
    assert eng.generate([4, 5, 6, 7], max_tokens=9, timeout=WAIT_S) == full


# ---------------------------------------------------------------------------
# MoE: the engines on TINY_MOE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["tiny-moe"], indirect=True)
@pytest.mark.parametrize("case", [
    test_concurrent_requests_match_jax,
    test_prompt_longer_than_a_chunk_prefills_in_chunks_like_jax,
    test_paged_speculation_is_exact_and_matches_jax,
    test_llm_engine_single_and_concurrent_match_jax,
    test_llm_engine_speculation_is_exact_and_matches_jax,
], ids=lambda case: case.__name__[len("test_"):])
def test_tiny_moe_engines_match_jax(model, engines, case):
    """Each engine test above on TINY_MOE: greedy tokens (and accepted
    drafts) equal the JAX engines'."""
    assert model[2].n_experts == 4
    case(engines)
