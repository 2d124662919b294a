"""The knobs of the port (counterpart of `ray_tpu/core/config.py`).

Same names, defaults and environment variables as the JAX package: each
knob can be overridden with `RAY_TPU_<NAME>`, parsed to the declared type.
Only the knobs the port reads are here: those of the multi-process runtime
(control plane, node daemon, zygote, object store and transfer, tracing and
diagnosis), the cluster address `init` joins, the serving engines', the
train plane's (elastic restarts, train observability) and the data layer's
(the streaming executor).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # Storage backend for control-plane state: "memory" (default, like the
    # reference's gcs_storage="memory") or a file path for persistence.
    gcs_storage: str = "memory"
    # Health-check cadence (ref: ray_config_def.h:841-843 — 5s initial delay,
    # 3s period, failure threshold).
    health_check_initial_delay_ms: int = 5000
    health_check_period_ms: int = 3000
    health_check_failure_threshold: int = 5

    # ---- cluster-state syncer (syncer.py; ref: ray_syncer.proto:62 —
    # versioned delta sync replaces full-state heartbeats) ----
    # Delta sync on/off (off => legacy full-state heartbeats + 1 Hz
    # list_nodes view polls).
    syncer_enabled: bool = True
    # Coalescing window between delta pushes: local changes batch into at
    # most one wire message per interval.
    syncer_report_interval_ms: int = 100
    # Idle nodes piggyback liveness on the sync channel with a tiny
    # keepalive at this cadence (must undercut health_check_period_ms *
    # health_check_failure_threshold or idle nodes get marked dead).
    syncer_keepalive_ms: int = 2000
    # GCS fan-out coalescing: node changes batch into at most one
    # cluster-view broadcast per interval.
    syncer_broadcast_interval_ms: int = 200
    # While the sync channel is healthy the legacy heartbeat degrades to
    # a slow fallback: its period is multiplied by this factor.
    syncer_heartbeat_fallback_factor: float = 5.0
    # Cap for the heartbeat/syncer retry backoff when the GCS is down.
    heartbeat_backoff_cap_s: float = 8.0

    # ---- node daemon / scheduling ----
    # Hybrid scheduling policy threshold: prefer the local node until its
    # critical resource utilization crosses this fraction, then spill to the
    # top-k least-utilized nodes (ref: policy/hybrid_scheduling_policy.h:26-49).
    scheduler_spread_threshold: float = 0.5
    # Worker pool
    num_workers_soft_limit: int = 0  # 0 => num_cpus
    worker_lease_timeout_ms: int = 30000
    idle_worker_killing_time_threshold_ms: int = 1000
    worker_register_timeout_s: int = 30

    # ---- worker zygote / prestart (ref: worker_pool.h:347
    # PrestartWorkers + idle pool; worker_zygote.py here) ----
    # Fork workers from a pre-imported zygote template instead of cold
    # subprocess spawns (RAY_TPU_ZYGOTE_ENABLED=0 to disable; containers
    # and foreign-python runtime envs always cold-spawn).
    zygote_enabled: bool = True
    # Distinct per-runtime-env-key zygotes kept alive (LRU beyond this).
    zygote_max: int = 4
    # Extra comma-separated modules the zygote pre-imports (must be
    # fork-safe: no import-time threads/sockets).
    zygote_preload: str = ""
    # How long a spawn awaits a booting zygote's socket, without
    # blocking the daemon's loop, before it cold-spawns; the zygote is
    # kept and serves later spawns once it listens.
    zygote_boot_wait_s: float = 5.0
    # Backlog-driven prestart: when >= watermark default-env lease
    # requests are queued, warm workers are started ahead of grants, up
    # to the warm-pool cap (0 => num_workers_soft_limit).
    worker_prestart_enabled: bool = True
    zygote_prestart_watermark: int = 1
    zygote_warm_pool_cap: int = 0
    # GCS-side actor creations in flight at once (ref:
    # gcs_actor_scheduler.h leases many actors concurrently): a serial
    # loop caps creation at 1/start_actor-latency; the bound keeps a
    # burst from flooding daemons with more concurrent fork+boot
    # pipelines than hosts can absorb.
    actor_schedule_concurrency: int = 8
    # Object transfer chunk size over DCN (ref: ray_config_def.h:352 — 5 MiB).
    object_transfer_chunk_bytes: int = 5 * 1024 * 1024

    # ---- object transfer plane (transfer.py; RAY_TPU_TRANSFER_*) ----
    # Per-pull in-flight chunk budget in BYTES (not chunks): the window
    # striped across all replica sources. Also the receiver's heap
    # high-water bound — chunks land direct-to-shm, only in-flight
    # frames live on the Python heap.
    transfer_window_bytes: int = 64 * 1024 * 1024
    # Concurrent chunk fetches pipelined per source within the window.
    transfer_per_source_inflight: int = 2
    # Per-chunk RPC deadline; also how long a relay serve waits for a
    # not-yet-landed range of an in-flight broadcast object.
    transfer_chunk_timeout_s: float = 30.0
    # Abandoned receive partials (pusher/parent died mid-transfer) are
    # aborted after this long, freeing their store reservation.
    transfer_partial_ttl_s: float = 300.0
    # Relay-tree fan-out for 1->N broadcast pre-staging: each node
    # serves at most this many children, so the owner's uplink carries
    # fanout*size instead of N*size.
    transfer_broadcast_fanout: int = 2
    # Chunk RPCs a push/relay keeps in flight toward one peer.
    transfer_push_pipeline: int = 4
    # Kill switch: serve chunk payloads as raw frames (zero-copy);
    # 0 falls back to the legacy bytes-through-pickle path.
    transfer_raw_frames: bool = True

    # ---- streaming data plane (data/streaming; RAY_TPU_DATA_STREAM_*) ----
    # Default Dataset execution path: streaming operator graph with a
    # bytes-windowed backpressure budget. 0 falls back to the legacy
    # block-materializing executor in data/execution.py.
    data_stream_enabled: bool = True
    # Total bytes of operator output the whole pipeline may hold
    # un-consumed before upstream submission stalls (the global window).
    data_stream_window_bytes: int = 128 * 1024 * 1024
    # Per-operator cap on output bytes in flight (produced but not yet
    # consumed downstream); an operator at its cap stalls — the stall
    # seconds are accounted per operator in Dataset.stats().
    data_stream_op_inflight_bytes: int = 64 * 1024 * 1024
    # Device-prefetch depth for iter_device_batches: batches resident
    # on the card ahead of compute (double buffering at 2).
    data_stream_prefetch_depth: int = 2
    # Relay-tree fan-out for streaming all-to-all shuffle pre-staging;
    # 0 inherits transfer_broadcast_fanout.
    data_stream_shuffle_fanout: int = 0
    # Store used/capacity fraction above which the backpressure budget
    # shrinks and over-budget submissions spill to disk-backed store
    # space instead of stalling forever.
    data_stream_spill_threshold: float = 0.8
    # A byte-stalled operator raises BackpressureTimeout after this
    # long with no forward progress anywhere in the pipeline.
    data_stream_stall_timeout_s: float = 120.0

    # ---- task lanes (the task path's pinned leases) ----
    # Pre-leased task lanes: after `task_lane_min_calls` submissions of
    # the same (function, resources, runtime-env) signature the lease is
    # kept warm and pinned, and subsequent calls ride compact raw-frame
    # deltas straight into the pinned worker's executor queue
    # (RAY_TPU_TASK_LANE_ENABLED=0 restores per-call leasing).
    task_lane_enabled: bool = True
    task_lane_min_calls: int = 3
    # Calls in flight on one pinned lane before new submissions spill
    # back to the normal lease/scheduler path (backpressure bound).
    # Kept small on purpose: a lane pipelines the low-concurrency
    # submit+wait pattern, while a large burst should fan out across
    # the worker pool instead of serializing behind one pinned worker.
    task_lane_max_inflight: int = 8
    # Idle pinned lanes release their worker after this long so the
    # pool can reap it (mirrors idle_worker_killing_time_threshold_ms).
    task_lane_idle_s: float = 2.0

    # ---- object store ----
    # Per-node shared-memory store capacity. 0 => 30% of system RAM
    # (matches the reference's default plasma sizing).
    object_store_memory: int = 0
    # Inline small objects in task replies instead of the shm store
    # (ref: max_direct_call_object_size, 100 KiB).
    max_inline_object_size: int = 100 * 1024
    # Large-put direct-write fast path: puts of at least this many bytes
    # land in the store file via write() (kernel page-cache copy — no
    # per-page fault + zero-fill like the mmap path pays, ~3x on tmpfs)
    # and their deleted files park in the native store's bounded
    # warm-file recycle pool for the next large create. 0 disables the
    # fast path (always mmap+copy).
    put_direct_min_bytes: int = 1024 * 1024

    # ---- ownership / lineage ----
    # Keep lineage for reconstruction while refs exist
    # (ref: ray_config_def.h:145 lineage_pinning_enabled, 1 GiB cap :158).
    lineage_pinning_enabled: bool = True
    max_lineage_bytes: int = 1024 * 1024 * 1024

    # ---- observability ----
    # Prometheus text endpoint on each node daemon (0 = disabled);
    # RAY_TPU_METRICS_EXPORT_PORT=8090 enables :8090/metrics.
    metrics_export_port: int = 0
    # Federated Prometheus endpoint on the GCS (0 = disabled): one
    # exposition merging every node's syncer-shipped metric snapshot,
    # node-labelled (RAY_TPU_METRICS_GCS_EXPORT_PORT).
    metrics_gcs_export_port: int = 0
    # Per-service/method RPC instrumentation (queue-wait + handler
    # latency histograms, inflight gauges, bytes counters) on RpcServer
    # and both clients. RAY_TPU_METRICS_RPC_ENABLED=0 is the bench
    # kill switch the observability-overhead probe flips.
    metrics_rpc_enabled: bool = True
    # EventLoopThread lag probe cadence (0 disables): a sleep(interval)
    # measures its own overshoot — the Python analogue of the
    # reference's instrumented asio event loops.
    metrics_loop_probe_ms: int = 250
    # How often a node piggybacks a full metric snapshot on its syncer
    # push (0 disables federation; the cadence is deliberately much
    # slower than the delta interval — snapshots are the big payload).
    metrics_sync_interval_ms: int = 5000
    # Task events flushed to the GCS sink for the state API/timeline.
    # 1s coalescing window (matches the reference's flush interval):
    # the window size bounds staleness, not volume — volume is bounded
    # by the ring.
    task_events_enabled: bool = True
    task_events_flush_ms: int = 1000
    # Worker-side unflushed-event backstop when the GCS is unreachable:
    # the TaskEventBuffer ring never grows past this many attempts
    # (oldest dropped, per-kind drop counters — execution never blocks).
    task_events_max_buffer: int = 10000
    # Opt-in profile events (object transfers, user profiling spans)
    # riding the same bounded pipeline (RAY_TPU_TASK_EVENTS_PROFILE=1).
    task_events_profile: bool = False
    # GCS-side per-job storage cap: oldest attempts evicted first, with
    # eviction counts surfaced through the state API.
    task_events_max_per_job: int = 10000
    # Finished jobs keep their task events this long before GC frees
    # the storage (0 = GC at the first sweep after job completion).
    task_events_finished_job_ttl_s: float = 300.0
    # Per-task resource attribution: the executor wraps each attempt
    # with thread CPU-time + RSS delta/peak probes and ships them on the
    # attempt's task-event record (RAY_TPU_TASK_EVENTS_RESOURCES=0 is
    # the bench kill switch the attribution_overhead probe flips).
    task_events_resources: bool = True
    # Opt-in CUDA memory attribution per attempt (reads
    # torch.cuda.memory_stats() around the task body, only in a process
    # that has already initialised CUDA: RAY_TPU_TASK_EVENTS_DEVICE_MEM=1).
    task_events_device_mem: bool = False

    # ---- diagnosis plane (signal-safe stack dumps + hung-task
    # watchdog; profiling.py + the Diagnosis GCS service) ----
    # Workers register faulthandler on SIGUSR1 at boot so the daemon can
    # extract all-thread tracebacks even when the GIL is held by a
    # thread stuck in native code (RAY_TPU_STACK_DUMP_ENABLED=0 off).
    stack_dump_enabled: bool = True
    # RUNNING attempts older than this with no progress are flagged
    # hung: one rate-limited stack dump is auto-captured and attached
    # to the attempt's task-event record (0 disables the watchdog).
    hang_threshold_s: float = 300.0
    # Watchdog poll cadence (each tick asks busy workers for their
    # running attempts with a short deadline).
    hang_poll_interval_s: float = 2.0
    # Auto-captured dumps are truncated to this many bytes before they
    # ride the task-event pipeline (bounded record size).
    hang_dump_max_bytes: int = 32768
    # Global floor between auto-captures on one daemon: a mass hang must
    # not turn the watchdog into a signal storm.
    hang_dump_min_interval_s: float = 30.0
    # Opt-in distributed tracing: span context rides TaskSpecs, spans
    # flush into the TaskEvents sink (ref: ray.init tracing hooks,
    # util/tracing/tracing_helper.py).
    tracing_enabled: bool = False
    # Node memory monitor (ref: src/ray/common/memory_monitor.h:52 —
    # refresh cadence; 0 disables) + usage fraction above which the
    # daemon kills workers, newest task lease first (ref LIFO-retriable
    # policy, raylet/worker_killing_policy.h:64).
    memory_monitor_refresh_ms: int = 250
    memory_usage_threshold: float = 0.95
    # GCS load attribution: every GCS RPC carries its caller's identity
    # (node id + component — syncer/serve-gauges/task-events/scheduler/
    # client) and the GCS accumulates per-service x per-component
    # request/bytes/handler-time shares (`ray-tpu gcs top`). The shares
    # are the measure-then-shard evidence for the GCS sharding arc.
    # RAY_TPU_GCS_ATTRIBUTION_ENABLED=0 is the bench kill switch the
    # gcs_attribution_overhead probe flips.
    gcs_attribution_enabled: bool = True
    # Wall budget for a single GCS handler: any handler exceeding it is
    # logged (method + caller + args digest) and journaled so slow-path
    # regressions name their caller (RAY_TPU_GCS_SLOW_HANDLER_MS; 0
    # disables the audit; read once at GCS start).
    gcs_slow_handler_ms: float = 100.0
    # GCS event-loop audit cadence: a sleep(interval) on the GCS's own
    # loop measures its overshoot (lag) and samples the asyncio task
    # backlog + KV/store sizes into gcs-labelled gauges (0 disables).
    gcs_loop_audit_ms: int = 500
    # Cluster flight recorder: a bounded, PersistentStore-durable
    # journal of state transitions (node join/death, failover, drain +
    # KV migration, autoscale/elastic resizes, PG repair) queryable via
    # `ray-tpu events` / state.cluster_events() and surviving GCS
    # restart (RAY_TPU_GCS_FLIGHT_RECORDER_ENABLED=0 disables).
    gcs_flight_recorder_enabled: bool = True
    # In-memory + durable journal bound: oldest entries evicted (and
    # deleted from the store) past this many.
    gcs_flight_max_events: int = 4096

    # ---- placement groups / gang scheduling ----
    # Two-phase gang reserve (ref: gcs_placement_group_scheduler.h:274
    # prepare/commit): a PREPAREd bundle the GCS never commits (GCS
    # crash, peer-node prepare failure) auto-expires on the daemon after
    # this long and its resources return to the pool — the timeout-
    # bounded rollback that keeps a half-placed gang from leaking.
    pg_prepare_ttl_s: float = 30.0
    # On bundle COMMIT the daemon pre-warms one pool worker per bundle
    # so gang start rides ~3ms zygote forks instead of cold spawns
    # (RAY_TPU_PG_PREWARM_ENABLED=0 disables).
    pg_prewarm_enabled: bool = True

    # ---- elastic training plane (train/elastic.py) ----
    # How long the elastic supervisor waits for a replacement bundle
    # (gang back to CREATED) after a rank dies/hangs before it shrinks
    # the gang to the largest feasible world size.
    elastic_replace_timeout_s: float = 30.0
    # Capped exponential backoff + jitter between gang restarts
    # (RAY_TPU_ELASTIC_BACKOFF_*; FailureConfig fields override).
    elastic_backoff_initial_s: float = 0.5
    elastic_backoff_max_s: float = 15.0
    elastic_backoff_multiplier: float = 2.0
    # Fraction of the delay randomized away (0.2 => +/-20%).
    elastic_backoff_jitter: float = 0.2
    # Cadence of the shrunk supervisor's capacity probe for growing the
    # gang back toward the target world size.
    elastic_grow_check_s: float = 10.0

    # ---- train-plane observability (train/observability.py;
    # RAY_TPU_TRAIN_OBS_*) ----
    # Kill switch for the whole train-plane observability stack:
    # per-step phase attribution, per-rank gauge federation, step
    # spans, and the GCS TrainRunState aggregator's inputs.
    train_obs_enabled: bool = True
    # Cadence of the per-rank gauge push (worker -> local node daemon
    # -> syncer -> GCS). Rides the existing serve-gauge report path.
    train_obs_push_s: float = 1.0
    # Node-daemon TTL sweep for per-(run, rank) train gauges: a rank
    # that stops pushing (dead, SIGSTOPped) ages out of the node's
    # synced state after this long, but stays in the GCS aggregator's
    # retained view (marked stale) for blame attribution.
    train_obs_gauge_ttl_s: float = 30.0
    # Step window for cross-rank skew: the per-rank gauges carry mean
    # step time over the last N steps; the GCS computes p99/p50 across
    # ranks from those windows.
    train_obs_window_steps: int = 20
    # Step spans emitted per rank per attempt before span minting stops
    # (bounds trace volume for long runs; the shared tracing ring
    # buffer also caps at 10k records). 0 disables step spans entirely.
    train_obs_trace_steps: int = 512
    # Peak accelerator FLOP/s used as the MFU denominator when
    # ScalingConfig.flops_per_step is set. 0 => report achieved FLOP/s
    # only and skip the MFU estimate.
    train_obs_peak_flops: float = 0.0

    # ---- serving plane (paged KV cache engine; serve/llm.py,
    # serve/kv_cache.py — RAY_TPU_KV_BLOCK_* / RAY_TPU_SERVE_*) ----
    # Tokens per KV block. Small blocks waste less HBM on short tails
    # but deepen block tables; 16 matches the vLLM default.
    kv_block_size: int = 16
    # Blocks in the pool (block 0 is the reserved null block and never
    # allocated). 0 => derived from the engine's num_slots * max_len
    # budget so paged and fixed-slot engines reserve equal HBM.
    kv_block_count: int = 0
    # Refcounted prefix-block sharing + copy-on-write (vLLM automatic
    # prefix caching at block granularity). 0 disables: every request
    # prefills from scratch.
    kv_block_prefix_sharing: bool = True
    # Prompt tokens admitted per engine tick during prefill: long
    # prompts prefill in chunks interleaved with decode bursts so
    # active streams' inter-token latency stays bounded.
    serve_prefill_chunk: int = 128
    # Per-request streaming token queue bound: a consumer that falls
    # this many tokens behind has its stream dropped with an explicit
    # error instead of growing replica RSS without limit.
    serve_stream_queue_max: int = 1024
    # Prompt-lookup speculative decoding on the paged engine: default
    # draft window K for engines/deployments that don't pass
    # speculation_k explicitly. 0/1 disables; >= 2 verifies K
    # candidates (1 carried token + K-1 n-gram proposals) per tick in
    # one width-K device call. Exact under greedy decoding.
    serve_speculation_k: int = 0
    # Trailing n-gram length the drafter matches against each slot's
    # own context (prompt + generated tokens) to mine proposals.
    serve_speculation_ngram: int = 2
    # ---- decode on rails (serve/handle.py, serve/replica.py) ----
    # Stream token frames over the compiled-DAG channel plane instead of
    # per-batch stream_next RPCs: the handle pre-creates a shm ring on
    # its own node and the replica's stream drain runs as a pinned rails
    # stage whose frames ride versioned channel writes (same-host mmap,
    # cross-host RemoteChannelWriter push through the reader node's
    # daemon). Kill switch: off => every stream admits on the ordinary
    # RPC pull path; on-stream failures always spill there too.
    serve_rails_enabled: bool = True
    # Ring capacity per rails stream (bytes).
    serve_rails_capacity_bytes: int = 1 << 20
    # Per-replica rails lane width: concurrent pinned stream stages.
    # Attach requests beyond this spill to the RPC pull path at
    # admission time (never mid-stream).
    serve_rails_max_streams: int = 32
    # Handle-side ring poll slice; a slice that yields no frame
    # rate-limits a replica liveness probe (serve_rails_probe_s) so a
    # SIGKILLed replica surfaces as a resume, not a silent hang.
    serve_rails_tick_s: float = 0.2
    serve_rails_probe_s: float = 1.0
    # Daemon-side TTL for per-replica serve gauges: a replica that
    # stopped pushing (crash, scale-down) ages out of the syncer's
    # "serve" entry instead of pinning stale queue depth.
    serve_gauge_ttl_s: float = 10.0
    # Controller-side TTL for handle-pushed autoscale stats (the
    # fallback signal when the syncer view is absent): entries from a
    # handle process that exited between pushes expire instead of
    # flapping the replica target.
    serve_autoscale_stats_ttl_s: float = 5.0
    # ---- serving-plane robustness ----
    # Handle-side retry budget for replica-death/draining failures:
    # attempts (total tries) and capped exponential backoff + jitter
    # between them, mirroring the elastic-train knobs.  Also bounds the
    # number of mid-stream failover resumes per streaming response.
    serve_retry_max: int = 3
    serve_retry_backoff_initial_s: float = 0.05
    serve_retry_backoff_max_s: float = 2.0
    serve_retry_backoff_multiplier: float = 2.0
    serve_retry_backoff_jitter: float = 0.2
    # Graceful drain on downscale/redeploy: a retiring replica stops
    # admission, keeps serving in-flight streams up to this long, then
    # exits; whatever remains migrates-by-recompute through the handle
    # resume path.
    serve_drain_timeout_s: float = 30.0
    # HTTP proxy admission bound: requests beyond this many in flight
    # are shed with 503 + Retry-After instead of queueing without limit.
    serve_proxy_max_inflight: int = 256
    # Per-request deadline on proxied unary calls and per-pull deadline
    # on proxied/handle streams.
    serve_request_deadline_s: float = 120.0
    # Per-tick wall budget for the controller's concurrent replica
    # health probes (shared deadline across the bounded gather, not
    # per-replica).
    serve_health_timeout_s: float = 10.0
    # ---- serving-plane observability ----
    # Per-request serve tracing: the proxy/handle mint a trace context
    # (trace id == request id) and every hop — proxy admission, handle
    # routing, replica queue, engine admission, prefill chunks, decode
    # bursts, stream pulls, failover resumes — records a span into the
    # GCS TaskEvents sink (`ray-tpu serve trace <request-id>`).  On by
    # default (spans are dict appends off the device path); kill switch
    # RAY_TPU_SERVE_TRACE_ENABLED=0 also disables the engines'
    # per-token latency attribution.
    serve_trace_enabled: bool = True
    # Cadence of the replica/proxy worker-process metrics push to the
    # local node daemon (the daemon folds worker registry dumps into
    # its syncer federation payload so serve TTFT/ITL histograms and
    # KV-cache counters appear in `ray-tpu metrics --federated`).
    serve_metrics_push_s: float = 2.0
    # ---- disaggregated serving (serve/disagg.py) ----
    # Knob families: RAY_TPU_SERVE_DISAGG_* (prefill/decode split),
    # RAY_TPU_SERVE_PREFIX_REGISTRY_* (cluster-wide prefix registry),
    # RAY_TPU_SERVE_KV_MIGRATE_* (live KV migration on drain).
    # Prefill/decode split: paged replicas offload long-prompt prefill
    # to dedicated prefill actors and adopt the returned KV frames into
    # their block pool instead of recomputing. Off by default: the
    # split only pays for itself when long prompts interfere with
    # decode ITL.
    serve_disagg_enabled: bool = False
    # Prompts shorter than this many tokens prefill locally even when
    # disagg is on (the frame round-trip costs more than the compute).
    serve_disagg_prompt_threshold: int = 64
    # Dedicated prefill actors per engine pool (keyed by
    # config/block-size/max-len so frames always fit the adopter).
    serve_disagg_prefill_actors: int = 1
    # Cluster-wide prefix registry: replicas publish block-aligned
    # prefix digests over the gauge/syncer path and the handle routes
    # prefix-warm requests to the replica already holding those blocks.
    serve_prefix_registry_enabled: bool = True
    # Per-replica cap on published digests (newest-registered win) so
    # the gauge payload stays bounded on prefix-heavy workloads.
    serve_prefix_registry_max_entries: int = 512
    # Live KV migration on drain: a draining replica exports each
    # in-flight stream's KV blocks as a migration ticket; the resumed
    # stream adopts them on the new replica instead of recomputing the
    # whole context (recompute stays the fallback when the ticket is
    # missing, stale, or oversized).
    serve_kv_migrate_enabled: bool = True
    # Tickets whose KV frame exceeds this many bytes are not published
    # (the resume falls back to recompute rather than bloating the GCS
    # KV store with multi-MB blobs).
    serve_kv_migrate_inline_max_bytes: int = 4194304
    # Grace window the draining replica waits after publishing tickets
    # so handles observe the failure and resume elsewhere before the
    # process exits.
    serve_kv_migrate_linger_s: float = 2.0
    # Tickets older than this are treated as stale and ignored on
    # consume (left-over tickets are also deleted on read).
    serve_kv_migrate_ttl_s: float = 60.0
    # Grace window for replica actors to come up before the controller
    # declares a deployment failed.
    serve_startup_grace_s: float = 600.0
    # Shared-memory ring channels (experimental/channel.py, the rails'
    # transport): spin-wait poll backoff bounds, in MICROSECONDS. Once the
    # backoff saturates at the max the waiter also sched_yield()s so a
    # busy peer on the same core can make progress.
    channel_backoff_us_min: float = 1.0
    channel_backoff_us_max: float = 200.0
    # CompiledDAG.teardown() wait on stage loops before raising with
    # the straggler list.
    dag_teardown_timeout_s: float = 10.0
    # ---- workflow plane ----
    # Root directory for workflow checkpoint storage.
    workflow_storage: str = "/tmp/ray_tpu_workflows"
    # ---- usage stats (util/usage_stats.py; opt-in, off by default like
    # the reference's RAY_USAGE_STATS_ENABLED gate) ----
    usage_stats_enabled: bool = False
    # Report endpoint; empty disables the network hop (local file only).
    usage_stats_url: str = ""
    # Local spool file for usage reports (empty = session temp dir).
    usage_stats_path: str = ""

    # ---- client bootstrap / process-local paths ----
    # Cluster address used by ray_tpu.init() and the CLI when none is
    # passed explicitly ("host:port"; empty = start a local cluster).
    # The supervisor exports RAY_TPU_ADDRESS into worker environments, so
    # this knob is also the in-cluster handoff channel.
    address: str = ""
    # Directory for per-node daemon/worker logs (empty =
    # $TMPDIR/ray_tpu_torch_logs/<node id>); the node's runtime-env cache
    # sits beside them.
    log_dir: str = ""
    # Explicit path to the native object-store library; empty = build it
    # from ray_tpu_torch/csrc into ray_tpu_torch/_build (store_build.py).
    store_lib: str = ""
    # Mirror driver worker stdout/stderr lines back to the driver
    # process (the reference's log_to_driver).
    log_to_driver: bool = True
    # fsync the GCS persistence WAL on every append. Durable by default;
    # turn off for throughput when the control-plane store is scratch.
    gcs_fsync: bool = True

    # ---- timeouts ----
    actor_creation_timeout_s: int = 120

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> None:
    global _config
    _config = None
