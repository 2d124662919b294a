"""Disaggregated serving plane: prefill/decode split, prefix registry
digests, live-KV migration tickets.

The port's copy of `ray_tpu/serve/disagg.py`, importing `ray_tpu_torch`
only: a prefill actor runs the port's `paged_prefill_chunk` on `device`
("cuda" unless the caller asks for the CPU) and ships its frame as a
tensor in the cache dtype.

Three coordination pieces over machinery that already exists:

  Prefill/decode split   `PrefillWorker` actors run `paged_prefill_chunk`
                         over chunked long prompts in a private block
                         pool and hand the finished blocks back as ONE
                         host frame (models/decoding.py gather_blocks).
                         The decode replica `import_prefix`es the frame
                         into its own pool — a sealed KV block is just
                         bytes riding the zero-copy transfer plane, so
                         the handoff is an object-store put/get, not a
                         new RPC protocol.  Long-prompt prefill stops
                         competing with decode bursts for the decode
                         engine's device time (the long-TTFT vs
                         short-ITL interference the split removes).

  Prefix registry        Replicas publish the digests of their
                         registered block-aligned prefixes through the
                         existing report_serve_gauges -> syncer -> GCS
                         path (TTL-swept with the gauges themselves, so
                         a SIGKILLed replica's entries age out in
                         serve_gauge_ttl_s).  The controller folds the
                         merged owner map into routing state; the
                         handle routes prefix-warm requests to the
                         replica already holding those blocks
                         (serve/handle.py, modeled on multiplexed model
                         affinity).

  Live KV migration      A draining replica exports each in-flight
                         stream's written KV as a ticket (engine
                         export_streams) keyed by request id in the GCS
                         KV "serve" namespace; the handle's resume
                         protocol re-admits the stream on a survivor,
                         whose replica consumes the ticket and
                         import_prefix`es the frame — the resumed
                         context prefix-hits the imported chain and
                         recomputes at most one partial block instead
                         of the whole prompt+emitted recompute.  Any
                         failure anywhere falls back to the PR-9
                         recompute path (exactly-once either way).
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.kv_cache import prefix_digest

# GCS KV key prefix for migration tickets ("serve" namespace, beside
# the controller's app:*/routes/status keys).
_TICKET_PREFIX = b"migrate:"


def request_digests(tokens, block_size: int,
                    max_bounds: int = 8) -> List[tuple]:
    """(covered_tokens, digest) pairs for a request's block-aligned
    prefix boundaries, LONGEST first — the handle probes these against
    the cluster owner map and routes to the deepest match.  Bounded to
    the last `max_bounds` boundaries so routing cost stays O(1)-ish for
    very long prompts."""
    n_full = len(tokens) // block_size
    bounds = range(max(1, n_full - max_bounds + 1), n_full + 1)
    return [(k * block_size, prefix_digest(tokens[:k * block_size]))
            for k in reversed(list(bounds))] if n_full else []


def _worker():
    try:
        from ray_tpu_torch.api import _global_worker, is_initialized

        if not is_initialized():
            return None
        return _global_worker()
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# migration tickets (GCS KV, "serve" namespace)
# ---------------------------------------------------------------------------
def publish_migration_tickets(replica_id: str,
                              tickets: List[Dict[str, Any]]) -> int:
    """Write one GCS-KV ticket per exported stream.  Frames above the
    inline bound are dropped (their streams take the recompute
    fallback) — the KV plane is a small-value store, and a ticket that
    can't be written must not stall the drain."""
    import numpy as np

    from ray_tpu_torch.core.config import get_config

    w = _worker()
    if w is None:
        return 0
    bound = get_config().serve_kv_migrate_inline_max_bytes
    published = 0
    for t in tickets:
        kv = np.ascontiguousarray(t["kv"])
        if kv.nbytes > bound:
            continue
        blob = pickle.dumps({
            "tokens": list(t["tokens"]),
            "block_size": int(t["block_size"]),
            "kv_bytes": kv.tobytes(),
            "kv_shape": kv.shape,
            "kv_dtype": str(kv.dtype),
            "replica": replica_id,
            "ts": time.time(),
        })
        t0 = time.time()
        try:
            w.kv_put("serve", _TICKET_PREFIX
                     + t["request_id"].encode(), blob)
            published += 1
        except Exception:  # noqa: BLE001 fallback: recompute
            continue
        from ray_tpu_torch.util import tracing

        tracing.record_serve_span(
            tracing.serve_ctx(t["request_id"]), "serve.kv.migrate",
            t0, time.time(), side="publish", replica=replica_id,
            nbytes=kv.nbytes, tokens=len(t["tokens"]))
    return published


def consume_migration_ticket(request_id: str) -> Optional[Dict[str, Any]]:
    """Fetch-and-delete the migration ticket for a resumed request
    (at-most-once adopt; stale tickets past the TTL are dropped so a
    re-deployed app never imports last week's KV)."""
    import numpy as np

    from ray_tpu_torch.core.config import get_config

    w = _worker()
    if w is None:
        return None
    key = _TICKET_PREFIX + str(request_id).encode()
    try:
        blob = w.kv_get("serve", key)
    except Exception:  # noqa: BLE001
        return None
    if not blob:
        return None
    try:
        w.kv_del("serve", key)
    except Exception:  # noqa: BLE001 best-effort delete
        pass
    try:
        t = pickle.loads(blob)
        if time.time() - t.get("ts", 0) > \
                get_config().serve_kv_migrate_ttl_s:
            return None
        t["kv"] = np.frombuffer(
            t.pop("kv_bytes"), dtype=t.pop("kv_dtype")
        ).reshape(t.pop("kv_shape"))
        return t
    except Exception:  # noqa: BLE001 corrupt ticket: recompute
        return None


# ---------------------------------------------------------------------------
# prefill actors
# ---------------------------------------------------------------------------
class PrefillWorker:
    """Dedicated prefill actor: chunked `paged_prefill_chunk` over a
    private single-request block pool, returning the finished blocks as
    one transferable frame.  No decode loop, no allocator — the pool is
    exactly one prompt deep, so the actor's whole device time goes to
    prefill throughput (the point of the split)."""

    def __init__(self, cfg_name, *, seed: int = 0,
                 block_size: Optional[int] = None, max_len: int = 1024,
                 prefill_chunk: Optional[int] = None, app: str = "-",
                 device: str = "cuda"):
        import torch

        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.models.decoding import (
            init_paged_cache,
            make_paged_engine_fns,
        )
        from ray_tpu_torch.models.transformer import (
            TransformerConfig,
            init_params,
            resolve_device,
        )
        from ray_tpu_torch.models import configs
        from ray_tpu_torch.serve.llm import PagedLLMEngine, _to_compute

        knobs = get_config()
        cfg = (cfg_name if isinstance(cfg_name, TransformerConfig)
               else configs.get(cfg_name))
        self.cfg = cfg
        self.device = resolve_device(device)
        # The same weights the decode replica derives from (cfg, seed),
        # cast once to the compute dtype as its engine does; the fp32
        # masters are dropped before the pool is allocated.
        with torch.no_grad():
            masters = init_params(
                cfg, torch.Generator(device=self.device).manual_seed(seed),
                device=self.device)
            self.params = _to_compute(masters, cfg.compute_dtype,
                                      self.device)
        del masters
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.block_size = block_size or knobs.kv_block_size
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk or knobs.serve_prefill_chunk
        # The decode engine's chunk widths, so a prompt prefills here in
        # the same device calls it would run there.
        self._chunk_tiers = PagedLLMEngine._tiers(32, self.prefill_chunk)
        self._b_max = -(-max_len // self.block_size)
        # Block 0 stays the null block; 1.._b_max is the working set.
        self.cache = init_paged_cache(cfg, self._b_max + 1,
                                      self.block_size, device=self.device)
        self._chunk_fn, _, _ = make_paged_engine_fns(cfg)
        self._torch = torch
        self._app = app
        self._ongoing = 0
        self.stats = {"prefills": 0, "tokens_prefilled": 0,
                      "chunks": 0}
        self._gauge_stop = threading.Event()
        threading.Thread(target=self._gauge_loop, daemon=True).start()

    def _gauge_loop(self, period_s: float = 1.0) -> None:
        """Surface this actor in the serve gauge plane with
        role=prefill so `ray-tpu serve status` shows the split; the
        same TTL sweep that retires dead replicas retires us."""
        import os

        name = f"serve:{self._app}#prefill#{os.getpid()}"
        while not self._gauge_stop.wait(period_s):
            try:
                w = _worker()
                daemon = getattr(w, "daemon", None) if w else None
                if daemon is None:
                    return
                daemon.call(
                    "NodeDaemon", "report_serve_gauges",
                    app=self._app, replica=name,
                    gauges={"ongoing": float(self._ongoing),
                            "prefills": float(self.stats["prefills"])},
                    state={"role": "prefill"}, timeout=2)
            except Exception:  # noqa: BLE001 best-effort telemetry
                continue

    def prefill(self, tokens: List[int]) -> Dict[str, Any]:
        """Chunked prefill of one prompt; returns the KV frame + the
        last-token logits (the decode side stores them as prefix meta,
        so a whole-prompt hit samples its first token with no forward
        at all). Both are host tensors: the frame in the cache dtype,
        (2, L, n, block_size, Hkv, D)."""
        import numpy as np

        from ray_tpu_torch.models.decoding import gather_blocks

        torch = self._torch
        n = len(tokens)
        if n == 0 or n > self.max_len:
            raise ValueError(f"prompt length {n} outside (0, "
                             f"{self.max_len}]")
        self._ongoing += 1
        try:
            bs = self.block_size
            nb = -(-n // bs)
            blocks = list(range(1, nb + 1))
            table = np.zeros((self._b_max,), np.int32)
            table[:nb] = blocks
            dev_table = torch.from_numpy(table).to(self.device)
            pos = 0
            last = None
            with torch.no_grad():
                while pos < n:
                    nv = min(self.prefill_chunk, n - pos)
                    c = next(t for t in self._chunk_tiers if nv <= t)
                    chunk = np.zeros((c,), np.int32)
                    chunk[:nv] = tokens[pos:pos + nv]
                    self.cache, last = self._chunk_fn(
                        self.params, self.cache,
                        torch.from_numpy(chunk).to(self.device),
                        dev_table, pos, nv)
                    pos += nv
                    self.stats["chunks"] += 1
                frame = gather_blocks(self.cache, blocks).cpu()
            self.stats["prefills"] += 1
            self.stats["tokens_prefilled"] += n
            return {"tokens": list(tokens), "block_size": bs,
                    "kv": frame, "last_logits": last.cpu()}
        finally:
            self._ongoing -= 1

    def check_health(self) -> bool:
        return True

    def getpid(self) -> int:
        import os

        return os.getpid()


class DisaggPrefillClient:
    """Decode-replica-side client for the prefill pool: lazily creates
    (or attaches to) the named detached PrefillWorker actors and
    offloads long prompts, importing the returned frames into the local
    engine.  Prompt->actor assignment hashes the first block's digest,
    so repeated prompts with a shared system prefix land on the same
    prefill actor (its jitted chunk tiers stay warm)."""

    def __init__(self, cfg_name, *, seed: int, block_size: int,
                 max_len: int, device: str = "cuda"):
        self._cfg_name = cfg_name
        self._seed = seed
        self._device = str(device)
        self._block_size = block_size
        self._max_len = max_len
        self._actors: Optional[list] = None
        self._lock = threading.Lock()
        self._app = "-"

    def set_serve_context(self, app: str, replica_id: str) -> None:
        self._app = app

    def _pool_key(self) -> str:
        name = getattr(self._cfg_name, "name", None) or \
            (self._cfg_name if isinstance(self._cfg_name, str)
             else "custom")
        return f"{name}-{self._block_size}-{self._max_len}"

    def _ensure_actors(self) -> list:
        import ray_tpu_torch
        from ray_tpu_torch.core.config import get_config

        with self._lock:
            if self._actors is not None:
                return self._actors
            n = max(1, get_config().serve_disagg_prefill_actors)
            actors = []
            RemoteWorker = ray_tpu_torch.remote(PrefillWorker)
            for i in range(n):
                name = f"serve:prefill:{self._pool_key()}#{i}"
                try:
                    actors.append(ray_tpu_torch.get_actor(name))
                    continue
                except Exception:  # noqa: BLE001 not created yet
                    pass
                try:
                    actors.append(RemoteWorker.options(
                        name=name, lifetime="detached").remote(
                        self._cfg_name, seed=self._seed,
                        block_size=self._block_size,
                        max_len=self._max_len, app=self._app,
                        device=self._device))
                except Exception:  # noqa: BLE001 lost creation race
                    actors.append(ray_tpu_torch.get_actor(name))
            self._actors = actors
            return actors

    def prefill_into(self, engine, tokens: List[int]) -> bool:
        """Offload `tokens` to a prefill actor and adopt the frame.
        True when the engine now holds KV covering the whole prompt
        (either freshly imported or already registered); False means
        the caller prefills locally."""
        import ray_tpu_torch
        from ray_tpu_torch.core.config import get_config

        knobs = get_config()
        if len(tokens) < knobs.serve_disagg_prompt_threshold:
            return False
        if len(tokens) > self._max_len:
            return False
        alloc = getattr(engine, "allocator", None)
        if alloc is None or not alloc.prefix_sharing:
            return False
        # Already warm locally (registry hit routed us here, or a
        # previous request published it): nothing to ship.
        held, covered, _meta = alloc.lookup_prefix(tokens)
        alloc.free(held)
        if covered >= len(tokens):
            return True
        actors = self._ensure_actors()
        pick = actors[int(prefix_digest(
            tokens[:self._block_size]), 16) % len(actors)]
        out = ray_tpu_torch.get(pick.prefill.remote(list(tokens)),
                                timeout=knobs.serve_request_deadline_s)
        n = engine.import_prefix(out["tokens"], out["kv"],
                                 out["block_size"],
                                 last_logits=out.get("last_logits"))
        if n <= 0:
            return False
        engine.stats["disagg_prefills"] += 1
        engine.stats["adopted_blocks"] += n
        return True
