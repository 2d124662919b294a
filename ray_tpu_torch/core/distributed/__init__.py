"""The multi-process runtime (counterpart of `ray_tpu.core.distributed`),
for one host: the control plane (`gcs_server.py`, with `scheduler`,
`syncer`, `task_events`, `gcs_storage`, `log_monitor`), the node daemon
(`node_daemon.py`, with `transfer`, `pull_manager`, `runtime_env_agent`),
the zygote that forks workers (`worker_zygote.py`, `worker_main.py`), the
core worker of drivers and workers (`core_worker.py`), the RPC stack
(`wire`, `protocol`, `rpc`), the bootstrap `init()` calls (`driver.py`) and
the GPU resource primitives (`resources.py`, `accelerators.py`). Several
daemons on one machine, the client proxy and cross-language calls are
ROADMAP queue A, item 10a-iii."""
