"""The multi-process runtime (counterpart of `ray_tpu.core.distributed`):
the control plane (`gcs_server.py`, with `scheduler`,
`syncer`, `task_events`, `gcs_storage`, `log_monitor`), the node daemon
(`node_daemon.py`, with `transfer`, `pull_manager`, `runtime_env_agent`),
the zygote that forks workers (`worker_zygote.py`, `worker_main.py`), the
core worker of drivers and workers (`core_worker.py`), the RPC stack
(`wire`, `protocol`, `rpc`), the bootstrap `init()` calls (`driver.py`) and
the GPU resource primitives (`resources.py`, `accelerators.py`: a daemon
grants each lease card ids and scopes its worker to them), and the
in-process harnesses of `virtual_node.py`. Several daemons run on one
machine through `ray_tpu_torch.cluster_utils`, and objects move between
them through `transfer`/`pull_manager`; the client proxy is
`ray_tpu_torch.util.client`. Remote writers of the compiled DAG's rings push
through the daemon's `channel_*` endpoints; C++ workers and clients
(`cpp/`, `util/cross_lang.py`) speak the same wire protocol."""
