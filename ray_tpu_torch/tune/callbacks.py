"""Experiment callbacks: logging/tracking hooks for Tuner runs; the port's
copy of `ray_tpu/tune/callbacks.py`.

Analogue of the reference AIR callbacks (ref: python/ray/air/
integrations/ — wandb.py WandbLoggerCallback, mlflow.py
MLflowLoggerCallback; base interface python/ray/tune/callback.py).
JSON/CSV loggers work out of the box; wandb/mlflow activate when their
packages exist (this zero-egress image has neither, so they raise an
actionable ImportError at construction, not mid-run).
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional


class Callback:
    """ref: tune/callback.py — invoked by the Tuner's control loop."""

    def on_trial_result(self, trial_id: str, config: dict,
                        result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, config: dict,
                          last_result: dict, error: Optional[str]) -> None:
        pass

    def on_experiment_end(self, results) -> None:
        pass


class JsonLoggerCallback(Callback):
    """One result.json (JSON lines) per trial under the experiment dir
    (ref: tune/logger/json.py)."""

    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir

    def _path(self, trial_id: str) -> str:
        d = os.path.join(self.exp_dir, trial_id)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "result.json")

    def on_trial_result(self, trial_id, config, result):
        clean = {k: v for k, v in result.items()
                 if isinstance(v, (int, float, str, bool, type(None)))}
        with open(self._path(trial_id), "a") as f:
            f.write(json.dumps(clean) + "\n")


class CSVLoggerCallback(Callback):
    """progress.csv per trial (ref: tune/logger/csv.py). Rows buffer in
    memory and the file is (re)written with the UNION of all metric keys
    on completion — a header frozen at the first result would silently
    drop metrics that appear later (eval metrics, checkpoint markers)."""

    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir
        self._rows: Dict[str, List[dict]] = {}

    def on_trial_result(self, trial_id, config, result):
        clean = {k: v for k, v in result.items()
                 if isinstance(v, (int, float, str, bool))}
        self._rows.setdefault(trial_id, []).append(clean)
        self._write(trial_id)

    def _write(self, trial_id: str) -> None:
        rows = self._rows.get(trial_id, [])
        if not rows:
            return
        fieldnames: List[str] = []
        for row in rows:
            for k in row:
                if k not in fieldnames:
                    fieldnames.append(k)
        d = os.path.join(self.exp_dir, trial_id)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, ".progress.csv.tmp")
        with open(tmp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted(fieldnames))
            w.writeheader()
            for row in rows:
                w.writerow({k: row.get(k, "") for k in fieldnames})
        os.replace(tmp, os.path.join(d, "progress.csv"))

    def on_trial_complete(self, trial_id, config, last_result, error):
        self._write(trial_id)
        self._rows.pop(trial_id, None)


class WandbLoggerCallback(Callback):
    """ref: air/integrations/wandb.py — one wandb run per trial."""

    def __init__(self, project: str, **init_kwargs):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "WandbLoggerCallback needs the `wandb` package, which is "
                "not available in this environment; use "
                "JsonLoggerCallback/CSVLoggerCallback instead") from e
        self._wandb = __import__("wandb")
        self.project = project
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, object] = {}

    def on_trial_result(self, trial_id, config, result):
        run = self._runs.get(trial_id)
        if run is None:
            # Concurrent trials need concurrent runs: reinit=True would
            # FINISH the previously active run (clobbering in-flight
            # trials); "create_new" (wandb >= 0.19) returns independent
            # Run objects.
            try:
                run = self._wandb.init(project=self.project,
                                       name=trial_id, config=config,
                                       reinit="create_new",
                                       **self.init_kwargs)
            except TypeError:  # older wandb: best effort
                run = self._wandb.init(project=self.project,
                                       name=trial_id, config=config,
                                       reinit=True, **self.init_kwargs)
            self._runs[trial_id] = run
        run.log(result)

    def on_trial_complete(self, trial_id, config, last_result, error):
        run = self._runs.pop(trial_id, None)
        if run is not None:
            run.finish(exit_code=1 if error else 0)


class MLflowLoggerCallback(Callback):
    """ref: air/integrations/mlflow.py — one mlflow run per trial. Uses
    MlflowClient with explicit run ids throughout: the fluent
    start_run/end_run API operates on a global run STACK, which
    mis-attributes runs/statuses when trials are in flight concurrently."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: str = "ray_tpu_torch"):
        try:
            import mlflow  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "MLflowLoggerCallback needs the `mlflow` package, which "
                "is not available in this environment; use "
                "JsonLoggerCallback/CSVLoggerCallback instead") from e
        mlflow = __import__("mlflow")
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        self._client = mlflow.tracking.MlflowClient()
        exp = self._client.get_experiment_by_name(experiment_name)
        self._experiment_id = (exp.experiment_id if exp is not None
                               else self._client.create_experiment(
                                   experiment_name))
        self._run_ids: Dict[str, str] = {}

    def on_trial_result(self, trial_id, config, result):
        run_id = self._run_ids.get(trial_id)
        if run_id is None:
            run = self._client.create_run(
                self._experiment_id,
                tags={"mlflow.runName": trial_id})
            run_id = run.info.run_id
            self._run_ids[trial_id] = run_id
            for k, v in config.items():
                if isinstance(v, (int, float, str, bool)):
                    self._client.log_param(run_id, k, v)
        step = int(result.get("training_iteration", 0))
        for k, v in result.items():
            if isinstance(v, (int, float)):
                self._client.log_metric(run_id, k, float(v), step=step)

    def on_trial_complete(self, trial_id, config, last_result, error):
        run_id = self._run_ids.pop(trial_id, None)
        if run_id is not None:
            self._client.set_terminated(
                run_id, status="FAILED" if error else "FINISHED")
