"""The autoscaler's planner and v2 instance manager of ray_tpu_torch against
ray_tpu's, on the CPU, with no cluster.

The nine planning cases of tests/test_autoscaler.py, with its TPU host
written as a GPU host (`{"CPU": 8, "GPU": 4}`: the planner treats resource
names alike), go through both packages' `plan_scaling` and
`fits_after_removal` on the same inputs. The plans (what to launch, what
is infeasible) must be equal, and equal to what the JAX test asserts.

Three of the four cases of tests/test_autoscaler_v2.py drive each
package's `InstanceManager` over a fake provider of its own `NodeProvider`
class: a gang's full cycle with a stuck launch replaced, a restart from
the persisted table, and an attempt budget running out. Each records, after
every step, the table's status summary, the provider's live and terminated
instances and the records' attempts; the two traces must be equal. The
fourth case, test_gcp_sim_scale_up_down, drives the GCP TPU-VM provider
(`ray_tpu/autoscaler/gcp.py`), which has no port: the port launches GPU
nodes through `FakeMultiNodeProvider` and refuses `gcp` and `sim-gcp`
(tests/test_torch_autoscaler.py holds it to that refusal).

Nothing is numeric beyond counts, so there is no tolerance.
"""
import importlib
import time

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]


def _mod(rt, name):
    return importlib.import_module(f"{rt.__name__}.{name}")


TYPES = {
    "cpu_worker": {"resources": {"CPU": 4, "memory": 8.0}, "max_workers": 5},
    "gpu_host": {"resources": {"CPU": 8, "GPU": 4, "memory": 16.0},
                 "max_workers": 2},
}

# (planner keyword arguments, the plan the JAX test asserts)
PLANS = {
    "queued_demand": (dict(running=[{"CPU": 1}], pending_types=[],
                           demands=[{"CPU": 4}, {"CPU": 4}, {"CPU": 2}]),
                      ({"cpu_worker": 3}, [])),
    "smallest_sufficient_type": (dict(running=[], pending_types=[],
                                      demands=[{"CPU": 2}]),
                                 ({"cpu_worker": 1}, [])),
    "gpu_demand_picks_gpu_host": (dict(running=[], pending_types=[],
                                       demands=[{"GPU": 4}]),
                                  ({"gpu_host": 1}, [])),
    "max_workers_and_infeasible": (dict(running=[], pending_types=[],
                                        demands=[{"GPU": 4}] * 3 + [{"GPU": 64}]),
                                   ({"gpu_host": 2}, [{"GPU": 64}, {"GPU": 4}])),
    "booting_capacity": (dict(running=[], pending_types=["cpu_worker"],
                              demands=[{"CPU": 4}]),
                         ({}, [])),
    "strict_pack_pg": (dict(running=[{"CPU": 4}], pending_types=[], pending_pgs=[
        {"bundles": [{"CPU": 3}, {"CPU": 3}], "strategy": "STRICT_PACK"}]),
                       ({"gpu_host": 1}, [])),
    "strict_spread_pg": (dict(running=[{"CPU": 4}], pending_types=[], pending_pgs=[
        {"bundles": [{"CPU": 2}] * 3, "strategy": "STRICT_SPREAD"}]),
                         ({"cpu_worker": 2}, [])),
    "requests_within_totals": (dict(running=[{"CPU": 0}], pending_types=[],
                                    resource_requests=[{"CPU": 4}],
                                    totals=[{"CPU": 4}]),
                               ({}, [])),
    "requests_beyond_totals": (dict(running=[{"CPU": 0}], pending_types=[],
                                    resource_requests=[{"CPU": 4}, {"CPU": 4}],
                                    totals=[{"CPU": 4}]),
                               ({"cpu_worker": 1}, [])),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plans_match_jax(case):
    kwargs, expected = PLANS[case]
    plans = []
    for rt in RUNTIMES:
        plan = _mod(rt, "autoscaler.binpack").plan_scaling(TYPES, **kwargs)
        plans.append((plan.to_launch, plan.infeasible))
    assert plans[0] == plans[1] == expected, plans


def test_fits_after_removal_matches_jax():
    totals = [{"CPU": 4}, {"CPU": 4}]
    got = [(b.fits_after_removal(totals, 0, [{"CPU": 4}]),
            b.fits_after_removal(totals, 0, [{"CPU": 4}, {"CPU": 2}]))
           for b in (_mod(rt, "autoscaler.binpack") for rt in RUNTIMES)]
    assert got[0] == got[1] == (True, False)


# -- the v2 instance manager -----------------------------------------------------

def _fake_provider(rt):
    np_mod = _mod(rt, "autoscaler.node_provider")

    class FakeProvider(np_mod.NodeProvider):
        """Instances appear at once; the scenario decides which join the
        cluster (`ray_node_id`) and which hang (stuck)."""

        def __init__(self):
            self.instances = {}
            self.terminated = []
            self.seq = 0

        def create_node(self, node_type, node_config):
            iid = f"i-{self.seq}"
            self.seq += 1
            self.instances[iid] = np_mod.Instance(iid, node_type)
            return iid

        def terminate_node(self, instance_id):
            self.terminated.append(instance_id)
            self.instances.pop(instance_id, None)

        def non_terminated_nodes(self):
            return dict(self.instances)

    return FakeProvider()


def _types(rt):
    cfg = _mod(rt, "autoscaler.autoscaler").NodeTypeConfig
    return {"gpu-host": cfg(resources={"CPU": 8.0, "GPU": 4.0},
                            min_workers=0, max_workers=4)}


def _status(nodes=(), pending_pgs=(), pending_actors=()):
    return {"nodes": list(nodes), "pending_pgs": list(pending_pgs),
            "pending_actors": list(pending_actors), "resource_requests": []}


def _alive(node_id, idle_s=0.0):
    return {"node_id": node_id, "alive": True, "idle_s": idle_s,
            "total": {"CPU": 8.0, "GPU": 4.0},
            "available": {"CPU": 8.0, "GPU": 4.0}, "queued_demand": []}


def _snap(im, prov):
    return (im.summary(), sorted(prov.instances), list(prov.terminated),
            sorted((r.node_type, r.status, r.attempt) for r in im.instances.values()))


def v2_full_cycle(rt):
    v2 = _mod(rt, "autoscaler.v2")
    prov = _fake_provider(rt)
    saved = []
    im = v2.InstanceManager(prov, _types(rt), launch_timeout_s=0.15,
                            idle_timeout_s=0.1, drain_timeout_s=0.1,
                            persist=saved.append)
    trace = []
    gang = {"bundles": [{"GPU": 4.0}, {"GPU": 4.0}], "strategy": "PACK"}
    st = _status(pending_pgs=[gang])
    im.schedule(st)
    trace.append(_snap(im, prov))
    im.reconcile(st)
    trace.append(_snap(im, prov))
    joined, stuck = sorted(prov.instances)
    prov.instances[joined].ray_node_id = "node-A"
    st = _status(nodes=[_alive("node-A")], pending_pgs=[gang])
    im.reconcile(st)
    trace.append(_snap(im, prov))
    time.sleep(0.2)
    im.reconcile(st)
    trace.append(_snap(im, prov))
    im.reconcile(st)
    (repl,) = im.active(v2.ALLOCATED)
    prov.instances[repl.cloud_id].ray_node_id = "node-B"
    st = _status(nodes=[_alive("node-A"), _alive("node-B")], pending_pgs=[gang])
    im.reconcile(st)
    trace.append(_snap(im, prov))
    st = _status(nodes=[_alive("node-A", idle_s=5.0), _alive("node-B", idle_s=5.0)])
    for _ in range(3):
        im.reconcile(st)
        trace.append(_snap(im, prov))
    im.schedule(st)
    trace.append((_snap(im, prov), bool(saved), stuck in prov.terminated))
    return trace


def v2_restart(rt):
    v2 = _mod(rt, "autoscaler.v2")
    prov = _fake_provider(rt)
    im = v2.InstanceManager(prov, _types(rt), launch_timeout_s=60)
    gang = {"bundles": [{"GPU": 4.0}], "strategy": "PACK"}
    st = _status(pending_pgs=[gang])
    im.schedule(st)
    im.reconcile(st)
    trace = [_snap(im, prov)]
    im2 = v2.InstanceManager(prov, _types(rt), launch_timeout_s=60)
    im2.restore(im.dump())
    trace.append(_snap(im2, prov))
    im2.schedule(st)
    im2.reconcile(st)
    trace.append(_snap(im2, prov))
    (rec,) = im2.active(v2.ALLOCATED)
    prov.instances[rec.cloud_id].ray_node_id = "node-A"
    im2.reconcile(_status(nodes=[_alive("node-A")], pending_pgs=[gang]))
    trace.append(_snap(im2, prov))
    return trace


def v2_attempt_budget(rt):
    v2 = _mod(rt, "autoscaler.v2")
    prov = _fake_provider(rt)
    im = v2.InstanceManager(prov, _types(rt), launch_timeout_s=0.05, max_attempts=2)
    im.schedule(_status(pending_actors=[{"GPU": 4.0}]))
    trace = [_snap(im, prov)]
    for _ in range(8):
        im.reconcile(_status())
        time.sleep(0.06)
    trace.append(_snap(im, prov))
    return trace


V2_SCENARIOS = {"full_cycle": v2_full_cycle, "restart": v2_restart,
                "attempt_budget": v2_attempt_budget}


@pytest.mark.parametrize("name", list(V2_SCENARIOS))
def test_v2_instance_manager_matches_jax(name):
    traces = [V2_SCENARIOS[name](rt) for rt in RUNTIMES]
    assert traces[0] == traces[1], traces
    if name == "full_cycle":
        last = traces[1][-1]
        assert last[0][1] == [] and len(last[0][2]) == 3 and last[1] and last[2]
