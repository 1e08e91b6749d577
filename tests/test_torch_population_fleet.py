"""The population's fleet half on the port (the fleet tests of the JAX
package's ``tests/test_population.py``): members as lineages served
over the data plane.

* the parity gate: a 2-member population trained by a master and one
  worker over a real socket equals each member trained alone with its
  seed, bit for bit (weights and optimizer slots), and the JAX
  package's population of the same seeds within rtol 2e-4 / atol 2e-5;
* members with dropout (a tiny AlexNet): each job's step stream is the
  member's, kept across a dropped worker's requeue, so the members
  still equal their standalone runs bit for bit;
* churn: a dropped worker's job requeues with its step key and its
  late reply drops as stale; a clean leave requeues nothing;
* PBT: an exploit ships as a delta 50× smaller than a full ship, the
  perturbed hypers stay in their tune's range, the summary, gauges and
  counters;
* the GA over lineages (genes per lineage, retired chromosomes), the
  topology-tune refusal, the coordinator that never takes the vmap
  shortcut, the coordinator and worker over a socket, and the command
  line.

Every test runs under ``test_torch_network.kept_process_state``.  The
members' standalone runs are computed once per process.
"""

import gc
import json
import os
import threading
from types import SimpleNamespace

import numpy
import pytest
import torch

import veles_tpu_torch.prng as tprng
from veles_tpu_torch import resilience
from veles_tpu_torch.__main__ import Main, import_workflow_module
from veles_tpu_torch.client import Client
from veles_tpu_torch.config import Tune, override_scope, root
from veles_tpu_torch.error import Bug
from veles_tpu_torch.harness import run_workflow_module
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.population import (PopulationEngine,
                                        PopulationMaster,
                                        PopulationWorker, loopback_proto)
from veles_tpu_torch.server import Server

from test_torch_network import joined, kept_process_state, stopped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMNIST = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                      "mnist.py")
JMNIST = os.path.join(REPO, "veles_tpu", "znicz", "samples", "mnist.py")
TIMAGENET = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                         "imagenet.py")
#: No dataset directory: both MNIST samples take scikit-learn's digits.
NO_DATASETS = "/nonexistent/veles-datasets"
SEED = 42
STRIDE = 1000003
#: The members' MNIST: two epochs of 200-sample minibatches.
MNIST = {"max_epochs": 2, "minibatch_size": 200}
#: Members vs the JAX package's: the port's other f32 parity tests'.
RTOL, ATOL = 2e-4, 2e-5


def _setup(r=None):
    for r in (root,) if r is None else (r,):
        r.common.dirs.datasets = NO_DATASETS
        for key, value in MNIST.items():
            setattr(r.mnist, key, value)


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        root.mnist.reset()
        root.imagenet.reset()
        _setup()
        gc.collect()
        yield


def _module():
    return import_workflow_module(TMNIST)


def _final_state(wf):
    """Every trainable and optimizer slot, on the host."""
    out = {}
    for unit in wf.units:
        for which in ("trainables", "tstate"):
            vecs = getattr(unit, which, None)
            if not isinstance(vecs, dict):
                continue
            for attr, vec in vecs.items():
                if vec:
                    vec.map_read()
                    out["%s/%s/%s" % (unit.name, which, attr)] = \
                        numpy.array(vec.mem)
    return out


def _assert_states_equal(a, b, label):
    assert set(a) == set(b) and a, label
    for key in a:
        assert a[key].dtype == b[key].dtype, (label, key)
        assert numpy.array_equal(a[key], b[key]), \
            "%s: %s diverged" % (label, key)


_ALONE = {}


def _alone(module, i, tag="mnist"):
    """Member ``i`` trained alone from its seed: (state, fitness),
    computed once per process."""
    key = (tag, i)
    if key not in _ALONE:
        wf = run_workflow_module(module, seed=SEED + i * STRIDE,
                                 device="cpu")
        _ALONE[key] = (_final_state(wf),
                       float(wf.gather_results()["EvaluationFitness"]))
    return _ALONE[key]


def _drive_loopback(master, workers, proto, max_cycles=5000):
    """Round-robin dispatch over the in-process loopback (the member-job
    contract the socket fleet runs)."""
    for sid, wf in workers.items():
        master.note_slave_protocol(sid, proto)
        wf.note_net_proto(proto)
    for _ in range(max_cycles):
        if master.should_stop_serving():
            return
        jobs = {}
        for sid in workers:
            job = master.generate_data_for_slave(sid)
            if job is not None:
                jobs[sid] = job
        if not jobs:
            if master.should_stop_serving():
                return
            raise AssertionError("population stalled mid-run")
        for sid, job in jobs.items():
            replies = []
            workers[sid].do_job(job, None, replies.append)
            master.apply_data_from_slave(replies[0], sid)
    raise AssertionError("dispatch did not converge in %d cycles"
                         % max_cycles)


def _master(module, mode="train", size=2, **kwargs):
    return PopulationMaster(Launcher(), module, mode=mode, size=size,
                            seed=SEED, device="cpu", **kwargs)


def _worker(module):
    return PopulationWorker(Launcher(), module, seed=SEED, device="cpu")


# -- generator scopes -------------------------------------------------------


def test_prng_scoped_isolation():
    """Draws inside a scope never advance the outer streams, the host's
    or the device's."""
    tprng.reset()
    tprng.get(0).seed(7)
    expected = tprng.get(0).randint(0, 1 << 30, 2)
    tprng.reset()
    tprng.get(0).seed(7)
    first = tprng.get(0).randint(0, 1 << 30)
    outer = tprng.get(0).torch_generator("cpu").get_state()
    store = {}
    with tprng.scoped(store):
        tprng.get(0).seed(99)
        tprng.get(0).randint(0, 10, 5)
        torch.rand(3, generator=tprng.get(0).torch_generator("cpu"))
    assert [first, tprng.get(0).randint(0, 1 << 30)] == list(expected)
    assert torch.equal(tprng.get(0).torch_generator("cpu").get_state(),
                       outer)
    assert store[0].device_seed == 99


# -- the parity gate ----------------------------------------------------------


def test_population_fleet_parity_gate():
    """A 2-member population trained by a master and one worker over a
    real socket gives each member's weights and slots bit for bit as
    the module trained alone with the member's seed, and the same
    fitness; the members differ."""
    module = _module()
    root.common.net.zero = 1  # slots ride the per-member delta plane
    master = _master(module)
    server = Server("127.0.0.1:0", master)
    client = Client("127.0.0.1:%d" % server.port, _worker(module),
                    reconnect_attempts=1)
    thread = threading.Thread(target=client.run, name="test-client")
    thread.start()
    server.wait(timeout=240)
    joined(thread, 60)
    stopped(server)
    assert master.should_stop_serving()
    fleet = {m.member_id: _final_state(m.wf) for m in master.members}
    for i, mid in enumerate(("m0", "m1")):
        state, fitness = _alone(module, i)
        _assert_states_equal(state, fleet[mid], mid)
        assert master._members[mid].fitness == fitness
    key = [k for k in sorted(fleet["m0"]) if "/trainables/" in k][0]
    assert not numpy.array_equal(fleet["m0"][key], fleet["m1"][key])


def test_population_members_match_jax():
    """The same 2-member population (seeds, MNIST digits, f32 matmuls)
    trained by the JAX package's master and worker: every member's
    weights and slots within rtol 2e-4 / atol 2e-5 of the port's, and
    their fitness within 1e-6."""
    import veles_tpu.prng as jprng
    from veles_tpu.__main__ import import_workflow_module as jimport
    from veles_tpu.config import root as jroot
    from veles_tpu.launcher import Launcher as JLauncher
    from veles_tpu.population import (PopulationMaster as JMaster,
                                      PopulationWorker as JWorker)
    _setup(jroot)
    for r in (root, jroot):
        r.common.engine.precision_level = 1
    module = _module()
    master = _master(module)
    _drive_loopback(master, {"w": _worker(module)}, loopback_proto())
    jprng.reset()
    jmodule = jimport(JMNIST)
    jmaster = JMaster(JLauncher(), jmodule, mode="train", size=2,
                      seed=SEED)
    _drive_loopback(jmaster, {"w": JWorker(JLauncher(), jmodule,
                                           seed=SEED)},
                    loopback_proto())
    jprng.reset()
    for got, want in zip(master.members, jmaster.members):
        assert got.member_id == want.member_id
        g, w = _final_state(got.wf), _final_state(want.wf)
        assert sorted(g) == sorted(w)
        for key in w:
            numpy.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                          atol=ATOL, err_msg=key)
        assert got.fitness == pytest.approx(want.fitness, abs=1e-6)
        assert got.jobs_done == want.jobs_done


# -- churn ----------------------------------------------------------------


def test_worker_drop_mid_generation_requeues_and_parity():
    """A worker dropped with a member's job in flight requeues it with
    its step key, its late reply drops as stale, and the members end
    bit for bit as trained alone."""
    module = _module()
    proto = loopback_proto()
    master = _master(module)
    w1, w2 = _worker(module), _worker(module)
    master.note_slave_protocol("w1", proto)
    w1.note_net_proto(proto)
    job = master.generate_data_for_slave("w1")
    straggler = []
    w1.do_job(job, None, straggler.append)
    master.drop_slave("w1")
    assert master.requeues == 1
    assert resilience.stats.get("population.requeues") == 1
    member = master._members[job["m"]]
    assert member.requeued_keys
    master.apply_data_from_slave(straggler[0], "w1")
    assert resilience.stats.get("population.stale_updates") == 1
    _drive_loopback(master, {"w2": w2}, proto)
    for i, m in enumerate(master.members):
        state, fitness = _alone(module, i)
        _assert_states_equal(state, _final_state(m.wf), m.member_id)
        assert m.fitness == fitness


def test_worker_leave_join_cycle_keeps_step_keys_and_fitness():
    """A worker that completes its job and leaves cleanly requeues
    nothing; the joiner that replaces it drives the members to their
    standalone states bit for bit."""
    module = _module()
    proto = loopback_proto()
    master = _master(module)
    w1, w2 = _worker(module), _worker(module)
    master.note_slave_protocol("w1", proto)
    w1.note_net_proto(proto)
    job = master.generate_data_for_slave("w1")
    replies = []
    w1.do_job(job, None, replies.append)
    master.apply_data_from_slave(replies[0], "w1")
    master.drop_slave("w1")
    assert resilience.stats.get("population.requeues") == 0
    assert not master._members[job["m"]].requeued_keys
    _drive_loopback(master, {"w2": w2}, proto)
    for i, m in enumerate(master.members):
        state, fitness = _alone(module, i)
        _assert_states_equal(state, _final_state(m.wf), m.member_id)
        assert m.fitness == fitness


#: A tiny AlexNet with two dropout layers (``test_torch_population``'s).
def _tiny_alexnet_config():
    from test_torch_population import TINY_ALEXNET
    cfg = root.imagenet
    cfg.layers = TINY_ALEXNET
    cfg.minibatch_size = 16
    cfg.max_epochs = 2
    cfg.n_classes = 10
    cfg.sim_image_size = 32
    cfg.sim_classes = 10
    cfg.sim_train = 48
    cfg.sim_valid = 16


def test_dropout_members_keep_their_step_streams_across_a_drop():
    """Members with dropout: every job's step draws from the member's
    own stream (pinned by the job's key, advanced by the worker's
    reply), so two members interleaved on the workers — one worker
    dropped with a job in flight, its key re-served — each equal the
    module trained alone, masks included, bit for bit."""
    _tiny_alexnet_config()
    module = import_workflow_module(TIMAGENET)
    proto = loopback_proto()
    master = _master(module)
    w1, w2 = _worker(module), _worker(module)
    master.note_slave_protocol("w1", proto)
    w1.note_net_proto(proto)
    for _ in range(3):
        job = master.generate_data_for_slave("w1")
        replies = []
        w1.do_job(job, None, replies.append)
        master.apply_data_from_slave(replies[0], "w1")
    job = master.generate_data_for_slave("w1")
    key = job["data"]["__job__"]["rng"]
    assert "state" in key  # the stream moved on from its seed
    master.drop_slave("w1")
    assert master._members[job["m"]].requeued_keys == [key]
    _drive_loopback(master, {"w2": w2}, proto)
    for i, m in enumerate(master.members):
        state, fitness = _alone(module, i, "alexnet")
        _assert_states_equal(state, _final_state(m.wf), m.member_id)
        assert m.fitness == fitness
    a, b = (_alone(module, i, "alexnet")[0] for i in range(2))
    key = [k for k in sorted(a) if "/trainables/" in k][0]
    assert not numpy.array_equal(a[key], b[key])


# -- PBT ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pbt_run():
    """One PBT loopback run (3 members, a tuned learning rate, two
    exploits at this seed), each job's wire size measured through the
    tensor-frame encoder; the config is put back before the tests."""
    from veles_tpu_torch.network_common import encode_message
    with kept_process_state():
        _setup()
        root.mnist.max_epochs = 3
        root.mnist.learning_rate = Tune(0.1, 0.001, 0.5)
        module = _module()
        master = _master(module, mode="pbt", size=3, pbt_interval=1,
                         pbt_quantile=0.34)
        worker = _worker(module)
        proto = loopback_proto()
        master.note_slave_protocol("local", proto)
        worker.note_net_proto(proto)
        sizes = []  # (tag, member, bytes)
        seen = set()
        while not master.should_stop_serving():
            job = master.generate_data_for_slave("local")
            _flags, parts = encode_message(
                {"cmd": "job", "data": job}, codec=None, tensor=True)
            tag = ("exploit" if "exploit" in job else
                   "first" if job["m"] not in seen else "steady")
            seen.add(job["m"])
            sizes.append((tag, job["m"], sum(len(p) for p in parts)))
            replies = []
            worker.do_job(job, None, replies.append)
            master.apply_data_from_slave(replies[0], "local")
        stats = resilience.stats.snapshot()
    return {"master": master, "worker": worker, "sizes": sizes,
            "stats": stats}


def test_pbt_exploit_ships_delta_micro_bench(pbt_run):
    """An exploit-carrying job costs under a fiftieth of a full weight
    ship: the member's synced base was re-pointed at the leader's, so
    the wire carries a collapsing XOR delta, not the model."""
    master, sizes = pbt_run["master"], pbt_run["sizes"]
    assert master.exploits >= 1
    full = max(n for tag, _m, n in sizes if tag == "first")
    exploit_jobs = [(m, n) for tag, m, n in sizes if tag == "exploit"]
    assert len(exploit_jobs) == master.exploits
    for mid, n in exploit_jobs:
        assert n * 50 < full, (mid, n, full)
    assert pbt_run["stats"].get("population.exploit_adopt", 0) >= 1
    assert master.last_exploit_ms is not None
    assert sum(m.generation for m in master.members) >= 1


def test_pbt_perturbs_hypers_within_tune_range(pbt_run):
    """The exploited members' perturbed learning rates stay in the
    tune's range, and the worker's step took every member's value as
    an input: one hyperparameter program, not one per member or job."""
    master = pbt_run["master"]
    exploited = [m for m in master.members if m.generation]
    assert exploited
    for m in exploited:
        assert 0.001 <= m.hypers["learning_rate"] <= 0.5
    assert len({m.hypers["learning_rate"] for m in master.members}) >= 2
    compiler = pbt_run["worker"].inner.compiler
    assert list(compiler._hyper_progs_) == [("train", ("learning_rate",))]


def test_population_summary_and_gauges(pbt_run):
    from veles_tpu_torch.observability import metrics
    from veles_tpu_torch.population import live_population_summary
    master = pbt_run["master"]
    master._publish_gauges()
    summary = live_population_summary()
    assert summary is not None
    assert summary["members"] >= 3
    assert summary["exploits"] >= master.exploits
    assert "m0" in summary["fitness"] and "m0" in summary["generation"]
    own = master.population_summary()
    assert own["mode"] == "pbt" and own["members"] == 3
    assert own["jobs"] == sum(m.jobs_done for m in master.members)
    text = metrics.render_prometheus([metrics.registry])
    assert "population_members" in text
    assert 'population_member_fitness{member="m0"}' in text


def test_population_stat_names_counted(pbt_run):
    stats = pbt_run["stats"]
    assert stats.get("population.jobs", 0) > 0
    assert stats.get("population.ticks", 0) == stats["population.jobs"]
    assert stats.get("population.exploits", 0) >= 1


# -- the GA over lineages, the refusal, the engine's modes -------------------


def test_ga_fleet_applies_genes_per_lineage():
    """GA chromosomes become lineages with their genes applied through
    the override scope and shipped as hypers: the global tree never
    changes, and recorded chromosomes free their workflows here and
    their contexts on the worker."""
    tune = Tune(0.0005, 0.0001, 0.5)
    root.mnist.learning_rate = tune
    module = _module()
    master = _master(module, mode="ga", size=3, generations=2)
    worker = _worker(module)
    _drive_loopback(master, {"w": worker}, loopback_proto())
    assert root.mnist.learning_rate is tune
    assert master._ga_pop.complete
    assert master.best is not None and master.best[0] == "ga"
    assert "mnist.learning_rate" in master.best[2]
    fits = [m.fitness for m in master.members]
    assert len(fits) > 3 and len(set(fits)) >= 2
    assert all(m.wf is None and m.retired and m.last_good is None
               for m in master.members)
    assert len(worker._contexts) <= 3, sorted(worker._contexts)


def test_fleet_mode_rejects_topology_tunes():
    """A topology tune cannot ride fleet lineages: the port's master
    raises ``Bug``, as the JAX package's does."""
    from veles_tpu.__main__ import import_workflow_module as jimport
    from veles_tpu.config import root as jroot
    from veles_tpu.error import Bug as JBug
    from veles_tpu.launcher import Launcher as JLauncher
    from veles_tpu.population import PopulationMaster as JMaster
    root.mnist.max_epochs = 1
    root.ga_test.n_layers = Tune(2, 1, 4)
    with pytest.raises(Bug, match="topology"):
        _master(_module(), mode="ga", size=2, generations=1)
    jroot.mnist.max_epochs = 1
    from veles_tpu.config import Tune as JTune
    jroot.ga_test.n_layers = JTune(2, 1, 4)
    with pytest.raises(JBug, match="topology"):
        JMaster(JLauncher(), jimport(JMNIST), mode="ga", size=2,
                seed=SEED, generations=1)


def _main(module=None, **kw):
    args = dict(listen_address=None, master_address=None,
                result_file=None, random_seed=str(SEED), pbt=False,
                device="cpu")
    args.update(kw)
    return SimpleNamespace(module=module, args=SimpleNamespace(**args))


def test_coordinator_forces_fleet_path_over_vmap():
    """A coordinator (``-l``) never takes the in-process vmap GA
    shortcut, which would never bind the server its workers dial."""
    root.mnist.learning_rate = Tune(0.01, 0.001, 0.1)
    engine = PopulationEngine(_main(_module(),
                                    listen_address="127.0.0.1:0"), 2)
    assert engine.mode == "ga"
    assert engine._vmap_backend_applicable()
    called = []

    def fake_coordinator():
        called.append("coordinator")
        engine.master = SimpleNamespace(best=None)

    engine._run_coordinator = fake_coordinator
    engine._run_ga_vmap = lambda: called.append("vmap")
    engine._finish = lambda best: None
    engine.run()
    assert called == ["coordinator"]


def test_engine_coordinator_and_worker_over_a_socket(tmp_path):
    """``PopulationEngine`` as the coordinator (``-l 127.0.0.1:0``,
    which raises ``root.common.net.zero`` to 1) and as a worker
    (``-m``): the members end as trained alone, bit for bit, and the
    result file names the best."""
    module = _module()
    result = tmp_path / "pop.json"
    coordinator = PopulationEngine(
        _main(module, listen_address="127.0.0.1:0",
              result_file=str(result)), 2)
    thread = threading.Thread(target=coordinator.run,
                              name="test-coordinator")
    thread.start()
    for _ in range(600):
        if coordinator.server is not None:
            break
        threading.Event().wait(0.05)
    assert coordinator.server is not None
    assert root.common.net.zero == 1
    worker = PopulationEngine(
        _main(module, master_address="127.0.0.1:%d" %
              coordinator.server.port), 2)
    assert worker.run() is None
    joined(thread, 60)
    assert coordinator.master.should_stop_serving()
    for i, m in enumerate(coordinator.master.members):
        state, fitness = _alone(module, i)
        _assert_states_equal(state, _final_state(m.wf), m.member_id)
    data = json.loads(result.read_text())
    assert data["scheduling"] == "train"
    assert data["best_fitness"] == max(_alone(module, i)[1]
                                       for i in range(2))


def test_population_cli_end_to_end(tmp_path):
    """``--population 2`` through the command line: member training in
    the in-process loopback, its summary in the result file."""
    result = tmp_path / "pop.json"
    rc = Main([TMNIST, "root.mnist.max_epochs=1",
               "root.mnist.minibatch_size=200",
               "root.common.dirs.datasets=%r" % NO_DATASETS,
               "--population", "2", "--device", "cpu",
               "--result-file", str(result), "--random-seed", str(SEED),
               "-v", "warning"]).run()
    assert rc == 0
    data = json.loads(result.read_text())
    assert data["mode"] == "population"
    assert data["scheduling"] == "train" and data["size"] == 2
    assert set(data["summary"]["fitness"]) == {"m0", "m1"}
    assert data["best_fitness"] == pytest.approx(
        max(data["summary"]["fitness"].values()), abs=1e-6)


def test_override_scope_restores_exact_leaves():
    """Genes go on and come off by object: a Tune comes back, a leaf
    the scope made goes."""
    tune = Tune(0.1, 0.001, 0.5)
    root.ga_test.lr = tune
    root.ga_test.depth = 3
    with override_scope(root, {"ga_test.lr": 0.3,
                               "ga_test.fresh.leaf": 7}):
        assert root.ga_test.lr == 0.3
        assert root.ga_test.fresh.leaf == 7
        assert root.ga_test.depth == 3
    assert root.ga_test.lr is tune
    assert "leaf" not in root.ga_test.fresh.__dict__
