"""The port's parallel styles on ``torch.distributed`` (gloo on the CPU)
against the JAX package.

Every test here that starts ranks lives in this one file, so the
suite's ``--dist loadfile`` runs them one after another on one worker.
The ranks:

* start with the ``spawn`` method, run ``torch.set_num_threads(1)``
  and meet through a ``file://`` store in the test's ``tmp_path`` — no
  TCP port, except the command-line test, which must go through
  ``--jax-coordinator`` and retries once on a taken port;
* run one scripted session (:data:`SESSIONS`) and write their results
  to files; each joins by a deadline, after which every rank is killed
  and the test fails with their stderr;
* call ``destroy_process_group`` in ``finally``.

Every rank builds the port's TinyLM from one seed — its initial weights
equal the JAX package's bit for bit (``test_torch_training``) — applies
a style over a 2×2 (or 1×2×2) mesh and trains; the parent process runs
the JAX package's TinyLM from the same seed on one device, with no
mesh, and holds the port's parameters after each tick to it at float32
(``precision_level`` 1) within :data:`TOL`.  The JAX package's own
gates hold its 8-device styles to that replicated step
(``tests/test_transformer_tp.py``, ``test_moe_topk.py``,
``test_pipeline_schedules.py``, ``test_ring_flash.py``).  The JAX
package's trees, and the port's in this process, are put back whole
after each test.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

import numpy
import pytest
import torch

from test_torch_mesh import clean_roots  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: TinyLM geometry of every session (the JAX gates' sample, cut to 2
#: blocks, 16 sequences a minibatch).
GEOMETRY = dict(vocab_size=16, seq_len=32, embed_dim=32, n_heads=4,
                n_blocks=2, minibatch_size=16,
                loader_config={"n_train": 64, "n_valid": 16})
#: Parameters after each tick vs the JAX package's: float32 reduction
#: orders differ (an all-reduce over ranks vs one sum, the pipeline's
#: microbatch loop, the ring's merges), so each element is held within
#: rtol 2e-4 and atol 2e-5 — the tolerance of the JAX package's own
#: sharded-vs-replicated gates.  Losses within rel 1e-5.
TOL = dict(rtol=2e-4, atol=2e-5, loss=1e-5)
#: Ticks each session trains: a validation tick, then train ticks.
TICKS = 3
#: Seconds a session may take before its ranks are killed.
DEADLINE = 90


# -- the rank side ------------------------------------------------------------


def _port_lm(**kwargs):
    from veles_tpu_torch import prng
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.znicz.samples.tinylm import TinyLMWorkflow
    prng.reset()
    prng.get(0).seed(99)
    launcher = Launcher()
    wf = TinyLMWorkflow(launcher, **dict(GEOMETRY, **kwargs))
    launcher.initialize(device="cpu")
    return wf


def _params(wf):
    out = {}
    for u in wf.units:
        for attr, vec in getattr(u, "trainables", {}).items():
            vec.map_read()
            out["%s/%s" % (u.name, attr)] = numpy.array(vec.mem)
    return out


def _train(wf, ticks=TICKS):
    """Runs ``ticks`` loader ticks; returns the losses and the
    parameters after each."""
    losses, params = [], []
    for _ in range(ticks):
        wf.loader.run()
        losses.append(float(wf.step_metrics["loss"]))
        params.append(_params(wf))
    return {"losses": losses, "params": params}


def _held_shards(wf):
    """After one more tick: each placed parameter's (tensor shape the
    rank holds, its shard's shape, whether the Vector dropped its full
    tensor)."""
    wf.loader.run()
    compiler = wf.compiler
    mesh = wf.mesh
    out = {}
    for u in wf.units:
        for attr, vec in getattr(u, "trainables", {}).items():
            if not any(vec.placement or ()):
                continue
            name = "%s/%s" % (u.name, attr)
            shard = tuple(d // mesh.shape[a] if a else d
                          for d, a in zip(vec.shape, vec.placement))
            held = compiler._held.get(name)
            out[name] = (None if held is None else tuple(held.shape),
                         shard, vec.holder is compiler and
                         vec._devmem_ is None)
    return out


def _styled(style, **lm):
    """A TinyLM laid out in ``style`` over the world's ranks."""
    import veles_tpu_torch.parallel as par
    wf = _port_lm(**lm)
    axes, applier, kwargs = STYLES[style]
    applier = getattr(par, applier)
    applier(wf, par.make_mesh(None, axes), **kwargs)
    return wf


#: style → (mesh axes, applier, applier kwargs).
STYLES = {
    "dp": ({"data": 4}, "apply_dp_sharding", {}),
    "dp_tp": ({"data": 2, "model": 2}, "apply_dp_tp_sharding", {}),
    "dp_tp_sp": ({"data": 1, "model": 2, "seq": 2},
                 "apply_dp_tp_sp_sharding", {}),
    "dp_sp": ({"data": 2, "seq": 2}, "apply_dp_sp_sharding", {}),
    "dp_ep": ({"data": 2, "expert": 2}, "apply_dp_ep_sharding", {}),
    "dp_pp": ({"data": 2, "stage": 2}, "apply_dp_pp_sharding", {}),
    "dp_ep_tp": ({"data": 1, "expert": 2, "model": 2},
                 "apply_dp_ep_tp_sharding", {}),
    "dp_pp_tp": ({"data": 1, "stage": 2, "model": 2},
                 "apply_dp_pp_tp_sharding", {}),
}

#: case → (style, TinyLM kwargs, ZeRO level).  Each is also run by the
#: JAX package from the same seed (:func:`_jax_reference`).
CASES = {
    "dp": ("dp", {}, 0),
    "dp_tp_split": ("dp_tp", {}, 0),
    "dp_tp_fused": ("dp_tp", {"fused_qkv": True}, 0),
    "dp_tp_sp_ring": ("dp_tp_sp", {"seq_axis": "seq"}, 0),
    "dp_sp_ulysses": ("dp_sp", {"seq_axis": "seq", "sp_mode": "ulysses"},
                      0),
    "dp_ep_top2": ("dp_ep", {"n_experts": 4, "top_k": 2,
                             "expert_axis": "expert"}, 0),
    "dp_pp_1f1b": ("dp_pp", {"pipelined": True, "stage_axis": "stage",
                             "n_microbatches": 2, "schedule": "1f1b"},
                   0),
    "dp_pp_gpipe": ("dp_pp", {"pipelined": True, "stage_axis": "stage",
                              "n_microbatches": 2, "schedule": "gpipe"},
                    0),
    "dp_pp_interleaved": ("dp_pp", {"pipelined": True, "n_blocks": 4,
                                    "stage_axis": "stage",
                                    "n_microbatches": 2,
                                    "schedule": "interleaved",
                                    "n_chunks": 2}, 0),
    "dp_tp_moe": ("dp_tp", {"n_experts": 4}, 0),
    "dp_tp_pipelined": ("dp_tp", {"pipelined": True,
                                  "n_microbatches": 2}, 0),
    "dp_ep_tp": ("dp_ep_tp", {"n_experts": 4, "expert_axis": "expert"},
                 0),
    "dp_pp_tp_1f1b": ("dp_pp_tp", {"pipelined": True,
                                   "stage_axis": "stage",
                                   "n_microbatches": 2,
                                   "schedule": "1f1b"}, 0),
    "zero1": ("dp_tp", {}, 1),
    "zero2": ("dp", {}, 2),
}


def _session_styles(rank, world, out):
    """Every case of :data:`CASES` on a 4-rank world; rank 0 writes the
    losses and parameters, every rank checks that it holds the same
    parameters as rank 0."""
    import torch.distributed as dist
    from veles_tpu_torch.config import root
    import veles_tpu_torch.parallel as par
    root.common.engine.precision_level = 1
    results = {}
    for case, (style, lm, zero) in sorted(CASES.items()):
        wf = _styled(style, **lm)
        if zero:
            par.apply_zero_sharding(wf, level=zero)
        run = _train(wf)
        run["shards"] = _held_shards(wf)
        run["placements"] = {
            "%s/%s" % (u.name, a): v.placement
            for u in wf.units for which in ("trainables", "tstate")
            for a, v in (getattr(u, which, None) or {}).items()
            if isinstance(v, type(wf.loader.minibatch_mask))}
        mine = numpy.concatenate([a.ravel() for _, a in
                                  sorted(run["params"][-1].items())])
        ref = torch.from_numpy(mine.copy())
        dist.broadcast(ref, 0)
        run["same_on_ranks"] = bool(numpy.array_equal(ref.numpy(), mine))
        results[case] = run
    if rank == 0:
        with open(out, "wb") as fout:
            pickle.dump(results, fout)


def _session_topology(rank, world, out):
    """The cross-topology restore: train dp×tp 2×2 on four ranks, take a
    snapshot (``SnapshotterToFile``, each rank into its own directory),
    then restore it on the first two ranks as dp×tp 1×2 and on rank 0
    alone with no mesh, train on, and report what each restore saw."""
    import torch.distributed as dist
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    import veles_tpu_torch.parallel as par
    root.common.engine.precision_level = 1
    wf = _styled("dp_tp")
    _train(wf, 2)
    snap = SnapshotterToFile(
        wf, directory=os.path.join(os.path.dirname(out), "snap%d" % rank),
        prefix="lm", compression="", time_interval=0.0)
    snap.export()
    restored = SnapshotterToFile.import_(snap.destination)
    report = {"placement_after_restore":
              restored.forwards[1].params["wq"].placement,
              "mesh_after_restore": restored.mesh}
    if rank < 2:
        launcher = Launcher()
        launcher.add_ref(restored)
        launcher.initialize(device="cpu", snapshot=True)
        par.apply_dp_tp_sharding(restored,
                                 par.make_mesh([0, 1],
                                               {"data": 1, "model": 2}))
        report["two"] = _train(restored, 2)
    dist.barrier()
    if rank == 0:
        alone = SnapshotterToFile.import_(snap.destination)
        launcher = Launcher()
        launcher.add_ref(alone)
        launcher.initialize(device="cpu", snapshot=True)
        report["one"] = _train(alone, 2)
        with open(out, "wb") as fout:
            pickle.dump(report, fout)


#: The lost-rank sessions' TinyLM: 12 sequences a minibatch, so the
#: batch splits over 4 ranks and over the 3 survivors.
LOST = dict(minibatch_size=12)
#: Seconds the survivors' rebuild (or its refusal) may take.
REBUILD_SECONDS = 10.0


def _session_lost_rank(rank, world, out):
    """Rank 3 of four dies (``os._exit``) after three ticks of two
    TinyLMs: one under dp, one under dp with ZeRO-1 (slot shards held
    between ticks).  The survivors rebuild both over ranks 0-2 with no
    word from rank 3: the ZeRO one raises ``LostRankError``, the dp one
    re-forms, requeues its in-flight minibatch and trains three more
    ticks."""
    from veles_tpu_torch import resilience
    from veles_tpu_torch.config import root
    import veles_tpu_torch.parallel as par
    root.common.engine.precision_level = 1
    zero = _styled("dp", **LOST)
    par.apply_zero_sharding(zero, level=1)
    _train(zero, 2)
    wf = _styled("dp", **LOST)
    before = _train(wf)
    if rank == world - 1:
        sys.stderr.flush()
        os._exit(0)
    survivors = list(range(world - 1))
    report = {"held": list(zero.compiler._held)}
    start = time.monotonic()
    try:
        par.rebuild_mesh(zero, survivors)
    except resilience.LostRankError as e:
        report["zero_error"] = str(e)
    report["zero_seconds"] = time.monotonic() - start
    start = time.monotonic()
    par.rebuild_mesh(wf, survivors)
    report["requeued"] = len(wf.loader.failed_minibatches)
    report["dp_seconds"] = time.monotonic() - start
    report["mesh"] = wf.mesh.shape
    report["before"], report["after"] = before, _train(wf)
    if rank == 0:
        with open(out, "wb") as fout:
            pickle.dump(report, fout)


#: One case of each parallel family (tp, sp's ring, ep, pp, each over
#: dp) whose ticks run under each attribution mode: on with a peak
#: configured (the first tick of each geometry then runs under the FLOP
#: counter), off, and on without a peak.
ATTRIBUTION_CASES = ("dp_tp_split", "dp_tp_sp_ring", "dp_ep_top2",
                     "dp_pp_1f1b")
ATTRIBUTION_MODES = ((True, 1.0), (False, None), (True, None))


def _session_attribution(rank, world, out):
    """Each of :data:`ATTRIBUTION_CASES` trained from the same seed once
    per mode of :data:`ATTRIBUTION_MODES`; rank 0 writes the losses and
    parameters after each tick, and the mode's ``perf_summary``."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.observability import attribution
    root.common.engine.precision_level = 1
    results = {}
    for case in ATTRIBUTION_CASES:
        style, lm, _ = CASES[case]
        for on, peak in ATTRIBUTION_MODES:
            attribution.reset()
            root.common.observability.attribution = on
            root.common.observability.peak_tflops = peak
            run = _train(_styled(style, **lm))
            run["perf"] = attribution.perf_summary(wait=True)
            results[(case, on, peak)] = run
    if rank == 0:
        with open(out, "wb") as fout:
            pickle.dump(results, fout)


SESSIONS = {"styles": _session_styles, "topology": _session_topology,
            "lost_rank": _session_lost_rank,
            "attribution": _session_attribution}


def _rank_main(session, rank, world, store, out, err):
    fd = os.open(err, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        SESSIONS[session](rank, world, out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        # No collective: a lost-rank session's world has a dead member.
        dist.destroy_process_group()


# -- the parent side ----------------------------------------------------------


def _run_session(tmp_path, session, world=4, deadline=DEADLINE):
    """Starts ``world`` spawned ranks of ``session``; returns rank 0's
    results, or fails with every rank's stderr."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = str(tmp_path / ("%s.store" % session))
    out = str(tmp_path / ("%s.pkl" % session))
    errs = [str(tmp_path / ("%s.%d.err" % (session, r)))
            for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(session, r, world, store, out, errs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()

    def stderr():
        return "\n".join("--- rank %d ---\n%s" % (r, open(e).read()
                                                   if os.path.exists(e)
                                                   else "")
                         for r, e in enumerate(errs))
    if late:
        pytest.fail("session %r passed its %ds deadline; ranks killed\n%s"
                    % (session, deadline, stderr()))
    if any(p.exitcode for p in procs):
        pytest.fail("session %r: exit codes %s\n%s" % (
            session, [p.exitcode for p in procs], stderr()))
    with open(out, "rb") as fin:
        return pickle.load(fin)


@pytest.fixture
def kept_roots(clean_roots):
    """Both packages' config trees from a clean slate, put back whole
    after the test; yields the JAX package's root."""
    yield clean_roots[0]


_SESSION_CACHE = {}


@pytest.fixture
def styles_run(tmp_path_factory):
    """The "styles" session, run once for the tests that read it."""
    if "styles" not in _SESSION_CACHE:
        _SESSION_CACHE["styles"] = _run_session(
            tmp_path_factory.mktemp("styles"), "styles")
    return _SESSION_CACHE["styles"]


@pytest.fixture
def attribution_run(tmp_path_factory):
    """The "attribution" session, run once for the tests that read it."""
    if "attribution" not in _SESSION_CACHE:
        _SESSION_CACHE["attribution"] = _run_session(
            tmp_path_factory.mktemp("attribution"), "attribution")
    return _SESSION_CACHE["attribution"]


#: TinyLM kwargs that do not change the one-device function (the axes
#: and the schedule act only under a mesh): references are shared
#: across them.
MESH_ONLY = ("seq_axis", "sp_mode", "expert_axis", "stage_axis",
             "schedule", "n_chunks")
_JAX_CACHE = {}


def _jax_reference(jroot, lm, ticks=TICKS):
    """The JAX package's TinyLM from the same seed on one device:
    losses and parameters after each tick (computed once per distinct
    one-device model)."""
    lm = {k: v for k, v in lm.items() if k not in MESH_ONLY}
    key = tuple(sorted(lm.items()))
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = _jax_run(jroot, lm, ticks)
    return _JAX_CACHE[key]


def _jax_run(jroot, lm, ticks):
    import jax
    import veles_tpu.prng as jprng
    from veles_tpu.launcher import Launcher
    from veles_tpu.znicz.samples.tinylm import TinyLMWorkflow
    jroot.common.engine.precision_level = 1
    jprng.reset()
    jprng.get(0).seed(99)
    launcher = Launcher()
    wf = TinyLMWorkflow(launcher, **dict(GEOMETRY, **lm))
    launcher.initialize()
    losses, params = [], []
    for _ in range(ticks):
        wf.loader.run()
        losses.append(float(jax.device_get(wf.step_metrics["loss"])))
        params.append(_params(wf))
    jprng.reset()
    return {"losses": losses, "params": params}


def _assert_matches_jax(got, want, case):
    assert got["same_on_ranks"], "%s: ranks disagree" % case
    for tick, (g, w) in enumerate(zip(got["losses"], want["losses"])):
        assert g == pytest.approx(w, rel=TOL["loss"]), (case, tick)
    for tick, (g, w) in enumerate(zip(got["params"], want["params"])):
        assert sorted(g) == sorted(w)
        for name in w:
            numpy.testing.assert_allclose(
                g[name], w[name], rtol=TOL["rtol"], atol=TOL["atol"],
                err_msg="%s tick %d: %s" % (case, tick, name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_style_ticks_match_jax(case, styles_run, kept_roots):
    """Each style's ticks on a gloo world == the JAX package's ticks:
    dp 4, dp×tp 2×2 (split and fused qkv, the MoE and pipelined
    families), dp×tp×sp 1×2×2 (the ring on the flash chunk contract),
    dp×sp 2×2 (Ulysses), dp×ep 2×2 (top-2), dp×ep×tp 1×2×2, dp×pp 2×2
    (1F1B, GPipe, interleaved with 2 chunks), dp×pp×tp 1×2×2, ZeRO-1
    over dp×tp and ZeRO-2 over dp."""
    style, lm, zero = CASES[case]
    got = styles_run[case]
    _assert_matches_jax(got, _jax_reference(kept_roots, lm), case)
    # The style really split the work: every mesh axis but the data
    # axis (and the seq axis, which splits activations) places some
    # parameter, and ZeRO some slot.
    axes = set(STYLES[style][0]) - {"data", "seq"}
    placed = {a for p in got["placements"].values() for a in (p or ())
              if a is not None}
    assert axes <= placed, (case, placed)
    if zero:
        assert any(p and p[0] == "data"
                   for p in got["placements"].values()), case
    # Between ticks a rank keeps only its shard of each placed
    # parameter, as a sharded jax.Array holds only its shard.
    if axes & {"model", "expert", "stage"}:
        assert got["shards"], case
    for name, (held, shard, dropped) in got["shards"].items():
        assert held == shard and dropped, (case, name, held, shard)


@pytest.mark.parametrize("case", ATTRIBUTION_CASES)
def test_style_ticks_same_bits_with_attribution_on_off(case,
                                                        attribution_run):
    """A style's ticks on a gloo world give the same losses and the same
    parameters after every tick, bit for bit, with attribution on and a
    peak configured (the first tick of each geometry under the FLOP
    counter), off, and on without a peak; only the first published a
    dispatch span and an MFU, and the second published nothing."""
    runs = [attribution_run[(case,) + mode] for mode in ATTRIBUTION_MODES]
    first = runs[0]
    for run in runs[1:]:
        assert run["losses"] == first["losses"], case
        for tick, params in enumerate(run["params"]):
            for name, arr in params.items():
                assert numpy.array_equal(
                    arr, first["params"][tick][name]), (case, tick, name)
    # The MFU is published (rounded to 4 places, a loaded host's long
    # span may read 0.0 against the 1 TFLOP/s peak).
    assert first["perf"]["step_ms"] > 0 and "mfu" in first["perf"]
    assert first["perf"]["flops_per_dispatch"] > 0
    assert runs[1]["perf"] is None
    assert "mfu" not in runs[2]["perf"]


def test_cross_topology_restore(tmp_path, kept_roots):
    """A snapshot of a workflow trained under dp×tp on four ranks holds
    no mesh and no placement; restored on two ranks (dp×tp 1×2) and on
    one (no mesh) it trains on from the checkpointed weights, and both
    restores take the same first tick from them (the JAX package's
    ``test_cross_topology_snapshot_restore``, at 4 → 2 → 1)."""
    report = _run_session(tmp_path, "topology")
    assert report["placement_after_restore"] is None
    assert report["mesh_after_restore"] is None
    two, one = report["two"], report["one"]
    for run in (two, one):
        assert numpy.isfinite(run["losses"]).all()
    assert two["losses"][0] == pytest.approx(one["losses"][0], rel=1e-5)
    for name, arr in one["params"][0].items():
        numpy.testing.assert_allclose(two["params"][0][name], arr,
                                      rtol=TOL["rtol"], atol=TOL["atol"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_pair(tmp_path, port):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        argv = [sys.executable, "-m", "veles_tpu_torch",
                os.path.join(ROOT, "veles_tpu_torch", "znicz", "samples",
                             "tinylm.py"),
                "--device", "cpu", "--random-seed", "5",
                "--jax-coordinator", "127.0.0.1:%d" % port,
                "--jax-num-processes", "2", "--jax-process-id", str(rank),
                "--result-file", str(tmp_path / ("r%d.json" % rank)),
                "root.tinylm.max_epochs=2"]
        procs.append(subprocess.Popen(
            argv, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    end = time.monotonic() + DEADLINE
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail("the two CLI ranks passed their deadline")
    return [p.returncode for p in procs], outs


def test_cli_two_processes(tmp_path):
    """Two processes of the command line with ``--jax-coordinator`` /
    ``--jax-num-processes`` / ``--jax-process-id`` form a gloo world,
    train the TinyLM data-parallel and write the same results (one
    retry on a new port if the first was taken)."""
    import json
    codes, outs = _cli_pair(tmp_path, _free_port())
    if any(codes) and any("address already in use" in o.lower()
                          for o in outs):
        codes, outs = _cli_pair(tmp_path, _free_port())
    assert codes == [0, 0], "\n".join(outs)
    results = [json.load(open(str(tmp_path / ("r%d.json" % r))))
               for r in range(2)]
    assert results[0]["mode"] == "distributed"
    assert results[0]["results"] == results[1]["results"]
    assert results[0]["results"]["epochs"] == 2


def test_lost_rank_dp_survivors_reform_and_match_jax(tmp_path, kept_roots):
    """A rank of a 4-rank gloo world exits between ticks: the three
    survivors rebuild the dp TinyLM over themselves within
    :data:`REBUILD_SECONDS` without a word from the dead rank, requeue
    the in-flight minibatch and train on; their losses and parameters
    equal the JAX package's TinyLM laid out over 4 virtual devices and
    rebuilt over 3 (``rebuild_mesh(wf, jax.devices()[:3])``) within
    :data:`TOL`.  The same death under ZeRO-1, whose slot shards lived
    only on their ranks, raises ``LostRankError`` naming
    ``Launcher.resume_latest`` instead of waiting on the dead rank."""
    import jax
    import veles_tpu.prng as jprng
    import veles_tpu.parallel as jpar
    from veles_tpu.launcher import Launcher
    from veles_tpu.znicz.samples.tinylm import TinyLMWorkflow
    report = _run_session(tmp_path, "lost_rank")
    assert report["held"], "ZeRO-1 held no slot shard"
    assert "resume_latest" in report["zero_error"]
    assert report["zero_seconds"] < REBUILD_SECONDS
    assert report["dp_seconds"] < REBUILD_SECONDS
    assert report["mesh"] == {"data": 3}
    kept_roots.common.engine.precision_level = 1
    jprng.reset()
    jprng.get(0).seed(99)
    launcher = Launcher()
    wf = TinyLMWorkflow(launcher, **dict(GEOMETRY, **LOST))
    launcher.initialize()
    jpar.apply_dp_sharding(wf, jpar.make_mesh(jax.devices()[:4],
                                              {"data": 4}))

    def ticks():
        losses, params = [], []
        for _ in range(TICKS):
            wf.loader.run()
            losses.append(float(jax.device_get(wf.step_metrics["loss"])))
            params.append(_params(wf))
        return {"losses": losses, "params": params}

    before = ticks()
    jpar.rebuild_mesh(wf, jax.devices()[:3])
    assert len(wf.loader.failed_minibatches) == report["requeued"] == 1
    after = ticks()
    jprng.reset()
    for got, want in ((report["before"], before), (report["after"], after)):
        _assert_matches_jax(dict(got, same_on_ranks=True), want,
                            "lost rank")
