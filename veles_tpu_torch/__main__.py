"""The port's command line: the local-mode subset of ``python -m
veles_tpu``.

Usage::

    python -m veles_tpu_torch path/to/workflow.py [config.py ...] \
        [root.x.y=v ...] [-c FILE ...] \
        [--random-seed N] [--result-file F] [--max-epochs N] \
        [--device cuda|cpu | -a cuda|cpu|auto] [-v debug|info|warning|error] \
        [--dry-run load|init|exec] [--workflow-graph FILE] [--dump-config] \
        [--profile DIR] [--status-address HOST:PORT] \
        [-s SNAPSHOT | --auto-resume] [--snapshot-dir DIR] \
        [--snapshot-compression ""|gz|bz2|xz] [--snapshot-keep K] \
        [--no-snapshots] [--snapshot-artifact] \
        [--guardian-policy off|skip|lr_backoff|rollback] \
        [--guardian-spike K] [--guardian-window N] \
        [--train-ratio R] [--shuffle-limit N] [--optimizer NAME] \
        [--attn-fused-qkv on|off] [--attn-dtype f32|bf16] \
        [--attn-kernel xla|pallas|auto] [--serve-* ...] \
        [--trace-out FILE [--trace-ring N]] [--xprof DIR [--xprof-steps N]] \
        [-l HOST:PORT [--nodes HOST,...] | -m HOST:PORT] \
        [--optimize SIZE[:GENERATIONS] | --population N[:GENERATIONS]
         [--pbt ...] [--population-vmap on|off] |
         --ensemble-train N[:RATIO] [--ensemble-population] |
         --ensemble-test FILE]

It seeds generator 0, applies the config files and ``root.x.y=v``
overrides in argv order (the positional ones, then ``-c``'s), then the
loader, snapshot, guardian, serving, attention and optimizer flags
(explicit flags win over config files),
imports the workflow module and calls its ``run(load, main)`` hook
with the numpy.random guard installed (``prng.poison_numpy_random``;
``root.common.engine.poison_numpy_random = False`` turns it off):
``load`` builds the workflow under a local
:class:`~veles_tpu_torch.launcher.Launcher` — or resumes it from a
snapshot (``-s`` a blob, a ``*_current.lnk`` pointer or a
``sqlite://`` database; ``--auto-resume`` the newest verified
generation in the snapshot directory) — and ``main`` initializes it
on the device (the CUDA card unless ``--device cpu``), runs it and
writes the results JSON.  The ``--serve-*`` flags configure an in-workflow
:class:`~veles_tpu_torch.restful.RESTfulAPI` unit through
``root.common.serving``, the serving fabric's replicas, disaggregated
prefill and tenants included.  ``--trace-out`` turns span tracing on
(the master or standalone launcher writes the Chrome trace at the end
of the run) and ``--xprof`` arms a ``torch.profiler`` capture window
around the next ``--xprof-steps`` dispatches.  The meta-workflow modes run in this process
instead of the plain run: ``--optimize`` (the genetic search over
``Tune()`` leaves, :mod:`.genetics`), ``--population`` (a GA
population, one vmapped device job per generation, :mod:`.population`),
``--ensemble-train`` and ``--ensemble-test`` (:mod:`.ensemble`).
``-l HOST:PORT`` makes the process the data plane's coordinator and
``-m HOST:PORT`` one of its workers (with the ``--net-*``,
``--job-ticks``, ``--async-slave``, ``--reconnect-*``,
``--preempt-grace``, ``--slave-death-probability``, ``--measure-power``,
``--blacklist-cooldown`` and ``--chaos`` flags); ``--nodes`` with ``-l``
spawns the workers (``local`` a subprocess of this machine, any other
host through ssh) with the worker's half of this command line, and
respawns a dropped one.  ``--population`` and ``--pbt`` schedule
population members as lineages over the fleet (``-l``/``-m``, or an
in-process loopback), ``--ensemble-population`` routes
``--ensemble-train`` through them.  The three ``--jax-*`` flags make
the process one rank of a ``torch.distributed`` world.

The parser is :func:`cmdline.init_argparser`'s: the base options and
every subsystem's own.  ``-a``/``--backend``/``--device`` picks the
device by backend name (``backends.resolve_device``: ``cuda``, the
default, and ``auto`` are the card and raise without one; ``cpu`` is
the host); ``--dry-run load`` stops after the workflow is built,
``init`` after it is initialized, ``exec`` after the run (no results
file); ``--workflow-graph`` writes the control graph as DOT after
initialize; ``--dump-config`` prints the config tree before the run;
``--profile DIR`` writes a ``torch.profiler`` trace of the whole
``launcher.run`` into DIR; ``--status-address`` points the launcher's
web-status heartbeats at a dashboard (``root.common.web.url``).  The
JAX flags the port does not parse raise by name: ``--frontend`` names
its ROADMAP queue (:data:`NOT_PORTED`), ``--attn-decode-kernel`` the
reason it has no counterpart (:data:`NO_COUNTERPART`).
"""

import importlib
import importlib.util
import logging
import os
import sys

from . import network_common, observability, prng, snapshotter
from .cmdline import NOT_PORTED, NO_COUNTERPART, init_argparser
from .config import Tune, root
from .error import Bug
from .json_encoders import dump_json
from .launcher import Launcher
from .logger import Logger


def make_parser():
    """The command line's parser (:func:`cmdline.init_argparser`)."""
    return init_argparser(prog="veles_tpu_torch")


def import_workflow_module(spec):
    """Imports a workflow module from a ``.py`` path (by its package
    name when it sits in a package, so relative imports work) or a
    dotted name."""
    if not spec.endswith(".py"):
        return importlib.import_module(spec)
    path = os.path.abspath(spec)
    if not os.path.isfile(path):
        raise FileNotFoundError("workflow module not found: %s" % spec)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    parent = os.path.dirname(path)
    while os.path.isfile(os.path.join(parent, "__init__.py")):
        parts.insert(0, os.path.basename(parent))
        parent = os.path.dirname(parent)
    if len(parts) > 1:
        if parent not in sys.path:
            sys.path.insert(0, parent)
        return importlib.import_module(".".join(parts))
    mod_name = "veles_tpu_torch_workflow_" + parts[0]
    spec_obj = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec_obj)
    sys.modules[mod_name] = module
    spec_obj.loader.exec_module(module)
    return module


def apply_config_sources(sources, logger=None):
    """Applies config files and ``root.x=y`` override assignments in
    order, each executed with ``root`` and ``Tune`` in scope; a source
    that is neither raises :class:`~veles_tpu_torch.error.Bug`."""
    for src in sources:
        if "=" in src and src.lstrip().startswith("root."):
            code, origin = src, "<override>"
        elif os.path.isfile(src):
            with open(src) as fin:
                code = fin.read()
            origin = src
        else:
            raise Bug("config source %r is neither a root.x=y override "
                      "nor an existing file" % src)
        if logger is not None:
            logger.debug("applying config source %s", origin)
        exec(compile(code, origin, "exec"), {"root": root, "Tune": Tune})


class Main(Logger):
    """The command-line driver."""

    EXIT_SUCCESS = 0
    EXIT_FAILURE = 1

    def __init__(self, argv=None):
        super(Main, self).__init__()
        self.argv = list(sys.argv[1:] if argv is None else argv)
        self.args = None
        self.launcher = None
        self.workflow = None
        self.module = None
        self._snapshot_loaded = False
        self.profile_trace = None

    def parse(self):
        for arg in self.argv:
            flag = arg.split("=", 1)[0]
            if flag in NOT_PORTED:
                raise NotImplementedError(
                    "%s of the veles_tpu command line is not yet ported "
                    "(ROADMAP %s)" % (flag, NOT_PORTED[flag]))
            if flag in NO_COUNTERPART:
                raise NotImplementedError(
                    "%s of the veles_tpu command line has no counterpart "
                    "in the port: %s" % (flag, NO_COUNTERPART[flag]))
        self.args = make_parser().parse_intermixed_args(self.argv)
        logging.getLogger().setLevel(self.args.verbosity.upper())
        return self.args

    def seed_random(self):
        spec = self.args.random_seed
        if not spec:
            return
        try:
            seed = int(spec)
        except ValueError:
            seed = spec  # file:count:dtype
        prng.get(0).seed(seed)

    def apply_subsystem_flags(self):
        """Feeds the loader, snapshot, guardian, serving, attention and
        optimizer flags into the configuration tree, at the keys the
        JAX command line sets, where the units read them back."""
        args = self.args
        if args.train_ratio is not None:
            root.common.loader.train_ratio = args.train_ratio
        if args.shuffle_limit is not None:
            root.common.loader.shuffle_limit = args.shuffle_limit
        if args.snapshot_dir is not None:
            root.common.dirs.snapshots = args.snapshot_dir
        if args.snapshot_compression is not None:
            root.common.snapshotter.compression = \
                args.snapshot_compression
        if args.snapshot_keep is not None:
            root.common.snapshotter.keep = args.snapshot_keep
        if args.no_snapshots:
            root.common.snapshot_disabled = True
        if args.snapshot_artifact:
            root.common.snapshotter.artifact = True
        if args.guardian_policy is not None:
            root.common.guardian.policy = args.guardian_policy
        if args.guardian_spike is not None:
            root.common.guardian.spike_factor = args.guardian_spike
        if args.guardian_window is not None:
            root.common.guardian.window = args.guardian_window
        serving = root.common.serving
        for key in ("max_batch", "queue_depth", "rate_limit", "deadline",
                    "token", "kv_blocks", "kv_block_size", "kv_dtype",
                    "weight_dtype", "spec_draft", "spec_max_k",
                    "spec_draft_blocks", "drain_timeout", "reload_watch",
                    "reload_poll"):
            value = getattr(args, "serve_" + key)
            if value is not None:
                setattr(serving, key, value)
        if args.serve_warmup:
            serving.warmup = True
        if args.serve_no_paged:
            serving.paged = False
        if args.serve_spec:
            serving.spec = True
        if args.serve_fabric_replicas is not None:
            serving.fabric_replicas = args.serve_fabric_replicas
        if args.serve_fabric_disagg:
            serving.fabric_disagg = True
        if args.serve_tenant:
            serving.tenant = list(args.serve_tenant)
        # --trace-out arms span tracing (the launcher exports at the end
        # of the run; workers turn theirs on through the handshake),
        # --xprof the capture window around the next N dispatches.
        if args.trace_out:
            root.common.observability.trace_out = args.trace_out
            root.common.observability.trace = True
            observability.tracing.enable(ring=args.trace_ring)
        if args.xprof:
            root.common.observability.xprof = args.xprof
            observability.attribution.configure_xprof(args.xprof,
                                                      args.xprof_steps)
        engine = root.common.engine
        if args.attn_fused_qkv is not None:
            engine.fused_qkv = args.attn_fused_qkv == "on"
        if args.attn_dtype is not None:
            engine.attention_dtype = args.attn_dtype
        if args.attn_kernel is not None:
            engine.attention_kernel = args.attn_kernel
        if args.optimizer is not None:
            engine.optimizer = args.optimizer
        if args.zero is not None:
            engine.zero = args.zero
        if args.sp_ring_kernel is not None:
            engine.sp_ring_kernel = args.sp_ring_kernel
        if args.pp_schedule is not None:
            engine.pp_schedule = args.pp_schedule
        if args.pp_chunks is not None:
            engine.pp_chunks = args.pp_chunks
        if args.moe_topk is not None:
            engine.moe_top_k = args.moe_topk
        if args.moe_router_z is not None:
            engine.moe_router_z = args.moe_router_z
        if args.blacklist_cooldown is not None:
            root.common.server.blacklist_cooldown = args.blacklist_cooldown
        if args.status_address:
            root.common.web.url = args.status_address
        pop_cfg = root.common.population
        if args.pbt_interval is not None:
            pop_cfg.pbt_interval = args.pbt_interval
        if args.pbt_quantile is not None:
            pop_cfg.pbt_quantile = args.pbt_quantile
        if args.pbt_perturb is not None:
            pop_cfg.pbt_perturb = args.pbt_perturb
        if args.population_vmap is not None:
            pop_cfg.vmap = args.population_vmap == "on"
        # The data plane's knobs, read back by the handshake's
        # negotiation and the channels.
        net = root.common.net
        if args.net_codec is not None:
            name, level, threshold = network_common.parse_codec_spec(
                args.net_codec)
            net.codec = name
            if level is not None:
                net.codec_level = level
            if threshold is not None:
                net.codec_threshold = threshold
        if args.net_dtype is not None:
            net.dtype = args.net_dtype
        if args.job_ticks is not None:
            if args.job_ticks < 1:
                raise Bug("--job-ticks must be >= 1 (got %d)"
                          % args.job_ticks)
            net.job_ticks = args.job_ticks
        if args.net_zero is not None:
            if args.net_zero < 0:
                raise Bug("--net-zero must be >= 0 (got %d)"
                          % args.net_zero)
            net.zero = args.net_zero
        if args.net_legacy:
            net.mode = "legacy"
        if args.net_require:
            net.require = True

    def _filtered_worker_argv(self):
        """The command line a spawned worker runs, rebuilt from the
        parsed arguments (so no abbreviation of a coordinator flag
        reaches it): the workflow, its config sources, the seed, the
        device, and the flags a worker shares with its master; ``-m
        {master}`` last."""
        a = self.args
        out = [a.workflow] + list(a.config)
        for path in a.config_list:
            out += ["-c", path]
        if a.random_seed:
            out += ["--random-seed", a.random_seed]
        out += ["--device", a.device]
        if a.verbosity != "info":
            out += ["-v", a.verbosity]
        if a.max_epochs:
            out += ["--max-epochs", str(a.max_epochs)]
        if a.async_slave:
            out.append("--async-slave")
        if a.slave_death_probability:
            out += ["--slave-death-probability",
                    str(a.slave_death_probability)]
        if a.measure_power:
            out.append("--measure-power")
        for key in ("reconnect_attempts", "reconnect_delay",
                    "preempt_grace"):
            if getattr(a, key) is not None:
                out += ["--" + key.replace("_", "-"),
                        str(getattr(a, key))]
        if a.chaos:
            # Each process's rules fire off its own counters, so the
            # combined failure schedule stays reproducible.
            out += ["--chaos", a.chaos]
        if a.train_ratio is not None:
            out += ["--train-ratio", str(a.train_ratio)]
        if a.shuffle_limit is not None:
            out += ["--shuffle-limit", str(a.shuffle_limit)]
        # The handshake negotiates over matching preferences.
        if a.net_codec is not None:
            out += ["--net-codec", a.net_codec]
        if a.net_dtype is not None:
            out += ["--net-dtype", a.net_dtype]
        if a.net_legacy:
            out.append("--net-legacy")
        if a.net_zero is not None:
            out += ["--net-zero", str(a.net_zero)]
        if a.optimizer is not None:
            # The same GD units (slot shapes) as the master's.
            out += ["--optimizer", a.optimizer]
        return out + ["-m", "{master}"]

    def _data_plane_kwargs(self):
        """The launcher's master (``-l``, with the workers it spawns on
        ``--nodes``) or worker (``-m``) mode, the worker's client
        options and the chaos plan."""
        args = self.args
        kw = {}
        if args.chaos:
            kw["chaos"] = args.chaos
        if args.listen_address:
            kw["listen_address"] = args.listen_address
            nodes = [n.strip() for n in args.nodes.split(",")
                     if n.strip()]
            if nodes:
                kw["nodes"] = nodes
                kw["worker_argv"] = self._filtered_worker_argv()
        if args.master_address:
            kw["master_address"] = args.master_address
            slave = {}
            if args.async_slave:
                slave["async_mode"] = True
            if args.slave_death_probability:
                slave["death_probability"] = args.slave_death_probability
                # A worker of the command line really dies (its
                # supervisor or the master's respawn hook restarts it).
                slave["death_exits"] = True
            if args.measure_power:
                slave["measure_power"] = True
            for key in ("reconnect_attempts", "reconnect_delay",
                        "preempt_grace"):
                if getattr(args, key) is not None:
                    slave[key] = getattr(args, key)
            if args.net_legacy:
                slave["net_legacy"] = True
            if slave:
                kw["slave_kwargs"] = slave
        return kw

    def _launcher_kwargs(self):
        """The launcher's mode: master or worker of the data plane
        (``-l``, ``-m``), or distributed when the three ``--jax-*``
        flags are given together (a partial set raises).  Unlike the
        JAX command line, a world of one process is allowed: on the
        card it is a one-rank NCCL world."""
        args = self.args
        kw = self._data_plane_kwargs()
        if not (args.jax_coordinator or args.jax_num_processes or
                args.jax_process_id):
            return kw
        if not (args.jax_coordinator and args.jax_num_processes >= 1 and
                0 <= args.jax_process_id < args.jax_num_processes):
            raise Bug(
                "--jax-coordinator, --jax-num-processes (>=1) and a "
                "--jax-process-id in [0, N) must be given together (got "
                "coordinator=%r, num_processes=%r, process_id=%r)" % (
                    args.jax_coordinator, args.jax_num_processes,
                    args.jax_process_id))
        return dict(kw, mode="distributed",
                    coordinator_address=args.jax_coordinator,
                    num_processes=args.jax_num_processes,
                    process_id=args.jax_process_id)

    def load(self, WorkflowClass, **kwargs):
        """The ``load`` closure of the module's ``run`` hook: builds the
        launcher, then resumes a snapshot or constructs the
        workflow."""
        kwargs.setdefault("result_file", self.args.result_file or None)
        self.launcher = Launcher(**self._launcher_kwargs())
        if self.args.snapshot:
            spec = self.args.snapshot
            if spec.startswith(("odbc://", "sqlite://", "db://")):
                self.workflow = snapshotter.SnapshotterToDB.import_(spec)
            else:
                self.workflow = snapshotter.SnapshotterToFile.import_(spec)
            self._snapshot_loaded = True
            self.launcher.add_ref(self.workflow)
            self.info("resumed snapshot %s (%s)", spec,
                      type(self.workflow).__name__)
        elif self.args.auto_resume and self.launcher.resume_latest(
                expect_class=WorkflowClass) is not None:
            self.workflow = self.launcher.workflow
            self._snapshot_loaded = True
        else:
            self.workflow = WorkflowClass(self.launcher, **kwargs)
        if self.args.max_epochs:
            decision = getattr(self.workflow, "decision", None)
            if decision is None:
                raise Bug("--max-epochs given but the workflow has no "
                          "decision unit")
            decision.max_epochs = int(self.args.max_epochs)
        return self.workflow, self._snapshot_loaded

    def main(self, **kwargs):
        """The ``main`` closure: initialize → run → results, each stage
        but the first skipped by ``--dry-run``."""
        if self.workflow is None:
            raise Bug("main() called before load()")
        if self.args.dry_run == "load":
            return
        kwargs.setdefault("device", self.args.device)
        self.launcher.initialize(snapshot=self._snapshot_loaded,
                                 **kwargs)
        if self.args.workflow_graph:
            self.workflow.generate_graph(self.args.workflow_graph)
            self.info("workflow graph -> %s", self.args.workflow_graph)
        if self.args.dry_run == "init":
            self.launcher.stop_heartbeats()
            return
        if self.args.profile:
            self.profile_run(self.args.profile)
        else:
            self.launcher.run()
        if self.args.dry_run == "exec":
            return
        self.write_results()

    def profile_run(self, directory):
        """``launcher.run`` under ``torch.profiler`` (the host and, on
        the card, CUDA activity); the Chrome trace goes to
        ``directory/trace_<pid>_<ms>.json``, its path to
        :attr:`profile_trace`."""
        import time
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.launcher.device.torch_device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(directory, exist_ok=True)
        with profile(activities=activities) as prof:
            try:
                self.launcher.run()
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
        self.profile_trace = os.path.join(directory, "trace_%d_%d.json" % (
            os.getpid(), int(time.time() * 1000)))
        prof.export_chrome_trace(self.profile_trace)
        self.info("profiler trace -> %s", self.profile_trace)

    # -- the meta-workflow modes -------------------------------------------

    @staticmethod
    def _size_spec(spec, default_tail=None, tail_type=int):
        """``N[:TAIL]`` → (N, TAIL)."""
        if ":" in spec:
            head, tail = spec.split(":", 1)
            return int(head), tail_type(tail)
        return int(spec), default_tail

    def run_genetics(self):
        from .genetics.optimizer import GeneticsOptimizer
        size, generations = self._size_spec(self.args.optimize)
        GeneticsOptimizer(main=self, size=size,
                          generations=generations).run()

    def run_ensemble_train(self):
        from .ensemble import EnsembleTrainer
        n, ratio = self._size_spec(self.args.ensemble_train, 1.0, float)
        EnsembleTrainer(main=self, instances=n, train_ratio=ratio).run()

    def run_population(self):
        from .population import PopulationEngine
        size, generations = self._size_spec(self.args.population or "2")
        PopulationEngine(main=self, size=size, generations=generations,
                         mode="pbt" if self.args.pbt else None).run()

    def run_ensemble_test(self):
        from .ensemble import EnsembleTester
        EnsembleTester(main=self,
                       ensemble_file=self.args.ensemble_test).run()

    def write_results(self):
        path = self.args.result_file
        if not path:
            return
        dump_json({
            "workflow": self.workflow.name,
            "class": type(self.workflow).__name__,
            "checksum": self.workflow.checksum,
            "mode": self.launcher.mode,
            "device": self.launcher.device.backend_name,
            "seed": repr(prng.get(0).seed_value),
            "runtime": self.launcher.runtime,
            "units": len(self.workflow.units),
            "results": self.workflow.gather_results(),
        }, path)
        self.info("results -> %s", path)

    def run(self):
        if not logging.getLogger().handlers:
            logging.basicConfig(
                format="%(asctime)s %(levelname).1s %(name)s: "
                       "%(message)s", datefmt="%H:%M:%S")
        self.parse()
        if not self.args.workflow:
            make_parser().print_help()
            return self.EXIT_FAILURE
        self.seed_random()
        apply_config_sources(
            list(self.args.config) + list(self.args.config_list),
            logger=self)
        # Explicit flags win over config-file assignments.
        self.apply_subsystem_flags()
        self.module = import_workflow_module(self.args.workflow)
        if self.args.dump_config:
            root.print_()
        run_hook = getattr(self.module, "run", None)
        if run_hook is None:
            raise Bug("workflow module %s has no run(load, main) hook"
                      % self.module.__name__)
        guard = bool(root.common.engine.get("poison_numpy_random", True))
        if guard:
            prng.guard_path(os.path.dirname(os.path.abspath(
                self.module.__file__)))
            prng.poison_numpy_random()
        try:
            if self.args.population or self.args.pbt:
                self.run_population()
            elif self.args.optimize:
                self.run_genetics()
            elif self.args.ensemble_train:
                self.run_ensemble_train()
            elif self.args.ensemble_test:
                self.run_ensemble_test()
            else:
                run_hook(self.load, self.main)
        except KeyboardInterrupt:
            self.warning("interrupted")
            if self.launcher is not None:
                self.launcher.stop()
            return self.EXIT_FAILURE
        finally:
            if guard:
                prng.unpoison_numpy_random()
        return self.EXIT_SUCCESS


def main(argv=None):
    return Main(argv).run()


if __name__ == "__main__":
    sys.exit(main())
