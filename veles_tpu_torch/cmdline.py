"""Command-line argument aggregation (the JAX package's ``cmdline``).

Any class built with the :class:`CommandLineArgumentsRegistry`
metaclass may declare a static ``init_parser(parser)`` hook, and every
module of :data:`CONTRIBUTING_MODULES` a module-level one;
:func:`init_argparser` folds the base options of
:class:`CommandLineBase` and every hook into one argparse tree, so the
subsystems (loaders, snapshots, the guardian, serving, attention, the
data plane, observability, …) contribute their own flags without the
entry point knowing them.

The flags of the JAX command line that the port does not parse are
listed in the help's epilog: :data:`NOT_PORTED` with the ROADMAP queue
that brings each, :data:`NO_COUNTERPART` with the reason there is none.
``--device`` (cuda or cpu) and ``--status-address`` are the port's own.
"""

import argparse
import importlib

#: Flags of the JAX command line that the port refuses, with the
#: ROADMAP queue that brings each.
NOT_PORTED = {"--frontend": "A8b-ii"}

#: Flags of the JAX command line that have no counterpart in the port,
#: with the reason.
NO_COUNTERPART = {
    "--attn-decode-kernel":
        "a CUDA tensor takes the decode kernels B4/B5 or raises, and "
        "there is no XLA decode to select",
}


class CommandLineArgumentsRegistry(type):
    """Metaclass collecting the classes that declare a static
    ``init_parser``."""

    classes = []

    def __init__(cls, name, bases, clsdict):
        super(CommandLineArgumentsRegistry, cls).__init__(
            name, bases, clsdict)
        init_parser = clsdict.get("init_parser")
        if init_parser is None:
            return
        if not isinstance(init_parser, staticmethod):
            raise TypeError(
                "%s.init_parser must be a staticmethod (it is collected "
                "by CommandLineArgumentsRegistry before instantiation)"
                % name)
        CommandLineArgumentsRegistry.classes.append(cls)


class SortedHelpFormatter(argparse.RawDescriptionHelpFormatter):
    """Lists the options alphabetically."""

    def add_arguments(self, actions):
        super(SortedHelpFormatter, self).add_arguments(
            sorted(actions, key=lambda a: a.dest))


class CommandLineBase(object):
    """The options every run understands; the subsystems' arrive
    through the registry and :data:`CONTRIBUTING_MODULES`."""

    DRY_RUN_CHOICES = ("load", "init", "exec", "no")
    LOG_LEVELS = ("debug", "info", "warning", "error")

    @staticmethod
    def init_parser(parser):
        parser.add_argument(
            "workflow", nargs="?", default="",
            help="path to the workflow module (a .py file defining "
                 "run(load, main)) or a dotted module name")
        parser.add_argument(
            "config", nargs="*", default=[],
            help="config file(s) executed with `root` in scope, and/or "
                 "root.path=value override assignments")
        parser.add_argument(
            "-c", "--config-list", nargs="*", default=[], metavar="FILE",
            help="additional config files (explicit form)")
        parser.add_argument(
            "-r", "--random-seed", default="", metavar="SPEC",
            help="seed of generator 0: an integer, or file:count:dtype")
        parser.add_argument(
            "--result-file", default="", metavar="FILE",
            help="write the run's metrics JSON here")
        parser.add_argument(
            "--max-epochs", type=int, default=None,
            help="override the decision's max_epochs")
        parser.add_argument(
            "-a", "--backend", "--device", dest="device", default="cuda",
            metavar="BACKEND",
            help="device of the run: cuda (the default) or auto, the "
                 "card, raising without one; cpu, the host "
                 "(backends.resolve_device)")
        parser.add_argument(
            "--dry-run", default="no",
            choices=CommandLineBase.DRY_RUN_CHOICES,
            help="stop after the given stage: load = construct only, "
                 "init = initialize only, exec = run but write no "
                 "results")
        parser.add_argument(
            "--workflow-graph", default="", metavar="FILE",
            help="write the control-flow graph (Graphviz DOT) here")
        parser.add_argument(
            "--dump-config", action="store_true",
            help="print the effective config tree before running")
        parser.add_argument(
            "--profile", default="", metavar="DIR",
            help="capture a torch.profiler trace of the whole run into "
                 "DIR")
        parser.add_argument(
            "--status-address", default="", metavar="HOST:PORT",
            help="post web-status heartbeats to the dashboard at "
                 "HOST:PORT (root.common.web.url; "
                 "python -m veles_tpu_torch.web_status)")
        parser.add_argument(
            "--jax-coordinator", default="", metavar="HOST:PORT",
            help="distributed run: the address every process meets at "
                 "(torch.distributed init_method tcp://HOST:PORT); each "
                 "process is one rank and the step is data-parallel over "
                 "the world (NCCL on the card, gloo with --device cpu)")
        parser.add_argument(
            "--jax-num-processes", type=int, default=0, metavar="N",
            help="distributed run: the number of processes (the world "
                 "size)")
        parser.add_argument(
            "--jax-process-id", type=int, default=0, metavar="I",
            help="distributed run: this process's rank")
        parser.add_argument(
            "-v", "--verbosity", default="info",
            choices=CommandLineBase.LOG_LEVELS, help="log level")
        parser.add_argument(
            "--optimize", default="", metavar="SIZE[:GENERATIONS]",
            help="genetic hyperparameter search over Tune() config "
                 "leaves with the given population size")
        parser.add_argument(
            "--ensemble-train", default="", metavar="N[:RATIO]",
            help="train an ensemble of N instances, each on RATIO of "
                 "the train set (default 1.0)")
        parser.add_argument(
            "--ensemble-test", default="", metavar="FILE",
            help="evaluate the ensemble described by FILE (written by "
                 "--ensemble-train)")
        parser.add_argument(
            "--chaos", default="", metavar="PLAN",
            help="deterministic fault-injection plan, e.g. "
                 "'net.drop@job:7,worker.kill@job:12,seed:42' "
                 "(resilience.FaultInjector)")
        parser.add_argument(
            "-l", "--listen-address", default="", metavar="HOST:PORT",
            help="run as the data plane's coordinator (master), "
                 "listening on HOST:PORT")
        parser.add_argument(
            "-m", "--master-address", default="", metavar="HOST:PORT",
            help="run as a worker (slave) of the coordinator at "
                 "HOST:PORT")
        parser.add_argument(
            "--blacklist-cooldown", type=float, default=None,
            metavar="SEC",
            help="blacklist parole: a worker machine blacklisted by the "
                 "job-timeout watchdog is re-admitted on probation (one "
                 "in-flight job until it completes clean) after this "
                 "many seconds (default 60; 0 = immediate probation)")
        parser.add_argument(
            "--nodes", default="", metavar="HOST[,HOST...]",
            help="with -l: spawn workers on these hosts over ssh "
                 "('local' spawns subprocesses on this machine); "
                 "dropped workers respawn the same way")
        return parser


#: Modules that contribute flags through a module-level
#: ``init_parser(parser)``, imported when the parser is built.
CONTRIBUTING_MODULES = (
    "veles_tpu_torch.client",
    "veles_tpu_torch.guardian",
    "veles_tpu_torch.loader.base",
    "veles_tpu_torch.network_common",
    "veles_tpu_torch.observability",
    "veles_tpu_torch.ops.attention",
    "veles_tpu_torch.ops.moe",
    "veles_tpu_torch.ops.pipeline",
    "veles_tpu_torch.population",
    "veles_tpu_torch.restful",
    "veles_tpu_torch.snapshotter",
    "veles_tpu_torch.znicz.optimizers",
)


def refused_epilog():
    """The help's list of the JAX flags the port does not parse."""
    lines = ["flags of the veles_tpu command line that the port refuses:"]
    for flag, queue in sorted(NOT_PORTED.items()):
        lines.append("  %s  not yet ported (ROADMAP %s)" % (flag, queue))
    for flag, reason in sorted(NO_COUNTERPART.items()):
        lines.append("  %s  no counterpart: %s" % (flag, reason))
    from .backends import NO_COUNTERPART as backends
    for name, reason in sorted(backends.items()):
        lines.append("  -a/--backend %s  no counterpart: %s" %
                     (name, reason))
    return "\n".join(lines)


def init_argparser(**kwargs):
    """The aggregated parser: the base options, the contributing
    modules' hooks and every registered class's ``init_parser``."""
    kwargs.setdefault("formatter_class", SortedHelpFormatter)
    kwargs.setdefault("description",
                      "Runs a workflow module of the PyTorch port.")
    kwargs.setdefault("epilog", refused_epilog())
    parser = argparse.ArgumentParser(**kwargs)
    CommandLineBase.init_parser(parser)
    for name in CONTRIBUTING_MODULES:
        importlib.import_module(name).init_parser(parser)
    seen = {CommandLineBase}
    for cls in CommandLineArgumentsRegistry.classes:
        if cls in seen:
            continue
        seen.add(cls)
        try:
            cls.init_parser(parser)
        except argparse.ArgumentError:
            # Two subsystems claiming one flag is a bug, but the command
            # line stays usable: the first registration wins.
            pass
    return parser
