"""The port's command-line aggregation (``veles_tpu_torch.cmdline``), the
flags it took over from ``NOT_PORTED`` (``-a``/``--backend``,
``--dry-run``, ``--workflow-graph``, ``--dump-config``, ``--profile``,
with ``--status-address``), the backend registry and computing power
(``backends``), ``Workflow.generate_graph``, ``Config.print_`` and the
event timeline (``logger``), against the JAX package's, on the CPU.

Parity: the same workflow gives the same DOT text; the same config tree
gives the same ``print_`` text; ``Logger.event`` gives records with the
same fields; the help of both parsers lists every subsystem flag of the
JAX package's ``test_platform_polish.py::test_subsystem_flags_in_help``.
The counterparts of ``test_cli.py::test_dry_run_init_skips_training``
and ``test_workflow.py::test_generate_graph_dot`` run on the port.
``-a auto`` on a machine without a card raises ``DeviceNotFoundError``:
it never carries on on the CPU.
"""

import argparse
import io
import json
import logging
import os

import pytest
import torch

from veles_tpu_torch import __main__ as tmain
from veles_tpu_torch import backends, cmdline
from veles_tpu_torch import logger as tlogger
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.error import DeviceNotFoundError

from test_torch_network import kept_process_state, write_mnist_idx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "veles_tpu_torch", "znicz", "samples",
                     "mnist.py")


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        yield


@pytest.fixture
def mnist_argv(tmp_path):
    """A port MNIST command line on synthetic IDX files, on the CPU."""
    write_mnist_idx(str(tmp_path))
    return [MNIST, "root.mnist.max_epochs=2", "root.mnist.layers=(16, 10)",
            "root.common.dirs.datasets=%r" % str(tmp_path),
            "--device", "cpu", "-v", "warning", "--random-seed", "5"]


# -- the parser ---------------------------------------------------------------


@pytest.mark.parametrize("flag", [
    "--async-slave", "--slave-death-probability", "--measure-power",
    "--train-ratio", "--shuffle-limit", "--snapshot-dir", "--no-snapshots",
    "--nodes"])
def test_subsystem_flags_in_help(flag):
    """Every flag of the JAX package's help test is in the port's help
    (and in the JAX package's, as that test holds)."""
    from veles_tpu.cmdline import init_argparser as jax_parser
    assert flag in cmdline.init_argparser(prog="x").format_help()
    assert flag in jax_parser(prog="x").format_help()


def test_help_lists_every_jax_flag():
    """Each option of the JAX parser is in the port's help: parsed, or
    named in the epilog with its queue or reason."""
    from veles_tpu.cmdline import init_argparser as jax_parser
    text = tmain.make_parser().format_help()
    options = {s for a in jax_parser(prog="x")._actions
               for s in a.option_strings}
    assert sorted(o for o in options if o not in text) == []
    assert "--frontend  not yet ported (ROADMAP A8b-ii)" in text
    assert "-a/--backend tpu  no counterpart" in text
    assert "--attn-decode-kernel  no counterpart" in text


def test_registry_collects_static_init_parser():
    before = list(cmdline.CommandLineArgumentsRegistry.classes)
    try:
        class Extra(metaclass=cmdline.CommandLineArgumentsRegistry):
            @staticmethod
            def init_parser(parser):
                parser.add_argument("--extra-knob", default="x")

        class Clash(metaclass=cmdline.CommandLineArgumentsRegistry):
            @staticmethod
            def init_parser(parser):
                parser.add_argument("--device")  # the base's: ignored

        assert cmdline.CommandLineArgumentsRegistry.classes[-2:] == \
            [Extra, Clash]
        args = cmdline.init_argparser().parse_args(["--extra-knob", "y"])
        assert args.extra_knob == "y" and args.device == "cuda"
        with pytest.raises(TypeError, match="staticmethod"):
            class Bad(metaclass=cmdline.CommandLineArgumentsRegistry):
                def init_parser(parser):
                    pass
    finally:
        cmdline.CommandLineArgumentsRegistry.classes[:] = before


def test_help_lists_options_by_dest():
    text = tmain.make_parser().format_help()
    order = [text.index(flag) for flag in ("  -a BACKEND",
                                           "  --dry-run",
                                           "  --workflow-graph")]
    assert order == sorted(order)


def test_no_workflow_prints_help(capsys):
    assert tmain.Main([]).run() == tmain.Main.EXIT_FAILURE
    assert "--workflow-graph" in capsys.readouterr().out


def test_frontend_stays_refused_naming_a8b_ii():
    with pytest.raises(NotImplementedError, match="A8b-ii"):
        tmain.Main(["wf.py", "--frontend"]).parse()


# -- backends ----------------------------------------------------------------


def test_backend_registry_and_create():
    assert backends.BackendRegistry.backends["cuda"] is backends.CUDADevice
    assert backends.BackendRegistry.backends["cpu"] is backends.CPUDevice
    dev = backends.Device.create("cpu")
    assert isinstance(dev, backends.CPUDevice)
    assert dev.torch_device == torch.device("cpu")
    assert dev.backend_name == "cpu" and dev.device_kind == "cpu"
    with pytest.raises(DeviceNotFoundError, match="no counterpart"):
        backends.Device.create("tpu")
    with pytest.raises(DeviceNotFoundError, match="unknown device"):
        backends.Device.create("opencl")
    dev = backends.resolve_device("cpu")
    assert backends.resolve_device(dev) is dev


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["auto", ""])
def test_auto_without_a_card_raises(name):
    with pytest.raises(DeviceNotFoundError, match="CUDA card"):
        backends.Device.create(name)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_backend_auto_without_a_card_raises(mnist_argv):
    argv = [a for a in mnist_argv if a not in ("--device", "cpu")]
    with pytest.raises(DeviceNotFoundError):
        tmain.Main(argv + ["-a", "auto"]).run()


@pytest.mark.parametrize("flag", ["-a", "--backend", "--device"])
def test_device_flags_are_one_option(flag):
    """``-a``, ``--backend`` and ``--device`` set one ``device``; the
    default is the card."""
    assert tmain.Main(["wf.py"]).parse().device == "cuda"
    args = tmain.Main(["wf.py", flag, "cpu"]).parse()
    assert args.device == "cpu" and not hasattr(args, "backend")


def test_compute_power_is_cached_by_card_name(tmp_path, monkeypatch):
    troot.common.dirs.cache = str(tmp_path / "cache")
    calls = []
    monkeypatch.setattr(backends.Device, "measure_power",
                        lambda self: calls.append(1) or 123.5)
    assert backends.Device.create("cpu").compute_power == 123.5
    assert backends.Device.create("cpu").compute_power == 123.5
    assert len(calls) == 1
    with open(tmp_path / "cache" / "device_power.json") as fin:
        assert json.load(fin) == {"cpu:cpu": 123.5}


def test_measure_power_uses_the_client_gemm(monkeypatch):
    from veles_tpu_torch import client
    seen = []
    monkeypatch.setattr(client, "measure_computing_power",
                        lambda device=None: seen.append(device) or 7.0)
    assert backends.Device.create("cpu").measure_power() == 7.0
    assert seen == [torch.device("cpu")]


# -- the flags ---------------------------------------------------------------


def test_dry_run_init_skips_training(mnist_argv, tmp_path):
    result, graph = tmp_path / "res.json", tmp_path / "graph.dot"
    main = tmain.Main(mnist_argv + ["--dry-run", "init", "--result-file",
                                    str(result), "--workflow-graph",
                                    str(graph)])
    assert main.run() == 0
    assert not result.exists()
    text = graph.read_text()
    assert text.startswith("digraph") and "fc0" in text
    assert text == main.workflow.generate_graph(write_on_disk=False)
    assert main.workflow.decision.epoch_number == 0


def test_dry_run_load_builds_only(mnist_argv):
    main = tmain.Main(mnist_argv + ["--dry-run", "load"])
    assert main.run() == 0
    assert main.workflow is not None and main.launcher.device is None


def test_dry_run_exec_runs_but_writes_no_results(mnist_argv, tmp_path):
    result = tmp_path / "res.json"
    main = tmain.Main(mnist_argv + ["--dry-run", "exec", "--result-file",
                                    str(result)])
    assert main.run() == 0
    assert main.workflow.decision.epoch_number == 2
    assert not result.exists()


def test_backend_flag_picks_the_device(mnist_argv, tmp_path):
    argv = [a for a in mnist_argv if a not in ("--device", "cpu")]
    result = tmp_path / "res.json"
    main = tmain.Main(argv + ["-a", "cpu", "--result-file", str(result)])
    assert main.run() == 0
    assert isinstance(main.launcher.device, backends.CPUDevice)
    with open(result) as fin:
        assert json.load(fin)["device"] == "cpu"
    worker = main._filtered_worker_argv()
    assert worker[worker.index("--device") + 1] == "cpu"
    assert "-a" not in worker and "--backend" not in worker


def test_dump_config_prints_the_tree(mnist_argv, capsys):
    assert tmain.Main(mnist_argv + ["--dry-run", "load",
                                    "--dump-config"]).run() == 0
    out = capsys.readouterr().out
    assert "'mnist'" in out and "'max_epochs': 2" in out


def test_profile_writes_a_trace_of_the_run(mnist_argv, tmp_path):
    main = tmain.Main(mnist_argv + ["--profile", str(tmp_path / "prof")])
    assert main.run() == 0
    assert os.path.dirname(main.profile_trace) == str(tmp_path / "prof")
    with open(main.profile_trace) as fin:
        events = json.load(fin)["traceEvents"]
    assert events and main.workflow.decision.epoch_number == 2


def test_status_address_flag_posts_heartbeats(mnist_argv):
    """``--status-address`` sets ``root.common.web.url``; the run's
    launcher posts to it, a last time when the run ends."""
    from veles_tpu_torch.web_status import WebStatusServer
    server = WebStatusServer(host="127.0.0.1", port=0).start()
    try:
        address = "127.0.0.1:%d" % server.port
        main = tmain.Main(mnist_argv + [
            "--status-address", address, "root.common.web.interval=0.05"])
        main.parse()
        assert main.args.status_address == address
        assert main.run() == 0
        assert troot.common.web.url == address
        assert main.launcher.status_address == address
        assert main.launcher.heartbeats >= 1
        (info,) = server.status().values()
        assert info["workflow"] == "MnistWorkflow"
        assert info["running"] is False and info["epoch"] == 2
    finally:
        server.stop()


# -- graph, print_, logger --------------------------------------------------


def _counter_graph(units_mod, workflow_cls):
    class Counter(units_mod.Unit):
        def run(self):
            pass

    wf = workflow_cls()
    u = Counter(wf, name="body")
    u.link_from(wf.start_point)
    wf.end_point.link_from(u)
    return wf.generate_graph(write_on_disk=False)


def test_generate_graph_dot(tmp_path):
    from veles_tpu import units as junits
    from veles_tpu.dummy import DummyWorkflow as JDummy
    from veles_tpu_torch import units as tunits
    from veles_tpu_torch.dummy import DummyWorkflow
    dot = _counter_graph(tunits, DummyWorkflow)
    assert dot.startswith("digraph")
    assert '"body"' in dot and "->" in dot
    assert dot == _counter_graph(junits, JDummy)
    path = tmp_path / "g.dot"
    wf = DummyWorkflow()
    assert wf.generate_graph(str(path)) == path.read_text()


def _fill(node):
    node.alpha = 1
    node.beta.gamma = [1, 2.5, "x"]
    node.beta.delta = {"k": (1, 2)}
    node.zeta = None


def test_print_matches_jax():
    from veles_tpu.config import root as jroot
    texts = []
    for r in (troot, jroot):
        _fill(r.print_test)
        buf = io.StringIO()
        r.print_test.print_(file=buf)
        texts.append(buf.getvalue())
        r.common.__dict__.pop("print_test", None)
        r.__dict__.pop("print_test", None)
    assert texts[0] == texts[1]
    assert "'gamma': [1, 2.5, 'x']" in texts[0]
    with pytest.raises(AttributeError, match="protected"):
        troot.print_ = 1


def test_event_records_match_jax(tmp_path):
    from veles_tpu import logger as jlogger

    class Port(tlogger.Logger):
        pass

    class Jax(jlogger.Logger):
        pass

    path = str(tmp_path / "events" / "log.jsonl")
    tlogger.set_event_sink_path(path)
    try:
        Port().event("tick", "begin", step=3)
        Port().event("tick", "end", step=3)
        Jax().event("tick", "single", step=3)
        ring = tlogger.get_event_sink().ring
        jring = jlogger.get_event_sink().ring
        assert [r["phase"] for r in ring] == ["B", "E"]
        assert sorted(ring[0]) == sorted(jring[-1])
        assert ring[0]["cls"] == "Port" and ring[0]["step"] == 3
    finally:
        tlogger.set_event_sink_path(None)
    with open(path) as fin:
        assert [json.loads(line)["phase"] for line in fin] == ["B", "E"]


def test_event_ring_is_bounded():
    sink = tlogger.EventSink()
    sink.ring_size = 3
    for i in range(5):
        sink.emit({"i": i})
    assert [r["i"] for r in sink.ring] == [2, 3, 4]


def test_setup_logging_installs_once(tmp_path, monkeypatch):
    rootlog = logging.getLogger()
    handlers, level = list(rootlog.handlers), rootlog.level
    monkeypatch.setattr(tlogger, "_configured", [False])
    try:
        tlogger.setup_logging(logging.WARNING,
                              filename=str(tmp_path / "log.txt"))
        added = [h for h in rootlog.handlers if h not in handlers]
        assert len(added) == 2
        assert isinstance(added[0].formatter, tlogger.ColorFormatter)
        tlogger.setup_logging(logging.ERROR)
        assert rootlog.level == logging.ERROR
        assert len(rootlog.handlers) == len(handlers) + 2
    finally:
        for h in rootlog.handlers[:]:
            if h not in handlers:
                rootlog.removeHandler(h)
                h.close()
        rootlog.setLevel(level)


def test_color_formatter_colors_a_terminal(monkeypatch):
    fmt = tlogger.ColorFormatter("%(message)s")
    record = logging.LogRecord("x", logging.ERROR, __file__, 1, "boom",
                               None, None)

    class Tty(io.StringIO):
        def isatty(self):
            return True

    monkeypatch.setattr("sys.stderr", io.StringIO())
    assert fmt.format(record) == "boom"
    monkeypatch.setattr("sys.stderr", Tty())
    assert fmt.format(record) == "\033[31mboom\033[0m"


def test_parse_intermixed_and_argparse_types():
    args = tmain.Main(["wf.py", "-v", "error", "root.x=1", "--dry-run",
                       "exec"]).parse()
    assert args.config == ["root.x=1"] and args.dry_run == "exec"
    with pytest.raises(SystemExit):
        tmain.make_parser().parse_args(["wf.py", "--dry-run", "maybe"])
    assert isinstance(tmain.make_parser(), argparse.ArgumentParser)
