"""The port's plotting stack (``plotter``, ``plotting_units``,
``graphics_server``, ``graphics_client``) against the JAX package's, on
the CPU.

The counterparts of the JAX package's ``tests/test_graphics.py``: the
pub/sub round trip to a viewer that renders PNGs, every family's
``render`` (matplotlib, Agg), and plotters in an MNIST run streaming to
a subscribed viewer.  The parity test runs the same MNIST training in
both packages with an ``AccumulatingPlotter`` on the decision, a
``Histogram`` of the first layer's weights and a ``MatrixPlotter`` on
the validation and train confusion matrix (from the evaluator's
probability capture), one firing an epoch; a subscriber socket decodes
each package's stream with the port's restricted unpickler, and the
payloads agree: the same names and families in the same order, the f32
curves and bin edges within 1e-5 relative, the confusion matrices and
histogram counts exactly.  The restricted unpickler lets containers and
numpy arrays through and refuses anything callable.
"""

import glob
import os
import pickle
import socket
import threading

import numpy
import pytest

from veles_tpu_torch import prng as tprng
from veles_tpu_torch.config import root as troot
from veles_tpu_torch.graphics_client import GraphicsClient, safe_loads
from veles_tpu_torch.graphics_server import GraphicsServer
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.network_common import connect, recv_message
from veles_tpu_torch.plotting_units import (
    AccumulatingPlotter, Histogram, ImagePlotter, ImmediatePlotter,
    MatrixPlotter, MultiHistogram, SlaveStats, TableMaxMin)

from test_torch_network import MLP, joined, kept_process_state, \
    write_mnist_idx

#: The curves' and bin edges' relative tolerance against JAX (f32).
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _process_state():
    with kept_process_state():
        try:
            yield
        finally:
            for cls in _servers():
                if cls._instance is not None:
                    stop(cls._instance)


def _servers():
    from veles_tpu.graphics_server import GraphicsServer as JaxServer
    return (GraphicsServer, JaxServer)


def stop(server):
    """Stops a graphics server of either package and joins its accept
    thread: the listener is shut down first, since a bare close (the
    JAX package's ``stop``) does not wake a thread blocked in
    ``accept``."""
    try:
        server._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    server.stop()
    joined(server._accept_thread, 10)


@pytest.fixture
def server():
    srv = GraphicsServer("127.0.0.1:0")
    yield srv
    stop(srv)


def _wait_subscribed(srv, n=1):
    import time
    end = time.monotonic() + 30.0
    while srv.subscriber_count < n and time.monotonic() < end:
        time.sleep(0.02)
    assert srv.subscriber_count == n


def test_pub_sub_roundtrip(server, tmp_path):
    client = GraphicsClient("127.0.0.1:%d" % server.port,
                            output_dir=str(tmp_path))
    result = {}
    t = threading.Thread(
        target=lambda: result.update(rendered=client.run(max_payloads=2)),
        name="test-viewer")
    t.start()
    try:
        _wait_subscribed(server)
        server.publish({"kind": "plot", "name": "curve",
                        "cls_name": "AccumulatingPlotter",
                        "data": {"label": "err",
                                 "values": [0.5, 0.3, 0.2]}})
        server.publish({"kind": "plot", "name": "hist",
                        "cls_name": "Histogram",
                        "data": {"counts": numpy.array([1, 2, 3]),
                                 "edges": numpy.array([0.0, 0.1, 0.2,
                                                       0.3]),
                                 "name": "weights"}})
    finally:
        joined(t, 60)
        client.stop()
    assert result.get("rendered") == 2
    files = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / "*.png")))
    assert files == ["curve.png", "hist.png"]


def _render_ok(cls, data):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure()
    try:
        cls.render(data, fig)
        assert fig.axes
    finally:
        plt.close(fig)


@pytest.mark.parametrize("cls, data", [
    (AccumulatingPlotter, {"label": "x", "values": [3.0, 2.0, 1.0],
                           "fit_poly_power": 1}),
    (MatrixPlotter, {"matrix": numpy.arange(9).reshape(3, 3),
                     "name": "confusion"}),
    (ImagePlotter, {"images": numpy.random.RandomState(0).rand(4, 49)}),
    (Histogram, {"counts": numpy.array([1, 5, 2]),
                 "edges": numpy.array([0., 1., 2., 3.]), "name": "w"}),
    (MultiHistogram, {"hists": [{"counts": [1, 2],
                                 "edges": [0., 0.5, 1.0]}] * 3}),
    (TableMaxMin, {"rows": [{"label": "w0", "max": 1.0, "min": -1.0}]}),
    (ImmediatePlotter, {"series": [{"x": [0, 1, 2], "y": [5, 6, 7]}]}),
    (SlaveStats, {"workers": []}),
    (SlaveStats, {"workers": [{"id": "a/1", "power": 1.0,
                               "jobs_done": 3, "state": "WORK",
                               "blacklisted": False}]}),
], ids=lambda v: getattr(v, "__name__", ""))
def test_every_family_renders(cls, data):
    _render_ok(cls, data)


@pytest.fixture
def mnist_data(tmp_path):
    from veles_tpu.config import root as jroot
    write_mnist_idx(str(tmp_path))
    for r in (jroot, troot):
        r.common.dirs.datasets = str(tmp_path)
        r.common.engine.precision_level = 1
        r.common.graphics.enabled = True
    return jroot, troot


def confusion(evaluator, loader):
    """Labels × predictions over every sample the evaluator captured
    (the validation and train samples of the last epoch)."""
    probs = evaluator.read_capture()
    loader.original_labels.map_read()
    labels = numpy.asarray(loader.original_labels.mem).astype(numpy.int64)
    start = loader.class_lengths[0]
    probs, labels = probs[start:], labels[start:]
    out = numpy.zeros((probs.shape[1],) * 2, dtype=numpy.int64)
    numpy.add.at(out, (labels, probs.argmax(axis=1)), 1)
    return out


def _epoch_gate(units, loader):
    """A gate that lets a plotter run at an epoch's end only."""
    gate = units.Bool(True)

    class EpochEnd(units.Unit):
        def run(self):
            gate.__ilshift__(not loader.epoch_ended)

    return EpochEnd, gate


def _plotted_mnist(pkg):
    """The MNIST run of ``pkg`` ("port" or "jax") with the three
    plotters, one firing an epoch; returns (launcher, workflow)."""
    if pkg == "port":
        from veles_tpu_torch import mutable, plotting_units as pu, units
        from veles_tpu_torch.znicz.samples.mnist import MnistWorkflow
        prng, launcher = tprng, Launcher()
    else:
        import veles_tpu.prng as prng
        from veles_tpu import mutable, plotting_units as pu, units
        from veles_tpu.launcher import Launcher as JLauncher
        from veles_tpu.znicz.samples.mnist import MnistWorkflow
        launcher = JLauncher()
    prng.reset()
    prng.get(0).seed(5)
    wf = MnistWorkflow(launcher, **MLP)

    class Units(object):
        Unit = units.Unit
        Bool = mutable.Bool

    EpochEnd, gate = _epoch_gate(Units, wf.loader)
    end = EpochEnd(wf, name="epoch_end")
    end.link_from(wf.decision)
    curve = pu.AccumulatingPlotter(wf, name="validation error",
                                   input=wf.decision,
                                   input_field="min_validation_err")
    hist = pu.Histogram(wf, name="fc0 weights",
                        input=wf.forwards[0].weights)
    matrix = pu.MatrixPlotter(
        wf, name="confusion",
        input=lambda: confusion(wf.evaluator, wf.loader))
    for plotter in (curve, hist, matrix):
        plotter.link_from(end)
        plotter.gate_skip = gate
    if pkg == "port":
        launcher.initialize(device="cpu")
    else:
        launcher.initialize()
    wf.evaluator.enable_capture(wf.loader)
    return launcher, wf


def _subscribe(port):
    """A subscriber socket's thread collecting every payload, decoded
    with the port's restricted unpickler, until the server closes."""
    sock = connect("127.0.0.1:%d" % port, timeout=30.0)
    got = []

    def loop():
        while True:
            try:
                payload = recv_message(sock, loads=safe_loads)
            except OSError:
                return
            if payload is None:
                return
            got.append(payload)

    t = threading.Thread(target=loop, name="test-subscriber")
    t.start()
    return sock, t, got


def test_plot_payloads_match_jax(mnist_data):
    streams = {}
    for pkg in ("port", "jax"):
        launcher, wf = _plotted_mnist(pkg)
        server = launcher.graphics_server
        assert server is not None
        sock, t, got = _subscribe(server.port)
        try:
            _wait_subscribed(server)
            launcher.run()
        finally:
            stop(server)
            joined(t, 30)
            sock.close()
        streams[pkg] = (got, wf)
    got, twf = streams["port"]
    want, jwf = streams["jax"]
    epochs = MLP["max_epochs"]
    assert len(got) == len(want) == 3 * epochs
    for g, w in zip(got, want):
        assert (g["kind"], g["name"], g["cls_name"]) == \
            (w["kind"], w["name"], w["cls_name"])
        gd, wd = g["data"], w["data"]
        assert sorted(gd) == sorted(wd)
        if g["cls_name"] == "AccumulatingPlotter":
            assert gd["label"] == wd["label"]
            numpy.testing.assert_allclose(gd["values"], wd["values"],
                                          rtol=RTOL)
        elif g["cls_name"] == "Histogram":
            numpy.testing.assert_allclose(gd["edges"], wd["edges"],
                                          rtol=RTOL)
            assert numpy.array_equal(gd["counts"], wd["counts"])
        else:
            assert gd["matrix"].dtype == numpy.int64
            assert numpy.array_equal(gd["matrix"], wd["matrix"])
            # Every validation and train sample of the epoch, once.
            assert gd["matrix"].sum() == sum(twf.loader.class_lengths[1:])
    assert twf.decision.epoch_n_valid == jwf.decision.epoch_n_valid


def test_plotters_in_mnist_workflow(mnist_data, tmp_path):
    """Plotters linked into a port MNIST run publish live payloads that
    a subscribed viewer renders to PNG files."""
    launcher, wf = _plotted_mnist("port")
    server = launcher.graphics_server
    out = tmp_path / "plots"
    client = GraphicsClient("127.0.0.1:%d" % server.port,
                            output_dir=str(out))
    t = threading.Thread(target=client.run, name="test-viewer")
    t.start()
    try:
        _wait_subscribed(server)
        launcher.run()
    finally:
        stop(server)
        joined(t, 60)
        client.stop()
    assert client.rendered == 3 * MLP["max_epochs"]
    for name in ("validation_error", "fc0_weights", "confusion"):
        assert (out / ("%s.png" % name)).is_file(), name
    curve = wf["validation error"]
    assert len(curve.values) == MLP["max_epochs"]


class _Evil(object):
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("obj, ok", [
    ({"kind": "plot", "data": {"m": numpy.eye(3, dtype=numpy.float32),
                               "v": [numpy.float64(1.5), 2, "s"]}}, True),
    ({"evil": _Evil()}, False),
    (numpy.random.RandomState, False),
], ids=["containers-and-numpy", "callable", "class"])
def test_restricted_unpickler(obj, ok):
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if ok:
        back = safe_loads(blob)
        assert numpy.array_equal(back["data"]["m"], obj["data"]["m"])
        assert back["data"]["v"][0] == 1.5
    else:
        with pytest.raises(pickle.UnpicklingError):
            safe_loads(blob)


def test_graphics_server_launch_is_process_wide():
    """``launch`` returns one server until it stops; ``stop`` closes the
    listener and joins the accept thread."""
    troot.common.graphics.host = "127.0.0.1"
    first = GraphicsServer.launch()
    assert GraphicsServer.launch() is first
    sock = socket.create_connection(("127.0.0.1", first.port), timeout=10)
    try:
        _wait_subscribed(first)
    finally:
        first.stop()
        sock.close()
    assert not first._accept_thread.is_alive()
    assert GraphicsServer._instance is None
