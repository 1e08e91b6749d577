"""The port stands alone: ``veles_tpu_torch``, ``chip_smoke.py`` and
``serve_ab.py`` import ``torch`` and never ``jax`` or anything of
``veles_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    out = [os.path.join(ROOT, name) for name in (
        "chip_smoke.py", "serve_ab.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT,
                                                  "veles_tpu_torch")):
        out.extend(os.path.join(dirpath, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def test_import_leaves_jax_and_veles_tpu_out():
    code = ("import sys, veles_tpu_torch, veles_tpu_torch.serve, "
            "veles_tpu_torch.export, veles_tpu_torch.restful, "
            "veles_tpu_torch.accelerated_units, "
            "veles_tpu_torch.znicz.samples.tinylm, "
            "veles_tpu_torch.ops.flash_attention, "
            "veles_tpu_torch.ops.attention, veles_tpu_torch.__main__, "
            "veles_tpu_torch.ops.lrn, veles_tpu_torch.guardian, "
            "veles_tpu_torch.mean_disp_normalizer, veles_tpu_torch.znicz, "
            "veles_tpu_torch.znicz.standard_workflow, "
            "veles_tpu_torch.znicz.samples.imagenet, "
            "veles_tpu_torch.znicz.samples.mnist, "
            "veles_tpu_torch.serving.speculation, "
            "veles_tpu_torch.serving.reload, "
            "veles_tpu_torch.ops.decode_attention, "
            "veles_tpu_torch.snapshotter, veles_tpu_torch.normalization, "
            "veles_tpu_torch.resilience, veles_tpu_torch.launcher, "
            "veles_tpu_torch.loader.stream, veles_tpu_torch.loader.image, "
            "veles_tpu_torch.znicz.samples.cifar, veles_tpu_torch.dummy, "
            "veles_tpu_torch.avatar, veles_tpu_torch.input_joiner, "
            "veles_tpu_torch.harness, veles_tpu_torch.downloader, "
            "veles_tpu_torch.config, veles_tpu_torch.prng, "
            "veles_tpu_torch.loader, veles_tpu_torch.loader.interactive, "
            "veles_tpu_torch.loader.pickles, veles_tpu_torch.loader.hdf5, "
            "veles_tpu_torch.loader.saver, veles_tpu_torch.loader.audio, "
            "veles_tpu_torch.loader.hdfs_loader, "
            "veles_tpu_torch.znicz.rbm, veles_tpu_torch.znicz.kohonen, "
            "veles_tpu_torch.znicz.samples.mnist_rbm, "
            "veles_tpu_torch.znicz.samples.kohonen, "
            "veles_tpu_torch.genetics, veles_tpu_torch.genetics.core, "
            "veles_tpu_torch.genetics.vmap_eval, "
            "veles_tpu_torch.genetics.optimizer, veles_tpu_torch.ensemble, "
            "veles_tpu_torch.population, "
            "veles_tpu_torch.population.engine, "
            "veles_tpu_torch.population.vmap_backend, "
            "veles_tpu_torch.parallel, veles_tpu_torch.parallel.mesh, "
            "veles_tpu_torch.parallel.collectives, "
            "veles_tpu_torch.parallel.placed, veles_tpu_torch.ops.moe, "
            "veles_tpu_torch.ops.pipeline, "
            "veles_tpu_torch.network_common, veles_tpu_torch.server, "
            "veles_tpu_torch.client, veles_tpu_torch.fleet, "
            "veles_tpu_torch.fleet.scheduler, "
            "veles_tpu_torch.population.lineage, "
            "veles_tpu_torch.population.master, "
            "veles_tpu_torch.population.worker, "
            "veles_tpu_torch.observability, "
            "veles_tpu_torch.observability.tracing, "
            "veles_tpu_torch.observability.attribution, "
            "veles_tpu_torch.serving.fabric, "
            "veles_tpu_torch.serving.fabric.router, "
            "veles_tpu_torch.serving.fabric.disagg, "
            "veles_tpu_torch.serving.fabric.registry, "
            "veles_tpu_torch.cmdline, veles_tpu_torch.logger, "
            "veles_tpu_torch.backends, veles_tpu_torch.web_status, "
            "veles_tpu_torch.plotter, veles_tpu_torch.plotting_units, "
            "veles_tpu_torch.graphics_server, "
            "veles_tpu_torch.graphics_client, veles_tpu_torch.publishing, "
            "veles_tpu_torch.publishing_confluence, "
            "veles_tpu_torch.interaction, veles_tpu_torch.native, "
            "veles_tpu_torch.forge, veles_tpu_torch.forge.client, "
            "veles_tpu_torch.forge.server\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'veles_tpu.')) or "
            "m == 'veles_tpu')\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_hdf5_loader_imports_h5py_only_when_it_reads():
    """The card's machine has no h5py: importing the loader package must
    not need it."""
    code = ("import sys, veles_tpu_torch.loader, "
            "veles_tpu_torch.loader.hdf5\n"
            "print('h5py' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_service_modules_import_without_matplotlib():
    """The card's machine has no matplotlib: the plotters, the graphics
    stream, the publisher and the dashboard import without it (only a
    viewer or a publisher's image backend renders)."""
    code = ("import sys, veles_tpu_torch.plotting_units, "
            "veles_tpu_torch.graphics_server, "
            "veles_tpu_torch.graphics_client, veles_tpu_torch.publishing, "
            "veles_tpu_torch.web_status, veles_tpu_torch.interaction\n"
            "print('matplotlib' in sys.modules, 'IPython' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False False"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_veles_tpu_import(path):
    with open(path) as fin:
        tree = ast.parse(fin.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "veles_tpu"), \
                "%s imports %s" % (os.path.relpath(path, ROOT), name)
