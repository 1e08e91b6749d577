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
            "veles_tpu_torch.ops.decode_attention\n"
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
