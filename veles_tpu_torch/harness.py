"""Shared in-process run harness for meta-workflows (the JAX package's
``harness``): runs a workflow module's ``run(load, main)`` hooks to
completion inside this process under a :class:`Launcher`.  The device
comes from ``main_kwargs`` — the CUDA card unless it names the CPU.
"""

import zlib

from . import prng
from .launcher import Launcher

#: Metric key meta-workflows optimize on (provided by decision units).
FITNESS_KEY = "EvaluationFitness"


def seed_to_int(spec, default=1234):
    """An integer seed base from a ``--random-seed`` value: an int
    string, or the ``file:count:dtype`` form hashed
    deterministically."""
    if spec is None or spec == "":
        return default
    try:
        return int(spec)
    except (TypeError, ValueError):
        return zlib.crc32(str(spec).encode("utf-8")) & 0x7FFFFFFF


def run_workflow_module(module, seed=None, **main_kwargs):
    """Runs ``module.run(load, main)`` to completion; returns the
    finished workflow.  ``seed`` (int) reseeds generator 0 first, so
    every evaluation starts from identical randomness; ``main_kwargs``
    reach ``Launcher.initialize`` (``device="cpu"`` for the host)."""
    if seed is not None:
        prng.reset()
        prng.get(0).seed(seed)
    state = {}

    def load(WorkflowClass, **kwargs):
        launcher = Launcher()
        wf = WorkflowClass(launcher, **kwargs)
        state["launcher"], state["wf"] = launcher, wf
        return wf, False

    def main(**kwargs):
        kwargs.update(main_kwargs)
        state["launcher"].initialize(**kwargs)
        state["launcher"].run()

    module.run(load, main)
    return state["wf"]
