"""veles_tpu_torch — the PyTorch and CUDA port of ``veles_tpu``.

The port mirrors the JAX package's module names: ``veles_tpu_torch/X.py``
is the counterpart of ``veles_tpu/X.py`` and is held against it by the
tests in ``tests/test_torch_*.py``.  It imports ``torch`` and never
``jax``, and nothing of ``veles_tpu``.  Its entry points run on the CUDA
card unless the caller asks for the CPU.

Ported so far: serving an exported causal LM (the artifact reader and
writer, the paged KV block pool, the continuous-batching serving
engine, the HTTP server, the flash-decode kernel); training through the
fused tick (the TinyLM workflow with the flash-attention kernels); and
the znicz layer library with ``StandardWorkflow``, the MNIST FC sample
and the AlexNet sample, whose LRN layers run hand-written forward and
backward kernels (``ops/lrn.py``); and the meta-workflows that run in
one process — the genetic search (``genetics``), whose generations train
as one population step vmapped over the members, the population
engine's GA mode (``population``) and ensembles (``ensemble``); and the
operator services — the web-status dashboard (``web_status``), plotters
and the graphics stream, report publishing, the shell unit, the model
registry (``forge``) and the native runtime binding (``native``).  Every
kernel is CUDA C++ for Hopper under ``ops/csrc/``.
"""
