"""Speculative decoding in the port (``veles_tpu_torch.serving
.speculation``, ``ExportedModel.paged_verify`` and the engine's spec
paths) against the JAX package's.

Host-side pieces (the n-gram drafter, the acceptance rule, the adaptive
draft budget, the draft compatibility gate) must give the JAX
package's outputs on the same inputs.  ``paged_verify`` runs on the
CPU on a small random LM (vocab 13, embed 8, 2 heads, positions 32 —
the JAX package's spec fixture geometry): its greedy tokens equal the
JAX package's and its logits the JAX forward's at the same positions
(rtol = atol = 1e-5: float32, different matmul orders).  Greedy and
sampled speculative output equal the port's own plain decode on the f32
plane, token for token, and so do they on the int8 and fp8 planes: there
a verify runs the plain step program column by column, writing only
accepted positions (its blocks hold bit for bit what plain steps leave,
and the JAX package's plain-step scales within rtol 1e-5, codes within
one code), and an extend runs each row alone.
"""

import threading
import time

import numpy
import pytest
import torch

from veles_tpu.export import ExportedModel as JaxModel
from veles_tpu.serving import speculation as JS
from veles_tpu_torch import export as X
from veles_tpu_torch.error import Bug
from veles_tpu_torch.serving import ServingEngine
from veles_tpu_torch.serving import speculation as S

# Tier-1 runs test files in parallel workers: keep torch's CPU ops to
# two threads so these files do not starve the timing-sensitive ones.
torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tspec") / "spec.veles.tgz")
    return X.random_lm_artifact(path, vocab=13, embed=8, n_heads=2,
                                n_blocks=1, hidden=16, max_position=32,
                                seed=42)


@pytest.fixture(scope="module")
def model(artifact):
    return X.ExportedModel(artifact, device="cpu")


# -- host-side pieces against the JAX package -------------------------------

def test_ngram_drafter_matches_jax():
    rng = numpy.random.RandomState(1)
    mine, theirs = S.NGramDrafter(), JS.NGramDrafter()
    for trial in range(200):
        n = int(rng.randint(1, 40))
        ctx = numpy.zeros(64, numpy.int32)
        ctx[:n] = rng.randint(0, 5 if trial % 2 else 50, n)
        k = int(rng.randint(0, 8))
        numpy.testing.assert_array_equal(mine.propose(ctx, n, k),
                                         theirs.propose(ctx, n, k))
    with pytest.raises(Bug):
        S.NGramDrafter(max_n=1, min_n=2)


def test_accept_lengths_matches_jax():
    rng = numpy.random.RandomState(2)
    for _ in range(50):
        B, K = int(rng.randint(1, 6)), int(rng.randint(1, 8))
        drafts = rng.randint(0, 3, (B, K))
        lens = rng.randint(0, K + 1, B)
        targets = rng.randint(0, 3, (B, K + 1))
        got = S.accept_lengths(drafts, lens, targets)
        numpy.testing.assert_array_equal(
            got, JS.accept_lengths(drafts, lens, targets))
        assert (got <= lens).all()


def test_spec_state_matches_jax():
    """The adaptive budget, its EWMA and the probe after a plain streak
    evolve as the JAX package's under the same round outcomes."""
    rng = numpy.random.RandomState(3)
    mine, theirs = S.SpecState(4, 64), JS.SpecState(4, 64)
    for _ in range(120):
        tok = int(rng.randint(0, 9))
        for st in (mine, theirs):
            st.extend_ctx([tok])
        budgets = [st.budget(4, True) for st in (mine, theirs)]
        assert budgets[0] == budgets[1]
        drafted = budgets[0]
        accepted = int(rng.randint(0, drafted + 1)) if drafted else 0
        if rng.rand() < 0.7:
            accepted = 0
        for st in (mine, theirs):
            st.update(accepted, drafted, 4, True)
        assert (mine.k, mine.ewma, mine.plain_streak) == \
            (theirs.k, theirs.ewma, theirs.plain_streak)
    numpy.testing.assert_array_equal(mine.ctx, theirs.ctx)
    assert S.MAX_SPEC_K == JS.MAX_SPEC_K == 15


def test_draft_compat_gate(model, tmp_path):
    other = X.ExportedModel(X.random_lm_artifact(
        str(tmp_path / "v7.veles.tgz"), vocab=7, embed=8, n_heads=2,
        n_blocks=1, hidden=16, max_position=32), device="cpu")
    with pytest.raises(Bug, match="vocabulary mismatch"):
        S.check_draft_compat(model, other)
    with pytest.raises(Bug, match="vocabulary mismatch"):
        ServingEngine(model, max_batch=4, kv_blocks=32, kv_block_size=4,
                      spec_draft=other)
    short = X.ExportedModel(X.random_lm_artifact(
        str(tmp_path / "p16.veles.tgz"), vocab=13, embed=4, n_heads=2,
        n_blocks=1, hidden=8, max_position=16), device="cpu")
    with pytest.raises(Bug, match="shorter"):
        S.check_draft_compat(model, short)
    with pytest.raises(Bug, match="spec-max-k"):
        ServingEngine(model, spec=True, spec_max_k=16)


# -- paged_verify -------------------------------------------------------------

def _verify_inputs():
    """Two rows, block size 4: each row's prompt extended first, then a
    verify chunk of its current token and 3 drafts (row 1 with 2)."""
    prompts = [[1, 5, 9, 2, 6], [4, 4, 8, 3, 11, 7, 0]]
    tables = numpy.array([[1, 2, 3, 4], [5, 6, 7, 8]], numpy.int32)
    toks = numpy.array([[3, 4, 5, 6], [2, 9, 1, 0]], numpy.int32)
    dlens = numpy.array([3, 2], numpy.int32)
    return prompts, tables, toks, dlens


def _verify(m, kv_dtype="f32", attend=None):
    prompts, tables, toks, dlens = _verify_inputs()
    pool = m.make_kv_pool(12, 4, kv_dtype=kv_dtype)
    tokens = numpy.zeros((2, 8), numpy.int32)
    lengths = numpy.array([len(p) for p in prompts], numpy.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    zeros = numpy.zeros(2, numpy.float32)
    seeds = numpy.zeros(2, numpy.uint32)
    m.paged_extend(pool, tables, tokens, numpy.zeros(2, numpy.int32),
                   lengths, zeros, seeds)
    kw = {} if attend is None else {"attend": attend}
    out = m.paged_verify(pool, tables, lengths, toks, dlens,
                         numpy.ones(2, numpy.int32), zeros, seeds, **kw)
    return out, pool, prompts, toks, lengths


def test_paged_verify_matches_jax(artifact, model, monkeypatch):
    """On the f32 plane: the verify chunk's greedy tokens equal the JAX
    package's paged_verify, and its logits at column j equal the JAX
    forward's at position len + j over the prompt followed by the chunk
    (rtol = atol = 1e-5)."""
    seen = []
    head = X._head_logits

    def capture(x, params):
        y = head(x, params)
        seen.append(y.numpy().copy())
        return y

    monkeypatch.setattr(X, "_head_logits", capture)
    got, _, prompts, toks, lengths = _verify(model)
    monkeypatch.undo()
    jm = JaxModel(artifact)
    want, _, _, _, _ = _verify(jm)
    numpy.testing.assert_array_equal(got, want)
    logits = seen[-1]
    assert logits.shape == (2, 4, 13)
    dlens = _verify_inputs()[3]
    for r, p in enumerate(prompts):
        # The real columns: the current token and the row's drafts (a
        # junk column's k/v went to the TRASH block).
        n = int(dlens[r]) + 1
        seq = numpy.array([p + toks[r, :n].tolist()])
        ref = jm.forward(seq)[0]
        numpy.testing.assert_allclose(
            logits[r, :n], ref[lengths[r]:lengths[r] + n], **LOGIT_TOL)
        numpy.testing.assert_array_equal(got[r], logits[r].argmax(-1))


def test_verify_pad_columns_write_trash(model):
    """Columns past a row's draft count write to the TRASH block: the
    row's own blocks hold exactly the positions up to its drafts."""
    _, pool, _, _, _ = _verify(model)
    ks = pool.storage[0][0]
    # Row 1 (7 prompt tokens, 2 drafts): positions 7..9 real, 10 junk
    # — the last slot of its table block 2 (block id 7) stays empty.
    assert ks[7, 2].abs().sum() == 0
    assert ks[7, 1].abs().sum() > 0


def _plane(t):
    """A copy of a pool tensor of either package as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy().copy()
    return numpy.array(t, dtype=numpy.float32)


def _stepped(m, kv_dtype, n_steps):
    """The ``_verify_inputs`` prompts extended into a fresh pool, then
    ``n_steps`` greedy plain steps: (pool, (B, n_steps + 1) tokens —
    the extend's and each step's — and the pool's planes after each step
    as float32 numpy)."""
    prompts, tables, _, _ = _verify_inputs()
    pool = m.make_kv_pool(12, 4, kv_dtype=kv_dtype)
    tokens = numpy.zeros((2, 8), numpy.int32)
    lengths = numpy.array([len(p) for p in prompts], numpy.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    zeros = numpy.zeros(2, numpy.float32)
    seeds = numpy.zeros(2, numpy.uint32)
    toks = [numpy.asarray(m.paged_extend(
        pool, tables, tokens, numpy.zeros(2, numpy.int32), lengths, zeros,
        seeds))]
    after = []
    for j in range(n_steps):
        toks.append(numpy.asarray(m.paged_step(
            pool, tables, lengths + j, toks[-1],
            numpy.full(2, j + 1, numpy.int32), zeros, seeds)))
        after.append([[_plane(t) for t in group] for group in pool.storage])
    return pool, numpy.stack(toks, axis=1), after


def test_quantized_verify_grows_scales_like_jax(artifact, model):
    """On a quantized plane a verify grows the written blocks' scales as
    the JAX package's plain decode does, one accepted position at a
    time, and a rejected draft grows nothing: on the int8 and the fp8
    plane, from the same extended pool, a verify whose drafts are the
    greedy continuation (row 1's second draft wrong) leaves each row's
    blocks with the JAX package's plain-step scales after 1 + its
    accepted drafts (rtol 1e-5) and codes within one code, and its
    reached columns answer the JAX package's step tokens."""
    jm = JaxModel(artifact)
    _, tables, _, _ = _verify_inputs()
    for kv_dtype in ("int8", "fp8"):
        _, steps_j, after_j = _stepped(jm, kv_dtype, 4)
        pool, steps_m, _ = _stepped(model, kv_dtype, 0)
        numpy.testing.assert_array_equal(steps_m[:, 0], steps_j[:, 0])
        toks = steps_j[:, :4].copy()
        toks[1, 2] = (toks[1, 2] + 1) % 13
        dlens = numpy.array([3, 3], numpy.int32)
        got = model.paged_verify(
            pool, tables, numpy.array([5, 7], numpy.int32), toks, dlens,
            numpy.ones(2, numpy.int32), numpy.zeros(2, numpy.float32),
            numpy.zeros(2, numpy.uint32))
        acc = S.accept_lengths(toks[:, 1:], dlens, got)
        assert acc.tolist() == [3, 1]
        assert got[1, 2:].tolist() == [-1, -1]
        for r in range(2):
            a = int(acc[r])
            numpy.testing.assert_array_equal(got[r, :a + 1],
                                             steps_j[r, 1:a + 2])
            blocks = tables[r]
            for i, (mine, theirs) in enumerate(zip(pool.storage,
                                                   after_j[a])):
                for t, w in zip(mine, theirs):
                    t, w = _plane(t)[blocks], w[blocks]
                    if i >= 2:
                        numpy.testing.assert_allclose(t, w, rtol=1e-5)
                    elif kv_dtype == "int8":
                        assert numpy.abs(t - w).max() <= 1.0
                    else:   # one step of e4m3 (3 mantissa bits)
                        assert (numpy.abs(t - w) <= 2.0 ** -3 *
                                numpy.maximum(numpy.abs(t), numpy.abs(w)) +
                                1e-30).all()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_verify_is_plain_steps(model, kv_dtype):
    """The port's verify on a quantized plane is its plain step program
    column by column: with every draft the greedy continuation, the
    answers equal the steps' tokens and the whole pool equals the pool
    the plain steps leave, bit for bit; a row that rejects stops
    writing, so its blocks equal the pool after 1 + its accepted
    drafts."""
    _, tables, _, _ = _verify_inputs()
    _, steps, after = _stepped(model, kv_dtype, 4)
    lengths = numpy.array([5, 7], numpy.int32)
    zeros = numpy.zeros(2, numpy.float32)
    seeds = numpy.zeros(2, numpy.uint32)
    for wrong, want_acc in ((None, [3, 3]), (1, [3, 0])):
        pool, _, _ = _stepped(model, kv_dtype, 0)
        toks = steps[:, :4].copy()
        if wrong is not None:
            toks[wrong, 1] = (toks[wrong, 1] + 1) % 13
        got = model.paged_verify(pool, tables, lengths, toks,
                                 numpy.array([3, 3]),
                                 numpy.ones(2, numpy.int32), zeros, seeds)
        acc = S.accept_lengths(toks[:, 1:], numpy.array([3, 3]), got)
        assert acc.tolist() == want_acc
        for r in range(2):
            a = int(acc[r])
            numpy.testing.assert_array_equal(got[r, :a + 1],
                                             steps[r, 1:a + 2])
            for mine, theirs in zip(pool.storage, after[a]):
                for t, w in zip(mine, theirs):
                    numpy.testing.assert_array_equal(_plane(t)[tables[r]],
                                                     w[tables[r]])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_extend_row_alone(model, kv_dtype):
    """On a quantized plane a row's extend stores and answers the same
    bits whatever rows share the call: each row beside the other equals
    each row alone."""
    prompts, tables, _, _ = _verify_inputs()
    lengths = numpy.array([len(p) for p in prompts], numpy.int32)
    tokens = numpy.zeros((2, 8), numpy.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    zeros = numpy.zeros(2, numpy.float32)
    seeds = numpy.zeros(2, numpy.uint32)
    both = model.make_kv_pool(12, 4, kv_dtype=kv_dtype)
    tok = model.paged_extend(both, tables, tokens,
                             numpy.zeros(2, numpy.int32), lengths, zeros,
                             seeds)
    for r in range(2):
        alone = model.make_kv_pool(12, 4, kv_dtype=kv_dtype)
        one = model.paged_extend(
            alone, tables[r:r + 1], tokens[r:r + 1, :lengths[r]],
            numpy.zeros(1, numpy.int32), lengths[r:r + 1], zeros[:1],
            seeds[:1])
        assert int(one[0]) == int(tok[r])
        for mine, theirs in zip(both.storage, alone.storage):
            for t, w in zip(mine, theirs):
                assert torch.equal(t[tables[r]], w[tables[r]])


# -- the engine -------------------------------------------------------------

def _prompts():
    rng = numpy.random.RandomState(7)
    out = [rng.randint(0, 13, (1, n)).astype(numpy.int32) for n in (2, 5, 8)]
    out.append(numpy.tile(numpy.array([[3, 7, 1]], numpy.int32), (1, 4)))
    return out


def _serve(model, prompts, max_new=10, concurrent=True, sampling=None,
           **kw):
    defaults = dict(max_batch=4, kv_blocks=48, kv_block_size=4)
    defaults.update(kw)
    engine = ServingEngine(model, **defaults).start()
    out = {}
    try:
        def gen(i):
            out[i] = engine.submit_generate(prompts[i], max_new,
                                            **(sampling or {}))
        if concurrent:
            threads = [threading.Thread(target=gen, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for i in range(len(prompts)):
                gen(i)
        counters = engine.stats.snapshot()["counters"]
        gauges = engine.stats.snapshot()["gauges"]
        engine.kv_pool.drop_prefixes()
        blocks_left = engine.kv_pool.occupancy()["blocks_used"]
    finally:
        engine.stop()
    return [out[i] for i in range(len(prompts))], counters, gauges, \
        blocks_left


def _row_blocks(pool, ids):
    """Copies of every plane tensor's blocks ``ids``."""
    return [t[torch.as_tensor(ids)].clone() for group in pool.storage
            for t in group]


def _pool_copy(model, pool):
    new = model.make_kv_pool(pool.n_blocks, pool.block_size)
    for src, dst in zip(pool.storage, new.storage):
        for a, b in zip(src, dst):
            b.copy_(a)
    return new


@pytest.mark.parametrize("schedule", ["extend", "step", "verify"])
def test_f32_row_results_do_not_depend_on_schedule(model, monkeypatch,
                                                   schedule):
    """On the f32 plane a row's logits, token and stored k/v are the
    same bit for bit however the engine schedules it: a one-token extend
    alone or in a group of three rows ("extend"), a step alone or among
    max_batch rows ("step"), the columns of one verify chunk or plain
    steps at the same positions ("verify").  The engine groups rows by
    their arrival and its spec gate picks verify or plain step from
    measured dispatch times, so any difference here is a greedy token
    that can flip with the host's load."""
    seen = []
    head = X._head_logits

    def capture(x, params):
        y = head(x, params)
        seen.append(y.reshape(-1, y.shape[-1]).clone())
        return y

    monkeypatch.setattr(X, "_head_logits", capture)
    prompts = [p[0] for p in _prompts()]
    B, K = len(prompts), 3
    # Row r owns blocks 1 + 8r .. 8 + 8r (block size 4, 32 positions).
    tables = 1 + numpy.arange(8 * B, dtype=numpy.int32).reshape(B, 8)
    lens = numpy.array([len(p) for p in prompts], numpy.int32)
    tokens = numpy.zeros((B, 16), numpy.int32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
    zeros = numpy.zeros(B, numpy.float32)
    seeds = numpy.zeros(B, numpy.uint32)
    ones = numpy.ones(B, numpy.int32)
    pool = model.make_kv_pool(8 * B + 1, 4)
    tok = model.paged_extend(pool, tables, tokens, numpy.zeros_like(lens),
                             lens, zeros, seeds)

    def run(fn, *args):
        """(tokens, logits rows, pool) of one call on a copy of the
        pool."""
        del seen[:]
        copy = _pool_copy(model, pool)
        out = fn(copy, *args)
        return numpy.asarray(out), torch.cat(seen), copy

    r = 1
    if schedule == "extend":
        one = tok[:, None]
        alone = run(model.paged_extend, tables[r:r + 1], one[r:r + 1],
                    lens[r:r + 1], ones[:1], zeros[:1], seeds[:1])
        pad = numpy.zeros_like(tables[:1])   # an all-TRASH pad row
        group = run(model.paged_extend,
                    numpy.concatenate([tables[:3], pad]),
                    numpy.pad(one, ((0, 0), (0, 15))), lens, ones, zeros,
                    seeds)
    elif schedule == "step":
        alone = run(model.paged_step, tables[r:r + 1], lens[r:r + 1],
                    tok[r:r + 1], ones[:1], zeros[:1], seeds[:1])
        group = run(model.paged_step, tables, lens, tok, ones, zeros,
                    seeds)
    if schedule in ("extend", "step"):
        assert alone[0][0] == group[0][r]
        assert torch.equal(alone[1][0], group[1][r])
        for a, b in zip(_row_blocks(alone[2], tables[r]),
                        _row_blocks(group[2], tables[r])):
            assert torch.equal(a, b)
        return
    rng = numpy.random.RandomState(11)
    toks = numpy.concatenate([tok[:, None],
                              rng.randint(0, 13, (B, K))], axis=1)
    toks = toks.astype(numpy.int32)
    chunk = run(model.paged_verify, tables, lens, toks,
                numpy.full(B, K, numpy.int64), ones, zeros, seeds)
    steps = _pool_copy(model, pool)
    logits = []
    for j in range(K + 1):
        del seen[:]
        got = model.paged_step(steps, tables, lens + j, toks[:, j],
                               ones + j, zeros, seeds)
        numpy.testing.assert_array_equal(got, chunk[0][:, j])
        logits.append(torch.cat(seen))
    assert torch.equal(torch.stack(logits, dim=1),
                       chunk[1].reshape(B, K + 1, -1))
    for a, b in zip(_row_blocks(chunk[2], tables.ravel()),
                    _row_blocks(steps, tables.ravel())):
        assert torch.equal(a, b)


def test_spec_greedy_token_identical_to_plain_f32(model):
    """Greedy n-gram speculation on the f32 plane — concurrent rows of
    different lengths, drafting, one-pass verify, rewind, adaptive K —
    answers token for token as plain paged decode, with drafts really
    accepted; every block returns to the pool."""
    prompts = _prompts()
    plain, _, _, _ = _serve(model, prompts)
    spec, c, g, left = _serve(model, prompts, spec=True, spec_max_k=3)
    for a, b in zip(spec, plain):
        numpy.testing.assert_array_equal(a, b)
    assert c.get("batches.verify", 0) >= 1
    assert c.get("spec.accepted", 0) >= 1
    assert g["spec.tokens_per_step"] > 1.0
    assert left == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_spec_greedy_on_quantized_planes_bounded_divergence(model,
                                                            kv_dtype):
    """On the int8 and fp8 planes the speculative stream is held to
    plain decode on the same plane token for token — more than the JAX
    package's KV quality gate (bounded divergence: every answer equal up
    to generated position 8 of 12): a verify there runs the plain step
    program column by column and an extend runs each row alone, so a
    row's answer does not depend on how it was scheduled."""
    prompts = _prompts()
    plain, _, _, _ = _serve(model, prompts, max_new=12, kv_dtype=kv_dtype)
    spec, c, _, _ = _serve(model, prompts, max_new=12, kv_dtype=kv_dtype,
                           spec=True, spec_max_k=3)
    assert c.get("batches.verify", 0) >= 1
    assert c.get("spec.accepted", 0) >= 1
    for a, b in zip(spec, plain):
        numpy.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_spec_sampled_on_quantized_planes_identical(model, kv_dtype):
    """Sampled speculation on the int8 and fp8 planes equals plain
    sampled decode on the same plane with the same seeds."""
    prompts = _prompts()
    gen = {"temperature": 1.3, "seed": 5}
    plain, _, _, _ = _serve(model, prompts, kv_dtype=kv_dtype,
                            sampling=gen)
    spec, c, _, _ = _serve(model, prompts, kv_dtype=kv_dtype, spec=True,
                           spec_max_k=3, sampling=gen)
    assert c.get("batches.verify", 0) >= 1
    for a, b in zip(spec, plain):
        numpy.testing.assert_array_equal(a, b)


def test_spec_sampled_identical_to_plain_streams(model):
    """Sampled speculation draws the port's own per-row streams at the
    same generation indices: sampled output equals plain sampled decode
    with the same seeds."""
    prompts = _prompts()
    gen = {"temperature": 1.3, "seed": 5}
    plain, _, _, _ = _serve(model, prompts, sampling=gen)
    spec, c, _, _ = _serve(model, prompts, spec=True, spec_max_k=3,
                           sampling=gen)
    for a, b in zip(spec, plain):
        numpy.testing.assert_array_equal(a, b)
    assert c.get("batches.verify", 0) >= 1
    greedy, _, _, _ = _serve(model, prompts)
    assert any(not numpy.array_equal(a, b) for a, b in zip(spec, greedy))


def test_draft_model_drafter(artifact, model):
    """The draft-model drafter with draft == target proposes the
    target's own greedy stream: every draft accepted, output identical,
    and the draft pool returns its mirrors."""
    prompts = _prompts()[:2]
    plain, _, _, _ = _serve(model, prompts, concurrent=False)
    draft = X.ExportedModel(artifact, device="cpu")
    engine = ServingEngine(model, max_batch=4, kv_blocks=48,
                           kv_block_size=4, spec_draft=draft,
                           spec_max_k=3).start()
    try:
        assert engine.spec_mode == "draft"
        for p, want in zip(prompts, plain):
            numpy.testing.assert_array_equal(engine.submit_generate(p, 10),
                                             want)
        c = engine.stats.snapshot()["counters"]
        assert c.get("spec.drafted", 0) >= 1
        assert c["spec.accepted"] == c["spec.drafted"]
        assert engine.draft_pool.occupancy()["blocks_used"] == 0
        engine._degrade_draft()
        assert engine.spec_mode == "ngram"
        numpy.testing.assert_array_equal(
            engine.submit_generate(prompts[0], 10), plain[0])
    finally:
        engine.stop()


class _PagedFake(object):
    """A paged model whose target stream is the fed token + 1 (mod 97):
    the port's pool accounting with no device storage."""

    max_position = 64

    def __init__(self):
        self.verify_shapes = []

    def make_kv_pool(self, n_blocks, block_size=16, kv_dtype=None):
        return X.KVBlockPool(n_blocks, block_size,
                             copy_fn=lambda storage, s, d: storage)

    def paged_extend(self, pool, tables, tokens, prior, chunk_lens, temps,
                     seeds):
        tokens, clens = numpy.asarray(tokens), numpy.asarray(chunk_lens)
        return numpy.array([(int(tokens[i, max(int(clens[i]) - 1, 0)]) + 1)
                            % 97 for i in range(tokens.shape[0])],
                           numpy.int32)

    def paged_step(self, pool, tables, pos, tok, gen_idx, temps, seeds):
        time.sleep(0.002)
        return (numpy.asarray(tok) + 1) % 97

    def paged_verify(self, pool, tables, pos, toks, draft_lens, gen_idx,
                     temps, seeds):
        self.verify_shapes.append(numpy.asarray(toks).shape)
        time.sleep(0.002)
        return (numpy.asarray(toks) + 1) % 97


def _expected(prompt, n):
    return (int(prompt[0, -1]) + 1 + numpy.arange(n)) % 97


class _Wrong(object):
    def propose(self, ctx, n_ctx, k):
        return numpy.full(int(k), 95, numpy.int32)


def test_rewind_frees_rejected_blocks():
    """Block size 1: every rejected draft position grew its own block,
    and the rewind returns them at the same boundary; accounting
    balances once the row retires."""
    engine = ServingEngine(_PagedFake(), max_batch=4, kv_blocks=128,
                           kv_block_size=1, spec=True, spec_max_k=3,
                           spec_adaptive=False)
    engine._drafter = _Wrong()
    engine.start()
    try:
        prompt = numpy.array([[11, 12]], numpy.int32)
        out = engine.submit_generate(prompt, 10)
        numpy.testing.assert_array_equal(out[0, 2:], _expected(prompt, 10))
        c = engine.stats.snapshot()["counters"]
        assert c.get("spec.rewound_blocks", 0) >= c.get("spec.rounds", 0) > 0
        assert c.get("spec.accepted", 0) == 0
        engine.kv_pool.drop_prefixes()
        assert engine.kv_pool.occupancy()["blocks_used"] == 0
    finally:
        engine.stop()


class _Chain(object):
    def propose(self, ctx, n_ctx, k):
        last = int(ctx[n_ctx - 1])
        return ((last + 1 + numpy.arange(int(k))) % 97).astype(numpy.int32)


def test_tail_block_copied_before_write():
    """When another owner holds the block the next write lands in, the
    engine copies it on write first (the pool's COW count), and the
    stream is unchanged."""
    engine = ServingEngine(_PagedFake(), max_batch=4, kv_blocks=64,
                           kv_block_size=4, spec=True, spec_max_k=3)
    engine._drafter = _Chain()
    engine.start()
    try:
        grabbed = []

        def grab_tail():
            for _ in range(400):
                with engine._cond:
                    rows = list(engine._rows)
                if rows and rows[0].table:
                    blk = rows[0].table[-1]
                    engine.kv_pool.retain([blk])
                    grabbed.append(blk)
                    return
                time.sleep(0.002)

        t = threading.Thread(target=grab_tail)
        t.start()
        prompt = numpy.array([[3, 4]], numpy.int32)
        out = engine.submit_generate(prompt, 40)
        t.join()
        numpy.testing.assert_array_equal(out[0, 2:], _expected(prompt, 40))
        assert grabbed
        assert engine.kv_pool.occupancy()["cow_copies"] >= 1
        engine.kv_pool.release(grabbed)
        engine.kv_pool.drop_prefixes()
        assert engine.kv_pool.occupancy()["blocks_used"] == 0
        assert engine.stats.get("spec.accepted") >= 1
    finally:
        engine.stop()
