"""A whole-prompt prefix-cache hit against the prompt's first serving
(``veles_tpu_torch.export.ExportedModel.paged_extend`` and the serving
engine's prefix path).

When every block of a prompt is cached, the engine re-feeds only the
prompt's last token: a one-row chunk, whose products and attention take
the decode path.  The first serving of a prompt longer than
``DECODE_MAX_Q`` tokens ends with the same one-row program
(``export.extend_chunks``), so on every KV plane the hit's first logits,
its first token and the k/v it writes at the last position equal the
first serving's bit for bit — ``torch.equal``, not a tolerance: when the
first token is nearly tied, any difference can flip it.

The LM is small (2 blocks, E=64, H=2, vocab 64, numpy seed 77); the
prompts (40 and 48 tokens) are longer than ``DECODE_MAX_Q`` = 16 and a
multiple of the block size (8).  On the CPU the dense prefill chunk and
the one-row chunk round apart at these widths, so a first serving that
computed its last position in the dense chunk fails these tests.
"""

import numpy
import pytest
import torch

from veles_tpu_torch import export as X
from veles_tpu_torch.ops.decode_attention import DECODE_MAX_Q
from veles_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

BLOCK = 8
PROMPT_LENGTHS = (40, 48)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tprefix") / "lm.veles.tgz")
    X.random_lm_artifact(path, vocab=64, embed=64, n_heads=2, n_blocks=2,
                         hidden=128, max_position=128, seed=77)
    return X.ExportedModel(path, device="cpu")


def _prompt(n, seed=3):
    return numpy.random.RandomState(seed + n).randint(0, 64, n)


@pytest.fixture
def first_logits(monkeypatch):
    """The logits each ``paged_extend`` call sampled its first tokens
    from, one list per call (the head runs once per real row: on the
    row's last chunk)."""
    calls = []
    head = X._head_logits

    def capture(x, params):
        y = head(x, params)
        if calls and calls[-1] is not None:
            calls[-1].append(y.clone())
        return y

    monkeypatch.setattr(X, "_head_logits", capture)
    return calls


def _recorded(model, calls):
    """``model.paged_extend`` that opens a list in ``calls`` for each
    call (and closes it after, so steps are not recorded)."""
    extend = model.paged_extend

    def call(*args, **kwargs):
        calls.append([])
        try:
            return extend(*args, **kwargs)
        finally:
            calls.append(None)
    return call


def _planes(pool, block):
    return [t[block].clone() for group in pool.storage for t in group]


def test_extend_chunks_end_with_one_row():
    """Chunks of at most DECODE_MAX_Q rows run whole; a longer one ends
    with its last position alone."""
    assert X.extend_chunks(1) == [1]
    assert X.extend_chunks(DECODE_MAX_Q) == [DECODE_MAX_Q]
    assert X.extend_chunks(DECODE_MAX_Q + 1) == [DECODE_MAX_Q, 1]
    assert X.extend_chunks(700) == [699, 1]


@pytest.mark.parametrize("n", PROMPT_LENGTHS)
@pytest.mark.parametrize("kv_dtype", X.KV_DTYPES)
def test_whole_prompt_hit_is_first_serving_bit_for_bit(model, first_logits,
                                                       kv_dtype, n):
    """The engine's two calls on one pool: the first serving (a miss,
    the whole prompt from position 0), then a whole-prompt hit (a
    copy-on-write of the last block, the last token re-fed at position
    n − 1).  The hit's first logits and token equal the miss's, and the
    block it rewrote equals the cached one in every plane tensor (codes
    and scales included)."""
    prompt = _prompt(n)
    pool = model.make_kv_pool(2 * n // BLOCK + 2, BLOCK, kv_dtype)
    ids = pool.alloc(n // BLOCK)
    extend = _recorded(model, first_logits)
    zeros = numpy.zeros(1, numpy.float32)
    seeds = numpy.zeros(1, numpy.uint32)
    miss = extend(pool, numpy.asarray([ids], numpy.int32),
                  prompt[None].astype(numpy.int32),
                  numpy.zeros(1, numpy.int32), numpy.full(1, n, numpy.int32),
                  zeros, seeds)
    cached = _planes(pool, ids[-1])
    copy = pool.cow_copy(ids[-1])
    hit = extend(pool, numpy.asarray([list(ids[:-1]) + [copy]], numpy.int32),
                 prompt[None, -1:].astype(numpy.int32),
                 numpy.full(1, n - 1, numpy.int32), numpy.ones(1, numpy.int32),
                 zeros, seeds)
    opened = [c for c in first_logits if c is not None]
    assert [len(c) for c in opened] == [1, 1]
    assert torch.equal(opened[0][0], opened[1][0])
    assert miss[0] == hit[0]
    for a, b in zip(cached, _planes(pool, copy)):
        assert torch.equal(a, b)
    for a, b in zip(cached, _planes(pool, ids[-1])):
        assert torch.equal(a, b)   # the shared block stays untouched


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_engine_repeated_prompt_answers_as_first_serving(model,
                                                         first_logits,
                                                         monkeypatch,
                                                         kv_dtype):
    """Through the serving engine: a prompt served twice, the second
    time a whole-prompt prefix-cache hit, samples its first token from
    the same logits bit for bit and answers the same tokens."""
    monkeypatch.setattr(model, "paged_extend",
                        _recorded(model, first_logits))
    engine = ServingEngine(model, max_batch=2, kv_blocks=48,
                           kv_block_size=BLOCK, kv_dtype=kv_dtype).start()
    try:
        prompt = _prompt(PROMPT_LENGTHS[0])
        first = engine.submit_generate(prompt[None], 6)
        hits = engine.kv_pool.prefix_hits
        again = engine.submit_generate(prompt[None], 6)
        assert engine.kv_pool.prefix_hits > hits
        assert engine.kv_pool.cow_copies >= 1
    finally:
        engine.stop(drain=True)
    numpy.testing.assert_array_equal(first, again)
    opened = [c for c in first_logits if c is not None]
    assert [len(c) for c in opened] == [1, 1]
    assert torch.equal(opened[0][0], opened[1][0])
