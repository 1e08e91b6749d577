"""The port's normalizer registry against the JAX package's: every
registered kind, on the same seeded data (analysed in two slabs, so the
streaming accumulation runs), gives the JAX package's bytes for the
analysed state, ``normalize`` and ``denormalize`` (tolerance 0), and
its state survives a pickle."""

import pickle

import numpy
import pytest

import veles_tpu.normalization as jnorm
from veles_tpu_torch import normalization as tnorm

KINDS = {
    "none": {},
    "linear": {},
    "range_linear": {"interval": (0, 255), "target": (-1, 1)},
    "mean_disp": {},
    "external_mean": "mean",
    "pointwise": {},
}


def _data(seed):
    rng = numpy.random.RandomState(seed)
    data = rng.randint(0, 256, (40, 3, 4)).astype(numpy.float32)
    data[:, 0, 0] = 7.0   # a constant feature: a zero spread
    return data


def _make(pkg, kind):
    kwargs = KINDS[kind]
    if kwargs == "mean":
        kwargs = {"mean_source": _data(9).mean(axis=0)}
    return pkg.normalizer_factory(kind, **kwargs)


def test_every_kind_is_registered_in_both():
    assert sorted(tnorm.NormalizerRegistry.registry) == \
        sorted(jnorm.NormalizerRegistry.registry) == sorted(KINDS)


def _state_bytes(state):
    return pickle.dumps({k: numpy.asarray(v).tobytes() if not
                         isinstance(v, (bool, int, float, tuple)) else v
                         for k, v in sorted(state.items())})


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_normalizer_gives_the_jax_bytes(kind):
    data = _data(1)
    outs = []
    for pkg in (jnorm, tnorm):
        norm = _make(pkg, kind)
        norm.analyze(data[:25])
        norm.analyze(data[25:])
        y = norm.normalize(data)
        back = norm.denormalize(y)
        outs.append((_state_bytes(norm.state), y.dtype, y.tobytes(),
                     back.dtype, back.tobytes()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_normalizer_state_survives_a_pickle(kind):
    norm = _make(tnorm, kind)
    data = _data(2)
    y = norm.normalize(data)
    copy = pickle.loads(pickle.dumps(norm))
    assert type(copy) is type(norm)
    assert copy.is_analyzed == norm.is_analyzed
    assert copy.normalize(data).tobytes() == y.tobytes()
    assert copy.denormalize(y).tobytes() == norm.denormalize(y).tobytes()
