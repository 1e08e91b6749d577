"""The port's mesh layouts (``veles_tpu_torch.parallel``) against the
JAX package's, in this process and with no process group: a layout is
plain data there — a rank grid over named axes and one placement per
step tensor — so every applier and every rebuild runs without ranks.

Each case builds the port's and the JAX package's TinyLM from one seed,
applies the same style over an 8-slot mesh (8 virtual CPU devices for
the JAX package, ranks 0–7 for the port) and holds every parameter's,
optimizer slot's and batch vector's placement to the JAX package's
``PartitionSpec`` exactly, plus the units' sequence-parallel
attributes.  The rebuild cases are those of
``tests/test_transformer_tp.py`` (the JAX package runs the same rebuild
on its devices; the style, the mesh shape and the membership epoch must
agree).  Training under these styles is ``test_torch_distributed``'s.
"""

import importlib

import numpy
import pytest

import veles_tpu_torch.parallel as TP
from veles_tpu_torch.parallel.mesh import _transformer_tp_plan


class _JaxParallel(object):
    """``veles_tpu.parallel``, imported at first use: the spawned ranks
    of ``test_torch_distributed`` import this module for its fixture and
    must not import JAX."""

    def __getattr__(self, name):
        return getattr(importlib.import_module("veles_tpu.parallel"), name)


JP = _JaxParallel()


def _config_nodes(node):
    out = [(node, dict(node.__dict__))]
    for _, value in node.items():
        if isinstance(value, type(node)):
            out.extend(_config_nodes(value))
    return out


#: The engine and loader knobs the parallel tests' models read: unset
#: in both trees for the test (an earlier file on the same worker may
#: have left one of them in one tree), whatever the test sets after.
ENGINE_KNOBS = ("precision_level", "fused_qkv", "remat", "optimizer",
                "attention_dtype", "attention_kernel", "moe_top_k",
                "moe_router_z", "pp_schedule", "pp_chunks",
                "sp_ring_kernel", "zero")
LOADER_KNOBS = ("train_ratio", "shuffle_limit")


@pytest.fixture
def clean_roots():
    """Both packages' whole config trees, the knobs above unset in both
    for the test and every node's ``__dict__`` put back whole after it;
    yields (JAX root, port root)."""
    from veles_tpu.config import root as jroot
    from veles_tpu_torch.config import root as troot
    saved = _config_nodes(jroot) + _config_nodes(troot)
    for r in (jroot, troot):
        for key in ENGINE_KNOBS:
            r.common.engine.__dict__.pop(key, None)
        for key in LOADER_KNOBS:
            r.common.loader.__dict__.pop(key, None)
    yield jroot, troot
    for node, state in saved:
        node.__dict__.clear()
        node.__dict__.update(state)


@pytest.fixture(autouse=True)
def _kept_roots(clean_roots):
    yield


def _pair(**kwargs):
    from test_torch_training import _build
    kwargs.setdefault("max_epochs", 1)
    return _build(seed=42, **kwargs)


def _spec(jvec):
    sharding = jvec.sharding
    return () if sharding is None else tuple(sharding.spec)


def _vectors(wf):
    """{name: Vector} of every trainable, optimizer slot and batch
    vector of a workflow, keyed alike in both packages."""
    out = {}
    for u in wf.units:
        for which in ("trainables", "tstate"):
            for attr, vec in (getattr(u, which, None) or {}).items():
                if vec:
                    out["%s/%s" % (u.name, attr)] = vec
    loader = wf.loader
    for attr in ("minibatch_indices", "minibatch_mask"):
        out["loader/" + attr] = getattr(loader, attr)
    return out


def _assert_same_layout(jwf, twf):
    jv, tv = _vectors(jwf), _vectors(twf)
    assert sorted(jv) == sorted(tv)
    for name in jv:
        assert (tv[name].placement or ()) == _spec(jv[name]), name
    assert twf._parallel_style_ == jwf._parallel_style_
    assert twf.mesh.shape == dict(jwf.mesh.shape)
    for ju, tu in zip(jwf.forwards, twf.forwards):
        for attr in ("sp_kernel", "seq_axis"):
            assert getattr(tu, attr, None) == getattr(ju, attr, None), \
                (tu.name, attr)


def _jmesh(axes, n=8):
    import jax
    return JP.make_mesh(jax.devices()[:n], axes)


def _tmesh(axes, n=8):
    return TP.make_mesh(range(n), axes)


#: case → (TinyLM kwargs, applier name, mesh axes, applier kwargs,
#: ZeRO level).
LAYOUTS = {
    "dp": ({}, "apply_dp_sharding", {"data": 8}, {}, 0),
    "dp_tp_dense": ({}, "apply_dp_tp_sharding", {"data": 2, "model": 4},
                    {}, 0),
    "dp_tp_fused": ({"fused_qkv": True}, "apply_dp_tp_sharding",
                    {"data": 2, "model": 4}, {}, 0),
    "dp_tp_indivisible_heads": ({"embed_dim": 24, "n_heads": 3},
                                "apply_dp_tp_sharding",
                                {"data": 2, "model": 4}, {}, 0),
    "dp_tp_moe": ({"n_experts": 4}, "apply_dp_tp_sharding",
                  {"data": 2, "model": 4}, {}, 0),
    "dp_tp_pipelined": ({"pipelined": True, "n_blocks": 2,
                         "n_microbatches": 2}, "apply_dp_tp_sharding",
                        {"data": 2, "model": 4}, {}, 0),
    "dp_tp_sp": ({"seq_axis": "seq"}, "apply_dp_tp_sp_sharding",
                 {"data": 2, "model": 2, "seq": 2}, {"sp_kernel": "xla"},
                 0),
    "dp_sp": ({"seq_axis": "seq"}, "apply_dp_sp_sharding",
              {"data": 2, "seq": 4}, {}, 0),
    "dp_ep": ({"n_experts": 4}, "apply_dp_ep_sharding",
              {"data": 2, "expert": 4}, {}, 0),
    "dp_ep_tp": ({"n_experts": 4}, "apply_dp_ep_tp_sharding",
                 {"data": 2, "expert": 2, "model": 2}, {}, 0),
    "dp_pp": ({"pipelined": True, "n_blocks": 4, "n_microbatches": 2},
              "apply_dp_pp_sharding", {"data": 2, "stage": 4}, {}, 0),
    "dp_pp_tp": ({"pipelined": True, "n_blocks": 2, "n_microbatches": 2},
                 "apply_dp_pp_tp_sharding",
                 {"data": 2, "stage": 2, "model": 2}, {}, 0),
    "zero1_dp_tp": ({}, "apply_dp_tp_sharding", {"data": 2, "model": 4},
                    {}, 1),
    "zero2_dp": ({"optimizer": None}, "apply_dp_sharding", {"data": 8},
                 {}, 2),
    "zero1_dp_ep": ({"n_experts": 4}, "apply_dp_ep_sharding",
                    {"data": 2, "expert": 4}, {}, 1),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_matches_jax(case):
    lm, applier, axes, kwargs, zero = LAYOUTS[case]
    lm = {k: v for k, v in lm.items() if v is not None}
    jwf, twf = _pair(**lm)
    getattr(JP, applier)(jwf, _jmesh(axes), **kwargs)
    getattr(TP, applier)(twf, _tmesh(axes), **kwargs)
    if zero:
        JP.apply_zero_sharding(jwf, level=zero)
        TP.apply_zero_sharding(twf, level=zero)
        assert twf._zero_ == jwf._zero_
    _assert_same_layout(jwf, twf)


def test_dense_block_is_megatron_sharded():
    """The canonical plan spelled out: q/k/v and w1 column, wo and w2
    row, the q/k/v biases sharded, the residual side replicated, the
    embedding's embed dim sharded, the momentum mirroring by name."""
    _, twf = _pair()
    TP.apply_dp_tp_sharding(twf, _tmesh({"data": 2, "model": 4}))
    blk = twf.forwards[1]
    place = {n: v.placement for n, v in blk.params.items()}
    assert place["wq"] == place["w1"] == (None, "model")
    assert place["wo"] == place["w2"] == ("model", None)
    assert place["bq"] == place["b1"] == ("model",)
    assert place["bo"] == place["ln1_g"] == ()
    assert twf.embedding.weights.placement == (None, "model")
    gd = [g for g in twf.gds if g.target is blk][0]
    assert gd.tstate["velocity_wo"].placement == ("model", None)


def test_uninitialized_unit_degrades_to_replicated():
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.znicz.attention import TransformerBlock
    _, twf = _pair()
    blk = TransformerBlock(twf, n_heads=2, name="orphan")
    assert _transformer_tp_plan(blk, 4, "model") is None
    blk.input = Vector()
    assert _transformer_tp_plan(blk, 4, "model") is None


def test_mesh_grid_lines_and_pickling():
    """A mesh is a rank grid: the lines a collective runs in, the
    coordinates of a rank, -1 as the remaining ranks; pickling keeps
    the grid and drops the process groups."""
    import pickle
    mesh = TP.make_mesh(range(8), {"data": 2, "model": -1})
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.line(("model",), 5) == [4, 5, 6, 7]
    assert mesh.line(("data",), 5) == [1, 5]
    assert mesh.line(("data", "model"), 5) == list(range(8))
    assert mesh.coords(6) == {"data": 1, "model": 2}
    assert mesh.group(()) is None
    mesh._groups_["x"] = object()
    again = pickle.loads(pickle.dumps(mesh))
    assert again._groups_ == {} and again.shape == mesh.shape
    with pytest.raises(RuntimeError, match="torch.distributed"):
        again.group("data")


def test_snapshot_pickles_no_layout():
    """A pickled workflow carries its weights but no mesh and no
    placement (a restore re-places on the topology it finds)."""
    import pickle
    _, twf = _pair()
    TP.apply_dp_tp_sharding(twf, _tmesh({"data": 2, "model": 4}))
    back = pickle.loads(pickle.dumps(twf))
    assert back.mesh is None and back._parallel_style_ is None
    assert back.forwards[1].params["wq"].placement is None
    numpy.testing.assert_array_equal(
        back.forwards[1].params["wq"].mem,
        twf.forwards[1].params["wq"].mem)


#: rebuild case → (TinyLM kwargs, applier, axes, survivors, epoch,
#: expected style, expected shape).
REBUILDS = {
    "dp_sp_8_to_4": ({"seq_axis": "seq"}, "apply_dp_sp_sharding",
                     {"data": 2, "seq": 4}, 4, None, "dp_sp",
                     {"data": 2, "seq": 2}),
    "dp_ep_8_to_4": ({"n_experts": 4}, "apply_dp_ep_sharding",
                     {"data": 2, "expert": 4}, 4, None, "dp_ep",
                     {"data": 2, "expert": 2}),
    "dp_pp_8_to_4": ({"pipelined": True, "n_blocks": 4,
                      "n_microbatches": 2}, "apply_dp_pp_sharding",
                     {"data": 2, "stage": 4}, 4, None, "dp_pp",
                     {"data": 2, "stage": 2}),
    "three_axis_8_to_4": ({"seq_axis": "seq"}, "apply_dp_tp_sp_sharding",
                          {"data": 2, "model": 2, "seq": 2}, 4, None,
                          "dp_tp_sp", {"data": 1, "model": 2, "seq": 2}),
    "partial_fit_8_to_6": ({"seq_axis": "seq"},
                           "apply_dp_tp_sp_sharding",
                           {"data": 2, "model": 2, "seq": 2}, 6, None,
                           "dp_tp", {"data": 3, "model": 2}),
    "growth_4_to_8": ({"seq_axis": "seq"}, "apply_dp_sp_sharding",
                      {"data": 2, "seq": 2}, 8, 17, "dp_sp",
                      {"data": 4, "seq": 2}),
    "indivisible_to_dp": ({"seq_axis": "seq"}, "apply_dp_sp_sharding",
                          {"data": 2, "seq": 4}, 3, None, "dp",
                          {"data": 3}),
    "zero_dp_tp_8_to_4": ({}, "apply_dp_tp_sharding",
                          {"data": 2, "model": 4}, 4, None, "dp_tp",
                          {"data": 2, "model": 2}),
}


@pytest.mark.parametrize("case", sorted(REBUILDS))
def test_rebuild_matches_jax(case):
    """rebuild_mesh over the survivors re-forms the style where it
    divides (shrink keeps the data axis, growth widens it, a 3-axis
    style falls to a 2-axis one before plain dp), re-applies ZeRO,
    stamps the membership epoch and counts the direction — as the JAX
    package's rebuild does on its devices."""
    import jax
    import veles_tpu_torch.resilience as tres
    lm, applier, axes, n, epoch, style, shape = REBUILDS[case]
    jwf, twf = _pair(**lm)
    start = 4 if case.startswith("growth") else 8
    getattr(JP, applier)(jwf, _jmesh(axes, start))
    getattr(TP, applier)(twf, _tmesh(axes, start))
    if case.startswith("zero"):
        JP.apply_zero_sharding(jwf, level=1)
        TP.apply_zero_sharding(twf, level=1)
    before = tres.stats.snapshot()
    JP.rebuild_mesh(jwf, jax.devices()[:n], epoch=epoch)
    TP.rebuild_mesh(twf, list(range(n)), epoch=epoch)
    assert twf._parallel_style_[0] == style == jwf._parallel_style_[0]
    assert twf.mesh.shape == shape == dict(jwf.mesh.shape)
    assert twf._membership_epoch_ == jwf._membership_epoch_ == \
        (epoch if epoch is not None else 1)
    after = tres.stats.snapshot()
    way = "membership.grow" if n > start else "membership.shrink"
    assert after.get(way, 0) == before.get(way, 0) + 1
    assert after.get("membership.rebuilds", 0) == \
        before.get("membership.rebuilds", 0) + 1
    _assert_same_layout(jwf, twf)
