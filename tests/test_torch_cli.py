"""The port's command line against the JAX package's
(``veles_tpu.cmdline.init_argparser``): every option of the JAX parser
is parsed by ``veles_tpu_torch.__main__.make_parser`` or refused by
name, with its ROADMAP queue (or, for ``--attn-decode-kernel``, the
reason it has no counterpart); the flags the port parses leave the same
keys with the same values in both packages' ``root`` trees, config
sources first and explicit flags after them."""

import contextlib

import pytest

from veles_tpu import __main__ as jmain
from veles_tpu.cmdline import init_argparser
from veles_tpu.config import root as jroot

from veles_tpu_torch import __main__ as tmain
from veles_tpu_torch import restful as trestful
from veles_tpu_torch.config import root as troot

SUBTREES = ("serving", "guardian", "loader", "engine", "population",
            "genetics", "server", "observability")


def _jax_options():
    parser = init_argparser(prog="veles_tpu")
    return sorted({s for a in parser._actions for s in a.option_strings})


def _port_options():
    parser = tmain.make_parser()
    return {s for a in parser._actions for s in a.option_strings}


JAX_OPTIONS = _jax_options()
#: The flags refused until A8b-i ported them, with a value each parses.
PORTED_A8B_I = {"-a": "cpu", "--backend": "auto", "--dry-run": "init",
                "--dump-config": None, "--profile": "prof",
                "--workflow-graph": "graph.dot"}
REFUSED = sorted(set(JAX_OPTIONS) - _port_options())


def test_every_jax_option_is_parsed_or_refused_by_name():
    port = _port_options()
    refused = set(tmain.NOT_PORTED) | set(tmain.NO_COUNTERPART)
    missing = [o for o in JAX_OPTIONS if o not in port and
               o not in refused]
    assert missing == []
    # A flag is one or the other, never both.
    assert sorted(port & refused) == []
    assert tmain.NOT_PORTED == {"--frontend": "A8b-ii"}


@pytest.mark.parametrize("flag", REFUSED + sorted(PORTED_A8B_I))
def test_refused_flag_names_its_queue(flag):
    """A refused flag raises naming its queue or its reason; the flags
    refused until A8b-i (``-a``, ``--backend``, ``--dry-run``,
    ``--workflow-graph``, ``--dump-config``, ``--profile``) now parse."""
    if flag in PORTED_A8B_I:
        value = PORTED_A8B_I[flag]
        args = tmain.Main(["wf.py", flag] + (
            [] if value is None else [value])).parse()
        dest = {"-a": "device", "--backend": "device"}.get(
            flag, flag.lstrip("-").replace("-", "_"))
        assert getattr(args, dest) == (True if value is None else value)
        assert flag not in tmain.NOT_PORTED
        return
    with pytest.raises(NotImplementedError) as err:
        tmain.Main(["wf.py", flag, "1"]).parse()
    if flag in tmain.NOT_PORTED:
        assert "ROADMAP %s" % tmain.NOT_PORTED[flag] in str(err.value)
    else:
        assert tmain.NO_COUNTERPART[flag] in str(err.value)


def test_attn_decode_kernel_refused_with_its_reason():
    with pytest.raises(NotImplementedError) as err:
        tmain.Main(["wf.py", "--attn-decode-kernel=auto"]).parse()
    text = str(err.value)
    assert "no counterpart" in text and "B4/B5" in text
    assert "--attn-decode-kernel" not in tmain.NOT_PORTED


@contextlib.contextmanager
def _kept_trees():
    """Restores both packages' ``root.common`` subtrees the case
    touches."""
    saved = [(node, dict(node.__dict__)) for r in (jroot, troot)
             for node in (getattr(r.common, name) for name in SUBTREES)]
    try:
        yield
    finally:
        for node, state in saved:
            node.__dict__.clear()
            node.__dict__.update(state)


def _leaves(r):
    return {name: getattr(r.common, name).as_dict() for name in SUBTREES}


def _diff(before, after):
    out = {}
    for name in SUBTREES:
        for key, value in after[name].items():
            if before[name].get(key, object()) != value:
                out["%s.%s" % (name, key)] = value
    return out


def _apply(module, root_, argv, sources=()):
    """The keys ``argv`` (after the config ``sources``) sets in
    ``root_``'s subtrees, through ``module``'s Main."""
    main = module.Main(["wf.py"] + list(sources) + list(argv))
    main.parse()
    before = _leaves(root_)
    module.apply_config_sources(list(main.args.config))
    main.apply_subsystem_flags()
    return _diff(before, _leaves(root_))


R1_CASES = [
    (["--optimizer", "adam"], {"engine.optimizer": "adam"}),
    (["--guardian-spike", "3.5"], {"guardian.spike_factor": 3.5}),
    (["--guardian-window", "7"], {"guardian.window": 7}),
    (["--train-ratio", "0.5"], {"loader.train_ratio": 0.5}),
    (["--shuffle-limit", "3"], {"loader.shuffle_limit": 3}),
    (["--attn-fused-qkv", "on"], {"engine.fused_qkv": True}),
    (["--attn-fused-qkv=off"], {"engine.fused_qkv": False}),
    (["--attn-dtype", "bf16"], {"engine.attention_dtype": "bf16"}),
    (["--attn-kernel", "xla"], {"engine.attention_kernel": "xla"}),
]

SERVE_CASES = [
    (["--serve-max-batch", "4"], {"serving.max_batch": 4}),
    (["--serve-queue-depth", "9"], {"serving.queue_depth": 9}),
    (["--serve-rate-limit", "2.5"], {"serving.rate_limit": 2.5}),
    (["--serve-deadline", "60"], {"serving.deadline": 60.0}),
    (["--serve-token", "s3"], {"serving.token": "s3"}),
    (["--serve-warmup"], {"serving.warmup": True}),
    (["--serve-kv-blocks", "33"], {"serving.kv_blocks": 33}),
    (["--serve-kv-block-size", "8"], {"serving.kv_block_size": 8}),
    (["--serve-kv-dtype", "int8"], {"serving.kv_dtype": "int8"}),
    (["--serve-weight-dtype", "int8"], {"serving.weight_dtype": "int8"}),
    (["--serve-no-paged"], {"serving.paged": False}),
    (["--serve-spec"], {"serving.spec": True}),
    (["--serve-spec-draft", "d.veles.tgz"],
     {"serving.spec_draft": "d.veles.tgz"}),
    (["--serve-spec-max-k", "3"], {"serving.spec_max_k": 3}),
    (["--serve-spec-draft-blocks", "12"],
     {"serving.spec_draft_blocks": 12}),
    (["--serve-drain-timeout", "5"], {"serving.drain_timeout": 5.0}),
    (["--serve-reload-watch", "m_current.lnk"],
     {"serving.reload_watch": "m_current.lnk"}),
    (["--serve-reload-poll", "0.5"], {"serving.reload_poll": 0.5}),
    (["--serve-fabric-replicas", "2"], {"serving.fabric_replicas": 2}),
    (["--serve-fabric-disagg"], {"serving.fabric_disagg": True}),
    (["--serve-tenant", "a=1:2", "--serve-tenant", "b=5@m.tgz"],
     {"serving.tenant": ["a=1:2", "b=5@m.tgz"]}),
]


@pytest.mark.parametrize("argv,want", R1_CASES + SERVE_CASES,
                         ids=lambda v: " ".join(v)
                         if isinstance(v, list) else "")
def test_flag_sets_the_same_keys_in_both_trees(argv, want):
    with _kept_trees():
        got_jax = _apply(jmain, jroot, argv)
    with _kept_trees():
        got_port = _apply(tmain, troot, argv)
    assert got_jax == want
    assert got_port == want


def test_every_port_serve_flag_is_covered():
    covered = {a[0].split("=")[0] for a, _ in SERVE_CASES}
    port = {o for o in _port_options() if o.startswith("--serve-")}
    assert covered == port and len(port) == 21


def test_all_flags_at_once_and_the_serving_defaults():
    argv = [a for case, _ in R1_CASES[:-3] + SERVE_CASES for a in case]
    with _kept_trees():
        got_jax = _apply(jmain, jroot, argv)
        jax_defaults = __import__(
            "veles_tpu.restful", fromlist=["x"]).serving_config_defaults()
    with _kept_trees():
        got_port = _apply(tmain, troot, argv)
        port_defaults = trestful.serving_config_defaults()
    assert got_jax == got_port
    assert len(got_port) == len(R1_CASES) - 3 + len(SERVE_CASES)
    assert jax_defaults == port_defaults
    assert port_defaults["max_batch"] == 4


def test_explicit_flags_win_over_config_sources():
    sources = ["root.common.serving.max_batch=3",
               "root.common.serving.deadline=9.0",
               "root.common.guardian.window=2"]
    argv = ["--serve-max-batch", "5", "--guardian-window", "6"]
    with _kept_trees():
        got_jax = _apply(jmain, jroot, argv, sources)
    with _kept_trees():
        got_port = _apply(tmain, troot, argv, sources)
    want = {"serving.max_batch": 5, "serving.deadline": 9.0,
            "guardian.window": 6}
    assert got_jax == want
    assert got_port == want


#: The meta-workflow flags (genetics, populations, ensembles): only
#: ``--population-vmap`` sets a key; the others choose the run's mode.
META_CASES = [
    (["--population-vmap", "on"], {"population.vmap": True}),
    (["--population", "4:2"], {}),
    (["--optimize", "4:2"], {}),
    (["--ensemble-train", "2:0.8"], {}),
    (["--ensemble-test", "ens.json"], {}),
]


@pytest.mark.parametrize("argv,want", META_CASES,
                         ids=lambda v: " ".join(v)
                         if isinstance(v, list) else "")
def test_meta_flag_sets_the_same_keys_in_both_trees(argv, want):
    with _kept_trees():
        got_jax = _apply(jmain, jroot, argv)
    with _kept_trees():
        got_port = _apply(tmain, troot, argv)
    assert got_jax == want
    assert got_port == want
    args = tmain.Main(["wf.py"] + argv).parse()
    dest = argv[0].lstrip("-").replace("-", "_")
    assert getattr(args, dest) == (argv[1] if dest != "population_vmap"
                                   else "on")


@pytest.mark.parametrize("flag", ["--pbt", "--pbt-interval",
                                  "--ensemble-population", "-l", "-m"])
def test_fleet_population_flags_stay_refused_naming_a7a(flag):
    """The fleet's flags, refused by name until their queues (A7a, A7b)
    were ported, now parse: ``-l`` and ``-m`` choose the launcher's
    master and worker modes, ``--pbt`` and ``--ensemble-population``
    the population's scheduling, ``--pbt-interval`` its key."""
    if flag in ("-l", "-m"):
        main = tmain.Main(["wf.py", flag, "127.0.0.1:1"])
        main.parse()
        kw = main._launcher_kwargs()
        key = "listen_address" if flag == "-l" else "master_address"
        assert kw == {key: "127.0.0.1:1"}
        return
    argv = ["wf.py", flag] + (["2"] if flag == "--pbt-interval" else [])
    args = tmain.Main(argv).parse()
    dest = flag.lstrip("-").replace("-", "_")
    assert getattr(args, dest) == (2 if flag == "--pbt-interval"
                                   else True)
    assert flag not in tmain.NOT_PORTED


#: The fleet's flags (A7a-ii, A7b): the keys they set in both trees.
FLEET_CASES = [
    (["--pbt-interval", "3"], {"population.pbt_interval": 3}),
    (["--pbt-quantile", "0.4"], {"population.pbt_quantile": 0.4}),
    (["--pbt-perturb", "1.5"], {"population.pbt_perturb": 1.5}),
    (["--population-vmap", "off"], {"population.vmap": False}),
    (["--blacklist-cooldown", "7.5"],
     {"server.blacklist_cooldown": 7.5}),
    (["--pbt"], {}),
    (["--ensemble-population"], {}),
    (["--nodes", "local,host2"], {}),
]


@pytest.mark.parametrize("argv,want", FLEET_CASES,
                         ids=lambda v: " ".join(v)
                         if isinstance(v, list) else "")
def test_fleet_flag_sets_the_same_keys_in_both_trees(argv, want):
    with _kept_trees():
        got_jax = _apply(jmain, jroot, argv)
    with _kept_trees():
        got_port = _apply(tmain, troot, argv)
    assert got_jax == want
    assert got_port == want


#: The parallelism flags: the six knobs land at the JAX command line's
#: ``root.common.engine`` keys; the three ``--jax-*`` flags set no key —
#: they choose the launcher's distributed mode (checked below).
A6_CASES = [
    (["--pp-schedule", "1f1b"], {"engine.pp_schedule": "1f1b"}),
    (["--pp-chunks", "2"], {"engine.pp_chunks": 2}),
    (["--moe-topk", "2"], {"engine.moe_top_k": 2}),
    (["--moe-router-z", "0.001"], {"engine.moe_router_z": 0.001}),
    (["--sp-ring-kernel", "xla"], {"engine.sp_ring_kernel": "xla"}),
    (["--zero", "2"], {"engine.zero": 2}),
    (["--jax-coordinator", "127.0.0.1:9"], {}),
    (["--jax-num-processes", "2"], {}),
    (["--jax-process-id", "1"], {}),
]


@pytest.mark.parametrize("argv,want", A6_CASES,
                         ids=lambda v: " ".join(v)
                         if isinstance(v, list) else "")
def test_parallelism_flag_sets_the_same_keys_in_both_trees(argv, want):
    with _kept_trees():
        got_jax = _apply(jmain, jroot, argv)
    with _kept_trees():
        got_port = _apply(tmain, troot, argv)
    assert got_jax == want
    assert got_port == want


def test_jax_flags_choose_the_distributed_launcher_together():
    """The three ``--jax-*`` flags make the launcher distributed; a
    partial set raises, as in the JAX command line."""
    from veles_tpu_torch.error import Bug
    main = tmain.Main(["wf.py", "--jax-coordinator", "127.0.0.1:9",
                       "--jax-num-processes", "2", "--jax-process-id",
                       "1"])
    main.parse()
    assert main._launcher_kwargs() == {
        "mode": "distributed", "coordinator_address": "127.0.0.1:9",
        "num_processes": 2, "process_id": 1}
    for argv in (["--jax-coordinator", "127.0.0.1:9"],
                 ["--jax-num-processes", "2", "--jax-process-id", "1"],
                 ["--jax-coordinator", "h:1", "--jax-num-processes", "2",
                  "--jax-process-id", "2"]):
        main = tmain.Main(["wf.py"] + argv)
        main.parse()
        with pytest.raises(Bug, match="must be given together"):
            main._launcher_kwargs()
    assert tmain.Main(["wf.py"]).parse() is not None


#: The observability flags (A8a): ``--trace-out`` sets the trace keys
#: and turns tracing on (with ``--trace-ring``'s ring), ``--xprof`` its
#: key and arms the capture window; alone, ``--trace-ring`` and
#: ``--xprof-steps`` set nothing, as in the JAX command line.
OBS_CASES = [
    (["--trace-out", "t.json"],
     {"observability.trace_out": "t.json", "observability.trace": True}),
    (["--trace-out", "t.json", "--trace-ring", "64"],
     {"observability.trace_out": "t.json", "observability.trace": True}),
    (["--trace-ring", "64"], {}),
    (["--xprof", "xp"], {"observability.xprof": "xp"}),
    (["--xprof", "xp", "--xprof-steps", "3"], {"observability.xprof": "xp"}),
    (["--xprof-steps", "3"], {}),
]


@pytest.mark.parametrize("argv,want", OBS_CASES,
                         ids=lambda v: " ".join(v)
                         if isinstance(v, list) else "")
def test_observability_flag_sets_the_same_keys_in_both_trees(argv, want):
    """The same keys in both trees, and the same live state: tracing on
    with the same ring size, the same capture window armed."""
    from veles_tpu.observability import attribution as jattr
    from veles_tpu.observability import tracing as jtrace
    from veles_tpu_torch.observability import attribution as tattr
    from veles_tpu_torch.observability import tracing as ttrace
    try:
        with _kept_trees():
            got_jax = _apply(jmain, jroot, argv)
        with _kept_trees():
            got_port = _apply(tmain, troot, argv)
        assert got_jax == want
        assert got_port == want
        assert ttrace.enabled() == jtrace.enabled() == \
            ("--trace-out" in argv)
        assert ttrace._collector.maxlen == jtrace._collector.maxlen
        for key in ("dir", "steps"):
            assert tattr._xprof[key] == jattr._xprof[key]
    finally:
        for mod in (ttrace, jtrace, tattr, jattr):
            mod.reset()
