"""Base classes of the neural-network layer units (the JAX package's
``znicz.nn_units``).

* :class:`ForwardBase` — a forward layer with ``input``/``output``
  Vectors and optional ``weights``/``bias`` trainables;
* :class:`GradientDescentBase` — the per-layer trainer unit holding the
  update hyperparameters and optimizer slots; the backward comes from
  autograd over the composed forward, and the unit applies its
  optimizer's rule inside the same step.

Both take part in the data plane: a forward unit ships its trainables
to workers and folds their updates back (:class:`ForwardBase`'s wire
dialects), and a GD unit syncs a 1/K shard of its optimizer slots over
the wire when ``--net-zero K`` is negotiated.
"""

import numpy
import torch

from .. import prng
from ..accelerated_units import TracedUnit
from ..config import root, get as config_get
from ..memory import Vector
from ..registry import MappedUnitRegistry
from . import optimizers


#: znicz scaled-tanh constants (1.7159·tanh(0.6666·x)).
TANH_A = 1.7159
TANH_B = 0.6666


# -- shared activation bodies (the all2all, conv and standalone
# activation families) ---------------------------------------------------


def act_tanh(v):
    return TANH_A * torch.tanh(TANH_B * v)


def act_softplus(v):
    """znicz "RELU": log(1 + e^x)."""
    return torch.nn.functional.softplus(v)


def act_strict_relu(v):
    """max(x, 0); a tie at 0 sends half the gradient each way, as
    ``jnp.maximum`` does (``torch.relu`` would send none)."""
    return torch.maximum(v, torch.zeros_like(v))


def act_sigmoid(v):
    return torch.sigmoid(v)


def _proto_of_slave(unit, slave):
    """The wire protocol negotiated with one worker ({} = legacy)."""
    get = getattr(unit.workflow, "slave_protocol", None)
    return get(slave) if get is not None else {}


def _proto_of_net(unit):
    """This worker session's negotiated protocol ({} = legacy)."""
    return getattr(unit.workflow, "net_proto", None) or {}


def _as_bits(arr):
    return arr.view(numpy.dtype("u%d" % arr.dtype.itemsize))


def _xor(arr, bits):
    """``arr`` with ``bits`` XOR-ed into its bit pattern."""
    return numpy.bitwise_xor(_as_bits(arr),
                             bits.reshape(arr.shape)).view(arr.dtype)


def fold_update(current, theirs, base):
    """The master's fold of one worker update (delayed SGD):
    ``current + (theirs − base)`` — the worker trained ``base`` into
    ``theirs`` while the master moved on to ``current`` — and exactly
    ``theirs`` wherever ``current`` is still ``base`` bit for bit.
    Rounded, ``base + (theirs − base)`` can miss ``theirs`` (a weight
    that shrinks by more than half in one job); with one worker and
    serialized jobs the fold therefore lands each job's result exactly,
    and the trajectory is the in-process one."""
    new = current + (theirs - base)
    same = _as_bits(current) == _as_bits(base)
    new[same] = theirs[same]
    return new


def dot(a, w, cdt):
    """``a @ w`` with both operands rounded to ``cdt`` and a float32
    result — the JAX package's ``jnp.dot(a.astype(cdt), w.astype(cdt),
    preferred_element_type=float32)``."""
    return torch.matmul(a.to(cdt).float(), w.to(cdt).float())


class ForwardUnitRegistry(MappedUnitRegistry):
    """String → forward-layer class."""
    registry = {}


class GDUnitRegistry(MappedUnitRegistry):
    """String → trainer class, under the MAPPING of its forward
    layer."""
    registry = {}


def gd_for(layer_or_mapping):
    """The GD unit class paired with a forward layer (by its MAPPING
    string)."""
    mapping = getattr(layer_or_mapping, "MAPPING", layer_or_mapping)
    return GDUnitRegistry.get_factory(mapping)


class ForwardBase(TracedUnit, metaclass=ForwardUnitRegistry):
    """A forward layer unit."""

    hide_from_registry = True

    #: Whether this layer type owns trainable parameters — static, so
    #: workflow builders can pair GD units before weights exist.
    HAS_PARAMS = True

    def __init__(self, workflow, **kwargs):
        super(ForwardBase, self).__init__(workflow, **kwargs)
        self.view_group = "WORKER"
        self.input = None            # linked Vector
        self.output = Vector()
        self.weights = Vector()
        self.bias = Vector()
        self.include_bias = kwargs.get("include_bias", True)
        self.weights_stddev = kwargs.get("weights_stddev")
        self.bias_stddev = kwargs.get("bias_stddev")
        self.prng_key = kwargs.get("prng_key", 0)
        self.demand("input")

    @property
    def trainables(self):
        t = {}
        if self.weights:
            t["weights"] = self.weights
        if self.include_bias and self.bias:
            t["bias"] = self.bias
        return t

    @property
    def compute_dtype(self):
        """Activation-stream dtype (see
        ``accelerated_units.step_compute_dtype``)."""
        from ..accelerated_units import step_compute_dtype
        return step_compute_dtype()

    def rand(self):
        return prng.get(self.prng_key)

    # -- the distributed contract ----------------------------------------
    #
    # Two wire dialects, negotiated per worker in the handshake:
    #
    # * legacy (pickle-compat): full trainables both ways; the master
    #   keeps a FIFO of the copies it shipped each worker and folds an
    #   update against the matching one (:func:`fold_update`);
    # * delta: full weights ship at join and rebase only; later jobs
    #   carry the change since that worker's last sync as a BITWISE XOR
    #   (exact).  The worker returns its change in the negotiated
    #   ``--net-dtype``: at fp32 as an XOR against the base it trained
    #   from (exact — the master reconstructs the worker's values and
    #   folds them by :func:`fold_update`, as the legacy dialect does),
    #   at bf16 or int8 as an encoded arithmetic delta the master adds
    #   (int8 with an error-feedback residual).  The JAX package ships
    #   the fp32 rung as ``theirs − base`` and adds it, which rounds
    #   where :func:`fold_update` does not.
    # ----------------------------------------------------------------------

    def init_unpickled(self):
        super(ForwardBase, self).init_unpickled()
        self._shipped_ = {}          # legacy: slave -> FIFO of copies
        self._synced_ = {}           # delta: slave -> (version, arrays)
        self._bases_ = {}            # delta: slave -> {version: arrays}
        self._base_ = None           # worker: last synced arrays
        self._base_version_ = None
        # Worker, int8 wire: the f32 quantization error of the last
        # shipped delta, added into the next one before quantizing.
        self._residual_ = {}

    def _trainable_arrays(self):
        out = {}
        for attr, vec in self.trainables.items():
            vec.map_read()
            out[attr] = numpy.array(vec.mem)
        return out

    def _slave_proto(self, slave):
        return _proto_of_slave(self, slave)

    def _net_proto(self):
        return _proto_of_net(self)

    _as_bits = staticmethod(_as_bits)

    def generate_data_for_slave(self, slave=None):
        """Ships the trainables, or their change since this worker's
        last sync (see the dialects above)."""
        if not self.trainables:
            return None
        arrays = self._trainable_arrays()
        if not self._slave_proto(slave).get("delta"):
            # Legacy: full copy + FIFO (a pipelined worker holds
            # several jobs in flight; replies come in serve order).
            self._shipped_.setdefault(slave, []).append(arrays)
            return arrays
        version = getattr(self.workflow, "weights_version", 0)
        prev = self._synced_.get(slave)
        self._synced_[slave] = (version, arrays)
        self._bases_.setdefault(slave, {})[version] = arrays
        if prev is None:
            return {"F": arrays, "v": version}
        base_version, base = prev
        delta = {}
        for attr, arr in arrays.items():
            b = base.get(attr)
            if b is None or b.shape != arr.shape or \
                    b.dtype != arr.dtype:
                # Reshaped trainables: rebase with a full ship.
                return {"F": arrays, "v": version}
            bits = numpy.bitwise_xor(_as_bits(arr), _as_bits(b))
            # Unchanged tensors collapse to a None marker.
            delta[attr] = bits if bits.any() else None
        return {"D": delta, "v": version, "bv": base_version}

    def apply_data_from_master(self, data):
        if not data:
            return
        from ..resilience import ProtocolError
        if "F" in data:
            self._base_ = {}
            # A full rebase starts a fresh delta session: an owed
            # quantization error belonged to the old base.
            self._residual_ = {}
            for attr, arr in data["F"].items():
                vec = self.trainables.get(attr)
                if vec is not None:
                    vec.mem = arr
                    # An own copy: the base must survive however the
                    # wire buffer or vec.mem is reused.
                    self._base_[attr] = numpy.array(arr)
            self._base_version_ = data.get("v")
            return
        if "D" in data:
            if self._base_ is None:
                raise ProtocolError(
                    "weights delta received before any full sync — "
                    "the session is desynchronized; reconnecting "
                    "will trigger a full rebase")
            if data.get("bv") != self._base_version_:
                raise ProtocolError(
                    "weights delta based on version %s but this "
                    "worker is synced to %s — reconnecting will "
                    "trigger a full rebase" %
                    (data.get("bv"), self._base_version_))
            for attr, bits in data["D"].items():
                vec = self.trainables.get(attr)
                base = self._base_.get(attr)
                if vec is None or base is None:
                    raise ProtocolError(
                        "weights delta names unknown trainable %r"
                        % attr)
                if bits is None:  # unchanged since the last sync
                    vec.mem = numpy.array(base)
                    continue
                new = _xor(base, bits)
                self._base_[attr] = new
                vec.mem = numpy.array(new)
            self._base_version_ = data.get("v")
            return
        # Legacy master: a plain attr → array dict, full overwrite.
        for attr, arr in data.items():
            vec = self.trainables.get(attr)
            if vec is not None:
                vec.mem = arr

    def generate_data_for_master(self):
        if not self.trainables:
            return None
        arrays = self._trainable_arrays()
        proto = self._net_proto()
        if not proto.get("delta") or self._base_ is None:
            return arrays
        import zlib
        from ..network_common import encode_delta, decode_delta
        dtype = proto.get("dtype") or "fp32"
        feedback = dtype == "int8"
        delta = {}
        for attr, arr in arrays.items():
            b = self._base_.get(attr)
            if b is None or b.shape != arr.shape or b.dtype != arr.dtype:
                return arrays  # desynced trainable set: full rebase
            if dtype == "fp32":
                bits = numpy.bitwise_xor(_as_bits(arr), _as_bits(b))
                delta[attr] = {"x": bits} if bits.any() else None
                continue
            d = arr - b
            if not d.any():
                # Untouched trainables (every validation job) collapse
                # to None; an owed residual waits for the next update.
                delta[attr] = None
                continue
            if feedback and d.dtype == numpy.float32:
                r = self._residual_.get(attr)
                if r is not None and r.shape == d.shape:
                    d = d + r
            # A deterministic stochastic-rounding seed: the same
            # (tensor, base version) quantizes alike on every replay.
            seed = zlib.crc32(attr.encode("utf-8")) ^ \
                ((self._base_version_ or 0) & 0xFFFFFFFF)
            payload = encode_delta(d, dtype, seed=seed)
            if payload is None:
                # A codec refusal (a non-f32 tensor, a non-finite
                # int8 input): the exact delta ships, nothing is owed.
                if feedback:
                    self._residual_.pop(attr, None)
                delta[attr] = d
                continue
            if feedback:
                self._residual_[attr] = d - decode_delta(payload)
            delta[attr] = payload
        return {"U": delta, "bv": self._base_version_}

    def apply_data_from_slave(self, data, slave=None):
        """Folds a worker's update into the current values: an fp32
        update by :func:`fold_update` against the base it was trained
        from, a bf16/int8 one by adding its decoded delta."""
        if not data:
            return
        if "U" in data:
            from ..network_common import decode_delta
            from ..resilience import ProtocolError
            bv = data.get("bv")
            bases = self._bases_.get(slave, {})
            for attr, d in data["U"].items():
                vec = self.trainables.get(attr)
                if vec is None or d is None:  # None = unchanged
                    continue
                vec.map_read()  # the device copy (if any) is not newer
                if isinstance(d, dict) and "x" in d:
                    base = bases.get(bv, {}).get(attr)
                    if base is None:
                        raise ProtocolError(
                            "update of %s/%s is based on version %s, "
                            "which was never shipped to %s" %
                            (self.name, attr, bv, slave))
                    vec.mem = fold_update(vec.mem, _xor(base, d["x"]),
                                          base)
                    continue
                d = decode_delta(d)
                vec.mem = vec.mem + d.reshape(vec.mem.shape)
            for version in [v for v in bases if v < bv]:
                del bases[version]
            return
        bases = self._shipped_.get(slave)
        base = bases.pop(0) if bases else None
        if bases is not None and not bases:
            self._shipped_.pop(slave, None)
        for attr, arr in data.items():
            vec = self.trainables.get(attr)
            if vec is None:
                continue
            if base is not None and attr in base:
                vec.map_read()  # the device copy (if any) is not newer
                vec.mem = fold_update(vec.mem, arr, base[attr])
            else:
                vec.mem = arr

    def drop_slave(self, slave=None):
        self._shipped_.pop(slave, None)
        self._synced_.pop(slave, None)
        self._bases_.pop(slave, None)

    # -- population member contexts ------------------------------------------

    def export_sync_state(self):
        """Worker side: this unit's delta-session base (arrays, version,
        residual) as an opaque snapshot, swapped per member so lineages
        interleaved on one worker never cross-apply a delta."""
        return (self._base_, self._base_version_, dict(self._residual_))

    def import_sync_state(self, state):
        """Worker side: installs a member's delta-session base (None =
        a fresh member, which forces a full-ship sync)."""
        state = state or (None, None, {})
        if len(state) == 2:
            state = state + ({},)
        self._base_, self._base_version_, residual = state
        self._residual_ = dict(residual or {})

    def adopt_synced_from(self, src, slave):
        """Master side, exploit as a delta: seeds this lineage unit's
        synced base for ``slave`` with the leader unit's, so the next
        job to that worker ships an XOR delta against a base it already
        holds instead of full weights.  False when the leader has no
        synced base there, None when this unit has nothing to sync."""
        if not self.trainables:
            return None
        prev = src._synced_.get(slave)
        if prev is None:
            return False
        version, arrays = prev
        self._synced_[slave] = (version, dict(arrays))
        self._bases_.setdefault(slave, {})[version] = dict(arrays)
        return True

    def adopt_shipped_values(self, src, slave):
        """Master side: overwrites this lineage unit's trainables with
        the values the leader unit last shipped to ``slave``.  False
        when the leader has no synced base there, None when not
        applicable."""
        if not self.trainables:
            return None
        prev = src._synced_.get(slave)
        if prev is None:
            return False
        _version, arrays = prev
        for attr, vec in self.trainables.items():
            arr = arrays.get(attr)
            if arr is None or arr.shape != vec.shape:
                return False
            vec.map_write()
            vec.mem = numpy.array(arr)
        return True


class GradientDescentBase(TracedUnit, metaclass=GDUnitRegistry):
    """Per-layer trainer: hyperparameters and optimizer slots for its
    ``target`` forward unit; ``tupdate`` runs inside the step with the
    autograd gradient and delegates to the registered optimizer."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(GradientDescentBase, self).__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.target = kwargs.get("target")
        #: Update rule (optimizers registry).  An explicit kwarg pins
        #: it against the ``root.common.engine.optimizer`` override.
        self.optimizer = kwargs.get("optimizer") or config_get(
            root.common.engine.optimizer, "sgd")
        self._optimizer_explicit = "optimizer" in kwargs
        optimizers.get(self.optimizer)  # validate early
        #: Adam/Lion coefficients + epsilon; None = the optimizer's
        #: own default.
        self.beta1 = kwargs.get("beta1")
        self.beta2 = kwargs.get("beta2")
        self.eps = kwargs.get("eps")
        self.learning_rate = kwargs.get("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.get(
            "learning_rate_bias", self.learning_rate)
        # L2 weight decay.
        self.weights_decay = kwargs.get("weights_decay", 0.0)
        self.weights_decay_bias = kwargs.get("weights_decay_bias", 0.0)
        # Momentum.
        self.gradient_moment = kwargs.get("gradient_moment", 0.0)
        self.gradient_moment_bias = kwargs.get(
            "gradient_moment_bias", self.gradient_moment)
        #: Whether a bias hyper was left to follow its plain value at
        #: construction: only then does a tensor override of the plain
        #: hyper (the population step) reach the bias too.
        self._bias_tied = {
            "learning_rate": "learning_rate_bias" not in kwargs,
            "gradient_moment": "gradient_moment_bias" not in kwargs,
        }
        self._velocities = {}

    def init_unpickled(self):
        super(GradientDescentBase, self).init_unpickled()
        # The slot-shard wire sync (``--net-zero``), per session:
        # master: slave -> (version, shard arrays); worker: the last
        # synced shard arrays and their version.
        self._slot_synced_ = {}
        self._slot_base_ = None
        self._slot_base_version_ = None

    @property
    def tstate(self):
        return dict(self._velocities)

    @property
    def optimizer_obj(self):
        return optimizers.get(self.optimizer)

    def initialize(self, device=None, **kwargs):
        super(GradientDescentBase, self).initialize(
            device=device, **kwargs)
        if self.target is None:
            raise ValueError("%s has no target forward unit" % self)
        if not self.target.is_initialized:
            # Requeued by Workflow.initialize until the target's
            # weights exist.
            raise AttributeError(
                "%s: target %s not initialized yet" %
                (self.name, self.target.name))
        override = config_get(root.common.engine.optimizer, None)
        if override and not self._optimizer_explicit:
            optimizers.get(override)
            self.optimizer = override
        opt = self.optimizer_obj
        stale = sorted(
            s for s in self._velocities
            if not any(s.startswith(p) for p in opt.SLOT_PREFIXES))
        if stale:
            raise optimizers.SlotMismatchError(
                "%s holds optimizer slots %s that do not belong to "
                "optimizer %r (its slot prefixes: %s)"
                % (self.name, stale, self.optimizer,
                   ", ".join(opt.SLOT_PREFIXES) or "none"))
        for v in self._velocities.values():
            # Slots a snapshot carried come back as host arrays.
            v.initialize(self.device)
        for attr, vec in self.target.trainables.items():
            for slot, shape, dtype in opt.slots(attr, vec, self):
                if slot not in self._velocities:
                    v = Vector(numpy.zeros(shape, dtype=dtype))
                    v.initialize(self.device)
                    self._velocities[slot] = v

    def _bias_ties(self):
        """The construction-time ties of the bias hypers; a snapshot
        from before they were recorded ties by value equality."""
        ties = getattr(self, "_bias_tied", None)
        if ties is None:
            ties = {"learning_rate":
                    self.learning_rate_bias == self.learning_rate,
                    "gradient_moment":
                    self.gradient_moment_bias == self.gradient_moment}
        return ties

    def _hyper(self, attr, hypers=None):
        """(learning rate, weight decay, momentum) of ``attr``: the
        bias trio for "bias", the main trio otherwise.  ``hypers``
        (``{name: 0-dim tensor}``, the population step) overrides them:
        ``name + "_bias"`` the bias trio, and a plain name the bias
        trio too where the bias value is tied to the plain one
        (``weights_decay_bias`` never is)."""
        if attr == "bias":
            own = (self.learning_rate_bias, self.weights_decay_bias,
                   self.gradient_moment_bias)
            suffix = "_bias"
        else:
            own = (self.learning_rate, self.weights_decay,
                   self.gradient_moment)
            suffix = ""
        if not hypers:
            return own
        out = []
        for name, own_v in zip(("learning_rate", "weights_decay",
                                "gradient_moment"), own):
            if suffix:
                tied = self._bias_ties().get(name, False)
                fallback = hypers.get(name, own_v) if tied else own_v
                out.append(hypers.get(name + suffix, fallback))
            else:
                out.append(hypers.get(name, own_v))
        return tuple(out)

    def _hyper_dict(self, attr, hypers=None):
        """The hyperparameter dict handed to the optimizer's rule, each
        entry overridable by a tensor of ``hypers``."""
        lr, decay, moment = self._hyper(attr, hypers)
        out = {"learning_rate": lr, "weights_decay": decay,
               "gradient_moment": moment}
        defaults = self.optimizer_obj.HYPER_DEFAULTS
        for name in ("beta1", "beta2", "eps"):
            if hypers and name in hypers:
                out[name] = hypers[name]
                continue
            own = getattr(self, name, None)
            out[name] = defaults.get(name) if own is None else own
        return out

    def tupdate(self, attr, param, grad, state, ctx, hypers=None):
        """Applies this unit's optimizer rule to one parameter;
        ``hypers`` overrides the Python-float hyperparameters with
        tensors (the population step, where they differ per member)."""
        return self.optimizer_obj.update(
            attr, param, grad, state, self._hyper_dict(attr, hypers),
            traced=bool(hypers))

    # -- ZeRO over the wire (``--net-zero K``) -----------------------------
    #
    # The optimizer slots join the delta data plane sharded K ways: a
    # worker of shard rank r owns the flat slice [r·n/K, (r+1)·n/K) of
    # every slot tensor and syncs only that.  Master → worker: the
    # shard, full at join or rebase, an XOR delta after.  Worker →
    # master: an XOR delta of the shard against its synced base (exact:
    # the master's optimizer state is the trainer's bit for bit).
    # Without the negotiated key nothing ships, and the slots stay
    # worker-local.

    def _zero_shard(self, proto):
        """(rank, K) of a negotiated slot-sync session, else None."""
        dp = int(proto.get("zero") or 0)
        if dp <= 0 or not proto.get("delta"):
            return None
        return int(proto.get("zero_rank") or 0), dp

    @staticmethod
    def _shard_bounds(vec, rank, dp):
        """The flat [lo, hi) slice of ``vec`` that ``rank`` owns (the
        last rank absorbs the remainder)."""
        n = vec.size
        return rank * n // dp, (rank + 1) * n // dp

    def _slot_shard_arrays(self, rank, dp):
        out = {}
        for slot, vec in self.tstate.items():
            lo, hi = self._shard_bounds(vec, rank, dp)
            if hi <= lo:
                continue
            vec.map_read()
            out[slot] = numpy.array(vec.mem.reshape(-1)[lo:hi])
        return out

    def _check_shard(self, slot, size, rank, dp):
        """Raises ProtocolError unless ``slot`` exists here and ``rank``
        owns exactly ``size`` of its elements — checked for every shard
        of a message before any of them changes local state."""
        from ..resilience import ProtocolError
        vec = self.tstate.get(slot)
        if vec is None:
            raise ProtocolError(
                "slot sync names unknown optimizer slot %r on %s"
                % (slot, self.name))
        lo, hi = self._shard_bounds(vec, rank, dp)
        if hi - lo != size:
            raise ProtocolError(
                "slot shard for %s/%s is %d elements but rank %d/%d "
                "owns %d — shard geometry desync" %
                (self.name, slot, size, rank, dp, hi - lo))

    def _store_shard(self, slot, arr, rank, dp):
        vec = self.tstate[slot]
        lo, hi = self._shard_bounds(vec, rank, dp)
        vec.map_write()
        vec.mem.reshape(-1)[lo:hi] = arr

    def generate_data_for_slave(self, slave=None):
        """Master side: this worker's slot shard — full at join or
        rebase, an XOR delta after (unchanged slots collapse to
        None)."""
        shard = self._zero_shard(self._slave_proto(slave))
        if shard is None or not self.tstate:
            return None
        rank, dp = shard
        arrays = self._slot_shard_arrays(rank, dp)
        if not arrays:
            return None
        from .. import resilience
        version = getattr(self.workflow, "weights_version", 0)
        prev = self._slot_synced_.get(slave)
        self._slot_synced_[slave] = (version, arrays)
        full = sum(a.nbytes for a in arrays.values())
        if prev is None:
            resilience.stats.incr("net.slot_bytes", full)
            return {"F": arrays, "v": version}
        base_version, base = prev
        delta = {}
        sent = 0
        for slot, arr in arrays.items():
            b = base.get(slot)
            if b is None or b.shape != arr.shape or b.dtype != arr.dtype:
                resilience.stats.incr("net.slot_bytes", full)
                return {"F": arrays, "v": version}
            bits = numpy.bitwise_xor(_as_bits(arr), _as_bits(b))
            if bits.any():
                delta[slot] = bits
                sent += bits.nbytes
            else:
                delta[slot] = None
        resilience.stats.incr("net.slot_bytes", sent)
        return {"D": delta, "v": version, "bv": base_version}

    def apply_data_from_master(self, data):
        """Worker side: lands the master's slot shard in the local slot
        Vectors (the rest of each tensor stays this worker's own)."""
        if not data:
            return
        from ..resilience import ProtocolError
        shard = self._zero_shard(self._net_proto())
        if shard is None:
            return
        rank, dp = shard
        if "F" in data:
            for slot, arr in data["F"].items():
                self._check_shard(slot, arr.size, rank, dp)
            base = {}
            for slot, arr in data["F"].items():
                self._store_shard(slot, arr, rank, dp)
                base[slot] = numpy.array(arr)
            self._slot_base_ = base
            self._slot_base_version_ = data.get("v")
            return
        if "D" not in data:
            return
        if self._slot_base_ is None:
            raise ProtocolError(
                "slot-shard delta received before any full sync — "
                "the session is desynchronized; reconnecting will "
                "trigger a full rebase")
        if data.get("bv") != self._slot_base_version_:
            raise ProtocolError(
                "slot-shard delta based on version %s but this "
                "worker is synced to %s — reconnecting will trigger "
                "a full rebase" % (data.get("bv"),
                                   self._slot_base_version_))
        updates = {}  # validate, then commit
        for slot, bits in data["D"].items():
            base = self._slot_base_.get(slot)
            if base is None:
                raise ProtocolError(
                    "slot-shard delta names unsynced slot %r" % slot)
            if bits is None:
                updates[slot] = (base, False)
                continue
            self._check_shard(slot, base.size, rank, dp)
            if bits.size != base.size:
                raise ProtocolError(
                    "slot-shard delta for %r is %d elements against "
                    "a %d-element base — shard geometry desync"
                    % (slot, bits.size, base.size))
            updates[slot] = (_xor(base, bits), True)
        for slot, (new, changed) in updates.items():
            if changed:
                self._slot_base_[slot] = new
            self._store_shard(slot, numpy.array(new), rank, dp)
        self._slot_base_version_ = data.get("v")

    def generate_data_for_master(self):
        """Worker side: XOR deltas of this worker's slot shard against
        its synced base; the base advances to what ships."""
        shard = self._zero_shard(self._net_proto())
        if shard is None or self._slot_base_ is None or \
                not self.tstate:
            return None
        rank, dp = shard
        arrays = self._slot_shard_arrays(rank, dp)
        from .. import resilience
        delta = {}
        sent = 0
        for slot, arr in arrays.items():
            b = self._slot_base_.get(slot)
            if b is None or b.shape != arr.shape or b.dtype != arr.dtype:
                resilience.stats.incr(
                    "net.slot_bytes",
                    sum(a.nbytes for a in arrays.values()))
                self._slot_base_ = {s: numpy.array(a)
                                    for s, a in arrays.items()}
                return {"S": arrays}
            bits = numpy.bitwise_xor(_as_bits(arr), _as_bits(b))
            if bits.any():
                delta[slot] = bits
                sent += bits.nbytes
                self._slot_base_[slot] = arr
            else:
                delta[slot] = None
        resilience.stats.incr("net.slot_bytes", sent)
        return {"X": delta}

    def apply_data_from_slave(self, data, slave=None):
        """Master side: the owner's shard values from its XOR delta
        against what this master last synced to it (last writer wins
        between owners of one shard).  A worker's bad slot piece is
        dropped with a warning — never raised: a master-side exception
        stops the coordinator."""
        if not data:
            return
        shard = self._zero_shard(self._slave_proto(slave))
        if shard is None:
            return
        rank, dp = shard
        prev = self._slot_synced_.get(slave)
        synced = prev[1] if prev else {}
        if prev is None:
            self._slot_synced_[slave] = (None, synced)
        from .. import resilience
        if "S" in data:  # a full shard rebase from the worker
            for slot, arr in data["S"].items():
                try:
                    self._check_shard(slot, arr.size, rank, dp)
                except Exception as e:
                    resilience.stats.incr("net.slot_dropped")
                    self.warning("dropping slot rebase from %s: %s",
                                 slave, e)
                    continue
                self._store_shard(slot, arr, rank, dp)
                synced[slot] = numpy.array(arr)
            return
        if "X" not in data:
            return
        for slot, bits in data["X"].items():
            if bits is None:
                continue
            base = synced.get(slot)
            if base is None or base.size != bits.size:
                resilience.stats.incr("net.slot_dropped")
                self.warning(
                    "slot-shard XOR delta for %s/%s has no matching "
                    "synced base — dropped (worker %s will rebase on "
                    "its next full sync)", self.name, slot, slave)
                continue
            new = _xor(base, bits)
            try:
                self._check_shard(slot, new.size, rank, dp)
            except Exception as e:
                resilience.stats.incr("net.slot_dropped")
                self.warning("dropping slot delta from %s: %s",
                             slave, e)
                continue
            self._store_shard(slot, new, rank, dp)
            synced[slot] = new

    def drop_slave(self, slave=None):
        self._slot_synced_.pop(slave, None)

    # -- population member contexts ------------------------------------------

    def export_sync_state(self):
        return (self._slot_base_, self._slot_base_version_)

    def import_sync_state(self, state):
        self._slot_base_, self._slot_base_version_ = \
            tuple(state)[:2] if state else (None, None)

    def adopt_synced_from(self, src, slave):
        """Master side: exploit as a delta for the slot shards (see
        ``ForwardBase.adopt_synced_from``)."""
        if not self.tstate:
            return None
        prev = src._slot_synced_.get(slave)
        if prev is None:
            return False
        version, arrays = prev
        self._slot_synced_[slave] = (version, dict(arrays))
        return True

    def adopt_shipped_values(self, src, slave, rank=0, dp=1):
        """Master side: overwrites this unit's slot shard with the
        values the leader last synced to ``slave``."""
        if not self.tstate:
            return None
        prev = src._slot_synced_.get(slave)
        if prev is None:
            return False
        _version, arrays = prev
        for slot, arr in arrays.items():
            vec = self.tstate.get(slot)
            if vec is None:
                return False
            lo, hi = self._shard_bounds(vec, rank, dp)
            if hi - lo != arr.size:
                return False
            self._store_shard(slot, arr, rank, dp)
        return True

    def _slave_proto(self, slave):
        return _proto_of_slave(self, slave)

    def _net_proto(self):
        return _proto_of_net(self)
