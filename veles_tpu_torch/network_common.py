"""The data plane's wire: address parsing, machine identity and
length-prefixed framing over plain TCP sockets (the JAX package's
``network_common``).

Besides the legacy framed-pickle format there is a **tensor-framed**
format, negotiated in the handshake: ndarrays leave the pickle and ride
as raw buffer frames (a memoryview send, no intermediate pickle copy of
the array bytes; a bounded receive into one reusable buffer), with a
per-tensor payload codec (``none``/``gzip``, level and size threshold
from ``--net-codec``) and the lossy delta encodings of ``--net-dtype``
(bf16, int8).  Frames are HMAC-authenticated under a per-connection
nonce and a monotonic sequence number before anything is unpickled.
A channel's serialization and send are the ``net.serialize`` and
``net.send`` spans of the trace (:mod:`.observability.tracing`).

The codecs act on numpy arrays on the host: they are host code, and a
payload is byte-equal to the JAX package's for the same input.
"""

import collections
import gzip
import hashlib
import hmac as hmac_mod
import pickle
import socket
import struct
import threading
import time
import uuid
import zlib

from .observability import tracing as _tracing

_HEADER = struct.Struct(">QB")  # payload length, flags
_FLAG_GZIP = 1
#: Tensor-framed body (see :func:`encode_tensor_parts`).  Never sent
#: unless the peer negotiated the capability in its handshake.
_FLAG_TENSOR = 2
_DIGEST_SIZE = hashlib.sha256().digest_size

#: Payloads above this size are compressed (control messages are tiny;
#: index arrays for big blocks may not be).
COMPRESS_THRESHOLD = 1 << 16

#: Default gzip level for wire compression (overridable per channel
#: through :class:`WireCodec` / ``--net-codec``).
COMPRESS_LEVEL = 1

#: Frame-size bounds.  The 8-byte length header is network-supplied:
#: without a cap a corrupt/hostile header drives ``_recv_exact`` into
#: an unbounded allocation loop, and a tiny gzip frame can expand into
#: gigabytes (decompression bomb).  Oversize either way is treated as
#: a dead peer.  Control traffic is small; raise these only for
#: genuinely huge index blocks.
MAX_FRAME_SIZE = 1 << 30
MAX_MESSAGE_SIZE = 1 << 30


def parse_address(address, default_port=5050):
    """"host:port" | "host" | ":port" → (host, port)."""
    if isinstance(address, (tuple, list)):
        return address[0], int(address[1])
    host, sep, port = str(address).rpartition(":")
    if not sep:
        return address or "0.0.0.0", default_port
    return host or "0.0.0.0", int(port)


def machine_id():
    """A stable machine identity (from the host's MAC address)."""
    return "%012x" % uuid.getnode()


def normalize_secret(secret):
    """Caller convenience: str → bytes; None and EMPTY both mean "no
    auth" (an empty key would MAC frames yet skip the truthiness-gated
    sequence binding — half-authenticated is worse than unauthenticated
    because it looks secure)."""
    if secret is None:
        return None
    if isinstance(secret, str):
        secret = secret.encode("utf-8")
    return bytes(secret) or None


def _mac_parts(secret, flags, parts, nonce, seq):
    """HMAC over a multi-part body without concatenating it (the
    parts may be params-sized memoryviews).  The authenticated bytes:
    per-connection nonce + monotonic sequence + flags + body — the
    nonce kills cross-session replay, the sequence kills in-session
    replay/reorder."""
    h = hmac_mod.new(secret, digestmod=hashlib.sha256)
    h.update(nonce)
    if seq is not None:
        h.update(struct.pack(">Q", seq))
    h.update(bytes([flags]))
    for p in parts:
        h.update(p)
    return h.digest()


class WireCodec(object):
    """Per-channel payload codec: ``name`` ("none"/"gzip"), gzip
    ``level``, and the size ``threshold`` below which a payload ships
    uncompressed (compressing tiny control frames wastes CPU for
    negative savings)."""

    def __init__(self, name="gzip", level=None, threshold=None):
        self.name = name or "none"
        self.level = COMPRESS_LEVEL if level is None else int(level)
        self.threshold = COMPRESS_THRESHOLD if threshold is None \
            else int(threshold)

    @classmethod
    def from_config(cls):
        """Codec from ``root.common.net`` (the --net-codec flag)."""
        from .config import root, get as config_get
        return cls(config_get(root.common.net.codec, "gzip"),
                   config_get(root.common.net.codec_level, None),
                   config_get(root.common.net.codec_threshold, None))

    def pack(self, payload):
        """Returns (compressed_bool, bytes-like)."""
        if self.name == "gzip" and len(payload) >= self.threshold:
            packed = gzip.compress(payload,
                                   compresslevel=self.level)
            if len(packed) < len(payload):
                return True, packed
        return False, payload

    def __repr__(self):
        return "WireCodec(%r, level=%d, threshold=%d)" % (
            self.name, self.level, self.threshold)


# -- bf16 wire encoding ----------------------------------------------------

def encode_bf16(arr):
    """float32 → bfloat16 wire halves (uint16) with round-to-nearest-
    even, numpy-only (no ml_dtypes dependency).  Used for the optional
    lossy delta encoding (``--net-dtype bf16``)."""
    import numpy
    bits = numpy.ascontiguousarray(arr, dtype=numpy.float32).view(
        numpy.uint32)
    # RNE: add 0x7FFF + lsb-of-result before truncating.
    rounded = bits + 0x7FFF + ((bits >> 16) & 1)
    # NaNs must stay NaN: truncation of a NaN mantissa can land on an
    # all-zero mantissa (= infinity); force a quiet-NaN pattern.
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    out = (rounded >> 16).astype(numpy.uint16)
    out[nan] = ((bits[nan] >> 16) | 0x0040).astype(numpy.uint16)
    return out


def decode_bf16(halves, shape=None):
    """bfloat16 wire halves → float32 (exact expansion)."""
    import numpy
    bits = halves.astype(numpy.uint32) << 16
    out = bits.view(numpy.float32)
    return out.reshape(shape) if shape is not None else out


# -- int8 wire encoding -----------------------------------------------------

def encode_int8(arr, seed=0):
    """float32 → int8 delta payload ``{"i8": codes, "sc": scale}``
    with ONE per-tensor symmetric scale (amax/127) and STOCHASTIC
    rounding — a quarter of the f32 bytes.  Stochastic rounding keeps
    the quantizer unbiased (E[decode] == value) and the caller
    carries the residual (error feedback: the quantization error of
    this delta rides into the next one), which together keep the
    xor-delta training plane converging.  Deterministic per ``seed``
    — the loopback convergence gates replay identical sessions.
    Returns None for non-finite input (int8 cannot represent NaN/inf;
    the caller ships exact f32 and lets the guardian own NaN policy)
    — and for empty arrays, where there is nothing to quantize."""
    import numpy
    a = numpy.ascontiguousarray(arr, dtype=numpy.float32)
    if a.size == 0:
        return None
    amax = float(numpy.max(numpy.abs(a)))
    if not numpy.isfinite(amax):
        return None
    if amax == 0.0:
        return {"i8": numpy.zeros(a.shape, numpy.int8), "sc": 0.0}
    scale = amax / 127.0
    x = a / scale
    rng = numpy.random.RandomState(int(seed) & 0x7FFFFFFF)
    lo = numpy.floor(x)
    q = lo + (rng.random_sample(x.shape) < (x - lo))
    q = numpy.clip(q, -127, 127).astype(numpy.int8)
    return {"i8": q, "sc": scale}


def decode_int8(payload):
    """int8 delta payload → float32 (``codes · scale``)."""
    import numpy
    return payload["i8"].astype(numpy.float32) * \
        numpy.float32(payload["sc"])


# -- the delta-dtype codec ladder -------------------------------------------

#: Table-driven wire-dtype registry for worker→master weight deltas:
#: name → (encode(arr, seed) → payload dict or None-for-exact-f32,
#: decode(payload) → f32 array, the payload's sniff key, one help
#: line).  A new rung slots in HERE — the parser choices/help, the
#: handshake negotiation, and the decode sniff all derive from this
#: table, never another if-chain.
DELTA_DTYPES = collections.OrderedDict((
    ("fp32", {
        "encode": None, "decode": None, "key": None,
        "help": "exact f32 (default; bit-reproducible)"}),
    ("bf16", {
        "encode": lambda a, seed=0: {"b16": encode_bf16(a)},
        "decode": lambda d: decode_bf16(d["b16"]),
        "key": "b16",
        "help": "half the bytes; LOSSY (breaks bit-reproducibility "
                "of distributed runs)"}),
    ("int8", {
        "encode": encode_int8,
        "decode": decode_int8,
        "key": "i8",
        "help": "a quarter of the bytes; LOSSY — stochastic-rounded "
                "int8 with a per-worker error-feedback residual "
                "carrying the quantization error into the next "
                "delta"}),
))


def encode_delta(arr, dtype, seed=0):
    """Encodes one f32 delta for the wire at ``dtype`` (a
    :data:`DELTA_DTYPES` name).  Returns the payload dict, or None
    when the delta should ship as exact f32 (the fp32 rung, a
    non-f32 array, or a codec refusal like non-finite int8 input)."""
    import numpy
    codec = DELTA_DTYPES[dtype]
    if codec["encode"] is None:
        return None
    a = numpy.asarray(arr)
    if a.dtype != numpy.float32:
        return None  # only f32 tensors ride the lossy rungs
    return codec["encode"](a, seed=seed)


def decode_delta(d):
    """The master-side inverse: payload dicts are sniffed by their
    registry key; plain arrays (exact f32) pass through — so every
    negotiated dtype decodes through ONE call site."""
    if isinstance(d, dict):
        for codec in DELTA_DTYPES.values():
            key = codec["key"]
            if key is not None and key in d:
                return codec["decode"](d)
        from .resilience import ProtocolError
        raise ProtocolError(
            "unrecognized delta payload keys %s — known codecs: %s" %
            (sorted(d), ", ".join(n for n in DELTA_DTYPES)))
    return d


# -- tensor framing --------------------------------------------------------

#: Arrays below this size stay inside the pickle skeleton — framing a
#: 12-byte array costs more header than it saves.
_TENSOR_MIN_BYTES = 256


class _TensorRef(object):
    """Pickle-skeleton placeholder for an extracted ndarray."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __reduce__(self):
        return (_TensorRef, (self.i,))


def _extract_tensors(obj, tensors):
    """Recursively replaces large ndarrays in dict/list/tuple trees
    with :class:`_TensorRef` markers, appending the arrays (made
    C-contiguous) to ``tensors``.  Returns the skeleton."""
    import numpy
    if isinstance(obj, numpy.ndarray) and obj.dtype != object and \
            obj.nbytes >= _TENSOR_MIN_BYTES:
        arr = numpy.ascontiguousarray(obj)
        tensors.append(arr)
        return _TensorRef(len(tensors) - 1)
    if isinstance(obj, dict):
        return {k: _extract_tensors(v, tensors)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_extract_tensors(v, tensors) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


def _restore_tensors(obj, tensors):
    if isinstance(obj, _TensorRef):
        return tensors[obj.i]
    if isinstance(obj, dict):
        return {k: _restore_tensors(v, tensors)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore_tensors(v, tensors) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_restore_tensors(v, tensors) for v in obj)
    return obj


def encode_tensor_parts(obj, codec=None):
    """Builds the tensor-framed body for ``obj``: a list of bytes-like
    parts ``[u32 header_len + header, blob, blob, ...]``.

    The header pickles ``(skeleton, [(dtype, shape, nbytes,
    compressed), ...])``; each blob is the raw (or per-tensor
    gzipped) array buffer.  Raw blobs are ``memoryview``s over the
    arrays themselves — the array bytes are never copied into an
    intermediate pickle (the zero-copy contract)."""
    parts, _ = _encode_tensor_parts_timed(obj, codec)
    return parts


def _encode_tensor_parts_timed(obj, codec):
    """(parts, compress_seconds) — the compress share is returned so
    :func:`encode_message` can report serialize time EXCLUSIVE of
    compression (net.serialize_us + net.compress_us must sum to
    reality, not double-count)."""
    codec = codec or _NO_CODEC
    tensors = []
    skeleton = _extract_tensors(obj, tensors)
    specs = []
    blobs = []
    t0 = time.perf_counter()
    for arr in tensors:
        view = memoryview(arr).cast("B")
        compressed, blob = codec.pack(view)
        specs.append((arr.dtype.str, arr.shape, len(blob),
                      compressed))
        blobs.append(blob)
    compress_s = time.perf_counter() - t0
    from . import resilience
    resilience.stats.incr("net.compress_us", int(compress_s * 1e6))
    header = pickle.dumps((skeleton, specs),
                          protocol=pickle.HIGHEST_PROTOCOL)
    # Cap the RAW (pre-compression) size: the receiver's per-tensor
    # decompression budget is MAX_MESSAGE_SIZE, so a frame that only
    # fits the wire compressed would read there as a dead peer — the
    # misleading-diagnostic failure the sender-side check exists to
    # prevent.
    _check_outgoing_size(
        4 + len(header) + sum(arr.nbytes for arr in tensors))
    return ([struct.pack(">I", len(header)) + header] + blobs,
            compress_s)


def decode_tensor_parts(payload, loads=None, max_message=None):
    """Parses a tensor-framed body (one contiguous buffer).  Returns
    the object, or None on any malformation/bound violation (the
    dead-peer contract of :func:`recv_message`).  Uncompressed
    tensors are ``frombuffer`` views into ``payload`` — pass a
    writable buffer (bytearray/memoryview) for writable arrays."""
    import numpy
    limit = max_message if max_message is not None else \
        MAX_MESSAGE_SIZE
    view = memoryview(payload)
    if len(view) < 4:
        return None
    (header_len,) = struct.unpack(">I", bytes(view[:4]))
    if header_len > len(view) - 4:
        return None
    try:
        skeleton, specs = (loads or pickle.loads)(
            bytes(view[4:4 + header_len]))
    except Exception:
        # Peer-supplied bytes: undecodable reads as a dead peer (the
        # caller drops + requeues) — but count it, or a skewed-build
        # worker flapping forever would be invisible to operators.
        from . import resilience
        resilience.stats.incr("net.decode_error")
        return None
    offset = 4 + header_len
    budget = limit
    tensors = []
    for dtype_str, shape, nbytes, compressed in specs:
        if nbytes < 0 or offset + nbytes > len(view):
            return None
        blob = view[offset:offset + nbytes]
        offset += nbytes
        try:
            dt = numpy.dtype(dtype_str)
            if compressed:
                raw = _bounded_gunzip(blob, budget)
                if raw is None:
                    return None
                budget -= len(raw)
                # bytes → writable buffer so downstream in-place
                # mutation keeps working (compressed tensors only;
                # raw ones alias the recv buffer).
                arr = numpy.frombuffer(bytearray(raw), dtype=dt)
            else:
                arr = numpy.frombuffer(blob, dtype=dt)
            tensors.append(arr.reshape(shape))
        except (ValueError, TypeError):
            return None
    try:
        return _restore_tensors(skeleton, tensors)
    except (IndexError, AttributeError):
        return None


def _check_outgoing_size(raw_bytes):
    """Bounds an outgoing message by its RAW serialized size against
    both receiver caps (minus MAC headroom).  Failing HERE, loudly,
    matters: an oversize frame at the receiver reads as a dead peer
    (its cap guards against hostile headers), and 'worker reconnects
    forever with a misleading handshake warning' is a far worse
    diagnostic than an exception naming the knob.  Raw, not
    compressed: the receiver's decompression budget is
    MAX_MESSAGE_SIZE, so a frame that only fits the wire compressed
    would still be dropped there."""
    cap = min(MAX_FRAME_SIZE, MAX_MESSAGE_SIZE) - 4096
    if raw_bytes > cap:
        raise ValueError(
            "outgoing message serializes to %d raw bytes, above the "
            "network_common.MAX_FRAME_SIZE/MAX_MESSAGE_SIZE caps "
            "(%d/%d); raise them on BOTH peers for genuinely huge "
            "messages" % (raw_bytes, MAX_FRAME_SIZE,
                          MAX_MESSAGE_SIZE))


_NO_CODEC = WireCodec("none")
#: Module-default codec for bare :func:`send_message` callers —
#: matches the historical hardcoded gzip-1/64KiB behavior.
_DEFAULT_CODEC = WireCodec("gzip")


def encode_message(obj, codec=None, tensor=False):
    """Serializes ``obj`` into ``(flags, parts)`` for
    :func:`send_parts` — the EXPENSIVE half of a send (pickling,
    tensor extraction, compression), deliberately separable from the
    cheap socket half so callers can serialize outside locks (the
    coordinator serializes jobs outside its workflow lock).

    ``tensor=True`` produces the tensor-framed format (negotiated
    capability); otherwise the legacy whole-pickle format with
    optional whole-payload gzip via ``codec``."""
    t0 = time.perf_counter()
    if tensor:
        parts, compress_s = _encode_tensor_parts_timed(obj, codec)
        flags = _FLAG_TENSOR
    else:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        # Raw-pickle bound (compression only shrinks the frame, so
        # passing here guarantees the peer's bounded gunzip accepts
        # it — see _check_outgoing_size).
        _check_outgoing_size(len(payload))
        flags = 0
        tc = time.perf_counter()
        compressed, payload = (codec or _DEFAULT_CODEC).pack(payload)
        if compressed:
            flags |= _FLAG_GZIP
        compress_s = time.perf_counter() - tc
        from . import resilience
        resilience.stats.incr("net.compress_us",
                              int(compress_s * 1e6))
        parts = [payload]
    from . import resilience
    # Exclusive of the compress share (already on net.compress_us) —
    # the comms timings must sum to reality, not double-count.
    resilience.stats.incr(
        "net.serialize_us",
        int((time.perf_counter() - t0 - compress_s) * 1e6))
    return flags, parts


def send_parts(sock, flags, parts, secret=None, nonce=b"", seq=None):
    """Sends one pre-encoded frame (the cheap half — MAC + syscalls).
    With ``secret``, an HMAC-SHA256 over nonce+seq+flags+body is
    prepended so the peer can authenticate the frame BEFORE
    unpickling (pickle from an unauthenticated peer is arbitrary code
    execution).

    Frames beyond :data:`MAX_FRAME_SIZE` fail HERE, loudly: the
    receiver would silently drop the peer (its cap guards against
    hostile headers), and 'worker reconnects forever with a
    misleading handshake warning' is a far worse diagnostic than an
    exception naming the knob."""
    total = sum(len(memoryview(p).cast("B")) for p in parts)
    # Backstop for hand-built parts; encode_message already bounded
    # the raw size (one formula, one error — see the helper).
    _check_outgoing_size(total)
    t0 = time.perf_counter()
    if secret is not None:
        mac = _mac_parts(secret, flags, parts, nonce, seq)
        sock.sendall(_HEADER.pack(total + _DIGEST_SIZE, flags) + mac)
        total += _DIGEST_SIZE
    else:
        sock.sendall(_HEADER.pack(total, flags))
    for p in parts:
        sock.sendall(p)
    from . import resilience
    resilience.stats.incr("net.bytes_sent", total + _HEADER.size)
    resilience.stats.incr("net.frames_sent")
    resilience.stats.incr(
        "net.send_us", int((time.perf_counter() - t0) * 1e6))


def send_message(sock, obj, secret=None, nonce=b"", seq=None,
                 codec=None, tensor=False):
    """Frames and sends one message (blocking) — convenience wrapper
    over :func:`encode_message` + :func:`send_parts`."""
    flags, parts = encode_message(obj, codec=codec, tensor=tensor)
    send_parts(sock, flags, parts, secret, nonce=nonce, seq=seq)


def recv_message(sock, secret=None, nonce=b"", seq=None, loads=None,
                 max_frame=None, max_message=None):
    """Receives one framed message; None on orderly close or (with
    ``secret``) on authentication failure — callers treat both as a
    dead peer and drop the connection.  ``seq`` is the sequence number
    the frame MUST carry (replayed or reordered frames fail the MAC).
    ``loads`` substitutes the deserializer — receivers of
    UNAUTHENTICATED streams (graphics viewers) pass a restricted
    unpickler so a hostile peer cannot smuggle arbitrary callables.
    ``max_frame``/``max_message`` cap the raw and decompressed sizes
    (default :data:`MAX_FRAME_SIZE`/:data:`MAX_MESSAGE_SIZE`);
    oversize frames also read as a dead peer — the cap is checked
    BEFORE any payload byte is read or buffered."""
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    length, flags = _HEADER.unpack(header)
    if length > (max_frame if max_frame is not None
                 else MAX_FRAME_SIZE):
        from . import resilience
        resilience.stats.incr("net.oversize")
        return None
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    from . import resilience
    resilience.stats.incr("net.bytes_recv", length + _HEADER.size)
    resilience.stats.incr("net.frames_recv")
    if secret is not None:
        if len(payload) < _DIGEST_SIZE:
            return None
        mac, payload = (payload[:_DIGEST_SIZE],
                        payload[_DIGEST_SIZE:])
        want = _mac_parts(secret, flags, [payload], nonce, seq)
        if not hmac_mod.compare_digest(bytes(mac), want):
            return None
    max_msg = max_message if max_message is not None \
        else MAX_MESSAGE_SIZE
    if flags & _FLAG_TENSOR:
        # Tensor-framed body (self-describing; flag is MAC-covered so
        # a peer cannot downgrade/upgrade the format undetected).
        return decode_tensor_parts(payload, loads=loads,
                                   max_message=max_msg)
    if flags & _FLAG_GZIP:
        payload = _bounded_gunzip(payload, max_msg)
        if payload is None:
            resilience.stats.incr("net.oversize")
            return None
    return (loads or pickle.loads)(payload)


def _bounded_gunzip(payload, limit):
    """Gzip-decompresses with a hard output cap; None on overflow or
    corrupt input (both mean the peer is hostile or broken)."""
    d = zlib.decompressobj(wbits=16 + zlib.MAX_WBITS)
    try:
        out = d.decompress(payload, limit + 1)
    except zlib.error:
        return None
    if len(out) > limit or d.unconsumed_tail or d.unused_data \
            or not d.eof:
        # Oversize, trailing garbage (unused_data — bytes after the
        # member, incl. a second gzip member our sender never emits),
        # or a TRUNCATED stream (valid prefix, no terminator) —
        # partial plaintext must never reach the unpickler.
        return None
    return out


class Channel(object):
    """A socket wrapper binding HMAC authentication to a
    per-connection nonce and monotonic per-direction sequence numbers
    (a static-key HMAC alone would let captured frames be replayed).

    Handshake contract: both sides start with ``nonce=b""`` and
    sequence 0; the server issues ``os.urandom(16)`` in its
    ``handshake_ack`` and both sides then :meth:`rekey` — every later
    frame is MAC-bound to that session."""

    def __init__(self, sock, secret=None, injector=None, codec=None):
        self.sock = sock
        self.secret = normalize_secret(secret)
        self.nonce = b""
        self.send_seq = 0
        self.recv_seq = 0
        #: Fault injector consulted at ``net.send``/``net.recv``
        #: (resilience.FaultInjector); None falls back to the
        #: process-wide one, so a ``--chaos`` plan reaches every
        #: channel without explicit wiring.
        self.injector = injector
        #: Negotiated wire protocol (set by :meth:`set_proto` after
        #: the handshake); empty = legacy pickle framing.
        self.proto = {}
        self.codec = codec or WireCodec.from_config()
        self._send_lock = threading.Lock()

    def _injector(self):
        from . import resilience
        return resilience.effective(self.injector)

    def rekey(self, nonce):
        self.nonce = nonce

    def set_proto(self, proto):
        """Installs the handshake-negotiated protocol: tensor framing
        on/off and the effective codec (both peers must agree — the
        negotiation result rides the handshake_ack).  An EMPTY proto
        (legacy pickle-compat session) keeps the channel's configured
        codec: old peers decompress _FLAG_GZIP frames fine, and
        dropping to codec 'none' would ship their params-sized
        pickles uncompressed — a silent wire-volume regression on
        exactly the compat path."""
        self.proto = dict(proto or {})
        if not self.proto:
            return
        self.codec = WireCodec(self.proto.get("codec", "none"),
                               self.proto.get("codec_level"),
                               self.proto.get("codec_threshold"))

    @property
    def tensor_mode(self):
        return bool(self.proto.get("tensor"))

    def encode(self, obj):
        """The expensive half of :meth:`send` (serialize + compress),
        safe to run outside any lock; pair with :meth:`send_parts`."""
        with _tracing.span("net.serialize"):
            return encode_message(obj, codec=self.codec,
                                  tensor=self.tensor_mode)

    def send_parts(self, flags, parts):
        """The socket half of :meth:`send`: MAC + sequence + sendall.
        Serialized per channel — two threads interleaving parts of
        different frames would corrupt the stream."""
        self._injector().check("net.send")
        with _tracing.span("net.send"):
            with self._send_lock:
                send_parts(self.sock, flags, parts, self.secret,
                           nonce=self.nonce,
                           seq=self.send_seq if self.secret else None)
                if self.secret is not None:
                    self.send_seq += 1

    def send(self, obj):
        self.send_parts(*self.encode(obj))

    def recv(self):
        self._injector().check("net.recv")
        obj = recv_message(self.sock, self.secret, nonce=self.nonce,
                           seq=self.recv_seq if self.secret else None)
        if obj is not None and self.secret is not None:
            self.recv_seq += 1
        return obj

    def close(self, drain=0.0):
        """Closes the socket; with ``drain`` seconds, after a half-close
        and a read of what the peer still sends until it hangs up (or
        the time is out): closing with unread bytes in the receive
        buffer sends a reset, which can destroy a last frame (a "bye")
        still on its way to the peer."""
        if drain:
            try:
                self.sock.shutdown(socket.SHUT_WR)
                self.sock.settimeout(drain)
                while self.sock.recv(65536):
                    pass
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


def _recv_exact(sock, n):
    """Receives exactly ``n`` bytes into ONE preallocated writable
    buffer (``recv_into`` — no per-chunk bytes objects, and tensor
    frames can expose writable zero-copy array views over it).
    Returns a memoryview, or None on close/error."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            r = sock.recv_into(view[got:], n - got)
        except (ConnectionResetError, OSError):
            return None
        if not r:
            return None
        got += r
    return view


def init_parser(parser):
    """The data plane's flags of the command line."""
    parser.add_argument(
        "--net-codec", default=None,
        metavar="NAME[:LEVEL[:THRESHOLD]]",
        help="wire payload codec: 'none' or 'gzip' with optional "
             "compression level and byte threshold below which "
             "frames ship uncompressed (default gzip:1:65536); "
             "negotiated down to what the peer supports")
    parser.add_argument(
        "--net-dtype", default=None, choices=tuple(DELTA_DTYPES),
        help="worker→master weight-delta wire dtype: " + "; ".join(
            "%s: %s" % (name, codec["help"])
            for name, codec in DELTA_DTYPES.items()))
    parser.add_argument(
        "--job-ticks", type=int, default=None, metavar="K",
        help="minibatch ticks per distributed job (default 1): the "
             "worker runs K ticks as one fused scan-block dispatch, "
             "amortizing one weight sync over K minibatches")
    parser.add_argument(
        "--net-zero", type=int, default=None, metavar="K",
        help="ZeRO over the wire: optimizer slots join the delta "
             "data plane SHARDED K ways — each worker owns and syncs "
             "a 1/K flat slice of every slot tensor, so slot wire "
             "bytes and the master's per-worker synced-base memory "
             "divide by K instead of replicating (default 0 = slots "
             "stay worker-local; K=1 replicates the full state to "
             "every worker; handshake-negotiated, old peers fall "
             "back to no slot sync)")
    parser.add_argument(
        "--net-legacy", action="store_true",
        help="force the legacy full-pickled-weights protocol "
             "(disables delta sync and tensor framing)")
    parser.add_argument(
        "--net-require", action="store_true",
        help="refuse pickle-compat fallback: workers without the "
             "tensor-framing capability are rejected with an "
             "actionable error instead of being served legacy frames")


def parse_codec_spec(spec):
    """"gzip:6:4096" → ("gzip", 6, 4096); level/threshold optional."""
    parts = str(spec).split(":")
    name = parts[0] or "none"
    if name not in ("none", "gzip"):
        raise ValueError(
            "unknown net codec %r (known: none, gzip)" % name)
    level = int(parts[1]) if len(parts) > 1 and parts[1] else None
    threshold = int(parts[2]) if len(parts) > 2 and parts[2] else None
    return name, level, threshold


def connect(address, timeout=None, io_timeout=None):
    """Dials ``address``.  ``timeout`` bounds the CONNECT only;
    ``io_timeout`` (default None = blocking) is what the socket runs
    with afterwards.  Leaving the connect timeout armed was a bug: a
    worker blocking in ``recv`` for a job longer than the connect
    timeout got ``socket.timeout``, misread it as a dead peer, and
    spuriously reconnected.

    TCP keepalive replaces that accidental liveness bound with a
    deliberate one: a silent partition (peer host power-cycled, NAT
    state dropped — no FIN/RST ever arrives) surfaces as a dead
    connection within a few minutes instead of blocking ``recv``
    forever."""
    host, port = parse_address(address)
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(io_timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 20),
                     ("TCP_KEEPCNT", 4)):
        if hasattr(socket, opt):  # platform-dependent knobs
            sock.setsockopt(socket.IPPROTO_TCP,
                            getattr(socket, opt), val)
    return sock
