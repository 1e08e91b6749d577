"""Hot-deployment plumbing: artifact verification and the reload
watcher that closes the train→serve loop.

The port of the JAX package's ``veles_tpu/serving/reload.py``, which is
stdlib-only: the port keeps its own copy, with the two snapshot-format
helpers it reads (the sidecar manifest and the ``_current.lnk``
pointer) copied beside it.

A training run that snapshots with ``--snapshot-artifact`` also
exports every snapshot generation as a serving artifact
(``<blob>.veles.tgz``) with a sha256 sidecar manifest
(``<artifact>.manifest.json``: ``{"sha256", "size"}``).  A serving
replica started with ``--reload-watch <prefix>_current.lnk`` follows
the SAME pointer the trainer maintains: when it moves, the watcher
resolves the new snapshot, finds its sibling artifact, verifies it
against the manifest (bit rot, torn writes, and the
``serve.reload_corrupt`` chaos fault are all rejected here, and the
old weights keep serving), and hands the verified bytes to
:meth:`~veles_tpu_torch.serving.engine.ServingEngine.reload`.

Verification reads the artifact ONCE and loads the model from the
verified in-memory bytes — what was hashed is exactly what serves
(no check-then-reopen race with a trainer mid-replace)."""

import hashlib
import io
import json
import os
import threading

from .. import resilience
from ..logger import Logger

#: Suffix of the serving artifact the snapshotter writes next to
#: each snapshot blob.
ARTIFACT_SUFFIX = ".veles.tgz"
#: Suffix of a blob's sidecar manifest.
MANIFEST_SUFFIX = ".manifest.json"


def read_manifest(path):
    """The parsed sidecar manifest of ``path`` (``<path>.manifest.json``),
    or None when it has no readable one."""
    try:
        with open(path + MANIFEST_SUFFIX) as fin:
            manifest = json.load(fin)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def write_manifest(path):
    """Writes the sha256/size sidecar manifest of the file at ``path``
    (the format :func:`read_verified` checks) and returns it."""
    with open(path, "rb") as fin:
        blob = fin.read()
    manifest = {"sha256": hashlib.sha256(blob).hexdigest(),
                "size": len(blob)}
    with open(path + MANIFEST_SUFFIX, "w") as fout:
        json.dump(manifest, fout)
    return manifest


def resolve_pointer(path):
    """The snapshot a ``*_current.lnk`` pointer names (a path that is no
    pointer passes through).  Raises OSError when the pointer cannot
    be read, is empty, or names a file that does not exist; a pointer
    naming a bare file name is resolved beside the pointer."""
    if not path.endswith(".lnk"):
        return path
    with open(path) as fin:
        target = fin.read().strip()
    if not target:
        raise OSError("snapshot pointer %s is empty" % path)
    if not os.path.isfile(target):
        sibling = os.path.join(os.path.dirname(path),
                               os.path.basename(target))
        if os.path.isfile(sibling):
            return sibling
        raise OSError("snapshot pointer %s names %s, which does not "
                      "exist" % (path, target))
    return target


class ArtifactRejected(Exception):
    """A candidate artifact failed the deploy gate (checksum
    mismatch, missing/garbled manifest, unreadable file).  The
    caller keeps serving the OLD weights."""


def read_verified(path, injector=None, require_manifest=False):
    """Reads the artifact at ``path`` and verifies it against its
    sidecar manifest (``<path>.manifest.json``, the snapshotter
    format): sha256 and size must match.  Returns the verified bytes
    as a file object ready for ``ExportedModel``.  A missing sidecar
    passes unless ``require_manifest`` (the watcher requires it —
    unattended deployment trusts nothing unverified; an operator's
    explicit ``/admin/reload`` of a hand-built artifact does not).

    Consults the ``serve.reload_corrupt`` chaos point after the
    read: a firing rule flips one byte of the blob, so the checksum
    gate must reject it — the deterministic corruption drill."""
    try:
        with open(path, "rb") as fin:
            blob = fin.read()
    except OSError as e:
        raise ArtifactRejected(
            "cannot read artifact %s (%s)" % (path, e)) from e
    try:
        resilience.effective(injector).check("serve.reload_corrupt")
    except resilience.InjectedReloadCorruption:
        at = len(blob) // 2
        blob = blob[:at] + bytes([blob[at] ^ 0xFF]) + blob[at + 1:]
    manifest = read_manifest(path)
    if manifest is None:
        if require_manifest:
            raise ArtifactRejected(
                "artifact %s has no sidecar manifest — unattended "
                "reload deploys only sha256-manifested artifacts"
                % path)
    else:
        digest = hashlib.sha256(blob).hexdigest()
        if len(blob) != manifest.get("size") or \
                digest != manifest.get("sha256"):
            resilience.stats.incr("serve.reload_rejected")
            raise ArtifactRejected(
                "artifact %s does not match its manifest (sha256 "
                "%s… != recorded %s…, size %d vs %s) — keeping the "
                "current weights" %
                (path, digest[:12],
                 str(manifest.get("sha256"))[:12], len(blob),
                 manifest.get("size")))
    out = io.BytesIO(blob)
    out.name = path
    return out


def resolve_artifact(watch_path):
    """The artifact a watch target currently names, or None.

    ``watch_path`` may be the artifact itself, a ``*_current.lnk``
    snapshot pointer (the artifact is the pointer target's
    ``.veles.tgz`` sibling written by ``--snapshot-artifact``), or a
    non-artifact snapshot path with such a sibling."""
    try:
        target = resolve_pointer(watch_path)
    except OSError:
        return None
    if target.endswith(ARTIFACT_SUFFIX):
        return target if os.path.isfile(target) else None
    sibling = target + ARTIFACT_SUFFIX
    return sibling if os.path.isfile(sibling) else None


class ArtifactWatcher(Logger):
    """Polls a watch target and calls ``on_change(path)`` whenever
    the artifact it names changes (new pointer target, or same path
    rewritten — fingerprinted by (path, mtime_ns, size)).  The
    callback does the verify+reload; its exceptions are logged and
    swallowed so one bad artifact never kills the watcher — the next
    good generation deploys normally."""

    def __init__(self, watch_path, on_change, poll=5.0):
        super(ArtifactWatcher, self).__init__()
        self.watch_path = watch_path
        self.on_change = on_change
        self.poll = float(poll)
        self._seen = self._fingerprint()  # startup artifact = current
        self._stop = threading.Event()
        self._thread = None

    def _fingerprint(self):
        path = resolve_artifact(self.watch_path)
        if path is None:
            return None
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (os.path.abspath(path), st.st_mtime_ns, st.st_size)

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="veles-reload-watch")
        self._thread.start()
        self.info("watching %s for new serving artifacts (every "
                  "%gs)", self.watch_path, self.poll)
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll + 5.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.poll):
            self.check_once()

    def check_once(self):
        """One poll (public so tests drive it without sleeping).
        Returns True when a change was dispatched.  A genuinely bad
        artifact (:class:`ArtifactRejected`) is remembered and never
        re-polled — the next GOOD generation deploys normally; a
        TRANSIENT failure (reload timeout, engine busy) leaves the
        fingerprint unseen so the same generation retries on the
        next poll instead of being skipped forever."""
        fp = self._fingerprint()
        if fp is None or fp == self._seen:
            return False
        path = fp[0]
        self.info("watch target moved -> %s", path)
        try:
            self.on_change(path)
        except ArtifactRejected:
            self._seen = fp
            self.exception("artifact %s REJECTED — still serving "
                           "the previous weights", path)
        except Exception:
            self.exception("hot reload of %s failed — will retry "
                           "next poll", path)
            return False
        else:
            self._seen = fp
        return True
