"""Workflow snapshotting: checkpoint and resume (the JAX package's
``snapshotter``).

A snapshotter is a unit linked after the Decision that pickles the
whole workflow — graph, unit state, Vectors (device tensors are mapped
to the host first, ``memory.Vector.__getstate__``) — whenever the
decision reports improvement, subject to throttles: every
``interval``-th trigger, at least ``time_interval`` seconds apart.

Integrity and retention: every export writes a sidecar **manifest**
(``<blob>.manifest.json`` — SHA-256 of the blob, size, epoch,
validation error, codec, finiteness, timestamp) with the same atomic
temp + ``os.replace`` discipline as the blob itself; ``import_``
verifies the checksum before unpickling, and the resume path
(``Launcher.resume_latest`` → ``resilience.iter_snapshots``) walks back
to the previous good **generation** when the newest snapshot is
corrupt, missing, unhealthy or unloadable.  The last ``keep``
generations per prefix are retained (``--snapshot-keep``, default 3).
The database backend (:class:`SnapshotterToDB`, stdlib ``sqlite3``)
keeps the checksum in a column, prunes rows beyond ``keep`` and walks
back over rows the same way.

With ``--snapshot-artifact`` every generation also gets a serving
artifact beside its blob (``<blob>.veles.tgz`` + sha256 manifest,
written through ``export.export_workflow``), which a server following
the ``<prefix>_current.lnk`` pointer hot-deploys.

A snapshot pickles this package's classes: it loads here, not in the
JAX package (and the JAX package's snapshots do not load here).  Every
device tensor rides as a host array; ``initialize(snapshot=True)``
puts the Vectors back on whatever device the resumed run uses, so a
snapshot written on the card loads in a process that has not touched
CUDA, and resumes on the card or on the CPU.
"""

import bz2
import gzip
import hashlib
import json
import lzma
import os
import pickle
import time

import numpy

from . import resilience
from .config import root, get as config_get
from .registry import MappedUnitRegistry
from .resilience import RetryPolicy
from .units import Unit


def init_parser(parser):
    """The snapshot flags of the command line."""
    parser.add_argument(
        "-s", "--snapshot", default="", metavar="SNAPSHOT",
        help="resume from a snapshot: a blob, a *_current.lnk pointer "
             "or sqlite://DATABASE (its newest verified row)")
    parser.add_argument(
        "--snapshot-dir", default=None, metavar="DIR",
        help="snapshot destination directory; the sample workflows "
             "link a snapshotter when it is set (sets "
             "root.common.dirs.snapshots)")
    parser.add_argument(
        "--snapshot-compression", default=None,
        choices=("", "gz", "bz2", "xz"),
        help="snapshot codec (sets root.common.snapshotter."
             "compression)")
    parser.add_argument(
        "--snapshot-keep", type=int, default=None, metavar="K",
        help="retain the last K snapshot generations per prefix "
             "(default 3; 0 = unlimited; sets "
             "root.common.snapshotter.keep)")
    parser.add_argument(
        "--no-snapshots", action="store_true",
        help="disable snapshotting for this run")
    parser.add_argument(
        "--auto-resume", action="store_true",
        help="crash-resume: if the snapshot directory holds a "
             "*_current.lnk pointer, resume from the newest VERIFIED "
             "snapshot generation instead of starting fresh (no-op "
             "when -s is given or no snapshot exists)")
    parser.add_argument(
        "--snapshot-artifact", action="store_true",
        help="continuous deployment: alongside every snapshot, "
             "export the workflow's forward chain as a serving "
             "artifact (<blob>.veles.tgz + sha256 manifest sidecar) "
             "— a server watching <prefix>_current.lnk "
             "(--reload-watch) hot-deploys each verified generation "
             "(sets root.common.snapshotter.artifact)")


CODECS = {
    "": (lambda p: open(p, "wb"), lambda p: open(p, "rb"), ""),
    "gz": (lambda p: gzip.open(p, "wb"),
           lambda p: gzip.open(p, "rb"), ".gz"),
    "bz2": (lambda p: bz2.open(p, "wb"),
            lambda p: bz2.open(p, "rb"), ".bz2"),
    "xz": (lambda p: lzma.open(p, "wb"),
           lambda p: lzma.open(p, "rb"), ".xz"),
}

#: Manifest sidecar suffix (``<blob>.manifest.json``).
MANIFEST_SUFFIX = ".manifest.json"

#: Manifest schema version.
MANIFEST_FORMAT = 1


class SnapshotIntegrityError(resilience.ResilienceError):
    """A snapshot blob does not match its manifest checksum (bit rot,
    torn write, tampering).  Resume paths catch this and walk back to
    the previous generation instead of loading garbage."""


class SnapshotUnhealthyError(resilience.ResilienceError):
    """The manifest records that the snapshot was written with
    NON-FINITE trainables (a NaN epoch under the guardian's rollback
    policy): the blob is intact but resuming from it is useless, so
    the generation walk skips it like a corrupt one.  Load explicitly
    with ``verify=False`` to inspect the poisoned state."""


class SnapshotPointerError(FileNotFoundError):
    """A ``_current.lnk`` pointer that cannot be resolved (missing,
    empty, or naming a deleted snapshot).  Carries an actionable
    message naming the pointer file — the raw FileNotFoundError from
    deep inside pickle loading named only the target."""


def workflow_is_finite(workflow):
    """True when every trainable Vector of the workflow holds only
    finite values on its host mirror (pickling just mapped them
    host-side, so this reads memory already paid for)."""
    from .memory import Vector
    for unit in getattr(workflow, "units", ()):
        vecs = getattr(unit, "trainables", None)
        if not isinstance(vecs, dict):
            continue
        for vec in vecs.values():
            if isinstance(vec, Vector) and vec and \
                    vec.mem is not None and \
                    not numpy.isfinite(vec.mem).all():
                return False
    return True


def manifest_path(path):
    """The sidecar manifest path for a snapshot blob."""
    return path + MANIFEST_SUFFIX


def write_manifest_sidecar(path, manifest):
    """Writes ``path``'s sidecar manifest atomically (temp +
    ``os.replace``) — shared by the snapshot and serving-artifact
    writers: resume and the deploy gate trust the checksum, so a
    torn manifest must never exist."""
    mpath = manifest_path(path)
    tmp = mpath + ".part"
    try:
        with open(tmp, "w") as fout:
            json.dump(manifest, fout, indent=1, sort_keys=True)
        os.replace(tmp, mpath)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return manifest


def read_manifest(path):
    """The parsed manifest for a snapshot blob, or None when the blob
    has no (readable) sidecar — legacy snapshots predate manifests."""
    try:
        with open(manifest_path(path)) as fin:
            manifest = json.load(fin)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def sha256_file(path, chunk=1 << 20):
    """Streaming SHA-256 of a file (snapshots can be GBs — never read
    them whole)."""
    digest = hashlib.sha256()
    with open(path, "rb") as fin:
        while True:
            block = fin.read(chunk)
            if not block:
                break
            digest.update(block)
    return digest.hexdigest()


def _declared_families(directory):
    """Family names the directory itself declares — via
    ``*_current.lnk`` pointers AND via manifest ``prefix`` fields
    (so a family stays protected from a shorter family's
    retention/resume walks even after an operator deletes its
    pointer)."""
    import glob
    families = {os.path.basename(link)[:-len("_current.lnk")]
                for link in glob.glob(
                    os.path.join(directory, "*_current.lnk"))}
    for mpath in glob.glob(os.path.join(
            directory, "*" + MANIFEST_SUFFIX)):
        try:
            with open(mpath) as fin:
                prefix = json.load(fin).get("prefix")
        except (OSError, ValueError, AttributeError):
            continue
        if isinstance(prefix, str) and prefix:
            families.add(prefix)
    return families


def iter_generations(directory, prefix):
    """Snapshot blob paths of one family in ``directory``, newest
    first.  Ordering prefers the manifest ``created`` stamp (mtime as
    the legacy fallback); blobs of a DIFFERENT family that merely
    share the glob (``mnist_big_*`` under prefix ``mnist``) are
    excluded — by their manifest's recorded prefix, or, for legacy
    manifest-less blobs, by belonging to a longer family the
    directory's pointers declare (retention pruning must never eat
    another training's checkpoints)."""
    import glob
    if not directory or not os.path.isdir(directory):
        return []
    longer_families = {f for f in _declared_families(directory)
                       if f != prefix and f.startswith(prefix)}
    out = []
    seen = set()
    for pattern in (prefix + ".pickle*", prefix + "_*.pickle*"):
        for path in glob.glob(os.path.join(directory, pattern)):
            # .veles.tgz: a snapshot's SIBLING SERVING ARTIFACT
            # (--snapshot-artifact) shares the blob's name stem — it
            # is a deploy artifact, never a resumable generation.
            if path.endswith((MANIFEST_SUFFIX, ".part", ".lnk",
                              ".veles.tgz")) or path in seen:
                continue
            seen.add(path)
            manifest = read_manifest(path)
            if manifest is not None and \
                    manifest.get("prefix") not in (None, prefix):
                continue
            if manifest is None and any(
                    os.path.basename(path).startswith(f + "_") or
                    os.path.basename(path).startswith(f + ".")
                    for f in longer_families):
                continue
            stamp = None
            if manifest is not None:
                try:
                    stamp = float(manifest["created"])
                except (KeyError, TypeError, ValueError):
                    stamp = None
            if stamp is None:
                try:
                    stamp = os.path.getmtime(path)
                except OSError:
                    continue  # pruned between glob and stat
            out.append((stamp, path))
    out.sort(reverse=True)
    return [path for _, path in out]


class SnapshotterRegistry(MappedUnitRegistry):
    """String → snapshotter class ("file", "db")."""
    registry = {}


class SnapshotterBase(Unit, metaclass=SnapshotterRegistry):
    """Common throttling and trigger logic.

    kwargs: ``prefix`` — snapshot name stem; ``compression`` —
    ""/gz/bz2/xz; ``interval`` — snapshot every Nth trigger;
    ``time_interval`` — min seconds between snapshots; ``skip`` —
    disable; ``keep`` — generations retained per prefix (default
    ``root.common.snapshotter.keep`` or 3; 0 = unlimited).  Link
    ``suffix`` from the Decision (``snapshot_suffix``) and gate the
    unit on decision.improved.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.prefix = kwargs.get("prefix", "snapshot")
        self.compression = kwargs.get(
            "compression",
            root.common.snapshotter.get("compression", "gz"))
        self.interval = kwargs.get(
            "interval", root.common.snapshotter.get("interval", 1))
        self.time_interval = kwargs.get(
            "time_interval",
            root.common.snapshotter.get("time_interval", 1.0))
        self.skip = kwargs.get("skip", False)
        self.keep = int(kwargs.get(
            "keep", root.common.snapshotter.get("keep", 3)))
        #: Continuous deployment (``--snapshot-artifact``): export a
        #: verified serving artifact next to every snapshot blob.
        self.export_artifact = bool(kwargs.get(
            "artifact", root.common.snapshotter.get("artifact",
                                                    False)))
        super(SnapshotterBase, self).__init__(workflow, **kwargs)
        # After super().__init__ — it runs init_unpickled, which
        # clears the transient injector slot.
        #: Transient write failures (an NFS hiccup, an injected
        #: ``snapshot.fail``) are retried with backoff; exhaustion
        #: propagates — a run silently losing its checkpoints is
        #: worse than a loud stop.
        self.retry_policy = kwargs.get("retry_policy") or RetryPolicy(
            max_attempts=int(kwargs.get("write_retries", 3)),
            base_delay=0.05)
        #: Fault injector consulted at ``snapshot.write`` /
        #: ``snapshot.corrupt``; None = the process-wide one.
        #: Transient (trailing underscore): injectors hold locks.
        self.injector_ = kwargs.get("injector")
        self.view_group = "SERVICE"
        self.suffix = ""
        self.destination = None
        self._counter = 0
        self._last_time = 0.0
        self._deferred = False

    def init_unpickled(self):
        super(SnapshotterBase, self).init_unpickled()
        self.injector_ = None

    def initialize(self, **kwargs):
        super(SnapshotterBase, self).initialize(**kwargs)
        self._last_time = time.time()

    def run(self):
        self._counter += 1
        if self.skip or config_get(root.common.snapshot_disabled,
                                   False):
            return
        if self._counter % self.interval:
            return
        if time.time() - self._last_time < self.time_interval:
            return
        self._last_time = time.time()
        # With worker jobs outstanding the pickled state would
        # disagree with updates already in flight, so defer until the
        # workflow reports the queue drained (on_jobs_drained).  Only
        # a coordinator workflow has the hook; local runs never
        # defer.
        inflight = getattr(self.workflow, "total_inflight_jobs",
                           None)
        if inflight is not None and inflight():
            self._deferred = True
            self.info("deferring snapshot: %d worker job(s) in "
                      "flight", inflight())
            return
        self._deferred = False  # self-heal a stale deferral
        self.export()

    def on_jobs_drained(self):
        """Coordinator-side callback once every outstanding worker job
        has been answered or requeued — performs a deferred
        snapshot."""
        if self._deferred:
            self._deferred = False
            # Re-stamp: the throttle window starts at the actual
            # export, not at the (earlier) deferred request.
            self._last_time = time.time()
            self.export()

    def describe(self):
        """Training-progress fields recorded in the manifest: the
        decision's epoch counter and best validation error, when the
        workflow has them (duck-typed — non-training workflows
        snapshot too)."""
        decision = getattr(self.workflow, "decision", None)
        out = {}
        try:
            epoch = getattr(decision, "epoch_number", None)
            if epoch is not None:
                out["epoch"] = int(epoch)
        except (TypeError, ValueError):
            pass
        try:
            verr = getattr(decision, "min_validation_err", None)
            if verr is not None and float(verr) < 1e29:
                out["validation_error"] = float(verr)
        except (TypeError, ValueError):
            pass
        # Optimizer kind(s): resuming under a DIFFERENT optimizer
        # fails at initialize with a slot-mismatch error — recording
        # the kind here lets operators (and tooling) see what a
        # checkpoint needs before loading multi-GB state.
        kinds = sorted({
            kind for kind in (
                getattr(unit, "optimizer", None)
                for unit in getattr(self.workflow, "units", ()))
            if isinstance(kind, str)})
        if kinds:
            out["optimizer"] = "+".join(kinds)
        return out

    def export(self):
        raise NotImplementedError()


class _HashingWriter(object):
    """File-object tee that SHA-256s (and counts) every byte on its
    way to the underlying raw file — the manifest checksum comes for
    free with the write instead of re-reading the blob."""

    def __init__(self, raw):
        self._raw = raw
        self.digest = hashlib.sha256()
        self.size = 0

    def write(self, data):
        self.digest.update(data)
        # pickle protocol 5 hands PickleBuffer objects (no len());
        # the raw write reports the byte count either way.
        written = self._raw.write(data)
        self.size += written
        return written

    def flush(self):
        self._raw.flush()

    # gzip's GzipFile probes these on its fileobj.
    def seekable(self):
        return False

    @property
    def mode(self):
        return "wb"

    def fileno(self):
        return self._raw.fileno()


class SnapshotterToFile(SnapshotterBase):
    """Pickle-to-file backend."""

    MAPPING = "file"

    def __init__(self, workflow, **kwargs):
        super(SnapshotterToFile, self).__init__(workflow, **kwargs)
        self.directory = kwargs.get(
            "directory",
            config_get(root.common.dirs.snapshots, "snapshots"))

    def export(self):
        os.makedirs(self.directory, exist_ok=True)
        _, _, ext = CODECS[self.compression]
        name = self.prefix
        if self.suffix:
            name += "_" + self.suffix
        path = os.path.join(self.directory, name + ".pickle" + ext)
        digest, size = self.retry_policy.call(
            lambda: self._write_atomic(path),
            retry_on=(OSError,), stat="snapshot.retry",
            on_retry=lambda attempt, e: self.warning(
                "snapshot write failed (%s) — retrying", e))
        # Same retry umbrella as the blob: a transient error here
        # would otherwise leave a healthy blob with no sidecar —
        # loadable, but unverifiable.
        self.retry_policy.call(
            lambda: self._write_manifest(path, digest, size),
            retry_on=(OSError,), stat="snapshot.retry",
            on_retry=lambda attempt, e: self.warning(
                "manifest write failed (%s) — retrying", e))
        # Chaos: bit-rot the blob AFTER the manifest recorded the
        # good checksum — resume must now reject this generation and
        # walk back to the previous one.
        try:
            resilience.effective(self.injector_).check(
                "snapshot.corrupt")
        except resilience.InjectedSnapshotCorruption:
            corrupt_file(path)
            self.warning("chaos: flipped one byte of %s", path)
        if self.export_artifact:
            # BEFORE the pointer moves: a serving replica watching
            # _current.lnk must never resolve a pointer whose
            # artifact is still being written.
            self._export_serving_artifact(path)
        self.destination = path
        self._update_current_link(path)
        resilience.stats.incr("snapshot.write")
        size = os.path.getsize(path)
        self.info("snapshot -> %s (%.1f MB)", path, size / 1e6)
        self.prune()
        if size > (1 << 30):
            self.warning("snapshot exceeds 1 GB — consider trimming "
                         "unit state")

    def _write_atomic(self, path):
        """Pickles into a temp file in the same directory, then
        ``os.replace``s it over the target: a crash mid-pickle can
        never clobber the previous good snapshot at the same path —
        the invariant coordinator crash-resume rests on.  The
        on-disk bytes are SHA-256'd as they stream through (no
        second multi-GB read for the manifest); returns
        ``(hexdigest, size)``."""
        resilience.effective(self.injector_).check("snapshot.write")
        tmp = path + ".part"
        try:
            with open(tmp, "wb") as raw:
                tee = _HashingWriter(raw)
                # gzip/bz2/lzma .open all accept a file object; ""
                # writes straight through the tee.
                codec = {"": lambda f: f,
                         "gz": lambda f: gzip.open(f, "wb"),
                         "bz2": lambda f: bz2.open(f, "wb"),
                         "xz": lambda f: lzma.open(f, "wb")}[
                    self.compression]
                fout = codec(tee)
                try:
                    pickle.dump(self.workflow, fout,
                                protocol=pickle.HIGHEST_PROTOCOL)
                finally:
                    if fout is not tee:
                        fout.close()  # flush the codec trailer
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return tee.digest.hexdigest(), tee.size

    def _write_manifest(self, path, digest, size):
        """Sidecar integrity manifest, atomic like the blob: resume
        trusts the checksum, so a torn manifest must never exist."""
        manifest = {
            "format": MANIFEST_FORMAT,
            "sha256": digest,
            "size": size,
            "prefix": self.prefix,
            "suffix": self.suffix,
            "codec": self.compression,
            "created": time.time(),
            "finite": workflow_is_finite(self.workflow),
        }
        manifest.update(self.describe())
        return write_manifest_sidecar(path, manifest)

    def _export_serving_artifact(self, path):
        """The train→serve hot-deploy hook: exports the workflow's
        forward chain as a serving artifact next to the snapshot blob
        (``<blob>.veles.tgz`` + sha256 sidecar manifest, atomic
        temp+replace like everything else here).  A serving replica
        following this family's ``_current.lnk`` verifies the
        manifest and hot-swaps the weights in.  Workflows without an exportable forward
        chain — or transient export failures — log and skip: losing
        one deploy generation must never fail the training snapshot
        that carries it."""
        from .export import export_workflow
        from .serving.reload import ARTIFACT_SUFFIX
        apath = path + ARTIFACT_SUFFIX
        tmp = apath + ".part"
        try:
            export_workflow(self.workflow, tmp)
            digest = sha256_file(tmp)
            size = os.path.getsize(tmp)
            os.replace(tmp, apath)
            manifest = {
                "format": MANIFEST_FORMAT,
                "kind": "serving-artifact",
                "sha256": digest,
                "size": size,
                "prefix": self.prefix,
                "created": time.time(),
            }
            manifest.update(self.describe())
            write_manifest_sidecar(apath, manifest)
            resilience.stats.incr("snapshot.artifact")
            self.info("serving artifact -> %s", apath)
        except Exception as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            self.warning("serving-artifact export skipped: %s", e)

    def prune(self):
        """Deletes generations beyond ``keep`` (oldest first), with
        their manifests and sibling serving artifacts.  The newest
        generation — the one ``_current.lnk`` names — always
        survives; ``keep <= 0`` disables pruning."""
        if self.keep <= 0:
            return
        from .serving.reload import ARTIFACT_SUFFIX
        for path in iter_generations(self.directory,
                                     self.prefix)[self.keep:]:
            try:
                os.unlink(path)
            except OSError as e:
                # Keep the manifest too: a surviving blob without
                # its sidecar would degrade to an unverifiable
                # legacy snapshot.
                self.warning("cannot prune %s (%s) — kept with its "
                             "manifest", path, e)
                continue
            for extra in (manifest_path(path),
                          path + ARTIFACT_SUFFIX,
                          manifest_path(path + ARTIFACT_SUFFIX)):
                try:
                    os.unlink(extra)
                except OSError:
                    pass
            resilience.stats.incr("snapshot.prune")
            self.info("pruned snapshot generation %s", path)

    def _update_current_link(self, path):
        """Maintains ``<prefix>_current.lnk`` with the newest snapshot
        path.  Atomic for the same reason as the snapshot itself: the
        pointer is what a restarted run trusts."""
        link = os.path.join(self.directory,
                            self.prefix + "_current.lnk")
        tmp = link + ".part"
        with open(tmp, "w") as fout:
            # Absolute: a coordinator restarted from a different cwd
            # (supervisors rarely preserve it) must still find the
            # snapshot the pointer names.
            fout.write(os.path.abspath(path))
        os.replace(tmp, link)

    @staticmethod
    def resolve(path):
        """Resolves a ``_current.lnk`` pointer to its snapshot path
        (non-pointer paths pass through).  Raises
        :class:`SnapshotPointerError` naming the POINTER file when it
        is missing, empty, or dangling — the generation-walk resume
        fallback (``resilience.iter_snapshots``) then takes over for
        ``--auto-resume``; an explicit ``-s`` gets the actionable
        message instead of a raw FileNotFoundError from pickle."""
        if not path.endswith(".lnk"):
            return path
        try:
            with open(path) as fin:
                target = fin.read().strip()
        except OSError as e:
            raise SnapshotPointerError(
                "snapshot pointer %s cannot be read (%s) — pass the "
                "snapshot file itself, or use --auto-resume to walk "
                "the surviving generations" % (path, e)) from e
        if not target:
            raise SnapshotPointerError(
                "snapshot pointer %s is empty — the snapshot "
                "directory may have been partially cleaned; use "
                "--auto-resume to walk the surviving generations"
                % path)
        if not os.path.isfile(target):
            # Legacy cwd-relative pointer: pointer and snapshot share
            # a directory.
            sibling = os.path.join(os.path.dirname(path),
                                   os.path.basename(target))
            if os.path.isfile(sibling):
                return sibling
            raise SnapshotPointerError(
                "snapshot pointer %s names %s, which does not exist "
                "— the snapshot was deleted or the volume is "
                "incomplete; use --auto-resume to fall back to an "
                "older generation" % (path, target))
        return target

    @staticmethod
    def verify(path):
        """Checks ``path`` against its sidecar manifest.  Returns the
        manifest dict (or None for a legacy blob without one); raises
        :class:`SnapshotIntegrityError` — and counts
        ``snapshot.verify_fail`` — on checksum or size mismatch."""
        manifest = read_manifest(path)
        if manifest is None:
            return None
        expected = manifest.get("sha256")
        size = manifest.get("size")
        try:
            if size is not None and os.path.getsize(path) != size:
                raise SnapshotIntegrityError(
                    "snapshot %s is %d bytes, manifest says %s"
                    % (path, os.path.getsize(path), size))
            if expected and sha256_file(path) != expected:
                raise SnapshotIntegrityError(
                    "snapshot %s fails its manifest checksum "
                    "(expected sha256 %s…) — refusing to load a "
                    "corrupt checkpoint" % (path, expected[:12]))
        except SnapshotIntegrityError:
            resilience.stats.incr("snapshot.verify_fail")
            raise
        if manifest.get("finite") is False:
            resilience.stats.incr("snapshot.unhealthy")
            raise SnapshotUnhealthyError(
                "snapshot %s was written with non-finite trainables "
                "(a poisoned epoch) — the generation walk skips it; "
                "load with verify=False to inspect it" % path)
        return manifest

    @staticmethod
    def import_(path, verify=True):
        """Loads a snapshot (the resume path).  ``path`` may be the
        ``_current.lnk`` pointer file.  With ``verify`` (the
        default) the blob is checked against its manifest first;
        legacy blobs without a manifest load unchecked."""
        path = SnapshotterToFile.resolve(path)
        if verify:
            SnapshotterToFile.verify(path)
        for _, reader, ext in CODECS.values():
            if ext and path.endswith(ext):
                with reader(path) as fin:
                    return pickle.load(fin)
        with open(path, "rb") as fin:
            return pickle.load(fin)


def corrupt_file(path):
    """Flips one mid-file byte in place (chaos `snapshot.corrupt` and
    integrity tests)."""
    size = os.path.getsize(path)
    offset = size // 2
    with open(path, "r+b") as fout:
        fout.seek(offset)
        byte = fout.read(1)
        fout.seek(offset)
        fout.write(bytes([byte[0] ^ 0xFF]))


class SnapshotterToDB(SnapshotterBase):
    """Database snapshot backend on stdlib ``sqlite3``.  ``database``
    accepts a file path or an ``odbc://``-, ``sqlite://``- or
    ``db://``-style spec whose tail is treated as the file path.

    Snapshots land in a ``snapshots`` table (prefix, suffix, created,
    codec, sha256, epoch, validation_error, blob); writes ride the
    same ``retry_policy`` + ``snapshot.write`` injection point as the
    file backend, rows beyond ``keep`` are pruned per prefix, and
    resume with ``SnapshotterToDB.import_(database, prefix=...)``
    walks rows newest-first, skipping any whose blob fails its
    ``sha256`` — the DB-side equivalent of the file backend's
    generation walk.
    """

    MAPPING = "db"

    TABLE_DDL = ("CREATE TABLE IF NOT EXISTS snapshots ("
                 "id INTEGER PRIMARY KEY AUTOINCREMENT, "
                 "prefix TEXT NOT NULL, suffix TEXT, "
                 "created REAL NOT NULL, codec TEXT, "
                 "sha256 TEXT, epoch INTEGER, "
                 "validation_error REAL, finite INTEGER, "
                 "blob BLOB NOT NULL)")

    #: Columns added since the first schema revision — applied with
    #: ALTER TABLE when an existing database predates them.
    MIGRATIONS = ("sha256 TEXT", "epoch INTEGER",
                  "validation_error REAL", "finite INTEGER")

    def __init__(self, workflow, **kwargs):
        super(SnapshotterToDB, self).__init__(workflow, **kwargs)
        self.database = self._db_path(kwargs["database"])

    @staticmethod
    def _db_path(spec):
        for scheme in ("odbc://", "sqlite://", "db://"):
            if spec.startswith(scheme):
                return spec[len(scheme):]
        return spec

    @classmethod
    def _ensure_schema(cls, conn):
        conn.execute(cls.TABLE_DDL)
        import sqlite3
        for column in cls.MIGRATIONS:
            try:
                conn.execute(
                    "ALTER TABLE snapshots ADD COLUMN " + column)
            except sqlite3.OperationalError:
                pass  # already present

    def export(self):
        import sqlite3
        blob = pickle.dumps(self.workflow,
                            protocol=pickle.HIGHEST_PROTOCOL)
        if self.compression == "gz":
            blob = gzip.compress(blob)
        elif self.compression == "bz2":
            blob = bz2.compress(blob)
        elif self.compression == "xz":
            blob = lzma.compress(blob)
        # Chaos: the manifest checksum is of the GOOD blob; the
        # corrupted bytes are what lands in the row.
        stored = blob
        try:
            resilience.effective(self.injector_).check(
                "snapshot.corrupt")
        except resilience.InjectedSnapshotCorruption:
            mid = len(blob) // 2
            stored = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + \
                blob[mid + 1:]
            self.warning("chaos: flipped one byte of the %s row",
                         self.prefix)
        digest = hashlib.sha256(blob).hexdigest()
        os.makedirs(os.path.dirname(os.path.abspath(self.database)),
                    exist_ok=True)
        described = self.describe()
        described["finite"] = int(workflow_is_finite(self.workflow))
        self.retry_policy.call(
            lambda: self._insert_row(stored, digest, described),
            retry_on=(OSError, sqlite3.OperationalError),
            stat="snapshot.retry",
            on_retry=lambda attempt, e: self.warning(
                "snapshot row insert failed (%s) — retrying", e))
        resilience.stats.incr("snapshot.write")
        self.destination = "%s#%s" % (self.database, self.prefix)
        self.info("snapshot -> %s (%.1f MB)", self.destination,
                  len(stored) / 1e6)

    def _insert_row(self, blob, digest, described):
        import sqlite3
        resilience.effective(self.injector_).check("snapshot.write")
        with sqlite3.connect(self.database) as conn:
            self._ensure_schema(conn)
            conn.execute(
                "INSERT INTO snapshots (prefix, suffix, created, "
                "codec, sha256, epoch, validation_error, finite, "
                "blob) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (self.prefix, self.suffix, time.time(),
                 self.compression, digest, described.get("epoch"),
                 described.get("validation_error"),
                 described.get("finite"), sqlite3.Binary(blob)))
            if self.keep > 0:
                pruned = conn.execute(
                    "DELETE FROM snapshots WHERE prefix = ? AND id "
                    "NOT IN (SELECT id FROM snapshots WHERE "
                    "prefix = ? ORDER BY id DESC LIMIT ?)",
                    (self.prefix, self.prefix, self.keep)).rowcount
                if pruned:
                    resilience.stats.incr("snapshot.prune", pruned)

    @staticmethod
    def import_(database, prefix=None, verify=True):
        """Loads the newest VERIFIED snapshot (optionally filtered by
        prefix) from the database, walking back over rows whose blob
        fails its stored checksum — the row-store generation walk."""
        import sqlite3
        path = SnapshotterToDB._db_path(database)
        with sqlite3.connect(path) as conn:
            SnapshotterToDB._ensure_schema(conn)
            # Metadata first, blobs lazily per candidate: the walk
            # usually stops at row one, and fetching every
            # generation's (multi-GB) blob up front would balloon
            # the coordinator's memory for nothing.
            if prefix is None:
                rows = conn.execute(
                    "SELECT id, codec, sha256, finite FROM "
                    "snapshots ORDER BY id DESC").fetchall()
            else:
                rows = conn.execute(
                    "SELECT id, codec, sha256, finite FROM "
                    "snapshots WHERE prefix = ? ORDER BY id DESC",
                    (prefix,)).fetchall()
            if not rows:
                raise FileNotFoundError(
                    "no snapshot rows in %s (prefix=%r)"
                    % (path, prefix))
            last_error = None
            for row_id, codec, digest, finite in rows:
                if verify and finite == 0:
                    resilience.stats.incr("snapshot.unhealthy")
                    last_error = SnapshotUnhealthyError(
                        "snapshot row %d in %s holds non-finite "
                        "trainables — walking back" % (row_id, path))
                    continue
                blob = bytes(conn.execute(
                    "SELECT blob FROM snapshots WHERE id = ?",
                    (row_id,)).fetchone()[0])
                if verify and digest and \
                        hashlib.sha256(blob).hexdigest() != digest:
                    resilience.stats.incr("snapshot.verify_fail")
                    last_error = SnapshotIntegrityError(
                        "snapshot row %d in %s fails its checksum — "
                        "walking back to the previous generation"
                        % (row_id, path))
                    continue
                if codec == "gz":
                    blob = gzip.decompress(blob)
                elif codec == "bz2":
                    blob = bz2.decompress(blob)
                elif codec == "xz":
                    blob = lzma.decompress(blob)
                return pickle.loads(blob)
        raise last_error or FileNotFoundError(
            "no loadable snapshot rows in %s (prefix=%r)"
            % (path, prefix))


def link_snapshotter(workflow, after, **kwargs):
    """Links an improvement-gated :class:`SnapshotterToFile` after
    ``after`` (the decision, in the sample workflows) and returns it —
    or returns None when neither ``kwargs`` nor the configuration
    (``root.common.dirs.snapshots``, set by ``--snapshot-dir``) names a
    snapshot directory.  The snapshotter exports whenever the
    decision's ``improved`` holds, under its throttles, with the
    decision's ``snapshot_suffix``; its prefix defaults to the
    workflow's ``snapshot_prefix``."""
    directory = kwargs.pop("directory", None) or config_get(
        root.common.dirs.snapshots, None)
    if directory is None:
        return None
    prefix = kwargs.pop("prefix", getattr(workflow, "snapshot_prefix",
                                          "snapshot"))
    snap = SnapshotterToFile(workflow, directory=directory,
                             prefix=prefix, **kwargs)
    snap.link_from(after)
    snap.gate_skip = ~workflow.decision.improved
    snap.link_attrs(workflow.decision, ("suffix", "snapshot_suffix"))
    return snap
