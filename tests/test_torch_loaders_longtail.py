"""The port's long-tail loaders against the JAX package's on the same
files: pickles, HDF5, the minibatch dump and replay (each package's
dump read by the other), the queue loader, audio windows (overlap,
short files, stereo), spectrogram features and WebHDFS text over a
local stub namenode.  Every array must be equal bit for bit — the
decoding is the same numpy and standard-library code."""

import http.server
import json
import pickle
import threading
import wave

import numpy
import pytest
import torch

import veles_tpu.prng as jprng
from veles_tpu.dummy import DummyWorkflow as JDummyWorkflow
import veles_tpu.loader.audio as jaudio
import veles_tpu.loader.hdf5 as jhdf5
import veles_tpu.loader.hdfs_loader as jhdfs
import veles_tpu.loader.interactive as jinteractive
import veles_tpu.loader.pickles as jpickles
import veles_tpu.loader.saver as jsaver
from veles_tpu.loader.fullbatch import FullBatchLoader as JFullBatch

import veles_tpu_torch.prng as tprng
from veles_tpu_torch.dummy import DummyWorkflow
import veles_tpu_torch.loader.audio as taudio
import veles_tpu_torch.loader.hdf5 as thdf5
import veles_tpu_torch.loader.hdfs_loader as thdfs
import veles_tpu_torch.loader.interactive as tinteractive
import veles_tpu_torch.loader.pickles as tpickles
import veles_tpu_torch.loader.saver as tsaver
from veles_tpu_torch.error import BadFormatError
from veles_tpu_torch.loader.fullbatch import FullBatchLoader as TFullBatch
from veles_tpu_torch.memory import Vector, map_read_all


def _pair(jmod, tmod, name, **kwargs):
    """The loader ``name`` of both packages, ``load_data``'ed."""
    jl = getattr(jmod, name)(JDummyWorkflow(), **kwargs)
    tl = getattr(tmod, name)(DummyWorkflow(), **kwargs)
    jl.load_data()
    tl.load_data()
    return jl, tl


def _same(jl, tl, attrs=("original_data", "original_labels",
                         "original_targets")):
    assert jl.class_lengths == tl.class_lengths
    for attr in attrs:
        jv, tv = getattr(jl, attr), getattr(tl, attr)
        assert bool(jv) == bool(tv), attr
        if jv:
            assert jv.mem.dtype == tv.mem.dtype, attr
            numpy.testing.assert_array_equal(jv.mem, tv.mem)


def _write_wav(path, samples, rate=8000, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((numpy.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


# -- pickles / hdf5 --------------------------------------------------------

@pytest.mark.parametrize("with_targets", [False, True])
def test_pickles_loader_equal(tmp_path, with_targets):
    rng = numpy.random.RandomState(0)
    train = (rng.rand(20, 6).astype(numpy.float32), rng.randint(0, 3, 20))
    if with_targets:
        train = train + (rng.rand(20, 2).astype(numpy.float32),)
    valid = {"data": rng.rand(8, 6).astype(numpy.float32),
             "labels": rng.randint(0, 3, 8)}
    if with_targets:
        valid["targets"] = rng.rand(8, 2).astype(numpy.float32)
    tp, vp = tmp_path / "train.pickle", tmp_path / "valid.pickle"
    for path, obj in ((tp, train), (vp, valid)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    jl, tl = _pair(jpickles, tpickles, "PicklesLoader", train_path=str(tp),
                   validation_path=str(vp), minibatch_size=5)
    _same(jl, tl)
    assert tl.class_lengths == [0, 8, 20]
    numpy.testing.assert_array_equal(tl.original_data.mem[:8],
                                     valid["data"])


def test_pickles_loader_without_paths_raises():
    with pytest.raises(BadFormatError):
        tpickles.PicklesLoader(DummyWorkflow()).load_data()


def test_hdf5_loader_equal(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = numpy.random.RandomState(0)
    paths = {}
    for name, n in (("train", 12), ("test", 5)):
        paths[name] = tmp_path / ("%s.h5" % name)
        with h5py.File(paths[name], "w") as f:
            f["data"] = rng.rand(n, 5).astype(numpy.float32)
            f["labels"] = rng.randint(0, 2, n)
    jl, tl = _pair(jhdf5, thdf5, "HDF5Loader",
                   train_path=str(paths["train"]),
                   test_path=str(paths["test"]), minibatch_size=4)
    _same(jl, tl)
    assert tl.class_lengths == [5, 0, 12]
    assert tl.original_labels.mem.dtype == numpy.int32


# -- minibatch dump / replay -----------------------------------------------

def _tiny_loader(base):
    class TinyLoader(base):
        def load_data(self):
            self.original_data.mem = numpy.arange(
                30, dtype=numpy.float32).reshape(10, 3)
            self.original_labels.mem = (numpy.arange(10) % 3).astype(
                numpy.int32)
            self.class_lengths = [0, 4, 6]

        def fill_minibatch(self):
            idx = self.minibatch_indices.mem
            self.minibatch_data.mem = numpy.take(
                self.original_data.mem, idx, axis=0)
            self.minibatch_labels.mem = numpy.take(
                self.original_labels.mem, idx, axis=0)
    return TinyLoader


def _dump(saver_mod, base, wf, path, device_fields=False):
    prng = jprng if saver_mod is jsaver else tprng
    prng.reset()
    prng.get(0).seed(3)
    loader = _tiny_loader(base)(wf, minibatch_size=4)
    if device_fields:
        loader.initialize(device=None)
    else:
        loader.initialize()
    saver = saver_mod.MinibatchesSaver(wf, file_name=path)
    saver.link_attrs(loader, "minibatch_data", "minibatch_labels",
                     "minibatch_mask", "minibatch_class")
    saver.initialize()
    for _ in range(3):  # one epoch: 4 validation + 6 train rows
        loader.serve_next_minibatch()
        loader.fill_minibatch()
        if device_fields:
            # The step's outputs: device tensors newer than the host.
            for vec in (loader.minibatch_data, loader.minibatch_labels,
                        loader.minibatch_mask):
                vec.devmem = torch.from_numpy(vec.mem.copy())
        saver.run()
    saver.stop()


@pytest.mark.parametrize("device_fields", [False, True])
def test_saver_round_trip_across_packages(tmp_path, device_fields):
    jdump, tdump = str(tmp_path / "j.dmp.gz"), str(tmp_path / "t.dmp.gz")
    _dump(jsaver, JFullBatch, JDummyWorkflow(), jdump)
    _dump(tsaver, TFullBatch, DummyWorkflow(), tdump, device_fields)
    jrec = list(jsaver.read_minibatch_stream(jdump))
    trec = list(tsaver.read_minibatch_stream(tdump))
    assert len(jrec) == len(trec) == 3
    for a, b in zip(jrec, trec):
        assert sorted(a) == sorted(b) and a["class"] == b["class"]
        for key in ("data", "labels", "mask"):
            assert a[key].dtype == b[key].dtype
            numpy.testing.assert_array_equal(a[key], b[key])
    # Each package replays the other's dump.
    for jpath, tpath in ((jdump, tdump), (tdump, jdump)):
        jl = jsaver.MinibatchesLoader(JDummyWorkflow(), file_name=jpath,
                                      minibatch_size=4)
        tl = tsaver.MinibatchesLoader(DummyWorkflow(), file_name=tpath,
                                      minibatch_size=4)
        jl.load_data()
        tl.load_data()
        _same(jl, tl)
        assert tl.class_lengths == [0, 4, 6]
        assert tl.original_data.shape == (10, 3)


def test_saver_rejects_a_foreign_file(tmp_path):
    path = tmp_path / "x.dmp"
    path.write_bytes(b"not a dump")
    with pytest.raises(BadFormatError):
        list(tsaver.read_minibatch_stream(str(path)))


def test_map_read_all_packs_every_stale_vector():
    a = Vector(numpy.zeros((3, 2), numpy.float32))
    b = Vector(numpy.zeros(4, numpy.int32))
    c = Vector(numpy.zeros(5, numpy.bool_))
    fresh = (torch.arange(6, dtype=torch.float32).reshape(3, 2),
             torch.tensor([7, -1, 3, 2], dtype=torch.int32),
             torch.tensor([True, False, True, True, False]))
    for vec, t in zip((a, b, c), fresh):
        vec.devmem = t
    map_read_all([a, b, c])
    for vec, t in zip((a, b, c), fresh):
        assert vec.mem.dtype == t.numpy().dtype
        numpy.testing.assert_array_equal(vec.mem, t.numpy())


# -- queue loader ----------------------------------------------------------

def test_queue_loader_equal():
    loaders = []
    for mod, wf in ((jinteractive, JDummyWorkflow()),
                    (tinteractive, DummyWorkflow())):
        loader = mod.QueueLoader(wf, sample_shape=(3,), minibatch_size=4)
        loader.initialize()
        for i in range(6):
            loader.feed([i, i + 0.5, -i], context="c%d" % i)
        loaders.append(loader)
    for _ in range(2):   # a full minibatch, then the two left
        for loader in loaders:
            loader.serve_next_minibatch()
            loader.fill_minibatch()
        jl, tl = loaders
        assert jl.minibatch_size == tl.minibatch_size
        assert jl.minibatch_contexts == tl.minibatch_contexts
        assert (tl.minibatch_class, tl.last_minibatch,
                tl.epoch_ended) == (0, True, True)
        for attr in ("minibatch_data", "minibatch_mask"):
            numpy.testing.assert_array_equal(getattr(jl, attr).mem,
                                             getattr(tl, attr).mem)
    assert tl.minibatch_size == 2
    assert tl.minibatch_mask.mem.tolist() == [1, 1, 0, 0]


@pytest.mark.parametrize("name", ["QueueLoader", "InteractiveLoader",
                                  "RestfulLoader"])
def test_queue_loader_stop_unblocks_the_consumer(name):
    loader = getattr(tinteractive, name)(DummyWorkflow(),
                                         sample_shape=(2,),
                                         minibatch_size=3)
    loader.initialize()
    done = threading.Event()

    def consume():
        loader.fill_minibatch()
        done.set()

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    assert not done.wait(0.2)
    loader.stop()
    assert done.wait(10)
    assert loader.minibatch_size == 0


def test_queue_loader_needs_a_sample_shape():
    with pytest.raises(ValueError):
        tinteractive.QueueLoader(DummyWorkflow()).initialize()


# -- audio -----------------------------------------------------------------

def _tones(tmp_path, freqs=(440, 3000), n=8000):
    dirs = []
    for i, freq in enumerate(freqs):
        d = tmp_path / ("tone%d" % i)
        d.mkdir()
        t = numpy.linspace(0, 1, n)
        _write_wav(d / "a.wav", 0.8 * numpy.sin(2 * numpy.pi * freq * t))
        dirs.append(str(d))
    return dirs


def test_audio_windows_and_labels_equal(tmp_path):
    dirs = _tones(tmp_path)
    jl, tl = _pair(jaudio, taudio, "AudioFileLoader", minibatch_size=4,
                   window_size=2000, train_paths=dirs)
    _same(jl, tl, ("original_data", "original_labels"))
    assert tl.class_lengths == [0, 0, 8]
    assert tl.original_data.mem.shape == (8, 2000)
    assert tl.samplerate == jl.samplerate == 8000


def test_audio_overlapping_windows_equal(tmp_path):
    _write_wav(tmp_path / "x.wav", numpy.sin(numpy.arange(4000) * 0.01))
    jl, tl = _pair(jaudio, taudio, "AudioFileLoader", window_size=2000,
                   window_step=1000,
                   train_paths=[(str(tmp_path / "x.wav"), 0)])
    _same(jl, tl, ("original_data", "original_labels"))
    assert tl.class_lengths[2] == 3


def test_audio_short_file_zero_padded_equal(tmp_path):
    _write_wav(tmp_path / "s.wav", numpy.ones(100) * 0.5)
    jl, tl = _pair(jaudio, taudio, "AudioFileLoader", window_size=1000,
                   train_paths=[(str(tmp_path / "s.wav"), 0)])
    _same(jl, tl, ("original_data", "original_labels"))
    assert numpy.all(tl.original_data.mem[0, 100:] == 0)


@pytest.mark.parametrize("mono", [False, True])
def test_audio_stereo_equal(tmp_path, mono):
    rng = numpy.random.RandomState(1)
    frames = rng.uniform(-0.9, 0.9, (50, 2))
    _write_wav(tmp_path / "st.wav", frames.ravel(), channels=2)
    _write_wav(tmp_path / "long.wav", rng.uniform(-0.9, 0.9, 900 * 2),
               channels=2)
    jl, tl = _pair(jaudio, taudio, "AudioFileLoader", window_size=200,
                   mono=mono, train_paths=[(str(tmp_path / "st.wav"), 0),
                                           (str(tmp_path / "long.wav"), 1)])
    _same(jl, tl, ("original_data", "original_labels"))
    assert tl.original_data.mem.shape == ((5, 200) if mono else
                                          (5, 200, 2))


def test_audio_decode_equal(tmp_path):
    sig = numpy.sin(numpy.linspace(0, 20, 500))
    _write_wav(tmp_path / "r.wav", sig, rate=16000)
    jdata, jrate = jaudio.decode_audio(str(tmp_path / "r.wav"))
    tdata, trate = taudio.decode_audio(str(tmp_path / "r.wav"))
    assert jrate == trate == 16000
    numpy.testing.assert_array_equal(jdata, tdata)
    numpy.testing.assert_allclose(tdata[:, 0], sig, atol=1e-3)


def test_spectrogram_features_equal(tmp_path):
    dirs = _tones(tmp_path, (400, 3200))
    jl, tl = _pair(jaudio, taudio, "SpectrogramLoader", window_size=2000,
                   fft_size=256, train_paths=dirs)
    _same(jl, tl, ("original_data", "original_labels"))
    n_frames = (2000 - 256) // 128 + 1
    assert tl.original_data.mem.shape == (8, n_frames, 129)
    spec, labels = tl.original_data.mem, tl.original_labels.mem
    assert abs(int(spec[labels == 0].mean(axis=(0, 1)).argmax()) - 13) <= 2
    assert abs(int(spec[labels == 1].mean(axis=(0, 1)).argmax()) - 102) <= 3


def test_spectrogram_rejects_a_window_shorter_than_the_fft():
    with pytest.raises(BadFormatError):
        taudio.SpectrogramLoader(DummyWorkflow(), window_size=100,
                                 fft_size=256)


# -- WebHDFS ---------------------------------------------------------------

class _WebHDFSStub(http.server.BaseHTTPRequestHandler):
    CONTENT = b"line one\nline two\nline three\n" + b"0123456789" * 10

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        import urllib.parse
        q = dict(urllib.parse.parse_qsl(
            urllib.parse.urlparse(self.path).query))
        op = q.get("op")
        if op == "GETFILESTATUS":
            blob = json.dumps({"FileStatus": {
                "length": len(self.CONTENT), "type": "FILE"}}).encode()
        elif op == "OPEN":
            off = int(q.get("offset", 0))
            blob = self.CONTENT[off:off + int(q.get("length", 1 << 30))]
        elif op == "LISTSTATUS":
            blob = json.dumps({"FileStatuses": {"FileStatus": [
                {"pathSuffix": "data.txt"}]}}).encode()
        else:
            self.send_response(400)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)


@pytest.fixture
def namenode():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _WebHDFSStub)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield "127.0.0.1:%d" % httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def test_webhdfs_client_equal(namenode):
    jc, tc = jhdfs.WebHDFSClient(namenode), thdfs.WebHDFSClient(namenode)
    assert jc.stat("/data.txt") == tc.stat("/data.txt")
    assert tc.list("/") == jc.list("/") == ["data.txt"]
    assert tc.open("/data.txt") == jc.open("/data.txt") == \
        _WebHDFSStub.CONTENT
    chunks = list(tc.iter_chunks("/f", chunk_bytes=32))
    assert chunks == list(jc.iter_chunks("/f", chunk_bytes=32))
    assert b"".join(chunks) == _WebHDFSStub.CONTENT
    assert len(chunks) == -(-len(_WebHDFSStub.CONTENT) // 32)


@pytest.mark.parametrize("chunk", [2, 3])
def test_hdfs_text_loader_equal(namenode, chunk):
    loaders = [mod.HDFSTextLoader(wf, file="/data.txt", address=namenode,
                                  chunk=chunk)
               for mod, wf in ((jhdfs, JDummyWorkflow()),
                               (thdfs, DummyWorkflow()))]
    for loader in loaders:
        loader.initialize()
    served, lines = 0, []
    while not bool(loaders[1].finished):
        for loader in loaders:
            loader.run()
        assert loaders[0].output == loaders[1].output
        assert bool(loaders[0].finished) == bool(loaders[1].finished)
        lines.extend(line for line in loaders[1].output if line)
        served += 1
    assert served == 4 // chunk + 1
    assert lines == ["line one", "line two", "line three",
                     "0123456789" * 10]


def test_hdfs_text_loader_needs_file_and_address():
    with pytest.raises(BadFormatError):
        thdfs.HDFSTextLoader(DummyWorkflow(), file="/x")
