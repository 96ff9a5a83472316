"""The port's corpus wrappers (timbre_trap_tpu_torch.data.datasets) and
download helpers (timbre_trap_tpu_torch.data.download) against the JAX
package's on the synthetic corpora of ``tests/test_datasets.py`` (8 kHz,
5 octaves x 12 bins, 0.5-s blocks): every wrapper lists the same tracks and
loads the same audio, ground truth and seeded items, bit for bit. The
download helpers run the cases of ``tests/test_download.py`` against a
localhost HTTP server. Everything here runs on the CPU; JAX is imported
only to compare."""

import http.server
import json
import os
import subprocess
import sys
import tarfile
import threading
import zipfile

import numpy as np
import pytest
import torch

import timbre_trap_tpu.data.datasets as jax_datasets
import timbre_trap_tpu_torch.data.datasets as port_datasets
from test_datasets import (  # noqa: F401 (fixtures)
    SR, _tone, _write_midi_simple, bach10_dir, musicnet_dir, trios_dir,
    urmp_dir)
from timbre_trap_tpu_torch.data import (change_base_dir,
                                        stream_url_resource, unzip_and_remove)
from timbre_trap_tpu_torch.data.io import save_wav
from timbre_trap_tpu_torch.transform import CQT

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FMA_HEADER = (",album,track\n"
              "track_id,title,genres_all\n"
              ",,\n")


@pytest.fixture(scope="module")
def port_cqt():
    return CQT(n_octaves=5, bins_per_octave=12, sample_rate=SR,
               secs_per_block=0.5, device="cpu")


# --------------------------------------------------------------------- #
# The corpora written inline by tests/test_datasets.py                   #
# --------------------------------------------------------------------- #

@pytest.fixture()
def su_dir(tmp_path):
    (tmp_path / "audio").mkdir()
    (tmp_path / "gt_Note").mkdir()
    for track, notes in (("PQ02", [[0.1, 0.9, 440.0], [1.0, 1.8, 220.0]]),
                         ("SQ01", [[0.2, 1.5, 330.0]])):
        save_wav(str(tmp_path / "audio" / f"{track}_audio.wav"),
                 _tone(60, 2.0), SR)
        np.savetxt(str(tmp_path / "gt_Note" / f"{track}_note.txt"),
                   np.array(notes))
    return str(tmp_path)


@pytest.fixture()
def maestro_dir(tmp_path):
    (tmp_path / "2018").mkdir()
    with open(tmp_path / "maestro-v3.0.0.csv", "w") as fh:
        fh.write("canonical_composer,split,audio_filename,midi_filename\n")
        fh.write("Bach,train,2018/piece.wav,2018/piece.midi\n")
        fh.write("Mozart,test,2018/other.wav,2018/other.midi\n")
    save_wav(str(tmp_path / "2018" / "piece.wav"), _tone(60, 1.0), SR)
    _write_midi_simple(str(tmp_path / "2018" / "piece.midi"),
                       [(60, 0.0, 0.8), (64, 0.4, 0.9)])
    return str(tmp_path)


@pytest.fixture()
def guitarset_dir(tmp_path):
    (tmp_path / "annotation").mkdir()
    (tmp_path / "audio_mono-mic").mkdir()
    for track, freq in (("00_Jazz1-Sw_solo", 440.0), ("00_Rock2-85_comp",
                                                      196.0)):
        data = [{"time": t, "duration": 0.0,
                 "value": {"frequency": freq, "voiced": True, "index": 0}}
                for t in np.arange(0.05, 0.9, 0.01)]
        data.append({"time": 0.95, "duration": 0.0,
                     "value": {"frequency": 0.0, "voiced": False,
                               "index": 0}})
        jam = {"file_metadata": {"duration": 1.0},
               "annotations": [{"namespace": "pitch_contour", "data": data},
                               {"namespace": "beat", "data": []}]}
        with open(tmp_path / "annotation" / f"{track}.jams", "w") as fh:
            json.dump(jam, fh)
        save_wav(str(tmp_path / "audio_mono-mic" / f"{track}_mic.wav"),
                 _tone(69, 1.0), SR)
    return str(tmp_path)


@pytest.fixture()
def medleydb_dir(tmp_path):
    """MedleyDB's Audio/ and Metadata/ trees, the Pitch-Tracking subset and
    the Stem-Synth one under one root."""
    import yaml

    song = "ArtistA_SongOne"
    audio_dir = tmp_path / "Audio" / song
    (audio_dir / f"{song}_RAW").mkdir(parents=True)
    meta_dir = tmp_path / "Metadata"
    meta_dir.mkdir()
    save_wav(str(audio_dir / f"{song}_MIX.wav"), _tone(60), SR)
    save_wav(str(audio_dir / f"{song}_RAW" / f"{song}_RAW_01_01.wav"),
             _tone(69), SR)
    metadata = {
        "genre": "Jazz",
        "stems": {"S01": {"filename": f"{song}_STEM_01.wav",
                          "instrument": "violin",
                          "raw": {"R01": {"filename": f"{song}_RAW_01_01.wav",
                                          "instrument": "violin"}}},
                  "S02": {"filename": f"{song}_STEM_02.wav",
                          "instrument": "piano",
                          "raw": {}}},
    }
    with open(meta_dir / f"{song}_METADATA.yaml", "w") as fh:
        yaml.safe_dump(metadata, fh)

    (tmp_path / "audio").mkdir()
    (tmp_path / "pitch").mkdir()
    with open(tmp_path / "medleydb_pitch_metadata.json", "w") as fh:
        json.dump({"TrackA": {"instrument": "violin"}}, fh)
    save_wav(str(tmp_path / "audio" / "TrackA.wav"), _tone(69), SR)
    f0 = np.array([[0.0, 440.0], [0.01, 440.0], [0.02, 0.0], [0.5, 441.0]])
    np.savetxt(str(tmp_path / "pitch" / "TrackA.csv"), f0, delimiter=",")

    (tmp_path / "annotation_stems").mkdir()
    (tmp_path / "audio_stems").mkdir()
    np.savetxt(str(tmp_path / "annotation_stems"
                   / f"{song}_STEM_01.RESYN.csv"), f0, delimiter=",")
    save_wav(str(tmp_path / "audio_stems" / f"{song}_STEM_01.RESYN.wav"),
             _tone(69), SR)
    return str(tmp_path)


@pytest.fixture()
def fma_dir(tmp_path):
    meta = tmp_path / "fma_metadata"
    meta.mkdir()
    with open(meta / "genres.csv", "w") as fh:
        fh.write("genre_id,#tracks,parent,title,top_level\n")
        fh.write("12,100,0,Rock,12\n")
        fh.write("25,50,12,Punk,12\n")
        fh.write("5,80,0,Classical,5\n")
    with open(meta / "tracks.csv", "w") as fh:
        fh.write(FMA_HEADER)
        fh.write('2,Song,"[25]"\n')
        fh.write('5,Other,"[5, 12]"\n')
        fh.write('9,Empty,"[]"\n')
    return str(tmp_path)


# --------------------------------------------------------------------- #
# Every wrapper against the JAX package's                                #
# --------------------------------------------------------------------- #

# (wrapper, corpus fixture, splits); every concrete class of the zoo.
WRAPPERS = [
    ("URMPMixtures", "urmp_dir", ["01"]),
    ("URMPStems", "urmp_dir", ["01"]),
    ("Bach10Mixtures", "bach10_dir", None),
    ("Bach10Stems", "bach10_dir", ["01"]),
    ("Su", "su_dir", None),
    ("TRIOSMixtures", "trios_dir", ["mozart"]),
    ("TRIOSStems", "trios_dir", ["mozart"]),
    ("MAESTRO", "maestro_dir", ["train"]),
    ("GuitarSet", "guitarset_dir", ["00"]),
    ("MedleyDBMixtures", "medleydb_dir", None),
    ("MedleyDBStems", "medleydb_dir", ["violin"]),
    ("MedleyDB_Pitch", "medleydb_dir", ["violin"]),
    ("MedleyDB_Stem_Synth", "medleydb_dir", ["violin"]),
    ("FMA_F", "fma_dir", ["Rock", "None"]),
    ("FMA_L", "fma_dir", ["Rock"]),
    ("FMA_M", "fma_dir", ["Classical"]),
    ("FMA_S", "fma_dir", None),
    ("MusicNetMixtures", "musicnet_dir", ["train"]),
    ("MusicNetSolo", "musicnet_dir", ["train"]),
]


def _assert_same(got, want, what):
    """The same nested structure of arrays, bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for key in want:
            _assert_same(got[key], want[key], f"{what}[{key}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, str):
        assert got == want, what
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name,corpus,splits", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_wrapper_matches_jax(name, corpus, splits, request, port_cqt,
                             small_cqt):
    """Tracks, audio paths, audio and ground truth of every track, and two
    passes of seeded 0.5-s crops and one of whole tracks, bit for bit."""
    base_dir = request.getfixturevalue(corpus)
    port_cls, jax_cls = getattr(port_datasets, name), getattr(jax_datasets,
                                                              name)
    mpe = hasattr(jax_cls, "get_ground_truth")
    kw = dict(base_dir=base_dir, splits=splits, sample_rate=SR)

    def both(**extra):
        return (port_cls(**kw, **extra, **({"cqt": port_cqt} if mpe else {})),
                jax_cls(**kw, **extra, **({"cqt": small_cqt} if mpe else {})))

    got, want = both(n_secs=0.5, seed=3)
    assert got.name() == want.name()
    assert got.available_splits() == want.available_splits()
    assert len(want.tracks) > 0 and got.tracks == want.tracks
    for track in want.tracks:
        assert got.get_audio_path(track) == want.get_audio_path(track)
        if name.startswith("FMA"):
            continue  # no MP3 in this corpus; see the decoding case below
        _assert_same(got.get_audio(track), want.get_audio(track), track)
        if mpe:
            _assert_same(got.get_ground_truth(track),
                         want.get_ground_truth(track), track)
    if name.startswith("FMA"):
        return
    for _ in range(2):
        for i in range(len(want)):
            _assert_same(got[i], want[i], f"item {i}")
    got, want = both(n_secs=None)
    for i in range(len(want)):
        _assert_same(got[i], want[i], f"whole item {i}")


def test_taxonomy_aliases_match_jax():
    """The five reference-taxonomy sub-packages name the same wrappers."""
    import importlib

    for sub in ("AudioMixtures", "AudioStems", "Common", "MixedMultiPitch",
                "SoloMultiPitch"):
        port = importlib.import_module(
            f"timbre_trap_tpu_torch.data.datasets.{sub}")
        jax_sub = importlib.import_module(
            f"timbre_trap_tpu.data.datasets.{sub}")
        assert port.__all__ == jax_sub.__all__, sub
        for alias in jax_sub.__all__:
            got, want = getattr(port, alias), getattr(jax_sub, alias)
            assert got.__name__ == want.__name__, (sub, alias)
            assert got.__module__.startswith("timbre_trap_tpu_torch."), alias
    assert port_datasets.__all__ == jax_datasets.__all__
    assert port_datasets.FMA is port_datasets.FMA_L


def test_wrappers_subclass_the_port_data_package():
    from timbre_trap_tpu_torch.data import (AMTDataset, AudioDataset,
                                            BaseDataset, MPEDataset)

    for name, *_ in WRAPPERS:
        cls = getattr(port_datasets, name)
        assert issubclass(cls, BaseDataset), name
        assert issubclass(cls, MPEDataset if hasattr(cls, "get_ground_truth")
                          else AudioDataset), name
    assert issubclass(port_datasets.Su, AMTDataset)


def test_fma_get_audio_decodes_mp3_as_jax(fma_dir):
    """An MP3 of the FMA corpus decodes through the port's native binding
    to the JAX package's audio, bit for bit, and its seeded crops match."""
    from test_native_audio import _lame, encode_mp3
    from timbre_trap_tpu_torch.data.io import native

    if not (native.available() and native.mp3_available() and _lame()):
        pytest.skip("libmpg123/libmp3lame unavailable")
    audio_dir = os.path.join(fma_dir, "000")
    os.makedirs(audio_dir)
    t = np.arange(2 * SR) / SR
    sig = (0.5 * np.sin(2 * np.pi * 440.0 * t) * 32767).astype(np.int16)
    encode_mp3(os.path.join(audio_dir, "000002.mp3"), sig, SR)

    kw = dict(base_dir=fma_dir, splits=["Rock"], sample_rate=SR, n_secs=0.5,
              seed=1)
    got, want = port_datasets.FMA_S(**kw), jax_datasets.FMA_S(**kw)
    audio = got.get_audio("000002")
    assert audio.shape[0] == 1 and audio.shape[-1] > SR
    _assert_same(audio, want.get_audio("000002"), "000002")
    _assert_same(got[0], want[0], "item 0")


def test_medleydb_without_pyyaml_raises_import_error(medleydb_dir,
                                                     monkeypatch):
    """Without PyYAML a wrapper that reads the YAML metadata raises the
    ImportError that names it; the JSON-only Pitch subset still loads."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    for cls in (port_datasets.MedleyDBMixtures,
                port_datasets.MedleyDB_Stem_Synth):
        with pytest.raises(ImportError, match="yaml"):
            cls(base_dir=medleydb_dir, splits=None, sample_rate=SR)
    assert port_datasets.MedleyDB_Pitch(
        base_dir=medleydb_dir, splits=["violin"], sample_rate=SR,
        cqt=None).tracks == ["TrackA"]


def test_import_needs_neither_pyyaml_nor_jax():
    """A fresh interpreter imports the zoo, its taxonomy sub-packages and
    the command-line entry points with PyYAML blocked, and holds no JAX
    module after."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import timbre_trap_tpu_torch.data.datasets\n"
            "from timbre_trap_tpu_torch.data.datasets import (AudioMixtures,"
            " AudioStems, Common, MixedMultiPitch, SoloMultiPitch)\n"
            "from timbre_trap_tpu_torch.experiments import (evaluate, "
            "sonify, train)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'timbre_trap_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# --------------------------------------------------------------------- #
# download.py: the cases of tests/test_download.py                       #
# --------------------------------------------------------------------- #

@pytest.fixture()
def http_root(tmp_path):
    root = tmp_path / "www"
    root.mkdir()
    (root / "payload.bin").write_bytes(os.urandom(70000))

    def handler(*a, **kw):
        return http.server.SimpleHTTPRequestHandler(*a, directory=str(root),
                                                    **kw)

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield root, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_stream_url_resource(http_root, tmp_path):
    root, base = http_root
    dest = str(tmp_path / "out.bin")
    stream_url_resource(f"{base}/payload.bin", dest)
    assert open(dest, "rb").read() == (root / "payload.bin").read_bytes()


def test_unzip_and_remove_zip(tmp_path):
    inner = tmp_path / "content.txt"
    inner.write_text("hello")
    zpath = str(tmp_path / "a.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.write(inner, "content.txt")
    inner.unlink()
    unzip_and_remove(zpath)
    assert not os.path.exists(zpath)
    assert (tmp_path / "content.txt").read_text() == "hello"


def test_unzip_and_remove_tar(tmp_path):
    inner = tmp_path / "content.txt"
    inner.write_text("hi")
    tpath = str(tmp_path / "a.tar.gz")
    with tarfile.open(tpath, "w:gz") as tf:
        tf.add(inner, "sub/content.txt")
    inner.unlink()
    unzip_and_remove(tpath, tar=True)
    assert not os.path.exists(tpath)
    assert (tmp_path / "sub" / "content.txt").read_text() == "hi"


def test_change_base_dir(tmp_path):
    old = tmp_path / "old"
    new = tmp_path / "new"
    old.mkdir(), new.mkdir()
    (old / "x.txt").write_text("x")
    (old / "sub").mkdir()
    change_base_dir(str(new), str(old))
    assert not old.exists()
    assert (new / "x.txt").read_text() == "x"
    assert (new / "sub").is_dir()
