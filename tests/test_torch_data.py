"""The port's host data pipeline (timbre_trap_tpu_torch.data) on the cases of
``tests/test_data.py``, and against the JAX package's on one synthetic
corpus: the datasets, the stem mixer and the shuffled loader draw the same
numbers from the same seeds and yield the same arrays bit for bit. Also
the prefetch thread's lifetime: it ends, with the loader's worker pool,
when the consumer stops early. Everything here runs on the CPU; JAX is
imported only to compare."""

import os
import threading

import numpy as np
import pytest
import torch

import timbre_trap_tpu.data as jax_data
import timbre_trap_tpu_torch.data as port_data
from timbre_trap_tpu.transform.design import midi_to_hz as jax_midi_to_hz
from timbre_trap_tpu_torch.data import (AMTDataset, AudioDataset,
                                        ComboDataset, DataLoader, MPEDataset,
                                        StemMixingDataset, constants,
                                        default_collate, device_prefetch,
                                        separate_ground_truth)
from timbre_trap_tpu_torch.data.io import load_audio, load_notes_midi, save_wav
from timbre_trap_tpu_torch.data.note import NoteDataset
from timbre_trap_tpu_torch.data.pitch import PitchDataset
from timbre_trap_tpu_torch.transform import CQT
from timbre_trap_tpu_torch.transform.design import midi_to_hz

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_cqt():
    """The small geometry of ``conftest.small_cqt``, the port's CQT."""
    return CQT(n_octaves=5, bins_per_octave=12, sample_rate=8000,
               secs_per_block=0.5, device="cpu")


# --------------------------------------------------------------------- #
# IO                                                                    #
# --------------------------------------------------------------------- #

def test_wav_round_trip(tmp_path):
    path = str(tmp_path / "t.wav")
    audio = 0.5 * np.sin(2 * np.pi * 440 * np.arange(8000) / 8000)
    save_wav(path, audio.astype(np.float32), 8000)
    loaded, fs = load_audio(path, sample_rate=8000, normalize=False)
    assert fs == 8000 and loaded.shape == (1, 8000)
    assert np.allclose(loaded[0], audio, atol=1e-3)


def test_wav_resample_and_normalize(tmp_path):
    path = str(tmp_path / "t.wav")
    audio = 0.25 * np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)
    save_wav(path, audio.astype(np.float32), 16000)
    loaded, fs = load_audio(path, sample_rate=8000)
    assert fs == 8000
    assert abs(loaded.shape[-1] - 8000) <= 1
    assert np.abs(loaded).max() == pytest.approx(1.0, abs=1e-6)  # inf-norm


def test_wav_loads_as_the_jax_package_loads(tmp_path):
    """The same file through both packages' loaders (the native loader
    where it builds, else the numpy one), at the file's rate and
    resampled: the same bits."""
    path = str(tmp_path / "t.wav")
    audio = 0.3 * np.random.default_rng(4).standard_normal(12345)
    save_wav(path, audio.astype(np.float32), 16000)
    for sr in (16000, 8000):
        got, fs = load_audio(path, sample_rate=sr)
        want, want_fs = jax_data.io.load_audio(path, sample_rate=sr)
        assert fs == want_fs and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_unsupported_format(tmp_path):
    path = str(tmp_path / "t.ogg")
    open(path, "wb").write(b"OggS\x00")
    with pytest.raises(ValueError):
        load_audio(path)
    bad_mp3 = str(tmp_path / "t.mp3")
    open(bad_mp3, "wb").write(b"\xff\xfb")
    with pytest.raises((ValueError, RuntimeError)):
        load_audio(bad_mp3)


# --------------------------------------------------------------------- #
# MIDI                                                                  #
# --------------------------------------------------------------------- #

def _varlen(n):
    out = [n & 0x7F]
    n >>= 7
    while n:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(reversed(out))


def _write_midi(path, events, ticks_per_beat=480):
    """events: list of (delta_ticks, raw message bytes)."""
    track = b""
    for delta, msg in events:
        track += _varlen(delta) + msg
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track
    header = b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big") \
        + (1).to_bytes(2, "big") + ticks_per_beat.to_bytes(2, "big")
    chunk = b"MTrk" + len(track).to_bytes(4, "big") + track
    with open(path, "wb") as fh:
        fh.write(header + chunk)


def test_midi_basic_notes(tmp_path):
    path = str(tmp_path / "t.mid")
    _write_midi(path, [
        (0, bytes([0xFF, 0x51, 0x03, 0x07, 0xA1, 0x20])),  # tempo 500000
        (0, bytes([0x90, 60, 100])),     # C4 on at t=0
        (480, bytes([0x80, 60, 0])),     # C4 off at 0.5 s
        (0, bytes([0x90, 64, 90])),      # E4 on at 0.5 s
        (960, bytes([0x90, 64, 0])),     # E4 off (note-on vel 0) at 1.5 s
    ])
    pitches, velocities, intervals = load_notes_midi(path)
    assert list(pitches) == [60, 64]
    assert list(velocities) == [100, 90]
    assert intervals[0] == pytest.approx([0.0, 0.5])
    assert intervals[1] == pytest.approx([0.5, 1.5])


def test_midi_sustain_extension(tmp_path):
    path = str(tmp_path / "t.mid")
    _write_midi(path, [
        (0, bytes([0x90, 60, 100])),      # on at 0
        (240, bytes([0xB0, 64, 127])),    # sustain down at 0.25
        (240, bytes([0x80, 60, 0])),      # off at 0.5 (sustained!)
        (480, bytes([0xB0, 64, 0])),      # sustain up at 1.0
        (480, bytes([0x90, 62, 50])),     # later event
        (0, bytes([0x80, 62, 0])),
    ])
    pitches, _, intervals = load_notes_midi(path)
    assert intervals[0] == pytest.approx([0.0, 1.0])
    want = jax_data.io.load_notes_midi(path)
    for got, ref in zip((pitches, _, intervals), want):
        np.testing.assert_array_equal(got, ref)


def test_midi_tempo_change(tmp_path):
    path = str(tmp_path / "t.mid")
    _write_midi(path, [
        (0, bytes([0x90, 60, 100])),
        (480, bytes([0xFF, 0x51, 0x03, 0x0F, 0x42, 0x40])),  # tempo 1000000
        (480, bytes([0x80, 60, 0])),      # 0.5 s + 1.0 s = 1.5 s
    ])
    _, _, intervals = load_notes_midi(path)
    assert intervals[0] == pytest.approx([0.0, 1.5])


def test_midi_running_status(tmp_path):
    path = str(tmp_path / "t.mid")
    _write_midi(path, [
        (0, bytes([0x90, 60, 100])),
        (0, bytes([64, 100])),           # running 0x90: E4 on
        (480, bytes([0x80, 60, 0])),
        (0, bytes([64, 0])),             # running 0x80: E4 off
    ])
    pitches, _, intervals = load_notes_midi(path)
    assert sorted(pitches) == [60, 64]


# --------------------------------------------------------------------- #
# Collation                                                             #
# --------------------------------------------------------------------- #

def test_default_collate(rng):
    samples = [{"track": f"t{i}", "audio": rng.standard_normal((1, 10))}
               for i in range(3)]
    batch = default_collate(samples)
    assert batch["track"] == ["t0", "t1", "t2"]
    assert batch["audio"].shape == (3, 1, 10)


def test_separate_ground_truth():
    both = {constants.KEY_TRACK: "a", constants.KEY_AUDIO: np.zeros((1, 4)),
            constants.KEY_GROUND_TRUTH: np.zeros((3, 2)),
            constants.KEY_TIMES: np.zeros(2)}
    audio_only = {constants.KEY_TRACK: "b",
                  constants.KEY_AUDIO: np.zeros((1, 4))}
    b, a, s = separate_ground_truth([both, audio_only])
    assert b[constants.KEY_AUDIO].shape == (1, 1, 4)
    assert a[constants.KEY_TRACK] == ["b"]
    assert s is None
    with pytest.raises(ValueError):
        separate_ground_truth([{constants.KEY_TRACK: "c"}])


# --------------------------------------------------------------------- #
# Synthetic datasets, in both packages                                  #
# --------------------------------------------------------------------- #

def _toy_classes(pkg):
    """The toy audio, MPE (``<track>.f0.npy``) and AMT (``<track>.notes.npy``)
    datasets of ``tests/test_data.py`` over one package's base classes."""

    class ToyAudio(pkg.AudioDataset):
        @staticmethod
        def available_splits():
            return ["all"]

        def get_tracks(self, split):
            return sorted(os.path.splitext(f)[0]
                          for f in os.listdir(self.base_dir)
                          if f.endswith(".wav"))

        def get_audio_path(self, track):
            return os.path.join(self.base_dir, f"{track}.wav")

    class ToyMPE(pkg.MPEDataset, ToyAudio):
        def get_tracks(self, split):
            return ToyAudio.get_tracks(self, split)

        def get_audio_path(self, track):
            return ToyAudio.get_audio_path(self, track)

        def get_ground_truth_path(self, track):
            return os.path.join(self.base_dir, f"{track}.f0.npy")

        def get_ground_truth(self, track):
            data = np.load(self.get_ground_truth_path(track),
                           allow_pickle=True).item()
            return data["times"], [np.asarray(p) for p in data["pitches"]]

    class ToyAMT(pkg.AMTDataset, ToyAudio):
        def get_tracks(self, split):
            return ToyAudio.get_tracks(self, split)

        def get_audio_path(self, track):
            return ToyAudio.get_audio_path(self, track)

        def get_ground_truth_path(self, track):
            return os.path.join(self.base_dir, f"{track}.notes.npy")

        def get_ground_truth(self, track):
            data = np.load(self.get_ground_truth_path(track),
                           allow_pickle=True).item()
            return data["pitches"], data["intervals"]

    return ToyAudio, ToyMPE, ToyAMT


_ToyAudio, _ToyMPE, _ToyAMT = _toy_classes(port_data)
_JaxToyAudio, _JaxToyMPE, _JaxToyAMT = _toy_classes(jax_data)


@pytest.fixture()
def toy_dataset_dir(tmp_path, port_cqt):
    """Three 1.5-s tones of ``tests/test_data.py`` with frame-level f0 and
    note annotations, and a 0.6-s fourth track shorter than a crop."""
    sr = port_cqt.sample_rate
    for i, (midi, secs) in enumerate([(60.0, 1.5), (64.0, 1.5), (67.0, 1.5),
                                      (55.0, 0.6)]):
        f = float(midi_to_hz(midi))
        n = int(secs * sr)
        audio = 0.5 * np.sin(2 * np.pi * f * np.arange(n) / sr)
        save_wav(str(tmp_path / f"tr{i}.wav"), audio.astype(np.float32), sr)
        times = np.arange(0, secs, 0.01)
        pitches = [np.array([f])] * len(times)
        np.save(str(tmp_path / f"tr{i}.f0.npy"),
                {"times": times, "pitches": pitches})
        np.save(str(tmp_path / f"tr{i}.notes.npy"),
                {"pitches": np.array([midi, midi + 7.0]),
                 "intervals": np.array([[0.1, secs - 0.2],
                                        [0.4, secs]])})
    return str(tmp_path)


def test_mpe_dataset_getitem(toy_dataset_dir, port_cqt):
    ds = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"],
                 sample_rate=port_cqt.sample_rate, cqt=port_cqt,
                 n_secs=1.0, seed=3)
    assert len(ds) == 4
    data = ds[0]
    n_samples = port_cqt.get_expected_samples(1.0)
    n_frames = port_cqt.get_expected_frames(n_samples)
    assert data[constants.KEY_AUDIO].shape == (1, n_samples)
    assert data[constants.KEY_GROUND_TRUTH].shape == (port_cqt.n_bins,
                                                      n_frames)
    gt = data[constants.KEY_GROUND_TRUTH]
    assert gt.max() == pytest.approx(1.0)
    peak_bin = np.argmax(gt.sum(axis=-1))
    expected_bin = np.argmin(np.abs(port_cqt.midi_freqs - 60.0))
    assert abs(int(peak_bin) - int(expected_bin)) <= 1


def test_mpe_dataset_full_track(toy_dataset_dir, port_cqt):
    ds = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"],
                 sample_rate=port_cqt.sample_rate, cqt=port_cqt,
                 n_secs=None, seed=3)
    data = ds[1]
    frames = data[constants.KEY_GROUND_TRUTH].shape[-1]
    assert frames == len(data[constants.KEY_TIMES])
    with pytest.raises(ValueError):
        _ToyMPE(base_dir=toy_dataset_dir, splits=["all"], sample_rate=16000,
                cqt=port_cqt)


def test_combo_and_loader(toy_dataset_dir, port_cqt):
    ds = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"],
                 sample_rate=port_cqt.sample_rate, cqt=port_cqt,
                 n_secs=1.0, seed=0)
    combo = ComboDataset([ds, ds])
    assert len(combo) == 8
    loader = DataLoader(combo, batch_size=3, shuffle=True, drop_last=True,
                        seed=1)
    batches = list(loader)
    assert len(batches) == len(loader) == 2
    assert batches[0][constants.KEY_AUDIO].shape[0] == 3
    assert len(DataLoader(combo, batch_size=3)) == 3


def test_loader_threaded_matches_serial(toy_dataset_dir, port_cqt):
    ds = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"],
                 sample_rate=port_cqt.sample_rate, cqt=port_cqt,
                 n_secs=None, seed=0)
    serial = list(DataLoader(ds, batch_size=1, num_workers=0))
    threaded = list(DataLoader(ds, batch_size=1, num_workers=2))
    assert [b[constants.KEY_TRACK] for b in serial] == \
           [b[constants.KEY_TRACK] for b in threaded]


def test_stem_mixing(toy_dataset_dir, port_cqt):
    ds = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"],
                 sample_rate=port_cqt.sample_rate, cqt=port_cqt,
                 n_secs=1.0, seed=0)
    mix = StemMixingDataset([ds], tracks_per_epoch=4, n_min=2, n_max=3,
                            seed=7)
    assert len(mix) == 4
    data = mix[0]
    assert data[constants.KEY_AUDIO].shape[-1] == \
        port_cqt.get_expected_samples(1.0)
    assert data[constants.KEY_GROUND_TRUTH].max() <= 1.0
    other = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"],
                    sample_rate=port_cqt.sample_rate, cqt=port_cqt,
                    n_secs=0.5)
    with pytest.raises(ValueError):
        StemMixingDataset([ds, other], tracks_per_epoch=4)


def _assert_same_item(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, str):
            assert got[key] == value, key
        else:
            assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def _both(port_cls, jax_cls, port_cqt, jax_cqt, **kw):
    return (port_cls(cqt=port_cqt, **kw), jax_cls(cqt=jax_cqt, **kw))


@pytest.mark.parametrize("kind", ["mpe", "amt"])
@pytest.mark.parametrize("n_secs", [1.0, None])
def test_datasets_match_jax_bit_for_bit(toy_dataset_dir, port_cqt, small_cqt,
                                        kind, n_secs):
    """MPEDataset and AMTDataset (the NoteDataset rasterizer) against the
    JAX classes from the same seed: every item of two passes (the crops
    draw from the dataset's RandomState; the short track is zero-padded
    two-sided) yields the same arrays, dtypes and keys."""
    port_cls, jax_cls = {"mpe": (_ToyMPE, _JaxToyMPE),
                         "amt": (_ToyAMT, _JaxToyAMT)}[kind]
    got, want = _both(port_cls, jax_cls, port_cqt, small_cqt,
                      base_dir=toy_dataset_dir, splits=["all"],
                      sample_rate=8000, n_secs=n_secs, seed=5)
    for _ in range(2):
        for i in range(len(want)):
            _assert_same_item(got[i], want[i])
    if kind == "amt":
        assert isinstance(got, NoteDataset)


def test_audio_dataset_and_fixed_offsets_match_jax(toy_dataset_dir, port_cqt,
                                                   small_cqt):
    """AudioDataset crops, and MPE items at fixed offsets (``offset_s``,
    negative for a padded short track), as the JAX classes give them."""
    got = _ToyAudio(base_dir=toy_dataset_dir, splits=["all"],
                    sample_rate=8000, n_secs=0.7, seed=9)
    want = _JaxToyAudio(base_dir=toy_dataset_dir, splits=["all"],
                        sample_rate=8000, n_secs=0.7, seed=9)
    for i in range(len(want)):
        _assert_same_item(got[i], want[i])
    got, want = _both(_ToyMPE, _JaxToyMPE, port_cqt, small_cqt,
                      base_dir=toy_dataset_dir, splits=["all"],
                      sample_rate=8000, n_secs=1.0, seed=0)
    for i, offset in ((0, 1600), (2, 0), (3, -900)):
        _assert_same_item(got.__getitem__(i, offset_s=offset),
                          want.__getitem__(i, offset_s=offset))


def test_combo_and_stem_mixing_match_jax(toy_dataset_dir, port_cqt,
                                         small_cqt):
    """ComboDataset's index walk over an MPE and an audio-only dataset, and
    StemMixingDataset's random mixes (stems drawn from its RandomState,
    ground truth summed and clipped) as the JAX classes give them."""
    kw = dict(base_dir=toy_dataset_dir, splits=["all"], sample_rate=8000,
              n_secs=1.0)
    port_mpe, jax_mpe = _both(_ToyMPE, _JaxToyMPE, port_cqt, small_cqt,
                              seed=1, **kw)
    port_audio = _ToyAudio(seed=2, **kw)
    jax_audio = _JaxToyAudio(seed=2, **kw)
    got = ComboDataset([port_mpe, port_audio])
    want = jax_data.ComboDataset([jax_mpe, jax_audio])
    assert len(got) == len(want) == 8
    for i in range(len(want)):
        _assert_same_item(got[i], want[i])
    got = StemMixingDataset([port_mpe, port_audio], tracks_per_epoch=6,
                            n_min=1, n_max=4, seed=11)
    want = jax_data.StemMixingDataset([jax_mpe, jax_audio],
                                      tracks_per_epoch=6, n_min=1, n_max=4,
                                      seed=11)
    for i in range(len(want)):
        _assert_same_item(got[i], want[i])


@pytest.mark.parametrize("source,num_workers", [("mix", 0),
                                                ("full-tracks", 2)])
def test_shuffled_loader_matches_jax_per_epoch(toy_dataset_dir, port_cqt,
                                               small_cqt, source,
                                               num_workers):
    """A shuffled DataLoader: the lifetime RNG's first epoch, then
    ``set_epoch`` keyed epochs (2 before 1), batch by batch the same arrays
    as the JAX loader's. Serially over a stem mixer (each item draws from
    the datasets' RandomStates), and with worker threads over whole tracks
    (no draws: the threads may call the datasets in any order)."""
    def loader(pkg, ds_cls, cqt):
        n_secs = 0.5 if source == "mix" else None
        ds = ds_cls(base_dir=toy_dataset_dir, splits=["all"], cqt=cqt,
                    sample_rate=8000, n_secs=n_secs, seed=4)
        if source == "mix":
            ds = pkg.StemMixingDataset([ds], tracks_per_epoch=7, n_min=1,
                                       n_max=2, seed=6)
        else:
            ds = pkg.ComboDataset([ds, ds])
        # Whole tracks differ in length: one a batch.
        return pkg.DataLoader(ds, batch_size=2 if source == "mix" else 1,
                              shuffle=True, seed=13, num_workers=num_workers,
                              drop_last=True)

    got = loader(port_data, _ToyMPE, port_cqt)
    want = loader(jax_data, _JaxToyMPE, small_cqt)
    n = len(want)
    assert len(got) == n == (3 if source == "mix" else 8)
    for epoch in (None, 2, 1):
        if epoch is not None:
            got.set_epoch(epoch)
            want.set_epoch(epoch)
        pairs = list(zip(got, want))
        assert len(pairs) == n
        for g, w in pairs:
            _assert_same_item(g, w)


# --------------------------------------------------------------------- #
# The prefetch thread                                                    #
# --------------------------------------------------------------------- #

def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device_prefetch"]


def test_device_prefetch_stops_its_thread_when_closed_early(toy_dataset_dir,
                                                            port_cqt):
    """A consumer that stops after two batches of an endless source: once
    ``close()`` returns, the prefetch thread has ended and the source was
    closed; a loader with worker threads as the source ends its pool too.
    Exceptions of the source reach the consumer."""
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    before = set(threading.enumerate())
    batches = device_prefetch(endless(), transfer=lambda b: b * 10, depth=2)
    assert [next(batches), next(batches)] == [0, 10]
    batches.close()
    assert closed == [True] and not _prefetch_threads()

    ds = _ToyMPE(base_dir=toy_dataset_dir, splits=["all"], sample_rate=8000,
                 cqt=port_cqt, n_secs=0.5, seed=0)
    loader = DataLoader(ComboDataset([ds] * 4), batch_size=2, num_workers=2)
    batches = device_prefetch(iter(loader), depth=1)
    first = next(batches)
    assert first[constants.KEY_AUDIO].shape == (2, 1, 4000)
    batches.close()
    assert set(threading.enumerate()) <= before

    def failing():
        yield 1
        raise OSError("unreadable track")

    batches = device_prefetch(failing())
    assert next(batches) == 1
    with pytest.raises(OSError, match="unreadable"):
        next(batches)
    assert not _prefetch_threads()


# --------------------------------------------------------------------- #
# Rasterization corner cases                                            #
# --------------------------------------------------------------------- #

def test_multi_pitch_to_activations_blur(port_cqt):
    freqs = port_cqt.get_midi_freqs()
    f = float(midi_to_hz(freqs[10]))
    acts = PitchDataset.multi_pitch_to_activations(
        [np.array([f]), np.array([])], freqs)
    assert acts.shape == (len(freqs), 2)
    assert acts[10, 0] == pytest.approx(1.0)  # GT bin renormalized to 1
    assert acts[9, 0] > 0 and acts[11, 0] > 0  # blur spreads
    assert acts[:, 1].sum() == 0.0
    np.testing.assert_array_equal(
        acts, jax_data.PitchDataset.multi_pitch_to_activations(
            [np.array([float(jax_midi_to_hz(freqs[10]))]), np.array([])],
            freqs))


def test_multi_pitch_out_of_bounds_warns(port_cqt):
    freqs = port_cqt.get_midi_freqs()
    with pytest.warns(RuntimeWarning):
        acts = PitchDataset.multi_pitch_to_activations(
            [np.array([5.0])], freqs)  # 5 Hz below range
    assert acts.sum() == 0.0


def test_activations_multi_pitch_round_trip(port_cqt):
    freqs = port_cqt.get_midi_freqs()
    acts = np.zeros((len(freqs), 3))
    acts[20, 0] = 0.9
    acts[40, 2] = 0.7
    mp = PitchDataset.activations_to_multi_pitch(acts, freqs, peaks_only=True)
    assert len(mp[0]) == 1 and len(mp[1]) == 0 and len(mp[2]) == 1
    assert mp[0][0] == pytest.approx(float(midi_to_hz(freqs[20])))


def test_notes_to_multi_pitch():
    times = np.array([0.0, 0.5, 1.0, 1.5])
    pitches = np.array([440.0])
    intervals = np.array([[0.4, 1.2]])
    mp = NoteDataset.notes_to_multi_pitch(pitches, intervals, times)
    assert len(mp[0]) == 0
    assert mp[1][0] == 440.0 and mp[2][0] == 440.0
    assert len(mp[3]) == 0


def test_amt_dataset_is_an_mpe_and_note_dataset(toy_dataset_dir, port_cqt):
    ds = _ToyAMT(base_dir=toy_dataset_dir, splits=["all"], sample_rate=8000,
                 cqt=port_cqt, n_secs=None)
    assert isinstance(ds, AMTDataset) and isinstance(ds, MPEDataset)
    assert isinstance(ds, NoteDataset) and isinstance(ds, AudioDataset)
    data = ds[0]
    gt = data[constants.KEY_GROUND_TRUTH]
    assert gt.shape == (port_cqt.n_bins, len(data[constants.KEY_TIMES]))
    assert gt.max() == pytest.approx(1.0)
