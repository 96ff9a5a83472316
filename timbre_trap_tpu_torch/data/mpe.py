"""Audio + frame-level pitch dataset (the port's copy of
``timbre_trap_tpu/data/mpe.py``; reference: datasets/MPEDataset.py)."""

from . import constants
from .audio import AudioDataset
from .pitch import PitchDataset

__all__ = ["MPEDataset"]


class MPEDataset(AudioDataset, PitchDataset):
    """Dataset with audio and frame-level multi-pitch annotations."""

    def __init__(self, sample_rate=16000, cqt=None, resample_idcs=None, **kwargs):
        PitchDataset.__init__(self, cqt, resample_idcs, **kwargs)
        self.sample_rate = sample_rate
        if self.cqt is not None and self.sample_rate != self.cqt.sample_rate:
            raise ValueError("dataset and CQT sample rates must agree")

    def __getitem__(self, index, offset_s=None):
        track = self.tracks[index]
        audio = self.get_audio(track)
        n_samples = audio.shape[-1]

        data = {constants.KEY_TRACK: track, constants.KEY_AUDIO: audio}
        if self.n_secs is None:
            if self.cqt is not None:
                data.update(PitchDataset.__getitem__(self, index, n_samples))
        else:
            audio, offset_t = self.slice_audio(audio, offset_s=offset_s)
            data[constants.KEY_AUDIO] = audio
            if self.cqt is not None:
                data.update(PitchDataset.__getitem__(self, index, n_samples,
                                                     offset_t))
        return data
