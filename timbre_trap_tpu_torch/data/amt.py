"""Audio + note-annotated dataset (the port's copy of
``timbre_trap_tpu/data/amt.py``; reference: datasets/AMTDataset.py)."""

from . import constants
from .mpe import MPEDataset
from .note import NoteDataset

__all__ = ["AMTDataset"]


class AMTDataset(MPEDataset, NoteDataset):
    """Dataset with audio and note-level annotations."""

    def __getitem__(self, index, offset_s=None):
        track = self.tracks[index]
        audio = self.get_audio(track)
        n_samples = audio.shape[-1]

        data = {constants.KEY_TRACK: track, constants.KEY_AUDIO: audio}
        if self.n_secs is None:
            if self.cqt is not None:
                data.update(NoteDataset.__getitem__(self, index, n_samples))
        else:
            audio, offset_t = self.slice_audio(audio, offset_s=offset_s)
            data[constants.KEY_AUDIO] = audio
            if self.cqt is not None:
                data.update(NoteDataset.__getitem__(self, index, n_samples,
                                                    offset_t))
        return data
