from .wav import load_audio, resample_audio, save_wav
from .midi import parse_midi_messages, load_notes_midi

__all__ = ["load_audio", "resample_audio", "save_wav",
           "parse_midi_messages", "load_notes_midi"]
