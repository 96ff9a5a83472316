"""Free Music Archive wrappers (reference: datasets/AudioMixtures/FMA.py).

The port's copy of ``timbre_trap_tpu/data/datasets/fma.py``.

Audio-only mp3 corpus with genre splits derived from the fma_metadata CSVs.
Audio decodes through the native MP3 path (``data/io/native.py`` →
``native/src/mp3_decode.cc`` over the system libmpg123); on machines
without libmpg123, loading degrades per-sample to empty audio exactly like
the reference's torchaudio error path (``AudioDataset.py:79-84``).
"""

import ast
import csv
import os

from ..audio import AudioDataset
from ..download import stream_url_resource, unzip_and_remove, change_base_dir

__all__ = ["FMA", "FMA_F", "FMA_L", "FMA_M", "FMA_S"]


class FMABase(AudioDataset):
    """Genre-split FMA wrapper; subclasses select the download size."""

    SIZE = None

    def __init__(self, **kwargs):
        self.metadata = None
        AudioDataset.__init__(self, **kwargs)

    def load_metadata(self):
        """Map 6-digit track ids to their top-level genre titles."""
        genres_path = os.path.join(self.base_dir, "fma_metadata", "genres.csv")
        genre_ids, titles, top_levels = [], [], []
        with open(genres_path, newline="") as fh:
            for row in csv.DictReader(fh):
                genre_ids.append(int(row["genre_id"]))
                titles.append(row["title"])
                top_levels.append(int(row["top_level"]))
        root_titles = {gid: titles[genre_ids.index(tl)]
                       for gid, tl in zip(genre_ids, top_levels)}

        tracks_path = os.path.join(self.base_dir, "fma_metadata", "tracks.csv")
        self.metadata = {}
        with open(tracks_path, newline="") as fh:
            reader = csv.reader(fh)
            header_top = next(reader)     # section row ('track', 'album', ...)
            header_sub = next(reader)     # field row ('genres_all', ...)
            next(reader, None)            # units row
            # locate the track/genres_all column
            col = None
            for i, (top, sub) in enumerate(zip(header_top, header_sub)):
                if top == "track" and sub == "genres_all":
                    col = i
            if col is None:
                raise ValueError("could not locate track/genres_all column")
            for row in reader:
                if not row or not row[0]:
                    continue
                track_id = f"{int(row[0]):06d}"
                try:
                    genre_ids_all = ast.literal_eval(row[col]) or []
                except (ValueError, SyntaxError):
                    genre_ids_all = []
                genres = sorted({root_titles[g] for g in genre_ids_all
                                 if g in root_titles})
                self.metadata[track_id] = genres if genres else ["None"]

    @staticmethod
    def available_splits():
        return ["Rock", "Electronic", "Experimental", "Hip-Hop", "Folk",
                "Instrumental", "Pop", "International", "Classical",
                "Old-Time / Historic", "Jazz", "Country", "Soul-RnB",
                "Spoken", "Blues", "Easy Listening", "None"]

    def get_tracks(self, split):
        if self.metadata is None:
            self.load_metadata()
        return [t for t, genres in self.metadata.items() if split in genres]

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, track[:3], f"{track}.mp3")

    @classmethod
    def name(cls):
        return "FMA"

    @classmethod
    def download(cls, save_dir):
        AudioDataset.download(save_dir)
        meta_url = "https://os.unil.cloud.switch.ch/fma/fma_metadata.zip"
        meta_path = os.path.join(save_dir, os.path.basename(meta_url))
        stream_url_resource(meta_url, meta_path)
        unzip_and_remove(meta_path)
        audio_url = f"https://os.unil.cloud.switch.ch/fma/fma_{cls.SIZE}.zip"
        audio_path = os.path.join(save_dir, os.path.basename(audio_url))
        stream_url_resource(audio_url, audio_path)
        unzip_and_remove(audio_path)
        change_base_dir(save_dir, os.path.join(save_dir, f"fma_{cls.SIZE}"))


class FMA_F(FMABase):
    SIZE = "full"


class FMA_L(FMABase):
    SIZE = "large"


class FMA_M(FMABase):
    SIZE = "medium"


class FMA_S(FMABase):
    SIZE = "small"


# Default size matches the reference (AudioMixtures/__init__.py:1).
FMA = FMA_L
