"""Virtual-concatenation audio dataset of the PyTorch port (counterpart of
jukebox_tpu/data/files_dataset.py): item i maps to window
[i * sample_length, (i + 1) * sample_length) of the concatenated wav files,
with an optional +-sample_length / 2 aug_shift drawn per (seed, epoch, item)
and song-boundary clamping (files_dataset.py:49-65), so the port reads the
same chunks as the JAX package. It reads the audio files the JAX package's
dataset reads (AUDIO_EXTS) through utils/io.py, at any rate, and caches
their durations in `.dur` sidecars as the JAX package does; a file that no
decoder on the machine can read raises, naming it.
"""

import math
import os

import numpy as np

from jukebox_tpu_torch.data.labels import Labeller
from jukebox_tpu_torch.utils.io import get_duration_sec, load_audio

# the audio files of the dataset (a copy of the JAX package's AUDIO_EXTS)
AUDIO_EXTS = (".mp3", ".opus", ".m4a", ".aac", ".wav", ".ogg", ".flac")


def find_files(root, exts=AUDIO_EXTS):
    out = []
    for dirpath, _, filenames in os.walk(root, followlinks=True):
        for name in filenames:
            if name.lower().endswith(exts):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


class FilesAudioDataset:
    def __init__(self, hps):
        self.sr = hps.sr
        self.channels = hps.channels
        self.min_duration = hps.min_duration or math.ceil(hps.sample_length / hps.sr)
        self.max_duration = hps.max_duration or math.inf
        self.sample_length = hps.sample_length
        if not hps.sample_length / hps.sr < self.min_duration:
            raise ValueError(f"Sample length {hps.sample_length} per sr "
                             f"{hps.sr} should be shorter than min duration "
                             f"{self.min_duration}")
        self.aug_shift = hps.aug_shift
        self.labels = hps.labels
        self.seed = int(hps.get("seed", 0))
        self.epoch = 0
        self.init_dataset(hps)

    def set_epoch(self, epoch):
        """Advance the augmentation stream: aug_shift draws are seeded per
        (seed, epoch, item)."""
        self.epoch = int(epoch)

    def filter(self, files, durations):
        keep = [i for i in range(len(files))
                if self.min_duration <= durations[i] / self.sr < self.max_duration]
        print(f"Keeping {len(keep)} of {len(files)} files")
        self.files = [files[i] for i in keep]
        self.durations = [int(durations[i]) for i in keep]
        self.cumsum = np.cumsum(self.durations)

    def init_dataset(self, hps):
        files = find_files(hps.audio_files_dir)
        print(f"Found {len(files)} files. Getting durations")
        durations = np.array([get_duration_sec(f, cache=True) * self.sr
                              for f in files])
        self.filter(files, durations)
        if self.labels:
            self.labeller = Labeller(hps.max_bow_genre_size, hps.n_tokens,
                                     self.sample_length, v3=hps.labels_v3)

    def get_index_offset(self, item):
        """item -> (song index, offset in song), centring aug shifts and
        clamping to song boundaries (files_dataset.py:49-65)."""
        half_interval = self.sample_length // 2
        if self.aug_shift:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, int(item)]))
            shift = int(rng.integers(-half_interval, half_interval))
        else:
            shift = 0
        offset = item * self.sample_length + shift
        midpoint = offset + half_interval
        assert 0 <= midpoint < self.cumsum[-1]
        index = np.searchsorted(self.cumsum, midpoint)
        start = self.cumsum[index - 1] if index > 0 else 0.0
        end = self.cumsum[index]
        assert start <= midpoint <= end
        if offset > end - self.sample_length:
            offset = max(start, offset - half_interval)
        elif offset < start:
            offset = min(end - self.sample_length, offset + half_interval)
        assert start <= offset <= end - self.sample_length
        return index, int(offset - start)

    def get_metadata(self, filename, test):
        """Override for labelled datasets: return (artist, genre, lyrics).
        This base returns no metadata, on which Labeller.get_label fails, as
        in the JAX package: a labelled run needs a subclass."""
        return None, None, None

    def get_song_chunk(self, index, offset, test=False):
        filename, total_length = self.files[index], self.durations[index]
        data, _ = load_audio(filename, sr=self.sr, offset=offset,
                             duration=self.sample_length)
        assert data.shape == (self.channels, self.sample_length), \
            f"Expected {(self.channels, self.sample_length)}, got {data.shape}"
        if self.labels:
            artist, genre, lyrics = self.get_metadata(filename, test)
            labels = self.labeller.get_label(artist, genre, lyrics,
                                             total_length, offset)
            return data.T, labels["y"]
        return data.T

    def get_item(self, item, test=False):
        index, offset = self.get_index_offset(item)
        return self.get_song_chunk(index, offset, test)

    def __len__(self):
        return int(np.floor(self.cumsum[-1] / self.sample_length))

    def __getitem__(self, item):
        return self.get_item(item)


class FixedMetadataDataset(FilesAudioDataset):
    """A labelled dataset whose every file has the same artist, genre and
    lyrics."""

    def __init__(self, hps, artist, genre, lyrics):
        self.metadata = (artist, genre, lyrics)
        super().__init__(hps)

    def get_metadata(self, filename, test):
        return self.metadata
