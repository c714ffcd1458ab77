"""Host-side input pipeline of the PyTorch port (counterpart of
jukebox_tpu/data/data_processor.py): a train/test offset split, and a
deterministic epoch-shuffled loader that decodes batches ahead of the step
in a thread pool. The pool lives inside the loader's iteration: it is shut
down when the iteration ends or the iterator is closed, so no thread
outlives the loop.
"""

import concurrent.futures as futures

import numpy as np

from jukebox_tpu_torch.data.files_dataset import FilesAudioDataset
from jukebox_tpu_torch.utils.audio_utils import calculate_bandwidth


class OffsetView:
    """Train/test split as an offset view (data_processor.py:9-22)."""

    def __init__(self, dataset, start, end, test=False):
        if not 0 <= start < end <= len(dataset):
            raise ValueError(f"view [{start}, {end}) of {len(dataset)} items")
        self.dataset = dataset
        self.start, self.end, self.test = start, end, test

    def __len__(self):
        return self.end - self.start

    def __getitem__(self, item):
        return self.dataset.get_item(self.start + item, test=self.test)

    @property
    def sr(self):
        return self.dataset.sr


class ShardedLoader:
    """Deterministic epoch-shuffled, process-sharded batch loader yielding
    numpy batches [bs, T, C] (and labels [bs, ...] for labelled views), as
    jukebox_tpu's: each of nproc processes (default: torch.distributed's
    world; a data-parallel run passes its "dp" size) reads its slice
    idx[proc::nproc] of the epoch's order, cut to the same length on every
    process when dropping the last batch."""

    def __init__(self, view, bs, shuffle=True, drop_last=True, nworkers=2,
                 seed=0, proc=None, nproc=None):
        from jukebox_tpu_torch.parallel.dist import get_rank, world_size
        self.proc = get_rank() if proc is None else proc
        self.nproc = world_size() if nproc is None else nproc
        self.view = view
        self.bs = bs
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.nworkers = max(1, nworkers)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.view)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # each process reads its slice of the global batch
        per = n // self.nproc if self.drop_last else -(-n // self.nproc)
        return idx[self.proc::self.nproc][:per]

    def __len__(self):
        per = len(self._indices())
        return per // self.bs if self.drop_last else -(-per // self.bs)

    def _fetch(self, batch_idx):
        items = [self.view[int(i)] for i in batch_idx]
        if isinstance(items[0], tuple):
            return (np.stack([it[0] for it in items]),
                    np.stack([it[1] for it in items]))
        return np.stack(items)

    def __iter__(self):
        idx = self._indices()
        n_batches = len(self)
        batches = [idx[i * self.bs:(i + 1) * self.bs] for i in range(n_batches)]
        with futures.ThreadPoolExecutor(self.nworkers) as pool:
            pending = [pool.submit(self._fetch, b)
                       for b in batches[:2 * self.nworkers]]
            for b in batches[len(pending):] + [None] * len(pending):
                done = pending.pop(0)
                if b is not None:
                    pending.append(pool.submit(self._fetch, b))
                yield done.result()


class DataProcessor:
    """Dataset, bandwidth statistics, split and loaders. `dataset` may be a
    ready-made FilesAudioDataset (e.g. a labelled subclass); by default the
    unlabelled base is built from hps. proc / nproc: this process's slice
    of each batch (ShardedLoader)."""

    def __init__(self, hps, dataset=None, proc=None, nproc=None):
        self.dataset = dataset if dataset is not None else FilesAudioDataset(hps)
        duration = 1 if hps.prior else 600
        hps.bandwidth = calculate_bandwidth(self.dataset, hps,
                                            duration=duration)
        train_len = int(len(self.dataset) * hps.train_test_split)
        self.train_dataset = OffsetView(self.dataset, 0, train_len, test=False)
        self.test_dataset = OffsetView(self.dataset, train_len,
                                       len(self.dataset), test=True)
        self.train_loader = ShardedLoader(self.train_dataset, hps.bs,
                                          shuffle=True, drop_last=True,
                                          nworkers=hps.nworkers,
                                          seed=hps.get("seed", 0),
                                          proc=proc, nproc=nproc)
        self.test_loader = ShardedLoader(self.test_dataset, hps.bs,
                                         shuffle=False, drop_last=False,
                                         nworkers=hps.nworkers,
                                         seed=hps.get("seed", 0),
                                         proc=proc, nproc=nproc)
        print(f"Train {len(self.train_dataset)} samples. "
              f"Test {len(self.test_dataset)} samples")

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)
        self.train_loader.set_epoch(epoch)
        self.test_loader.set_epoch(epoch)
