"""Training logger and running metrics of the PyTorch port (counterpart of
jukebox_tpu/utils/logger.py): Metrics, Logger, init_logging, def_tqdm and
get_range.

The Logger writes TensorBoard event files itself, with no tensorboardX,
tensorboard or protobuf package: each record is an `Event` protobuf encoded
by hand (EventWriter) and framed as TFRecord (a little-endian uint64
length, the masked CRC-32C of those 8 bytes, the data, the masked CRC-32C
of the data). Scalars are `simple_value` summaries, text is written as
tensorboardX's add_text writes it (tag + "/text_summary", a DT_STRING
tensor of shape [1], the text plugin's metadata), into
{logdir}/logs/events.out.tfevents.<time>.<host> as the JAX package's
SummaryWriter names it. Audio goes where the JAX Logger writes it when
soundfile is absent: int16 wav files {logdir}/audio/{tag}_{i}_it{iters}.wav
through scipy.io.wavfile. The port has one process, so it is always rank 0.
"""

import os
import re
import socket
import struct
import sys
import time

import numpy as np

try:
    from tqdm import tqdm
except ImportError:  # the card's machine may not have it
    tqdm = None
else:
    class _Bar(tqdm):
        # no monitor thread: nothing of a run outlives it
        monitor_interval = 0


def def_tqdm(x, total=None):
    if tqdm is None:
        return x
    return _Bar(x, total=total, leave=True, file=sys.stdout,
                bar_format="{n_fmt}/{total_fmt} [{elapsed}<{remaining}, "
                           "{rate_fmt}{postfix}]")


def get_range(x):
    return def_tqdm(x)


# ---------------------------------------------------------------------------
# TFRecord framing and the Event protobuf, by hand
# ---------------------------------------------------------------------------

def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of bytes, as TFRecord checksums them."""
    c = 0xFFFFFFFF
    for byte in data:
        c = _CRC_TABLE[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data):
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data):
    """One TFRecord: length, its masked CRC, data, the data's masked CRC."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n):
    n &= (1 << 64) - 1  # int64: negatives as ten bytes, as protobuf does
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire):
    return _varint((field << 3) | wire)


def _int_field(field, n):
    return _key(field, 0) + _varint(n)


def _bytes_field(field, data):
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _key(field, 2) + _varint(len(data)) + data


def _double_field(field, x):
    return _key(field, 1) + struct.pack("<d", x)


def _float_field(field, x):
    return _key(field, 5) + struct.pack("<f", x)


# summary.proto Summary.Value: tag 1, simple_value 2, tensor 8, metadata 9
def scalar_value(tag, value):
    return _bytes_field(1, tag) + _float_field(2, float(value))


# tensor.proto: dtype 1 (DT_STRING = 7), tensor_shape 2 (dim 2: size 1),
# string_val 8; SummaryMetadata.plugin_data 1 (plugin_name 1; the text
# plugin's content, TextPluginData(version=0), serialises to nothing)
_TEXT_SHAPE = _bytes_field(2, _bytes_field(2, _int_field(1, 1)))
_TEXT_METADATA = _bytes_field(9, _bytes_field(1, _bytes_field(1, "text")))


def text_value(tag, text):
    tensor = _int_field(1, 7) + _TEXT_SHAPE + _bytes_field(8, text)
    return (_bytes_field(1, tag + "/text_summary") + _bytes_field(8, tensor)
            + _TEXT_METADATA)


def event(wall_time, step=0, file_version=None, values=()):
    """An Event: wall_time 1, step 2 (left out at 0, as proto3 leaves
    defaults out), file_version 3, summary 5 (Summary.value 1)."""
    out = _double_field(1, wall_time)
    if step:
        out += _int_field(2, int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version)
    if values:
        out += _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))
    return out


# tensorboardX's _clean_tag: characters other than these become "_", and
# leading slashes go
_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(name):
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


class EventWriter:
    """An event file under `logdir`, opened with its file_version record
    ("brain.Event:2"); each record is written through to the file."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "events.out.tfevents."
                                 + str(time.time())[:10] + "."
                                 + socket.gethostname())
        self._f = open(self.path, "wb")
        self.write(event(time.time(), file_version="brain.Event:2"))

    def write(self, data):
        self._f.write(tfrecord(data))
        self._f.flush()

    def add_summary(self, value, step):
        self.write(event(time.time(), step, values=[value]))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_records(path):
    """The records of a TFRecord file, each CRC checked (ValueError on a
    mismatch)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        body = data[i + 12:i + 12 + n]
        (body_crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc32c(head) or body_crc != masked_crc32c(body):
            raise ValueError(f"{path}: record at byte {i} fails its CRC")
        out.append(body)
        i += 16 + n
    return out


def _fields(data):
    """(field, wire type, value) of a protobuf message: ints for varints,
    bytes for the rest."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(data, i)
        elif wire == 1:
            val, i = data[i:i + 8], i + 8
        elif wire == 5:
            val, i = data[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(data, i)
            val, i = data[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire}")
        yield field, wire, val


def _read_varint(data, i):
    n = shift = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def read_events(path):
    """[(step, tag, value)] of an event file's summaries, in file order:
    value a float for a simple_value, the text (str) for a text summary;
    each record's CRCs checked."""
    out = []
    for rec in read_records(path):
        step, values = 0, []
        for field, _, val in _fields(rec):
            if field == 2:
                step = val
            elif field == 5:
                values += [v for f, _, v in _fields(val) if f == 1]
        for v in values:
            tag, value = None, None
            for field, _, val in _fields(v):
                if field == 1:
                    tag = val.decode("utf-8")
                elif field == 2:
                    (value,) = struct.unpack("<f", val)
                elif field == 8:
                    value = b"".join(s for f, _, s in _fields(val)
                                     if f == 8).decode("utf-8")
            out.append((step, tag, value))
    return out


# ---------------------------------------------------------------------------
# metrics and the logger (jukebox_tpu/utils/logger.py:19-133)
# ---------------------------------------------------------------------------

class Metrics:
    """Running weighted averages per key (reference logger.py:117-147)."""

    def __init__(self):
        self.sum = {}
        self.n = {}

    def reset(self):
        self.sum, self.n = {}, {}

    def update(self, tag, val, batch):
        val, batch = float(val), int(batch)
        self.sum[tag] = self.sum.get(tag, 0.0) + val * batch
        self.n[tag] = self.n.get(tag, 0) + batch
        return self.sum[tag] / self.n[tag]

    def avg(self, tag):
        if tag in self.sum:
            return self.sum[tag] / self.n[tag]
        return 0.0


class Logger:
    def __init__(self, logdir, rank=0):
        self.rank = rank
        self.logdir = logdir
        self.iters = 0
        self._pbar = None
        if rank == 0:
            os.makedirs(logdir, exist_ok=True)
            self.sw = EventWriter(f"{logdir}/logs")
        else:
            self.sw = None

    def step(self):
        self.iters += 1

    def flush(self):
        if self.sw is not None:
            self.sw.flush()

    def close(self):
        if self.sw is not None:
            self.sw.close()

    def add_scalar(self, tag, val):
        if self.sw is not None:
            self.sw.add_summary(scalar_value(clean_tag(tag), val), self.iters)

    def add_text(self, tag, text):
        if self.sw is not None:
            self.sw.add_summary(text_value(tag, text), self.iters)

    def add_audios(self, tag, auds, sample_rate=22050, max_len=None,
                   max_log=8):
        """Up to max_log clips of auds [N, T(, 1)] (numpy or a tensor on any
        device), each cut to max_len seconds, as int16 wavs."""
        if self.sw is None:
            return
        from scipy.io import wavfile
        if hasattr(auds, "detach"):
            auds = auds.detach().float().cpu().numpy()
        auds = np.asarray(auds)
        d = f"{self.logdir}/audio"
        os.makedirs(d, exist_ok=True)
        for i in range(min(len(auds), max_log)):
            aud = auds[i].squeeze()
            if max_len:
                aud = aud[: max_len * sample_rate]
            pcm = (np.clip(aud, -1, 1) * 32767).astype(np.int16)
            wavfile.write(f"{d}/{tag}_{i}_it{self.iters}.wav", sample_rate,
                          pcm)

    def get_range(self, loader, total=None):
        if self.rank == 0:
            self._pbar = def_tqdm(loader, total=total)
        else:
            self._pbar = loader
        return enumerate(self._pbar)

    def close_range(self):
        if self.rank == 0 and self._pbar is not None and tqdm is not None:
            self._pbar.close()

    def set_postfix(self, *args, **kwargs):
        if self.rank == 0 and tqdm is not None and self._pbar is not None:
            self._pbar.set_postfix(*args, **kwargs)


def init_logging(hps, local_rank, rank):
    logdir = f"{hps.local_logdir}/{hps.name}"
    logger = Logger(logdir, rank)
    metrics = Metrics()
    if rank == 0:
        os.makedirs(logdir, exist_ok=True)
        with open(logdir + "/argv.txt", "w") as f:
            f.write(" ".join(sys.argv))
        print(f"Logging to {logdir}")
    return logger, metrics
