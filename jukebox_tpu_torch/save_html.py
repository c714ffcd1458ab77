"""Per-sample HTML pages of the PyTorch port (a copy of
jukebox_tpu/save_html.py): one page per item with the decoded audio, the
lyric text, the alignment heatmap as a PNG, and a JS karaoke animation
driven by a down-sampled alignment JSON. The PNG (8-bit greyscale) is
written with zlib and struct; its pixels are those of the JAX package's
PIL image."""

import json
import os
import struct
import zlib

import numpy as np

from jukebox_tpu_torch.hparams import Hyperparams

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; max-width: 900px; margin: 2em auto; }}
 .lyrics span.active {{ background: #ffd54d; }}
 img {{ max-width: 100%; }}
</style></head>
<body>
<h2>{title}</h2>
<p>artist: {artist} &middot; genre: {genre}</p>
<audio id="aud" controls src="{audio}"></audio>
{align_img}
<div class="lyrics" id="lyrics">{spans}</div>
<script>
const align = {align_json};
const sr = {sr};
const totalSamples = {total_samples};
const aud = document.getElementById('aud');
aud.ontimeupdate = () => {{
  if (!align.length) return;
  const frac = aud.currentTime * sr / totalSamples;
  const row = Math.min(align.length - 1, Math.floor(frac * align.length));
  let best = 0, bestv = -1;
  for (let j = 0; j < align[row].length; j++)
    if (align[row][j] > bestv) {{ bestv = align[row][j]; best = j; }}
  document.querySelectorAll('#lyrics span').forEach((s, j) =>
    s.classList.toggle('active', j === best));
}};
</script>
</body></html>
"""


def _png_chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png_gray(path, img):
    """img [H, W] uint8 as an 8-bit greyscale PNG, every row filter 0."""
    h, w = img.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in img)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                                  0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def _alignment_png(path, alignment):
    a = np.asarray(alignment, dtype=np.float32)
    if a.size == 0:
        return False
    a = a / (a.max() + 1e-8)
    img = (255 * (1.0 - a.T)).astype(np.uint8)  # tokens x time, dark = attended
    write_png_gray(path, np.ascontiguousarray(img))
    return True


def _downsample_alignment(alignment, max_rows=512, max_cols=256):
    a = np.asarray(alignment, dtype=np.float32)
    if a.size == 0:
        return []
    r = max(1, a.shape[0] // max_rows)
    c = max(1, a.shape[1] // max_cols)
    a = a[: (a.shape[0] // r) * r, : (a.shape[1] // c) * c]
    a = a.reshape(a.shape[0] // r, r, a.shape[1] // c, c).mean(axis=(1, 3))
    return np.round(a / (a.max() + 1e-8), 3).tolist()


def _save_item_html(logdir, item, x_item, lyrics, alignment, hps):
    title = f"item_{item}"
    align_img_tag = ""
    align_json = []
    if alignment is not None:
        if _alignment_png(f"{logdir}/{title}_align.png", alignment):
            align_img_tag = f'<img src="{title}_align.png" alt="alignment">'
        align_json = _downsample_alignment(alignment)
        # json.dumps runs the C encoder (json.dump streams through the
        # Python one, ~0.6 s a page at 1b sizes); the text is the same
        with open(f"{logdir}/{title}_align.json", "w") as f:
            f.write(json.dumps(align_json))
    if not isinstance(lyrics, str):
        lyrics = ""
    spans = "".join(f"<span>{c}</span>" for c in lyrics.replace("\n", "\n "))
    info = hps.get("info", {})
    html = _PAGE.format(title=title, artist=info.get("artist", ""),
                        genre=info.get("genre", ""), align_img=align_img_tag,
                        audio=f"item_{item}.wav", spans=spans,
                        align_json=json.dumps(align_json), sr=hps.sr,
                        total_samples=int(np.asarray(x_item).shape[0]))
    with open(f"{logdir}/{title}.html", "w") as f:
        f.write(html)


def save_html(logdir, x, zs, labels, alignments, hps):
    os.makedirs(logdir, exist_ok=True)
    x = np.asarray(x)
    infos = labels.get("info", [{}] * x.shape[0]) if isinstance(labels, dict) else [{}] * x.shape[0]
    for item in range(x.shape[0]):
        info = infos[item] if item < len(infos) else {}
        lyrics = info.get("lyrics", "") if isinstance(info, dict) else ""
        alignment = alignments[item] if alignments is not None else None
        item_hps = dict(hps)
        item_hps["info"] = info if isinstance(info, dict) else {}
        _save_item_html(logdir, item, x[item], lyrics, alignment,
                        Hyperparams(**item_hps))
