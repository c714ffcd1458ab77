"""models/conditioners.py Conditioner: the device's seconds of one
window's x conditioning (the code table, the 2 x 16 dilated residual
blocks and two transposed convs from 2048 codes of level 1 to 8192
positions, the LayerNorm), from the traced part's run of the open
window's conditioner under a profile of its own (drivers/
upsampler_windows.py traced); None where the port records no
sample.x_cond span there."""

from benchmark import recorder


def read(r):
    rec = recorder.traced()
    if rec is None or not any(s.name == "sample.x_cond"
                              for s in rec["spans"]):
        return None
    runs = r.spans.get("x_cond")
    return runs[-1][2]["device_s"] if runs else None
