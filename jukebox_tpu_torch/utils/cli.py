"""Minimal fire-style CLI dispatcher of the PyTorch port (a copy of
jukebox_tpu/utils/cli.py; the `fire` package is not a dependency).

Supports the reference's invocation shapes:
    python -m jukebox_tpu_torch.train --hps=vqvae,prior_1b_lyrics,all_fp16,cpu_ema --bs=1
Positional args map to the function's positional params; --key=value pairs
become kwargs with values parsed as Python literals when possible, with
comma-separated values becoming tuples.
"""

import ast
import sys


def _parse_value(text):
    if "," in text:
        parts = [p for p in text.split(",") if p != ""]
        return tuple(_parse_value(p) for p in parts)
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def fire(fn, argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args, kwargs = [], {}
    for token in argv:
        if token.startswith("--"):
            body = token[2:]
            if "=" in body:
                key, value = body.split("=", 1)
                kwargs[key] = _parse_value(value)
            else:
                kwargs[body] = True
        else:
            args.append(_parse_value(token))
    return fn(*args, **kwargs)
