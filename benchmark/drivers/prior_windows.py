"""Sampling traffic: a top prior's windows sampled back to back, as
jukebox_tpu_torch.sample.sample_level hops them, through the calls
PriorRuntime.sample makes in its order (stage_decode once; per window the
lyric encoder where the prior has one, sample_init, sample_segment in
segments, sample_finish). Set-up starts the first window and warms a step
at each temperature on it; the window goes on from there.

Traffic parameters (traffic/<mix>.json):
  batch          rows sampled together (the CLI's max_batch_size)
  hop_fraction   new codes per window over n_ctx; the window's context is
                 the rest, the codes sampled before it
  segment        tokens per sample_segment call
  chunk_size     the prefill's chunk (the CLI's chunk_size)
  temps          sampling temperature of each segment, in turn (0: greedy,
                 the tokens the check compares)
  fp16           the staged bf16 decode (the CLI's fp16=True)
  offset_tokens  the level position of the first window (labels' offset)
  total_seconds  [lo, hi] of the songs' total length drawn for the labels
  check_rows     rows of each window the reference recomputes
  check_windows  windows the reference recomputes (the first ones)

The logits of the checked rows are kept as the timed path hands them to
the token sampler, and compared with the reference's at every served
position.
"""

import gc
import sys

import numpy as np
import torch

from benchmark import common, weights
from benchmark.reference import prior as ref


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def raw_to_tokens(hp, level):
    return int(np.prod([s ** d for s, d in zip(hp["strides_t"][:level + 1],
                                                hp["downs_t"][:level + 1])]))


def build_program(cfg, device):
    """The program's VQ-VAE and prior runtime for the configuration, built
    by its factories from the presets that cfg["program"] names, after
    checking that the presets hold cfg["hparams"] and that the prior's
    parameters are the reference's layout."""
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    prog, hp = cfg["program"], cfg["hparams"]
    over = dict(prog.get("overrides", {}))
    merged = setup_hparams(f"{prog['vqvae']},{prog['prior']}", dict(over))
    for key, val in hp.items():
        got = merged.get(key)
        if isinstance(got, tuple):
            got = list(got)
        if got != val:
            raise ValueError(f"{cfg['name']}: the program's {key} is {got!r}, "
                             f"the configuration's {val!r}")
    vq_keys = ("levels", "downs_t", "strides_t", "l_bins", "emb_width",
               "width", "depth")
    vq_over = {k: v for k, v in over.items() if k in vq_keys}
    length = hp["n_ctx"] * raw_to_tokens(hp, hp["level"])
    vqvae = make_vqvae(setup_hparams(prog["vqvae"], dict(
        sample_length=length, seed=0, **vq_over)), device)
    pr_over = {k: v for k, v in over.items() if k not in vq_keys}
    runtime = make_prior(setup_hparams(prog["prior"], dict(seed=0, **pr_over)),
                         vqvae, device)
    want = dict(ref.layout(cfg))
    have = {n: tuple(p.shape) for n, p in runtime.model.named_parameters()}
    if have != {n: tuple(s) for n, s in want.items()}:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"{cfg['name']}: the prior's parameters differ from "
                         f"the reference's layout: {diff}")
    return vqvae, runtime


@torch.no_grad()
def load_weights(runtime, cfg, seed, device):
    """Draw the prior's weights from the seed and copy them in."""
    w = weights.draw(ref.layout(cfg), common.derive(seed, 1), device,
                     cfg["hparams"]["init_scale"])
    params = dict(runtime.model.named_parameters())
    for name, t in w.items():
        params[name].copy_(t)
    del w


class Driver:
    """One run's sampling traffic. setup(), then run_window() (and
    traced()), release(), check()."""

    def __init__(self, config, traffic, seed, device, quantize=None,
                 program=None):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.hp = config["hparams"]
        if not ref.is_top(self.hp):
            raise NotImplementedError("the sampling driver runs top priors")
        self.device = torch.device(device)
        self.quantize = quantize  # "int8": the program's int8 decode
        self.program = program
        self.windows, self.state, self.n_seg = [], None, 0
        self._keep = None

    # -- set-up ------------------------------------------------------------

    def setup(self):
        if self.program is None:
            self.program = build_program(self.cfg, self.device)
        self.vqvae, self.runtime = self.program
        self.model = self.runtime.model
        load_weights(self.runtime, self.cfg, self.seed, self.device)
        self._inputs()
        fp16 = self.tr["fp16"]
        self.dec, self.cache_int8 = None, False
        if fp16:
            self.runtime.release()
            _, self.cache_int8 = self.runtime.stage_decode(
                quantize=self.quantize)
            self.dec = self.runtime.staged
        self._keep_logits()
        self.gen = torch.Generator(device=self.device).manual_seed(
            common.derive(self.seed, 3))
        self._first_window()
        sync(self.device)

    def _inputs(self):
        hp, tr, dev = self.hp, self.tr, self.device
        gen = torch.Generator(device=dev).manual_seed(
            common.derive(self.seed, 2))
        B, n_ctx = tr["batch"], hp["n_ctx"]
        self.hop = int(tr["hop_fraction"] * n_ctx)
        self.ctx_len = n_ctx - self.hop

        def randint(hi, shape):
            return torch.randint(0, hi, shape, generator=gen, device=dev)
        self.track = randint(hp["l_bins"], (B, self.ctx_len))
        genre_bins, artist_bins = hp["y_bins"]
        g = hp["max_bow_genre_size"]
        lo, hi = tr["total_seconds"]
        total = (lo + (hi - lo) * torch.rand((B, 1), generator=gen,
                                             device=dev)) * hp["sr"]
        genres = randint(genre_bins, (B, g))
        n_genres = 1 + randint(g, (B, 1))
        genres = torch.where(torch.arange(g, device=dev)[None] < n_genres,
                             genres, torch.full_like(genres, -1))
        self.labels = torch.cat([total.long(), torch.zeros_like(total).long(),
                                 torch.zeros_like(total).long(),
                                 randint(artist_bins, (B, 1)), genres], dim=1)
        self.lyrics = (randint(hp["n_vocab"], (B, hp["n_tokens"]))
                       if hp.get("n_tokens") else None)
        rng = np.random.default_rng(common.derive(self.seed, 4))
        self.rows = sorted(rng.choice(B, min(tr["check_rows"], B),
                                      replace=False).tolist())

    def _keep_logits(self):
        """Keep the checked rows' logits of each step as the timed path
        hands them to the token sampler (while self._keep is a list)."""
        prior = self.model.prior
        sample_tok = type(prior)._sample_tok
        rows = torch.tensor(self.rows, device=self.device)

        def kept(logits, gen, temp, top_k, top_p):
            if self._keep is not None:
                self._keep.append(logits[rows, 0])
            return sample_tok(logits, gen, temp, top_k, top_p)
        prior._sample_tok = kept

    def _y(self, start):
        """The window's labels at level position `start`, as the program's
        get_y sets them: offset and sample length, then the lyrics."""
        hp = self.hp
        r = raw_to_tokens(hp, hp["level"])
        y = self.labels.clone()
        y[:, 1] = (self.tr["offset_tokens"] + start) * r
        y[:, 2] = hp["n_ctx"] * r
        return y if self.lyrics is None else torch.cat([y, self.lyrics], 1)

    def _first_window(self):
        """The first window's sample_init and a step at each temperature
        of the mix: every shape the window runs. The window goes on from
        these steps."""
        self._start_window()
        for temp in sorted(set(self.tr["temps"])):
            self._decode(1, temp)

    # -- the window ----------------------------------------------------------

    def _start_window(self):
        hp, tr, model = self.hp, self.tr, self.model
        start = len(self.windows) * self.hop
        z = self.track[:, start:start + self.ctx_len]
        y = self._y(start)
        fp16 = tr["fp16"]
        enc = (model.encoder_kv_from_y(y, fp16)
               if model.prime_prior is not None else None)
        caches, x_tok, x_cond, y_cond = model.sample_init(
            tr["batch"], z=z, z_conds=None, y=y, fp16=fp16,
            chunk_size=tr["chunk_size"], dec_params=self.dec, encoder_kv=enc,
            int8=self.cache_int8)
        t = model.sample_prefix_len(z)
        self.state = dict(caches=caches, x_tok=x_tok, x_cond=x_cond,
                          y_cond=y_cond, t=t, t_end=t + self.hop, z=z, y=y,
                          segs=[], index=len(self.windows))
        self.windows.append(self.state)

    def _finish_window(self):
        st = self.state
        toks = torch.cat([s[1] for s in st["segs"]], dim=1)
        codes = self.model.sample_finish(toks, z=st["z"])
        st["codes"] = codes
        self.track = torch.cat([self.track, codes[:, -self.hop:]], dim=1)
        st["caches"] = st["x_cond"] = st["y_cond"] = None
        self.state = None

    def _decode(self, n, temp):
        """n tokens of the open window at `temp`, recorded with the checked
        rows' logits where the window is one that the check compares."""
        st = self.state
        self._keep = [] if st["index"] < self.tr["check_windows"] else None
        toks, st["x_tok"] = self.model.sample_segment(
            st["caches"], st["x_tok"], st["t"], n, self.gen, st["x_cond"],
            st["y_cond"], fp16=self.tr["fp16"], temp=temp,
            dec_params=self.dec)
        st["segs"].append((st["t"], toks, temp, self._keep))
        self._keep = None
        st["t"] += n

    def _segment(self, spans):
        """The next segment (a window's sample_init first where one is
        due); returns its steps."""
        if self.state is not None and self.state["t"] >= self.state["t_end"]:
            self._finish_window()
        if self.state is None:
            s0 = common.now()
            self._start_window()
            sync(self.device)
            spans.add("init", s0, common.now())
        st, tr = self.state, self.tr
        n = min(tr["segment"], st["t_end"] - st["t"])
        temp = tr["temps"][self.n_seg % len(tr["temps"])]
        t, s0 = st["t"], common.now()
        self._decode(n, temp)
        sync(self.device)
        spans.add("segment", s0, common.now(), steps=n, batch=tr["batch"],
                  t=t)
        self.n_seg += 1
        return n

    def run_window(self, spans, seconds=None, segments=None):
        """Segments back to back until `seconds` have passed (or after
        `segments` segments); the run stops at a segment's end."""
        sync(self.device)
        t0 = common.now()
        steps = n = 0
        while True:
            steps += self._segment(spans)
            n += 1
            el = common.now() - t0
            if (seconds is not None and el >= seconds) or (
                    segments is not None and n >= segments):
                break
        return dict(seconds=common.now() - t0, steps=steps, segments=n,
                    tokens=steps * self.tr["batch"])

    def end_to_end(self, window):
        """None of its own: the window's rate swings with the host's speed
        (window_tokens_per_s.sample reads it)."""
        return {}

    def traced(self, profile, spans):
        """One more segment under `profile` (a window's sample_init that is
        due runs first, outside it); returns (trace, work). The window's
        `spans` keep only the window's segments."""
        if self.state is not None and self.state["t"] >= self.state["t_end"]:
            self._finish_window()
        if self.state is None:
            self._start_window()
        t, B = self.state["t"], self.tr["batch"]
        spans = common.Spans()
        trace = profile(lambda: self._segment(spans))
        n = spans.get("segment")[0][2]["steps"]
        work = [dict(kind="decode_step", batch=B, t=t + i) for i in range(n)]
        return trace, work

    def attempted(self):
        return self.tr["batch"] * len(self.windows)

    # -- after the window ----------------------------------------------------

    def release(self, keep_program=False):
        """Free the program's state: its caches, staged weights and (unless
        keep_program) the model."""
        for st in self.windows:
            st["caches"] = st["x_cond"] = st["y_cond"] = None
        self.state = None
        self.runtime.release()
        self.model.prior.__dict__.pop("_sample_tok", None)
        self.dec = None
        if not keep_program:
            self.program = None
        self.model = self.runtime = self.vqvae = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, control=None):
        """[(name, value)] over the checked rows of the first
        check_windows windows, against the reference's logits over each
        row's prompt and served tokens: tokens outside the vocabulary (and
        codes outside the level's bins); the gaps by which each greedy
        token's logit lies below the reference's best (their mean and the
        widest); and, at every served position, the logits the timed path
        produced against the reference's: the mean KL divergence of the
        reference's distribution from the program's (nats), the norm of
        their difference over the norm of the reference's, and the share
        of the change that int8 product weights (ref.int8_weights) make to
        the reference's logits that the program's difference carries (its
        projection on that change; logits centred). control: a dtype; the
        reference computed in that precision stands in the program's place
        (its logits, and the token it puts first)."""
        hp, tr = self.hp, self.tr
        L, bins, _ = ref.geometry(hp)
        bad = 0
        for st in self.windows:
            for _, toks, _, _ in st["segs"]:
                bad += int(((toks < 0) | (toks >= bins)).sum())
            if "codes" in st:
                c = st["codes"]
                bad += int(((c < 0) | (c >= hp["l_bins"])).sum())
        wins = self.windows[:tr["check_windows"]]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w = weights.draw(ref.layout(self.cfg), common.derive(self.seed, 1),
                         self.device, hp["init_scale"])
        w8 = ref.int8_weights(w)
        gaps, kl, err2, ref2, n_pos = [], 0.0, 0.0, 0.0, 0
        de = ee = 0.0

        def centred(x):
            return x - x.mean(-1, keepdim=True)
        try:
            for st in wins:
                served = torch.cat([s[1] for s in st["segs"]], dim=1)
                z = st["z"]
                if hp.get("single_enc_dec"):
                    prefix = torch.cat([self.lyrics, z + hp["n_vocab"]], 1)
                else:
                    prefix = z
                for i, r in enumerate(self.rows):
                    stream = torch.cat([prefix[r], served[r]])[None]
                    lg = ref.logits(w, self.cfg, stream, st["y"][r:r + 1])
                    lg8 = ref.logits(w8, self.cfg, stream, st["y"][r:r + 1])
                    low = (None if control is None else ref.logits(
                        w, self.cfg, stream, st["y"][r:r + 1], control))
                    for t, toks, temp, kept in st["segs"]:
                        pos = torch.arange(t, t + toks.shape[1],
                                           device=lg.device)
                        want = lg[0, pos]
                        got = (torch.stack([k[i] for k in kept]).float()
                               if low is None else low[0, pos])
                        logp = torch.log_softmax(want, -1)
                        kl += float((logp.exp() * (logp - torch.log_softmax(
                            got, -1))).sum())
                        d = centred(got) - centred(want)
                        e = centred(lg8[0, pos]) - centred(want)
                        err2 += float((d * d).sum())
                        ref2 += float((centred(want) ** 2).sum())
                        de += float((d * e).sum())
                        ee += float((e * e).sum())
                        n_pos += len(pos)
                        if temp != 0.0:
                            continue
                        tok = (toks[r].long() if low is None
                               else got.argmax(-1))
                        gaps.append(want.max(dim=-1).values
                                    - want.gather(1, tok[:, None])[:, 0])
                    del lg, lg8, low
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
            del w, w8
        g = torch.cat(gaps) if gaps else torch.zeros(0)
        self.compared = int(g.numel())
        flips = int((g > 0).sum())
        print(f"note: {self.compared} greedy tokens compared, {flips} not "
              f"the reference's best; logits at {n_pos} positions",
              file=sys.stderr)
        return [("out_of_range", bad),
                ("logit_gap_mean", float(g.mean()) if g.numel() else 0.0),
                ("logit_gap_max", float(g.max()) if g.numel() else 0.0),
                ("logit_kl", kl / max(n_pos, 1)),
                ("logit_err", (err2 / ref2) ** 0.5 if ref2 else 0.0),
                ("int8_share", de / ee if ee else 0.0)]
