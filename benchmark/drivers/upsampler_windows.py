"""Sampling traffic at an upsampler's level: windows hopped as
jukebox_tpu_torch.sample.sample_level hops them below the top, each
conditioned on the codes of the level above (n_ctx / cond_downsample of
them, the slice models/prior.py get_z_conds takes), through the calls
PriorRuntime.sample makes in its order (stage_decode once; per window
sample_init, which runs the conditioner, makes the caches and prefills the
window's context, then sample_segment in segments and sample_finish).
Set-up starts the first window part-way, as if `drawn` of its new codes
had been sampled already, and warms a step at each temperature on it; the
measured window decodes the rest of that window, then starts the next
(its conditioner and its prefill) and decodes on.

Traffic parameters (traffic/<mix>.json): those of prior_windows (the
labels' offset_tokens and total_seconds, batch, hop_fraction, segment,
chunk_size, temps, fp16, check_rows, check_windows), and
  drawn     new codes of the first window drawn from the seed with its
            context: the first window decodes from n_ctx - hop + drawn
  windows   windows whose codes of the level above are drawn; a run that
            reaches past them stops with an error

The check keeps the checked rows' logits as the timed path hands them to
the token sampler and compares them with the reference's
(reference/upsampler.py) at every served position, by the numbers
prior_windows compares.

    python3 -m benchmark.drivers.upsampler_windows --workload <cell> \
        --fault x_cond_late --seeds 1,2,3 --segments 6

reads a planted fault's numbers over seeds, as benchmark.calibrate reads
the controls (one JSON line a seed): FAULTS names them.
"""

import argparse
import json
import sys
import time

import torch

from benchmark import common, harness, weights
from benchmark.drivers import prior_windows as pw
from benchmark.reference import prior as rprior
from benchmark.reference import upsampler as ref

# faults the driver can plant in the program (the controls of a cell's
# limits): the conditioner's output one position late, its LayerNorm left
# out; the token loop fed each step the token sampled a step before the
# one it serves (the served stream itself unchanged)
FAULTS = ("x_cond_late", "x_cond_no_ln", "tok_late")


def build_program(cfg, device):
    """The program's VQ-VAE and prior runtime for the configuration, built
    by its factories from the presets that cfg["program"] names, after
    checking that the presets hold cfg["hparams"] and that the prior's
    parameters are the upsampler reference's layout (prior_windows'
    build_program, against reference/upsampler.py)."""
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
    length = hp["n_ctx"] * pw.raw_to_tokens(hp, hp["level"])
    vqvae = make_vqvae(setup_hparams(prog["vqvae"], dict(
        sample_length=length, seed=0, **vq_over)), device)
    pr_over = {k: v for k, v in over.items() if k not in vq_keys}
    runtime = make_prior(setup_hparams(prog["prior"], dict(seed=0, **pr_over)),
                         vqvae, device)
    want = {n: tuple(s) for n, s in ref.layout(cfg)}
    have = {n: tuple(p.shape) for n, p in runtime.model.named_parameters()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:6]
        raise ValueError(f"{cfg['name']}: the prior's parameters differ from "
                         f"the reference's layout: {diff}")
    return vqvae, runtime


@torch.no_grad()
def load_weights(runtime, cfg, seed, device):
    """Draw the upsampler's weights from the seed and copy them in."""
    w = weights.draw(ref.layout(cfg), common.derive(seed, 1), device,
                     cfg["hparams"]["init_scale"])
    params = dict(runtime.model.named_parameters())
    for name, t in w.items():
        params[name].copy_(t)
    del w


def cond_downsample(hp):
    """Codes of this level per code of the level above."""
    up = hp["level"] + 1
    return hp["strides_t"][up] ** hp["downs_t"][up]


class Driver(pw.Driver):
    """One run's sampling traffic at an upsampler's level: setup(), then
    run_window() (and traced()), release(), check(). quantize="int8": the
    program's int8 decode (a control); fault: one of FAULTS planted in the
    program (a control)."""

    def __init__(self, config, traffic, seed, device, quantize=None,
                 program=None, fault=None):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.hp = config["hparams"]
        if rprior.is_top(self.hp):
            raise ValueError("a top prior samples through prior_windows")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"no planted fault {fault!r}; FAULTS: {FAULTS}")
        self.device = torch.device(device)
        self.quantize, self.program, self.fault = quantize, program, fault
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
        self.dec, self.cache_int8 = None, False
        if self.tr["fp16"]:
            self.runtime.release()
            _, self.cache_int8 = self.runtime.stage_decode(
                quantize=self.quantize)
            self.dec = self.runtime.staged
        self._keep_logits()
        self._plant()
        self.gen = torch.Generator(device=self.device).manual_seed(
            common.derive(self.seed, 3))
        self._first_window()
        pw.sync(self.device)

    def _inputs(self):
        """prior_windows' labels and checked rows (its context codes are
        the first window's context), then from a stream of their own the
        first window's `drawn` codes and the codes of the level above."""
        super()._inputs()
        hp, tr, dev = self.hp, self.tr, self.device
        gen = torch.Generator(device=dev).manual_seed(
            common.derive(self.seed, 5))
        B, n_ctx = tr["batch"], hp["n_ctx"]
        self.down = cond_downsample(hp)
        drawn = torch.randint(0, hp["l_bins"], (B, tr["drawn"]),
                              generator=gen, device=dev)
        self.track = torch.cat([self.track, drawn], dim=1)
        n_up = (n_ctx + self.hop * (tr["windows"] - 1)) // self.down
        self.z_up = torch.randint(0, hp["l_bins"], (B, n_up), generator=gen,
                                  device=dev)

    def _plant(self):
        """Plant self.fault in the program (undone by release)."""
        if self.fault is None:
            return
        cond = self.model.conditioner_blocks[0]
        if self.fault == "tok_late":
            prior = self.model.prior
            emb_at = type(prior)._emb_at.__get__(prior)
            fed = []

            def late(t, x_tok, x_cond, y_cond, n):
                prev = fed[0] if fed else x_tok
                fed[:] = [x_tok]
                return emb_at(t, prev, x_cond, y_cond, n)
            prior._emb_at = late
        elif self.fault == "x_cond_late":
            forward = type(cond).forward.__get__(cond)

            def late(x):
                h = forward(x)
                return torch.cat([h[:, :1], h[:, :-1]], dim=1)
            cond.forward = late
        else:
            cond.ln.forward = lambda x, plain=False: x

    # -- the window ----------------------------------------------------------

    def _start_window(self):
        """sample_init of the next window at level position index x hop:
        its context is every code the track holds from there, its codes
        of the level above the n_ctx / cond_downsample from start /
        cond_downsample."""
        hp, tr = self.hp, self.tr
        index = len(self.windows)
        start = index * self.hop
        up0, n_up = start // self.down, hp["n_ctx"] // self.down
        if up0 + n_up > self.z_up.shape[1]:
            raise RuntimeError(f"window {index} needs codes of the level "
                               f"above past the {tr['windows']} windows drawn")
        z = self.track[:, start:]
        z_up = self.z_up[:, up0:up0 + n_up]
        y = self._y(start)
        caches, x_tok, x_cond, y_cond = self.model.sample_init(
            tr["batch"], z=z, z_conds=[z_up], y=y, fp16=tr["fp16"],
            chunk_size=tr["chunk_size"], dec_params=self.dec,
            int8=self.cache_int8)
        t = self.model.sample_prefix_len(z)
        self.state = dict(caches=caches, x_tok=x_tok, x_cond=x_cond,
                          y_cond=y_cond, t=t, t_end=hp["n_ctx"], z=z,
                          z_up=z_up, y=y, segs=[], index=index)
        self.windows.append(self.state)

    def _finish_window(self):
        st = self.state
        toks = torch.cat([s[1] for s in st["segs"]], dim=1)
        st["codes"] = self.model.sample_finish(toks, z=st["z"])
        self.track = torch.cat([self.track, toks.to(self.track.dtype)],
                               dim=1)
        st["caches"] = st["x_cond"] = st["y_cond"] = None
        self.state = None

    def traced(self, profile, spans):
        """prior_windows' traced segment, after the open window's
        conditioner has run once more under a profile of its own: the
        seconds of its device operations go into the window's `spans` as
        x_cond (x_cond_s.up0 reads them)."""
        st = self.state or self.windows[-1]
        t0 = common.now()
        with torch.no_grad():
            tr = profile(lambda: self.model.get_cond([st["z_up"]], st["y"]))
        spans.add("x_cond", t0, common.now(), device_s=tr.busy_s)
        return super().traced(profile, spans)

    # -- after the window ----------------------------------------------------

    def release(self, keep_program=False):
        if self.fault is not None and self.model is not None:
            cond = self.model.conditioner_blocks[0]
            cond.__dict__.pop("forward", None)
            cond.ln.__dict__.pop("forward", None)
            self.model.prior.__dict__.pop("_emb_at", None)
        super().release(keep_program)

    @torch.no_grad()
    def check(self, control=None):
        """[(name, value)] as prior_windows' check names them, over the
        checked rows of the first check_windows windows, against the
        upsampler reference's logits over each row's context and served
        codes, conditioned on the window's codes of the level above and
        its labels (the reference's conditioner runs once a row, and its
        x conditioning feeds the three forwards). control: a dtype; the
        reference with the transformer's products in that precision stands
        in the program's place (its logits, and the token it puts first)."""
        hp, tr = self.hp, self.tr
        bins = hp["l_bins"]
        n_labels = 4 + hp["max_bow_genre_size"]
        bad = 0
        for st in self.windows:
            for _, toks, _, _ in st["segs"]:
                bad += int(((toks < 0) | (toks >= bins)).sum())
            if "codes" in st:
                c = st["codes"]
                bad += int(((c < 0) | (c >= bins)).sum())
        wins = self.windows[:tr["check_windows"]]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        w = weights.draw(ref.layout(self.cfg), common.derive(self.seed, 1),
                         self.device, hp["init_scale"])
        w8 = rprior.int8_weights(w)
        gaps, greedy, kl, err2, ref2, n_pos = [], [], 0.0, 0.0, 0.0, 0
        sampled = []
        de = ee = 0.0

        def centred(x):
            return x - x.mean(-1, keepdim=True)
        try:
            for st in wins:
                served = torch.cat([s[1] for s in st["segs"]], dim=1)
                for i, r in enumerate(self.rows):
                    stream = torch.cat([st["z"][r], served[r]])[None]
                    z_up = st["z_up"][r:r + 1]
                    y = st["y"][r:r + 1, :n_labels]
                    cond = ref.x_cond(w, self.cfg, z_up)
                    lg = ref.logits(w, self.cfg, stream, z_up, y, cond=cond)
                    lg8 = ref.logits(w8, self.cfg, stream, z_up, y, cond=cond)
                    low = (None if control is None else ref.logits(
                        w, self.cfg, stream, z_up, y, control, cond=cond))
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
                            sampled.append(toks[r].long())
                            continue
                        tok = (toks[r].long() if low is None
                               else got.argmax(-1))
                        gaps.append(want.max(dim=-1).values
                                    - want.gather(1, tok[:, None])[:, 0])
                        greedy.append(tok)
                    del lg, lg8, low, cond
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
            del w, w8
        g = torch.cat(gaps) if gaps else torch.zeros(0)
        self.compared = int(g.numel())
        flips = int((g > 0).sum())

        def distinct(toks):
            return int(torch.unique(torch.cat(toks)).numel()) if toks else 0
        n_sampled = sum(int(t.numel()) for t in sampled)
        print(f"note: {self.compared} greedy tokens compared "
              f"({distinct(greedy)} distinct), {flips} not the reference's "
              f"best; {n_sampled} sampled at temp > 0 "
              f"({distinct(sampled)} distinct); logits at {n_pos} positions; "
              f"{len(self.windows)} windows started", file=sys.stderr)
        return [("out_of_range", bad),
                ("logit_gap_mean", float(g.mean()) if g.numel() else 0.0),
                ("logit_gap_max", float(g.max()) if g.numel() else 0.0),
                ("logit_kl", kl / max(n_pos, 1)),
                ("logit_err", (err2 / ref2) ** 0.5 if ref2 else 0.0),
                ("int8_share", de / ee if ee else 0.0)]


def fault_readings(cell_name, seeds, fault, segments, device="cuda",
                   base=common.BENCH_DIR, bench=None, program=None):
    """[(seed, {check: value}, greedy tokens compared, seconds)] of a
    planted fault over `seeds`, as benchmark.calibrate's readings, and the
    program built (reused by the next call)."""
    bench = bench or common.load_json(common.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, cell_name, base)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = Driver(cfg, traffic, seed, torch.device(device),
                     program=program, fault=fault)
        drv.setup()
        program = drv.program
        drv.run_window(common.Spans(), segments=segments)
        drv.release(keep_program=True)
        checks = dict(drv.check())
        out.append((seed, checks, drv.compared, time.perf_counter() - t0))
    return out, program


def main(argv=None):
    p = argparse.ArgumentParser(description="a planted fault's numbers")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=FAULTS)
    p.add_argument("--seeds", required=True)
    p.add_argument("--segments", type=int, default=6)
    a = p.parse_args(argv)
    res, _ = fault_readings(a.workload, [int(s) for s in a.seeds.split(",")],
                            a.fault, a.segments)
    for seed, checks, n, sec in res:
        print(json.dumps(dict(workload=a.workload, seed=seed, mode=a.fault,
                              checks=checks, compared=n, seconds=sec)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
