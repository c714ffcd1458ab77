"""Training traffic: a top prior fine-tuned as upstream's README does
(jukebox_tpu_torch.train with --prior over a frozen VQ-VAE), one step after
another in train.train's order: the step of make_prior_train_step (encode,
forward, backward, the scaled and clipped Adam update), its metrics read
back, the EMA's step, the loss scaler's update. Every step's batch is new:
audio and labels drawn from the seed.

train.train itself is not driven: it runs the loader's epoch to
hps.max_steps and cannot stop at a time, and it samples a window at step 1;
this driver makes the same calls per step without the loader and logger.

Traffic parameters (traffic/<mix>.json):
  hps            the preset sets of the recipe
  batch          rows a step
  weight_decay   the recipe's --weight_decay
  check_steps    steps of set-up that the reference follows (the first)
  audio_std      std of the drawn audio (clipped to [-1, 1])
"""

import gc
import sys

import torch

from benchmark import common, weights
from benchmark.drivers.prior_windows import raw_to_tokens, sync
from benchmark.reference import prior as ref
from benchmark.reference import train as rtrain


def vq_hparams(hps):
    keys = ("levels", "downs_t", "strides_t", "emb_width", "width", "depth",
            "m_conv", "hvqvae_multipliers", "l_bins", "dilation_growth_rate",
            "dilation_cycle")
    return {k: (list(hps[k]) if isinstance(hps[k], tuple) else hps[k])
            for k in keys}


class Driver:
    def __init__(self, config, traffic, seed, device, half_batch=False):
        self.cfg, self.tr, self.seed = config, traffic, int(seed)
        self.hp = config["hparams"]
        self.device = torch.device(device)
        self.records, self.it = [], 0
        self.mark = None
        self.half_batch = half_batch
        self.length = self.hp["n_ctx"] * raw_to_tokens(self.hp,
                                                       self.hp["level"])

    # -- set-up ------------------------------------------------------------

    def setup(self):
        from jukebox_tpu_torch.models.make_models import (make_prior,
                                                          make_vqvae)
        from jukebox_tpu_torch.train import make_prior_train_step
        from jukebox_tpu_torch.utils.train_utils import (LossScalar,
                                                         adam_init, get_ema,
                                                         make_lr_schedule)
        hp, dev = self.hp, self.device
        hps = self.recipe()
        for key, val in hp.items():
            got = hps.get(key)
            if (list(got) if isinstance(got, tuple) else got) != val:
                raise ValueError(f"the recipe's {key} is {got!r}, the "
                                 f"configuration's {val!r}")
        # as train.setup: fp32 products at full precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.vqvae = make_vqvae(hps, dev)
        self.runtime = make_prior(hps, self.vqvae, dev)
        self._load_weights()
        self.lr_fn = make_lr_schedule(hps)
        self.opt = adam_init(self.runtime.params, fp16_state=hps.fp16_opt)
        self.ema = get_ema(self.runtime.params, hps)
        self.scalar = LossScalar(
            hps.fp16_loss_scale,
            scale_factor=2.0 ** (1.0 / hps.fp16_scale_window))
        self.step_fn = make_prior_train_step(self.runtime, hps, self.lr_fn,
                                             mark=self._on_mark)
        # the steps the reference follows, through the window's own call
        self.checked = []
        for i in range(self.tr["check_steps"]):
            rec = self._step()
            if i == 0:
                self.g1 = self._first_grads()
            self.checked.append(rec)
        self.changed = {n: p.detach().float().to("cpu", copy=True)
                        for n, p in self.runtime.params.items()}

    def recipe(self):
        """The recipe's hparams (the traffic's preset sets over the
        configuration's overrides), with the VQ-VAE's and Adam's settings
        kept for the reference."""
        from jukebox_tpu_torch.hparams import setup_hparams
        hp, tr = self.hp, self.tr
        over = dict(self.cfg["program"].get("overrides", {}))
        hps = setup_hparams(tr["hps"], dict(
            prior=True, train=True, levels=hp["levels"], level=hp["level"],
            labels=True, weight_decay=tr["weight_decay"], bs=tr["batch"],
            sample_length=self.length, save=False, seed=0, **over))
        self.hps = hps
        self.vq = vq_hparams(hps)
        self.opt_hps = dict(lr=hps.lr, lr_warmup=hps.lr_warmup,
                            beta1=hps.beta1, beta2=hps.beta2, eps=hps.eps,
                            clip=hps.clip, weight_decay=hps.weight_decay,
                            fp16_opt=bool(hps.fp16_opt))
        return hps

    def _layouts(self):
        return ref.layout(self.cfg), rtrain.encoder_layout(self.vq,
                                                           self.hp["level"])

    @torch.no_grad()
    def _load_weights(self):
        prior_l, enc_l = self._layouts()
        have = {n: tuple(p.shape) for n, p in
                self.runtime.model.named_parameters()}
        if have != {n: tuple(s) for n, s in prior_l}:
            raise ValueError("the prior's parameters differ from the "
                             "reference's layout")
        w = self._draw()
        params = dict(self.runtime.model.named_parameters())
        vq_state = dict(self.vqvae.named_parameters())
        vq_state.update(self.vqvae.named_buffers())
        for name, t in w.items():
            (params if name in params else vq_state)[name].copy_(t)

    def _draw(self):
        prior_l, enc_l = self._layouts()
        w = weights.draw(prior_l, common.derive(self.seed, 1), self.device,
                         self.hp["init_scale"])
        w.update(weights.draw(enc_l, common.derive(self.seed, 5),
                              self.device, 1.0))
        return w

    def _batch(self, it):
        """Step it's rows: audio [B, T, 1] and labels with lyrics."""
        hp, B, dev = self.hp, self.tr["batch"], self.device
        gen = torch.Generator(device=dev).manual_seed(
            common.derive(self.seed, 10, it))
        x = (torch.randn((B, self.length, 1), generator=gen, device=dev)
             * self.tr["audio_std"]).clamp_(-1.0, 1.0)
        genre_bins, artist_bins = hp["y_bins"]
        r = raw_to_tokens(hp, hp["level"])
        total = torch.randint(int(hp["min_duration"] * hp["sr"]) + self.length,
                              int(hp["max_duration"] * hp["sr"]), (B, 1),
                              generator=gen, device=dev)
        offset = torch.randint(0, 1 << 20, (B, 1), generator=gen,
                               device=dev) * r
        offset = torch.minimum(offset, total - self.length)
        y = torch.cat([total, offset, torch.full_like(total, self.length),
                       torch.randint(0, artist_bins, (B, 1), generator=gen,
                                     device=dev),
                       torch.randint(0, genre_bins,
                                     (B, hp["max_bow_genre_size"]),
                                     generator=gen, device=dev),
                       torch.randint(0, hp["n_vocab"], (B, hp["n_tokens"]),
                                     generator=gen, device=dev)], dim=1)
        return x, y

    def _on_mark(self, part):
        if self.mark is not None:
            self.mark(part)

    def _step(self):
        """One step in train.train's order; returns its record."""
        self.it += 1
        it = self.it
        x, y = self._batch(it)
        if self.half_batch:  # a planted fault: half the rows left out
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        scale = self.scalar.get_scale()
        loss, out = self.step_fn(self.opt, (x, y),
                                 self._seed(it), it, scale)
        out = {k: float(v) for k, v in out.items()}
        out["loss"] = float(loss)
        self.ema.step(self.runtime.params)
        self._on_mark("ema")
        self.scalar.update_scale(not bool(out["step_ok"]))
        rec = dict(it=it, loss=out["loss"], ok=bool(out["step_ok"]),
                   scale=scale)
        self.records.append(rec)
        return rec

    def _seed(self, it):
        return common.derive(self.seed, 11, it) & 0x7FFFFFFF

    def _first_grads(self):
        """The first step's gradient as the optimizer got it, from its
        first moment: m = (1 - beta1) g."""
        opt, b1 = self.opt, self.hps.beta1
        out = {}
        for n, m in opt["m"].items():
            m = m.float()
            if "m_scale" in opt:
                m = m * opt["m_scale"][n]
            out[n] = (m / (1.0 - b1)).to("cpu", copy=True)
        return out

    # -- the window ----------------------------------------------------------

    def run_window(self, spans, seconds=None, steps=None):
        sync(self.device)
        t0 = common.now()
        n = 0
        while True:
            s0 = common.now()
            self._step()
            sync(self.device)
            spans.add("step", s0, common.now())
            n += 1
            el = common.now() - t0
            if (seconds is not None and el >= seconds) or (
                    steps is not None and n >= steps):
                break
        el = common.now() - t0
        return dict(seconds=el, steps=n,
                    tokens=n * self.tr["batch"] * (self.hp["n_ctx"]
                                                   + self.hp["n_tokens"]))

    def end_to_end(self, window):
        return {"train_tokens_per_s": window["tokens"] / window["seconds"]}

    def traced(self, profile, spans):
        """A step timed by parts (each mark after a synchronise, added to
        `spans` as part.<name>), then a step under `profile`; returns
        (trace, work)."""
        last = [common.now()]

        def mark(part):
            sync(self.device)
            t = common.now()
            spans.add(f"part.{part}", last[0], t)
            last[0] = t
        self.mark = mark
        sync(self.device)
        last[0] = common.now()
        self._step()
        self.mark = None
        trace = profile(self._step)
        work = [dict(kind="train_step", batch=self.tr["batch"],
                     recompute=bool(self.hps.c_res),
                     fp16_moments=bool(self.hps.fp16_opt),
                     params=sum(p.numel() for p in
                                self.runtime.params.values()))]
        return trace, work

    def attempted(self):
        return len(self.records)

    # -- after the window ----------------------------------------------------

    def release(self):
        self.runtime = self.vqvae = self.step_fn = self.opt = None
        self.ema = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, lowp=None):
        """The reference over the checked steps from the drawn weights:
        (losses, first gradients, changes of the parameters), on the
        CPU. lowp: round every product's inputs to that dtype (the
        control)."""
        steps = self.tr["check_steps"]
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            w = self._draw()
            names = [n for n, _ in ref.layout(self.cfg)]
            p0 = {n: w[n].detach().to("cpu", copy=True) for n in names}
            state, losses = {"m": {}, "v": {}}, []
            for it in range(1, steps + 1):
                x, y = self._batch(it)
                with torch.no_grad():
                    z = rtrain.encode(w, self.vq, self.hp["level"], x)
                lo, g = rtrain.grads(w, names, self.cfg, z, y, lowp)
                rtrain.adam({n: w[n] for n in names}, g, state, it,
                            rtrain.lr_at(self.opt_hps, it), self.opt_hps)
                del g
                losses.append(lo)
            g1 = {n: t.to("cpu", copy=True) for n, t in state["g1"].items()}
            change = {n: w[n].detach().cpu() - p0[n] for n in names}
            return losses, g1, change, p0
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

    @staticmethod
    def _compare(losses, g1, change, ref_losses, ref_g1, ref_change):
        keep = rtrain.moving_parts(ref_g1)
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            ref_losses))
        grad_gap, _, at_g = rtrain.leaf_gaps(g1, ref_g1, keep)
        change_gap, n, at_c = rtrain.leaf_gaps(change, ref_change, keep)
        print(f"note: {n} of {len(ref_g1)} leaves compared; widest "
              f"gradient gap at {at_g}, change gap at {at_c}",
              file=sys.stderr)
        return loss_gap, grad_gap, change_gap, n

    def check(self):
        """[(name, value)]: each checked step's loss against the
        reference's (relative), the first gradient's and the checked
        steps' change's worst leaf (reference.train.leaf_gaps over the
        leaves the reference's first gradient moves), and the steps the
        program skipped."""
        losses, g1, change, p0 = self._reference()
        d_prog = {n: self.changed[n] - p0[n] for n in change}
        got = [r["loss"] for r in self.checked]
        loss_gap, grad_gap, change_gap, self.compared = self._compare(
            got, self.g1, d_prog, losses, g1, change)
        skipped = sum(1 for r in self.checked if not r["ok"])
        return [("loss_gap", loss_gap), ("grad_gap", grad_gap),
                ("change_gap", change_gap), ("skipped_steps", skipped)]

    def control_check(self, lowp=torch.float8_e4m3fn):
        """The control's numbers: the reference with every product's
        inputs in `lowp` in the program's place."""
        ref_out = self._reference()[:3]
        low = self._reference(lowp)[:3]
        loss_gap, grad_gap, change_gap, self.compared = self._compare(
            *low, *ref_out)
        return [("loss_gap", loss_gap), ("grad_gap", grad_gap),
                ("change_gap", change_gap), ("skipped_steps", 0)]
