"""Traffic driver ``train_epochs``: the Trainer's train epochs, fed from a
full decode cache.

Set-up finds or writes the dataset (``classes`` x ``per_class`` colour-cell
PNGs at the configuration's input size, from the seed; :func:`benchmark.
data.seeded_dataset`), builds the program's ``Trainer`` from the
configuration, loads weights drawn from the seed, fills the Trainer's
``DecodeCache`` with every training image through the program's own
``BatchLoader``, and runs one short train epoch of ``setup_steps`` steps
(``Trainer._run_train_epoch``, as ``Trainer.fit`` runs each epoch, with the
epoch's own sampler seed). Its first ``recorded_steps`` steps take draws that the
benchmark makes (augmentation and drop-connect) and are recorded: their
batches, losses, the optimizer's first moments after step 1 and the
parameters before the next step, which the plain reference then follows
(:func:`compare`). The same Trainer then runs the measured window: as many
whole epochs as begin before ``--seconds`` runs out.

With ``--trace 1`` two :class:`~benchmark.trace.StretchProfiler` cover
``profile.units`` steps every ``profile.every`` in the window, for
``profile.reads`` stretches each: one traces the host and the card from the
``profile.start``-th step (ranges, launches, breakdown), the other the card
alone from the ``profile.device_start``-th (busy and idle time).
"""

from __future__ import annotations

import copy
import gc
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import data, flops, harness
from benchmark.reference import augment as ref_augment
from benchmark.reference import models
from benchmark.reference import triplet

FAULTS = ("unchanged", "half")


class _Chunks:
    """A sampler over every training path, ``size`` at a time."""

    def __init__(self, paths, size):
        self.paths, self.size = paths, size

    def __iter__(self):
        for lo in range(0, len(self.paths), self.size):
            chunk = self.paths[lo:lo + self.size]
            yield chunk, np.zeros(len(chunk), np.int64)


def _host(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x.detach().cpu().clone()


def _to(x, device):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to(v, device) for v in x]
    return x.to(device)


class Recorder:
    """Stands in for ``Trainer.train_step`` over the first steps: hands the
    program the benchmark's draws and keeps what the reference needs.
    ``fault`` plants a fault in the program's steps (for the harness's own
    tests and the control measurements): ``unchanged`` returns the state
    without a step, ``half`` steps on the first half of the batch."""

    def __init__(self, step, n, generator, preset, keeps, fault=None):
        self.step, self.n, self.gen = step, n, generator
        self.preset, self.keeps, self.fault = preset, keeps, fault
        self.count = 0
        self.batches: List[tuple] = []
        self.losses: List[float] = []
        self.pos_dists: List[float] = []
        self.first_moments: Optional[Dict] = None
        self.params_after: Optional[Dict] = None
        self.first_bn_vars: Optional[Dict] = None

    def __call__(self, state, images, labels):
        import torch
        i = self.count
        self.count += 1
        if i == self.n:
            self.params_after = {k: _host(p) for k, p in
                                 state.module.named_parameters()}
        if i >= self.n:
            return self.step(state, images, labels)
        device = images.device
        b = images.shape[0]
        draws = (ref_augment.sample(self.preset, images.shape, self.gen,
                                    device) if self.preset else None)
        masks = [torch.rand(b, generator=self.gen, device=device) < keep
                 for keep in self.keeps]
        self.batches.append((_host(images), _host(labels), _host(draws),
                             _host(masks)))
        kw = {}
        if self.fault == "half":
            h = b // 2
            images, labels = images[:h], labels[:h]
            draws = None if draws is None else [
                {k: v[:h] for k, v in d.items()} for d in draws]
            masks = [m[:h] for m in masks]
        if draws is not None:
            kw["aug_draws"] = draws
        if masks:
            kw["drop_draws"] = masks
        if self.fault == "unchanged":
            zero = torch.zeros((), device=device)
            metrics = {k: zero for k in ("loss", "n_triplets", "frac_mined",
                                         "mean_pos_dist", "mean_neg_dist")}
        else:
            state, metrics = self.step(state, images, labels, **kw)
        self.losses.append(float(metrics["loss"]))
        self.pos_dists.append(float(metrics["mean_pos_dist"]))
        if i == 0:
            self.first_bn_vars = {
                k[:-len(".running_var")]: _host(v)
                for k, v in state.module.named_buffers()
                if k.endswith(".running_var")}
            moments = {}
            for name, p in state.module.named_parameters():
                st = state.optimizer.state.get(p, {})
                moments[name] = (_host(st["exp_avg"]) if "exp_avg" in st
                                 else torch.zeros_like(p, device="cpu"))
            self.first_moments = moments
        return state, metrics


class Profiled:
    """Stands in for ``Trainer.train_step`` in a traced window."""

    def __init__(self, step, profilers):
        self.step, self.profilers = step, profilers

    def __call__(self, state, images, labels):
        for p in self.profilers:
            p.begin()
        out = self.step(state, images, labels)
        for p in self.profilers:
            p.end()
        return out


def _drop_keeps(backbone: str) -> List[float]:
    if backbone not in models.EFFNET_SCALING:
        return []
    return [1.0 - rate for _, cin, cout, _, _, s, rate in
            models.effnet_blocks(backbone)
            if s == 1 and cin == cout and rate > 0]


class Run:
    """One run's set-up, window and comparison (see the module
    docstring)."""

    def __init__(self, cell, seed: int, device: str,
                 fault: Optional[str] = None):
        import torch
        from embeddingnet_tpu_torch.config import params_from_dict
        from embeddingnet_tpu_torch.data.index import ENDataLoader
        from embeddingnet_tpu_torch.data.pipeline import BatchLoader
        from embeddingnet_tpu_torch.train.loop import Trainer

        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.device = torch.device(device)
        p = cell.traffic["params"]
        self.p = p
        cfg = copy.deepcopy(cell.config["config"])
        self.cfg = cfg
        self.tmp = tempfile.mkdtemp(prefix="embn-bench-")
        cfg["GENERAL"]["seed"] = harness.derive_seed(seed, "trainer") % 2 ** 31
        cfg["GENERAL"]["work_dir"] = os.path.join(self.tmp, "work")
        m = cfg["MODEL"]
        self.backbone, self.enc_len = m["backbone_name"], m["encodings_len"]
        size = m["input_shape"][0]

        self.phases = {}
        t = time.perf_counter()
        cfg["DATALOADER"]["dataset_path"] = data.seeded_dataset(
            harness.derive_seed(seed, "images"), p["classes"],
            p["per_class"], size)
        params = params_from_dict(cfg)
        dl = ENDataLoader(cfg["DATALOADER"]["dataset_path"],
                          validate=cfg["DATALOADER"]["validate"],
                          val_ratio=cfg["DATALOADER"]["val_ratio"],
                          cache_index=False)
        t = self._phase("dataset", t)
        self.trainer = Trainer(params, dl, device=device,
                               log_fn=lambda *a, **k: None)
        self.weights_seed = harness.derive_seed(seed, "weights")
        self.trainer.module.load_state_dict(models.make_weights(
            self.backbone, self.enc_len, self.weights_seed, self.device))

        t = self._phase("trainer and weights", t)
        # every training image into the Trainer's decode cache, by the
        # program's own loader
        paths = [q for c in dl.class_names for q in dl.train_data[c]]
        for _ in BatchLoader(_Chunks(paths, 1024), m["input_shape"],
                             cache=self.trainer._decode_cache):
            pass
        self._phase("cache fill", t)
        gen = torch.Generator(device=self.device).manual_seed(
            harness.derive_seed(seed, "draws"))
        g = cfg["GENERATOR"]
        self.batch = g["k_classes"] * g["k_samples"]
        self.recorder = Recorder(self.trainer.train_step,
                                 p["recorded_steps"], gen,
                                 g.get("augmentations") or None,
                                 _drop_keeps(self.backbone), fault)
        self.epoch = 0

    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    def epoch_run(self) -> dict:
        self.trainer._current_epoch = self.epoch
        self.epoch += 1
        t0 = time.perf_counter()
        out = self.trainer._run_train_epoch()
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "data_wait_s": self.trainer._data_wait_s,
                "steps": self.cfg["GENERATOR"]["n_batches"],
                "images": self.cfg["GENERATOR"]["n_batches"] * self.batch,
                "loss": out.get("loss", float("nan")),
                "finite": bool(np.isfinite(out.get("loss", np.nan)))}

    def warm(self) -> None:
        """The set-up epoch: a short one of ``setup_steps`` steps, whose
        first steps are the recorded ones."""
        self.trainer.train_step = self.recorder
        gen = self.trainer.params.generator
        t = time.perf_counter()
        gen.n_batches = self.p["setup_steps"]
        try:
            self.epoch_run()
        finally:
            gen.n_batches = self.cfg["GENERATOR"]["n_batches"]
        self._phase("set-up epoch", t)
        self.trainer.train_step = self.recorder.step
        if self.recorder.params_after is None:
            raise RuntimeError("the set-up epoch ran fewer steps than the "
                               "recorded ones and the one after")

    def window(self, seconds: float, profilers=()) -> dict:
        step = self.trainer.train_step
        if profilers:
            self.trainer.train_step = Profiled(step, profilers)
        epochs = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            reads = [len(p.raw) for p in profilers]
            e = self.epoch_run()
            e["profiled"] = any(len(p.raw) != n or p._prof is not None
                                for p, n in zip(profilers, reads))
            epochs.append(e)
        window_s = time.perf_counter() - t0
        self.trainer.train_step = step
        return {"window_s": window_s, "epochs": epochs,
                "images": sum(e["images"] for e in epochs),
                "steps": sum(e["steps"] for e in epochs)}

    def program_readings(self) -> dict:
        r = self.recorder
        # Flax's running average from a start of 1: ra = m + (1 - m) var
        m = self.cfg["PERFORMANCE"]["bn_momentum"]
        return {"losses": r.losses, "pos_dists": r.pos_dists,
                "bn_vars": {k: (v - m) / (1 - m)
                            for k, v in r.first_bn_vars.items()},
                "first_grads": {
            k: v / (1 - triplet.B1) for k, v in r.first_moments.items()},
            "params": r.params_after}

    def release(self) -> None:
        """Drop the program's state (the reference runs after it)."""
        import torch
        self.trainer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference_readings(self, quant=None) -> dict:
        """The plain reference over the recorded steps, from the same
        weights, batches and draws."""
        import torch
        w0 = models.make_weights(self.backbone, self.enc_len,
                                 self.weights_seed, self.device)
        ref = triplet.Steps(self.cfg, w0, quant=quant, remat=True)
        for images, labels, draws, masks in self.recorder.batches:
            ref.step(images.to(self.device), labels.to(self.device),
                     _to(draws, self.device),
                     _to(masks, self.device))
        out = {"losses": list(ref.losses), "pos_dists": list(ref.pos_dists),
               "bn_vars": {k: v.cpu() for k, v in ref.first_bn_vars.items()},
               "first_grads": {k: v.cpu() for k, v in
                               ref.first_grads.items()},
               "params": {k: v.cpu() for k, v in ref.parameters().items()}}
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def initial_params(self) -> dict:
        w0 = models.make_weights(self.backbone, self.enc_len,
                                 self.weights_seed, self.device)
        return {k: w0[k].cpu() for k in
                models.parameter_names(self.backbone, self.enc_len)}

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def compare(prog: dict, ref: dict, w0: dict) -> Dict[str, float]:
    """The numbers that decide ``correct`` (a cell's limits file picks
    those it holds to a limit):

    * ``loss1_gap``, ``loss_gap``: the relative gap of the first recorded
      step's loss, and the largest over the recorded steps;
    * ``grad_gap``: the first step's gradient, as the optimizer got it, by
      the worst leaf: the gap between the program's and the reference's
      norm of the leaf, over the reference's norm of that leaf or of the
      median leaf, whichever is larger;
    * ``pos_dist1_gap``: the relative gap of the first step's mean distance
      between two embeddings of one class (the forward alone: the same
      weights, batch and draws on both sides);
    * ``bn_var1_gap_median``: every BatchNorm's batch variance in the
      first step's forward (the program's from its running variance after
      the step), the relative L2 gap of each layer's, the median layer's;
    * ``grad_gap_median``: the same gap of the median leaf;
    * ``change_gap``, ``change_gap_median``: the same for the parameters'
      change over the recorded steps.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's (zero to rounding: the classifier that the loss never reaches)
    are left out of the gaps."""
    import torch

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    names = list(ref["first_grads"])
    g_ref = {n: norm(ref["first_grads"][n]) for n in names}
    med_g = statistics.median(g_ref.values())
    kept = [n for n in names if g_ref[n] >= 1e-3 * med_g]
    grads = [abs(norm(prog["first_grads"][n]) - g_ref[n])
             / max(g_ref[n], med_g) for n in kept]
    d_ref = {n: norm(ref["params"][n] - w0[n]) for n in kept}
    med_d = statistics.median(d_ref.values())
    change = [abs(norm(prog["params"][n] - w0[n]) - d_ref[n])
              / max(d_ref[n], med_d) for n in kept]
    losses = [abs(a - b) / abs(b)
              for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses = [float("inf")]
    pos = abs(prog["pos_dists"][0] - ref["pos_dists"][0]) / ref["pos_dists"][0]
    bn = [norm(prog["bn_vars"][k] - v) / norm(v)
          for k, v in ref["bn_vars"].items()]
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "pos_dist1_gap": pos, "bn_var1_gap_median": statistics.median(bn),
            "grad_gap": max(grads),
            "grad_gap_median": statistics.median(grads),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: Optional[str] = None) -> dict:
    import torch
    from embeddingnet_tpu_torch.ops import fused_conv, preprocess

    r = Run(cell, seed, device, fault)
    try:
        r.warm()
        setup_s = time.perf_counter() - t_start
        profilers = []
        if trace:
            from benchmark.trace import StretchProfiler
            pp = r.p["profile"]
            profilers = [
                StretchProfiler(cell.name, pp["units"], pp["start"],
                                pp["every"], pp["reads"],
                                counters=lambda: {**fused_conv.LAUNCHES,
                                                  **preprocess.LAUNCHES}),
                StretchProfiler(cell.name, pp["units"], pp["device_start"],
                                pp["every"], pp["reads"], device_only=True)]
        win = r.window(seconds, profilers)
        cuda = torch.cuda.is_available() and r.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(r.device) if cuda else 0
        prog = r.program_readings()
        r.release()
        numbers = compare(prog, r.reference_readings(), r.initial_params())
    finally:
        r.close()
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 r.phases.items()), file=sys.stderr)
    print("window epochs, wall/data wait (s): " + " ".join(
        f"{e['wall_s']:.4f}/{e['data_wait_s']:.4f}" for e in win["epochs"]),
        file=sys.stderr)
    size = r.cfg["MODEL"]["input_shape"][0]
    rec = {"kind": "train", "setup_s": setup_s, **win,
           "batch": r.batch, "backbone": r.backbone,
           "flops_per_image": flops.train_flops(r.backbone, size, r.enc_len),
           "conv3x3_launches": (flops.resnet50_conv3x3_launches(r.batch, size)
                                if r.backbone == "resnet50"
                                and r.cfg["PERFORMANCE"].get("pallas_conv")
                                else []),
           "profile": profilers[0].result() if profilers else None,
           "profile_device": profilers[1].result() if profilers else None}
    if profilers:
        print("device idle: card-only trace {:.4f} %, with the host traced "
              "{:.4f} %".format(*(100 * (1 - p["busy_s"] / p["wall_s"])
                                  for p in (rec["profile_device"],
                                            rec["profile"]))),
              file=sys.stderr)
    bad = sum(e["steps"] for e in win["epochs"] if not e["finite"])
    return {"rec": rec, "peak_bytes": peak, "attempted": win["steps"],
            "failed": bad,
            "checks": harness.check_numbers(numbers, cell.limits["limits"]),
            "numbers": numbers}
