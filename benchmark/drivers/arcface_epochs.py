"""Traffic driver ``arcface_epochs``: the Trainer's ArcFace train epochs,
fed from a full decode cache.

The set-up and the window are :mod:`benchmark.drivers.train_epochs`'s: the
seeded dataset, the program's ``Trainer`` from the configuration (here in
``arcface`` mode: a ViT under ``ArcFaceModule``, uniform batches from
``SimpleSampler``), weights drawn from the seed (:func:`benchmark.
reference.vit_arcface.make_weights`), the ``DecodeCache`` filled by the
program's ``BatchLoader``, a set-up epoch of ``setup_steps`` steps, then as
many whole epochs as begin before ``--seconds`` runs out.

The set-up epoch's first ``recorded_steps`` steps take flip draws that the
benchmark makes and are recorded: their batches and draws, their losses,
the module's forward on the first batch as the step preprocesses it (run
before the first step, without gradients), Adam's first moments after step
1 and the parameters before the next step. After the window the plain
reference (:class:`benchmark.reference.vit_arcface.Steps`) follows them
from the same weights, and :func:`compare` gives the numbers that decide
``correct``.

With ``--trace 1`` two :class:`~benchmark.trace.StretchProfiler` cover the
window as in ``train_epochs``; the host-traced reads are summarised with
the ranges ``augment``, ``attn``, ``ln``, ``mlp`` and ``arcface``, and keep
the rise of ``vit.LAUNCHES`` beside the conv and preprocessing counters.
The program must have that counter: a tree without it exits before any
work.
"""

from __future__ import annotations

import copy
import os
import statistics
import sys
import tempfile
import time
from collections import Counter
from typing import Dict, List, Optional

from benchmark import data, harness, vit_flops
from benchmark.drivers import train_epochs as te
from benchmark.reference import triplet
from benchmark.reference import vit_arcface as ref_vit
from benchmark.trace import StretchProfiler, settled, summarize

RANGES = ("augment", "attn", "ln", "mlp", "arcface")
FAULTS = te.FAULTS


class Recorder:
    """Stands in for ``Trainer.train_step`` over the first steps: hands the
    program the benchmark's flip draws and keeps what the reference needs.
    ``fault`` plants a fault in the program's steps: ``unchanged`` returns
    the state without a step, ``half`` steps on the first half of the
    batch."""

    def __init__(self, step, n, generator, flip, compute_dtype, augment_fn,
                 fault=None):
        self.step, self.n, self.gen, self.flip = step, n, generator, flip
        self.compute_dtype, self.augment_fn = compute_dtype, augment_fn
        self.fault = fault
        self.count = 0
        self.batches: List[tuple] = []
        self.losses: List[float] = []
        self.first_embeddings = None
        self.first_moments: Optional[Dict] = None
        self.params_after: Optional[Dict] = None

    def __call__(self, state, images, labels):
        import torch
        from embeddingnet_tpu_torch.train import steps
        i = self.count
        self.count += 1
        if i == self.n:
            self.params_after = {k: te._host(p) for k, p in
                                 state.module.named_parameters()}
        if i >= self.n:
            return self.step(state, images, labels)
        b = images.shape[0]
        draws = (ref_vit.sample_flip(b, self.gen, images.device)
                 if self.flip else None)
        self.batches.append((te._host(images), te._host(labels),
                             te._host(draws)))
        if i == 0:
            with torch.no_grad():
                x = steps._preprocess(images, self.compute_dtype,
                                      self.augment_fn, None, draws)
                self.first_embeddings = te._host(state.module(x)[0].float())
        if self.fault == "half":
            h = b // 2
            images, labels = images[:h], labels[:h]
            draws = None if draws is None else [
                {k: v[:h] for k, v in d.items()} for d in draws]
        if self.fault == "unchanged":
            metrics = {"loss": torch.zeros((), device=images.device)}
        else:
            state, metrics = self.step(state, images, labels,
                                       aug_draws=draws)
        self.losses.append(float(metrics["loss"]))
        if i == 0:
            moments = {}
            for name, p in state.module.named_parameters():
                st = state.optimizer.state.get(p, {})
                moments[name] = (te._host(st["exp_avg"]) if "exp_avg" in st
                                 else torch.zeros_like(p, device="cpu"))
            self.first_moments = moments
        return state, metrics


class Run(te.Run):
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
        m, g = cfg["MODEL"], cfg["GENERATOR"]
        self.backbone, self.enc_len = m["backbone_name"], m["encodings_len"]
        self.shape = ref_vit.VARIANTS[self.backbone]
        self.size = m["input_shape"][0]

        self.phases = {}
        t = time.perf_counter()
        cfg["DATALOADER"]["dataset_path"] = data.seeded_dataset(
            harness.derive_seed(seed, "images"), p["classes"],
            p["per_class"], self.size)
        params = params_from_dict(cfg)
        dl = ENDataLoader(cfg["DATALOADER"]["dataset_path"],
                          validate=cfg["DATALOADER"]["validate"],
                          val_ratio=cfg["DATALOADER"]["val_ratio"],
                          cache_index=False)
        self.n_classes = dl.n_classes
        t = self._phase("dataset", t)
        self.trainer = Trainer(params, dl, device=device,
                               log_fn=lambda *a, **k: None)
        self.weights_seed = harness.derive_seed(seed, "weights")
        self.trainer.module.load_state_dict(self._weights())
        t = self._phase("trainer and weights", t)
        paths = [q for c in dl.class_names for q in dl.train_data[c]]
        for _ in BatchLoader(te._Chunks(paths, 1024), m["input_shape"],
                             cache=self.trainer._decode_cache):
            pass
        self._phase("cache fill", t)
        gen = torch.Generator(device=self.device).manual_seed(
            harness.derive_seed(seed, "draws"))
        self.batch = g["batch_size"]
        self.recorder = Recorder(
            self.trainer.train_step, p["recorded_steps"], gen,
            g.get("augmentations") == "deepfake",
            self.trainer.compute_dtype, self.trainer.augment_fn, fault)
        self.epoch = 0

    def _weights(self) -> Dict:
        return ref_vit.make_weights(self.shape, self.size, self.enc_len,
                                    self.n_classes, self.weights_seed,
                                    self.device)

    def program_readings(self) -> dict:
        r = self.recorder
        return {"losses": r.losses, "embeddings": r.first_embeddings,
                "first_grads": {k: v / (1 - triplet.B1)
                                for k, v in r.first_moments.items()},
                "params": r.params_after}

    def release(self) -> None:
        self.recorder.step = None
        super().release()

    def reference_readings(self, quant=None) -> dict:
        """The plain reference over the recorded steps, from the same
        weights, batches and draws."""
        import torch
        ref = ref_vit.Steps(self.cfg, self._weights(), quant=quant,
                            remat=True, shape=self.shape)
        for images, labels, draws in self.recorder.batches:
            ref.step(images.to(self.device), labels.to(self.device),
                     te._to(draws, self.device))
        out = {"losses": list(ref.losses),
               "embeddings": ref.first_embeddings.cpu(),
               "first_grads": {k: v.cpu() for k, v in
                               ref.first_grads.items()},
               "params": {k: v.cpu() for k, v in ref.parameters().items()}}
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    def initial_params(self) -> dict:
        return {k: v.cpu() for k, v in self._weights().items()}


def compare(prog: dict, ref: dict, w0: dict) -> Dict[str, float]:
    """The numbers that decide ``correct`` (the cell's limits file picks
    those it holds to a limit):

    * ``loss1_gap``, ``loss_gap``: the relative gap of the first recorded
      step's loss, and the largest over the recorded steps;
    * ``emb1_gap``: the first batch's embeddings (the forward alone: the
      same weights, batch and flips on both sides), relative L2;
    * ``grad_gap``, ``grad_gap_median``: the first step's gradient, as the
      optimizer got it: the gap between the program's and the reference's
      norm of each leaf, over the reference's norm of that leaf or of the
      median leaf, whichever is larger; the worst leaf and the median;
    * ``change_gap``, ``change_gap_median``: the same for the parameters'
      change over the recorded steps.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the gaps: the attention's key biases, whose
    exact gradient is zero (the softmax ignores a shift of all of a
    query's scores), hold rounding only."""
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
    emb = norm(prog["embeddings"] - ref["embeddings"]) / norm(
        ref["embeddings"])
    return {"loss1_gap": losses[0], "loss_gap": max(losses),
            "emb1_gap": emb, "grad_gap": max(grads),
            "grad_gap_median": statistics.median(grads),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}


class Profiler(StretchProfiler):
    """A :class:`~benchmark.trace.StretchProfiler` whose reads are
    summarised with the ViT's and the ArcFace step's ranges, and count
    each range's host events beside them."""

    def result(self) -> dict:
        import torch
        for prof, wall, launches in self.raw:
            summary = summarize(prof, wall, self.units, RANGES)
            summary["launches"] = launches
            summary["range_calls"] = dict(Counter(
                e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name in RANGES))
            self.counts.append(summary["kernels"])
            if settled(self.counts):
                return summary
        raise RuntimeError(
            f"{self.cell}: torch.profiler"
            f"{' (card only)' if self.device_only else ''} saw no two of "
            f"{len(self.raw)} reads of {self.units} units with the most "
            f"kernels (kernel counts of the reads {self.counts})")


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: Optional[str] = None) -> dict:
    import torch
    from embeddingnet_tpu_torch.models import vit
    from embeddingnet_tpu_torch.ops import fused_conv, preprocess

    if not hasattr(vit, "LAUNCHES"):
        raise RuntimeError("the program has no vit.LAUNCHES: this cell "
                           "reads the ViT's counters")
    r = Run(cell, seed, device, fault)
    try:
        r.warm()
        setup_s = time.perf_counter() - t_start
        profilers = []
        if trace:
            pp = r.p["profile"]
            profilers = [
                Profiler(cell.name, pp["units"], pp["start"], pp["every"],
                         pp["reads"],
                         counters=lambda: {**fused_conv.LAUNCHES,
                                           **preprocess.LAUNCHES,
                                           **vit.LAUNCHES}),
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
    s = r.shape
    rec = {"kind": "train", "setup_s": setup_s, **win,
           "batch": r.batch, "backbone": r.backbone,
           "flops_per_image": vit_flops.train_flops(s, r.size, r.enc_len,
                                                    r.n_classes),
           "attention_shape": [r.batch, vit_flops.tokens(s, r.size),
                               s.heads, s.dim // s.heads],
           "profile": profilers[0].result() if profilers else None,
           "profile_device": profilers[1].result() if profilers else None}
    if profilers:
        print("device idle: card-only trace {:.4f} %, with the host traced "
              "{:.4f} %".format(*(100 * (1 - p["busy_s"] / p["wall_s"])
                                  for p in (rec["profile_device"],
                                            rec["profile"]))),
              file=sys.stderr)
        print("ranges seen / counters: {} / {}".format(
            rec["profile"]["range_calls"], rec["profile"]["launches"]),
            file=sys.stderr)
    bad = sum(e["steps"] for e in win["epochs"] if not e["finite"])
    return {"rec": rec, "peak_bytes": peak, "attempted": win["steps"],
            "failed": bad,
            "checks": harness.check_numbers(numbers, cell.limits["limits"]),
            "numbers": numbers}
