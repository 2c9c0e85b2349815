"""Checkpoint / resume: whole-train-state snapshots with ``torch.save`` (port
of ``embeddingnet_tpu/train/checkpoint.py``, which uses Orbax).

A checkpoint is the directory ``<weights>/<epoch>/`` holding ``state.pt``
(:meth:`~embeddingnet_tpu_torch.train.state.TrainState.state_dict`: module,
optimizer, generator, step count, plateau scale, EMA) and ``host.json``
(``epoch``, ``best``, ``metrics`` and the callbacks' state). It is written
into a temporary directory beside it and renamed into place with
``os.replace``, so a crash mid-write leaves no torn checkpoint. The state
is written from a host copy of its tensors (taken before ``save``
returns). Loads use ``weights_only=True``.

``PERFORMANCE.async_checkpoint`` writes the host copy on a background
thread while training goes on; the next save, :meth:`CheckpointManager.
wait`, :meth:`~CheckpointManager.epochs`, ``restore`` and ``close`` wait
for it, and the files are the synchronous save's byte for byte. Under
several ranks (``parallel``) rank 0 alone writes, every rank makes the
same save decisions, and a read waits at a barrier until rank 0's write is
done. A state split over a model group (``parallel/tp.py``) is saved
whole, its slices gathered from every rank of the group, and cut to this
rank's slices on load, so a checkpoint of a tensor-parallel run resumes in
one process and the other way round.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import torch
import torch.distributed as dist

from embeddingnet_tpu_torch.parallel.tp import gather_state, slice_state
from embeddingnet_tpu_torch.train.state import TrainState

STATE_FILE, HOST_FILE = "state.pt", "host.json"


def host_copy(tree):
    """``tree`` with every tensor copied to the host (a new tensor, so the
    training may go on changing the original)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class CheckpointManager:
    """Best-only checkpoints under ``<work_dir>/weights/``, at most
    ``max_to_keep`` of them (the oldest go first). ``map_location`` is where
    restored tensors land (the Trainer's device). ``async_save`` writes on
    a background thread; ``parallel`` (a data-parallel world) lets rank 0
    alone write."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 monitor: str = "val_loss", mode: str = "min",
                 async_save: bool = False, map_location=None,
                 parallel=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self.map_location = map_location
        self.async_save = async_save
        self.parallel = parallel
        # the world's rank 0 (with a model axis, several ranks are rank 0
        # of their data group)
        self.writes = parallel is None or dist.get_rank() == 0
        self.best: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value < self.best if self.mode == "min" else value > self.best

    def save(self, epoch: int, state: TrainState, metrics: dict,
             host_state: Optional[dict] = None) -> bool:
        """Save if the monitored metric improved. Returns True when a
        checkpoint was written."""
        raw = metrics.get(self.monitor)
        if raw is None and self.mode == "min":
            raw = metrics.get("loss")  # reference fallback
        # an absent monitored metric (recall evaluated every N epochs) has
        # nothing to compare with, so it never counts as improved
        if raw is None or not self._improved(float(raw)):
            return False
        self.best = float(raw)
        split = getattr(state.module, "model_parallel", None) is not None
        if not self.writes and not split:
            return True
        # whole tensors: a collective over the model group when split
        tree = gather_state(state)
        if not self.writes:
            return True
        host = {"epoch": epoch, "best": self.best,
                "metrics": {k: float(v) for k, v in metrics.items()},
                **(host_state or {})}
        self._wait_local()
        tensors = host_copy(tree)
        if not self.async_save:
            self._write(epoch, tensors, host)
            return True
        self._thread = threading.Thread(
            target=self._write_catching, args=(epoch, tensors, host),
            name=f"checkpoint-{epoch}", daemon=True)
        self._thread.start()
        return True

    def _write(self, epoch: int, tensors: dict, host: dict) -> None:
        final = os.path.join(self.directory, str(epoch))
        tmp = os.path.join(self.directory, f".tmp-{epoch}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tensors, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, HOST_FILE), "w") as f:
            json.dump(host, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._complete()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def _write_catching(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # handed to the next wait()
            self._error = e

    def _wait_local(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("the background checkpoint write "
                               "failed") from error

    def wait(self) -> None:
        """Until this rank's pending write is done; under several ranks,
        then until every rank got there (so rank 0's files are
        complete)."""
        self._wait_local()
        if self.parallel is not None and dist.get_world_size() > 1:
            dist.barrier()

    def close(self) -> None:
        self.wait()

    def _complete(self):
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, HOST_FILE)))

    def epochs(self):
        """The epochs with a complete checkpoint, oldest first (after
        :meth:`wait`)."""
        self.wait()
        return self._complete()

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, state: TrainState, epoch: Optional[int] = None):
        """Load a checkpoint into ``state`` in place; ``(state,
        host_state)``. ``epoch=None`` -> latest."""
        epoch = epoch if epoch is not None else self.latest_epoch()
        self.wait()
        path = os.path.join(self.directory, str(epoch))
        if epoch is None or not os.path.exists(
                os.path.join(path, HOST_FILE)):
            raise FileNotFoundError(
                f"no checkpoint{'' if epoch is None else f' {epoch}'} "
                f"under {self.directory}")
        state.load_state_dict(slice_state(torch.load(
            os.path.join(path, STATE_FILE), map_location=self.map_location,
            weights_only=True), state))
        with open(os.path.join(path, HOST_FILE)) as f:
            host = json.load(f)
        self.best = host.get("best")
        return state, host


def save_encodings_pickle(encoded_training_data: dict, save_folder: str,
                          save_file_name: str = "encodings.pkl") -> str:
    """The encodings-pickle contract of the JAX package."""
    import pickle
    os.makedirs(save_folder, exist_ok=True)
    path = os.path.join(save_folder, save_file_name)
    with open(path, "wb") as f:
        pickle.dump(encoded_training_data, f)
    return path


def create_save_folders(params_general) -> dict:
    """The work-dir tree of the JAX package (and of the reference)."""
    work_dir_path = os.path.join(params_general["work_dir"],
                                 params_general["project_name"])
    paths = {
        "work_dir": work_dir_path,
        "weights": os.path.join(work_dir_path, "weights/"),
        "pretraining_weights": os.path.join(
            work_dir_path, "pretraining_model/weights/"),
        "encodings": os.path.join(work_dir_path, "encodings/"),
        "plots": os.path.join(work_dir_path, "plots/"),
        "tensorboard": os.path.join(work_dir_path, "tf_log/"),
        "pretraining_tensorboard": os.path.join(
            work_dir_path, "pretraining_model/tf_log/"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths
