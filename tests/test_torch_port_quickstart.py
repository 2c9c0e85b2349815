"""``examples/quickstart_torch.py``, the port's twin of
``examples/quickstart.py``, end to end on the CPU (``--device cpu``, one
torch thread): the dataset, two epochs of ``simple2`` with semihard
mining, the export of the encoder and ``encodings.pkl``, the
classification of a held-out image and the val recall."""

import os
import pickle
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main = runpy.run_path(os.path.join(ROOT, "examples",
                                           "quickstart_torch.py"))["main"]
        work = tmp_path_factory.mktemp("quickstart")
        return main(["--device", "cpu", "--work_dir", str(work)]), work
    finally:
        torch.set_num_threads(n)


def test_trains_two_epochs(run):
    out, _ = run
    h = out["history"]
    assert len(h["loss"]) == len(h["val_loss"]) == 2
    assert np.isfinite(h["loss"]).all() and np.isfinite(h["val_loss"]).all()


def test_exports_the_encoder_and_the_db(run):
    out, work = run
    assert out["weights"] == os.path.join(str(work), "base_model.pt")
    state = torch.load(out["weights"], weights_only=True)
    assert any(k.startswith("backbone.") for k in state)
    with open(out["encodings"], "rb") as f:
        db = pickle.load(f)
    assert len(db["labels"]) == len(db["encodings"]) == 6 * 9
    assert db["encodings"].shape[1] == 32


def test_classifies_and_measures_recall(run):
    out, _ = run
    true, label, top5 = out["query"]
    classes = [f"class_{c:02d}" for c in range(6)]
    assert true == "class_00" and label in classes and len(top5) == 5
    assert 0.0 <= out["recall"]["top1"] <= out["recall"]["top5"] <= 1.0
