"""A run of the harness on the CPU, at test size, with the timed path
broken underneath: ``correct`` has to come out false.

The look for a card is skipped (``run_cell(device="cpu")``); the rest of
the run is the one the chip makes: corpus, set-up, window, the
reference's check. The cells have no exchange between chips to leave out.
"""

import pytest

import run
from yabpe_tpu_torch.pretok import ingest
from yabpe_tpu_torch.train import trainer


def _run(root, workload):
    return run.run_cell(workload, 2**31 + 11, 0.5, False, device="cpu", root=root)


def test_a_sound_run_is_correct(tiny_root):
    result = _run(tiny_root, "tiny.train")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert not run.forbidden_modules()


def _no_merges(self, counter, base):
    return base, []  # the merge loop's state never advances


def _half_the_spans(files, chunk, align):
    return ORIG_SPANS(files, chunk, align)[::2]


ORIG_SPANS = ingest._spans
ORIG_TRAIN = trainer.BBPETrainer.train


def _swap_merges(self, files):
    model = ORIG_TRAIN(self, files)
    model.merges[0], model.merges[1] = model.merges[1], model.merges[0]
    return model


FAULTS = {
    "state_unchanged": (trainer.BBPETrainer, "_train_device", _no_merges),
    "half_the_batch": (ingest, "_spans", _half_the_spans),
    "answer_altered": (trainer.BBPETrainer, "train", _swap_merges),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_train_faults_are_caught(tiny_root, monkeypatch, fault):
    owner, name, fn = FAULTS[fault]
    monkeypatch.setattr(owner, name, fn)
    result = _run(tiny_root, "tiny.train")
    assert not result["correct"], result["checks"]
