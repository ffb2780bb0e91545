"""A rank of a node-sharded run (``sharding="halo"``: the halo teacher, the
table student) holds only its own rows of the features while it trains and
evaluates: once ``llp_tpu_torch/train/loop.py`` has cut them, no reference to
the whole prepared feature matrix is left (the mode is for features that do
not fit one device).  Run in a gloo world of one in this process, where the
same code cuts the rows (every row is the rank's, cut into a copy)."""

import gc
import weakref

import pytest

from llp_tpu_torch.parallel.mesh import close_world, init_world
from llp_tpu_torch.train import loop
from llp_tpu_torch.train.student import StudentTrainer
from llp_tpu_torch.train.teacher import TeacherTrainer
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

DATASET = "synthetic:sbm:200:3:6.0:11"
EPOCHS = 2


def _cfg(cls, root, **kw):
    batch = "batch_size" if cls is TeacherConfig else "link_batch_size"
    return cls(datasets=DATASET, dataset_dir=str(root / "data"), save_dir=str(root / "saved"),
               results_dir="", runs=1, epochs=EPOCHS, hidden_channels=16, dropout=0.0,
               **{batch: 256}, **kw)


@pytest.mark.parametrize("setting", ["transductive", "production"])
@pytest.mark.parametrize("role", ["teacher", "student"])
def test_a_sharded_rank_drops_the_whole_features(tmp_path, role, setting, monkeypatch):
    loop.run_teacher(_cfg(TeacherConfig, tmp_path, transductive=setting), verbose=False,
                     device="cpu")
    whole, alive = [], []
    name = "prepare_production" if setting == "production" else "prepare_transductive"
    prepare = getattr(loop, name)

    def prepared(cfg, device):
        data = prepare(cfg, device)
        whole.extend(weakref.ref(data[k]) for k in ("x", "inf_x") if k in data)
        return data

    trainer = TeacherTrainer if role == "teacher" else StudentTrainer
    epoch = trainer.epoch

    def watched(self, gen, *a, **kw):
        gc.collect()
        alive.append([r() is not None for r in whole])
        return epoch(self, gen, *a, **kw)

    monkeypatch.setattr(loop, name, prepared)
    monkeypatch.setattr(trainer, "epoch", watched)
    cls, run = ((TeacherConfig, loop.run_teacher) if role == "teacher"
                else (StudentConfig, loop.run_student))
    extra = {} if role == "teacher" else {"minibatch": True}
    world = init_world(0, 1, "cpu", init_method=f"file://{tmp_path / 'store'}", timeout=60)
    try:
        run(_cfg(cls, tmp_path, transductive=setting, sharding="halo", **extra),
            verbose=False, world=world)
    finally:
        close_world()
    assert alive == [[False] * len(whole)] * EPOCHS and whole
