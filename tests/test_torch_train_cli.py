"""The port's train CLI (`python -m object_nerf_torch.train`) on the
synthetic scene with `device=cpu`: artefacts, checkpoint retention, and a
resume that repeats the uninterrupted run bit for bit. Modelled on
tests/test_train_cli.py and tests/test_resume.py of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from object_nerf_torch.config import load_config
from object_nerf_torch.data import dataset_dict
from object_nerf_torch.train import __main__ as train_cli
from object_nerf_torch.train.checkpoint import (
    latest_checkpoint, restore_system, save_checkpoint,
)
from object_nerf_torch.train.convert import load_reference_ckpt
from object_nerf_torch.train.system import ObjectNeRFSystem

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARGS = [
    f"dataset_config={ROOT / 'config/synthetic.yml'}",
    "exp_name=clitest", "img_wh=[24,18]", "device=cpu",
    "model.D=2", "model.W=32", "model.skips=[1]",
    "model.inst_D=2", "model.inst_W=16", "model.inst_skips=[1]",
    "model.N_samples=8", "model.N_importance=4",
    "model.N_max_objs=8", "model.N_obj_code_length=8",
    "train.num_epochs=1", "train.batch_size=64",
    "train.limit_train_batches=0.5", "train.val_check_interval=0.5",
]


def _with(args, **over):
    keys = tuple(f"{k}=" for k in over)
    return [a for a in args if not a.startswith(keys)] + [f"{k}={v}" for k, v in over.items()]


def test_train_cli_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    train_cli.main(list(ARGS))
    out = capsys.readouterr().out
    assert "[val]" in out and "rays/s" in out and "Done." in out
    runs = list((tmp_path / "logs").iterdir())
    assert len(runs) == 1 and "clitest" in runs[0].name
    run = runs[0]
    snapshot = load_config(default_conf=run / "run_config_snapshot.yaml")
    assert snapshot.model.W == 32 and snapshot.device == "cpu"
    # one epoch: its checkpoint, `last`, and the final step's
    assert (run / "epoch_0.ckpt").is_file() and (run / "last.ckpt").is_file()
    last = latest_checkpoint(run)
    ckpt = torch.load(last, map_location="cpu", weights_only=False)
    assert ckpt["step"] == 40 and ckpt["epoch"] == 1  # 5184 rays / 64, half of them
    # reference key names: the eval CLI's loader reads it as a reference .ckpt
    sd = load_reference_ckpt(last)
    assert "nerf_coarse.xyz_encoding_1.0.weight" in sd
    assert "code_library.embedding_instance.weight" in sd


def test_train_cli_ckpt_retention(tmp_path, monkeypatch):
    """save_top_k: -1 keeps every epoch's checkpoint, k > 0 the best k by the
    epoch's own val/psnr, 0 none; `last` is always there."""
    monkeypatch.chdir(tmp_path)
    args = _with(ARGS, **{"train.num_epochs": 3})
    for top_k, n_kept in ((-1, 3), (1, 1), (0, 0)):
        train_cli.main(_with(args, **{"train.save_top_k": top_k, "exp_name": f"k{top_k}"}))
        run = next(p for p in (tmp_path / "logs").iterdir() if p.name.endswith(f"k{top_k}"))
        assert len(list(run.glob("epoch_*.ckpt"))) == n_kept, top_k
        assert (run / "last.ckpt").is_file()


def test_train_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main([a for a in ARGS if a != "device=cpu"])
    # a generic_dataset config needs a scene on disk; given one, it trains
    with pytest.raises(SystemExit, match="no scene selected"):
        train_cli.main(_with(ARGS, dataset_name="generic_dataset"))
    from object_nerf_torch.scripts.make_synthetic_dataset import make_dataset

    scene = make_dataset(tmp_path / "desk", img_wh=(48, 44), n_frames=4)
    train_cli.main(_with(ARGS, **{
        "dataset_config": ROOT / "config/synthetic_desk.yml", "exp_name": "deskcli",
        "img_wh": "[48,44]", "model.use_voxel_embedding": "false",
        "snapshot_source": "false", "dataset_extra.root_dir": scene,
        "dataset_extra.split": f"{scene}/split", "dataset_extra.validate_idx": 3}))
    run = next(p for p in (tmp_path / "logs").iterdir() if p.name.endswith("deskcli"))
    ckpt = torch.load(latest_checkpoint(run), map_location="cpu", weights_only=False)
    assert ckpt["step"] == 33  # 2 train frames x 2112 rays / 64, half of them
    cfg = load_config(cli_args=[a for a in ARGS if a != "device=cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ObjectNeRFSystem(cfg)  # no device given: cuda
    # a voxel-conditioned run of the CLI on the CPU, its grid from a written PLY
    from object_nerf_torch.data.ply_io import write_ply

    write_ply(str(tmp_path / "pcd.ply"),
              np.random.RandomState(0).rand(400, 3) * [2.4, 2.4, 1.2] - [1.2, 1.2, 0.2])
    train_cli.main(_with(ARGS, **{"exp_name": "voxcli", "model.use_voxel_embedding": "true",
                                  "model.N_freq_voxel": 2,
                                  "dataset_extra.pcd_path": tmp_path / "pcd.ply",
                                  "dataset_extra.voxel_size": 0.3,
                                  "dataset_extra.neighbor_marks": 3}))
    run = next(p for p in (tmp_path / "logs").iterdir() if p.name.endswith("voxcli"))
    ckpt = torch.load(latest_checkpoint(run), map_location="cpu", weights_only=False)
    assert ckpt["step"] == 40 and ckpt["voxel_static"] is not None
    assert "embedding_xyz.embedding_space_ftr.weight" in ckpt["state_dict"]


def _system(ckpt_path=None, **train_over):
    cfg = load_config(cli_args=_with(ARGS, **{"train.num_epochs": 2}))
    cfg.train.merge(train_over)
    if ckpt_path is not None:
        cfg["ckpt_path"] = str(ckpt_path)
    kw = dict(img_wh=(16, 12), dataset_extra=cfg.dataset_extra)
    ds = dataset_dict["synthetic"]("train", n_frames=2, **kw)
    return ObjectNeRFSystem(cfg, dataset=ds, val_dataset=dataset_dict["synthetic"]("val", **kw),
                            device="cpu")


@pytest.mark.parametrize("optimizer", ["adam", "ranger"])
def test_resume_repeats_the_next_steps_exactly(tmp_path, optimizer):
    """Weights, optimizer state, step, the device generator and the batch
    sampler all come back: steps 4-8 of a resumed run equal those of the
    uninterrupted one bit for bit (across ranger's sync at step 6 too)."""
    sys1 = _system(optimizer=optimizer)
    for _ in range(3):
        sys1.training_step(sys1.train_dataset.sample_batch(64, sys1.batch_rng))
    path = save_checkpoint(tmp_path, sys1)
    assert path.name == "step_3.ckpt" and latest_checkpoint(tmp_path) == path

    sys2 = _system(ckpt_path=path, optimizer=optimizer)
    assert sys2.global_step == 3
    for _ in range(5):
        m1 = sys1.training_step(sys1.train_dataset.sample_batch(64, sys1.batch_rng))
        m2 = sys2.training_step(sys2.train_dataset.sample_batch(64, sys2.batch_rng))
        assert float(m1["train/loss"]) == float(m2["train/loss"])
        assert m1["lr"] == m2["lr"]
    assert sys1.global_step == sys2.global_step == 8
    for (k, a), b in zip(sys1.models.state_dict().items(), sys2.models.state_dict().values()):
        assert torch.equal(a, b), k
    # a fresh system that loads only weights (a reference-style state dict)
    bare = tmp_path / "weights.ckpt"
    torch.save({"state_dict": sys1.models.state_dict()}, bare)
    sys3 = _system(optimizer=optimizer)
    restore_system(sys3, bare)
    assert sys3.global_step == 0
    assert torch.equal(sys3.models.nerf_fine.sigma.weight, sys1.models.nerf_fine.sigma.weight)


def test_fit_resumes_mid_run_and_guards_nan(tmp_path):
    sys1 = _system(val_check_interval=0.5, nan_check_every=1)
    assert sys1.steps_per_epoch == 3
    hist = sys1.fit()
    assert sys1.global_step == 6 and len(hist) == 6  # int(3 * 0.5) = 1: every step
    assert {"train/loss", "train/psnr", "lr", "val/psnr", "val/ssim"} <= set(hist[0])
    assert all(np.isfinite(h["train/loss"]) for h in hist)
    # resumed at step 4 of 6, fit takes the two steps that are left
    sys2 = _system()
    for _ in range(4):
        sys2.training_step(sys2.train_dataset.sample_batch(64, sys2.batch_rng))
    seen = []
    sys3 = _system(ckpt_path=save_checkpoint(tmp_path, sys2))
    sys3.fit(epoch_end_callbacks=[lambda epoch, s: seen.append((epoch, s.global_step))])
    assert seen == [(1, 6)]
    # the guard
    with torch.no_grad():
        sys3.models.nerf_fine.sigma.bias.fill_(float("nan"))
    sys3.train_step.global_step = 0
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        sys3.fit()


_NO_PIL = r"""
import sys
sys.modules["PIL"] = None  # tensorboardX imports, its image summaries do not
from object_nerf_torch.train import __main__ as train_cli
train_cli.main(sys.argv[1:])
"""


def test_image_panel_is_best_effort_without_pil(tmp_path):
    """With tensorboardX importable and PIL blocked (tensorboardX does not
    require Pillow, but draws images with it), the CLI finishes: it writes
    the validation scalars, says once per validation that the image panel was
    skipped, and writes no image."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _NO_PIL, *ARGS], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Done." in out.stdout and "TensorBoard logging off" not in out.stdout
    assert out.stdout.count("[val] image panel skipped") == out.stdout.count("[val] epoch")
    assert out.stdout.count("[val] epoch") == 2
    run = next((tmp_path / "logs").iterdir())
    events = EventAccumulator(str(run))
    events.Reload()
    assert {"val/psnr", "val/ssim", "train/loss"} <= set(events.Tags()["scalars"])
    assert events.Tags()["images"] == []
