"""The port's weight bridge (object_nerf_torch/train/convert.py)."""

import numpy as np
import pytest
import torch

from object_nerf_tpu.train.torch_convert import convert_state_dict

from object_nerf_torch.train.convert import from_jax_params, load_reference_ckpt
from object_nerf_torch.train.system import ObjectNeRFModels

from _torch_port import CFG, N_OBJS, SMALL, jax_params, to_numpy

torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def test_jax_params_round_trip_through_port_state_dict():
    """JAX init -> numpy -> from_jax_params -> the port's modules (reference
    key names, strict load) -> the JAX package's own reference-checkpoint
    converter gives the identical arrays back."""
    params = to_numpy(jax_params(seed=7))
    models = ObjectNeRFModels(CFG, n_importance=1, n_max_objs=N_OBJS)
    models.load_state_dict(from_jax_params(params))  # strict: every key matches
    sd = {k: v.detach().numpy() for k, v in models.state_dict().items()}
    back = convert_state_dict(sd, SMALL)
    want, got = dict(_leaves(params)), dict(_leaves(back))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_reference_ckpt(tmp_path):
    params = to_numpy(jax_params(seed=1))
    sd = from_jax_params(params)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {**sd, "loss.some_buffer": torch.zeros(1)},
                "epoch": 3}, path)
    loaded = load_reference_ckpt(str(path))
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k

    # a checkpoint with a voxel grid is not loaded without its grid
    torch.save({"state_dict": {**sd, "embedding_xyz.embedding_space_ftr.weight":
                               torch.zeros(4, 16)}}, path)
    with pytest.raises(ValueError, match="voxel"):
        load_reference_ckpt(str(path))
    loaded, voxel = load_reference_ckpt(str(path), with_voxel=True)
    assert set(loaded) == set(sd) | {"embedding_xyz.embedding_space_ftr.weight"}
    assert voxel["features"].shape == (4, 16)
    assert load_reference_ckpt(str(path), with_voxel=True)[1] is not None
    torch.save({"state_dict": sd}, path)
    assert load_reference_ckpt(str(path), with_voxel=True)[1] is None
