"""flops.py against a count by hand of both configurations' layers."""

import pytest

from benchmark import flops, harness
from benchmark.model_spec import Spec

# (fan_in x fan_out) of every layer, summed by hand
VOXEL = dict(
    scene=271 * 256 + (256 + 271) * 256 + 6 * 256 * 256 + 256            # trunk, sigma
    + 256 * 256 + (256 + 27) * 128 + 128 * 3,                             # final, dir, rgb
    obj=439 * 128 + (128 + 439) * 128 + 2 * 128 * 128 + 128
    + 128 * 128 + (128 + 27) * 64 + 64 * 3,
    # input gradients with a consumer: 208 encoded scene voxel columns; 208 + 104 + 64
    # object columns; every hidden row; the heads' rows
    igrad_scene=208 * 256 * 2 + 7 * 256 * 256 + 256 + 256 * 256 + 256 * 128 + 128 * 3,
    igrad_obj=376 * 128 * 2 + 3 * 128 * 128 + 128 + 128 * 128 + 128 * 64 + 64 * 3,
    sigma_only=271 * 256 + (256 + 271) * 256 + 6 * 256 * 256 + 256)
PE = dict(
    scene=63 * 256 + (256 + 63) * 256 + 6 * 256 * 256 + 256 + 256 * 256 + 283 * 128 + 384,
    obj=127 * 128 + (128 + 127) * 128 + 2 * 128 * 128 + 128 + 128 * 128 + 155 * 64 + 192,
    igrad_scene=7 * 256 * 256 + 256 + 256 * 256 + 256 * 128 + 128 * 3,
    igrad_obj=64 * 128 * 2 + 3 * 128 * 128 + 128 + 128 * 128 + 128 * 64 + 64 * 3,
    sigma_only=63 * 256 + (256 + 63) * 256 + 6 * 256 * 256 + 256)


@pytest.mark.parametrize("name,hand", [("objnerf-voxel-scannet", VOXEL),
                                       ("objnerf-pe-synthetic", PE)])
def test_counts_match_a_hand_count(name, hand):
    spec = Spec.from_config(harness.config(name)["model"])
    fwd = hand["scene"] + hand["obj"]
    assert flops.macs_per_sample(spec) == fwd
    assert flops.macs_per_sample(spec, sigma_only=True) == hand["sigma_only"]
    bwd = fwd + hand["igrad_scene"] + hand["igrad_obj"]
    assert flops.bwd_macs_per_sample(spec) == bwd
    assert flops.train_step_flops(spec, 2048) == 2 * 2048 * (64 + 128) * (fwd + bwd)
    assert flops.render_frame_flops(spec, 640 * 480) == \
        2 * 640 * 480 * (64 * hand["sigma_only"] + 128 * fwd)


def test_voxel_step_is_about_two_teraflop():
    spec = Spec.from_config(harness.config("objnerf-voxel-scannet")["model"])
    assert 1.9e12 < flops.train_step_flops(spec, 2048) < 2.2e12


def test_peaks_name_the_card():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError):
        flops.peaks("some other card")
