"""Frozen operation and byte counts, and the table of peaks.

The multiply-add counts are `chip_smoke.py:_macs_per_sample` and
`_bwd_macs_per_sample`, frozen here at the model's own input widths (no
padded tile columns). Counted as the model needs them, not as a kernel
happens to run them: the backward's count is one product per weight for
its gradient and the input gradients that have a consumer; the forward
the backward recomputes is not counted. A FLOP is two per multiply-add."""

from __future__ import annotations

from .model_spec import Spec

# dense bf16 tensor-core peak and memory rate by card (NVIDIA data sheets;
# `chip_smoke.py:PEAKS`): (name substring, TFLOP/s, TB/s)
PEAKS = (
    ("H100 PCIe", 756.0, 2.0),
    ("H100 NVL", 835.0, 3.9),
    ("H200", 989.0, 4.8),
    ("H100", 989.0, 3.35),  # SXM
)


def peaks(device_name: str):
    """(FLOP/s, bytes/s) of the named card; raises for a card not listed."""
    for key, tflops, tbs in PEAKS:
        if key in device_name:
            return tflops * 1e12, tbs * 1e12
    raise ValueError(f"no published peaks for {device_name!r}")


def _branch_macs(width, depth, skips, c_in, c_dir, heads: bool) -> int:
    m = 0
    for i in range(depth):
        k = c_in if i == 0 else (c_in + width if i in skips else width)
        m += k * width
    m += width  # sigma head
    if heads:
        m += width * width + (width + c_dir) * (width // 2) + (width // 2) * 3
    return m


def macs_per_sample(spec: Spec, sigma_only: bool = False) -> int:
    """Forward multiply-adds of one sample: both branches with their heads,
    or the scene trunk and sigma head alone (the eval render's coarse pass)."""
    m = _branch_macs(spec.W, spec.D, spec.skips, spec.in_xyz, spec.in_dir, not sigma_only)
    if not sigma_only:
        m += _branch_macs(spec.inst_W, spec.inst_D, spec.inst_skips, spec.in_inst,
                          spec.in_dir, True)
    return m


def grad_columns(spec: Spec):
    """(scene, object) input columns whose gradient has a consumer: the
    encoded voxel features (a voxel model) and the object code."""
    if not spec.use_voxel_embedding:
        return 0, spec.N_obj_code_length
    n = 2 * spec.N_freq_voxel + 1
    return (spec.N_scn_voxel_size * n,
            (spec.N_scn_voxel_size + spec.N_obj_voxel_size) * n + spec.N_obj_code_length)


def _input_grad_macs(width, depth, skips, c_need) -> int:
    m = 0
    for i in range(depth):
        if i > 0:
            m += width * width
        if i == 0 or i in skips:
            m += c_need * width
    return m + width + width * width + width * (width // 2) + (width // 2) * 3


def bwd_macs_per_sample(spec: Spec) -> int:
    """Backward multiply-adds of one sample: the weight gradients (one
    product per weight) and the input gradients that have a consumer."""
    g_s, g_o = grad_columns(spec)
    return (macs_per_sample(spec)
            + _input_grad_macs(spec.W, spec.D, spec.skips, g_s)
            + _input_grad_macs(spec.inst_W, spec.inst_D, spec.inst_skips, g_o))


def train_step_flops(spec: Spec, batch: int) -> float:
    """Model FLOPs of one training step: both passes' forward (64 and 128
    samples a ray, both branches with heads) and backward."""
    samples = batch * (spec.N_samples + spec.N_samples + spec.N_importance)
    return 2.0 * samples * (macs_per_sample(spec) + bwd_macs_per_sample(spec))


def train_bwd_flops(spec: Spec, batch: int) -> float:
    samples = batch * (spec.N_samples + spec.N_samples + spec.N_importance)
    return 2.0 * samples * bwd_macs_per_sample(spec)


def _n_weights(spec: Spec) -> int:
    n = 0
    for width, depth, skips, c_in in ((spec.W, spec.D, spec.skips, spec.in_xyz),
                                      (spec.inst_W, spec.inst_D, spec.inst_skips,
                                       spec.in_inst)):
        n += _branch_macs(width, depth, skips, c_in, spec.in_dir, True) + 2 * width + 3
    return n


def train_bwd_bytes(spec: Spec, batch: int) -> float:
    """Bytes the backward of one step has to move at the least, each input
    read once and each output written once: per pass the bf16 weights in and
    the f32 weight gradients out; per sample its position (3 f32), its raw
    voxel features in and their gradient out (f32), its 8 output cotangents
    (f32); per ray its direction encoding and code (f32) and the code's
    gradient (f32)."""
    per_sample = 4 * (3 + 8 + 2 * spec.voxel_channels)
    per_ray = 4 * (spec.in_dir + 2 * spec.N_obj_code_length)
    samples = batch * (spec.N_samples + spec.N_samples + spec.N_importance)
    return 2 * _n_weights(spec) * (2 + 4) + samples * per_sample + 2 * batch * per_ray


def render_frame_flops(spec: Spec, rays: int) -> float:
    """Model FLOPs of one eval frame: the coarse scene density at N_samples
    a ray and both branches with heads at N_samples + N_importance."""
    return 2.0 * rays * (spec.N_samples * macs_per_sample(spec, sigma_only=True)
                         + (spec.N_samples + spec.N_importance) * macs_per_sample(spec))


def render_chain_bytes(spec: Spec, rays: int) -> float:
    """Bytes the frame's forward chain launches have to move at the least:
    per sample its position (3 f32) and raw voxel features (f32) in; per ray
    its depths in (f32), its direction encoding and code in (f32), its 10
    map values out (f32); the bf16 weights once per launch (not counted:
    they stay in L2)."""
    samples = rays * (spec.N_samples + spec.N_samples + spec.N_importance)
    return (samples * 4 * (3 + 1 + spec.voxel_channels)
            + rays * 4 * (spec.in_dir + spec.N_obj_code_length + 10))
