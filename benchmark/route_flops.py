"""Operation and byte counts of a frame of the `rays_in_bbox` route
(`drivers/route.py`), counted as `flops.py` counts the plain eval frame.

The route's coarse pass runs both branches with their heads, not the scene
density alone, and hands its raw outputs to the compositing glue. The
counts hold for every ray of the frame, hit or miss: they are the work the
route asks for, whatever implements it."""

from __future__ import annotations

from .flops import macs_per_sample, render_chain_bytes
from .model_spec import Spec

RAW_OUTPUTS = 8  # sigma, rgb, object sigma, object rgb of a coarse sample (f32)


def route_frame_flops(spec: Spec, rays: int) -> float:
    """Model FLOPs of one route frame: both branches with heads at
    N_samples a ray (coarse) and at N_samples + N_importance (fine)."""
    samples = rays * (spec.N_samples + spec.N_samples + spec.N_importance)
    return 2.0 * samples * macs_per_sample(spec)


def route_chain_bytes(spec: Spec, rays: int) -> float:
    """Bytes the route frame's forward chain launches have to move at the
    least: those of the plain frame (`flops.render_chain_bytes`) and the
    coarse pass's raw outputs, written once."""
    return render_chain_bytes(spec, rays) + rays * spec.N_samples * 4 * RAW_OUTPUTS
