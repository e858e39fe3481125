"""Audio Raytracing Studio — accelerator-native rebuild.

A JAX/XLA reimplementation of CipherCorePro/Audio-Raytracing-Studio:
procedural impulse-response synthesis ("audio raytracing"), FFT convolution
reverb, 3D surround panning, channel-layout mapping, BS.1770 loudness
metering, v4 JSON presets, and the same 4-tab web UI — rebuilt for
accelerators (batched static-shape graphs, device meshes) rather than
translated.

Reference behavior citations throughout point into
/root/reference/raytracer_studio.py (studied, not copied).

Migrating call sites from the reference monolith can keep their exact
function names: ``from audio_raytracing_studio_tpu import compat as
raytracer_studio`` (see docs/MIGRATION.md).

Production serving: ``serving.RenderService`` micro-batches concurrent
render jobs into single SPMD device programs;
``python -m audio_raytracing_studio_tpu.serving.service`` serves the
HTTP job API (docs/MIGRATION.md "Level 2").
"""

from . import config
from .params import IRDraws, IRGeometry, RenderParams

__version__ = "0.1.0"

__all__ = [
    "config",
    "RenderParams",
    "IRGeometry",
    "IRDraws",
    "render",
    "render_batch",
    "__version__",
]


def render(*args, **kwargs):
    """Single-clip render — see models.pipeline.render (lazy import)."""
    from .models.pipeline import render as _render

    return _render(*args, **kwargs)


def render_batch(*args, **kwargs):
    """Batched/sharded render — see parallel.sharding.render_batch (lazy import)."""
    from .parallel.sharding import render_batch as _render_batch

    return _render_batch(*args, **kwargs)
