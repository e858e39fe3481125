"""Serving layer: dynamic micro-batching render service + HTTP job API.

The batched SPMD pipeline reaches its throughput at batch sizes that
fill the device (bench.py: B=48); a request-per-render server wastes
that.  ``RenderService`` (serving.batcher) queues concurrent jobs, groups
them by XLA static signature, and dispatches each group as ONE
``render_batch`` call; ``serve`` (serving.service) exposes it as a
zero-dependency HTTP JSON job API.

No reference counterpart: raytracer_studio.py handles one synchronous
render per Gradio click (SURVEY §2.7 — no parallelism of any kind).
"""

from .batcher import RenderJob, RenderResult, RenderService

__all__ = ["RenderJob", "RenderResult", "RenderService"]
