#!/usr/bin/env bash
# Install the optional extras for the full studio experience.
# The core framework needs only jax, numpy, scipy (see pyproject.toml).
set -e
pip install gradio matplotlib pillow  # web UI + visualizer
echo "Launch the studio with: python -m audio_raytracing_studio_tpu.app.studio"
