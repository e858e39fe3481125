"""Reference-API compatibility façade — the raytracer_studio.py surface.

Every public function and module-level constant of the reference monolith
(/root/reference/raytracer_studio.py), exposed under the reference's exact
name and signature so call sites migrate 1:1:

    from audio_raytracing_studio_tpu import compat as raytracer_studio

The implementations delegate to the JAX framework: hot DSP routes
through the same jitted device ops the flagship pipeline uses (one compile
per shape/static-config, exactly like the product render path); host-level
utilities (presets, marker, metrics, plots, UI handlers) route through the
framework modules.  Numeric outputs match the reference within the project
parity contract (≤1e-3 max-abs; see PARITY.md — the measured margins are
~2e-6 on the pipeline configs).

Three deliberate, documented deviations:

* ``generate_impulse_response_split_3d`` takes an optional ``seed`` keyword
  (default 0).  The reference uses the **unseeded global NumPy RNG**
  (raytracer_studio.py:262-285), so even the reference cannot reproduce its
  own output run-to-run; here randomness is the framework's counter-based
  hash stream (ops/rng.py, PARITY.md "seed streams v2") — deterministic per
  seed and identical on every backend.
* DSP functions take an optional ``backend`` keyword: ``"jax"`` (default)
  runs the jitted device path; ``"oracle"`` runs the float64 NumPy
  reference-semantics implementation (oracle/dsp.py) — the same switch
  analysis.metrics.calculate_audio_metrics already exposes.
* ``generate_impulse_response_split_3d`` honors at most **80 early
  reflections** (``ops.ir_synth.MAX_REFLECTIONS`` — the static tap budget
  of the compiled kernels, and the reference's own product-path clip at
  raytracer_studio.py:224).  The bare reference function would loop an
  arbitrary ``reflection_count``; here counts above 80 are capped on both
  backends (consistently, so parity between them holds).

UI-handler functions that the reference defines over gradio types
(``gr.update`` / ``gr.SelectData``) return objects from the same ``gr``
layer the studio uses: real gradio when installed, else the in-repo
API-compatible headless runtime (app/_gradio_headless.py).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import config, params
from .analysis import metrics as _metrics
from .analysis.profiler import run_audio_profiler as _run_audio_profiler
from .analysis.visualize import (
    plot_waveform_and_spectrogram as _plot_waveform_and_spectrogram,
)
from .app import marker as _marker
from .app import studio as _studio
from .app.api import (  # noqa: F401  (re-exports: ref :991-1125, :1129-1174)
    apply_raytrace_convolution_3d,
    process_audio_main_v41,
)
from .models import pipeline as _pipeline
from .models.pipeline import StaticSpec
from .ops import convolution as _convolution
from .ops import filters as _filters
from .ops import ir_synth as _ir_synth
from .ops import spatial as _spatial
from .oracle import dsp as _oracle
from .params import IRDraws, RenderParams  # noqa: F401
from .utils.presets import PresetStore

# --- module-level constants (ref raytracer_studio.py:22-43) ---------------
APP_VERSION = config.APP_VERSION
PRESET_DIR = config.PRESET_DIR
LAST_PRESET_FILE = os.path.join(config.PRESET_DIR, config.LAST_PRESET_FILENAME)
BASE_SURROUND_MAP_PATH = config.BASE_SURROUND_MAP_PATH
material_absorption = config.MATERIAL_ABSORPTION
DEFAULT_MATERIAL = config.DEFAULT_MATERIAL
DEFAULT_HALL_TYPE = config.DEFAULT_HALL_TYPE
CHANNEL_LAYOUTS = config.CHANNEL_LAYOUTS
DEFAULT_CHANNEL_LAYOUT = config.DEFAULT_CHANNEL_LAYOUT


def _store() -> PresetStore:
    """Preset store rooted at the CWD, like the reference's relative paths."""
    return PresetStore(".")


# --- presets (ref :47-80, :864-988) ----------------------------------------


def ensure_preset_dir():
    """Create PRESET_DIR if missing (ref :47-49)."""
    _store().ensure_dir()


def save_last_preset(preset_name):
    """Persist the last-used preset filename (ref :51-60)."""
    _store().save_last(preset_name)


def load_last_preset():
    """Last-used preset filename, or None (ref :62-80)."""
    return _store().load_last()


def list_presets_for_dropdown_v4():
    """Sorted case-insensitive ``*_v4.json`` listing (ref :864-868)."""
    return _store().list_presets()


def save_current_preset_v4(preset_name, *control_values):
    """Save the 16 control values → (status message, dropdown update)
    (ref :870-899)."""
    return _studio.save_preset(_store(), preset_name, *control_values)


def load_selected_preset_v4(preset_file):
    """Load a preset → 16 control updates in v4 key order (ref :901-932)."""
    return _studio.load_preset(_store(), preset_file)


def delete_selected_preset_v4(preset_file):
    """Delete a preset → (status message, dropdown update) (ref :934-946)."""
    return _studio.delete_preset(_store(), preset_file)


def export_presets_as_zip_v4():
    """ZIP all presets to a temp file → its path, or None (ref :948-988)."""
    return _store().export_zip()


# --- parameter math (ref :147-236) ------------------------------------------


def update_hall_info(selected_hall_type):
    """Hall-description markdown (ref :147-155)."""
    return _studio.update_hall_info(selected_hall_type)


def adjust_reverb_parameters_by_hall(hall_type):
    """(ir_duration_s, reflection_count, max_early_delay_s, early_late_split_s)
    per hall type (ref :157-166)."""
    hp = params.hall_base_parameters(hall_type)
    return (
        hp.ir_duration_s,
        hp.reflection_count,
        hp.max_early_delay_s,
        hp.early_late_split_s,
    )


# exact reference names and semantics already live in params.py
from .params import (  # noqa: E402,F401  (ref :168-236)
    adapt_early_late_levels,
    adjust_parameters_for_3d,
    compute_final_directionality_3d,
)


# --- jitted device cores -----------------------------------------------------
# Module-level jits with static_argnames (the models.pipeline idiom): per-call
# closures would re-trace on every invocation and bake value scalars into HLO
# literals (see CLAUDE.md).

_jit_air = jax.jit(_filters.apply_air_absorption, static_argnames=("rate", "pow2"))
_jit_synthesize = jax.jit(_ir_synth.synthesize, static_argnames=("shape",))


@jax.jit
def _pan_core(audio_cn, x, y, z):
    six = _spatial.apply_pan(audio_cn, _spatial.pan_matrix(x, y, z))
    return _filters.conditional_peak_normalize(six)


@functools.partial(jax.jit, static_argnames=("layout", "rate"))
def _map_core(data_cn, layout, rate, z):
    out = _spatial.map_layout(data_cn, layout, rate, z)
    return _filters.conditional_peak_normalize(out)


@functools.partial(jax.jit, static_argnames=("spec",))
def _split_front_core(
    audio_cn, kernels, early_level, late_level,
    dry_wet, dry_factor, bass_gain, treble_gain, air_factor, *, spec: StaticSpec,
):
    """conv(early,late) → air on late → level-combine → dry-kill mix → EQ →
    conditional normalize (the front half of convolve_audio_split_3d,
    ref :338-408 — everything before the pan/map stages)."""
    len_out = spec.len_out
    conv = _convolution.convolve_full(audio_cn, kernels, len_out)
    late_wet = conv[1]
    if spec.air_on:
        late_wet = _filters.apply_air_absorption(late_wet, spec.rate, air_factor)
    wet = conv[0] * early_level + late_wet * late_level
    dry = jnp.pad(audio_cn, ((0, 0), (0, len_out - spec.n_in)))
    mixed = dry_factor * (1.0 - dry_wet) * dry + dry_wet * wet
    if spec.eq_on:
        mixed = _filters.apply_shelf_eq(mixed, spec.rate, bass_gain, treble_gain)
    return _filters.conditional_peak_normalize(mixed)


@functools.partial(jax.jit, static_argnames=("spec",))
def _external_front_core(
    audio_cn, ir_cn, dry_wet, dry_factor, bass_gain, treble_gain, *, spec: StaticSpec,
):
    """L⊛IR_L, R⊛IR_R → dry-kill mix → EQ → conditional normalize (the front
    half of convolve_audio_external_ir, ref :410-462)."""
    len_out = spec.len_out
    wet = _convolution.convolve_pairwise(audio_cn, ir_cn, len_out)
    dry = jnp.pad(audio_cn, ((0, 0), (0, len_out - spec.n_in)))
    mixed = dry_factor * (1.0 - dry_wet) * dry + dry_wet * wet
    if spec.eq_on:
        mixed = _filters.apply_shelf_eq(mixed, spec.rate, bass_gain, treble_gain)
    return _filters.conditional_peak_normalize(mixed)


def _eq_on(bass_gain, treble_gain) -> bool:
    # ONE definition of the reference's host-visible EQ skip (ref :389) —
    # params.eq_enabled, shared with the pipeline's jit cache key
    return params.eq_enabled(bass_gain, treble_gain)


# --- DSP core (ref :84-571) --------------------------------------------------


def generate_impulse_response_split_3d(
    rate, ir_duration, reflection_count, max_delay, material,
    directionality, early_late_split, diffusion_grade,
    *, seed: int = 0, backend: str = "jax",
):
    """Split (early_ir, late_ir) float32 arrays (ref :238-308).

    Deterministic per ``seed`` (see module docstring); both backends consume
    the same counter-based draw stream, so they agree within float error.
    """
    g = params.derive_ir_geometry(
        rate, ir_duration, reflection_count, max_delay,
        material, directionality, early_late_split, diffusion_grade,
    )
    if g.rate <= 0 or g.ir_duration <= 0:
        # the reference's degenerate fallback: unit early impulse, silent late
        return np.array([1.0], dtype=np.float32), np.zeros(1, dtype=np.float32)
    shape = _ir_synth.IRShape.from_geometry(g)
    delays, strengths, noise = _ir_synth.hash_draws(int(seed), shape)
    if backend == "oracle":
        # the hash stream draws the full static tap budget; the oracle takes
        # exactly reflection_count taps and late_length noise samples
        n = max(0, shape.reflection_count)
        draws = IRDraws(
            delays=np.asarray(delays)[:n],
            strengths=np.asarray(strengths)[:n],
            noise=np.asarray(noise)[: max(0, g.late_length)],
        )
        return _oracle.generate_impulse_response_split(g, draws)
    early, late = _jit_synthesize(
        shape, delays, strengths, noise, _ir_synth.IRScalars.from_geometry(g)
    )
    return np.asarray(early), np.asarray(late)


def apply_simple_lp_filter(signal, rate, air_absorption_factor, *, backend="jax"):
    """FFT-domain air-absorption low-pass over all channels (ref :310-336).

    Returns the input unchanged when the factor is below the skip threshold
    or the input is not a non-empty 2-D array (the reference's guards).
    """
    if air_absorption_factor < config.AIR_ABSORPTION_MIN_FACTOR:
        return signal
    if not isinstance(signal, np.ndarray) or signal.ndim != 2 or signal.size == 0:
        return signal
    if signal.shape[0] < 2:
        return signal
    if backend == "oracle":
        return _oracle.apply_air_absorption(signal, rate, air_absorption_factor)
    out = _jit_air(
        jnp.asarray(signal.astype(np.float32).T),
        int(rate),
        jnp.float32(np.clip(air_absorption_factor, 0.0, 1.0)),
    )
    return np.asarray(out).T


def dynamic_dry_wet_mix(dry_signal, wet_signal, dry_wet, kill_start=0.5):
    """Dry/wet crossfade with linear dry-kill past ``kill_start`` and
    tail-append length handling (ref :84-144).  Elementwise host math — the
    ONE implementation lives in oracle/dsp.py (shares params.dry_kill_factor
    with the device pipeline)."""
    return _oracle.dynamic_dry_wet_mix(dry_signal, wet_signal, dry_wet, kill_start)


def convolve_audio_split_3d(
    data, early_ir, late_ir, early_level, late_level, dry_wet,
    bass_gain=1.0, treble_gain=1.0, rate=44100, kill_start_dw=0.5,
    air_absorption_factor=0.0, *, backend="jax",
):
    """Internal-hall wet path: early/late convolution + air LP on the late
    stream + dry-kill mix + shelf EQ + conditional normalize (ref :338-408).

    Returns (len_out, 2) float32 where len_out = len(data) + len(IR) − 1.
    """
    if backend == "oracle":
        return _oracle.convolve_audio_split(
            data, early_ir, late_ir, early_level, late_level, dry_wet,
            bass_gain, treble_gain, rate, kill_start_dw, air_absorption_factor,
        )
    if data is None or np.asarray(data).size == 0:
        return np.zeros((0, 2), dtype=np.float32)
    audio_nc = _pipeline._ensure_stereo_host(np.asarray(data))
    early = np.asarray(early_ir, dtype=np.float32).flatten()
    late = np.asarray(late_ir, dtype=np.float32).flatten()
    n_in = audio_nc.shape[0]

    # activity rules of the reference (size > 1, any nonzero, level > 1e-6)
    early_act = early.size > 1 and bool(np.any(early)) and early_level > 1e-6
    late_act = late.size > 1 and bool(np.any(late)) and late_level > 1e-6
    l_pad = max(early.size, late.size, 1)
    kernels = np.zeros((2, l_pad), dtype=np.float32)
    kernels[0, : early.size] = early
    kernels[1, : late.size] = late

    dw = float(np.clip(dry_wet, 0.0, 1.0))
    spec = StaticSpec(
        n_in=n_in,
        ir_length=l_pad,
        rate=int(rate),
        layout=config.DEFAULT_CHANNEL_LAYOUT,  # unused by the front half
        eq_on=_eq_on(bass_gain, treble_gain),
        air_on=air_absorption_factor > config.AIR_ABSORPTION_MIN_FACTOR,
        # inactivity is enforced by the traced zeroed level scalars below;
        # constants here keep the flags out of the jit cache key (a flip
        # would recompile a byte-identical graph)
        early_on=False,
        late_on=False,
    )
    out = _split_front_core(
        jnp.asarray(audio_nc.T),
        jnp.asarray(kernels),
        jnp.float32(early_level if early_act else 0.0),
        jnp.float32(late_level if late_act else 0.0),
        jnp.float32(dw),
        jnp.float32(params.dry_kill_factor(dw, float(np.clip(kill_start_dw, 0.0, 1.0)))),
        jnp.float32(bass_gain),
        jnp.float32(treble_gain),
        jnp.float32(np.clip(air_absorption_factor, 0.0, 1.0)),
        spec=spec,
    )
    return np.asarray(out).T


def convolve_audio_external_ir(
    data, external_ir_data, dry_wet,
    bass_gain=1.0, treble_gain=1.0, rate=44100, kill_start_dw=0.5,
    *, backend="jax",
):
    """True-stereo convolution L⊛IR_L, R⊛IR_R + mix + EQ (ref :410-462).

    A non-stereo IR is rejected and the input returned unchanged (float32),
    matching the reference's logged skip."""
    if backend == "oracle":
        return _oracle.convolve_audio_external_ir(
            data, external_ir_data, dry_wet, bass_gain, treble_gain,
            rate, kill_start_dw,
        )
    if data is None or np.asarray(data).size == 0:
        return np.zeros((0, 2), dtype=np.float32)
    ir = external_ir_data
    if (
        ir is None
        or not isinstance(ir, np.ndarray)
        or ir.ndim != 2
        or ir.shape[1] != 2
    ):
        return np.asarray(data, dtype=np.float32)
    audio_nc = _pipeline._ensure_stereo_host(np.asarray(data))
    n_in = audio_nc.shape[0]
    dw = float(np.clip(dry_wet, 0.0, 1.0))
    spec = StaticSpec(
        n_in=n_in,
        ir_length=int(ir.shape[0]),
        rate=int(rate),
        layout=config.DEFAULT_CHANNEL_LAYOUT,
        eq_on=_eq_on(bass_gain, treble_gain),
        air_on=False,
        early_on=False,
        late_on=False,
    )
    out = _external_front_core(
        jnp.asarray(audio_nc.T),
        jnp.asarray(ir.astype(np.float32).T),
        jnp.float32(dw),
        jnp.float32(params.dry_kill_factor(dw, float(np.clip(kill_start_dw, 0.0, 1.0)))),
        jnp.float32(bass_gain),
        jnp.float32(treble_gain),
        spec=spec,
    )
    return np.asarray(out).T


def apply_surround_panning_3d(audio_data, x_pos, y_pos, z_pos, *, backend="jax"):
    """Stereo → 5.1 constant-power pan, normalized only on clipping
    (ref :464-505).  Returns (N, 6) float32."""
    if backend == "oracle":
        return _oracle.apply_surround_panning(audio_data, x_pos, y_pos, z_pos)
    if audio_data is None or np.asarray(audio_data).size == 0:
        return np.zeros((0, 6), dtype=np.float32)
    audio_nc = _pipeline._ensure_stereo_host(np.asarray(audio_data))
    out = _pan_core(
        jnp.asarray(audio_nc.T),
        jnp.float32(np.clip(x_pos, 0.0, 1.0)),
        jnp.float32(np.clip(y_pos, 0.0, 1.0)),
        jnp.float32(np.clip(z_pos, 0.0, 1.0)),
    )
    return np.asarray(out).T


def apply_delay(signal, delay_samples):
    """Zero-pad front, trim tail to the original length (ref :507-515)."""
    if not isinstance(signal, np.ndarray):
        return signal
    return _oracle.apply_delay(signal, delay_samples)


def map_channels(data_5_1, target_layout_name, rate, z_pos=0.5, *, backend="jax"):
    """Map internal 5.1 onto the target layout → (array, channel names)
    (ref :517-571): stereo downmix, identity 5.1, delayed side channels for
    7.1, z-scaled delayed height channels for 5.1.2."""
    if backend == "oracle":
        return _oracle.map_channels(data_5_1, target_layout_name, rate, z_pos)
    if target_layout_name not in config.CHANNEL_LAYOUTS:
        target_layout_name = config.DEFAULT_CHANNEL_LAYOUT
    names = _spatial.layout_channel_names(target_layout_name)
    arr = np.asarray(data_5_1) if data_5_1 is not None else None
    if arr is None or arr.ndim != 2 or arr.shape[1] != 6:
        channels = config.CHANNEL_LAYOUTS[target_layout_name]["channels"]
        return np.zeros((0, channels), dtype=np.float32), names
    out = _map_core(
        jnp.asarray(arr.astype(np.float32).T),
        target_layout_name,
        int(rate),
        jnp.float32(np.clip(z_pos, 0.0, 1.0)),
    )
    return np.asarray(out).T, names


# --- analysis & metering (ref :573-813) -------------------------------------


def calculate_audio_metrics(data, rate, *, backend="jax"):
    """{'lufs', 'true_peak_dbfs', 'rms_dbfs'} of (samples, channels) audio
    (ref :674-711): LUFS over the mean of the first ≤2 channels, sample-peak
    dBFS, RMS dBFS, −inf for silence, None on invalid input."""
    none_metrics = {"lufs": None, "true_peak_dbfs": None, "rms_dbfs": None}
    if (
        data is None
        or not isinstance(data, np.ndarray)
        or data.size == 0
        or rate <= 0
        or data.ndim not in (1, 2)
    ):
        return none_metrics
    return _metrics.calculate_audio_metrics(data, rate, backend=backend)


def plot_waveform_and_spectrogram_v4(file_path, title="Audio"):
    """Waveform grid + symlog spectrogram PNG → temp path (ref :573-672)."""
    return _plot_waveform_and_spectrogram(file_path, title)


def run_audio_profiler_v4(original_file_obj, processed_file_obj):
    """Markdown A/B comparison report (ref :713-813)."""
    return _run_audio_profiler(original_file_obj, processed_file_obj)


# --- UI handlers (ref :817-862, :1293-1384) ----------------------------------
# These return objects from the same `gr` layer the studio runs on (real
# gradio when installed, the in-repo headless runtime otherwise).


def update_marker_image(x_pos, y_pos, base_image_path_param=None):
    """Draw the red position marker → temp PNG path (ref :817-839)."""
    return _marker.update_marker_image(x_pos, y_pos, base_image_path_param)


def update_controls_from_click(evt):
    """Map click event → (x-slider, y-slider, marker image) updates
    (ref :841-854)."""
    return _studio.on_map_click(evt)


def handle_slider_change(x_pos, y_pos):
    """X/Y slider move → marker image update (ref :856-862)."""
    return _studio.on_slider_change(x_pos, y_pos)


def toggle_ir_controls_v4(use_external):
    """Interactivity updates for [external IR input] + the 7 hall controls
    (ref :1293-1303)."""
    return _studio.toggle_ir_controls(use_external)


def on_start_v41():
    """Startup initializer → the 28 ordered updates (ref :1333-1384)."""
    return _studio.on_start(_store())


__all__ = [
    # constants
    "APP_VERSION", "PRESET_DIR", "LAST_PRESET_FILE", "BASE_SURROUND_MAP_PATH",
    "material_absorption", "DEFAULT_MATERIAL", "DEFAULT_HALL_TYPE",
    "CHANNEL_LAYOUTS", "DEFAULT_CHANNEL_LAYOUT",
    # presets
    "ensure_preset_dir", "save_last_preset", "load_last_preset",
    "list_presets_for_dropdown_v4", "save_current_preset_v4",
    "load_selected_preset_v4", "delete_selected_preset_v4",
    "export_presets_as_zip_v4",
    # parameter math
    "update_hall_info", "adjust_reverb_parameters_by_hall",
    "adjust_parameters_for_3d", "compute_final_directionality_3d",
    "adapt_early_late_levels",
    # DSP core
    "generate_impulse_response_split_3d", "apply_simple_lp_filter",
    "dynamic_dry_wet_mix", "convolve_audio_split_3d",
    "convolve_audio_external_ir", "apply_surround_panning_3d",
    "apply_delay", "map_channels",
    # analysis
    "calculate_audio_metrics", "plot_waveform_and_spectrogram_v4",
    "run_audio_profiler_v4",
    # orchestrator + UI
    "apply_raytrace_convolution_3d", "process_audio_main_v41",
    "update_marker_image", "update_controls_from_click",
    "handle_slider_change", "toggle_ir_controls_v4", "on_start_v41",
]
